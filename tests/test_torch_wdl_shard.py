"""The row-sharded WDL plane (``shifu_tpu_torch.train.wdl_shard``) on one
rank against ``shifu_tpu.train.wdl_shard``, scenario by scenario after the
reference's ``tests/test_wdl_shard.py``: a world of one with the plane on
bit-identical to the replicated run (in RAM at batch 0 and 16, streamed,
hashed, resumed), the layout (each shard ``ceil(card / D)`` rows of every
table and moment, pad and unpad round trips), the serving copies and the
knobs' gates.  The multi-rank cases are ``tests/test_torch_mesh.py``'s.

The reference runs through ``test_torch_wdl.reference_wdl`` (the scoped
C1 shim, 64-bit types off), from the port's initial params (its normal
draws differ from XLA's by 1-2 ulps, C10) and with its gather lowering
(``_ONEHOT_MAX_ELEMS`` 0, as its own shard tests set).  Tolerances: params
within 1e-5 of the reference's, errors rtol 1e-4; the hot copy's tail row
(a float32 mean over another reduction order) within 1e-6 of the
reference's, its scores within 1e-6; everything the port computes twice
(sharded and replicated, served copies) bit for bit.

    python -m pytest tests/test_torch_wdl_shard.py -q --durations=5
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch.config import environment
from shifu_tpu_torch.models import wdl as P
from shifu_tpu_torch.ops import prng
from shifu_tpu_torch.parallel.mesh import Mesh
from shifu_tpu_torch.train import wdl_shard as PS
from shifu_tpu_torch.train import wdl_trainer as PT
from shifu_tpu_torch.train.checkpoint import tree_leaves
from shifu_tpu_torch.train.nn_trainer import TrainSettings

from test_torch_wdl import _one_torch_thread, reference_wdl  # noqa: F401

pytestmark = pytest.mark.torch_port

N = 64
CARDS = [10, 7]          # divisible by none of 2, 3, 4: padding always on


@pytest.fixture(autouse=True)
def _clean_env():
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    yield
    environment.reset_for_tests()
    j_environment.reset_for_tests()


def spec(extra=None, cards=CARDS):
    return P.WDLModelSpec(numeric_dim=3, cat_cardinalities=list(cards),
                          embed_dim=4, hidden_nodes=[8],
                          activations=["relu"], extra=extra or {})


def data(seed=0, n=N):
    """``tests/test_wdl_shard.py::_data``."""
    rng = np.random.default_rng(seed)
    xn = rng.normal(size=(n, 3)).astype(np.float32)
    xc = np.stack([rng.integers(0, CARDS[0], n),
                   rng.integers(0, CARDS[1], n)], axis=1).astype(np.int32)
    y = (rng.random(n) > 0.5).astype(np.float32)
    return xn, xc, y, np.ones(n, np.float32)


def settings(cls=TrainSettings, **kw):
    base = dict(optimizer="ADAM", learning_rate=0.05, l2=1e-4, epochs=3,
                batch_size=0, early_stop_window=0, seed=7)
    base.update(kw)
    return cls(**base)


def same(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == z.dtype and x.shape == z.shape and torch.equal(x, z)
        for x, z in zip(la, lb))


def ref_leaves(params):
    """The reference layout's leaves of a member (per-column lists)."""
    return [np.asarray(a, np.float32)
            for a in jax.tree_util.tree_leaves(params)]


def port_leaves(s, params):
    cols = P.columns_of(s, params)
    return [np.asarray(a, np.float32)
            for a in jax.tree_util.tree_leaves(cols)]


@contextlib.contextmanager
def reference_from_port_init(s, seed: int, bags: int):
    """The reference's WDL modules (``reference_wdl``) with its gather
    lowering and its ``init_params`` returning the port's members, in the
    order its trainer asks for them."""
    with reference_wdl() as R:
        from shifu_tpu.train import wdl_shard as RS
        R.wdl._ONEHOT_MAX_ELEMS = 0
        members = iter([
            jax.tree_util.tree_map(jnp.asarray, P.columns_of(s, p))
            for p in (P.init_params(k, s)
                      for k in prng.split(prng.prng_key(seed), bags))])
        R.wdl.init_params = lambda key, spec: next(members)
        R.shard = RS
        yield R


def ref_mesh(d: int):
    from jax.sharding import Mesh as JMesh
    return JMesh(np.asarray(jax.devices("cpu")[:d]).reshape(1, d),
                 ("ensemble", "data"))


def reference_train(s, bs: int, d: int, bags: int = 2, shard=True,
                    **kw):
    """The reference's in-RAM trainer on ``d`` XLA CPU devices from the
    port's init: (params as leaves, valid errors, train errors)."""
    from shifu_tpu.train.nn_trainer import TrainSettings as RT
    xn, xc, y, w = data()
    with reference_from_port_init(s, 7, bags) as R:
        rs = R.wdl.WDLModelSpec.from_json(s.to_json())
        res = R.trainer.train_wdl_ensemble(
            xn, xc, y, w, rs, settings(RT, batch_size=bs, **kw), bags=bags,
            mesh=ref_mesh(d), shard=shard)
        return ([jax.tree_util.tree_map(np.asarray, p)
                 for p in res.params],
                np.asarray(res.valid_errors), np.asarray(res.train_errors))


def port_train(s, bs: int, bags: int = 2, shard=None, **kw):
    xn, xc, y, w = data()
    return PT.train_wdl_ensemble(xn, xc, y, w, s, settings(batch_size=bs,
                                                           **kw),
                                 bags=bags, shard=shard, device="cpu")


# ------------------------------------------------------- in-RAM parity
@pytest.mark.parametrize("precision", ["f32", "mixed"])
@pytest.mark.parametrize("bs", [0, 16])
def test_inram_sharded_matches_replicated_bitwise_1rank(bs, precision):
    s = spec()
    rep = port_train(s, bs, shard=False, precision=precision)
    sh = port_train(s, bs, shard=True, precision=precision)
    assert same(rep.params, sh.params)
    assert np.array_equal(rep.valid_errors, sh.valid_errors)
    assert np.array_equal(rep.train_errors, sh.train_errors)
    assert rep.history == sh.history


@pytest.mark.parametrize("bs", [0, 16])
def test_inram_sharded_matches_the_reference_1device(bs):
    """The reference's sharded executables on one device (its
    ``test_inram_sharded_matches_replicated_bitwise_1dev``) from the same
    initial params."""
    s = spec()
    want, want_va, want_tr = reference_train(s, bs, 1)
    got = port_train(s, bs, shard=True)
    np.testing.assert_allclose(got.valid_errors, want_va, rtol=1e-4)
    np.testing.assert_allclose(got.train_errors, want_tr, rtol=1e-4)
    for g, w in zip(got.params, want):
        for a, b in zip(port_leaves(s, g), ref_leaves(w)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


# ------------------------------------------------------------ layout
def _mesh(d: int, r: int) -> Mesh:
    """Rank ``r`` of a data axis of ``d`` (no process group: the layout
    maps need none)."""
    return Mesh(n_ensemble=1, n_data=d, rank=r)


@pytest.mark.parametrize("d", [2, 3, 4])
def test_sharded_tables_are_actually_sharded(d):
    """Each rank's table and both Adam moments hold ``ceil(card_i / D)``
    rows of every column (the flat shard: ``sum(vs)`` rows), the ranks'
    blocks rebuild the whole tables, and no rank holds a padded row with
    anything but zeros."""
    from shifu_tpu_torch.train.optimizers import make_optimizer, tree_map
    s = spec()
    members = [P.init_params(k, s) for k in prng.split(prng.prng_key(0), 2)]
    members = [dict(m, wide_cat=torch.randn(m["wide_cat"].shape))
               for m in members]
    stacked = tree_map(lambda *ts: torch.stack(ts), *members)
    state = make_optimizer("ADAM", 0.05).init(stacked, 2)
    state["m"] = tree_map(torch.randn_like, state["m"])
    vs = [-(-c // d) for c in CARDS]
    full = {"embed": [], "wide_cat": [], "m": []}
    for r in range(d):
        plane = PS.WDLShardPlane(_mesh(d, r), s, 2)
        assert plane.vs == vs and plane.local_rows == sum(vs)
        loc, lst = plane.local(stacked), plane.local(state)
        assert loc["embed"].shape == (2, sum(vs), s.embed_dim)
        assert loc["wide_cat"].shape == (2, sum(vs))
        for mom in ("m", "v"):
            assert lst[mom]["embed"].shape == (2, sum(vs), s.embed_dim)
            assert lst[mom]["wide_cat"].shape == (2, sum(vs))
        assert lst["t"].shape == (2,)
        assert loc["deep"][0]["w"].shape == stacked["deep"][0]["w"].shape
        full["embed"].append(loc["embed"])
        full["wide_cat"].append(loc["wide_cat"])
        full["m"].append(lst["m"]["embed"])
    off = np.concatenate([[0], np.cumsum(vs)])
    for name, axis in (("embed", 1), ("wide_cat", 1), ("m", 1)):
        want = state["m"]["embed"] if name == "m" else stacked[name]
        cols = []
        for i, c in enumerate(CARDS):
            blocks = torch.cat([t.narrow(axis, int(off[i]), vs[i])
                                for t in full[name]], dim=axis)
            assert torch.count_nonzero(blocks.narrow(
                axis, c, vs[i] * d - c)) == 0          # the padding
            cols.append(blocks.narrow(axis, 0, c))
        assert torch.equal(torch.cat(cols, dim=axis), want)


def test_pad_unpad_roundtrip_non_divisible():
    """Padding and unpadding round-trip at D = 4 (10 and 7 rows), and the
    padded tables are the reference's ``pad_params``' per column."""
    s = spec()
    member = P.init_params(prng.prng_key(1), s)
    plane = PS.WDLShardPlane(_mesh(4, 0), s, 1)
    assert plane.vs == [-(-c // 4) for c in CARDS] == [3, 2]
    padded = plane.pad_params(member)
    assert padded["embed"].shape[0] == sum(plane.vp) == 20
    assert same(plane.unpad_params(padded), member)
    with reference_wdl() as R:
        from shifu_tpu.train import wdl_shard as RS
        rs = R.wdl.WDLModelSpec.from_json(s.to_json())
        ref_plane = RS.WDLShardPlane(ref_mesh(4), rs, 1)
        ref = ref_plane.pad_params(jax.tree_util.tree_map(
            jnp.asarray, P.columns_of(s, member)))
        assert ref_plane.vs == plane.vs
        for name in ("embed", "wide_cat"):
            np.testing.assert_array_equal(
                padded[name].numpy(),
                np.concatenate([np.asarray(t) for t in ref[name]]))


# ------------------------------------------------------ streamed parity
class _Win:
    def __init__(self, i, s, arrays, rows):
        self.index, self.start = i, s
        self.rows = self.n_valid = rows
        self.arrays = arrays


class FakePlanes:
    """``tests/test_wdl_shard.py::_FakePlanes``: windows of 16 rows."""

    def __init__(self, x, bins, y, w, wrows):
        self.x, self.bins, self.y, self.w = x, bins, y, w
        self.window_rows = wrows
        self.num_rows = len(y)

    def windows(self):
        wr = self.window_rows
        for i, s in enumerate(range(0, self.num_rows, wr)):
            yield _Win(i, s, {"x": self.x[s:s + wr], "y": self.y[s:s + wr],
                              "w": self.w[s:s + wr],
                              "bins": self.bins[s:s + wr]}, wr)

    def prepared(self, prepare):
        for win in self.windows():
            yield prepare(win)


def streamed_mask_fn():
    masks = (np.random.default_rng(5).random((2, N)) > 0.3) \
        .astype(np.float32)

    def mask_fn(idx, yw):
        tm = masks[:, idx * 16:(idx + 1) * 16]
        return tm, 1.0 - tm
    return mask_fn


def port_streamed(shard, mesh=None, elastic=None):
    xn, xc, y, w = data()
    s = spec(extra={"num_feat_idx": [0, 1, 2], "cat_col_idx": [0, 1]})
    return PT.train_wdl_streamed(FakePlanes(xn, xc, y, w, 16), s,
                                 settings(), 2, streamed_mask_fn(),
                                 [0, 1, 2], [0, 1], shard=shard,
                                 elastic=elastic, device="cpu", mesh=mesh)


def test_streamed_sharded_bitwise_1rank():
    """The reference's ``test_streamed_sharded_bitwise_1dev``, and its
    sharded run on one device from the same init."""
    from shifu_tpu.train.nn_trainer import TrainSettings as RT
    rep = port_streamed(False)
    sh = port_streamed(True)
    assert same(rep.params, sh.params)
    assert np.array_equal(rep.valid_errors, sh.valid_errors)
    xn, xc, y, w = data()
    s = spec(extra={"num_feat_idx": [0, 1, 2], "cat_col_idx": [0, 1]})
    with reference_from_port_init(s, 7, 2) as R:
        res = R.trainer.train_wdl_streamed(
            FakePlanes(xn, xc, y, w, 16),
            R.wdl.WDLModelSpec.from_json(s.to_json()), settings(RT), 2,
            streamed_mask_fn(), [0, 1, 2], [0, 1], mesh=ref_mesh(1),
            shard=True)
        want = [ref_leaves(p) for p in res.params]
        want_va = np.asarray(res.valid_errors)
    np.testing.assert_allclose(sh.valid_errors, want_va, rtol=1e-4)
    for g, r in zip(sh.params, want):
        for a, b in zip(port_leaves(s, g), r):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


# ------------------------------------------------------- hashed-ID path
def test_hashed_training_scores_consistently(tmp_path):
    """Sharded training on hashed ids (the reference's hashed test, on one
    rank): the replicated run's params bit for bit; saved and reloaded,
    the standalone scorer hashing raw ids equals the forward on pre-hashed
    ids, and the plan survives the file."""
    from shifu_tpu_torch.ops.hashing import column_hash_key
    buckets = 6
    s = P.WDLModelSpec(
        numeric_dim=3, cat_cardinalities=[buckets, CARDS[1]], embed_dim=4,
        hidden_nodes=[8], activations=["relu"],
        extra={"num_feat_idx": [0, 1, 2], "cat_col_idx": [0, 1],
               "hash_buckets": buckets, "hashed_cols": [0],
               "hash_keys": [column_hash_key(0)]})
    rep = port_train(s, 0, bags=1, shard=False, epochs=2)
    sh = port_train(s, 0, bags=1, shard=True, epochs=2)
    assert same(rep.params, sh.params)
    path = str(tmp_path / "model0.wdl")
    P.save_model(path, s, sh.params[0])
    m = P.IndependentWDLModel.load(path)
    assert P.hash_plan(m.spec) is not None
    xn, xc, _, _ = data()
    got = m.compute(xn, xc, device="cpu")
    hashed = P.apply_hash_host(m.spec, xc)
    assert hashed[:, 0].max() < buckets
    want = P.forward(m.params, m.spec, torch.from_numpy(xn),
                     torch.from_numpy(hashed)).numpy()
    assert got.tobytes() == want.tobytes()


# ------------------------------------------------- checkpoint / resume
def test_sharded_checkpoint_resume_bit_exact(tmp_path):
    """4 sharded minibatch epochs against 2, then a resume to 4: params
    and best errors bit for bit; the checkpoint's tables keep the true
    cardinalities."""
    from shifu_tpu_torch.train import checkpoint as ckpt
    s = spec()

    def run(ckdir, epochs, resume):
        return port_train(s, 16, shard=True, epochs=epochs,
                          checkpoint_dir=ckdir or "", checkpoint_every=2,
                          resume=resume)
    full = run(None, 4, False)
    ckdir = str(tmp_path / "ck")
    run(ckdir, 2, False)
    last = os.path.join(ckdir, f"ckpt-{ckpt.latest_epoch(ckdir)}.npz")
    with np.load(last) as z:
        shapes = {z[k].shape for k in z.files if k.startswith("leaf")}
    assert (2, sum(CARDS), s.embed_dim) in shapes
    resumed = run(ckdir, 4, True)
    assert same(full.params, resumed.params)
    assert np.array_equal(full.valid_errors, resumed.valid_errors)


def test_sharded_ledger_gathers_only_to_write(tmp_path, monkeypatch):
    """The ledger keeps the local layout: a run of 5 epochs with a
    checkpoint every 3 gathers whole trees 4 times (the checkpoint's
    params, moments and best params at epoch 3, the result's best
    params), not on every epoch; without a checkpoint directory once."""
    calls = []
    whole = PT._Layout.whole
    monkeypatch.setattr(PT._Layout, "whole",
                        lambda self, tree: calls.append(1) or
                        whole(self, tree))
    s = spec()
    port_train(s, 16, shard=True, epochs=5,
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=3)
    assert len(calls) == 4
    calls.clear()
    port_train(s, 16, shard=True, epochs=5)
    assert len(calls) == 1


# --------------------------------------------------------------- serve
def _served_model(seed=3):
    s = spec(extra={"num_feat_idx": [0, 2, 4], "cat_col_idx": [1, 3]})
    p = P.init_params(prng.prng_key(seed), s)
    g = torch.Generator().manual_seed(seed)
    p["wide_cat"] = torch.randn(p["wide_cat"].shape, generator=g)
    p["bias"] = torch.tensor([0.125])
    return P.IndependentWDLModel(s, p)


@pytest.mark.parametrize("d", [1, 2, 3, 8])
def test_serve_sharded_bit_identical_zero_captures(monkeypatch, d):
    """The bucket scorer with ``serveCopy=sharded`` over D shards (D
    emulated on the CPU device) against the replicated copy: every score
    byte equal at every request size, and no capture forced after warm
    (the reference's ``test_serve_sharded_bit_identical_zero_recompiles``).
    Ids past a column's cardinality and negative ones clip alike."""
    from shifu_tpu_torch.serve.scorer import AOTScorer, serve_capture_count
    m = _served_model()
    monkeypatch.setattr(PS, "serve_devices",
                        lambda device: [torch.device("cpu")] * d)

    def build(mode, name):
        environment.set_property("shifu.wdl.serveCopy", mode)
        sc = AOTScorer([m], buckets=(1, 4, 16), name=name, device="cpu")
        sc.warm()
        return sc
    classic = build("full", "serve.score.wdlclassic")
    sharded = build("sharded", "serve.score.wdlsharded")
    rng = np.random.default_rng(7)
    x = rng.normal(size=(16, classic.n_features)).astype(np.float32)
    bins = rng.integers(-1, 12, size=(16, classic.n_bins_cols)) \
        .astype(np.int32)
    for n in (1, 3, 4, 11, 16):
        got = sharded.score_batch(x[:n], bins[:n])
        assert got.tobytes() == classic.score_batch(x[:n], bins[:n]) \
            .tobytes()
    assert serve_capture_count("serve.score.wdlsharded") == 0


def test_serve_hot_copy_matches_the_reference():
    """``serveCopy=hot`` with 4 head rows: the tables squash to 4 exact
    rows and one tail mean (within 1e-6 of the reference's, a float32 mean
    in another order), head ids score as the full copy bit for bit, cold
    ids as the reference's hot forward within 1e-6, and the bucket scorer
    serves the copy with no capture forced."""
    from shifu_tpu_torch.serve.scorer import AOTScorer, serve_capture_count
    m = _served_model()
    s, p = m.spec, m.params
    environment.set_property("shifu.wdl.serveCopy", "hot")
    environment.set_property("shifu.wdl.serveHotRows", "4")
    mode, fwd = PS.build_serve_forward(s, p, torch.device("cpu"))
    assert mode == "hot"
    hspec, hot = PS._hot_params(s, p, 4)
    assert hspec.cat_cardinalities == [5, 5]
    xn, xc, _, _ = data()
    got = fwd(torch.from_numpy(xn), torch.from_numpy(xc).long()).numpy()
    full = P.forward(p, s, torch.from_numpy(xn),
                     torch.from_numpy(xc)).numpy()
    head = (xc < 4).all(axis=1)
    assert head.any() and (~head).any()
    assert np.array_equal(got[head], full[head])
    with reference_wdl() as R:
        from shifu_tpu.train import wdl_shard as RS
        rs = R.wdl.WDLModelSpec.from_json(s.to_json())
        cols = jax.tree_util.tree_map(jnp.asarray, P.columns_of(s, p))
        rhot = RS._hot_params(rs, cols, 4)
        want = np.asarray(R.wdl.forward(rhot, rs, jnp.asarray(xn),
                                        jnp.asarray(xc)))
        want_tabs = {k: [np.asarray(t) for t in rhot[k]]
                     for k in ("embed", "wide_cat")}
    hcols = P.columns_of(hspec, hot)
    for k in ("embed", "wide_cat"):
        for a, b in zip(hcols[k], want_tabs[k]):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a[:4], b[:4])
            np.testing.assert_allclose(a[4:], b[4:], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    sc = AOTScorer([m], buckets=(1, 16, 64), name="serve.score.wdlhot",
                   device="cpu")
    sc.warm()
    bins = np.zeros((N, sc.n_bins_cols), np.int32)
    bins[:, [1, 3]] = xc
    x = np.zeros((N, sc.n_features), np.float32)
    x[:, [0, 2, 4]] = xn
    np.testing.assert_allclose(sc.score_batch(x, bins)[:, 0],
                               got[:, 0] * 1000.0, rtol=1e-6)
    assert serve_capture_count("serve.score.wdlhot") == 0


def test_serve_copy_mode_resolution():
    """The reference's ``test_serve_copy_mode_resolution``: auto keeps the
    replicated copy on one device and small tables; the knob forces a
    copy; auto shards with more than one device past the threshold.  A
    copy over several cards is not built (its shards would run outside
    the rung's captured graph): auto serves the replicated copy there,
    ``sharded`` raises."""
    s = spec()
    p = P.init_params(prng.prng_key(0), s)
    cpu = torch.device("cpu")
    assert PS.build_serve_forward(s, p, cpu) == ("full", None)
    assert PS.resolve_serve_mode(s, [cpu, cpu]) == "full"
    environment.set_property("shifu.wdl.shardMinBytes", "0")
    assert PS.resolve_serve_mode(s, [cpu, cpu]) == "sharded"
    assert PS.resolve_serve_mode(s, [cpu]) == "full"
    environment.set_property("shifu.wdl.serveCopy", "sharded")
    mode, fwd = PS.build_serve_forward(s, p, cpu)
    assert mode == "sharded" and fwd is not None
    xn, xc, _, _ = data()
    got = fwd(torch.from_numpy(xn), torch.from_numpy(xc).long()).numpy()
    want = P.forward(p, s, torch.from_numpy(xn),
                     torch.from_numpy(xc)).numpy()
    assert got.tobytes() == want.tobytes()
    two_cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(NotImplementedError, match="more than one card"):
        PS.build_serve_forward(s, p, two_cards[0], two_cards)
    environment.set_property("shifu.wdl.serveCopy", "auto")
    assert PS.build_serve_forward(s, p, two_cards[0], two_cards) == \
        ("full", None)
    environment.set_property("shifu.wdl.serveCopy", "bogus")
    assert PS.serve_copy_mode() == "auto"
    assert PS.resolve_serve_mode(P.WDLModelSpec(numeric_dim=3,
                                                cat_cardinalities=[]),
                                 [cpu, cpu]) == "full"


# ------------------------------------------------------ gating & costs
def test_shard_gating():
    """The reference's ``test_shard_gating`` on the port's mesh: an
    override wins, ``off`` beats the size gate, ``on`` shards even a data
    axis of 1, ``auto`` shards only above 1 and past the threshold."""
    s = spec()
    two, one = _mesh(2, 0), _mesh(1, 0)
    assert PS.shard_enabled(s, two, 2, "f32", override=True)
    assert not PS.shard_enabled(s, two, 2, "f32", override=False)
    environment.set_property("shifu.wdl.shardTables", "off")
    assert not PS.shard_enabled(s, two, 2, "f32")
    environment.set_property("shifu.wdl.shardTables", "on")
    assert PS.shard_enabled(s, two, 2, "f32")
    assert PS.shard_enabled(s, one, 2, "f32")
    assert PS.shard_enabled(s, None, 2, "f32")
    environment.set_property("shifu.wdl.shardTables", "auto")
    assert not PS.shard_enabled(s, two, 2, "f32")
    environment.set_property("shifu.wdl.shardMinBytes", "0")
    assert PS.shard_enabled(s, two, 2, "f32")
    assert not PS.shard_enabled(s, one, 2, "f32")
    assert not PS.shard_enabled(P.WDLModelSpec(numeric_dim=3,
                                               cat_cardinalities=[]),
                                two, 2, "f32", override=True)
    with reference_wdl() as R:
        from shifu_tpu.train import wdl_shard as RS
        rs = R.wdl.WDLModelSpec.from_json(s.to_json())
        for bags, prec in ((1, "f32"), (2, "bf16"), (3, "mixed")):
            assert RS.table_param_bytes(rs, bags, prec) == \
                PS.table_param_bytes(s, bags, prec)


def test_cost_models_registered():
    from shifu_tpu_torch.obs.costs import cost_models
    models = cost_models()
    for name in ("wdl.sparse_gather", "wdl.shard_update"):
        assert name in models
    with reference_wdl():
        from shifu_tpu.obs.costs import cost_models as ref_models
        from shifu_tpu.train import wdl_shard  # noqa: F401  (registers)
        ref = ref_models()
        for name, kw in (
                ("wdl.sparse_gather", dict(rows=128, cols=2, embed=4,
                                           members=2, devices=4,
                                           bytes_per=4)),
                ("wdl.shard_update", dict(table_elems=1000, members=2,
                                          steps=3, bytes_per=4))):
            got = models[name](**kw)
            assert got["flops"] > 0 and got["bytes_accessed"] > 0
            assert got == ref[name](**kw)
