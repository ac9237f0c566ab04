"""Port parity for the out-of-core tree trainers: ``ops.tree``'s path
histograms and recorded grows, ``train_gbt_streamed`` and
``train_rf_streamed`` of ``shifu_tpu_torch`` (``device="cpu"``) against
``shifu_tpu`` on the same numpy-seeded shards (the reference tests'
plane: 1,024 rows x 6 columns x 8 bins, shards of 300 rows, windows of
256), in every regime: fully resident, a disk tail on the exact per-level
schedule, and coarse-to-fine; then resume, members, one-vs-all and the
CLI.

Tolerances: split features and left masks equal; leaves rtol 1e-5, atol
1e-6 (an internal node's mean gradient is a cancelling sum near 0);
progress errors rtol 1e-5; ``disk_passes``, ``tail_sweeps`` and
``bytes_read`` exactly equal.  Within the port, coarse-to-fine equals the
exact schedule bit for bit, and a resumed forest the uninterrupted one.

The reference's fully resident streamed RF swaps its train and
validation errors for the trees it grows a tree at a time (its
``_rf_round_streamed`` packs [train, 1, valid, 1] where ``absorb_rf``
reads [valid, valid weight, train, train weight]; ROADMAP Queue 3 C11);
the port reports them in order, as the reference's own tail regime does,
and the comparison swaps them back.
"""

import dataclasses
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch.config import environment

pytestmark = pytest.mark.torch_port

N_BINS = 8
GBT_WIN = 256 * (6 * 1 + 3 * 4)     # a prepared GBT window: u8 bins, y/tw/vw
RF_WIN = 256 * (6 * 1 + 2 * 4)      # a prepared RF window: u8 bins, y/w
TAIL = {"gbt": 2 * GBT_WIN + 64, "rf": 2 * RF_WIN + 64}
RESIDENT = 1 << 30


@pytest.fixture(autouse=True)
def _clean_env():
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    yield
    environment.reset_for_tests()
    j_environment.reset_for_tests()


def _tree_data(n=1024, c=6, n_bins=N_BINS, seed=3, noise=False):
    """The reference tests' plane (``tests/test_tree_streaming.py``);
    ``noise`` draws labels independent of the bins."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins - 1, size=(n, c)).astype(np.int32)
    logit = (bins[:, 0] - 3) * 0.8 + (bins[:, 1] == 2) * 1.5 - 0.5
    if noise:
        logit = logit * 0.0
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    w = np.ones(n, np.float32)
    return bins, y, w


def _write_shards(d, bins, y, w, shard_rows=300):
    os.makedirs(d, exist_ok=True)
    shard = 0
    for s in range(0, len(y), shard_rows):
        e = min(s + shard_rows, len(y))
        np.savez(os.path.join(d, f"part-{shard:05d}.npz"),
                 bins=bins[s:e].astype(np.int16), y=y[s:e], w=w[s:e])
        shard += 1
    with open(os.path.join(d, "schema.json"), "w") as f:
        json.dump({"columnNums": list(range(bins.shape[1])),
                   "numShards": shard, "numRows": len(y)}, f)


def _stream(pkg, d, window=256):
    if pkg == "ref":
        from shifu_tpu.data.shards import Shards
        from shifu_tpu.data.streaming import ShardStream
    else:
        from shifu_tpu_torch.data.shards import Shards
        from shifu_tpu_torch.data.streaming import ShardStream
    return ShardStream(Shards.open(d), ("bins", "y", "w"), window)


def _settings(pkg, **kw):
    if pkg == "ref":
        from shifu_tpu.train.dt_trainer import DTSettings
    else:
        from shifu_tpu_torch.train.dt_trainer import DTSettings
    return DTSettings(**kw)


def _train(pkg, kind, d, budget, c2f=None, **kw):
    """One streamed forest of ``pkg`` over the shards in ``d``."""
    old = os.environ.get("SHIFU_TREE_TAIL_C2F")
    if c2f is not None:
        os.environ["SHIFU_TREE_TAIL_C2F"] = c2f
    try:
        if pkg == "ref":
            from shifu_tpu.train import dt_trainer as dt
            extra = {}
        else:
            from shifu_tpu_torch.train import dt_trainer as dt
            extra = {"device": "cpu"}
        fn = dt.train_gbt_streamed if kind == "gbt" else dt.train_rf_streamed
        return fn(_stream(pkg, d), N_BINS, None, _settings(pkg, **kw),
                  cache_budget=budget, **extra)
    finally:
        if old is None:
            os.environ.pop("SHIFU_TREE_TAIL_C2F", None)
        else:
            os.environ["SHIFU_TREE_TAIL_C2F"] = old


GBT = dict(n_trees=5, depth=3, loss="log", learning_rate=0.1, seed=0)
RF = dict(n_trees=6, depth=3, impurity="entropy", loss="squared", seed=2,
          tail_tree_batch=4)
RUNS = {
    # name: (kind, plane, budget, c2f, settings)
    "gbt_resident": ("gbt", "plain", RESIDENT, None, GBT),
    "gbt_exact": ("gbt", "plain", TAIL["gbt"], "0", GBT),
    "gbt_c2f": ("gbt", "plain", TAIL["gbt"], "1", GBT),
    "gbt_noise_exact": ("gbt", "noise", TAIL["gbt"], "0",
                        dict(GBT, n_trees=10, depth=2)),
    "gbt_noise_c2f": ("gbt", "noise", TAIL["gbt"], "1",
                      dict(GBT, n_trees=10, depth=2)),
    "rf_resident": ("rf", "plain", RESIDENT, None, RF),
    "rf_tail": ("rf", "plain", TAIL["rf"], None, RF),
    "rf_mc_resident": ("rf", "mc", RESIDENT, None, dict(RF, n_classes=3)),
    "rf_mc_tail": ("rf", "mc", TAIL["rf"], None, dict(RF, n_classes=3)),
    "dt_tail": ("rf", "plain", TAIL["rf"], None,
                dict(RF, n_trees=1, poisson_bagging=False, depth=4)),
}


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    """Each package's copy of each plane (the spill each writes lands in
    its own copy)."""
    root = tmp_path_factory.mktemp("torch_tree_streaming")
    bins, y, w = _tree_data()
    _, y_noise, _ = _tree_data(noise=True)
    y_mc = ((bins[:, 0] >= 3).astype(np.float32)
            + (bins[:, 1] >= 4).astype(np.float32))
    out = {}
    for name, yy in (("plain", y), ("noise", y_noise), ("mc", y_mc)):
        for pkg in ("ref", "port"):
            d = str(root / f"{name}_{pkg}")
            _write_shards(d, bins, yy, w)
            out[name, pkg] = d
    out["root"] = root
    return out


class _Runs:
    """{(run, package): ForestResult}, each trained on first use (a test
    worker trains only the runs its tests read)."""

    def __init__(self, planes):
        self.planes = planes
        self.done = {}

    def __getitem__(self, key):
        if key not in self.done:
            name, pkg = key
            kind, plane, budget, c2f, kw = RUNS[name]
            self.done[key] = _train(pkg, kind, self.planes[plane, pkg],
                                    budget, c2f, **kw)
        return self.done[key]


@pytest.fixture(scope="module")
def runs(planes):
    return _Runs(planes)


def _assert_forests(a, b, rtol=1e-5, atol=1e-6):
    assert len(a.trees) == len(b.trees)
    for ta, tb in zip(a.trees, b.trees):
        np.testing.assert_array_equal(ta.split_feat, tb.split_feat)
        np.testing.assert_array_equal(ta.left_mask, tb.left_mask)
        np.testing.assert_allclose(ta.leaf_value, tb.leaf_value, rtol=rtol,
                                   atol=atol)


def _assert_bits(a, b):
    assert len(a.trees) == len(b.trees)
    for ta, tb in zip(a.trees, b.trees):
        for f in ("split_feat", "left_mask", "leaf_value"):
            assert np.asarray(getattr(ta, f)).tobytes() == \
                np.asarray(getattr(tb, f)).tobytes(), f


def _ref_history(name, res):
    """The reference's history, its resident-round RF trees' swapped
    errors put back in order (C11)."""
    h = np.array(res.history)
    if name in ("rf_resident", "rf_mc_resident"):
        first = RUNS[name][4]["tail_tree_batch"]     # the window-loop batch
        h[first:] = h[first:, ::-1]
    return h


@pytest.mark.parametrize("name", list(RUNS))
def test_streamed_forest_matches_the_reference(runs, name):
    ref, port = runs[name, "ref"], runs[name, "port"]
    _assert_forests(port, ref)
    np.testing.assert_allclose(np.array(port.history),
                               _ref_history(name, ref), rtol=1e-5)
    assert (port.disk_passes, port.tail_sweeps, port.bytes_read) == \
        (ref.disk_passes, ref.tail_sweeps, ref.bytes_read)
    assert port.trees_built == ref.trees_built
    np.testing.assert_allclose(port.feature_importance,
                               ref.feature_importance, rtol=1e-4,
                               atol=1e-4 * np.abs(ref.feature_importance)
                               .max())
    if RUNS[name][0] == "gbt":
        assert port.spec_kwargs["init_score"] == pytest.approx(
            ref.spec_kwargs["init_score"], rel=1e-6)
    else:
        assert port.spec_kwargs == ref.spec_kwargs


@pytest.mark.parametrize("exact,c2f", [("gbt_exact", "gbt_c2f"),
                                       ("gbt_noise_exact", "gbt_noise_c2f")])
def test_coarse_to_fine_is_the_exact_forest_bit_for_bit(runs, exact, c2f):
    """Coarse-to-fine is a schedule, not a model: the port's forest, its
    gains and its errors equal the exact schedule's, in fewer tail
    sweeps (the exact one pays depth + 2 a tree)."""
    a, b = runs[exact, "port"], runs[c2f, "port"]
    _assert_bits(a, b)
    np.testing.assert_array_equal(a.feature_importance,
                                  b.feature_importance)
    np.testing.assert_allclose(np.array(a.history), np.array(b.history),
                               rtol=1e-6)
    n, d = RUNS[exact][4]["n_trees"], RUNS[exact][4]["depth"]
    assert a.tail_sweeps == n * (d + 2)
    assert b.tail_sweeps < a.tail_sweeps


def test_label_noise_surrenders_to_the_exact_schedule(runs):
    """On labels independent of the bins the speculation keeps missing
    near the root; after six such trees the port finishes on the exact
    schedule, as the reference does: the sweep count shows where."""
    port = runs["gbt_noise_c2f", "port"]
    n, d = 10, 2
    assert port.tail_sweeps > n          # not one pass a tree
    assert port.tail_sweeps < n * (d + 2)
    assert port.tail_sweeps == runs["gbt_noise_c2f", "ref"].tail_sweeps


def test_tail_matches_the_fully_resident_forest(runs):
    """A tail run keeps the fully resident run's structure; its leaves sum
    in other groups (f32-equivalent)."""
    for kind in ("gbt_exact", "rf_tail"):
        res = "gbt_resident" if kind == "gbt_exact" else "rf_resident"
        _assert_forests(runs[kind, "port"], runs[res, "port"], rtol=1e-4,
                        atol=1e-6)
        assert runs[kind, "port"].disk_passes == \
            1 + runs[kind, "port"].tail_sweeps
    assert runs["gbt_resident", "port"].disk_passes == 1


def test_candidate_k_covering_every_split_is_the_exact_forest(tmp_path):
    """``tailCandidateK`` at C - 1 with a constant column covers every
    split: bit-identical to the exact schedule, and to the reference's
    bounded scan."""
    bins, y, w = _tree_data()
    bins[:, 5] = 0
    got = {}
    for pkg, env in (("ref", j_environment), ("port", environment)):
        d = str(tmp_path / pkg)
        _write_shards(d, bins, y, w)
        exact = _train(pkg, "gbt", d, TAIL["gbt"], "0", **dict(GBT,
                                                                n_trees=3))
        env.set_property("shifu.tree.tailCandidateK", "5")
        got[pkg] = _train(pkg, "gbt", d, TAIL["gbt"], "1",
                          **dict(GBT, n_trees=3))
        if pkg == "port":
            _assert_bits(exact, got[pkg])
    _assert_forests(got["port"], got["ref"])
    assert got["port"].tail_sweeps == got["ref"].tail_sweeps


# ------------------------------------------------------------ tree ops
def _ops_inputs(seed, n=1000, c=6, b=N_BINS, depth=3):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b - 1, (n, c)).astype(np.int32)
    stats = np.stack([rng.integers(1, 4, n),
                      rng.normal(size=n)], 1).astype(np.float32)
    return bins, stats


@pytest.mark.parametrize("seed,depth", [(0, 1), (1, 3), (2, 4)])
def test_path_histograms_and_recorded_grow_match_the_reference(seed, depth):
    """``build_path_histograms`` along a grown tree's structure, and the
    grow's ``record_hists`` outputs, match the reference (rtol 1e-5), and
    in the port the two are the same bits (one B2 launch at TB = depth
    against the grow's level-by-level B1)."""
    import jax.numpy as jnp

    from shifu_tpu.ops import tree as rt
    from shifu_tpu_torch.ops import tree as pt
    bins, stats = _ops_inputs(seed, depth=depth)
    c = bins.shape[1]
    cat, fa = np.zeros(c, bool), np.ones(c, bool)
    r = rt.grow_tree_jit(jnp.asarray(bins), jnp.asarray(stats),
                         jnp.asarray(cat), jnp.asarray(fa), N_BINS, depth,
                         "variance", 1.0, 0.0, record_hists=True)
    p = pt.grow_tree(*(torch.from_numpy(a) for a in (bins, stats, cat, fa)),
                     N_BINS, depth, "variance", 1.0, 0.0, record_hists=True)
    np.testing.assert_array_equal(p[0].numpy(), np.asarray(r[0]))
    scale = np.abs(stats).sum(0)                 # per channel
    for got, want in ((p[5], r[5]), (p[6], r[6])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6 * scale.max())
    hl, raw = pt.build_path_histograms(torch.from_numpy(bins),
                                       torch.from_numpy(stats), p[0], p[1],
                                       depth, N_BINS)
    rhl, rraw = rt.build_path_histograms(jnp.asarray(bins),
                                         jnp.asarray(stats), r[0], r[1],
                                         depth, N_BINS)
    np.testing.assert_allclose(hl.numpy(), np.asarray(rhl), rtol=1e-5,
                               atol=1e-6 * scale.max())
    np.testing.assert_allclose(raw.numpy(), np.asarray(rraw), rtol=1e-5,
                               atol=1e-6 * scale.max())
    assert hl.numpy().tobytes() == p[5].numpy().tobytes()
    assert raw.numpy().tobytes() == p[6].numpy().tobytes()


@pytest.mark.parametrize("valid_upto", [0, 1, 3])
def test_stale_tail_evidence_steers_the_grow_as_the_reference(valid_upto):
    """``grow_tree`` with ``tail_extra`` (the previous pass's tail-only
    left histograms) decides its splits as the reference's does, the
    evidence gated by ``valid_upto`` and by the previous tree's prefix."""
    import jax.numpy as jnp

    from shifu_tpu.ops import tree as rt
    from shifu_tpu_torch.ops import tree as pt
    depth = 3
    bins, stats = _ops_inputs(7, depth=depth)
    tbins, tstats = _ops_inputs(8, n=600, depth=depth)
    c = bins.shape[1]
    cat, fa = np.zeros(c, bool), np.ones(c, bool)
    # the previous tree: grown on the full data; the evidence: its tail
    # rows' path histograms
    allb = np.concatenate([bins, tbins])
    alls = np.concatenate([stats, tstats])
    prev = pt.grow_tree(*(torch.from_numpy(a) for a in (allb, alls, cat,
                                                         fa)),
                        N_BINS, depth, "variance", 1.0, 0.0)
    extra, _ = pt.build_path_histograms(torch.from_numpy(tbins),
                                        torch.from_numpy(tstats), prev[0],
                                        prev[1], depth, N_BINS)
    p = pt.grow_tree(*(torch.from_numpy(a) for a in (bins, stats, cat, fa)),
                     N_BINS, depth, "variance", 1.0, 0.0, record_hists=True,
                     tail_extra=extra, prev_sf=prev[0], prev_lm=prev[1],
                     valid_upto=valid_upto)
    r = rt.grow_tree_jit(jnp.asarray(bins), jnp.asarray(stats),
                         jnp.asarray(cat), jnp.asarray(fa), N_BINS, depth,
                         "variance", 1.0, 0.0, record_hists=True,
                         tail_extra=jnp.asarray(extra.numpy()),
                         prev_sf=jnp.asarray(prev[0].numpy()),
                         prev_lm=jnp.asarray(prev[1].numpy()),
                         valid_upto=jnp.int32(valid_upto))
    np.testing.assert_array_equal(p[0].numpy(), np.asarray(r[0]))
    np.testing.assert_array_equal(p[1].numpy(), np.asarray(r[1]))
    # the evidence only steers decisions: the recorded histograms are the
    # resident rows' own along the structure grown
    hl, raw = pt.build_path_histograms(torch.from_numpy(bins),
                                       torch.from_numpy(stats), p[0], p[1],
                                       depth, N_BINS)
    assert p[5].numpy().tobytes() == hl.numpy().tobytes()
    assert p[6].numpy().tobytes() == raw.numpy().tobytes()


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_node_index_and_predict_match_the_reference(level):
    import jax.numpy as jnp

    from shifu_tpu.ops import tree as rt
    from shifu_tpu_torch.ops import tree as pt
    bins, stats = _ops_inputs(3)
    c = bins.shape[1]
    cat, fa = np.zeros(c, bool), np.ones(c, bool)
    p = pt.grow_tree(*(torch.from_numpy(a) for a in (bins, stats, cat, fa)),
                     N_BINS, 3, "variance", 5.0, 0.0)
    tb = torch.from_numpy(bins)
    got = pt.node_index_at_level(p[0], p[1], tb, level).numpy()
    want = np.asarray(rt.node_index_at_level(
        jnp.asarray(p[0].numpy()), jnp.asarray(p[1].numpy()),
        jnp.asarray(bins), level))
    np.testing.assert_array_equal(got, want)
    pred = pt.predict_tree(p[0], p[1], p[2], tb, 3).numpy()
    np.testing.assert_array_equal(pred, p[2].numpy()[p[4].numpy()])
    np.testing.assert_array_equal(pred, np.asarray(rt.predict_tree(
        jnp.asarray(p[0].numpy()), jnp.asarray(p[1].numpy()),
        jnp.asarray(p[2].numpy()), jnp.asarray(bins), 3)))


# ---------------------------------------------------------------- resume
class _Checkpoints:
    """A checkpoint_fn keeping every commit: (trees, history, init, f)."""

    def __init__(self):
        self.saved = []

    def __call__(self, trees, history, init_score, scores=None):
        self.saved.append((list(trees), [tuple(h) for h in history],
                           init_score,
                           None if scores is None else scores.copy()))


@pytest.mark.parametrize("regime", ["resident", "exact", "c2f"])
@pytest.mark.parametrize("sidecar", [True, False])
def test_streamed_gbt_resume_is_bit_identical(planes, regime, sidecar):
    """Six trees with a checkpoint every three, then a resume from the
    first checkpoint: the same forest and errors bit for bit, with the
    per-row score sidecar or without it (the restored trees then replay
    through the forest walk, window by window)."""
    from shifu_tpu_torch.train.dt_trainer import (DTSettings,
                                                  train_gbt_streamed)
    budget = RESIDENT if regime == "resident" else TAIL["gbt"]
    c2f = {"resident": None, "exact": "0", "c2f": "1"}[regime]
    old = os.environ.get("SHIFU_TREE_TAIL_C2F")
    if c2f is not None:
        os.environ["SHIFU_TREE_TAIL_C2F"] = c2f
    try:
        s = DTSettings(**dict(GBT, n_trees=6, checkpoint_every=3))
        ck = _Checkpoints()
        full = train_gbt_streamed(_stream("port", planes["plain", "port"]),
                                  N_BINS, None, s, checkpoint_fn=ck,
                                  cache_budget=budget, device="cpu")
        trees, history, init, scores = ck.saved[0]
        assert len(trees) == 3
        res = train_gbt_streamed(
            _stream("port", planes["plain", "port"]), N_BINS, None,
            dataclasses.replace(s, resume=True), init_trees=trees,
            init_score=init, start_history=history,
            init_scores=scores if sidecar else None, cache_budget=budget,
            device="cpu")
    finally:
        if old is None:
            os.environ.pop("SHIFU_TREE_TAIL_C2F", None)
        else:
            os.environ["SHIFU_TREE_TAIL_C2F"] = old
    _assert_bits(full, res)
    assert res.history == full.history
    assert full.spec_kwargs == res.spec_kwargs


@pytest.mark.parametrize("budget", [RESIDENT, TAIL["rf"]])
@pytest.mark.parametrize("plane,k", [("plain", 0), ("mc", 3)])
def test_streamed_rf_resume_is_bit_identical(planes, budget, plane, k):
    from shifu_tpu_torch.train.dt_trainer import (DTSettings,
                                                  train_rf_streamed)
    s = DTSettings(**dict(RF, n_classes=k, checkpoint_every=4))
    ck = _Checkpoints()
    full = train_rf_streamed(_stream("port", planes[plane, "port"]), N_BINS,
                             None, s, checkpoint_fn=ck, cache_budget=budget,
                             device="cpu")
    trees, history, _, _ = ck.saved[0]
    assert len(trees) == 4
    res = train_rf_streamed(_stream("port", planes[plane, "port"]), N_BINS,
                            None, s, init_trees=trees,
                            start_history=history, cache_budget=budget,
                            device="cpu")
    _assert_bits(full, res)
    assert res.history == full.history


# ------------------------------------------------------------ pipeline
def _configure(d, algorithm="GBT", params=None, bags=1):
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.train.algorithm = Algorithm[algorithm]
    mc.train.params = dict(params if params is not None else {
        "TreeNum": 4, "MaxDepth": 3, "Loss": "log", "LearningRate": 0.1,
        "MinInfoGain": 1e-3})
    mc.train.baggingNum = bags
    mc.save(path)


STREAM_PROPS = {"shifu.train.streaming": "on",
                "shifu.train.windowRows": "1000"}


def _run(pkg, d, step, **params):
    props = params.pop("_props", STREAM_PROPS)
    env = j_environment if pkg == "ref" else environment
    for k, v in props.items():
        env.set_property(k, v)
    try:
        if pkg == "ref":
            if step == "train":
                from shifu_tpu.pipeline.train import TrainProcessor as P
            else:
                from shifu_tpu.pipeline.evaluate import EvalProcessor as P
            assert P(d, params=params).run() == 0
        else:
            if step == "train":
                from shifu_tpu_torch.pipeline.train import TrainProcessor as P
            else:
                from shifu_tpu_torch.pipeline.evaluate import \
                    EvalProcessor as P
            assert P(d, params=params, device="cpu").run() == 0
    finally:
        env.reset_for_tests()


def _auc(d):
    with open(os.path.join(d, "evals", "Eval1", "EvalPerformance.json")) as f:
        return json.load(f)["areaUnderRoc"]


@pytest.mark.parametrize("alg", ["GBT", "RF"])
def test_cli_streamed_train_matches_the_reference_and_evals(prepared_set,
                                                            tmp_path, alg,
                                                            caplog):
    """``train -Dshifu.train.streaming=on`` on the prepared set: the port
    logs its streamed run, writes the model the reference loads, and the
    reference's model scores in the port; ``eval -run`` AUCs agree within
    0.005."""
    import logging
    params = None if alg == "GBT" else {
        "TreeNum": 4, "MaxDepth": 4, "Impurity": "entropy",
        "MinInfoGain": 1e-3}
    dirs = {}
    for pkg in ("ref", "port"):
        d = dirs[pkg] = str(tmp_path / pkg)
        shutil.copytree(prepared_set, d)
        _configure(d, alg, params)
        with caplog.at_level(logging.INFO):
            _run(pkg, d, "train")
    assert re.search(rf"train {alg} STREAMED on cpu: 4000 rows, window 1000",
                     caplog.text)
    ext = alg.lower()
    from shifu_tpu.models.tree import load_model as j_load
    from shifu_tpu_torch.models.tree import load_model
    for src, loader in (("port", j_load), ("ref", load_model)):
        spec, trees = loader(os.path.join(dirs[src], "models",
                                          f"model0.{ext}"))
        assert spec.n_trees == len(trees) == 4
    _, pt = load_model(os.path.join(dirs["port"], "models", f"model0.{ext}"))
    _, rt = load_model(os.path.join(dirs["ref"], "models", f"model0.{ext}"))
    for a, b in zip(pt, rt):
        np.testing.assert_array_equal(a.split_feat[:3], b.split_feat[:3])
    # cross-load: each package scores the other's model files
    for pkg in ("ref", "port"):
        shutil.copytree(os.path.join(dirs[pkg], "models"),
                        os.path.join(str(tmp_path), "saved", pkg))
    for pkg in ("ref", "port"):
        other = "port" if pkg == "ref" else "ref"
        shutil.rmtree(os.path.join(dirs[pkg], "models"))
        shutil.copytree(os.path.join(str(tmp_path), "saved", other),
                        os.path.join(dirs[pkg], "models"))
    aucs = {}
    for pkg in ("ref", "port"):
        _run(pkg, dirs[pkg], "eval", run_eval="Eval1", _props={})
        aucs[pkg] = _auc(dirs[pkg])
    assert abs(aucs["ref"] - aucs["port"]) <= 0.005
    assert aucs["port"] > 0.6


def test_streamed_bagged_member_equals_a_single_streamed_run(prepared_set,
                                                             tmp_path):
    """``baggingNum 3`` on a streamed plane trains three sequential
    out-of-core members; member 1 is bit for bit the forest of one
    ``train_gbt_streamed`` run with ``_streamed_bag_mask_fn(member=1)``
    and seed + 1."""
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.models.tree import load_model
    from shifu_tpu_torch.train import dt_trainer as dt
    d = str(tmp_path / "set")
    shutil.copytree(prepared_set, d)
    _configure(d, bags=3)
    _run("port", d, "train")
    models = sorted(f for f in os.listdir(os.path.join(d, "models"))
                    if f.startswith("model"))
    assert models == ["model0.gbt", "model1.gbt", "model2.gbt"]
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    from shifu_tpu_torch.config import load_column_configs
    by_num = {c.columnNum: c for c in load_column_configs(
        os.path.join(d, "ColumnConfig.json"))}
    shards = Shards.open(os.path.join(d, "tmp", "CleanedData"))
    col_nums = shards.schema["columnNums"]
    cat = np.array([by_num[cn].is_categorical() for cn in col_nums])
    n_bins = max(by_num[cn].num_bins() + 1 for cn in col_nums)
    base = dt.settings_from_params(mc.train.params, mc.train,
                                   mc.train.algorithm)
    base.stats_exact = not mc.dataSet.weightColumnName
    for k, v in STREAM_PROPS.items():
        environment.set_property(k, v)
    single = dt.train_gbt_streamed(
        dt._tree_stream(shards), n_bins, cat,
        dataclasses.replace(base, seed=base.seed + 1),
        mask_fn=dt._streamed_bag_mask_fn(mc, False, 3, base.seed, 1),
        device="cpu")
    _, member = load_model(os.path.join(d, "models", "model1.gbt"))
    _, m0 = load_model(os.path.join(d, "models", "model0.gbt"))
    _assert_bits(single, dt.ForestResult(member, {}, 0, 0, None))
    assert any((a.leaf_value != b.leaf_value).any()
               for a, b in zip(member, m0))


def test_streamed_grid_trials_rank_and_save_the_best(prepared_set, tmp_path):
    d = str(tmp_path / "set")
    shutil.copytree(prepared_set, d)
    _configure(d, params={"TreeNum": 3, "MaxDepth": [2, 3], "Loss": "log",
                          "LearningRate": 0.1})
    _run("port", d, "train")
    with open(os.path.join(d, "tmp", "grid_search.json")) as f:
        report = json.load(f)
    assert len(json.dumps(report)) > 10
    assert os.path.isfile(os.path.join(d, "models", "model0.gbt"))
    text = open(os.path.join(d, "tmp", "train.progress")).read()
    assert "Trial [0]" in text and "Trial [1]" in text


# ------------------------------------------------------ one-vs-all
TAGS = ["alpha", "beta", "gamma"]


@pytest.fixture(scope="module")
def three_class(tmp_path_factory):
    """A three-class model set over a 1,200-row CSV (three informative
    columns), prepared by the reference's init, stats (EqualTotal) and
    norm."""
    from shifu_tpu.config import ModelConfig
    from shifu_tpu.config.model_config import BinningMethod
    from shifu_tpu.pipeline.create import InitProcessor, create_new_model
    from shifu_tpu.pipeline.norm import NormalizeProcessor
    from shifu_tpu.pipeline.stats import StatsProcessor
    root = tmp_path_factory.mktemp("torch_stream_mc")
    rng = np.random.default_rng(5)
    n = 1200
    y = rng.integers(0, 3, n)
    f = [rng.normal(size=n) + (y == k) * 2.5 for k in range(3)]
    lines = ["id|f1|f2|f3|tag"] + [
        f"r{i}|{f[0][i]:.5f}|{f[1][i]:.5f}|{f[2][i]:.5f}|{TAGS[y[i]]}"
        for i in range(n)]
    csv = os.path.join(str(root), "mc.csv")
    with open(csv, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    meta = os.path.join(str(root), "meta.names")
    with open(meta, "w") as fh:
        fh.write("id\n")
    d = create_new_model("mcstream", base_dir=str(root))
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    ds = mc.dataSet
    ds.dataPath, ds.dataDelimiter, ds.targetColumnName = csv, "|", "tag"
    ds.posTags, ds.negTags, ds.metaColumnNameFile = list(TAGS), [], meta
    mc.stats.binningMethod = BinningMethod.EqualTotal
    mc.save(path)
    assert InitProcessor(d).run() == 0
    assert StatsProcessor(d, params={}).run() == 0
    assert NormalizeProcessor(d, params={}).run() == 0
    return d


@pytest.mark.parametrize("alg,bags,method,files", [
    ("GBT", 1, "ONEVSALL", ["model0.gbt", "model1.gbt", "model2.gbt"]),
    ("RF", 1, "ONEVSALL", ["model0.rf", "model1.rf", "model2.rf"]),
    ("GBT", 2, "ONEVSALL", [f"model{i}.gbt" for i in range(6)]),
    ("RF", 1, "NATIVE", ["model0.rf"])])
def test_streamed_multiclass_matches_the_reference(three_class, tmp_path,
                                                   alg, bags, method, files):
    """One-vs-all (one streamed forest a class), OVA x bagging (K x B
    streamed jobs) and the native multi-class RF on a streamed plane with
    a disk tail: the reference's model files, split features equal,
    leaves within rtol 1e-5."""
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import (Algorithm,
                                                     MultipleClassification)
    from shifu_tpu_torch.models.tree import load_model
    params = {"TreeNum": 3, "MaxDepth": 2, "MinInfoGain": 1e-3}
    params.update({"Loss": "log", "LearningRate": 0.2} if alg == "GBT"
                  else {"Impurity": "entropy"})
    props = dict(STREAM_PROPS, **{"shifu.train.windowRows": "256",
                                  "shifu.train.deviceCacheBytes": "3000"})
    got = {}
    for pkg in ("ref", "port"):
        d = str(tmp_path / pkg)
        shutil.copytree(three_class, d)
        path = os.path.join(d, "ModelConfig.json")
        mc = ModelConfig.load(path)
        mc.train.algorithm = Algorithm[alg]
        mc.train.params = params
        mc.train.baggingNum = bags
        mc.train.multiClassifyMethod = MultipleClassification[method]
        mc.save(path)
        _run(pkg, d, "train", _props=props)
        mdir = os.path.join(d, "models")
        assert sorted(f for f in os.listdir(mdir)
                      if f.startswith("model")) == files
        got[pkg] = {f: load_model(os.path.join(mdir, f)) for f in files}
    for f in files:
        (sp, tp), (sr, tr) = got["port"][f], got["ref"][f]
        assert sp.extra == sr.extra
        for a, b in zip(tp, tr):
            np.testing.assert_array_equal(a.split_feat, b.split_feat)
            np.testing.assert_allclose(a.leaf_value, b.leaf_value,
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("alg", ["NN", "LR"])
def test_streamed_nn_and_lr_still_raise_naming_item_8(prepared_set, alg,
                                                      monkeypatch):
    """Streamed NN/LR was ROADMAP item 8 and raised naming it; it is
    ported (``tests/test_torch_nn_streamed.py``): with streaming on it
    trains out of core and writes its model, and with the elastic combine
    on (``-Dshifu.dcn.elastic`` and a controller id, no coordinator) it
    closes every epoch and the closing eval on the step board."""
    from shifu_tpu_torch.cli import main
    _configure(prepared_set, alg, {})
    set_conf = os.path.join(prepared_set, "ModelConfig.json")
    with open(set_conf) as f:
        conf = json.load(f)
    conf["train"]["numTrainEpochs"] = 2
    with open(set_conf, "w") as f:
        json.dump(conf, f)
    monkeypatch.delenv("SHIFU_COORDINATOR", raising=False)
    monkeypatch.setenv("SHIFU_PROCESS_ID", "0")
    assert main(["-Dshifu.train.streaming=on", "-Dshifu.dcn.elastic=true",
                 "-Dshifu.train.windowRows=1000", "--dir", prepared_set,
                 "train", "--device", "cpu"]) == 0
    steps = os.path.join(prepared_set, "telemetry", "steps")
    assert sorted(f for f in os.listdir(steps) if f.startswith("close-")) \
        == [f"close-{i:06d}.json" for i in range(3)]
    monkeypatch.delenv("SHIFU_PROCESS_ID")
    environment.reset_for_tests()
    assert main(["-Dshifu.train.streaming=on", "-Dshifu.train.windowRows="
                 "1000", "--dir", prepared_set, "train", "--device",
                 "cpu"]) == 0
    assert os.path.isfile(os.path.join(prepared_set, "models",
                                       f"model0.{alg.lower()}"))
