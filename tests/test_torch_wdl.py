"""``shifu_tpu_torch.models.wdl`` and the WDL half of ``ops/hashing.py``
against ``shifu_tpu``'s on the CPU.

The reference's ``shifu_tpu.models.wdl`` does not import under this jax
(ROADMAP Queue 3, C1: its ``p in batching.primitive_batchers`` meets a
``PrimitiveBatchersProxy``, which has no ``__contains__``).
:func:`reference_wdl` reaches it for the span of a ``with`` block: it gives
the proxy a ``__contains__`` that reads ``fancy_primitive_batchers``
(where ``optimization_barrier_p`` is registered already, so the module's
own hook returns at once and jax is unchanged), imports the reference's
WDL modules, and on exit removes the attribute, drops every ``shifu_tpu``
module the block imported from ``sys.modules`` and from its parent
package.  A later ``from shifu_tpu.models import wdl`` in the same process
then fails as it did before, so the reference's own WDL tests pass or
fail whatever ran first in their worker.  No test file imports a
reference WDL module at module level.

The reference runs under ``jax.enable_x64(False)`` (C3: under the rig's
64-bit mode its logit sums and initial weights are float64).

Tolerances: initial weights bit-equal, except the normal draws (the
embeddings and the He deep layers), whose ``erf_inv`` ``log1p`` differs
from XLA's in the last bit for about 1% of draws (``ops/prng.py``): the
embeddings within 1 ulp, the He layers (scaled once more) within 2.
Forward within 1e-6 (abs) of both reference lowerings.  Loss rtol 1e-6; gradients rtol 1e-5 (+1e-7): the one-hot lowering's
embedding gradient is a matmul where the gather's is a scatter-add.
Hashed bucket ids, model files and spec bytes equal.
"""

import contextlib
import importlib
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shifu_tpu_torch.models import wdl as P
from shifu_tpu_torch.ops import hashing as PH
from shifu_tpu_torch.ops import prng

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while the module runs: its tensors are small,
    and under ``-n 6`` a pool a worker oversubscribes the cores, which
    slows the step-by-step loops (the SVM dual's 2,000 iterations) a
    hundredfold."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

# reference modules the WDL ones import, loaded before the shim so that
# only the WDL modules are new inside it (and dropped after it)
_SHARED = ("shifu_tpu.config", "shifu_tpu.models", "shifu_tpu.models.nn",
           "shifu_tpu.ops.hashing", "shifu_tpu.data.shards",
           "shifu_tpu.data.streaming", "shifu_tpu.parallel.mesh",
           "shifu_tpu.train.nn_trainer", "shifu_tpu.train.optimizers",
           "shifu_tpu.train.sampling", "shifu_tpu.train.early_stop",
           "shifu_tpu.train.checkpoint", "shifu_tpu.train.grid_search",
           "shifu_tpu.pipeline.train", "shifu_tpu.pipeline.evaluate",
           "shifu_tpu.pipeline.norm", "shifu_tpu.pipeline.export",
           "shifu_tpu.pipeline.combo", "shifu_tpu.serve.scorer",
           "shifu_tpu.eval.scorer", "shifu_tpu.export.reference_spec",
           "shifu_tpu.models.reference_import", "shifu_tpu.models.svm")


@contextlib.contextmanager
def reference_wdl():
    """The reference's WDL modules (``wdl``, ``trainer``) for the span of
    the block, under ``jax.enable_x64(False)``; see the module docs."""
    for name in _SHARED:
        importlib.import_module(name)
    from jax._src.interpreters import batching
    proxy = batching.PrimitiveBatchersProxy
    patched = "__contains__" not in vars(proxy)
    before = set(sys.modules)
    if patched:
        proxy.__contains__ = \
            lambda self, p: p in batching.fancy_primitive_batchers
    try:
        from shifu_tpu.models import wdl
        from shifu_tpu.train import wdl_trainer
        with jax.enable_x64(False):
            yield SimpleNamespace(wdl=wdl, trainer=wdl_trainer)
    finally:
        if patched:
            del proxy.__contains__
        for name in sorted(set(sys.modules) - before, reverse=True):
            if name.split(".")[0] != "shifu_tpu":
                continue
            del sys.modules[name]
            parent, _, child = name.rpartition(".")
            if parent in sys.modules and \
                    child in vars(sys.modules[parent]):
                delattr(sys.modules[parent], child)


def _spec(cls, cards=(4, 7, 3), numeric=5, **kw):
    return cls(numeric_dim=numeric, cat_cardinalities=list(cards),
               embed_dim=kw.pop("embed_dim", 3),
               hidden_nodes=kw.pop("hidden_nodes", [6, 4]),
               activations=kw.pop("activations", ["relu", "sigmoid"]), **kw)


def _ref_params(R, spec, seed=0):
    """Reference init, wide weights and bias made non-zero."""
    p = R.wdl.init_params(jax.random.PRNGKey(seed), spec)
    rng = np.random.default_rng(seed + 100)
    if spec.wide_enable:
        p["wide_cat"] = [jnp.asarray(rng.normal(size=v.shape)
                                     .astype(np.float32) * 0.3)
                         for v in p["wide_cat"]]
        p["wide_num"] = jnp.asarray(rng.normal(
            size=p["wide_num"].shape).astype(np.float32) * 0.3)
    p["bias"] = jnp.asarray([0.125], jnp.float32)
    return p


def _inputs(n, numeric, cards, seed=1):
    rng = np.random.default_rng(seed)
    xn = rng.normal(size=(n, numeric)).astype(np.float32)
    # ids past a column's cardinality and negative ones clip, as the
    # reference's gather clips
    xc = np.stack([rng.integers(-1, c + 2, n) for c in cards],
                  axis=1).astype(np.int32)
    return xn, xc


def test_shim_is_scoped():
    with reference_wdl() as R:
        assert R.wdl.WDLModelSpec
    assert "shifu_tpu.models.wdl" not in sys.modules
    with pytest.raises(TypeError):
        from shifu_tpu.models import wdl  # noqa: F401


@pytest.mark.parametrize("deep,wide", [(True, True), (True, False),
                                       (False, True)])
def test_init_matches_the_reference(deep, wide):
    with reference_wdl() as R:
        rs = _spec(R.wdl.WDLModelSpec, deep_enable=deep, wide_enable=wide)
        ref = R.wdl.init_params(jax.random.PRNGKey(3), rs)
        ref = {k: (np.asarray(v) if not isinstance(v, list) else
                   [{kk: np.asarray(vv) for kk, vv in x.items()}
                    if isinstance(x, dict) else np.asarray(x) for x in v])
               for k, v in ref.items()}
    ps = P.WDLModelSpec.from_json(rs.to_json())
    got = P.columns_of(ps, P.init_params(prng.prng_key(3), ps))
    assert sorted(got) == sorted(ref)
    np.testing.assert_array_equal(got["bias"], ref["bias"])
    if wide:
        for g, r in zip(got["wide_cat"], ref["wide_cat"]):
            np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(got["wide_num"], ref["wide_num"])
    if deep:
        for g, r in zip(got["embed"], ref["embed"]):
            assert g.dtype == r.dtype == np.float32
            np.testing.assert_array_max_ulp(g, r, maxulp=1)
        for g, r in zip(got["deep"], ref["deep"]):
            np.testing.assert_array_max_ulp(g["w"], r["w"], maxulp=2)
            np.testing.assert_array_equal(g["b"], r["b"])


@pytest.mark.parametrize("case", ["onehot", "gather", "wide_only",
                                  "deep_only"])
def test_forward_matches_the_reference(case):
    """``onehot``: 256 rows x 3 small columns take the reference's one-hot
    einsum; ``gather``: one column of 40,000 categories over 1,024 rows
    puts N·C·K past 2^25, so the reference gathers."""
    cards = {"gather": (40_000, 5)}.get(case, (4, 7, 3))
    n = 1024 if case == "gather" else 256
    kw = {"wide_only": {"deep_enable": False},
          "deep_only": {"wide_enable": False}}.get(case, {})
    with reference_wdl() as R:
        rs = _spec(R.wdl.WDLModelSpec, cards, **kw)
        rp = _ref_params(R, rs)
        xn, xc = _inputs(n, rs.numeric_dim, cards)
        if case != "gather":
            assert n * len(cards) * max(cards) <= R.wdl._ONEHOT_MAX_ELEMS
        else:
            assert n * len(cards) * max(cards) > R.wdl._ONEHOT_MAX_ELEMS
        want = np.asarray(R.wdl.forward(rp, rs, jnp.asarray(xn),
                                        jnp.asarray(xc)))
        cols = jax.tree_util.tree_map(np.asarray, rp)
    ps = P.WDLModelSpec.from_json(rs.to_json())
    params = P.from_columns(ps, cols)
    got = P.forward(params, ps, torch.from_numpy(xn),
                    torch.from_numpy(xc)).numpy()
    assert got.shape == want.shape == (n, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # stacked members score as each alone
    stacked = {k: (torch.stack([v, v]) if not isinstance(v, list) else
                   [{kk: torch.stack([vv, vv]) for kk, vv in x.items()}
                    for x in v]) for k, v in params.items()}
    two = P.forward(stacked, ps, torch.from_numpy(xn),
                    torch.from_numpy(xc)).numpy()
    np.testing.assert_allclose(two[1], got, rtol=0, atol=1e-6)


def test_loss_and_gradients_match_the_reference():
    with reference_wdl() as R:
        rs = _spec(R.wdl.WDLModelSpec)
        rp = _ref_params(R, rs)
        xn, xc = _inputs(200, rs.numeric_dim, rs.cat_cardinalities)
        rng = np.random.default_rng(5)
        y = (rng.random(200) < 0.4).astype(np.float32)[:, None]
        w = rng.uniform(0.5, 2.0, 200).astype(np.float32)
        args = (rs, jnp.asarray(xn), jnp.asarray(xc), jnp.asarray(y),
                jnp.asarray(w), 1e-3)
        want_loss = float(R.wdl.weighted_loss(rp, *args))
        want_g = jax.grad(R.wdl.weighted_loss)(rp, *args)
        want_g = jax.tree_util.tree_map(np.asarray, want_g)
        want_l2 = jax.tree_util.tree_map(np.asarray,
                                         R.wdl.l2_grads(rp, 1e-3))
        cols = jax.tree_util.tree_map(np.asarray, rp)
    ps = P.WDLModelSpec.from_json(rs.to_json())
    params = {k: v for k, v in P.from_columns(ps, cols).items()}
    from shifu_tpu_torch.train.checkpoint import tree_leaves, tree_unflatten
    from shifu_tpu_torch.train.optimizers import tree_map
    params = tree_map(lambda t: t.requires_grad_(True), params)
    loss = P.weighted_loss(params, ps, torch.from_numpy(xn),
                           torch.from_numpy(xc), torch.from_numpy(y),
                           torch.from_numpy(w), l2=1e-3)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-6)
    leaves = tree_leaves(params)
    grads = P.columns_of(ps, tree_unflatten(
        params, list(torch.autograd.grad(loss, leaves))))
    for k in ("bias", "wide_num"):
        np.testing.assert_allclose(grads[k], want_g[k], rtol=1e-5,
                                   atol=1e-7)
    for k in ("embed", "wide_cat"):
        for g, r in zip(grads[k], want_g[k]):
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-7)
    for g, r in zip(grads["deep"], want_g["deep"]):
        for kk in ("w", "b"):
            np.testing.assert_allclose(g[kk], r[kk], rtol=1e-5, atol=1e-7)
    l2 = P.columns_of(ps, P.l2_grads(P.from_columns(ps, cols), 1e-3))
    for g, r in zip(l2["embed"], want_l2["embed"]):
        np.testing.assert_allclose(g, r, rtol=1e-6)
    for g, r in zip(l2["deep"], want_l2["deep"]):
        np.testing.assert_allclose(g["w"], r["w"], rtol=1e-6)
        np.testing.assert_array_equal(g["b"], r["b"])
    np.testing.assert_array_equal(l2["wide_num"], want_l2["wide_num"])


def test_model_files_load_in_either_package(tmp_path):
    port_path = str(tmp_path / "port.wdl")
    ref_path = str(tmp_path / "ref.wdl")
    with reference_wdl() as R:
        rs = _spec(R.wdl.WDLModelSpec, extra={"num_feat_idx": [0, 1]})
        rp = _ref_params(R, rs)
        R.wdl.save_model(ref_path, rs, rp)
        ps = P.WDLModelSpec.from_json(rs.to_json())
        P.save_model(port_path, ps, P.from_columns(
            ps, jax.tree_util.tree_map(np.asarray, rp)))
        rs2, rp2 = R.wdl.load_model(port_path)
        assert rs2 == rs
        ref_cols = jax.tree_util.tree_map(np.asarray, rp2)
        from shifu_tpu.models import load_any
        assert type(load_any(port_path)).__name__ == "IndependentWDLModel"
    ps2, pp2 = P.load_model(ref_path)
    assert ps2 == ps
    got = P.columns_of(ps2, pp2)
    for k in ("embed", "wide_cat"):
        for g, r in zip(got[k], ref_cols[k]):
            np.testing.assert_array_equal(g, r)
    for g, r in zip(got["deep"], ref_cols["deep"]):
        np.testing.assert_array_equal(g["w"], r["w"])
    np.testing.assert_array_equal(got["bias"], ref_cols["bias"])
    from shifu_tpu_torch.models import load_any as p_load
    m = p_load(ref_path)
    assert type(m).__name__ == "IndependentWDLModel"
    assert m.input_kind == "both"


@pytest.mark.parametrize("buckets", [1, 32, 1000, (1 << 31) - 1])
def test_hash_buckets_match_the_reference(buckets):
    from shifu_tpu.ops import hashing as RH
    rng = np.random.default_rng(buckets % 97)
    ids = rng.integers(-2, 1 << 31, 20_000).astype(np.int64)
    for col in (0, 7, 250):
        key = RH.column_hash_key(col)
        assert PH.column_hash_key(col) == key
        host = RH.hash_bucket_host(ids, key, buckets)
        np.testing.assert_array_equal(PH.hash_bucket_host(ids, key, buckets),
                                      host)
        dev = PH.hash_bucket_device(torch.from_numpy(ids), key, buckets)
        np.testing.assert_array_equal(dev.numpy(), host)
        jd = RH.hash_bucket_device(jnp.asarray(ids.astype(np.int32)), key,
                                   buckets)
        np.testing.assert_array_equal(np.asarray(jd), host)


def test_hashed_columns_fold_alike_on_host_and_device():
    cards = (60, 5, 45)
    with reference_wdl() as R:
        rs = _spec(R.wdl.WDLModelSpec, (32, 5, 32), extra={
            "hash_buckets": 32, "hashed_cols": [0, 2],
            "hash_keys": [PH.column_hash_key(3), PH.column_hash_key(9)]})
        _, xc = _inputs(500, 1, cards)
        want = R.wdl.apply_hash_host(rs, xc)
        want_dev = np.asarray(R.wdl.apply_hash_device(rs, jnp.asarray(xc)))
    ps = P.WDLModelSpec.from_json(rs.to_json())
    np.testing.assert_array_equal(P.apply_hash_host(ps, xc), want)
    np.testing.assert_array_equal(
        P.apply_hash_device(ps, torch.from_numpy(xc)).numpy(), want)
    np.testing.assert_array_equal(want_dev, want)
    assert want[:, 0].max() < 32 and (want[:, 1] == xc[:, 1]).all()


def _golden():
    """``tests/test_wdl_golden.py``'s pinned model, built in the port."""
    from test_wdl_golden import _grid
    from shifu_tpu_torch.config.column_config import (ColumnConfig,
                                                      ColumnType)

    def cc(num, name, cats=None, bounds=None, mean=0.25):
        c = ColumnConfig(columnNum=num, columnName=name,
                         columnType=ColumnType.C if cats else ColumnType.N)
        b = c.columnBinning
        b.binCategory, b.binBoundary = cats, bounds
        b.binCountNeg, b.binCountPos = [10, 5], [2, 3]
        b.binCountWoe, b.binWeightedWoe = [-0.5, 0.75], [-0.25, 0.5]
        b.binPosRate = [0.125, 0.375]
        c.columnStats.mean, c.columnStats.stdDev = mean, 1.25
        return c

    spec = P.WDLModelSpec(numeric_dim=2, cat_cardinalities=[3, 2],
                          embed_dim=2, hidden_nodes=[3],
                          activations=["relu"], column_nums=[1, 2],
                          cat_column_nums=[5, 6])
    params = P.from_columns(spec, {
        "embed": [_grid((3, 2)), _grid((2, 2), offset=-0.25)],
        "deep": [{"w": _grid((6, 3)), "b": _grid((3,), offset=0.0)},
                 {"w": _grid((3, 1), offset=0.375), "b": _grid((1,))}],
        "wide_cat": [_grid((3,), offset=0.125), _grid((2,), offset=-0.375)],
        "wide_num": _grid((2, 1), offset=0.5),
        "bias": np.asarray([0.25], np.float32)})
    ccs = [cc(1, "num1", bounds=[float("-inf"), 0.5]),
           cc(2, "num2", bounds=[float("-inf"), 0.0], mean=-0.75),
           cc(5, "catA", cats=["a", "b"]), cc(6, "catB", cats=["x"])]
    return spec, params, ccs


def test_spec_round_trip_scores_as_the_native_model(tmp_path):
    """The golden model (``tests/test_torch_export.py`` pins its bytes)
    written and re-read scores as the native model, hashed plan aside."""
    from shifu_tpu_torch.export.reference_spec import write_reference_wdl
    from shifu_tpu_torch.models.reference_import import load_reference_wdl
    spec, params, ccs = _golden()
    path = str(tmp_path / "model0.wdl")
    write_reference_wdl(path, spec, params, ccs)
    spec2, params2, _ = load_reference_wdl(path)
    xn, xc = _inputs(64, 2, spec.cat_cardinalities)
    np.testing.assert_allclose(
        P.IndependentWDLModel(spec2, params2).compute(xn, xc, device="cpu"),
        P.IndependentWDLModel(spec, params).compute(xn, xc, device="cpu"),
        rtol=1e-5, atol=1e-7)


def test_spec_refusals_follow_the_reference(tmp_path):
    from shifu_tpu_torch.config.errors import ShifuError
    from shifu_tpu_torch.export.reference_spec import write_reference_wdl
    spec, params, ccs = _golden()
    for bad in ({"activations": ["tanh"]}, {"deep_enable": False}):
        s = P.WDLModelSpec.from_json(spec.to_json())
        for k, v in bad.items():
            setattr(s, k, v)
        with pytest.raises(ShifuError):
            write_reference_wdl(str(tmp_path / "m.wdl"), s, params, ccs)


def test_independent_model_scores_the_full_planes():
    """``compute_full`` slices its planes by the spec's index lists and
    hashes on the way; host arrays and tensors score alike."""
    with reference_wdl() as R:
        rs = _spec(R.wdl.WDLModelSpec, (6, 32), numeric=3, extra={
            "num_feat_idx": [4, 0, 2], "cat_col_idx": [1, 3],
            "hash_buckets": 32, "hashed_cols": [1],
            "hash_keys": [PH.column_hash_key(11)]})
        rp = _ref_params(R, rs)
        rng = np.random.default_rng(2)
        x = rng.normal(size=(300, 6)).astype(np.float32)
        bins = rng.integers(0, 90, size=(300, 4)).astype(np.int32)
        want = R.wdl.IndependentWDLModel(rs, rp).compute_full(x, bins)
        cols = jax.tree_util.tree_map(np.asarray, rp)
    ps = P.WDLModelSpec.from_json(rs.to_json())
    m = P.IndependentWDLModel(ps, P.from_columns(ps, cols))
    got = m.compute_full(x, bins, device="cpu")
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    got_t = m.compute_full(torch.from_numpy(x), torch.from_numpy(bins))
    np.testing.assert_allclose(got_t, got, rtol=0, atol=1e-6)
