"""The port's device mesh (``shifu_tpu_torch.parallel.mesh``) on the CPU:
worlds of 2 and 3 gloo ranks against one rank and against the reference's
8-device virtual mesh (``tests/test_multichip.py:61-166``,
``tests/test_tree_streaming.py:207-275``), resident and out of core (each
rank keeps its block of every window's rows).

The ranks are this file run as a script, one process a rank, joined
through a ``FileStore`` under the session's temporary directory (no port
to collide under xdist).  Each world runs every scenario once a test
session, in every rank on the same seeded numpy inputs
(``_world_results``: under xdist the first worker that asks, under a file
lock); the tests compare.  On a world larger than one the histograms sum in the kernels'
fixed point (the plain ``*_fixed_ref`` arithmetic on the CPU), so "one
rank" below is one process with the same arithmetic
(the ``fixed_point`` fixture), and the B1/B2/B3 cells, forests,
accumulator boundaries, counts and cells and the forests' scores must
equal it bit for bit; the NN, whose gradients sum in float, agrees within
the reference's tolerance.  The reference's cells differ from exact sums
in their low bits (ROADMAP C4): rtol 1e-5.  WDL (replicated or
row-sharded tables, resident and streamed) agrees with one rank within
the reference's multi-device bound (params 1e-5, errors rtol 1e-4), the
correlation cells within 1e-12 relative and SE within 1e-6; the world of
2 also runs the model-set steps (SE/ST varselect, ``stats
-correlation``, WDL ``train``) on copies of the prepared set.

    python -m pytest tests/test_torch_mesh.py -q --durations=5
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port

WORLDS = (2, 3)
N = 997                         # divides neither world (nor the 8 devices)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ----------------------------------------------------------- shared inputs
def _kernel_inputs():
    rng = np.random.default_rng(19)
    c, b, k, tb = 6, 8, 4, 3
    bins = rng.integers(0, b, (N, c)).astype(np.uint8)
    node = rng.integers(-1, k, N).astype(np.int32)
    w = rng.integers(1, 4, N).astype(np.float32)
    stats = np.stack([w, w * rng.normal(size=N).astype(np.float32)], 1)
    node_b = rng.integers(-1, k, (tb, N)).astype(np.int32)
    stats_b = np.stack([np.stack([w, w * rng.normal(size=N)
                                  .astype(np.float32)], 1)
                        for _ in range(tb)])
    idx = rng.integers(0, 64, (N, 5)).astype(np.int32)
    idx[rng.random((N, 5)) < 0.05] = -1
    pos = (rng.random(N) < 0.3).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, N).astype(np.float32)
    st = np.stack([pos, 1 - pos, pos * wt, (1 - pos) * wt], 1)
    return dict(bins=bins, node=node, stats=stats, node_b=node_b,
                stats_b=stats_b.astype(np.float32), k=k, b=b, idx=idx,
                st=st.astype(np.float32), exact=(True, True, False, False))


def _tree_plane():
    """Well separated gains (a logit on columns 1 and 4): the forests'
    structure is pinned against the reference at MinInfoGain 1e-3 (C9)."""
    rng = np.random.default_rng(5)
    bins = rng.integers(0, 16, (N, 6)).astype(np.uint8)
    logit = 2.0 * (bins[:, 1] > 9) - 1.5 * (bins[:, 4] < 5) - 0.3
    y = (rng.random(N) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    w = rng.integers(1, 4, N).astype(np.float32)
    return bins, y, w


TREE_PARAMS = {
    "GBT": {"TreeNum": 3, "MaxDepth": 3, "LearningRate": 0.1, "Loss": "log",
            "FeatureSubsetStrategy": "ALL", "MinInfoGain": 1e-3,
            "MinInstancesPerNode": 5},
    "RF": {"TreeNum": 4, "MaxDepth": 3, "Impurity": "entropy",
           "FeatureSubsetStrategy": "ALL", "MinInfoGain": 1e-3,
           "MinInstancesPerNode": 5, "TreeBatch": 3}}


def _tree_settings(pkg, alg):
    mc = pkg.config.model_config
    tc = mc.ModelTrainConf()
    tc.validSetRate, tc.baggingSampleRate = 0.2, 0.8
    return pkg.train.dt_trainer.settings_from_params(
        TREE_PARAMS[alg], tc, mc.Algorithm[alg])


def _accumulator_inputs():
    """``tests/test_multichip.py:104``'s data."""
    rng = np.random.default_rng(11)
    c = 5
    x = rng.normal(size=(N, c)).astype(np.float32) * [1, 10, 100, 1, 1]
    valid = rng.random((N, c)) > 0.07
    target = (rng.random(N) < 0.3).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, N).astype(np.float32)
    return x.astype(np.float32), valid, target, weight


#: the streamed scenarios: 997 rows in windows of 240 (a multiple of both
#: worlds' data axes), 5 windows; a prepared window holds 240 rows of u8
#: bins and f32 y/tw/vw (GBT) or y/w (RF); 2 windows resident under the
#: tail budgets, 3 re-streamed a sweep
STREAM_WINDOW = 240
S_GBT = dict(n_trees=4, depth=3, loss="log", learning_rate=0.1, seed=0,
             min_gain=1e-3, min_instances=5)
S_RF = dict(n_trees=5, depth=3, impurity="entropy", loss="squared", seed=2,
            bagging_rate=0.8, tail_tree_batch=3, min_gain=1e-3,
            min_instances=5)
STREAM_RUNS = {             # name: (kind, cache budget, SHIFU_TREE_TAIL_C2F)
    "gbt_c2f": ("gbt", 2 * STREAM_WINDOW * (6 + 12) + 64, "1"),
    "gbt_exact": ("gbt", 2 * STREAM_WINDOW * (6 + 12) + 64, "0"),
    "gbt_resident": ("gbt", 1 << 30, None),
    "rf_tail": ("rf", 2 * STREAM_WINDOW * (6 + 8) + 64, None),
    "rf_resident": ("rf", 1 << 30, None),
}


def _tree_shards(d):
    """``_tree_plane`` as npz shards of 300 rows (each run its own copy:
    the first pass writes the spill beside them)."""
    import json
    bins, y, w = _tree_plane()
    os.makedirs(d)
    for i, s0 in enumerate(range(0, N, 300)):
        np.savez(os.path.join(d, f"part-{i:05d}.npz"),
                 bins=bins[s0:s0 + 300].astype(np.int16), y=y[s0:s0 + 300],
                 w=w[s0:s0 + 300])
    with open(os.path.join(d, "schema.json"), "w") as f:
        json.dump({"columnNums": list(range(6)), "numShards": i + 1,
                   "numRows": N}, f)
    return d


def _with_c2f(c2f, fn):
    old = os.environ.get("SHIFU_TREE_TAIL_C2F")
    if c2f is not None:
        os.environ["SHIFU_TREE_TAIL_C2F"] = c2f
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop("SHIFU_TREE_TAIL_C2F", None)
        else:
            os.environ["SHIFU_TREE_TAIL_C2F"] = old


def _streamed_run(res):
    return {"trees": _forests(res.trees), "history": res.history,
            "fi": res.feature_importance, "init": res.spec_kwargs,
            "passes": (res.disk_passes, res.tail_sweeps, res.bytes_read)}


def _train_streamed(mesh, root: str, name: str, **kw):
    """One streamed forest of ``STREAM_RUNS[name]`` on a fresh copy of the
    plane under ``root``."""
    import shifu_tpu_torch.train.dt_trainer as dt
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.data.streaming import ShardStream
    kind, budget, c2f = STREAM_RUNS[name]
    d = _tree_shards(os.path.join(root, f"{name}{len(os.listdir(root))}"))
    fn = dt.train_gbt_streamed if kind == "gbt" else dt.train_rf_streamed
    settings = dt.DTSettings(**(S_GBT if kind == "gbt" else S_RF))
    return _with_c2f(c2f, lambda: fn(
        ShardStream(Shards.open(d), ("bins", "y", "w"), STREAM_WINDOW), 16,
        None, settings, cache_budget=budget, device="cpu", mesh=mesh, **kw))


class _Checkpoints:
    """A checkpoint_fn keeping every commit: (trees, history, init, f)."""

    def __init__(self):
        self.saved = []

    def __call__(self, trees, history, init_score, scores=None):
        self.saved.append((list(trees), [tuple(h) for h in history],
                           init_score,
                           None if scores is None else scores.copy()))


def _streamed_resume(mesh, root: str) -> dict:
    """The c2f GBT with a checkpoint every 2 trees, then a resume from the
    first checkpoint with its score sidecar (every rank's rows, gathered)
    and without it (the restored trees replayed window by window)."""
    ck = _Checkpoints()
    old = dict(S_GBT)
    S_GBT["checkpoint_every"] = 2
    try:
        full = _train_streamed(mesh, root, "gbt_c2f", checkpoint_fn=ck)
        trees, history, init, scores = ck.saved[0]
        out = {"full": _streamed_run(full), "scores": scores}
        for sidecar in (True, False):
            res = _train_streamed(
                mesh, root, "gbt_c2f", init_trees=trees,
                init_score=init, start_history=history,
                init_scores=scores if sidecar else None)
            out[sidecar] = _streamed_run(res)
    finally:
        S_GBT.clear()
        S_GBT.update(old)
    return out


def scenario_streamed(mesh, root):
    root = os.path.join(root, f"streamed_r{mesh.rank}")
    os.makedirs(root, exist_ok=True)
    out = {name: _streamed_run(_train_streamed(mesh, root, name))
           for name in STREAM_RUNS}
    out["resume"] = _streamed_resume(mesh, root)
    return out


NN_STREAM_BATCHES = (0, 48)     # full batch; slices on multiples of 24


def _nn_stream_plane(d):
    """A norm plane of npz shards: 997 rows x 6 features, weights in
    [0.5, 2)."""
    import json
    rng = np.random.default_rng(13)
    x = rng.normal(size=(N, 6)).astype(np.float32)
    y = (x[:, 0] - 0.7 * x[:, 2] + rng.normal(0, 0.7, N) > 0) \
        .astype(np.float32)
    w = rng.uniform(0.5, 2.0, N).astype(np.float32)
    os.makedirs(d)
    for i, s0 in enumerate(range(0, N, 400)):
        np.savez(os.path.join(d, f"part-{i:05d}.npz"), x=x[s0:s0 + 400],
                 y=y[s0:s0 + 400], w=w[s0:s0 + 400])
    with open(os.path.join(d, "schema.json"), "w") as f:
        json.dump({"outputNames": [f"f{i}" for i in range(6)],
                   "columnNums": list(range(6)), "numShards": i + 1,
                   "numRows": N}, f)
    return d


def _nn_stream_spec(pkg):
    return pkg.NNModelSpec(input_dim=6, hidden_nodes=[8],
                           activations=["tanh"], loss="log")


def _train_nn_streamed(mesh, root: str, bags: int, batch: int):
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.data.streaming import (ShardStream,
                                                mask_fn_from_settings)
    from shifu_tpu_torch.models import nn as nn_model
    from shifu_tpu_torch.train.nn_trainer import (TrainSettings,
                                                  train_ensemble_streamed)
    d = _nn_stream_plane(os.path.join(root, f"nn{len(os.listdir(root))}"))
    res = train_ensemble_streamed(
        ShardStream(Shards.open(d), ("x", "y", "w"), STREAM_WINDOW),
        _nn_stream_spec(nn_model),
        TrainSettings(optimizer="ADAM", learning_rate=0.05, epochs=4,
                      batch_size=batch, seed=0), bags,
        mask_fn_from_settings(bags, valid_rate=0.25, sample_rate=0.9,
                              seed=0), device="cpu", mesh=mesh)
    return {"valid": res.valid_errors,
            "params": [[{k: v.numpy() for k, v in layer.items()}
                        for layer in p] for p in res.params]}


def scenario_nn_streamed(mesh, root):
    from shifu_tpu_torch.parallel.mesh import device_mesh
    root = os.path.join(root, f"nn_streamed_r{mesh.rank}")
    os.makedirs(root, exist_ok=True)
    return {(bags, batch): _train_nn_streamed(device_mesh(n_ensemble=bags),
                                              root, bags, batch)
            for bags in (1, 2) for batch in NN_STREAM_BATCHES}


def _nn_inputs(bags):
    """``tests/test_multichip.py:71``'s data and masks."""
    from shifu_tpu_torch.train.sampling import member_masks
    rng = np.random.default_rng(3)
    n, d = 96, 6
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    tw, vw = member_masks(n, bags, valid_rate=0.25, sample_rate=1.0,
                          replacement=False, targets=y, seed=0)
    return x, y, tw, vw


def _scoring_models():
    """Two forests (one of 8 trees, one of 3) and two nets, from seeds."""
    from shifu_tpu_torch.models import nn as nn_model
    from shifu_tpu_torch.models.tree import (IndependentTreeModel,
                                             TreeModelSpec)
    from shifu_tpu_torch.ops import prng
    from shifu_tpu_torch.ops.tree import TreeArrays
    rng = np.random.default_rng(7)
    models = []
    for t_count in (8, 3):
        trees = []
        for _ in range(t_count):
            sf = rng.integers(-1, 6, 15).astype(np.int32)
            sf[7:] = -1
            trees.append(TreeArrays(split_feat=sf,
                                    left_mask=rng.random((15, 16)) < 0.5,
                                    leaf_value=rng.normal(size=15)
                                    .astype(np.float32), depth=3))
        models.append(IndependentTreeModel(TreeModelSpec(
            algorithm="GBT", n_trees=t_count, depth=3, n_bins=16,
            loss="log", learning_rate=0.1, init_score=-0.2), trees))
    spec = nn_model.NNModelSpec(input_dim=6, hidden_nodes=[8],
                                activations=["tanh"])
    for i in range(2):
        models.append(nn_model.IndependentNNModel(
            spec, nn_model.init_params(prng.prng_key(i), spec)))
    x = rng.normal(size=(N, 6)).astype(np.float32)
    bins = rng.integers(0, 16, (N, 6)).astype(np.uint8)
    return models, x, bins


# ------------------------------------------------- the ranks' scenarios
def _forests(trees):
    return [(t.split_feat, t.left_mask, t.leaf_value) for t in trees]


def scenario_meshes(mesh):
    from shifu_tpu_torch.parallel.mesh import (device_mesh,
                                               shard_rows_from_local)
    r0, r1 = mesh.row_block(N)
    t, row0, n = shard_rows_from_local(mesh, np.arange(r0, r1))
    assert (row0, n) == (r0, N) and t.tolist() == list(range(r0, r1))
    return {k: (m.shape, m.coords) for k in (1, 2, 3)
            for m in [device_mesh(n_ensemble=k)]}


def scenario_kernels(mesh):
    from shifu_tpu_torch.ops import hist, stats_hist
    d = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in _kernel_inputs().items()}
    r0, r1 = mesh.row_block(N)
    before = (hist.build_histograms_batch_sharded.allreduces,
              stats_hist.stats_histograms_sharded.allreduces)
    out = {
        "b1": hist.build_histograms_sharded(
            d["bins"][r0:r1], d["node"][r0:r1], d["stats"][r0:r1], d["k"],
            d["b"], mesh),
        "b2": hist.build_histograms_batch_sharded(
            d["bins"][r0:r1], d["node_b"][:, r0:r1].contiguous(),
            d["stats_b"][:, r0:r1].contiguous(), d["k"], d["b"], mesh),
        "b3": stats_hist.stats_histograms_sharded(
            d["idx"][r0:r1], d["st"][r0:r1], 64, mesh, d["exact"])}
    out = {k: v.numpy() for k, v in out.items()}
    out["allreduces"] = (
        hist.build_histograms_batch_sharded.allreduces - before[0],
        stats_hist.stats_histograms_sharded.allreduces - before[1])
    return out


def _train_forests(mesh):
    import shifu_tpu_torch as port
    import shifu_tpu_torch.config.model_config  # noqa: F401
    import shifu_tpu_torch.train.dt_trainer as dt
    bins, y, w = _tree_plane()
    out = {}
    for alg, fn in (("GBT", dt.train_gbt), ("RF", dt.train_rf)):
        res = fn(bins, y, w, 16, None, _tree_settings(port, alg),
                 device="cpu", mesh=mesh)
        out[alg] = (_forests(res.trees), res.history,
                    res.feature_importance)
    return out


def scenario_forests(mesh):
    return _train_forests(mesh)


def _accumulate(mesh, fused: bool):
    from shifu_tpu_torch.config.model_config import BinningMethod
    from shifu_tpu_torch.ops.binning import NumericAccumulator
    x, valid, target, weight = _accumulator_inputs()
    acc = NumericAccumulator(n_cols=x.shape[1], num_buckets=256, mesh=mesh)
    if fused:
        for s, e in ((0, 400), (400, N)):
            acc.update_fused(x[s:e], valid[s:e], target[s:e], weight[s:e])
        acc.finalize_fused()
    else:
        for s, e in ((0, 400), (400, N)):    # two uneven chunks
            acc.update_moments(x[s:e], valid[s:e])
        acc.finalize_range()
        for s, e in ((0, 400), (400, N)):
            acc.update_histogram(x[s:e], valid[s:e], target[s:e],
                                 weight[s:e])
    cells = acc._hist_dev.numpy().copy()
    bnd, aggs, pct, distinct = acc.finalize_sketch(BinningMethod.EqualTotal,
                                                   8)
    return {"total_rows": acc.total_rows, "missing": acc.missing,
            "mean": acc.moments["mean"], "cells": cells, "bnd": bnd,
            "aggs": aggs, "pct": pct, "distinct": distinct}


def scenario_accumulator(mesh, fused):
    return _accumulate(mesh, fused)


def scenario_scorer(mesh):
    from shifu_tpu_torch.eval.scorer import Scorer
    models, x, bins = _scoring_models()
    return Scorer(models, device="cpu", mesh=mesh).score(x, bins).scores


def _walk(model, bins):
    """The forest's [T, N] per-tree outputs through B4's plain version."""
    from shifu_tpu_torch.ops import tree_quant as tq
    dev = torch.device("cpu")
    return tq.predict_forest_quant(*model.quant_arrays(dev),
                                   torch.from_numpy(bins), 3)


def scenario_walk(mesh):
    """Each rank walks its block (B4), the data group gathers the rows."""
    from shifu_tpu_torch.parallel.mesh import gather_rows, shard_chunk_rows
    models, _, bins = _scoring_models()
    block, _ = shard_chunk_rows(mesh, bins)
    return gather_rows(mesh, _walk(models[0], block).T.contiguous(),
                       N).T.numpy()


def _train_nn(mesh, bags):
    from shifu_tpu_torch.models import nn as nn_model
    from shifu_tpu_torch.train.nn_trainer import (TrainSettings,
                                                  train_ensemble)
    x, y, tw, vw = _nn_inputs(bags)
    spec = nn_model.NNModelSpec(input_dim=6, hidden_nodes=[8],
                                activations=["tanh"], loss="log")
    settings = TrainSettings(optimizer="ADAM", learning_rate=0.05,
                             epochs=5, seed=0)
    res = train_ensemble(x, y, tw, vw, spec, settings, device="cpu",
                         mesh=mesh)
    return {"valid": res.valid_errors,
            "params": [[{k: v.numpy() for k, v in layer.items()}
                        for layer in p] for p in res.params]}


def scenario_nn(mesh, bags):
    from shifu_tpu_torch.parallel.mesh import device_mesh
    return _train_nn(device_mesh(n_ensemble=bags), bags)


# ------------------------------------------------ WDL, the mesh's item 12
WDL_CARDS = [10, 7]          # divisible by neither world: padding always on
#: (bags, MiniBatchs): full batch and batches of 24, a multiple of both
#: worlds' data axes, so every world takes one rank's batches
WDL_RUNS = [(1, 0), (1, 24), (2, 0), (2, 24)]


def _wdl_spec(extra=None):
    from shifu_tpu_torch.models import wdl as P
    return P.WDLModelSpec(numeric_dim=3, cat_cardinalities=list(WDL_CARDS),
                          embed_dim=4, hidden_nodes=[8],
                          activations=["relu"], extra=extra or {})


def _wdl_data(n=64):
    """``tests/test_wdl_shard.py::_data``."""
    rng = np.random.default_rng(0)
    xn = rng.normal(size=(n, 3)).astype(np.float32)
    xc = np.stack([rng.integers(0, WDL_CARDS[0], n),
                   rng.integers(0, WDL_CARDS[1], n)], axis=1) \
        .astype(np.int32)
    y = (rng.random(n) > 0.5).astype(np.float32)
    return xn, xc, y, np.ones(n, np.float32)


def _wdl_settings(**kw):
    from shifu_tpu_torch.train.nn_trainer import TrainSettings
    base = dict(optimizer="ADAM", learning_rate=0.05, l2=1e-4, epochs=3,
                batch_size=0, seed=7)
    base.update(kw)
    return TrainSettings(**base)


def _wdl_result(spec, res):
    """(valid errors, train errors, every member's leaves in the
    reference's per-column tree order)."""
    from shifu_tpu_torch.models import wdl as P
    from shifu_tpu_torch.train.checkpoint import tree_leaves
    return {"valid": res.valid_errors, "train": res.train_errors,
            "params": [[np.asarray(a) for a in tree_leaves(
                P.columns_of(spec, p))] for p in res.params]}


def _train_wdl(mesh_of, bags, bs, shard, **kw):
    """One in-RAM run on ``_wdl_data``: ``_wdl_result`` and each member's
    scores of the rows."""
    from shifu_tpu_torch.models import wdl as P
    from shifu_tpu_torch.train import wdl_trainer as PT
    xn, xc, y, w = _wdl_data()
    s = _wdl_spec()
    res = PT.train_wdl_ensemble(
        xn, xc, y, w, s, _wdl_settings(batch_size=bs, **kw), bags=bags,
        shard=shard, device="cpu", mesh=mesh_of(bags))
    return dict(_wdl_result(s, res), scores=[
        P.forward(p, s, torch.from_numpy(xn), torch.from_numpy(xc))
        .numpy()[:, 0] for p in res.params])


def _wdl_layout(mesh):
    """A 1-bag sharded layout on ``mesh``'s data axis: this rank's table
    and moment shapes, and whether its ranks' shards rebuild the tables
    and the optimizer state bit for bit."""
    from shifu_tpu_torch.models import wdl as P
    from shifu_tpu_torch.ops import prng
    from shifu_tpu_torch.train import wdl_trainer as PT
    from shifu_tpu_torch.train.checkpoint import tree_leaves
    from shifu_tpu_torch.train.optimizers import make_optimizer, tree_map
    s = _wdl_spec()
    p = P.init_params(prng.prng_key(1), s)
    p["wide_cat"] = torch.arange(p["wide_cat"].numel(), dtype=torch.float32)
    stacked = tree_map(lambda t: t[None], p)
    state = make_optimizer("ADAM", 0.05).init(stacked, 1)
    state["v"] = tree_map(lambda t: t + 1.5, state["v"])
    lay = PT._Layout(mesh, s, 1, "f32", True)
    loc, lst = lay.local(stacked), lay.local(state)
    back = tree_leaves((lay.whole(loc), lay.whole(lst)))
    return {"vs": lay.plane.vs, "embed": tuple(loc["embed"].shape),
            "wide_cat": tuple(loc["wide_cat"].shape),
            "moments": [tuple(lst[k][t].shape) for k in ("m", "v")
                        for t in ("embed", "wide_cat")],
            "roundtrip": all(torch.equal(a, b) for a, b in zip(
                back, tree_leaves((stacked, state))))}


def _wdl_resume(mesh_of, root):
    """A 1-bag sharded minibatch run of 4 epochs, and one of 2 resumed to
    4 from its checkpoint (each rank its own checkpoint directory)."""
    ck = os.path.join(root, "ck")
    full = _train_wdl(mesh_of, 1, 24, True, epochs=4)
    _train_wdl(mesh_of, 1, 24, True, epochs=2, checkpoint_dir=ck,
               checkpoint_every=2)
    resumed = _train_wdl(mesh_of, 1, 24, True, epochs=4, checkpoint_dir=ck,
                         checkpoint_every=2, resume=True)
    return full, resumed


def _wdl_table_allocs(mesh_of, epochs):
    """The tensors with a whole table's rows (``sum(WDL_CARDS)``, a size
    nothing else here has) that a 1-bag sharded minibatch run of
    ``epochs`` epochs makes on this rank, every op's outputs counted
    under a dispatch mode: the init's, a result's, a checkpoint's are the
    same whatever the epochs, so a count that grows with them is an epoch
    gathering a whole table."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves as pytree_leaves
    rows = sum(WDL_CARDS)

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            Count.n += sum(1 for t in pytree_leaves(out)
                           if isinstance(t, torch.Tensor)
                           and rows in t.shape)
            return out
    with Count():
        _train_wdl(mesh_of, 1, 24, True, epochs=epochs)
    return Count.n


def scenario_wdl(mesh, root):
    from shifu_tpu_torch.parallel.mesh import device_mesh
    root = os.path.join(root, f"wdl_r{mesh.rank}")
    os.makedirs(root, exist_ok=True)

    def mesh_of(bags):
        return device_mesh(n_ensemble=bags)
    out = {(bags, bs, shard): _train_wdl(mesh_of, bags, bs, shard)
           for bags, bs in WDL_RUNS for shard in (False, True)}
    out["layout"] = _wdl_layout(device_mesh())
    out["resume"] = _wdl_resume(mesh_of, root)
    out["allocs"] = [_wdl_table_allocs(mesh_of, e) for e in (1, 4)]
    return out


class _Win:
    def __init__(self, i, s, arrays, rows):
        self.index, self.start = i, s
        self.rows = self.n_valid = rows
        self.arrays = arrays


class _WdlPlanes:
    """``tests/test_wdl_shard.py::_FakePlanes``: zipped windows of 16
    rows (a block of 8 / 6 rows a rank on 2 / 3 ranks, padded)."""

    window_rows = 16

    def __init__(self):
        self.x, self.bins, self.y, self.w = _wdl_data()
        self.num_rows = len(self.y)

    def prepared(self, prepare):
        wr = self.window_rows
        for i, s in enumerate(range(0, self.num_rows, wr)):
            yield prepare(_Win(i, s, {
                "x": self.x[s:s + wr], "y": self.y[s:s + wr],
                "w": self.w[s:s + wr], "bins": self.bins[s:s + wr]}, wr))


def _wdl_mask_fn():
    masks = (np.random.default_rng(5).random((2, 64)) > 0.3) \
        .astype(np.float32)

    def mask_fn(idx, yw):
        tm = masks[:, idx * 16:(idx + 1) * 16]
        return tm, 1.0 - tm
    return mask_fn


def _train_wdl_streamed(mesh, bags, shard):
    from shifu_tpu_torch.train import wdl_trainer as PT
    s = _wdl_spec({"num_feat_idx": [0, 1, 2], "cat_col_idx": [0, 1]})
    return _wdl_result(s, PT.train_wdl_streamed(
        _WdlPlanes(), s, _wdl_settings(), 2, _wdl_mask_fn(), [0, 1, 2],
        [0, 1], shard=shard, device="cpu", mesh=mesh))


def scenario_wdl_streamed(mesh):
    from shifu_tpu_torch.parallel.mesh import device_mesh
    return {(bags, shard): _train_wdl_streamed(device_mesh(n_ensemble=bags),
                                               bags, shard)
            for bags in (1, 2) for shard in (False, True)}


def _corr_inputs():
    rng = np.random.default_rng(23)
    x = rng.normal(size=(N, 5)) * [1, 10, 100, 1, 1]
    x[:, 3] = 0.6 * x[:, 0] + 0.4 * rng.normal(size=N)
    valid = rng.random((N, 5)) > 0.08
    return x.astype(np.float32), valid


def _correlate(mesh):
    """Pairwise-complete Pearson over two uneven chunks, each rank its
    block of every chunk."""
    from shifu_tpu_torch.ops.correlation import CorrelationAccumulator
    x, valid = _corr_inputs()
    acc = CorrelationAccumulator(n_cols=5, offset=np.nanmean(
        np.where(valid, x, np.nan), axis=0), mesh=mesh)
    for s, e in ((0, 400), (400, N)):
        acc.update(np.where(valid[s:e], x[s:e], 0.0), valid[s:e])
    return acc.finalize()


def scenario_correlation(mesh):
    return _correlate(mesh)


def _sens_net():
    from shifu_tpu_torch.models import nn as nn_model
    from shifu_tpu_torch.ops import prng
    spec = _nn_stream_spec(nn_model)
    return spec, nn_model.init_params(prng.prng_key(4), spec)


def _sensitivity(mesh, root):
    """SE over the NN stream plane (windows of 240: a multiple of both
    worlds' data axes), one candidate a feature and one pair."""
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.data.streaming import ShardStream
    from shifu_tpu_torch.ops import sensitivity as sens
    d = _nn_stream_plane(os.path.join(root, f"sens{len(os.listdir(root))}"))
    spec, params = _sens_net()
    masks = sens.mask_matrix(6, [[i] for i in range(6)] + [[1, 4]])
    mse, base, rows = sens.streamed_sensitivity(
        ShardStream(Shards.open(d), ("x", "y"), STREAM_WINDOW), spec,
        [{k: v.numpy() for k, v in layer.items()} for layer in params],
        masks, mask_batch=3, device="cpu", mesh=mesh)
    return {"mse": mse, "base": base, "rows": rows}


def scenario_sensitivity(mesh, root):
    root = os.path.join(root, f"sens_r{mesh.rank}")
    os.makedirs(root, exist_ok=True)
    return _sensitivity(mesh, root)


#: the model-set steps a world of 2 runs on its copies of the prepared
#: set, against one rank's run (``scenario_pipeline``)
PIPELINE_STEPS = ("se", "st", "correlation", "wdl_replicated",
                  "wdl_sharded")
PIPELINE_WDL = {"MiniBatchs": 256, "NumHiddenNodes": [8],
                "EmbedColumnNum": 3}


def _prepare_pipeline_set(d: str) -> None:
    """An NN ``model0`` over the set's norm plane (seeded), for SE/ST."""
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.models import nn as nn_model
    from shifu_tpu_torch.ops import prng
    names = Shards.open(os.path.join(d, "tmp", "NormalizedData")) \
        .schema["outputNames"]
    spec = nn_model.NNModelSpec(input_dim=len(names), hidden_nodes=[8],
                                activations=["tanh"])
    os.makedirs(os.path.join(d, "models"), exist_ok=True)
    nn_model.save_model(os.path.join(d, "models", "model0.nn"), spec,
                        nn_model.init_params(prng.prng_key(5), spec))


def _run_pipeline(d: str) -> dict:
    """SE and ST varselect, ``stats -correlation`` and WDL ``train`` (2
    bags with replicated tables; 1 bag with ``auto`` sharding past a
    lowered ``shardMinBytes``) on set ``d``: each step's output files."""
    import json
    from shifu_tpu_torch.config import ModelConfig, environment
    from shifu_tpu_torch.config.model_config import Algorithm, FilterBy
    from shifu_tpu_torch.pipeline.stats import StatsProcessor
    from shifu_tpu_torch.pipeline.train import TrainProcessor
    from shifu_tpu_torch.pipeline.varselect import VarSelectProcessor
    path = os.path.join(d, "ModelConfig.json")
    out = {}
    environment.reset_for_tests()
    try:
        for fb in ("se", "st"):
            mc = ModelConfig.load(path)
            mc.train.algorithm = Algorithm.NN
            mc.varSelect.filterBy = FilterBy[fb.upper()]
            mc.varSelect.filterNum = 3
            mc.save(path)
            assert VarSelectProcessor(d, params={}, device="cpu").run() == 0
            with open(os.path.join(d, "varsels", "se.json")) as f:
                scores = json.load(f)
            with open(os.path.join(d, "ColumnConfig.json")) as f:
                selected = [c["columnNum"] for c in json.load(f)
                            if c.get("finalSelect")]
            out[fb] = (scores, selected)
        assert StatsProcessor(d, params={"correlation": True},
                              device="cpu").run() == 0
        with open(os.path.join(d, "correlation.csv")) as f:
            rows = [line.strip().split(",") for line in f]
        out["correlation"] = (rows[0], np.array(
            [[float(v) for v in r[1:]] for r in rows[1:]]))
        for step, bags, props in (
                ("wdl_replicated", 2, {}),
                ("wdl_sharded", 1, {"shifu.wdl.shardMinBytes": "1"})):
            for k, v in props.items():
                environment.set_property(k, v)
            mc = ModelConfig.load(path)
            mc.train.algorithm = Algorithm.WDL
            mc.train.baggingNum = bags
            mc.train.numTrainEpochs = 2
            mc.train.params = dict(PIPELINE_WDL)
            mc.save(path)
            assert TrainProcessor(d, params={}, device="cpu").run() == 0
            models = {}
            for f in sorted(os.listdir(os.path.join(d, "models"))):
                if f.endswith(".wdl"):
                    with np.load(os.path.join(d, "models", f)) as z:
                        models[f] = {k: z[k] for k in z.files}
            out[step] = models
            environment.reset_for_tests()
    finally:
        environment.reset_for_tests()
    return out


def scenario_pipeline(mesh, dirs):
    return _run_pipeline(dirs[mesh.rank])


#: each path a mesh leaves out: (what to run, the ROADMAP words it names)
NOT_PORTED = {
    "bagged_trees": ("GBT", {"baggingNum": 2}, {}, "tree trainers"),
    "multiclass_trees": ("RF", {"posTags": ["bad", "good", "other"]}, {},
                         "multi-class tree trainers"),
    "genetic": (None, {}, {}, "GENETIC varselect"),
}


def scenario_not_ported(mesh, dirs):
    """Run each left-out path on this rank's copy of a prepared set; the
    message each raises, or None."""
    from shifu_tpu_torch.config import ModelConfig, environment
    from shifu_tpu_torch.config.model_config import Algorithm, FilterBy
    from shifu_tpu_torch.pipeline.train import TrainProcessor
    from shifu_tpu_torch.pipeline.varselect import VarSelectProcessor
    d = dirs[mesh.rank]
    path = os.path.join(d, "ModelConfig.json")
    out = {}
    for case, (alg, train, props, _) in NOT_PORTED.items():
        environment.reset_for_tests()
        for k, v in props.items():
            environment.set_property(k, v)
        if alg:
            mc = ModelConfig.load(path)
            tags = (list(mc.dataSet.posTags), list(mc.dataSet.negTags))
            mc.train.algorithm = Algorithm[alg]
            mc.train.baggingNum = train.get("baggingNum", 1)
            if "posTags" in train:          # a K = 3 target
                mc.dataSet.posTags, mc.dataSet.negTags = train["posTags"], []
            mc.save(path)
            if "posTags" in train:
                mc.dataSet.posTags, mc.dataSet.negTags = tags
            proc = TrainProcessor(d, params={}, device="cpu")
        else:                               # GENETIC varselect
            mc = ModelConfig.load(path)
            by = mc.varSelect.filterBy
            mc.varSelect.filterBy = FilterBy.GENETIC
            mc.save(path)
            mc.varSelect.filterBy = by
            proc = VarSelectProcessor(d, params={}, device="cpu")
        try:
            proc.run()
            out[case] = None
        except NotImplementedError as e:
            out[case] = str(e)
        mc.save(path)                       # the set as it was
    environment.reset_for_tests()
    return out


SCENARIOS = {name[len("scenario_"):]: fn for name, fn in list(globals()
             .items()) if name.startswith("scenario_")}


def _serve(rank: int, world: int, store: str) -> None:
    """A rank: join the world, then run each framed (scenario, kwargs)
    from stdin and write its framed (ok, result) to stdout."""
    from datetime import timedelta

    import torch.distributed as dist
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)                       # prints go to the log, not the pipe
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    from shifu_tpu_torch.parallel.mesh import device_mesh
    inp = sys.stdin.buffer
    while True:
        head = inp.read(8)
        if len(head) < 8:
            break
        name, kwargs = pickle.loads(inp.read(struct.unpack("<Q", head)[0]))
        try:
            res = (True, SCENARIOS[name](device_mesh(), **kwargs))
        except Exception:                  # the test reports it
            res = (False, traceback.format_exc())
        blob = pickle.dumps(res)
        out.write(struct.pack("<Q", len(blob)) + blob)
        out.flush()
    os._exit(0)          # no teardown barrier: every rank is done here


# --------------------------------------------------------- the test side
class _World:
    """``size`` rank processes of this file, started together."""

    def __init__(self, size: int, root: str):
        self.size = size
        self.logs = [open(os.path.join(root, f"rank{r}.log"), "w")
                     for r in range(size)]
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        store = os.path.join(root, "store")
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(size),
             store], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self.logs[r], env=env, cwd=root) for r in range(size)]

    def run(self, name: str, **kwargs):
        """Every rank's result of one scenario."""
        blob = pickle.dumps((name, kwargs))
        for p in self.procs:
            p.stdin.write(struct.pack("<Q", len(blob)) + blob)
            p.stdin.flush()
        out = []
        for r, p in enumerate(self.procs):
            head = p.stdout.read(8)
            if len(head) < 8:
                raise RuntimeError(f"rank {r} of {self.size} died; see "
                                   f"{self.logs[r].name}")
            ok, res = pickle.loads(p.stdout.read(
                struct.unpack("<Q", head)[0]))
            if not ok:
                raise RuntimeError(f"rank {r} of {self.size}: {res}")
            out.append(res)
        return out

    def close(self) -> None:
        for p in self.procs:
            p.stdin.close()
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for f in self.logs:
            f.close()


#: every scenario a world runs, once: (name, keyword arguments)
RUNS = [("meshes", {}), ("kernels", {}), ("forests", {}), ("walk", {}),
        ("scorer", {}), ("accumulator", {"fused": False}),
        ("accumulator", {"fused": True}), ("nn", {"bags": 1}),
        ("nn", {"bags": 2}), ("streamed", {"root": None}),
        ("nn_streamed", {"root": None}), ("wdl", {"root": None}),
        ("wdl_streamed", {}), ("correlation", {}),
        ("sensitivity", {"root": None})]


def _world_results(root: str, world: int, template: str) -> dict:
    """Every scenario's per-rank results in a world of ``world`` ranks,
    computed once a test session: the first xdist worker to ask starts the
    ranks under a file lock and leaves the results beside it for the
    others (so a session starts 2 + 3 rank processes, not that many a
    worker).  The world of 2 also runs the model-set steps
    (``scenario_pipeline``) and every left-out path on its own copies of
    the prepared set."""
    import fcntl
    import shutil
    done = os.path.join(root, f"mesh_world{world}.pkl")
    with open(os.path.join(root, f"mesh_world{world}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(done):
            with open(done, "rb") as f:
                return pickle.load(f)
        run_dir = os.path.join(root, f"mesh_world{world}")
        os.makedirs(run_dir)
        w = _World(world, run_dir)
        try:
            out = {name if not kw or "root" in kw else
                   (name, *kw.values()):
                   w.run(name, **({"root": run_dir} if "root" in kw
                                  else kw)) for name, kw in RUNS}
            if world == 2:
                dirs = tuple(os.path.join(run_dir, f"set{r}")
                             for r in range(world))
                for d in dirs:
                    shutil.copytree(template, d)
                out["not_ported"] = w.run("not_ported", dirs=dirs)
                pipes = tuple(os.path.join(run_dir, f"pipe{r}")
                              for r in range(world))
                for d in pipes:
                    shutil.copytree(template, d)
                    _prepare_pipeline_set(d)
                out["pipeline"] = w.run("pipeline", dirs=pipes)
        finally:
            w.close()
        with open(done + ".part", "wb") as f:
            pickle.dump(out, f)
        os.replace(done + ".part", done)
        return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, request):
    """``worlds(w)``: every scenario's per-rank results on a world of w
    ranks (:func:`_world_results`)."""
    import threading
    base = tmp_path_factory.getbasetemp()
    root = str(base.parent if os.environ.get("PYTEST_XDIST_WORKER")
               else base)
    template = request.getfixturevalue("_prepared_template")
    out, threads = {}, {}

    def compute(world: int) -> None:
        try:
            out[world] = _world_results(root, world, template)
        except Exception as e:          # re-raised by the test that asks
            out[world] = e

    def get(world: int) -> dict:
        if not threads:                 # both worlds at once
            for w in WORLDS:
                threads[w] = threading.Thread(target=compute, args=(w,))
                threads[w].start()
        threads[world].join(timeout=300)
        if isinstance(out.get(world), Exception):
            raise out[world]
        return out[world]
    yield get
    for t in threads.values():
        t.join(timeout=300)


@pytest.fixture
def fixed_point(monkeypatch):
    """One process with the arithmetic a world larger than one uses on the
    CPU: the fixed-point plain versions of B1/B2/B3 in place of the
    float64 ones, and the leaf sums through the histogram."""
    from shifu_tpu_torch.ops import hist, stats_hist, tree
    monkeypatch.setattr(hist, "build_histograms_ref",
                        hist.build_histograms_fixed_ref)
    monkeypatch.setattr(stats_hist, "stats_histograms_ref",
                        lambda i, s, nb: stats_hist.stats_histograms_fixed_ref(
                            i, s, nb))
    monkeypatch.setattr(tree, "_level_leaf_raw",
                        lambda s, ni, k, mesh=None: tree._leaf_raw_hist(
                            s, ni, k))


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


def _ref_mesh(n_ensemble: int = 1):
    import jax
    from shifu_tpu.parallel.mesh import device_mesh
    return device_mesh(n_ensemble=n_ensemble, devices=jax.devices("cpu")[:8])


# ------------------------------------------------------------- the tests
@pytest.mark.parametrize("world", WORLDS)
def test_device_mesh_follows_the_gcd_rule(worlds, world):
    import jax
    from shifu_tpu.parallel.mesh import device_mesh
    for rank, got in enumerate(worlds(world)["meshes"][0:world]):
        for k, (shape, coords) in got.items():
            ref = device_mesh(n_ensemble=k,
                              devices=jax.devices("cpu")[:world])
            assert shape == dict(ref.shape)
            assert coords == divmod(rank, shape["data"])


@pytest.mark.parametrize("kernel", ["b1", "b2", "b3"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_kernels_equal_one_rank(worlds, world, kernel):
    from shifu_tpu_torch.ops import hist, stats_hist
    d = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in _kernel_inputs().items()}
    want = {
        "b1": lambda: hist.build_histograms_fixed_ref(
            d["bins"], d["node"], d["stats"], d["k"], d["b"]),
        "b2": lambda: torch.stack([hist.build_histograms_fixed_ref(
            d["bins"], d["node_b"][t], d["stats_b"][t], d["k"], d["b"])
            for t in range(d["node_b"].shape[0])]),
        "b3": lambda: stats_hist.stats_histograms_fixed_ref(
            d["idx"], d["st"], 64, d["exact"])}[kernel]().numpy()
    for got in worlds(world)["kernels"]:
        assert _same(got[kernel], want)
        assert got["allreduces"] == (2, 1)      # one a sharded build


@pytest.mark.parametrize("kernel", ["b1", "b2", "b3"])
def test_sharded_kernels_match_the_reference_mesh(worlds, kernel):
    """Within C4's rtol of the reference's ``*_sharded`` lowerings on its
    8-device mesh (Pallas in interpret mode), count channels exact."""
    import jax.numpy as jnp
    from shifu_tpu.ops import hist_pallas as hp
    d = _kernel_inputs()
    mesh = _ref_mesh()
    pad = 1000 - N

    def rows(a, fill=0, axis=0):
        width = [(0, 0)] * a.ndim
        width[axis] = (0, pad)
        return jnp.asarray(np.pad(a, width, constant_values=fill))
    if kernel == "b1":
        ref = hp.build_histograms_sharded(
            rows(d["bins"]).astype(jnp.int32), rows(d["node"], -1),
            rows(d["stats"]), d["k"], d["b"], mesh, interpret=True)
    elif kernel == "b2":
        ref = hp.build_histograms_batch_sharded(
            rows(d["bins"]).astype(jnp.int32), rows(d["node_b"], -1, 1),
            rows(d["stats_b"], 0, 1), d["k"], d["b"], mesh, interpret=True)
    else:
        ref = hp.stats_histograms_sharded(
            rows(d["idx"], -1), rows(d["st"]), 64, mesh, interpret=True,
            exact=d["exact"])
    ref = np.asarray(ref, np.float64)
    for world in WORLDS:
        got = worlds(world)["kernels"][0][kernel].astype(np.float64)
        np.testing.assert_array_equal(got[..., 0], ref[..., 0])  # counts
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("alg", ["GBT", "RF"])
@pytest.mark.parametrize("world", WORLDS)
def test_forests_equal_one_rank(worlds, fixed_point, world, alg):
    want_trees, want_hist, want_fi = _train_forests(None)[alg]
    for trees, history, fi in (r[alg] for r in
                               worlds(world)["forests"]):
        assert len(trees) == len(want_trees)
        for got, want in zip(trees, want_trees):
            assert all(_same(g, w) for g, w in zip(got, want))
        assert _same(fi, want_fi)
        # the errors are every rank's float64 sums: f32 within rounding
        np.testing.assert_allclose(history, want_hist, rtol=1e-5)


@pytest.mark.parametrize("alg", ["GBT", "RF"])
def test_forests_match_the_reference_mesh(worlds, alg):
    """The structure of the reference's forest trained on its 8-device mesh
    at MinInfoGain 1e-3 (C9), the leaves within 1e-4."""
    import shifu_tpu as ref_pkg
    import shifu_tpu.config.model_config  # noqa: F401
    import shifu_tpu.train.dt_trainer as rdt
    bins, y, w = _tree_plane()
    fn = rdt.train_gbt if alg == "GBT" else rdt.train_rf
    ref = fn(bins.astype(np.int32), y, w, 16, None,
             _tree_settings(ref_pkg, alg), mesh=_ref_mesh())
    for world in WORLDS:
        trees = worlds(world)["forests"][0][alg][0]
        assert len(trees) == len(ref.trees)
        for (sf, lm, lv), t in zip(trees, ref.trees):
            np.testing.assert_array_equal(sf, np.asarray(t.split_feat))
            live = sf >= 0
            np.testing.assert_array_equal(lm[live],
                                          np.asarray(t.left_mask)[live])
            np.testing.assert_allclose(lv, np.asarray(t.leaf_value),
                                       rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("world", WORLDS)
def test_accumulator_equals_one_rank(worlds, fixed_point, world, fused):
    want = _accumulate(None, fused)
    for got in worlds(world)[("accumulator", fused)]:
        assert got["total_rows"] == want["total_rows"] == N
        assert _same(got["missing"], want["missing"])
        assert _same(got["cells"], want["cells"])
        for gb, wb, ga, wa in zip(got["bnd"], want["bnd"], got["aggs"],
                                  want["aggs"]):
            assert _same(gb, wb)                     # boundaries
            assert _same(ga[:-1], wa[:-1])            # the bins' cells
            np.testing.assert_array_equal(ga[-1, :2], wa[-1, :2])
            np.testing.assert_allclose(ga[-1], wa[-1], rtol=1e-6)
        assert _same(got["pct"], want["pct"])
        assert _same(got["distinct"], want["distinct"])
        np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-5)


def test_accumulator_matches_the_reference_mesh(worlds):
    """``tests/test_multichip.py:104`` against the port's worlds."""
    from shifu_tpu.config.model_config import BinningMethod
    from shifu_tpu.ops.binning import NumericAccumulator
    x, valid, target, weight = _accumulator_inputs()
    acc = NumericAccumulator(n_cols=x.shape[1], num_buckets=256,
                             mesh=_ref_mesh())
    for s, e in ((0, 400), (400, N)):
        acc.update_moments(x[s:e], valid[s:e])
    acc.finalize_range()
    for s, e in ((0, 400), (400, N)):
        acc.update_histogram(x[s:e], valid[s:e], target[s:e], weight[s:e])
    b8, a8, p8, d8 = acc.finalize_sketch(BinningMethod.EqualTotal, 8)
    for world in WORLDS:
        got = worlds(world)[("accumulator", False)][0]
        np.testing.assert_array_equal(got["missing"], acc.missing)
        np.testing.assert_allclose(got["mean"], acc.moments["mean"],
                                   rtol=1e-5)
        for i in range(x.shape[1]):
            np.testing.assert_array_equal(got["bnd"][i], b8[i])
            np.testing.assert_array_equal(got["aggs"][i][:, :2],
                                          a8[i][:, :2])
            np.testing.assert_allclose(got["aggs"][i][:, 2:], a8[i][:, 2:],
                                       rtol=1e-5)
        np.testing.assert_array_equal(got["distinct"], d8)
        np.testing.assert_allclose(got["pct"], p8, rtol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_forest_walk_equals_one_rank(worlds, world):
    """B4 over each rank's block, gathered: the one-rank walk bit for
    bit."""
    models, _, bins = _scoring_models()
    want = _walk(models[0], bins).numpy()
    for got in worlds(world)["walk"]:
        assert _same(got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_scorer_equals_one_rank(worlds, world):
    """Every model's scores, gathered in row order.  The forests' walks are
    bit-equal (above); their link's vectorised ``exp`` on the CPU may round
    a row by an ulp by its place in the block (rtol 1e-6; on the card
    ``chip_smoke.py`` holds them bit for bit), and the nets' GEMMs of
    another height may sum in another order (1e-5)."""
    from shifu_tpu_torch.eval.scorer import Scorer
    models, x, bins = _scoring_models()
    want = Scorer(models, device="cpu").score(x, bins).scores
    for got in worlds(world)["scorer"]:
        assert got.shape == want.shape
        np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=1e-6)
        np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=1e-5,
                                   atol=1e-5)


def test_scorer_matches_the_reference_mesh(worlds):
    """``tests/test_multichip.py:145``: the nets scored on the reference's
    8-device mesh, the same weights."""
    import jax.numpy as jnp
    from shifu_tpu.eval.scorer import Scorer
    from shifu_tpu.models import nn as jnn
    models, x, _ = _scoring_models()
    ref_models = []
    for m in models[2:]:
        spec = jnn.NNModelSpec(input_dim=6, hidden_nodes=[8],
                               activations=["tanh"])
        ref_models.append(jnn.IndependentNNModel(spec, [
            {k: jnp.asarray(v.numpy()) for k, v in layer.items()}
            for layer in m.params]))
    ref = Scorer(ref_models, mesh=_ref_mesh()).score(x).scores
    for world in WORLDS:
        got = worlds(world)["scorer"][0]
        np.testing.assert_allclose(got[:, 2:], ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("bags", [1, 2])
@pytest.mark.parametrize("world", WORLDS)
def test_nn_matches_one_rank(worlds, world, bags):
    """``tests/test_multichip.py:71``: the mesh changes where rows and
    members live, not the math (valid errors rtol 1e-4, params 1e-3)."""
    want = _train_nn(None, bags)
    for got in worlds(world)[("nn", bags)]:
        np.testing.assert_allclose(got["valid"], want["valid"], rtol=1e-4,
                                   atol=1e-6)
        for pg, pw in zip(got["params"], want["params"]):
            for lg, lw in zip(pg, pw):
                for k in ("w", "b"):
                    np.testing.assert_allclose(lg[k], lw[k], rtol=1e-3,
                                               atol=1e-5)


@pytest.mark.parametrize("bags", [1, 2])
def test_nn_matches_the_reference_mesh(worlds, bags):
    """The reference's 8-device mesh from the port's initial weights, with
    64-bit types off as the reference deploys (C3)."""
    import jax
    import jax.numpy as jnp
    from shifu_tpu.models import nn as jnn
    from shifu_tpu.train.nn_trainer import TrainSettings, train_ensemble
    from shifu_tpu_torch.models import nn as nn_model
    from shifu_tpu_torch.ops import prng
    x, y, tw, vw = _nn_inputs(bags)
    spec = nn_model.NNModelSpec(input_dim=6, hidden_nodes=[8],
                                activations=["tanh"], loss="log")
    init = [nn_model.init_params(k, spec)
            for k in prng.split(prng.prng_key(0), bags)]
    with jax.enable_x64(False):
        ref = train_ensemble(
            x, y, tw, vw, jnn.NNModelSpec(input_dim=6, hidden_nodes=[8],
                                          activations=["tanh"], loss="log"),
            TrainSettings(optimizer="ADAM", learning_rate=0.05, epochs=5,
                          seed=0),
            init_params_list=[[{k: jnp.asarray(v.numpy())
                                for k, v in layer.items()} for layer in p]
                              for p in init],
            mesh=_ref_mesh(n_ensemble=bags))
    for world in WORLDS:
        got = worlds(world)[("nn", bags)][0]
        np.testing.assert_allclose(got["valid"], ref.valid_errors,
                                   rtol=1e-4, atol=1e-6)
        for pg, pr in zip(got["params"], ref.params):
            for lg, lr in zip(pg, pr):
                for k in ("w", "b"):
                    np.testing.assert_allclose(lg[k], np.asarray(lr[k]),
                                               rtol=1e-3, atol=1e-5)


# ------------------------------------------------------ out of core
_ONE_RANK: dict = {}


def _one_rank(key, fn):
    """One rank's result of a streamed scenario, computed once a worker
    (under the ``fixed_point`` fixture of the asking test)."""
    if key not in _ONE_RANK:
        _ONE_RANK[key] = fn()
    return _ONE_RANK[key]


def _same_run(got, want):
    assert got["passes"] == want["passes"]       # disk passes, sweeps, bytes
    assert len(got["trees"]) == len(want["trees"])
    for g, w in zip(got["trees"], want["trees"]):
        assert all(_same(a, b) for a, b in zip(g, w))
    assert _same(got["fi"], want["fi"])
    assert got["init"] == want["init"]
    # the errors are every rank's float64 sums: f32 within rounding
    np.testing.assert_allclose(got["history"], want["history"], rtol=1e-5)


@pytest.mark.parametrize("name", sorted(STREAM_RUNS))
@pytest.mark.parametrize("world", WORLDS)
def test_streamed_forests_equal_one_rank(worlds, fixed_point, tmp_path,
                                         world, name):
    """Each window's rows split over the ranks: the one-rank streamed
    forest bit for bit (c2f and exact with 3 of 5 windows on the disk
    tail, RF's super-batch over the tail, and fully resident), with its
    disk passes, tail sweeps and bytes read."""
    want = _one_rank(name, lambda: _streamed_run(
        _train_streamed(None, str(tmp_path), name)))
    for got in worlds(world)["streamed"]:
        _same_run(got[name], want)


def test_streamed_resume_on_a_world_is_bit_identical(worlds, fixed_point,
                                                     tmp_path):
    """A c2f GBT on a world of 2 checkpointed at tree 2 (its per-row score
    sidecar gathered from both ranks: one rank's bits) and resumed with
    and without the sidecar: the uninterrupted forest bit for bit."""
    want = _one_rank("resume", lambda: _streamed_resume(None,
                                                        str(tmp_path)))
    for got in worlds(2)["streamed"]:
        r = got["resume"]
        assert _same(r["scores"], want["scores"])
        _same_run(r["full"], want["full"])
        for sidecar in (True, False):
            rs = r[sidecar]
            assert len(rs["trees"]) == len(r["full"]["trees"])
            for g, w in zip(rs["trees"], r["full"]["trees"]):
                assert all(_same(a, b) for a, b in zip(g, w))
            assert rs["history"] == r["full"]["history"]


@pytest.mark.parametrize("name", ["gbt_c2f", "rf_tail"])
def test_streamed_forests_match_the_reference_mesh(worlds, tmp_path, name):
    """The reference's streamed forest on its 8-device mesh (fully
    resident: the structure does not depend on the tail,
    ``tests/test_tree_streaming.py:207-275``): split features equal,
    leaves and the validation error within 1e-4.  The reference's fully
    resident RF reports the trees it grows one at a time with train and
    validation swapped (C11): its train error is the validation's."""
    import shifu_tpu.train.dt_trainer as rdt
    from shifu_tpu.data.shards import Shards
    from shifu_tpu.data.streaming import ShardStream
    kind = STREAM_RUNS[name][0]
    d = _tree_shards(str(tmp_path / "ref"))
    fn = rdt.train_gbt_streamed if kind == "gbt" else rdt.train_rf_streamed
    ref = fn(ShardStream(Shards.open(d), ("bins", "y", "w"), STREAM_WINDOW),
             16, None, rdt.DTSettings(**(S_GBT if kind == "gbt" else S_RF)),
             mesh=_ref_mesh())
    ref_valid = ref.valid_error if kind == "gbt" else ref.train_error
    for world in WORLDS:
        got = worlds(world)["streamed"][0][name]
        assert len(got["trees"]) == len(ref.trees)
        for (sf, lm, lv), t in zip(got["trees"], ref.trees):
            np.testing.assert_array_equal(sf, np.asarray(t.split_feat))
            np.testing.assert_allclose(lv, np.asarray(t.leaf_value),
                                       rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["history"][-1][1], ref_valid,
                                   rtol=1e-4)


def _close_nn(got, want):
    np.testing.assert_allclose(got["valid"], want["valid"], rtol=1e-4,
                               atol=1e-6)
    for pg, pw in zip(got["params"], want["params"]):
        for lg, lw in zip(pg, pw):
            for k in ("w", "b"):
                np.testing.assert_allclose(lg[k], np.asarray(lw[k]),
                                           rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("batch", NN_STREAM_BATCHES)
@pytest.mark.parametrize("bags", [1, 2])
@pytest.mark.parametrize("world", WORLDS)
def test_streamed_nn_matches_one_rank(worlds, tmp_path, world, bags,
                                      batch):
    """The streamed NN with each window's rows (full batch) or each
    slice's rows (minibatch) split over the data axis and the bags over
    the ensemble axis: one rank's within the reference's tolerance."""
    want = _one_rank(("nn", bags, batch), lambda: _train_nn_streamed(
        None, str(tmp_path), bags, batch))
    for got in worlds(world)["nn_streamed"]:
        _close_nn(got[(bags, batch)], want)


@pytest.mark.parametrize("batch", NN_STREAM_BATCHES)
@pytest.mark.parametrize("bags", [1, 2])
def test_streamed_nn_matches_the_reference_mesh(worlds, tmp_path, bags,
                                                batch):
    """The reference's streamed NN from the port's initial weights with
    64-bit types off (C3): full batch on its 8-device mesh; minibatch on
    one device (its minibatch program aborts XLA:CPU now and then on the
    8-device mesh; the slices are the same, 48 rows on multiples of 24)."""
    import jax
    import jax.numpy as jnp
    from shifu_tpu.data.shards import Shards
    from shifu_tpu.data.streaming import (ShardStream,
                                          mask_fn_from_settings)
    from shifu_tpu.models import nn as jnn
    from shifu_tpu.parallel.mesh import device_mesh
    from shifu_tpu.train.nn_trainer import (TrainSettings,
                                            train_ensemble_streamed)
    from shifu_tpu_torch.models import nn as nn_model
    from shifu_tpu_torch.ops import prng
    d = _nn_stream_plane(str(tmp_path / "ref"))
    init = [nn_model.init_params(k, _nn_stream_spec(nn_model))
            for k in prng.split(prng.prng_key(0), bags)]
    mesh = _ref_mesh(n_ensemble=bags) if batch == 0 else \
        device_mesh(1, devices=jax.devices("cpu")[:1])
    with jax.enable_x64(False):
        ref = train_ensemble_streamed(
            ShardStream(Shards.open(d), ("x", "y", "w"), STREAM_WINDOW),
            _nn_stream_spec(jnn),
            TrainSettings(optimizer="ADAM", learning_rate=0.05, epochs=4,
                          batch_size=batch, seed=0), bags,
            mask_fn_from_settings(bags, valid_rate=0.25, sample_rate=0.9,
                                  seed=0),
            init_params_list=[[{k: jnp.asarray(v.numpy())
                                for k, v in layer.items()} for layer in p]
                              for p in init], mesh=mesh)
    want = {"valid": ref.valid_errors, "params": ref.params}
    for world in WORLDS:
        _close_nn(worlds(world)["nn_streamed"][0][(bags, batch)], want)


# ------------------------------------------------------------------ WDL
def _close_wdl(got, want, atol=1e-5):
    """The reference's multi-device bound (``tests/test_wdl_shard.py``):
    params within atol 1e-5, validation errors rtol 1e-4."""
    np.testing.assert_allclose(got["valid"], want["valid"], rtol=1e-4)
    assert len(got["params"]) == len(want["params"])
    for pg, pw in zip(got["params"], want["params"]):
        assert len(pg) == len(pw)
        for a, b in zip(pg, pw):
            assert a.shape == np.asarray(b).shape
            np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=0,
                                       atol=atol)


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("bags,bs", WDL_RUNS)
@pytest.mark.parametrize("world", WORLDS)
def test_wdl_matches_one_rank(worlds, world, bags, bs, shard):
    """WDL on a world, members on the ensemble axis and each batch's rows
    on the data axis, tables replicated or row-sharded: one rank's
    replicated run within the reference's bound; every rank the same;
    the saved shapes the true cardinalities."""
    want = _one_rank(("wdl", bags, bs), lambda: _train_wdl(
        lambda bags: None, bags, bs, False))
    ranks = worlds(world)["wdl"]
    for got in ranks:
        _close_wdl(got[(bags, bs, shard)], want)
        assert _same(got[(bags, bs, shard)]["params"][0][2],
                     ranks[0][(bags, bs, shard)]["params"][0][2])


@pytest.mark.parametrize("world", WORLDS)
def test_wdl_tables_are_sharded_on_a_world(worlds, world):
    """Each rank holds ceil(card_i / D) rows of every table and of both
    Adam moments; the ranks' shards rebuild the tables and the state bit
    for bit."""
    vs = [-(-c // world) for c in WDL_CARDS]
    for got in worlds(world)["wdl"]:
        lay = got["layout"]
        assert lay["vs"] == vs
        assert lay["embed"] == (1, sum(vs), 4)
        assert lay["wide_cat"] == (1, sum(vs))
        assert lay["moments"] == [(1, sum(vs), 4), (1, sum(vs))] * 2
        assert lay["roundtrip"]


@pytest.mark.parametrize("world", WORLDS)
def test_wdl_sharded_epochs_allocate_no_whole_table(worlds, world):
    """A sharded run's epochs make no tensor of a whole table's rows on
    any rank (the ledger keeps the shards; only the init, a checkpoint
    and the result see whole tables): 4 epochs make as many as 1."""
    for got in worlds(world)["wdl"]:
        one, four = got["allocs"]
        assert 0 < one == four


@pytest.mark.parametrize("world", WORLDS)
def test_wdl_sharded_resume_on_a_world_is_bit_identical(worlds, world):
    for got in worlds(world)["wdl"]:
        full, resumed = got["resume"]
        assert np.array_equal(full["valid"], resumed["valid"])
        for a, b in zip(full["params"][0], resumed["params"][0]):
            assert _same(a, b)


def _auc(score, y) -> float:
    """The ROC area from the ranks of the scores (ties averaged)."""
    from scipy.stats import rankdata
    r = rankdata(score)
    pos = y > 0.5
    n1, n0 = pos.sum(), (~pos).sum()
    return float((r[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


@pytest.mark.parametrize("world", WORLDS)
def test_wdl_matches_the_reference_mesh(worlds, world):
    """The reference's sharded trainer on ``world`` XLA CPU devices (2
    bags, batches of 24), from the port's initial params: params within
    1e-5, each member's AUC within 0.005."""
    from test_torch_wdl_shard import ref_leaves, reference_train
    from shifu_tpu_torch.models import wdl as P
    s = _wdl_spec()
    want, want_va, _ = reference_train(s, 24, world, bags=2, shard=True)
    got = worlds(world)["wdl"][0][(2, 24, True)]
    _close_wdl(got, {"valid": want_va,
                     "params": [ref_leaves(t) for t in want]})
    xn, xc, y, _ = _wdl_data()
    for score, tree in zip(got["scores"], want):
        ref = P.forward(P.from_columns(s, tree), s, torch.from_numpy(xn),
                        torch.from_numpy(xc)).numpy()[:, 0]
        assert abs(_auc(score, y) - _auc(ref, y)) <= 0.005


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("bags", [1, 2])
@pytest.mark.parametrize("world", WORLDS)
def test_streamed_wdl_matches_one_rank(worlds, world, bags, shard):
    """The streamed WDL with each window's rows split over the data axis
    (8 / 6 rows a rank, padded): one rank's within the reference's
    bound."""
    want = _one_rank(("wdl_streamed", bags), lambda: _train_wdl_streamed(
        None, bags, False))
    for got in worlds(world)["wdl_streamed"]:
        _close_wdl(got[(bags, shard)], want)


def test_streamed_wdl_matches_the_reference_mesh(worlds):
    """The reference's sharded streamed trainer on 2 XLA CPU devices from
    the port's initial params (its ``test_streamed_sharded_multi_device``
    bound)."""
    from test_torch_wdl_shard import (FakePlanes, data, ref_leaves,
                                      ref_mesh, reference_from_port_init,
                                      settings, streamed_mask_fn)
    from shifu_tpu.train.nn_trainer import TrainSettings as RT
    s = _wdl_spec({"num_feat_idx": [0, 1, 2], "cat_col_idx": [0, 1]})
    xn, xc, y, w = data()
    with reference_from_port_init(s, 7, 2) as R:
        res = R.trainer.train_wdl_streamed(
            FakePlanes(xn, xc, y, w, 16),
            R.wdl.WDLModelSpec.from_json(s.to_json()), settings(RT), 2,
            streamed_mask_fn(), [0, 1, 2], [0, 1], mesh=ref_mesh(2),
            shard=True)
        want = {"valid": np.asarray(res.valid_errors),
                "params": [ref_leaves(p) for p in res.params]}
    _close_wdl(worlds(2)["wdl_streamed"][0][(2, True)], want)


# ------------------------------------- stats -correlation, SE/ST varselect
@pytest.mark.parametrize("world", WORLDS)
def test_correlation_matches_one_rank(worlds, world):
    """Each rank's float64 pair sums of its block, one all_reduce: one
    rank's cells within 1e-12 relative (float64 reassociation)."""
    want = _correlate(None)
    for got in worlds(world)["correlation"]:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


def test_correlation_matches_the_reference_mesh(worlds):
    """The reference's accumulator on its 8-device mesh (float32 pair
    sums, numeric columns shifted by their means): within its bounds,
    rtol 1e-5 + 1e-6."""
    from shifu_tpu.ops.correlation import CorrelationAccumulator
    x, valid = _corr_inputs()
    acc = CorrelationAccumulator(n_cols=5, offset=np.nanmean(
        np.where(valid, x, np.nan), axis=0), mesh=_ref_mesh())
    for s, e in ((0, 400), (400, N)):
        acc.update(np.where(valid[s:e], x[s:e], 0.0), valid[s:e])
    for world in WORLDS:
        np.testing.assert_allclose(worlds(world)["correlation"][0],
                                   acc.finalize(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_sensitivity_matches_one_rank(worlds, world, tmp_path):
    """Each window's rows split over the ranks, the sums all_reduced: one
    rank's frozen MSEs and base error within 1e-6 (SE's bound), the same
    rows."""
    want = _one_rank("sensitivity", lambda: _sensitivity(None,
                                                         str(tmp_path)))
    for got in worlds(world)["sensitivity"]:
        assert got["rows"] == want["rows"] == N
        np.testing.assert_allclose(got["mse"], want["mse"], rtol=1e-6)
        np.testing.assert_allclose(got["base"], want["base"], rtol=1e-6)


def test_sensitivity_matches_the_reference_mesh(worlds, tmp_path):
    """The reference's streamed job on its 8-device mesh (windows of 240,
    a multiple of 8), 64-bit types off (C3): within 1e-6."""
    import jax
    from shifu_tpu.data.shards import Shards
    from shifu_tpu.data.streaming import ShardStream
    from shifu_tpu.models import nn as jnn
    from shifu_tpu.ops import sensitivity as rsens
    d = _nn_stream_plane(str(tmp_path / "ref"))
    spec, params = _sens_net()
    masks = rsens.mask_matrix(6, [[i] for i in range(6)] + [[1, 4]])
    with jax.enable_x64(False):
        mse, base, rows = rsens.streamed_sensitivity(
            ShardStream(Shards.open(d), ("x", "y"), STREAM_WINDOW),
            jnn.NNModelSpec(input_dim=6, hidden_nodes=[8],
                            activations=["tanh"], loss="log"),
            [{k: jax.numpy.asarray(v.numpy()) for k, v in layer.items()}
             for layer in params], masks, mesh=_ref_mesh(), mask_batch=3)
    for world in WORLDS:
        got = worlds(world)["sensitivity"][0]
        assert got["rows"] == rows
        np.testing.assert_allclose(got["mse"], mse, rtol=1e-6)
        np.testing.assert_allclose(got["base"], base, rtol=1e-6)


@pytest.mark.parametrize("step", PIPELINE_STEPS)
def test_pipeline_on_a_world_matches_one_rank(worlds, _prepared_template,
                                              tmp_path, step):
    """The model-set steps through their processors on a world of 2 (each
    rank its own copy of the prepared set) against one process's run:
    SE/ST the same selection and scores within 1e-6 / 1e-5 absolute (the
    bounds of ``tests/test_torch_varselect.py``), ``stats
    -correlation`` the same columns and cells (``correlation.csv`` prints
    6 decimals, so a float64 reassociation can move a cell by one unit of
    the 6th and no more; the merged sums themselves are held to 1e-12
    relative by ``test_correlation_matches_one_rank``), WDL
    (2 bags on the ensemble axis; 1 bag row-sharded by ``auto``) the model
    files' arrays within 1e-5 and their shapes equal."""
    import shutil

    def one():
        d = str(tmp_path / "one")
        shutil.copytree(_prepared_template, d)
        _prepare_pipeline_set(d)
        return _run_pipeline(d)
    want = _one_rank("pipeline", one)[step]
    for got in (r[step] for r in worlds(2)["pipeline"]):
        if step in ("se", "st"):
            (gs, gsel), (ws, wsel) = got, want
            assert gsel == wsel and sorted(gs) == sorted(ws)
            np.testing.assert_allclose([gs[k] for k in sorted(gs)],
                                       [ws[k] for k in sorted(ws)], rtol=0,
                                       atol=1e-6 if step == "se" else 1e-5)
        elif step == "correlation":
            assert got[0] == want[0]
            assert (np.isnan(got[1]) == np.isnan(want[1])).all()
            units = np.abs(np.round(got[1] * 1e6) - np.round(want[1] * 1e6))
            assert np.nanmax(units) <= 1
        else:
            assert sorted(got) == sorted(want)
            for f in want:
                assert sorted(got[f]) == sorted(want[f])
                for k in want[f]:
                    assert got[f][k].shape == want[f][k].shape
                    if k != "__spec__":
                        np.testing.assert_allclose(got[f][k], want[f][k],
                                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_paths_left_out_raise_naming_their_item(worlds, case):
    for rank in worlds(2)["not_ported"]:
        assert rank[case] is not None, f"{case} ran on a mesh"
        assert "item 12" in rank[case] and NOT_PORTED[case][3] in rank[case]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _npz_members(path):
    with np.load(path) as z:
        return {k: z[k].tobytes() for k in z.files}


def test_cli_world_trains_the_one_rank_forest(prepared_set, fixed_point):
    """Two ``python -m shifu_tpu_torch.cli train`` processes joined through
    the ``SHIFU_*`` variables, each on its own copy of the prepared set:
    every rank's ``models/model0.gbt`` holds the one-rank file's arrays and
    spec byte for byte."""
    import json
    import shutil
    from shifu_tpu_torch.cli import main
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    mc = ModelConfig.load(os.path.join(prepared_set, "ModelConfig.json"))
    mc.train.algorithm = Algorithm.GBT
    mc.train.params = {"TreeNum": 3, "MaxDepth": 4, "LearningRate": 0.1,
                       "Loss": "log", "MinInfoGain": 1e-3}
    mc.save(os.path.join(prepared_set, "ModelConfig.json"))
    dirs = [f"{prepared_set}_cli{r}" for r in range(2)]
    for d in dirs:
        shutil.copytree(prepared_set, d)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "shifu_tpu_torch.cli", "--dir", d, "train",
         "--device", "cpu"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=dict(
            os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
            SHIFU_COORDINATOR=f"127.0.0.1:{port}", SHIFU_NUM_PROCESSES="2",
            SHIFU_PROCESS_ID=str(r)))
        for r, d in enumerate(dirs)]
    assert main(["--dir", prepared_set, "train", "--device", "cpu"]) == 0
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out.decode()[-2000:]
    want = _npz_members(os.path.join(prepared_set, "models", "model0.gbt"))
    assert json.loads(bytes(np.frombuffer(want["__spec__"], np.uint8))
                      .decode())["n_trees"] == 3
    for d in dirs:
        assert _npz_members(os.path.join(d, "models", "model0.gbt")) == want


def test_cli_world_trains_the_one_rank_streamed_forest(prepared_set,
                                                       fixed_point, caplog):
    """``test_cli_world_trains_the_one_rank_forest`` out of core
    (``-Dshifu.train.streaming=on``, windows of 600 rows, a device budget
    that leaves a disk tail): both ranks' ``model0.gbt`` hold the one-rank
    file's arrays and spec byte for byte, and log the one-rank run's
    passes."""
    import json
    import logging
    import re
    import shutil
    from shifu_tpu_torch.cli import main
    from shifu_tpu_torch.config import ModelConfig, environment
    from shifu_tpu_torch.config.model_config import Algorithm
    mc = ModelConfig.load(os.path.join(prepared_set, "ModelConfig.json"))
    mc.train.algorithm = Algorithm.GBT
    mc.train.params = {"TreeNum": 3, "MaxDepth": 3, "LearningRate": 0.1,
                       "Loss": "log", "MinInfoGain": 1e-3}
    mc.save(os.path.join(prepared_set, "ModelConfig.json"))
    props = ["-Dshifu.train.streaming=on", "-Dshifu.train.windowRows=600",
             "-Dshifu.train.deviceCacheBytes=60000"]
    dirs = [f"{prepared_set}_cli{r}" for r in range(2)]
    for d in dirs:
        shutil.copytree(prepared_set, d)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "shifu_tpu_torch.cli", *props, "--dir", d,
         "train", "--device", "cpu"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=dict(
            os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
            SHIFU_COORDINATOR=f"127.0.0.1:{port}", SHIFU_NUM_PROCESSES="2",
            SHIFU_PROCESS_ID=str(r)))
        for r, d in enumerate(dirs)]
    line = re.compile(r"streamed GBT: .* (\d+) resident .*; (\d+) disk "
                      r"passes, (\d+) tail sweeps, .*; (\d+) bytes read")
    try:
        with caplog.at_level(logging.INFO,
                             logger="shifu_tpu_torch.train.dt_trainer"):
            assert main([*props, "--dir", prepared_set, "train", "--device",
                         "cpu"]) == 0
    finally:
        environment.reset_for_tests()
    one = [m.groups() for m in map(line.search, caplog.messages) if m]
    assert len(one) == 1 and int(one[0][2]) > 0, one     # a disk tail
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out.decode()[-2000:]
    want = _npz_members(os.path.join(prepared_set, "models", "model0.gbt"))
    assert json.loads(bytes(np.frombuffer(want["__spec__"], np.uint8))
                      .decode())["n_trees"] == 3
    for d in dirs:
        assert _npz_members(os.path.join(d, "models", "model0.gbt")) == want


def test_initialize_distributed_retries_then_coded_error(monkeypatch):
    """``tests/test_elastic.py:338``'s ladder: 1 try + 2 retries, then the
    coded ERROR_DCN_CONNECT (1063)."""
    import torch.distributed as dist
    from shifu_tpu_torch.config import environment
    from shifu_tpu_torch.config.errors import ShifuError
    from shifu_tpu_torch.parallel.mesh import initialize_distributed
    calls = []

    def boom(*a, **k):
        calls.append(1)
        raise RuntimeError("connection refused (injected)")
    monkeypatch.setattr(dist, "TCPStore", lambda *a, **k: object())
    monkeypatch.setattr(dist, "init_process_group", boom)
    environment.set_property("shifu.io.retries", "2")
    environment.set_property("shifu.io.retryBaseMs", "1")
    try:
        with pytest.raises(ShifuError) as e:
            initialize_distributed("localhost:1", num_processes=2,
                                   process_id=0, device="cpu")
    finally:
        environment.reset_for_tests()
    assert e.value.error_code.code == 1063
    assert "after 3 attempt" in str(e.value)
    assert len(calls) == 3


def test_initialize_distributed_succeeds_after_transient(monkeypatch):
    import torch.distributed as dist
    from shifu_tpu_torch.config import environment
    from shifu_tpu_torch.parallel.mesh import initialize_distributed
    calls = []

    def flaky(*a, **k):
        calls.append(k)
        if len(calls) == 1:
            raise RuntimeError("coordinator not up yet (injected)")
    monkeypatch.setattr(dist, "TCPStore", lambda *a, **k: object())
    monkeypatch.setattr(dist, "init_process_group", flaky)
    environment.set_property("shifu.io.retryBaseMs", "1")
    try:
        assert initialize_distributed("localhost:1", num_processes=2,
                                      process_id=1, device="cpu") == "gloo"
    finally:
        environment.reset_for_tests()
    assert len(calls) == 2
    assert calls[-1]["rank"] == 1 and calls[-1]["world_size"] == 2


def test_initialize_distributed_is_a_no_op_without_a_coordinator(
        monkeypatch):
    monkeypatch.delenv("SHIFU_COORDINATOR", raising=False)
    from shifu_tpu_torch.parallel.mesh import (device_mesh,
                                               initialize_distributed)
    assert initialize_distributed() is None
    assert device_mesh().shape == {"ensemble": 1, "data": 1}


if __name__ == "__main__":
    _serve(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
