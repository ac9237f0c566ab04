"""The port's device mesh (``shifu_tpu_torch.parallel.mesh``) on the CPU:
worlds of 2 and 3 gloo ranks against one rank and against the reference's
8-device virtual mesh (``tests/test_multichip.py:61-166``).

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
in their low bits (ROADMAP C4): rtol 1e-5.

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


#: each path a mesh leaves out: (what to run, the ROADMAP words it names)
NOT_PORTED = {
    "bagged_trees": ("GBT", {"baggingNum": 2}, {}, "tree trainers"),
    "streamed_trees": ("GBT", {}, {"shifu.train.streaming": "on"},
                       "tree trainers"),
    "streamed_nn": ("NN", {}, {"shifu.train.streaming": "on"},
                    "elastic plane"),
    "wdl": ("WDL", {}, {}, "row-sharded tables"),
    "varselect": (None, {}, {}, "varselect, correlation and sensitivity"),
    "correlation": (None, {}, {}, "varselect, correlation and sensitivity"),
}


def scenario_not_ported(mesh, dirs):
    """Run each left-out path on this rank's copy of a prepared set; the
    message each raises, or None."""
    from shifu_tpu_torch.config import ModelConfig, environment
    from shifu_tpu_torch.config.model_config import Algorithm
    from shifu_tpu_torch.pipeline.stats import StatsProcessor
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
            mc.train.algorithm = Algorithm[alg]
            mc.train.baggingNum = train.get("baggingNum", 1)
            mc.save(path)
            proc = TrainProcessor(d, params={}, device="cpu")
        elif case == "varselect":
            proc = VarSelectProcessor(d, params={}, device="cpu")
        else:
            proc = StatsProcessor(d, params={"correlation": True},
                                  device="cpu")
        try:
            proc.run()
            out[case] = None
        except NotImplementedError as e:
            out[case] = str(e)
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
        ("nn", {"bags": 2})]


def _world_results(root: str, world: int, template: str) -> dict:
    """Every scenario's per-rank results in a world of ``world`` ranks,
    computed once a test session: the first xdist worker to ask starts the
    ranks under a file lock and leaves the results beside it for the
    others (so a session starts 2 + 3 rank processes, not that many a
    worker).  The world of 2 also runs every left-out path on its own
    copies of the prepared set."""
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
            out = {name if not kw else (name, *kw.values()):
                   w.run(name, **kw) for name, kw in RUNS}
            if world == 2:
                dirs = tuple(os.path.join(run_dir, f"set{r}")
                             for r in range(world))
                for d in dirs:
                    shutil.copytree(template, d)
                out["not_ported"] = w.run("not_ported", dirs=dirs)
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
