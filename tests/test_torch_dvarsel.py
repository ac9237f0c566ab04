"""Port parity for the genetic wrapper (``filterBy GENETIC``) and
``varselect -recursive``: ``shifu_tpu_torch.train.dvarsel`` and
``pipeline.varselect`` against ``shifu_tpu``'s.

The reference runs under ``jax.enable_x64(False)``: under the test rig's
64-bit types its default-dtype Xavier draw is float64 (C3), while every
deployment's — and the port's threefry draw, bit for bit — is float32.
Both searches then start from the same weights and draw the same
populations from ``numpy.random.default_rng``; fitness (masked-NN
validation loss after ADAM epochs, float32 in both) agrees within rtol
1e-4 generation by generation, so the populations, the credit and the
``genetic.json`` ranking are equal.  The fixtures' fitness is well
separated (graded coefficients), as C9's are for splits: a swap of two
candidates within rounding would change every later generation.  The
streamed search is held to the reference's streamed one (same
populations, fitness within 1e-4), and its selection to the resident
search's.  ``-recursive 2`` (SE) makes the reference's
``ColumnConfig.json.{i}`` selections with SE within PR 11's tolerance
(1e-6 absolute: the reference sums in float64 under x64, C3).
"""

import json
import os
import shutil

import numpy as np
import pytest

from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch.config import environment

pytestmark = pytest.mark.torch_port

BETAS = np.array([3.0, -2.5, 2.0, -1.5, 1.0, -0.6, 0.3, 0.0])


@pytest.fixture(autouse=True)
def _clean_env():
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    yield
    environment.reset_for_tests()
    j_environment.reset_for_tests()


def _graded(n=2000, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, len(BETAS))).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ BETAS)))).astype(np.float32)
    w = rng.integers(1, 3, n).astype(np.float32)
    return x, y, w


def _recording(evaluate, log):
    def run(masks):
        fits = evaluate(masks)
        log.append((np.asarray(masks).copy(), np.asarray(fits)))
        return fits
    return run


SETTINGS = dict(n_select=3, population=8, generations=4, epochs=25,
                seed=1)


def test_genetic_unit_recovers_xor():
    """The reference's unit case (``tests/test_dvarsel_report.py:106``)
    on the port: the XOR pair from 6 columns."""
    from shifu_tpu_torch.train.dvarsel import (WrapperSettings,
                                               genetic_varselect)
    rng = np.random.default_rng(3)
    n = 2000
    x = rng.normal(size=(n, 6)).astype(np.float32)
    xor = (x[:, 0] > 0) ^ (x[:, 1] > 0)
    y = (rng.random(n) < 1 / (1 + np.exp(-3.0 * np.where(xor, 1, -1)))) \
        .astype(np.float32)
    scores, history = genetic_varselect(
        x, y, np.ones(n, np.float32), {ci: [ci] for ci in range(6)},
        WrapperSettings(n_select=2, population=12, generations=4,
                        epochs=60, seed=0), device="cpu")
    top2 = sorted(scores, key=scores.get, reverse=True)[:2]
    assert set(top2) == {0, 1}, scores
    assert history[-1]["best"] <= history[0]["best"] + 1e-6


def test_resident_search_matches_the_reference():
    import jax
    from shifu_tpu.train import dvarsel as J
    from shifu_tpu_torch.train import dvarsel as T
    x, y, w = _graded()
    blocks = {ci: [ci] for ci in range(x.shape[1])}
    runs = []
    for mod, kw in ((J, {}), (T, {"device": "cpu"})):
        s = mod.WrapperSettings(**SETTINGS)
        rng = np.random.default_rng(s.seed)
        vmask = rng.random(len(y)) < s.valid_rate
        log = []
        with jax.enable_x64(False):
            ev = mod.make_population_evaluator(x, y, w * ~vmask, w * vmask,
                                               s, **kw)
            scores, history = mod._genetic_search(
                _recording(ev, log), blocks, s, x.shape[1], rng)
        runs.append((log, scores, history))
    (jlog, jscores, jhist), (tlog, tscores, thist) = runs
    assert len(tlog) == len(jlog) == SETTINGS["generations"]
    for (tm, tf), (jm, jf) in zip(tlog, jlog):
        np.testing.assert_array_equal(tm, jm)           # same populations
        np.testing.assert_allclose(tf, jf, rtol=1e-4)
        gaps = np.diff(np.sort(np.unique(np.round(jf, 6))))
        assert gaps.min() > 1e-4 * jf.max()               # well separated
    assert tscores == jscores
    for a, b in zip(thist, jhist):
        np.testing.assert_allclose([a["best"], a["mean"]],
                                   [b["best"], b["mean"]], rtol=1e-4)
    top = sorted(tscores, key=tscores.get, reverse=True)[:3]
    assert {0, 1} <= set(top)


def _write_plane(d, x, y, w, shard_rows=512):
    os.makedirs(d)
    k = 0
    for s in range(0, len(y), shard_rows):
        np.savez(os.path.join(d, f"part-{k:05d}.npz"), x=x[s:s + shard_rows],
                 y=y[s:s + shard_rows], w=w[s:s + shard_rows])
        k += 1
    with open(os.path.join(d, "schema.json"), "w") as f:
        json.dump({"outputNames": [f"c{i}" for i in range(x.shape[1])],
                   "columnNums": list(range(x.shape[1])),
                   "numShards": k, "numRows": len(y)}, f)


def test_streamed_search_matches_the_reference_and_the_resident(tmp_path):
    """Windows of 512 rows over 2,000 (a padded tail): the same
    populations and fitness within 1e-4 as the reference's streamed
    search.  Its selection equals the resident search's on the XOR
    plane, whose best pair is far ahead of every other, with a search
    budget (16 candidates, 6 generations) that reaches it in both modes
    (they draw different populations: the resident one splits its rows
    with the search's generator first)."""
    import jax
    from shifu_tpu.data.shards import Shards as JShards
    from shifu_tpu.data.streaming import ShardStream as JStream
    from shifu_tpu.train import dvarsel as J
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.data.streaming import ShardStream
    from shifu_tpu_torch.train import dvarsel as T
    x, y, w = _graded()
    plane = str(tmp_path / "plane")
    _write_plane(plane, x, y, w)
    blocks = {ci: [ci] for ci in range(x.shape[1])}
    logs = []
    for mod, stream, kw in (
            (J, JStream(JShards.open(plane), ("x", "y", "w"), 512), {}),
            (T, ShardStream(Shards.open(plane), ("x", "y", "w"), 512),
             {"device": "cpu"})):
        s = mod.WrapperSettings(**SETTINGS)
        log = []
        with jax.enable_x64(False):
            ev, d = mod.make_streamed_population_evaluator(stream, s, **kw)
            scores, _ = mod._genetic_search(
                _recording(ev, log), blocks, s, d,
                np.random.default_rng(s.seed))
        logs.append((log, scores))
    (jlog, jscores), (tlog, tscores) = logs
    for (tm, tf), (jm, jf) in zip(tlog, jlog):
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_allclose(tf, jf, rtol=1e-4)
    assert tscores == jscores
    rng = np.random.default_rng(3)
    xor_x = rng.normal(size=(2000, 6)).astype(np.float32)
    xor = (xor_x[:, 0] > 0) ^ (xor_x[:, 1] > 0)
    xor_y = (rng.random(2000) < 1 / (1 + np.exp(
        -3.0 * np.where(xor, 1, -1)))).astype(np.float32)
    ones = np.ones(2000, np.float32)
    xor_plane = str(tmp_path / "xor")
    _write_plane(xor_plane, xor_x, xor_y, ones)
    xor_blocks = {ci: [ci] for ci in range(6)}
    s = T.WrapperSettings(n_select=2, population=16, generations=6,
                          epochs=60, seed=0)
    streamed, _ = T.genetic_varselect_streamed(
        ShardStream(Shards.open(xor_plane), ("x", "y", "w"), 512),
        xor_blocks, s, device="cpu")
    resident, _ = T.genetic_varselect(xor_x, xor_y, ones, xor_blocks, s,
                                      device="cpu")

    def top(scores):
        return set(sorted(scores, key=scores.get, reverse=True)[:2])
    assert top(streamed) == top(resident) == {0, 1}


def test_wrapper_settings_from_params_match():
    from shifu_tpu.train.dvarsel import WrapperSettings as J
    from shifu_tpu_torch.train.dvarsel import WrapperSettings as T
    p = {"EXPECT_VARIABLE_CNT": 4, "POPULATION_LIVE_SIZE": 6,
         "POPULATION_MULTIPLY_CNT": 2, "HYBRID_PERCENT": 30,
         "MUTATION_PERCENT": 10, "WrapperEpochs": 7,
         "WrapperLearningRate": 0.02, "WrapperHiddenNodes": 3, "Seed": 9}
    for params in (p, {}, None):
        assert T.from_params(params, 5, 0.2).__dict__ == \
            J.from_params(params, 5, 0.2).__dict__


@pytest.fixture(scope="module")
def nn_set(tmp_path_factory, _prepared_template):
    """The prepared set re-normalized without ``txn_id`` (a leaking id),
    with a reference-trained NN ``model0.nn`` (x64 off, C3)."""
    import jax
    from shifu_tpu.config import ModelConfig
    from shifu_tpu.pipeline.norm import NormalizeProcessor
    from shifu_tpu.pipeline.train import TrainProcessor
    d = str(tmp_path_factory.mktemp("torch_dvarsel") / "nnset")
    shutil.copytree(_prepared_template, d)
    cpath = os.path.join(d, "ColumnConfig.json")
    with open(cpath) as f:
        ccs = json.load(f)
    for c in ccs:
        c["finalSelect"] = c.get("columnFlag") not in (
            "Target", "Weight", "Meta") and c["columnName"] != "txn_id"
    with open(cpath, "w") as f:
        json.dump(ccs, f, indent=1)
    assert NormalizeProcessor(d, params={}).run() == 0
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.train.numTrainEpochs = 20
    mc.train.params = {"NumHiddenNodes": [8], "ActivationFunc": ["tanh"],
                       "Propagation": "R"}
    mc.save(path)
    with jax.enable_x64(False):
        assert TrainProcessor(d, params={}).run() == 0
    return d


def _pair(src, root, **varselect):
    from shifu_tpu.config import ModelConfig
    from shifu_tpu.config.model_config import FilterBy
    dirs = []
    for who in ("ref", "port"):
        d = str(root / who)
        shutil.copytree(src, d)
        path = os.path.join(d, "ModelConfig.json")
        mc = ModelConfig.load(path)
        for k, v in varselect.items():
            setattr(mc.varSelect, k, FilterBy[v] if k == "filterBy" else v)
        mc.save(path)
        dirs.append(d)
    return dirs


def _flags(d, name="ColumnConfig.json"):
    with open(os.path.join(d, name)) as f:
        return [(c["columnName"], c.get("finalSelect"), c.get("columnFlag"))
                for c in json.load(f)]


def test_genetic_step_matches_the_reference(nn_set, tmp_path):
    """``varselect`` with ``filterBy GENETIC`` over the fraud set's norm
    plane: the same ``genetic.json`` (history within 1e-4, the credit
    ranking equal) and the same selection."""
    import jax
    from shifu_tpu.pipeline.varselect import VarSelectProcessor as JVarSel
    from shifu_tpu_torch.pipeline.varselect import VarSelectProcessor
    params = {"POPULATION_LIVE_SIZE": 6, "POPULATION_MULTIPLY_CNT": 3,
              "WrapperEpochs": 15, "Seed": 2}
    ref, port = _pair(nn_set, tmp_path, filterBy="GENETIC", filterNum=3,
                      params=params)
    with jax.enable_x64(False):
        assert JVarSel(ref, params={}).run() == 0
    assert VarSelectProcessor(port, params={}, device="cpu").run() == 0
    got, want = (json.load(open(os.path.join(d, "varsels", "genetic.json")))
                 for d in (port, ref))
    assert list(got["credit"]) == list(want["credit"])
    assert got["credit"] == want["credit"]
    for a, b in zip(got["history"], want["history"]):
        np.testing.assert_allclose([a["best"], a["mean"]],
                                   [b["best"], b["mean"]], rtol=1e-4)
    assert _flags(port) == _flags(ref)
    assert sum(1 for _, s, _ in _flags(port) if s) == 3


def test_genetic_step_streams_past_the_budget(nn_set, tmp_path):
    """``-Dshifu.train.streaming=on``: the streamed search in the step
    (windows of 1,000 rows) selects as the reference's streamed step."""
    import jax
    from shifu_tpu.pipeline.varselect import VarSelectProcessor as JVarSel
    from shifu_tpu_torch.pipeline.varselect import VarSelectProcessor
    params = {"POPULATION_LIVE_SIZE": 8, "POPULATION_MULTIPLY_CNT": 2,
              "WrapperEpochs": 10, "Seed": 4}
    ref, port = _pair(nn_set, tmp_path, filterBy="GENETIC", filterNum=3,
                      params=params)
    for env in (environment, j_environment):
        env.set_property("shifu.train.streaming", "on")
        env.set_property("shifu.train.windowRows", "1000")
    with jax.enable_x64(False):
        assert JVarSel(ref, params={}).run() == 0
    assert VarSelectProcessor(port, params={}, device="cpu").run() == 0
    got, want = (json.load(open(os.path.join(d, "varsels", "genetic.json")))
                 for d in (port, ref))
    assert list(got["credit"]) == list(want["credit"])
    assert _flags(port) == _flags(ref)


def test_recursive_rounds_match_the_reference(nn_set, tmp_path):
    """``-recursive 2`` with SE: each round's ``ColumnConfig.json.{i}``
    selection and ``se.{i}.json`` ranking as the reference's, SE within
    1e-6; a KS set refuses ``-recursive`` in both."""
    import jax
    from shifu_tpu.pipeline.varselect import VarSelectProcessor as JVarSel
    from shifu_tpu_torch.pipeline.varselect import VarSelectProcessor
    ref, port = _pair(nn_set, tmp_path, filterBy="SE", filterNum=5)
    with jax.enable_x64(False):
        assert JVarSel(ref, params={"recursive": 2}).run() == 0
    assert VarSelectProcessor(port, params={"recursive": 2},
                              device="cpu").run() == 0
    vs = "varsels"
    for i in range(3):
        name = os.path.join(vs, f"ColumnConfig.json.{i}")
        assert _flags(port, name) == _flags(ref, name), i
    for i in range(2):
        got, want = (json.load(open(os.path.join(d, vs, f"se.{i}.json")))
                     for d in (port, ref))
        assert list(got) == list(want)
        np.testing.assert_allclose([got[k] for k in want],
                                   [want[k] for k in want], rtol=0,
                                   atol=1e-6)
    assert _flags(port) == _flags(ref)
    ks_ref, ks_port = _pair(nn_set, tmp_path / "ks", filterBy="KS")
    assert JVarSel(ks_ref, params={"recursive": 2}).run() == 1
    assert VarSelectProcessor(ks_port, params={"recursive": 2},
                              device="cpu").run() == 1
