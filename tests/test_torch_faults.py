"""The port's fault sites (``shifu_tpu_torch.faults``): the counterparts of
``tests/test_faults.py`` for the sites the port fires, in-process with
``ioerror`` injections.  A step killed at a site resumes from its journal
or checkpoint to the bytes of an uninterrupted run:

- ``norm:shard`` / ``norm:wire``: norm resumes at the first uncommitted
  shard, rewrites a truncated committed one, truncates torn wire bytes;
- ``train:tree`` (GBT), ``train:epoch`` (NN), ``train:bag`` (kernel SVM):
  the resumed models are bit-identical to an uninterrupted run's;
- ``train:superbatch``: the streamed GBT and RF disk tails resume from
  the drain's checkpoint bit-identically;
- ``rawcache:commit`` and ``spill:manifest``: one fault rides the retry
  ladder and commits; exhaustion leaves no manifest (no cache), the step
  succeeds and the next pass rebuilds;
- ``spill:append``: the spill is abandoned, the stream unaffected.

The catalog walk holds every site ``faults.SITES`` declares to a
``faults.fire`` call in the port, but the two multi-device sites of
ROADMAP Queue 1 step 5 (``dcn:step``, ``train:rejoin``).
"""

import ast
import json
import os
import shutil

import numpy as np
import pytest

from shifu_tpu_torch import faults
from shifu_tpu_torch.config import environment

pytestmark = pytest.mark.torch_port

PORT = os.path.join(os.path.dirname(__file__), "..", "shifu_tpu_torch")
#: sites the port does not fire yet (none: ``dcn:step`` and
#: ``train:rejoin`` fire in the elastic step protocol)
MULTI_DEVICE_SITES: set = set()


@pytest.fixture(autouse=True)
def _clean_faults():
    environment.reset_for_tests()
    faults.reset_for_tests()
    yield
    environment.reset_for_tests()
    faults.reset_for_tests()


def set_faults(spec: str) -> None:
    environment.set_property("shifu.faults", spec)
    faults.reset_for_tests()


# ------------------------------------------------------------ the catalog
def _fired_sites():
    out = set()
    for root, _, files in os.walk(PORT):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(root, f)) as fh:
                tree = ast.parse(fh.read())
            for n in ast.walk(tree):
                if isinstance(n, ast.Call) and len(n.args) >= 2 and (
                        (isinstance(n.func, ast.Attribute)
                         and n.func.attr == "fire"
                         and isinstance(n.func.value, ast.Name)
                         and n.func.value.id == "faults")):
                    site, point = n.args[0], n.args[1]
                    if isinstance(site, ast.Constant) \
                            and isinstance(point, ast.Constant):
                        out.add((site.value, point.value))
    return out


def test_every_declared_site_fires_in_the_port():
    fired = _fired_sites()
    assert fired <= set(faults.SITES), fired - set(faults.SITES)
    missing = set(faults.SITES) - MULTI_DEVICE_SITES - fired
    assert not missing, sorted(missing)


# ---------------------------------------------------------------- elastic
def test_dcn_step_and_train_rejoin_fire_in_the_elastic_protocol(tmp_path):
    """``dcn:step=<s>`` fires at step s's boundary before the contribution
    commits (nothing of the controller lands for s); ``train:rejoin=<s>``
    when a rejoined controller replays committed step s from the journal.
    One controller on a fake clock, in process."""
    import numpy as np
    from shifu_tpu_torch.parallel import elastic as el
    clock = [0.0]

    def ctx():
        return el.ElasticContext(
            str(tmp_path), "ctrl-0", cfg=el.ElasticConfig(quorum_frac=1.0),
            heartbeat=False, now_fn=lambda: clock[0],
            sleep_fn=lambda s: clock.__setitem__(0, clock[0] + s)).start()
    pay = {"g": np.ones(3, np.float32)}
    set_faults("dcn:step=1:ioerror")
    a = ctx()
    a.step(0, pay)
    with pytest.raises(faults.InjectedFault, match="dcn:step=1"):
        a.step(1, pay)
    assert not a.board.has_contribution(1, "ctrl-0")
    assert a.step(1, pay).contributors == ["ctrl-0"]  # the retry closes
    set_faults("train:rejoin=0:ioerror")
    b = ctx()                                         # incarnation 2
    assert b.rejoined
    with pytest.raises(faults.InjectedFault, match="train:rejoin=0"):
        b.closed_step(0)


# ------------------------------------------------------------------ norm
def _small_geometry(monkeypatch, chunk_rows=500, shard_rows=1024):
    """Chunks of 500 rows and shards of 1,024, so the 4,000-row fixture
    gives several shards."""
    monkeypatch.setattr("shifu_tpu_torch.data.parsepool.CHUNK_ROWS",
                        chunk_rows)
    monkeypatch.setattr("shifu_tpu_torch.pipeline.norm.SHARD_ROWS",
                        shard_rows)


def _norm(d):
    from shifu_tpu_torch.pipeline.norm import NormalizeProcessor
    return NormalizeProcessor(d, params={}).run()


def _plane_arrays(d, sub):
    from shifu_tpu_torch.data.shards import Shards
    s = Shards.open(os.path.join(d, "tmp", sub))
    return [{k: np.asarray(v).copy() for k, v in p.items()}
            for p in s.iter_shards()]


def _assert_same_planes(a, b):
    for sub in ("NormalizedData", "CleanedData"):
        pa, pb = _plane_arrays(a, sub), _plane_arrays(b, sub)
        assert len(pa) == len(pb) > 2
        for x, y in zip(pa, pb):
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype
                assert x[k].tobytes() == y[k].tobytes(), (sub, k)


def _journal(d, step):
    with open(os.path.join(d, "tmp", "journal", f"{step}.json")) as f:
        return json.load(f)


def test_norm_resumes_at_first_uncommitted_shard(prepared_set, monkeypatch):
    control = prepared_set + "_ctl"
    shutil.copytree(prepared_set, control)
    _small_geometry(monkeypatch)
    set_faults("norm:shard=2:ioerror")
    with pytest.raises(faults.InjectedFault):
        _norm(prepared_set)
    doc = _journal(prepared_set, "NORMALIZE")
    assert doc["status"] == "running"
    assert sorted(doc["items"]) == ["shard-00000", "shard-00001"]
    part0 = os.path.join(prepared_set, "tmp", "NormalizedData",
                         "part-00000.npz")
    mtime0 = os.stat(part0).st_mtime_ns
    set_faults("")
    assert _norm(prepared_set) == 0
    assert os.stat(part0).st_mtime_ns == mtime0     # the prefix stays
    assert _journal(prepared_set, "NORMALIZE")["status"] == "complete"
    assert _norm(control) == 0
    _assert_same_planes(prepared_set, control)


def test_norm_resume_rewrites_truncated_committed_shard(prepared_set,
                                                        monkeypatch):
    control = prepared_set + "_ctl"
    shutil.copytree(prepared_set, control)
    _small_geometry(monkeypatch)
    set_faults("norm:shard=2:ioerror")
    with pytest.raises(faults.InjectedFault):
        _norm(prepared_set)
    part1 = os.path.join(prepared_set, "tmp", "NormalizedData",
                         "part-00001.npz")
    with open(part1, "r+b") as f:
        f.truncate(os.path.getsize(part1) // 2)
    set_faults("")
    assert _norm(prepared_set) == 0
    assert _norm(control) == 0
    _assert_same_planes(prepared_set, control)


def test_norm_wire_fault_resume_bit_identical(prepared_set, monkeypatch):
    from shifu_tpu_torch.data.spill import wire_dir
    control = prepared_set + "_ctl"
    shutil.copytree(prepared_set, control)
    _small_geometry(monkeypatch)
    set_faults("norm:wire=2:ioerror")
    with pytest.raises(faults.InjectedFault):
        _norm(prepared_set)
    doc = _journal(prepared_set, "NORMALIZE")
    assert "shard-00001" in doc["items"]
    assert "shard-00002" not in doc["items"]
    wdir = wire_dir(os.path.join(prepared_set, "tmp", "CleanedData"),
                    ("bins", "y", "w"))
    with open(os.path.join(wdir, "y.raw"), "ab") as f:
        f.write(b"\xff" * 12)            # a mid-append crash's torn tail
    set_faults("")
    assert _norm(prepared_set) == 0
    assert _norm(control) == 0
    _assert_same_planes(prepared_set, control)


# ----------------------------------------------------------------- train
def _set_train(mdir, alg, params, epochs=None, **train):
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    path = os.path.join(mdir, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.train.algorithm = Algorithm[alg]
    mc.train.params = params
    if epochs is not None:
        mc.train.numTrainEpochs = epochs
    for k, v in train.items():
        setattr(mc.train, k, v)
    mc.save(path)


def _train(mdir, **params):
    from shifu_tpu_torch.pipeline.train import TrainProcessor
    return TrainProcessor(mdir, params=params, device="cpu").run()


def _pair(prepared_set, alg, params, **kw):
    control = prepared_set + "_ctl"
    shutil.copytree(prepared_set, control)
    for d in (prepared_set, control):
        _set_train(d, alg, params, **kw)
    assert _train(control) == 0
    return control


def _same_forests(a, b):
    assert len(a) == len(b)
    for ta, tb in zip(a, b):
        for k in ("split_feat", "left_mask", "leaf_value"):
            assert np.asarray(getattr(ta, k)).tobytes() == \
                np.asarray(getattr(tb, k)).tobytes(), k


def test_gbt_crash_resume_bit_identical(prepared_set):
    """``train:tree=9`` stops the port's GBT at tree 9, as it stops the
    reference's; the torn journal resumes without ``-resume`` from the
    checkpoint to the uninterrupted forest."""
    from shifu_tpu_torch.models.tree import load_model
    control = _pair(prepared_set, "GBT", {"TreeNum": 10, "MaxDepth": 2,
                                          "CheckpointInterval": 4})
    set_faults("train:tree=9:ioerror")
    with pytest.raises(faults.InjectedFault, match="train:tree=9"):
        _train(prepared_set)
    assert os.path.isfile(os.path.join(prepared_set, "tmp", "checkpoints",
                                       "forest_ckpt.npz"))
    with open(os.path.join(prepared_set, "tmp", "train.progress")) as f:
        assert len(f.read().splitlines()) == 9
    set_faults("")
    assert _train(prepared_set) == 0
    trees = [load_model(os.path.join(d, "models", "model0.gbt"))[1]
             for d in (control, prepared_set)]
    assert len(trees[0]) == 10
    _same_forests(*trees)


def test_nn_crash_resume_bit_identical(prepared_set):
    from shifu_tpu_torch.models import nn as nn_model
    control = _pair(prepared_set, "NN",
                    {"NumHiddenNodes": [8], "CheckpointInterval": 3,
                     "Propagation": "R"}, epochs=9)
    set_faults("train:epoch=6:ioerror")
    with pytest.raises(faults.InjectedFault, match="train:epoch=6"):
        _train(prepared_set)
    set_faults("")
    assert _train(prepared_set) == 0
    _, pc = nn_model.load_model(os.path.join(control, "models",
                                             "model0.nn"))
    _, pr = nn_model.load_model(os.path.join(prepared_set, "models",
                                             "model0.nn"))
    assert len(pc) == len(pr)
    for lc, lr in zip(pc, pr):
        for k in lc:
            assert lc[k].numpy().tobytes() == lr[k].numpy().tobytes(), k


def _cut_rows(mdir, rows):
    """Re-norm ``mdir`` (the port's ``norm``) from the CSV's first
    ``rows`` rows: the dual solve's cost grows with the rows squared."""
    from shifu_tpu_torch.config import ModelConfig
    path = os.path.join(mdir, "ModelConfig.json")
    mc = ModelConfig.load(path)
    cut = os.path.join(mdir, "train_cut.csv")
    with open(mc.dataSet.dataPath) as src, open(cut, "w") as out:
        for _, line in zip(range(rows + 1), src):      # the header, rows
            out.write(line)
    mc.dataSet.dataPath = cut
    mc.save(path)
    assert _norm(mdir) == 0


def test_kernel_svm_bag_crash_resumes_at_the_first_unsolved_bag(
        prepared_set):
    """``train:bag=1`` stops a 3-bag RBF SVM before bag 1; the resumed
    run keeps bag 0 (not re-solved) and solves bags 1-2 to the
    uninterrupted run's bytes (on the CSV's first 400 rows)."""
    params = {"Kernel": "RBF", "Gamma": 0.2, "Const": 1.0}
    _cut_rows(prepared_set, 400)
    control = _pair(prepared_set, "SVM", params, baggingNum=3)
    set_faults("train:bag=1:ioerror")
    with pytest.raises(faults.InjectedFault, match="train:bag=1"):
        _train(prepared_set)
    bag0 = os.path.join(prepared_set, "models", "model0.svm")
    mtime0 = os.stat(bag0).st_mtime_ns
    assert not os.path.exists(os.path.join(prepared_set, "models",
                                           "model1.svm"))
    set_faults("")
    assert _train(prepared_set) == 0
    assert os.stat(bag0).st_mtime_ns == mtime0
    for b in range(3):
        got, want = (dict(np.load(os.path.join(d, "models",
                                               f"model{b}.svm")))
                     for d in (prepared_set, control))
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].tobytes() == want[k].tobytes(), (b, k)


# ----------------------------------------- disk-tail super-batch drains
N_BINS = 8
GBT_WIN = 256 * (6 * 1 + 3 * 4)     # a prepared GBT window: u8 bins, y/tw/vw
RF_WIN = 256 * (6 * 1 + 2 * 4)      # a prepared RF window: u8 bins, y/w


def _tail_stream(d):
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.data.streaming import ShardStream
    if not os.path.isfile(os.path.join(d, "schema.json")):
        rng = np.random.default_rng(3)
        n, c = 1024, 6
        bins = rng.integers(0, N_BINS - 1, size=(n, c)).astype(np.int16)
        logit = (bins[:, 0] - 3) * 0.8 + (bins[:, 1] == 2) * 1.5 - 0.5
        y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
        w = np.ones(n, np.float32)
        os.makedirs(d)
        for shard, s in enumerate(range(0, n, 300)):
            np.savez(os.path.join(d, f"part-{shard:05d}.npz"),
                     bins=bins[s:s + 300], y=y[s:s + 300], w=w[s:s + 300])
        with open(os.path.join(d, "schema.json"), "w") as f:
            json.dump({"columnNums": list(range(c)), "numRows": n}, f)
    return ShardStream(Shards.open(d), ("bins", "y", "w"), 256)


def _saver(saved):
    def ckpt(trees, history, init_score, scores=None):
        saved.update(trees=list(trees), history=list(history),
                     init=init_score,
                     scores=None if scores is None else scores.copy())
    return ckpt


def test_gbt_tail_superbatch_crash_resume_bit_identical(tmp_path,
                                                        monkeypatch):
    """The coarse-to-fine tail killed at its second drain resumes from the
    drain's checkpoint (which commits only trees whose score updates are
    final) to the uninterrupted forest."""
    from shifu_tpu_torch.train.dt_trainer import (DTSettings,
                                                  train_gbt_streamed)
    monkeypatch.setenv("SHIFU_TREE_TAIL_C2F", "1")
    d = str(tmp_path / "s")
    budget = 2 * GBT_WIN + 64
    settings = DTSettings(n_trees=10, depth=3, loss="log", seed=0,
                          checkpoint_every=3)
    control = train_gbt_streamed(_tail_stream(d), N_BINS, None, settings,
                                 cache_budget=budget, device="cpu")
    assert control.trees_built == 10
    saved = {}
    set_faults("train:superbatch=2:ioerror")
    with pytest.raises(faults.InjectedFault):
        train_gbt_streamed(_tail_stream(d), N_BINS, None, settings,
                           cache_budget=budget, checkpoint_fn=_saver(saved),
                           device="cpu")
    assert 0 < len(saved["trees"]) < 10
    set_faults("")
    resumed = train_gbt_streamed(
        _tail_stream(d), N_BINS, None, settings, cache_budget=budget,
        init_trees=saved["trees"], init_score=saved["init"],
        start_history=saved["history"], init_scores=saved["scores"],
        device="cpu")
    assert resumed.trees_built == 10
    _same_forests(control.trees, resumed.trees)
    np.testing.assert_allclose(np.array(control.history),
                               np.array(resumed.history), rtol=1e-5)


def test_rf_tail_superbatch_crash_resume_bit_identical(tmp_path):
    """The RF tail's super-batches of 2 trees: a crash at the second
    drain keeps batch 1's commit, and the regrown forest is bit-identical
    (the hash bags are stateless a (tree, row))."""
    from shifu_tpu_torch.train.dt_trainer import (DTSettings,
                                                  train_rf_streamed)
    d = str(tmp_path / "s")
    budget = 2 * RF_WIN + 64
    settings = DTSettings(n_trees=6, depth=3, impurity="entropy",
                          loss="squared", seed=2, tail_tree_batch=2)
    control = train_rf_streamed(_tail_stream(d), N_BINS, None, settings,
                                cache_budget=budget, device="cpu")
    assert control.trees_built == 6
    saved = {}
    set_faults("train:superbatch=2:ioerror")
    with pytest.raises(faults.InjectedFault):
        train_rf_streamed(_tail_stream(d), N_BINS, None, settings,
                          cache_budget=budget, checkpoint_fn=_saver(saved),
                          device="cpu")
    assert len(saved["trees"]) == 2
    set_faults("")
    resumed = train_rf_streamed(
        _tail_stream(d), N_BINS, None, settings, cache_budget=budget,
        init_trees=saved["trees"], start_history=saved["history"],
        device="cpu")
    assert resumed.trees_built == 6
    _same_forests(control.trees, resumed.trees)


# ------------------------------------------------- raw cache and spill
def _rawcache_manifests(mdir):
    root = os.path.join(mdir, "tmp", "RawCache")
    if not os.path.isdir(root):
        return []
    return [os.path.join(root, d, "manifest.json")
            for d in sorted(os.listdir(root))
            if os.path.isfile(os.path.join(root, d, "manifest.json"))]


def _init(mdir):
    from shifu_tpu_torch.pipeline.create import InitProcessor
    assert InitProcessor(mdir).run() == 0


def _stats(mdir):
    from shifu_tpu_torch.pipeline.stats import StatsProcessor
    return StatsProcessor(mdir, params={}, device="cpu").run()


def test_rawcache_commit_fault_retries_then_lands(model_set):
    environment.set_property("shifu.io.retryBaseMs", "1")
    _init(model_set)
    set_faults("rawcache:commit=0:ioerror")
    assert _stats(model_set) == 0
    assert _rawcache_manifests(model_set)


def test_rawcache_commit_exhaustion_absent_cache_then_rebuilt(model_set):
    """Exhausted retries at the commit abandon the cache without failing
    the step (the cache is an optimization, not the output); the next
    pass rebuilds it."""
    environment.set_property("shifu.io.retryBaseMs", "1")
    _init(model_set)
    set_faults("rawcache:commit=0:ioerror@99")
    assert _stats(model_set) == 0
    assert _rawcache_manifests(model_set) == []
    set_faults("")
    assert _norm(model_set) == 0
    assert _rawcache_manifests(model_set)


def test_spill_manifest_commit_retries_and_exhaustion(tmp_path):
    from shifu_tpu_torch.data.spill import SpillWriter, open_spill
    environment.set_property("shifu.io.retryBaseMs", "1")
    for spec, lands in (("spill:manifest=0:ioerror", True),
                        ("spill:manifest=0:ioerror@99", False)):
        set_faults(spec)
        d = str(tmp_path / f"spill-{lands}")
        w = SpillWriter(d, ("y",), [["s", 1, 2]], 1 << 20)
        assert w.append({"y": np.arange(8, dtype=np.float32)})
        assert w.finish() is lands
        rd, _ = open_spill(d, ("y",), [["s", 1, 2]])
        assert (rd is not None and rd.rows == 8) is lands
        assert not [f for f in os.listdir(d) if ".tmp" in f]


def test_spill_append_fault_abandons_the_spill(tmp_path):
    from shifu_tpu_torch.data.spill import SpillWriter, open_spill
    set_faults("spill:append=1:ioerror")
    d = str(tmp_path / "spill")
    w = SpillWriter(d, ("y",), [["s", 1, 2]], 1 << 20)
    assert w.append({"y": np.arange(8, dtype=np.float32)})
    assert not w.append({"y": np.arange(8, dtype=np.float32)})
    assert not w.finish()
    assert open_spill(d, ("y",), [["s", 1, 2]])[0] is None


def test_wire_shard_read_fault_rides_the_retry_ladder(prepared_set):
    """``shards:shard`` fires on a wire plane's shard reads too (the
    reference's second place): one fault is retried, the shard read."""
    from shifu_tpu_torch.data.shards import Shards
    environment.set_property("shifu.io.retryBaseMs", "1")
    s = Shards.open(os.path.join(prepared_set, "tmp", "CleanedData"))
    assert s.is_wire
    want = [p["y"].copy() for p in s.iter_shards()]
    set_faults("shards:shard=0:ioerror")
    got = [p["y"].copy() for p in s.iter_shards()]
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
    set_faults("shards:shard=0:ioerror@99")
    with pytest.raises(OSError, match="wire shard read failed"):
        list(s.iter_shards())
