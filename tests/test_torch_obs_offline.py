"""Port parity for the offline telemetry plane — the step runner's spans,
the offline counters, ``drift.json``, the hand kernels' cost records,
``obs/{report,timeline,utilization,monitor}`` and ``--profile``.

With telemetry on, both packages run ``init → stats → norm → train (GBT)
→ eval`` on copies of one scaffolded fraud set (the port on the CPU,
where the kernel wrappers take their plain versions):

- each step's span tree holds the reference's (name, kind) pairs; the
  port's extra spans are its finer ``train`` phases;
- the deterministic counters are equal (rows, disk passes, trees, host
  syncs, quarantined rows, raw-cache passes, drift rows);
- ``drift.json``'s per-column PSI agrees within 1e-6;
- the cost records' launches equal the calls of the plain versions the
  kernel wrappers made, per record name.

The renders are pure functions of the trace files: each package renders
both packages' traces, and the reports, utilization reports, timelines
and monitor documents must be equal byte for byte — except the
utilization report's device/peak row and its ``no cost record`` lines,
which are the port's by design (``obs/utilization.py``).  The golden and
torn-tail traces of ``tests/test_obs_costs.py`` and the multi-process
dirs of ``tests/test_obs_aggregate.py`` are the oracles.
"""

import json
import os
import shutil
import sys
import time

import numpy as np
import pytest

from shifu_tpu import obs as jobs
from shifu_tpu.config import environment as jenv
from shifu_tpu_torch import obs
from shifu_tpu_torch.config import environment

pytestmark = pytest.mark.torch_port

GBT = {"TreeNum": 3, "MaxDepth": 3, "Loss": "log"}


def _reset():
    for o in (obs, jobs):
        o.reset_for_tests()
    for e in (environment, jenv):
        e.reset_for_tests()


@pytest.fixture(autouse=True)
def _clean():
    _reset()
    yield
    _reset()


class _Calls:
    """Counts the plain-version calls the port's kernel wrappers make."""

    def __init__(self, monkeypatch):
        from shifu_tpu_torch.ops import hist, stats_hist, tree_quant
        self.n = {"pallas.hist": 0, "stats.stats_hist": 0,
                  "pallas.tree_traverse": 0}
        for mod, fn, name in (
                (hist, "build_histograms_ref", "pallas.hist"),
                (hist, "build_histograms_batch_ref", "pallas.hist"),
                (stats_hist, "stats_histograms_ref", "stats.stats_hist"),
                (tree_quant, "predict_forest_quant_ref",
                 "pallas.tree_traverse")):
            orig = getattr(mod, fn)

            def counted(*a, _orig=orig, _name=name, **kw):
                self.n[_name] += 1
                return _orig(*a, **kw)
            monkeypatch.setattr(mod, fn, counted)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, fraud_csv):
    """{package: model set dir} after the offline path with telemetry on,
    and the port's plain-version call counts."""
    from conftest import _scaffold_model_set
    from shifu_tpu.config import ModelConfig
    base = tmp_path_factory.mktemp("obs_offline")
    d = _scaffold_model_set(str(base / "scaffold"), fraud_csv)
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    mc.train.algorithm = "GBT"
    mc.train.params = dict(GBT)
    mc.save(os.path.join(d, "ModelConfig.json"))
    out = {}
    for pkg in ("ref", "port"):
        out[pkg] = str(base / pkg)
        shutil.copytree(d, out[pkg])
    _reset()
    from shifu_tpu.pipeline.create import InitProcessor as JI
    from shifu_tpu.pipeline.evaluate import EvalProcessor as JE
    from shifu_tpu.pipeline.norm import NormalizeProcessor as JN
    from shifu_tpu.pipeline.stats import StatsProcessor as JS
    from shifu_tpu.pipeline.train import TrainProcessor as JT
    jobs.set_enabled(True)
    assert JI(out["ref"]).run() == 0
    for P, p in ((JS, {}), (JN, {}), (JT, {}), (JE, {"run_eval": ""})):
        assert P(out["ref"], params=p).run() == 0
    _reset()
    from shifu_tpu_torch.pipeline.create import InitProcessor
    from shifu_tpu_torch.pipeline.evaluate import EvalProcessor
    from shifu_tpu_torch.pipeline.norm import NormalizeProcessor
    from shifu_tpu_torch.pipeline.stats import StatsProcessor
    from shifu_tpu_torch.pipeline.train import TrainProcessor
    mp = pytest.MonkeyPatch()
    try:
        calls = _Calls(mp)
        obs.set_enabled(True)
        assert InitProcessor(out["port"]).run() == 0
        assert StatsProcessor(out["port"], device="cpu").run() == 0
        assert NormalizeProcessor(out["port"]).run() == 0
        assert TrainProcessor(out["port"], params={},
                              device="cpu").run() == 0
        assert EvalProcessor(out["port"], params={"run_eval": ""},
                             device="cpu").run() == 0
    finally:
        mp.undo()
        _reset()
    out["calls"] = dict(calls.n)
    return out


def _trace(d):
    return os.path.join(d, "telemetry", "trace.jsonl")


def _blocks(path):
    out = {}
    step = None
    with open(path) as f:
        for ln in f:
            r = json.loads(ln)
            if r["kind"] == "meta":
                step = r["step"]
                out[step] = {"spans": set(), "metrics": {}, "costs": {},
                             "roots": []}
            elif r["kind"] == "span":
                out[step]["spans"].add((r["name"],
                                        r["attrs"].get("kind")))
                if r["parent"] is None:
                    out[step]["roots"].append(r["name"])
            elif r["kind"] == "metric":
                out[step]["metrics"][r["name"]] = r.get("value")
            elif r["kind"] == "cost":
                c = out[step]["costs"]
                c[r["name"]] = c.get(r["name"], 0) + r["launches"]
    return out


DETERMINISTIC = ("stats.rows", "stats.columns", "norm.rows", "norm.shards",
                 "train.trees", "train.trees_built", "train.host_syncs",
                 "eval.rows_scored", "ingest.disk_passes",
                 "ingest.bytes_read", "data.quarantined_rows",
                 "data.quarantined_shards", "rawcache.hits",
                 "rawcache.misses", "rawcache.bytes_written", "drift.rows",
                 "drift.columns_tracked")


def test_span_trees_have_the_reference_names_and_kinds(runs):
    ref, port = _blocks(_trace(runs["ref"])), _blocks(_trace(runs["port"]))
    assert list(port) == list(ref) == ["INIT", "STATS", "NORMALIZE",
                                       "TRAIN", "EVAL"]
    for step in ref:
        assert port[step]["roots"] == ref[step]["roots"] == [step]
        assert ref[step]["spans"] <= port[step]["spans"], step
        extra = port[step]["spans"] - ref[step]["spans"]
        assert all(kind == "phase" for _, kind in extra), extra
        assert {(step, "step"), ("setup", "phase"),
                ("process", "phase")} <= port[step]["spans"]


def test_deterministic_counters_equal_the_reference(runs):
    ref, port = _blocks(_trace(runs["ref"])), _blocks(_trace(runs["port"]))
    for step in ref:
        for name in DETERMINISTIC:
            assert port[step]["metrics"].get(name) == \
                ref[step]["metrics"].get(name), (step, name)
    assert port["TRAIN"]["metrics"]["train.trees"] == GBT["TreeNum"]
    assert port["STATS"]["metrics"]["stats.rows"] == 4000


def test_drift_json_psi_agrees(runs):
    docs = []
    for pkg in ("ref", "port"):
        with open(os.path.join(runs[pkg], "telemetry", "drift.json")) as f:
            docs.append(json.load(f))
    ref, port = docs
    assert port["rows"] == ref["rows"] == 4000
    assert port["flagged"] == ref["flagged"]
    assert set(port["columns"]) == set(ref["columns"]) and ref["columns"]
    for col, v in ref["columns"].items():
        assert abs(port["columns"][col] - v) <= 1e-6, col


def test_cost_record_launches_equal_the_wrapper_calls(runs):
    port = _blocks(_trace(runs["port"]))
    launches = {}
    for block in port.values():
        for name, n in block["costs"].items():
            launches[name] = launches.get(name, 0) + n
    assert launches == runs["calls"]
    assert launches["pallas.hist"] > 0 and launches["stats.stats_hist"] > 0
    assert launches["pallas.tree_traverse"] > 0


# ---------------------------------------------------------------- renders
def _strip_port_lines(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("device: ")
                     and not ln.startswith("  no cost record:")
                     and not ln.startswith("no cost records in this trace"))


def _renders(d):
    from shifu_tpu.obs import report as jr
    from shifu_tpu.obs import utilization as ju
    from shifu_tpu_torch.obs import report as pr
    from shifu_tpu_torch.obs import utilization as pu
    return ((pr.render_telemetry(d), jr.render_telemetry(d)),
            (_strip_port_lines(pu.render_utilization(d)),
             _strip_port_lines(ju.render_utilization(d))))


def _normalise(text, d):
    return text.replace(d, "<dir>")


@pytest.mark.parametrize("who", ["ref", "port"])
def test_reports_render_byte_equal(runs, who, tmp_path):
    d = str(tmp_path / who)
    shutil.copytree(os.path.join(runs[who], "telemetry"),
                    os.path.join(d, "telemetry"))
    (rep_p, rep_j), (util_p, util_j) = _renders(d)
    assert rep_p == rep_j and "STATS" in rep_p
    assert util_p == util_j and "utilization:" in util_p


@pytest.mark.parametrize("who", ["ref", "port"])
def test_timelines_are_equal(runs, who, tmp_path):
    from shifu_tpu.obs import timeline as jt
    from shifu_tpu_torch.obs import timeline as pt
    d = str(tmp_path / who)
    shutil.copytree(os.path.join(runs[who], "telemetry"),
                    os.path.join(d, "telemetry"))
    docs = []
    for mod, name in ((pt, "port.json"), (jt, "ref.json")):
        out = mod.export_timeline(d, str(tmp_path / name))
        with open(out) as f:
            docs.append(json.load(f))
    assert docs[0] == docs[1] and docs[0]["traceEvents"]


def _golden_trace(td):
    """``tests/test_obs_costs.py``'s hand-built trace, verbatim."""
    os.makedirs(os.path.join(td, "telemetry"))
    lines = [
        {"kind": "meta", "schema_version": 7, "step": "TRAIN", "ts": 1.0,
         "pid": 7, "backend": {"platform": "cpu", "device_kind": "cpu"}},
        {"kind": "span", "name": "TRAIN", "id": 1, "parent": None,
         "ts": 1.0, "dur_s": 2.0, "tid": "MainThread", "attrs": {}},
        {"kind": "metric", "type": "counter", "name": "ingest.rows_emitted",
         "value": 9000.0},
        {"kind": "metric", "type": "counter", "name": "ingest.rows_padded",
         "value": 1000.0},
        {"kind": "metric", "type": "counter", "name": "xla.recompiles",
         "value": 1.0},
        {"kind": "cost", "name": "gbt.forest", "signature": "f32[100,8]",
         "flops": 4.0e9, "bytes_accessed": 1.0e9, "compiles": 1,
         "launches": 2, "analytic": False},
        {"kind": "cost", "name": "nn.step", "signature": "f32[100,8]",
         "flops": 1.0e9, "bytes_accessed": 4.0e9, "compiles": 1,
         "launches": 1, "analytic": False},
    ]
    with open(os.path.join(td, "telemetry", "trace.jsonl"), "w") as f:
        for ln in lines:
            f.write(json.dumps(ln) + "\n")


def test_golden_and_torn_traces_render_alike(tmp_path, monkeypatch):
    from shifu_tpu.obs import timeline as jt
    from shifu_tpu_torch.obs import timeline as pt
    from shifu_tpu_torch.obs import utilization as pu
    monkeypatch.setenv("SHIFU_TPU_PEAK_FLOPS", "1e11")
    monkeypatch.setenv("SHIFU_TPU_PEAK_BW", "5e10")
    td = str(tmp_path / "golden")
    _golden_trace(td)
    (rep_p, rep_j), (util_p, util_j) = _renders(td)
    assert rep_p == rep_j and util_p == util_j
    full = pu.render_utilization(td)
    assert "MFU 4.50%" in full and "1 RECOMPILE(S)" in full
    with open(os.path.join(td, "telemetry", "trace.jsonl"), "a") as f:
        f.write('{"kind": "cost", "name": "torn')   # a crash mid-write
    (rep_p, rep_j), (util_p, util_j) = _renders(td)
    assert rep_p == rep_j and util_p == util_j and "torn" in util_p
    docs = []
    for mod, name in ((pt, "p.json"), (jt, "j.json")):
        skipped = []
        out = mod.export_timeline(td, str(tmp_path / name), skipped=skipped)
        assert len(skipped) == 1
        with open(out) as f:
            docs.append(json.load(f))
    assert docs[0] == docs[1]
    assert docs[0]["otherData"]["torn_lines_skipped"] == 1


def _proc_dir(base, name, proc, rows, skew_s=0.0, now=None, step="TRAIN",
              state="running"):
    """``tests/test_obs_aggregate.py``'s one-process telemetry dir."""
    now = time.time() if now is None else now
    d = os.path.join(base, name)
    hd = os.path.join(d, "telemetry", "health")
    os.makedirs(hd, exist_ok=True)
    path = os.path.join(hd, f"{proc}.json")
    with open(path, "w") as f:
        json.dump({"proc": proc, "step": step, "state": state,
                   "ts": now + skew_s, "started_ts": now + skew_s - 60,
                   "last_progress_ts": now + skew_s - 1,
                   "interval_s": 5.0, "rows": rows, "pid": 4242}, f)
    os.utime(path, (now, now))
    with open(os.path.join(d, "telemetry", "trace.jsonl"), "w") as f:
        f.write(json.dumps(
            {"kind": "meta", "schema_version": obs.SCHEMA_VERSION,
             "step": step, "ts": now + skew_s, "pid": 4242}) + "\n")
        f.write(json.dumps(
            {"kind": "span", "name": "process", "id": 1, "parent": None,
             "ts": now + skew_s, "dur_s": 2.0,
             "attrs": {"rows": rows}}) + "\n")
    return d


def test_aggregate_reports_and_timelines_are_equal(tmp_path):
    from shifu_tpu.obs import monitor as jm
    from shifu_tpu.obs import report as jr
    from shifu_tpu.obs import timeline as jt
    from shifu_tpu_torch.obs import monitor as pm
    from shifu_tpu_torch.obs import report as pr
    from shifu_tpu_torch.obs import timeline as pt
    now = time.time()
    dirs = [_proc_dir(str(tmp_path), "w0", "train-0", 100, 0.0, now),
            _proc_dir(str(tmp_path), "w1", "train-1", 40, 300.0, now)]
    assert pr.render_telemetry_merged(dirs) == \
        jr.render_telemetry_merged(dirs)
    assert pm.dir_clock_offset(dirs[1]) == jm.dir_clock_offset(dirs[1])
    docs = []
    for mod, name in ((pt, "p.json"), (jt, "j.json")):
        out = mod.export_merged_timeline(dirs, str(tmp_path / name))
        with open(out) as f:
            docs.append(json.load(f))
    assert docs[0] == docs[1]
    assert pm.render_aggregate(dirs, now=now) == \
        jm.render_aggregate(dirs, now=now)


# ---------------------------------------------------------------- monitor
def _health(proc, ts, state="running", **kw):
    rec = {"proc": proc, "step": "TRAIN", "state": state, "ts": ts,
           "last_progress_ts": ts, "interval_s": 0.5, "rows": 10}
    rec.update(kw)
    return rec


def test_monitor_json_documents_and_exit_codes_match(tmp_path):
    from shifu_tpu.obs import monitor as jm
    from shifu_tpu_torch.obs import monitor as pm
    from shifu_tpu_torch.obs.health import health_dir_for
    hd = health_dir_for(str(tmp_path))
    os.makedirs(hd)
    now = time.time()
    with open(os.path.join(hd, "a.json"), "w") as f:
        json.dump(_health("train-1", now), f)
    with open(os.path.join(hd, "b.json"), "w") as f:
        json.dump(_health("train-2", now, state="exited", exit_code=0), f)
    for stale in (False, True):
        if stale:
            with open(os.path.join(hd, "a.json"), "w") as f:
                json.dump(_health("train-1", now - 60), f)
        got = pm.status_json(str(tmp_path), now=now)
        want = jm.status_json(str(tmp_path), now=now)
        assert got == want
        assert got[1] == (pm.EXIT_UNHEALTHY if stale else 0)
        assert pm.render_status(str(tmp_path), now=now) == \
            jm.render_status(str(tmp_path), now=now)
    printed = []
    rc = pm.run_monitor(str(tmp_path), once=True, json_mode=True,
                        _print=printed.append)
    assert rc == 3 and json.loads(printed[0])["kind"] == "monitor"
    assert pm.status_json(str(tmp_path / "none")) == \
        jm.status_json(str(tmp_path / "none"))


def test_monitor_and_analysis_cli_match(tmp_path, capsys):
    from shifu_tpu.cli import main as jmain
    from shifu_tpu_torch.cli import main
    now = time.time()
    dirs = [_proc_dir(str(tmp_path), "w0", "train-0", 100, 0.0, now),
            _proc_dir(str(tmp_path), "w1", "train-1", 40, 300.0, now)]
    outs = []
    for run in (main, jmain):
        codes = []
        text = []
        for argv in (["--dir", dirs[0], "monitor", "--once", "--json"],
                     ["monitor", "--once", "--json", "--aggregate", *dirs],
                     ["analysis", "--telemetry", "--aggregate", *dirs],
                     ["--dir", str(tmp_path / "empty"), "monitor", "--once",
                      "--json"]):
            capsys.readouterr()
            codes.append(run(argv))
            out = capsys.readouterr().out
            if "--json" in argv:            # drop the reading's clock
                doc = json.loads(out)
                doc.pop("ts", None)
                for p in doc.get("procs", []) + doc.get("step_lag", []):
                    p.pop("age_s", None)
                    p.pop("progress_age_s", None)
                out = json.dumps(doc, sort_keys=True)
            text.append(out)
        outs.append((codes, text))
    assert outs[0] == outs[1]


# ------------------------------------------------------------- profiler
def test_profile_writes_a_chrome_trace_naming_the_step_ops(prepared_set,
                                                           tmp_path):
    """``--profile DIR`` wraps the step in ``torch.profiler``: a Chrome
    trace under ``DIR/<step>`` that names the step's ops; off, nothing is
    written (``tests/test_ops_hardening.py``'s device-trace oracle)."""
    from shifu_tpu_torch.cli import main
    prof = str(tmp_path / "prof")
    assert main(["--dir", prepared_set, "stats", "--device", "cpu",
                 "--profile", prof]) == 0
    path = os.path.join(prof, "stats", "trace.json")
    with open(path) as f:
        doc = json.load(f)
    names = {e.get("name") for e in doc.get("traceEvents", [])}
    assert any(str(n).startswith("aten::") for n in names)
    environment.reset_for_tests()
    assert main(["--dir", prepared_set, "stats", "--device", "cpu"]) == 0
    assert os.listdir(prof) == ["stats"]


def test_telemetry_off_starts_no_thread_and_writes_no_trace(prepared_set):
    import threading
    from shifu_tpu_torch.pipeline.norm import NormalizeProcessor
    before = {t.name for t in threading.enumerate()}
    assert NormalizeProcessor(prepared_set).run() == 0
    assert not os.path.exists(os.path.join(prepared_set, "telemetry",
                                           "trace.jsonl"))
    assert not os.path.exists(os.path.join(prepared_set, "telemetry",
                                           "drift.json"))
    after = {t.name for t in threading.enumerate()}
    assert not {n for n in after - before if "heartbeat" in n.lower()
                or "export" in n.lower()}


# ------------------------------------------------------ streamed ingest
STREAM_WINDOW = 1000


def test_streamed_gbt_records_the_ingest_stall_and_tail_repairs(
        prepared_set, tmp_path, monkeypatch):
    """A streamed GBT with a disk tail, coarse-to-fine, telemetry on, in
    both packages: the TRAIN block records ``ingest.h2d_wait_seconds``,
    the ``ingest.window_prep`` spans (the port's prefetch thread also
    waits under ``ingest.h2d_wait``) and the reference's
    ``train.tail_repairs`` and ``train.tail_repair_levels``."""
    from shifu_tpu.pipeline.train import TrainProcessor as JT
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.pipeline.train import TrainProcessor
    monkeypatch.setenv("SHIFU_TREE_TAIL_C2F", "1")
    with open(os.path.join(prepared_set, "tmp", "CleanedData",
                           "schema.json")) as f:
        n_cols = len(json.load(f)["columnNums"])
    # one prepared window resident in both packages (the port's int32
    # bins of the >256-bin column are twice the reference's uint16), the
    # other three on the disk tail, so coarse-to-fine speculates
    props = {"shifu.train.streaming": "on",
             "shifu.train.windowRows": str(STREAM_WINDOW),
             "shifu.train.deviceCacheBytes":
                 str(STREAM_WINDOW * (4 * n_cols + 12) + 64)}
    dirs = {}
    for pkg in ("ref", "port"):
        dirs[pkg] = str(tmp_path / pkg)
        shutil.copytree(prepared_set, dirs[pkg])
        path = os.path.join(dirs[pkg], "ModelConfig.json")
        mc = ModelConfig.load(path)
        mc.train.algorithm = "GBT"
        mc.train.params = {"TreeNum": 4, "MaxDepth": 3, "Loss": "log"}
        mc.save(path)
    for pkg, env, o in (("ref", jenv, jobs), ("port", environment, obs)):
        _reset()
        for k, v in props.items():
            env.set_property(k, v)
        o.set_enabled(True)
        if pkg == "ref":
            assert JT(dirs[pkg], params={}).run() == 0
        else:
            assert TrainProcessor(dirs[pkg], params={},
                                  device="cpu").run() == 0
    _reset()
    ref = _blocks(_trace(dirs["ref"]))["TRAIN"]
    port = _blocks(_trace(dirs["port"]))["TRAIN"]
    for block in (ref, port):
        assert ("ingest.window_prep", None) in block["spans"]
        assert block["metrics"]["ingest.h2d_wait_seconds"] >= 0
    assert ("ingest.h2d_wait", None) in port["spans"]
    for name in ("train.tail_repairs", "train.tail_repair_levels",
                 "train.tail_sweeps", "ingest.disk_passes"):
        assert port["metrics"].get(name) == ref["metrics"].get(name), name
    assert port["metrics"]["train.tail_repairs"] > 0
