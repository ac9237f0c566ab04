"""Port parity for the serving plane's observability (``shifu_tpu_torch.obs``
and ``shifu_tpu_torch.faults``) against ``shifu_tpu.obs`` / ``shifu_tpu.faults``
on the same numpy-seeded streams.

Both packages run the same numpy arithmetic on the same inputs, so every
comparison here is exact: SLO quantiles, burn rates and alerts, the
brownout mode sequence, score-log segments (read across packages, byte for
byte), the outcome join, the quality summary, the posttrain snapshot, the
OpenMetrics exposition, heartbeat classification and the flushed trace.
Clocks are injected; nothing sleeps.
"""

import json
import os
import time

import numpy as np
import pytest

from shifu_tpu import faults as j_faults
from shifu_tpu import obs as j_obs
from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch import faults
from shifu_tpu_torch import obs
from shifu_tpu_torch.config import environment

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _clean():
    for env, o, f in ((environment, obs, faults),
                      (j_environment, j_obs, j_faults)):
        env.reset_for_tests()
        o.reset_for_tests()
        f.reset_for_tests()
    yield
    for env, o, f in ((environment, obs, faults),
                      (j_environment, j_obs, j_faults)):
        env.reset_for_tests()
        o.reset_for_tests()
        o.set_enabled(False)
        f.reset_for_tests()


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


# ------------------------------------------------------------------ SLO
def _slo_stream(seed):
    """[(dt, kind, payload)]: latency batches, error counts and sheds."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(120):
        roll = rng.random()
        dt = float(rng.uniform(0.0, 3.0))
        if roll < 0.7:
            lat = rng.lognormal(np.log(0.004), 0.9,
                                size=int(rng.integers(1, 40)))
            out.append((dt, "ok", lat))
        elif roll < 0.9:
            out.append((dt, "err", int(rng.integers(1, 5))))
        else:
            out.append((dt, "shed", int(rng.integers(1, 3))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_tracker_summaries_match_reference(seed):
    """Quantiles, availability, burn rates, alerts and both summaries are
    equal at every injected ``now`` (exact: same bins, same numpy)."""
    clk, jclk = Clock(), Clock()
    kw = dict(p99_ms=8.0, availability=0.99, window_s=5.0, n_windows=6)
    t = obs.SLOTracker(clock=clk, **kw)
    jt = j_obs.SLOTracker(clock=jclk, **kw)
    for i, (dt, kind, payload) in enumerate(_slo_stream(seed)):
        clk.t += dt
        jclk.t += dt
        for tr in (t, jt):
            if kind == "ok":
                tr.observe_batch(payload)
            elif kind == "err":
                tr.record_errors(payload)
            else:
                tr.record_shed(payload)
        if i % 10 == 9:
            assert t.summary() == jt.summary()
            assert t.compact() == jt.compact()
            assert t.alerts() == jt.alerts()
            for q in (0.5, 0.9, 0.99):
                assert t.quantile_ms(q) == jt.quantile_ms(q)
    assert t.shed_total == jt.shed_total > 0


def test_slo_objectives_and_gauges_match_reference():
    environment.set_property("shifu.serve.sloP99Ms", "12.5")
    j_environment.set_property("shifu.serve.sloP99Ms", "12.5")
    assert obs.slo_objectives(2.0) == j_obs.slo_objectives(2.0)
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    assert obs.slo_objectives(3.0) == j_obs.slo_objectives(3.0) \
        == (6.0, 0.999)
    obs.set_enabled(True)
    j_obs.set_enabled(True)
    lat = np.random.default_rng(3).lognormal(-5.0, 1.0, 500)
    trackers = [obs.SLOTracker(p99_ms=5.0, clock=Clock()),
                j_obs.SLOTracker(p99_ms=5.0, clock=Clock())]
    for tr in trackers:
        tr.observe_batch(lat)
        tr.record_errors(3)
        tr.emit_gauges()
    assert obs.snapshot() == j_obs.snapshot()


def test_brownout_governor_mode_sequence_matches_reference():
    rng = np.random.default_rng(4)
    g, jg = obs.BrownoutGovernor(), j_obs.BrownoutGovernor()
    seq, jseq = [], []
    for stressed in rng.random(300) < 0.45:
        seq.append((g.check(bool(stressed)), g.mode))
        jseq.append((jg.check(bool(stressed)), jg.mode))
    assert seq == jseq
    assert g.entries == jg.entries > 0


# ------------------------------------------------------------- scorelog
def _fill_scorelog(mod, root, rate, close=True):
    """Seeded records through a ScoreLog of ``mod`` with tiny segments and
    a budget that prunes; ``close=False`` leaves a torn ``.open`` tail."""
    rng = np.random.default_rng(5)
    sl = mod.ScoreLog(root, sample_rate=rate, segment_bytes=160,
                      budget_bytes=900, gen_fn=lambda: 3, clock=Clock(50.0))
    got = []
    for i in range(60):
        scores = rng.uniform(0, 1000, size=int(rng.integers(1, 4)))
        bins = rng.integers(0, 9, size=(len(scores), 3)) if i % 3 else None
        got.append(sl.log(f"q{i:03d}", scores.astype(np.float32),
                          bins=bins, ts=10.0 + i))
    if close:
        sl.close()
    else:                                # one record left in a torn tail
        sl.sample_rate = 1.0
        got.append(sl.log("tail", [1.0], ts=99.0))
    return got, sl.stats


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("rate", [1.0, 0.5])
def test_scorelog_segments_read_both_ways(tmp_path, writer, rate):
    """Segments one package writes are byte-equal to the other's and read
    record for record by both readers — rotation, budget pruning and the
    head sampler included; a torn ``.open`` tail is skipped by name."""
    from shifu_tpu.obs.scorelog import ScoreLog as JScoreLog
    from shifu_tpu_torch.obs.scorelog import ScoreLog
    mods = {"port": obs, "reference": j_obs}
    other = "reference" if writer == "port" else "port"
    a, b = str(tmp_path / writer), str(tmp_path / other)
    got_a, stats_a = _fill_scorelog(mods[writer], a, rate, close=False)
    got_b, stats_b = _fill_scorelog(mods[other], b, rate, close=False)
    assert got_a == got_b and stats_a == stats_b
    assert stats_a["pruned"] > 0 and stats_a["segments"] > 2
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert names[-1].endswith(".jsonl.open")
    for n in names:
        assert open(os.path.join(a, n), "rb").read() == \
            open(os.path.join(b, n), "rb").read()
    for reader in (obs.read_score_records, j_obs.read_score_records):
        skipped, j_skipped = [], []
        recs = reader(a, skipped=skipped)
        assert recs == j_obs.read_score_records(b, skipped=j_skipped)
        assert skipped == j_skipped == [names[-1]]
        assert recs and all(r["gen"] == 3 for r in recs)
    # the next writer of either package sweeps the torn tail, continues
    sl = (ScoreLog if writer == "reference" else JScoreLog)(
        a, sample_rate=1.0)
    assert sl.recovered == 1
    sl.log("next", [1.0], gen=4, ts=99.0)
    sl.close()
    assert j_obs.read_score_records(a)[-1]["req"] == "next"
    assert obs.read_score_records(a)[-1]["req"] == "next"


# ------------------------------------------------------------- outcomes
def _drive_joiner(mod, drop_dir):
    clk = Clock(0.0)
    joined = []
    j = mod.OutcomeJoiner(watermark_s=30.0, clock=clk,
                          on_join=lambda g, s, lab: joined.append(
                              (g, s.tolist(), lab.tolist())))
    rng = np.random.default_rng(6)
    results = []
    for i in range(80):
        clk.t += float(rng.uniform(0, 2))
        req = f"r{int(rng.integers(0, 40))}"
        if rng.random() < 0.55:
            j.record_prediction(req, rng.uniform(0, 1000, 2), gen=i // 30)
        else:
            lab = (rng.random(2) < 0.5).astype(float)
            if rng.random() < 0.2:
                lab = float(lab[0])              # scalar broadcast
            elif rng.random() < 0.1:
                lab = [1.0, 0.0, 1.0]            # length mismatch
            got = j.add_outcome(req, lab)
            results.append(None if got is None else
                           (got[0], got[1].tolist(), got[2].tolist()))
    os.makedirs(drop_dir)
    with open(os.path.join(drop_dir, "feed.jsonl"), "w") as f:
        f.write(json.dumps({"req": "r1", "label": 1}) + "\n")
        f.write('{"req": "torn\n')
        f.write(json.dumps({"outcomes": [{"req": "r2", "labels": [0, 1]}]})
                + "\n")
    n = j.ingest_drop_dir(drop_dir)
    return results, joined, dict(j.stats), j.pending, n


def test_outcome_joiner_matches_reference(tmp_path):
    got = _drive_joiner(obs, str(tmp_path / "port"))
    want = _drive_joiner(j_obs, str(tmp_path / "ref"))
    assert got == want
    stats = got[2]
    assert stats["joined_rows"] > 0 and stats["late"] > 0
    assert stats["evicted"] > 0 and stats["malformed"] > 0
    assert os.listdir(tmp_path / "port") == []


# -------------------------------------------------------------- quality
def test_posttrain_snapshot_is_byte_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    rng = np.random.default_rng(7)
    scores = rng.uniform(0, 1000, 777)
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    doc = obs.write_posttrain_snapshot(a, scores, auc=0.8123456789)
    jdoc = j_obs.write_posttrain_snapshot(b, scores, auc=0.8123456789)
    assert doc == jdoc
    assert open(a, "rb").read() == open(b, "rb").read()
    d = tmp_path / "set"
    os.makedirs(d / "telemetry")
    os.replace(a, obs.posttrain_snapshot_path(str(d)))
    assert j_obs.load_posttrain_snapshot(str(d)) == doc
    assert obs.load_posttrain_snapshot(str(d)) == doc


@pytest.mark.parametrize("flip", [False, True])
def test_quality_monitor_summary_matches_reference(tmp_path, monkeypatch,
                                                   flip):
    """Per-generation live AUC, ECE and score-PSI (and the degraded
    reasons) are equal for the same generations, scores, labels and
    snapshot; flipped labels in generation 1 degrade both alike."""
    monkeypatch.setattr(time, "time", lambda: 1700000000.0)
    rng = np.random.default_rng(8)
    base = rng.uniform(0, 1000, 600)
    snap = obs.write_posttrain_snapshot(str(tmp_path / "p.json"), base,
                                        auc=0.93)
    mons = [obs.QualityMonitor(snapshot=snap, min_joined=32),
            j_obs.QualityMonitor(snapshot=snap, min_joined=32)]
    for gen in (0, 1):
        for _ in range(12):
            lab = (rng.random(40) < 0.3).astype(np.float32)
            s = np.clip(lab * 600 + rng.normal(300, 150, 40), 0, 1000)
            if flip and gen == 1:
                lab = 1.0 - lab
            for m in mons:
                m.observe_scores(gen, s)
                m.update(gen, s, lab)
    summ, jsumm = mons[0].summary(), mons[1].summary()
    assert summ == jsumm
    assert mons[0].compact() == mons[1].compact()
    assert summ["current_gen"] == 1 and summ["live_auc"] is not None
    assert ("live-auc" in summ["reasons"]) == flip
    path = str(tmp_path / "quality.json")
    assert mons[0].emit(path=path) == summ
    assert json.load(open(path)) == jsumm


def test_quality_knobs_and_psi_threshold_match_reference():
    for env in (environment, j_environment):
        env.set_property("shifu.drift.psiThreshold", "0.3")
        env.set_property("shifu.quality.minJoined", "17")
    from shifu_tpu.obs.quality import quality_min_joined as j_min
    from shifu_tpu.obs.quality import quality_psi_threshold as j_psi
    from shifu_tpu_torch.obs.quality import (quality_min_joined,
                                             quality_psi_threshold)
    assert quality_psi_threshold() == j_psi() == 0.3
    assert quality_min_joined() == j_min() == 17
    for env in (environment, j_environment):
        env.reset_for_tests()
    assert obs.psi_threshold() == j_obs.psi_threshold()
    assert obs.start_quality_monitor(sample_rate=0.0) is None


# ------------------------------------------------- registry / exporter
def _instrument(mod):
    rng = np.random.default_rng(9)
    mod.counter("serve.requests").inc(7)
    mod.counter("serve.rows_scored").inc(1234)
    mod.gauge("serve.queue_depth").set(17)
    mod.gauge("device.peak_bytes_in_use").set_max(3.5e9)
    h = mod.histogram("serve.batch_latency_ms")
    for v in rng.lognormal(0.5, 1.0, 300):
        h.observe(v)
    mod.histogram("serve.bucket_occupancy").observe(0.25)


def test_registry_snapshot_and_openmetrics_are_byte_equal(tmp_path):
    obs.set_enabled(True)
    j_obs.set_enabled(True)
    _instrument(obs)
    _instrument(j_obs)
    recs, jrecs = obs.snapshot(), j_obs.snapshot()
    assert recs == jrecs and len(recs) == 6
    text = obs.render_openmetrics()
    assert text == j_obs.render_openmetrics()
    assert text == obs.render_openmetrics(jrecs)
    assert 'shifu_tpu_serve_batch_latency_ms{quantile="0.99"}' in text
    obs.write_metrics_files(str(tmp_path), step="SERVE")
    assert open(tmp_path / "metrics.prom").read() == text
    doc = json.load(open(tmp_path / "metrics.json"))
    assert doc["metrics"] == jrecs and doc["schema_version"] == 14
    assert obs.metric_name("serve.rows_scored") == \
        j_obs.metric_name("serve.rows_scored")


def test_exporter_writes_on_start_and_stop(tmp_path):
    obs.set_enabled(True)
    exp = obs.start_exporter(str(tmp_path), step="SERVE", interval_s=60)
    try:
        assert os.path.isfile(tmp_path / "metrics.prom")
        obs.counter("serve.batches").inc(3)
    finally:
        exp.stop()
    assert "shifu_tpu_serve_batches_total 3" in \
        open(tmp_path / "metrics.prom").read()


def test_disabled_plane_allocates_nothing(tmp_path):
    """Telemetry off (the default): a shared null span, no-op
    instruments, no heartbeat/exporter threads and no files."""
    assert not obs.enabled()
    sp = obs.span("serve.batch", rows=1)
    assert sp is obs.span("other")
    with sp as s:
        assert s.set(x=1) is s and s.fence(3) == 3
    assert obs.counter("serve.batches") is obs.gauge("serve.mode")
    assert obs.record_span("serve.batch", 0.0, 0.1) is None
    assert obs.start_heartbeat(str(tmp_path / "h")) is None
    assert obs.start_exporter(str(tmp_path / "t")) is None
    assert obs.flush(str(tmp_path / "trace.jsonl")) is False
    assert os.listdir(tmp_path) == []


def test_enable_tristate_matches_reference(monkeypatch):
    for value, want in (("1", True), ("off", False)):
        monkeypatch.setenv("SHIFU_TPU_TELEMETRY", value)
        obs.set_enabled(None)
        j_obs.set_enabled(None)
        assert obs.enabled() == j_obs.enabled() == want
    monkeypatch.delenv("SHIFU_TPU_TELEMETRY")
    environment.set_property("shifu.telemetry", "on")
    obs.set_enabled(None)
    assert obs.enabled()
    obs.set_enabled(False)
    assert not obs.enabled()


# --------------------------------------------------------------- health
def test_reference_reads_and_classifies_port_serve_heartbeat(tmp_path):
    """A SERVE heartbeat the port writes (with the serve extras) is read
    by the reference's ``read_health`` and classified to the same state
    as the port's ``classify`` — live, then exited after ``stop``."""
    obs.set_enabled(True)
    hdir = obs.health_dir_for(str(tmp_path))
    extras = {"queue_depth": 3, "queue_buildup": False, "mode": "normal",
              "slo": {"p99_ms": 1.5, "alerting": False},
              "quality": {"degraded": False, "live_auc": 0.9}}
    hb = obs.HeartbeatWriter(hdir, step="SERVE", proc="serve-demo",
                             interval_s=60, extras_fn=lambda: extras)
    hb.start()
    try:
        obs.counter("serve.batches").inc()
        hb.beat()
        recs, jrecs = obs.read_health(hdir), j_obs.read_health(hdir)
        assert recs == jrecs and len(recs) == 1
        rec = jrecs[0]
        assert rec["step"] == "SERVE" and rec["proc"] == "serve-demo"
        assert rec["schema_version"] == j_obs.SCHEMA_VERSION
        for k, v in extras.items():
            assert rec[k] == v
        now = rec["ts"] + 1.0
        assert obs.classify(rec, now=now) == j_obs.classify(rec, now=now) \
            == "live"
        late = rec["ts"] + 1000.0
        assert obs.classify(rec, now=late) == \
            j_obs.classify(rec, now=late) == "stale"
    finally:
        hb.stop(exit_code=0)
    rec = j_obs.read_health(hdir)[0]
    assert j_obs.classify(rec) == obs.classify(rec) == "exited"
    assert rec["exit_code"] == 0


def test_heartbeat_interval_knob_matches_reference(monkeypatch):
    assert obs.heartbeat_interval_s() == j_obs.heartbeat_interval_s() == 5.0
    monkeypatch.setenv("SHIFU_TPU_HEARTBEAT_S", "0.25")
    assert obs.heartbeat_interval_s() == j_obs.heartbeat_interval_s() == 0.25
    assert obs.heartbeat_interval_s(0.01) == 0.05


# ---------------------------------------------------------------- trace
def test_reference_load_blocks_reads_port_trace(tmp_path):
    """A trace the port flushed (spans, a cross-thread ``record_span``,
    an event, metrics) loads through the reference's ``load_blocks`` with
    the same span names, nesting and schema version."""
    from shifu_tpu.obs.report import load_blocks
    obs.set_enabled(True)
    with obs.span("serve.swap", key="k") as outer:
        with obs.span("serve.prepare") as inner:
            inner.fence(np.zeros(3))
        obs.event("serve.note", beat=1)
    obs.record_span("serve.request", ts=time.time(), dur_s=0.002,
                    tid="shifu-serve", attrs={"rows": 4})
    obs.counter("serve.batches").inc(2)
    path = str(tmp_path / "telemetry" / "trace.jsonl")
    assert obs.flush(path, step="SERVE") is True
    assert obs.pending_records() == []
    skipped = []
    blocks = load_blocks(path, skipped=skipped)
    assert skipped == [] and len(blocks) == 1
    blk = blocks[0]
    assert blk["meta"]["schema_version"] == j_obs.SCHEMA_VERSION
    assert blk["meta"]["step"] == "SERVE"
    names = sorted(s["name"] for s in blk["spans"])
    assert names == ["serve.prepare", "serve.request", "serve.swap"]
    by = {s["name"]: s for s in blk["spans"]}
    assert by["serve.prepare"]["parent"] == by["serve.swap"]["id"] \
        == outer.id
    assert by["serve.request"]["tid"] == "shifu-serve"
    assert [e["name"] for e in blk["events"]] == ["serve.note"]
    assert [m["name"] for m in blk["metrics"]] == ["serve.batches"]


def test_fence_synchronises_only_cuda_tensors(monkeypatch):
    import torch
    obs.set_enabled(True)
    environment.set_property("shifu.telemetry.fence", "on")
    obs.set_enabled(True)
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: calls.append(d))
    x = torch.zeros(2)
    assert obs.fence([x, x]) is not None and obs.fence(3) == 3
    assert calls == []


# --------------------------------------------------------------- faults
def test_fault_spec_parses_and_fires_like_reference(monkeypatch):
    spec = "serve:request=2:ioerror@2,obs:heartbeat=0:kill,serve:swap=k:ioerror"
    assert faults.parse_spec(spec) == j_faults.parse_spec(spec)
    for bad in ("serve:request", "serve:request=1:explode"):
        with pytest.raises(ValueError):
            faults.parse_spec(bad)
        with pytest.raises(ValueError):
            j_faults.parse_spec(bad)
    assert faults.SITES == j_faults.SITES
    monkeypatch.setenv("SHIFU_TPU_FAULTS", "serve:request=2:ioerror@2")
    faults.reset_for_tests()
    assert faults.active()
    faults.fire("serve", "request", 1)
    for _ in range(2):
        with pytest.raises(faults.InjectedFault, match="serve:request=2"):
            faults.fire("serve", "request", 2)
    faults.fire("serve", "request", 2)           # disarmed after @2
