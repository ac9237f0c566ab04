"""Port parity for the serving plane (``shifu_tpu_torch.serve``: overload,
batcher, scorer capture contract, server) against ``shifu_tpu.serve``.

The state machines (ladder refinement, retry budget, circuit breaker,
admission and deadline shedding) run the same arithmetic in both packages
on the same seeded event streams and injected clocks, so they are held
equal exactly.  Served scores are f32 tree sums / GEMMs taken in another
order by each package: they agree within 1e-3 on the 0–1000 scale
(``TOL``).  The slice as a whole is one HTTP script run against the
reference's ``ServeServer`` and the port's (``device="cpu"``) on the same
GBT and NN model sets at ``-Dshifu.scorelog.sampleRate=1.0``: equal status
and error codes, scores within ``TOL``, equal joined counts and live AUC
(within 1e-6: both rank the same scores, tied leaf paths tie in both).
"""

import json
import os
import shutil
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from shifu_tpu import faults as j_faults
from shifu_tpu import obs as j_obs
from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch import faults, obs
from shifu_tpu_torch.config import environment

pytestmark = pytest.mark.torch_port

TOL = 1e-3          # 0-1000 scale: f32 sums/GEMMs in another order


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("SHIFU_TPU_HEARTBEAT_S", "3600")   # beats by hand
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


def _both_props(**props):
    for env in (environment, j_environment):
        for k, v in props.items():
            env.set_property(k, str(v))


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


# ------------------------------------------------------ ladder refinement
@pytest.mark.parametrize("seed", range(4))
def test_refine_ladder_matches_reference(seed):
    from shifu_tpu.serve.scorer import refine_ladder as j_refine
    from shifu_tpu_torch.serve import refine_ladder
    rng = np.random.default_rng(seed)
    ladders = [(1, 8, 64, 512), (1, 4, 16), (2, 32, 256, 1024)]
    for _ in range(25):
        lad = ladders[int(rng.integers(0, len(ladders)))]
        sizes = rng.integers(1, lad[-1] + 1, size=int(rng.integers(1, 30)))
        counts = {int(s): int(rng.integers(1, 50)) for s in sizes}
        kw = dict(max_extra=int(rng.integers(1, 4)),
                  min_share=float(rng.uniform(0.05, 0.4)))
        assert refine_ladder(lad, counts, **kw) == \
            j_refine(lad, counts, **kw)
    assert refine_ladder((1, 8, 64), {}) == (1, 8, 64)


# --------------------------------------------------- overload primitives
def test_retry_budget_and_breaker_sequences_match_reference():
    from shifu_tpu.serve import overload as j_ov
    from shifu_tpu_torch.serve import overload as ov
    rng = np.random.default_rng(11)
    events = rng.integers(0, 3, size=400)
    budgets = (ov.RetryBudget(frac=0.3), j_ov.RetryBudget(frac=0.3))
    breakers = (ov.CircuitBreaker(threshold=3, cooldown_s=1.5),
                j_ov.CircuitBreaker(threshold=3, cooldown_s=1.5))
    seqs = ([], [])
    now = 0.0
    for e in events:
        now += float(rng.uniform(0.0, 0.6))
        for seq, bud, brk in zip(seqs, budgets, breakers):
            if e == 0:
                bud.on_success()
                if brk.allow(now):
                    brk.record_success()
                seq.append(("ok", bud.tokens, brk.state, brk.failures))
            elif e == 1:
                seq.append(("retry", bud.try_retry(), bud.tokens))
            else:
                allowed = brk.allow(now)
                opened = brk.record_failure(now) if allowed else None
                seq.append(("fail", allowed, opened, brk.state,
                            brk.opens))
    assert seqs[0] == seqs[1]
    assert breakers[0].opens == breakers[1].opens > 0
    assert ov.CircuitBreaker(threshold=0).allow(0.0)
    assert ov.RetryBudget(frac=0.0).try_retry() is False


def test_overload_knobs_match_reference():
    from shifu_tpu.serve import overload as j_ov
    from shifu_tpu.serve.batcher import configured_refine_every as j_rf
    from shifu_tpu.serve.batcher import \
        configured_trace_sample_rate as j_tr
    from shifu_tpu_torch.serve import overload as ov
    from shifu_tpu_torch.serve.batcher import (configured_refine_every,
                                               configured_trace_sample_rate)
    names = ("configured_max_queue_rows", "configured_deadline_s",
             "configured_retry_budget_frac", "configured_hedge_s",
             "configured_breaker_failures", "configured_brownout_enabled")
    defaults = [getattr(ov, n)() for n in names]
    assert defaults == [getattr(j_ov, n)() for n in names]
    assert defaults == [0, 0.0, 0.1, 0.0, 3, True]
    _both_props(**{"shifu.serve.maxQueueRows": 40,
                   "shifu.serve.requestDeadlineMs": 7.5,
                   "shifu.serve.retryBudgetFrac": 0.25,
                   "shifu.serve.hedgeMs": 3,
                   "shifu.serve.breakerFailures": 5,
                   "shifu.serve.brownout": "false",
                   "shifu.serve.traceSampleRate": 1.5,
                   "shifu.serve.bucketRefineEvery": 9})
    assert [getattr(ov, n)() for n in names] == \
        [getattr(j_ov, n)() for n in names]
    assert configured_trace_sample_rate() == j_tr() == 1.0
    assert configured_refine_every() == j_rf() == 9
    e = ov.OverloadedError("x", retry_after_s=0.0)
    assert (e.code, e.retry_after_s) == ("overloaded", 0.001)
    assert ov.DeadlineExceededError.code == "deadline_exceeded"


# -------------------------------------------------------------- batcher
class _Stub:
    """A scorer both batchers can drive (deterministic host arithmetic)."""
    buckets = (1, 4, 16)
    needs_bins = False
    accepts_raw = False

    def score_batch(self, x, bins=None):
        return np.stack([x.sum(axis=1), x.mean(axis=1)], axis=1)


def _drive_batcher(pkg_batcher, slo_cls):
    clk = Clock()
    stub = _Stub()
    slo = slo_cls(p99_ms=4.0, clock=clk, window_s=1.0, n_windows=5)
    b = pkg_batcher.MicroBatcher(lambda: stub, max_delay_s=0.002,
                                 clock=clk, trace_sample_rate=0.0, slo=slo)
    rng = np.random.default_rng(12)
    out, tickets = [], []
    for i in range(200):
        clk.t += float(rng.uniform(0.0, 0.003))
        roll = rng.random()
        if roll < 0.6:
            n = int(rng.integers(1, 12))
            x = rng.normal(size=(n, 3)).astype(np.float32)
            dl = float(rng.uniform(0.5, 6.0)) if rng.random() < 0.3 \
                else None
            try:
                t = b.submit_burst(x, deadline_ms=dl)
                tickets.append(t)
                if rng.random() < 0.08:
                    t.cancel()
                out.append(("ok", n, b.queue_depth))
            except Exception as e:          # noqa: BLE001 — coded shed
                out.append((type(e).__name__, getattr(e, "code", None),
                            round(e.retry_after_s, 9)))
        else:
            out.append(("pump", b.pump()))
    while b.queue_depth:
        clk.t += 0.01
        out.append(("pump", b.pump()))
    for t in tickets:
        assert t.done()
        out.append((None if t.error is None else t.error.code,
                    None if t.error is not None else
                    t.scores.round(5).tolist(),
                    t.latencies().round(9).tolist()))
    return (out, dict(b.stats), dict(b.bucket_counts),
            dict(b.size_counts), slo.summary())


def test_batcher_admission_deadlines_and_cancels_match_reference():
    """The same submit/pump/cancel script under the same fake clock: the
    same 429s (and Retry-After), the same deadline and cancel sheds
    before launch, the same flushes, per-row latencies and SLO feed."""
    from shifu_tpu.serve import batcher as j_batcher
    from shifu_tpu_torch.serve import batcher
    _both_props(**{"shifu.serve.maxQueueRows": 20,
                   "shifu.serve.requestDeadlineMs": 4})
    got = _drive_batcher(batcher, obs.SLOTracker)
    want = _drive_batcher(j_batcher, j_obs.SLOTracker)
    assert got == want
    stats = got[1]
    assert stats["shed_overload"] > 0 and stats["shed_expired"] > 0
    assert stats["cancelled"] > 0 and stats["batches"] > 0
    assert got[4]["shed"] == stats["shed_overload"] + \
        stats["shed_expired"] + stats["cancelled"]


def test_serve_request_and_admit_faults_keep_batcher_serviceable():
    """``serve:request=k`` fails exactly batch k's tickets; the next batch
    scores.  ``serve:admit=1`` surfaces instead of the coded rejection
    and leaves the queue depth and shed accounting as recorded."""
    from shifu_tpu_torch.serve.batcher import MicroBatcher
    environment.set_property("shifu.faults",
                             "serve:request=1:ioerror,serve:admit=1:ioerror")
    environment.set_property("shifu.serve.maxQueueRows", 4)
    faults.reset_for_tests()
    clk = Clock()
    slo = obs.SLOTracker(p99_ms=4.0, clock=clk)
    b = MicroBatcher(lambda: _Stub(), clock=clk, slo=slo)
    x = np.ones((2, 3), np.float32)
    t0 = b.submit_burst(x)
    b.pump(force=True)
    t1 = b.submit_burst(x)
    b.pump(force=True)
    assert t0.wait(1).tolist() == [2.0, 2.0]     # mean of (sum, mean)
    with pytest.raises(faults.InjectedFault):
        t1.wait(1)
    b.submit_burst(np.ones((4, 3), np.float32))
    with pytest.raises(faults.InjectedFault):
        b.submit_burst(x)                   # shed #1: the drill fires
    assert b.queue_depth == 4 and b.stats["shed_overload"] == 1
    assert slo.shed_total == 1 and b.stats["errors"] == 1
    b.pump(force=True)
    assert b.submit_burst(x).n == 2


def test_scorelog_rotation_fault_counts_a_write_error(tmp_path):
    """``obs:scorelog=0`` (ioerror) at the first rotation commit: the
    append path counts a write error, as the reference's does."""
    for env, o in ((environment, obs), (j_environment, j_obs)):
        env.set_property("shifu.faults", "obs:scorelog=0:ioerror")
    faults.reset_for_tests()
    j_faults.reset_for_tests()
    stats = []
    for o in (obs, j_obs):
        sl = o.ScoreLog(str(tmp_path / o.__name__), sample_rate=1.0,
                        segment_bytes=10)
        sl.log("a", [1.0], gen=0, ts=1.0)
        sl.log("b", [2.0], gen=0, ts=2.0)
        sl.close()
        stats.append(dict(sl.stats))
    assert stats[0] == stats[1] and stats[0]["write_errors"] == 1


# ------------------------------------------------------------ model sets
def _train(tmp_path_factory, template, name, algorithm, params, **train):
    from shifu_tpu.config import ModelConfig
    from shifu_tpu.config.model_config import Algorithm
    from shifu_tpu.pipeline.train import TrainProcessor
    d = str(tmp_path_factory.mktemp("serve_plane") / name)
    shutil.copytree(template, d)
    mc_path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(mc_path)
    mc.train.algorithm = getattr(Algorithm, algorithm)
    mc.train.params = params
    for k, v in train.items():
        setattr(mc.train, k, v)
    mc.save(mc_path)
    assert TrainProcessor(d, params={}).run() == 0
    return d


@pytest.fixture(scope="module")
def sets(tmp_path_factory, _prepared_template):
    """Model sets trained once by the reference (read-only templates):
    two GBTs (5 and 3 trees) and a two-bag NN."""
    t = _prepared_template
    return {
        "gbt": _train(tmp_path_factory, t, "gbt", "GBT",
                      {"TreeNum": 5, "MaxDepth": 4, "Loss": "log",
                       "LearningRate": 0.1}),
        "gbt3": _train(tmp_path_factory, t, "gbt3", "GBT",
                       {"TreeNum": 3, "MaxDepth": 3, "Loss": "log",
                        "LearningRate": 0.2}),
        "nn": _train(tmp_path_factory, t, "nn", "NN",
                     {"NumHiddenNodes": [8], "ActivationFunc": ["tanh"],
                      "Propagation": "ADAM", "LearningRate": 0.01},
                     baggingNum=2, numTrainEpochs=2),
    }


def _records(d, n, seed):
    """(records, labels): raw records of the set's CSV with JSON-typed
    numbers and junk, one malformed record; labels from the tag."""
    import csv

    from shifu_tpu_torch.config import ModelConfig
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    with open(mc.dataSet.dataPath) as f:
        rows = list(csv.DictReader(f, delimiter="|"))
    rng = np.random.default_rng(seed)
    recs = [dict(rows[int(i)]) for i in rng.choice(len(rows), n,
                                                   replace=False)]
    labels = [1.0 if r["tag"] == "bad" else 0.0 for r in recs]
    for r in recs:
        if rng.random() < 0.2 and r.get("amount"):
            r["amount"] = float(r["amount"])
        elif rng.random() < 0.05:
            r["age_days"] = "n/a"
    return recs, labels


# ------------------------------------------------------ capture contract
def test_capture_contract_on_the_cpu(sets, tmp_path):
    """One build per rung and path at warm, none after requests of every
    size from 1 to 1500, none after ``extend_buckets`` (its rungs are
    built before they are published) and none after a committed swap."""
    from shifu_tpu_torch.serve import (ServeServer, covering_bucket,
                                       serve_capture_count)
    from shifu_tpu_torch.serve.transform import FusedTransform
    d = str(tmp_path / "set")
    shutil.copytree(sets["gbt"], d)
    srv = ServeServer(d, key="cap", buckets=(1, 8, 64), device="cpu",
                      dtype=torch.float64)
    sc = srv.registry.get("cap")
    assert sc.accepts_raw and sc.captures == 3 * 2
    assert serve_capture_count("serve.score.cap") == 0
    rng = np.random.default_rng(13)
    bins = rng.integers(0, 6, size=(1500, sc.n_bins_cols)).astype(np.int32)
    x = np.zeros((1500, sc.n_features), np.float32)
    whole = sc.score_batch(x, bins)
    for n in range(1, 1501):
        got = sc.score_batch(x[:n], bins[:n])
        assert got.shape == (n, 1)
        if n in (1, 7, 8, 9, 64, 333, 512, 1500):
            assert np.array_equal(got, whole[:n])
    recs, _ = _records(d, 150, 1)
    tf = FusedTransform.from_dir(d, dtype=torch.float64)
    packed, _, _ = tf.parse_records(recs)
    for n in (1, 5, 64, 65, 150):
        assert sc.score_batch_raw(packed[:n]).shape == (n, 1)
    assert sc.captures == 6 and serve_capture_count("serve.score.cap") == 0
    assert sc.extend_buckets([24, 8]) == 1 and sc.buckets == (1, 8, 24, 64)
    assert sc.captures == 8 and covering_bucket(sc.buckets, 20) == 24
    assert np.array_equal(sc.score_batch(x[:20], bins[:20]), whole[:20])
    srv.swap(os.path.join(sets["gbt3"], "models"))
    sc2 = srv.registry.get("cap")
    assert sc2 is not sc and sc2.name == "serve.score.cap.g1"
    assert set(sc.buckets) <= set(sc2.buckets)
    before = sc2.captures
    b2 = bins[:, :sc2.n_bins_cols]
    srv.score(x[:300], b2[:300])
    assert sc2.captures == before
    assert serve_capture_count() == 0
    assert sc2.eager_batch([x[:9], b2[:9]]).tolist() == \
        sc2.score_batch(x[:9], b2[:9]).tolist()


def test_batcher_refinement_extends_the_ladder_ahead_of_use(sets, tmp_path):
    from shifu_tpu.serve.scorer import refine_ladder as j_refine
    from shifu_tpu_torch.serve import ServeServer, serve_capture_count
    environment.set_property("shifu.serve.bucketRefineEvery", 6)
    srv = ServeServer(sets["gbt"], key="ref", buckets=(1, 64), device="cpu",
                      dtype=torch.float64, models=None)
    sc = srv.registry.get("ref")
    rng = np.random.default_rng(14)
    for _ in range(6):
        bins = rng.integers(0, 6, size=(10, sc.n_bins_cols))
        srv.score(np.zeros((10, sc.n_features), np.float32), bins)
    for t in threading.enumerate():         # the background capture
        if t.name == "shifu-torch-serve-ladder":
            t.join(timeout=60)
            assert not t.is_alive()
    assert sc.buckets == j_refine((1, 64), {10: 6}) == (1, 16, 64)
    assert serve_capture_count("serve.score.ref") == 0


def test_serve_replicas_raise_naming_the_router(sets, tmp_path, capsys):
    """The fleet router is ported: ``serve --replicas 2`` on a machine
    without CUDA raises naming the fleet, because its workers (``--device``
    defaults to ``cuda`` and is forwarded) exit before they announce; the
    worker flags ``--replica`` / ``--announce`` run a worker."""
    from shifu_tpu_torch.cli import main
    with pytest.raises(RuntimeError, match="fleet worker exited rc=1"):
        main(["--dir", sets["gbt"], "serve", "--replicas", "2",
              "--port", "0"])
    assert main(["--dir", sets["gbt"], "serve", "--device", "cpu",
                 "--replica", "w0", "--announce",
                 str(tmp_path / "w0.json"), "--selfcheck", "2"]) == 0
    assert json.loads(capsys.readouterr().out)["replica"] == "w0"


# ----------------------------------------------------- the slice, HTTP
class _Front:
    """A ServeServer behind the stdlib HTTP front-end on an ephemeral
    port."""

    def __init__(self, srv, make_handler):
        from http.server import ThreadingHTTPServer
        self.srv = srv
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def call(self, path, body=None, headers=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(self.url + path, data=data,
                                     headers={"Content-Type":
                                              "application/json",
                                              **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.load(r), dict(r.headers)
        except urllib.error.HTTPError as e:
            return e.code, json.load(e), dict(e.headers)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)
        self.srv.stop()


@pytest.fixture
def fronts(request):
    """Stops every front-end and server a test opens (no hung workers)."""
    opened = []
    yield opened
    for f in opened:
        f.close()


def _assert_scores(a, b):
    assert [s is None for s in a] == [s is None for s in b]
    x = np.asarray([s for s in a if s is not None], np.float64)
    y = np.asarray([s for s in b if s is not None], np.float64)
    assert x.shape == y.shape and np.max(np.abs(x - y)) <= TOL


@pytest.mark.parametrize("kind", ["gbt", "nn"])
def test_http_script_matches_reference_server(sets, tmp_path, fronts, kind):
    """One script against both servers: raw and pre-binned ``/score``, a
    429 burst over ``maxQueueRows``, a 504 under the deadline header,
    ``/outcome``, ``/quality``, ``/slo``, ``/healthz``, ``/swap``
    prepare/commit, a rollback, the SERVE heartbeat and the score log."""
    from shifu_tpu.serve.server import ServeServer as JServeServer
    from shifu_tpu.serve.server import _make_handler as j_handler
    from shifu_tpu.serve.transform import FusedTransform as JFusedTransform
    from shifu_tpu_torch.serve import serve_capture_count
    from shifu_tpu_torch.serve.server import ServeServer, _make_handler
    obs.set_enabled(True)
    j_obs.set_enabled(True)
    _both_props(**{"shifu.serve.maxQueueRows": 64,
                   "shifu.quality.minJoined": 16})
    dirs = {}
    for who in ("port", "ref"):
        dirs[who] = str(tmp_path / who)
        shutil.copytree(sets[kind], dirs[who])
        base = np.random.default_rng(15).uniform(0, 1000, 400)
        j_obs.write_posttrain_snapshot(
            j_obs.posttrain_snapshot_path(dirs[who]), base, auc=0.9)
    # a lax latency objective: the brownout mode rides load, not timing
    kw = dict(key="s", buckets=(1, 8, 64), max_delay_ms=1.0,
              scorelog_sample_rate=1.0, slo_p99_ms=1e6)
    srv = ServeServer(dirs["port"], device="cpu", dtype=torch.float64, **kw)
    jsrv = JServeServer(dirs["ref"], **kw)
    port = _Front(srv, _make_handler)
    fronts.append(port)
    ref = _Front(jsrv, j_handler)
    fronts.append(ref)
    both = (port, ref)
    sc = srv.registry.get("s")

    # 429: the worker is not started, so a queue at the cap holds
    for f in both:
        f.srv.batcher.submit_burst(np.zeros((64, sc.n_features),
                                            np.float32),
                                   np.zeros((64, sc.n_bins_cols), np.int32)
                                   if sc.needs_bins else None)
    recs, labels = _records(dirs["port"], 40, 2)
    got = [f.call("/score", {"records": recs[:3]}) for f in both]
    assert got[0][0] == got[1][0] == 429
    assert got[0][1]["error"] == got[1][1]["error"] == "overloaded"
    assert got[0][1]["retry_after_ms"] > 0
    assert int(got[0][2]["Retry-After"]) >= 1
    for f in both:
        f.srv.batcher.drain()
        f.srv.start()

    # raw /score with request ids (one malformed record each time)
    scored = {}
    for i in range(4):
        chunk = recs[i * 10:(i + 1) * 10]
        body = {"records": chunk + ([17] if i == 0 else [])}
        hdr = {"X-Shifu-Request": f"r{i}", "X-Shifu-Trace": f"t{i}"}
        (c, a, _), (jc, b, _) = [f.call("/score", body, hdr) for f in both]
        assert c == jc == 200
        assert a["errors"] == b["errors"] and a["generation"] == 0
        assert a["req"] == b["req"] == f"r{i}" and a["trace"] == f"t{i}"
        _assert_scores(a["scores"], b["scores"])
        scored[f"r{i}"] = labels[i * 10:(i + 1) * 10]

    # pre-binned /score: the reference transform's planes of records
    jtf = JFusedTransform.from_dir(dirs["ref"])
    packed, _, _ = jtf.parse_records(recs[:12])
    import jax
    xx, bb = jax.jit(jtf.apply_device)(packed)
    body = {"rows": np.asarray(xx)[:, :sc.n_features].tolist()}
    if sc.needs_bins:
        body["bins"] = np.asarray(bb)[:, :sc.n_bins_cols].tolist()
    (c, a, _), (jc, b, _) = [f.call("/score", body,
                                    {"X-Shifu-Request": "p0"})
                             for f in both]
    assert c == jc == 200
    _assert_scores(a["scores"], b["scores"])
    scored["p0"] = labels[:12]

    # 504: an already-hopeless per-request budget sheds before launch
    (c, a, _), (jc, b, _) = [f.call("/score", {"records": recs[:2]},
                                    {"X-Shifu-Deadline-Ms": "0.001"})
                             for f in both]
    assert c == jc == 504
    assert a["error"] == b["error"] == "deadline_exceeded"
    assert a["detail"] == b["detail"]

    # delayed labels join onto the logged predictions
    outcomes = {"outcomes": [{"req": r, "labels": lab}
                             for r, lab in scored.items()]
                + [{"req": "never-scored", "labels": [1.0]}]}
    (c, a, _), (jc, b, _) = [f.call("/outcome", outcomes) for f in both]
    assert c == jc == 200 and a == b
    assert a["joined_rows"] == 52 and a["late"] == 1
    (c, a, _), (jc, b, _) = [f.call("/quality") for f in both]
    assert c == jc == 200
    assert a["joined"] == b["joined"] == 52
    assert a["baseline_auc"] == b["baseline_auc"] == 0.9
    assert a["current_gen"] == b["current_gen"] == 0
    assert a["live_auc"] is not None
    assert abs(a["live_auc"] - b["live_auc"]) <= 1e-6

    (c, a, _), (jc, b, _) = [f.call("/slo") for f in both]
    assert c == jc == 200
    assert a["objectives"] == b["objectives"] and a["shed"] == b["shed"] == 2
    for h in ("short", "long"):
        for k in ("requests", "errors"):
            assert a["horizons"][h][k] == b["horizons"][h][k]
    (c, a, _), (jc, b, _) = [f.call("/healthz") for f in both]
    assert c == jc == 200
    for k in ("state", "generation", "buckets", "needs_bins", "accepts_raw",
              "n_features", "mode", "queue_depth"):
        assert a[k] == b[k], k
    for k in ("requests", "rows", "errors", "shed_overload", "shed_expired"):
        assert a["stats"][k] == b["stats"][k], k
    assert a["device"] == "cpu"

    # /swap: prepare (captures off-line) then commit; then a rollback
    target = os.path.join(sets["gbt3"], "models")
    (c, a, _), (jc, b, _) = [f.call("/swap", {"phase": "prepare",
                                              "dir": target})
                             for f in both]
    assert c == jc == 200 and a == b
    assert a["prepared_generation"] == 1 and a["generation"] == 0
    (c, a, _), (jc, b, _) = [f.call("/swap", {"phase": "commit"})
                             for f in both]
    assert c == jc == 200 and a == b and a["generation"] == 1
    assert serve_capture_count("serve.score.s") == 0
    hdr = {"X-Shifu-Request": "g1"}
    (c, a, _), (jc, b, _) = [f.call("/score", {"records": recs[:10]}, hdr)
                             for f in both]
    assert c == jc == 200 and a["generation"] == b["generation"] == 1
    _assert_scores(a["scores"], b["scores"])
    assert srv.registry.get("s").buckets == jsrv.registry.get("s").buckets
    (c, a, _), (jc, b, _) = [f.call("/swap", {"phase": "bogus"})
                             for f in both]
    assert c == jc == 400
    for f in both:
        f.srv.registry.rollback("s")
    (c, a, _), (jc, b, _) = [f.call("/score", {"records": recs[:10]})
                             for f in both]
    assert a["generation"] == b["generation"] == 0
    _assert_scores(a["scores"], b["scores"])
    assert srv.registry.generation_history("s") == []

    # the SERVE heartbeat the port writes reads as the reference's does
    srv._heartbeat.beat()
    jsrv._heartbeat.beat()
    hp = j_obs.read_health(j_obs.health_dir_for(dirs["port"]))
    hr = j_obs.read_health(j_obs.health_dir_for(dirs["ref"]))
    assert [r["proc"] for r in hp] == [r["proc"] for r in hr] == ["serve-s"]
    assert j_obs.classify(hp[0]) == j_obs.classify(hr[0]) == "live"
    for k in ("queue_depth", "queue_buildup", "mode"):
        assert hp[0][k] == hr[0][k], k
    assert set(hp[0]["slo"]) == set(hr[0]["slo"])
    assert hp[0]["quality"]["joined"] == hr[0]["quality"]["joined"]
    for f in both:
        f.close()
    fronts.clear()
    assert j_obs.classify(
        j_obs.read_health(j_obs.health_dir_for(dirs["port"]))[0]) == "exited"

    # the score log: one record a scored request, readable by both
    from shifu_tpu.obs.report import load_blocks
    logs = [j_obs.read_score_records(j_obs.scorelog_dir(dirs[w]))
            for w in ("port", "ref")]
    known = set(scored) | {"g1"}            # the rest carry minted ids
    assert [(r["req"] if r["req"] in known else None, r["gen"],
             len(r["scores"])) for r in logs[0]] == \
        [(r["req"] if r["req"] in known else None, r["gen"],
          len(r["scores"])) for r in logs[1]]
    assert obs.read_score_records(obs.scorelog_dir(dirs["port"])) == logs[0]
    qs = [json.load(open(j_obs.quality_artifact_path(dirs[w])))
          for w in ("port", "ref")]
    assert qs[0]["current_gen"] == qs[1]["current_gen"] == 1
    for g in ("0", "1"):
        for k in ("scored", "joined"):
            assert qs[0]["generations"][g][k] == qs[1]["generations"][g][k]
    assert qs[0]["generations"]["0"]["joined"] == 52
    for w in ("port", "ref"):
        spans = [s["name"] for blk in load_blocks(
            os.path.join(dirs[w], "telemetry", "trace.jsonl"))
            for s in blk["spans"]]
        assert spans.count("serve.request") == 4, w
        assert os.path.isfile(os.path.join(dirs[w], "telemetry",
                                           "metrics.prom"))


def test_brownout_flips_and_restores_like_the_reference(sets, tmp_path):
    """Queue buildup for two checks engages brownout in both servers (the
    flush deadline shrinks, sampling and refinement stop, the score log
    tap comes off); three healthy checks restore every setting."""
    from shifu_tpu.serve.server import ServeServer as JServeServer
    from shifu_tpu_torch.serve.server import ServeServer
    obs.set_enabled(True)
    j_obs.set_enabled(True)
    kw = dict(key="b", buckets=(1, 4), max_delay_ms=2.0,
              scorelog_sample_rate=0.5, slo_p99_ms=1e6)   # stress = queue
    servers = [ServeServer(str(tmp_path / "p"), device="cpu",
                           models=_load_port(sets["gbt"]), **kw),
               JServeServer(str(tmp_path / "r"),
                            models=_load_ref(sets["gbt"]), **kw)]
    modes = [[], []]
    for srv, seq in zip(servers, modes):
        b = srv.batcher
        b.trace_sample_rate = 0.25
        sl = b.scorelog
        assert sl is not None
        n = srv.registry.get("b").n_bins_cols
        b.submit_burst(np.zeros((17, 0), np.float32),
                       np.zeros((17, n), np.int32))
        seq += [srv.check_brownout(), srv.check_brownout()]
        seq.append((b.max_delay_s, b.trace_sample_rate, b.refine_every,
                    b.scorelog is None))
        b.drain()
        seq += [srv.check_brownout() for _ in range(3)]
        seq.append((b.max_delay_s, b.trace_sample_rate, b.scorelog is sl))
    assert modes[0] == modes[1]
    assert modes[0][:2] == ["normal", "brownout"]
    assert modes[0][-2] == "normal" and modes[0][-1][2] is True


def _load_port(d):
    from shifu_tpu_torch.eval.scorer import load_models
    return load_models(os.path.join(d, "models"))


def _load_ref(d):
    from shifu_tpu.eval.scorer import Scorer
    return Scorer.from_dir(os.path.join(d, "models")).models
