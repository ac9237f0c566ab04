"""Port parity for the serving fleet (``shifu_tpu_torch.serve.router``)
against ``shifu_tpu.serve.router``, scenario for scenario with the
reference's ``tests/test_serve_fleet.py`` and the router cases of
``tests/test_serve_overload.py``.

The in-process tests run the port's ``ServeServer`` workers on the CPU
behind real loopback ``ThreadingHTTPServer`` listeners, as the reference's
do, so the router sees genuine HTTP transport (connection refused on
death, real concurrency during a coordinated swap) without process start
cost.  The router's state machine is held to the reference's on the same
stub backends and injected clock (fleet documents equal), and the fleet's
scores to the reference's ``ServeServer`` on the same model set within
1e-3 on the 0-1000 scale (``TOL``: f32 GEMMs in another order).  The two
subprocess SIGKILL drills are marked ``slow`` exactly where the
reference's are.
"""

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from shifu_tpu import faults as j_faults
from shifu_tpu import obs as j_obs
from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch import faults, obs
from shifu_tpu_torch.config import environment
from shifu_tpu_torch.serve.router import (DEAD, DRAINING, UP, ServeRouter,
                                          spawn_worker, wait_for_announce)
from shifu_tpu_torch.serve.server import ServeServer, _make_handler

pytestmark = [pytest.mark.torch_port, pytest.mark.serve,
              pytest.mark.fleet]

TOL = 1e-3


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("SHIFU_TPU_HEARTBEAT_S", "3600")
    for env, o, f in ((environment, obs, faults),
                      (j_environment, j_obs, j_faults)):
        env.reset_for_tests()
        f.reset_for_tests()
    yield
    for env, o, f in ((environment, obs, faults),
                      (j_environment, j_obs, j_faults)):
        env.reset_for_tests()
        f.reset_for_tests()
        o.set_enabled(False)


def _modelset(d, n_models=2, seed0=0, subdir="models"):
    """A raw-capable model set on disk, written by the reference's savers
    (the port reads them): 2 numeric ZSCALE columns and a tiny NN
    ensemble; every fleet worker loads the same snapshot."""
    import jax
    from shifu_tpu.config import ColumnConfig, save_column_configs
    from shifu_tpu.config.model_config import ModelConfig
    from shifu_tpu.models.nn import NNModelSpec, init_params, save_model
    if not os.path.exists(os.path.join(d, "ModelConfig.json")):
        ccs = []
        for j, name in enumerate(("a", "b")):
            cc = ColumnConfig(columnNum=j, columnName=name,
                              finalSelect=True)
            cc.columnBinning.binBoundary = [float("-inf"), 0.0, 1.0]
            cc.columnBinning.binCountNeg = [5, 5, 5]
            cc.columnBinning.binCountPos = [2, 3, 4]
            cc.columnBinning.binPosRate = [2 / 7., 3 / 8., 4 / 9.]
            cc.columnBinning.binCountWoe = [0.1, -0.2, 0.3, 0.0]
            cc.columnStats.mean = 0.4 + j
            cc.columnStats.stdDev = 1.3
            ccs.append(cc)
        ModelConfig().save(os.path.join(d, "ModelConfig.json"))
        save_column_configs(ccs, os.path.join(d, "ColumnConfig.json"))
    spec = NNModelSpec(input_dim=2, hidden_nodes=[4],
                       activations=["tanh"])
    md = os.path.join(d, subdir)
    os.makedirs(md, exist_ok=True)
    for i in range(n_models):
        save_model(os.path.join(md, f"model{i}.nn"), spec,
                   init_params(jax.random.PRNGKey(seed0 + i), spec))
    return md


class _TrackingHTTPServer(ThreadingHTTPServer):
    """A ThreadingHTTPServer that can sever ESTABLISHED connections too:
    ``shutdown()`` only stops the accept loop, which no longer models
    transport death while the router pools keep-alive connections."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._conns = set()
        self._conns_lock = threading.Lock()

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def kill_connections(self):
        import socket
        with self._conns_lock:
            conns, self._conns = list(self._conns), set()
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


class _Fleet:
    """The port's in-process workers behind real loopback listeners."""

    def __init__(self):
        self.workers = []        # (srv, httpd)
        self.router = ServeRouter(poll_ms=100, stale_s=2)

    def add(self, model_set_dir, name):
        srv = ServeServer(model_set_dir, key="m", buckets=(4, 16),
                          replica=name, max_delay_ms=1.0, device="cpu")
        srv.registry.state_dir = None    # in-memory journal per worker
        srv.start()
        httpd = _TrackingHTTPServer(("127.0.0.1", 0), _make_handler(srv))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        self.workers.append((srv, httpd))
        self.router.add_backend(name, httpd.server_address[1])
        return srv, httpd

    def up(self):
        self.router.poll_once()
        self.router.ensure_uniform()
        return self.router.fleet_doc()

    def kill_listener(self, httpd):
        httpd.shutdown()
        httpd.server_close()
        httpd.kill_connections()

    def stop(self):
        self.router.stop(kill_workers=False)
        for srv, httpd in self.workers:
            try:
                httpd.shutdown()
                httpd.server_close()
            except OSError:
                pass
            srv.stop()


@pytest.fixture
def fleet():
    f = _Fleet()
    yield f
    f.stop()


_RECORDS = [{"a": 0.5, "b": 1.5}, {"a": None, "b": "?"}]


# -------------------------------------------------------- basic routing
def test_router_balances_and_reports_uniform_fleet(fleet, tmp_path):
    from shifu_tpu.serve.server import ServeServer as JServeServer
    d = str(tmp_path)
    _modelset(d)
    fleet.add(d, "r0")
    fleet.add(d, "r1")
    doc = fleet.up()
    assert doc["up"] == 2 and doc["accepts_raw"] is True
    base = fleet.router.score({"records": _RECORDS})["scores"]
    assert base[0] is not None
    for _ in range(9):
        out = fleet.router.score({"records": _RECORDS})
        assert out["scores"] == base      # same snapshot everywhere
    reqs = {r.name: r.requests for r in fleet.router.replicas.values()}
    assert all(v > 0 for v in reqs.values()), reqs
    # the reference's server scores the same records alike
    jsrv = JServeServer(d, key="m", buckets=(4, 16), max_delay_ms=1.0)
    jsrv.registry.state_dir = None
    jsrv.start()
    try:
        want = jsrv.score_raw(_RECORDS)["scores"]
    finally:
        jsrv.stop()
    assert [s is None for s in base] == [s is None for s in want]
    got = np.array([s for s in base if s is not None], np.float64)
    ref = np.array([s for s in want if s is not None], np.float64)
    assert np.max(np.abs(got - ref)) <= TOL


def test_requeue_on_replica_death_completes_request(fleet, tmp_path):
    """A replica whose transport dies mid-fleet never fails a request:
    the router requeues on a peer and the answer is identical."""
    d = str(tmp_path)
    _modelset(d)
    fleet.add(d, "r0")
    _, h1 = fleet.add(d, "r1")
    fleet.up()
    base = fleet.router.score({"records": _RECORDS})["scores"]
    obs.set_enabled(True)
    before = obs.counter("serve.fleet_requeues").value
    fleet.kill_listener(h1)
    for _ in range(6):
        out = fleet.router.score({"records": _RECORDS})
        assert out["replica"] == "r0" or out["scores"] == base
    assert obs.counter("serve.fleet_requeues").value > before
    r1 = fleet.router.replicas["r1"]
    assert r1.state in (DRAINING, DEAD) or r1.breaker.state == "open"


def test_mixed_raw_prebinned_fleet_refused(fleet, tmp_path):
    """``ensure_uniform`` refuses a fleet where one replica lacks the
    transform snapshot."""
    d = str(tmp_path)
    _modelset(d)
    naked = str(tmp_path / "naked")
    os.makedirs(naked)
    _modelset(naked)                       # then strip the snapshot
    os.remove(os.path.join(naked, "ModelConfig.json"))
    os.remove(os.path.join(naked, "ColumnConfig.json"))
    fleet.add(d, "r0")
    fleet.add(naked, "naked")
    fleet.router.poll_once()
    with pytest.raises(ValueError, match="accepts_raw"):
        fleet.router.ensure_uniform()


# ------------------------------------------------------ coordinated swap
def test_coordinated_swap_has_no_mixed_model_window(fleet, tmp_path):
    """Under concurrent load, for any two requests where a finished
    before b started, gen(a) <= gen(b) — and both generations are
    observed."""
    d = str(tmp_path)
    _modelset(d)
    _modelset(d, seed0=100, subdir="models2")
    fleet.add(d, "r0")
    fleet.add(d, "r1")
    fleet.up()
    results, stop = [], threading.Event()

    def pound():
        while not stop.is_set():
            t0 = time.monotonic()
            try:
                o = fleet.router.score({"records": _RECORDS}, timeout=60)
            except RuntimeError:
                continue
            results.append((t0, time.monotonic(), o["generation"]))

    threads = [threading.Thread(target=pound, daemon=True)
               for _ in range(3)]
    [t.start() for t in threads]
    time.sleep(0.25)
    doc = fleet.router.coordinated_swap(os.path.join(d, "models2"))
    time.sleep(0.25)
    stop.set()
    [t.join(timeout=30) for t in threads]
    assert sorted(doc["committed"]) == ["r0", "r1"]
    assert not doc.get("errors")
    gens = {g for _, _, g in results}
    assert gens == {0, 1}, gens
    bad = [(a, b) for a in results for b in results
           if a[1] < b[0] and a[2] > b[2]]
    assert bad == [], f"{len(bad)} mixed-window pairs"


def test_canary_swap_commits_only_a_slice(fleet, tmp_path):
    d = str(tmp_path)
    _modelset(d)
    _modelset(d, seed0=100, subdir="models2")
    fleet.add(d, "r0")
    fleet.add(d, "r1")
    fleet.up()
    doc = fleet.router.coordinated_swap(os.path.join(d, "models2"),
                                        canary=0.5)
    assert len(doc["committed"]) == 1 and len(doc["aborted"]) == 1
    assert doc["canary"] == doc["committed"]
    gens = {r.generation for r in fleet.router.replicas.values()
            if r.state == UP}
    assert gens == {0, 1}                  # the explicit mixed slice


def test_canary_frac_property_drives_default(fleet, tmp_path):
    d = str(tmp_path)
    _modelset(d)
    _modelset(d, seed0=100, subdir="models2")
    fleet.add(d, "r0")
    fleet.add(d, "r1")
    fleet.up()
    environment.set_property("shifu.serve.canaryFrac", "0.5")
    doc = fleet.router.coordinated_swap(os.path.join(d, "models2"))
    assert len(doc["committed"]) == 1 and len(doc["aborted"]) == 1


def test_swap_buries_unreachable_draining_replica(fleet, tmp_path):
    """An unreachable DRAINING replica cannot veto the fleet's swap: it
    is buried DEAD and skipped, while the reachable fleet commits."""
    d = str(tmp_path)
    _modelset(d)
    _modelset(d, seed0=100, subdir="models2")
    fleet.add(d, "r0")
    _, h1 = fleet.add(d, "r1")
    fleet.up()
    fleet.kill_listener(h1)
    fleet.router.replicas["r1"].state = DRAINING
    doc = fleet.router.coordinated_swap(os.path.join(d, "models2"))
    assert doc["committed"] == ["r0"]
    assert fleet.router.replicas["r1"].state == DEAD
    out = fleet.router.score({"records": _RECORDS})
    assert out["generation"] == 1


def test_swap_prepare_failure_on_live_replica_aborts_all(fleet, tmp_path):
    """A live replica failing PREPARE aborts the whole swap — the old
    fleet keeps serving generation 0 everywhere."""
    d = str(tmp_path)
    _modelset(d)
    fleet.add(d, "r0")
    fleet.add(d, "r1")
    fleet.up()
    with pytest.raises(RuntimeError, match="prepare"):
        fleet.router.coordinated_swap(str(tmp_path / "nonexistent"))
    out = fleet.router.score({"records": _RECORDS})
    assert out["generation"] == 0
    assert fleet.router.fleet_doc()["up"] == 2


def test_router_http_front_scores_swaps_and_reports(fleet, tmp_path):
    """The router's own front: ``GET /healthz|/health|/status`` is the
    fleet document, ``POST /score`` routes, ``POST /swap`` runs the
    coordinated swap, an unknown path is a 404."""
    import http.client
    from shifu_tpu_torch.serve.router import _make_router_handler
    d = str(tmp_path)
    _modelset(d)
    _modelset(d, seed0=100, subdir="models2")
    fleet.add(d, "r0")
    fleet.add(d, "r1")
    fleet.up()
    front = ThreadingHTTPServer(("127.0.0.1", 0),
                                _make_router_handler(fleet.router))
    threading.Thread(target=front.serve_forever, daemon=True).start()
    conn = http.client.HTTPConnection("127.0.0.1",
                                      front.server_address[1], timeout=30)

    def call(method, path, doc=None):
        body = None if doc is None else json.dumps(doc)
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())

    try:
        for path in ("/healthz", "/health", "/status"):
            code, doc = call("GET", path)
            assert code == 200 and doc["kind"] == "fleet" and doc["up"] == 2
        code, doc = call("POST", "/score", {"records": _RECORDS})
        assert code == 200 and doc["generation"] == 0
        assert doc["replica"] in ("r0", "r1")
        code, doc = call("POST", "/swap",
                         {"dir": os.path.join(d, "models2")})
        assert code == 200 and sorted(doc["committed"]) == ["r0", "r1"]
        assert call("POST", "/score", {"records": _RECORDS})[1][
            "generation"] == 1
        assert call("POST", "/swap", {})[0] == 500
        assert call("GET", "/nope")[0] == 404
        assert call("POST", "/nope", {})[0] == 404
    finally:
        conn.close()
        front.shutdown()
        front.server_close()


# ------------------------------------------------------------ fault site
def test_serve_replica_fault_site_declared_and_scoped():
    """The replica-death drill site exists and its point key is the
    replica name — arming r0 must not touch r1's path."""
    assert faults.is_declared_site("serve", "replica")
    environment.set_property("shifu.faults", "serve:replica=r0:ioerror")
    faults.reset_for_tests()
    with pytest.raises(OSError):
        faults.fire("serve", "replica", "r0")
    faults.fire("serve", "replica", "r1")   # different replica: no-op
    faults.fire("serve", "replica", "r0")   # fired once, now disarmed


def test_worker_fires_the_replica_fault_and_stamps_heartbeats(fleet,
                                                              tmp_path):
    """A worker's ``/score`` fires ``serve:replica`` with its name before
    the request enqueues (an armed ioerror answers 400 and scores
    nothing), its ``/healthz`` names the replica, and its heartbeat is
    proc ``serve-<key>-<replica>`` as in the reference."""
    import http.client
    d = str(tmp_path)
    _modelset(d)
    obs.set_enabled(True)
    srv, httpd = fleet.add(d, "r0")
    environment.set_property("shifu.faults", "serve:replica=r0:ioerror")
    faults.reset_for_tests()
    conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1],
                                      timeout=30)
    try:
        conn.request("POST", "/score", body=json.dumps(
            {"records": _RECORDS}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 400
        assert "serve:replica=r0" in json.loads(resp.read())["error"]
        assert srv.batcher.stats["requests"] == 0
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read())["replica"] == "r0"
    finally:
        conn.close()
    health = os.path.join(d, "telemetry", "health")
    assert os.path.isfile(os.path.join(health, "serve-m-r0.json"))


# ------------------------------------- the router's state machine vs ref
class _Stub:
    """A loopback worker stub whose /healthz answer the test sets."""

    def __init__(self, name, delay_s=0.0, status=200):
        self.hz = {"state": "serving", "accepts_raw": False,
                   "needs_bins": False, "generation": 0,
                   "slo": {"alerting": False}}
        stub = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _reply(self, code, doc):
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):                   # noqa: N802
                self._reply(200, stub.hz)

            def do_POST(self):                  # noqa: N802
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if delay_s:
                    time.sleep(delay_s)
                self._reply(status, {"scores": [0.5], "replica": name})

            def log_message(self, fmt, *args):
                pass

        self.httpd = _TrackingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.httpd.kill_connections()


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def test_poll_drain_and_burial_match_reference():
    """The same fleet events through the reference's router and the
    port's, on the same stubs and injected clock: every poll returns the
    same fleet document (drain on SLO burn, return on recovery, drain on
    an unreachable replica, burial once stale)."""
    from shifu_tpu.serve.router import ServeRouter as JRouter
    clocks = (Clock(), Clock())
    routers = (ServeRouter(poll_ms=100, stale_s=2, clock=clocks[0]),
               JRouter(poll_ms=100, stale_s=2, clock=clocks[1]))
    stubs = [_Stub("s0"), _Stub("s1"), _Stub("s2")]
    docs = ([], [])

    def sweep(dt=0.0):
        for clk, router, out in zip(clocks, routers, docs):
            clk.t += dt
            doc = router.poll_once()
            out.append([(r["name"], r["state"], r["breaker"])
                        for r in doc["replicas"]] + [doc["up"]])

    try:
        for r in routers:
            for i, s in enumerate(stubs):
                r.add_backend(f"s{i}", s.port)
        sweep()
        stubs[1].hz["slo"] = {"alerting": True}
        sweep(0.5)
        stubs[1].hz["slo"] = {"alerting": False}
        sweep(0.5)
        stubs[2].close()
        sweep(0.5)                          # unreachable: draining
        sweep(1.0)                          # still within stale_s
        sweep(2.0)                          # stale: dead
        sweep(0.5)
        assert docs[0] == docs[1]
        assert docs[0][-1][:3] == [("s0", UP, "closed"),
                                   ("s1", UP, "closed"),
                                   ("s2", DEAD, "closed")]
        for r in routers:
            r.ensure_uniform()
            assert r._pick().name in ("s0", "s1")
    finally:
        for r in routers:
            r.stop(kill_workers=False)
        for s in stubs[:2]:
            s.close()


# --------------------------------------------------- router overload cases
def test_retry_budget_exhaustion_propagates_coded_429():
    """With every replica's transport dead, the router spends its retry
    budget then sheds with a coded ``OverloadedError``."""
    from shifu_tpu_torch.serve.overload import OverloadedError
    environment.set_property("shifu.serve.breakerFailures", "0")
    obs.set_enabled(True)
    router = ServeRouter(poll_ms=100, stale_s=60)
    dead = _Stub("dead")
    dead.close()                        # connection refused from now on
    r = router.add_backend("dead", dead.port)
    r.state = UP
    before = obs.counter("serve.fleet_retry_denied").value
    try:
        with pytest.raises(OverloadedError) as ei:
            router.score({"records": [{}]}, timeout=30.0)
        assert ei.value.code == "overloaded"
        assert obs.counter("serve.fleet_retry_denied").value == before + 1
        assert router.retry_budget.tokens < 1.0
    finally:
        router.stop(kill_workers=False)


def test_breaker_opens_after_transport_failures_and_probes_later():
    from shifu_tpu_torch.serve.overload import (DEFAULT_BREAKER_COOLDOWN_S,
                                                OverloadedError)
    obs.set_enabled(True)
    clk = Clock()
    router = ServeRouter(poll_ms=100, stale_s=60, clock=clk)
    dead = _Stub("dead")
    dead.close()
    r = router.add_backend("dead", dead.port)
    r.state = UP
    before = obs.counter("serve.fleet_breaker_opens").value
    try:
        with pytest.raises((RuntimeError, OverloadedError)):
            router.score({"records": [{}]}, timeout=5.0)
        assert r.breaker.state == "open"
        assert r.doc()["breaker"] == "open"
        assert obs.counter("serve.fleet_breaker_opens").value \
            == before + 1
        assert router._pick() is None           # refused while open
        clk.t += DEFAULT_BREAKER_COOLDOWN_S + 0.1
        assert router._pick() is r              # the half-open probe
        assert r.breaker.state == "half_open"
        assert router._pick() is None           # one probe at a time
        r.breaker.record_success()
        assert router._pick() is r
    finally:
        router.stop(kill_workers=False)


def test_hedged_dispatch_fires_and_first_response_wins():
    environment.set_property("shifu.serve.hedgeMs", "40")
    obs.set_enabled(True)
    router = ServeRouter(poll_ms=100, stale_s=60)
    slow = _Stub("slow", delay_s=0.5)
    fast = _Stub("fast", delay_s=0.0)
    rs = router.add_backend("slow", slow.port)
    rf = router.add_backend("fast", fast.port)
    rs.state = rf.state = UP
    rs.requests = 0
    rf.requests = 1                     # tie-break: slow picked first
    before = obs.counter("serve.fleet_hedges").value
    try:
        assert router._hedge_delay_s() == pytest.approx(0.04)
        t0 = time.monotonic()
        out = router.score({"records": [{}]}, timeout=10.0)
        assert out["replica"] == "fast"
        assert time.monotonic() - t0 < 0.45     # did not wait for slow
        assert obs.counter("serve.fleet_hedges").value == before + 1
    finally:
        router.stop(kill_workers=False)
        slow.close()
        fast.close()


def test_hedge_error_does_not_win_while_peer_in_flight():
    environment.set_property("shifu.serve.hedgeMs", "40")
    environment.set_property("shifu.serve.breakerFailures", "0")
    router = ServeRouter(poll_ms=100, stale_s=60)
    sick = _Stub("sick", delay_s=0.1, status=500)
    ok = _Stub("ok", delay_s=0.15)
    r0 = router.add_backend("sick", sick.port)
    r1 = router.add_backend("ok", ok.port)
    r0.state = r1.state = UP
    r0.requests, r1.requests = 0, 1
    try:
        out = router.score({"records": [{}]}, timeout=10.0)
        assert out["replica"] == "ok"
    finally:
        router.stop(kill_workers=False)
        sick.close()
        ok.close()


def test_reply_cut_mid_body_is_requeued_on_a_peer():
    """A worker that dies while writing its reply (the body cut short of
    its Content-Length) is a transport failure: the port's router requeues
    the request on a peer.  The reference's router lets the
    ``IncompleteRead`` escape instead (ROADMAP Queue 3, C13)."""
    import http.client

    from shifu_tpu.serve.router import ServeRouter as JRouter

    class Cut(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_POST(self):                      # noqa: N802
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", "100")
            self.end_headers()
            self.wfile.write(b'{"scores": [')
            self.wfile.flush()
            self.close_connection = True

        def log_message(self, fmt, *args):
            pass

    cut = _TrackingHTTPServer(("127.0.0.1", 0), Cut)
    threading.Thread(target=cut.serve_forever, daemon=True).start()
    ok = _Stub("ok")
    routers = (ServeRouter(poll_ms=100, stale_s=60),
               JRouter(poll_ms=100, stale_s=60))
    try:
        for router in routers:
            rc = router.add_backend("cut", cut.server_address[1])
            ro = router.add_backend("ok", ok.port)
            rc.state = ro.state = UP
            rc.requests, ro.requests = 0, 1     # the cut one first
        out = routers[0].score({"records": [{}]}, timeout=10.0)
        assert out["replica"] == "ok" and out["scores"] == [0.5]
        assert routers[0].replicas["cut"].breaker.failures >= 1
        with pytest.raises(http.client.IncompleteRead):
            routers[1].score({"records": [{}]}, timeout=10.0)
    finally:
        for router in routers:
            router.stop(kill_workers=False)
        cut.shutdown()
        cut.server_close()
        ok.close()


def test_fleet_knobs_match_reference():
    from shifu_tpu.serve import router as j_router
    from shifu_tpu_torch.serve import router
    for props in ({}, {"shifu.serve.fleetPollMs": "50",
                       "shifu.serve.fleetStaleS": "0.01",
                       "shifu.serve.canaryFrac": "1.7"}):
        for env in (environment, j_environment):
            env.reset_for_tests()
            for k, v in props.items():
                env.set_property(k, v)
        assert router.fleet_poll_s() == j_router.fleet_poll_s()
        assert router.fleet_stale_s() == j_router.fleet_stale_s()
        assert router.canary_frac() == j_router.canary_frac()
    assert router.canary_frac(0.25) == j_router.canary_frac(0.25)


def test_spawn_worker_forwards_properties_and_the_device(monkeypatch,
                                                         tmp_path):
    """A worker's command line: this package's CLI, every ``-D``
    property of this process, the worker flags and ``--device``."""
    import subprocess
    from shifu_tpu_torch.serve import router
    seen = {}

    class P:
        def __init__(self, cmd, env=None):
            seen["cmd"], seen["env"] = cmd, env

    monkeypatch.setattr(subprocess, "Popen", P)
    environment.set_property("shifu.serve.hedgeMs", "7")
    router.spawn_worker(str(tmp_path), "r3", str(tmp_path / "a.json"),
                        max_delay_ms=1.5, extra_env={"X_TEST": "1"},
                        device="cpu")
    cmd = seen["cmd"]
    assert cmd[1:3] == ["-m", "shifu_tpu_torch.cli"]
    assert "-Dshifu.serve.hedgeMs=7" in cmd
    i = cmd.index("serve")
    assert cmd[i:] == ["serve", "--port", "0", "--replica", "r3",
                       "--announce", str(tmp_path / "a.json"),
                       "--device", "cpu", "--max-delay-ms", "1.5"]
    assert seen["env"]["X_TEST"] == "1"
    router.spawn_worker(str(tmp_path), "r4", "a.json")
    assert seen["cmd"][seen["cmd"].index("--device") + 1] == "cuda"


# ------------------------------------------------- subprocess kill drill
def _spawn_fleet(d, router, names=("r0", "r1")):
    fdir = os.path.join(d, "serving", "fleet")
    os.makedirs(fdir, exist_ok=True)
    procs = {}
    for name in names:
        ann = os.path.join(fdir, f"{name}.json")
        procs[name] = (spawn_worker(d, name, ann, device="cpu"), ann)
    for name, (p, ann) in procs.items():
        doc = wait_for_announce(ann, p, timeout=240)
        router.add_backend(name, doc["port"], proc=p)
    router.poll_once()
    router.ensure_uniform()
    assert router.fleet_doc()["up"] == 2
    return procs


@pytest.mark.slow
def test_replica_sigkill_drill_requeues_and_buries(tmp_path):
    """Two ``spawn_worker`` subprocesses on the CPU; the ``serve:replica``
    fault hard-kills r0 on its first scoring request, and the router
    requeues the in-flight request on r1 so it still completes; the next
    poll buries r0."""
    d = str(tmp_path)
    _modelset(d)
    environment.set_property("shifu.faults", "serve:replica=r0:kill")
    router = ServeRouter(poll_ms=200, stale_s=5)
    procs = {}
    try:
        procs = _spawn_fleet(d, router)
        outs = [router.score({"records": [{"a": 0.5, "b": 1.5}]},
                             timeout=120) for _ in range(4)]
        assert all(o["scores"][0] is not None for o in outs)
        assert procs["r0"][0].poll() is not None     # hard-died
        router.poll_once()
        assert router.replicas["r0"].state == DEAD
        out = router.score({"records": [{"a": 0.5, "b": 1.5}]})
        assert out["replica"] == "r1"
    finally:
        router.stop()
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()


@pytest.mark.slow
def test_fleet_chaos_sigkill_under_double_load_no_hung_clients(tmp_path):
    """Two subprocess replicas under four client threads, r0 SIGKILLed
    mid-window: every request resolves as a score or a coded 429, no
    client hangs, and most requests score while r1 lives."""
    from shifu_tpu_torch.serve.overload import OverloadedError
    d = str(tmp_path)
    _modelset(d)
    router = ServeRouter(poll_ms=200, stale_s=5)
    procs = {}
    try:
        procs = _spawn_fleet(d, router)
        ok, shed, uncoded = [], [], []
        stop = threading.Event()

        def pound(i):
            while not stop.is_set():
                try:
                    out = router.score(
                        {"records": [{"a": 0.5, "b": 1.5}]},
                        timeout=30.0, deadline_ms=30000.0)
                    ok.append(out["replica"])
                except OverloadedError:
                    shed.append(i)
                except RuntimeError as e:
                    uncoded.append(str(e))

        threads = [threading.Thread(target=pound, args=(i,), daemon=True)
                   for i in range(4)]
        [t.start() for t in threads]
        time.sleep(1.0)
        procs["r0"][0].kill()
        time.sleep(2.0)
        stop.set()
        [t.join(timeout=60) for t in threads]
        assert not any(t.is_alive() for t in threads)
        total = len(ok) + len(shed) + len(uncoded)
        assert total > 0 and len(ok) > 0
        assert uncoded == [], uncoded[:3]
        assert len(shed) / total < 0.5, (len(shed), total)
        router.poll_once()
        assert router.replicas["r0"].state == DEAD
        assert router.replicas["r1"].state in (UP, DRAINING)
    finally:
        router.stop()
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
