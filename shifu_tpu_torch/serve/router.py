"""ServeRouter — N serve workers behind one health-/SLO-aware front; the
port of ``shifu_tpu.serve.router``.

One serving process is one card's ceiling; the fleet goes horizontal.
``python -m shifu_tpu_torch.cli --dir <set> serve --replicas N`` spawns N
ordinary serve workers (each its own process, CUDA context, captured
rungs, registry, batcher and journal) on ephemeral ports and puts this thin
HTTP router in front:

- **Balancing**: requests go to the live replica with the fewest
  in-flight requests.  The router polls every replica's ``GET /healthz``
  (``-Dshifu.serve.fleetPollMs``) and DRAINS — stops dispatching to,
  keeps polling — any replica whose SLO tracker is alerting or whose last
  successful poll is older than ``-Dshifu.serve.fleetStaleS``; a drained
  replica that recovers is returned to rotation.
- **Requeue on replica death**: scoring is stateless and idempotent, so a
  request whose connection dies mid-flight (the worker was SIGKILLed —
  the ``serve:replica`` fault site's drill), or whose reply is cut off
  mid-body, is requeued on a peer; every accepted request completes as
  long as one replica survives.
- **Overload resilience** (:mod:`shifu_tpu_torch.serve.overload`):
  requeues spend a token-bucket RETRY BUDGET
  (``-Dshifu.serve.retryBudgetFrac`` of recent successes) — an exhausted
  budget sheds the request with a coded 429; each replica carries a
  CIRCUIT BREAKER (``-Dshifu.serve.breakerFailures`` consecutive
  transport/5xx failures open it, a half-open probe after a cooldown
  closes it); with ``-Dshifu.serve.hedgeMs`` > 0 a request still
  unanswered after the router-observed p99 delay is HEDGED onto a second
  replica — first response wins.  A caller deadline (``deadline_ms`` /
  ``X-Shifu-Deadline-Ms``) rides every dispatch to the worker.
- **Connection reuse**: a small per-replica connection pool backs
  ``_http`` (health polls and scoring); a transport error on a pooled
  connection recycles it and retries once on a fresh one.
- **Coordinated hot-swap** (``POST /swap`` on the router): PREPARE the
  candidate on every replica (each captures its rungs off-line, the old
  model keeps serving), pause dispatch, wait for in-flight requests,
  COMMIT every replica through its journal, resume — no request is ever
  scored by a mixed-model fleet.  With ``-Dshifu.serve.canaryFrac`` > 0
  only ``ceil(frac*N)`` replicas commit (the rest abort): an explicit
  canary slice.
- **Uniformity**: the router refuses a fleet whose replicas disagree on
  ``accepts_raw`` / ``needs_bins``.

Workers run on the device the caller asked for (``--device``, forwarded
explicitly; default ``cuda``).  A worker that cannot reach it exits
non-zero before it announces, and :func:`run_fleet` then refuses to
start: the fleet never carries on with a CPU replica.  Each worker
heartbeats as proc ``serve-<key>-<replica>``.
"""

from __future__ import annotations

import http.client
import json
import logging
import math
import os
import queue
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .. import obs
from .overload import (CircuitBreaker, OverloadedError, RetryBudget,
                       configured_hedge_s)

log = logging.getLogger(__name__)

DEFAULT_POLL_MS = 500.0
DEFAULT_STALE_S = 10.0
DEFAULT_CANARY_FRAC = 0.0

#: idle keep-alive connections pooled per replica
CONN_POOL_SIZE = 4

#: replica lifecycle: starting -> up <-> draining -> dead
STARTING, UP, DRAINING, DEAD = "starting", "up", "draining", "dead"


def fleet_poll_s(override_ms: Optional[float] = None) -> float:
    """Health-poll cadence: ``shifu.serve.fleetPollMs`` (default 500)."""
    if override_ms is None:
        from ..config import environment
        override_ms = environment.get_float("shifu.serve.fleetPollMs",
                                            DEFAULT_POLL_MS)
    return max(0.01, float(override_ms)) / 1000.0


def fleet_stale_s(override: Optional[float] = None) -> float:
    """Stale-heartbeat cutoff: a replica unreachable for longer is
    declared dead (``shifu.serve.fleetStaleS``, default 10)."""
    if override is not None:
        return max(0.1, float(override))
    from ..config import environment
    return max(0.1, environment.get_float("shifu.serve.fleetStaleS",
                                          DEFAULT_STALE_S))


def canary_frac(override: Optional[float] = None) -> float:
    """Coordinated-swap canary slice: commit only ``ceil(frac*N)``
    replicas (``shifu.serve.canaryFrac``, default 0 = commit all)."""
    if override is not None:
        return min(1.0, max(0.0, float(override)))
    from ..config import environment
    return min(1.0, max(0.0, environment.get_float(
        "shifu.serve.canaryFrac", DEFAULT_CANARY_FRAC)))


class Replica:
    """One backend worker as the router sees it."""

    def __init__(self, name: str, port: int, host: str = "127.0.0.1",
                 proc: Optional[subprocess.Popen] = None):
        self.name = name
        self.host = host
        self.port = int(port)
        self.proc = proc
        self.state = STARTING
        self.inflight = 0
        self.last_ok = 0.0
        self.accepts_raw: Optional[bool] = None
        self.needs_bins: Optional[bool] = None
        self.generation: Optional[int] = None
        self.requests = 0
        # per-replica circuit breaker (consecutive transport/5xx ->
        # open -> half-open probe) — replaces bury-on-first-error
        self.breaker = CircuitBreaker()
        # small keep-alive connection pool (health polls + scoring)
        self._conns: deque = deque()
        self._conn_lock = threading.Lock()

    def take_conn(self, timeout: float):
        """(connection, was_pooled): a pooled keep-alive connection when
        one is idle, else a fresh one."""
        with self._conn_lock:
            conn = self._conns.popleft() if self._conns else None
        if conn is not None:
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            return conn, True
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout), False

    def put_conn(self, conn) -> None:
        with self._conn_lock:
            if len(self._conns) < CONN_POOL_SIZE:
                self._conns.append(conn)
                return
        conn.close()

    def drop_conns(self) -> None:
        """Close every pooled connection (replica died / shutdown)."""
        with self._conn_lock:
            conns, self._conns = list(self._conns), deque()
        for c in conns:
            c.close()

    def doc(self) -> dict:
        return {"name": self.name, "port": self.port, "state": self.state,
                "inflight": int(self.inflight),
                "requests": int(self.requests),
                "generation": self.generation,
                "breaker": self.breaker.state,
                "accepts_raw": self.accepts_raw,
                "needs_bins": self.needs_bins}


class ServeRouter:
    """See module docs.  In-process testable: ``add_backend`` +
    ``poll_once`` + ``score``/``coordinated_swap`` need no poll thread
    or subprocesses — any HTTP endpoint speaking the worker protocol
    (``/healthz``, ``/score``, ``/swap``) is a backend."""

    def __init__(self, poll_ms: Optional[float] = None,
                 stale_s: Optional[float] = None,
                 clock=time.monotonic):
        self.replicas: Dict[str, Replica] = {}
        self.clock = clock
        self.poll_s = fleet_poll_s(poll_ms)
        self.stale_s = fleet_stale_s(stale_s)
        # overload resilience: the fleet-wide retry budget, the hedge
        # floor (0 = off), and the router-side latency tracker whose
        # observed p99 sets the actual hedge delay
        self.retry_budget = RetryBudget()
        self._hedge_s = configured_hedge_s()
        self.latency = obs.SLOTracker(
            p99_ms=max(self._hedge_s * 1000.0, 1000.0), clock=clock)
        self._lock = threading.Lock()
        self._gate = threading.Event()      # cleared = dispatch paused
        self._gate.set()
        self._idle = threading.Condition(self._lock)  # inflight -> 0
        self._stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        self._swap_lock = threading.Lock()  # one coordinated swap at a time

    # -------------------------------------------------------------- fleet
    def add_backend(self, name: str, port: int, host: str = "127.0.0.1",
                    proc: Optional[subprocess.Popen] = None) -> Replica:
        r = Replica(name, port, host=host, proc=proc)
        with self._lock:
            self.replicas[name] = r
        return r

    def _http(self, r: Replica, method: str, path: str,
              doc: Optional[dict] = None, timeout: float = 30.0,
              headers: Optional[dict] = None) -> dict:
        """One HTTP exchange with a worker over its pooled keep-alive
        connection (a transport error on a POOLED connection recycles
        it and retries once fresh — a stale socket is not a replica
        failure).  Raises ``OSError`` for transport failures (the
        requeue trigger); a worker-side 5xx raises ``RuntimeError``
        (the request REACHED the worker, so it is not blindly
        requeued) — except 504, the worker's coded deadline shed, which
        passes through like 429 for the caller to see."""
        body = None if doc is None else json.dumps(doc).encode()
        hdrs = {"Content-Type": "application/json"} if body else {}
        hdrs.update(headers or {})
        conn, pooled = r.take_conn(timeout)
        resp = data = None
        for attempt in (0, 1):
            try:
                conn.request(method, path, body=body, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
                break
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                if pooled and attempt == 0:
                    conn, pooled = http.client.HTTPConnection(
                        r.host, r.port, timeout=timeout), False
                    continue
                if isinstance(e, OSError):
                    raise
                # a reply cut off mid-body (the worker died while writing
                # it: ``IncompleteRead``) is a transport failure as well,
                # so the request is requeued like a refused connection
                raise ConnectionError(f"{r.name}{path}: {e!r}") from e
        payload = json.loads(data or b"{}")
        if resp.will_close:
            conn.close()
        else:
            r.put_conn(conn)
        if resp.status >= 500 and resp.status != 504:
            raise RuntimeError(f"{r.name}{path} -> {resp.status}: "
                               f"{payload.get('error')}")
        payload["_status"] = resp.status
        return payload

    def poll_once(self) -> dict:
        """One health sweep: refresh every replica's state from its
        ``/healthz`` (drain on SLO burn, bury on stale/exited), update
        the fleet gauge, and return the merged fleet doc."""
        now = self.clock()
        for r in list(self.replicas.values()):
            if r.state == DEAD:
                continue
            try:
                hz = self._http(r, "GET", "/healthz", timeout=5.0)
                r.last_ok = now
                r.accepts_raw = bool(hz.get("accepts_raw"))
                r.needs_bins = bool(hz.get("needs_bins"))
                r.generation = hz.get("generation")
                burning = bool((hz.get("slo") or {}).get("alerting"))
                if burning and r.state != DRAINING:
                    log.warning("draining %s: SLO burn", r.name)
                    if obs.enabled():
                        obs.counter("serve.fleet_drains").inc()
                    r.state = DRAINING
                elif not burning:
                    r.state = UP
            except (OSError, ValueError, RuntimeError) as e:
                exited = r.proc is not None and r.proc.poll() is not None
                stale = r.last_ok and now - r.last_ok > self.stale_s
                never = not r.last_ok and r.state != STARTING
                if exited or stale or never:
                    if r.state != DEAD:
                        log.warning("replica %s dead (%s)", r.name, e)
                        if obs.enabled():
                            obs.counter("serve.fleet_drains").inc()
                    r.state = DEAD
                    r.drop_conns()
                elif r.state == UP:
                    log.warning("draining %s: unreachable (%s)", r.name, e)
                    if obs.enabled():
                        obs.counter("serve.fleet_drains").inc()
                    r.state = DRAINING
        up = sum(1 for r in self.replicas.values() if r.state == UP)
        obs.gauge("serve.fleet_replicas_up").set(up)
        return self.fleet_doc()

    def ensure_uniform(self) -> None:
        """Refuse a mixed fleet: every live replica must agree on
        ``accepts_raw`` and ``needs_bins`` — a request's shape cannot
        depend on which replica the balancer picks."""
        live = [r for r in self.replicas.values()
                if r.state in (UP, DRAINING) and r.accepts_raw is not None]
        for field in ("accepts_raw", "needs_bins"):
            vals = {bool(getattr(r, field)) for r in live}
            if len(vals) > 1:
                detail = ", ".join(f"{r.name}={getattr(r, field)}"
                                   for r in live)
                raise ValueError(
                    f"mixed fleet: replicas disagree on {field} "
                    f"({detail}) — refusing to serve")

    def fleet_doc(self) -> dict:
        reps = [r.doc() for r in self.replicas.values()]
        gens = {r["generation"] for r in reps
                if r["state"] in (UP, DRAINING)}
        return {"kind": "fleet",
                "replicas": reps,
                "up": sum(1 for r in reps if r["state"] == UP),
                "generations": sorted(g for g in gens if g is not None),
                "accepts_raw": all(r["accepts_raw"] for r in reps
                                   if r["state"] == UP) if reps else False}

    # ----------------------------------------------------------- dispatch
    def _pick(self, exclude: Optional[Replica] = None
              ) -> Optional[Replica]:
        """Least-inflight live replica whose circuit breaker allows
        dispatch (an open breaker hides the replica; a half-open one
        admits exactly the probe request).  ``exclude`` keeps a hedged
        second dispatch off the primary's replica."""
        now = self.clock()
        with self._lock:
            up = [r for r in self.replicas.values()
                  if r.state == UP and r is not exclude]
            up.sort(key=lambda x: (x.inflight, x.requests))
            for r in up:
                if r.breaker.allow(now):
                    r.inflight += 1
                    r.requests += 1
                    return r
            return None

    def _done(self, r: Replica) -> None:
        with self._idle:
            r.inflight = max(0, r.inflight - 1)
            if not self._total_inflight():
                self._idle.notify_all()

    def _total_inflight(self) -> int:
        return sum(r.inflight for r in self.replicas.values())

    def _dispatch(self, r: Replica, doc: dict, timeout: float,
                  headers: Optional[dict] = None) -> dict:
        """One replica dispatch with inflight + breaker bookkeeping.
        Transport errors and 5xx feed the breaker; the replica stays in
        rotation unless its process exited (the breaker — not instant
        burial — decides when to stop dispatching to a flaky one)."""
        t0 = self.clock()
        try:
            out = self._http(r, "POST", "/score", doc, timeout=timeout,
                             headers=headers)
            r.breaker.record_success()
            if out.get("_status", 200) < 400:
                self.latency.observe_batch([self.clock() - t0])
            out["replica"] = r.name
            return out
        except (OSError, RuntimeError) as e:
            if r.breaker.record_failure(self.clock()):
                log.warning("breaker OPEN for %s (%s)", r.name, e)
                if obs.enabled():
                    obs.counter("serve.fleet_breaker_opens").inc()
            if isinstance(e, OSError) and r.proc is not None \
                    and r.proc.poll() is not None:
                r.state = DEAD
                r.drop_conns()
            raise
        finally:
            self._done(r)

    def _hedge_delay_s(self) -> float:
        """The hedged-dispatch trigger delay: the router-observed p99
        when the latency tracker has data, never below the ``hedgeMs``
        floor; 0 = hedging off."""
        if self._hedge_s <= 0.0:
            return 0.0
        p99 = self.latency.quantile_ms(0.99)
        return self._hedge_s if p99 is None \
            else max(self._hedge_s, p99 / 1000.0)

    def _dispatch_hedged(self, r: Replica, doc: dict, timeout: float,
                         headers: Optional[dict] = None) -> dict:
        """Dispatch with tail-shaving: when the primary has not
        answered within the p99-derived hedge delay, fire the SAME
        request at a second replica — first response wins, the loser's
        answer is dropped (scoring is idempotent).  A first ERROR does
        not win: while another dispatch is still in flight, its answer
        gets the remaining budget."""
        delay = self._hedge_delay_s()
        if delay <= 0.0 or timeout <= delay:
            return self._dispatch(r, doc, timeout, headers)
        results: queue.Queue = queue.Queue()

        def run(rep: Replica) -> None:
            try:
                results.put(("ok", self._dispatch(rep, doc, timeout,
                                                  headers)))
            except BaseException as e:      # noqa: BLE001 — relayed
                results.put(("err", e))

        threading.Thread(target=run, args=(r,), daemon=True,
                         name="fleet-dispatch").start()
        launched = 1
        try:
            kind, val = results.get(timeout=delay)
        except queue.Empty:
            r2 = self._pick(exclude=r)
            if r2 is not None:
                launched = 2
                if obs.enabled():
                    obs.counter("serve.fleet_hedges").inc()
                threading.Thread(target=run, args=(r2,), daemon=True,
                                 name="fleet-hedge").start()
            kind, val = results.get(timeout=max(0.05, timeout))
        if kind == "err" and launched == 2:
            try:
                kind, val = results.get(timeout=max(0.05, timeout))
            except queue.Empty:
                pass                        # fall through to the error
        if kind == "err":
            raise val
        return val

    def score(self, doc: dict, timeout: float = 30.0,
              deadline_ms: Optional[float] = None) -> dict:
        """Route one ``POST /score`` body to the best live replica.
        A transport failure (replica died before replying) REQUEUES the
        request on a peer — scoring is idempotent, so the retry is safe
        — but each requeue spends the retry budget: exhausted, the
        request sheds with a coded 429 instead of amplifying overload.
        ``deadline_ms`` (the ``X-Shifu-Deadline-Ms`` header) bounds the
        whole attempt and propagates to the worker, shrinking, on every
        dispatch."""
        if deadline_ms is not None:
            timeout = min(timeout, max(0.001, float(deadline_ms) / 1000.0))
        deadline = self.clock() + timeout
        attempts = 0
        while True:
            # the swap gate: cleared while a coordinated commit runs
            self._gate.wait(timeout=max(0.0, deadline - self.clock()))
            if not self._gate.is_set():
                raise RuntimeError("timed out while a coordinated swap "
                                   "held the dispatch gate")
            r = self._pick()
            if r is None:
                with self._lock:
                    live = [x for x in self.replicas.values()
                            if x.state == UP]
                if live:
                    # replicas are live but every breaker refuses the
                    # dispatch: shed coded instead of spinning on the
                    # poller until the cooldown elapses
                    raise OverloadedError(
                        f"all {len(live)} live replica breaker(s) open",
                        retry_after_s=self.poll_s)
                if self.clock() >= deadline:
                    raise RuntimeError("no live replicas")
                self.poll_once()
                if not any(x.state in (UP, STARTING, DRAINING)
                           for x in self.replicas.values()):
                    raise RuntimeError("no live replicas")
                time.sleep(min(0.05, self.poll_s))
                continue
            left = max(0.1, deadline - self.clock())
            headers = None
            if deadline_ms is not None:
                headers = {"X-Shifu-Deadline-Ms":
                           f"{max(1.0, left * 1000.0):.1f}"}
            try:
                out = self._dispatch_hedged(r, doc, left, headers)
                if out.get("_status", 200) < 400:
                    self.retry_budget.on_success()
                return out
            except OSError as e:
                # transport death: the worker never answered — requeue
                attempts += 1
                if obs.enabled():
                    obs.counter("serve.fleet_requeues").inc()
                log.warning("requeue after %s failed (%s), attempt %d",
                            r.name, e, attempts)
                if self.clock() >= deadline:
                    raise RuntimeError(
                        f"request failed on {attempts} replica(s): {e}"
                        ) from e
                if not self.retry_budget.try_retry():
                    if obs.enabled():
                        obs.counter("serve.fleet_retry_denied").inc()
                    raise OverloadedError(
                        f"retry budget exhausted after {attempts} "
                        f"transport failure(s): {e}",
                        retry_after_s=self.poll_s) from e

    # --------------------------------------------------- coordinated swap
    def coordinated_swap(self, models_dir: str,
                         canary: Optional[float] = None,
                         timeout: float = 300.0) -> dict:
        """Fleet-wide hot-swap with NO mixed-model scoring window:

        1. PREPARE on every live replica (each builds + warms the
           candidate off-line; serving continues on the old model);
           any failure aborts every already-prepared replica and the
           old fleet keeps serving.  A DRAINING replica that no longer
           answers is buried (DEAD) and skipped instead — it serves
           nothing, so skipping it cannot create a mixed window —
           but a reachable DRAINING replica still swaps, so it rejoins
           on the NEW model when its SLO burn clears.
        2. PAUSE dispatch, wait for in-flight requests to finish.
        3. COMMIT every replica (``canaryFrac`` > 0: only the canary
           slice commits, the rest abort — an explicit mixed window).
        4. RESUME dispatch.
        """
        frac = canary_frac(canary)
        with self._swap_lock:
            self.poll_once()
            live = [r for r in self.replicas.values()
                    if r.state in (UP, DRAINING)]
            if not live:
                raise RuntimeError("coordinated swap with no live replicas")
            prepared: List[Replica] = []
            for r in live:
                try:
                    got = self._http(r, "POST", "/swap",
                                     {"phase": "prepare",
                                      "dir": models_dir}, timeout=timeout)
                    if got["_status"] != 200:
                        raise RuntimeError(
                            f"prepare on {r.name}: {got.get('error')}")
                    prepared.append(r)
                except (OSError, RuntimeError) as e:
                    if isinstance(e, OSError) and r.state == DRAINING:
                        # already out of dispatch and now unreachable:
                        # bury it and keep the fleet swap going
                        log.warning("swap skips %s: draining replica "
                                    "unreachable (%s)", r.name, e)
                        r.state = DEAD
                        continue
                    for p in prepared:
                        try:
                            self._http(p, "POST", "/swap",
                                       {"phase": "abort"}, timeout=30.0)
                        except (OSError, RuntimeError):
                            pass        # dead replica: nothing to abort
                    raise RuntimeError(
                        f"coordinated swap aborted: prepare failed on "
                        f"{r.name}: {e}") from e
            if not prepared:
                raise RuntimeError("coordinated swap: no replica "
                                   "survived the prepare phase")
            n_commit = len(prepared) if frac <= 0.0 \
                else min(len(prepared), max(1, math.ceil(frac
                                                         * len(prepared))))
            commit = prepared[:n_commit]
            abort = prepared[n_commit:]
            self._gate.clear()          # pause dispatch
            try:
                with self._idle:
                    deadline = self.clock() + timeout
                    while self._total_inflight():
                        left = deadline - self.clock()
                        if left <= 0:
                            raise RuntimeError(
                                "coordinated swap: in-flight requests "
                                "did not drain")
                        self._idle.wait(timeout=min(0.1, left))
                errors = {}
                for r in commit:
                    try:
                        self._http(r, "POST", "/swap",
                                   {"phase": "commit"}, timeout=timeout)
                    except (OSError, RuntimeError) as e:
                        # a replica dying mid-commit is buried, not a
                        # mixed window: it serves nothing until repolled
                        errors[r.name] = str(e)
                        r.state = DEAD
                for r in abort:
                    try:
                        self._http(r, "POST", "/swap", {"phase": "abort"},
                                   timeout=30.0)
                    except (OSError, RuntimeError) as e:
                        errors[r.name] = str(e)
                        r.state = DEAD
            finally:
                self._gate.set()        # resume dispatch
            obs.counter("serve.fleet_swaps").inc()
            self.poll_once()
            doc = {"kind": "fleet-swap",
                   "committed": [r.name for r in commit
                                 if r.name not in errors],
                   "canary": [r.name for r in commit] if abort else [],
                   "aborted": [r.name for r in abort],
                   **self.fleet_doc()}
            if errors:
                doc["errors"] = errors
            return doc

    # ---------------------------------------------------------- lifecycle
    def start_polling(self) -> None:
        if self._poll_thread is not None:
            return

        def loop():
            while not self._stop.wait(self.poll_s):
                try:
                    self.poll_once()
                except Exception:       # noqa: BLE001 — keep polling
                    log.exception("fleet poll failed")

        self._poll_thread = threading.Thread(target=loop, daemon=True,
                                             name="fleet-poll")
        self._poll_thread.start()

    def stop(self, kill_workers: bool = True) -> None:
        self._stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=2.0)
            self._poll_thread = None
        for r in self.replicas.values():
            r.drop_conns()
        if kill_workers:
            for r in self.replicas.values():
                if r.proc is not None and r.proc.poll() is None:
                    r.proc.terminate()
            for r in self.replicas.values():
                if r.proc is not None:
                    try:
                        r.proc.wait(timeout=10.0)
                    except subprocess.TimeoutExpired:
                        r.proc.kill()


# ------------------------------------------------------------------ HTTP
def _make_router_handler(router: ServeRouter):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: replies always carry Content-Length, so
        # clients (and the fleet's own pooled connections) can reuse
        # the socket across requests
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, doc: dict,
                   headers: Optional[dict] = None) -> None:
            body = json.dumps(doc).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):                      # noqa: N802 (stdlib API)
            if self.path in ("/healthz", "/health", "/status"):
                self._reply(200, router.fleet_doc())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):                     # noqa: N802
            try:
                n = int(self.headers.get("Content-Length", 0))
                doc = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/score":
                    hdr = self.headers.get("X-Shifu-Deadline-Ms")
                    out = router.score(
                        doc, deadline_ms=None if hdr is None
                        else float(hdr))
                    self._reply(out.pop("_status", 200), out)
                elif self.path == "/swap":
                    mdir = doc.get("dir") or doc.get("models_dir")
                    if not mdir:
                        raise ValueError('swap needs {"dir": ...}')
                    self._reply(200, router.coordinated_swap(
                        str(mdir), canary=doc.get("canary_frac")))
                else:
                    self._reply(404, {"error": f"unknown {self.path}"})
            except OverloadedError as e:       # coded fast-fail: the
                # retry budget shed this request, do not mask it as 500
                self._reply(429, {"error": e.code,
                                  "retry_after_ms":
                                      round(e.retry_after_s * 1000.0, 3)},
                            headers={"Retry-After":
                                     str(max(1, round(e.retry_after_s)))})
            except Exception as e:             # noqa: BLE001 — HTTP edge
                self._reply(500, {"error": str(e)})

        def log_message(self, fmt, *args):
            log.debug("router: " + fmt, *args)

    return Handler


def spawn_worker(model_set_dir: str, name: str, announce: str,
                 max_delay_ms: Optional[float] = None,
                 extra_env: Optional[dict] = None,
                 device: str = "cuda") -> subprocess.Popen:
    """One fleet worker: an ordinary ``serve`` process of this package on
    an ephemeral port that writes ``announce`` (port/pid JSON) once bound.
    ``-D`` properties set in THIS process are forwarded on the worker's
    command line so fleet knobs behave like single-process knobs, and
    ``device`` is passed as ``--device``."""
    from ..config import environment
    cmd = [sys.executable, "-m", "shifu_tpu_torch.cli"]
    cmd += [f"-D{k}={v}" for k, v in
            sorted(environment.all_properties().items())]
    cmd += ["--dir", model_set_dir, "serve", "--port", "0",
            "--replica", name, "--announce", announce,
            "--device", str(device)]
    if max_delay_ms is not None:
        cmd += ["--max-delay-ms", str(max_delay_ms)]
    env = dict(os.environ)
    env.update(extra_env or {})
    return subprocess.Popen(cmd, env=env)


def wait_for_announce(path: str, proc: subprocess.Popen,
                      timeout: float = 300.0) -> dict:
    """Block until the worker writes its announce file (compile+warm
    happens before the bind, so this can take a while on first start)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"fleet worker exited rc={proc.returncode} before "
                "announcing its port")
        if os.path.isfile(path):
            try:
                with open(path) as f:
                    doc = json.load(f)
                if doc.get("port"):
                    return doc
            except (OSError, ValueError):
                pass                    # torn read: announce mid-write
        time.sleep(0.05)
    raise RuntimeError(f"fleet worker did not announce within {timeout}s")


def run_fleet(model_set_dir: str, replicas: int = 2, port: int = 8188,
              max_delay_ms: Optional[float] = None,
              device: str = "cuda") -> int:
    """The ``serve --replicas N`` entry: spawn N workers on ``device``,
    wait for their announces (a worker that exits first — no CUDA, say —
    makes this raise and stops the rest), refuse a mixed fleet, then serve
    the routing front on ``port`` (0 = an ephemeral port) until
    interrupted."""
    fleet_dir = os.path.join(model_set_dir, "serving", "fleet")
    os.makedirs(fleet_dir, exist_ok=True)
    router = ServeRouter()
    procs = []
    try:
        for i in range(int(replicas)):
            name = f"r{i}"
            announce = os.path.join(fleet_dir, f"{name}.json")
            if os.path.exists(announce):
                os.unlink(announce)
            procs.append((name, announce,
                          spawn_worker(model_set_dir, name, announce,
                                       max_delay_ms=max_delay_ms,
                                       device=device)))
        for name, announce, proc in procs:
            doc = wait_for_announce(announce, proc)
            router.add_backend(name, doc["port"], proc=proc)
        router.poll_once()
        router.ensure_uniform()
        router.start_polling()
        from http.server import ThreadingHTTPServer
        httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                    _make_router_handler(router))
        bound = httpd.server_address[1]
        fd = router.fleet_doc()
        print(f"shifu-tpu-torch serve fleet: {len(procs)} replica(s) on "
              f"http://127.0.0.1:{bound} on {device} (up={fd['up']}, "
              f"accepts_raw={fd['accepts_raw']})", flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()
        return 0
    finally:
        router.stop()
        for _, _, proc in procs:         # workers that never joined
            if proc.poll() is None:
                proc.kill()
                proc.wait()
