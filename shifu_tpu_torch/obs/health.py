"""Live health & heartbeats — per-process liveness for long-running
steps; the port of ``shifu_tpu.obs.health``.  A heartbeat file this
module writes has the reference's layout, so the reference's
:func:`read_health` / :func:`classify` (and its ``monitor`` CLI) read it.

The post-hoc trace (``trace.jsonl``) tells you what happened; this module
tells you what is happening NOW.  Every pipeline step process runs a
:class:`HeartbeatWriter`: a daemon thread that, every ``interval_s``
seconds, snapshots the process's live state — current step, open spans
(per thread: the main step phase AND the ingest prep thread), rows /
windows / trees / epochs out of the metrics registry, device-memory
high-water, a last-progress timestamp — and atomically commits it to
``<modelset>/telemetry/health/<proc>.json`` through :mod:`ioutil` (a
reader, or a crash, never observes a torn health file).

This is the per-worker progress surface the reference's Guagua master
aggregated from worker RPC (``GuaguaConstants`` progress reporting): the
reference's ``monitor`` CLI tails the directory and flags stale/stalled
processes (the port's own ``monitor`` is ROADMAP Queue 1 item 13).

Staleness model (shared with the monitor via :func:`classify`):

- ``live``     heartbeat age <= STALE_FACTOR x the file's own declared
  interval and the process reports progress recently;
- ``stalled``  heartbeats fresh but no progress-counter movement for
  ``stall_after_s`` (the straggler flag — the process is alive but its
  plane stopped advancing: stuck collective, dead input, livelock);
- ``stale``    heartbeat age > STALE_FACTOR x interval — SIGSTOP'd,
  deadlocked, or dead without a final beat (OOM-kill, preemption);
- ``exited``   the process committed a final beat with its exit code.

Zero-cost when telemetry is disabled: :func:`start_heartbeat` returns
``None`` without creating a thread, a file, or a directory.

Fault site: ``obs:heartbeat=<beat>`` fires before beat ``<beat>``'s
atomic commit — a ``kill`` there proves a death mid-heartbeat leaves the
previous (valid) file in place, never a torn one.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .. import faults
from ..ioutil import atomic_write_json, sweep_orphan_tmp
from . import registry, tracer

log = logging.getLogger(__name__)

HEALTH_DIRNAME = "health"
# heartbeat files older than STALE_FACTOR x their declared interval are
# stale — "within 2 heartbeat intervals", the monitor acceptance bound
STALE_FACTOR = 2.0

# registry counters folded into the headline progress fields; ANY counter
# movement refreshes last_progress_ts, these just get first-class columns
_ROWS_COUNTERS = ("stats.rows", "norm.rows", "eval.rows_scored",
                  "ingest.rows_emitted")
_PROGRESS_FIELDS = (("windows", "ingest.windows_emitted"),
                    ("trees", "train.trees"),
                    ("epochs", "train.epochs"))


def heartbeat_interval_s(override: Optional[float] = None) -> float:
    """Heartbeat cadence: explicit override > env ``SHIFU_TPU_HEARTBEAT_S``
    > property ``shifu.telemetry.heartbeatSeconds`` > 5 s."""
    if override is not None:
        return max(0.05, float(override))
    v = os.environ.get("SHIFU_TPU_HEARTBEAT_S")
    if v:
        try:
            return max(0.05, float(v))
        except ValueError:
            pass
    from ..config import environment
    p = environment.get_property("shifu.telemetry.heartbeatSeconds")
    if p is not None:
        try:
            return max(0.05, float(p))
        except (TypeError, ValueError):
            pass
    return 5.0


def health_dir_for(model_set_dir: str) -> str:
    return os.path.join(os.path.abspath(model_set_dir), "telemetry",
                        HEALTH_DIRNAME)


class HeartbeatWriter:
    """Background heartbeat thread for ONE process; see module docs."""

    def __init__(self, health_dir: str, step: Optional[str] = None,
                 proc: Optional[str] = None,
                 interval_s: Optional[float] = None,
                 extras_fn: Optional[Callable[[], Dict[str, Any]]] = None):
        self.health_dir = health_dir
        self.step = step
        self.pid = os.getpid()
        self.proc = proc or f"{(step or 'proc').lower()}-{self.pid}"
        self.interval_s = heartbeat_interval_s(interval_s)
        self.path = os.path.join(health_dir, f"{self.proc}.json")
        # per-beat extra fields (the serve plane's queue_depth /
        # queue_buildup / slo summary); failures are swallowed — a
        # broken extras hook must never stop the heartbeat
        self._extras_fn = extras_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started_ts = 0.0
        self._beats = 0
        self._last_progress_ts = 0.0
        self._last_counter_total: Optional[float] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "HeartbeatWriter":
        os.makedirs(self.health_dir, exist_ok=True)
        sweep_orphan_tmp(self.health_dir)   # a prior crash's .tmp droppings
        self._started_ts = time.time()
        self._last_progress_ts = self._started_ts
        self.beat()                          # beat 0: visible immediately
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="shifu-heartbeat")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.beat()
            except Exception:               # telemetry must never fail a step
                log.debug("heartbeat write failed", exc_info=True)

    def stop(self, exit_code: Optional[int] = None) -> None:
        """Retire the thread and commit a final ``state=exited`` beat so
        the monitor distinguishes a clean exit from a silent death."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(2.0, 2 * self.interval_s))
            self._thread = None
        try:
            self.beat(state="exited", exit_code=exit_code)
        except Exception:
            log.debug("final heartbeat write failed", exc_info=True)

    # ------------------------------------------------------------- one beat
    def beat(self, state: str = "running",
             exit_code: Optional[int] = None) -> Dict[str, Any]:
        rec = self._record(state, exit_code)
        faults.fire("obs", "heartbeat", self._beats, path=self.path)
        atomic_write_json(self.path, rec, indent=1)
        self._beats += 1
        return rec

    def _record(self, state: str,
                exit_code: Optional[int]) -> Dict[str, Any]:
        now = time.time()
        metrics = {m["name"]: m for m in registry.snapshot(reset=False)}
        counter_total = sum(m.get("value") or 0.0 for m in metrics.values()
                            if m.get("type") == "counter")
        if self._last_counter_total is None \
                or counter_total != self._last_counter_total:
            self._last_progress_ts = now
            self._last_counter_total = counter_total
        # per-thread deepest open span: what each thread is doing NOW
        spans: Dict[str, str] = {}
        for sp in tracer.live_spans():      # oldest first -> deepest wins
            spans[sp["thread"]] = sp["name"]
        registry.sample_device_memory()
        rec: Dict[str, Any] = {
            "kind": "health",
            "schema_version": tracer.SCHEMA_VERSION,
            "proc": self.proc,
            "pid": self.pid,
            "host": socket.gethostname(),
            "step": self.step,
            "state": state,
            "ts": round(now, 3),
            "started_ts": round(self._started_ts, 3),
            "interval_s": self.interval_s,
            "beat": self._beats,
            "phase": spans.get("MainThread"),
            "spans": spans,
            "rows": sum(metrics[n]["value"] for n in _ROWS_COUNTERS
                        if n in metrics),
            "last_progress_ts": round(self._last_progress_ts, 3),
        }
        for field, metric in _PROGRESS_FIELDS:
            if metric in metrics:
                rec[field] = metrics[metric]["value"]
        hbm = metrics.get("device.peak_bytes_in_use")
        if hbm and hbm.get("value") is not None:
            rec["device_peak_bytes"] = hbm["value"]
        if exit_code is not None:
            rec["exit_code"] = exit_code
        if self._extras_fn is not None:
            try:
                extras = self._extras_fn() or {}
            except Exception:
                log.debug("heartbeat extras hook failed", exc_info=True)
                extras = {}
            for k, v in extras.items():      # core fields always win
                rec.setdefault(k, v)
        return rec


def start_heartbeat(health_dir: str, step: Optional[str] = None,
                    proc: Optional[str] = None,
                    interval_s: Optional[float] = None,
                    extras_fn: Optional[Callable[[], Dict[str, Any]]] = None
                    ) -> Optional[HeartbeatWriter]:
    """Start the per-process heartbeat — ``None`` (no thread, no file, no
    directory) when telemetry is disabled."""
    if not tracer.enabled():
        return None
    return HeartbeatWriter(health_dir, step=step, proc=proc,
                           interval_s=interval_s,
                           extras_fn=extras_fn).start()


# ---------------------------------------------------------------- readers
def read_health(health_dir: str) -> List[Dict[str, Any]]:
    """All parseable health records under ``health_dir``, sorted by proc.
    Unparseable files are skipped with a warning (atomic writes make torn
    files impossible; a half-copied directory should not kill the
    monitor)."""
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(health_dir))
    except OSError:
        return out
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(health_dir, name)
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, json.JSONDecodeError):
            log.warning("skipping unparseable health file %s", path)
            continue
        if isinstance(rec, dict):
            rec["_file"] = path
            out.append(rec)
    return out


def classify(rec: Dict[str, Any], now: Optional[float] = None,
             stall_after_s: Optional[float] = None) -> str:
    """``live | stalled | stale | exited`` for one health record (see
    module docs for the model)."""
    now = time.time() if now is None else now
    if rec.get("state") == "exited":
        return "exited"
    interval = float(rec.get("interval_s") or 5.0)
    age = now - float(rec.get("ts") or 0.0)
    if age > STALE_FACTOR * interval:
        return "stale"
    if stall_after_s is None:
        stall_after_s = max(6 * interval, 30.0)
    if now - float(rec.get("last_progress_ts") or 0.0) > stall_after_s:
        return "stalled"
    return "live"
