"""Span tracer — nested wall-clock spans with a thread-safe collector; the
port of ``shifu_tpu.obs.tracer``.

JSONL schema (``SCHEMA_VERSION``, the reference's, so the reference's
``obs.report.load_blocks`` reads a trace this module flushed) — one JSON
object per line, keyed by ``kind``:

- ``meta``:   ``{kind, schema_version, step, ts, pid, backend}`` — opens
  a flush block;
- ``span``:   ``{kind, name, id, parent, ts, dur_s, tid, attrs}`` —
  ``parent`` is the enclosing span's ``id`` (``null`` for roots); ``ts``
  is epoch seconds at entry; durations come from ``time.perf_counter``;
- ``event``:  ``{kind, name, ts, parent, tid, attrs}`` — a point-in-time
  record;
- ``metric``: one registry instrument snapshot (see :mod:`.registry`).

The port has no executable-cost plane (the reference's ``obs.costs`` is
ROADMAP Queue 1 item 13), so a block carries no ``cost`` records.

Zero-cost when disabled: :func:`span` returns a shared no-op singleton
(one function call + one branch per call site), :func:`event` returns
immediately, :func:`fence` never touches the device.  :meth:`Span.fence`
/ :func:`fence` synchronise the CUDA device of the tensors they are
given (fencing mode only), so a span covers the device work it
launched.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

# the reference's schema version (v14: the one-parse offline pipeline's
# instruments; see shifu_tpu/obs/tracer.py for the history) — the port
# writes the same record layout
SCHEMA_VERSION = 14

_TRUE = ("1", "true", "on", "yes")

# tri-state enable: explicit set_enabled() override > cached env/property
# lookup.  The cache keeps enabled() at one global read + branch on the
# hot path; reset_for_tests()/set_enabled(None) clears it.
_enabled_override: Optional[bool] = None
_enabled_cache: Optional[bool] = None
_fence_cache: Optional[bool] = None


def _truthy(v: Optional[str]) -> bool:
    return v is not None and str(v).strip().lower() in _TRUE


def _lookup(env_key: str, *prop_keys: str) -> bool:
    v = os.environ.get(env_key)
    if v is None:
        from ..config import environment
        for k in prop_keys:
            v = environment.get_property(k)
            if v is not None:
                break
    return _truthy(v)


def enabled() -> bool:
    """Is telemetry on?  env ``SHIFU_TPU_TELEMETRY`` / property
    ``shifu.telemetry`` / :func:`set_enabled` (CLI ``--telemetry``)."""
    if _enabled_override is not None:
        return _enabled_override
    global _enabled_cache
    if _enabled_cache is None:
        _enabled_cache = _lookup("SHIFU_TPU_TELEMETRY",
                                 "shifu.telemetry", "shifu.tpu.telemetry")
    return _enabled_cache


def set_enabled(value: Optional[bool]) -> None:
    """Programmatic override (CLI flag, tests); ``None`` restores the
    env/property lookup."""
    global _enabled_override, _enabled_cache, _fence_cache
    _enabled_override = value
    _enabled_cache = None
    _fence_cache = None


def fencing_enabled() -> bool:
    """Fenced spans: a device synchronise at :meth:`Span.fence` so a
    span's wall-clock covers the device work it launched, not just the
    dispatch.  Env ``SHIFU_TPU_TELEMETRY_FENCE`` / property
    ``shifu.telemetry.fence``; only active while telemetry is on."""
    global _fence_cache
    if not enabled():
        return False
    if _fence_cache is None:
        _fence_cache = _lookup("SHIFU_TPU_TELEMETRY_FENCE",
                               "shifu.telemetry.fence")
    return _fence_cache


# ------------------------------------------------------------- collector
class _Collector:
    """Thread-safe record buffer + per-thread span stack."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._records: List[Dict[str, Any]] = []
        self._tls = threading.local()
        self._next_id = 0
        # id -> (name, thread name, entry ts) for spans currently OPEN —
        # the heartbeat thread (obs/health) reads this to report what
        # each thread is doing *right now*, between record flushes
        self._live: Dict[int, tuple] = {}

    def new_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    @property
    def stack(self) -> List[int]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current_parent(self) -> Optional[int]:
        st = self.stack
        return st[-1] if st else None

    def add(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._records.append(rec)

    def span_opened(self, span_id: int, name: str, ts: float) -> None:
        with self._lock:
            self._live[span_id] = (name, threading.current_thread().name,
                                   ts)

    def span_closed(self, span_id: int) -> None:
        with self._lock:
            self._live.pop(span_id, None)

    def live_spans(self) -> List[Dict[str, Any]]:
        """Currently-open spans, oldest first (heartbeat surface)."""
        with self._lock:
            return [{"id": i, "name": n, "thread": t, "ts": ts}
                    for i, (n, t, ts) in sorted(self._live.items())]

    def drain(self) -> List[Dict[str, Any]]:
        with self._lock:
            out, self._records = self._records, []
            return out

    def peek(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._live.clear()
        self._tls = threading.local()


_collector = _Collector()


class Span:
    """A live span; use via ``with span("name", k=v) as sp:``.  Extra
    attributes attach with :meth:`set`; :meth:`fence` blocks on device
    values when fencing is on so the duration covers real work."""

    __slots__ = ("name", "attrs", "id", "parent", "_ts", "_t0")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.id = _collector.new_id()
        self.parent: Optional[int] = None
        self._ts = 0.0
        self._t0 = 0.0

    def __enter__(self) -> "Span":
        self.parent = _collector.current_parent()
        _collector.stack.append(self.id)
        self._ts = time.time()
        self._t0 = time.perf_counter()
        _collector.span_opened(self.id, self.name, self._ts)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
        st = _collector.stack
        if st and st[-1] == self.id:
            st.pop()
        _collector.span_closed(self.id)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        _collector.add({"kind": "span", "name": self.name, "id": self.id,
                        "parent": self.parent, "ts": round(self._ts, 3),
                        "dur_s": round(dur, 6),
                        "tid": threading.current_thread().name,
                        "attrs": self.attrs})
        return False

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def fence(self, value: Any) -> Any:
        """Block until ``value``'s device buffers are ready (fencing mode
        only) so async dispatch doesn't flatter this span; returns the
        value either way."""
        return fence(value)


class _NullSpan:
    """Shared no-op span: the disabled path allocates nothing."""

    __slots__ = ()
    id = None
    parent = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def fence(self, value: Any) -> Any:
        return value


_NULL_SPAN = _NullSpan()


def span(name: str, /, **attrs: Any):
    """Open a (nested) span.  No-op singleton when telemetry is off."""
    if not enabled():
        return _NULL_SPAN
    return Span(name, attrs)


def event(name: str, /, **attrs: Any) -> None:
    """Record a point-in-time event under the current span (per-epoch
    trainer metrics, early stops, ...)."""
    if not enabled():
        return
    _collector.add({"kind": "event", "name": name,
                    "ts": round(time.time(), 3),
                    "parent": _collector.current_parent(),
                    "tid": threading.current_thread().name, "attrs": attrs})


def record_span(name: str, ts: float, dur_s: float,
                attrs: Optional[Dict[str, Any]] = None,
                tid: Optional[str] = None,
                parent: Optional[int] = None) -> Optional[int]:
    """Record an externally-timed span.  Producers whose spans start and
    end on DIFFERENT threads (the serve plane: a request enters on the
    caller's thread and completes on the batcher worker) measure with
    their own perf counters and emit the finished span here; ``tid``
    overrides the track label (e.g. ``shifu-serve``).  Returns the span
    id, or None (no allocation) when telemetry is off."""
    if not enabled():
        return None
    sid = _collector.new_id()
    _collector.add({"kind": "span", "name": name, "id": sid,
                    "parent": parent, "ts": round(float(ts), 6),
                    "dur_s": round(float(dur_s), 6),
                    "tid": tid or threading.current_thread().name,
                    "attrs": dict(attrs or {})})
    return sid


def fence(value: Any) -> Any:
    """Module-level fence for call sites without a span handle."""
    if fencing_enabled():
        _synchronize(value)
    return value


def _synchronize(value: Any) -> None:
    """``torch.cuda.synchronize`` on the device of every CUDA tensor in
    ``value`` (a tensor or a list/tuple of them); a no-op for CPU tensors
    and host values."""
    items = value if isinstance(value, (list, tuple)) else (value,)
    devices = {v.device for v in items
               if getattr(getattr(v, "device", None), "type", None) == "cuda"}
    if devices:
        import torch
        for d in devices:
            torch.cuda.synchronize(d)


def pending_records() -> List[Dict[str, Any]]:
    """Snapshot of not-yet-flushed records (tests, bench)."""
    return _collector.peek()


def live_spans() -> List[Dict[str, Any]]:
    """Spans currently open across ALL threads (the heartbeat's 'what is
    this process doing right now' surface).  Empty when disabled."""
    if not enabled():
        return []
    return _collector.live_spans()


def flush(path: str, step: Optional[str] = None,
          extra_meta: Optional[Dict[str, Any]] = None) -> bool:
    """Append the buffered spans/events plus a registry snapshot to
    ``path`` as one JSONL block opened by a ``meta`` line, then clear
    both.  Returns False (and writes nothing) when telemetry is off."""
    if not enabled():
        return False
    from . import registry
    records = _collector.drain()
    metrics = registry.snapshot(reset=True)
    meta: Dict[str, Any] = {"kind": "meta", "schema_version": SCHEMA_VERSION,
                            "step": step, "ts": round(time.time(), 3),
                            "pid": os.getpid(),
                            "backend": backend_info()}
    if extra_meta:
        meta.update(extra_meta)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # append-only trace sink by design: each flush appends a block;
    # every reader skips a torn final line
    with open(path, "a") as f:
        for rec in [meta] + records + metrics:
            f.write(json.dumps(rec) + "\n")
    return True


def backend_info() -> Dict[str, str]:
    """(platform, device_kind) stamped into the flush meta: ``gpu`` and
    the card's name when CUDA is up, else ``cpu``."""
    try:
        import torch
        if torch.cuda.is_available():
            return {"platform": "gpu",
                    "device_kind": torch.cuda.get_device_name(0)}
    except Exception:                      # noqa: BLE001 — best effort
        pass
    return {"platform": "cpu", "device_kind": "cpu"}


def reset_for_tests() -> None:
    from .registry import get_registry
    set_enabled(None)
    _collector.clear()
    get_registry().reset()
