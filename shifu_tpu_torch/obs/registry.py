"""Metrics registry — named counters/gauges/histograms, host-side only;
the port of ``shifu_tpu.obs.registry``.

The role the reference's Hadoop counters played (rows processed, records
filtered, per-job timings aggregated by the JobTracker): one process-wide
registry every plane reports into, snapshotted into the telemetry JSONL
at each step flush.

Conventions:

- metrics are recorded HOST-SIDE only: instruments coerce through
  ``float()`` (a one-element CUDA tensor would force a device sync, so
  call sites fetch the value first);
- instruments are created on first use and aggregate for the life of the
  step (the step flush resets them);
- when telemetry is disabled every factory returns a shared no-op
  instrument — zero allocation, zero lock traffic.

Device accounting: :func:`sample_device_memory` — the CUDA caching
allocator's in-use/peak/reserved bytes of the current card
(``torch.cuda.memory_stats``; skipped without CUDA).  The reference's
``ensure_compile_listener`` (XLA compile accounting) has no counterpart:
the port compiles nothing after warm, and the serve plane's capture
count (``serve.scorer.serve_capture_count``) takes its place.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np

from . import tracer
from .slo import LOG_BINS, quantile_from_counts


# Instruments are THREAD-SAFE: ``ingest.*`` counters increment from the
# ``prepared()`` background prep thread while trainers update ``train.*``
# on the main thread, and the heartbeat/exporter threads (obs/health,
# obs/exporter) snapshot the same instruments concurrently.  A bare
# ``self.value += n`` is a read-modify-write the GIL does NOT make atomic
# (the interpreter can switch between the load and the store), so every
# mutation and every read-out takes the instrument's own lock.
class Counter:
    """Monotonic accumulator (rows processed, epochs, trees built)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        n = float(n)
        with self._lock:
            self.value += n

    def to_record(self) -> Dict[str, Any]:
        with self._lock:
            return {"kind": "metric", "type": "counter", "name": self.name,
                    "value": self.value}


class Gauge:
    """Last-value instrument with a high-water option (loss, throughput,
    device-memory peak)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.value = v

    def set_max(self, v: float) -> None:
        v = float(v)
        with self._lock:
            if self.value is None or v > self.value:
                self.value = v

    def to_record(self) -> Dict[str, Any]:
        with self._lock:
            return {"kind": "metric", "type": "gauge", "name": self.name,
                    "value": self.value}


class Histogram:
    """Streaming summary (count/sum/min/max/last) plus a fixed-bin LOG
    sketch (:data:`shifu_tpu.obs.slo.LOG_BINS`) so snapshots carry
    p50/p99 estimates (schema v8) — still no per-observation storage."""

    __slots__ = ("name", "count", "sum", "min", "max", "last", "_bins",
                 "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.last: Optional[float] = None
        self._bins = np.zeros(LOG_BINS.n, np.int64)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = LOG_BINS.index(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None or v < self.min else self.min
            self.max = v if self.max is None or v > self.max else self.max
            self.last = v
            self._bins[i] += 1

    @property
    def mean(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> Optional[float]:
        """Sketch-resolution quantile (~6.6% relative error per bin)."""
        with self._lock:
            return quantile_from_counts(self._bins, q, LOG_BINS)

    def _q(self, q: float) -> Optional[float]:
        v = quantile_from_counts(self._bins, q, LOG_BINS)
        return None if v is None else round(v, 9)

    def to_record(self) -> Dict[str, Any]:
        with self._lock:
            return {"kind": "metric", "type": "histogram", "name": self.name,
                    "count": self.count, "sum": round(self.sum, 6),
                    "min": self.min, "max": self.max, "last": self.last,
                    "p50": self._q(0.50), "p99": self._q(0.99)}


class _NullInstrument:
    """Shared no-op standing in for every instrument when disabled."""

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def set_max(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL = _NullInstrument()


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, Any] = {}

    def _get(self, name: str, cls):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name)
            elif not isinstance(inst, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(inst).__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self, reset: bool = False) -> List[Dict[str, Any]]:
        with self._lock:
            recs = [inst.to_record()
                    for _, inst in sorted(self._instruments.items())]
            if reset:
                self._instruments.clear()
            return recs

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _registry


def counter(name: str):
    return _registry.counter(name) if tracer.enabled() else _NULL


def gauge(name: str):
    return _registry.gauge(name) if tracer.enabled() else _NULL


def histogram(name: str):
    return _registry.histogram(name) if tracer.enabled() else _NULL


def snapshot(reset: bool = False) -> List[Dict[str, Any]]:
    return _registry.snapshot(reset=reset)


# -------------------------------------------------------- device helpers
def sample_device_memory() -> None:
    """Record device-memory gauges for the current CUDA card (the
    per-step high-water mark): ``device.bytes_in_use`` /
    ``device.peak_bytes_in_use`` from the caching allocator's stats and
    ``device.bytes_limit`` from the card's total memory.  Skipped when
    telemetry is off or no CUDA card is up."""
    if not tracer.enabled():
        return
    try:
        import torch
        if not torch.cuda.is_available() \
                or not torch.cuda.is_initialized():
            return
        stats = torch.cuda.memory_stats()
        limit = torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory
    except Exception:                      # noqa: BLE001 — best effort
        return
    for value, metric in (
            (stats.get("allocated_bytes.all.current"),
             "device.bytes_in_use"),
            (stats.get("allocated_bytes.all.peak"),
             "device.peak_bytes_in_use"),
            (limit, "device.bytes_limit")):
        if value is not None:
            _registry.gauge(metric).set_max(value)
