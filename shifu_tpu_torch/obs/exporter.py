"""Metrics snapshots — periodic OpenMetrics-text + JSON registry dumps;
the port of ``shifu_tpu.obs.exporter`` (byte-equal exposition for the
same records).

One export format for every consumer: an external scraper (Prometheus
file-sd / node-exporter textfile collector) reads
``<modelset>/telemetry/metrics.prom``, anything programmatic (our bench,
the monitor, dashboards) reads the sibling ``metrics.json``; both are
rendered from the SAME registry snapshot so they can never disagree.

Naming is schema-versioned: every metric name is prefixed
``shifu_tpu_`` and sanitized to the OpenMetrics charset (dots become
underscores: ``ingest.bytes_read`` -> ``shifu_tpu_ingest_bytes_read``),
counters get the conventional ``_total`` suffix, and every exposition
carries ``shifu_tpu_telemetry_schema_version`` so a scraper can detect a
layout change instead of silently mis-joining series (the same contract
as the bench/obs schema handshake).

Histograms export as summaries: ``_count`` + ``_sum`` (counters),
``{quantile="0.5"}`` / ``{quantile="0.99"}`` sample lines (the registry
histogram's fixed-bin log sketch, schema v8 — the OpenMetrics summary
convention, so a scraper gets p50/p99 without buckets) and ``_min`` /
``_max`` / ``_last`` gauges (see
:class:`.registry.Histogram`).

:class:`MetricsExporter` is the periodic writer: a daemon thread dumping
both files through :mod:`ioutil` atomic writes every ``interval_s`` (the
heartbeat cadence by default), plus a final dump at ``stop()`` so the
last scrape of a finished step sees its closing totals.  Zero-cost when
telemetry is disabled: :func:`start_exporter` returns ``None``.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional

from ..ioutil import atomic_write_json, atomic_write_text
from . import registry, tracer

log = logging.getLogger(__name__)

METRICS_PROM_BASENAME = "metrics.prom"
METRICS_JSON_BASENAME = "metrics.json"
NAME_PREFIX = "shifu_tpu_"

_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")


def metric_name(name: str) -> str:
    """Registry name -> OpenMetrics name: prefix + charset sanitize."""
    n = _SANITIZE.sub("_", name)
    if not n or not (n[0].isalpha() or n[0] == "_"):
        n = "_" + n
    return NAME_PREFIX + n


def _fmt(v: Any) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def render_openmetrics(records: Optional[List[Dict[str, Any]]] = None
                       ) -> str:
    """The OpenMetrics text exposition for a registry snapshot (the
    current registry when ``records`` is None)."""
    if records is None:
        records = registry.snapshot(reset=False)
    lines: List[str] = []
    ver = metric_name("telemetry.schema_version")
    lines += [f"# TYPE {ver} gauge",
              f"{ver} {tracer.SCHEMA_VERSION}"]
    for rec in records:
        name = metric_name(rec["name"])
        kind = rec.get("type")
        if kind == "counter":
            lines += [f"# TYPE {name} counter",
                      f"{name}_total {_fmt(rec.get('value'))}"]
        elif kind == "gauge":
            lines += [f"# TYPE {name} gauge",
                      f"{name} {_fmt(rec.get('value'))}"]
        elif kind == "histogram":
            lines += [f"# TYPE {name} summary",
                      f"{name}_count {_fmt(rec.get('count'))}",
                      f"{name}_sum {_fmt(rec.get('sum'))}"]
            # quantile sample lines (summary convention): p50/p99 from
            # the registry histogram's log sketch; pre-v8 records carry
            # no quantiles and render the plain summary as before
            for q, key in (("0.5", "p50"), ("0.99", "p99")):
                if rec.get(key) is not None:
                    lines.append(
                        f'{name}{{quantile="{q}"}} {_fmt(rec.get(key))}')
            for stat in ("min", "max", "last"):
                sname = f"{name}_{stat}"
                lines += [f"# TYPE {sname} gauge",
                          f"{sname} {_fmt(rec.get(stat))}"]
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def snapshot_document(step: Optional[str] = None) -> Dict[str, Any]:
    """The JSON-flavoured snapshot (same registry read as the text
    exposition)."""
    return {
        "kind": "metrics_snapshot",
        "schema_version": tracer.SCHEMA_VERSION,
        "step": step,
        "ts": round(time.time(), 3),
        "pid": os.getpid(),
        "metrics": registry.snapshot(reset=False),
    }


def write_metrics_files(telemetry_dir: str,
                        step: Optional[str] = None) -> None:
    """One synchronized dump of both formats (atomic, crash-safe)."""
    os.makedirs(telemetry_dir, exist_ok=True)
    doc = snapshot_document(step=step)
    atomic_write_json(os.path.join(telemetry_dir, METRICS_JSON_BASENAME),
                      doc, indent=1)
    atomic_write_text(os.path.join(telemetry_dir, METRICS_PROM_BASENAME),
                      render_openmetrics(doc["metrics"]))


class MetricsExporter:
    """Periodic background dump of the registry; see module docs."""

    def __init__(self, telemetry_dir: str, step: Optional[str] = None,
                 interval_s: Optional[float] = None):
        from .health import heartbeat_interval_s
        self.telemetry_dir = telemetry_dir
        self.step = step
        self.interval_s = heartbeat_interval_s(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsExporter":
        self._write()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="shifu-metrics-exporter")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._write()

    def _write(self) -> None:
        try:
            write_metrics_files(self.telemetry_dir, step=self.step)
        except Exception:                   # telemetry must never fail a step
            log.debug("metrics export failed", exc_info=True)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(2.0, 2 * self.interval_s))
            self._thread = None
        self._write()                        # closing totals for scrapers


def start_exporter(telemetry_dir: str, step: Optional[str] = None,
                   interval_s: Optional[float] = None
                   ) -> Optional[MetricsExporter]:
    """Start the periodic exporter — ``None`` (no thread, no files) when
    telemetry is disabled."""
    if not tracer.enabled():
        return None
    return MetricsExporter(telemetry_dir, step=step,
                           interval_s=interval_s).start()
