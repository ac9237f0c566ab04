"""Serving-plane observability — the port of ``shifu_tpu.obs``' facade,
with the reference's names for every module it ports.

Modules:

- :mod:`tracer` — nested wall-clock spans (optionally fenced with a CUDA
  synchronise) + point events, thread-safe collector with a live-span
  registry, JSONL sink in the reference's record layout;
- :mod:`registry` — named counters/gauges/histograms and the device
  memory sample;
- :mod:`manifest` — the declared metric and span names;
- :mod:`slo` — sliding-window latency quantiles, availability and
  burn-rate alerts, and the brownout governor;
- :mod:`health` — per-process heartbeat files under
  ``<modelset>/telemetry/health/``;
- :mod:`exporter` — periodic ``metrics.prom`` / ``metrics.json``;
- :mod:`scorelog` — sampled, crash-safe prediction segments under
  ``<modelset>/telemetry/scorelog/``;
- :mod:`outcomes` — the delayed-label join;
- :mod:`quality` — per-generation live AUC / calibration / score-PSI
  against eval's ``telemetry/posttrain.json``.

The reference's ``costs`` (``costed_jit``, ``record_executable``),
``drift``'s monitor, ``monitor``, ``report``, ``timeline``,
``utilization`` and ``profiler`` are not here: they are ROADMAP Queue 1
item 13.

Everything is zero-cost when disabled (the default): ``span()`` returns
a shared no-op singleton, instruments are no-op singletons, heartbeat
and exporter factories return ``None`` — no threads, no fencing, no
files.  Enable with env ``SHIFU_TPU_TELEMETRY=1`` or property
``-Dshifu.telemetry=on``.
"""

from .registry import (counter, gauge, histogram,             # noqa: F401
                       sample_device_memory, snapshot, get_registry)
from .tracer import (SCHEMA_VERSION, enabled, set_enabled,    # noqa: F401
                     fencing_enabled, span, event, fence, flush,
                     record_span, pending_records, live_spans,
                     reset_for_tests)
from .manifest import (MANIFEST, PREFIXES, SPANS,             # noqa: F401
                       SPAN_PREFIXES, is_declared, is_declared_span)
from .slo import (SLOTracker, LogBins, LOG_BINS,              # noqa: F401
                  quantile_from_counts, slo_objectives,
                  BrownoutGovernor)
from .health import (HeartbeatWriter, start_heartbeat,        # noqa: F401
                     read_health, classify, health_dir_for,
                     heartbeat_interval_s)
from .exporter import (MetricsExporter, start_exporter,       # noqa: F401
                       render_openmetrics, write_metrics_files,
                       metric_name)
from .scorelog import (ScoreLog, read_score_records,          # noqa: F401
                       scorelog_dir, scorelog_sample_rate)
from .outcomes import (OutcomeJoiner, outcomes_drop_dir,      # noqa: F401
                       outcome_watermark_s)
from .quality import (QualityMonitor, start_quality_monitor,  # noqa: F401
                      write_posttrain_snapshot,
                      load_posttrain_snapshot, psi_threshold,
                      posttrain_snapshot_path, quality_artifact_path)

__all__ = [
    # tracer
    "SCHEMA_VERSION", "enabled", "set_enabled", "fencing_enabled",
    "span", "event", "fence", "flush", "record_span", "pending_records",
    "live_spans", "reset_for_tests",
    # registry
    "counter", "gauge", "histogram", "sample_device_memory", "snapshot",
    "get_registry",
    # manifest
    "MANIFEST", "PREFIXES", "SPANS", "SPAN_PREFIXES", "is_declared",
    "is_declared_span",
    # SLO plane
    "SLOTracker", "LogBins", "LOG_BINS", "quantile_from_counts",
    "slo_objectives", "BrownoutGovernor",
    # health
    "HeartbeatWriter", "start_heartbeat", "read_health", "classify",
    "health_dir_for", "heartbeat_interval_s",
    # exporter
    "MetricsExporter", "start_exporter", "render_openmetrics",
    "write_metrics_files", "metric_name",
    # model-quality plane
    "ScoreLog", "read_score_records", "scorelog_dir",
    "scorelog_sample_rate", "OutcomeJoiner", "outcomes_drop_dir",
    "outcome_watermark_s", "QualityMonitor", "start_quality_monitor",
    "write_posttrain_snapshot", "load_posttrain_snapshot",
    "psi_threshold", "posttrain_snapshot_path", "quality_artifact_path",
]
