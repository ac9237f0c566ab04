"""Metric-name manifest — the port's plain copy of
``shifu_tpu.obs.manifest``, the one registry of declared instrument names.

Every ``obs.counter("...")`` / ``obs.gauge("...")`` /
``obs.histogram("...")`` call site in ``shifu_tpu_torch/`` names a
metric declared here (or starts with a declared dynamic-family prefix),
because the registry's create-on-first-use convenience
has a failure mode that is otherwise silent: a typo'd name at one call
site quietly creates a NEW metric, the dashboards / bench joins keep
reading the old (now frozen) one, and nothing errors anywhere.

Declaring a metric: ``MANIFEST[name] = (type, help)``.  Families whose
member names are data-dependent (per-eval-set AUC, bench extras) declare
a prefix in ``PREFIXES`` instead — f-string call sites must start with
one of them.

SPAN names get the same treatment (``SPANS`` / ``SPAN_PREFIXES``): the
timeline/report joins key on span-name literals, so a typo'd span name
would silently vanish from every report.  Root spans named after the
step (``obs.span(self.profile_name, ...)``) are variables, not
literals, and ride outside the lint.
"""

from __future__ import annotations

from typing import Dict, Tuple

# name -> (instrument type, one-line help)
MANIFEST: Dict[str, Tuple[str, str]] = {
    # ---- ingest plane (spill cache / window prep / H2D pipeline)
    "ingest.bytes_read": ("counter", "bytes materialized into windows"),
    "ingest.windows_emitted": ("counter", "windows yielded to consumers"),
    "ingest.rows_emitted": ("counter", "valid rows in emitted windows"),
    "ingest.h2d_wait_seconds": ("counter",
                                "consumer time blocked on window prep/H2D"),
    "ingest.disk_passes": ("counter", "full/tail stream traversals"),
    "ingest.spill_hits": ("counter", "sweeps served from the mmap spill"),
    "ingest.spill_misses": ("counter", "sweeps that re-read npz shards"),
    "ingest.retries": ("counter", "transient IO errors absorbed by retry"),
    "ingest.rows_padded": ("counter",
                           "zero-weight pad rows added to fill windows"),
    "ingest.parse_stall_frac": ("gauge",
                                "fraction of the parse-pool consumer "
                                "loop spent blocked on parse futures "
                                "(~0 = parse hidden, ~1 = parse-bound)"),
    # ---- one-parse raw cache (data/rawcache)
    "rawcache.hits": ("counter",
                      "raw passes served from the columnar raw cache "
                      "(zero string-plane touch)"),
    "rawcache.misses": ("counter",
                        "raw passes that parsed the string plane with "
                        "a cache root configured"),
    "rawcache.bytes_written": ("counter",
                               "decoded-column bytes committed into "
                               "the raw cache"),
    # ---- data hygiene
    "data.quarantined_rows": ("counter", "rows quarantined as unreadable"),
    "data.quarantined_shards": ("counter", "shards quarantined as torn"),
    # ---- stats plane
    "stats.rows": ("counter", "rows swept by the stats accumulators"),
    "stats.columns": ("gauge", "columns in the stats sweep"),
    "stats.rows_per_sec": ("gauge", "stats sweep throughput"),
    "stats.resumed_chunks": ("counter", "chunks skipped via mid-sweep resume"),
    # ---- norm plane
    "norm.rows": ("counter", "rows materialized by norm"),
    "norm.shards": ("gauge", "shards written by norm"),
    "norm.rows_per_sec": ("gauge", "norm throughput"),
    "norm.resumed_shards": ("counter", "committed shards verified on resume"),
    # ---- train plane
    "train.epochs": ("counter", "epochs completed (NN/LR/WDL/SVM)"),
    "train.epoch_s": ("histogram", "per-epoch wall-clock"),
    "train.trees": ("counter", "trees built (GBT/RF/DT)"),
    "train.trees_built": ("gauge", "final forest size of the last trainer"),
    "train.valid_err": ("gauge", "last validation error"),
    "train.host_syncs": ("counter", "device->host value-forcing fetches"),
    "train.tail_sweeps": ("counter", "disk-tail re-streams paid"),
    "train.tail_repairs": ("counter", "c2f speculation repairs"),
    "train.tail_repair_levels": ("counter", "levels regrown by repairs"),
    "train.tail_c2f_fallbacks": ("counter",
                                 "c2f auto-fallbacks to the exact schedule"),
    # ---- WDL sharded categorical plane (train/wdl_shard)
    "wdl.shard_devices": ("gauge", "data-axis shards each WDL table "
                                   "splits over"),
    "wdl.shard_table_bytes": ("gauge", "per-device bytes of table params "
                                       "+ optimizer moments"),
    "wdl.hash_buckets": ("gauge", "hashed-ID bucket space (0 = exact ids)"),
    "wdl.hashed_cols": ("gauge", "categorical columns on the hashed-ID "
                                 "path"),
    "wdl.serve_shard_devices": ("gauge", "devices the serve-time sharded "
                                         "table copy spans"),
    # ---- eval plane (per-set AUC gauges ride the eval. prefix)
    "eval.rows_scored": ("counter", "eval rows scored"),
    "eval.rows_per_sec": ("gauge", "eval scoring throughput"),
    # ---- varselect plane
    "varsel.host_syncs": ("counter", "varselect packed fetches"),
    "varsel.mask_batches": ("counter", "mask-batched programs dispatched"),
    "varsel.windows": ("counter", "windows swept by varselect"),
    "varsel.rows_per_sec": ("gauge", "varselect throughput"),
    "varsel.candidates": ("gauge", "candidate columns scored"),
    # ---- device / XLA accounting (registry-internal writers)
    "device.bytes_in_use": ("gauge", "HBM in use (high-water sampled)"),
    "device.peak_bytes_in_use": ("gauge", "HBM peak"),
    "device.bytes_limit": ("gauge", "HBM capacity"),
    "xla.compile_count": ("counter", "XLA compilations observed"),
    "xla.compile_time_s": ("counter", "XLA compile wall-clock"),
    # ---- cost-attribution plane (obs/costs)
    "xla.recompiles": ("counter",
                       "costed executables rebuilt for a NEW input "
                       "signature (the shape-churn sentinel)"),
    "xla.launches": ("counter", "costed executable launches"),
    # ---- serving plane (serve/)
    "serve.requests": ("counter",
                       "scoring requests accepted (one per submit; "
                       "row volume is serve.rows_scored)"),
    "serve.rows_scored": ("counter", "request rows scored"),
    "serve.batches": ("counter", "padded-bucket device launches"),
    "serve.rows_padded": ("counter",
                          "pad rows added to fill serve buckets"),
    "serve.flush_full": ("counter", "flushes triggered by a full bucket"),
    "serve.flush_deadline": ("counter",
                             "flushes triggered by the maxDelayMs "
                             "deadline"),
    "serve.request_errors": ("counter", "batches failed in-flight"),
    "serve.swaps": ("counter", "model hot-swaps promoted"),
    "serve.rollbacks": ("counter",
                        "registry re-flips to the previous generation "
                        "(probation failure or operator rollback)"),
    "serve.trace_sampled": ("counter",
                            "requests head-sampled into per-request "
                            "tracing (shifu.serve.traceSampleRate)"),
    "serve.queue_depth": ("gauge",
                          "rows currently queued (set at each flush and "
                          "sampled into SERVE heartbeats/healthz — the "
                          "queue-buildup early warning)"),
    "serve.bucket_occupancy": ("histogram",
                               "real rows / bucket size per launch "
                               "(p50/p99 land in metrics.prom)"),
    "serve.bucket_rungs_added": ("counter",
                                 "ladder rungs added by occupancy-"
                                 "driven refinement (compiled ahead of "
                                 "use)"),
    "serve.batch_latency_ms": ("histogram",
                               "oldest-request latency per batch"),
    # ---- overload protection (serve/overload; bounded admission +
    # deadline shedding + brownout)
    "serve.shed_overload": ("counter",
                            "submits rejected at the maxQueueRows "
                            "admission cap (coded 429/overloaded)"),
    "serve.shed_expired": ("counter",
                           "queued requests shed because their deadline "
                           "passed before pad/launch (coded 504)"),
    "serve.cancelled": ("counter",
                        "client-abandoned tickets (wait timed out) shed "
                        "from the queue before launch"),
    "serve.mode": ("gauge",
                   "serving mode: 0 normal, 1 brownout (degraded under "
                   "sustained burn/queue stress)"),
    "serve.brownouts": ("counter", "brownout-mode entries (lifetime)"),
    # ---- raw-record serving (serve/transform fused into the scorer)
    "serve.raw_requests": ("counter",
                           "raw-record scoring requests accepted "
                           "(POST /score with records)"),
    "serve.raw_rows": ("counter",
                       "raw records parsed and scored through the "
                       "fused-transform executable"),
    "serve.raw_rejects": ("counter",
                          "malformed raw records rejected per-record "
                          "with a coded error (the rest of the request "
                          "still scores)"),
    # ---- serving fleet (serve/router)
    "serve.fleet_replicas_up": ("gauge",
                                "replicas in rotation after the last "
                                "health sweep"),
    "serve.fleet_requeues": ("counter",
                             "requests requeued on a peer after a "
                             "replica died mid-flight"),
    "serve.fleet_drains": ("counter",
                           "replicas pulled from rotation (SLO burn, "
                           "stale heartbeat, or death)"),
    "serve.fleet_swaps": ("counter",
                          "coordinated fleet-wide hot-swaps driven "
                          "through the router"),
    "serve.fleet_hedges": ("counter",
                           "hedged second dispatches fired after the "
                           "p99 hedge delay (first response wins)"),
    "serve.fleet_breaker_opens": ("counter",
                                  "replica circuit breakers opened on "
                                  "consecutive transport/5xx failures"),
    "serve.fleet_retry_denied": ("counter",
                                 "requeues shed because the retry "
                                 "budget was exhausted (coded 429)"),
    # ---- live SLO plane (obs/slo; mirrored into metrics.prom each beat)
    "slo.p50_ms": ("gauge", "sliding-window latency p50 (log sketch)"),
    "slo.p99_ms": ("gauge", "sliding-window latency p99 (log sketch)"),
    "slo.availability": ("gauge", "observed availability over the ring"),
    "slo.burn_rate_short": ("gauge",
                            "max error-budget burn over the short "
                            "(current-window) horizon"),
    "slo.burn_rate_long": ("gauge",
                           "max error-budget burn over the long "
                           "(whole-ring) horizon"),
    "slo.alerts_firing": ("gauge", "burn-rate alert rules currently firing"),
    # ---- elastic DCN plane (parallel/elastic, parallel/mesh)
    "dcn.connect_retries": ("counter",
                            "coordinator connect failures absorbed by "
                            "the bounded backoff ladder"),
    "dcn.steps_closed": ("counter", "elastic steps this controller "
                                    "closed (won the exclusive commit)"),
    "dcn.step_timeouts": ("counter",
                          "elastic steps closed on stepTimeoutMs with "
                          "stragglers outstanding"),
    "dcn.step_wait_seconds": ("counter",
                              "time blocked waiting for quorum/close "
                              "(the straggler-masking cost)"),
    "dcn.late_applied": ("counter",
                         "late contributions folded into a later close "
                         "within the staleness window"),
    "dcn.late_dropped": ("counter",
                         "late contributions dropped past the staleness "
                         "window (quorum mode drops all)"),
    "dcn.catchup_steps": ("counter",
                          "steps replayed from the close journal "
                          "instead of recomputed"),
    "dcn.rejoins": ("counter",
                    "controller restarts that rejoined a live job "
                    "(incarnation > 1)"),
    "dcn.membership_epoch": ("gauge",
                             "current membership epoch (bumps on "
                             "join/leave/rejoin)"),
    "dcn.live_members": ("gauge",
                         "controllers the heartbeat staleness rule "
                         "considers alive"),
    # ---- continual refresh plane (refresh/)
    "refresh.triggers": ("counter",
                         "refresh cycles started (PSI breach or "
                         "schedule)"),
    "refresh.skips": ("counter",
                      "triggers suppressed by the cooldown guard"),
    "refresh.retrains": ("counter", "warm retrains run"),
    "refresh.promotions": ("counter",
                           "candidates hot-swapped into serving after "
                           "passing the AUC gate"),
    "refresh.rejections": ("counter",
                           "candidates archived on AUC regression "
                           "(incumbent stays live)"),
    "refresh.rollbacks": ("counter",
                          "promotions rolled back in probation (SLO "
                          "burn / canary parity)"),
    "refresh.state": ("gauge",
                      "controller state: 0 idle, 1 training, "
                      "2 probation"),
    "refresh.generation": ("gauge", "serving generation under refresh"),
    "refresh.cycle": ("gauge", "refresh cycles begun (lifetime)"),
    # ---- drift monitor (obs/drift)
    "drift.rows": ("gauge", "rows folded into the live drift counts"),
    "drift.columns_tracked": ("gauge", "columns with a training snapshot"),
    "drift.columns_flagged": ("gauge", "columns with PSI over threshold"),
    "drift.psi_max": ("gauge", "max per-column PSI vs training snapshot"),
    "drift.psi_mean": ("gauge", "mean per-column PSI vs training snapshot"),
    # ---- model-quality plane (obs/scorelog, obs/outcomes, obs/quality)
    "scorelog.records": ("counter",
                         "sampled prediction records appended to the "
                         "score log"),
    "scorelog.segments": ("counter",
                          "score-log segments committed by atomic "
                          "rotation"),
    "scorelog.pruned_segments": ("counter",
                                 "committed segments pruned by the "
                                 "disk budget"),
    "quality.outcomes": ("counter",
                         "outcome records ingested (POST /outcome + "
                         "drop directory)"),
    "quality.outcomes_late": ("counter",
                              "outcomes dropped: unknown/evicted "
                              "request id, watermark miss, or length "
                              "mismatch"),
    "quality.scored_rows": ("gauge",
                            "sampled scores folded into the live "
                            "score histograms"),
    "quality.joined_rows": ("gauge",
                            "outcome-joined (score,label) rows in the "
                            "rolling windows"),
    "quality.live_auc": ("gauge",
                         "rolling live AUC of the current serving "
                         "generation"),
    "quality.ece": ("gauge",
                    "reliability-bin expected calibration error "
                    "(current generation)"),
    "quality.score_psi": ("gauge",
                          "PSI of live scores vs the posttrain "
                          "snapshot (current generation)"),
    "quality.degraded": ("gauge",
                         "1 while the quality plane flags live-AUC or "
                         "score-PSI degradation"),
}

# dynamic families: f-string names must start with one of these
PREFIXES: Tuple[str, ...] = (
    "bench.",        # per-plane bench gauges mirror BENCH_r0N extras
    "eval.",         # eval.<set>.auc / eval.<set>.pr_auc per eval set
)

# span-name literals (obs.span("...") / obs.record_span("...") call
# sites) — the timeline tracks, report sections and tests join on these
SPANS: Dict[str, str] = {
    "setup": "step scaffolding before process() (processor base)",
    "process": "step body (processor base)",
    "varselect.sensitivity": "SE/ST sensitivity scoring phase",
    "ingest.window_prep": "background window materialization (prep thread)",
    "ingest.h2d_wait": "consumer blocked on window prep / H2D",
    "serve.request": ("sampled scoring request: queue-wait / deadline-"
                      "wait / pad / launch / device decomposition"),
    "serve.batch": ("sampled padded-bucket launch; links the member "
                    "requests' trace ids (fan-in causality)"),
    "dcn.step": ("elastic quorum step: contribute -> wait for quorum/"
                 "timeout/peer close -> adopt the committed aggregate"),
    "refresh.retrain": ("warm-start retraining of a refresh candidate "
                        "(checkpoint resume over the data-window "
                        "cursor)"),
}

# span families whose names embed data (the bench's per-plane spans)
SPAN_PREFIXES: Tuple[str, ...] = (
    "bench.",
)


def is_declared(name: str) -> bool:
    return name in MANIFEST or any(name.startswith(p) for p in PREFIXES)


def is_declared_span(name: str) -> bool:
    return name in SPANS or any(name.startswith(p) for p in SPAN_PREFIXES)


def declared_type(name: str) -> str:
    """Instrument type for an exact declared name ('' for prefix-only)."""
    if name in MANIFEST:
        return MANIFEST[name][0]
    return ""
