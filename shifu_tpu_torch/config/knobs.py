"""Knob registry — the port's copy of ``shifu_tpu.config.knobs``: every
``-Dshifu.*`` property and ``SHIFU_*`` environment variable that
``shifu_tpu_torch`` reads, declared in one place with the reference's
name, kind, type, default and doc (``tests/test_torch_knobs.py`` holds the
port to it: every read names a declared knob, every declared knob is read
or named somewhere in the port, and a knob both packages declare has equal
fields in both).

Property names match case-insensitively (``environment.get_property``
lowercases on fallback, and ``SHIFU_FOO_BAR`` env vars fold to
``shifu.foo.bar``).  The reference's ``knob-registry`` lint rule itself
waits for the port's ``lint`` (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

__all__ = ["Knob", "KNOBS", "is_declared", "is_declared_prefix"]


@dataclass(frozen=True)
class Knob:
    name: str            # "shifu.serve.maxDelayMs" or "SHIFU_TREE_BATCH"
    kind: str            # "property" (-D / shifuconfig) or "env"
    type: str            # int | float | bool | str
    default: str         # rendered default ("" = unset / derived)
    doc: str             # one line


def _k(name: str, kind: str, type_: str, default: str, doc: str) -> Knob:
    return Knob(name, kind, type_, default, doc)


_DECLS: Tuple[Knob, ...] = (
    # ---- telemetry / observability plane
    _k("shifu.telemetry", "property", "bool", "off",
       "master telemetry switch (same as --telemetry / SHIFU_TPU_TELEMETRY)"),
    _k("shifu.tpu.telemetry", "property", "bool", "off",
       "alias of shifu.telemetry (env-folded SHIFU_TPU_TELEMETRY form)"),
    _k("shifu.telemetry.fence", "property", "bool", "off",
       "block_until_ready-fence spans for exact device timings"),
    _k("shifu.telemetry.heartbeatSeconds", "property", "float", "5",
       "heartbeat commit interval for obs/health writers"),
    _k("shifu.profile", "property", "str", "",
       "jax.profiler capture dir for this step (--profile)"),
    _k("shifu.drift.psiThreshold", "property", "float", "0.25",
       "PSI above which the drift monitor flags a column"),
    _k("SHIFU_TPU_TELEMETRY", "env", "bool", "0",
       "enable telemetry (1/true/on; same as shifu.telemetry)"),
    _k("SHIFU_TPU_TELEMETRY_FENCE", "env", "bool", "0",
       "env form of shifu.telemetry.fence"),
    _k("SHIFU_TPU_HEARTBEAT_S", "env", "float", "5",
       "env form of shifu.telemetry.heartbeatSeconds"),
    _k("SHIFU_TPU_PEAK_FLOPS", "env", "float", "",
       "override the backend peak-FLOP/s table (roofline report)"),
    _k("SHIFU_TPU_PEAK_BW", "env", "float", "",
       "override the backend peak-bytes/s table (roofline report)"),
    # ---- fault injection
    _k("shifu.faults", "property", "str", "",
       "deterministic fault spec: site:point=value:action[@count],..."),
    _k("SHIFU_TPU_FAULTS", "env", "str", "",
       "env form of shifu.faults"),
    # ---- IO / artifact plane
    _k("shifu.io.retries", "property", "int", "3",
       "transient-IO retry attempts absorbed before re-raising"),
    _k("shifu.io.retryBaseMs", "property", "int", "50",
       "retry backoff base (doubles per attempt, jittered)"),
    _k("shifu.data.badThreshold", "property", "float", "0",
       "bounded bad-input tolerance: rows/shards quarantined up to this"),
    # ---- ingest / streaming plane
    _k("shifu.stream.spill", "property", "bool", "true",
       "mmap binned spill cache for re-sweeps"),
    _k("shifu.stream.spillBudgetBytes", "property", "int", "8589934592",
       "spill cache size budget (bytes)"),
    _k("shifu.stream.spillDir", "property", "str", "",
       "spill cache directory (default: under the modelset tmp)"),
    _k("shifu.stream.prefetch", "property", "int", "2",
       "prepared-window pipeline depth (H2D double-buffering)"),
    _k("SHIFU_TPU_PREFETCH", "env", "int", "2",
       "env form of shifu.stream.prefetch"),
    _k("shifu.ingest.parseWorkers", "property", "int", "-1",
       "raw-shard parse pool threads (-1 auto min(cores,8); 0 inline)"),
    _k("shifu.ingest.rawCache", "property", "bool", "true",
       "columnar raw-parse cache shared across pipeline steps"),
    _k("shifu.ingest.rawCacheBudgetBytes", "property", "int", "8589934592",
       "raw cache size budget (bytes; overflow aborts permanently)"),
    _k("shifu.norm.wireOnly", "property", "bool", "true",
       "norm emits the clean plane direct-to-wire (no clean npz)"),
    # ---- stats plane
    _k("shifu.stats.onePass", "property", "bool", "true",
       "one-pass fused stats sweep (false restores two-pass)"),
    _k("shifu.stats.fusedBudgetBytes", "property", "int", "1073741824",
       "device-resident budget for the fused stats sweep"),
    _k("shifu.stats.checkpointChunks", "property", "int", "0",
       "checkpoint accumulator partials every N chunks (0 = off)"),
    _k("shifu.rebin.ivKeepRatio", "property", "float", "0.95",
       "stats -rebin: IV mass to keep when merging bins"),
    _k("shifu.rebin.minBinInstCnt", "property", "int", "0",
       "stats -rebin: minimum instances per bin"),
    _k("shifu.rebin.maxNumBin", "property", "int", "",
       "stats -rebin: target bin count (default: stats.maxNumBin)"),
    # ---- train plane
    _k("shifu.train.streaming", "property", "str", "auto",
       "stream training windows from disk (on/off/auto by memory budget)"),
    _k("shifu.train.memoryBudgetBytes", "property", "int", "2147483648",
       "in-RAM plane budget driving the streaming auto decision"),
    _k("shifu.train.windowRows", "property", "int", "0",
       "streamed window height (0 = derived)"),
    _k("shifu.train.deviceCacheBytes", "property", "int", "1073741824",
       "HBM-resident window cache budget (ResidentCache)"),
    _k("shifu.train.precision", "property", "str", "f32",
       "training precision ladder: f32 | bf16 | mixed"),
    # ---- WDL sharded categorical plane (train/wdl_shard)
    _k("shifu.wdl.shardTables", "property", "str", "auto",
       "row-shard WDL embed/wide tables + optimizer moments over the data "
       "axis (on/off/auto by shardMinBytes)"),
    _k("shifu.wdl.hashBuckets", "property", "int", "0",
       "hashed-ID bucket space: categorical columns wider than this map "
       "through splitmix64 (0 = exact ids; params.HashBuckets wins)"),
    _k("shifu.wdl.serveCopy", "property", "str", "auto",
       "serve-time WDL table copy: full | sharded | hot | auto (sharded when "
       "multi-device and over shardMinBytes)"),
    _k("shifu.tree.tailSuperBatchBytes", "property", "int", "268435456",
       "histogram budget deriving the disk-tail tree super-batch"),
    _k("shifu.tree.tailCoarseToFine", "property", "bool", "auto",
       "GBT disk-tail coarse-to-fine speculation (default on for accelerator "
       "backends)"),
    _k("shifu.tree.tailCandidateK", "property", "int", "0",
       "bounded-candidate split scan K for the disk tail (0 = exact)"),
    _k("shifu.tree.tailHistBudgetBytes", "property", "int", "268435456",
       "per-sweep histogram budget for the streamed tail"),
    _k("SHIFU_TREE_BATCH", "env", "int", "8",
       "resident RF/GBT trees grown per jitted program"),
    _k("SHIFU_TAIL_TREE_BATCH", "env", "int", "",
       "disk-tail super-batch width override (default budget-derived)"),
    _k("SHIFU_TREE_TAIL_C2F", "env", "bool", "auto",
       "env form of shifu.tree.tailCoarseToFine"),
    # ---- varselect plane
    _k("shifu.varsel.batched", "property", "bool", "true",
       "mask-batched streamed sensitivity (false = per-column oracle)"),
    _k("shifu.varsel.maskBatch", "property", "int", "32",
       "candidate masks evaluated per vmapped program"),
    # ---- serving plane
    _k("shifu.serve.buckets", "property", "str", "1/8/64/512",
       "padded-batch bucket ladder (slash-separated rungs)"),
    _k("shifu.serve.maxDelayMs", "property", "float", "2",
       "micro-batcher deadline flush bound"),
    _k("shifu.serve.bucketRefineEvery", "property", "int", "512",
       "batches between occupancy-driven ladder refinements (0 = off)"),
    _k("shifu.serve.traceSampleRate", "property", "float", "0",
       "per-request trace head-sampling rate (0..1)"),
    _k("shifu.serve.sloP99Ms", "property", "float", "",
       "p99 latency SLO (default 2x maxDelayMs)"),
    _k("shifu.serve.sloAvailability", "property", "float", "0.999",
       "availability SLO for error-budget burn alerts"),
    _k("shifu.serve.generations", "property", "int", "3",
       "previous serving generations kept rollback-able per key"),
    _k("shifu.serve.fleetPollMs", "property", "float", "500",
       "fleet router health-poll cadence across replicas"),
    _k("shifu.serve.fleetStaleS", "property", "float", "10",
       "replica unreachable this long is declared dead and drained"),
    _k("shifu.serve.canaryFrac", "property", "float", "0",
       "coordinated-swap canary slice: commit ceil(frac*N) replicas, abort "
       "the rest (0 = commit the whole fleet)"),
    _k("shifu.serve.maxQueueRows", "property", "int", "0",
       "admission cap: queued rows beyond this fast-fail with a coded "
       "429/overloaded (0 = auto, 128x the top bucket rung)"),
    _k("shifu.serve.requestDeadlineMs", "property", "float", "0",
       "default per-request deadline; expired tickets are shed before "
       "pad/launch with a coded 504 (0 = none; X-Shifu-Deadline-Ms overrides "
       "per request)"),
    _k("shifu.serve.retryBudgetFrac", "property", "float", "0.1",
       "router retry budget: requeues allowed per recent success (token "
       "bucket; 0 = no retries)"),
    _k("shifu.serve.hedgeMs", "property", "float", "0",
       "hedged second dispatch after the router-observed p99 (this value is "
       "the floor/fallback delay; 0 = hedging off)"),
    _k("shifu.serve.breakerFailures", "property", "int", "3",
       "consecutive transport/5xx failures that open a replica's circuit "
       "breaker (half-open probe after cooldown; 0 = off)"),
    _k("shifu.serve.brownout", "property", "bool", "true",
       "brownout degradation: sustained SLO burn or queue buildup flips the "
       "worker into a degraded mode (shrunk flush deadline, "
       "sampling/refinement off) with hysteresis on recovery"),
    # ---- continual refresh plane (refresh/)
    _k("shifu.refresh.psiThreshold", "property", "float", "",
       "PSI breach that triggers a refresh cycle (default: "
       "shifu.drift.psiThreshold)"),
    _k("shifu.refresh.intervalS", "property", "float", "0",
       "wall-clock refresh schedule in seconds (0 = drift-only)"),
    _k("shifu.refresh.cooldownS", "property", "float", "300",
       "minimum seconds between refresh cycles (thrash guard: a "
       "sustained breach records ONE skip per window)"),
    _k("shifu.refresh.minAucDelta", "property", "float", "0",
       "holdout AUC bar a candidate must clear to promote (0 = strict "
       "non-regression)"),
    _k("shifu.refresh.probationS", "property", "float", "60",
       "post-promotion probation window watched for SLO burn / canary "
       "parity before the promotion is final"),
    _k("shifu.refresh.units", "property", "int", "0",
       "extra epochs/trees per warm retrain (0 = the configured "
       "numTrainEpochs / TreeNum budget, warm-started)"),
    _k("shifu.refresh.canaryRows", "property", "int", "64",
       "canary batch size pinned at promotion for probation bit-parity "
       "checks"),
    # ---- model-quality observability plane (obs/scorelog+outcomes+quality)
    _k("shifu.scorelog.sampleRate", "property", "float", "0",
       "serve-path score-log head-sampling rate (0..1; 0 = plane off)"),
    _k("shifu.scorelog.segmentBytes", "property", "int", "1048576",
       "score-log segment size before atomic rotation commit"),
    _k("shifu.scorelog.budgetBytes", "property", "int", "67108864",
       "score-log disk budget: oldest committed segments pruned over this"),
    _k("shifu.quality.watermarkS", "property", "float", "3600",
       "delayed-label join window: predictions older than this are evicted "
       "unjoined"),
    _k("shifu.quality.aucDelta", "property", "float", "0.05",
       "live-AUC drop vs the posttrain baseline that marks the model "
       "degraded (the quality refresh trigger)"),
    _k("shifu.quality.psiThreshold", "property", "float", "",
       "score-distribution PSI breach threshold (default: "
       "shifu.drift.psiThreshold)"),
    _k("shifu.quality.minJoined", "property", "int", "64",
       "joined rows per generation before live AUC / calibration / score PSI "
       "are judged"),
    # ---- multi-host / elastic DCN plane
    _k("shifu.dcn.elastic", "property", "bool", "false",
       "quorum-gated elastic multi-controller step protocol (the in-mesh "
       "psum path stays the fast default)"),
    _k("shifu.dcn.quorumFrac", "property", "float", "0.97",
       "fraction of live controllers whose contributions close a step (also "
       "the monitor's QUORUM LOST threshold)"),
    # ---- multi-host / launcher
    # (the reference's fields, word for word: the coordinator is the
    # torch.distributed TCPStore's address here)
    _k("SHIFU_COORDINATOR", "env", "str", "",
       "jax.distributed coordinator address (host:port); unset = "
       "single-process"),
    _k("SHIFU_NUM_PROCESSES", "env", "int", "",
       "process count for the multi-controller job"),
    _k("SHIFU_PROCESS_ID", "env", "int", "",
       "this controller's process index"),
    _k("SHIFU_TPU_HOME", "env", "str", "",
       "home dir holding conf/shifuconfig global properties"),
    _k("SHIFU_HOME", "env", "str", "",
       "fallback for SHIFU_TPU_HOME (reference launcher compat)"),
    # ---- the port's own
    _k("SHIFU_TORCH_BUILD_DIR", "env", "str", "",
       "where ops/cuda_lib.py builds the CUDA kernels (default "
       "<repo>/build/shifu_tpu_torch)"),
)

KNOBS: Dict[str, Knob] = {k.name: k for k in _DECLS}
if len(KNOBS) != len(_DECLS):            # duplicate declaration = a bug
    raise AssertionError("duplicate knob declaration in config/knobs.py")

_PROPS_LOWER: Dict[str, str] = {
    k.name.lower(): k.name for k in _DECLS if k.kind == "property"}


def is_declared(name: str) -> bool:
    """Exact declared knob?  Properties match case-insensitively."""
    if name in KNOBS:
        return True
    return name.lower() in _PROPS_LOWER


def is_declared_prefix(token: str) -> bool:
    """Is ``token`` a strict prefix of some declared knob (a line-wrapped
    mention)?"""
    tl = token.lower()
    return any(n.lower().startswith(tl) for n in KNOBS)
