"""ServeServer — registry + batcher + heartbeats behind one object, and
its stdlib HTTP front-end; the port of ``shifu_tpu.serve.server``.

``python -m shifu_tpu_torch.cli --dir <modelset> serve`` loads the
modelset's trained ensemble (``<dir>/models``) onto the card, captures
every bucket rung's CUDA graph, starts the micro-batcher worker and the
per-process SERVE heartbeat (:mod:`shifu_tpu_torch.obs.health`), then
serves:

- in-process: :meth:`ServeServer.score` (closed-loop) /
  :meth:`ServeServer.submit` (async ticket) / :meth:`ServeServer.score_raw`;
- over HTTP: ``POST /score`` with ``{"rows": [[...]], "bins": [[...]]}``
  -> ``{"scores": [...]}``, or RAW records ``{"records": [{field: value,
  ...}]}`` when the modelset dir carries its ModelConfig/ColumnConfig
  snapshot (a malformed record fails alone with a coded error, its
  ``scores`` slot null); ``GET /healthz`` -> live state, bucket/batch/
  queue accounting and the compact SLO summary; ``GET /slo`` -> the full
  SLO/burn-rate payload; ``GET /quality`` -> the live model-quality
  table; ``POST /outcome`` -> delayed labels joined onto logged
  predictions; ``POST /swap`` -> promotion phases (``prepare`` /
  ``commit`` / ``abort``, or a one-shot ``swap``);
- request tracing: an ``X-Shifu-Trace`` request header propagates the
  caller's trace id onto the batch pipeline (forcing sampling for that
  request); otherwise requests are head-sampled at
  ``-Dshifu.serve.traceSampleRate``;
- overload: a submit over ``-Dshifu.serve.maxQueueRows`` is answered 429
  with ``Retry-After`` and ``{"error": "overloaded", "retry_after_ms"}``;
  a request whose ``-Dshifu.serve.requestDeadlineMs`` (or
  ``X-Shifu-Deadline-Ms``) passed before launch is answered 504 with
  ``{"error": "deadline_exceeded", "detail"}``; the brownout governor
  runs on each heartbeat.

The server owns an SLO tracker (fed per-row latencies by the batcher);
with a model-set dir its SERVE heartbeats carry ``queue_depth`` /
``queue_buildup`` / ``mode`` / the compact SLO summary (and ``quality``),
the metrics exporter mirrors the registry into ``telemetry/metrics.prom``
and ``stop()`` flushes sampled request spans to ``telemetry/trace.jsonl``
(telemetry on).

Model-quality plane (``-Dshifu.scorelog.sampleRate`` > 0, default 0 =
off): a sampled score log (crash-safe segments under
``telemetry/scorelog/``), an outcome joiner (``POST /outcome`` + the
``telemetry/outcomes/`` drop directory, swept each heartbeat) and a
quality monitor seeded from eval's ``telemetry/posttrain.json``.

Knobs: ``-Dshifu.serve.buckets``, ``-Dshifu.serve.bucketRefineEvery``,
``-Dshifu.serve.maxDelayMs`` (default 2 ms),
``-Dshifu.serve.traceSampleRate``, ``-Dshifu.serve.sloP99Ms`` /
``-Dshifu.serve.sloAvailability``, ``-Dshifu.serve.maxQueueRows``,
``-Dshifu.serve.requestDeadlineMs``, ``-Dshifu.serve.brownout``,
``-Dshifu.serve.generations``, ``-Dshifu.scorelog.*`` and
``-Dshifu.quality.*``.  ``serve --replicas N`` puts N of these
processes behind :mod:`shifu_tpu_torch.serve.router`; ``GET /healthz``'s
``graphs`` says what the process's CUDA graphs did (captures a request
forced, ``tree_traverse`` launches, replays).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from .. import faults, obs, resolve_device
from .batcher import MicroBatcher, Ticket
from .overload import (DeadlineExceededError, OverloadedError,
                       configured_brownout_enabled)
from .registry import ModelRegistry
from .scorer import bucket_ladder, serve_graph_counts

log = logging.getLogger(__name__)

DEFAULT_MAX_DELAY_MS = 2.0

# queue depth at/over this many top buckets flags "buildup" in
# heartbeats — work queued beyond what the next few flushes can absorb
QUEUE_BUILDUP_BUCKETS = 4

# brownout policy: the flush deadline shrinks to this fraction of its
# configured value while degraded (smaller batches, lower queue wait —
# throughput for latency, the right trade under overload)
BROWNOUT_DELAY_FACTOR = 0.25


def max_delay_s(override_ms: Optional[float] = None) -> float:
    """Deadline-flush bound: explicit override > property
    ``shifu.serve.maxDelayMs`` > 2 ms."""
    if override_ms is not None:
        return max(0.0, float(override_ms)) / 1000.0
    from ..config import environment
    return max(0.0, environment.get_float("shifu.serve.maxDelayMs",
                                          DEFAULT_MAX_DELAY_MS)) / 1000.0


def _load_transform(model_set_dir: str, dtype: torch.dtype = torch.float32):
    """The modelset's :class:`FusedTransform` when its config snapshot
    (ModelConfig.json + ColumnConfig.json) is on disk — pre-binned-only
    sets serve fine without one, they just refuse raw records."""
    if not all(os.path.isfile(os.path.join(model_set_dir, f))
               for f in ("ModelConfig.json", "ColumnConfig.json")):
        return None
    from .transform import FusedTransform
    try:
        return FusedTransform.from_dir(model_set_dir, dtype=dtype)
    except (OSError, ValueError, KeyError) as e:
        log.warning("raw-record path disabled (%s)", e)
        return None


class ServeServer:
    """One serving process for one modelset, on ``device`` (default CUDA;
    raises when CUDA is absent unless ``device="cpu"`` is asked for).
    ``dtype`` is the raw-record transform's compute dtype."""

    def __init__(self, model_set_dir: Optional[str] = None,
                 models: Optional[Sequence] = None,
                 key: Optional[str] = None,
                 buckets: Optional[Sequence[int]] = None,
                 max_delay_ms: Optional[float] = None,
                 trace_sample_rate: Optional[float] = None,
                 slo_p99_ms: Optional[float] = None,
                 slo_availability: Optional[float] = None,
                 scorelog_sample_rate: Optional[float] = None,
                 transform=None, replica: Optional[str] = None,
                 device=None, dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.model_set_dir = model_set_dir
        self.key = key or (os.path.basename(os.path.abspath(model_set_dir))
                           if model_set_dir else "default")
        self.replica = replica
        state_dir = (os.path.join(model_set_dir, "serving")
                     if model_set_dir else None)
        self.registry = ModelRegistry(state_dir=state_dir,
                                      device=self.device)
        src = models if models is not None \
            else os.path.join(model_set_dir, "models")
        if transform is None and model_set_dir:
            transform = _load_transform(model_set_dir, dtype)
        self.transform = transform
        self.registry.load(self.key, src,
                           buckets=tuple(buckets or bucket_ladder()),
                           transform=transform)
        delay_s = max_delay_s(max_delay_ms)
        p99_obj, avail_obj = obs.slo_objectives(delay_s * 1000.0)
        self.slo = obs.SLOTracker(
            p99_ms=slo_p99_ms if slo_p99_ms is not None else p99_obj,
            availability=slo_availability
            if slo_availability is not None else avail_obj)
        self.batcher = MicroBatcher(self.registry.provider(self.key),
                                    max_delay_s=delay_s,
                                    trace_sample_rate=trace_sample_rate,
                                    slo=self.slo)
        # brownout governor (overload tentpole): evaluated each beat —
        # or directly via check_brownout() — against burn-rate alerts
        # and queue buildup; None when -Dshifu.serve.brownout=false
        self.brownout = obs.BrownoutGovernor() \
            if configured_brownout_enabled() else None
        self._normal_settings: Optional[dict] = None
        self._heartbeat = None
        self._exporter = None
        self._started = False
        # model-quality plane: only exists at sampleRate > 0 (zero-cost
        # contract — the batcher tap stays one is-not-None check)
        self.scorelog = None
        self.outcomes = None
        self.quality = None
        self._join_count = 0
        from ..obs.scorelog import scorelog_sample_rate as _rate_knob
        rate = _rate_knob(scorelog_sample_rate)
        if model_set_dir and rate > 0.0:
            from ..obs.outcomes import OutcomeJoiner, outcomes_drop_dir
            from ..obs.quality import (quality_artifact_path,
                                       start_quality_monitor)
            from ..obs.scorelog import ScoreLog, scorelog_dir
            self.quality = start_quality_monitor(model_set_dir,
                                                 sample_rate=rate)
            self.outcomes = OutcomeJoiner(on_join=self._on_join)
            self.scorelog = ScoreLog(
                scorelog_dir(model_set_dir), sample_rate=rate,
                gen_fn=lambda: self.registry.generation(self.key),
                on_log=self._on_scored)
            self.batcher.scorelog = self.scorelog
            self._quality_path = quality_artifact_path(model_set_dir)
            self._drop_dir = outcomes_drop_dir(model_set_dir)

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "ServeServer":
        if self._started:
            return self
        self.batcher.start()
        if self.model_set_dir:
            proc = f"serve-{self.key}" + \
                (f"-{self.replica}" if self.replica else "")
            self._heartbeat = obs.start_heartbeat(
                obs.health_dir_for(self.model_set_dir), step="SERVE",
                proc=proc, extras_fn=self._beat_extras)
            self._exporter = obs.start_exporter(
                os.path.join(self.model_set_dir, "telemetry"),
                step="SERVE")
        self._started = True
        return self

    def stop(self, exit_code: Optional[int] = 0) -> None:
        if not self._started:
            return
        self.batcher.stop()
        if self.scorelog is not None:
            self.scorelog.close()       # commit the partial tail segment
        if self.quality is not None:
            self.quality.emit(path=self._quality_path)
        if self._exporter is not None:
            self._exporter.stop()
            self._exporter = None
        if self._heartbeat is not None:
            self._heartbeat.stop(exit_code=exit_code)
            self._heartbeat = None
        if self.model_set_dir and obs.enabled():
            # sampled request/batch spans land in the reference's trace
            # file (its analysis --telemetry renders them)
            obs.flush(trace_path(self.model_set_dir), step="SERVE")
        self._started = False

    # -------------------------------------------------- brownout mode
    @property
    def mode(self) -> str:
        """``normal`` or ``brownout`` (the ``serve.mode`` gauge /
        heartbeat extra / ``<< BROWNOUT`` monitor flag)."""
        return self.brownout.mode if self.brownout is not None \
            else "normal"

    def check_brownout(self, now: Optional[float] = None) -> str:
        """One governor evaluation (rides each heartbeat; tests call it
        directly): *stressed* = a firing burn-rate alert OR queue
        buildup.  Applies/reverts the degradation policy on a mode
        flip and returns the current mode."""
        if self.brownout is None:
            return "normal"
        qd = self.batcher.queue_depth
        top = self.registry.get(self.key).buckets[-1]
        stressed = bool(self.slo.alerts(now=now)) \
            or qd >= QUEUE_BUILDUP_BUCKETS * top
        if self.brownout.check(stressed):
            if self.brownout.mode == "brownout":
                self._enter_brownout()
            else:
                self._exit_brownout()
        obs.gauge("serve.mode").set(
            1.0 if self.brownout.mode == "brownout" else 0.0)
        return self.brownout.mode

    def _enter_brownout(self) -> None:
        """Shed everything optional: shrink the flush deadline (smaller
        batches, bounded queue wait), stop trace and score-log sampling,
        freeze ladder refinement.  Settings are saved for the exit."""
        b = self.batcher
        self._normal_settings = {
            "max_delay_s": b.max_delay_s,
            "trace_sample_rate": b.trace_sample_rate,
            "refine_every": b.refine_every,
            "scorelog": b.scorelog,
        }
        b.max_delay_s = b.max_delay_s * BROWNOUT_DELAY_FACTOR
        b.trace_sample_rate = 0.0
        b.refine_every = 0
        b.scorelog = None
        obs.counter("serve.brownouts").inc()
        log.warning("serve %s: BROWNOUT engaged (deadline %.2f ms, "
                    "sampling/refinement suspended)", self.key,
                    b.max_delay_s * 1000.0)

    def _exit_brownout(self) -> None:
        saved, self._normal_settings = self._normal_settings, None
        if saved is None:
            return
        b = self.batcher
        b.max_delay_s = saved["max_delay_s"]
        b.trace_sample_rate = saved["trace_sample_rate"]
        b.refine_every = saved["refine_every"]
        b.scorelog = saved["scorelog"]
        log.warning("serve %s: brownout lifted, normal service restored",
                    self.key)

    def _beat_extras(self) -> dict:
        """Per-beat heartbeat payload: queue depth + serving mode + the
        compact SLO summary (the monitor's buildup / burn-rate /
        brownout flags), mirrored into the registry gauges the exporter
        scrapes."""
        qd = self.batcher.queue_depth
        top = self.registry.get(self.key).buckets[-1]
        self.slo.emit_gauges()
        obs.gauge("serve.queue_depth").set(qd)
        extras = {"queue_depth": int(qd),
                  "queue_buildup": bool(qd >= QUEUE_BUILDUP_BUCKETS * top),
                  "mode": self.check_brownout(),
                  "slo": self.slo.compact()}
        if self.quality is not None:
            if self.outcomes is not None:
                self.outcomes.ingest_drop_dir(self._drop_dir)
            extras["quality"] = self.quality.compact()
            self.quality.emit(path=self._quality_path)
        return extras

    # ------------------------------------------------------------- scoring
    def submit(self, rows: np.ndarray,
               bins: Optional[np.ndarray] = None,
               trace_id: Optional[str] = None,
               req_id: Optional[str] = None,
               deadline_ms: Optional[float] = None) -> Ticket:
        return self.batcher.submit_burst(np.asarray(rows, np.float32),
                                         bins, trace_id=trace_id,
                                         req_id=req_id,
                                         deadline_ms=deadline_ms)

    def score(self, rows: np.ndarray, bins: Optional[np.ndarray] = None,
              timeout: float = 30.0,
              trace_id: Optional[str] = None,
              req_id: Optional[str] = None,
              deadline_ms: Optional[float] = None) -> np.ndarray:
        """Closed-loop scoring (mean ensemble score per row, scaled)."""
        if not self._started:                  # in-process, no worker
            t = self.batcher.submit_burst(np.asarray(rows, np.float32),
                                          bins, trace_id=trace_id,
                                          req_id=req_id,
                                          deadline_ms=deadline_ms)
            self.batcher.drain()
            return t.wait(timeout)
        t = self.batcher.submit_burst(np.asarray(rows, np.float32), bins,
                                      trace_id=trace_id, req_id=req_id,
                                      deadline_ms=deadline_ms)
        return t.wait(timeout)

    def score_raw(self, records: Sequence, timeout: float = 30.0,
                  trace_id: Optional[str] = None,
                  req_id: Optional[str] = None,
                  deadline_ms: Optional[float] = None) -> dict:
        """Raw-record scoring: parse + categorical binning on host, the
        whole norm transform on the device inside the rung's captured
        graph.  PER-RECORD rejection: a malformed record (non-
        object, non-scalar field) gets a coded error and a null
        ``scores`` slot while its neighbours still score — the
        ``-Dshifu.data.badThreshold`` philosophy applied to serving."""
        scorer = self.registry.get(self.key)
        if not getattr(scorer, "accepts_raw", False):
            raise ValueError(
                "this modelset serves pre-binned rows only — raw "
                "records need the ModelConfig/ColumnConfig snapshot "
                "next to models/")
        obs.counter("serve.raw_requests").inc()
        packed, kept, errors = scorer.transform.parse_records(records)
        if errors:
            obs.counter("serve.raw_rejects").inc(len(errors))
        scores: list = [None] * len(records)
        if len(packed):
            obs.counter("serve.raw_rows").inc(int(len(packed)))
            t = self.batcher.submit_burst(packed, raw=True,
                                          trace_id=trace_id,
                                          req_id=req_id,
                                          deadline_ms=deadline_ms)
            if not self._started:              # in-process, no worker
                self.batcher.drain()
            got = t.wait(timeout)
            for i, s in zip(kept, got):
                scores[int(i)] = float(s)
        return {"scores": scores, "errors": errors,
                "generation": self.registry.generation(self.key)}

    def swap_phase(self, doc: dict) -> dict:
        """The ``POST /swap`` body: ``{"phase": ..., "dir": ...}``.

        ``prepare`` BUILDs + warms the candidate from ``dir`` and holds
        it pending (live model untouched); ``commit`` journals + flips
        it; ``abort`` discards it; ``swap`` (the default) does
        prepare+commit in one call.  The fleet router drives
        prepare-everywhere THEN commit-everywhere so no request ever
        sees a mixed-model fleet."""
        phase = str(doc.get("phase") or "swap")
        if phase in ("prepare", "swap"):
            mdir = doc.get("dir") or doc.get("models_dir")
            if not mdir:
                raise ValueError(
                    'swap phase %r needs a models dir ({"dir": ...})'
                    % phase)
            if phase == "swap":
                self.swap(str(mdir))
            else:
                gen = self.registry.prepare(
                    self.key, str(mdir), buckets=self._refined_ladder())
                return {"kind": "swap", "phase": phase,
                        "prepared_generation": gen,
                        "generation": self.registry.generation(self.key)}
        elif phase == "commit":
            self.registry.commit(self.key)
        elif phase == "abort":
            self.registry.abort(self.key)
        else:
            raise ValueError(f"unknown swap phase {phase!r}")
        return {"kind": "swap", "phase": phase,
                "generation": self.registry.generation(self.key)}

    def _refined_ladder(self) -> tuple:
        """The live ladder refined against observed batch sizes — the
        candidate captures it during BUILD."""
        from .scorer import refine_ladder
        scorer = self.registry.get(self.key)
        with self.batcher._cond:
            counts = dict(self.batcher.size_counts)
        return refine_ladder(scorer.buckets, counts)

    def swap(self, models_or_dir) -> None:
        """Promote a retrained model without dropping requests.  The
        candidate's ladder is the live ladder REFINED against the
        observed batch-size distribution (:func:`refine_ladder`), so a
        swap is also the natural point where padding waste learned
        during this generation's traffic is squeezed out — every rung
        (inherited and refined) is captured during the swap's BUILD
        phase, before the flip."""
        self.registry.swap(self.key, models_or_dir,
                           buckets=self._refined_ladder())

    def status(self) -> dict:
        scorer = self.registry.get(self.key)
        return {
            "state": "serving" if self._started else "loaded",
            "key": self.key,
            "generation": self.registry.generation(self.key),
            "device": str(self.device),
            "models": len(scorer.models),
            "buckets": list(scorer.buckets),
            "needs_bins": scorer.needs_bins,
            "accepts_raw": bool(getattr(scorer, "accepts_raw", False)),
            "replica": self.replica,
            "n_features": scorer.n_features,
            "max_delay_ms": self.batcher.max_delay_s * 1000.0,
            "trace_sample_rate": self.batcher.trace_sample_rate,
            "queue_depth": int(self.batcher.queue_depth),
            "mode": self.mode,
            "slo": self.slo.compact(),
            "stats": dict(self.batcher.stats),
            "bucket_counts": {str(k): v for k, v in
                              sorted(self.batcher.bucket_counts.items())},
            "graphs": serve_graph_counts(),
        }

    def slo_doc(self) -> dict:
        """The ``GET /slo`` payload: objectives, short/long-horizon
        quantiles/availability, burn rates and firing alerts."""
        return {"kind": "slo", "key": self.key,
                "queue_depth": int(self.batcher.queue_depth),
                **self.slo.summary()}

    # ------------------------------------------------------ quality plane
    def _on_scored(self, req: str, scores, gen: int, ts: float) -> None:
        """Score-log hook (every SAMPLED record): feed the PSI
        histogram and register the prediction for the delayed join."""
        if self.quality is not None:
            self.quality.observe_scores(gen, scores)
        if self.outcomes is not None:
            self.outcomes.record_prediction(req, scores, gen, ts=ts)

    def _on_join(self, gen: int, scores, labels) -> None:
        """Outcome-join hook: fold the joined rows into the live
        AUC/calibration windows; re-emit the artifact periodically so
        the controller/monitor read fresh numbers between beats."""
        if self.quality is None:
            return
        self.quality.update(gen, scores, labels)
        self._join_count += 1
        if self._join_count % 8 == 0:
            self.quality.emit(path=self._quality_path)

    def add_outcomes(self, doc) -> dict:
        """The ``POST /outcome`` body: one ``{"req", "labels"}`` record
        or a ``{"outcomes": [...]}`` batch.  Returns join accounting
        (``joined_rows`` counts rows joined by THIS call)."""
        if self.outcomes is None:
            return {"kind": "outcome", "enabled": False,
                    "joined_rows": 0}
        recs = doc.get("outcomes") \
            if isinstance(doc, dict) and "outcomes" in doc else [doc]
        joined = 0
        for rec in recs:
            got = self.outcomes.add_outcome(
                str(rec["req"]), rec.get("labels", rec.get("label")))
            if got is not None:
                joined += int(len(got[1]))
        return {"kind": "outcome", "enabled": True,
                "joined_rows": joined,
                "pending": self.outcomes.pending,
                "late": self.outcomes.stats["late"]}

    def quality_doc(self) -> dict:
        """The ``GET /quality`` payload: the live quality summary (drop
        directory swept first, so a batch label feed lands before the
        read)."""
        if self.quality is None:
            return {"kind": "quality", "key": self.key, "enabled": False}
        if self.outcomes is not None:
            self.outcomes.ingest_drop_dir(self._drop_dir)
        return {"key": self.key, "enabled": True,
                **self.quality.summary()}


# ------------------------------------------------------------------ HTTP
def _make_handler(server: ServeServer):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: every reply carries Content-Length
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
                self._reply(200, server.status())
            elif self.path == "/slo":
                self._reply(200, server.slo_doc())
            elif self.path == "/quality":
                self._reply(200, server.quality_doc())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):                     # noqa: N802
            if self.path not in ("/score", "/outcome", "/swap"):
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                doc = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/outcome":
                    self._reply(200, server.add_outcomes(doc))
                    return
                if self.path == "/swap":
                    self._reply(200, server.swap_phase(doc))
                    return
                # a kill here models a replica dying mid-request — the
                # router requeues the un-launched ticket on a peer
                faults.fire("serve", "replica",
                            server.replica or server.key)
                # propagate the caller's trace id (forces sampling)
                trace_id = self.headers.get("X-Shifu-Trace")
                # the outcome-join key: caller-supplied, or minted here
                # when the score log is live (sampling decides whether
                # the id actually becomes joinable)
                req_id = self.headers.get("X-Shifu-Request")
                if req_id is None and server.scorelog is not None:
                    req_id = os.urandom(8).hex()
                # the propagated request budget (router -> worker):
                # remaining milliseconds; absent = the property default
                deadline_ms = None
                hdr = self.headers.get("X-Shifu-Deadline-Ms")
                if hdr is not None:
                    deadline_ms = float(hdr)
                if "records" in doc:           # raw-record path
                    recs = doc["records"]
                    if not isinstance(recs, list):
                        self._reply(400, {"error": "records must be a "
                                          "list of objects"})
                        return
                    got = server.score_raw(recs, trace_id=trace_id,
                                           req_id=req_id,
                                           deadline_ms=deadline_ms)
                    if got["errors"] and not any(
                            s is not None for s in got["scores"]):
                        self._reply(400, {**got, "error":
                                          "no parseable records"})
                        return
                    out = {**got, "scores":
                           [None if s is None else round(float(s), 6)
                            for s in got["scores"]]}
                else:
                    rows = np.asarray(doc["rows"], np.float32)
                    bins = doc.get("bins")
                    if bins is not None:
                        bins = np.asarray(bins, np.int32)
                    scores = server.score(rows, bins, trace_id=trace_id,
                                          req_id=req_id,
                                          deadline_ms=deadline_ms)
                    out = {"scores": [round(float(s), 6)
                                      for s in scores],
                           "generation":
                               server.registry.generation(server.key)}
                if trace_id:
                    out["trace"] = trace_id
                if req_id:
                    out["req"] = req_id
                self._reply(200, out)
            except OverloadedError as e:       # coded admission shed
                self._reply(429, {"error": e.code,
                                  "retry_after_ms":
                                      round(e.retry_after_s * 1000.0, 3)},
                            headers={"Retry-After":
                                     str(max(1, round(e.retry_after_s)))})
            except DeadlineExceededError as e:  # coded deadline shed
                self._reply(504, {"error": e.code, "detail": str(e)})
            except Exception as e:             # noqa: BLE001 — HTTP edge
                self._reply(400, {"error": str(e)})

        def log_message(self, fmt, *args):     # stdlib prints to stderr
            log.debug("http: " + fmt, *args)

    return Handler


def trace_path(model_set_dir: str) -> str:
    """``<modelset>/telemetry/trace.jsonl`` — the reference's trace file."""
    return os.path.join(os.path.abspath(model_set_dir), "telemetry",
                        "trace.jsonl")


def run_serve(model_set_dir: str, port: int = 8188,
              selfcheck: int = 0, max_delay_ms: Optional[float] = None,
              buckets: Optional[Sequence[int]] = None,
              replica: Optional[str] = None,
              announce: Optional[str] = None, device=None) -> int:
    """The ``serve`` entry.  ``selfcheck=N`` scores N synthetic rows
    in-process and exits (no port); otherwise binds the stdlib HTTP
    front-end on ``port`` (0 = an ephemeral port) until interrupted.  A
    fleet worker (:func:`shifu_tpu_torch.serve.router.spawn_worker`) runs
    with ``replica`` (its fleet name, stamped on heartbeats) and
    ``announce`` (a JSON file written after the bind, so after every rung
    is captured, with the bound port, the pid and the name)."""
    server = ServeServer(model_set_dir, max_delay_ms=max_delay_ms,
                         buckets=buckets, replica=replica, device=device)
    server.start()
    try:
        scorer = server.registry.get(server.key)
        if selfcheck:
            rng = np.random.default_rng(0)
            rows = rng.normal(size=(selfcheck,
                                    scorer.n_features)).astype(np.float32)
            bins = None
            if scorer.needs_bins:
                bins = np.zeros((selfcheck, scorer.n_bins_cols), np.int32)
            scores = server.score(rows, bins)
            print(json.dumps({"selfcheck_rows": int(selfcheck),
                              "scores_head": [round(float(s), 4)
                                              for s in scores[:5]],
                              **server.status()}))
            return 0
        from http.server import ThreadingHTTPServer
        httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                    _make_handler(server))
        bound = httpd.server_address[1]
        if announce:
            from ..ioutil import atomic_write_json
            atomic_write_json(announce, {"port": int(bound),
                                         "pid": os.getpid(),
                                         "name": replica or server.key})
        who = f"{server.key}/{replica}" if replica else server.key
        print(f"shifu-tpu-torch serve: {who} on "
              f"http://127.0.0.1:{bound} on {server.device} "
              f"(buckets {list(scorer.buckets)}, "
              f"deadline {server.batcher.max_delay_s * 1000:.1f} ms)",
              flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()
        return 0
    finally:
        server.stop()
