"""ServeServer — registry + batcher behind one object, and its stdlib HTTP
front-end (the port of ``shifu_tpu.serve.server``).

``python -m shifu_tpu_torch.cli --dir <modelset> serve`` loads the
modelset's trained ensemble (``<dir>/models``) onto the device, launches
every bucket once, starts the micro-batcher worker, then serves:

- in-process: :meth:`ServeServer.score` / :meth:`ServeServer.score_raw`;
- over HTTP: ``POST /score`` with ``{"rows": [[...]], "bins": [[...]]}``
  -> ``{"scores": [...]}``, or RAW records ``{"records": [{field: value,
  ...}]}`` when the modelset dir carries its ModelConfig/ColumnConfig
  snapshot (a malformed record fails alone with a coded error, its
  ``scores`` slot null); ``GET /healthz`` -> live state and bucket/batch
  accounting.

Knobs: ``-Dshifu.serve.buckets`` (bucket ladder), ``-Dshifu.serve.maxDelayMs``
(deadline flush, default 2 ms).  The reference's heartbeats, SLO tracker,
score log, quality monitor, brownout governor and hot-swap endpoints wait
for a later slice.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from .batcher import MicroBatcher, Ticket
from .registry import ModelRegistry
from .scorer import bucket_ladder

log = logging.getLogger(__name__)

DEFAULT_MAX_DELAY_MS = 2.0


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
                 transform=None, device=None,
                 dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.model_set_dir = model_set_dir
        self.key = key or (os.path.basename(os.path.abspath(model_set_dir))
                           if model_set_dir else "default")
        self.registry = ModelRegistry()
        src = models if models is not None \
            else os.path.join(model_set_dir, "models")
        if transform is None and model_set_dir:
            transform = _load_transform(model_set_dir, dtype)
        self.transform = transform
        self.registry.load(self.key, src,
                           buckets=tuple(buckets or bucket_ladder()),
                           transform=transform, device=self.device)
        self.batcher = MicroBatcher(self.registry.provider(self.key),
                                    max_delay_s=max_delay_s(max_delay_ms))
        self._started = False

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "ServeServer":
        if not self._started:
            self.batcher.start()
            self._started = True
        return self

    def stop(self) -> None:
        if self._started:
            self.batcher.stop()
            self._started = False

    # ------------------------------------------------------------- scoring
    def submit(self, rows: np.ndarray,
               bins: Optional[np.ndarray] = None) -> Ticket:
        return self.batcher.submit_burst(np.asarray(rows, np.float32), bins)

    def score(self, rows: np.ndarray, bins: Optional[np.ndarray] = None,
              timeout: float = 30.0) -> np.ndarray:
        """Closed-loop scoring (mean ensemble score per row, scaled)."""
        t = self.submit(rows, bins)
        if not self._started:                  # in-process, no worker
            self.batcher.drain()
        return t.wait(timeout)

    def score_raw(self, records: Sequence, timeout: float = 30.0) -> dict:
        """Raw-record scoring: parse + categorical binning on host, the
        norm transform on the device.  PER-RECORD rejection: a malformed
        record gets a coded error and a null ``scores`` slot while its
        neighbours still score."""
        scorer = self.registry.get(self.key)
        if not scorer.accepts_raw:
            raise ValueError(
                "this modelset serves pre-binned rows only — raw "
                "records need the ModelConfig/ColumnConfig snapshot "
                "next to models/")
        packed, kept, errors = scorer.transform.parse_records(records)
        scores: list = [None] * len(records)
        if len(packed):
            t = self.batcher.submit_burst(packed, raw=True)
            if not self._started:              # in-process, no worker
                self.batcher.drain()
            got = t.wait(timeout)
            for i, s in zip(kept, got):
                scores[int(i)] = float(s)
        return {"scores": scores, "errors": errors,
                "generation": self.registry.generation(self.key)}

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
            "accepts_raw": scorer.accepts_raw,
            "n_features": scorer.n_features,
            "max_delay_ms": self.batcher.max_delay_s * 1000.0,
            "queue_depth": int(self.batcher.queue_depth),
            "stats": dict(self.batcher.stats),
            "bucket_counts": {str(k): v for k, v in
                              sorted(self.batcher.bucket_counts.items())},
        }


# ------------------------------------------------------------------ HTTP
def _make_handler(server: ServeServer):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: every reply carries Content-Length
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, doc: dict) -> None:
            body = json.dumps(doc).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):                      # noqa: N802 (stdlib API)
            if self.path in ("/healthz", "/health", "/status"):
                self._reply(200, server.status())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):                     # noqa: N802
            if self.path != "/score":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                doc = json.loads(self.rfile.read(n) or b"{}")
                if "records" in doc:           # raw-record path
                    recs = doc["records"]
                    if not isinstance(recs, list):
                        self._reply(400, {"error": "records must be a "
                                          "list of objects"})
                        return
                    got = server.score_raw(recs)
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
                    scores = server.score(rows, bins)
                    out = {"scores": [round(float(s), 6) for s in scores],
                           "generation":
                               server.registry.generation(server.key)}
                self._reply(200, out)
            except Exception as e:             # noqa: BLE001 — HTTP edge
                self._reply(400, {"error": str(e)})

        def log_message(self, fmt, *args):     # stdlib prints to stderr
            log.debug("http: " + fmt, *args)

    return Handler


def run_serve(model_set_dir: str, port: int = 8188, selfcheck: int = 0,
              max_delay_ms: Optional[float] = None, device=None) -> int:
    """The ``serve`` entry.  ``selfcheck=N`` scores N synthetic rows
    in-process and exits (no port); otherwise binds the stdlib HTTP
    front-end on ``port`` (0 = an ephemeral port) until interrupted."""
    server = ServeServer(model_set_dir, max_delay_ms=max_delay_ms,
                         device=device)
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
        print(f"shifu-tpu-torch serve: {server.key} on "
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
