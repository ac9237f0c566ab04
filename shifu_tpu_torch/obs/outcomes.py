"""Delayed-label join: outcome records meet logged predictions; the port
of ``shifu_tpu.obs.outcomes``.

Fraud labels arrive days after scoring (the chargeback window) — live
model quality is only measurable by JOINING outcomes back onto the
predictions the score log sampled.  :class:`OutcomeJoiner` holds the
sampled predictions in a bounded in-memory window keyed by request id;
outcome records arrive either through ``POST /outcome`` on the serve
port or as JSONL files in a drop directory
(``<modelset>/telemetry/outcomes/`` — the batch path for an offline
label feed), and each join hands ``(generation, scores, labels)`` to
the quality monitor.

The window is a WATERMARK (``-Dshifu.quality.watermarkS``): predictions
older than the watermark are evicted, and outcomes for evicted or
never-sampled requests are counted ``late`` and dropped — the join is
bounded in memory and honest about sampling (a sampled score log can
only ever join the fraction it kept).
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from . import registry

log = logging.getLogger(__name__)

OUTCOMES_DIRNAME = "outcomes"

DEFAULT_WATERMARK_S = 3600.0


def outcomes_drop_dir(model_set_dir: str) -> str:
    return os.path.join(model_set_dir, "telemetry", OUTCOMES_DIRNAME)


def outcome_watermark_s(override: Optional[float] = None) -> float:
    """``-Dshifu.quality.watermarkS`` — the join window: outcomes for
    predictions older than this are late."""
    if override is not None:
        return float(override)
    from ..config import environment
    p = environment.get_property("shifu.quality.watermarkS")
    if p is not None:
        try:
            return float(p)
        except (TypeError, ValueError):
            pass
    return DEFAULT_WATERMARK_S


class OutcomeJoiner:
    """Request-id join of delayed outcomes onto sampled predictions.

    ``record_prediction`` is fed by the score log's ``on_log`` hook (so
    only SAMPLED predictions are joinable — the contract).  A repeated
    request id concatenates scores (a burst split across launches).
    ``on_join`` receives ``(gen, scores, labels)`` per successful join.
    """

    def __init__(self, watermark_s: Optional[float] = None,
                 on_join: Optional[Callable] = None,
                 clock: Callable[[], float] = time.time):
        self.watermark_s = outcome_watermark_s(watermark_s)
        self.on_join = on_join
        self._clock = clock
        # req -> [first_ts, gen, [score chunks]]; insertion order is
        # arrival order, so eviction pops from the front
        self._pending: "OrderedDict[str, list]" = OrderedDict()
        self.stats: Dict[str, int] = {"predictions": 0, "outcomes": 0,
                                      "joined_rows": 0, "late": 0,
                                      "evicted": 0, "malformed": 0}

    # ------------------------------------------------------------ feeding
    def record_prediction(self, req: str, scores, gen: int,
                          ts: Optional[float] = None) -> None:
        now = self._clock() if ts is None else float(ts)
        chunk = np.asarray(scores, np.float32).ravel()
        ent = self._pending.get(req)
        if ent is not None:
            ent[2].append(chunk)
        else:
            self._pending[req] = [now, int(gen), [chunk]]
        self.stats["predictions"] += 1
        self._evict(now)

    def _evict(self, now: float) -> None:
        horizon = now - self.watermark_s
        while self._pending:
            first = next(iter(self._pending))
            if self._pending[first][0] >= horizon:
                break
            del self._pending[first]
            self.stats["evicted"] += 1

    # ------------------------------------------------------------ joining
    def add_outcome(self, req: str, labels, ts: Optional[float] = None
                    ) -> Optional[Tuple[int, np.ndarray, np.ndarray]]:
        """Join one outcome record; returns ``(gen, scores, labels)`` or
        ``None`` (unknown/evicted request id, watermark miss, or a
        label/score length mismatch — all counted)."""
        now = self._clock() if ts is None else float(ts)
        self.stats["outcomes"] += 1
        registry.counter("quality.outcomes").inc()
        ent = self._pending.pop(req, None)
        if ent is None or now - ent[0] > self.watermark_s:
            self.stats["late"] += 1
            registry.counter("quality.outcomes_late").inc()
            return None
        scores = np.concatenate(ent[2])
        lab = np.asarray(labels, np.float32).ravel()
        if lab.size == 1 and scores.size > 1:
            lab = np.full(scores.shape, float(lab[0]), np.float32)
        if len(lab) != len(scores):
            self.stats["malformed"] += 1
            registry.counter("quality.outcomes_late").inc()
            return None
        self.stats["joined_rows"] += int(len(scores))
        if self.on_join is not None:
            self.on_join(ent[1], scores, lab)
        return ent[1], scores, lab

    # ----------------------------------------------------------- drop dir
    def ingest_drop_dir(self, path: str) -> int:
        """Consume outcome files (JSONL, one ``{"req", "labels"}`` per
        line; a ``{"outcomes": [...]}`` wrapper line is unrolled) from
        the drop directory; files are removed after ingest, torn lines
        counted malformed.  Returns records processed."""
        if not os.path.isdir(path):
            return 0
        n = 0
        for name in sorted(os.listdir(path)):
            if not (name.endswith(".json") or name.endswith(".jsonl")):
                continue
            full = os.path.join(path, name)
            try:
                with open(full) as f:
                    lines = f.readlines()
            except OSError:             # pragma: no cover
                log.warning("outcome drop file unreadable: %s", full,
                            exc_info=True)
                continue
            for line in lines:
                if not line.strip():
                    continue
                try:
                    doc = json.loads(line)
                except ValueError:
                    self.stats["malformed"] += 1
                    continue
                recs = doc.get("outcomes", [doc]) \
                    if isinstance(doc, dict) else []
                for rec in recs:
                    try:
                        self.add_outcome(str(rec["req"]),
                                         rec.get("labels",
                                                 rec.get("label")))
                        n += 1
                    except (KeyError, TypeError, ValueError):
                        self.stats["malformed"] += 1
            try:
                os.remove(full)
            except OSError:             # pragma: no cover
                pass
        return n

    @property
    def pending(self) -> int:
        return len(self._pending)
