"""Sampled prediction logging from the serve path — the quality feed;
the port of ``shifu_tpu.obs.scorelog``.  Segments are byte-compatible
both ways: either package's :func:`read_score_records` reads the other's
segments, rotation and budget file names included.

The reference's ``posttrain`` step computes score-distribution stats
once, offline, from the eval run; production then flies blind.  This
module is the live half of that loop: the micro-batcher taps every
completed launch and, for the head-sampled fraction of requests, appends
one JSON record per request — timestamp, serving model generation,
request id, scores, and (when present) the sampled bin vector — into
bounded append-only segments under ``<modelset>/telemetry/scorelog/``.

Crash-safety contract (the torn-trace-line contract, at segment
granularity): the active segment is written as ``seg-NNNNNN.jsonl.open``
and COMMITTED by an atomic ``os.replace`` to ``seg-NNNNNN.jsonl`` at
rotation.  A crash mid-segment leaves a ``.open`` orphan: readers skip
it with a surfaced count, committed segments are untouched, and the next
writer sweeps the orphan and continues at the next index.  A disk budget
(``-Dshifu.scorelog.budgetBytes``) prunes the OLDEST committed segments
so the log can run unattended.

Zero-cost when off (the default): ``-Dshifu.scorelog.sampleRate`` is 0,
the server constructs no :class:`ScoreLog`, and the batcher's tap is one
``is not None`` check per launch.  Sampling itself is head-sampling —
one RNG draw per scored request, before any formatting.

Single-writer by design: one serve process owns a model set's score log
(the same assumption the heartbeat and journal planes make).
"""

from __future__ import annotations

import json
import logging
import os
import random
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .. import faults
from . import registry

log = logging.getLogger(__name__)

SEGMENT_PREFIX = "seg-"
SEGMENT_SUFFIX = ".jsonl"
OPEN_SUFFIX = ".open"

DEFAULT_SEGMENT_BYTES = 1 << 20          # 1 MiB per committed segment
DEFAULT_BUDGET_BYTES = 64 << 20          # 64 MiB total, oldest pruned


def scorelog_dir(model_set_dir: str) -> str:
    return os.path.join(model_set_dir, "telemetry", "scorelog")


def _float_knob(name: str, override, default: float) -> float:
    if override is not None:
        return float(override)
    from ..config import environment
    p = environment.get_property(name)
    if p is not None:
        try:
            return float(p)
        except (TypeError, ValueError):
            pass
    return default


def scorelog_sample_rate(override: Optional[float] = None) -> float:
    """``-Dshifu.scorelog.sampleRate`` (0..1, default 0 = the whole
    quality plane off)."""
    return min(max(_float_knob("shifu.scorelog.sampleRate", override,
                               0.0), 0.0), 1.0)


def scorelog_segment_bytes(override: Optional[int] = None) -> int:
    """``-Dshifu.scorelog.segmentBytes`` — bytes per segment before
    atomic rotation."""
    return max(int(_float_knob("shifu.scorelog.segmentBytes", override,
                               DEFAULT_SEGMENT_BYTES)), 1)


def scorelog_budget_bytes(override: Optional[int] = None) -> int:
    """``-Dshifu.scorelog.budgetBytes`` — total committed-segment disk
    budget; oldest segments pruned past it."""
    return max(int(_float_knob("shifu.scorelog.budgetBytes", override,
                               DEFAULT_BUDGET_BYTES)), 1)


class ScoreLog:
    """Bounded append-only score log with atomic segment rotation.

    ``gen_fn`` supplies the CURRENT serving generation at log time (the
    registry's swap counter), so records written across a hot-swap are
    attributed to the model that actually scored them.  ``on_log`` is
    the in-process fast path to the join/quality plane — called with
    ``(req, scores, gen, ts)`` for every sampled record, so the quality
    monitor never re-reads its own segments.
    """

    def __init__(self, root: str, sample_rate: Optional[float] = None,
                 segment_bytes: Optional[int] = None,
                 budget_bytes: Optional[int] = None,
                 gen_fn: Optional[Callable[[], int]] = None,
                 on_log: Optional[Callable] = None,
                 clock: Callable[[], float] = time.time):
        self.root = root
        self.sample_rate = scorelog_sample_rate(sample_rate)
        self.segment_bytes = scorelog_segment_bytes(segment_bytes)
        self.budget_bytes = scorelog_budget_bytes(budget_bytes)
        self._gen_fn = gen_fn
        self._on_log = on_log
        self._clock = clock
        self._rng = random.Random(0x5C02E)
        self.stats: Dict[str, int] = {"records": 0, "segments": 0,
                                      "pruned": 0, "write_errors": 0}
        os.makedirs(self.root, exist_ok=True)
        self.recovered = self._sweep_orphans()
        self._seq = self._next_seq()
        self._file = None
        self._path = None
        self._bytes = 0

    # ------------------------------------------------------------ recovery
    def _sweep_orphans(self) -> int:
        """A ``.open`` segment on startup is a previous writer's torn
        final segment (killed mid-write or mid-rotation): drop it —
        committed segments carry the durable history."""
        n = 0
        for name in os.listdir(self.root):
            if name.endswith(OPEN_SUFFIX):
                try:
                    os.remove(os.path.join(self.root, name))
                    n += 1
                except OSError:         # pragma: no cover
                    log.warning("scorelog orphan sweep failed",
                                exc_info=True)
        return n

    def _next_seq(self) -> int:
        seqs = [int(n[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)])
                for n in os.listdir(self.root)
                if n.startswith(SEGMENT_PREFIX)
                and n.endswith(SEGMENT_SUFFIX)]
        return max(seqs) + 1 if seqs else 0

    # ------------------------------------------------------------- logging
    def log(self, req_id: Optional[str], scores,
            bins=None, gen: Optional[int] = None,
            ts: Optional[float] = None) -> Optional[str]:
        """Head-sampled append of one scored request; returns the
        request id when the record was sampled, else ``None``."""
        if self._rng.random() >= self.sample_rate:
            return None
        req = req_id if req_id is not None else os.urandom(8).hex()
        if gen is None:
            gen = int(self._gen_fn()) if self._gen_fn is not None else 0
        if ts is None:
            ts = self._clock()
        scores = np.asarray(scores, np.float32).ravel()
        rec: Dict[str, Any] = {
            "ts": round(float(ts), 3), "gen": int(gen), "req": req,
            "scores": [round(float(s), 6) for s in scores]}
        if bins is not None:
            rec["bins"] = np.asarray(bins).astype(int).tolist()
        try:
            self._append(json.dumps(rec, sort_keys=True) + "\n")
        except OSError:
            self.stats["write_errors"] += 1
            log.warning("scorelog append failed", exc_info=True)
        self.stats["records"] += 1
        registry.counter("scorelog.records").inc()
        if self._on_log is not None:
            self._on_log(req, scores, int(gen), float(ts))
        return req

    def _append(self, line: str) -> None:
        if self._file is None:
            self._path = os.path.join(
                self.root,
                f"{SEGMENT_PREFIX}{self._seq:06d}{SEGMENT_SUFFIX}"
                f"{OPEN_SUFFIX}")
            # the .open suffix IS the torn marker; commit is the atomic
            # rename at rotation
            self._file = open(self._path, "a")
            self._bytes = 0
        self._file.write(line)
        self._file.flush()
        self._bytes += len(line)
        if self._bytes >= self.segment_bytes:
            self._rotate()

    def _rotate(self) -> None:
        """Commit the active segment: fsync + atomic rename drops the
        ``.open`` torn marker in one step."""
        f, path = self._file, self._path
        self._file = None
        f.flush()
        os.fsync(f.fileno())
        f.close()
        faults.fire("obs", "scorelog", self._seq, path=path)
        os.replace(path, path[:-len(OPEN_SUFFIX)])
        self._seq += 1
        self._bytes = 0
        self.stats["segments"] += 1
        registry.counter("scorelog.segments").inc()
        self._enforce_budget()

    def _enforce_budget(self) -> None:
        names = sorted(n for n in os.listdir(self.root)
                       if n.startswith(SEGMENT_PREFIX)
                       and n.endswith(SEGMENT_SUFFIX))
        sizes = {}
        for n in names:
            try:
                sizes[n] = os.path.getsize(os.path.join(self.root, n))
            except OSError:             # pragma: no cover
                sizes[n] = 0
        total = sum(sizes.values())
        pruned = 0
        for n in names[:-1]:            # never prune the newest segment
            if total <= self.budget_bytes:
                break
            try:
                os.remove(os.path.join(self.root, n))
            except OSError:             # pragma: no cover
                continue
            total -= sizes[n]
            pruned += 1
        if pruned:
            self.stats["pruned"] += pruned
            registry.counter("scorelog.pruned_segments").inc(pruned)

    def close(self) -> None:
        """Clean shutdown commits the partial tail segment (only a
        CRASH leaves a torn ``.open``)."""
        if self._file is not None and self._bytes > 0:
            try:
                self._rotate()
            except OSError:             # pragma: no cover
                log.warning("scorelog close rotation failed",
                            exc_info=True)
        elif self._file is not None:
            self._file.close()
            self._file = None


def read_score_records(root: str,
                       skipped: Optional[List[str]] = None
                       ) -> List[Dict[str, Any]]:
    """Every record in COMMITTED segments, oldest first.  Uncommitted
    ``.open`` segments (a crashed writer's torn tail) and torn JSON
    lines are skipped with their names appended to ``skipped`` — the
    torn-trace-line contract."""
    recs: List[Dict[str, Any]] = []
    if not os.path.isdir(root):
        return recs
    for name in sorted(os.listdir(root)):
        if name.endswith(OPEN_SUFFIX):
            if skipped is not None:
                skipped.append(name)
            continue
        if not (name.startswith(SEGMENT_PREFIX)
                and name.endswith(SEGMENT_SUFFIX)):
            continue
        with open(os.path.join(root, name)) as f:
            for i, line in enumerate(f):
                try:
                    recs.append(json.loads(line))
                except ValueError:
                    if skipped is not None:
                        skipped.append(f"{name}:{i + 1}")
    return recs
