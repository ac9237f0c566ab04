"""Live-model registry: modelset-keyed scorers with atomic hot-swap — the
port of ``shifu_tpu.serve.registry``.  The journal's layout is the
reference's, so either package restores a journal the other wrote.

A serving process holds one :class:`AOTScorer` per modelset.  Promoting
a retrained model must never drop requests, so a swap is journal-style:

1. BUILD — load the candidate's models and capture every bucket rung's
   CUDA graph, entirely off-line (the live scorer keeps serving), so a
   commit costs no capture;
2. JOURNAL — commit ``serving.json`` via :mod:`shifu_tpu.ioutil`'s
   atomic write (a restart re-resolves to whatever was last promoted —
   a crash mid-commit leaves the previous journal intact, and a crash
   between the commit and the flip re-promotes the candidate on
   restart: the journal is write-ahead);
3. FLIP — one reference assignment under the lock.  In-flight batches
   finish on the old scorer (the batcher reads the provider per flush);
   the next batch scores on the new one.  A journal failure (disk full,
   perms) raises BEFORE the flip, so the previous model stays live.

The registry keeps a bounded GENERATION HISTORY per key (previous
serving docs + their scorers/model dirs, ``-Dshifu.serve.generations``
deep): :meth:`rollback` re-flips to the prior generation through the
SAME journal-first path — the continual-refresh controller's escape
hatch when a promotion burns its probation window.  Generation numbers
are monotonic (a post-rollback promotion never reuses a number), and
``serving.json`` records the history so a restarted process can resolve
*and* roll back.

Fault site: ``serve:swap=<key>`` fires after BUILD and before
JOURNAL+FLIP — on the swap AND rollback paths — a crash or injected
error there must leave the currently-live model serving bit-identical
scores.

For a FLEET-coordinated swap the two phases are exposed separately:
:meth:`prepare` runs BUILD and holds the warmed candidate pending
(the live model keeps serving, nothing is journalled), then
:meth:`commit` runs JOURNAL+FLIP, or :meth:`abort` discards the
candidate.  A router prepares every replica before committing any, so
no request ever sees a mixed-model fleet; :meth:`swap` is simply
prepare+commit in one call.

A registry may carry a :class:`~shifu_tpu_torch.serve.transform.FusedTransform`
per key (``load(..., transform=...)``): it is threaded into every
scorer the registry builds — swap, rollback rebuild, restore — so the
raw-record path survives promotion.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

from .. import faults, obs, resolve_device
from ..eval.scorer import SCORE_SCALE, load_models
from ..ioutil import atomic_write_json
from .scorer import AOTScorer

log = logging.getLogger(__name__)

SERVING_JOURNAL = "serving.json"

DEFAULT_GENERATIONS = 3


def history_limit(override: Optional[int] = None) -> int:
    """Bounded generation history depth: ``shifu.serve.generations``
    previous generations kept rollback-able (default 3)."""
    if override is not None:
        return max(0, int(override))
    from ..config import environment
    return max(0, environment.get_int("shifu.serve.generations",
                                      DEFAULT_GENERATIONS))


class _Generation(NamedTuple):
    gen: int
    scorer: Optional[AOTScorer]     # None = rebuildable from models_dir
    models_dir: Optional[str]
    promoted_ts: float


class _Pending(NamedTuple):
    """A prepared-but-uncommitted swap candidate (see :meth:`prepare`)."""
    gen: int
    scorer: AOTScorer
    models_dir: Optional[str]
    buckets: Optional[tuple]
    transform: Optional[object]


class ModelRegistry:
    """See module docs.  ``state_dir=None`` keeps the journal in-memory
    only (tests, embedded use); every scorer lives on ``device`` (default
    CUDA)."""

    def __init__(self, state_dir: Optional[str] = None, device=None):
        self.state_dir = state_dir
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._live: Dict[str, AOTScorer] = {}
        self._gen: Dict[str, int] = {}
        self._dirs: Dict[str, str] = {}
        self._hist: Dict[str, List[_Generation]] = {}
        self._peak: Dict[str, int] = {}      # highest gen ever (monotonic)
        self._buckets: Dict[str, Optional[tuple]] = {}   # last ladder used
        self._transforms: Dict[str, Optional[object]] = {}  # FusedTransform
        self._pending: Dict[str, _Pending] = {}   # prepared, uncommitted

    # ------------------------------------------------------------ lookup
    def get(self, key: str) -> AOTScorer:
        with self._lock:
            try:
                return self._live[key]
            except KeyError:
                raise KeyError(f"no live model under {key!r} — load() or "
                               "swap() one first") from None

    def provider(self, key: str):
        """A per-flush scorer resolver for :class:`MicroBatcher`."""
        return lambda: self.get(key)

    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._live)

    def generation(self, key: str) -> int:
        with self._lock:
            return self._gen.get(key, 0)

    def next_generation(self, key: str) -> int:
        """The number the NEXT promotion will take — monotonic past the
        peak, so a rolled-back generation's number is never reused."""
        with self._lock:
            return self._peak.get(key, 0) + 1

    def models_dir(self, key: str) -> Optional[str]:
        """The directory the live generation was loaded from (None for
        in-memory models)."""
        with self._lock:
            return self._dirs.get(key)

    def relocate(self, key: str, models_dir: str) -> None:
        """Re-point the live generation at ``models_dir``, a copy of the
        files it was loaded from, and commit the journal: the refresh
        loop moves the incumbent out of the training workspace before a
        retrain overwrites it, so a rollback to it (a restarted process's
        too) loads the incumbent again."""
        with self._lock:
            if key not in self._live:
                raise KeyError(f"relocate({key!r}) before load()")
            self._dirs[key] = models_dir
        self._journal()

    def generation_history(self, key: str) -> List[Dict]:
        """Previous generations (oldest first) still rollback-able."""
        with self._lock:
            return [{"generation": g.gen, "models_dir": g.models_dir,
                     "promoted_ts": g.promoted_ts}
                    for g in self._hist.get(key, [])]

    # ------------------------------------------------------- load / swap
    def _build(self, key: str, models_or_dir, scale: float,
               buckets: Optional[Sequence[int]], gen: int,
               warm: bool, transform=None) -> AOTScorer:
        models = load_models(models_or_dir) \
            if isinstance(models_or_dir, str) else list(models_or_dir)
        scorer = AOTScorer(models, scale=scale, buckets=buckets,
                           name=f"serve.score.{key}.g{gen}",
                           transform=transform, device=self.device)
        if warm:
            scorer.warm()
        return scorer

    def load(self, key: str, models_or_dir, scale: float = SCORE_SCALE,
             buckets: Optional[Sequence[int]] = None,
             warm: bool = True, transform=None) -> AOTScorer:
        """First load of a modelset (no previous model to protect);
        accepts a models dir or an in-memory model sequence.  A
        ``transform`` (:class:`FusedTransform`) enables the raw-record
        graphs and is carried into every later rebuild."""
        scorer = self._build(key, models_or_dir, scale, buckets, 0, warm,
                             transform)
        new_dir = models_or_dir if isinstance(models_or_dir, str) else None
        self._journal(pending={key: (new_dir, 0)})
        with self._lock:
            self._live[key] = scorer
            self._gen[key] = 0
            self._peak[key] = max(self._peak.get(key, 0), 0)
            self._hist.setdefault(key, [])
            self._buckets[key] = tuple(buckets) if buckets else None
            self._transforms[key] = transform
            if new_dir is not None:
                self._dirs[key] = new_dir
        return scorer

    def restore(self, key: str, default_models_dir: str,
                scale: float = SCORE_SCALE,
                buckets: Optional[Sequence[int]] = None,
                warm: bool = True, transform=None) -> AOTScorer:
        """Resolve the serving journal and load whatever was last
        promoted under ``key`` (falling back to ``default_models_dir``
        for a never-promoted set), restoring the recorded generation
        number and the rollback history (scorers rebuild lazily from
        their model dirs) — the restart path of a serving/refresh
        process."""
        doc = self._read_journal().get(key) or {}
        mdir = doc.get("models_dir") or default_models_dir
        gen = int(doc.get("generation") or 0)
        hist = [h for h in (doc.get("history") or [])
                if h.get("models_dir")]
        scorer = self._build(key, mdir, scale, buckets, gen, warm,
                             transform)
        with self._lock:
            self._live[key] = scorer
            self._gen[key] = gen
            self._dirs[key] = mdir
            self._transforms[key] = transform
            self._hist[key] = [
                _Generation(int(h["generation"]), None, h["models_dir"],
                            float(h.get("promoted_ts") or 0.0))
                for h in hist]
            self._peak[key] = max([gen] + [int(h["generation"])
                                           for h in hist])
            self._buckets[key] = tuple(buckets) if buckets else None
        # re-commit the resolved doc: a never-promoted set gets its
        # first journal here, and a pruned history is recorded
        self._journal()
        log.info("restored %s at generation %d (%d prior generation(s) "
                 "rollback-able)", key, gen, len(hist))
        return scorer

    def prepare(self, key: str, models_or_dir, scale: float = SCORE_SCALE,
                buckets: Optional[Sequence[int]] = None,
                warm: bool = True, transform=None) -> int:
        """Phase 1 of a swap: BUILD the candidate (load, and capture
        every bucket rung) and hold it PENDING — the live
        model keeps serving and nothing is journalled, so a fleet
        router can prepare EVERY replica before committing any.
        Returns the generation the candidate will take on
        :meth:`commit`; :meth:`abort` discards it.  The number is not
        reserved until commit, so an aborted or failed prepare lets the
        next promotion take the same number."""
        with self._lock:
            if key not in self._live:
                raise KeyError(f"prepare({key!r}) before load() — "
                               "nothing is live to replace")
            gen = self._peak.get(key, self._gen[key]) + 1
            if transform is None:
                transform = self._transforms.get(key)
        # BUILD off-line: the expensive part happens while the old
        # scorer keeps serving
        scorer = self._build(key, models_or_dir, scale, buckets, gen,
                             warm, transform)
        new_dir = models_or_dir if isinstance(models_or_dir, str) else None
        with self._lock:
            self._pending[key] = _Pending(
                gen, scorer, new_dir,
                tuple(buckets) if buckets else None, transform)
        return gen

    def commit(self, key: str) -> AOTScorer:
        """Phase 2 of a swap: JOURNAL then FLIP the PENDING candidate
        (module docs — a failure before the flip leaves the previous
        model live and the candidate discarded)."""
        with self._lock:
            if key not in self._pending:
                raise KeyError(f"commit({key!r}) without a prepare()")
            pend = self._pending.pop(key)
            # interleaved promotions may have moved the peak since
            # prepare: never reuse a taken number
            gen = max(pend.gen, self._peak.get(key, 0) + 1)
            prev = _Generation(self._gen[key], self._live[key],
                               self._dirs.get(key), round(time.time(), 3))
        # a crash from here to the flip must leave the OLD model live
        faults.fire("serve", "swap", key)
        # JOURNAL before FLIP (module docs): a journal failure raises
        # while the old model is still live; once committed, the flip is
        # one infallible reference assignment.  The journal records the
        # post-flip history (incumbent demoted into it, bounded).
        limit = history_limit()
        with self._lock:
            hist_after = (self._hist.get(key, []) + [prev])[-limit:] \
                if limit else []
        self._journal(pending={key: (pend.models_dir, gen)},
                      history={key: hist_after})
        with self._lock:
            self._hist[key] = hist_after
            self._live[key] = pend.scorer
            self._gen[key] = gen
            self._peak[key] = max(self._peak.get(key, 0), gen)
            self._buckets[key] = pend.buckets
            self._transforms[key] = pend.transform
            if pend.models_dir is not None:
                self._dirs[key] = pend.models_dir
        obs.counter("serve.swaps").inc()
        log.info("promoted %s generation %d", key, gen)
        return pend.scorer

    def abort(self, key: str) -> bool:
        """Discard a PENDING candidate (canary losers, a fleet-mate's
        failed prepare).  The live model never moved; returns whether
        anything was pending."""
        with self._lock:
            return self._pending.pop(key, None) is not None

    def pending_generation(self, key: str) -> Optional[int]:
        """The generation a PENDING candidate will take, or None."""
        with self._lock:
            pend = self._pending.get(key)
            return None if pend is None else pend.gen

    def swap(self, key: str, models_or_dir, scale: float = SCORE_SCALE,
             buckets: Optional[Sequence[int]] = None,
             warm: bool = True, transform=None) -> AOTScorer:
        """Atomic hot-swap (see module docs): :meth:`prepare` +
        :meth:`commit` in one call.  Raises if the build or journal
        fails — the previous model stays live in that case."""
        self.prepare(key, models_or_dir, scale, buckets, warm, transform)
        return self.commit(key)

    def rollback(self, key: str, warm: bool = True) -> AOTScorer:
        """Re-flip to the previous generation through the same
        journal-first path as :meth:`swap`: journal commits the
        post-rollback doc first, then one reference assignment.  The
        prior generation's scorer is reused when still held (bit-
        identical scores by construction) or rebuilt from its recorded
        model dir.  Raises with the CURRENT model still live when there
        is no history (or the journal fails)."""
        with self._lock:
            if key not in self._live:
                raise KeyError(f"rollback({key!r}) before load()")
            hist = list(self._hist.get(key) or [])
            if not hist:
                raise LookupError(
                    f"rollback({key!r}): no previous generation held — "
                    "the history window (shifu.serve.generations) is "
                    "empty")
            prev = hist[-1]
            cur_gen = self._gen[key]
        scorer = prev.scorer
        if scorer is None:
            # restored-process history entry: rebuild from the dir the
            # journal recorded (off-line, like a swap's BUILD phase) on
            # the key's own bucket ladder — same launch shapes, same
            # bits
            scorer = self._build(key, prev.models_dir, SCORE_SCALE,
                                 self._buckets.get(key), prev.gen, warm,
                                 self._transforms.get(key))
        # same crash-safety contract as swap: a death here leaves the
        # CURRENT model live and the journal un-flipped
        faults.fire("serve", "swap", key)
        self._journal(pending={key: (prev.models_dir, prev.gen)},
                      history={key: hist[:-1]})
        with self._lock:
            self._hist[key] = hist[:-1]
            self._live[key] = scorer
            self._gen[key] = prev.gen
            if prev.models_dir is not None:
                self._dirs[key] = prev.models_dir
        obs.counter("serve.rollbacks").inc()
        log.info("rolled back %s generation %d -> %d", key, cur_gen,
                 prev.gen)
        return scorer

    # ------------------------------------------------------------ journal
    def _read_journal(self) -> Dict[str, dict]:
        if not self.state_dir:
            return {}
        try:
            with open(os.path.join(self.state_dir, SERVING_JOURNAL)) as f:
                doc = json.load(f)
            return doc if isinstance(doc, dict) else {}
        except (OSError, ValueError):
            return {}

    def _journal(self, pending: Optional[Dict[str, tuple]] = None,
                 history: Optional[Dict[str, List[_Generation]]] = None
                 ) -> None:
        """Commit the serving journal.  ``pending`` maps key ->
        ``(models_dir|None, generation)`` for a promotion/rollback that
        is being journalled BEFORE its flip (write-ahead); ``history``
        carries the post-flip generation history for those keys."""
        if not self.state_dir:
            return
        with self._lock:
            keys = set(self._live)
            dirs = dict(self._dirs)
            gens = dict(self._gen)
            hists = {k: list(v) for k, v in self._hist.items()}
        for k, (mdir, gen) in (pending or {}).items():
            keys.add(k)
            gens[k] = gen
            if mdir is not None:
                dirs[k] = mdir
        for k, h in (history or {}).items():
            hists[k] = list(h)
        doc = {k: {"models_dir": dirs.get(k),
                   "generation": gens.get(k, 0),
                   "promoted_ts": round(time.time(), 3),
                   "history": [{"generation": g.gen,
                                "models_dir": g.models_dir,
                                "promoted_ts": g.promoted_ts}
                               for g in hists.get(k, [])]}
               for k in sorted(keys)}
        os.makedirs(self.state_dir, exist_ok=True)
        atomic_write_json(os.path.join(self.state_dir, SERVING_JOURNAL),
                          doc)
