"""Micro-batching front-end: queue, deadline flush, padded-bucket launch —
the core of ``shifu_tpu.serve.batcher``.

Requests (single rows or bursts of rows) append to a queue; a worker
drains it into the smallest covering bucket of the ladder, pads the
remainder (counted), and launches the scorer.  Flush fires when a full top
bucket is queued or when the oldest queued request has waited
``max_delay_s``.  Wall-clock is injectable (``clock=``) and the drain path
is callable in-process (:meth:`MicroBatcher.pump`), so tests drive the
deadline semantics without sleeps; only a started server runs the worker
thread.  (Admission control, request deadlines, tracing, score logging and
ladder refinement of the reference wait for a later slice.)
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .scorer import AOTScorer, covering_bucket

log = logging.getLogger(__name__)


class Ticket:
    """Completion handle for one submitted burst of rows.  A burst may span
    several launches; the event fires when every row has a score (or its
    batch errored)."""

    __slots__ = ("stamps", "scores", "_pending", "_event", "error", "_lock")

    def __init__(self, n: int, stamps: np.ndarray):
        self.stamps = stamps                  # arrival time per row
        self.scores = np.empty(n, np.float32)
        self._pending = n
        self._event = threading.Event()
        self._lock = threading.Lock()
        self.error: Optional[BaseException] = None

    def _complete(self, sl: slice, scores: Optional[np.ndarray],
                  error: Optional[BaseException]) -> None:
        if error is None:
            self.scores[sl] = scores
        else:
            self.error = error
        with self._lock:
            self._pending -= sl.stop - sl.start
            done = self._pending <= 0
        if done:
            self._event.set()

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until every row is scored; raises the batch error if the
        request died with its batch."""
        if not self._event.wait(timeout):
            raise TimeoutError("scoring request timed out")
        if self.error is not None:
            raise self.error
        return self.scores


class MicroBatcher:
    """See module docs.  ``scorer_provider`` is read once per flush."""

    def __init__(self, scorer_provider: Callable[[], AOTScorer],
                 max_delay_s: float = 0.002,
                 clock: Callable[[], float] = time.monotonic):
        self._provider = scorer_provider
        self.max_delay_s = float(max_delay_s)
        self.clock = clock
        self._cond = threading.Condition()
        # queue of (ticket, rows, bins, row_offset, raw): row_offset = how
        # many of this burst's rows earlier flushes already consumed; raw
        # marks packed raw-record bursts — a launch never mixes the two
        self._queue: deque = deque()
        self._queued_rows = 0
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.stats: Dict[str, float] = {
            "requests": 0, "rows": 0, "batches": 0, "rows_padded": 0,
            "flush_full": 0, "flush_deadline": 0, "errors": 0}
        self.bucket_counts: Dict[int, int] = {}

    # ------------------------------------------------------------ submit
    def submit_burst(self, rows: np.ndarray,
                     bins: Optional[np.ndarray] = None,
                     stamps: Optional[np.ndarray] = None,
                     raw: bool = False) -> Ticket:
        """A burst of rows — one queue append, one shared ticket.
        ``stamps`` records ideal arrival times; ``raw=True`` marks ``rows``
        as PACKED raw-record wire rows."""
        n = len(rows)
        if stamps is None:
            stamps = np.full(n, self.clock())
        t = Ticket(n, np.asarray(stamps, np.float64))
        with self._cond:
            if self._stop:
                raise RuntimeError("batcher is stopped")
            self._queue.append((t, rows, bins, 0, raw))
            self._queued_rows += n
            self.stats["requests"] += 1
            self._cond.notify_all()
        return t

    @property
    def queue_depth(self) -> int:
        """Rows currently queued."""
        return self._queued_rows

    # ------------------------------------------------------------- drain
    def _top_bucket(self) -> int:
        return self._provider().buckets[-1]

    def _oldest_stamp(self) -> Optional[float]:
        return float(self._queue[0][0].stamps[self._queue[0][3]]) \
            if self._queue else None

    def _take(self, max_rows: int) -> List[Tuple[Ticket, np.ndarray,
                                                 Optional[np.ndarray], int,
                                                 bool]]:
        """Pop up to ``max_rows`` rows off the queue head (splitting a burst
        that straddles the boundary), stopping at a raw/pre-binned kind
        boundary.  Caller holds the lock."""
        out, taken = [], 0
        kind: Optional[bool] = None
        while self._queue and taken < max_rows:
            t, rows, bins, off, raw = self._queue[0]
            if kind is None:
                kind = raw
            elif raw != kind:
                break
            self._queue.popleft()
            take = min(max_rows - taken, len(rows) - off)
            out.append((t, rows[off:off + take],
                        None if bins is None else bins[off:off + take],
                        off, raw))
            taken += take
            if off + take < len(rows):
                self._queue.appendleft((t, rows, bins, off + take, raw))
        self._queued_rows -= taken
        return out

    def pump(self, now: Optional[float] = None, force: bool = False) -> int:
        """In-process drain: flush ONE batch if a flush condition holds
        (full top bucket queued, the oldest request's deadline passed, or
        ``force``).  Returns rows flushed (0 = no flush due)."""
        now = self.clock() if now is None else now
        with self._cond:
            if not self._queue:
                return 0
            full = self._queued_rows >= self._top_bucket()
            deadline_hit = now - self._oldest_stamp() >= self.max_delay_s
            if not (full or deadline_hit or force):
                return 0
            parts = self._take(self._top_bucket())
            self.stats["flush_full" if full else "flush_deadline"] += 1
        return self._launch(parts)

    def drain(self, timeout: float = 30.0) -> None:
        """Flush everything queued right now (shutdown / tests)."""
        deadline = time.monotonic() + timeout
        while True:
            with self._cond:
                if not self._queue:
                    return
            if self.pump(force=True) == 0 and time.monotonic() > deadline:
                raise TimeoutError("batcher drain timed out")

    # ------------------------------------------------------------ launch
    def _launch(self, parts) -> int:
        n = sum(len(rows) for _, rows, _, _, _ in parts)
        if n == 0:
            return 0
        raw_kind = parts[0][4]
        err: Optional[BaseException] = None
        mean = None
        bucket = n
        # assembly stays INSIDE the try: mismatched widths or missing bins
        # fail this batch's tickets, not the worker
        try:
            scorer = self._provider()
            bucket = covering_bucket(scorer.buckets, n)
            rows = np.concatenate([r for _, r, _, _, _ in parts], axis=0) \
                if len(parts) > 1 else parts[0][1]
            if raw_kind:
                raw = scorer.score_batch_raw(rows)
            else:
                bins = None
                if scorer.needs_bins:
                    bins = np.concatenate([b for _, _, b, _, _ in parts],
                                          axis=0) \
                        if len(parts) > 1 else parts[0][2]
                raw = scorer.score_batch(rows, bins)
            mean = raw.mean(axis=1).astype(np.float32)
        except Exception as e:              # noqa: BLE001 — tickets carry it
            err = e
        off = 0
        for t, r, _, src_off, _ in parts:
            t._complete(slice(src_off, src_off + len(r)),
                        None if err is not None else mean[off:off + len(r)],
                        err)
            off += len(r)
        with self._cond:
            self.stats["batches"] += 1
            self.stats["rows"] += n
            self.stats["rows_padded"] += max(bucket - n, 0)
            self.bucket_counts[bucket] = \
                self.bucket_counts.get(bucket, 0) + 1
            if err is not None:
                self.stats["errors"] += 1
        return n

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "MicroBatcher":
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="shifu-torch-serve-batcher")
        self._thread.start()
        return self

    def _run(self) -> None:
        while True:
            try:
                with self._cond:
                    while not self._queue and not self._stop:
                        self._cond.wait()
                    if self._stop and not self._queue:
                        return
                    # coalesce: wait for the top bucket to fill, but never
                    # past the oldest request's deadline
                    while (self._queued_rows < self._top_bucket()
                           and not self._stop):
                        remaining = (self._oldest_stamp() + self.max_delay_s
                                     - self.clock())
                        if remaining <= 0:
                            break
                        self._cond.wait(timeout=remaining)
                self.pump(force=True)
            except Exception:               # noqa: BLE001 — worker survives
                log.exception("serve batch failed; batcher continues")
                time.sleep(0.05)

    def stop(self, drain: bool = True) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        if drain:
            self.drain()
