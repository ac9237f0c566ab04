"""Micro-batching front-end: queue, deadline flush, padded-bucket launch —
the port of ``shifu_tpu.serve.batcher``.

Requests (single rows or bursts of rows) append to a queue; a worker
drains it into the smallest covering bucket of the ladder, pads the
remainder (counted), and replays that rung's captured graph.  Flush fires when a full top bucket is
queued (throughput wins at high load) or when the oldest queued request
has waited ``max_delay_s`` (p99 stays bounded at low load).

Wall-clock is injectable (``clock=``) and the drain path is callable
in-process (:meth:`pump`), so unit tests drive deadline semantics with
a fake clock and zero sleeps; only the real server starts the worker
thread (:meth:`start`).

Fault site: ``serve:request=<batch#>`` fires before batch ``<batch#>``'s
device launch — an ``ioerror`` there fails exactly that batch's tickets
(the error propagates to the waiting callers) and must leave the scorer
and registry fully serviceable for the next request.
``serve:admit=<shed#>`` fires while the <shed#>-th submit is being
rejected at the admission cap — the die-during-shed drill.

Overload protection (:mod:`.overload`): admission is
BOUNDED — ``-Dshifu.serve.maxQueueRows`` (0 = auto, 128x the top rung)
caps queued rows, and a submit that would exceed it fast-fails with a
coded :class:`OverloadedError` carrying a ``Retry-After`` derived from
the drain-rate EWMA the launch path maintains.  Requests carry a
DEADLINE (``deadline_ms=`` / ``-Dshifu.serve.requestDeadlineMs``,
measured from the ideal arrival stamp); :meth:`pump` sheds tickets
whose deadline already passed — and tickets the client abandoned via a
:meth:`Ticket.wait` timeout — BEFORE pad/launch, so dead work never
reaches the device and the shed caller gets a coded
:class:`DeadlineExceededError`, never a silently-dropped result.

Per-request tracing (head-sampled, ``-Dshifu.serve.traceSampleRate``,
default 0 = off): a sampled request carries a trace id from submit
through batch assembly into the device launch and decomposes into
queue-wait (submit -> taken off the queue; ``deadline_wait_s`` marks the
part attributable to the deadline coalescing window), pad (burst
concatenate + the scorer's pad copy), launch (argument prep + host
fetch) and device (copy in, graph replay, copy out) — segments that sum, within
scheduler noise, to the request's end-to-end latency.  Each sampled
batch emits a ``serve.batch`` span linking its member requests' trace
ids (fan-in causality); both land on the ``shifu-serve`` timeline track
via :func:`shifu_tpu_torch.obs.record_span`.  With sampling off the hot path
pays ONE float compare per submit and nothing per batch, matching the
plane's zero-cost convention; an explicit ``trace_id`` (the
``X-Shifu-Trace`` header) forces sampling for that request.

Score logging (the quality plane's feed): when the server wires a
:class:`shifu_tpu_torch.obs.scorelog.ScoreLog` onto ``self.scorelog``, every
completed launch offers its per-request mean scores to the log's own
head sampler, keyed by the request id carried on the ticket
(``req_id=``, the ``X-Shifu-Request`` header).  ``scorelog`` defaults to
``None`` — one ``is not None`` check per launch, nothing per submit.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import faults, obs
from .overload import (AUTO_QUEUE_BUCKETS, DeadlineExceededError,
                       OverloadedError, configured_deadline_s,
                       configured_max_queue_rows)
from .scorer import AOTScorer, covering_bucket, refine_ladder

log = logging.getLogger(__name__)


def configured_trace_sample_rate() -> float:
    """Head-sampling probability for per-request tracing: property
    ``shifu.serve.traceSampleRate`` in [0, 1], default 0 (off)."""
    from ..config import environment
    rate = environment.get_float("shifu.serve.traceSampleRate", 0.0)
    return min(max(rate, 0.0), 1.0)


def configured_refine_every() -> int:
    """Batches between occupancy-driven ladder refinements (property
    ``shifu.serve.bucketRefineEvery``; 0 disables).  Default 512: often
    enough to adapt to a load shift within seconds at serving rates,
    rare enough that the (background, ahead-of-use) captures are
    noise."""
    from ..config import environment
    return max(0, environment.get_int("shifu.serve.bucketRefineEvery",
                                      512))


def _mint_trace_id() -> str:
    return os.urandom(8).hex()


class _ReqTrace:
    """Per-sampled-request trace state carried on the ticket: the trace
    id, submit timestamps, and the latency decomposition accumulated as
    the request's rows move through one or more batches."""

    __slots__ = ("trace_id", "ts", "t0", "taken", "queue_wait_s",
                 "deadline_wait_s", "pad_s", "launch_s", "device_s",
                 "batches", "flushes")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.ts = time.time()                 # wall clock (span ts)
        self.t0 = time.perf_counter()         # duration basis
        self.taken = False
        self.queue_wait_s = 0.0
        self.deadline_wait_s = 0.0
        self.pad_s = 0.0
        self.launch_s = 0.0
        self.device_s = 0.0
        self.batches = 0
        self.flushes: List[str] = []


class Ticket:
    """Completion handle for one submitted burst of rows.  A burst may
    span several device launches; the event fires when every row has a
    score (or its batch errored).  One event per BURST, not per row —
    the per-request cost at high load is an array append."""

    __slots__ = ("n", "stamps", "scores", "done_ts", "_pending", "_event",
                 "error", "_lock", "trace", "req", "deadline", "cancelled")

    def __init__(self, n: int, stamps: np.ndarray,
                 trace: Optional[_ReqTrace] = None,
                 req: Optional[str] = None,
                 deadline: Optional[float] = None):
        self.n = n
        self.stamps = stamps                  # arrival time per row
        self.scores = np.empty(n, np.float32)
        self.done_ts = np.empty(n, np.float64)
        self._pending = n
        self._event = threading.Event()
        self._lock = threading.Lock()
        self.error: Optional[BaseException] = None
        self.trace = trace                    # sampled requests only
        self.req = req                        # score-log join id
        self.deadline = deadline              # absolute batcher-clock time
        self.cancelled = False                # client abandoned the wait

    def _complete(self, sl: slice, scores: Optional[np.ndarray],
                  now: float, error: Optional[BaseException]) -> None:
        if error is None:
            self.scores[sl] = scores
        else:
            self.error = error
        self.done_ts[sl] = now
        with self._lock:
            self._pending -= sl.stop - sl.start
            done = self._pending <= 0
        if done:
            self._event.set()

    def cancel(self) -> None:
        """Mark the ticket abandoned: ``pump()`` sheds its still-queued
        rows through the expired-ticket path instead of scoring work
        whose result nobody will read (counted as ``serve.cancelled``)."""
        self.cancelled = True

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until every row is scored; raises the batch error if
        the request died with its batch.  A timeout CANCELS the ticket —
        the client is gone, so its queued rows shed instead of being
        scored into the void."""
        if not self._event.wait(timeout):
            self.cancel()
            raise TimeoutError("scoring request timed out")
        if self.error is not None:
            raise self.error
        return self.scores

    def done(self) -> bool:
        return self._event.is_set()

    def latencies(self) -> np.ndarray:
        """Per-row completion latency (seconds) — open-loop clients
        stamp ideal arrival times, so these are coordination-free."""
        return self.done_ts - self.stamps


class MicroBatcher:
    """See module docs.  ``scorer_provider`` is read once per flush, so
    a registry hot-swap takes effect at the next batch boundary without
    dropping queued requests."""

    def __init__(self, scorer_provider: Callable[[], AOTScorer],
                 max_delay_s: float = 0.002,
                 clock: Callable[[], float] = time.monotonic,
                 trace_sample_rate: Optional[float] = None,
                 slo=None):
        self._provider = scorer_provider
        self.max_delay_s = float(max_delay_s)
        self.clock = clock
        # head-sampled request tracing (property default) + optional SLO
        # tracker (obs/slo) fed per-row latencies at each completion
        self.trace_sample_rate = trace_sample_rate \
            if trace_sample_rate is not None \
            else configured_trace_sample_rate()
        self.slo = slo
        self._trace_rng = random.Random(0x51F0)
        self._cond = threading.Condition()
        # queue of (ticket, rows, bins, row_offset, raw): row_offset = how
        # many of this burst's rows earlier flushes already consumed; raw
        # marks packed raw-record bursts (serve/transform.py wire format)
        # — a launch never mixes raw and pre-binned rows, the two ride
        # different graphs
        self._queue: deque = deque()
        self._queued_rows = 0
        self._batches = 0
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # overload protection: bounded admission (0 = auto at submit
        # time, AUTO_QUEUE_BUCKETS x the top rung) + default deadline
        # (0 = none) + the drain-rate EWMA behind Retry-After
        self.max_queue_rows = configured_max_queue_rows()
        self.default_deadline_s = configured_deadline_s()
        self._drain_rate = 0.0            # rows/s EWMA across launches
        self._last_launch_t: Optional[float] = None
        # telemetry-independent accounting (the bench reads this; the
        # same numbers mirror into obs counters when telemetry is on)
        self.stats: Dict[str, float] = {
            "requests": 0, "rows": 0, "batches": 0, "rows_padded": 0,
            "flush_full": 0, "flush_deadline": 0, "errors": 0,
            "shed_overload": 0, "shed_expired": 0, "cancelled": 0}
        self.bucket_counts: Dict[int, int] = {}
        # real batch row-counts (rows -> batches): the occupancy-driven
        # ladder refinement's evidence (refine_ladder); keys are bounded
        # by the top rung
        self.size_counts: Dict[int, int] = {}
        self.refine_every = configured_refine_every()
        self._refining = False
        # sampled score logging (obs/scorelog), wired by the server when
        # -Dshifu.scorelog.sampleRate > 0; None keeps the launch path to
        # one is-not-None check
        self.scorelog = None

    # ------------------------------------------------------------ submit
    def submit(self, row: np.ndarray, bins: Optional[np.ndarray] = None,
               stamp: Optional[float] = None,
               trace_id: Optional[str] = None,
               req_id: Optional[str] = None,
               deadline_ms: Optional[float] = None) -> Ticket:
        """One single-record scoring request."""
        return self.submit_burst(
            np.asarray(row, np.float32)[None, :],
            None if bins is None else np.asarray(bins)[None, :],
            stamps=None if stamp is None else np.asarray([stamp]),
            trace_id=trace_id, req_id=req_id, deadline_ms=deadline_ms)

    def submit_burst(self, rows: np.ndarray,
                     bins: Optional[np.ndarray] = None,
                     stamps: Optional[np.ndarray] = None,
                     trace_id: Optional[str] = None,
                     req_id: Optional[str] = None,
                     raw: bool = False,
                     deadline_ms: Optional[float] = None) -> Ticket:
        """A burst of concurrent single-record requests (an open-loop
        load generator's arrivals for one tick) — one queue append, one
        shared ticket.  ``stamps`` lets the generator record IDEAL
        arrival times so latency percentiles are free of coordinated
        omission.  ``trace_id`` (a propagated ``X-Shifu-Trace`` header)
        forces request tracing for this burst; otherwise the burst is
        head-sampled at ``trace_sample_rate`` (minting an id).
        ``req_id`` (the ``X-Shifu-Request`` header) is the score log's
        delayed-outcome join key for this burst.  ``raw=True`` marks
        ``rows`` as PACKED raw-record wire rows (``serve/transform.py``)
        — they flush through the transform+score graphs and never share
        a launch with pre-binned rows.  ``deadline_ms``
        (the ``X-Shifu-Deadline-Ms`` header; default the
        ``requestDeadlineMs`` property, 0 = none) is the request's
        budget measured from its ideal arrival stamp — an expired
        ticket sheds in :meth:`pump` with a coded error.

        Raises :class:`OverloadedError` (coded 429 + Retry-After) when
        the queue is at the admission cap — a burst larger than the cap
        is still admitted into an EMPTY queue, so oversized requests
        stay serviceable."""
        n = len(rows)
        if stamps is None:
            stamps = np.full(n, self.clock())
        st = np.asarray(stamps, np.float64)
        dl_s = (self.default_deadline_s if deadline_ms is None
                else max(0.0, float(deadline_ms)) / 1000.0)
        deadline = float(st.min()) + dl_s if dl_s > 0.0 else None
        trace = None
        if trace_id is not None or (
                self.trace_sample_rate > 0.0 and obs.enabled()
                and self._trace_rng.random() < self.trace_sample_rate):
            trace = _ReqTrace(trace_id or _mint_trace_id())
            obs.counter("serve.trace_sampled").inc()
        t = Ticket(n, st, trace=trace, req=req_id, deadline=deadline)
        shed_no = None
        with self._cond:
            if self._stop:
                raise RuntimeError("batcher is stopped")
            cap = self.max_queue_rows \
                or AUTO_QUEUE_BUCKETS * self._top_bucket()
            if self._queued_rows and self._queued_rows + n > cap:
                self.stats["shed_overload"] += 1
                shed_no = int(self.stats["shed_overload"])
                retry_after = self._retry_after_s()
            else:
                self._queue.append((t, rows, bins, 0, raw))
                self._queued_rows += n
                # one accepted request per submit call; row volume is
                # the separate "rows" / serve.rows_scored accounting
                self.stats["requests"] += 1
                self._cond.notify_all()
        if shed_no is not None:
            obs.counter("serve.shed_overload").inc()
            if self.slo is not None:
                self.slo.record_shed()
            # the die-during-shed drill: an ioerror here surfaces
            # INSTEAD of the coded rejection and must leave the queue
            # depth and SLO shed accounting exactly as recorded above
            faults.fire("serve", "admit", shed_no)
            raise OverloadedError(
                f"queue at admission cap ({cap} rows); retry in "
                f"{retry_after:.3f}s", retry_after_s=retry_after)
        obs.counter("serve.requests").inc()
        return t

    def _retry_after_s(self) -> float:
        """Time for the drain-rate EWMA to absorb the current queue —
        the 429 Retry-After hint.  Caller holds the lock."""
        if self._drain_rate > 0.0:
            est = self._queued_rows / self._drain_rate
        else:
            est = max(self.max_delay_s * 2.0, 0.01)
        return min(max(est, 0.001), 30.0)

    def score_sync(self, rows: np.ndarray,
                   bins: Optional[np.ndarray] = None,
                   timeout: Optional[float] = 30.0) -> np.ndarray:
        """Closed-loop convenience: submit + wait."""
        return self.submit_burst(np.asarray(rows, np.float32),
                                 bins).wait(timeout)

    @property
    def queue_depth(self) -> int:
        """Rows currently queued (sampled into SERVE heartbeats /
        ``/healthz`` so the monitor can flag buildup before the deadline
        blows)."""
        return self._queued_rows

    # ------------------------------------------------------------- drain
    def _top_bucket(self) -> int:
        return self._provider().buckets[-1]

    def _oldest_stamp(self) -> Optional[float]:
        return float(self._queue[0][0].stamps[self._queue[0][3]]) \
            if self._queue else None

    def _take(self, max_rows: int, now: Optional[float] = None
              ) -> Tuple[List[Tuple[Ticket, np.ndarray,
                                    Optional[np.ndarray], int, bool]],
                         List[Tuple[Ticket, int, int]]]:
        """Pop up to ``max_rows`` rows off the queue head (splitting a
        burst when it straddles the boundary).  Stops at a raw/pre-binned
        kind boundary — one launch, one graph family.  Expired or
        client-cancelled tickets met on the way are SHED, not taken —
        returned as ``(ticket, offset, remaining_rows)`` so the caller
        can complete them with a coded error OUTSIDE the lock, before
        any pad/launch work is spent on them.  Caller holds the lock."""
        out, shed, taken = [], [], 0
        kind: Optional[bool] = None
        while self._queue and taken < max_rows:
            t, rows, bins, off, raw = self._queue[0]
            if t.cancelled or (now is not None and t.deadline is not None
                               and t.deadline <= now):
                self._queue.popleft()
                remaining = len(rows) - off
                self._queued_rows -= remaining
                shed.append((t, off, remaining))
                key = "cancelled" if t.cancelled else "shed_expired"
                self.stats[key] += 1
                continue
            if kind is None:
                kind = raw
            elif raw != kind:
                break
            self._queue.popleft()
            room = max_rows - taken
            avail = len(rows) - off
            take = min(room, avail)
            out.append((t, rows[off:off + take],
                        None if bins is None else bins[off:off + take],
                        off, raw))
            taken += take
            if take < avail:
                self._queue.appendleft((t, rows, bins, off + take, raw))
        self._queued_rows -= taken
        return out, shed

    def pump(self, now: Optional[float] = None, force: bool = False) -> int:
        """In-process drain: flush ONE batch if a flush condition holds
        (full top bucket queued, or the oldest request's deadline has
        passed, or ``force``).  Returns rows flushed (0 = no flush due).
        This is the testable core the worker thread loops around."""
        now = self.clock() if now is None else now
        with self._cond:
            if not self._queue:
                return 0
            full = self._queued_rows >= self._top_bucket()
            deadline_hit = now - self._oldest_stamp() >= self.max_delay_s
            if not (full or deadline_hit or force):
                return 0
            parts, shed = self._take(self._top_bucket(), now=now)
            if parts:
                self.stats["flush_full" if full else "flush_deadline"] += 1
            obs.gauge("serve.queue_depth").set(self._queued_rows)
        if shed:
            # coded fast-fail BEFORE pad/launch: the device never sees
            # expired/abandoned work, the client never sees silence
            n_cancelled = sum(1 for t, _, _ in shed if t.cancelled)
            if n_cancelled:
                obs.counter("serve.cancelled").inc(n_cancelled)
            if len(shed) > n_cancelled:
                obs.counter("serve.shed_expired").inc(
                    len(shed) - n_cancelled)
            if self.slo is not None:
                self.slo.record_shed(len(shed))
            err = DeadlineExceededError(
                "request deadline passed before its rows launched")
            for t, off, remaining in shed:
                t._complete(slice(off, off + remaining), None, now, err)
        if not parts:
            return 0
        if full:
            obs.counter("serve.flush_full").inc()
        else:
            obs.counter("serve.flush_deadline").inc()
        return self._launch(parts, reason="full" if full
                            else ("deadline" if deadline_hit else "forced"))

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
    def _launch(self, parts, reason: str = "forced") -> int:
        n = sum(len(rows) for _, rows, _, _, _ in parts)
        if n == 0:
            return 0
        raw_kind = parts[0][4]
        with self._cond:
            batch_index = self._batches
            self._batches += 1
        # sampled members (the common case is NONE: no perf counters, no
        # timing dict, no record emission — the batch path is unchanged)
        traced = [t for t, _, _, _, _ in parts if t.trace is not None]
        t_take = time.perf_counter() if traced else 0.0
        tm: Optional[Dict[str, float]] = \
            {"pad_s": 0.0, "launch_s": 0.0, "device_s": 0.0} if traced \
            else None
        err: Optional[BaseException] = None
        mean = None
        bucket = n
        scorer = None
        # assembly stays INSIDE the try: mismatched row widths across
        # bursts, a missing bins array, or a provider failure must fail
        # this batch's tickets, not escape into the worker loop
        try:
            scorer = self._provider()
            bucket = covering_bucket(scorer.buckets, n)
            t_asm = time.perf_counter() if traced else 0.0
            rows = np.concatenate([r for _, r, _, _, _ in parts], axis=0) \
                if len(parts) > 1 else parts[0][1]
            bins = None
            if not raw_kind and scorer.needs_bins:
                bins = np.concatenate([b for _, _, b, _, _ in parts],
                                      axis=0) \
                    if len(parts) > 1 else parts[0][2]
            if tm is not None:
                tm["pad_s"] += time.perf_counter() - t_asm
            faults.fire("serve", "request", batch_index)
            if raw_kind:
                if not getattr(scorer, "accepts_raw", False):
                    raise ValueError("raw-record request but the live "
                                     "scorer has no fused transform")
                if tm is not None and getattr(scorer, "supports_timings",
                                              False):
                    raw = scorer.score_batch_raw(rows, timings=tm)
                else:
                    raw = scorer.score_batch_raw(rows)
            elif tm is not None and getattr(scorer, "supports_timings",
                                            False):
                raw = scorer.score_batch(rows, bins, timings=tm)
            else:
                raw = scorer.score_batch(rows, bins)
            mean = raw.mean(axis=1).astype(np.float32)
        except BaseException as e:          # noqa: BLE001 — tickets carry it
            err = e
        now = self.clock()
        now_pc = time.perf_counter() if traced else 0.0
        # SLO record BEFORE ticket completion: a caller unblocked by
        # _complete may read /slo immediately, and must see this batch's
        # latencies (guarded so a tracker fault can never hang tickets)
        if self.slo is not None:
            try:
                if err is not None:
                    self.slo.record_errors(n)
                else:
                    self.slo.observe_batch(np.concatenate(
                        [now - t.stamps[so:so + len(r)]
                         for t, r, _, so, _ in parts]))
            except Exception:               # noqa: BLE001
                log.exception("SLO record failed for batch")
        off = 0
        for t, r, _, src_off, _ in parts:
            sl_dst = slice(src_off, src_off + len(r))
            t._complete(sl_dst,
                        None if err is not None
                        else mean[off:off + len(r)], now, err)
            off += len(r)
        pad = bucket - n
        with self._cond:
            # drain-rate EWMA (rows/s across launch completions): the
            # admission path's Retry-After estimate
            if self._last_launch_t is not None:
                dt = now - self._last_launch_t
                if dt > 0:
                    inst = n / dt
                    self._drain_rate = inst if self._drain_rate == 0.0 \
                        else 0.7 * self._drain_rate + 0.3 * inst
            self._last_launch_t = now
            self.stats["batches"] += 1
            self.stats["rows"] += n
            self.stats["rows_padded"] += pad
            self.bucket_counts[bucket] = \
                self.bucket_counts.get(bucket, 0) + 1
            self.size_counts[n] = self.size_counts.get(n, 0) + 1
            batches_now = self.stats["batches"]
            if err is not None:
                self.stats["errors"] += 1
        obs.counter("serve.batches").inc()
        obs.counter("serve.rows_scored").inc(n)
        obs.counter("serve.rows_padded").inc(pad)
        # histogram, not gauge: a gauge only ever showed the LAST batch's
        # occupancy — the report now carries the p50/p99 of the whole
        # distribution (the metrics.prom quantile lines)
        obs.histogram("serve.bucket_occupancy").observe(n / bucket)
        if err is None and self.refine_every \
                and batches_now % self.refine_every == 0:
            self._maybe_refine(scorer)
        if self.scorelog is not None and err is None:
            lo = 0
            for t, r, b, _, _ in parts:
                self.scorelog.log(t.req, mean[lo:lo + len(r)], bins=b)
                lo += len(r)
        if traced:
            self._emit_trace_spans(parts, traced, batch_index, bucket, n,
                                   pad, reason, err, t_take, tm, now_pc)
        if err is not None:
            obs.counter("serve.request_errors").inc()
            if not isinstance(err, (faults.InjectedFault, ValueError,
                                    RuntimeError)):
                raise err
            return n
        oldest = min(float(t.stamps[so]) for t, _, _, so, _ in parts)
        obs.histogram("serve.batch_latency_ms").observe(
            (now - oldest) * 1000.0)
        return n

    def _maybe_refine(self, scorer) -> None:
        """Occupancy-driven ladder refinement (every ``refine_every``
        batches): propose tighter rungs from the observed batch-size
        distribution and grow the scorer's ladder on a BACKGROUND
        thread — each new rung is captured before it is published, so
        the serving loop never waits on a capture and the capture
        contract holds.  Test doubles without
        ``extend_buckets`` are skipped."""
        if scorer is None or self._refining \
                or not hasattr(scorer, "extend_buckets"):
            return
        with self._cond:
            counts = dict(self.size_counts)
        refined = refine_ladder(scorer.buckets, counts)
        if tuple(refined) == tuple(sorted(scorer.buckets)):
            return
        self._refining = True

        def grow() -> None:
            try:
                scorer.extend_buckets(refined)
            except Exception:           # noqa: BLE001 — advisory path
                log.exception("bucket-ladder refinement failed; ladder "
                              "unchanged")
            finally:
                self._refining = False

        threading.Thread(target=grow, daemon=True,
                         name="shifu-torch-serve-ladder").start()

    def _emit_trace_spans(self, parts, traced, batch_index: int,
                          bucket: int, n: int, pad: int, reason: str,
                          err: Optional[BaseException], t_take: float,
                          tm: Dict[str, float], now_pc: float) -> None:
        """Fold this batch's measured decomposition into its sampled
        members and emit the ``serve.batch`` span plus a
        ``serve.request`` span for every member that just COMPLETED
        (split bursts emit once, after their final batch)."""
        for t in traced:
            tr = t.trace
            if not tr.taken:
                tr.taken = True
                tr.queue_wait_s = max(t_take - tr.t0, 0.0)
                if reason == "deadline":
                    tr.deadline_wait_s = min(tr.queue_wait_s,
                                             self.max_delay_s)
            # every member rides the whole batch's pad/launch/device wall
            tr.pad_s += tm["pad_s"]
            tr.launch_s += tm["launch_s"]
            tr.device_s += tm["device_s"]
            tr.batches += 1
            tr.flushes.append(reason)
        batch_wall = now_pc - t_take
        obs.record_span(
            "serve.batch", ts=time.time() - batch_wall, dur_s=batch_wall,
            tid="shifu-serve",
            attrs={"batch": batch_index, "bucket": bucket, "rows": n,
                   "pad": pad, "flush": reason,
                   "links": [t.trace.trace_id for t in traced],
                   "pad_s": round(tm["pad_s"], 6),
                   "launch_s": round(tm["launch_s"], 6),
                   "device_s": round(tm["device_s"], 6),
                   **({"error": type(err).__name__} if err else {})})
        for t in traced:
            if not t.done():
                continue                     # more launches still due
            tr = t.trace
            obs.record_span(
                "serve.request", ts=tr.ts, dur_s=now_pc - tr.t0,
                tid="shifu-serve",
                attrs={"trace": tr.trace_id, "rows": t.n,
                       "batch": batch_index, "batches": tr.batches,
                       "flush": ",".join(tr.flushes),
                       "queue_wait_s": round(tr.queue_wait_s, 6),
                       "deadline_wait_s": round(tr.deadline_wait_s, 6),
                       "pad_s": round(tr.pad_s, 6),
                       "launch_s": round(tr.launch_s, 6),
                       "device_s": round(tr.device_s, 6),
                       "e2e_s": round(now_pc - tr.t0, 6),
                       **({"error": type(err).__name__} if err else {})})

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
                # the failed batch's tickets already carry the error (see
                # serve:request contract); the server must stay serviceable
                log.exception("serve batch failed; batcher continues")
                time.sleep(0.05)            # no hot loop on repeated failure

    def stop(self, drain: bool = True) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        if drain:
            self.drain()
