"""The out-of-core data plane — the port of ``shifu_tpu.data.streaming``
(the reference's ``MemoryDiskFloatMLDataSet.java:54-99,315-361``: fill
memory to a budget, spill the rest to disk, chain the iterators).

- :func:`should_stream` decides resident against streamed.
- :class:`ShardStream` re-batches the clean plane into fixed-size row
  windows: by mmap slicing of the wire plane (or of the spill an earlier
  pass wrote), else by decoding npz shards on a reader thread, writing the
  spill through on the first full pass.
- :meth:`ShardStream.prepared` runs the trainer's ``prepare`` hook (masks,
  the copy to the device) on a thread, ``depth`` windows ahead.
- :class:`ResidentCache` keeps the prepared windows that fit a device
  budget and re-streams only the tail past it on every later sweep.

Sampling masks cannot be materialised ``[bags, n_rows]`` for an unbounded
plane, so :func:`window_member_masks` derives every row's bag and
validation assignment from (seed, member, global row index) through a
splitmix64 hash: any window masks on its own, the same way every sweep.
``bytes_read``, ``disk_passes`` and ``tail_sweeps`` are plain integers,
and with telemetry on the same traversals count in the reference's
``ingest.*`` and ``train.tail_sweeps`` counters.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from .. import obs

from .shards import Shards


def stream_prefetch_depth(override=None) -> int:
    """Prefetch depth of shard streams: an explicit override, else env
    ``SHIFU_TPU_PREFETCH``, else ``-Dshifu.stream.prefetch=N``, else 2.
    It bounds both the shard read-ahead queue and the prepared-window
    queue."""
    if override is not None:
        try:
            return max(0, int(override))
        except (TypeError, ValueError):
            pass
    v = os.environ.get("SHIFU_TPU_PREFETCH")
    if v:
        try:
            return max(0, int(v))
        except ValueError:
            pass
    from ..config import environment
    return max(0, environment.get_int("shifu.stream.prefetch", 2))


def should_stream(shards, schema: Optional[dict] = None) -> bool:
    """Stream out-of-core when the f32 norm plane would not fit
    ``shifu.train.memoryBudgetBytes`` (default 2 GiB); forced either way
    via ``-Dshifu.train.streaming=on|off``."""
    from ..config import environment
    mode = (environment.get_property("shifu.train.streaming", "auto")
            or "auto").lower()
    if mode in ("on", "true", "force"):
        return True
    if mode in ("off", "false"):
        return False
    schema = schema if schema is not None else getattr(shards, "schema", {})
    budget = environment.get_int("shifu.train.memoryBudgetBytes", 1 << 31)
    width = len(schema.get("outputNames") or []) or 1
    n_rows = schema.get("numRows") or shards.num_rows
    return n_rows * 4 * (width + 2) > budget


# ------------------------------------------------------------ hash uniforms
_U64 = np.uint64


def _splitmix64(z: np.ndarray) -> np.ndarray:
    z = (z + _U64(0x9E3779B97F4A7C15))
    z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
    return z ^ (z >> _U64(31))


def row_uniform(seed: int, stream: int, idx: np.ndarray) -> np.ndarray:
    """Deterministic uniforms in [0,1) keyed by (seed, stream, row index)."""
    with np.errstate(over="ignore"):
        key = _splitmix64(_U64(seed & 0xFFFFFFFF) * _U64(0x100000001B3)
                          + _U64(stream & 0xFFFFFFFF))
        z = _splitmix64(np.asarray(idx, _U64) ^ key)
    return (z >> _U64(11)).astype(np.float64) * (1.0 / (1 << 53))


def _hash_poisson(lam: float, u: np.ndarray, kmax: int = 16) -> np.ndarray:
    """Poisson(lam) counts via inverse CDF on hash uniforms (lam <= ~4)."""
    out = np.zeros(u.shape, np.float32)
    p = np.exp(-lam)
    cdf = np.full(u.shape, p)
    term = p
    for k in range(1, kmax + 1):
        out += (u >= cdf).astype(np.float32)
        term = term * lam / k
        cdf = cdf + term
    return out


def window_member_masks(idx: np.ndarray, bags: int, *, valid_rate: float,
                        kfold: int = -1, sample_rate: float = 1.0,
                        replacement: bool = False,
                        up_sample_weight: float = 1.0,
                        targets: Optional[np.ndarray] = None,
                        seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(train_w, valid_w): [bags, len(idx)] row weights for a row window —
    ``train.sampling.member_masks``'s semantics (k-fold partition, or a
    shared validation split with Poisson or Bernoulli bags; up-sampling)
    as pure functions of the global row index.  Stratified validation
    degrades to plain Bernoulli(valid_rate): exact per-class counts need a
    global pass."""
    idx = np.asarray(idx)
    m = len(idx)
    if kfold and kfold > 1:
        fold = (row_uniform(seed, 101, idx) * kfold).astype(np.int64) % kfold
        valid_w = np.stack([(fold == i).astype(np.float32)
                            for i in range(kfold)])
        train_w = 1.0 - valid_w
    else:
        vmask = row_uniform(seed, 11, idx) < valid_rate
        if bags == 1 and sample_rate >= 1.0 and not replacement:
            bag_w = np.ones((1, m), np.float32)
        else:
            bag_w = np.empty((bags, m), np.float32)
            for b in range(bags):
                u = row_uniform(seed, 1000 + b, idx)
                bag_w[b] = _hash_poisson(sample_rate, u) if replacement \
                    else (u < sample_rate).astype(np.float32)
        train_w = bag_w * (~vmask)[None, :]
        valid_w = np.broadcast_to(vmask.astype(np.float32),
                                  (bags, m)).copy()
    if up_sample_weight != 1.0 and targets is not None:
        train_w = train_w * np.where(targets > 0.5, up_sample_weight,
                                     1.0)[None, :]
    return train_w.astype(np.float32), valid_w.astype(np.float32)


# ----------------------------------------------------------------- windows
@dataclass
class Window:
    """A fixed-size row window.  Arrays are padded to ``rows``; padded rows
    carry zero ``w`` (every consumer ignores them through the weights)."""
    start: int                       # global index of the first real row
    n_valid: int                     # real rows (<= rows)
    arrays: Dict[str, np.ndarray]    # each [rows, ...]
    src: Optional[Tuple[int, int]] = None   # (shard, row offset) of row 0

    @property
    def rows(self) -> int:
        return len(next(iter(self.arrays.values())))

    @property
    def index(self) -> np.ndarray:
        """Global row indices (the padded tail gets past-the-end ids)."""
        return np.arange(self.start, self.start + self.rows)


def _put_item(q: "queue.Queue", stop: threading.Event, item) -> bool:
    """Put on a bounded queue unless the consumer has gone."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _retire(q: "queue.Queue", stop: threading.Event,
            t: threading.Thread) -> None:
    """Unblock and join a producer thread, also when the consumer left
    mid-iteration, so no daemon thread outlives its generator."""
    stop.set()
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass
    t.join(timeout=5.0)


class ShardStream:
    """Windowed, prefetching iterator over a clean plane.

    - ``window_rows`` fixes every window's row count; the last window is
      zero-padded (to the smallest ``W/2^k`` rung covering it when
      ``remainder_multiple`` > 0).
    - A wire plane, or a committed spill, serves every window as mmap
      slices.  Otherwise the first full pass decodes npz on a reader
      thread (a queue ``prefetch`` deep) and writes the spill through
      (:class:`~shifu_tpu_torch.data.spill.SpillWriter`); later passes
      read the spill.
    - ``keys`` selects the arrays, e.g. ``("bins", "y", "w")``; integer
      columns come back from the spill in their narrow wire dtype.
    """

    def __init__(self, shards: Shards, keys: Sequence[str],
                 window_rows: int, prefetch: Optional[int] = None,
                 spill: Optional[bool] = None,
                 remainder_multiple: int = 0):
        from .spill import spill_enabled
        assert window_rows > 0
        self.shards = shards
        self.keys = tuple(keys)
        self.window_rows = int(window_rows)
        self.remainder_multiple = int(remainder_multiple)
        self.prefetch = stream_prefetch_depth(prefetch)
        self.spill = spill_enabled() if spill is None else bool(spill)
        self._spill_off = False         # sticky: aborted marker / IO error
        self._spill_rd = None           # validated SpillReader
        self.bytes_read = 0             # host bytes across every sweep

    # ------------------------------------------------------ spill plumbing
    def _spill_dir(self) -> str:
        from .spill import spill_dir_for
        return spill_dir_for(self.shards.directory, self.keys)

    def _spill_reader(self):
        if self._spill_rd is not None:
            return self._spill_rd
        # a wire plane IS a spill: mmap-first whatever the spill knob says
        wire = self.shards.wire_reader(self.keys) \
            if hasattr(self.shards, "wire_reader") else None
        if wire is not None:
            self._spill_rd = wire
            return wire
        if not self.spill or self._spill_off:
            return None
        from .spill import open_spill
        try:
            rd, writable = open_spill(self._spill_dir(), self.keys,
                                      self.shards.source_signature())
        except OSError:
            self._spill_off = True
            return None
        if rd is not None:
            self._spill_rd = rd
        elif not writable:
            self._spill_off = True      # permanent abort marker on disk
        return rd

    def _spill_writer(self):
        """A writer for the cold pass, or None (disabled, already built,
        permanently aborted)."""
        if not self.spill or self._spill_off or self._spill_rd is not None:
            return None
        from .spill import SpillWriter, spill_budget_bytes
        try:
            return SpillWriter(self._spill_dir(), self.keys,
                               self.shards.source_signature(),
                               spill_budget_bytes())
        except OSError:
            self._spill_off = True
            return None

    def _reader(self, q: "queue.Queue", stop: threading.Event,
                start_shard: int, shard_offset: int, writer=None) -> None:
        """Background npz reader of the cold path; the spill writes through
        here, off the consumer's path."""
        try:
            for si, part in enumerate(
                    self.shards.iter_shards(start_shard, strict=True)):
                item = {k: part[k] for k in self.keys}
                if writer is not None and not writer.append(item):
                    writer = None             # abandoned; keep streaming
                if si == 0 and shard_offset:
                    item = {k: v[shard_offset:] for k, v in item.items()}
                if not _put_item(q, stop, (start_shard + si,
                                           shard_offset if si == 0 else 0,
                                           item)):
                    if writer is not None:
                        writer.abort()        # consumer left mid-pass
                    return
            if writer is not None:
                writer.finish()
            _put_item(q, stop, None)
        except BaseException as e:  # surface IO errors on the consumer side
            if writer is not None:
                writer.abort()
            _put_item(q, stop, e)

    def windows(self, start_shard: int = 0, shard_offset: int = 0,
                start_row: int = 0) -> Iterator[Window]:
        """Window the shard sequence.  The offsets resume mid-plane (the
        ResidentCache tail: skip the cached shards, slice into the first
        partial one, keep global row ids aligned).  A committed spill or
        wire plane serves the whole call by mmap slicing."""
        rd = self._spill_reader()
        if rd is not None:
            g0 = rd.global_of(start_shard, shard_offset)
            if g0 is not None:
                obs.counter("ingest.spill_hits").inc()
                yield from self._windows_mmap(rd, g0, start_row)
                return
        obs.counter("ingest.spill_misses").inc()
        yield from self._windows_npz(start_shard, shard_offset, start_row)

    def _count(self, arrays: Dict[str, np.ndarray], n_valid: int) -> None:
        nbytes = sum(a.nbytes for a in arrays.values())
        self.bytes_read += nbytes
        obs.counter("ingest.bytes_read").inc(nbytes)
        obs.counter("ingest.windows_emitted").inc()
        obs.counter("ingest.rows_emitted").inc(n_valid)

    def _tail_rows(self, buffered: int) -> int:
        """Padded row count of the final partial window: the smallest
        remainder rung covering ``buffered``, else the full window."""
        w = self.window_rows
        m = self.remainder_multiple
        if m <= 0 or buffered >= w:
            return w
        rung, r = w, w // 2
        for _ in range(3):
            if r < max(m, buffered) or r % m:
                break
            rung, r = r, r // 2
        return rung

    def _windows_mmap(self, rd, g0: int, start_row: int) -> Iterator[Window]:
        """Windows as raw-file slices (the same ``src``/``start``
        bookkeeping as the npz path)."""
        W = self.window_rows
        if rd.rows <= g0:
            return
        mms = {k: rd.memmap(k) for k in self.keys}
        start, g = start_row, g0
        while g < rd.rows:
            e = min(g + W, rd.rows)
            arrays = {k: np.asarray(mms[k][g:e]) for k in self.keys}
            nv = e - g
            if nv < W:
                rows = self._tail_rows(nv)
                arrays = {k: _pad_rows(a, rows) for k, a in arrays.items()}
                obs.counter("ingest.rows_padded").inc(rows - nv)
            self._count(arrays, nv)
            yield Window(start=start, n_valid=nv, arrays=arrays,
                         src=rd.src_of(g))
            start += W
            g += W

    def _windows_npz(self, start_shard: int = 0, shard_offset: int = 0,
                     start_row: int = 0) -> Iterator[Window]:
        writer = self._spill_writer() \
            if (start_shard == 0 and shard_offset == 0) else None
        q: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()
        t = threading.Thread(target=self._reader,
                             args=(q, stop, start_shard, shard_offset,
                                   writer), daemon=True)
        t.start()
        try:
            buf: Dict[str, list] = {k: [] for k in self.keys}
            # (shard, offset of the first unconsumed row, rows left) per
            # buffered chunk: gives each window its (shard, offset)
            sources: list = []
            buffered = 0
            start = start_row
            W = self.window_rows

            def consume(rows: int) -> Tuple[int, int]:
                src = (sources[0][0], sources[0][1])
                left = rows
                while left > 0 and sources:
                    si, off, n = sources[0]
                    take = min(left, n)
                    left -= take
                    if take == n:
                        sources.pop(0)
                    else:
                        sources[0] = (si, off + take, n - take)
                return src

            while True:
                item = q.get()
                if isinstance(item, BaseException):
                    raise item
                if item is None:
                    break
                si, off, part = item
                n = len(next(iter(part.values())))
                if n == 0:
                    continue
                for k in self.keys:
                    buf[k].append(part[k])
                sources.append((si, off, n))
                buffered += n
                while buffered >= W:
                    arrays, buf, buffered = _take(buf, W, self.keys)
                    self._count(arrays, W)
                    yield Window(start=start, n_valid=W, arrays=arrays,
                                 src=consume(W))
                    start += W
            if buffered:
                arrays, buf, _ = _take(buf, buffered, self.keys)
                rows = self._tail_rows(buffered)
                arrays = {k: _pad_rows(a, rows) for k, a in arrays.items()}
                obs.counter("ingest.rows_padded").inc(rows - buffered)
                self._count(arrays, buffered)
                yield Window(start=start, n_valid=buffered,
                             arrays=arrays, src=consume(buffered))
        finally:
            _retire(q, stop, t)

    def prepared(self, prepare: Callable[["Window"], "PreparedWindow"],
                 start_shard: int = 0, shard_offset: int = 0,
                 start_row: int = 0,
                 depth: Optional[int] = None) -> Iterator["PreparedWindow"]:
        """Window assembly and the trainer's ``prepare`` hook (masks, the
        copy to the device) on a background thread, ``depth`` windows
        ahead of the consumer, so window N+1's copy overlaps window N's
        kernels.  ``depth=None`` is the stream's prefetch depth; ``depth <=
        0`` prepares inline.  A window's ``on_consume`` runs on the
        consumer's thread as it takes the window.  Each window's assembly
        and prep runs under an ``ingest.window_prep`` span; the time the
        consumer spends waiting for a window (inline: all of its prep)
        lands in the ``ingest.h2d_wait_seconds`` counter, the ingest
        stall the telemetry report shows."""
        import time
        depth = self.prefetch if depth is None else int(depth)

        def _prep(win: "Window") -> "PreparedWindow":
            item = prepare(win)
            if getattr(item, "src", None) is None:
                item.src = win.src    # tail bookkeeping (ResidentCache)
            return item

        def _taken(item: "PreparedWindow") -> "PreparedWindow":
            sync = getattr(item, "on_consume", None)
            if sync is not None:
                item.on_consume = None
                sync()
            return item

        if depth <= 0:
            wait_c = obs.counter("ingest.h2d_wait_seconds")
            it = self.windows(start_shard, shard_offset, start_row)
            while True:
                t0 = time.perf_counter()
                with obs.span("ingest.window_prep"):
                    win = next(it, None)
                    if win is None:
                        return
                    item = _prep(win)
                wait_c.inc(time.perf_counter() - t0)
                yield _taken(item)

        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def worker() -> None:
            try:
                for win in self.windows(start_shard, shard_offset,
                                        start_row):
                    # off the consumer's thread: the timeline puts these
                    # spans on a track of their own, opposite the
                    # consumer's kernels
                    with obs.span("ingest.window_prep", window=win.start,
                                  rows=win.n_valid):
                        item = _prep(win)
                    if not _put_item(q, stop, item):
                        return
                _put_item(q, stop, None)
            except BaseException as e:
                _put_item(q, stop, e)

        t = threading.Thread(target=worker, daemon=True,
                             name="shifu-ingest")
        t.start()
        wait_s = 0.0
        try:
            while True:
                t0 = time.perf_counter()
                with obs.span("ingest.h2d_wait"):
                    item = q.get()
                wait_s += time.perf_counter() - t0
                if isinstance(item, BaseException):
                    raise item
                if item is None:
                    break
                yield _taken(item)
        finally:
            obs.counter("ingest.h2d_wait_seconds").inc(wait_s)
            _retire(q, stop, t)

    @property
    def num_rows(self) -> int:
        return self.shards.num_rows


def _take(buf: Dict[str, list], rows: int, keys: Sequence[str]):
    """Split ``rows`` rows off the buffer front (no copy when aligned)."""
    arrays = {}
    rest: Dict[str, list] = {}
    for k in keys:
        cat = buf[k][0] if len(buf[k]) == 1 else np.concatenate(buf[k])
        arrays[k] = cat[:rows]
        rest[k] = [cat[rows:]] if len(cat) > rows else []
    remaining = sum(len(a) for a in rest[keys[0]])
    return arrays, rest, remaining


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    if len(a) >= rows:
        return a
    pad = np.zeros((rows - len(a),) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad])


@dataclass
class PreparedWindow:
    """A window after the trainer's ``prepare`` hook: arrays on the device
    (tensors) or the host.  ``src`` is filled in from the source window by
    :meth:`ShardStream.prepared` (tail bookkeeping).  On a mesh the
    arrays and ``index`` are a rank's block of the window's rows (``start``,
    ``n_valid`` and ``rows`` stay the window's), and ``cache_bytes`` is
    what the whole window would hold, so every rank makes the one-rank
    residency decisions.  ``sums`` carries host-side sums the trainer took
    of the whole window (the streamed GBT's prior)."""
    start: int
    n_valid: int
    rows: int
    index: np.ndarray
    arrays: Dict[str, object]
    resident: bool = False
    src: Optional[Tuple[int, int]] = None
    # run once on the consumer's thread when it takes the window (the
    # device copy's stream sync)
    on_consume: Optional[Callable[[], None]] = None
    cache_bytes: Optional[int] = None
    sums: Optional[np.ndarray] = None

    @property
    def nbytes(self) -> int:
        return int(sum(getattr(a, "nbytes", 0)
                       for a in self.arrays.values()))

    @property
    def budget_bytes(self) -> int:
        """The bytes the residency budget counts for this window."""
        return self.nbytes if self.cache_bytes is None else self.cache_bytes


class ResidentCache:
    """Two-tier window residency — the reference's
    ``MemoryDiskFloatMLDataSet.java:54-99`` memory fraction: prepared
    (device) windows fill a byte budget; only the tail past it re-streams
    from disk on every later sweep, from its recorded (shard, offset), so
    cached shard files are never read again.  Resident windows keep their
    device tensors, and any per-row state the trainer attaches (GBT
    scores, RF out-of-bag votes), across sweeps.

    ``disk_passes`` counts stream traversals (the warm pass and every tail
    re-stream), ``tail_sweeps`` the tail re-streams alone."""

    def __init__(self, stream: "ShardStream", budget_bytes: int,
                 prepare: Callable[[Window], PreparedWindow],
                 pipeline_depth: Optional[int] = None):
        self.stream = stream
        self.budget = int(budget_bytes)
        self.prepare = prepare
        self.pipeline_depth = pipeline_depth
        self.cached: list = []
        self.tail: Optional[Tuple[int, int, int]] = None  # shard, offset, row
        self.disk_passes = 0
        self.tail_sweeps = 0
        self._warm = False

    def _prepared(self, start_shard: int = 0, shard_offset: int = 0,
                  start_row: int = 0) -> Iterator[PreparedWindow]:
        return self.stream.prepared(self.prepare, start_shard, shard_offset,
                                    start_row, depth=self.pipeline_depth)

    def items(self) -> Iterator[PreparedWindow]:
        if not self._warm:
            used = 0
            caching = True
            self.disk_passes += 1
            obs.counter("ingest.disk_passes").inc()
            for item in self._prepared():
                if caching and used + item.budget_bytes <= self.budget:
                    item.resident = True
                    self.cached.append(item)
                    used += item.budget_bytes
                elif caching:
                    caching = False
                    self.tail = (item.src[0], item.src[1], item.start) \
                        if item.src else (0, 0, 0)
                yield item
            self._warm = True
        else:
            yield from self.cached
            if self.tail is not None:
                yield from self.tail_items()

    def tail_items(self) -> Iterator[PreparedWindow]:
        """Re-stream only the tail (the windows past the resident budget):
        one disk pass, prepared as the warm pass was."""
        if not self._warm:
            raise RuntimeError("tail_items() before the warm pass — "
                               "iterate items() once first")
        if self.tail is None:
            return
        self.disk_passes += 1
        self.tail_sweeps += 1
        obs.counter("ingest.disk_passes").inc()
        obs.counter("train.tail_sweeps").inc()
        sh, off, row = self.tail
        yield from self._prepared(start_shard=sh, shard_offset=off,
                                  start_row=row)

    @property
    def resident_rows(self) -> int:
        return sum(it.n_valid for it in self.cached)

    @property
    def warmed(self) -> bool:
        """True once the first sweep has classified every window."""
        return self._warm


def auto_window_rows(row_bytes: int, budget_bytes: int,
                     multiple: int = 8, lo: int = 1024,
                     hi: int = 1 << 22, n_rows: Optional[int] = None) -> int:
    """Window size from a memory budget (the reference's
    ``guagua.data.memoryFraction``): as many rows as fit, clamped and
    rounded to ``multiple``, capped at the plane (``n_rows``) so a small
    plane does not compute over millions of padded rows a sweep."""
    rows = int(budget_bytes // max(row_bytes, 1))
    if n_rows:
        hi = min(hi, n_rows + (-n_rows) % multiple)
        lo = min(lo, hi)
    rows = max(lo, min(rows, hi))
    return max(multiple, rows - rows % multiple)


def stream_window_rows(row_bytes: int, data_size: int, shards) -> int:
    """The streamed trainers' window geometry: ``shifu.train.windowRows``,
    else the budget-derived :func:`auto_window_rows`, rounded up to
    ``data_size`` (the mesh's data axis: every rank takes an equal block
    of each window's rows)."""
    from ..config import environment
    budget = environment.get_int("shifu.train.memoryBudgetBytes", 1 << 31)
    n_rows = (shards.schema.get("numRows") if hasattr(shards, "schema")
              else None) or getattr(shards, "num_rows", None)
    wr = environment.get_int("shifu.train.windowRows", 0) or \
        auto_window_rows(row_bytes, budget, multiple=data_size,
                         n_rows=n_rows)
    wr += (-wr) % data_size
    return max(data_size, wr)


MaskFn = Callable[[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]


def mask_fn_from_settings(bags: int, *, valid_rate: float, kfold: int = -1,
                          sample_rate: float = 1.0, replacement: bool = False,
                          up_sample_weight: float = 1.0,
                          seed: int = 0) -> MaskFn:
    """Bind sampling settings into a ``(index, targets) -> (train_w,
    valid_w)`` window mask function for the streamed trainers."""
    def fn(idx: np.ndarray, targets: np.ndarray):
        return window_member_masks(
            idx, bags, valid_rate=valid_rate, kfold=kfold,
            sample_rate=sample_rate, replacement=replacement,
            up_sample_weight=up_sample_weight, targets=targets, seed=seed)
    return fn
