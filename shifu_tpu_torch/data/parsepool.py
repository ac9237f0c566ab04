"""Parse pool — the offline pipeline's shared parse stage; the port's copy
of ``shifu_tpu.data.parsepool``.

:func:`iter_extracted` yields ``(chunk_idx, ExtractedChunk)`` in strict
chunk order, either inline (``-Dshifu.ingest.parseWorkers=0``) or with one
producer thread streaming raw chunks and a pool of parse threads
(default ``min(cores, 8)``), emission FIFO behind a bounded queue — callers
see the serial sequence either way.  Pre-parse Bernoulli sampling uses one
deterministic per-chunk substream (``rng([977, chunk_idx])``) over the
chunk's RAW row count.

With a ``cache_root`` (``PathFinder.raw_cache_dir``) the columnar raw cache
(:mod:`.rawcache`) takes part: a pass over a committed cache serves every
chunk from memmaps and touches no text; a cold pass parses at full rate,
writes the cache through, and replays the consumer's sample on the full
parse (``subsample_extracted``).  Each such pass logs one line: hit or
miss, and the bytes it wrote.
"""

from __future__ import annotations

import logging
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from .extract import ChunkExtractor, ExtractedChunk
from .rawcache import (RawCacheWriter, open_raw_cache, raw_cache_budget_bytes,
                       raw_cache_enabled)
from .shards import source_signature

log = logging.getLogger(__name__)

RAW_SAMPLE_SEED = 977          # pre-parse sample substream (stats plane)

# default raw chunk geometry (rows per chunk): one module-level value, so
# the cache's chunkRows pin and the reader's chunking agree; tests shrink
# it to force multi-chunk runs
CHUNK_ROWS = 262144


# passes over a cache root since the process started (plain integers; the
# reference's rawcache.* obs counters are ROADMAP item 13)
cache_passes = {"hits": 0, "misses": 0, "bytes_written": 0}


def parse_workers() -> int:
    """``shifu.ingest.parseWorkers``: <0 (default) = auto ``min(cores,
    8)``; 0 = inline serial path; N = that many parse threads."""
    from ..config import environment
    w = environment.get_int("shifu.ingest.parseWorkers", -1)
    if w < 0:
        w = min(os.cpu_count() or 1, 8)
    return w


def sample_raw_mask(raw_rows: int, rate: float, chunk_idx: int) -> np.ndarray:
    """The deterministic pre-parse Bernoulli mask over a chunk's raw rows
    (seeded per chunk over the RAW row count)."""
    return np.random.default_rng(
        [RAW_SAMPLE_SEED, chunk_idx]).random(raw_rows) < rate


def _sample_chunk(chunk, rate: float, chunk_idx: int):
    """Serial order: subset the raw rows BEFORE parsing."""
    if rate >= 1.0 or len(chunk) == 0:
        return chunk
    return chunk.take(sample_raw_mask(len(chunk), rate, chunk_idx))


def subsample_extracted(ex: ExtractedChunk, rate: float,
                        chunk_idx: int) -> ExtractedChunk:
    """Replay the same pre-parse sample AFTER a full parse —
    ``mask[kept_idx]`` selects exactly the rows the sample-then-parse
    order keeps, and row-wise parses commute with the subset."""
    if rate >= 1.0:
        return ex
    smask = sample_raw_mask(ex.raw_rows, rate, chunk_idx)
    sel = smask[ex.kept_idx] if ex.kept_idx is not None else \
        np.zeros(ex.n, dtype=bool)
    return ExtractedChunk(
        n=int(sel.sum()), target=ex.target[sel], weight=ex.weight[sel],
        numeric=ex.numeric[sel], numeric_valid=ex.numeric_valid[sel],
        numeric_cols=ex.numeric_cols,
        categorical={k: v[sel] for k, v in ex.categorical.items()},
        categorical_cols=ex.categorical_cols,
        kept_idx=ex.kept_idx[sel] if ex.kept_idx is not None else None,
        raw_rows=ex.raw_rows)


def cache_dir_for(cache_root: str, source_sig,
                  extractor: ChunkExtractor) -> str:
    """One cache per (source files, row identity): the training source
    and each eval source key their own subdirectory (the reference's
    key, so both packages share a cache)."""
    import hashlib
    import json
    key = hashlib.md5(json.dumps(
        [source_sig, extractor.row_identity()],
        sort_keys=True).encode()).hexdigest()[:16]
    return os.path.join(cache_root, key)


def iter_extracted(source, extractor: ChunkExtractor, *,
                   rate: float = 1.0, keep_raw: bool = False,
                   cache_root: Optional[str] = None,
                   start_chunk: int = 0, chunk_rows: Optional[int] = None
                   ) -> Iterator[Tuple[int, ExtractedChunk]]:
    """Yield ``(chunk_idx, ExtractedChunk)`` in strict chunk order — the
    ``enumerate(source.iter_chunks())`` + ``extract()`` loop, with the
    sample applied before the parse, or served from the raw cache under
    ``cache_root``.  ``start_chunk`` skips extraction of a prefix (its raw
    rows still stream past).  ``keep_raw`` passes (PSI) keep each chunk's
    raw strings (``ExtractedChunk.raw``) and never touch the cache."""
    if chunk_rows is None:
        chunk_rows = CHUNK_ROWS
    rd = None
    cdir = sig = None
    writable = False
    if cache_root and not keep_raw and raw_cache_enabled():
        sig = source_signature(source.files)
        cdir = cache_dir_for(cache_root, sig, extractor)
        rd, writable = open_raw_cache(cdir, sig, extractor, chunk_rows)
    if rd is not None:                 # served: no text touched
        cache_passes["hits"] += 1
        log.info("raw cache hit %s: %d chunks, %d rows", cdir, rd.n_chunks,
                 rd.rows)
        for ci in range(start_chunk, rd.n_chunks):
            yield ci, subsample_extracted(rd.chunk(ci, extractor), rate, ci)
        return
    if cdir is not None:
        cache_passes["misses"] += 1
        log.info("raw cache miss %s: parsing from text", cdir)
    writer = None
    if cdir is not None and writable and start_chunk == 0:
        writer = RawCacheWriter(cdir, extractor, sig, chunk_rows,
                                raw_cache_budget_bytes())
    workers = parse_workers()

    def work(ci, chunk):
        # a cache-writing pass parses at FULL rate (the cache covers every
        # row); the consumer's view replays the sample on the full parse
        if writer is not None:
            return extractor.extract(chunk)
        return extractor.extract(_sample_chunk(chunk, rate, ci),
                                 keep_raw=keep_raw)

    def emit(ci, ex):
        if writer is not None:
            writer.append(ex)          # abandons itself on budget/IO
            return ci, subsample_extracted(ex, rate, ci)
        return ci, ex

    done = False
    try:
        if workers <= 0:
            for ci, chunk in enumerate(source.iter_chunks(chunk_rows)):
                if ci >= start_chunk:
                    yield emit(ci, work(ci, chunk))
        else:
            for ci, ex in _pooled(source, work, start_chunk, chunk_rows,
                                  workers):
                yield emit(ci, ex)
        if writer is not None and writer.finish():
            cache_passes["bytes_written"] += writer.bytes_written
            log.info("raw cache written %s: %d bytes", cdir,
                     writer.bytes_written)
        done = True
    finally:
        if not done and writer is not None:
            writer.abort()


def _pooled(source, work, start_chunk, chunk_rows, workers):
    """Producer thread streams chunks in order; a thread pool parses;
    emission is strictly FIFO behind a bounded future queue."""
    import queue
    import threading
    from concurrent.futures import ThreadPoolExecutor

    pend: "queue.Queue" = queue.Queue(maxsize=max(2 * workers, 2))
    stop = threading.Event()
    exc: list = []

    def produce(pool):
        try:
            for ci, chunk in enumerate(source.iter_chunks(chunk_rows)):
                if ci < start_chunk:
                    continue           # skipped prefix: stream past
                item = (ci, pool.submit(work, ci, chunk))
                while not stop.is_set():
                    try:
                        pend.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    item[1].cancel()
                    return
        except BaseException as e:     # a read error surfaces in order
            exc.append(e)
        finally:
            while not stop.is_set():
                try:
                    pend.put(None, timeout=0.05)
                    break
                except queue.Full:
                    continue

    with ThreadPoolExecutor(max_workers=workers,
                            thread_name_prefix="parse") as pool:
        prod = threading.Thread(target=produce, args=(pool,), daemon=True,
                                name="parse-producer")
        prod.start()
        try:
            while True:
                item = pend.get()
                if item is None:
                    break
                ci, fut = item
                yield ci, fut.result()
        finally:
            stop.set()
            while True:                # unblock a put-blocked producer
                try:
                    item = pend.get_nowait()
                    if item is not None:
                        item[1].cancel()
                except queue.Empty:
                    break
            prod.join(timeout=10)
    if exc:
        raise exc[0]
