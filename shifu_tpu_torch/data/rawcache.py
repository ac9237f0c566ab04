"""Columnar raw cache — the port's copy of ``shifu_tpu.data.rawcache``
(same layout, same manifest, so a cache either package writes serves the
other): the first full extraction of a source writes the decoded columns
into flat raw files beside a ``manifest.json`` commit point, and every
later pass (stats' second sweep, norm, eval) reads ``np.memmap`` slices
instead of parsing the text again.

Layout under ``<tmp>/RawCache/<key>/``::

    manifest.json      commit point (version, row identity, columns,
                       per-chunk row counts, categorical vocabularies,
                       source signature, bytes; ``aborted`` marker on a
                       permanent budget abort)
    target.raw         float64 [rows]
    weight.raw         float64 [rows]
    kept_idx.raw       int64   [rows]   positional raw-row index of each
                                        kept row within its chunk
    numeric.raw        float64 [rows, C_num]     (NaN = missing)
    numeric_valid.raw  bool    [rows, C_num]
    cat-<j>.raw        int32   [rows]   vocabulary codes, column j

The cached payload is the full (unsampled) extraction plus each chunk's
``raw_rows``: every row-wise op of the extractor commutes with a row
subset, so a consumer's pre-parse sample replays from ``kept_idx`` bit for
bit (``parsepool.subsample_extracted``).  Categorical cells store as codes
in first-appearance order across chunks, and decode to the exact strings
the parse gave.

Staleness pins the source files' ``[name, size, mtime_ns]``
(``data/shards.py::source_signature``) and the extractor's row identity;
a consumer with another ``chunkRows`` rebuilds.  Writers append under a
process-unique tmp suffix and commit the raw renames, then the manifest,
so a reader never sees a torn cache; the next writer sweeps a killed
writer's tmp files.  Overflowing ``shifu.ingest.rawCacheBudgetBytes``
(default 8 GiB) aborts once and leaves a permanent ``aborted`` marker.
``shifu.ingest.rawCache=false`` turns the cache off.  Each pass logs its
hit or miss as it starts, and a committed cache its bytes written; with
telemetry on the parse pool counts them in ``rawcache.hits`` /
``rawcache.misses`` / ``rawcache.bytes_written``.  The
``rawcache:commit`` fault site fires before a cache's commit, as the
reference's does.
"""

from __future__ import annotations

import json
import logging
import mmap
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ioutil import io_retry
from .extract import ChunkExtractor, ExtractedChunk
from .spill import _tmp_suffix

log = logging.getLogger(__name__)

MANIFEST = "manifest.json"
RAWCACHE_FORMAT_VERSION = 1

_FIXED = (("target", np.dtype(np.float64)),
          ("weight", np.dtype(np.float64)),
          ("kept_idx", np.dtype(np.int64)))


def raw_cache_enabled() -> bool:
    from ..config import environment
    return environment.get_bool("shifu.ingest.rawCache", True)


def raw_cache_budget_bytes() -> int:
    from ..config import environment
    return environment.get_int("shifu.ingest.rawCacheBudgetBytes", 1 << 33)


def _sweep_tmp(directory: str) -> None:
    """Remove the tmp files a killed writer left (an absent manifest is an
    absent cache, so they are never read)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return
    for f in names:
        if ".tmp-" in f:
            try:
                os.remove(os.path.join(directory, f))
            except OSError:
                pass


def _codes(values: np.ndarray, vmap: Dict[str, int]) -> np.ndarray:
    """int32 codes of ``values``; a value not yet in ``vmap`` takes the
    next code, in first-appearance order (the reference's ``Series.map``
    plus ``pd.unique`` over the unmapped cells)."""
    if len(values) == 0:
        return np.empty(0, np.int32)
    uniq, first, inv = np.unique(np.asarray(values, dtype=object),
                                 return_index=True, return_inverse=True)
    code = np.empty(len(uniq), np.int32)
    for k in np.argsort(first, kind="stable"):
        c = vmap.get(uniq[k])
        if c is None:
            c = vmap[uniq[k]] = len(vmap)
        code[k] = c
    return code[inv.reshape(-1)]


class RawCacheWriter:
    """Write-through raw cache built during one full-extraction pass.  The
    dtypes are fixed by the extraction (f64 numerics, i64 ``kept_idx``, i32
    codes); only the budget aborts a write."""

    def __init__(self, directory: str, extractor: ChunkExtractor,
                 source_sig, chunk_rows: int, budget_bytes: int):
        self.directory = directory
        self.sig = source_sig
        self.chunk_rows = int(chunk_rows)
        self.budget = int(budget_bytes)
        self.row_identity = extractor.row_identity()
        self.numeric_names = [c.columnName for c in extractor.numeric_cols]
        self.cat_names = [c.columnName for c in extractor.categorical_cols]
        self._suffix = _tmp_suffix()
        self._files: Dict[str, object] = {}
        self._vocab_maps: List[Dict[str, int]] = [{} for _ in self.cat_names]
        self._chunk_kept: List[int] = []
        self._chunk_raw: List[int] = []
        self._rows = 0
        self.bytes_written = 0
        self._dead = False
        os.makedirs(directory, exist_ok=True)
        _sweep_tmp(directory)

    def _keys(self) -> List[str]:
        return ([k for k, _ in _FIXED] + ["numeric", "numeric_valid"]
                + [f"cat-{j}" for j in range(len(self.cat_names))])

    def _raw_path(self, key: str) -> str:
        return os.path.join(self.directory, key + ".raw")

    def append(self, ex: ExtractedChunk) -> bool:
        """Append one chunk's full extraction.  False once the cache is
        abandoned (budget, IO error); the caller keeps parsing."""
        if self._dead:
            return False
        try:
            if not self._files:
                for k in self._keys():
                    self._files[k] = open(self._raw_path(k) + self._suffix,
                                          "wb")
            parts: Dict[str, np.ndarray] = {
                "target": np.ascontiguousarray(ex.target, np.float64),
                "weight": np.ascontiguousarray(ex.weight, np.float64),
                "kept_idx": np.ascontiguousarray(ex.kept_idx, np.int64),
                "numeric": np.ascontiguousarray(ex.numeric, np.float64),
                "numeric_valid": np.ascontiguousarray(ex.numeric_valid,
                                                      np.bool_)}
            for j, name in enumerate(self.cat_names):
                parts[f"cat-{j}"] = _codes(ex.categorical[name],
                                           self._vocab_maps[j])
            nb = sum(a.nbytes for a in parts.values())
            if self.bytes_written + nb > self.budget:
                self.abort(mark=f"budget {self.budget} bytes exceeded at "
                                f"row {self._rows}")
                return False
            for k, a in parts.items():
                a.tofile(self._files[k])
            self._rows += ex.n
            self.bytes_written += nb
            self._chunk_kept.append(int(ex.n))
            self._chunk_raw.append(int(ex.raw_rows))
            return True
        except OSError:
            self.abort()
            return False

    def finish(self) -> bool:
        """Commit: the raw renames, then the manifest (the commit point)."""
        if self._dead:
            return False
        try:
            for f in self._files.values():
                f.close()
            for k in self._files:
                os.replace(self._raw_path(k) + self._suffix,
                           self._raw_path(k))
            self._write_manifest({
                "version": RAWCACHE_FORMAT_VERSION,
                "rowIdentity": self.row_identity,
                "numericCols": self.numeric_names,
                "categoricalCols": self.cat_names,
                "vocabs": [sorted(m, key=m.get) for m in self._vocab_maps],
                "rows": self._rows,
                "chunkKept": self._chunk_kept,
                "chunkRaw": self._chunk_raw,
                "chunkRows": self.chunk_rows,
                "bytes": self.bytes_written,
                "source": self.sig}, "raw cache manifest commit",
                commit=True)
            self._dead = True
            return True
        except OSError:
            self.abort()
            return False

    def _write_manifest(self, man: dict, what: str,
                        commit: bool = False) -> None:
        """Write the manifest atomically; ``commit`` marks the cache's
        commit point (the ``rawcache:commit`` fault site), not an abort
        marker."""
        from .. import faults
        tmp = os.path.join(self.directory, MANIFEST + self._suffix)

        def write():
            if commit:
                faults.fire("rawcache", "commit", 0, path=tmp)
            with open(tmp, "w") as f:
                json.dump(man, f)
            os.replace(tmp, os.path.join(self.directory, MANIFEST))
        io_retry(write, what, self.directory)

    def abort(self, mark: Optional[str] = None) -> None:
        """Drop the half-written cache; ``mark`` records a permanent reason
        (the budget) so later passes do not try again."""
        if self._dead:
            return
        self._dead = True
        for f in self._files.values():
            try:
                f.close()
            except OSError:
                pass
        for k in self._files:
            try:
                os.remove(self._raw_path(k) + self._suffix)
            except OSError:
                pass
        if mark:
            try:
                self._write_manifest({
                    "version": RAWCACHE_FORMAT_VERSION,
                    "rowIdentity": self.row_identity,
                    "aborted": mark,
                    "source": self.sig}, "raw cache abort marker")
            except OSError:
                pass


class RawCacheReader:
    """mmap view over a committed raw cache; serves ``ExtractedChunk``s to
    any extractor whose columns are a subset of the cached set."""

    def __init__(self, directory: str, man: dict):
        self.directory = directory
        self.man = man
        self.rows = int(man["rows"])
        self.chunk_kept = [int(x) for x in man["chunkKept"]]
        self.chunk_raw = [int(x) for x in man["chunkRaw"]]
        self.numeric_names = list(man["numericCols"])
        self.cat_names = list(man["categoricalCols"])
        self.vocab_arrays = [np.asarray(v, dtype=object)
                             for v in man["vocabs"]]
        self.cum = np.concatenate(
            [[0], np.cumsum(self.chunk_kept)]).astype(np.int64)
        self._mms: Dict[str, np.memmap] = {}

    @property
    def n_chunks(self) -> int:
        return len(self.chunk_kept)

    def _memmap(self, key: str, dtype: np.dtype, trailing: int) -> np.memmap:
        mm = self._mms.get(key)
        if mm is None:
            shape = (self.rows, trailing) if trailing else (self.rows,)
            path = os.path.join(self.directory, key + ".raw")
            mm = io_retry(
                lambda: np.memmap(path, dtype=dtype, mode="r", shape=shape),
                "raw cache mmap open", path)
            try:
                mm._mmap.madvise(mmap.MADV_SEQUENTIAL)
            except (AttributeError, ValueError, OSError):
                pass
            self._mms[key] = mm
        return mm

    def serves(self, extractor: ChunkExtractor) -> bool:
        """The row identity matches and the requested columns are a subset
        of the cached set."""
        if self.man.get("rowIdentity") != extractor.row_identity():
            return False
        num, cat = set(self.numeric_names), set(self.cat_names)
        return (all(c.columnName in num for c in extractor.numeric_cols)
                and all(c.columnName in cat
                        for c in extractor.categorical_cols))

    def chunk(self, ci: int, extractor: ChunkExtractor) -> ExtractedChunk:
        """Chunk ``ci``'s full extraction for ``extractor``, equal to a
        fresh parse's arrays."""
        s, e = int(self.cum[ci]), int(self.cum[ci + 1])
        n = e - s
        f64 = np.dtype(np.float64)
        target = np.asarray(self._memmap("target", f64, 0)[s:e])
        weight = np.asarray(self._memmap("weight", f64, 0)[s:e])
        kept_idx = np.asarray(self._memmap("kept_idx",
                                           np.dtype(np.int64), 0)[s:e])
        if extractor.numeric_cols:
            C = len(self.numeric_names)
            cols = [self.numeric_names.index(c.columnName)
                    for c in extractor.numeric_cols]
            num_all = np.asarray(self._memmap("numeric", f64, C)[s:e])
            val_all = np.asarray(self._memmap("numeric_valid",
                                              np.dtype(np.bool_), C)[s:e])
            numeric = np.ascontiguousarray(num_all[:, cols])
            numeric_valid = np.ascontiguousarray(val_all[:, cols])
        else:
            numeric = np.zeros((n, 0))
            numeric_valid = np.zeros((n, 0), dtype=bool)
        categorical: Dict[str, np.ndarray] = {}
        for cc in extractor.categorical_cols:
            j = self.cat_names.index(cc.columnName)
            codes = np.asarray(self._memmap(f"cat-{j}",
                                            np.dtype(np.int32), 0)[s:e])
            vocab = self.vocab_arrays[j]
            categorical[cc.columnName] = vocab[codes] if len(vocab) \
                else np.empty(n, dtype=object)
        return ExtractedChunk(
            n=n, target=target, weight=weight, numeric=numeric,
            numeric_valid=numeric_valid,
            numeric_cols=extractor.numeric_cols, categorical=categorical,
            categorical_cols=extractor.categorical_cols,
            kept_idx=kept_idx, raw_rows=int(self.chunk_raw[ci]))


def open_raw_cache(directory: str, source_sig, extractor: ChunkExtractor,
                   chunk_rows: int) -> Tuple[Optional[RawCacheReader], bool]:
    """``(reader, writable)``: ``reader`` is a committed cache that serves
    ``extractor``, or None; ``writable`` says whether a cold pass should
    (re)build one — False under a permanent abort marker for this source,
    or when a fresh cache exists that does not cover the requested columns
    (rebuilding it would thrash the other steps' cache)."""
    path = os.path.join(directory, MANIFEST)

    def read():
        if not os.path.isfile(path):       # absence is final
            return None
        with open(path) as f:
            return json.load(f)
    try:
        man = io_retry(read, "raw cache manifest read", path)
    except (OSError, ValueError):
        return None, True
    if man is None:
        return None, True
    if man.get("version") != RAWCACHE_FORMAT_VERSION \
            or man.get("source") != source_sig:
        return None, True                  # stale source
    if man.get("aborted"):
        return None, False
    try:
        if int(man.get("chunkRows", 0)) != int(chunk_rows):
            return None, True
        rd = RawCacheReader(directory, man)
        rows, C = rd.rows, len(rd.numeric_names)
        sizes = [("target", 8), ("weight", 8), ("kept_idx", 8),
                 ("numeric", 8 * C), ("numeric_valid", C)]
        sizes += [(f"cat-{j}", 4) for j in range(len(rd.cat_names))]
        for key, row_bytes in sizes:
            if rows and row_bytes and os.path.getsize(
                    os.path.join(directory, key + ".raw")) < rows * row_bytes:
                return None, True          # torn raw file
        if not rd.serves(extractor):
            return None, False
        return rd, False
    except (OSError, KeyError, ValueError, TypeError):
        return None, True
