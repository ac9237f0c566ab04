"""The wire plane and the spill cache: flat per-key raw files beside a
``manifest.json`` — the port's copy of ``shifu_tpu.data.spill`` (same
layout, same manifest, so a plane either package writes reads in the
other).

Layout under ``<CleanedData>/.spill_cache/spill-<keys>/``::

    manifest.json      commit point: keys, dtypes, trailing shapes, rows,
                       per-shard rows, bytes, source signature
    <key>.raw          rows-major flat array

:class:`WireWriter` is norm's direct-to-wire output (``chip_smoke.py``
also writes its generated training plane with it); :func:`open_spill` and
:class:`SpillReader` are how ``train`` reads one, as ``np.memmap`` views
that go to the device without a host copy.  :class:`SpillWriter` is the
streamed trainers' write-through cache over npz shards: the first full
pass of a ``ShardStream`` lands the selected columns in the same layout
(integer columns narrowed to the smallest unsigned type that holds them),
and every later sweep of the out-of-core tail reads them by mmap instead
of decoding zip members.

Knobs (``config.environment`` properties): ``shifu.stream.spill`` on/off
(default on), ``shifu.stream.spillBudgetBytes`` (default 8 GiB; a stream
over it keeps reading npz, and the manifest records the abort so later
passes do not retry), ``shifu.stream.spillDir`` (default: the shard
directory).  A spill pins its shards' ``(name, size, mtime_ns)``; any
change invalidates it.
"""

from __future__ import annotations

import json
import mmap
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ioutil import io_retry

MANIFEST = "manifest.json"
SPILL_FORMAT_VERSION = 1

_tmp_lock = threading.Lock()
_tmp_seq = 0


def _tmp_suffix() -> str:
    """Process-unique temp suffix."""
    global _tmp_seq
    with _tmp_lock:
        _tmp_seq += 1
        return f".tmp-{os.getpid()}-{_tmp_seq}"


def spill_enabled() -> bool:
    from ..config import environment
    return environment.get_bool("shifu.stream.spill", True)


def spill_budget_bytes() -> int:
    from ..config import environment
    return environment.get_int("shifu.stream.spillBudgetBytes", 1 << 33)


def spill_base_dir(shards_dir: str) -> str:
    from ..config import environment
    base = environment.get_property("shifu.stream.spillDir") or shards_dir
    return os.path.join(base, ".spill_cache")


def spill_dir_for(shards_dir: str, keys: Sequence[str]) -> str:
    return os.path.join(spill_base_dir(shards_dir),
                        "spill-" + "-".join(keys))


def _narrow_int_dtype(a: np.ndarray) -> np.dtype:
    """Storage dtype of one column: integers narrow to the smallest
    unsigned type their observed values fit; floats store as they are."""
    if a.dtype.kind in "iu" and a.size:
        lo, hi = int(a.min()), int(a.max())
        if lo >= 0:
            if hi < 1 << 8:
                return np.dtype(np.uint8)
            if hi < 1 << 16:
                return np.dtype(np.uint16)
    return a.dtype


class SpillWriter:
    """Write-through spill built during one cold pass over npz shards.

    ``append`` per shard in order; ``finish`` commits (raw renames, then
    the manifest, the commit point); ``abort`` discards, leaving an
    ``aborted`` marker when given a reason (a budget or dtype overflow
    would only recur)."""

    def __init__(self, directory: str, keys: Sequence[str], source_sig,
                 budget_bytes: int):
        self.directory = directory
        self.keys = tuple(keys)
        self.sig = source_sig
        self.budget = int(budget_bytes)
        self._suffix = _tmp_suffix()
        self._files: Dict[str, object] = {}
        self._dtypes: Dict[str, np.dtype] = {}
        self._shapes: Dict[str, Tuple[int, ...]] = {}
        self._row_bytes = 0
        self._rows = 0
        self._bytes = 0
        self._shard_rows: List[int] = []
        self._dead = False
        os.makedirs(directory, exist_ok=True)

    def _raw_path(self, key: str) -> str:
        return os.path.join(self.directory, key + ".raw")

    def append(self, part: Dict[str, np.ndarray]) -> bool:
        """Append one shard's selected columns.  False once the spill is
        abandoned (budget, dtype overflow, IO error): the caller keeps
        streaming npz, unaffected."""
        if self._dead:
            return False
        try:
            from .. import faults
            faults.fire("spill", "append", len(self._shard_rows))
            n = int(len(next(iter(part.values()))))
            if not self._files:
                for k in self.keys:
                    a = np.asarray(part[k])
                    self._dtypes[k] = _narrow_int_dtype(a)
                    self._shapes[k] = tuple(a.shape[1:])
                self._row_bytes = sum(
                    int(np.prod(self._shapes[k], dtype=np.int64))
                    * self._dtypes[k].itemsize for k in self.keys)
                for k in self.keys:
                    self._files[k] = open(self._raw_path(k) + self._suffix,
                                          "wb")
            if self._bytes + n * self._row_bytes > self.budget:
                self.abort(mark=f"budget {self.budget} bytes exceeded at "
                                f"row {self._rows}")
                return False
            for k in self.keys:
                a = np.ascontiguousarray(np.asarray(part[k]))
                dt = self._dtypes[k]
                if a.dtype != dt:
                    if a.size and dt.kind == "u" and (
                            int(a.min()) < 0
                            or int(a.max()) >= 1 << (8 * dt.itemsize)):
                        # a later shard outgrew the first shard's narrow
                        # dtype: a half-written file cannot widen
                        self.abort(mark=f"column {k!r} outgrew "
                                        f"{dt.name} mid-stream")
                        return False
                    a = a.astype(dt)
                a.tofile(self._files[k])
            self._rows += n
            self._bytes += n * self._row_bytes
            self._shard_rows.append(n)
            return True
        except OSError:
            self.abort()
            return False

    def finish(self) -> bool:
        """Commit the completed spill (the pass reached the dataset end)."""
        if self._dead:
            return False
        try:
            for f in self._files.values():
                f.close()
            for k in self._files:
                os.replace(self._raw_path(k) + self._suffix,
                           self._raw_path(k))
            self._write_manifest({
                "version": SPILL_FORMAT_VERSION, "keys": list(self.keys),
                "dtypes": {k: self._dtypes[k].str for k in self._files},
                "shapes": {k: list(self._shapes[k]) for k in self._files},
                "rows": self._rows, "shard_rows": self._shard_rows,
                "bytes": self._bytes, "source": self.sig})
            self._dead = True
            return True
        except OSError:
            self.abort()
            return False

    def abort(self, mark: Optional[str] = None) -> None:
        """Drop the half-written spill; ``mark`` records a permanent reason
        so later passes do not try again (an unmarked abort, a consumer
        that left mid-pass, leaves nothing and the next pass retries)."""
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
                self._write_manifest({"version": SPILL_FORMAT_VERSION,
                                      "keys": list(self.keys),
                                      "aborted": mark, "source": self.sig})
            except OSError:
                pass

    def _write_manifest(self, man: dict) -> None:
        from .. import faults
        tmp = os.path.join(self.directory, MANIFEST + self._suffix)

        def write():
            faults.fire("spill", "manifest", 0, path=tmp)
            with open(tmp, "w") as f:
                json.dump(man, f)
            os.replace(tmp, os.path.join(self.directory, MANIFEST))
        io_retry(write, "spill manifest commit", self.directory)


def wire_dir(shards_dir: str, keys: Sequence[str]) -> str:
    """The direct-to-wire norm output directory; it lives with its
    schema."""
    return os.path.join(shards_dir, ".spill_cache",
                        "spill-" + "-".join(keys))


class WireWriter:
    """Per-shard durable wire writer: the manifest is re-committed after
    every shard append, so the committed prefix always matches the shards
    appended (and norm's journal); a torn append leaves raw-file tail
    bytes past the manifest's row count, which readers ignore and
    :meth:`resume` truncates.  Dtypes and trailing shapes are fixed up
    front.  Write failures raise."""

    def __init__(self, directory: str, keys: Sequence[str],
                 dtypes: Dict[str, np.dtype], trailing: Dict[str, tuple],
                 source_sig):
        self.directory = directory
        self.keys = tuple(keys)
        self._dtypes = {k: np.dtype(dtypes[k]) for k in self.keys}
        self._shapes = {k: tuple(trailing.get(k, ())) for k in self.keys}
        self.sig = source_sig
        self._suffix = _tmp_suffix()
        self._files: Dict[str, object] = {}
        self._shard_rows: List[int] = []
        self._rows = 0
        os.makedirs(directory, exist_ok=True)

    def _raw_path(self, key: str) -> str:
        return os.path.join(self.directory, key + ".raw")

    def _row_bytes(self, key: str) -> int:
        return int(np.prod(self._shapes[key] or (1,), dtype=np.int64)) \
            * self._dtypes[key].itemsize

    @property
    def n_shards(self) -> int:
        return len(self._shard_rows)

    @classmethod
    def resume(cls, directory: str, keys: Sequence[str],
               dtypes: Dict[str, np.dtype], trailing: Dict[str, tuple],
               source_sig, n_shards: int) -> Optional["WireWriter"]:
        """Adopt the committed prefix of an interrupted plane: the manifest
        must cover >= ``n_shards`` shards of this exact source and layout;
        the raw files are truncated to exactly those rows (dropping the
        tail bytes a mid-append crash left) and the returned writer is
        positioned after them.  None = unusable, rebuild from scratch."""
        try:
            with open(os.path.join(directory, MANIFEST)) as f:
                man = json.load(f)
        except (OSError, ValueError):
            return None
        if (man.get("version") != SPILL_FORMAT_VERSION or man.get("aborted")
                or list(man.get("keys") or []) != list(keys)
                or man.get("source") != source_sig
                or len(man.get("shard_rows") or []) < n_shards):
            return None
        w = cls(directory, keys, dtypes, trailing, source_sig)
        try:
            for k in keys:
                if np.dtype(man["dtypes"][k]) != w._dtypes[k] or \
                        tuple(man["shapes"][k]) != w._shapes[k]:
                    return None
        except KeyError:
            return None
        w._shard_rows = [int(x) for x in man["shard_rows"][:n_shards]]
        w._rows = sum(w._shard_rows)
        try:
            for k in keys:
                need = w._rows * w._row_bytes(k)
                path = w._raw_path(k)
                if os.path.getsize(path) < need:
                    w.close()
                    return None
                with open(path, "r+b") as f:
                    f.truncate(need)
                w._files[k] = open(path, "ab")
            w._commit_manifest()       # re-pin to the adopted prefix
        except OSError:
            w.close()
            return None
        return w

    def append(self, part: Dict[str, np.ndarray]) -> None:
        """Append one shard's columns and durably commit the manifest."""
        if not self._files:
            for k in self.keys:
                self._files[k] = open(self._raw_path(k), "wb")
        n = int(len(next(iter(part.values()))))
        for k in self.keys:
            a = np.asarray(part[k])
            if a.shape[1:] != self._shapes[k]:
                raise ValueError(f"wire column {k!r}: shard shape "
                                 f"{a.shape[1:]} != {self._shapes[k]}")
            if a.dtype != self._dtypes[k]:
                a = a.astype(self._dtypes[k])
            np.ascontiguousarray(a).tofile(self._files[k])
        self._rows += n
        self._shard_rows.append(n)
        self._commit_manifest()

    def truncate_to(self, n_shards: int) -> None:
        """Drop every shard past ``n_shards`` (a resumed shard's replay
        diverged from the journal: it and everything after re-run)."""
        self._shard_rows = self._shard_rows[:n_shards]
        self._rows = sum(self._shard_rows)
        for k in self.keys:
            f = self._files.get(k)
            if f is not None:
                f.close()
            with open(self._raw_path(k), "r+b") as g:
                g.truncate(self._rows * self._row_bytes(k))
            self._files[k] = open(self._raw_path(k), "ab")
        self._commit_manifest()

    def finish(self) -> None:
        """Close out; a zero-shard plane still lands an empty manifest."""
        if not self._shard_rows:
            self._commit_manifest()
        self.close()

    def close(self) -> None:
        for f in self._files.values():
            try:
                f.close()
            except OSError:
                pass
        self._files = {}

    def _commit_manifest(self) -> None:
        man = {"version": SPILL_FORMAT_VERSION,
               "keys": list(self.keys),
               "dtypes": {k: self._dtypes[k].str for k in self.keys},
               "shapes": {k: list(self._shapes[k]) for k in self.keys},
               "rows": self._rows,
               "shard_rows": list(self._shard_rows),
               "bytes": sum(self._rows * self._row_bytes(k)
                            for k in self.keys),
               "source": self.sig}
        tmp = os.path.join(self.directory, MANIFEST + self._suffix)

        def write():
            for f in self._files.values():
                f.flush()
            with open(tmp, "w") as f:
                json.dump(man, f)
            os.replace(tmp, os.path.join(self.directory, MANIFEST))
        io_retry(write, "wire manifest commit", self.directory)


class SpillReader:
    """mmap view over a committed plane."""

    def __init__(self, directory: str, man: dict):
        self.directory = directory
        self.man = man
        self.keys = tuple(man["keys"])
        self.rows = int(man["rows"])
        self.shard_rows = [int(x) for x in man["shard_rows"]]
        # cum[i] = global row of shard i's first row
        self.cum = np.concatenate(
            [[0], np.cumsum(self.shard_rows)]).astype(np.int64)
        self._mms: Dict[str, np.memmap] = {}

    def memmap(self, key: str) -> np.ndarray:
        mm = self._mms.get(key)
        if mm is None:
            dt = np.dtype(self.man["dtypes"][key])
            shape = (self.rows,) + tuple(self.man["shapes"][key])
            path = os.path.join(self.directory, key + ".raw")
            if self.rows == 0:         # np.memmap refuses an empty file
                mm = np.empty(shape, dt)
            else:
                mm = io_retry(lambda: np.memmap(path, dtype=dt, mode="r",
                                                shape=shape),
                              "spill mmap open", path)
                # the streamed tail walks each raw file front to back, many
                # times a forest: ask the kernel to read ahead
                try:
                    mm._mmap.madvise(mmap.MADV_SEQUENTIAL)
                except (AttributeError, ValueError, OSError):
                    pass
            self._mms[key] = mm
        return mm

    def global_of(self, shard: int, offset: int) -> Optional[int]:
        """Global row of (shard, row offset); None outside the manifest."""
        if not 0 <= shard < len(self.shard_rows):
            return None
        g = int(self.cum[shard]) + int(offset)
        return g if 0 <= g <= self.rows else None

    def src_of(self, g: int) -> Tuple[int, int]:
        """(shard, row offset) of global row ``g``, the inverse of
        :meth:`global_of` (zero-row shards skipped as the npz stream
        skips them)."""
        si = int(np.searchsorted(self.cum, g, side="right") - 1)
        return si, int(g - self.cum[si])


def open_spill(directory: str, keys: Sequence[str],
               source_sig) -> Tuple[Optional[SpillReader], bool]:
    """(reader, writable): ``reader`` is a valid committed plane or None;
    ``writable`` is False when a marker records a permanent abort for this
    exact source."""
    path = os.path.join(directory, MANIFEST)

    def read():
        if not os.path.isfile(path):
            return None
        with open(path) as f:
            return json.load(f)
    try:
        man = io_retry(read, "spill manifest read", path)
        if man is None:
            return None, True
    except (OSError, ValueError):
        return None, True
    if man.get("version") != SPILL_FORMAT_VERSION \
            or list(man.get("keys") or []) != list(keys) \
            or man.get("source") != source_sig:
        return None, True
    if man.get("aborted"):
        return None, False
    try:
        rows = int(man["rows"])
        for k in keys:
            dt = np.dtype(man["dtypes"][k])
            need = rows * int(np.prod(man["shapes"][k] or [1],
                                      dtype=np.int64)) * dt.itemsize
            if rows and os.path.getsize(
                    os.path.join(directory, k + ".raw")) < need:
                return None, True
        return SpillReader(directory, man), False
    except (OSError, KeyError, ValueError, TypeError):
        return None, True
