"""The wire plane: flat per-key raw files beside a ``manifest.json`` — the
port's copy of the wire half of ``shifu_tpu.data.spill`` (same layout,
same manifest, so a plane either package writes reads in the other).

Layout under ``<CleanedData>/.spill_cache/spill-<keys>/``::

    manifest.json      commit point: keys, dtypes, trailing shapes, rows,
                       per-shard rows, bytes, source signature
    <key>.raw          rows-major flat array

:class:`WireWriter` is norm's direct-to-wire output (the port's tests and
``chip_smoke.py`` write planes with it); :func:`open_spill` and
:class:`SpillReader` are how ``train`` reads one, as ``np.memmap`` views
that go to the device without a host copy.
"""

from __future__ import annotations

import json
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


def wire_dir(shards_dir: str, keys: Sequence[str]) -> str:
    """The direct-to-wire norm output directory; it lives with its
    schema."""
    return os.path.join(shards_dir, ".spill_cache",
                        "spill-" + "-".join(keys))


class WireWriter:
    """Per-shard durable wire writer: the manifest is re-committed after
    every shard append, so the committed prefix always matches the shards
    appended; a torn append leaves raw-file tail bytes past the manifest's
    row count, which readers ignore.  Dtypes and trailing shapes are fixed
    up front.  Write failures raise.  (The reference's ``resume``, which
    adopts an interrupted plane's prefix, comes with the norm slice.)"""

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
            self._mms[key] = mm
        return mm


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
