"""Shard IO for the materialized norm/clean planes — the port's copy of
the read side of ``shifu_tpu.data.shards``: npz shards, or (schema
``"wire": true``) the flat wire plane that norm writes directly
(``data/spill.py``).

A wire plane's :meth:`Shards.load_all` returns the ``np.memmap`` arrays
themselves, in the wire dtype, so the trainer's device put reads the bins
straight out of the page cache with no host-side widen or copy.
"""

from __future__ import annotations

import json
import logging
import os
import zipfile
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..ioutil import io_retry

log = logging.getLogger(__name__)

ROWS_SIDECAR = ".shard_rows.json"


def source_signature(files: Sequence[str]) -> List[List]:
    """``[name, size, mtime_ns]`` of each file (a path that cannot be
    stat'ed, such as a remote URL, pins by name): the staleness key of the
    spill cache and of the raw cache, the reference's convention."""
    out: List[List] = []
    for f in files:
        try:
            st = os.stat(f)
            out.append([os.path.basename(f), st.st_size, st.st_mtime_ns])
        except OSError:
            out.append([f, None, None])
    return out


def bins_wire_dtype(n_bins: int) -> np.dtype:
    """The compact storage/wire dtype for bin ids 0..n_bins-1, the same
    policy as the reference's norm, spill cache and device put."""
    if n_bins <= 1 << 8:
        return np.dtype(np.uint8)
    if n_bins <= 1 << 16:
        return np.dtype(np.uint16)
    return np.dtype(np.int32)


def _npz_rows(path: str) -> int:
    """Row count of one npz shard from one member's npy header."""
    try:
        from numpy.lib import format as npf
        with zipfile.ZipFile(path) as z:
            names = z.namelist()
            name = "y.npy" if "y.npy" in names else names[0]
            with z.open(name) as f:
                ver = npf.read_magic(f)
                if ver == (1, 0):
                    shape, _, _ = npf.read_array_header_1_0(f)
                else:
                    shape, _, _ = npf.read_array_header_2_0(f)
                return int(shape[0]) if shape else 0
    except Exception:
        return int(len(np.load(path)["y"]))


class _WireView:
    """SpillReader facade over the tail of a wire plane from shard
    ``base``: memmaps and prefix sums rebase, so the stream's window and
    cursor bookkeeping do not see where the view starts (the
    :meth:`Shards.from_row` cursor, which slices npz file lists the same
    way)."""

    def __init__(self, rd, base_shard: int):
        self._rd = rd
        self._g0 = int(rd.cum[base_shard])
        self.rows = rd.rows - self._g0
        self.shard_rows = list(rd.shard_rows[base_shard:])
        self.cum = (np.asarray(rd.cum[base_shard:]) - self._g0).astype(
            np.int64)

    def memmap(self, key: str):
        return self._rd.memmap(key)[self._g0:]

    def global_of(self, shard: int, offset: int) -> Optional[int]:
        if not 0 <= shard < len(self.shard_rows):
            return None
        g = int(self.cum[shard]) + int(offset)
        return g if 0 <= g <= self.rows else None

    def src_of(self, g: int):
        si = int(np.searchsorted(self.cum, g, side="right") - 1)
        return si, int(g - self.cum[si])


@dataclass
class Shards:
    directory: str
    schema: dict
    files: List[str]
    _shard_rows: Optional[List[int]] = field(default=None, repr=False,
                                             compare=False)
    # a wire plane's shards are flat raw files, no npz; _wire_base is the
    # from_row cursor in shard units
    _wire_base: int = field(default=0, repr=False, compare=False)
    _wire_rd: Optional[object] = field(default=None, repr=False,
                                       compare=False)

    @classmethod
    def open(cls, directory: str) -> "Shards":
        with open(os.path.join(directory, "schema.json")) as f:
            schema = json.load(f)
        files = sorted(os.path.join(directory, f)
                       for f in os.listdir(directory) if f.endswith(".npz"))
        return cls(directory, schema, files)

    @property
    def is_wire(self) -> bool:
        return bool(self.schema.get("wire"))

    def wire_reader(self, keys: Optional[Sequence[str]] = None):
        """The SpillReader over the wire plane, or None for npz shards.  A
        schema that claims wire over a missing/torn/stale plane is a coded
        error: re-run norm."""
        if not self.is_wire:
            return None
        wire_keys = list(self.schema.get("wireKeys") or [])
        if keys is not None and not set(keys) <= set(wire_keys):
            raise ValueError(
                f"wire plane in {self.directory} carries {wire_keys}, "
                f"caller asked for {list(keys)}")
        if self._wire_rd is None:
            from .spill import open_spill, wire_dir
            d = wire_dir(self.directory, wire_keys)
            rd, _ = open_spill(d, wire_keys,
                               self.schema.get("wireSignature"))
            if rd is None:
                from ..config.errors import ErrorCode, ShifuError
                raise ShifuError(
                    ErrorCode.ERROR_INPUT_NOT_FOUND,
                    f"{self.directory}: schema says direct-to-wire but "
                    f"the wire spill under {d} is missing, torn or "
                    "stale — re-run `norm`")
            self._wire_rd = rd
        rd = self._wire_rd
        return _WireView(rd, self._wire_base) if self._wire_base else rd

    def iter_shards(self, start: int = 0, strict: bool = False
                    ) -> Iterator[Dict[str, np.ndarray]]:
        """Shards in order, as dicts of arrays (memmap slices for a wire
        plane).  Opens ride the transient-IO retry ladder; with
        ``shifu.data.badThreshold`` > 0 an undecodable shard is
        quarantined (skipped, counted in ``data.quarantined_shards``,
        logged) while the quarantined share stays under the threshold.
        ``strict`` turns quarantine off: the streaming window planes index
        rows by shard position and cannot lose a shard silently."""
        from .. import faults, obs
        from ..config import environment
        if self.is_wire:
            rd = self.wire_reader()
            keys = list(self.schema.get("wireKeys") or [])
            for i in range(start, len(rd.shard_rows)):
                def _slice(i=i):
                    faults.fire("shards", "shard", i, path=self.directory)
                    s, e = int(rd.cum[i]), int(rd.cum[i + 1])
                    return {k: rd.memmap(k)[s:e] for k in keys}
                yield io_retry(_slice, "wire shard read", self.directory)
            return
        bad_threshold = 0.0 if strict else \
            environment.get_float("shifu.data.badThreshold", 0.0)
        quarantined = 0
        for i, f in enumerate(self.files[start:], start=start):
            def _load(f=f, i=i):
                faults.fire("shards", "shard", i, path=f)
                return dict(np.load(f))
            try:
                yield io_retry(_load, "shard decode", f)
            except (OSError, ValueError, zipfile.BadZipFile) as e:
                if bad_threshold <= 0:
                    raise
                quarantined += 1
                obs.counter("data.quarantined_shards").inc()
                log.warning("quarantined undecodable shard %s: %s", f, e)
                if quarantined / max(len(self.files), 1) > bad_threshold:
                    from ..config.errors import ErrorCode, ShifuError
                    raise ShifuError(
                        ErrorCode.ERROR_BAD_DATA_THRESHOLD,
                        f"{quarantined}/{len(self.files)} shards "
                        f"quarantined exceeds shifu.data.badThreshold="
                        f"{bad_threshold}; last: {f} ({e})") from e

    def load_all(self) -> Dict[str, np.ndarray]:
        """Every row of every key: the whole-plane memmaps for a wire plane
        (no copy), concatenated shards otherwise."""
        if self.is_wire:
            rd = self.wire_reader()
            if rd.rows == 0:
                raise FileNotFoundError(f"no rows in {self.directory}")
            return {k: rd.memmap(k)
                    for k in self.schema.get("wireKeys") or []}
        parts = list(self.iter_shards())
        if not parts:
            raise FileNotFoundError(f"no shards in {self.directory}")
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def source_signature(self) -> List[List]:
        """[(name, size, mtime_ns)] of every npz shard, the spill cache's
        staleness check; a wire plane pins the schema's wire signature."""
        if self.is_wire:
            return [["wire", self.schema.get("wireSignature")]]
        return source_signature(self.files)

    @property
    def shard_rows(self) -> List[int]:
        """Per-shard row counts: schema ``shardRows``, else the wire
        manifest, else a one-time npy-header scan."""
        if self._shard_rows is not None:
            return self._shard_rows
        sr = self.schema.get("shardRows")
        if isinstance(sr, list) and (len(sr) == len(self.files)
                                     or self.is_wire):
            self._shard_rows = [int(x) for x in sr]
        elif self.is_wire:
            self._shard_rows = list(self.wire_reader().shard_rows)
        else:
            self._shard_rows = [_npz_rows(f) for f in self.files]
        return self._shard_rows

    @property
    def num_rows(self) -> int:
        return sum(self.shard_rows)

    @property
    def n_shards(self) -> int:
        return len(self.shard_rows) if self.is_wire else len(self.files)

    def from_row(self, row: int) -> "Shards":
        """A view of this shard set from the shard holding global row
        ``row``: the refresh loop's data-window cursor, shard-aligned and
        rounded down so no row is skipped.  A cursor at or past the end
        keeps the last shard: with no new data the freshest window is
        still the one to train on."""
        if row <= 0 or self.n_shards == 0:
            return self
        rows = self.shard_rows
        cum, k = 0, len(rows) - 1
        for i, r in enumerate(rows):
            if cum + r > row:
                k = i
                break
            cum += r
        kept = [int(x) for x in rows[k:]]
        schema = dict(self.schema)
        if "shardRows" in schema:
            schema["shardRows"] = list(kept)
        if "numRows" in schema:
            schema["numRows"] = int(sum(kept))
        view = Shards(self.directory, schema, list(self.files[k:]))
        view._shard_rows = kept
        view._wire_base = self._wire_base + k
        view._wire_rd = self._wire_rd
        return view
