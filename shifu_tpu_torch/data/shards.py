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
import os
import zipfile
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..ioutil import io_retry

ROWS_SIDECAR = ".shard_rows.json"


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


@dataclass
class Shards:
    directory: str
    schema: dict
    files: List[str]
    _shard_rows: Optional[List[int]] = field(default=None, repr=False,
                                             compare=False)
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
        return self._wire_rd

    def iter_shards(self, start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Shards in order, as dicts of arrays (memmap slices for a wire
        plane).  Undecodable shards raise (the reference's bad-shard
        quarantine is not ported)."""
        if self.is_wire:
            rd = self.wire_reader()
            keys = list(self.schema.get("wireKeys") or [])
            for i in range(start, len(rd.shard_rows)):
                s, e = int(rd.cum[i]), int(rd.cum[i + 1])
                yield {k: rd.memmap(k)[s:e] for k in keys}
            return
        for f in self.files[start:]:
            yield io_retry(lambda f=f: dict(np.load(f)), "shard decode", f)

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
