"""Streaming sketches for auto-type inference and the fused stats sweep —
the port's copy of ``shifu_tpu.ops.sketches`` without pandas.

- :class:`HyperLogLog` hashes each value as ``pd.util.hash_array(...,
  categorize=False)`` does for strings: SipHash-2-4 of the UTF-8 bytes
  under pandas' default key ``"0123456789123456"``, then pandas' 64-bit
  finaliser.  :func:`hash_strings` reproduces that bit for bit, vectorised
  in numpy ``uint64`` over the values grouped by byte length, so the
  registers (and ``distinctCount``) equal the reference's.  Each distinct
  value is hashed once; :meth:`HyperLogLog.update_distinct` and
  :meth:`FrequentItems.update_distinct` take a column batch's distinct
  values from one ``np.unique`` over its ``S`` view
  (:func:`shifu_tpu_torch.data.cells.distinct`), shared by both sketches.
- :class:`FrequentItems` reproduces the reference's pandas merge order
  (``value_counts`` → ``Series.add`` → Misra-Gries prune), which decides
  which of several tied items survive into :meth:`FrequentItems.top`.
- :class:`RangeSketch` is pure numpy and copied as it stands.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Sequence

import numpy as np

_U64 = np.uint64
_SIP_KEY = b"0123456789123456"          # pandas' default hash_key


def _rotl(x: np.ndarray, b: int) -> np.ndarray:
    return (x << _U64(b)) | (x >> _U64(64 - b))


def _sip_round(v0, v1, v2, v3):
    v0 = v0 + v1
    v1 = _rotl(v1, 13) ^ v0
    v0 = _rotl(v0, 32)
    v2 = v2 + v3
    v3 = _rotl(v3, 16) ^ v2
    v0 = v0 + v3
    v3 = _rotl(v3, 21) ^ v0
    v2 = v2 + v1
    v1 = _rotl(v1, 17) ^ v2
    v2 = _rotl(v2, 32)
    return v0, v1, v2, v3


def _siphash24(data: np.ndarray, length: int) -> np.ndarray:
    """SipHash-2-4 of ``n`` messages of ``length`` bytes each, given as a
    [n, length] uint8 array; returns [n] uint64."""
    n = data.shape[0]
    k0, k1 = np.frombuffer(_SIP_KEY, "<u8").astype(_U64)
    v0 = np.full(n, k0 ^ _U64(0x736F6D6570736575), _U64)
    v1 = np.full(n, k1 ^ _U64(0x646F72616E646F6D), _U64)
    v2 = np.full(n, k0 ^ _U64(0x6C7967656E657261), _U64)
    v3 = np.full(n, k1 ^ _U64(0x7465646279746573), _U64)
    # the message padded to whole 8-byte words, its length in the top byte
    n_words = length // 8 + 1
    buf = np.zeros((n, n_words * 8), np.uint8)
    buf[:, :length] = data
    buf[:, -1] = length & 0xFF
    words = buf.view("<u8").astype(_U64)                      # [n, words]
    for w in range(n_words):
        m = words[:, w]
        v3 = v3 ^ m
        for _ in range(2):
            v0, v1, v2, v3 = _sip_round(v0, v1, v2, v3)
        v0 = v0 ^ m
    v2 = v2 ^ _U64(0xFF)
    for _ in range(4):
        v0, v1, v2, v3 = _sip_round(v0, v1, v2, v3)
    return v0 ^ v1 ^ v2 ^ v3


def _finish(h: np.ndarray) -> np.ndarray:
    """pandas' 64-bit finaliser of the SipHash values, in place."""
    with np.errstate(over="ignore"):
        h ^= h >> _U64(30)
        h *= _U64(0xBF58476D1CE4E5B9)
        h ^= h >> _U64(27)
        h *= _U64(0x94D049BB133111EB)
        h ^= h >> _U64(31)
    return h


def hash_strings(values: Sequence) -> np.ndarray:
    """[n] uint64 — ``pd.util.hash_array(np.asarray(values, dtype=object),
    categorize=False)`` for string values: SipHash-2-4 of each value's
    UTF-8 bytes, then pandas' splitmix-style finaliser.  Each distinct
    value is hashed once."""
    vals = np.empty(len(values), dtype=object)
    vals[:] = [v if isinstance(v, str) else str(v) for v in values]
    uniq, inverse = np.unique(vals, return_inverse=True)
    raw = [u.encode("utf-8") for u in uniq]
    lengths = np.fromiter(map(len, raw), np.int64, len(raw))
    h = np.zeros(len(raw), _U64)
    with np.errstate(over="ignore"):
        for length in np.unique(lengths).tolist():
            sel = np.flatnonzero(lengths == length)
            data = np.frombuffer(b"".join(raw[i] for i in sel), np.uint8) \
                .reshape(len(sel), length)
            h[sel] = _siphash24(data, length)
    return _finish(h)[inverse.reshape(-1)]


def hash_distinct(d) -> np.ndarray:
    """[u] uint64: :func:`hash_strings` of each distinct cell of a
    ``data.cells.Distinct``, from its ``S`` bytes grouped by length."""
    rows = d.keys.view(np.uint8).reshape(len(d.keys), d.keys.dtype.itemsize)
    h = np.zeros(len(d.keys), _U64)
    with np.errstate(over="ignore"):
        for length in np.unique(d.widths).tolist():
            sel = np.flatnonzero(d.widths == length)
            h[sel] = _siphash24(rows[sel, :length], length)
    return _finish(h)


class HyperLogLog:
    """Classic HLL over 64-bit hashes (reference uses HyperLogLogPlus(8);
    p=12 here: 4096 registers, ~1.6% standard error, 4KB)."""

    def __init__(self, p: int = 12):
        self.p = p
        self.m = 1 << p
        self.regs = np.zeros(self.m, np.uint8)

    def update(self, values: Sequence) -> None:
        if len(values) == 0:
            return
        self.update_hashes(hash_strings(values))

    def update_distinct(self, d) -> None:
        """:meth:`update` with the values' ``data.cells.Distinct``: each
        distinct value's hash once, which sets the same registers (a
        register keeps the maximum rank of the hashes that reach it)."""
        if len(d.keys):
            self.update_hashes(hash_distinct(d))

    def update_hashes(self, h: np.ndarray) -> None:
        idx = (h >> np.uint64(64 - self.p)).astype(np.int64)
        rest = h << np.uint64(self.p)        # top 64-p bits shifted up
        # rank = leading zeros of `rest` + 1, capped at 64-p+1; a zero rest
        # means all remaining bits were 0
        nz = rest != 0
        lz = np.full(len(h), 64 - self.p, np.uint8)
        # float64 log2 is exact for the leading-bit position of a uint64
        with np.errstate(divide="ignore"):
            lz[nz] = (63 - np.floor(np.log2(rest[nz].astype(np.float64)))) \
                .astype(np.uint8)
        rank = np.minimum(lz + 1, 64 - self.p + 1).astype(np.uint8)
        np.maximum.at(self.regs, idx, rank)

    def estimate(self) -> int:
        m = float(self.m)
        alpha = 0.7213 / (1 + 1.079 / m)
        inv = np.power(2.0, -self.regs.astype(np.float64))
        e = alpha * m * m / inv.sum()
        zeros = int((self.regs == 0).sum())
        if e <= 2.5 * m and zeros:
            e = m * np.log(m / zeros)          # small-range correction
        return int(round(e))


class RangeSketch:
    """Streaming per-column value-range sketch → PROVISIONAL fine-histogram
    boundaries for the fused one-pass stats sweep: the observed range,
    expanded by ``margin`` on each side when the device chunk cache
    overflows; overflow chunks accumulate on that grid and re-bin onto the
    exact [min, max] grid at finalize (counts conserved exactly, placement
    error bounded by one provisional bucket width)."""

    def __init__(self, n_cols: int, margin: float = 0.25):
        self.margin = margin
        self.mn = np.full(n_cols, np.inf)
        self.mx = np.full(n_cols, -np.inf)

    def update(self, mn: np.ndarray, mx: np.ndarray) -> None:
        np.minimum(self.mn, np.asarray(mn, np.float64), out=self.mn)
        np.maximum(self.mx, np.asarray(mx, np.float64), out=self.mx)

    def provisional_bounds(self):
        """(lo, hi) float64 arrays: the observed range expanded by
        ``margin`` on each side.  Degenerate columns take the same
        fallbacks as ``NumericAccumulator.finalize_range``."""
        lo, hi = self.mn.copy(), self.mx.copy()
        empty = ~np.isfinite(lo) | ~np.isfinite(hi)
        lo[empty], hi[empty] = 0.0, 1.0
        same = hi <= lo
        hi[same] = lo[same] + 1.0
        span = hi - lo
        return lo - self.margin * span, hi + self.margin * span


class FrequentItems:
    """Bounded frequent-item counter with Misra-Gries merging: when more
    than ``cap`` items are live, every count drops by the (cap+1)-th
    largest and non-positive entries evict.

    The order of ``counts`` (which :meth:`top` breaks ties by) follows the
    reference's pandas operations:

    - a batch's counts come in descending count order, ties in order of
      first appearance (``value_counts``, a stable sort);
    - merging with the held counts keeps that order when both hold the
      same items in the same order, and otherwise sorts the union by item
      (``Series.add`` aligns on the sorted union of the two indexes);
    - the prune keeps the merged order."""

    def __init__(self, k: int = 32, cap: int = 4096):
        self.k = k
        self.cap = cap
        self.counts: Dict[str, int] = {}

    def update(self, values: Sequence) -> None:
        if len(values) == 0:
            return
        vals = np.asarray(values, dtype=str).astype(object)
        uniq, first, cnt = np.unique(vals, return_index=True,
                                     return_counts=True)
        self._merge([str(k) for k in uniq], first, cnt)

    def update_distinct(self, d) -> None:
        """:meth:`update` with the values' ``data.cells.Distinct``."""
        if len(d.keys):
            self._merge(d.values, d.first, d.counts)

    def _merge(self, uniq: List[str], first: np.ndarray,
               cnt: np.ndarray) -> None:
        """Adds a batch's distinct values (``uniq``, with their first
        indices and counts) to the held counts."""
        seen = np.argsort(first, kind="stable")          # first appearance
        order = seen[np.argsort(-cnt[seen], kind="stable")]
        cnt = cnt[order]
        if not self.counts:
            # the prune on the batch alone, before any item becomes a
            # Python object: it keeps the order, and its items are the
            # counts above the (cap+1)-th largest
            if len(cnt) > self.cap:
                d = np.sort(cnt)[len(cnt) - self.cap - 1]
                keep = cnt > d
                order, cnt = order[keep], cnt[keep] - d
            self.counts = dict(zip([uniq[i] for i in order.tolist()],
                                   cnt.tolist()))
            return
        keys = [uniq[i] for i in order.tolist()]
        vc = dict(zip(keys, cnt.tolist()))
        if keys != list(self.counts):
            keys = sorted(set(keys) | set(self.counts))
        vc = {k: vc.get(k, 0) + self.counts.get(k, 0) for k in keys}
        if len(vc) > self.cap:
            d = np.sort(np.fromiter(vc.values(), np.int64, len(vc)))[
                len(vc) - self.cap - 1]
            vc = {k: v - d for k, v in vc.items() if v - d > 0}
        self.counts = vc

    def top(self, k: int = None) -> List[str]:
        k = k or self.k
        # heapq.nsmallest is sorted(...)[:k], ties in insertion order
        return [v for v, _ in heapq.nsmallest(k, self.counts.items(),
                                              key=lambda kv: -kv[1])]
