"""Device-side splitmix64, the streaming row hash on the card — the port of
``shifu_tpu.ops.hashing``'s bagging half.

The streamed trainers key every stateless decision (bags, validation
splits) off ``data.streaming.row_uniform``: a host splitmix64 over the
global row index.  Replaying those draws on the device lets a resident
streamed forest draw its per-tree bags there instead of hashing and
copying [N] floats a tree.  The reference carries 64-bit values as uint32
hi/lo pairs (no uint64 without x64 mode); PyTorch has int64 on every
backend, so here a 64-bit value is one int64 tensor: additions and
multiplies wrap modulo 2^64 as uint64 arithmetic does, and every right
shift is masked to a logical shift (``>>`` on int64 is arithmetic); the
reference's uint32 halves (``row_key_u32``, ``thresholds_u32``,
``split_index_u32``) become :func:`row_key_i64` and
:func:`thresholds_i64`, and a window's global row indices go to the
device as they are.
Poisson counts compare the 53-bit uniform with integer CDF thresholds, so
device bags are bit-identical to the host's ``_hash_poisson``.

The WDL hashed-ID half folds a high-cardinality categorical column into a
fixed bucket space: ``bucket = (hi32(splitmix64(id ^ col_key)) *
buckets) >> 32``, Lemire's multiply-shift over the top 32 hash bits.  With
``buckets < 2^31`` that product stays below 2^63, so the device replay
is one int64 tensor op chain, bit-identical to the host's uint64 map.
"""

from __future__ import annotations

import numpy as np
import torch

_M64 = (1 << 64) - 1


def _i64(v: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    v &= _M64
    return v - (1 << 64) if v >= 1 << 63 else v


def _shr(z, k: int):
    """Logical right shift of an int64 tensor by 0 < k < 64."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _xorshift_r(z, k: int):
    """z ^ (z >> k), the shift logical, for 0 < k < 64."""
    return z ^ _shr(z, k)


def _splitmix64_dev(z):
    """splitmix64 of int64 ``z`` (its + and * wrap modulo 2^64, so the
    reference's limb helpers ``_add64``/``_mul64`` are plain + and *)."""
    z = _xorshift_r(z + _i64(0x9E3779B97F4A7C15), 30)
    z = _xorshift_r(z * _i64(0xBF58476D1CE4E5B9), 27)
    return _xorshift_r(z * _i64(0x94D049BB133111EB), 31)


def _row_key(seed: int, stream: int) -> int:
    """Host scalar half of ``row_uniform``: splitmix64(seed * FNV + stream),
    as a uint64 Python int."""
    z = ((seed & 0xFFFFFFFF) * 0x100000001B3
         + (stream & 0xFFFFFFFF)) & _M64
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z ^= z >> 30
    z = (z * 0xBF58476D1CE4E5B9) & _M64
    z ^= z >> 27
    z = (z * 0x94D049BB133111EB) & _M64
    z ^= z >> 31
    return z


def poisson_thresholds(lam: float, kmax: int = 16) -> np.ndarray:
    """[kmax] uint64 CDF thresholds over the 53-bit uniform lattice:
    ``count = sum_k [u53 >= t_k]`` reproduces ``_hash_poisson`` exactly
    (its float compare ``u >= cdf`` over u = u53 * 2^-53)."""
    p = np.exp(-lam)
    cdf = p
    term = p
    out = np.empty(kmax, np.uint64)
    for k in range(1, kmax + 1):
        out[k - 1] = np.uint64(min(np.ceil(cdf * (1 << 53)), 1 << 53))
        term = term * lam / k
        cdf = cdf + term
    return out


def hash_poisson_traced(idx, key, thresholds):
    """[N] f32 Poisson bag counts of global row indices ``idx`` (int64
    tensor) under the row key ``key`` (an int64 scalar tensor,
    :func:`row_key_i64`) and CDF ``thresholds`` ([kmax] int64 tensor,
    :func:`thresholds_i64`), on the device of ``idx``.  One function serves
    every tree of a streamed forest: only the key changes."""
    z = _splitmix64_dev(idx ^ key)
    u53 = _shr(z, 11)                                  # < 2^53: no sign
    return (u53[:, None] >= thresholds[None, :]).sum(dim=1).float()


def hash_poisson_device(idx, seed: int, stream: int, lam: float,
                        kmax: int = 16):
    """[N] f32 Poisson(lam) counts from global row indices ``idx`` (int64
    tensor): the device replay of ``_hash_poisson(lam, row_uniform(seed,
    stream, idx))``, bit-identical to the host draw."""
    dev = idx.device
    return hash_poisson_traced(
        idx.long(), torch.tensor(row_key_i64(seed, stream), device=dev),
        torch.from_numpy(thresholds_i64(lam, kmax)).to(dev))


def row_key_i64(seed: int, stream: int) -> int:
    """The host row key as the int64 that :func:`hash_poisson_traced`
    takes."""
    return _i64(_row_key(seed, stream))


def thresholds_i64(lam: float, kmax: int = 16) -> np.ndarray:
    """:func:`poisson_thresholds` as int64 (every threshold <= 2^53)."""
    return poisson_thresholds(lam, kmax).astype(np.int64)


# ---------------------------------------------------------- hash buckets
#: seed of the per-column hash keys (distinct from the row-bagging streams
#: so a column never shares a key with a bag draw)
WDL_HASH_SEED = 0x5D1F00D


def column_hash_key(column_num: int, seed: int = WDL_HASH_SEED) -> int:
    """Stable 64-bit per-column key of the hashed-ID bucket map."""
    return _row_key(seed, column_num)


def hash_bucket_host(idx: np.ndarray, key: int, buckets: int) -> np.ndarray:
    """[N] int32 bucket ids of the bin ids ``idx`` (negatives count as 0)
    under the column key ``key``, on the host (uint64 arithmetic)."""
    z = np.maximum(np.asarray(idx, np.int64), 0).astype(np.uint64)
    z ^= np.uint64(key)
    z = (z + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(_M64)
    z ^= z >> np.uint64(30)
    z = (z * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(_M64)
    z ^= z >> np.uint64(27)
    z = (z * np.uint64(0x94D049BB133111EB)) & np.uint64(_M64)
    z ^= z >> np.uint64(31)
    hi32 = z >> np.uint64(32)
    return ((hi32 * np.uint64(buckets)) >> np.uint64(32)).astype(np.int32)


def hash_bucket_device(idx: torch.Tensor, key, buckets: int) -> torch.Tensor:
    """:func:`hash_bucket_host` on ``idx``'s device, bit-identical.
    ``key`` is a uint64 Python int, or an int64 tensor of keys (as
    :func:`_i64` gives them) broadcasting over ``idx``'s last axis."""
    assert 0 < buckets < 1 << 31, "bucket ids need buckets < 2^31"
    k = key if isinstance(key, torch.Tensor) else _i64(key)
    z = _splitmix64_dev(idx.long().clamp_min(0) ^ k)
    return ((_shr(z, 32) * buckets) >> 32).to(torch.int32)
