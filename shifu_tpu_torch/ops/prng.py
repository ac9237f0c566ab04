"""JAX's threefry random stream in PyTorch — the counterpart of the
``jax.random`` calls the RF trainer makes (``PRNGKey``, ``fold_in``,
``split``, ``uniform`` and ``poisson``), bit for bit.

The resident Random Forest draws each tree's Poisson bag from
``fold_in(PRNGKey(seed), tree)``.  A port that drew other bags would grow
other forests from the same seed, and could not resume a checkpoint
``shifu_tpu`` wrote (the out-of-bag replay re-draws each stored tree's
bag).  So this module reproduces the stream of the installed jax
(``jax/_src/prng.py`` ``threefry_2x32``, ``_threefry_split_foldlike``,
``threefry_fold_in``, ``_threefry_random_bits_partitionable`` — the
partitionable path, ``jax_threefry_partitionable`` being on — and
``jax/_src/random.py`` ``_uniform``, ``_poisson_knuth``).

A key is a pair of uint32 words, held here as a Python tuple of ints (keys
are per tree and tiny; the hash of a key runs on the host).  Per-row bits
run on the device as int64 tensors masked to 32 bits, since PyTorch has
little uint32 arithmetic.  With the partitionable path row i's bits depend
only on the key and i, so the draw of the first n rows does not depend on
how many rows follow.

Only the integer part has to be exact (keys, bits, uniforms); the Poisson
loop then adds ``log(u)`` in float32 as jax does.  ``torch.log`` and XLA's
``log`` differ in the last bit for some inputs, which moves a bag only
where a row's running log-product lands within that bit of ``-lam``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: Knuth iterations run between two "all rows finished" checks
POISSON_BLOCK = 16
#: rates at or above this take jax's rejection sampler, not ported
KNUTH_MAX_RATE = 10.0

Key = Tuple[int, int]


def _threefry(k1, k2, x0, x1, rotl, add):
    """Threefry-2x32 with 20 rounds on (x0, x1) under key (k1, k2);
    ``rotl``/``add`` do the 32-bit arithmetic of the array type."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0, x1 = add(x0, ks[0]), add(x1, ks[1])
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = add(x0, x1)
            x1 = rotl(x1, r) ^ x0
        x0 = add(x0, ks[(i + 1) % 3])
        x1 = add(add(x1, ks[(i + 2) % 3]), i + 1)
    return x0, x1


def _host_hash(key: Key, x0: int, x1: int) -> Tuple[int, int]:
    return _threefry(key[0], key[1], x0, x1,
                     lambda v, r: ((v << r) | (v >> (32 - r))) & M32,
                     lambda a, b: (a + b) & M32)


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` with jax's 64-bit seed split:
    ``[seed >> 32, seed & 0xFFFFFFFF]`` (a negative seed as its two's
    complement)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (s >> 32) & M32, s & M32


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``: the hash of
    the counter pair (0, data)."""
    return _host_hash(key, 0, int(data) & M32)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)``: key i is the hash of the counter
    pair (0, i)."""
    return tuple(_host_hash(key, 0, i) for i in range(num))


def random_bits(keys, n: int, device=None) -> torch.Tensor:
    """[len(keys), n] int64 in [0, 2^32): jax's 32-bit random bits of
    shape (n,) under each key — the hash of the counter pair (hi, lo) of
    row i, its two words xor-ed."""
    if n >= 1 << 32:
        raise ValueError("random_bits: at most 2^32 - 1 rows")
    k1, k2 = (torch.tensor([[k[j]] for k in keys], dtype=torch.int64,
                           device=device) for j in (0, 1))
    lo = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    hi = torch.zeros_like(lo)
    b0, b1 = _threefry(k1, k2, hi, lo,
                       lambda v, r: ((v << r) & M32) | (v >> (32 - r)),
                       lambda a, b: (a + b) & M32)
    return b0 ^ b1


def uniform_f32(keys, n: int, device=None) -> torch.Tensor:
    """[len(keys), n]: ``jax.random.uniform(key, (n,), float32)`` in
    [0, 1) under each key — the top 23 bits as a mantissa under exponent
    0, minus 1."""
    bits = (random_bits(keys, n, device) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    return u.clamp_min(0.0)


def _check_rate(lam: float) -> float:
    lam32 = float(np.float32(lam))
    if not np.isfinite(lam32) or lam32 < 0.0:
        raise ValueError(f"poisson: rate {lam} must be finite and >= 0")
    if lam32 >= KNUTH_MAX_RATE:
        raise NotImplementedError(
            f"poisson: rate {lam} >= {KNUTH_MAX_RATE:g} takes jax's rejection "
            "sampler, which is not yet ported to shifu_tpu_torch (ROADMAP "
            "Queue 1 item 6)")
    return lam32


def poisson(keys, lam: float, n: int, device=None) -> torch.Tensor:
    """[len(keys), n] float32: ``jax.random.poisson(key, lam, (n,))``
    under each key, for a rate below 10 (Knuth's loop, jax's branch there;
    larger rates raise).

    Each iteration splits every running key, adds one to the rows still
    above ``-lam`` and adds ``log(u)`` of a fresh uniform draw.  A row
    whose log-product has fallen to ``-lam`` never moves again, so the
    loop runs blocks of :data:`POISSON_BLOCK` iterations and asks the
    device once a block whether any row is unfinished (one host sync)."""
    lam32 = _check_rate(lam)
    rngs = list(keys)
    k = torch.zeros((len(rngs), n), dtype=torch.int32, device=device)
    if lam32 == 0.0 or n == 0 or not rngs:
        return k.float()
    log_prod = torch.zeros((len(rngs), n), dtype=torch.float32,
                           device=device)
    while True:
        for _ in range(POISSON_BLOCK):
            subs = []
            for j, rng in enumerate(rngs):
                rngs[j], sub = split(rng)
                subs.append(sub)
            u = uniform_f32(subs, n, device)
            k = k + (log_prod > -lam32).to(torch.int32)
            log_prod = log_prod + torch.log(u)
        if not bool((log_prod > -lam32).any()):
            break
    return (k - 1).float()
