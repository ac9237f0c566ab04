"""JAX's threefry random stream in PyTorch — the counterpart of the
``jax.random`` calls the RF and NN trainers make (``PRNGKey``,
``fold_in``, ``split``, ``uniform``, ``normal``, ``bernoulli`` and
``poisson``), bit for bit where the arithmetic allows.

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

The NN trainer draws its initial weights (``uniform`` over a range for
Xavier, ``normal`` for He and Lecun) and its dropout masks
(``bernoulli``) from the same stream.  A uniform over ``[lo, hi)`` is one
fused multiply-add, as XLA compiles it, so Xavier weights are bit-equal;
``normal`` is ``sqrt(2) * erf_inv(u)`` with ``u`` uniform on (-1, 1), in
XLA's float32 approximation of ``erf_inv``, whose ``log1p`` differs from
XLA's in the last bit, so He and Lecun weights agree within a few ulps.

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


def uniform_range_f32(key: Key, n: int, lo: float, hi: float,
                      device=None) -> torch.Tensor:
    """[n]: ``jax.random.uniform(key, (n,), float32, lo, hi)`` — the unit
    draw scaled by ``hi - lo`` (in f32) and shifted by ``lo`` in one
    fused multiply-add, floored at ``lo``."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    u = uniform_f32([key], n, device)[0]
    # the f64 product of two f32 values is exact: one rounding, as an FMA
    out = (u.double() * float(hi32 - lo32) + float(lo32)).float()
    return out.clamp_min(float(lo32))


# Giles' float32 approximation of erfinv, the one XLA compiles
# (``ErfInv32``): coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: ``p(w) * x`` with ``w = -log1p(-x^2)``
    and a degree-8 polynomial in ``w - 2.5`` or ``sqrt(w) - 3``, its
    Horner steps fused multiply-adds as XLA:CPU compiles them.  Within a
    few ulps of XLA (``log1p`` differs in the last bit)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    lt_c = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=x.device)
    ge_c = torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lt_c[0], ge_c[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = (p.double() * w + torch.where(lt, lt_c[i], ge_c[i])).float()
    out = p * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       out)


def normal_f32(key: Key, n: int, device=None) -> torch.Tensor:
    """[n]: ``jax.random.normal(key, (n,), float32)`` — ``sqrt(2) *
    erf_inv(u)`` for ``u`` uniform on ``(nextafter(-1, 0), 1)``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform_range_f32(key, n, lo, 1.0, device)
    return erfinv_f32(u) * torch.tensor(np.sqrt(2), dtype=torch.float32)


def bernoulli(keys, p, shape, device=None) -> torch.Tensor:
    """[len(keys), *shape] bool: ``jax.random.bernoulli(key, p, shape)``
    for a float32 ``p`` under each key — a float32 uniform over the
    flattened shape, below ``p``.  ``p`` is a number or a [len(keys)]
    tensor (one rate a key)."""
    n = int(np.prod(shape))
    u = uniform_f32(list(keys), n, device)
    if isinstance(p, torch.Tensor):
        p = p.to(device=u.device, dtype=torch.float32).reshape(-1, 1)
    else:
        p = float(np.float32(p))
    return (u < p).reshape(len(keys), *shape)


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
