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
``jax/_src/random.py`` ``_uniform``, ``_poisson_knuth``,
``_poisson_rejection``).

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

Only the integer part has to be exact (keys, bits, uniforms); Knuth's
Poisson loop (rates below 10) then adds ``log(u)`` in float32 as jax does.
``torch.log`` and XLA's ``log`` differ in the last bit for some inputs,
which moves a bag only where a row's running log-product lands within
that bit of ``-lam``.

Rates of 10 and above take jax's transformed rejection sampler (Hörmann),
whose accept test ``s <= t`` subtracts ``lgamma(k + 1)`` from numbers of
the order of ``k * log(lam)``: at a rate of 1000 or 1e5 one ulp of a
different ``lgamma`` flips whole draws.  So this module carries XLA's
float32 ``lgamma`` (the Lanczos form XLA expands it to, ROADMAP C10) over
its own copies of XLA:CPU's ``log`` (Cephes' polynomial) and ``log1p``
(Cephes' rational form below sqrt(2) - 1), with the multiply-adds XLA
fuses done as fused multiply-adds.  Built of IEEE adds, multiplies,
divisions and ``floor`` only, it gives the same bits on the CPU and on
the card.
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
#: rates at or above this take jax's rejection sampler
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
    return lam32


def poisson(keys, lam: float, n: int, device=None) -> torch.Tensor:
    """[len(keys), n] float32: ``jax.random.poisson(key, lam, (n,))``
    under each key — Knuth's loop below a rate of 10, the transformed
    rejection sampler from 10 on (jax's two branches).

    Each Knuth iteration splits every running key, adds one to the rows
    still above ``-lam`` and adds ``log(u)`` of a fresh uniform draw.  A
    row whose log-product has fallen to ``-lam`` never moves again, so the
    loop runs blocks of :data:`POISSON_BLOCK` iterations and asks the
    device once a block whether any row is unfinished (one host sync)."""
    lam32 = _check_rate(lam)
    rngs = list(keys)
    k = torch.zeros((len(rngs), n), dtype=torch.int32, device=device)
    if lam32 == 0.0 or n == 0 or not rngs:
        return k.float()
    if lam32 >= KNUTH_MAX_RATE:
        return _poisson_rejection(rngs, lam32, n, device)
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


# ---------------------------------------------- XLA:CPU's float32 math
def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` with one rounding to float32 (the product of two
    float32 values is exact in float64); a Python number is first rounded
    to float32, as XLA's constant is."""
    def d(v):
        return v.double() if isinstance(v, torch.Tensor) \
            else float(np.float32(v))
    return (d(a) * d(b) + d(c)).float()


def _f32(v: float) -> float:
    return float(np.float32(v))


_LOG_P = tuple(_f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log``: Cephes' degree-8 polynomial on the
    mantissa shifted to [sqrt(1/2), sqrt(2)) around 1, plus the exponent
    times ln 2 in two parts; ``-inf`` at 0 and at denormals (which XLA:CPU
    flushes to zero), NaN below 0, ``inf`` at ``inf``."""
    xin = x
    m, e = torch.frexp(x)
    e = e.float()
    small = m < _f32(0.707106781186547524)
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.float()
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma(x, p[0], p[1])
    y1 = _fma(x, p[3], p[4])
    y2 = _fma(x, p[6], p[7])
    y = _fma(y, x, p[2])
    y1 = _fma(y1, x, p[5])
    y2 = _fma(y2, x, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _f32(-2.12194440e-4))
    x = x - x2 * 0.5
    x = x + y
    out = x + e * 0.693359375
    out = torch.where(xin < float(np.finfo(np.float32).tiny),
                      torch.full_like(out, -float("inf")), out)
    out = torch.where(xin < 0, torch.full_like(out, float("nan")), out)
    return torch.where(xin == float("inf"), xin, out)


_LOG1P_NUM = tuple(_f32(c) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(_f32(c) for c in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log1p``: Cephes' rational approximation
    ``x - x^2/2 + x^3 P(x)/Q(x)`` where ``|x| < sqrt(2) - 1``, else
    :func:`log_f32` of ``1 + x``."""
    def poly(coeffs):
        p = torch.zeros_like(x)
        for c in coeffs:
            p = _fma(p, x, c)
        return p
    x2 = x * x
    small = (poly(_LOG1P_NUM) / poly(_LOG1P_DEN)) * (x * x2)
    small = x + (x2 * -0.5 + small)
    large = log_f32(torch.where(x > -1.0, x + 1.0, torch.ones_like(x)))
    return torch.where(x.abs() < _f32(0.41421356237309504880), small, large)


_LANCZOS = tuple(_f32(c) for c in (
    676.520368121885098567009190444019, -1259.13921672240287047156078755283,
    771.3234287776530788486528258894, -176.61502916214059906584551354,
    12.507343278686904814458936853, -0.13857109526572011689554707,
    9.984369578019570859563e-6, 1.50563273514931155834e-7))


def lgamma_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``lgamma`` for ``x >= 0.5`` (the Lanczos
    approximation, g = 7, in the op order XLA compiles it to: ``z/7.5`` as
    a multiply by its float32 reciprocal).  The reflection XLA takes below
    0.5 is not needed here: the rejection sampler rejects every draw whose
    ``k + 1`` is below 1.  Below 0.5 this returns NaN."""
    z = x - 1.0
    # a Python number over a tensor would be a reciprocal times the
    # number in PyTorch (two roundings): divide tensors
    acc = torch.full_like(z, _LANCZOS[0]) / (z + 1.0) + 1.0
    for i, c in enumerate(_LANCZOS[1:], start=2):
        acc = acc + torch.full_like(z, c) / (z + float(i))
    t = z + 7.5
    log_t = log1p_f32(z * _f32(1.0 / 7.5)) + _f32(np.log(7.5))
    log_y = _fma(z + 0.5 - t / log_t, log_t, _f32(0.5 * np.log(2 * np.pi)))
    out = log_y + log_f32(acc)
    return torch.where(x >= 0.5, out, torch.full_like(out, float("nan")))


def _poisson_rejection(keys, lam32: float, n: int, device) -> torch.Tensor:
    """jax's ``_poisson_rejection`` for a rate >= 10 under each key: each
    iteration splits the key in three, draws two full-shape uniforms and
    takes, at every row it accepts, this iteration's ``k`` — also at rows
    accepted before, as jax's ``select`` does — until every row of that
    key is accepted.  A key whose rows are all accepted stops changing;
    the device is asked once a block of iterations whether any key still
    runs."""
    lam = torch.tensor(lam32, dtype=torch.float32, device=device)
    log_lam = log_f32(lam)
    b = _fma(2.53, torch.sqrt(lam), 0.931)
    a = _fma(0.02483, b, -0.059)
    inv_alpha = 1.1239 + torch.full_like(b, 1.1328) / (b - 3.4)
    v_r = 0.9277 - torch.full_like(b, 3.6224) / (b - 2.0)
    two_a = 2.0 * a
    rngs = list(keys)
    k_out = torch.full((len(rngs), n), -1.0, dtype=torch.float32,
                       device=device)
    accepted = torch.zeros((len(rngs), n), dtype=torch.bool, device=device)
    while True:
        for _ in range(POISSON_BLOCK):
            running = ~accepted.all(dim=1, keepdim=True)
            s0, s1 = [], []
            for j, rng in enumerate(rngs):
                rngs[j], k0, k1 = split(rng, 3)
                s0.append(k0)
                s1.append(k1)
            u = uniform_f32(s0, n, device) - 0.5
            v = uniform_f32(s1, n, device)
            us = 0.5 - u.abs()
            k = torch.floor(_fma(two_a / us + b, u, lam) + 0.43)
            s = log_f32(v * inv_alpha / (a / (us * us) + b))
            t = _fma(k, log_lam, -lam) - lgamma_f32(k + 1.0)
            accept1 = (us >= 0.07) & (v <= v_r)
            reject = (k < 0) | ((us < 0.013) & (v > us))
            accept = (accept1 | (~reject & (s <= t))) & running
            k_out = torch.where(accept, k, k_out)
            accepted = accepted | accept
        if bool(accepted.all()):
            break
    return k_out
