"""Port parity for kernel B1's plain version: ``shifu_tpu_torch.ops.tree.
build_histograms`` on CPU tensors against ``shifu_tpu.ops.tree.
build_histograms`` (segment_sum scatter) and against the Pallas kernel
``build_histograms_pallas`` in interpret mode, on the same numpy-seeded
inputs.

Tolerances: the count channel (integer weights) is exact in all three.
Other channels agree within 1e-5 of the cell's sum of |stats| (the
reference scatters in f32, the port sums in f64 and rounds once).  The
Pallas kernel computes through a bf16 hi/lo split that keeps about 16
mantissa bits per product (ROADMAP Queue 3, C4), so its comparison feeds
stats with at most 16 significant bits, where the split is exact and only
the f32 accumulation differs.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shifu_tpu.ops.hist_pallas import build_histograms_pallas
from shifu_tpu.ops.tree import build_histograms as j_build_histograms
from shifu_tpu_torch.ops import hist
from shifu_tpu_torch.ops.tree import build_histograms

pytestmark = pytest.mark.torch_port

RTOL = 1e-5


def _inputs(seed, n, c, b, k, s, dtype, inactive=0.3, grid16=False):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b, size=(n, c)).astype(dtype)
    node = rng.integers(0, k, size=n).astype(np.int32)
    node[rng.random(n) < inactive] = -1
    w = rng.integers(1, 4, size=(n, 1)).astype(np.float32)
    other = rng.normal(size=(n, s - 1)).astype(np.float32)
    if grid16:                 # <= 16 significant bits: bf16 hi+lo exact
        other = np.round(other * 256) / 256
    return bins, node, np.concatenate([w, w * other], axis=1)


def _port(bins, node, stats, k, b):
    return build_histograms(torch.from_numpy(bins), torch.from_numpy(node),
                            torch.from_numpy(stats), k, b).numpy()


def _assert_close(got, want, abs_hist):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., 0], want[..., 0])   # counts
    assert np.all(np.abs(got - want) <= RTOL * abs_hist + 1e-30)


@pytest.mark.parametrize("n,c,b,k,s,dtype", [
    (400, 6, 16, 1, 2, np.uint8), (400, 6, 64, 3, 2, np.uint8),
    (700, 9, 256, 8, 3, np.uint8), (300, 5, 33, 3, 3, np.int32),
    (600, 7, 4001, 8, 2, np.int32), (250, 7, 4001, 3, 3, np.int32)])
def test_plain_version_matches_reference_scatter(n, c, b, k, s, dtype):
    bins, node, stats = _inputs(n + k, n, c, b, k, s, dtype)
    got = _port(bins, node, stats, k, b)
    want = np.asarray(j_build_histograms(
        jnp.asarray(bins), jnp.asarray(node), jnp.asarray(stats), k, b))
    _assert_close(got, want, _port(bins, node, np.abs(stats), k, b))


@pytest.mark.parametrize("n,c,b,k,s", [
    (300, 5, 16, 1, 2), (300, 5, 16, 3, 3), (200, 3, 40, 8, 2)])
def test_plain_version_matches_reference_pallas_interpret(n, c, b, k, s):
    bins, node, stats = _inputs(7 * n + k, n, c, b, k, s, np.int32,
                                grid16=True)
    got = _port(bins, node, stats, k, b)
    want = np.asarray(build_histograms_pallas(
        jnp.asarray(bins), jnp.asarray(node), jnp.asarray(stats), k, b,
        interpret=True))
    _assert_close(got, want, _port(bins, node, np.abs(stats), k, b))


def test_narrow_planes_give_the_int32_result():
    """uint8 and uint16 planes (uint16 widens on its device) sum exactly
    what the int32 plane of the same ids sums."""
    bins, node, stats = _inputs(5, 500, 4, 200, 4, 2, np.int32)
    want = _port(bins, node, stats, 4, 200)
    for dt in (np.uint8, np.uint16):
        np.testing.assert_array_equal(
            _port(bins.astype(dt), node, stats, 4, 200), want)
    wide = hist.widen_bins(torch.from_numpy(bins.astype(np.uint16)))
    assert wide.dtype == torch.int32
    np.testing.assert_array_equal(wide.numpy(), bins)


def test_rows_and_ids_out_of_range_contribute_nothing():
    """Node ids past K and bin ids outside [0, B) are dropped, as a plain
    loop over (row, column) drops them."""
    bins, node, stats = _inputs(9, 300, 3, 8, 2, 2, np.int32)
    rng = np.random.default_rng(10)
    node[rng.random(300) < 0.1] = 2
    bins[rng.random((300, 3)) < 0.1] = 8
    bins[rng.random((300, 3)) < 0.1] = -3
    want = np.zeros((2, 3, 8, 2), np.float64)
    for r in range(300):
        for col in range(3):
            if 0 <= node[r] < 2 and 0 <= bins[r, col] < 8:
                want[node[r], col, bins[r, col]] += stats[r]
    np.testing.assert_allclose(_port(bins, node, stats, 2, 8), want,
                               rtol=RTOL, atol=1e-6)


def test_cpu_tensors_launch_no_kernel():
    before = build_histograms.launches
    bins, node, stats = _inputs(3, 50, 2, 4, 1, 2, np.uint8)
    _port(bins, node, stats, 1, 4)
    assert build_histograms.launches == before


def test_hist_bytes_counts_active_rows_once():
    bins, node, stats = _inputs(4, 1000, 10, 64, 4, 2, np.uint8)
    active = int((node >= 0).sum())
    got = hist.hist_bytes(torch.from_numpy(bins), torch.from_numpy(node),
                          torch.from_numpy(stats), 4, 64)
    assert got == 4 * 1000 + active * (10 + 8) + 4 * 4 * 10 * 64 * 2


def _np_meta(stats):
    """numpy's reading of ``channel_meta`` on [TB, N, S]: max |value| and
    whether every value is an integer with max |value| * N < 2^31."""
    n = stats.shape[1]
    if n == 0:
        return (np.zeros(stats.shape[::2], np.float32),
                np.ones(stats.shape[::2], np.int32))
    with np.errstate(invalid="ignore"):
        amax = np.abs(stats).max(axis=1)
        whole = (stats == np.trunc(stats)).all(axis=1)
    return amax, (whole & (amax.astype(np.float64) * n < 2.0 ** 31)) \
        .astype(np.int32)


_N = 1024
_META_CASES = {
    "integer": np.arange(_N) % 5,
    "fraction": np.r_[np.zeros(_N - 1), 0.25],
    "negative_integer": -(np.arange(_N) % 9),
    "under_2^31": np.full(_N, (1 << 21) - 1),     # amax * N = 2^31 - 1024
    "at_2^31": np.full(_N, 1 << 21),              # amax * N = 2^31
    "nan": np.r_[np.zeros(_N - 1), np.nan],
    "inf": np.r_[np.zeros(_N - 1), -np.inf],
    "zeros": np.zeros(_N),
}


@pytest.mark.parametrize("case", sorted(_META_CASES))
def test_channel_meta_flags_32_bit_channels(case):
    """The flag that lets the kernel sum a channel in 32-bit integers,
    against numpy: integers (negative ones too) under the 2^31 edge set
    it; a fraction, the edge itself, NaN or inf clear it."""
    stats = np.stack([_META_CASES[case], np.arange(_N) % 3],
                     axis=1).astype(np.float32)[None]
    amax, exact = hist.channel_meta(torch.from_numpy(stats), _N)
    want_amax, want_exact = _np_meta(stats)
    np.testing.assert_array_equal(amax.numpy(), want_amax)
    np.testing.assert_array_equal(exact.numpy(), want_exact)
    assert exact.dtype == torch.int32 and amax.dtype == torch.float32
    assert exact[0, 1] == 1


def test_channel_meta_of_no_rows_is_exact():
    amax, exact = hist.channel_meta(torch.zeros((2, 0, 3)), 0)
    assert amax.shape == exact.shape == (2, 3)
    assert bool((amax == 0).all()) and bool((exact == 1).all())


@pytest.mark.parametrize("n,k,spread", [(2000, 3, 1.0), (500, 1, 1e6),
                                        (0, 2, 1.0)])
def test_fixed_point_plain_version_is_exact_integer_arithmetic(n, k,
                                                               spread):
    """``build_histograms_fixed_ref`` (the kernel's arithmetic, its
    card oracle) against Python integers: each value quantised to
    round(v * 2^e) with amax * N * 2^e < 2^62, the quanta summed exactly,
    the sum rounded to f32 once and scaled back; and within the
    quantisation (half of 2^-e a row, plus f32 rounding) of the float64
    plain version."""
    bins, node, stats = _inputs(n + k, n, 3, 8, k, 2, np.uint8)
    stats[:, 1] *= np.float32(spread)
    got = hist.build_histograms_fixed_ref(
        torch.from_numpy(bins), torch.from_numpy(node),
        torch.from_numpy(stats), k, 8).numpy()
    want = np.zeros((k, 3, 8, 2), np.float32)
    for s in range(2):
        amax = float(np.abs(stats[:, s]).max()) if n else 0.0
        t = amax * max(n, 1)
        e = 62 - math.frexp(t)[1] if t > 0 else 0
        sums = {}
        for r in range(n):
            if 0 <= node[r] < k:
                q = int(np.round(float(stats[r, s]) * 2.0 ** e))
                for col in range(3):
                    key = (node[r], col, bins[r, col])
                    sums[key] = sums.get(key, 0) + q
        for (kk, col, bb), v in sums.items():
            want[kk, col, bb, s] = np.float32(float(np.float32(v))
                                              * 2.0 ** -e)
        np.testing.assert_array_equal(got[..., s], want[..., s])
    plain = _port(bins, node, stats, k, 8)
    rows = _port(bins, node, np.ones_like(stats), k, 8)
    amax = np.abs(stats).max(axis=0) if n else np.zeros(2)
    e = np.array([62 - math.frexp(a * max(n, 1))[1] if a > 0 else 0
                  for a in amax])
    assert np.all(np.abs(got - plain) <= rows * 2.0 ** (-e - 1)
                  + np.spacing(np.abs(plain)))
