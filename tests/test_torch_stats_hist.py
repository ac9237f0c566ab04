"""Port parity for kernel B3's plain version:
``shifu_tpu_torch.ops.stats_hist.stats_histograms_ref`` (and the port's
``_histogram_kernel`` around it) on CPU tensors against the reference's
Pallas kernel ``stats_histograms_pallas`` in interpret mode and its
``segment_sum`` lowering (``_histogram_kernel(use_pallas=False)``), on the
same numpy-seeded inputs.

Tolerances: count channels are exact everywhere.  Weighted channels agree
within rtol/atol 1e-4 of the Pallas kernel, which recovers f32 through a
bf16 hi/lo split (ROADMAP Queue 3, C4), and within 1e-6 of the cell's
value against ``segment_sum`` (f32 sums in row order against the port's
f64 sum rounded once).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shifu_tpu.ops.binning import _histogram_kernel as j_histogram_kernel
from shifu_tpu.ops.hist_pallas import stats_histograms_pallas
from shifu_tpu_torch.ops import stats_hist
from shifu_tpu_torch.ops.binning import _bucket_ids, _histogram_kernel

pytestmark = pytest.mark.torch_port


def _ids(seed, n, c, b, s, invalid=0.05):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, b, size=(n, c)).astype(np.int32)
    idx[rng.random((n, c)) < invalid] = -1
    pos = (rng.random(n) < 0.3).astype(np.float32)
    chans = [pos, 1.0 - pos]
    if s == 4:
        w = rng.uniform(0.5, 2.0, n).astype(np.float32)
        chans += [w * pos, w * (1.0 - pos)]
    return idx, np.stack(chans, axis=1), (True, True) + (False,) * (s - 2)


@pytest.mark.parametrize("n,c,b,s", [(300, 5, 64, 2), (257, 9, 128, 4),
                                     (1, 3, 64, 4), (2048, 2, 4096, 2)])
def test_plain_version_matches_the_pallas_kernel(n, c, b, s):
    idx, st, exact = _ids(n + c, n, c, b, s)
    got = stats_hist.stats_histograms_ref(torch.from_numpy(idx),
                                          torch.from_numpy(st), b).numpy()
    want = np.asarray(stats_histograms_pallas(
        jnp.asarray(idx), jnp.asarray(st), b, interpret=True, exact=exact))
    assert got.shape == want.shape == (c, b, s) and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # every valid cell lands in exactly one bucket
    np.testing.assert_array_equal(got[..., 0].sum(1) + got[..., 1].sum(1),
                                  (idx >= 0).sum(0))


@pytest.mark.parametrize("unit_weight", [True, False])
@pytest.mark.parametrize("b", [64, 256, 4096])
def test_histogram_kernel_matches_segment_sum(unit_weight, b):
    rng = np.random.default_rng(b)
    r, c = 3000, 10
    x = (rng.normal(size=(r, c)) * 10).astype(np.float32)
    x[:, 3] = np.round(x[:, 3])              # ties on bucket edges
    valid = rng.random((r, c)) > 0.07
    t = (rng.random(r) < 0.3).astype(np.float32)
    w = rng.uniform(0.5, 2.0, r).astype(np.float32)
    lo = x.min(0) - np.float32(1e-3)
    hi = x.max(0) + np.float32(1e-3)
    lo[5] = hi[5] = x[0, 5]                  # a zero-width range
    want = np.asarray(j_histogram_kernel(
        *(jnp.asarray(a) for a in (x, valid, t, w, lo, hi)), b,
        use_pallas=False, unit_weight=unit_weight))
    tx, tv, tt, tw, tlo, thi = (torch.from_numpy(a)
                                for a in (x, valid, t, w, lo, hi))
    got = _histogram_kernel(tx, tv, tt, tw, tlo, thi, b,
                            unit_weight=unit_weight).numpy()
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the bucket ids themselves, against the reference's f32 formula
    scale = b / jnp.maximum(jnp.asarray(hi) - jnp.asarray(lo), 1e-30)
    j_idx = np.asarray(jnp.clip((jnp.asarray(x) - jnp.asarray(lo)) * scale,
                                0, b - 1).astype(jnp.int32))
    np.testing.assert_array_equal(_bucket_ids(tx, tv, tlo, thi, b).numpy(),
                                  np.where(valid, j_idx, -1))


def test_dispatch_and_launcher_contract():
    """CPU tensors take the plain version (no launch counted); the CUDA
    launcher refuses CPU tensors and bad shapes instead of falling back."""
    idx, st, exact = _ids(7, 100, 4, 64, 4)
    ti, ts = torch.from_numpy(idx), torch.from_numpy(st)
    before = stats_hist.stats_histograms_cuda.launches
    got = stats_hist.stats_histograms(ti, ts, 64, exact)
    assert torch.equal(got, stats_hist.stats_histograms_ref(ti, ts, 64))
    assert stats_hist.stats_histograms_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        stats_hist.stats_histograms_cuda(ti, ts, 64, exact)
    with pytest.raises(ValueError, match="multiple of 64"):
        stats_hist.stats_histograms_ref(ti, ts, 100)
    with pytest.raises(ValueError, match="share N"):
        stats_hist.stats_histograms_ref(ti[:5], ts, 64)
    assert stats_hist.stats_hist_bytes(ti, ts, 64) == \
        4 * 100 * 4 + 4 * 100 * 4 + 4 * 4 * 64 * 4
