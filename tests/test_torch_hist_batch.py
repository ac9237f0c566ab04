"""Port parity for kernel B2's plain version: ``shifu_tpu_torch.ops.tree.
build_histograms_batch`` on CPU tensors against per-tree
``build_histograms_ref`` (exact: the batched plain version IS that loop,
so on the CPU a batched build equals the sequential ones bit for bit),
against ``shifu_tpu.ops.tree.build_histograms_batch`` (the reference's
vmapped segment_sum scatter) and against its Pallas kernel
``build_histograms_pallas_batch`` in interpret mode, on the same
numpy-seeded inputs.

Tolerances as for B1 (``tests/test_torch_hist.py``, ROADMAP Queue 3 C4):
count channels exact, the others within 1e-5 of the cell's sum of
|stats|; the Pallas comparison feeds stats of at most 16 significant bits,
where its bf16 hi/lo split is exact.  The kernel itself runs only on the
card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shifu_tpu.ops.hist_pallas import build_histograms_pallas_batch
from shifu_tpu.ops.tree import build_histograms_batch as j_batch
from shifu_tpu_torch.ops import hist
from shifu_tpu_torch.ops.tree import build_histograms_batch

pytestmark = pytest.mark.torch_port

RTOL = 1e-5


def _inputs(seed, n, c, b, k, tb, s, dtype, grid16=False):
    """Shared bins; per tree node ids (~30% inactive) and stats [bag *
    w, bag * w * g] with Poisson bags, so ~1/3 of each tree's rows
    weigh 0."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b, size=(n, c)).astype(dtype)
    node = rng.integers(0, k, size=(tb, n)).astype(np.int32)
    node[rng.random((tb, n)) < 0.3] = -1
    w = rng.poisson(1.0, size=(tb, n, 1)) \
        * rng.integers(1, 4, size=(1, n, 1))
    other = rng.normal(size=(tb, n, s - 1))
    if grid16:                 # <= 16 significant bits: bf16 hi+lo exact
        other = np.round(other * 256) / 256
    stats = np.concatenate([w, w * other], axis=2).astype(np.float32)
    return bins, node, stats


def _port(bins, node, stats, k, b):
    return build_histograms_batch(torch.from_numpy(bins),
                                  torch.from_numpy(node),
                                  torch.from_numpy(stats), k, b).numpy()


def _assert_close(got, want, abs_hist):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., 0], want[..., 0])   # counts
    assert np.all(np.abs(got - want) <= RTOL * abs_hist + 1e-30)


CASES = [(400, 6, 16, 1, 8, 2, np.uint8), (400, 6, 64, 3, 4, 2, np.uint8),
         (500, 9, 256, 8, 3, 3, np.uint8), (300, 5, 33, 3, 2, 3, np.int32),
         (600, 7, 4001, 8, 2, 2, np.int32), (200, 4, 16, 2, 1, 1, np.uint8)]


@pytest.mark.parametrize("n,c,b,k,tb,s,dtype", CASES)
def test_plain_batch_equals_per_tree_builds(n, c, b, k, tb, s, dtype):
    bins, node, stats = _inputs(n + tb, n, c, b, k, tb, s, dtype)
    got = _port(bins, node, stats, k, b)
    assert got.shape == (tb, k, c, b, s)
    for t in range(tb):
        want = hist.build_histograms_ref(
            torch.from_numpy(bins), torch.from_numpy(node[t]),
            torch.from_numpy(stats[t]), k, b).numpy()
        assert got[t].tobytes() == want.tobytes(), t


@pytest.mark.parametrize("n,c,b,k,tb,s,dtype", CASES)
def test_plain_batch_matches_reference_scatter(n, c, b, k, tb, s, dtype):
    bins, node, stats = _inputs(3 * n + tb, n, c, b, k, tb, s, dtype)
    got = _port(bins, node, stats, k, b)
    want = np.asarray(j_batch(jnp.asarray(bins), jnp.asarray(node),
                              jnp.asarray(stats), k, b))
    _assert_close(got, want, _port(bins, node, np.abs(stats), k, b))


@pytest.mark.parametrize("n,c,b,k,tb,s", [
    (300, 5, 16, 1, 3, 2), (200, 3, 40, 4, 2, 3)])
def test_plain_batch_matches_reference_pallas_interpret(n, c, b, k, tb, s):
    bins, node, stats = _inputs(5 * n + k, n, c, b, k, tb, s, np.int32,
                                grid16=True)
    got = _port(bins, node, stats, k, b)
    want = np.asarray(build_histograms_pallas_batch(
        jnp.asarray(bins), jnp.asarray(node), jnp.asarray(stats), k, b,
        interpret=True))
    _assert_close(got, want, _port(bins, node, np.abs(stats), k, b))


def test_cpu_tensors_launch_no_kernel():
    before = build_histograms_batch.launches
    bins, node, stats = _inputs(3, 50, 2, 4, 1, 2, 2, np.uint8)
    _port(bins, node, stats, 1, 4)
    assert build_histograms_batch.launches == before


def test_hist_batch_bytes_counts_shared_bins_once():
    """Bins of the rows live in ANY tree once, each tree's node ids, the
    stats of its live rows, and the output."""
    bins, node, stats = _inputs(4, 1000, 10, 64, 4, 3, 2, np.uint8)
    live = (node >= 0) & (node < 4)
    got = hist.hist_batch_bytes(torch.from_numpy(bins),
                                torch.from_numpy(node),
                                torch.from_numpy(stats), 4, 64)
    assert got == int(live.any(0).sum()) * 10 + 4 * 3 * 1000 \
        + int(live.sum()) * 8 + 4 * 3 * 4 * 10 * 64 * 2


def test_channel_meta_is_per_tree_and_channel():
    """Each (tree, channel) of a batch gets its own flag and max |value|,
    as numpy computes them: Poisson bags x integer weights are exact, the
    w*g channel is not, and one tree's large weights cross 2^31 alone."""
    bins, node, stats = _inputs(8, 1000, 4, 16, 2, 4, 2, np.uint8)
    stats[2, :, 0] = 3_000_000.0           # x 1000 rows > 2^31
    stats[3, :, 1] = np.round(stats[3, :, 1])
    amax, exact = hist.channel_meta(torch.from_numpy(stats), 1000)
    want_amax = np.abs(stats).max(axis=1)
    want_exact = (stats == np.trunc(stats)).all(axis=1) \
        & (want_amax.astype(np.float64) * 1000 < 2.0 ** 31)
    np.testing.assert_array_equal(amax.numpy(), want_amax)
    np.testing.assert_array_equal(exact.numpy(), want_exact)
    assert exact.numpy().tolist() == [[1, 0], [1, 0], [0, 0], [1, 1]]
