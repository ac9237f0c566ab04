"""Card-only tests of the port's hand-written CUDA kernels: each kernel
(B4 ``tree_traverse``, B1 ``hist``, B2 ``hist_batch``, B3 ``stats_hist``)
against its plain PyTorch version on the same numpy-seeded inputs (B2 also
against B1 tree by tree); tree growth, Random Forest bags and the stats
accumulator on the card against the CPU; and GBT and RF chunks run under
``torch.cuda.set_sync_debug_mode("error")``.

A CUDA kernel has no CPU mode, so every test here carries the ``gpu``
marker and skips without CUDA.  The file imports neither ``jax`` nor
``shifu_tpu``, so it runs on the machine with the card:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from shifu_tpu_torch.ops import tree_quant as tq
from shifu_tpu_torch.ops.tree import n_tree_nodes

pytestmark = [pytest.mark.torch_port, pytest.mark.gpu]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _forest(n_trees, depth, n_bins, n_cols, seed):
    rng = np.random.default_rng(seed)
    k = n_tree_nodes(depth)
    sf = rng.integers(0, n_cols, size=(n_trees, k)).astype(np.int32)
    sf[rng.random((n_trees, k)) < 0.1] = -1
    sf[:, (1 << depth) - 1:] = -1
    lm = (rng.random((n_trees, k, n_bins)) < 0.5).astype(np.uint8)
    lv = rng.normal(0.0, 0.1, size=(n_trees, k)).astype(np.float32)
    return sf, lm, lv


def _on(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


@pytest.mark.parametrize("n_rows,n_cols,n_bins,depth,dtype", [
    (1, 256, 64, 7, np.uint8), (8, 256, 64, 7, np.uint8),
    (64, 256, 64, 7, np.uint8), (333, 256, 64, 7, np.uint8),
    (512, 256, 64, 7, np.uint8), (4096, 256, 64, 7, np.uint8),
    (1000, 13, 256, 3, np.uint8), (129, 3, 2, 1, np.uint8),
    (40, 60000, 32, 5, np.uint8), (70, 5, 64, 0, np.uint8),
    (1000, 7, 4001, 4, np.int32), (300, 256, 300, 7, np.int32)])
def test_tree_traverse_kernel_equals_plain_version(cuda, n_rows, n_cols,
                                                   n_bins, depth, dtype):
    """Bit-equal [T, N] output across row counts, odd column counts (the
    byte-copy staging path), a plane wider than 48 KB of shared memory per
    row tile, depth 0, and int32 planes of forests past 256 bins; bins run
    past n_bins to pin the clamp."""
    sf, lm, lv = _forest(100, depth, n_bins, n_cols, seed=n_rows + depth)
    hi = n_bins + 16 if dtype == np.int32 else min(255, n_bins + 16)
    bins = np.random.default_rng(n_rows).integers(
        0, hi, size=(n_rows, n_cols)).astype(dtype)
    args = _on(cuda, sf, lm, lv, bins)
    before = tq.predict_forest_quant.launches
    got = tq.predict_forest_quant(*args, depth)
    torch.cuda.synchronize()
    want = tq.predict_forest_quant_ref(*args, depth)
    assert tq.predict_forest_quant.launches == before + 1
    assert got.shape == (100, n_rows) and torch.equal(got, want)


def test_tree_traverse_kernel_rejects_what_it_cannot_take(cuda):
    sf, lm, lv = _on(cuda, *_forest(2, 3, 8, 4, seed=1))
    bins = torch.zeros((5, 4), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="bins"):
        tq.predict_forest_quant(sf, lm, lv, bins.long(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        tq.predict_forest_quant(sf, lm, lv, bins.t().contiguous().t(), 3)
    with pytest.raises(ValueError, match="nodes per tree"):
        tq.predict_forest_quant(sf, lm, lv, bins, 4)
    with pytest.raises(NotImplementedError):
        tq.predict_forest_quant(sf, lm, lv[..., None], bins, 3)


# ------------------------------------------------------------------ B1
def _hist_inputs(n, c, b, k, s, dtype, seed):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b, size=(n, c)).astype(dtype)
    node = rng.integers(0, k, size=n).astype(np.int32)
    node[rng.random(n) < 0.3] = -1
    w = rng.integers(1, 4, size=(n, 1)).astype(np.float32)
    other = rng.normal(size=(n, s - 1)).astype(np.float32)
    return bins, node, np.concatenate([w, w * other], axis=1)


@pytest.mark.parametrize("n,c,b,k,s,dtype", [
    (1, 256, 64, 1, 2, np.uint8), (1000, 256, 64, 2, 2, np.uint8),
    (65536, 256, 64, 32, 2, np.uint8), (5000, 7, 4001, 8, 2, np.int32),
    (3000, 3, 65536, 1, 1, np.int32), (4000, 5, 64, 300, 3, np.uint8),
    (2000, 33, 7, 3, 4, np.uint8), (0, 4, 8, 2, 2, np.uint8)])
def test_hist_kernel_matches_plain_version(cuda, n, c, b, k, s, dtype):
    """Count channel equal, the others within 1e-5 of the cell's |stats|
    sum; a second launch is bit-equal.  Covers node tiling (K=300), bin
    tiling (B=65536), S in {1..4}, odd column counts and N=0."""
    from shifu_tpu_torch.ops import hist
    from shifu_tpu_torch.ops.tree import build_histograms
    bins, node, stats = _on(cuda, *_hist_inputs(n, c, b, k, s, dtype,
                                                 seed=n + k))
    before = build_histograms.launches
    got = build_histograms(bins, node, stats, k, b)
    again = build_histograms(bins, node, stats, k, b)
    torch.cuda.synchronize()
    assert build_histograms.launches == before + 2
    want = hist.build_histograms_ref(bins, node, stats, k, b)
    scale = hist.build_histograms_ref(bins, node, stats.abs(), k, b)
    assert got.shape == (k, c, b, s) and torch.equal(got, again)
    assert torch.equal(got[..., 0], want[..., 0])
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


def test_hist_kernel_rejects_what_it_cannot_take(cuda):
    from shifu_tpu_torch.ops.tree import build_histograms
    bins, node, stats = _on(cuda, *_hist_inputs(10, 4, 8, 2, 2, np.uint8, 1))
    with pytest.raises(ValueError, match="bins"):
        build_histograms(bins.float(), node, stats, 2, 8)
    # int64 ids widen to int32 like uint16 ones, as the reference's astype
    assert torch.equal(build_histograms(bins.long(), node, stats, 2, 8),
                       build_histograms(bins, node, stats, 2, 8))
    with pytest.raises(ValueError, match="stats"):
        build_histograms(bins, node, stats.double(), 2, 8)
    with pytest.raises(ValueError, match="node_idx"):
        build_histograms(bins, node.long(), stats, 2, 8)
    with pytest.raises(ValueError, match="B <= 65536"):
        build_histograms(bins.int(), node, stats, 2, 70000)


# ------------------------------------------------------------------ B2
def _batch_inputs(n, c, b, k, tb, s, dtype, seed):
    """Shared bins; per tree its own node ids (~30% inactive) and stats
    (integer bag-like weights, ~1/3 of them 0, times N(0, 1) channels)."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b, size=(n, c)).astype(dtype)
    node = rng.integers(0, k, size=(tb, n)).astype(np.int32)
    node[rng.random((tb, n)) < 0.3] = -1
    w = rng.poisson(1.0, size=(tb, n, 1)).astype(np.float32)
    other = rng.normal(size=(tb, n, s - 1)).astype(np.float32)
    return bins, node, np.concatenate([w, w * other], axis=2)


@pytest.mark.parametrize("n,c,b,k,tb,s,dtype", [
    (1000, 256, 64, 1, 8, 2, np.uint8), (65536, 256, 64, 2, 8, 2, np.uint8),
    (65536, 256, 64, 32, 8, 2, np.uint8), (1, 256, 64, 1, 1, 2, np.uint8),
    (5000, 7, 4001, 8, 3, 2, np.int32), (3000, 3, 65536, 1, 2, 1, np.int32),
    (4000, 5, 64, 300, 2, 3, np.uint8), (2000, 33, 7, 3, 5, 4, np.uint8),
    (20000, 64, 64, 4096, 2, 2, np.uint8), (0, 4, 8, 2, 2, 2, np.uint8)])
def test_hist_batch_kernel_equals_b1_per_tree(cuda, n, c, b, k, tb, s,
                                              dtype):
    """Every tree's slice is bit-equal to a B1 launch on that tree's node
    ids and stats, a second launch is bit-equal, and the count channel
    equals the plain version.  Covers both modes (shared rows at small
    K, partitioned rows), node and bin tiling, TB = 1, S in {1..4}, odd
    column counts, K = 4096 and N = 0."""
    from shifu_tpu_torch.ops import hist
    from shifu_tpu_torch.ops.tree import (build_histograms,
                                          build_histograms_batch)
    bins, node, stats = _on(cuda, *_batch_inputs(n, c, b, k, tb, s, dtype,
                                                 seed=n + k + tb))
    before = build_histograms_batch.launches
    got = build_histograms_batch(bins, node, stats, k, b)
    again = build_histograms_batch(bins, node, stats, k, b)
    torch.cuda.synchronize()
    assert build_histograms_batch.launches == before + 2
    assert got.shape == (tb, k, c, b, s) and torch.equal(got, again)
    want = hist.build_histograms_batch_ref(bins, node, stats, k, b)
    assert torch.equal(got[..., 0], want[..., 0])
    # the other layout (partitioned rows forced) gives the same bits
    assert torch.equal(hist.build_histograms_batch_cuda(
        bins, node, stats, k, b, mode=0), got)
    for t in range(tb):
        assert torch.equal(got[t], build_histograms(bins, node[t], stats[t],
                                                    k, b)), t


def test_hist_batch_kernel_rejects_what_it_cannot_take(cuda):
    from shifu_tpu_torch.ops.tree import build_histograms_batch
    bins, node, stats = _on(cuda, *_batch_inputs(10, 4, 8, 2, 3, 2,
                                                 np.uint8, 1))
    with pytest.raises(ValueError, match="bins"):
        build_histograms_batch(bins.float(), node, stats, 2, 8)
    with pytest.raises(ValueError, match="stats_b"):
        build_histograms_batch(bins, node, stats.double(), 2, 8)
    with pytest.raises(ValueError, match="node_idx_b"):
        build_histograms_batch(bins, node[0], stats, 2, 8)
    with pytest.raises(ValueError, match="rows of bins"):
        build_histograms_batch(bins, node[:2], stats, 2, 8)


def test_grow_forest_on_the_card_equals_grow_tree(cuda):
    """A batch of 4 depth-9 entropy trees (K up to 256 left children, so
    both kernel modes) grown by grow_forest on B2 equals grow_tree on B1
    tree by tree, bit for bit, with MaxLeaves on one run."""
    from shifu_tpu_torch.ops import tree as tt
    rng = np.random.default_rng(8)
    n, c = 30000, 24
    bins = rng.integers(0, 32, size=(n, c)).astype(np.uint8)
    y = (rng.random(n) < 0.3).astype(np.float32)
    bag = rng.poisson(1.0, size=(4, n)).astype(np.float32)
    stats = np.stack([bag, bag * y], axis=2)
    fa = rng.random((4, c)) < 0.7
    cat = np.zeros(c, bool)
    cat[5] = True
    b, st, ct, f = _on(cuda, bins, stats, cat, fa)
    for max_leaves in (0, 40):
        forest = tt.grow_forest(b, st, ct, f, 32, 9, "entropy", 1.0, 0.0,
                                max_leaves)
        for t in range(4):
            one = tt.grow_tree(b, st[t], ct, f[t], 32, 9, "entropy", 1.0,
                               0.0, max_leaves)
            for x, z in zip(forest[t], one):
                assert torch.equal(x, z), (max_leaves, t)


def test_bags_on_the_card_equal_the_cpu(cuda):
    from shifu_tpu_torch.ops import prng
    keys = [prng.fold_in(prng.prng_key(7), t) for t in range(3)]
    for lam in (0.5, 1.0, 3.0):
        got = prng.poisson(keys, lam, 1 << 18, cuda).cpu()
        assert torch.equal(got, prng.poisson(keys, lam, 1 << 18, "cpu"))


def test_grow_tree_on_the_card_matches_the_cpu(cuda):
    """A separated-gain plane grows the same tree on both devices, and
    the card's tree is bit-identical from run to run."""
    from shifu_tpu_torch.ops import tree as tt
    rng = np.random.default_rng(5)
    bins = rng.integers(0, 32, size=(20000, 12)).astype(np.uint8)
    logit = 2.0 * (bins[:, 2] > 20) - 1.5 * (bins[:, 7] < 6)
    y = (rng.random(20000) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    w = rng.integers(1, 4, size=20000).astype(np.float32)
    stats = np.stack([w, w * (y - y.mean())], axis=1).astype(np.float32)
    cat = np.zeros(12, bool)
    cat[7] = True
    args = (np.ones(12, bool),)
    out = {}
    for dev in ("cpu", "cuda", "cuda"):
        b, st, ct, fa = _on(torch.device(dev), bins, stats, cat, *args)
        res = tt.grow_tree(b, st, ct, fa, 32, 5, "variance", 20.0, 0.5)
        out.setdefault(dev, []).append([r.cpu() for r in res])
    (cpu,), (card, card2) = out["cpu"], out["cuda"]
    for a, b in zip(card, card2):
        assert torch.equal(a, b)
    assert torch.equal(card[0], cpu[0]) and torch.equal(card[1], cpu[1])
    assert torch.equal(card[4], cpu[4])
    assert torch.allclose(card[2], cpu[2], rtol=1e-5, atol=1e-6)


def test_gbt_chunk_makes_no_host_sync(cuda):
    from shifu_tpu_torch.train import dt_trainer as dt
    rng = np.random.default_rng(6)
    n, c = 4096, 16
    bins, y, w = _on(cuda, rng.integers(0, 64, size=(n, c)).astype(np.uint8),
                     (rng.random(n) < 0.3).astype(np.float32),
                     rng.integers(1, 4, size=n).astype(np.float32))
    vw = w * (torch.arange(n, device=cuda) % 5 == 0)
    tw = w - vw
    settings = dt.DTSettings(n_trees=2, depth=5, loss="log",
                             learning_rate=0.1)
    fa = torch.ones((2, c), dtype=torch.bool, device=cuda)
    cat = torch.zeros(c, dtype=torch.bool, device=cuda)
    cat[3] = True
    f = torch.zeros(n, device=cuda)
    dt.gbt_forest_chunk(bins, y, tw, vw, f, fa, cat, settings, 64,
                        "variance", True)             # build + warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        f2, packed = dt.gbt_forest_chunk(bins, y, tw, vw, f, fa, cat,
                                         settings, 64, "variance", True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert packed.shape[0] == 2 and packed.dtype == torch.uint8
    assert bool(torch.isfinite(f2).all())


def test_rf_chunk_makes_no_host_sync(cuda):
    """10 RF trees of depth 6 in one chunk: a batch of 8 through B2 (one
    launch a level) and 2 single trees through B1, with no host sync
    once the bags are drawn; the packed trees equal a TreeBatch 1 run."""
    from shifu_tpu_torch.ops import tree as tt
    from shifu_tpu_torch.train import dt_trainer as dt
    rng = np.random.default_rng(9)
    n, c = 4096, 16
    bins, y, w = _on(cuda, rng.integers(0, 64, size=(n, c)).astype(np.uint8),
                     (rng.random(n) < 0.3).astype(np.float32),
                     rng.integers(1, 4, size=n).astype(np.float32))
    settings = dt.DTSettings(n_trees=10, depth=6, impurity="entropy")
    fa = torch.ones((10, c), dtype=torch.bool, device=cuda)
    cat = torch.zeros(c, dtype=torch.bool, device=cuda)
    cat[3] = True
    bags = dt.draw_bags(settings, range(10), n, cuda)
    zero = torch.zeros(n, device=cuda)

    def run(tree_batch):
        return dt.rf_forest_chunk(bins, y, w, bags, zero, zero, fa, cat,
                                  settings, 64, True, tree_batch)
    run(8)                                              # build + warm up
    torch.cuda.synchronize()
    batch, single = (tt.build_histograms_batch.launches,
                     tt.build_histograms.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run(8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tt.build_histograms_batch.launches == batch + 6
    assert tt.build_histograms.launches == single + 2 * 6
    want = run(1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _stats_inputs(n, c, b, s, seed, invalid=0.05):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, b, size=(n, c)).astype(np.int32)
    idx[rng.random((n, c)) < invalid] = -1
    pos = (rng.random(n) < 0.3).astype(np.float32)
    chans = [pos, 1.0 - pos]
    for k in range(s - 2):              # weighted channels
        w = rng.uniform(0.5, 3.0, n).astype(np.float32)
        chans.append(w * (pos if k % 2 == 0 else 1.0 - pos))
    return idx, np.stack(chans, axis=1), (True, True) + (False,) * (s - 2)


@pytest.mark.parametrize("n,c,b,s", [
    (262144, 224, 4096, 4), (262144, 224, 4096, 2), (1, 7, 64, 4),
    (100003, 13, 64, 2), (5000, 5, 4096, 4), (0, 3, 64, 2),
    (70001, 300, 64, 3)])
def test_stats_hist_kernel_matches_plain_version(cuda, n, c, b, s):
    """Counts bit-equal, weighted channels within 1e-6 of the cell's
    value, a relaunch bit-identical.  Covers the stats path's shapes (one
    block a column, writing f32 directly), few columns (rows split over
    blocks that meet in the 64-bit accumulator), column groups of several
    columns (C = 300), N not a multiple of the transpose tile or a block's
    rows, N = 1 and N = 0."""
    from shifu_tpu_torch.ops import stats_hist as sh
    idx_h, st_h, exact = _stats_inputs(n, c, b, s, seed=n + c)
    idx, st = _on(cuda, idx_h, st_h)
    before = sh.stats_histograms_cuda.launches
    got = sh.stats_histograms(idx, st, b, exact)
    again = sh.stats_histograms(idx, st, b, exact)
    torch.cuda.synchronize()
    assert sh.stats_histograms_cuda.launches == before + 2
    want = sh.stats_histograms_ref(idx, st, b)
    assert got.shape == (c, b, s) and torch.equal(got, again)
    assert torch.equal(got[..., :2], want[..., :2])
    assert bool(((got - want).abs() <= 1e-6 * want.abs() + 1e-30).all())


def test_stats_hist_kernel_never_takes_the_plain_version(cuda, monkeypatch):
    """A CUDA tensor launches the kernel (the plain version would raise
    here) and refuses what it cannot take instead of falling back."""
    from shifu_tpu_torch.ops import stats_hist as sh
    idx, st = _on(cuda, *_stats_inputs(50, 3, 64, 2, seed=1)[:2])

    def no_plain(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")
    monkeypatch.setattr(sh, "stats_histograms_ref", no_plain)
    assert sh.stats_histograms(idx, st, 64, (True, True)).shape == (3, 64, 2)
    with pytest.raises(ValueError, match="idx"):
        sh.stats_histograms(idx.long(), st, 64)
    with pytest.raises(ValueError, match="stats"):
        sh.stats_histograms(idx, st.double(), 64)
    with pytest.raises(ValueError, match="S <= 4"):
        sh.stats_histograms(idx, st.repeat(1, 3), 64)
    with pytest.raises(ValueError, match="leading run"):
        sh.stats_histograms(idx, st, 64, (False, True))


@pytest.mark.parametrize("budget", [1 << 30, 40000])
def test_numeric_accumulator_on_the_card_matches_the_cpu(cuda, budget):
    """The fused sweep (resident, and overflowing into the provisional
    grid) gives the CPU's counts, boundaries, percentiles and distinct
    counts on the card; weighted sums within 1e-6 relative."""
    from shifu_tpu_torch.config.model_config import BinningMethod
    from shifu_tpu_torch.ops.binning import NumericAccumulator
    rng = np.random.default_rng(8)
    n, c = 3000, 6
    x = rng.normal(size=(n, c)) * 5
    valid = rng.random((n, c)) > 0.05
    y = (rng.random(n) < 0.3).astype(float)
    w = rng.uniform(0.5, 2.0, n)
    out = []
    for dev in ("cpu", "cuda"):
        acc = NumericAccumulator(n_cols=c, device=dev, fused_budget=budget)
        for s in range(0, n, 1000):
            acc.update_fused(x[s:s + 1000], valid[s:s + 1000],
                             y[s:s + 1000], w[s:s + 1000])
        acc.finalize_fused()
        out.append(acc.finalize_sketch(BinningMethod.EqualPositive, 10))
    (bc, ac, pc, dc), (bg, ag, pg, dg) = out
    for j in range(c):
        assert np.array_equal(bc[j], bg[j])
        assert np.array_equal(ac[j][:, :2], ag[j][:, :2])
        assert np.allclose(ac[j], ag[j], rtol=1e-6, atol=1e-9)
    assert np.array_equal(pc, pg) and np.array_equal(dc, dg)
