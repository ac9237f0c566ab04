"""Card-only tests of the port's hand-written CUDA kernels: each kernel
(B4 ``tree_traverse``, also its node-index walk of multi-class leaves,
B1 ``hist``, B2 ``hist_batch``, B3 ``stats_hist``) against its plain
PyTorch version on the same numpy-seeded inputs (B2 also against B1 tree
by tree, for multi-class channels too, and bagged GBT members against
single runs); tree growth, Random Forest bags and the stats
accumulator on the card against the CPU; GBT and RF chunks run under
``torch.cuda.set_sync_debug_mode("error")``; the port's ``eval`` on
the card against the CPU, with its ``tree_traverse`` launch count; and
the NN trainer's stacked step on the card against the CPU, with one host
sync an epoch (the ``[2, B]`` error fetch); the raw cache served on the
card's path; the streamed NN trainer's epochs and the SE sensitivity job
on the card against the CPU; ``encode``'s node-index walk (one launch a
call, never the plain walk) against ``traverse_nodes``, and the exported
reference spec's host scores against the native forest on the card; the
WDL trainer on the card against the CPU (one host sync a minibatch
epoch), the hashed-ID buckets on the card against the host, the kernel
SVM's dual on the card against the CPU, and WDL and SVM forwards that
never leave the card; a two-replica serving fleet whose workers run on
the card, and ``stats -correlation`` on the card against the CPU; a warm
GBT refresh retrain on the card (``hist`` launched for the appended trees
alone, the restored forest bit-equal, its replay through
``tree_traverse``) and a refresh promotion whose canary replays bit for
bit through probation.

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


@pytest.mark.parametrize("n_rows", [1, 333, 65536])
@pytest.mark.parametrize("n_bins,depth,dtype", [
    (64, 7, np.uint8), (128, 5, np.uint8), (256, 6, np.uint8),
    (64, 4, np.int32), (200, 2, np.int32), (64, 14, np.uint8)])
def test_tree_traverse_packed_path_equals_plain_version(cuda, n_rows, n_bins,
                                                        depth, dtype):
    """The packed path (masks of <= 256 bins: bitsets of 2, 4 and 8 words
    a node, uint8 and int32 planes; depth 14, too large to stage, walks
    its records from L2) equals the plain version bit for bit, given the
    packed form or packing on the fly, with leaves at every depth, split
    features past the last column and bins past n_bins (C5)."""
    n_cols, n_trees = 37, 2 if depth == 14 else 24
    sf, lm, lv = _forest(n_trees, depth, n_bins, n_cols,
                         seed=n_rows + n_bins + depth)
    rng = np.random.default_rng(depth)
    inner = sf[:, :(1 << depth) - 1]
    inner[rng.random(inner.shape) < 0.05] = n_cols + 3      # clamps (C5)
    hi = n_bins + 16 if dtype == np.int32 else min(256, n_bins + 16)
    bins = rng.integers(0, hi, size=(n_rows, n_cols)).astype(dtype)
    args = _on(cuda, sf, lm, lv, bins)
    packed = tq.pack_forest(*args[:3], depth)
    want = tq.predict_forest_quant_ref(*args, depth)
    before = tq.predict_forest_quant.launches
    got = tq.predict_forest_quant(*args, depth, packed=packed)
    fly = tq.predict_forest_quant(*args, depth)
    torch.cuda.synchronize()
    assert tq.predict_forest_quant.launches == before + 2
    assert torch.equal(got, want) and torch.equal(fly, want)
    assert torch.equal(tq.forest_walk_ref(packed, args[3]), want)


def test_tree_traverse_kernel_rejects_what_it_cannot_take(cuda):
    sf, lm, lv = _on(cuda, *_forest(2, 3, 8, 4, seed=1))
    bins = torch.zeros((5, 4), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="bins"):
        tq.predict_forest_quant(sf, lm, lv, bins.long(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        tq.predict_forest_quant(sf, lm, lv, bins.t().contiguous().t(), 3)
    with pytest.raises(ValueError, match="nodes per tree"):
        tq.predict_forest_quant(sf, lm, lv, bins, 4)
    with pytest.raises(ValueError, match="multi-class leaves"):
        tq.predict_forest_quant(sf, lm, lv[:1, :, None], bins, 3)
    with pytest.raises(ValueError, match="packed forest"):
        tq.predict_forest_quant(sf, lm, lv, bins, 2, packed=tq.pack_forest(
            sf, lm, lv, 3))


@pytest.mark.parametrize("n_rows,n_bins,depth,dtype", [
    (1, 64, 7, np.uint8), (65536, 64, 14, np.uint8), (4096, 256, 5, np.uint8),
    (777, 300, 4, np.int32)])
def test_node_index_walk_equals_plain_version(cuda, n_rows, n_bins, depth,
                                              dtype):
    """Multi-class [T, K, S] leaves launch B4 once over the node-index
    forest (packed or on the fly; the wide path past 256 bins) and gather
    on the card: bit-equal to the plain version, never falling back."""
    sf, lm, _ = _forest(4, depth, n_bins, 37, seed=n_rows + depth)
    lv = np.random.default_rng(depth).random(
        (4, n_tree_nodes(depth), 3)).astype(np.float32)
    bins = np.random.default_rng(n_rows).integers(
        0, n_bins, size=(n_rows, 37)).astype(dtype)
    args = _on(cuda, sf, lm, lv, bins)
    packed = tq.pack_forest(*args[:3], depth)
    before = tq.predict_forest_quant.launches
    got = tq.predict_forest_quant(*args, depth, packed=packed)
    fly = tq.predict_forest_quant(*args, depth)
    torch.cuda.synchronize()
    assert tq.predict_forest_quant.launches == before + 2
    want = tq.predict_forest_quant_ref(*args, depth)
    assert got.shape == (4, n_rows, 3)
    assert torch.equal(got, want) and torch.equal(fly, want)


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
    assert torch.equal(got, hist.build_histograms_fixed_ref(bins, node,
                                                            stats, k, b))
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
    equals the plain version.  Covers node and bin tiling, TB = 1, S in
    {1..4}, odd column counts, K = 4096 and N = 0."""
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


#: the card cases of the redesigned B1/B2: (N, C, B, K, bin dtype)
_EDGE_CASES = {
    "one_node": (5000, 64, 64, 1, np.uint8),     # K=1, every row live
    "empty": (3000, 40, 16, 4, np.uint8),        # no live row at all
    "edge": (1024, 32, 16, 2, np.uint8),         # a channel at 2^31
    "wide": (5000, 7, 4001, 8, np.int32),        # int32 bins, 4001 bins
    "nonfinite": (2000, 33, 8, 3, np.uint8),     # NaN / inf stats
}


def _edge_inputs(case, form, tb=3, seed=0):
    """TB trees' inputs for one card case and channel form: ``exact``
    (both channels integers), ``mixed`` (integer w, float w*g) or
    ``wide`` (neither an integer)."""
    n, c, b, k, dtype = _EDGE_CASES[case]
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b, size=(n, c)).astype(dtype)
    node = rng.integers(0, k, size=(tb, n)).astype(np.int32)
    if case == "one_node":
        node[:] = 0
    elif case == "empty":
        node[:] = -1
    w = rng.integers(1, 4, size=(tb, n)).astype(np.float64)
    if form == "exact":
        other = w * (rng.random((tb, n)) < 0.3)
    else:
        other = w * rng.standard_normal((tb, n))
    if form == "wide":
        w = w + 0.5
    if case == "edge":
        # tree 0: amax * N = 2^31 - 1024 (32-bit sums), all in one cell;
        # tree 1: amax * N = 2^31 (64-bit form); N = 1024
        node[:2] = 0
        bins[:, 0] = 0
        w[0] = (1 << 21) - 1
        w[1] = rng.integers(1, 1 << 21, size=n)
        w[1, 7] = 1 << 21
    stats = np.stack([w, other], axis=2).astype(np.float32)
    if case == "nonfinite":
        stats[1, 5, 1] = np.nan
        stats[2, 9, 0] = np.inf
    return bins, node, stats


def _assert_matches_plain(got, bins, node, stats, k, b):
    """Every channel bit-equal to the plain version of the kernel's own
    fixed-point arithmetic; against the float64 plain version, integer
    channels bit-equal, other finite ones within 1e-5 of the cell's
    |stats| sum, non-finite ones all NaN."""
    from shifu_tpu_torch.ops import hist
    st = stats.cpu().numpy()
    for t in range(stats.shape[0]):
        fixed = hist.build_histograms_fixed_ref(bins, node[t], stats[t], k,
                                                b)
        assert torch.equal(got[t].nan_to_num(), fixed.nan_to_num()), t
        assert torch.equal(got[t].isnan(), fixed.isnan()), t
        want = hist.build_histograms_ref(bins, node[t], stats[t], k, b)
        scale = hist.build_histograms_ref(bins, node[t], stats[t].abs(), k,
                                          b)
        for s in range(stats.shape[2]):
            col = st[t, :, s]
            g, w_ = got[t, ..., s], want[..., s]
            if not np.isfinite(col).all():
                assert bool(torch.isnan(g).all()), (t, s)
            elif (col == np.trunc(col)).all():
                assert torch.equal(g, w_), (t, s)
            else:
                assert bool(((g - w_).abs() <= 1e-5 * scale[..., s]).all())


@pytest.mark.parametrize("case", sorted(_EDGE_CASES))
@pytest.mark.parametrize("form", ["exact", "mixed", "wide"])
@pytest.mark.parametrize("rows", ["few", "many"])
def test_hist_channel_forms_and_edges(cuda, rows, form, case):
    """On 32-bit, mixed and 64-bit channels, at K=1 with every row in one
    node, an empty level, a channel at the 2^31 edge, int32 bins of 4001
    bins and non-finite stats, with few rows (<= 1024: one block an output
    tile, which writes f32 itself) and with 32x the rows (several blocks a
    tile adding into the global accumulator, where the tiles leave room):
    B2 == the plain versions (bit-equal to the fixed-point one on every
    channel, to the float64 one on integer channels), == B1 tree by tree,
    and the same bits on a second launch."""
    from shifu_tpu_torch.ops import hist
    n, c, b, k, dtype = _EDGE_CASES[case]
    bins, node, stats = _on(cuda, *_edge_inputs(case, form))
    if rows == "few":
        n = min(n, 1024)
        bins, node, stats = bins[:n], node[:, :n], stats[:, :n]
        node, stats = node.contiguous(), stats.contiguous()
    else:
        bins, node, stats = (bins.repeat(32, 1), node.repeat(1, 32),
                             stats.repeat(1, 32, 1))
        n *= 32
    direct = hist.hist_plan(n, c, 3, k, b, 2,
                            np.dtype(dtype).itemsize)["direct"]
    assert direct or rows == "many"
    got = hist.build_histograms_batch_cuda(bins, node, stats, k, b)
    again = hist.build_histograms_batch_cuda(bins, node, stats, k, b)
    torch.cuda.synchronize()
    assert got.shape == (3, k, c, b, 2)
    assert torch.equal(got.nan_to_num(), again.nan_to_num())
    assert torch.equal(got.isnan(), again.isnan())
    _assert_matches_plain(got, bins, node, stats, k, b)
    for t in range(3):
        one = hist.build_histograms_cuda(bins, node[t], stats[t], k, b)
        assert torch.equal(got[t].nan_to_num(), one.nan_to_num()), t
        assert torch.equal(got[t].isnan(), one.isnan()), t
    if case == "edge" and rows == "few":       # 2^31 - 1024 in one cell
        assert got[0, 0, 0, 0, 0].item() == float((1 << 31) - 1024)


def test_channel_meta_on_the_card_matches_numpy(cuda):
    """The 32-bit flag: integers (negative ones too) whose max |value|
    times N stays under 2^31; a fraction, the 2^31 edge, NaN or inf
    clear it; an empty channel keeps it."""
    from shifu_tpu_torch.ops.hist import channel_meta
    n = 1024
    cols = np.stack([np.arange(n) % 7 - 3.0,             # negative ints
                     np.full(n, 0.5),                     # a fraction
                     np.full(n, float((1 << 21) - 1)),    # just under
                     np.full(n, float(1 << 21)),          # at 2^31
                     np.r_[np.zeros(n - 1), np.nan],
                     np.r_[np.zeros(n - 1), -np.inf],
                     np.zeros(n)], axis=1).astype(np.float32)
    amax, exact = channel_meta(torch.from_numpy(cols[None]).to(cuda), n)
    assert exact.cpu().numpy().tolist() == [[1, 0, 1, 0, 0, 0, 1]]
    np.testing.assert_array_equal(amax.cpu().numpy()[0],
                                  np.abs(cols).max(axis=0))
    amax, exact = channel_meta(torch.zeros((2, 0, 3), device=cuda), 0)
    assert bool((exact == 1).all()) and bool((amax == 0).all())


@pytest.mark.parametrize("k", [4, 16384])
def test_leaf_sums_on_the_card_match_the_plain_version(cuda, k):
    """The leaf-sum level through B1 (one all-zero column of one bin):
    equal to the CPU's float64 matmul for integer stats, within one f32
    ulp otherwise, the same bits from run to run, one B1 launch a call."""
    from shifu_tpu_torch.ops import tree as tt
    rng = np.random.default_rng(k)
    n = 60000
    node = rng.integers(0, k, size=n).astype(np.int32)
    node[rng.random(n) < 0.2] = -1
    w = rng.poisson(1.0, size=n).astype(np.float32)
    for stats in (np.stack([w, w * (rng.random(n) < 0.4)], axis=1),
                  np.stack([w, w * rng.standard_normal(n)], axis=1)):
        stats = stats.astype(np.float32)
        want = tt._level_leaf_raw(torch.from_numpy(stats),
                                  torch.from_numpy(node), k).numpy()
        before = tt.build_histograms.launches
        leaf_before = tt._leaf_raw_hist.launches
        st, nd = _on(cuda, stats, node)
        got = tt._level_leaf_raw(st, nd, k)
        again = tt._level_leaf_raw(st, nd, k)
        assert tt.build_histograms.launches == before + 2
        assert tt._leaf_raw_hist.launches == leaf_before + 2
        assert torch.equal(got, again)
        got = got.cpu().numpy()
        assert got.shape == (2, k) and got.dtype == np.float32
        np.testing.assert_array_equal(got[0], want[0])        # integers
        if (stats[:, 1] == np.trunc(stats[:, 1])).all():
            np.testing.assert_array_equal(got[1], want[1])
        else:
            assert np.all(np.abs(got[1] - want[1])
                          <= np.spacing(np.abs(want[1])))


def test_hist_parts_skip_without_fault(cuda):
    """Every stop a timing run uses (``launch_until``) launches cleanly,
    for TB trees and for one (B1), and leaves the production launch's
    bits as they were; a stop past the adds is refused."""
    from shifu_tpu_torch.ops import hist
    bins, node, stats = _on(cuda, *_batch_inputs(20000, 64, 64, 32, 2, 2,
                                                 np.uint8, 3))
    full = hist.build_histograms_batch_cuda(bins, node, stats, 32, 64)
    for nb, sb in ((node, stats), (node[:1], stats[:1])):
        for stop in (hist.SETUP, hist.WALK, hist.ADDS):
            out = hist.launch_until(bins, nb, sb, 32, 64, stop)
            torch.cuda.synchronize()
            assert out.shape == (nb.shape[0], 32, 64, 64, 2)
    assert torch.equal(full, hist.build_histograms_batch_cuda(
        bins, node, stats, 32, 64))
    with pytest.raises(ValueError, match="stop"):
        hist.launch_until(bins, node, stats, 32, 64, 3)


@pytest.mark.parametrize("c,vec", [(64, 2), (256, 2), (16, 1)])
def test_hist_kernel_takes_an_offset_plane_only_where_aligned(cuda, c, vec):
    """A uint8 plane that is a view at an odd byte offset: refused where
    the plan loads V > 1 bin ids at once, launched where V = 1, and a
    view at a V-aligned offset gives the bits of a fresh copy."""
    from shifu_tpu_torch.ops import hist
    n, b, k = 3000, 64, 4
    assert hist.hist_plan(n, c, 1, k, b, 2)["vec"] == vec
    bins, node, stats = _hist_inputs(n, c, b, k, 2, np.uint8, 9)
    flat = torch.zeros(n * c + 2 * vec, dtype=torch.uint8, device=cuda)
    node, stats = _on(cuda, node, stats)
    want = hist.build_histograms_cuda(_on(cuda, bins)[0], node, stats, k, b)
    for off in (1, vec):
        view = flat[off:off + n * c].view(n, c)
        view.copy_(torch.from_numpy(bins).to(cuda))
        if off % vec:
            with pytest.raises(ValueError, match="byte boundary"):
                hist.build_histograms_cuda(view, node, stats, k, b)
        else:
            assert torch.equal(hist.build_histograms_cuda(
                view, node, stats, k, b), want)


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


def test_multiclass_forest_on_the_card_equals_grow_tree(cuda):
    """Native multi-class channels (S = 3): grow_forest on B2 equals
    grow_tree on B1 tree by tree, and the CPU's splits."""
    from shifu_tpu_torch.ops import tree as tt
    rng = np.random.default_rng(12)
    n, c = 20000, 16
    y = rng.integers(0, 3, n)
    bins = rng.integers(0, 32, size=(n, c)).astype(np.uint8)
    bins[:, 4] = np.where(rng.random(n) < 0.7, y * 10, bins[:, 4])
    bag = rng.poisson(1.0, size=(3, n)).astype(np.float32)
    stats = bag[:, :, None] * np.eye(3, dtype=np.float32)[y]
    fa = rng.random((3, c)) < 0.8
    fa[:, 4] = True
    cat = np.zeros(c, bool)
    cat[9] = True
    b, st, ct, f = _on(cuda, bins, stats, cat, fa)
    forest = tt.grow_forest(b, st, ct, f, 32, 6, "entropy", 1.0, 1e-3,
                            n_classes=3)
    for t in range(3):
        one = tt.grow_tree(b, st[t], ct, f[t], 32, 6, "entropy", 1.0, 1e-3,
                           n_classes=3)
        for x, z in zip(forest[t], one):
            assert torch.equal(x, z), t
    cpu = tt.grow_tree(*_on(torch.device("cpu"), bins, stats[0], cat, fa[0]),
                       32, 6, "entropy", 1.0, 1e-3, n_classes=3)
    assert torch.equal(forest[0][0].cpu(), cpu[0])
    assert torch.allclose(forest[0][2].cpu(), cpu[2], rtol=1e-5, atol=1e-6)


def test_bagged_gbt_on_the_card_equals_single_runs(cuda):
    """Three bagged GBT members boost side by side: one B2 launch a level
    with TB = 3 (and B1 for the leaf sums only), each member bit-identical
    to ``train_gbt`` on its weights on the card."""
    from dataclasses import replace
    from shifu_tpu_torch.ops import tree as tt
    from shifu_tpu_torch.train import dt_trainer as dt
    from shifu_tpu_torch.train.sampling import validation_split
    rng = np.random.default_rng(13)
    n, c = 50000, 24
    bins = rng.integers(0, 64, size=(n, c)).astype(np.uint8)
    logit = 1.5 * (bins[:, 3] > 40) - (bins[:, 11] < 10)
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    w = rng.integers(1, 4, size=n).astype(np.float32)
    cat = np.zeros(c, bool)
    cat[5] = True
    s = dt.DTSettings(n_trees=4, depth=5, loss="log", learning_rate=0.1,
                      feature_subset="HALF")
    members = [replace(s, seed=b) for b in range(3)]
    vm = [validation_split(n, s.valid_rate, m.seed) for m in members]
    tw, vw = np.stack([w * ~v for v in vm]), np.stack([w * v for v in vm])
    batch, single = (tt.build_histograms_batch.launches,
                     tt.build_histograms.launches)
    bagged = dt.train_gbt_bagged(bins, y, tw, vw, 64, cat, members,
                                 device=cuda)
    assert tt.build_histograms_batch.launches == batch + 4 * 5
    assert tt.build_histograms.launches == single + 4 * 3
    for m, rb in zip(members, bagged):
        r1 = dt.train_gbt(bins, y, w, 64, cat, m, device=cuda)
        for a, b in zip(r1.trees, rb.trees):
            assert a.split_feat.tobytes() == b.split_feat.tobytes()
            assert a.left_mask.tobytes() == b.left_mask.tobytes()
            assert a.leaf_value.tobytes() == b.leaf_value.tobytes()
        assert rb.history == r1.history


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
    # B1: the batch's 8 leaf-sum levels, and 2 trees x (6 levels + leaves)
    assert tt.build_histograms.launches == single + 8 + 2 * 7
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


@pytest.mark.parametrize("n,c,b,s,n_exact", [
    (1, 1, 64, 1, 1), (1, 9, 4096, 4, 2), (5000, 1, 4096, 1, 0),
    (4097, 9, 4096, 3, 1), (30000, 13, 64, 4, 2), (20000, 227, 4096, 4, 2),
    (20000, 17, 4096, 4, 0), (9000, 6, 4096, 2, 2), (65536, 30, 64, 2, 0)])
def test_stats_hist_kernel_edges(cuda, n, c, b, s, n_exact):
    """The cluster design at its edges: C of 1 and not a multiple of the
    cluster's 8 columns, N = 1, a column with every cell missing and one
    with ids past B, B = 64 and 4096, S = 1 to 4 with 0 to 2 count
    channels (one or two columns a CTA), rows split over clusters.  Count
    channels bit-equal, weighted ones within 1e-6 of the cell's value, a
    relaunch bit-identical."""
    from shifu_tpu_torch.ops import stats_hist as sh
    rng = np.random.default_rng(n + c + s)
    idx_h = rng.integers(0, b, size=(n, c)).astype(np.int32)
    idx_h[rng.random((n, c)) < 0.05] = -1
    idx_h[:, 0] = -1                                  # all missing
    if c > 2:
        idx_h[::3, 2] = b + 7                         # past B: nowhere
    st_h = np.stack([rng.integers(0, 3, n).astype(np.float32)
                     if k < n_exact else
                     rng.uniform(-2.0, 3.0, n).astype(np.float32)
                     for k in range(s)], axis=1)
    exact = (True,) * n_exact + (False,) * (s - n_exact)
    idx, st = _on(cuda, idx_h, st_h)
    got = sh.stats_histograms(idx, st, b, exact)
    again = sh.stats_histograms(idx, st, b, exact)
    torch.cuda.synchronize()
    want = sh.stats_histograms_ref(idx, st, b)
    assert got.shape == (c, b, s) and torch.equal(got, again)
    assert torch.equal(got[..., :n_exact], want[..., :n_exact])
    assert bool(((got - want).abs() <= 1e-6 * want.abs() + 1e-30).all())
    assert not bool(got[0].any())


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


@pytest.fixture
def fraud_set(tmp_path, monkeypatch):
    """``new → init → stats → norm → train`` of the port alone over the
    fraud-style CSV of ``examples/make_fraud_data.py`` (4,000 rows, GBT of
    5 depth-4 trees on the card), read in chunks of 1,000 rows."""
    import importlib.util
    import os

    from shifu_tpu_torch import cli
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    from shifu_tpu_torch.data import parsepool
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "make_fraud_data", os.path.join(here, "..", "examples",
                                        "make_fraud_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    csv_path = mod.make(str(tmp_path / "data"), n=4000)
    monkeypatch.setattr(parsepool, "CHUNK_ROWS", 1000)
    assert cli.main(["--dir", str(tmp_path), "new", "fraud"]) == 0
    d = str(tmp_path / "fraud")
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    ds = mc.dataSet
    ds.dataPath, ds.dataDelimiter, ds.targetColumnName = csv_path, "|", "tag"
    ds.posTags, ds.negTags, ds.weightColumnName = ["bad"], ["good"], "weight"
    mc.evals[0].dataSet.dataPath = csv_path
    mc.train.algorithm = Algorithm.GBT
    mc.train.params = {"TreeNum": 5, "MaxDepth": 4, "Loss": "log",
                       "LearningRate": 0.1}
    mc.save(os.path.join(d, "ModelConfig.json"))
    for argv in (["init"], ["stats"], ["norm"], ["train"]):
        assert cli.main(["--dir", d, *argv]) == 0, argv
    return d


def test_eval_on_the_card_matches_the_cpu(cuda, fraud_set, tmp_path):
    """``eval -run`` on the card launches ``tree_traverse`` once per model
    per chunk (none on the CPU) and gives the CPU's scores (within 1e-3 on
    the 0-1000 scale after the %.3f score file) and AUC (within 1e-6)."""
    import csv
    import json
    import os
    import shutil

    from shifu_tpu_torch import cli
    cpu_set = str(tmp_path / "cpu")
    shutil.copytree(fraud_set, cpu_set)
    # 1 model x 5 chunks: the file's header line shortens the first
    # 1,000-row chunk by one (pandas' chunking), so a fifth holds one row
    before = tq.predict_forest_quant.launches
    assert cli.main(["--dir", fraud_set, "eval", "-run"]) == 0
    assert tq.predict_forest_quant.launches - before == 5
    assert cli.main(["--dir", cpu_set, "eval", "-run", "--device",
                     "cpu"]) == 0
    assert tq.predict_forest_quant.launches - before == 5
    out = []
    for d in (fraud_set, cpu_set):
        ev = os.path.join(d, "evals", "Eval1")
        with open(os.path.join(ev, "EvalScore")) as f:
            rows = list(csv.reader(f, delimiter="|"))[1:]
        with open(os.path.join(ev, "EvalPerformance.json")) as f:
            out.append((np.asarray(rows, dtype=object), json.load(f)))
    (card, pc), (cpu, pp) = out
    assert len(card) == len(cpu) == 4000
    np.testing.assert_array_equal(card[:, :2], cpu[:, :2])
    diff = np.abs(card[:, 2:].astype(float) - cpu[:, 2:].astype(float))
    assert diff.max() <= 1e-3 + 1e-9
    assert abs(pc["areaUnderRoc"] - pp["areaUnderRoc"]) <= 1e-6
    assert pc["areaUnderRoc"] > 0.8


def _nn_plane(seed=0, n=2048, d=16, bags=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x[:, 0] - x[:, 1] + rng.normal(size=n) * 0.5 > 0).astype(
        np.float32)
    w = rng.integers(1, 4, n).astype(np.float32)
    valid = rng.random(n) < 0.2
    tw = np.stack([(rng.random(n) < 0.9) * ~valid * w
                   for _ in range(bags)]).astype(np.float32)
    vw = np.tile(valid * w, (bags, 1)).astype(np.float32)
    return x, y, tw, vw


@pytest.mark.parametrize("settings", [
    dict(optimizer="R"),
    dict(optimizer="ADAM", learning_rate=0.01, batch_size=256)])
def test_nn_stacked_step_on_the_card_matches_the_cpu(cuda, settings):
    """Three members from carried weights: per-epoch errors and weights
    within rtol 1e-5 (true f32 GEMMs on both, summed in another order)."""
    from shifu_tpu_torch.models import nn as nn_model
    from shifu_tpu_torch.ops import prng
    from shifu_tpu_torch.train.nn_trainer import (TrainSettings,
                                                  train_ensemble)
    x, y, tw, vw = _nn_plane()
    spec = nn_model.NNModelSpec(input_dim=16, hidden_nodes=[20, 10],
                                activations=["tanh"])
    init = [nn_model.init_params(k, spec) for k in
            prng.split(prng.prng_key(5), 3)]
    runs = [train_ensemble(x, y, tw, vw, spec,
                           TrainSettings(epochs=4, **settings),
                           init_params_list=init, device=dev)
            for dev in ("cpu", cuda)]
    np.testing.assert_allclose(np.array(runs[1].history),
                               np.array(runs[0].history), rtol=1e-5)
    for a, b in zip(runs[0].params, runs[1].params):
        for la, lb in zip(a, b):
            for k in ("w", "b"):
                np.testing.assert_allclose(lb[k].numpy(), la[k].numpy(),
                                           rtol=1e-5, atol=1e-6)


def test_nn_full_batch_epoch_makes_one_host_sync(cuda):
    """An epoch's only host sync is the [2, B] error fetch: runs of 3 and
    2 epochs differ by exactly one synchronizing operation."""
    import warnings

    from shifu_tpu_torch.models import nn as nn_model
    from shifu_tpu_torch.train.nn_trainer import (TrainSettings,
                                                  train_ensemble)
    x, y, tw, vw = _nn_plane()
    spec = nn_model.NNModelSpec(input_dim=16, hidden_nodes=[20, 10],
                                activations=["tanh"])

    def syncs(epochs):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                train_ensemble(x, y, tw, vw, spec,
                               TrainSettings(epochs=epochs), device=cuda)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return sum("synchroniz" in str(w.message) for w in seen)
    assert syncs(3) - syncs(2) == 1


# ------------------------------------------------------------ streaming
def _stream_shards(d, n=4096, c=16, b=64, seed=12, shard_rows=1000):
    """npz shards of a plane with a learnable target (the out-of-core
    trainers' input) and its schema."""
    import json
    import os
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b, size=(n, c)).astype(np.uint8)
    logit = (bins[:, 0].astype(np.float32) - 32) / 10 + (bins[:, 3] < 8)
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    w = rng.integers(1, 4, size=n).astype(np.float32)
    os.makedirs(d, exist_ok=True)
    for i, s in enumerate(range(0, n, shard_rows)):
        np.savez(os.path.join(d, f"part-{i:05d}.npz"),
                 bins=bins[s:s + shard_rows], y=y[s:s + shard_rows],
                 w=w[s:s + shard_rows])
    with open(os.path.join(d, "schema.json"), "w") as f:
        json.dump({"columnNums": list(range(c)), "numRows": n}, f)
    return d


_STREAM_WIN = 512
_GBT_WIN_BYTES = _STREAM_WIN * (16 + 12)       # u8 bins, y/tw/vw f32


def _streamed_gbt(d, device, c2f, prefetch=None, budget=None, trees=4):
    import os
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.data.streaming import ShardStream
    from shifu_tpu_torch.train import dt_trainer as dt
    old = os.environ.get("SHIFU_TREE_TAIL_C2F")
    os.environ["SHIFU_TREE_TAIL_C2F"] = c2f
    try:
        return dt.train_gbt_streamed(
            ShardStream(Shards.open(d), ("bins", "y", "w"), _STREAM_WIN,
                        prefetch=prefetch), 64, None,
            dt.DTSettings(n_trees=trees, depth=5, loss="log",
                          learning_rate=0.1),
            cache_budget=5 * _GBT_WIN_BYTES + 100 if budget is None
            else budget, device=device)
    finally:
        if old is None:
            os.environ.pop("SHIFU_TREE_TAIL_C2F")
        else:
            os.environ["SHIFU_TREE_TAIL_C2F"] = old


def _same_forest(a, b):
    return len(a.trees) == len(b.trees) and all(
        getattr(x, k).tobytes() == getattr(y, k).tobytes()
        for x, y in zip(a.trees, b.trees)
        for k in ("split_feat", "left_mask", "leaf_value"))


def test_streamed_c2f_is_the_exact_forest_on_the_card(cuda, tmp_path):
    """5 of 8 windows resident, 3 on the disk tail: coarse-to-fine (B2 at
    TB = depth a tail window) grows the exact schedule's forest (B1 a
    level a window) bit for bit, in fewer tail sweeps; both launch on the
    card.  Against the CPU's exact run: the same tail sweeps and levels
    0-1 split alike (deeper nodes of this plane split on noise columns
    whose gains tie within the sums' last bits, C4)."""
    from shifu_tpu_torch.ops import tree as tt
    d = _stream_shards(str(tmp_path / "s"))
    b1, b2 = tt.build_histograms.launches, tt.build_histograms_batch.launches
    c2f = _streamed_gbt(d, cuda, "1")
    assert tt.build_histograms_batch.launches > b2
    exact = _streamed_gbt(d, cuda, "0")
    assert tt.build_histograms.launches > b1
    assert _same_forest(c2f, exact)
    assert c2f.history == exact.history
    assert exact.tail_sweeps == 4 * (5 + 2) > c2f.tail_sweeps
    cpu = _streamed_gbt(d, torch.device("cpu"), "0")
    assert cpu.tail_sweeps == exact.tail_sweeps
    for a, b in zip(exact.trees, cpu.trees):
        np.testing.assert_array_equal(a.split_feat[:3], b.split_feat[:3])
        np.testing.assert_array_equal(a.left_mask[:3], b.left_mask[:3])


def test_tail_windows_are_not_reused_while_a_launch_reads_them(cuda,
                                                               tmp_path):
    """Every window on the tail (a 0-byte device cache): prepared inline
    (prefetch 0) and two windows ahead on the copy stream (prefetch 2),
    the exact schedule grows the same forest bit for bit — the consumer
    waits on each window's copy event and ``record_stream`` keeps the
    allocator from handing a window's memory to the next copy while a
    kernel still reads it."""
    d = _stream_shards(str(tmp_path / "s"), n=8192)
    inline = _streamed_gbt(d, cuda, "0", prefetch=0, budget=0, trees=3)
    ahead = _streamed_gbt(d, cuda, "0", prefetch=2, budget=0, trees=3)
    assert inline.tail_sweeps == ahead.tail_sweeps == 3 * (5 + 2)
    assert _same_forest(inline, ahead)
    assert inline.history == ahead.history


def test_resident_windows_stay_on_the_card_and_a_level_makes_no_sync(
        cuda, tmp_path):
    """Resident windows keep their device tensors across sweeps (the same
    storage every sweep), and a resident level (node routing, B1 over the
    window, the level step) runs with no host sync."""
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.data.streaming import ResidentCache, ShardStream
    from shifu_tpu_torch.ops.tree import n_tree_nodes
    from shifu_tpu_torch.train import dt_trainer as dt
    d = _stream_shards(str(tmp_path / "s"))
    stream = ShardStream(Shards.open(d), ("bins", "y", "w"), _STREAM_WIN)
    cache = ResidentCache(stream, 5 * _GBT_WIN_BYTES + 100, dt._gbt_prepare(
        dt._WindowCopier(cuda), 0.2, 0, 64))
    first = [(it.resident, it.arrays["bins"].data_ptr())
             for it in cache.items()]
    again = [(it.resident, it.arrays["bins"].data_ptr())
             for it in cache.items()]
    assert [r for r, _ in first] == [True] * 5 + [False] * 3
    assert again[:5] == first[:5]
    it = cache.cached[0]
    assert all(t.is_cuda for t in it.arrays.values())
    total = n_tree_nodes(5)
    sf, lm, lv = dt._blank_tree(total, 64, cuda)
    sf[0] = 0
    lm[0, :32] = True
    f = torch.zeros(_STREAM_WIN, device=cuda)
    cat = torch.zeros(16, dtype=torch.bool, device=cuda)
    fa = torch.ones(16, dtype=torch.bool, device=cuda)
    hist = torch.zeros((1, 16, 64, 2), device=cuda)
    args = (it.arrays["bins"], it.arrays["y"], it.arrays["tw"], f, sf, lm)
    dt._gbt_window_hist(hist, *args, 1, 64, 1, "log", True)   # warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hl = dt._gbt_window_hist(hist, *args, 1, 64, 1, "log", True)
        full = dt._gbt_window_hist(torch.zeros((1, 16, 64, 2), device=cuda),
                                   *args, 1, 64, 0, "log", False)
        level = dt._derive_level(full, hl, sf[:1])
        dt._tree_level_step(level, cat, fa, "variance", 1.0, 0.0, False, 1,
                            5, 0, sf, lm, lv,
                            torch.ones((), dtype=torch.int32, device=cuda),
                            torch.zeros(16, device=cuda))
        dt._gbt_window_update(torch.zeros(4, device=cuda), *args[:3],
                              it.arrays["vw"], f, sf, lm, lv, 0.1, 5, "log")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert level.shape == (2, 16, 64, 2) and level.is_cuda


def test_device_bags_on_the_card_are_the_host_stream(cuda):
    from shifu_tpu_torch.data.streaming import _hash_poisson, row_uniform
    from shifu_tpu_torch.ops.hashing import hash_poisson_device
    idx = np.concatenate([np.arange(0, 50_000),
                          np.arange(2 ** 31 - 5000, 2 ** 31 + 5000),
                          np.arange(2 ** 32 - 5000, 2 ** 32 + 5000)])
    for lam, stream in ((1.0, 5003), (0.63, 1001)):
        got = hash_poisson_device(torch.from_numpy(idx).to(cuda), 7, stream,
                                  lam).cpu().numpy()
        np.testing.assert_array_equal(
            got, _hash_poisson(lam, row_uniform(7, stream, idx)))


def test_raw_cache_serves_norm_and_eval_on_the_card(cuda, fraud_set):
    """``stats`` on the card wrote ``tmp/RawCache``; ``norm`` after it is
    served from it.  The eval set names no weight column, so its rows key
    a cache of their own: the first ``eval -run`` writes it (a miss) and
    the second is served."""
    import os

    from shifu_tpu_torch import cli
    from shifu_tpu_torch.data import parsepool

    def passes(*argv):
        before = dict(parsepool.cache_passes)
        assert cli.main(["--dir", fraud_set, *argv]) == 0
        return [parsepool.cache_passes[k] - before[k]
                for k in ("hits", "misses")]
    (key,) = os.listdir(os.path.join(fraud_set, "tmp", "RawCache"))
    assert os.path.isfile(os.path.join(fraud_set, "tmp", "RawCache", key,
                                       "manifest.json"))
    assert passes("norm") == [1, 0]
    assert passes("eval", "-run") == [0, 1]
    assert passes("eval", "-run") == [1, 0]
    assert len(os.listdir(os.path.join(fraud_set, "tmp", "RawCache"))) == 2


def _norm_plane(d, n=3000, dim=16, shard_rows=1000, seed=3):
    import os

    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.ioutil import atomic_savez, atomic_write_json
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    y = (x[:, 0] - x[:, 1] + rng.normal(size=n) * 0.5 > 0).astype(
        np.float32)
    w = rng.integers(1, 4, n).astype(np.float32)
    os.makedirs(d)
    for i, s in enumerate(range(0, n, shard_rows)):
        atomic_savez(os.path.join(d, f"part-{i:05d}.npz"),
                     x=x[s:s + shard_rows], y=y[s:s + shard_rows],
                     w=w[s:s + shard_rows])
    atomic_write_json(os.path.join(d, "schema.json"), {
        "outputNames": [f"f{i}" for i in range(dim)],
        "columnNums": list(range(dim)), "numRows": n})
    return Shards.open(d)


@pytest.mark.parametrize("settings", [
    dict(optimizer="R"),
    dict(optimizer="ADAM", learning_rate=0.01, batch_size=256,
         dropout_rate=0.1)])
def test_streamed_nn_on_the_card_matches_the_cpu(cuda, tmp_path, settings):
    """Three members over 3,000 rows in windows of 1,024 (a padded tail):
    per-epoch errors and final weights within rtol 1e-4."""
    from shifu_tpu_torch.data.streaming import (ShardStream,
                                                mask_fn_from_settings)
    from shifu_tpu_torch.models import nn as nn_model
    from shifu_tpu_torch.train.nn_trainer import (TrainSettings,
                                                  train_ensemble_streamed)
    shards = _norm_plane(str(tmp_path / "plane"))
    spec = nn_model.NNModelSpec(input_dim=16, hidden_nodes=[12],
                                activations=["tanh"], loss="log")
    st = TrainSettings(epochs=5, seed=1, **settings)
    mask_fn = mask_fn_from_settings(3, valid_rate=0.2, sample_rate=0.8)
    res = [train_ensemble_streamed(
        ShardStream(shards, ("x", "y", "w"), 1024,
                    remainder_multiple=0 if st.batch_size else 1),
        spec, st, 3, mask_fn, device=dev) for dev in (cuda, "cpu")]
    np.testing.assert_allclose(np.array(res[0].history),
                               np.array(res[1].history), rtol=1e-4)
    for pc, pg in zip(res[1].params, res[0].params):
        for lc, lg in zip(pc, pg):
            for k in ("w", "b"):
                np.testing.assert_allclose(lg[k].numpy(), lc[k].numpy(),
                                           rtol=1e-4, atol=1e-5)


def test_sensitivity_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The streamed SE job (windows of 1,024 over 3,000 rows, mask batch
    5) gives the CPU's frozen and base MSEs within rtol 1e-5."""
    from shifu_tpu_torch.data.streaming import ShardStream
    from shifu_tpu_torch.models import nn as nn_model
    from shifu_tpu_torch.ops import prng
    from shifu_tpu_torch.ops import sensitivity as sens
    shards = _norm_plane(str(tmp_path / "plane"))
    spec = nn_model.NNModelSpec(input_dim=16, hidden_nodes=[8, 4],
                                activations=["tanh", "relu"])
    params = nn_model.init_params(prng.prng_key(0), spec)
    masks = sens.mask_matrix(16, [[i] for i in range(14)] + [[14, 15]])
    out = [sens.streamed_sensitivity(
        ShardStream(shards, ("x", "y"), 1024), spec, params, masks,
        mask_batch=5, device=dev) for dev in (cuda, "cpu")]
    assert out[0][2] == out[1][2] == 3000
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5)
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=1e-5)


@pytest.mark.parametrize("depth,n_bins,dtype", [
    (7, 64, np.uint8), (14, 64, np.uint8), (7, 300, np.int32)])
def test_encode_node_index_walk_on_the_card_equals_traverse_nodes(
        cuda, depth, n_bins, dtype):
    """``encode``'s walk on the card (one ``tree_traverse`` launch a call
    for the whole forest) gives ``traverse_nodes``' global node ids for
    every tree; at depth 14 ids reach 32,766, exact in f32."""
    from shifu_tpu_torch.models.tree import IndependentTreeModel, \
        TreeModelSpec
    from shifu_tpu_torch.ops.tree import TreeArrays, traverse_nodes
    from shifu_tpu_torch.pipeline.encode import leaf_indices
    sf, lm, lv = _forest(6, depth, n_bins, 19, seed=depth)
    trees = [TreeArrays(sf[i], lm[i].astype(bool), lv[i], depth)
             for i in range(len(sf))]
    model = IndependentTreeModel(TreeModelSpec("RF", len(trees), depth,
                                               n_bins), trees)
    bins = np.random.default_rng(depth).integers(
        0, n_bins, size=(65536, 19)).astype(dtype)
    before = tq.predict_forest_quant.launches
    got = leaf_indices(model, torch.from_numpy(bins).to(cuda))
    torch.cuda.synchronize()
    assert tq.predict_forest_quant.launches == before + 1
    b = torch.from_numpy(bins.astype(np.int32))
    want = torch.stack([traverse_nodes(torch.from_numpy(t.split_feat),
                                       torch.from_numpy(t.left_mask), b,
                                       depth) for t in trees])
    assert torch.equal(got.cpu(), want)
    if depth == 14:
        assert int(want.max()) > 16384


def test_encode_cuda_bins_never_reach_the_plain_walk(cuda, monkeypatch):
    from shifu_tpu_torch.models.tree import IndependentTreeModel, \
        TreeModelSpec
    from shifu_tpu_torch.ops.tree import TreeArrays
    from shifu_tpu_torch.pipeline import encode

    def refuse(*a, **k):
        raise AssertionError("a CUDA bin plane reached the plain walk")
    monkeypatch.setattr(encode, "traverse_nodes", refuse)
    monkeypatch.setattr(tq, "predict_forest_quant_ref", refuse)
    sf, lm, lv = _forest(3, 5, 32, 7, seed=1)
    model = IndependentTreeModel(
        TreeModelSpec("GBT", 3, 5, 32),
        [TreeArrays(sf[i], lm[i].astype(bool), lv[i], 5) for i in range(3)])
    bins = torch.randint(0, 32, (1000, 7), dtype=torch.uint8, device=cuda)
    assert encode.leaf_indices(model, bins).shape == (3, 1000)


def test_spec_round_trip_on_the_card_matches_the_host_scorer(cuda,
                                                             fraud_set):
    """``export -t spec``'s ``model0.gbt`` re-read by
    ``load_reference_tree``: its float64 host scores equal the native
    forest scored through ``tree_traverse`` on the card within rtol 1e-5
    / atol 1e-6 on rows with every numeric present."""
    import os

    from shifu_tpu_torch import cli
    from shifu_tpu_torch.config import ModelConfig, load_column_configs
    from shifu_tpu_torch.data.reader import DataSource
    from shifu_tpu_torch.data.transform import DatasetTransformer
    from shifu_tpu_torch.models.reference_import import load_reference_tree
    from shifu_tpu_torch.models.tree import IndependentTreeModel
    assert cli.main(["--dir", fraud_set, "export", "-t", "spec"]) == 0
    ref = load_reference_tree(os.path.join(fraud_set, "export",
                                           "reference", "model0.gbt"))
    native = IndependentTreeModel.load(os.path.join(fraud_set, "models",
                                                    "model0.gbt"))
    mc = ModelConfig.load(os.path.join(fraud_set, "ModelConfig.json"))
    ccs = load_column_configs(os.path.join(fraud_set, "ColumnConfig.json"))
    chunks = list(DataSource(mc.dataSet.dataPath,
                             mc.dataSet.dataDelimiter).iter_chunks())
    tf = DatasetTransformer(mc, ccs)
    by_num = {cc.columnNum: cc for cc in ccs}
    scores, host = [], []
    for chunk in chunks:
        tc = tf.transform(chunk)
        before = tq.predict_forest_quant.launches
        scores.append(native.compute(tc.bins, device=cuda)[:, 0])
        assert tq.predict_forest_quant.launches == before + 1
        raw, missing = {}, np.zeros(tc.n, bool)
        for j, num in enumerate(native.spec.column_nums):
            cc = by_num[num]
            if cc.is_categorical():
                raw[num] = tc.bins[:, j].astype(np.float64)
            else:
                v = np.array([float(x) if str(x).strip() not in ("", "NA")
                              else np.nan for x in chunk.col(cc.columnName)])
                raw[num] = v
                missing |= ~np.isfinite(v)
        host.append((1.0 / (1.0 + np.exp(-ref.compute(raw))), ~missing))
    got = np.concatenate(scores)
    want = np.concatenate([h for h, _ in host])
    ok = np.concatenate([m for _, m in host])
    assert ok.sum() > 1000
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ WDL and SVM
def _wdl_planes(n=1500, seed=21):
    rng = np.random.default_rng(seed)
    cards = [6, 33, 400]
    xn = rng.normal(size=(n, 5)).astype(np.float32)
    xc = np.stack([rng.integers(0, c, n) for c in cards],
                  axis=1).astype(np.int32)
    logit = xn[:, 0] + (xc[:, 1] % 4 == 0) - 0.5
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    w = rng.integers(1, 4, size=n).astype(np.float32)
    return cards, xn, xc, y, w


@pytest.mark.parametrize("batch", [0, 128])
def test_wdl_training_on_cuda_equals_cpu(cuda, batch):
    """3 bags, 4 epochs, full batch or minibatches of 128, on the card and
    on the CPU: per-epoch errors within 1e-5 relative, params within
    1e-5 (+1e-6)."""
    from shifu_tpu_torch.models import wdl
    from shifu_tpu_torch.train.nn_trainer import TrainSettings
    from shifu_tpu_torch.train.wdl_trainer import train_wdl_ensemble
    cards, xn, xc, y, w = _wdl_planes()
    spec = wdl.WDLModelSpec(numeric_dim=5, cat_cardinalities=cards,
                            embed_dim=4, hidden_nodes=[16, 8])
    runs = [train_wdl_ensemble(xn, xc, y, w, spec, TrainSettings(
        optimizer="ADAM", learning_rate=0.01, l2=1e-4, epochs=4,
        batch_size=batch), bags=3, device=dev) for dev in ("cpu", cuda)]
    np.testing.assert_allclose(np.array(runs[1].history),
                               np.array(runs[0].history), rtol=1e-5)
    from shifu_tpu_torch.train.checkpoint import tree_leaves
    for a, b in zip(runs[0].params, runs[1].params):
        for la, lb in zip(tree_leaves(a), tree_leaves(b)):
            np.testing.assert_allclose(lb.numpy(), la.numpy(), rtol=1e-5,
                                       atol=1e-6)


def test_wdl_minibatch_epoch_makes_one_host_sync(cuda):
    """Minibatch steps make no host sync: runs of 3 and 2 epochs differ
    by the one [2, B] error fetch."""
    import warnings

    from shifu_tpu_torch.models import wdl
    from shifu_tpu_torch.train.nn_trainer import TrainSettings
    from shifu_tpu_torch.train.wdl_trainer import train_wdl_ensemble
    cards, xn, xc, y, w = _wdl_planes()
    spec = wdl.WDLModelSpec(numeric_dim=5, cat_cardinalities=cards)

    def syncs(epochs):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                train_wdl_ensemble(xn, xc, y, w, spec, TrainSettings(
                    optimizer="ADAM", epochs=epochs, batch_size=128),
                    bags=2, device=cuda)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return sum("synchroniz" in str(w.message) for w in seen)
    assert syncs(3) - syncs(2) == 1


def test_wdl_hash_buckets_on_cuda_equal_the_host(cuda):
    from shifu_tpu_torch.ops import hashing
    ids = np.random.default_rng(3).integers(-5, 1 << 31, 100_000)
    for buckets in (1, 32, 12345, (1 << 31) - 1):
        key = hashing.column_hash_key(buckets)
        got = hashing.hash_bucket_device(torch.from_numpy(ids).to(cuda),
                                         key, buckets)
        assert got.device.type == "cuda"
        np.testing.assert_array_equal(
            got.cpu().numpy(), hashing.hash_bucket_host(ids, key, buckets))


def test_svm_dual_on_cuda_equals_cpu(cuda):
    """The rbf dual on 1,024 rows, 2,000 iterations, on the card and on
    the CPU: duals within 1e-4, decision values within 1e-3, support
    sets equal but for duals within 1e-4 of the 1e-6 threshold."""
    from shifu_tpu_torch.models.svm import SVMModelSpec
    from shifu_tpu_torch.train.svm_trainer import _solve_dual
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1024, 8)).astype(np.float32)
    y = (np.linalg.norm(x[:, :2], axis=1) > 1.2).astype(np.float32)
    spec = SVMModelSpec(input_dim=8, kernel="rbf", gamma=0.3)
    tm = (rng.random(1024) < 0.8).astype(np.float32)
    out = [[v.cpu().numpy() for v in _solve_dual(
        *(torch.from_numpy(a).to(dev) for a in (x, 2 * y - 1, tm, tm)),
        spec, 2000)] for dev in ("cpu", cuda)]
    (ca, cf, _, _), (ga, gf, _, _) = out
    np.testing.assert_allclose(ga, ca, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gf, cf, rtol=0, atol=1e-3)
    differ = (ga > 1e-6) != (ca > 1e-6)
    assert (np.abs(ca[differ] - 1e-6) <= 1e-4).all()


def test_wdl_and_svm_forwards_stay_on_the_card(cuda):
    """A CUDA forward of either model makes no host sync and returns a
    CUDA tensor: no step falls back to the CPU."""
    from shifu_tpu_torch.models import svm, wdl
    from shifu_tpu_torch.ops import hashing
    cards, xn, xc, _, _ = _wdl_planes(300)
    spec = wdl.WDLModelSpec(numeric_dim=5, cat_cardinalities=[6, 32, 32],
                            extra={"hash_buckets": 32, "hashed_cols": [2],
                                   "hash_keys": [hashing.column_hash_key(7)]})
    m = wdl.IndependentWDLModel(spec, wdl.init_params((0, 1), spec))
    s = svm.IndependentSVMModel(
        svm.SVMModelSpec(input_dim=5, kernel="rbf", gamma=0.5),
        xn[:40], np.linspace(-1, 1, 40).astype(np.float32))
    xn_d, xc_d = (torch.from_numpy(a).to(cuda) for a in (xn, xc))
    m.forward_device(xn_d, xc_d)                   # warm: params, bounds
    s.decision(xn_d)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = (m.forward_device(xn_d, xc_d), s.decision(xn_d))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(o.device.type == "cuda" and o.shape == (300, 1) for o in out)
    np.testing.assert_allclose(out[0].cpu().numpy(),
                               m.compute(xn, xc, device="cpu"), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out[1].cpu().numpy(),
                               s.compute(xn, device="cpu"), rtol=1e-5,
                               atol=1e-6)


def _serve_inputs(d, scorer, n, seed):
    """(x, bins, packed wire rows) for ``n`` rows of the fraud set."""
    import csv
    import os

    from shifu_tpu_torch.config import ModelConfig
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    with open(mc.dataSet.dataPath) as f:
        recs = [dict(r) for _, r in zip(range(n),
                                        csv.DictReader(f, delimiter="|"))]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, scorer.n_features)).astype(np.float32)
    bins = rng.integers(0, 8, size=(n, scorer.n_bins_cols)).astype(np.int32)
    packed, kept, _ = scorer.transform.parse_records(recs)
    assert len(kept) == n
    return x, bins, packed


def test_serve_rung_replays_equal_the_eager_launch(cuda, fraud_set):
    """Every rung of both paths is a captured CUDA graph, and its replay
    gives the eager launch of the same padded-batch function bit for
    bit, full and ragged; B4 is replayed once per scored batch."""
    from shifu_tpu_torch.serve import ServeServer, serve_capture_count
    srv = ServeServer(fraud_set, key="g", buckets=(1, 8, 64, 512))
    sc = srv.registry.get("g")
    assert sc.accepts_raw and sc.captures == 8
    assert all(r.graph is not None and r.launches == 1
               for r in sc._rungs.values())
    # each rung's eager warm-up launched B4 once, outside its capture
    assert sc.warm_launches == 8 and sc.replays == 0
    x, bins, packed = _serve_inputs(fraud_set, sc, 1500, 0)
    before = tq.predict_forest_quant.launches
    batches = 0
    for b in sc.buckets:
        for n in sorted({b, max(1, b - 3)}):
            got = sc.score_batch(x[:n], bins[:n])
            assert np.array_equal(got, sc.eager_batch([x[:n], bins[:n]]))
            raw = sc.score_batch_raw(packed[:n])
            assert np.array_equal(raw, sc.eager_batch([packed[:n]],
                                                      raw=True))
            batches += 2
    # a replay and an eager launch a check
    assert tq.predict_forest_quant.launches - before == 2 * batches
    assert sc.replays == sc.replayed_launches == batches
    assert serve_capture_count("serve.score.g") == 0


def test_serve_captures_nothing_after_warm_or_a_swap(cuda, fraud_set):
    """Requests of every size to 1500 replay the warm graphs: no capture;
    a committed swap captured its rungs at prepare; the replays count
    one B4 launch a scored batch."""
    import os

    from shifu_tpu_torch.serve import ServeServer, serve_capture_count
    srv = ServeServer(fraud_set, key="w", buckets=(1, 8, 64, 512),
                      max_delay_ms=0.5)
    sc = srv.registry.get("w")
    x, bins, packed = _serve_inputs(fraud_set, sc, 1500, 1)
    whole = sc.score_batch(x, bins)
    for n in range(1, 1501, 37):
        assert np.array_equal(sc.score_batch(x[:n], bins[:n]), whole[:n])
    assert sc.captures == 8 and serve_capture_count("serve.score.w") == 0
    srv.start()
    try:
        batches0 = srv.batcher.stats["batches"]
        before = tq.predict_forest_quant.launches
        got = srv.score(x[:700], bins[:700])
        assert np.allclose(got, whole[:700].mean(axis=1), rtol=0, atol=0)
        assert tq.predict_forest_quant.launches - before == \
            srv.batcher.stats["batches"] - batches0 == 2
        gen = srv.registry.prepare("w", os.path.join(fraud_set, "models"),
                                   buckets=sc.buckets)
        pend = srv.registry._pending["w"].scorer
        assert gen == 1 and pend.captures == 8
        srv.registry.commit("w")
        assert srv.registry.get("w") is pend and pend.captures == 8
        again = srv.score(x[:700], bins[:700])
        assert np.array_equal(again, got) and pend.captures == 8
        assert serve_capture_count("serve.score.w") == 0
    finally:
        srv.stop()


def test_fleet_of_two_replicas_serves_from_the_card(cuda, fraud_set):
    """``spawn_worker`` starts two worker processes with ``--device
    cuda``; behind the router each serves raw records from its own CUDA
    context and captured rungs, within 1e-3 of the set served on the CPU,
    with no capture forced, and the two replicas share the load."""
    import csv
    import os

    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.serve import ServeServer
    from shifu_tpu_torch.serve.router import (ServeRouter, spawn_worker,
                                              wait_for_announce)
    sc_cpu = ServeServer(fraud_set, key="c", device="cpu")
    mc = ModelConfig.load(os.path.join(fraud_set, "ModelConfig.json"))
    with open(mc.dataSet.dataPath) as f:
        recs = [dict(r) for _, r in zip(range(64),
                                        csv.DictReader(f, delimiter="|"))]
    sc_cpu.start()
    try:
        want = sc_cpu.score_raw(recs)["scores"]
    finally:
        sc_cpu.stop()
    fdir = os.path.join(fraud_set, "serving", "fleet")
    os.makedirs(fdir, exist_ok=True)
    router = ServeRouter(poll_ms=200, stale_s=30)
    procs = []
    try:
        for name in ("r0", "r1"):
            ann = os.path.join(fdir, f"{name}.json")
            p = spawn_worker(fraud_set, name, ann, device="cuda")
            assert p.args[p.args.index("--device") + 1] == "cuda"
            procs.append((name, ann, p))
        for name, ann, p in procs:
            router.add_backend(name, wait_for_announce(ann, p)["port"],
                               proc=p)
        router.poll_once()
        router.ensure_uniform()
        assert router.fleet_doc()["up"] == 2
        for _ in range(6):
            got = router.score({"records": recs})["scores"]
            assert np.max(np.abs(np.asarray(got) - np.asarray(want))) \
                <= 1e-3
        for r in router.replicas.values():
            hz = router._http(r, "GET", "/healthz")
            assert hz["device"].startswith("cuda") and hz["replica"] == r.name
            assert hz["graphs"]["captures_forced"] == 0
            assert hz["graphs"]["replays"] >= 1 and r.requests >= 1
            assert hz["graphs"]["replayed_launches"] == \
                hz["graphs"]["replays"]
    finally:
        router.stop()
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()


def test_stats_correlation_on_the_card_matches_the_cpu(cuda, fraud_set,
                                                       tmp_path):
    """``stats -correlation`` on the card (pair sums as float64 GEMMs
    there) writes the CPU's matrix within 1e-6, and the same stats."""
    import json
    import os
    import shutil

    from shifu_tpu_torch import cli
    cpu_set = str(tmp_path / "cpu_corr")
    shutil.copytree(fraud_set, cpu_set)
    assert cli.main(["--dir", fraud_set, "stats", "-correlation"]) == 0
    assert cli.main(["--dir", cpu_set, "stats", "-correlation", "--device",
                     "cpu"]) == 0
    mats = []
    for d in (fraud_set, cpu_set):
        with open(os.path.join(d, "correlation.csv")) as f:
            rows = [line.rstrip("\n").split(",") for line in f]
        mats.append((rows[0], np.array([[float(v) for v in r[1:]]
                                        for r in rows[1:]])))
    assert mats[0][0] == mats[1][0] and len(mats[0][0]) > 4
    np.testing.assert_allclose(mats[0][1], mats[1][1], atol=1e-6)
    with open(os.path.join(fraud_set, "ColumnConfig.json")) as f:
        card = json.load(f)
    with open(os.path.join(cpu_set, "ColumnConfig.json")) as f:
        cpu = json.load(f)
    assert [c["columnBinning"]["binBoundary"] for c in card] == \
        [c["columnBinning"]["binBoundary"] for c in cpu]


def test_warm_gbt_retrain_on_the_card_appends_to_the_restored_forest(
        cuda, fraud_set, monkeypatch):
    """``warm_retrain`` on the card over the set re-normed in shards of
    1,000 rows: 2 trees appended to the incumbent's 5 (2 x (4 + 1)
    ``hist`` launches, nothing else retrained), the 5 bit-equal and the
    score sidecar restoring f; then 2 more past the data-window cursor
    (the last shard only), where the restored 7 replay through
    ``tree_traverse``."""
    import os

    from shifu_tpu_torch import cli
    from shifu_tpu_torch.models.tree import load_model
    from shifu_tpu_torch.ops import tree as tree_ops
    from shifu_tpu_torch.refresh import RefreshJournal, warm_retrain
    monkeypatch.setattr("shifu_tpu_torch.pipeline.norm.SHARD_ROWS", 1000)
    assert cli.main(["--dir", fraud_set, "norm"]) == 0
    _, incumbent = load_model(os.path.join(fraud_set, "models",
                                           "model0.gbt"))
    journal = RefreshJournal(fraud_set)
    prev = incumbent
    for gen, restored in ((1, 5), (2, 7)):
        tree_ops.build_histograms.launches = 0
        tq.predict_forest_quant.launches = 0
        info = warm_retrain(fraud_set, gen, journal=journal, units=2,
                            device="cuda")
        assert info["warm"] and info["resumed_from"] == restored
        assert tree_ops.build_histograms.launches == 2 * (4 + 1)
        replays = tq.predict_forest_quant.launches
        assert (replays >= 1) if gen == 2 else (replays == 0)
        _, trees = load_model(os.path.join(info["models_dir"],
                                           "model0.gbt"))
        assert len(trees) == restored + 2
        for a, b in zip(trees[:restored], prev):
            for k in ("split_feat", "left_mask", "leaf_value"):
                assert getattr(a, k).tobytes() == getattr(b, k).tobytes()
        prev = trees


def test_refresh_promotion_canary_replays_bit_identically(cuda, fraud_set):
    """An in-process server on the card: a breach runs the warm retrain
    and the gate on the card, the swap captures the candidate's rungs at
    prepare and none at commit, and the canary pinned at promotion
    scores bit-identically through probation to ``complete``."""
    import numpy as np

    from shifu_tpu_torch.refresh import (PROBATION, RefreshConfig,
                                         RefreshController)
    from shifu_tpu_torch.serve import ServeServer, serve_capture_count
    srv = ServeServer(fraud_set, key="r", buckets=(1, 8, 64),
                      max_delay_ms=0.5)
    now = [1000.0]
    ctrl = RefreshController(
        fraud_set, server=srv,
        config=RefreshConfig(psi_threshold=0.25, cooldown_s=0.0,
                             probation_s=5.0, units=2, canary_rows=16,
                             holdout_rows=512),
        clock=lambda: now[0], sleep=lambda s: None,
        drift_fn=lambda: {"psi_max": 0.9, "rows": 1, "flagged": []},
        slo_alerts_fn=lambda: [])
    rec = ctrl.tick()
    assert rec["kind"] == "promote" and ctrl.journal.stage == PROBATION
    assert srv.registry.generation("r") == 1
    live = srv.registry.get("r")
    assert live.captures == 2 * len(live.buckets) and live.lazy_captures == 0
    can = ctrl._canary
    assert can is not None and can["gen"] == 1
    for _ in range(3):
        got = live.score_batch(can["x"], can["bins"])
        assert np.asarray(got).tobytes() == can["expected"].tobytes()
        assert ctrl.tick() is None
    now[0] += 6.0
    assert ctrl.tick()["kind"] == "complete"
    assert serve_capture_count("serve.score.r") == 0
