"""Port parity: the forest traversal of ``shifu_tpu_torch.ops.tree_quant``
against both lowerings of ``shifu_tpu.ops.tree_quant`` (the jnp gather
fallback and the Pallas kernel in interpret mode).

Per-tree outputs are integer routing plus one leaf select, so the [T, N]
predictions must be EQUAL — no tolerance.  Inputs come from a numpy seed
and cross the packages as numpy arrays.  The CUDA kernel itself is held
against the plain version on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from shifu_tpu.ops import tree_quant as jtq
from shifu_tpu_torch.models.tree import TreeModelSpec, forest_from_numpy
from shifu_tpu_torch.ops import tree_quant as tq
from shifu_tpu_torch.ops.tree import n_tree_nodes

pytestmark = pytest.mark.torch_port


def _forest(n_trees, depth, n_bins, n_cols, seed, leaf_frac=0.1):
    """Random complete-binary forest: ~``leaf_frac`` of internal nodes are
    early leaves, bottom-level nodes always are."""
    rng = np.random.default_rng(seed)
    k = n_tree_nodes(depth)
    sf = rng.integers(0, n_cols, size=(n_trees, k)).astype(np.int32)
    sf[rng.random((n_trees, k)) < leaf_frac] = -1
    sf[:, (1 << depth) - 1:] = -1
    lm = (rng.random((n_trees, k, n_bins)) < 0.5).astype(np.uint8)
    lv = rng.normal(0.0, 0.1, size=(n_trees, k)).astype(np.float32)
    return sf, lm, lv


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("n_rows", [1, 127, 128, 129, 333])
@pytest.mark.parametrize("n_bins,depth", [(32, 4), (64, 6), (256, 3)])
def test_forest_predictions_equal_both_reference_lowerings(n_bins, depth,
                                                           n_rows):
    n_cols = 11
    sf, lm, lv = _forest(3, depth, n_bins, n_cols, seed=depth * 1000 + n_bins)
    rng = np.random.default_rng(n_rows)
    bins = rng.integers(0, n_bins, size=(n_rows, n_cols)).astype(np.uint8)
    got = tq.predict_forest_quant(*_torch(sf, lm, lv, bins), depth).numpy()
    fallback = np.asarray(jtq.predict_forest_quant(
        sf, lm, lv, bins, depth, use_kernel=False))
    kernel = np.asarray(jtq.predict_forest_quant(
        sf, lm, lv, bins, depth, use_kernel=True, interpret=True))
    assert got.shape == (3, n_rows) and got.dtype == np.float32
    assert np.array_equal(got, fallback)
    assert np.array_equal(got, kernel)


def test_out_of_range_bins_follow_the_gather_fallback():
    """Bin ids >= n_bins: the reference's jnp gather clamps them to the
    last mask column, its Pallas one-hot routes them right.  The port (plain
    version and CUDA kernel alike) follows the fallback."""
    depth, n_bins, n_cols = 4, 32, 5
    sf, lm, lv = _forest(4, depth, n_bins, n_cols, seed=7, leaf_frac=0.0)
    rng = np.random.default_rng(8)
    bins = rng.integers(n_bins, 256, size=(64, n_cols)).astype(np.uint8)
    got = tq.predict_forest_quant(*_torch(sf, lm, lv, bins), depth).numpy()
    fallback = np.asarray(jtq.predict_forest_quant(
        sf, lm, lv, bins, depth, use_kernel=False))
    kernel = np.asarray(jtq.predict_forest_quant(
        sf, lm, lv, bins, depth, use_kernel=True, interpret=True))
    assert np.array_equal(got, fallback)
    assert not np.array_equal(got, kernel)     # the reference's own split


def test_single_tree_walk_matches_reference_node_ids():
    depth, n_bins, n_cols = 5, 16, 6
    sf, lm, _ = _forest(1, depth, n_bins, n_cols, seed=3)
    bins = np.random.default_rng(4).integers(
        0, n_bins, size=(50, n_cols)).astype(np.uint8)
    got = tq.traverse_quant(*_torch(sf[0], lm[0], bins), depth).numpy()
    want = np.asarray(jtq.traverse_quant(sf[0], lm[0], bins, depth))
    assert np.array_equal(got, want)


def test_multiclass_leaves_take_the_plain_gather():
    depth, n_bins, n_cols = 3, 8, 4
    sf, lm, _ = _forest(2, depth, n_bins, n_cols, seed=5)
    lv = np.random.default_rng(6).random(
        (2, n_tree_nodes(depth), 3)).astype(np.float32)
    bins = np.random.default_rng(7).integers(
        0, n_bins, size=(20, n_cols)).astype(np.uint8)
    got = tq.predict_forest_quant(*_torch(sf, lm, lv, bins), depth).numpy()
    want = np.asarray(jtq.predict_forest_quant(sf, lm, lv, bins, depth,
                                               use_kernel=False))
    assert got.shape == (2, 20, 3) and np.array_equal(got, want)


def test_cpu_calls_never_count_as_kernel_launches():
    sf, lm, lv = _forest(2, 3, 8, 4, seed=9)
    bins = np.zeros((5, 4), np.uint8)
    before = tq.predict_forest_quant.launches
    tq.predict_forest_quant(*_torch(sf, lm, lv, bins), 3)
    assert tq.predict_forest_quant.launches == before


def test_cost_model_matches_reference():
    kw = dict(rows=512, n_feat=256, n_bins=64, n_nodes=255, depth=7,
              n_trees=100)
    assert tq.quant_traverse_cost(**kw) == jtq.quant_traverse_cost(**kw)


def test_traverse_bytes_counts_only_what_the_walks_read():
    """One depth-2 tree whose node 2 is an early leaf; three rows end at
    nodes 3, 2 and 4.  Reads: 5 bins, split features of nodes 0-2, four
    left-mask entries, three leaf values, and the [1, 3] f32 output."""
    sf = np.array([[0, 1, -1, -1, -1, -1, -1]], np.int32)
    lm = np.zeros((1, 7, 4), np.uint8)
    lm[0, 0, 0] = 1                     # node 0: bin 0 goes left
    lm[0, 1, :2] = 1                    # node 1: bins 0-1 go left
    bins = np.array([[0, 0, 0], [1, 3, 2], [0, 2, 1]], np.uint8)
    got = tq.traverse_bytes(*_torch(sf, lm, bins), 2)
    assert got == {"bytes": 5 + 3 * 4 + 4 + 3 * 4 + 3 * 4, "split_steps": 5}
    lv = np.zeros((1, 7), np.float32)
    lv[0, [3, 2, 4]] = [1.0, 2.0, 3.0]
    assert tq.predict_forest_quant(*_torch(sf, lm, lv, bins),
                                   2).tolist() == [[1.0, 2.0, 3.0]]
    # a random forest never needs more than the reference's whole-forest
    # count, which charges every node of every tree
    sf, lm, lv = _forest(4, 5, 16, 9, seed=21)
    bins = np.random.default_rng(22).integers(
        0, 16, size=(40, 9)).astype(np.uint8)
    got = tq.traverse_bytes(*_torch(sf, lm, bins), 5)
    whole = tq.quant_traverse_cost(rows=40, n_feat=9, n_bins=16,
                                   n_nodes=sf.shape[1], depth=5, n_trees=4)
    assert 0 < got["bytes"] < whole["bytes_accessed"]


def test_bins_dtype_and_stacking_match_reference():
    sf, lm, lv = _forest(3, 3, 300, 4, seed=11)
    spec = TreeModelSpec(algorithm="GBT", n_trees=3, depth=3, n_bins=300)
    model = forest_from_numpy(spec.to_json(), sf, lm.astype(bool), lv)
    assert jtq.ensemble_bins_dtype([model]) == np.dtype(np.int32)
    assert tq.ensemble_bins_dtype([model]) == torch.int32
    assert not tq.bins_fit_uint8(300) and tq.bins_fit_uint8(256)
    got = tq.stack_forest_quant(model.trees)
    want = jtq.stack_forest_quant(model.trees)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_int32_bins_match_reference_classic_path():
    """Forests wider than 256 bins ride int32 planes; the reference walks
    them with its classic gather path (``ops.tree``), not its kernel."""
    from shifu_tpu.ops.tree import predict_forest_stacked, stack_forest
    depth, n_bins, n_cols = 4, 4001, 7
    sf, lm, lv = _forest(5, depth, n_bins, n_cols, seed=12)
    spec = TreeModelSpec(algorithm="GBT", n_trees=5, depth=depth,
                         n_bins=n_bins)
    model = forest_from_numpy(spec.to_json(), sf, lm.astype(bool), lv)
    bins = np.random.default_rng(13).integers(
        0, n_bins + 1, size=(200, n_cols)).astype(np.int32)
    got = tq.predict_forest_quant(*_torch(sf, lm, lv, bins), depth).numpy()
    want = np.asarray(predict_forest_stacked(*stack_forest(model.trees),
                                             bins, depth))
    assert np.array_equal(got, want)
    assert model.bins_dtype == torch.int32
