"""Port parity for the ``encode`` step: ``shifu_tpu_torch.pipeline.encode``
against ``shifu_tpu``'s on copies of the prepared fraud set with the same
reference-trained forest.

``tmp/EncodedData`` (and ``EncodedData.<evalset>``) is compared byte for
byte: the training set, an eval set, several parse chunks, ``-ref`` with
another model set's forest, and ``-ref``'s layout checks (a directory
that is no model set, another column selection, another binning), which
both packages refuse alike.  The walk itself: on the CPU the port walks
each tree with ``traverse_nodes``; the card's path is the
``tree_traverse`` node-index walk, whose plain version here must give
the same global node ids (depth 7, and depth 14 where ids reach 32,766,
exact in the kernel's f32 leaves).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def forests(tmp_path_factory, _prepared_template):
    """Reference-trained GBT and RF sets, made on first use."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
    from pipeline import train_algorithm
    params = {"GBT": {"TreeNum": 5, "MaxDepth": 4, "Loss": "log",
                      "LearningRate": 0.1},
              "RF": {"TreeNum": 4, "MaxDepth": 5, "Impurity": "variance"}}
    sets = {}

    def get(alg):
        if alg not in sets:
            d = str(tmp_path_factory.mktemp(f"encode_{alg}") / "set")
            shutil.copytree(_prepared_template, d)
            train_algorithm(d, alg, params[alg])
            sets[alg] = d
        return sets[alg]
    return get


def _pair(src, root):
    dirs = []
    for who in ("ref", "port"):
        d = str(root / who)
        shutil.copytree(src, d)
        dirs.append(d)
    return dirs


def _encode(ref, port, **params):
    from shifu_tpu.pipeline.encode import EncodeProcessor as JEncode
    from shifu_tpu_torch.pipeline.encode import EncodeProcessor
    return (JEncode(ref, params=dict(params)).run(),
            EncodeProcessor(port, params=dict(params), device="cpu").run())


def _same(ref, port, name):
    with open(os.path.join(ref, "tmp", name), "rb") as a, \
            open(os.path.join(port, "tmp", name), "rb") as b:
        want, got = a.read(), b.read()
    assert got == want
    return want


@pytest.mark.parametrize("alg", ["GBT", "RF"])
def test_encoded_data_is_byte_equal(forests, tmp_path, alg):
    ref, port = _pair(forests(alg), tmp_path)
    assert _encode(ref, port) == (0, 0)
    text = _same(ref, port, "EncodedData").decode()
    lines = text.splitlines()
    assert lines[0].startswith("target|tree0|") and len(lines) > 3000


def test_encode_evalset_is_byte_equal(forests, tmp_path):
    ref, port = _pair(forests("GBT"), tmp_path)
    assert _encode(ref, port, evalset="Eval1") == (0, 0)
    _same(ref, port, "EncodedData.Eval1")
    assert _encode(ref, port, evalset="NoSuchSet") == (1, 1)


def test_encode_over_several_chunks_is_byte_equal(forests, tmp_path,
                                                  monkeypatch):
    from shifu_tpu_torch.data import parsepool
    monkeypatch.setattr(parsepool, "CHUNK_ROWS", 700)
    ref, port = _pair(forests("GBT"), tmp_path)
    assert _encode(ref, port) == (0, 0)
    _same(ref, port, "EncodedData")


def test_encode_ref_and_its_layout_checks(forests, tmp_path):
    """``-ref`` with another set's forest (the RF set, same layout) is
    byte-equal; a directory without ModelConfig.json, a forest over
    another column selection and one over another binning are refused by
    both packages."""
    ref, port = _pair(forests("GBT"), tmp_path)
    other = forests("RF")
    assert _encode(ref, port, ref_model=other) == (0, 0)
    _same(ref, port, "EncodedData")
    assert _encode(ref, port, ref_model=str(tmp_path)) == (1, 1)
    # another column selection: the other set selects one column fewer
    narrow = str(tmp_path / "narrow")
    shutil.copytree(other, narrow)
    cpath = os.path.join(narrow, "ColumnConfig.json")
    with open(cpath) as f:
        ccs = json.load(f)
    chosen = [c for c in ccs if c.get("columnFlag") not in
              ("Target", "Weight", "Meta") and c["columnName"] != "tag"]
    for c in ccs:
        c["finalSelect"] = c in chosen[:-1]
    with open(cpath, "w") as f:
        json.dump(ccs, f, indent=1)
    from shifu_tpu.pipeline.norm import NormalizeProcessor
    from shifu_tpu.pipeline.train import TrainProcessor
    assert NormalizeProcessor(narrow, params={}).run() == 0
    assert TrainProcessor(narrow, params={}).run() == 0
    assert _encode(ref, port, ref_model=narrow) == (1, 1)
    # another binning: same selection, one column's bins differ
    rebinned = str(tmp_path / "rebinned")
    shutil.copytree(other, rebinned)
    cpath = os.path.join(rebinned, "ColumnConfig.json")
    with open(cpath) as f:
        ccs = json.load(f)
    num = next(c for c in ccs if c.get("columnType") == "N"
               and (c.get("columnBinning") or {}).get("binBoundary"))
    num["columnBinning"]["binBoundary"] = \
        num["columnBinning"]["binBoundary"][:-1]
    with open(cpath, "w") as f:
        json.dump(ccs, f, indent=1)
    assert _encode(ref, port, ref_model=rebinned) == (1, 1)


def test_encode_refuses_a_net_and_a_missing_model(forests, tmp_path):
    ref, port = _pair(forests("GBT"), tmp_path)
    for d in (ref, port):
        os.remove(os.path.join(d, "models", "model0.gbt"))
    assert _encode(ref, port) == (1, 1)
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    from shifu_tpu_torch.models import nn as nn_model
    from shifu_tpu_torch.ops import prng
    spec = nn_model.NNModelSpec(input_dim=3, hidden_nodes=[2],
                                activations=["tanh"])
    for d in (ref, port):
        path = os.path.join(d, "ModelConfig.json")
        mc = ModelConfig.load(path)
        mc.train.algorithm = Algorithm.NN
        mc.save(path)
        nn_model.save_model(os.path.join(d, "models", "model0.nn"), spec,
                            nn_model.init_params(prng.prng_key(0), spec))
    assert _encode(ref, port) == (1, 1)


def _forest(rng, n_trees, depth, n_bins, n_cols):
    from shifu_tpu_torch.ops.tree import TreeArrays
    k = (1 << (depth + 1)) - 1
    trees = []
    for _ in range(n_trees):
        sf = rng.integers(0, n_cols, k).astype(np.int32)
        sf[(1 << depth) - 1:] = -1                 # the last level: leaves
        sf[rng.random(k) < 0.1] = -1               # and some earlier ones
        trees.append(TreeArrays(
            split_feat=sf, left_mask=rng.random((k, n_bins)) < 0.5,
            leaf_value=rng.normal(size=k).astype(np.float32), depth=depth))
    return trees


@pytest.mark.parametrize("depth", [7, 14])
def test_node_index_walk_gives_the_reference_node_ids(depth):
    """The node-index walk (the card's path, here its plain version) and
    the CPU path give the reference's ``leaf_indices`` for every row and
    tree, frozen rows at their leaf included."""
    import jax.numpy as jnp
    from shifu_tpu.pipeline.encode import leaf_indices as j_leaf_indices
    from shifu_tpu_torch.models.tree import IndependentTreeModel, \
        TreeModelSpec
    from shifu_tpu_torch.ops import tree_quant as tq
    from shifu_tpu_torch.pipeline.encode import leaf_indices
    rng = np.random.default_rng(depth)
    n_bins, n_cols = 33, 9
    trees = _forest(rng, 3, depth, n_bins, n_cols)
    bins = rng.integers(0, n_bins, (2000, n_cols)).astype(np.int32)
    want = np.asarray(j_leaf_indices(trees, jnp.asarray(bins))).T
    model = IndependentTreeModel(
        TreeModelSpec("RF", len(trees), depth, n_bins), trees)
    got = leaf_indices(model, torch.from_numpy(bins))
    np.testing.assert_array_equal(got.numpy(), want)
    sf, lm, _ = model.quant_arrays(torch.device("cpu"))
    ids = tq.predict_forest_quant(sf, lm, tq.node_index_leaves(sf),
                                  torch.from_numpy(bins).to(torch.uint8),
                                  depth)
    np.testing.assert_array_equal(ids.round().long().numpy(), want)
    assert want.max() > (1 << depth) - 2           # deep leaves reached
