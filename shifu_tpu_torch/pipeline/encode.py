"""`encode` step — the port of ``shifu_tpu.pipeline.encode`` (reference
``ModelDataEncodeProcessor.java``): re-emit a dataset with each row
encoded as the terminal node id of every tree of a trained forest
(feature crosses for downstream linear models).

The rows stream through the parse pool (served from the raw cache where
``stats`` wrote one) and the host transform; the forest walks their bins
on the step's device.  On a CUDA device that is one ``tree_traverse``
launch a chunk for the whole forest, the kernel's node-index walk
(:func:`leaf_indices`: every leaf value replaced by its node's index,
exact in f32); it launches or raises.  On the CPU each tree walks with
the plain gathers of ``ops/tree.py::traverse_nodes``, as the reference's
jnp walk does.  ``tmp/EncodedData[.<evalset>]`` equals the reference's
byte for byte.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from .. import ioutil
from ..config.validator import ModelStep
from ..data.parsepool import iter_extracted
from ..data.reader import DataSource
from ..data.transform import DatasetTransformer
from ..models import load_any
from ..ops import tree_quant as tq
from ..ops.tree import traverse_nodes
from .processor import BasicProcessor

log = logging.getLogger(__name__)


def node_index_forest(model, device: torch.device):
    """The forest's node-index walk on a CUDA ``device``: (split_feats,
    left masks, node-id leaves, packed form, depth), built once a run."""
    sf, lm, _ = model.quant_arrays(device)
    ids = tq.node_index_leaves(sf)
    depth = model.spec.depth
    return sf, lm, ids, tq.pack_forest(sf, lm, ids, depth), depth


def leaf_indices(model, bins: torch.Tensor, forest=None) -> torch.Tensor:
    """[T, N] int64 terminal global node id of every row in every tree of
    ``model`` (an ``IndependentTreeModel``) — the same walk as predict,
    returning the node instead of its value.  A CUDA ``bins`` (in
    ``model.bins_dtype``) takes ONE ``tree_traverse`` launch for the whole
    forest (``forest``: :func:`node_index_forest`'s arrays, else built
    here); CPU bins walk each tree with ``traverse_nodes``."""
    if bins.device.type == "cuda":
        sf, lm, ids, packed, depth = forest or node_index_forest(
            model, bins.device)
        out = tq.predict_forest_quant(sf, lm, ids, bins, depth,
                                      packed=packed)
        return out.round().long()
    if bins.device.type != "cpu":
        raise ValueError(f"leaf_indices: no walk for device {bins.device}")
    return torch.stack([
        traverse_nodes(torch.from_numpy(np.asarray(t.split_feat, np.int32)),
                       torch.from_numpy(np.asarray(t.left_mask, bool)),
                       bins, t.depth)
        for t in model.trees])


class EncodeProcessor(BasicProcessor):
    step = ModelStep.EVAL

    @property
    def profile_name(self) -> str:
        return "ENCODE"

    def process(self) -> int:
        mc = self.model_config
        ref = self.params.get("ref_model")
        if ref:
            # `encode -ref <dir>`: leaf-encode with ANOTHER model set's
            # trained tree model (reference ENCODE_REF_MODEL — champion
            # model crosses for stacking)
            from ..config import ModelConfig
            from ..config.path_finder import PathFinder
            ref_cfg = os.path.join(ref, "ModelConfig.json")
            if not os.path.isfile(ref_cfg):
                log.error("-ref %s is not a model-set dir (no "
                          "ModelConfig.json)", ref)
                return 1
            ref_mc = ModelConfig.load(ref_cfg)
            model_path = PathFinder(ref_mc, ref).model_path(0, None)
        else:
            model_path = self.paths.model_path(0, None)
        if not os.path.isfile(model_path):
            log.error("no model at %s — encode needs a trained GBT/RF",
                      model_path)
            return 1
        model = load_any(model_path)
        if getattr(model, "input_kind", "norm") != "bins":
            log.error("encode requires a tree model (GBT/RF); found %s",
                      type(model).__name__)
            return 1
        if ref and not self._ref_layout_matches(ref, model):
            return 1

        evalset = self.params.get("evalset")
        if evalset:
            idx = [i for i, e in enumerate(mc.evals) if e.name == evalset]
            if not idx:
                log.error("no eval set named %s", evalset)
                return 1
            ds = mc.evals[idx[0]].dataSet
            transformer = DatasetTransformer(mc, self.column_configs,
                                             for_eval_set=idx[0])
            out_name = f"EncodedData.{evalset}"
        else:
            ds = mc.dataSet
            transformer = DatasetTransformer(mc, self.column_configs)
            out_name = "EncodedData"

        source = DataSource(self._abs(ds.dataPath), ds.dataDelimiter,
                            header_path=self._abs(ds.headerPath),
                            header_delimiter=ds.headerDelimiter)
        on_card = self.device.type == "cuda"
        forest = node_index_forest(model, self.device) if on_card else None
        dtype = model.bins_dtype if on_card else torch.int32
        out_path = os.path.join(self.paths.tmp_dir, out_name)
        n = 0
        with self.phase("encode"), ioutil.atomic_open(out_path) as f:
            f.write("target|" + "|".join(
                f"tree{t}" for t in range(len(model.trees))) + "\n")
            for _, ex in iter_extracted(source, transformer.extractor,
                                        cache_root=self.paths.raw_cache_dir):
                tc = transformer.transform(ex)
                if tc.n == 0:
                    continue
                bins = torch.from_numpy(tc.bins).to(self.device, dtype)
                leaves = leaf_indices(model, bins, forest).cpu().numpy()
                block = np.column_stack(
                    [tc.target.astype(int).astype(str),
                     *(leaves[t].astype(str)
                       for t in range(leaves.shape[0]))])
                f.write("\n".join("|".join(r) for r in block.tolist()) + "\n")
                n += tc.n
        log.info("encoded %d rows x %d trees on %s -> %s", n,
                 len(model.trees), self.device, out_path)
        return 0

    def _ref_layout_matches(self, ref: str, model) -> bool:
        """The ``-ref`` model's split features and bin ids index THIS
        set's plane: a model trained on another column selection, order
        or binning would encode silent garbage, so both must agree
        (reference stacking assumes a shared ColumnConfig)."""
        from ..config.column_config import load_column_configs
        from ..data.transform import model_input_columns
        ours = [c.columnNum for c in
                model_input_columns(self.model_config, self.column_configs)]
        want = list(model.spec.column_nums or [])
        if want and want != ours:
            log.error("-ref model was trained on columns %s but this "
                      "set's model inputs are %s — encode needs the "
                      "same ColumnConfig selection/order", want, ours)
            return False
        ref_cc_path = os.path.join(ref, "ColumnConfig.json")
        if os.path.isfile(ref_cc_path):
            ref_bins = {c.columnNum: c.num_bins()
                        for c in load_column_configs(ref_cc_path)}
            mine = {c.columnNum: c.num_bins() for c in self.column_configs}
            bad = [cn for cn in (want or ours)
                   if ref_bins.get(cn) != mine.get(cn)]
            if bad:
                log.error("-ref model's binning disagrees on columns "
                          "%s (per-column bin counts differ) — re-run "
                          "stats/norm with matching binning", bad)
                return False
        return True
