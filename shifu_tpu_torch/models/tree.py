"""Tree-ensemble model spec (GBT / RF / DT) — the port of
``shifu_tpu.models.tree``: the same self-contained npz file (spec json +
per-tree arrays), so a ``model0.gbt`` written by either package loads in
the other byte for byte, and a standalone scorer over binned rows.

Trees live as complete-binary arrays (split_feat / per-bin left_mask /
leaf_value); scoring is ``depth`` gathers over the whole batch through
:func:`shifu_tpu_torch.ops.tree_quant.predict_forest_quant`.
"""

from __future__ import annotations

import io
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import ioutil, resolve_device
from ..ops.tree import TreeArrays


@dataclass
class TreeModelSpec:
    algorithm: str                      # "GBT" | "RF" | "DT"
    n_trees: int
    depth: int
    n_bins: int
    loss: str = "squared"               # GBT leaf-to-score link
    learning_rate: float = 0.1          # GBT shrinkage
    init_score: float = 0.0             # GBT prior (f_0)
    column_nums: Optional[List[int]] = None
    feature_names: Optional[List[str]] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({"version": 1, "kind": "tree",
                           "algorithm": self.algorithm, "n_trees": self.n_trees,
                           "depth": self.depth, "n_bins": self.n_bins,
                           "loss": self.loss, "learning_rate": self.learning_rate,
                           "init_score": self.init_score,
                           "column_nums": self.column_nums,
                           "feature_names": self.feature_names,
                           "extra": self.extra})

    @classmethod
    def from_json(cls, s: str) -> "TreeModelSpec":
        d = json.loads(s)
        return cls(algorithm=d["algorithm"], n_trees=d["n_trees"],
                   depth=d["depth"], n_bins=d["n_bins"],
                   loss=d.get("loss", "squared"),
                   learning_rate=d.get("learning_rate", 0.1),
                   init_score=d.get("init_score", 0.0),
                   column_nums=d.get("column_nums"),
                   feature_names=d.get("feature_names"),
                   extra=d.get("extra", {}))


def save_model(path: str, spec: TreeModelSpec, trees: List[TreeArrays]) -> None:
    arrays = {"__spec__": np.frombuffer(spec.to_json().encode(), np.uint8)}
    for i, t in enumerate(trees):
        arrays[f"sf{i}"] = t.split_feat
        arrays[f"lm{i}"] = np.packbits(t.left_mask, axis=1)
        arrays[f"lv{i}"] = t.leaf_value
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    ioutil.atomic_write_bytes(path, buf.getvalue())


def load_model(path: str) -> Tuple[TreeModelSpec, List[TreeArrays]]:
    data = np.load(path)
    spec = TreeModelSpec.from_json(bytes(data["__spec__"]).decode())
    trees = []
    for i in range(spec.n_trees):
        lm = np.unpackbits(data[f"lm{i}"], axis=1)[:, :spec.n_bins].astype(bool)
        trees.append(TreeArrays(split_feat=data[f"sf{i}"], left_mask=lm,
                                leaf_value=data[f"lv{i}"], depth=spec.depth))
    return spec, trees


def forest_from_numpy(spec_json: str, split_feats: np.ndarray,
                      left_masks: np.ndarray, leaf_values: np.ndarray
                      ) -> "IndependentTreeModel":
    """A model from stacked forest arrays as the reference holds them —
    split_feats [T, K] int32, left_masks [T, K, B] (bool or 0/1), leaf
    values [T, K] (or [T, K, S]) f32 — and its spec JSON
    (``TreeModelSpec.to_json``): how weights carry across packages without
    a file."""
    spec = TreeModelSpec.from_json(spec_json)
    sf = np.asarray(split_feats, np.int32)
    lm = np.asarray(left_masks).astype(bool)
    lv = np.asarray(leaf_values, np.float32)
    if not (len(sf) == len(lm) == len(lv) == spec.n_trees):
        raise ValueError(f"spec declares {spec.n_trees} trees, arrays hold "
                         f"{len(sf)}/{len(lm)}/{len(lv)}")
    trees = [TreeArrays(split_feat=sf[i].copy(), left_mask=lm[i].copy(),
                        leaf_value=lv[i].copy(), depth=spec.depth)
             for i in range(spec.n_trees)]
    return IndependentTreeModel(spec, trees)


class IndependentTreeModel:
    """Standalone forest scorer (reference ``IndependentTreeModel.compute``).
    ``input_kind = 'bins'``: consumes the binned int matrix."""

    input_kind = "bins"

    def __init__(self, spec: TreeModelSpec, trees: List[TreeArrays]):
        self.spec = spec
        self.trees = trees
        self._quant: Dict[torch.device, tuple] = {}   # device -> stacked
        self._packed: Dict[torch.device, object] = {}  # device -> packed

    @classmethod
    def load(cls, path: str) -> "IndependentTreeModel":
        return cls(*load_model(path))

    @property
    def bins_dtype(self) -> torch.dtype:
        """The bin plane this forest walks: uint8 up to 256 bins (the wire
        dtype), int32 beyond."""
        from ..ops.tree_quant import bins_fit_uint8
        return torch.uint8 if bins_fit_uint8(self.spec.n_bins) \
            else torch.int32

    def quant_arrays(self, device: torch.device) -> tuple:
        """The stacked quantized layout on ``device`` (built once)."""
        arrays = self._quant.get(device)
        if arrays is None:
            from ..ops.tree_quant import stack_forest_quant
            if len({t.depth for t in self.trees}) != 1:
                raise NotImplementedError(
                    "forests mixing tree depths are not ported yet")
            arrays = self._quant[device] = stack_forest_quant(self.trees,
                                                              device)
        return arrays

    def quant_packed(self, device: torch.device):
        """The kernel's packed form of the forest on a CUDA ``device``
        (``tree_quant.pack_forest``, built once beside the stacked arrays;
        a native multi-class forest packs its node-index form, whose walk
        ends on node ids the class distributions are gathered at); None
        on the CPU, whose plain walk reads the stacked arrays."""
        if device.type == "cpu":
            return None
        if device not in self._packed:
            from ..ops.tree_quant import pack_forest
            self._packed[device] = pack_forest(*self.quant_arrays(device),
                                               self.trees[0].depth)
        return self._packed[device]

    def link(self, preds: torch.Tensor) -> torch.Tensor:
        """[T, N] per-tree predictions -> [N] model output, f32 as in the
        reference: GBT ``init + lr * sum`` then the loss link, RF and DT
        the mean vote (``[N, S]`` for multiclass leaves)."""
        if self.spec.algorithm == "GBT":
            f = self.spec.init_score + self.spec.learning_rate \
                * preds.sum(dim=0)
            if self.spec.loss == "log":
                return 1.0 / (1.0 + torch.exp(-f))
            return f.clamp(0.0, 1.0)
        return preds.mean(dim=0)

    def compute(self, bins, device=None) -> np.ndarray:
        """[N, 1] (or [N, S] multiclass) f32 scores for binned rows; runs
        on ``device`` (default CUDA, or the device of a tensor ``bins``)."""
        from ..ops import tree_quant as tq
        if isinstance(bins, torch.Tensor) and device is None:
            dev = bins.device
        else:
            dev = resolve_device(device)
        b = bins if isinstance(bins, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(bins))
        b = b.to(dev, self.bins_dtype).contiguous()
        preds = tq.predict_forest_quant(*self.quant_arrays(dev), b,
                                        self.trees[0].depth,
                                        packed=self.quant_packed(dev))
        out = self.link(preds)
        if out.dim() == 1:
            out = out[:, None]
        return out.float().cpu().numpy()
