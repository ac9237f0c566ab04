"""Complete-binary tree arrays — the port's copy of ``TreeArrays`` and
``n_tree_nodes`` from ``shifu_tpu.ops.tree`` (the growers and histogram
code arrive with the training slice)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TreeArrays:
    """Complete binary tree, node i's children at 2i+1 / 2i+2."""
    split_feat: np.ndarray   # [nodes] int32, -1 = leaf
    left_mask: np.ndarray    # [nodes, n_bins] bool: bin goes left
    leaf_value: np.ndarray   # [nodes] float32
    depth: int

    @property
    def n_nodes(self) -> int:
        return len(self.split_feat)


def n_tree_nodes(depth: int) -> int:
    return (1 << (depth + 1)) - 1
