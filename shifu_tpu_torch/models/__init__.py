"""Model specs — standalone scorers + serialization (the port of
``shifu_tpu.models``).  ``load_any`` sniffs the embedded spec kind of a
saved model file: tree forests (GBT/RF/DT) and NN nets (NN, LR — a
0-hidden-layer net — and TENSORFLOW) are ported; WDL and SVM raise until
their slice lands (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import json

import numpy as np

#: model kinds the reference writes that this package cannot score yet
NOT_PORTED = ("wdl", "svm")


def spec_kind(path: str) -> str:
    data = np.load(path)
    return json.loads(bytes(data["__spec__"]).decode()).get("kind", "nn")


def load_any(path: str):
    """Load a saved model file -> object with ``.compute(x_or_bins)``."""
    kind = spec_kind(path)
    if kind == "tree":
        from .tree import IndependentTreeModel
        return IndependentTreeModel.load(path)
    if kind == "nn":
        from .nn import IndependentNNModel
        return IndependentNNModel.load(path)
    if kind in NOT_PORTED:
        raise NotImplementedError(
            f"{path}: {kind!r} models (WDL, SVM) are not yet ported to "
            "shifu_tpu_torch (ROADMAP Queue 1 item 10)")
    raise ValueError(f"unknown model kind {kind!r} in {path}")
