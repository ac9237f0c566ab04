"""Model specs — standalone scorers + serialization (the port of
``shifu_tpu.models``).  ``load_any`` sniffs the embedded spec kind of a
saved model file: tree forests (GBT/RF/DT), NN nets (NN, LR — a
0-hidden-layer net —, TENSORFLOW and the linear SVM), wide-and-deep
models and kernel SVMs.
"""

from __future__ import annotations

import json

import numpy as np


def spec_kind(path: str) -> str:
    data = np.load(path)
    return json.loads(bytes(data["__spec__"]).decode()).get("kind", "nn")


def load_any(path: str):
    """Load a saved model file -> object with ``.compute(...)``."""
    kind = spec_kind(path)
    if kind == "tree":
        from .tree import IndependentTreeModel
        return IndependentTreeModel.load(path)
    if kind == "nn":
        from .nn import IndependentNNModel
        return IndependentNNModel.load(path)
    if kind == "wdl":
        from .wdl import IndependentWDLModel
        return IndependentWDLModel.load(path)
    if kind == "svm":
        from .svm import IndependentSVMModel
        return IndependentSVMModel.load(path)
    raise ValueError(f"unknown model kind {kind!r} in {path}")
