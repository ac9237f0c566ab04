"""Model specs — standalone scorers + serialization (the port of
``shifu_tpu.models``).  ``load_any`` sniffs the embedded spec kind of a
saved model file; tree forests (GBT/RF/DT) are ported, the other kinds raise
until their slice lands.
"""

from __future__ import annotations

import json

import numpy as np

#: model kinds the reference writes that this package cannot score yet
NOT_PORTED = ("nn", "wdl", "svm")


def spec_kind(path: str) -> str:
    data = np.load(path)
    return json.loads(bytes(data["__spec__"]).decode()).get("kind", "nn")


def load_any(path: str):
    """Load a saved model file -> object with ``.compute(bins)``."""
    kind = spec_kind(path)
    if kind == "tree":
        from .tree import IndependentTreeModel
        return IndependentTreeModel.load(path)
    if kind in NOT_PORTED:
        raise NotImplementedError(
            f"{path}: {kind!r} models (NN/LR, WDL, SVM) are not yet ported "
            "to shifu_tpu_torch — only GBT/RF forests serve here")
    raise ValueError(f"unknown model kind {kind!r} in {path}")
