"""Kernel SVM model spec and standalone scorer — the port of
``shifu_tpu.models.svm``.

The reference's SVM is Encog/libsvm C-SVC with linear, poly, sigmoid and
RBF kernels (``core/alg/SVMTrainer.java:80-145``).  The model keeps the
support vectors and their signed duals; scoring is one kernel matrix
against the support vectors (``torch.matmul``, cuBLAS on the card) and one
product with the duals, where libsvm loops over support vectors a row.
The linear SVM trains on the NN path (a hinge head) and is an NN file.
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


@dataclass
class SVMModelSpec:
    input_dim: int
    kernel: str = "rbf"                 # linear | poly | sigmoid | rbf
    gamma: float = 0.1
    coef0: float = 0.0
    degree: int = 3
    column_nums: Optional[List[int]] = None
    feature_names: Optional[List[str]] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({
            "version": 1, "kind": "svm", "input_dim": self.input_dim,
            "kernel": self.kernel, "gamma": self.gamma,
            "coef0": self.coef0, "degree": self.degree,
            "column_nums": self.column_nums,
            "feature_names": self.feature_names, "extra": self.extra})

    @classmethod
    def from_json(cls, s: str) -> "SVMModelSpec":
        d = json.loads(s)
        return cls(input_dim=d["input_dim"], kernel=d.get("kernel", "rbf"),
                   gamma=d.get("gamma", 0.1), coef0=d.get("coef0", 0.0),
                   degree=d.get("degree", 3),
                   column_nums=d.get("column_nums"),
                   feature_names=d.get("feature_names"),
                   extra=d.get("extra", {}))


def kernel_matrix(spec: SVMModelSpec, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """[n, m] kernel values in libsvm's conventions (``svm.h``
    kernel_type): rbf ``exp(-gamma |a-b|^2)``, poly ``(gamma a.b +
    coef0)^degree``, sigmoid ``tanh(gamma a.b + coef0)``, linear ``a.b``.
    One product ``a @ b.T`` feeds every kernel; rbf's squared distance
    is clamped at zero."""
    dot = a @ b.T
    if spec.kernel == "linear":
        return dot
    if spec.kernel == "poly":
        return (spec.gamma * dot + spec.coef0) ** spec.degree
    if spec.kernel == "sigmoid":
        return torch.tanh(spec.gamma * dot + spec.coef0)
    sq = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * dot
    return torch.exp(-spec.gamma * torch.clamp(sq, min=0.0))


def save_model(path: str, spec: SVMModelSpec, sv_x, alpha_y) -> None:
    """The reference's ``.svm`` npz: the spec json, ``sv_x`` [S, d] and
    ``alpha_y`` [S], float32."""
    def host(a):
        return np.asarray(a.detach().cpu().numpy()
                          if isinstance(a, torch.Tensor) else a, np.float32)

    arrays = {"__spec__": np.frombuffer(spec.to_json().encode(), np.uint8),
              "sv_x": host(sv_x), "alpha_y": host(alpha_y)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    ioutil.atomic_write_bytes(path, buf.getvalue())


def load_model(path: str) -> Tuple[SVMModelSpec, np.ndarray, np.ndarray]:
    data = np.load(path)
    spec = SVMModelSpec.from_json(bytes(data["__spec__"]).decode())
    return spec, data["sv_x"], data["alpha_y"]


class IndependentSVMModel:
    """Standalone kernel-SVM scorer over saved support vectors.  The
    decision value maps through a sigmoid so scores live in [0, 1] like
    every other scorer's (AUC and gains are sigmoid-invariant).  Reads the
    normalized floats (``input_kind`` "norm")."""

    input_kind = "norm"

    def __init__(self, spec: SVMModelSpec, sv_x, alpha_y):
        self.spec = spec
        self.sv_x = torch.as_tensor(np.asarray(sv_x, np.float32))
        self.alpha_y = torch.as_tensor(np.asarray(alpha_y, np.float32))
        self._on: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    @classmethod
    def load(cls, path: str) -> "IndependentSVMModel":
        return cls(*load_model(path))

    def decision(self, x: torch.Tensor) -> torch.Tensor:
        """[N, 1] scores of device rows ``x``: ``sigmoid((K(x, sv) + 1) @
        alpha_y)`` (the +1 is the trainer's bias fold)."""
        dev = x.device
        if dev not in self._on:
            self._on[dev] = (self.sv_x.to(dev), self.alpha_y.to(dev))
        sv, ay = self._on[dev]
        with torch.no_grad():
            k = kernel_matrix(self.spec, x.float(), sv) + 1.0
            return torch.sigmoid(k @ ay)[:, None]

    def compute(self, x, device=None) -> np.ndarray:
        """[N, 1] f32 scores; a tensor scores on its device, host rows on
        ``device`` (default CUDA)."""
        if isinstance(x, torch.Tensor) and device is None:
            dev = x.device
        else:
            dev = resolve_device(device)
        xt = x if isinstance(x, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return self.decision(xt.to(dev)).cpu().numpy()
