"""NN model: MLP forward/backprop — the port of ``shifu_tpu.models.nn``
(the reference's Encog flat network, ``core/dtrain/nn/``).

Activations (``nn/Activation*.java`` plus Encog's), losses
(``nn/*ErrorCalculation.java``), the Xavier/He/Lecun weight randomizers
(``core/dtrain/random/``), dropout (``BasicDropoutLayer``) and the
standalone scorer of ``IndependentNNModel.java``, in PyTorch.

Params are a list of layers ``[{"w": [in, out], "b": [out]}, ...]`` as in
the reference.  An ensemble's members stack on a leading axis (``w``
``[B, in, out]``, ``b`` ``[B, out]``): :func:`forward` then runs one
matrix product a layer for all B members (the reference ``vmap``s the
member forward), the first layer as one GEMM of the shared input against
the members' weights side by side.  The products are ``torch.matmul``
(cuBLAS on the card); nothing here is a hand kernel, as nothing in the
reference's NN is a Pallas kernel.

Weights are drawn with the port's threefry stream (``ops/prng.py``), so
one seed gives the reference's initial weights: Xavier bit for bit, He and
Lecun within a few ulps.  Model files are the reference's ``.nn`` npz
(weights plus the spec json), so each package loads the other's.
"""

from __future__ import annotations

import io
import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import ioutil, resolve_device
from ..ops import prng

SPEC_VERSION = 1

Params = List[Dict[str, torch.Tensor]]


# ----------------------------------------------------------- activations
ACTIVATIONS: Dict[str, Callable] = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "leakyrelu": lambda x: torch.where(x >= 0, x, 0.01 * x),
    "ptanh": lambda x: torch.where(x >= 0, torch.tanh(x),
                                   0.25 * torch.tanh(x)),
    "swish": lambda x: x * torch.sigmoid(x),
    "linear": lambda x: x,
    "log": lambda x: torch.where(x >= 0, torch.log1p(x), -torch.log1p(-x)),
    "sin": torch.sin,
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def activation(name: str) -> Callable:
    key = (name or "sigmoid").lower()
    if key not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; one of "
                         f"{sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]


@dataclass
class NNModelSpec:
    """Network shape + metadata; serialized alongside weights so the saved
    model scores standalone (reference ``IndependentNNModel.java``)."""
    input_dim: int
    hidden_nodes: List[int]
    activations: List[str]
    output_dim: int = 1
    output_activation: str = "sigmoid"
    loss: str = "squared"           # reference default squared error
    column_nums: Optional[List[int]] = None
    feature_names: Optional[List[str]] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    def layer_dims(self) -> List[Tuple[int, int]]:
        dims = [self.input_dim] + list(self.hidden_nodes) + [self.output_dim]
        return list(zip(dims[:-1], dims[1:]))

    def to_json(self) -> str:
        return json.dumps({
            "version": SPEC_VERSION, "kind": "nn",
            "input_dim": self.input_dim, "hidden_nodes": self.hidden_nodes,
            "activations": self.activations, "output_dim": self.output_dim,
            "output_activation": self.output_activation, "loss": self.loss,
            "column_nums": self.column_nums,
            "feature_names": self.feature_names, "extra": self.extra})

    @classmethod
    def from_json(cls, s: str) -> "NNModelSpec":
        d = json.loads(s)
        return cls(input_dim=d["input_dim"], hidden_nodes=d["hidden_nodes"],
                   activations=d["activations"],
                   output_dim=d.get("output_dim", 1),
                   output_activation=d.get("output_activation", "sigmoid"),
                   loss=d.get("loss", "squared"),
                   column_nums=d.get("column_nums"),
                   feature_names=d.get("feature_names"),
                   extra=d.get("extra", {}))

    def shape_key(self) -> tuple:
        """What two models must share to score as one stacked forward."""
        return (self.input_dim, tuple(self.hidden_nodes),
                tuple(self.activations), self.output_dim,
                self.output_activation)


# ------------------------------------------------------------------- init
def init_params(key: prng.Key, spec: NNModelSpec,
                initializer: str = "xavier") -> Params:
    """Weight init per reference randomizers (``core/dtrain/random/``:
    Xavier/He/Lecun; default Xavier), as float32 host tensors drawn from
    the reference's key sequence: one ``split`` a layer."""
    init = (initializer or "xavier").lower()
    params = []
    for fan_in, fan_out in spec.layer_dims():
        key, sub = prng.split(key)
        n = fan_in * fan_out
        if init in ("he", "herandomizer", "lecun", "lecunrandomizer"):
            num = 2.0 if init.startswith("he") else 1.0
            w = prng.normal_f32(sub, n) * float(np.float32(np.sqrt(
                num / fan_in)))
        else:  # xavier uniform
            limit = np.sqrt(6.0 / (fan_in + fan_out))
            w = prng.uniform_range_f32(sub, n, -limit, limit)
        params.append({"w": w.reshape(fan_in, fan_out),
                       "b": torch.zeros(fan_out, dtype=torch.float32)})
    return params


# ---------------------------------------------------------------- forward
def _nonzero(v) -> bool:
    """Static gate for optional terms: a number 0.0 skips the op; a
    per-member tensor (stacked grid trials) always includes it."""
    return not (isinstance(v, (int, float)) and float(v) == 0.0)


def _dense(h: torch.Tensor, layer: Dict[str, torch.Tensor],
           matmul_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``h @ w + b``; stacked weights ``[B, in, out]`` take a shared 2-D
    input as one GEMM against the members side by side (``einsum`` folds
    B into the output columns) and a stacked input as a batched GEMM.
    ``matmul_dtype`` (bf16) narrows the product's inputs only."""
    w, b = layer["w"], layer["b"]
    hin = h
    if matmul_dtype is not None and h.dtype != matmul_dtype:
        hin, w = h.to(matmul_dtype), w.to(matmul_dtype)
    if w.dim() == 3 and hin.dim() == 2:
        out = torch.einsum("ni,bio->bno", hin, w)
    else:
        out = torch.matmul(hin, w)
    out = out.to(h.dtype)
    return out + (b.unsqueeze(-2) if b.dim() == 2 else b)


def forward(params: Params, spec: NNModelSpec, x: torch.Tensor, *,
            dropout_rate=0.0, rng=None,
            matmul_dtype: Optional[torch.dtype] = None,
            row0: int = 0) -> torch.Tensor:
    """MLP forward: ``[N, out]``, or ``[B, N, out]`` for stacked params.

    Hidden dropout (inverted scaling) only when a key is given: ``rng`` is
    one key, or one key a member for stacked params, split once a hidden
    layer as the reference does; ``dropout_rate`` is a number or a
    ``[B]`` tensor (stacked grid trials).  The compute dtype follows the
    weights: bf16 params pull the input and every hidden activation to
    bf16, and the head widens back to f32 before its activation.
    ``row0``: the rows are rows [row0, row0 + N) of the batch the dropout
    masks are drawn for (a mesh rank's block)."""
    acts = [activation(a) for a in spec.activations]
    cdt = params[0]["w"].dtype if params else torch.float32
    stacked = bool(params) and params[0]["w"].dim() == 3
    h = x.to(cdt) if cdt != torch.float32 else x
    keys = None
    if rng is not None and _nonzero(dropout_rate):
        keys = list(rng) if stacked else [rng]
        keep_p = 1.0 - dropout_rate
    for i, layer in enumerate(params[:-1]):
        h = acts[i % max(1, len(acts))](_dense(h, layer, matmul_dtype))
        if keys is not None:
            subs = []
            for j, k in enumerate(keys):
                keys[j], sub = prng.split(k)
                subs.append(sub)
            keep = prng.bernoulli(subs, keep_p, tuple(h.shape[-2:]),
                                  device=h.device,
                                  start=row0 * h.shape[-1])
            if isinstance(keep_p, torch.Tensor):
                kp = keep_p.to(h.dtype).reshape(-1, 1, 1)
            else:
                kp = torch.tensor(keep_p, dtype=h.dtype, device=h.device)
            if not stacked:
                keep = keep[0]
            h = torch.where(keep, h / kp, torch.zeros((), dtype=h.dtype,
                                                      device=h.device))
    out = _dense(h, params[-1], matmul_dtype)
    if out.dtype != torch.float32:
        out = out.float()
    return activation(spec.output_activation)(out)


def _clip(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp(p, 1e-7, 1.0)


LOSSES = {
    "squared": lambda p, y: (p - y) ** 2,
    "absolute": lambda p, y: torch.abs(p - y),
    "log": lambda p, y: -(y * torch.log(_clip(p))
                          + (1 - y) * torch.log(_clip(1 - p))),
    # hinge on a linear head: y in {0,1} maps to targets {-1,+1}
    "hinge": lambda p, y: torch.clamp(1.0 - (2.0 * y - 1.0) * p, min=0.0),
}


def per_row_loss(pred: torch.Tensor, y: torch.Tensor,
                 spec: NNModelSpec) -> torch.Tensor:
    """Per-row loss ``[..., N]`` of ``pred`` ``[..., N, out]`` against ``y``
    ``[..., N, 1]``.  Multi-class (``output_dim > 1``): y holds the class
    index and the loss is softmax cross-entropy (the native mode); an
    index outside ``[0, K)`` one-hots to zeros, as in the reference.
    Otherwise the configured elementwise loss."""
    if spec.output_dim > 1:
        idx = y.squeeze(-1).to(torch.int32)
        k = torch.arange(spec.output_dim, dtype=torch.int32,
                         device=pred.device)
        oh = (idx.unsqueeze(-1) == k).to(pred.dtype)
        return -(oh * torch.log(_clip(pred))).sum(dim=-1)
    lfn = LOSSES.get(spec.loss, LOSSES["squared"])
    return lfn(pred, y).sum(dim=-1)


def weighted_loss(params: Params, spec: NNModelSpec, x, y, w, *,
                  l2=0.0, l1=0.0, dropout_rate=0.0, rng=None,
                  matmul_dtype: Optional[torch.dtype] = None):
    """Mean weighted loss plus L1/L2 on the weights (reference
    ``Weight.java:201-213`` regularizes in the update; in the loss it is
    the same under gradient descent): a scalar, or ``[B]`` for stacked
    params (each member's own loss, so their sum's gradient is each
    member's gradient).  ``w`` is ``[N]`` or ``[B, N]``."""
    pred = forward(params, spec, x, dropout_rate=dropout_rate, rng=rng,
                   matmul_dtype=matmul_dtype)
    per_row = per_row_loss(pred, y, spec)
    denom = torch.clamp(w.sum(dim=-1), min=1e-9)
    loss = (per_row * w).sum(dim=-1) / denom
    reg = regularization(params, l2, l1)
    return loss if reg is None else loss + reg


def regularization(params: Params, l2=0.0, l1=0.0):
    """:func:`weighted_loss`'s L2 and L1 terms on the weights (``[B]`` for
    stacked params), or None when neither is set."""
    if not (_nonzero(l2) or _nonzero(l1)):
        return None
    loss = 0.0
    if _nonzero(l2):
        loss = loss + l2 * sum((layer["w"] ** 2).sum(dim=(-2, -1))
                               for layer in params)
    if _nonzero(l1):
        loss = loss + l1 * sum(torch.abs(layer["w"]).sum(dim=(-2, -1))
                               for layer in params)
    return loss


# ------------------------------------------------------- stacking helpers
def stack_params(members: Sequence[Params], device=None) -> Params:
    """Members' params stacked on a leading axis, on ``device``."""
    return [{k: torch.stack([m[li][k] for m in members]).to(device)
             for k in ("b", "w")} for li in range(len(members[0]))]


def params_from_jax(layers: Sequence[Dict[str, Any]]) -> Params:
    """The reference's params (a list of ``{"w", "b"}`` arrays, e.g. from
    ``shifu_tpu.models.nn.init_params`` through ``np.asarray``) as this
    package's float32 host tensors; bf16 arrays keep their bits."""
    out = []
    for layer in layers:
        d = {}
        for k in ("b", "w"):
            a = np.asarray(layer[k])
            if a.dtype.kind not in "biufc":           # ml_dtypes bfloat16
                d[k] = torch.from_numpy(a.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                d[k] = torch.from_numpy(np.array(a, np.float32))
        out.append(d)
    return out


def params_to_jax(params: Params) -> List[Dict[str, np.ndarray]]:
    """Inverse of :func:`params_from_jax`: float32 numpy arrays (bf16
    widened, which is exact) the reference's functions take."""
    return [{k: layer[k].detach().float().cpu().numpy() for k in ("w", "b")}
            for layer in params]


# ------------------------------------------------------------- save/load
def save_model(path: str, spec: NNModelSpec, params) -> None:
    """Self-contained .nn file: npz of weight arrays + the spec json (the
    reference's format, ``w{i}``/``b{i}`` float32 and ``__spec__``)."""
    arrays = {}
    for i, layer in enumerate(params):
        for k in ("w", "b"):
            v = layer[k]
            if isinstance(v, torch.Tensor):
                v = v.detach().float().cpu().numpy()
            arrays[f"{k}{i}"] = np.asarray(v, np.float32)
    arrays["__spec__"] = np.frombuffer(spec.to_json().encode(),
                                       dtype=np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    ioutil.atomic_write_bytes(path, buf.getvalue())


def load_model(path: str) -> Tuple[NNModelSpec, Params]:
    data = np.load(path)
    spec = NNModelSpec.from_json(bytes(data["__spec__"]).decode())
    params = [{"w": torch.from_numpy(np.array(data[f"w{i}"], np.float32)),
               "b": torch.from_numpy(np.array(data[f"b{i}"], np.float32))}
              for i in range(len(spec.layer_dims()))]
    return spec, params


class IndependentNNModel:
    """Dependency-light scorer over a saved spec (reference
    ``IndependentNNModel.java``: load once, ``compute()`` per batch).
    Reads the normalized floats (``input_kind`` "norm")."""

    input_kind = "norm"

    def __init__(self, spec: NNModelSpec, params: Params):
        self.spec = spec
        self.params = params
        self._on: Dict[torch.device, Params] = {}

    @classmethod
    def load(cls, path: str) -> "IndependentNNModel":
        return cls(*load_model(path))

    def params_on(self, device: torch.device) -> Params:
        """The weights on ``device`` (copied there once)."""
        if device not in self._on:
            self._on[device] = [{k: v.to(device) for k, v in layer.items()}
                                for layer in self.params]
        return self._on[device]

    def compute(self, x, device=None) -> np.ndarray:
        """[N, out] f32 scores; runs on ``device`` (default CUDA, or the
        device of a tensor ``x``)."""
        if isinstance(x, torch.Tensor) and device is None:
            dev = x.device
        else:
            dev = resolve_device(device)
        xt = x if isinstance(x, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(x, np.float32))
        with torch.no_grad():
            out = forward(self.params_on(dev), self.spec,
                          xt.to(dev, torch.float32))
        return out.cpu().numpy()


def fit_params_into(old_spec: NNModelSpec, old_params, new_spec: NNModelSpec,
                    key: prng.Key, initializer: str = "xavier"):
    """Continuous-training structure fit-in (reference ``NNMaster.java:
    331-362,605-645``): fresh-init the new shape, then copy each old
    weight block into the top-left corner of the matching layer.  Returns
    None when the old net does not embed (any old dim exceeds the new
    one, or fewer layers configured than saved).  When layers are added
    the old output layer is not copied (it cannot sit mid-stack)."""
    old_dims = old_spec.layer_dims()
    new_dims = new_spec.layer_dims()
    if len(old_dims) > len(new_dims):
        return None
    for (oi, oo), (ni, no) in zip(old_dims, new_dims):
        if oi > ni or oo > no:
            return None
    params = init_params(key, new_spec, initializer)
    out = []
    for li, layer in enumerate(params):
        if li < len(old_params) and not (
                len(old_dims) < len(new_dims) and li == len(old_params) - 1):
            w, b = layer["w"].clone(), layer["b"].clone()
            ow = torch.as_tensor(np.asarray(old_params[li]["w"],
                                            np.float32))
            ob = torch.as_tensor(np.asarray(old_params[li]["b"],
                                            np.float32))
            w[:ow.shape[0], :ow.shape[1]] = ow
            b[:ob.shape[0]] = ob
            out.append({"w": w, "b": b})
        else:
            out.append(layer)
    return out
