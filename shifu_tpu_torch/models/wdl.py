"""Wide-and-deep model — the port of ``shifu_tpu.models.wdl`` (reference
``core/dtrain/wdl/``: ``WideAndDeep.java:50``'s DenseLayer / EmbedLayer /
WideLayer / BiasLayer graph).

- deep side: one embedding table a categorical column (the missing bin is
  one more row) beside the normalized numeric block, through dense layers;
- wide side: one scalar weight a categorical bin (the sparse LR of
  ``WideLayer``) plus a linear term on the numerics;
- output: ``sigmoid(bias + deep + wide)``, trained with weighted log loss.

Layout.  A member's tables live FLAT: every column's embedding rows in one
``embed`` [R, E] table (R = the sum of the cardinalities, column ``c``'s
rows at ``spec.row_offsets()[c]``) and every wide weight in one
``wide_cat`` [R] vector.  A batch's lookups are then one ``F.embedding``
over global row ids (each id clipped into its column first, as the
reference's gather clips), and their backward one deterministic
accumulate, whatever the number of columns.  Members stack on a leading
axis (``embed`` [B, R, E]); the stacked tables are gathered as one
[B·R, E] table.  The dense half of the forward
(:func:`logits_from_rows`) takes the looked-up rows, so the replicated
lookup, the trainer's row-sharded one (``train/wdl_shard.py``) and the
serving copies share its arithmetic op for op.  Model files keep the
reference's per-column npz keys (``emb{i}``, ``wc{i}``), so each package
loads the other's.

The reference lowers its lookups two ways: a clipped gather (scoring
batches) and, when ``N·C·K`` is at most 2^25, a one-hot einsum at
``Precision.HIGHEST`` (training batches, where the TPU serialises the
gather's scatter-add backward).  The forward values agree; the one-hot's
backward is a matmul, so embedding gradients differ in the last bits.
This port has the gather alone.  The reference's ``optimization_barrier``
plumbing exists to keep XLA's fusion from reassociating adds across its
sharded paths; eager PyTorch does not reassociate, so it has no
counterpart.  The adds keep the reference's order: bias, then the deep
head, then the wide columns summed left to right, then ``x_num @
wide_num``.
"""

from __future__ import annotations

import io
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import ioutil, resolve_device
from ..ops import prng
from . import nn as nn_model

Params = Dict[str, Any]


@dataclass
class WDLModelSpec:
    numeric_dim: int
    cat_cardinalities: List[int]        # bins incl. the missing bin, per col
    embed_dim: int = 8
    hidden_nodes: List[int] = field(default_factory=lambda: [64, 32])
    activations: List[str] = field(default_factory=lambda: ["relu", "relu"])
    wide_enable: bool = True
    deep_enable: bool = True
    column_nums: Optional[List[int]] = None
    cat_column_nums: Optional[List[int]] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({
            "version": 1, "kind": "wdl", "numeric_dim": self.numeric_dim,
            "cat_cardinalities": self.cat_cardinalities,
            "embed_dim": self.embed_dim, "hidden_nodes": self.hidden_nodes,
            "activations": self.activations, "wide_enable": self.wide_enable,
            "deep_enable": self.deep_enable, "column_nums": self.column_nums,
            "cat_column_nums": self.cat_column_nums, "extra": self.extra})

    @classmethod
    def from_json(cls, s: str) -> "WDLModelSpec":
        d = json.loads(s)
        return cls(numeric_dim=d["numeric_dim"],
                   cat_cardinalities=d["cat_cardinalities"],
                   embed_dim=d.get("embed_dim", 8),
                   hidden_nodes=d.get("hidden_nodes", [64, 32]),
                   activations=d.get("activations", ["relu", "relu"]),
                   wide_enable=d.get("wide_enable", True),
                   deep_enable=d.get("deep_enable", True),
                   column_nums=d.get("column_nums"),
                   cat_column_nums=d.get("cat_column_nums"),
                   extra=d.get("extra", {}))

    def row_offsets(self) -> np.ndarray:
        """[C + 1] int64: column ``c``'s rows of a flat table are
        ``offsets[c]:offsets[c + 1]``."""
        return np.concatenate(
            [[0], np.cumsum(self.cat_cardinalities, dtype=np.int64)])

    def deep_spec(self) -> nn_model.NNModelSpec:
        """The dense stack: numerics and embeddings in, one linear logit
        out."""
        return nn_model.NNModelSpec(
            input_dim=self.numeric_dim
            + len(self.cat_cardinalities) * self.embed_dim,
            hidden_nodes=list(self.hidden_nodes),
            activations=list(self.activations), output_dim=1,
            output_activation="linear")


def init_params(key: prng.Key, spec: WDLModelSpec) -> Params:
    """One member's initial params as float32 host tensors, drawn from the
    reference's keys: ``split(key, C + 2)``, column ``i``'s embedding
    ``normal(keys[i]) * embed_dim^-0.5``, the deep stack's He init under
    ``keys[-2]``; wide weights and the bias start at zero."""
    n_cat = len(spec.cat_cardinalities)
    keys = prng.split(key, n_cat + 2)
    rows = int(sum(spec.cat_cardinalities))
    params: Params = {}
    if spec.deep_enable:
        scale = float(np.float32(spec.embed_dim ** -0.5))
        tabs = [prng.normal_f32(keys[i], card * spec.embed_dim) * scale
                for i, card in enumerate(spec.cat_cardinalities)]
        params["embed"] = (torch.cat(tabs) if tabs else torch.zeros(0)
                           ).reshape(rows, spec.embed_dim)
        params["deep"] = nn_model.init_params(keys[-2], spec.deep_spec(),
                                              "he")
    if spec.wide_enable:
        params["wide_cat"] = torch.zeros(rows, dtype=torch.float32)
        params["wide_num"] = torch.zeros((spec.numeric_dim, 1),
                                         dtype=torch.float32)
    params["bias"] = torch.zeros(1, dtype=torch.float32)
    return params


def columns_of(spec: WDLModelSpec, params: Params) -> Dict[str, Any]:
    """The reference's per-column layout of one member's params, as numpy
    arrays: ``embed`` and ``wide_cat`` become lists of per-column
    tables (bf16 widened, which is exact)."""
    off = spec.row_offsets()

    def host(t):
        return np.asarray(t.detach().float().cpu().numpy()
                          if isinstance(t, torch.Tensor) else t, np.float32)

    out: Dict[str, Any] = {"bias": host(params["bias"])}
    if "embed" in params:
        e = host(params["embed"])
        out["embed"] = [e[off[c]:off[c + 1]] for c in range(len(off) - 1)]
        out["deep"] = [{k: host(layer[k]) for k in ("w", "b")}
                       for layer in params["deep"]]
    if "wide_cat" in params:
        w = host(params["wide_cat"])
        out["wide_cat"] = [w[off[c]:off[c + 1]] for c in range(len(off) - 1)]
        out["wide_num"] = host(params["wide_num"])
    return out


def from_columns(spec: WDLModelSpec, cols: Dict[str, Any]) -> Params:
    """Inverse of :func:`columns_of`: per-column arrays (this package's,
    or the reference's params through ``np.asarray``) as the flat float32
    host tensors."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    params: Params = {"bias": t(cols["bias"]).reshape(1)}
    if spec.deep_enable:
        tabs = [np.asarray(a, np.float32).reshape(-1, spec.embed_dim)
                for a in cols["embed"]]
        params["embed"] = t(np.concatenate(tabs) if tabs else
                            np.zeros((0, spec.embed_dim), np.float32))
        params["deep"] = [{"w": t(layer["w"]), "b": t(layer["b"])}
                          for layer in cols["deep"]]
    if spec.wide_enable:
        wc = [np.asarray(a, np.float32).reshape(-1) for a in cols["wide_cat"]]
        params["wide_cat"] = t(np.concatenate(wc) if wc else np.zeros(0))
        params["wide_num"] = t(cols["wide_num"]).reshape(spec.numeric_dim, 1)
    return params


# ---------------------------------------------------------------- forward
def id_bounds(spec: WDLModelSpec, device) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(each column's last id, its first row in the flat tables), [C]
    int64 on ``device``."""
    off = spec.row_offsets()
    return (torch.as_tensor(np.diff(off) - 1, device=device),
            torch.as_tensor(off[:-1], device=device))


def global_ids(spec: WDLModelSpec, x_cat: torch.Tensor,
               bounds=None) -> torch.Tensor:
    """[N, C] int64 rows of the flat tables: each bin id clipped into its
    column (``clip(id, 0, card - 1)``, as the reference's gather clips),
    then offset to the column's first row.  ``bounds`` are
    :func:`id_bounds` on ``x_cat``'s device, made here when not given."""
    top, start = bounds if bounds is not None else \
        id_bounds(spec, x_cat.device)
    return torch.minimum(x_cat.long().clamp_min(0), top) + start


def _lookup(table: torch.Tensor, ids: torch.Tensor, stacked: bool
            ) -> torch.Tensor:
    """Rows ``ids`` [N, C] of a flat table ([R, E] or a wide [R]; with a
    leading member axis when ``stacked``) -> [N, C, E] / [N, C], or [B,
    N, C, ...]: one ``F.embedding`` (a gather, whose backward is one
    deterministic accumulate); a stacked table is gathered as one [B·R,
    E] table."""
    vector = table.dim() == (2 if stacked else 1)
    if vector:
        table = table.unsqueeze(-1)
    if stacked:
        b, rows = table.shape[0], table.shape[1]
        shift = torch.arange(b, device=ids.device).reshape(b, 1, 1) * rows
        out = F.embedding(ids.unsqueeze(0) + shift,
                          table.reshape(b * rows, table.shape[-1]))
    else:
        out = F.embedding(ids, table)
    return out.squeeze(-1) if vector else out


def forward_logits(params: Params, spec: WDLModelSpec, x_num: torch.Tensor,
                   x_cat: torch.Tensor) -> torch.Tensor:
    """Logits [N, 1] (or [B, N, 1] for stacked params) from the numerics
    ``x_num`` [N, numeric_dim] and the bin ids ``x_cat`` [N, C] (bucket
    ids for hashed columns: see :func:`apply_hash_device`)."""
    ids = global_ids(spec, x_cat) if spec.cat_cardinalities else None
    return logits_from_ids(params, spec, x_num, ids,
                           x_num.shape[0] if spec.numeric_dim
                           else x_cat.shape[0])


def logits_from_ids(params: Params, spec: WDLModelSpec,
                    x_num: torch.Tensor, ids: Optional[torch.Tensor],
                    n: int) -> torch.Tensor:
    """:func:`forward_logits` over the flat tables' row ids
    (:func:`global_ids`; a trainer maps its plane once): the lookups, then
    :func:`logits_from_rows`."""
    stacked = params["bias"].dim() == 2
    emb = wrows = None
    if ids is not None:
        if spec.deep_enable:
            emb = _lookup(params["embed"], ids, stacked)       # [.., N, C, E]
        if spec.wide_enable:
            wrows = _lookup(params["wide_cat"], ids, stacked)  # [.., N, C]
    return logits_from_rows(params, spec, x_num, emb, wrows, n)


def logits_from_rows(params: Params, spec: WDLModelSpec,
                     x_num: torch.Tensor, emb: Optional[torch.Tensor],
                     wrows: Optional[torch.Tensor], n: int) -> torch.Tensor:
    """The dense half of the forward over rows already looked up: ``emb``
    [.., N, C, E] and ``wrows`` [.., N, C] (None without categorical
    columns or without that side).  Every lookup (replicated, row-sharded
    or a serving copy) feeds this one function, so their arithmetic is the
    same op for op.

    The compute dtype follows the tables (the bf16/mixed ladder casts the
    whole tree): lookups, numerics and hidden activations run narrow, the
    logit sums in float32."""
    n_cat = len(spec.cat_cardinalities)
    stacked = params["bias"].dim() == 2
    tab = params.get("embed") if spec.deep_enable else params.get("wide_cat")
    cdt = tab.dtype if tab is not None else torch.float32
    if cdt != torch.float32 and spec.numeric_dim:
        x_num = x_num.to(cdt)
    bias = params["bias"].float()
    logit = bias.unsqueeze(-2) if stacked else bias   # [B, 1, 1] or [1]
    lead = (params["bias"].shape[0],) if stacked else ()
    if spec.deep_enable:
        parts = []
        if spec.numeric_dim:
            parts.append(x_num.expand(*lead, n, spec.numeric_dim))
        if n_cat:
            parts.append(emb.reshape(*lead, n, n_cat * spec.embed_dim))
        h = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
        acts = [nn_model.activation(a) for a in spec.activations]
        for li, layer in enumerate(params["deep"][:-1]):
            h = acts[li % len(acts)](nn_model._dense(h, layer, None))
        logit = logit + nn_model._dense(h, params["deep"][-1], None)
    if spec.wide_enable:
        wide = None
        if n_cat:
            # left to right, as the reference's column loop adds
            wide = torch.cumsum(wrows.float(), dim=-1)[..., -1:]
        if spec.numeric_dim:
            lin = torch.matmul(x_num, params["wide_num"])
            wide = lin.float() if wide is None else wide + lin
        if wide is not None:
            logit = logit + wide
    return logit


def forward(params: Params, spec: WDLModelSpec, x_num, x_cat):
    return torch.sigmoid(forward_logits(params, spec, x_num, x_cat))


# ---------------------------------------------------------- hashed IDs
def hash_plan(spec: WDLModelSpec):
    """(buckets, [(col_pos, key64), ...]) from the spec's hashed-ID plan,
    or None when the spec has no hashed columns.  The plan is recorded in
    ``spec.extra`` at train time so serving replays the same map."""
    buckets = int(spec.extra.get("hash_buckets", 0) or 0)
    cols = spec.extra.get("hashed_cols") or []
    keys = spec.extra.get("hash_keys") or []
    if buckets <= 0 or not cols:
        return None
    return buckets, [(int(c), int(k)) for c, k in zip(cols, keys)]


def apply_hash_host(spec: WDLModelSpec, x_cat: np.ndarray) -> np.ndarray:
    """Map the hashed-ID columns of a host [N, C] bin matrix into bucket
    space (identity when the spec has no hash plan).  Not idempotent:
    exactly one layer calls it on each path (the trainers, and
    :meth:`IndependentWDLModel.compute`)."""
    plan = hash_plan(spec)
    if plan is None:
        return x_cat
    from ..ops import hashing
    buckets, cols = plan
    out = np.array(x_cat, np.int32, copy=True)
    for c, key in cols:
        out[:, c] = hashing.hash_bucket_host(x_cat[:, c], key, buckets)
    return out


def hash_plan_on(spec: WDLModelSpec, device):
    """:func:`hash_plan` as (buckets, column positions, int64 keys) with
    the positions and keys on ``device``, or None."""
    plan = hash_plan(spec)
    if plan is None:
        return None
    from ..ops import hashing
    buckets, cols = plan
    return (buckets, torch.tensor([c for c, _ in cols], device=device),
            torch.tensor([hashing._i64(k) for _, k in cols], device=device))


def apply_hash_device(spec: WDLModelSpec, x_cat: torch.Tensor,
                      plan=None) -> torch.Tensor:
    """:func:`apply_hash_host` on the tensor's device, bit-identical: every
    hashed column in one vectorised splitmix64 (its per-column keys as
    a row vector).  ``plan`` is :func:`hash_plan_on` on that device, made
    here when not given."""
    plan = plan if plan is not None else hash_plan_on(spec, x_cat.device)
    if plan is None:
        return x_cat
    from ..ops import hashing
    buckets, pos, keys = plan
    out = x_cat.clone()
    out[:, pos] = hashing.hash_bucket_device(x_cat[:, pos], keys,
                                             buckets).to(out.dtype)
    return out


# ------------------------------------------------------------------ loss
def per_row_bce(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Clipped binary cross-entropy per row: p, y [..., N, 1] -> [..., N].
    The one definition of the WDL loss (resident, streamed, eval sums)."""
    return -(y * torch.log(torch.clamp(p, 1e-7, 1.0))
             + (1 - y) * torch.log(torch.clamp(1 - p, 1e-7, 1.0))).sum(-1)


def _l2_sum(params: Params) -> torch.Tensor:
    """Sum of squares of the deep weights and the embedding tables, per
    member for stacked params (bias and wide terms are not penalised)."""
    stacked = params["bias"].dim() == 2
    dims = (lambda t: tuple(range(1, t.dim()))) if stacked else \
        (lambda t: tuple(range(t.dim())))
    reg = 0.0
    for layer in params.get("deep", []):
        reg = reg + (layer["w"] ** 2).sum(dim=dims(layer["w"]))
    if "embed" in params:
        reg = reg + (params["embed"] ** 2).sum(dim=dims(params["embed"]))
    return reg


def weighted_loss(params: Params, spec: WDLModelSpec, x_num, x_cat, y, w,
                  l2: float = 0.0):
    """Mean weighted log loss plus ``l2`` times the squares of the deep
    weights and embeddings: a scalar, or [B] for stacked params."""
    p = forward(params, spec, x_num, x_cat)
    per = per_row_bce(p, y)
    loss = (per * w).sum(-1) / torch.clamp(w.sum(-1), min=1e-9)
    if l2:
        loss = loss + l2 * _l2_sum(params)
    return loss


def l2_grads(params: Params, l2: float) -> Params:
    """Gradient of :func:`weighted_loss`'s L2 term: ``2·l2·w`` on the deep
    weights and the embedding tables, zero elsewhere."""
    from ..train.optimizers import tree_map
    g = tree_map(torch.zeros_like, params)
    for i, layer in enumerate(params.get("deep", [])):
        g["deep"][i]["w"] = 2.0 * l2 * layer["w"]
    if "embed" in params:
        g["embed"] = 2.0 * l2 * params["embed"]
    return g


# ------------------------------------------------------------- save/load
def save_model(path: str, spec: WDLModelSpec, params: Params) -> None:
    """The reference's ``.wdl`` npz: the spec json, ``bias``, per-column
    ``emb{i}``/``wc{i}``, ``dw{i}``/``db{i}`` and ``wn``, float32."""
    cols = columns_of(spec, params)
    arrays = {"__spec__": np.frombuffer(spec.to_json().encode(), np.uint8),
              "bias": cols["bias"]}
    if spec.deep_enable:
        for i, t in enumerate(cols["embed"]):
            arrays[f"emb{i}"] = t
        for i, layer in enumerate(cols["deep"]):
            arrays[f"dw{i}"] = layer["w"]
            arrays[f"db{i}"] = layer["b"]
    if spec.wide_enable:
        for i, t in enumerate(cols["wide_cat"]):
            arrays[f"wc{i}"] = t
        arrays["wn"] = cols["wide_num"]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    ioutil.atomic_write_bytes(path, buf.getvalue())


def load_model(path: str) -> Tuple[WDLModelSpec, Params]:
    data = np.load(path)
    spec = WDLModelSpec.from_json(bytes(data["__spec__"]).decode())
    n_cat = len(spec.cat_cardinalities)
    cols: Dict[str, Any] = {"bias": data["bias"]}
    if spec.deep_enable:
        cols["embed"] = [data[f"emb{i}"] for i in range(n_cat)]
        cols["deep"] = []
        i = 0
        while f"dw{i}" in data:
            cols["deep"].append({"w": data[f"dw{i}"], "b": data[f"db{i}"]})
            i += 1
    if spec.wide_enable:
        cols["wide_cat"] = [data[f"wc{i}"] for i in range(n_cat)]
        cols["wide_num"] = data["wn"]
    return spec, from_columns(spec, cols)


class IndependentWDLModel:
    """Standalone scorer (reference ``IndependentWDLModel.java``): reads
    both planes, the normalized numerics and the categorical bin ids."""

    input_kind = "both"

    def __init__(self, spec: WDLModelSpec, params: Params):
        self.spec = spec
        self.params = params
        self._on: Dict[torch.device, tuple] = {}

    @classmethod
    def load(cls, path: str) -> "IndependentWDLModel":
        return cls(*load_model(path))

    def on(self, device: torch.device) -> tuple:
        """(params, id bounds, hash plan) on ``device``, copied there
        once, so a forward there copies nothing from the host."""
        if device not in self._on:
            from ..train.optimizers import tree_map
            self._on[device] = (
                tree_map(lambda t: t.to(device), self.params),
                id_bounds(self.spec, device),
                hash_plan_on(self.spec, device))
        return self._on[device]

    def forward_device(self, x_num: torch.Tensor,
                       x_cat: torch.Tensor) -> torch.Tensor:
        """[N, 1] scores from device tensors: hashed columns fold on the
        device, then one forward."""
        params, bounds, plan = self.on(x_cat.device)
        x_cat = apply_hash_device(self.spec, x_cat, plan)
        ids = global_ids(self.spec, x_cat, bounds) \
            if self.spec.cat_cardinalities else None
        with torch.no_grad():
            return torch.sigmoid(logits_from_ids(
                params, self.spec, x_num.float(), ids, len(x_cat)))

    def compute(self, x_num, x_cat, device=None) -> np.ndarray:
        """[N, 1] f32 scores; tensors score on their device, host arrays
        on ``device`` (default CUDA)."""
        if isinstance(x_cat, torch.Tensor) and device is None:
            dev = x_cat.device
        else:
            dev = resolve_device(device)
        xn = torch.as_tensor(np.asarray(x_num, np.float32)
                             if not isinstance(x_num, torch.Tensor)
                             else x_num).to(dev)
        xc = torch.as_tensor(np.asarray(x_cat, np.int64)
                             if not isinstance(x_cat, torch.Tensor)
                             else x_cat).to(dev)
        return self.forward_device(xn, xc).cpu().numpy()

    def compute_full(self, x, bins, device=None) -> np.ndarray:
        """Score from the full transform planes: this model's numeric
        feature block and categorical bin columns (indices recorded at
        train time in the spec)."""
        nf = self.spec.extra.get("num_feat_idx", [])
        cf = self.spec.extra.get("cat_col_idx", [])
        n = len(x) if x is not None else len(bins)
        if isinstance(bins, torch.Tensor) or isinstance(x, torch.Tensor):
            dev = (bins if isinstance(bins, torch.Tensor) else x).device
            x_num = x[:, nf] if nf else torch.zeros((n, 0), device=dev)
            x_cat = bins[:, cf].long() if cf else \
                torch.zeros((n, 0), dtype=torch.int64, device=dev)
            return self.forward_device(x_num, x_cat).cpu().numpy()
        x_num = x[:, nf] if nf else np.zeros((n, 0), np.float32)
        x_cat = bins[:, cf] if cf else np.zeros((n, 0), np.int32)
        return self.compute(x_num, x_cat, device=device)
