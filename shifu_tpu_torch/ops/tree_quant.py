"""Quantized tree-traversal scoring: forests walked directly on narrow bin
planes, f32 only at the leaf-value select — the port of
``shifu_tpu.ops.tree_quant``.

Two versions of one function, :func:`predict_forest_quant`:

- the CUDA kernel ``csrc/tree_traverse.cu`` (hand-written for Hopper,
  replacing the Pallas kernel ``_traverse_kernel``), taken for every CUDA
  tensor; a CUDA input it cannot take raises, it never falls back;
- the plain PyTorch version :func:`predict_forest_quant_ref` — the narrow
  gather walk of the reference's jnp fallback — taken for CPU tensors
  only.  It is the CPU path and the kernel's oracle on the card.

Bins ride uint8 (forests of <= 256 bins, the wire dtype) or int32 (wider
forests, where the reference walks the classic int32 gather path of
``ops/tree.py`` instead of its kernel).  Routing is integer end to end and
the leaf is one select, so per-tree outputs of the two versions (and of
every reference lowering) are equal bit for bit.  Out-of-range bin ids
clamp to ``n_bins - 1`` in both versions, as the reference's gather
fallback does.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from .tree import n_tree_nodes


def bins_fit_uint8(n_bins: int) -> bool:
    """Whether a forest's bin ids ride uint8 (ids in [0, n_bins))."""
    return n_bins <= 256


def ensemble_bins_dtype(models: Sequence) -> torch.dtype:
    """The narrowest dtype an ensemble's bins input can ride: the widest of
    its forests' ``bins_dtype`` (uint8 when every id space fits a byte,
    else int32).  The kernel and the plain version take either."""
    if any(m.bins_dtype == torch.int32 for m in models):
        return torch.int32
    return torch.uint8


# ------------------------------------------------------------ forest prep
def stack_forest_quant(trees, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Same-depth trees stacked in the quantized layout: split_feat
    [T, K] int32, left-mask planes [T, K, B] uint8 (1 = bin goes left),
    leaf values [T, K] (or [T, K, S] multiclass) f32."""
    sf = np.stack([np.asarray(t.split_feat, np.int32) for t in trees])
    lm = np.stack([np.asarray(t.left_mask, np.uint8) for t in trees])
    lv = np.stack([np.asarray(t.leaf_value, np.float32) for t in trees])
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (sf, lm, lv))


# ------------------------------------------------------- plain version
def _walk(split_feats, left_u8s, bins, depth: int) -> torch.Tensor:
    """[T, N] terminal node ids: every tree's narrow gather walk at once."""
    t, k = split_feats.shape
    n, c = bins.shape
    b = left_u8s.shape[2]
    dev = bins.device
    sf = split_feats.long()
    lm = left_u8s.reshape(-1)
    rows = torch.arange(n, device=dev)[None, :]
    tree_base = (torch.arange(t, device=dev) * k)[:, None]
    node = torch.zeros((t, n), dtype=torch.long, device=dev)
    for _ in range(depth):
        feat = sf.gather(1, node)
        row_bin = bins[rows, feat.clamp(0, c - 1)].long().clamp_(0, b - 1)
        goes_left = lm[(tree_base + node) * b + row_bin] > 0
        child = torch.where(goes_left, 2 * node + 1, 2 * node + 2)
        node = torch.where(feat >= 0, child, node)
    return node


def traverse_quant(split_feat, left_u8, bins, depth: int) -> torch.Tensor:
    """Terminal global node id per row for ONE tree: split_feat [K] int32,
    left_u8 [K, B] uint8, bins [N, C] uint8 or int32 (read as is)."""
    return _walk(split_feat[None], left_u8[None], bins, depth)[0]


def predict_forest_quant_ref(split_feats, left_u8s, leaf_values, bins,
                             depth: int) -> torch.Tensor:
    """[T, N] (or [T, N, S]) forest predictions — the plain version."""
    node = _walk(split_feats, left_u8s, bins, depth)
    if leaf_values.dim() == 2:
        return leaf_values.gather(1, node)
    trees = torch.arange(node.shape[0], device=node.device)[:, None]
    return leaf_values[trees, node]


# ------------------------------------------------------------ the kernel
def _check(name: str, a: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if a.device != device or a.dtype != dtype or a.dim() != ndim \
            or not a.is_contiguous():
        raise ValueError(
            f"tree_traverse kernel: {name} must be a contiguous {ndim}-D "
            f"{dtype} tensor on {device}, got {tuple(a.shape)} {a.dtype} "
            f"on {a.device}{'' if a.is_contiguous() else ' (strided)'}")


def _predict_quant_cuda(split_feats, left_u8s, leaf_values, bins,
                        depth: int) -> torch.Tensor:
    """Validate, allocate the [T, N] output and launch ``tree_traverse``
    on the current stream."""
    dev = bins.device
    _check("bins", bins, torch.int32 if bins.dtype == torch.int32
           else torch.uint8, 2, dev)
    _check("split_feats", split_feats, torch.int32, 2, dev)
    _check("left_u8s", left_u8s, torch.uint8, 3, dev)
    _check("leaf_values", leaf_values, torch.float32, 2, dev)
    t, k = split_feats.shape
    n, c = bins.shape
    b = left_u8s.shape[2]
    if tuple(left_u8s.shape[:2]) != (t, k) \
            or tuple(leaf_values.shape) != (t, k):
        raise ValueError(f"tree_traverse kernel: forest arrays disagree: "
                         f"split_feats {tuple(split_feats.shape)}, "
                         f"left_u8s {tuple(left_u8s.shape)}, leaf_values "
                         f"{tuple(leaf_values.shape)}")
    if depth < 0 or k < n_tree_nodes(depth) or c == 0 or b == 0:
        raise ValueError(f"tree_traverse kernel: depth {depth} needs "
                         f"{n_tree_nodes(depth)} nodes per tree (have {k}), "
                         f"and bins/masks must be non-empty ({c} columns, "
                         f"{b} bins)")
    out = torch.empty((t, n), dtype=torch.float32, device=dev)
    if n == 0 or t == 0:
        return out
    from . import cuda_lib
    fn = cuda_lib.load("tree_traverse").shifu_tree_traverse
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 \
        + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(bins.data_ptr(), bins.element_size(), split_feats.data_ptr(),
                left_u8s.data_ptr(), leaf_values.data_ptr(), out.data_ptr(),
                n, c, t, k, b, depth, stream)
    if rc != 0:
        raise RuntimeError(f"tree_traverse kernel launch failed "
                           f"(cudaError_t {rc})")
    predict_forest_quant.launches += 1
    return out


def predict_forest_quant(split_feats, left_u8s, leaf_values, bins,
                         depth: int) -> torch.Tensor:
    """[T, N] forest predictions over a uint8 or int32 bin plane: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.
    ``launches`` counts kernel launches (never plain-version calls)."""
    if bins.device.type == "cpu":
        return predict_forest_quant_ref(split_feats, left_u8s, leaf_values,
                                        bins, depth)
    if bins.device.type != "cuda":
        raise ValueError(f"predict_forest_quant: no kernel for device "
                         f"{bins.device}")
    if leaf_values.dim() != 2:
        raise NotImplementedError(
            "multiclass [T, K, S] leaves have no CUDA kernel yet — score "
            "them with predict_forest_quant_ref")
    return _predict_quant_cuda(split_feats, left_u8s, leaf_values, bins,
                               depth)


predict_forest_quant.launches = 0


# -------------------------------------------------- analytic cost model
def quant_traverse_cost(rows: int, n_feat: int, n_bins: int,
                        n_nodes: int, depth: int,
                        n_trees: int = 1) -> dict:
    """FLOPs / bytes of one traversal launch — the reference's analytic
    model, copied as is.

    Per (tree, level k-wide): the feature dot (2*k*N), the feature
    one-hot + bin select (~3*C*N), the mask dot (2*k*B*N) and the bin
    membership reduce (~3*B*N); plus the terminal leaf dot (2*K*N) — the
    TPU kernel's one-hot formulation, not the CUDA kernel's gathers.
    Bytes: the uint8 bins plane read ONCE, every node's arrays and mask
    row once, [T, N] f32 out written once — more than a walk reads, which
    :func:`traverse_bytes` counts for given data."""
    lv_flops = 0.0
    for level in range(depth):
        k = 1 << level
        lv_flops += 2.0 * k + 3.0 * n_feat + 2.0 * k * n_bins \
            + 3.0 * n_bins
    flops = float(rows) * n_trees * (lv_flops + 2.0 * n_nodes)
    read = 1.0 * rows * n_feat \
        + n_trees * (4.0 * n_nodes + 1.0 * n_nodes * n_bins
                     + 4.0 * n_nodes)
    write = 4.0 * n_trees * rows
    return {"flops": flops, "bytes_accessed": read + write}


def traverse_bytes(split_feats, left_u8s, bins, depth: int) -> dict:
    """What one traversal launch must move for THIS data, each element
    read once: the bins some walk reads, the split feature of every node a
    walk visits, the left-mask entries the walks look up, the leaf value of
    every terminal node, and the [T, N] f32 output; plus the split steps
    taken over all (tree, row) pairs.  Unlike :func:`quant_traverse_cost`
    it charges nothing that no row reaches."""
    t, k = split_feats.shape
    n, c = bins.shape
    b = left_u8s.shape[2]
    dev = bins.device
    sf = split_feats.long()
    lm = left_u8s.reshape(-1)
    rows = torch.arange(n, device=dev)[None, :]
    tree_base = (torch.arange(t, device=dev) * k)[:, None]
    node = torch.zeros((t, n), dtype=torch.long, device=dev)
    live = torch.ones((t, n), dtype=torch.bool, device=dev)
    read_sf = torch.zeros(t * k, dtype=torch.bool, device=dev)
    read_lm = torch.zeros(t * k * b, dtype=torch.bool, device=dev)
    read_bins = torch.zeros(n * c, dtype=torch.bool, device=dev)
    steps = torch.zeros((), dtype=torch.long, device=dev)
    for _ in range(depth):
        gid = tree_base + node
        read_sf[gid[live]] = True
        feat = sf.gather(1, node)
        live &= feat >= 0                   # a leaf stops its walk for good
        col = feat.clamp(0, c - 1)
        read_bins[(rows * c + col)[live]] = True
        key = gid * b + bins[rows, col].long().clamp_(0, b - 1)
        read_lm[key[live]] = True
        child = torch.where(lm[key] > 0, 2 * node + 1, 2 * node + 2)
        node = torch.where(live, child, node)
        steps += live.sum()
    read_lv = torch.zeros(t * k, dtype=torch.bool, device=dev)
    read_lv[(tree_base + node).reshape(-1)] = True
    nbytes = int(read_bins.sum()) * bins.element_size() \
        + int(read_sf.sum()) * 4 + int(read_lm.sum()) \
        + int(read_lv.sum()) * 4 + 4 * t * n
    return {"bytes": nbytes, "split_steps": int(steps)}
