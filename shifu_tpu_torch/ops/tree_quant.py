"""Quantized tree-traversal scoring: forests walked directly on narrow bin
planes, f32 only at the leaf-value select — the port of
``shifu_tpu.ops.tree_quant``.

Two versions of one function, :func:`predict_forest_quant`:

- the CUDA kernel ``csrc/tree_traverse.cu`` (hand-written for Hopper,
  replacing the Pallas kernel ``_traverse_kernel``), taken for every CUDA
  tensor; a CUDA input it cannot take raises, it never falls back.  For
  masks of <= 256 bins it walks the forest's packed form
  (:func:`pack_forest`: one record of bitset and split feature a node,
  staged in shared memory), which a caller that pins a forest on the card
  builds once and passes in; without it the wrapper packs on the fly.
  Wider masks take the kernel's wide path over the uint8 masks.
  Multi-class leaves ([T, K, S] class distributions) take the node-index
  walk: the kernel runs over the forest with every leaf value replaced by
  its node's index (exact in f32 up to 2^24 nodes; the leaf is a pure
  select), and the [T, K, S] leaves are gathered at those indices on the
  device (the reference gathers ``lv[traverse_quant(...)]`` likewise);
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
import functools
import threading
from typing import NamedTuple, Optional, Sequence, Tuple

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


# ---------------------------------------------------------- packed form
class PackedForest(NamedTuple):
    """A forest in the layout the kernel's packed path walks: ``records``
    [T, n_int, words] int32 — for each of the first n_int = 2^depth - 1
    nodes (deeper nodes are never split) its left mask as a bitset of w32
    32-bit words (bit b of word j: bin 32 * j + b goes left), then its
    split feature, padded to a multiple of four words — and ``leaves``
    [T, 2^(depth + 1) - 1] f32, the values a walk can end on."""
    records: torch.Tensor
    leaves: torch.Tensor
    depth: int
    n_bins: int


#: the deepest forest the packed path takes (the kernel's limit); deeper
#: ones walk their arrays as they are
MAX_PACKED_DEPTH = 24


def mask_words(n_bins: int) -> int:
    """32-bit bitset words of a packed node: 2 up to 64 bins, 4 up to 128,
    8 up to 256."""
    return 2 if n_bins <= 64 else 4 if n_bins <= 128 else 8


#: the most nodes a tree may have for the node-index walk: node ids ride
#: the kernel's f32 leaf values, exact up to 2^24
MAX_INDEX_NODES = 1 << 24


def node_index_leaves(split_feats) -> torch.Tensor:
    """[T, K] f32 leaf values that are each node's own index — the forest
    the node-index walk of multi-class leaves runs the kernel over."""
    t, k = split_feats.shape
    if k > MAX_INDEX_NODES:
        raise ValueError(f"tree_traverse kernel: the node-index walk takes "
                         f"trees of at most {MAX_INDEX_NODES} nodes, got {k}")
    return torch.arange(k, dtype=torch.float32,
                        device=split_feats.device).expand(t, k).contiguous()


def gather_leaves(leaf_values, node) -> torch.Tensor:
    """[T, N, S] class distributions at the terminal nodes ``node`` [T, N]
    (integer, or the node-index walk's f32 ids) of leaves [T, K, S]."""
    trees = torch.arange(node.shape[0], device=node.device)[:, None]
    return leaf_values[trees, node.long()]


def pack_forest(split_feats, left_u8s, leaf_values,
                depth: int) -> Optional[PackedForest]:
    """The packed form of a stacked forest (``stack_forest_quant``'s
    arrays), built with tensor ops on the arrays' device; None where the
    kernel walks the arrays as they are (masks wider than 256 bins, depth
    past :data:`MAX_PACKED_DEPTH`).  A forest with multi-class leaves
    [T, K, S] packs for the node-index walk: its packed leaves are the
    node ids (:func:`node_index_leaves`), and the caller gathers the
    class distributions (:func:`gather_leaves`)."""
    t, k = split_feats.shape
    b = left_u8s.shape[2]
    if leaf_values.dim() == 3:
        leaf_values = node_index_leaves(split_feats)
    if b > 256 or not 0 <= depth <= MAX_PACKED_DEPTH \
            or k < n_tree_nodes(depth):
        return None
    dev = split_feats.device
    w32 = mask_words(b)
    words = (w32 + 1 + 3) // 4 * 4
    n_int = max(1, (1 << depth) - 1)
    bits = torch.zeros((t, n_int, w32 * 32), dtype=torch.bool, device=dev)
    bits[:, :, :b] = left_u8s[:, :n_int] != 0
    bits = bits.view(t, n_int, w32, 32)
    rec = torch.zeros((t, n_int, words), dtype=torch.int64, device=dev)
    for j in range(32):                   # bit j of every mask word
        rec[..., :w32] |= bits[..., j].long() << j
    rec[..., w32] = split_feats[:, :n_int].long()
    rec = torch.where(rec >= 1 << 31, rec - (1 << 32), rec)   # as int32
    leaves = leaf_values[:, :n_tree_nodes(depth)].float().contiguous()
    return PackedForest(rec.to(torch.int32).contiguous(), leaves, depth, b)


def forest_walk_ref(packed: PackedForest, bins) -> torch.Tensor:
    """[T, N] predictions walked over the packed form — the plain version
    of the kernel's packed path, equal bit for bit to
    :func:`predict_forest_quant_ref` on the arrays it was packed from."""
    rec = packed.records.long() & 0xFFFFFFFF
    t, n_int, _ = rec.shape
    n, c = bins.shape
    w32 = mask_words(packed.n_bins)
    dev = bins.device
    rows = torch.arange(n, device=dev)[None, :]
    trees = torch.arange(t, device=dev)[:, None]
    node = torch.zeros((t, n), dtype=torch.long, device=dev)
    feat_all = packed.records[..., w32].long()
    for _ in range(packed.depth):
        feat = feat_all[trees, node]
        b = bins[rows, feat.clamp(0, c - 1)].long() \
            .clamp(0, packed.n_bins - 1)
        word = rec[trees, node, b >> 5]
        child = 2 * node + 2 - ((word >> (b & 31)) & 1)
        node = torch.where(feat >= 0, child, node)
    return packed.leaves.gather(1, node)


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
    return gather_leaves(leaf_values, node)


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
                        depth: int, packed: Optional[PackedForest]
                        ) -> torch.Tensor:
    """Validate, allocate the [T, N] output and launch ``tree_traverse``
    on the current stream: the packed path for masks of <= 256 bins (the
    forest packed here unless ``packed`` is given), else the wide path."""
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
    if packed is None:
        packed = pack_forest(split_feats, left_u8s, leaf_values, depth)
    if packed is not None:
        want = (t, max(1, (1 << depth) - 1),
                (mask_words(b) + 1 + 3) // 4 * 4)
        if packed.depth != depth or packed.n_bins != b \
                or tuple(packed.records.shape) != want \
                or tuple(packed.leaves.shape) != (t, n_tree_nodes(depth)):
            raise ValueError(f"tree_traverse kernel: the packed forest "
                             f"(depth {packed.depth}, {packed.n_bins} bins, "
                             f"records {tuple(packed.records.shape)}) is "
                             f"not this forest's (depth {depth}, {b} bins, "
                             f"{t} trees)")
        _check("packed.records", packed.records, torch.int32, 3, dev)
        _check("packed.leaves", packed.leaves, torch.float32, 2, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if packed is not None:
            rc = lib.shifu_forest_walk(
                bins.data_ptr(), bins.element_size(),
                packed.records.data_ptr(), packed.leaves.data_ptr(),
                out.data_ptr(), n, c, t, b, depth, stream)
        else:
            rc = lib.shifu_tree_traverse(
                bins.data_ptr(), bins.element_size(), split_feats.data_ptr(),
                left_u8s.data_ptr(), leaf_values.data_ptr(), out.data_ptr(),
                n, c, t, k, b, depth, stream)
    if rc != 0:
        raise RuntimeError(f"tree_traverse kernel launch failed "
                           f"(cudaError_t {rc})")
    _count_launch()
    return out


# launches this thread recorded into a CUDA graph (``n``: a graph capture
# launches nothing, the replay does and the replayer counts it) and made
# eagerly (``eager``)
_captured = threading.local()


def _count_launch() -> None:
    if torch.cuda.is_current_stream_capturing():
        _captured.n = getattr(_captured, "n", 0) + 1
    else:
        _captured.eager = getattr(_captured, "eager", 0) + 1
        predict_forest_quant.launches += 1


def captured_launches() -> int:
    """Kernel launches this thread has recorded into CUDA graphs so far: a
    graph's share is the difference across its capture."""
    return getattr(_captured, "n", 0)


def eager_launches() -> int:
    """Kernel launches this thread has made eagerly so far (each also
    counted in ``predict_forest_quant.launches``)."""
    return getattr(_captured, "eager", 0)


def count_replays(n: int) -> None:
    """Count ``n`` kernel launches made by replaying a captured graph (a
    replay runs the launches its capture recorded)."""
    predict_forest_quant.launches += n


@functools.cache
def _lib():
    from . import cuda_lib
    lib = cuda_lib.load("tree_traverse")
    lib.shifu_tree_traverse.restype = ctypes.c_int
    lib.shifu_tree_traverse.argtypes = [ctypes.c_void_p, ctypes.c_int] \
        + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.shifu_forest_walk.restype = ctypes.c_int
    lib.shifu_forest_walk.argtypes = [ctypes.c_void_p, ctypes.c_int] \
        + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    return lib


def predict_forest_quant(split_feats, left_u8s, leaf_values, bins,
                         depth: int,
                         packed: Optional[PackedForest] = None
                         ) -> torch.Tensor:
    """[T, N] (or [T, N, S] for multi-class leaves [T, K, S]) forest
    predictions over a uint8 or int32 bin plane: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  ``packed`` is the
    forest's :func:`pack_forest` form on the card, built once by a caller
    that pins the forest (the kernel's input; the plain version does not
    read it).  Multi-class leaves launch the kernel once for the
    node-index walk and gather their distributions on the device.
    ``launches`` counts kernel launches (never plain-version calls): an
    eager launch here, a launch recorded in a CUDA graph when the graph
    replays (:func:`count_replays`), never at capture."""
    if bins.device.type == "cpu":
        return predict_forest_quant_ref(split_feats, left_u8s, leaf_values,
                                        bins, depth)
    if bins.device.type != "cuda":
        raise ValueError(f"predict_forest_quant: no kernel for device "
                         f"{bins.device}")
    if leaf_values.dim() == 3:
        if leaf_values.device != bins.device \
                or leaf_values.shape[:2] != split_feats.shape:
            raise ValueError(f"tree_traverse kernel: multi-class leaves "
                             f"{tuple(leaf_values.shape)} on "
                             f"{leaf_values.device} do not fit split_feats "
                             f"{tuple(split_feats.shape)} on {bins.device}")
        node = _predict_quant_cuda(split_feats, left_u8s,
                                   node_index_leaves(split_feats), bins,
                                   depth, packed)
        return gather_leaves(leaf_values, node)
    return _predict_quant_cuda(split_feats, left_u8s, leaf_values, bins,
                               depth, packed)


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


def traverse_bytes(split_feats, left_u8s, bins, depth: int,
                   leaf_width: int = 1) -> dict:
    """What one traversal launch must move for THIS data, each element
    read once: the bins some walk reads, the split feature of every node a
    walk visits, the left-mask entries the walks look up, the leaf value of
    every terminal node (``leaf_width`` f32 each: S for a class
    distribution), and the [T, N] (or [T, N, S]) f32 output; plus the
    split steps taken over all (tree, row) pairs.  Unlike
    :func:`quant_traverse_cost` it charges nothing that no row reaches."""
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
        + (int(read_lv.sum()) * 4 + 4 * t * n) * leaf_width
    return {"bytes": nbytes, "split_steps": int(steps)}
