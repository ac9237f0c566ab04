"""The decision-tree histogram build — the port of
``shifu_tpu.ops.hist_pallas.build_histograms_pallas`` (kernel B1), the hot
op of tree training:

    out[k, c, b, s] = sum_n [node(n) = k] * stats(n, s) * [bins(n, c) = b]

and of its tree-batched form ``build_histograms_pallas_batch`` (kernel B2,
``out[t, k, c, b, s]`` for TB trees sharing one bin plane, each tree with
its own node ids and stats; the Random Forest grows a batch of trees one
level at a time with it).

Two versions of each function, dispatched by
:func:`shifu_tpu_torch.ops.tree.build_histograms` and
:func:`~shifu_tpu_torch.ops.tree.build_histograms_batch`:

- :func:`build_histograms_cuda` launches the hand-written CUDA kernel
  ``csrc/hist.cu`` (shared-memory sub-histograms, 64-bit fixed-point
  sums, bit-identical from run to run; the source says why and how);
- :func:`build_histograms_batch_cuda` launches ``csrc/hist_batch.cu``,
  whose every tree slice is bit-identical to ``csrc/hist.cu`` on that
  tree's inputs (the same fixed point, scaled per tree and channel);
- :func:`build_histograms_ref`, the plain PyTorch version: one
  ``scatter_add_`` per column chunk into a flat float64 ``[K*C*B, S]``
  buffer, rounded to f32 at the end.  It is the CPU path and the kernel's
  oracle on the card.  Float64 keeps its own rounding error (f32
  accumulation over 10^4 rows per cell reaches ~1e-5 relative) out of the
  comparison: both versions return the f32 rounding of a near-exact sum.
  :func:`build_histograms_batch_ref` loops it over the trees, so on the
  CPU a batched build equals the sequential ones exactly.

Bins ride uint8 (<= 256 bins) or int32; a uint16 plane widens on its own
device first (:func:`widen_bins`).  Rows whose node id is outside [0, K)
and cells whose bin id is outside [0, B) contribute nothing in both.
"""

from __future__ import annotations

import ctypes

import torch

#: the elements one plain-version scatter handles at once (memory bound)
_REF_CHUNK = 1 << 24


def widen_bins(bins: torch.Tensor) -> torch.Tensor:
    """A bin plane the kernels take: uint8 and int32 as they are, any
    other integer dtype as int32 on its own device (uint16 ids are read
    through an int16 view, which every backend supports).  A non-integer
    plane is returned as it is, for the kernel's wrapper to refuse."""
    if bins.dtype in (torch.uint8, torch.int32) or bins.is_floating_point() \
            or bins.dtype == torch.bool:
        return bins
    if bins.dtype == torch.uint16:
        return bins.view(torch.int16).to(torch.int32) & 0xFFFF
    return bins.to(torch.int32)


def build_histograms_ref(bins, node_idx, stats, n_nodes: int,
                         n_bins: int) -> torch.Tensor:
    """[K, C, B, S] f32 — the plain version (see the module docstring)."""
    n, c = bins.shape
    s = stats.shape[1]
    dev = bins.device
    acc = torch.zeros((n_nodes * c * n_bins, s), dtype=torch.float64,
                      device=dev)
    node = node_idx.long()
    row_ok = (node >= 0) & (node < n_nodes)
    base = node.clamp(0, n_nodes - 1) * c
    st = stats.double()
    step = max(1, _REF_CHUNK // max(n, 1))
    for c0 in range(0, c, step):
        cols = torch.arange(c0, min(c, c0 + step), device=dev)
        b = bins[:, c0:c0 + len(cols)].long()
        ok = row_ok[:, None] & (b >= 0) & (b < n_bins)
        idx = ((base[:, None] + cols[None, :]) * n_bins
               + b.clamp(0, n_bins - 1)).reshape(-1, 1).expand(-1, s)
        src = (st[:, None, :] * ok[..., None]).reshape(-1, s)
        acc.scatter_add_(0, idx, src)
    return acc.reshape(n_nodes, c, n_bins, s).float()


def _check(name: str, a: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if a.device != device or a.dtype != dtype or a.dim() != ndim \
            or not a.is_contiguous():
        raise ValueError(
            f"hist kernel: {name} must be a contiguous {ndim}-D {dtype} "
            f"tensor on {device}, got {tuple(a.shape)} {a.dtype} on "
            f"{a.device}{'' if a.is_contiguous() else ' (strided)'}")


def build_histograms_cuda(bins, node_idx, stats, n_nodes: int,
                          n_bins: int) -> torch.Tensor:
    """Validate, allocate and launch ``csrc/hist.cu`` on the current
    stream: [K, C, B, S] f32.  No host sync: the channel scales come from
    a device-side ``amax``."""
    dev = bins.device
    _check("bins", bins, torch.int32 if bins.dtype == torch.int32
           else torch.uint8, 2, dev)
    _check("node_idx", node_idx, torch.int32, 1, dev)
    _check("stats", stats, torch.float32, 2, dev)
    n, c = bins.shape
    s = stats.shape[1]
    if node_idx.shape[0] != n or stats.shape[0] != n:
        raise ValueError(f"hist kernel: {n} rows of bins, "
                         f"{node_idx.shape[0]} node ids, {stats.shape[0]} "
                         "stat rows")
    if n_nodes < 1 or c < 1 or s < 1 or not 1 <= n_bins <= 65536:
        raise ValueError(f"hist kernel: needs K >= 1, C >= 1, S >= 1 and "
                         f"1 <= B <= 65536 (K={n_nodes}, C={c}, S={s}, "
                         f"B={n_bins})")
    total = n_nodes * c * n_bins * s
    out = torch.empty((n_nodes, c, n_bins, s), dtype=torch.float32,
                      device=dev)
    acc = torch.empty(total, dtype=torch.int64, device=dev)
    amax = stats.abs().amax(dim=0) if n else \
        torch.zeros(s, dtype=torch.float32, device=dev)
    from . import cuda_lib
    fn = cuda_lib.load("hist").shifu_hist
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(bins.data_ptr(), bins.element_size(), node_idx.data_ptr(),
                stats.data_ptr(), amax.data_ptr(), acc.data_ptr(),
                out.data_ptr(), n, c, n_nodes, n_bins, s, stream)
    if rc != 0:
        raise RuntimeError(f"hist kernel launch failed (cudaError_t {rc})")
    return out


def hist_bytes(bins, node_idx, stats, n_nodes: int, n_bins: int) -> int:
    """What one launch must move for THIS data, each element once: every
    node id, the bins and stats of the rows whose node is in [0, K), and
    the [K, C, B, S] f32 output."""
    n, c = bins.shape
    s = stats.shape[1]
    active = int(((node_idx >= 0) & (node_idx < n_nodes)).sum())
    return 4 * n + active * (c * bins.element_size() + 4 * s) \
        + 4 * n_nodes * c * n_bins * s


def build_histograms_batch_ref(bins, node_idx_b, stats_b, n_nodes: int,
                               n_bins: int) -> torch.Tensor:
    """[TB, K, C, B, S] f32 — :func:`build_histograms_ref` per tree."""
    return torch.stack([build_histograms_ref(bins, node_idx_b[t], stats_b[t],
                                             n_nodes, n_bins)
                        for t in range(node_idx_b.shape[0])])


def _batch_lib():
    from . import cuda_lib
    lib = cuda_lib.load("hist_batch")
    lib.shifu_hist_batch.restype = ctypes.c_int
    lib.shifu_hist_batch.argtypes = [ctypes.c_void_p, ctypes.c_int] \
        + [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p,
                                   ctypes.c_longlong] \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    for fn in (lib.shifu_hist_batch_workspace, lib.shifu_hist_batch_plan):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
    return lib


def hist_batch_plan(n_rows: int, n_cols: int, n_trees: int, n_nodes: int,
                    n_bins: int, n_stats: int, mode: int = -1) -> dict:
    """How ``csrc/hist_batch.cu`` tiles a launch at these shapes (for logs
    and the smoke): mode, tree/node/bin tiles, column group, row chunks,
    whether blocks write f32 directly, shared memory a block."""
    out = (ctypes.c_longlong * 8)()
    rc = _batch_lib().shifu_hist_batch_plan(n_rows, n_cols, n_trees,
                                            n_nodes, n_bins, n_stats, mode,
                                            out)
    if rc != 0:
        raise ValueError(f"hist_batch kernel: shapes not supported "
                         f"(cudaError_t {rc})")
    keys = ("shared", "tree_tile", "node_tile", "bin_tile", "col_group",
            "chunks", "direct", "smem")
    return dict(zip(keys, list(out)))


def build_histograms_batch_cuda(bins, node_idx_b, stats_b, n_nodes: int,
                                n_bins: int, mode: int = -1) -> torch.Tensor:
    """Validate, allocate and launch ``csrc/hist_batch.cu`` on the current
    stream: [TB, K, C, B, S] f32.  No host sync: the per-tree channel
    scales come from a device-side ``amax``.  ``mode`` -1 lets the kernel
    pick its layout from the shapes; 0 / 1 force partitioned / shared
    rows (A/B timing only — the result is the same bits)."""
    dev = bins.device
    _check("bins", bins, torch.int32 if bins.dtype == torch.int32
           else torch.uint8, 2, dev)
    _check("node_idx_b", node_idx_b, torch.int32, 2, dev)
    _check("stats_b", stats_b, torch.float32, 3, dev)
    n, c = bins.shape
    tb, s = stats_b.shape[0], stats_b.shape[2]
    if node_idx_b.shape != (tb, n) or stats_b.shape[1] != n:
        raise ValueError(f"hist_batch kernel: {n} rows of bins, node ids "
                         f"{tuple(node_idx_b.shape)}, stats "
                         f"{tuple(stats_b.shape)}")
    if tb < 1 or n_nodes < 1 or c < 1 or s < 1 \
            or not 1 <= n_bins <= 65536 or n >= 1 << 31:
        raise ValueError(f"hist_batch kernel: needs TB >= 1, K >= 1, C >= 1, "
                         f"S >= 1, 1 <= B <= 65536 and N < 2^31 (TB={tb}, "
                         f"K={n_nodes}, C={c}, S={s}, B={n_bins}, N={n})")
    lib = _batch_lib()
    need = ctypes.c_longlong(0)
    rc = lib.shifu_hist_batch_workspace(n, c, tb, n_nodes, n_bins, s, mode,
                                        ctypes.byref(need))
    if rc != 0:
        raise ValueError(f"hist_batch kernel: shapes not supported "
                         f"(cudaError_t {rc})")
    out = torch.empty((tb, n_nodes, c, n_bins, s), dtype=torch.float32,
                      device=dev)
    ws = torch.empty(max(need.value, 1), dtype=torch.uint8, device=dev)
    amax = stats_b.abs().amax(dim=1) if n else \
        torch.zeros((tb, s), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.shifu_hist_batch(
            bins.data_ptr(), bins.element_size(), node_idx_b.data_ptr(),
            stats_b.data_ptr(), amax.data_ptr(), ws.data_ptr(), need.value,
            out.data_ptr(), n, c, tb, n_nodes, n_bins, s, mode, stream)
    if rc != 0:
        raise RuntimeError(f"hist_batch kernel launch failed (cudaError_t "
                           f"{rc})")
    return out


def hist_batch_bytes(bins, node_idx_b, stats_b, n_nodes: int,
                     n_bins: int) -> int:
    """What one batched launch must move for THIS data, each element once:
    the bins of the rows active in any tree, every tree's node ids and the
    stats of its active rows, and the [TB, K, C, B, S] f32 output."""
    n, c = bins.shape
    tb, s = stats_b.shape[0], stats_b.shape[2]
    live = (node_idx_b >= 0) & (node_idx_b < n_nodes)
    return int(live.any(dim=0).sum()) * c * bins.element_size() \
        + 4 * tb * n + int(live.sum()) * 4 * s \
        + 4 * tb * n_nodes * c * n_bins * s
