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

- :func:`build_histograms_cuda` (B1, one tree) and
  :func:`build_histograms_batch_cuda` (B2, TB trees in one launch) launch
  the one hand-written CUDA kernel ``csrc/hist.cu`` (rows partitioned by
  node, shared-memory sub-histograms, exact integer sums, bit-identical
  from run to run; the source says why and how), so every tree slice of
  a B2 launch is bit-identical to B1 on that tree's inputs;
- :func:`build_histograms_ref`, the plain PyTorch version: one
  ``scatter_add_`` per column chunk into a flat float64 ``[K*C*B, S]``
  buffer, rounded to f32 at the end.  It is the CPU path and the kernel's
  oracle on the card.  Float64 keeps its own rounding error (f32
  accumulation over 10^4 rows per cell reaches ~1e-5 relative) out of the
  comparison: both versions return the f32 rounding of a near-exact sum.
  :func:`build_histograms_batch_ref` loops it over the trees, so on the
  CPU a batched build equals the sequential ones exactly;
- :func:`build_histograms_fixed_ref`, the kernel's own fixed-point
  arithmetic in plain PyTorch: the kernel's bits, for bit-for-bit checks
  on the card.

Bins ride uint8 (<= 256 bins) or int32; a uint16 plane widens on its own
device first (:func:`widen_bins`).  Rows whose node id is outside [0, K)
and cells whose bin id is outside [0, B) contribute nothing in both.
"""

from __future__ import annotations

import ctypes
import functools
import os

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


def _scatter_cells(bins, node_idx, src, n_nodes: int,
                   n_bins: int) -> torch.Tensor:
    """[K, C, B, S] sums of ``src`` [N, S] (its dtype) over (node,
    feature, bin) cells: one ``scatter_add_`` per column chunk.  On the
    CPU the chunks run on a thread pool (each column's cells are its own,
    and a cell still adds its rows in row order, so the sums do not
    depend on the split)."""
    n, c = bins.shape
    dev = bins.device
    node = node_idx.long()
    row_ok = (node >= 0) & (node < n_nodes)
    step = max(1, _REF_CHUNK // max(n, 1))
    if dev.type == "cpu" and n * c >= _POOL_MIN:
        step = min(step, -(-c // _pool_threads()))
    edges = list(range(0, c, step)) + [c]

    def chunk(c0: int, c1: int) -> torch.Tensor:
        s = src.shape[1]
        cc = c1 - c0
        acc = torch.zeros((n_nodes * cc * n_bins, s), dtype=src.dtype,
                          device=dev)
        b = bins[:, c0:c1].long()
        ok = row_ok[:, None] & (b >= 0) & (b < n_bins)
        cols = torch.arange(cc, device=dev)
        idx = (((node.clamp(0, n_nodes - 1) * cc)[:, None] + cols[None, :])
               * n_bins + b.clamp(0, n_bins - 1)).reshape(-1, 1) \
            .expand(-1, s)
        acc.scatter_add_(0, idx, (src[:, None, :] * ok[..., None])
                         .reshape(-1, s))
        return acc.reshape(n_nodes, cc, n_bins, s)

    spans = list(zip(edges[:-1], edges[1:]))
    if dev.type == "cpu" and len(spans) > 1:
        parts = list(_pool().map(lambda e: chunk(*e), spans))
    else:
        parts = [chunk(*e) for e in spans]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


#: rows x columns from which the CPU plain version splits its columns
#: over a thread pool
_POOL_MIN = 1 << 18
_POOL = None


def _pool_threads() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def _pool():
    global _POOL
    if _POOL is None:
        from concurrent.futures import ThreadPoolExecutor
        _POOL = ThreadPoolExecutor(_pool_threads(),
                                   thread_name_prefix="hist-ref")
    return _POOL


def build_histograms_ref(bins, node_idx, stats, n_nodes: int,
                         n_bins: int) -> torch.Tensor:
    """[K, C, B, S] f32 — the plain version (see the module docstring)."""
    return _scatter_cells(bins, node_idx, stats.double(), n_nodes,
                          n_bins).float()


def channel_exp(amax, n_rows: int) -> torch.Tensor:
    """The exponent e of each channel's fixed-point scale 2^e, as
    ``csrc/fixed_point.cuh::channel_exp`` computes it: the largest with
    amax * N * 2^e < 2^62; 0 for an all-zero or non-finite channel."""
    t = amax.double() * max(n_rows, 1)
    _, p = torch.frexp(t)                         # t < 2^p
    return torch.where((t > 0) & torch.isfinite(t), 62 - p.long(), 0)


def build_histograms_fixed_ref(bins, node_idx, stats, n_nodes: int,
                               n_bins: int) -> torch.Tensor:
    """[K, C, B, S] f32 by the kernel's own arithmetic in plain PyTorch:
    each channel quantised to q = rint(v * 2^e) (:func:`channel_exp`),
    the quanta summed exactly in int64, each sum rounded to f32 once and
    scaled back by 2^-e; NaN where a channel is not finite.  The kernel
    gives these bits on any data (its 32-bit channels too, as its source
    proves).  :func:`build_histograms_ref` agrees within the quantisation:
    at most half of 2^-e a row of the cell, plus f32 rounding."""
    amax = stats.abs().amax(dim=0) if stats.shape[0] else \
        torch.zeros(stats.shape[1], device=stats.device)
    e = channel_exp(amax, bins.shape[0]).double()
    q = torch.round(stats.double() * torch.pow(2.0, e)).long()
    sums = _scatter_cells(bins, node_idx, q, n_nodes, n_bins)
    out = (sums.float().double() * torch.pow(2.0, -e)).float()
    return torch.where(torch.isfinite(amax), out, float("nan"))


def _check(name: str, a: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if a.device != device or a.dtype != dtype or a.dim() != ndim \
            or not a.is_contiguous():
        raise ValueError(
            f"hist kernel: {name} must be a contiguous {ndim}-D {dtype} "
            f"tensor on {device}, got {tuple(a.shape)} {a.dtype} on "
            f"{a.device}{'' if a.is_contiguous() else ' (strided)'}")


def channel_meta(stats_b, n_rows: int):
    """Per (tree, channel) of ``stats_b`` [TB, N, S]: ``amax`` [TB, S] f32,
    max |stats| (NaN or inf where the channel is not finite), and
    ``exact`` [TB, S] int32, 1 where every value is an integer and
    ``amax * n_rows < 2^31``, so every partial sum of the channel fits a
    32-bit integer and the kernel may sum it in one.  Computed on the
    tensors' device, with no host sync; an empty channel is exact."""
    tb, n, s = stats_b.shape
    if n == 0:
        return (torch.zeros((tb, s), dtype=torch.float32,
                            device=stats_b.device),
                torch.ones((tb, s), dtype=torch.int32,
                           device=stats_b.device))
    amax = stats_b.abs().amax(dim=1)
    whole = (stats_b == stats_b.trunc()).all(dim=1)
    exact = whole & (amax.double() * n_rows < 2.0 ** 31)
    return amax, exact.to(torch.int32)


@functools.cache
def _lib():
    from . import cuda_lib
    lib = cuda_lib.load("hist")
    args = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong] \
        + [ctypes.c_int] * 5
    lib.shifu_hist.restype = lib.shifu_hist_until.restype = ctypes.c_int
    lib.shifu_hist.argtypes = args + [ctypes.c_void_p]
    lib.shifu_hist_until.argtypes = args + [ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.shifu_hist_workspace, lib.shifu_hist_plan):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
    return lib


def hist_plan(n_rows: int, n_cols: int, n_trees: int, n_nodes: int,
              n_bins: int, n_stats: int, bin_bytes: int = 1) -> dict:
    """How ``csrc/hist.cu`` tiles a launch at these shapes (for logs and
    the smoke): bin ids a lane loads, node and bin tiles, column group,
    row chunks, whether blocks write f32 directly, shared memory a
    block."""
    out = (ctypes.c_longlong * 7)()
    rc = _lib().shifu_hist_plan(n_rows, n_cols, n_trees, n_nodes, n_bins,
                                n_stats, bin_bytes, out)
    if rc != 0:
        raise ValueError(f"hist kernel: shapes not supported (cudaError_t "
                         f"{rc})")
    keys = ("vec", "node_tile", "bin_tile", "col_group", "chunks", "direct",
            "smem")
    return dict(zip(keys, list(out)))


def _launch(name, bins, node_idx_b, stats_b, n_nodes: int, n_bins: int,
            stop=None) -> torch.Tensor:
    """Validate, allocate and launch ``csrc/hist.cu`` for TB trees on the
    current stream: [TB, K, C, B, S] f32.  No host sync: the channel
    scales and 32-bit flags come from device-side ``channel_meta``.
    ``stop`` launches the timing entry point instead (:func:`launch_until`).
    A uint8 plane must start on a V-byte boundary (V from the plan), which
    every fresh tensor does."""
    dev = bins.device
    _check("bins", bins, torch.int32 if bins.dtype == torch.int32
           else torch.uint8, 2, dev)
    _check(name[0], node_idx_b, torch.int32, 2, dev)
    _check(name[1], stats_b, torch.float32, 3, dev)
    n, c = bins.shape
    tb, s = stats_b.shape[0], stats_b.shape[2]
    if node_idx_b.shape != (tb, n) or stats_b.shape[1] != n:
        raise ValueError(f"hist kernel: {n} rows of bins, node ids "
                         f"{tuple(node_idx_b.shape)}, stats "
                         f"{tuple(stats_b.shape)}")
    if not 1 <= tb <= 65535 or n_nodes < 1 or c < 1 or s < 1 \
            or not 1 <= n_bins <= 65536 or n >= 1 << 31:
        raise ValueError(f"hist kernel: needs 1 <= TB <= 65535, K >= 1, "
                         f"C >= 1, S >= 1, 1 <= B <= 65536 and N < 2^31 "
                         f"(TB={tb}, K={n_nodes}, C={c}, S={s}, B={n_bins}, "
                         f"N={n})")
    vec = hist_plan(n, c, tb, n_nodes, n_bins, s,
                    bins.element_size())["vec"] if n else 1
    if bins.data_ptr() % vec:
        raise ValueError(f"hist kernel: bins must start on a {vec}-byte "
                         f"boundary for {vec}-wide loads (a view at byte "
                         f"offset {bins.data_ptr() % vec}); pass a copy")
    lib = _lib()
    need = ctypes.c_longlong(0)
    rc = lib.shifu_hist_workspace(n, c, tb, n_nodes, n_bins, s,
                                  bins.element_size(), ctypes.byref(need))
    if rc != 0:
        raise ValueError(f"hist kernel: shapes not supported (cudaError_t "
                         f"{rc})")
    out = torch.empty((tb, n_nodes, c, n_bins, s), dtype=torch.float32,
                      device=dev)
    ws = torch.empty(max(need.value, 1), dtype=torch.uint8, device=dev)
    amax, exact = channel_meta(stats_b, n)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (bins.data_ptr(), bins.element_size(), node_idx_b.data_ptr(),
                stats_b.data_ptr(), amax.data_ptr(), exact.data_ptr(),
                ws.data_ptr(), need.value, out.data_ptr(), n, c, tb, n_nodes,
                n_bins, s)
        rc = lib.shifu_hist(*args, stream) if stop is None else \
            lib.shifu_hist_until(*args, stop, stream)
    if rc != 0:
        raise RuntimeError(f"hist kernel launch failed (cudaError_t {rc})")
    return out


def build_histograms_cuda(bins, node_idx, stats, n_nodes: int,
                          n_bins: int) -> torch.Tensor:
    """Kernel B1: ``csrc/hist.cu`` launched for one tree, [K, C, B, S]
    f32."""
    _check("node_idx", node_idx, torch.int32, 1, bins.device)
    _check("stats", stats, torch.float32, 2, bins.device)
    return _launch(("node_idx", "stats"), bins, node_idx[None], stats[None],
                   n_nodes, n_bins)[0]


def hist_kernel_cost(rows: int, n_feat: int, n_bins: int, n_nodes: int,
                     n_stats: int = 2, n_trees: int = 1,
                     bin_bytes: int = 1) -> dict:
    """Bytes and operations of one ``csrc/hist.cu`` launch (B1, or B2 at
    ``n_trees`` > 1) from its shape alone, every row active — the CUDA
    kernel's counts, not the TPU kernel's one-hot products: the bins read
    once, each tree's node ids and stats once, the [TB, K, C, B, S] f32
    output written once, and one fixed-point add per (tree, row, column,
    channel).  :func:`hist_bytes` / :func:`hist_batch_bytes` take off what
    a given launch's inactive rows do not move, so this is their count
    with every row active and an upper bound otherwise."""
    read = float(rows) * n_feat * bin_bytes \
        + n_trees * rows * (4.0 + 4.0 * n_stats)
    write = 4.0 * n_trees * n_nodes * n_feat * n_bins * n_stats
    return {"flops": float(n_trees) * rows * n_feat * n_stats,
            "bytes_accessed": read + write}


def hist_bytes(bins, node_idx, stats, n_nodes: int, n_bins: int) -> int:
    """What one launch must move for THIS data, each element once: every
    node id, the bins and stats of the rows whose node is in [0, K), and
    the [K, C, B, S] f32 output — :func:`hist_kernel_cost` less the bins
    and stats of the inactive rows."""
    return hist_batch_bytes(bins, node_idx[None], stats[None], n_nodes,
                            n_bins)


def record_hist_cost(bins, stats, n_nodes: int, n_bins: int,
                     n_trees: int = 1) -> None:
    """One ``pallas.hist`` cost record (the reference's name) for a
    launch of B1/B2 — or, on the CPU, of its plain version."""
    from ..obs import costs
    costs.record_model_launch(
        "pallas.hist", rows=int(bins.shape[0]), n_feat=int(bins.shape[1]),
        n_bins=int(n_bins), n_nodes=int(n_nodes),
        n_stats=int(stats.shape[-1]), n_trees=int(n_trees),
        bin_bytes=int(bins.element_size()))


def _register_cost_model() -> None:
    from ..obs import costs
    costs.register_cost_model("pallas.hist", hist_kernel_cost)


_register_cost_model()


def build_histograms_batch_ref(bins, node_idx_b, stats_b, n_nodes: int,
                               n_bins: int) -> torch.Tensor:
    """[TB, K, C, B, S] f32 — :func:`build_histograms_ref` per tree."""
    return torch.stack([build_histograms_ref(bins, node_idx_b[t], stats_b[t],
                                             n_nodes, n_bins)
                        for t in range(node_idx_b.shape[0])])


def build_histograms_batch_cuda(bins, node_idx_b, stats_b, n_nodes: int,
                                n_bins: int) -> torch.Tensor:
    """Kernel B2: ``csrc/hist.cu`` launched for TB trees at once, [TB, K,
    C, B, S] f32, each tree's slice bit-identical to a B1 launch on its
    inputs."""
    return _launch(("node_idx_b", "stats_b"), bins, node_idx_b, stats_b,
                   n_nodes, n_bins)


#: where :func:`launch_until` stops a launch: after the partition and the
#: blocks' set-up, after the row walk (staging, bin loads), after the adds
SETUP, WALK, ADDS = 0, 1, 2


def launch_until(bins, node_idx_b, stats_b, n_nodes: int, n_bins: int,
                 stop: int) -> torch.Tensor:
    """For timing only: a :func:`build_histograms_batch_cuda` launch (B1
    at TB = 1) stopped after part ``stop`` (:data:`SETUP`, :data:`WALK`
    or :data:`ADDS`) through the kernel's timing entry point, so a launch's
    time splits by part; the output is undefined."""
    if stop not in (SETUP, WALK, ADDS):
        raise ValueError(f"hist kernel: stop must be SETUP, WALK or ADDS, "
                         f"got {stop}")
    return _launch(("node_idx_b", "stats_b"), bins, node_idx_b, stats_b,
                   n_nodes, n_bins, stop)


def hist_batch_bytes(bins, node_idx_b, stats_b, n_nodes: int,
                     n_bins: int) -> int:
    """What one batched launch must move for THIS data, each element once:
    the bins of the rows active in any tree, every tree's node ids and the
    stats of its active rows, and the [TB, K, C, B, S] f32 output —
    :func:`hist_kernel_cost` less the bins no tree reads and the stats of
    each tree's inactive rows."""
    n, c = bins.shape
    tb, s = stats_b.shape[0], stats_b.shape[2]
    live = (node_idx_b >= 0) & (node_idx_b < n_nodes)
    whole = hist_kernel_cost(n, c, n_bins, n_nodes, s, tb,
                             bins.element_size())["bytes_accessed"]
    idle_rows = n - int(live.any(dim=0).sum())
    idle_pairs = tb * n - int(live.sum())
    return int(whole) - idle_rows * c * bins.element_size() \
        - idle_pairs * 4 * s
