"""The decision-tree histogram build — the port of
``shifu_tpu.ops.hist_pallas.build_histograms_pallas`` (kernel B1), the hot
op of tree training:

    out[k, c, b, s] = sum_n [node(n) = k] * stats(n, s) * [bins(n, c) = b]

Two versions of one function, dispatched by
:func:`shifu_tpu_torch.ops.tree.build_histograms`:

- :func:`build_histograms_cuda` launches the hand-written CUDA kernel
  ``csrc/hist.cu`` (shared-memory sub-histograms, 64-bit fixed-point
  sums, bit-identical from run to run; the source says why and how);
- :func:`build_histograms_ref`, the plain PyTorch version: one
  ``scatter_add_`` per column chunk into a flat float64 ``[K*C*B, S]``
  buffer, rounded to f32 at the end.  It is the CPU path and the kernel's
  oracle on the card.  Float64 keeps its own rounding error (f32
  accumulation over 10^4 rows per cell reaches ~1e-5 relative) out of the
  comparison: both versions return the f32 rounding of a near-exact sum.

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
