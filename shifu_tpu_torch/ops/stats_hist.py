"""The stats plane's fine histogram — the port of
``shifu_tpu.ops.hist_pallas.stats_histograms_pallas`` (kernel B3):

    out[c, b, s] = sum_n [idx(n, c) = b] * stats(n, s)

for bucket ids ``idx`` [N, C] int32 (-1, or any id outside [0, B), marks a
missing cell that counts nowhere), per-row channels ``stats`` [N, S] f32
and B = ``num_buckets`` (a multiple of 64, at most 4096): [C, B, S] f32.

- :func:`stats_histograms_cuda` launches the hand-written CUDA kernel
  ``csrc/stats_hist.cu`` (thread-block clusters that read each 32-byte
  sector of ids once and hand every id to the CTA that owns its column
  through distributed shared memory, then shared-memory sub-histograms;
  count channels summed as integers, weighted ones in 64-bit fixed point,
  so the result is bit-identical from run to run; the source says why
  and how).
- :func:`stats_histograms_ref`, the plain PyTorch version: one
  ``index_add_`` per column chunk into a flat float64 [C*B, S] buffer,
  rounded to f32 at the end.  It is the CPU path and the kernel's oracle
  on the card.

- :func:`stats_histograms_fixed_ref`, the kernel's own arithmetic in
  plain PyTorch (count channels as integers, the others in 64-bit fixed
  point): the kernel's bits, for bit-for-bit checks on the card.  It
  splits where the kernel's raw mode does: the exact int64 cells at a
  given scale (:func:`stats_fixed_cells`), then their rounding
  (:func:`stats_flush_ref`).

On a mesh whose data axis splits a chunk's rows over ranks,
:func:`stats_histograms_sharded` (the reference's
``stats_histograms_sharded``, ``hist_pallas.py:673``) reduces the channels'
amax and the row count over the ranks, takes each rank's exact int64 cells
at that scale (the kernel's raw mode on the card, the fixed-point plain
version on the CPU), sums them with one ``all_reduce`` and rounds once:
the bits of one launch over all the rows.

``exact[s]`` marks channel s as a count channel (0/1 indicators, or other
non-negative integers): the kernel sums those as integers.  Count channels
come first, as the stats plane orders them; without flags every channel is
summed in fixed point.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from ..parallel import mesh as meshlib
from ..parallel.mesh import data_sharded

#: the elements one plain-version ``index_add_`` handles at once
_REF_CHUNK = 1 << 24


def _check_args(idx, stats, num_buckets: int) -> None:
    if idx.dim() != 2 or stats.dim() != 2 or idx.shape[0] != stats.shape[0]:
        raise ValueError(f"stats_hist: idx [N, C] and stats [N, S] must "
                         f"share N, got {tuple(idx.shape)} and "
                         f"{tuple(stats.shape)}")
    if num_buckets % 64 or not 64 <= num_buckets <= 4096:
        raise ValueError(f"stats_hist: num_buckets={num_buckets} must be a "
                         "multiple of 64 in [64, 4096]")


def stats_histograms_ref(idx, stats, num_buckets: int) -> torch.Tensor:
    """[C, B, S] f32 — the plain version (see the module docstring)."""
    _check_args(idx, stats, num_buckets)
    n, c = idx.shape
    s = stats.shape[1]
    dev = idx.device
    acc = torch.zeros((c * num_buckets + 1, s), dtype=torch.float64,
                      device=dev)
    st = stats.double()
    step = max(1, _REF_CHUNK // max(n, 1))
    for c0 in range(0, c, step):
        cols = torch.arange(c0, min(c, c0 + step), device=dev)
        b = idx[:, c0:c0 + len(cols)].long()
        ok = (b >= 0) & (b < num_buckets)
        flat = torch.where(ok, cols[None, :] * num_buckets + b,
                           c * num_buckets)               # overflow slot
        acc.index_add_(0, flat.reshape(-1),
                       st[:, None, :].expand(n, len(cols), s).reshape(-1, s))
    return acc[:-1].reshape(c, num_buckets, s).float()


def _n_exact(exact, s: int) -> int:
    """The length of the leading run of count channels that ``exact``
    flags (None: none); raises where the flags are not such a run."""
    exact = tuple(bool(e) for e in exact) if exact is not None \
        else (False,) * s
    n_exact = exact.index(False) if False in exact else s
    if len(exact) != s or any(exact[n_exact:]):
        raise ValueError(f"stats_hist kernel: exact flags {exact} must mark "
                         f"a leading run of the {s} channels")
    return n_exact


def stats_fixed_cells(idx, stats, num_buckets: int, n_exact: int, amax,
                      n_scale: int) -> torch.Tensor:
    """[C, B, S] int64: each cell's exact sum as the kernel's raw mode
    writes it — the first ``n_exact`` channels as integers, the others as
    quanta rint(v * 2^e), e = ``hist.channel_exp`` of ``amax`` [S] and
    ``n_scale`` rows."""
    from .hist import channel_exp
    _check_args(idx, stats, num_buckets)
    n, c = idx.shape
    s = stats.shape[1]
    dev = idx.device
    e = channel_exp(amax, n_scale).double()
    e[:n_exact] = 0
    q = torch.round(torch.nan_to_num(stats.double() * torch.pow(2.0, e),
                                     nan=0.0, posinf=0.0,
                                     neginf=0.0)).long()
    acc = torch.zeros((c * num_buckets + 1, s), dtype=torch.int64,
                      device=dev)
    step = max(1, _REF_CHUNK // max(n, 1))
    for c0 in range(0, c, step):
        cols = torch.arange(c0, min(c, c0 + step), device=dev)
        b = idx[:, c0:c0 + len(cols)].long()
        ok = (b >= 0) & (b < num_buckets)
        flat = torch.where(ok, cols[None, :] * num_buckets + b,
                           c * num_buckets)               # overflow slot
        acc.index_add_(0, flat.reshape(-1),
                       q[:, None, :].expand(n, len(cols), s).reshape(-1, s))
    return acc[:-1].reshape(c, num_buckets, s)


def stats_flush_ref(cells, amax, n_scale: int, n_exact: int) -> torch.Tensor:
    """The f32 of int64 ``cells`` [C, B, S] as the kernel's flush writes
    it: a count channel's integer rounded to f32, any other rounded once
    and scaled back by 2^-e, NaN where that channel is not finite."""
    from .hist import channel_exp
    e = channel_exp(amax, n_scale).double()
    weighted = torch.arange(cells.shape[-1], device=cells.device) >= n_exact
    e = torch.where(weighted, e, 0.0)
    out = (cells.float().double() * torch.pow(2.0, -e)).float()
    return torch.where(weighted & ~torch.isfinite(amax), float("nan"), out)


def stats_histograms_fixed_ref(idx, stats, num_buckets: int,
                               exact: Optional[Sequence[bool]] = None
                               ) -> torch.Tensor:
    """[C, B, S] f32 by the kernel's own arithmetic in plain PyTorch (see
    the module docstring): the kernel's bits on any data.
    :func:`stats_histograms_ref` agrees exactly on count channels and
    within the quantisation (half of 2^-e a row of the cell, plus f32
    rounding) on the others."""
    n_exact = _n_exact(exact, stats.shape[1])
    amax = stats.abs().amax(dim=0) if idx.shape[0] else \
        torch.zeros(stats.shape[1], device=stats.device)
    return stats_flush_ref(
        stats_fixed_cells(idx, stats, num_buckets, n_exact, amax,
                          idx.shape[0]), amax, idx.shape[0], n_exact)


def _check(name: str, a: torch.Tensor, dtype: torch.dtype,
           device: torch.device) -> None:
    if a.device != device or a.dtype != dtype or not a.is_contiguous():
        raise ValueError(
            f"stats_hist kernel: {name} must be a contiguous {dtype} tensor "
            f"on {device}, got {a.dtype} on {a.device}"
            f"{'' if a.is_contiguous() else ' (strided)'}")


@functools.cache
def _lib():
    from . import cuda_lib
    lib = cuda_lib.load("stats_hist")
    args = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 4
    for fn in (lib.shifu_stats_hist, lib.shifu_stats_hist_until,
               lib.shifu_stats_hist_plan, lib.shifu_stats_hist_raw,
               lib.shifu_stats_hist_flush):
        fn.restype = ctypes.c_int
    lib.shifu_stats_hist_raw.argtypes = [ctypes.c_void_p] * 5 \
        + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.shifu_stats_hist_flush.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.shifu_stats_hist.argtypes = args + [ctypes.c_void_p]
    lib.shifu_stats_hist_until.argtypes = args + [ctypes.c_int,
                                                  ctypes.c_void_p]
    lib.shifu_stats_hist_plan.argtypes = [ctypes.c_longlong] \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def stats_hist_plan(n_rows: int, n_cols: int, num_buckets: int,
                    n_stats: int, n_exact: int) -> dict:
    """How ``csrc/stats_hist.cu`` tiles a launch at these shapes on the
    current card (for logs and the smoke): columns a CTA, CTAs a cluster,
    column clusters, row chunks, whether CTAs write f32 directly, rows a
    tile, shared memory a CTA."""
    out = (ctypes.c_longlong * 7)()
    rc = _lib().shifu_stats_hist_plan(n_rows, n_cols, num_buckets, n_stats,
                                      n_exact, out)
    if rc != 0:
        raise ValueError(f"stats_hist kernel: shapes not supported "
                         f"(cudaError_t {rc})")
    keys = ("cols_a_cta", "cluster", "clusters", "chunks", "direct",
            "tile_rows", "smem")
    return dict(zip(keys, list(out)))


def _launch(idx, stats, num_buckets: int, exact, stop=None,
            meta=None) -> torch.Tensor:
    """Validate, allocate and launch ``csrc/stats_hist.cu`` on the current
    stream; ``stop`` launches the timing entry point instead
    (:func:`launch_until`); ``meta`` ((amax [S] f32, n_scale [1] int64)
    device tensors reduced over a mesh) launches the raw mode: [C, B, S]
    int64 cells at that scale."""
    _check_args(idx, stats, num_buckets)
    dev = idx.device
    if dev.type != "cuda":
        raise ValueError(f"stats_hist kernel: needs CUDA tensors, got "
                         f"{dev} (the plain version is "
                         "stats_histograms_ref)")
    _check("idx", idx, torch.int32, dev)
    _check("stats", stats, torch.float32, dev)
    n, c = idx.shape
    s = stats.shape[1]
    if not 1 <= s <= 4:
        raise ValueError(f"stats_hist kernel: needs 1 <= S <= 4, got {s}")
    n_exact = _n_exact(exact, s)
    if meta is not None:
        amax, n_scale = meta
        acc = torch.empty((c, num_buckets, s), dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _lib().shifu_stats_hist_raw(
                idx.data_ptr(), stats.data_ptr(), amax.data_ptr(),
                acc.data_ptr(), n_scale.data_ptr(), n, c, num_buckets, s,
                n_exact, stream)
        if rc != 0:
            raise RuntimeError(
                f"stats_hist kernel launch failed (cudaError_t {rc})")
        return acc
    amax = stats.abs().amax(dim=0) if n else \
        torch.zeros(s, dtype=torch.float32, device=dev)
    out = torch.empty((c, num_buckets, s), dtype=torch.float32, device=dev)
    if stop == AMAX:
        return out
    acc = torch.empty(c * num_buckets * s, dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (idx.data_ptr(), stats.data_ptr(), amax.data_ptr(),
                acc.data_ptr(), out.data_ptr(), n, c, num_buckets, s,
                n_exact)
        rc = lib.shifu_stats_hist(*args, stream) if stop is None else \
            lib.shifu_stats_hist_until(*args, stop, stream)
    if rc != 0:
        raise RuntimeError(
            f"stats_hist kernel launch failed (cudaError_t {rc})")
    return out


def stats_histograms_cuda(idx, stats, num_buckets: int,
                          exact: Optional[Sequence[bool]] = None
                          ) -> torch.Tensor:
    """Validate, allocate and launch ``csrc/stats_hist.cu`` on the current
    stream: [C, B, S] f32.  No host sync: the fixed-point scales come from
    a device-side ``amax``.  ``exact`` must mark a leading run of channels
    (the stats plane's order: counts first).  ``launches`` counts kernel
    launches."""
    out = _launch(idx, stats, num_buckets, exact)
    stats_histograms_cuda.launches += 1
    _record_cost(idx, stats, num_buckets)
    return out


stats_histograms_cuda.launches = 0


def stats_histograms_sharded(idx, stats, num_buckets: int, mesh,
                             exact: Optional[Sequence[bool]] = None
                             ) -> torch.Tensor:
    """B3 over the rows of every rank of the mesh's data group (reference
    ``stats_histograms_sharded``): each rank passes its own block of the
    chunk's rows and gets the [C, B, S] f32 one launch over all of them
    gives, bit for bit.  One ``all_reduce`` gathers every rank's amax and
    row count (on the device, no host sync), the rank's exact int64 cells
    at that scale come from the kernel's raw mode (counted in
    ``stats_histograms_cuda.launches``) or :func:`stats_fixed_cells` on
    the CPU, a second ``all_reduce`` sums them (``allreduces`` counts it)
    and the flush rounds them."""
    _check_args(idx, stats, num_buckets)
    s = stats.shape[1]
    dev = idx.device
    n_exact = _n_exact(exact, s)
    g_amax, n_scale = global_stats_meta(stats, mesh)
    if dev.type == "cpu":
        cells = stats_fixed_cells(idx, stats, num_buckets, n_exact, g_amax,
                                  int(n_scale))
    else:
        cells = _launch(idx, stats, num_buckets, exact,
                        meta=(g_amax, n_scale))
        stats_histograms_cuda.launches += 1
    _record_cost(idx, stats, num_buckets)
    meshlib.all_reduce(mesh, cells)
    stats_histograms_sharded.allreduces += 1
    if dev.type == "cpu":
        return stats_flush_ref(cells, g_amax, int(n_scale), n_exact)
    return flush_cuda(cells, g_amax, n_scale, n_exact)


stats_histograms_sharded.allreduces = 0


def global_stats_meta(stats, mesh):
    """(amax [S] f32, n_scale [1] int64): the channels' amax and the row
    count over every rank of the mesh's data group — one ``all_reduce`` on
    the device, each rank's values in its own row of a zero [data, S + 1]
    float64 tensor (an exact gather), reduced by max and sum."""
    n, s = stats.shape
    dev = stats.device
    amax = stats.abs().amax(dim=0) if n else \
        torch.zeros(s, dtype=torch.float32, device=dev)
    buf = torch.zeros((mesh.n_data, s + 1), dtype=torch.float64, device=dev)
    buf[mesh.coords[1]] = torch.cat([
        amax.double(), torch.tensor([float(n)], dtype=torch.float64,
                                    device=dev)])
    meshlib.all_reduce(mesh, buf)
    return (buf[:, :s].amax(dim=0).float().contiguous(),
            buf[:, s].sum().to(torch.int64).reshape(1))


def flush_cuda(cells, amax, n_scale, n_exact: int) -> torch.Tensor:
    """``csrc/stats_hist.cu``'s flush of summed int64 cells [C, B, S] at
    the scale of ``amax`` [S] and ``n_scale`` [1]: f32."""
    out = torch.empty(cells.shape, dtype=torch.float32, device=cells.device)
    with torch.cuda.device(cells.device):
        stream = torch.cuda.current_stream(cells.device).cuda_stream
        rc = _lib().shifu_stats_hist_flush(
            cells.data_ptr(), amax.data_ptr(), out.data_ptr(),
            n_scale.data_ptr(), cells.numel(), cells.shape[-1], n_exact,
            stream)
    if rc != 0:
        raise RuntimeError(f"stats_hist flush launch failed (cudaError_t "
                           f"{rc})")
    return out


def stats_histograms(idx, stats, num_buckets: int,
                     exact: Optional[Sequence[bool]] = None,
                     mesh=None) -> torch.Tensor:
    """B3 on ``idx``'s device: the kernel for CUDA tensors, the plain
    version for CPU tensors (and only for them); on a mesh whose data axis
    splits the rows, :func:`stats_histograms_sharded` (fixed point on
    either device)."""
    if data_sharded(mesh):
        return stats_histograms_sharded(idx, stats, num_buckets, mesh, exact)
    if idx.device.type == "cpu":
        out = stats_histograms_ref(idx, stats, num_buckets)
        _record_cost(idx, stats, num_buckets)
        return out
    return stats_histograms_cuda(idx, stats, num_buckets, exact)


def stats_hist_cost(rows: int, n_cols: int, n_buckets: int,
                    n_stats: int) -> dict:
    """Bytes and operations of one ``csrc/stats_hist.cu`` launch from its
    shape: the [N, C] int32 ids, the [N, S] f32 stats and the [C, B, S]
    f32 output once each (what :func:`stats_hist_bytes` charges a given
    launch), and one fixed-point add per (row, column, channel) — an
    upper bound on the adds when ids are missing."""
    return {"flops": float(rows) * n_cols * n_stats,
            "bytes_accessed": 4.0 * rows * n_cols + 4.0 * rows * n_stats
            + 4.0 * n_cols * n_buckets * n_stats}


def _record_cost(idx, stats, num_buckets: int) -> None:
    from ..obs import costs
    costs.record_model_launch(
        "stats.stats_hist", rows=int(idx.shape[0]), n_cols=int(idx.shape[1]),
        n_buckets=int(num_buckets), n_stats=int(stats.shape[1]))


def _register_cost_model() -> None:
    from ..obs import costs
    costs.register_cost_model("stats.stats_hist", stats_hist_cost)


_register_cost_model()


#: where :func:`launch_until` stops a launch: after the wrapper's device-side
#: ``amax``, after the kernel's staging of the ids, after zeroing and
#: accumulating the cells (before the flush to f32)
AMAX, STAGE, ACCUM = 0, 1, 2


def launch_until(idx, stats, num_buckets: int,
                 exact: Optional[Sequence[bool]], stop: int) -> torch.Tensor:
    """For timing only: a :func:`stats_histograms_cuda` launch stopped
    after part ``stop`` (:data:`AMAX`, :data:`STAGE` or :data:`ACCUM`), so
    a launch's device time splits by part; the output is undefined."""
    if stop not in (AMAX, STAGE, ACCUM):
        raise ValueError(f"stats_hist kernel: stop must be AMAX, STAGE or "
                         f"ACCUM, got {stop}")
    return _launch(idx, stats, num_buckets, exact, stop)


def stats_hist_bytes(idx, stats, num_buckets: int) -> int:
    """What one launch must move, each element once: the [N, C] int32 ids,
    the [N, S] f32 stats, and the [C, B, S] f32 output."""
    n, c = idx.shape
    return int(stats_hist_cost(n, c, num_buckets,
                               stats.shape[1])["bytes_accessed"])
