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
    lib.shifu_stats_hist.restype = ctypes.c_int
    lib.shifu_stats_hist_until.restype = ctypes.c_int
    lib.shifu_stats_hist_plan.restype = ctypes.c_int
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


def _launch(idx, stats, num_buckets: int, exact, stop=None) -> torch.Tensor:
    """Validate, allocate and launch ``csrc/stats_hist.cu`` on the current
    stream; ``stop`` launches the timing entry point instead
    (:func:`launch_until`)."""
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
    exact = tuple(bool(e) for e in exact) if exact is not None \
        else (False,) * s
    n_exact = exact.index(False) if False in exact else s
    if len(exact) != s or any(exact[n_exact:]):
        raise ValueError(f"stats_hist kernel: exact flags {exact} must mark "
                         f"a leading run of the {s} channels")
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
    return out


stats_histograms_cuda.launches = 0


def stats_histograms(idx, stats, num_buckets: int,
                     exact: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """B3 on ``idx``'s device: the kernel for CUDA tensors, the plain
    version for CPU tensors (and only for them)."""
    if idx.device.type == "cpu":
        return stats_histograms_ref(idx, stats, num_buckets)
    return stats_histograms_cuda(idx, stats, num_buckets, exact)


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
    s = stats.shape[1]
    return 4 * n * c + 4 * n * s + 4 * c * num_buckets * s
