"""The device mesh over ``torch.distributed`` — the port of
``shifu_tpu.parallel.mesh`` (the reference's Guagua BSP replacement).

The reference lays its devices out as a 2D ``(ensemble, data)`` mesh and
lets XLA place its collectives.  Here each device is a rank process
(``torch.distributed``), and the same grid decides what a rank holds:

- the ``data`` axis splits rows: rank (e, d) keeps block d of every
  row-indexed array (:func:`row_block`, :func:`shard_chunk_rows`), each
  kernel launches on its own rows, and one collective over the rank's
  data group (the ranks of its ensemble row) merges the results — the
  reference's ``psum``;
- the ``ensemble`` axis splits members (bags, folds): the ranks of one
  data column hold the same rows and train different members, whose
  results meet through the ensemble group at the end.

A process that never joined a world sees a mesh of one rank: every
collective is skipped and every caller runs as it does without a mesh.

Ranks join through :func:`initialize_distributed`, from the launcher's
``SHIFU_COORDINATOR`` / ``SHIFU_NUM_PROCESSES`` / ``SHIFU_PROCESS_ID``.
A rank's tensors live on card ``process_id % device_count``.  The backend
is NCCL when no two ranks share a card and gloo when they do (NCCL refuses
two ranks on one device); gloo reduces CUDA tensors through host copies
that it makes itself, so no caller moves a tensor off its card.  The
chosen backend is logged.
"""

from __future__ import annotations

import logging
import math
import os
import random
import time
from datetime import timedelta
from typing import Dict, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)

#: the seconds a rank waits for the coordinator's store and its peers
CONNECT_TIMEOUT_S = 300


class Mesh:
    """The world's ranks as an ``(ensemble, data)`` grid, rank r at
    ``(r // data, r % data)`` (the reference's ``reshape(e, n // e)``).

    ``data_group`` is the process group of this rank's ensemble row (the
    ranks that split its rows), ``ensemble_group`` that of its data column
    (the ranks that split its members); each is None where its axis is 1."""

    def __init__(self, n_ensemble: int = 1, n_data: int = 1, rank: int = 0,
                 data_group=None, ensemble_group=None):
        self.n_ensemble, self.n_data, self.rank = n_ensemble, n_data, rank
        self.data_group, self.ensemble_group = data_group, ensemble_group

    @property
    def shape(self) -> Dict[str, int]:
        return {"ensemble": self.n_ensemble, "data": self.n_data}

    @property
    def size(self) -> int:
        return self.n_ensemble * self.n_data

    @property
    def coords(self) -> Tuple[int, int]:
        """This rank's (ensemble index, data index)."""
        return divmod(self.rank, self.n_data)

    def row_block(self, n: int) -> Tuple[int, int]:
        """This rank's rows [r0, r1) of ``n`` (:func:`row_block`)."""
        return row_block(n, self.n_data, self.coords[1])

    def member_block(self, members: int) -> Tuple[int, int]:
        """This rank's members [m0, m1) of ``members``: the ensemble axis
        divides them (the gcd rule of :func:`device_mesh`)."""
        per = members // self.n_ensemble
        e = self.coords[0]
        return e * per, (e + 1) * per

    def __repr__(self) -> str:
        return (f"Mesh(ensemble={self.n_ensemble}, data={self.n_data}, "
                f"rank={self.rank})")


def data_sharded(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` splits rows over more than one rank — the
    condition under which the kernels take their sharded forms."""
    return mesh is not None and mesh.n_data > 1


#: process groups made for (world group, world size, ensemble size): every
#: rank must create the same groups in the same order, once
_GROUPS: Dict[tuple, tuple] = {}


def device_mesh(n_ensemble: int = 1) -> Mesh:
    """The ``(ensemble, data)`` mesh over the joined world (reference
    ``device_mesh``): the ensemble axis takes ``gcd(world, n_ensemble)``
    ranks, never more than there are members, and the rest go to the data
    axis.  Outside a world, a mesh of one rank."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh()
    n = dist.get_world_size()
    e = math.gcd(n, max(1, int(n_ensemble)))
    d = n // e
    key = (id(dist.group.WORLD), n, e)
    if key not in _GROUPS:
        rows = [dist.new_group([i * d + j for j in range(d)])
                for i in range(e)] if d > 1 else None
        cols = [dist.new_group([i * d + j for i in range(e)])
                for j in range(d)] if e > 1 else None
        _GROUPS[key] = (rows, cols)
    rows, cols = _GROUPS[key]
    rank = dist.get_rank()
    return Mesh(e, d, rank, rows[rank // d] if rows else None,
                cols[rank % d] if cols else None)


def pad_rows(n: int, multiple: int) -> int:
    """Rows to add so n divides the data-axis extent."""
    r = n % multiple
    return 0 if r == 0 else multiple - r


def row_block(n: int, n_data: int, index: int) -> Tuple[int, int]:
    """Rows [r0, r1) of block ``index`` when ``n`` rows split over
    ``n_data`` ranks in the reference's layout: ``ceil(n / n_data)`` rows
    a block, the last blocks short (or empty) where the zero padding of
    :func:`pad_rows` would sit."""
    per = -(-n // max(n_data, 1))
    r0 = min(index * per, n)
    return r0, min(r0 + per, n)


def shard_chunk_rows(mesh: Optional[Mesh], *arrays):
    """This rank's block of per-row chunk arrays (1D [R] or 2D [R, C]) in
    the reference's layout: the rows zero-padded to a multiple of the data
    axis and cut into equal blocks, so every rank's block has
    ``ceil(R / data)`` rows.  Returns the host blocks plus a live-row bool
    mask marking real rows — the arrays as they are and a ``None`` mask
    when ``mesh`` is None or its data axis is 1.  Zero rows are invalid
    or weightless at every call site (reference: each Guagua/MR worker
    reads its own input split, ``ShifuInputFormat``)."""
    if not data_sharded(mesh):
        return tuple(arrays) + (None,)
    n = np.asarray(arrays[0]).shape[0]
    per = (n + pad_rows(n, mesh.n_data)) // mesh.n_data
    r0, r1 = mesh.row_block(n)
    out = []
    for a in list(arrays) + [np.ones(n, bool)]:
        a = np.asarray(a)
        blk = np.zeros((per,) + a.shape[1:], a.dtype)
        blk[:r1 - r0] = a[r0:r1]
        out.append(blk)
    return tuple(out)


def shard_rows_from_local(mesh: Optional[Mesh], local_rows,
                          device=None) -> Tuple[torch.Tensor, int, int]:
    """This rank's own row block (read from its own shard files, the
    reference's per-host feed) on ``device``, with its global first row and
    the global row count: blocks follow one another in data-rank order
    (reference ``shard_rows_from_local``; one all_gather of the block
    sizes over the data group)."""
    t = torch.as_tensor(np.ascontiguousarray(local_rows)).to(device)
    if not data_sharded(mesh):
        return t, 0, int(t.shape[0])
    sizes = all_gather(mesh, torch.tensor([t.shape[0]], dtype=torch.int64,
                                          device=t.device)).cpu().numpy()
    i = mesh.coords[1]
    return t, int(sizes[:i].sum()), int(sizes.sum())


# ------------------------------------------------------------ collectives
def _group(mesh: Mesh, axis: str):
    return mesh.data_group if axis == "data" else mesh.ensemble_group


def all_reduce(mesh: Optional[Mesh], t: torch.Tensor,
               axis: str = "data") -> torch.Tensor:
    """``t`` summed in place over the ranks of this rank's ``axis`` group
    (a no-op where the axis is 1); returns ``t``."""
    if mesh is None or mesh.shape[axis] <= 1:
        return t
    import torch.distributed as dist
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_group(mesh, axis))
    return t


def reduce_scatter(mesh: Optional[Mesh], t: torch.Tensor,
                   axis: str = "data") -> torch.Tensor:
    """This rank's block of dim 0 of ``t`` summed over the ranks of its
    ``axis`` group (``t`` is ``[size * n, ...]`` on every rank; the result
    ``[n, ...]``), differentiable: the backward is an all_gather of the
    cotangents, the transpose of the sum (the reference's tiled
    ``psum_scatter``).  A no-op where the axis is 1.

    One ``torch.distributed.reduce_scatter_tensor``; narrow float
    tensors travel as float32 and round back."""
    if mesh is None or mesh.shape[axis] <= 1:
        return t
    return _ReduceScatter.apply(t, mesh, axis)


def _reduce_scatter(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    import warnings

    import torch.distributed as dist
    wide = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
    wide = wide.contiguous()
    n = wide.shape[0] // mesh.shape[axis]
    out = wide.new_empty((n,) + tuple(wide.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, wide, group=_group(mesh, axis))
    return out.to(t.dtype)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _reduce_scatter(mesh, t, axis)

    @staticmethod
    def backward(ctx, g):
        return all_gather(ctx.mesh, g.contiguous(), ctx.axis), None, None


def all_gather(mesh: Optional[Mesh], t: torch.Tensor,
               axis: str = "data") -> torch.Tensor:
    """Every rank's ``t`` of this rank's ``axis`` group concatenated along
    dim 0 in rank order — bit for bit: the tensors travel as raw bytes.
    Every rank's ``t`` must have the same shape."""
    if mesh is None or mesh.shape[axis] <= 1:
        return t
    import torch.distributed as dist
    t = t.contiguous()
    raw = t.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, raw, group=_group(mesh, axis))
    return torch.cat(parts).view(t.dtype).reshape(
        (-1,) + tuple(t.shape[1:]))


def gather_rows(mesh: Optional[Mesh], t: torch.Tensor,
                n: int) -> torch.Tensor:
    """The [n, ...] rows whose blocks (:func:`row_block`, short or equal
    padded ones) the data group holds, in row order: each block is padded
    to ``ceil(n / data)`` rows, gathered, and the padding trimmed."""
    if not data_sharded(mesh):
        return t
    per = -(-n // mesh.n_data)
    if t.shape[0] < per:
        t = torch.cat([t, t.new_zeros((per - t.shape[0],)
                                      + tuple(t.shape[1:]))])
    out = all_gather(mesh, t)
    blocks = [row_block(n, mesh.n_data, i) for i in range(mesh.n_data)]
    keep = [torch.arange(i * per, i * per + (r1 - r0), device=out.device)
            for i, (r0, r1) in enumerate(blocks)]
    return out[torch.cat(keep)]


def gather_members(mesh: Optional[Mesh], tree):
    """A tree (lists, tuples, dicts) of per-member tensors, each ``[m,
    ...]`` for this rank's members, as ``[m * ensemble, ...]`` tensors of
    every member in member order: one all_gather over the ensemble group
    of all leaves' bytes."""
    if mesh is None or mesh.n_ensemble <= 1:
        return tree
    from ..train.optimizers import tree_map
    leaves = []
    tree_map(lambda t: leaves.append(t.contiguous()), tree)
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in leaves])
    ranks = all_gather(mesh, flat, axis="ensemble").reshape(
        mesh.n_ensemble, -1)
    cols = iter(ranks.split([t.numel() * t.element_size() for t in leaves],
                            dim=1))

    def whole(t):
        return torch.cat([c.contiguous().view(t.dtype).reshape(t.shape)
                          for c in next(cols)])
    return tree_map(whole, tree)


# ------------------------------------------------------------- multi-host
def _backend(num_processes: int, device: Optional[str]) -> str:
    if device == "cpu" or not torch.cuda.is_available():
        return "gloo"
    return "nccl" if num_processes <= torch.cuda.device_count() else "gloo"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: Optional[str] = None) -> Optional[str]:
    """Join the world (reference ``initialize_distributed``, the
    Guagua/ZooKeeper coordination role): a ``torch.distributed.TCPStore``
    at the coordinator's ``host:port`` (served by process 0), then
    ``init_process_group`` with this rank and the world size.  After it,
    :func:`device_mesh` spans every rank.  Returns the backend, or None
    when there is no coordinator (a single-process run stays a true no-op).

    Args default from SHIFU_COORDINATOR / SHIFU_NUM_PROCESSES /
    SHIFU_PROCESS_ID (set by the launcher).  ``device`` "cpu" (the CLI's
    ``--device cpu``) keeps the rank on the host over gloo; otherwise the
    rank takes card ``process_id % device_count``.

    The connect rides the same bounded exponential-backoff+jitter ladder
    as :func:`ioutil.io_retry` (``shifu.io.retries`` attempts,
    ``shifu.io.retryBaseMs`` base; counter ``dcn.connect_retries``), and a
    spent ladder raises a CODED error instead of hanging the launcher."""
    coordinator = coordinator or os.environ.get("SHIFU_COORDINATOR")
    if coordinator is None:
        return None
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_backend()
    if num_processes is None:
        num_processes = int(os.environ["SHIFU_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["SHIFU_PROCESS_ID"])
    backend = _backend(num_processes, device)
    if device != "cpu" and torch.cuda.is_available():
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    from ..config import environment
    attempts = max(0, environment.get_int("shifu.io.retries", 3)) + 1
    base = environment.get_int("shifu.io.retryBaseMs", 50) / 1000.0
    host, _, port = coordinator.rpartition(":")
    for attempt in range(attempts):
        try:
            store = dist.TCPStore(
                host, int(port), num_processes, is_master=process_id == 0,
                timeout=timedelta(seconds=CONNECT_TIMEOUT_S),
                wait_for_workers=False)
            dist.init_process_group(
                backend, store=store, rank=process_id,
                world_size=num_processes,
                timeout=timedelta(seconds=CONNECT_TIMEOUT_S))
            break
        except (OSError, RuntimeError, ValueError) as e:
            # a refused or timed-out connect surfaces as RuntimeError
            # (DistStoreError subclasses it); ValueError covers a
            # malformed address.  A ladder that ends still raises CODED.
            store = None
            if attempt + 1 >= attempts:
                from ..config.errors import ErrorCode, ShifuError
                raise ShifuError(
                    ErrorCode.ERROR_DCN_CONNECT,
                    f"coordinator {coordinator} (process "
                    f"{process_id}/{num_processes}) after {attempts} "
                    f"attempt(s): {e}") from e
            from .. import obs
            obs.counter("dcn.connect_retries").inc()
            delay = base * (2 ** attempt) * (1.0 + random.random())
            log.warning("torch.distributed init at %s failed (attempt "
                        "%d/%d, retrying in %.0f ms): %s", coordinator,
                        attempt + 1, attempts, delay * 1000, e)
            time.sleep(delay)
    log.info("joined the world at %s as rank %d of %d over %s%s",
             coordinator, process_id, num_processes, backend,
             "" if device == "cpu" or not torch.cuda.is_available()
             else f" on cuda:{torch.cuda.current_device()}")
    return backend
