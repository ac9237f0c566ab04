"""Device cost-attribution plane — the port's copy of
``shifu_tpu.obs.costs``: bytes and operations accounting per hand kernel.

The span tree says *where* wall-clock goes; this module says *what work
the card was asked to do* in it.  Each of the four hand kernels registers
an analytic cost model here (:func:`register_cost_model`) and its wrapper
records one launch per kernel launch (:func:`record_model_launch`),
graph replays included; the records flush into the telemetry JSONL as
``{"kind": "cost", ...}`` lines beside the spans and metrics, and
``analysis --telemetry --utilization`` joins them against the span wall
times.

**The models count what the CUDA kernels do**, not what the TPU kernels
do: the reference's ``hist_kernel_cost`` counts the MXU one-hot products
(2·K·N·B multiply-adds a histogram) that the port's shared-memory adds
never perform.  ``bytes_accessed`` is each input read once and each
output written once; ``flops`` is the integer operations of the kernel
(one fixed-point add per (row, column, channel) for a histogram, eight
per (tree, row, level) for the forest walk).  A record has the launch's
shapes only, so **each model is an upper bound**: it is the count that
``PERF.md`` §6's bounds use (``hist_bytes``, ``hist_batch_bytes``,
``stats_hist_bytes``) with every row active, and for the forest walk
every node's split feature, left-mask row and leaf value read
(``traverse_bytes`` charges only what a walk reaches).  A bytes/s rate
from these models overstates what the card moved wherever rows are
inactive or a walk skips nodes.  The record names are
the reference's (``pallas.hist`` for B1 and B2, ``pallas.tree_traverse``
for B4), so both packages' report code groups a trace the same way, plus
``stats.stats_hist`` for B3; the reference's ``tree.scatter_hist`` names
an XLA scatter the port does not have.  On the CPU the kernels' plain
versions record under the same names.

The reference's ``costed_jit`` and ``record_executable`` read XLA's cost
analysis of a compiled executable; eager PyTorch has no such executable,
so they have no counterpart, and torch ops outside the hand kernels carry
no cost record (the utilization report says so for each step).  Nor is
there a shape-churn recompile sentinel (``xla.recompiles``).

The peak table holds this card only: the H100 80GB HBM3's datasheet
figures (3.35e12 B/s of HBM3, 67e12 FP32 operations/s), matched from
``torch.cuda.get_device_name()``, and a CPU placeholder row; the
``SHIFU_TPU_PEAK_FLOPS`` / ``SHIFU_TPU_PEAK_BW`` variables override it.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import tracer

log = logging.getLogger(__name__)


# ------------------------------------------------------------ peak table
# (substring of the lower-cased device name, peak operations/s, peak B/s):
# NVIDIA's datasheet figures for the H100 SXM5 80GB HBM3; the CPU row is
# an order-of-magnitude placeholder so the report renders
DEVICE_PEAKS: Tuple[Tuple[str, float, float], ...] = (
    ("h100 80gb hbm3", 67e12, 3.35e12),
    ("cpu", 1e11, 5e10),
)
GENERIC_PEAKS = (1e11, 5e10)


def backend_info() -> Dict[str, str]:
    """(platform, device_kind) stamped into the flush meta: ``gpu`` and
    the card's name when CUDA is up, else ``cpu``."""
    try:
        import torch
        if torch.cuda.is_available():
            return {"platform": "gpu",
                    "device_kind": torch.cuda.get_device_name(0)}
    except Exception:                      # noqa: BLE001 — best effort
        pass
    return {"platform": "cpu", "device_kind": "cpu"}


def resolve_peaks(backend: Optional[Dict[str, str]] = None
                  ) -> Tuple[float, float, str]:
    """(peak operations/s, peak B/s, provenance label).  Env overrides
    beat the table: ``SHIFU_TPU_PEAK_FLOPS`` / ``SHIFU_TPU_PEAK_BW``."""
    backend = backend or backend_info()
    kind = str(backend.get("device_kind") or "").lower()
    platform = str(backend.get("platform") or "").lower()
    flops = bw = None
    label = "generic fallback"
    for sub, f, b in DEVICE_PEAKS:
        if sub in kind or sub == platform:
            flops, bw, label = f, b, sub
            break
    if flops is None:
        flops, bw = GENERIC_PEAKS
    for env, idx in (("SHIFU_TPU_PEAK_FLOPS", 0), ("SHIFU_TPU_PEAK_BW", 1)):
        v = os.environ.get(env)
        if v:
            try:
                if idx == 0:
                    flops = float(v)
                else:
                    bw = float(v)
                label += f" +{env}"
            except ValueError:
                log.warning("ignoring unparseable %s=%r", env, v)
    return flops, bw, label


# -------------------------------------------------------------- registry
class _Entry:
    """One (name, shape signature) kernel's accumulated accounting."""

    __slots__ = ("name", "signature", "flops", "bytes_accessed", "launches")

    def __init__(self, name: str, signature: str, flops: float,
                 bytes_accessed: float):
        self.name = name
        self.signature = signature
        self.flops = flops
        self.bytes_accessed = bytes_accessed
        self.launches = 0          # since the last snapshot(reset=True)

    def to_record(self) -> Dict[str, Any]:
        return {"kind": "cost", "name": self.name,
                "signature": self.signature, "flops": self.flops,
                "bytes_accessed": self.bytes_accessed, "compiles": 0,
                "launches": self.launches, "analytic": True}


class CostRegistry:
    """Process-wide kernel cost table; thread-safe (the streamed window
    loop launches while the heartbeat / exporter threads snapshot)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, Any], _Entry] = {}

    def launch(self, name: str, key: Any, signature: str,
               model: Callable[[], Dict[str, float]]) -> None:
        with self._lock:
            ent = self._entries.get((name, key))
        if ent is None:
            est = model()
            with self._lock:
                ent = self._entries.setdefault((name, key), _Entry(
                    name, signature, float(est.get("flops") or 0.0),
                    float(est.get("bytes_accessed") or 0.0)))
        with self._lock:
            ent.launches += 1

    def snapshot(self, reset: bool = False) -> List[Dict[str, Any]]:
        """Cost records with launches since the last reset, sorted by
        (name, signature) so the trace is diff-friendly."""
        with self._lock:
            ents = [e for _, e in sorted(self._entries.items(),
                                         key=lambda kv: (kv[1].name,
                                                         kv[1].signature))
                    if e.launches]
            recs = [e.to_record() for e in ents]
            if reset:
                for e in ents:
                    e.launches = 0
        return recs

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()


_registry = CostRegistry()
_models: Dict[str, Callable[..., Dict[str, float]]] = {}


def cost_snapshot(reset: bool = False) -> List[Dict[str, Any]]:
    return _registry.snapshot(reset=reset)


def reset_for_tests() -> None:
    # the model table is not cleared: models register at kernel-module
    # import, not per run
    _registry.reset()


def register_cost_model(name: str,
                        fn: Callable[..., Dict[str, float]]) -> None:
    """Register an analytic model: ``fn(**shape_kwargs)`` returns a dict
    with ``flops`` and ``bytes_accessed``."""
    _models[name] = fn


def cost_models() -> Dict[str, Callable[..., Dict[str, float]]]:
    """The registered analytic models, by name."""
    return dict(_models)


def record_model_launch(name: str, **shape_kwargs) -> None:
    """Record one launch of an analytically modelled kernel, keyed by its
    shape kwargs.  No-op when telemetry is off or the model is unknown."""
    if not tracer.enabled():
        return
    model = _models.get(name)
    if model is None:
        log.debug("no cost model registered under %r", name)
        return
    key = tuple(sorted(shape_kwargs.items()))
    sig = ",".join(f"{k}={v}" for k, v in key)
    _registry.launch(name, key, sig, lambda: model(**shape_kwargs))
