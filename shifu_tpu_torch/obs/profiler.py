"""Profiler hook — opt-in ``torch.profiler`` capture per step; the port of
``shifu_tpu.obs.profiler``.

``shifu-tpu-torch <step> --profile [DIR]`` (or ``-Dshifu.profile=<DIR>``)
wraps the step's ``process()`` in ``torch.profiler.profile`` — CPU
activity, plus CUDA activity when the step computes on the card — and
writes a Chrome trace (``chrome://tracing`` / Perfetto) to
``<DIR>/<step>/trace.json``.  The hand kernels show there under their own
names (``hist_accum_kernel``, ``stats_hist_kernel``,
``forest_walk_kernel``, ...).  The always-on wall-clock spans live in
:mod:`shifu_tpu_torch.obs.tracer`; this knob adds the op view when
asked.  Off (the default), :func:`profile_step` is a free nullcontext.
"""

from __future__ import annotations

import contextlib
import logging
import os

log = logging.getLogger(__name__)


def profile_dir() -> str:
    """The configured capture root ('' = profiling off)."""
    from ..config import environment
    return environment.get_property("shifu.profile", "") or ""


def trace_file(step_name: str) -> str:
    return os.path.join(os.path.abspath(profile_dir()), step_name.lower(),
                        "trace.json")


def profile_step(step_name: str, device=None):
    """Context manager: a ``torch.profiler`` capture written to
    ``<profile_dir>/<step_name>/trace.json`` when profiling is configured,
    else a free nullcontext.  ``device`` is the step's device: CUDA
    activity is recorded when it is a CUDA device."""
    if not profile_dir():
        return contextlib.nullcontext()
    return _capture(step_name, device)


@contextlib.contextmanager
def _capture(step_name: str, device):
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = trace_file(step_name)
    activities = [ProfilerActivity.CPU]
    if getattr(device, "type", str(device)) == "cuda":
        activities.append(ProfilerActivity.CUDA)
    from . import tracer
    tracer.event("profile_capture", step=step_name, dir=os.path.dirname(out))
    log.info("profiler trace -> %s (chrome://tracing or Perfetto)", out)
    with profile(activities=activities) as prof:
        yield prof
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    prof.export_chrome_trace(out)
