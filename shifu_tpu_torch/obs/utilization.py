"""Utilization & roofline report — did the wall-clock buy real work?

``shifu-tpu-torch analysis --telemetry --utilization`` (the port's copy
of ``shifu_tpu.obs.utilization``) joins the cost records
(:mod:`obs.costs`: per-kernel operations / bytes accessed × launches)
against the fenced span wall times of each flush block and reports, per
PLANE (the executable-name prefix: ``nn.``, ``gbt.``, ``stats.``, …):

- total FLOPs and bytes moved, achieved FLOP/s and bytes/s over the
  step's main-thread wall-clock;
- percent of the device's peak FLOP/s and peak bandwidth (peak table in
  :mod:`obs.costs`, overridable via ``SHIFU_TPU_PEAK_FLOPS`` /
  ``SHIFU_TPU_PEAK_BW``);
- the roofline verdict: operational intensity (FLOPs/byte) under the
  machine balance point ⇒ *bandwidth-bound*, over ⇒ *compute-bound* —
  which roof the plane is actually pushing against;
- padding waste: padded vs real rows per window bucket
  (``ingest.rows_padded`` / ``ingest.rows_emitted``), the fraction of
  ingest/compute spent on rows that carry zero weight.

The port's cost records cover the four hand kernels only: each step's
block ends with a ``no cost record`` line for the torch ops outside them,
the one line (beside the device's peak row) that the reference does not
print for the same trace.

Rendering is DETERMINISTIC by construction — stable sorts (step order as
flushed, planes alphabetically) and fixed float formatting — so the
golden test diffs cleanly across runs on the same trace.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

from .costs import resolve_peaks
from .report import NO_TELEMETRY_HINT, load_blocks, trace_path


def _block_wall(block: Dict[str, Any]) -> float:
    """Main-thread root wall-clock of one flush block (the same total
    the span-tree report prints — ingest-thread spans overlap it)."""
    spans = block.get("spans") or []
    by_id = {s["id"]: s for s in spans}
    roots = [s for s in spans if s.get("parent") not in by_id]
    main = [s for s in roots if s.get("tid") in (None, "MainThread")]
    return sum(s.get("dur_s") or 0.0 for s in (main or roots))


def plane_of(name: str) -> str:
    """Executable name -> plane: the prefix before the first dot."""
    return str(name).split(".", 1)[0]


def aggregate_block(block: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """Per-plane totals for one block: flops, bytes, launches, compiles,
    executables (entries), analytic entry count."""
    planes: Dict[str, Dict[str, float]] = {}
    for c in block.get("costs") or []:
        p = planes.setdefault(plane_of(c.get("name")), {
            "flops": 0.0, "bytes": 0.0, "launches": 0, "compiles": 0,
            "executables": 0, "analytic": 0})
        launches = int(c.get("launches") or 0)
        p["launches"] += launches
        p["compiles"] += int(c.get("compiles") or 0)
        p["executables"] += 1
        if c.get("analytic"):
            p["analytic"] += 1
        if c.get("flops") is not None:
            p["flops"] += float(c["flops"]) * max(launches, 1)
        if c.get("bytes_accessed") is not None:
            p["bytes"] += float(c["bytes_accessed"]) * max(launches, 1)
    return planes


def verdict_for(flops: float, nbytes: float, peak_flops: float,
                peak_bw: float) -> str:
    """Roofline verdict from operational intensity vs machine balance."""
    if flops <= 0 and nbytes <= 0:
        return "no-cost-data"
    if nbytes <= 0:
        return "compute-bound"
    if flops <= 0:
        return "bandwidth-bound"
    balance = peak_flops / max(peak_bw, 1e-30)    # FLOPs/byte at the ridge
    return "compute-bound" if (flops / nbytes) >= balance \
        else "bandwidth-bound"


def _fmt_e(v: Optional[float]) -> str:
    return "-".rjust(9) if v is None else f"{v:9.3e}"


def _fmt_pct(v: Optional[float]) -> str:
    return "-".rjust(7) if v is None else f"{v:6.2%}".rjust(7)


def _padding_line(block: Dict[str, Any], out: List[str]) -> None:
    mvals = {m.get("name"): m.get("value")
             for m in block.get("metrics") or []}
    padded = mvals.get("ingest.rows_padded")
    real = mvals.get("ingest.rows_emitted")
    if not padded:
        return
    total = float(padded) + float(real or 0.0)
    frac = float(padded) / total if total else 0.0
    out.append(f"  padding waste: {padded:,.0f} padded of {total:,.0f} "
               f"window rows ({frac:.2%} of ingest/compute feeds "
               "zero-weight rows)")


def render_utilization(model_set_dir: str) -> str:
    """The ``--utilization`` payload for a model-set dir (missing/empty
    traces render the usual hint; exit stays 0 at the CLI)."""
    path = trace_path(model_set_dir)
    if not os.path.isfile(path):
        return f"{NO_TELEMETRY_HINT}\nexpected trace at {path}"
    skipped: List[str] = []
    blocks = load_blocks(path, skipped=skipped)
    if not blocks:
        return f"{NO_TELEMETRY_HINT}\ntrace {path} holds no records"
    backend = next((b["meta"].get("backend") for b in blocks
                    if b["meta"].get("backend")), None)
    peak_flops, peak_bw, label = resolve_peaks(backend)
    out: List[str] = [f"utilization: {path}"]
    if skipped:
        out.append(f"warning: {len(skipped)} torn line(s) skipped")
    kind = (backend or {}).get("device_kind", "unknown")
    out.append(f"device: {kind}  peaks[{label}]: "
               f"{peak_flops:.3e} FLOP/s, {peak_bw:.3e} B/s  "
               "(override: SHIFU_TPU_PEAK_FLOPS / SHIFU_TPU_PEAK_BW)")
    out.append("")

    grand_flops = grand_bytes = grand_wall = 0.0
    any_costs = False
    for block in blocks:
        planes = aggregate_block(block)
        if not planes:
            continue
        any_costs = True
        wall = _block_wall(block)
        step = block["meta"].get("step") or "(unlabeled)"
        out.append(f"== {step}  wall {wall:.3f}s")
        out.append(f"  {'plane':<10}{'flops':>10}{'bytes':>10}"
                   f"{'flop/s':>10}{'bytes/s':>10}{'%pkflop':>8}"
                   f"{'%pkbw':>8}{'fl/byte':>11}  verdict")
        for plane in sorted(planes):
            p = planes[plane]
            fl, by = p["flops"], p["bytes"]
            fps = fl / wall if wall > 0 else None
            bps = by / wall if wall > 0 else None
            pctf = (fps / peak_flops) if fps is not None else None
            pctb = (bps / peak_bw) if bps is not None else None
            inten = (fl / by) if by > 0 else None
            v = verdict_for(fl, by, peak_flops, peak_bw)
            out.append(f"  {plane:<10}{_fmt_e(fl):>10}{_fmt_e(by):>10}"
                       f"{_fmt_e(fps):>10}{_fmt_e(bps):>10}"
                       f"{_fmt_pct(pctf):>8}{_fmt_pct(pctb):>8}"
                       f"{_fmt_e(inten):>11}  {v}"
                       + ("  [analytic]" if p["analytic"] else ""))
            grand_flops += fl
            grand_bytes += by
        execs = sum(int(p["executables"]) for p in planes.values())
        compiles = sum(int(p["compiles"]) for p in planes.values())
        launches = sum(int(p["launches"]) for p in planes.values())
        mvals = {m.get("name"): m.get("value")
                 for m in block.get("metrics") or []}
        rec = mvals.get("xla.recompiles")
        out.append(f"  executables: {execs} costed, {compiles} compile(s), "
                   f"{launches} launch(es)"
                   + (f", {rec:.0f} RECOMPILE(S) from shape churn"
                      if rec else ""))
        _padding_line(block, out)
        out.append("  no cost record: torch ops outside the hand "
                   "kernels")
        grand_wall += wall
        out.append("")

    if not any_costs:
        out.append("no cost records in this trace — the hand kernels "
                   "record their launches when telemetry is enabled; "
                   "torch ops outside them carry no cost record")
        return "\n".join(out)
    mfu = grand_flops / (grand_wall * peak_flops) if grand_wall > 0 else 0.0
    out.append(f"pipeline: {_fmt_e(grand_flops).strip()} FLOPs, "
               f"{_fmt_e(grand_bytes).strip()} bytes over "
               f"{grand_wall:.3f}s costed wall — MFU {mfu:.2%}")
    return "\n".join(out)
