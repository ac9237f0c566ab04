"""Timeline export — span JSONL -> Chrome/Perfetto ``trace_event`` JSON.

``shifu-tpu-torch analysis --telemetry --timeline out.json`` (the port's
copy of ``shifu_tpu.obs.timeline``) converts the
telemetry trace into the Trace Event Format that ``chrome://tracing``
and https://ui.perfetto.dev load directly: every span becomes a complete
(``"ph": "X"``) event with microsecond timestamps, every point event an
instant (``"ph": "i"``), one process per flush block (the step run's
pid), and — the part that makes the ingest/compute overlap
visually auditable — INGEST-THREAD spans (``ingest.window_prep``, the
background prep/H2D pipeline) land on their own named track, separate
from the main thread's device-compute spans, so a starved accelerator
shows up as gaps on the compute track opposite solid bars on the ingest
track (the runtime-must-expose-timelines argument of the TF paper).

Track assignment: span records carry ``tid`` (the recording thread's
name, schema v5).  Sampled serving spans (``serve.request`` /
``serve.batch``, schema v8 — tid ``shifu-serve``) land on their own
``shifu-serve`` track so a request's queue-wait renders opposite the
batch launches that drained it; any other span recorded off the main
thread — or named ``ingest.*`` (pre-v5 traces have no ``tid``) —
routes to the ingest track.

Cross-process merge (:func:`export_merged_timeline`): N telemetry dirs
combine into ONE trace — every (dir, pid) pair becomes its own process
row (the per-proc tracks quorum/straggler analysis reads), and each
dir's span timestamps are normalized by its heartbeat-derived clock
offset (:func:`shifu_tpu_torch.obs.monitor.dir_clock_offset`) so skewed host
clocks line up on a common axis.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional, Sequence

from ..ioutil import atomic_write_text
from . import tracer
from .report import load_blocks, trace_path

log = logging.getLogger(__name__)

# fixed tids per process: compute first so it sorts on top in viewers
TID_MAIN = 1
TID_INGEST = 2
TID_SERVE = 3
TRACK_NAMES = {TID_MAIN: "step / device compute",
               TID_INGEST: "ingest (window prep + H2D wait)",
               TID_SERVE: "shifu-serve (sampled request / batch spans)"}


def _is_serve(rec: Dict[str, Any]) -> bool:
    return (rec.get("tid") == "shifu-serve"
            or str(rec.get("name", "")).startswith("serve."))


def _is_ingest(rec: Dict[str, Any]) -> bool:
    if str(rec.get("name", "")).startswith("ingest."):
        return True
    tid = rec.get("tid")
    return tid is not None and tid != "MainThread"


def _tid_for(rec: Dict[str, Any]) -> int:
    if _is_serve(rec):
        return TID_SERVE
    return TID_INGEST if _is_ingest(rec) else TID_MAIN


def _us(seconds: float) -> int:
    return int(round(float(seconds) * 1e6))


def to_trace_events(blocks: List[Dict[str, Any]],
                    skipped: Optional[List[str]] = None) -> Dict[str, Any]:
    """Trace Event Format document (JSON-object flavour) for a parsed
    trace (see :func:`shifu_tpu_torch.obs.report.load_blocks`).  Cost records
    (schema v6) annotate the output: every block's ROOT spans carry the
    block's total flops / bytes_accessed in ``args`` (Perfetto shows
    them in the span details pane) and each costed executable lands as
    an instant ``cost:<name>`` event with its per-signature numbers."""
    events: List[Dict[str, Any]] = []
    seen_pids: Dict[int, str] = {}
    for bi, block in enumerate(blocks):
        meta = block["meta"]
        pid = int(meta.get("pid") or (100000 + bi))
        step = meta.get("step") or "(unlabeled)"
        costs = block.get("costs") or []
        tot_flops = sum((c.get("flops") or 0.0)
                        * max(int(c.get("launches") or 0), 1)
                        for c in costs)
        tot_bytes = sum((c.get("bytes_accessed") or 0.0)
                        * max(int(c.get("launches") or 0), 1)
                        for c in costs)
        by_id = {s["id"]: s for s in block["spans"]}
        if pid not in seen_pids:
            seen_pids[pid] = step
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": f"shifu-tpu {step} "
                                              f"(pid {pid})"}})
            for tid, label in TRACK_NAMES.items():
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": tid,
                               "args": {"name": label}})
                events.append({"ph": "M", "name": "thread_sort_index",
                               "pid": pid, "tid": tid,
                               "args": {"sort_index": tid}})
        for s in block["spans"]:
            args = dict(s.get("attrs") or {}, span_id=s.get("id"),
                        parent=s.get("parent"))
            if costs and s.get("parent") not in by_id:
                # root span: the block's cost totals, visible in the
                # span-details pane
                args["flops"] = tot_flops
                args["bytes_accessed"] = tot_bytes
            events.append({
                "ph": "X", "name": s["name"], "cat": "span",
                "pid": pid,
                "tid": _tid_for(s),
                "ts": _us(s.get("ts") or 0.0),
                "dur": max(1, _us(s.get("dur_s") or 0.0)),
                "args": args,
            })
        for c in costs:
            events.append({
                "ph": "i", "s": "t", "name": f"cost:{c.get('name')}",
                "cat": "cost", "pid": pid, "tid": TID_MAIN,
                "ts": _us(meta.get("ts") or 0.0),
                "args": {"signature": c.get("signature"),
                         "flops": c.get("flops"),
                         "bytes_accessed": c.get("bytes_accessed"),
                         "launches": c.get("launches"),
                         "compiles": c.get("compiles"),
                         "analytic": bool(c.get("analytic"))},
            })
        for e in block["events"]:
            events.append({
                "ph": "i", "s": "t", "name": e["name"], "cat": "event",
                "pid": pid,
                "tid": _tid_for(e),
                "ts": _us(e.get("ts") or 0.0),
                "args": dict(e.get("attrs") or {}),
            })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "shifu-tpu telemetry",
            "schema_version": tracer.SCHEMA_VERSION,
            "steps": [b["meta"].get("step") for b in blocks],
            # a crash mid-write tears the final trace line; the export
            # skips it like report.py does and SURFACES the count here
            "torn_lines_skipped": len(skipped or []),
        },
    }


def export_timeline(model_set_dir: str, out_path: str,
                    skipped: Optional[List[str]] = None) -> Optional[str]:
    """Convert ``<modelset>/telemetry/trace.jsonl`` to ``out_path``.
    Returns the output path, or ``None`` (nothing written) when there is
    no telemetry to convert.  Torn trace lines (crash mid-write) are
    skipped exactly like ``report.py`` skips them — logged, counted in
    the output's ``otherData.torn_lines_skipped``, and appended to
    ``skipped`` when the caller wants to surface them."""
    path = trace_path(model_set_dir)
    if not os.path.isfile(path):
        return None
    if skipped is None:
        skipped = []
    blocks = load_blocks(path, skipped=skipped)
    if not blocks:
        return None
    if skipped:
        log.warning("timeline export: %d torn trace line(s) skipped "
                    "(crashed run mid-write?) — the valid prefix was "
                    "exported", len(skipped))
    doc = to_trace_events(blocks, skipped=skipped)
    atomic_write_text(out_path, json.dumps(doc))
    return out_path


def export_merged_timeline(dirs: Sequence[str], out_path: str,
                           skipped: Optional[List[str]] = None
                           ) -> Optional[str]:
    """Merge N process telemetry dirs into ONE trace_event document (see
    module docs): per-(dir, pid) process rows, clock-offset-normalized
    timestamps, dir-labelled process names.  Returns the output path, or
    None when no dir holds a readable trace."""
    from .monitor import dir_clock_offset
    if skipped is None:
        skipped = []
    blocks: List[Dict[str, Any]] = []
    offsets: Dict[str, float] = {}
    pid_map: Dict[tuple, int] = {}
    for d in dirs:
        path = trace_path(d)
        if not os.path.isfile(path):
            continue
        off = dir_clock_offset(d)
        label = os.path.basename(os.path.abspath(d))
        offsets[label] = round(off, 3)
        for b in load_blocks(path, skipped=skipped):
            meta = b["meta"]
            key = (d, meta.get("pid"))
            # distinct pids per (dir, proc): two hosts can share a pid
            pid_map.setdefault(key, len(pid_map) + 1)
            meta["pid"] = pid_map[key]
            meta["step"] = f"{label}/{meta.get('step') or '?'}"
            if meta.get("ts"):
                meta["ts"] = float(meta["ts"]) - off
            for rec in b["spans"] + b["events"]:
                if rec.get("ts"):
                    rec["ts"] = float(rec["ts"]) - off
            blocks.append(b)
    if not blocks:
        return None
    doc = to_trace_events(blocks, skipped=skipped)
    doc["otherData"]["merged_dirs"] = [os.path.abspath(d) for d in dirs]
    doc["otherData"]["clock_offsets"] = offsets
    atomic_write_text(out_path, json.dumps(doc))
    return out_path
