"""Report surface — render a telemetry trace as a per-step span tree.

``shifu-tpu-torch analysis --telemetry`` (the port's copy of
``shifu_tpu.obs.report``, a pure function of the trace files) reads ``<modelset>/telemetry/
trace.jsonl`` (blocks appended by each step's flush, see
:mod:`shifu_tpu_torch.obs.tracer` for the schema) and prints, per step: the
span tree with total and SELF time (total minus direct children — where
the step actually spent its wall-clock), rows/sec where a span carries a
``rows`` attribute, summarized per-epoch/tree events, and the metric
snapshot.  The closing line aggregates the whole pipeline.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

log = logging.getLogger(__name__)

TRACE_BASENAME = "trace.jsonl"

NO_TELEMETRY_HINT = ("no telemetry recorded (enable with "
                     "SHIFU_TPU_TELEMETRY=1, --telemetry, or "
                     "-Dshifu.telemetry=on)")


def trace_path(model_set_dir: str) -> str:
    return os.path.join(os.path.abspath(model_set_dir), "telemetry",
                        TRACE_BASENAME)


def load_blocks(path: str,
                skipped: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    """Parse the JSONL into flush blocks: ``{"meta", "spans", "events",
    "metrics", "costs"}`` per block.  Unparseable lines — a crash
    mid-write tears the final line — are SKIPPED with a warning (and
    appended to ``skipped`` when given), never a parse failure: a
    crashed run's partial trace is exactly the one you want to read."""
    blocks: List[Dict[str, Any]] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                log.warning("telemetry trace %s line %d is not valid JSON "
                            "(torn write from a crashed run?) — skipping",
                            path, lineno)
                if skipped is not None:
                    skipped.append(f"line {lineno}")
                continue
            kind = rec.get("kind")
            if kind == "meta":
                blocks.append({"meta": rec, "spans": [], "events": [],
                               "metrics": [], "costs": []})
                continue
            if not blocks:       # tolerate a headerless fragment
                blocks.append({"meta": {"step": None, "ts": None},
                               "spans": [], "events": [], "metrics": [],
                               "costs": []})
            if kind == "span":
                blocks[-1]["spans"].append(rec)
            elif kind == "event":
                blocks[-1]["events"].append(rec)
            elif kind == "metric":
                blocks[-1]["metrics"].append(rec)
            elif kind == "cost":
                blocks[-1]["costs"].append(rec)
    return blocks


def _fmt_attrs(attrs: Dict[str, Any], dur: float) -> str:
    parts = []
    rows = attrs.get("rows")
    if isinstance(rows, (int, float)) and dur > 0:
        parts.append(f"{rows:,.0f} rows ({rows / dur:,.0f} rows/s)")
    for k, v in attrs.items():
        if k in ("rows", "kind"):
            continue
        parts.append(f"{k}={v}")
    return ("  " + " ".join(parts)) if parts else ""


def _render_block(block: Dict[str, Any], out: List[str]) -> float:
    meta = block["meta"]
    spans = block["spans"]
    by_id = {s["id"]: s for s in spans}
    children: Dict[Any, List[dict]] = {}
    roots: List[dict] = []
    for s in spans:
        parent = s.get("parent")
        if parent in by_id:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    ev_by_parent: Dict[Any, List[dict]] = {}
    for e in block["events"]:
        ev_by_parent.setdefault(e.get("parent"), []).append(e)

    # wall-clock total counts MAIN-THREAD roots only: ingest-thread spans
    # (the prep pipeline) run CONCURRENTLY with the step and would
    # double-count the overlap the pipelining exists to create
    main_roots = [s for s in roots
                  if s.get("tid") in (None, "MainThread")]
    total = sum(s["dur_s"] for s in (main_roots or roots))
    ts = meta.get("ts")
    when = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts)) \
        if ts else "?"
    out.append(f"== {meta.get('step') or '(unlabeled)'}  {when}  "
               f"total {total:.3f}s")

    def _events_line(span_id: Any, indent: str) -> None:
        evs = ev_by_parent.pop(span_id, None)
        if not evs:
            return
        by_name: Dict[str, List[dict]] = {}
        for e in evs:
            by_name.setdefault(e["name"], []).append(e)
        for name, group in by_name.items():
            last = group[-1]["attrs"]
            tail = " ".join(f"{k}={_num(v)}" for k, v in last.items())
            out.append(f"{indent}· {name} ×{len(group)}"
                       + (f"  (last: {tail})" if tail else ""))

    def _walk(s: dict, depth: int) -> None:
        kids = sorted(children.get(s["id"], []), key=lambda c: c["ts"])
        self_s = s["dur_s"] - sum(k["dur_s"] for k in kids)
        indent = "  " * depth
        label = f"{indent}{s['name']}"
        out.append(f"{label:<38}{s['dur_s']:>10.3f}s  self "
                   f"{max(self_s, 0.0):>8.3f}s"
                   f"{_fmt_attrs(s.get('attrs') or {}, s['dur_s'])}")
        _events_line(s["id"], indent + "  ")
        for group in _grouped(kids):
            if len(group) == 1:
                _walk(group[0], depth + 1)
            else:
                _agg_line(group, depth + 1)

    def _agg_line(group: List[dict], depth: int) -> None:
        """Repeated same-name siblings (per-window ingest spans, per-tree
        spans) collapse to one aggregate line — a 500-window sweep is one
        line with a count, not 500."""
        indent = "  " * depth
        dur = sum(g["dur_s"] for g in group)
        rows = sum(g.get("attrs", {}).get("rows") or 0 for g in group)
        label = f"{indent}{group[0]['name']} ×{len(group)}"
        tail = f"  {rows:,.0f} rows ({rows / dur:,.0f} rows/s)" \
            if rows and dur > 0 else ""
        out.append(f"{label:<38}{dur:>10.3f}s  (aggregated){tail}")

    for group in _grouped(sorted(roots, key=lambda s: s["ts"])):
        if len(group) == 1:
            _walk(group[0], 1)
        else:
            _agg_line(group, 1)
    _events_line(None, "  ")          # events outside any span
    for m in block["metrics"]:
        if m["type"] == "histogram":
            mean = m["sum"] / m["count"] if m.get("count") else 0.0
            out.append(f"  metric {m['name']}: count={m['count']} "
                       f"mean={mean:.4g} min={_num(m['min'])} "
                       f"max={_num(m['max'])}")
        else:
            out.append(f"  metric {m['name']}: {_num(m.get('value'))} "
                       f"({m['type']})")
    # ingest stall: fraction of the step's wall-clock the consumer spent
    # blocked waiting for windows/H2D (the accelerator-starvation signal
    # the out-of-core overhaul exists to drive toward zero)
    wait = next((m.get("value") for m in block["metrics"]
                 if m.get("name") == "ingest.h2d_wait_seconds"), None)
    if wait is not None and total > 0:
        frac = min(float(wait) / total, 1.0)
        out.append(f"  ingest stall fraction: {frac:.1%} "
                   f"({float(wait):.3f}s blocked on ingest of "
                   f"{total:.3f}s wall)")
    # parse stall: fraction of the step's wall-clock the consumer spent
    # blocked on the raw-shard parse pool (0 when the pool keeps ahead
    # of the accumulators or the pass was served from the raw cache)
    mvals = {m.get("name"): m.get("value") for m in block["metrics"]}
    pstall = mvals.get("ingest.parse_stall_frac")
    if pstall is not None:
        out.append(f"  parse stall fraction: {float(pstall):.1%} "
                   "(consumer blocked on the parse pool)")
    hits, misses = (mvals.get("rawcache.hits"),
                    mvals.get("rawcache.misses"))
    if hits or misses:
        mb = (mvals.get("rawcache.bytes_written") or 0) / 1e6
        out.append(f"  raw cache: {int(hits or 0)} pass(es) served "
                   f"decoded, {int(misses or 0)} parsed from text"
                   + (f", {mb:,.1f} MB written" if mb else ""))
    # disk-tail plane: how often the out-of-core remainder re-streamed
    # (the super-batch schedule's cost driver — passes, not rows, are
    # what the one-pass-feeds-everything restructure bounds)
    sweeps = mvals.get("train.tail_sweeps")
    if sweeps:
        passes = mvals.get("ingest.disk_passes") or 0
        repairs = mvals.get("train.tail_repairs") or 0
        rlevels = mvals.get("train.tail_repair_levels") or 0
        line = (f"  tail sweeps: {int(sweeps)} "
                f"({int(passes)} disk passes total")
        if repairs:
            line += (f", {int(repairs)} speculation repairs over "
                     f"{int(rlevels)} levels")
        out.append(line + ")")
    return total


def _num(v: Any) -> Any:
    if isinstance(v, float):
        return f"{v:.6g}"
    return v


# siblings sharing a name above this count render as one aggregate line
AGGREGATE_OVER = 3


def _grouped(spans: List[dict]) -> List[List[dict]]:
    """Partition an ordered sibling list: names occurring more than
    ``AGGREGATE_OVER`` times become one group, everything else stays a
    singleton in original order."""
    by_name: Dict[str, int] = {}
    for s in spans:
        by_name[s["name"]] = by_name.get(s["name"], 0) + 1
    groups: List[List[dict]] = []
    agg: Dict[str, List[dict]] = {}
    for s in spans:
        if by_name[s["name"]] > AGGREGATE_OVER:
            bucket = agg.get(s["name"])
            if bucket is None:
                bucket = agg[s["name"]] = []
                groups.append(bucket)
            bucket.append(s)
        else:
            groups.append([s])
    return groups


def _render_drift(model_set_dir: str, out: List[str]) -> None:
    """The drift section: the live PSI table ``obs/drift`` emitted as
    ``telemetry/drift.json`` (absent = no drift monitor ran)."""
    path = os.path.join(os.path.abspath(model_set_dir), "telemetry",
                        "drift.json")
    if not os.path.isfile(path):
        return
    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, json.JSONDecodeError):
        out.append(f"drift: {path} unreadable (torn write?)")
        return
    out.append(f"drift: {d.get('rows', 0):,} live rows vs training "
               f"snapshot (threshold {d.get('threshold')})")
    cols = sorted((d.get("columns") or {}).items(),
                  key=lambda kv: -kv[1])
    for name, v in cols[:10]:
        flag = "  << DRIFTING" if v > (d.get("threshold") or 0.25) else ""
        out.append(f"  psi {name}: {v:.4f}{flag}")
    if len(cols) > 10:
        out.append(f"  ... {len(cols) - 10} more column(s) in {path}")
    flagged = d.get("flagged") or []
    out.append(f"  {len(flagged)} column(s) over threshold"
               + (f": {', '.join(flagged)}" if flagged else ""))
    out.append("")


def _q(v: Any) -> str:
    return "-" if v is None else f"{float(v):.4f}"


def _render_quality(model_set_dir: str, out: List[str]) -> None:
    """The model-quality section: the live AUC / calibration / score-PSI
    table ``obs/quality`` emitted as ``telemetry/quality.json`` (absent
    = the score-log plane never ran).  Rendering is byte-deterministic
    for a given artifact: generations sorted newest-first, fixed-width
    floats."""
    path = os.path.join(os.path.abspath(model_set_dir), "telemetry",
                        "quality.json")
    if not os.path.isfile(path):
        return
    try:
        with open(path) as f:
            q = json.load(f)
    except (OSError, json.JSONDecodeError):
        out.append(f"quality: {path} unreadable (torn write?)")
        return
    out.append(f"quality: {int(q.get('joined') or 0):,} joined rows vs "
               f"posttrain baseline auc {_q(q.get('baseline_auc'))} "
               f"(delta threshold {_q(q.get('auc_delta'))}, "
               f"psi threshold {_q(q.get('psi_threshold'))})")
    gens = sorted(((int(g), row) for g, row in
                   (q.get("generations") or {}).items()), reverse=True)
    for g, row in gens:
        out.append(f"  gen {g}: auc={_q(row.get('live_auc'))} "
                   f"ece={_q(row.get('ece'))} "
                   f"psi={_q(row.get('psi'))}  "
                   f"{int(row.get('joined') or 0):,} joined / "
                   f"{int(row.get('scored') or 0):,} scored")
    if q.get("degraded"):
        out.append("  << QUALITY DEGRADED "
                   f"({', '.join(q.get('reasons') or [])})")
    out.append("")


def render_telemetry(model_set_dir: str) -> str:
    """The ``analysis --telemetry`` payload for a model-set dir.  Missing
    or empty traces render a hint, not an error — the CLI exits 0 either
    way (a monitoring query on a fresh model set is not a failure)."""
    path = trace_path(model_set_dir)
    if not os.path.isfile(path):
        return f"{NO_TELEMETRY_HINT}\nexpected trace at {path}"
    skipped: List[str] = []
    blocks = load_blocks(path, skipped=skipped)
    if not blocks:
        return (f"{NO_TELEMETRY_HINT}\ntrace {path} "
                + ("holds no parseable records "
                   f"({len(skipped)} torn line(s) skipped)" if skipped
                   else "is empty"))
    out: List[str] = [f"telemetry: {path}",
                      f"schema v{blocks[-1]['meta'].get('schema_version')}"
                      f", {len(blocks)} step record(s)"]
    if skipped:
        out.append(f"warning: {len(skipped)} torn line(s) skipped "
                   f"({', '.join(skipped[:5])}) — crashed run mid-write")
    out.append("")
    grand = 0.0
    for block in blocks:
        grand += _render_block(block, out)
        out.append("")
    _render_drift(model_set_dir, out)
    _render_quality(model_set_dir, out)
    out.append(f"pipeline total: {grand:.3f}s across {len(blocks)} "
               "step record(s)")
    return "\n".join(out)


def render_telemetry_merged(dirs: List[str]) -> str:
    """``analysis --telemetry --aggregate``: N process telemetry dirs as
    ONE report — each dir's span tree (headed by its clock offset) plus
    the merged per-proc step-lag table from the health plane."""
    from .monitor import (aggregate_records, dir_clock_offset,
                          step_lag_table)
    out: List[str] = [f"merged telemetry over {len(dirs)} dir(s)"]
    for d in dirs:
        off = dir_clock_offset(d)
        out.append("")
        out.append(f"==== {os.path.abspath(d)} "
                   f"(clock offset {off:+.1f}s)")
        out.append(render_telemetry(d))
    recs, _counts = aggregate_records(dirs)
    if recs:
        out.append("")
        out.append("==== per-proc step lag (health plane, "
                   "clock-normalized)")
        for row in step_lag_table(recs):
            lag_s = f"{row['lag_s']:.1f}s" \
                if row["lag_s"] is not None else "-"
            out.append(f"  {row['step']:<11}{(row['proc'] or '?'):<22}"
                       f"{(row['dir'] or '?'):<14}"
                       f"rows {row['rows']:<12,.0f}"
                       f"lag {row['rows_lag']:<10,.0f}{lag_s}")
    return "\n".join(out)
