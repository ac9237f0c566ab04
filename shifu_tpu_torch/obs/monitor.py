"""``shifu-tpu-torch monitor`` — tail the health directory, render live
status; the port's copy of ``shifu_tpu.obs.monitor``.

Reads the heartbeat files :mod:`obs.health` writers commit under
``<modelset>/telemetry/health/`` and renders one line per process:
step, state (live / stalled / stale / exited), heartbeat age, the phase
each thread is in right now, and the progress counters (rows, windows,
trees, epochs).  SERVE heartbeats additionally carry queue depth, the
compact SLO summary, and (when the score-log plane is on) the compact
model-quality summary — queue buildup, a firing burn-rate alert and a
degraded quality verdict get their own ``<<`` flags.  The summary line
carries the quorum
fraction — ``healthy / total`` — the primitive the elastic
straggler/quorum logic reads.

``--aggregate DIR DIR ...`` merges the health directories of N
processes (one telemetry dir per process/host) into ONE report: a
single merged table tagged by source dir, a merged quorum line, and a
per-proc STEP-LAG table — for each step, every proc's progress against
the front-runner (rows behind, seconds since progress), the per-worker
lag signal the DAG-of-sync-SGD model frames for straggler detection.
Cross-host clocks are normalized per dir: the writer's embedded ``ts``
minus the health file's mtime (both stamp the same atomic commit; on a
shared filesystem the mtime comes from the common fileserver clock)
estimates each process's clock offset, and offsets beyond
``CLOCK_OFFSET_MIN_S`` are subtracted from ages/lags.

Stateless by design: every render is a fresh read of the directory, so
the monitor can attach to (and detach from) a running job at any time,
from any process, with no coordination.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import tracer
from .health import classify, health_dir_for, read_health

# `monitor --once --json` exit code when any process is stalled/stale —
# distinct from generic failure (1) and the bench/schema mismatch (2)
EXIT_UNHEALTHY = 3

_STATE_FLAGS = {"live": "", "stalled": "  << STALLED (no progress)",
                "stale": "  << STALE (no heartbeat)", "exited": ""}

# per-dir clock offsets smaller than this are mtime/commit jitter, not
# skew — leave them unapplied so same-host dirs stay byte-stable
CLOCK_OFFSET_MIN_S = 1.0


def quorum_objective() -> float:
    """The QUORUM LOST threshold — the same ``shifu.dcn.quorumFrac``
    the elastic step protocol closes on (parallel/elastic): when fewer
    than this fraction of active processes are still heartbeating, the
    job can no longer close steps by quorum."""
    from ..config import environment
    return environment.get_float("shifu.dcn.quorumFrac", 0.97)


def _quorum_state(recs: List[Dict[str, Any]], counts: Dict[str, int]
                  ) -> Tuple[int, int, float, bool]:
    """(healthy, active, quorum fraction, lost?) — stalled counts as
    heartbeating (a straggler is alive), stale/dead does not."""
    healthy = counts.get("live", 0) + counts.get("stalled", 0)
    active = len(recs) - counts.get("exited", 0)
    quorum = healthy / active if active else 1.0
    return healthy, active, quorum, bool(active) and \
        quorum < quorum_objective()


def _age(rec: Dict[str, Any], now: float) -> float:
    return max(0.0, now - float(rec.get("ts") or 0.0))


def _fmt_count(v: Any) -> str:
    if v is None:
        return "-"
    return f"{v:,.0f}"


def _fmt_quality(v: Any) -> str:
    if v is None:
        return "-"
    return f"{float(v):.4f}"


def fleet_quality(recs: List[Dict[str, Any]]
                  ) -> Optional[Dict[str, Any]]:
    """Merge per-process SERVE quality extras into ONE fleet row: the
    worst (min) live AUC and worst (max) score PSI — per generation and
    overall — summed joined rows, OR'd degradation.  ``None`` when no
    record carries quality extras (plane off fleet-wide)."""
    rows = [r.get("quality") for r in recs if r.get("quality")]
    if not rows:
        return None
    gens: Dict[int, Optional[float]] = {}
    for q in rows:
        for g, auc in (q.get("generations") or {}).items():
            g = int(g)
            if auc is None:
                gens.setdefault(g, None)
            elif gens.get(g) is None:
                gens[g] = float(auc)
            else:
                gens[g] = min(gens[g], float(auc))
    aucs = [float(q["live_auc"]) for q in rows
            if q.get("live_auc") is not None]
    psis = [float(q["score_psi"]) for q in rows
            if q.get("score_psi") is not None]
    return {
        "procs": len(rows),
        "live_auc": round(min(aucs), 6) if aucs else None,
        "score_psi": round(max(psis), 6) if psis else None,
        "joined": sum(int(q.get("joined") or 0) for q in rows),
        "degraded": any(q.get("degraded") for q in rows),
        "generations": {g: (round(gens[g], 6)
                            if gens[g] is not None else None)
                        for g in sorted(gens)},
    }


def status_records(model_set_dir: str, now: Optional[float] = None
                   ) -> Tuple[List[Dict[str, Any]], Dict[str, int]]:
    """(records, state counts) for a model set — each record is the
    health file's content plus ``status`` and ``age_s``."""
    now = time.time() if now is None else now
    recs = read_health(health_dir_for(model_set_dir))
    counts: Dict[str, int] = {}
    for rec in recs:
        rec["status"] = classify(rec, now=now)
        rec["age_s"] = round(_age(rec, now), 3)
        counts[rec["status"]] = counts.get(rec["status"], 0) + 1
    return recs, counts


def _row_flags(rec: Dict[str, Any]) -> str:
    """Staleness + serving-plane flags for one table row."""
    flags = _STATE_FLAGS.get(rec["status"], "")
    slo = rec.get("slo") or {}
    if slo.get("alerting"):
        burns = ",".join(slo.get("alerts") or []) or "burn"
        flags += f"  << SLO BURN ({burns})"
    if rec.get("queue_buildup"):
        flags += "  << QUEUE BUILDUP"
    if rec.get("mode") == "brownout":
        flags += "  << BROWNOUT"
    if (rec.get("quality") or {}).get("degraded"):
        flags += "  << QUALITY DEGRADED"
    return flags


def _row_phase(rec: Dict[str, Any]) -> str:
    phase = rec.get("phase") or "-"
    ingest = [f"{t}:{s}" for t, s in (rec.get("spans") or {}).items()
              if t != "MainThread"]
    if ingest:
        phase += "  [" + " ".join(sorted(ingest)) + "]"
    qd = rec.get("queue_depth")
    if qd is not None:
        phase += f"  q={qd:,.0f}"
    slo = rec.get("slo") or {}
    if slo.get("p99_ms") is not None:
        phase += (f"  p99={slo['p99_ms']:.2f}/"
                  f"{slo.get('objective_p99_ms', 0):.2f}ms")
    return phase


def _render_table(recs: List[Dict[str, Any]], counts: Dict[str, int],
                  with_dir: bool = False) -> List[str]:
    """The per-process table + quorum line (shared by the single-dir and
    aggregate renders)."""
    dir_h = f"{'DIR':<14}" if with_dir else ""
    out = [f"{dir_h}{'PROC':<22}{'STEP':<11}{'STATE':<9}{'AGE':>7}  "
           f"{'ROWS':>12}{'WINDOWS':>9}{'TREES':>7}{'EPOCHS':>7}  PHASE"]
    for rec in recs:
        dir_c = f"{rec.get('_dir_label', '?'):<14}" if with_dir else ""
        out.append(
            f"{dir_c}"
            f"{rec.get('proc', '?'):<22}{(rec.get('step') or '-'):<11}"
            f"{rec['status']:<9}{rec['age_s']:>6.1f}s  "
            f"{_fmt_count(rec.get('rows')):>12}"
            f"{_fmt_count(rec.get('windows')):>9}"
            f"{_fmt_count(rec.get('trees')):>7}"
            f"{_fmt_count(rec.get('epochs')):>7}  {_row_phase(rec)}"
            f"{_row_flags(rec)}")
    for rec in recs:
        rf = rec.get("refresh")
        if rf:
            # the refresh controller's heartbeat extras: lifecycle state,
            # last journalled decision, serving generation + rollback
            # window depth
            out.append(
                f"-- refresh[{rec.get('proc', '?')}]: "
                f"{rf.get('state', '?')}"
                f"  last={rf.get('last_decision') or '-'}"
                f"  outcome={rf.get('last_outcome') or '-'}"
                f"  gen={rf.get('generation', 0)}"
                f" (+{rf.get('generations_held', 0)} held)"
                f"  cycle={rf.get('cycle', 0)}")
    for rec in recs:
        q = rec.get("quality")
        if q:
            # the SERVE heartbeat's compact model-quality summary:
            # rolling live AUC / score PSI over the joined window
            gens = " ".join(
                f"g{g}={_fmt_quality(v)}" for g, v in
                sorted(((int(g), v) for g, v in
                        (q.get("generations") or {}).items())))
            out.append(
                f"-- quality[{rec.get('proc', '?')}]: "
                f"auc={_fmt_quality(q.get('live_auc'))}"
                f"  psi={_fmt_quality(q.get('score_psi'))}"
                f"  joined={int(q.get('joined') or 0):,}"
                + (f"  [{gens}]" if gens else ""))
    healthy, active, quorum, lost = _quorum_state(recs, counts)
    parts = [f"{counts.get(k, 0)} {k}" for k in
             ("live", "stalled", "stale", "exited") if counts.get(k)]
    out.append(f"-- {', '.join(parts) or 'no processes'}; "
               f"quorum {healthy}/{active} ({quorum:.0%}) of active "
               "processes heartbeating")
    if lost:
        out.append(f"-- << QUORUM LOST: {quorum:.0%} heartbeating is "
                   f"below shifu.dcn.quorumFrac "
                   f"{quorum_objective():.2f} — elastic steps can only "
                   "close by timeout; check the stale processes")
    return out


def render_status(model_set_dir: str, now: Optional[float] = None) -> str:
    """One monitor frame: the table + quorum summary."""
    now = time.time() if now is None else now
    recs, counts = status_records(model_set_dir, now=now)
    if not recs:
        return (f"no health records under "
                f"{health_dir_for(model_set_dir)}\n"
                "start a step with telemetry enabled "
                "(SHIFU_TPU_TELEMETRY=1 / --telemetry) to emit heartbeats")
    return "\n".join(_render_table(recs, counts))


def status_json(model_set_dir: str, now: Optional[float] = None
                ) -> Tuple[Dict[str, Any], int]:
    """(one machine-readable snapshot doc, exit code) — the ``monitor
    --once --json`` payload CI/cron scripts consume instead of scraping
    the human table.  Exit 0 when every process is live/exited (or the
    dir is empty: nothing running is not unhealthy); EXIT_UNHEALTHY (3)
    when ANY process is stalled or stale, or any SERVE process reports
    a degraded model-quality verdict."""
    now = time.time() if now is None else now
    recs, counts = status_records(model_set_dir, now=now)
    for rec in recs:
        rec.pop("_file", None)               # host path, not health state
    healthy, active, quorum, lost = _quorum_state(recs, counts)
    fq = fleet_quality(recs)
    unhealthy = counts.get("stalled", 0) + counts.get("stale", 0)
    doc = {
        "kind": "monitor",
        "schema_version": tracer.SCHEMA_VERSION,
        "ts": round(now, 3),
        "health_dir": health_dir_for(model_set_dir),
        "procs": recs,
        "quality": fq,
        "summary": {
            "total": len(recs),
            "counts": {k: counts.get(k, 0)
                       for k in ("live", "stalled", "stale", "exited")},
            "active": active,
            "healthy": healthy,
            "quorum": round(quorum, 4),
            "quorum_lost": lost,
        },
    }
    degraded = bool(fq and fq["degraded"])
    return doc, (EXIT_UNHEALTHY if unhealthy or lost or degraded else 0)


# ------------------------------------------------- cross-process merge
def record_clock_offset(rec: Dict[str, Any]) -> float:
    """Writer-clock minus fileserver-clock estimate for one health
    record: the embedded ``ts`` and the file mtime stamp the SAME atomic
    commit, so their difference is the writer's clock offset (plus
    commit jitter — see CLOCK_OFFSET_MIN_S)."""
    path = rec.get("_file")
    if not path:
        return 0.0
    try:
        return float(rec.get("ts") or 0.0) - os.path.getmtime(path)
    except OSError:
        return 0.0


def dir_clock_offset(model_set_dir: str) -> float:
    """The dir-level clock offset (median over its health records);
    offsets under CLOCK_OFFSET_MIN_S collapse to 0 (jitter, not skew)."""
    offs = sorted(record_clock_offset(r)
                  for r in read_health(health_dir_for(model_set_dir)))
    if not offs:
        return 0.0
    off = offs[len(offs) // 2]
    return off if abs(off) >= CLOCK_OFFSET_MIN_S else 0.0


def aggregate_records(dirs: Sequence[str], now: Optional[float] = None
                      ) -> Tuple[List[Dict[str, Any]], Dict[str, int]]:
    """Merged, clock-normalized health records across N telemetry dirs.
    Each record gains ``_dir`` / ``_dir_label`` / ``clock_offset_s``;
    ages and staleness are computed on the NORMALIZED timestamps so a
    skewed-clock host is not misread as stale (or freshly alive)."""
    now = time.time() if now is None else now
    recs: List[Dict[str, Any]] = []
    counts: Dict[str, int] = {}
    for d in dirs:
        off = dir_clock_offset(d)
        label = os.path.basename(os.path.abspath(d))
        for rec in read_health(health_dir_for(d)):
            if off:
                for key in ("ts", "started_ts", "last_progress_ts"):
                    if rec.get(key):
                        rec[key] = float(rec[key]) - off
            rec["_dir"] = d
            rec["_dir_label"] = label
            rec["clock_offset_s"] = round(off, 3)
            rec["status"] = classify(rec, now=now)
            rec["age_s"] = round(_age(rec, now), 3)
            counts[rec["status"]] = counts.get(rec["status"], 0) + 1
            recs.append(rec)
    recs.sort(key=lambda r: (r.get("_dir_label") or "",
                             r.get("proc") or ""))
    return recs, counts


def step_lag_table(recs: List[Dict[str, Any]],
                   now: Optional[float] = None) -> List[Dict[str, Any]]:
    """Per-proc lag against the front-runner of its step: rows behind
    the max-progress process and seconds since the proc last advanced,
    on clock-normalized timestamps — the per-worker lag signal quorum/
    straggler logic consumes."""
    now = time.time() if now is None else now
    by_step: Dict[str, List[Dict[str, Any]]] = {}
    for rec in recs:
        by_step.setdefault(rec.get("step") or "-", []).append(rec)
    out: List[Dict[str, Any]] = []
    for step in sorted(by_step):
        group = by_step[step]
        max_rows = max(float(r.get("rows") or 0.0) for r in group)
        max_prog = max(float(r.get("last_progress_ts") or 0.0)
                       for r in group)
        for r in group:
            rows = float(r.get("rows") or 0.0)
            prog = float(r.get("last_progress_ts") or 0.0)
            out.append({
                "step": step,
                "proc": r.get("proc"),
                "dir": r.get("_dir_label") or r.get("_dir"),
                "status": r.get("status"),
                "rows": rows,
                "rows_lag": max_rows - rows,
                "lag_s": round(max_prog - prog, 3) if prog else None,
                "progress_age_s": round(now - prog, 3) if prog else None,
                "clock_offset_s": r.get("clock_offset_s", 0.0),
            })
    return out


def render_aggregate(dirs: Sequence[str],
                     now: Optional[float] = None) -> str:
    """One merged monitor frame over N telemetry dirs: the tagged
    table, merged quorum, and the per-proc step-lag table."""
    now = time.time() if now is None else now
    recs, counts = aggregate_records(dirs, now=now)
    if not recs:
        return ("no health records under any of: "
                + ", ".join(health_dir_for(d) for d in dirs))
    out = [f"== merged monitor over {len(dirs)} telemetry dir(s)"]
    out += _render_table(recs, counts, with_dir=True)
    fq = fleet_quality(recs)
    if fq:
        gens = " ".join(f"g{g}={_fmt_quality(v)}"
                        for g, v in sorted(fq["generations"].items()))
        out.append(
            f"-- fleet quality ({fq['procs']} proc(s)): "
            f"worst auc={_fmt_quality(fq['live_auc'])}"
            f"  worst psi={_fmt_quality(fq['score_psi'])}"
            f"  joined={fq['joined']:,}"
            + (f"  [{gens}]" if gens else "")
            + ("  << QUALITY DEGRADED" if fq["degraded"] else ""))
    out.append("")
    out.append("-- per-proc step lag (vs the step's front-runner)")
    out.append(f"{'STEP':<11}{'PROC':<22}{'DIR':<14}{'ROWS':>12}"
               f"{'LAG(rows)':>11}{'LAG(s)':>8}{'CLKOFF(s)':>10}")
    for row in step_lag_table(recs, now=now):
        lag_s = f"{row['lag_s']:.1f}" if row["lag_s"] is not None else "-"
        out.append(
            f"{row['step']:<11}{(row['proc'] or '?'):<22}"
            f"{(row['dir'] or '?'):<14}{_fmt_count(row['rows']):>12}"
            f"{_fmt_count(row['rows_lag']):>11}{lag_s:>8}"
            f"{row['clock_offset_s']:>10.1f}")
    return "\n".join(out)


def aggregate_json(dirs: Sequence[str], now: Optional[float] = None
                   ) -> Tuple[Dict[str, Any], int]:
    """The machine-readable merge (``monitor --aggregate --once
    --json``): per-proc health + merged quorum + the step-lag table;
    exit code semantics match :func:`status_json`."""
    now = time.time() if now is None else now
    recs, counts = aggregate_records(dirs, now=now)
    lag = step_lag_table(recs, now=now)
    for rec in recs:
        rec.pop("_file", None)
        rec.pop("_dir", None)
    healthy, active, quorum, lost = _quorum_state(recs, counts)
    fq = fleet_quality(recs)
    unhealthy = counts.get("stalled", 0) + counts.get("stale", 0)
    doc = {
        "kind": "monitor_aggregate",
        "schema_version": tracer.SCHEMA_VERSION,
        "ts": round(now, 3),
        "dirs": [os.path.abspath(d) for d in dirs],
        "clock_offsets": {os.path.basename(os.path.abspath(d)):
                          round(dir_clock_offset(d), 3) for d in dirs},
        "procs": recs,
        "step_lag": lag,
        "quality": fq,
        "summary": {
            "total": len(recs),
            "counts": {k: counts.get(k, 0)
                       for k in ("live", "stalled", "stale", "exited")},
            "active": active,
            "healthy": healthy,
            "quorum": round(quorum, 4),
            "quorum_lost": lost,
        },
    }
    degraded = bool(fq and fq["degraded"])
    return doc, (EXIT_UNHEALTHY if unhealthy or lost or degraded else 0)


def run_monitor(model_set_dir: str, interval_s: float = 2.0,
                once: bool = False, max_frames: Optional[int] = None,
                json_mode: bool = False,
                aggregate_dirs: Optional[Sequence[str]] = None,
                _print=print) -> int:
    """The CLI loop: render a frame every ``interval_s`` until
    interrupted (``--once`` renders a single frame).  The single-dir
    human table always exits 0 — an empty health dir is a message, not
    an error; ``json_mode`` prints one JSON doc per frame and carries
    the health exit code (0 ok / 3 any stalled-or-stale or QUORUM
    LOST) so scripts can gate on it.  ``aggregate_dirs`` switches to
    the merged multi-dir view (``--aggregate``; replaces ``--dir``);
    its human table ALSO exits 3 when the quorum is lost (live members
    below ``shifu.dcn.quorumFrac``) or the merged fleet quality row is
    degraded — the fleet-level page."""
    frames = 0
    rc = 0
    try:
        while True:
            if aggregate_dirs:
                if json_mode:
                    doc, rc = aggregate_json(aggregate_dirs)
                    _print(json.dumps(doc, sort_keys=True))
                else:
                    _print(render_aggregate(aggregate_dirs))
                    recs, counts = aggregate_records(aggregate_dirs)
                    fq = fleet_quality(recs)
                    rc = EXIT_UNHEALTHY \
                        if (_quorum_state(recs, counts)[3]
                            or (fq and fq["degraded"])) else 0
            elif json_mode:
                doc, rc = status_json(model_set_dir)
                _print(json.dumps(doc, sort_keys=True))
            else:
                _print(render_status(model_set_dir))
            frames += 1
            if once or (max_frames is not None and frames >= max_frames):
                return rc if (json_mode or aggregate_dirs) else 0
            _print("")
            time.sleep(interval_s)
    except KeyboardInterrupt:
        return rc if (json_mode or aggregate_dirs) else 0
