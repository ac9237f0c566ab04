"""RefreshController — the port's copy of
``shifu_tpu.refresh.controller``: the drift-gated continual train → gate
→ promote loop, over pieces the port already has:

- **trigger**: a PSI breach of the streaming
  :class:`~shifu_tpu_torch.obs.drift.DriftMonitor` (fed live through
  :meth:`RefreshController.observe`, or read from the
  ``telemetry/drift.json`` artifact a norm or eval re-run writes), live
  model quality (the attached server's
  :class:`~shifu_tpu_torch.obs.quality.QualityMonitor` or the
  ``telemetry/quality.json`` artifact it writes: live AUC down against
  the posttrain snapshot, or a score-distribution PSI breach), or a
  wall-clock schedule (``-Dshifu.refresh.intervalS``).  A cooldown
  (``-Dshifu.refresh.cooldownS``) keeps a sustained breach from
  thrashing the fleet with back-to-back retrains;
- **warm retrain**: :func:`shifu_tpu_torch.refresh.retrain.warm_retrain`
  on the controller's device: NN/WDL resume from the trainer
  checkpoints, GBT appends trees on the boosted residuals of the
  restored forest (B1 builds their histograms; the restored trees replay
  through B4 on the new window), on the data-window cursor's new rows
  only, never a cold re-run;
- **gate**: the candidate reaches the fleet only on AUC non-regression
  over a fresh holdout (:mod:`shifu_tpu_torch.eval.gate`,
  ``-Dshifu.refresh.minAucDelta``); a rejected candidate is archived
  with its eval report and the incumbent stays live;
- **probation**: the promotion is watched through the SLO plane for
  ``-Dshifu.refresh.probationS``: a firing error-budget burn alert (the
  attached server's tracker, or a SERVE heartbeat of the fleet) or a
  parity-canary mismatch rolls the registry back to the previous
  generation (``ModelRegistry.rollback``, the swap's journal-first
  path).

Every decision (trigger / skip / train / promote / reject / rollback /
complete) commits to the refresh journal under ``<modelset>/refresh/``
(:mod:`shifu_tpu_torch.refresh.journal`), so a killed controller resumes
mid-cycle: at the gate after a death past the retrain, adopting a swap
committed before the death, or watching the rest of a probation window.

Fault sites: ``refresh:trigger`` (before the trigger record commits),
``refresh:promote`` (after the gate passes, before the registry swap),
``refresh:rollback`` (before the rollback re-flips the registry).

The clock and sleep are injectable; the decision matrix runs in tests
with no real waiting.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import faults, obs
from ..ioutil import atomic_savez, atomic_write_json
from .journal import IDLE, PROBATION, TRAINED, TRIGGERED, RefreshJournal

log = logging.getLogger(__name__)

# heartbeat/monitor surface: the three externally meaningful states
STAGE_STATE = {IDLE: "idle", TRIGGERED: "training", TRAINED: "training",
               PROBATION: "probation"}
_STATE_CODE = {"idle": 0, "training": 1, "probation": 2}

CANARY_BASENAME = "canary.npz"

DEFAULT_COOLDOWN_S = 300.0
DEFAULT_PROBATION_S = 60.0
DEFAULT_CANARY_ROWS = 64


@dataclass
class RefreshConfig:
    """Resolved refresh knobs (the module docstring gives each one's
    meaning)."""
    psi_threshold: float
    interval_s: float = 0.0          # 0 = no schedule trigger
    cooldown_s: float = DEFAULT_COOLDOWN_S
    min_auc_delta: float = 0.0
    probation_s: float = DEFAULT_PROBATION_S
    units: int = 0                   # extra epochs/trees (0 = derived)
    canary_rows: int = DEFAULT_CANARY_ROWS
    holdout_rows: int = 4096

    @classmethod
    def from_env(cls, **overrides) -> "RefreshConfig":
        """The knobs, ``shifu.refresh.psiThreshold`` defaulting to the
        drift monitor's own ``shifu.drift.psiThreshold``."""
        from ..config import environment
        from ..obs.drift import psi_threshold as drift_threshold
        psi = environment.get_property("shifu.refresh.psiThreshold")
        try:
            psi_thr = float(psi) if psi is not None else drift_threshold()
        except (TypeError, ValueError):
            psi_thr = drift_threshold()
        cfg = cls(
            psi_threshold=psi_thr,
            interval_s=environment.get_float("shifu.refresh.intervalS",
                                             0.0),
            cooldown_s=environment.get_float("shifu.refresh.cooldownS",
                                             DEFAULT_COOLDOWN_S),
            min_auc_delta=environment.get_float(
                "shifu.refresh.minAucDelta", 0.0),
            probation_s=environment.get_float("shifu.refresh.probationS",
                                              DEFAULT_PROBATION_S),
            units=environment.get_int("shifu.refresh.units", 0),
            canary_rows=environment.get_int("shifu.refresh.canaryRows",
                                            DEFAULT_CANARY_ROWS),
        )
        for k, v in overrides.items():
            if v is not None:
                setattr(cfg, k, v)
        return cfg


def drift_columns_for(model_set_dir: str) -> Optional[List]:
    """The model-input ColumnConfig list in clean-plane column order —
    what a :class:`DriftMonitor` over served/normed bin windows needs.
    None when the plane or ColumnConfig is not materialized yet."""
    from ..config import load_column_configs
    cc_path = os.path.join(model_set_dir, "ColumnConfig.json")
    schema_path = os.path.join(model_set_dir, "tmp", "CleanedData",
                               "schema.json")
    try:
        with open(schema_path) as f:
            nums = json.load(f).get("columnNums") or []
        by_num = {c.columnNum: c for c in load_column_configs(cc_path)}
        cols = [by_num[n] for n in nums if n in by_num]
        return cols if len(cols) == len(nums) else None
    except (OSError, ValueError, KeyError):
        return None


class RefreshController:
    """One controller per model set; see module docs.

    Serving attachment: a live in-process ``server``
    (:class:`~shifu_tpu_torch.serve.server.ServeServer`: promotions go
    through its traffic-refined ladder, each rung captured at prepare,
    and probation reads its SLO tracker), or a bare ``registry`` and
    ``key`` (the CLI and daemon mode: promotions commit the serving
    journal, a serving fleet re-resolves it, and probation reads the
    fleet's SERVE heartbeats).  Retrain and gate run on the registry's
    device.

    Hooks (``retrain_fn(controller, gen)``, ``gate_fn(controller,
    candidate)``, ``drift_fn()``, ``quality_fn()``,
    ``slo_alerts_fn()``) default to the pipeline's wiring and are
    injectable for tests."""

    def __init__(self, model_set_dir: str, server=None, registry=None,
                 key: Optional[str] = None,
                 config: Optional[RefreshConfig] = None,
                 clock: Callable[[], float] = time.time,
                 sleep: Callable[[float], None] = time.sleep,
                 retrain_fn=None, gate_fn=None,
                 drift_fn: Optional[Callable[[], Optional[dict]]] = None,
                 quality_fn: Optional[Callable[[], Optional[dict]]] = None,
                 slo_alerts_fn: Optional[Callable[[], List[dict]]] = None,
                 drift_columns: Optional[Sequence] = None,
                 warm: bool = True):
        self.dir = os.path.abspath(model_set_dir)
        self.server = server
        self.registry = server.registry if server is not None else registry
        if self.registry is None:
            raise ValueError("RefreshController needs a server= or "
                             "registry= to promote into")
        self.key = key or (server.key if server is not None
                           else os.path.basename(self.dir))
        self.config = config or RefreshConfig.from_env()
        self.journal = RefreshJournal(self.dir)
        self.clock = clock
        self.sleep = sleep
        self.warm = warm
        self.retrain_fn = retrain_fn or _default_retrain
        self.gate_fn = gate_fn or _default_gate
        self.drift_fn = drift_fn
        self.quality_fn = quality_fn
        self.slo_alerts_fn = slo_alerts_fn
        self._drift_columns = list(drift_columns) if drift_columns \
            else None
        self._drift = self._fresh_drift()
        self._candidate = None           # models dir or in-memory list
        self._canary: Optional[Dict[str, Any]] = None
        self._heartbeat = None
        self._started_ts = self.clock()
        self._set_gauges()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "RefreshController":
        """Attach the live surfaces (heartbeat when telemetry is on) —
        idempotent; the tick loop works without it."""
        if self._heartbeat is None:
            self._heartbeat = obs.start_heartbeat(
                obs.health_dir_for(self.dir), step="REFRESH",
                proc=f"refresh-{self.key}", extras_fn=self._beat_extras)
        return self

    def stop(self, exit_code: Optional[int] = 0) -> None:
        if self._heartbeat is not None:
            self._heartbeat.stop(exit_code=exit_code)
            self._heartbeat = None

    def _beat_extras(self) -> dict:
        last = self.journal.doc.get("last_decision") or {}
        return {"refresh": {
            "state": STAGE_STATE.get(self.journal.stage, "idle"),
            "last_decision": last.get("kind"),
            "generation": self.registry.generation(self.key),
            "generations_held": len(
                self.registry.generation_history(self.key)),
            "cycle": self.journal.cycle,
            "last_outcome": self.journal.doc.get("last_outcome"),
        }}

    def _set_gauges(self) -> None:
        state = STAGE_STATE.get(self.journal.stage, "idle")
        obs.gauge("refresh.state").set(_STATE_CODE.get(state, 0))
        obs.gauge("refresh.generation").set(
            self.registry.generation(self.key))
        obs.gauge("refresh.cycle").set(self.journal.cycle)

    # ----------------------------------------------------------- drift feed
    def _fresh_drift(self):
        from ..obs.drift import DriftMonitor
        if not self._drift_columns:
            return None
        mon = DriftMonitor(self._drift_columns,
                           threshold=self.config.psi_threshold)
        return mon if mon._have.any() else None

    def observe(self, bins: np.ndarray,
                weights: Optional[np.ndarray] = None) -> None:
        """Fold one binned window of live traffic into the internal
        drift monitor (requires ``drift_columns``); every 8th window
        also refreshes the ``telemetry/drift.json`` artifact."""
        if self._drift is None:
            raise ValueError("no drift monitor attached — pass "
                             "drift_columns= (or feed drift_fn=)")
        self._drift.update(bins, weights)
        if self._drift.windows % 8 == 0:
            self._drift.emit(path=os.path.join(self.dir, "telemetry",
                                               "drift.json"))

    def _drift_summary(self):
        """(summary, from_artifact) — injectable fn > live monitor >
        the drift.json artifact a norm/eval re-run emitted."""
        if self.drift_fn is not None:
            return self.drift_fn(), False
        if self._drift is not None and self._drift.rows:
            return self._drift.summary(), False
        path = os.path.join(self.dir, "telemetry", "drift.json")
        try:
            with open(path) as f:
                doc = json.load(f)
            return (doc if isinstance(doc, dict) else None), True
        except (OSError, ValueError):
            return None, True

    def _quality_summary(self):
        """(summary, from_artifact) — injectable fn > the attached
        server's live quality monitor > the quality.json artifact a
        serve process emitted."""
        if self.quality_fn is not None:
            return self.quality_fn(), False
        if self.server is not None \
                and getattr(self.server, "quality", None) is not None:
            return self.server.quality.summary(), False
        path = os.path.join(self.dir, "telemetry", "quality.json")
        try:
            with open(path) as f:
                doc = json.load(f)
            return (doc if isinstance(doc, dict) else None), True
        except (OSError, ValueError):
            return None, True

    # -------------------------------------------------------------- trigger
    def _check_trigger(self, now: float) -> Optional[Dict[str, Any]]:
        summ, from_artifact = self._drift_summary()
        anchor = self.journal.doc.get("last_cycle_end_ts")
        if summ and summ.get("psi_max") is not None \
                and float(summ["psi_max"]) >= self.config.psi_threshold:
            ts = summ.get("ts")
            # an artifact breach older than the last cycle already
            # caused (or was rejected by) that cycle — not a new signal
            if not (from_artifact and anchor is not None
                    and ts is not None and float(ts) <= float(anchor)):
                return {"source": "psi",
                        "psi_max": round(float(summ["psi_max"]), 6),
                        "rows": int(summ.get("rows") or 0),
                        "flagged": list(summ.get("flagged") or [])[:8]}
        q, q_from_artifact = self._quality_summary()
        if q and q.get("degraded"):
            ts = q.get("ts")
            # same staleness anchor as the drift artifact: a degraded
            # table older than the last cycle is that cycle's cause,
            # not a new signal
            if not (q_from_artifact and anchor is not None
                    and ts is not None and float(ts) <= float(anchor)):
                return {"source": "quality",
                        "reasons": list(q.get("reasons") or []),
                        "live_auc": q.get("live_auc"),
                        "baseline_auc": q.get("baseline_auc"),
                        "score_psi": q.get("score_psi"),
                        "joined": int(q.get("joined") or 0)}
        if self.config.interval_s > 0:
            base = anchor if anchor is not None else self._started_ts
            if now - float(base) >= self.config.interval_s:
                return {"source": "schedule",
                        "interval_s": self.config.interval_s}
        return None

    def _in_cooldown(self, now: float) -> bool:
        last_end = self.journal.doc.get("last_cycle_end_ts")
        return last_end is not None and \
            now - float(last_end) < self.config.cooldown_s

    # ------------------------------------------------------------- the loop
    def tick(self, now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """One controller iteration: advance the cycle state machine as
        far as it can go without waiting (a fresh trigger runs all the
        way into probation; probation completes on a later tick).
        Returns the last decision record committed this tick, or None
        when nothing changed."""
        now = self.clock() if now is None else now
        decided: Optional[Dict[str, Any]] = None
        stage = self.journal.stage
        if stage == IDLE:
            trig = self._check_trigger(now)
            if trig is None:
                return None
            if self._in_cooldown(now):
                decided = self._skip_once(trig, now)
                self._set_gauges()
                return decided
            faults.fire("refresh", "trigger", self.key)
            self.journal.begin_cycle(
                trig, now,
                incumbent_gen=self.registry.generation(self.key))
            decided = self.journal.record("trigger", now, **trig)
            obs.counter("refresh.triggers").inc()
            stage = TRIGGERED
        if stage == TRIGGERED:
            decided = self._retrain(now)
            stage = TRAINED
        if stage == TRAINED:
            decided = self._gate_and_promote(self.clock())
            stage = self.journal.stage
        if stage == PROBATION:
            rec = self._probation(self.clock() if now is None else now)
            decided = rec or decided
        self._set_gauges()
        return decided

    def _skip_once(self, trig: Dict[str, Any],
                   now: float) -> Optional[Dict[str, Any]]:
        """Cooldown suppression: a sustained breach records ONE skip per
        cooldown window, not one per tick."""
        last_skip = self.journal.doc.get("last_skip_ts")
        last_end = float(self.journal.doc.get("last_cycle_end_ts") or 0.0)
        if last_skip is not None and float(last_skip) >= last_end:
            return None
        self.journal.doc["last_skip_ts"] = round(now, 3)
        rec = self.journal.record(
            "skip", now, reason="cooldown",
            cooldown_s=self.config.cooldown_s, trigger=trig)
        obs.counter("refresh.skips").inc()
        return rec

    # -------------------------------------------------------------- retrain
    def _retrain(self, now: float) -> Dict[str, Any]:
        gen = self.registry.next_generation(self.key)
        with obs.span("refresh.retrain", kind="phase"):
            info = dict(self.retrain_fn(self, gen) or {})
        self._candidate = info.pop("models", None) \
            or info.get("models_dir")
        if self._candidate is None:
            raise RuntimeError("retrain_fn returned no candidate "
                               "(models= or models_dir=)")
        obs.counter("refresh.retrains").inc()
        done = self.clock()
        rec = self.journal.record(
            "train", done, gen=gen,
            duration_s=round(done - now, 3),
            **{k: v for k, v in info.items()
               if isinstance(v, (str, int, float, bool, type(None)))})
        self.journal.set_stage(
            TRAINED, candidate=info.get("models_dir"), candidate_gen=gen)
        return rec

    def _load_candidate(self) -> bool:
        """Resume path: re-resolve the candidate from the journal after
        a controller death (only dir-backed candidates survive)."""
        cand = self.journal.doc.get("candidate")
        if cand and os.path.isdir(cand):
            self._candidate = cand
            return True
        return False

    # ------------------------------------------------------- gate / promote
    def _gate_and_promote(self, now: float) -> Dict[str, Any]:
        gen = int(self.journal.doc.get("candidate_gen") or 0)
        incumbent = int(self.journal.doc.get("incumbent_gen") or 0)
        if self.registry.generation(self.key) > incumbent:
            # the swap committed before a previous controller died —
            # adopt the promotion instead of re-promoting
            rec = self.journal.record("promote", now,
                                      gen=self.registry.generation(
                                          self.key),
                                      resumed=True)
            self._enter_probation(now)
            return rec
        if self._candidate is None and not self._load_candidate():
            # in-memory candidate lost with the previous controller —
            # fall back one stage and retrain
            log.warning("refresh resume: candidate gone, re-entering "
                        "retrain")
            self.journal.set_stage(TRIGGERED)
            return self._retrain(now)
        gate = self.gate_fn(self, self._candidate)
        if not gate.passed:
            archived = self._archive_reject(gate, gen)
            obs.counter("refresh.rejections").inc()
            rec = self.journal.record("reject", self.clock(), gen=gen,
                                      gate=gate.report(),
                                      archived=archived)
            self._finish_cycle("rejected")
            return rec
        faults.fire("refresh", "promote", self.key)
        if self.server is not None:
            self.server.swap(self._candidate)
        else:
            self.registry.swap(self.key, self._candidate, warm=self.warm)
        promoted = self.registry.generation(self.key)
        obs.counter("refresh.promotions").inc()
        rec = self.journal.record("promote", self.clock(), gen=promoted,
                                  gate=gate.report())
        self._enter_probation(self.clock())
        return rec

    def _archive_reject(self, gate, gen: int) -> Optional[str]:
        """A rejected candidate is archived beside its eval report — the
        incumbent stays live and the evidence stays on disk."""
        adir = self.journal.archive_dir(gen)
        os.makedirs(adir, exist_ok=True)
        if isinstance(self._candidate, str) \
                and os.path.isdir(self._candidate):
            dst = os.path.join(adir, "models")
            if not os.path.isdir(dst):
                os.rename(self._candidate, dst)
        atomic_write_json(os.path.join(adir, "eval_report.json"),
                          {"gate": gate.report(), "gen": gen,
                           "cycle": self.journal.cycle})
        self._candidate = None
        return adir

    def _enter_probation(self, now: float) -> None:
        self._capture_canary()
        self.journal.set_stage(
            PROBATION,
            promoted_gen=self.registry.generation(self.key),
            probation_until=round(now + self.config.probation_s, 3))

    # ------------------------------------------------------------ probation
    def _capture_canary(self) -> None:
        """Pin a canary batch + the freshly promoted generation's scores
        for it (bit-parity is re-checked through probation; persisted so
        a restarted controller keeps checking)."""
        xb = self._canary_rows()
        if xb is None:
            self._canary = None
            return
        x, bins = xb
        scorer = self.registry.get(self.key)
        try:
            expected = np.asarray(scorer.score_batch(
                x, bins if scorer.needs_bins else None))
        except Exception:
            log.warning("canary capture failed — probation runs on SLO "
                        "signals only", exc_info=True)
            self._canary = None
            return
        self._canary = {"x": x, "bins": bins, "expected": expected,
                        "gen": self.registry.generation(self.key)}
        payload = {"x": x, "expected": expected,
                   "gen": np.asarray(self._canary["gen"], np.int64)}
        if bins is not None:
            payload["bins"] = bins
        atomic_savez(os.path.join(self.journal.root, CANARY_BASENAME),
                     **payload)

    def _canary_rows(self):
        """Canary input: the head of the newest holdout window, sliced
        to the live scorer's serving signature (``n_features`` /
        ``n_bins_cols`` are a prefix of the materialized planes — the
        same contract serve requests follow).  None when no plane is
        materialized (in-memory test rigs) or it can't cover the
        signature."""
        try:
            from ..eval.gate import load_holdout
            h = load_holdout(self.dir, max_rows=self.config.canary_rows)
        except (OSError, ValueError):
            return None
        scorer = self.registry.get(self.key)
        nf = int(getattr(scorer, "n_features", h.x.shape[1]))
        nb = int(getattr(scorer, "n_bins_cols", 0))
        if h.x.shape[1] < nf or (nb and (h.bins is None
                                         or h.bins.shape[1] < nb)):
            return None
        x = np.ascontiguousarray(h.x[:, :nf], np.float32)
        bins = None
        if nb and h.bins is not None:
            bins = np.ascontiguousarray(h.bins[:, :nb])
        return x, bins

    def _restore_canary(self) -> None:
        path = os.path.join(self.journal.root, CANARY_BASENAME)
        try:
            d = np.load(path)
            self._canary = {"x": np.asarray(d["x"]),
                            "bins": np.asarray(d["bins"])
                            if "bins" in d else None,
                            "expected": np.asarray(d["expected"]),
                            "gen": int(d["gen"])}
        except (OSError, ValueError, KeyError):
            self._canary = None

    def _slo_alerts(self) -> List[dict]:
        if self.slo_alerts_fn is not None:
            return list(self.slo_alerts_fn() or [])
        if self.server is not None:
            return list(self.server.slo.alerts())
        # daemon mode: the serving fleet's heartbeats carry the compact
        # SLO summary — a firing alert on any SERVE proc is the signal
        from ..obs.health import health_dir_for, read_health
        out = []
        for rec in read_health(health_dir_for(self.dir)):
            slo = rec.get("slo") or {}
            if rec.get("step") == "SERVE" and slo.get("alerting"):
                out.append({"severity": "page",
                            "budget": ",".join(slo.get("alerts") or [])
                            or "burn", "proc": rec.get("proc")})
        return out

    def _probation_breach(self) -> Optional[str]:
        alerts = self._slo_alerts()
        if alerts:
            a = alerts[0]
            return f"slo-burn:{a.get('severity', '?')}:" \
                   f"{a.get('budget', '?')}"
        if self._canary is None:
            self._restore_canary()
        can = self._canary
        if can is not None \
                and can["gen"] == self.registry.generation(self.key):
            scorer = self.registry.get(self.key)
            try:
                got = np.asarray(scorer.score_batch(
                    can["x"], can["bins"] if scorer.needs_bins else None))
            except Exception:
                log.warning("canary rescore failed", exc_info=True)
                return "canary-error"
            if got.tobytes() != can["expected"].tobytes():
                return "canary-parity"
        return None

    def _probation(self, now: float) -> Optional[Dict[str, Any]]:
        promoted = int(self.journal.doc.get("promoted_gen") or 0)
        reason = self._probation_breach()
        if reason is not None:
            faults.fire("refresh", "rollback", self.key)
            self.registry.rollback(self.key, warm=self.warm)
            obs.counter("refresh.rollbacks").inc()
            rec = self.journal.record(
                "rollback", self.clock(), reason=reason,
                from_gen=promoted,
                gen=self.registry.generation(self.key))
            self._finish_cycle("rolled_back")
            return rec
        until = float(self.journal.doc.get("probation_until") or 0.0)
        if now >= until:
            rec = self.journal.record("complete", now, gen=promoted)
            self._finish_cycle("promoted")
            return rec
        return None

    def _finish_cycle(self, outcome: str) -> None:
        self.journal.end_cycle(outcome, self.clock())
        self._candidate = None
        self._canary = None
        # the next cycle drifts against a FRESH live window — a breach
        # the cycle just answered must re-accumulate to re-trigger
        self._drift = self._fresh_drift()
        # same for live quality: the just-answered degradation must not
        # re-trigger off the old generation's windows
        if self.server is not None \
                and getattr(self.server, "quality", None) is not None:
            self.server.quality.reset_windows()

    # ------------------------------------------------------------ run modes
    def run_once(self, poll_s: float = 0.5,
                 timeout_s: float = 3600.0) -> str:
        """Drive at most one full cycle to completion (the ``shifu-tpu
        refresh`` one-shot): returns ``no-trigger`` when nothing fired,
        else the cycle outcome (promoted / rejected / rolled_back)."""
        rec = self.tick()
        if self.journal.stage == IDLE:
            # nothing fired (or only a cooldown skip): report THAT, not
            # a previous cycle's outcome
            if rec is None:
                return "no-trigger"
            if rec.get("kind") == "skip":
                return "skipped"
            return str(self.journal.doc.get("last_outcome"))
        deadline = self.clock() + timeout_s
        while self.journal.stage != IDLE:
            if self.clock() >= deadline:
                return "timeout"
            self.sleep(poll_s)
            self.tick()
        return str(self.journal.doc.get("last_outcome"))

    def run(self, poll_s: float = 2.0, max_ticks: Optional[int] = None,
            stop: Optional[Callable[[], bool]] = None) -> None:
        """The ``--daemon`` loop: tick forever (``max_ticks`` / ``stop``
        bound it for tests), logging decisions as they commit."""
        self.start()
        ticks = 0
        try:
            while True:
                try:
                    rec = self.tick()
                except faults.InjectedFault:
                    raise
                except Exception:
                    log.exception("refresh tick failed — retrying after "
                                  "poll interval")
                    rec = None
                if rec is not None:
                    log.info("refresh decision: %s (cycle %d)",
                             rec.get("kind"), rec.get("cycle", -1))
                ticks += 1
                if max_ticks is not None and ticks >= max_ticks:
                    return
                if stop is not None and stop():
                    return
                self.sleep(poll_s)
        finally:
            self.stop()


# ------------------------------------------------------ default hooks
def _default_retrain(controller: RefreshController, gen: int) -> dict:
    from .retrain import detach_incumbent, warm_retrain
    detach_incumbent(controller.dir, controller.registry, controller.key,
                     controller.journal)
    return warm_retrain(controller.dir, gen, journal=controller.journal,
                        units=controller.config.units,
                        device=controller.registry.device)


def _default_gate(controller: RefreshController, candidate):
    from ..eval.gate import auc_gate, load_holdout
    from ..eval.scorer import load_models
    holdout = load_holdout(controller.dir,
                           max_rows=controller.config.holdout_rows)
    old = controller.registry.get(controller.key).models
    new = load_models(candidate) if isinstance(candidate, str) \
        else list(candidate)
    return auc_gate(old, new, holdout,
                    min_delta=controller.config.min_auc_delta,
                    device=controller.registry.device)
