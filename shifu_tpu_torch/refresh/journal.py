"""Refresh-cycle journal — the port's copy of ``shifu_tpu.refresh.journal``,
the controller's crash-consistency spine.

The continual-refresh loop is a long-running state machine (idle →
triggered → trained → probation → idle).  Its state commits the way the
step journals commit pipeline work, in the reference's layout, so a
journal one package wrote resumes in the other:

- ``<modelset>/refresh/state.json`` — the live cycle state, rewritten
  atomically at every transition.  A killed controller re-reads it and
  resumes mid-cycle: a death after retraining re-enters at the gate, a
  death after the registry swap adopts the promotion and enters
  probation — never a second retrain, never a forgotten candidate.
- ``<modelset>/refresh/decisions/`` — one immutable record a decision
  (``trigger`` / ``skip`` / ``train`` / ``promote`` / ``reject`` /
  ``rollback`` / ``complete``), written once by tmp + rename.  The
  decision stream is the audit log the monitor line and post-mortems
  read.

Timestamps come from the caller (the controller's injectable clock), so
tests drive a whole lifecycle with a fake clock and no sleeps.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List

from ..ioutil import atomic_write_json, sweep_orphan_tmp

log = logging.getLogger(__name__)

JOURNAL_VERSION = 1

REFRESH_DIRNAME = "refresh"
STATE_BASENAME = "state.json"
DECISIONS_DIRNAME = "decisions"
CANDIDATES_DIRNAME = "candidates"
ARCHIVE_DIRNAME = "archive"

# cycle stages (the resume points)
IDLE = "idle"
TRIGGERED = "triggered"          # trigger committed, retrain owed
TRAINED = "trained"              # candidate built, gate + promote owed
PROBATION = "probation"          # promoted, watching the SLO window

STAGES = (IDLE, TRIGGERED, TRAINED, PROBATION)

DECISION_KINDS = ("trigger", "skip", "train", "promote", "reject",
                  "rollback", "complete")


def refresh_dir_for(model_set_dir: str) -> str:
    return os.path.join(os.path.abspath(model_set_dir), REFRESH_DIRNAME)


class RefreshJournal:
    """Cycle state and append-only decision records of one model set."""

    def __init__(self, model_set_dir: str):
        self.root = refresh_dir_for(model_set_dir)
        self.state_path = os.path.join(self.root, STATE_BASENAME)
        self.decisions_dir = os.path.join(self.root, DECISIONS_DIRNAME)
        self.doc: Dict[str, Any] = self._load()

    # --------------------------------------------------------------- state
    def _load(self) -> Dict[str, Any]:
        try:
            with open(self.state_path) as f:
                doc = json.load(f)
            if doc.get("version") == JOURNAL_VERSION \
                    and doc.get("stage") in STAGES:
                return doc
            log.warning("refresh journal %s has unknown version/stage — "
                        "starting a fresh state", self.state_path)
        except (OSError, ValueError):
            pass
        return {"version": JOURNAL_VERSION, "stage": IDLE, "cycle": 0,
                "seq": 0, "last_decision": None,
                "last_cycle_end_ts": None, "data_cursor": 0}

    def _flush(self) -> None:
        os.makedirs(self.root, exist_ok=True)
        atomic_write_json(self.state_path, self.doc)

    @property
    def stage(self) -> str:
        return self.doc.get("stage") or IDLE

    @property
    def cycle(self) -> int:
        return int(self.doc.get("cycle") or 0)

    def candidate_dir(self, gen: int) -> str:
        return os.path.join(self.root, CANDIDATES_DIRNAME, f"gen-{gen}")

    def archive_dir(self, gen: int) -> str:
        return os.path.join(self.root, ARCHIVE_DIRNAME, f"gen-{gen}")

    # ------------------------------------------------------------ decisions
    def record(self, kind: str, ts: float, **fields) -> Dict[str, Any]:
        """Commit one immutable decision record and fold it into the live
        state.  ``ts`` is the controller's clock."""
        if kind not in DECISION_KINDS:
            raise ValueError(f"unknown refresh decision kind {kind!r}")
        seq = int(self.doc.get("seq") or 0)
        rec = {"kind": kind, "seq": seq, "cycle": self.cycle,
               "ts": round(float(ts), 3), **fields}
        os.makedirs(self.decisions_dir, exist_ok=True)
        sweep_orphan_tmp(self.decisions_dir)
        atomic_write_json(
            os.path.join(self.decisions_dir, f"d{seq:06d}-{kind}.json"),
            rec)
        self.doc["seq"] = seq + 1
        self.doc["last_decision"] = {"kind": kind, "seq": seq,
                                     "cycle": self.cycle,
                                     "ts": rec["ts"]}
        self._flush()
        return rec

    def decisions(self) -> List[Dict[str, Any]]:
        """Every parseable decision record, in commit order."""
        out: List[Dict[str, Any]] = []
        try:
            names = sorted(os.listdir(self.decisions_dir))
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.decisions_dir, name)) as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                log.warning("skipping unparseable refresh decision %s",
                            name)
                continue
            if isinstance(rec, dict):
                out.append(rec)
        return out

    # ------------------------------------------------------------ lifecycle
    def begin_cycle(self, trigger: Dict[str, Any], ts: float,
                    incumbent_gen: int) -> None:
        self.doc["cycle"] = self.cycle + 1
        self.doc["stage"] = TRIGGERED
        self.doc["trigger"] = dict(trigger)
        self.doc["cycle_started_ts"] = round(float(ts), 3)
        self.doc["incumbent_gen"] = int(incumbent_gen)
        for k in ("candidate", "candidate_gen", "gate", "promoted_gen",
                  "probation_until"):
            self.doc.pop(k, None)
        self._flush()

    def set_stage(self, stage: str, **fields) -> None:
        if stage not in STAGES:
            raise ValueError(f"unknown refresh stage {stage!r}")
        self.doc["stage"] = stage
        self.doc.update(fields)
        self._flush()

    def end_cycle(self, outcome: str, ts: float) -> None:
        """Close the cycle (promoted / rejected / rolled_back); the
        cooldown window anchors on this timestamp."""
        self.doc["stage"] = IDLE
        self.doc["last_outcome"] = outcome
        self.doc["last_cycle_end_ts"] = round(float(ts), 3)
        self._flush()

    def set_cursor(self, rows: int) -> None:
        """Advance the data-window cursor: the rows of the materialized
        plane earlier trainings consumed (warm retrains start here)."""
        self.doc["data_cursor"] = int(rows)
        self._flush()

    @property
    def data_cursor(self) -> int:
        return int(self.doc.get("data_cursor") or 0)
