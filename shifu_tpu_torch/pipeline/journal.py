"""Per-step commit journals — the port's copy of
``shifu_tpu.pipeline.journal`` (same file, same fields, so either package
reads the other's journals).

- every step owns ``tmp/journal/<STEP>.json`` (atomic rename on every
  update, never torn itself);
- ``BasicProcessor.run()`` marks it ``running`` on entry and ``complete``
  on success — a journal stuck at ``running`` IS the torn-step detector;
- steps with resumable sub-work (norm shards, stats chunks) record one
  **item** per committed unit with the exact byte sizes of its files;
  downstream preconditions (train needs norm) check journal completeness
  and those sizes, not mere file existence.  Norm writes items and resumes
  from them; stats binds its sweep signature without resuming (its
  mid-sweep checkpoints are not ported, ROADMAP Queue 1 item 2) and train
  only reads items.

A missing journal means "pre-journal artifacts, trust the files".
"""

from __future__ import annotations

import json
import os
import logging
import time
from typing import Dict, List, Optional

from ..ioutil import atomic_write_json

log = logging.getLogger(__name__)

JOURNAL_VERSION = 1

RUNNING = "running"
COMPLETE = "complete"


class StepJournal:
    def __init__(self, path: str, step: str, root: str):
        self.path = path
        self.step = step
        self.root = root               # file paths record relative to this
        self.doc: dict = self._load()
        # tear state of the PREVIOUS run, frozen before open_run() marks
        # this one running — the resume decision reads this, never the
        # live status (which this run owns)
        self.was_torn: bool = self.is_torn()

    # ------------------------------------------------------------- state
    def _load(self) -> dict:
        try:
            with open(self.path) as f:
                doc = json.load(f)
            if doc.get("version") == JOURNAL_VERSION \
                    and doc.get("step") == self.step:
                return doc
        except (OSError, ValueError):
            pass
        return {"version": JOURNAL_VERSION, "step": self.step,
                "status": None, "signature": None, "items": {}}

    def _flush(self) -> None:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        atomic_write_json(self.path, self.doc)

    @property
    def status(self) -> Optional[str]:
        return self.doc.get("status")

    @property
    def exists(self) -> bool:
        return self.doc.get("status") is not None

    def is_torn(self) -> bool:
        """A previous run started this step and never committed."""
        return self.exists and self.status != COMPLETE

    # --------------------------------------------------------- lifecycle
    def open_run(self) -> None:
        """Mark the step running.  Signature/items from a previous torn
        run are preserved."""
        self.was_torn = self.is_torn()
        self.doc["status"] = RUNNING
        self.doc["run_id"] = f"{os.getpid()}-{int(time.time() * 1000)}"
        self._flush()

    def complete(self, **meta) -> None:
        self.doc["status"] = COMPLETE
        if meta:
            self.doc.setdefault("meta", {}).update(meta)
        self._flush()

    # ------------------------------------------------------------- items
    def arm(self, signature: dict, resume: bool = True) -> Dict[str, dict]:
        """Bind this run to ``signature`` and return the verified resume
        items of an interrupted previous run (empty when the previous run
        completed, the signature changed, verification fails, or
        ``resume=False``).  Unverifiable items are dropped from the
        journal so the caller's view and the journal agree."""
        prev_sig = self.doc.get("signature")
        prev_items = dict(self.doc.get("items") or {})
        # only a TORN previous run resumes; a completed one re-runs whole
        resumable = (resume and prev_sig == signature
                     and self.was_torn and prev_items)
        kept: Dict[str, dict] = {}
        if resumable:
            for name, meta in prev_items.items():
                if self.verify_item(meta):
                    kept[name] = meta
                else:
                    log.warning("journal %s: item %r fails verification "
                                "(torn artifact) — its unit will re-run",
                                self.step, name)
        self.doc["signature"] = signature
        self.doc["items"] = kept
        self._flush()
        return kept

    def commit_item(self, name: str, files: Optional[List[str]] = None,
                    **meta) -> None:
        """Record one committed unit of work; ``files`` are pinned with
        their exact sizes (the torn-artifact check on resume)."""
        if files:
            meta["files"] = [[os.path.relpath(p, self.root),
                              os.path.getsize(p)] for p in files]
        self.doc["items"][name] = meta
        self._flush()

    def verify_item(self, meta: dict) -> bool:
        for rel, size in meta.get("files") or []:
            p = os.path.join(self.root, rel)
            try:
                if os.path.getsize(p) != int(size):
                    return False
            except OSError:
                return False
        return True

    def verify_all(self) -> bool:
        """Every recorded item's files still match their committed sizes
        (the downstream-precondition completeness check)."""
        return all(self.verify_item(m)
                   for m in (self.doc.get("items") or {}).values())
