"""Pipeline processors — the port's copy of
``shifu_tpu.pipeline.processor.BasicProcessor``: one processor per CLI
step, with shared setup (config load, validation, journal), the ordered-
pipeline preconditions, and ``tmp/profile.json`` phase timing.

Not ported yet (ROADMAP Queue 1 item 13): the telemetry spans,
heartbeats, metrics exporter, device trace and fault-injection sites of
the reference's ``run``.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import List, Optional

from .. import DeviceLike, ioutil, resolve_device
from ..config import (ColumnConfig, ModelConfig, load_column_configs,
                      save_column_configs)
from ..config.path_finder import PathFinder
from ..config.validator import ModelStep, probe
from .journal import StepJournal

log = logging.getLogger(__name__)


def telemetry_requested() -> bool:
    """Whether the caller switched the reference's telemetry on (env
    ``SHIFU_TPU_TELEMETRY`` or property ``shifu.telemetry``): the steps
    whose telemetry-only parts are not ported raise then."""
    from ..config import environment
    v = os.environ.get("SHIFU_TPU_TELEMETRY")
    if v is None:
        v = environment.get_property("shifu.telemetry") \
            or environment.get_property("shifu.tpu.telemetry")
    return str(v).strip().lower() in ("1", "true", "yes", "on")


class BasicProcessor:
    """Shared step setup/teardown (reference ``BasicModelProcessor.java``).
    ``device`` is where the step computes: CUDA unless the caller names
    another, raising at construction when CUDA is asked for and absent."""

    step: ModelStep = ModelStep.NEW
    require_columns: bool = True       # INIT creates ColumnConfig itself

    def __init__(self, model_set_dir: str = ".",
                 params: Optional[dict] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.dir = os.path.abspath(model_set_dir)
        self.params = params or {}
        self.model_config: Optional[ModelConfig] = None
        self.column_configs: List[ColumnConfig] = []
        self.paths: Optional[PathFinder] = None
        self.journal: Optional[StepJournal] = None
        self._phases: dict = {}

    @property
    def profile_name(self) -> str:
        return self.step.name

    # ------------------------------------------------------------ lifecycle
    def setup(self) -> None:
        mc_path = os.path.join(self.dir, "ModelConfig.json")
        if not os.path.isfile(mc_path):
            raise FileNotFoundError(
                f"{mc_path} not found — run `shifu-tpu new <name>` first")
        self.model_config = ModelConfig.load(mc_path)
        self.paths = PathFinder(self.model_config, self.dir)
        probe(self.model_config, self.step, self.dir)
        cc_path = self.paths.column_config_path
        if os.path.isfile(cc_path):
            self.column_configs = load_column_configs(cc_path)
        elif self.require_columns:
            raise FileNotFoundError(
                f"{cc_path} not found — run `shifu-tpu init` first")
        self.paths.ensure_dirs()
        self.journal = StepJournal(
            self.paths.journal_path(self.profile_name), self.profile_name,
            self.dir)
        self._check_step_preconditions()

    def _check_step_preconditions(self) -> None:
        """Ordered-pipeline guard: a step whose inputs do not exist, or
        whose upstream journal says they are torn, fails with a coded
        hint."""
        from ..config.errors import ErrorCode, ShifuError
        s = self.step
        if s in (ModelStep.NORMALIZE, ModelStep.VARSELECT, ModelStep.TRAIN):
            cand = [c for c in self.column_configs or [] if c.is_candidate()]
            if cand and not any((c.num_bins() or 0) > 0
                                or c.columnStats.mean is not None
                                for c in cand):
                raise ShifuError(
                    ErrorCode.ERROR_STEP_PRECONDITION,
                    f"`{s.value.lower()}` needs column statistics — run "
                    "`stats` first")
        if s == ModelStep.TRAIN:
            if not (os.path.isfile(os.path.join(self.paths.norm_dir,
                                                "schema.json"))
                    or os.path.isfile(os.path.join(self.paths.clean_dir,
                                                   "schema.json"))):
                raise ShifuError(
                    ErrorCode.ERROR_STEP_PRECONDITION,
                    "`train` needs the materialized data plane — run "
                    "`norm` first")
            nj = StepJournal(self.paths.journal_path("NORMALIZE"),
                             "NORMALIZE", self.dir)
            if nj.is_torn():
                raise ShifuError(
                    ErrorCode.ERROR_TORN_ARTIFACT,
                    "the last `norm` run did not complete (journal "
                    "status=running) — re-run `norm` (it resumes at the "
                    "first uncommitted shard)")
            if nj.status and not nj.verify_all():
                raise ShifuError(
                    ErrorCode.ERROR_TORN_ARTIFACT,
                    "materialized norm shards no longer match their "
                    "journaled sizes (torn/corrupted artifact) — re-run "
                    "`norm`")

    def _abs(self, p: Optional[str]) -> Optional[str]:
        """Resolve a config-relative path against the model-set dir;
        scheme'd URIs pass through for the reader to refuse."""
        if p is None or "://" in p:
            return p
        return p if os.path.isabs(p) else os.path.normpath(
            os.path.join(self.dir, p))

    def save_model_config(self) -> None:
        self.model_config.save(self.paths.model_config_path)

    def save_column_configs(self) -> None:
        save_column_configs(self.column_configs,
                            self.paths.column_config_path)

    def backup(self, path: str) -> None:
        """Keep one backup generation of a config file before overwrite."""
        if os.path.isfile(path):
            os.makedirs(self.paths.backup_dir, exist_ok=True)
            shutil.copy2(path, os.path.join(self.paths.backup_dir,
                                            os.path.basename(path)))

    def run(self) -> int:
        t0 = time.time()
        log.info("step %s start on %s", self.step.name, self.device)
        with self.phase("setup"):
            self.setup()
        # stays "running" until the step commits: a crash below leaves
        # the marker the next run (and downstream preconditions) read
        self.journal.open_run()
        code = self.process()
        if code == 0:
            self.journal.complete(exit_code=0)
        total = time.time() - t0
        log.info("step %s done in %.2fs", self.step.name, total)
        self._write_profile(total)
        return code

    # ------------------------------------------------------------ profiling
    def phase(self, name: str):
        """Time a named phase; accumulates into ``tmp/profile.json``."""
        return _PhaseSpan(self._phases, name)

    def _write_profile(self, total_s: float) -> None:
        try:
            path = os.path.join(self.paths.tmp_dir, "profile.json")
            doc = {}
            if os.path.isfile(path):
                try:
                    with open(path) as f:
                        doc = json.load(f)
                except (json.JSONDecodeError, OSError):
                    doc = {}            # self-heal a truncated file
            doc[self.profile_name] = {
                "total_s": round(total_s, 3),
                "phases_s": {k: round(v, 3)
                             for k, v in self._phases.items()}}
            os.makedirs(self.paths.tmp_dir, exist_ok=True)
            ioutil.atomic_write_json(path, doc)
        except Exception:                       # profiling must never fail
            log.debug("profile write failed", exc_info=True)

    def process(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError


class _PhaseSpan:
    def __init__(self, store: dict, name: str):
        self.store = store
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.store[self.name] = self.store.get(self.name, 0.0) \
            + (time.perf_counter() - self.t0)
        return False
