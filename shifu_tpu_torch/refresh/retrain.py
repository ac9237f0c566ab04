"""Warm-start retraining for the refresh loop — the port's copy of
``shifu_tpu.refresh.retrain``: never a cold re-run.

One refresh retrain is one real ``train`` step, warmed three ways:

- **trainer state**: ``params["resume"]=True`` restores the checkpoints.
  NN, LR, SVM and WDL get params, optimizer state, RNG and early-stop
  window back from ``tmp/checkpoints/ckpt-<epoch>.npz``; GBT and RF
  restore the mid-forest checkpoint and append trees on the boosted
  residuals (the restored trees replay through the ``tree_traverse``
  kernel when the score sidecar covers other rows);
- **data-window cursor**: the refresh journal counts the rows of the
  materialized plane earlier trainings consumed;
  ``params["window_cursor"]`` hands the trainers a shard-aligned view
  from there, so a warm retrain reads the new windows only (with no new
  rows it keeps the freshest shard);
- **unit budget**: ``params["refresh_extra"]`` asks for N more epochs
  or trees past the restored state (``-Dshifu.refresh.units``; 0 takes
  the configured ``numTrainEpochs`` / ``TreeNum``, warm-started).

The trained models are copied into an immutable candidate directory,
``<modelset>/refresh/candidates/gen-<N>/``: the registry promotes (or the
archive keeps) that directory; ``<modelset>/models`` stays the training
workspace.  Before the first retrain overwrites the workspace,
:func:`detach_incumbent` copies the generation served from it into
``candidates/gen-<g>/`` and re-points the registry there, so a rollback
to the incumbent never loads a later candidate.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Any, Dict, Optional

from .. import DeviceLike

log = logging.getLogger(__name__)


def _tree_alg(alg_name: str) -> bool:
    return alg_name in ("GBT", "RF", "DT")


def _warm_evidence(paths, alg_name: str) -> int:
    """Restorable trainer state before the retrain runs: the forest
    checkpoint's tree count (GBT, RF, DT) or the checkpoint epoch (the
    rest); 0 means the retrain starts cold (nothing to resume)."""
    if _tree_alg(alg_name):
        meta = os.path.join(paths.checkpoint_dir,
                            "forest_ckpt.npz.meta.json")
        try:
            with open(meta) as f:
                return int(json.load(f).get("trees_done") or 0)
        except (OSError, ValueError):
            return 0
    from ..train import checkpoint as ckpt
    return int(ckpt.latest_epoch(paths.checkpoint_dir) or 0)


def _copy_models(src: str, dst: str) -> int:
    """Copy the ``model*`` files of ``src`` into ``dst``; returns how
    many."""
    os.makedirs(dst, exist_ok=True)
    copied = 0
    for f in sorted(os.listdir(src)):
        if f.startswith("model"):
            shutil.copy2(os.path.join(src, f), os.path.join(dst, f))
            copied += 1
    return copied


def detach_incumbent(model_set_dir: str, registry, key: str,
                     journal=None) -> Optional[str]:
    """When the live generation of ``key`` is served from the training
    workspace ``<modelset>/models``, copy its files into
    ``refresh/candidates/gen-<g>/`` and re-point the registry (and its
    ``serving.json``) there.  Returns that directory, or None when the
    live generation lives elsewhere already."""
    from ..config import ModelConfig
    from ..config.path_finder import PathFinder
    from .journal import RefreshJournal

    live = registry.models_dir(key)
    mc = ModelConfig.load(os.path.join(model_set_dir, "ModelConfig.json"))
    workspace = PathFinder(mc, model_set_dir).models_dir
    if not live or os.path.realpath(live) != os.path.realpath(workspace):
        return None
    journal = journal or RefreshJournal(model_set_dir)
    dst = journal.candidate_dir(registry.generation(key))
    if not _copy_models(workspace, dst):
        raise RuntimeError(f"no model files to detach in {workspace}")
    registry.relocate(key, dst)
    log.info("incumbent of %s detached from %s into %s", key, workspace,
             dst)
    return dst


def derived_units(mc) -> int:
    """The default warm budget: the configured fresh-run budget, spent
    from a warm start on the new window."""
    if _tree_alg(mc.train.algorithm.name):
        return int((mc.train.params or {}).get("TreeNum", 100))
    return int(mc.train.numTrainEpochs)


def warm_retrain(model_set_dir: str, gen: int, journal=None,
                 units: int = 0,
                 extra_params: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None) -> Dict[str, Any]:
    """Run one warm retrain on ``device`` and stage the result as
    candidate ``gen``.  Returns the decision record's payload
    (``models_dir``, ``warm``, ``resumed_from``, ``units``, the cursor's
    accounting)."""
    from ..config import ModelConfig
    from ..config.path_finder import PathFinder
    from ..data.shards import Shards
    from ..pipeline.train import TrainProcessor
    from .journal import RefreshJournal

    journal = journal or RefreshJournal(model_set_dir)
    mc = ModelConfig.load(os.path.join(model_set_dir, "ModelConfig.json"))
    alg = mc.train.algorithm.name
    paths = PathFinder(mc, model_set_dir)
    resumed_from = _warm_evidence(paths, alg)
    units = int(units) if units else derived_units(mc)

    plane_dir = paths.clean_dir if _tree_alg(alg) else paths.norm_dir
    total = Shards.open(plane_dir).num_rows
    cursor = min(journal.data_cursor, total)

    t0 = time.perf_counter()
    rc = TrainProcessor(model_set_dir, params={
        "resume": True,
        "window_cursor": cursor,
        "refresh_extra": units,
        **(extra_params or {})}, device=device).run()
    if rc != 0:
        raise RuntimeError(f"warm retrain failed: train step rc={rc}")

    cand = journal.candidate_dir(gen)
    if not _copy_models(paths.models_dir, cand):
        raise RuntimeError(f"warm retrain produced no model files in "
                           f"{paths.models_dir}")
    journal.set_cursor(total)
    return {
        "models_dir": cand,
        "algorithm": alg,
        "warm": resumed_from > 0,
        "resumed_from": resumed_from,
        "units": units,
        "cursor_rows": cursor,
        "new_rows": max(total - cursor, 0),
        "train_s": round(time.perf_counter() - t0, 3),
    }
