"""Model-set version management — the port of ``shifu_tpu.pipeline.manage``
(reference ``ManageModelProcessor.java``: git-branch-like save/switch of
model-set versions), on the host; the snapshot tree is the reference's.

``save [name]`` snapshots ModelConfig.json + ColumnConfig.json + models/
into ``.backup/<name>/``; ``switch <name>`` restores a snapshot (saving the
current state to ``.backup/autosave`` first); ``history`` lists versions;
``show`` prints the current version (ModelAction.SHOW); ``delete <name>``
drops a snapshot; ``cp <dst>`` clones the model set's configs into a new
scaffold (the reference's ``shifu cp <src> <dst>``).
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import List, Optional

from .. import ioutil

log = logging.getLogger(__name__)

VERSIONED = ["ModelConfig.json", "ColumnConfig.json", "models"]


def _backup_dir(model_set_dir: str) -> str:
    return os.path.join(os.path.abspath(model_set_dir), ".backup")


def list_versions(model_set_dir: str) -> List[str]:
    bd = _backup_dir(model_set_dir)
    if not os.path.isdir(bd):
        return []
    return sorted(d for d in os.listdir(bd)
                  if os.path.isdir(os.path.join(bd, d)))


def save_version(model_set_dir: str, name: Optional[str] = None) -> int:
    d = os.path.abspath(model_set_dir)
    if not os.path.isfile(os.path.join(d, "ModelConfig.json")):
        log.error("no ModelConfig.json in %s", d)
        return 1
    name = name or time.strftime("v%Y%m%d-%H%M%S")
    dst = os.path.join(_backup_dir(d), name)
    if os.path.isdir(dst):
        shutil.rmtree(dst)
    os.makedirs(dst)
    for item in VERSIONED:
        src = os.path.join(d, item)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dst, item))
        elif os.path.isfile(src):
            shutil.copy2(src, os.path.join(dst, item))
    _note_current(model_set_dir, name)
    log.info("saved model-set version %s", name)
    return 0


def switch_version(model_set_dir: str, name: str) -> int:
    d = os.path.abspath(model_set_dir)
    src = os.path.join(_backup_dir(d), name)
    if not os.path.isdir(src):
        log.error("no saved version %s (have: %s)", name,
                  list_versions(model_set_dir) or "none")
        return 1
    save_version(model_set_dir, "autosave")  # never lose current state
    for item in VERSIONED:
        cur = os.path.join(d, item)
        snap = os.path.join(src, item)
        if os.path.isdir(cur):
            shutil.rmtree(cur)
        elif os.path.isfile(cur):
            os.remove(cur)
        if os.path.isdir(snap):
            shutil.copytree(snap, cur)
        elif os.path.isfile(snap):
            shutil.copy2(snap, cur)
    _note_current(model_set_dir, name)
    log.info("switched to model-set version %s", name)
    return 0


def show_history(model_set_dir: str) -> int:
    versions = list_versions(model_set_dir)
    if not versions:
        log.info("no saved versions")
        return 0
    for v in versions:
        log.info("version: %s", v)
    return 0


def _current_file(model_set_dir: str) -> str:
    return os.path.join(_backup_dir(model_set_dir), "CURRENT")


def _note_current(model_set_dir: str, name: str) -> None:
    os.makedirs(_backup_dir(model_set_dir), exist_ok=True)
    ioutil.atomic_write_text(_current_file(model_set_dir), name + "\n")


def show_current(model_set_dir: str) -> int:
    """Print the working version (reference ``printCurrentWorker``)."""
    cur = "master"
    cf = _current_file(model_set_dir)
    if os.path.isfile(cf):
        cur = open(cf).read().strip() or cur
    log.info("current version: %s (%d saved)", cur,
             len(list_versions(model_set_dir)))
    return 0


def delete_version(model_set_dir: str, name: str) -> int:
    """Drop a saved snapshot (reference ``ModelAction.DELETE``)."""
    src = os.path.join(_backup_dir(model_set_dir), name)
    if not os.path.isdir(src):
        log.error("no saved version %s (have: %s)", name,
                  list_versions(model_set_dir) or "none")
        return 1
    shutil.rmtree(src)
    cf = _current_file(model_set_dir)
    if os.path.isfile(cf) and open(cf).read().strip() == name:
        os.remove(cf)          # `show` must not report a deleted version
    log.info("deleted model-set version %s", name)
    return 0


def copy_model_set(model_set_dir: str, dst: str) -> int:
    """Clone configs (not artifacts) into a fresh model-set scaffold —
    the reference's ``shifu cp``: start a variant experiment from the
    same dataSet/stats/train config."""
    import json
    d = os.path.abspath(model_set_dir)
    if not os.path.isfile(os.path.join(d, "ModelConfig.json")):
        log.error("no ModelConfig.json in %s", d)
        return 1
    dst = os.path.abspath(dst)
    if os.path.exists(dst):
        log.error("%s already exists", dst)
        return 1
    os.makedirs(dst)
    with open(os.path.join(d, "ModelConfig.json")) as f:
        mc = json.load(f)
    if isinstance(mc.get("basic"), dict):
        mc["basic"]["name"] = os.path.basename(dst)
    ioutil.atomic_write_json(os.path.join(dst, "ModelConfig.json"), mc)
    cc = os.path.join(d, "ColumnConfig.json")
    if os.path.isfile(cc):
        shutil.copy2(cc, os.path.join(dst, "ColumnConfig.json"))
    log.info("copied model set %s -> %s", d, dst)
    return 0
