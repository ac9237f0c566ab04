"""`combo` step — the port of ``shifu_tpu.pipeline.combo`` (reference
``ComboModelProcessor.java``): multi-algorithm ensemble.  ``combo new -alg
NN:GBT:LR`` records the member algorithms; ``combo run`` trains one
sub-model set per algorithm (sharing the parent's stats/ColumnConfig);
``combo eval`` scores every member on the eval sets and reports the
assembled (mean) performance.

``run`` and ``eval`` compute on ``device`` (CUDA unless the caller names
another): a tree member trains with the histogram kernels and every
forest scores through ``tree_traverse``, nets, SVMs and wide-and-deep
models through cuBLAS GEMMs; each member's ``norm`` runs on the host.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import List, Optional

import numpy as np

from .. import ioutil

log = logging.getLogger(__name__)

COMBO_FILE = "combo.json"


def run_combo(model_set_dir: str, action: str, algs: Optional[str],
              resume: bool = False, device=None) -> int:
    d = os.path.abspath(model_set_dir)
    if action == "new":
        if not algs:
            log.error("combo new requires -alg A:B:C")
            return 1
        members = [a.strip().upper() for a in algs.split(":") if a.strip()]
        ioutil.atomic_write_json(os.path.join(d, COMBO_FILE),
                                 {"algorithms": members})
        log.info("combo: %s", members)
        return 0

    combo_path = os.path.join(d, COMBO_FILE)
    if not os.path.isfile(combo_path):
        log.error("no %s — run `combo new -alg ...` first", COMBO_FILE)
        return 1
    with open(combo_path) as f:
        members: List[str] = json.load(f)["algorithms"]

    if action == "init":
        return _init_members(d, members)
    if action == "run":
        rc = _init_members(d, members)
        if rc:
            return rc
        return _train_members(d, members, resume=resume, device=device)
    if action == "eval":
        return _eval_members(d, members, device=device)
    log.error("unknown combo action %s", action)
    return 1


def _member_dir(d: str, alg: str, i: int) -> str:
    return os.path.join(d, f"combo_{i}_{alg}")


def _init_members(d: str, members: List[str]) -> int:
    """Each member = a sub model-set dir sharing the parent's configs/stats
    but with its own train.algorithm (reference sub-model dirs)."""
    from ..config import ModelConfig
    from ..config.meta import unknown_param_problems
    from ..config.validator import ValidationError
    parent = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    # typos must fail HERE — the per-member applicability filter below would
    # otherwise silently drop them (the parent dict legitimately mixes keys
    # of several algorithm families, so only unknown keys are errors)
    bad = unknown_param_problems(parent.train.params)
    if bad:
        raise ValidationError(bad)
    for i, alg in enumerate(members):
        md = _member_dir(d, alg, i)
        os.makedirs(md, exist_ok=True)
        mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
        from ..config.model_config import Algorithm
        mc.train.algorithm = Algorithm[alg]
        mc.basic.name = f"{mc.basic.name}_{alg}{i}"
        # keep only the params applicable to this member's algorithm —
        # driven by the meta schema so combo and probe() can't disagree
        from ..config.meta import TRAIN_PARAM_RULES
        mc.train.params = {
            k: v for k, v in (mc.train.params or {}).items()
            if (r := TRAIN_PARAM_RULES.get(k)) is not None
            and (r.algs is None or alg in r.algs)}
        if alg not in ("NN", "LR", "SVM", "TENSORFLOW"):
            # tree/WDL members can't grid-search — inheriting the parent's
            # grid file or list-valued axes would hard-fail their training
            # step; those members fall back to per-key defaults
            mc.train.gridConfigFile = None
            from ..train.grid_search import _is_axis
            mc.train.params = {k: v for k, v in mc.train.params.items()
                               if not (isinstance(v, list)
                                       and _is_axis(k, v))}
        elif mc.train.gridConfigFile and \
                not os.path.isabs(mc.train.gridConfigFile):
            # member configs resolve paths against THEIR dir — pin the
            # parent-relative grid file to the parent
            mc.train.gridConfigFile = os.path.join(
                d, mc.train.gridConfigFile)
        mc.save(os.path.join(md, "ModelConfig.json"))
        shutil.copy(os.path.join(d, "ColumnConfig.json"),
                    os.path.join(md, "ColumnConfig.json"))
    log.info("combo init: %d member dirs", len(members))
    return 0


def _train_members(d: str, members: List[str], resume: bool = False,
                   device=None) -> int:
    """``combo run [-resume]``: -resume skips members whose model file is
    already on disk (reference ComboModelProcessor -resume)."""
    from ..eval.scorer import discover_model_paths
    from .norm import NormalizeProcessor
    from .train import TrainProcessor
    for i, alg in enumerate(members):
        md = _member_dir(d, alg, i)
        if resume and discover_model_paths(os.path.join(md, "models")):
            log.info("combo: member %d (%s) already trained, skipping "
                     "(-resume)", i, alg)
            continue
        log.info("combo: training member %d (%s)", i, alg)
        rc = NormalizeProcessor(md, params={}).run()
        if rc == 0:
            rc = TrainProcessor(md, params={}, device=device).run()
        if rc:
            log.error("combo member %d (%s) failed", i, alg)
            return rc
    return 0


def _eval_members(d: str, members: List[str], device=None) -> int:
    """Score each member on the parent's eval sets; assemble by mean
    (reference assembles sub-model scores into a combined score column).
    The rows stream through the parse pool in ``parsepool.CHUNK_ROWS``
    chunks; each chunk scores every member's models on ``device``."""
    from ..config import ModelConfig, load_column_configs
    from ..data.parsepool import iter_extracted
    from ..data.reader import DataSource
    from ..eval.metrics import evaluate_scores
    from ..eval.scorer import ModelRunner, Scorer

    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    ccs = load_column_configs(os.path.join(d, "ColumnConfig.json"))
    rc = 0
    for ei, ev in enumerate(mc.evals):
        ds = ev.dataSet
        if not ds.dataPath:
            continue
        member_scores = []
        targets = weights = None
        for i, alg in enumerate(members):
            md = _member_dir(d, alg, i)
            scorer = Scorer.from_dir(os.path.join(md, "models"),
                                     device=device)
            runner = ModelRunner(mc, ccs, scorer.models, for_eval_set=ei,
                                 device=device)
            path = ds.dataPath if os.path.isabs(ds.dataPath) else \
                os.path.normpath(os.path.join(d, ds.dataPath))
            source = DataSource(path, ds.dataDelimiter)
            s_parts, t_parts, w_parts = [], [], []
            for _, ex in iter_extracted(source,
                                        runner.transformer.extractor):
                out = runner.compute(ex)
                if out["n"] == 0:
                    continue
                s_parts.append(out["result"].mean)
                t_parts.append(out["target"])
                w_parts.append(out["weight"])
            if not s_parts:
                log.error("combo eval %s: no usable rows (check tags/filter) "
                          "— skipping", ev.name)
                rc = 1
                member_scores = []
                break
            member_scores.append(np.concatenate(s_parts))
            if targets is None:
                targets = np.concatenate(t_parts)
                weights = np.concatenate(w_parts)
        if not member_scores:
            continue
        assembled = np.mean(np.stack(member_scores), axis=0)
        res = evaluate_scores(assembled, targets, weights,
                              buckets=ev.performanceBucketNum)
        out_path = os.path.join(d, f"ComboEval.{ev.name}.json")
        doc = res.to_dict()
        doc["members"] = members
        per_member = []
        for i, (alg, ms) in enumerate(zip(members, member_scores)):
            m_res = evaluate_scores(ms, targets, weights)
            per_member.append({"member": f"{i}:{alg}",
                               "areaUnderRoc": m_res.to_dict()["areaUnderRoc"]})
        doc["memberAuc"] = per_member
        ioutil.atomic_write_json(out_path, doc)
        log.info("combo eval %s: assembled AUC %.6f (members: %s)", ev.name,
                 res.areaUnderRoc,
                 {p["member"]: round(p["areaUnderRoc"], 4) if p["areaUnderRoc"]
                  else None for p in per_member})
    return rc
