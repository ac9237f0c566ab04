"""`train` step — the port of ``shifu_tpu.pipeline.train.TrainProcessor``.

Tree algorithms read the clean/binned plane (``tmp/CleanedData``) and go to
``train.dt_trainer.run_tree_training``: resident GBT, RF and DT, single or
as grid trials (list-valued ``train#params`` or ``train.gridConfigFile``,
expanded by :meth:`TrainProcessor._trials`), bagged or k-fold members,
and multi-class targets.  NN, LR, SVM, TensorFlow and WDL raise "not yet
ported" (ROADMAP Queue 1 items 7 and 10).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List

from ..config.meta import validate_train_params
from ..config.model_config import Algorithm
from ..config.validator import ModelStep, ValidationError
from ..data.shards import Shards
from ..train import grid_search
from .processor import BasicProcessor

log = logging.getLogger(__name__)


class TrainProcessor(BasicProcessor):
    step = ModelStep.TRAIN

    def process(self) -> int:
        mc = self.model_config
        alg = mc.train.algorithm
        if self.journal.was_torn and not self.params.get("resume"):
            # the previous train died mid-step: resume from the trainer
            # checkpoints, exactly as an explicit `train -resume` would
            log.info("train: previous run was interrupted — resuming "
                     "from trainer checkpoints")
            self.params["resume"] = True
        if alg in (Algorithm.GBT, Algorithm.RF, Algorithm.DT):
            from ..train.dt_trainer import run_tree_training
            return run_tree_training(self)
        raise NotImplementedError(
            f"{alg.name} training is not yet ported to shifu_tpu_torch "
            "(ROADMAP Queue 1 items 7 and 10) — train it with shifu_tpu")

    def _trials(self, params: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Grid trials: explicit per-line file (train.gridConfigFile,
        validated per trial via the meta schema) or cartesian expansion of
        list-valued params; file trials inherit unlisted keys from
        train#params (reference ``TrainProcessor._trials``)."""
        gcf = self.model_config.train.gridConfigFile
        if gcf:
            file_trials = grid_search.load_grid_config(self._abs(gcf))
            # list-valued params are grid axes in their own right — expand
            # them first so a file trial that doesn't mention the key
            # doesn't inherit a raw list (cartesian product of both)
            base_trials = grid_search.expand(params) \
                if grid_search.is_grid_search(params) else [params]
            merged = [{**b, **t} for b in base_trials for t in file_trials]
            # a file trial that sets an expanded key collapses that axis —
            # drop the resulting exact duplicates (keep first occurrence)
            seen, trials = set(), []
            for t in merged:
                key = tuple(sorted((k, repr(v)) for k, v in t.items()))
                if key not in seen:
                    seen.add(key)
                    trials.append(t)
            problems = []
            for i, t in enumerate(trials):
                for p in validate_train_params(
                        t, self.model_config.train.algorithm):
                    problems.append(f"gridConfigFile trial {i + 1}: {p}")
            if problems:
                raise ValidationError(problems)
            return trials
        if grid_search.is_grid_search(params):
            return grid_search.expand(params)
        return [params]

    def _open_shards(self, directory: str) -> Shards:
        return Shards.open(directory)

    def _use_streaming(self, shards: Shards, schema: dict) -> bool:
        from ..data.streaming import should_stream
        return should_stream(shards, schema)
