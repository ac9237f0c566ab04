"""`train` step — the port of ``shifu_tpu.pipeline.train.TrainProcessor``.

Tree algorithms read the clean/binned plane (``tmp/CleanedData``) and go to
``train.dt_trainer.run_tree_training``; of them the resident,
single-member GBT is ported.  NN, LR, SVM, TensorFlow and WDL raise "not
yet ported" (ROADMAP Queue 1 items 7 and 10).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List

from ..config.model_config import Algorithm
from ..config.validator import ModelStep
from ..data.shards import Shards
from .processor import BasicProcessor

log = logging.getLogger(__name__)

# params whose value is naturally a list: only a list of lists is a grid
_LIST_VALUED = ("NumHiddenNodes", "ActivationFunc", "FixedLayers",
                "NumEmbedColumnIds")


def _is_axis(key: str, v) -> bool:
    """A list value is a grid axis unless the key naturally takes a list
    (``shifu_tpu.train.grid_search._is_axis``)."""
    if not isinstance(v, list):
        return False
    if key in _LIST_VALUED:
        return bool(v) and isinstance(v[0], list)
    return True


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
        """The trials of train#params: just ``params``, since grid search
        (list-valued params or a ``train.gridConfigFile``) is not yet
        ported."""
        if self.model_config.train.gridConfigFile or any(
                _is_axis(k, v) for k, v in params.items()):
            raise NotImplementedError(
                "grid search (list-valued train#params or "
                "train.gridConfigFile) is not yet ported to shifu_tpu_torch "
                "(ROADMAP Queue 1 item 6) — train it with shifu_tpu")
        return [dict(params)]

    def _open_shards(self, directory: str) -> Shards:
        return Shards.open(directory)

    def _use_streaming(self, shards: Shards, schema: dict) -> bool:
        from ..data.streaming import should_stream
        return should_stream(shards, schema)
