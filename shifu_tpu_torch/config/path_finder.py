"""PathFinder — where each step reads and writes inside a model-set
directory; the port's copy of the paths ``shifu_tpu.config.path_finder``
gives the init, stats, norm, varselect, train, posttrain, eval and export
steps (reference ``fs/PathFinder.java``), so both packages read and write
the same files."""

from __future__ import annotations

import os
from typing import Optional

from .model_config import ModelConfig

MODEL_CONFIG_JSON = "ModelConfig.json"
COLUMN_CONFIG_JSON = "ColumnConfig.json"


class PathFinder:
    def __init__(self, model_config: ModelConfig, model_set_dir: str = "."):
        self.model_config = model_config
        self.root = os.path.abspath(model_set_dir)

    @property
    def model_config_path(self) -> str:
        return os.path.join(self.root, MODEL_CONFIG_JSON)

    @property
    def column_config_path(self) -> str:
        return os.path.join(self.root, COLUMN_CONFIG_JSON)

    @property
    def tmp_dir(self) -> str:
        return os.path.join(self.root, "tmp")

    @property
    def stats_dir(self) -> str:
        return os.path.join(self.tmp_dir, "stats")

    @property
    def raw_cache_dir(self) -> str:
        """Columnar raw-parse cache root (``data/rawcache``): one
        subdirectory per (source signature, row identity)."""
        return os.path.join(self.tmp_dir, "RawCache")

    @property
    def stats_partial_path(self) -> str:
        """Mid-sweep stats accumulator checkpoint (resume support)."""
        return os.path.join(self.stats_dir, "partial_sweep.npz")

    @property
    def correlation_path(self) -> str:
        return os.path.join(self.root, "correlation.csv")

    @property
    def norm_dir(self) -> str:
        """Normalized (float) dataset shards — NN/LR/WDL input."""
        return os.path.join(self.tmp_dir, "NormalizedData")

    @property
    def clean_dir(self) -> str:
        """Binned (int) dataset shards — tree-model input."""
        return os.path.join(self.tmp_dir, "CleanedData")

    @property
    def models_dir(self) -> str:
        return os.path.join(self.root, "models")

    @property
    def tmp_models_dir(self) -> str:
        return os.path.join(self.tmp_dir, "modelsTmp")

    def model_path(self, index: int, alg: Optional[str] = None) -> str:
        if alg is None:
            alg = self.model_config.train.algorithm.name
            alg = {"TENSORFLOW": "nn"}.get(alg, alg)
        return os.path.join(self.models_dir, f"model{index}.{alg.lower()}")

    def tmp_model_path(self, index: int, epoch: int,
                       alg: Optional[str] = None) -> str:
        """A member's tmp model of an epoch (``models/tmp`` role)."""
        alg = (alg or self.model_config.train.algorithm.name).lower()
        return os.path.join(self.tmp_models_dir,
                            f"model{index}-{epoch}.{alg}")

    @property
    def checkpoint_dir(self) -> str:
        return os.path.join(self.tmp_dir, "checkpoints")

    @property
    def journal_dir(self) -> str:
        """Per-step commit journals (``pipeline/journal``)."""
        return os.path.join(self.tmp_dir, "journal")

    def journal_path(self, step: str) -> str:
        return os.path.join(self.journal_dir, f"{step}.json")

    @property
    def progress_path(self) -> str:
        return os.path.join(self.tmp_dir, "train.progress")

    # ---------------------------------------------------------------- eval
    def eval_dir(self, eval_name: str) -> str:
        return os.path.join(self.root, "evals", eval_name)

    def eval_score_path(self, eval_name: str) -> str:
        return os.path.join(self.eval_dir(eval_name), "EvalScore")

    def eval_confusion_path(self, eval_name: str) -> str:
        return os.path.join(self.eval_dir(eval_name), "EvalConfusionMatrix")

    def eval_performance_path(self, eval_name: str) -> str:
        return os.path.join(self.eval_dir(eval_name), "EvalPerformance.json")

    def eval_norm_path(self, eval_name: str) -> str:
        return os.path.join(self.eval_dir(eval_name), "EvalNormalized")

    # ------------------------------------------------------------ varselect
    @property
    def varsel_dir(self) -> str:
        return os.path.join(self.root, "varsels")

    @property
    def varsel_history_path(self) -> str:
        return os.path.join(self.varsel_dir, "varsel.history")

    # ------------------------------------------------------------ posttrain
    @property
    def post_train_dir(self) -> str:
        return os.path.join(self.root, "posttrain")

    @property
    def bin_avg_score_path(self) -> str:
        return os.path.join(self.post_train_dir, "binAvgScore.csv")

    @property
    def feature_importance_path(self) -> str:
        return os.path.join(self.post_train_dir, "featureImportance.csv")

    # -------------------------------------------------------------- export
    @property
    def export_dir(self) -> str:
        return os.path.join(self.root, "export")

    def pmml_path(self, index: int) -> str:
        return os.path.join(self.export_dir,
                            f"{self.model_config.basic.name}{index}.pmml")

    # ----------------------------------------------------------- telemetry
    @property
    def telemetry_dir(self) -> str:
        """Serving-plane telemetry (``obs/``): trace, heartbeats, metrics,
        score log, posttrain and quality snapshots."""
        return os.path.join(self.root, "telemetry")

    @property
    def posttrain_snapshot_path(self) -> str:
        """Training-time score distribution + AUC baseline
        (``obs/quality``) — what live quality is judged against."""
        return os.path.join(self.telemetry_dir, "posttrain.json")

    @property
    def backup_dir(self) -> str:
        return os.path.join(self.root, ".backup")

    def ensure_dirs(self) -> None:
        for d in (self.tmp_dir, self.stats_dir, self.models_dir,
                  self.tmp_models_dir, self.checkpoint_dir,
                  self.journal_dir):
            os.makedirs(d, exist_ok=True)
