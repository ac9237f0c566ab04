"""`posttrain` step — the port of ``shifu_tpu.pipeline.posttrain``
(reference ``PostTrainModelProcessor.java``,
``core/posttrain/PostTrainMapper.java``): score the training plane with
the final models and write each column's per-bin average score into
``ColumnConfig.binAvgScore`` (Python ``round``, as the reference does),
with ``posttrain/binAvgScore.csv`` and a feature-importance ranking
``posttrain/featureImportance.csv`` (the bin-average spread weighted by
``1 - `` the largest bin's population share).

The norm plane (``tmp/NormalizedData``) and the clean plane
(``tmp/CleanedData``) are read shard by shard side by side; under the
default ``wireOnly`` norm the clean plane is the wire plane, which
``Shards.iter_shards`` serves as memmap slices at the norm shards' row
splits.  Scoring is ``eval/scorer.py``'s ``Scorer`` on the step's device:
forests walk with the ``tree_traverse`` kernel (B4) on the card, nets run
their GEMMs.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List

import numpy as np

from .. import ioutil
from ..config.validator import ModelStep
from ..data.shards import Shards
from ..eval.scorer import Scorer
from .processor import BasicProcessor

log = logging.getLogger(__name__)


class PostTrainProcessor(BasicProcessor):
    step = ModelStep.POSTTRAIN

    def process(self) -> int:
        scorer = Scorer.from_dir(self.paths.models_dir, device=self.device)
        norm = Shards.open(self.paths.norm_dir)
        clean = Shards.open(self.paths.clean_dir)
        col_nums: List[int] = clean.schema.get("columnNums", [])
        by_num = {c.columnNum: c for c in self.column_configs}

        sums: Dict[int, np.ndarray] = {}
        counts: Dict[int, np.ndarray] = {}
        with self.phase("score"):
            for nshard, cshard in zip(norm.iter_shards(),
                                      clean.iter_shards()):
                bins = np.asarray(cshard["bins"])
                scores = scorer.score(nshard["x"], bins=bins).mean
                for j, cnum in enumerate(col_nums):
                    cc = by_num.get(cnum)
                    if cc is None:
                        continue
                    nb = cc.num_bins() + 1              # + the missing bin
                    b = np.clip(bins[:, j].astype(np.int64), 0, nb - 1)
                    s = np.bincount(b, weights=scores, minlength=nb)
                    c = np.bincount(b, minlength=nb).astype(np.float64)
                    if cnum in sums:
                        sums[cnum] += s
                        counts[cnum] += c
                    else:
                        sums[cnum], counts[cnum] = s, c

        fi: Dict[str, float] = {}
        for cnum in col_nums:
            cc = by_num.get(cnum)
            if cc is None or cnum not in sums:
                continue
            avg = sums[cnum] / np.maximum(counts[cnum], 1)
            cc.columnBinning.binAvgScore = [int(round(v)) for v in avg]
            pop = counts[cnum] / max(counts[cnum].sum(), 1)
            seen = counts[cnum] > 0
            if seen.any():
                spread = float(avg[seen].max() - avg[seen].min())
                fi[cc.columnName] = spread * float(1 - pop.max())
        self.save_column_configs()

        os.makedirs(self.paths.post_train_dir, exist_ok=True)
        ranked = sorted(fi.items(), key=lambda kv: -kv[1])
        with ioutil.atomic_open(self.paths.feature_importance_path) as f:
            for name, v in ranked:
                f.write(f"{name}\t{v:.4f}\n")
        with ioutil.atomic_open(self.paths.bin_avg_score_path) as f:
            for cnum in col_nums:
                cc = by_num.get(cnum)
                if cc and cc.columnBinning.binAvgScore:
                    f.write(f"{cnum}|{cc.columnName}|"
                            + ",".join(map(str, cc.columnBinning.binAvgScore))
                            + "\n")
        log.info("posttrain on %s: bin average scores for %d columns; top "
                 "features %s", self.device, len(sums),
                 [n for n, _ in ranked[:5]])
        return 0
