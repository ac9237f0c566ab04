"""`test` step — the port of ``shifu_tpu.pipeline.smoke`` (reference
``ShifuTestProcessor.java``): user-side smoke test that configs, filters
and tag mapping parse cleanly on a sample of records before any device
time is spent; host code.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..config.validator import ModelStep
from ..data.extract import ChunkExtractor
from ..data.reader import DataSource
from .processor import BasicProcessor

log = logging.getLogger(__name__)

SAMPLE_ROWS = 100_000


class SmokeTestProcessor(BasicProcessor):
    step = ModelStep.INIT  # validates at init level; runs pre-stats fine

    def __init__(self, model_set_dir: str = ".",
                 params: Optional[dict] = None):
        super().__init__(model_set_dir, params, device="cpu")   # host step

    def process(self) -> int:
        mc = self.model_config
        # reference ShifuTestProcessor.java:54-60 `-filter [target]`:
        # blank = training set only, "*" = train + every eval set,
        # a name = that eval set only; default (no -filter) tests all
        target = self.params.get("filter_target")
        # four cases: None / "*" = training + all evals; "" = training
        # only; "a,b" = the named eval sets (comma-split, like the
        # reference's per-name loop)
        if target in (None, "*"):
            names = None
        elif str(target).strip() == "":
            return self._test_source("training", mc.dataSet, for_eval=None)
        else:
            names = [t.strip() for t in str(target).split(",") if t.strip()]
            if not names:                       # e.g. "," — a typo, not blank
                log.error("test -filter %r: no eval set names given", target)
                return 1
        rc = 0
        if names is None:
            rc |= self._test_source("training", mc.dataSet, for_eval=None)
        unmatched = set(names or [])
        for i, ev in enumerate(mc.evals):
            if names is not None and ev.name not in names:
                continue
            if ev.dataSet.dataPath:
                unmatched.discard(ev.name)
                rc |= self._test_source(f"eval:{ev.name}", ev.dataSet,
                                        for_eval=i)
        if unmatched:
            log.error("test -filter %s: no such eval set (or it has no "
                      "dataPath): %s", target, sorted(unmatched))
            return 1
        return rc

    def _test_source(self, label, ds, for_eval) -> int:
        try:
            source = DataSource(self._abs(ds.dataPath), ds.dataDelimiter,
                                header_path=self._abs(ds.headerPath),
                                header_delimiter=ds.headerDelimiter)
            extractor = ChunkExtractor(self.model_config, self.column_configs,
                                       for_eval_set=for_eval)
        except Exception as e:
            log.error("%s: FAILED to open (%s)", label, e)
            return 1
        n = pos = neg = filtered = 0
        missing_cells = 0
        for chunk in source.iter_chunks():
            ex = extractor.extract(chunk)
            raw_n = len(chunk)
            filtered += raw_n - ex.n
            n += ex.n
            pos += int(ex.target.sum())
            neg += int((1 - ex.target).sum())
            missing_cells += int((~ex.numeric_valid).sum())
            if n >= SAMPLE_ROWS:
                break
        if n == 0:
            log.error("%s: 0 usable records (check tags/filters/delimiter)",
                      label)
            return 1
        if pos == 0 or neg == 0:
            log.error("%s: one-sided tags (%d pos / %d neg) — check "
                      "posTags/negTags", label, pos, neg)
            return 1
        log.info("%s: OK — %d records sampled (%d pos / %d neg, %d filtered, "
                 "%.2f%% missing numeric cells)", label, n, pos, neg, filtered,
                 100.0 * missing_cells / max(n * max(ex.numeric.shape[1], 1), 1))
        return 0
