"""`varselect` step — the port of ``shifu_tpu.pipeline.varselect``
(reference ``VarSelectModelProcessor.java:95``, ``core/VariableSelector``
and the sensitivity MR job of ``core/varselect/``).

- Filter ranking by KS, IV, MIX (the mean of the KS and IV ranks) or
  PARETO (iterative fronts over KS and IV) from the stats in
  ``ColumnConfig.json``; FI from ``posttrain``'s ``featureImportance.csv``.
- SE / ST sensitivity of the trained NN/LR ``model0``: the norm plane
  streams through :func:`ops.sensitivity.streamed_sensitivity` on the
  step's device (``-Dshifu.varsel.batched=false`` runs the resident
  per-column loop instead); a column's score is the MSE rise when its
  feature block is frozen to its mean (ST: relative to the base error),
  written to ``varsels/se.json``.  On a mesh every rank reads each window
  and scores its block of the rows; the sums meet in an all_reduce, so
  every rank selects alike.
- The auto filter: missing rate, minimum KS and IV, and correlation
  pruning from an existing ``correlation.csv`` (skipped with a warning
  when it is absent, as the reference does).
- ``filterBy GENETIC``: the wrapper search of ``train/dvarsel.py`` over
  the norm plane (resident, or streamed past the memory budget), its
  candidates' nets trained on the step's device; the credit ranking goes
  to ``varsels/genetic.json``.  On a mesh it raises naming its item (the
  population lies on the ensemble axis, as the tree trainers' members
  do).
- ``-recursive N`` (SE/ST only): each round runs ``norm`` and ``train``
  on the current selection, selects again against the fresh model and
  snapshots ``varsels/ColumnConfig.json.{i}`` and ``se.{i}.json``.
- The force-select and force-remove name files (NSColumn matching),
  ``filterNum`` and ``filterOutRatio``; ``-list``, ``-reset``,
  ``-recover``, ``-autofilter``, ``-recoverauto`` and the varsel history.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Tuple

import numpy as np

from .. import obs
from ..config import ColumnConfig
from ..config.model_config import FilterBy
from ..config.validator import ModelStep, ValidationError
from .processor import BasicProcessor

log = logging.getLogger(__name__)


def pareto_front_ranks(ks: np.ndarray, iv: np.ndarray) -> np.ndarray:
    """Iterative Pareto fronts over (ks, iv): rank 0 is the first front.
    A point is dominated when another is >= on both and > on one."""
    n = len(ks)
    remaining = np.arange(n)
    ranks = np.zeros(n, int)
    r = 0
    while len(remaining):
        k, v = ks[remaining], iv[remaining]
        ge = (k[:, None] >= k[None, :]) & (v[:, None] >= v[None, :])
        gt = (k[:, None] > k[None, :]) | (v[:, None] > v[None, :])
        dominated = np.any(ge & gt, axis=0)
        ranks[remaining[~dominated]] = r
        remaining = remaining[dominated]
        r += 1
    return ranks


class VarSelectProcessor(BasicProcessor):
    step = ModelStep.VARSELECT

    def process(self) -> int:
        if self.params.get("list"):
            return self._list()
        if self.params.get("reset"):
            return self._reset()
        if self.params.get("recover"):
            return self._recover()
        if self.params.get("autofilter"):
            return self._autofilter_only()
        if self.params.get("recoverauto"):
            return self._recover_auto()
        vs = self.model_config.varSelect
        if vs.filterEnable and vs.filterBy == FilterBy.GENETIC:
            from ..parallel.mesh import device_mesh
            if device_mesh().size > 1:
                # the population lies on the ensemble axis, as the tree
                # trainers' members do: it comes with them
                raise NotImplementedError(
                    "filterBy GENETIC on a mesh is not yet ported to "
                    "shifu_tpu_torch (ROADMAP Queue 1 item 12, multi-device: "
                    "GENETIC varselect, with the tree trainers' member "
                    "kinds) — run it as one process")
        return self._select()

    # ---------------------------------------------------------- bookkeeping
    def _selected(self) -> List[ColumnConfig]:
        return [c for c in self.column_configs if c.finalSelect]

    def _list(self) -> int:
        for c in self._selected():
            log.info("selected: %3d %s (ks=%.4f iv=%.4f)", c.columnNum,
                     c.columnName, c.columnStats.ks or 0,
                     c.columnStats.iv or 0)
        log.info("%d columns selected", len(self._selected()))
        return 0

    def _reset(self) -> int:
        self._push_history()
        for c in self.column_configs:
            c.finalSelect = False
        self.save_column_configs()
        log.info("selection reset")
        return 0

    @staticmethod
    def _pop_last_history(path: str, what: str, apply_fn) -> bool:
        """Apply the last JSONL entry of a history file, and only then
        truncate it (a failure leaves the entry for a retry)."""
        if not os.path.isfile(path):
            log.error("no %s history to recover from", what)
            return False
        with open(path) as f:
            lines = f.read().strip().splitlines()
        if not lines:
            log.error("%s history empty", what)
            return False
        apply_fn(json.loads(lines[-1]))
        from ..ioutil import atomic_write_text
        atomic_write_text(path, "\n".join(lines[:-1])
                          + ("\n" if lines[:-1] else ""))
        return True

    def _recover(self) -> int:
        def apply(last):
            sel = set(last["selected"])
            for c in self.column_configs:
                c.finalSelect = c.columnNum in sel
            self.save_column_configs()
            log.info("recovered selection of %d columns (ts %s)",
                     len(sel), last.get("ts"))
        return 0 if self._pop_last_history(
            self.paths.varsel_history_path, "varsel", apply) else 1

    def _push_history(self) -> None:
        os.makedirs(self.paths.varsel_dir, exist_ok=True)
        entry = {"ts": time.strftime("%Y-%m-%d %H:%M:%S"),
                 "selected": [c.columnNum for c in self._selected()]}
        # an append-only ledger: readers tolerate a torn tail
        with open(self.paths.varsel_history_path, "a") as f:
            f.write(json.dumps(entry) + "\n")

    # ------------------------------------------------ standalone autofilter
    def _autofilter_only(self) -> int:
        """``varselect -autofilter``: the auto filter alone over the
        current selection, recording what it turned off."""
        vs = self.model_config.varSelect
        selected = [c for c in self.column_configs
                    if c.finalSelect and not c.is_force_select()]
        if not selected:
            log.error("no selected columns to auto-filter — run a "
                      "selection first")
            return 1
        kept = {c.columnNum for c in self._auto_filter(selected, vs)}
        removed = [c.columnNum for c in selected if c.columnNum not in kept]
        if not removed:
            log.info("autofilter: nothing to remove (%d columns pass)",
                     len(kept))
            return 0
        for c in selected:
            c.finalSelect = c.columnNum in kept
        os.makedirs(self.paths.varsel_dir, exist_ok=True)
        with open(self._autofilter_history_path(), "a") as f:
            f.write(json.dumps({"ts": time.strftime("%Y-%m-%d %H:%M:%S"),
                                "removed": removed}) + "\n")
        self.save_column_configs()
        log.info("autofilter: %d kept, %d removed", len(kept), len(removed))
        return 0

    def _recover_auto(self) -> int:
        """``varselect -recoverauto``: restore what the last
        ``-autofilter`` turned off."""
        def apply(last):
            removed = set(last["removed"])
            n = 0
            for c in self.column_configs:
                if c.columnNum in removed:
                    c.finalSelect = True
                    n += 1
            self.save_column_configs()
            log.info("recovered %d auto-filtered columns (ts %s)", n,
                     last.get("ts"))
        return 0 if self._pop_last_history(
            self._autofilter_history_path(), "autofilter", apply) else 1

    def _autofilter_history_path(self) -> str:
        return os.path.join(self.paths.varsel_dir, "autofilter.history")

    # ------------------------------------------------------------ selection
    def _check_filterby_algorithm(self) -> None:
        """filterBy against train.algorithm, before any side effect."""
        vs = self.model_config.varSelect
        if not vs.filterEnable:
            return
        fb, alg = vs.filterBy, self.model_config.train.algorithm.name
        if fb in (FilterBy.SE, FilterBy.ST) and \
                alg not in ("NN", "LR", "SVM", "TENSORFLOW"):
            raise ValidationError(
                [f"varSelect.filterBy {fb.name} needs an NN/LR model "
                 f"(train.algorithm is {alg}) — use filterBy FI for "
                 "tree models"])
        if fb == FilterBy.FI and alg not in ("GBT", "RF", "DT"):
            raise ValidationError(
                [f"varSelect.filterBy FI needs a tree model "
                 f"(train.algorithm is {alg}) — use SE/ST for NN/LR"])

    def _select(self) -> int:
        vs = self.model_config.varSelect
        self._check_filterby_algorithm()
        rounds = int(self.params.get("recursive") or 1)
        if rounds > 1:
            if vs.filterBy not in (FilterBy.SE, FilterBy.ST):
                log.error("varselect -recursive needs filterBy SE/ST "
                          "(wrapper re-scoring); got %s", vs.filterBy.name)
                return 1
            return self._recursive_select(rounds)
        return self._select_once()

    def _recursive_select(self, rounds: int) -> int:
        """SE/ST wrapper recursion (reference
        ``VarSelectModelProcessor.java:201-227``): each round re-norms and
        retrains on the current selection, re-scores sensitivity against
        the fresh model, re-selects, and snapshots ``ColumnConfig.json.{i}``
        and ``se.{i}.json`` into varsels/."""
        from .norm import NormalizeProcessor
        from .train import TrainProcessor
        os.makedirs(self.paths.varsel_dir, exist_ok=True)
        self._snapshot_round(0)
        for i in range(rounds):
            self.save_column_configs()   # current selection feeds norm/train
            for proc in (NormalizeProcessor(self.dir, {}),
                         TrainProcessor(self.dir, {}, device=self.device)):
                rc = proc.run()
                if rc != 0:
                    log.error("recursive varselect round %d: %s failed "
                              "(rc=%d)", i + 1, type(proc).__name__, rc)
                    return rc
            rc = self._select_once()
            if rc != 0:
                return rc
            self._snapshot_round(i + 1)
            se_src = os.path.join(self.paths.varsel_dir, "se.json")
            if os.path.isfile(se_src):
                _atomic_copy(se_src, os.path.join(self.paths.varsel_dir,
                                                  f"se.{i}.json"))
            log.info("recursive varselect round %d/%d: %d selected",
                     i + 1, rounds, len(self._selected()))
        return 0

    def _snapshot_round(self, i: int) -> None:
        src = self.paths.column_config_path
        if os.path.isfile(src):
            _atomic_copy(src, os.path.join(self.paths.varsel_dir,
                                           f"ColumnConfig.json.{i}"))

    def _select_once(self) -> int:
        vs = self.model_config.varSelect
        self._push_history()
        self._apply_force_files(vs)
        candidates = [c for c in self.column_configs
                      if c.is_candidate() and not c.is_force_select()
                      and c.columnStats.ks is not None]
        if vs.autoFilterEnable:
            candidates = self._auto_filter(candidates, vs)
        # columns pruned from `candidates` this run must not keep a stale
        # finalSelect from a previous run
        for c in self.column_configs:
            if not c.is_force_select():
                c.finalSelect = False
        if not vs.filterEnable:
            for c in candidates:
                c.finalSelect = True
            self.save_column_configs()
            return 0

        fb = vs.filterBy
        if fb in (FilterBy.SE, FilterBy.ST):
            scores = self._sensitivity_scores(candidates, fb)
        elif fb == FilterBy.GENETIC:
            scores = self._genetic_scores(candidates, vs)
        elif fb == FilterBy.FI:
            scores = self._fi_scores(candidates)
        elif fb == FilterBy.IV:
            scores = {c.columnNum: c.columnStats.iv or 0 for c in candidates}
        elif fb == FilterBy.MIX:
            ks_rank = _rank_of({c.columnNum: c.columnStats.ks or 0
                                for c in candidates})
            iv_rank = _rank_of({c.columnNum: c.columnStats.iv or 0
                                for c in candidates})
            scores = {k: -(ks_rank[k] + iv_rank[k]) / 2 for k in ks_rank}
        elif fb == FilterBy.PARETO:
            ks = np.array([c.columnStats.ks or 0 for c in candidates])
            iv = np.array([c.columnStats.iv or 0 for c in candidates])
            ranks = pareto_front_ranks(ks, iv)
            scores = {c.columnNum: -float(r)
                      for c, r in zip(candidates, ranks)}
        else:  # KS, the default
            scores = {c.columnNum: c.columnStats.ks or 0 for c in candidates}

        # -inf marks columns the scoring model never saw: never
        # selectable, and out of the filterOutRatio count
        candidates = [c for c in candidates
                      if scores[c.columnNum] != float("-inf")]
        n_keep = vs.filterNum
        if vs.filterOutRatio is not None:
            n_keep = min(n_keep,
                         int(len(candidates) * (1 - vs.filterOutRatio)))
        ranked = sorted(candidates, key=lambda c: -scores[c.columnNum])
        keep = set(c.columnNum for c in ranked[:n_keep])
        for c in candidates:
            c.finalSelect = c.columnNum in keep
        self.save_column_configs()
        n_force = sum(1 for c in self.column_configs if c.is_force_select())
        log.info("varselect by %s: %d selected (+%d force), from %d "
                 "candidates", fb.name, len(keep), n_force, len(candidates))
        return 0

    def _apply_force_files(self, vs) -> None:
        from ..config.column_config import (ColumnFlag, ns_in,
                                            read_column_name_file)
        force_sel = read_column_name_file(
            self._abs(vs.forceSelectColumnNameFile))
        force_rem = read_column_name_file(
            self._abs(vs.forceRemoveColumnNameFile))
        for c in self.column_configs:
            # bare names in the files match namespaced header columns
            if ns_in(c.columnName, force_rem):
                c.columnFlag = ColumnFlag.ForceRemove
                c.finalSelect = False
            elif ns_in(c.columnName, force_sel) and c.is_candidate():
                c.columnFlag = ColumnFlag.ForceSelect
                c.finalSelect = True

    def _auto_filter(self, candidates: List[ColumnConfig], vs
                     ) -> List[ColumnConfig]:
        """Missing rate, minimum KS and IV, then correlation pruning."""
        out = [c for c in candidates
               if (c.columnStats.missingPercentage or 0.0)
               <= vs.missingRateThreshold
               and (c.columnStats.ks or 0) >= vs.minKsThreshold
               and (c.columnStats.iv or 0) >= vs.minIvThreshold]
        dropped = len(candidates) - len(out)
        if vs.correlationThreshold < 1.0:
            out, corr_dropped = self._correlation_prune(out, vs)
            dropped += corr_dropped
        if dropped:
            log.info("auto-filter removed %d columns", dropped)
        return out

    def _correlation_prune(self, cols: List[ColumnConfig], vs
                           ) -> Tuple[List[ColumnConfig], int]:
        """Keep columns in KS order, dropping each whose |correlation|
        with a kept one passes ``correlationThreshold``."""
        corr_path = self.paths.correlation_path
        if not os.path.isfile(corr_path):
            log.warning("correlation matrix missing — run `stats "
                        "-correlation` first; skipping correlation pruning")
            return cols, 0
        # header row + name-keyed rows, as `stats -correlation` writes it
        with open(corr_path) as f:
            header = f.readline().strip().split(",")[1:]
            mat = np.array([[float(v) for v in line.strip().split(",")[1:]]
                            for line in f])
        idx = {n: i for i, n in enumerate(header)}
        abs_mat = np.abs(mat)
        kept: List[ColumnConfig] = []
        kept_rows: List[int] = []
        for c in sorted(cols, key=lambda c: -(c.columnStats.ks or 0)):
            i = idx.get(c.columnName)
            if i is None or not kept_rows or \
                    not np.any(abs_mat[i, kept_rows]
                               > vs.correlationThreshold):
                kept.append(c)
                if i is not None:
                    kept_rows.append(i)
        kept_names = {c.columnName for c in kept}
        return [c for c in cols if c.columnName in kept_names], \
            len(cols) - len(kept)

    # --------------------------------------------------------- sensitivity
    def _sensitivity_scores(self, candidates: List[ColumnConfig],
                            fb: FilterBy) -> Dict[int, float]:
        """SE/ST: the MSE rise when a column's feature block is frozen to
        its mean, scored by the trained ``model0`` over the norm plane."""
        from ..config import environment
        from ..data.shards import Shards
        from ..ioutil import atomic_write_json
        from ..models import nn as nn_model
        from ..ops import sensitivity as sens

        model_path = self.paths.model_path(0, None)
        if not os.path.isfile(model_path):
            raise FileNotFoundError(
                f"{model_path} not found — SE/ST varselect needs a trained "
                "model; run `train` first")
        spec, params = nn_model.load_model(model_path)
        shards = Shards.open(self.paths.norm_dir)
        names = shards.schema["outputNames"]
        blocks = _column_blocks(names, candidates)
        in_plane = [c for c in candidates if blocks.get(c.columnNum)]
        if not in_plane:
            raise RuntimeError("SE/ST varselect: no candidate feature "
                               "blocks in the normalized plane — run `norm`")
        masks = sens.mask_matrix(
            len(names), [blocks[c.columnNum] for c in in_plane])
        t0 = time.perf_counter()
        with self.phase("sensitivity"):
            if environment.get_bool("shifu.varsel.batched", True):
                mse, base_mse, n_rows = self._streamed_sensitivity(
                    shards, spec, params, masks)
            else:               # the resident per-column loop
                data = shards.load_all()
                mse, base_mse = sens.per_column_scores(
                    spec, params, data["x"], data["y"], masks,
                    device=self.device)
                n_rows = len(data["y"])
        dt = max(time.perf_counter() - t0, 1e-9)
        obs.gauge("varsel.rows_per_sec").set(n_rows * len(in_plane) / dt)
        obs.gauge("varsel.candidates").set(float(len(in_plane)))
        log.info("sensitivity on %s: %d candidates x %d rows in %.2fs "
                 "(%.0f rows*cols/s)", self.device, len(in_plane), n_rows,
                 dt, n_rows * len(in_plane) / dt)
        scores = _scores_from_mse(candidates,
                                  [c.columnNum for c in in_plane],
                                  mse, base_mse, fb)
        os.makedirs(self.paths.varsel_dir, exist_ok=True)
        atomic_write_json(
            os.path.join(self.paths.varsel_dir, "se.json"),
            {str(k): v for k, v in
             sorted(scores.items(), key=lambda kv: -kv[1])
             if v != float("-inf")})
        return scores

    def _streamed_sensitivity(self, shards, spec, params, masks):
        """Window geometry and stream wiring of the mask-batched job:
        (mse, base_mse, rows)."""
        from ..data.streaming import ShardStream, stream_window_rows
        from ..ops import sensitivity as sens
        from ..parallel.mesh import device_mesh
        B = sens.mask_batch_size(self.model_config.varSelect.params)
        d = len(shards.schema["outputNames"])
        # every rank reads each window and scores its block of the rows
        mesh = device_mesh()
        # a launch holds ~B frozen copies of the window's first layer:
        # count B in the row bytes so the auto window shrinks with it
        window_rows = stream_window_rows(4 * (d + 2) * max(1, B // 4),
                                         mesh.n_data, shards)
        stream = ShardStream(shards, ("x", "y"), window_rows)
        log.info("sensitivity STREAMED: window %d rows, mask batch %d "
                 "(%d launches a window)", window_rows, B,
                 -(-len(masks) // B))
        return sens.streamed_sensitivity(stream, spec, params, masks,
                                         mask_batch=B, device=self.device,
                                         mesh=mesh)

    def _genetic_scores(self, candidates: List[ColumnConfig],
                        vs) -> Dict[int, float]:
        """The dvarsel wrapper search over the norm plane: resident, or
        streamed in windows when the plane is past the memory budget
        (``should_stream``); the population's nets train on the step's
        device.  Writes ``varsels/genetic.json``."""
        from ..data.shards import Shards
        from ..data.streaming import (ShardStream, should_stream,
                                      stream_window_rows)
        from ..ioutil import atomic_write_json
        from ..train.dvarsel import (WrapperSettings, genetic_varselect,
                                     genetic_varselect_streamed)

        shards = Shards.open(self.paths.norm_dir)
        names = shards.schema["outputNames"]
        blocks = {cn: idx for cn, idx in
                  _column_blocks(names, candidates).items() if idx}
        if not blocks:
            raise RuntimeError("genetic varselect: no candidate feature "
                               "blocks in the normalized plane — run `norm`")
        settings = WrapperSettings.from_params(
            vs.params, n_select=min(vs.filterNum, len(blocks)),
            valid_rate=self.model_config.train.validSetRate)
        if should_stream(shards):
            window_rows = stream_window_rows(4 * (len(names) + 2), 1,
                                             shards)
            stream = ShardStream(shards, ("x", "y", "w"), window_rows)
            log.info("genetic varselect STREAMED: window %d rows, "
                     "population %d", window_rows, settings.population)
            t0 = time.perf_counter()
            with self.phase("genetic"):
                scores, history = genetic_varselect_streamed(
                    stream, blocks, settings, device=self.device)
        else:
            data = shards.load_all()
            t0 = time.perf_counter()
            with self.phase("genetic"):
                scores, history = genetic_varselect(
                    data["x"], data["y"], data["w"], blocks, settings,
                    device=self.device)
        dt = max(time.perf_counter() - t0, 1e-9)
        epochs = settings.generations * settings.epochs
        log.info("genetic varselect on %s: %d generations x %d candidates "
                 "in %.2fs (%.1f epochs/s)", self.device,
                 settings.generations, settings.population, dt, epochs / dt)
        os.makedirs(self.paths.varsel_dir, exist_ok=True)
        atomic_write_json(
            os.path.join(self.paths.varsel_dir, "genetic.json"),
            {"history": history,
             "credit": {str(k): v for k, v in sorted(
                 scores.items(), key=lambda kv: -kv[1])}})
        # columns with no feature block rank last
        for c in candidates:
            scores.setdefault(c.columnNum, -1.0)
        return scores

    def _fi_scores(self, candidates: List[ColumnConfig]) -> Dict[int, float]:
        """FI: ``posttrain``'s featureImportance.csv."""
        fi_path = self.paths.feature_importance_path
        if not os.path.isfile(fi_path):
            raise FileNotFoundError(
                f"{fi_path} not found — FI varselect needs `posttrain` first")
        by_name = {}
        with open(fi_path) as f:
            for line in f:
                name, v = line.rsplit("\t", 1)
                by_name[name] = float(v)
        return {c.columnNum: by_name.get(c.columnName, 0.0)
                for c in candidates}


def _column_blocks(names: List[str],
                   candidates: List[ColumnConfig]) -> Dict[int, List[int]]:
    """Feature indices per source column: output names are the full
    column name, with a ``_k`` suffix where a column expands (one-hot)."""
    by_name = {c.columnName: c.columnNum for c in candidates}
    blocks: Dict[int, List[int]] = {}
    for i, n in enumerate(names):
        base = n
        if base not in by_name and "_" in base:
            stem, _, tail = base.rpartition("_")
            if stem in by_name and tail.isdigit():
                base = stem
        cn = by_name.get(base)
        if cn is not None:
            blocks.setdefault(cn, []).append(i)
    return blocks


def _scores_from_mse(candidates: List[ColumnConfig],
                     in_plane_ids: List[int], mse: np.ndarray,
                     base_mse: float, fb: FilterBy) -> Dict[int, float]:
    """Frozen MSEs to SE (absolute rise) or ST (rise over the base)
    scores.  Candidates outside the model's plane score ``-inf``."""
    scores = {c.columnNum: float("-inf") for c in candidates}
    for cn, m in zip(in_plane_ids, mse):
        scores[cn] = (float(m) - base_mse) if fb == FilterBy.SE \
            else (float(m) - base_mse) / max(base_mse, 1e-12)
    return scores


def _atomic_copy(src: str, dst: str) -> None:
    """Whole-or-nothing snapshot copy."""
    from ..ioutil import atomic_write_bytes
    with open(src, "rb") as f:
        atomic_write_bytes(dst, f.read())


def _rank_of(scores: Dict[int, float]) -> Dict[int, int]:
    order = sorted(scores, key=lambda k: -scores[k])
    return {k: i for i, k in enumerate(order)}

