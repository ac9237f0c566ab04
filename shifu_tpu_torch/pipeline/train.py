"""`train` step — the port of ``shifu_tpu.pipeline.train.TrainProcessor``.

Tree algorithms read the clean/binned plane (``tmp/CleanedData``) and go to
``train.dt_trainer.run_tree_training``: GBT, RF and DT, single or as grid
trials (list-valued ``train#params`` or ``train.gridConfigFile``,
expanded by :meth:`TrainProcessor._trials`), bagged or k-fold members,
and multi-class targets, resident or out of core (a plane over
``shifu.train.memoryBudgetBytes``, or ``-Dshifu.train.streaming=on``).

NN and LR (and TENSORFLOW, which trains the same net) read the norm plane
(``tmp/NormalizedData``) and train as one stacked ensemble on the step's
device (``train.nn_trainer.train_ensemble``): bagging and k-fold members,
same-shape grid trials (``tmp/grid_search.json`` ranks them, the best is
``model0``), one-vs-all members (``model{b*K+k}`` with
``spec.extra.class_index``) or a native softmax head, ``-shuffle`` and
continuous training.  A norm plane over ``shifu.train.memoryBudgetBytes``
(or any with ``-Dshifu.train.streaming=on``) trains out of core through
``train.nn_trainer.train_ensemble_streamed``: windows of
``shifu.train.windowRows`` rows (default: the budget's), sampling masks
hashed from the global row index, grid trials one streamed run each.

SVM with the linear kernel is the NN path's hinge head (``Const`` C maps
to L2 ``1/(2C)``; the model file scores through a sigmoid); the other
kernels solve the dual on the step's device (``train.svm_trainer``), one
``model{b}.svm`` a bag, each bag journalled so an interrupted run skips
the bags it solved.  WDL reads both planes and trains through
``train.wdl_trainer.run_wdl_training``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .. import faults
from ..config.meta import validate_train_params
from ..config.model_config import Algorithm
from ..config.validator import ModelStep, ValidationError
from ..data.shards import Shards
from ..models import nn as nn_model
from ..ops import prng
from ..train import grid_search
from ..train.nn_trainer import (TrainSettings, train_ensemble,
                                train_ensemble_streamed)
from ..train.sampling import member_masks
from .processor import BasicProcessor

log = logging.getLogger(__name__)


def settings_from_params(params: Dict[str, Any], train_conf,
                         defaults: Optional[Dict[str, Any]] = None
                         ) -> TrainSettings:
    """Map reference ``train#params`` keys (Propagation/LearningRate/
    RegularizedConstant/DropoutRate/...) onto TrainSettings."""
    p = dict(defaults or {})
    p.update(params or {})
    return TrainSettings(
        optimizer=str(p.get("Propagation", p.get("Optimizer", "R"))),
        learning_rate=float(p.get("LearningRate", 0.1)),
        learning_decay=float(p.get("LearningDecay", 0.0)),
        l2=float(p.get("RegularizedConstant", p.get("L2Const", 0.0))),
        l1=float(p.get("L1Const", 0.0)),
        dropout_rate=float(p.get("DropoutRate", 0.0)),
        epochs=int(train_conf.numTrainEpochs),
        batch_size=int(p.get("MiniBatchs", 0) or 0),
        early_stop_window=int(p.get("WindowSize", 10)
                              if train_conf.earlyStopEnable else 0),
        weight_initializer=str(p.get("WeightInitializer", "xavier")),
        seed=int(p.get("Seed", 0)),
        tmp_model_every=int(p.get("TmpModelEpochs", 0) or 0),
        checkpoint_every=int(p.get("CheckpointInterval", 25)),
        fixed_layers=tuple(int(v) for v in p.get("FixedLayers", []) or []),
        fixed_bias=bool(p.get("FixedBias", False)),
        matmul_precision=str(p.get("Precision", "") or ""),
        precision=str(p.get("TrainPrecision", "") or ""),
    )


def nn_spec_from_params(input_dim: int, params: Dict[str, Any],
                        column_nums: List[int],
                        feature_names: List[str]) -> nn_model.NNModelSpec:
    """Reference NN shape keys: NumHiddenLayers / NumHiddenNodes /
    ActivationFunc."""
    nodes = params.get("NumHiddenNodes", [50])
    acts = params.get("ActivationFunc", ["tanh"] * len(nodes))
    n_layers = int(params.get("NumHiddenLayers", len(nodes)))
    nodes = [int(v) for v in nodes][:n_layers] or [50]
    acts = [str(a).lower() for a in acts][:n_layers] or ["tanh"]
    while len(acts) < len(nodes):
        acts.append(acts[-1])
    return nn_model.NNModelSpec(
        input_dim=input_dim, hidden_nodes=nodes, activations=acts,
        output_dim=1, output_activation="sigmoid",
        loss=str(params.get("Loss", "squared")).lower(),
        column_nums=column_nums, feature_names=feature_names)


def lr_spec(input_dim: int, params: Dict[str, Any], column_nums: List[int],
            feature_names: List[str]) -> nn_model.NNModelSpec:
    """LR as the degenerate 0-hidden-layer net: one sigmoid(xW+b) matmul
    (``LogisticRegressionWorker.java:302-346``'s model)."""
    return nn_model.NNModelSpec(
        input_dim=input_dim, hidden_nodes=[], activations=[],
        output_dim=1, output_activation="sigmoid", loss="log",
        column_nums=column_nums, feature_names=feature_names,
        extra={"algorithm": "LR"})


def svm_spec(input_dim: int, params: Dict[str, Any], column_nums: List[int],
             feature_names: List[str]) -> nn_model.NNModelSpec:
    """Linear SVM: hinge loss on a linear head (reference
    ``core/alg/SVMTrainer.java``'s Kernel/Gamma/Const params).  The other
    kernels solve the dual (``train/svm_trainer.py``) and reach this spec
    only on the streamed path, where the kernel matrix cannot be
    materialised: a coded error, as the reference's libsvm SVM is
    local-only too.  ``Const`` (C) is kept in ``extra``; the trainer maps
    it to L2 ``1/(2C)`` (:func:`_apply_svm_objective`)."""
    kernel = str(params.get("Kernel", "linear")).lower()
    if kernel != "linear":
        from ..config.errors import ErrorCode, ShifuError
        raise ShifuError(ErrorCode.ERROR_MODELCONFIG_NOT_VALIDATION,
                         f"SVM Kernel={kernel!r} cannot run in streamed/"
                         "out-of-core mode (the kernel matrix is "
                         "local-scale by nature); drop "
                         "-Dshifu.train.streaming or use NN/GBT")
    c_penalty = float(params.get("Const", 1.0))
    return nn_model.NNModelSpec(
        input_dim=input_dim, hidden_nodes=[], activations=[],
        output_dim=1, output_activation="linear", loss="hinge",
        column_nums=column_nums, feature_names=feature_names,
        extra={"algorithm": "SVM", "svm_const": c_penalty})


def _apply_svm_objective(settings: TrainSettings, alg: Algorithm,
                         run_params: Dict[str, Any]) -> None:
    """Soft-margin C -> L2 ``1/(2C)``, default C = 1."""
    if alg == Algorithm.SVM:
        settings.l2 = 1.0 / (2.0 * float(run_params.get("Const", 1.0)))


def _scoring_spec(spec: nn_model.NNModelSpec) -> nn_model.NNModelSpec:
    """The spec a model file ships with: the SVM trains a linear head
    (hinge needs raw margins) and scores through a sigmoid, so eval stays
    in the [0, 1] * 1000 range (rank metrics unchanged)."""
    if (spec.extra or {}).get("algorithm") == "SVM":
        return dataclasses.replace(
            spec, output_activation="sigmoid",
            extra={**spec.extra, "margin_sigmoid": True})
    return spec


class TrainProcessor(BasicProcessor):
    step = ModelStep.TRAIN

    def process(self) -> int:
        mc = self.model_config
        alg = mc.train.algorithm
        if self.params.get("dry"):
            log.info("dry run: algorithm=%s bags=%d epochs=%d", alg.name,
                     mc.train.baggingNum, mc.train.numTrainEpochs)
            return 0
        if self.journal.was_torn and not self.params.get("resume"):
            # the previous train died mid-step: resume from the trainer
            # checkpoints, exactly as an explicit `train -resume` would
            log.info("train: previous run was interrupted — resuming "
                     "from trainer checkpoints")
            self.params["resume"] = True
        if alg in (Algorithm.NN, Algorithm.LR, Algorithm.SVM,
                   Algorithm.TENSORFLOW):
            if alg == Algorithm.TENSORFLOW:
                # the reference's TF-on-YARN bridge trains the same net
                # here; TF-only params it would ignore are an error
                from ..config.meta import tf_ignored_param_problems
                tf_problems = tf_ignored_param_problems(mc.train)
                if tf_problems:
                    raise ValidationError(tf_problems)
                log.info("algorithm TENSORFLOW: training the same network "
                         "on the NN path")
            return self._train_nn_family(
                Algorithm.NN if alg == Algorithm.TENSORFLOW else alg)
        if alg in (Algorithm.GBT, Algorithm.RF, Algorithm.DT):
            from ..train.dt_trainer import run_tree_training
            return run_tree_training(self)
        if alg == Algorithm.WDL:
            from ..train.wdl_trainer import run_wdl_training
            return run_wdl_training(self)
        raise ValueError(f"unsupported algorithm {alg}")

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

    # ------------------------------------------------------------ NN / LR
    def _train_nn_family(self, alg: Algorithm) -> int:
        from ..config.model_config import MultipleClassification
        mc = self.model_config
        K = len(mc.dataSet.posTags) if mc.is_multi_class() else 0
        ova = K > 2 and mc.train.multiClassifyMethod == \
            MultipleClassification.ONEVSALL
        if ova and (mc.train.gridConfigFile or
                    grid_search.is_grid_search(mc.train.params or {})):
            raise ValueError("grid search is not supported with "
                             "ONEVSALL multi-class")
        shards = self._open_shards(self.paths.norm_dir)
        if self._use_streaming(shards, shards.schema):
            return self._train_nn_streamed(alg, shards, K, ova)
        with self.phase("load_data"):
            data = shards.load_all()
        x, y, w = data["x"], data["y"], data["w"]
        if self.params.get("shuffle"):
            # `train -shuffle` re-randomizes row order before training
            perm = np.random.default_rng(0).permutation(len(y))
            x, y, w = x[perm], y[perm], w[perm]
        schema = shards.schema
        column_nums = schema.get("columnNums", [])
        feature_names = schema.get("outputNames", [])
        n, d = x.shape
        log.info("train %s on %s: %d rows x %d features", alg.name,
                 self.device, n, d)
        if alg == Algorithm.SVM and str((mc.train.params or {}).get(
                "Kernel", "linear")).lower() != "linear":
            # a local-scale solve: on a mesh every rank solves the whole
            # plane, as the reference's processes do
            return self._train_kernel_svm(x, y, w, column_nums,
                                          feature_names)

        params = dict(mc.train.params or {})
        trials = self._trials(params)
        is_gs = len(trials) > 1
        kfold = mc.train.numKFold if mc.train.isCrossValidation else -1
        bags = 1 if is_gs else max(1, mc.train.baggingNum)
        os.makedirs(self.paths.tmp_models_dir, exist_ok=True)
        t0 = time.time()
        results = []
        # a live progress stream operators tail
        with open(self.paths.progress_path, "w") as pf:
            # same-shape grid trials train as ONE stacked run with
            # per-member hypers; otherwise one run of every member
            runs = grid_search.stackable_groups(trials) if is_gs \
                else [list(range(bags))]
            for run in runs:
                run_params = trials[run[0]] if is_gs else dict(params)
                results.append(self._train_run(
                    alg, run, run_params, trials, is_gs, kfold, bags, K,
                    ova, x, y, w, column_nums, feature_names, pf))
        with self.phase("save_models"):
            self._write_models(results, alg, is_gs)
        log.info("train done in %.1fs", time.time() - t0)
        return 0

    def _train_run(self, alg, run, run_params, trials, is_gs, kfold, bags,
                   K, ova, x, y, w, column_nums, feature_names, pf):
        """One stacked run: a group of same-shape grid trials, or every
        bagging/k-fold member (times K classes one-vs-all)."""
        mc = self.model_config
        n, d = x.shape
        spec = self._make_spec(alg, d, run_params, column_nums,
                               feature_names)
        if K > 2 and not ova:
            # native multi-class: one softmax head over K classes
            spec.output_dim = K
            spec.output_activation = "softmax"
            spec.extra["n_classes"] = K
        settings = settings_from_params(run_params, mc.train)
        _apply_svm_objective(settings, alg, run_params)
        if not is_gs:
            # trainer-state checkpoints: only full runs checkpoint/resume
            settings.checkpoint_dir = self.paths.checkpoint_dir
            settings.resume = bool(self.params.get("resume"))
            settings.resume_extra = int(self.params.get("refresh_extra")
                                        or 0)
        up_w = mc.train.upSampleWeight
        if K > 2 and up_w != 1.0:
            log.warning("upSampleWeight ignored for multi-class")
            up_w = 1.0
        train_w, valid_w = member_masks(
            n, 1 if is_gs else bags, valid_rate=mc.train.validSetRate,
            kfold=kfold if not is_gs else -1,
            sample_rate=mc.train.baggingSampleRate,
            replacement=mc.train.baggingWithReplacement,
            stratified=mc.train.stratifiedSample,
            up_sample_weight=up_w, targets=y, seed=settings.seed)
        if is_gs:
            # every trial of the group sees the SAME split
            train_w = np.tile(train_w, (len(run), 1))
            valid_w = np.tile(valid_w, (len(run), 1))
        y_members = None
        if ova:
            # member b*K+k trains class k's binary task on bag b's mask
            b0 = train_w.shape[0]
            train_w = np.repeat(train_w, K, axis=0)
            valid_w = np.repeat(valid_w, K, axis=0)
            y_members = np.tile(np.stack([(y == k).astype(np.float32)
                                          for k in range(K)]), (b0, 1))
            spec.extra.update({"ova_classes": K, "n_classes": K})
        n_members = train_w.shape[0]
        train_w = train_w * w[None, :]
        valid_w = valid_w * w[None, :]
        init_list = self._continuous_init(spec, n_members, alg, settings)
        member_hypers = None
        if is_gs and len(run) > 1:
            # identical init, so the trials differ only in their hypers
            if init_list is None:
                p0 = nn_model.init_params(prng.prng_key(settings.seed),
                                          spec, settings.weight_initializer)
                init_list = [p0] * len(run)
            else:
                init_list = [init_list[0]] * len(run)
            tsl = [settings_from_params(trials[t], mc.train) for t in run]
            base_lr = settings.learning_rate
            member_hypers = {
                "lr_scale": np.array([s.learning_rate / base_lr
                                      for s in tsl]),
                "l2": np.array([s.l2 for s in tsl]),
                "l1": np.array([s.l1 for s in tsl]),
                "dropout": np.array([s.dropout_rate for s in tsl])}
        from ..parallel.mesh import device_mesh
        # members on the ensemble axis, rows on the data axis (reference
        # ``device_mesh(n_ensemble=members)``); a world of one: one card
        mesh = device_mesh(n_ensemble=n_members)
        with self.phase("train"):
            res = train_ensemble(
                x, y, train_w, valid_w, spec, settings,
                init_params_list=init_list,
                progress=self._progress_fn(pf, run),
                checkpoint=self._checkpoint_fn(spec, alg),
                y_members=y_members, member_hypers=member_hypers,
                device=self.device, mesh=mesh)
        return run, spec, res, ([trials[t] for t in run] if is_gs
                                else run_params)

    def _train_nn_streamed(self, alg: Algorithm, shards: Shards, K: int,
                           ova: bool) -> int:
        """The streamed counterpart of the resident NN family: windows
        flow through ``train_ensemble_streamed``; sampling masks are
        stateless hashes of the global row index (``data.streaming``).
        Members go on the mesh's ensemble axis and each window's rows on
        its data axis; with ``-Dshifu.dcn.elastic`` and a
        ``SHIFU_PROCESS_ID`` each epoch closes through the elastic step
        protocol (``parallel/elastic.py``) instead."""
        from ..data.streaming import (ShardStream, mask_fn_from_settings,
                                      stream_window_rows)
        from ..parallel.elastic import elastic_context_for
        from ..parallel.mesh import device_mesh
        mc = self.model_config
        schema = shards.schema
        column_nums = schema.get("columnNums", [])
        feature_names = schema.get("outputNames", [])
        d = len(feature_names)
        n_rows = schema.get("numRows") or shards.num_rows
        params = dict(mc.train.params or {})
        trials = self._trials(params)
        is_gs = len(trials) > 1
        kfold = mc.train.numKFold if mc.train.isCrossValidation else -1
        bags = 1 if is_gs else max(1, mc.train.baggingNum)
        if mc.train.stratifiedSample:
            log.warning("streaming: stratified validation degrades to a "
                        "Bernoulli split (it needs a global pass)")
        if self.params.get("shuffle"):
            log.warning("streaming: `train -shuffle` ignored; use "
                        "`norm -shuffle` to reshuffle the materialized "
                        "shards")
        # members on the ensemble axis (k-fold folds, or bags; one-vs-all
        # fans each out per class), rows on the data axis
        mesh_members = kfold if (not is_gs and kfold and kfold > 1) \
            else bags
        mesh = device_mesh(n_ensemble=mesh_members * (K if ova else 1))
        data_size = mesh.shape["data"]
        window_rows = stream_window_rows(4 * (d + 2), data_size, shards)
        log.info("train %s STREAMED on %s: %d rows x %d features, window "
                 "%d rows, mesh %s", alg.name, self.device, n_rows, d,
                 window_rows, mesh.shape)
        # grid trials stay synchronous: their step ids would collide
        ectx = None if is_gs else elastic_context_for(self.dir)
        os.makedirs(self.paths.tmp_models_dir, exist_ok=True)
        t0 = time.time()
        results = []
        with open(self.paths.progress_path, "w") as pf, \
                ectx if ectx is not None else contextlib.nullcontext():
            runs = [[t] for t in range(len(trials))] if is_gs \
                else [list(range(bags))]
            for run in runs:
                run_params = trials[run[0]] if is_gs else dict(params)
                spec = self._make_spec(alg, d, run_params, column_nums,
                                       feature_names)
                if K > 2 and not ova:
                    spec.output_dim = K
                    spec.output_activation = "softmax"
                    spec.extra["n_classes"] = K
                if ova:
                    spec.extra.update({"ova_classes": K, "n_classes": K})
                settings = settings_from_params(run_params, mc.train)
                _apply_svm_objective(settings, alg, run_params)
                if not is_gs:
                    settings.checkpoint_dir = self.paths.checkpoint_dir
                    settings.resume = bool(self.params.get("resume"))
                    settings.resume_extra = int(
                        self.params.get("refresh_extra") or 0)
                run_kfold = kfold if not is_gs else -1
                n_members = run_kfold if (run_kfold and run_kfold > 1) \
                    else (len(run) if is_gs else bags)
                up_w = mc.train.upSampleWeight
                if K > 2 and up_w != 1.0:
                    log.warning("upSampleWeight ignored for multi-class")
                    up_w = 1.0
                mask_fn = mask_fn_from_settings(
                    n_members, valid_rate=mc.train.validSetRate,
                    kfold=run_kfold, sample_rate=mc.train.baggingSampleRate,
                    replacement=mc.train.baggingWithReplacement,
                    up_sample_weight=up_w, seed=settings.seed)
                member_classes = None
                if ova:
                    # member b*K + k trains class k on bag b's masks,
                    # binarised on the device
                    def mask_fn(idx, targets, base_fn=mask_fn):
                        tm, vm = base_fn(idx, targets)
                        return (np.repeat(tm, K, axis=0),
                                np.repeat(vm, K, axis=0))
                    member_classes = [k for _ in range(n_members)
                                      for k in range(K)]
                    n_members *= K
                # full batch: the tail window shrinks to a remainder rung
                # (a multiple of the data axis); minibatch slices keep the
                # window's fixed edges
                stream = ShardStream(
                    shards, ("x", "y", "w"), window_rows,
                    remainder_multiple=data_size
                    if settings.batch_size == 0 else 0)
                run_elastic = ectx
                if ectx is not None and settings.batch_size != 0:
                    log.warning("elastic mode needs full-batch streaming "
                                "(MiniBatchs=0); this run stays "
                                "synchronous")
                    run_elastic = None
                with self.phase("train"):
                    res = train_ensemble_streamed(
                        stream, spec, settings, n_members, mask_fn,
                        init_params_list=self._continuous_init(
                            spec, n_members, alg, settings),
                        progress=self._progress_fn(pf, run),
                        checkpoint=self._checkpoint_fn(spec, alg),
                        member_classes=member_classes, device=self.device,
                        mesh=mesh, elastic=run_elastic)
                results.append((run, spec, res,
                                [run_params] if is_gs else run_params))
        with self.phase("save_models"):
            self._write_models(results, alg, is_gs)
        log.info("train done in %.1fs (streamed)", time.time() - t0)
        return 0

    def _train_kernel_svm(self, x, y, w, column_nums, feature_names) -> int:
        """Non-linear-kernel SVM bags (reference ``SVMTrainer.java``
        Kernel/Gamma/Const; local-scale by design, see
        ``train/svm_trainer.py``).  Each solved bag commits its model to
        the step's journal, so an interrupted multi-bag run resumes at the
        first unsolved bag."""
        from ..models.svm import SVMModelSpec, save_model
        from ..train.svm_trainer import train_kernel_svm
        mc = self.model_config
        params = dict(mc.train.params or {})
        if grid_search.is_grid_search(params):
            raise ValueError("grid search is not supported for kernel SVM "
                             "(single local-scale solve per bag)")
        n, d = x.shape
        kernel = str(params.get("Kernel", "linear")).lower()
        kernel = {"radialbasisfunction": "rbf"}.get(kernel, kernel)
        spec = SVMModelSpec(
            input_dim=d, kernel=kernel,
            gamma=float(params.get("Gamma", 1.0 / max(d, 1))),
            coef0=float(params.get("Coef0", 0.0)),
            degree=int(params.get("Degree", 3)),
            column_nums=column_nums, feature_names=feature_names,
            extra={"algorithm": "SVM"})
        c_penalty = float(params.get("Const", 1.0))
        bags = max(1, mc.train.baggingNum)
        os.makedirs(self.paths.models_dir, exist_ok=True)
        items = self.journal.arm({"alg": "SVM", "kernel": spec.kernel,
                                  "const": c_penalty, "bags": bags},
                                 resume=bool(self.params.get("resume")))
        with open(self.paths.progress_path, "a" if items else "w") as pf:
            for b in range(bags):
                path = os.path.join(self.paths.models_dir, f"model{b}.svm")
                if items.get(f"bag-{b}"):
                    log.info("svm bag %d: already solved, skipping", b)
                    continue
                faults.fire("train", "bag", b, path=path)
                tw, _ = member_masks(
                    n, 1, valid_rate=mc.train.validSetRate,
                    sample_rate=mc.train.baggingSampleRate,
                    replacement=mc.train.baggingWithReplacement,
                    targets=y, seed=b)
                train_mask = (tw[0] > 0) & (w > 0)
                with self.phase("train"):
                    sv_x, alpha_y, tr, va, n_sv = train_kernel_svm(
                        x, y, train_mask, spec, c_penalty,
                        device=self.device)
                save_model(path, spec, sv_x, alpha_y)
                self.journal.commit_item(f"bag-{b}", files=[path],
                                         valid_err=float(va))
                pf.write(f"Trainer #{b} Train Error: {tr:.6f} "
                         f"Validation Error: {va:.6f} ({n_sv} SVs)\n")
                log.info("svm bag %d: %d SVs -> %s", b, n_sv, path)
        return 0

    def _make_spec(self, alg: Algorithm, d: int, run_params: Dict[str, Any],
                   column_nums, feature_names) -> nn_model.NNModelSpec:
        if alg == Algorithm.SVM:
            return svm_spec(d, run_params, column_nums, feature_names)
        if alg == Algorithm.LR:
            return lr_spec(d, run_params, column_nums, feature_names)
        return nn_spec_from_params(d, run_params, column_nums,
                                   feature_names)

    def _progress_fn(self, pf, run):
        def progress(epoch, tr, va):
            line = (f"Trial {run} Epoch #{epoch + 1} "
                    f"Train Error: {tr:.6f} Validation Error: {va:.6f}")
            pf.write(line + "\n")
            pf.flush()
            faults.fire("train", "epoch", epoch + 1)
            log.info(line)
        return progress

    def _checkpoint_fn(self, spec, alg: Algorithm):
        def checkpoint(epoch, params_list):
            for i, p in enumerate(params_list):
                nn_model.save_model(
                    self.paths.tmp_model_path(i, epoch + 1,
                                              alg.name.lower()), spec, p)
        return checkpoint

    def _continuous_init(self, spec, n_members: int, alg: Algorithm,
                         settings=None):
        """Continuous training: warm-start members from the final models
        on disk; a GROWN configuration fits the saved net into the larger
        structure (reference ``NNMaster.java:331-362,605-645``)."""
        if not self.model_config.train.isContinuous:
            return None
        seed = settings.seed if settings else 0
        initializer = settings.weight_initializer if settings else "xavier"
        init, grown = [], 0
        for i in range(n_members):
            path = self.paths.model_path(i, alg.name.lower())
            if not os.path.isfile(path):
                return None
            old_spec, params = nn_model.load_model(path)
            if old_spec.layer_dims() != spec.layer_dims():
                params = nn_model.fit_params_into(
                    old_spec, params, spec,
                    prng.fold_in(prng.prng_key(seed), i), initializer)
                if params is None:
                    log.warning("continuous: model%d does not embed in the "
                                "new structure, fresh init", i)
                    return None
                grown += 1
            init.append(params)
        log.info("continuous training: warm-started %d members%s",
                 n_members,
                 f" ({grown} grown via structure fit-in)" if grown else "")
        return init

    def _write_models(self, results, alg: Algorithm, is_gs: bool) -> None:
        ext = alg.name.lower()
        os.makedirs(self.paths.models_dir, exist_ok=True)
        # stale models of other runs never mix into eval's glob
        for f in os.listdir(self.paths.models_dir):
            if f.startswith("model"):
                os.remove(os.path.join(self.paths.models_dir, f))
        if is_gs:
            # grid search: the best trial by validation error is model0
            flat = {}
            for run, spec, res, run_params in results:
                for j, trial_idx in enumerate(run):
                    flat[trial_idx] = (res.valid_errors[j], spec,
                                       res.params[j], run_params[j])
            idxs = sorted(flat)
            order = grid_search.rank_and_report(
                self.paths.tmp_dir, [flat[i][0] for i in idxs],
                [flat[i][3] for i in idxs])
            best = idxs[order[0]]
            err, spec, p, tp = flat[best]
            log.info("grid search: best trial #%d valid error %.6f "
                     "params %s", best, err, tp)
            nn_model.save_model(self.paths.model_path(0, ext),
                                _scoring_spec(spec), p)
            return
        run, spec, res, _ = results[0]
        ova_k = (spec.extra or {}).get("ova_classes")
        for i, p in enumerate(res.params):
            sp = spec
            if ova_k:
                # member b*K+k scores class k
                sp = dataclasses.replace(
                    spec, extra={**spec.extra, "class_index": i % ova_k})
            nn_model.save_model(self.paths.model_path(i, ext),
                                _scoring_spec(sp), p)
        log.info("saved %d model(s); valid errors %s", len(res.params),
                 np.round(res.valid_errors, 6).tolist())

    def _open_shards(self, directory: str) -> Shards:
        """The step's view of the materialized plane.  The refresh loop
        passes ``window_cursor`` (rows earlier trainings consumed), so a
        warm retrain reads only the new data windows, shard-aligned
        (:meth:`Shards.from_row`)."""
        shards = Shards.open(directory)
        cur = int(self.params.get("window_cursor") or 0)
        if cur:
            view = shards.from_row(cur)
            log.info("data-window cursor %d: training on %d of %d rows "
                     "(%d of %d shards)", cur, view.num_rows,
                     shards.num_rows, view.n_shards, shards.n_shards)
            return view
        return shards

    def _use_streaming(self, shards: Shards, schema: dict) -> bool:
        from ..data.streaming import should_stream
        return should_stream(shards, schema)
