"""NN/LR ensemble trainer — the port of ``shifu_tpu.train.nn_trainer``'s
resident trainer (``train_ensemble``; reference Guagua BSP loop,
``NNMaster.java:207-319``, ``AbstractNNWorker.java:521-588``, and the
bagging/k-fold/grid job fan-out of ``TrainModelProcessor.java:684-945``).

The whole plane lives on one device.  Ensemble members (bags, folds,
one-vs-all classes, same-shape grid trials) stack on a leading axis, as
the reference stacks them under ``vmap``: one forward a layer for all
members (``models.nn.forward``), the members' losses summed so that one
``torch.autograd`` pass gives each member its own gradient, and the update
rule applied elementwise over the stacked tensors.

- The full-batch step (one update an epoch over every row) is the
  default, as in the reference; ``MiniBatchs`` sweeps fixed batches (the
  last padded with zero-weight rows), dropout keys folded in per batch.
- Per-member hypers (``lr_scale``, ``l2``, ``l1``, ``dropout``) let
  same-shape grid trials train as one stacked run; ``y_members`` gives
  each member its own target (one-vs-all).
- Each epoch makes ONE host fetch: the ``[2, B]`` train and validation
  errors, which drive the progress lines, learning decay and the window
  early stop.  The best epoch's params are tracked on the device.
- Checkpoints (``train/checkpoint.py``) carry the reference's 8-tuple
  (params, optimizer state, key, best errors, best params, early-stop
  windows), so ``train -resume`` continues a run either package wrote,
  and a resumed run on one device equals an uninterrupted one bit for
  bit (cuBLAS GEMMs and ``torch.sum`` are deterministic for a fixed
  configuration; no atomics enter the step).

The reference's mesh (rows sharded over a ``data`` axis, members over
``ensemble``) is a ``parallel.mesh.Mesh`` of rank processes
(:func:`train_ensemble`'s ``mesh``): each rank takes its block of every
minibatch, so a ``MiniBatchs`` value is used as given on any mesh (the
reference rounds it down to a multiple of its data-axis size).
``Precision`` (the reference's ``jax.default_matmul_precision``) applies on the card only: ``bfloat16``
multiplies bf16 inputs (f32 accumulation), ``tensorfloat32`` allows TF32,
anything else keeps true f32; the CPU ignores it, as XLA:CPU does.

:func:`train_ensemble_streamed` is the out-of-core counterpart (the
reference's ``MemoryDiskFloatMLDataSet.java`` role): the norm plane
streams window by window through a ``ShardStream`` every epoch, each
window crossing to the card on a copy stream
(``dt_trainer._WindowCopier``).
Full batch accumulates each window's unnormalised gradient sums on the
device and steps once an epoch on ``sum(grads) / sum(weights)``; an
epoch's errors are measured one pass late (on the params entering the
next epoch) and a closing eval-only pass ends the ledger.  ``MiniBatchs``
slices each window at edges fixed by the window size.  The reference's
mesh and elastic combine are ROADMAP item 12.  With telemetry on, each
epoch counts ``train.epochs`` and its wall in ``train.epoch_s``.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs, resolve_device
from ..models import nn as nn_model
from ..ops import prng
from ..parallel import mesh as meshlib
from .early_stop import WindowEarlyStop
from .optimizers import (cast_tree, make_optimizer, mixed_apply, mixed_init,
                         per_member, resolve_precision, tree_map)

log = logging.getLogger(__name__)


@dataclass
class TrainSettings:
    optimizer: str = "R"               # reference default Propagation=R (RPROP)
    learning_rate: float = 0.1
    learning_decay: float = 0.0        # per-epoch multiplicative decay
    l2: float = 0.0
    l1: float = 0.0
    dropout_rate: float = 0.0
    epochs: int = 100
    batch_size: int = 0                # 0 = full batch (reference semantics)
    early_stop_window: int = 0         # 0 = disabled
    weight_initializer: str = "xavier"
    seed: int = 0
    tmp_model_every: int = 0           # epochs between tmp-model checkpoints
    checkpoint_dir: str = ""           # "" disables trainer-state checkpoints
    checkpoint_every: int = 25
    resume: bool = False               # restore latest trainer state
    resume_extra: int = 0              # train N MORE epochs past a restored
                                       # state (0 = plain resume)
    fixed_layers: Tuple[int, ...] = () # 1-based layer ids frozen during
    fixed_bias: bool = False           # continuous training (FIXED_LAYERS)
    matmul_precision: str = ""         # the card's GEMM precision
    precision: str = ""                # f32 | bf16 | mixed ("" = property)
    opt_kwargs: Dict[str, Any] = field(default_factory=dict)


def _resume_epoch_target(settings: TrainSettings, start_epoch: int,
                         stops) -> int:
    """Epoch budget after a checkpoint restore: ``resume_extra`` > 0 trains
    that many MORE epochs and re-opens the early-stop patience; a plain
    resume keeps the original budget and stop state."""
    if settings.resume_extra <= 0:
        return settings.epochs
    for s in stops:
        s.since_best = 0
    return start_epoch + settings.resume_extra


@dataclass
class EnsembleResult:
    params: List[Any]                  # per-member best params (host)
    train_errors: np.ndarray           # [bags] at best epoch
    valid_errors: np.ndarray           # [bags]
    epochs_run: int
    history: List[Tuple[float, float]]  # per-epoch (mean train, mean valid)


ProgressFn = Callable[[int, float, float], None]

_BF16_NAMES = ("bfloat16", "default", "fastest")
_TF32_NAMES = ("tensorfloat32", "high")
_F32_NAMES = ("float32", "highest")


def matmul_mode(precision: str, device: torch.device
                ) -> Tuple[Optional[torch.dtype], bool]:
    """``Precision`` on ``device``: (the GEMM input dtype, allow TF32).
    The CPU ignores it; on the card ``bfloat16`` narrows the inputs,
    ``tensorfloat32`` allows TF32, ``float32`` (or "") keeps true f32."""
    name = (precision or "").lower()
    if device.type != "cuda" or not name or name in _F32_NAMES:
        return None, False
    if name in _BF16_NAMES:
        return torch.bfloat16, False
    if name in _TF32_NAMES:
        return None, True
    raise ValueError(f"unknown Precision {precision!r}; one of "
                     f"{_BF16_NAMES + _TF32_NAMES + _F32_NAMES}")


@contextlib.contextmanager
def _allow_tf32(on: bool):
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


# -------------------------------------------- trainer-state checkpointing
# The checkpoint carries MORE than (params, opt_state, key): the final
# model is each member's BEST-epoch params, and early stop is a stateful
# window — the reference's 8-tuple, in its leaf order.
def _ckpt_template(stacked, opt_state, bags: int):
    zf = np.zeros(bags, np.float64)
    zi = np.zeros(bags, np.int64)
    return (stacked, opt_state, np.zeros(2, np.uint32), zf, zf.copy(),
            stacked, zf.copy(), zi)


def _host(tree):
    return tree_map(lambda t: t.detach().cpu(), tree)


def _member(stacked, i: int):
    """Member ``i`` of a stacked param tree, as host tensors (an NN's
    layer list, a WDL's dict)."""
    return tree_map(lambda t: t[i].detach().cpu().clone(), stacked)


def _ckpt_state(stacked, opt_state, key, best_valid, best_train, best_dev,
                stops):
    """The 8-tuple on the host; members with no best epoch yet carry
    their current params as the reference's do."""
    host = _host(stacked)
    have = torch.from_numpy(np.isfinite(best_valid))
    best = tree_map(lambda b, p: torch.where(per_member(have, p),
                                             b.detach().cpu(), p),
                    best_dev, host)
    return (host, _host(opt_state), np.asarray(key, np.uint32),
            np.asarray(best_valid, np.float64),
            np.asarray(best_train, np.float64), best,
            np.asarray([s.best for s in stops], np.float64),
            np.asarray([s.since_best for s in stops], np.int64))


def _pad_all(x, y, train_w, valid_w, multiple: int, y_members=None):
    """Zero-weight rows to a multiple of ``multiple`` (the minibatch)."""
    extra = (-x.shape[0]) % multiple
    if extra:
        x = np.concatenate([x, np.zeros((extra, x.shape[1]), x.dtype)])
        y = np.concatenate([y, np.zeros(extra, y.dtype)])
        zpad = np.zeros((train_w.shape[0], extra), train_w.dtype)
        train_w = np.concatenate([train_w, zpad], axis=1)
        valid_w = np.concatenate([valid_w, zpad], axis=1)
        if y_members is not None:
            y_members = np.concatenate(
                [y_members, np.zeros((y_members.shape[0], extra),
                                     y_members.dtype)], axis=1)
    return x, y, train_w, valid_w, y_members


def _as_params(p) -> nn_model.Params:
    """Init params from any source (this package, numpy, the reference's
    arrays) as float32 host tensors."""
    if p and isinstance(p[0]["w"], torch.Tensor):
        return [{k: layer[k].detach().cpu() for k in ("b", "w")}
                for layer in p]
    return nn_model.params_from_jax(p)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _init_stack(spec, settings: TrainSettings, bags: int,
                init_params_list, dev: torch.device):
    """(key, optimizer, precision, stacked params, optimizer state): the
    members' initial params on ``dev``, narrowed by the precision ladder
    (bf16/mixed train narrow params; mixed keeps the f32 master in the
    optimizer state)."""
    key = prng.prng_key(settings.seed)
    if init_params_list is None:
        init_params_list = [
            nn_model.init_params(k, spec, settings.weight_initializer)
            for k in prng.split(key, bags)]
    init_list = [_as_params(p) for p in init_params_list]
    opt = make_optimizer(settings.optimizer, settings.learning_rate,
                         **settings.opt_kwargs)
    precision = resolve_precision(settings.precision)
    if precision != "f32":
        init_list = [cast_tree(p, torch.bfloat16) for p in init_list]
    stacked = nn_model.stack_params(init_list, dev)
    opt_state = mixed_init(opt, stacked, bags) if precision == "mixed" \
        else opt.init(stacked, bags)
    return key, opt, precision, stacked, opt_state


class _EpochLedger:
    """The epoch-end bookkeeping the NN and WDL trainers share: the errors
    history, each member's best epoch (errors on the host, params on the
    device), the early-stop windows, the learning-rate decay, the
    tmp-model and trainer-checkpoint saves, and the final choice of
    params."""

    trainer = "nn"                  # the telemetry events' trainer

    def __init__(self, settings: TrainSettings, stacked, bags: int,
                 precision: str, progress, checkpoint, dev: torch.device):
        self.settings, self.precision, self.bags = settings, precision, bags
        self.progress, self.checkpoint, self.dev = progress, checkpoint, dev
        self.stops = [WindowEarlyStop(settings.early_stop_window)
                      for _ in range(bags)]
        self.best_valid = np.full(bags, np.inf)
        self.best_train = np.full(bags, np.inf)
        self.best_dev = tree_map(torch.clone, stacked)
        self.best_va_dev = torch.full((bags,), float("inf"), device=dev)
        self.history: List[Tuple[float, float]] = []
        self.tr = self.va = np.zeros(bags)
        self.lr_scale = 1.0

    def resume(self, stacked, opt_state):
        """The latest trainer checkpoint, restored: None, or (start epoch,
        epoch target, stacked, optimizer state, key); the best epochs, the
        early-stop windows and the lr scale are restored into the
        ledger."""
        from . import checkpoint as ckpt
        s = self.settings
        restored = ckpt.restore_state(
            s.checkpoint_dir, _ckpt_template(stacked, opt_state, self.bags),
            expect_precision=self.precision)
        if restored is None:
            return None
        start_epoch, state = restored
        to_dev = lambda t: t.to(self.dev)       # noqa: E731
        self.best_valid[:], self.best_train[:] = state[3], state[4]
        for w, b, k in zip(self.stops, state[6], state[7]):
            w.best, w.since_best = float(b), int(k)
        self.best_dev = tree_map(to_dev, state[5])
        self.best_va_dev = to_dev(
            torch.from_numpy(self.best_valid.astype(np.float32)))
        self.lr_scale = (1.0 - s.learning_decay) ** start_epoch \
            if s.learning_decay > 0 else 1.0
        epochs_target = _resume_epoch_target(s, start_epoch, self.stops)
        log.info("resumed trainer state at epoch %d (target %d)",
                 start_epoch, epochs_target)
        if s.early_stop_window > 0 and \
                all(w.since_best >= w.window_size for w in self.stops):
            start_epoch = epochs_target    # it had already stopped
        return (start_epoch, epochs_target, tree_map(to_dev, state[0]),
                tree_map(to_dev, state[1]),
                (int(state[2][0]), int(state[2][1])))

    def record(self, epoch: int, tr: np.ndarray, va: np.ndarray,
               params, va_dev: Optional[torch.Tensor] = None) -> bool:
        """Record ``epoch``'s errors, measured on ``params``; True when
        every member's early-stop window fired (every window advances).
        ``va_dev``, the same validation errors still on the device, picks
        the best params there with no host-to-device copy (the resident
        epoch makes one host sync); without it the host's choice is
        copied over."""
        self.tr, self.va = tr, va
        self.history.append((float(tr.mean()), float(va.mean())))
        now = time.perf_counter()
        obs.counter("train.epochs").inc()
        obs.histogram("train.epoch_s").observe(
            now - getattr(self, "_epoch_t0", now))
        self._epoch_t0 = now
        obs.gauge("train.valid_err").set(float(va.mean()))
        obs.event("epoch", trainer=self.trainer, epoch=epoch,
                  train_err=round(float(tr.mean()), 6),
                  valid_err=round(float(va.mean()), 6))
        improved = va < self.best_valid
        imp = None
        if va_dev is not None:
            imp = va_dev < self.best_va_dev
            self.best_va_dev = torch.where(imp, va_dev, self.best_va_dev)
        elif improved.any():
            imp = torch.from_numpy(improved).to(self.dev)
        if imp is not None:
            self.best_dev = tree_map(
                lambda b, p: torch.where(per_member(imp, p), p, b),
                self.best_dev, params)
        self.best_valid[improved] = va[improved]
        self.best_train[improved] = tr[improved]
        if self.progress:
            self.progress(epoch, float(tr.mean()), float(va.mean()))
        if self.settings.early_stop_window > 0:
            return all([w.should_stop(float(v))
                        for w, v in zip(self.stops, va)])
        return False

    def end_epoch(self, epoch: int, stacked, opt_state, key,
                  stopped: bool):
        """After ``epoch``'s update: the tmp models, the trainer checkpoint
        (saved after the windows advanced, and forced on the stop epoch,
        so a resumed run replays the exact stop state), the lr decay."""
        s = self.settings
        if self.checkpoint and s.tmp_model_every and \
                (epoch + 1) % s.tmp_model_every == 0:
            self.checkpoint(epoch, [_member(stacked, i)
                                    for i in range(self.bags)])
        if s.checkpoint_dir and s.checkpoint_every and \
                ((epoch + 1) % s.checkpoint_every == 0 or stopped):
            from . import checkpoint as ckpt
            ckpt.save_state(s.checkpoint_dir, epoch + 1,
                            _ckpt_state(stacked, opt_state, key,
                                        self.best_valid, self.best_train,
                                        self.best_dev, self.stops),
                            precision=self.precision)
        if s.learning_decay > 0:
            self.lr_scale *= (1.0 - s.learning_decay)

    def result(self, stacked, epochs_run: int) -> EnsembleResult:
        """Each member's best-epoch params, or its last where no epoch
        recorded a finite validation error."""
        params = []
        for i in range(self.bags):
            if np.isfinite(self.best_valid[i]):
                params.append(_member(self.best_dev, i))
            else:
                params.append(_member(stacked, i))
                self.best_valid[i] = float(self.va[i])
                self.best_train[i] = float(self.tr[i])
        return EnsembleResult(params=params, train_errors=self.best_train,
                              valid_errors=self.best_valid,
                              epochs_run=epochs_run, history=self.history)


def train_ensemble(x: np.ndarray, y: np.ndarray,
                   train_w: np.ndarray, valid_w: np.ndarray,
                   spec: nn_model.NNModelSpec,
                   settings: TrainSettings,
                   init_params_list: Optional[List[Any]] = None,
                   progress: Optional[ProgressFn] = None,
                   checkpoint: Optional[Callable[[int, List[Any]],
                                                 None]] = None,
                   y_members: Optional[np.ndarray] = None,
                   member_hypers: Optional[Dict[str, np.ndarray]] = None,
                   device=None, mesh=None) -> EnsembleResult:
    """Train ``B`` members on ``device`` (default CUDA); ``train_w`` /
    ``valid_w`` are ``[B, N]`` per-row weights (bag/fold masks x data
    weights).  ``y_members`` ([B, N]) gives each member its own target;
    ``member_hypers`` gives each its own ``lr_scale``/``l2``/``l1``/
    ``dropout`` ([B] arrays).

    ``mesh`` (``parallel.mesh.device_mesh(n_ensemble=B)``; every rank
    passes the whole arrays): the ensemble axis splits the members over
    rank groups, the data axis splits the rows.  A rank computes its
    members' gradients on its rows, the data group all_reduces them
    (SUM; the loss is divided by every rank's weight sum, and the
    regularization enters on one rank) and every rank of it takes the same
    optimizer step; errors are summed over the data group in float64 and
    every member's errors and params gathered over the ensemble group at
    the end of an epoch, so the bookkeeping (best epochs, early stop,
    checkpoints) sees every member.  Float sums in another order: the
    result agrees with one rank's within the reference's tolerance."""
    dev = resolve_device(device)
    mm_dtype, tf32 = matmul_mode(settings.matmul_precision, dev)
    with _allow_tf32(tf32) if dev.type == "cuda" else \
            contextlib.nullcontext():
        return _train(x, y, train_w, valid_w, spec, settings,
                      init_params_list, progress, checkpoint, y_members,
                      member_hypers, dev, mm_dtype, mesh)


def _mesh_rows(mesh, n: int, bs: int) -> np.ndarray:
    """This rank's rows of the (padded) plane: its block of every
    minibatch of ``bs`` rows (or of all ``n`` rows in full batch), in
    order, so its local minibatch i is rows [i * lb, (i + 1) * lb)."""
    if not bs or bs >= n:
        r0, r1 = mesh.row_block(n)
        return np.arange(r0, r1)
    b0, b1 = mesh.row_block(bs)
    return (np.arange(0, n, bs)[:, None] + np.arange(b0, b1)[None, :]) \
        .reshape(-1)


def _flat_all_reduce(mesh, grads):
    """The gradient tree summed over the data group in one f32
    all_reduce (bf16 gradients round back after the sum)."""
    leaves = []
    tree_map(leaves.append, grads)
    flat = meshlib.all_reduce(mesh, torch.cat([g.float().reshape(-1)
                                               for g in leaves]))
    parts = iter(flat.split([g.numel() for g in leaves]))
    return tree_map(lambda g: next(parts).view_as(g).to(g.dtype), grads)


def _train(x, y, train_w, valid_w, spec, settings, init_params_list,
           progress, checkpoint, y_members, member_hypers,
           dev: torch.device, mm_dtype, mesh=None) -> EnsembleResult:
    bags = train_w.shape[0]
    key, opt, precision, stacked, opt_state = _init_stack(
        spec, settings, bags, init_params_list, dev)
    sharded = meshlib.data_sharded(mesh)
    ens = mesh is not None and mesh.n_ensemble > 1
    m0, m1 = mesh.member_block(bags) if ens else (0, bags)

    # per-member hyper rows [B, 4]: lr_scale, l2, l1, dropout
    if member_hypers is None:
        hyp = np.tile(np.asarray(
            [[1.0, settings.l2, settings.l1, settings.dropout_rate]],
            np.float32), (bags, 1))
    else:
        hyp = np.stack([
            np.asarray(member_hypers.get("lr_scale", np.ones(bags)),
                       np.float32),
            np.asarray(member_hypers.get("l2", np.full(bags, settings.l2)),
                       np.float32),
            np.asarray(member_hypers.get("l1", np.full(bags, settings.l1)),
                       np.float32),
            np.asarray(member_hypers.get(
                "dropout", np.full(bags, settings.dropout_rate)),
                np.float32)], axis=1)
    dropout = float(hyp[:, 3].max())           # does any member drop?
    uniform = member_hypers is None
    hd = torch.from_numpy(hyp).to(dev)
    l2 = settings.l2 if uniform else hd[:, 1]
    l1 = settings.l1 if uniform else hd[:, 2]
    rate = settings.dropout_rate if uniform else hd[:, 3]

    bs = settings.batch_size
    if bs:
        x, y, train_w, valid_w, y_members = _pad_all(
            x, y, train_w, valid_w, bs, y_members)
    n_padded = x.shape[0]
    mb = bool(bs and bs < n_padded)
    row0 = 0                 # a rank's first row of each (mini)batch
    if sharded:
        rows = _mesh_rows(mesh, n_padded, bs if mb else 0)
        row0 = mesh.row_block(bs if mb else n_padded)[0]
        x, y = x[rows], y[rows]
        train_w, valid_w = train_w[:, rows], valid_w[:, rows]
        if y_members is not None:
            y_members = y_members[:, rows]
    if ens:
        train_w, valid_w = train_w[m0:m1], valid_w[m0:m1]
        if y_members is not None:
            y_members = y_members[m0:m1]
        hd, full_stacked = hd[m0:m1], stacked
        stacked = tree_map(lambda t: t[m0:m1].clone(), stacked)
        opt_state = tree_map(lambda t: t[m0:m1].clone(), opt_state)
        if not uniform:
            l2, l1, rate = hd[:, 1], hd[:, 2], hd[:, 3]
    lb = len(x) // max(1, n_padded // bs) if mb else len(x)  # local batch
    xd = _upload(x, dev)
    twd, vwd = _upload(train_w, dev), _upload(valid_w, dev)
    # targets as [N, 1] shared, or [B, N, 1] per member
    yd = _upload(y if y_members is None else y_members, dev).unsqueeze(-1)
    if sharded:
        # every rank's weight sums: each batch's train weight (the loss
        # denominator) and the train and valid totals (the errors')
        nb = max(1, n_padded // bs) if mb else 1
        den = meshlib.all_reduce(mesh, torch.cat([
            twd.double().reshape(twd.shape[0], nb, -1).sum(-1).T,
            twd.double().sum(-1)[None], vwd.double().sum(-1)[None]]))
        batch_den = den[:nb].float().clamp_min(1e-9)
        err_den = den[nb:].clamp_min(1e-9)
        reg_here = mesh.coords[1] == 0   # the regularization enters once

    fixed = set(settings.fixed_layers)

    def freeze(delta):
        """Zero the deltas of fixed layers (reference FIXED_LAYERS /
        FIXED_BIAS; 1-based layer ids)."""
        if not fixed:
            return delta
        return [dl if (li + 1) not in fixed else
                {"b": torch.zeros_like(dl["b"]) if settings.fixed_bias
                 else dl["b"], "w": torch.zeros_like(dl["w"])}
                for li, dl in enumerate(delta)]

    def mesh_loss(params, xb, yb, twb, rngs, bi):
        """A rank's share of each member's loss: its rows' weighted loss
        over every rank's weight sum, plus the regularization on one rank,
        so the data group's gradient sum is the whole batch's gradient."""
        pred = nn_model.forward(params, spec, xb, dropout_rate=rate,
                                rng=rngs if dropout > 0 else None,
                                matmul_dtype=mm_dtype, row0=row0)
        per_row = nn_model.per_row_loss(pred, yb, spec)
        loss = (per_row * twb).sum(dim=-1) / batch_den[bi]
        reg = nn_model.regularization(params, l2, l1) if reg_here else None
        return loss if reg is None else loss + reg

    def step(stacked, opt_state, xb, yb, twb, rngs, lr_scale, bi=0):
        params = [{k: v.detach().requires_grad_(True)
                   for k, v in layer.items()} for layer in stacked]
        leaves = [layer[k] for layer in params for k in ("b", "w")]
        with torch.enable_grad():
            if sharded:
                loss = mesh_loss(params, xb, yb, twb, rngs, bi)
            else:
                loss = nn_model.weighted_loss(
                    params, spec, xb, yb, twb, l2=l2, l1=l1,
                    dropout_rate=rate, rng=rngs if dropout > 0 else None,
                    matmul_dtype=mm_dtype)
            flat = torch.autograd.grad(loss.sum(), leaves)
        grads = [{"b": flat[2 * i], "w": flat[2 * i + 1]}
                 for i in range(len(params))]
        if sharded:
            grads = _flat_all_reduce(mesh, grads)
        scale = lr_scale * hd[:, 0]
        if precision == "mixed":
            return mixed_apply(opt, grads, opt_state, scale=scale,
                               freeze=freeze)
        delta, opt_state = opt.update(grads, opt_state, stacked)
        stacked = tree_map(
            lambda p, d: p + (d * per_member(scale, d)).to(p.dtype),
            stacked, freeze(delta))
        return stacked, opt_state

    def eval_errors(stacked) -> torch.Tensor:
        pred = nn_model.forward(stacked, spec, xd, matmul_dtype=mm_dtype)
        per_row = nn_model.per_row_loss(pred, yd, spec)
        if sharded:
            num = meshlib.all_reduce(mesh, torch.stack([
                (per_row * mw).double().sum(dim=-1) for mw in (twd, vwd)]))
            return (num / err_den).float()

        def err(mw):
            return (per_row * mw).sum(dim=-1) / torch.clamp(
                mw.sum(dim=-1), min=1e-9)
        return torch.stack([err(twd), err(vwd)])

    def whole(tree):
        """Every member's tensors of a member-split tree (the ensemble
        group's gather); the tree itself without an ensemble axis."""
        return meshlib.gather_members(mesh, tree) if ens else tree

    ledger = _EpochLedger(settings, full_stacked if ens else stacked, bags,
                          precision, progress, checkpoint, dev)
    epochs_run = start_epoch = 0
    epochs_target = settings.epochs
    restored = ledger.resume(whole(stacked), whole(opt_state)) \
        if settings.resume and settings.checkpoint_dir else None
    if restored is not None:
        start_epoch, epochs_target, stacked, opt_state, key = restored
        if ens:
            stacked = tree_map(lambda t: t[m0:m1].clone(), stacked)
            opt_state = tree_map(lambda t: t[m0:m1].clone(), opt_state)

    for epoch in range(start_epoch, epochs_target):
        key, sub = prng.split(key)
        rngs = prng.split(sub, bags)[m0:m1]
        if mb:
            for bi in range((n_padded - bs) // bs + 1):
                rngs_b = [prng.fold_in(r, bi) for r in rngs] \
                    if dropout > 0 else rngs
                s = bi * lb
                yb = yd[s:s + lb] if y_members is None \
                    else yd[:, s:s + lb]
                stacked, opt_state = step(stacked, opt_state,
                                          xd[s:s + lb], yb,
                                          twd[:, s:s + lb], rngs_b,
                                          ledger.lr_scale, bi)
        else:
            stacked, opt_state = step(stacked, opt_state, xd, yd, twd,
                                      rngs, ledger.lr_scale)
        with torch.no_grad():
            errs = eval_errors(stacked)
            if ens:
                errs = meshlib.all_gather(mesh, errs.T.contiguous(),
                                          axis="ensemble").T
            tr, va = errs.cpu().numpy()                    # the one fetch
            stop_now = ledger.record(epoch, tr, va, whole(stacked),
                                     va_dev=errs[1])
        epochs_run = epoch + 1
        ledger.end_epoch(epoch, whole(stacked), whole(opt_state)
                         if settings.checkpoint_dir else opt_state, key,
                         stop_now)
        if stop_now:
            log.info("early stop at epoch %d (window %d)", epoch,
                     settings.early_stop_window)
            break
    return ledger.result(whole(stacked), epochs_run)


# ------------------------------------------------------------- streaming
def train_ensemble_streamed(stream, spec: nn_model.NNModelSpec,
                            settings: TrainSettings, bags: int, mask_fn,
                            init_params_list: Optional[List[Any]] = None,
                            progress: Optional[ProgressFn] = None,
                            checkpoint: Optional[Callable[[int, List[Any]],
                                                          None]] = None,
                            member_classes: Optional[List[int]] = None,
                            device=None) -> EnsembleResult:
    """Out-of-core ensemble training: one pass over ``stream``'s windows
    an epoch (keys ``x``, ``y``, ``w``); the plane is never resident.

    ``mask_fn(global_row_index, targets) -> (train_w, valid_w)`` gives
    each window's ``[bags, rows]`` sampling masks
    (``data.streaming.mask_fn_from_settings``); they multiply the data
    weights, and padded tail rows get weight zero.  ``member_classes``
    (one-vs-all) binarises ``y == class`` for each member on the device.
    Full batch (``batch_size`` 0) is :func:`train_ensemble`'s math up to
    the order of the sums; a minibatch run updates within each window."""
    dev = resolve_device(device)
    mm_dtype, tf32 = matmul_mode(settings.matmul_precision, dev)
    with _allow_tf32(tf32) if dev.type == "cuda" else \
            contextlib.nullcontext():
        return _train_streamed(stream, spec, settings, bags, mask_fn,
                               init_params_list, progress, checkpoint,
                               member_classes, dev, mm_dtype)


def _train_streamed(stream, spec, settings, bags, mask_fn, init_params_list,
                    progress, checkpoint, member_classes,
                    dev: torch.device, mm_dtype) -> EnsembleResult:
    from ..data.streaming import PreparedWindow
    from .dt_trainer import _WindowCopier

    key, opt, precision, stacked, opt_state = _init_stack(
        spec, settings, bags, init_params_list, dev)
    dropout, l1, l2 = settings.dropout_rate, settings.l1, settings.l2
    cls = None if member_classes is None else torch.tensor(
        member_classes, dtype=torch.float32, device=dev).reshape(-1, 1, 1)
    # mixed accumulates the cross-window gradient sums in f32
    acc_dtype = torch.float32 if precision == "mixed" else None

    def targets(yb: torch.Tensor) -> torch.Tensor:
        """[N, 1] shared, or [B, N, 1] binarised per member (OVA)."""
        y = yb.unsqueeze(-1)
        return y if cls is None else (y.unsqueeze(0) == cls).to(y.dtype)

    def eval_sums(pred, ym, tw, vw) -> torch.Tensor:
        per_row = nn_model.per_row_loss(pred, ym, spec)
        return torch.stack([(per_row * tw).sum(-1), tw.sum(-1),
                            (per_row * vw).sum(-1), vw.sum(-1)], dim=1)

    def grad_eval_window(stacked, win, rngs):
        """The window's unnormalised gradient sums and its [B, 4] error
        sums (without dropout), for the full-batch step."""
        params = [{k: v.detach().requires_grad_(True)
                   for k, v in layer.items()} for layer in stacked]
        leaves = [layer[k] for layer in params for k in ("b", "w")]
        ym, tw, vw = targets(win["y"]), win["tw"], win["vw"]
        with torch.enable_grad():
            pred = nn_model.forward(params, spec, win["x"],
                                    dropout_rate=dropout,
                                    rng=rngs if dropout > 0 else None,
                                    matmul_dtype=mm_dtype)
            per_row = nn_model.per_row_loss(pred, ym, spec)
            flat = torch.autograd.grad((per_row * tw).sum(), leaves)
        with torch.no_grad():
            if dropout > 0:
                pred = nn_model.forward(stacked, spec, win["x"],
                                        matmul_dtype=mm_dtype)
            stats = eval_sums(pred.detach(), ym, tw, vw)
        return [{"b": flat[2 * i], "w": flat[2 * i + 1]}
                for i in range(len(params))], stats

    def eval_window(stacked, win):
        with torch.no_grad():
            pred = nn_model.forward(stacked, spec, win["x"],
                                    matmul_dtype=mm_dtype)
            return eval_sums(pred, targets(win["y"]), win["tw"], win["vw"])

    def step(stacked, opt_state, grads, lr_scale):
        if precision == "mixed":
            return mixed_apply(opt, grads, opt_state, scale=lr_scale)
        delta, opt_state = opt.update(grads, opt_state, stacked)
        return tree_map(lambda p, d: p + (d * lr_scale).to(p.dtype),
                        stacked, delta), opt_state

    def apply_update(stacked, opt_state, grad_acc, wsum, lr_scale):
        inv = 1.0 / torch.clamp(wsum, min=1e-9)
        g = [{"w": gl["w"] * per_member(inv, gl["w"]) + 2.0 * l2 * pl["w"]
              + l1 * torch.sign(pl["w"]),
              "b": gl["b"] * per_member(inv, gl["b"])}
             for gl, pl in zip(grad_acc, stacked)]
        return step(stacked, opt_state, g, lr_scale)

    def minibatch(stacked, opt_state, win, s, e, rngs, lr_scale):
        params = [{k: v.detach().requires_grad_(True)
                   for k, v in layer.items()} for layer in stacked]
        leaves = [layer[k] for layer in params for k in ("b", "w")]
        ym = targets(win["y"][s:e])
        with torch.enable_grad():
            loss = nn_model.weighted_loss(
                params, spec, win["x"][s:e], ym, win["tw"][:, s:e], l2=l2,
                l1=l1, dropout_rate=dropout,
                rng=rngs if dropout > 0 else None, matmul_dtype=mm_dtype)
            flat = torch.autograd.grad(loss.sum(), leaves)
        grads = [{"b": flat[2 * i], "w": flat[2 * i + 1]}
                 for i in range(len(params))]
        return step(stacked, opt_state, grads, lr_scale)

    copier = _WindowCopier(dev)

    def prepare(win):
        """Masks on the host, then one copy a window to the device."""
        y = np.asarray(win.arrays["y"], np.float32)
        tm, vm = mask_fn(win.index, win.arrays["y"])
        wcol = np.asarray(win.arrays["w"], np.float32)
        if win.n_valid < win.rows:                 # zero the padded tail
            wcol = wcol.copy()
            wcol[win.n_valid:] = 0.0
        arrays, sync = copier({"y": y}, extra={
            "x": np.asarray(win.arrays["x"], np.float32),
            "tw": np.asarray(tm * wcol[None, :], np.float32),
            "vw": np.asarray(vm * wcol[None, :], np.float32)})
        return PreparedWindow(win.start, win.n_valid, win.rows, win.index,
                              arrays, on_consume=sync)

    full_batch = settings.batch_size == 0
    W = stream.window_rows
    if not full_batch:
        # each window sliced into ~batch_size minibatches at fixed edges
        n_slices = max(1, W // max(settings.batch_size, 1))
        edges = [i * W // n_slices for i in range(n_slices)] + [W]
        slices = [(s, e) for s, e in zip(edges[:-1], edges[1:]) if e > s]

    ledger = _EpochLedger(settings, stacked, bags, precision, progress,
                          checkpoint, dev)
    ledger.trainer = "nn_streamed"
    start_epoch = 0
    epochs_target = settings.epochs
    restored = ledger.resume(stacked, opt_state) \
        if settings.resume and settings.checkpoint_dir else None
    if restored is not None:
        start_epoch, epochs_target, stacked, opt_state, key = restored

    def bookkeep(epoch_done: int, stats: np.ndarray, snapshot) -> bool:
        """Record the errors of ``epoch_done``, measured on ``snapshot``;
        True when every member's early-stop window fired."""
        return ledger.record(
            epoch_done, stats[:, 0] / np.maximum(stats[:, 1], 1e-9),
            stats[:, 2] / np.maximum(stats[:, 3], 1e-9), snapshot)

    epochs_run = start_epoch
    for epoch in range(start_epoch, epochs_target):
        key, sub = prng.split(key)
        rngs = prng.split(sub, bags)
        entering = stacked         # the params this epoch's stats measure
        stats_acc = torch.zeros((bags, 4), device=dev)
        grad_acc = tree_map(
            lambda a: torch.zeros(a.shape, dtype=acc_dtype or a.dtype,
                                  device=dev), stacked) if full_batch \
            else None
        n_win = 0
        for win in stream.prepared(prepare):
            arrays = win.arrays
            rngs_w = [prng.fold_in(r, n_win) for r in rngs] \
                if dropout > 0 else rngs
            if full_batch:
                grads, stats = grad_eval_window(stacked, arrays, rngs_w)
                grad_acc = tree_map(torch.add, grad_acc, grads)
                stats_acc += stats
            else:
                stats_acc += eval_window(stacked, arrays)
                for si, (s, e) in enumerate(slices):
                    rngs_s = [prng.fold_in(r, si) for r in rngs_w] \
                        if dropout > 0 else rngs_w
                    stacked, opt_state = minibatch(
                        stacked, opt_state, arrays, s, e, rngs_s,
                        ledger.lr_scale)
            n_win += 1
        if n_win == 0:
            raise RuntimeError("streamed training: empty shard stream")
        stats = stats_acc.cpu().numpy().astype(np.float64)  # the one fetch
        # the stats were measured on the params entering this epoch, so
        # they close the PREVIOUS epoch's ledger.  ``epoch > 0`` (not
        # ``> start_epoch``): a resumed epoch closes the last epoch before
        # the restart, which its checkpoint did not record
        stopped = bookkeep(epoch - 1, stats, entering) if epoch > 0 \
            else False
        if full_batch:
            stacked, opt_state = apply_update(
                stacked, opt_state, grad_acc, stats_acc[:, 1],
                ledger.lr_scale)
        epochs_run = epoch + 1
        ledger.end_epoch(epoch, stacked, opt_state, key, stopped)
        if stopped:
            log.info("early stop at epoch %d (window %d, streamed)", epoch,
                     settings.early_stop_window)
            break

    # the closing eval-only pass: the errors of the last params
    stats_acc = torch.zeros((bags, 4), device=dev)
    for win in stream.prepared(prepare):
        stats_acc += eval_window(stacked, win.arrays)
    bookkeep(epochs_run - 1, stats_acc.cpu().numpy().astype(np.float64),
             stacked)
    return ledger.result(stacked, epochs_run)
