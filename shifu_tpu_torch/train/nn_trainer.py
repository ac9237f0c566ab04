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
``ensemble``) has no counterpart: one card holds the plane, so a
``MiniBatchs`` value is used as given (the reference rounds it down to a
multiple of its data-axis size).  ``Precision`` (the reference's
``jax.default_matmul_precision``) applies on the card only: ``bfloat16``
multiplies bf16 inputs (f32 accumulation), ``tensorfloat32`` allows TF32,
anything else keeps true f32; the CPU ignores it, as XLA:CPU does.

Not ported here: the streamed trainer (ROADMAP Queue 1 item 8) and the
obs hooks (item 13).
"""

from __future__ import annotations

import contextlib
import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models import nn as nn_model
from ..ops import prng
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


def _restore_tracking(state, best_valid, best_train, stops,
                      device: torch.device):
    """Put a restored 8-tuple's tracking back: the best errors (host, in
    place), the windows' state, and the best params and best validation
    errors on the device (returned)."""
    best_valid[:], best_train[:] = state[3], state[4]
    for s, b, k in zip(stops, state[6], state[7]):
        s.best, s.since_best = float(b), int(k)
    return (tree_map(lambda t: t.to(device), state[5]),
            torch.from_numpy(best_valid.astype(np.float32)).to(device))


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
                   device=None) -> EnsembleResult:
    """Train ``B`` members on ``device`` (default CUDA); ``train_w`` /
    ``valid_w`` are ``[B, N]`` per-row weights (bag/fold masks x data
    weights).  ``y_members`` ([B, N]) gives each member its own target;
    ``member_hypers`` gives each its own ``lr_scale``/``l2``/``l1``/
    ``dropout`` ([B] arrays)."""
    dev = resolve_device(device)
    mm_dtype, tf32 = matmul_mode(settings.matmul_precision, dev)
    with _allow_tf32(tf32) if dev.type == "cuda" else \
            contextlib.nullcontext():
        return _train(x, y, train_w, valid_w, spec, settings,
                      init_params_list, progress, checkpoint, y_members,
                      member_hypers, dev, mm_dtype)


def _train(x, y, train_w, valid_w, spec, settings, init_params_list,
           progress, checkpoint, y_members, member_hypers,
           dev: torch.device, mm_dtype) -> EnsembleResult:
    bags = train_w.shape[0]
    key = prng.prng_key(settings.seed)
    if init_params_list is None:
        init_params_list = [
            nn_model.init_params(k, spec, settings.weight_initializer)
            for k in prng.split(key, bags)]
    init_list = [_as_params(p) for p in init_params_list]
    opt = make_optimizer(settings.optimizer, settings.learning_rate,
                         **settings.opt_kwargs)
    # ---- precision ladder: bf16/mixed train narrow params; mixed keeps
    # the f32 master in the optimizer state
    precision = resolve_precision(settings.precision)
    if precision != "f32":
        init_list = [cast_tree(p, torch.bfloat16) for p in init_list]
    stacked = nn_model.stack_params(init_list, dev)
    opt_state = mixed_init(opt, stacked, bags) if precision == "mixed" \
        else opt.init(stacked, bags)

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
    xd = _upload(x, dev)
    twd, vwd = _upload(train_w, dev), _upload(valid_w, dev)
    # targets as [N, 1] shared, or [B, N, 1] per member
    yd = _upload(y if y_members is None else y_members, dev).unsqueeze(-1)

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

    def step(stacked, opt_state, xb, yb, twb, rngs, lr_scale):
        params = [{k: v.detach().requires_grad_(True)
                   for k, v in layer.items()} for layer in stacked]
        leaves = [layer[k] for layer in params for k in ("b", "w")]
        with torch.enable_grad():
            loss = nn_model.weighted_loss(
                params, spec, xb, yb, twb, l2=l2, l1=l1, dropout_rate=rate,
                rng=rngs if dropout > 0 else None, matmul_dtype=mm_dtype)
            flat = torch.autograd.grad(loss.sum(), leaves)
        grads = [{"b": flat[2 * i], "w": flat[2 * i + 1]}
                 for i in range(len(params))]
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

        def err(mw):
            return (per_row * mw).sum(dim=-1) / torch.clamp(
                mw.sum(dim=-1), min=1e-9)
        return torch.stack([err(twd), err(vwd)])

    stops = [WindowEarlyStop(settings.early_stop_window)
             for _ in range(bags)]
    best_valid = np.full(bags, np.inf)
    best_train = np.full(bags, np.inf)
    # the best epoch's params and validation error, tracked on the device
    best_dev = tree_map(torch.clone, stacked)
    best_va_dev = torch.full((bags,), float("inf"), device=dev)
    history: List[Tuple[float, float]] = []
    lr_scale = 1.0
    epochs_run = 0
    tr = va = np.zeros(bags)

    start_epoch = 0
    epochs_target = settings.epochs
    if settings.resume and settings.checkpoint_dir:
        from . import checkpoint as ckpt
        restored = ckpt.restore_state(
            settings.checkpoint_dir,
            _ckpt_template(stacked, opt_state, bags),
            expect_precision=precision)
        if restored is not None:
            start_epoch, state = restored
            to_dev = lambda t: t.to(dev)       # noqa: E731
            stacked = tree_map(to_dev, state[0])
            opt_state = tree_map(to_dev, state[1])
            key = (int(state[2][0]), int(state[2][1]))
            best_dev, best_va_dev = _restore_tracking(
                state, best_valid, best_train, stops, dev)
            lr_scale = (1.0 - settings.learning_decay) ** start_epoch \
                if settings.learning_decay > 0 else 1.0
            epochs_target = _resume_epoch_target(settings, start_epoch,
                                                 stops)
            log.info("resumed trainer state at epoch %d (target %d)",
                     start_epoch, epochs_target)
            if settings.early_stop_window > 0 and \
                    all(s.since_best >= s.window_size for s in stops):
                start_epoch = epochs_target    # it had already stopped

    for epoch in range(start_epoch, epochs_target):
        key, sub = prng.split(key)
        rngs = prng.split(sub, bags)
        if bs and bs < n_padded:
            for bi in range((n_padded - bs) // bs + 1):
                rngs_b = [prng.fold_in(r, bi) for r in rngs] \
                    if dropout > 0 else rngs
                s = bi * bs
                yb = yd[s:s + bs] if y_members is None \
                    else yd[:, s:s + bs]
                stacked, opt_state = step(stacked, opt_state,
                                          xd[s:s + bs], yb,
                                          twd[:, s:s + bs], rngs_b,
                                          lr_scale)
        else:
            stacked, opt_state = step(stacked, opt_state, xd, yd, twd,
                                      rngs, lr_scale)
        with torch.no_grad():
            errs = eval_errors(stacked)
            improved = errs[1] < best_va_dev
            best_va_dev = torch.where(improved, errs[1], best_va_dev)
            best_dev = tree_map(
                lambda b, p: torch.where(per_member(improved, p), p, b),
                best_dev, stacked)
        tr, va = errs.cpu().numpy()                    # the one fetch
        history.append((float(tr.mean()), float(va.mean())))
        epochs_run = epoch + 1
        imp = np.flatnonzero(va < best_valid)
        best_valid[imp], best_train[imp] = va[imp], tr[imp]
        if progress:
            progress(epoch, float(tr.mean()), float(va.mean()))
        if checkpoint and settings.tmp_model_every and \
                (epoch + 1) % settings.tmp_model_every == 0:
            checkpoint(epoch, [nn_model.member_params(stacked, i)
                               for i in range(bags)])
        if settings.learning_decay > 0:
            lr_scale *= (1.0 - settings.learning_decay)
        stop_now = False
        if settings.early_stop_window > 0:
            # every member's window advances; stop when all agree
            flags = [s.should_stop(float(v)) for s, v in zip(stops, va)]
            stop_now = all(flags)
        if settings.checkpoint_dir and settings.checkpoint_every and \
                ((epoch + 1) % settings.checkpoint_every == 0 or stop_now):
            # saved AFTER the windows advanced (and forced on the stop
            # epoch): a resumed run replays the exact stop state
            from . import checkpoint as ckpt
            ckpt.save_state(settings.checkpoint_dir, epoch + 1,
                            _ckpt_state(stacked, opt_state, key,
                                        best_valid, best_train, best_dev,
                                        stops),
                            precision=precision)
        if stop_now:
            log.info("early stop at epoch %d (window %d)", epoch,
                     settings.early_stop_window)
            break

    params = []
    for i in range(bags):
        if np.isfinite(best_valid[i]):
            params.append(nn_model.member_params(best_dev, i))
        else:
            params.append(nn_model.member_params(stacked, i))
            best_valid[i], best_train[i] = float(va[i]), float(tr[i])
    return EnsembleResult(params=params, train_errors=best_train,
                          valid_errors=best_valid, epochs_run=epochs_run,
                          history=history)
