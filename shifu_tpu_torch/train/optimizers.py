"""Weight-update rules — the port of ``shifu_tpu.train.optimizers``
(reference ``core/dtrain/Weight.java``), over PyTorch tensors.

The reference exposes two families (``Weight.java:39,48-56``):

- propagation algorithms: ``B`` backprop+momentum, ``Q`` quickprop,
  ``R`` resilient RPROP, ``M`` manhattan;
- update rules: ``ADAM | MOMENTUM | RMSPROP | ADAGRAD | NESTEROV``
  (``nn/update/*.java``).

Each rule is an ``(init, update)`` pair over a param tree (lists and dicts
of tensors), elementwise, so the same rule steps one model or an
ensemble stacked on a leading member axis: ADAM's step counter is then a
``[B]`` tensor (``init(params, members=B)``), as the reference's vmapped
state is.  ``update`` returns a delta to ADD to params; state trees keep
the reference's keys, which fix the checkpoint's leaf order.  L1/L2
regularization is applied in the loss, not here.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch


class Optimizer(NamedTuple):
    init: Callable[..., Any]                            # (params, members)
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)


def tree_map(f, *trees):
    """Map ``f`` over the tensor leaves of matching trees (lists, tuples
    and dicts)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(f, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        out = [tree_map(f, *xs) for xs in zip(*trees)]
        return out if isinstance(t0, list) else tuple(out)
    return f(*trees)


def _first_leaf(tree) -> torch.Tensor:
    if isinstance(tree, dict):
        return _first_leaf(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _first_leaf(tree[0])
    return tree


def _zeros_like(params):
    return tree_map(torch.zeros_like, params)


def per_member(v, like: torch.Tensor):
    """A ``[B]`` per-member tensor shaped to broadcast over a stacked
    leaf ``like`` (``[B, ...]``); numbers and scalars pass through."""
    if isinstance(v, torch.Tensor) and v.dim() == 1 and like.dim() > 1:
        return v.reshape(v.shape + (1,) * (like.dim() - 1))
    return v


# ------------------------------------------------------------ update rules
def sgd(learning_rate: float) -> Optimizer:
    def init(params, members: Optional[int] = None):
        return ()

    def update(grads, state, params):
        return tree_map(lambda g: -learning_rate * g, grads), state

    return Optimizer(init, update)


def momentum(learning_rate: float, beta: float = 0.9,
             nesterov_mode: bool = False) -> Optimizer:
    """MOMENTUM / NESTEROV update rules (``nn/update/MomentumUpdate.java``,
    ``NesterovUpdate.java``)."""
    def init(params, members: Optional[int] = None):
        return {"v": _zeros_like(params)}

    def update(grads, state, params):
        v = tree_map(lambda v_, g: beta * v_ - learning_rate * g,
                     state["v"], grads)
        if nesterov_mode:
            delta = tree_map(lambda v_, g: beta * v_ - learning_rate * g,
                             v, grads)
        else:
            delta = v
        return delta, {"v": v}

    return Optimizer(init, update)


def adagrad(learning_rate: float, eps: float = 1e-8) -> Optimizer:
    def init(params, members: Optional[int] = None):
        return {"g2": _zeros_like(params)}

    def update(grads, state, params):
        g2 = tree_map(lambda a, g: a + g * g, state["g2"], grads)
        delta = tree_map(
            lambda g, a: -learning_rate * g / (torch.sqrt(a) + eps),
            grads, g2)
        return delta, {"g2": g2}

    return Optimizer(init, update)


def rmsprop(learning_rate: float, decay: float = 0.9,
            eps: float = 1e-8) -> Optimizer:
    def init(params, members: Optional[int] = None):
        return {"g2": _zeros_like(params)}

    def update(grads, state, params):
        g2 = tree_map(lambda a, g: decay * a + (1 - decay) * g * g,
                      state["g2"], grads)
        delta = tree_map(
            lambda g, a: -learning_rate * g / (torch.sqrt(a) + eps),
            grads, g2)
        return delta, {"g2": g2}

    return Optimizer(init, update)


def adam(learning_rate: float, beta1: float = 0.9, beta2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params, members: Optional[int] = None):
        t = torch.zeros(() if members is None else (members,),
                        dtype=torch.float32,
                        device=_first_leaf(params).device)
        return {"m": _zeros_like(params), "t": t, "v": _zeros_like(params)}

    def update(grads, state, params):
        t = state["t"] + 1.0
        bc1, bc2 = 1 - beta1 ** t, 1 - beta2 ** t
        m = tree_map(lambda m_, g: beta1 * m_ + (1 - beta1) * g,
                     state["m"], grads)
        v = tree_map(lambda v_, g: beta2 * v_ + (1 - beta2) * g * g,
                     state["v"], grads)
        delta = tree_map(
            lambda m_, v_: -learning_rate * (m_ / per_member(bc1, m_))
            / (torch.sqrt(v_ / per_member(bc2, v_)) + eps), m, v)
        return delta, {"m": m, "t": t, "v": v}

    return Optimizer(init, update)


# ----------------------------------------------- propagation algos (B/Q/R/M)
def backprop(learning_rate: float, momentum_term: float = 0.5) -> Optimizer:
    """``B``: plain backprop + momentum (``Weight.java`` B branch)."""
    return momentum(learning_rate, beta=momentum_term)


def manhattan(learning_rate: float) -> Optimizer:
    """``M``: fixed step in the gradient's sign direction."""
    def init(params, members: Optional[int] = None):
        return ()

    def update(grads, state, params):
        return tree_map(lambda g: -learning_rate * torch.sign(g),
                        grads), state

    return Optimizer(init, update)


def rprop(init_step: float = 0.1, eta_plus: float = 1.2,
          eta_minus: float = 0.5, max_step: float = 50.0,
          min_step: float = 1e-6) -> Optimizer:
    """``R``: resilient propagation — per-weight adaptive step from gradient
    sign agreement; the reference NN default (``Weight.java`` R branch,
    Encog ResilientPropagation constants).  On a sign flip the weight does
    not move and the remembered gradient is zeroed."""
    def init(params, members: Optional[int] = None):
        return {"prev_g": _zeros_like(params),
                "step": tree_map(lambda p: torch.full_like(p, init_step),
                                 params)}

    def update(grads, state, params):
        def one(g, pg, st):
            agree = g * pg
            new_st = torch.where(
                agree > 0, torch.clamp(st * eta_plus, max=max_step),
                torch.where(agree < 0,
                            torch.clamp(st * eta_minus, min=min_step), st))
            flip = agree < 0
            zero = torch.zeros_like(g)
            delta = torch.where(flip, zero, -torch.sign(g) * new_st)
            return delta, new_st, torch.where(flip, zero, g)

        outs = tree_map(one, grads, state["prev_g"], state["step"])
        return _pick(outs, 0), {"prev_g": _pick(outs, 2),
                                "step": _pick(outs, 1)}

    return Optimizer(init, update)


def _pick(tree, i: int):
    """Element ``i`` of every tuple leaf of a tree built by
    :func:`tree_map` from a function returning tuples."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def quickprop(learning_rate: float, mu: float = 1.75,
              eps: float = 1e-10) -> Optimizer:
    """``Q``: quickprop — quadratic step from consecutive gradients
    (``Weight.java`` Q branch), clamped by the maximum-growth factor
    ``mu``."""
    def init(params, members: Optional[int] = None):
        return {"prev_d": _zeros_like(params), "prev_g": _zeros_like(params)}

    def update(grads, state, params):
        def one(g, pg, pd):
            tiny = torch.where(pg == g, torch.full_like(g, eps),
                               torch.zeros_like(g))
            quick = g / (pg - g + tiny) * pd
            bound = mu * torch.abs(pd)
            quick = torch.minimum(torch.maximum(quick, -bound - eps),
                                  bound + eps)
            grad_step = -learning_rate * g
            return torch.where(pd == 0.0, grad_step, quick + grad_step)

        delta = tree_map(one, grads, state["prev_g"], state["prev_d"])
        return delta, {"prev_d": delta, "prev_g": grads}

    return Optimizer(init, update)


# ------------------------------------------------------ precision ladder
# the shifu.train.precision ladder: "f32" keeps the math untouched; "bf16"
# trains entirely in bfloat16 (params, activations, optimizer state);
# "mixed" keeps an f32 MASTER copy of the params in the optimizer state,
# runs forward/backward on its bf16 cast, widens the gradients and steps
# the master — one bf16 rounding per step.
PRECISIONS = ("f32", "bf16", "mixed")


def resolve_precision(setting: str = "") -> str:
    """The effective training precision: an explicit trainer setting
    wins, else the ``shifu.train.precision`` property, default ``f32``.
    Unknown values fail loudly."""
    if not setting:
        from ..config import environment
        setting = environment.get_property("shifu.train.precision", "f32")
    key = str(setting).lower()
    if key not in PRECISIONS:
        raise ValueError(f"unknown shifu.train.precision {setting!r}; "
                         f"one of {PRECISIONS}")
    return key


def compute_dtype(precision: str) -> torch.dtype:
    """Param/activation dtype of the forward/backward pass."""
    return torch.float32 if precision == "f32" else torch.bfloat16


def cast_tree(tree, dtype: torch.dtype):
    """Cast every floating leaf of a tree; integer leaves pass."""
    return tree_map(lambda l: l.to(dtype) if l.is_floating_point() else l,
                    tree)


def mixed_init(opt: Optimizer, params_bf16, members: Optional[int] = None):
    """Mixed-precision optimizer state: the f32 master (exactly equal to
    the bf16 params) plus the wrapped rule's own state over the master."""
    master = cast_tree(params_bf16, torch.float32)
    return {"inner": opt.init(master, members), "master": master}


def mixed_apply(opt: Optimizer, grads, state, scale=1.0, freeze=None):
    """One mixed-precision update: bf16 grads widen to f32, the inner
    rule steps the f32 master (``freeze`` optionally zeroes fixed-layer
    deltas, ``scale`` is the trainer's lr decay/per-member factor, a
    number or ``[B]``), and the new bf16 training params are ONE rounding
    of the new master.  Returns ``(params_bf16, state)``."""
    g32 = cast_tree(grads, torch.float32)
    delta, inner = opt.update(g32, state["inner"], state["master"])
    if freeze is not None:
        delta = freeze(delta)
    master = tree_map(lambda m, d: m + d * per_member(scale, d),
                      state["master"], delta)
    return cast_tree(master, torch.bfloat16), \
        {"inner": inner, "master": master}


# ----------------------------------------------------------------- factory
_RULES = {
    "ADAM": lambda lr, kw: adam(lr, **kw),
    "MOMENTUM": lambda lr, kw: momentum(lr, **kw),
    "NESTEROV": lambda lr, kw: momentum(lr, nesterov_mode=True, **kw),
    "RMSPROP": lambda lr, kw: rmsprop(lr, **kw),
    "ADAGRAD": lambda lr, kw: adagrad(lr, **kw),
    "SGD": lambda lr, kw: sgd(lr),
    # propagation letters (reference train#params "Propagation")
    "B": lambda lr, kw: backprop(lr, **kw),
    "M": lambda lr, kw: manhattan(lr),
    "R": lambda lr, kw: rprop(**kw),
    "Q": lambda lr, kw: quickprop(lr, **kw),
}


def make_optimizer(name: str, learning_rate: float = 0.1,
                   **kwargs) -> Optimizer:
    key = (name or "R").upper()
    if key not in _RULES:
        raise ValueError(f"unknown optimizer/propagation {name!r}; "
                         f"one of {sorted(_RULES)}")
    return _RULES[key](learning_rate, kwargs)
