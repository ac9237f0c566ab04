"""Genetic wrapper variable selection — the port of
``shifu_tpu.train.dvarsel`` (the reference's ``core/dvarsel/`` stack:
``VarSelMaster``/``VarSelWorker``, ``wrapper/CandidateGenerator``
inherit/crossover/mutation, ``wrapper/ValidationConductor`` per-candidate
NN fitness, ``CandidatePopulation``/``SeedCredit``).

The reference trains a small NN per candidate column subset; here the
whole population trains at once on the NN member axis: the candidates'
weights stack on a leading axis, so every layer is one matrix product for
all of them (``models/nn.py``'s stacked forward, cuBLAS GEMMs on the
card), and a candidate's subset is a 0/1 mask on its first layer's
weights (``x @ (w * m)`` is ``(x * m) @ w``).  Every candidate starts from
the same weights, the port's threefry draw for ``PRNGKey(seed)``
(``ops/prng.py``; Xavier weights bit-equal to the reference's), so fitness
ranks subsets, not initializations.  Gradients come from autograd and the
updates from the port's ADAM (``train/optimizers.py``).

Two data modes share one search loop (:func:`_genetic_search`, the
reference's ``numpy.random.default_rng`` loop as it stands, so the same
fitness gives the same populations): resident (:func:`genetic_varselect`,
the matrix on the device, full-batch epochs) and streamed
(:func:`genetic_varselect_streamed`, one ADAM step a window over the
norm plane's ``ShardStream`` windows, resident in the device cache up to
its budget).  The reference's mesh (candidates over an ensemble axis,
rows over a data axis) is one device here.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs, resolve_device
from ..models import nn as nn_model
from ..ops import prng
from .optimizers import make_optimizer, tree_map

log = logging.getLogger(__name__)


@dataclass
class WrapperSettings:
    """Reference CandidateGenerator params (``CandidateGenerator.java:42-90``
    POPULATION_LIVE_SIZE / POPULATION_MULTIPLY_CNT / HYBRID_PERCENT /
    MUTATION_PERCENT / EXPECT_VARIABLE_CNT)."""
    n_select: int = 10            # columns per candidate seed
    population: int = 16          # live seeds per generation
    generations: int = 5          # multiply count
    hybrid_percent: float = 0.5   # crossover share of the next generation
    mutation_percent: float = 0.2 # mutation share (rest inherits)
    epochs: int = 40              # fitness-model epochs
    learning_rate: float = 0.05
    hidden: int = 8
    valid_rate: float = 0.25
    seed: int = 0

    @classmethod
    def from_params(cls, params: Dict, n_select: int,
                    valid_rate: float) -> "WrapperSettings":
        p = params or {}
        return cls(
            # reference knob for the seed size wins over the filterNum
            # default (CandidateGenerator EXPECT_VARIABLE_CNT)
            n_select=int(p.get("EXPECT_VARIABLE_CNT", n_select)),
            population=int(p.get("POPULATION_LIVE_SIZE", 16)),
            generations=int(p.get("POPULATION_MULTIPLY_CNT", 5)),
            hybrid_percent=float(p.get("HYBRID_PERCENT", 50)) / 100.0,
            mutation_percent=float(p.get("MUTATION_PERCENT", 20)) / 100.0,
            epochs=int(p.get("WrapperEpochs", 40)),
            learning_rate=float(p.get("WrapperLearningRate", 0.05)),
            hidden=int(p.get("WrapperHiddenNodes", 8)),
            valid_rate=valid_rate,
            seed=int(p.get("Seed", 0)))


class _Population:
    """The candidates' fitness nets stacked on the member axis, and the
    ADAM steps and fitness sums over them."""

    def __init__(self, d: int, settings: WrapperSettings,
                 device: torch.device):
        self.spec = nn_model.NNModelSpec(input_dim=d,
                                         hidden_nodes=[settings.hidden],
                                         activations=["tanh"], loss="log")
        self.p0 = [{k: v.to(device) for k, v in layer.items()}
                   for layer in nn_model.init_params(
                       prng.prng_key(settings.seed), self.spec)]
        self.opt = make_optimizer("ADAM", settings.learning_rate)
        self.device = device

    def start(self, n: int):
        """(stacked params, ADAM state) of ``n`` candidates at ``p0``."""
        stacked = [{k: v.expand((n,) + v.shape).clone()
                    for k, v in layer.items()} for layer in self.p0]
        return stacked, self.opt.init(stacked, members=n)

    @staticmethod
    def masked(params, masks: torch.Tensor):
        """First-layer weight mask: ``x @ (w * m) == (x * m) @ w``."""
        return [{"w": params[0]["w"] * masks[:, :, None],
                 "b": params[0]["b"]}] + params[1:]

    def step(self, stacked, opt_state, masks, x, y, tw):
        """One ADAM step of every candidate on rows ``x`` weighted ``tw``."""
        params = [{k: v.detach().requires_grad_(True)
                   for k, v in layer.items()} for layer in stacked]
        leaves = [layer[k] for layer in params for k in ("b", "w")]
        with torch.enable_grad():
            loss = nn_model.weighted_loss(self.masked(params, masks),
                                          self.spec, x, y, tw)
            flat = torch.autograd.grad(loss.sum(), leaves)
        grads = [{"b": flat[2 * i], "w": flat[2 * i + 1]}
                 for i in range(len(params))]
        delta, opt_state = self.opt.update(grads, opt_state, stacked)
        return tree_map(lambda p, dl: p + dl, stacked, delta), opt_state

    def loss_sums(self, stacked, masks, x, y, vw) -> torch.Tensor:
        """[P, 2]: each candidate's weighted loss sum over ``x`` and the
        weight sum."""
        with torch.no_grad():
            pred = nn_model.forward(self.masked(stacked, masks), self.spec,
                                    x)
            per = nn_model.per_row_loss(pred, y, self.spec)
            return torch.stack([(per * vw).sum(dim=-1),
                                vw.sum().expand(per.shape[0])], dim=1)


def make_population_evaluator(x: np.ndarray, y: np.ndarray,
                              tw: np.ndarray, vw: np.ndarray,
                              settings: WrapperSettings, device=None):
    """``evaluate(feat_masks [P, D] bool) -> val-loss [P]``: P masked NNs
    trained full batch for ``settings.epochs`` epochs as one stacked run
    (the reference's ``ValidationConductor.voteVariables`` per-seed
    training loop, all seeds at once), on ``device`` (default CUDA) where
    the rows stay resident across generations."""
    dev = resolve_device(device)
    pop = _Population(x.shape[1], settings, dev)
    xd = torch.from_numpy(np.require(x, np.float32, "CW")).to(dev)
    yd = torch.from_numpy(np.asarray(y, np.float32)).to(dev)[:, None]
    twd = torch.from_numpy(np.asarray(tw, np.float32)).to(dev)
    vwd = torch.from_numpy(np.asarray(vw, np.float32)).to(dev)

    def evaluate(feat_masks: np.ndarray) -> np.ndarray:
        masks = torch.from_numpy(np.asarray(feat_masks, np.float32)).to(dev)
        stacked, opt_state = pop.start(len(feat_masks))
        for _ in range(settings.epochs):
            stacked, opt_state = pop.step(stacked, opt_state, masks, xd, yd,
                                          twd)
        a = pop.loss_sums(stacked, masks, xd, yd, vwd).cpu().numpy()
        return a[:, 0] / np.maximum(a[:, 1], 1e-9)
    return evaluate


def make_streamed_population_evaluator(stream, settings: WrapperSettings,
                                       cache_budget: Optional[int] = None,
                                       device=None):
    """Out-of-core counterpart of :func:`make_population_evaluator`: the
    population still trains as one stacked run, but an epoch is one ADAM
    step a window over the norm plane's prepared windows (the reference's
    minibatch scan); windows within ``cache_budget`` (default
    ``shifu.train.deviceCacheBytes``, 1 GiB) stay on the device across
    every epoch and generation, the rest re-stream from disk.

    The train/validation split derives from the global row index
    (``row_uniform(seed, 11, index) < valid_rate``), as the reference's
    streamed split does.  Returns ``(evaluate, d)``; ``evaluate`` reads
    the device once a generation."""
    from ..data.streaming import PreparedWindow, ResidentCache, row_uniform

    names = stream.shards.schema.get("outputNames") or []
    if not names:
        raise ValueError("streamed dvarsel needs schema outputNames "
                         "(run `norm` to materialize the plane)")
    d = len(names)
    dev = resolve_device(device)
    pop = _Population(d, settings, dev)

    def prepare(win):
        vmask = row_uniform(settings.seed, 11, win.index) \
            < settings.valid_rate
        wcol = np.asarray(win.arrays["w"], np.float32).copy()
        wcol[win.n_valid:] = 0.0
        host = {"x": np.asarray(win.arrays["x"], np.float32),
                "y": np.asarray(win.arrays["y"], np.float32)[:, None],
                "tw": (wcol * ~vmask).astype(np.float32),
                "vw": (wcol * vmask).astype(np.float32)}
        return PreparedWindow(
            start=win.start, n_valid=win.n_valid, rows=win.rows,
            index=win.index,
            arrays={k: torch.from_numpy(np.require(v, requirements="CW"))
                    .to(dev) for k, v in host.items()})

    if cache_budget is None:
        from ..config import environment
        cache_budget = environment.get_int("shifu.train.deviceCacheBytes",
                                           1 << 30)
    cache = ResidentCache(stream, cache_budget, prepare)

    def evaluate(feat_masks: np.ndarray) -> np.ndarray:
        masks = torch.from_numpy(np.asarray(feat_masks, np.float32)).to(dev)
        stacked, opt_state = pop.start(len(feat_masks))
        win_c = obs.counter("varsel.windows")
        for _ in range(settings.epochs):
            for it in cache.items():
                a = it.arrays
                stacked, opt_state = pop.step(stacked, opt_state, masks,
                                              a["x"], a["y"], a["tw"])
                win_c.inc()
        acc = torch.zeros((len(feat_masks), 2), device=dev)
        for it in cache.items():
            a = it.arrays
            acc += pop.loss_sums(stacked, masks, a["x"], a["y"], a["vw"])
        a = acc.cpu().numpy()               # the generation's one read
        obs.counter("varsel.host_syncs").inc()
        return a[:, 0] / np.maximum(a[:, 1], 1e-9)

    return evaluate, d


def genetic_varselect(x: np.ndarray, y: np.ndarray, w: np.ndarray,
                      blocks: Dict[int, List[int]],
                      settings: WrapperSettings, device=None
                      ) -> Tuple[Dict[int, float], List[dict]]:
    """Evolve column subsets over a RESIDENT matrix; returns (per-column
    credit scores, history).  See :func:`_genetic_search` for the loop;
    :func:`genetic_varselect_streamed` is the out-of-core twin."""
    rng = np.random.default_rng(settings.seed)
    vmask = rng.random(len(y)) < settings.valid_rate
    tw = np.asarray(w, np.float32) * ~vmask
    vw = np.asarray(w, np.float32) * vmask
    evaluate = make_population_evaluator(x, y, tw, vw, settings, device)
    return _genetic_search(evaluate, blocks, settings, x.shape[1], rng)


def genetic_varselect_streamed(stream, blocks: Dict[int, List[int]],
                               settings: WrapperSettings,
                               cache_budget: Optional[int] = None,
                               device=None
                               ) -> Tuple[Dict[int, float], List[dict]]:
    """Out-of-core genetic wrapper: the same search, with fitness
    evaluated by one ADAM step a window over the norm plane's windows
    instead of a resident matrix."""
    evaluate, d = make_streamed_population_evaluator(stream, settings,
                                                     cache_budget, device)
    return _genetic_search(evaluate, blocks, settings, d,
                           np.random.default_rng(settings.seed))


def _genetic_search(evaluate, blocks: Dict[int, List[int]],
                    settings: WrapperSettings, d: int,
                    rng: np.random.Generator
                    ) -> Tuple[Dict[int, float], List[dict]]:
    """The generation loop both data modes share — the reference's loop
    as it stands, draw for draw.

    Seeds are column-id sets of size ``n_select``; each generation ranks
    them by masked-NN validation loss (``evaluate(feat_masks [P, d])``),
    then builds the next from inherit + crossover + mutation
    (``CandidateGenerator.java``); per-column credit accumulates
    rank-weighted wins (``SeedCredit.java``)."""
    col_ids = sorted(blocks.keys())
    C = len(col_ids)
    k = min(settings.n_select, C)
    P = settings.population

    def feat_mask(seed_cols: np.ndarray) -> np.ndarray:
        m = np.zeros(d, bool)
        for ci in seed_cols:
            m[blocks[col_ids[ci]]] = True
        return m

    if k >= C:
        log.warning("dvarsel: seed size %d >= %d candidate columns — every "
                    "seed holds ALL columns, the search is degenerate; set "
                    "EXPECT_VARIABLE_CNT (or filterNum) below the candidate "
                    "count", k, C)
    pop = np.stack([rng.choice(C, size=k, replace=False) for _ in range(P)])
    credit = np.zeros(C)
    history: List[dict] = []
    best_seed, best_fit = None, np.inf
    for gen in range(settings.generations):
        fmasks = np.stack([feat_mask(s) for s in pop])
        fits = evaluate(fmasks)
        order = np.argsort(fits)
        # SeedCredit: rank-weighted column wins
        for rank, pi in enumerate(order):
            for ci in pop[pi]:
                credit[ci] += (P - rank)
        if fits[order[0]] < best_fit:
            best_fit = float(fits[order[0]])
            best_seed = pop[order[0]].copy()
        history.append({"generation": gen,
                        "best": float(fits[order[0]]),
                        "mean": float(fits.mean())})
        log.info("dvarsel gen %d: best %.6f mean %.6f", gen,
                 fits[order[0]], fits.mean())
        if gen == settings.generations - 1:
            break
        # ---- next generation (CandidateGenerator proportions)
        n_cross = int(P * settings.hybrid_percent)
        n_mut = int(P * settings.mutation_percent)
        n_inherit = P - n_cross - n_mut
        nxt = [pop[pi].copy() for pi in order[:max(1, n_inherit)]]
        parents = pop[order[:max(2, P // 2)]]
        while len(nxt) < max(1, n_inherit) + n_cross:
            pa, pb = parents[rng.integers(len(parents), size=2)]
            union = np.union1d(pa, pb)
            nxt.append(rng.choice(union, size=min(k, len(union)),
                                  replace=False))
        while len(nxt) < P:
            base = pop[order[rng.integers(max(1, P // 2))]].copy()
            flip = rng.integers(len(base))
            choices = np.setdiff1d(np.arange(C), base)
            if len(choices):
                base[flip] = rng.choice(choices)
            nxt.append(base)
        pop = np.stack([np.sort(np.asarray(s)) for s in nxt])

    scores = {col_ids[ci]: float(credit[ci]) for ci in range(C)}
    # the winning seed's columns get a decisive bonus so exactly those rank
    # first when filterNum == n_select
    if best_seed is not None:
        for ci in best_seed:
            scores[col_ids[ci]] += credit.max() * C
    return scores, history
