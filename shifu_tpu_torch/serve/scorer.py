"""Device-resident ensemble scorer — one captured CUDA graph per batch
bucket; the port of ``shifu_tpu.serve.scorer``.

:class:`AOTScorer` pins the ensemble on the device once — the forests in
their packed traversal layout, the NN/LR nets stacked per shape — and
keeps the reference's request contract: a batch pads to the smallest
covering rung of the bucket ladder, batches beyond the top rung chunk
through it, and the result is trimmed back to the request's rows.  Forest
columns read the bins (one ``tree_traverse`` kernel launch per forest per
bucket); net columns read the normalized floats ``x`` (one stacked
forward per same-shape group, ``torch.matmul`` on cuBLAS), as do kernel
SVM columns (one kernel matrix against the support vectors); a WDL
column reads its numeric block of ``x`` and its categorical columns of
the bins, hashed columns folding on the device.  A raw-record batch gets
both planes from ``FusedTransform.apply_device``.

The reference's AOT contract — compile every rung once at startup, never
again — becomes per-bucket CUDA graphs.  ``warm()`` captures, for every
rung, one ``torch.cuda.CUDAGraph`` of the whole padded-batch function
(``fn(x, bins)``, and a second one of ``apply_device`` -> ``fn`` over the
wire rows when the scorer takes raw records), after one eager launch on a
side stream that takes the lazy kernel build, the transform's constants
and the library handles out of the capture.  The graphs read static input
buffers, write a static output buffer allocated outside the graph, and
share one memory pool across the scorer's rungs.  A request copies its
padded rows into the rung's pinned host staging buffer, then on the
scorer's stream: one host-to-device copy, the replay, one device-to-host
copy.  Rungs share the pool, so their intermediates may alias: every
replay runs on the scorer's one stream, in order; a rung's lock covers
its copy-in, replay and copy-out.  A capture that fails raises — the
scorer never falls back to eager launches on the card.

On the CPU nothing is captured: a rung is its static input buffers and
the function runs eagerly over them, and "capture" counts one build per
rung and path, so the capture contract (:func:`serve_capture_count`) is
testable without a card.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..eval.scorer import SCORE_SCALE, Scorer
from ..ops import tree_quant as tq

log = logging.getLogger(__name__)

# geometric bucket ladder default: one graph per rung; request batches
# pad to the smallest covering rung (``-Dshifu.serve.buckets``)
DEFAULT_BUCKETS = (1, 8, 64, 512)


def bucket_ladder() -> Tuple[int, ...]:
    """The configured bucket ladder, ascending and deduplicated
    (property ``shifu.serve.buckets`` = comma-separated sizes)."""
    from ..config import environment
    spec = environment.get_property("shifu.serve.buckets")
    if not spec:
        return DEFAULT_BUCKETS
    try:
        sizes = sorted({int(s) for s in spec.split(",") if s.strip()})
        if not sizes or any(s <= 0 for s in sizes):
            raise ValueError(spec)
        return tuple(sizes)
    except ValueError:
        log.warning("ignoring unparseable shifu.serve.buckets=%r", spec)
        return DEFAULT_BUCKETS


def covering_bucket(buckets: Sequence[int], n: int) -> int:
    """Smallest rung >= n (the largest rung when n exceeds the ladder —
    the caller chunks oversize batches)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def refine_ladder(buckets: Sequence[int], size_counts: dict,
                  max_extra: int = 2, min_share: float = 0.2,
                  occupancy_target: float = 0.8,
                  multiple: int = 8) -> Tuple[int, ...]:
    """Occupancy-driven rung refinement: given the observed distribution
    of real batch row-counts (``size_counts``: rows -> batches), propose
    intermediate rungs under rungs that systematically pad.

    A rung qualifies when it carries at least ``min_share`` of observed
    batches AND the p95 of its real batch sizes — rounded up to
    ``multiple`` — lands below ``occupancy_target`` of the rung.  At most
    ``max_extra`` rungs are added per refinement and existing rungs are
    never removed, so every in-flight ``covering_bucket`` decision stays
    valid and the captured graphs keep serving; a new rung is captured
    before any batch pads to it (:meth:`AOTScorer.extend_buckets`)."""
    buckets = tuple(sorted(set(int(b) for b in buckets)))
    total = sum(size_counts.values())
    if not total:
        return buckets
    per_rung: dict = {b: [] for b in buckets}
    for n, cnt in size_counts.items():
        per_rung[covering_bucket(buckets, int(n))].append((int(n), cnt))
    proposals = []
    for b, sizes in per_rung.items():
        if b == buckets[0]:
            continue                    # nothing tighter to offer
        carried = sum(c for _, c in sizes)
        if carried / total < min_share:
            continue
        cum, p95 = 0, b
        for n, c in sorted(sizes):
            cum += c
            if cum >= 0.95 * carried:
                p95 = n
                break
        rung = min(b, ((p95 + multiple - 1) // multiple) * multiple)
        if 0 < rung < occupancy_target * b and rung not in buckets:
            proposals.append((carried, rung))
    extra = sorted(r for _, r in
                   sorted(proposals, reverse=True)[:max_extra])
    return tuple(sorted(set(buckets) | set(extra)))


def infer_dims(models: Sequence) -> Tuple[int, int]:
    """(n_features, n_bin_cols) the ensemble's inputs must provide, derived
    from the saved specs: the nets' ``input_dim``, the SVMs' support-vector
    width, the forests' widest split column, and a WDL model's recorded
    index lists (each plane's width apart); 0 where no model reads a
    plane."""
    n_feat = n_bins_cols = 0
    for m in models:
        name = type(m).__name__
        if name == "IndependentNNModel":
            n_feat = max(n_feat, int(m.spec.input_dim))
        elif name == "IndependentSVMModel":
            n_feat = max(n_feat, int(m.sv_x.shape[1]))
        elif name == "IndependentTreeModel":
            feats = max((int(np.max(t.split_feat)) for t in m.trees),
                        default=-1)
            n_bins_cols = max(n_bins_cols, feats + 1)
        elif name == "IndependentWDLModel":
            extra = m.spec.extra or {}
            nf = extra.get("num_feat_idx") or []
            cf = extra.get("cat_col_idx") or []
            if nf:
                n_feat = max(n_feat, max(nf) + 1)
            if cf:
                n_bins_cols = max(n_bins_cols, max(cf) + 1)
        else:
            raise TypeError(f"cannot serve a {name}")
    return n_feat, n_bins_cols


def _tree_column(m, device: torch.device) -> Callable:
    """Score column of a saved forest on ``device``: the narrow traversal
    (kernel on CUDA, over the ensemble's uint8 or int32 bin plane) then the
    model's f32 link — the device twin of ``IndependentTreeModel.compute``."""
    depth = m.trees[0].depth
    arrays = m.quant_arrays(device)
    packed = m.quant_packed(device)          # packed once, where pinned

    def col(x, bins):
        preds = tq.predict_forest_quant(*arrays, bins, depth, packed=packed)
        out = m.link(preds)
        return out[:, 0] if out.dim() > 1 else out
    return col


def _wdl_column(m, device: torch.device) -> Callable:
    """Score column of a WDL model on ``device``: its numeric block of
    ``x`` and categorical columns of the bins (index lists pinned once),
    hashed columns folded on the device (``apply_hash_device``, bit-equal
    to the trainer's host hashing), one forward.  The table copy is picked
    here, once, when the scorer is built (a swap's ``prepare``):
    ``shifu.wdl.serveCopy`` (``train/wdl_shard.py::build_serve_forward``)
    — the replicated params, the hot-rows copy or the copy split over the
    process's cards — each pinned on the device and captured inside every
    rung's graph."""
    from ..train.wdl_shard import build_serve_forward
    extra = m.spec.extra or {}
    nf = torch.tensor(extra.get("num_feat_idx") or [], dtype=torch.int64,
                      device=device)
    cf = torch.tensor(extra.get("cat_col_idx") or [], dtype=torch.int64,
                      device=device)
    mode, fwd = build_serve_forward(m.spec, m.params, device)
    if fwd is None:
        m.on(device)                         # pinned once, like a forest
        fwd = m.forward_device

    def col(x, bins):
        return fwd(x.index_select(1, nf), bins.index_select(1, cf).long())[
            :, 0]
    col.serve_copy = mode
    return col


def _svm_column(m) -> Callable:
    """Score column of a kernel SVM over ``x``."""
    return lambda x, bins: m.decision(x)[:, 0]


def build_ensemble_fn(scorer: Scorer, device: torch.device) -> Callable:
    """``fn(x, bins) -> [n, M]`` scaled scores over the whole ensemble on
    ``device``: the scorer's same-shape net groups as stacked forwards
    over ``x``, every other model as its own column."""
    from ..models.nn import forward
    groups = scorer.nn_groups()
    grouped = {i for idxs, _, _ in groups for i in idxs}
    columns = {}
    for i, m in enumerate(scorer.models):
        if i in grouped:
            continue
        kind = getattr(m, "input_kind", "norm")
        if kind == "bins":
            columns[i] = _tree_column(m, device)
        elif kind == "both":
            columns[i] = _wdl_column(m, device)
        else:
            columns[i] = _svm_column(m)
    n_models = len(scorer.models)
    scale = scorer.scale

    def fn(x, bins):
        cols: List[Optional[torch.Tensor]] = [None] * n_models
        for idxs, spec, stacked in groups:
            out = forward(stacked, spec, x)            # [G, n, out]
            for pos, i in enumerate(idxs):
                cols[i] = out[pos, :, 0]
        for i, col in columns.items():
            cols[i] = col(x, bins)
        return torch.stack(cols, dim=1) * scale
    return fn


# every live scorer, for the process-wide capture count
_SCORERS: "weakref.WeakSet" = weakref.WeakSet()


def serve_capture_count(prefix: str = "serve.score") -> int:
    """Captures a request forced, across every live scorer whose name
    starts with ``prefix``: rungs captured at request time because
    ``warm()`` / ``extend_buckets`` had not (a rung is captured once, ever)
    — the port of the reference's ``serve_recompile_count``.  A warmed
    server must report 0 whatever request sizes arrive, across refinement
    and a committed swap (each generation is its own scorer, captured
    before it is published)."""
    return sum(s.lazy_captures for s in list(_SCORERS)
               if s.name.startswith(prefix))


def serve_graph_counts(prefix: str = "serve.score") -> dict:
    """What this process's scorers (names starting with ``prefix``) did on
    the device: captures a request forced (:func:`serve_capture_count`),
    rung builds, graph replays, the ``tree_traverse`` launches those
    replays ran and the rungs' eager warm-ups made, and the kernel's
    process-wide launch count."""
    live = [s for s in list(_SCORERS) if s.name.startswith(prefix)]
    return {"captures_forced": sum(s.lazy_captures for s in live),
            "captures": sum(s.captures for s in live),
            "replays": sum(s.replays for s in live),
            "replayed_launches": sum(s.replayed_launches for s in live),
            "warm_launches": sum(s.warm_launches for s in live),
            "tree_traverse_launches": int(tq.predict_forest_quant.launches)}


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


class _Rung:
    """One rung of one path: static inputs on the scoring device, the host
    buffers a request fills (pinned staging on CUDA, the inputs themselves
    on the CPU) and, on CUDA, the captured graph over the inputs, its
    output buffer and pinned host copy, the replay's completion event, the
    cost-record shapes of the kernel launches the graph records (one a
    launch) and the count of those its eager warm-up made."""

    __slots__ = ("inputs", "graph", "out", "host_in", "host_out", "event",
                 "launch_shapes", "warm_launches", "lock")

    def __init__(self, inputs: List[torch.Tensor]):
        self.inputs = inputs
        self.graph = None
        self.out = None
        self.host_in: List[torch.Tensor] = []
        self.host_out = None
        self.event = None
        self.launch_shapes: list = []
        self.warm_launches = 0
        self.lock = threading.Lock()

    @property
    def launches(self) -> int:
        """Kernel launches the captured graph replays."""
        return len(self.launch_shapes)


class AOTScorer:
    """The modelset's ensemble pinned on the device behind per-bucket CUDA
    graphs (see module docs).  ``warm()`` captures every rung;
    :meth:`score_batch` then pads to the covering rung, replays and trims.
    Thread-safe: a batcher worker replays while a refinement or a swap
    captures elsewhere (thread-local capture mode)."""

    # the batcher's request tracer may pass ``timings=``
    supports_timings = True

    def __init__(self, models: Sequence, scale: float = SCORE_SCALE,
                 buckets: Optional[Sequence[int]] = None,
                 transform=None, device=None, name: str = "serve.score"):
        self.device = resolve_device(device)
        self.name = name
        self.scorer = Scorer(models, scale, device=self.device)
        self.buckets = tuple(sorted(set(buckets or bucket_ladder())))
        self.n_features, self.n_bins_cols = infer_dims(models)
        self.bins_dtype = self.scorer.bins_dtype()
        self._fn = build_ensemble_fn(self.scorer, self.device)
        self.needs_bins = self.n_bins_cols > 0
        self.transform = transform
        self.accepts_raw = transform is not None
        if transform is not None:
            if transform.width < self.n_features:
                raise ValueError(
                    f"transform emits {transform.width} features but the "
                    f"ensemble consumes {self.n_features} — the ColumnConfig "
                    "snapshot does not match the models")
            if transform.n_columns < self.n_bins_cols:
                raise ValueError(
                    f"transform emits {transform.n_columns} bin columns but "
                    f"the ensemble consumes {self.n_bins_cols}")
        self._rungs: Dict[Tuple[bool, int], _Rung] = {}
        self._lock = threading.Lock()           # rung table + ladder
        self.captures = 0                       # rungs built, all time
        self.lazy_captures = 0                  # built at request time
        # B4 launches: made by the rungs' eager warm-ups, and run by graph
        # replays (``replays`` of them); each also in the kernel's count
        self.warm_launches = 0
        self.replays = 0
        self.replayed_launches = 0
        self._count_lock = threading.Lock()
        self._pool = None
        self._stream = None
        _SCORERS.add(self)

    @property
    def models(self) -> List:
        return self.scorer.models

    # ----------------------------------------------------------- function
    def _raw_fn(self, wire: torch.Tensor) -> torch.Tensor:
        xx, bb = self.transform.apply_device(wire,
                                             need_x=self.n_features > 0)
        return self._fn(
            xx[:, :self.n_features],
            bb[:, :self.n_bins_cols].to(self.bins_dtype).contiguous())

    def _shapes(self, bucket: int, raw: bool) -> list:
        if raw:
            return [((bucket, self.transform.wire_width),
                     _torch_dtype(self.transform.wire_dtype))]
        return [((bucket, self.n_features), torch.float32),
                ((bucket, self.n_bins_cols), self.bins_dtype)]

    # ------------------------------------------------------------ capture
    def _build(self, bucket: int, raw: bool) -> _Rung:
        """A rung's static buffers and, on CUDA, its captured graph."""
        dev = self.device
        rung = _Rung([torch.zeros(shape, dtype=dt, device=dev)
                      for shape, dt in self._shapes(bucket, raw)])
        if dev.type != "cuda":
            rung.host_in = rung.inputs          # filled in place
            return rung
        fn = self._raw_fn if raw else self._fn
        with torch.cuda.device(dev), torch.no_grad():
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(dev)
            # one eager launch on a side stream first: the kernel's lazy
            # build and attribute setup, the transform's constants, the
            # pinned model tensors and the library handles all happen
            # here, outside the capture
            cur = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            eager0 = tq.eager_launches()
            with torch.cuda.stream(side):
                ref = fn(*rung.inputs)
            rung.warm_launches = tq.eager_launches() - eager0
            cur.wait_stream(side)
            torch.cuda.synchronize(dev)
            rung.out = torch.empty_like(ref)
            graph = torch.cuda.CUDAGraph()
            tq.take_captured()
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                rung.out.copy_(fn(*rung.inputs))
            rung.launch_shapes = tq.take_captured()
            rung.graph = graph
        rung.host_in = [torch.zeros(shape, dtype=dt, pin_memory=True)
                        for shape, dt in self._shapes(bucket, raw)]
        rung.host_out = torch.empty(tuple(rung.out.shape),
                                    dtype=rung.out.dtype, pin_memory=True)
        rung.event = torch.cuda.Event()
        return rung

    def _rung(self, bucket: int, raw: bool, lazy: bool = True) -> _Rung:
        key = (raw, bucket)
        rung = self._rungs.get(key)
        if rung is not None:
            return rung
        with self._lock:
            rung = self._rungs.get(key)
            if rung is None:
                rung = self._build(bucket, raw)
                self.captures += 1
                self.warm_launches += rung.warm_launches
                if lazy:
                    self.lazy_captures += 1
                    log.warning("%s: rung %d%s captured at request time — "
                                "warm() was not called", self.name, bucket,
                                " (raw)" if raw else "")
                self._rungs[key] = rung
        return rung

    def _warm_one(self, bucket: int) -> None:
        self._rung(bucket, False, lazy=False)
        if self.accepts_raw:
            self._rung(bucket, True, lazy=False)

    def warm(self) -> None:
        """Capture every rung (both paths) before the first request."""
        for b in self.buckets:
            self._warm_one(b)

    def extend_buckets(self, new_buckets: Sequence[int]) -> int:
        """Grow the ladder with occupancy-refined rungs
        (:func:`refine_ladder`).  Every new rung is captured BEFORE it is
        published, so no batch ever pads to a rung without its graph.
        Existing rungs are never removed.  Returns the rungs added."""
        add = [int(b) for b in sorted(set(new_buckets))
               if int(b) > 0 and int(b) not in self.buckets]
        for b in add:
            self._warm_one(b)
        if add:
            with self._lock:
                self.buckets = tuple(sorted(set(self.buckets) | set(add)))
            from .. import obs
            obs.counter("serve.bucket_rungs_added").inc(len(add))
            log.info("%s: ladder refined to %s", self.name, self.buckets)
        return len(add)

    # ------------------------------------------------------------- score
    def _run(self, arrays: Sequence[np.ndarray], n: int, raw: bool,
             timings: Optional[dict]) -> np.ndarray:
        """Pad ``arrays`` into the covering rung, run it, trim to ``n``."""
        bucket = covering_bucket(self.buckets, n)
        rung = self._rung(bucket, raw)
        with rung.lock:
            t0 = time.perf_counter() if timings is not None else 0.0
            for host, a in zip(rung.host_in, arrays):
                hv = host.numpy()
                if a is not None:
                    hv[:n] = a
                hv[n:] = 0
            t1 = time.perf_counter() if timings is not None else 0.0
            if rung.graph is None:              # CPU: eager over the rung
                with torch.no_grad():
                    out = (self._raw_fn if raw else self._fn)(*rung.inputs)
                t2 = time.perf_counter() if timings is not None else 0.0
                res = out.numpy()[:n].copy()
            else:
                with torch.cuda.stream(self._stream):
                    for buf, host in zip(rung.inputs, rung.host_in):
                        buf.copy_(host, non_blocking=True)
                    rung.graph.replay()
                    rung.host_out.copy_(rung.out, non_blocking=True)
                    rung.event.record()
                rung.event.synchronize()
                tq.count_replays(rung.launch_shapes)
                with self._count_lock:
                    self.replays += 1
                    self.replayed_launches += rung.launches
                t2 = time.perf_counter() if timings is not None else 0.0
                res = rung.host_out.numpy()[:n].copy()
        if timings is not None:
            t3 = time.perf_counter()
            timings["pad_s"] = timings.get("pad_s", 0.0) + (t1 - t0)
            timings["device_s"] = timings.get("device_s", 0.0) + (t2 - t1)
            timings["launch_s"] = timings.get("launch_s", 0.0) + (t3 - t2)
        return res

    def _check_prebinned(self, x: np.ndarray,
                         bins: Optional[np.ndarray]) -> None:
        if bins is None and self.needs_bins:
            raise ValueError("ensemble contains bin-consuming models "
                             "— requests must carry bins")
        n_bins = self.n_bins_cols if bins is None else bins.shape[1]
        if x.shape[1] != self.n_features or n_bins != self.n_bins_cols:
            raise ValueError(
                f"request carries {x.shape[1]} features and {n_bins} bin "
                f"columns; the ensemble takes {self.n_features} and "
                f"{self.n_bins_cols}")

    def score_batch(self, x: np.ndarray,
                    bins: Optional[np.ndarray] = None,
                    timings: Optional[dict] = None) -> np.ndarray:
        """raw scaled scores [n, M] for a request batch; pads to the
        covering bucket, chunks batches beyond the top rung.

        ``timings`` (sampled request tracing only) accumulates the launch
        decomposition in place: ``pad_s`` the host pad copy into the
        rung's staging, ``device_s`` the copy in, replay and copy out
        (waited on), ``launch_s`` the trim of the host result."""
        n = len(x)
        top = self.buckets[-1]
        if n > top:
            return np.concatenate(
                [self.score_batch(x[s:s + top],
                                  None if bins is None else bins[s:s + top],
                                  timings=timings)
                 for s in range(0, n, top)], axis=0)
        self._check_prebinned(x, bins)
        return self._run([x, bins], n, False, timings)

    def score_batch_raw(self, packed: np.ndarray,
                        timings: Optional[dict] = None) -> np.ndarray:
        """raw scaled scores [n, M] for PACKED raw-record rows (the
        ``serve/transform.py`` wire format): the transform runs on the
        device inside the rung's graph and feeds the same ensemble.  Same
        pad/chunk/trim contract as :meth:`score_batch`; pad rows are
        all-missing."""
        if not self.accepts_raw:
            raise ValueError("this scorer was built without a norm "
                             "transform — raw records need the "
                             "ColumnConfig snapshot")
        n = len(packed)
        top = self.buckets[-1]
        if n > top:
            return np.concatenate(
                [self.score_batch_raw(packed[s:s + top], timings=timings)
                 for s in range(0, n, top)], axis=0)
        return self._run([packed], n, True, timings)

    def score_mean(self, x: np.ndarray,
                   bins: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-row ensemble mean — the serving response column."""
        return self.score_batch(x, bins).mean(axis=1)

    def eager_batch(self, arrays: Sequence[Optional[np.ndarray]],
                    raw: bool = False) -> np.ndarray:
        """The same padded-batch function as the rung covering
        ``len(arrays[0])`` rows (at most the top rung), launched eagerly
        on fresh tensors instead of replayed — the reference a replay is
        held to, bit for bit.  Not on the serving path."""
        n = len(arrays[0])
        bucket = covering_bucket(self.buckets, n)
        ins = []
        for (shape, dt), a in zip(self._shapes(bucket, raw), arrays):
            t = torch.zeros(shape, dtype=dt)
            if a is not None:
                t[:n] = torch.from_numpy(np.asarray(a)).to(dt)
            ins.append(t.to(self.device))
        with torch.no_grad():
            out = (self._raw_fn if raw else self._fn)(*ins)
        return out.cpu().numpy()[:n]
