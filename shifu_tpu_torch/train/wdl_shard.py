"""Row-sharded WDL tables — the port of ``shifu_tpu.train.wdl_shard``.

The replicated WDL trainer keeps every embedding and wide table whole on
every rank, so a step pays a whole-table gradient all_reduce and each rank
steps every row.  With ``shifu.wdl.shardTables`` the ``embed`` and
``wide_cat`` tables (and every optimizer leaf shaped like them: Adam's
moments, the mixed ladder's master) are split by rows over the mesh's
``data`` axis:

- **layout**: column ``i``'s rows pad with zero rows to ``vp_i = D ·
  vs_i``, ``vs_i = ceil(card_i / D)``, and rank ``d`` holds rows ``[d ·
  vs_i, (d + 1) · vs_i)`` of every column.  The port's tables are flat
  (``models/wdl.py``: every column's rows in one table), so a rank's shard
  is the flat concatenation of its ``vs_i``-row blocks
  (:attr:`WDLShardPlane.local_offsets`);
- **sparse row gather**: the batch's ids are all_gathered over the data
  group, each rank resolves them against its own rows (a masked local
  take: ids clip to the TRUE cardinality before the rank offset, so a
  padded row is never read), and one tiled reduce-scatter
  (``parallel.mesh.reduce_scatter``) hands each rank the rows of its own
  row block.  Each (row, column) cell has one nonzero contributor, so the
  scatter rebuilds the replicated lookup bit for bit;
- **sharded update**: the reduce-scatter's backward is an all_gather of
  the cotangents, so each shard's gradient lands complete on its owner
  and no table crosses ranks; the dense leaves' partial gradients sum
  after the backward (``_flat_all_reduce``), the loss normaliser and L2
  stay outside the gradient, and the update rule steps only the local
  rows (every rule is elementwise, so a padded row keeps a zero gradient
  and stays zero);
- **snapshots**: :meth:`WDLShardPlane.whole` gathers the shards and drops
  the padding, so the ledger, checkpoints and saved models keep the
  exact shapes whatever the world.

The dense half of every forward is ``models.wdl.logits_from_rows``, the
function the replicated lookup feeds, so a world of one with the plane on
is the replicated run bit for bit.

Serving (``shifu.wdl.serveCopy``): :func:`build_serve_forward` picks the
replicated copy, a lossy hot-rows copy (the first ``serveHotRows`` rows
exact and one mean-of-tail row, to which the forward's clip maps every
cold id) or a copy split over the process's cards (a masked lookup a
shard, the shards summed on the scoring card), built at swap time.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import obs
from ..config import environment
from ..models import wdl as wdl_model
from ..parallel import mesh as meshlib

log = logging.getLogger(__name__)

_TABLES = ("embed", "wide_cat")


# ------------------------------------------------------------------ knobs
def shard_mode() -> str:
    """``shifu.wdl.shardTables``: on | off | auto (size-gated)."""
    raw = str(environment.get_property("shifu.wdl.shardTables", "auto")
              or "auto").lower()
    if raw in ("on", "true", "1"):
        return "on"
    if raw in ("off", "false", "0"):
        return "off"
    if raw != "auto":
        log.warning("unknown shifu.wdl.shardTables %r; using auto", raw)
    return "auto"


def shard_min_bytes() -> int:
    """``shifu.wdl.shardMinBytes``: the auto gate's threshold on the
    replicated bytes of the tables and their moments."""
    return environment.get_int("shifu.wdl.shardMinBytes", 64 << 20)


def serve_copy_mode() -> str:
    """``shifu.wdl.serveCopy``: auto | full | sharded | hot."""
    raw = str(environment.get_property("shifu.wdl.serveCopy", "auto")
              or "auto").lower()
    if raw in ("auto", "full", "sharded", "hot"):
        return raw
    log.warning("unknown shifu.wdl.serveCopy %r; using auto", raw)
    return "auto"


def serve_hot_rows() -> int:
    """``shifu.wdl.serveHotRows``: the exact head rows of the hot copy."""
    return environment.get_int("shifu.wdl.serveHotRows", 1 << 16)


def table_param_bytes(spec, bags: int = 1, precision: str = "f32") -> int:
    """Replicated bytes of every categorical table and its two Adam
    moments, over ``bags`` members: what the auto gate weighs (a float32
    estimate for mixed too, a lower bound)."""
    per = 4 if precision == "f32" else 2
    elems = 0
    for c in spec.cat_cardinalities:
        if spec.deep_enable:
            elems += int(c) * spec.embed_dim
        if spec.wide_enable:
            elems += int(c)
    return 3 * elems * per * bags


def data_size(mesh) -> int:
    return mesh.n_data if mesh is not None else 1


def shard_enabled(spec, mesh, bags: int = 1, precision: str = "f32",
                  override: Optional[bool] = None) -> bool:
    """Whether a run shards its tables: an explicit ``override`` wins,
    then ``shifu.wdl.shardTables`` (``on`` shards on a world of one too;
    ``auto`` only where the data axis is above 1 and the tables reach
    ``shifu.wdl.shardMinBytes``)."""
    if not spec.cat_cardinalities:
        return False
    if override is not None:
        return bool(override)
    mode = shard_mode()
    if mode == "off":
        return False
    if mode == "on":
        return True
    if data_size(mesh) <= 1:
        return False
    return table_param_bytes(spec, bags, precision) >= shard_min_bytes()


# ------------------------------------------------------------------ plane
def _row_axis(name: str, t: torch.Tensor) -> int:
    """The rows' axis of a table leaf: ``embed`` [.., R, E], ``wide_cat``
    [.., R]."""
    return t.dim() - (2 if name == "embed" else 1)


def _map_tables(fn: Callable[[str, torch.Tensor], torch.Tensor], tree):
    """``tree`` (params or any optimizer state: every params-shaped
    subtree, a dict with a ``bias``) with ``fn(name, leaf)`` applied to
    its table leaves; every other leaf as it is."""
    if isinstance(tree, dict):
        params_like = "bias" in tree
        return {k: (fn(k, v) if params_like and k in _TABLES
                    and isinstance(v, torch.Tensor)
                    else _map_tables(fn, v)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_tables(fn, v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return tree


def _offsets(sizes) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)]) \
        .astype(np.int64)


class WDLShardPlane:
    """The row-sharded layout of one spec over ``mesh``'s data axis (a
    mesh of one, or None, is a data axis of 1): per-column rows a shard
    ``vs``, padded cardinalities ``vp``, the flat offsets of the true,
    padded and local layouts, and the maps between them."""

    def __init__(self, mesh, spec, bags: int = 1, d: Optional[int] = None):
        self.mesh, self.spec, self.bags = mesh, spec, bags
        self.d = data_size(mesh) if d is None else d
        self.me = mesh.coords[1] if mesh is not None and self.d > 1 else 0
        self.cards = [int(c) for c in spec.cat_cardinalities]
        self.vs = [-(-c // self.d) for c in self.cards]
        self.vp = [v * self.d for v in self.vs]
        self.offsets = _offsets(self.cards)
        self.pad_offsets = _offsets(self.vp)
        self.local_offsets = _offsets(self.vs)
        self._on: Dict[torch.device, tuple] = {}

    @property
    def local_rows(self) -> int:
        return int(self.local_offsets[-1])

    # -- shape plumbing
    def _relayout(self, t: torch.Tensor, axis: int, src, dst, rows: int,
                  pieces) -> torch.Tensor:
        """A new table of ``rows`` rows along ``axis`` (zeros), column
        ``i``'s rows ``src[i] + a .. src[i] + b`` copied to ``dst[i] + a'``
        for each ``(i, a, b, a')`` of ``pieces``."""
        shape = list(t.shape)
        shape[axis] = rows
        out = t.new_zeros(shape)
        for i, a, b, a2 in pieces:
            if b > a:
                out.narrow(axis, int(dst[i]) + a2, b - a).copy_(
                    t.narrow(axis, int(src[i]) + a, b - a))
        return out

    def pad_params(self, tree):
        """Each column's rows zero-padded to ``vp_i`` (the flat padded
        layout), in a params tree or any optimizer state."""
        def pad(name, t):
            return self._relayout(
                t, _row_axis(name, t), self.offsets, self.pad_offsets,
                int(self.pad_offsets[-1]),
                [(i, 0, c, 0) for i, c in enumerate(self.cards)])
        return _map_tables(pad, tree)

    def unpad_params(self, tree):
        """:meth:`pad_params` undone: the true cardinalities again."""
        def unpad(name, t):
            return self._relayout(
                t, _row_axis(name, t), self.pad_offsets, self.offsets,
                int(self.offsets[-1]),
                [(i, 0, c, 0) for i, c in enumerate(self.cards)])
        return _map_tables(unpad, tree)

    def _blocks(self, d: int):
        """Rank ``d``'s rows of each column in the true layout: (column,
        first, end); ``end - first`` is short where the padding starts, 0
        past it."""
        return [(i, min(d * v, c), min((d + 1) * v, c))
                for i, (c, v) in enumerate(zip(self.cards, self.vs))]

    def shard(self, name: str, t: torch.Tensor, d: int) -> torch.Tensor:
        """Rank ``d``'s shard of one true-layout table leaf: each column's
        block of ``vs_i`` rows, the padding as zero rows."""
        return self._relayout(t, _row_axis(name, t), self.offsets,
                              self.local_offsets, self.local_rows,
                              [(i, a, b, 0) for i, a, b in self._blocks(d)])

    def local(self, tree, d: Optional[int] = None):
        """Rank ``d``'s shard (default this rank's) of every table leaf of
        a true-layout tree (params or optimizer state)."""
        d = self.me if d is None else d
        return _map_tables(lambda name, t: self.shard(name, t, d), tree)

    def whole(self, tree):
        """The true-layout tree from every rank's shard (:meth:`local`):
        one all_gather a table leaf over the data group; the padding
        dropped.  The shards themselves where the data axis is 1."""
        if self.d <= 1:
            return tree

        def gather(name, t):
            axis = _row_axis(name, t)
            rows = meshlib.all_gather(
                self.mesh, t.movedim(axis, 0).contiguous())   # [D·Rl, ...]
            out = rows.new_zeros((int(self.offsets[-1]),)
                                 + tuple(rows.shape[1:]))
            for d in range(self.d):
                base = d * self.local_rows
                for i, a, b in self._blocks(d):
                    if b > a:
                        at = base + int(self.local_offsets[i])
                        out[int(self.offsets[i]) + a:
                            int(self.offsets[i]) + b] = rows[at:at + b - a]
            return out.movedim(0, axis)
        return _map_tables(gather, tree)

    def table_bytes_per_device(self, precision: str = "f32") -> int:
        return table_param_bytes(self.spec, self.bags, precision) // self.d

    # -- the sparse row gather
    def _consts(self, dev: torch.device):
        """[C] int64 cardinalities, rows a shard and shard offsets on
        ``dev``, made there once (before a graph captures a lookup)."""
        if dev not in self._on:
            self._on[dev] = tuple(torch.as_tensor(np.asarray(a, np.int64),
                                                  device=dev)
                                  for a in (self.cards, self.vs,
                                            self.local_offsets[:-1]))
        return self._on[dev]

    def local_ids(self, x_cat: torch.Tensor, d: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows of rank ``d``'s shard [N, C] int64, owned [N, C] bool;
        default this rank's) for bin ids ``x_cat`` (hashed already): each
        id clipped to its column's TRUE cardinality, then offset by the
        rank's first row of the column; a row another rank owns is clipped
        into range and masked."""
        card, vs, loff = self._consts(x_cat.device)
        rel = torch.minimum(x_cat.long().clamp_min(0), card - 1) \
            - (self.me if d is None else d) * vs
        owned = (rel >= 0) & (rel < vs)
        return torch.minimum(rel.clamp_min(0), vs - 1) + loff, owned

    def gathered_ids(self, x_cat: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`local_ids` of every rank's rows of a block: this rank's
        ``x_cat`` [n, C] all_gathered over the data group (int32, rank
        order) first — the lookups' rows then reduce-scatter back in the
        same order."""
        g = meshlib.all_gather(self.mesh, x_cat.to(torch.int32).contiguous()) \
            if self.d > 1 else x_cat
        return self.local_ids(g)

    def rows(self, table: torch.Tensor, ids: Tuple[torch.Tensor,
                                                   torch.Tensor],
             stacked: bool) -> torch.Tensor:
        """The lookups of this rank's row block against the shards: the
        masked local take of the gathered ids, then one reduce-scatter
        over the rows (the backward: an all_gather of the cotangents)."""
        rows = masked_rows(table, *ids, stacked)
        if self.d <= 1:
            return rows
        axis = 1 if stacked else 0
        rows = meshlib.reduce_scatter(
            self.mesh, rows.movedim(axis, 0).contiguous())
        return rows.movedim(0, axis)

    def logits(self, params, x_num: torch.Tensor, ids, n: int
               ) -> torch.Tensor:
        """``models.wdl.logits_from_rows`` over the sharded lookups of
        :meth:`gathered_ids`' ``ids`` (``n`` this rank's rows)."""
        spec = self.spec
        stacked = params["bias"].dim() == 2
        emb = wrows = None
        if spec.cat_cardinalities:
            if spec.deep_enable:
                emb = self.rows(params["embed"], ids, stacked)
            if spec.wide_enable:
                wrows = self.rows(params["wide_cat"], ids, stacked)
        return wdl_model.logits_from_rows(params, spec, x_num, emb, wrows, n)


def masked_rows(table: torch.Tensor, lid: torch.Tensor,
                owned: torch.Tensor, stacked: bool) -> torch.Tensor:
    """A shard's lookups of ``lid`` ([.., M, C(, E)]), zero where the
    shard does not own the row."""
    rows = wdl_model._lookup(table, lid, stacked)
    mask = owned.unsqueeze(-1) if rows.dim() == owned.dim() + (
        2 if stacked else 1) else owned
    return torch.where(mask, rows, torch.zeros((), dtype=rows.dtype,
                                               device=rows.device))


def split_grads(grads) -> Tuple[Dict, Dict]:
    """(the dense leaves, the table leaves) of a params-shaped gradient
    tree: the dense ones sum over the data group, the sharded tables'
    arrived whole through the reduce-scatter's backward."""
    dense = {k: v for k, v in grads.items() if k not in _TABLES}
    return dense, {k: v for k, v in grads.items() if k in _TABLES}


# -------------------------------------------------------------- telemetry
def _sparse_gather(rows=0, cols=0, embed=0, members=1, devices=1,
                   bytes_per=4):
    touched = float(rows) * cols * (embed + 1) * members
    # the ids' all_gather (4 B ints), the table reads and the scatter
    return {"flops": 2.0 * touched,
            "bytes_accessed": float(rows) * cols * 4 * devices
            + 2.0 * touched * bytes_per}


def _shard_update(table_elems=0, members=1, steps=1, bytes_per=4):
    # an Adam-shaped bound: ~10 operations an element, p, m, v read and
    # written once
    elems = float(table_elems) * members * steps
    return {"flops": 10.0 * elems, "bytes_accessed": 6.0 * elems * bytes_per}


def _register_cost_models() -> None:
    """Analytic records for the sparse gather and the sharded update (the
    reference's names; per-call totals over members and ranks)."""
    obs.register_cost_model("wdl.sparse_gather", _sparse_gather)
    obs.register_cost_model("wdl.shard_update", _shard_update)


_register_cost_models()


def record_shard_gauges(plane: WDLShardPlane, precision: str,
                        hash_buckets: int = 0, hashed_cols: int = 0) -> None:
    """The sharded run's set-up gauges (no-ops with telemetry off)."""
    if not obs.enabled():
        return
    obs.gauge("wdl.shard_devices").set(float(plane.d))
    obs.gauge("wdl.shard_table_bytes").set(
        float(plane.table_bytes_per_device(precision)))
    obs.gauge("wdl.hash_buckets").set(float(hash_buckets))
    obs.gauge("wdl.hashed_cols").set(float(hashed_cols))


def record_epoch_launches(plane: WDLShardPlane, rows: int, steps: int,
                          precision: str = "f32") -> None:
    """One epoch's sparse gathers and sharded updates as cost records."""
    spec = plane.spec
    bytes_per = 4 if precision == "f32" else 2
    embed = spec.embed_dim if spec.deep_enable else 0
    obs.record_model_launch(
        "wdl.sparse_gather", rows=int(rows), cols=len(plane.cards),
        embed=embed, members=plane.bags, devices=plane.d,
        bytes_per=bytes_per)
    elems = sum(vp * embed + vp for vp in plane.vp)
    obs.record_model_launch(
        "wdl.shard_update", table_elems=int(elems), members=plane.bags,
        steps=int(steps), bytes_per=bytes_per)


# ---------------------------------------------------------------- serving
def serve_devices(device: torch.device) -> List[torch.device]:
    """The cards a ``sharded`` copy spans: every visible card when the
    scoring device is a card, else the scoring device alone."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def resolve_serve_mode(spec, devices: Sequence[torch.device]) -> str:
    """The serving copy for one model: the knob wins; ``auto`` picks
    ``sharded`` only with more than one card and tables past
    ``shifu.wdl.shardMinBytes``, else ``full``."""
    if not spec.cat_cardinalities:
        return "full"
    mode = serve_copy_mode()
    if mode != "auto":
        return mode
    if len(devices) > 1 and table_param_bytes(spec) >= shard_min_bytes():
        return "sharded"
    return "full"


def _hot_params(spec, params, k: int):
    """The lossy hot copy: (spec, params) with each column's first ``k``
    rows exact and one mean-of-tail row where the column has more than
    ``k + 1``; the spec's cardinalities shrink with the tables, so the
    forward's clip sends every cold id to the tail row."""
    cards = [int(c) for c in spec.cat_cardinalities]
    off = spec.row_offsets()
    hot_cards = [c if c <= k + 1 else k + 1 for c in cards]

    def squash(t):
        parts = []
        for i, c in enumerate(cards):
            col = t[int(off[i]):int(off[i + 1])]
            if c > k + 1:
                col = torch.cat([col[:k], col[k:].mean(dim=0,
                                                       keepdim=True)])
            parts.append(col)
        return torch.cat(parts)
    out = dict(params)
    for name in _TABLES:
        if name in params:
            out[name] = squash(params[name])
    return dataclasses.replace(spec, cat_cardinalities=hot_cards), out


def build_serve_forward(spec, params, device,
                        devices: Optional[Sequence[torch.device]] = None):
    """The serving copy of one WDL model, built once at swap time:
    ``(mode, fn)`` with ``fn(x_num, x_cat) -> [N, 1]`` probabilities over
    tensors on ``device`` (``x_cat`` the raw bin ids; hashed columns fold
    first), or ``(mode, None)`` for the replicated copy.

    ``sharded`` splits the tables over ``devices`` (default
    :func:`serve_devices`) in the trainer's layout: a shard resolves the
    ids against its rows (a masked lookup), the shards' rows come to the
    scoring device and sum there in rank order (one nonzero a cell, so
    bit for bit the replicated lookup), then the one dense half.  Every
    op has a fixed shape, so it captures inside a bucket rung's graph
    where every shard lies on the scoring card (one card, or shards
    emulated on one device).  Shards on other cards would run on streams
    a rung's capture does not hold, so a copy over several cards is not
    built: ``auto`` keeps the replicated copy there and an explicit
    ``sharded`` raises ``NotImplementedError``."""
    devices = list(devices) if devices is not None else \
        serve_devices(device)
    mode = resolve_serve_mode(spec, devices)
    if mode == "sharded" and len(set(devices)) > 1:
        if serve_copy_mode() == "auto":
            log.warning("WDL serve copy: the tables are past "
                        "shifu.wdl.shardMinBytes, but a copy over %d cards "
                        "cannot be captured in a rung's graph; serving the "
                        "replicated copy", len(set(devices)))
            return "full", None
        raise NotImplementedError(
            "shifu.wdl.serveCopy=sharded over more than one card: each "
            "shard's lookup would run outside the scoring card's captured "
            "graph (ROADMAP Queue 1, a multi-card serving copy); serve "
            "with serveCopy=full or hot, or on one card")
    if mode == "full":
        return mode, None
    if mode == "hot":
        hspec, hparams = _hot_params(spec, params, max(1, serve_hot_rows()))
        hot = wdl_model.IndependentWDLModel(hspec, hparams)
        hot.on(device)
        log.info("WDL serve copy: hot (%d head rows exact)",
                 max(1, serve_hot_rows()))
        return mode, hot.forward_device
    d = len(devices)
    plane = WDLShardPlane(None, spec, d=d)
    shards = [(dev, {k: plane.shard(k, params[k], r).to(dev)
                     for k in _TABLES if k in params})
              for r, dev in enumerate(devices)]
    from ..train.optimizers import tree_map
    dense = tree_map(lambda t: t.to(device),
                     {k: v for k, v in params.items() if k not in _TABLES})
    hplan = wdl_model.hash_plan_on(spec, device)
    plane._consts(device)                   # made here, not in a capture

    def lookup(name, x_cat) -> torch.Tensor:
        """Each shard's masked lookup, summed on ``device`` in rank
        order."""
        acc = None
        for r, (dev, tabs) in enumerate(shards):
            lid, owned = plane.local_ids(x_cat, r)
            rows = masked_rows(tabs[name], lid.to(dev), owned.to(dev),
                               False).to(device)
            acc = rows if acc is None else acc + rows
        return acc

    def fwd(x_num, x_cat):
        x_cat = wdl_model.apply_hash_device(spec, x_cat, hplan)
        emb = lookup("embed", x_cat) if spec.deep_enable else None
        wrows = lookup("wide_cat", x_cat) if spec.wide_enable else None
        with torch.no_grad():
            return torch.sigmoid(wdl_model.logits_from_rows(
                dense, spec, x_num.float(), emb, wrows, len(x_cat)))
    if obs.enabled():
        obs.gauge("wdl.serve_shard_devices").set(float(d))
    log.info("WDL serve copy: sharded over %d device(s)", d)
    return mode, fwd
