"""Fused raw-record transform — the norm pipeline as torch ops on the
scorer's device (the port of ``shifu_tpu.serve.transform``).

Per-column constant tables are built once from the ColumnConfig snapshot;
per request, host code parses strings to floats (and categoricals to bin
ids) into a packed wire array, and :meth:`FusedTransform.apply_device`
runs searchsorted / gather / clip-affine math on the device:

- every bin-index-only norm family (WoE, posrate/zscale categoricals,
  DISCRETE, INDEX) collapses to ONE f64 table evaluated on host by the
  offline code itself (``NormalizedColumn.bin_value_table``), so the device
  op is a plain gather;
- value-carrying families (ZSCALE/ZSCORE/HYBRID numerics, ASIS) run the
  clip/affine with host-precomputed f64 bounds;
- numeric binning is ``searchsorted(boundaries, v, right=True) - 1`` with
  the same clip and missing -> num_bins fill as ``ColumnBinner``;
- categorical string -> index runs on host through ``ColumnBinner``.

The compute dtype is a constructor argument: ``float32`` (the default)
matches the reference CLI, ``float64`` matches the reference under x64
(its test rig), where the wire is f64 too.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.model_config import NormType, PrecisionType

#: coded per-record rejection reasons (one malformed record fails ITS OWN
#: slot, never the batch)
ERR_BAD_RECORD = "bad_record"
ERR_BAD_FIELD = "bad_field"

_TABLE_TYPES = (
    NormType.WOE, NormType.WEIGHT_WOE, NormType.WOE_INDEX,
    NormType.WOE_ZSCORE, NormType.WOE_ZSCALE,
    NormType.WEIGHT_WOE_ZSCORE, NormType.WEIGHT_WOE_ZSCALE,
    NormType.WOE_ZSCALE_INDEX,
    NormType.DISCRETE_ZSCORE, NormType.DISCRETE_ZSCALE,
)


@dataclass
class _ColumnPlan:
    """One input column's host+device recipe."""
    name: str
    categorical: bool
    mode: str                      # onehot | table | asis | zscore
    width: int
    num_bins: int                  # binner bins; invalid/missing -> num_bins
    binner: Any = None             # ColumnBinner (host side)
    boundaries: Optional[np.ndarray] = None   # numeric split points (f64)
    table: Optional[np.ndarray] = None        # fused bin->value map (f64)
    mean: float = 0.0
    std: float = 1.0
    lo: float = 0.0                # z-score clip bounds (host f64 math)
    hi: float = 0.0
    zero: bool = False             # std ~ 0: the offline path emits zeros


class FusedTransform:
    """ColumnConfig snapshot -> packed wire format -> (x, bins) on device.

    Wire format: one ``[n, 3*C]`` float array per request —
    ``vals | valid | bin-idx`` column triples — so the micro-batcher pads
    raw rows like any other and a zero row decodes as all-missing.
    """

    def __init__(self, model_config, column_configs,
                 columns: Optional[Sequence] = None,
                 dtype: torch.dtype = torch.float32):
        from ..data.transform import model_input_columns
        from ..ops.binning import ColumnBinner
        from ..ops.normalize import NormalizedColumn

        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"compute dtype must be float32 or float64, "
                             f"got {dtype}")
        self.mc = model_config
        self.dtype = dtype
        self.norm_type = model_config.normalize.normType
        self.cutoff = model_config.normalize.stdDevCutOff
        self.precision = model_config.normalize.precisionType
        self.missing_values = list(
            model_config.dataSet.missingOrInvalidValues or [])
        cols = list(columns) if columns is not None else \
            model_input_columns(model_config, column_configs)
        if not cols:
            raise ValueError("no input columns with binning stats — the "
                             "raw path needs the stats+norm snapshot")
        self.plan: List[_ColumnPlan] = [self._plan_column(
            cc, NormalizedColumn(cc, self.norm_type, self.cutoff),
            ColumnBinner) for cc in cols]
        self.width = sum(p.width for p in self.plan)
        # onehot columns emit >1 output column; the grouped device path
        # assumes width 1 everywhere, so they route through the per-column
        # path
        self._has_onehot = any(p.mode == "onehot" for p in self.plan)
        self._build_groups()
        self._consts: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    # ------------------------------------------------------------- build
    def _plan_column(self, cc, nc, ColumnBinner) -> _ColumnPlan:
        cat = cc.is_categorical()
        t = self.norm_type
        if cat:
            binner = ColumnBinner(categories=cc.bin_category or [])
            boundaries = None
        else:
            binner = ColumnBinner(boundaries=np.asarray(cc.bin_boundary)) \
                if cc.bin_boundary else None
            boundaries = None if binner is None else binner.boundaries
        nb = binner.num_bins if binner is not None else 1
        onehot = t == NormType.ONEHOT or \
            (t == NormType.ZSCALE_ONEHOT and cat)
        p = _ColumnPlan(name=cc.columnName, categorical=cat, mode="zscore",
                        width=nc.width, num_bins=nb, binner=binner,
                        boundaries=boundaries)
        if onehot:
            p.mode = "onehot"
        elif cat or t in _TABLE_TYPES:
            p.mode = "table"
            p.table = nc.bin_value_table(nb)
        elif t in (NormType.ASIS_WOE, NormType.ASIS_PR):
            p.mode = "asis"
            p.mean = float(cc.mean())
        else:
            # ZSCALE/ZSCORE/OLD_*/HYBRID*/ZSCALE_ONEHOT-numeric/*_INDEX-numeric
            mean, std = float(cc.mean()), cc.std_dev()
            p.mean = mean
            if std is None or std < 1e-5:
                p.zero = True
            else:
                p.std = float(std)
                p.lo = mean - self.cutoff * float(std)
                p.hi = mean + self.cutoff * float(std)
        return p

    @classmethod
    def from_dir(cls, model_set_dir: str,
                 dtype: torch.dtype = torch.float32) -> "FusedTransform":
        """Build from a model-set directory's config snapshot."""
        from ..config import ModelConfig, load_column_configs
        mc = ModelConfig.load(os.path.join(model_set_dir,
                                           "ModelConfig.json"))
        ccs = load_column_configs(os.path.join(model_set_dir,
                                               "ColumnConfig.json"))
        return cls(mc, ccs, dtype=dtype)

    # -------------------------------------------------------------- wire
    @property
    def n_columns(self) -> int:
        return len(self.plan)

    @property
    def wire_width(self) -> int:
        return 3 * len(self.plan)

    @property
    def wire_dtype(self) -> np.dtype:
        return np.dtype(np.float64 if self.dtype == torch.float64
                        else np.float32)

    def parse_records(self, records: Sequence[Any]
                      ) -> Tuple[np.ndarray, np.ndarray, List[Dict]]:
        """JSON records -> (packed [m, 3C], kept row indices, errors).

        A malformed record (non-object, or a non-scalar field value) is
        rejected ALONE with a coded error; parseable records around it
        still score.  Unparseable numeric STRINGS are not malformed — they
        are missing/invalid values and norm to the missing semantics.
        """
        from ..data.reader import parse_numeric, record_field_str
        errors: List[Dict] = []
        kept: List[int] = []
        for i, rec in enumerate(records):
            if not isinstance(rec, dict):
                errors.append({"index": i, "code": ERR_BAD_RECORD,
                               "error": "record must be an object of "
                                        "{field: value}"})
                continue
            bad = next((k for k, v in rec.items() if v is not None and
                        not isinstance(v, (str, int, float, bool))), None)
            if bad is not None:
                errors.append({"index": i, "code": ERR_BAD_FIELD,
                               "error": f"field {bad!r} must be a scalar "
                                        "value"})
                continue
            kept.append(i)
        c = len(self.plan)
        packed = np.zeros((len(kept), 3 * c), self.wire_dtype)
        if kept:
            for j, p in enumerate(self.plan):
                vals = [record_field_str(records[i].get(p.name))
                        for i in kept]
                if p.categorical:
                    packed[:, 2 * c + j] = p.binner.bin_categorical(vals)
                    packed[:, c + j] = 1.0
                else:
                    f, valid = parse_numeric(vals, self.missing_values)
                    packed[:, j] = np.where(valid, f, 0.0)
                    packed[:, c + j] = valid
        return packed, np.asarray(kept, np.int64), errors

    def _build_groups(self) -> None:
        """Host-side column groups for the batched device path: same-mode
        columns run as single ops — one batched searchsorted over padded
        boundaries, one padded table gather, one broadcast z-score — with
        the same elementwise IEEE ops and a value-preserving column
        permutation at the end."""
        z_idx: List[int] = []    # zscore/zero columns (width 1)
        t_idx: List[int] = []    # non-empty fused tables
        t0_idx: List[int] = []   # empty tables -> zeros
        a_idx: List[int] = []    # asis passthrough
        bc_idx: List[int] = []   # bins: categorical (wire passthrough)
        bn_idx: List[int] = []   # bins: numeric with boundaries
        bu_idx: List[int] = []   # bins: numeric without a binner
        for j, p in enumerate(self.plan):
            (bc_idx if p.categorical else
             bn_idx if p.boundaries is not None else bu_idx).append(j)
            if p.mode == "onehot":
                continue
            if p.mode == "table":
                (t_idx if len(p.table) else t0_idx).append(j)
            elif p.mode == "asis":
                a_idx.append(j)
            else:
                z_idx.append(j)
        pl = self.plan
        self._z_idx = np.asarray(z_idx, np.int64)
        self._z_mean = np.asarray([pl[j].mean for j in z_idx], np.float64)
        self._z_std = np.asarray([pl[j].std for j in z_idx], np.float64)
        self._z_lo = np.asarray([pl[j].lo for j in z_idx], np.float64)
        self._z_hi = np.asarray([pl[j].hi for j in z_idx], np.float64)
        self._z_zero = np.asarray([pl[j].zero for j in z_idx], bool)
        self._t_idx = np.asarray(t_idx, np.int64)
        self._t_len = np.asarray([len(pl[j].table) for j in t_idx],
                                 np.int64)
        tmax = int(self._t_len.max()) if t_idx else 0
        self._t_tab = np.zeros((len(t_idx), tmax), np.float64)
        for k, j in enumerate(t_idx):
            self._t_tab[k, :len(pl[j].table)] = pl[j].table
        self._t0_idx = np.asarray(t0_idx, np.int64)
        self._a_idx = np.asarray(a_idx, np.int64)
        self._a_mean = np.asarray([pl[j].mean for j in a_idx], np.float64)
        self._bc_idx = np.asarray(bc_idx, np.int64)
        self._bn_idx = np.asarray(bn_idx, np.int64)
        self._bn_nb = np.asarray([pl[j].num_bins for j in bn_idx],
                                 np.int64)
        bmax = max((len(pl[j].boundaries) for j in bn_idx), default=0)
        # +inf pad: finite values always insert before the pad, so the
        # padded searchsorted returns the unpadded column's index
        self._bn_bounds = np.full((len(bn_idx), bmax), np.inf, np.float64)
        for k, j in enumerate(bn_idx):
            self._bn_bounds[k, :len(pl[j].boundaries)] = pl[j].boundaries
        self._bu_idx = np.asarray(bu_idx, np.int64)
        if not self._has_onehot:
            self._x_inv = np.argsort(
                np.concatenate([self._z_idx, self._t_idx, self._t0_idx,
                                self._a_idx]))
        self._bin_inv = np.argsort(
            np.concatenate([self._bc_idx, self._bn_idx, self._bu_idx]))

    def _device_consts(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The group constants as tensors on ``device`` (float ones in the
        compute dtype), made once per device."""
        got = self._consts.get(device)
        if got is not None:
            return got
        cd = self.dtype
        floats = ("_z_mean", "_z_std", "_z_lo", "_z_hi", "_t_tab",
                  "_a_mean", "_bn_bounds")
        ints = ("_z_idx", "_t_idx", "_t_len", "_t0_idx", "_a_idx",
                "_bc_idx", "_bn_idx", "_bn_nb", "_bu_idx", "_bin_inv") \
            + (() if self._has_onehot else ("_x_inv",))
        got = {k: torch.tensor(getattr(self, k), dtype=cd, device=device)
               for k in floats}
        got.update({k: torch.from_numpy(getattr(self, k)).to(device)
                    for k in ints})
        got["_z_zero"] = torch.from_numpy(self._z_zero).to(device)
        self._consts[device] = got
        return got

    # ------------------------------------------------------------ device
    def apply_device(self, packed: torch.Tensor, need_x: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Packed wire rows (a tensor on the scoring device) -> (x
        [n, width] f32, bins [n, C] int32), the whole norm transform as
        batched torch ops; onehot plans take the per-column path.  With
        ``need_x=False`` (a consumer of bins only, such as a tree
        ensemble) x comes back as an empty [n, 0] tensor and none of its
        ops run."""
        if self._has_onehot:
            return self._apply_device_cols(packed, need_x)
        k = self._device_consts(packed.device)
        cd = self.dtype
        c = len(self.plan)
        n = packed.shape[0]
        vals = packed[:, :c].to(cd)
        valid = packed[:, c:2 * c] != 0
        cats = packed[:, 2 * c:3 * c].to(torch.int32)

        bin_blocks = []
        if len(self._bc_idx):
            bin_blocks.append(cats[:, k["_bc_idx"]])
        if len(self._bn_idx):
            v, ok = vals[:, k["_bn_idx"]], valid[:, k["_bn_idx"]]
            idx = torch.searchsorted(k["_bn_bounds"], v.T.contiguous(),
                                     right=True).T - 1
            nb = k["_bn_nb"][None, :]
            idx = torch.minimum(idx.clamp(min=0), nb - 1)
            bin_blocks.append(torch.where(ok, idx, nb).to(torch.int32))
        if len(self._bu_idx):
            bin_blocks.append(
                torch.where(valid[:, k["_bu_idx"]], 0, 1).to(torch.int32))
        binm = bin_blocks[0] if len(bin_blocks) == 1 else \
            torch.cat(bin_blocks, dim=1)
        bins = binm[:, k["_bin_inv"]]
        if not need_x:
            return packed.new_zeros((n, 0), dtype=torch.float32), bins

        x_blocks = []
        if len(self._z_idx):
            v, ok = vals[:, k["_z_idx"]], valid[:, k["_z_idx"]]
            mean = k["_z_mean"][None, :]
            filled = torch.where(ok, v, mean)
            z = (torch.minimum(torch.maximum(filled, k["_z_lo"][None, :]),
                               k["_z_hi"][None, :]) - mean) \
                / k["_z_std"][None, :]
            x_blocks.append(torch.where(k["_z_zero"][None, :],
                                        torch.zeros((), dtype=cd,
                                                    device=z.device), z))
        if len(self._t_idx):
            idx = torch.minimum(bins[:, k["_t_idx"]].long().clamp(min=0),
                                k["_t_len"][None, :] - 1)
            cols = torch.arange(len(self._t_idx), device=idx.device)
            x_blocks.append(k["_t_tab"][cols[None, :], idx])
        if len(self._t0_idx):
            x_blocks.append(torch.zeros((n, len(self._t0_idx)), dtype=cd,
                                        device=packed.device))
        if len(self._a_idx):
            v, ok = vals[:, k["_a_idx"]], valid[:, k["_a_idx"]]
            x_blocks.append(torch.where(ok, v, k["_a_mean"][None, :]))
        xm = x_blocks[0] if len(x_blocks) == 1 else \
            torch.cat(x_blocks, dim=1)
        x = self._apply_precision(xm[:, k["_x_inv"]])
        return x.to(torch.float32), bins

    def _apply_device_cols(self, packed: torch.Tensor, need_x: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-column path (onehot plans: output widths vary)."""
        cd = self.dtype
        dev = packed.device
        c = len(self.plan)
        n = packed.shape[0]
        vals = packed[:, :c].to(cd)
        valid = packed[:, c:2 * c] != 0
        cats = packed[:, 2 * c:3 * c].to(torch.int32)
        outs, bin_cols = [], []
        for j, p in enumerate(self.plan):
            v, ok = vals[:, j], valid[:, j]
            if p.categorical:
                bidx = cats[:, j]
            elif p.boundaries is not None:
                bounds = torch.tensor(p.boundaries, dtype=cd, device=dev)
                idx = torch.searchsorted(bounds, v.contiguous(),
                                         right=True) - 1
                idx = idx.clamp(0, p.num_bins - 1)
                bidx = torch.where(ok, idx, p.num_bins).to(torch.int32)
            else:
                bidx = torch.where(ok, 0, 1).to(torch.int32)
            bin_cols.append(bidx)
            if not need_x:
                continue
            if p.mode == "onehot":
                idx = bidx.long().clamp(0, p.width - 1)
                outs.append(torch.nn.functional.one_hot(idx, p.width)
                            .to(cd))
            elif p.mode == "table":
                if len(p.table) == 0:
                    outs.append(torch.zeros((n, 1), dtype=cd, device=dev))
                else:
                    tab = torch.tensor(p.table, dtype=cd, device=dev)
                    outs.append(tab[bidx.long().clamp(0, len(p.table) - 1)]
                                [:, None])
            elif p.mode == "asis":
                outs.append(torch.where(ok, v, p.mean)[:, None])
            elif p.zero:
                outs.append(torch.zeros((n, 1), dtype=cd, device=dev))
            else:            # zscore: clip to host-precomputed bounds
                filled = torch.where(ok, v, p.mean)
                z = (filled.clamp(p.lo, p.hi) - p.mean) / p.std
                outs.append(z[:, None])
        bins = torch.stack(bin_cols, dim=1)
        if not need_x:
            return packed.new_zeros((n, 0), dtype=torch.float32), bins
        x = self._apply_precision(torch.cat(outs, dim=1))
        return x.to(torch.float32), bins

    def _apply_precision(self, x: torch.Tensor) -> torch.Tensor:
        """Device twin of ``ops.normalize.apply_precision``."""
        if self.precision == PrecisionType.FLOAT7:
            return torch.round(x, decimals=7)
        if self.precision == PrecisionType.FLOAT16:
            return x.to(torch.float16).to(self.dtype)
        if self.precision == PrecisionType.FLOAT32:
            return x.to(torch.float32).to(self.dtype)
        return x
