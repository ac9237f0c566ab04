"""Port parity for the stats side of ``ops/binning.py``, ``ops/sketches.py``
and ``ops/stats_math.py``: the port's accumulators, sketches and stats
math on CPU tensors against ``shifu_tpu``'s on the same numpy-seeded
inputs.

Tolerances: counts, boundaries, percentiles, distinct counts, HLL
registers and frequent items are equal.  Weighted per-bin sums agree
within 1e-6 relative (f32 sums in another order), the moments within 1e-5
relative (f32 chunk sums in another order, combined in f64 alike).
"""

import numpy as np
import pandas as pd
import pytest

from shifu_tpu.config.model_config import BinningMethod as JMethod
from shifu_tpu.ops import binning as jb
from shifu_tpu.ops import sketches as js
from shifu_tpu.ops import stats_math as jm
from shifu_tpu_torch.config.model_config import BinningMethod
from shifu_tpu_torch.ops import binning as pb
from shifu_tpu_torch.ops import sketches as ps
from shifu_tpu_torch.ops import stats_math as pm

pytestmark = pytest.mark.torch_port


def _data(seed, n=6000, c=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c)) * 10
    x[:, 1] = np.round(x[:, 1])              # few distinct values
    x[:, 2] = rng.exponential(size=n)        # skewed
    valid = rng.random((n, c)) > 0.08
    valid[:, 3] = False                      # all missing
    x[~valid] = np.nan
    y = (rng.random(n) < 0.35).astype(float)
    w = rng.uniform(0.5, 2.0, n)
    return x, valid, y, w


def _run(mod, mode, x, valid, y, w, unit_weight, chunk=2000, **kw):
    acc = mod.NumericAccumulator(n_cols=x.shape[1], unit_weight=unit_weight,
                                 num_buckets=kw.pop("num_buckets", 4096),
                                 **kw)
    parts = [slice(s, s + chunk) for s in range(0, len(x), chunk)]
    if mode == "two_pass":
        for p in parts:
            acc.update_moments(x[p], valid[p])
        acc.finalize_range()
        for p in parts:
            acc.update_histogram(x[p], valid[p], y[p], w[p])
    else:
        for p in parts:
            acc.update_fused(x[p], valid[p], y[p], w[p])
        acc.finalize_fused()
    return acc


def _assert_same_sketch(a, b):
    (ba, aa, pa, da), (bb, ab, pb_, db) = a, b
    for c in range(len(ba)):
        np.testing.assert_array_equal(ba[c], bb[c])
        np.testing.assert_array_equal(aa[c][:, :2], ab[c][:, :2])
        np.testing.assert_allclose(aa[c], ab[c], rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(pa, pb_)
    np.testing.assert_array_equal(da, db)


def _assert_same_moments(p, j):
    for k in ("count", "min", "max"):
        np.testing.assert_array_equal(p.moments[k], j.moments[k])
    for k in ("mean", "M2", "M3", "M4"):
        np.testing.assert_allclose(p.moments[k], j.moments[k], rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(p.missing, j.missing)


# fused with every chunk resident; fused where 1 of 3 chunks stays and 2
# overflow into the provisional grid; the two-pass sweep; a drain every
# 2 chunks (the exact f64 host finalize)
@pytest.mark.parametrize("mode,budget,drain", [
    ("fused", 1 << 30, None), ("fused", 2000 * (5 * 5 + 8), None),
    ("two_pass", 1 << 30, None), ("fused", 1 << 30, 4000),
    ("two_pass", 1 << 30, 4000)])
@pytest.mark.parametrize("unit_weight", [True, False])
def test_numeric_accumulator_matches_reference(mode, budget, drain,
                                               unit_weight, monkeypatch):
    x, valid, y, w = _data(11)
    if drain:
        monkeypatch.setattr(jb.NumericAccumulator, "DRAIN_ROWS", drain)
        monkeypatch.setattr(pb.NumericAccumulator, "DRAIN_ROWS", drain)
    kw = {"fused_budget": budget}
    p = _run(pb, mode, x, valid, y, w, unit_weight, **kw)
    j = _run(jb, mode, x, valid, y, w, unit_weight, **kw)
    assert (p.hist is not None) == bool(drain) == (j.hist is not None)
    _assert_same_moments(p, j)
    _assert_same_sketch(p.finalize_sketch(BinningMethod.EqualPositive, 10),
                        j.finalize_sketch(JMethod.EqualPositive, 10))


@pytest.mark.parametrize("method", list(BinningMethod))
def test_finalize_sketch_every_method(method):
    x, valid, y, w = _data(5, n=4000)
    p = _run(pb, "fused", x, valid, y, w, False)
    j = _run(jb, "fused", x, valid, y, w, False)
    _assert_same_sketch(p.finalize_sketch(method, 10),
                        j.finalize_sketch(JMethod(method.value), 10))


@pytest.mark.parametrize("num_buckets", [64, 192])
def test_zero_measure_and_all_missing_columns(num_buckets):
    """No positives under EqualPositive: the single-bin shape; an
    all-missing column: NaN percentiles, every row in the missing bin."""
    rng = np.random.default_rng(3)
    n = 2000
    x = rng.normal(size=(n, 2))
    valid = np.ones((n, 2), bool)
    valid[:, 1] = False
    y = np.zeros(n)
    outs = []
    for mod, method in ((pb, BinningMethod.EqualPositive),
                        (jb, JMethod.EqualPositive)):
        acc = _run(mod, "two_pass", x, valid, y, np.ones(n), True,
                   num_buckets=num_buckets)
        outs.append(acc.finalize_sketch(method, 8))
    bnds, aggs, pct, _ = outs[0]
    assert len(bnds[0]) == 1 and bnds[0][0] == float("-inf")
    assert aggs[0].shape == (2, 4) and aggs[0][0, 1] == n
    assert np.isnan(pct[1]).all() and aggs[1][-1, :2].sum() == n
    _assert_same_sketch(*outs)


def test_accumulator_refuses_misaligned_buckets():
    with pytest.raises(ValueError, match="multiple of 64"):
        pb.NumericAccumulator(n_cols=2, num_buckets=100)


def test_categorical_accumulator_matches_reference():
    rng = np.random.default_rng(2)
    cats = np.array(["US", " GB", "FR ", "", "?", "de", "DE", "ü"], object)
    p, j = pb.CategoricalAccumulator(), jb.CategoricalAccumulator()
    for chunk in range(3):
        n = 500
        vals = cats[rng.integers(0, len(cats), n)]
        valid = np.array([v.strip() not in ("", "?") for v in vals])
        y = (rng.random(n) < 0.3).astype(float)
        w = rng.uniform(0.5, 2, n)
        for acc in (p, j):
            acc.update("c", vals, valid, y, w)
    for cap in (0, 3):
        a, b = p.finalize("c", cap), j.finalize("c", cap)
        assert a[0] == b[0] and a[2:] == b[2:]
        np.testing.assert_allclose(a[1], b[1], rtol=1e-12)


def test_stats_math_matches_reference():
    rng = np.random.default_rng(4)
    neg = rng.integers(0, 50, size=(3, 9)).astype(float)
    pos = rng.integers(0, 20, size=(3, 9)).astype(float)
    pos[1] = 0
    a, b = pm.column_metrics(neg, pos), jm.column_metrics(neg, pos)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(pm.pos_rate(pos[0], neg[0]),
                                  jm.pos_rate(pos[0], neg[0]))
    assert pm.psi(neg[0], pos[0]) == jm.psi(neg[0], pos[0])
    assert pm.merge_adjacent_by_iv(neg[0], pos[0], 4, 0.95, 0) == \
        jm.merge_adjacent_by_iv(neg[0], pos[0], 4, 0.95, 0)


AWKWARD = ["", "a", "é", "日本", "x" * 7, "y" * 8, "z" * 9, "ab\x00", "\x00",
           "q" * 16, "q" * 17, "🙂" * 3, "abc def"]


def test_hash_strings_equal_pandas():
    rng = np.random.default_rng(0)
    big = ["".join(rng.choice(list("ab日x\x01 "), rng.integers(0, 30)))
           for _ in range(3000)]
    for vals in (AWKWARD, big):
        want = pd.util.hash_array(np.asarray(vals, dtype=object),
                                  categorize=False)
        np.testing.assert_array_equal(ps.hash_strings(vals), want)


@pytest.mark.parametrize("kind", [
    "unique_ids", "tied_low_card", "mixed", "distinct_unique_ids",
    "distinct_tied_low_card", "distinct_mixed", "distinct_ascii"])
@pytest.mark.parametrize("cap", [4, 4096])
def test_sketches_match_reference(kind, cap):
    """Registers, counts and their order equal the reference's over four
    chunks (ties, and a cap-4 prune).  The ``distinct_`` kinds feed the
    port as ``init`` does: one ``np.unique`` over each chunk's ``S`` view
    shared by both sketches (``update_distinct``), or the object path for
    a chunk without one (NUL bytes, non-ASCII)."""
    from shifu_tpu_torch.data.cells import distinct, stripped_cells
    rng = np.random.default_rng(len(kind) + cap)
    pf, jf = ps.FrequentItems(cap=cap), js.FrequentItems(cap=cap)
    ph, jh = ps.HyperLogLog(), js.HyperLogLog()
    shared = kind.startswith("distinct_")
    base = kind[len("distinct_"):] if shared else kind
    for chunk in range(4):
        if base == "unique_ids":
            batch = [str(v) for v in range(chunk * 1500, chunk * 1500 + 1500)]
        elif base == "tied_low_card":
            batch = list(rng.choice(list("gfedcba"), 70))
        elif base == "ascii":
            batch = list(rng.choice(["", "a", "ab", "b a", "x" * 9, "10",
                                     "2", "-0", "1.50"], 60))
        else:
            batch = list(rng.choice(AWKWARD, 40)) + \
                [str(v) for v in rng.integers(0, 10, 30)]
        arr = np.asarray(batch, dtype=object)
        for acc in (jf, jh):
            acc.update(arr)
        cells = stripped_cells([str(v) for v in batch]) if shared else None
        d = distinct(cells) if cells is not None else None
        for acc in (pf, ph):
            if d is None:
                acc.update(arr)
            else:
                acc.update_distinct(d)
        assert list(pf.counts.items()) == list(jf.counts.items())
        assert pf.top() == jf.top()
    np.testing.assert_array_equal(ph.regs, jh.regs)
    assert ph.estimate() == jh.estimate()


def test_range_sketch_matches_reference():
    p, j = ps.RangeSketch(3), js.RangeSketch(3)
    for mn, mx in (([0, np.inf, 5], [1, -np.inf, 5]), ([-2, np.inf, 5],
                                                       [0.5, -np.inf, 5])):
        p.update(mn, mx)
        j.update(mn, mx)
    for u, v in zip(p.provisional_bounds(), j.provisional_bounds()):
        np.testing.assert_array_equal(u, v)
