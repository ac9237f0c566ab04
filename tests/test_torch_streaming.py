"""Port parity for the out-of-core data plane: ``shifu_tpu_torch.data.
streaming`` (``ShardStream``, ``ResidentCache``, the hash masks),
``data.spill.SpillWriter`` and ``ops.hashing`` against ``shifu_tpu`` on the
same numpy-seeded shards.

Tolerance 0 throughout: windows (indices, ``n_valid``, ``rows``, arrays,
dtypes, ``src``), the spill files on disk, the resident/tail split of a
budget, the mask matrices and every hashed bag are bit-equal.
"""

import json
import os

import numpy as np
import pytest
import torch

from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch.config import environment

pytestmark = pytest.mark.torch_port

N, C, B = 1100, 6, 8


@pytest.fixture(autouse=True)
def _clean_env():
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    yield
    environment.reset_for_tests()
    j_environment.reset_for_tests()


def _data(n=N, seed=3):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B - 1, size=(n, C)).astype(np.int16)
    y = (rng.random(n) < 0.3).astype(np.float32)
    w = rng.integers(1, 4, n).astype(np.float32)
    return bins, y, w


def _write_npz(d, bins, y, w, shard_rows=(300, 256, 0, 290, 254)):
    """npz shards of uneven sizes (an empty one among them) + schema."""
    os.makedirs(d, exist_ok=True)
    s = 0
    for i, r in enumerate(shard_rows):
        np.savez(os.path.join(d, f"part-{i:05d}.npz"), bins=bins[s:s + r],
                 y=y[s:s + r], w=w[s:s + r])
        s += r
    assert s == len(y)
    with open(os.path.join(d, "schema.json"), "w") as f:
        json.dump({"columnNums": list(range(C)), "numRows": len(y)}, f)


def _write_wire(d, bins, y, w, shard_rows=(300, 256, 290, 254)):
    """The port's WireWriter output: uint8 bins, f32 y/w, wire schema."""
    from shifu_tpu_torch.data.spill import WireWriter, wire_dir
    keys = ["bins", "y", "w"]
    os.makedirs(d, exist_ok=True)
    ww = WireWriter(wire_dir(d, keys), keys,
                    {"bins": np.uint8, "y": np.float32, "w": np.float32},
                    {"bins": (C,)}, "sig-1")
    s = 0
    for r in shard_rows:
        ww.append({"bins": bins[s:s + r].astype(np.uint8), "y": y[s:s + r],
                   "w": w[s:s + r]})
        s += r
    ww.finish()
    with open(os.path.join(d, "schema.json"), "w") as f:
        json.dump({"columnNums": list(range(C)), "numRows": len(y),
                   "wire": True, "wireKeys": keys, "wireSignature": "sig-1",
                   "shardRows": list(shard_rows)}, f)


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    """Each package's copy of one npz plane, and one wire plane."""
    root = tmp_path_factory.mktemp("torch_streaming")
    bins, y, w = _data()
    out = {}
    for pkg in ("ref", "port"):
        _write_npz(str(root / f"npz_{pkg}"), bins, y, w)
        _write_wire(str(root / f"wire_{pkg}"), bins, y, w)
        out["npz", pkg] = str(root / f"npz_{pkg}")
        out["wire", pkg] = str(root / f"wire_{pkg}")
    out["root"] = root
    return out


def _stream(pkg, d, window, **kw):
    if pkg == "ref":
        from shifu_tpu.data.shards import Shards
        from shifu_tpu.data.streaming import ShardStream
    else:
        from shifu_tpu_torch.data.shards import Shards
        from shifu_tpu_torch.data.streaming import ShardStream
    return ShardStream(Shards.open(d), ("bins", "y", "w"), window, **kw)


def _windows(stream, *args):
    return [(w.start, w.n_valid, w.rows, w.src, w.index.tolist(),
             {k: (a.dtype.str, a.tobytes()) for k, a in w.arrays.items()})
            for w in stream.windows(*args)]


def _copy_tree(src, dst):
    import shutil
    shutil.copytree(src, dst)
    return dst


@pytest.mark.parametrize("window,ladder", [(256, 0), (300, 0), (256, 8),
                                           (2048, 0), (97, 0)])
def test_npz_windows_and_the_spill_match_the_reference(planes, tmp_path,
                                                       window, ladder):
    """The cold npz pass (which writes the spill through) and the mmap pass
    over the spill give the reference's windows, and the spill files on
    disk are the reference's bytes."""
    from shifu_tpu_torch.data.spill import spill_dir_for
    d = {pkg: _copy_tree(planes["npz", pkg], str(tmp_path / pkg))
         for pkg in ("ref", "port")}
    s = {pkg: _stream(pkg, d[pkg], window, remainder_multiple=ladder)
         for pkg in ("ref", "port")}
    cold = {pkg: _windows(s[pkg]) for pkg in s}
    assert cold["port"] == cold["ref"]
    sdir = {pkg: spill_dir_for(d[pkg], ("bins", "y", "w")) for pkg in d}
    for name in ("bins.raw", "y.raw", "w.raw"):
        with open(os.path.join(sdir["ref"], name), "rb") as a, \
                open(os.path.join(sdir["port"], name), "rb") as b:
            assert a.read() == b.read(), name
    mans = [json.load(open(os.path.join(sdir[p], "manifest.json")))
            for p in ("ref", "port")]
    for m in mans:
        m.pop("source")         # each pins its own files' mtimes
    assert mans[0] == mans[1]
    assert mans[1]["dtypes"]["bins"] == "|u1"
    warm = {pkg: _windows(s[pkg]) for pkg in s}
    assert warm["port"] == warm["ref"]
    assert [w[:5] for w in warm["port"]] == [w[:5] for w in cold["port"]]
    assert s["port"].bytes_read == s["ref"].bytes_read


@pytest.mark.parametrize("start", [(0, 0, 0), (1, 44, 344), (3, 0, 556),
                                   (4, 253, 1099), (1, 0, 300)])
@pytest.mark.parametrize("spill", [False, True])
def test_resumed_windows_match_the_reference(planes, tmp_path, start, spill):
    """``windows(shard, offset, row)`` from the middle of the plane, by the
    npz path (spill off) and by the spill's mmap path."""
    d = {pkg: _copy_tree(planes["npz", pkg], str(tmp_path / pkg))
         for pkg in ("ref", "port")}
    got = {}
    for pkg in d:
        st = _stream(pkg, d[pkg], 128, spill=spill)
        if spill:
            _windows(st)                       # the pass that writes it
        got[pkg] = _windows(st, *start)
    assert got["port"] == got["ref"]
    assert got["port"] and got["port"][0][0] == start[2]


@pytest.mark.parametrize("window,start", [(256, (0, 0, 0)), (300, (0, 0, 0)),
                                          (128, (2, 10, 566)),
                                          (4096, (0, 0, 0))])
def test_wire_windows_match_the_reference(planes, window, start):
    """A wire plane the port's WireWriter wrote streams by mmap in both
    packages, the same windows."""
    got = {pkg: _windows(_stream(pkg, planes["wire", pkg], window), *start)
           for pkg in ("ref", "port")}
    assert got["port"] == got["ref"]
    assert all(w[5]["bins"][0] == "|u1" for w in got["port"])


def _host_prepare(pkg):
    from importlib import import_module
    mod = import_module(("shifu_tpu" if pkg == "ref" else "shifu_tpu_torch")
                        + ".data.streaming")

    def prep(win):
        return mod.PreparedWindow(win.start, win.n_valid, win.rows,
                                  win.index, dict(win.arrays))
    return mod, prep


@pytest.mark.parametrize("budget_windows", [0, 1, 3, 9])
def test_resident_cache_splits_a_budget_as_the_reference(planes,
                                                         budget_windows):
    """The same budget keeps the same windows resident and starts the tail
    at the same (shard, offset, row); every later sweep re-streams only
    the tail, and disk_passes == 1 + tail_sweeps."""
    stats = {}
    for pkg in ("ref", "port"):
        mod, prep = _host_prepare(pkg)
        st = _stream(pkg, planes["wire", pkg], 128)
        row_bytes = C + 8
        cache = mod.ResidentCache(st, budget_windows * 128 * row_bytes + 5,
                                  prep, pipeline_depth=2)
        first = [(it.start, it.resident) for it in cache.items()]
        again = [(it.start, it.resident) for it in cache.items()]
        tail = [it.start for it in cache.tail_items()]
        assert cache.disk_passes == 1 + cache.tail_sweeps
        stats[pkg] = (first, again, tail, cache.tail, cache.resident_rows,
                      cache.disk_passes, cache.tail_sweeps, st.bytes_read)
    assert stats["port"] == stats["ref"]


def test_prepared_runs_the_consume_hook_on_the_consumer(planes):
    """``PreparedWindow.on_consume`` (the copy stream's sync) runs once,
    on the consumer's thread, when the consumer takes the window."""
    import threading
    from shifu_tpu_torch.data.streaming import PreparedWindow
    st = _stream("port", planes["wire", "port"], 256)
    seen = []

    def prep(win):
        it = PreparedWindow(win.start, win.n_valid, win.rows, win.index,
                            dict(win.arrays))
        it.on_consume = lambda: seen.append(threading.get_ident())
        return it
    for depth in (0, 2):
        seen.clear()
        items = list(st.prepared(prep, depth=depth))
        assert len(seen) == len(items) == 5
        assert set(seen) == {threading.get_ident()}
        assert all(it.on_consume is None for it in items)


def test_spill_budget_abort_is_permanent_as_in_the_reference(planes,
                                                             tmp_path):
    """A spill over ``shifu.stream.spillBudgetBytes`` aborts with a marker
    (the reference's manifest), and later passes stream npz without
    retrying; the windows stay the reference's."""
    got = {}
    for pkg, env in (("ref", j_environment), ("port", environment)):
        env.set_property("shifu.stream.spillBudgetBytes", "4000")
        d = _copy_tree(planes["npz", pkg], str(tmp_path / pkg))
        st = _stream(pkg, d, 256)
        a, b = _windows(st), _windows(st)
        man = json.load(open(os.path.join(
            d, ".spill_cache", "spill-bins-y-w", "manifest.json")))
        got[pkg] = (a, b, man["aborted"], st._spill_off)
    assert got["port"] == got["ref"]
    assert got["port"][3] is True


@pytest.mark.parametrize("seed,stream", [(0, 11), (7, 5000), (2 ** 33 + 5, 1000),
                                         (123, 101)])
def test_row_uniform_matches_the_reference(seed, stream):
    from shifu_tpu.data.streaming import row_uniform as ref
    from shifu_tpu_torch.data.streaming import row_uniform
    idx = np.concatenate([np.arange(5000), np.arange(2 ** 32 - 9, 2 ** 32 + 9)])
    np.testing.assert_array_equal(row_uniform(seed, stream, idx),
                                  ref(seed, stream, idx))


MASK_CASES = [
    dict(bags=1, valid_rate=0.2),
    dict(bags=3, valid_rate=0.2, sample_rate=0.7),
    dict(bags=3, valid_rate=0.1, sample_rate=1.0, replacement=True),
    dict(bags=2, valid_rate=0.2, sample_rate=0.8, replacement=True,
         up_sample_weight=3.0),
    dict(bags=4, valid_rate=0.0, kfold=4),
    dict(bags=5, valid_rate=0.2, kfold=5, up_sample_weight=2.0),
]


@pytest.mark.parametrize("kw", MASK_CASES)
def test_window_member_masks_match_the_reference(kw):
    from shifu_tpu.data.streaming import mask_fn_from_settings as ref_fn
    from shifu_tpu.data.streaming import window_member_masks as ref
    from shifu_tpu_torch.data.streaming import (mask_fn_from_settings,
                                                window_member_masks)
    idx = np.arange(10_000, 14_096)
    targets = (np.random.default_rng(1).random(len(idx)) < 0.3) \
        .astype(np.float32)
    kw = dict(kw, seed=9)
    bags = kw.pop("bags")
    a = window_member_masks(idx, bags, targets=targets, **kw)
    b = ref(idx, bags, targets=targets, **kw)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)
    fa = mask_fn_from_settings(bags, **kw)(idx, targets)
    fb = ref_fn(bags, **kw)(idx, targets)
    for x, y in zip(fa, fb):
        np.testing.assert_array_equal(x, y)


def _hash_index():
    return np.concatenate([np.arange(0, 3000),
                           np.arange(2 ** 31 - 1500, 2 ** 31 + 1500),
                           np.arange(2 ** 32 - 1500, 2 ** 32 + 1500)])


@pytest.mark.parametrize("lam", [1.0, 0.63, 3.5])
@pytest.mark.parametrize("seed,stream", [(0, 5000), (11, 5007),
                                         (2 ** 33 + 1, 1002)])
def test_device_hash_bags_are_the_host_stream(lam, seed, stream):
    """``hash_poisson_device`` on CPU tensors is bit-equal to the numpy
    ``_hash_poisson`` stream and to the reference's device hash, on a
    window whose indices pass 2^31 and 2^32."""
    import jax.numpy as jnp

    from shifu_tpu.data.streaming import _hash_poisson, row_uniform
    from shifu_tpu.ops.hashing import hash_poisson_device as ref_dev
    from shifu_tpu.ops.hashing import split_index_u32
    from shifu_tpu_torch.ops.hashing import hash_poisson_device
    idx = _hash_index()
    host = _hash_poisson(lam, row_uniform(seed, stream, idx))
    got = hash_poisson_device(torch.from_numpy(idx.astype(np.int64)), seed,
                              stream, lam).numpy()
    hi, lo = split_index_u32(idx)
    ref = np.asarray(ref_dev(jnp.asarray(hi), jnp.asarray(lo), seed, stream,
                             lam))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, ref)


def test_hash_helpers_match_the_reference():
    """The CDF thresholds and row keys, as int64 here, are the reference's
    uint64 values (its uint32 halves put together)."""
    from shifu_tpu.ops import hashing as ref
    from shifu_tpu_torch.ops import hashing as port
    for lam in (0.5, 1.0, 2.5):
        np.testing.assert_array_equal(port.poisson_thresholds(lam),
                                      ref.poisson_thresholds(lam))
        hi, lo = ref.thresholds_u32(lam)
        np.testing.assert_array_equal(
            port.thresholds_i64(lam),
            (hi.astype(np.int64) << 32) | lo.astype(np.int64))
    for seed, stream in ((0, 5000), (2 ** 35 + 3, 7), (12345, 1002)):
        assert port._row_key(seed, stream) == ref._row_key(seed, stream)
        hi, lo = ref.row_key_u32(seed, stream)
        assert port.row_key_i64(seed, stream) % (1 << 64) == \
            (int(hi) << 32) | int(lo)


@pytest.mark.parametrize("row_bytes,n_rows,props", [
    (2 * 256 + 8, 4_194_304, {}),
    (20, 1_048_576, {}),
    (20, 1500, {}),
    (20, 4_194_304, {"shifu.train.windowRows": "524288"}),
    (520, 4_194_304, {"shifu.train.memoryBudgetBytes": "100000000"})])
@pytest.mark.parametrize("data_size", [1, 8])
def test_window_geometry_matches_the_reference(row_bytes, n_rows, props,
                                               data_size):
    from shifu_tpu.data.streaming import stream_window_rows as ref
    from shifu_tpu_torch.data.streaming import stream_window_rows

    class _S:
        schema = {"numRows": n_rows}
        num_rows = n_rows
    for k, v in props.items():
        environment.set_property(k, v)
        j_environment.set_property(k, v)
    assert stream_window_rows(row_bytes, data_size, _S()) == \
        ref(row_bytes, data_size, _S())


def test_default_geometry_of_a_4m_row_plane_has_no_resident_window():
    """The reference's defaults on 4,194,304 rows x 256 columns: windows of
    4,129,776 rows, and a prepared GBT window (256 bins + y/tw/vw = 268
    bytes a row) over the 1 GiB device cache — the whole plane is tail."""
    from shifu_tpu_torch.data.streaming import stream_window_rows

    class _S:
        schema = {"numRows": 4_194_304}
        num_rows = 4_194_304
    w = stream_window_rows(2 * 256 + 8, 1, _S())
    assert w == 4_129_776
    assert w * 268 > 1 << 30


@pytest.mark.parametrize("override,env,prop,want", [
    (None, None, None, 2), (3, "5", None, 3), (None, "5", None, 5),
    (None, None, "0", 0), ("x", None, "4", 4)])
def test_prefetch_depth_matches_the_reference(monkeypatch, override, env,
                                              prop, want):
    from shifu_tpu.data.streaming import stream_prefetch_depth as ref
    from shifu_tpu_torch.data.streaming import stream_prefetch_depth
    if env is None:
        monkeypatch.delenv("SHIFU_TPU_PREFETCH", raising=False)
    else:
        monkeypatch.setenv("SHIFU_TPU_PREFETCH", env)
    if prop is not None:
        environment.set_property("shifu.stream.prefetch", prop)
        j_environment.set_property("shifu.stream.prefetch", prop)
    assert stream_prefetch_depth(override) == ref(override) == want
