#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``shifu_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with an NVIDIA GPU (built and
measured on an H100).  It

1. requires CUDA and prints the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
2. builds every hand-written kernel from ``shifu_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and holds each against its
   plain PyTorch version on the card: ``tree_traverse`` over a 100-tree,
   depth-7 forest (K=255 nodes), 64 bins and 256 columns at N in
   {1, 8, 64, 333, 512, 4096} must equal the plain version bit for bit;
3. drives the port's serving path at full width: writes a synthetic GBT
   model set (ModelConfig.json, ColumnConfig.json with 224 numeric + 32
   categorical final-selected columns, models/model0.gbt with 100 trees of
   depth 7 from ``--seed``) with the port's own savers, starts
   ``ServeServer`` on ``cuda`` behind the stdlib HTTP handler on
   127.0.0.1:0, POSTs raw-record batches of 1, 7, 64, 333, 512 and 1500
   records (missing fields, junk numbers, unknown categories, one malformed
   record) plus pre-binned requests, GETs /healthz, and checks every score
   against the same model set served on ``device="cpu"`` within 1e-3 on the
   0-1000 scale (f32 tree sums run in another order on the card).  Kernel
   launch counts are zeroed just before this phase and read just after it:
   every kernel of the path must have launched;
4. times each kernel (CUDA events, launches queued behind a spin kernel so
   the host cannot starve the card) at the serving top rung N=512 and at
   N=65536, beside its plain version and its bound (the larger of the bytes
   this data makes it move over 3.35 TB/s and its integer operations over
   67 T/s), and times the device transform at N=512 with and without its
   x blocks;
5. prints one JSON line listing every ported kernel, then as its last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Any failed check exits non-zero before the last line is printed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
INT_OPS_PER_S = 67e12              # H100 SXM non-tensor 32-bit rate
OPS_PER_LEVEL = 8                  # loads, compares, clamps, select, madd
SCORE_TOL = 1e-3                   # 0-1000 scale, card vs CPU
N_TREES, DEPTH, N_BINS, N_NUM, N_CAT = 100, 7, 64, 224, 32
N_COLS = N_NUM + N_CAT
KERNEL_ROWS = (1, 8, 64, 333, 512, 4096)
RAW_BATCHES = (1, 7, 64, 333, 512, 1500)
TIMED_ROWS = (512, 65536)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


# ------------------------------------------------------------- the card
def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------- the forest
def random_forest(rng, n_trees, depth, n_bins, n_cols, leaf_frac=0.1):
    """Complete-binary forest: ~``leaf_frac`` of internal nodes are early
    leaves, left masks random bits, leaf values N(0, 0.1)."""
    k = (1 << (depth + 1)) - 1
    sf = rng.integers(0, n_cols, size=(n_trees, k)).astype(np.int32)
    sf[rng.random((n_trees, k)) < leaf_frac] = -1
    sf[:, (1 << depth) - 1:] = -1
    lm = rng.random((n_trees, k, n_bins)) < 0.5
    lv = rng.normal(0.0, 0.1, size=(n_trees, k)).astype(np.float32)
    return sf, lm, lv


def device_ms(torch, fn, launches: int = 20, repeats: int = 7) -> float:
    """Median device time of one ``fn()`` call: each repeat queues a spin
    kernel, then ``launches`` calls between two CUDA events, so the card
    runs them back to back whatever the host's enqueue cost."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)          # ~25 ms of spinning
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) / launches)
    return float(np.median(per))


# ------------------------------------------------------- phase: kernels
def check_kernels(torch, tq, rng) -> dict:
    """tree_traverse against its plain version at every N; returns the max
    |kernel - plain| seen."""
    sf, lm, lv = random_forest(rng, N_TREES, DEPTH, N_BINS, N_COLS)
    dev = torch.device("cuda")
    forest = [torch.from_numpy(a).to(dev)
              for a in (sf, lm.astype(np.uint8), lv)]
    err = 0.0
    for n in KERNEL_ROWS:
        bins = torch.from_numpy(rng.integers(
            0, N_BINS, size=(n, N_COLS)).astype(np.uint8)).to(dev)
        got = tq.predict_forest_quant(*forest, bins, DEPTH)
        want = tq.predict_forest_quant_ref(*forest, bins, DEPTH)
        torch.cuda.synchronize()
        if got.shape != (N_TREES, n) or not torch.equal(got, want):
            fail(f"tree_traverse != plain version at N={n} (max |d| "
                 f"{(got - want).abs().max().item()})")
        err = max(err, (got - want).abs().max().item())
        log(f"tree_traverse == plain version bit for bit at N={n}")
    return {"tree_traverse": err}


# ---------------------------------------------------- phase: model set
def write_model_set(root: str, rng) -> dict:
    """The synthetic GBT model set, written with the port's own savers in
    the reference's file formats.  Returns the column plan for records."""
    from shifu_tpu_torch.config import (ColumnConfig, ModelConfig,
                                        save_column_configs)
    from shifu_tpu_torch.config.column_config import ColumnFlag, ColumnType
    from shifu_tpu_torch.config.model_config import Algorithm, NormType
    from shifu_tpu_torch.models.tree import TreeModelSpec, save_model
    from shifu_tpu_torch.ops.tree import TreeArrays

    mc = ModelConfig()
    mc.basic.name = "chip_smoke"
    mc.dataSet.targetColumnName = "tag"
    mc.dataSet.posTags, mc.dataSet.negTags = ["bad"], ["good"]
    mc.normalize.normType = NormType.ZSCALE
    mc.train.algorithm = Algorithm.GBT
    mc.train.params = {"TreeNum": N_TREES, "FeatureSubsetStrategy":
                       "TWOTHIRDS", "MaxDepth": DEPTH,
                       "MinInstancesPerNode": 5, "MinInfoGain": 0.0,
                       "DropoutRate": 0.0, "Impurity": "variance",
                       "LearningRate": 0.1, "Loss": "log"}
    mc.save(os.path.join(root, "ModelConfig.json"))

    ccs, plan = [], []
    for j in range(N_COLS):
        cc = ColumnConfig(columnNum=j, finalSelect=True)
        bn = cc.columnBinning
        if j < N_NUM:
            mean, std = float(rng.normal(0, 50)), float(rng.uniform(0.5, 20))
            cc.columnName = f"num{j:03d}"
            cuts = np.sort(rng.normal(mean, std, size=N_BINS - 2))
            bn.binBoundary = [float("-inf")] + [float(c) for c in cuts]
            n_val = N_BINS - 1
            plan.append(("num", cc.columnName, mean, std))
        else:
            n_val = int(rng.integers(20, 61))
            cc.columnName = f"cat{j:03d}"
            cc.columnType = ColumnType.C
            bn.binCategory = [f"{cc.columnName}_v{k}" for k in range(n_val)]
            plan.append(("cat", cc.columnName, bn.binCategory, None))
        neg = rng.integers(50, 500, size=n_val + 1)
        pos = rng.integers(5, 100, size=n_val + 1)
        rate = pos / (pos + neg)
        bn.binCountNeg, bn.binCountPos = neg.tolist(), pos.tolist()
        bn.binPosRate = rate.tolist()
        bn.binCountWoe = np.log((pos / pos.sum()) / (neg / neg.sum())).tolist()
        bn.length = n_val + 1
        if j < N_NUM:
            cc.columnStats.mean, cc.columnStats.stdDev = mean, std
        else:
            cc.columnStats.mean = float(rate.mean())
            cc.columnStats.stdDev = float(rate.std())
        ccs.append(cc)
    tag = ColumnConfig(columnNum=N_COLS, columnName="tag",
                       columnType=ColumnType.C, columnFlag=ColumnFlag.Target)
    save_column_configs(ccs + [tag], os.path.join(root, "ColumnConfig.json"))

    sf, lm, lv = random_forest(rng, N_TREES, DEPTH, N_BINS, N_COLS)
    spec = TreeModelSpec(algorithm="GBT", n_trees=N_TREES, depth=DEPTH,
                         n_bins=N_BINS, loss="log", learning_rate=0.1,
                         init_score=-1.2, column_nums=list(range(N_COLS)),
                         feature_names=[c.columnName for c in ccs])
    save_model(os.path.join(root, "models", "model0.gbt"), spec,
               [TreeArrays(split_feat=sf[t], left_mask=lm[t],
                           leaf_value=lv[t], depth=DEPTH)
                for t in range(N_TREES)])
    return {"plan": plan}


def make_records(rng, plan, n: int, malformed_at=None) -> list:
    """Raw JSON records: ~5% missing fields, ~1% unparseable numbers,
    ~3% unknown categories, some numbers sent as strings."""
    junk = ["n/a", "1_000", "", "?", "0x1F"]
    recs = []
    for i in range(n):
        rec = {}
        for kind, name, a, b in plan:
            roll = rng.random()
            if roll < 0.05:
                continue
            if kind == "num":
                v = float(rng.normal(a, 1.5 * b))
                rec[name] = junk[int(rng.integers(len(junk)))] \
                    if roll < 0.06 else (repr(v) if roll < 0.2 else v)
            else:
                rec[name] = "zz-unknown" if roll < 0.08 \
                    else a[int(rng.integers(len(a)))]
        recs.append(rec)
    if malformed_at is not None:
        recs[malformed_at] = ["not", "a", "record"]
    return recs


# -------------------------------------------------------- phase: serve
def serve_phase(torch, tq, root: str, plan, rng) -> dict:
    """The main path over HTTP on the card, checked against the CPU."""
    from http.server import ThreadingHTTPServer

    from shifu_tpu_torch.serve import ServeServer
    from shifu_tpu_torch.serve.server import _make_handler

    t0 = time.perf_counter()
    server = ServeServer(root, device="cuda").start()
    log(f"cuda server up in {time.perf_counter() - t0:.2f} s "
        f"(buckets {server.status()['buckets']})")
    cpu = ServeServer(root, device="cpu")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(server))
    port = httpd.server_address[1]
    worker = threading.Thread(target=httpd.serve_forever, daemon=True)
    worker.start()

    def call(path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.load(resp)

    requests = [make_records(rng, plan, n, malformed_at=3 if n == 64
                             else None) for n in RAW_BATCHES]
    scorer = server.registry.get(server.key)
    t_parse = time.perf_counter()
    for r in requests:              # the host half of each raw request
        scorer.transform.parse_records(r)
    parse_s = time.perf_counter() - t_parse
    prebinned = [rng.integers(0, N_BINS, size=(n, scorer.n_bins_cols))
                 for n in (5, 100)]
    try:
        batches_before = server.batcher.stats["batches"]
        tq.predict_forest_quant.launches = 0
        t1 = time.perf_counter()
        answers = [call("/score", {"records": r}) for r in requests]
        pre = [call("/score", {"rows": [[] for _ in b], "bins": b.tolist()})
               for b in prebinned]
        health = call("/healthz")
        wall = time.perf_counter() - t1
        launches = tq.predict_forest_quant.launches
        batches = server.batcher.stats["batches"] - batches_before
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
        worker.join(timeout=30)
    log(f"main path: {len(requests)} raw + {len(prebinned)} pre-binned "
        f"requests in {wall:.3f} s, {batches} batches, {launches} "
        f"tree_traverse launches; host record parsing alone takes "
        f"{parse_s:.3f} s of it ({sum(map(len, requests))} records x "
        f"{N_COLS} columns)")
    if launches < batches or launches == 0:
        fail(f"tree_traverse launched {launches} times for {batches} "
             "scored batches")
    if not (health["state"] == "serving" and health["accepts_raw"]
            and health["device"].startswith("cuda")
            and health["buckets"] == [1, 8, 64, 512]):
        fail(f"unexpected /healthz: {health}")

    worst = 0.0
    for recs, got in zip(requests, answers):
        want = cpu.score_raw(recs)
        if got["errors"] != want["errors"]:
            fail(f"errors differ: {got['errors']} vs {want['errors']}")
        for s, w in zip(got["scores"], want["scores"]):
            if (s is None) != (w is None):
                fail("a null score on one device only")
            if s is not None:
                if not math.isfinite(s) or not 0.0 <= s <= 1000.0:
                    fail(f"score {s} outside [0, 1000]")
                worst = max(worst, abs(s - w))
    malformed = answers[RAW_BATCHES.index(64)]
    if malformed["scores"][3] is not None or \
            [e["code"] for e in malformed["errors"]] != ["bad_record"]:
        fail(f"malformed record not rejected alone: {malformed['errors']}")
    for b, got in zip(prebinned, pre):
        want = cpu.score(np.zeros((len(b), 0), np.float32), b)
        worst = max(worst, float(np.max(np.abs(
            np.asarray(got["scores"]) - want))))
    if worst > SCORE_TOL:
        fail(f"card vs CPU scores differ by {worst} > {SCORE_TOL}")
    log(f"every score within {worst:.3g} of the CPU path (tolerance "
        f"{SCORE_TOL}); malformed record rejected with its code")
    return {"launches": {"tree_traverse": launches}, "batches": batches,
            "max_abs_score_diff": worst, "wall_s": wall, "parse_s": parse_s}


# ------------------------------------------------------- phase: timing
def time_kernels(torch, tq, rng, gpu: str) -> dict:
    sf, lm, lv = random_forest(rng, N_TREES, DEPTH, N_BINS, N_COLS)
    dev = torch.device("cuda")
    forest = [torch.from_numpy(a).to(dev)
              for a in (sf, lm.astype(np.uint8), lv)]
    out = {}
    for n in TIMED_ROWS:
        bins = torch.from_numpy(rng.integers(
            0, N_BINS, size=(n, N_COLS)).astype(np.uint8)).to(dev)
        ms = device_ms(torch, lambda: tq.predict_forest_quant(
            *forest, bins, DEPTH))
        plain_ms = device_ms(torch, lambda: tq.predict_forest_quant_ref(
            *forest, bins, DEPTH), launches=3, repeats=5)
        # what this run's data needs: each element a walk reads, once;
        # [T, N] f32 written once; integer work per split step taken
        need = tq.traverse_bytes(forest[0], forest[1], bins, DEPTH)
        whole = tq.quant_traverse_cost(
            rows=n, n_feat=N_COLS, n_bins=N_BINS, n_nodes=sf.shape[1],
            depth=DEPTH, n_trees=N_TREES)["bytes_accessed"]
        bytes_ms = need["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = need["split_steps"] * OPS_PER_LEVEL / INT_OPS_PER_S * 1e3
        out[n] = {"ms": ms, "plain_ms": plain_ms,
                  "bound_ms": max(bytes_ms, ops_ms),
                  "bound_by": "bytes" if bytes_ms >= ops_ms
                  else "operations",
                  "bytes": need["bytes"], "split_steps": need["split_steps"],
                  "whole_forest_bytes": whole}
        log(f"tree_traverse N={n}: kernel {ms:.5f} ms, plain "
            f"{plain_ms:.4f} ms, bound {out[n]['bound_ms']:.6f} ms "
            f"({out[n]['bound_by']}: {need['bytes'] / 1e6:.3f} MB read "
            f"and written, {need['split_steps']} split steps; the whole "
            f"forest and plane would be {whole / 1e6:.3f} MB) — [{gpu}]")
    return out


def time_transform(torch, root: str, plan, rng, gpu: str) -> dict:
    """The device transform at the top rung, as the scorer runs it for a
    tree-only ensemble (bins only) and with its x blocks too: host wall
    time per call (eager ops are host-bound) and device time per call,
    the two variants in turns."""
    from shifu_tpu_torch.serve.transform import FusedTransform
    tf = FusedTransform.from_dir(root)
    packed = tf.parse_records(make_records(rng, plan, 512))[0]
    wire = torch.from_numpy(packed).to("cuda")
    out = {True: {"host_ms": [], "device_ms": []},
           False: {"host_ms": [], "device_ms": []}}
    for need_x in (True, False, False, True):
        fn = lambda: tf.apply_device(wire, need_x=need_x)      # noqa: E731
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        out[need_x]["host_ms"].append((time.perf_counter() - t0) * 20.0)
        out[need_x]["device_ms"].append(device_ms(torch, fn))
    res = {("with_x" if k else "bins_only"): {m: float(np.median(v))
                                             for m, v in d.items()}
           for k, d in out.items()}
    for name, d in res.items():
        log(f"device transform N=512 {name}: {d['host_ms']:.4f} ms wall "
            f"per call, {d['device_ms']:.4f} ms device — [{gpu}]")
    return res


# ----------------------------------------------------------------- main
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available — this smoke runs on an NVIDIA GPU")
    try:
        from shifu_tpu_torch.ops import cuda_lib
        from shifu_tpu_torch.ops import tree_quant as tq
    except ImportError as e:
        fail(f"run from the repository root ({e})")
    gpu = gpu_identity()
    print(gpu, flush=True)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}) on {kind}")
    rng = np.random.default_rng(args.seed)
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    built = cuda_lib.build(["tree_traverse"])
    for name, (path, build_log) in built.items():
        log(f"built {name} -> {os.path.relpath(path)}")
        for line in build_log.splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")

    errs = check_kernels(torch, tq, rng)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        plan = write_model_set(root, rng)["plan"]
        served = serve_phase(torch, tq, root, plan, rng)
        time_transform(torch, root, plan, rng, gpu)
    times = time_kernels(torch, tq, rng, gpu)

    top = times[512]
    kernels = [{
        "name": "tree_traverse", "route": "cuda",
        "source": "shifu_tpu_torch/csrc/tree_traverse.cu",
        "replaces": "shifu_tpu/ops/tree_quant.py:159",
        "launches": served["launches"]["tree_traverse"],
        "max_abs_err": errs["tree_traverse"],
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": None,
        "at_65536_rows": {k: times[65536][k] for k in
                          ("ms", "plain_ms", "bound_ms", "bound_by")},
        "gpu": gpu}]
    log(f"served {served['batches']} batches; max |card - cpu| "
        f"{served['max_abs_score_diff']:.3g}; total "
        f"{time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
