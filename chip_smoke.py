#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``shifu_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --time-of DIR [--seed N]

Run from the repository root on a machine with an NVIDIA GPU (built and
measured on an H100).  The main path's data (steps 3-6) comes from a
generator of its own, seeded from ``--seed``, so the checks and timings
around it never move it.  With ``--time-of DIR`` it only times the
histogram kernels B1 and B2 and a chunk of GBT trees of the
``shifu_tpu_torch`` in checkout DIR (``time_of``), to compare two
versions on one card.  Otherwise it

1. requires CUDA and prints the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
2. builds every hand-written kernel from ``shifu_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and holds each against its
   plain PyTorch version on the card: ``tree_traverse`` over a 100-tree,
   depth-7 forest (K=255 nodes), 64 bins and 256 columns at N in
   {1, 8, 64, 333, 512, 4096} must equal the plain version bit for bit;
   ``hist`` (the histogram build) over 256 uint8 columns of 64 bins with
   two stat channels [w, w*g] (integer weights 1-3, ~30% of rows
   inactive) at N in {1, 1000, 65536, 1048576} and K in {1, 2, 32} (and
   K=4096 where it is timed, step 7), and over 7 int32 columns of 4001
   bins at K=8, must give bit for bit what the plain version of its own
   fixed-point arithmetic gives, the float64 plain version's count
   channel exactly, the w*g channel within 1e-5 of that version's sum of
   |stats| per cell plus the fixed point's quantum (half of 2^-e a row),
   and the same bits on a second launch; ``stats_hist`` (the stats
   plane's fine histogram) over ~5%
   missing cells at (N, C, B, S) in {262144 x 224 x 4096 with S = 4 and
   2, 100003 x 13 x 64 with S = 4 and 2, 4096 x 5 x 4096 x 2, 1 x 7 x
   4096 x 4} must give the plain version's count channels exactly, the
   weighted ones within 1e-6 of the plain value, and the same bits on a
   second launch; ``hist_batch`` (the tree-batched histogram of the
   Random Forest) over 8 trees of ``hist``'s data at N = 1,048,576 and K
   in {1, 32, 4096} and over 7 int32 columns of 4001 bins at K=8 must give
   every tree a ``hist`` launch's bits, held to the plain versions as
   ``hist`` is, and the same bits on a second launch;
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
4. drives the port's training path at full width: writes the same column
   plan's training set (the wire plane of 1,048,576 rows, y from a logit
   on 10 columns drawn from ``--seed``, integer weights) with the port's
   own savers and ``WireWriter``, and runs ``shifu_tpu_torch.cli.main
   train`` on ``cuda`` (TreeNum 10, MaxDepth 7, Loss log, LearningRate
   0.1, CheckpointInterval 5, validSetRate 0.2).  It checks the exit
   code, the 10 depth-7 trees of ``models/model0.gbt``, falling train and
   validation errors, an informative column on top of the feature
   importance, and exactly 80 ``hist`` launches (7 levels and the leaf
   sums a tree; the 10 leaf-sum launches also counted on their own),
   counted from zero around the run.  Then: one chunk of trees under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync inside a
   chunk); 5 trees, then ``train -resume`` to 10, bit-identical to the
   uninterrupted forest; the same 5-tree checkpoint without its per-row
   score sidecar resumed to 10, its trees replayed through
   ``tree_traverse`` (launches counted from zero around the run), with
   the uninterrupted forest's splits and leaves within 1e-5 relative;
   the train phase split into upload, grow and checkpoints from
   ``tmp/profile.json``; and the plane's first 65,536 rows trained to 5
   trees on ``cuda`` and on ``cpu``, with equal split features on levels
   0-1, per-tree errors within 1e-4 relative and the two forests' AUCs
   (scored by ``tree_traverse``) within 0.005;
5. drives the port's Random Forest path at full width: ``init -model``'s
   RF params (TreeNum 10, MaxDepth 14, TWOTHIRDS, entropy, Loss squared)
   plus CheckpointInterval 8 on the same 1,048,576-row plane through
   ``cli.main train`` on ``cuda``, with exactly 14 ``hist_batch`` launches
   (the 8-tree batch, one a level) and 38 ``hist`` launches (the batch's
   8 leaf-sum levels, then 2 trees one by one), counted from zero around
   the run (10 of the ``hist`` launches leaf sums, counted on their own);
   32,767-node trees, a falling out-of-bag error, every tree's root split
   on an informative column (the column a depth-14 impurity importance
   puts on top may be a many-category one: it sums the gains of thousands
   of deep splits), the peak device memory.  Then: the two chunks again
   on resident tensors (the batch under ``set_sync_debug_mode("error")``),
   each reproducing the CLI's trees bit for bit, timed per tree with CUDA
   events around every histogram launch and leaf-sum level; 8 trees,
   then ``train -resume`` to 10, bit-identical, its restored trees
   replayed through ``tree_traverse``; and the plane's first 65,536
   rows at depth 7 on ``cuda`` and ``cpu``: bags equal (0 rows differ),
   levels 0-1 equal, errors within 1e-4 relative, AUCs within 0.005;
6. drives the port's stats path through the CLI: writes the column
   plan's raw data as a 16,384-row '|'-delimited CSV (224 numeric columns
   with ~5% empty cells, 32 categorical, ``weight``, ``tag``; a cut in
   rows, not width), runs ``new``, ``init`` (it must type 224 numeric and
   32 categorical candidates) and ``stats`` on ``cuda`` in chunks of 4,096
   rows with a fused budget that keeps 2 chunks resident and overflows 2
   into the provisional grid, with exactly 4 ``stats_hist`` launches
   counted from zero around ``stats``; checks every numeric column's
   counts and finite boundaries, and that ``stats`` on ``cpu`` writes the
   same ColumnConfig.json (integers, types, categories and binBoundary
   equal, floats within 1e-5 relative + 1e-4); times the host parse
   alone.  Then the port's ``NumericAccumulator`` on ``cuda`` at a
   deployment's size: 8 weighted chunks of 262,144 rows x 224 columns from
   ``--seed`` (3 resident, 5 overflowing, 8 ``stats_hist`` launches), the
   ms a chunk update and the finalize take and the peak device memory,
   and the first 2 chunks on ``cuda`` and ``cpu`` with equal counts,
   boundaries and percentiles;
7. times each kernel (CUDA events, launches queued behind a spin kernel so
   the host cannot starve the card) beside its plain version, one PyTorch
   call that computes the same function where there is one, and its bound
   (the larger of the bytes this data makes it move over 3.35 TB/s and its
   integer operations over 67 T/s): ``tree_traverse`` at the serving top
   rung N=512, at N=65536 and at N=1,048,576 (the train replay's and an
   eval set's rows) on the forest packed once, as a pinning caller does,
   ``stats_hist`` at N=262,144 x 224 columns x 4096 buckets with S = 4
   and 2 (``index_add_`` the PyTorch call), split by part (amax, staging
   the ids, adds, flush),
   ``hist`` at N = 1,048,576 and K
   in {1, 32, 4096} and ``hist_batch`` at TB=8 and the same N and K
   beside 8 ``hist`` launches (``scatter_add_`` the PyTorch call), each
   split by part (partition, row walk, adds, flush); times the device
   transform at
   N=512 with and without its x blocks; and reports ms per tree of the
   full-width train, with a ``torch.profiler`` breakdown of one tree's
   device time;
8. prints one JSON line listing every ported kernel, then as its last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Any failed check exits non-zero before the last line is printed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
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
TRAVERSE_ROWS = (512, 65536, 1 << 20)   # serve's top rung, a chunk, replay
HIST_ROWS = (1, 1000, 65536, 1 << 20)
HIST_NODES = (1, 2, 32)
CHUNK_REPEATS = 15                 # timed GBT chunks (the tree is host-bound)
HIST_WIDE = (1 << 20, 7, 4001, 8)          # N, C, B (int32 bins), K
HIST_TOL = 1e-5                            # x the plain version on |stats|
TRAIN_ROWS, TRAIN_TREES, TRAIN_CKPT = 1 << 20, 10, 5
CUT_ROWS, CUT_TREES = 65536, 5
ERR_RTOL, AUC_TOL = 1e-4, 0.005            # card vs CPU
REPLAY_RTOL = 1e-5                         # replayed vs uninterrupted leaves
N_INFORMATIVE = 10
TRAIN_PARTS = ("train/upload", "train/grow", "train/checkpoint")
STATS_BUCKETS = 4096                       # the stats plane's fine sketch
STATS_TOL = 1e-6                           # weighted B3 cells, x |value|
STATS_CASES = ((262144, N_NUM, STATS_BUCKETS, 4), (262144, N_NUM,
               STATS_BUCKETS, 2), (100003, 13, 64, 4), (100003, 13, 64, 2),
               (4096, 5, STATS_BUCKETS, 2), (1, 7, STATS_BUCKETS, 4))
CSV_ROWS, CSV_CHUNK = 16384, 4096          # the stats CLI phase's cut
CHUNK_BYTES = CSV_CHUNK * (5 * N_NUM + 8)  # what a kept chunk holds
RESIDENT_CHUNKS, RESIDENT_ROWS = 8, 262144
CARD_CPU_RTOL, CARD_CPU_ATOL = 1e-5, 1e-4  # ColumnConfig floats, card/CPU
HIST_BATCH = 8                             # B2's tree batch (RF_TREE_BATCH)
HIST_BATCH_NODES = (1, 32, 4096)           # K: shallow levels, the deepest
HIST_TIMED_NODES = HIST_BATCH_NODES        # B1 timed at the same K
HIST_BATCH_WIDE = (1 << 20, 7, 4001, 8)    # N, C, B (int32 bins), K
RF_TREES, RF_DEPTH, RF_CKPT = 10, 14, 8    # init -model's RF + a checkpoint
RF_CUT_DEPTH = 7                           # card vs CPU on CUT_ROWS rows


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


def hist_inputs(torch, rng, n, c, b, k, dtype=np.uint8):
    """B1 inputs on the card: uniform bins, node ids in [0, K) with ~30%
    of rows inactive (-1), stats [w, w*g] with integer w in 1..3 and
    g ~ N(0, 1)."""
    bins = rng.integers(0, b, size=(n, c), dtype=dtype)
    node = rng.integers(0, k, size=n, dtype=np.int32)
    node[rng.random(n) < 0.3] = -1
    w = rng.integers(1, 4, size=n).astype(np.float32)
    stats = np.stack([w, w * rng.standard_normal(n, np.float32)], axis=1)
    return [torch.from_numpy(a).to("cuda") for a in (bins, node, stats)]


def quantum_floor(torch, hist, bins, node, stats, k, b):
    """What the fixed point itself may lose in each cell: half of its
    quantum 2^-e a row of the cell (``hist.channel_exp``)."""
    rows = hist.build_histograms_ref(bins, node, torch.ones_like(stats[:, :1]),
                                     k, b)
    e = hist.channel_exp(stats.abs().amax(dim=0), bins.shape[0])
    return rows * torch.pow(2.0, -e.double() - 1).float()


def held_to_plain(torch, hist, got, bins, node, stats, k, b, where, name):
    """One tree's histogram against the plain versions: bit-equal to the
    kernel's own arithmetic (``build_histograms_fixed_ref``), counts equal
    to the float64 plain version, w*g within HIST_TOL of it run on |stats|
    plus the fixed point's quantum floor.  Returns max |got - plain|."""
    if not torch.equal(got, hist.build_histograms_fixed_ref(
            bins, node, stats, k, b)):
        fail(f"{name} != its fixed-point plain version at {where}")
    want = hist.build_histograms_ref(bins, node, stats, k, b)
    scale = hist.build_histograms_ref(bins, node, stats.abs(), k, b)
    d = (got - want).abs()
    if not torch.equal(got[..., 0], want[..., 0]):
        fail(f"{name} count channel != plain version at {where}")
    floor = quantum_floor(torch, hist, bins, node, stats, k, b)
    if not bool((d <= HIST_TOL * scale + floor).all()):
        fail(f"{name} w*g channel beyond {HIST_TOL} x |stats| and the "
             f"quantum at {where} (max |d| {d.max().item()})")
    return d.max().item()


def check_hist(torch, rng) -> dict:
    """B1 against its plain versions (``held_to_plain``), a second launch
    bit-equal.  Returns the max |kernel - plain| seen."""
    from shifu_tpu_torch.ops import hist
    from shifu_tpu_torch.ops.tree import build_histograms
    cases = [(n, N_COLS, N_BINS, k, np.uint8) for n in HIST_ROWS
             for k in HIST_NODES] + [HIST_WIDE + (np.int32,)]
    err = 0.0
    for n, c, b, k, dtype in cases:
        bins, node, stats = hist_inputs(torch, rng, n, c, b, k, dtype)
        got = build_histograms(bins, node, stats, k, b)
        again = build_histograms(bins, node, stats, k, b)
        torch.cuda.synchronize()
        where = f"N={n} C={c} B={b} K={k} {np.dtype(dtype).name}"
        if got.shape != (k, c, b, 2) or not torch.equal(got, again):
            fail(f"hist: two launches differ at {where}")
        d = held_to_plain(torch, hist, got, bins, node, stats, k, b, where,
                          "hist")
        err = max(err, d)
        log(f"hist == plain version at {where}: bit-equal to the fixed "
            f"point, counts equal, max |d| {d:.3g}, relaunch bit-equal")
        del bins, node, stats, got, again
    return {"hist": err}


def batch_inputs(torch, rng, n, c, b, k, tb, dtype=np.uint8):
    """B2 inputs on the card in ``hist_inputs``' style: shared uniform
    bins; per tree node ids in [0, K) with ~30% of rows inactive and
    stats [w, w*g], w a Poisson(1) bag times an integer weight 1..3 (so
    ~37% of each tree's rows weigh 0), g ~ N(0, 1)."""
    bins = rng.integers(0, b, size=(n, c), dtype=dtype)
    node = rng.integers(0, k, size=(tb, n), dtype=np.int32)
    node[rng.random((tb, n)) < 0.3] = -1
    w = (rng.poisson(1.0, size=(tb, n))
         * rng.integers(1, 4, size=n)).astype(np.float32)
    stats = np.stack([w, w * rng.standard_normal((tb, n), np.float32)],
                     axis=2)
    return [torch.from_numpy(a).to("cuda") for a in (bins, node, stats)]


def check_hist_batch(torch, rng) -> dict:
    """B2 against B1 and its plain versions: every tree's slice bit-equal
    to a B1 launch on that tree's inputs and held to the plain versions
    as B1 is (``held_to_plain``), a second launch bit-equal.  TB=8 at full
    width for each K in HIST_BATCH_NODES and at one int32-bin shape.
    Returns the max |kernel - plain| seen."""
    from shifu_tpu_torch.ops import hist
    from shifu_tpu_torch.ops.tree import (build_histograms,
                                          build_histograms_batch)
    cases = [(TRAIN_ROWS, N_COLS, N_BINS, k, np.uint8)
             for k in HIST_BATCH_NODES] + [HIST_BATCH_WIDE + (np.int32,)]
    err = 0.0
    for n, c, b, k, dtype in cases:
        bins, node, stats = batch_inputs(torch, rng, n, c, b, k, HIST_BATCH,
                                         dtype)
        where = f"TB={HIST_BATCH} N={n} C={c} B={b} K={k} " \
                f"{np.dtype(dtype).name}"
        got = build_histograms_batch(bins, node, stats, k, b)
        again = build_histograms_batch(bins, node, stats, k, b)
        torch.cuda.synchronize()
        if got.shape != (HIST_BATCH, k, c, b, 2) or \
                not torch.equal(got, again):
            fail(f"hist_batch: two launches differ at {where}")
        del again
        for t in range(HIST_BATCH):
            if not torch.equal(got[t], build_histograms(bins, node[t],
                                                        stats[t], k, b)):
                fail(f"hist_batch tree {t} != hist (B1) at {where}")
        d_max = 0.0
        for t in range(HIST_BATCH):            # one tree at a time: memory
            d_max = max(d_max, held_to_plain(
                torch, hist, got[t], bins, node[t], stats[t], k, b, where,
                f"hist_batch tree {t}"))
            torch.cuda.empty_cache()
        err = max(err, d_max)
        plan = hist.hist_plan(n, c, HIST_BATCH, k, b, 2,
                              np.dtype(dtype).itemsize)
        log(f"hist_batch == hist per tree bit for bit and == plain version "
            f"at {where}: counts equal, max |d| {d_max:.3g}, relaunch "
            f"bit-equal (plan {plan})")
        del bins, node, stats, got
        torch.cuda.empty_cache()
    return {"hist_batch": err}


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


# ------------------------------------------------------- phase: train
def train_plane(rng, plan, n: int):
    """The training plane of the serving column plan: bins [n, 256] uint8,
    each column uniform over its value bins and its missing bin; y drawn
    from a logit on N_INFORMATIVE columns (numeric: a linear trend over
    the bins, categorical: a random effect per category); integer weights
    1..3.  Returns (bins, y, w, informative column ids, categorical
    mask)."""
    is_cat = np.array([kind == "cat" for kind, _, _, _ in plan])
    n_bins = [len(a) + 1 if kind == "cat" else N_BINS
              for kind, _, a, _ in plan]
    bins = rng.integers(0, N_BINS, size=(n, N_COLS), dtype=np.uint8)
    for j in np.flatnonzero(is_cat):
        bins[:, j] = rng.integers(0, n_bins[j], size=n, dtype=np.uint8)
    informative = np.sort(rng.choice(N_COLS, size=N_INFORMATIVE,
                                     replace=False))
    logit = np.full(n, -1.0, np.float32)
    for j in informative:
        if is_cat[j]:
            effect = rng.normal(0.0, 1.2, size=n_bins[j])
        else:
            effect = rng.choice([-1.0, 1.0]) * rng.uniform(0.6, 2.0) \
                * np.linspace(-1.0, 1.0, N_BINS)
        logit += effect.astype(np.float32)[bins[:, j]]
    y = (rng.random(n, np.float32) < 1.0 / (1.0 + np.exp(-logit))) \
        .astype(np.float32)
    w = rng.integers(1, 4, size=n).astype(np.float32)
    return bins, y, w, informative, is_cat


def write_plane(clean: str, bins, y, w, names, sig) -> None:
    """The norm step's clean output as the port's ``WireWriter`` writes
    it: the wire plane in shards of 2^18 rows, and ``schema.json``."""
    from shifu_tpu_torch.data.spill import WireWriter, wire_dir
    from shifu_tpu_torch.ioutil import atomic_write_json
    keys, shard = ("bins", "y", "w"), 1 << 18
    ww = WireWriter(wire_dir(clean, keys), keys,
                    {"bins": np.uint8, "y": np.float32, "w": np.float32},
                    {"bins": (bins.shape[1],)}, sig)
    rows = []
    for r0 in range(0, len(y), shard):
        ww.append({"bins": bins[r0:r0 + shard], "y": y[r0:r0 + shard],
                   "w": w[r0:r0 + shard]})
        rows.append(min(shard, len(y) - r0))
    ww.finish()
    atomic_write_json(os.path.join(clean, "schema.json"), {
        "outputNames": names, "columnNums": list(range(len(names))),
        "columnNames": names, "normType": "ZSCALE", "numShards": len(rows),
        "numRows": len(y), "shardRows": rows, "binsDtype": "uint8",
        "width": len(names), "wire": True, "wireKeys": list(keys),
        "wireSignature": sig})


def set_train_params(d: str, params: dict) -> None:
    from shifu_tpu_torch.config import ModelConfig
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.train.params = dict(params)
    mc.save(path)


def write_train_set(d: str, serve_root: str, params: dict, clean: str,
                    algorithm: str = "GBT") -> str:
    """A model set for ``train``: the serving set's ModelConfig and
    ColumnConfig with the given algorithm, train#params and validSetRate
    0.2, its clean dir a link to the plane ``clean``."""
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    os.makedirs(os.path.join(d, "tmp"))
    shutil.copy(os.path.join(serve_root, "ColumnConfig.json"), d)
    mc = ModelConfig.load(os.path.join(serve_root, "ModelConfig.json"))
    mc.basic.name = os.path.basename(d)
    mc.dataSet.dataPath = os.path.join(d, "data.csv")   # norm's input
    mc.train.algorithm = Algorithm[algorithm]
    mc.train.validSetRate = 0.2
    mc.save(os.path.join(d, "ModelConfig.json"))
    set_train_params(d, params)
    os.symlink(clean, os.path.join(d, "tmp", "CleanedData"))
    return d


def train_cli(d: str, device: str, *extra: str) -> float:
    """``train`` through the CLI a user calls; returns its wall seconds."""
    from shifu_tpu_torch import cli
    t0 = time.perf_counter()
    rc = cli.main(["--dir", d, "train", *extra, "--device", device])
    if rc != 0:
        fail(f"train {' '.join(extra)} on {device} exited {rc} in {d}")
    return time.perf_counter() - t0


def load_forest(d: str, kind: str = "gbt"):
    from shifu_tpu_torch.models.tree import load_model
    return load_model(os.path.join(d, "models", f"model0.{kind}"))


def progress_errors(d: str) -> np.ndarray:
    """[trees, 2] (train, validation) errors from ``tmp/train.progress``."""
    with open(os.path.join(d, "tmp", "train.progress")) as f:
        return np.array([[float(a), float(b)] for a, b in re.findall(
            r"Train Error: (\S+) Validation Error: (\S+)", f.read())])


def auc(score: np.ndarray, y: np.ndarray) -> float:
    """Rank AUC with ties at their mean rank."""
    _, inv, cnt = np.unique(score, return_inverse=True, return_counts=True)
    rank = (np.cumsum(cnt) - (cnt - 1) / 2.0)[inv]
    pos = y > 0.5
    n1, n0 = int(pos.sum()), int((~pos).sum())
    return float((rank[pos].sum() - n1 * (n1 + 1) / 2.0) / (n1 * n0))


def tree_counters():
    """The launch counts of the tree-training kernels' wrappers: B1
    (``hist``, the leaf sums' launches included), the leaf sums on their
    own, B2 (``hist_batch``) and B4 (``tree_traverse``)."""
    from shifu_tpu_torch.ops import tree as tree_ops
    from shifu_tpu_torch.ops import tree_quant as tq
    return {"hist": tree_ops.build_histograms,
            "leaf_sums": tree_ops._leaf_raw_hist,
            "hist_batch": tree_ops.build_histograms_batch,
            "tree_traverse": tq.predict_forest_quant}


def zero_tree_counts() -> None:
    for fn in tree_counters().values():
        fn.launches = 0


def read_tree_counts() -> dict:
    return {name: fn.launches for name, fn in tree_counters().items()}


def train_phase(torch, root: str, serve_root: str, plan, rng,
                device: str = "cuda") -> dict:
    """The training path at full width, checked by the repo's own means;
    the tree kernels' counts (``tree_counters``) are zeroed just before the
    run and read just after it."""
    t0 = time.perf_counter()
    bins, y, w, informative, is_cat = train_plane(rng, plan, TRAIN_ROWS)
    names = [p[1] for p in plan]
    clean = os.path.join(root, "plane")
    write_plane(clean, bins, y, w, names, {"chip_smoke": "full"})
    params = {"TreeNum": TRAIN_TREES, "MaxDepth": DEPTH, "Loss": "log",
              "LearningRate": 0.1, "CheckpointInterval": TRAIN_CKPT}
    full = write_train_set(os.path.join(root, "train"), serve_root, params,
                           clean)
    log(f"training set written in {time.perf_counter() - t0:.2f} s: "
        f"{TRAIN_ROWS} rows x {N_COLS} columns, informative columns "
        f"{informative.tolist()}, positive rate {y.mean():.4f}")

    zero_tree_counts()
    wall = train_cli(full, device)
    launches = read_tree_counts()
    want = {"hist": TRAIN_TREES * (DEPTH + 1), "leaf_sums": TRAIN_TREES,
            "hist_batch": 0, "tree_traverse": 0}
    if launches != want:
        fail(f"GBT train launched {launches}, not {want} ({TRAIN_TREES} "
             f"trees x {DEPTH} levels and the leaf sums)")

    spec, trees = load_forest(full)
    if spec.n_trees != TRAIN_TREES or len(trees) != TRAIN_TREES or \
            spec.depth != DEPTH or spec.n_bins != N_BINS:
        fail(f"model0.gbt holds {len(trees)} trees of depth {spec.depth} "
             f"over {spec.n_bins} bins")
    if any(t.split_feat.shape != ((1 << (DEPTH + 1)) - 1,)
           or t.split_feat[0] < 0 for t in trees):
        fail("a tree has the wrong node count or no root split")
    err = progress_errors(full)
    if err.shape != (TRAIN_TREES, 2) or not np.all(np.diff(err[:, 0]) < 0) \
            or not err[-1, 1] < err[0, 1]:
        fail(f"errors do not fall tree by tree: {err.tolist()}")
    with open(os.path.join(full, "tmp", "feature_importance.json")) as f:
        fi = json.load(f)
    top = names.index(max(fi, key=fi.get))
    if top not in informative:
        fail(f"top feature {names[top]} is not an informative column")
    ck = os.path.join(full, "tmp", "checkpoints", "forest_ckpt.npz")
    for path in (ck, ck + ".scores.npz", ck + ".meta.json",
                 os.path.join(full, "tmp", "journal", "TRAIN.json")):
        if not os.path.isfile(path):
            fail(f"train left no {path}")
    with open(os.path.join(full, "tmp", "profile.json")) as f:
        phases = json.load(f)["TRAIN"]["phases_s"]
    if any(p not in phases for p in TRAIN_PARTS):
        fail(f"profile.json does not split the train phase: {phases}")
    phases["train/other"] = round(
        phases["train"] - sum(phases[p] for p in TRAIN_PARTS), 3)
    log(f"main path (train): {TRAIN_TREES} trees of depth {DEPTH} in "
        f"{wall:.3f} s wall ({phases}); train error {err[0, 0]:.6f} -> "
        f"{err[-1, 0]:.6f}, validation {err[0, 1]:.6f} -> {err[-1, 1]:.6f}; "
        f"top feature {names[top]}; launches {launches}")
    out = {"launches": launches, "wall_s": wall, "phases_s": phases,
           "errors": err.tolist()}
    out["chunk"] = chunk_phase(torch, bins, y, w, is_cat, device)

    # resume: 5 trees, then -resume to 10, against the forest above
    part = write_train_set(os.path.join(root, "resume"), serve_root,
                           dict(params, TreeNum=TRAIN_CKPT), clean)
    train_cli(part, device)
    # the same 5-tree checkpoint without its per-row score sidecar, for
    # the replay resume below
    replay = write_train_set(os.path.join(root, "replay"), serve_root,
                             params, clean)
    shutil.copytree(os.path.join(part, "tmp", "checkpoints"),
                    os.path.join(replay, "tmp", "checkpoints"),
                    ignore=shutil.ignore_patterns("*.scores.npz"))
    set_train_params(part, params)
    train_cli(part, device, "-resume")
    _, got = load_forest(part)
    if len(got) != len(trees):
        fail(f"resumed forest has {len(got)} trees")
    for t, (a, b) in enumerate(zip(got, trees)):
        if any(getattr(a, k).tobytes() != getattr(b, k).tobytes()
               for k in ("split_feat", "left_mask", "leaf_value")):
            fail(f"resumed forest differs from the uninterrupted one at "
                 f"tree {t}")
    log(f"{TRAIN_CKPT} trees + train -resume to {TRAIN_TREES}: forest "
        "bit-identical to the uninterrupted run")
    out["replay"] = replay_phase(replay, device, trees)

    # card vs CPU on the plane's first CUT_ROWS rows
    cut = os.path.join(root, "plane_cut")
    write_plane(cut, bins[:CUT_ROWS], y[:CUT_ROWS], w[:CUT_ROWS], names,
                {"chip_smoke": "cut"})
    runs = []
    for name, dev in (("card", device), ("cpu", "cpu")):
        d = write_train_set(os.path.join(root, f"cut_{name}"), serve_root,
                            dict(params, TreeNum=CUT_TREES), cut)
        runs.append((train_cli(d, dev), load_forest(d), progress_errors(d)))
    out["cut"] = compare_cut(torch, *runs, bins[:CUT_ROWS], y[:CUT_ROWS],
                             device)
    out["plane"] = (bins, y, w, informative, is_cat, clean, cut, names)
    return out


def replay_phase(d: str, device: str, trees) -> dict:
    """``train -resume`` from a 5-tree checkpoint with no score sidecar:
    the restored trees replay through ``tree_traverse`` (counts zeroed
    just before, read just after; one launch for the one depth group),
    then 5 more trees grow (40 ``hist`` launches: 7 levels and the leaf
    sums a tree).  Split features and
    left masks must equal the uninterrupted forest's, leaves within
    REPLAY_RTOL (the replay adds each tree's leaf to the scores as the
    uninterrupted run does, so bit-equality is expected and reported)."""
    zero_tree_counts()
    wall = train_cli(d, device, "-resume")
    launches = read_tree_counts()
    grown = TRAIN_TREES - TRAIN_CKPT
    if launches["tree_traverse"] < 1 or launches["hist_batch"] != 0 or \
            launches["hist"] != grown * (DEPTH + 1) or \
            launches["leaf_sums"] != grown:
        fail(f"replay resume launched {launches}, not >= 1 tree_traverse, "
             f"{grown * (DEPTH + 1)} hist of which {grown} leaf sums")
    _, got = load_forest(d)
    if len(got) != len(trees):
        fail(f"replayed forest has {len(got)} trees")
    worst, bit_equal = 0.0, True
    for t, (a, b) in enumerate(zip(got, trees)):
        if not (np.array_equal(a.split_feat, b.split_feat)
                and np.array_equal(a.left_mask, b.left_mask)):
            fail(f"replayed forest splits differ from the uninterrupted "
                 f"one at tree {t}")
        d_leaf = np.abs(a.leaf_value - b.leaf_value)
        if not np.all(d_leaf <= REPLAY_RTOL * np.abs(b.leaf_value) + 1e-7):
            fail(f"replayed leaves differ by up to {d_leaf.max()} at tree "
                 f"{t}")
        worst = max(worst, float(d_leaf.max()))
        bit_equal &= a.leaf_value.tobytes() == b.leaf_value.tobytes()
    with open(os.path.join(d, "tmp", "profile.json")) as f:
        replay_s = json.load(f)["TRAIN"]["phases_s"].get("train/replay")
    log(f"{TRAIN_CKPT} trees without their score sidecar + train -resume "
        f"to {TRAIN_TREES}: launches {launches}; splits equal, leaves "
        f"within {worst:.3g} of the uninterrupted forest (bit-identical: "
        f"{bit_equal}); replay launch {replay_s} s, run {wall:.3f} s")
    return {"launches": launches, "max_abs_leaf_diff": worst,
            "bit_identical": bit_equal, "wall_s": wall}


def compare_cut(torch, card, cpu, bins, y, device: str) -> dict:
    """Levels 0-1 split alike, per-tree errors within ERR_RTOL, and the
    AUCs of the two forests' scores (walked by tree_traverse on the card)
    within AUC_TOL on the validation rows."""
    from shifu_tpu_torch.ops import tree_quant as tq
    from shifu_tpu_torch.train.sampling import validation_split
    (s_card, (spec_a, trees_a), err_a), (s_cpu, (spec_b, trees_b), err_b) \
        = card, cpu
    for t, (a, b) in enumerate(zip(trees_a, trees_b)):
        if not np.array_equal(a.split_feat[:3], b.split_feat[:3]):
            fail(f"tree {t}: levels 0-1 split on {a.split_feat[:3]} on the "
                 f"card, {b.split_feat[:3]} on the CPU")
    # below level 1 near-tie splits may go either way (ROADMAP Queue 3,
    # C4/C9): counted, not checked
    deeper = sum(int((a.split_feat != b.split_feat).sum())
                 for a, b in zip(trees_a, trees_b))
    if err_a.shape != (CUT_TREES, 2) or err_b.shape != (CUT_TREES, 2):
        fail(f"train.progress holds {len(err_a)} and {len(err_b)} trees")
    rel = np.abs(err_a - err_b) / np.abs(err_b)
    if not np.all(rel <= ERR_RTOL):
        fail(f"card vs CPU errors differ by up to {rel.max()} relative")
    vmask = validation_split(len(y), 0.2, 0)
    bins_d = torch.from_numpy(bins).to(device)
    aucs = []
    for spec, trees in ((spec_a, trees_a), (spec_b, trees_b)):
        pred = tq.predict_forest_quant(*tq.stack_forest_quant(trees, device),
                                       bins_d, DEPTH)
        score = (spec.init_score + spec.learning_rate * pred.sum(0)).cpu()
        aucs.append(auc(score.numpy()[vmask], y[vmask]))
    if abs(aucs[0] - aucs[1]) > AUC_TOL:
        fail(f"card vs CPU validation AUC {aucs[0]:.5f} vs {aucs[1]:.5f}")
    log(f"card vs CPU on {len(y)} rows x {CUT_TREES} trees: levels 0-1 "
        f"equal ({deeper} of {CUT_TREES * len(trees_a[0].split_feat)} "
        f"nodes split on another feature below them), errors within "
        f"{rel.max():.3g} relative, validation AUC {aucs[0]:.5f} vs "
        f"{aucs[1]:.5f}; train wall {s_card:.2f} s on the card, "
        f"{s_cpu:.2f} s on the CPU")
    return {"max_rel_err": float(rel.max()), "auc": aucs,
            "nodes_differ": deeper, "wall_s": [s_card, s_cpu]}


def chunk_phase(torch, bins, y, w, is_cat, device: str) -> dict:
    """One chunk of two full-width trees straight through
    ``gbt_forest_chunk`` on device-resident tensors: under
    ``set_sync_debug_mode("error")`` (any host sync raises), then timed
    (host wall around a synchronised chunk), then traced with
    ``torch.profiler`` for the device time by kernel."""
    from shifu_tpu_torch.train import dt_trainer as dt
    from shifu_tpu_torch.train.sampling import validation_split
    dev = torch.device(device)
    vmask = validation_split(len(y), 0.2, 0)
    bins_d = dt.put_bins(bins, N_BINS, dev)
    y_d, tw, vw = (torch.from_numpy(a.astype(np.float32)).to(dev)
                   for a in (y, w * ~vmask, w * vmask))
    settings = dt.DTSettings(n_trees=2, depth=DEPTH, loss="log",
                             learning_rate=0.1)
    fa = torch.ones((2, N_COLS), dtype=torch.bool, device=dev)
    cat = torch.from_numpy(is_cat).to(dev)
    f = torch.zeros(len(y), device=dev)

    def run():
        return dt.gbt_forest_chunk(bins_d, y_d, tw, vw, f, fa, cat,
                                   settings, N_BINS, "variance",
                                   bool(is_cat.any()))
    run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    walls = []
    for _ in range(CHUNK_REPEATS):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / 2)
    ms_tree = float(np.median(walls))
    quart = [float(q) for q in np.percentile(walls, [25, 75])]
    prof = profile_device(torch, run)
    log(f"a 2-tree chunk ran under set_sync_debug_mode('error') with no "
        f"host sync; {ms_tree:.3f} ms per tree (median of {CHUNK_REPEATS} "
        f"chunks, host wall; quartiles {quart[0]:.3f} / {quart[1]:.3f}), "
        f"{TRAIN_ROWS * 1e3 / ms_tree:.4g} rows x trees / s")
    return {"ms_per_tree": ms_tree, "quartiles_ms": quart, "profile": prof}


def profile_device(torch, run) -> dict:
    """Device time by kernel over one ``run()`` from ``torch.profiler``:
    kernel-busy ms per tree, its share of the run's profiled wall time,
    and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    if busy == 0.0:
        log("torch.profiler recorded no device time: breakdown not measured")
        return {}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    log(f"torch.profiler over one 2-tree chunk: kernels busy {busy:.3f} ms "
        f"of {wall_ms:.3f} ms profiled wall ({busy / wall_ms:.1%}); top "
        "kernels (ms, launches):")
    for name, (ms, n) in top:
        log(f"  {ms:9.3f} ms {n:5d}x  {name[:110]}")
    return {"busy_ms": busy, "wall_ms": wall_ms,
            "top": [(name[:110], ms, n) for name, (ms, n) in top]}



# ------------------------------------------------------- phase: RF train
def rf_phase(torch, root: str, serve_root: str, plane,
             device: str = "cuda") -> dict:
    """The Random Forest path at full width: ``init -model``'s RF
    defaults (TreeNum 10, MaxDepth 14, TWOTHIRDS, entropy, Loss squared)
    with CheckpointInterval 8 on the GBT phase's 1,048,576 x 256 plane,
    through ``cli.main train`` on ``cuda``.  The first chunk of 8 trees
    grows as one batch (one ``hist_batch`` launch a level: 14, and one
    ``hist`` launch a tree for its leaf sums: 8), the last 2 one by one
    (``hist``: 2 x 15); the counts are zeroed just before the run and
    read just after it.  Then: the chunk again on resident
    tensors, timed per level; 8 trees and ``train -resume`` to 10,
    bit-identical through a ``tree_traverse`` replay; card vs CPU on the
    plane's first CUT_ROWS rows at depth RF_CUT_DEPTH."""
    from shifu_tpu_torch.pipeline.create import _ALG_DEFAULT_PARAMS
    bins, y, w, informative, is_cat, clean, cut, names = plane
    params = dict(_ALG_DEFAULT_PARAMS["RF"][1], CheckpointInterval=RF_CKPT)
    if (params["TreeNum"], params["MaxDepth"]) != (RF_TREES, RF_DEPTH):
        fail(f"init -model's RF defaults changed: {params}")
    full = write_train_set(os.path.join(root, "rf"), serve_root, params,
                           clean, "RF")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_tree_counts()
    wall = train_cli(full, device)
    launches = read_tree_counts()
    peak = torch.cuda.max_memory_allocated() - base
    want = {"hist_batch": RF_DEPTH,
            "hist": RF_CKPT + (RF_TREES - RF_CKPT) * (RF_DEPTH + 1),
            "leaf_sums": RF_TREES, "tree_traverse": 0}
    if launches != want:
        fail(f"RF train launched {launches}, not {want}")

    spec, trees = load_forest(full, "rf")
    nodes = (1 << (RF_DEPTH + 1)) - 1
    if spec.algorithm != "RF" or spec.n_trees != RF_TREES or \
            len(trees) != RF_TREES or spec.depth != RF_DEPTH:
        fail(f"model0.rf: {spec.algorithm}, {len(trees)} trees of depth "
             f"{spec.depth}")
    if any(t.split_feat.shape != (nodes,) or t.split_feat[0] < 0
           for t in trees):
        fail("an RF tree has the wrong node count or no root split")
    deep = min(int((t.split_feat[(1 << (RF_DEPTH - 1)) - 1:] >= 0).sum())
               for t in trees)
    err = progress_errors(full)
    if err.shape != (RF_TREES, 2) or not np.isfinite(err).all() \
            or not err[-1, 1] < err[0, 1]:
        fail(f"RF errors: {err.tolist()} (out-of-bag error must fall)")
    with open(os.path.join(full, "tmp", "feature_importance.json")) as f:
        fi = json.load(f)
    top = names.index(max(fi, key=fi.get))
    roots = [int(t.split_feat[0]) for t in trees]
    if any(r not in informative for r in roots):
        fail(f"RF root splits on {[names[r] for r in roots]}, not all "
             f"informative columns {[names[i] for i in informative]}")
    ck = os.path.join(full, "tmp", "checkpoints", "forest_ckpt.npz")
    for path in (ck, ck + ".meta.json",
                 os.path.join(full, "tmp", "journal", "TRAIN.json")):
        if not os.path.isfile(path):
            fail(f"RF train left no {path}")
    with open(os.path.join(full, "tmp", "profile.json")) as f:
        phases = json.load(f)["TRAIN"]["phases_s"]
    if any(p not in phases for p in TRAIN_PARTS):
        fail(f"profile.json does not split the RF train phase: {phases}")
    phases["train/other"] = round(
        phases["train"] - sum(phases[p] for p in TRAIN_PARTS), 3)
    log(f"main path (RF train): {RF_TREES} trees of depth {RF_DEPTH} "
        f"({nodes} nodes; every tree splits >= {deep} nodes on its deepest "
        f"split level) in {wall:.3f} s wall ({phases}); train error "
        f"{err[0, 0]:.6f} -> {err[-1, 0]:.6f}, out-of-bag {err[0, 1]:.6f} "
        f"-> {err[-1, 1]:.6f}; roots on informative "
        f"{sorted({names[r] for r in roots})}, top feature {names[top]}; "
        f"launches "
        f"{launches}; peak device memory {peak / 2**30:.3f} GiB")
    out = {"launches": launches, "wall_s": wall, "phases_s": phases,
           "errors": err.tolist(), "peak_bytes": peak}
    out["chunk"] = rf_chunk_phase(torch, full, bins, y, w, is_cat, trees,
                                  params, device)

    # resume: stop after the 8-tree checkpoint, then -resume to 10
    part = write_train_set(os.path.join(root, "rf_resume"), serve_root,
                           dict(params, TreeNum=RF_CKPT), clean, "RF")
    train_cli(part, device)
    set_train_params(part, params)
    zero_tree_counts()
    resume_wall = train_cli(part, device, "-resume")
    r_launches = read_tree_counts()
    if r_launches["tree_traverse"] < 1 or r_launches["hist_batch"] != 0 \
            or r_launches["hist"] != (RF_TREES - RF_CKPT) * (RF_DEPTH + 1) \
            or r_launches["leaf_sums"] != RF_TREES - RF_CKPT:
        fail(f"RF resume launched {r_launches}")
    _, got = load_forest(part, "rf")
    if len(got) != RF_TREES:
        fail(f"resumed RF has {len(got)} trees")
    for t, (a, b) in enumerate(zip(got, trees)):
        if any(getattr(a, k).tobytes() != getattr(b, k).tobytes()
               for k in ("split_feat", "left_mask", "leaf_value")):
            fail(f"resumed RF differs from the uninterrupted one at tree {t}")
    if not np.array_equal(progress_errors(part), err[RF_CKPT:]):
        fail("resumed RF's errors differ from the uninterrupted run's")
    with open(os.path.join(part, "tmp", "profile.json")) as f:
        replay_s = json.load(f)["TRAIN"]["phases_s"].get("train/replay")
    log(f"RF: {RF_CKPT} trees + train -resume to {RF_TREES}: launches "
        f"{r_launches} (the {RF_CKPT} restored {nodes}-node trees replay "
        f"their bags through tree_traverse in {replay_s} s); forest and "
        f"errors bit-identical to the uninterrupted run; run "
        f"{resume_wall:.3f} s")
    out["resume"] = {"launches": r_launches, "wall_s": resume_wall,
                     "replay_s": replay_s}
    out["cut"] = compare_rf_cut(torch, root, serve_root, params, cut,
                                bins[:CUT_ROWS], y[:CUT_ROWS], device)
    return out


def rf_settings(d: str, params: dict):
    """The trainer's settings for model set ``d`` under ``params``."""
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    from shifu_tpu_torch.train import dt_trainer as dt
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    return dt.settings_from_params(params, mc.train, Algorithm.RF)


def rf_chunk_phase(torch, full, bins, y, w, is_cat, trees, params,
                   device: str) -> dict:
    """The RF run's chunks again, straight through ``rf_forest_chunk`` on
    device-resident tensors: the 8-tree batch under
    ``set_sync_debug_mode("error")`` (no host sync once the bags are
    drawn), then the 2-tree remainder, each timed on the host around a
    synchronised chunk, with CUDA events around every histogram launch
    and leaf-sum level (device ms by level).  Both must reproduce the CLI
    run's trees bit for bit."""
    from shifu_tpu_torch.ops import tree as tree_ops
    from shifu_tpu_torch.train import dt_trainer as dt
    dev = torch.device(device)
    settings = rf_settings(full, params)
    bins_d = dt.put_bins(bins, N_BINS, dev)
    y_d, w_d = (torch.from_numpy(a).to(dev) for a in (y, w))
    cat = torch.from_numpy(is_cat).to(dev)
    fa = torch.from_numpy(np.stack([dt._feat_subset(settings, N_COLS, t)
                                    for t in range(RF_TREES)])).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bags = dt.draw_bags(settings, range(RF_TREES), len(y), dev)
    torch.cuda.synchronize()
    bag_ms = (time.perf_counter() - t0) * 1e3
    zero = torch.zeros(len(y), device=dev)

    events, inside = [], []

    def timed(name, fn):
        def call(*a, **k):
            if inside:             # B1 under the leaf sums: theirs
                return fn(*a, **k)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            inside.append(name)
            try:
                r = fn(*a, **k)
            finally:
                inside.pop()
            e1.record()
            events.append((name, e0, e1))
            return r
        call.launches = 0          # the wrapped function counts into this
        return call

    real = {n: getattr(tree_ops, n) for n in
            ("build_histograms_batch", "build_histograms", "_level_leaf_raw")}
    for n, fn in real.items():
        setattr(tree_ops, n, timed(n, fn))
    out = {"bag_ms": bag_ms}
    try:
        for part, sl, debug in (("batch", slice(0, RF_CKPT), True),
                                ("remainder", slice(RF_CKPT, RF_TREES),
                                 False)):
            events.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if debug:
                torch.cuda.set_sync_debug_mode("error")
            try:
                _, _, packed = dt.rf_forest_chunk(
                    bins_d, y_d, w_d, bags[sl], zero, zero, fa[sl], cat,
                    settings, N_BINS, bool(is_cat.any()), HIST_BATCH)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            levels = {}
            for name, e0, e1 in events:
                levels.setdefault(name, []).append(e0.elapsed_time(e1))
            n_trees = sl.stop - sl.start
            for j, row in enumerate(packed.cpu().numpy()):
                tree = dt._unpack_tree(row, (1 << (RF_DEPTH + 1)) - 1,
                                       N_BINS, N_COLS, RF_DEPTH)[0]
                want = trees[sl.start + j]
                if any(getattr(tree, k).tobytes() != getattr(want, k)
                       .tobytes() for k in ("split_feat", "left_mask",
                                            "leaf_value")):
                    fail(f"RF {part} chunk tree {j} differs from the CLI "
                         "run's")
            leaf_ms = levels.get("_level_leaf_raw", [])
            out[part] = {"ms_per_tree": ms / n_trees, "levels_ms": levels,
                         "leaf_ms_per_tree_max": max(leaf_ms, default=0.0)}
            hist_name = "build_histograms_batch" if part == "batch" \
                else "build_histograms"
            per_level = levels.get(hist_name, [])
            log(f"RF {part}: {n_trees} trees in {ms:.1f} ms, "
                f"{ms / n_trees:.1f} ms per tree (host wall around a "
                f"synchronised chunk{', no host sync inside' if debug else ''}"
                f"); {hist_name} device ms by launch "
                f"{[round(v, 3) for v in per_level]}; leaf sums "
                f"{sum(leaf_ms):.1f} ms (at most {max(leaf_ms, default=0):.3f}"
                f" ms a tree, {len(leaf_ms)} trees)")
    finally:
        for n, fn in real.items():
            setattr(tree_ops, n, fn)
    log(f"RF bags: {RF_TREES} x {len(y)} Poisson draws in {bag_ms:.1f} ms")
    return out


def compare_rf_cut(torch, root, serve_root, params, cut, bins, y,
                   device: str) -> dict:
    """RF at depth RF_CUT_DEPTH on the plane's first CUT_ROWS rows, on the
    card and on the CPU: the bags drawn on each equal (0 rows differ),
    levels 0-1 split alike, per-tree errors within ERR_RTOL relative, and
    the two forests' AUCs (scored by tree_traverse on the card) within
    AUC_TOL."""
    from shifu_tpu_torch.ops import tree_quant as tq
    from shifu_tpu_torch.train import dt_trainer as dt
    params = dict(params, MaxDepth=RF_CUT_DEPTH)
    runs, sets = [], []
    for name, dev in (("card", device), ("cpu", "cpu")):
        d = write_train_set(os.path.join(root, f"rf_cut_{name}"), serve_root,
                            params, cut, "RF")
        sets.append(d)
        runs.append((train_cli(d, dev), load_forest(d, "rf"),
                     progress_errors(d)))
    settings = rf_settings(sets[0], params)
    bags = [dt.draw_bags(settings, range(RF_TREES), CUT_ROWS, dev).cpu()
            for dev in (device, "cpu")]
    bag_diff = int((bags[0] != bags[1]).sum())
    if bag_diff:
        fail(f"RF bags drawn on the card and the CPU differ in {bag_diff} "
             "rows")
    (s_card, (_, trees_a), err_a), (s_cpu, (_, trees_b), err_b) = runs
    for t, (a, b) in enumerate(zip(trees_a, trees_b)):
        if not np.array_equal(a.split_feat[:3], b.split_feat[:3]):
            fail(f"RF tree {t}: levels 0-1 split on {a.split_feat[:3]} on "
                 f"the card, {b.split_feat[:3]} on the CPU")
    deeper = sum(int((a.split_feat != b.split_feat).sum())
                 for a, b in zip(trees_a, trees_b))
    if err_a.shape != (RF_TREES, 2) or err_b.shape != (RF_TREES, 2):
        fail(f"RF train.progress holds {len(err_a)} and {len(err_b)} trees")
    rel = np.abs(err_a - err_b) / np.abs(err_b)
    if not np.all(rel <= ERR_RTOL):
        fail(f"RF card vs CPU errors differ by up to {rel.max()} relative")
    bins_d = torch.from_numpy(bins).to(device)
    aucs = []
    for trees in (trees_a, trees_b):
        pred = tq.predict_forest_quant(*tq.stack_forest_quant(trees, device),
                                       bins_d, RF_CUT_DEPTH)
        aucs.append(auc(pred.mean(0).cpu().numpy(), y))
    if abs(aucs[0] - aucs[1]) > AUC_TOL:
        fail(f"RF card vs CPU AUC {aucs[0]:.5f} vs {aucs[1]:.5f}")
    log(f"RF card vs CPU on {len(y)} rows x {RF_TREES} trees of depth "
        f"{RF_CUT_DEPTH}: bags equal ({bag_diff} rows differ), levels 0-1 "
        f"equal ({deeper} of {RF_TREES * len(trees_a[0].split_feat)} nodes "
        f"split on another feature below them), errors within "
        f"{rel.max():.3g} relative, AUC {aucs[0]:.5f} vs {aucs[1]:.5f}; "
        f"train wall {s_card:.2f} s on the card, {s_cpu:.2f} s on the CPU")
    return {"bag_rows_differ": bag_diff, "max_rel_err": float(rel.max()),
            "auc": aucs, "nodes_differ": deeper, "wall_s": [s_card, s_cpu]}


# ---------------------------------------------------------- phase: stats
def stats_inputs(torch, rng, n, c, b, s):
    """B3 inputs on the card: bucket ids uniform in [0, B) with ~5% of
    cells missing (-1); stats [pos, neg] 0/1 indicators, and with S = 4
    also [w * pos, w * neg] with w uniform in [0.5, 3)."""
    idx = rng.integers(0, b, size=(n, c), dtype=np.int32)
    idx[rng.random((n, c)) < 0.05] = -1
    pos = (rng.random(n) < 0.3).astype(np.float32)
    chans = [pos, 1.0 - pos]
    if s == 4:
        w = rng.uniform(0.5, 3.0, n).astype(np.float32)
        chans += [w * pos, w * (1.0 - pos)]
    exact = (True, True) + (False,) * (s - 2)
    return [torch.from_numpy(a).to("cuda")
            for a in (idx, np.stack(chans, axis=1))] + [exact]


def check_stats_hist(torch, rng) -> dict:
    """B3 against its plain version on the card: counts bit-equal,
    weighted channels within STATS_TOL of the plain value, a relaunch
    bit-identical.  Returns the max |kernel - plain| seen."""
    from shifu_tpu_torch.ops import stats_hist as sh
    err = 0.0
    for n, c, b, s in STATS_CASES:
        idx, st, exact = stats_inputs(torch, rng, n, c, b, s)
        got = sh.stats_histograms(idx, st, b, exact)
        again = sh.stats_histograms(idx, st, b, exact)
        want = sh.stats_histograms_ref(idx, st, b)
        torch.cuda.synchronize()
        where = f"N={n} C={c} B={b} S={s}"
        d = (got - want).abs()
        if got.shape != (c, b, s) or not torch.equal(got, again):
            fail(f"stats_hist: two launches differ at {where}")
        if not torch.equal(got[..., :2], want[..., :2]):
            fail(f"stats_hist counts != plain version at {where}")
        if not bool((d <= STATS_TOL * want.abs()).all()):
            fail(f"stats_hist weighted cells beyond {STATS_TOL} relative "
                 f"at {where} (max |d| {d.max().item()})")
        err = max(err, d.max().item())
        log(f"stats_hist == plain version at {where}: counts equal, max "
            f"|d| {d.max().item():.3g}, relaunch bit-equal")
        del idx, st, got, again, want, d
    return {"stats_hist": err}


def write_stats_csv(path: str, rng, plan, n: int) -> float:
    """The raw data of the smoke's column plan as a '|'-delimited CSV, its
    header row in ``<path>.header``: 224 numeric columns (~5% empty cells), 32 categorical
    columns of their 20-60 categories, an integer ``weight`` 1..3 and a
    ``tag`` (bad/good) drawn from a logit on two numeric columns and one
    categorical.  Returns the positive rate."""
    cols, names = [], []
    logit = np.full(n, -1.0)
    for j, (kind, name, a, b) in enumerate(plan):
        if kind == "num":
            v = rng.normal(a, b, size=n)
            if j < 2:
                logit += (v - a) / b
            cells = np.array([f"{x:.6g}" for x in v], dtype=object)
            cells[rng.random(n) < 0.05] = ""
        else:
            k = rng.integers(0, len(a), size=n)
            if j == N_NUM:
                logit += rng.normal(0, 1, size=len(a))[k]
            cells = np.asarray(a, dtype=object)[k]
        cols.append(cells)
        names.append(name)
    y = rng.random(n) < 1.0 / (1.0 + np.exp(-logit))
    cols.append(rng.integers(1, 4, size=n).astype(str).astype(object))
    cols.append(np.where(y, "bad", "good").astype(object))
    with open(path + ".header", "w") as f:
        f.write("|".join(names + ["weight", "tag"]) + "\n")
    with open(path, "w") as f:
        f.write("\n".join("|".join(r) for r in zip(*cols)) + "\n")
    return float(y.mean())


def stats_cli(d: str, device: str, *props: str) -> float:
    from shifu_tpu_torch import cli
    t0 = time.perf_counter()
    rc = cli.main(["--dir", d, *props, "stats", "--device", device])
    if rc != 0:
        fail(f"stats on {device} exited {rc} in {d}")
    return time.perf_counter() - t0


def compare_column_configs(got, want, where="", worst=None) -> dict:
    """Integers, strings, categories and binBoundary equal; floats within
    CARD_CPU_RTOL relative + CARD_CPU_ATOL.  Returns the largest float
    difference seen, absolute and relative, with where each was."""
    if worst is None:
        worst = {"abs": (0.0, ""), "rel": (0.0, "")}
    if isinstance(want, dict):
        if set(got) != set(want):
            fail(f"ColumnConfig keys differ at {where}")
        for k in want:
            compare_column_configs(got[k], want[k], f"{where}.{k}", worst)
    elif isinstance(want, list) and not where.endswith(".binBoundary"):
        if not isinstance(got, list) or len(got) != len(want):
            fail(f"ColumnConfig lists differ at {where}")
        for i, (g, w) in enumerate(zip(got, want)):
            compare_column_configs(g, w, f"{where}[{i}]", worst)
    elif isinstance(want, float) and isinstance(got, float) and got != want:
        d = abs(got - want)
        if d > CARD_CPU_RTOL * abs(want) + CARD_CPU_ATOL:
            fail(f"card vs CPU ColumnConfig {where}: {got} vs {want}")
        worst["abs"] = max(worst["abs"], (d, where))
        worst["rel"] = max(worst["rel"], (d / abs(want), where))
    elif got != want:
        fail(f"card vs CPU ColumnConfig {where}: {got!r} vs {want!r}")
    return worst


def stats_phase(torch, root: str, plan, rng) -> dict:
    """``new → init → stats`` through the CLI a user calls, on the card:
    a synthetic CSV at the full width of the column plan (CSV_ROWS rows,
    a cut in rows only), chunks of CSV_CHUNK rows and a fused budget that
    keeps 2 of the 4 chunks resident and overflows 2 into the provisional
    grid.  The ``stats_hist`` count is zeroed just before ``stats`` and
    read just after (4 launches: one a chunk).  The same set's ``stats``
    on the CPU must give the same ColumnConfig.json (see
    compare_column_configs)."""
    from shifu_tpu_torch import cli
    from shifu_tpu_torch.config import ModelConfig, environment
    from shifu_tpu_torch.config.path_finder import PathFinder
    from shifu_tpu_torch.data import parsepool
    from shifu_tpu_torch.data.extract import ChunkExtractor
    from shifu_tpu_torch.data.reader import DataSource
    from shifu_tpu_torch.ops import stats_hist as sh
    from shifu_tpu_torch.config import load_column_configs
    base = os.path.join(root, "stats")
    os.makedirs(base)
    csv = os.path.join(base, "data.csv")
    t0 = time.perf_counter()
    pos_rate = write_stats_csv(csv, rng, plan, CSV_ROWS)
    log(f"stats CSV written in {time.perf_counter() - t0:.2f} s: {CSV_ROWS} "
        f"rows x {N_COLS + 2} fields, positive rate {pos_rate:.4f}")
    if cli.main(["--dir", base, "new", "card"]) != 0:
        fail("new exited non-zero")
    d = os.path.join(base, "card")
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    ds = mc.dataSet
    ds.dataPath, ds.dataDelimiter, ds.targetColumnName = csv, "|", "tag"
    ds.posTags, ds.negTags, ds.weightColumnName = ["bad"], ["good"], "weight"
    ds.headerPath, ds.headerDelimiter = csv + ".header", "|"
    mc.save(os.path.join(d, "ModelConfig.json"))
    t0 = time.perf_counter()
    if cli.main(["--dir", d, "init"]) != 0:
        fail("init exited non-zero")
    init_s = time.perf_counter() - t0
    ccs = load_column_configs(os.path.join(d, "ColumnConfig.json"))
    kinds = [(c.is_categorical(), c.is_candidate()) for c in ccs]
    if kinds.count((False, True)) != N_NUM or \
            kinds.count((True, True)) != N_CAT:
        fail(f"init typed {kinds.count((False, True))} numeric and "
             f"{kinds.count((True, True))} categorical candidates")
    cpu_dir = os.path.join(base, "cpu")
    shutil.copytree(d, cpu_dir)

    prev_chunk, parsepool.CHUNK_ROWS = parsepool.CHUNK_ROWS, CSV_CHUNK
    budget = f"-Dshifu.stats.fusedBudgetBytes={2 * CHUNK_BYTES}"
    try:
        sh.stats_histograms_cuda.launches = 0
        wall = stats_cli(d, "cuda", budget)
        launches = sh.stats_histograms_cuda.launches
        cpu_wall = stats_cli(cpu_dir, "cpu", budget)
        # the host parse alone: the same chunks through the extractor
        mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
        src = DataSource(csv, "|", header_path=csv + ".header")
        ex = ChunkExtractor(mc, load_column_configs(
            PathFinder(mc, d).column_config_path))
        t0 = time.perf_counter()
        for chunk in src.iter_chunks(CSV_CHUNK):
            ex.extract(chunk)
        parse_s = time.perf_counter() - t0
    finally:
        parsepool.CHUNK_ROWS = prev_chunk
        environment.reset_for_tests()       # drop the -D budget
    if launches != CSV_ROWS // CSV_CHUNK:
        fail(f"stats launched stats_hist {launches} times for "
             f"{CSV_ROWS // CSV_CHUNK} chunks")
    with open(os.path.join(d, "tmp", "profile.json")) as f:
        phases = json.load(f)["STATS"]["phases_s"]
    with open(os.path.join(d, "ColumnConfig.json")) as f:
        card = json.load(f)
    with open(os.path.join(cpu_dir, "ColumnConfig.json")) as f:
        cpu = json.load(f)
    numeric = [c for c in card if c["columnBinning"].get("binBoundary")]
    for c in numeric:
        st, bn = c["columnStats"], c["columnBinning"]
        if st["totalCount"] != CSV_ROWS or \
                sum(bn["binCountPos"]) + sum(bn["binCountNeg"]) != CSV_ROWS \
                or len(bn["binBoundary"]) < 2 \
                or not all(math.isfinite(v) for v in bn["binBoundary"][1:]):
            fail(f"stats wrote a bad numeric column {c['columnName']}")
    if len(numeric) != N_NUM:
        fail(f"{len(numeric)} numeric columns binned, not {N_NUM}")
    if len(card) != len(cpu):
        fail(f"{len(card)} columns on the card, {len(cpu)} on the CPU")
    worst = None
    for a, b in zip(card, cpu):
        worst = compare_column_configs(a, b, a["columnName"], worst)
    cells = CSV_ROWS * (N_COLS + 2)
    log(f"main path (stats): new + init ({init_s:.2f} s) + stats on the "
        f"card in {wall:.3f} s ({phases}); {launches} stats_hist launches; "
        f"card vs CPU ColumnConfig: counts, categories and boundaries "
        f"equal, floats within {worst['abs'][0]:.3g} absolute (at "
        f"{worst['abs'][1]}) and {worst['rel'][0]:.3g} relative (at "
        f"{worst['rel'][1]}); CPU stats {cpu_wall:.2f} s; the host parse "
        f"alone takes {parse_s:.3f} s, "
        f"{parse_s * 1e6 / cells:.3f} us a cell")
    return {"launches": {"stats_hist": launches}, "wall_s": wall,
            "init_s": init_s, "cpu_wall_s": cpu_wall, "phases_s": phases,
            "parse_s": parse_s, "parse_us_per_cell": parse_s * 1e6 / cells,
            "float_diff": worst}


def resident_phase(torch, seed: int) -> dict:
    """The port's NumericAccumulator on the card at a deployment's size:
    weighted (S = 4), RESIDENT_CHUNKS chunks of 262,144 rows x 224
    columns made on the card from ``seed``; with the default 1 GiB fused
    budget 3 chunks stay resident and 5 overflow, so both sides of
    finalize_fused run at full size.  Times each chunk update and the
    finalize, counts B3 launches (zeroed just before), reads the peak
    device memory; then holds the first two chunks against the CPU path
    (counts and boundaries equal)."""
    from shifu_tpu_torch.config.model_config import BinningMethod
    from shifu_tpu_torch.ops import stats_hist as sh
    from shifu_tpu_torch.ops.binning import NumericAccumulator
    gen = torch.Generator(device="cuda")

    def chunk(i):
        gen.manual_seed(seed * 1000 + i)
        n, c = RESIDENT_ROWS, N_NUM
        shift = torch.arange(c, device="cuda", dtype=torch.float32)
        x = torch.randn((n, c), generator=gen, device="cuda") \
            * (1.0 + shift / 16) + shift
        valid = torch.rand((n, c), generator=gen, device="cuda") > 0.05
        t = (torch.rand(n, generator=gen, device="cuda") < 0.3).float()
        w = torch.rand(n, generator=gen, device="cuda") * 2.5 + 0.5
        return x, valid, t, w

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    acc = NumericAccumulator(n_cols=N_NUM, device="cuda")
    sh.stats_histograms_cuda.launches = 0
    update_ms = []
    for i in range(RESIDENT_CHUNKS):
        args = chunk(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc.update_fused(*args)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
        del args
    resident = len(acc._fused_chunks)
    t0 = time.perf_counter()
    acc.finalize_fused()
    sketch = acc.finalize_sketch(BinningMethod.EqualPositive, 10)
    torch.cuda.synchronize()
    finalize_ms = (time.perf_counter() - t0) * 1e3
    launches = sh.stats_histograms_cuda.launches
    peak = torch.cuda.max_memory_allocated() - base
    if launches != RESIDENT_CHUNKS or resident != 3:
        fail(f"resident accumulator: {launches} stats_hist launches, "
             f"{resident} chunks kept")
    if any(len(b) < 2 for b in sketch[0]):
        fail("resident accumulator left a column unbinned")
    del acc, sketch

    out = []
    for dev in ("cuda", "cpu"):
        acc = NumericAccumulator(n_cols=N_NUM, device=dev)
        for i in range(2):
            acc.update_fused(*(a.to(dev) for a in chunk(i)))
        acc.finalize_fused()
        out.append(acc.finalize_sketch(BinningMethod.EqualPositive, 10))
        del acc
    (bg, ag, pg, dg), (bc, ac, pc, dc) = out
    for j in range(N_NUM):
        if not (np.array_equal(bg[j], bc[j])
                and np.array_equal(ag[j][:, :2], ac[j][:, :2])):
            fail(f"resident accumulator: card vs CPU counts or boundaries "
                 f"differ at column {j}")
    if not (np.array_equal(pg, pc) and np.array_equal(dg, dc)):
        fail("resident accumulator: card vs CPU percentiles differ")
    per_chunk = float(np.median(update_ms))
    log(f"resident accumulator: {RESIDENT_CHUNKS} chunks of {RESIDENT_ROWS} "
        f"x {N_NUM} weighted, {resident} resident; update "
        f"{per_chunk:.3f} ms a chunk (median; all {[round(v, 3) for v in update_ms]}), "
        f"finalize {finalize_ms:.3f} ms, {launches} stats_hist launches, "
        f"peak device memory {peak / 2**30:.3f} GiB; first 2 chunks: "
        "card == CPU counts, boundaries, percentiles")
    return {"launches": launches, "update_ms": update_ms,
            "update_ms_median": per_chunk, "finalize_ms": finalize_ms,
            "peak_bytes": peak, "resident_chunks": resident}

# ------------------------------------------------------- phase: timing
def traverse_forest(torch, tq, rng):
    """``random_forest``'s serving forest on the card, and the keyword
    arguments that hand a version's packed form of it to
    ``predict_forest_quant`` (none for a version without one), packed once
    as a caller that pins the forest does."""
    sf, lm, lv = random_forest(rng, N_TREES, DEPTH, N_BINS, N_COLS)
    forest = [torch.from_numpy(a).to("cuda")
              for a in (sf, lm.astype(np.uint8), lv)]
    packed = {"packed": tq.pack_forest(*forest, DEPTH)} \
        if hasattr(tq, "pack_forest") else {}
    return forest, packed


def time_kernels(torch, tq, rng, gpu: str) -> dict:
    forest, packed = traverse_forest(torch, tq, rng)
    sf = forest[0]
    out = {}
    for n in TRAVERSE_ROWS:
        bins = torch.from_numpy(rng.integers(
            0, N_BINS, size=(n, N_COLS)).astype(np.uint8)).to("cuda")
        if not torch.equal(tq.predict_forest_quant(*forest, bins, DEPTH,
                                                   **packed),
                           tq.predict_forest_quant_ref(*forest, bins, DEPTH)):
            fail(f"tree_traverse != plain version at N={n} (timed)")
        ms = device_ms(torch, lambda: tq.predict_forest_quant(
            *forest, bins, DEPTH, **packed))
        plain_ms = device_ms(torch, lambda: tq.predict_forest_quant_ref(
            *forest, bins, DEPTH), launches=3 if n <= 65536 else 1,
            repeats=5 if n <= 65536 else 3)
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
        log(f"tree_traverse N={n} (bit-equal to the plain version): "
            f"kernel {ms:.5f} ms, plain "
            f"{plain_ms:.4f} ms, bound {out[n]['bound_ms']:.6f} ms "
            f"({out[n]['bound_by']}: {need['bytes'] / 1e6:.3f} MB read "
            f"and written, {need['split_steps']} split steps; the whole "
            f"forest and plane would be {whole / 1e6:.3f} MB) — [{gpu}]")
    return out


def time_parts(torch, bins, node_b, stats_b, k: int) -> dict:
    """A histogram launch's device ms by part, on [TB, N] node ids and [TB,
    N, S] stats (B1 at TB = 1): ``hist.launch_until`` stopped after the
    partition (the wrapper's channel scan and the block set-up included),
    after the row walk (staging, bin loads), after the adds, then the
    production launch whole (the flush and finalize); each part is the
    difference of two neighbours."""
    from shifu_tpu_torch.ops import hist
    steps = [(name, lambda stop=stop: hist.launch_until(
        bins, node_b, stats_b, k, N_BINS, stop)) for name, stop in
        (("partition", hist.SETUP), ("walk", hist.WALK),
         ("adds", hist.ADDS))]
    steps.append(("flush", lambda: hist.build_histograms_batch_cuda(
        bins, node_b, stats_b, k, N_BINS)))
    out, prev = {}, 0.0
    for name, launch in steps:
        cum = device_ms(torch, launch, launches=5, repeats=3)
        out[name] = cum - prev
        prev = cum
    return out


def time_hist(torch, rng, gpu: str) -> dict:
    """B1 at N=1,048,576 rows of 256 uint8 columns, 64 bins, S=2, for K in
    HIST_TIMED_NODES on ``hist_inputs``' data, each held to the plain
    versions first (``held_to_plain``): the kernel (its wrapper's device
    work included), its split by part, the plain version, and one
    ``scatter_add_`` of every active (row, column) into the flat [K*C*B,
    S] f32 buffer with the cell index computed beforehand; the bound
    counts what this data makes the build move (``hist_bytes``) and one
    add per active (row, column, channel)."""
    from shifu_tpu_torch.ops import hist
    from shifu_tpu_torch.ops.tree import build_histograms
    out = {}
    for k in HIST_TIMED_NODES:
        bins, node, stats = hist_inputs(torch, rng, TRAIN_ROWS, N_COLS,
                                        N_BINS, k)
        d = held_to_plain(torch, hist, build_histograms(
            bins, node, stats, k, N_BINS), bins, node, stats, k, N_BINS,
            f"N={TRAIN_ROWS} K={k} (timed)", "hist")
        ms = device_ms(torch, lambda: build_histograms(bins, node, stats, k,
                                                       N_BINS))
        parts = time_parts(torch, bins, node[None], stats[None], k)
        plain_ms = device_ms(torch, lambda: hist.build_histograms_ref(
            bins, node, stats, k, N_BINS), launches=2, repeats=3)
        act = (node >= 0).nonzero()[:, 0]
        cols = torch.arange(N_COLS, device="cuda")
        cell = ((node[act].long() * N_COLS)[:, None] + cols) * N_BINS \
            + bins[act].long()
        idx = cell.reshape(-1, 1).expand(-1, 2)
        src = stats[act][:, None, :].expand(-1, N_COLS, -1).reshape(-1, 2)
        del cell
        flat = torch.zeros((k * N_COLS * N_BINS, 2), device="cuda")
        library_ms = device_ms(torch, lambda: flat.scatter_add_(0, idx, src),
                               launches=3, repeats=5)
        nbytes = hist.hist_bytes(bins, node, stats, k, N_BINS)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = act.numel() * N_COLS * 2 / INT_OPS_PER_S * 1e3
        plan = hist.hist_plan(TRAIN_ROWS, N_COLS, 1, k, N_BINS, 2)
        out[k] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": max(bytes_ms, ops_ms),
                  "bound_by": "bytes" if bytes_ms >= ops_ms
                  else "operations", "bytes": nbytes,
                  "active_rows": int(act.numel()), "parts_ms": parts,
                  "plan": plan, "max_abs_err": d}
        log(f"hist N={TRAIN_ROWS} K={k}: kernel {ms:.5f} ms (by part "
            + ", ".join(f"{n} {v:.4f}" for n, v in parts.items())
            + f"), plain {plain_ms:.4f} ms, scatter_add_ {library_ms:.4f} "
            f"ms, bound {out[k]['bound_ms']:.6f} ms ({out[k]['bound_by']}: "
            f"{nbytes / 1e6:.3f} MB, {act.numel()} active rows; plan "
            f"{plan}) — [{gpu}]")
        del bins, node, stats, act, idx, src, flat
        torch.cuda.empty_cache()
    return out


def time_hist_batch(torch, rng, gpu: str) -> dict:
    """B2 at TB=8 over N=1,048,576 rows of 256 uint8 columns, 64 bins,
    S=2, for each K in HIST_BATCH_NODES (K=4096: the deepest level of a
    depth-14 tree) on ``batch_inputs``' data: the kernel (its wrapper's
    device work included), its split by part, 8 B1 launches, the plain
    version,
    and one ``scatter_add_`` of every tree's active (row, column) into
    the flat [TB*K*C*B, S] f32 buffer with the cell index computed
    beforehand; the bound counts what this data makes the build move
    (``hist_batch_bytes``: the bins once, each tree's node ids and
    active stats, the output) and one add per active (tree, row, column,
    channel)."""
    from shifu_tpu_torch.ops import hist
    from shifu_tpu_torch.ops.tree import (build_histograms,
                                          build_histograms_batch)
    out = {}
    tb = HIST_BATCH
    torch.cuda.empty_cache()
    for k in HIST_BATCH_NODES:
        bins, node, stats = batch_inputs(torch, rng, TRAIN_ROWS, N_COLS,
                                         N_BINS, k, tb)
        ms = device_ms(torch, lambda: build_histograms_batch(
            bins, node, stats, k, N_BINS), launches=10, repeats=5)
        # the sequential alternative: one B1 launch a tree
        b1_ms = device_ms(torch, lambda: [build_histograms(
            bins, node[t], stats[t], k, N_BINS) for t in range(tb)],
            launches=2, repeats=3)
        parts = time_parts(torch, bins, node, stats, k)
        plain_ms = device_ms(torch, lambda: hist.build_histograms_batch_ref(
            bins, node, stats, k, N_BINS), launches=1, repeats=3)
        plan = hist.hist_plan(TRAIN_ROWS, N_COLS, tb, k, N_BINS, 2)
        nbytes = hist.hist_batch_bytes(bins, node, stats, k, N_BINS)
        act = (node >= 0).nonzero()                   # [M, 2] (tree, row)
        n_act = int(act.shape[0])
        cols = torch.arange(N_COLS, device="cuda")
        cell = ((act[:, 0] * k + node[act[:, 0], act[:, 1]].long())
                * N_COLS)[:, None] + cols        # [M, C] int64, in place on
        cell.mul_(N_BINS).add_(bins[act[:, 1]])  # (memory: M*C is ~1.5e9)
        idx = cell.reshape(-1, 1).expand(-1, 2)
        src = stats[act[:, 0], act[:, 1]][:, None, :] \
            .expand(-1, N_COLS, -1).reshape(-1, 2)
        del cell
        flat = torch.zeros((tb * k * N_COLS * N_BINS, 2), device="cuda")
        library_ms = device_ms(torch, lambda: flat.scatter_add_(0, idx, src),
                               launches=2, repeats=3)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_act * N_COLS * 2 / INT_OPS_PER_S * 1e3
        out[k] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": max(bytes_ms, ops_ms),
                  "bound_by": "bytes" if bytes_ms >= ops_ms
                  else "operations", "bytes": nbytes, "active": n_act,
                  "hist_each_tree_ms": b1_ms, "plan": plan,
                  "parts_ms": parts}
        log(f"hist_batch TB={tb} N={TRAIN_ROWS} K={k}: kernel {ms:.5f} ms "
            "(by part " + ", ".join(f"{n} {v:.4f}" for n, v in parts.items())
            + f"), {tb} hist (B1) launches {b1_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, scatter_add_ {library_ms:.4f} ms, bound "
            f"{out[k]['bound_ms']:.6f} ms ({out[k]['bound_by']}: "
            f"{nbytes / 1e6:.3f} MB, {n_act} active (tree, row) pairs; "
            f"plan {plan}) — [{gpu}]")
        del bins, node, stats, act, idx, src, flat
        torch.cuda.empty_cache()
    return out


def time_of(torch, root: str, seed: int) -> None:
    """``--time-of DIR``, with ``shifu_tpu_torch`` imported from checkout
    DIR: B1 and B2 (TB=8) at ``time_hist``'s shapes and K on
    ``hist_inputs`` / ``batch_inputs``' data from ``seed``, each launch
    timed whole and on all-zero stats (device ms), then ``chunk_phase``
    on a training plane from ``seed`` (the column plan of
    ``write_model_set``, the rows of ``train_plane``).  Only the two
    wrappers and ``gbt_forest_chunk`` are called, so any version of the
    port can be timed; what a launch on zero stats skips is the version's
    own (the one-source kernel drops every such row in its partition).
    Prints the card, a log line a case and one JSON line."""
    from shifu_tpu_torch.ops import hist
    gpu = gpu_identity()
    print(gpu, flush=True)
    rng = np.random.default_rng(seed)
    out = {"root": os.path.abspath(root), "gpu": gpu, "cases": {}}
    for tb, k in [(0, k) for k in HIST_TIMED_NODES] \
            + [(HIST_BATCH, k) for k in HIST_BATCH_NODES]:
        if tb:
            name, fn = f"B2 TB={tb} K={k}", hist.build_histograms_batch_cuda
            bins, node, stats = batch_inputs(torch, rng, TRAIN_ROWS, N_COLS,
                                             N_BINS, k, tb)
        else:
            name, fn = f"B1 K={k}", hist.build_histograms_cuda
            bins, node, stats = hist_inputs(torch, rng, TRAIN_ROWS, N_COLS,
                                            N_BINS, k)
        row = {tag: device_ms(torch, lambda st=st: fn(bins, node, st, k,
                                                      N_BINS),
                              launches=5, repeats=3)
               for tag, st in (("ms", stats),
                               ("zero_stats_ms", torch.zeros_like(stats)))}
        out["cases"][name] = row
        log(f"{name}: {row['ms']:.4f} ms, on zero stats "
            f"{row['zero_stats_ms']:.4f} ms ({out['root']}) — [{gpu}]")
        del bins, node, stats
        torch.cuda.empty_cache()
    from shifu_tpu_torch.ops import stats_hist as sh
    for s in (4, 2):
        idx, st, exact = stats_inputs(torch, rng, RESIDENT_ROWS, N_NUM,
                                      STATS_BUCKETS, s)
        name = f"B3 S={s}"
        row = {"ms": device_ms(torch, lambda: sh.stats_histograms_cuda(
            idx, st, STATS_BUCKETS, exact))}
        if hasattr(sh, "launch_until"):          # versions with parts
            row["parts_ms"] = stats_parts(torch, sh, idx, st, exact)
        out["cases"][name] = row
        log(f"{name}: {row['ms']:.4f} ms"
            + (" (by part " + ", ".join(f"{n} {v:.4f}" for n, v in
                                         row["parts_ms"].items()) + ")"
               if "parts_ms" in row else "")
            + f" ({out['root']}) — [{gpu}]")
        del idx, st
    from shifu_tpu_torch.ops import tree_quant as tq
    forest, packed = traverse_forest(torch, tq, rng)
    for n in TRAVERSE_ROWS:
        bins = torch.from_numpy(rng.integers(
            0, N_BINS, size=(n, N_COLS)).astype(np.uint8)).to("cuda")
        name = f"B4 N={n}"
        out["cases"][name] = {"ms": device_ms(
            torch, lambda: tq.predict_forest_quant(*forest, bins, DEPTH,
                                                   **packed))}
        log(f"{name}: {out['cases'][name]['ms']:.5f} ms ({out['root']}) — "
            f"[{gpu}]")
        del bins
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        plan = write_model_set(d, np.random.default_rng([seed, 1]))["plan"]
    bins, y, w, _, is_cat = train_plane(np.random.default_rng([seed, 2]),
                                        plan, TRAIN_ROWS)
    chunk = chunk_phase(torch, bins, y, w, is_cat, "cuda")
    out["gbt_ms_per_tree"] = chunk["ms_per_tree"]
    out["gbt_quartiles_ms"] = chunk["quartiles_ms"]
    log(f"GBT: {chunk['ms_per_tree']:.3f} ms a tree ({out['root']}) — "
        f"[{gpu}]")
    print(json.dumps(out), flush=True)


def stats_parts(torch, sh, idx, st, exact) -> dict:
    """A B3 launch's device ms by part: ``stats_hist.launch_until``
    stopped after the wrapper's ``amax``, after the kernel's staging of
    the ids, after zeroing and accumulating the cells, then the production
    launch whole (the flush to f32); each part is the difference of two
    neighbours."""
    steps = [(name, lambda stop=stop: sh.launch_until(
        idx, st, STATS_BUCKETS, exact, stop)) for name, stop in
        (("amax", sh.AMAX), ("stage", sh.STAGE), ("accumulate", sh.ACCUM))]
    steps.append(("flush", lambda: sh.stats_histograms_cuda(
        idx, st, STATS_BUCKETS, exact)))
    out, prev = {}, 0.0
    for name, launch in steps:
        cum = device_ms(torch, launch, launches=10, repeats=5)
        out[name] = cum - prev
        prev = cum
    return out


def time_stats_hist(torch, rng, gpu: str) -> dict:
    """B3 at the stats path's chunk, N=262,144 x 224 columns, 4096
    buckets, for S=4 and S=2 on ``stats_inputs``' data: the kernel (its
    wrapper's id transpose included), the plain version, and one
    ``index_add_`` over the flattened (column, bucket) cell of every
    valid cell (its index computed beforehand); the bound counts the ids,
    stats and output once (``stats_hist_bytes``) and one add per valid
    cell and channel."""
    from shifu_tpu_torch.ops import stats_hist as sh
    out = {}
    n, c, b = RESIDENT_ROWS, N_NUM, STATS_BUCKETS
    for s in (4, 2):
        idx, st, exact = stats_inputs(torch, rng, n, c, b, s)
        ms = device_ms(torch, lambda: sh.stats_histograms(idx, st, b, exact))
        parts = stats_parts(torch, sh, idx, st, exact)
        plan = sh.stats_hist_plan(n, c, b, s, sum(exact))
        plain_ms = device_ms(torch, lambda: sh.stats_histograms_ref(
            idx, st, b), launches=2, repeats=3)
        ok = idx >= 0
        flat = (idx.long() + torch.arange(c, device="cuda") * b)[ok]
        src = st[:, None, :].expand(n, c, s)[ok]
        acc = torch.zeros((c * b, s), device="cuda")
        library_ms = device_ms(torch, lambda: acc.index_add_(0, flat, src),
                               launches=3, repeats=5)
        nbytes = sh.stats_hist_bytes(idx, st, b)
        valid = int(flat.numel())
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = valid * s / INT_OPS_PER_S * 1e3
        out[s] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": max(bytes_ms, ops_ms),
                  "bound_by": "bytes" if bytes_ms >= ops_ms
                  else "operations", "bytes": nbytes, "valid_cells": valid,
                  "parts_ms": parts, "plan": plan}
        log(f"stats_hist N={n} C={c} B={b} S={s}: kernel {ms:.5f} ms (by "
            "part " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
            + f"), plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms, "
            f"bound {out[s]['bound_ms']:.6f} ms ({out[s]['bound_by']}: "
            f"{nbytes / 1e6:.3f} MB, {valid} valid cells; plan {plan}) — "
            f"[{gpu}]")
        del idx, st, ok, flat, src, acc
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
    ap.add_argument("--time-of", metavar="DIR",
                    help="only time B1, B2 and a GBT chunk of the checkout "
                    "in DIR")
    args = ap.parse_args()
    if args.time_of:
        sys.path.insert(0, os.path.abspath(args.time_of))
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available — this smoke runs on an NVIDIA GPU")
    if args.time_of:
        time_of(torch, args.time_of, args.seed)
        return
    try:
        from shifu_tpu_torch.ops import cuda_lib
        from shifu_tpu_torch.ops import tree_quant as tq
    except ImportError as e:
        fail(f"run from the repository root ({e})")
    gpu = gpu_identity()
    print(gpu, flush=True)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}) on {kind}")
    rng = np.random.default_rng(args.seed)         # checks and timings
    path_rng = np.random.default_rng([args.seed, 1])   # the main path's data
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    built = cuda_lib.build(["tree_traverse", "hist", "stats_hist"])
    for name, (path, build_log) in built.items():
        log(f"built {name} -> {os.path.relpath(path)}")
        for line in build_log.splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")

    errs = check_kernels(torch, tq, rng)
    errs.update(check_hist(torch, rng))
    errs.update(check_stats_hist(torch, rng))
    errs.update(check_hist_batch(torch, rng))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        serve_root = os.path.join(root, "serve")
        os.makedirs(serve_root)
        plan = write_model_set(serve_root, path_rng)["plan"]
        served = serve_phase(torch, tq, serve_root, plan, path_rng)
        time_transform(torch, serve_root, plan, rng, gpu)
        trained = train_phase(torch, root, serve_root, plan, path_rng)
        forest = rf_phase(torch, root, serve_root, trained.pop("plane"))
        stats = stats_phase(torch, root, plan, path_rng)
    resident = resident_phase(torch, args.seed)
    times = time_kernels(torch, tq, rng, gpu)
    hist_times = time_hist(torch, rng, gpu)
    stats_times = time_stats_hist(torch, rng, gpu)
    batch_times = time_hist_batch(torch, rng, gpu)
    ms_tree = trained["chunk"]["ms_per_tree"]
    ph = trained["phases_s"]
    log(f"full-width train: {ms_tree:.3f} ms per tree device-resident, "
        f"{ph['train'] * 1e3 / TRAIN_TREES:.3f} ms per tree through the "
        f"CLI's train phase of {ph['train']:.3f} s: upload "
        f"{ph['train/upload']:.3f} s, grow {ph['train/grow']:.3f} s "
        f"({ph['train/grow'] * 1e3 / TRAIN_TREES:.3f} ms a tree), "
        f"checkpoints {ph['train/checkpoint']:.3f} s, other "
        f"{ph['train/other']:.3f} s — [{gpu}]")

    top = times[512]
    h32 = hist_times[32]
    kernels = [{
        "name": "tree_traverse", "route": "cuda",
        "source": "shifu_tpu_torch/csrc/tree_traverse.cu",
        "replaces": "shifu_tpu/ops/tree_quant.py:159",
        "launches": served["launches"]["tree_traverse"],
        "train_replay_launches":
            trained["replay"]["launches"]["tree_traverse"],
        "max_abs_err": errs["tree_traverse"],
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": None,
        **{f"at_{n}_rows": {k: times[n][k] for k in
                            ("ms", "plain_ms", "bound_ms", "bound_by")}
           for n in TRAVERSE_ROWS[1:]},
        "gpu": gpu}, {
        "name": "hist", "route": "cuda",
        "source": "shifu_tpu_torch/csrc/hist.cu",
        "leaf_sum_launches": trained["launches"]["leaf_sums"],
        "rf_launches": forest["launches"]["hist"],
        "rf_leaf_sum_launches": forest["launches"]["leaf_sums"],
        "replaces": "shifu_tpu/ops/hist_pallas.py:75",
        "launches": trained["launches"]["hist"],
        "max_abs_err": max([errs["hist"]] + [hist_times[k]["max_abs_err"]
                                             for k in HIST_TIMED_NODES]),
        "ms": h32["ms"], "plain_ms": h32["plain_ms"],
        "bound_ms": h32["bound_ms"], "bound_by": h32["bound_by"],
        "library_ms": h32["library_ms"],
        "shape": f"N={TRAIN_ROWS} C={N_COLS} B={N_BINS} S=2 K=32 uint8",
        "parts_ms": h32["parts_ms"],
        **{f"at_{k}_node{'s' if k > 1 else ''}": {
            m: hist_times[k].get(m) for m in
            ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "parts_ms")}
           for k in (1, 4096)},
        "gpu": gpu}, {
        "name": "stats_hist", "route": "cuda",
        "source": "shifu_tpu_torch/csrc/stats_hist.cu",
        "replaces": "shifu_tpu/ops/hist_pallas.py:534",
        "launches": stats["launches"]["stats_hist"],
        "resident_launches": resident["launches"],
        "max_abs_err": errs["stats_hist"],
        "ms": stats_times[4]["ms"], "plain_ms": stats_times[4]["plain_ms"],
        "bound_ms": stats_times[4]["bound_ms"],
        "bound_by": stats_times[4]["bound_by"],
        "library_ms": stats_times[4]["library_ms"],
        "shape": f"N={RESIDENT_ROWS} C={N_NUM} B={STATS_BUCKETS} S=4",
        "parts_ms": stats_times[4]["parts_ms"],
        "at_2_channels": {k: stats_times[2][k] for k in
                          ("ms", "plain_ms", "library_ms", "bound_ms",
                           "bound_by", "parts_ms")},
        "gpu": gpu}, {
        "name": "hist_batch", "route": "cuda",
        "source": "shifu_tpu_torch/csrc/hist.cu",
        "replaces": "shifu_tpu/ops/hist_pallas.py:161",
        "launches": forest["launches"]["hist_batch"],
        "max_abs_err": errs["hist_batch"],
        "ms": batch_times[32]["ms"], "plain_ms": batch_times[32]["plain_ms"],
        "bound_ms": batch_times[32]["bound_ms"],
        "bound_by": batch_times[32]["bound_by"],
        "library_ms": batch_times[32]["library_ms"],
        "shape": f"TB={HIST_BATCH} N={TRAIN_ROWS} C={N_COLS} B={N_BINS} S=2 "
                 "K=32 uint8",
        "hist_each_tree_ms": batch_times[32]["hist_each_tree_ms"],
        "parts_ms": batch_times[32]["parts_ms"],
        **{f"at_{k}_node{'s' if k > 1 else ''}": {
            m: batch_times[k].get(m) for m in
            ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "hist_each_tree_ms", "parts_ms")}
           for k in (1, 4096)},
        "rf_levels_ms": forest["chunk"]["batch"]["levels_ms"].get(
            "build_histograms_batch"),
        "rf_leaf_ms_per_tree_max": forest["chunk"]["batch"][
            "leaf_ms_per_tree_max"],
        "gpu": gpu}]
    rf_chunk = forest["chunk"]
    log(f"full-width RF ({RF_TREES} trees, depth {RF_DEPTH}): "
        f"{rf_chunk['batch']['ms_per_tree']:.1f} ms per tree in the "
        f"{RF_CKPT}-tree batch (hist_batch), "
        f"{rf_chunk['remainder']['ms_per_tree']:.1f} ms per tree one by one "
        f"(hist), bags {rf_chunk['bag_ms']:.1f} ms; CLI train phase "
        f"{forest['phases_s']['train']:.3f} s ({forest['phases_s']}); peak "
        f"device memory {forest['peak_bytes'] / 2**30:.3f} GiB — [{gpu}]")
    log(f"stats: {CSV_ROWS} rows x {N_COLS + 2} fields through new/init/"
        f"stats in {stats['init_s'] + stats['wall_s']:.2f} s (stats "
        f"{stats['wall_s']:.3f} s, host parse {stats['parse_us_per_cell']:.3f}"
        f" us a cell); resident accumulator {resident['update_ms_median']:.3f}"
        f" ms a 262,144-row chunk, finalize {resident['finalize_ms']:.3f} ms, "
        f"peak {resident['peak_bytes'] / 2**30:.3f} GiB — [{gpu}]")
    log(f"served {served['batches']} batches; max |card - cpu| "
        f"{served['max_abs_score_diff']:.3g}; trained {TRAIN_TREES} GBT and "
        f"{RF_TREES} RF trees; "
        f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
