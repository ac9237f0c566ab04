"""A self-contained elastic controller — one process of an N-controller
quorum-gated NN job over a shared directory (the port of
``shifu_tpu.parallel.elastic_demo``)::

    python -m shifu_tpu_torch.parallel.elastic_demo --out DIR --proc I \\
        --nproc N [--rows R --features D --epochs E --window W \\
        --quorum-frac F --timeout-ms T --staleness S] [--device cpu|cuda]

Each controller regenerates the SAME global data set from a fixed seed,
takes its contiguous row block (its "shard files"), trains the streamed
NN with the elastic step protocol (``parallel/elastic.py``) as a world of
one on its own device (the card unless ``--device cpu``), and commits
``result-<proc>.json`` and ``params-<proc>.npz`` under ``--out``, so a
caller compares controllers bit for bit and reads the AUC.  The combine
rides ``<out>/telemetry/steps/`` only: no ``torch.distributed``.

A fault spec in ``SHIFU_TPU_FAULTS`` (``dcn:step=3:kill``) makes a
controller the worker-loss drill; launching it again with the same
``--proc`` rejoins from the close journal.  A controller starts training
once all ``--nproc`` controllers have joined the board (or after
``JOIN_TIMEOUT_S``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


#: seconds a controller waits for the others to join before it trains
JOIN_TIMEOUT_S = 120.0


def auc(scores, y) -> float:
    """Rank ROC AUC, ties at their average rank."""
    scores = np.asarray(scores, np.float64)
    y = np.asarray(y) > 0.5
    order = np.argsort(scores, kind="mergesort")
    s_sorted = scores[order]
    ranks = np.empty(len(scores), np.float64)
    ranks[order] = np.arange(1, len(scores) + 1, dtype=np.float64)
    # average the ranks of each run of ties
    starts = np.flatnonzero(np.r_[True, s_sorted[1:] != s_sorted[:-1]])
    ends = np.r_[starts[1:], len(s_sorted)]
    for a, b in zip(starts, ends):
        if b - a > 1:
            ranks[order[a:b]] = ranks[order[a:b]].mean()
    npos = int(y.sum())
    nneg = len(y) - npos
    if npos == 0 or nneg == 0:
        return 0.5
    return float((ranks[y].sum() - npos * (npos + 1) / 2) / (npos * nneg))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True,
                    help="the shared job directory (board and results)")
    ap.add_argument("--proc", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--rows", type=int, default=4096,
                    help="GLOBAL rows (each controller owns 1/nproc)")
    ap.add_argument("--features", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--window", type=int, default=0,
                    help="stream window rows (0 = local rows / 2)")
    ap.add_argument("--quorum-frac", type=float, default=None)
    ap.add_argument("--timeout-ms", type=float, default=None)
    ap.add_argument("--staleness", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)

    import torch

    from .. import ioutil
    from ..config import environment
    from ..data.shards import Shards
    from ..data.streaming import ShardStream, mask_fn_from_settings
    from ..models.nn import NNModelSpec, forward
    from .elastic import ElasticContext
    from .mesh import device_mesh
    from ..train.nn_trainer import TrainSettings, train_ensemble_streamed

    environment.set_property("shifu.dcn.elastic", "true")
    if args.quorum_frac is not None:
        environment.set_property("shifu.dcn.quorumFrac", args.quorum_frac)
    if args.timeout_ms is not None:
        environment.set_property("shifu.dcn.stepTimeoutMs", args.timeout_ms)
    if args.staleness is not None:
        environment.set_property("shifu.dcn.staleness", args.staleness)

    t_start = time.time()
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)

    # the SAME global data on every controller, each owning a contiguous
    # row block: its "shard files"
    rng = np.random.default_rng(11)
    D = args.features
    x_all = rng.normal(size=(args.rows, D)).astype(np.float32)
    wvec = (rng.normal(size=D) / np.sqrt(D)).astype(np.float32)
    y_all = (1.0 / (1.0 + np.exp(-(x_all @ wvec) * 3))
             > rng.random(args.rows)).astype(np.float32)
    per = args.rows // args.nproc
    lo, hi = args.proc * per, (args.proc + 1) * per
    ddir = os.path.join(out, f"data-{args.proc}")
    os.makedirs(ddir, exist_ok=True)
    ioutil.atomic_savez(os.path.join(ddir, "part-00000.npz"),
                        x=x_all[lo:hi], y=y_all[lo:hi],
                        w=np.ones(hi - lo, np.float32))
    ioutil.atomic_write_json(os.path.join(ddir, "schema.json"), {
        "outputNames": [f"c{i}" for i in range(D)],
        "columnNums": list(range(D)), "numShards": 1, "numRows": hi - lo})

    mesh = device_mesh(n_ensemble=1)          # a controller: a world of one
    window = args.window or max(1, (hi - lo) // 2)
    stream = ShardStream(Shards.open(ddir), ("x", "y", "w"), window)
    spec = NNModelSpec(input_dim=D, hidden_nodes=[8],
                       activations=["tanh"], loss="log")
    settings = TrainSettings(optimizer="ADAM", learning_rate=0.05,
                             epochs=args.epochs, batch_size=0, seed=7)
    mask_fn = mask_fn_from_settings(1, valid_rate=0.25, seed=7)

    ctx = ElasticContext(out, proc=f"ctrl-{args.proc}").start()
    # the job starts once every controller joined (its member record): a
    # controller that raced ahead alone would close its steps by itself
    deadline = time.time() + JOIN_TIMEOUT_S
    while len(ctx.board.members()) < args.nproc and time.time() < deadline:
        time.sleep(0.02)
    t_train = time.time()
    try:
        res = train_ensemble_streamed(stream, spec, settings, 1, mask_fn,
                                      device=args.device, mesh=mesh,
                                      elastic=ctx)
    except BaseException:
        ctx.stop(exit_code=1)
        raise
    train_s = time.time() - t_train
    dcn_stats = {"rejoined": ctx.rejoined, "incarnation": ctx.incarnation,
                 "catchup_steps": ctx.catchup_steps,
                 "steps_closed": ctx.steps_closed,
                 "step_timeouts": ctx.step_timeouts,
                 "late_applied": ctx.late_applied,
                 "late_dropped": ctx.late_dropped,
                 "step_wait_s": round(ctx.wait_s, 6)}
    ctx.stop(exit_code=0)

    # results: bit-comparable params and an AUC on the GLOBAL plane
    params = res.params[0]
    flat = {f"l{i}_{k}": layer[k].numpy()
            for i, layer in enumerate(params) for k in ("w", "b")}
    ioutil.atomic_savez(os.path.join(out, f"params-{args.proc}.npz"),
                        **flat)
    with torch.no_grad():
        scores = forward(params, spec, torch.from_numpy(x_all)).numpy()[:, 0]
    a = auc(scores, y_all)
    checksum = float(sum(np.abs(v).sum() for v in flat.values()))
    ioutil.atomic_write_json(os.path.join(out, f"result-{args.proc}.json"), {
        "proc": args.proc, "checksum": checksum, "auc": round(a, 6),
        "epochs_run": res.epochs_run,
        "history": [[round(u, 6), round(v, 6)] for u, v in res.history],
        "dcn": dcn_stats, "wall_s": round(time.time() - t_start, 3),
        "train_s": round(train_s, 3), "rows_local": hi - lo,
        "window": window, "device": args.device})
    print(f"ELASTIC-OK proc={args.proc} checksum={checksum:.8f} "
          f"auc={a:.4f} catchup={dcn_stats['catchup_steps']} "
          f"rejoined={int(dcn_stats['rejoined'])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
