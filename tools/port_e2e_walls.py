#!/usr/bin/env python3
"""Walls of the port's ``norm → train → eval -run`` on the card, checkout
by checkout, in turns.

    python3 tools/port_e2e_walls.py --of DIR [--of DIR ...] [--seed N]
                                    [--out FILE]

Writes the chip smoke's stats CSV (``chip_smoke.py::write_model_set`` for
the column plan, ``write_stats_csv`` for 16,384 rows x 258 fields, both
from ``--seed``) and prepares one model set from it with this checkout's
port: ``new``, ``init`` and ``stats --device cuda``.  Then, for each
``--of`` checkout in the order given (name one twice to run in turns, for
example parent, change, change, parent), it copies that set and runs, in
a process of its own with that checkout's packages, the steps of
``chip_smoke.py::e2e_phase``: ``norm``, ``train --device cuda`` (the
smoke's GBT: 10 trees, depth 7, Loss log), ``eval -new`` and ``eval -run
--device cuda``, through ``shifu_tpu_torch.cli.main`` with chunks of
4,096 rows.  Each wall is taken around ``cli.main`` alone: the imports,
the CUDA context and the kernels' build come before the first.  Prints
one JSON line with every turn's walls, its ``tmp/profile.json`` phases
and whether its ``EvalScore`` file equals the first turn's.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the CSV writers and the e2e settings)

TURN = r"""
import json, sys, time
import torch
from shifu_tpu_torch import cli
from shifu_tpu_torch.data import parsepool
from shifu_tpu_torch.ops import cuda_lib
cuda_lib.build(["tree_traverse", "hist", "stats_hist"])
torch.zeros(1, device="cuda")
parsepool.CHUNK_ROWS = int(sys.argv[1])
walls = {}
for name, argv in json.loads(sys.argv[2]):
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        sys.exit(f"{argv} exited non-zero")
    walls[name] = time.perf_counter() - t0
print("WALLS", json.dumps(walls))
"""


def run_turn(repo: str, steps: list) -> dict:
    """``steps`` ([name, argv] pairs) through ``shifu_tpu_torch.cli.main``
    in a fresh process with the packages of checkout ``repo``; the wall of
    each step in s."""
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run(
        [sys.executable, "-c", TURN, str(chip_smoke.CSV_CHUNK),
         json.dumps(steps)], env=env, cwd=repo, capture_output=True,
        text=True)
    if out.returncode != 0:
        sys.exit(f"{repo}: {steps} exited {out.returncode}:\n"
                 f"{out.stdout[-2000:]}{out.stderr[-4000:]}")
    return json.loads(out.stdout.split("WALLS")[-1])


def prepare(root: str, seed: int) -> str:
    """The stats CSV and a model set through ``stats`` on it, with the
    e2e phase's train and eval settings; its directory."""
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    plan = chip_smoke.write_model_set(
        root, np.random.default_rng([seed, 1]))["plan"]
    csv = os.path.join(root, "data.csv")
    chip_smoke.write_stats_csv(csv, np.random.default_rng([seed, 2]), plan,
                               chip_smoke.CSV_ROWS)
    base = os.path.join(root, "base")
    run_turn(REPO, [["new", ["--dir", base, "new", "set"]]])
    d = os.path.join(base, "set")
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    ds = mc.dataSet
    ds.dataPath, ds.dataDelimiter, ds.targetColumnName = csv, "|", "tag"
    ds.posTags, ds.negTags, ds.weightColumnName = ["bad"], ["good"], "weight"
    ds.headerPath, ds.headerDelimiter = csv + ".header", "|"
    mc.stats.maxNumBin = chip_smoke.N_BINS - 1
    mc.train.algorithm = Algorithm.GBT
    mc.train.params = {"TreeNum": chip_smoke.TRAIN_TREES,
                       "MaxDepth": chip_smoke.DEPTH, "Loss": "log",
                       "LearningRate": 0.1}
    ev = mc.evals[0].dataSet
    ev.dataPath, ev.dataDelimiter = csv, "|"
    ev.headerPath, ev.headerDelimiter = csv + ".header", "|"
    mc.save(path)
    run_turn(REPO, [["init", ["--dir", d, "init"]],
                    ["stats", ["--dir", d, "stats", "--device", "cuda"]]])
    return d


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--of", action="append", required=True, metavar="DIR",
                    help="a checkout whose port runs a turn (repeatable)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    ev = chip_smoke.E2E_EVAL
    turns, first = [], None
    with tempfile.TemporaryDirectory(prefix="e2e_walls_") as root:
        template = prepare(root, args.seed)
        for i, of in enumerate(args.of):
            d = os.path.join(root, f"turn{i}")
            shutil.copytree(template, d)
            walls = run_turn(os.path.abspath(of), [
                ["norm", ["--dir", d, "norm"]],
                ["train", ["--dir", d, "train", "--device", "cuda"]],
                ["eval_new", ["--dir", d, "eval", "-new", ev]],
                ["eval", ["--dir", d, "eval", "-run", ev, "--device",
                          "cuda"]]])
            with open(os.path.join(d, "tmp", "profile.json")) as f:
                profile = json.load(f)
            with open(os.path.join(d, "evals", ev, "EvalScore"), "rb") as f:
                scores = f.read()
            first = scores if first is None else first
            turns.append({"of": of, "walls_s": walls,
                          "phases_s": {k: profile[k]["phases_s"] for k in
                                       ("NORMALIZE", "EVAL")},
                          "eval_scores_equal_first": scores == first})
            shutil.rmtree(d)
    line = json.dumps({"rows": chip_smoke.CSV_ROWS,
                       "fields": chip_smoke.N_COLS + 2,
                       "gpu": chip_smoke.gpu_identity(), "turns": turns})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
