#!/usr/bin/env python3
"""Host walls of ``new → init → stats`` in both packages, on one CSV.

    python3 tools/port_host_walls.py [--seed N] [--out FILE] [--of DIR]
    python3 tools/port_host_walls.py --parse [--seed N] [--out FILE]
    python3 tools/port_host_walls.py --norm-eval [--seed N] [--out F] [--of DIR]

Writes the chip smoke's stats CSV (``chip_smoke.py::write_model_set`` for
the column plan, ``write_stats_csv`` for 16,384 rows x 258 fields, both
from ``--seed``), then runs ``new``, ``init`` and ``stats`` through
``shifu_tpu.cli`` (JAX on the CPU) and through ``shifu_tpu_torch.cli``
(``stats --device cpu``), each step in a process of its own with the wall
taken around ``cli.main`` alone (imports excluded); ``--of DIR`` imports
both packages from checkout DIR instead (for example a ``git archive`` of
a parent commit), so two versions can be timed in one session.  It then
checks that
the two ColumnConfig.json files agree: every integer, string, category
list and ``binBoundary`` equal, floats within 1e-5 relative + 1e-4
(``chip_smoke.py``'s card-vs-CPU rule: skewness and kurtosis near 0 turn
f32 moment differences of 1e-7 into large relative ones).  Prints
one JSON line with the four walls.  Runs on the CPU: these are host walls,
not device numbers.

With ``--parse`` it times only the port's parse pool on the same CSV
after the port's ``init`` and ``stats --device cpu``: ``iter_extracted``
over the model inputs in chunks of 4,096 rows, inline
(``shifu.ingest.parseWorkers=0``) and with 1 and 8 parse threads (the
default is ``min(cores, 8)``), in turns 0, 1, 8, 8, 1, 0, each in the same
process, and checks that every turn yields the same rows.  It times this
checkout's parse pool only, so it does not take ``--of``.

With ``--norm-eval`` it times ``norm`` and ``eval -run`` of both packages
with the raw cache and without it (``-Dshifu.ingest.rawCache=false``):
each package runs ``new``, ``init``, ``stats`` (which writes the cache),
``norm``, ``train`` (GBT, 10 trees of depth 7) and ``eval -new``, then
both steps in turns (reference cache on, port on, port off, reference
off, then the same four in reverse order), each step in a process of
its own; it checks that the two packages' eval AUCs agree within 0.005.
Its JSON line holds the walls of every turn.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the CSV writers and tolerances)

PACKAGES = {"shifu_tpu": (), "shifu_tpu_torch": ("--device", "cpu")}


def run_step(package: str, argv: list, repo: str = REPO) -> float:
    """``<package>.cli.main(argv)`` in a fresh process, with the packages
    of checkout ``repo``; its wall in s."""
    code = ("import sys, time\n"
            f"from {package}.cli import main\n"
            "t0 = time.perf_counter()\n"
            f"rc = main({argv!r})\n"
            "print('WALL', time.perf_counter() - t0)\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                         capture_output=True, text=True)
    if out.returncode != 0:
        sys.exit(f"{package} {argv} exited {out.returncode}:\n"
                 f"{out.stdout[-2000:]}{out.stderr[-4000:]}")
    return float(out.stdout.split("WALL")[-1].split()[0])


def same(got, want, where: str) -> None:
    """ColumnConfig values equal, floats within the stated tolerance."""
    if isinstance(want, dict):
        if set(got) != set(want):
            sys.exit(f"ColumnConfig keys differ at {where}")
        for k in want:
            same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list) and not where.endswith(".binBoundary"):
        if not isinstance(got, list) or len(got) != len(want):
            sys.exit(f"ColumnConfig lists differ at {where}")
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and isinstance(got, float):
        if not (got == want or abs(got - want) <= chip_smoke.CARD_CPU_RTOL
                * abs(want) + chip_smoke.CARD_CPU_ATOL):
            sys.exit(f"ColumnConfig {where}: {got} vs {want}")
    elif got != want:
        sys.exit(f"ColumnConfig {where}: {got!r} vs {want!r}")


def parse_turns(root: str, csv: str) -> dict:
    """The port's parse pool inline and with 1 and 8 threads, in turns
    (see the module docstring); seconds per turn."""
    import time

    from shifu_tpu_torch.config import (ModelConfig, environment,
                                        load_column_configs)
    from shifu_tpu_torch.data.parsepool import iter_extracted
    from shifu_tpu_torch.data.reader import DataSource
    from shifu_tpu_torch.data.transform import DatasetTransformer
    base = os.path.join(root, "parse")
    os.makedirs(base)
    run_step("shifu_tpu_torch", ["--dir", base, "new", "set"])
    d = os.path.join(base, "set")
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    ds = mc.dataSet
    ds.dataPath, ds.dataDelimiter, ds.targetColumnName = csv, "|", "tag"
    ds.posTags, ds.negTags, ds.weightColumnName = ["bad"], ["good"], "weight"
    ds.headerPath, ds.headerDelimiter = csv + ".header", "|"
    mc.save(path)
    for argv in (["init"], ["stats", "--device", "cpu"]):
        run_step("shifu_tpu_torch", ["--dir", d, *argv])
    mc = ModelConfig.load(path)
    tf = DatasetTransformer(mc, load_column_configs(
        os.path.join(d, "ColumnConfig.json")))
    out, rows = {}, set()
    for w in (0, 1, 8, 8, 1, 0):
        environment.set_property("shifu.ingest.parseWorkers", str(w))
        src = DataSource(csv, "|", header_path=csv + ".header")
        t0 = time.perf_counter()
        n = sum(ex.n for _, ex in iter_extracted(src, tf.extractor,
                                                 chunk_rows=4096))
        out.setdefault(f"parse_s workers={w}", []).append(
            time.perf_counter() - t0)
        rows.add(n)
    if rows != {chip_smoke.CSV_ROWS}:
        sys.exit(f"parse turns yielded {sorted(rows)} rows")
    return out


GBT = {"TreeNum": 10, "MaxDepth": 7, "Loss": "log", "LearningRate": 0.1}
EVAL_SET = "walls"


def norm_eval_turns(root: str, csv: str, repo: str) -> dict:
    """``norm`` and ``eval -run`` of both packages, cache on and off, in
    turns (see the module docstring); seconds per turn, and each
    package's eval AUC."""
    dirs, out = {}, {}
    for package, dev in PACKAGES.items():
        base = os.path.join(root, "ne_" + package)
        os.makedirs(base)
        run_step(package, ["--dir", base, "new", "set"], repo)
        d = dirs[package] = os.path.join(base, "set")
        path = os.path.join(d, "ModelConfig.json")
        with open(path) as f:
            mc = json.load(f)
        ds = dict(dataPath=csv, dataDelimiter="|", targetColumnName="tag",
                  posTags=["bad"], negTags=["good"],
                  weightColumnName="weight", headerPath=csv + ".header",
                  headerDelimiter="|")
        mc["dataSet"].update(ds)
        mc["evals"][0]["dataSet"].update(ds)
        mc["train"].update(algorithm="GBT", params=dict(GBT))
        with open(path, "w") as f:
            json.dump(mc, f, indent=2)
        for argv in (["init"], ["stats", *dev], ["norm"], ["train", *dev],
                     ["eval", "-new", EVAL_SET]):
            run_step(package, ["--dir", d, *argv], repo)
    order = [("shifu_tpu", "on"), ("shifu_tpu_torch", "on"),
             ("shifu_tpu_torch", "off"), ("shifu_tpu", "off")]
    for package, mode in order + order[::-1]:
        props = [] if mode == "on" else ["-Dshifu.ingest.rawCache=false"]
        d = dirs[package]
        for step, argv in (("norm", ["norm"]),
                           ("eval", ["eval", "-run", EVAL_SET,
                                     *PACKAGES[package]])):
            out.setdefault(f"{package} {step}_s cache={mode}", []).append(
                run_step(package, [*props, "--dir", d, *argv], repo))
    aucs = {}
    for package, d in dirs.items():
        with open(os.path.join(d, "evals", EVAL_SET,
                               "EvalPerformance.json")) as f:
            aucs[package] = json.load(f)["areaUnderRoc"]
        out[f"{package} auc"] = aucs[package]
    if abs(aucs["shifu_tpu"] - aucs["shifu_tpu_torch"]) > 0.005:
        sys.exit(f"eval AUCs differ: {aucs}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the JSON line here")
    ap.add_argument("--of", default=REPO, metavar="DIR",
                    help="the checkout whose packages run (default: this one)")
    ap.add_argument("--parse", action="store_true",
                    help="only time the port's parse pool, inline against "
                    "1 and 8 threads")
    ap.add_argument("--norm-eval", action="store_true",
                    help="only time norm and eval -run of both packages, "
                    "with the raw cache and without it")
    args = ap.parse_args()
    if args.parse and os.path.abspath(args.of) != REPO:
        ap.error("--parse times this checkout's parse pool; it takes no "
                 "--of")
    repo = os.path.abspath(args.of)
    walls = {}
    with tempfile.TemporaryDirectory(prefix="host_walls_") as root:
        plan = chip_smoke.write_model_set(
            root, np.random.default_rng([args.seed, 1]))["plan"]
        csv = os.path.join(root, "data.csv")
        chip_smoke.write_stats_csv(csv, np.random.default_rng([args.seed, 2]),
                                   plan, chip_smoke.CSV_ROWS)
        only = args.parse or args.norm_eval
        if args.parse:
            walls = parse_turns(root, csv)
        elif args.norm_eval:
            walls = norm_eval_turns(root, csv, repo)
        for package, stats_args in () if only else PACKAGES.items():
            base = os.path.join(root, package)
            os.makedirs(base)
            run_step(package, ["--dir", base, "new", "set"], repo)
            d = os.path.join(base, "set")
            path = os.path.join(d, "ModelConfig.json")
            with open(path) as f:
                mc = json.load(f)
            mc["dataSet"].update(
                dataPath=csv, dataDelimiter="|", targetColumnName="tag",
                posTags=["bad"], negTags=["good"], weightColumnName="weight",
                headerPath=csv + ".header", headerDelimiter="|")
            with open(path, "w") as f:
                json.dump(mc, f, indent=2)
            walls[f"{package} init_s"] = run_step(
                package, ["--dir", d, "init"], repo)
            with open(os.path.join(d, "ColumnConfig.json")) as f:
                walls[f"{package} init"] = json.load(f)
            walls[f"{package} stats_s"] = run_step(
                package, ["--dir", d, "stats", *stats_args], repo)
            with open(os.path.join(d, "ColumnConfig.json")) as f:
                walls[f"{package} stats"] = json.load(f)
    for step in () if only else ("init", "stats"):
        ref, port = walls.pop(f"shifu_tpu {step}"), \
            walls.pop(f"shifu_tpu_torch {step}")
        if len(ref) != len(port):
            sys.exit(f"{step}: {len(port)} columns, reference {len(ref)}")
        for a, b in zip(port, ref):
            same(a, b, f"{step} {b['columnName']}")
    walls.update(repo=repo, rows=chip_smoke.CSV_ROWS,
                 fields=chip_smoke.N_COLS + 2, cpus=os.cpu_count())
    if not only:
        walls["column_configs_agree"] = True
    line = json.dumps(walls)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
