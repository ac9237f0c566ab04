#!/usr/bin/env python3
"""Host walls of ``new → init → stats`` in both packages, on one CSV.

    python3 tools/port_host_walls.py [--seed N] [--out FILE] [--of DIR]

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the JSON line here")
    ap.add_argument("--of", default=REPO, metavar="DIR",
                    help="the checkout whose packages run (default: this one)")
    args = ap.parse_args()
    repo = os.path.abspath(args.of)
    walls = {}
    with tempfile.TemporaryDirectory(prefix="host_walls_") as root:
        plan = chip_smoke.write_model_set(
            root, np.random.default_rng([args.seed, 1]))["plan"]
        csv = os.path.join(root, "data.csv")
        chip_smoke.write_stats_csv(csv, np.random.default_rng([args.seed, 2]),
                                   plan, chip_smoke.CSV_ROWS)
        for package, stats_args in PACKAGES.items():
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
    for step in ("init", "stats"):
        ref, port = walls.pop(f"shifu_tpu {step}"), \
            walls.pop(f"shifu_tpu_torch {step}")
        if len(ref) != len(port):
            sys.exit(f"{step}: {len(port)} columns, reference {len(ref)}")
        for a, b in zip(port, ref):
            same(a, b, f"{step} {b['columnName']}")
    walls.update(repo=repo, rows=chip_smoke.CSV_ROWS,
                 fields=chip_smoke.N_COLS + 2, cpus=os.cpu_count(),
                 column_configs_agree=True)
    line = json.dumps(walls)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
