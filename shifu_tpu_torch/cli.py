"""shifu-tpu-torch CLI — the port's counterpart of ``shifu_tpu.cli``.

The port carries the ``new``, ``init``, ``stats``, ``train`` and
``serve`` commands.  ``-Dkey=value`` properties go to the Environment tier
as in the reference; ``--device`` picks where the port runs (default
``cuda``; ``cpu`` runs the plain PyTorch versions).  ``new`` and ``init``
run on the host.

    python -m shifu_tpu_torch.cli --dir <base> new <name>
    python -m shifu_tpu_torch.cli --dir <modelset> init [-model]
    python -m shifu_tpu_torch.cli --dir <modelset> stats [--device cpu]
    python -m shifu_tpu_torch.cli --dir <modelset> serve [--port N]
    python -m shifu_tpu_torch.cli --dir <modelset> serve --selfcheck 4 --device cpu
    python -m shifu_tpu_torch.cli --dir <modelset> train [-resume] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

from .config import environment


def _split_props(argv: List[str]) -> List[str]:
    """Pull ``-Dk=v`` pairs out of argv into Environment, return the rest."""
    rest = []
    for a in argv:
        if a.startswith("-D") and "=" in a:
            k, _, v = a[2:].partition("=")
            environment.set_property(k, v)
        else:
            rest.append(a)
    return rest


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="shifu-tpu-torch",
        description="PyTorch/CUDA port of shifu-tpu (new, init, stats, "
        "GBT train, serve)")
    p.add_argument("--dir", default=".", help="model-set directory (default: cwd)")
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("new", help="create a new model-set scaffold")
    sp.add_argument("name")

    sp = sub.add_parser("init",
                        help="build the initial ColumnConfig.json from the "
                        "header, typing columns from a sample")
    sp.add_argument("-model", dest="init_model", action="store_true",
                    help="fill the algorithm's default train#params into "
                    "ModelConfig.json (reference `init -model`)")

    sp = sub.add_parser("stats", help="per-column stats + binning (fine "
                        "histograms on the device)")
    _device_arg(sp)

    sp = sub.add_parser("serve", help="online scoring server: the trained "
                        "ensemble pinned on the device behind a padded-"
                        "bucket micro-batcher (knobs: -Dshifu.serve.buckets, "
                        "-Dshifu.serve.maxDelayMs)")
    sp.add_argument("--port", dest="serve_port", type=int, default=8188,
                    help="HTTP port for POST /score + GET /healthz "
                    "(default 8188; 0 binds an ephemeral port)")
    sp.add_argument("--max-delay-ms", dest="serve_max_delay_ms",
                    type=float, default=None, metavar="MS",
                    help="deadline flush bound (overrides "
                    "-Dshifu.serve.maxDelayMs; default 2)")
    sp.add_argument("--selfcheck", dest="serve_selfcheck", type=int,
                    nargs="?", const=8, default=0, metavar="N",
                    help="score N synthetic rows in-process and exit")
    _device_arg(sp)

    tp = sub.add_parser("train", help="train the model set from the "
                        "norm step's clean plane (resident single-member "
                        "GBT is ported)")
    tp.add_argument("-resume", dest="resume", action="store_true",
                    help="continue from the mid-forest checkpoint")
    _device_arg(tp)
    return p


def _device_arg(sp) -> None:
    sp.add_argument("--device", dest="device", choices=("cuda", "cpu"),
                    default="cuda",
                    help="where the port runs (default cuda; raises when "
                    "CUDA is absent)")


def main(argv: Optional[List[str]] = None) -> int:
    argv = _split_props(list(argv if argv is not None else sys.argv[1:]))
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose
                        else logging.WARNING)
    if args.command == "new":
        from .pipeline.create import create_new_model
        create_new_model(args.name, base_dir=args.dir)
        return 0
    if args.command == "init":
        from .pipeline.create import InitProcessor, check_algorithm_param
        if args.init_model:
            return check_algorithm_param(args.dir)
        return InitProcessor(args.dir).run()
    if args.command == "stats":
        from .pipeline.stats import StatsProcessor
        return StatsProcessor(args.dir, device=args.device).run()
    if args.command == "serve":
        from .serve.server import run_serve
        return run_serve(args.dir, port=args.serve_port,
                         selfcheck=args.serve_selfcheck,
                         max_delay_ms=args.serve_max_delay_ms,
                         device=args.device)
    if args.command == "train":
        from .pipeline.train import TrainProcessor
        return TrainProcessor(args.dir, params={"resume": args.resume},
                              device=args.device).run()
    raise ValueError(f"unknown command {args.command!r}")


if __name__ == "__main__":
    sys.exit(main())
