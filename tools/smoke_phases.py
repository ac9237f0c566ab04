#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s phases alone on the card.

    python3 tools/smoke_phases.py PHASE [PHASE ...]

PHASE is one of ``train``, ``mesh``, ``stream``, ``nn_stream`` and
``wdl``, run in that order on one card from the repository root.  Each
runs the smoke's own function (``train_phase``, ``mesh_phase``,
``stream_phase``, ``nn_stream_phase``, ``wdl_phase``) with its checks,
on data from the smoke's seeds (the seed 0 streams of a whole run,
though the phases between them do not run, so the data may differ from
a whole run's); ``mesh`` and ``stream`` need ``train``.  The
smoke's marks log each phase's wall and the marked steps inside it;
the last line is a JSON object of the phases' walls (s).  A phase's wall
alone is cheaper to measure than a whole run of the smoke, and its host
is the same kind, so the smoke's time budget can be checked a phase at
a time.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

PHASES = ("train", "mesh", "stream", "nn_stream", "wdl")


def main(argv) -> int:
    wanted = set(argv)
    if not wanted or not wanted <= set(PHASES) or \
            (wanted & {"mesh", "stream"} and "train" not in wanted):
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    from shifu_tpu_torch.ops import cuda_lib
    if not torch.cuda.is_available():
        cs.fail("CUDA is not available")
    gpu = cs.gpu_identity()
    print(gpu, flush=True)
    t0 = time.perf_counter()
    cuda_lib.build(["tree_traverse", "hist", "stats_hist"])
    walls = {}
    mark = cs.marker(walls, t0)
    mark("kernels built")
    path_rng = np.random.default_rng([0, 1])
    with tempfile.TemporaryDirectory(prefix="smoke_phases_") as root:
        serve_root = os.path.join(root, "serve")
        os.makedirs(serve_root)
        plan = cs.write_model_set(serve_root, path_rng)["plan"]
        if "train" in wanted:
            trained = cs.train_phase(torch, root, serve_root, plan,
                                     path_rng)
            mark("train_phase")
            plane = trained.pop("plane")
        if "mesh" in wanted:
            cs.mesh_phase(torch, root, serve_root, plane, trained["dir"],
                          gpu)
            mark("mesh_phase")
        if "stream" in wanted:
            cs.stream_phase(torch, root, serve_root, plan,
                            np.random.default_rng([0, 5]), plane, gpu)
            mark("stream_phase")
        if "nn_stream" in wanted:
            cs.nn_stream_phase(torch, root, serve_root,
                               np.random.default_rng([0, 6]), gpu)
            mark("nn_stream_phase")
        if "wdl" in wanted:
            cs.wdl_phase(torch, root, serve_root, plan,
                         np.random.default_rng([0, 8]), gpu)
            mark("wdl_phase")
    print(json.dumps(walls), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
