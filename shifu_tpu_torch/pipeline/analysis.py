"""`analysis -fi` — the port of ``shifu_tpu.pipeline.analysis``
(reference ``ShifuCLI.java:658`` ``analysisModelFi``): feature importance
from a saved GBT/RF model file, written next to it as ``<model>.fi``, on
the host.  ``analysis --telemetry`` (with ``--timeline``,
``--utilization`` or ``--aggregate``) renders the trace files
(``obs/{report,timeline,utilization}.py``; the CLI dispatches them).

The compact forest format serializes splits and leaves but not per-node
gains, so the standalone FI is depth-weighted split frequency (a split at
level L counts 1/2^L — shallower splits partition more rows); the exact
gain-weighted FI is produced at train time (``tmp/feature_importance.json``).
"""

from __future__ import annotations

import logging
import os

import numpy as np

from .. import ioutil

log = logging.getLogger(__name__)


def analyze_model_fi(model_path: str) -> int:
    if not model_path or not os.path.isfile(model_path):
        log.error("model %s does not exist", model_path)
        return 1
    ext = os.path.splitext(model_path)[1].lower()
    if ext not in (".gbt", ".rf", ".dt"):
        log.error("analysis -fi needs a GBT/RF model, got %s", model_path)
        return 1
    from ..models import tree as tree_model
    spec, trees = tree_model.load_model(model_path)
    n_feat = len(spec.column_nums or [])
    if not n_feat:
        n_feat = int(max(int(t.split_feat.max()) for t in trees)) + 1
    fi = np.zeros(n_feat)
    for t in trees:
        sf = np.asarray(t.split_feat)
        nodes = np.flatnonzero(sf >= 0)
        levels = np.floor(np.log2(nodes + 1)).astype(int)
        np.add.at(fi, sf[nodes], 1.0 / (1 << levels))
    names = spec.feature_names or [str(cn) for cn in spec.column_nums
                                   or range(n_feat)]
    out = model_path + ".fi"
    order = np.argsort(-fi)
    with ioutil.atomic_open(out) as f:
        for j in order:
            f.write(f"{names[j]}\t{fi[j]:.6f}\n")
    log.info("feature importance (%d features, %d trees) -> %s",
             n_feat, len(trees), out)
    return 0
