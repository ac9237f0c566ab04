"""`convert` step — the port of ``shifu_tpu.pipeline.convert`` (reference
``shifu convert`` / ``util/IndependentTreeModelUtils``, zip <-> binary
model specs), on the host.

Our models are already self-contained npz blobs; convert maps npz <-> a
human-readable JSON spec (weights inlined) for diffing/porting.
"""

from __future__ import annotations

import glob
import json
import logging
import os

import numpy as np

from .. import ioutil

log = logging.getLogger(__name__)


def model_to_json(path: str, out_path: str) -> None:
    data = np.load(path)
    spec = json.loads(bytes(data["__spec__"]).decode())
    arrays = {k: data[k].tolist() for k in data.files if k != "__spec__"}
    ioutil.atomic_write_text(out_path,
                             json.dumps({"spec": spec,
                                         "arrays": arrays}))


def json_to_model(path: str, out_path: str) -> None:
    import io
    with open(path) as f:
        doc = json.load(f)
    arrays = {}
    for k, v in doc["arrays"].items():
        a = np.asarray(v)
        if k.startswith(("sf",)):
            a = a.astype(np.int32)
        elif k.startswith(("lm",)):
            a = a.astype(np.uint8)
        else:
            a = a.astype(np.float32)
        arrays[k] = a
    arrays["__spec__"] = np.frombuffer(
        json.dumps(doc["spec"]).encode(), np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    ioutil.atomic_write_bytes(out_path, buf.getvalue())


def run_convert(model_set_dir: str, params: dict) -> int:
    models_dir = os.path.join(os.path.abspath(model_set_dir), "models")
    to_binary = params.get("tob")
    n = 0
    if to_binary:
        for p in sorted(glob.glob(os.path.join(models_dir, "model*.json"))):
            out = p[:-5]  # strip .json -> original ext embedded in stem
            json_to_model(p, out)
            log.info("convert %s -> %s", p, out)
            n += 1
    else:
        for p in sorted(glob.glob(os.path.join(models_dir, "model*.*"))):
            if p.endswith(".json"):
                continue
            out = p + ".json"
            model_to_json(p, out)
            log.info("convert %s -> %s", p, out)
            n += 1
    if n == 0:
        log.error("no models found in %s", models_dir)
        return 1
    return 0
