"""Helpers of the port's parity tests (``tests/test_torch_*.py``)."""

import os

import numpy as np


def writable_reference_filter(monkeypatch):
    """Scoped work-around for the reference's filtered extraction (ROADMAP
    Queue 3, C14): ``shifu_tpu.data.purifier.DataPurifier.mask`` returns
    ``np.asarray`` of a pandas result, which pandas' copy-on-write makes
    read-only, and ``shifu_tpu.data.extract.ChunkExtractor.extract`` then
    updates it in place (``keep &= ...``), raising ``ValueError: output
    array is read-only``.  This patches the reference's ``mask`` to return
    a writable copy of the same values, through pytest's ``monkeypatch``,
    so nothing outlives the test."""
    from shifu_tpu.data import purifier

    mask = purifier.DataPurifier.mask

    def writable(self, df):
        return np.array(mask(self, df), dtype=bool)
    monkeypatch.setattr(purifier.DataPurifier, "mask", writable)


def shifted_source(d, out_dir):
    """The set's CSV cut to its ``web`` rows, so its bins drift from the
    training snapshot, as the set's dataPath."""
    from shifu_tpu.config import ModelConfig as JModelConfig
    path = os.path.join(d, "ModelConfig.json")
    mc = JModelConfig.load(path)
    with open(mc.dataSet.dataPath) as f:
        lines = f.read().splitlines()
    col = lines[0].split("|").index("channel")
    keep = [lines[0]] + [ln for ln in lines[1:]
                         if ln.split("|")[col] == "web"]
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "web.csv")
    with open(src, "w") as f:
        f.write("\n".join(keep) + "\n")
    mc.dataSet.dataPath = src
    mc.evals[0].dataSet.dataPath = src
    mc.save(path)
    return len(keep) - 1
