"""Port parity for hot-swap (``shifu_tpu_torch.serve.registry``) against
``shifu_tpu.serve.registry``: the serving journal one package writes is
restored by the other, and the same prepare / commit / abort / rollback
sequence leaves both registries with the same generations, history and
journal, scoring the same raw records within 1e-3 on the 0–1000 scale
(``TOL``: f32 tree sums in another order).  Scorers live on the CPU here;
the capture contract (no capture at commit) is held too.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from shifu_tpu import faults as j_faults
from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch import faults
from shifu_tpu_torch.config import environment

pytestmark = pytest.mark.torch_port

TOL = 1e-3
BUCKETS = (1, 8)


@pytest.fixture(autouse=True)
def _clean():
    for env, f in ((environment, faults), (j_environment, j_faults)):
        env.reset_for_tests()
        f.reset_for_tests()
    yield
    for env, f in ((environment, faults), (j_environment, j_faults)):
        env.reset_for_tests()
        f.reset_for_tests()


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory, _prepared_template):
    """Two GBT model sets trained by the reference: 5 trees of depth 4 and
    3 of depth 3 (read-only)."""
    from shifu_tpu.config import ModelConfig
    from shifu_tpu.config.model_config import Algorithm
    from shifu_tpu.pipeline.train import TrainProcessor
    out = {}
    for name, params in (("a", {"TreeNum": 5, "MaxDepth": 4}),
                         ("b", {"TreeNum": 3, "MaxDepth": 3})):
        d = str(tmp_path_factory.mktemp("serve_swap") / name)
        shutil.copytree(_prepared_template, d)
        mc_path = os.path.join(d, "ModelConfig.json")
        mc = ModelConfig.load(mc_path)
        mc.train.algorithm = Algorithm.GBT
        mc.train.params = {**params, "Loss": "log", "LearningRate": 0.1}
        mc.save(mc_path)
        assert TrainProcessor(d, params={}).run() == 0
        out[name] = d
    return out


def _records(d, n=30):
    import csv

    from shifu_tpu_torch.config import ModelConfig
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    with open(mc.dataSet.dataPath) as f:
        return [dict(r) for _, r in zip(range(n),
                                        csv.DictReader(f, delimiter="|"))]


class _Pair:
    """A port and a reference registry over one state dir each, sharing
    the set's transform so every scorer takes raw records."""

    def __init__(self, root, set_dir):
        from shifu_tpu.serve.registry import ModelRegistry as JRegistry
        from shifu_tpu.serve.transform import FusedTransform as JTransform
        from shifu_tpu_torch.serve.registry import ModelRegistry
        from shifu_tpu_torch.serve.transform import FusedTransform
        self.reg = ModelRegistry(state_dir=os.path.join(root, "port"),
                                 device="cpu")
        self.jreg = JRegistry(state_dir=os.path.join(root, "ref"))
        self.tf = FusedTransform.from_dir(set_dir, dtype=torch.float64)
        self.jtf = JTransform.from_dir(set_dir)
        recs = _records(set_dir)
        self.packed = self.tf.parse_records(recs)[0]
        self.jpacked = self.jtf.parse_records(recs)[0]

    def scores(self, key):
        a = self.reg.get(key).score_batch_raw(self.packed)
        b = self.jreg.get(key).score_batch_raw(self.jpacked)
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) <= TOL
        return a

    def state(self, key):
        """(generation, next, pending, history without timestamps) of
        each registry — equal in both."""
        got = []
        for r in (self.reg, self.jreg):
            got.append((r.generation(key), r.next_generation(key),
                        r.pending_generation(key),
                        [(h["generation"], h["models_dir"])
                         for h in r.generation_history(key)]))
        assert got[0] == got[1]
        return got[0]

    def journals(self):
        docs = []
        for who in ("port", "ref"):
            path = os.path.join(self.reg.state_dir if who == "port"
                                else self.jreg.state_dir, "serving.json")
            doc = json.load(open(path))
            for ent in doc.values():           # wall-clock stamps differ
                ent.pop("promoted_ts")
                for h in ent["history"]:
                    h.pop("promoted_ts")
            docs.append(doc)
        assert docs[0] == docs[1]
        return docs[0]


def test_prepare_commit_abort_rollback_sequences_match(model_dirs,
                                                       tmp_path):
    from shifu_tpu_torch.serve import serve_capture_count
    a = os.path.join(model_dirs["a"], "models")
    b = os.path.join(model_dirs["b"], "models")
    p = _Pair(str(tmp_path), model_dirs["a"])
    for r, tf in ((p.reg, p.tf), (p.jreg, p.jtf)):
        r.load("k", a, buckets=BUCKETS, transform=tf)
    s0 = p.scores("k")
    assert p.state("k") == (0, 1, None, [])
    for r in (p.reg, p.jreg):
        assert r.prepare("k", b, buckets=BUCKETS) == 1
    assert p.state("k") == (0, 1, 1, [])
    assert np.array_equal(p.scores("k"), s0)        # pending: not live
    for r in (p.reg, p.jreg):
        assert r.abort("k") is True and r.abort("k") is False
    for r in (p.reg, p.jreg):
        r.prepare("k", b, buckets=BUCKETS)
    captures = p.reg._pending["k"].scorer.captures
    for r in (p.reg, p.jreg):
        r.commit("k")
    assert p.reg.get("k").captures == captures      # commit captured none
    s1 = p.scores("k")
    assert not np.array_equal(s1, s0)
    assert p.state("k") == (1, 2, None, [(0, a)])
    for r in (p.reg, p.jreg):
        r.swap("k", a, buckets=BUCKETS)
    assert p.state("k") == (2, 3, None, [(0, a), (1, b)])
    assert np.max(np.abs(p.scores("k") - s0)) == 0.0
    for r in (p.reg, p.jreg):
        r.rollback("k")
    assert p.state("k") == (1, 3, None, [(0, a)])
    assert np.array_equal(p.scores("k"), s1)        # the held scorer
    for r in (p.reg, p.jreg):
        r.rollback("k")
        with pytest.raises(LookupError):
            r.rollback("k")
    assert p.state("k") == (0, 3, None, [])
    assert np.array_equal(p.scores("k"), s0)
    for r in (p.reg, p.jreg):
        r.swap("k", b, buckets=BUCKETS)             # never reuses 1 or 2
    assert p.state("k")[0] == 3
    doc = p.journals()
    assert doc["k"]["generation"] == 3 and doc["k"]["models_dir"] == b
    assert serve_capture_count("serve.score.k") == 0


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journal_written_by_either_package_is_restored_by_the_other(
        model_dirs, tmp_path, writer):
    """Promotions journalled by one package; a fresh registry of the other
    restores the live generation, its models and the rollback history,
    and rolls back through it (rebuilding the prior scorer)."""
    from shifu_tpu.serve.registry import ModelRegistry as JRegistry
    from shifu_tpu_torch.serve.registry import ModelRegistry
    a = os.path.join(model_dirs["a"], "models")
    b = os.path.join(model_dirs["b"], "models")
    p = _Pair(str(tmp_path), model_dirs["a"])
    w = p.reg if writer == "port" else p.jreg
    w.load("k", a, buckets=BUCKETS)
    w.swap("k", b, buckets=BUCKETS)
    w.swap("k", a, buckets=BUCKETS)
    state_dir = w.state_dir
    if writer == "port":
        r = JRegistry(state_dir=state_dir)
        tf = p.jtf
    else:
        r = ModelRegistry(state_dir=state_dir, device="cpu")
        tf = p.tf
    r.restore("k", a, buckets=BUCKETS, transform=tf)
    assert r.generation("k") == 2 and r.next_generation("k") == 3
    assert [(h["generation"], h["models_dir"])
            for h in r.generation_history("k")] == [(0, a), (1, b)]
    packed = p.packed if writer == "reference" else p.jpacked
    got = r.get("k").score_batch_raw(packed)
    r.rollback("k")
    assert r.generation("k") == 1
    rolled = r.get("k").score_batch_raw(packed)
    for path, gen in ((a, 0), (b, 1)):
        other = ModelRegistry(device="cpu") if writer == "reference" \
            else JRegistry()
        other.load("k", path, buckets=BUCKETS, transform=tf)
        want = other.get("k").score_batch_raw(packed)
        assert np.max(np.abs((got if gen == 0 else rolled) - want)) \
            == 0.0
    doc = json.load(open(os.path.join(state_dir, "serving.json")))
    assert doc["k"]["generation"] == 1 and doc["k"]["models_dir"] == b


def test_swap_fault_leaves_the_previous_model_live(model_dirs, tmp_path):
    """``serve:swap=<key>`` (ioerror) after the candidate is captured and
    before the journal and the flip: both packages keep the incumbent
    live, scoring bit for bit as before, with the journal unchanged."""
    a = os.path.join(model_dirs["a"], "models")
    b = os.path.join(model_dirs["b"], "models")
    p = _Pair(str(tmp_path), model_dirs["a"])
    for r, tf in ((p.reg, p.tf), (p.jreg, p.jtf)):
        r.load("k", a, buckets=BUCKETS, transform=tf)
    before = p.scores("k")
    journal = p.journals()
    for env in (environment, j_environment):
        env.set_property("shifu.faults", "serve:swap=k:ioerror")
    faults.reset_for_tests()
    j_faults.reset_for_tests()
    with pytest.raises(faults.InjectedFault):
        p.reg.swap("k", b, buckets=BUCKETS)
    with pytest.raises(j_faults.InjectedFault):
        p.jreg.swap("k", b, buckets=BUCKETS)
    assert p.state("k") == (0, 1, None, [])
    assert np.array_equal(p.scores("k"), before)
    assert p.journals() == journal


def test_generation_history_limit_matches_reference(model_dirs, tmp_path):
    for env in (environment, j_environment):
        env.set_property("shifu.serve.generations", 1)
    a = os.path.join(model_dirs["a"], "models")
    b = os.path.join(model_dirs["b"], "models")
    p = _Pair(str(tmp_path), model_dirs["a"])
    for r, tf in ((p.reg, p.tf), (p.jreg, p.jtf)):
        r.load("k", a, buckets=BUCKETS, transform=tf)
        for d in (b, a, b):
            r.swap("k", d, buckets=BUCKETS)
    assert p.state("k") == (3, 4, None, [(2, a)])
    p.scores("k")
    assert p.journals()["k"]["history"] == [{"generation": 2,
                                             "models_dir": a}]
