"""Port parity for the continual-refresh loop (``shifu_tpu_torch.refresh``,
``eval/gate.py``, ``pipeline/refresh.py``, ``Shards.from_row``) against
``shifu_tpu``: each of the 17 scenarios of ``tests/test_refresh.py`` runs
through both packages on the same seeded inputs (the port's nets carry
the reference's weights, its registries and scorers live on the CPU),
and the transcripts must be equal:

- the decision kinds, their order and their fields (timestamps and the
  real retrain wall excepted; paths compared relative to the model set);
- the journal stages after every tick, the generations, and whether the
  served scores moved;
- ``Shards.from_row`` views (files, ``shardRows``, ``numRows``);
- the gate's AUCs within ``AUC_TOL`` = 1e-6 (under pytest the reference
  sums its sweep in float64, C3; the port in the CLI's float32 scores);
- the warm GBT retrain: the restored trees bit-equal to the incumbent's,
  the counts of restored and appended trees equal, levels 0-1 of the
  appended trees equal at the default parameters and the whole structure
  with ``MinInfoGain`` 1e-3 (C9), leaves within rtol ``LEAF_RTOL`` = 1e-5.

Beyond the oracle, a journal the reference wrote and left at the gate
(killed by ``refresh:promote``) resumes in the port, which promotes it,
or adopts the swap the reference committed before it died.
"""

import json
import os
import shutil

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

AUC_TOL = 1e-6
LEAF_RTOL = 1e-5


# ------------------------------------------------------------- two packages
class _Pkg:
    """One package's refresh surface, and nets with the reference's
    weights (``models(seed0)``: two 8-input [8] relu nets)."""

    def __init__(self, name):
        self.name = name
        if name == "j":
            from shifu_tpu import faults, obs
            from shifu_tpu.config import environment
            from shifu_tpu.config.column_config import ColumnConfig
            from shifu_tpu.data.shards import Shards
            from shifu_tpu.eval import gate
            from shifu_tpu.models import nn as nn_model
            from shifu_tpu.obs.drift import DriftMonitor
            from shifu_tpu.obs.monitor import render_status
            from shifu_tpu import refresh
            from shifu_tpu.serve import registry
        else:
            from shifu_tpu_torch import faults, obs
            from shifu_tpu_torch.config import environment
            from shifu_tpu_torch.config.column_config import ColumnConfig
            from shifu_tpu_torch.data.shards import Shards
            from shifu_tpu_torch.eval import gate
            from shifu_tpu_torch.models import nn as nn_model
            from shifu_tpu_torch.obs.drift import DriftMonitor
            from shifu_tpu_torch.obs.monitor import render_status
            from shifu_tpu_torch import refresh
            from shifu_tpu_torch.serve import registry
        self.faults, self.obs, self.environment = faults, obs, environment
        self.ColumnConfig, self.Shards, self.gate = ColumnConfig, Shards, gate
        self.nn, self.DriftMonitor = nn_model, DriftMonitor
        self.render_status, self.refresh = render_status, refresh
        self._registry = registry

    @property
    def port(self) -> bool:
        return self.name == "p"

    def registry(self, state_dir=None):
        if self.port:
            return self._registry.ModelRegistry(state_dir=state_dir,
                                                device="cpu")
        return self._registry.ModelRegistry(state_dir=state_dir)

    def models(self, n=2, n_features=8, seed0=0):
        import jax
        from shifu_tpu.models import nn as jnn
        spec = jnn.NNModelSpec(input_dim=n_features, hidden_nodes=[8],
                               activations=["relu"])
        ref = [jnn.IndependentNNModel(spec, jnn.init_params(
            jax.random.PRNGKey(seed0 + i), spec)) for i in range(n)]
        if not self.port:
            return ref
        pspec = self.nn.NNModelSpec(input_dim=n_features, hidden_nodes=[8],
                                    activations=["relu"])
        return [self.nn.IndependentNNModel(
            pspec, self.nn.params_from_jax(m.params)) for m in ref]

    def auc_gate(self, old, new, holdout, min_delta=None):
        kw = {"device": "cpu"} if self.port else {}
        return self.gate.auc_gate(old, new, holdout, min_delta=min_delta,
                                  **kw)

    def set_faults(self, spec):
        self.environment.set_property("shifu.faults", spec)
        self.faults.reset_for_tests()

    def reset(self):
        self.environment.reset_for_tests()
        self.faults.reset_for_tests()


PKGS = {}


def _pkg(name) -> _Pkg:
    if name not in PKGS:
        PKGS[name] = _Pkg(name)
    return PKGS[name]


@pytest.fixture(autouse=True)
def _clean_env():
    for n in ("j", "p"):
        _pkg(n).reset()
    yield
    for n in ("j", "p"):
        _pkg(n).reset()
        _pkg(n).obs.set_enabled(False)


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _controller(P, tmp, reg=None, clock=None, gate=None, drift=None,
                slo=None, retrain=None, **cfg):
    reg = reg or P.registry()
    if "m" not in reg.keys():
        reg.load("m", P.models(seed0=0), buckets=(1, 4))
    clock = clock or Clock()
    calls = []

    def default_retrain(c, g):
        calls.append(g)
        return {"models": P.models(seed0=50 + 10 * g), "warm": True,
                "resumed_from": 7}

    kw = {"psi_threshold": 0.25, "cooldown_s": 10.0, "probation_s": 5.0}
    kw.update(cfg)
    R = P.refresh
    ctrl = R.RefreshController(
        str(tmp), registry=reg, key="m", config=R.RefreshConfig(**kw),
        clock=clock, sleep=lambda s: clock.advance(s),
        retrain_fn=retrain or default_retrain,
        gate_fn=gate or (lambda c, cand: P.gate.GateResult(
            0.5, 0.6, 0.1, 0.0, True, 100)),
        drift_fn=drift
        or (lambda: {"psi_max": 0.5, "rows": 256, "flagged": ["c1"]}),
        slo_alerts_fn=slo or (lambda: []))
    ctrl._retrain_calls = calls
    return ctrl, reg, clock


def _canon(obj, root):
    """Decisions and states without their wall times, paths relative to
    the model set ``root``."""
    if isinstance(obj, dict):
        return {k: _canon(v, root) for k, v in obj.items()
                if k not in ("ts", "train_s", "promoted_ts",
                             "cycle_started_ts", "last_cycle_end_ts",
                             "last_skip_ts")}
    if isinstance(obj, (list, tuple)):
        return [_canon(v, root) for v in obj]
    if isinstance(obj, str) and root and obj.startswith(root):
        return "<set>" + obj[len(root):]
    return obj


def _assert_same(a, b, path="$"):
    """Equal transcripts, floats within AUC_TOL (the gate's AUCs)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a, b)
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert isinstance(b, (int, float)), (path, a, b)
        if np.isnan(a):
            assert np.isnan(b), (path, a, b)
        else:
            assert abs(a - b) <= AUC_TOL, (path, a, b)
    else:
        assert a == b, (path, a, b)


def _both(tmp_path, scenario):
    """Run ``scenario(P, dir)`` in both packages, each in a directory of
    its own, and hold the transcripts equal; returns them."""
    out = {}
    for name in ("j", "p"):
        d = tmp_path / name
        d.mkdir()
        out[name] = _canon(scenario(_pkg(name), d), str(d))
    _assert_same(out["j"], out["p"])
    return out


def _kinds(ctrl):
    return [d["kind"] for d in ctrl.journal.decisions()]


# ------------------------------------------------------- decision matrix
def test_breach_retrain_promote_then_complete(tmp_path):
    def scenario(P, d):
        ctrl, reg, clock = _controller(P, d)
        x = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
        before = reg.get("m").score_batch(x).tobytes()
        t = [ctrl.tick()["kind"], reg.generation("m"), ctrl.journal.stage,
             reg.get("m").score_batch(x).tobytes() != before]
        clock.advance(6.0)
        t += [ctrl.tick()["kind"], ctrl.journal.stage,
              ctrl.journal.doc["last_outcome"], ctrl.journal.decisions()]
        return t

    t = _both(tmp_path, scenario)["p"]
    assert t[:4] == ["promote", 1, "probation", True]
    assert t[4:7] == ["complete", "idle", "promoted"]
    assert [r["kind"] for r in t[7]] == ["trigger", "train", "promote",
                                         "complete"]
    assert t[7][0]["source"] == "psi" and t[7][0]["psi_max"] == 0.5


def test_auc_regression_rejected_incumbent_untouched(tmp_path):
    """The real gate: labels follow the incumbent's scores, so the random
    candidate regresses AUC; both packages reject with the same AUCs."""
    from shifu_tpu.eval.scorer import Scorer
    rng = np.random.default_rng(3)
    hx = rng.normal(size=(512, 8)).astype(np.float32)
    old_scores = Scorer(_pkg("j").models(seed0=0)).score(hx).mean
    y = (old_scores > np.median(old_scores)).astype(np.float32)
    x = rng.normal(size=(4, 8)).astype(np.float32)

    def scenario(P, d):
        reg = P.registry()
        reg.load("m", P.models(seed0=0), buckets=(1, 4))
        holdout = P.gate.Holdout(x=hx, y=y, w=np.ones(512, np.float32))

        def gate(c, cand):
            return P.auc_gate(c.registry.get(c.key).models, list(cand),
                              holdout, min_delta=0.0)

        ctrl, reg, clock = _controller(P, d, reg=reg, gate=gate)
        before = reg.get("m").score_batch(x).tobytes()
        rec = ctrl.tick()
        with open(os.path.join(rec["archived"], "eval_report.json")) as f:
            report = json.load(f)
        return [rec, reg.generation("m"),
                reg.get("m").score_batch(x).tobytes() == before,
                ctrl.journal.stage, ctrl.journal.doc["last_outcome"],
                report]

    t = _both(tmp_path, scenario)["p"]
    assert t[0]["kind"] == "reject" and t[0]["gate"]["passed"] is False
    assert t[0]["gate"]["new_auc"] < t[0]["gate"]["old_auc"]
    assert t[1:5] == [0, True, "idle", "rejected"]
    assert t[5]["gate"]["passed"] is False


def test_slo_burn_in_probation_rolls_back(tmp_path):
    def scenario(P, d):
        alerts = []
        ctrl, reg, clock = _controller(P, d, slo=lambda: list(alerts))
        x = np.random.default_rng(1).normal(size=(4, 8)).astype(np.float32)
        before = reg.get("m").score_batch(x).tobytes()
        t = [ctrl.tick()["kind"],
             reg.get("m").score_batch(x).tobytes() != before]
        alerts.append({"severity": "page", "budget": "latency"})
        rec = ctrl.tick()
        return t + [rec, reg.generation("m"),
                    reg.get("m").score_batch(x).tobytes() == before,
                    ctrl.journal.doc["last_outcome"]]

    t = _both(tmp_path, scenario)["p"]
    assert t[:2] == ["promote", True]
    assert t[2]["kind"] == "rollback" and t[2]["reason"].startswith(
        "slo-burn")
    assert t[3:] == [0, True, "rolled_back"]


def test_canary_parity_failure_rolls_back(tmp_path):
    def scenario(P, d):
        ctrl, reg, clock = _controller(P, d)
        rng = np.random.default_rng(2)
        x = rng.normal(size=(4, 8)).astype(np.float32)
        before = reg.get("m").score_batch(x).tobytes()
        t = [ctrl.tick()["kind"]]
        ctrl._canary = {"x": rng.normal(size=(3, 8)).astype(np.float32),
                        "bins": None,
                        "expected": np.zeros((3, 2), np.float32),
                        "gen": reg.generation("m")}
        rec = ctrl.tick()
        return t + [rec, reg.get("m").score_batch(x).tobytes() == before]

    t = _both(tmp_path, scenario)["p"]
    assert t[0] == "promote" and t[1]["kind"] == "rollback"
    assert t[1]["reason"] == "canary-parity" and t[2] is True


def test_cooldown_suppresses_with_single_skip(tmp_path):
    def scenario(P, d):
        ctrl, reg, clock = _controller(P, d)
        t = [ctrl.tick()["kind"]]
        clock.advance(6.0)
        t.append(ctrl.tick()["kind"])
        t.append(ctrl.tick())
        t += [ctrl.tick(), ctrl.tick(), len(ctrl._retrain_calls)]
        clock.advance(11.0)
        t += [ctrl.tick()["kind"], len(ctrl._retrain_calls),
              ctrl.journal.decisions()]
        return t

    t = _both(tmp_path, scenario)["p"]
    assert t[:2] == ["promote", "complete"]
    assert t[2]["kind"] == "skip" and t[2]["reason"] == "cooldown"
    assert t[3:8] == [None, None, 1, "promote", 2]


def test_schedule_trigger_fires_without_drift(tmp_path):
    def scenario(P, d):
        ctrl, reg, clock = _controller(P, d, drift=lambda: None,
                                       interval_s=100.0, cooldown_s=0.0)
        t = [ctrl.tick()]
        clock.advance(101.0)
        return t + [ctrl.tick()["kind"], ctrl.journal.decisions()[0]]

    t = _both(tmp_path, scenario)["p"]
    assert t[:2] == [None, "promote"] and t[2]["source"] == "schedule"


def _dir_retrain(P, cand, calls):
    """A retrain that stages a dir-backed candidate (it survives the
    controller's death)."""
    def retrain(c, g):
        calls.append(g)
        cdir = c.journal.candidate_dir(g)
        os.makedirs(cdir, exist_ok=True)
        for i, m in enumerate(cand):
            P.nn.save_model(os.path.join(cdir, f"model{i}.nn"), m.spec,
                            m.params)
        return {"models_dir": cdir, "warm": True, "resumed_from": 5}
    return retrain


def test_crash_mid_promote_keeps_incumbent_and_resumes(tmp_path):
    """``refresh:promote`` leaves the incumbent live and bit-identical and
    the journal at the gate; a fresh controller resumes there without
    retraining."""
    def scenario(P, d):
        reg = P.registry()
        reg.load("m", P.models(seed0=0), buckets=(1, 4))
        clock, calls = Clock(), []
        retrain = _dir_retrain(P, P.models(seed0=99), calls)
        ctrl, reg, clock = _controller(P, d, reg=reg, clock=clock,
                                       retrain=retrain)
        x = np.random.default_rng(5).normal(size=(4, 8)).astype(np.float32)
        before = reg.get("m").score_batch(x).tobytes()
        P.set_faults("refresh:promote=m:ioerror")
        with pytest.raises(P.faults.InjectedFault):
            ctrl.tick()
        t = [reg.generation("m"),
             reg.get("m").score_batch(x).tobytes() == before,
             ctrl.journal.stage, _kinds(ctrl)]
        P.reset()
        ctrl2, _, _ = _controller(P, d, reg=reg, clock=clock,
                                  retrain=retrain)
        t.append(ctrl2.journal.stage)
        rec = ctrl2.tick()
        return t + [rec, reg.generation("m"), len(calls),
                    reg.get("m").score_batch(x).tobytes() != before]

    t = _both(tmp_path, scenario)["p"]
    assert t[:5] == [0, True, "trained", ["trigger", "train"], "trained"]
    assert t[5]["kind"] == "promote" and t[6:] == [1, 1, True]


def test_adopts_promotion_committed_before_death(tmp_path):
    def scenario(P, d):
        ctrl, reg, clock = _controller(P, d)
        P.set_faults("refresh:promote=m:ioerror")
        with pytest.raises(P.faults.InjectedFault):
            ctrl.tick()
        P.reset()
        reg.swap("m", P.models(seed0=50), buckets=(1, 4))   # the lost flip
        ctrl2, _, _ = _controller(P, d, reg=reg, clock=clock)
        rec = ctrl2.tick()
        return [rec, ctrl2.journal.stage,
                [r for r in ctrl2.journal.decisions()
                 if r["kind"] == "promote"], reg.generation("m")]

    t = _both(tmp_path, scenario)["p"]
    assert len(t[2]) == 1 and t[2][0]["resumed"] is True
    assert t[1] == "probation" and t[3] == 1


def test_journal_records_are_atomic_and_ordered(tmp_path):
    def scenario(P, d):
        ctrl, reg, clock = _controller(P, d)
        ctrl.tick()
        clock.advance(6.0)
        ctrl.tick()
        j = P.refresh.RefreshJournal(str(d))
        tmps = [f for _, _, files in os.walk(os.path.join(str(d),
                                                          "refresh"))
                for f in files if ".tmp" in f]
        names = sorted(os.listdir(os.path.join(str(d), "refresh",
                                               "decisions")))
        return [j.stage, j.cycle, [r["seq"] for r in j.decisions()],
                j.doc, tmps, names]

    t = _both(tmp_path, scenario)["p"]
    assert t[0] == "idle" and t[1] == 1 and t[2] == sorted(set(t[2]))
    assert t[3]["version"] == 1 and t[4] == []


# ----------------------------------------------------- live drift monitor
def _drift_cols(P, n_cols=3, n_bins=4):
    cols = []
    for j in range(n_cols):
        cc = P.ColumnConfig(columnNum=j, columnName=f"c{j}")
        cc.columnBinning.binBoundary = [float(i) for i in range(n_bins)]
        cc.columnBinning.binCountNeg = [100] * n_bins + [5]
        cc.columnBinning.binCountPos = [100] * n_bins + [5]
        cols.append(cc)
    return cols


def test_observe_drifted_windows_triggers_cycle(tmp_path):
    def scenario(P, d):
        reg = P.registry()
        reg.load("m", P.models(seed0=0), buckets=(1, 4))
        clock = Clock()
        R = P.refresh
        ctrl = R.RefreshController(
            str(d), registry=reg, key="m",
            config=R.RefreshConfig(psi_threshold=0.25, cooldown_s=0.0,
                                   probation_s=5.0),
            clock=clock, sleep=lambda s: clock.advance(s),
            retrain_fn=lambda c, g: {"models": P.models(seed0=50)},
            gate_fn=lambda c, cand: P.gate.GateResult(0.5, 0.6, 0.1, 0.0,
                                                      True, 10),
            drift_columns=_drift_cols(P), slo_alerts_fn=lambda: [])
        ctrl.observe(np.random.default_rng(0).integers(0, 4,
                                                       size=(256, 3)))
        t = [ctrl.tick()]
        for _ in range(4):
            ctrl.observe(np.zeros((256, 3), np.int64))
        rec = ctrl.tick()
        return t + [rec, ctrl.journal.decisions()[0]]

    t = _both(tmp_path, scenario)["p"]
    assert t[0] is None and t[1]["kind"] == "promote"
    assert t[2]["source"] == "psi" and t[2]["psi_max"] >= 0.25


def test_drift_artifact_emitted_atomically(tmp_path):
    def scenario(P, d):
        mon = P.DriftMonitor(_drift_cols(P))
        mon.update(np.zeros((64, 3), np.int64))
        path = os.path.join(str(d), "telemetry", "drift.json")
        summ = mon.emit(path=path)
        with open(path) as f:
            doc = json.load(f)
        return [doc["psi_max"] == summ["psi_max"], summ["psi_max"],
                summ["flagged"],
                [f for f in os.listdir(os.path.dirname(path))
                 if ".tmp" in f]]

    t = _both(tmp_path, scenario)["p"]
    assert t[0] is True and t[3] == []


# ---------------------------------------------------------- shards cursor
def test_shards_from_row_is_shard_aligned(tmp_path):
    def scenario(P, d):
        rows = [10, 20, 30]
        for i, r in enumerate(rows):
            np.savez(os.path.join(str(d), f"part-{i:05d}.npz"),
                     x=np.full((r, 2), i, np.float32),
                     y=np.zeros(r, np.float32))
        with open(os.path.join(str(d), "schema.json"), "w") as f:
            json.dump({"numRows": 60, "shardRows": rows}, f)
        s = P.Shards.open(str(d))
        t = [s.from_row(0) is s]
        for row in (10, 15, 30, 999):
            v = s.from_row(row)
            t.append([[os.path.basename(f) for f in v.files], v.num_rows,
                      v.n_shards, v.schema, float(v.load_all()["x"][0, 0])])
        return t

    t = _both(tmp_path, scenario)["p"]
    assert t[0] is True
    assert [v[1] for v in t[1:]] == [50, 50, 30, 30]
    assert t[4][3] == {"numRows": 30, "shardRows": [30]} and t[4][4] == 2.0


# ------------------------------------------------------------- gate units
def test_auc_gate_degenerate_holdout_fails_closed(tmp_path):
    hx = np.random.default_rng(7).normal(size=(64, 8)).astype(np.float32)

    def scenario(P, d):
        models = P.models()
        holdout = P.gate.Holdout(x=hx, y=np.ones(64, np.float32),
                                 w=np.ones(64, np.float32))
        return P.auc_gate(models, models, holdout).report()

    assert _both(tmp_path, scenario)["p"]["passed"] is False


def test_auc_gate_min_delta_bar(tmp_path):
    from shifu_tpu.eval.scorer import Scorer
    hx = np.random.default_rng(8).normal(size=(256, 8)).astype(np.float32)
    sc = Scorer(_pkg("j").models(seed0=0)).score(hx).mean
    y = (sc > np.median(sc)).astype(np.float32)

    def scenario(P, d):
        models = P.models(seed0=0)
        holdout = P.gate.Holdout(x=hx, y=y, w=np.ones(256, np.float32))
        return [P.auc_gate(models, models, holdout, 0.0).report(),
                P.auc_gate(models, models, holdout, 0.01).report()]

    same, bar = _both(tmp_path, scenario)["p"]
    assert same["passed"] is True and same["delta"] == 0.0
    assert bar["passed"] is False


# ------------------------------------------------------- monitor surface
def test_monitor_renders_refresh_state_line(tmp_path):
    import time as _time
    now = _time.time()

    def scenario(P, d):
        hdir = os.path.join(str(d), "telemetry", "health")
        os.makedirs(hdir)
        rec = {"kind": "health", "proc": "refresh-m", "pid": 1,
               "step": "REFRESH", "state": "running", "ts": now,
               "started_ts": now, "interval_s": 5.0, "beat": 1, "rows": 0,
               "last_progress_ts": now,
               "refresh": {"state": "probation", "last_decision": "promote",
                           "generation": 3, "generations_held": 2,
                           "cycle": 4, "last_outcome": "promoted"}}
        with open(os.path.join(hdir, "refresh-m.json"), "w") as f:
            json.dump(rec, f)
        frame = P.render_status(str(d), now=now)
        return [ln for ln in frame.splitlines() if "refresh[" in ln]

    lines = _both(tmp_path, scenario)["p"]
    assert len(lines) == 1 and "probation" in lines[0]
    assert "last=promote" in lines[0] and "gen=3 (+2 held)" in lines[0]
    assert "cycle=4" in lines[0]


# ------------------------------------------- the real GBT model sets
def _gbt_template(root, template, params):
    """A GBT incumbent trained by the reference over the prepared fraud
    plane, with its mid-forest checkpoint and score sidecar."""
    from shifu_tpu.config import ModelConfig
    from shifu_tpu.config.model_config import Algorithm
    from shifu_tpu.pipeline.train import TrainProcessor
    mdir = os.path.join(root, "fraudtest")
    shutil.copytree(template, mdir)
    mc = ModelConfig.load(os.path.join(mdir, "ModelConfig.json"))
    mc.train.algorithm = Algorithm.GBT
    mc.train.params = params
    mc.save(os.path.join(mdir, "ModelConfig.json"))
    assert TrainProcessor(mdir, params={}).run() == 0
    return mdir


@pytest.fixture(scope="module")
def _gbt_set(tmp_path_factory, _prepared_template):
    """The reference drill's incumbent: 8 trees of depth 3, a checkpoint
    every 4 (read-only: each package refreshes a copy)."""
    return _gbt_template(str(tmp_path_factory.mktemp("refresh_gbt")),
                         _prepared_template,
                         {"TreeNum": 8, "MaxDepth": 3, "Loss": "log",
                          "LearningRate": 0.1, "CheckpointInterval": 4})


def _copy_set(src, dst):
    shutil.copytree(src, dst)
    return dst


def _processor(P, mdir, **params):
    if P.port:
        from shifu_tpu_torch.pipeline.refresh import RefreshProcessor
        return RefreshProcessor(mdir, params=params, device="cpu")
    from shifu_tpu.pipeline.refresh import RefreshProcessor
    return RefreshProcessor(mdir, params=params)


def test_refresh_processor_step_no_trigger(tmp_path, _gbt_set):
    """The one-shot step in registry mode: a quiet drift plane records no
    decision and the step commits serving.json."""
    def scenario(P, d):
        mdir = _copy_set(_gbt_set, os.path.join(str(d), "fraudtest"))
        P.environment.set_property("shifu.refresh.psiThreshold", "1e9")
        rc = _processor(P, mdir, poll=0.01).run()
        with open(os.path.join(mdir, "serving", "serving.json")) as f:
            doc = json.load(f)
        return [rc, doc, P.refresh.RefreshJournal(mdir).decisions()]

    t = _both(tmp_path, scenario)["p"]
    assert t[0] == 0 and t[1]["fraudtest"]["generation"] == 0
    assert t[2] == []


def test_refresh_cli_runs_the_step_on_the_cpu(tmp_path, _gbt_set):
    """``refresh`` is a subcommand of the port's CLI (it was an unknown
    choice before), and ``lint`` raises naming its ROADMAP item."""
    from shifu_tpu_torch.cli import main
    mdir = _copy_set(_gbt_set, str(tmp_path / "fraudtest"))
    assert main(["-Dshifu.refresh.psiThreshold=1e9", "--dir", mdir,
                 "refresh", "--poll", "0.01", "--device", "cpu"]) == 0
    assert os.path.isfile(os.path.join(mdir, "serving", "serving.json"))
    for extra in ([], ["--json", "--rules", "R1", "shifu_tpu"]):
        with pytest.raises(NotImplementedError, match="item 13"):
            main(["--dir", mdir, "lint", *extra])


def test_registry_rollback_after_restart_serves_the_incumbent(tmp_path,
                                                              _gbt_set):
    """Registry mode across restarts: a real warm retrain is promoted,
    a restarted controller rolls it back on an SLO alert, and a registry
    restored from ``serving.json`` then serves the incumbent bit for bit,
    although the retrain overwrote the ``<set>/models`` workspace that
    generation 0 was first loaded from."""
    P = _pkg("p")
    key = "fraudtest"
    mdir = _copy_set(_gbt_set, str(tmp_path / key))
    state = os.path.join(mdir, "serving")
    cfg = P.refresh.RefreshConfig(psi_threshold=0.25, cooldown_s=0.0,
                                  probation_s=60.0, units=2)

    def restarted(alerts):
        reg = P.registry(state_dir=state)
        reg.restore(key, os.path.join(mdir, "models"), warm=False)
        ctrl = P.refresh.RefreshController(
            mdir, registry=reg, key=key, warm=False, config=cfg,
            drift_fn=lambda: {"psi_max": 0.9, "rows": 1, "flagged": []},
            gate_fn=lambda c, cand: P.gate.GateResult(0.5, 0.6, 0.1, 0.0,
                                                      True, 100),
            slo_alerts_fn=lambda: list(alerts))
        return reg, ctrl

    reg, ctrl = restarted([])
    assert ctrl.tick()["kind"] == "promote" and reg.generation(key) == 1
    assert len(_forest(os.path.join(mdir, "models", "model0.gbt"))) == 10
    _, ctrl = restarted([{"severity": "page", "budget": "latency"}])
    assert ctrl.tick()["kind"] == "rollback"
    with open(os.path.join(state, "serving.json")) as f:
        doc = json.load(f)[key]
    gen0 = os.path.join(mdir, "refresh", "candidates", "gen-0")
    assert doc["generation"] == 0 and doc["models_dir"] == gen0

    reg, _ = restarted([])
    pristine = P.registry()
    pristine.load(key, os.path.join(_gbt_set, "models"), warm=False)
    got, want = reg.get(key), pristine.get(key)
    assert reg.generation(key) == 0
    rng = np.random.default_rng(3)
    bins = rng.integers(0, 4, size=(64, want.n_bins_cols)).astype(np.int32)
    x = np.zeros((64, want.n_features), np.float32)
    assert np.asarray(got.score_batch(x, bins)).tobytes() == \
        np.asarray(want.score_batch(x, bins)).tobytes()


def _forest(path):
    from shifu_tpu_torch.models.tree import load_model
    return load_model(path)[1]


def _hold_forests(jtrees, ptrees, n_restored, j_inc, p_inc, whole):
    """Restored trees bit-equal to each package's incumbent (``j_inc``,
    ``p_inc``).  With ``whole``, every appended split and mask equal and
    leaves within LEAF_RTOL.  Without it (the default parameters, C9),
    levels 0-1 split alike in every appended tree grown from the same
    forest: once a tree's noise splits below level 1 part, the next
    trees' gradients differ and the comparison stops."""
    assert len(jtrees) == len(ptrees)
    for i in range(n_restored):
        for a, b in ((jtrees[i], j_inc[i]), (ptrees[i], p_inc[i])):
            assert np.asarray(a.split_feat).tobytes() == \
                np.asarray(b.split_feat).tobytes()
            assert np.asarray(a.leaf_value).tobytes() == \
                np.asarray(b.leaf_value).tobytes()
    for a, b in zip(jtrees[n_restored:], ptrees[n_restored:]):
        sa, sb = np.asarray(a.split_feat), np.asarray(b.split_feat)
        np.testing.assert_array_equal(sa[:None if whole else 3],
                                      sb[:None if whole else 3])
        if not whole and not np.array_equal(sa, sb):
            break
        if whole:
            np.testing.assert_array_equal(np.asarray(a.left_mask),
                                          np.asarray(b.left_mask))
            np.testing.assert_allclose(np.asarray(b.leaf_value),
                                       np.asarray(a.leaf_value),
                                       rtol=LEAF_RTOL, atol=1e-7)


def test_warm_gbt_retrain_whole_structure_with_min_gain(
        tmp_path, _prepared_template):
    """The warm GBT append on the prepared plane at ``MinInfoGain`` 1e-3
    (C9), twice: 6 restored trees and 3 appended on the full plane (the
    score sidecar restores f), then those 9 and 2 more past the cursor
    (the last shard only: the restored trees replay).  Every node equal,
    leaves within LEAF_RTOL."""
    base = _gbt_template(str(tmp_path / "base"), _prepared_template,
                         {"TreeNum": 6, "MaxDepth": 3, "Loss": "log",
                          "LearningRate": 0.1, "CheckpointInterval": 3,
                          "MinInfoGain": 1e-3})
    incumbent = _forest(os.path.join(base, "models", "model0.gbt"))

    def scenario(P, d):
        mdir = _copy_set(base, os.path.join(str(d), "fraudtest"))
        kw = {"device": "cpu"} if P.port else {}
        j = P.refresh.RefreshJournal(mdir)
        infos = []
        for gen, units in ((1, 3), (2, 2)):
            infos.append(P.refresh.warm_retrain(mdir, gen, journal=j,
                                                units=units, **kw))
        return infos

    out = _both(tmp_path, scenario)
    info = out["p"]
    assert [i["resumed_from"] for i in info] == [6, 9]
    assert [i["warm"] for i in info] == [True, True]
    assert info[0]["cursor_rows"] == 0 and info[1]["new_rows"] == 0
    assert info[1]["cursor_rows"] == info[0]["new_rows"] > 0
    inc = {"j": incumbent, "p": incumbent}
    for gen, n, restored in ((1, 9, 6), (2, 11, 9)):
        got = {k: _forest(os.path.join(str(tmp_path / k / "fraudtest"),
                                       "refresh", "candidates",
                                       f"gen-{gen}", "model0.gbt"))
               for k in ("j", "p")}
        assert len(got["p"]) == n
        _hold_forests(got["j"], got["p"], restored, inc["j"], inc["p"],
                      whole=True)
        inc = got


def _drill(P, mdir):
    """The reference's e2e drill: serve → drift breach → warm retrain →
    gated promote → ``refresh:promote`` kill survived → probation burn →
    rollback → a clean second cycle, on the CPU."""
    R = P.refresh
    if P.port:
        from shifu_tpu_torch.serve.server import ServeServer
        server = ServeServer(model_set_dir=mdir, buckets=(1, 8),
                             max_delay_ms=0.0, device="cpu")
    else:
        from shifu_tpu.serve.server import ServeServer
        server = ServeServer(model_set_dir=mdir, buckets=(1, 8),
                             max_delay_ms=0.0)
    scorer = server.registry.get(server.key)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, scorer.n_features)).astype(np.float32)
    bins = rng.integers(0, 4, size=(4, scorer.n_bins_cols)).astype(
        np.int32) if scorer.needs_bins else None
    before = server.score(x, bins).tobytes()
    clock, alerts = Clock(), []
    cfg = R.RefreshConfig(psi_threshold=0.25, cooldown_s=0.0,
                          probation_s=5.0, units=4, canary_rows=16,
                          holdout_rows=512)

    def make():
        return R.RefreshController(
            mdir, server=server, config=cfg, clock=clock,
            sleep=lambda s: clock.advance(s),
            drift_columns=R.drift_columns_for(mdir),
            slo_alerts_fn=lambda: list(alerts))

    ctrl = make()
    t = {"tick0": ctrl.tick()}
    n_cols = len(ctrl._drift.columns)
    for _ in range(4):
        ctrl.observe(np.zeros((512, n_cols), np.int64))
    t["psi"] = ctrl._drift.summary()["psi_max"]
    P.set_faults(f"refresh:promote={server.key}:ioerror")
    with pytest.raises(P.faults.InjectedFault):
        ctrl.tick()
    P.reset()
    t["killed"] = [server.registry.generation(server.key),
                   server.score(x, bins).tobytes() == before,
                   ctrl.journal.stage]
    ctrl2 = make()
    t["resumed"] = ctrl2.tick()
    promoted = server.score(x, bins)
    t["promoted_moved"] = promoted.tobytes() != before
    alerts.append({"severity": "page", "budget": "latency"})
    t["rollback"] = ctrl2.tick()
    t["rolled_back_bits"] = server.score(x, bins).tobytes() == before
    with open(os.path.join(mdir, "serving", "serving.json")) as f:
        t["serving_gen"] = json.load(f)[server.key]["generation"]
    alerts.clear()
    for _ in range(4):
        ctrl2.observe(np.zeros((512, n_cols), np.int64))
    t["second"] = ctrl2.tick()
    clock.advance(6.0)
    t["complete"] = ctrl2.tick()
    t["final_gen"] = server.registry.generation(server.key)
    t["final_finite"] = bool(np.isfinite(server.score(x, bins)).all())
    t["decisions"] = ctrl2.journal.decisions()
    t["state"] = ctrl2.journal.doc
    return t


def test_e2e_drill_warm_refresh_kill_resume_and_rollback(tmp_path,
                                                         _gbt_set):
    """The reference's drill in both packages: the same decisions (the
    train records' warm-start accounting, the gate's AUCs within
    AUC_TOL), the same generations and bit-stable scores at every
    transition; the candidates are the restored 8 trees bit-equal plus 4
    appended whose levels 0-1 agree (default parameters, C9), and the
    second cycle's the first candidate's 12 (its checkpoint) plus 4."""
    def scenario(P, d):
        return _drill(P, _copy_set(_gbt_set,
                                   os.path.join(str(d), "fraudtest")))

    t = _both(tmp_path, scenario)["p"]
    assert t["tick0"] is None and t["psi"] >= 0.25
    assert t["killed"] == [0, True, "trained"]
    assert t["resumed"]["kind"] == "promote" and t["promoted_moved"]
    assert t["rollback"]["kind"] == "rollback" and t["rolled_back_bits"]
    assert t["serving_gen"] == 0
    assert t["second"]["kind"] == "promote" and t["final_gen"] == 2
    assert t["complete"]["kind"] == "complete" and t["final_finite"]
    trains = [r for r in t["decisions"] if r["kind"] == "train"]
    assert [(r["warm"], r["resumed_from"], r["units"]) for r in trains] \
        == [(True, 8, 4), (True, 12, 4)]
    incumbent = _forest(os.path.join(_gbt_set, "models", "model0.gbt"))
    inc = {"j": incumbent, "p": incumbent}
    for r in trains:
        rel = r["models_dir"][len("<set>"):].lstrip("/")
        got = {k: _forest(os.path.join(str(tmp_path / k), rel,
                                       "model0.gbt"))
               for k in ("j", "p")}
        assert len(got["p"]) == r["resumed_from"] + 4
        _hold_forests(got["j"], got["p"], r["resumed_from"], inc["j"],
                      inc["p"], whole=False)
        inc = got


def test_reference_journal_killed_at_promote_resumes_in_the_port(
        tmp_path, _gbt_set):
    """A refresh journal the reference wrote, killed by
    ``refresh:promote`` after its warm retrain, resumes in the port at the
    gate without a second retrain and promotes; when the reference's swap
    had committed before the kill, the port's restored registry adopts
    it."""
    J, P = _pkg("j"), _pkg("p")
    outcomes = {}
    for case in ("gate", "adopt"):
        mdir = _copy_set(_gbt_set, str(tmp_path / case / "fraudtest"))
        jreg = J.registry(state_dir=os.path.join(mdir, "serving"))
        jreg.restore("fraudtest", os.path.join(mdir, "models"), warm=False)
        cfg = dict(psi_threshold=0.25, cooldown_s=0.0, probation_s=5.0,
                   units=2, holdout_rows=512)
        jctrl = J.refresh.RefreshController(
            mdir, registry=jreg, key="fraudtest", warm=False,
            config=J.refresh.RefreshConfig(**cfg),
            drift_fn=lambda: {"psi_max": 0.9, "rows": 1, "flagged": []},
            slo_alerts_fn=lambda: [])
        J.set_faults("refresh:promote=fraudtest:ioerror")
        with pytest.raises(J.faults.InjectedFault):
            jctrl.tick()
        J.reset()
        assert jctrl.journal.stage == "trained"
        cand = jctrl.journal.doc["candidate"]
        if case == "adopt":       # the flip landed before the death
            jreg.swap("fraudtest", cand, warm=False)
        preg = P.registry(state_dir=os.path.join(mdir, "serving"))
        preg.restore("fraudtest", os.path.join(mdir, "models"), warm=False)
        retrains = []
        pctrl = P.refresh.RefreshController(
            mdir, registry=preg, key="fraudtest", warm=False,
            config=P.refresh.RefreshConfig(**cfg),
            retrain_fn=lambda c, g: retrains.append(g),
            drift_fn=lambda: None, slo_alerts_fn=lambda: [])
        assert pctrl.journal.stage == "trained"
        rec = pctrl.tick()
        assert retrains == []
        assert rec["kind"] == "promote" and preg.generation("fraudtest") == 1
        assert pctrl.journal.stage == "probation"
        with open(os.path.join(mdir, "serving", "serving.json")) as f:
            doc = json.load(f)["fraudtest"]
        assert doc["generation"] == 1 and doc["models_dir"] == cand
        outcomes[case] = rec
    assert outcomes["gate"]["gate"]["passed"] is True
    assert "resumed" not in outcomes["gate"]
    assert outcomes["adopt"]["resumed"] is True
