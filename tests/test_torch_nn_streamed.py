"""Port parity for the streamed (out-of-core) NN/LR trainer:
``train.nn_trainer.train_ensemble_streamed`` and the train step's
``_train_nn_streamed`` against ``shifu_tpu``'s, on a plane forced to
stream (``-Dshifu.train.streaming=on``, windows of 256 rows, so the
4,000-row fraud plane makes 16 windows an epoch).

The port runs on the CPU through its CLI, the reference through its
processors under ``jax.enable_x64(False)`` (the test rig's 64-bit mode
would draw float64 initial weights and sum the window errors in float64,
ROADMAP Queue 3 C3; every deployment of the reference, and the port, is
float32).  The streamed minibatch cases run the reference's ``train`` in
a process of its own on one XLA:CPU device: its slice edges land on
multiples of the data axis (8 on the rig's mesh, 1 on the port's one
device), and its streamed minibatch program aborts XLA:CPU now and then
on the 8-device mesh.  Tolerances are the
resident NN parity tests' (``tests/test_torch_nn_pipeline.py``):
per-epoch train and validation errors (the ``%.6f`` progress lines)
within 1e-4 relative + 2e-6, per-row scores within 5e-3 on the 0-1000
scale, AUC within ±0.005.  Also: the streamed full batch equals the
port's resident ``train_ensemble`` on the same masks within rtol 1e-4
(the reference's
``tests/test_streaming.py::test_streamed_fullbatch_matches_in_ram``), a
minibatch run converges, ``-resume`` is bit-identical to an
uninterrupted run, and mixed precision scores within the reference's
0.01 AUC bound of float32.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch.config import environment

from tests.test_torch_nn_pipeline import (ADAM, NN, _assert_same, _copies,
                                          _models, _perf, _progress,
                                          nn_template, three_class_template)

pytestmark = pytest.mark.torch_port

__all__ = ["nn_template", "three_class_template"]      # module fixtures

STREAM = {"shifu.train.streaming": "on", "shifu.train.windowRows": "256"}


@pytest.fixture(autouse=True)
def _clean_env():
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    yield
    environment.reset_for_tests()
    j_environment.reset_for_tests()


def _ref_step(d, step, **params):
    from shifu_tpu.pipeline.evaluate import EvalProcessor
    from shifu_tpu.pipeline.train import TrainProcessor
    for k, v in STREAM.items():
        j_environment.set_property(k, v)
    try:
        if step == "train":
            with jax.enable_x64(False):
                assert TrainProcessor(d, params=params).run() == 0
        else:
            assert EvalProcessor(d, params={"run_eval": ""}).run() == 0
    finally:
        j_environment.reset_for_tests()


def _port(d, *argv, props=STREAM):
    from shifu_tpu_torch.cli import main
    try:
        assert main([f"-D{k}={v}" for k, v in props.items()]
                    + ["--dir", d, *argv, "--device", "cpu"]) == 0
    finally:
        environment.reset_for_tests()


def _both(ref, port):
    _ref_step(ref, "train")
    _port(port, "train")
    _ref_step(ref, "eval")
    _port(port, "eval", "-run")


CASES = {
    "nn_rprop": ("NN", NN, {}),
    "lr_adam": ("LR", {"Propagation": "ADAM", "LearningRate": 0.1}, {}),
    "nn_dropout": ("NN", dict(NN, DropoutRate=0.2), {}),
    "nn_bagged": ("NN", NN, {"baggingNum": 3}),
    "nn_kfold": ("NN", NN, {"isCrossValidation": True, "numKFold": 3}),
    "nn_l2_decay": ("NN", dict(NN, RegularizedConstant=0.01,
                               LearningDecay=0.05), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_streamed_set_matches_reference(nn_template, tmp_path, case):
    alg, params, train = CASES[case]
    ref, port = _copies(nn_template, tmp_path, alg, params, **train)
    _both(ref, port)
    _assert_same(ref, port)
    n = train.get("baggingNum", train.get("numKFold", 1))
    ext = "lr" if alg == "LR" else "nn"
    assert _models(port) == [f"model{i}.{ext}" for i in range(n)]
    assert len(_progress(port)) == 8


@pytest.mark.parametrize("method", ["ONEVSALL", "NATIVE"])
def test_streamed_multiclass_matches_reference(three_class_template,
                                               tmp_path, method):
    ref, port = _copies(three_class_template, tmp_path, "NN", NN,
                        multiClassifyMethod=method)
    _both(ref, port)
    _assert_same(ref, port, multiclass=True)
    assert _perf(port)["accuracy"] > 0.6
    assert len(_models(port)) == (3 if method == "ONEVSALL" else 1)


def test_streamed_grid_search_picks_the_same_trial(nn_template, tmp_path):
    import json
    params = dict(NN, RegularizedConstant=[0.0, 0.01])
    ref, port = _copies(nn_template, tmp_path, "NN", params, epochs=4)
    _both(ref, port)
    reports = []
    for d in (ref, port):
        with open(os.path.join(d, "tmp", "grid_search.json")) as f:
            reports.append(json.load(f))
    assert [r["trial"] for r in reports[0]] == \
        [r["trial"] for r in reports[1]]
    np.testing.assert_allclose([r["validError"] for r in reports[1]],
                               [r["validError"] for r in reports[0]],
                               rtol=1e-4)
    _assert_same(ref, port)


def _ref_train_one_device(d):
    """The reference's streamed ``train`` of ``d`` in a process of its own
    on one XLA:CPU device, in float32."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="0",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    code = ("import sys, jax; assert len(jax.devices()) == 1; "
            "from shifu_tpu.config import environment; "
            "from shifu_tpu.pipeline.train import TrainProcessor; "
            f"[environment.set_property(k, v) for k, v in {STREAM!r}.items()]; "
            "assert not jax.config.jax_enable_x64; "
            "sys.exit(TrainProcessor(sys.argv[1], params={}).run())")
    subprocess.run([sys.executable, "-c", code, d], env=env, check=True,
                   timeout=300)


# MiniBatchs 80 cuts each 256-row window into slices of 85, 85 and 86 rows
MINIBATCH = dict(ADAM, MiniBatchs=80)
MINIBATCH_CASES = {
    "adam": ("nn_template", MINIBATCH, {}),
    "adam_dropout": ("nn_template", dict(MINIBATCH, DropoutRate=0.2), {}),
    "bagged_l2": ("nn_template", dict(MINIBATCH, RegularizedConstant=0.01),
                  {"baggingNum": 2}),
    "ova": ("three_class_template", MINIBATCH,
            {"multiClassifyMethod": "ONEVSALL"}),
}


@pytest.mark.parametrize("case", sorted(MINIBATCH_CASES))
def test_streamed_minibatch_matches_one_device_reference(request, tmp_path,
                                                         case):
    """Streamed minibatch training (slice edges from the window size,
    dropout keys folded in per window and slice, per-window errors taken
    before the window's updates, the per-slice normalised loss with L2)
    against the reference on one device: progress, scores and AUC at the
    tolerances above, models cross-loaded."""
    fixture, params, train = MINIBATCH_CASES[case]
    multiclass = "multiClassifyMethod" in train
    ref, port = _copies(request.getfixturevalue(fixture), tmp_path, "NN",
                        params, **train)
    _ref_train_one_device(ref)
    _port(port, "train")
    _ref_step(ref, "eval")
    _port(port, "eval", "-run")
    _assert_same(ref, port, multiclass=multiclass)
    n = 3 if multiclass else train.get("baggingNum", 1)
    assert _models(port) == [f"model{i}.nn" for i in range(n)]
    tr = _progress(port)[:, 0]
    assert len(tr) == 8 and tr[-1] < tr[0]


def _plane(d, n=600, dim=5, shard_rows=150, seed=0):
    """A norm plane of npz shards with its schema; (shards, x, y, w)."""
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.ioutil import atomic_savez, atomic_write_json
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] + rng.normal(0, 0.5, n) > 0) \
        .astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    os.makedirs(d)
    rows = []
    for i, s in enumerate(range(0, n, shard_rows)):
        atomic_savez(os.path.join(d, f"part-{i:05d}.npz"),
                     x=x[s:s + shard_rows], y=y[s:s + shard_rows],
                     w=w[s:s + shard_rows])
        rows.append(min(shard_rows, n - s))
    names = [f"f{i}" for i in range(dim)]
    atomic_write_json(os.path.join(d, "schema.json"), {
        "outputNames": names, "columnNums": list(range(dim)),
        "numRows": n, "shardRows": rows})
    return Shards.open(d), x, y, w


@pytest.mark.parametrize("batch", [0, 64])
def test_streamed_equals_resident_on_the_same_masks(tmp_path, batch):
    """Full batch: the streamed run is the resident run up to the order
    of the sums (rtol 1e-4); a minibatch run over windows converges."""
    from shifu_tpu_torch.data.streaming import ShardStream
    from shifu_tpu_torch.models import nn as nn_model
    from shifu_tpu_torch.train.nn_trainer import (TrainSettings,
                                                  train_ensemble,
                                                  train_ensemble_streamed)
    from shifu_tpu_torch.train.sampling import member_masks
    n, dim, bags = 600, 5, 2
    shards, x, y, w = _plane(str(tmp_path / "s"), n, dim)
    tm, vm = member_masks(n, bags, valid_rate=0.25, sample_rate=0.9,
                          replacement=False, targets=y, seed=0)
    spec = nn_model.NNModelSpec(input_dim=dim, hidden_nodes=[8],
                                activations=["tanh"], loss="log")
    settings = TrainSettings(
        optimizer="R" if batch == 0 else "ADAM",
        learning_rate=0.1 if batch == 0 else 0.02, epochs=6, seed=0,
        l2=1e-4, batch_size=batch)

    def mask_fn(idx, targets):
        idx = np.minimum(idx, n - 1)       # the padded tail weighs zero
        return tm[:, idx], vm[:, idx]

    stream = ShardStream(shards, ("x", "y", "w"), window_rows=128,
                         remainder_multiple=1 if batch == 0 else 0)
    got = train_ensemble_streamed(stream, spec, settings, bags, mask_fn,
                                  device="cpu")
    if batch:
        tr = np.array(got.history)[:, 0]
        assert tr[-1] < tr[0] and np.all(np.isfinite(tr))
        assert got.epochs_run == 6
        return
    want = train_ensemble(x, y, tm * w[None, :], vm * w[None, :], spec,
                          settings, device="cpu")
    np.testing.assert_allclose(got.valid_errors, want.valid_errors,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.array(got.history),
                               np.array(want.history), rtol=1e-4, atol=1e-6)
    for pg, pw in zip(got.params, want.params):
        for lg, lw in zip(pg, pw):
            for k in ("w", "b"):
                np.testing.assert_allclose(lg[k].numpy(), lw[k].numpy(),
                                           rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("params", [NN, dict(ADAM, MiniBatchs=64,
                                             DropoutRate=0.1)],
                         ids=["full_batch", "minibatch_dropout"])
def test_streamed_resume_is_bit_identical(nn_template, tmp_path, params):
    """Three epochs, then ``-resume`` to six, equals six epochs straight:
    model bytes and the resumed progress lines."""
    from shifu_tpu_torch.config import ModelConfig
    params = dict(params, CheckpointInterval=3)
    _, full = _copies(nn_template, tmp_path / "full", "NN", params,
                      epochs=6)
    _, part = _copies(nn_template, tmp_path / "part", "NN", params,
                      epochs=3)
    _port(full, "train")
    _port(part, "train")
    path = os.path.join(part, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.train.numTrainEpochs = 6
    mc.save(path)
    _port(part, "train", "-resume")
    for f in _models(full):
        with open(os.path.join(full, "models", f), "rb") as a, \
                open(os.path.join(part, "models", f), "rb") as b:
            assert a.read() == b.read(), f
    np.testing.assert_array_equal(_progress(part), _progress(full)[2:])


def test_streamed_mixed_precision_within_the_pinned_bound(nn_template,
                                                          tmp_path):
    """The reference's precision contract (``EPS_AUC`` 0.01): a streamed
    ``TrainPrecision mixed`` run scores within 0.01 AUC of the float32
    run and writes float32 model files."""
    base = dict(ADAM, NumHiddenNodes=[16], MiniBatchs=128,
                LearningRate=0.01)
    aucs = []
    for i, params in enumerate((base, dict(base, TrainPrecision="mixed"))):
        _, d = _copies(nn_template, tmp_path / str(i), "NN", params)
        _port(d, "train")
        _port(d, "eval", "-run")
        aucs.append(_perf(d)["areaUnderRoc"])
    assert aucs[0] > 0.7
    assert abs(aucs[0] - aucs[1]) <= 0.01
    from shifu_tpu_torch.models.nn import load_model
    _, params = load_model(os.path.join(d, "models", "model0.nn"))
    assert params[0]["w"].dtype == torch.float32
