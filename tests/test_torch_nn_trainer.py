"""Port parity for the resident NN ensemble trainer:
``shifu_tpu_torch.train.nn_trainer.train_ensemble`` (``device="cpu"``)
against ``shifu_tpu.train.nn_trainer.train_ensemble`` on the same
numpy-seeded plane, initial weights carried in from the reference
(``models.nn.params_from_jax``), for five epochs.

Tolerance: per-epoch errors and final weights within rtol 1e-4 (atol
1e-6 on weights).  Under pytest the reference sums its gradients over
the data axis of an 8-device CPU mesh, the port in one pass, so the f32
sums differ in the last bits; RPROP acts on their signs, and the planes
here keep every gradient clear of 0 for five epochs.  The reference
rounds ``MiniBatchs`` down to a multiple of its data-axis size and pads
rows to it (8 under pytest, 1 on one device, the port's semantics), so
the minibatch cases use 512 rows and batches of 64: multiples of 8 on
which both packages cut the same batches.  The dropout case uses
per-member hypers, whose rates the reference draws against in float32
(its uniform-rate path draws float64 under the rig's x64, C3).

Resume: a checkpoint of either package resumes in the other, and a
resumed port run equals the uninterrupted one bit for bit, f32 and mixed.
"""

import os

import numpy as np
import pytest
import torch

import jax

from shifu_tpu.models import nn as jnn
from shifu_tpu.train import nn_trainer as jt
from shifu_tpu_torch.config import environment
from shifu_tpu_torch.config.errors import ErrorCode, ShifuError
from shifu_tpu_torch.models import nn as pnn
from shifu_tpu_torch.train import nn_trainer as pt

pytestmark = pytest.mark.torch_port

RTOL = 1e-4
N, D = 512, 10


@pytest.fixture(autouse=True)
def _clean_env():
    from shifu_tpu.config import environment as j_environment
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    yield
    environment.reset_for_tests()
    j_environment.reset_for_tests()


def _plane(bags, classes=2, seed=0):
    """A logistic plane (labels in ``range(classes)``), integer weights,
    per-member bag masks and one shared validation split."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    logits = x[:, :classes] * 1.5 + rng.normal(size=(N, classes)) * 0.5
    y = (logits.argmax(axis=1) if classes > 2
         else (logits[:, 0] > 0)).astype(np.float32)
    w = rng.integers(1, 4, N).astype(np.float32)
    valid = rng.random(N) < 0.25
    tw = np.stack([(rng.random(N) < 0.9) * ~valid * w
                   for _ in range(bags)]).astype(np.float32)
    vw = np.tile(valid * w, (bags, 1)).astype(np.float32)
    return x, y, tw, vw


def _spec(**kw):
    args = dict(input_dim=D, hidden_nodes=[8, 6],
                activations=["tanh", "sigmoid"], loss="squared")
    args.update(kw)
    return jnn.NNModelSpec(**args), pnn.NNModelSpec(**args)


def _init(spec, members, seed=1):
    with jax.enable_x64(False):
        keys = jax.random.split(jax.random.PRNGKey(seed), members)
        return [[{k: np.asarray(v) for k, v in l.items()}
                 for l in jnn.init_params(k, spec)] for k in keys]


def _run_both(spec_kw=None, members=1, classes=2, y_members=False,
              hypers=None, **settings):
    js, ps = _spec(**(spec_kw or {}))
    x, y, tw, vw = _plane(members // classes if y_members else members,
                          classes)
    if y_members:
        tw, vw = np.repeat(tw, classes, 0), np.repeat(vw, classes, 0)
        y_members = np.tile(np.stack([(y == k).astype(np.float32)
                                      for k in range(classes)]),
                            (members // classes, 1))
    else:
        y_members = None
    init = _init(js, members)
    kw = dict(epochs=5, seed=7)
    kw.update(settings)
    jr = jt.train_ensemble(x, y, tw, vw, js, jt.TrainSettings(**kw),
                           init_params_list=init, y_members=y_members,
                           member_hypers=hypers)
    pr = pt.train_ensemble(x, y, tw, vw, ps, pt.TrainSettings(**kw),
                           init_params_list=init, y_members=y_members,
                           member_hypers=hypers, device="cpu")
    return jr, pr


def _assert_close(jr, pr):
    assert pr.epochs_run == jr.epochs_run
    np.testing.assert_allclose(np.array(pr.history), np.array(jr.history),
                               rtol=RTOL)
    np.testing.assert_allclose(pr.valid_errors, jr.valid_errors, rtol=RTOL)
    np.testing.assert_allclose(pr.train_errors, jr.train_errors, rtol=RTOL)
    for jp, pp in zip(jr.params, pr.params):
        for a, b in zip(jp, pp):
            for k in ("w", "b"):
                np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]),
                                           rtol=RTOL, atol=1e-6)


CASES = {
    "full_batch_R": dict(),
    "minibatch_ADAM": dict(optimizer="ADAM", learning_rate=0.01,
                           batch_size=64),
    "three_bags_R": dict(members=3),
    "grid_hypers_ADAM": dict(
        members=3, optimizer="ADAM", learning_rate=0.02, batch_size=128,
        hypers={"lr_scale": np.array([1.0, 0.5, 2.0]),
                "l2": np.array([0.0, 1e-3, 0.0]),
                "l1": np.array([0.0, 0.0, 1e-3]),
                "dropout": np.array([0.0, 0.2, 0.1])}),
    "ova_y_members": dict(members=6, classes=3, y_members=True),
    "native_softmax": dict(
        classes=3, spec_kw=dict(output_dim=3, output_activation="softmax")),
    "fixed_layers": dict(optimizer="B", fixed_layers=(1,), fixed_bias=True),
    "decay_and_early_stop": dict(
        optimizer="ADAM", learning_rate=0.5, learning_decay=0.2,
        early_stop_window=1, epochs=12),
    "quickprop_log_loss": dict(optimizer="Q", learning_rate=0.05,
                               spec_kw=dict(loss="log")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_ensemble_matches_reference(case):
    jr, pr = _run_both(**CASES[case])
    _assert_close(jr, pr)
    if case == "decay_and_early_stop":
        assert pr.epochs_run < 12                 # the window tripped
    if case == "fixed_layers":
        init = _init(_spec()[0], 1)[0]
        assert np.array_equal(pr.params[0][0]["w"].numpy(), init[0]["w"])
        assert np.array_equal(pr.params[0][0]["b"].numpy(), init[0]["b"])


def _settings(d, **kw):
    base = dict(optimizer="ADAM", learning_rate=0.02, seed=3,
                checkpoint_dir=str(d), checkpoint_every=3)
    base.update(kw)
    return base


def _port_run(x, y, tw, vw, spec, init, **kw):
    return pt.train_ensemble(x, y, tw, vw, spec, pt.TrainSettings(**kw),
                             init_params_list=init, device="cpu")


def _same_bits(a, b):
    for pa, pb in zip(a.params, b.params):
        for la, lb in zip(pa, pb):
            for k in ("w", "b"):
                assert torch.equal(la[k], lb[k])
    assert np.array_equal(a.valid_errors, b.valid_errors)
    assert np.array_equal(a.train_errors, b.train_errors)


@pytest.mark.parametrize("precision", ["f32", "mixed"])
def test_resume_is_bit_identical_within_the_port(tmp_path, precision):
    js, ps = _spec()
    x, y, tw, vw = _plane(2)
    init = _init(js, 2)
    full = _port_run(x, y, tw, vw, ps, init, precision=precision,
                     **_settings(tmp_path / "a", epochs=6))
    _port_run(x, y, tw, vw, ps, init, precision=precision,
              **_settings(tmp_path / "b", epochs=3))
    res = _port_run(x, y, tw, vw, ps, init, precision=precision,
                    **_settings(tmp_path / "b", epochs=6, resume=True))
    _same_bits(full, res)
    assert res.history == full.history[3:]
    if precision == "mixed":
        assert res.params[0][0]["w"].dtype == torch.bfloat16


def test_precision_mismatch_on_resume_is_a_coded_error(tmp_path):
    js, ps = _spec()
    x, y, tw, vw = _plane(1)
    init = _init(js, 1)
    _port_run(x, y, tw, vw, ps, init, **_settings(tmp_path, epochs=3))
    with pytest.raises(ShifuError) as ei:
        _port_run(x, y, tw, vw, ps, init, precision="mixed",
                  **_settings(tmp_path, epochs=6, resume=True))
    assert ei.value.error_code is ErrorCode.ERROR_CHECKPOINT_PRECISION_MISMATCH


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    """Three epochs in one package, three more in the other from its
    checkpoint: the result matches the resuming package's uninterrupted
    run within the parity tolerance (leaf order, dtypes and the key carry
    over exactly)."""
    js, ps = _spec()
    x, y, tw, vw = _plane(2)
    init = _init(js, 2)
    d = tmp_path / "ckpt"
    if writer == "reference":
        jt.train_ensemble(x, y, tw, vw, js, jt.TrainSettings(
            **_settings(d, epochs=3)), init_params_list=init)
        res = _port_run(x, y, tw, vw, ps, init,
                        **_settings(d, epochs=6, resume=True))
        full = _port_run(x, y, tw, vw, ps, init,
                         **_settings(tmp_path / "full", epochs=6))
        got, want = res, full
    else:
        _port_run(x, y, tw, vw, ps, init, **_settings(d, epochs=3))
        res = jt.train_ensemble(x, y, tw, vw, js, jt.TrainSettings(
            **_settings(d, epochs=6, resume=True)), init_params_list=init)
        full = jt.train_ensemble(x, y, tw, vw, js, jt.TrainSettings(
            **_settings(tmp_path / "full", epochs=6)), init_params_list=init)
        got, want = full, res
    assert len(res.history) == 3
    np.testing.assert_allclose(np.array(got.history[-3:]),
                               np.array(want.history[-3:]), rtol=RTOL)
    for jp, pp in zip(want.params, got.params):
        for a, b in zip(jp, pp):
            for k in ("w", "b"):
                np.testing.assert_allclose(np.asarray(b[k]), np.asarray(a[k]),
                                           rtol=RTOL, atol=1e-6)
    assert sorted(os.listdir(d)) == ["ckpt-3.npz", "ckpt-6.npz"]


def test_tmp_models_and_progress_per_epoch():
    js, ps = _spec()
    x, y, tw, vw = _plane(2)
    seen, saved = [], []
    res = pt.train_ensemble(
        x, y, tw, vw, ps, pt.TrainSettings(epochs=4, tmp_model_every=2),
        init_params_list=_init(js, 2),
        progress=lambda e, tr, va: seen.append((e, tr, va)),
        checkpoint=lambda e, ps_: saved.append((e, len(ps_))),
        device="cpu")
    assert [s[0] for s in seen] == [0, 1, 2, 3]
    assert [(s[1], s[2]) for s in seen] == res.history
    assert saved == [(1, 2), (3, 2)]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_mixed_checkpoint_restores_in_the_other_package(tmp_path, writer):
    """A mixed-precision checkpoint (bf16 params stored as uint16 bits,
    the f32 master and ADAM state in the optimizer tree, the precision
    tag) restores onto the other package's template leaf for leaf, bits
    equal."""
    import jax.numpy as jnp

    from shifu_tpu.train import checkpoint as jckpt
    from shifu_tpu.train import optimizers as jopt
    from shifu_tpu_torch.train import checkpoint as pckpt
    from shifu_tpu_torch.train import optimizers as popt
    js, ps = _spec()
    x, y, tw, vw = _plane(2)
    init = _init(js, 2)
    d = tmp_path / "ckpt"
    kw = _settings(d, epochs=3, precision="mixed")
    if writer == "reference":
        jt.train_ensemble(x, y, tw, vw, js, jt.TrainSettings(**kw),
                          init_params_list=init)
    else:
        _port_run(x, y, tw, vw, ps, init, **kw)
    jp = [[{k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in l.items()}
           for l in p] for p in init]
    jo = jopt.make_optimizer("ADAM", 0.02)
    jstack = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *jp)
    jstate = jax.tree_util.tree_map(lambda *a: jnp.stack(a),
                                    *[jopt.mixed_init(jo, p) for p in jp])
    jr = jckpt.restore_state(str(d), jt._ckpt_template(
        jstack, jstate, jax.random.PRNGKey(0), 2), expect_precision="mixed")
    pstack = pnn.stack_params([popt.cast_tree(pnn.params_from_jax(p),
                                              torch.bfloat16) for p in init])
    pstate = popt.mixed_init(pt.make_optimizer("ADAM", 0.02), pstack, 2)
    pr = pckpt.restore_state(str(d), pt._ckpt_template(pstack, pstate, 2),
                             expect_precision="mixed")
    assert jr is not None and pr is not None and jr[0] == pr[0] == 3
    jl = jax.tree_util.tree_leaves(jr[1])
    pl = pckpt.tree_leaves(pr[1])
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        a = np.asarray(a)
        if isinstance(b, torch.Tensor):
            assert str(b.dtype).replace("torch.", "") == str(a.dtype)
            b = b.view(torch.int16).numpy().view(np.uint16) \
                if b.dtype == torch.bfloat16 else b.numpy()
            a = a.view(np.uint16) if a.dtype.kind not in "biufc" else a
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name,dtype,tf32", [
    ("", None, False), ("float32", None, False), ("highest", None, False),
    ("bfloat16", torch.bfloat16, False), ("DEFAULT", torch.bfloat16, False),
    ("tensorfloat32", None, True), ("high", None, True)])
def test_precision_maps_on_the_card_and_is_ignored_on_the_cpu(name, dtype,
                                                              tf32):
    assert pt.matmul_mode(name, torch.device("cuda")) == (dtype, tf32)
    assert pt.matmul_mode(name, torch.device("cpu")) == (None, False)


def test_unknown_precision_raises():
    with pytest.raises(ValueError, match="Precision"):
        pt.matmul_mode("fp8", torch.device("cuda"))
