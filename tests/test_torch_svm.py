"""The SVM slice (``shifu_tpu_torch.models.svm``,
``train/svm_trainer.py`` and the linear SVM on the NN path) against
``shifu_tpu`` on the CPU: the port of ``tests/test_svm_kernel.py`` and
the SVM cases of ``tests/test_train.py``.

Tolerances: kernel matrices rtol 1e-5 (+1e-6); after 2,000 projected
gradient iterations the duals within 1e-4 and the decision values within
1e-3 of the reference's (float32 matvecs summed in another order, 2,000
times); the support sets equal but for rows whose dual lies within that
1e-4 of the 1e-6 threshold; the linear SVM's per-epoch errors rtol 1e-4
(+2e-6); one model file scored by both packages within 1e-5; AUC
±0.005; served scores within 1e-3 of ``eval``'s on the 0-1000 scale.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from shifu_tpu_torch.config import environment
from shifu_tpu_torch.models import svm as P
from shifu_tpu_torch.train import svm_trainer as PT

from test_torch_wdl import _one_torch_thread  # noqa: F401
from test_torch_wdl_train import _auc, _port, _progress, wdl_template  # noqa

pytestmark = pytest.mark.torch_port

ALPHA_TOL = 1e-4
F_TOL = 1e-3
AUC_TOL = 0.005
KERNELS = {"linear": {}, "poly": dict(gamma=0.5, coef0=1.0, degree=3),
           "sigmoid": dict(gamma=0.5, coef0=0.0), "rbf": dict(gamma=1.0)}


@pytest.fixture(autouse=True)
def _clean_env():
    from shifu_tpu.config import environment as j_environment
    environment.reset_for_tests()
    j_environment.reset_for_tests()
    yield
    environment.reset_for_tests()
    j_environment.reset_for_tests()


def _circles(n=300, seed=0):
    """Concentric rings with a gap: linearly inseparable, RBF-easy."""
    rng = np.random.default_rng(seed)
    r = np.where(rng.random(n) < 0.5, 0.6, 1.6)
    th = rng.random(n) * 2 * np.pi
    x = np.stack([r * np.cos(th), r * np.sin(th)], axis=1)
    x += rng.normal(0, 0.08, x.shape)
    return x.astype(np.float32), (r > 1.0).astype(np.float32)


@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_kernel_matrix_matches_the_reference(kind):
    import jax.numpy as jnp
    from shifu_tpu.models.svm import SVMModelSpec, kernel_matrix
    rng = np.random.default_rng(1)
    a = rng.normal(size=(40, 6)).astype(np.float32)
    b = rng.normal(size=(25, 6)).astype(np.float32)
    rs = SVMModelSpec(input_dim=6, kernel=kind, **KERNELS[kind])
    want = np.asarray(kernel_matrix(rs, jnp.asarray(a), jnp.asarray(b)))
    ps = P.SVMModelSpec.from_json(rs.to_json())
    got = P.kernel_matrix(ps, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # the rbf distance clamp: a row against itself never passes 1
    if kind == "rbf":
        diag = torch.diagonal(P.kernel_matrix(ps, torch.from_numpy(a),
                                              torch.from_numpy(a))).numpy()
        assert (diag <= 1.0).all() and (diag >= 1.0 - 1e-5).all()


@pytest.mark.parametrize("kind", ["rbf", "poly", "sigmoid"])
def test_dual_matches_the_reference(kind, tmp_path):
    """2,000 iterations on 300 rows (20% validation): duals, decision
    values, errors and support sets; then the model files, read by either
    package, score alike."""
    import jax
    import jax.numpy as jnp
    from shifu_tpu.models.svm import SVMModelSpec
    from shifu_tpu.models.svm import load_model as j_load
    from shifu_tpu.train import svm_trainer as RT
    x, y = _circles()
    mask = np.ones(len(y), bool)
    mask[::5] = False
    rs = SVMModelSpec(input_dim=2, kernel=kind, **KERNELS[kind])
    y_pm = 2.0 * y - 1.0
    tm = mask.astype(np.float32)
    with jax.enable_x64(False):
        ra, rf, rtr, rva = (np.asarray(v) for v in RT._solve_dual(
            jnp.asarray(x), jnp.asarray(y_pm), jnp.asarray(tm),
            jnp.asarray(tm * 2.0), float(rs.gamma), float(rs.coef0),
            (rs.kernel, rs.degree), 2000))
        ref = RT.train_kernel_svm(x, y, mask, rs, c_penalty=2.0)
    ps = P.SVMModelSpec.from_json(rs.to_json())
    pa, pf, ptr, pva = (v.numpy() for v in PT._solve_dual(
        torch.from_numpy(x), torch.from_numpy(y_pm), torch.from_numpy(tm),
        torch.from_numpy(tm * 2.0), ps, 2000))
    np.testing.assert_allclose(pa, ra, rtol=0, atol=ALPHA_TOL)
    np.testing.assert_allclose(pf, rf, rtol=0, atol=F_TOL)
    np.testing.assert_allclose([ptr, pva], [rtr, rva], rtol=0, atol=F_TOL)
    assert (pa[~mask] == 0).all()               # validation rows never SVs
    differ = (pa > 1e-6) != (ra > 1e-6)
    assert (np.abs(ra[differ] - 1e-6) <= ALPHA_TOL).all()
    got = PT.train_kernel_svm(x, y, mask, ps, c_penalty=2.0, device="cpu")
    assert abs(got[4] - ref[4]) <= differ.sum()
    np.testing.assert_allclose(got[2:4], ref[2:4], rtol=0, atol=F_TOL)
    # files either way
    P.save_model(str(tmp_path / "port.svm"), ps, got[0], got[1])
    from shifu_tpu.models.svm import save_model as j_save
    j_save(str(tmp_path / "ref.svm"), rs, ref[0], ref[1])
    js, jx, ja = j_load(str(tmp_path / "port.svm"))
    np.testing.assert_array_equal(jx, got[0])
    from shifu_tpu_torch.models import load_any
    m = load_any(str(tmp_path / "ref.svm"))
    assert type(m).__name__ == "IndependentSVMModel"
    from shifu_tpu.models.svm import IndependentSVMModel as JM
    want = np.asarray(JM(rs, ref[0], ref[1]).compute(x))
    np.testing.assert_allclose(m.compute(x, device="cpu"), want, rtol=0,
                               atol=1e-5)
    acc = ((m.compute(x, device="cpu")[:, 0] > 0.5) == (y > 0.5)).mean()
    if kind == "rbf":
        assert acc > 0.95


def test_row_cap_and_streamed_kernels_are_refused():
    from shifu_tpu.pipeline.train import svm_spec as j_svm_spec
    from shifu_tpu_torch.config.errors import ShifuError
    from shifu_tpu_torch.pipeline.train import svm_spec
    x = np.zeros((PT.MAX_KERNEL_ROWS + 1, 2), np.float32)
    with pytest.raises(ShifuError, match="16384"):
        PT.train_kernel_svm(x, np.zeros(len(x)), np.ones(len(x), bool),
                            P.SVMModelSpec(input_dim=2), device="cpu")
    with pytest.raises(ShifuError, match="streamed"):
        svm_spec(4, {"Kernel": "RBF"}, [0, 1, 2, 3], [])
    got = svm_spec(3, {"Const": 2.0}, [0, 1, 2], ["a", "b", "c"])
    want = j_svm_spec(3, {"Const": 2.0}, [0, 1, 2], ["a", "b", "c"])
    assert got.to_json() == want.to_json()
    assert got.loss == "hinge" and got.output_activation == "linear"


def _svm_set(template, tmp_path, params, bags=1, epochs=6):
    from test_torch_wdl_train import _copies
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    ref, port = _copies(template, tmp_path, {}, epochs=epochs, bags=bags)
    for d in (ref, port):
        path = os.path.join(d, "ModelConfig.json")
        mc = ModelConfig.load(path)
        mc.train.algorithm = Algorithm.SVM
        mc.train.params = dict(params)
        mc.save(path)
    return ref, port


def _cut_training_rows(ref, port, rows):
    """Both sets train on the CSV's first ``rows`` rows: the reference's
    ``norm`` rewrites the reference copy's planes from a cut of the data
    file, and the port copy takes them (the eval set keeps the whole
    CSV)."""
    from shifu_tpu.config import ModelConfig
    from shifu_tpu.pipeline.norm import NormalizeProcessor
    path = os.path.join(ref, "ModelConfig.json")
    mc = ModelConfig.load(path)
    cut = os.path.join(ref, "train_cut.csv")
    with open(mc.dataSet.dataPath) as src, open(cut, "w") as out:
        for _, line in zip(range(rows + 1), src):      # the header, rows
            out.write(line)
    mc.dataSet.dataPath = cut
    mc.save(path)
    assert NormalizeProcessor(ref, params={}).run() == 0
    shutil.rmtree(os.path.join(port, "tmp"))
    shutil.copytree(os.path.join(ref, "tmp"), os.path.join(port, "tmp"))
    shutil.copy(path, os.path.join(port, "ModelConfig.json"))


def _ref(d, *steps, props=None):
    import jax
    from shifu_tpu.config import environment as j_environment
    from shifu_tpu.pipeline.evaluate import EvalProcessor
    from shifu_tpu.pipeline.train import TrainProcessor
    for k, v in (props or {}).items():
        j_environment.set_property(k, v)
    with jax.enable_x64(False):
        for step in steps:
            if step == "train":
                assert TrainProcessor(d, params={}).run() == 0
            else:
                assert EvalProcessor(d, params={"run_eval": ""}).run() == 0


def test_linear_svm_on_the_nn_path_matches_the_reference(wdl_template,
                                                         tmp_path):
    """Hinge on a linear head, ``Const`` 20 as L2 1/40, minibatches of
    512, 2 bags: progress, the ``.svm`` files (NN-format, scored through a
    sigmoid) and AUC."""
    ref, port = _svm_set(wdl_template, tmp_path,
                         {"Kernel": "linear", "Const": 20.0,
                          "Propagation": "ADAM", "LearningRate": 0.05,
                          "MiniBatchs": 512}, bags=2)
    _ref(ref, "train", "eval")
    assert _port(port, "train") == 0
    assert _port(port, "eval", "-run") == 0
    np.testing.assert_allclose(_progress(port), _progress(ref), rtol=1e-4,
                               atol=2e-6)
    assert abs(_auc(port) - _auc(ref)) <= AUC_TOL
    assert _auc(port) > 0.7
    from shifu_tpu_torch.models import load_any
    for f in ("model0.svm", "model1.svm"):
        specs = [json.loads(bytes(np.load(os.path.join(
            d, "models", f))["__spec__"]).decode()) for d in (ref, port)]
        assert specs[0] == specs[1]
        m = load_any(os.path.join(port, "models", f))
        assert m.spec.loss == "hinge" and m.spec.extra["margin_sigmoid"]
        assert m.spec.output_activation == "sigmoid"


def test_kernel_svm_set_through_the_cli_matches_the_reference(wdl_template,
                                                              tmp_path):
    """RBF, one bag trained on the CSV's first 1,200 rows (the dual's
    2,000 iterations over all 4,000 take seconds a package), evaluated on
    all of it: the train and validation hinge,
    AUC, the served scores, and the refusals (grid search, the spec and
    PMML exports, which have no kernel-SVM format)."""
    params = {"Kernel": "RBF", "Gamma": 0.2, "Const": 1.0}
    ref, port = _svm_set(wdl_template, tmp_path, params)
    _cut_training_rows(ref, port, 1200)
    _ref(ref, "train", "eval")
    assert _port(port, "train") == 0
    assert _port(port, "eval", "-run") == 0

    def hinge(d):
        with open(os.path.join(d, "tmp", "train.progress")) as f:
            line = f.read().split()
        return [float(line[4]), float(line[7])], int(line[8].lstrip("("))
    (gh, gn), (wh, wn) = hinge(port), hinge(ref)
    np.testing.assert_allclose(gh, wh, rtol=0, atol=F_TOL)
    assert abs(gn - wn) <= 0.01 * wn
    assert abs(_auc(port) - _auc(ref)) <= AUC_TOL
    from shifu_tpu_torch.eval.scorer import Scorer
    from shifu_tpu_torch.models import load_any
    from shifu_tpu_torch.serve.scorer import AOTScorer
    models = [load_any(os.path.join(port, "models", "model0.svm"))]
    aot = AOTScorer(models, device="cpu", buckets=(8, 64))
    assert aot.n_bins_cols == 0
    x = np.random.default_rng(3).normal(
        size=(70, aot.n_features)).astype(np.float32)
    np.testing.assert_allclose(aot.score_batch(x),
                               Scorer(models, device="cpu").score(x).scores,
                               rtol=0, atol=1e-3)
    assert _port(port, "export", "-t", "spec") == 1
    assert _port(port, "export", "-t", "pmml") == 1
    from shifu_tpu_torch.config import ModelConfig
    path = os.path.join(port, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.train.params = {**params, "Gamma": [0.1, 0.2]}
    mc.save(path)
    with pytest.raises(ValueError, match="grid search"):
        _port(port, "train")
