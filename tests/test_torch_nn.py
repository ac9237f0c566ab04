"""Port parity for the NN model module: ``shifu_tpu_torch.models.nn``
against ``shifu_tpu.models.nn`` on the same numpy-seeded inputs, on the
CPU.

Tolerances: activations and losses rtol 1e-6 (the same f32 formulas);
the f32 forward 1e-6 absolute on sigmoid outputs (the same products
summed in another order); the bf16 forward 2e-2 (bf16 products in XLA's
and PyTorch's own rounding); ``weighted_loss`` gradients rtol 1e-5 (the
autograd of each package, another summation order).  Initial weights:
Xavier bit-equal, He and Lecun within 1e-6 (``erf_inv``'s ``log1p``
differs in the last bit); dropout masks bit-equal from one key.

The test rig runs JAX with 64-bit types on (ROADMAP Queue 3, C3), where
``jax.random.uniform`` with the default dtype draws float64.  The
reference's weights and dropout masks are drawn in float32 in every
deployment, so the draws are held here under ``jax.enable_x64(False)``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shifu_tpu.models import nn as jnn
from shifu_tpu_torch.models import nn as pnn
from shifu_tpu_torch.ops import prng

pytestmark = pytest.mark.torch_port

SHAPE = dict(input_dim=9, hidden_nodes=[7, 5], activations=["tanh", "relu"])


def _specs(**kw):
    args = {**SHAPE, **kw}
    return jnn.NNModelSpec(**args), pnn.NNModelSpec(**args)


def _jax_params(seed, spec):
    with jax.enable_x64(False):
        return [{k: np.asarray(v) for k, v in layer.items()}
                for layer in jnn.init_params(jax.random.PRNGKey(seed), spec)]


def _rows(seed, n=64, d=9):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(jnn.ACTIVATIONS))
def test_activations_match_reference(name):
    x = np.random.default_rng(1).normal(scale=3.0, size=(40, 6)).astype(
        np.float32)
    want = np.asarray(jnn.ACTIVATIONS[name](jnp.asarray(x)))
    got = pnn.ACTIVATIONS[name](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", sorted(jnn.LOSSES))
def test_losses_match_reference(name):
    rng = np.random.default_rng(2)
    p = rng.random((50, 1)).astype(np.float32)
    p[:3, 0] = [0.0, 1.0, 1e-9]                 # the log loss's clip
    y = (rng.random((50, 1)) < 0.4).astype(np.float32)
    want = np.asarray(jnn.LOSSES[name](jnp.asarray(p), jnp.asarray(y)))
    got = pnn.LOSSES[name](torch.from_numpy(p), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_native_softmax_per_row_loss_matches_reference():
    js, ps = _specs(output_dim=3, output_activation="softmax")
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(30, 3)).astype(np.float32)
    pred = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    y = rng.integers(0, 3, (30, 1)).astype(np.float32)
    want = np.asarray(jnn.per_row_loss(jnp.asarray(pred), jnp.asarray(y), js))
    got = pnn.per_row_loss(torch.from_numpy(pred), torch.from_numpy(y),
                           ps).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("init", ["xavier", "he", "lecun"])
def test_init_params_follow_the_reference_stream(init):
    js, ps = _specs()
    with jax.enable_x64(False):
        want = jnn.init_params(jax.random.PRNGKey(11), js, init)
    got = pnn.init_params(prng.prng_key(11), ps, init)
    for a, b in zip(want, got):
        assert b["w"].dtype == torch.float32
        if init == "xavier":
            assert np.array_equal(np.asarray(a["w"]), b["w"].numpy())
        else:
            np.testing.assert_allclose(b["w"].numpy(), np.asarray(a["w"]),
                                       rtol=0, atol=1e-6)
        assert np.array_equal(np.asarray(a["b"]), b["b"].numpy())


def test_forward_f32_single_and_stacked_match_reference():
    js, ps = _specs()
    x = _rows(4)
    members = [_jax_params(s, js) for s in (1, 2, 3)]
    stacked = pnn.stack_params([pnn.params_from_jax(m) for m in members])
    got = pnn.forward(stacked, ps, torch.from_numpy(x)).numpy()
    assert got.shape == (3, 64, 1)
    for i, m in enumerate(members):
        want = np.asarray(jnn.forward(m, js, jnp.asarray(x)))
        single = pnn.forward(pnn.params_from_jax(m), ps,
                             torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(single, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-6)


def test_forward_bf16_weights_match_reference():
    js, ps = _specs()
    x = _rows(5)
    p = _jax_params(6, js)
    jp = [{k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in l.items()}
          for l in p]
    want = np.asarray(jnn.forward(jp, js, jnp.asarray(x)))
    tp = [{k: torch.from_numpy(v).to(torch.bfloat16) for k, v in l.items()}
          for l in p]
    got = pnn.forward(tp, ps, torch.from_numpy(x))
    assert got.dtype == torch.float32            # the head widens back
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2)


@pytest.mark.parametrize("loss,l2,l1", [("squared", 0.0, 0.0),
                                        ("log", 1e-3, 2e-3),
                                        ("absolute", 0.0, 1e-3)])
def test_weighted_loss_gradients_match_jax_grad(loss, l2, l1):
    js, ps = _specs(loss=loss)
    rng = np.random.default_rng(7)
    x = _rows(8)
    y = (rng.random((64, 1)) < 0.5).astype(np.float32)
    w = rng.integers(1, 4, 64).astype(np.float32)
    p = _jax_params(9, js)
    jl, jg = jax.value_and_grad(jnn.weighted_loss)(
        [{k: jnp.asarray(v) for k, v in l.items()} for l in p], js,
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), l2=l2, l1=l1)
    tp = [{k: v.requires_grad_(True) for k, v in l.items()}
          for l in pnn.params_from_jax(p)]
    tl = pnn.weighted_loss(tp, ps, torch.from_numpy(x), torch.from_numpy(y),
                           torch.from_numpy(w), l2=l2, l1=l1)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    for a, b in zip(jg, tp):
        for k in ("w", "b"):
            np.testing.assert_allclose(b[k].grad.numpy(), np.asarray(a[k]),
                                       rtol=1e-5, atol=1e-8)


def test_dropout_masks_follow_the_reference_key():
    js, ps = _specs()
    x = _rows(10)
    p = _jax_params(12, js)
    with jax.enable_x64(False):
        key = jax.random.PRNGKey(21)
        want = np.asarray(jnn.forward(
            [{k: jnp.asarray(v) for k, v in l.items()} for l in p], js,
            jnp.asarray(x), dropout_rate=0.3, rng=key))
        mask = np.asarray(jax.random.bernoulli(
            jax.random.split(key)[1], 0.7, (64, 7)))
    got = pnn.forward(pnn.params_from_jax(p), ps, torch.from_numpy(x),
                      dropout_rate=0.3, rng=prng.prng_key(21)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    sub = prng.split(prng.prng_key(21))[1]
    assert np.array_equal(prng.bernoulli([sub], 0.7, (64, 7))[0].numpy(),
                          mask)


def test_nn_files_cross_load_both_ways(tmp_path):
    js, ps = _specs(extra={"algorithm": "NN"})
    p = _jax_params(13, js)
    x = _rows(14)
    ref_path, port_path = str(tmp_path / "ref.nn"), str(tmp_path / "port.nn")
    jnn.save_model(ref_path, js, [{k: jnp.asarray(v) for k, v in l.items()}
                                  for l in p])
    pnn.save_model(port_path, ps, pnn.params_from_jax(p))
    with open(ref_path, "rb") as f1, open(port_path, "rb") as f2:
        assert f1.read() == f2.read()
    want = jnn.IndependentNNModel.load(port_path).compute(x)
    got = pnn.IndependentNNModel.load(ref_path).compute(x, device="cpu")
    assert pnn.IndependentNNModel.load(ref_path).spec == ps
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_fit_params_into_matches_reference():
    old_j, old_p = _specs(hidden_nodes=[4], activations=["tanh"])
    new_j, new_p = _specs(hidden_nodes=[6, 3], activations=["tanh"])
    old = _jax_params(15, old_j)
    with jax.enable_x64(False):
        want = jnn.fit_params_into(
            old_j, [{k: jnp.asarray(v) for k, v in l.items()} for l in old],
            new_j, jax.random.PRNGKey(16))
    got = pnn.fit_params_into(old_p, pnn.params_from_jax(old), new_p,
                              prng.prng_key(16))
    for a, b in zip(want, got):
        for k in ("w", "b"):
            assert np.array_equal(np.asarray(a[k]), b[k].numpy())
    too_big = pnn.NNModelSpec(input_dim=9, hidden_nodes=[2],
                              activations=["tanh"])
    assert pnn.fit_params_into(new_p, got, too_big, prng.prng_key(0)) is None


def test_params_round_trip_through_the_reference_layout():
    js, _ = _specs()
    p = _jax_params(17, js)
    back = pnn.params_to_jax(pnn.params_from_jax(p))
    for a, b in zip(p, back):
        for k in ("w", "b"):
            assert np.array_equal(a[k], b[k])
