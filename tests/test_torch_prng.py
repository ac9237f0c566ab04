"""Port parity for ``shifu_tpu_torch.ops.prng``: JAX's threefry stream
(``PRNGKey``, ``fold_in``, ``split``, ``uniform``, ``poisson``) on the
CPU, bit for bit against ``jax.random`` under the test rig's x64 mode,
for several seeds (one past 2^32) and tree ids — the Random Forest's bags
must be the reference's bags, or the two packages grow different forests
from one seed and cannot resume each other's checkpoints."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shifu_tpu_torch.ops import prng

pytestmark = pytest.mark.torch_port

SEEDS = (0, 3, 12345, (1 << 32) + 7, -5)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the draws are long chains of small
    elementwise ops, which several test workers' thread pools, each the
    size of the machine, slow down by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(k):
    return tuple(int(v) for v in np.asarray(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert _key(key) == prng.prng_key(seed)
    for tree in (0, 1, 7, 9, 4095, (1 << 32) - 1):
        assert _key(jax.random.fold_in(key, tree)) == \
            prng.fold_in(prng.prng_key(seed), tree)
    assert [_key(k) for k in jax.random.split(key)] == \
        list(prng.split(prng.prng_key(seed)))
    assert [_key(k) for k in jax.random.split(key, 5)] == \
        list(prng.split(prng.prng_key(seed), 5))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniforms_equal_jax(seed):
    keys = [jax.random.fold_in(jax.random.PRNGKey(seed), t) for t in (0, 3)]
    got = prng.uniform_f32([_key(k) for k in keys], 4097)
    for k, row in zip(keys, got):
        want = np.asarray(jax.random.uniform(k, (4097,), jnp.float32))
        assert row.dtype == torch.float32
        np.testing.assert_array_equal(row.numpy(), want)
    # row i's bits depend on the key and i only: a prefix is a prefix
    np.testing.assert_array_equal(
        prng.uniform_f32([_key(keys[0])], 100)[0].numpy(), got[0, :100])


@pytest.mark.parametrize("lam", [0.5, 1.0, 3.0])
def test_poisson_bags_equal_jax(lam):
    n = 1 << 16
    cases = [(0, 0), (0, 7), (3, 1), ((1 << 32) + 7, 9)]
    got = prng.poisson([prng.fold_in(prng.prng_key(s), t) for s, t in cases],
                       lam, n)
    assert got.shape == (len(cases), n) and got.dtype == torch.float32
    for (seed, tree), row in zip(cases, got):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), tree)
        want = np.asarray(jax.random.poisson(key, lam, (n,)), np.float32)
        np.testing.assert_array_equal(row.numpy(), want)
    assert abs(float(got.mean()) - lam) < 0.02 * max(lam, 1.0)


def test_poisson_edge_rates():
    key = prng.prng_key(1)
    assert not prng.poisson([key], 0.0, 100).any()
    np.testing.assert_array_equal(
        prng.poisson([key], 9.5, 1000)[0].numpy(),
        np.asarray(jax.random.poisson(jax.random.PRNGKey(1), 9.5, (1000,)),
                   np.float32))
    with pytest.raises(ValueError, match="finite"):
        prng.poisson([key], -1.0, 10)


def _jax_poisson(seed, lam, n):
    return np.asarray(jax.random.poisson(jax.random.PRNGKey(seed), lam,
                                         (n,)), np.float32)


@pytest.mark.parametrize("lam,n", [(10.0, 1 << 20), (10.5, 1 << 16),
                                   (37.0, 1 << 16), (1000.0, 1 << 17),
                                   (1e5, 1 << 18)])
def test_poisson_rejection_sampler_is_bit_equal_to_jax(lam, n):
    """Rates >= 10 take jax's transformed rejection sampler: every draw
    equals ``jax.random.poisson``'s, under several keys."""
    seeds = (0, 1, 7) if n <= 1 << 17 else (3,)
    got = prng.poisson([prng.prng_key(s) for s in seeds], lam, n)
    for s, row in zip(seeds, got):
        np.testing.assert_array_equal(row.numpy(), _jax_poisson(s, lam, n))


def test_the_xla_math_the_sampler_uses_is_bit_equal():
    """``log_f32``, ``log1p_f32`` and ``lgamma_f32`` (x >= 0.5) give
    XLA:CPU's float32 bits, which the accept test needs at large k."""
    rng = np.random.default_rng(5)
    x = np.concatenate([np.arange(1, 120001, dtype=np.float32),
                        (rng.random(50000) * 1000 + 0.5).astype(np.float32)])
    np.testing.assert_array_equal(
        prng.lgamma_f32(torch.from_numpy(x)).numpy(),
        np.asarray(jax.lax.lgamma(jnp.asarray(x, jnp.float32))))
    u = (rng.random(1 << 18) * 100).astype(np.float32)
    u[:4] = [0.0, 1e-40, 1.0, np.inf]
    np.testing.assert_array_equal(
        prng.log_f32(torch.from_numpy(u)).numpy(),
        np.asarray(jnp.log(jnp.asarray(u, jnp.float32))))
    w = (rng.random(1 << 18) * 2 - 0.9).astype(np.float32)
    np.testing.assert_array_equal(
        prng.log1p_f32(torch.from_numpy(w)).numpy(),
        np.asarray(jnp.log1p(jnp.asarray(w, jnp.float32))))
