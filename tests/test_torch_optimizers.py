"""Port parity for the update rules: every rule of
``shifu_tpu.train.optimizers._RULES`` and ``mixed_apply`` against
``shifu_tpu_torch.train.optimizers`` on one model and on members stacked
on a leading axis, for one update and for five updates from equal
gradients.

Sign rules (``R`` RPROP, ``M`` manhattan) must agree exactly: their deltas
are steps chosen by the signs of the gradients, and the gradients here
are drawn clear of 0.  The others agree within rtol 1e-6 (the same f32
formulas; ``pow`` and ``sqrt`` may differ in the last bit).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shifu_tpu.train import optimizers as jopt
from shifu_tpu_torch.train import optimizers as popt

pytestmark = pytest.mark.torch_port

SIGN_RULES = ("R", "M")
SHAPES = ((6, 4), (4, 1))


def _tree(rng, lead=()):
    """Params/gradients as the reference's list of {"w", "b"} layers,
    values clear of 0 (|v| in [0.05, 1.05)) with random signs."""
    def arr(shape):
        v = rng.random(lead + shape) + 0.05
        return (v * rng.choice([-1.0, 1.0], lead + shape)).astype(np.float32)
    return [{"w": arr(s), "b": arr(s[1:])} for s in SHAPES]


def _to_jax(t):
    return [{k: jnp.asarray(v) for k, v in l.items()} for l in t]


def _to_torch(t):
    return [{k: torch.from_numpy(v.copy()) for k, v in l.items()} for l in t]


def _check(got, want, exact):
    for a, b in zip(want, got):
        for k in ("w", "b"):
            if exact:
                assert np.array_equal(b[k].numpy(), np.asarray(a[k]))
            else:
                np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]),
                                           rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("stacked", [False, True], ids=["one", "stacked"])
@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("rule", sorted(jopt._RULES))
def test_rule_matches_reference(rule, steps, stacked):
    rng = np.random.default_rng(3)
    lead = (3,) if stacked else ()
    params = _tree(rng, lead)
    grads = [_tree(rng, lead) for _ in range(steps)]
    jo = jopt.make_optimizer(rule, 0.05)
    po = popt.make_optimizer(rule, 0.05)
    jp, pp = _to_jax(params), _to_torch(params)
    if stacked:
        # the reference inits each member and stacks (its vmap layout)
        states = [jo.init([{k: v[i] for k, v in l.items()} for l in jp])
                  for i in range(3)]
        js = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)
        update = jax.vmap(jo.update)
    else:
        js, update = jo.init(jp), jo.update
    ps = po.init(pp, 3 if stacked else None)
    for g in grads:
        jd, js = update(_to_jax(g), js, jp)
        pd, ps = po.update(_to_torch(g), ps, pp)
        _check(pd, jd, rule in SIGN_RULES)
        jp = jax.tree_util.tree_map(lambda p, d: p + d, jp, jd)
        pp = popt.tree_map(lambda p, d: p + d, pp, pd)
    _check(pp, jp, rule in SIGN_RULES)


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("rule", ["ADAM", "R"])
def test_mixed_apply_matches_reference(rule, steps):
    rng = np.random.default_rng(4)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(steps)]
    jo = jopt.make_optimizer(rule, 0.05)
    po = popt.make_optimizer(rule, 0.05)
    jp = jopt.cast_tree(_to_jax(params), jnp.bfloat16)
    pp = popt.cast_tree(_to_torch(params), torch.bfloat16)
    js, ps = jopt.mixed_init(jo, jp), popt.mixed_init(po, pp)

    def freeze(d):                       # the trainer's fixed layer 1
        return [{"w": d[0]["w"] * 0, "b": d[0]["b"]}] + d[1:]
    for g in grads:
        jp, js = jopt.mixed_apply(
            jo, jopt.cast_tree(_to_jax(g), jnp.bfloat16), js, scale=0.5,
            freeze=freeze)
        pp, ps = popt.mixed_apply(
            po, popt.cast_tree(_to_torch(g), torch.bfloat16), ps, scale=0.5,
            freeze=freeze)
        assert all(l[k].dtype == torch.bfloat16 for l in pp for k in l)
        _check(ps["master"], js["master"], rule in SIGN_RULES)
        for a, b in zip(jp, pp):
            for k in ("w", "b"):
                want = np.asarray(a[k].astype(jnp.float32))
                got = b[k].float().numpy()
                if rule in SIGN_RULES:
                    assert np.array_equal(got, want)
                else:
                    # one bf16 rounding of masters within 1e-6 of each
                    # other: equal, or one bf16 ulp apart at a tie
                    np.testing.assert_allclose(got, want, rtol=2 ** -7)


def test_rprop_does_not_move_on_a_sign_flip():
    po = popt.make_optimizer("R")
    p = [{"w": torch.ones(2, 2), "b": torch.ones(2)}]
    s = po.init(p)
    g1 = [{"w": torch.tensor([[1.0, -1.0], [2.0, 3.0]]),
           "b": torch.tensor([1.0, 1.0])}]
    _, s = po.update(g1, s, p)
    g2 = [{"w": torch.tensor([[-1.0, -1.0], [2.0, -3.0]]),
           "b": torch.tensor([1.0, -1.0])}]
    d, s = po.update(g2, s, p)
    flips = torch.tensor([[True, False], [False, True]])
    assert bool((d[0]["w"][flips] == 0).all())
    assert bool((s["prev_g"][0]["w"][flips] == 0).all())
    assert bool((d[0]["w"][~flips] != 0).all())


def test_precision_ladder_resolves_like_the_reference():
    from shifu_tpu_torch.config import environment
    environment.reset_for_tests()
    assert popt.resolve_precision("") == jopt.resolve_precision("") == "f32"
    assert popt.resolve_precision("MIXED") == "mixed"
    assert popt.compute_dtype("bf16") == torch.bfloat16
    with pytest.raises(ValueError, match="precision"):
        popt.resolve_precision("fp8")
