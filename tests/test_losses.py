"""Loss math invariants (reference parity: `model/MMF.py:138-233`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_flows.train.losses import MultiTaskLoss, masked_ce, masked_mse


def test_masked_mse_ignores_pads():
    B, D, F = 2, 4, 3
    mask = jnp.array([[1, 1, 0, 0], [1, 1, 1, 0]])[..., None].astype(jnp.float32)
    pred = jnp.zeros((B, D, F))
    target = jnp.ones((B, D, F))
    # polluting pad predictions must not change the loss
    pred_dirty = pred.at[:, 3, :].set(100.0)
    l1 = masked_mse(pred, target, mask)
    l2 = masked_mse(pred_dirty, target, mask)
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l2))
    # per-jet normalization: sum of F errors per particle / n_particles
    np.testing.assert_allclose(np.asarray(l1), [3.0, 3.0])


def test_masked_ce_ignores_pads():
    B, D, V = 2, 3, 5
    mask = jnp.array([[1, 1, 0], [1, 0, 0]])[..., None].astype(jnp.float32)
    targets = jnp.array([[1, 2, 0], [3, 0, 0]])[..., None]
    logits = jnp.zeros((B, D, V))
    l = masked_ce(logits, targets, mask)
    # uniform logits -> log(V) per real particle, / n_real
    np.testing.assert_allclose(np.asarray(l), [np.log(V), np.log(V) / 1.0], rtol=1e-5)

    # pad-position logits don't matter
    logits_dirty = logits.at[:, 2, :].set(50.0)
    np.testing.assert_allclose(np.asarray(masked_ce(logits_dirty, targets, mask)),
                               np.asarray(l), rtol=1e-6)


@pytest.mark.parametrize("mode", ["sum", "weighted", "time-weighted"])
def test_multitask_modes(mode):
    mt = MultiTaskLoss(mode, n_embd=16)
    l1 = jnp.array([1.0, 2.0])
    l2 = jnp.array([3.0, 4.0])
    t = jnp.array([0.3, 0.7])
    params = mt.init(jax.random.PRNGKey(0), l1, l2, t)
    loss, m1, m2, w1, w2 = mt.apply(params, l1, l2, t)
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(m1), 1.5)
    np.testing.assert_allclose(float(m2), 3.5)
    if mode == "sum":
        np.testing.assert_allclose(float(loss), 5.0)
        assert not jax.tree.leaves(params)  # no parameters
    else:
        # near-zero-init uncertainties -> starts ~balanced:
        # 0.5*(u1 + e^-u1*l1) + 0.5*(u2 + e^-u2*l2) ~ (l1+l2)/2
        # ('time-weighted' zero-inits only the output bias, so u is small
        # but not exactly 0 — same as the reference `MMF.py:214`)
        np.testing.assert_allclose(float(loss), 2.5, atol=0.05)
        np.testing.assert_allclose(float(w1), 1.0, atol=0.05)


def test_time_weighted_params_are_trainable():
    mt = MultiTaskLoss("time-weighted", n_embd=16)
    l1, l2, t = jnp.ones(4), jnp.ones(4), jnp.linspace(0.1, 0.9, 4)
    params = mt.init(jax.random.PRNGKey(0), l1, l2, t)

    def loss_of(p):
        return mt.apply(p, l1, l2, t)[0]

    g = jax.grad(loss_of)(params)
    gnorm = sum(float(jnp.abs(x).sum()) for x in jax.tree.leaves(g))
    assert gnorm > 0  # uncertainty MLP receives gradient
