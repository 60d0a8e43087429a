"""Analytic-property tests for the bridge math (reference parity targets:
`model/CFM.py:157-204`, `model/MJB.py:149-272`, `utils/thermostats.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_flows.dynamics.bridges import (
    RandomTelegraphBridge,
    UniformFlow,
    top_k_filter,
    top_p_filter,
)
from multimodal_flows.dynamics.thermostats import (
    ConstantThermostat,
    LinearThermostat,
    THERMOSTAT_REGISTRY,
)

V = 9
BETA = 0.075


def test_thermostat_wts_bounds():
    th = ConstantThermostat(BETA, V)
    t = jnp.linspace(0.0, 1.0, 11)
    w = th.w_ts(t, 1.0)
    assert np.all(np.asarray(w) > 0) and np.all(np.asarray(w) <= 1.0)
    # at t=1 integral is 0 -> w=1
    np.testing.assert_allclose(float(th.w_ts(1.0, 1.0)), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(th.w_ts(0.0, 1.0)), np.exp(-V * BETA), rtol=1e-6)


def test_thermostat_registry():
    for name, cls in THERMOSTAT_REGISTRY.items():
        th = cls(BETA, V)
        w = float(th.w_ts(0.5, 0.9))
        assert np.isfinite(w)
    lin = LinearThermostat(BETA, V)
    np.testing.assert_allclose(float(lin.w_ts(0.0, 1.0)), np.exp(-V * BETA * 0.5), rtol=1e-6)


def test_uniform_flow_endpoints():
    key = jax.random.PRNGKey(0)
    flow = UniformFlow(sigma=0.0)
    B, D, F = 8, 5, 3
    k1, k2, k3 = jax.random.split(key, 3)
    x0 = jax.random.normal(k1, (B, D, F))
    x1 = jax.random.normal(k2, (B, D, F))

    xt0 = flow.sample(k3, jnp.zeros(B), x0, x1)
    np.testing.assert_allclose(np.asarray(xt0), np.asarray(x0), atol=1e-6)
    xt1 = flow.sample(k3, jnp.ones(B), x0, x1)
    np.testing.assert_allclose(np.asarray(xt1), np.asarray(x1), atol=1e-6)

    # midpoint
    xt = flow.sample(k3, jnp.full(B, 0.5), x0, x1)
    np.testing.assert_allclose(np.asarray(xt), np.asarray(0.5 * (x0 + x1)), atol=1e-6)

    # drift target
    drift = flow.conditional_drift(xt, x0, x1)
    np.testing.assert_allclose(np.asarray(drift), np.asarray(x1 - x0), atol=1e-6)


def test_uniform_flow_sigma_smear():
    flow = UniformFlow(sigma=1.0)
    key = jax.random.PRNGKey(1)
    x0 = jnp.zeros((2048, 1, 1))
    x1 = jnp.zeros((2048, 1, 1))
    xt = flow.sample(key, jnp.full(2048, 0.5), x0, x1)
    assert abs(float(xt.std()) - 1.0) < 0.1


def test_masked_source_draws():
    key = jax.random.PRNGKey(2)
    mask = jnp.array([[1], [1], [0]])[None].repeat(4, axis=0)  # (4,3,1)
    flow = UniformFlow(0.0)
    x0 = flow.draw_source(key, jnp.zeros((4, 3, 2)), mask)
    assert np.all(np.asarray(x0)[:, 2, :] == 0)

    bridge = RandomTelegraphBridge(BETA, V)
    k0 = bridge.draw_source(key, (4, 3, 1), mask)
    assert np.all(np.asarray(k0)[:, 2, :] == 0)
    real = np.asarray(k0)[:, :2, :]
    assert real.min() >= 1 and real.max() <= V - 1


def test_conditional_probability_rows_normalize():
    bridge = RandomTelegraphBridge(BETA, V)
    B, D = 3, 4
    k_in = jnp.ones((B, D, 1), jnp.int32) * 2
    k_grid = jnp.broadcast_to(jnp.arange(V)[None, None, :], (B, D, V))
    p = bridge.conditional_probability(0.0, 0.7, k_in, k_grid)
    np.testing.assert_allclose(np.asarray(p.sum(-1)), 1.0, rtol=1e-5)
    assert np.all(np.asarray(p) >= 0)


def test_conditional_probability_kronecker_limit():
    """At t_out == t_in the conditional collapses to a delta."""
    bridge = RandomTelegraphBridge(BETA, V)
    k_in = jnp.full((2, 3, 1), 5, jnp.int32)
    k_grid = jnp.broadcast_to(jnp.arange(V)[None, None, :], (2, 3, V))
    p = bridge.conditional_probability(0.3, 0.3, k_in, k_grid)
    expected = np.eye(V)[5]
    np.testing.assert_allclose(np.asarray(p)[0, 0], expected, atol=1e-5)


def test_transition_probability_normalized_and_endpoints():
    bridge = RandomTelegraphBridge(BETA, V)
    key = jax.random.PRNGKey(3)
    B, D = 16, 6
    k0 = jax.random.randint(key, (B, D, 1), 1, V, dtype=jnp.int32)
    k1 = jax.random.randint(jax.random.fold_in(key, 1), (B, D, 1), 1, V, dtype=jnp.int32)

    for t in (0.1, 0.5, 0.9):
        p = bridge.transition_probability(jnp.full(B, t), k0, k1)
        np.testing.assert_allclose(np.asarray(p.sum(-1)), 1.0, rtol=1e-4)
        assert np.all(np.asarray(p) >= -1e-7)

    # near t=0 posterior concentrates on k0; near t=1 on k1
    p0 = bridge.transition_probability(jnp.full(B, 1e-6), k0, k1)
    np.testing.assert_array_equal(np.asarray(p0.argmax(-1)), np.asarray(k0[..., 0]))
    p1 = bridge.transition_probability(jnp.full(B, 1.0 - 1e-6), k0, k1)
    np.testing.assert_array_equal(np.asarray(p1.argmax(-1)), np.asarray(k1[..., 0]))


def test_bridge_sample_shape_and_range():
    bridge = RandomTelegraphBridge(BETA, V)
    key = jax.random.PRNGKey(4)
    B, D = 32, 8
    k0 = jax.random.randint(key, (B, D, 1), 1, V, dtype=jnp.int32)
    k1 = jax.random.randint(jax.random.fold_in(key, 7), (B, D, 1), 1, V, dtype=jnp.int32)
    kt = bridge.sample(key, jnp.full(B, 0.5), k0, k1)
    assert kt.shape == (B, D, 1)
    arr = np.asarray(kt)
    assert arr.min() >= 0 and arr.max() < V


def test_rate_positive_and_guided():
    """The rate is >= 1 everywhere and largest toward high-prob states."""
    bridge = RandomTelegraphBridge(BETA, V)
    B, D = 4, 5
    k = jnp.ones((B, D), jnp.int32)
    probs = jnp.full((B, D, V), 1.0 / V)
    t = jnp.full(B, 0.5)
    r = bridge.rate(t, k, probs)
    assert r.shape == (B, D, V)
    assert np.all(np.asarray(r) >= 1.0)

    # peaked probs -> rate peaks at the same state
    peaked = jnp.zeros((B, D, V)).at[..., 7].set(1.0)
    r2 = bridge.rate(t, k, peaked)
    assert np.all(np.asarray(r2.argmax(-1)) == 7)


def test_top_k_filter():
    probs = jnp.array([[0.1, 0.2, 0.3, 0.4]])
    out = np.asarray(top_k_filter(probs, 2))
    np.testing.assert_allclose(out[0], [0.0, 0.0, 0.3 / 0.7, 0.4 / 0.7], atol=1e-5)
    # k >= V is identity
    np.testing.assert_allclose(np.asarray(top_k_filter(probs, 4)), np.asarray(probs))


def test_top_p_filter():
    probs = jnp.array([[0.5, 0.3, 0.15, 0.05]])
    out = np.asarray(top_p_filter(probs, 0.8))
    np.testing.assert_allclose(out[0], [0.5 / 0.8, 0.3 / 0.8, 0.0, 0.0], atol=1e-4)
    # always keeps the argmax even for tiny p
    out2 = np.asarray(top_p_filter(probs, 0.01))
    np.testing.assert_allclose(out2[0], [1.0, 0.0, 0.0, 0.0], atol=1e-4)
