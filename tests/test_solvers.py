"""Solver-step invariants (reference parity: `model/solvers.py`)."""

import jax
import jax.numpy as jnp
import numpy as np

from multimodal_flows.data.state import MultiModal
from multimodal_flows.dynamics.bridges import RandomTelegraphBridge
from multimodal_flows.dynamics import solvers

V = 9


def _toy_state(B=16, D=6, seed=0):
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    return MultiModal(
        time=jnp.full((B,), 0.5),
        continuous=jax.random.normal(k1, (B, D, 3)),
        discrete=jax.random.randint(k2, (B, D, 1), 0, V, dtype=jnp.int32),
        mask=jnp.ones((B, D, 1), jnp.int32),
    )


def test_poisson_tauleap_token_range():
    state = _toy_state()
    rates = jnp.ones((16, 6, V)) * 2.0
    u = jax.random.uniform(jax.random.PRNGKey(1), (16, 6))
    k_new = solvers._poisson_tauleap_tokens(
        u, state.discrete[..., 0], rates, jnp.asarray(0.1), V)
    arr = np.asarray(k_new)
    assert arr.min() >= 0 and arr.max() < V


def test_bernoulli_tauleap_token_range():
    state = _toy_state()
    rates = jnp.ones((16, 6, V)) * 2.0
    k_new = solvers._bernoulli_tauleap_tokens(
        jax.random.PRNGKey(1), state.discrete[..., 0], rates, jnp.asarray(0.1), V)
    arr = np.asarray(k_new)
    assert arr.min() >= 0 and arr.max() < V


def test_tauleap_zero_rates_no_jump():
    """With zero off-diagonal intensity nothing moves."""
    state = _toy_state()
    k = state.discrete[..., 0]
    rates = jnp.zeros((16, 6, V))
    u = jax.random.uniform(jax.random.PRNGKey(2), k.shape)
    k_new = solvers._poisson_tauleap_tokens(u, k, rates, jnp.asarray(0.1), V)
    np.testing.assert_array_equal(np.asarray(k_new), np.asarray(k))


def test_euler_transition_stays_with_tiny_dt():
    state = _toy_state()
    k = state.discrete[..., 0]
    rates = jnp.ones((16, 6, V))
    k_new = solvers._euler_transition_tokens(
        jax.random.PRNGKey(3), k, rates, jnp.asarray(1e-9), None, None, V)
    np.testing.assert_array_equal(np.asarray(k_new), np.asarray(k))


def test_jump_or_stay_single_jump_semantics():
    state = _toy_state()
    k = state.discrete[..., 0]
    # huge rate -> always jump; peaked probs -> jump to state 3 (unless already there)
    rates = jnp.full((16, 6, V), 1e6)
    probs = jnp.zeros((16, 6, V)).at[..., 3].set(0.9).at[..., 4].set(0.1)
    k_new = solvers._jump_or_stay_tokens(jax.random.PRNGKey(4), k, rates, probs,
                                         jnp.asarray(0.1), V)
    arr = np.asarray(k_new)
    was3 = np.asarray(k) == 3
    assert np.all(arr[~was3] != np.asarray(k)[~was3])  # everything jumped
    assert set(np.unique(arr)) <= {3, 4}


def test_filtered_probs_temperature():
    logits = jnp.array([[1.0, 2.0, 3.0]])
    p_hot = solvers._filtered_probs(logits, 0.5, None, None)
    p_cold = solvers._filtered_probs(logits, 2.0, None, None)
    # lower temperature -> sharper
    assert float(p_hot.max()) > float(p_cold.max())
    np.testing.assert_allclose(float(p_hot.sum()), 1.0, rtol=1e-6)


def test_simulate_trajectory_shapes():
    """Trajectory return stacks the full path (for the tutorial plots)."""
    state = _toy_state(B=4, D=2)
    bridge = RandomTelegraphBridge(0.075, V)

    def apply_fn(s):
        return -s.continuous, jnp.zeros(s.discrete.shape[:2] + (V,))

    solver = solvers.HybridSolver(apply_fn, bridge, V)
    final, traj = solvers.simulate(jax.random.PRNGKey(5), solver, state, 7, 1e-5,
                                   return_trajectory=True)
    assert traj.continuous.shape == (7, 4, 2, 3)
    assert traj.discrete.shape == (7, 4, 2, 1)
    np.testing.assert_allclose(np.asarray(traj.continuous[-1]),
                               np.asarray(final.continuous))


def test_simulate_use_final_max_rates():
    state = _toy_state(B=4, D=2)
    bridge = RandomTelegraphBridge(0.075, V)
    logits = jnp.zeros((4, 2, V)).at[..., 6].set(10.0)

    def apply_fn(s):
        return jnp.zeros_like(s.continuous), logits

    solver = solvers.HybridSolver(apply_fn, bridge, V)
    final = solvers.simulate(jax.random.PRNGKey(6), solver, state, 5, 1e-5,
                             use_final_max_rates=True)
    # rate is maximized at the model's peaked state
    assert np.all(np.asarray(final.discrete)[..., 0] == 6)


def test_censored_poisson_matches_full_poisson_statistics():
    """The censored draw must reproduce the joint law of
    (jump_mask, net_jumps) that a full Poisson draw induces."""
    key = jax.random.PRNGKey(0)
    lam = jnp.asarray(np.random.default_rng(0).uniform(0.0, 1.5, size=(200, 50, V)),
                      jnp.float32)
    k = jnp.zeros((200, 50), jnp.int32)
    diff = jnp.arange(V, dtype=jnp.int32)[None, None, :] - k[:, :, None]

    def stats(delta_n):
        jm = (delta_n.sum(-1) <= 1)
        nj = (delta_n * diff).sum(-1)
        return np.asarray(jm).mean(), np.asarray(jnp.where(jm, nj, 0)).mean(), \
            np.asarray(jnp.where(jm, nj, 0)).std()

    full = stats(jax.random.poisson(key, lam, dtype=jnp.int32))
    cens = stats(solvers._censored_poisson(key, lam))
    assert abs(full[0] - cens[0]) < 0.01
    assert abs(full[1] - cens[1]) < 0.05
    assert abs(full[2] - cens[2]) < 0.05


def test_per_class_temperature():
    """Per-class temperature vector (reference `_temperature_scaling`,
    `solvers.py:95-99`, with the intended (1,1,S) broadcast): logits
    divided by T*freqs elementwise over classes."""
    logits = jnp.asarray(np.random.default_rng(0).normal(size=(2, 3, 9)),
                         jnp.float32)
    freqs = solvers.REFERENCE_CLASS_FREQS
    out = solvers._per_class_temperature(logits, 0.8, freqs)
    expected = np.asarray(logits) / (0.8 * np.asarray(freqs)[None, None] + 1e-8)
    np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-6)


def test_hybrid_euler_class_freqs_changes_distribution():
    """The hybrid euler path honors class_freqs; tauleap ignores it
    (reference applies `_temperature_scaling` only in euler_step)."""
    B, D, S = 64, 8, 9
    key = jax.random.PRNGKey(0)
    state = MultiModal(
        time=jnp.full((B,), 0.5),
        continuous=jnp.zeros((B, D, 3)),
        discrete=jnp.ones((B, D, 1), jnp.int32),
        mask=jnp.ones((B, D, 1), jnp.int32))
    logits = jax.random.normal(jax.random.PRNGKey(1), (B, D, S)) * 3.0
    apply_fn = lambda s: (jnp.zeros((B, D, 3)), logits)
    bridge = RandomTelegraphBridge(0.5, S)

    def run(method, class_freqs, temperature=0.5):
        sol = solvers.HybridSolver(apply_fn, bridge, S, temperature=temperature,
                                   method=method, class_freqs=class_freqs)
        out, _ = sol.fwd_step(key, state, jnp.float32(0.5))
        return np.asarray(out.discrete)

    heavy = (0.01,) * 5 + (100.0,) * 4  # extreme per-class temps
    a = run("euler", None)
    b = run("euler", heavy)
    assert (a != b).any(), "class_freqs had no effect on the euler path"
    t1 = run("tauleap", None)
    t2 = run("tauleap", heavy)
    np.testing.assert_array_equal(t1, t2)  # tauleap: scalar T only


def test_single_uniform_tauleap_matches_full_poisson_law():
    """The single-uniform gated tau-leap must reproduce the per-site token
    distribution of the reference's full S-Poisson draw with the
    at-most-one-jump gate (proof in _poisson_tauleap_tokens docstring)."""
    B, D = 400, 50
    rng = np.random.default_rng(1)
    rates = jnp.asarray(rng.uniform(0.1, 3.0, size=(1, 1, V)).repeat(D, 1).repeat(B, 0),
                        jnp.float32)
    dt = jnp.float32(0.25)
    k0 = jnp.full((B, D), 4, jnp.int32)

    # reference construction: full Poisson, gate, net-jump shift mod S
    delta_n = jax.random.poisson(jax.random.PRNGKey(2), rates * dt, dtype=jnp.int32)
    jm = (delta_n.sum(-1) <= 1).astype(jnp.int32)
    diff = jnp.arange(V, dtype=jnp.int32)[None, None, :] - k0[:, :, None]
    k_ref = (k0 + (delta_n * diff).sum(-1) * jm) % V

    u = jax.random.uniform(jax.random.PRNGKey(3), k0.shape)
    k_new = solvers._poisson_tauleap_tokens(u, k0, rates, dt, V)

    f_ref = np.bincount(np.asarray(k_ref).ravel(), minlength=V) / (B * D)
    f_new = np.bincount(np.asarray(k_new).ravel(), minlength=V) / (B * D)
    np.testing.assert_allclose(f_new, f_ref, atol=0.01)


def test_simulate_unroll_is_semantics_free():
    """`unroll` amortizes scan bookkeeping only: the trajectory (same RNG
    stream, same math) must be identical for any factor, including one
    that does not divide num_timesteps."""
    state = _toy_state(B=8, D=4)
    bridge = RandomTelegraphBridge(0.075, V)

    def apply_fn(s):
        return -0.3 * s.continuous, s.continuous.sum(-1, keepdims=True) * jnp.ones(
            s.discrete.shape[:2] + (V,))

    solver = solvers.HybridSolver(apply_fn, bridge, V)
    outs = [solvers.simulate(jax.random.PRNGKey(9), solver, state, 10, 1e-5,
                             unroll=u) for u in (1, 2, 3)]
    for other in outs[1:]:
        np.testing.assert_array_equal(np.asarray(outs[0].discrete),
                                      np.asarray(other.discrete))
        np.testing.assert_allclose(np.asarray(outs[0].continuous),
                                   np.asarray(other.continuous), rtol=1e-6)


def test_set_scan_unroll_default_flows_through():
    solvers.set_scan_unroll(4)
    try:
        assert solvers.scan_unroll() == 4
        state = _toy_state(B=4, D=2)
        bridge = RandomTelegraphBridge(0.075, V)
        solver = solvers.HybridSolver(
            lambda s: (jnp.zeros_like(s.continuous),
                       jnp.zeros(s.discrete.shape[:2] + (V,))), bridge, V)
        ref = solvers.simulate(jax.random.PRNGKey(2), solver, state, 6, 1e-5,
                               unroll=1)
        via_default = solvers.simulate(jax.random.PRNGKey(2), solver, state, 6,
                                       1e-5)
        np.testing.assert_array_equal(np.asarray(ref.discrete),
                                      np.asarray(via_default.discrete))
    finally:
        solvers.set_scan_unroll(1)
