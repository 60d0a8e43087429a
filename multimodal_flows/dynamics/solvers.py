"""Sampling-time integrators, fused for `lax.scan`.

Re-design of the reference solvers (`model/solvers.py:7-274`).
The reference steps a Python loop on the host, paying per-step dispatch;
here each `simulate_*` compiles the full time loop into a single XLA
program — model forward, telegraph rates, Poisson tau-leaping and the Euler
ODE update all fuse on-device, and only the final state is transferred out.

All steps are pure: `(key, state, t, dt) -> state`.  The model is passed as
`apply_fn(state) -> heads` where heads is `(vt, logits)` for hybrid models,
`vt` for continuous-only, `logits` for discrete-only.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from multimodal_flows.data.state import MultiModal
from multimodal_flows.dynamics.bridges import (
    RandomTelegraphBridge,
    top_k_filter,
    top_p_filter,
)

Array = jax.Array


def _filtered_probs(logits: Array, temperature: float, top_k: Optional[int], top_p: Optional[float]) -> Array:
    """softmax(logits / T) with optional top-k / top-p filtering
    (reference `solvers.py:33-42`)."""
    logits = logits.astype(jnp.float32) / jnp.asarray(temperature, jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    if top_k is not None:
        probs = top_k_filter(probs, top_k)
    if top_p is not None:
        probs = top_p_filter(probs, top_p)
    return probs


#: reference per-class temperature frequencies (`model/solvers.py:95`):
#: photons/hadrons cooled (0.85), leptons heated (1.2)
REFERENCE_CLASS_FREQS = (0.85, 0.85, 0.85, 0.85, 0.85, 1.2, 1.2, 1.2, 1.2)


def _per_class_temperature(logits: Array, temperature, class_freqs) -> Array:
    """Per-class temperature vector: logits / (T * freqs + 1e-8)
    (reference `_temperature_scaling`, `model/solvers.py:95-99`).

    The reference reshapes the (1,1,S) temperature to (S,1,1) before the
    divide (`solvers.py:98`), which cannot broadcast against (B,D,S) logits
    — here the intended (1,1,S) per-class shape is used.
    """
    freqs = jnp.asarray(class_freqs, jnp.float32)[None, None, :]
    temp = jnp.asarray(temperature, jnp.float32) * freqs
    return logits.astype(jnp.float32) / (temp + 1e-8)


def _censored_poisson(key: Array, lam: Array) -> Array:
    """Sample min(Poisson(lam), 2) exactly via CDF inversion.

    P(N=0) = e^-lam, P(N=1) = lam e^-lam, P(N>=2) = rest — two comparisons
    against one uniform instead of `jax.random.poisson`'s rejection loops
    (which dominated the tau-leap step cost on an earlier accelerator).
    """
    u = jax.random.uniform(key, lam.shape, dtype=jnp.float32)
    p0 = jnp.exp(-lam)
    p01 = p0 * (1.0 + lam)
    return jnp.where(u < p0, 0, jnp.where(u < p01, 1, 2)).astype(jnp.int32)


def _poisson_tauleap_tokens(u: Array, k: Array, rates: Array, dt: Array, vocab_size: int) -> Array:
    """Poisson tau-leap with at-most-one-jump gating
    (reference `solvers.py:47-54`), via a single uniform per site.

    u: (B, D) uniforms in [0,1), k: (B, D) int tokens, rates: (B, D, S),
    dt scalar.  The caller supplies the uniforms so `simulate` can hoist
    the whole trajectory's randomness into ONE batched PRNG call before
    the scan (per-step threefry draws of ~B*D elements are fixed-overhead
    dominated).

    Distributionally exact optimization.  The reference draws S independent
    Poissons N_j ~ Poisson(r_j dt) per site and applies
    `k <- k + sum_j N_j (j - k)` gated on `sum_j N_j <= 1`.  Under that
    gate the only reachable outcomes are

        stay                    with prob  e^{-R dt} + P(sum N >= 2)
        move to class j         with prob  r_j dt e^{-R dt}      (j = k: stay)

    where R = sum_j r_j (independent Poissons: P(total 1, at class j) =
    r_j dt e^{-r_j dt} prod_{i!=j} e^{-r_i dt}).  So one uniform per site
    against the cumulative thresholds c_j = e^{-R dt} (1 + sum_{i<=j} r_i dt)
    reproduces the exact joint law while drawing S times fewer random bits
    than per-class sampling.
    """
    rdt = rates.astype(jnp.float32) * dt                                 # (B,D,S)
    total = rdt.sum(axis=-1, keepdims=True)                              # (B,D,1)
    base = jnp.exp(-total)                                               # P(N_tot = 0)
    cum = base * (1.0 + jnp.cumsum(rdt, axis=-1))                        # c_j
    u = u[..., None]                                                     # (B,D,1)
    # index of the segment u falls in: u < base -> stay; u in
    # (c_{j-1}, c_j] -> move to j; u > c_{S-1} (the >=2 tail) -> stay
    jumped = (u >= base) & (u < cum[..., -1:])
    dest = jnp.sum((u >= cum).astype(k.dtype), axis=-1)                  # (B,D)
    return jnp.where(jumped[..., 0], dest, k)


def _bernoulli_tauleap_tokens(key: Array, k: Array, rates: Array, dt: Array, vocab_size: int) -> Array:
    """Bernoulli tau-leap variant (reference `solvers.py:207-215`)."""
    prob_jump = jnp.clip(rates * dt, None, 1.0)
    delta_n = jax.random.bernoulli(key, prob_jump).astype(k.dtype)
    diff = jnp.arange(vocab_size, dtype=k.dtype)[None, None, :] - k[:, :, None]
    net_jumps = (delta_n * diff).sum(axis=-1)
    return (k + net_jumps) % vocab_size


def _euler_transition_tokens(key: Array, k: Array, rates: Array, dt: Array,
                             top_k: Optional[int], top_p: Optional[float],
                             vocab_size: int) -> Array:
    """One-step categorical transition matrix: off-diagonal rates*dt, diagonal
    carries the remaining mass (reference `solvers.py:62-91`)."""
    delta_p = jnp.clip(rates * dt, None, 1.0)                           # (B,D,S)
    onehot = jax.nn.one_hot(k, vocab_size, dtype=delta_p.dtype)
    delta_p = delta_p * (1.0 - onehot)                                  # zero diagonal
    diag = jnp.clip(1.0 - delta_p.sum(axis=-1, keepdims=True), 0.0, None)
    delta_p = delta_p + diag * onehot
    if top_k is not None:
        delta_p = top_k_filter(delta_p, top_k)
    if top_p is not None:
        delta_p = top_p_filter(delta_p, top_p)
    logits = jnp.log(jnp.clip(delta_p, 1e-30, None))
    return jax.random.categorical(key, logits, axis=-1)


def _jump_or_stay_tokens(key: Array, k: Array, rates: Array, probs: Array, dt: Array,
                         vocab_size: int) -> Array:
    """Bernoulli leave decision + categorical destination excluding the
    current class (reference `solvers.py:239-274`)."""
    key_leave, key_dest = jax.random.split(key)
    rate_leave = jnp.take_along_axis(rates, k[..., None], axis=-1)[..., 0]  # (B,D)
    p_leave = jnp.clip(rate_leave * dt, None, 1.0)
    jump = jax.random.bernoulli(key_leave, p_leave)                         # (B,D)

    onehot = jax.nn.one_hot(k, vocab_size, dtype=probs.dtype)
    dest_probs = probs * (1.0 - onehot)
    dest_probs = dest_probs / jnp.clip(dest_probs.sum(axis=-1, keepdims=True), 1e-8, None)
    dest = jax.random.categorical(key_dest, jnp.log(jnp.clip(dest_probs, 1e-30, None)), axis=-1)
    return jnp.where(jump, dest.astype(k.dtype), k)


# ---------------------------------------------------------------------------
# Hybrid solver (MMF): Euler ODE for continuous + tau-leap for discrete
# ---------------------------------------------------------------------------


class HybridSolver:
    """Joint continuous+discrete step (reference `solvers.py:7-119`)."""

    def __init__(self, apply_fn: Callable, bridge_discrete: RandomTelegraphBridge,
                 vocab_size: int, temperature: float = 1.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 method: str = "tauleap", class_freqs=None):
        self.apply_fn = apply_fn
        self.bridge = bridge_discrete
        self.vocab_size = int(vocab_size)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.method = method
        # per-class temperature vector, used by the euler path only (the
        # reference euler_step calls `_temperature_scaling`,
        # `model/solvers.py:68-69`, while tauleap_step divides by scalar T)
        self.class_freqs = class_freqs

    #: True when the step's only randomness is one uniform per (jet, site)
    #: — `simulate` then hoists the whole trajectory's draws into a single
    #: batched PRNG call before the scan
    @property
    def uses_single_uniform(self) -> bool:
        return self.method == "tauleap"

    def fwd_step(self, key: Array, state: MultiModal, dt: Array) -> Tuple[MultiModal, Array]:
        u = (jax.random.uniform(key, state.discrete.shape[:2], dtype=jnp.float32)
             if self.uses_single_uniform else None)
        return self.fwd_step_u(key, u, state, dt)

    def fwd_step_u(self, key: Optional[Array], u: Optional[Array],
                   state: MultiModal, dt: Array) -> Tuple[MultiModal, Array]:
        """Step with externally supplied uniforms `u` (tauleap) or a PRNG
        key (euler); exactly one of the two is consumed per method."""
        vt, logits = self.apply_fn(state)
        if self.method == "euler" and self.class_freqs is not None:
            logits = _per_class_temperature(logits, self.temperature, self.class_freqs)
            probs = _filtered_probs(logits, 1.0, self.top_k, self.top_p)
        else:
            probs = _filtered_probs(logits, self.temperature, self.top_k, self.top_p)
        k = state.discrete[..., 0]
        rates = self.bridge.rate(state.time, k, probs)                   # (B,D,S)

        if self.method == "tauleap":
            k_new = _poisson_tauleap_tokens(u, k, rates, dt, self.vocab_size)
        elif self.method == "euler":
            k_new = _euler_transition_tokens(key, k, rates, dt, self.top_k, self.top_p, self.vocab_size)
        else:
            raise ValueError(f"unknown hybrid method {self.method!r}")

        x_new = state.continuous + vt.astype(state.continuous.dtype) * dt
        new_state = state.replace(continuous=x_new, discrete=k_new[..., None])
        return new_state, rates


class ContinuousSolver:
    """Euler / Euler-Maruyama for pure CFM (reference `solvers.py:123-153`)."""

    def __init__(self, apply_fn: Callable, diffusion_fn: Optional[Callable] = None,
                 method: str = "euler"):
        self.apply_fn = apply_fn
        self.diffusion_fn = diffusion_fn
        self.method = method

    def fwd_step(self, key: Array, state: MultiModal, dt: Array) -> MultiModal:
        vt = self.apply_fn(state)
        if self.method == "euler":
            return state.replace(continuous=state.continuous + vt * dt)
        elif self.method == "euler_maruyama":
            diffusion = self.diffusion_fn(state) if self.diffusion_fn else 0.0
            dw = jax.random.normal(key, state.continuous.shape, state.continuous.dtype)
            return state.replace(continuous=state.continuous + vt * dt + diffusion * dw)
        raise ValueError(f"unknown continuous method {self.method!r}")


class DiscreteSolver:
    """Pure-MJB steps, selected by `markov_jump_solver`
    (reference `solvers.py:157-274`)."""

    def __init__(self, apply_fn: Callable, bridge_discrete: RandomTelegraphBridge,
                 vocab_size: int, temperature: float = 1.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 method: str = "tauleap-poisson"):
        self.apply_fn = apply_fn
        self.bridge = bridge_discrete
        self.vocab_size = int(vocab_size)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.method = method

    @property
    def uses_single_uniform(self) -> bool:
        return self.method == "tauleap-poisson"

    def fwd_step(self, key: Array, state: MultiModal, dt: Array) -> Tuple[MultiModal, Array]:
        u = (jax.random.uniform(key, state.discrete.shape[:2], dtype=jnp.float32)
             if self.uses_single_uniform else None)
        return self.fwd_step_u(key, u, state, dt)

    def fwd_step_u(self, key: Optional[Array], u: Optional[Array],
                   state: MultiModal, dt: Array) -> Tuple[MultiModal, Array]:
        logits = self.apply_fn(state)
        probs = _filtered_probs(logits, self.temperature, self.top_k, self.top_p)
        k = state.discrete[..., 0]
        rates = self.bridge.rate(state.time, k, probs)

        if self.method == "tauleap-poisson":
            k_new = _poisson_tauleap_tokens(u, k, rates, dt, self.vocab_size)
        elif self.method == "tauleap-bernouilli":  # reference spelling
            k_new = _bernoulli_tauleap_tokens(key, k, rates, dt, self.vocab_size)
        elif self.method == "euler":
            k_new = _euler_transition_tokens(key, k, rates, dt, self.top_k, self.top_p, self.vocab_size)
        elif self.method == "jump_or_stay":
            k_new = _jump_or_stay_tokens(key, k, rates, probs, dt, self.vocab_size)
        else:
            raise ValueError(f"unknown discrete method {self.method!r}")

        return state.replace(discrete=k_new[..., None]), rates


# ---------------------------------------------------------------------------
# Fused simulation loops (single lax.scan per trajectory)
# ---------------------------------------------------------------------------


#: process-wide default for `simulate`'s `lax.scan` unroll factor.  The
#: sampling drivers pick it up through `scan_unroll()` (and key their jit
#: caches on it).  Whether >1 pays at the flagship packed shape is
#: unmeasured on H100.
_SCAN_UNROLL = 1


def set_scan_unroll(n: int) -> None:
    global _SCAN_UNROLL
    _SCAN_UNROLL = max(1, int(n))


def scan_unroll() -> int:
    return _SCAN_UNROLL


def time_grid(time_eps: float, num_timesteps: int):
    """linspace(eps, 1-eps, steps) and the uniform dt
    (reference `MMF.py:181-184`)."""
    ts = jnp.linspace(time_eps, 1.0 - time_eps, num_timesteps, dtype=jnp.float32)
    dt = (ts[-1] - ts[0]) / (num_timesteps - 1)
    return ts, dt


def simulate(
    key: Array,
    solver,
    source: MultiModal,
    num_timesteps: int,
    time_eps: float,
    *,
    return_trajectory: bool = False,
    use_final_max_rates: bool = False,
    unroll: Optional[int] = None,
) -> MultiModal:
    """Roll a solver over the full time grid inside one `lax.scan`.

    Mirrors `simulate_dynamics` (reference `MMF.py:172-200`) but compiled:
    `num_timesteps` iterations of (model forward -> rates -> tau-leap +
    Euler).  For tau-leap solvers (whose only randomness is one uniform per
    site) the whole trajectory's draws are hoisted into ONE batched PRNG
    call before the scan — per-step threefry launches of ~B*D elements are
    fixed-overhead dominated, while one (steps, B, D) draw amortizes them.
    Other solver methods keep per-step key folding.

    `unroll` is passed to `lax.scan`: >1 replicates the step body so XLA
    amortizes per-iteration loop bookkeeping and can fuse across adjacent
    steps.  Semantics are unchanged (same math, same RNG stream); compile
    time grows with the body size.
    """
    ts, dt = time_grid(time_eps, num_timesteps)
    if unroll is None:
        unroll = _SCAN_UNROLL
    B = len(source)
    D = source.num_particles

    track_rates = use_final_max_rates
    if track_rates:
        init_rates = jnp.zeros((B, D, solver.vocab_size), dtype=jnp.float32)
    else:
        init_rates = None

    single_u = getattr(solver, "uses_single_uniform", False)
    if single_u:
        us = jax.random.uniform(key, (num_timesteps, B, D), dtype=jnp.float32)
        xs = (ts, us)

        def step(carry, x):
            state, _ = carry
            t, u = x
            state = state.replace(time=jnp.full((B,), t, dtype=jnp.float32))
            state, rates = solver.fwd_step_u(None, u, state, dt)
            last_rates = rates if track_rates else None
            y = state if return_trajectory else None
            return (state, last_rates), y

        (final_state, final_rates), traj = jax.lax.scan(
            step, (source, init_rates), xs, unroll=unroll
        )
    else:

        def step(carry, t):
            state, k, _ = carry
            k, sub = jax.random.split(k)
            state = state.replace(time=jnp.full((B,), t, dtype=jnp.float32))
            out = solver.fwd_step(sub, state, dt)
            if isinstance(out, tuple):
                state, rates = out
            else:
                state, rates = out, None
            last_rates = rates if track_rates else None
            y = state if return_trajectory else None
            return (state, k, last_rates), y

        (final_state, _, final_rates), traj = jax.lax.scan(
            step, (source, key, init_rates), ts, unroll=unroll
        )

    if track_rates:
        # argmax override of final tokens (reference `MMF.py:193-196`)
        max_rate = jnp.argmax(final_rates, axis=2).astype(jnp.int32)
        final_state = final_state.replace(discrete=max_rate[..., None])

    if return_trajectory:
        return final_state, traj
    return final_state
