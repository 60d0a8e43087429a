"""Generative bridges as pure functions (explicit PRNG keys, fp32 math).

Re-design of the reference dynamics layer:
- `UniformFlow`  — linear-interpolant conditional flow-matching bridge for
  continuous features (reference `model/CFM.py:157-204`).
- `RandomTelegraphBridge` — multivariate random-telegraph continuous-time
  Markov jump bridge for discrete tokens (reference `model/MJB.py:149-272`).

Unlike the reference (which mutates the batch and draws the source lazily on
CPU), these are stateless: sources are drawn on-device inside the jitted loss
via `draw_source_*`, and every sample takes an explicit key.  Bridge math is
kept in float32 regardless of the network compute dtype — the telegraph
posterior divides by p(k1|k0) and the rate divides by (1 - w_t), both of
which lose precision in bf16 near the time endpoints.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from multimodal_flows.dynamics.thermostats import ConstantThermostat, Thermostat

Array = jax.Array


def _bcast_time(t: Array, ndim: int) -> Array:
    """Right-pad time with singleton dims: (B,) -> (B, 1, ..., 1);
    per-token (B, D) -> (B, D, 1, ...).  Packed multi-jet training rows
    carry per-token time (each jet draws its own t), so bridge math must
    broadcast either shape."""
    return t.reshape(t.shape + (1,) * (ndim - t.ndim))


class UniformFlow:
    """Conditional OT flow matching: linear interpolation between endpoints.

    xt = t * x1 + (1 - t) * x0 + sigma * z      (reference `CFM.py:171-185`)
    conditional drift target: x1 - x0           (reference `CFM.py:187-194`)
    """

    def __init__(self, sigma: float):
        self.sigma = float(sigma)

    def draw_source(self, key: Array, x1: Array, mask: Array) -> Array:
        """Masked standard-normal source (reference `CFM.py:175-177`)."""
        x0 = jax.random.normal(key, x1.shape, dtype=jnp.float32)
        return x0 * mask

    def sample(self, key: Array, t: Array, x0: Array, x1: Array) -> Array:
        """Interpolant state xt at time t (t: (B,))."""
        tb = _bcast_time(t.astype(jnp.float32), x1.ndim)
        xt = tb * x1 + (1.0 - tb) * x0
        z = jax.random.normal(key, xt.shape, dtype=xt.dtype)
        return xt + self.sigma * z

    def conditional_drift(self, xt: Array, x0: Array, x1: Array) -> Array:
        """u_t(x | x0, x1) = x1 - x0 (A=0, B=1, C=-1 in the reference)."""
        return x1 - x0

    def diffusion(self, xt: Array) -> float:
        return 0.0


class RandomTelegraphBridge:
    """Multivariate random-telegraph bridge over a vocabulary of size S.

    Conditional: P(x_t = i | x_{t0}) = 1/S + w_{t0,t}(delta_{i,x_{t0}} - 1/S)
    with w_{t0,t1} = exp(-S beta \\int_{t0}^{t1} beta(r) dr)
    (reference `MJB.py:237-257`).
    """

    def __init__(
        self,
        beta: float,
        vocab_size: int,
        thermostat: Optional[Thermostat] = None,
        top_k: Optional[int] = None,
    ):
        self.beta = float(beta)
        self.vocab_size = int(vocab_size)
        self.thermostat = thermostat or ConstantThermostat(beta, vocab_size)
        self.top_k = top_k

    # ------------------------------------------------------------ source

    def draw_source(self, key: Array, shape: Tuple[int, ...], mask: Array) -> Array:
        """Uniform random tokens in {1..S-1}, masked (reference `MJB.py:201-203`)."""
        k0 = jax.random.randint(key, shape, 1, self.vocab_size, dtype=jnp.int32)
        return k0 * mask.astype(jnp.int32)

    # ------------------------------------------------------ probabilities

    def conditional_probability(self, t_in, t_out, k_in: Array, k_out: Array) -> Array:
        """P(x(t_out) = k_out | x(t_in) = k_in); times broadcast over batch
        — scalar, per-jet (B,), or per-token (B, D) for packed training
        rows (reference `MJB.py:237-257`)."""
        t_in = jnp.asarray(t_in, jnp.float32)
        t_out = jnp.asarray(t_out, jnp.float32)
        wt = self.thermostat.w_ts(t_in, t_out)  # broadcast(t_in, t_out) shape
        kron = (k_out == k_in).astype(jnp.float32)
        wt = _bcast_time(wt, kron.ndim)
        return 1.0 / self.vocab_size + wt * (kron - 1.0 / self.vocab_size)

    def transition_probability(self, t: Array, k0: Array, k1: Array) -> Array:
        """Posterior P(x_t = k | x0 = k0, x1 = k1) over all k (B, D, S)
        via Bayes (reference `MJB.py:217-235`)."""
        B, D = k0.shape[0], k0.shape[1]
        k_grid = jnp.arange(self.vocab_size, dtype=jnp.int32)[None, None, :]  # (1,1,S)
        k_grid = jnp.broadcast_to(k_grid, (B, D, self.vocab_size))

        k0b = k0.reshape(B, D, 1)
        k1b = k1.reshape(B, D, 1)

        p_k_to_k1 = self.conditional_probability(t, 1.0, k_grid, k1b)   # (B,D,S)
        p_k0_to_k = self.conditional_probability(0.0, t, k0b, k_grid)   # (B,D,S)
        p_k0_to_k1 = self.conditional_probability(0.0, 1.0, k0b, k1b)   # (B,D,1)

        return (p_k_to_k1 * p_k0_to_k) / p_k0_to_k1

    def sample(self, key: Array, t: Array, k0: Array, k1: Array) -> Array:
        """Draw k_t ~ posterior; returns (B, D, 1) int32 (reference
        `MJB.py:197-215`)."""
        probs = self.transition_probability(t, k0, k1)
        if self.top_k is not None:
            probs = top_k_filter(probs, self.top_k)
        logits = jnp.log(jnp.clip(probs, 1e-30, None))
        kt = jax.random.categorical(key, logits, axis=-1)  # (B, D)
        return kt.astype(jnp.int32)[..., None]

    # ---------------------------------------------------------------- rate

    def rate(self, t: Array, k: Array, probs: Array) -> Array:
        """Model-guided jump rate at sampling time (reference `MJB.py:163-195`):

        rate = 1 + (w_t S / (1 - w_t)) * q_x + w_t * q_y

        t: (B,), k: (B, D) or (B, D, 1) current tokens,
        probs: (B, D, S) model posterior q_x.  Diverges as t -> 1; callers
        use a time grid ending at 1 - time_eps (reference `MMF.py:183`).
        """
        if k.ndim == 3:
            k = k[..., 0]
        qx = probs
        # probability of the current token: one-hot dot instead of
        # take_along_axis — the masked sum fuses into the surrounding
        # elementwise ops instead of a gather along the minor-most axis
        onehot = jax.nn.one_hot(k, self.vocab_size, dtype=qx.dtype)
        qy = (qx * onehot).sum(axis=-1, keepdims=True)               # (B,D,1)

        wt = self.thermostat.w_ts(t.astype(jnp.float32), 1.0)  # (B,)
        A = 1.0
        Bc = (wt * self.vocab_size) / (1.0 - wt)
        C = wt
        return A + Bc[:, None, None] * qx + C[:, None, None] * qy


def top_k_filter(probs: Array, k: int) -> Array:
    """Keep the top-k entries of a prob tensor along the last axis and
    renormalize (reference `MJB.py:259-264`, `solvers.py:101-109`)."""
    V = probs.shape[-1]
    if k >= V:
        return probs
    thresh = jax.lax.top_k(probs, k)[0][..., -1:]
    kept = jnp.where(probs >= thresh, probs, 0.0)
    return kept / (kept.sum(axis=-1, keepdims=True) + 1e-8)


def top_p_filter(probs: Array, p: float) -> Array:
    """Nucleus filtering on probs (reference `solvers.py:111-119`): keep the
    smallest prefix of descending-sorted probs with cumulative mass <= p
    (always keeping the argmax), zero the rest, renormalize."""
    sorted_probs = jnp.sort(probs, axis=-1)[..., ::-1]
    cum = jnp.cumsum(sorted_probs, axis=-1)
    keep_sorted = cum <= p
    keep_sorted = keep_sorted.at[..., 0].set(True)
    # threshold: smallest kept prob value
    num_keep = keep_sorted.sum(axis=-1, keepdims=True)
    thresh = jnp.take_along_axis(sorted_probs, num_keep - 1, axis=-1)
    kept = jnp.where(probs >= thresh, probs, 0.0)
    return kept / (kept.sum(axis=-1, keepdims=True) + 1e-8)
