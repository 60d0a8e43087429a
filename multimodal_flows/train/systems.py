"""Trainable systems: MMF (flagship), CFM, MJB.

Functional re-design of the reference Lightning modules
(`model/MMF.py:20-200`, `model/CFM.py:13-154`, `model/MJB.py:14-146`):
each system owns a module (encoder + any loss-time parameters), pure
bridges, and three pure functions —

  loss_fn(params, coupling, key, train)  -> (loss, metrics)
  forward(params, state)                 -> heads
  simulate(params, key, source, ...)     -> generated state

The intermediate bridge states (x_t, k_t) are constructed **on-device
inside the jitted loss** (the reference builds them on CPU and transfers,
`MMF.py:149-151`); the sampling loop is one `lax.scan` (see
`dynamics/solvers.py`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from multimodal_flows import nn

from multimodal_flows.config import Config
from multimodal_flows.data.packing import PackedJets
from multimodal_flows.data.state import DataCoupling, MultiModal
from multimodal_flows.dynamics.bridges import RandomTelegraphBridge, UniformFlow
from multimodal_flows.dynamics.solvers import (
    ContinuousSolver,
    DiscreteSolver,
    HybridSolver,
    simulate,
)
from multimodal_flows.dynamics.thermostats import ConstantThermostat
from multimodal_flows.models.registry import build_model
from multimodal_flows.train.losses import (
    MultiTaskLoss,
    masked_ce,
    masked_mse,
    packed_masked_ce,
    packed_masked_mse,
)

Array = jax.Array


def _sample_time(key: Array, shape, eps: float) -> Array:
    """t = eps + (1 - eps) * U[0,1)  (reference `MMF.py:146`).  `shape` is
    (B,) for plain batches or (B, J) for packed rows (one t per jet slot)."""
    if isinstance(shape, int):
        shape = (shape,)
    return eps + (1.0 - eps) * jax.random.uniform(key, shape, dtype=jnp.float32)


def _token_time(t_jets: Array, segments: Array) -> Array:
    """Scatter per-jet times (B, J) to per-token times (B, W) via the
    within-row segment ids (pads get slot 0's t; their outputs are masked)."""
    J = t_jets.shape[1]
    slot = jnp.clip(segments, 0, J - 1).astype(jnp.int32)
    return jnp.take_along_axis(t_jets, slot, axis=1)


class MMFModel(nn.Module):
    """Encoder + multitask-loss parameters in one trainable pytree."""

    config: Config

    def setup(self):
        self.encoder = build_model(self.config)
        self.multitask = MultiTaskLoss(self.config.multitask_loss, self.config.n_embd)

    def __call__(self, state: MultiModal, deterministic: bool = True,
                 segments=None, num_segments=None):
        if segments is not None:
            return self.encoder(state, deterministic, segments, num_segments)
        return self.encoder(state, deterministic)

    def training_loss(self, state: MultiModal, drift_target: Array, target_tokens: Array,
                      deterministic: bool = True):
        vt, logits = self.encoder(state, deterministic)
        loss_mse = masked_mse(vt, drift_target, state.mask)     # (B,)
        loss_ce = masked_ce(logits, target_tokens, state.mask)  # (B,)
        return self.multitask(loss_mse, loss_ce, state.time)

    def packed_training_loss(self, state: MultiModal, drift_target: Array,
                             target_tokens: Array, t_jets: Array,
                             segments: Array, jet_valid: Array,
                             deterministic: bool = True):
        """Per-jet multitask loss over packed multi-jet rows: the exact
        `training_loss` math with per-jet normalization recovered through
        the segment ids (tests/test_packed_training.py pins loss+grad
        parity per jet against the unpacked path)."""
        J = jet_valid.shape[1]
        vt, logits = self.encoder(state, deterministic, segments, J)
        loss_mse = packed_masked_mse(vt, drift_target, state.mask,
                                     segments, J).reshape(-1)
        loss_ce = packed_masked_ce(logits, target_tokens, state.mask,
                                   segments, J).reshape(-1)
        w = jet_valid.astype(jnp.float32).reshape(-1)
        return self.multitask(loss_mse, loss_ce, t_jets.reshape(-1), weights=w)


class MMF:
    """MultiModal Flow Bridge: CFM kinematics + telegraph flavor tokens,
    multitask loss, hybrid tau-leaping sampler (reference `MMF.py:20-200`)."""

    name = "MMF"

    def __init__(self, config: Config):
        self.config = config
        self.module = MMFModel(config)
        thermostat = ConstantThermostat(config.beta, config.vocab_size)
        self.bridge_continuous = UniformFlow(config.sigma)
        self.bridge_discrete = RandomTelegraphBridge(config.beta, config.vocab_size, thermostat)

    # ----------------------------------------------------------------- init

    def example_state(self, batch_size: int = 2) -> MultiModal:
        D = self.config.max_num_particles
        return MultiModal(
            time=jnp.zeros((batch_size,), jnp.float32),
            continuous=jnp.zeros((batch_size, D, self.config.dim_continuous), jnp.float32),
            discrete=jnp.zeros((batch_size, D, 1), jnp.int32),
            mask=jnp.ones((batch_size, D, 1), jnp.int32),
        )

    def init_params(self, key: Array, batch_size: int = 2):
        state = self.example_state(batch_size)
        drift = jnp.zeros_like(state.continuous)
        return self.module.init(key, state, drift, state.discrete, method="training_loss")

    # ----------------------------------------------------------------- loss

    def loss_fn(self, params, coupling, key: Array, train: bool = True
                ) -> Tuple[Array, Dict[str, Array]]:
        if isinstance(coupling, PackedJets):
            return self.packed_loss_fn(params, coupling, key, train)
        cfg = self.config
        target = coupling.target
        mask = target.mask
        B = target.continuous.shape[0]

        k_t, k_x0, k_k0, k_xt, k_kt, k_drop = jax.random.split(key, 6)
        t = _sample_time(k_t, B, cfg.time_eps)

        x0 = coupling.source.continuous
        if x0 is None:
            x0 = self.bridge_continuous.draw_source(k_x0, target.continuous, mask)
        k0 = coupling.source.discrete
        if k0 is None:
            k0 = self.bridge_discrete.draw_source(k_k0, target.discrete.shape, mask)

        xt = self.bridge_continuous.sample(k_xt, t, x0, target.continuous)
        kt = self.bridge_discrete.sample(k_kt, t, k0, target.discrete)
        state = MultiModal(time=t, continuous=xt, discrete=kt, mask=mask)

        drift_target = self.bridge_continuous.conditional_drift(xt, x0, target.continuous)

        rngs = {"dropout": k_drop} if (train and cfg.dropout > 0) else None
        loss, l_mse, l_ce, w_mse, w_ce = self.module.apply(
            params, state, drift_target, target.discrete,
            deterministic=not train, method="training_loss", rngs=rngs)

        metrics = {"loss": loss, "loss_mse": l_mse, "loss_ce": l_ce,
                   "weight_mse": w_mse, "weight_ce": w_ce}
        return loss, metrics

    def packed_loss_fn(self, params, batch: PackedJets, key: Array,
                       train: bool = True) -> Tuple[Array, Dict[str, Array]]:
        """Training loss over packed multi-jet rows.

        Identical math to `loss_fn` per jet (each jet draws its own t; the
        bridges broadcast per-token time; per-jet normalization recovered
        via segment sums) at the sampler's packed operating point (W=128
        rows) — the reference hot loop (`model/MMF.py:138-170`) at packed
        shapes.
        """
        cfg = self.config
        mask = batch.mask
        B, J = batch.jet_valid.shape

        k_t, k_x0, k_k0, k_xt, k_kt, k_drop = jax.random.split(key, 6)
        t_jets = _sample_time(k_t, (B, J), cfg.time_eps)
        t_tok = _token_time(t_jets, batch.segments)                    # (B, W)

        x1, k1 = batch.continuous, batch.discrete
        x0 = self.bridge_continuous.draw_source(k_x0, x1, mask)
        k0 = self.bridge_discrete.draw_source(k_k0, k1.shape, mask)

        xt = self.bridge_continuous.sample(k_xt, t_tok, x0, x1)
        kt = self.bridge_discrete.sample(k_kt, t_tok, k0, k1)
        state = MultiModal(time=t_tok, continuous=xt, discrete=kt, mask=mask)
        drift_target = self.bridge_continuous.conditional_drift(xt, x0, x1)

        rngs = {"dropout": k_drop} if (train and cfg.dropout > 0) else None
        loss, l_mse, l_ce, w_mse, w_ce = self.module.apply(
            params, state, drift_target, k1, t_jets, batch.segments,
            batch.jet_valid, deterministic=not train,
            method="packed_training_loss", rngs=rngs)

        metrics = {"loss": loss, "loss_mse": l_mse, "loss_ce": l_ce,
                   "weight_mse": w_mse, "weight_ce": w_ce}
        return loss, metrics

    # ------------------------------------------------------------- sampling

    def make_solver(self, params, temperature: Optional[float] = None,
                    top_k=None, top_p=None, segments=None,
                    num_segments=None) -> HybridSolver:
        cfg = self.config
        if segments is None:
            apply_fn = lambda s: self.module.apply(params, s)
        else:
            # packed multi-jet rows: block-diagonal attention via segment
            # ids (static through the whole trajectory scan); num_segments
            # (max jets/row) sizes EPiC's per-jet global stream
            apply_fn = lambda s: self.module.apply(params, s, segments=segments,
                                                   num_segments=num_segments)
        return HybridSolver(
            apply_fn,
            self.bridge_discrete,
            cfg.vocab_size,
            temperature=cfg.temperature if temperature is None else temperature,
            top_k=cfg.top_k if top_k is None else top_k,
            top_p=cfg.top_p if top_p is None else top_p,
            method=cfg.hybrid_solver,
            class_freqs=cfg.class_freqs,
        )

    def simulate(self, params, key: Array, source: MultiModal, num_timesteps: int,
                 temperature: float = 1.0, top_k=None, top_p=None,
                 use_final_max_rates: bool = False, return_trajectory: bool = False,
                 segments=None, num_segments=None, unroll=None):
        solver = self.make_solver(params, temperature, top_k, top_p, segments,
                                  num_segments)
        return simulate(key, solver, source, num_timesteps, self.config.time_eps,
                        return_trajectory=return_trajectory,
                        use_final_max_rates=use_final_max_rates, unroll=unroll)


class CFM:
    """Continuous-only conditional flow matching (reference `CFM.py:13-154`)."""

    name = "CFM"

    def __init__(self, config: Config):
        self.config = config
        self.module = build_model(config)
        self.bridge_continuous = UniformFlow(config.sigma)

    def example_state(self, batch_size: int = 2) -> MultiModal:
        D = self.config.max_num_particles
        return MultiModal(
            time=jnp.zeros((batch_size,), jnp.float32),
            continuous=jnp.zeros((batch_size, D, self.config.dim_continuous), jnp.float32),
            mask=jnp.ones((batch_size, D, 1), jnp.int32),
        )

    def init_params(self, key: Array, batch_size: int = 2):
        return self.module.init(key, self.example_state(batch_size))

    def loss_fn(self, params, coupling, key: Array, train: bool = True):
        if isinstance(coupling, PackedJets):
            return self.packed_loss_fn(params, coupling, key, train)
        cfg = self.config
        target = coupling.target
        mask = target.mask
        B = target.continuous.shape[0]

        k_t, k_x0, k_xt, k_drop = jax.random.split(key, 4)
        t = _sample_time(k_t, B, cfg.time_eps)

        x0 = coupling.source.continuous
        if x0 is None:
            x0 = self.bridge_continuous.draw_source(k_x0, target.continuous, mask)

        xt = self.bridge_continuous.sample(k_xt, t, x0, target.continuous)
        state = MultiModal(time=t, continuous=xt, mask=mask)
        drift_target = self.bridge_continuous.conditional_drift(xt, x0, target.continuous)

        rngs = {"dropout": k_drop} if (train and cfg.dropout > 0) else None
        vt = self.module.apply(params, state, deterministic=not train, rngs=rngs)

        # global masked MSE (reference `CFM.py:126-128` normalizes over the
        # whole batch, not per jet)
        se = (vt - drift_target) ** 2 * mask
        loss = se.sum() / mask.sum()
        return loss, {"loss": loss, "loss_mse": loss}

    def packed_loss_fn(self, params, batch: PackedJets, key: Array,
                       train: bool = True):
        """CFM loss over packed multi-jet rows: the global masked-MSE
        normalization (`CFM.py:126-128`) sums over exactly the same real
        tokens packed or not, so only per-token time + segment-masked
        attention differ from the flat path."""
        cfg = self.config
        mask = batch.mask
        B, J = batch.jet_valid.shape

        k_t, k_x0, k_xt, k_drop = jax.random.split(key, 4)
        t_jets = _sample_time(k_t, (B, J), cfg.time_eps)
        t_tok = _token_time(t_jets, batch.segments)

        x1 = batch.continuous
        x0 = self.bridge_continuous.draw_source(k_x0, x1, mask)
        xt = self.bridge_continuous.sample(k_xt, t_tok, x0, x1)
        state = MultiModal(time=t_tok, continuous=xt, mask=mask)
        drift_target = self.bridge_continuous.conditional_drift(xt, x0, x1)

        rngs = {"dropout": k_drop} if (train and cfg.dropout > 0) else None
        vt = self.module.apply(params, state, deterministic=not train,
                               segments=batch.segments, num_segments=J,
                               rngs=rngs)
        se = (vt - drift_target) ** 2 * mask
        # clip guards a batch of only padding rows (possible after
        # `pad_rows` + shuffle); real batches are unaffected
        loss = se.sum() / jnp.clip(mask.sum(), 1, None)
        return loss, {"loss": loss, "loss_mse": loss}

    def simulate(self, params, key: Array, source: MultiModal, num_timesteps: int,
                 method: str = "euler", return_trajectory: bool = False,
                 segments=None, num_segments=None, unroll=None, **_ignored):
        """Euler / Euler-Maruyama integration.  Extra hybrid-only kwargs
        (temperature, top_k, ...) are accepted and ignored so the generic
        generation driver can run any system."""
        if segments is None:
            apply_fn = lambda s: self.module.apply(params, s)
        else:
            apply_fn = lambda s: self.module.apply(params, s, segments=segments,
                                                   num_segments=num_segments)
        solver = ContinuousSolver(
            apply_fn,
            diffusion_fn=lambda s: self.bridge_continuous.diffusion(s.continuous),
            method=method,
        )
        return simulate(key, solver, source, num_timesteps, self.config.time_eps,
                        return_trajectory=return_trajectory, unroll=unroll)


class MJB:
    """Discrete-only Markov jump bridge (reference `MJB.py:14-146`)."""

    name = "MJB"

    def __init__(self, config: Config):
        self.config = config
        self.module = build_model(config)
        thermostat = ConstantThermostat(config.beta, config.vocab_size)
        self.bridge_discrete = RandomTelegraphBridge(config.beta, config.vocab_size, thermostat)

    def example_state(self, batch_size: int = 2) -> MultiModal:
        D = self.config.max_num_particles
        return MultiModal(
            time=jnp.zeros((batch_size,), jnp.float32),
            discrete=jnp.zeros((batch_size, D, 1), jnp.int32),
            mask=jnp.ones((batch_size, D, 1), jnp.int32),
        )

    def init_params(self, key: Array, batch_size: int = 2):
        return self.module.init(key, self.example_state(batch_size))

    def loss_fn(self, params, coupling, key: Array, train: bool = True):
        if isinstance(coupling, PackedJets):
            return self.packed_loss_fn(params, coupling, key, train)
        cfg = self.config
        target = coupling.target
        mask = target.mask
        B = target.discrete.shape[0]

        k_t, k_k0, k_kt, k_drop = jax.random.split(key, 4)
        t = _sample_time(k_t, B, cfg.time_eps)

        k0 = coupling.source.discrete
        if k0 is None:
            k0 = self.bridge_discrete.draw_source(k_k0, target.discrete.shape, mask)

        kt = self.bridge_discrete.sample(k_kt, t, k0, target.discrete)
        state = MultiModal(time=t, discrete=kt, mask=mask)

        rngs = {"dropout": k_drop} if (train and cfg.dropout > 0) else None
        logits = self.module.apply(params, state, deterministic=not train, rngs=rngs)

        # global masked CE (reference `MJB.py:120-122` normalizes over the
        # whole batch)
        targets = target.discrete[..., 0]
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, targets[..., None].astype(jnp.int32), axis=-1)[..., 0]
        w = mask[..., 0].astype(jnp.float32) * (targets != 0)
        loss = (nll * w).sum() / mask[..., 0].sum()
        return loss, {"loss": loss, "loss_ce": loss}

    def packed_loss_fn(self, params, batch: PackedJets, key: Array,
                       train: bool = True):
        """MJB loss over packed multi-jet rows (global masked-CE
        normalization `MJB.py:120-122`, per-token time, segment-masked
        attention)."""
        cfg = self.config
        mask = batch.mask
        B, J = batch.jet_valid.shape

        k_t, k_k0, k_kt, k_drop = jax.random.split(key, 4)
        t_jets = _sample_time(k_t, (B, J), cfg.time_eps)
        t_tok = _token_time(t_jets, batch.segments)

        k1 = batch.discrete
        k0 = self.bridge_discrete.draw_source(k_k0, k1.shape, mask)
        kt = self.bridge_discrete.sample(k_kt, t_tok, k0, k1)
        state = MultiModal(time=t_tok, discrete=kt, mask=mask)

        rngs = {"dropout": k_drop} if (train and cfg.dropout > 0) else None
        logits = self.module.apply(params, state, deterministic=not train,
                                   segments=batch.segments, num_segments=J,
                                   rngs=rngs)
        targets = k1[..., 0]
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, targets[..., None].astype(jnp.int32), axis=-1)[..., 0]
        w = mask[..., 0].astype(jnp.float32) * (targets != 0)
        # clip guards a batch of only padding rows (pad_rows + shuffle)
        loss = (nll * w).sum() / jnp.clip(mask[..., 0].sum(), 1, None)
        return loss, {"loss": loss, "loss_ce": loss}

    def simulate(self, params, key: Array, source: MultiModal, num_timesteps: int,
                 temperature: float = 1.0, top_k=None, top_p=None,
                 return_trajectory: bool = False, segments=None,
                 num_segments=None, unroll=None, **_ignored):
        if segments is None:
            apply_fn = lambda s: self.module.apply(params, s)
        else:
            apply_fn = lambda s: self.module.apply(params, s, segments=segments,
                                                   num_segments=num_segments)
        solver = DiscreteSolver(
            apply_fn,
            self.bridge_discrete,
            self.config.vocab_size,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            method=self.config.markov_jump_solver,
        )
        return simulate(key, solver, source, num_timesteps, self.config.time_eps,
                        return_trajectory=return_trajectory, unroll=unroll)


def build_system(config: Config, kind: str = "MMF"):
    from multimodal_flows.train.gpt import GPT

    registry = {"MMF": MMF, "CFM": CFM, "MJB": MJB, "GPT": GPT}
    return registry[kind](config)


SYSTEM_REGISTRY = {"MMF": MMF, "CFM": CFM, "MJB": MJB}
