"""EPiC: equivariant point-cloud encoder.

Re-design of the reference EPiC network (`networks/EPiC.py:9-178`, itself
after EPiC-GAN): a local particle stream and a global jet stream coupled by
masked mean+sum pooling (`ops.masked_meansum_pool`) and global->local
broadcast, with weight-normalized Dense layers and local/global skip
connections.  Continuous-only (drift head; no discrete head).

Packed multi-jet rows (round 4): with `segments` (and a static
`num_segments` = max jets per row), pooling becomes per-jet
(`ops.segment_meansum_pool`) and the global stream carries one vector per
(row, jet-slot) — so several jets share one attentionless row without
mixing, and EPiC joins the packed sampling/training paths that previously
excluded it (the per-row global pool would have blended packed jets).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from multimodal_flows import nn

from multimodal_flows.config import Config
from multimodal_flows.data.state import MultiModal
from multimodal_flows.models.blocks import DENSE_INIT, timestep_embedding
from multimodal_flows.ops.pooling import (
    masked_meansum_pool,
    segment_gather,
    segment_meansum_pool,
)

Array = jax.Array


class _WNDense(nn.Module):
    """Weight-normalised Dense: kernel = scale * v / ||v||, the norm taken
    per output feature (reference `nn.utils.weight_norm`, `EPiC.py:80-178`);
    `scale` starts at one, so every column starts at unit norm."""

    features: int
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: Array) -> Array:
        v = self.param("kernel", DENSE_INIT, (x.shape[-1], self.features))
        scale = self.param("scale", nn.initializers.ones, (self.features,))
        bias = self.param("bias", nn.initializers.zeros, (self.features,))
        kernel = v * (scale / jnp.sqrt(jnp.sum(v * v, axis=0) + 1e-12))
        return x.astype(self.dtype) @ kernel.astype(self.dtype) + bias.astype(self.dtype)


def _wn_dense(features: int, name: str, dtype=jnp.float32):
    return _WNDense(features, dtype, name=name)


def _broadcast_global(x_global: Array, num_particles: int) -> Array:
    return jnp.broadcast_to(x_global[:, None, :], (x_global.shape[0], num_particles, x_global.shape[-1]))


class EPiCProjection(nn.Module):
    """Input projection into (local, global) streams (reference
    `EPiC.py:80-124`).  `pool` abstracts per-row vs per-segment pooling."""

    dim_hid_loc: int
    dim_hid_glob: int
    dtype: jnp.dtype = jnp.float32

    def __call__(self, time: Array, x_local: Array, x_global: Array,
                 pool: Callable):
        h = jnp.concatenate([time, x_local], axis=-1)
        h = nn.gelu(_wn_dense(self.dim_hid_loc, "local_fc1", self.dtype)(h), approximate=False)
        h = nn.gelu(_wn_dense(self.dim_hid_loc, "local_fc2", self.dtype)(h), approximate=False)

        g = pool(h, x_global)
        g = nn.gelu(_wn_dense(self.dim_hid_loc, "global_fc1", self.dtype)(g), approximate=False)
        g = nn.gelu(_wn_dense(self.dim_hid_glob, "global_fc2", self.dtype)(g), approximate=False)
        return h, g


class EPiCLayer(nn.Module):
    """One equivariant layer: pool -> global MLP (+skip) -> broadcast ->
    local MLP (+skip) (reference `EPiC.py:127-178`).  `pool`/`bcast`
    abstract the per-row vs per-segment (packed) pooling topology."""

    dim_loc: int
    dim_hid_loc: int
    dim_hid_glob: int
    dropout: float = 0.0
    dtype: jnp.dtype = jnp.float32

    def __call__(self, time: Array, x_local: Array, x_global: Array,
                 pool: Callable, bcast: Callable, deterministic: bool = True):
        act = lambda v: nn.leaky_relu(v)

        # global stream
        g_hidden = pool(x_local, x_global)
        g_hidden = act(_wn_dense(self.dim_loc, "fc_glob1", self.dtype)(g_hidden))
        x_global = x_global + _wn_dense(self.dim_hid_glob, "fc_glob2", self.dtype)(g_hidden)
        g_out = nn.Dropout(self.dropout, deterministic=deterministic)(act(x_global))

        # local stream
        glob2local = bcast(x_global)
        l_hidden = jnp.concatenate([time, x_local, glob2local], axis=-1)
        l_hidden = act(_wn_dense(self.dim_hid_loc, "fc_loc1", self.dtype)(l_hidden))
        x_local = x_local + _wn_dense(self.dim_hid_loc, "fc_loc2", self.dtype)(l_hidden)
        l_out = nn.Dropout(self.dropout, deterministic=deterministic)(act(x_local))

        return l_out, g_out


class EPiC(nn.Module):
    """Full EPiC drift network (reference `EPiC.py:9-77`)."""

    config: Config

    def __call__(self, state: MultiModal, deterministic: bool = True,
                 segments: Optional[Array] = None,
                 num_segments: Optional[int] = None) -> Array:
        cfg = self.config
        dt = jnp.float32
        mask = state.mask.astype(dt)
        D = state.continuous.shape[1]

        if segments is None:
            # per-row pooling: one jet per row (the reference topology)
            pool = lambda h, g: masked_meansum_pool(mask, h, g)
            bcast = lambda g: _broadcast_global(g, D)
            time_glob = timestep_embedding(state.time, cfg.n_embd)       # (B, E)
            time_local = _broadcast_global(time_glob, D)                 # (B, D, E)
        else:
            # packed rows: per-jet pooling over segment ids; the global
            # stream is (B, J, *) — one slot per jet in the row
            assert num_segments is not None, (
                "EPiC with segments needs a static num_segments "
                "(max jets per packed row)")
            J = num_segments
            pool = lambda h, g: segment_meansum_pool(segments, h, g, num_segments=J)
            bcast = lambda g: segment_gather(g, segments)
            # per-token time (packed training: each jet its own t); per-jet
            # time recovered as the segment mean (all tokens of a jet share
            # t, so the mean is exact; empty slots get 0 and are never
            # gathered back)
            t_tok = state.time
            if t_tok.ndim == 1:
                t_tok = jnp.broadcast_to(t_tok[:, None], segments.shape)
            t_jets = segment_meansum_pool(segments, t_tok[..., None],
                                          num_segments=J)[..., 0]        # (B, J)
            time_glob = timestep_embedding(t_jets, cfg.n_embd)           # (B, J, E)
            time_local = timestep_embedding(t_tok, cfg.n_embd)           # (B, D, E)

        x_emb = nn.Dense(cfg.n_embd, kernel_init=DENSE_INIT, dtype=dt, name="wxe")(
            state.continuous.astype(dt))

        x_local, x_global = EPiCProjection(cfg.n_embd, cfg.n_embd_glob, dt, name="proj")(
            time_local, x_emb, time_glob, pool)
        x_local_skip, x_global_skip = x_local, x_global

        for i in range(cfg.n_layer):
            x_local, x_global = EPiCLayer(cfg.n_embd, cfg.n_embd, cfg.n_embd_glob,
                                          cfg.dropout, dt, name=f"layer_{i}")(
                time_local, x_local, x_global, pool, bcast, deterministic)
            x_local = x_local + x_local_skip
            x_global = x_global + x_global_skip

        glob_bcast = bcast(x_global)
        h = jnp.concatenate([time_local, x_local, glob_bcast], axis=-1)
        return nn.Dense(cfg.dim_continuous, kernel_init=DENSE_INIT, dtype=jnp.float32,
                        name="head")(h)
