"""Toy MLP model for the 2D tutorial workload.

Equivalent of the notebook's `MultiModalFlow` MLP (reference
`notebooks/Tutorial_Colored_8Gaussians_to_2Moons.ipynb`, cell 8): Fourier
time embedding, concat of [x, one-hot(k), t_emb], shared MLP trunk, split
drift/logit heads.  Operates on single-particle clouds (B, 1, F).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from multimodal_flows import nn

from multimodal_flows.config import Config
from multimodal_flows.data.state import MultiModal
from multimodal_flows.models.blocks import DENSE_INIT, TimeFourierEmbedding

Array = jax.Array


class ToyMLP(nn.Module):
    config: Config

    def __call__(self, state: MultiModal, deterministic: bool = True):
        cfg = self.config
        B, D, F = state.continuous.shape

        t_emb = TimeFourierEmbedding(cfg.n_embd)(state.time)            # (B, E)
        t_emb = jnp.broadcast_to(t_emb[:, None, :], (B, D, cfg.n_embd))

        k_onehot = jax.nn.one_hot(state.discrete[..., 0], cfg.vocab_size)
        h = jnp.concatenate([state.continuous, k_onehot, t_emb], axis=-1)

        for i in range(max(cfg.n_layer, 1)):
            h = nn.Dense(cfg.n_inner or 128, kernel_init=DENSE_INIT, name=f"fc{i}")(h)
            h = nn.gelu(h, approximate=False)

        vt = nn.Dense(cfg.dim_continuous, kernel_init=DENSE_INIT, name="head_x")(h)
        logits = nn.Dense(cfg.vocab_size, kernel_init=DENSE_INIT, name="head_y")(h)
        return vt, logits
