"""Shared network blocks.

Re-designs of the reference's shared torch modules (`utils/models.py:8-75`):
MLP (fc-GELU-proj-dropout), LayerNorm with optional bias, sinusoidal
timestep embedding, and the Fourier time embedding used by the tutorial.

All Dense/Embed weights init N(0, 0.02), biases zero, matching the
reference's `_init_weights` (`networks/ParticleTransformers.py:135-142`).
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
from multimodal_flows import nn

Array = jax.Array

DENSE_INIT = nn.initializers.normal(stddev=0.02)
EMBED_INIT = nn.initializers.normal(stddev=0.02)

#: named activations (reference GPT2 `activation_function`, `GPT.py:31`)
ACTIVATIONS = {
    "gelu": lambda x: nn.gelu(x, approximate=False),
    "gelu_new": lambda x: nn.gelu(x, approximate=True),  # GPT2 tanh-approx GELU
    "relu": nn.relu,
    "silu": nn.silu,
    "tanh": jnp.tanh,
}


def activation_fn(name: str):
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; one of {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]


class MLP(nn.Module):
    """fc -> activation -> proj -> dropout (reference `utils/models.py:8-25`)."""

    n_inner: int
    n_out: Optional[int] = None
    dropout: float = 0.0
    use_bias: bool = True
    dtype: jnp.dtype = jnp.float32
    activation: str = "gelu"

    def __call__(self, x: Array, deterministic: bool = True) -> Array:
        n_out = self.n_out if self.n_out is not None else x.shape[-1]
        x = nn.Dense(self.n_inner, use_bias=self.use_bias, kernel_init=DENSE_INIT,
                     dtype=self.dtype, name="c_fc")(x)
        x = activation_fn(self.activation)(x)
        x = nn.Dense(n_out, use_bias=self.use_bias, kernel_init=DENSE_INIT,
                     dtype=self.dtype, name="c_proj")(x)
        x = nn.Dropout(self.dropout, deterministic=deterministic)(x)
        return x


class LayerNorm(nn.Module):
    """LayerNorm with optional bias (reference `utils/models.py:28-37`).
    Stats are computed in fp32 for bf16 activations."""

    use_bias: bool = True
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: Array) -> Array:
        return nn.LayerNorm(epsilon=1e-5, use_bias=self.use_bias, dtype=self.dtype)(x)


def timestep_embedding(timesteps: Array, embedding_dim: int, max_positions: int = 10000) -> Array:
    """Sinusoidal transformer time embedding
    (reference `utils/models.py:62-75`).

    Accepts any leading shape: (B,) per-jet time -> (B, E); (B, T)
    per-token time (packed multi-jet training rows) -> (B, T, E).
    """
    half_dim = embedding_dim // 2
    emb = math.log(max_positions) / (half_dim - 1)
    freqs = jnp.exp(jnp.arange(half_dim, dtype=jnp.float32) * -emb)
    args = timesteps.astype(jnp.float32)[..., None] * freqs
    emb = jnp.concatenate([jnp.sin(args), jnp.cos(args)], axis=-1)
    if embedding_dim % 2 == 1:
        emb = jnp.pad(emb, [(0, 0)] * (emb.ndim - 1) + [(0, 1)])
    return emb


def time_token_embedding(time: Array, embedding_dim: int, dtype=jnp.float32) -> Array:
    """Per-token time embedding for set encoders: per-jet (B,) time
    broadcasts as (B, 1, E); per-token (B, T) time (packed multi-jet rows,
    each jet carrying its own t) embeds as (B, T, E)."""
    emb = timestep_embedding(time, embedding_dim).astype(dtype)
    if time.ndim == 1:
        return emb[:, None, :]
    return emb


class TimeFourierEmbedding(nn.Module):
    """log-spaced Fourier features of scalar t (reference
    `utils/models.py:40-59`, used by the toy tutorial model)."""

    dim: int
    max_freq: float = 10.0

    def __call__(self, t: Array) -> Array:
        half = self.dim // 2
        inv_freq = 1.0 / (self.max_freq ** (jnp.arange(half, dtype=jnp.float32) / (half - 1)))
        if t.ndim == 1:
            t = t[:, None]
        x = t.astype(jnp.float32) * inv_freq[None, :]
        return jnp.concatenate([jnp.sin(x), jnp.cos(x)], axis=-1)


def key_mask_bias(mask: Array, neg: float = -1e9) -> Array:
    """(B, D, 1) pad mask -> compact additive key mask (B, D).

    Pad *keys* are excluded from every softmax; pad *queries* produce
    garbage rows that the loss mask discards, so no (B, 1, D, D) pair
    tensor is needed on the default path (the reference materializes a
    (B, n_head, D, D) boolean pair mask, `ParticleTransformers.py:64-68`).
    """
    m = mask[..., 0] > 0
    return jnp.where(m, 0.0, neg).astype(jnp.float32)


def pair_mask_bias(mask: Array, neg: float = -1e9) -> Array:
    """(B, D, 1) pad mask -> additive (B, 1, D, D) attention bias.

    The reference materializes a boolean (B, n_head, D, D) pair mask
    (`ParticleTransformers.py:64-68`); we use an additive-bias formulation
    (0 for real pairs, `neg` otherwise) so learned pairwise biases
    (co-occurrence / Lund) compose with hard masking instead of silently
    replacing it.  Fully-padded query rows softmax to uniform (finite)
    attention instead of NaN; their outputs are discarded by the loss mask.
    """
    m = mask[..., 0] > 0  # (B, D)
    pair = m[:, None, :, None] & m[:, None, None, :]  # (B,1,D,D)
    return jnp.where(pair, 0.0, neg).astype(jnp.float32)
