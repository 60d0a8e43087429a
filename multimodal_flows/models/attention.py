"""Self/cross attention modules over padded particle sets.

Re-design of reference `networks/attention.py:6-120`: pre-LN residual
blocks around fused-QKV multi-head attention with optional per-head
QK-LayerNorm.  Attention is non-causal (jets are permutation-symmetric
sets); masking and learned pairwise terms enter through one additive
(B, H|1, T, T) bias consumed by `ops.multihead_attention`.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from multimodal_flows import nn

from multimodal_flows.models.blocks import DENSE_INIT, MLP, LayerNorm
from multimodal_flows.ops.attention import (
    multihead_attention,
    multihead_attention_btc,
)

Array = jax.Array


class SelfAttention(nn.Module):
    """Fused-QKV multi-head self attention with QK-LayerNorm
    (reference `attention.py:32-74`).

    `dropout` is the residual dropout after c_proj; `attn_dropout` drops
    attention probabilities (the reference passes dropout_p=config.dropout
    into SDPA, `attention.py:69`) and defaults to `dropout` for parity.
    Prob dropout is applied only when not deterministic — the reference
    leaves SDPA's dropout_p unguarded, which (latent bug) would also drop
    at eval/predict time.
    """

    n_embd: int
    n_head: int
    dropout: float = 0.0
    use_bias: bool = True
    qk_layernorm: bool = True
    dtype: jnp.dtype = jnp.float32
    attn_dropout: Optional[float] = None  # None -> same as dropout

    def __call__(self, x: Array, attn_bias: Optional[Array] = None,
                 deterministic: bool = True, key_mask: Optional[Array] = None,
                 segments: Optional[Array] = None,
                 kv_cache: Optional[tuple] = None):
        """kv_cache — autoregressive decode mode: x is the single position
        `pos`, kv_cache = (k_cache, v_cache, pos) with caches (B, T, C).
        Returns (y, (k_cache, v_cache, pos)) with the caches updated at
        `pos`; attention sees only cached positions <= pos (causal).

        segments — (B, T) int ids for block-diagonal packed multi-jet rows
        (pads = -1); attention is restricted to same-segment pairs."""
        assert self.n_embd % self.n_head == 0
        B, T, C = x.shape
        hs = C // self.n_head

        qkv = nn.Dense(3 * self.n_embd, use_bias=self.use_bias, kernel_init=DENSE_INIT,
                       dtype=self.dtype, name="c_attn")(x)
        q, k, v = jnp.split(qkv, 3, axis=-1)

        if self.qk_layernorm:
            # per-head-size LayerNorm, params shared across heads; applied
            # in token layout (B, T, H, hs) — a free reshape — instead of
            # the head-transposed layout: LN over hs commutes with the
            # transpose, so the math and the param tree are unchanged while
            # the kernel path below needs no transposes at all.  Applied
            # before the decode/full-sequence split (identical in both).
            q = LayerNorm(use_bias=self.use_bias, dtype=self.dtype, name="q_layernorm")(
                q.reshape(B, T, self.n_head, hs)).reshape(B, T, C)
            k = LayerNorm(use_bias=self.use_bias, dtype=self.dtype, name="k_layernorm")(
                k.reshape(B, T, self.n_head, hs)).reshape(B, T, C)

        if kv_cache is not None:
            k_cache, v_cache, pos = kv_cache
            k_cache = jax.lax.dynamic_update_slice(k_cache, k, (0, pos, 0))
            v_cache = jax.lax.dynamic_update_slice(v_cache, v, (0, pos, 0))
            # causal: only cached positions <= pos are valid keys
            Tc = k_cache.shape[1]
            causal = jnp.where(jnp.arange(Tc)[None, :] <= pos, 0.0, -1e9
                               ).astype(jnp.float32)
            causal = jnp.broadcast_to(causal, (B, Tc))
            y = multihead_attention_btc(q, k_cache, v_cache, self.n_head,
                                        None, causal)
            y = nn.Dense(self.n_embd, use_bias=self.use_bias,
                         kernel_init=DENSE_INIT, dtype=self.dtype,
                         name="c_proj")(y)
            return y, (k_cache, v_cache, pos)

        p_attn = self.dropout if self.attn_dropout is None else self.attn_dropout
        rng = (self.make_rng("dropout")
               if (p_attn > 0.0 and not deterministic) else None)
        # qk-LN bounds |scores| <= gamma_q gamma_k sqrt(hs) for trained
        # gammas, so the softmax can skip its max-subtract passes over
        # (B,H,T,T) at inference (the sampling hot path).  Training keeps
        # the safe softmax: the gains are learned and unbounded, and the
        # clamp backstop would silently flatten gradients if scores ever
        # grew past it.  Learned pairwise biases (co-occurrence / Lund)
        # are unbounded -> safe path there too.
        y = multihead_attention_btc(q, k, v, self.n_head, attn_bias, key_mask,
                                    dropout_rate=p_attn, dropout_rng=rng,
                                    unnormalized_softmax=(
                                        self.qk_layernorm and attn_bias is None
                                        and deterministic),
                                    segments=segments)
        y = nn.Dense(self.n_embd, use_bias=self.use_bias, kernel_init=DENSE_INIT,
                     dtype=self.dtype, name="c_proj")(y)
        y = nn.Dropout(self.dropout, deterministic=deterministic)(y)
        return y


class CrossAttention(nn.Module):
    """Query from x, keys/values from z (reference `attention.py:77-120`)."""

    n_embd: int
    n_head: int
    dropout: float = 0.0
    use_bias: bool = True
    qk_layernorm: bool = True
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: Array, z: Array, attn_bias: Optional[Array] = None,
                 deterministic: bool = True) -> Array:
        B, T, C = x.shape
        hs = C // self.n_head

        q = nn.Dense(self.n_embd, use_bias=self.use_bias, kernel_init=DENSE_INIT,
                     dtype=self.dtype, name="c_query")(x)
        kv = nn.Dense(2 * self.n_embd, use_bias=self.use_bias, kernel_init=DENSE_INIT,
                      dtype=self.dtype, name="c_attn")(z)
        k, v = jnp.split(kv, 2, axis=-1)

        def heads(t):
            return t.reshape(B, -1, self.n_head, hs).transpose(0, 2, 1, 3)

        q, k, v = heads(q), heads(k), heads(v)

        if self.qk_layernorm:
            q = LayerNorm(use_bias=self.use_bias, dtype=self.dtype, name="q_layernorm")(q)
            k = LayerNorm(use_bias=self.use_bias, dtype=self.dtype, name="k_layernorm")(k)

        y = multihead_attention(q, k, v, attn_bias)
        y = y.transpose(0, 2, 1, 3).reshape(B, T, C)
        y = nn.Dense(self.n_embd, use_bias=self.use_bias, kernel_init=DENSE_INIT,
                     dtype=self.dtype, name="c_proj")(y)
        y = nn.Dropout(self.dropout, deterministic=deterministic)(y)
        return y


class SelfAttnBlock(nn.Module):
    """Pre-LN residual block: x + Attn(LN(x)); x + MLP(LN(x))
    (reference `attention.py:6-26`).

    `attn_dropout` (prob dropout) and `activation` exist for the GPT
    baseline's GPT2 semantics (attn_pdrop / resid_pdrop /
    activation_function, reference `GPT.py:31-34`); the set encoders use
    the defaults (attn_dropout = dropout, exact GELU) for reference parity.
    """

    n_embd: int
    n_head: int
    n_inner: Optional[int] = None
    dropout: float = 0.0
    use_bias: bool = True
    qk_layernorm: bool = True
    dtype: jnp.dtype = jnp.float32
    attn_dropout: Optional[float] = None
    activation: str = "gelu"

    def __call__(self, x: Array, attn_bias: Optional[Array] = None,
                 deterministic: bool = True, key_mask: Optional[Array] = None,
                 segments: Optional[Array] = None,
                 kv_cache: Optional[tuple] = None):
        n_inner = self.n_inner if self.n_inner is not None else 4 * self.n_embd
        h = LayerNorm(use_bias=self.use_bias, dtype=self.dtype, name="ln1")(x)
        attn = SelfAttention(self.n_embd, self.n_head, self.dropout, self.use_bias,
                             self.qk_layernorm, self.dtype, self.attn_dropout,
                             name="attn")
        if kv_cache is not None:
            y, kv_cache = attn(h, attn_bias, deterministic, key_mask, segments, kv_cache)
            x = x + y
        else:
            x = x + attn(h, attn_bias, deterministic, key_mask, segments)
        h = LayerNorm(use_bias=self.use_bias, dtype=self.dtype, name="ln2")(x)
        x = x + MLP(n_inner, dropout=self.dropout, use_bias=self.use_bias,
                    dtype=self.dtype, activation=self.activation,
                    name="ffw")(h, deterministic)
        if kv_cache is not None:
            return x, kv_cache
        return x
