"""Particle-cloud transformer encoders.

Re-designs of the reference set encoders
(`networks/ParticleTransformers.py:17-432`): static (B, D) padded
sets, additive attention bias composing the pad-pair mask with learned
pairwise terms, fp32 softmax, optional bf16 matmuls.

Behavioral note: the reference adds learned pairwise biases onto a
*boolean* SDPA mask (`ParticleTransformers.py:70-72`), which silently
converts hard masking into "+1 for real pairs".  Here the pad mask is
always a -1e9 additive term so pairwise biases and masking compose as
intended.

Model heads return:
  ParticleFormer / FusedParticleFormer: (vt (B,D,Fc), logits (B,D,V))
  FlavorFormer: logits (B,D,V)
  KinFormer:    vt (B,D,Fc)
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from multimodal_flows import nn

from multimodal_flows.config import Config
from multimodal_flows.data.state import MultiModal
from multimodal_flows.models.attention import SelfAttnBlock
from multimodal_flows.models.blocks import (
    DENSE_INIT,
    EMBED_INIT,
    LayerNorm,
    key_mask_bias,
    pair_mask_bias,
    time_token_embedding,
)

Array = jax.Array


def _dtype(config: Config):
    return jnp.bfloat16 if config.compute_dtype == "bfloat16" else jnp.float32



def _block_cls(config: Config):
    """SelfAttnBlock, optionally rematerialized (`config.remat`): recompute
    block activations in the backward pass to trade FLOPs for HBM (the
    reference has no equivalent; useful at large global batch)."""
    if config.remat:
        return nn.remat(SelfAttnBlock, static_argnums=(3,))
    return SelfAttnBlock

class _EmbedMLP(nn.Module):
    """Linear/Embed -> GELU -> Linear feature embedder (reference `wxe`/`wye`,
    `ParticleTransformers.py:29-34`)."""

    n_hidden: int
    n_out: int
    vocab_size: Optional[int] = None  # set for token embedding
    use_bias: bool = True
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: Array) -> Array:
        if self.vocab_size is not None:
            h = nn.Embed(self.vocab_size, self.n_hidden, embedding_init=EMBED_INIT,
                         dtype=self.dtype, name="embed")(x)
        else:
            h = nn.Dense(self.n_hidden, use_bias=self.use_bias, kernel_init=DENSE_INIT,
                         dtype=self.dtype, name="fc")(x)
        h = nn.gelu(h, approximate=False)
        return nn.Dense(self.n_out, use_bias=self.use_bias, kernel_init=DENSE_INIT,
                        dtype=self.dtype, name="proj")(h)


class _Head(nn.Module):
    """Linear -> GELU -> Linear output head (reference `head_x`/`head_y`,
    `ParticleTransformers.py:48-53`)."""

    n_inner: int
    n_out: int
    use_bias: bool = True
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: Array) -> Array:
        h = nn.Dense(self.n_inner, use_bias=self.use_bias, kernel_init=DENSE_INIT,
                     dtype=self.dtype, name="fc")(x)
        h = nn.gelu(h, approximate=False)
        # final head projection in fp32 for stable drift/logit outputs
        return nn.Dense(self.n_out, use_bias=self.use_bias, kernel_init=DENSE_INIT,
                        dtype=jnp.float32, name="proj")(h)


class _CoOccurrenceBias(nn.Module):
    """Symmetric token co-occurrence attention bias via triangle-number pair
    encoding (reference `ParticleTransformers.py:124-133`).

    The reference gathers the pair embedding into a (B, D, D, E) tensor and
    THEN projects to heads — at packed row widths (W=128, E=256) that
    intermediate alone is ~2 GB per batch.
    Gather and linear map commute, so here the (n_pairs, E) table is
    projected FIRST — n_pairs = V(V+1)/2 = 45 rows — and the (B, D, D, H)
    bias is gathered directly (H=4: ~64x smaller).  Same parameters, same
    math, no pair-width HBM cliff.
    """

    vocab_size: int
    n_embd: int
    n_head: int
    dtype: jnp.dtype = jnp.float32

    def __call__(self, tokens: Array) -> Array:  # tokens: (B, D)
        i, j = tokens[:, :, None], tokens[:, None, :]
        lo = jnp.minimum(i, j)
        hi = jnp.maximum(i, j)
        pair_idx = (hi * (hi + 1)) // 2 + lo  # (B, D, D)
        n_pairs = (self.vocab_size * (self.vocab_size + 1)) // 2
        table = nn.Embed(n_pairs, self.n_embd, embedding_init=EMBED_INIT,
                         dtype=self.dtype, name="wue")(
            jnp.arange(n_pairs, dtype=jnp.int32))                    # (P, E)
        table = nn.Dense(self.n_head, kernel_init=DENSE_INIT, dtype=self.dtype,
                         name="wue_proj")(table)                     # (P, H)
        bias = table[pair_idx]                                       # (B,D,D,H)
        return bias.transpose(0, 3, 1, 2).astype(jnp.float32)        # (B,H,D,D)


class ParticleFormer(nn.Module):
    """Dual-stream multimodal transformer (the flagship encoder; reference
    `ParticleTransformers.py:17-142`).

    Per-modality half-width stacks with the time embedding re-added after
    every block, concatenated into full-width fused blocks, split back with
    modality skip connections into drift and logit heads.
    """

    config: Config

    def __call__(self, state: MultiModal, deterministic: bool = True,
                 segments: Optional[Array] = None,
                 num_segments: Optional[int] = None):  # num_segments: EPiC-only

        cfg = self.config
        dt = _dtype(cfg)
        half = cfg.n_embd // 2

        # default path: compact key-side mask (no (B,1,D,D) pair tensor);
        # pairwise variants fold the pad pair mask into the full bias.
        # `segments` (packed multi-jet rows, pads = -1) replaces the key
        # mask: the block-diagonal same-segment comparison subsumes pad
        # masking and is fused into the softmax (ops/attention.py).
        if cfg.use_coocurrence:
            key_mask = None
            attn_bias = _CoOccurrenceBias(
                cfg.vocab_size, cfg.n_embd, cfg.n_head, dt, name="coocc")(state.discrete[..., 0])
            if segments is None:
                attn_bias = pair_mask_bias(state.mask) + attn_bias
        elif segments is not None:
            key_mask = None
            attn_bias = None
        else:
            key_mask = key_mask_bias(state.mask)
            attn_bias = None

        time_emb = time_token_embedding(state.time, half, dt)  # (B,1|T,half)

        # continuous stream
        x = _EmbedMLP(cfg.n_embd, half, use_bias=cfg.bias, dtype=dt, name="wxe")(
            state.continuous.astype(dt))
        x = LayerNorm(dtype=dt, name="ln1_x")(x)
        x = nn.Dropout(cfg.dropout, deterministic=deterministic)(x + time_emb)
        x_skip = x

        for i in range(cfg.n_layer):
            x = _block_cls(cfg)(half, cfg.n_head, cfg.n_inner, cfg.dropout, cfg.bias,
                              cfg.qk_layernorm, dt,
                              name=f"block_x_{i}")(x, attn_bias, deterministic, key_mask, segments)
            x = x + time_emb
        x = LayerNorm(dtype=dt, name="ln2_x")(x + x_skip)

        # discrete stream
        y = _EmbedMLP(cfg.n_embd, half, vocab_size=cfg.vocab_size, use_bias=cfg.bias,
                      dtype=dt, name="wye")(state.discrete[..., 0])
        y = LayerNorm(dtype=dt, name="ln1_y")(y)
        y = nn.Dropout(cfg.dropout, deterministic=deterministic)(y + time_emb)
        y_skip = y

        for i in range(cfg.n_layer):
            y = _block_cls(cfg)(half, cfg.n_head, cfg.n_inner, cfg.dropout, cfg.bias,
                              cfg.qk_layernorm, dt,
                              name=f"block_y_{i}")(y, attn_bias, deterministic, key_mask, segments)
            y = y + time_emb
        y = LayerNorm(dtype=dt, name="ln2_y")(y + y_skip)

        # fused stream
        z = jnp.concatenate([x, y], axis=-1)
        time_emb2 = nn.Dense(cfg.n_embd, kernel_init=DENSE_INIT, dtype=dt,
                             name="time_expand")(time_emb)
        z = nn.Dropout(cfg.dropout, deterministic=deterministic)(z + time_emb2)

        for i in range(cfg.n_layer_fused):
            z = _block_cls(cfg)(cfg.n_embd, cfg.n_head, cfg.n_inner, cfg.dropout, cfg.bias,
                              cfg.qk_layernorm, dt,
                              name=f"block_fuse_{i}")(z, attn_bias, deterministic, key_mask, segments)
            z = z + time_emb2

        x, y = jnp.split(z, 2, axis=-1)
        x = LayerNorm(dtype=dt, name="ln3_x")(x + x_skip)
        y = LayerNorm(dtype=dt, name="ln3_y")(y + y_skip)

        vt = _Head(cfg.n_inner or 4 * half, cfg.dim_continuous, cfg.bias, dt, name="head_x")(x)
        logits = _Head(cfg.n_inner or 4 * half, cfg.vocab_size, cfg.bias, dt, name="head_y")(y)
        return vt, logits


class FusedParticleFormer(nn.Module):
    """Single-stream variant: embed both modes, concat, full-width blocks,
    split into two heads (reference `ParticleTransformers.py:145-219`)."""

    config: Config

    def __call__(self, state: MultiModal, deterministic: bool = True,
                 segments: Optional[Array] = None,
                 num_segments: Optional[int] = None):  # num_segments: EPiC-only

        cfg = self.config
        dt = _dtype(cfg)
        half = cfg.n_embd // 2

        key_mask = None if segments is not None else key_mask_bias(state.mask)
        attn_bias = None

        x = _EmbedMLP(cfg.n_embd, half, use_bias=cfg.bias, dtype=dt, name="wxe")(
            state.continuous.astype(dt))
        x = LayerNorm(dtype=dt, name="ln1_x")(x)
        y = _EmbedMLP(cfg.n_embd, half, vocab_size=cfg.vocab_size, use_bias=cfg.bias,
                      dtype=dt, name="wye")(state.discrete[..., 0])
        y = LayerNorm(dtype=dt, name="ln1_y")(y)

        z = jnp.concatenate([x, y], axis=-1)
        time_emb = time_token_embedding(state.time, cfg.n_embd, dt)

        z = nn.Dropout(cfg.dropout, deterministic=deterministic)(z + time_emb)
        z_skip = z

        for i in range(cfg.n_layer):
            z = _block_cls(cfg)(cfg.n_embd, cfg.n_head, cfg.n_inner, cfg.dropout, cfg.bias,
                              cfg.qk_layernorm, dt,
                              name=f"block_{i}")(z, attn_bias, deterministic, key_mask, segments)
            z = z + time_emb

        z = LayerNorm(dtype=dt, name="ln2")(z + z_skip)
        x, y = jnp.split(z, 2, axis=-1)

        vt = _Head(cfg.n_inner or 2 * cfg.n_embd, cfg.dim_continuous, cfg.bias, dt, name="head_x")(x)
        logits = _Head(cfg.n_inner or 2 * cfg.n_embd, cfg.vocab_size, cfg.bias, dt, name="head_y")(y)
        return vt, logits


class FlavorFormer(nn.Module):
    """Discrete-only encoder for MJB (reference
    `ParticleTransformers.py:223-312`), with optional learned positional
    embedding and lambda_u-gated pairwise token-interaction bias."""

    config: Config

    def __call__(self, state: MultiModal, deterministic: bool = True,
                 segments: Optional[Array] = None,
                 num_segments: Optional[int] = None):  # num_segments: EPiC-only

        cfg = self.config
        dt = _dtype(cfg)
        if segments is not None and cfg.use_pos_emb:
            raise ValueError("packed rows (segments) are incompatible with "
                             "learned positional embeddings")

        if cfg.use_pairwise:
            lambda_u = self.param("lambda_u", nn.initializers.zeros, ())
            u_bias = _CoOccurrenceBias(cfg.vocab_size, cfg.n_embd, cfg.n_head, dt,
                                       name="pairwise")(state.discrete[..., 0])
            attn_bias = lambda_u * u_bias
            if segments is None:
                attn_bias = pair_mask_bias(state.mask) + attn_bias
            key_mask = None
        elif segments is not None:
            attn_bias = None
            key_mask = None
        else:
            attn_bias = None
            key_mask = key_mask_bias(state.mask)

        tok = _EmbedMLP(cfg.n_embd, cfg.n_embd, vocab_size=cfg.vocab_size,
                        use_bias=cfg.bias, dtype=dt, name="wte")(state.discrete[..., 0])
        tok = LayerNorm(dtype=dt, name="ln1")(tok)

        time_emb = time_token_embedding(state.time, cfg.n_embd, dt)

        if cfg.use_pos_emb:
            # index by the actual (possibly bucket-truncated) width: slots
            # are first-n filled, so positions 0..T-1 are the right rows of
            # the max_num_particles-sized table at any width
            pos = jnp.arange(tok.shape[1])
            pos_emb = nn.Embed(cfg.max_num_particles, cfg.n_embd, embedding_init=EMBED_INIT,
                               dtype=dt, name="wpe")(pos)
            tok = tok + pos_emb[None, :, :]

        f = nn.Dropout(cfg.dropout, deterministic=deterministic)(tok + time_emb)
        f_skip = tok

        for i in range(cfg.n_layer):
            f = _block_cls(cfg)(cfg.n_embd, cfg.n_head, cfg.n_inner, cfg.dropout, cfg.bias,
                              cfg.qk_layernorm, dt,
                              name=f"block_{i}")(f, attn_bias, deterministic, key_mask, segments)
            f = f + time_emb

        f = LayerNorm(dtype=dt, name="ln2")(f + f_skip)
        return _Head(cfg.n_inner or 4 * cfg.n_embd, cfg.vocab_size, cfg.bias, dt,
                     name="head")(f)


def lund_observables(state: MultiModal, mu, sig) -> Array:
    """Pairwise Lund-plane observables (log kT, log dR) from standardized
    kinematics (reference `ParticleTransformers.py:412-432`).

    Destandardizes with the dataset metadata, masks pads, and normalizes the
    two observables per pair.
    """
    kin = state.continuous.astype(jnp.float32)
    dim = kin.shape[-1]
    mu = jnp.asarray(mu, jnp.float32).reshape(1, 1, dim)
    sig = jnp.asarray(sig, jnp.float32).reshape(1, 1, dim)
    kin = kin * sig + mu
    kin = kin * state.mask

    pt_i, pt_j = kin[..., 0][:, :, None], kin[..., 0][:, None, :]
    eta_i, eta_j = kin[..., 1][:, :, None], kin[..., 1][:, None, :]
    phi_i, phi_j = kin[..., 2][:, :, None], kin[..., 2][:, None, :]

    deta = eta_i - eta_j
    dphi = jnp.remainder(phi_i - phi_j + jnp.pi, 2 * jnp.pi) - jnp.pi
    dR = jnp.sqrt(deta**2 + dphi**2)
    # eps-regularized: the reference takes log(0) = -inf on the self-pair
    # diagonal, which NaNs the whole bias (its `particle_interactions_emb`
    # carries a "TODO fix", `ParticleTransformers.py:392`)
    log_dR = jnp.log(dR + 1e-8)
    # guarded denominator: padded particles have pt = 0 (the reference's
    # 0/0 here NaNs pad pairs, which then poison the masked softmax)
    kt_arg = jnp.minimum(pt_i, pt_j) * dR**2 / (pt_i * pt_j + 1e-12)
    log_kt = jnp.log(jnp.clip(kt_arg, 0.0, None) + 1e-8)
    U = jnp.stack([log_kt, log_dR], axis=-1)  # (B,D,D,2)
    U = (U - U.mean(axis=-1, keepdims=True)) / (U.std(axis=-1, keepdims=True) + 1e-8)
    return U


class KinFormer(nn.Module):
    """Continuous-only encoder for CFM (reference
    `ParticleTransformers.py:315-409`), with optional Lund pairwise bias."""

    config: Config

    def __call__(self, state: MultiModal, deterministic: bool = True,
                 segments: Optional[Array] = None,
                 num_segments: Optional[int] = None):  # num_segments: EPiC-only

        cfg = self.config
        dt = _dtype(cfg)
        if segments is not None and cfg.use_pos_emb:
            raise ValueError("packed rows (segments) are incompatible with "
                             "learned positional embeddings")

        if cfg.use_pairwise:
            # segment masking subsumes the pad-pair mask; the Lund bias on
            # cross-jet pairs is computed but masked out in attention
            attn_bias = (jnp.zeros_like(pair_mask_bias(state.mask))
                         if segments is not None else pair_mask_bias(state.mask))
            key_mask = None
            lambda_u = self.param("lambda_u", nn.initializers.zeros, ())
            meta = cfg.metadata or {}
            mu = meta.get("mean", [0.0] * cfg.dim_continuous)
            sig = meta.get("std", [1.0] * cfg.dim_continuous)
            U = lund_observables(state, mu, sig)                       # (B,D,D,2)
            # pair-MLP in query-row chunks: the (B, D, D, E) hidden tensors
            # of the unchunked form are ~2 GB at packed widths (W=128,
            # E=256); a chunk of rows keeps peak pair-hidden memory at chunk/D of
            # that, while the (B,D,D,2) input and (B,D,D,H) output stay
            # small (H=4).  Exactness: the reference symmetrizes
            # 0.5*(f(U) + f(U)^T) (`ParticleTransformers.py:375-377`);
            # per-pair elementwise f means row i of f(U)^T is f(U^T row i),
            # so each chunk computes BOTH orientations and averages —
            # bit-identical to the unchunked symmetrize.  The second
            # symmetrize (`:392-400`) is then the identity: g(u_sym) is
            # bitwise symmetric because fp addition is commutative.
            fc = nn.Dense(cfg.n_embd, kernel_init=DENSE_INIT, dtype=dt, name="wue_fc")
            ln = nn.LayerNorm(dtype=dt, name="wue_ln")
            pfc = nn.Dense(cfg.n_embd, use_bias=cfg.bias, kernel_init=DENSE_INIT,
                           dtype=dt, name="wue_proj_fc")
            pout = nn.Dense(cfg.n_head, use_bias=cfg.bias, kernel_init=DENSE_INIT,
                            dtype=dt, name="wue_proj_out")

            def stage1(v):
                return ln(nn.gelu(fc(v), approximate=False))

            D = U.shape[1]
            c = cfg.pair_chunk if cfg.pair_chunk and cfg.pair_chunk > 0 else D
            Ut = U.transpose(0, 2, 1, 3)
            outs = []
            for a in range(0, D, c):
                u_sym = 0.5 * (stage1(U[:, a:a + c].astype(dt))
                               + stage1(Ut[:, a:a + c].astype(dt)))
                outs.append(pout(nn.gelu(pfc(u_sym), approximate=False)))
            u = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=1)
            attn_bias = attn_bias + lambda_u * u.transpose(0, 3, 1, 2).astype(jnp.float32)
        elif segments is not None:
            attn_bias = None
            key_mask = None
        else:
            attn_bias = None
            key_mask = key_mask_bias(state.mask)

        x = _EmbedMLP(cfg.n_embd, cfg.n_embd, use_bias=cfg.bias, dtype=dt, name="wxe")(
            state.continuous.astype(dt))
        x = LayerNorm(dtype=dt, name="ln1")(x)

        time_emb = time_token_embedding(state.time, cfg.n_embd, dt)

        if cfg.use_pos_emb:
            pos = jnp.arange(x.shape[1])
            pos_emb = nn.Embed(cfg.max_num_particles, cfg.n_embd, embedding_init=EMBED_INIT,
                               dtype=dt, name="wpe")(pos)
            x = x + pos_emb[None, :, :]

        h = nn.Dropout(cfg.dropout, deterministic=deterministic)(x + time_emb)
        h_skip = h

        for i in range(cfg.n_layer):
            h = _block_cls(cfg)(cfg.n_embd, cfg.n_head, cfg.n_inner, cfg.dropout, cfg.bias,
                              cfg.qk_layernorm, dt,
                              name=f"block_{i}")(h, attn_bias, deterministic, key_mask, segments)
            h = h + time_emb

        h = LayerNorm(dtype=dt, name="ln2")(h + h_skip)
        return _Head(cfg.n_inner or 4 * cfg.n_embd, cfg.dim_continuous, cfg.bias, dt,
                     name="head")(h)
