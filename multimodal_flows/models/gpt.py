"""Autoregressive flavor-sequence GPT baseline.

Replacement for the reference `JetFlavorSeqGPT`
(`model/GPT.py:8-125`), which wraps HuggingFace's torch `GPT2LMHeadModel`:
here the decoder is a small causal transformer built from the same
SelfAttnBlock used by the set encoders (pre-LN, fused QKV) with learned
positional embeddings, and generation is a fixed-shape `lax.scan` loop
(one compiled program, no per-token Python).

Vocabulary layout (reference `GPT.py:18-21`): flavor tokens 1..V-1, plus
BOS = V+1, EOS = V+2, PAD = V+3 over sequences of max_seq_length + 2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from multimodal_flows import nn

from multimodal_flows.config import Config
from multimodal_flows.models.attention import SelfAttnBlock
from multimodal_flows.models.blocks import DENSE_INIT, EMBED_INIT, LayerNorm

Array = jax.Array


class FlavorSeqGPT(nn.Module):
    """Decoder-only causal transformer over flavor-token sequences.

    Two apply paths share the same parameters: `__call__` (teacher-forced
    full sequence) and `decode` (single position with per-layer KV caches
    — generation runs T single-token forwards instead of T full-sequence
    forwards, ~T/2 fewer FLOPs)."""

    config: Config

    @property
    def seq_len(self) -> int:
        return self.config.max_seq_length + 2  # BOS + tokens + EOS

    @property
    def full_vocab(self) -> int:
        return self.config.vocab_size + 4  # + BOS/EOS/PAD

    def setup(self):
        cfg = self.config
        self.wte = nn.Embed(self.full_vocab, cfg.n_embd, embedding_init=EMBED_INIT,
                            name="wte")
        self.wpe = nn.Embed(self.seq_len, cfg.n_embd, embedding_init=EMBED_INIT,
                            name="wpe")
        self.drop_emb = nn.Dropout(cfg.dropout_emb)
        # GPT2 dropout semantics (reference `GPT.py:31-34`): attn_pdrop on
        # attention probs, resid_pdrop after attn/MLP projections,
        # activation_function (gelu_new = tanh-approx) in the MLP
        self.blocks = [
            SelfAttnBlock(cfg.n_embd, cfg.n_head, cfg.n_inner,
                          dropout=cfg.dropout_res, use_bias=cfg.bias,
                          qk_layernorm=False, attn_dropout=cfg.dropout_att,
                          activation=cfg.activation, name=f"block_{i}")
            for i in range(cfg.n_layer)]
        self.ln_f = LayerNorm(name="ln_f")
        self.lm_head = nn.Dense(self.full_vocab, use_bias=False,
                                kernel_init=DENSE_INIT, name="lm_head")

    def __call__(self, input_ids: Array, deterministic: bool = True) -> Array:
        B, T = input_ids.shape
        tok = self.wte(input_ids)
        pos = self.wpe(jnp.arange(T))
        h = self.drop_emb(tok + pos[None], deterministic=deterministic)

        causal = jnp.tril(jnp.ones((T, T), bool))
        bias = jnp.where(causal, 0.0, -1e9).astype(jnp.float32)[None, None]
        for block in self.blocks:
            h = block(h, bias, deterministic)

        h = self.ln_f(h)
        return self.lm_head(h)

    def init_cache(self, batch_size: int):
        """Per-layer (k, v) caches of shape (B, seq_len, n_embd)."""
        cfg = self.config
        shape = (batch_size, self.seq_len, cfg.n_embd)
        return [(jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
                for _ in range(cfg.n_layer)]

    def decode(self, token: Array, pos: Array, caches):
        """One autoregressive step: token (B,) at position `pos` (traced
        scalar); returns (logits (B, V), updated caches)."""
        h = self.wte(token[:, None]) + self.wpe(pos)[None, None, :]
        new_caches = []
        for block, (kc, vc) in zip(self.blocks, caches):
            h, (kc, vc, _) = block(h, None, True, None, kv_cache=(kc, vc, pos))
            new_caches.append((kc, vc))
        h = self.ln_f(h)
        return self.lm_head(h)[:, 0], new_caches
