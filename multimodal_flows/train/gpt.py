"""GPT baseline training/generation system.

Functional equivalent of the reference `JetFlavorSeqGPT` Lightning module
(`model/GPT.py:8-125`): next-token CE with pads ignored, cosine LR (the
Trainer's schedule covers it), and autoregressive sampling with
temperature/top-k — compiled as one `lax.scan` over positions with a
fixed-shape token buffer (the reference calls HF `model.generate`, a
Python loop per token).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from multimodal_flows.config import Config
from multimodal_flows.data.state import DataCoupling
from multimodal_flows.models.gpt import FlavorSeqGPT

Array = jax.Array


class GPT:
    """Autoregressive flavor-sequence baseline system."""

    name = "GPT"

    def __init__(self, config: Config):
        self.config = config
        self.module = FlavorSeqGPT(config)
        self.start_token = config.vocab_size + 1
        self.end_token = config.vocab_size + 2
        self.pad_token = config.vocab_size + 3

    def init_params(self, key: Array, batch_size: int = 2):
        T = self.module.seq_len
        return self.module.init(key, jnp.zeros((batch_size, T), jnp.int32))

    # ----------------------------------------------------------------- loss

    def loss_fn(self, params, coupling: DataCoupling, key: Array, train: bool = True
                ) -> Tuple[Array, dict]:
        """Next-token CE; positions whose target is PAD are ignored
        (reference `GPT.py:51-66, 120-125` via labels=-100)."""
        tokens = coupling.target.discrete
        if tokens.ndim == 3:
            tokens = tokens[..., 0]
        tokens = tokens.astype(jnp.int32)

        rngs = {"dropout": key} if (train and (self.config.dropout_att > 0
                                               or self.config.dropout_emb > 0
                                               or self.config.dropout_res > 0)) else None
        logits = self.module.apply(params, tokens, deterministic=not train, rngs=rngs)

        # shift: predict token t+1 from prefix <= t
        logits = logits[:, :-1]
        targets = tokens[:, 1:]
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
        w = (targets != self.pad_token).astype(jnp.float32)
        loss = (nll * w).sum() / jnp.clip(w.sum(), 1.0, None)
        return loss, {"loss": loss, "loss_ce": loss}

    # ------------------------------------------------------------- sampling

    def generate(self, params, key: Array, batch_size: int,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None) -> Array:
        """Sample token sequences starting from BOS; returns (B, T) int32
        including special tokens (reference `GPT.py:85-100`).

        One `lax.scan` over positions: each step runs the full forward on
        the fixed-size buffer and writes position t+1.  Sequences that have
        emitted EOS keep emitting PAD.
        """
        cfg = self.config
        T = self.module.seq_len
        temperature = cfg.temperature if temperature is None else temperature
        if isinstance(temperature, (list, tuple)):
            temperature = temperature[0]
        top_k = cfg.top_k if top_k is None else top_k

        # KV-cached decode: each scan step runs ONE token through the
        # decoder against per-layer caches instead of re-running the full
        # (B, T) forward per position (~T/2 fewer FLOPs)
        caches = self.module.apply(params, batch_size, method="init_cache")
        prev = jnp.full((batch_size,), self.start_token, jnp.int32)
        done = jnp.zeros((batch_size,), bool)

        def step(carry, t):
            prev, caches, done, k = carry
            k, sub = jax.random.split(k)
            logits_t, caches = self.module.apply(params, prev, t, caches,
                                                 method="decode")
            logits_t = logits_t.astype(jnp.float32) / jnp.asarray(
                temperature, jnp.float32)
            if top_k is not None:
                thresh = jax.lax.top_k(logits_t, top_k)[0][..., -1:]
                logits_t = jnp.where(logits_t >= thresh, logits_t, -1e9)
            nxt = jax.random.categorical(sub, logits_t, axis=-1).astype(jnp.int32)
            nxt = jnp.where(done, self.pad_token, nxt)
            done = done | (nxt == self.end_token)
            return (nxt, caches, done, k), nxt

        _, toks = jax.lax.scan(step, (prev, caches, done, key), jnp.arange(T - 1))
        bos = jnp.full((batch_size, 1), self.start_token, jnp.int32)
        return jnp.concatenate([bos, toks.T], axis=1)

    def sample_jets(self, params, key: Array, batch_size: int,
                    temperature: Optional[float] = None,
                    top_k: Optional[int] = None) -> np.ndarray:
        """Generate and strip special tokens back to (B, max_num_particles)
        flavor sets (reference `GPT.py:97-98`)."""
        from multimodal_flows.data.datasets import seq_to_jet_set

        seq = np.asarray(self.generate(params, key, batch_size, temperature, top_k))
        return seq_to_jet_set(seq, self.config.vocab_size, self.config.max_seq_length)

    # ------------------------------------------------- trainer compatibility

    def example_state(self, batch_size: int = 2):
        return jnp.zeros((batch_size, self.module.seq_len), jnp.int32)
