"""Attention op tests: masking semantics, key-mask vs pair-bias
equivalence, token-major vs head-major layouts, and segment-masked packed
rows against per-jet attention."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_flows.models.blocks import key_mask_bias, pair_mask_bias
from multimodal_flows.ops.attention import multihead_attention


def _qkv(B=4, H=2, T=10, Dh=8, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return tuple(jax.random.normal(k, (B, H, T, Dh)) for k in ks)


def _mask(B=4, T=10, seed=1):
    n = jax.random.randint(jax.random.PRNGKey(seed), (B,), 2, T + 1)
    return (jnp.arange(T)[None, :] < n[:, None]).astype(jnp.int32)[..., None]


def test_key_mask_equals_pair_bias_on_real_rows():
    """Key-side masking must reproduce the pair-mask result for every real
    (non-pad) query row — pad rows are allowed to differ (discarded)."""
    q, k, v = _qkv()
    mask = _mask()
    out_pair = multihead_attention(q, k, v, pair_mask_bias(mask), None)
    out_key = multihead_attention(q, k, v, None, key_mask_bias(mask))
    real = np.asarray(mask[..., 0]) > 0
    np.testing.assert_allclose(np.asarray(out_pair).transpose(0, 2, 1, 3)[real],
                               np.asarray(out_key).transpose(0, 2, 1, 3)[real],
                               rtol=1e-5, atol=1e-6)


def test_pad_keys_never_attended():
    q, k, v = _qkv()
    mask = _mask()
    v_dirty = v.at[:, :, -1, :].set(1e6)  # poison the last key slot
    # jets where the last slot is padded must be unaffected by the poison
    km = key_mask_bias(mask)
    out_clean = multihead_attention(q, k, v, None, km)
    out_dirty = multihead_attention(q, k, v_dirty, None, km)
    pad_last = np.asarray(mask[:, -1, 0]) == 0
    np.testing.assert_allclose(np.asarray(out_clean)[pad_last],
                               np.asarray(out_dirty)[pad_last], rtol=1e-5)


def test_bias_composes_with_key_mask():
    q, k, v = _qkv()
    mask = _mask()
    bias = jax.random.normal(jax.random.PRNGKey(5), (4, 1, 10, 10))
    out = multihead_attention(q, k, v, bias, key_mask_bias(mask))
    assert np.isfinite(np.asarray(out)).all()


def _btc_qkv(B=12, T=10, C=32, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return tuple(jax.random.normal(k, (B, T, C), jnp.float32) for k in ks)


def test_btc_xla_matches_transposed_formulation():
    """The token-major (B,T,C) attention equals the head-transposed
    (B,H,T,Dh) formulation (the production path never materializes the
    head layout)."""
    from multimodal_flows.ops.attention import multihead_attention_btc

    B, T, C, H = 6, 10, 32, 4
    q, k, v = _btc_qkv(B, T, C)
    mask = _mask(B, T)
    km = key_mask_bias(mask)

    def heads(t):
        return t.reshape(B, T, H, C // H).transpose(0, 2, 1, 3)

    ref = multihead_attention(heads(q), heads(k), heads(v), None, km)
    ref = np.asarray(ref).transpose(0, 2, 1, 3).reshape(B, T, C)
    out = np.asarray(multihead_attention_btc(q, k, v, H, None, km))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_unnormalized_softmax_matches_safe_softmax():
    """The max-subtract-free softmax (enabled when qk-LN bounds the scores)
    must match the safe softmax exactly on bounded inputs, including -1e9
    key masking and gradients."""
    from multimodal_flows.ops.attention import (
        multihead_attention_btc,
        fast_inference_softmax,
    )

    B, T, C, H = 6, 10, 32, 4
    q, k, v = _btc_qkv(B, T, C)
    mask = _mask(B, T)
    km = jnp.where(mask[..., 0] > 0, 0.0, -1e9).astype(jnp.float32)

    ref = multihead_attention_btc(q, k, v, H, None, km)
    with fast_inference_softmax():
        out = multihead_attention_btc(q, k, v, H, None, km, unnormalized_softmax=True)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-6)

        g_ref = jax.grad(lambda a: (multihead_attention_btc(a, k, v, H, None, km) ** 2).sum())(q)
        g_out = jax.grad(lambda a: (multihead_attention_btc(
            a, k, v, H, None, km, unnormalized_softmax=True) ** 2).sum())(q)
        np.testing.assert_allclose(np.asarray(g_out), np.asarray(g_ref), atol=1e-5)

    # without the trace-time opt-in, the flag is inert (val-loss safety)
    out_gated = multihead_attention_btc(q, k, v, H, None, km, unnormalized_softmax=True)
    np.testing.assert_allclose(np.asarray(out_gated), np.asarray(ref), atol=1e-6)

    # full rows of pad keys on pad queries stay finite
    assert np.isfinite(np.asarray(out)).all()


@pytest.mark.parametrize("widths", [(5, 4), (3, 3, 3, 2), (12,)])
def test_segment_attention_matches_per_jet(widths):
    """Segment-masked attention over a packed row (several jets behind a
    block-diagonal mask, pads as segment -1) equals attention run on each
    jet alone, in values and in gradients."""
    from multimodal_flows.ops.attention import multihead_attention_btc

    B, T, C, H = 3, 12, 32, 4
    q, k, v = _btc_qkv(B, T, C)
    seg = np.full((B, T), -1, np.int32)
    bounds = np.cumsum((0,) + widths)
    for j, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        seg[:, lo:hi] = j
    seg = jnp.asarray(seg)
    w = jax.random.normal(jax.random.PRNGKey(9), (B, T, C))

    def packed(a, b, c):
        out = multihead_attention_btc(a, b, c, H, None, None, segments=seg)
        return out[:, :bounds[-1]]

    def per_jet(a, b, c):
        return jnp.concatenate(
            [multihead_attention_btc(a[:, lo:hi], b[:, lo:hi], c[:, lo:hi], H, None, None)
             for lo, hi in zip(bounds[:-1], bounds[1:])], axis=1)

    def loss(f):
        return lambda a, b, c: (f(a, b, c) * w[:, :bounds[-1]]).sum()

    with jax.default_matmul_precision("highest"):
        np.testing.assert_allclose(np.asarray(packed(q, k, v)),
                                   np.asarray(per_jet(q, k, v)), rtol=1e-5, atol=1e-6)
        g_packed = jax.grad(loss(packed), argnums=(0, 1, 2))(q, k, v)
        g_jet = jax.grad(loss(per_jet), argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g_packed, g_jet):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(a[:, :bounds[-1]], b[:, :bounds[-1]],
                                   rtol=1e-5, atol=1e-6)
        # pad slots carry no gradient into the jets' outputs
        assert np.all(a[:, bounds[-1]:] == 0)
