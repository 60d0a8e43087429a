"""Network shape/masking tests for every registry encoder and variant flag
(reference parity: `networks/ParticleTransformers.py`, `networks/EPiC.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_flows.config import Config
from multimodal_flows.data.state import MultiModal
from multimodal_flows.models.registry import MODEL_REGISTRY, build_model
from multimodal_flows.models.particle_transformers import lund_observables
from tests.conftest import make_jets


def cfg_for(model, **kw):
    base = dict(model=model, n_embd=16, n_inner=32, n_layer=1, n_layer_fused=1,
                n_head=2, max_num_particles=6, vocab_size=9, dim_continuous=3,
                n_embd_glob=8,
                metadata={"mean": [0.0, 0.0, 0.0], "std": [1.0, 1.0, 1.0]})
    base.update(kw)
    return Config(**base)


def state_for(B=4, D=6, seed=0):
    jets = make_jets(B=B, D=D, seed=seed)
    return MultiModal(time=jnp.full((B,), 0.5),
                      continuous=jnp.asarray(jets.continuous),
                      discrete=jnp.asarray(jets.discrete),
                      mask=jnp.asarray(jets.mask))


DUAL_HEAD = {"ParticleFormer", "FusedParticleFormer", "ToyMLP"}


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_forward_shapes(name):
    cfg = cfg_for(name)
    model = build_model(cfg)
    st = state_for()
    params = model.init(jax.random.PRNGKey(0), st)
    out = model.apply(params, st)
    if name in DUAL_HEAD:
        vt, logits = out
        assert vt.shape == (4, 6, 3)
        assert logits.shape == (4, 6, 9)
    elif name == "FlavorFormer":
        assert out.shape == (4, 6, 9)
    else:  # KinFormer, EPiC
        assert out.shape == (4, 6, 3)
    assert all(np.isfinite(np.asarray(o)).all() for o in jax.tree.leaves(out))


@pytest.mark.parametrize("name,flags", [
    ("ParticleFormer", {"use_coocurrence": True}),
    ("FlavorFormer", {"use_pairwise": True}),
    ("FlavorFormer", {"use_pos_emb": True}),
    ("KinFormer", {"use_pairwise": True}),
    ("KinFormer", {"use_pos_emb": True}),
])
def test_variant_flags(name, flags):
    cfg = cfg_for(name, **flags)
    model = build_model(cfg)
    st = state_for()
    params = model.init(jax.random.PRNGKey(0), st)
    out = model.apply(params, st)
    leaves = jax.tree.leaves(out)
    assert all(np.isfinite(np.asarray(o)).all() for o in leaves)
    names = [  # lambda_u gate present for pairwise variants
        "/".join(str(p) for p in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    if flags.get("use_pairwise"):
        assert any("lambda_u" in n for n in names)
    if flags.get("use_pos_emb"):
        assert any("wpe" in n for n in names)
    if flags.get("use_coocurrence"):
        assert any("coocc" in n for n in names)


@pytest.mark.parametrize("name", ["ParticleFormer", "FusedParticleFormer",
                                  "FlavorFormer", "KinFormer", "EPiC"])
def test_pad_invariance(name):
    """Changing features at padded slots must not change real outputs."""
    cfg = cfg_for(name)
    model = build_model(cfg)
    st = state_for(seed=3)
    params = model.init(jax.random.PRNGKey(0), st)

    m = np.asarray(st.mask)
    dirty = st.replace(
        continuous=st.continuous + 7.0 * (1 - st.mask),
        discrete=(st.discrete + 3 * (1 - st.mask)).astype(jnp.int32) % 9,
    )
    out_clean = model.apply(params, st)
    out_dirty = model.apply(params, dirty)

    def check(a, b):
        a, b = np.asarray(a), np.asarray(b)
        real = np.broadcast_to(m, a.shape[:2] + (1,))[..., 0] > 0
        np.testing.assert_allclose(a[real], b[real], rtol=2e-4, atol=2e-5)

    jax.tree.map(check, out_clean, out_dirty)


def test_lund_observables_symmetric():
    st = state_for(seed=4)
    U = lund_observables(st, [0.0, 0.0, 0.0], [1.0, 1.0, 1.0])
    assert U.shape == (4, 6, 6, 2)
    u = np.asarray(U)
    # pairwise dR symmetric -> log dR channel symmetric
    np.testing.assert_allclose(u[..., 1], np.swapaxes(u[..., 1], 1, 2),
                               rtol=1e-4, atol=1e-5)


def test_grad_flows_through_all_models():
    for name in ["ParticleFormer", "EPiC", "FlavorFormer", "KinFormer"]:
        cfg = cfg_for(name)
        model = build_model(cfg)
        st = state_for()
        params = model.init(jax.random.PRNGKey(0), st)

        def loss(p):
            out = model.apply(p, st)
            return sum(jnp.sum(o**2) for o in jax.tree.leaves(out))

        g = jax.grad(loss)(params)
        gnorm = sum(float(jnp.abs(x).sum()) for x in jax.tree.leaves(g))
        assert np.isfinite(gnorm) and gnorm > 0, name


def test_remat_equivalence():
    """remat=True must not change outputs or gradients (only memory)."""
    st = state_for()
    cfg = cfg_for("ParticleFormer")
    cfg_r = cfg_for("ParticleFormer", remat=True)
    model = build_model(cfg)
    model_r = build_model(cfg_r)
    params = model.init(jax.random.PRNGKey(0), st)

    out = model.apply(params, st)
    out_r = model_r.apply(params, st)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6), out, out_r)

    def loss(m):
        def f(p):
            vt, logits = m.apply(p, st)
            return (vt**2).sum() + (logits**2).sum()
        return f

    g = jax.grad(loss(model))(params)
    g_r = jax.grad(loss(model_r))(params)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5), g, g_r)


def test_attention_prob_dropout():
    """Attention-probability dropout parity (reference passes
    dropout_p=config.dropout into SDPA, `networks/attention.py:69`):
    with dropout > 0 the training forward is stochastic beyond the
    residual dropout alone, and eval is deterministic."""
    from multimodal_flows.models.attention import SelfAttention

    x = jnp.asarray(np.random.default_rng(0).normal(size=(2, 6, 16)),
                    jnp.float32)

    attn = SelfAttention(16, 2, dropout=0.0, attn_dropout=0.5)
    p = attn.init(jax.random.PRNGKey(0), x)
    det = attn.apply(p, x, deterministic=True)
    r1 = attn.apply(p, x, deterministic=False,
                    rngs={"dropout": jax.random.PRNGKey(1)})
    r2 = attn.apply(p, x, deterministic=False,
                    rngs={"dropout": jax.random.PRNGKey(2)})
    # residual dropout is 0 here, so any stochasticity comes from the probs
    assert np.abs(np.asarray(r1) - np.asarray(det)).max() > 0
    assert np.abs(np.asarray(r1) - np.asarray(r2)).max() > 0

    # attn_dropout defaults to dropout (reference ties both to config.dropout)
    tied = SelfAttention(16, 2, dropout=0.3)
    assert tied.attn_dropout is None
    # deterministic path ignores dropout entirely
    p2 = tied.init(jax.random.PRNGKey(0), x)
    np.testing.assert_allclose(np.asarray(tied.apply(p2, x, deterministic=True)),
                               np.asarray(tied.apply(p2, x, deterministic=True)))
