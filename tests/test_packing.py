"""Block-diagonal multi-jet packing: parity + round-trip tests.

Packing puts several low-multiplicity jets into one `pack_width`-token
attention row behind a same-segment mask (`ops/attention.py` `segments`).
These tests pin the invariant that makes it legal: the packed forward
equals the unpacked forward per jet to float tolerance, for every
packable encoder, and the pack/unpack plumbing is lossless.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_flows.config import Config
from multimodal_flows.data.state import MultiModal
from multimodal_flows.sampling.generator import (
    _build_packed_rows,
    _unpack_rows,
    generate_packed,
    pack_jets,
)
from multimodal_flows.train.systems import MMF, build_system


def _mk_cfg(**kw):
    base = dict(model="ParticleFormer", n_embd=32, n_inner=64, n_layer=2,
                n_layer_fused=2, n_head=2, vocab_size=9, dim_continuous=3,
                max_num_particles=24, batch_size=4, compute_dtype="float32",
                dropout=0.0)
    base.update(kw)
    return Config(**base)


def _first_n_masks(mults, D):
    return (np.arange(D)[None, :] < np.asarray(mults)[:, None]
            ).astype(np.int64)[..., None]


def _pack_states(key, cfg, mults, W):
    """Build an unpacked batch of jets and its packed single-row twin."""
    D = cfg.max_num_particles
    N = len(mults)
    masks = _first_n_masks(mults, D)
    kx, kk = jax.random.split(key)
    x = np.asarray(jax.random.normal(kx, (N, D, cfg.dim_continuous))) * masks
    k = np.asarray(jax.random.randint(kk, (N, D, 1), 1, cfg.vocab_size)) * masks

    t = 0.37
    unpacked = MultiModal(
        time=jnp.full((N,), t, jnp.float32),
        continuous=jnp.asarray(x, jnp.float32),
        discrete=jnp.asarray(k, jnp.int32),
        mask=jnp.asarray(masks, jnp.int32),
    )

    row_of, offset_of, n_rows = pack_jets(np.asarray(mults), W)
    assert n_rows >= 1 and (row_of >= 0).all()
    row_mask, row_seg = _build_packed_rows(masks, row_of, offset_of, n_rows, W)
    px = np.zeros((n_rows, W, cfg.dim_continuous), np.float32)
    pk = np.zeros((n_rows, W, 1), np.int32)
    for j, m in enumerate(mults):
        r, o = int(row_of[j]), int(offset_of[j])
        px[r, o:o + m] = x[j, :m]
        pk[r, o:o + m] = k[j, :m]
    packed = MultiModal(
        time=jnp.full((n_rows,), t, jnp.float32),
        continuous=jnp.asarray(px),
        discrete=jnp.asarray(pk),
        mask=jnp.asarray(row_mask, jnp.int32),
    )
    return unpacked, packed, jnp.asarray(row_seg), (row_of, offset_of, masks)


@pytest.mark.parametrize("model,system_kind", [
    ("ParticleFormer", "MMF"),
    ("FusedParticleFormer", "MMF"),
    ("KinFormer", "CFM"),
    ("FlavorFormer", "MJB"),
])
def test_packed_forward_parity(model, system_kind):
    """Packed forward == per-jet unpacked forward (fp32, same params)."""
    cfg = _mk_cfg(model=model)
    system = build_system(cfg, system_kind)
    params = system.init_params(jax.random.PRNGKey(0))
    mults = [5, 9, 3, 7, 12, 4]
    W = 24
    unpacked, packed, seg, (row_of, offset_of, _) = _pack_states(
        jax.random.PRNGKey(1), cfg, mults, W)

    ref = system.module.apply(params, unpacked)
    out = system.module.apply(params, packed, segments=seg)

    ref_heads = ref if isinstance(ref, tuple) else (ref,)
    out_heads = out if isinstance(out, tuple) else (out,)
    for ref_h, out_h in zip(ref_heads, out_heads):
        ref_h, out_h = np.asarray(ref_h), np.asarray(out_h)
        for j, m in enumerate(mults):
            r, o = int(row_of[j]), int(offset_of[j])
            np.testing.assert_allclose(
                out_h[r, o:o + m], ref_h[j, :m], rtol=2e-4, atol=2e-5,
                err_msg=f"{model}: jet {j} mismatch")


def test_packed_forward_parity_pairwise_kinformer():
    """KinFormer with the Lund pairwise bias stays per-jet exact under
    packing (cross-jet bias entries are masked by the segment mask)."""
    cfg = _mk_cfg(model="KinFormer", use_pairwise=True,
                  metadata={"mean": [1.0, 0.0, 0.0], "std": [2.0, 1.0, 1.0]})
    system = build_system(cfg, "CFM")
    params = system.init_params(jax.random.PRNGKey(0))
    mults = [6, 4, 8, 3]
    unpacked, packed, seg, (row_of, offset_of, _) = _pack_states(
        jax.random.PRNGKey(2), cfg, mults, 24)

    ref = np.asarray(system.module.apply(params, unpacked))
    out = np.asarray(system.module.apply(params, packed, segments=seg))
    for j, m in enumerate(mults):
        r, o = int(row_of[j]), int(offset_of[j])
        np.testing.assert_allclose(out[r, o:o + m], ref[j, :m],
                                   rtol=2e-4, atol=2e-5)


def test_pack_jets_properties():
    rng = np.random.default_rng(0)
    mult = np.clip(rng.poisson(40, size=500), 1, 150)
    W = 128
    row_of, offset_of, n_rows = pack_jets(mult, W)
    packable = mult <= W
    assert (row_of[packable] >= 0).all()
    assert (row_of[~packable] == -1).all()
    # rows never overflow and jets never overlap
    fill = np.zeros(n_rows, np.int64)
    slots = np.zeros((n_rows, W), np.int64)
    for j in np.where(packable)[0]:
        r, o, m = row_of[j], offset_of[j], mult[j]
        slots[r, o:o + m] += 1
        fill[r] += m
    assert (fill <= W).all()
    assert slots.max() == 1
    # packing efficiency: BFD on Poisson(40) mults should waste little
    assert mult[packable].sum() / (n_rows * W) > 0.85


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(1)
    mult = np.clip(rng.poisson(10, size=40), 1, 24)
    D, W = 24, 32
    masks = _first_n_masks(mult, D)
    row_of, offset_of, n_rows = pack_jets(mult, W)
    row_mask, row_seg = _build_packed_rows(masks, row_of, offset_of, n_rows, W)
    assert (row_mask[..., 0].sum(1) == np.bincount(
        row_of, weights=mult, minlength=n_rows)).all()

    # fill rows with per-token payload, unpack, compare
    payload = rng.normal(size=(n_rows, W, 3)).astype(np.float32) * row_mask
    tokens = (rng.integers(1, 9, size=(n_rows, W, 1)) * row_mask).astype(np.int32)
    rows = MultiModal(continuous=payload, discrete=tokens, mask=row_mask)
    out = _unpack_rows(rows, masks, row_of, offset_of, W)
    assert out.continuous.shape == (40, D, 3)
    for j in range(40):
        r, o, m = int(row_of[j]), int(offset_of[j]), int(mult[j])
        np.testing.assert_array_equal(out.continuous[j, :m], payload[r, o:o + m])
        np.testing.assert_array_equal(out.discrete[j, :m], tokens[r, o:o + m])
        assert (out.continuous[j, m:] == 0).all()


def test_generate_packed_end_to_end():
    """Packed generation runs, returns the right shapes/masks, and fills
    real slots with finite kinematics + valid tokens."""
    cfg = _mk_cfg()
    system = MMF(cfg)
    params = system.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    mult = np.clip(rng.poisson(8, size=30), 1, 24)
    masks = _first_n_masks(mult, cfg.max_num_particles)

    res = generate_packed(system, params, masks, num_timesteps=8,
                          pack_width=24, batch_size=4, seed=0,
                          metadata={"mean": [0.0, 0.0, 0.0],
                                    "std": [1.0, 1.0, 1.0]})
    s = res.sample
    assert s.continuous.shape == (30, cfg.max_num_particles, 3)
    np.testing.assert_array_equal(np.asarray(s.mask), masks)
    real = masks[..., 0].astype(bool)
    assert np.isfinite(np.asarray(s.continuous)).all()
    toks = np.asarray(s.discrete)[..., 0]
    # telegraph jumps can land on any class incl. 0 for an untrained model
    assert ((toks[real] >= 0) & (toks[real] < cfg.vocab_size)).all()
    assert (toks[~real] == 0).all()
    assert (np.asarray(s.continuous)[~real] == 0).all()


def test_rebalanced_batch():
    """Pad-tail rebalance: the last scan batch must not be mostly empty
    rows riding the full forward."""
    from multimodal_flows.sampling.generator import _rebalanced_batch

    # the bench shape: 674 rows at B=256 -> 3 batches of 232 (696 total,
    # not 768)
    assert _rebalanced_batch(674, 256) == 232
    assert 3 * 232 >= 674
    # even split already: no change
    assert _rebalanced_batch(512, 256) == 256
    # saving exists (64 rows) but is <5% of the padded total: keep the
    # round compile signature
    assert _rebalanced_batch(1976, 256) == 256
    # single batch: untouched (the _snap_batch ladder owns that case)
    assert _rebalanced_batch(100, 256) == 256
    # production scale: ceil(32900/129)=256 -> unchanged
    assert _rebalanced_batch(32900, 256) == 256
    # mesh granularity: balanced size stays divisible by the data axis
    assert _rebalanced_batch(674, 256, gran=32) % 32 == 0


def test_generate_packed_rebalanced_end_to_end():
    """Packed generation through a rebalance-triggering row count still
    returns every jet with intact masks (the rebalanced batch covers all
    rows; nothing is dropped at the n_rows cut)."""
    cfg = _mk_cfg()
    system = MMF(cfg)
    params = system.init_params(jax.random.PRNGKey(0))
    # all jets at full width -> one row each -> n_rows = N = 130;
    # B=128 -> 2 batches, rebalanced to 72
    N = 130
    mult = np.full(N, cfg.max_num_particles)
    masks = _first_n_masks(mult, cfg.max_num_particles)
    res = generate_packed(system, params, masks, num_timesteps=2,
                          pack_width=cfg.max_num_particles, batch_size=128,
                          seed=0)
    s = res.sample
    assert s.continuous.shape == (N, cfg.max_num_particles, 3)
    np.testing.assert_array_equal(np.asarray(s.mask), masks)
    assert np.isfinite(np.asarray(s.continuous)).all()


def test_generate_packed_falls_back_for_pos_emb():
    """use_pos_emb models can't pack; the driver falls back to bucketed."""
    cfg = _mk_cfg(model="FlavorFormer", use_pos_emb=True)
    system = build_system(cfg, "MJB")
    params = system.init_params(jax.random.PRNGKey(0))
    mult = np.asarray([4, 6, 3, 5])
    masks = _first_n_masks(mult, cfg.max_num_particles)
    res = generate_packed(system, params, masks, num_timesteps=4,
                          batch_size=4, seed=0)
    assert res.sample.discrete.shape == (4, cfg.max_num_particles, 1)


def test_generate_packed_handles_pairwise(monkeypatch):
    """Pairwise-bias encoders sample on the PACKED path since round 4: the
    co-occurrence bias gathers a pre-projected 45-row table (no (B,D,D,E)
    tensor) and the Lund pair-MLP runs in query-row chunks, so the round-3
    HBM blowup is gone and the fallback was removed."""
    import multimodal_flows.sampling.generator as gen

    packed_calls = []
    real = gen._run_packed_rows

    def spy(*a, **kw):
        packed_calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(gen, "_run_packed_rows", spy)

    for cfg, kind in [
        (_mk_cfg(model="KinFormer", use_pairwise=True, pair_chunk=8,
                 metadata={"mean": [0.0] * 3, "std": [1.0] * 3}), "CFM"),
        (_mk_cfg(model="FlavorFormer", use_pairwise=True), "MJB"),
        (_mk_cfg(model="ParticleFormer", use_coocurrence=True), "MMF"),
    ]:
        system = build_system(cfg, kind)
        params = system.init_params(jax.random.PRNGKey(0))
        mult = np.asarray([4, 6, 3, 5])
        masks = _first_n_masks(mult, cfg.max_num_particles)
        n_before = len(packed_calls)
        res = gen.generate_packed(system, params, masks, num_timesteps=4,
                                  batch_size=4, seed=0)
        assert len(packed_calls) == n_before + 1, f"{cfg.model} not packed"
        assert res.sample.mask.shape == (4, cfg.max_num_particles, 1)


def test_packed_forward_parity_coocurrence():
    """ParticleFormer with the co-occurrence bias stays per-jet exact under
    packing (cross-jet bias entries are masked by the segment mask; the
    table-gather rewrite must equal the reference gather-then-project)."""
    cfg = _mk_cfg(model="ParticleFormer", use_coocurrence=True)
    system = build_system(cfg, "MMF")
    params = system.init_params(jax.random.PRNGKey(0))
    mults = [6, 4, 8, 3]
    unpacked, packed, seg, (row_of, offset_of, _) = _pack_states(
        jax.random.PRNGKey(5), cfg, mults, 24)

    ref = system.module.apply(params, unpacked)
    out = system.module.apply(params, packed, segments=seg)
    for ref_h, out_h in zip(ref, out):
        ref_h, out_h = np.asarray(ref_h), np.asarray(out_h)
        for j, m in enumerate(mults):
            r, o = int(row_of[j]), int(offset_of[j])
            np.testing.assert_allclose(out_h[r, o:o + m], ref_h[j, :m],
                                       rtol=2e-4, atol=2e-5)


def test_packed_forward_parity_epic():
    """EPiC joins the packed path (round 4): per-segment mean+sum pooling
    (`ops/pooling.py:segment_meansum_pool`) keeps the global stream per-jet,
    so the packed forward equals the per-jet unpacked forward exactly —
    the per-row pool that excluded EPiC from packing would have blended
    jets sharing a row (reference `EPiC.py:65-72`)."""
    cfg = _mk_cfg(model="EPiC", n_embd_glob=8)
    system = build_system(cfg, "CFM")
    params = system.init_params(jax.random.PRNGKey(0))
    mults = [5, 9, 3, 7, 12, 4]
    W = 24
    unpacked, packed, seg, (row_of, offset_of, _) = _pack_states(
        jax.random.PRNGKey(7), cfg, mults, W)
    J = int(np.asarray(seg).max()) + 1

    ref = np.asarray(system.module.apply(params, unpacked))
    out = np.asarray(system.module.apply(params, packed, segments=seg,
                                         num_segments=J))
    for j, m in enumerate(mults):
        r, o = int(row_of[j]), int(offset_of[j])
        np.testing.assert_allclose(out[r, o:o + m], ref[j, :m],
                                   rtol=2e-4, atol=2e-5,
                                   err_msg=f"EPiC: jet {j} mismatch")


def test_generate_packed_epic_end_to_end(monkeypatch):
    """EPiC samples on the PACKED path end-to-end (the round-3 exclusion at
    generator.py is gone) and returns finite per-jet kinematics."""
    import multimodal_flows.sampling.generator as gen

    packed_calls = []
    real = gen._run_packed_rows

    def spy(*a, **kw):
        packed_calls.append(kw.get("num_segments"))
        return real(*a, **kw)

    monkeypatch.setattr(gen, "_run_packed_rows", spy)

    cfg = _mk_cfg(model="EPiC", n_embd_glob=8)
    system = build_system(cfg, "CFM")
    params = system.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    mult = np.clip(rng.poisson(8, size=20), 1, 24)
    masks = _first_n_masks(mult, cfg.max_num_particles)
    res = gen.generate_packed(system, params, masks, num_timesteps=4,
                              pack_width=24, batch_size=4, seed=0)
    assert len(packed_calls) == 1 and packed_calls[0] is not None
    s = res.sample
    assert s.continuous.shape == (20, cfg.max_num_particles, 3)
    np.testing.assert_array_equal(np.asarray(s.mask), masks)
    assert np.isfinite(np.asarray(s.continuous)).all()
    real_slots = masks[..., 0].astype(bool)
    assert (np.asarray(s.continuous)[~real_slots] == 0).all()


def test_lund_chunking_matches_unchunked():
    """The chunked Lund pair-MLP (pair_chunk) equals the unchunked form."""
    meta = {"mean": [1.0, 0.0, 0.0], "std": [2.0, 1.0, 1.0]}
    cfg_c = _mk_cfg(model="KinFormer", use_pairwise=True, pair_chunk=8,
                    metadata=meta)
    cfg_u = _mk_cfg(model="KinFormer", use_pairwise=True, pair_chunk=0,
                    metadata=meta)
    sys_c = build_system(cfg_c, "CFM")
    sys_u = build_system(cfg_u, "CFM")
    params = sys_c.init_params(jax.random.PRNGKey(0))
    mults = [6, 4, 8, 3]
    unpacked, _, _, _ = _pack_states(jax.random.PRNGKey(6), cfg_c, mults, 24)
    out_c = np.asarray(sys_c.module.apply(params, unpacked))
    out_u = np.asarray(sys_u.module.apply(params, unpacked))
    np.testing.assert_allclose(out_c, out_u, rtol=1e-5, atol=1e-6)


def test_generate_packed_caps_dispatch_batch_at_128(monkeypatch):
    """The packed-row dispatch batch is capped at 128 rows even when the
    caller asks for more; the bucketed fallback keeps the caller's
    batch_size."""
    from multimodal_flows.sampling import generator as gen

    cfg = _mk_cfg()
    system = MMF(cfg)
    params = system.init_params(jax.random.PRNGKey(0))

    seen = {}
    real = gen._run_packed_rows

    def spy(*args, **kwargs):
        seen["batch_size"] = kwargs["batch_size"]
        return real(*args, **kwargs)

    monkeypatch.setattr(gen, "_run_packed_rows", spy)
    mult = np.full(8, cfg.max_num_particles)
    masks = _first_n_masks(mult, cfg.max_num_particles)
    gen.generate_packed(system, params, masks, num_timesteps=2,
                        pack_width=cfg.max_num_particles, batch_size=256,
                        seed=0)
    assert seen["batch_size"] <= 128
