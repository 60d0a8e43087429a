"""Packed TRAINING: per-jet loss/grad parity + end-to-end fit.

Round-4 extension of multi-jet packing from the sampler into the train
step (VERDICT r3 #1).  The invariants pinned here make it legal:

- per-token time: each jet draws its own t; packed rows scatter per-jet
  times to tokens, and the time embedding / bridge math broadcast them
- per-jet loss normalization: masked MSE/CE per jet recovered through
  segment sums equals the unpacked per-jet losses
- the multitask combination over (jets in the batch) is identical, so the
  packed loss AND its parameter gradient match the unpacked path exactly
  (same jets, same per-jet t, fp32 tolerance)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_flows.config import Config
from multimodal_flows.data.datasets import ArrayDataset
from multimodal_flows.data.packing import (
    PackedJets,
    pack_multimodal,
    pad_rows,
    singleton_rows,
)
from multimodal_flows.data.state import DataCoupling, MultiModal
from multimodal_flows.train.systems import MMF, build_system
from multimodal_flows.train.trainer import Trainer


def _mk_cfg(**kw):
    base = dict(model="ParticleFormer", n_embd=32, n_inner=64, n_layer=2,
                n_layer_fused=2, n_head=2, vocab_size=9, dim_continuous=3,
                max_num_particles=24, batch_size=4, compute_dtype="float32",
                dropout=0.0, multitask_loss="time-weighted")
    base.update(kw)
    return Config(**base)


def _make_jets(mults, D, seed=0):
    rng = np.random.default_rng(seed)
    N = len(mults)
    mask = (np.arange(D)[None, :] < np.asarray(mults)[:, None]).astype(np.int32)[..., None]
    x = (rng.normal(size=(N, D, 3)) * mask).astype(np.float32)
    k = (rng.integers(1, 9, (N, D, 1)) * mask).astype(np.int32)
    return MultiModal(continuous=x, discrete=k, mask=mask)


def _packed_twin(jets, t_jets, xt, kt, drift, W):
    """Pack a constructed training state (xt, kt, drift per jet) into rows,
    returning everything the packed loss needs."""
    packed, leftover = pack_multimodal(jets, W)
    assert len(leftover) == 0
    # re-scatter the *state* arrays (xt/kt/drift) into the same layout by
    # packing MultiModals that carry them
    st = pack_multimodal(jets.replace(continuous=xt, discrete=kt), W)[0]
    dr = pack_multimodal(jets.replace(continuous=drift), W)[0]
    # per-(row, slot) jet time: invert the layout via segment ids + the
    # jet order (row, offset); pack_multimodal assigns slots in offset order
    from multimodal_flows.data.packing import pack_jets
    mult = np.asarray(jets.mask)[..., 0].sum(1)
    row_of, offset_of, n_rows = pack_jets(mult, W)
    J = packed.jet_valid.shape[1]
    t_slots = np.zeros((n_rows, J), np.float32)
    order = np.lexsort((offset_of, row_of))
    prev, s = -1, 0
    for j in order:
        r = int(row_of[j])
        s = s + 1 if r == prev else 0
        prev = r
        t_slots[r, s] = t_jets[j]
    return packed, st, dr, t_slots, (row_of, offset_of)


class TestMMFPackedParity:
    def test_loss_and_grad_parity(self):
        """Packed training loss == unpacked loss on the same jets with the
        same per-jet t — value and parameter gradient (fp32)."""
        cfg = _mk_cfg()
        system = MMF(cfg)
        params = system.init_params(jax.random.PRNGKey(0))

        mults = [5, 9, 3, 7, 12, 4, 6, 8]
        D, W = 24, 24
        jets = _make_jets(mults, D, seed=1)
        rng = np.random.default_rng(2)
        N = len(mults)
        t_jets = (0.05 + 0.9 * rng.random(N)).astype(np.float32)
        mask = np.asarray(jets.mask)
        xt = (rng.normal(size=(N, D, 3)) * mask).astype(np.float32)
        kt = (rng.integers(1, 9, (N, D, 1)) * mask).astype(np.int32)
        drift = (rng.normal(size=(N, D, 3)) * mask).astype(np.float32)

        # ---- unpacked
        state_u = MultiModal(time=jnp.asarray(t_jets), continuous=jnp.asarray(xt),
                             discrete=jnp.asarray(kt), mask=jnp.asarray(mask))

        def loss_u(p):
            out = system.module.apply(p, state_u, jnp.asarray(drift),
                                      jnp.asarray(jets.discrete),
                                      method="training_loss")
            return out[0]

        # ---- packed
        packed, st, dr, t_slots, _ = _packed_twin(jets, t_jets, xt, kt, drift, W)
        J = packed.jet_valid.shape[1]
        slot = np.clip(packed.segments, 0, J - 1)
        t_tok = np.take_along_axis(t_slots, slot, axis=1)
        state_p = MultiModal(time=jnp.asarray(t_tok),
                             continuous=jnp.asarray(st.continuous),
                             discrete=jnp.asarray(st.discrete),
                             mask=jnp.asarray(packed.mask))

        def loss_p(p):
            out = system.module.apply(
                p, state_p, jnp.asarray(dr.continuous),
                jnp.asarray(packed.discrete), jnp.asarray(t_slots),
                jnp.asarray(packed.segments), jnp.asarray(packed.jet_valid),
                method="packed_training_loss")
            return out[0]

        lu, gu = jax.value_and_grad(loss_u)(params)
        lp, gp = jax.value_and_grad(loss_p)(params)
        np.testing.assert_allclose(float(lp), float(lu), rtol=2e-5)
        flat_u = jax.tree.leaves(gu)
        flat_p = jax.tree.leaves(gp)
        for a, b in zip(flat_u, flat_p):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       rtol=5e-4, atol=1e-5)

    @pytest.mark.parametrize("mode", ["sum", "weighted"])
    def test_loss_parity_other_multitask_modes(self, mode):
        cfg = _mk_cfg(multitask_loss=mode)
        system = MMF(cfg)
        params = system.init_params(jax.random.PRNGKey(0))
        mults = [4, 7, 3, 6]
        D, W = 24, 24
        jets = _make_jets(mults, D, seed=3)
        rng = np.random.default_rng(4)
        N = len(mults)
        t_jets = (0.1 + 0.8 * rng.random(N)).astype(np.float32)
        mask = np.asarray(jets.mask)
        xt = (rng.normal(size=(N, D, 3)) * mask).astype(np.float32)
        kt = (rng.integers(1, 9, (N, D, 1)) * mask).astype(np.int32)
        drift = (rng.normal(size=(N, D, 3)) * mask).astype(np.float32)

        state_u = MultiModal(time=jnp.asarray(t_jets), continuous=jnp.asarray(xt),
                             discrete=jnp.asarray(kt), mask=jnp.asarray(mask))
        lu = system.module.apply(params, state_u, jnp.asarray(drift),
                                 jnp.asarray(jets.discrete),
                                 method="training_loss")[0]

        packed, st, dr, t_slots, _ = _packed_twin(jets, t_jets, xt, kt, drift, W)
        J = packed.jet_valid.shape[1]
        t_tok = np.take_along_axis(t_slots, np.clip(packed.segments, 0, J - 1), axis=1)
        state_p = MultiModal(time=jnp.asarray(t_tok),
                             continuous=jnp.asarray(st.continuous),
                             discrete=jnp.asarray(st.discrete),
                             mask=jnp.asarray(packed.mask))
        lp = system.module.apply(
            params, state_p, jnp.asarray(dr.continuous),
            jnp.asarray(packed.discrete), jnp.asarray(t_slots),
            jnp.asarray(packed.segments), jnp.asarray(packed.jet_valid),
            method="packed_training_loss")[0]
        np.testing.assert_allclose(float(lp), float(lu), rtol=2e-5)


def test_bridge_per_token_time_matches_per_jet():
    """Bridge math with per-token (B, D) time == per-jet (B,) time when
    every token of a jet shares the jet's t."""
    from multimodal_flows.dynamics.bridges import RandomTelegraphBridge

    bridge = RandomTelegraphBridge(0.1, 9)
    rng = np.random.default_rng(0)
    B, D = 3, 6
    k0 = jnp.asarray(rng.integers(1, 9, (B, D, 1)), jnp.int32)
    k1 = jnp.asarray(rng.integers(1, 9, (B, D, 1)), jnp.int32)
    t = jnp.asarray([0.2, 0.5, 0.9], jnp.float32)
    p_jet = bridge.transition_probability(t, k0, k1)
    t_tok = jnp.broadcast_to(t[:, None], (B, D))
    p_tok = bridge.transition_probability(t_tok, k0, k1)
    np.testing.assert_allclose(np.asarray(p_tok), np.asarray(p_jet), rtol=1e-6)


def test_time_token_embedding_shapes():
    from multimodal_flows.models.blocks import time_token_embedding, timestep_embedding

    t1 = jnp.asarray([0.1, 0.7])
    e1 = time_token_embedding(t1, 16)
    assert e1.shape == (2, 1, 16)
    t2 = jnp.asarray([[0.1, 0.3], [0.7, 0.9]])
    e2 = time_token_embedding(t2, 16)
    assert e2.shape == (2, 2, 16)
    # per-token rows embed exactly like the flat call on the same values
    np.testing.assert_allclose(np.asarray(e2[0, 1]),
                               np.asarray(timestep_embedding(jnp.asarray([0.3]), 16)[0]),
                               rtol=1e-6)


def test_singleton_rows_and_pad_rows():
    jets = _make_jets([4, 6], 8, seed=5)
    rows = singleton_rows(jets)
    assert rows.jet_valid.shape == (2, 1)
    assert (np.asarray(rows.segments)[0, :4] == 0).all()
    assert (np.asarray(rows.segments)[0, 4:] == -1).all()
    padded = pad_rows(rows, 8)
    assert len(padded) == 8
    assert (np.asarray(padded.segments)[2:] == -1).all()
    assert (np.asarray(padded.jet_valid)[2:] == 0).all()
    assert (np.asarray(padded.mask)[2:] == 0).all()


def test_pack_multimodal_layout():
    jets = _make_jets([5, 9, 3, 7, 12, 4], 24, seed=6)
    packed, leftover = pack_multimodal(jets, 12)
    assert len(leftover) == 0
    # token conservation: every real particle lands exactly once
    assert int(np.asarray(packed.mask).sum()) == int(np.asarray(jets.mask).sum())
    assert int(np.asarray(packed.jet_valid).sum()) == 6
    # payload conservation (set equality of (token, kinematics) rows)
    src = np.asarray(jets.continuous)[np.asarray(jets.mask)[..., 0] > 0]
    dst = np.asarray(packed.continuous)[np.asarray(packed.mask)[..., 0] > 0]
    np.testing.assert_allclose(np.sort(src.ravel()), np.sort(dst.ravel()))
    # oversized jets are left over
    packed2, leftover2 = pack_multimodal(jets, 8)
    assert set(leftover2) == {1, 4}  # mults 9 and 12 > 8


def test_fit_packed_end_to_end_loss_decreases():
    """Trainer.fit with packed_training=True runs (incl. an oversized-jet
    singleton unit) and the loss decreases."""
    cfg = _mk_cfg(batch_size=8, max_epochs=6, lr=1e-3, lr_final=1e-4,
                  packed_training=True, pack_width=16, max_num_particles=24,
                  use_ema_weights=True)
    rng = np.random.default_rng(7)
    mults = np.clip(rng.poisson(8, 64), 2, 24)
    mults[:3] = [20, 22, 24]  # force an oversized (>pack_width) unit
    jets = _make_jets(mults, 24, seed=8)
    ds = ArrayDataset(DataCoupling(source=MultiModal(mask=jets.mask), target=jets))
    train_ds, val_ds = ds.split(0.8, seed=0)

    system = MMF(cfg)
    trainer = Trainer(system, cfg, mesh=None)
    import os, tempfile
    with tempfile.TemporaryDirectory() as d:
        cfg.dir = d
        state = trainer.fit(train_ds, val_ds)
    # loss decreased over training
    logs = trainer  # metrics via logger files are in tmp; recompute directly
    key = jax.random.PRNGKey(123)
    packed_units = trainer._pack_units(train_ds)
    batch = packed_units[0].coupling[np.arange(min(8, len(packed_units[0])))]
    l_final, _ = system.loss_fn(state.params, batch, key, train=False)
    p0 = system.init_params(jax.random.PRNGKey(0))
    l_init, _ = system.loss_fn(p0, batch, key, train=False)
    assert float(l_final) < float(l_init)


def test_fit_packed_matches_metric_names():
    """Packed epochs produce the same metric keys (val_loss/_mse/_ce feed
    the same checkpoint monitors)."""
    cfg = _mk_cfg(batch_size=4, max_epochs=1, packed_training=True,
                  pack_width=24)
    rng = np.random.default_rng(9)
    mults = np.clip(rng.poisson(6, 24), 2, 12)
    jets = _make_jets(mults, 24, seed=10)
    ds = ArrayDataset(DataCoupling(source=MultiModal(mask=jets.mask), target=jets))
    train_ds, val_ds = ds.split(0.75, seed=0)
    system = MMF(cfg)
    trainer = Trainer(system, cfg, mesh=None)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        cfg.dir = d
        trainer.fit(train_ds, val_ds)
        import json, glob, os
        metrics_files = glob.glob(os.path.join(d, "**", "metrics.jsonl"),
                                  recursive=True)
        assert metrics_files
        rec = json.loads(open(metrics_files[0]).readlines()[-1])
    for k in ("train_loss", "val_loss", "val_loss_mse", "val_loss_ce"):
        assert k in rec, rec.keys()


@pytest.mark.parametrize("model,kind", [("KinFormer", "CFM"),
                                        ("FlavorFormer", "MJB"),
                                        ("EPiC", "CFM")])
def test_cfm_mjb_packed_loss_runs_and_is_finite(model, kind):
    cfg = _mk_cfg(model=model, packed_training=True, pack_width=24,
                  n_embd_glob=8)
    system = build_system(cfg, kind)
    params = system.init_params(jax.random.PRNGKey(0))
    jets = _make_jets([5, 9, 3, 7], 24, seed=11)
    packed, _ = pack_multimodal(jets, 24)
    loss, metrics = system.loss_fn(params, packed, jax.random.PRNGKey(1))
    assert np.isfinite(float(loss))


def test_pack_units_guard_pos_emb():
    """Learned positional embeddings are incompatible with packed rows
    (absolute slots would leak across jets): _pack_units must decline and
    fit must fall back to unpacked training instead of tracing a model
    that raises on segments + use_pos_emb."""
    cfg = _mk_cfg(model="FlavorFormer", packed_training=True, pack_width=24,
                  use_pos_emb=True, use_pairwise=True)
    system = build_system(cfg, "MJB")
    trainer = Trainer(system, cfg, mesh=None)
    jets = _make_jets([5, 9, 3, 7], 24, seed=3).replace(continuous=None)
    ds = ArrayDataset(DataCoupling(source=MultiModal(mask=jets.mask),
                                   target=jets))
    assert trainer._pack_units(ds) is None


def test_pack_units_preserve_jets_per_step():
    """`batch_size` means JETS per optimizer step in packed mode: rows
    carry multiple jets, so the row batch shrinks by the realized packing
    density (measured on the r04 flagship: batching batch_size ROWS cut
    steps/epoch ~2.9x, stretched the EMA horizon, and degraded W1(pt)
    0.82 -> 8.35)."""
    cfg = _mk_cfg(batch_size=12, packed_training=True, pack_width=24,
                  max_num_particles=24)
    trainer = Trainer(MMF(cfg), cfg, mesh=None)
    # 32 jets of mult 6 -> 4 jets/row at W=24
    jets = _make_jets([6] * 32, 24, seed=2)
    ds = ArrayDataset(DataCoupling(source=MultiModal(mask=jets.mask),
                                   target=jets))
    units = trainer._pack_units(ds)
    assert units is not None
    assert trainer._packed_row_bs == 3  # 12 jets/step / 4 jets/row
    # rows padded to the ROW batch multiple, not cfg.batch_size
    assert len(units[0]) % 3 == 0
