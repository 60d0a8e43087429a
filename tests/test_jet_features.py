"""Tests for the physics evaluation layer: metrics, jetkit substructure
(native vs numpy cross-check), jet features (reference parity:
`utils/aoj.py:323-872`, `utils/metrics.py`)."""

import numpy as np
import pytest

from multimodal_flows.data.state import MultiModal
from multimodal_flows.utils import jet_substructure as jk
from multimodal_flows.utils.jet_features import (
    EnergyCorrelationFunctions,
    JetChargeDipole,
    JetFeatures,
    ParticleClouds,
)
from multimodal_flows.utils.metrics import (
    flavor_multiplicities,
    wasserstein1d,
    wasserstein_flavor,
)


def make_clouds(B=12, D=20, seed=0):
    rng = np.random.default_rng(seed)
    n = rng.integers(4, D + 1, size=B)
    mask = (np.arange(D)[None, :] < n[:, None]).astype(np.int32)[..., None]
    pt = rng.uniform(1, 50, size=(B, D)) * mask[..., 0]
    eta = rng.uniform(-0.5, 0.5, size=(B, D)) * mask[..., 0]
    phi = rng.uniform(-0.5, 0.5, size=(B, D)) * mask[..., 0]
    cont = np.stack([pt, eta, phi], axis=-1).astype(np.float32)
    disc = (rng.integers(1, 9, size=(B, D, 1)) * mask).astype(np.int32)
    return MultiModal(continuous=cont, discrete=disc, mask=mask)


def test_native_library_loads():
    assert jk.load_library() is not None, "libjetkit.so missing — run make -C native"


def test_substructure_native_matches_numpy():
    clouds = make_clouds(B=6, D=10)
    pt = clouds.continuous[..., 0]
    eta = clouds.continuous[..., 1]
    phi = clouds.continuous[..., 2]
    native = jk.substructure(pt, eta, phi)
    fallback = jk.substructure(pt, eta, phi, force_numpy=True)
    for k in native:
        np.testing.assert_allclose(native[k], fallback[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_substructure_sanity():
    clouds = make_clouds(B=16, D=30, seed=3)
    pt = clouds.continuous[..., 0]
    sub = jk.substructure(pt, clouds.continuous[..., 1], clouds.continuous[..., 2])
    t1, t21, t32 = sub["tau1"], sub["tau21"], sub["tau32"]
    ok = np.isfinite(t1)
    assert ok.all()
    assert np.all(t1[ok] >= 0)
    # subjettiness ratios in [0, ~1]
    assert np.nanmax(t21) <= 1.0 + 1e-5
    assert np.nanmax(t32) <= 1.0 + 1e-5
    # tau decreases with more axes
    assert np.all(sub["tau2"] <= sub["tau1"] + 1e-6)
    assert np.all(sub["tau3"] <= sub["tau2"] + 1e-6)


def test_substructure_few_particles_nan():
    pt = np.array([[10.0, 5.0, 0, 0]])
    eta = np.zeros((1, 4))
    phi = np.zeros((1, 4))
    sub = jk.substructure(pt, eta, phi)
    assert np.isnan(sub["tau1"][0])


def test_particle_clouds_views():
    clouds = make_clouds()
    pc = ParticleClouds(clouds)
    assert pc.multiplicity.min() >= 4
    # four-momentum consistency: E^2 = px^2+py^2+pz^2 (massless)
    p2 = pc.px**2 + pc.py**2 + pc.pz**2
    np.testing.assert_allclose(pc.E[pc.mask_bool] ** 2, p2[pc.mask_bool], rtol=1e-4)
    # charge assignment
    assert set(np.unique(pc.charge)) <= {-1.0, 0.0, 1.0}
    neg = pc.isNegative
    assert np.all(pc.charge[neg] == -1)
    # flavor counts sum to multiplicity
    total = sum(getattr(pc, f"num_{n}") for n in
                ["Photon", "NeutralHadron", "NegativeHadron", "PositiveHadron",
                 "Electron", "Positron", "Muon", "AntiMuon"])
    np.testing.assert_array_equal(total, pc.multiplicity)


def test_jet_features():
    clouds = make_clouds(B=10, D=15, seed=5)
    jf = JetFeatures(clouds)
    assert jf.pt.shape == (10,)
    assert np.all(jf.pt > 0)
    assert np.all(np.isfinite(jf.m))
    assert hasattr(jf, "tau21") and hasattr(jf, "c1") and hasattr(jf, "d2")
    # W1 against itself is 0
    assert jf.Wassertein1D("pt", jf) == pytest.approx(0.0)
    counts = jf.flavor_counts()
    np.testing.assert_array_equal(counts[:, 1:].sum(1), jf.numParticles)


def test_flavor_multiplicities_and_w1():
    clouds = make_clouds(B=50, seed=7)
    feats = flavor_multiplicities(clouds)
    assert len(feats) == 16
    np.testing.assert_array_equal(
        feats["negatives"] - feats["positives"], feats["net charge"])
    w1 = wasserstein_flavor(clouds, clouds)
    assert all(v == pytest.approx(0.0) for v in w1.values())


def test_wasserstein1d_analytic():
    x = np.zeros(100)
    y = np.ones(100)
    assert wasserstein1d(x, y) == pytest.approx(1.0)


def test_ecf_and_dipole():
    clouds = make_clouds(B=20, seed=9)
    ecf = EnergyCorrelationFunctions(clouds)
    auto, pt2 = ecf.compute_ecf("hadron")
    assert auto.shape == pt2.shape
    assert np.all(auto >= 0)
    cross, _ = ecf.compute_ecf("positive", "negative")
    assert np.all(cross >= 0)

    jf = JetFeatures(clouds, compute_substructure=False)
    dip = JetChargeDipole(jf)
    q0, qk, d2 = dip.charge_and_dipole()
    assert q0.shape == qk.shape == d2.shape
    assert np.all(np.isfinite(qk))
    # Q0 integer-valued (sum of +-1 charges)
    assert np.allclose(q0, np.round(q0))
