"""Smoke tests for the plotting suite (reference parity:
`utils/plotting.py`)."""

import os

import matplotlib.pyplot as plt
import numpy as np

from multimodal_flows.data.state import MultiModal
from multimodal_flows.utils.jet_features import JetChargeDipole, JetFeatures
from multimodal_flows.utils.plotting import (
    flavor_kinematics,
    plot_charge_features,
    plot_flavor_feats,
    plot_jet_features,
    plot_kin_feats,
    plot_trajectories,
)
from tests.test_jet_features import make_clouds


def test_flavor_and_kin_plots(tmp_path):
    gen = make_clouds(B=30, D=15, seed=0)
    ref = make_clouds(B=30, D=15, seed=1)
    p1 = str(tmp_path / "flavor.png")
    fig = plot_flavor_feats(gen, ref, path=p1)
    assert os.path.exists(p1) and os.path.getsize(p1) > 0
    plt.close(fig)

    gf, rf = JetFeatures(gen), JetFeatures(ref)
    p2 = str(tmp_path / "kin.png")
    fig = plot_kin_feats(gf, rf, path=p2)
    assert os.path.exists(p2)
    plt.close(fig)

    p3 = str(tmp_path / "jets.png")
    fig = plot_jet_features(gf, rf, path=p3)
    assert os.path.exists(p3)
    plt.close(fig)

    p4 = str(tmp_path / "flavor_kin.png")
    fig = flavor_kinematics(gf, rf, path=p4)
    assert os.path.exists(p4)
    plt.close(fig)

    p5 = str(tmp_path / "charge.png")
    fig = plot_charge_features(JetChargeDipole(gf), JetChargeDipole(rf), path=p5)
    assert os.path.exists(p5)
    plt.close(fig)


def test_plot_trajectories(tmp_path):
    T, N = 8, 40
    rng = np.random.default_rng(0)
    traj = MultiModal(
        continuous=rng.normal(size=(T, N, 1, 2)).astype(np.float32).cumsum(0),
        discrete=rng.integers(1, 3, size=(T, N, 1, 1)).astype(np.int32),
        mask=np.ones((T, N, 1, 1), np.int32),
    )
    p = str(tmp_path / "traj.png")
    fig = plot_trajectories(traj, path=p)
    assert os.path.exists(p)
    plt.close(fig)
