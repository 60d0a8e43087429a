"""In-training physics eval + `best_physics` checkpoint slot.

The val-loss monitors mis-rank sample quality (CLOSURE_r03: W1(jet pT)
15.6 for the val-loss `best` slot vs 0.82 for the end-of-cosine EMA), so
the trainer can periodically sample a few thousand jets and checkpoint
the best W1(pt/mass/mult) in a `best_physics` slot beside the
reference-style monitors (`scripts/train_mmf.py:128-148`).
"""

import json
import os
import tempfile

import jax
import numpy as np
import pytest

from conftest import make_jets
from multimodal_flows.config import Config
from multimodal_flows.data.datasets import ArrayDataset
from multimodal_flows.data.state import DataCoupling, MultiModal
from multimodal_flows.train.physics_eval import (
    physics_metrics,
    reference_observables,
)
from multimodal_flows.train.systems import build_system
from multimodal_flows.train.trainer import Trainer

META = {"mean": [1.0, 0.0, 0.0], "std": [0.5, 1.0, 1.0]}


def _mk_cfg(**kw):
    base = dict(model="ParticleFormer", n_embd=32, n_inner=64, n_layer=1,
                n_layer_fused=1, n_head=2, vocab_size=9, dim_continuous=3,
                max_num_particles=16, batch_size=8, compute_dtype="float32",
                dropout=0.0, pack_width=16, metadata=dict(META))
    base.update(kw)
    return Config(**base)


@pytest.mark.parametrize("model,kind,expected", [
    ("ParticleFormer", "MMF", {"val_w1_pt", "val_w1_mass", "val_w1_mult"}),
    ("KinFormer", "CFM", {"val_w1_pt", "val_w1_mass"}),
    ("FlavorFormer", "MJB", {"val_w1_mult"}),
])
def test_physics_metrics_per_modality(model, kind, expected):
    """W1 observables follow the system's modalities: continuous gives jet
    pT/mass, discrete gives token multiplicity; the combined score is the
    ref-std-normalized mean."""
    cfg = _mk_cfg(model=model)
    system = build_system(cfg, kind)
    params = system.init_params(jax.random.PRNGKey(0))
    jets = make_jets(B=24, D=16, seed=3)
    if kind == "CFM":
        jets = jets.replace(discrete=None)
    elif kind == "MJB":
        jets = jets.replace(continuous=None)
    ref_obs = reference_observables(jets, cfg.metadata, 24)
    assert set(f"val_w1_{k}" for k in ref_obs) == expected

    out = physics_metrics(system, params, ref_obs, np.asarray(jets.mask),
                          num_timesteps=4, metadata=cfg.metadata,
                          batch_size=8, seed=0, pack_width=16)
    assert expected <= set(out)
    assert "val_w1_physics" in out
    assert all(np.isfinite(v) for v in out.values())


def test_physics_metrics_zero_for_identical_samples():
    """Scoring the reference against itself gives W1 = 0 (sanity pin of
    the observable plumbing: destandardize + JetFeatures + W1)."""
    jets = make_jets(B=32, D=16, seed=5)
    ref_obs = reference_observables(jets, META, 32)
    from multimodal_flows.utils.metrics import wasserstein1d

    for name, vals in ref_obs.items():
        assert wasserstein1d(vals, vals) == 0.0


def test_fit_writes_best_physics_slot():
    """Trainer.fit with physics_eval_every_n_epochs > 0 runs the eval,
    logs val_w1_* metrics, and fills the best_physics checkpoint slot with
    a ranked index entry."""
    cfg = _mk_cfg(batch_size=8, max_epochs=3, lr=1e-3, lr_final=1e-4,
                  use_ema_weights=True, physics_eval_every_n_epochs=2,
                  physics_eval_num_jets=24, physics_eval_num_timesteps=4)
    jets = make_jets(B=48, D=16, seed=7)
    ds = ArrayDataset(DataCoupling(source=MultiModal(mask=jets.mask), target=jets))
    train_ds, val_ds = ds.split(0.7, seed=0)
    system = build_system(cfg, "MMF")
    trainer = Trainer(system, cfg, mesh=None)
    with tempfile.TemporaryDirectory() as d:
        cfg.dir = d
        trainer.fit(train_ds, val_ds)
        ckdir = os.path.join(d, "scratch", "checkpoints")
        assert os.path.exists(os.path.join(ckdir, "best_physics"))
        index = json.load(open(os.path.join(ckdir, "index.json")))
        ranked = index["topk"]["best_physics"]
        assert ranked and all(np.isfinite(e["value"]) for e in ranked)
        # the eval ran on epochs 2 and 3 (cadence 2 + final epoch)
        assert {e["epoch"] for e in ranked} <= {2, 3}
        assert "best_physics" in index["best_values"]
        # val_w1_physics reached the metrics history
        hist = [h for h in index["history"] if "val_w1_physics" in h]
        assert len(hist) == 2


def test_physics_eval_uses_common_random_numbers(monkeypatch):
    """Every in-training eval of a run must use ONE fixed generation seed
    (common random numbers): round 5 measured per-eval reseeding to
    mis-rank — each score carried the full few-thousand-jet sampling
    variance and the argmin picked a noise dip (CLOSURE_r05 run 1,
    PHYSEVAL_CRN_r05.md).  Guards against reintroducing epoch-dependent
    seeding."""
    import multimodal_flows.train.physics_eval as pe

    seeds = []
    real = pe.physics_metrics

    def record(*a, **kw):
        seeds.append(kw.get("seed"))
        return real(*a, **kw)

    monkeypatch.setattr(pe, "physics_metrics", record)
    cfg = _mk_cfg(batch_size=8, max_epochs=4, physics_eval_every_n_epochs=1,
                  physics_eval_num_jets=16, physics_eval_num_timesteps=2)
    jets = make_jets(B=32, D=16, seed=9)
    ds = ArrayDataset(DataCoupling(source=MultiModal(mask=jets.mask), target=jets))
    train_ds, val_ds = ds.split(0.7, seed=0)
    trainer = Trainer(build_system(cfg, "MMF"), cfg, mesh=None)
    with tempfile.TemporaryDirectory() as d:
        cfg.dir = d
        trainer.fit(train_ds, val_ds)
    assert len(seeds) >= 3, "expected one eval per epoch"
    assert len(set(seeds)) == 1, f"eval seeds must be constant, got {seeds}"
    assert seeds[0] is not None


def test_physics_eval_failure_does_not_kill_fit(monkeypatch):
    """A failing physics eval is logged and skipped — a metric must never
    kill a 1500-epoch run."""
    import multimodal_flows.train.physics_eval as pe

    def boom(*a, **kw):
        raise RuntimeError("synthetic failure")

    monkeypatch.setattr(pe, "physics_metrics", boom)
    cfg = _mk_cfg(batch_size=8, max_epochs=2, physics_eval_every_n_epochs=1,
                  physics_eval_num_jets=16, physics_eval_num_timesteps=2)
    jets = make_jets(B=32, D=16, seed=9)
    ds = ArrayDataset(DataCoupling(source=MultiModal(mask=jets.mask), target=jets))
    train_ds, val_ds = ds.split(0.7, seed=0)
    trainer = Trainer(build_system(cfg, "MMF"), cfg, mesh=None)
    with tempfile.TemporaryDirectory() as d:
        cfg.dir = d
        trainer.fit(train_ds, val_ds)  # must not raise
        ckdir = os.path.join(d, "scratch", "checkpoints")
        assert not os.path.exists(os.path.join(ckdir, "best_physics"))
