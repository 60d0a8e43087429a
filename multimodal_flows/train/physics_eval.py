"""In-training physics eval: sample a few thousand jets and score W1
against the validation set, feeding the `best_physics` checkpoint slot.

Why this exists: the reference selects checkpoints on validation loss
(`scripts/train_mmf.py:128-148`, monitors val_loss/_mse/_ce), but the
round-3 ablation (CLOSURE_r03.md) measured that ranking to be a
catastrophic proxy for sample quality — the val-loss `best` slot scored
W1(jet pT) 15.6 vs 0.82 for the end-of-cosine EMA (`last`).  The loss is
a per-step denoising objective; sample quality depends on the whole
integrated trajectory.  So every `physics_eval_every_n_epochs` the trainer
generates `physics_eval_num_jets` jets at a low step count with the
current (EMA) params, computes W1 on the observables that mis-ranked
(jet pT, jet mass, token multiplicity), and checkpoints the best combined
score in the `best_physics` slot beside val_loss/_mse/_ce.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from multimodal_flows.data.state import MultiModal


def _destandardized(jets: MultiModal, metadata: Optional[Dict]) -> MultiModal:
    if jets.continuous is None or not metadata:
        return jets
    mean = np.asarray(metadata["mean"], np.float32)
    std = np.asarray(metadata["std"], np.float32)
    x = (np.asarray(jets.continuous) * std + mean) * np.asarray(jets.mask)
    return jets.replace(continuous=x.astype(np.float32))


def reference_observables(ref_jets: MultiModal, metadata: Optional[Dict],
                          num_jets: int) -> Dict[str, np.ndarray]:
    """Host-side observables of the (standardized) reference jets; computed
    once per fit and cached by the trainer.  Returns {name: (N,) values}."""
    ref = _destandardized(ref_jets[:num_jets].map(np.asarray), metadata)
    obs: Dict[str, np.ndarray] = {}
    if ref.continuous is not None:
        from multimodal_flows.utils.jet_features import JetFeatures

        f = JetFeatures(ref, compute_substructure=False)
        obs["pt"] = np.asarray(f.pt, np.float64)
        obs["mass"] = np.asarray(f.m, np.float64)
    if ref.discrete is not None:
        toks = np.asarray(ref.discrete)[..., 0]
        obs["mult"] = (toks > 0).sum(axis=1).astype(np.float64)
    return obs


def physics_metrics(system, params, ref_obs: Dict[str, np.ndarray],
                    masks: np.ndarray, *, num_timesteps: int,
                    metadata: Optional[Dict], batch_size: int, seed: int,
                    mesh=None, pack_width: int = 128) -> Dict[str, float]:
    """Generate jets with `params` and score W1 per observable vs
    `ref_obs` (from `reference_observables`).

    Returns {"val_w1_pt": ..., "val_w1_mass": ..., "val_w1_mult": ...,
    "val_w1_physics": combined} — the combined score is the mean of the
    per-observable W1s each normalized by the reference std, so GeV-scale
    pT and O(10) multiplicities weigh equally in the ranking.
    """
    from multimodal_flows.sampling.generator import generate_packed
    from multimodal_flows.utils.metrics import wasserstein1d

    res = generate_packed(system, params, masks, num_timesteps=num_timesteps,
                          pack_width=pack_width, batch_size=batch_size,
                          seed=seed, metadata=metadata, mesh=mesh)
    sample = res.sample

    gen: Dict[str, np.ndarray] = {}
    if sample.continuous is not None and ("pt" in ref_obs or "mass" in ref_obs):
        from multimodal_flows.utils.jet_features import JetFeatures

        f = JetFeatures(sample, compute_substructure=False)
        gen["pt"] = np.asarray(f.pt, np.float64)
        gen["mass"] = np.asarray(f.m, np.float64)
    if sample.discrete is not None and "mult" in ref_obs:
        toks = np.asarray(sample.discrete)[..., 0]
        gen["mult"] = (toks > 0).sum(axis=1).astype(np.float64)

    out: Dict[str, float] = {}
    normed = []
    for name, ref_vals in ref_obs.items():
        if name not in gen:
            continue
        w1 = wasserstein1d(gen[name], ref_vals)
        out[f"val_w1_{name}"] = float(w1)
        scale = float(ref_vals.std()) or 1.0
        normed.append(w1 / scale)
    if normed:
        out["val_w1_physics"] = float(np.mean(normed))
    return out
