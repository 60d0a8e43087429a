"""End-to-end quality closure demonstration (VERDICT r1 #4).

Trains a ~2M-param MMF (ParticleFormer) on 100k synthetic AOJ-like jets
through the production pipeline (PFCands .h5 -> AspenOpenJets loader ->
Trainer, EMA, bucketing) then generates 50k jets with the hybrid tau-leap
sampler and commits the closure evidence:

  CLOSURE_r02.md         — W1(pT, mass, multiplicity), flavor-frequency
                           table, untrained-model contrast
  closure/metrics.json   — the raw numbers
  closure/*.png          — kinematics + flavor closure plots

The synthetic jets are structured (falling jet-pT spectrum, collimated
constituents, AOJ-like flavor frequencies with pT-flavor correlation) so
closure is a real learning task, not an identity map.  Real AOJ files are
unreachable from this environment (zero egress); swap --data for them when
available.

Usage: python scripts/closure_r02.py [--num_jets 120000] [--epochs 30]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

#: AOJ-like flavor probabilities for tokens 1..8
#: (photon, K_L, pi-, pi+, e-, e+, mu-, mu+)
FLAVOR_PIDS = np.array([22, 130, -211, 211, -11, 11, -13, 13])
FLAVOR_PROBS = np.array([0.26, 0.12, 0.27, 0.27, 0.02, 0.02, 0.02, 0.02])


def generate_synthetic_pfcands(num_jets: int, max_p: int, seed: int = 0) -> np.ndarray:
    """Vectorized AOJ-like PFCands tensor (px,py,pz,e,d0,d0Err,dz,dzErr,
    pid,charge): Poisson multiplicities, per-jet falling pT spectrum with
    leading-particle hierarchy, collimated eta/phi, photons softer than
    charged hadrons (a real flavor-kinematics correlation to learn)."""
    rng = np.random.default_rng(seed)
    n = np.clip(rng.poisson(28, num_jets), 5, max_p)
    slot = np.arange(max_p)[None, :]
    mask = slot < n[:, None]                                     # (J, P)

    # falling jet-pT spectrum like real AOJ QCD jets: p(pT) ~ pT^-4.5,
    # truncated to [400, 1000] GeV via inverse-CDF sampling
    u_pt = rng.random(num_jets)
    a, lo, hi = 3.5, 400.0, 1000.0          # p(pT) ~ pT^-(a+1)
    jet_pt = (lo**-a + u_pt * (hi**-a - lo**-a)) ** (-1.0 / a)
    jet_pt = jet_pt[:, None]
    # particle pT fractions: exponential decay over the pt-ordered slots
    w = rng.exponential(1.0, (num_jets, max_p)) * np.exp(-slot / 12.0)
    w = np.where(mask, w, 0.0)
    frac = w / w.sum(axis=1, keepdims=True)
    pt = jet_pt * frac

    # flavors, with photons biased toward softer slots
    u = rng.random((num_jets, max_p))
    soft = (slot / np.maximum(n[:, None] - 1, 1)).clip(0, 1)
    p_gamma = FLAVOR_PROBS[0] * (0.5 + soft)                     # soft -> more photons
    probs = np.broadcast_to(FLAVOR_PROBS, (num_jets, max_p, 8)).copy()
    probs[..., 0] = p_gamma
    probs /= probs.sum(axis=-1, keepdims=True)
    cdf = probs.cumsum(axis=-1)
    fl_idx = (u[..., None] > cdf).sum(axis=-1)                   # (J, P) in 0..7
    pid = FLAVOR_PIDS[fl_idx] * mask

    axis_eta = rng.uniform(-1.5, 1.5, num_jets)[:, None]
    axis_phi = rng.uniform(-np.pi, np.pi, num_jets)[:, None]
    spread = 0.25 * np.sqrt(-np.log(rng.random((num_jets, max_p)).clip(1e-9)))
    ang = rng.uniform(0, 2 * np.pi, (num_jets, max_p))
    eta = axis_eta + spread * np.cos(ang)
    phi = axis_phi + spread * np.sin(ang)

    px, py = pt * np.cos(phi), pt * np.sin(phi)
    pz = pt * np.sinh(eta)
    e = np.sqrt(px**2 + py**2 + pz**2)

    pf = np.zeros((num_jets, max_p, 10), dtype=np.float32)
    pf[..., 0], pf[..., 1], pf[..., 2], pf[..., 3] = px * mask, py * mask, pz * mask, e * mask
    pf[..., 4:8] = rng.normal(0, 0.01, (num_jets, max_p, 4)) * mask[..., None]
    pf[..., 8] = pid
    return pf


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num_jets", type=int, default=120_000)
    p.add_argument("--max_p", type=int, default=64)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--gen_jets", type=int, default=50_000)
    p.add_argument("--num_timesteps", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--workdir", default="/tmp/closure_r02")
    p.add_argument("--outdir", default="closure")
    p.add_argument("--n_embd", type=int, default=128)
    p.add_argument("--n_layer", type=int, default=4)
    p.add_argument("--n_layer_fused", type=int, default=5)
    p.add_argument("--reuse_experiment", default=None,
                   help="existing experiment id under workdir/closure/: skip "
                        "training and load its 'best' checkpoint (finish a "
                        "run whose generation phase was interrupted)")
    args = p.parse_args(argv)

    import h5py
    import jax

    from multimodal_flows.config import Config
    from multimodal_flows.data.aoj import AspenOpenJets, sample_from_empirical_masks
    from multimodal_flows.data.datasets import ArrayDataset
    from multimodal_flows.data.state import DataCoupling, MultiModal
    from multimodal_flows.sampling.generator import generate_bucketed
    from multimodal_flows.train.systems import MMF
    from multimodal_flows.train.trainer import Trainer
    from multimodal_flows.utils import enable_compilation_cache
    from multimodal_flows.utils.jet_features import JetFeatures
    from multimodal_flows.utils.logger import SimpleLogger as log
    from multimodal_flows.utils.metrics import wasserstein_flavor, wasserstein1d
    from multimodal_flows.utils import plotting

    enable_compilation_cache()
    os.makedirs(args.workdir, exist_ok=True)
    os.makedirs(args.outdir, exist_ok=True)

    # ---- 1. synthetic AOJ file -> production loader
    h5_path = os.path.join(args.workdir, "RunG_synth_v2.h5")
    if not os.path.exists(h5_path):
        pf = generate_synthetic_pfcands(args.num_jets + 30_000, args.max_p, seed=0)
        with h5py.File(h5_path, "w") as f:
            f.create_dataset("PFCands", data=pf)
        log.info(f"wrote synthetic PFCands {pf.shape} -> {h5_path}")

    aoj = AspenOpenJets(args.workdir, "RunG_synth_v2.h5")
    jets, metadata = aoj(num_jets=args.num_jets, max_num_particles=args.max_p,
                         transform="standardize")
    test_jets, _ = aoj(num_jets=None, max_num_particles=args.max_p,
                       transform=None)
    test_jets = test_jets[args.num_jets:]          # held-out, unstandardized
    log.info(f"train {len(jets)} jets, held-out test {len(test_jets)}")

    cfg = Config(
        model="ParticleFormer", n_embd=args.n_embd, n_inner=2 * args.n_embd,
        n_layer=args.n_layer, n_layer_fused=args.n_layer_fused,
        n_head=4, vocab_size=9, dim_continuous=3,
        max_num_particles=args.max_p, batch_size=args.batch_size,
        max_epochs=args.epochs, lr=1e-3, lr_final=1e-5, warmup_epochs=2,
        use_ema_weights=True, multitask_loss="time-weighted",
        bucketed_training=True, bucket_widths=[48],
        metadata=metadata, dir=args.workdir, project="closure", seed=0,
    )
    if args.reuse_experiment:
        cfg.experiment_id = args.reuse_experiment
    else:
        cfg.mint_experiment_id()
    system = MMF(cfg)
    n_params = sum(x.size for x in jax.tree.leaves(
        system.init_params(jax.random.PRNGKey(0))))
    log.info(f"model params: {n_params/1e6:.2f}M")

    ds = ArrayDataset(DataCoupling(source=MultiModal(mask=jets.mask), target=jets))
    train_ds, val_ds = ds.split(0.95, seed=0)

    # ---- untrained contrast sample (same sampler, fresh params)
    masks = sample_from_empirical_masks(
        np.asarray(test_jets.mask), args.gen_jets, seed=3)
    params0 = system.init_params(jax.random.PRNGKey(1))
    res0 = generate_bucketed(system, params0, masks,
                             num_timesteps=50, batch_size=args.batch_size,
                             seed=5, metadata=metadata)

    # ---- 2. train
    trainer = Trainer(system, cfg, mesh=None)
    t0 = time.time()
    if not args.reuse_experiment:
        trainer.fit(train_ds, val_ds)
    train_s = time.time() - t0
    log.info(f"training done in {train_s:.0f}s")
    params = trainer.load_for_inference("best")

    # ---- 3. generate
    t0 = time.time()
    res = generate_bucketed(system, params, masks,
                            num_timesteps=args.num_timesteps,
                            batch_size=args.batch_size, seed=7,
                            metadata=metadata)
    gen_s = time.time() - t0
    log.info(f"generated {len(res.sample)} jets in {gen_s:.0f}s "
             f"({res.jets_per_sec:.1f} jets/s)")

    # ---- 4. closure metrics (gen vs held-out test, physical units)
    def closure_numbers(sample):
        feats_g = JetFeatures(sample)
        feats_r = JetFeatures(test_jets)
        w1 = {
            "pt": feats_g.Wassertein1D("pt", feats_r),
            "mass": feats_g.Wassertein1D("m", feats_r),
            "multiplicity": wasserstein1d(
                feats_g.numParticles.astype(float),
                feats_r.numParticles.astype(float)),
            "tau21": feats_g.Wassertein1D("tau21", feats_r),
            "d2": feats_g.Wassertein1D("d2", feats_r),
        }
        wf = wasserstein_flavor(sample, test_jets)
        tok_g = np.asarray(sample.discrete)[..., 0]
        m_g = np.asarray(sample.mask)[..., 0] > 0
        freq_g = np.bincount(tok_g[m_g], minlength=9) / m_g.sum()
        return w1, wf, freq_g, feats_g, feats_r

    w1_un, wf_un, _, _, _ = closure_numbers(res0.sample)
    w1, wf, freq_g, feats_g, feats_r = closure_numbers(res.sample)
    tok_r = np.asarray(test_jets.discrete)[..., 0]
    m_r = np.asarray(test_jets.mask)[..., 0] > 0
    freq_r = np.bincount(tok_r[m_r], minlength=9) / m_r.sum()

    out = {
        "model_params": int(n_params),
        "train_jets": len(train_ds), "epochs": args.epochs,
        "train_seconds": train_s,
        "gen_jets": len(res.sample), "num_timesteps": args.num_timesteps,
        "gen_seconds": gen_s, "jets_per_sec": res.jets_per_sec,
        "w1_trained": w1, "w1_untrained": w1_un,
        "wasserstein_flavor_trained": wf,
        "wasserstein_flavor_untrained": wf_un,
        "flavor_freq_generated": freq_g.tolist(),
        "flavor_freq_test": freq_r.tolist(),
    }
    with open(os.path.join(args.outdir, "metrics.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in
                      ("w1_trained", "w1_untrained")}, indent=1))

    # ---- 5. plots
    plotting.plot_kin_feats(feats_g, feats_r,
                            path=os.path.join(args.outdir, "kin_closure.png"))
    plotting.plot_flavor_feats(res.sample, test_jets,
                               path=os.path.join(args.outdir, "flavor_closure.png"))

    # ---- 6. markdown artifact
    rows = "\n".join(
        f"| {k} | {w1[k]:.4g} | {w1_un[k]:.4g} |" for k in w1)
    flavors = ["pad", "photon", "K_L", "pi-", "pi+", "e-", "e+", "mu-", "mu+"]
    freq_rows = "\n".join(
        f"| {name} | {freq_g[i]:.4f} | {freq_r[i]:.4f} |"
        for i, name in enumerate(flavors))
    wf_rows = "\n".join(
        f"| {k} | {wf[k]:.4g} | {wf_un[k]:.4g} |" for k in sorted(wf))
    md = f"""# Closure — round 2

End-to-end quality closure of the JAX rebuild on synthetic AOJ-like jets
(real AOJ is unreachable from this environment; the dataset has a falling
jet-pT spectrum, collimated constituents, and pT-correlated AOJ-like
flavor fractions — see `scripts/closure_r02.py`).

- model: ParticleFormer MMF, {n_params/1e6:.2f}M params (n_embd {args.n_embd}, {args.n_layer}+{args.n_layer_fused} layers)
- trained {args.epochs} epochs on {len(train_ds):,} jets ({train_s:.0f}s on one chip)
- generated {len(res.sample):,} jets @ {args.num_timesteps} tau-leap steps
  ({res.jets_per_sec:.1f} jets/s) with EMA weights from the `best` checkpoint

## W1 closure (generated vs held-out test, physical units)

| observable | trained | untrained (contrast) |
|---|---|---|
{rows}

## Flavor frequencies

| flavor | generated | test |
|---|---|---|
{freq_rows}

## W1 on the 16 flavor-multiplicity observables (reference metric set)

| observable | trained | untrained |
|---|---|---|
{wf_rows}

Plots: `closure/kin_closure.png`, `closure/flavor_closure.png`.
Raw numbers: `closure/metrics.json`.
"""
    with open("CLOSURE_r02.md", "w") as f:
        f.write(md)
    log.info("wrote CLOSURE_r02.md")


if __name__ == "__main__":
    main()
