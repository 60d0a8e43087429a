"""Packed vs bucketed sampling throughput per encoder (VERDICT r3 #2/#3).

Round 3 left the pairwise-bias encoders (KinFormer+Lund, co-occurrence)
and EPiC on the bucketed fallback; round 4 moved them onto the packed
path (chunked Lund pair-MLP, project-before-gather co-occurrence bias,
per-segment EPiC pooling).  This script loads each trained round-4
encoder experiment (the round-4 encoder closures) and times
`generate_packed` vs the `generate_bucketed` fallback on the same masks,
reporting jets/s for both.

Throughput is parameter-VALUE independent (same compute graph either
way), so when a trained round-4 experiment is not on disk (e.g. /tmp was
recycled between rounds) each variant falls back to freshly initialized
params at the identical architecture — the jets/s comparison is the same
measurement.

Usage: python scripts/encoder_packed_vs_bucketed.py [--num_jets 2000]
Appends a markdown table to ENCODER_CLOSURES_r04.md.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default="/tmp/encoders_r04")
    p.add_argument("--num_jets", type=int, default=2000)
    p.add_argument("--num_timesteps", type=int, default=200)
    p.add_argument("--out_md", default="ENCODER_CLOSURES_r04.md")
    args = p.parse_args(argv)

    import jax
    import yaml

    from multimodal_flows.config import Config
    from multimodal_flows.data.aoj import (AspenOpenJets, extract_metadata,
                                               sample_from_empirical_masks)
    from multimodal_flows.sampling.generator import (generate_bucketed,
                                                         generate_packed)
    from multimodal_flows.train.systems import build_system
    from multimodal_flows.train.trainer import Trainer
    from multimodal_flows.utils import enable_compilation_cache
    from multimodal_flows.utils.logger import SimpleLogger as log

    enable_compilation_cache()

    synth = os.path.join(args.dir, "RunG_synth_r04test.h5")
    if not os.path.exists(synth):
        import h5py

        from closure_r02 import generate_synthetic_pfcands

        os.makedirs(args.dir, exist_ok=True)
        pf = generate_synthetic_pfcands(5_000, 64, seed=11)
        with h5py.File(synth, "w") as f:
            f.create_dataset("PFCands", data=pf)
    aoj = AspenOpenJets(args.dir, "RunG_synth_r04test.h5")
    test, _ = aoj(num_jets=5_000, max_num_particles=64, transform=None)
    masks = sample_from_empirical_masks(np.asarray(test.mask), args.num_jets,
                                        64, seed=11)
    metadata = extract_metadata(np.asarray(test.continuous),
                                np.asarray(test.mask))

    # trained round-4 experiments if present, else init-params fallback at
    # the identical architecture (jets/s does not depend on param values)
    units = []
    for exp_dir in sorted(glob.glob(os.path.join(args.dir, "enc", "*"))):
        cfg_path = os.path.join(exp_dir, "config.yaml")
        if not os.path.exists(cfg_path):
            continue
        raw = yaml.safe_load(open(cfg_path))
        kind = "MMF"
        for t in raw.get("tags") or []:
            if t.startswith("system:"):
                kind = t.split(":", 1)[1]
        units.append((Config.load(exp_dir), kind, exp_dir))
    if not units:
        log.info("no trained encoder experiments found -> init params")
        base = dict(n_embd=256, n_inner=512, n_layer=5, n_layer_fused=6,
                    n_head=4, vocab_size=9, dim_continuous=3,
                    max_num_particles=64, batch_size=256, metadata=metadata)
        units = [
            (Config(model="FlavorFormer", use_pairwise=True, use_pos_emb=True,
                    **base), "MJB", None),
            (Config(model="EPiC", n_embd_glob=16, **base), "CFM", None),
            (Config(model="KinFormer", use_pairwise=True, **base), "CFM", None),
            (Config(model="ParticleFormer", use_coocurrence=True, **base),
             "MMF", None),
        ]

    rows = []
    for cfg, kind, exp_dir in units:
        system = build_system(cfg, kind)
        if exp_dir is not None:
            trainer = Trainer(system, cfg, mesh=None)
            params = trainer.load_for_inference("last")
        else:
            params = system.init_params(jax.random.PRNGKey(0))
        name = (f"{cfg.model}"
                + (" +pairwise" if getattr(cfg, "use_pairwise", False) else "")
                + (" +coocc" if getattr(cfg, "use_coocurrence", False) else "")
                + (" +posemb" if getattr(cfg, "use_pos_emb", False) else ""))

        res_p = generate_packed(system, params, masks,
                                num_timesteps=args.num_timesteps,
                                batch_size=256, seed=3, metadata=cfg.metadata)
        res_b = generate_bucketed(system, params, masks,
                                  num_timesteps=args.num_timesteps,
                                  batch_size=256, seed=3, metadata=cfg.metadata)
        # warm-cache repeats (first calls pay compile)
        res_p = generate_packed(system, params, masks,
                                num_timesteps=args.num_timesteps,
                                batch_size=256, seed=4, metadata=cfg.metadata)
        res_b = generate_bucketed(system, params, masks,
                                  num_timesteps=args.num_timesteps,
                                  batch_size=256, seed=4, metadata=cfg.metadata)
        rows.append({"encoder": name, "system": kind,
                     "packed": round(res_p.jets_per_sec, 1),
                     "bucketed": round(res_b.jets_per_sec, 1),
                     "speedup": round(res_p.jets_per_sec /
                                      max(res_b.jets_per_sec, 1e-9), 2)})
        log.info(f"{name}: packed {rows[-1]['packed']} vs bucketed "
                 f"{rows[-1]['bucketed']} jets/s ({rows[-1]['speedup']}x)")

    md = ["", "## Packed vs bucketed sampling (round-4 fast path, "
          f"{args.num_jets:,} jets @{args.num_timesteps} steps)",
          "",
          "| encoder | system | packed jets/s | bucketed jets/s | speedup |",
          "|---|---|---|---|---|"]
    for r in rows:
        md.append(f"| {r['encoder']} | {r['system']} | {r['packed']} | "
                  f"{r['bucketed']} | {r['speedup']}x |")
    md.append("")
    md.append("(`use_pos_emb` models route to the bucketed path by design — "
              "learned absolute positions are incompatible with packed rows.)")
    with open(os.path.join(REPO, args.out_md), "a") as f:
        f.write("\n".join(md) + "\n")
    print(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
