"""Sampling CLI: generate AOJ jets from a trained MMF experiment.

Flag-compatible re-design of the reference generation entry point
(`scripts/sample_mmf.py:16-168`): loads the persisted experiment config and
checkpoint, builds noise sources from the test-set empirical multiplicity
masks, sweeps num_files x temperature x num_timesteps, and writes
`generation_results_{tag}/generated_sample.h5`.  Each sweep point runs as
one compiled `lax.scan` per batch on the device mesh (no per-step Python).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodal_flows.config import Config
from multimodal_flows.data.aoj import AspenOpenJets, sample_from_empirical_masks
from multimodal_flows.sampling.generator import run_generation_sweep
from multimodal_flows.train.systems import build_system
from multimodal_flows.train.trainer import Trainer
from multimodal_flows.utils.logger import SimpleLogger as log


def experiment_configs(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num_nodes", "-N", type=int, default=1)
    p.add_argument("--dir", type=str, default="./experiments")
    p.add_argument("--project", "-proj", type=str, default="aoj_jets")
    p.add_argument("--experiment_id", "-id", type=str, required=True)
    p.add_argument("--data_files", "-f", type=str, default="RunG_batch0.h5")
    p.add_argument("--dir_aoj", type=str, default=None,
                   help="override the experiment's stored AOJ data dir "
                        "(reference `train_mmf.py:19`)")
    p.add_argument("--continuous_features", "-cont", type=str, nargs="*",
                   default=["pt", "eta_rel", "phi_rel"])
    p.add_argument("--discrete_features", "-disc", type=str, default="tokens")
    p.add_argument("--batch_size", "-bs", type=int, default=256)
    p.add_argument("--tag", "-t", type=str, default="")
    p.add_argument("--checkpoint", "-ckpt", type=str, default="best")
    p.add_argument("--num_jets", "-n", type=int, default=100_000)
    p.add_argument("--num_timesteps", "-steps", type=int, nargs="*", default=[100])
    p.add_argument("--temperature", "-tmp", type=float, nargs="*", default=[1.0])
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--use_final_max_rates", action="store_true", default=False)
    p.add_argument("--num_files", type=int, default=1)
    p.add_argument("--make_plots", "-plots", action="store_true", default=False)
    p.add_argument("--max_dispatch_steps", type=int, default=8_000,
                   help="bound on batches*timesteps per device program; "
                        "lower it for encoders with heavy forwards (pairwise "
                        "biases) to keep each device program short")
    p.add_argument("--scan_unroll", type=int, default=1,
                   help="lax.scan unroll factor for the sampling loop "
                        "(semantics-free; whether >1 pays at the flagship "
                        "shape is unmeasured on H100)")
    p.add_argument("--metrics_only", action="store_true", default=False,
                   help="crash-resume: skip generation and (re)compute "
                        "metrics.json for every existing generation_results* "
                        "dir that has a generated_sample.h5 but no metrics "
                        "(a crash between the h5 write and the metrics write "
                        "otherwise forces a full regeneration)")
    args = p.parse_args(argv)

    run_cfg = Config.load(os.path.join(args.dir, args.project, args.experiment_id))
    # selective overrides (reference `sample_mmf.py:40-55`)
    for k in ["dir", "project", "experiment_id", "data_files", "continuous_features",
              "discrete_features", "batch_size", "num_jets", "top_k", "top_p",
              "use_final_max_rates", "num_files"]:
        setattr(run_cfg, k, getattr(args, k))
    if args.dir_aoj is not None:
        run_cfg.dir_aoj = args.dir_aoj
    run_cfg.temperature = args.temperature
    run_cfg.num_timesteps = args.num_timesteps
    return run_cfg, args


def main(argv=None):
    config, args = experiment_configs(argv)

    if args.metrics_only:
        # pure-numpy path: keep JAX on the CPU so a metrics pass does not
        # reserve the card's memory
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        from multimodal_flows.utils import enable_compilation_cache

        enable_compilation_cache()
        if args.scan_unroll > 1:
            from multimodal_flows.dynamics.solvers import set_scan_unroll

            set_scan_unroll(args.scan_unroll)

    kind = "MMF"
    for t in config.tags or []:
        if t.startswith("system:"):
            kind = t.split(":", 1)[1]

    if kind == "GPT":
        return _sample_gpt(config, args)

    if args.metrics_only:
        return _metrics_only(config)

    system = build_system(config, kind)
    trainer = Trainer(system, config, mesh="auto")
    params = trainer.load_for_inference(name=args.checkpoint)
    log.info(f"loaded checkpoint {args.checkpoint!r} from {config.experiment_dir}")

    # empirical multiplicity masks from the test file
    test = _load_test(config)
    pad_masks = sample_from_empirical_masks(
        test.mask, config.num_jets, config.max_num_particles, seed=config.seed)

    results = run_generation_sweep(
        system, params, pad_masks, config,
        temperatures=args.temperature,
        timestep_grid=args.num_timesteps,
        num_files=args.num_files,
        mesh=trainer.mesh,
        max_dispatch_steps=args.max_dispatch_steps,
    )

    # W1 closure metrics vs the test sample (reference `utils/metrics.py:36-67`)
    for res in results:
        res_dir = os.path.join(config.experiment_dir, f"generation_results{res.tag}")
        point = {"jets_per_sec": res.jets_per_sec,
                 "num_timesteps": res.num_timesteps,
                 "temperature": res.temperature}
        _write_point_metrics(res_dir, res.sample, test, config, point, tag=res.tag)

    if args.make_plots:
        from multimodal_flows.utils.jet_features import JetFeatures
        from multimodal_flows.utils.plotting import (
            flavor_kinematics, plot_flavor_feats, plot_kin_feats)

        for res in results:
            res_dir = os.path.join(config.experiment_dir, f"generation_results{res.tag}")
            sample = res.sample
            plot_flavor_feats(sample, test, path=os.path.join(res_dir, "plots_flavor.png"))
            gen_feats, test_feats = JetFeatures(sample), JetFeatures(test)
            plot_kin_feats(gen_feats, test_feats, path=os.path.join(res_dir, "plots_kin.png"))
            flavor_kinematics(gen_feats, test_feats,
                              path=os.path.join(res_dir, "flavor_kinematics.png"))


def _load_test(config):
    """Test split used both for empirical multiplicity masks and as the W1
    reference sample (reference `sample_mmf.py:57-76`)."""
    aoj = AspenOpenJets(data_dir=config.dir_aoj, data_files=config.data_files)
    test, _ = aoj(num_jets=config.num_jets,
                  max_num_particles=config.max_num_particles,
                  features={"continuous": config.continuous_features,
                            "discrete": config.discrete_features},
                  pt_order=True, padding="zeros")
    return test


def _write_point_metrics(res_dir, sample, test, config, point, tag=""):
    """Compute + persist one sweep point's W1 closure metrics (numpy-only;
    safe to run CPU-forced when resuming after a crash)."""
    import json

    from multimodal_flows.utils.metrics import wasserstein1d, wasserstein_flavor

    if sample.discrete is not None and test.discrete is not None:
        w1 = wasserstein_flavor(sample, test,
                                path=os.path.join(res_dir, "w1_flavor.txt"))
        point["w1_flavor"] = w1
        log.info(f"{tag}: W1(multiplicity)={w1['multiplicity']:.4f}")
    if sample.continuous is not None and test.continuous is not None:
        # kinematic closure for continuous(-only) systems: per-feature
        # W1 over real particles, physical units
        g = np.asarray(sample.continuous)
        r = np.asarray(test.continuous)
        gm = np.asarray(sample.mask)[..., 0] > 0
        rm = np.asarray(test.mask)[..., 0] > 0
        names = config.continuous_features or ["pt", "eta_rel", "phi_rel"]
        point["w1_kinematics"] = {
            name: wasserstein1d(g[..., i][gm], r[..., i][rm])
            for i, name in enumerate(names)}
        log.info(f"{tag}: W1(kin)=" + str(
            {k: round(v, 4) for k, v in point['w1_kinematics'].items()}))
    with open(os.path.join(res_dir, "metrics.json"), "w") as f:
        json.dump(point, f, indent=1)


def _metrics_only(config):
    """Crash-resume: recompute metrics.json for existing generation dirs.

    Generation and metrics are separate failure domains — the h5 write
    lands before the (CPU) W1 pass, and a crash in between must not force
    regenerating 10k+ jets.  Parses steps/temperature back out of the
    directory tag.  Runs no device code; pure numpy."""
    import glob as _glob
    import re

    from multimodal_flows.data.state import MultiModal

    test = _load_test(config)
    done = 0
    for res_dir in sorted(_glob.glob(
            os.path.join(config.experiment_dir, "generation_results*"))):
        h5 = os.path.join(res_dir, "generated_sample.h5")
        if not os.path.exists(h5):
            continue
        if os.path.exists(os.path.join(res_dir, "metrics.json")):
            continue
        m = re.search(r"steps_(\d+)_temp_([\d.]+)", os.path.basename(res_dir))
        point = {"jets_per_sec": None,  # unknown: generation ran in a prior process
                 "num_timesteps": int(m.group(1)) if m else None,
                 "temperature": float(m.group(2)) if m else None}
        try:
            sample = MultiModal.load_from(h5)
        except OSError as e:
            # h5 truncated by a crash mid-write (pre-atomic-save artifact):
            # set it aside so the caller regenerates instead of looping here
            log.info(f"corrupt sample {h5} ({e}); renaming to .corrupt")
            os.replace(h5, h5 + ".corrupt")
            continue
        _write_point_metrics(res_dir, sample, test, config, point,
                             tag=os.path.basename(res_dir))
        done += 1
    log.info(f"metrics_only: wrote metrics.json for {done} generation dir(s)")


def _sample_gpt(config, args):
    """Autoregressive generation for the GPT baseline: batched compiled
    sampling, results gathered into sample.npy (the reference's
    GPTGeneratorCallback writes the same artifact,
    `utils/callbacks.py:65-107`)."""
    import jax
    import numpy as np

    system = build_system(config, "GPT")
    trainer = Trainer(system, config, mesh=None)
    params = trainer.load_for_inference(name=args.checkpoint)
    log.info(f"loaded GPT checkpoint {args.checkpoint!r}")

    temp = args.temperature[0] if isinstance(args.temperature, list) else args.temperature
    chunks = []
    bs = config.batch_size
    n_batches = (config.num_jets + bs - 1) // bs
    for b in range(n_batches):
        key = jax.random.fold_in(jax.random.PRNGKey(config.seed), b)
        chunks.append(system.sample_jets(params, key, bs, temperature=temp,
                                         top_k=config.top_k))
    sample = np.concatenate(chunks, axis=0)[: config.num_jets]

    res_dir = os.path.join(config.experiment_dir,
                           f"generation_results_{args.tag}_gpt_temp_{temp}")
    os.makedirs(res_dir, exist_ok=True)
    out = os.path.join(res_dir, "sample.npy")
    np.save(out, sample)
    log.info(f"wrote {sample.shape} token sample -> {out}")


if __name__ == "__main__":
    main()
