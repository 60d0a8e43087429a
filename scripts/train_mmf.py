"""Training CLI for the MultiModal Flow Bridge on AOJ jets.

Flag-compatible re-design of the reference entry point
(`scripts/train_mmf.py:12-180`): same flag names and defaults, same
config.yaml round-trip for resume, but the execution engine is the
JAX Trainer (jitted step over a data mesh) instead of Lightning DDP.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodal_flows.config import Config
from multimodal_flows.data.aoj import AspenOpenJets
from multimodal_flows.data.datasets import ArrayDataset
from multimodal_flows.data.state import DataCoupling, MultiModal
from multimodal_flows.train.systems import build_system
from multimodal_flows.train.trainer import Trainer
from multimodal_flows.utils.logger import SimpleLogger as log


def experiment_configs(argv=None) -> Config:
    p = argparse.ArgumentParser()
    # system
    p.add_argument("--num_nodes", "-N", type=int, default=1)
    p.add_argument("--dir", type=str, default="./experiments")
    p.add_argument("--dir_aoj", type=str, default="./aoj")
    p.add_argument("--project", "-proj", type=str, default="aoj_jets")
    p.add_argument("--experiment_id", "-id", type=str, default=None)
    p.add_argument("--ckpt_path", "-ckpt", type=str, default=None)
    p.add_argument("--resume_ckpt", "-resume", type=str, default="last")
    p.add_argument("--tags", type=str, nargs="*")
    # training
    p.add_argument("--data_files", "-f", type=str, default="RunG_batch0.h5")
    p.add_argument("--num_jets", "-n", type=int, default=1_250_000)
    p.add_argument("--max_num_particles", "-d", type=int, default=150)
    p.add_argument("--batch_size", "-bs", type=int, default=256)
    p.add_argument("--max_epochs", "-epochs", type=int, default=1500)
    p.add_argument("--train_frac", type=float, default=0.8)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--lr_final", type=float, default=1e-5)
    p.add_argument("--warmup_epochs", type=int, default=0)
    p.add_argument("--use_ema_weights", "-ema", action="store_true", default=False)
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--seed", type=int, default=0)
    # model
    p.add_argument("--model", "-nn", type=str, default="ParticleFormer")
    p.add_argument("--continuous_features", "-cont", type=str, nargs="*",
                   default=["pt", "eta_rel", "phi_rel"])
    p.add_argument("--discrete_features", "-disc", type=str, default="tokens")
    p.add_argument("--vocab_size", type=int, default=9)
    p.add_argument("--dim_continuous", type=int, default=3)
    p.add_argument("--n_embd", type=int, default=256)
    p.add_argument("--n_inner", type=int, default=512)
    p.add_argument("--n_layer", type=int, default=5)
    p.add_argument("--n_layer_fused", type=int, default=6)
    p.add_argument("--n_head", type=int, default=4)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--qk_layernorm", type=lambda s: s.lower() != "false", default=True)
    p.add_argument("--bias", type=lambda s: s.lower() != "false", default=True)
    p.add_argument("--multitask_loss", "-loss", type=str, default="time-weighted")
    p.add_argument("--use_coocurrence", action="store_true", default=False)
    p.add_argument("--use_pairwise", action="store_true", default=False,
                   help="pairwise attention bias (Lund for KinFormer, token "
                        "co-occurrence for FlavorFormer); reference YAML-only "
                        "keys `ParticleTransformers.py:246-252,339-351`")
    p.add_argument("--use_pos_emb", action="store_true", default=False,
                   help="learned positional embedding (FlavorFormer/KinFormer)")
    p.add_argument("--n_embd_glob", type=int, default=16,
                   help="EPiC global-stream width (reference `EPiC.py:22`)")
    # dynamics
    p.add_argument("--beta", "-b", type=float, default=0.075)
    p.add_argument("--sigma", "-sig", type=float, default=1e-5)
    p.add_argument("--time_eps", "-eps", type=float, default=1e-5)
    # sampling defaults stored in config
    p.add_argument("--num_timesteps", "-steps", type=int, default=100)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--top_p", type=float, default=None)
    # extras with no reference flag
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--system", type=str, default="MMF",
                   choices=["MMF", "CFM", "MJB", "GPT"],
                   help="trainable system (the reference drives only MMF "
                        "from this entry point; CFM/MJB/GPT are library "
                        "modules there)")
    p.add_argument("--bucketed_training", action="store_true", default=False,
                   help="group jets by multiplicity into static-width "
                        "buckets (2-3x faster epochs; within-bucket batches)")
    p.add_argument("--packed_training", action="store_true", default=False,
                   help="multi-jet packed training: jets share "
                        "pack_width-token rows behind a block-diagonal "
                        "segment mask, with per-jet time and per-jet loss "
                        "normalization (exact per-jet parity)")
    p.add_argument("--pack_width", type=int, default=128,
                   help="packed row width for packed training/sampling")
    p.add_argument("--physics_eval_every_n_epochs", type=int, default=0,
                   help="0 = off; every N epochs sample a few thousand "
                        "jets and checkpoint the best W1(pt/mass/mult) in "
                        "a `best_physics` slot (the val-loss monitors "
                        "mis-rank sample quality, CLOSURE_r03)")
    p.add_argument("--physics_eval_num_jets", type=int, default=2000)
    p.add_argument("--physics_eval_num_timesteps", type=int, default=250)
    p.add_argument("--physics_eval_margin", type=float, default=0.3,
                   help="tie-to-later slot rule: best_physics holds the "
                        "LATEST eval within (1+margin) of the best score "
                        "seen (argmin mis-ranks at feasible eval sizes, "
                        "PHYSEVAL_CRN_r05.md); 0 = legacy argmin")
    p.add_argument("--use_wandb", action="store_true", default=False,
                   help="extra Weights & Biases metric sink (offline-first; "
                        "requires the wandb package — the online-tracker UX "
                        "the reference gets from Comet)")
    p.add_argument("--remat", action="store_true", default=False)
    p.add_argument("--fsdp", action="store_true", default=False,
                   help="ZeRO-3-style: shard params + optimizer state over "
                        "the data axis")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="model-axis size of a (data, model) mesh with "
                        "Megatron-style kernel sharding")
    p.add_argument("--epoch_hbm_budget_mb", type=int, default=4096,
                   help="device-resident epoch stack cap; larger epochs "
                        "stream in double-buffered super-chunks")

    args = p.parse_args(argv)
    ns = vars(args)
    system_kind = ns.pop("system")
    cfg = Config(**ns)
    # record the system kind in the persisted tags so resume/sampling can
    # rebuild the right system
    cfg.tags = [t for t in (cfg.tags or []) if not t.startswith("system:")]
    cfg.tags.append(f"system:{system_kind}")

    if cfg.experiment_id is not None:
        # resume: reload the persisted config, keep the resume-relevant
        # overrides (reference `train_mmf.py:71-79`)
        path = os.path.join(cfg.dir, cfg.project, cfg.experiment_id)
        run_cfg = Config.load(path)
        run_cfg.max_epochs = cfg.max_epochs
        run_cfg.lr = cfg.lr
        run_cfg.lr_final = cfg.lr_final
        run_cfg.resume_ckpt = cfg.resume_ckpt
        run_cfg.experiment_id = cfg.experiment_id
        return run_cfg
    return cfg


def system_kind_of(config: Config) -> str:
    for t in config.tags or []:
        if t.startswith("system:"):
            return t.split(":", 1)[1]
    return "MMF"


def make_datasets(config: Config, system_kind: str = "MMF"):
    aoj = AspenOpenJets(data_dir=config.dir_aoj, data_files=config.data_files)
    jets, metadata = aoj(
        num_jets=config.num_jets,
        max_num_particles=config.max_num_particles,
        download=True,
        features={"continuous": config.continuous_features,
                  "discrete": config.discrete_features},
        transform="standardize",
        pt_order=True,
        padding="zeros",
    )
    config.metadata = metadata

    if system_kind == "GPT":
        from multimodal_flows.data.datasets import jet_set_to_seq

        config.max_seq_length = config.max_num_particles
        seq = jet_set_to_seq(jets, config.vocab_size)
        coupling = DataCoupling(target=seq)
    else:
        # source carries only the pad mask; x0/k0 drawn on-device per loss call
        coupling = DataCoupling(source=MultiModal(mask=jets.mask), target=jets)
    return ArrayDataset(coupling).split(config.train_frac, seed=config.seed)


def main(argv=None):
    from multimodal_flows.utils import enable_compilation_cache

    enable_compilation_cache()
    config = experiment_configs(argv)
    resume = None
    if config.experiment_id is not None:
        resume = config.resume_ckpt
        log.info(f"resuming experiment {config.experiment_id} from {resume!r}")
    else:
        config.mint_experiment_id()

    kind = system_kind_of(config)
    train_ds, val_ds = make_datasets(config, kind)
    config.save()  # persist config.yaml (incl. metadata) into the experiment dir
    log.info(f"experiment dir: {config.experiment_dir} (system {kind})")

    system = build_system(config, kind)
    trainer = Trainer(system, config)
    trainer.fit(train_ds, val_ds, resume=resume)


if __name__ == "__main__":
    main()
