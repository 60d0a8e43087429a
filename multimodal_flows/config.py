"""Experiment configuration.

Mirrors the reference's argparse + YAML round-trip config system
(`scripts/train_mmf.py:12-79`, `utils/helpers.py:14-48`) with the same key
names, as a plain dataclass: CLI flags populate it, `save()` persists
`config.yaml` into the experiment directory, and `Config.load(path)`
reloads it for resume / sampling with selective overrides.

Extra knobs with no reference flag (mesh shape, dtype policy, packing,
sharding) default to values that reproduce the reference behavior.
"""

from __future__ import annotations

import dataclasses
import os
import secrets
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import yaml


@dataclass
class Config:
    # system
    num_nodes: int = 1
    dir: str = "./experiments"
    dir_aoj: str = "./aoj"
    project: str = "aoj_jets"
    experiment_id: Optional[str] = None
    ckpt_path: Optional[str] = None
    resume_ckpt: str = "last"
    tags: Optional[List[str]] = None

    # training (reference `train_mmf.py:29-39`)
    data_files: Any = "RunG_batch0.h5"
    num_jets: int = 1_250_000
    max_num_particles: int = 150
    batch_size: int = 256
    max_epochs: int = 1500
    train_frac: float = 0.8
    lr: float = 5e-4
    lr_final: float = 1e-5
    warmup_epochs: int = 0
    use_ema_weights: bool = False
    ema_decay: float = 0.9999
    gradient_clip_val: float = 1.0
    seed: int = 0

    # model (reference `train_mmf.py:42-56`)
    model: str = "ParticleFormer"
    continuous_features: List[str] = field(default_factory=lambda: ["pt", "eta_rel", "phi_rel"])
    discrete_features: str = "tokens"
    vocab_size: int = 9  # tokens 1..8 plus pad token 0
    dim_continuous: int = 3
    n_embd: int = 256
    n_inner: Optional[int] = 512
    n_layer: int = 5
    n_layer_fused: int = 6
    n_head: int = 4
    dropout: float = 0.0
    qk_layernorm: bool = True
    bias: bool = True
    multitask_loss: str = "time-weighted"
    use_coocurrence: bool = False
    # extra-config keys with no reference CLI flag (YAML-only there):
    use_pos_emb: bool = False
    use_pairwise: bool = False
    n_embd_glob: int = 16
    markov_jump_solver: str = "tauleap-poisson"
    hybrid_solver: str = "tauleap"               # reference `solvers.py:9`; "euler"
                                                 # selects the transition-matrix step
    class_freqs: Optional[List[float]] = None    # per-class temperature vector for
                                                 # the hybrid euler path (reference
                                                 # `_temperature_scaling`,
                                                 # `solvers.py:95-99`)

    # GPT baseline keys (reference `model/GPT.py:12-37`)
    max_seq_length: int = 150
    activation: str = "gelu_new"
    dropout_att: float = 0.0
    dropout_emb: float = 0.0
    dropout_res: float = 0.0

    # dynamics (reference `train_mmf.py:59-61`)
    beta: float = 0.075
    sigma: float = 1e-5
    time_eps: float = 1e-5

    # sampling (reference `train_mmf.py:64-67`)
    num_timesteps: Any = 100
    temperature: Any = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    use_final_max_rates: bool = False

    # dataset metadata injected at runtime (reference `train_mmf.py:95`)
    metadata: Optional[Dict[str, Any]] = None

    # --- knobs with no reference equivalent ---
    mesh_shape: Optional[Dict[str, int]] = None  # e.g. {"data": 8}
    compute_dtype: str = "float32"               # or "bfloat16"
    remat: bool = False                          # rematerialize attention blocks
                                                 # (trade FLOPs for HBM at large batch)
    bucketed_training: bool = False              # group jets by multiplicity into
                                                 # static-width buckets (skips pad
                                                 # compute; within-bucket batches)
    bucket_widths: List[int] = field(default_factory=lambda: [48, 64, 128])
                                                 # 48 covers ~88% of AOJ-like jets
                                                 # (mean mult ~40); the >128 tail
                                                 # stays at D.  Set on an earlier
                                                 # accelerator; unmeasured on H100
    packed_training: bool = False                # multi-jet packed training: jets
                                                 # share pack_width-token rows behind
                                                 # a block-diagonal segment mask; each
                                                 # jet keeps its own t and per-jet
                                                 # loss normalization (exact per-jet
                                                 # parity, tests/test_packed_training)
    pack_width: int = 128                        # packed row width, set on an earlier
                                                 # accelerator and unmeasured on
                                                 # H100; jets wider than this train
                                                 # as singleton rows at their native
                                                 # width
    pair_chunk: int = 16                         # query-row chunk for the Lund
                                                 # pair-MLP (KinFormer use_pairwise):
                                                 # bounds the (B, chunk, D, E) pair
                                                 # hiddens so packed W=128 rows fit
                                                 # device memory; 0 = unchunked
    fsdp: bool = False                           # shard params + optimizer state
                                                 # over the data axis (ZeRO-3-style)
    tensor_parallel: int = 1                     # model-axis size of a 2-D
                                                 # (data, model) mesh: Megatron-style
                                                 # sharding of the attention/MLP
                                                 # kernels (parallel/mesh.py:tp_sharding)
    epoch_hbm_budget_mb: int = 4096              # cap on the device-resident epoch
                                                 # batch stack; bigger epochs stream
                                                 # in double-buffered super-chunks
                                                 # (trainer._epoch_chunks).  Set on
                                                 # an earlier accelerator;
                                                 # unmeasured on H100
    checkpoint_every_n_epochs: int = 1
    save_top_k: int = 10                         # best checkpoints kept per monitor
                                                 # (reference `train_mmf.py:128-148`)
    physics_eval_every_n_epochs: int = 0         # 0 = off.  Every N epochs sample
                                                 # physics_eval_num_jets jets at
                                                 # physics_eval_num_timesteps and
                                                 # checkpoint the best W1(pt/mass/
                                                 # mult) in `best_physics` — the
                                                 # val-loss monitors mis-rank sample
                                                 # quality (CLOSURE_r03: W1(pt) 15.6
                                                 # for `best` vs 0.82 for `last`)
    physics_eval_num_jets: int = 2000
    physics_eval_num_timesteps: int = 250        # few-step quality anti-correlates
                                                 # with many-step quality near the
                                                 # cosine tail: at 50 steps the slot
                                                 # mis-ranked the r04 flagship;
                                                 # >=250 tracks the 500-step
                                                 # ordering (physeval_protocol_r04).
                                                 # ~5x the per-eval cost of the old
                                                 # 50-step protocol (~5 s vs ~1 s
                                                 # warm per eval)
    physics_eval_margin: float = 0.3             # tie-to-later slot rule: the
                                                 # best_physics slot holds the
                                                 # LATEST eval within (1+margin) of
                                                 # the best score seen; argmin
                                                 # selection provably mis-ranks at
                                                 # feasible eval sizes (CRN study,
                                                 # PHYSEVAL_CRN_r05.md: equal-
                                                 # quality late checkpoints differ
                                                 # ~15%/seed at 2k jets, genuinely
                                                 # worse ones separate by 60%+;
                                                 # 0.3 sits between).  0 = legacy
                                                 # argmin
    log_every_n_steps: int = 50
    use_wandb: bool = False                      # extra Weights & Biases metric
                                                 # sink (offline-first; gated on
                                                 # the wandb package) — the
                                                 # online-tracker UX the reference
                                                 # gets from Comet
                                                 # (`utils/helpers.py:14-38`)

    # ------------------------------------------------------------ helpers

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def experiment_dir(self) -> str:
        assert self.experiment_id is not None
        return os.path.join(self.dir, self.project, self.experiment_id)

    def mint_experiment_id(self) -> str:
        if self.experiment_id is None:
            self.experiment_id = secrets.token_hex(8)
        return self.experiment_id

    def save(self, path: Optional[str] = None) -> str:
        """Persist config.yaml into the experiment dir
        (reference `helpers.py:35-36`)."""
        path = path or self.experiment_dir
        os.makedirs(path, exist_ok=True)
        out = os.path.join(path, "config.yaml")
        with open(out, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False, default_flow_style=False)
        return out

    @classmethod
    def load(cls, experiment_path: str) -> "Config":
        """Reload a persisted config (reference `helpers.py:42-48`)."""
        with open(os.path.join(experiment_path, "config.yaml")) as f:
            raw = yaml.safe_load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in raw.items() if k in known})
        return cfg
