"""Shared fixture code for the multi-process test: the same tiny config and
global batch must be constructible identically in the parent (single
process, 8 virtual devices) and in every worker (2 processes x 4 devices),
so the loss comparison is apples-to-apples."""

import numpy as np

from multimodal_flows.config import Config
from multimodal_flows.data.state import DataCoupling, MultiModal

GLOBAL_BATCH = 16


def tiny_mp_config(**kw) -> Config:
    base = dict(model="ParticleFormer", n_embd=16, n_inner=32, n_layer=1,
                n_layer_fused=1, n_head=2, max_num_particles=6, vocab_size=9,
                dim_continuous=3, batch_size=GLOBAL_BATCH, dropout=0.0,
                multitask_loss="sum", time_eps=1e-5)
    base.update(kw)
    return Config(**base)


def make_global_coupling() -> DataCoupling:
    """Deterministic global batch — every process computes the same one
    (mirroring the shared-seed shuffle of the trainer)."""
    rng = np.random.default_rng(7)
    B, D = GLOBAL_BATCH, 6
    mult = rng.integers(2, D + 1, B)
    mask = (np.arange(D)[None, :] < mult[:, None]).astype(np.int64)[..., None]
    x = (rng.normal(size=(B, D, 3)).astype(np.float32) * mask)
    k = (rng.integers(1, 9, size=(B, D, 1)) * mask).astype(np.int64)
    target = MultiModal(continuous=x, discrete=k, mask=mask)
    return DataCoupling(source=MultiModal(mask=mask), target=target)
