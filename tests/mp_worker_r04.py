"""Round-4 multi-process worker: FSDP/TP state + step, checkpoint
save/restore across a process RESTART, and a packed-generation gather
(VERDICT r3 #8) — 2 real processes x 4 virtual CPU devices over gloo.

Two phases, launched as separate process pairs by
tests/test_multiprocess.py::test_two_process_fsdp_tp_ckpt_packed:

  * phase "train": FSDP-sharded state creation + one optimizer step via
    the Trainer's compiled step, a TP (4x2 mesh) state + step, a packed
    per-process generation all-gathered with `gather_multihost`, and a
    CheckpointManager.save of the FSDP-sharded train state (the shards are
    all-gathered and process 0 writes the file; all fs bookkeeping is process-0-gated,
    checkpoints.py:_save_to).
  * phase "restore": FRESH processes restore that checkpoint onto a
    newly-minted FSDP-sharded abstract state (exercising restore into
    multihost shardings), verify the parameter fingerprint matches the
    saved one, and take one more step to prove the restored state trains.

Replaces the reference behaviors of Lightning's rank-zero ModelCheckpoint
+ DDP resume (`utils/helpers.py:51-105`, `scripts/train_mmf.py:128-170`).
"""

import json
import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]
out_path = sys.argv[4]
phase = sys.argv[5]            # "train" | "restore"
ckpt_dir = sys.argv[6]

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORM_NAME"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.distributed.initialize(f"localhost:{port}", num_processes=nproc,
                           process_id=pid)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from multimodal_flows.parallel.mesh import (
    make_mesh,
    make_mesh_2d,
    replicated_sharding,
    shard_coupling,
)
from multimodal_flows.sampling.generator import gather_multihost, generate_packed
from multimodal_flows.train.checkpoints import CheckpointManager
from multimodal_flows.train.systems import MMF
from multimodal_flows.train.trainer import Trainer
from tests.mp_common import make_global_coupling, tiny_mp_config


def fingerprint(params, mesh):
    """Replicated global L1 of a (possibly sharded) param pytree."""
    return float(jax.jit(
        lambda p: sum(jax.numpy.abs(x).sum() for x in jax.tree.leaves(p)),
        out_shardings=replicated_sharding(mesh))(params))


def fsdp_trainer():
    # n_embd 64 so the big kernels clear fsdp_sharding's min_size=4096
    # and genuinely shard over the 8-device data axis
    cfg = tiny_mp_config(fsdp=True, lr=1e-3, n_embd=64, n_inner=128)
    mesh = make_mesh()
    return Trainer(MMF(cfg), cfg, mesh=mesh), mesh


def main():
    assert jax.process_count() == nproc and len(jax.devices()) == 4 * nproc
    out = {"process": pid, "phase": phase}

    trainer, mesh = fsdp_trainer()
    state = trainer.init_state(jax.random.PRNGKey(0), 4)
    # the big kernels really shard over the 8-device data axis
    out["fsdp_any_sharded"] = any(
        "data" in str(x.sharding.spec)
        for x in jax.tree.leaves(state.params))
    batch = shard_coupling(make_global_coupling(), mesh)
    ckpt = CheckpointManager(ckpt_dir, top_k=2)

    if phase == "train":
        state, metrics = trainer.compiled_train_step()(
            state, batch, jax.random.PRNGKey(42))
        out["fsdp_loss"] = float(
            jax.device_get(metrics["loss"]))
        out["fsdp_fingerprint"] = fingerprint(state.params, mesh)
        ckpt.save(trainer._to_ckpt(state, epoch=1),
                  {"val_loss": out["fsdp_loss"]}, 1)

        # ---- TP: (data=4, model=2) mesh, Megatron kernel sharding ------
        cfg_tp = tiny_mp_config(tensor_parallel=2, lr=1e-3)
        mesh_tp = make_mesh_2d(2)
        trainer_tp = Trainer(MMF(cfg_tp), cfg_tp, mesh=mesh_tp)
        state_tp = trainer_tp.init_state(jax.random.PRNGKey(0), 4)
        out["tp_any_sharded"] = any(
            "model" in str(x.sharding.spec)
            for x in jax.tree.leaves(state_tp.params))
        batch_tp = shard_coupling(make_global_coupling(), mesh_tp)
        state_tp, m_tp = trainer_tp.compiled_train_step()(
            state_tp, batch_tp, jax.random.PRNGKey(42))
        out["tp_loss"] = float(jax.device_get(m_tp["loss"]))

        # ---- packed generation + multihost gather ----------------------
        n_total = 16
        rng = np.random.default_rng(5)
        mult = rng.integers(2, 7, n_total)
        masks = (np.arange(6)[None, :] < mult[:, None]).astype(np.int64)[..., None]
        lo = pid * (n_total // nproc)
        hi = lo + n_total // nproc
        host_params = jax.device_get(
            jax.jit(lambda p: p, out_shardings=replicated_sharding(mesh))(
                state.params))
        res = generate_packed(trainer.system, host_params, masks[lo:hi],
                              num_timesteps=4, pack_width=6, batch_size=8,
                              seed=123)
        gathered = gather_multihost(res.sample)
        out["packed_gathered_jets"] = int(len(gathered))
        out["packed_checksum"] = float(
            np.abs(np.asarray(gathered.continuous)).sum())
        out["packed_mult_total"] = int(np.asarray(gathered.mask).sum())

    else:  # phase == "restore" — fresh processes, restore + one step
        restored = ckpt.load(trainer._to_ckpt(state), name="last")
        state = trainer._from_ckpt(state, restored)
        out["restored_epoch"] = int(jax.device_get(restored["epoch"]))
        out["restored_fingerprint"] = fingerprint(state.params, mesh)
        out["restored_still_sharded"] = any(
            "data" in str(x.sharding.spec)
            for x in jax.tree.leaves(state.params))
        state, metrics = trainer.compiled_train_step()(
            state, batch, jax.random.PRNGKey(43))
        out["post_restore_loss"] = float(jax.device_get(metrics["loss"]))

    with open(out_path, "w") as f:
        json.dump(out, f)
    print("worker", pid, phase, "ok", flush=True)


if __name__ == "__main__":
    main()
