"""Smoke run of the flagship MMF on NVIDIA GPUs, through the package's own
entry points, with random weights and synthetic AOJ-like jets.

    python chip_smoke.py               # one card: train, resume, sample,
                                       # precision check
    python chip_smoke.py --multichip   # four cards: data-parallel, FSDP and
                                       # tensor-parallel steps against one
                                       # device, and one sharded sampler run

Every phase checks its own results and any failure ends the run with a
non-zero exit.  With no GPU visible to JAX the run fails before any phase.
The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Checkpoints and logs go to `.chip_smoke/` in the checkout (git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time

import numpy as np

from multimodal_flows.config import Config
from multimodal_flows.data.datasets import ArrayDataset
from multimodal_flows.data.state import DataCoupling, MultiModal

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".chip_smoke")

#: relative L2 bound for the default-precision forward and solver step
#: against the same computation at "highest" matmul precision.  A float32
#: matmul on the card may run in TF32 (10 mantissa bits, unit roundoff
#: 2^-11 ~ 4.9e-4); the error compounds over the 11 transformer blocks and
#: the heads, so the bound is ~20x that roundoff.
PRECISION_REL_L2 = 1e-2
#: at most this share of real particle tokens may take another tau-leap
#: jump between the two precisions (a uniform that falls within the
#: precision error of a jump threshold)
PRECISION_TOKEN_FLIPS = 1e-2
#: data-parallel, FSDP and tensor-parallel runs against one device, all at
#: "highest" precision, so only the order of the cross-device reductions
#: differs: relative loss difference, and largest parameter difference
#: after the steps (each Adam step moves a parameter by at most ~lr = 5e-4)
MULTICHIP_LOSS_RTOL = 1e-4
MULTICHIP_PARAM_ATOL = 1e-4


def flagship_config(**overrides) -> Config:
    """The reference flagship (`train_mmf.py` defaults): ParticleFormer,
    n_embd 256, n_inner 512, 5+6 layers, 4 heads, D=150, time-weighted
    multitask loss."""
    base = dict(model="ParticleFormer", n_embd=256, n_inner=512, n_layer=5,
                n_layer_fused=6, n_head=4, vocab_size=9, dim_continuous=3,
                max_num_particles=150, multitask_loss="time-weighted")
    base.update(overrides)
    return Config(**base)


def device_guard() -> dict:
    """The JAX device as the result line reports it; raises unless JAX runs
    on a GPU and nvidia-smi names the card and its power limit."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(f"chip_smoke needs a GPU; JAX runs on {devices[0].platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    if not card:
        raise RuntimeError("nvidia-smi reported no card name and power limit")
    print(f"device: {devices[0].device_kind} x{len(devices)}")
    print(f"card (name, power limit): {card}")
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def synthetic_jets(num_jets: int, max_particles: int, seed: int, *,
                   mean_mult: float = 40.0, num_wide: int = 0,
                   wide_above: int = 128) -> MultiModal:
    """Standardized AOJ-like jets: multiplicity Poisson(mean_mult) clipped
    to [3, max_particles], the first `num_wide` jets wider than
    `wide_above`; kinematics N(0, 1), tokens uniform in 1..8, first-n
    filled masks."""
    rng = np.random.default_rng(seed)
    mult = np.clip(rng.poisson(mean_mult, num_jets), 3, max_particles)
    mult[:num_wide] = rng.integers(wide_above + 1, max_particles + 1, num_wide)
    mask = (np.arange(max_particles)[None, :] < mult[:, None]).astype(np.int32)[..., None]
    return MultiModal(
        continuous=(rng.normal(size=(num_jets, max_particles, 3)) * mask).astype(np.float32),
        discrete=(rng.integers(1, 9, (num_jets, max_particles, 1)) * mask).astype(np.int32),
        mask=mask)


def _epoch_losses(exp_dir: str) -> list:
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _trees_equal(a, b) -> bool:
    import jax

    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def train_phase(cfg: Config, jets: MultiModal, out_dir: str, *, epochs: int = 2,
                timed_epochs: int = 3):
    """Packed EMA training for `epochs` epochs, a bit-exact restore of the
    `last` checkpoint, one resumed epoch, and the steady time of one
    optimizer step.  Returns (system, EMA params of the resumed run)."""
    import jax
    import jax.numpy as jnp

    from multimodal_flows.train.checkpoints import CheckpointManager
    from multimodal_flows.train.systems import build_system
    from multimodal_flows.train.trainer import Trainer

    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = cfg.replace(dir=out_dir, project="smoke", experiment_id="train",
                      packed_training=True, use_ema_weights=True,
                      max_epochs=epochs, save_top_k=1)
    train_ds, val_ds = ArrayDataset(
        DataCoupling(source=MultiModal(mask=jets.mask), target=jets)
    ).split(cfg.train_frac, seed=cfg.seed)

    system = build_system(cfg, "MMF")
    trainer = Trainer(system, cfg)
    t0 = time.perf_counter()
    state = trainer.fit(train_ds, val_ds)
    fit_s = time.perf_counter() - t0
    log = _epoch_losses(cfg.experiment_dir)
    losses = [m["train_loss"] for m in log]
    print(f"train: {epochs} epochs in {fit_s:.1f} s (compiles included); "
          f"epoch times {[round(m['epoch_time_s'], 2) for m in log]} s; "
          f"train_loss {losses}; val_loss {[m['val_loss'] for m in log]}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"training loss not finite and falling: {losses}")

    ckpt = CheckpointManager(os.path.join(cfg.experiment_dir, "checkpoints"))
    restored = ckpt.load(trainer._to_ckpt(state), name="last")
    if not (_trees_equal(restored["params"], state.params)
            and _trees_equal(restored["ema_params"], state.ema_params)
            and _trees_equal(restored["opt_state"], state.opt_state)):
        raise RuntimeError("restored checkpoint differs from the saved state")
    print("checkpoint: `last` restores bit-identical params, EMA and optimizer state")

    # steady optimizer step: the packed unit's epoch scan, already compiled
    # by `fit`, run again to completion and divided by its steps
    unit, row_bs = trainer._pack_units(train_ds)[0], trainer._packed_row_bs
    if trainer._use_resident_gather(unit, row_bs):
        idx = trainer._epoch_perm(len(unit), row_bs, shuffle=True, seed=cfg.seed, epoch=0)
        args = (jax.tree.map(jnp.asarray, unit.coupling), jnp.asarray(idx))
        epoch_fn, n_steps = trainer.compiled_train_epoch_gather(), len(idx)
    else:
        stack, n_steps = trainer._stack_epoch(unit, row_bs, shuffle=True, seed=cfg.seed)
        epoch_fn, args = trainer.compiled_train_epoch(), (stack,)
    key = jax.random.PRNGKey(cfg.seed + 1)
    times = []
    for i in range(timed_epochs):
        t0 = time.perf_counter()
        state, _ = jax.block_until_ready(epoch_fn(state, *args, jax.random.fold_in(key, i)))
        times.append(time.perf_counter() - t0)
    print(f"train compile (first epoch less the second): "
          f"{log[0]['epoch_time_s'] - log[1]['epoch_time_s']:.2f} s")
    print(f"train step ({row_bs} rows x {cfg.pack_width} tokens, ~{cfg.batch_size} jets): "
          f"steady median {1e3 * float(np.median(times)) / n_steps:.3f} ms "
          f"({timed_epochs} scans of {n_steps} steps)")

    resumed_cfg = cfg.replace(max_epochs=epochs + 1)
    resumed = Trainer(build_system(resumed_cfg, "MMF"), resumed_cfg).fit(
        train_ds, val_ds, resume="last")
    log = _epoch_losses(cfg.experiment_dir)
    if log[-1]["epoch"] != epochs or not np.isfinite(log[-1]["train_loss"]):
        raise RuntimeError(f"resume did not run epoch {epochs}: {log[-1]}")
    print(f"resume: epoch {epochs} from `last`, train_loss {log[-1]['train_loss']:.4f}, "
          f"step {int(resumed.step)}")
    return system, resumed.ema_params


def check_sample(sample: MultiModal, pad_masks: np.ndarray, vocab_size: int) -> float:
    """Finite kinematics; tokens in 0..V-1 on real slots and 0 on pads.
    Returns the share of real slots that decoded to the pad token 0 (the
    telegraph sampler may jump there, as the reference's does)."""
    real = pad_masks[..., 0] > 0
    tokens = np.asarray(sample.discrete)[..., 0]
    if not np.array_equal(np.asarray(sample.mask), pad_masks.astype(np.int32)):
        raise RuntimeError("sample mask differs from the requested pad masks")
    if not np.isfinite(np.asarray(sample.continuous)).all():
        raise RuntimeError("non-finite kinematics in the sample")
    if not ((tokens[real] >= 0) & (tokens[real] < vocab_size)).all():
        raise RuntimeError("real particle with a token outside 0..V-1")
    if (tokens[~real] != 0).any() or (np.asarray(sample.continuous)[~real] != 0).any():
        raise RuntimeError("padded slot with a non-zero token or kinematics")
    return float((tokens[real] == 0).mean())


def sample_phase(system, params, pad_masks: np.ndarray, *, num_timesteps: int = 100,
                 pack_width: int = 128, batch_size: int = 128, seed: int = 0) -> None:
    """Packed sampling; jets wider than `pack_width` take the bucketed
    fallback.  The first call compiles, the second is timed."""
    from multimodal_flows.sampling.generator import generate_packed

    n_wide = int((pad_masks[..., 0].sum(1) > pack_width).sum())
    if n_wide == 0:
        raise RuntimeError("sample phase needs jets wider than pack_width")
    for label in ("first (compile)", "steady"):
        res = generate_packed(system, params, pad_masks, num_timesteps=num_timesteps,
                              pack_width=pack_width, batch_size=batch_size, seed=seed)
        pad_share = check_sample(res.sample, pad_masks, system.config.vocab_size)
        print(f"sample {label}: {len(pad_masks)} jets ({n_wide} bucketed, wider "
              f"than {pack_width}) x {num_timesteps} steps in {res.wall_time_s:.2f} s "
              f"= {res.jets_per_sec:.1f} jets/s; {pad_share:.4f} of real slots "
              f"decoded to the pad token")


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def precision_phase(system, params, pad_masks: np.ndarray, *, seed: int = 0) -> None:
    """One forward plus one hybrid tau-leap step at the default matmul
    precision against the same at "highest" precision."""
    import jax
    import jax.numpy as jnp

    from multimodal_flows.dynamics.solvers import time_grid
    from multimodal_flows.sampling.generator import make_noise_source

    cfg = system.config
    k_src, k_u = jax.random.split(jax.random.PRNGKey(seed))
    state = make_noise_source(k_src, pad_masks, cfg).replace(
        time=jnp.full((len(pad_masks),), 0.5, jnp.float32))
    u = jax.random.uniform(k_u, state.discrete.shape[:2], dtype=jnp.float32)
    _, dt = time_grid(cfg.time_eps, 100)

    def forward_and_step(p, s, u):
        vt, logits = system.module.apply(p, s)
        stepped, _ = system.make_solver(p).fwd_step_u(None, u, s, dt)
        return vt, logits, stepped.continuous, stepped.discrete

    default = jax.jit(forward_and_step)(params, state, u)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(forward_and_step)(params, state, u)
    real = pad_masks[..., 0] > 0
    worst = 0.0
    for name, a, b in zip(("drift", "logits", "stepped x"), default[:3], ref[:3]):
        a, b = np.asarray(a)[real], np.asarray(b)[real]
        rel = _rel_l2(a, b)
        worst = max(worst, rel)
        print(f"precision {name}: max-abs {np.abs(a - b).max():.3e}, rel-L2 {rel:.3e}")
    flips = float((np.asarray(default[3])[..., 0] != np.asarray(ref[3])[..., 0])[real].mean())
    print(f"precision stepped tokens: {flips:.4f} of real slots differ")
    if worst > PRECISION_REL_L2 or flips > PRECISION_TOKEN_FLIPS:
        raise RuntimeError(f"default precision off the highest-precision reference: "
                           f"rel-L2 {worst:.3e} (limit {PRECISION_REL_L2}), token "
                           f"flips {flips:.4f} (limit {PRECISION_TOKEN_FLIPS})")


def _max_abs_diff(a, b) -> float:
    import jax

    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def multichip_phase(cfg: Config, jets: MultiModal, n_devices: int = 4, *,
                    steps: int = 3, num_timesteps: int = 20) -> None:
    """Data-parallel packed training steps over an `n_devices` mesh against
    the same steps on one device; one FSDP and one tensor_parallel=2 step
    against the data-parallel loss; one sharded packed sampler run against
    the unsharded one."""
    import jax

    from multimodal_flows.data.packing import pack_multimodal, pad_rows
    from multimodal_flows.parallel.mesh import batch_sharding, make_mesh, make_mesh_2d
    from multimodal_flows.sampling.generator import generate_packed
    from multimodal_flows.train.systems import MMF
    from multimodal_flows.train.trainer import Trainer

    devices = jax.devices()[:n_devices]
    if len(devices) < n_devices:
        raise RuntimeError(f"multichip needs {n_devices} devices, JAX has {len(devices)}")
    cfg = cfg.replace(packed_training=True, use_ema_weights=True)
    packed, _ = pack_multimodal(jets, cfg.pack_width)
    packed = pad_rows(packed, 2 * n_devices)
    key = jax.random.PRNGKey(cfg.seed)

    def run(cfg_run, mesh, n_steps):
        trainer = Trainer(MMF(cfg_run), cfg_run, mesh=mesh, steps_per_epoch=10)
        state = trainer.init_state(key, steps_per_epoch=10)
        batch = jax.device_put(packed, batch_sharding(mesh))
        step = trainer.compiled_train_step()
        losses = []
        for i in range(n_steps):
            state, metrics = step(state, batch, jax.random.fold_in(key, i))
            losses.append(float(metrics["loss"]))
        return losses, jax.device_get(state.params)

    def check_losses(name, losses, ref):
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        print(f"multichip {name}: losses {losses}, max relative difference {rel:.3e}")
        if not np.isfinite(losses).all() or rel > MULTICHIP_LOSS_RTOL:
            raise RuntimeError(f"{name} loss off the one-device reference: {rel:.3e}")

    print(f"multichip: {len(packed)} packed rows of {cfg.pack_width} tokens "
          f"({len(jets)} jets) per step, {n_devices} devices, n_embd {cfg.n_embd}, "
          f"{cfg.n_layer}+{cfg.n_layer_fused} blocks")
    with jax.default_matmul_precision("highest"):
        ref_losses, ref_params = run(cfg, make_mesh(devices[:1]), steps)
        mesh = make_mesh(devices)
        dp_losses, dp_params = run(cfg, mesh, steps)
        check_losses("data-parallel", dp_losses, ref_losses)
        diff = _max_abs_diff(dp_params, ref_params)
        print(f"multichip data-parallel: params after {steps} steps, max-abs "
              f"difference {diff:.3e}")
        if diff > MULTICHIP_PARAM_ATOL:
            raise RuntimeError(f"data-parallel params off the one-device run: {diff:.3e}")
        check_losses("fsdp", run(cfg.replace(fsdp=True), mesh, 1)[0], ref_losses[:1])
        check_losses("tensor_parallel=2", run(cfg.replace(tensor_parallel=2),
                                              make_mesh_2d(2, devices), 1)[0],
                     ref_losses[:1])

        system = MMF(cfg)
        pad_masks = np.asarray(jets.mask)
        kw = dict(num_timesteps=num_timesteps, pack_width=cfg.pack_width,
                  batch_size=8 * n_devices, seed=cfg.seed)
        sharded = generate_packed(system, ref_params, pad_masks, mesh=mesh, **kw)
        single = generate_packed(system, ref_params, pad_masks, **kw)
    check_sample(sharded.sample, pad_masks, cfg.vocab_size)
    real = pad_masks[..., 0] > 0
    agree = float((sharded.sample.discrete == single.sample.discrete)[..., 0][real].mean())
    print(f"multichip sampler: {len(pad_masks)} jets x {num_timesteps} steps sharded "
          f"over {n_devices} devices; tokens agree with one device on {agree:.4f} "
          f"of real slots")
    if agree < 1.0 - PRECISION_TOKEN_FLIPS:
        raise RuntimeError(f"sharded sampler off the one-device sampler: {agree:.4f}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--multichip", action="store_true",
                        help="run only the four-card data/FSDP/tensor-parallel phase")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    device = device_guard()
    from multimodal_flows.utils import enable_compilation_cache

    print(f"compile cache: {enable_compilation_cache()}")
    if args.multichip:
        # flagship width; depth cut to 1+2 blocks, which keeps every sharded
        # layout (half-width and fused blocks) and bounds the compiles
        multichip_phase(flagship_config(seed=args.seed, n_layer=1, n_layer_fused=2),
                        synthetic_jets(256, 150, args.seed))
    else:
        cfg = flagship_config(seed=args.seed, batch_size=256)
        jets = synthetic_jets(8192, 150, args.seed, num_wide=16)
        system, params = train_phase(cfg, jets, OUT_DIR)
        sample_phase(system, params,
                     np.asarray(synthetic_jets(1024, 150, args.seed + 1, num_wide=32).mask),
                     seed=args.seed)
        precision_phase(system, params,
                        np.asarray(synthetic_jets(8, 150, args.seed + 2, num_wide=2).mask),
                        seed=args.seed)
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
