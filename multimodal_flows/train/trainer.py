"""The training loop: one jitted step, data-parallel over a mesh.

Replaces the reference's Lightning `Trainer(strategy='ddp')` stack
(`scripts/train_mmf.py:159-170`): loss + grad + Adam update + EMA fuse into
a single donated jit; the batch is sharded over the `data` mesh axis, so
the partitioner inserts the gradient all-reduce (the NCCL allreduce of the
reference) automatically.  Validation runs the same loss with the
EMA parameters (the reference's EMA swap callback,
`utils/callbacks.py:207-220`) and per-epoch means feed best-k
checkpointing on val_loss / val_loss_mse / val_loss_ce.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from multimodal_flows import pytree

from multimodal_flows.config import Config
from multimodal_flows.data.datasets import ArrayDataset, num_batches, shuffle_batches
from multimodal_flows.parallel.mesh import make_mesh
from multimodal_flows.train.checkpoints import CheckpointManager
from multimodal_flows.train.ema import ema_update
from multimodal_flows.train.lr_schedules import warmup_cosine_epoch_schedule
from multimodal_flows.utils.logger import MetricsLogger, SimpleLogger as log


class TrainState(pytree.PyTreeNode):
    params: Any
    opt_state: Any
    ema_params: Any          # None when EMA disabled
    step: jax.Array


class Trainer:
    def __init__(self, system, config: Config, mesh: Optional[object] = "auto",
                 steps_per_epoch: Optional[int] = None):
        self.system = system
        self.config = config
        if mesh == "auto" and config.tensor_parallel > 1:
            from multimodal_flows.parallel.mesh import make_mesh_2d

            self.mesh = make_mesh_2d(config.tensor_parallel)
        else:
            self.mesh = make_mesh() if mesh == "auto" else mesh
        self._steps_per_epoch = steps_per_epoch
        self._compiled = {}
        self._physics_ref = None  # (ref_obs, masks) cache for physics eval
        self._packed_row_bs = None  # rows/step preserving jets/step (_pack_units)

    # ------------------------------------------------------------ building

    def make_optimizer(self, steps_per_epoch: int):
        cfg = self.config
        schedule = warmup_cosine_epoch_schedule(
            cfg.lr, cfg.lr_final, cfg.warmup_epochs, cfg.max_epochs, steps_per_epoch)
        self.lr_schedule = schedule
        return optax.chain(
            optax.clip_by_global_norm(cfg.gradient_clip_val),
            optax.adam(schedule),
        )

    def init_state(self, key, steps_per_epoch: int) -> TrainState:
        params = self.system.init_params(key)
        if self.config.fsdp and self.config.tensor_parallel > 1:
            raise ValueError("fsdp and tensor_parallel are mutually exclusive")
        if self.config.fsdp and self.mesh is not None:
            # ZeRO-3-style: params (and everything derived from them — Adam
            # moments, EMA) live sharded over the data axis; jit inserts the
            # per-layer all-gathers / reduce-scatters
            from multimodal_flows.parallel.mesh import fsdp_sharding

            shardings = fsdp_sharding(params, self.mesh)
            params = jax.tree.map(jax.device_put, params, shardings)
        elif self.config.tensor_parallel > 1 and self.mesh is not None:
            # Megatron-style tensor parallelism: attention/MLP kernels live
            # sharded over the `model` axis; optimizer moments and EMA
            # inherit the layout, jit inserts the per-block all-reduces
            from multimodal_flows.parallel.mesh import tp_sharding

            shardings = tp_sharding(params, self.mesh)
            params = jax.tree.map(jax.device_put, params, shardings)
        self.tx = self.make_optimizer(steps_per_epoch)
        opt_state = self.tx.init(params)
        ema = jax.tree.map(jnp.copy, params) if self.config.use_ema_weights else None
        state = TrainState(params=params, opt_state=opt_state, ema_params=ema,
                           step=jnp.zeros((), jnp.int32))
        if (self.mesh is not None and not self.config.fsdp
                and self.config.tensor_parallel <= 1):
            # freshly-minted scalars (Adam's `count`, `step`) are committed
            # to device 0; replicate the whole train state over the mesh so
            # the jitted epoch sees one consistent device set (caught by
            # the round-3 verify drive: every earlier fit test ran mesh=None)
            from multimodal_flows.parallel.mesh import replicated_sharding

            state = jax.device_put(state, replicated_sharding(self.mesh))
        elif self.mesh is not None:
            # fsdp/tp: params (and the moments/EMA derived from them)
            # already carry mesh-wide NamedShardings, but the scalar leaves
            # sit on device 0.  Single-process jit silently re-replicates
            # uncommitted scalars; a multi-host checkpoint RESTORE gets the
            # single-device sharding back as a *committed* layout and jit
            # then rejects the mixed device set (caught by the round-4
            # 2-process restart test).  Replicate them over the mesh here
            # so both the live state and the restore target are consistent.
            from jax.sharding import NamedSharding

            from multimodal_flows.parallel.mesh import replicated_sharding

            rep = replicated_sharding(self.mesh)
            state = jax.tree.map(
                lambda x: x if isinstance(getattr(x, "sharding", None),
                                          NamedSharding)
                else jax.device_put(x, rep), state)
        return state

    # --------------------------------------------------------------- steps

    def _train_step(self, state: TrainState, batch, key):
        def loss_of(params):
            return self.system.loss_fn(params, batch, key, train=True)

        (loss, metrics), grads = jax.value_and_grad(loss_of, has_aux=True)(state.params)
        updates, opt_state = self.tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        if state.ema_params is not None:
            ema = ema_update(state.ema_params, params, self.config.ema_decay)
        else:
            ema = None
        new_state = TrainState(params=params, opt_state=opt_state, ema_params=ema,
                               step=state.step + 1)
        metrics = dict(metrics)
        metrics["grad_norm"] = optax.global_norm(grads)
        return new_state, metrics

    def _eval_step(self, state: TrainState, batch, key):
        params = state.ema_params if state.ema_params is not None else state.params
        _, metrics = self.system.loss_fn(params, batch, key, train=False)
        return metrics

    def compiled_train_step(self):
        if "train" not in self._compiled:
            self._compiled["train"] = jax.jit(self._train_step, donate_argnums=0)
        return self._compiled["train"]

    def compiled_eval_step(self):
        if "eval" not in self._compiled:
            self._compiled["eval"] = jax.jit(self._eval_step)
        return self._compiled["eval"]

    # ------------------------------------------------- epoch-compiled paths

    def _train_epoch(self, state: TrainState, epoch_batches, key):
        """One full training epoch as a single lax.scan over the
        device-resident batch stack (n_batches leading axis): one host
        dispatch per epoch instead of one per step."""

        def body(state, batch):
            k = jax.random.fold_in(key, state.step)
            return self._train_step(state, batch, k)

        return jax.lax.scan(body, state, epoch_batches)

    def _eval_epoch(self, state: TrainState, epoch_batches, key):
        def body(i, batch):
            k = jax.random.fold_in(key, i)
            return i + 1, self._eval_step(state, batch, k)

        _, metrics = jax.lax.scan(body, jnp.int32(0), epoch_batches)
        return metrics

    @staticmethod
    def _fetch_metrics(metrics_seq):
        """Fetch a {name: (n_b,)} metric dict in ONE device->host transfer
        (stacked on device first, instead of one transfer per leaf)."""
        names = sorted(metrics_seq)
        stacked = jnp.stack([metrics_seq[k].astype(jnp.float32) for k in names])
        fetched = np.asarray(stacked)
        return {k: fetched[i] for i, k in enumerate(names)}

    def compiled_train_epoch(self):
        if "train_epoch" not in self._compiled:
            self._compiled["train_epoch"] = jax.jit(self._train_epoch, donate_argnums=0)
        return self._compiled["train_epoch"]

    def compiled_eval_epoch(self):
        if "eval_epoch" not in self._compiled:
            self._compiled["eval_epoch"] = jax.jit(self._eval_epoch)
        return self._compiled["eval_epoch"]

    # ------------------------------------------ device-resident gather path

    def _train_epoch_gather(self, state: TrainState, data, idx, key):
        """One epoch over a device-RESIDENT dataset: per-step batches are
        gathered on device from host-computed permutation indices.

        The host ships the dataset to HBM once and then only (n_b, B) int32
        indices per epoch (~1 MB), instead of restacking ~hundreds of MB of
        batches every epoch, which on a small host dominates the epoch.
        Batch composition is identical to `shuffle_batches` (same
        permutation stream), so the parameter trajectory matches the
        stacked path bit for bit."""

        def body(state, batch_idx):
            batch = jax.tree.map(lambda a: a[batch_idx], data)
            k = jax.random.fold_in(key, state.step)
            return self._train_step(state, batch, k)

        return jax.lax.scan(body, state, idx)

    def _eval_epoch_gather(self, state: TrainState, data, idx, key):
        def body(i, batch_idx):
            batch = jax.tree.map(lambda a: a[batch_idx], data)
            k = jax.random.fold_in(key, i)
            return i + 1, self._eval_step(state, batch, k)

        _, metrics = jax.lax.scan(body, jnp.int32(0), idx)
        return metrics

    def compiled_train_epoch_gather(self):
        if "train_epoch_gather" not in self._compiled:
            self._compiled["train_epoch_gather"] = jax.jit(
                self._train_epoch_gather, donate_argnums=0)
        return self._compiled["train_epoch_gather"]

    def compiled_eval_epoch_gather(self):
        if "eval_epoch_gather" not in self._compiled:
            self._compiled["eval_epoch_gather"] = jax.jit(self._eval_epoch_gather)
        return self._compiled["eval_epoch_gather"]

    def _use_resident_gather(self, ds: ArrayDataset, batch_size: int) -> bool:
        """Resident-gather is used on single-device runs whose dataset fits
        the HBM budget.  Multi-device meshes keep the stacked path: a
        gather of arbitrary global rows into a data-sharded batch would
        insert a cross-device collective every step, while stacked batches
        shard with zero communication."""
        if self.mesh is not None and self.mesh.devices.size > 1:
            return False
        data_bytes = sum(a.nbytes for a in jax.tree.leaves(ds.coupling))
        return data_bytes <= self.config.epoch_hbm_budget_mb * (1 << 20)

    @staticmethod
    def _epoch_perm(n: int, batch_size: int, *, shuffle: bool, seed: int,
                    epoch: int, pad_last: bool = False) -> np.ndarray:
        """(n_b, B) row indices for one epoch — the exact index stream of
        `shuffle_batches` (same SeedSequence), reshaped for the gather path."""
        idx = np.arange(n)
        if shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
            rng.shuffle(idx)
        num_full = n // batch_size
        out = idx[:num_full * batch_size].reshape(num_full, batch_size)
        rem = n - num_full * batch_size
        if rem and pad_last:
            import math as _math

            tail = np.tile(idx[num_full * batch_size:],
                           _math.ceil(batch_size / rem))[:batch_size]
            out = np.concatenate([out, tail[None]], axis=0)
        return out.astype(np.int32)

    # ------------------------------------------------- multiplicity buckets

    @staticmethod
    def _truncate_width(coupling, w: int):
        """Drop pad columns beyond width w (valid for first-n masks only)."""
        def trunc(a):
            return a[:, :w] if (a is not None and a.ndim >= 2) else a

        from multimodal_flows.data.state import DataCoupling, MultiModal

        def tmm(mm):
            return MultiModal(
                time=mm.time,
                continuous=trunc(mm.continuous),
                discrete=trunc(mm.discrete),
                mask=trunc(mm.mask),
            )

        return DataCoupling(source=tmm(coupling.source), target=tmm(coupling.target),
                            context=coupling.context)

    def _bucketize(self, ds: ArrayDataset, min_size: int = 1):
        """Split a dataset into multiplicity buckets of static widths
        (config.bucket_widths + the full width).  Returns
        [(width, ArrayDataset, indices)] or None when masks aren't
        first-n filled (bucketing would drop real particles).

        Buckets smaller than `min_size` (the batch size) are merged into the
        next wider bucket — lossless, since truncation keeps all particles
        at any width >= multiplicity — so no jet is ever systematically
        excluded from training by the bucket partition."""
        mask = np.asarray(ds.coupling.target.mask)
        D = mask.shape[1]
        mult = mask[..., 0].sum(axis=1)
        first_n = (mask[..., 0].cumsum(axis=1) ==
                   np.minimum(np.arange(1, D + 1)[None, :], mult[:, None])).all()
        if not first_n:
            return None
        widths = sorted(w for w in self.config.bucket_widths if w < D) + [D]
        raw = []
        lo = -1
        for w in widths:
            sel = np.where((mult <= w) & (mult > lo))[0]
            lo = w
            if len(sel):
                raw.append((w, sel))

        # merge undersized buckets upward into the next wider bucket
        merged = []
        carry_sel, carry_w = None, None
        for w, sel in raw:
            if carry_sel is not None:
                sel = np.concatenate([carry_sel, sel])
                carry_sel = None
            if len(sel) < min_size:
                carry_sel, carry_w = sel, w
            else:
                merged.append((w, sel))
        if carry_sel is not None:
            if merged:
                # the widest bucket(s) were undersized: fold the widest
                # surviving bucket into them at the carried (wider) width
                w_prev, sel_prev = merged.pop()
                merged.append((max(w_prev, carry_w),
                               np.concatenate([sel_prev, carry_sel])))
            else:
                merged.append((carry_w, carry_sel))

        return [(w, ArrayDataset(self._truncate_width(ds.coupling[sel], w)), sel)
                for w, sel in merged]

    # --------------------------------------------------- packed training

    def _pack_units(self, ds: ArrayDataset):
        """Pack a dataset into multi-jet rows for packed training.

        Returns a list of `PackedDataset` units — the W=pack_width packed
        rows, plus (when some jets are wider than pack_width) a singleton-
        rows unit at the native width — or None when packing does not
        apply (non-first-n masks, or explicit sources in the coupling,
        which the packed loss would ignore).  Each unit is padded with
        empty rows to a batch multiple so nothing is dropped by drop_last
        and every batch compiles at one shape.

        Packing is computed ONCE per dataset (best-fit-decreasing is a
        host-side Python loop); epochs shuffle rows, not jets — jets
        sharing a row co-occur in every batch, which is statistically
        benign at >=3 jets/row x 128 rows/batch since each jet still draws
        its own t every epoch.
        """
        from multimodal_flows.data.packing import (
            PackedDataset, pack_multimodal, pad_rows, singleton_rows)

        cfg = self.config
        if getattr(cfg, "use_pos_emb", False):
            # learned positional embeddings index absolute row slots; a
            # packed row would leak cross-jet positions (the model raises
            # on segments + use_pos_emb) — fall back to unpacked training
            log.warn("packed_training disabled: learned positional "
                     "embeddings (use_pos_emb) are incompatible with "
                     "multi-jet packed rows")
            return None
        src = ds.coupling.source
        if src.continuous is not None or src.discrete is not None:
            log.warn("packed_training disabled: coupling has explicit "
                     "sources (packed loss draws sources per token)")
            return None
        target = ds.coupling.target
        try:
            packed, leftover = pack_multimodal(target, cfg.pack_width)
        except ValueError:
            log.warn("packed_training disabled: masks are not first-n filled")
            return None

        # `batch_size` means JETS per optimizer step, matching the
        # unpacked/bucketed paths: rows carry ~2-4 jets each, so batching
        # cfg.batch_size ROWS would take ~3x fewer (and ~3x bigger) steps
        # per epoch — silently changing the optimization trajectory AND
        # stretching the EMA horizon (1/(1-decay) steps) from ~9 to ~25
        # epochs at the flagship point.  Measured on the 300-epoch r04
        # flagship: rows-as-batch closed at W1(pt) 8.35 where round 3's
        # bucketed run (same jets/step as this conversion) closed at 0.82.
        # The row batch is computed once from the realized packing density
        # and cached so train/val/physics-eval units share one shape.
        if self._packed_row_bs is None:
            n_jets = len(target)
            n_rows = (len(packed) if packed is not None else 0) + len(leftover)
            jets_per_row = max(n_jets / max(n_rows, 1), 1.0)
            row_bs = max(int(round(cfg.batch_size / jets_per_row)), 1)
            if self.mesh is not None:
                from multimodal_flows.parallel.mesh import data_axis_size

                n_dev = data_axis_size(self.mesh)
                row_bs = max((row_bs // n_dev) * n_dev, n_dev)
            self._packed_row_bs = min(row_bs, cfg.batch_size)
            log.info(f"packed training: {jets_per_row:.2f} jets/row -> "
                     f"{self._packed_row_bs} rows per step "
                     f"(~{cfg.batch_size} jets/step)")
        row_bs = self._packed_row_bs

        units = []
        if packed is not None:
            units.append(PackedDataset(pad_rows(packed, row_bs)))
        if len(leftover):
            units.append(PackedDataset(pad_rows(
                singleton_rows(target[leftover]), row_bs)))
        return units or None

    def _ship_stack(self, batches):
        """Stack a list of host batches along a new scan axis and ship to
        the device(s) in one transfer."""
        stacked = jax.tree.map(lambda *xs: np.stack(xs), *batches)
        if self.mesh is None:
            return jax.tree.map(jnp.asarray, stacked)
        # shard the per-step batch axis (axis 1); the scan axis stays unsharded
        from jax.sharding import NamedSharding, PartitionSpec as P

        sharding = NamedSharding(self.mesh, P(None, "data"))
        if jax.process_count() == 1:
            put = lambda a: jax.device_put(a, sharding)
        else:
            # every host computed the same shuffle (shared seed); keep only
            # this process's rows of the sharded batch axis
            from multimodal_flows.parallel.mesh import local_batch_shard

            put = lambda a: jax.make_array_from_process_local_data(
                sharding, local_batch_shard(np.asarray(a), axis=1))
        return jax.tree.map(put, stacked)

    def _stack_epoch(self, ds: ArrayDataset, batch_size: int, *, shuffle: bool,
                     seed: int = 0, epoch: int = 0, pad_last: bool = False):
        """Host-side: gather an epoch's batches into one (n_batches, B, ...)
        pytree and ship it to the device(s) in a single transfer."""
        batches = list(shuffle_batches(ds, batch_size, shuffle=shuffle, seed=seed,
                                       epoch=epoch, drop_last=not pad_last,
                                       pad_last=pad_last))
        return self._ship_stack(batches), len(batches)

    def _chunk_len(self, ds: ArrayDataset, batch_size: int) -> int:
        """Batches per device-resident super-chunk under the HBM budget.

        The whole-epoch stack was the round-2 design; at the reference's
        1.25M-jet scale (`scripts/train_mmf.py:30`) that stack alone is
        ~5-6 GB and the resident val stacks compound it, so epochs larger
        than `epoch_hbm_budget_mb` stream in chunks instead.  Half the
        budget per chunk: the next chunk's host->device transfer overlaps
        the current chunk's compute (async dispatch double-buffers it)."""
        per_jet = sum(a.nbytes for a in jax.tree.leaves(ds.coupling)) / max(len(ds), 1)
        per_batch = max(per_jet * batch_size, 1.0)
        budget = self.config.epoch_hbm_budget_mb * (1 << 20)
        return max(1, int(budget / 2 / per_batch))

    def _epoch_chunks(self, ds: ArrayDataset, batch_size: int, *, shuffle: bool,
                      seed: int = 0, epoch: int = 0, pad_last: bool = False):
        """Yield (device_stack, n_batches) super-chunks of one epoch.

        Chunking only splits the epoch `lax.scan`; the train step folds
        its RNG from `state.step`, so the parameter trajectory is
        bit-identical to the resident path (tests/test_training.py)."""
        batches = list(shuffle_batches(ds, batch_size, shuffle=shuffle, seed=seed,
                                       epoch=epoch, drop_last=not pad_last,
                                       pad_last=pad_last))
        chunk = self._chunk_len(ds, batch_size)
        if len(batches) <= chunk:
            yield self._ship_stack(batches), len(batches)
            return
        # equal-size chunks (+ one tail size) so jit compiles at most two
        # scan lengths, reused every epoch
        for lo in range(0, len(batches), chunk):
            part = batches[lo:lo + chunk]
            yield self._ship_stack(part), len(part)

    # ----------------------------------------------------------------- fit

    def fit(self, train_ds: ArrayDataset, val_ds: ArrayDataset,
            resume: Optional[str] = None) -> TrainState:
        cfg = self.config
        if self.mesh is not None:
            # batch shards over the data axis only (a 2-D mesh replicates
            # the batch over `model`)
            n_dev = dict(zip(self.mesh.axis_names, self.mesh.devices.shape)).get(
                "data", self.mesh.devices.size)
            assert cfg.batch_size % n_dev == 0, (
                f"batch_size {cfg.batch_size} must be divisible by the "
                f"{n_dev}-device data axis")
        # packed training: convert datasets to multi-jet row units up front
        # (affects steps-per-epoch, hence the LR schedule)
        packed_train_units = packed_val_units = None
        if cfg.packed_training:
            if cfg.bucketed_training:
                raise ValueError(
                    "packed_training and bucketed_training are mutually exclusive")
            packed_train_units = self._pack_units(train_ds)
            packed_val_units = self._pack_units(val_ds) if packed_train_units else None
            if packed_val_units is None:
                packed_train_units = None  # all-or-nothing fallback

        bs_fit = (self._packed_row_bs if packed_train_units is not None
                  else cfg.batch_size)
        if packed_train_units is not None:
            spe = self._steps_per_epoch or max(
                sum(num_batches(len(u), bs_fit) for u in packed_train_units), 1)
        else:
            spe = self._steps_per_epoch or max(num_batches(len(train_ds), cfg.batch_size), 1)

        key = jax.random.PRNGKey(cfg.seed)
        k_init, k_train = jax.random.split(key)
        state = self.init_state(k_init, spe)

        exp_dir = cfg.experiment_dir if cfg.experiment_id else os.path.join(cfg.dir, "scratch")
        ckpt = CheckpointManager(os.path.join(exp_dir, "checkpoints"),
                                 top_k=cfg.save_top_k,
                                 physics_margin=cfg.physics_eval_margin)
        logger = MetricsLogger(
            exp_dir,
            wandb_project=cfg.project if cfg.use_wandb else None,
            wandb_name=cfg.experiment_id,
            wandb_config=cfg.to_dict() if cfg.use_wandb else None)

        start_epoch = 0
        if resume and ckpt.has(resume):
            restored = ckpt.load(self._to_ckpt(state), name=resume)
            state = self._from_ckpt(state, restored)
            start_epoch = int(restored["epoch"])
            log.info(f"resumed from {resume!r} at epoch {start_epoch}")
        elif cfg.ckpt_path:
            # explicit warm start from a checkpoint dir outside this
            # experiment (reference `--ckpt_path`, train_mmf.py:24,170)
            restored = CheckpointManager.load_path(self._to_ckpt(state), cfg.ckpt_path)
            state = self._from_ckpt(state, restored)
            start_epoch = int(restored["epoch"])
            log.info(f"warm-started from {cfg.ckpt_path} at epoch {start_epoch}")

        train_epoch_fn = self.compiled_train_epoch()
        eval_epoch_fn = self.compiled_eval_epoch()
        global_step = start_epoch * spe  # python-side mirror of state.step

        # multiplicity bucketing (opt-in): jets grouped into static widths;
        # one compile per width (jit re-specializes on shape), batches are
        # within-bucket — skips the pad-column compute
        train_buckets = val_buckets = None
        if cfg.bucketed_training:
            train_buckets = self._bucketize(train_ds, min_size=cfg.batch_size)
            val_buckets = self._bucketize(val_ds)
            if train_buckets is None or val_buckets is None:
                log.warn("bucketed_training disabled: masks are not first-n filled")
                train_buckets = val_buckets = None

        # device-resident gather mode (single-device + dataset fits HBM):
        # ship each (bucket) dataset to the device ONCE; epochs gather
        # their batches on device from host permutation indices
        def ship_resident(ds):
            return jax.tree.map(
                lambda a: jnp.asarray(a),
                ds.coupling) if self._use_resident_gather(ds, cfg.batch_size) else None

        if packed_train_units is not None:
            train_units = [(u, ship_resident(u)) for u in packed_train_units]
        elif train_buckets is None:
            train_units = [(train_ds, ship_resident(train_ds))]
        else:
            train_units = [(b_ds, ship_resident(b_ds)) for _, b_ds, _ in train_buckets]

        # the val stack(s) are deterministic — build and ship once when they
        # fit the HBM budget, else stream per epoch
        def build_val(ds):
            n = len(ds)
            n_batches = num_batches(n, bs_fit, drop_last=False)
            weights = [min(bs_fit, n - i * bs_fit)
                       for i in range(n_batches)]
            data_dev = ship_resident(ds)
            if data_dev is not None:
                idx = jnp.asarray(self._epoch_perm(
                    n, bs_fit, shuffle=False, seed=0, epoch=0,
                    pad_last=True))
                return ("gather", (data_dev, idx), weights)
            if n_batches <= self._chunk_len(ds, bs_fit):
                stack, _ = self._stack_epoch(ds, bs_fit, shuffle=False,
                                             pad_last=True)
                return ("resident", stack, weights)
            return ("stream", ds, weights)

        if packed_val_units is not None:
            val_sets = [build_val(u) for u in packed_val_units]
        elif val_buckets is None:
            val_sets = [build_val(val_ds)]
        else:
            val_sets = [build_val(b_ds) for _, b_ds, _ in val_buckets]

        for epoch in range(start_epoch, cfg.max_epochs):
            t0 = time.time()
            # ---- train: one compiled scan per epoch (per bucket)
            k_epoch = jax.random.fold_in(k_train, epoch)

            def run_unit(state, ds, data_dev, key):
                """Train one dataset for one epoch via the resident-gather
                path when shipped, else chunked stacks.  Returns
                (state, [(metrics_seq, n_batches), ...])."""
                outs = []
                if data_dev is not None:
                    idx = self._epoch_perm(len(ds), bs_fit,
                                           shuffle=True, seed=cfg.seed,
                                           epoch=epoch)
                    state, metrics_seq = self.compiled_train_epoch_gather()(
                        state, data_dev, jnp.asarray(idx), key)
                    outs.append((self._fetch_metrics(metrics_seq), idx.shape[0]))
                else:
                    # depth-2 pipeline: fetch chunk i-1's metrics (blocking
                    # until its scan finishes) only right before dispatching
                    # chunk i, so the generator's host restack + transfer of
                    # chunk i overlaps chunk i-1's compute.  At most two
                    # half-budget stacks are live, honoring the HBM budget.
                    # Fetching inside the loop body instead would serialize
                    # transfer and compute.
                    pend = None
                    for stack, n_b in self._epoch_chunks(
                            ds, bs_fit, shuffle=True, seed=cfg.seed,
                            epoch=epoch):
                        if pend is not None:
                            outs.append((self._fetch_metrics(pend[0]), pend[1]))
                        state, metrics_seq = train_epoch_fn(state, stack, key)
                        pend = (metrics_seq, n_b)
                    if pend is not None:
                        outs.append((self._fetch_metrics(pend[0]), pend[1]))
                return state, outs

            accum, weights = [], []
            if train_buckets is None and len(train_units) == 1:
                ds0, dev0 = train_units[0]
                state, outs = run_unit(state, ds0, dev0, k_epoch)
                for m, n_b in outs:
                    accum.append(m)
                    weights.append(n_b)
                    global_step += n_b
            else:
                # random unit order per epoch (avoids a fixed curriculum
                # over buckets / packed units)
                rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, epoch, 77]))
                for bi in rng.permutation(len(train_units)):
                    u_ds, u_dev = train_units[bi]
                    if train_buckets is not None:
                        w = train_buckets[bi][0]
                        if len(u_ds) < cfg.batch_size:
                            # only possible when the WHOLE dataset is smaller
                            # than one batch (buckets merge up to batch_size;
                            # packed units are padded to batch multiples)
                            log.warn(f"bucket width {w}: {len(u_ds)} jets < "
                                     f"batch_size {cfg.batch_size}; skipped")
                            continue
                    state, outs = run_unit(state, u_ds, u_dev,
                                           jax.random.fold_in(k_epoch, int(bi)))
                    for m, n_b in outs:
                        accum.append(m)
                        weights.append(n_b)
                        global_step += n_b
            train_metrics = _combine_stacked(accum, weights, prefix="train_")

            # ---- validate with EMA params when enabled (tail batch padded;
            # means weighted by real jet count)
            k_val = jax.random.fold_in(k_train, 1_000_000_000 + epoch)
            v_accum, v_weights = [], []
            for kind, payload, weights in val_sets:
                if kind == "gather":
                    data_dev, idx = payload
                    v_accum.append(self._fetch_metrics(
                        self.compiled_eval_epoch_gather()(state, data_dev, idx, k_val)))
                elif kind == "resident":
                    v_accum.append(self._fetch_metrics(
                        eval_epoch_fn(state, payload, k_val)))
                else:
                    # stream oversized val sets chunk by chunk, concatenating
                    # the per-batch metric stacks
                    parts = []
                    for ci, (stack, _) in enumerate(self._epoch_chunks(
                            payload, bs_fit, shuffle=False, pad_last=True)):
                        m = eval_epoch_fn(state, stack,
                                          jax.random.fold_in(k_val, ci))
                        parts.append(jax.tree.map(np.asarray, m))
                    v_accum.append({k: np.concatenate([p[k] for p in parts])
                                    for k in parts[0]})
                v_weights.append(weights)
            if len(v_accum) == 1:
                val_metrics = _mean_stacked(v_accum[0], prefix="val_",
                                            weights=v_weights[0])
            else:
                val_metrics = _combine_stacked(
                    v_accum, [sum(w) for w in v_weights], prefix="val_",
                    inner_weights=v_weights)

            # ---- periodic in-training physics eval (best_physics slot):
            # sample a few thousand jets at a low step count and score
            # W1(pt/mass/mult) vs the val set — the val-loss monitors
            # mis-rank sample quality (CLOSURE_r03: W1(pt) 15.6 for the
            # val-loss `best` slot vs 0.82 for the end-of-cosine EMA)
            did_physics = False
            if cfg.physics_eval_every_n_epochs > 0 and (
                    (epoch + 1) % cfg.physics_eval_every_n_epochs == 0
                    or epoch == cfg.max_epochs - 1):
                val_metrics.update(self._run_physics_eval(state, val_ds, epoch))
                did_physics = "val_w1_physics" in val_metrics

            epoch_metrics = {**train_metrics, **val_metrics,
                             "epoch": epoch,
                             "lr": float(self.lr_schedule(global_step)),
                             "epoch_time_s": time.time() - t0}
            logger.log(int(state.step), epoch_metrics)

            if ((epoch + 1) % cfg.checkpoint_every_n_epochs == 0
                    or epoch == cfg.max_epochs - 1 or did_physics):
                ckpt.save(self._to_ckpt(state, epoch=epoch + 1), val_metrics, epoch + 1)

            log.info(
                f"epoch {epoch}: train_loss={train_metrics.get('train_loss', float('nan')):.4f} "
                f"val_loss={val_metrics.get('val_loss', float('nan')):.4f} "
                f"({epoch_metrics['epoch_time_s']:.1f}s)")

        logger.close()
        return state

    # -------------------------------------------------------- physics eval

    def _run_physics_eval(self, state: TrainState, val_ds: ArrayDataset,
                          epoch: int) -> Dict[str, float]:
        """Sample with the current (EMA) params and score W1 vs the val
        set (train/physics_eval.py).  The reference observables and masks
        are computed once per fit and cached; generation reuses the packed
        sampler's compile cache across evals (same shapes every time)."""
        from multimodal_flows.train.physics_eval import (
            physics_metrics, reference_observables)

        cfg = self.config
        target = val_ds.coupling.target
        if target.mask is None:
            return {}
        n = min(cfg.physics_eval_num_jets, len(target))
        if self._physics_ref is None:
            self._physics_ref = (
                reference_observables(target, cfg.metadata, n),
                np.asarray(target.mask)[:n],
            )
        ref_obs, masks = self._physics_ref
        params = state.ema_params if state.ema_params is not None else state.params
        t0 = time.time()
        try:
            # Common random numbers: ONE fixed generation seed for every
            # eval of the run, so successive scores differ only through
            # the params and the shared sampling noise cancels in the
            # ranking.  Round 5 measured the alternative (reseeding per
            # eval, seed + 104729*(epoch+1)) to mis-rank: each of the ~30
            # scores carried the full few-thousand-jet sampling variance
            # and the argmin picked a noise dip — `best_physics` chose a
            # checkpoint scoring W1(pt) 1.94 at 50k/500 over the 0.89
            # end-of-cosine EMA (CLOSURE_r05.md run 1, PHYSEVAL_CRN_r05.md).
            out = physics_metrics(
                self.system, params, ref_obs, masks,
                num_timesteps=cfg.physics_eval_num_timesteps,
                metadata=cfg.metadata, batch_size=cfg.batch_size,
                seed=cfg.seed + 104729, mesh=self.mesh,
                pack_width=cfg.pack_width)
        except Exception as e:  # never let a metric kill a long run
            log.warn(f"physics eval failed at epoch {epoch}: {e!r}")
            return {}
        if "val_w1_physics" in out:
            log.info(f"physics eval: w1={out['val_w1_physics']:.4f} "
                     + " ".join(f"{k.removeprefix('val_w1_')}={v:.3f}"
                                for k, v in out.items()
                                if k != "val_w1_physics")
                     + f" ({time.time() - t0:.1f}s)")
        return out

    # ----------------------------------------------------------- inference

    def load_for_inference(self, name: str = "best", use_ema: Optional[bool] = None):
        """Restore a checkpoint slot and return the parameters to predict
        with (EMA when enabled — the reference applies EMA weights in
        `EMACallback.on_predict_start`, `utils/callbacks.py:182-201`)."""
        cfg = self.config
        spe = self._steps_per_epoch or 1
        state = self.init_state(jax.random.PRNGKey(0), spe)
        ckpt = CheckpointManager(os.path.join(cfg.experiment_dir, "checkpoints"))
        restored = ckpt.load(self._to_ckpt(state), name=name)
        want_ema = cfg.use_ema_weights if use_ema is None else use_ema
        if want_ema and "ema_params" in restored:
            return restored["ema_params"]
        return restored["params"]

    # -------------------------------------------------------- ckpt mapping

    def _to_ckpt(self, state: TrainState, epoch: int = 0):
        d = {"params": state.params, "opt_state": state.opt_state,
             "step": state.step, "epoch": np.full((), epoch, np.int32)}
        if state.ema_params is not None:
            d["ema_params"] = state.ema_params
        return d

    def _from_ckpt(self, template: TrainState, restored) -> TrainState:
        return TrainState(
            params=restored["params"],
            opt_state=restored["opt_state"],
            ema_params=restored.get("ema_params", template.ema_params),
            step=jnp.asarray(restored["step"], jnp.int32),
        )


def _combine_stacked(accum, weights, prefix: str = "", inner_weights=None
                     ) -> Dict[str, float]:
    """Weighted mean across several scan-stacked metric dicts (one per
    bucket); `inner_weights` optionally weights within each stack."""
    if not accum:
        return {}
    per = []
    for i, m in enumerate(accum):
        iw = inner_weights[i] if inner_weights is not None else None
        per.append(_mean_stacked(m, prefix=prefix, weights=iw))
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    return {k: float(sum(p[k] * wi for p, wi in zip(per, w))) for k in per[0]}


def _mean_stacked(metrics_seq, prefix: str = "", weights=None) -> Dict[str, float]:
    """Mean over a scan-stacked metrics dict {name: (n_batches,)} — one
    host fetch per epoch."""
    ws = None if weights is None else np.asarray(weights, np.float64)
    out = {}
    for k, v in metrics_seq.items():
        v = np.asarray(v, np.float64)
        out[prefix + k] = float(v.mean() if ws is None else (v * ws).sum() / ws.sum())
    return out


def _mean_metrics(accum, prefix: str = "", weights=None) -> Dict[str, float]:
    if not accum:
        return {}
    if weights is None:
        w = np.ones(len(accum))
    else:
        w = np.asarray(weights, dtype=np.float64)
    w = w / w.sum()
    out = {}
    for k in accum[0]:
        vals = np.asarray([float(m[k]) for m in accum])
        out[prefix + k] = float((vals * w).sum())
    return out
