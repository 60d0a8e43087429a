"""Generation system: batched, jitted, device-resident sampling.

Replaces the reference predict path (`scripts/sample_mmf.py:58-114` +
`utils/callbacks.py:14-62`): where the reference steps a Python loop per
timestep per rank and gathers per-rank temp files over the shared
filesystem, here each batch runs one `lax.scan`-compiled trajectory on
device (sharded over the data mesh), only final states cross to host, and
multi-host gather (when needed) uses `multihost_utils.process_allgather`
instead of the filesystem.

Destandardization with the dataset metadata and final pad masking happen
on host before writing `generated_sample.h5` + `configs.yaml`, exactly
like the reference generator callback (`callbacks.py:52-62`).
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import yaml

from multimodal_flows.config import Config
from multimodal_flows.data.state import MultiModal
from multimodal_flows.dynamics.solvers import scan_unroll
from multimodal_flows.ops.attention import (fast_inference_softmax,
                                                  fast_softmax_would_apply)
from multimodal_flows.utils.logger import SimpleLogger as log


@dataclasses.dataclass
class GenerationResult:
    sample: MultiModal           # destandardized, masked, on host
    jets_per_sec: float
    wall_time_s: float
    num_timesteps: int
    temperature: float
    tag: str = ""


def make_noise_source(key, pad_mask: np.ndarray, config: Config) -> MultiModal:
    """Noise source for generation (reference `sample_mmf.py:80-86`):
    continuous ~ N(0,1)*mask, tokens ~ U{1..V-1}*mask, t0 = time_eps."""
    B, D = pad_mask.shape[0], pad_mask.shape[1]
    k_x, k_k = jax.random.split(key)
    mask = jnp.asarray(pad_mask, jnp.int32)
    x = jax.random.normal(k_x, (B, D, config.dim_continuous), jnp.float32) * mask
    k = jax.random.randint(k_k, (B, D, 1), 1, config.vocab_size, jnp.int32) * mask
    t0 = jnp.full((B,), config.time_eps, jnp.float32)
    return MultiModal(time=t0, continuous=x, discrete=k, mask=mask)


def _snap_batch(n: int) -> int:
    """Smallest batch on the {8, 16, 32, then multiples of 64} ladder that
    fits n rows — bounds the number of distinct tail programs ever
    compiled."""
    for b in (8, 16, 32):
        if n <= b:
            return b
    return ((n + 63) // 64) * 64


def generate(
    system,
    params,
    pad_masks: np.ndarray,
    *,
    num_timesteps: int,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    use_final_max_rates: bool = False,
    batch_size: int = 256,
    seed: int = 0,
    mesh=None,
    metadata: Optional[Dict] = None,
    max_dispatch_steps: int = 8_000,
) -> GenerationResult:
    """Generate jets for every pad mask row, batched at a static shape.

    Each dispatch is one compiled scan-of-scans (see below); the tail batch
    is padded to `batch_size` and trimmed after, so `num_timesteps` and the
    batch count are the only compile-relevant knobs.

    `max_dispatch_steps` bounds batches*timesteps per device program:
    larger runs split into several dispatches of at most that many batch
    steps each.
    """
    cfg = system.config
    num_jets = pad_masks.shape[0]
    key = jax.random.PRNGKey(seed)

    # chunk very long runs into bounded device programs
    batches_cap = max(1, max_dispatch_steps // max(num_timesteps, 1))
    cap_jets = batches_cap * batch_size
    if num_jets > cap_jets:
        pieces = []
        wall = 0.0
        for i, lo in enumerate(range(0, num_jets, cap_jets)):
            part = generate(system, params, pad_masks[lo:lo + cap_jets],
                            num_timesteps=num_timesteps, temperature=temperature,
                            top_k=top_k, top_p=top_p,
                            use_final_max_rates=use_final_max_rates,
                            batch_size=batch_size, seed=seed + 7919 * i,
                            mesh=mesh, metadata=metadata,
                            max_dispatch_steps=max_dispatch_steps)
            pieces.append(part.sample)
            wall += part.wall_time_s
        sample = MultiModal.concat(pieces)
        return GenerationResult(sample=sample, jets_per_sec=num_jets / wall,
                                wall_time_s=wall, num_timesteps=num_timesteps,
                                temperature=temperature)

    if mesh is not None:
        from multimodal_flows.parallel.mesh import data_axis_size, replicated_sharding

        n_data = data_axis_size(mesh)
        assert batch_size % n_data == 0, (
            f"batch_size {batch_size} must be divisible by the "
            f"{n_data}-device data axis")
        params = jax.device_put(params, replicated_sharding(mesh))

    # tail shrinking: when the last partial batch would waste >=64 rows of
    # padding, run it as a separate smaller program (sizes snap to the
    # {8,16,32, multiples of 64} ladder so repeat calls reuse a handful of
    # compiles) instead of padding to the full batch size — a one-jet tail
    # bucket otherwise costs a whole `batch_size` trajectory (~12 s at
    # 1000 steps for 255 padded jets)
    rem = num_jets % batch_size
    if (mesh is None and 0 < rem and num_jets > rem
            and batch_size - _snap_batch(rem) >= 64):
        head = generate(system, params, pad_masks[:num_jets - rem],
                        num_timesteps=num_timesteps, temperature=temperature,
                        top_k=top_k, top_p=top_p,
                        use_final_max_rates=use_final_max_rates,
                        batch_size=batch_size, seed=seed, mesh=mesh,
                        metadata=metadata, max_dispatch_steps=max_dispatch_steps)
        tail = generate(system, params, pad_masks[num_jets - rem:],
                        num_timesteps=num_timesteps, temperature=temperature,
                        top_k=top_k, top_p=top_p,
                        use_final_max_rates=use_final_max_rates,
                        batch_size=batch_size, seed=seed + 104729, mesh=mesh,
                        metadata=metadata, max_dispatch_steps=max_dispatch_steps)
        sample = MultiModal.concat([head.sample, tail.sample])
        wall = head.wall_time_s + tail.wall_time_s
        return GenerationResult(sample=sample, jets_per_sec=num_jets / wall,
                                wall_time_s=wall, num_timesteps=num_timesteps,
                                temperature=temperature)
    if mesh is None and num_jets < batch_size:
        # shrink the program to the snapped batch ladder
        batch_size = min(_snap_batch(num_jets), batch_size)

    # All batches run inside ONE compiled scan-of-scans: the outer scan walks
    # the stacked pad masks (noise drawn on device per batch), the inner scan
    # is the `num_timesteps` trajectory.  One host dispatch per generation
    # run.
    # Temperature is a traced argument so sweeping T reuses the compile; the
    # jitted sampler is cached on the system keyed by the static knobs.
    n_batches = (num_jets + batch_size - 1) // batch_size
    total = n_batches * batch_size
    masks = pad_masks
    if total > num_jets:  # pad tail to the static batch shape
        pad = np.repeat(masks[-1:], total - num_jets, axis=0)
        masks = np.concatenate([masks, pad], axis=0)
    masks_stacked = masks.reshape(n_batches, batch_size, *masks.shape[1:])

    cache = getattr(system, "_sim_cache", None)
    if cache is None:
        cache = system._sim_cache = {}
    sig = (num_timesteps, top_k, top_p, use_final_max_rates, batch_size,
           n_batches, masks.shape[1], fast_softmax_would_apply(), scan_unroll())

    if sig not in cache:

        def run_all(p, key, masks_dev, temp):
            def body(k, mask_b):
                k, k_noise, k_sim = jax.random.split(k, 3)
                src = make_noise_source(k_noise, mask_b, cfg)
                final = system.simulate(
                    p, k_sim, src, num_timesteps, temperature=temp,
                    top_k=top_k, top_p=top_p,
                    use_final_max_rates=use_final_max_rates)
                return k, final
            _, finals = jax.lax.scan(body, key, masks_dev)
            return finals  # leading (n_batches, batch_size, ...)

        cache[sig] = jax.jit(run_all)
    run_all = cache[sig]

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        masks_dev = jax.device_put(masks_stacked, NamedSharding(mesh, P(None, "data")))
    else:
        masks_dev = jnp.asarray(masks_stacked)

    t_start = time.perf_counter()
    with fast_inference_softmax():
        finals = run_all(params, key, masks_dev, jnp.asarray(temperature, jnp.float32))
    sample = jax.block_until_ready(
        finals.map(lambda a: a.reshape(total, *a.shape[2:])[:num_jets]))
    wall = time.perf_counter() - t_start

    # ---- host-side finalize: destandardize + mask (reference
    # `callbacks.py:52-58`)
    sample = sample.astype_numpy()
    x = sample.continuous
    if metadata and x is not None:
        mean = np.asarray(metadata["mean"], np.float32)
        std = np.asarray(metadata["std"], np.float32)
        x = x * std + mean
    m = np.asarray(sample.mask)
    sample = MultiModal(
        continuous=None if x is None else (x * m).astype(np.float32),
        discrete=(np.asarray(sample.discrete) * m).astype(np.int32),
        mask=m.astype(np.int32),
    )

    return GenerationResult(
        sample=sample,
        jets_per_sec=num_jets / wall,
        wall_time_s=wall,
        num_timesteps=num_timesteps,
        temperature=temperature,
    )


def generate_bucketed(
    system,
    params,
    pad_masks: np.ndarray,
    *,
    num_timesteps: int,
    bucket_widths=(32, 40, 48, 56, 64, 128),
    **kw,
) -> GenerationResult:
    """Multiplicity-bucketed generation: pad is wasted compute.

    AOJ jets average ~40 particles but the reference pads every jet to
    D=150, so ~3/4 of the attention/dense work is zeros.  Here jets are
    grouped by multiplicity into static-width buckets, each bucket runs
    the compiled sampler at its own width, and the outputs are re-padded
    and reassembled in the original order.  Exactly the same per-jet
    distribution (masked attention + masked losses make the model
    width-agnostic); only the zero-padding work is skipped.  Default
    widths step by 8 around the AOJ bulk, then jump to 64/128 for the
    tail; they were set on an earlier accelerator and are unmeasured on
    H100.

    Not applicable with learned positional embeddings (`use_pos_emb`).
    """
    cfg = system.config
    if getattr(cfg, "use_pos_emb", False):
        # learned positional embeddings are sized to max_num_particles;
        # widths can't change — run flat
        return generate(system, params, pad_masks, num_timesteps=num_timesteps, **kw)
    D = pad_masks.shape[1]
    mult = pad_masks[..., 0].sum(axis=1)
    # masks must be first-n filled for column truncation to be lossless
    first_n = (pad_masks[..., 0].cumsum(axis=1) ==
               np.minimum(np.arange(1, D + 1)[None, :], mult[:, None])).all()
    if not first_n:
        return generate(system, params, pad_masks, num_timesteps=num_timesteps, **kw)

    widths = sorted(w for w in bucket_widths if w < D) + [D]
    num_jets = pad_masks.shape[0]
    order = []
    pieces = []
    t0 = time.perf_counter()
    lo = 0
    for w in widths:
        sel = np.where((mult <= w) & (mult > lo))[0] if w != widths[0] else np.where(mult <= w)[0]
        lo = w
        if len(sel) == 0:
            continue
        res = generate(system, params, pad_masks[sel, :w], num_timesteps=num_timesteps, **kw)
        s = res.sample
        if w < D:  # re-pad to the global width
            padw = D - w
            s = MultiModal(
                continuous=np.pad(s.continuous, ((0, 0), (0, padw), (0, 0))),
                discrete=np.pad(s.discrete, ((0, 0), (0, padw), (0, 0))),
                mask=np.pad(s.mask, ((0, 0), (0, padw), (0, 0))),
            )
        order.append(sel)
        pieces.append(s)
    wall = time.perf_counter() - t0

    merged = MultiModal.concat([p.map(np.asarray) for p in pieces]).astype_numpy()
    inv = np.argsort(np.concatenate(order))
    merged = merged[inv]

    return GenerationResult(
        sample=merged,
        jets_per_sec=num_jets / wall,
        wall_time_s=wall,
        num_timesteps=num_timesteps,
        temperature=kw.get("temperature", 1.0),
    )


# packing layout math lives in data/packing.py (shared with the packed
# TRAINING path since round 4); re-exported here under the round-3 names
from multimodal_flows.data.packing import (  # noqa: E402
    build_packed_rows as _build_packed_rows,
    pack_jets,
    unpack_rows as _unpack_rows,
)


#: encoders supporting packed multi-jet rows: transformers via the
#: block-diagonal segment attention mask; EPiC (round 4) via per-segment
#: mean+sum pooling (`ops/pooling.py:segment_meansum_pool`), so its global
#: stream is per-jet and packing never mixes jets
_PACKABLE_MODELS = ("ParticleFormer", "FusedParticleFormer", "KinFormer",
                    "FlavorFormer", "EPiC")


def generate_packed(
    system,
    params,
    pad_masks: np.ndarray,
    *,
    num_timesteps: int,
    pack_width: int = 128,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    use_final_max_rates: bool = False,
    batch_size: int = 256,
    seed: int = 0,
    mesh=None,
    metadata: Optional[Dict] = None,
    max_dispatch_steps: int = 8_000,
) -> GenerationResult:
    """Generation with multi-jet packing: several jets share one
    `pack_width`-token attention row behind a block-diagonal segment mask.

    Exactly the per-jet model: attention is restricted to same-segment
    pairs (`ops/attention.py`), all dense/MLP/solver work is per-token, and
    on the sampling grid every jet shares the same t, so the packed forward
    equals the unpacked one to float tolerance (tests/test_packing.py).
    Jets wider than `pack_width` fall back to the bucketed path.
    """
    cfg = system.config
    num_jets = pad_masks.shape[0]
    D = pad_masks.shape[1]
    mult = pad_masks[..., 0].sum(axis=1)
    first_n = (pad_masks[..., 0].cumsum(axis=1) ==
               np.minimum(np.arange(1, D + 1)[None, :], mult[:, None])).all()
    # pairwise-bias encoders take the packed path too: the co-occurrence
    # bias projects its 45-row pair table BEFORE gathering (no (B,D,D,E)
    # tensor at all) and the Lund pair-MLP runs in query-row chunks
    # (`config.pair_chunk`), bounding device memory at W=128
    # (models/particle_transformers.py)
    if (cfg.model not in _PACKABLE_MODELS or getattr(cfg, "use_pos_emb", False)
            or not first_n):
        return generate_bucketed(
            system, params, pad_masks, num_timesteps=num_timesteps,
            temperature=temperature, top_k=top_k, top_p=top_p,
            use_final_max_rates=use_final_max_rates, batch_size=batch_size,
            seed=seed, mesh=mesh, metadata=metadata,
            max_dispatch_steps=max_dispatch_steps)

    t_start = time.perf_counter()
    row_of, offset_of, n_rows = pack_jets(mult, pack_width)

    # packed rows are ~pack_width/48 heavier than the bucketed batches the
    # dispatch cap is counted in, so the row cap scales down with the width
    row_cap = max(1_000, max_dispatch_steps * 48 // pack_width)

    # the packed dispatch batch is capped at 128 rows, a value set on an
    # earlier accelerator and unmeasured on H100.  The caller's batch_size
    # still governs the bucketed fallback paths (oversized jets).
    packed_bs = min(batch_size, 128)
    if mesh is not None:
        from multimodal_flows.parallel.mesh import data_axis_size

        # the cap is a perf knob, not a correctness bound: keep the batch
        # a positive multiple of the data axis so sharding still divides
        n_data = data_axis_size(mesh)
        packed_bs = min(max(packed_bs // n_data * n_data, n_data), batch_size)

    sample_rows = None
    if n_rows > 0:
        row_mask, row_seg = _build_packed_rows(pad_masks, row_of, offset_of,
                                               n_rows, pack_width)
        sample_rows = _run_packed_rows(
            system, params, row_mask, row_seg,
            num_timesteps=num_timesteps, temperature=temperature,
            top_k=top_k, top_p=top_p, use_final_max_rates=use_final_max_rates,
            batch_size=packed_bs, seed=seed, mesh=mesh,
            max_dispatch_steps=row_cap,
            num_segments=int(row_seg.max()) + 1)

    if sample_rows is not None:
        sample = _unpack_rows(sample_rows, pad_masks, row_of, offset_of, pack_width)
    else:
        sample = MultiModal(
            continuous=np.zeros((num_jets, D, cfg.dim_continuous), np.float32),
            discrete=np.zeros((num_jets, D, 1), np.int32),
            mask=pad_masks.astype(np.int32))

    # unpackable tail (mult > pack_width): bucketed path, then overwrite
    left = np.where(row_of < 0)[0]
    if len(left):
        res_l = generate_bucketed(
            system, params, pad_masks[left], num_timesteps=num_timesteps,
            temperature=temperature, top_k=top_k, top_p=top_p,
            use_final_max_rates=use_final_max_rates, batch_size=batch_size,
            seed=seed + 15485863, mesh=mesh, metadata=None,
            max_dispatch_steps=max_dispatch_steps)
        x = np.asarray(sample.continuous)
        k = np.asarray(sample.discrete)
        x[left] = np.asarray(res_l.sample.continuous)
        k[left] = np.asarray(res_l.sample.discrete)
        sample = MultiModal(continuous=x, discrete=k, mask=sample.mask)

    wall = time.perf_counter() - t_start

    # host-side finalize: destandardize + mask (reference `callbacks.py:52-58`)
    x = sample.continuous
    if metadata and x is not None:
        mean = np.asarray(metadata["mean"], np.float32)
        std = np.asarray(metadata["std"], np.float32)
        x = x * std + mean
    m = np.asarray(sample.mask)
    sample = MultiModal(
        continuous=None if x is None else (x * m).astype(np.float32),
        discrete=(np.asarray(sample.discrete) * m).astype(np.int32),
        mask=m.astype(np.int32))

    return GenerationResult(sample=sample, jets_per_sec=num_jets / wall,
                            wall_time_s=wall, num_timesteps=num_timesteps,
                            temperature=temperature)


def _rebalanced_batch(n_rows: int, batch_size: int, gran: int = 8) -> int:
    """Shrink the batch so the same number of scan batches covers `n_rows`
    nearly evenly, killing the pad tail of the last batch.

    E.g. 674 packed rows at B=256 pad to 3x256=768: the last batch is ~37%
    empty rows that still ride the full forward (12% of the whole run).
    Rebalancing to B=232 covers them in 3x232=696 — one compile, no extra
    dispatch (vs the flat path's separate tail program, `generate`).
    `gran` keeps batches a multiple of 8 (and of the data axis on meshes).
    Only fires when it removes >=32 pad rows AND >=5% of the padded total,
    so big production runs (last-batch waste already amortized over many
    batches) keep their round-number compile signatures."""
    n_batches = (n_rows + batch_size - 1) // batch_size
    if n_batches <= 1:
        return batch_size
    balanced = -(-n_rows // n_batches)          # ceil: rows per batch
    balanced = -(-balanced // gran) * gran      # ceil to granularity
    saved = (batch_size - balanced) * n_batches
    if saved >= 32 and saved >= 0.05 * n_batches * batch_size:
        return balanced
    return batch_size


def _run_packed_rows(system, params, row_masks: np.ndarray, row_segs: np.ndarray,
                     *, num_timesteps: int, temperature: float, top_k, top_p,
                     use_final_max_rates: bool, batch_size: int, seed: int,
                     mesh, max_dispatch_steps: int,
                     num_segments: Optional[int] = None) -> MultiModal:
    """Run packed rows through the compiled scan-of-scans sampler (the
    packed twin of `generate`'s core): noise per row on device, segments as
    a scanned input, chunked into dispatches of bounded length."""
    cfg = system.config
    n_rows, W = row_masks.shape[0], row_masks.shape[1]
    key = jax.random.PRNGKey(seed)

    if mesh is not None:
        from multimodal_flows.parallel.mesh import data_axis_size, replicated_sharding

        n_data = data_axis_size(mesh)
        assert batch_size % n_data == 0, (
            f"batch_size {batch_size} must be divisible by the "
            f"{n_data}-device data axis")
        params = jax.device_put(params, replicated_sharding(mesh))

    if mesh is None and n_rows < batch_size:
        batch_size = min(_snap_batch(n_rows), batch_size)

    n_batches = (n_rows + batch_size - 1) // batch_size
    # pad-tail rebalance (see `_rebalanced_batch`); granularity 8 is a value
    # set on an earlier accelerator, the data axis keeps the batch divisible
    batch_size = _rebalanced_batch(
        n_rows, batch_size, gran=8 if mesh is None else math.lcm(8, n_data))
    n_batches = (n_rows + batch_size - 1) // batch_size
    total = n_batches * batch_size
    if total > n_rows:  # pad with empty rows (mask 0, segment -1)
        pad_m = np.zeros((total - n_rows,) + row_masks.shape[1:], row_masks.dtype)
        pad_s = np.full((total - n_rows, W), -1, row_segs.dtype)
        row_masks = np.concatenate([row_masks, pad_m], axis=0)
        row_segs = np.concatenate([row_segs, pad_s], axis=0)

    batches_cap = max(1, max_dispatch_steps // max(num_timesteps, 1))
    if n_batches > batches_cap:
        pieces = []
        for i, lo in enumerate(range(0, total, batches_cap * batch_size)):
            hi = min(lo + batches_cap * batch_size, total)
            pieces.append(_run_packed_rows(
                system, params, row_masks[lo:hi], row_segs[lo:hi],
                num_timesteps=num_timesteps, temperature=temperature,
                top_k=top_k, top_p=top_p,
                use_final_max_rates=use_final_max_rates,
                batch_size=batch_size, seed=seed + 7919 * (i + 1), mesh=mesh,
                max_dispatch_steps=max_dispatch_steps,
                num_segments=num_segments))
        return MultiModal.concat([p.map(np.asarray) for p in pieces])[:n_rows]

    masks_stacked = row_masks.reshape(n_batches, batch_size, *row_masks.shape[1:])
    segs_stacked = row_segs.reshape(n_batches, batch_size, W)

    cache = getattr(system, "_packed_sim_cache", None)
    if cache is None:
        cache = system._packed_sim_cache = {}
    sig = (num_timesteps, top_k, top_p, use_final_max_rates, batch_size,
           n_batches, W, num_segments, fast_softmax_would_apply(), scan_unroll())

    if sig not in cache:

        def run_all(p, key, masks_dev, segs_dev, temp):
            def body(k, xs):
                mask_b, seg_b = xs
                k, k_noise, k_sim = jax.random.split(k, 3)
                src = make_noise_source(k_noise, mask_b, cfg)
                final = system.simulate(
                    p, k_sim, src, num_timesteps, temperature=temp,
                    top_k=top_k, top_p=top_p,
                    use_final_max_rates=use_final_max_rates,
                    segments=seg_b, num_segments=num_segments)
                return k, final
            _, finals = jax.lax.scan(body, key, (masks_dev, segs_dev))
            return finals

        cache[sig] = jax.jit(run_all)
    run_all = cache[sig]

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = NamedSharding(mesh, P(None, "data"))
        masks_dev = jax.device_put(masks_stacked, sh)
        segs_dev = jax.device_put(segs_stacked, sh)
    else:
        masks_dev = jnp.asarray(masks_stacked)
        segs_dev = jnp.asarray(segs_stacked)

    with fast_inference_softmax():
        finals = run_all(params, key, masks_dev, segs_dev,
                         jnp.asarray(temperature, jnp.float32))
    rows = jax.block_until_ready(
        finals.map(lambda a: a.reshape(total, *a.shape[2:])[:n_rows]))
    return rows.astype_numpy()


def gather_multihost(sample: MultiModal) -> MultiModal:
    """All-gather generated samples across hosts (replaces the reference's
    per-rank temp-file + barrier + concat, `callbacks.py:27-62`)."""
    if jax.process_count() == 1:
        return sample
    from jax.experimental import multihost_utils

    # tiled=True concatenates the per-process samples along the jet axis;
    # the default (tiled=False) would stack a new leading process axis —
    # caught by tests/test_multiprocess.py the first time this branch ever
    # executed with process_count > 1
    return sample.map(lambda a: multihost_utils.process_allgather(a, tiled=True))


def save_generation(result: GenerationResult, config: Config, res_dir: str) -> str:
    """Write generated_sample.h5 + configs.yaml into the results dir
    (reference `callbacks.py:41-62`)."""
    os.makedirs(res_dir, exist_ok=True)
    out_path = os.path.join(res_dir, "generated_sample.h5")
    result.sample.save_to(out_path)
    with open(os.path.join(res_dir, "configs.yaml"), "w") as f:
        yaml.safe_dump(config.to_dict(), f, sort_keys=False)
    return out_path


def run_generation_sweep(
    system,
    params,
    test_masks: np.ndarray,
    config: Config,
    *,
    temperatures: List[float],
    timestep_grid: List[int],
    num_files: int = 1,
    mesh=None,
    save: bool = True,
    max_dispatch_steps: int = 8_000,
) -> List[GenerationResult]:
    """The reference sweep driver: num_files x temperature x num_timesteps
    (reference `sample_mmf.py:147-168`).

    `max_dispatch_steps` bounds batches*timesteps per device program; lower
    it for encoders whose forward is much heavier than the flagship (e.g.
    pairwise-bias models) to keep each device program short."""
    results = []
    tags = config.tags or ""
    if isinstance(tags, (list, tuple)):
        tags = "_".join(str(t) for t in tags)
    if tags:
        tags = f"_{tags}"
    for i in range(num_files):
        for temp in temperatures:
            for steps in timestep_grid:
                suffix = f"_{i}" if i > 0 else ""
                tag = f"{tags}{suffix}_steps_{steps}_temp_{temp}"
                res = generate_packed(
                    system, params, test_masks,
                    num_timesteps=steps, temperature=temp,
                    top_k=config.top_k, top_p=config.top_p,
                    use_final_max_rates=config.use_final_max_rates,
                    batch_size=config.batch_size, seed=config.seed + i,
                    mesh=mesh, metadata=config.metadata,
                    max_dispatch_steps=max_dispatch_steps,
                )
                res.tag = tag
                log.info(f"generated {len(res.sample)} jets @steps={steps} T={temp}: "
                         f"{res.jets_per_sec:.1f} jets/s")
                if save and config.experiment_id:
                    res_dir = os.path.join(config.experiment_dir,
                                           f"generation_results{tag}")
                    save_generation(res, config, res_dir)
                results.append(res)
    return results
