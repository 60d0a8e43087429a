"""Time the packed-row attention core on one GPU.

Compares the program's attention core, XLA's segment-masked einsum
attention (`ops.attention.multihead_attention_btc`), with JAX's library kernel
`jax.experimental.pallas.ops.gpu.attention.mha` (Pallas, Triton route; a
library kernel, not one this repository wrote), called with `segment_ids`.
Its (B, T, H, hs) layout is a free reshape of the token-major q/k/v.  Both
run at the default matmul precision: float32 dots may use TF32 on the card.

Two measurements, at the sampler's packed operating point (rows of
T=128 tokens holding several AOJ-like jets, 128 rows per batch):
  1. the attention forward alone at B=128, T=128, H=4, hs=64;
  2. the flagship's 100-step packed sampler over 1024 jets with each core,
     in the order XLA, mha, mha, XLA after one warm-up run each.

    python scripts/attention_core_bench.py
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

B, T, H, HS = 128, 128, 4, 64


def packed_segments(rows: int, width: int, seed: int = 0) -> np.ndarray:
    """Segment ids of `rows` packed rows built from AOJ-like multiplicities
    (Poisson(40) clipped to [3, width]); pads are -1."""
    from multimodal_flows.data.packing import build_packed_rows, pack_jets

    rng = np.random.default_rng(seed)
    mult = np.clip(rng.poisson(40, 4 * rows), 3, width)
    masks = (np.arange(width)[None, :] < mult[:, None]).astype(np.int32)[..., None]
    row_of, offset_of, n_rows = pack_jets(mult, width)
    _, seg = build_packed_rows(masks, row_of, offset_of, n_rows, width)
    return seg[:rows].astype(np.int32)


def mha_btc(q, k, v, n_head, segments):
    from jax.experimental.pallas.ops.gpu.attention import mha

    b, t, c = q.shape
    hs = c // n_head
    out = mha(q.reshape(b, t, n_head, hs), k.reshape(b, t, n_head, hs),
              v.reshape(b, t, n_head, hs), segment_ids=segments, sm_scale=hs ** -0.5)
    return out.reshape(b, t, c)


def forward_alone() -> None:
    from multimodal_flows.ops.attention import multihead_attention_btc
    from multimodal_flows.utils.profiling import device_timer

    seg = jnp.asarray(packed_segments(B, T))
    q, k, v = (jax.random.normal(key, (B, T, H * HS), jnp.float32)
               for key in jax.random.split(jax.random.PRNGKey(0), 3))
    xla = jax.jit(lambda q, k, v, s: multihead_attention_btc(q, k, v, H, None, None, segments=s))
    lib = jax.jit(lambda q, k, v, s: mha_btc(q, k, v, H, s))
    real = np.asarray(seg) >= 0
    diff = np.abs(np.asarray(xla(q, k, v, seg)) - np.asarray(lib(q, k, v, seg)))[real].max()
    print(f"forward B={B} T={T} H={H} hs={HS}: max-abs difference mha vs XLA {diff:.3e}")
    for name, fn in (("xla", xla), ("mha", lib), ("mha", lib), ("xla", xla)):
        t = device_timer(fn, q, k, v, seg, iters=50, warmup=3)
        print(f"forward {name}: {1e3 * t:.4f} ms (median of 50)")


def in_sampler() -> None:
    import multimodal_flows.models.attention as attention
    from chip_smoke import flagship_config, synthetic_jets
    from multimodal_flows.sampling.generator import generate_packed
    from multimodal_flows.train.systems import MMF

    xla_core = attention.multihead_attention_btc

    def lib_core(q, k, v, n_head, bias=None, key_mask=None, *, segments=None, **kw):
        if segments is None or bias is not None or key_mask is not None:
            return xla_core(q, k, v, n_head, bias, key_mask, segments=segments, **kw)
        return mha_btc(q, k, v, n_head, segments)

    cfg = flagship_config()
    masks = np.asarray(synthetic_jets(1024, 150, 0).mask)
    params = MMF(cfg).init_params(jax.random.PRNGKey(0))
    systems = {"xla": MMF(cfg), "mha": MMF(cfg)}   # one compiled sampler each
    cores = {"xla": xla_core, "mha": lib_core}

    def run(name):
        attention.multihead_attention_btc = cores[name]
        try:
            return generate_packed(systems[name], params, masks, num_timesteps=100,
                                   pack_width=T, batch_size=B, seed=0)
        finally:
            attention.multihead_attention_btc = xla_core

    for name in ("xla", "mha"):
        print(f"sampler {name} first run (compile): {run(name).wall_time_s:.2f} s")
    for name in ("xla", "mha", "mha", "xla"):
        res = run(name)
        print(f"sampler {name}: {res.wall_time_s:.4f} s for {len(masks)} jets x 100 steps "
              f"= {res.jets_per_sec:.2f} jets/s")


def main() -> None:
    if jax.devices()[0].platform != "gpu":
        raise RuntimeError("attention_core_bench needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card (name, power limit): {card}; jax device {jax.devices()[0].device_kind}")
    forward_alone()
    in_sampler()


if __name__ == "__main__":
    main()
