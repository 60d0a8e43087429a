"""Targeted sampling-step microbenchmark (round-2 perf work).

Measures the full hybrid tau-leap sampling trajectory per-step cost via
`system.simulate` (the exact bench.py hot path, PRNG pre-hoisted) across
(T, B) shapes, printing ms/step and jets/s implied at 1000 steps.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--shapes", default="48:256,48:512,64:256,40:256,32:256")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--ablate", action="store_true",
                   help="also time a forward-only scan at each shape to "
                        "isolate the solver overhead beyond the model fwd")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from multimodal_flows.config import Config
    from multimodal_flows.train.systems import MMF
    from multimodal_flows.data.state import MultiModal
    from multimodal_flows.utils import enable_compilation_cache

    enable_compilation_cache()

    cfg = Config(model="ParticleFormer", n_embd=256, n_inner=512, n_layer=5,
                 n_layer_fused=6, n_head=4, vocab_size=9, dim_continuous=3,
                 max_num_particles=256, multitask_loss="time-weighted")
    system = MMF(cfg)
    params = system.init_params(jax.random.PRNGKey(0), batch_size=2)

    @jax.jit
    def run(p, key, src, steps_dummy):
        return system.simulate(p, key, src, args.steps, temperature=1.0)

    rng = np.random.default_rng(0)
    for spec in args.shapes.split(","):
        T, B = (int(v) for v in spec.split(":"))
        n = np.clip(rng.poisson(40, B), 3, T)
        m = (np.arange(T)[None] < n[:, None]).astype(np.int32)[..., None]
        src = MultiModal(
            time=jnp.full((B,), cfg.time_eps, jnp.float32),
            continuous=jnp.asarray(rng.normal(size=(B, T, 3)) * m, jnp.float32),
            discrete=jnp.asarray(rng.integers(1, 9, (B, T, 1)) * m, jnp.int32),
            mask=jnp.asarray(m))
        f = run(params, jax.random.PRNGKey(1), src, args.steps)
        float(jax.tree.leaves(f)[0].ravel()[-1])  # force
        best = 1e9
        for it in range(3):
            t0 = time.perf_counter()
            f = run(params, jax.random.PRNGKey(2 + it), src, args.steps)
            float(jax.tree.leaves(f)[0].ravel()[-1])
            best = min(best, time.perf_counter() - t0)
        ms = best / args.steps * 1e3
        jps = B / (ms * 1e-3 * 1000)
        print(f"T={T:4d} B={B:5d}: {ms:6.2f} ms/step  -> {jps:6.1f} jets/s @1000",
              flush=True)

        if args.ablate:
            # forward-only scan: same state threading, no solver arithmetic
            @jax.jit
            def run_fwd(p, s0):
                def body(s, t):
                    s = s.replace(time=jnp.full((B,), t, jnp.float32))
                    vt, logits = system.module.apply(p, s)
                    s = s.replace(continuous=s.continuous + 0.0 * vt)
                    return s, None
                ts = jnp.linspace(0.01, 0.99, args.steps)
                out, _ = jax.lax.scan(body, s0, ts)
                return out

            f2 = run_fwd(params, src)
            float(jax.tree.leaves(f2)[0].ravel()[-1])
            bf = 1e9
            for _ in range(3):
                t0 = time.perf_counter()
                f2 = run_fwd(params, src)
                float(jax.tree.leaves(f2)[0].ravel()[-1])
                bf = min(bf, time.perf_counter() - t0)
            msf = bf / args.steps * 1e3
            print(f"           fwd-only: {msf:6.2f} ms/step  "
                  f"(solver overhead {ms - msf:5.2f} ms)", flush=True)


if __name__ == "__main__":
    main()
