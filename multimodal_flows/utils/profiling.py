"""Profiling hooks (aux subsystem; absent in the reference, SURVEY §5).

Thin wrappers around `jax.profiler` so the trainer/sampler can capture
device traces without importing profiler plumbing inline, plus a timer
that waits for the device with `jax.block_until_ready`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import jax


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Capture a jax.profiler device trace into `logdir` (no-op when None)."""
    if not logdir:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_timer(fn, *args, iters: int = 3, warmup: int = 1):
    """Median wall time of `fn(*args)`, each call waited for on the device."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
