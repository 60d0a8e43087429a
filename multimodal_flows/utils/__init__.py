import os

from multimodal_flows.utils.logger import MetricsLogger, SimpleLogger

#: compile cache used when JAX_COMPILATION_CACHE_DIR is unset: a fixed path
#: inside the checkout (listed in .gitignore), so reruns find their entries
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and
    nothing is set here; otherwise the cache goes to `REPO_CACHE_DIR`."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax

    os.makedirs(REPO_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR


__all__ = ["MetricsLogger", "SimpleLogger", "enable_compilation_cache"]
