"""Test harness: run everything on CPU with 8 virtual devices so mesh /
sharding tests work without accelerators (the JAX-native way to test
multi-device code paths)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from multimodal_flows.data.state import DataCoupling, MultiModal  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_jets(B=4, D=10, Fc=3, V=9, seed=0, min_particles=2):
    """Synthetic padded particle clouds mimicking AOJ outputs."""
    rng = np.random.default_rng(seed)
    n = rng.integers(min_particles, D + 1, size=B)
    mask = (np.arange(D)[None, :] < n[:, None]).astype(np.int32)[..., None]
    continuous = rng.normal(size=(B, D, Fc)).astype(np.float32) * mask
    discrete = rng.integers(1, V, size=(B, D, 1)).astype(np.int32) * mask
    return MultiModal(continuous=continuous, discrete=discrete, mask=mask)


@pytest.fixture
def jets():
    return make_jets()


@pytest.fixture
def coupling(jets):
    source = MultiModal(mask=jets.mask)
    return DataCoupling(source=source, target=jets)
