"""Network registry (reference `networks/registry.py:4-9`)."""

from __future__ import annotations

from multimodal_flows.config import Config
from multimodal_flows.models.epic import EPiC
from multimodal_flows.models.particle_transformers import (
    FlavorFormer,
    FusedParticleFormer,
    KinFormer,
    ParticleFormer,
)
from multimodal_flows.models.toy import ToyMLP

MODEL_REGISTRY = {
    "ParticleFormer": ParticleFormer,
    "FusedParticleFormer": FusedParticleFormer,
    "FlavorFormer": FlavorFormer,
    "KinFormer": KinFormer,
    "EPiC": EPiC,
    "ToyMLP": ToyMLP,
}


def build_model(config: Config):
    """Instantiate the configured encoder (reference `MMF.py:30`)."""
    try:
        cls = MODEL_REGISTRY[config.model]
    except KeyError:
        raise KeyError(
            f"unknown model {config.model!r}; available: {sorted(MODEL_REGISTRY)}"
        ) from None
    return cls(config)
