from multimodal_flows.sampling.generator import (
    GenerationResult,
    generate,
    make_noise_source,
    run_generation_sweep,
)

__all__ = ["generate", "make_noise_source", "run_generation_sweep", "GenerationResult"]
