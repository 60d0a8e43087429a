from multimodal_flows.models.registry import MODEL_REGISTRY, build_model

__all__ = ["MODEL_REGISTRY", "build_model"]
