from multimodal_flows.ops.attention import multihead_attention
from multimodal_flows.ops.pooling import masked_meansum_pool

__all__ = ["multihead_attention", "masked_meansum_pool"]
