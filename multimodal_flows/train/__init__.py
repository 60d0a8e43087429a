from multimodal_flows.train.losses import MultiTaskLoss, masked_ce, masked_mse
from multimodal_flows.train.systems import CFM, MJB, MMF, build_system
from multimodal_flows.train.trainer import Trainer

__all__ = [
    "MultiTaskLoss",
    "masked_mse",
    "masked_ce",
    "MMF",
    "CFM",
    "MJB",
    "build_system",
    "Trainer",
]
