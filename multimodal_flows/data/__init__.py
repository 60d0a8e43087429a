from multimodal_flows.data.state import MultiModal, DataCoupling
from multimodal_flows.data.datasets import (
    ArrayDataset,
    make_train_val_loaders,
    shuffle_batches,
)

__all__ = [
    "MultiModal",
    "DataCoupling",
    "ArrayDataset",
    "make_train_val_loaders",
    "shuffle_batches",
]
