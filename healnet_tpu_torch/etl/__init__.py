from healnet_tpu_torch.etl.base import Dataset
from healnet_tpu_torch.etl.datasets import (
    MMDataset,
    class_weights,
    discretize_survival,
    train_val_test_split,
)
from healnet_tpu_torch.etl.prefetch import BackgroundIterator, DevicePrefetcher, pin_tree
from healnet_tpu_torch.etl.table import Table
from healnet_tpu_torch.etl.tcga import DatasetView, LRUCache, TCGADataset
from healnet_tpu_torch.etl.transforms import (
    Compose,
    RearrangeTransform,
    RepeatTransform,
    ResizeTransform,
    ToFloat,
)

__all__ = [
    "Dataset",
    "MMDataset",
    "class_weights",
    "discretize_survival",
    "train_val_test_split",
    "LRUCache",
    "DatasetView",
    "TCGADataset",
    "Table",
    "BackgroundIterator",
    "DevicePrefetcher",
    "pin_tree",
    "Compose",
    "RearrangeTransform",
    "RepeatTransform",
    "ResizeTransform",
    "ToFloat",
]
