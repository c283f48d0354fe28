"""Host data path: in-memory datasets, the epoch plan, eval transforms."""

from .augment import make_eval_transform, normalize
from .datasets import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    IMAGENET_MEAN,
    IMAGENET_STD,
    Dataset,
    batch_at,
    epoch_batches,
    epoch_index_plan,
    synthetic_dataset,
)

__all__ = [
    "CIFAR10_MEAN", "CIFAR10_STD", "IMAGENET_MEAN", "IMAGENET_STD",
    "Dataset", "batch_at", "epoch_batches", "epoch_index_plan",
    "make_eval_transform", "normalize", "synthetic_dataset",
]
