"""Datasets: the in-memory ``Dataset``, the synthetic dataset and the
deterministic epoch plan.

Counterpart of the numpy code of ``sfc_vit_tpu/data/datasets.py`` (that
package's ``__init__`` imports jax, so the port carries its own copy).
Loaders produce ``images [N, H, W, C] uint8`` + ``labels [N] int32``;
batching and shuffling happen in :func:`epoch_batches`.  The file
loaders (CIFAR-10, TinyImageNet, ImageFolder) are ROADMAP queue 1
item 9.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = [
    "Dataset",
    "synthetic_dataset",
    "epoch_batches",
    "epoch_index_plan",
    "batch_at",
    "CIFAR10_MEAN",
    "CIFAR10_STD",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
]

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2023, 0.1994, 0.2010)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Dataset:
    """In-memory dataset: images [N,H,W,C] uint8, labels [N] int32."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 num_classes: int):
        assert images.ndim == 4 and images.dtype == np.uint8
        self.images = images
        self.labels = labels.astype(np.int32)
        self.num_classes = num_classes

    def __len__(self) -> int:
        return self.images.shape[0]


def synthetic_dataset(
    n: int = 1024, hw: int = 32, channels: int = 3, num_classes: int = 10,
    seed: int = 0,
) -> Dataset:
    """Deterministic class-separable synthetic data (smoke/benchmarks).

    Each class gets a distinct low-frequency template plus noise, so a
    working model can overfit it quickly -- useful as a training smoke
    test signal, not just random labels.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    templates = np.stack(
        [
            np.sin(2 * np.pi * ((k + 1) * xx + k * yy))[..., None]
            * np.ones((1, 1, channels), np.float32)
            for k in range(num_classes)
        ]
    )
    imgs = templates[labels] * 0.5 + 0.5
    imgs = imgs + rng.normal(0, 0.1, imgs.shape).astype(np.float32)
    return Dataset(
        (np.clip(imgs, 0, 1) * 255).astype(np.uint8), labels, num_classes
    )


def epoch_index_plan(
    n: int,
    batch_size: int,
    seed: int = 0,
    epoch: int = 0,
    shuffle: bool = True,
    drop_last: bool = True,
    process_index: int = 0,
    process_count: int = 1,
) -> Tuple[np.ndarray, Optional[int], int]:
    """The deterministic per-epoch index plan shared by every loader
    backend (:func:`epoch_batches` and the grain adapter): returns
    ``(order, pad_from, end)`` where ``order[:end]`` is this process's
    sample sequence and positions ``>= pad_from`` (when not None) are
    eval padding whose labels must report as -1."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    pad_from = None
    if process_count > 1:
        shard = order[process_index::process_count]
        if drop_last:
            # training: equal shard length on every host (truncate the
            # remainder) so all processes run the same number of
            # collective steps; the shuffle rotates what gets dropped.
            per_host = n // process_count
            order = shard[:per_host]
        else:
            # evaluation: every sample must be counted exactly once, so
            # short shards PAD (label -1, masked out of every metric by
            # the eval step) up to the ceil length instead of all hosts
            # truncating to the floor — which silently dropped up to
            # process_count-1 samples from the reported accuracy.
            per_host = -(-n // process_count)
            pad_from = len(shard)
            order = np.concatenate(
                [shard, np.zeros(per_host - len(shard), np.int64)]
            )
        n = per_host
    end = n - (n % batch_size) if drop_last else n
    return order, pad_from, end


def batch_at(
    ds: Dataset,
    order: np.ndarray,
    pad_from: Optional[int],
    batch_size: int,
    i: int,
    end: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Materialize the batch starting at plan position ``i``."""
    idx = order[i : min(i + batch_size, end)]
    labels = ds.labels[idx]
    if pad_from is not None and i + len(idx) > pad_from:
        labels = labels.copy()
        labels[max(0, pad_from - i):] = -1
    return ds.images[idx], labels


def epoch_batches(
    ds: Dataset,
    batch_size: int,
    seed: int = 0,
    epoch: int = 0,
    shuffle: bool = True,
    drop_last: bool = True,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (uint8 images NHWC, int32 labels) batches for one epoch.

    Multi-host: each process draws the same seeded permutation and takes
    its strided shard, so per-host batches are disjoint and the global
    batch is ``batch_size * process_count`` (the mesh-sharded input
    pipeline the reference has no equivalent of -- SURVEY.md 2f).
    """
    order, pad_from, end = epoch_index_plan(
        len(ds), batch_size, seed=seed, epoch=epoch, shuffle=shuffle,
        drop_last=drop_last, process_index=process_index,
        process_count=process_count,
    )
    for i in range(0, end, batch_size):
        yield batch_at(ds, order, pad_from, batch_size, i, end)
