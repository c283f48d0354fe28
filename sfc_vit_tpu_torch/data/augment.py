"""Image transforms on the device: counterpart of the eval half of
``sfc_vit_tpu/data/augment.py``.

``normalize`` and ``make_eval_transform`` (uint8 NHWC -> normalised
float32, ``img / 255`` then ``(img - mean) / std``, as the JAX version
computes it).  The train-time augmentations (random-resized-crop, flip,
colour jitter, erasing) are ROADMAP queue 1 item 9; the port trains
without them, like the CLI's ``--no-augment``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

__all__ = ["normalize", "make_eval_transform"]


def normalize(img: torch.Tensor, mean: Sequence[float],
              std: Sequence[float]) -> torch.Tensor:
    mean = torch.as_tensor(mean, dtype=img.dtype, device=img.device)
    std = torch.as_tensor(std, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def make_eval_transform(mean: Sequence[float], std: Sequence[float],
                        device=None) -> Callable:
    """uint8 NHWC (numpy or tensor) -> normalised float32 on ``device``;
    the uint8 batch is what crosses to the device."""

    def batch_fn(images_u8) -> torch.Tensor:
        x = images_u8
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = x.to(device)
        return normalize(x.float() / 255.0, mean, std)

    return batch_fn
