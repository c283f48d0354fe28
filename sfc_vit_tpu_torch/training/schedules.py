"""Learning-rate schedules as plain functions of the step: counterpart of
``sfc_vit_tpu/training/schedules.py``.

* :func:`warmup_cosine` -- linear warmup to ``base_lr``, cosine to 0.
* :func:`warmup_cosine_min_lr` -- linear warmup, cosine to ``min_lr``.

The optimizer reads the schedule at the update count BEFORE the update,
as optax does: the first update runs at ``lr(0)``, which is 0 under
warmup (a ``LambdaLR`` stepped first would be one step ahead).
"""

from __future__ import annotations

import math
from typing import Callable

__all__ = ["warmup_cosine", "warmup_cosine_min_lr"]

Schedule = Callable[[int], float]


def _progress(step: float, warmup_steps: int, total_steps: int) -> float:
    return (step - warmup_steps) / max(1.0, total_steps - warmup_steps)


def warmup_cosine(base_lr: float, warmup_steps: int,
                  total_steps: int) -> Schedule:
    """lr(t) = base * t / warmup, then base * 0.5 * (1 + cos(pi * progress))."""

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_steps:
            return base_lr * step / max(1.0, warmup_steps)
        p = min(max(_progress(step, warmup_steps, total_steps), 0.0), 1.0)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * p))

    return schedule


def warmup_cosine_min_lr(base_lr: float, warmup_steps: int, total_steps: int,
                         min_lr: float = 1e-6) -> Schedule:
    """Linear warmup, then ``min_lr + 0.5 * (base - min_lr) * (1 + cos)``."""

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_steps:
            return base_lr * step / max(1.0, warmup_steps)
        p = min(_progress(step, warmup_steps, total_steps), 1.0)
        return min_lr + 0.5 * (base_lr - min_lr) * (1.0 + math.cos(math.pi * p))

    return schedule
