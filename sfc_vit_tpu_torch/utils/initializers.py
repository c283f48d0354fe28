"""flax's parameter initialisers, drawn from a ``torch.Generator``.

The port creates parameters in float32 on the CPU from a seeded
generator, with the distributions flax gives the same leaves; the values
differ from JAX's (another random stream), so parity tests convert one
framework's parameters into the other.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

__all__ = ["lecun_normal", "normal", "xavier_normal"]

#: std of a standard normal truncated at +-2 (flax's variance correction).
_TRUNC_STD = 0.87962566103423978


def lecun_normal(fan_in: int, fan_out: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``lecun_normal`` for a Dense kernel ``[fan_in, fan_out]``:
    truncated normal at +-2 std, std corrected so the variance is
    1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    w = torch.empty(fan_in, fan_out)
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def xavier_normal(shape: Sequence[int], fan_in: int, fan_out: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``xavier_normal``: an untruncated normal of variance
    2 / (fan_in + fan_out)."""
    return normal(shape, (2.0 / (fan_in + fan_out)) ** 0.5, generator)


def normal(shape: Sequence[int], std: float,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``normal(stddev)``."""
    return torch.randn(*shape, generator=generator) * std
