"""Mixup / cutmix: counterpart of ``sfc_vit_tpu/training/mixing.py``.

The random draws (lambda, the permutation, the box centre and the coin)
come from an explicit ``torch.Generator`` on the host; each can also be
passed in, so a test can feed both frameworks the same draws (their
random streams never agree).  The images stay where they are: on the
card in training.  Scalar arithmetic is float32, as in the JAX version,
and cutmix's box is a mask, as there.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["mixup", "cutmix", "mix_or_cutmix", "sample_beta"]

MixOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, float]


def _uniform(gen: torch.Generator) -> float:
    return float(torch.rand((), generator=gen))


def _gamma(alpha: float, gen: torch.Generator) -> float:
    """Gamma(alpha, 1) by Marsaglia and Tsang's method (torch has no
    gamma sampler that takes a generator)."""
    if alpha < 1.0:
        u = _uniform(gen)
        return _gamma(alpha + 1.0, gen) * u ** (1.0 / alpha)
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        x = float(torch.randn((), generator=gen))
        v = (1.0 + c * x) ** 3
        if v <= 0.0:
            continue
        u = _uniform(gen)
        if u > 0.0 and math.log(u) < 0.5 * x * x + d - d * v + d * math.log(v):
            return d * v


def sample_beta(alpha: float, gen: torch.Generator) -> float:
    """Beta(alpha, alpha) as float32; 1.0 when ``alpha <= 0``."""
    if alpha <= 0:
        return 1.0
    a, b = _gamma(alpha, gen), _gamma(alpha, gen)
    return float(np.float32(a / (a + b)))


def _perm(gen, n: int, perm, device) -> torch.Tensor:
    if perm is None:
        perm = torch.randperm(n, generator=gen)
    return torch.as_tensor(np.array(perm, dtype=np.int64)).to(device)


def mixup(gen: Optional[torch.Generator], x: torch.Tensor, y: torch.Tensor,
          alpha: float = 0.2, lam: Optional[float] = None,
          perm=None) -> MixOut:
    """Convex combination of the batch with a shuffled copy of itself.
    Returns ``(mixed_x, y_a, y_b, lam)``."""
    lam = np.float32(sample_beta(alpha, gen) if lam is None else lam)
    idx = _perm(gen, x.shape[0], perm, x.device)
    mixed = float(lam) * x + float(np.float32(1.0) - lam) * x[idx]
    return mixed.to(x.dtype), y, y[idx], float(lam)


def cutmix(gen: Optional[torch.Generator], x: torch.Tensor, y: torch.Tensor,
           alpha: float = 1.0, lam: Optional[float] = None, perm=None,
           center: Optional[Tuple[int, int]] = None) -> MixOut:
    """Paste a box from a shuffled copy; lambda corrected by the box's
    actual area.  ``x`` is NHWC; ``center`` is ``(cx, cy)``."""
    b, h, w, _ = x.shape
    lam = np.float32(sample_beta(alpha, gen) if lam is None else lam)
    idx = _perm(gen, b, perm, x.device)
    cut_rat = np.sqrt(np.float32(1.0) - lam)
    cut_w = int(np.float32(w) * cut_rat)
    cut_h = int(np.float32(h) * cut_rat)
    if center is None:
        cx = int(torch.randint(0, w, (), generator=gen))
        cy = int(torch.randint(0, h, (), generator=gen))
    else:
        cx, cy = (int(c) for c in center)
    x1, x2 = np.clip([cx - cut_w // 2, cx + cut_w // 2], 0, w)
    y1, y2 = np.clip([cy - cut_h // 2, cy + cut_h // 2], 0, h)
    rows = torch.arange(h, device=x.device)[:, None]
    cols = torch.arange(w, device=x.device)[None, :]
    mask = (rows >= y1) & (rows < y2) & (cols >= x1) & (cols < x2)
    mixed = torch.where(mask[None, :, :, None], x[idx], x)
    area = np.float32((x2 - x1) * (y2 - y1))
    lam_adj = np.float32(1.0) - area / np.float32(h * w)
    return mixed, y, y[idx], float(lam_adj)


def mix_or_cutmix(gen: Optional[torch.Generator], x: torch.Tensor,
                  y: torch.Tensor, mixup_alpha: float = 0.2,
                  cutmix_alpha: float = 1.0, mix_prob: float = 0.5,
                  use_mixup: Optional[bool] = None, lam: Optional[float] = None,
                  perm=None, center: Optional[Tuple[int, int]] = None) -> MixOut:
    """Coin flip (mixup with probability ``mix_prob``) between the two."""
    if use_mixup is None:
        use_mixup = _uniform(gen) < mix_prob
    if use_mixup:
        return mixup(gen, x, y, mixup_alpha, lam=lam, perm=perm)
    return cutmix(gen, x, y, cutmix_alpha, lam=lam, perm=perm, center=center)
