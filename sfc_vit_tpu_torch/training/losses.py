"""Losses: counterpart of ``sfc_vit_tpu/training/losses.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["soft_target_cross_entropy", "cross_entropy", "mixup_criterion"]


def soft_target_cross_entropy(logits: torch.Tensor,
                              soft_targets: torch.Tensor) -> torch.Tensor:
    """``-(targets * log_softmax(logits)).sum(-1).mean()`` in fp32, used
    with mixup/cutmix soft targets."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -(soft_targets.float() * logp).sum(dim=-1).mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean integer-label cross entropy in fp32 (eval criterion)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def mixup_criterion(criterion, pred, y_a, y_b, lam):
    """``lam * L(pred, y_a) + (1 - lam) * L(pred, y_b)``."""
    return lam * criterion(pred, y_a) + (1.0 - lam) * criterion(pred, y_b)
