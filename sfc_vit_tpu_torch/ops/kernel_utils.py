"""Shared helpers for the port's kernels and their plain versions.

Counterpart of ``sfc_vit_tpu/ops/kernel_utils.py``; the Mosaic-only
helpers there (lane broadcasts, VMEM unroll estimates) have no use here.
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "ln_fp32", "round_up"]

#: Masked-logit value: -1e30, never -inf, so a masked softmax gives 0
#: weights and no NaN.
NEG_INF = -1e30


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def ln_fp32(v: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """flax ``nn.LayerNorm`` semantics over the last axis: fp32 stats with
    the clamped fast-variance form (E[x^2] - E[x]^2), scale and bias in
    fp32, rounded back to the input dtype.

    The arithmetic of the ``ln_rows`` kernel; use this, not
    ``F.layer_norm`` (two-pass variance), wherever the port normalises.
    """
    vf = v.float()
    mean = vf.mean(dim=-1, keepdim=True)
    var = ((vf * vf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    vn = (vf - mean) * torch.rsqrt(var + eps)
    return (vn * scale.float() + bias.float()).to(v.dtype)
