"""Fused transformer-MLP block ``x + fc2(act(fc1(LN(x))))`` on Hopper.

Counterpart of ``sfc_vit_tpu/ops/fused_mlp.py`` (forward only).  The TPU
kernel ``_mlp_kernel`` runs the whole block per row tile with the hidden
activation in VMEM; a Hopper block holds at most 227 KB of shared
memory, so here the block is three hand-written kernels
(``csrc/ln_rows.cu``, ``csrc/gemm_bf16.cu``):

  ``ln_rows`` -> ``gemm`` (fc1, +b1, activation in fp32, one round to
  bf16 -- the TPU kernel's rounding point) -> ``gemm`` (fc2, +b2, +x in
  fp32, one round).

The hidden ``[R, F]`` passes through L2/HBM between the two GEMMs.

:func:`mlp_block_ref` is the plain PyTorch version, the counterpart of
``mlp_block_xla``: it rounds fc1's output to the input dtype before the
activation, as XLA's unfused graph does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_no_grad, gemm, ln_rows
from .kernel_utils import ln_fp32

__all__ = ["fused_mlp_block", "mlp_block_ref"]


def mlp_block_ref(x, ln_scale, ln_bias, w1, b1, w2, b2,
                  eps: float = 1e-5, activation: str = "gelu",
                  residual: bool = True) -> torch.Tensor:
    """Unfused formula (flax Dense/LayerNorm semantics), ``[B, N, D]``."""
    xn = ln_fp32(x, ln_scale, ln_bias, eps)
    h = xn @ w1 + b1.to(x.dtype)
    if activation == "gelu":
        h = F.gelu(h)  # exact erf
    elif activation == "relu":
        h = F.relu(h)
    else:
        raise ValueError(f"unsupported activation {activation!r}")
    y = h @ w2 + b2.to(x.dtype)
    return x + y if residual else y


def fused_mlp_block(x, ln_scale, ln_bias, w1, b1, w2, b2,
                    eps: float = 1e-5, activation: str = "gelu",
                    residual: bool = True) -> torch.Tensor:
    """``x + fc2(act(fc1(LN(x))))`` ([B, N, D] in and out).

    A CPU ``x`` runs :func:`mlp_block_ref`.  A CUDA ``x`` launches the
    kernels (bf16, Dense kernels ``[in, out]``) or raises; it never falls
    back.  ``fused_mlp_block.launches`` counts the CUDA calls.
    """
    if x.device.type == "cpu":
        return mlp_block_ref(x, ln_scale, ln_bias, w1, b1, w2, b2,
                             eps=eps, activation=activation,
                             residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_block: no kernel for device {x.device}")
    if activation not in ("gelu", "relu"):
        raise ValueError(f"unsupported activation {activation!r}")
    check_no_grad("fused_mlp_block", 3, x, ln_scale, ln_bias, w1, b1, w2, b2)
    b, n, d = x.shape
    x2 = x.view(b * n, d)  # raises on a non-contiguous x
    xn = ln_rows(x2, ln_scale.float(), ln_bias.float(), eps)
    h = gemm(xn, w1, bias=b1.float(), act=activation)
    out = gemm(h, w2, bias=b2.float(), residual=x2 if residual else None)
    fused_mlp_block.launches += 1
    return out.view(b, n, d)


fused_mlp_block.launches = 0
