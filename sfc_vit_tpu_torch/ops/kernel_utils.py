"""Shared helpers for the port's kernels and their plain versions.

Counterpart of ``sfc_vit_tpu/ops/kernel_utils.py``; the Mosaic-only
helpers there (lane broadcasts, VMEM unroll estimates) have no use here.
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "ln_fp32", "ln_bwd_fp32", "round_up", "n_valid",
           "split_heads", "fp32_compute_not_ported", "kernel_is_f32"]

#: Masked-logit value: -1e30, never -inf, so a masked softmax gives 0
#: weights and no NaN.
NEG_INF = -1e30


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def n_valid(n: int, n_actual) -> int:
    """Keys a softmax sees under the ``n_actual`` contract: those before
    ``n_actual`` (all ``n`` when it is None)."""
    return n if n_actual is None else min(n_actual, n)


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, N, H*Dh] -> fp32 [B, H, N, Dh]."""
    b, n, w = t.shape
    return t.view(b, n, heads, w // heads).transpose(1, 2).float()


def fp32_compute_not_ported(what: str, dtype: torch.dtype) -> NotImplementedError:
    """The refusal of the post-norm tail kernels (#15/#16) given a CUDA
    tensor in a dtype other than bfloat16: they never fall back to their
    plain versions."""
    return NotImplementedError(
        f"{what}: {dtype} compute on the GPU is not ported yet, the kernels "
        "take bfloat16: ROADMAP.md queue 1 item 15 (fp32 compute for the "
        "post-norm tail, kernels #15/#16)")


def kernel_is_f32(what: str, dtype: torch.dtype) -> bool:
    """Which kernels a CUDA tensor of ``dtype`` launches for #5, #6, #7 and
    #14: True for float32 (the fp32 SIMT kernels), False for bfloat16 (the
    Hopper ``wgmma`` kernels).  Any other dtype raises; nothing falls back
    to a plain version."""
    if dtype == torch.float32:
        return True
    if dtype == torch.bfloat16:
        return False
    raise NotImplementedError(
        f"{what}: no kernel computes in {dtype}; the kernels take bfloat16 or "
        "float32")


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


def ln_bwd_fp32(x: torch.Tensor, dxn: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5):
    """Backward of :func:`ln_fp32` from the fp32 cotangent ``dxn`` of its
    output, with the backward kernels' arithmetic: the statistics are
    recomputed from ``x``, ``dxh = dxn * scale`` and
    ``dx = inv * (dxh - mean(dxh) - xhat * mean(dxh * xhat))``.

    Returns ``(dx, dscale, dbias)`` in fp32; the sums run over every
    leading axis.  The plain version of ``csrc/ln_rows_bwd.cu``.
    """
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mean) * inv
    dxh = dxn * scale.float()
    m1 = dxh.mean(dim=-1, keepdim=True)
    m2 = (dxh * xhat).mean(dim=-1, keepdim=True)
    dx = inv * (dxh - m1 - xhat * m2)
    lead = tuple(range(x.dim() - 1))
    return dx, (dxn * xhat).sum(dim=lead), dxn.sum(dim=lead)
