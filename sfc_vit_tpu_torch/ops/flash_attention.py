"""Short-sequence attention straight off the packed QKV projection (#7).

Counterpart of the packed part of ``sfc_vit_tpu/ops/flash_attention.py``:
``packed_flash_attention`` maps a packed projection [B, N, 3*H*Dh] to
[B, N, H*Dh] with an fp32 softmax and no layout change between the QKV
GEMM and the attention.  The TPU kernel ``_packed_kernel`` holds one
image's whole packed block in VMEM; here it is ``csrc/attention_fwd.cu``
(the per-(image, head, query tile) two-pass softmax that kernel #1 runs)
instantiated at the flagship's head dim 192: fp32 logits times scale,
``P = p / l`` rounded to the input dtype before an fp32 ``P V``.  Its
bound on the H100 is the bytes of qkv and of the output.

As in the JAX package, the kernel is the inference path.  Under autograd
the JAX rule ``_pfa_fwd`` / ``_pfa_bwd`` applies, plain code there and
plain PyTorch here: the softmax in the input dtype with the weights
stored for the backward.  A CPU tensor runs :func:`_packed_xla_ref`; a
CUDA tensor launches the kernel (bfloat16, head dim 64 or 192) or raises.
``packed_flash_attention.launches`` counts the launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import attention_fwd
from .kernel_utils import fp32_compute_not_ported

__all__ = ["packed_flash_attention", "_packed_xla_ref"]


def _split(qkv: torch.Tensor, heads: int):
    """q, k, v [B, H, N, Dh] views of the packed projection."""
    b, n, three_inner = qkv.shape
    return qkv.view(b, n, 3, heads, three_inner // (3 * heads)).permute(2, 0, 3, 1, 4)


def _merge(out: torch.Tensor) -> torch.Tensor:
    """[B, H, N, Dh] -> [B, N, H*Dh]."""
    b, h, n, dh = out.shape
    return out.transpose(1, 2).reshape(b, n, h * dh)


def _packed_xla_ref(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """The kernel's plain version (JAX's ``_packed_xla_ref``): fp32
    logits times ``scale``, fp32 softmax rounded to the input dtype, then
    the weighted sum."""
    q, k, v = _split(qkv, heads)
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return _merge(w @ v)


def _pfa_fwd(qkv: torch.Tensor, heads: int, scale: float):
    """The differentiated forward (JAX's ``_pfa_fwd``): logits and softmax
    in the input dtype; returns the output and ``(q, k, v, p)``."""
    q, k, v = _split(qkv, heads)
    sc = torch.tensor(scale, dtype=q.dtype, device=q.device)
    p = torch.softmax((q @ k.transpose(-1, -2)) * sc, dim=-1)
    return _merge(p @ v), (q, k, v, p)


def _pfa_bwd(res, g: torch.Tensor, scale: float) -> torch.Tensor:
    """JAX's ``_pfa_bwd``: the packed dqkv from the stored weights."""
    q, k, v, p = res
    b, h, n, dh = q.shape
    sc = torch.tensor(scale, dtype=q.dtype, device=q.device)
    gh = g.reshape(b, n, h, dh).transpose(1, 2)
    dp = gh @ v.transpose(-1, -2)
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * sc
    dqkv = torch.stack([ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ gh])
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, n, 3 * h * dh)


class _PackedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, scale):
        out, res = _pfa_fwd(qkv, heads, scale)
        ctx.save_for_backward(*res)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        return _pfa_bwd(ctx.saved_tensors, g, ctx.scale), None, None


def packed_flash_attention(qkv: torch.Tensor, heads: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Attention on a packed [B, N, 3*H*Dh] projection -> [B, N, H*Dh].

    Under autograd, JAX's store-weights rule.  Otherwise a CPU ``qkv``
    runs :func:`_packed_xla_ref` and a CUDA one kernel #7, or raises for
    a dtype other than bfloat16 or a head dim the kernel does not take.
    """
    b, n, three_inner = qkv.shape
    if three_inner % (3 * heads):
        raise ValueError(f"packed QKV feature dim {three_inner} must be "
                         f"divisible by 3*heads={3 * heads}")
    s = (three_inner // 3 // heads) ** -0.5 if scale is None else scale
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _PackedAttention.apply(qkv, heads, s)
    if qkv.device.type == "cpu":
        return _packed_xla_ref(qkv, heads, s)
    if qkv.device.type != "cuda":
        raise ValueError(f"packed_flash_attention: no kernel for device {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise fp32_compute_not_ported("packed_flash_attention", qkv.dtype)
    out = attention_fwd(qkv.contiguous(), heads, n, s)
    packed_flash_attention.launches += 1
    return out


packed_flash_attention.launches = 0
