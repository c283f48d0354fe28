"""Fused pre-norm attention block ``x + attn(LN(x) @ W_qkv) @ W_out`` on
Hopper.

Counterpart of ``sfc_vit_tpu/ops/fused_attention_block.py`` (forward
only).  The TPU kernel ``_attn_block_kernel`` holds a group of whole
images, their QKV projection and every head's softmax in 100 MiB of
VMEM; a Hopper block has 227 KB of shared memory, so here the block is
four launches of three hand-written kernels (``csrc/ln_rows.cu``,
``csrc/gemm_bf16.cu``, ``csrc/attention_fwd.cu``):

  ``ln_rows`` -> ``gemm`` (QKV, no bias, rounded to bf16 as the TPU
  kernel's ``qkv_s`` is) -> ``attention_fwd`` (per image, head and query
  tile, straight off the packed qkv) -> ``gemm`` (out projection, +x in
  fp32, one round).

No biases: the pre-norm family's to_qkv/to_out are bias-free.

``n_actual`` keeps the JAX contract: keys at or past it are masked out of
every softmax.  Rows at or past it are don't-care in the kernel path (they
attend to the real keys), and pass through unchanged in the plain
version, :func:`attention_block_ref` -- compare real rows only.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import attention_fwd, check_no_grad, gemm, ln_rows
from .kernel_utils import ln_fp32

__all__ = ["fused_attention_block", "attention_block_ref"]


def _head_dim(d_qkv: int, heads: int) -> int:
    """Reject packed widths where ``// 3`` or ``// heads`` would truncate
    (wrong attention with no error), as the JAX package does."""
    if d_qkv % (3 * heads):
        raise ValueError(
            f"packed QKV feature dim {d_qkv} must be divisible by "
            f"3*heads={3 * heads}"
        )
    return d_qkv // (3 * heads)


def attention_block_ref(x, ln_scale, ln_bias, w_qkv, w_out, heads: int,
                        scale: Optional[float] = None, eps: float = 1e-5,
                        n_actual: Optional[int] = None) -> torch.Tensor:
    """Unfused formula, the counterpart of ``attention_block_xla``: LN with
    fp32 stats, the packed-QKV layout, fp32 logits and softmax, weights
    rounded to the input dtype before the weighted sum.  Rows at or past
    ``n_actual`` are padding and pass through unchanged."""
    if n_actual is not None and n_actual < x.shape[1]:
        out = attention_block_ref(x[:, :n_actual], ln_scale, ln_bias,
                                  w_qkv, w_out, heads, scale, eps)
        return torch.cat([out, x[:, n_actual:]], dim=1)
    b, n, _ = x.shape
    dh = _head_dim(w_qkv.shape[1], heads)
    s = dh ** -0.5 if scale is None else scale
    qkv = ln_fp32(x, ln_scale, ln_bias, eps) @ w_qkv
    q, k, v = qkv.view(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    logits = (q.float() @ k.float().transpose(-1, -2)) * s
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    att = (w @ v).transpose(1, 2).reshape(b, n, heads * dh)
    return x + att @ w_out


def fused_attention_block(x, ln_scale, ln_bias, w_qkv, w_out, heads: int,
                          scale: Optional[float] = None, eps: float = 1e-5,
                          n_actual: Optional[int] = None) -> torch.Tensor:
    """The whole pre-norm attention block ([B, N, D] in and out).

    A CPU ``x`` runs :func:`attention_block_ref`.  A CUDA ``x`` launches
    the kernels (bf16, head dim 64, Dense kernels ``[in, out]``) or
    raises; it never falls back.  ``fused_attention_block.launches``
    counts the CUDA calls.
    """
    if x.device.type == "cpu":
        return attention_block_ref(x, ln_scale, ln_bias, w_qkv, w_out,
                                   heads, scale, eps, n_actual)
    if x.device.type != "cuda":
        raise ValueError(
            f"fused_attention_block: no kernel for device {x.device}")
    check_no_grad("fused_attention_block", 4, x, ln_scale, ln_bias, w_qkv,
                  w_out)
    b, n, d = x.shape
    dh = _head_dim(w_qkv.shape[1], heads)
    s = dh ** -0.5 if scale is None else scale
    n_valid = n if n_actual is None else min(n_actual, n)
    x2 = x.view(b * n, d)  # raises on a non-contiguous x
    xn = ln_rows(x2, ln_scale.float(), ln_bias.float(), eps)
    qkv = gemm(xn, w_qkv)
    att = attention_fwd(qkv.view(b, n, -1), heads, n_valid, s)
    out = gemm(att.view(b * n, -1), w_out, residual=x2)
    fused_attention_block.launches += 1
    return out.view(b, n, d)


fused_attention_block.launches = 0
