"""Fused pre-norm attention block ``x + attn(LN(x) @ W_qkv) @ W_out`` on
Hopper, forward and backward.

Counterpart of ``sfc_vit_tpu/ops/fused_attention_block.py``.  The TPU
kernels ``_attn_block_kernel`` and ``_attn_block_bwd_kernel`` hold a
group of whole images, their QKV projection and every head's softmax in
100 MiB of VMEM; a Hopper block has 227 KB of shared memory, so here
each is a chain of hand-written kernels (``csrc/ln_rows.cu``,
``csrc/gemm_bf16.cu``, ``csrc/attention_fwd.cu``,
``csrc/attention_bwd_sm90.cu``, ``csrc/ln_rows_bwd.cu``).

Forward: ``ln_rows`` -> ``gemm`` (QKV, no bias, rounded to bf16 as the
TPU kernel's ``qkv_s`` is) -> ``attention_fwd`` (per image, head and
query tile, straight off the packed qkv; the training forward also
writes the log-sum-exp, the TPU's ``save_lse``) -> ``gemm`` (out
projection, +x in fp32, one round).  Training saves qkv, att and lse, as
``_fab_fwd`` does.

Backward (the TPU's ``with_acts`` + ``with_lse`` path): ``ln_rows``
(recompute xn) -> ``gemm`` NT (datt = gp W_out^T) -> ``attention_bwd``
(packed dqkv; one block per (image, head) up to 256 tokens, else
``csrc/attention_bwd.cu``) -> ``gemm`` TN (dW_out = att^T gp) -> ``gemm``
NT (dxn = dqkv W_qkv^T, fp32) -> ``gemm`` TN (dW_qkv = xn^T dqkv) ->
``ln_rows_bwd`` (dx = LN backward + g, dLN).

No biases: the pre-norm family's to_qkv/to_out are bias-free.

``n_actual`` keeps the JAX contract: keys at or past it are masked out of
every softmax.  Rows at or past it are don't-care in the kernel forward
(they attend to the real keys), and pass through unchanged in the plain
version, :func:`attention_block_ref` -- compare real rows only.  In the
backward, ``g`` is zeroed on those rows before every gradient path
(``gp``), so they add nothing to any parameter gradient, and their
cotangent passes straight through ``dx``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import attention_bwd, attention_fwd, gemm, ln_rows, ln_rows_bwd
from .kernel_utils import ln_bwd_fp32, ln_fp32, n_valid as _n_valid
from .kernel_utils import split_heads as _split_heads

__all__ = ["fused_attention_block", "attention_block_ref",
           "attention_block_bwd_ref", "attention_fwd_ref", "attention_bwd_ref",
           "attention_block_train_fwd", "attention_block_bwd"]


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


def attention_fwd_ref(qkv: torch.Tensor, heads: int, n_valid: int,
                      scale: float):
    """Plain version of ``csrc/attention_fwd.cu`` with its log-sum-exp:
    fp32 logits times ``scale``, keys at or past ``n_valid`` masked, P
    normalised and rounded to the input dtype before an fp32 P.V.
    Returns ``(att [B, N, H*Dh], lse fp32 [B, H, N])``."""
    b, n, w = qkv.shape
    dh = w // (3 * heads)
    q, k, v = qkv.view(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4).float()
    logits = (q @ k.transpose(-1, -2)) * scale
    logits[..., n_valid:] = -1e30
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.softmax(logits, dim=-1).to(qkv.dtype).float()
    att = (p @ v).transpose(1, 2).reshape(b, n, heads * dh).to(qkv.dtype)
    return att, lse


def attention_bwd_ref(qkv, att, datt, lse, heads: int, n_valid: int,
                      scale: float) -> torch.Tensor:
    """Plain version of ``csrc/attention_bwd.cu``: the packed ``dqkv``
    from the saved ``qkv``, ``att``, fp32 ``lse`` [B, H, N] and the
    cotangent ``datt`` of ``att``, with the TPU kernel's rounding points
    (pn and ds rounded to the input dtype, fp32 sums)."""
    b, n, w = qkv.shape
    dh = w // (3 * heads)
    dt = qkv.dtype
    q, k, v = qkv.view(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4).float()
    da = _split_heads(datt, heads)
    pn = torch.exp((q @ k.transpose(-1, -2)) * scale - lse[..., None])
    pn[..., n_valid:] = 0.0
    pf = pn.to(dt).float()
    dpn = da @ v.transpose(-1, -2)
    delta = (da * _split_heads(att, heads)).sum(-1, keepdim=True)
    ds = (pf * (dpn - delta) * scale).to(dt).float()
    dqkv = torch.stack([ds @ k, ds.transpose(-1, -2) @ q,
                        pf.transpose(-1, -2) @ da])  # [3, B, H, N, Dh]
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, n, w).to(dt)


def attention_block_bwd_ref(x, g, ln_scale, ln_bias, w_qkv, w_out, qkv, att,
                            lse, heads: int, scale: Optional[float] = None,
                            eps: float = 1e-5, n_actual: Optional[int] = None):
    """Plain version of ``_attn_block_bwd_kernel``'s ``with_acts`` +
    ``with_lse`` path, with its rounding points.

    ``x``, ``g`` ``[B, N, D]``; ``qkv`` ``[B, N, 3*inner]``, ``att``
    ``[B, N, inner]`` and ``lse`` (fp32 ``[B, H, N]``) are what the
    training forward saved.  Returns ``(dx, dln_scale, dln_bias, dw_qkv,
    dw_out)``, each in its input's dtype.
    """
    b, n, d = x.shape
    dh = _head_dim(w_qkv.shape[1], heads)
    inner = heads * dh
    s = dh ** -0.5 if scale is None else scale
    n_valid = _n_valid(n, n_actual)
    dt = x.dtype
    gp = g.clone()
    gp[:, n_valid:] = 0  # pad rows add nothing to any parameter gradient
    datt = (gp.float() @ w_out.float().T).to(dt)
    dqkv = attention_bwd_ref(qkv, att, datt, lse, heads, n_valid, s)
    dqkv = dqkv.reshape(b * n, 3 * inner).float()
    dw_out = att.reshape(b * n, inner).float().T @ gp.reshape(b * n, d).float()
    xn = ln_fp32(x, ln_scale, ln_bias, eps).reshape(b * n, d).float()
    dw_qkv = xn.T @ dqkv
    dxn = dqkv @ w_qkv.float().T
    dxf, dls, dlb = ln_bwd_fp32(x.reshape(b * n, d), dxn, ln_scale, eps)
    dx = (g.reshape(b * n, d).float() + dxf).to(dt).view(b, n, d)
    return (dx, dls.to(ln_scale.dtype), dlb.to(ln_bias.dtype),
            dw_qkv.to(w_qkv.dtype), dw_out.to(w_out.dtype))


def _fwd_kernels(x, ln_scale, ln_bias, w_qkv, w_out, heads, s, eps, n_valid,
                 save):
    b, n, d = x.shape
    x2 = x.view(b * n, d)  # raises on a non-contiguous x
    xn = ln_rows(x2, ln_scale.float(), ln_bias.float(), eps)
    qkv = gemm(xn, w_qkv).view(b, n, -1)
    att = attention_fwd(qkv, heads, n_valid, s, with_lse=save)
    if save:
        att, lse = att
    out = gemm(att.view(b * n, -1), w_out, residual=x2).view(b, n, d)
    fused_attention_block.launches += 1
    return (out, qkv, att, lse) if save else out


def attention_block_train_fwd(x, ln_scale, ln_bias, w_qkv, w_out,
                              heads: int, scale: Optional[float] = None,
                              eps: float = 1e-5,
                              n_actual: Optional[int] = None):
    """The training forward, ``(out, qkv, att, lse)`` (the TPU's
    ``save_acts`` + ``save_lse``).  Kernels for a CUDA ``x``;
    :func:`attention_block_ref` and plain saved tensors for a CPU one."""
    dh = _head_dim(w_qkv.shape[1], heads)
    s = dh ** -0.5 if scale is None else scale
    n_valid = _n_valid(x.shape[1], n_actual)
    if x.device.type == "cpu":
        out = attention_block_ref(x, ln_scale, ln_bias, w_qkv, w_out, heads,
                                  s, eps, n_actual)
        xn = ln_fp32(x, ln_scale, ln_bias, eps)
        qkv = (xn.float() @ w_qkv.float()).to(x.dtype)
        return (out, qkv, *attention_fwd_ref(qkv, heads, n_valid, s))
    return _fwd_kernels(x, ln_scale, ln_bias, w_qkv, w_out, heads, s, eps,
                        n_valid, save=True)


def attention_block_bwd(x, g, ln_scale, ln_bias, w_qkv, w_out, qkv, att, lse,
                        heads: int, scale: Optional[float] = None,
                        eps: float = 1e-5, n_actual: Optional[int] = None):
    """The backward from the saved ``qkv``, ``att`` and ``lse``, with the
    arguments and results of :func:`attention_block_bwd_ref`, which it
    runs for a CPU ``x``.  A CUDA ``x`` launches the kernel chain
    (``fused_attention_block.bwd_launches`` counts it)."""
    if x.device.type == "cpu":
        return attention_block_bwd_ref(x, g, ln_scale, ln_bias, w_qkv, w_out,
                                       qkv, att, lse, heads, scale, eps,
                                       n_actual)
    b, n, d = x.shape
    dh = _head_dim(w_qkv.shape[1], heads)
    s = dh ** -0.5 if scale is None else scale
    n_valid = _n_valid(n, n_actual)
    r, inner = b * n, att.shape[-1]
    x2 = x.view(r, d)
    g2 = g.reshape(r, d).contiguous()
    gp = g2
    if n_valid < n:
        gp = g2.clone()
        gp.view(b, n, d)[:, n_valid:] = 0
    lns = ln_scale.float()
    xn = ln_rows(x2, lns, ln_bias.float(), eps)
    datt = gemm(gp, w_out, trans_b=True)                     # [R, inner]
    dqkv = attention_bwd(qkv, att, datt.view(b, n, inner), lse, heads,
                         n_valid, s).view(r, 3 * inner)
    dw_out = gemm(att.view(r, inner), gp, trans_a=True)      # [inner, D]
    dxn = gemm(dqkv, w_qkv, trans_b=True, out_dtype=torch.float32)  # [R, D]
    dw_qkv = gemm(xn, dqkv, trans_a=True)                    # [D, 3*inner]
    dx, dls, dlb = ln_rows_bwd(x2, dxn, lns, g2, eps, add_g=True)
    fused_attention_block.bwd_launches += 1
    return (dx.view(b, n, d), dls.to(ln_scale.dtype), dlb.to(ln_bias.dtype),
            dw_qkv.to(w_qkv.dtype), dw_out.to(w_out.dtype))


class _FusedAttention(torch.autograd.Function):
    """Kernels #1 and #4 as one differentiable op: the forward saves x,
    the LN params, the weights and qkv, att, lse (as ``_fab_fwd`` does);
    the backward is :func:`attention_block_bwd`."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_qkv, w_out, heads, s, eps,
                n_actual):
        out, qkv, att, lse = attention_block_train_fwd(
            x, ln_scale, ln_bias, w_qkv, w_out, heads, s, eps, n_actual)
        ctx.save_for_backward(x, ln_scale, ln_bias, w_qkv, w_out, qkv, att,
                              lse)
        ctx.config = (heads, s, eps, n_actual)
        return out

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, w_qkv, w_out, qkv, att, lse = ctx.saved_tensors
        heads, s, eps, n_actual = ctx.config
        grads = attention_block_bwd(x, g.to(x.dtype), ln_scale, ln_bias,
                                    w_qkv, w_out, qkv, att, lse, heads, s,
                                    eps, n_actual)
        return (*grads, None, None, None, None)


def fused_attention_block(x, ln_scale, ln_bias, w_qkv, w_out, heads: int,
                          scale: Optional[float] = None, eps: float = 1e-5,
                          n_actual: Optional[int] = None) -> torch.Tensor:
    """The whole pre-norm attention block ([B, N, D] in and out),
    differentiable.

    A CPU ``x`` runs :func:`attention_block_ref` (and, under autograd,
    :func:`attention_block_bwd_ref` for the backward).  A CUDA ``x``
    launches the kernels (bf16, head dim 64, Dense kernels ``[in, out]``)
    or raises; it never falls back.  ``fused_attention_block.launches``
    counts the CUDA forwards and ``fused_attention_block.bwd_launches``
    the CUDA backwards.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"fused_attention_block: no kernel for device {x.device}")
    dh = _head_dim(w_qkv.shape[1], heads)
    s = dh ** -0.5 if scale is None else scale
    args = (x, ln_scale, ln_bias, w_qkv, w_out)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedAttention.apply(*args, heads, s, eps, n_actual)
    if x.device.type == "cpu":
        return attention_block_ref(*args, heads, scale, eps, n_actual)
    return _fwd_kernels(*args, heads, s, eps, _n_valid(x.shape[1], n_actual),
                        save=False)


fused_attention_block.launches = 0
fused_attention_block.bwd_launches = 0
