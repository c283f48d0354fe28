"""Torch-parity multi-head attention with probability dropout (family A)
for training, forward and backward, on Hopper.

Counterpart of ``sfc_vit_tpu/ops/fused_torch_attention.py``: the whole
``nn.MultiheadAttention`` training forward,
``out_proj(prob_dropout(softmax(q k^T scale)) v)`` with the packed
in-proj ``[D, 3D]``, and its backward.  The TPU kernels
``_torch_mha_kernel`` (#5) and ``_torch_mha_bwd_kernel`` (#6) hold a
group of images, both projections and every head's softmax in VMEM; here
each is a chain of hand-written kernels through L2:

Forward (#5): ``gemm`` (``qkv = bf16(x W_in + b_in)``, fp32 sum and bias,
one rounding) -> ``attention_fwd`` with the mask (``csrc/packed_attn_sm90.cu``'s
masked forms, a persistent grid over (image, head, 64-query tile) items:
fp32 logits times Dh^-0.5, pad keys -1e30, ``pd = bf16((P / keep) *
mask)`` with the mask's 64 x 64 tiles brought by TMA beside K and V,
``att = bf16(pd v)``, and the fp32 ``lse = m + log l`` the backward
recomputes from; its plain twin is ``attention_fwd_ref`` with the mask)
-> ``gemm`` (``y = bf16(att W_out + b_out)``).  Training saves qkv, att
and lse.

Backward (#6): ``colsum`` (db_out of gp, the cotangent with rows at or
past ``n_actual`` zeroed) -> ``gemm`` TN (dW_out = att^T gp, one fp32 sum
over all rows) -> ``gemm`` NT (datt = bf16(gp W_out^T)) ->
``attention_bwd`` with the mask (``csrc/attention_bwd_sm90.cu`` at both
models' shapes: dq, dk, dv from the recomputed fp32 ``pf = exp(s - lse)``,
``pdf = (pf / keep) * mask``, ``dp = ((da v^T) / keep) * mask``, the flash
delta ``rowsum(da * att_h)``, ``ds = bf16(pf (dp - delta) scale)``; its
plain twin is ``attention_bwd_ref`` with the mask) -> ``colsum``
(db_in of the bf16-rounded dqkv) -> ``gemm`` TN (dW_in = x^T dqkv) ->
``gemm`` NT (dx = dqkv W_in^T, one rounding to x's dtype).  No LayerNorm
and no residual: the encoder layer adds them outside.  Parameter
gradients leave in fp32 and are cast to the parameters' dtypes, as
``_ftm_bwd`` does.

The dropout mask ``[B, H, N, N]`` is an input, drawn outside the kernel
as the JAX package draws it (``layers.py:141-145``); it may be bool or
uint8 (the same 0/1 values in a quarter of a bf16 mask's bytes).  Its
cotangent is zero.  ``keep = 1 - rate`` divides, it is never turned into
a reciprocal: ``x / keep`` and ``x * (1 / keep)`` round differently.

``n_actual`` keeps the JAX contract: keys at or past it are masked out of
every softmax, rows at or past it are don't-care outputs whose
cotangents are zeroed before every gradient path, so their dx and their
share of every parameter gradient are zero.

In float32 (the reference notebook's ``VisionTransformer``, and the
flagship at its own ``dtype=None``) the same chains run on fp32 SIMT
kernels, full fp32 with no TF32 and no narrower rounding:
``csrc/gemm_f32.cu`` for every product (its TN weight gradients split
over K and summed in split order), ``csrc/packed_attn_f32.cu`` for the
masked attention with lse, ``csrc/attention_bwd_f32.cu`` for its
backward (dq, then dk and dv, each row with one owner) and
``csrc/colsum_bf16.cu``'s fp32 instance for the bias gradients.

A CPU input runs the plain versions :func:`torch_mha_fwd_ref` and
:func:`torch_mha_bwd_ref` (the kernels' arithmetic and rounding points);
a CUDA input launches the kernels (bf16 or fp32, head dim 64 or 192) or
raises.  ``fused_torch_mha.launches`` counts the bf16 CUDA forwards and
``fused_torch_mha.bwd_launches`` the bf16 CUDA backwards,
``f32_launches`` and ``f32_bwd_launches`` the fp32 ones.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import attention_bwd, attention_fwd, colsum, gemm, gemm_f32
from .fused_attention_block import attention_bwd_ref
from .kernel_utils import NEG_INF, kernel_is_f32, n_valid as _n_valid

__all__ = ["fused_torch_mha", "torch_mha_train", "torch_mha_fwd_ref",
           "torch_mha_bwd_ref", "torch_mha_train_fwd", "torch_mha_bwd"]


def _validate(d: int, in_width: int, heads: int) -> None:
    if in_width != 3 * d:
        raise ValueError(
            f"torch MHA packs in_proj as [D, 3D]; got [{d}, {in_width}]")
    if d % heads:
        raise ValueError(f"dim {d} not divisible by heads {heads}")


def _check_args(x, w_in, heads: int, keep: float) -> None:
    if keep <= 0.0:
        raise ValueError(
            "fused_torch_mha requires keep > 0 (dropout rate < 1); rate=1.0 "
            "means the attention output is all zeros -- use the "
            "explicit-weights path for that.")
    _validate(x.shape[-1], w_in.shape[1], heads)


def _scale(d: int, heads: int, scale: Optional[float]) -> float:
    return (d // heads) ** -0.5 if scale is None else scale


def torch_mha_train(x, w_in, b_in, w_out, b_out, drop_mask, heads: int,
                    scale: Optional[float] = None, keep: float = 1.0,
                    n_actual: Optional[int] = None) -> torch.Tensor:
    """The unfused composition with an explicit 0/1 probability mask,
    the counterpart of JAX's ``torch_mha_train``: what the explicit-weights
    path of ``TorchMultiHeadAttention`` computes given the same mask
    (fp32 softmax, ``where(mask, P / keep, 0)``, weights cast to the
    input dtype before the weighted sum).  Differentiable by autograd."""
    b, n, d = x.shape
    _validate(d, w_in.shape[1], heads)
    dh = d // heads
    s = _scale(d, heads, scale)
    qkv = x @ w_in + b_in
    q, k, v = (t.reshape(b, n, heads, dh) for t in qkv.split(d, dim=-1))
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * s
    if n_actual is not None and n_actual < n:
        logits[..., n_actual:] = NEG_INF
    w = torch.softmax(logits, dim=-1)
    if drop_mask is not None:
        w = torch.where(drop_mask.bool(), w / keep, w.new_zeros(()))
    out = torch.einsum("bhnm,bmhd->bnhd", w.to(v.dtype), v)
    return out.reshape(b, n, d) @ w_out + b_out


def _logits(qkv: torch.Tensor, heads: int, n_valid: int, s: float):
    """fp32 q, k, v [B, H, N, Dh] and the logits times ``s`` with keys at
    or past ``n_valid`` set to -1e30."""
    b, n, w = qkv.shape
    q, k, v = qkv.view(b, n, 3, heads, w // (3 * heads)).permute(2, 0, 3, 1, 4).float()
    logits = (q @ k.transpose(-1, -2)) * s
    logits[..., n_valid:] = NEG_INF
    return q, k, v, logits


def torch_mha_fwd_ref(x, w_in, b_in, w_out, b_out, mask, heads: int,
                      scale: Optional[float] = None, keep: float = 1.0,
                      n_actual: Optional[int] = None, save_acts: bool = False):
    """Plain version of the forward kernel chain (#5) with its rounding
    points: qkv rounded once after the fp32 sum and bias, fp32 softmax,
    ``pd = (P / keep) * mask`` rounded to the input dtype, att rounded
    after the fp32 ``pd v``, y rounded after the fp32 sum and bias.
    Returns y, or ``(y, qkv, att, lse)`` with ``save_acts``."""
    b, n, d = x.shape
    _validate(d, w_in.shape[1], heads)
    s = _scale(d, heads, scale)
    dt = x.dtype
    qkv = (x.float() @ w_in.float() + b_in.float()).to(dt)
    _, _, v, logits = _logits(qkv, heads, _n_valid(n, n_actual), s)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    pd = ((p / l / keep) * mask.float()).to(dt).float()
    att = (pd @ v).transpose(1, 2).reshape(b, n, d).to(dt)
    y = (att.float() @ w_out.float() + b_out.float()).to(dt)
    if not save_acts:
        return y
    return y, qkv, att, (m + torch.log(l))[..., 0]


def torch_mha_bwd_ref(x, g, w_in, w_out, mask, qkv, att, lse, heads: int,
                      scale: Optional[float] = None, keep: float = 1.0,
                      n_actual: Optional[int] = None):
    """Plain version of the backward kernel chain (#6) with the rounding
    points of ``_torch_mha_bwd_kernel``, from what the training forward
    saved (``qkv``, ``att``, fp32 ``lse`` [B, H, N]) and its mask.

    Returns ``(dx, dw_in, db_in, dw_out, db_out)``: dx in x's dtype, the
    parameter gradients in fp32 (summed over every row in fp32)."""
    b, n, d = x.shape
    s = _scale(d, heads, scale)
    nv = _n_valid(n, n_actual)
    dt = x.dtype
    r = b * n
    gp = g.clone()
    gp[:, nv:] = 0  # pad rows add nothing to any gradient
    gpf = gp.reshape(r, d).float()
    db_out = gpf.sum(0)
    dw_out = att.reshape(r, d).float().T @ gpf
    datt = (gpf @ w_out.float().T).to(dt).view(b, n, d)
    dqkv = attention_bwd_ref(qkv, att, datt, lse, heads, nv, s, mask=mask,
                             keep=keep).reshape(r, 3 * d).float()
    db_in = dqkv.sum(0)
    dw_in = x.reshape(r, d).float().T @ dqkv
    dx = (dqkv @ w_in.float().T).to(dt).view(b, n, d)
    return dx, dw_in, db_in, dw_out, db_out


def _kernels_fwd(x, w_in, b_in, w_out, b_out, mask, heads, s, keep, n_valid,
                 save):
    f32 = kernel_is_f32("fused_torch_mha", x.dtype)
    mm = gemm_f32 if f32 else gemm
    b, n, d = x.shape
    x2 = x.reshape(b * n, d)
    qkv = mm(x2, w_in, bias=b_in.float()).view(b, n, 3 * d)
    att = attention_fwd(qkv, heads, n_valid, s, with_lse=save, mask=mask,
                        keep=keep)
    if save:
        att, lse = att
    y = mm(att.view(b * n, d), w_out, bias=b_out.float()).view(b, n, d)
    if f32:
        fused_torch_mha.f32_launches += 1
    else:
        fused_torch_mha.launches += 1
    return (y, qkv, att, lse) if save else y


def torch_mha_train_fwd(x, w_in, b_in, w_out, b_out, mask, heads: int,
                        scale: Optional[float] = None, keep: float = 1.0,
                        n_actual: Optional[int] = None):
    """The training forward, ``(y, qkv, att, lse)``: the kernels for a
    CUDA ``x``, :func:`torch_mha_fwd_ref` for a CPU one."""
    s = _scale(x.shape[-1], heads, scale)
    if x.device.type == "cpu":
        return torch_mha_fwd_ref(x, w_in, b_in, w_out, b_out, mask, heads, s,
                                 keep, n_actual, save_acts=True)
    return _kernels_fwd(x.contiguous(), w_in, b_in, w_out, b_out, mask, heads,
                        s, keep, _n_valid(x.shape[1], n_actual), save=True)


def torch_mha_bwd(x, g, w_in, w_out, mask, qkv, att, lse, heads: int,
                  scale: Optional[float] = None, keep: float = 1.0,
                  n_actual: Optional[int] = None):
    """The backward from the saved ``qkv``, ``att`` and ``lse``, with the
    arguments and results of :func:`torch_mha_bwd_ref`, which it runs for
    a CPU ``x``.  A CUDA ``x`` launches the kernel chain."""
    if x.device.type == "cpu":
        return torch_mha_bwd_ref(x, g, w_in, w_out, mask, qkv, att, lse, heads,
                                 scale, keep, n_actual)
    f32 = kernel_is_f32("fused_torch_mha", x.dtype)
    mm = gemm_f32 if f32 else gemm
    b, n, d = x.shape
    s = _scale(d, heads, scale)
    nv = _n_valid(n, n_actual)
    r = b * n
    x2 = x.reshape(r, d)
    gp = g.reshape(r, d).contiguous()
    if nv < n:
        gp = gp.clone()
        gp.view(b, n, d)[:, nv:] = 0
    db_out = colsum(gp)
    dw_out = mm(att.view(r, d), gp, trans_a=True, out_dtype=torch.float32)
    datt = mm(gp, w_out, trans_b=True)                            # [R, D]
    dqkv = attention_bwd(qkv, att, datt.view(b, n, d), lse, heads, nv, s,
                         mask=mask, keep=keep).view(r, 3 * d)
    db_in = colsum(dqkv)
    dw_in = mm(x2, dqkv, trans_a=True, out_dtype=torch.float32)    # [D, 3D]
    dx = mm(dqkv, w_in, trans_b=True).view(b, n, d)
    if f32:
        fused_torch_mha.f32_bwd_launches += 1
    else:
        fused_torch_mha.bwd_launches += 1
    return dx, dw_in, db_in, dw_out, db_out


class _FusedTorchMHA(torch.autograd.Function):
    """Kernels #5 and #6 as one differentiable op: the forward saves x,
    the weights, the mask and qkv, att, lse (as ``_ftm_fwd`` does); the
    backward is :func:`torch_mha_bwd`, its parameter gradients cast to
    the parameters' dtypes."""

    @staticmethod
    def forward(ctx, x, w_in, b_in, w_out, b_out, mask, heads, s, keep,
                n_actual):
        y, qkv, att, lse = torch_mha_train_fwd(x, w_in, b_in, w_out, b_out,
                                               mask, heads, s, keep, n_actual)
        ctx.save_for_backward(x, w_in, b_in, w_out, b_out, mask, qkv, att, lse)
        ctx.config = (heads, s, keep, n_actual)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w_in, b_in, w_out, b_out, mask, qkv, att, lse = ctx.saved_tensors
        heads, s, keep, n_actual = ctx.config
        dx, dw_in, db_in, dw_out, db_out = torch_mha_bwd(
            x, g.to(x.dtype), w_in, w_out, mask, qkv, att, lse, heads, s, keep,
            n_actual)
        return (dx, dw_in.to(w_in.dtype), db_in.to(b_in.dtype),
                dw_out.to(w_out.dtype), db_out.to(b_out.dtype),
                None, None, None, None, None)


def fused_torch_mha(x, w_in, b_in, w_out, b_out, drop_mask, heads: int,
                    scale: Optional[float] = None, keep: float = 1.0,
                    n_actual: Optional[int] = None) -> torch.Tensor:
    """Torch-parity MHA with probability dropout, differentiable.

    ``x`` [B, N, D]; ``w_in`` [D, 3D], ``w_out`` [D, D] (Dense kernels
    ``[in, out]``), biases [3D] and [D]; ``drop_mask`` the 0/1 keep mask
    [B, H, N, N] (bool or uint8) and ``keep = 1 - rate``.  A CPU ``x``
    runs the plain versions; a CUDA ``x`` launches kernels #5 (and, under
    autograd, #6) or raises; it never falls back.
    """
    _check_args(x, w_in, heads, keep)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_torch_mha: no kernel for device {x.device}")
    s = _scale(x.shape[-1], heads, scale)
    args = (x, w_in, b_in, w_out, b_out)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedTorchMHA.apply(*args, drop_mask, heads, s, keep, n_actual)
    if x.device.type == "cpu":
        return torch_mha_fwd_ref(*args, drop_mask, heads, s, keep, n_actual)
    return _kernels_fwd(x.contiguous(), *args[1:], drop_mask, heads, s, keep,
                        _n_valid(x.shape[1], n_actual), save=False)


fused_torch_mha.launches = 0
fused_torch_mha.bwd_launches = 0
fused_torch_mha.f32_launches = 0
fused_torch_mha.f32_bwd_launches = 0
