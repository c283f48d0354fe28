"""Curve-local block attention on [B, N, H, Dh] (#12, #13).

Counterpart of ``sfc_vit_tpu/ops/local_attention.py``.  Each query attends
to exactly the keys whose curve block is within ``halo`` blocks of its
own, ``|q // block - k // block| <= halo`` and ``k < N``: O(N x window)
work and memory in place of O(N^2).  Curve order keeps those keys near
the query in the image, which is the whole point of the curve layout.

The TPU kernels it replaces and their Hopper counterparts, CUDA C++ for
sm_90a:

  * #12 ``_kernel`` -> the windowed instance of #8's Hopper kernel
    (``csrc/flash_fwd_sm90.cu``'s single K step: ``wgmma`` on tiles a
    producer warp's TMA ring brings, the softmax in registers), a block of
    128 queries walking only the 128-key tiles of its window
    (``_build.local_fwd_tiles``, each warpgroup masking the keys outside
    its own, ``_build.local_fwd_key_range``; :func:`local_fwd`): fp32
    logits times scale over the query's whole window, the row's max and
    sum, ``P = p / l`` normalised in fp32 and *then* rounded to the input
    dtype, then an fp32 P.V rounded once; with autograd also the fp32
    log-sum-exp of the window, [B, H, N] (JAX keeps a lane-broadcast
    [B*H, Npad, 128] copy, a TPU layout).
  * #13 ``_bwd_kernel`` -> the windowed instances of #10's and #11's
    Hopper kernels (``csrc/flash_bwd_dq_sm90.cu``,
    ``csrc/flash_bwd_dkv_sm90.cu``: ``wgmma`` on tiles a producer warp's
    TMA ring brings), two launches (:func:`local_bwd`): p recomputed from
    the saved lse, ``dp = g v^T``, ``ds = p (dp - delta) scale`` with
    ``delta = rowsum(g * O)`` in fp32
    (:func:`~sfc_vit_tpu_torch.ops.flash_attention.flash_delta`, as JAX
    computes it outside its kernel); ``dq = ds k`` over the key window,
    then ``dv = p^T g`` and ``dk = ds^T q`` over the query-side window (the
    query blocks whose window holds the key block), each block walking
    only the 64-row tiles of its window (``_build.local_tile_window``),
    each output written once, no atomics.  p and ds stay fp32, as in JAX
    (a two-term bf16 split in the tensor-core products).

When every block is within ``halo`` of every other (``round_up(N, block)
// block <= halo + 1``) the mask is dense and, as in JAX, the function is
:func:`~sfc_vit_tpu_torch.ops.flash_attention.flash_attention`, forward
and backward.

Each kernel's plain version sits beside it, a loop over query blocks that
repeats JAX's arithmetic in O(N x window) memory, so it also runs at
16,384 tokens on the card: :func:`local_fwd_ref`, :func:`local_bwd_ref`.
:func:`local_block_attention_xla` is JAX's dense-mask twin.  A CPU tensor
runs the plain versions; a CUDA tensor launches the kernels (bfloat16,
head dim 64, ``block`` a multiple of 64, any ``halo >= 1``) or raises.
``local_block_attention.launches`` counts #12's launches,
``local_block_attention.bwd_launches`` #13's (one a backward, its two
kernels together).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .flash_attention import flash_attention, flash_attention_ref, flash_delta
from .kernel_utils import NEG_INF, round_up

__all__ = ["local_block_attention", "local_block_attention_ref",
           "local_block_attention_xla", "local_fwd", "local_bwd", "local_fwd_ref",
           "local_bwd_ref", "is_dense", "window"]


def _bhnd(t: torch.Tensor) -> torch.Tensor:
    """[B, N, H, Dh] -> a [B, H, N, Dh] view."""
    return t.permute(0, 2, 1, 3)


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return q.shape[-1] ** -0.5 if scale is None else scale


def window(j: int, n: int, block: int, halo: int):
    """The key range ``[lo, hi)`` of query block ``j`` (and, by symmetry,
    the query range whose windows hold key block ``j``)."""
    return max(0, (j - halo) * block), min(n, (j + halo + 1) * block)


def is_dense(n: int, block: int, halo: int) -> bool:
    """JAX's dense case: every block is within ``halo`` of every other, so
    the mask is all ones (``n_blocks <= 2 * halo + 1`` is not enough: the
    two end blocks would still be masked apart)."""
    return round_up(n, block) // block <= halo + 1


def local_block_attention_xla(q, k, v, block: int = 128, halo: int = 1,
                              scale: Optional[float] = None) -> torch.Tensor:
    """JAX's dense-mask twin: fp32 logits times scale, -1e30 outside
    ``|block(q) - block(k)| <= halo``, fp32 softmax rounded to the input
    dtype, then the weighted sum.  O(N^2) memory: for small N."""
    n = q.shape[1]
    ids = torch.arange(n, device=q.device) // block
    mask = (ids[:, None] - ids[None, :]).abs() <= halo
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * _scale(q, scale)
    logits = torch.where(mask, logits, torch.full((), NEG_INF, device=q.device))
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", weights, v)


# ---------------------------------------------------------------------------
# Plain versions: a loop over query blocks with JAX's arithmetic
# ---------------------------------------------------------------------------


def local_fwd_ref(q, k, v, block: int, halo: int, scale: float,
                  return_lse: bool = False):
    """Plain version of #12: ``(out [B, N, H, Dh], lse fp32 [B, H, N])``
    (just ``out`` without ``return_lse``).  Per query block the logits
    over its window ``[lo, hi)`` in fp32, the window's max and sum, ``P =
    p / l`` rounded to the input dtype, then an fp32 P.V rounded once."""
    b, n, h, dh = q.shape
    dt = q.dtype
    qf, kf, vf = _bhnd(q).float(), _bhnd(k).float(), _bhnd(v).float()
    out = torch.empty((b, h, n, dh), dtype=dt, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    for j in range(round_up(n, block) // block):
        q0, q1 = j * block, min(n, (j + 1) * block)
        lo, hi = window(j, n, block, halo)
        s = (qf[:, :, q0:q1] @ kf[:, :, lo:hi].transpose(-1, -2)) * scale
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        denom = p.sum(-1, keepdim=True)
        w = (p / denom).to(dt).float()
        out[:, :, q0:q1] = (w @ vf[:, :, lo:hi]).to(dt)
        lse[:, :, q0:q1] = (m + torch.log(denom))[..., 0]
    out = out.transpose(1, 2)
    return (out, lse) if return_lse else out


def local_bwd_ref(q, k, v, g, lse, delta, block: int, halo: int, scale: float):
    """Plain version of #13: ``(dq, dk, dv)`` [B, N, H, Dh] in the input
    dtypes from the forward's fp32 ``lse`` and ``delta = rowsum(g * O)``
    (both [B, H, N]).  Per query block over its window, all fp32: ``p =
    exp(s - lse)``, ``dp = g v^T``, ``ds = p (dp - delta) scale``, ``dq =
    ds k`` (rounded once), and ``dk += ds^T q``, ``dv += p^T g`` into fp32
    sums rounded once at the end."""
    b, n, h, dh = q.shape
    qf, kf, vf, gf = (_bhnd(t).float() for t in (q, k, v, g))
    dq = torch.empty((b, h, n, dh), dtype=q.dtype, device=q.device)
    dk = torch.zeros((b, h, n, dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for j in range(round_up(n, block) // block):
        q0, q1 = j * block, min(n, (j + 1) * block)
        lo, hi = window(j, n, block, halo)
        qj, gj = qf[:, :, q0:q1], gf[:, :, q0:q1]
        kw, vw = kf[:, :, lo:hi], vf[:, :, lo:hi]
        p = torch.exp((qj @ kw.transpose(-1, -2)) * scale - lse[:, :, q0:q1, None])
        dp = gj @ vw.transpose(-1, -2)
        ds = p * (dp - delta[:, :, q0:q1, None]) * scale
        dq[:, :, q0:q1] = (ds @ kw).to(q.dtype)
        dk[:, :, lo:hi] += ds.transpose(-1, -2) @ qj
        dv[:, :, lo:hi] += p.transpose(-1, -2) @ gj
    return (dq.transpose(1, 2), dk.to(k.dtype).transpose(1, 2),
            dv.to(v.dtype).transpose(1, 2))


# ---------------------------------------------------------------------------
# The kernels' wrappers: plain version for a CPU tensor, kernel for CUDA
# ---------------------------------------------------------------------------


def _check_device(q: torch.Tensor, block: int, halo: int) -> bool:
    """True for a CUDA tensor the kernels take; False for a CPU one."""
    if halo < 1 or block < 1:
        raise ValueError(f"local_block_attention: block={block}, halo={halo}; "
                         "both must be at least 1")
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"local_block_attention: no kernel for device {q.device}")
    if q.dtype != torch.bfloat16 or q.shape[-1] != 64 or block % 64:
        raise NotImplementedError(
            f"local_block_attention: {q.dtype} at head dim {q.shape[-1]} with block "
            f"{block} is not ported to the GPU yet, the kernels take bfloat16 at head "
            "dim 64 with block a multiple of 64: ROADMAP.md queue 2 entry 3 "
            "(kernels #12/#13 in fp32, at other head dims and blocks)")
    return True


def local_fwd(q, k, v, block: int, halo: int, scale: float, return_lse: bool = False):
    """#12: the output [B, N, H, Dh] (and the fp32 lse [B, H, N] with
    ``return_lse``)."""
    if not _check_device(q, block, halo):
        return local_fwd_ref(q, k, v, block, halo, scale, return_lse)
    res = _build.local_fwd(q, k, v, scale, block, halo, with_lse=return_lse)
    local_block_attention.launches += 1
    return res


def local_bwd(q, k, v, g, lse, delta, block: int, halo: int, scale: float):
    """#13: ``(dq, dk, dv)`` [B, N, H, Dh] in the input dtype."""
    if not _check_device(q, block, halo):
        return local_bwd_ref(q, k, v, g, lse, delta, block, halo, scale)
    grads = _build.local_bwd(q, k, v, g, lse, delta, scale, block, halo)
    local_block_attention.bwd_launches += 1
    return grads


class _Local(torch.autograd.Function):
    """#12 with its lse saved, then #13 (JAX's ``_la_fwd`` / ``_la_bwd``).
    ``plain`` runs the plain versions on any device (the comparison path,
    :func:`local_block_attention_ref`)."""

    @staticmethod
    def forward(ctx, q, k, v, block, halo, scale, plain):
        fwd = local_fwd_ref if plain else local_fwd
        out, lse = fwd(q, k, v, block, halo, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (block, halo, scale)
        ctx.plain = plain
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.to(out.dtype)
        bwd = local_bwd_ref if ctx.plain else local_bwd
        grads = bwd(q, k, v, g, lse, flash_delta(g, out), *ctx.args)
        return (*grads, None, None, None, None)


def _attend(q, k, v, block, halo, scale, plain: bool):
    s = _scale(q, scale)
    if is_dense(q.shape[1], block, halo):
        return (flash_attention_ref if plain else flash_attention)(q, k, v, s)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Local.apply(q, k, v, block, halo, s, plain)
    return (local_fwd_ref if plain else local_fwd)(q, k, v, block, halo, s)


def local_block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          block: int = 128, halo: int = 1,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Curve-local attention on [B, N, H, Dh], differentiable: exact
    ``|block(q) - block(k)| <= halo`` masking in O(N x window).

    A CPU tensor runs the plain versions; a CUDA one the kernels #12/#13
    (bfloat16, head dim 64, rows 16-byte aligned: the views of a packed
    projection need no copy) or raises.  It never falls back.  The dense
    case is :func:`~sfc_vit_tpu_torch.ops.flash_attention.flash_attention`.
    """
    return _attend(q, k, v, block, halo, scale, plain=False)


def local_block_attention_ref(q, k, v, block: int = 128, halo: int = 1,
                              scale: Optional[float] = None) -> torch.Tensor:
    """:func:`local_block_attention` through the plain versions on any
    device: the comparison path for the kernels."""
    return _attend(q, k, v, block, halo, scale, plain=True)


local_block_attention.launches = 0
local_block_attention.bwd_launches = 0
