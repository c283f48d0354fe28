"""Attention dispatch for the port: the packed-QKV and [B, N, H, Dh] entry
points and the plain formulas.

Counterpart of ``sfc_vit_tpu/ops/attention.py``.  Layouts are the JAX
package's: [B, N, H, Dh] for ``multi_head_attention``,
``dot_product_attention_xla`` and ``attention_with_weights``, the packed
[B, N, 3*H*Dh] projection for ``packed_qkv_attention``.

The port routes as the JAX package routes on its chip, on every device:
the route picks the *formula*, and each kernel's wrapper then runs its
plain version for a CPU tensor and the kernel for a CUDA one.
``packed_qkv_attention``'s implementations (:func:`packed_route`):

  * ``"auto"`` -- N <= ``PACKED_MAX_N``: kernel #7
    (:func:`~sfc_vit_tpu_torch.ops.flash_attention.packed_flash_attention`,
    the fp32 softmax normalised then rounded); past it, with a head dim in
    ``PALLAS_HEAD_DIMS``: streaming flash attention
    (:func:`~sfc_vit_tpu_torch.ops.flash_attention.flash_attention`,
    kernels #8-#11); otherwise the formula below.  JAX's VMEM budget
    (``packed_attention_fits``) has no counterpart: Hopper kernels tile.
  * ``"pallas"`` -- streaming flash attention at any N.
  * ``"xla"`` -- the formula (the kernel's plain version
    :func:`~sfc_vit_tpu_torch.ops.flash_attention._packed_xla_ref`): fp32
    logits and softmax, weights rounded to the input dtype before the
    weighted sum.
  * ``"local"`` -- curve-local block attention at JAX's defaults, block
    128 and halo 1
    (:func:`~sfc_vit_tpu_torch.ops.local_attention.local_block_attention`,
    kernels #12/#13), on [B, N, H, Dh] views of the packed projection.
  * ``"xla_bf16"``, ``"ring"``, ``"sp"`` -- not ported yet; each raises
    ``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .flash_attention import _packed_xla_ref, flash_attention, packed_flash_attention
from .local_attention import local_block_attention

__all__ = ["packed_qkv_attention", "multi_head_attention", "packed_route",
           "dot_product_attention_xla", "attention_with_weights",
           "check_implementation", "PALLAS_MIN_N", "PALLAS_HEAD_DIMS",
           "PACKED_MAX_N"]

_IMPLEMENTATIONS = ("auto", "xla", "xla_bf16", "pallas", "local", "ring", "sp")

#: Where each implementation that is not ported yet stands in ROADMAP.md.
_NOT_PORTED = {
    "xla_bf16": "queue 1 item 2 (the bf16-softmax formula)",
    "ring": "queue 1 item 13 (parallel: sequence parallelism)",
    "sp": "queue 1 item 13 (parallel: sequence parallelism)",
}

#: JAX's ``_PALLAS_MIN_N`` (``sfc_vit_tpu/ops/attention.py:130``): from
#: this length ``auto`` takes streaming flash attention.  It chooses the
#: *formula* a length runs, so that the port matches the reference; the
#: length at which flash overtakes the other forms on the H100 is still
#: to measure.
PALLAS_MIN_N = 1024
#: JAX's ``_PALLAS_HEAD_DIMS``: the head dims ``auto`` sends to flash.
PALLAS_HEAD_DIMS = (64, 128, 256)
#: JAX's ``_PACKED_MAX_N`` (``flash_attention.py:946``): up to this length
#: the packed entry point takes kernel #7, whose launcher holds the same
#: bound.  A formula choice, as above; the H100 crossover is still to
#: measure.
PACKED_MAX_N = _build.PACKED_MAX_N


def check_implementation(implementation: str) -> None:
    """Raise for an unknown implementation (ValueError) or one that is not
    ported yet (NotImplementedError naming its ROADMAP.md item)."""
    if implementation not in _IMPLEMENTATIONS:
        raise ValueError(f"unknown attention implementation {implementation!r}; "
                         f"one of {_IMPLEMENTATIONS}")
    if implementation in _NOT_PORTED:
        raise NotImplementedError(
            f"attention implementation {implementation!r} is not ported to "
            f"PyTorch yet: ROADMAP.md {_NOT_PORTED[implementation]}")


def packed_route(implementation: str, n: int, dh: int) -> str:
    """Which path ``packed_qkv_attention`` takes for ``n`` tokens of head
    dim ``dh``: ``'packed'`` (#7), ``'flash'`` (#8-#11), ``'local'``
    (#12/#13) or ``'xla'`` (the fp32 formula).  JAX's dispatch on its chip
    (``sfc_vit_tpu/ops/attention.py:212-239``) without the VMEM budget."""
    check_implementation(implementation)
    if implementation == "local":
        return "local"
    if implementation == "pallas":
        return "flash"
    if implementation == "auto":
        if n <= PACKED_MAX_N:
            return "packed"
        if dh in PALLAS_HEAD_DIMS and n >= PALLAS_MIN_N:
            return "flash"
    return "xla"


def attention_with_weights(q, k, v, scale: Optional[float] = None):
    """Attention that also returns the per-head weights [B, H, N, N]
    (fp32 softmax of fp32 logits); q, k, v [B, N, H, Dh]."""
    dh = q.shape[-1]
    s = dh ** -0.5 if scale is None else scale
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    weights = torch.softmax(logits * s, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", weights.to(q.dtype), v)
    return out, weights


def dot_product_attention_xla(q, k, v, scale: Optional[float] = None):
    """softmax(q k^T * scale) v on [B, N, H, Dh], the softmax in fp32 and
    the weights cast back to the input dtype."""
    dh = q.shape[-1]
    s = dh ** -0.5 if scale is None else scale
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * s
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", weights, v)


def multi_head_attention(q, k, v, scale: Optional[float] = None,
                         implementation: str = "auto") -> torch.Tensor:
    """Multi-head attention on [B, N, H, Dh] (JAX's dispatch,
    ``attention.py:262-328``): ``'local'`` runs
    :func:`~sfc_vit_tpu_torch.ops.local_attention.local_block_attention`
    at block 128, halo 1; ``'pallas'``, or ``'auto'`` at N >=
    ``PALLAS_MIN_N`` with a head dim in ``PALLAS_HEAD_DIMS``, runs
    :func:`flash_attention`; ``'xla'`` and the rest of ``'auto'`` the fp32
    formula, except that JAX's ``auto`` takes the bf16 softmax for bf16
    rows shorter than ``PALLAS_MIN_N``, which raises here until that
    formula is ported (queue 1 item 2)."""
    check_implementation(implementation)
    if implementation == "local":
        return local_block_attention(q, k, v, scale=scale)
    n, dh = q.shape[1], q.shape[-1]
    if implementation == "pallas" or (
            implementation == "auto" and dh in PALLAS_HEAD_DIMS and n >= PALLAS_MIN_N):
        return flash_attention(q, k, v, scale)
    if implementation == "auto" and q.dtype == torch.bfloat16 and n < PALLAS_MIN_N:
        check_implementation("xla_bf16")
    return dot_product_attention_xla(q, k, v, scale)


def packed_qkv_attention(qkv: torch.Tensor, heads: int,
                         scale: Optional[float] = None,
                         implementation: str = "auto") -> torch.Tensor:
    """Attention on a packed [B, N, 3*H*Dh] projection -> [B, N, H*Dh],
    routed by :func:`packed_route`.  The flash and local routes read q, k
    and v as [B, N, H, Dh] views of the projection, with no copy."""
    b, n, three_inner = qkv.shape
    if three_inner % (3 * heads):
        raise ValueError(f"packed QKV feature dim {three_inner} must be "
                         f"divisible by 3*heads={3 * heads}")
    dh = three_inner // (3 * heads)
    route = packed_route(implementation, n, dh)
    if route == "packed":
        return packed_flash_attention(qkv, heads, scale)
    if route in ("flash", "local"):
        q, k, v = qkv.view(b, n, 3, heads, dh).unbind(2)
        out = (flash_attention(q, k, v, scale) if route == "flash"
               else local_block_attention(q, k, v, scale=scale))
        return out.reshape(b, n, heads * dh)
    return _packed_xla_ref(qkv, heads, dh ** -0.5 if scale is None else scale)
