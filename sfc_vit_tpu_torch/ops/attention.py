"""Attention dispatch for the port: the packed-QKV entry point and the
plain formulas.

Counterpart of ``sfc_vit_tpu/ops/attention.py``.  Layouts are the JAX
package's: [B, N, H, Dh] for ``dot_product_attention_xla`` and
``attention_with_weights``, the packed [B, N, 3*H*Dh] projection for
``packed_qkv_attention``.

``packed_qkv_attention``'s implementations:
  * ``"auto"`` -- on a CUDA tensor, kernel #7
    (:func:`~sfc_vit_tpu_torch.ops.flash_attention.packed_flash_attention`),
    which raises for a head dim or dtype it does not take (its key tiles
    stream, so no sequence length is refused, and the TPU's
    ``_PACKED_MAX_N`` VMEM gate has no counterpart here).  On the CPU the
    formula below.
  * ``"xla"`` -- the formula (the kernel's plain version
    :func:`~sfc_vit_tpu_torch.ops.flash_attention._packed_xla_ref`): fp32
    logits and softmax, weights rounded to the input dtype before the
    weighted sum.
  * ``"xla_bf16"``, ``"pallas"``, ``"local"``, ``"ring"``, ``"sp"`` --
    not ported yet; each raises ``NotImplementedError`` naming its
    ROADMAP.md item.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import _packed_xla_ref, packed_flash_attention

__all__ = ["packed_qkv_attention", "dot_product_attention_xla",
           "attention_with_weights", "check_implementation"]

_IMPLEMENTATIONS = ("auto", "xla", "xla_bf16", "pallas", "local", "ring", "sp")

#: Where each implementation that is not ported yet stands in ROADMAP.md.
_NOT_PORTED = {
    "xla_bf16": "queue 1 item 2 (the bf16-softmax formula)",
    "pallas": "queue 1 item 10 (long context: streaming flash, kernels #8-#11)",
    "local": "queue 1 item 10 (long context: curve-local attention, kernels #12-#13)",
    "ring": "queue 1 item 13 (parallel: sequence parallelism)",
    "sp": "queue 1 item 13 (parallel: sequence parallelism)",
}


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


def packed_qkv_attention(qkv: torch.Tensor, heads: int,
                         scale: Optional[float] = None,
                         implementation: str = "auto") -> torch.Tensor:
    """Attention on a packed [B, N, 3*H*Dh] projection -> [B, N, H*Dh]."""
    check_implementation(implementation)
    three_inner = qkv.shape[-1]
    if three_inner % (3 * heads):
        raise ValueError(f"packed QKV feature dim {three_inner} must be "
                         f"divisible by 3*heads={3 * heads}")
    dh = three_inner // (3 * heads)
    if implementation == "auto" and qkv.device.type == "cuda":
        return packed_flash_attention(qkv, heads, scale)
    return _packed_xla_ref(qkv, heads, dh ** -0.5 if scale is None else scale)
