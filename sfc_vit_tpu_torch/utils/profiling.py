"""Observability: attention-weight rows from the flash kernel's lse.

Counterpart of ``sfc_vit_tpu/utils/profiling.py::attention_rows`` (line
80), the reading side of the LSE capture path: with q, k and the per-query
log-sum-exp that
:func:`~sfc_vit_tpu_torch.ops.flash_attention.flash_attention_with_lse`
returns (kernel #8's own lse on the card), chosen rows of the softmax
weights rebuild in O(rows x N), with no [N, N] tensor.  The module's
other hooks (``trace``, ``annotate``, ``attention_maps``) are not ported
yet: ROADMAP.md queue 1 item 14.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_rows"]


def attention_rows(q, k, lse, queries, scale: Optional[float] = None) -> torch.Tensor:
    """Rows ``queries`` of the softmax attention weights, [B, H, R, N]:
    ``exp(q_r k^T * scale - lse_r)`` in fp32, which is
    ``softmax(q k^T * scale)[queries]`` anchored to the kernel's own lse.

    q, k [B, N, H, Dh] and lse [B, H, Nq] (a tuple or list of one tensor,
    as a capture may hold them, is unwrapped); ``queries`` an int index
    sequence or tensor [R]; ``scale`` defaults to Dh ** -0.5.
    """
    def unwrap(a):
        return a[0] if isinstance(a, (tuple, list)) else a

    q, k, lse = unwrap(q), unwrap(k), unwrap(lse)
    s = q.shape[-1] ** -0.5 if scale is None else scale
    idx = torch.as_tensor(queries, dtype=torch.long, device=q.device)
    qs = q[:, idx].float()  # [B, R, H, Dh]
    logits = torch.einsum("brhd,bnhd->bhrn", qs, k.float()) * s
    return torch.exp(logits - lse[:, :, idx, None])
