"""Data-dependent curve token merging.

Counterpart of ``sfc_vit_tpu/ops/token_merge.py``: curve-adjacent token
pairs are scored by cosine similarity and the ``k`` most similar pairs
are merged (averaged); the others keep both tokens.  Plain PyTorch, as
the JAX package computes it outside any kernel.  Gradients flow through
the average and the gathers; the choice of pairs has none.
"""

from __future__ import annotations

import torch

__all__ = ["curve_pair_merge_topk"]


def curve_pair_merge_topk(x: torch.Tensor, merge_ratio: float = 0.5,
                          eps: float = 1e-6) -> torch.Tensor:
    """Merge the most similar curve-adjacent pairs: [B, N, D] -> [B, M, D]
    with M = N - k, k = floor(N/2 * merge_ratio).

    Curve order is kept: a merged pair gives one averaged token at its
    pair position, an unmerged pair both tokens.  Every sort is stable,
    so ties break by pair index and the count of merges is exact.
    """
    b, n, d = x.shape
    if n % 2:
        raise ValueError(f"token count {n} must be even to pair-merge")
    if not 0.0 <= merge_ratio <= 1.0:
        raise ValueError(
            f"merge_ratio must be in [0, 1], got {merge_ratio!r} "
            "(>1 would silently drop unmerged tokens, <0 silently no-op)")
    p = n // 2
    k = int(p * merge_ratio)
    if k == 0:
        return x
    x0, x1 = x[:, 0::2], x[:, 1::2]  # [B, P, D]

    def _norm(t):
        return t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + eps)

    sim = (_norm(x0) * _norm(x1)).sum(-1)  # [B, P]
    order = torch.argsort(-sim, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    merge = rank < k  # [B, P]

    slot_a = torch.where(merge[..., None], 0.5 * (x0 + x1), x0)  # always valid
    tokens = torch.stack([slot_a, x1], dim=2).reshape(b, n, d)
    valid = torch.stack([torch.ones_like(merge), ~merge], dim=2).reshape(b, n)
    # stable compaction: valid tokens first, curve order kept
    perm = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    compacted = torch.gather(tokens, 1, perm[..., None].expand(b, n, d))
    return compacted[:, : n - k]
