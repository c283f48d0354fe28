"""NHWC patchify and the static curve gather, the two steps every curve
tokenizer shares (counterparts of ``patchify`` and ``curve_gather`` in
``sfc_vit_tpu/tokenizers/embeddings.py``).  A module of their own, with
no import of the models, so that ``models.simple_vit`` and the tokenizers,
which build on ``models.layers``, import each other in either order.
"""

from __future__ import annotations

import torch

__all__ = ["patchify", "curve_gather"]


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)*(W/p), p*p*C] row-major patches."""
    b, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def curve_gather(tokens: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Reorder tokens [B, N, D] along axis 1 by a static LUT (int64)."""
    return tokens.index_select(1, lut)
