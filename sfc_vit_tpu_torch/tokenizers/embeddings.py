"""Image -> token sequence: NHWC patchify, the static curve gather and the
fused gather + projection.

Counterpart of ``patchify``, ``curve_gather`` and ``FusedCurveProjection``
in ``sfc_vit_tpu/tokenizers/embeddings.py``.  Images stay NHWC
(``[B, H, W, C]``) and patch features are ordered (row, col, channel),
the JAX package's layout, so a Dense kernel ``[p*p*C, D]`` carries over
unchanged.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.gather_project import gather_project
from ..utils.initializers import lecun_normal

__all__ = ["patchify", "curve_gather", "FusedCurveProjection"]


class FusedCurveProjection(nn.Module):
    """Dense-compatible projection fused with the curve gather (kernel #14
    on the card, :func:`~sfc_vit_tpu_torch.ops.gather_project.gather_project`).

    Its parameters are named and shaped exactly like a Dense layer's
    (``kernel`` [group * in_dim, features], lecun normal; ``bias``
    [features], zeros), so a tokenizer switches between the gather +
    Dense path and this one without changing its checkpoint.  ``lut`` has
    ``n_tokens * group`` entries, each checked to lie in ``[0, n_rows)``;
    the input rows are gathered, grouped and projected in one kernel.
    ``dtype`` None computes in the input's dtype, as in JAX.
    """

    def __init__(self, in_dim: int, features: int, lut: Sequence[int], n_rows: int,
                 group: int = 1, dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__()
        lut = np.asarray(lut, dtype=np.int64)
        if lut.ndim != 1 or lut.size % group or lut.min() < 0 or lut.max() >= n_rows:
            raise ValueError(f"FusedCurveProjection: a LUT of {lut.size} entries in "
                             f"[{lut.min()}, {lut.max()}] for {n_rows} rows, group {group}")
        self.group, self.dtype = group, dtype
        self.kernel = nn.Parameter(lecun_normal(group * in_dim, features, generator))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("lut", torch.from_numpy(lut.astype(np.int32)), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        return gather_project(x.to(dt), self.lut, self.kernel.to(dt), self.bias.to(dt),
                              group=self.group)


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)*(W/p), p*p*C] row-major patches."""
    b, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def curve_gather(tokens: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Reorder tokens [B, N, D] along axis 1 by a static LUT (int64)."""
    return tokens.index_select(1, lut)
