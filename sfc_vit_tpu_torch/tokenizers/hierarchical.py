"""Hierarchical (multiscale) curve tokenizers.

Counterpart of ``sfc_vit_tpu/tokenizers/hierarchical.py``: per pyramid
level ``l`` the image is cut into ``2^l``-pixel pre-patches, reordered
along the curve over the pre-patch grid, grouped ``g_l`` curve-consecutive
pre-patches per token and linearly projected; coarser levels are
linearly upsampled to the finest token count, concatenated on features
and fused by one Dense layer.  Parameter names follow the flax tree
(``level_{i}/proj``, ``fusion``), Dense kernels ``[in, out]``.

With ``fused=True`` and a curve other than ``'raster'`` each level's
gather, grouping and projection are one
:class:`~sfc_vit_tpu_torch.tokenizers.embeddings.FusedCurveProjection`
(kernel #14 on the card) under the same ``proj`` parameters, as in JAX.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..curves import flat_lut
from ..models.layers import Dense
from .embeddings import FusedCurveProjection, curve_gather, patchify

__all__ = ["GroupedCurveEmbedding1D", "HierarchicalCurveEmbedding",
           "_linear_upsample_tokens"]


class GroupedCurveEmbedding1D(nn.Module):
    """One pyramid level: pre-patchify, curve reorder, group, project.

    ``curve='raster'`` applies no reorder; ``fused`` (any other curve)
    makes the reorder, grouping and projection one
    :class:`FusedCurveProjection`.  Input NHWC [B, H, W, C]."""

    def __init__(self, img_size: int, pre_patch_size: int,
                 group_patch_size: int, embed_dim: int, curve: str = "raster",
                 fused: bool = False, dtype: Optional[torch.dtype] = None,
                 channels: int = 3, generator=None):
        super().__init__()
        if img_size % pre_patch_size:
            raise ValueError("Image size must be divisible by pre_patch_size")
        self.pre_patch_size = pre_patch_size
        self.group_patch_size = group_patch_size
        self.grid_size = img_size // pre_patch_size
        self.n_final_patches = self.grid_size ** 2 // group_patch_size
        k = pre_patch_size ** 2 * channels
        self.fused = fused and curve != "raster"
        lut = None if curve == "raster" else flat_lut(curve, self.grid_size)
        if self.fused:
            self.register_buffer("lut", None, persistent=False)
            self.proj = FusedCurveProjection(k, embed_dim, lut, self.grid_size ** 2,
                                             group_patch_size, dtype, generator)
            return
        self.register_buffer(
            "lut", None if lut is None else torch.from_numpy(lut.astype(np.int64)),
            persistent=False)
        self.proj = Dense(group_patch_size * k, embed_dim, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = patchify(x, self.pre_patch_size)  # [B, grid^2, p*p*C]
        if self.fused:
            return self.proj(x)
        if self.lut is not None:
            x = curve_gather(x, self.lut)
        # group g curve-consecutive pre-patches per token
        x = x.reshape(x.shape[0], self.n_final_patches, -1)
        return self.proj(x)


def _linear_upsample_tokens(x: torch.Tensor, target_len: int) -> torch.Tensor:
    """Linear interpolation along the token axis with half-pixel centers:
    ``F.interpolate(mode='linear', align_corners=False)``, which JAX's
    ``jax.image.resize(..., 'linear')`` matches when upsampling."""
    if x.shape[1] == target_len:
        return x
    return F.interpolate(x.transpose(1, 2), size=target_len, mode="linear",
                         align_corners=False).transpose(1, 2)


class HierarchicalCurveEmbedding(nn.Module):
    """Multi-scale curve pyramid tokenizer.

    ``patch_list`` holds the exact per-level token counts
    ``(img / 2^l)^2 // g_l``; ``n_patches`` is the finest level's,
    ``out_dim = embed_dim * depth`` the fused width.  ``return_levels``
    returns the per-level token lists without upsample or fusion.
    """

    def __init__(self, img_size: int, patch_size_list: Sequence[int],
                 embed_dim: int, curve: str = "raster",
                 return_levels: bool = False, fused: bool = False,
                 dtype: Optional[torch.dtype] = None, channels: int = 3,
                 generator=None):
        super().__init__()
        self.img_size = img_size
        self.patch_size_list = tuple(patch_size_list)
        self.embed_dim = embed_dim
        self.curve = curve
        self.return_levels = return_levels
        for i, (pre, g) in enumerate(zip(self.pre_patch_sizes, self.patch_size_list)):
            self.add_module(f"level_{i}", GroupedCurveEmbedding1D(
                img_size, pre, g, embed_dim, curve, fused=fused, dtype=dtype,
                channels=channels, generator=generator))
        if not return_levels:
            self.fusion = Dense(self.out_dim, self.out_dim, dtype=dtype,
                                generator=generator)

    @property
    def pre_patch_sizes(self) -> List[int]:
        return [2 ** i for i in range(len(self.patch_size_list))]

    @property
    def patch_list(self) -> List[int]:
        return [(self.img_size // pre) ** 2 // g
                for pre, g in zip(self.pre_patch_sizes, self.patch_size_list)]

    @property
    def depth(self) -> int:
        return len(self.patch_size_list)

    @property
    def n_patches(self) -> int:
        return self.patch_list[0]

    @property
    def out_dim(self) -> int:
        """Fused embedding dim (the reference exposes this as embed_dim)."""
        return self.embed_dim * self.depth

    def forward(self, x: torch.Tensor) -> Union[torch.Tensor, List[torch.Tensor]]:
        levels = [getattr(self, f"level_{i}")(x) for i in range(self.depth)]
        if self.return_levels:
            return levels
        n_tokens = self.patch_list[0]
        levels = [levels[0]] + [_linear_upsample_tokens(t, n_tokens)
                                for t in levels[1:]]
        return self.fusion(torch.cat(levels, dim=-1))
