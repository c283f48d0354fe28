"""Image -> token sequence: NHWC patchify, the static curve gather, the
fused gather + projection and the 2-D and 1-D curve tokenizers.

Counterpart of ``sfc_vit_tpu/tokenizers/embeddings.py``.  Images stay NHWC
(``[B, H, W, C]``) and patch features are ordered (row, col, channel),
the JAX package's layout, so a Dense kernel ``[p*p*C, D]`` carries over
unchanged.

:class:`ConvPatchEmbedding` (the 2-D family: conv patchify, then the
curve's reorder of the patch tokens) keeps flax ``nn.Conv``'s parameters,
``proj/kernel`` [p, p, C, D] and ``proj/bias``, and computes the
stride-p convolution as what it is, ``patchify(x, p) @ kernel.reshape(p*p*C,
D) + bias``: no ``F.conv2d``, whose float32 runs through cuDNN in TF32 by
default, and no [D, C, p, p] layout to convert.  :class:`PixelCurveEmbedding1D`
(the 1-D family) gathers pixels along the curve, chunks them into runs of
``patch_size`` and applies a Dense ``proj``.  Each has the fused form JAX
gives it (kernel #14 on the card, the same parameters), and the 2-D family
the ``'random'`` curve: a fresh permutation of the tokens per step, from
:func:`~sfc_vit_tpu_torch.models.layers.curve_permutation`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..curves import flat_lut_2d, pixel_lut
from ..models.layers import Dense, _compute_dtype, curve_permutation
from ..ops.gather_project import gather_project
from ..utils.initializers import lecun_normal
from .patches import curve_gather, patchify

__all__ = ["patchify", "curve_gather", "FusedCurveProjection", "ConvPatchEmbedding",
           "PixelCurveEmbedding1D"]


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


class _ConvProjection(nn.Module):
    """flax ``nn.Conv(features, (p, p), strides=p, padding='VALID')`` over an
    NHWC image, as the product of its row-major patches with the kernel:
    ``kernel`` [p, p, C, D] (lecun normal over p*p*C, as flax draws a conv
    kernel) and a zero ``bias`` [D].  ``dtype`` None promotes the input with
    the parameters, as flax does."""

    def __init__(self, patch: int, channels: int, features: int,
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__()
        self.patch, self.dtype = patch, dtype
        k = patch * patch * channels
        self.kernel = nn.Parameter(
            lecun_normal(k, features, generator).reshape(patch, patch, channels, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def _matrix(self, dt: torch.dtype) -> torch.Tensor:
        return self.kernel.reshape(-1, self.kernel.shape[-1]).to(dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> the row-major patch tokens [B, (H/p)*(W/p), D]."""
        dt = _compute_dtype(self.dtype, x, self.kernel)
        return patchify(x.to(dt), self.patch) @ self._matrix(dt) + self.bias.to(dt)


class _FusedConvProjection(_ConvProjection):
    """The conv's parameters applied as one fused gather + projection over
    the patches (kernel #14 on the card): ``patchify(x, p)`` gathered along
    ``lut`` and multiplied by the kernel as a [p*p*C, D] matrix, the bias
    added to the fp32 sum.  ``dtype`` None computes in the input's dtype,
    as JAX's ``_FusedConvProjection`` does."""

    def __init__(self, patch: int, channels: int, features: int, lut: Sequence[int],
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__(patch, channels, features, dtype, generator)
        self.register_buffer("lut", torch.from_numpy(np.asarray(lut, dtype=np.int32)),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        return gather_project(patchify(x, self.patch).to(dt), self.lut, self._matrix(dt),
                              self.bias.to(dt))


class ConvPatchEmbedding(nn.Module):
    """Conv patchify, then the curve's reorder of the patch tokens: the 2-D
    family (JAX ``ConvPatchEmbedding``; the reference's ``ZigzagEmbedding``
    for ``'raster'``, ``HilbertEmbedding`` and ``RandomEmbedding``).

    ``curve`` is ``'raster'`` (no reorder), a curve of the registry (the
    tokens gathered along ``flat_lut_2d``, the reference's conv-patchify
    convention) or ``'random'`` (a fresh permutation per step, from
    :func:`~sfc_vit_tpu_torch.models.layers.curve_permutation`).
    ``fused`` (any curve but ``'random'``; ``'raster'`` through the LUT
    ``arange(n)``) makes the patch projection and the reorder one
    :class:`_FusedConvProjection` under the same ``proj`` parameters.
    Input NHWC [B, H, W, C] with C = ``channels``; output [B, N, D].
    """

    def __init__(self, img_size: int, patch_size: int, embed_dim: int,
                 curve: str = "raster", fused: bool = False,
                 dtype: Optional[torch.dtype] = None, channels: int = 3, generator=None):
        super().__init__()
        self.img_size, self.patch_size, self.embed_dim = img_size, patch_size, embed_dim
        self.curve = curve
        self.fused = fused and curve != "random"
        self.grid_size = img_size // patch_size
        self.n_patches = self.grid_size ** 2
        lut = None
        if curve not in ("raster", "random"):
            lut = flat_lut_2d(curve, self.grid_size)
        if self.fused:
            self.register_buffer("lut", None, persistent=False)
            self.proj = _FusedConvProjection(
                patch_size, channels, embed_dim,
                np.arange(self.n_patches) if lut is None else lut, dtype, generator)
            return
        self.register_buffer(
            "lut", None if lut is None else torch.from_numpy(lut.astype(np.int64)),
            persistent=False)
        self.proj = _ConvProjection(patch_size, channels, embed_dim, dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x)
        if self.fused:
            return x
        if self.curve == "random":
            return curve_gather(x, curve_permutation(self.n_patches, x.device))
        return x if self.lut is None else curve_gather(x, self.lut)


class PixelCurveEmbedding1D(nn.Module):
    """Pixels gathered along the curve, chunked into 1-D runs of
    ``patch_size`` pixels and projected by a Dense ``proj`` ([patch_size *
    C, D]): the 1-D family (JAX ``PixelCurveEmbedding1D``; the reference's
    ``RasterScan1DEmbedding`` for ``'raster'``, no gather, and its Hilbert,
    Peano, Moore, Morton and Onion 1-D tokenizers).

    N = H * W / ``patch_size`` tokens.  ``fused`` with a curve other than
    ``'raster'`` makes the gather, the chunking and the projection one
    :class:`FusedCurveProjection` (group ``patch_size``) under the same
    ``proj`` parameters.  ``grid_size`` is ``img_size``: the curve runs over
    the pixel lattice, so a positional table takes one pixel per token.
    """

    def __init__(self, img_size: int, patch_size: int, embed_dim: int,
                 curve: str = "raster", fused: bool = False,
                 dtype: Optional[torch.dtype] = None, channels: int = 3, generator=None):
        super().__init__()
        n_pixels = img_size * img_size
        if n_pixels % patch_size:
            raise ValueError(f"Image must be divisible into 1D patches: {n_pixels} "
                             f"pixels, patch_size {patch_size}")
        self.img_size, self.patch_size, self.embed_dim = img_size, patch_size, embed_dim
        self.curve = curve
        self.grid_size = img_size
        self.n_patches = n_pixels // patch_size
        self.fused = fused and curve != "raster"
        lut = None if curve == "raster" else pixel_lut(curve, img_size, img_size)
        if self.fused:
            self.register_buffer("lut", None, persistent=False)
            self.proj = FusedCurveProjection(channels, embed_dim, lut, n_pixels, patch_size,
                                             dtype, generator)
            return
        self.register_buffer(
            "lut", None if lut is None else torch.from_numpy(lut.astype(np.int64)),
            persistent=False)
        self.proj = Dense(patch_size * channels, embed_dim, dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x.reshape(b, h * w, c)  # row-major pixel sequence
        if self.fused:
            return self.proj(x)
        if self.lut is not None:
            x = curve_gather(x, self.lut)
        # curve-consecutive pixels chunked into tokens, features (pixel, channel)
        return self.proj(x.reshape(b, self.n_patches, self.patch_size * c))
