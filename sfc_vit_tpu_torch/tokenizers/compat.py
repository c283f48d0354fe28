"""The reference's tokenizer names, each a factory of one of the port's
three tokenizer modules (counterpart of ``sfc_vit_tpu/tokenizers/compat.py``).

The reference ships fifteen near-clone tokenizer classes; here each name
builds :class:`~sfc_vit_tpu_torch.tokenizers.embeddings.ConvPatchEmbedding`
(the 2-D family), :class:`~sfc_vit_tpu_torch.tokenizers.embeddings.PixelCurveEmbedding1D`
(the 1-D family) or
:class:`~sfc_vit_tpu_torch.tokenizers.hierarchical.HierarchicalCurveEmbedding`
(the multiscale family) for its curve.  The signatures are the
reference constructors'; ``in_channels`` becomes the module's
``channels``, which a PyTorch module needs to create its parameters (flax
infers it from the first input).
"""

from __future__ import annotations

from typing import Sequence

from .embeddings import ConvPatchEmbedding, PixelCurveEmbedding1D
from .hierarchical import GroupedCurveEmbedding1D, HierarchicalCurveEmbedding

__all__ = [
    "ZigzagEmbedding",
    "HilbertEmbedding",
    "RandomEmbedding",
    "RasterScan1DEmbedding",
    "HilbertEmbedding1D",
    "PeanoEmbedding1D",
    "MooreEmbedding1D",
    "MortonEmbedding1D",
    "OnionEmbedding1D",
    "SFCEmbedding1D",
    "HierarchicalHilbertEmbedding",
    "HierarchicalPeanoEmbedding",
    "HierarchicalMooreEmbedding",
    "HierarchicalMortonEmbedding",
    "HierarchicalOnionEmbedding",
    "HierarchicalRasterScanEmbedding",
    "HierarchicalZigzagEmbedding",
]


def _conv2d(curve: str):
    def make(img_size: int, patch_size: int, in_channels: int = 3,
             embed_dim: int = 256, **kw) -> ConvPatchEmbedding:
        return ConvPatchEmbedding(img_size, patch_size, embed_dim, curve=curve,
                                  channels=in_channels, **kw)
    return make


def _pixel1d(curve: str):
    def make(img_size: int, patch_size: int, in_channels: int = 3,
             embed_dim: int = 256, **kw) -> PixelCurveEmbedding1D:
        return PixelCurveEmbedding1D(img_size, patch_size, embed_dim, curve=curve,
                                     channels=in_channels, **kw)
    return make


def _hier(curve: str):
    def make(img_size: int, in_channels: int = 3,
             patch_size_list: Sequence[int] = (16, 4, 1),
             embed_dim: int = 256, **kw) -> HierarchicalCurveEmbedding:
        return HierarchicalCurveEmbedding(img_size, tuple(patch_size_list), embed_dim,
                                          curve=curve, channels=in_channels, **kw)
    return make


# --- 2D family (``src/tokenizers/_2D``) ---
ZigzagEmbedding = _conv2d("raster")
HilbertEmbedding = _conv2d("hilbert")
RandomEmbedding = _conv2d("random")

# --- 1D family (``src/tokenizers/_1D``) ---
RasterScan1DEmbedding = _pixel1d("raster")
HilbertEmbedding1D = _pixel1d("hilbert")
PeanoEmbedding1D = _pixel1d("peano")
MooreEmbedding1D = _pixel1d("moore")
MortonEmbedding1D = _pixel1d("morton")
OnionEmbedding1D = _pixel1d("onion")

# --- multiscale family (``src/tokenizers/multiscale``) ---
SFCEmbedding1D = GroupedCurveEmbedding1D
HierarchicalHilbertEmbedding = _hier("hilbert")
HierarchicalPeanoEmbedding = _hier("peano")
HierarchicalMooreEmbedding = _hier("moore")
HierarchicalMortonEmbedding = _hier("morton")
HierarchicalOnionEmbedding = _hier("onion")
HierarchicalRasterScanEmbedding = _hier("raster")
# The reference's multi_vanilla.py is broken (NameError); 'raster' is the
# working conv-free baseline it intended, as in the JAX package.
HierarchicalZigzagEmbedding = _hier("raster")
