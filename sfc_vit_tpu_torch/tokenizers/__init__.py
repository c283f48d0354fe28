"""Patchify and curve gather (the ``CurvePatchEmbedding`` front end), the
fused gather + projection, the 2-D and 1-D curve tokenizers, the
hierarchical curve tokenizer and the reference's tokenizer names."""

from . import compat
from .embeddings import (
    ConvPatchEmbedding,
    FusedCurveProjection,
    PixelCurveEmbedding1D,
    curve_gather,
    patchify,
)
from .hierarchical import GroupedCurveEmbedding1D, HierarchicalCurveEmbedding

__all__ = ["ConvPatchEmbedding", "FusedCurveProjection", "GroupedCurveEmbedding1D",
           "HierarchicalCurveEmbedding", "PixelCurveEmbedding1D", "compat",
           "curve_gather", "patchify"]
