"""Patchify and curve gather (the ``CurvePatchEmbedding`` front end), the
fused gather + projection and the hierarchical curve tokenizer."""

from .embeddings import FusedCurveProjection, curve_gather, patchify
from .hierarchical import GroupedCurveEmbedding1D, HierarchicalCurveEmbedding

__all__ = ["FusedCurveProjection", "GroupedCurveEmbedding1D",
           "HierarchicalCurveEmbedding", "curve_gather", "patchify"]
