"""Patchify and curve gather (the ``CurvePatchEmbedding`` front end) and
the hierarchical curve tokenizer."""

from .embeddings import curve_gather, patchify
from .hierarchical import GroupedCurveEmbedding1D, HierarchicalCurveEmbedding

__all__ = ["GroupedCurveEmbedding1D", "HierarchicalCurveEmbedding",
           "curve_gather", "patchify"]
