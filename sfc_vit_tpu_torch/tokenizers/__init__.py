"""Patchify and curve gather (the ``CurvePatchEmbedding`` front end)."""

from .embeddings import curve_gather, patchify

__all__ = ["curve_gather", "patchify"]
