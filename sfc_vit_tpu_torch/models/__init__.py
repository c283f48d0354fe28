"""The pre-norm ViT family (``SimpleViT``, ``CurveViT``) and its tables."""

from .posemb import gfpe, sincos_1d
from .simple_vit import (
    CurvePatchEmbedding,
    CurveViT,
    HilbertViT,
    PreNormTransformer,
    SimpleViT,
)

__all__ = [
    "CurvePatchEmbedding",
    "CurveViT",
    "HilbertViT",
    "PreNormTransformer",
    "SimpleViT",
    "gfpe",
    "sincos_1d",
]
