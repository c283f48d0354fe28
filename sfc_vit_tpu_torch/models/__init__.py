"""The pre-norm ViT family (``SimpleViT``, ``CurveViT``), family A's
``VisionTransformer``, ``VisionTransformer1D`` and
``HierarchicalVisionTransformer1D`` and their building blocks and tables."""

from .layers import (
    FactorisedLinear,
    MixerBlock,
    MultiLayerPredictor,
    TokenAggregator,
    TorchMultiHeadAttention,
    TorchTransformerEncoderLayer,
    TransformerSeqEncoder,
    family_a_route,
)
from .posemb import build_posemb, gfpe, sincos_1d
from .simple_vit import (
    CurvePatchEmbedding,
    CurveViT,
    HilbertViT,
    PreNormTransformer,
    SimpleViT,
    curve_pair_pool,
    layer_route,
)
from .vit import HierarchicalVisionTransformer1D, VisionTransformer, VisionTransformer1D

__all__ = [
    "CurvePatchEmbedding",
    "CurveViT",
    "FactorisedLinear",
    "HierarchicalVisionTransformer1D",
    "HilbertViT",
    "MixerBlock",
    "MultiLayerPredictor",
    "PreNormTransformer",
    "SimpleViT",
    "TokenAggregator",
    "TorchMultiHeadAttention",
    "TorchTransformerEncoderLayer",
    "TransformerSeqEncoder",
    "VisionTransformer",
    "VisionTransformer1D",
    "build_posemb",
    "curve_pair_pool",
    "family_a_route",
    "gfpe",
    "layer_route",
    "sincos_1d",
]
