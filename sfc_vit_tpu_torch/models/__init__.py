"""The pre-norm ViT family (``SimpleViT``, ``CurveViT``), family A's
``VisionTransformer1D`` and their building blocks and tables."""

from .layers import (
    FactorisedLinear,
    MixerBlock,
    MultiLayerPredictor,
    TokenAggregator,
    TorchMultiHeadAttention,
    TorchTransformerEncoderLayer,
    TransformerSeqEncoder,
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
from .vit import VisionTransformer1D

__all__ = [
    "CurvePatchEmbedding",
    "CurveViT",
    "FactorisedLinear",
    "HilbertViT",
    "MixerBlock",
    "MultiLayerPredictor",
    "PreNormTransformer",
    "SimpleViT",
    "TokenAggregator",
    "TorchMultiHeadAttention",
    "TorchTransformerEncoderLayer",
    "TransformerSeqEncoder",
    "VisionTransformer1D",
    "build_posemb",
    "curve_pair_pool",
    "gfpe",
    "layer_route",
    "sincos_1d",
]
