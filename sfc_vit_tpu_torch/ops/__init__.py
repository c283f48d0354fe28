"""Hand-written Hopper kernels with their plain PyTorch versions."""

from .fused_attention_block import attention_block_ref, fused_attention_block
from .fused_mlp import fused_mlp_block, mlp_block_ref
from .kernel_utils import NEG_INF, ln_fp32, round_up

__all__ = [
    "NEG_INF",
    "attention_block_ref",
    "fused_attention_block",
    "fused_mlp_block",
    "ln_fp32",
    "mlp_block_ref",
    "round_up",
]
