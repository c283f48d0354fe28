"""Hand-written Hopper kernels with their plain PyTorch versions."""

from .fused_attention_block import (
    attention_block_bwd,
    attention_block_bwd_ref,
    attention_block_ref,
    attention_block_train_fwd,
    attention_bwd_ref,
    attention_fwd_ref,
    fused_attention_block,
)
from .fused_mlp import (
    fused_mlp_block,
    mlp_block_bwd,
    mlp_block_bwd_ref,
    mlp_block_ref,
    mlp_block_train_fwd,
)
from .kernel_utils import NEG_INF, ln_bwd_fp32, ln_fp32, round_up

__all__ = [
    "NEG_INF",
    "attention_block_bwd",
    "attention_block_bwd_ref",
    "attention_block_ref",
    "attention_block_train_fwd",
    "attention_bwd_ref",
    "attention_fwd_ref",
    "fused_attention_block",
    "fused_mlp_block",
    "ln_bwd_fp32",
    "ln_fp32",
    "mlp_block_bwd",
    "mlp_block_bwd_ref",
    "mlp_block_ref",
    "mlp_block_train_fwd",
    "round_up",
]
