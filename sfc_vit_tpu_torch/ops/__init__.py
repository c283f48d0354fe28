"""Hand-written Hopper kernels with their plain PyTorch versions, and the
attention dispatch."""

from .attention import (
    attention_with_weights,
    dot_product_attention_xla,
    multi_head_attention,
    packed_qkv_attention,
    packed_route,
)
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
    fused_postnorm_tail,
    mlp_block_bwd,
    mlp_block_bwd_ref,
    mlp_block_ref,
    mlp_block_train_fwd,
    postnorm_tail_bwd,
    postnorm_tail_bwd_ref,
    postnorm_tail_kernel_ref,
    postnorm_tail_ref,
    postnorm_tail_train_fwd,
)
# ``flash_attention`` (the function) stays in its module of the same name,
# so that ``sfc_vit_tpu_torch.ops.flash_attention`` names the module.
from .flash_attention import (
    flash_attention_with_lse,
    flash_dkv_ref,
    flash_dq_ref,
    flash_fused_bwd_ref,
    flash_fwd_ref,
    packed_flash_attention,
)
from .fused_torch_attention import (
    fused_torch_mha,
    torch_mha_bwd,
    torch_mha_bwd_ref,
    torch_mha_fwd_ref,
    torch_mha_train,
    torch_mha_train_fwd,
)
# ``gather_project`` (the function) stays in its module of the same name too.
from .gather_project import gather_project_ref, gather_project_xla
from .kernel_utils import NEG_INF, ln_bwd_fp32, ln_fp32, round_up
from .local_attention import (
    local_block_attention,
    local_block_attention_ref,
    local_block_attention_xla,
    local_bwd_ref,
    local_fwd_ref,
)
from .token_merge import curve_pair_merge_topk

__all__ = [
    "NEG_INF",
    "attention_block_bwd",
    "attention_block_bwd_ref",
    "attention_block_ref",
    "attention_block_train_fwd",
    "attention_bwd_ref",
    "attention_fwd_ref",
    "attention_with_weights",
    "curve_pair_merge_topk",
    "dot_product_attention_xla",
    "flash_attention_with_lse",
    "flash_dkv_ref",
    "flash_dq_ref",
    "flash_fused_bwd_ref",
    "flash_fwd_ref",
    "fused_attention_block",
    "fused_mlp_block",
    "fused_postnorm_tail",
    "fused_torch_mha",
    "gather_project_ref",
    "gather_project_xla",
    "ln_bwd_fp32",
    "ln_fp32",
    "local_block_attention",
    "local_block_attention_ref",
    "local_block_attention_xla",
    "local_bwd_ref",
    "local_fwd_ref",
    "mlp_block_bwd",
    "mlp_block_bwd_ref",
    "mlp_block_ref",
    "mlp_block_train_fwd",
    "multi_head_attention",
    "packed_flash_attention",
    "packed_qkv_attention",
    "packed_route",
    "postnorm_tail_bwd",
    "postnorm_tail_bwd_ref",
    "postnorm_tail_kernel_ref",
    "postnorm_tail_ref",
    "postnorm_tail_train_fwd",
    "round_up",
    "torch_mha_bwd",
    "torch_mha_bwd_ref",
    "torch_mha_fwd_ref",
    "torch_mha_train",
    "torch_mha_train_fwd",
]
