"""The pre-norm ViT family in PyTorch: ``SimpleViT`` and ``CurveViT``.

Counterpart of ``sfc_vit_tpu/models/simple_vit.py``.  Parameter names
follow the flax tree (``to_patch_embedding/{norm_in,proj,norm_out}`` in
``CurveViT``, the same three at the top of ``SimpleViT``,
``transformer/attn_{i}/{norm,to_qkv,to_out}``,
``transformer/ff_{i}/{norm,fc1,fc2}``, ``transformer/norm``,
``linear_head``) so ``utils.convert`` maps one onto the other.  The
attention and MLP blocks hold their Dense kernels ``[in, out]`` as the
flax holders do, so the fused kernels take them without a transpose;
``proj`` and ``linear_head`` are ``nn.Linear`` (``[out, in]``).

Every encoder layer runs two fused blocks,
:func:`~sfc_vit_tpu_torch.ops.fused_attention_block` and
:func:`~sfc_vit_tpu_torch.ops.fused_mlp_block`: the hand-written kernels
for a CUDA input, their plain versions for a CPU input.  The embedding,
final LayerNorm, mean pool and head are plain PyTorch.

Unlike the JAX stack, :class:`PreNormTransformer` never pads the token
axis (196 -> 208 there, for Mosaic's sublane tiling): the Hopper kernels
mask ragged edges themselves, and every op is row-local apart from the
attention, which sees exactly the real keys.

``dtype`` is the compute dtype, as in flax: inputs and weights are cast
to it at use; ``None`` computes in the input's dtype.  Parameters are
created in float32, initialised from ``generator`` with flax's defaults
(lecun-normal Dense kernels, zero biases, unit LayerNorm scales) and then
moved to ``device``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sfc_vit_tpu.curves import flat_lut

from ..ops.fused_attention_block import fused_attention_block
from ..ops.fused_mlp import fused_mlp_block
from ..ops.kernel_utils import ln_fp32
from ..tokenizers.embeddings import curve_gather, patchify
from .posemb import gfpe, sincos_1d

__all__ = ["CurvePatchEmbedding", "PreNormTransformer", "SimpleViT",
           "CurveViT", "HilbertViT"]


def _lecun_normal(fan_in: int, fan_out: int, generator) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal at +-2 std, std corrected
    so the variance is 1 / fan_in; shape ``[fan_in, fan_out]``."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    w = torch.empty(fan_in, fan_out)
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def _linear(in_dim: int, out_dim: int, generator) -> nn.Linear:
    lin = nn.Linear(in_dim, out_dim, device="meta")
    lin.weight = nn.Parameter(_lecun_normal(in_dim, out_dim, generator).T.contiguous())
    lin.bias = nn.Parameter(torch.zeros(out_dim))
    return lin


def _dense(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """flax ``nn.Dense(dtype=x.dtype)``: weights cast to the compute dtype."""
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


class LayerNorm(nn.Module):
    """LayerNorm with flax's parameter names (``scale``, ``bias``) and
    :func:`~sfc_vit_tpu_torch.ops.ln_fp32` arithmetic."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ln_fp32(x, self.scale, self.bias, 1e-5)


class _DenseParams(nn.Module):
    """Param holder with ``nn.Dense``'s tree: ``kernel`` [in, out] and an
    optional ``bias``, read by the fused kernels as stored."""

    def __init__(self, in_dim: int, features: int, use_bias: bool = True,
                 generator=None):
        super().__init__()
        self.kernel = nn.Parameter(_lecun_normal(in_dim, features, generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None


class CurvePatchEmbedding(nn.Module):
    """Patchify -> curve gather -> LN -> Linear -> LN (NHWC input)."""

    def __init__(self, image_size: int, patch_size: int, dim: int,
                 channels: int = 3, curve: str = "hilbert",
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(
                f"image size {image_size} not divisible by patch {patch_size}")
        self.patch_size = patch_size
        self.grid_size = image_size // patch_size
        self.n_patches = self.grid_size ** 2
        self.dtype = dtype
        g = self.grid_size
        if curve == "raster":
            lut = None
        else:
            lut_np = flat_lut(curve, g)
            if sorted(lut_np.tolist()) != list(range(g * g)):
                raise ValueError(f"{curve} LUT on grid {g} is not a permutation")
            lut = torch.from_numpy(lut_np.astype(np.int64))
        self.register_buffer("lut", lut, persistent=False)
        self.norm_in = LayerNorm(patch_size * patch_size * channels)
        self.proj = _linear(patch_size * patch_size * channels, dim, generator)
        self.norm_out = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        x = patchify(x, self.patch_size)
        if self.lut is not None:
            x = curve_gather(x, self.lut)
        x = _dense(self.norm_in(x).to(dt), self.proj)
        return self.norm_out(x)


class _PreNormAttention(nn.Module):
    """LN -> QKV (no bias) -> softmax attention -> out proj (no bias),
    plus the residual, as one :func:`fused_attention_block` call."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dtype = dtype
        self.norm = LayerNorm(dim)
        self.to_qkv = _DenseParams(dim, 3 * inner, use_bias=False,
                                   generator=generator)
        self.to_out = _DenseParams(inner, dim, use_bias=False,
                                   generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        return fused_attention_block(
            x.to(dt), self.norm.scale, self.norm.bias,
            self.to_qkv.kernel.to(dt), self.to_out.kernel.to(dt), self.heads,
        )


class _FeedForward(nn.Module):
    """LN -> Linear -> GELU (exact) -> Linear, plus the residual, as one
    :func:`fused_mlp_block` call."""

    def __init__(self, dim: int, hidden_dim: int,
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.norm = LayerNorm(dim)
        self.fc1 = _DenseParams(dim, hidden_dim, generator=generator)
        self.fc2 = _DenseParams(hidden_dim, dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        return fused_mlp_block(
            x.to(dt), self.norm.scale, self.norm.bias,
            self.fc1.kernel.to(dt), self.fc1.bias.to(dt),
            self.fc2.kernel.to(dt), self.fc2.bias.to(dt),
            eps=1e-5, activation="gelu", residual=True,
        )


class PreNormTransformer(nn.Module):
    """Residual pre-norm stack with a final LayerNorm.

    Every layer takes the fused attention block (the JAX stack's
    ``attn_impl='auto'``); other attention implementations, per-layer
    schedules, pooling, merging and remat are later ROADMAP items.
    """

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dtype: Optional[torch.dtype] = None,
                 generator=None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"attn_{i}", _PreNormAttention(
                dim, heads, dim_head, dtype, generator))
            self.add_module(f"ff_{i}", _FeedForward(
                dim, mlp_dim, dtype, generator))
        self.norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"attn_{i}")(x)  # residual added in the block
            x = getattr(self, f"ff_{i}")(x)
        return self.norm(x)


def _classify(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Tokens -> + positional table -> pre-norm stack -> mean pool ->
    linear head (the part both models share)."""
    x = x + model.pos_embedding.to(x.dtype)
    x = model.transformer(x)
    return _dense(x.mean(dim=1), model.linear_head)


class SimpleViT(nn.Module):
    """Raster baseline: patchify -> LN/Linear/LN -> + sincos 1-D table ->
    pre-norm stack -> mean pool -> linear head."""

    def __init__(self, image_size: int, patch_size: int, num_classes: int,
                 dim: int, depth: int, heads: int, mlp_dim: int,
                 dim_head: int = 64, channels: int = 3,
                 dtype: Optional[torch.dtype] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(
                f"image size {image_size} not divisible by patch {patch_size}")
        self.patch_size = patch_size
        self.dtype = dtype
        k = patch_size * patch_size * channels
        self.norm_in = LayerNorm(k)
        self.proj = _linear(k, dim, generator)
        self.norm_out = LayerNorm(dim)
        n = (image_size // patch_size) ** 2
        self.register_buffer("pos_embedding",
                             torch.from_numpy(sincos_1d(n, dim)),
                             persistent=False)
        self.transformer = PreNormTransformer(
            dim, depth, heads, dim_head, mlp_dim, dtype, generator)
        self.linear_head = _linear(dim, num_classes, generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits ``[B, num_classes]`` for NHWC images ``[B, H, W, C]``."""
        dt = self.dtype or x.dtype
        x = patchify(x, self.patch_size)
        x = self.norm_out(_dense(self.norm_in(x).to(dt), self.proj))
        return _classify(self, x)


class CurveViT(nn.Module):
    """Curve-ordered SimpleViT with the GFPE positional encoding (T=4,
    h=3.0) over the curve's flat grid indices."""

    def __init__(self, image_size: int, patch_size: int, num_classes: int,
                 dim: int, depth: int, heads: int, mlp_dim: int,
                 dim_head: int = 64, channels: int = 3, curve: str = "hilbert",
                 temperature: float = 4.0, h_param: float = 3.0,
                 dtype: Optional[torch.dtype] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.to_patch_embedding = CurvePatchEmbedding(
            image_size, patch_size, dim, channels, curve, dtype, generator)
        grid = self.to_patch_embedding.grid_size
        positions = flat_lut(curve, grid).astype(np.float32)
        pe = gfpe(positions, dim, temperature=temperature, h_param=h_param)
        self.register_buffer("pos_embedding", torch.from_numpy(pe),
                             persistent=False)
        self.transformer = PreNormTransformer(
            dim, depth, heads, dim_head, mlp_dim, dtype, generator)
        self.linear_head = _linear(dim, num_classes, generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits ``[B, num_classes]`` for NHWC images ``[B, H, W, C]``."""
        return _classify(self, self.to_patch_embedding(x))


def HilbertViT(**kwargs) -> CurveViT:
    """Reference-named constructor."""
    kwargs.setdefault("curve", "hilbert")
    if "T" in kwargs:
        kwargs["temperature"] = kwargs.pop("T")
    return CurveViT(**kwargs)
