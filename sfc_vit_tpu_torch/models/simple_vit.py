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

Each encoder layer routes as the JAX model routes on its chip
(:func:`layer_route`): the attention block is one
:func:`~sfc_vit_tpu_torch.ops.fused_attention_block` call (kernels #1,
#4) under ``attn_impl='auto'`` while N <= ``FUSED_BLOCK_MAX_N`` and the
model and inner widths are multiples of 128; otherwise LN -> QKV ->
:func:`~sfc_vit_tpu_torch.ops.attention.packed_qkv_attention` (#7 up to
1,024 tokens, flash attention #8-#11 past them, or the fp32 formula) ->
out projection -> residual (a ``'local'`` layer: curve-local attention
#12/#13 in that place), with the two products left to
``torch.matmul`` as JAX leaves them to XLA.  The MLP block is one
:func:`~sfc_vit_tpu_torch.ops.fused_mlp_block` call (#2, #3) when the
model and hidden widths are multiples of 128, else
:func:`~sfc_vit_tpu_torch.ops.fused_mlp.mlp_block_ref` (JAX's
``mlp_block_xla``: fc1 rounded before the GELU).  Each wrapper runs its
plain version for a CPU input.  The embedding, token pooling or merging,
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

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..curves import flat_lut
from ..ops.attention import check_implementation, packed_qkv_attention, packed_route
from ..ops.fused_attention_block import fused_attention_block
from ..ops.fused_mlp import fused_mlp_block, mlp_block_ref
from ..ops.kernel_utils import ln_fp32
from ..ops.token_merge import curve_pair_merge_topk
from ..tokenizers.patches import curve_gather, patchify
from ..utils.initializers import lecun_normal as _lecun_normal
from .layers import remat_call
from .posemb import gfpe, sincos_1d

__all__ = ["CurvePatchEmbedding", "PreNormTransformer", "SimpleViT",
           "CurveViT", "HilbertViT", "curve_pair_pool", "layer_route",
           "fused_attn_gate", "fused_mlp_gate", "FUSED_BLOCK_MAX_N"]

#: JAX's length gate for the fused attention-block kernel
#: (``fused_attention_block_fits``, ``sfc_vit_tpu/ops/fused_attention_block.py
#: :218-219``): one whole-sequence softmax per image.  It chooses the
#: layer's *formula* (#1's normalise-then-round block or the unfused
#: composition), so that the port matches the reference; the H100
#: crossover is still to measure.
FUSED_BLOCK_MAX_N = 1024


def fused_attn_gate(attn_impl: str, n: int, d: int, inner: int) -> bool:
    """True when the attention block takes the fused kernel: JAX's
    ``_fused_attn_gate`` (``models/simple_vit.py:84-101``) on its chip,
    without the VMEM budget (Hopper kernels tile)."""
    return (attn_impl == "auto" and d % 128 == 0 and inner % 128 == 0
            and n <= FUSED_BLOCK_MAX_N)


def fused_mlp_gate(d: int, f: int) -> bool:
    """True when the MLP block takes the fused kernels (JAX's
    ``_FeedForward`` gate, ``models/simple_vit.py:321-326``, without the
    VMEM budget)."""
    return d % 128 == 0 and f % 128 == 0


def layer_route(attn_impl: str, n: int, d: int, inner: int, f: int,
                dh: int) -> Tuple[str, str]:
    """Which path an encoder layer takes for ``n`` tokens of width ``d``,
    attention width ``inner`` = heads x ``dh`` and MLP width ``f``:
    ``(attention, mlp)`` with attention one of ``'fused_block'`` (#1/#4),
    ``'packed'`` (#7), ``'flash'`` (#8-#11), ``'local'`` (#12/#13) or
    ``'xla'`` (the fp32 formula), and mlp ``'fused_mlp'`` (#2/#3) or ``'xla'``
    (``mlp_block_ref``).  The modules route through the same gates."""
    if fused_attn_gate(attn_impl, n, d, inner):
        attn = "fused_block"
    else:
        attn = packed_route(attn_impl, n, dh)
    return attn, "fused_mlp" if fused_mlp_gate(d, f) else "xla"


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
    plus the residual: one :func:`fused_attention_block` call where
    :func:`fused_attn_gate` holds, else the unfused composition with the
    attention dispatched by ``attn_impl``."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 dtype: Optional[torch.dtype] = None, generator=None,
                 attn_impl: str = "auto"):
        super().__init__()
        check_implementation(attn_impl)
        inner = heads * dim_head
        self.heads = heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.norm = LayerNorm(dim)
        self.to_qkv = _DenseParams(dim, 3 * inner, use_bias=False,
                                   generator=generator)
        self.to_out = _DenseParams(inner, dim, use_bias=False,
                                   generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        x = x.to(dt)
        w_qkv, w_out = self.to_qkv.kernel.to(dt), self.to_out.kernel.to(dt)
        if fused_attn_gate(self.attn_impl, x.shape[1], x.shape[2], w_out.shape[0]):
            return fused_attention_block(x, self.norm.scale, self.norm.bias,
                                         w_qkv, w_out, self.heads)
        out = packed_qkv_attention(ln_fp32(x, self.norm.scale, self.norm.bias, 1e-5)
                                   @ w_qkv, self.heads, implementation=self.attn_impl)
        return x + out @ w_out


class _FeedForward(nn.Module):
    """LN -> Linear -> GELU (exact) -> Linear, plus the residual: one
    :func:`fused_mlp_block` call where :func:`fused_mlp_gate` holds, else
    :func:`mlp_block_ref`."""

    def __init__(self, dim: int, hidden_dim: int,
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.norm = LayerNorm(dim)
        self.fc1 = _DenseParams(dim, hidden_dim, generator=generator)
        self.fc2 = _DenseParams(hidden_dim, dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        w1 = self.fc1.kernel
        block = fused_mlp_block if fused_mlp_gate(*w1.shape) else mlp_block_ref
        return block(
            x.to(dt), self.norm.scale, self.norm.bias,
            w1.to(dt), self.fc1.bias.to(dt),
            self.fc2.kernel.to(dt), self.fc2.bias.to(dt),
            eps=1e-5, activation="gelu", residual=True,
        )


def curve_pair_pool(x: torch.Tensor) -> torch.Tensor:
    """Merge curve-adjacent token pairs by averaging: [B, N, D] ->
    [B, N/2, D] (tokens 2i and 2i+1 are spatial neighbours on the curve)."""
    b, n, d = x.shape
    if n % 2:
        raise ValueError(f"token count {n} must be even to pair-pool")
    return x.reshape(b, n // 2, 2, d).mean(dim=2)


def _impl_schedule(attn_impl: Union[str, Sequence[str]],
                   depth: int) -> Tuple[str, ...]:
    """``attn_impl`` as a per-layer tuple of length ``depth`` (JAX's
    ``_impl_schedule``); a single string applies to every layer."""
    if isinstance(attn_impl, str):
        return (attn_impl,) * depth
    impls = tuple(attn_impl)
    if len(impls) != depth:
        raise ValueError(
            f"attn_impl schedule has {len(impls)} entries for depth {depth}; "
            "give one implementation per layer (or a single string for all "
            "layers)")
    if not all(isinstance(i, str) for i in impls):
        raise TypeError(f"attn_impl schedule must be strings, got {impls!r}")
    return impls


class PreNormTransformer(nn.Module):
    """Residual pre-norm stack with a final LayerNorm.

    ``attn_impl`` is one implementation for every layer or a per-layer
    tuple of length ``depth`` (the ``longctx-16k-hybrid`` preset: three
    ``'local'`` layers, kernels #12/#13, then one ``'auto'``); a schedule
    naming one that is not ported (``'xla_bf16'``, ``'ring'``, ``'sp'``)
    raises.  A local layer's curve blocks are positions in the sequence it
    receives, merged or not, as in JAX.  After layer ``i``,
    ``pool_layers`` halves the tokens with :func:`curve_pair_pool` and
    ``merge_layers`` merges the most similar curve pairs
    (:func:`~sfc_vit_tpu_torch.ops.token_merge.curve_pair_merge_topk` at
    ``merge_ratio``).  ``remat`` checkpoints each attention block and each
    MLP block apart in training (:func:`~sfc_vit_tpu_torch.models.layers.remat_call`),
    as JAX's ``nn.remat(_PreNormAttention)`` and ``nn.remat(_FeedForward)``;
    pooling and merging stay outside.  ``final_norm`` (pipeline stages) is
    not ported.
    """

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dtype: Optional[torch.dtype] = None,
                 generator=None, pool_layers: Sequence[int] = (),
                 merge_layers: Sequence[int] = (), merge_ratio: float = 0.5,
                 attn_impl: Union[str, Sequence[str]] = "auto", remat: bool = False):
        super().__init__()
        self.depth, self.remat = depth, remat
        self.pool_layers = tuple(pool_layers)
        self.merge_layers = tuple(merge_layers)
        self.merge_ratio = merge_ratio
        impls = _impl_schedule(attn_impl, depth)
        for i in range(depth):
            self.add_module(f"attn_{i}", _PreNormAttention(
                dim, heads, dim_head, dtype, generator, impls[i]))
            self.add_module(f"ff_{i}", _FeedForward(
                dim, mlp_dim, dtype, generator))
        self.norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = remat_call(getattr(self, f"attn_{i}"), x, self.remat)  # + residual
            x = remat_call(getattr(self, f"ff_{i}"), x, self.remat)
            if i in self.pool_layers:
                x = curve_pair_pool(x)
            if i in self.merge_layers:
                x = curve_pair_merge_topk(x, self.merge_ratio)
        return self.norm(x)


def _classify(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Tokens -> + positional table -> pre-norm stack -> mean pool ->
    linear head (the part both models share)."""
    x = x + model.pos_embedding.to(x.dtype)
    x = model.transformer(x)
    return _dense(x.mean(dim=1), model.linear_head)


class SimpleViT(nn.Module):
    """Raster baseline: patchify -> LN/Linear/LN -> + sincos 1-D table ->
    pre-norm stack -> mean pool -> linear head; ``remat`` goes to the
    :class:`PreNormTransformer`."""

    def __init__(self, image_size: int, patch_size: int, num_classes: int,
                 dim: int, depth: int, heads: int, mlp_dim: int,
                 dim_head: int = 64, channels: int = 3,
                 dtype: Optional[torch.dtype] = None,
                 device=None, generator: Optional[torch.Generator] = None,
                 attn_impl: Union[str, Sequence[str]] = "auto", remat: bool = False):
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
            dim, depth, heads, dim_head, mlp_dim, dtype, generator,
            attn_impl=attn_impl, remat=remat)
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
    h=3.0) over the curve's flat grid indices; ``pool_layers``,
    ``merge_layers`` / ``merge_ratio``, ``attn_impl`` and ``remat`` go to
    the :class:`PreNormTransformer`."""

    def __init__(self, image_size: int, patch_size: int, num_classes: int,
                 dim: int, depth: int, heads: int, mlp_dim: int,
                 dim_head: int = 64, channels: int = 3, curve: str = "hilbert",
                 temperature: float = 4.0, h_param: float = 3.0,
                 dtype: Optional[torch.dtype] = None,
                 device=None, generator: Optional[torch.Generator] = None,
                 pool_layers: Sequence[int] = (), merge_layers: Sequence[int] = (),
                 merge_ratio: float = 0.5,
                 attn_impl: Union[str, Sequence[str]] = "auto", remat: bool = False):
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
            dim, depth, heads, dim_head, mlp_dim, dtype, generator,
            pool_layers=pool_layers, merge_layers=merge_layers,
            merge_ratio=merge_ratio, attn_impl=attn_impl, remat=remat)
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
