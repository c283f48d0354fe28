"""Declarative model registry: ``build_model(ModelConfig(...))`` -> module.

Counterpart of ``sfc_vit_tpu/registry.py``.  ``ModelConfig`` and
``PRESETS`` carry the same fields and operating points; ``build_model``
runs the JAX package's validation and builds the pre-norm families
('simple', 'curvevit', with token merging and per-layer attention
schedules: the 'longctx-16k' and 'longctx-16k-hybrid' presets) and family
A's 'vit' (the 'notebook' preset) and 'vit1d' (the 'flagship' preset)
over the 2-D, 1-D or hierarchical tokenizer, fused (``fused=True``) or
not, and 'hier' over the hierarchical tokenizer's levels, each with or
without ``remat`` (per-layer activation recompute in training).  Models
are built on the card unless the caller asks for the CPU
(``device='cpu'``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from .curves import CURVE_REGISTRY
from .models import (
    CurveViT,
    HierarchicalVisionTransformer1D,
    SimpleViT,
    VisionTransformer,
    VisionTransformer1D,
)
from .ops.attention import check_implementation
from .tokenizers import ConvPatchEmbedding, HierarchicalCurveEmbedding, PixelCurveEmbedding1D

__all__ = ["ModelConfig", "build_tokenizer", "build_model", "PRESETS",
           "preset_config", "TOKENIZER_FAMILIES", "MODEL_FAMILIES"]

TOKENIZER_FAMILIES = ("2d", "1d", "hierarchical")
MODEL_FAMILIES = ("vit", "vit1d", "hier", "simple", "curvevit")


@dataclasses.dataclass
class ModelConfig:
    """curve + tokenizer + model size in, model out."""

    model: str = "vit1d"          # one of MODEL_FAMILIES
    tokenizer: str = "hierarchical"
    curve: str = "morton"
    img_size: int = 32
    patch_size: int = 4
    patch_size_list: Sequence[int] = (16, 4, 1)
    embed_dim: int = 256
    depth: int = 8
    n_heads: int = 4
    mlp_dim: int = 512
    dim_head: int = 64
    num_classes: int = 10
    posemb: str = "none"
    remat: bool = False
    fused: bool = False
    dtype: Optional[str] = None   # e.g. "bfloat16"
    attn_impl: Union[str, Sequence[str]] = "auto"
    merge_layers: Sequence[int] = ()
    merge_ratio: float = 0.5

    def torch_dtype(self) -> Optional[torch.dtype]:
        return None if self.dtype is None else getattr(torch, self.dtype)


#: Named operating points, the same as the JAX package's.
PRESETS = {
    "flagship": dict(model="vit1d", tokenizer="hierarchical", curve="morton",
                     img_size=32, patch_size_list=(16, 4, 1), embed_dim=256,
                     depth=8, n_heads=4, mlp_dim=512),
    "notebook": dict(model="vit", tokenizer="2d", curve="hilbert",
                     img_size=32, patch_size=4, embed_dim=256, depth=6,
                     n_heads=4, mlp_dim=256),
    "vit-tiny-4": dict(model="curvevit", img_size=32, patch_size=4,
                       embed_dim=192, depth=12, n_heads=3, mlp_dim=768),
    "vit-s-16": dict(model="curvevit", img_size=224, patch_size=16,
                     embed_dim=384, depth=12, n_heads=6, mlp_dim=1536),
    "vit-b-16": dict(model="curvevit", img_size=224, patch_size=16,
                     embed_dim=768, depth=12, n_heads=12, mlp_dim=3072),
    "longctx-16k": dict(model="curvevit", curve="hilbert", img_size=128,
                        patch_size=1, embed_dim=384, depth=4, n_heads=6,
                        mlp_dim=1536, dtype="bfloat16",
                        merge_layers=(1,), merge_ratio=0.5),
    "longctx-16k-hybrid": dict(
        model="curvevit", curve="hilbert", img_size=128, patch_size=1,
        embed_dim=384, depth=4, n_heads=6, mlp_dim=1536,
        dtype="bfloat16", merge_layers=(1,), merge_ratio=0.5,
        attn_impl=("local", "local", "local", "auto"),
    ),
}


def preset_config(name: str, **overrides) -> ModelConfig:
    """A ModelConfig from a named preset, with field overrides."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return ModelConfig(**{**PRESETS[name], **overrides})


def _check_curve(cfg: ModelConfig) -> None:
    if cfg.curve not in CURVE_REGISTRY and cfg.curve != "random":
        raise KeyError(f"unknown curve {cfg.curve!r}; available: "
                       f"{sorted(CURVE_REGISTRY) + ['random']}")
    if cfg.curve == "random" and cfg.tokenizer != "2d":
        raise ValueError("curve='random' (the per-call shuffle ablation) is only "
                         "implemented by the 2d tokenizer family")


def build_tokenizer(cfg: ModelConfig, return_levels: bool = False,
                    generator: Optional[torch.Generator] = None):
    """The tokenizer module for ``cfg`` (parameters on the CPU).  As in JAX,
    the 2-D family drops ``fused`` for ``'random'`` (the per-step shuffle
    has no static LUT to fuse)."""
    _check_curve(cfg)
    dtype = cfg.torch_dtype()
    if cfg.tokenizer == "2d":
        return ConvPatchEmbedding(
            img_size=cfg.img_size, patch_size=cfg.patch_size, embed_dim=cfg.embed_dim,
            curve=cfg.curve, fused=cfg.fused and cfg.curve != "random", dtype=dtype,
            generator=generator)
    if cfg.tokenizer == "1d":
        return PixelCurveEmbedding1D(
            img_size=cfg.img_size, patch_size=cfg.patch_size, embed_dim=cfg.embed_dim,
            curve=cfg.curve, fused=cfg.fused, dtype=dtype, generator=generator)
    if cfg.tokenizer == "hierarchical":
        return HierarchicalCurveEmbedding(
            img_size=cfg.img_size, patch_size_list=tuple(cfg.patch_size_list),
            embed_dim=cfg.embed_dim, curve=cfg.curve,
            return_levels=return_levels, fused=cfg.fused,
            dtype=dtype, generator=generator)
    raise KeyError(f"unknown tokenizer family {cfg.tokenizer!r}; "
                   f"available: {TOKENIZER_FAMILIES}")


def _validate(cfg: ModelConfig) -> None:
    """The JAX package's checks (``registry.py:176-257``)."""
    if cfg.model not in MODEL_FAMILIES:
        raise KeyError(
            f"unknown model family {cfg.model!r}; available: {MODEL_FAMILIES}")
    family_b = cfg.model in ("simple", "curvevit")
    if family_b:
        if cfg.curve not in CURVE_REGISTRY:
            raise KeyError(f"unknown curve {cfg.curve!r} for model {cfg.model!r}; "
                           f"available: {sorted(CURVE_REGISTRY)}")
        if cfg.fused:
            raise ValueError(f"model {cfg.model!r} has no fused-tokenizer path; "
                             "drop fused=True")
    if not isinstance(cfg.attn_impl, str) and not family_b:
        raise ValueError(
            f"per-layer attn_impl schedules are implemented by the family-B "
            f"models ('simple'/'curvevit') only -- model {cfg.model!r} takes a "
            "single implementation string")
    if cfg.merge_layers and cfg.model != "curvevit":
        raise ValueError(f"merge_layers is curve-pair token merging, implemented "
                         f"by model 'curvevit' only -- model {cfg.model!r} would "
                         "silently ignore it")
    if (family_b or cfg.model == "hier") and cfg.posemb != "none":
        raise ValueError(f"model {cfg.model!r} manages its own positional "
                         f"encoding; posemb={cfg.posemb!r} would be ignored")
    if not family_b:
        _check_curve(cfg)
    for impl in ((cfg.attn_impl,) if isinstance(cfg.attn_impl, str)
                 else tuple(cfg.attn_impl)):
        check_implementation(impl)


def build_model(cfg: ModelConfig, device="cuda",
                generator: Optional[torch.Generator] = None):
    """The module for ``cfg``, initialised from ``generator`` and moved to
    ``device``: the card by default.  Without a CUDA device it raises;
    pass ``device='cpu'`` to build on the CPU."""
    _validate(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: no CUDA device is available; pass "
                           "device='cpu' to build the model on the CPU")
    dtype = cfg.torch_dtype()
    if cfg.model in ("vit", "vit1d"):
        model = VisionTransformer if cfg.model == "vit" else VisionTransformer1D
        return model(
            build_tokenizer(cfg, generator=generator), depth=cfg.depth,
            n_heads=cfg.n_heads, mlp_dim=cfg.mlp_dim, num_classes=cfg.num_classes,
            posemb=cfg.posemb, dtype=dtype, attn_impl=cfg.attn_impl,
            device=device, generator=generator, remat=cfg.remat)
    if cfg.model == "hier":
        if cfg.tokenizer != "hierarchical":
            raise ValueError("model 'hier' requires tokenizer='hierarchical'")
        return HierarchicalVisionTransformer1D(
            build_tokenizer(cfg, return_levels=True, generator=generator),
            depth=cfg.depth, n_heads=cfg.n_heads, mlp_dim=cfg.mlp_dim,
            num_classes=cfg.num_classes, dtype=dtype, attn_impl=cfg.attn_impl,
            device=device, generator=generator, remat=cfg.remat)
    attn_impl = cfg.attn_impl if isinstance(cfg.attn_impl, str) else tuple(cfg.attn_impl)
    kw = dict(image_size=cfg.img_size, patch_size=cfg.patch_size,
              num_classes=cfg.num_classes, dim=cfg.embed_dim, depth=cfg.depth,
              heads=cfg.n_heads, mlp_dim=cfg.mlp_dim, dim_head=cfg.dim_head,
              dtype=dtype, device=device, generator=generator, attn_impl=attn_impl,
              remat=cfg.remat)
    if cfg.model == "simple":
        return SimpleViT(**kw)
    return CurveViT(curve=cfg.curve, merge_layers=tuple(cfg.merge_layers),
                    merge_ratio=cfg.merge_ratio, **kw)
