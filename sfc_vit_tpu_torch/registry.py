"""Declarative model registry: ``build_model(ModelConfig(...))`` -> module.

Counterpart of ``sfc_vit_tpu/registry.py``.  ``ModelConfig`` and
``PRESETS`` carry the same fields and operating points; ``build_model``
builds the pre-norm families ('simple', 'curvevit') and raises
``NotImplementedError`` naming the ROADMAP.md item for everything not yet
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from sfc_vit_tpu.curves import CURVE_REGISTRY

from .models import CurveViT, SimpleViT

__all__ = ["ModelConfig", "build_model", "PRESETS", "preset_config",
           "MODEL_FAMILIES"]

MODEL_FAMILIES = ("vit", "vit1d", "hier", "simple", "curvevit")

#: Where each family or option that is not ported yet stands in ROADMAP.md.
_NOT_PORTED = {
    "vit": "queue 1 item 7 (family-A models)",
    "vit1d": "queue 1 item 7 (family-A models)",
    "hier": "queue 1 item 7 (family-A models)",
    "merge_layers": "queue 1 item 10 (long context: token merge)",
    "remat": "queue 1 item 4 (train step: remat)",
    "attn_impl": "queue 2 kernels #5-#13 (other attention kernels)",
}


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


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet: ROADMAP.md {_NOT_PORTED[what]}")


def build_model(cfg: ModelConfig, device=None,
                generator: Optional[torch.Generator] = None):
    """The module for ``cfg``, on ``device``, initialised from
    ``generator``."""
    if cfg.model not in MODEL_FAMILIES:
        raise KeyError(
            f"unknown model family {cfg.model!r}; available: {MODEL_FAMILIES}")
    if cfg.model not in ("simple", "curvevit"):
        raise _not_ported(cfg.model)
    if cfg.curve not in CURVE_REGISTRY:
        raise KeyError(
            f"unknown curve {cfg.curve!r} for model {cfg.model!r}; "
            f"available: {sorted(CURVE_REGISTRY)}")
    if cfg.fused:
        raise ValueError(f"model {cfg.model!r} has no fused-tokenizer path; "
                         "drop fused=True")
    if cfg.posemb != "none":
        raise ValueError(f"model {cfg.model!r} manages its own positional "
                         f"encoding; posemb={cfg.posemb!r} would be ignored")
    if cfg.merge_layers:
        raise _not_ported("merge_layers")
    if cfg.remat:
        raise _not_ported("remat")
    if cfg.attn_impl != "auto":
        raise _not_ported("attn_impl")
    kw = dict(image_size=cfg.img_size, patch_size=cfg.patch_size,
              num_classes=cfg.num_classes, dim=cfg.embed_dim, depth=cfg.depth,
              heads=cfg.n_heads, mlp_dim=cfg.mlp_dim, dim_head=cfg.dim_head,
              dtype=cfg.torch_dtype(), device=device, generator=generator)
    if cfg.model == "simple":
        return SimpleViT(**kw)
    return CurveViT(curve=cfg.curve, **kw)
