"""Family-A models in PyTorch: ``VisionTransformer1D``.

Counterpart of ``sfc_vit_tpu/models/vit.py``: tokenizer -> optional
positional table -> ``MixerBlock`` -> post-norm ``TransformerSeqEncoder``
-> factorised ``MultiLayerPredictor`` (the reference's ``vit.py:392-458``;
its flagship, ``main.py:276-282``, pairs it with the hierarchical Morton
tokenizer).  NHWC images [B, H, W, C] in, logits [B, num_classes] out.
As in the reference, the stock model applies no CLS token and no
positional encoding (``posemb='none'``).

``VisionTransformer`` waits for the 2-D tokenizer and
``HierarchicalVisionTransformer1D`` for its own slice (ROADMAP.md queue 1
items 6 and 16); ``registry.build_model`` names them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.initializers import normal
from .layers import MixerBlock, MultiLayerPredictor, TransformerSeqEncoder
from .posemb import build_posemb

__all__ = ["VisionTransformer1D"]


def _token_dim(tok) -> int:
    return tok.out_dim if hasattr(tok, "out_dim") else tok.embed_dim


class VisionTransformer1D(nn.Module):
    """tokenizer -> MixerBlock -> encoder -> head.

    ``patch_embed`` is a tokenizer module (``HierarchicalCurveEmbedding``)
    exposing ``n_patches`` and ``out_dim`` (or ``embed_dim``).  Dropout
    (``dropout_rate`` in the encoder, 0.5 in the head) is on in
    ``train()`` mode.  Parameters are created in float32 from
    ``generator`` and moved to ``device``.
    """

    def __init__(self, patch_embed: nn.Module, depth: int = 6, n_heads: int = 4,
                 mlp_dim: int = 256, num_classes: int = 10,
                 dropout_rate: float = 0.1, posemb: str = "none",
                 dtype: Optional[torch.dtype] = None, attn_impl: str = "auto",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.posemb = posemb
        self.patch_embed = patch_embed
        dim, n = _token_dim(patch_embed), patch_embed.n_patches
        if posemb == "learned":
            self.pos_embed = nn.Parameter(normal((n, dim), 0.02, generator))
        else:
            table = build_posemb(posemb, n, dim,
                                 curve=getattr(patch_embed, "curve", None),
                                 grid=getattr(patch_embed, "grid_size", None))
            self.register_buffer(
                "pos_table", None if table is None else torch.from_numpy(table),
                persistent=False)
        self.mlp_mixer = MixerBlock(n, dim, dim * 2, out_dim=dim, dtype=dtype,
                                    generator=generator)
        self.encoder = TransformerSeqEncoder(dim, n_heads, mlp_dim, depth,
                                             dropout_rate, dtype, attn_impl,
                                             generator)
        self.mlp_head = MultiLayerPredictor(dim, n, n_layers=2, dropout_rate=0.5,
                                            num_classes=num_classes, dtype=dtype,
                                            generator=generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits ``[B, num_classes]`` for NHWC images ``[B, H, W, C]``."""
        x = self.patch_embed(x)
        if self.posemb == "learned":
            x = x + self.pos_embed.to(x.dtype)
        elif self.pos_table is not None:
            x = x + self.pos_table.to(x.dtype)
        x = self.mlp_mixer(x)
        x = self.encoder(x)
        return self.mlp_head(x)
