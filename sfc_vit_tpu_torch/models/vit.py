"""Family-A models in PyTorch: ``VisionTransformer``,
``VisionTransformer1D`` and ``HierarchicalVisionTransformer1D``.

Counterpart of ``sfc_vit_tpu/models/vit.py``.  ``VisionTransformer``:
tokenizer -> optional positional table -> post-norm
``TransformerSeqEncoder`` -> factorised ``MultiLayerPredictor`` (the
reference's ``vit.py:325-385``; its ``notebooks/hilbert.ipynb`` trains it
over the 2-D Hilbert and raster tokenizers: the ``'notebook'`` preset).
``VisionTransformer1D`` adds a ``MixerBlock`` before the encoder (the
reference's ``vit.py:392-458``; its flagship, ``main.py:276-282``, pairs
it with the hierarchical Morton tokenizer).
``HierarchicalVisionTransformer1D``: one encoder per level of the
hierarchical tokenizer, the levels concatenated along the tokens, a
two-layer fusion encoder and a mixing head (the reference's
``vit.py:465-545``, repaired as the JAX package repairs it).  NHWC images
[B, H, W, C] in, logits [B, num_classes] out.  As in the reference, the
stock models apply no CLS token and no positional encoding.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.initializers import normal
from .layers import MixerBlock, MultiLayerPredictor, TransformerSeqEncoder
from .posemb import build_posemb

__all__ = ["VisionTransformer", "VisionTransformer1D", "HierarchicalVisionTransformer1D"]


def _token_dim(tok) -> int:
    return tok.out_dim if hasattr(tok, "out_dim") else tok.embed_dim


class VisionTransformer(nn.Module):
    """tokenizer -> encoder -> head (the head reads every token through the
    factorised linear: no CLS token, no mean pool).

    ``patch_embed`` is a tokenizer module (``ConvPatchEmbedding``,
    ``PixelCurveEmbedding1D`` or ``HierarchicalCurveEmbedding``) exposing
    ``n_patches`` and ``out_dim`` (or ``embed_dim``).  Dropout
    (``dropout_rate`` in the encoder, 0.5 in the head) is on in
    ``train()`` mode; ``remat`` checkpoints each encoder layer in training.
    Parameters are created in float32 from ``generator`` and moved to
    ``device``.
    """

    #: ``VisionTransformer1D`` puts a ``MixerBlock`` before the encoder.
    _mixer = False

    def __init__(self, patch_embed: nn.Module, depth: int = 6, n_heads: int = 4,
                 mlp_dim: int = 256, num_classes: int = 10,
                 dropout_rate: float = 0.1, posemb: str = "none",
                 dtype: Optional[torch.dtype] = None, attn_impl: str = "auto",
                 device=None, generator: Optional[torch.Generator] = None,
                 remat: bool = False):
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
        if self._mixer:
            self.mlp_mixer = MixerBlock(n, dim, dim * 2, out_dim=dim, dtype=dtype,
                                        generator=generator)
        self.encoder = TransformerSeqEncoder(dim, n_heads, mlp_dim, depth,
                                             dropout_rate, dtype, attn_impl,
                                             generator, remat=remat)
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
        if self._mixer:
            x = self.mlp_mixer(x)
        x = self.encoder(x)
        return self.mlp_head(x)


class VisionTransformer1D(VisionTransformer):
    """tokenizer -> MixerBlock -> encoder -> head: :class:`VisionTransformer`
    with the channel-mixing ``mlp_mixer`` before the encoder (the
    flagship's model)."""

    _mixer = True


class HierarchicalVisionTransformer1D(nn.Module):
    """One encoder per pyramid level (``encoder_{i}``, ``depth`` layers
    each) -> the levels concatenated along the tokens -> a two-layer
    ``fusion_encoder`` -> ``MultiLayerPredictor(mix=True)`` over all
    ``sum(patch_list)`` tokens (dropout 0.5).

    ``patch_embed`` must be a ``HierarchicalCurveEmbedding`` built with
    ``return_levels=True``; every layer has its per-level width
    ``embed_dim``.  ``remat`` checkpoints each layer of the level encoders
    in training; the fusion encoder runs without it, as in JAX.
    Parameters are created in float32 from ``generator`` and moved to
    ``device``.
    """

    def __init__(self, patch_embed: nn.Module, depth: int = 6, n_heads: int = 4,
                 mlp_dim: int = 256, num_classes: int = 10,
                 dropout_rate: float = 0.1, dtype: Optional[torch.dtype] = None,
                 attn_impl: str = "auto", device=None,
                 generator: Optional[torch.Generator] = None, remat: bool = False):
        super().__init__()
        if not getattr(patch_embed, "return_levels", False):
            raise ValueError("HierarchicalVisionTransformer1D needs a hierarchical "
                             "tokenizer built with return_levels=True")
        self.patch_embed = patch_embed
        dim = patch_embed.embed_dim
        for i in range(len(patch_embed.patch_list)):
            self.add_module(f"encoder_{i}", TransformerSeqEncoder(
                dim, n_heads, mlp_dim, depth, dropout_rate, dtype, attn_impl, generator,
                remat=remat))
        self.fusion_encoder = TransformerSeqEncoder(dim, n_heads, mlp_dim, 2, dropout_rate,
                                                    dtype, attn_impl, generator)
        self.mlp_head = MultiLayerPredictor(dim, int(sum(patch_embed.patch_list)),
                                            n_layers=2, dropout_rate=0.5,
                                            num_classes=num_classes, mix=True,
                                            dtype=dtype, generator=generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits ``[B, num_classes]`` for NHWC images ``[B, H, W, C]``."""
        levels = self.patch_embed(x)
        x = torch.cat([getattr(self, f"encoder_{i}")(lvl)
                       for i, lvl in enumerate(levels)], dim=1)
        return self.mlp_head(self.fusion_encoder(x))
