"""Positional tables, host-precomputed numpy.

Counterpart of ``sfc_vit_tpu/models/posemb.py`` (``sincos_1d``, ``gfpe``
and the family-A registry ``build_posemb``).  The tables become buffers
of the models that use them.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..curves import flat_lut

__all__ = ["sincos_1d", "gfpe", "build_posemb"]


def sincos_1d(n_pos: int, dim: int, temperature: float = 10000.0) -> np.ndarray:
    """Vaswani sinusoidal 1-D table, (n_pos, dim) float32: interleaved
    sin (even dims) / cos (odd dims)."""
    if dim % 2:
        raise ValueError(f"embedding dim must be even, got {dim}")
    pos = np.arange(n_pos, dtype=np.float32)[:, None]
    div = np.exp(
        np.arange(0, dim, 2, dtype=np.float32) * (-math.log(temperature) / dim)
    )
    pe = np.zeros((n_pos, dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def gfpe(positions: np.ndarray, dim: int, temperature: float = 4.0,
         h_param: float = 3.0) -> np.ndarray:
    """GFPE-style curve positional encoding, (n, dim) float32.

    For curve flat-index ``pos`` and frequency index ``i``:
        arg = (2 i n pos 2pi) / (T n d) + h (2 i pos 2pi) / d
        pe  = [sin(arg) || cos(arg)]
    with defaults T=4, h=3.0 (the reference ``HilbertViT``).
    """
    if dim % 2:
        raise ValueError(f"embedding dim must be even, got {dim}")
    pos = np.asarray(positions, dtype=np.float32)[:, None]
    n = pos.shape[0]
    i_ar = np.arange(dim // 2, dtype=np.float32)[None, :]
    two_pi = 2.0 * math.pi
    scale = (2.0 * i_ar * n * pos * two_pi) / (temperature * n * dim)
    phase = h_param * (2.0 * i_ar * pos * two_pi) / dim
    arg = scale + phase
    return np.concatenate([np.sin(arg), np.cos(arg)], axis=1).astype(np.float32)


def build_posemb(kind: str, n_pos: int, dim: int, curve: Optional[str] = None,
                 grid: Optional[int] = None, temperature: float = 4.0,
                 h_param: float = 3.0) -> Optional[np.ndarray]:
    """A positional table (n_pos, dim), or None for 'none' / 'learned'.

    For 'gfpe' the positions are the curve's flat LUT values over
    ``grid`` (raster positions without a curve); where the LUT is finer
    than the token sequence each token takes its first curve cell's flat
    index, as the JAX package does.
    """
    if kind in ("none", "learned"):
        return None
    if kind == "sincos1d":
        return sincos_1d(n_pos, dim)
    if kind != "gfpe":
        raise ValueError(f"unknown positional embedding kind {kind!r}")
    if curve == "random":
        raise ValueError("gfpe is undefined for curve='random' (the per-call "
                         "shuffle has no static curve order to encode)")
    if curve is None or curve == "raster":
        positions = np.arange(n_pos, dtype=np.float32)
    else:
        if grid is None:
            grid = int(math.isqrt(n_pos))
            if grid * grid != n_pos:
                raise ValueError(
                    f"gfpe over curve {curve!r}: n_pos={n_pos} is not a perfect "
                    "square and the tokenizer exposes no grid_size; pass grid= "
                    "explicitly")
        positions = flat_lut(curve, grid).astype(np.float32)
        if positions.shape[0] != n_pos:
            if positions.shape[0] % n_pos:
                raise ValueError(
                    f"gfpe over curve {curve!r}: grid {grid} gives "
                    f"{positions.shape[0]} curve cells, not a multiple of "
                    f"n_pos={n_pos}")
            positions = positions[:: positions.shape[0] // n_pos]
    return gfpe(positions, dim, temperature=temperature, h_param=h_param)
