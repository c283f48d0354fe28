"""Positional tables of the pre-norm family, host-precomputed numpy.

Counterpart of ``sfc_vit_tpu/models/posemb.py`` (``sincos_1d`` and
``gfpe``); ported rather than imported because importing the JAX
package's ``models`` pulls in jax.  The tables become buffers of the
models that use them.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["sincos_1d", "gfpe"]


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
