"""Static index LUT builders: the bridge from curve math to the gather.

A copy of ``sfc_vit_tpu/curves/luts.py``.  Everything here runs once on
the host at model-build time and returns ``np.int32`` arrays, which the
tokenizers turn into index buffers, so the curve reordering is one
static gather on the device.

Reference touchpoints:
  * flat patch-grid LUTs: ``src/tokenizers/multiscale/multi_morton.py:68-72``
    and ``src/models/altvit.py:68-87``.
  * pixel coordinate LUTs: ``src/tokenizers/_1D/hilbert_embedding1D.py:25-28``.
  * onion spiral walk: ``src/tokenizers/_1D/onion_embedding1D.py:35-53``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Union

import numpy as np

from .generalize import embed_and_prune_sfc
from .generators import CURVE_REGISTRY

CurveLike = Union[str, "object"]

__all__ = [
    "curve_coords",
    "flat_lut",
    "flat_lut_2d",
    "pixel_lut",
    "onion_cells",
    "onion_flat_lut",
    "inverse_permutation",
]


def _curve_name(curve: CurveLike) -> str:
    if isinstance(curve, str):
        if curve not in CURVE_REGISTRY:
            raise KeyError(
                f"unknown curve {curve!r}; available: {sorted(CURVE_REGISTRY)}"
            )
        return curve
    for name, fn in CURVE_REGISTRY.items():
        if fn is curve:
            return name
    raise KeyError(f"unregistered curve function {curve!r}")


@lru_cache(maxsize=None)
def _coords_cached(name: str, d0: int, d1: int) -> np.ndarray:
    """Ordered cells with coords[:, 0] in [0, d0) and coords[:, 1] in
    [0, d1) -- one convention for every branch (non-square safe)."""
    if name == "onion":
        # The tokenizers use the direct spiral walk, not embed-and-prune
        # (whose onion path yields duplicate cells -- see generalize.py).
        # onion cells are (row, col) pairs with rows=d0, cols=d1; use
        # the read-only cached array (curve_coords copies on the way out).
        return _onion_cells_cached(d0, d1)
    if name == "raster":
        # Row-major enumeration, so flat/pixel LUTs are the identity --
        # the reference raster baselines apply *no* reorder
        # (``_1D/zigzag_embedding1D.py:31-39``, ``multiscale/multi_zigzag.py``).
        n = d0 * d1
        flat = np.arange(n, dtype=np.int32)
        return np.stack([flat // d1, flat % d1], axis=1).astype(np.int32)
    cells = embed_and_prune_sfc(CURVE_REGISTRY[name], d0, d1)
    return np.asarray(cells, dtype=np.int32)


def curve_coords(curve: CurveLike, width: int, height: int) -> np.ndarray:
    """Ordered integer (i, j) cells of a curve over a W x H grid,
    [N, 2] int32, with i in [0, width) and j in [0, height)."""
    return _coords_cached(_curve_name(curve), int(width), int(height)).copy()


def flat_lut(curve: CurveLike, grid: int) -> np.ndarray:
    """Flat permutation LUT over a grid x grid patch lattice, [grid^2] int32.

    flat index = i * grid + j for curve cell (i, j), matching
    ``SFCEmbedding1D._sfc_indices`` (``multi_morton.py:68-72``) and -- for
    Hilbert on power-of-2 grids -- ``HilbertPatchEmbedding._hilbert_order``
    (``altvit.py:68-87``).  Verified 8x8 Hilbert starts [0, 1, 9, 8, ...]
    (the notebook's transposed [0, 8, 9, 1, ...] convention is
    :func:`flat_lut_2d`).
    """
    coords = curve_coords(curve, grid, grid)
    lut = coords[:, 0].astype(np.int64) * grid + coords[:, 1]
    return lut.astype(np.int32)


_SWAPPED_TRANSFORM = {"hilbert", "peano"}  # curves whose reference
# post-transform is an (x, y) swap; the others are identity.


def flat_lut_2d(curve: CurveLike, grid: int) -> np.ndarray:
    """Flat LUT in the reference's conv-patchify (2D) convention.

    ``_2D/hilbert_embedding.py:30-45`` builds its LUT from a private
    *untransformed* copy of the Hilbert generator, producing the transpose
    of the altvit/1D convention (verified 8x8 start [0, 8, 9, 1, ...]).
    We recover the pre-transform coordinates per curve.
    """
    coords = curve_coords(curve, grid, grid)
    if _curve_name(curve) in _SWAPPED_TRANSFORM:
        coords = coords[:, ::-1]
    lut = coords[:, 0].astype(np.int64) * grid + coords[:, 1]
    return lut.astype(np.int32)


def pixel_lut(curve: CurveLike, height: int, width: int) -> np.ndarray:
    """Flat pixel-gather LUT over an H x W image, [H*W] int32.

    The reference 1D tokenizers index pixels as ``x[:, :, idx[:,0], idx[:,1]]``
    (``hilbert_embedding1D.py:36-37``), i.e. coordinate 0 selects the row.
    Here that collapses to one flat gather: flat = row * W + col.
    """
    coords = curve_coords(curve, height, width)  # (i, j) with i indexing rows
    lut = coords[:, 0].astype(np.int64) * width + coords[:, 1]
    return lut.astype(np.int32)


@lru_cache(maxsize=None)
def _onion_cells_cached(rows: int, cols: int) -> np.ndarray:
    visited = np.zeros((rows, cols), dtype=bool)
    out = np.empty((rows * cols, 2), dtype=np.int32)
    dirs = ((0, 1), (-1, 0), (0, -1), (1, 0))  # right, up, left, down
    d = 0
    i, j = rows - 1, 0
    for t in range(rows * cols):
        out[t] = (i, j)
        visited[i, j] = True
        ni, nj = i + dirs[d][0], j + dirs[d][1]
        if not (0 <= ni < rows and 0 <= nj < cols and not visited[ni, nj]):
            d = (d + 1) % 4
            ni, nj = i + dirs[d][0], j + dirs[d][1]
        i, j = ni, nj
    out.setflags(write=False)  # cached object: mutation must fail loudly
    return out


def onion_cells(rows: int, cols: int) -> np.ndarray:
    """Spiral (row, col) walk starting bottom-left, [rows*cols, 2] int32.

    Matches ``OnionEmbedding1D.onion_indices``
    (``onion_embedding1D.py:35-53``): directions cycle right, up, left,
    down over (row, col) indices, starting at (rows-1, 0).

    Returns a fresh writable copy; the lru-cached array is never exposed
    (a caller mutating the returned array must not corrupt later LUTs).
    """
    return _onion_cells_cached(int(rows), int(cols)).copy()


def onion_flat_lut(rows: int, cols: int) -> np.ndarray:
    """Flat spiral LUT: row * cols + col over the spiral walk, int32."""
    cells = _onion_cells_cached(int(rows), int(cols))
    return (cells[:, 0].astype(np.int64) * cols + cells[:, 1]).astype(np.int32)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    """Inverse of a permutation LUT (for scatter-style un-ordering)."""
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return inv
