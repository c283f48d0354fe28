"""Rectangle generalization of space-filling curves (host-side, numpy only).

A copy of the part of ``sfc_vit_tpu/curves/generalize.py`` that the LUTs
need: ``embed_and_prune_sfc`` generates the curve on the smallest
covering power-of-base square, snaps float centers to integer cells and
drops cells outside the W x H domain (the reference's
``space_filling_curves.py:458-491``).  ``block_stitch_sfc`` and
``get_symmetries`` stay in the JAX package: no path of the port uses
them.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np

from .generators import (
    CURVE_REGISTRY,
    hilbert_curve,
    moore_curve,
    onion_curve,
    peano_curve,
    raster_curve,
    z_curve,
)

Cell = Tuple[int, int]

__all__ = ["grid_size", "embed_and_prune_sfc"]

_BASE2 = {hilbert_curve, z_curve, moore_curve, raster_curve}


def _resolve(sfc) -> Callable:
    return CURVE_REGISTRY[sfc] if isinstance(sfc, str) else sfc


def grid_size(order: int, sfc) -> int:
    """Side length of the grid a curve of ``order`` covers.

    Matches reference ``grid_size`` (``space_filling_curves.py:458-468``),
    including the onion convention (even-rounded order, even though
    ``onion_curve`` itself doubles the order -- see the caveat on
    ``embed_and_prune_sfc``).
    """
    fn = _resolve(sfc)
    if fn in _BASE2:
        return 2 ** order
    if fn is peano_curve:
        return 3 ** order
    if fn is onion_curve:
        return order + (order % 2)
    raise ValueError(f"Unknown SFC: {getattr(fn, '__name__', fn)!r}")


def embed_and_prune_sfc(sfc, width: int, height: int) -> List[Cell]:
    """Embed a curve into a W x H rectangle and prune out-of-domain cells.

    Reference: ``space_filling_curves.py:471-491``.  Returns the ordered
    list of integer (i, j) cells with 0 <= i < width, 0 <= j < height.

    Caveat reproduced from the reference: for ``onion_curve`` the internal
    order-doubling makes the generated grid finer than ``grid_size``
    reports, so pruned cells are *not* unique; the LUTs use the direct
    spiral walk in :func:`sfc_vit_tpu_torch.curves.luts.onion_cells`.
    """
    fn = _resolve(sfc)
    order = 0
    while grid_size(order, fn) < max(width, height):
        order += 1
    p = grid_size(order, fn)
    raw = np.asarray(fn(order, size=float(p)), dtype=np.float64)
    cells = np.floor(raw).astype(np.int64)
    keep = (
        (cells[:, 0] >= 0)
        & (cells[:, 0] < width)
        & (cells[:, 1] >= 0)
        & (cells[:, 1] < height)
    )
    return [tuple(c) for c in cells[keep].tolist()]
