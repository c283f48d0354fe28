"""Space-filling-curve point generators (host-side, numpy only).

A copy of ``sfc_vit_tpu/curves/generators.py``: the port keeps its own
curve layer so that it never imports the JAX package.  The generators
run once at model build; their output becomes a static int64 gather
index, a buffer of the module that uses it.

Protocol (the reference's ``src/curves/space_filling_curves.py``): every
generator takes ``(order, size=1.0)`` and returns an ordered list of
``(x, y)`` float cell-center points covering a ``P x P`` grid scaled to
``[0, size]^2``.  The orderings are bit-exact with the reference
generators, including their mirror/rotation orientation conventions
(``tests/test_torch_curves.py`` holds this copy byte-equal to the JAX
package's LUTs); the float values are exact half-integer cell centers.

Implementation notes:
  * Hilbert / Moore use a single integer-frame recursion emitting integer
    cells directly (no float geometry).
  * Z-order is a closed-form vectorized bit computation (no recursion).
  * Peano uses a flip-bit formulation of the reference's 4-pattern table.
  * Onion is an iterative ring walk.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, List, Tuple

import numpy as np

Point = Tuple[float, float]

__all__ = [
    "hilbert_curve",
    "moore_curve",
    "z_curve",
    "peano_curve",
    "onion_curve",
    "raster_curve",
    "CURVE_REGISTRY",
    "curve_cells",
]


# ---------------------------------------------------------------------------
# Hilbert / Moore: integer frame recursion
# ---------------------------------------------------------------------------
#
# A "frame" is (x0, y0, xi, xj, yi, yj): the curve fills the parallelogram
# spanned by vectors (xi, xj) and (yi, yj) anchored at (x0, y0).  At the
# leaf, the visited cell is the integer cell containing the frame center
# x0 + (xi+yi)/2 (with xi+yi = +-1 at depth 0, so the cell is x0 or x0-1).
# All arithmetic stays in ints.


def _hilbert_cells(x0: int, y0: int, xi: int, xj: int, yi: int, yj: int,
                   n: int, out: list) -> None:
    if n <= 0:
        sx = xi + yi  # one of {+1, -1} at the leaf
        sy = xj + yj
        out.append((x0 + (sx - 1) // 2, y0 + (sy - 1) // 2))
        return
    hxi, hxj, hyi, hyj = xi // 2, xj // 2, yi // 2, yj // 2
    _hilbert_cells(x0, y0, hyi, hyj, hxi, hxj, n - 1, out)
    _hilbert_cells(x0 + hxi, y0 + hxj, hxi, hxj, hyi, hyj, n - 1, out)
    _hilbert_cells(x0 + hxi + hyi, y0 + hxj + hyj, hxi, hxj, hyi, hyj,
                   n - 1, out)
    _hilbert_cells(x0 + hxi + yi, y0 + hxj + yj, -hyi, -hyj, -hxi, -hxj,
                   n - 1, out)


@lru_cache(maxsize=None)
def _hilbert_int(order: int) -> Tuple[Tuple[int, int], ...]:
    """Integer Hilbert cells on a 2^order grid, reference orientation.

    The reference applies mirror([[-1,0],[0,1]]) @ rot(pi/2) after its
    float recursion, which is exactly an (x, y) swap; we fold that in here.
    """
    p = 1 << order
    raw: list = []
    _hilbert_cells(0, 0, p, 0, 0, p, order, raw)
    return tuple((y, x) for x, y in raw)


@lru_cache(maxsize=None)
def _moore_int(order: int) -> Tuple[Tuple[int, int], ...]:
    """Integer Moore cells (closed Hilbert loop), reference orientation.

    Four rotated Hilbert sub-curves stitched into a loop
    (cf. ``space_filling_curves.py:233-245``); the reference's final
    rot(2*pi) transform is the identity.
    """
    p = 1 << order
    h = p // 2
    out: list = []
    if order <= 0:
        out.append((0, 0))
        return tuple(out)
    _hilbert_cells(h, 0, -h, 0, 0, h, order - 1, out)
    _hilbert_cells(h, h, -h, 0, 0, h, order - 1, out)
    _hilbert_cells(h, p, h, 0, 0, -h, order - 1, out)
    _hilbert_cells(h, h, h, 0, 0, -h, order - 1, out)
    return tuple(out)


# ---------------------------------------------------------------------------
# Z-order / Morton: closed form
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _z_int(order: int) -> Tuple[Tuple[int, int], ...]:
    """Integer Z-order cells, reference orientation.

    The reference recursion visits quadrants in (TR, TL, BR, BL) order
    (``space_filling_curves.py:153-156``) with an identity final
    transform, so per 2-bit digit k (MSB first): dx = 1 - (k & 1),
    dy = k >> 1.  The curve therefore starts at grid corner (P-1, 0),
    not (0, 0).
    """
    n = 1 << (2 * order)
    d = np.arange(n, dtype=np.int64)
    x = np.zeros(n, dtype=np.int64)
    y = np.zeros(n, dtype=np.int64)
    for level in range(order):
        k = (d >> (2 * level)) & 3
        x |= (1 - (k & 1)) << level
        y |= (k >> 1) << level
    return tuple(zip(x.tolist(), y.tolist()))


# ---------------------------------------------------------------------------
# Peano: flip-bit recursion
# ---------------------------------------------------------------------------
#
# The reference's four orientation patterns (``space_filling_curves.py:
# 95-108``) are the S-traversal of the 3x3 macro cell under horizontal
# (fx) / vertical (fy) flips, with the child's fx toggled on odd traversal
# steps and the generated sub-sequence reversed on middle-column steps.


def _peano_cells(cx: int, cy: int, step: int, n: int, fx: int, fy: int,
                 out: list) -> None:
    if n == 0:
        out.append((cx, cy))
        return
    sub = step // 3
    for idx in range(9):
        r, c = idx // 3, idx % 3
        dx = c if (r % 2 == 0) else 2 - c
        dy = r
        if fx:
            dx = 2 - dx
        if fy:
            dy = 2 - dy
        child: list = []
        _peano_cells(cx + dx * sub, cy + dy * sub, sub, n - 1,
                     fx ^ (idx & 1), fy, child)
        if idx % 3 == 1:
            child.reverse()
        out.extend(child)


@lru_cache(maxsize=None)
def _peano_int(order: int) -> Tuple[Tuple[int, int], ...]:
    """Integer Peano cells on a 3^order grid, reference orientation.

    The reference's final mirror @ rot(pi/2) transform is an (x, y) swap,
    folded in here.
    """
    p = 3 ** order
    raw: list = []
    _peano_cells(0, 0, p, order, 0, 0, raw)
    return tuple((y, x) for x, y in raw)


# ---------------------------------------------------------------------------
# Onion (concentric rings) and raster
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _onion_int(order: int) -> Tuple[Tuple[int, int], ...]:
    """Integer onion cells: clockwise rings from the outside in.

    NOTE: the reference doubles the requested order
    (``space_filling_curves.py:21``), so this builds a (2*order)x(2*order)
    grid.  Ring traversal: bottom row L->R, right column B->T, top row
    R->L, left column T->B, then recurse inward.
    """
    j = 2 * order
    out: list = []
    lo, hi = 0, j - 1
    while lo < hi:
        for x in range(lo, hi + 1):
            out.append((x, lo))
        for y in range(lo + 1, hi + 1):
            out.append((hi, y))
        for x in range(hi - 1, lo - 1, -1):
            out.append((x, hi))
        for y in range(hi - 1, lo, -1):
            out.append((lo, y))
        lo += 1
        hi -= 1
    if lo == hi:
        out.append((lo, lo))
    return tuple(out)


# ---------------------------------------------------------------------------
# Public float-point protocol (reference-compatible)
# ---------------------------------------------------------------------------


def _scale(cells, p: int, size: float) -> List[Point]:
    cell = size / p
    half = cell / 2.0
    return [(x * cell + half, y * cell + half) for x, y in cells]


def hilbert_curve(order: int, size: float = 1.0) -> List[Point]:
    """Hilbert curve points on a 2^order grid scaled to [0, size]^2.

    Ordering bit-exact with the reference ``hilbert_curve``
    (``space_filling_curves.py:168-202``); 4x4 starts
    (0,0),(1,0),(1,1),(0,1),(0,2),... and ends at (3,0).
    """
    order = int(order)
    return _scale(_hilbert_int(order), 1 << order, size)


def moore_curve(order: int, size: float = 1.0) -> List[Point]:
    """Moore curve (closed Hilbert loop); cf. ``space_filling_curves.py:205-251``."""
    order = int(order)
    return _scale(_moore_int(order), 1 << order, size)


def z_curve(order: int, size: float = 1.0) -> List[Point]:
    """Z-order / Morton curve; cf. ``space_filling_curves.py:134-165``."""
    order = int(order)
    return _scale(_z_int(order), 1 << order, size)


def peano_curve(order: int, size: float = 1.0) -> List[Point]:
    """Peano curve on a 3^order grid; cf. ``space_filling_curves.py:74-131``."""
    order = int(order)
    return _scale(_peano_int(order), 3 ** order, size)


def onion_curve(order: int, size: float = 1.0) -> List[Point]:
    """Onion (spiral ring) curve; cf. ``space_filling_curves.py:9-71``.

    Like the reference, the order is doubled internally, so the grid is
    (2*order)x(2*order) and the point count is 4*order^2.  Order 0 is
    the empty grid and returns [] (the reference raises
    ZeroDivisionError scaling by the zero grid side -- bug, fixed).
    """
    order = int(order)
    if order == 0:
        return []
    return _scale(_onion_int(order), 2 * order, size)


def raster_curve(order: int, size: float = 1.0) -> List[Point]:
    """Row-major raster scan on a 2^order grid; cf. ``space_filling_curves.py:254-271``."""
    order = int(order)
    p = 1 << order
    cells = [(x, y) for y in range(p) for x in range(p)]
    return _scale(cells, p, size)


#: name -> generator, the declarative replacement for the reference's
#: comment-toggled registry dicts (``main.py:232-250``).
CURVE_REGISTRY: dict[str, Callable[..., List[Point]]] = {
    "hilbert": hilbert_curve,
    "moore": moore_curve,
    "z": z_curve,
    "morton": z_curve,
    "peano": peano_curve,
    "onion": onion_curve,
    "raster": raster_curve,
}


def curve_cells(name_or_fn, order: int) -> np.ndarray:
    """Integer (x, y) cell sequence for a curve, shape [P*P, 2] int32.

    Fast path used by LUT builders -- avoids the float protocol entirely.
    """
    fn = CURVE_REGISTRY[name_or_fn] if isinstance(name_or_fn, str) else name_or_fn
    table = {
        hilbert_curve: _hilbert_int,
        moore_curve: _moore_int,
        z_curve: _z_int,
        peano_curve: _peano_int,
        onion_curve: _onion_int,
    }
    if fn in table:
        return np.asarray(table[fn](int(order)), dtype=np.int32)
    if fn is raster_curve:
        p = 1 << int(order)
        g = np.arange(p * p, dtype=np.int32)
        return np.stack([g % p, g // p], axis=1)
    pts = fn(order)
    return np.floor(np.asarray(pts, dtype=np.float64) * _infer_grid(fn, order)).astype(np.int32)


def _infer_grid(fn, order: int) -> int:
    if fn is peano_curve:
        return 3 ** int(order)
    if fn is onion_curve:
        return 2 * int(order)
    return 1 << int(order)
