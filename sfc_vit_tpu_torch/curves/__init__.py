"""The port's curve layer: SFC generators, the rectangle embedding and the
LUT factories.

Host-side and numpy-only, copied from ``sfc_vit_tpu/curves`` so that the
port never imports the JAX package.  What no path of the port needs
stays there: the Hamiltonian refinement (``hamiltonian.py``,
``native.py`` and ``csrc/hamiltonian.cpp``), the locality metrics
(``metrics.py``) and the block-stitch generalizer.
"""

from .generalize import embed_and_prune_sfc, grid_size
from .generators import (
    CURVE_REGISTRY,
    curve_cells,
    hilbert_curve,
    moore_curve,
    onion_curve,
    peano_curve,
    raster_curve,
    z_curve,
)
from .luts import (
    curve_coords,
    flat_lut,
    flat_lut_2d,
    inverse_permutation,
    onion_cells,
    onion_flat_lut,
    pixel_lut,
)

__all__ = [
    "CURVE_REGISTRY",
    "curve_cells",
    "curve_coords",
    "embed_and_prune_sfc",
    "flat_lut",
    "flat_lut_2d",
    "grid_size",
    "hilbert_curve",
    "inverse_permutation",
    "moore_curve",
    "onion_cells",
    "onion_curve",
    "onion_flat_lut",
    "peano_curve",
    "pixel_lut",
    "raster_curve",
    "z_curve",
]
