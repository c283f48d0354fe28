"""The port's copy of the curve layer against the JAX package's: every LUT
byte-equal, for every registered curve, and the port's import surface
free of the JAX package."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sfc_vit_tpu import curves as jcurves
from sfc_vit_tpu_torch import curves

GRIDS = (2, 4, 8, 14, 16)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_registries_have_the_same_curves():
    assert set(curves.CURVE_REGISTRY) == set(jcurves.CURVE_REGISTRY)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("name", sorted(jcurves.CURVE_REGISTRY))
def test_luts_are_byte_equal(name, grid):
    _same(curves.flat_lut(name, grid), jcurves.flat_lut(name, grid))
    _same(curves.flat_lut_2d(name, grid), jcurves.flat_lut_2d(name, grid))
    _same(curves.pixel_lut(name, grid, grid), jcurves.pixel_lut(name, grid, grid))


@pytest.mark.parametrize("name", sorted(jcurves.CURVE_REGISTRY))
def test_rectangular_coords_and_cells_are_equal(name):
    _same(curves.pixel_lut(name, 6, 10), jcurves.pixel_lut(name, 6, 10))
    _same(curves.curve_coords(name, 5, 7), jcurves.curve_coords(name, 5, 7))
    assert (curves.embed_and_prune_sfc(name, 6, 3)
            == jcurves.embed_and_prune_sfc(name, 6, 3))
    _same(curves.curve_cells(name, 2), jcurves.curve_cells(name, 2))


def test_onion_walk_and_inverse_permutation():
    _same(curves.onion_cells(5, 7), jcurves.onion_cells(5, 7))
    _same(curves.onion_flat_lut(4, 6), jcurves.onion_flat_lut(4, 6))
    lut = curves.flat_lut("hilbert", 8)
    _same(curves.inverse_permutation(lut), jcurves.inverse_permutation(lut))
    assert np.array_equal(lut[curves.inverse_permutation(lut)], np.arange(64))


def test_unknown_curve_raises():
    with pytest.raises(KeyError, match="unknown curve"):
        curves.flat_lut("nope", 4)


def test_port_loads_no_module_of_the_jax_package():
    """Importing every module of the port loads neither jax, flax nor any
    module of the JAX package ``sfc_vit_tpu``."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import sfc_vit_tpu_torch\n"
        "for m in pkgutil.walk_packages(sfc_vit_tpu_torch.__path__, 'sfc_vit_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'jaxlib', 'sfc_vit_tpu'))\n"
        "assert not bad, bad\n"
    )
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
