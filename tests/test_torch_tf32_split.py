"""The 3xTF32 split by which ``csrc/gemm_f32.cu`` runs float32 products on
the tensor cores, in plain PyTorch (``ops/kernel_utils.py``:
``tf32_round``, ``tf32_split``, ``matmul_3xtf32``), on the CPU:

* the rounding against an exact one (fractions) on edge values (ties, a
  carry into the next binade and past the largest finite value,
  subnormals, zeros, inf) and on random bit patterns;
* the split's parts (big a TF32 value, big + small = x exactly, |small|
  <= 2^-11 |x|);
* the three-product sum at ViT-B's widths against the JAX package's fp32
  ``jnp.dot`` of the same inputs (within 1e-4 of its largest |value|, the
  port's fp32 gate) and against the fp64 product, within the split's
  stated bound 2^-19 of |a| @ |b|, which one TF32 product alone misses.

The GPU tests hold the device's ``cvt.rna.tf32.f32`` to ``tf32_round`` and
the kernel's split to ``tf32_split`` bit for bit
(``tests/test_torch_kernels.py::test_tf32_round_matches_plain_bit_for_bit``).
"""

import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfc_vit_tpu_torch.ops.kernel_utils import matmul_3xtf32, tf32_round, tf32_split, tf32_trunc

#: The split's error against the exact product, relative to |a| @ |b|: per
#: operand |small| <= 2^-11 |x| and the tensor cores' truncation of small
#: errs by at most 2^-10 |small| <= 2^-21 |x|, so the two truncations and
#: the dropped a_small b_small stay below (2 x 2^-21 + 2^-22)(1 + 2^-10)
#: < 1.3 x 2^-20 < 2^-19 of |a b|.
SPLIT_BOUND = 2.0 ** -19


def _exact_tf32(v: float) -> float:
    """v rounded to TF32 by exact arithmetic: to the grid of 11
    significant bits (2^-136 below the normal range), ties away from
    zero, inf from 2^128 up."""
    if not math.isfinite(v) or v == 0:
        return v
    _, e = math.frexp(abs(v))  # |v| = m 2^e, 1/2 <= m < 1
    ulp = Fraction(2) ** max(e - 11, -136)
    q = Fraction(abs(v)) / ulp
    n = math.floor(q)
    if q - n >= Fraction(1, 2):
        n += 1
    r = n * ulp
    return math.copysign(math.inf if r >= 2 ** 128 else float(r), v)


def _f32(v: float) -> float:
    return float(np.float32(v))


_EDGES = {
    "tie up": 1 + 2 ** -11, "tie up, negative": -(1 + 2 ** -11),
    "tie at an odd last bit": 1 + 3 * 2 ** -11, "below a tie": 1 + 2 ** -11 - 2 ** -23,
    "above a tie": 1 + 2 ** -11 + 2 ** -23, "into the next binade": 2 - 2 ** -23,
    "into the next binade, negative": -(2 - 2 ** -23),
    "largest finite to inf": 3.4028234663852886e38,
    "largest finite to -inf": -3.4028234663852886e38,
    "the largest TF32 value stays": (2 - 2 ** -10) * 2.0 ** 127,
    "smallest subnormal to 0": 2 ** -149, "subnormal tie": 0x1000 * 2 ** -149,
    "subnormal below a tie": 0xFFF * 2 ** -149, "subnormal up": 0x1FFF * 2 ** -149,
    "largest subnormal to the smallest normal": 0x7FFFFF * 2 ** -149,
    "smallest normal": 2 ** -126, "zero": 0.0, "negative zero": -0.0,
    "inf": math.inf, "-inf": -math.inf,
}


@pytest.mark.parametrize("v", list(_EDGES.values()), ids=list(_EDGES))
def test_tf32_round_edge_values(v):
    v = _f32(v)
    got = tf32_round(torch.tensor([v], dtype=torch.float32))
    want = torch.tensor([_exact_tf32(v)], dtype=torch.float32)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (v, float(got))


def test_tf32_round_random_bit_patterns():
    """20,000 finite fp32 bit patterns (every binade, both signs) against
    the exact rounding, bit for bit."""
    bits = np.random.default_rng(0).integers(0, 2 ** 32, size=40_000, dtype=np.uint64)
    x = bits.astype(np.uint32).view(np.float32)
    x = x[np.isfinite(x)][:20_000]
    got = tf32_round(torch.from_numpy(x)).numpy()
    want = np.array([_exact_tf32(float(v)) for v in x], dtype=np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_tf32_round_nan_clears_the_low_bits():
    """NaN keeps its top bits, the 13 below TF32's mantissa cleared: a NaN
    whose payload lies only there becomes inf (the H100's cvt.rna.tf32.f32,
    held to this by the GPU test)."""
    x = torch.tensor([0x7FC00000, 0x7FC07931, 0x7F800001, -0x007FFFFF], dtype=torch.int32)
    got = tf32_round(x.view(torch.float32)).view(torch.int32)
    assert got.tolist() == [0x7FC00000, 0x7FC06000, 0x7F800000, -0x00800000]


def test_tf32_split_parts():
    """big is a TF32 value (low 13 bits zero), big + small = x exactly in
    fp32, |small| <= 2^-11 |x|, and what the tensor cores take of small
    (tf32_trunc) lies within 2^-21 of |x| of it."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(100_000).astype(np.float32)
                         * np.float32(1e3))
    big, small = tf32_split(x)
    assert not bool((big.view(torch.int32) & 0x1FFF).any())
    assert torch.equal(big + small, x)
    xd, sd = x.double(), small.double()
    assert bool((sd.abs() <= 2 ** -11 * xd.abs()).all())
    assert bool(((sd - tf32_trunc(small).double()).abs() <= 2 ** -21 * xd.abs()).all())


def _operands(k: int, rows: int = 8, cols: int = 96):
    rng = np.random.default_rng(k)
    a = rng.standard_normal((rows, k)).astype(np.float32)
    b = (rng.standard_normal((k, cols)) * k ** -0.5).astype(np.float32)
    return a, b


@pytest.mark.parametrize("k", [768, 3072])
def test_three_products_match_jax_fp32_dot(k):
    """At ViT-B's contraction widths (768: QKV, fc1, dxn; 3,072: fc2), the
    split's sum against the JAX package's fp32 product of the same inputs
    on the CPU, within 1e-4 of its largest |value| (the port's fp32 gate)."""
    a, b = _operands(k)
    got = matmul_3xtf32(torch.from_numpy(a), torch.from_numpy(b)).float().numpy()
    want = np.asarray(jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST))
    assert want.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("k", [768, 3072, 50176])
def test_three_products_within_the_split_bound(k):
    """Against the fp64 product, every element of the split's sum within
    SPLIT_BOUND of |a| @ |b| (50,176: a weight gradient's depth at ViT-B
    batch 256); one TF32 product alone misses that bound."""
    a, b = (torch.from_numpy(t) for t in _operands(k, rows=4, cols=32))
    exact = a.double() @ b.double()
    mag = a.double().abs() @ b.double().abs()
    assert bool(((matmul_3xtf32(a, b) - exact).abs() <= SPLIT_BOUND * mag).all())
    one = tf32_round(a).double() @ tf32_round(b).double()
    assert bool(((one - exact).abs() > SPLIT_BOUND * mag).any())
