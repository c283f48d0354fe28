"""The arithmetic of #14's fp32 kernel (``csrc/gather_project_f32.cu``)
emulated in plain PyTorch on the CPU, against the JAX package's Pallas
``gather_project`` in interpret mode and against fp64.

The kernel gathers each output token's grouped rows through the LUT
(slot-major: feature ``p * K + kk`` is ``x[lut[i * group + p], kk]``),
multiplies them by W as three TF32 products (3xTF32: each operand split
into big = TF32-rounded and small = the rest, truncated to TF32 by the
tensor cores; a_big w_small + a_small w_big + a_big w_big) and adds the
bias to the fp32 sum.  ``kernel_utils.matmul_3xtf32`` is that product
with each term exact in fp64, so what differs from the exact product is
the split's error alone.  Shapes: the notebook's fused 2-D tokenizer
(64 patches of 48 features, group 1) at batch 2, the 1-D tokenizer at
patch 4 (1,024 pixels of 3 in groups of 4), the flagship's three levels
cut to a 16 px image and a ragged one (K 5 in groups of 3, D 301).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfc_vit_tpu.ops import gather_project as jgp
from sfc_vit_tpu_torch.ops.kernel_utils import matmul_3xtf32, tf32_trunc

#: The split's error against the exact product, relative to |a| @ |w|
#: (tests/test_torch_tf32_split.py: 1.25 x 2^-20 at most).
SPLIT_BOUND = 2.0 ** -19
#: The port's fp32 gate, of the largest |value|.
F32_TOL = 1e-4

#: (n, k, m, group, d): the notebook's 2-D tokenizer, the 1-D tokenizer at
#: patch 4, the flagship's levels at 16 px (64 pixels x 3 in groups of 16,
#: 16 pre-patches x 12 in groups of 4, 4 x 48 in groups of 1) and a ragged
#: shape.
SHAPES = [(64, 48, 64, 1, 256), (1024, 3, 256, 4, 256), (64, 3, 4, 16, 256),
          (16, 12, 4, 4, 256), (4, 48, 4, 1, 256), (50, 5, 16, 3, 301)]


def _inputs(seed, n, k, m, group, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, n, k)).astype(np.float32)
    lut = rng.permutation(n)[:m * group].astype(np.int32)
    w = (rng.standard_normal((group * k, d)) * (group * k) ** -0.5).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    return x, lut, w, b


def _grouped(x, lut, group):
    """[B, N, K] -> the gathered, grouped [B, M, group * K] (slot-major)."""
    g = torch.from_numpy(x)[:, torch.from_numpy(lut).long()]
    return g.reshape(x.shape[0], lut.size // group, group * x.shape[2])


def emulate(x, lut, w, b, group):
    """The kernel's output: the 3xTF32 product of the gathered rows and W,
    then the fp32 bias added to the fp32 sum."""
    a = _grouped(x, lut, group)
    return matmul_3xtf32(a, torch.from_numpy(w)).float() + torch.from_numpy(b)


@pytest.fixture(params=SHAPES, ids=lambda s: "x".join(map(str, s)))
def case(request):
    n, k, m, group, d = request.param
    return _inputs(sum(request.param), n, k, m, group, d), group


def test_emulated_kernel_matches_jax(case):
    """The emulated kernel against JAX's Pallas kernel (interpret mode, an
    fp32 sum with the bias added to it), within F32_TOL of the largest
    |value|."""
    (x, lut, w, b), group = case
    want = np.asarray(jgp.gather_project(jnp.asarray(x), jnp.asarray(lut), jnp.asarray(w),
                                         jnp.asarray(b), interpret=True, group=group))
    got = emulate(x, lut, w, b, group).numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= F32_TOL * float(np.abs(want).max())


def test_product_within_the_split_bound(case):
    """The 3xTF32 product against the fp64 product: within SPLIT_BOUND of
    |A| @ |W| element by element; one TF32 product of the same operands is
    not (the split is what buys fp32 accuracy)."""
    (x, lut, w, _), group = case
    a, wt = _grouped(x, lut, group), torch.from_numpy(w)
    exact = a.double() @ wt.double()
    mag = a.double().abs() @ wt.double().abs()
    assert bool(((matmul_3xtf32(a, wt) - exact).abs() <= SPLIT_BOUND * mag).all())
    one = tf32_trunc(a).double() @ tf32_trunc(wt).double()
    assert bool(((one - exact).abs() > SPLIT_BOUND * mag).any())
