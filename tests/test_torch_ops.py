"""The port's ops (sfc_vit_tpu_torch) against the JAX package's.

Inputs come from ``np.random.default_rng`` and go through both packages.
The JAX side runs as its own tests run it on the CPU: the XLA formulas,
and the Pallas kernels in interpret mode.  On the CPU the port's fused
wrappers run their plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfc_vit_tpu.curves import flat_lut
from sfc_vit_tpu.models import posemb as jposemb
from sfc_vit_tpu.ops import fused_attention_block as jfab
from sfc_vit_tpu.ops import fused_mlp as jmlp
from sfc_vit_tpu.ops.kernel_utils import ln_fp32 as jln_fp32
from sfc_vit_tpu.tokenizers import embeddings as jemb
from sfc_vit_tpu_torch.models import posemb
from sfc_vit_tpu_torch.ops import (
    attention_block_ref,
    fused_attention_block,
    fused_mlp_block,
    ln_fp32,
    mlp_block_ref,
)
from sfc_vit_tpu_torch.tokenizers import curve_gather, patchify

# tests/test_fused_attention_block.py's tolerances: fp32 agrees to
# summation order, bf16 to a few ulps at |x| ~ 4.
TOL = {np.float32: dict(rtol=3e-5, atol=3e-5),
       "bfloat16": dict(rtol=4e-2, atol=4e-2)}


def _np_args(rng, shapes_scales):
    return [rng.standard_normal(s).astype(np.float32) * sc + off
            for s, sc, off in shapes_scales]


def _mlp_np(seed=0, b=2, n=49, d=128, f=256):
    return _np_args(np.random.default_rng(seed), [
        ((b, n, d), 1.0, 0.0), ((d,), 0.1, 1.0), ((d,), 0.1, 0.0),
        ((d, f), d ** -0.5, 0.0), ((f,), 0.1, 0.0),
        ((f, d), f ** -0.5, 0.0), ((d,), 0.1, 0.0)])


def _attn_np(seed=0, b=2, n=64, d=128, heads=2, dh=64):
    inner = heads * dh
    return _np_args(np.random.default_rng(seed), [
        ((b, n, d), 1.0, 0.0), ((d,), 0.1, 1.0), ((d,), 0.1, 0.0),
        ((d, 3 * inner), d ** -0.5, 0.0), ((inner, d), inner ** -0.5, 0.0)])


def _to_jax(args, dtype):
    return [jnp.asarray(a, dtype) for a in args]


def _to_torch(args, dtype):
    return [torch.from_numpy(a).to(dtype) for a in args]


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


# -- (a) the fused blocks ----------------------------------------------


@pytest.mark.parametrize("port_fn", [mlp_block_ref, fused_mlp_block])
def test_mlp_matches_xla_fp32(port_fn):
    args = _mlp_np()
    want = jmlp.mlp_block_xla(*_to_jax(args, jnp.float32))
    got = port_fn(*_to_torch(args, torch.float32))
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[np.float32])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_pallas_interpret(dtype):
    args = _mlp_np(seed=1)
    want = jmlp.fused_mlp_block(*_to_jax(args, getattr(jnp, dtype)),
                                interpret=True)
    got = fused_mlp_block(*_to_torch(args, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = TOL["bfloat16"] if dtype == "bfloat16" else TOL[np.float32]
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


@pytest.mark.parametrize("n_actual", [None, 49])
@pytest.mark.parametrize("port_fn", [attention_block_ref, fused_attention_block])
def test_attention_matches_xla_fp32(port_fn, n_actual):
    args = _attn_np()
    want = jfab.attention_block_xla(*_to_jax(args, jnp.float32), heads=2,
                                    n_actual=n_actual)
    got = port_fn(*_to_torch(args, torch.float32), heads=2, n_actual=n_actual)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[np.float32])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_pallas_interpret_n_actual(dtype):
    """N=64 with 49 real tokens: pad keys masked, real rows compared (pad
    rows are don't-care in the kernel, identity in the plain version)."""
    args = _attn_np(seed=2)
    want = jfab.fused_attention_block(*_to_jax(args, getattr(jnp, dtype)),
                                      2, interpret=True, n_actual=49)
    got = fused_attention_block(*_to_torch(args, getattr(torch, dtype)),
                                heads=2, n_actual=49)
    tol = TOL["bfloat16"] if dtype == "bfloat16" else TOL[np.float32]
    np.testing.assert_allclose(_f32(got)[:, :49], _f32(want)[:, :49], **tol)


def test_attention_rejects_truncating_width():
    args = _to_torch(_attn_np(d=16, heads=2, dh=8), torch.float32)
    with pytest.raises(ValueError, match="divisible"):
        attention_block_ref(*args, heads=5)


# -- (b) LayerNorm, tokenizer front end, positional tables ---------------


@pytest.mark.parametrize("shape", [(3, 7, 48), (5, 768)])
def test_ln_fp32_matches_jax(shape):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32) * 3 + 0.5
    s = rng.standard_normal(shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    want = jln_fp32(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    got = ln_fp32(*(torch.from_numpy(a) for a in (x, s, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hw, c, p", [(28, 3, 4), (32, 1, 8), (16, 3, 16)])
def test_patchify_matches_jax(hw, c, p):
    x = np.random.default_rng(4).standard_normal((2, hw, hw, c)).astype(np.float32)
    want = np.asarray(jemb.patchify(jnp.asarray(x), p))
    np.testing.assert_array_equal(patchify(torch.from_numpy(x), p).numpy(), want)


@pytest.mark.parametrize("curve, grid", [("hilbert", 7), ("hilbert", 14), ("peano", 9)])
def test_curve_gather_matches_jax(curve, grid):
    lut = flat_lut(curve, grid)
    x = np.random.default_rng(5).standard_normal((2, grid * grid, 5)).astype(np.float32)
    want = np.asarray(jemb.curve_gather(jnp.asarray(x), lut))
    got = curve_gather(torch.from_numpy(x), torch.from_numpy(lut.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n, dim", [(49, 128), (196, 768)])
def test_sincos_1d_matches_jax(n, dim):
    np.testing.assert_array_equal(posemb.sincos_1d(n, dim),
                                  jposemb.sincos_1d(n, dim))


@pytest.mark.parametrize("grid, dim", [(7, 128), (14, 768)])
def test_gfpe_matches_jax(grid, dim):
    pos = flat_lut("hilbert", grid).astype(np.float32)
    np.testing.assert_array_equal(posemb.gfpe(pos, dim), jposemb.gfpe(pos, dim))
