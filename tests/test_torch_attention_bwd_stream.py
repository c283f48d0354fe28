"""The bf16 attention backward of #4 and #6 in the streamed form's regime
(``csrc/attention_bwd_stream_sm90.cu``: several 64-row tiles with a ragged
last one, head dims 128 and 256 past one tile) against the JAX package's
Pallas backward kernels in interpret mode, on the CPU.

The port's plain versions (``attention_bwd_ref`` inside the backward
chains ``attention_block_bwd_ref`` and ``torch_mha_bwd_ref``) are fed the
qkv, att and lse that JAX's Pallas training forwards save
(``_fused_attn_block(..., save_acts=True, save_lse=True)``,
``_torch_mha(..., save_acts=True)``) and held against
``_fused_attn_block_bwd`` / ``_torch_mha_bwd``; the port's differentiable
ops (``fused_attention_block``, ``fused_torch_mha``) against ``jax.vjp``
of JAX's on their Pallas training rule.  Dh 64 at 130 tokens with 127
valid (three tiles, the last of two rows), Dh 128 at 70 with 67 and Dh 256
at 65 (two tiles), with #6's 0/1 mask and keep and without it (#4).  The
kernels themselves are held to these plain versions on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``'s streamed-backward
phase).  Inputs come from ``np.random.default_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfc_vit_tpu.ops import fused_attention_block as jfab
from sfc_vit_tpu.ops import fused_torch_attention as jfta
from sfc_vit_tpu_torch.ops import fused_attention_block, fused_torch_mha
from sfc_vit_tpu_torch.ops.fused_attention_block import attention_block_bwd_ref
from sfc_vit_tpu_torch.ops.fused_torch_attention import torch_mha_bwd_ref

#: fp32: summation order only (PERF.md section 2's fp32 gate).
F32_TOL = dict(rtol=1e-4, atol=1e-4)
#: bf16: tests/test_torch_head_dims.py's, a few ulps at |x| ~ 4.
BF16_TOL = dict(rtol=4e-2, atol=4e-2)
KEEP = 0.9
#: (dh, heads, batch, n, n_valid): the streamed form's geometry, small.
SHAPES = [(64, 2, 2, 130, 127), (128, 2, 1, 70, 67), (256, 1, 2, 65, 65)]
#: #4's block: the model width its QKV projection reads.
D = 64
ATTN_NAMES = ("dx", "dln_scale", "dln_bias", "dw_qkv", "dw_out")
MHA_NAMES = ("dx", "dw_in", "db_in", "dw_out", "db_out")


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


def _close(got, want, names, tol):
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(jnp.asarray(b, jnp.float32)), err_msg=name, **tol)


def _block_args(seed, dh, heads, b, n):
    """#4's block: x, LN scale and bias, W_qkv, W_out, and the cotangent."""
    rng = np.random.default_rng(seed)
    inner = heads * dh
    return [_rand(rng, b, n, D), _rand(rng, D, scale=0.1, shift=1.0), _rand(rng, D, scale=0.1),
            _rand(rng, D, 3 * inner, scale=D ** -0.5),
            _rand(rng, inner, D, scale=inner ** -0.5)], _rand(rng, b, n, D)


def _mha_args(seed, dh, heads, b, n):
    """#5/#6's MHA (d = heads dh): x, W_in, b_in, W_out, b_out, the 0/1
    mask and the cotangent."""
    rng = np.random.default_rng(seed)
    d = heads * dh
    args = [_rand(rng, b, n, d), _rand(rng, d, 3 * d, scale=d ** -0.5),
            _rand(rng, 3 * d, scale=0.1), _rand(rng, d, d, scale=d ** -0.5),
            _rand(rng, d, scale=0.1)]
    return args, rng.random((b, heads, n, n)) < KEEP, _rand(rng, b, n, d)


def _saved_lse(lse, n, heads):
    """JAX's saved lse [B, N_pad, H_pad] as the port's [B, H, N]."""
    return jnp.transpose(lse[:, :n, :heads], (0, 2, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh, heads, b, n, n_valid", SHAPES)
def test_block_bwd_ref_matches_jax_pallas_bwd(dh, heads, b, n, n_valid, dtype):
    """#4 without a mask: ``attention_block_bwd_ref`` (``attention_bwd_ref``
    inside) against ``_fused_attn_block_bwd`` on the qkv, att and lse its
    Pallas forward saved (padded to a multiple of 16 tokens there, cut
    back here)."""
    args, g = _block_args(dh + n, dh, heads, b, n)
    jdt = getattr(jnp, dtype)
    jargs = [jnp.asarray(a, jdt) for a in args]
    jg = jnp.asarray(g, jdt)
    s = dh ** -0.5
    _, qkv, att, lse = jfab._fused_attn_block(*jargs, heads=heads, scale=s, eps=1e-5,
                                              interpret=True, n_actual=n_valid,
                                              save_acts=True, save_lse=True)
    want = jfab._fused_attn_block_bwd(jargs[0], jg, *jargs[1:], heads=heads, scale=s, eps=1e-5,
                                      interpret=True, n_actual=n_valid, qkv=qkv, att=att,
                                      lse=lse)
    tdt = getattr(torch, dtype)
    x, ls, lb, wq, wo = (_t(a, tdt) for a in jargs)
    got = attention_block_bwd_ref(x, _t(jg, tdt), ls, lb, wq, wo, _t(qkv[:, :n], tdt),
                                  _t(att[:, :n], tdt), _t(_saved_lse(lse, n, heads)), heads,
                                  n_actual=n_valid)
    assert [t.dtype for t in got] == [tdt] * 5
    _close(got, want, ATTN_NAMES, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh, heads, b, n, n_valid", SHAPES)
def test_mha_bwd_ref_matches_jax_pallas_bwd(dh, heads, b, n, n_valid, dtype):
    """#6 with the 0/1 mask and keep 0.9: ``torch_mha_bwd_ref``
    (``attention_bwd_ref`` with the mask inside) against ``_torch_mha_bwd``
    on the qkv, att and lse its Pallas forward saved."""
    args, mask, g = _mha_args(dh + n + 1, dh, heads, b, n)
    jdt = getattr(jnp, dtype)
    jargs = [jnp.asarray(a, jdt) for a in args]
    jg = jnp.asarray(g, jdt)
    jmask = jnp.asarray(mask, jnp.float32)
    s = dh ** -0.5
    _, qkv, att, lse = jfta._torch_mha(*jargs, jmask, heads=heads, scale=s, keep=KEEP,
                                       interpret=True, n_actual=n_valid, save_acts=True)
    want = jfta._torch_mha_bwd(jargs[0], jg, jargs[1], jargs[3], jmask, qkv, att, lse,
                               heads=heads, scale=s, keep=KEEP, interpret=True,
                               n_actual=n_valid)
    tdt = getattr(torch, dtype)
    got = torch_mha_bwd_ref(_t(jargs[0], tdt), _t(jg, tdt), _t(jargs[1], tdt),
                            _t(jargs[3], tdt), torch.from_numpy(mask), _t(qkv[:, :n], tdt),
                            _t(att[:, :n], tdt), _t(_saved_lse(lse, n, heads)), heads,
                            scale=s, keep=KEEP, n_actual=n_valid)
    want = [w.reshape(t.shape) for w, t in zip(want, got)]
    _close(got, want, MHA_NAMES, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dh, heads, b, n, n_valid", SHAPES)
def test_fused_attention_block_grads_match_jax_vjp(dh, heads, b, n, n_valid):
    """#4 through the port's autograd route (the plain chain for CPU
    tensors) against ``jax.vjp`` of JAX's block on its Pallas training
    rule, fp32."""
    args, g = _block_args(dh + n + 2, dh, heads, b, n)
    _, vjp = jax.vjp(lambda *a: jfab.fused_attention_block(
        *a, heads, interpret=True, n_actual=n_valid, train_impl="pallas"),
        *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    fused_attention_block(*leaves, heads=heads, n_actual=n_valid).backward(torch.from_numpy(g))
    _close([t.grad for t in leaves], want, ATTN_NAMES, F32_TOL)


@pytest.mark.parametrize("dh, heads, b, n, n_valid", SHAPES)
def test_fused_torch_mha_grads_match_jax_vjp(dh, heads, b, n, n_valid):
    """#6 through the port's autograd route against ``jax.vjp`` of JAX's
    ``fused_torch_mha`` on its Pallas training rule, one mask on both
    sides, fp32."""
    args, mask, g = _mha_args(dh + n + 3, dh, heads, b, n)
    _, vjp = jax.vjp(lambda *a: jfta.fused_torch_mha(
        *a, jnp.asarray(mask, jnp.float32), heads, keep=KEEP, interpret=True, n_actual=n_valid,
        train_impl="pallas"), *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    fused_torch_mha(*leaves, torch.from_numpy(mask), heads, keep=KEEP,
                    n_actual=n_valid).backward(torch.from_numpy(g))
    _close([t.grad for t in leaves], want, MHA_NAMES, F32_TOL)
