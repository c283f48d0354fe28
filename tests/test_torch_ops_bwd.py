"""The port's backward blocks against the JAX package's.

``mlp_block_bwd_ref`` and ``attention_block_bwd_ref`` (the plain versions
of the CUDA backward chains) are held against the Pallas backward kernels
``_fused_mlp_bwd`` / ``_fused_attn_block_bwd`` run in interpret mode, fed
the tensors the Pallas training forwards saved.  The port's
differentiable blocks are held against ``jax.vjp`` of the JAX blocks on
their Pallas training rule, and against torch autograd of the plain
forward.  Inputs come from ``np.random.default_rng``; shapes are small
(D 128, F 256, 2 heads of 64, N <= 40) to keep Pallas interpret mode
cheap on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfc_vit_tpu.ops import fused_attention_block as jfab
from sfc_vit_tpu.ops import fused_mlp as jmlp
from sfc_vit_tpu_torch.ops import (
    attention_block_bwd_ref,
    attention_block_ref,
    attention_fwd_ref,
    fused_attention_block,
    fused_mlp_block,
    mlp_block_bwd_ref,
    mlp_block_ref,
)

# fp32: summation order only (and the Pallas kernels' polynomial erf,
# max abs error 1.5e-7).
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 saved tensors and bf16 rounding of dz / pn / ds / dqkv inside:
# a sum taken in another order can round to the neighbouring bf16 value
# (one ulp, 2^-8 relative).  Measured here: at most one ulp of an output
# (0.0625 on dw1 at |dw1| up to 20.6).
BF16_TOL = dict(rtol=1e-2, atol=1e-2)

B, N, D, F, HEADS = 2, 40, 128, 256, 2
MLP_NAMES = ("dx", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2")
ATTN_NAMES = ("dx", "dln_scale", "dln_bias", "dw_qkv", "dw_out")


def _np(rng, shape, scale=1.0, shift=0.0):
    return rng.standard_normal(shape).astype(np.float32) * scale + shift


def _mlp_np(seed, n=N):
    rng = np.random.default_rng(seed)
    return [_np(rng, (B, n, D)), _np(rng, (D,), 0.1, 1.0), _np(rng, (D,), 0.1),
            _np(rng, (D, F), D ** -0.5), _np(rng, (F,), 0.1),
            _np(rng, (F, D), F ** -0.5), _np(rng, (D,), 0.1)], _np(rng, (B, n, D))


def _attn_np(seed, n=N):
    rng = np.random.default_rng(seed)
    inner = HEADS * 64
    return [_np(rng, (B, n, D)), _np(rng, (D,), 0.1, 1.0), _np(rng, (D,), 0.1),
            _np(rng, (D, 3 * inner), D ** -0.5),
            _np(rng, (inner, D), inner ** -0.5)], _np(rng, (B, n, D))


def _t(a, dtype):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


def _close(got, want, names, tol):
    for name, a, b in zip(names, got, want):
        a = a.detach().float().numpy()
        b = np.asarray(jnp.asarray(b, jnp.float32))
        np.testing.assert_allclose(a, b, err_msg=name, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_bwd_ref_matches_pallas_bwd(dtype):
    args, g = _mlp_np(0)
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in args]
    jg = jnp.asarray(g, getattr(jnp, dtype))
    kw = dict(eps=1e-5, activation="gelu", residual=True, interpret=True)
    _, z = jmlp._fused_mlp(*jargs, save_z=True, **kw)
    want = jmlp._fused_mlp_bwd(jargs[0], jg, *jargs[1:6], z=z, b2=jargs[6], **kw)
    tdt = getattr(torch, dtype)
    x, ls, lb, w1, b1, w2, b2 = (_t(a, tdt) for a in jargs)
    got = mlp_block_bwd_ref(x, _t(jg, tdt), ls, lb, w1, b1, w2, _t(z, tdt), b2)
    assert [t.dtype for t in got] == [tdt] * 7
    _close(got, want, MLP_NAMES, F32_TOL if dtype == "float32" else BF16_TOL)


def _jax_attn_saved(jargs, n_actual):
    """The Pallas training forward's qkv, att and lse, cut from its
    padded token axis (196 -> 208 style) to the port's layout."""
    n = jargs[0].shape[1]
    _, qkv, att, lse = jfab._fused_attn_block(
        *jargs, heads=HEADS, scale=64 ** -0.5, eps=1e-5, interpret=True,
        n_actual=n_actual, save_acts=True, save_lse=True)
    return qkv[:, :n], att[:, :n], jnp.transpose(lse[:, :n, :HEADS], (0, 2, 1)), (qkv, att, lse)


@pytest.mark.parametrize("dtype, n, n_actual", [
    ("float32", 40, None), ("float32", 40, 29), ("float32", 32, None),
    ("bfloat16", 40, 29),
])
def test_attention_bwd_ref_matches_pallas_bwd(dtype, n, n_actual):
    """n = 40 is not a multiple of 16 (the JAX kernels pad it to 48);
    with n_actual the real rows are compared and pad rows pass g through."""
    args, g = _attn_np(1, n)
    jdt = getattr(jnp, dtype)
    jargs = [jnp.asarray(a, jdt) for a in args]
    jg = jnp.asarray(g, jdt)
    qkv, att, lse, saved = _jax_attn_saved(jargs, n_actual)
    want = jfab._fused_attn_block_bwd(
        jargs[0], jg, *jargs[1:], heads=HEADS, scale=64 ** -0.5, eps=1e-5,
        interpret=True, n_actual=n_actual, qkv=saved[0], att=saved[1],
        lse=saved[2])
    tdt = getattr(torch, dtype)
    x, ls, lb, wq, wo = (_t(a, tdt) for a in jargs)
    got = attention_block_bwd_ref(x, _t(jg, tdt), ls, lb, wq, wo, _t(qkv, tdt),
                                  _t(att, tdt), _t(lse, torch.float32), HEADS,
                                  n_actual=n_actual)
    assert [t.dtype for t in got] == [tdt] * 5
    _close(got, want, ATTN_NAMES, F32_TOL if dtype == "float32" else BF16_TOL)


def test_attention_fwd_ref_lse_matches_pallas_save_lse():
    args, _ = _attn_np(2)
    jargs = [jnp.asarray(a) for a in args]
    qkv, att, lse, _ = _jax_attn_saved(jargs, 29)
    got_att, got_lse = attention_fwd_ref(_t(qkv, torch.float32), HEADS, 29,
                                         64 ** -0.5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), **F32_TOL)
    np.testing.assert_allclose(got_att.numpy()[:, :29], np.asarray(att)[:, :29],
                               **F32_TOL)


def _port_grads(fn, args, g, **kw):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    fn(*leaves, **kw).backward(torch.from_numpy(g))
    return [t.grad for t in leaves]


def test_fused_mlp_grads_match_jax_vjp_and_autograd():
    args, g = _mlp_np(3)
    _, vjp = jax.vjp(
        lambda *a: jmlp.fused_mlp_block(*a, interpret=True, train_impl="pallas"),
        *[jnp.asarray(a) for a in args])
    want = vjp(jnp.asarray(g))
    got = _port_grads(fused_mlp_block, args, g)
    _close(got, want, MLP_NAMES, F32_TOL)
    _close(got, _port_grads(mlp_block_ref, args, g), MLP_NAMES, F32_TOL)


@pytest.mark.parametrize("n_actual", [None, 29])
def test_fused_attention_grads_match_jax_vjp_and_autograd(n_actual):
    args, g = _attn_np(4)
    _, vjp = jax.vjp(
        lambda *a: jfab.fused_attention_block(
            *a, HEADS, interpret=True, n_actual=n_actual, train_impl="pallas"),
        *[jnp.asarray(a) for a in args])
    want = vjp(jnp.asarray(g))
    got = _port_grads(fused_attention_block, args, g, heads=HEADS,
                      n_actual=n_actual)
    _close(got, want, ATTN_NAMES, F32_TOL)
    _close(got, _port_grads(attention_block_ref, args, g, heads=HEADS,
                            n_actual=n_actual), ATTN_NAMES, F32_TOL)


def test_bf16_grads_come_back_in_input_dtypes():
    """Weights and x in bf16, LN params and biases in fp32 (as the model
    passes them): every gradient in its input's dtype, finite."""
    args, g = _mlp_np(5)
    dts = (torch.bfloat16, torch.float32, torch.float32, torch.bfloat16,
           torch.float32, torch.bfloat16, torch.float32)
    leaves = [torch.from_numpy(a).to(dt).requires_grad_() for a, dt in zip(args, dts)]
    fused_mlp_block(*leaves).backward(torch.from_numpy(g).bfloat16())
    for t, dt in zip(leaves, dts):
        assert t.grad.dtype == dt and torch.isfinite(t.grad.float()).all()
