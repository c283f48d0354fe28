"""The port's post-norm tail (#15, #16) and ``HierarchicalVisionTransformer1D``
against the JAX package on the CPU.

The plain versions of #15 and #16 against ``_postnorm_tail_kernel`` and
``_postnorm_tail_bwd_kernel`` in interpret mode, fed the same tensors; the
autograd route against ``jax.grad``; the unfused formula against
``postnorm_tail_xla``; one ``TorchTransformerEncoderLayer`` with an MLP of
1,024 against JAX's under ``_FORCE_FUSED``; a small hierarchical model's
logits and gradients.  Inputs come from ``np.random.default_rng``, as
``tests/test_fused_mlp.py`` makes them; JAX runs on the CPU.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfc_vit_tpu.ops.fused_mlp as jmlp
from sfc_vit_tpu import registry as jregistry
from sfc_vit_tpu.models import layers as jlayers
from sfc_vit_tpu.models import simple_vit as jsimple_vit
from sfc_vit_tpu_torch.models import HierarchicalVisionTransformer1D
from sfc_vit_tpu_torch.models import layers as port_layers
from sfc_vit_tpu_torch.ops.fused_mlp import (
    fused_postnorm_tail,
    postnorm_tail_bwd_ref,
    postnorm_tail_kernel_ref,
    postnorm_tail_ref,
)
from sfc_vit_tpu_torch.registry import build_model, preset_config
from sfc_vit_tpu_torch.utils import load_flax_params, to_flax_grads, to_flax_params

#: fp32, the kernel's arithmetic on both sides: summation order only
#: (JAX's own kernel-against-formula tolerance).
FWD_TOL = dict(rtol=3e-5, atol=3e-5)
#: fp32 gradients of #16 (JAX's own tolerance for its backward).
BWD_TOL = dict(rtol=3e-4, atol=3e-4)
#: bf16 gradients of #16 at a ragged 100 rows: relative L2 per tensor; one
#: bf16 rounding of ds2 or dz that flips between the two sides moves a
#: weight gradient by ~2^-9 of its share.
BWD_BF16_REL = 1e-2
#: fp32 logits and gradients through a few layers: summation order only.
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)

NAMES = ("ds", "dln1_s", "dln1_b", "dw1", "db1", "dw2", "db2", "dln2_s", "dln2_b")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _tail_inputs(b=2, n=64, d=256, f=1024, seed=0):
    """x, attn, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b (fp32 numpy), as
    ``tests/test_fused_mlp.py::_tail_inputs`` makes them."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (mk(b, n, d), mk(b, n, d), mk(d) * 0.1 + 1.0, mk(d) * 0.1,
            mk(d, f) / np.sqrt(d), mk(f) * 0.1, mk(f, d) / np.sqrt(f), mk(d) * 0.1,
            mk(d) * 0.1 + 1.0, mk(d) * 0.1)


def _both(args, dtype):
    """The same values as JAX arrays and torch tensors of ``dtype``."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16,
                                                                      torch.bfloat16)
    jargs = tuple(jnp.asarray(a, jdt) for a in args)
    return jargs, tuple(_t(np.asarray(a, np.float32)).to(tdt) for a in jargs)


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _close(got, want, dtype, name=""):
    """fp32 within FWD_TOL; bf16 within one bf16 ulp of the largest |value|."""
    got, want = _np(got), _np(want)
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, err_msg=name, **FWD_TOL)
        return
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= _bf16_ulp(top), f"{name}: max abs err {err} > one ulp at {top}"


# -- #15 -----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b, n", [(2, 64), (3, 50)], ids=["rows128", "ragged150"])
def test_kernel_ref_matches_the_tpu_kernel(dtype, b, n):
    """Serving form and training form (out, z, s2) against
    ``_postnorm_tail_kernel`` in interpret mode; 150 rows are padded to 256
    by the TPU wrapper."""
    jargs, targs = _both(_tail_inputs(b=b, n=n), dtype)
    want = jmlp.fused_postnorm_tail(*jargs, interpret=True)
    _close(postnorm_tail_kernel_ref(*targs), want, dtype, "out")
    wout, wz, ws2 = jmlp._postnorm_tail(*jargs, eps=1e-5, activation="relu",
                                        interpret=True, save_acts=True)
    out, z, s2 = postnorm_tail_kernel_ref(*targs, save_acts=True)
    assert z.dtype == s2.dtype == targs[0].dtype and z.shape == (b, n, 1024)
    for name, g, w in (("out", out, wout), ("z", z, wz), ("s2", s2, ws2)):
        _close(g, w, dtype, name)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_unfused_ref_matches_postnorm_tail_xla(dtype):
    """The unfused formula: fp32 to summation order; in bf16 both round
    every sum and product at the same points, and one rounding of an
    intermediate may flip between the two matrix products (XLA's and
    torch's), so within two ulps of the largest |value|."""
    jargs, targs = _both(_tail_inputs(b=1, n=40, d=128, f=256, seed=1), dtype)
    want = _np(jmlp.postnorm_tail_xla(*jargs))
    got = _np(postnorm_tail_ref(*targs))
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, **FWD_TOL)
    else:
        assert np.abs(got - want).max() <= 2 * _bf16_ulp(np.abs(want).max())


def test_cpu_wrapper_runs_the_kernel_ref_and_counts_nothing():
    _, targs = _both(_tail_inputs(b=1, n=8, d=128, f=256), "fp32")
    counts = (fused_postnorm_tail.launches, fused_postnorm_tail.train_launches,
              fused_postnorm_tail.bwd_launches)
    torch.testing.assert_close(fused_postnorm_tail(*targs), postnorm_tail_kernel_ref(*targs),
                               rtol=0, atol=0)
    leaves = [t.clone().requires_grad_() for t in targs]
    fused_postnorm_tail(*leaves).sum().backward()
    assert (fused_postnorm_tail.launches, fused_postnorm_tail.train_launches,
            fused_postnorm_tail.bwd_launches) == counts


# -- #16 -----------------------------------------------------------------------


@pytest.mark.parametrize("dtype, b, n", [("fp32", 2, 64), ("bf16", 1, 100)])
def test_bwd_ref_matches_the_tpu_kernel(dtype, b, n):
    """Fed the same saved z and s2 (from JAX's training forward) and the
    same cotangent: every output of ``_postnorm_tail_bwd`` in interpret
    mode, whose first two (the cotangents of x and attn) are one tensor."""
    args = _tail_inputs(b=b, n=n, seed=2)
    g = np.random.default_rng(3).standard_normal((b, n, 256)).astype(np.float32)
    jargs, targs = _both(args, dtype)
    jg, tg = _both((g,), dtype)
    _, jz, js2 = jmlp._postnorm_tail(*jargs, eps=1e-5, activation="relu",
                                     interpret=True, save_acts=True)
    x, a, l1s, l1b, w1, b1, w2, b2, l2s, l2b = jargs
    want = jmlp._postnorm_tail_bwd(x, a, jg[0], jz, js2, l1s, l1b, w1, b1, w2, l2s, l2b,
                                   eps=1e-5, activation="relu", interpret=True, b2=b2)
    np.testing.assert_array_equal(_np(want[0]), _np(want[1]))
    want = want[1:]
    tz, ts2 = (_t(np.asarray(v, np.float32)).to(targs[0].dtype) for v in (jz, js2))
    x, a, l1s, l1b, w1, b1, w2, b2, l2s, l2b = targs
    got = postnorm_tail_bwd_ref(x, a, tg[0], tz, ts2, l1s, l1b, w1, b1, w2, l2s, l2b,
                                b2=b2)
    for name, gt, wt in zip(NAMES, got, want):
        assert gt.dtype == targs[0].dtype and tuple(gt.shape) == tuple(wt.shape), name
        if dtype == "fp32":
            np.testing.assert_allclose(_np(gt), _np(wt), err_msg=name, **BWD_TOL)
        else:
            gf, wf = _np(gt).ravel(), _np(wt).ravel()
            rel = np.linalg.norm(gf - wf) / np.linalg.norm(wf)
            assert rel <= BWD_BF16_REL, f"{name}: relative L2 {rel}"


def test_autograd_route_matches_jax_grad():
    """The port's differentiable tail (#15's training form, then #16's
    plain versions) against ``jax.grad`` of JAX's with
    ``train_impl='pallas'`` in interpret mode: every argument."""
    args = _tail_inputs(b=2, n=24, d=128, f=1024, seed=4)
    w = np.random.default_rng(5).standard_normal((2, 24, 128)).astype(np.float32)

    def loss(*a):
        out = jmlp.fused_postnorm_tail(*a, interpret=True, train_impl="pallas")
        return jnp.sum(out * jnp.asarray(w))

    want_out = jmlp.fused_postnorm_tail(*map(jnp.asarray, args), interpret=True)
    want = jax.grad(loss, argnums=tuple(range(10)))(*map(jnp.asarray, args))
    leaves = [_t(a).requires_grad_() for a in args]
    out = fused_postnorm_tail(*leaves)
    np.testing.assert_allclose(_np(out.detach()), _np(want_out), **FWD_TOL)
    (out * _t(w)).sum().backward()
    for i, (leaf, wt) in enumerate(zip(leaves, want)):
        np.testing.assert_allclose(leaf.grad.numpy(), _np(wt), err_msg=f"arg {i}",
                                   **BWD_TOL)


# -- the encoder layer and the hierarchical model --------------------------------


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)


def _tree_close(got, want, **tol):
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_allclose(flat[path], np.asarray(leaf),
                                   err_msg=jax.tree_util.keystr(path), **tol)


@pytest.fixture
def tail_calls(monkeypatch):
    """Counts the port layer's calls of the fused tail."""
    calls = []

    def spy(*a, **k):
        calls.append(a[0].shape)
        return fused_postnorm_tail(*a, **k)

    monkeypatch.setattr(port_layers, "fused_postnorm_tail", spy)
    return calls


@pytest.mark.parametrize("training, rate", [(False, 0.1), (True, 0.0)],
                         ids=["eval", "train-dropout0"])
def test_encoder_layer_tail_matches_jax(monkeypatch, tail_calls, training, rate):
    """D = 128, MLP 1,024: both sides take the tail (JAX's kernels in
    interpret mode under ``_FORCE_FUSED``, the port's plain versions); the
    output, and in training the gradients of x and every parameter."""
    monkeypatch.setattr(jsimple_vit, "_FORCE_FUSED", True)
    rng = np.random.default_rng(6)
    x, g = (rng.standard_normal((2, 24, 128)).astype(np.float32) for _ in range(2))
    jmod = jlayers.TorchTransformerEncoderLayer(dim=128, n_heads=2, hidden_dim=1024,
                                                dropout_rate=rate)
    params = _perturbed(jmod.init(jax.random.key(0), jnp.asarray(x))["params"], 1)
    taken = []
    real = jmlp.fused_postnorm_tail

    def jspy(*a, **k):
        taken.append(True)
        return real(*a, **k)

    def jfn(p, xx):
        return jmod.apply({"params": p}, xx, deterministic=not training)

    with mock.patch.object(jmlp, "fused_postnorm_tail", jspy):
        want, vjp = jax.vjp(jfn, params, jnp.asarray(x))
    assert taken
    mod = load_flax_params(port_layers.TorchTransformerEncoderLayer(128, 2, 1024, rate),
                           params).train(training)
    xt = _t(x).requires_grad_()
    got = mod(xt)
    assert tail_calls == [(2, 24, 128)]
    np.testing.assert_allclose(_np(got.detach()), _np(want), **MODEL_TOL)
    if training:
        want_gp, want_gx = vjp(jnp.asarray(g))
        got.backward(_t(g))
        np.testing.assert_allclose(xt.grad.numpy(), _np(want_gx), **MODEL_TOL)
        _tree_close(to_flax_grads(mod), want_gp, **MODEL_TOL)


#: A small 'hier': img 16 with levels (16, 4, 1), three levels of 16
#: tokens, d = 128 per level, depth 1, MLP 1,024 (the tail's width gate).
HIER = dict(model="hier", img_size=16, embed_dim=128, depth=1, n_heads=2, mlp_dim=1024)


def test_hierarchical_model_matches_jax(monkeypatch, tail_calls):
    """``build_model(..., device='cpu')`` of a small 'hier' against JAX's
    from the same parameters: the logits, and the gradients of a loss
    through the deterministic forward (every layer through the tail, #16's
    plain version under autograd; JAX's kernels in interpret mode)."""
    monkeypatch.setattr(jsimple_vit, "_FORCE_FUSED", True)
    jmodel = jregistry.build_model(jregistry.preset_config("flagship", **HIER))
    x = np.random.default_rng(7).standard_normal((2, 16, 16, 3)).astype(np.float32)
    params = _perturbed(jmodel.init(jax.random.key(0), jnp.asarray(x[:1]))["params"], 8)
    w = np.random.default_rng(9).standard_normal((2, 10)).astype(np.float32)

    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(logits * jnp.asarray(w)), logits

    (_, want_logits), want_grads = jax.value_and_grad(loss, has_aux=True)(params)
    model = load_flax_params(build_model(preset_config("flagship", **HIER), device="cpu"),
                             params).eval()
    assert isinstance(model, HierarchicalVisionTransformer1D)
    _tree_close(to_flax_params(model), params, rtol=0, atol=0)  # the tree both ways
    logits = model(_t(x))
    assert len(tail_calls) == 3 + 2  # one layer per level, two fusion layers
    np.testing.assert_allclose(_np(logits.detach()), _np(want_logits), **MODEL_TOL)
    (logits * _t(w)).sum().backward()
    _tree_close(to_flax_grads(model), want_grads, **MODEL_TOL)


def test_hierarchical_model_shapes_and_refusals():
    """The flagship geometry at MLP 1,024: three levels of 64 tokens at
    d = 256, a fusion encoder over 192; a tokenizer without levels is
    refused, as JAX's ``assert`` refuses it."""
    model = build_model(preset_config("flagship", model="hier", depth=1, mlp_dim=1024),
                        device="cpu")
    assert model.patch_embed.patch_list == [64, 64, 64] and hasattr(model, "encoder_2")
    assert model.encoder_0.layer_0.linear1.kernel.shape == (256, 1024)
    assert model.fusion_encoder.n_layers == 2
    assert model.mlp_head.fact.W_seq.shape == (512, 192, 64)
    assert hasattr(model.mlp_head, "mixer")
    with pytest.raises(ValueError, match="tokenizer='hierarchical'"):
        build_model(preset_config("flagship", model="hier", tokenizer="2d"), device="cpu")
    with pytest.raises(ValueError, match="return_levels=True"):
        HierarchicalVisionTransformer1D(build_model(
            preset_config("flagship", depth=1), device="cpu").patch_embed)

