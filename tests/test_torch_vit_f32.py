"""The CurveViT presets at their own dtype (float32, no ``dtype`` set)
through the port's fused blocks #1-#4, against the JAX model from the same
parameters under ``_FORCE_FUSED`` (its Pallas kernels #1-#4 in interpret
mode at fp32, the stack padded once from 49 to 64 tokens).

``preset_config("vit-s-16", ...)`` cut to d 128, 2 heads of 64, depth 1,
MLP 256 over 49 tokens: built with ``build_model(..., device="cpu")``,
served through ``ServingEngine(dtype=None)`` and trained one step.  Spies
on the port's ``fused_attention_block`` and ``fused_mlp_block`` check that
every call saw float32 tensors: the contract the fp32 kernels rely on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfc_vit_tpu_torch.models.simple_vit as port_simple_vit
from sfc_vit_tpu import registry as jregistry
from sfc_vit_tpu.models import simple_vit as jsimple_vit
from sfc_vit_tpu.ops import fused_attention_block as jfab
from sfc_vit_tpu.ops import fused_mlp as jmlp
from sfc_vit_tpu.training import losses as jlosses
from sfc_vit_tpu_torch.registry import build_model, preset_config
from sfc_vit_tpu_torch.serving import ServingEngine
from sfc_vit_tpu_torch.training import TrainState, make_optimizer, make_train_step, warmup_cosine
from sfc_vit_tpu_torch.utils import load_flax_params, to_flax_grads

#: 7 x 7 patches of 4 x 4 -> 49 tokens (JAX pads them once to 64); the
#: widths every fused gate takes (multiples of 128).
SMALL = dict(img_size=28, patch_size=4, embed_dim=128, n_heads=2, depth=1, mlp_dim=256,
             num_classes=10)
#: fp32 on both sides, one layer and its backward: summation order only.
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(t):
    return np.asarray(t, dtype=np.float32)


@pytest.fixture
def block_calls(monkeypatch):
    """Spies on the port's two fused blocks: the dtype of every tensor
    each call received."""
    calls = []

    def spy(name, real):
        def wrapped(*args, **kw):
            calls.append((name, {a.dtype for a in (*args, *kw.values())
                                 if isinstance(a, torch.Tensor)}))
            return real(*args, **kw)
        return wrapped

    for name in ("fused_attention_block", "fused_mlp_block"):
        monkeypatch.setattr(port_simple_vit, name,
                            spy(name, getattr(port_simple_vit, name)))
    return calls


@pytest.fixture
def jax_fused(monkeypatch):
    """JAX's fused gates forced on (``_FORCE_FUSED``: its Pallas kernels in
    interpret mode), with a record of the blocks that took them."""
    monkeypatch.setattr(jsimple_vit, "_FORCE_FUSED", True)
    taken = []
    for module, name in ((jfab, "fused_attention_block"), (jmlp, "fused_mlp_block")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, _real=real, _name=name, **k: (taken.append(_name),
                                                                     _real(*a, **k))[1])
    return taken


def _jax_model_and_params(curve, seed=0):
    """The JAX model of the same preset, and its initial parameters with
    every leaf perturbed (so unit scales and zero biases hide nothing)."""
    cfg = jregistry.preset_config("vit-s-16", curve=curve, **SMALL)
    assert cfg.dtype is None
    jmodel = jregistry.build_model(cfg)
    params = jmodel.init(jax.random.key(seed), jnp.zeros((1, 28, 28, 3), jnp.float32))["params"]
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    return jmodel, params


def _port_model(curve, params):
    cfg = preset_config("vit-s-16", curve=curve, **SMALL)
    assert cfg.dtype is None and cfg.torch_dtype() is None
    return load_flax_params(build_model(cfg, device="cpu"), params)


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 28, 28, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _all_fp32(calls, n):
    assert len(calls) == n
    for name, dtypes in calls:
        assert dtypes == {torch.float32}, (name, dtypes)


@pytest.mark.parametrize("curve", ["hilbert", "raster"])
def test_served_logits_match_jax_in_fp32(jax_fused, block_calls, curve):
    """ServingEngine(dtype=None) over the preset's fp32 model: five images
    in batches of 4 and 2 (the tail padded), through the fused blocks in
    fp32, against JAX's logits with its kernels in interpret mode."""
    jmodel, params = _jax_model_and_params(curve)
    x, _ = _images(5, seed=2)
    del jax_fused[:]  # init
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    assert sorted(jax_fused) == ["fused_attention_block", "fused_mlp_block"]
    model = _port_model(curve, params)
    engine = ServingEngine(model, None, (28, 28, 3), batch_sizes=(2, 4), dtype=None,
                           device="cpu")
    assert all(p.dtype == torch.float32 for p in engine.model.parameters())
    del block_calls[:]  # the engine's warm-up forwards
    got = engine.predict(x)
    _all_fp32(block_calls, 2 * 2)  # two forwards, one layer of two blocks
    assert got.shape == (5, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def test_train_step_matches_jax_in_fp32(jax_fused, block_calls):
    """One train step of the preset's fp32 model (mixing off): the loss and
    every gradient against ``jax.grad`` through JAX's fused kernels and
    their backward kernels (#3, #4) in interpret mode."""
    jmodel, params = _jax_model_and_params("hilbert", seed=3)
    x, y = _images(4, seed=4)

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x))
        return jlosses.soft_target_cross_entropy(logits, jax.nn.one_hot(y, 10))

    del jax_fused[:]
    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    assert sorted(jax_fused) == ["fused_attention_block", "fused_mlp_block"]
    model = _port_model("hilbert", params)
    state = TrainState(model=model, optimizer=make_optimizer(
        model.parameters(), warmup_cosine(1e-3, 0, 10), grad_clip=1e9))
    m = make_train_step(10, use_mixing=False)(
        state, (torch.from_numpy(x), torch.from_numpy(y)), torch.Generator())
    _all_fp32(block_calls, 2)
    np.testing.assert_allclose(float(m["loss"]), float(want_loss), rtol=1e-5)
    got = dict(jax.tree_util.tree_leaves_with_path(to_flax_grads(model)))
    leaves = jax.tree_util.tree_leaves_with_path(want_grads)
    assert len(got) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_allclose(got[path], _np(leaf), err_msg=jax.tree_util.keystr(path),
                                   **TOL)


def test_preset_at_its_own_dtype_keeps_fp32_through_the_blocks(block_calls):
    """No dtype in the preset: parameters, activations and every block call
    stay float32 in eval and under autograd (no cast to bf16 anywhere
    between the model's entry and the blocks)."""
    cfg = preset_config("vit-b-16", **SMALL)
    assert cfg.dtype is None
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert model.dtype is None
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = torch.from_numpy(_images(3, seed=5)[0])
    with torch.no_grad():
        assert model.eval()(x).dtype == torch.float32
    logits = model.train()(x)
    assert logits.dtype == torch.float32
    logits.sum().backward()
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    _all_fp32(block_calls, 4)
