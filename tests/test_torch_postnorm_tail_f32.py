"""The family-A flagship at MLP 1,024 at its own fp32, the port's against
the JAX package's, on the CPU.

``preset_config("flagship", mlp_dim=1024)`` names no dtype, so both
frameworks compute in float32, and every layer's tail takes the post-norm
tail #15/#16 (dropout 0 in the encoder, as ``chip_smoke.py`` builds it).
A small ``VisionTransformer1D`` (depth 2, d 128 a level, MLP 1,024) is
served through ``ServingEngine(dtype=None)`` and trained one step against
JAX's model under ``_FORCE_FUSED``: its #15 and #16 in interpret mode at
fp32, the head's dropout mask recorded and replayed.  Spies hold every
``fused_postnorm_tail`` call of the port to fp32 tensors.  Inputs come
from numpy seeds.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfc_vit_tpu.ops.fused_mlp as jmlp
from sfc_vit_tpu import registry as jregistry
from sfc_vit_tpu.models import simple_vit as jsimple_vit
from sfc_vit_tpu.models import vit as jvit
from sfc_vit_tpu.training import losses as jlosses
from sfc_vit_tpu_torch.models import VisionTransformer1D, layers
from sfc_vit_tpu_torch.ops.fused_mlp import fused_postnorm_tail
from sfc_vit_tpu_torch.registry import build_tokenizer, preset_config
from sfc_vit_tpu_torch.serving import ServingEngine
from sfc_vit_tpu_torch.training import TrainState, make_optimizer, make_train_step, warmup_cosine
from sfc_vit_tpu_torch.utils import load_flax_params, to_flax_grads, to_flax_params

#: PERF.md §2's fp32 gate: logits within this fraction of the largest
#: |logit|, gradients within this relative L2 error per tensor.
F32_LOGIT, F32_GRAD = 1e-4, 1e-4
#: The flagship at MLP 1,024 cut to size: img 16, three levels of 16
#: tokens at d 128 (the model's width 384), depth 2, 2 heads.
SMALL = dict(img_size=16, embed_dim=128, depth=2, n_heads=2, mlp_dim=1024)


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 16, 16, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


@pytest.fixture
def tail_calls(monkeypatch):
    """The dtypes of every tensor each port tail call received."""
    calls = []

    def spy(*args, **kw):
        calls.append({a.dtype for a in (*args, *kw.values()) if isinstance(a, torch.Tensor)})
        return fused_postnorm_tail(*args, **kw)

    monkeypatch.setattr(layers, "fused_postnorm_tail", spy)
    return calls


@pytest.fixture
def jax_tail(monkeypatch):
    """JAX's gates forced on (its Pallas kernels in interpret mode), with a
    record of #15's and #16's calls."""
    monkeypatch.setattr(jsimple_vit, "_FORCE_FUSED", True)
    taken = []
    for name in ("_postnorm_tail", "_postnorm_tail_bwd"):
        real = getattr(jmlp, name)
        monkeypatch.setattr(jmlp, name, lambda *a, _r=real, _n=name, **k: (taken.append(_n),
                                                                          _r(*a, **k))[1])
    return taken


def _jax_model_and_params(seed=0):
    """JAX's model and a flax tree for it: the port's initial parameters
    (:func:`_port_model`'s tree), every leaf perturbed."""
    cfg = jregistry.preset_config("flagship", **SMALL)
    assert cfg.dtype is None
    jmodel = jvit.VisionTransformer1D(
        patch_embed=jregistry.build_tokenizer(cfg), depth=cfg.depth, n_heads=cfg.n_heads,
        mlp_dim=cfg.mlp_dim, num_classes=cfg.num_classes, dropout_rate=0.0)
    params = to_flax_params(_port_model(generator=torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    return jmodel, params


def _port_model(params=None, generator=None):
    cfg = preset_config("flagship", **SMALL)
    assert cfg.torch_dtype() is None
    model = VisionTransformer1D(build_tokenizer(cfg, generator=generator), depth=cfg.depth,
                                n_heads=cfg.n_heads, mlp_dim=cfg.mlp_dim,
                                num_classes=cfg.num_classes, dropout_rate=0.0, device="cpu",
                                generator=generator)
    return model if params is None else load_flax_params(model, params)


def _all_fp32(calls, n):
    assert len(calls) == n
    assert all(dtypes == {torch.float32} for dtypes in calls), calls


def test_served_logits_match_jax_in_fp32(jax_tail, tail_calls):
    """ServingEngine(dtype=None): five images in batches of 4 and 2, every
    layer through #15's plain version in fp32, against JAX's logits with
    its #15 in interpret mode."""
    jmodel, params = _jax_model_and_params()
    x, _ = _images(5, seed=2)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x)))
    assert jax_tail == ["_postnorm_tail"] * SMALL["depth"]
    engine = ServingEngine(_port_model(params), None, (16, 16, 3), batch_sizes=(2, 4),
                           dtype=None, device="cpu")
    assert all(p.dtype == torch.float32 for p in engine.model.parameters())
    del tail_calls[:]  # the engine's warm-up forwards
    got = engine.predict(x)
    _all_fp32(tail_calls, 2 * SMALL["depth"])  # two forwards
    assert got.shape == (5, 10) and got.dtype == np.float32
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= F32_LOGIT * scale, (err, scale)


def test_train_step_matches_jax_in_fp32(monkeypatch, jax_tail, tail_calls):
    """One train step (mixing off, the head's dropout mask JAX's): the loss
    and every gradient against ``jax.grad`` through JAX's #15 training form
    and #16 in interpret mode."""
    jmodel, params = _jax_model_and_params(seed=3)
    x, y = _images(4, seed=4)
    key = jax.random.key(5)

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x), deterministic=False,
                              rngs={"dropout": key})
        return jlosses.soft_target_cross_entropy(logits, jax.nn.one_hot(y, 10))

    keeps, real = [], jax.random.bernoulli

    def record(tree):
        """The forward's dropout masks in draw order."""
        drawn = []

        def spy(k, p=0.5, shape=None, *a, **kw):
            out = real(k, p, shape, *a, **kw)
            drawn.append(out)
            keeps.append(float(p))
            return out

        with mock.patch.object(jax.random, "bernoulli", spy):
            loss_fn(tree)
        return drawn

    masks = [(np.asarray(m), k) for m, k in zip(jax.jit(record)(params), keeps, strict=True)]
    assert len(masks) == 1  # the head's: the encoder's rate is 0
    del jax_tail[:]
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    assert sorted(set(jax_tail)) == ["_postnorm_tail", "_postnorm_tail_bwd"]

    def draw(shape, keep, device):
        mask, p = masks[0]
        assert tuple(shape) == mask.shape and keep == pytest.approx(p)
        return torch.from_numpy(mask.copy()).to(device)

    monkeypatch.setattr(layers, "dropout_mask", draw)
    model = _port_model(params)
    state = TrainState(model, make_optimizer(model.parameters(), warmup_cosine(1e-3, 0, 10),
                                             grad_clip=1e9))
    m = make_train_step(10, use_mixing=False)(state, (torch.from_numpy(x), torch.from_numpy(y)),
                                             torch.Generator(), torch.Generator())
    _all_fp32(tail_calls, SMALL["depth"])
    np.testing.assert_allclose(float(m["loss"]), float(want_loss), rtol=1e-5)
    got = dict(jax.tree_util.tree_leaves_with_path(to_flax_grads(model)))
    leaves = jax.tree_util.tree_leaves_with_path(want_grads)
    assert len(got) == len(leaves)
    for path, leaf in leaves:
        w = np.asarray(leaf, np.float64)
        err = np.linalg.norm(got[path] - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= F32_GRAD, (jax.tree_util.keystr(path), err)
