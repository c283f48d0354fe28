"""Per-layer activation recompute (``remat``) in the port, on the CPU.

Every model family builds with ``remat=True``.  For CurveViT, the
flagship's ``VisionTransformer1D``, the notebook's ``VisionTransformer``
and ``'hier'``, two train steps with ``remat=True`` equal two without
bit for bit (loss, every gradient, and the dropout generator's state
after them: the recompute replays the forward's masks and leaves the live
generator where the forward left it), with dropout on in family A and one
seeded generator installed by the train step.  The ``remat=True``
gradients of CurveViT, ``VisionTransformer`` and ``'hier'`` match JAX's
``remat=True`` model within 1e-4, JAX's dropout masks replayed into the
port by the state of the generator that draws each one, so that the
recompute gets the mask its forward got.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfc_vit_tpu import registry as jregistry
from sfc_vit_tpu.training import losses as jlosses
from sfc_vit_tpu_torch.models import (
    CurveViT,
    HierarchicalVisionTransformer1D,
    SimpleViT,
    VisionTransformer,
    VisionTransformer1D,
    layers,
)
from sfc_vit_tpu_torch.registry import build_model, preset_config
from sfc_vit_tpu_torch.training import TrainState, make_optimizer, make_train_step, warmup_cosine
from sfc_vit_tpu_torch.utils import load_flax_params, to_flax_grads, to_flax_params

#: fp32 gradients through two layers, the port's against JAX's: relative
#: L2 error of each tensor (PERF.md §2's fp32 gate).
GRAD_REL_L2 = 1e-4

#: Each family cut to size: (preset, overrides, image side).
CASES = {
    "curvevit": ("vit-b-16", dict(img_size=28, patch_size=4, embed_dim=128, depth=2,
                                  n_heads=2, mlp_dim=256), 28),
    "vit1d": ("flagship", dict(img_size=16, embed_dim=128, depth=2, n_heads=2,
                               mlp_dim=128), 16),
    "vit": ("notebook", dict(img_size=16, patch_size=4, embed_dim=128, depth=2, n_heads=2,
                             mlp_dim=64), 16),
    "hier": ("flagship", dict(model="hier", img_size=16, embed_dim=128, depth=1, n_heads=2,
                              mlp_dim=128), 16),
}


def _cfg(family, remat):
    preset, over, _ = CASES[family]
    return preset_config(preset, remat=remat, **over)


def _batch(family, n=4, seed=0):
    hw = CASES[family][2]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, hw, hw, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


@pytest.mark.parametrize("model, cls", [
    ("vit", VisionTransformer), ("vit1d", VisionTransformer1D),
    ("hier", HierarchicalVisionTransformer1D), ("simple", SimpleViT), ("curvevit", CurveViT),
])
def test_build_model_takes_remat(model, cls):
    """``remat=True`` builds for every family and reaches every checkpointed
    stack: each family-A encoder (not 'hier''s fusion encoder, as in JAX)
    and the family-B transformer."""
    preset = "vit-tiny-4" if model in ("simple", "curvevit") else "flagship"
    kw = dict(img_size=16, patch_size=4, depth=1) if preset == "flagship" else dict(depth=1)
    if model == "vit":
        kw.update(tokenizer="2d", curve="hilbert")
    built = build_model(preset_config(preset, model=model, remat=True, **kw), device="cpu")
    assert isinstance(built, cls)
    if model in ("simple", "curvevit"):
        stacks = [built.transformer]
    elif model == "hier":
        stacks = [built.encoder_0, built.encoder_1, built.encoder_2]
        assert not built.fusion_encoder.remat
    else:
        stacks = [built.encoder]
    assert all(s.remat for s in stacks)


def _two_steps(family, remat):
    model = build_model(_cfg(family, remat), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    state = TrainState(model, make_optimizer(model.parameters(), warmup_cosine(1e-3, 0, 10),
                                             grad_clip=1.0))
    step = make_train_step(10)
    gen, dgen = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    x, y = _batch(family)
    out = []
    for _ in range(2):
        m = step(state, (torch.from_numpy(x), torch.from_numpy(y)), gen, dgen)
        out.append((m["loss"], {n: p.grad.clone() for n, p in model.named_parameters()}))
    return out, dgen.get_state()


@pytest.mark.parametrize("family", list(CASES))
def test_remat_steps_equal_plain_steps_bit_for_bit(family):
    """Two steps (mixing on, dropout on in family A, clip, AdamW): the loss
    and every gradient of each step, and the dropout generator's state
    after both, equal with and without remat."""
    plain, plain_state = _two_steps(family, False)
    remat, remat_state = _two_steps(family, True)
    for (lp, gp), (lr, gr) in zip(plain, remat):
        assert torch.equal(lp, lr)
        assert gp.keys() == gr.keys()
        for name in gp:
            assert torch.equal(gp[name], gr[name]), name
    assert torch.equal(plain_state, remat_state)


def test_remat_recompute_replays_the_installed_generator():
    """A checkpointed layer with dropout, under one installed generator:
    the gradient equals the layer's without remat, and the generator ends
    where one forward leaves it."""
    torch.manual_seed(0)
    layer = layers.TorchTransformerEncoderLayer(128, 2, 256, dropout_rate=0.3).train()
    x = torch.randn(2, 10, 128)
    grads, states = [], []
    for remat in (False, True):
        gen = torch.Generator().manual_seed(9)
        xr = x.clone().requires_grad_()
        with layers.dropout_generator(gen):
            out = layers.remat_call(layer, xr, remat)
        torch.manual_seed(123)  # the default generator moves; the masks must not
        out.square().sum().backward()
        grads.append(xr.grad)
        states.append(gen.get_state())
    assert torch.equal(grads[0], grads[1])
    assert torch.equal(states[0], states[1])


def _jax_remat_model_and_params(family, seed):
    """JAX's remat model and the same model without remat, and one flax
    tree for both: the port's initial parameters, every leaf perturbed."""
    jmodel, plain = (jregistry.build_model(jregistry.preset_config(
        CASES[family][0], remat=remat, **CASES[family][1])) for remat in (True, False))
    params = to_flax_params(build_model(_cfg(family, False), device="cpu",
                                        generator=torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    return jmodel, plain, params


def _state_keyed_replay(masks):
    """A ``dropout_mask`` that hands out JAX's masks in draw order, keyed by
    the state of the generator it draws from: a recompute, drawing from a
    copy at the forward's state, gets the forward's mask again."""
    queue, seen = list(masks), {}

    def draw(shape, keep, device):
        gen = layers._GENERATOR.get()
        key = bytes(gen.get_state().numpy())
        torch.rand(1, generator=gen)  # advance the generator, as a draw does
        if key not in seen:
            seen[key] = queue.pop(0)
        mask, p = seen[key]
        assert tuple(shape) == mask.shape and keep == pytest.approx(p)
        return torch.from_numpy(mask.copy()).to(device)

    return draw, queue


@pytest.mark.parametrize("family", ["curvevit", "vit", "hier"])
def test_remat_gradients_match_jax_remat(monkeypatch, family):
    """One step (mixing off, dropout on in family A) of the port's remat
    model against ``jax.grad`` of JAX's remat model from the same
    parameters: the loss and every gradient.  JAX's masks are recorded from
    its model without remat (inside ``nn.remat`` a draw is traced), whose
    loss under the same key equals the remat model's."""
    jmodel, jplain, params = _jax_remat_model_and_params(family, seed=3)
    x, y = _batch(family, n=2, seed=4)
    key = jax.random.key(5)
    family_a = family != "curvevit"

    def apply(model, p):
        if family_a:
            return model.apply({"params": p}, jnp.asarray(x), deterministic=False,
                               rngs={"dropout": key})
        return model.apply({"params": p}, jnp.asarray(x))

    def loss_fn(p, model=jmodel):
        return jlosses.soft_target_cross_entropy(apply(model, p), jax.nn.one_hot(y, 10))

    keeps = []
    real = jax.random.bernoulli

    def record(tree):
        """The model without remat: its loss and its masks in draw order."""
        drawn = []

        def spy(k, p=0.5, shape=None, *a, **kw):
            out = real(k, p, shape, *a, **kw)
            drawn.append(out)
            keeps.append(float(p))
            return out

        with mock.patch.object(jax.random, "bernoulli", spy):
            return loss_fn(tree, jplain), drawn

    plain_loss, drawn = jax.jit(record)(params)
    masks = [(np.asarray(m), k) for m, k in zip(drawn, keeps, strict=True)]
    assert bool(masks) == family_a
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    np.testing.assert_allclose(float(want_loss), float(plain_loss), rtol=1e-6)

    draw, left = _state_keyed_replay(masks)
    monkeypatch.setattr(layers, "dropout_mask", draw)
    model = load_flax_params(build_model(_cfg(family, True), device="cpu"), params)
    state = TrainState(model, make_optimizer(model.parameters(), warmup_cosine(1e-3, 0, 10),
                                             grad_clip=1e9))
    m = make_train_step(10, use_mixing=False)(state, (torch.from_numpy(x), torch.from_numpy(y)),
                                             torch.Generator(), torch.Generator())
    assert not left  # every mask replayed
    np.testing.assert_allclose(float(m["loss"]), float(want_loss), rtol=1e-5)
    got = dict(jax.tree_util.tree_leaves_with_path(to_flax_grads(model)))
    leaves = jax.tree_util.tree_leaves_with_path(want_grads)
    assert len(got) == len(leaves)
    for path, leaf in leaves:
        w = np.asarray(leaf, np.float64)
        err = np.linalg.norm(got[path] - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= GRAD_REL_L2, (jax.tree_util.keystr(path), err)
