"""One family-A train step with dropout on, the port's against the JAX
package's, on the CPU in fp32: a small ``VisionTransformer1D`` (the
flagship's shape, cut down), JAX's mixing draws and dropout masks
replayed in draw order through the port's draw functions.  Also the
dropout function and the ``Trainer`` on that model.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfc_vit_tpu import registry as jregistry
from sfc_vit_tpu.training import losses as jlosses
from sfc_vit_tpu.training import mixing as jmixing
from sfc_vit_tpu.training import schedules as jsched
from sfc_vit_tpu.training import steps as jsteps
from sfc_vit_tpu_torch.data import epoch_batches, synthetic_dataset
from sfc_vit_tpu_torch.models import layers
from sfc_vit_tpu_torch.registry import build_model, preset_config
from sfc_vit_tpu_torch.training import (
    TrainConfig,
    Trainer,
    TrainState,
    make_optimizer,
    make_train_step,
    warmup_cosine,
)
from sfc_vit_tpu_torch.training import steps as port_steps
from sfc_vit_tpu_torch.utils import load_flax_params, to_flax_grads, to_flax_params

#: One train step's gradients, fp32 through two post-norm layers with
#: dropout: relative L2 error of each tensor (a ReLU input within rounding
#: of 0 flips single elements, so no elementwise bound).
GRAD_REL_L2 = 1e-4
#: The flagship cut to size: img 16, three levels of 16 tokens, d = 384,
#: depth 2, 2 heads of 192, MLP 128.
SMALL = dict(img_size=16, embed_dim=128, depth=2, n_heads=2, mlp_dim=128)


def _t(a):
    return torch.from_numpy(np.array(a))


def _images(n, hw=16, seed=0):
    return np.random.default_rng(seed).standard_normal((n, hw, hw, 3)).astype(np.float32)


def _jax_flagship(seed):
    jmodel = jregistry.build_model(jregistry.preset_config("flagship", **SMALL))
    variables = jmodel.init(jax.random.key(seed), jnp.asarray(_images(1)))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        variables["params"])
    return jmodel, params


def _port_flagship(params=None):
    model = build_model(preset_config("flagship", **SMALL), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    return model if params is None else load_flax_params(model, params)


def _rel_l2_close(got, want, tol):
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(leaves)
    for path, leaf in leaves:
        w = np.asarray(leaf, np.float64)
        err = np.linalg.norm(flat[path] - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= tol, (jax.tree_util.keystr(path), err)



def _record_masks(jmodel, params, x, k_drop, k_perm):
    """JAX's dropout masks of one training forward, in draw order (the
    masks depend on the keys and shapes, not on the images)."""
    masks = []
    real = jax.random.bernoulli

    def spy(key, p=0.5, shape=None, *args, **kw):
        out = real(key, p, shape, *args, **kw)
        masks.append((np.asarray(out), float(p)))
        return out

    with mock.patch.object(jax.random, "bernoulli", spy):
        jmodel.apply({"params": params}, jnp.asarray(x), deterministic=False,
                     rngs={"dropout": k_drop, "permute": k_perm})
    return masks


def _replay(masks):
    queue = list(masks)

    def draw(shape, keep, device):
        mask, p = queue.pop(0)
        assert tuple(shape) == mask.shape and keep == pytest.approx(p)
        return torch.from_numpy(mask.copy()).to(device)

    return draw, queue


def _jax_mix_draws(k_mix, x, hw):
    k_coin, k_aug = jax.random.split(k_mix)
    use_mixup = bool(jax.random.uniform(k_coin) < 0.5)
    if use_mixup:
        k_lam, k_perm = jax.random.split(k_aug)
        lam, center = float(jmixing._beta(k_lam, 0.2)), None
    else:
        k_lam, k_perm, k_cx, k_cy = jax.random.split(k_aug, 4)
        lam = float(jmixing._beta(k_lam, 1.0))
        center = (int(jax.random.randint(k_cx, (), 0, hw)),
                  int(jax.random.randint(k_cy, (), 0, hw)))
    perm = np.asarray(jax.random.permutation(k_perm, x.shape[0]))
    return dict(use_mixup=use_mixup, lam=lam, perm=perm, center=center)


def test_train_step_with_dropout_matches_jax(monkeypatch):
    """The JAX step (mixing on, dropout 0.1 in the encoder and 0.5 in the
    head) against the port's, JAX's mixing draws and dropout masks
    replayed: the loss, every gradient, then the params after one update
    (clip 1.0 + AdamW)."""
    seed = 3
    jmodel, params = _jax_flagship(seed=seed)
    rng = np.random.default_rng(seed)
    x = _images(4, seed=seed)
    y = rng.integers(0, 10, 4).astype(np.int32)
    key = jax.random.key(seed)
    k_mix, k_drop, k_perm = jax.random.split(jax.random.fold_in(key, 0), 3)
    masks = _record_masks(jmodel, params, x, k_drop, k_perm)
    # per layer: probabilities [B, H, N, N], attention out, MLP hidden, MLP
    # out; then the head
    assert len(masks) == 4 * SMALL["depth"] + 1
    draws = _jax_mix_draws(k_mix, x, 16)

    xm, ya, yb, lam = jmixing.mix_or_cutmix(k_mix, jnp.asarray(x), jnp.asarray(y))

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, xm, deterministic=False,
                              rngs={"dropout": k_drop, "permute": k_perm})
        soft = (lam * jax.nn.one_hot(ya, 10) + (1.0 - lam) * jax.nn.one_hot(yb, 10))
        return jlosses.soft_target_cross_entropy(logits, soft)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    sched = jsched.warmup_cosine(1e-3, 0, 10)
    jstate = jsteps.TrainState.create(apply_fn=jmodel.apply, params=params,
                                      tx=jsteps.make_optimizer(sched))
    jstate, jm = jax.jit(jsteps.make_train_step(10, schedule=sched))(
        jstate, (jnp.asarray(x), jnp.asarray(y)), key)

    real_mix = port_steps.mix_or_cutmix
    monkeypatch.setattr(port_steps, "mix_or_cutmix",
                        lambda gen, *a, **kw: real_mix(gen, *a, **kw, **draws))
    step = make_train_step(10)
    for clip, lr in ((float("inf"), 0.0), (1.0, None)):
        draw, left = _replay(masks)
        monkeypatch.setattr(layers, "dropout_mask", draw)
        model = _port_flagship(params)
        sched_p = (lambda _: 0.0) if lr == 0.0 else warmup_cosine(1e-3, 0, 10)
        state = TrainState(model, make_optimizer(model.parameters(), sched_p,
                                                 grad_clip=clip))
        m = step(state, (_t(x), _t(y)), torch.Generator())
        assert not left  # every mask replayed
        np.testing.assert_allclose(float(m["loss"]), float(want_loss), rtol=1e-5)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        if lr == 0.0:
            _rel_l2_close(to_flax_grads(model), want_grads, GRAD_REL_L2)
    np.testing.assert_allclose(float(m["accuracy"]), float(jm["accuracy"]))
    flat = dict(jax.tree_util.tree_leaves_with_path(to_flax_params(model)))
    grads = dict(jax.tree_util.tree_leaves_with_path(want_grads))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jstate.params):
        # The first AdamW update moves an element by about +-lr * sign(g).
        # Where the gradient is rounding noise (|g| under 1e-3 of its
        # tensor's largest: the key bias, to which the softmax is
        # invariant) the two frameworks' signs differ; elsewhere a ReLU input within rounding of 0 may move an
        # element differently (at most 0.1 % of a tensor); none moves by
        # more than 2 lr apart.
        diff = np.abs(flat[path] - np.asarray(leaf))
        g = np.abs(np.asarray(grads[path]))
        noise = g < 1e-3 * g.max()
        off = diff > 1e-6 + 1e-5 * np.abs(np.asarray(leaf))
        assert (off & ~noise).mean() <= 1e-3 and diff.max() <= 2e-3, \
            jax.tree_util.keystr(path)


def test_dropout_draws_from_the_installed_generator():
    x = torch.ones(64, 32)
    with layers.dropout_generator(torch.Generator().manual_seed(5)):
        a = layers.dropout(x, 0.25, training=True)
    with layers.dropout_generator(torch.Generator().manual_seed(5)):
        b = layers.dropout(x, 0.25, training=True)
    assert torch.equal(a, b)
    assert set(torch.unique(a).tolist()) <= {0.0, float(torch.tensor(1.0) / 0.75)}
    assert 0.15 < float((a == 0).float().mean()) < 0.35
    assert torch.equal(layers.dropout(x, 0.25, training=False), x)


def test_trainer_fits_a_small_flagship_on_cpu():
    ds = synthetic_dataset(n=8, hw=16, num_classes=10, seed=0)
    model = _port_flagship()
    before = [p.detach().clone() for p in model.parameters()]
    trainer = Trainer(model, TrainConfig(num_classes=10, epochs=1, warmup_epochs=0,
                                         base_lr=1e-3), steps_per_epoch=2)
    assert trainer.dropout_generator.device == torch.device("cpu")
    record = trainer.fit(lambda: epoch_batches(ds, 4, seed=0),
                         lambda: epoch_batches(ds, 4, shuffle=False, drop_last=False))
    assert np.isfinite(record["train_loss"]) and np.isfinite(record["test_loss"])
    assert all(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
