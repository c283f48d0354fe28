"""The port's training modules against the JAX package's.

Losses, mixing (with lambda, the permutation, the box and the coin taken
from the JAX draws), schedules, one optax update, a whole train step
against ``jax.grad`` on a small CurveViT, the eval step, the data path
and the Trainer.  Everything runs in fp32 on the CPU, at small shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sfc_vit_tpu.data import datasets as jdata
from sfc_vit_tpu.data import make_eval_transform as jmake_eval_transform
from sfc_vit_tpu.models import CurveViT as JCurveViT
from sfc_vit_tpu.training import losses as jlosses
from sfc_vit_tpu.training import mixing as jmixing
from sfc_vit_tpu.training import schedules as jsched
from sfc_vit_tpu.training import steps as jsteps
from sfc_vit_tpu_torch.data import (
    epoch_batches,
    make_eval_transform,
    synthetic_dataset,
)
from sfc_vit_tpu_torch.models import CurveViT
from sfc_vit_tpu_torch.training import (
    MetricsLogger,
    TrainConfig,
    Trainer,
    TrainState,
    cross_entropy,
    cutmix,
    make_eval_step,
    make_optimizer,
    make_train_step,
    mix_or_cutmix,
    mixup,
    mixup_criterion,
    soft_target_cross_entropy,
    warmup_cosine,
    warmup_cosine_min_lr,
)
from sfc_vit_tpu_torch.utils import load_flax_params, to_flax_grads, to_flax_params

#: 7x7 Hilbert grid, depth 2, dim 128: the JAX XLA path on the CPU.
SMALL = dict(image_size=28, patch_size=4, dim=128, depth=2, heads=2,
             dim_head=64, mlp_dim=256, num_classes=10)
# fp32 through two layers and their backward: summation order only.
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_close(got, want, **tol):
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_allclose(flat[path], np.asarray(leaf),
                                   err_msg=jax.tree_util.keystr(path), **tol)


# -- losses, mixing, schedules ---------------------------------------------


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 10)).astype(np.float32) * 3
    soft = rng.dirichlet(np.ones(10), 6).astype(np.float32)
    labels = rng.integers(0, 10, 6).astype(np.int32)
    labels_b = rng.integers(0, 10, 6).astype(np.int32)
    pairs = [
        (soft_target_cross_entropy(_t(logits), _t(soft)),
         jlosses.soft_target_cross_entropy(logits, soft)),
        (cross_entropy(_t(logits), _t(labels)),
         jlosses.cross_entropy(logits, labels)),
        (mixup_criterion(cross_entropy, _t(logits), _t(labels), _t(labels_b), 0.3),
         jlosses.mixup_criterion(jlosses.cross_entropy, logits, labels,
                                 labels_b, 0.3)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _batch(seed=0, b=6, hw=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hw, hw, 3)).astype(np.float32),
            rng.integers(0, 10, b).astype(np.int32))


def _check_mix(got, want):
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    assert got[3] == pytest.approx(float(want[3]), rel=1e-7)


def test_mixup_matches_jax_with_its_draws():
    x, y = _batch(1)
    key = jax.random.key(3)
    k_lam, k_perm = jax.random.split(key)
    lam = float(jmixing._beta(k_lam, 0.2))
    perm = np.asarray(jax.random.permutation(k_perm, x.shape[0]))
    want = jmixing.mixup(key, jnp.asarray(x), jnp.asarray(y), 0.2)
    _check_mix(mixup(None, _t(x), _t(y), 0.2, lam=lam, perm=perm), want)


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_cutmix_matches_jax_with_its_draws(seed):
    x, y = _batch(seed, hw=12)
    key = jax.random.key(seed)
    k_lam, k_perm, k_cx, k_cy = jax.random.split(key, 4)
    lam = float(jmixing._beta(k_lam, 1.0))
    perm = np.asarray(jax.random.permutation(k_perm, x.shape[0]))
    center = (int(jax.random.randint(k_cx, (), 0, 12)),
              int(jax.random.randint(k_cy, (), 0, 12)))
    want = jmixing.cutmix(key, jnp.asarray(x), jnp.asarray(y), 1.0)
    _check_mix(cutmix(None, _t(x), _t(y), 1.0, lam=lam, perm=perm,
                      center=center), want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mix_or_cutmix_matches_jax_with_its_coin(seed):
    x, y = _batch(seed, hw=12)
    key = jax.random.key(seed)
    k_coin, k_aug = jax.random.split(key)
    use_mixup = bool(jax.random.uniform(k_coin) < 0.5)
    if use_mixup:
        k_lam, k_perm = jax.random.split(k_aug)
        lam = float(jmixing._beta(k_lam, 0.2))
        center = None
    else:
        k_lam, k_perm, k_cx, k_cy = jax.random.split(k_aug, 4)
        lam = float(jmixing._beta(k_lam, 1.0))
        center = (int(jax.random.randint(k_cx, (), 0, 12)),
                  int(jax.random.randint(k_cy, (), 0, 12)))
    perm = np.asarray(jax.random.permutation(k_perm, x.shape[0]))
    want = jmixing.mix_or_cutmix(key, jnp.asarray(x), jnp.asarray(y))
    got = mix_or_cutmix(None, _t(x), _t(y), use_mixup=use_mixup, lam=lam,
                        perm=perm, center=center)
    _check_mix(got, want)


def test_mixing_draws_from_the_generator():
    x, y = _batch(7, hw=12)
    a = mix_or_cutmix(torch.Generator().manual_seed(0), _t(x), _t(y))
    b = mix_or_cutmix(torch.Generator().manual_seed(0), _t(x), _t(y))
    assert torch.equal(a[0], b[0]) and a[3] == b[3] and 0.0 <= a[3] <= 1.0
    lams = [mixup(torch.Generator().manual_seed(s), _t(x), _t(y), 0.2)[3]
            for s in range(200)]
    # Beta(0.2, 0.2) is U-shaped with mean 0.5
    assert 0.4 < np.mean(lams) < 0.6 and np.mean(np.abs(np.array(lams) - 0.5) > 0.4) > 0.4


@pytest.mark.parametrize("make, jmake, args", [
    (warmup_cosine, jsched.warmup_cosine, (3e-4, 10, 100)),
    (warmup_cosine_min_lr, jsched.warmup_cosine_min_lr, (3e-4, 10, 100, 1e-6)),
])
def test_schedules_match_jax(make, jmake, args):
    """JAX computes in float32, the port in float64: within 1e-6 of
    base_lr (near the end of the cosine the value itself is ~0)."""
    mine, theirs = make(*args), jmake(*args)
    assert mine(0) == 0.0
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        assert mine(step) == pytest.approx(float(theirs(step)), rel=1e-6,
                                           abs=1e-6 * args[0])


# -- the optimizer -----------------------------------------------------------


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["no_clip", "clip"])
def test_optimizer_update_matches_optax(grad_scale):
    rng = np.random.default_rng(9)
    params = {"a": rng.standard_normal((5, 7)).astype(np.float32),
              "b": rng.standard_normal((7,)).astype(np.float32)}
    sched = jsched.warmup_cosine(1e-2, 0, 10)
    tx = jsteps.make_optimizer(sched)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    tensors = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    opt = make_optimizer(tensors.values(), warmup_cosine(1e-2, 0, 10))
    for step in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) * grad_scale
                 for k, v in params.items()}
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, t in tensors.items():
            t.grad = torch.from_numpy(grads[k])
        clipped = float(opt.global_norm()) >= 1.0
        assert clipped == (grad_scale > 1)
        assert opt.step() == pytest.approx(float(sched(step)), rel=1e-6)
        for k, t in tensors.items():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-6)


# -- the train and eval steps ------------------------------------------------


def _jax_model_and_params(seed=0):
    jmodel = JCurveViT(**SMALL)
    x0 = jnp.zeros((1, 28, 28, 3), jnp.float32)
    params = jmodel.init(jax.random.key(seed), x0)["params"]
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    return jmodel, params


def _images(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 28, 28, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _updated_params_close(got, want, lr):
    """Params after one AdamW update.  The first update moves each element
    by ``lr * g / (|g| + eps)``, which is ``+-lr`` unless ``|g|`` is near
    eps: an element whose gradient is within rounding of 0 in either
    framework may move differently, by at most 2 lr.  So: at most 0.1 %
    of the elements outside rtol 1e-5 / atol 1e-6, none beyond 2 lr."""
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        diff = np.abs(flat[path] - np.asarray(leaf))
        off = diff > 1e-6 + 1e-5 * np.abs(np.asarray(leaf))
        assert off.mean() <= 1e-3 and diff.max() <= 2 * lr, jax.tree_util.keystr(path)


def _port_state(params, sched, grad_clip=1.0):
    model = load_flax_params(CurveViT(**SMALL), params)
    return TrainState(model=model, optimizer=make_optimizer(
        model.parameters(), sched, grad_clip=grad_clip))


def test_train_step_grads_and_update_match_jax():
    """Mixing off: loss and every gradient against ``jax.grad`` of the
    JAX step's loss, then the params after one update (clip 1.0 + AdamW,
    no warmup so the update is not lr(0) = 0) against the JAX step."""
    jmodel, params = _jax_model_and_params()
    x, y = _images()

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x))
        return jlosses.soft_target_cross_entropy(logits, jax.nn.one_hot(y, 10))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)

    state = _port_state(params, warmup_cosine(1e-3, 0, 10), grad_clip=1e9)
    step = make_train_step(10, use_mixing=False)
    m = step(state, (_t(x), _t(y)), torch.Generator())
    np.testing.assert_allclose(float(m["loss"]), float(want_loss), rtol=1e-5)
    _tree_close(to_flax_grads(state.model), want_grads, **GRAD_TOL)

    sched = jsched.warmup_cosine(1e-3, 0, 10)
    jstate = jsteps.TrainState.create(apply_fn=jmodel.apply, params=params,
                                      tx=jsteps.make_optimizer(sched))
    jstate, jm = jax.jit(jsteps.make_train_step(10, use_mixing=False, schedule=sched))(
        jstate, (jnp.asarray(x), jnp.asarray(y)), jax.random.key(0))
    state = _port_state(params, warmup_cosine(1e-3, 0, 10))
    m = step(state, (_t(x), _t(y)), torch.Generator())
    assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    np.testing.assert_allclose(float(m["accuracy"]), float(jm["accuracy"]))
    _updated_params_close(to_flax_params(state.model), jstate.params, 1e-3)


def test_grad_accum_matches_one_batch():
    _, params = _jax_model_and_params(seed=2)
    x, y = _images(n=6, seed=3)
    states, metrics = [], []
    for accum in (1, 2):
        state = _port_state(params, warmup_cosine(1e-3, 0, 10))
        step = make_train_step(10, grad_accum=accum)
        metrics.append(step(state, (_t(x), _t(y)), torch.Generator().manual_seed(1)))
        states.append(state)
    np.testing.assert_allclose(float(metrics[0]["loss"]), float(metrics[1]["loss"]),
                               rtol=1e-5)
    _updated_params_close(to_flax_params(states[1].model),
                          to_flax_params(states[0].model), 1e-3)
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(10, grad_accum=4)(states[0], (_t(x), _t(y)),
                                          torch.Generator())


def test_eval_step_matches_jax_and_masks_padding():
    jmodel, params = _jax_model_and_params(seed=4)
    x, y = _images(n=5, seed=5)
    y[3:] = -1
    jstate = jsteps.TrainState.create(apply_fn=jmodel.apply, params=params,
                                      tx=optax.sgd(0.0))
    want = jax.jit(jsteps.make_eval_step(10))(jstate, (jnp.asarray(x), jnp.asarray(y)))
    got = make_eval_step(10)(_port_state(params, warmup_cosine(0.0, 0, 1)),
                             (_t(x), _t(y)))
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]),
                               rtol=1e-5)
    assert int(got["correct"]) == int(want["correct"])
    assert int(got["count"]) == int(want["count"]) == 3


# -- data, logging, Trainer --------------------------------------------------


def test_data_path_is_byte_equal_to_jax():
    mine = synthetic_dataset(n=40, hw=12, num_classes=5, seed=3)
    theirs = jdata.synthetic_dataset(n=40, hw=12, num_classes=5, seed=3)
    assert np.array_equal(mine.images, theirs.images)
    assert np.array_equal(mine.labels, theirs.labels)
    for kw in (dict(seed=1, epoch=2), dict(shuffle=False, drop_last=False)):
        got = list(epoch_batches(mine, 16, **kw))
        want = list(jdata.epoch_batches(theirs, 16, **kw))
        assert len(got) == len(want)
        for (a, b), (c, d) in zip(got, want):
            assert np.array_equal(a, c) and np.array_equal(b, d)
    stats = ((0.5,) * 3, (0.25,) * 3)
    # XLA may fold the divisions into multiplications: one float32 ulp
    np.testing.assert_allclose(
        make_eval_transform(*stats)(mine.images).numpy(),
        np.asarray(jmake_eval_transform(*stats)(mine.images)), rtol=1e-6,
        atol=1e-6)


def test_metrics_logger_writes_jsonl_and_csv(tmp_path):
    log = MetricsLogger(tmp_path, stdout=False)
    log.log({"epoch": 1, "images_per_sec": 10.5})
    log.log({"epoch": 2, "images_per_sec": 11.0})
    log.close()
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 2
    assert (tmp_path / "metrics.csv").read_text().splitlines()[0].startswith(
        "epoch,images_per_sec")
    with pytest.raises(NotImplementedError, match="item 8"):
        MetricsLogger(tmp_path, tensorboard=True)


def test_trainer_fit_one_epoch_on_cpu():
    ds = synthetic_dataset(n=16, hw=28, num_classes=10, seed=0)
    test = synthetic_dataset(n=6, hw=28, num_classes=10, seed=1)
    tf = make_eval_transform((0.5,) * 3, (0.25,) * 3)
    model = CurveViT(**SMALL, generator=torch.Generator().manual_seed(0))
    before = [p.detach().clone() for p in model.parameters()]
    cfg = TrainConfig(num_classes=10, epochs=1, warmup_epochs=0, base_lr=1e-3)
    trainer = Trainer(model, cfg, steps_per_epoch=2)
    record = trainer.fit(
        lambda: ((tf(x), y) for x, y in epoch_batches(ds, 8, seed=0)),
        lambda: ((tf(x), y) for x, y in epoch_batches(test, 4, shuffle=False,
                                                       drop_last=False)))
    assert record["epoch"] == 1 and np.isfinite(record["train_loss"])
    assert 0.0 <= record["test_accuracy"] <= 1.0
    assert trainer.state.step == 2 and trainer.state.optimizer.count == 2
    assert all(not torch.equal(a, b) for a, b in zip(before, model.parameters()))


@pytest.mark.parametrize("field, value, item", [
    ("fsdp", True, "item 13"), ("data_parallel", 4, "item 13"),
    ("pipeline_parallel", 2, "item 13"), ("workdir", "/nonexistent", "item 8"),
    ("tensorboard", True, "item 8"),
])
def test_trainer_refuses_unported_options(field, value, item):
    cfg = TrainConfig(**{field: value})
    with pytest.raises(NotImplementedError, match=item):
        Trainer(CurveViT(**SMALL), cfg, steps_per_epoch=1)


def test_trainer_init_params_are_checked_and_loaded():
    _, params = _jax_model_and_params(seed=6)
    trainer = Trainer(CurveViT(**SMALL), TrainConfig(), steps_per_epoch=1,
                      init_params=params)
    _tree_close(to_flax_params(trainer.model), params, rtol=0, atol=0)
    bad = jax.tree_util.tree_map(np.asarray, params)
    bad["linear_head"]["kernel"] = bad["linear_head"]["kernel"][:, :5]
    with pytest.raises(ValueError, match="linear_head/kernel"):
        Trainer(CurveViT(**SMALL), TrainConfig(), steps_per_epoch=1,
                init_params=bad)
