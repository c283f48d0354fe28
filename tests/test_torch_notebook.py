"""The 2-D and 1-D curve tokenizers of the reference notebook's model, the
port's against the JAX package's, on the CPU.

``ConvPatchEmbedding`` (unfused, and fused with JAX's ``gather_project``
in interpret mode) for all seven curves, ``'random'`` replaying JAX's
permutation, recorded by wrapping ``jax.random.permutation``;
``PixelCurveEmbedding1D`` at patch 4 and at patch 1 (1,024 tokens) and
past it; the reference's tokenizer names; one train step of a
``'random'`` model under ``grad_accum=2``, one permutation for both
micro-batches, the eval step's permutation and the serving engine's
refusal of ``'random'``; the registry's new branches
and the flax round trip.  Inputs come from numpy seeds.  The model itself
is in ``test_torch_notebook_model.py``.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfc_vit_tpu import registry as jregistry
from sfc_vit_tpu.ops import gather_project as jgp
from sfc_vit_tpu.tokenizers import ConvPatchEmbedding as JConv
from sfc_vit_tpu.tokenizers import PixelCurveEmbedding1D as JPixel
from sfc_vit_tpu.tokenizers import compat as jcompat
from sfc_vit_tpu.training import losses as jlosses
from sfc_vit_tpu_torch.models import VisionTransformer, VisionTransformer1D, layers
from sfc_vit_tpu_torch.registry import build_model, build_tokenizer, preset_config
from sfc_vit_tpu_torch.serving import ServingEngine
from sfc_vit_tpu_torch.tokenizers import (
    ConvPatchEmbedding,
    FusedCurveProjection,
    PixelCurveEmbedding1D,
    compat,
)
from sfc_vit_tpu_torch.tokenizers.embeddings import _FusedConvProjection
from sfc_vit_tpu_torch.training import (
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
    warmup_cosine,
)
from sfc_vit_tpu_torch.utils import load_flax_params, to_flax_grads, to_flax_params

#: fp32 tokenizer outputs and gradients: the same products summed in
#: another order (a stride-p convolution against a matmul of the patches).
TOK_TOL = dict(rtol=1e-4, atol=1e-5)
CURVES = ("raster", "hilbert", "morton", "peano", "moore", "onion", "random")
#: The notebook preset cut to 16 px (16 tokens), d = 128, one layer of 2
#: heads of 64, MLP 64.
SMALL = dict(img_size=16, embed_dim=128, depth=1, n_heads=2, mlp_dim=64)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _images(n, hw=16, seed=0):
    return np.random.default_rng(seed).standard_normal((n, hw, hw, 3)).astype(np.float32)


def _perturbed(params, seed):
    """Every leaf perturbed, so unit scales and zero biases hide no
    mis-mapped leaf."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)


def _tree_close(got, want, **tol):
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_allclose(flat[path], np.asarray(leaf, np.float32),
                                   err_msg=jax.tree_util.keystr(path), **tol)


_JGP = jgp.gather_project


def _interpret_gp():
    """JAX's fused tokenizers through the Pallas kernel in interpret mode
    (on the CPU they would take its XLA twin).  The patched name also
    serves the kernel's own forward rule, which calls it positionally."""
    def interpreted(x, lut, w, b=None, block_n=None, interpret=True, group=1):
        return _JGP(x, lut, w, b, block_n, True, group)

    return mock.patch.object(jgp, "gather_project", interpreted)


def _record_perms(fn):
    """``fn()`` and every permutation JAX drew inside it."""
    perms, real = [], jax.random.permutation

    def spy(key, x, *args, **kw):
        out = real(key, x, *args, **kw)
        perms.append(np.asarray(out))
        return out

    with mock.patch.object(jax.random, "permutation", spy):
        out = fn()
    return out, perms


def _with_draws(fn):
    """``fn(params, *args) -> (loss, aux)`` as a jitted value-and-grad in
    ``params`` that also returns every dropout mask and permutation JAX
    draws inside, in draw order: ``((loss, (aux, masks, perms)), grads)``.
    The draws are recorded by wrapping ``jax.random.bernoulli`` and
    ``jax.random.permutation`` while the function is traced."""
    def wrapped(params, *args):
        masks, perms = [], []
        bernoulli, permutation = jax.random.bernoulli, jax.random.permutation

        def spy_mask(key, p=0.5, shape=None, *args, **kw):
            masks.append(bernoulli(key, p, shape, *args, **kw))
            return masks[-1]

        def spy_perm(key, x, *args, **kw):
            perms.append(permutation(key, x, *args, **kw))
            return perms[-1]

        with mock.patch.object(jax.random, "bernoulli", spy_mask), \
                mock.patch.object(jax.random, "permutation", spy_perm):
            loss, aux = fn(params, *args)
        return loss, (aux, masks, perms)

    return jax.jit(jax.value_and_grad(wrapped, has_aux=True))


def _replay_perm(monkeypatch, perm):
    """The port's permutation draws return JAX's ``perm``; returns the
    list of the draws made."""
    perm = np.asarray(perm)
    calls = []

    def draw(n, generator):
        calls.append(n)
        assert n == perm.shape[0]
        return torch.from_numpy(perm.astype(np.int64))

    monkeypatch.setattr(layers, "draw_permutation", draw)
    return calls


def _replay_masks(monkeypatch, masks):
    """The port's dropout masks are JAX's, in draw order; returns the queue
    of those not drawn yet."""
    queue = [np.asarray(m) for m in masks]

    def draw(shape, keep, device):
        mask = queue.pop(0)
        assert tuple(shape) == mask.shape
        return torch.from_numpy(mask.copy()).to(device)

    monkeypatch.setattr(layers, "dropout_mask", draw)
    return queue


def _jax_model(cfg, seed=0):
    jmodel = jregistry.build_model(jregistry.preset_config("notebook", **cfg))
    key = jax.random.key(seed)
    variables = jax.jit(jmodel.init)({"params": key, "permute": key},
                                     jnp.asarray(_images(1, hw=cfg["img_size"])))
    return jmodel, _perturbed(variables["params"], seed + 1)


def _rel_l2_close(got, want, tol):
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(leaves)
    for path, leaf in leaves:
        w = np.asarray(leaf, np.float64)
        err = np.linalg.norm(flat[path] - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= tol, (jax.tree_util.keystr(path), err)


# -- the 2-D tokenizer -----------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("curve", CURVES)
def test_conv_patch_embedding_matches_jax(monkeypatch, curve, fused):
    """Forward and parameter gradients of ``ConvPatchEmbedding`` (16 px,
    patch 4, D 32) against JAX's, fused through #14's plain version and
    JAX's kernel in interpret mode; ``'random'`` drops ``fused`` as JAX
    does, and replays JAX's permutation."""
    jtok = JConv(img_size=16, patch_size=4, embed_dim=32, curve=curve, fused=fused)
    x = _images(3)
    rngs = {"permute": jax.random.key(5)}
    params = _perturbed(jtok.init({"params": jax.random.key(0), **rngs},
                                  jnp.asarray(x))["params"], 1)

    def apply(p):
        return jtok.apply({"params": p}, jnp.asarray(x), rngs=rngs)

    with _interpret_gp():
        _, perms = _record_perms(lambda: apply(params))
        want, vjp = jax.vjp(apply, params)
    cot = np.random.default_rng(2).standard_normal(want.shape).astype(np.float32)
    (want_grads,) = vjp(jnp.asarray(cot))
    assert len(perms) == (curve == "random")
    calls = _replay_perm(monkeypatch, perms[0]) if perms else []
    tok = load_flax_params(ConvPatchEmbedding(16, 4, 32, curve=curve, fused=fused), params)
    assert isinstance(tok.proj, _FusedConvProjection) == (fused and curve != "random")
    assert (tok.n_patches, tok.grid_size) == (jtok.n_patches, jtok.grid_size)
    with layers.permutation_generator(torch.Generator()):
        got = tok(_t(x))
    assert len(calls) == len(perms)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOK_TOL)
    got.backward(_t(cot))
    _tree_close(to_flax_grads(tok), want_grads, **TOK_TOL)


def test_random_curve_needs_a_permutation_generator():
    """As flax needs a ``'permute'`` stream, the port needs an installed
    generator; inside one block every call takes the same permutation."""
    tok = ConvPatchEmbedding(16, 4, 32, curve="random")
    x = _t(_images(2))
    with pytest.raises(RuntimeError, match="permutation_generator"):
        tok(x)
    with layers.permutation_generator(torch.Generator().manual_seed(3)):
        a, b = tok(x), tok(x)
    with layers.permutation_generator(torch.Generator().manual_seed(3)):
        c = tok(x)
    assert torch.equal(a, b) and torch.equal(a, c)
    unshuffled = ConvPatchEmbedding(16, 4, 32)
    unshuffled.load_state_dict(tok.state_dict())
    ref = unshuffled(x)
    assert not torch.equal(a, ref)
    assert torch.equal(a.sort(dim=1).values, ref.sort(dim=1).values)  # a permutation


# -- the 1-D tokenizer -----------------------------------------------------------


@pytest.mark.parametrize("img, patch, curve, fused", [
    *((16, 4, c, f) for c in CURVES[:-1] for f in (False, True)),
    (32, 1, "hilbert", False), (32, 1, "hilbert", True), (32, 1, "raster", True),
    (33, 1, "hilbert", False), (33, 1, "onion", True),
])
def test_pixel_curve_embedding_1d_matches_jax(img, patch, curve, fused):
    """``PixelCurveEmbedding1D`` against JAX's: patch 4 for every curve,
    patch 1 at 32 px (1,024 tokens, F1's limit) and at 33 px (1,089, past
    it); fused (any curve but ``'raster'``) through #14."""
    jtok = JPixel(img_size=img, patch_size=patch, embed_dim=32, curve=curve, fused=fused)
    x = _images(2, hw=img)
    params = _perturbed(jtok.init(jax.random.key(0), jnp.asarray(x))["params"], 1)
    with _interpret_gp():
        want, vjp = jax.vjp(lambda p: jtok.apply({"params": p}, jnp.asarray(x)), params)
    cot = np.random.default_rng(2).standard_normal(want.shape).astype(np.float32)
    (want_grads,) = vjp(jnp.asarray(cot))
    tok = load_flax_params(PixelCurveEmbedding1D(img, patch, 32, curve=curve, fused=fused),
                           params)
    assert isinstance(tok.proj, FusedCurveProjection) == (fused and curve != "raster")
    assert (tok.n_patches, tok.grid_size) == (jtok.n_patches, jtok.grid_size)
    got = tok(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOK_TOL)
    got.backward(_t(cot))
    _tree_close(to_flax_grads(tok), want_grads, **TOK_TOL)


def test_pixel_curve_embedding_1d_refuses_ragged_patches():
    with pytest.raises(ValueError, match="divisible into 1D patches"):
        PixelCurveEmbedding1D(10, 3, 8)


# -- the reference's names -------------------------------------------------------


@pytest.mark.parametrize("name", compat.__all__)
def test_compat_names_build_what_jax_builds(name):
    """Each of the 17 reference names builds the module, curve and token
    count JAX's does; ``in_channels`` sets the port's ``channels``."""
    assert name in jcompat.__all__
    if name == "SFCEmbedding1D":
        from sfc_vit_tpu_torch.tokenizers import GroupedCurveEmbedding1D
        assert compat.SFCEmbedding1D is GroupedCurveEmbedding1D
        return
    kw = dict(img_size=16, in_channels=1, embed_dim=8)
    if not name.startswith("Hierarchical"):
        kw["patch_size"] = 4
    else:
        kw["patch_size_list"] = (4, 4, 1)
    jtok, tok = getattr(jcompat, name)(**kw), getattr(compat, name)(**kw)
    assert type(tok).__name__ == type(jtok).__name__
    assert (tok.curve, tok.n_patches) == (jtok.curve, jtok.n_patches)
    x = _t(_images(1)[..., :1])  # one channel: in_channels
    with layers.permutation_generator(torch.Generator()):
        out = tok(x)
    assert (out[0] if isinstance(out, list) else out).shape[-2] == tok.n_patches


# -- the 'random' curve in the train, eval and serving paths --------------------


def test_random_model_train_step_with_grad_accum_matches_jax(monkeypatch):
    """One train step of a ``'random'``-curve notebook model under
    ``grad_accum=2`` (no mixing).  JAX's step
    (``sfc_vit_tpu/training/steps.py:132-221``) folds the step into its key,
    splits it into the mixing, dropout and permutation keys, gives
    micro-batch i the rows i::2 and the i-th split of the dropout key, and
    one ``k_perm`` to both; the port draws one permutation for the step.
    JAX's masks and permutation replayed: the loss and every gradient."""
    cfg = dict(SMALL, curve="random")
    jmodel, params = _jax_model(cfg, seed=3)
    x = _images(4, seed=3)
    y = np.random.default_rng(3).integers(0, 10, 4).astype(np.int32)
    _, k_drop, k_perm = jax.random.split(jax.random.fold_in(jax.random.key(3), 0), 3)
    kds = jax.random.split(k_drop, 2)

    def micro_loss(p, xs, ys, kd):
        logits = jmodel.apply({"params": p}, xs, deterministic=False,
                              rngs={"dropout": kd, "permute": k_perm})
        return jlosses.soft_target_cross_entropy(logits, jax.nn.one_hot(ys, 10)), None

    step = _with_draws(micro_loss)
    masks, perms, losses, grads = [], [], [], []
    for i in range(2):
        (loss, (_, drawn, perm)), g = step(params, jnp.asarray(x[i::2]),
                                           jnp.asarray(y[i::2]), kds[i])
        masks += drawn
        perms += perm
        losses.append(float(loss))
        grads.append(g)
    assert len(perms) == 2 and np.array_equal(perms[0], perms[1])  # one a step
    want_grads = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, *grads)

    left = _replay_masks(monkeypatch, masks)
    calls = _replay_perm(monkeypatch, perms[0])
    model = load_flax_params(build_model(preset_config("notebook", **cfg), device="cpu"),
                             params)
    state = TrainState(model, make_optimizer(model.parameters(), lambda _: 0.0,
                                             grad_clip=float("inf")))
    m = make_train_step(10, use_mixing=False, grad_accum=2)(
        state, (_t(x), _t(y)), torch.Generator())
    assert not left and calls == [16]  # every mask replayed; one permutation
    np.testing.assert_allclose(float(m["loss"]), np.mean(losses), rtol=1e-5)
    _rel_l2_close(to_flax_grads(model), want_grads, 1e-4)


def test_eval_step_takes_one_permutation_and_serving_refuses_random():
    """JAX's eval step draws from the constant ``key(0)``: the port's eval
    step takes the same permutation on every call.  JAX's engine passes no
    ``'permute'`` stream, so the port's refuses a ``'random'`` model."""
    model = build_model(preset_config("notebook", **SMALL, curve="random"), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    state = TrainState(model, make_optimizer(model.parameters(), warmup_cosine(1e-3, 0, 1)))
    batch = (_t(_images(4)), torch.arange(4) % 10)
    step = make_eval_step(10)
    first, second = step(state, batch), step(state, batch)
    assert torch.equal(first["loss_sum"], second["loss_sum"])
    with pytest.raises(ValueError, match="random"):
        ServingEngine(model, None, (16, 16, 3), batch_sizes=(2,), device="cpu")
    plain = build_model(preset_config("notebook", **SMALL), device="cpu")
    engine = ServingEngine(plain, None, (16, 16, 3), batch_sizes=(2,), device="cpu")
    assert engine.predict(_images(3)).shape == (3, 10)


# -- the registry and the flax tree ---------------------------------------------


def test_notebook_preset_builds_on_the_cpu():
    model = build_model(preset_config("notebook"), device="cpu")
    assert type(model) is VisionTransformer and not hasattr(model, "mlp_mixer")
    tok = model.patch_embed
    assert isinstance(tok, ConvPatchEmbedding) and (tok.curve, tok.n_patches) == ("hilbert", 64)
    assert tok.proj.kernel.shape == (4, 4, 3, 256)
    layer = model.encoder.layer_5
    assert layer.self_attn.in_proj.kernel.shape == (256, 768) and layer.self_attn.n_heads == 4
    assert layer.linear1.kernel.shape == (256, 256)
    assert model.mlp_head.fact.W_seq.shape == (512, 64, 64)
    assert layers.family_a_route("auto", 64, 256, 4, 256, 0.1, True) == ("fused_mha", "unfused")
    assert layers.family_a_route("auto", 64, 256, 4, 256, 0.1, False) == ("packed", "unfused")


@pytest.mark.parametrize("overrides, cls, fused", [
    (dict(), ConvPatchEmbedding, False),
    (dict(fused=True), ConvPatchEmbedding, True),
    (dict(fused=True, curve="raster"), ConvPatchEmbedding, True),
    (dict(fused=True, curve="random"), ConvPatchEmbedding, False),
    (dict(tokenizer="1d"), PixelCurveEmbedding1D, False),
    (dict(tokenizer="1d", fused=True), PixelCurveEmbedding1D, True),
    (dict(tokenizer="1d", fused=True, curve="raster"), PixelCurveEmbedding1D, False),
])
def test_build_tokenizer_2d_and_1d(overrides, cls, fused):
    """The registry's 2-D and 1-D branches take JAX's gates: ``'random'``
    drops ``fused``; the 1-D family fuses any curve but ``'raster'``."""
    cfg = preset_config("notebook", **overrides)
    tok = build_tokenizer(cfg)
    assert type(tok) is cls and tok.fused == fused
    jtok = jregistry.build_tokenizer(jregistry.preset_config("notebook", **overrides))
    assert tok.n_patches == jtok.n_patches


@pytest.mark.parametrize("overrides", [
    dict(), dict(fused=True), dict(curve="random"), dict(tokenizer="1d", fused=True),
    dict(tokenizer="1d", patch_size=16, posemb="learned"), dict(tokenizer="hierarchical"),
    dict(model="vit1d", tokenizer="1d", patch_size=16), dict(model="vit1d", fused=True),
], ids=["2d", "2d-fused", "2d-random", "1d-fused", "1d-learned", "vit-hierarchical",
        "vit1d-1d", "vit1d-2d-fused"])
def test_flax_round_trip(overrides):
    """``utils/convert.py`` loads the flax tree of each ``'vit'`` model (and
    ``'vit1d'`` over the 1-D and 2-D tokenizers) at the preset's widths and
    writes it back bit for bit."""
    jcfg = jregistry.preset_config("notebook", **overrides)
    jmodel = jregistry.build_model(jcfg)
    key = jax.random.key(0)
    shapes = jax.eval_shape(jmodel.init, {"params": key, "permute": key},
                            jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    model = build_model(preset_config("notebook", **overrides), device="cpu")
    assert type(model) is (VisionTransformer1D if jcfg.model == "vit1d" else VisionTransformer)
    back = to_flax_params(load_flax_params(model, params))
    _tree_close(back, params, rtol=0, atol=0)
