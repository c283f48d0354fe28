"""The port's family-A path against the JAX package's, on the CPU in fp32.

Kernels #5/#6 (``fused_torch_mha``) and #7 (``packed_flash_attention``)
through their plain versions against the JAX TPU kernels in interpret
mode; the hierarchical tokenizer, the encoder layer, the mixer, the head
and a small ``VisionTransformer1D`` (the flagship's shape, cut down)
from the same flax parameters; the registry's refusals.  The train
step with dropout is in ``test_torch_family_a_train.py``.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfc_vit_tpu import registry as jregistry
from sfc_vit_tpu.models import layers as jlayers
from sfc_vit_tpu.ops import attention as jattention
from sfc_vit_tpu.ops import flash_attention as jflash
from sfc_vit_tpu.ops import fused_torch_attention as jfta
from sfc_vit_tpu.tokenizers import HierarchicalCurveEmbedding as JHier
from sfc_vit_tpu_torch.models import (
    MixerBlock,
    MultiLayerPredictor,
    TokenAggregator,
    TorchTransformerEncoderLayer,
    VisionTransformer1D,
)
from sfc_vit_tpu_torch.ops import (
    attention_with_weights,
    dot_product_attention_xla,
    fused_torch_mha,
    packed_flash_attention,
    packed_qkv_attention,
    torch_mha_train,
)
from sfc_vit_tpu_torch.registry import build_model, build_tokenizer, preset_config
from sfc_vit_tpu_torch.tokenizers import HierarchicalCurveEmbedding
from sfc_vit_tpu_torch.models import layers as port_layers
from sfc_vit_tpu_torch.training.trainer import _check_init_params
from sfc_vit_tpu_torch.utils import load_flax_params, to_flax_grads, to_flax_params

#: fp32 through one attention (kernel vs formula: summation order only).
OP_TOL = dict(rtol=1e-4, atol=1e-5)
#: fp32 logits and gradients through a few layers: summation order only.
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
#: The flagship cut to size: img 16, three levels of 16 tokens, d = 384,
#: depth 2, 2 heads of 192, MLP 128.
SMALL = dict(img_size=16, embed_dim=128, depth=2, n_heads=2, mlp_dim=128)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _perturbed(variables, seed):
    """Every leaf perturbed, so unit scales and zero biases hide no
    mis-mapped leaf."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        variables["params"])


def _tree_close(got, want, **tol):
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_allclose(flat[path], np.asarray(leaf),
                                   err_msg=jax.tree_util.keystr(path), **tol)


# -- kernels #5 / #6 ---------------------------------------------------------


def _mha_inputs(d, heads, seed=0, b=2, n=24, keep=0.9):
    rng = np.random.default_rng(seed)
    return dict(
        x=_rand(rng, b, n, d), w_in=_rand(rng, d, 3 * d, scale=d ** -0.5),
        b_in=_rand(rng, 3 * d, scale=0.1), w_out=_rand(rng, d, d, scale=d ** -0.5),
        b_out=_rand(rng, d, scale=0.1),
        mask=(rng.random((b, heads, n, n)) < keep),
        g=_rand(rng, b, n, d))


@pytest.mark.parametrize("d, heads", [(128, 2), (384, 2)], ids=["dh64", "dh192"])
def test_fused_torch_mha_matches_the_tpu_kernels(d, heads):
    """Forward and every gradient of the port's plain versions against
    JAX's ``_torch_mha_kernel`` / ``_torch_mha_bwd_kernel`` in interpret
    mode (24 tokens, 20 real, one 0/1 mask shared by both sides)."""
    a = _mha_inputs(d, heads)
    keep, n_actual = 0.9, 20
    args = [a[k] for k in ("x", "w_in", "b_in", "w_out", "b_out")]

    def jfn(*p):
        return jfta.fused_torch_mha(*p, jnp.asarray(a["mask"], jnp.float32), heads,
                                    keep=keep, interpret=True, n_actual=n_actual,
                                    train_impl="pallas")

    want, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    want_grads = vjp(jnp.asarray(a["g"]))

    leaves = [_t(v).requires_grad_() for v in args]
    before = (fused_torch_mha.launches, fused_torch_mha.bwd_launches)
    got = fused_torch_mha(*leaves, _t(a["mask"]), heads, keep=keep,
                          n_actual=n_actual)
    got.backward(_t(a["g"]))
    assert (fused_torch_mha.launches, fused_torch_mha.bwd_launches) == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **OP_TOL)
    for name, t, w in zip(("dx", "dw_in", "db_in", "dw_out", "db_out"), leaves,
                          want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), err_msg=name,
                                   **OP_TOL)
    assert not leaves[0].grad[:, n_actual:].any()  # pad rows: zero dx
    with torch.no_grad():  # the no-grad forward takes the same plain version
        np.testing.assert_allclose(
            fused_torch_mha(*map(_t, args), _t(a["mask"]), heads, keep=keep,
                            n_actual=n_actual).numpy(), np.asarray(want), **OP_TOL)


def test_torch_mha_train_matches_jax():
    a = _mha_inputs(128, 4, seed=1, n=16)
    args = [a[k] for k in ("x", "w_in", "b_in", "w_out", "b_out")]
    mask = a["mask"]

    def jfn(*p):
        return jfta.torch_mha_train(*p, jnp.asarray(mask), 4, keep=0.8, n_actual=13)

    want, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    want_grads = vjp(jnp.asarray(a["g"]))
    leaves = [_t(v).requires_grad_() for v in args]
    got = torch_mha_train(*leaves, _t(mask), 4, keep=0.8, n_actual=13)
    got.backward(_t(a["g"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **OP_TOL)
    for t, w in zip(leaves, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **OP_TOL)


def test_fused_torch_mha_refuses_what_jax_refuses():
    a = _mha_inputs(128, 2)
    x, w = _t(a["x"]), _t(a["w_in"])
    with pytest.raises(ValueError, match="keep > 0"):
        fused_torch_mha(x, w, _t(a["b_in"]), _t(a["w_out"]), _t(a["b_out"]),
                        _t(a["mask"]), 2, keep=0.0)
    with pytest.raises(ValueError, match=r"\[D, 3D\]"):
        fused_torch_mha(x, w[:, :128], _t(a["b_in"]), _t(a["w_out"]),
                        _t(a["b_out"]), _t(a["mask"]), 2, keep=0.9)


@pytest.mark.parametrize("d, impl, rate", [(384, "auto", 0.1), (384, "xla", 0.1),
                                           (96, "auto", 0.1), (384, "auto", 1.0)],
                         ids=["fused", "explicit-xla", "explicit-narrow", "rate-one"])
def test_mha_training_branches_match_jax(monkeypatch, d, impl, rate):
    """``TorchMultiHeadAttention`` training with dropout, JAX's masks
    replayed through the port's draw function: the fused branch (#5/#6's
    plain versions on the CPU), the explicit-weights branch (``'xla'``, or
    D not a multiple of 128) and rate 1 (no draw, every weight dropped);
    the output and every gradient."""
    rng = np.random.default_rng(9)
    x, g = _rand(rng, 2, 16, d), _rand(rng, 2, 16, d)
    jmod = jlayers.TorchMultiHeadAttention(dim=d, n_heads=2, dropout_rate=rate,
                                           attn_impl=impl)
    params = _perturbed(jmod.init(jax.random.key(0), jnp.asarray(x)), 1)

    def jfn(p, xx):
        return jmod.apply({"params": p}, xx, deterministic=False,
                          rngs={"dropout": jax.random.key(2)})

    masks, real = [], jax.random.bernoulli

    def spy(key, p=0.5, shape=None):
        masks.append(np.asarray(real(key, p, shape)))
        return masks[-1]

    with mock.patch.object(jax.random, "bernoulli", spy):
        jfn(params, jnp.asarray(x))
    assert len(masks) == (rate < 1.0)
    want, vjp = jax.vjp(jfn, params, jnp.asarray(x))
    want_gp, want_gx = vjp(jnp.asarray(g))

    def draw(shape, keep, device):
        mask = masks.pop(0)
        assert tuple(shape) == mask.shape and keep == pytest.approx(1.0 - rate)
        return torch.from_numpy(mask.copy())

    monkeypatch.setattr(port_layers, "dropout_mask", draw)
    mod = load_flax_params(port_layers.TorchMultiHeadAttention(d, 2, rate, attn_impl=impl),
                           params).train()
    xt = _t(x).requires_grad_()
    got = mod(xt)
    got.backward(_t(g))
    assert not masks  # every mask replayed
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **OP_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), **OP_TOL)
    # The key bias's gradient is summation noise (~1e-5; the softmax is
    # invariant to it) beside entries up to ~15.
    _tree_close(to_flax_grads(mod), want_gp, **MODEL_TOL)


# -- kernel #7 ---------------------------------------------------------------


@pytest.mark.parametrize("heads, dh", [(2, 64), (2, 192)])
def test_packed_flash_attention_matches_the_tpu_kernel(heads, dh):
    """No grad: the plain version against ``_packed_kernel`` in interpret
    mode.  Under autograd: JAX's store-weights rule, forward and dqkv."""
    rng = np.random.default_rng(2)
    qkv = _rand(rng, 2, 24, 3 * heads * dh)
    g = _rand(rng, 2, 24, heads * dh)
    s = dh ** -0.5
    want = jflash._packed_fwd(jnp.asarray(qkv), heads, s, interpret=True)
    with torch.no_grad():
        got = packed_flash_attention(_t(qkv), heads)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
        np.testing.assert_allclose(packed_qkv_attention(_t(qkv), heads).numpy(),
                                   np.asarray(want), **OP_TOL)
    want_out, vjp = jax.vjp(lambda q: jflash.packed_flash_attention(q, heads),
                            jnp.asarray(qkv))
    leaf = _t(qkv).requires_grad_()
    out = packed_flash_attention(leaf, heads)
    out.backward(_t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **OP_TOL)
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               **OP_TOL)
    assert packed_flash_attention.launches == 0  # counts CUDA launches only


def test_attention_formulas_match_jax():
    rng = np.random.default_rng(8)
    q, k, v = (_rand(rng, 2, 20, 3, 64) for _ in range(3))
    want = jattention.dot_product_attention_xla(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(dot_product_attention_xla(*map(_t, (q, k, v))).numpy(),
                               np.asarray(want), **OP_TOL)
    out, w = attention_with_weights(*map(_t, (q, k, v)), scale=0.1)
    jout, jw = jattention.attention_with_weights(*map(jnp.asarray, (q, k, v)), scale=0.1)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **OP_TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **OP_TOL)
    qkv = _rand(rng, 2, 20, 3 * 3 * 64)
    np.testing.assert_allclose(
        packed_qkv_attention(_t(qkv), 3, implementation="xla").numpy(),
        np.asarray(jattention.packed_qkv_attention(jnp.asarray(qkv), 3,
                                                    implementation="xla")), **OP_TOL)


def test_packed_qkv_attention_refuses_unported_implementations():
    qkv = torch.zeros(1, 4, 3 * 64)
    for impl, item in [("ring", "item 13"), ("sp", "item 13"),
                       ("xla_bf16", "item 2")]:
        with pytest.raises(NotImplementedError, match=item):
            packed_qkv_attention(qkv, 1, implementation=impl)
    with pytest.raises(ValueError, match="unknown attention"):
        packed_qkv_attention(qkv, 1, implementation="nope")


# -- modules and the model ---------------------------------------------------


def _images(n, hw=16, seed=0):
    return np.random.default_rng(seed).standard_normal((n, hw, hw, 3)).astype(np.float32)


@pytest.mark.parametrize("psl, levels", [((16, 4, 1), False), ((4, 4, 1), False),
                                         ((16, 4, 1), True)],
                         ids=["flagship", "upsampled", "levels"])
def test_hierarchical_tokenizer_matches_jax(psl, levels):
    """(4, 4, 1) at 16 px gives 64, 16 and 16 tokens: the coarse levels go
    through the linear upsample."""
    jtok = JHier(img_size=16, patch_size_list=psl, embed_dim=32, curve="morton",
                 return_levels=levels)
    x = _images(3)
    params = _perturbed(jtok.init(jax.random.key(0), jnp.asarray(x)), 1)
    want = jtok.apply({"params": params}, jnp.asarray(x))
    tok = HierarchicalCurveEmbedding(16, psl, 32, curve="morton", return_levels=levels)
    load_flax_params(tok, params)
    assert (tok.patch_list, tok.n_patches, tok.out_dim) == (
        jtok.patch_list, jtok.n_patches, jtok.out_dim)
    with torch.no_grad():
        got = tok(_t(x))
    for g, w in zip(got if levels else [got], want if levels else [want]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL)


def _module_parity(jmod, mod, x, seed, **apply_kw):
    params = _perturbed(jmod.init(jax.random.key(seed), jnp.asarray(x), **apply_kw), seed + 1)
    want = jmod.apply({"params": params}, jnp.asarray(x), **apply_kw)
    load_flax_params(mod, params)
    with torch.no_grad():
        np.testing.assert_allclose(mod.eval()(_t(x)).numpy(), np.asarray(want),
                                   **MODEL_TOL)


def test_encoder_layer_mixer_and_head_match_jax():
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 16, 384)
    _module_parity(jlayers.TorchTransformerEncoderLayer(dim=384, n_heads=2,
                                                        hidden_dim=128),
                   TorchTransformerEncoderLayer(384, 2, 128), x, 4)
    _module_parity(jlayers.MixerBlock(seq_len=16, embed_dim=384, hidden_dim=768),
                   MixerBlock(16, 384, 768), x, 5)
    for mix, n_layers in ((False, 2), (True, 3)):
        _module_parity(jlayers.MultiLayerPredictor(embed_dim=384, seq_len=16,
                                                   n_layers=n_layers, mix=mix),
                       MultiLayerPredictor(384, 16, n_layers=n_layers, mix=mix), x, 6)
    _module_parity(jlayers.TokenAggregator(dim=384), TokenAggregator(384), x, 7)


def _jax_flagship(seed=0, **overrides):
    jmodel = jregistry.build_model(jregistry.preset_config("flagship", **SMALL,
                                                           **overrides))
    params = _perturbed(jmodel.init(jax.random.key(seed), jnp.asarray(_images(1))),
                        seed + 1)
    return jmodel, params


def _port_flagship(params=None, **overrides):
    model = build_model(preset_config("flagship", **SMALL, **overrides), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    return model if params is None else load_flax_params(model, params)


@pytest.mark.parametrize("posemb", ["none", "gfpe", "learned"])
def test_vision_transformer_1d_matches_jax(posemb):
    jmodel, params = _jax_flagship(posemb=posemb)
    x = _images(3, seed=1)
    want = jmodel.apply({"params": params}, jnp.asarray(x))
    model = _port_flagship(params, posemb=posemb).eval()
    assert isinstance(model, VisionTransformer1D)
    with torch.no_grad():
        np.testing.assert_allclose(model(_t(x)).numpy(), np.asarray(want), **MODEL_TOL)


def test_flax_round_trip_and_init_params_check():
    _, params = _jax_flagship(seed=2)
    model = _port_flagship()
    _check_init_params(model, params)
    back = to_flax_params(load_flax_params(model, params))
    _tree_close(back, params, rtol=0, atol=0)
    bad = jax.tree_util.tree_map(np.asarray, params)
    bad["mlp_head"]["fact"]["W_seq"] = bad["mlp_head"]["fact"]["W_seq"][:, :8]
    with pytest.raises(ValueError, match="mlp_head/fact/W_seq"):
        _check_init_params(model, bad)


# -- the registry --------------------------------------------------------------


def test_build_tokenizer_and_flagship_shapes():
    cfg = preset_config("flagship")
    tok = build_tokenizer(cfg)
    assert (tok.patch_list, tok.n_patches, tok.out_dim) == ([64, 64, 64], 64, 768)
    model = build_model(preset_config("flagship", depth=1), device="cpu")
    attn = model.encoder.layer_0.self_attn
    assert attn.in_proj.kernel.shape == (768, 2304) and attn.n_heads == 4
    assert model.encoder.layer_0.linear1.kernel.shape == (768, 512)
    assert model.mlp_head.fact.W_seq.shape == (1536, 64, 64)


def test_build_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(preset_config("flagship", depth=1))


@pytest.mark.parametrize("overrides, exc, match", [
    (dict(model="vit", remat=True), NotImplementedError, "queue 1 item 4"),
    (dict(model="hier", remat=True), NotImplementedError, "queue 1 item 4"),
    (dict(tokenizer="1d", curve="random"), ValueError, "2d tokenizer"),
    (dict(model="hier", tokenizer="2d"), ValueError, "requires tokenizer='hierarchical'"),
    (dict(model="vit", tokenizer="3d"), KeyError, "unknown tokenizer family"),
    (dict(attn_impl="sp"), NotImplementedError, "queue 1 item 13"),
    (dict(remat=True), NotImplementedError, "queue 1 item 4"),
    (dict(curve="random"), ValueError, "2d tokenizer"),
    (dict(merge_layers=(1,)), ValueError, "curvevit"),
    (dict(attn_impl=("auto", "auto")), ValueError, "family-B"),
])
def test_build_model_refusals_name_their_item(overrides, exc, match):
    with pytest.raises(exc, match=match):
        build_model(preset_config("flagship", **overrides), device="cpu")
