"""The port's long-context path against the JAX package on the CPU: token
merging, a small merged CurveViT past 1,024 tokens (flash attention's
plain versions), the registry's long-context presets and the layer
routing of both families, held to JAX's own gates on its chip.

Inputs come from ``np.random.default_rng``; JAX runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfc_vit_tpu.ops.attention as jattention
import sfc_vit_tpu.ops.flash_attention as jfa
import sfc_vit_tpu.ops.fused_attention_block as jfab
import sfc_vit_tpu.ops.fused_mlp as jmlp
import sfc_vit_tpu.ops.fused_torch_attention as jfta
from sfc_vit_tpu.models import CurveViT as JCurveViT
from sfc_vit_tpu.models import layers as jlayers
from sfc_vit_tpu.models import simple_vit as jsimple_vit
from sfc_vit_tpu.ops.token_merge import curve_pair_merge_topk as jmerge
from sfc_vit_tpu.training import losses as jlosses
from sfc_vit_tpu_torch.models import CurveViT, family_a_route, layer_route
from sfc_vit_tpu_torch.ops import multi_head_attention
from sfc_vit_tpu_torch.ops.token_merge import curve_pair_merge_topk
from sfc_vit_tpu_torch.registry import PRESETS, build_model, preset_config
from sfc_vit_tpu_torch.training import soft_target_cross_entropy
from sfc_vit_tpu_torch.utils import load_flax_params, to_flax_grads

# fp32: the same arithmetic summed in another order.
OP_TOL = dict(rtol=1e-5, atol=1e-6)
# fp32 logits and gradients through three layers.
TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# -- token merge ----------------------------------------------------------------


def _merge_input(seed, tied):
    """[2, 16, 8]; with ``tied`` pairs 0-3 of each image are one repeated
    pair (equal similarities) and pair 5 repeats pair 4."""
    x = np.random.default_rng(seed).standard_normal((2, 16, 8)).astype(np.float32)
    if tied:
        x[:, 2:8] = np.tile(x[:, 0:2], (1, 3, 1))
        x[:, 10:12] = x[:, 8:10]
    return x


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("ratio", [0.0, 0.25, 0.5, 1.0])
def test_curve_pair_merge_topk_matches_jax(ratio, tied):
    """Forward and gradients (through the average and the gathers);
    stable sorts break ties by pair index on both sides."""
    x = _merge_input(0, tied)
    want = np.asarray(jmerge(jnp.asarray(x), ratio))
    xt = _t(x).requires_grad_()
    got = curve_pair_merge_topk(xt, ratio)
    assert got.shape == want.shape == (2, 16 - int(8 * ratio), 8)
    np.testing.assert_allclose(got.detach().numpy(), want, **OP_TOL)
    w = np.random.default_rng(1).standard_normal(want.shape).astype(np.float32)
    jgrad = jax.grad(lambda a: jnp.sum(jmerge(a, ratio) * jnp.asarray(w)))(jnp.asarray(x))
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), **OP_TOL)


def test_curve_pair_merge_topk_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="even"):
        curve_pair_merge_topk(torch.zeros(1, 5, 4))
    with pytest.raises(ValueError, match="merge_ratio"):
        curve_pair_merge_topk(torch.zeros(1, 4, 4), 1.5)


# -- a small merged CurveViT past 1,024 tokens ------------------------------------

#: 36 x 36 pixels along the Hilbert curve: 1,296 tokens in layers 0 and 1
#: (flash attention under 'auto'), 972 after the merge in layer 2 (kernel
#: #7's route); widths under 128, so no fused block and the plain MLP.
LONG = dict(image_size=36, patch_size=1, num_classes=10, dim=64, depth=3, heads=1,
            dim_head=64, mlp_dim=128, merge_layers=(1,), merge_ratio=0.5)


def test_small_model_routes_through_flash_and_packed():
    assert layer_route("auto", 1296, 64, 64, 128, 64) == ("flash", "xla")
    assert layer_route("auto", 972, 64, 64, 128, 64) == ("packed", "xla")
    assert layer_route("pallas", 972, 64, 64, 128, 64) == ("flash", "xla")


@pytest.mark.parametrize("impl", ["pallas", "auto"])
def test_merged_curvevit_matches_jax(impl):
    """Logits and one train step's gradients (soft-target cross entropy)
    against JAX's CurveViT under 'xla', in fp32."""
    jmodel = JCurveViT(**LONG, attn_impl="xla")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 36, 36, 3)).astype(np.float32)
    y = np.array([3, 7])
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x))
        return jlosses.soft_target_cross_entropy(logits, jax.nn.one_hot(y, 10)), logits

    (want_loss, want_logits), want_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    model = load_flax_params(CurveViT(**LONG, attn_impl=impl), params)
    logits = model(_t(x))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), **TOL)
    loss = soft_target_cross_entropy(logits, torch.nn.functional.one_hot(
        torch.from_numpy(y), 10).float())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got = dict(jax.tree_util.tree_leaves_with_path(to_flax_grads(model)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want_grads):
        np.testing.assert_allclose(got[path], np.asarray(leaf),
                                   err_msg=jax.tree_util.keystr(path), **TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_multi_head_attention_matches_jax(impl):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 300, 2, 64)).astype(np.float32) for _ in range(3))
    want = jattention.multi_head_attention(*map(jnp.asarray, (q, k, v)),
                                           implementation="xla")
    got = multi_head_attention(_t(q), _t(k), _t(v), implementation=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


# -- registry ---------------------------------------------------------------------


def test_build_model_builds_the_longctx_preset_on_cpu():
    cfg = preset_config("longctx-16k")
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert isinstance(model, CurveViT)
    assert model.to_patch_embedding.n_patches == 128 * 128
    assert model.transformer.merge_layers == (1,) and model.transformer.merge_ratio == 0.5
    assert model.dtype == torch.bfloat16
    assert {m.attn_impl for n, m in model.transformer.named_children()
            if n.startswith("attn_")} == {"auto"}


def test_build_model_refuses_unported_schedule_entries():
    """A schedule that names an implementation still to port ('sp',
    'ring') is refused, in the registry and in the model, naming its
    ROADMAP.md item (the hybrid preset itself builds:
    tests/test_torch_local.py)."""
    with pytest.raises(NotImplementedError, match="item 13"):
        build_model(preset_config("longctx-16k-hybrid",
                                  attn_impl=("local", "local", "sp", "auto")), device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        CurveViT(**LONG, attn_impl=("auto", "local", "ring"))


def test_attn_impl_schedule_length_is_checked():
    with pytest.raises(ValueError, match="3 entries for depth 2"):
        build_model(preset_config("vit-tiny-4", depth=2, attn_impl=("auto",) * 3),
                    device="cpu")


# -- routing: the port's gates against JAX's own on its chip ---------------------


def _jax_route(impl, n, d, inner, f, dh):
    """Which path JAX's modules take on a TPU for this layer, read by
    tracing them (``jax.eval_shape``) with the kernels replaced by
    recorders; called under the fixture below."""
    taken = []
    if jsimple_vit._fused_attn_gate(impl, n, d, inner, jnp.bfloat16):
        attn = "fused_block"
    else:
        def packed(qkv, heads, scale=None, *a, **k):
            taken.append("packed")
            return jnp.zeros(qkv.shape[:2] + (qkv.shape[2] // 3,), qkv.dtype)

        def flash(q, k, v, *a, **kw):
            taken.append("flash")
            return q

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jfa, "packed_flash_attention", packed)
            mp.setattr(jfa, "flash_attention", flash)
            jax.eval_shape(lambda a: jattention.packed_qkv_attention(
                a, inner // dh, implementation=impl),
                jax.ShapeDtypeStruct((1, n, 3 * inner), jnp.bfloat16))
        attn = taken[0] if taken else "xla"
    taken.clear()

    def fused(*a, **k):
        taken.append("fused_mlp")
        return a[0]

    def xla(*a, **k):
        taken.append("xla")
        return a[0]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmlp, "fused_mlp_block", fused)
        mp.setattr(jmlp, "mlp_block_xla", xla)
        ff = jsimple_vit._FeedForward(dim=d, hidden_dim=f, dtype=jnp.bfloat16)
        jax.eval_shape(ff.init, jax.random.PRNGKey(0),
                       jax.ShapeDtypeStruct((1, 8, d), jnp.bfloat16))
    return attn, taken[0]


@pytest.fixture
def jax_on_its_chip(monkeypatch):
    """JAX's gates as on a TPU (``jax.default_backend`` reads "tpu"), with
    its VMEM budgets lifted: the port ports the gates without them, since
    Hopper kernels tile."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jfab, "_VMEM_LIMIT", 2 ** 60)
    monkeypatch.setattr(jmlp, "_VMEM_LIMIT", 2 ** 60)
    monkeypatch.setattr(jfta, "_VMEM_LIMIT", 2 ** 60)
    monkeypatch.setattr(jfa, "packed_attention_fits",
                        lambda n, three_inner, itemsize: n <= jfa._PACKED_MAX_N)


def _preset_layers():
    """(n, d, inner, f, dh) of every family-B preset's layers, and
    CurveViT-S/12 at 4,096 tokens; longctx-16k also after its merge."""
    out = []
    for name, p in PRESETS.items():
        if p["model"] not in ("simple", "curvevit"):
            continue
        cfg = preset_config(name)
        n = (cfg.img_size // cfg.patch_size) ** 2
        layer = (cfg.embed_dim, cfg.n_heads * cfg.dim_head, cfg.mlp_dim, cfg.dim_head)
        out.append((n, *layer))
        if cfg.merge_layers:
            out.append((n - int(n // 2 * cfg.merge_ratio), *layer))
    out.append((4096, 384, 384, 1536, 64))
    return out


@pytest.mark.parametrize("impl", ["auto", "xla", "pallas"])
def test_layer_route_matches_jax_gates(impl, jax_on_its_chip):
    """The port's route for each preset's layer shapes and for N in {196,
    1024, 1025, 4096, 8192, 12288, 16384} x d in {192, 384, 768} (heads of
    64, MLP 4d) is JAX's route on its chip.  Before the port routed like
    this, every 'auto' layer took the fused blocks on the card, where JAX
    takes flash attention past 1,024 tokens and the unfused blocks at
    widths that are not multiples of 128 (vit-tiny-4, d = 192)."""
    shapes = _preset_layers() + [
        (n, d, d, 4 * d, 64) for n in (196, 1024, 1025, 4096, 8192, 12288, 16384)
        for d in (192, 384, 768)]
    for shape in shapes:
        assert layer_route(impl, *shape) == _jax_route(impl, *shape), shape
    assert layer_route("auto", 64, 192, 192, 768, 64) == ("packed", "xla")  # vit-tiny-4
    assert layer_route("auto", 16384, 384, 384, 1536, 64) == ("flash", "fused_mlp")


def _jax_family_a_route(impl, n, d, heads, f, rate, training):
    """Which paths JAX's ``TorchTransformerEncoderLayer`` takes on a TPU
    (bf16), read by tracing it with the kernels and formulas replaced by
    recorders; called under ``jax_on_its_chip``."""
    taken = []

    def record(name, result):
        def fn(*a, **k):
            taken.append(name)
            return result(*a)
        return fn

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfta, "fused_torch_mha", record("fused_mha", lambda x, *a: x))
        mp.setattr(jattention, "attention_with_weights", record(
            "mha_train", lambda q, k, v: (q, jnp.einsum("bnhd,bmhd->bhnm", q, k))))
        mp.setattr(jlayers, "packed_qkv_attention", record(
            "packed", lambda qkv, h: qkv[..., : qkv.shape[-1] // 3]))
        mp.setattr(jmlp, "fused_postnorm_tail", record("postnorm_tail", lambda x, *a: x))
        layer = jlayers.TorchTransformerEncoderLayer(
            dim=d, n_heads=heads, hidden_dim=f, dropout_rate=rate, dtype=jnp.bfloat16,
            attn_impl=impl)
        key = jax.random.key(0)
        jax.eval_shape(lambda x: layer.init({"params": key, "dropout": key}, x,
                                            deterministic=not training),
                       jax.ShapeDtypeStruct((1, n, d), jnp.bfloat16))
    attn = [t for t in taken if t != "postnorm_tail"]
    assert len(attn) == 1, taken
    return attn[0], "postnorm_tail" if "postnorm_tail" in taken else "unfused"


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_family_a_route_matches_jax_gates(impl, jax_on_its_chip):
    """``models.family_a_route`` against JAX's family-A layer on its chip for
    N in {64, 192, 1024, 1025, 4096} x d in {256, 768} (heads of 64 and
    192) x MLP in {512, 1024}, training with dropout 0.1 and 0 and in eval.
    Before the port routed like this, training with dropout took #5/#6 at
    every length, where JAX takes the explicit-weights formula past 1,024
    tokens."""
    for n in (64, 192, 1024, 1025, 4096):
        for d in (256, 768):
            for f in (512, 1024):
                for training, rate in ((True, 0.1), (True, 0.0), (False, 0.1)):
                    shape = (impl, n, d, 4, f, rate, training)
                    assert family_a_route(*shape) == _jax_family_a_route(*shape), shape
    assert family_a_route("auto", 1024, 256, 4, 1024, 0.1, True) == ("fused_mha", "unfused")
    assert family_a_route("auto", 1025, 256, 4, 1024, 0.1, True) == ("mha_train", "unfused")
    assert family_a_route("auto", 64, 768, 4, 1024, 0.0, True) == ("packed", "postnorm_tail")
