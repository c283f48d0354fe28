"""Every head dim the attention kernels take (ROADMAP F5): the launchers'
rule, their routes by sub-heads and forms tables, and the port's ops and
small models against the JAX package at Dh 32, 48, 96, 128 and 256, on
the CPU.

The kernels #1 and #4-#7 walk a head as C = ceil(Dh / 64) sub-heads of 64
columns; a ragged head reads zeros past Dh, which add nothing.  Here the
wrappers run their plain versions on CPU tensors, against JAX's Pallas
kernels in interpret mode (``_packed_fwd``, ``fused_torch_mha``,
``fused_attention_block``), and small models (the flagship at 3 and 4
heads, 'hier' at 4, CurveViT at ``dim_head`` 128 and 32) are served and
trained one step against JAX from the same flax parameters.  The kernels
themselves are held to these plain versions on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``'s head-dims phase).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfc_vit_tpu import registry as jregistry
from sfc_vit_tpu.models import simple_vit as jsimple_vit
from sfc_vit_tpu.ops import fused_attention_block as jfab
from sfc_vit_tpu.ops import flash_attention as jflash
from sfc_vit_tpu.ops import fused_torch_attention as jfta
from sfc_vit_tpu.training import losses as jlosses
from sfc_vit_tpu_torch.models import family_a_route, layer_route
from sfc_vit_tpu_torch.models import layers as port_layers
from sfc_vit_tpu_torch.ops import (
    _build,
    fused_attention_block,
    fused_torch_mha,
    packed_flash_attention,
)
from sfc_vit_tpu_torch.registry import build_model, preset_config
from sfc_vit_tpu_torch.serving import ServingEngine
from sfc_vit_tpu_torch.training import TrainState, make_optimizer, make_train_step
from sfc_vit_tpu_torch.utils import load_flax_params, to_flax_grads
from test_torch_longctx import _jax_family_a_route, _jax_route, jax_on_its_chip  # noqa: F401

#: The head dims past 64 and 192 that the repo's presets reach: 'hier' at
#: 8 heads (32), the flagship at 16, 8, 6 and 3 (48, 96, 128, 256).
HEAD_DIMS = (32, 48, 96, 128, 256)
#: fp32: summation order only (PERF.md section 2's fp32 gate).
F32_TOL = dict(rtol=1e-4, atol=1e-4)
#: bf16: tests/test_torch_ops.py's, a few ulps at |x| ~ 4.
BF16_TOL = dict(rtol=4e-2, atol=4e-2)
#: One train step's gradients through a few fp32 layers with dropout:
#: relative L2 error of each tensor (tests/test_torch_family_a_train.py's).
GRAD_REL_L2 = 1e-4


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np(t):
    return np.asarray(t.float().detach().numpy() if isinstance(t, torch.Tensor) else t,
                      np.float32)


# -- the launchers' rule, routes and forms ------------------------------------


@pytest.mark.parametrize("dh", range(16, 257, 16))
def test_check_packed_takes_every_multiple_of_16(dh):
    """Every multiple of 16 up to 256 passes the head-dim rule: a CPU
    tensor gets as far as the device check."""
    assert _build.attention_head_dim_ok(dh)
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.zeros(1, 4, 3 * 2 * dh, dtype=dtype)
        with pytest.raises(ValueError, match="CUDA tensor"):
            _build._check_packed(qkv, 2, 4, "attention_fwd", None, 1.0)


@pytest.mark.parametrize("dh", [24, 40, 272, 320, 384])
def test_check_packed_refuses_other_head_dims_naming_f5(dh):
    """Widths that are not a multiple of 16 (24: 32 heads at d 768) or are
    over 256 (384 and 768: 2 and 1 heads at d 768) raise before any launch,
    naming ROADMAP F5's remainder."""
    assert not _build.attention_head_dim_ok(dh)
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.zeros(1, 4, 3 * 2 * dh, dtype=dtype)
        with pytest.raises(ValueError, match="F5"):
            _build._check_packed(qkv, 2, 4, "attention_fwd", None, 1.0)


@pytest.mark.parametrize("dh, c", [(16, 1), (32, 1), (48, 1), (64, 1), (80, 2), (96, 2),
                                   (128, 2), (144, 3), (192, 3), (208, 4), (256, 4)])
def test_routes_key_on_subheads(dh, c):
    """The forward's one-pass limit, the fp32 forward's one-pass columns and
    the backward's resident limit are those of the head dim's sub-heads:
    one pass (or the resident form) up to the limit, two passes (or the
    streamed form) one token past it."""
    assert _build.attention_subheads(dh) == c
    for masked in (False, True):
        limit = (_build.PACKED_ONE_PASS_MAX_N_MASKED if masked
                 else _build.PACKED_ONE_PASS_MAX_N)[c]
        assert _build.attention_fwd_route(dh, limit, masked) == "one pass"
        assert _build.attention_fwd_route(dh, limit + 1, masked) == "two passes"
        assert _build.attention_fwd_f32_columns(dh, limit, masked) == limit
        assert _build.attention_fwd_f32_columns(dh, limit + 1, masked) == 0
        bwd = _build.ATTENTION_BWD_SM90_LIMITS.get((c, masked), 0)
        assert bwd == {1: 192 if masked else 256, 2: 64, 3: 64, 4: 0}[c]
        if bwd:
            assert _build.attention_bwd_route(dh, bwd, masked) == "sm90"
        assert _build.attention_bwd_route(dh, bwd + 1, masked) == "streamed"


def test_forms_tables_list_every_new_instance():
    """The instances at two and four sub-heads (Dh 80 to 128, 208 to 256)
    are in the tables ``flash_kernel_attrs`` reads, so phase 2 prints each
    one's registers and spills."""
    for c in (1, 2, 3, 4):
        for table in (_build.PACKED_ATTENTION_FORMS, _build.PACKED_ATTENTION_MASKED_FORMS,
                      _build.PACKED_ATTENTION_F32_FORMS,
                      _build.PACKED_ATTENTION_F32_MASKED_FORMS):
            assert {(64 * c, 0), (64 * c, 64)} <= set(table.values())
    assert {"packed_attention dh128 one pass 192 keys", "packed_attention dh256 two passes",
            "packed_attention masked dh128 one pass 128 keys",
            "packed_attention masked dh256 one pass"} <= (
        set(_build.PACKED_ATTENTION_FORMS) | set(_build.PACKED_ATTENTION_MASKED_FORMS))
    assert {"attention_bwd_sm90 dh128", "attention_bwd_sm90 dh128 dropout"} <= set(
        _build.ATTENTION_BWD_SM90_FORMS)
    assert {f"attention_bwd_f32 {part} dh{dh}{masked}" for part in ("dq", "dkv")
            for dh in (128, 256) for masked in ("", " masked")} <= set(_build.F32_KERNEL_FORMS)
    assert {"packed_attention_f32 dh128 one pass 192 keys",
            "packed_attention_f32 dh256 one pass 64 keys masked"} <= set(
        _build.F32_KERNEL_FORMS)


# -- the ops against JAX's kernels in interpret mode --------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_packed_flash_attention_matches_jax_kernel(dh, dtype):
    """#7's plain version against ``_packed_fwd`` in interpret mode."""
    rng = np.random.default_rng(dh)
    qkv = _rand(rng, 2, 24, 3 * 2 * dh)
    want = jflash._packed_fwd(jnp.asarray(qkv, getattr(jnp, dtype)), 2, dh ** -0.5,
                              interpret=True)
    with torch.no_grad():
        got = packed_flash_attention(_t(qkv, getattr(torch, dtype)), 2)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_fused_torch_mha_matches_jax_kernels(dh):
    """#5's forward and #6's gradients (the plain versions) against JAX's
    ``_torch_mha_kernel`` / ``_torch_mha_bwd_kernel`` in interpret mode:
    two heads of ``dh`` (D = 2 dh), 24 tokens with 20 real, one 0/1 mask
    on both sides."""
    rng = np.random.default_rng(dh + 1)
    d, heads, b, n, keep, n_actual = 2 * dh, 2, 2, 24, 0.9, 20
    args = [_rand(rng, b, n, d), _rand(rng, d, 3 * d, scale=d ** -0.5),
            _rand(rng, 3 * d, scale=0.1), _rand(rng, d, d, scale=d ** -0.5),
            _rand(rng, d, scale=0.1)]
    mask, g = rng.random((b, heads, n, n)) < keep, _rand(rng, b, n, d)

    def jfn(*p):
        return jfta.fused_torch_mha(*p, jnp.asarray(mask, jnp.float32), heads, keep=keep,
                                    interpret=True, n_actual=n_actual, train_impl="pallas")

    want, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    want_grads = vjp(jnp.asarray(g))
    leaves = [_t(a).requires_grad_() for a in args]
    got = fused_torch_mha(*leaves, torch.from_numpy(mask), heads, keep=keep,
                          n_actual=n_actual)
    got.backward(_t(g))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    for name, t, w in zip(("dx", "dw_in", "db_in", "dw_out", "db_out"), leaves, want_grads):
        np.testing.assert_allclose(_np(t.grad), _np(w), err_msg=name, **F32_TOL)


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_fused_attention_block_matches_jax_kernels(dh):
    """#1's block (the plain version) against JAX's ``_attn_block_kernel``
    in interpret mode, and its gradients (#4's plain backward) against
    ``jax.vjp`` through JAX's backward kernel: d 128, two heads of ``dh``,
    40 tokens with 29 real (JAX pads them to 48)."""
    rng = np.random.default_rng(dh + 2)
    d, inner, b, n, n_actual = 128, 2 * dh, 2, 40, 29
    args = [_rand(rng, b, n, d), _rand(rng, d, scale=0.1) + 1.0, _rand(rng, d, scale=0.1),
            _rand(rng, d, 3 * inner, scale=d ** -0.5), _rand(rng, inner, d, scale=inner ** -0.5)]
    g = _rand(rng, b, n, d)
    want, vjp = jax.vjp(lambda *a: jfab.fused_attention_block(
        *a, 2, interpret=True, n_actual=n_actual, train_impl="pallas"),
        *map(jnp.asarray, args))
    want_grads = vjp(jnp.asarray(g))
    leaves = [_t(a).requires_grad_() for a in args]
    got = fused_attention_block(*leaves, heads=2, n_actual=n_actual)
    got.backward(_t(g))
    np.testing.assert_allclose(_np(got)[:, :n_actual], _np(want)[:, :n_actual], **F32_TOL)
    for name, t, w in zip(("dx", "dln_scale", "dln_bias", "dw_qkv", "dw_out"), leaves,
                          want_grads):
        np.testing.assert_allclose(_np(t.grad), _np(w), err_msg=name, **F32_TOL)


# -- small models, served and trained one step --------------------------------


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)


def _rel_l2_close(got, want, tol):
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(leaves)
    for path, leaf in leaves:
        w = np.asarray(leaf, np.float64)
        err = np.linalg.norm(flat[path] - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= tol, (jax.tree_util.keystr(path), err)


def _served_and_trained(monkeypatch, preset, overrides, hw, family_a):
    """The preset cut to ``overrides`` in JAX and in the port from the same
    (perturbed) parameters: ServingEngine's logits against JAX's eval
    forward, then one train step's loss and gradients (mixing off; family
    A with dropout, JAX's masks replayed in draw order) against
    ``jax.value_and_grad``."""
    rng = np.random.default_rng(7)
    x = _rand(rng, 5, hw, hw, 3)
    y = rng.integers(0, 10, 4).astype(np.int32)
    jmodel = jregistry.build_model(jregistry.preset_config(preset, **overrides))
    params = _perturbed(jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(x[:1]))["params"],
                        1)
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    model = load_flax_params(build_model(preset_config(preset, **overrides), device="cpu"),
                             params)
    engine = ServingEngine(model, None, (hw, hw, 3), batch_sizes=(2, 4), dtype=None,
                           device="cpu")
    np.testing.assert_allclose(engine.predict(x), _np(want), **F32_TOL)

    xb = x[:4]
    rngs = {"dropout": jax.random.key(2), "permute": jax.random.key(3)}
    kw = dict(deterministic=False, rngs=rngs) if family_a else {}
    keeps, real = [], jax.random.bernoulli

    def loss_fn(tree):
        # JAX's dropout masks, in draw order, out of the traced step as aux
        masks = []

        def spy(key, p=0.5, shape=None, *a, **k):
            masks.append(real(key, p, shape, *a, **k))
            keeps.append(float(p))
            return masks[-1]

        with mock.patch.object(jax.random, "bernoulli", spy):
            logits = jmodel.apply({"params": tree}, jnp.asarray(xb), **kw)
        return jlosses.soft_target_cross_entropy(logits, jax.nn.one_hot(y, 10)), masks

    (want_loss, masks), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    left = list(zip(map(np.asarray, masks), keeps))
    assert bool(left) == family_a
    if family_a:

        def draw(shape, keep, device):
            mask, p = left.pop(0)
            assert tuple(shape) == mask.shape and keep == pytest.approx(p)
            return torch.from_numpy(mask.copy())

        monkeypatch.setattr(port_layers, "dropout_mask", draw)
    state = TrainState(model.train(), make_optimizer(model.parameters(), lambda _: 0.0,
                                                     grad_clip=float("inf")))
    m = make_train_step(10, use_mixing=False)(state, (torch.from_numpy(xb),
                                                      torch.from_numpy(y)),
                                              torch.Generator())
    assert not left  # every mask replayed
    np.testing.assert_allclose(float(m["loss"]), float(want_loss), rtol=1e-5)
    _rel_l2_close(to_flax_grads(model), want_grads, GRAD_REL_L2)


@pytest.mark.parametrize("heads", [3, 4], ids=["dh128", "dh96"])
def test_flagship_at_other_head_counts_matches_jax(monkeypatch, heads):
    """A small flagship (img 16, three levels of 128 -> d 384, depth 2, MLP
    128) at 3 heads (Dh 128) and 4 (Dh 96)."""
    _served_and_trained(monkeypatch, "flagship",
                        dict(img_size=16, embed_dim=128, depth=2, n_heads=heads,
                             mlp_dim=128), 16, family_a=True)


def test_hier_at_head_dim_32_matches_jax(monkeypatch):
    """A small 'hier' (levels of d 128, one layer each, two fusion layers)
    at 4 heads: Dh 32, as 8 heads give at the preset's d 256."""
    _served_and_trained(monkeypatch, "flagship",
                        dict(model="hier", img_size=16, embed_dim=128, depth=1, n_heads=4,
                             mlp_dim=128), 16, family_a=True)


@pytest.mark.parametrize("heads, dim_head", [(2, 128), (4, 32)])
def test_curvevit_at_other_dim_heads_matches_jax(monkeypatch, heads, dim_head):
    """A small CurveViT (ViT-S/16's preset cut to d 128, depth 1, MLP 256
    over 49 tokens) at ``dim_head`` 128 and 32, JAX's fused gates forced on
    (its Pallas #1-#4 in interpret mode at fp32)."""
    monkeypatch.setattr(jsimple_vit, "_FORCE_FUSED", True)
    _served_and_trained(monkeypatch, "vit-s-16",
                        dict(img_size=28, patch_size=4, embed_dim=128, n_heads=heads,
                             dim_head=dim_head, depth=1, mlp_dim=256), 28, family_a=False)


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_routes_at_other_head_counts_match_jax_gates(impl, jax_on_its_chip):  # noqa: F811
    """``family_a_route`` and ``layer_route`` pick what JAX's gates pick on
    its chip at the head counts of this file: the flagship's d 768 at 3,
    6, 8 and 16 heads, 'hier''s d 256 at 2 and 8, and family B at
    ``dim_head`` 128 and 32 over 196 and 49 tokens."""
    for d, heads in ((768, 3), (768, 6), (768, 8), (768, 16), (256, 2), (256, 8)):
        for n in (64, 192):
            for training, rate in ((True, 0.1), (False, 0.1)):
                shape = (impl, n, d, heads, 512, rate, training)
                assert family_a_route(*shape) == _jax_family_a_route(*shape), shape
    for n, d, heads, dh in ((196, 768, 6, 128), (49, 128, 2, 128), (49, 128, 4, 32),
                            (196, 384, 12, 32)):
        shape = (n, d, heads * dh, 4 * d, dh)
        assert layer_route(impl, *shape) == _jax_route(impl, *shape), shape
