"""The port's models, registry and weight conversion against the JAX
package: the same flax params and the same images through both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfc_vit_tpu.models import CurveViT as JCurveViT
from sfc_vit_tpu.models import SimpleViT as JSimpleViT
from sfc_vit_tpu.models import simple_vit as jsimple_vit
from sfc_vit_tpu_torch.models import CurveViT, HilbertViT, SimpleViT
from sfc_vit_tpu_torch.registry import (
    PRESETS,
    build_model,
    preset_config,
)
from sfc_vit_tpu_torch.utils import load_flax_params, to_flax_params

#: 7x7 Hilbert grid -> 49 tokens, which the JAX stack pads to 64 and masks.
SMALL = dict(image_size=28, patch_size=4, dim=128, depth=2, heads=2,
             dim_head=64, mlp_dim=256, num_classes=10)
# fp32 logits through two layers: summation order only.
TOL = dict(rtol=1e-4, atol=1e-4)


def _images(n=3, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 28, 28, 3)).astype(np.float32)


def _flax_params(jmodel, seed=0):
    """Initialised params with every leaf perturbed, so unit LayerNorm
    scales and zero biases do not hide a mis-mapped leaf."""
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(_images(1)))
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        variables["params"])


def _port_logits(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("force_fused", [False, True])
def test_curvevit_matches_jax(monkeypatch, force_fused):
    """Against JAX's XLA path and, with ``_FORCE_FUSED``, its pad-once
    (49 -> 64 tokens) interpret-mode kernel path."""
    monkeypatch.setattr(jsimple_vit, "_FORCE_FUSED", force_fused)
    jmodel = JCurveViT(**SMALL)
    params = _flax_params(jmodel)
    x = _images()
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model = load_flax_params(CurveViT(**SMALL), params)
    np.testing.assert_allclose(_port_logits(model, x), want, **TOL)


def test_simplevit_matches_jax():
    jmodel = JSimpleViT(**SMALL)
    params = _flax_params(jmodel, seed=3)
    x = _images(seed=4)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model = load_flax_params(SimpleViT(**SMALL), params)
    np.testing.assert_allclose(_port_logits(model, x), want, **TOL)


@pytest.mark.parametrize("cls", [CurveViT, SimpleViT])
def test_flax_round_trip_is_exact(cls):
    jcls = JCurveViT if cls is CurveViT else JSimpleViT
    params = _flax_params(jcls(**SMALL), seed=5)
    back = to_flax_params(load_flax_params(cls(**SMALL), params))
    flat_in = jax.tree_util.tree_leaves_with_path(params)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_out[path], leaf)


def test_load_flax_params_rejects_a_missing_leaf():
    params = _flax_params(JCurveViT(**SMALL))
    del params["transformer"]["ff_1"]["fc2"]["bias"]
    with pytest.raises(KeyError, match="ff_1.fc2.bias"):
        load_flax_params(CurveViT(**SMALL), params)


def test_init_is_seeded_and_flax_shaped():
    a = CurveViT(**SMALL, generator=torch.Generator().manual_seed(0))
    b = CurveViT(**SMALL, generator=torch.Generator().manual_seed(0))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    k = a.transformer.attn_0.to_qkv.kernel
    assert k.shape == (128, 3 * 128)  # [in, out], as flax holds it
    std = float(k.detach().std())
    assert 0.8 * 128 ** -0.5 < std < 1.2 * 128 ** -0.5
    assert float(k.detach().abs().max()) <= 2 * 128 ** -0.5 / 0.87962566103423978


def test_hilbertvit_is_a_hilbert_curvevit():
    m = HilbertViT(T=4.0, **SMALL)
    assert isinstance(m, CurveViT)
    ref = CurveViT(curve="hilbert", **SMALL)
    assert torch.equal(m.to_patch_embedding.lut, ref.to_patch_embedding.lut)


# -- registry -----------------------------------------------------------


def test_presets_match_the_jax_registry():
    from sfc_vit_tpu.registry import PRESETS as JPRESETS

    assert PRESETS == JPRESETS


def test_build_model_vit_b_16_config():
    cfg = preset_config("vit-b-16", depth=1, num_classes=1000, dtype="bfloat16")
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert isinstance(model, CurveViT)
    assert model.to_patch_embedding.n_patches == 196
    attn = model.transformer.attn_0
    assert attn.heads == 12 and attn.to_qkv.kernel.shape == (768, 2304)
    assert model.transformer.ff_0.fc1.kernel.shape == (768, 3072)
    assert model.dtype == torch.bfloat16


@pytest.mark.parametrize("name, overrides, match", [
    ("notebook", {"remat": True}, "train step"),
    ("notebook", {"attn_impl": "ring"}, "sequence parallelism"),
    ("longctx-16k-hybrid", {"attn_impl": ("local", "local", "local", "ring")},
     "sequence parallelism"),
    ("vit-b-16", {"remat": True}, "train step"),
    ("vit-b-16", {"attn_impl": "xla_bf16"}, "bf16-softmax formula"),
])
def test_build_model_names_the_roadmap_item(name, overrides, match):
    with pytest.raises(NotImplementedError, match=match):
        build_model(preset_config(name, **overrides), device="cpu")


def test_build_model_rejects_unknown_curve():
    with pytest.raises(KeyError, match="unknown curve"):
        build_model(preset_config("vit-tiny-4", curve="nope"), device="cpu")
