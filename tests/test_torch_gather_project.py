"""The port's fused gather + projection (#14) and the fused hierarchical
tokenizer against the JAX package on the CPU.

``gather_project_ref`` (the plain version of ``csrc/gather_project.cu``)
is held against JAX's ``gather_project`` in interpret mode (the TPU
kernel's one-hot gather and fp32 bias epilogue) for groups of 1, 4 and
16, with and without a bias and with a LUT that repeats indices; the
backward against ``jax.vjp``; the fused hierarchical tokenizer and a
small fused flagship against JAX's with ``fused=True``, parameters
carried across by ``utils/convert.py``.  Inputs come from
``np.random.default_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfc_vit_tpu import registry as jregistry
from sfc_vit_tpu.ops import gather_project as jgp
from sfc_vit_tpu.tokenizers import HierarchicalCurveEmbedding as JHier
from sfc_vit_tpu_torch.ops.gather_project import (
    gather_project,
    gather_project_ref,
    gather_project_xla,
)
from sfc_vit_tpu_torch.registry import build_model, preset_config
from sfc_vit_tpu_torch.tokenizers import FusedCurveProjection, HierarchicalCurveEmbedding
from sfc_vit_tpu_torch.utils import load_flax_params, to_flax_grads, to_flax_params

# fp32: the same products summed in another order.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16: the kernel's order (bias added to the fp32 sum, one rounding)
# against JAX's XLA twin (the sum rounded, then the bias added in bf16):
# one extra bf16 rounding, 2^-8 relative, on values of magnitude ~4.
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# fp32 logits and gradients through a few layers.
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, n, k, m, group, d, repeat=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, n, k)).astype(np.float32)
    lut = rng.integers(0, n, m * group) if repeat else rng.permutation(n)[:m * group]
    if repeat:
        lut[-1] = lut[0]  # at least one index taken twice
    w = (rng.standard_normal((group * k, d)) * (group * k) ** -0.5).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    g = rng.standard_normal((2, m, d)).astype(np.float32)
    return x, lut.astype(np.int32), w, b, g


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


#: (n, k, m, group): the flagship's three levels cut to a 16 px image
#: (64 pixels x 3 in groups of 16; 16 pre-patches x 12 in groups of 4; 4 x
#: 48 in groups of 1), and a ragged output count.
SHAPES = [(64, 3, 4, 16), (16, 12, 4, 4), (4, 48, 4, 1), (50, 8, 13, 3)]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("n, k, m, group", SHAPES)
def test_gather_project_ref_matches_pallas(n, k, m, group, bias):
    x, lut, w, b, _ = _inputs(0, n, k, m, group, 32)
    jb = jnp.asarray(b) if bias else None
    want = jgp.gather_project(jnp.asarray(x), jnp.asarray(lut), jnp.asarray(w), jb,
                              interpret=True, group=group)
    got = gather_project_ref(_t(x), _t(lut), _t(w), _t(b) if bias else None, group)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(
        gather_project_xla(_t(x), _t(lut), _t(w), _t(b) if bias else None, group).numpy(),
        np.asarray(jgp.gather_project_xla(jnp.asarray(x), jnp.asarray(lut),
                                          jnp.asarray(w), jb, group)), **F32_TOL)


@pytest.mark.parametrize("group", [1, 4, 16])
def test_gather_project_repeated_indices_and_bf16(group):
    """A LUT that repeats indices (any index list works), in bf16: the
    plain version against the TPU kernel in interpret mode at the same
    rounding point, and against JAX's XLA twin one rounding apart."""
    x, lut, w, b, _ = _inputs(1, 24, 6, 5, group, 40, repeat=True)
    assert len(set(lut.tolist())) < lut.size
    bf = jnp.bfloat16
    want = jgp.gather_project(jnp.asarray(x, bf), jnp.asarray(lut), jnp.asarray(w, bf),
                              jnp.asarray(b, bf), interpret=True, group=group)
    got = gather_project_ref(_t(x, torch.bfloat16), _t(lut), _t(w, torch.bfloat16),
                             _t(b, torch.bfloat16), group)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)
    twin = jgp.gather_project_xla(jnp.asarray(x, bf), jnp.asarray(lut),
                                  jnp.asarray(w, bf), jnp.asarray(b, bf), group)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(twin.astype(jnp.float32)),
                               **BF16_TOL)


@pytest.mark.parametrize("repeat", [False, True])
@pytest.mark.parametrize("group", [1, 4, 16])
def test_gather_project_backward_matches_jax_vjp(group, repeat):
    """dx (scattered through the LUT, repeats summed), dw and db against
    ``jax.vjp`` of JAX's ``gather_project`` in interpret mode."""
    x, lut, w, b, g = _inputs(2, 64, 3, 4, group, 32, repeat=repeat)
    want, vjp = jax.vjp(lambda a, c, d: jgp.gather_project(
        a, jnp.asarray(lut), c, d, interpret=True, group=group),
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    leaves = [_t(a).requires_grad_() for a in (x, w, b)]
    before = gather_project.launches
    out = gather_project(leaves[0], _t(lut), leaves[1], leaves[2], group)
    out.backward(_t(g))
    assert gather_project.launches == before  # the CPU launches nothing
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **F32_TOL)
    for name, t, wg in zip(("dx", "dw", "db"), leaves, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg), err_msg=name, **F32_TOL)


def test_gather_project_checks_its_arguments():
    x = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match="group"):
        gather_project(x, torch.arange(6), torch.zeros(12, 4), group=4)
    with pytest.raises(ValueError, match="rows"):
        gather_project(x, torch.arange(8), torch.zeros(6, 4), group=4)
    with pytest.raises(ValueError, match="LUT"):
        FusedCurveProjection(3, 4, [0, 8], n_rows=8)
    with pytest.raises(ValueError, match="no kernel for device"):
        xm = torch.zeros(1, 8, 3, device="meta")
        gather_project(xm, torch.arange(8, device="meta"), torch.zeros(3, 4, device="meta"))


# -- the fused tokenizer and a small fused flagship ----------------------------


def _images(n, hw=16, seed=0):
    return np.random.default_rng(seed).standard_normal((n, hw, hw, 3)).astype(np.float32)


def _perturbed(variables, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        variables["params"])


@pytest.mark.parametrize("psl", [(16, 4, 1), (4, 4, 1)], ids=["flagship", "upsampled"])
def test_fused_hierarchical_tokenizer_matches_jax(psl):
    """The fused tokenizer against JAX's ``fused=True`` (its
    ``FusedCurveProjection`` per level), forward and gradients; its
    parameters are the unfused tokenizer's, so the converter maps one tree
    onto both."""
    jtok = JHier(img_size=16, patch_size_list=psl, embed_dim=32, curve="morton",
                 fused=True)
    x = _images(3)
    params = _perturbed(jtok.init(jax.random.key(0), jnp.asarray(x)), 1)
    want, vjp = jax.vjp(lambda p: jtok.apply({"params": p}, jnp.asarray(x)), params)
    w = np.random.default_rng(2).standard_normal(want.shape).astype(np.float32)
    (want_grads,) = vjp(jnp.asarray(w))
    tok = load_flax_params(HierarchicalCurveEmbedding(16, psl, 32, curve="morton",
                                                      fused=True), params)
    assert isinstance(tok.level_0.proj, FusedCurveProjection)
    unfused = HierarchicalCurveEmbedding(16, psl, 32, curve="morton")
    assert {n: p.shape for n, p in unfused.named_parameters()} == {
        n: p.shape for n, p in tok.named_parameters()}
    got = tok(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MODEL_TOL)
    got.backward(_t(w))
    flat = dict(jax.tree_util.tree_leaves_with_path(to_flax_grads(tok)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want_grads):
        np.testing.assert_allclose(flat[path], np.asarray(leaf),
                                   err_msg=jax.tree_util.keystr(path), **MODEL_TOL)
    with torch.no_grad():
        np.testing.assert_allclose(load_flax_params(unfused, params)(_t(x)).numpy(),
                                   got.detach().numpy(), **MODEL_TOL)


#: The flagship cut to size, as in tests/test_torch_family_a.py.
SMALL = dict(img_size=16, embed_dim=128, depth=2, n_heads=2, mlp_dim=128)


def test_small_fused_flagship_matches_jax():
    jmodel = jregistry.build_model(jregistry.preset_config("flagship", **SMALL, fused=True))
    x = _images(3, seed=4)
    params = _perturbed(jax.jit(jmodel.init)(jax.random.key(3), jnp.asarray(x[:1])), 5)
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    model = build_model(preset_config("flagship", **SMALL, fused=True), device="cpu")
    load_flax_params(model, params)
    assert isinstance(model.patch_embed.level_2.proj, FusedCurveProjection)
    with torch.no_grad():
        np.testing.assert_allclose(model.eval()(_t(x)).numpy(), np.asarray(want),
                                   **MODEL_TOL)
    back = to_flax_params(model)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(dict(jax.tree_util.tree_leaves_with_path(back))[path],
                                      np.asarray(leaf))


def test_fused_flagship_preset_builds_on_cpu_with_the_unfused_init():
    """The fused and unfused flagships draw the same parameters from one
    seed (the projection's kernel is drawn where the Dense one was)."""
    cfg = dict(depth=1, dtype="bfloat16")
    fused = build_model(preset_config("flagship", fused=True, **cfg), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    plain = build_model(preset_config("flagship", **cfg), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    for (n1, p1), (n2, p2) in zip(fused.named_parameters(), plain.named_parameters()):
        assert n1 == n2 and torch.equal(p1, p2), n1
    x = _t(_images(2, hw=32, seed=6))
    with torch.no_grad():
        a, b = fused.eval()(x), plain.eval()(x)
    assert a.dtype == torch.bfloat16 and a.shape == (2, 10)
    torch.testing.assert_close(a.float(), b.float(), rtol=5e-2, atol=5e-2)
