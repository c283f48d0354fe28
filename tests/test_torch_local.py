"""The port's curve-local attention (#12, #13) and the hybrid long-context
CurveViT against the JAX package on the CPU.

``local_fwd_ref`` and ``local_bwd_ref`` (the plain versions of the
windowed kernels in ``csrc/local_fwd.cu`` and ``csrc/flash_bwd.cu``) are
held against JAX's
``_local_fwd`` / ``_local_bwd`` in interpret mode at ragged lengths (300
and 520 tokens at block 128, halo 1; 40 at block 8, halo 2, where the
window spans five blocks), in fp32 and bf16; the autograd route against
``jax.vjp`` of ``local_block_attention``; the dense case; the attention
dispatch; a small hybrid CurveViT through the flax converter; the
routing and the registry.  Inputs come from ``np.random.default_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfc_vit_tpu.ops.attention as jattention
import sfc_vit_tpu.ops.local_attention as jla
from sfc_vit_tpu.models import CurveViT as JCurveViT
from sfc_vit_tpu.training import losses as jlosses
from sfc_vit_tpu_torch.models import CurveViT, layer_route
from sfc_vit_tpu_torch.ops import multi_head_attention, packed_qkv_attention
from sfc_vit_tpu_torch.ops import local_attention as la
from sfc_vit_tpu_torch.ops.flash_attention import flash_delta
from sfc_vit_tpu_torch.registry import build_model, preset_config
from sfc_vit_tpu_torch.training import soft_target_cross_entropy
from sfc_vit_tpu_torch.utils import load_flax_params, to_flax_grads

# fp32: the same arithmetic summed in another order.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 inputs and outputs: P is normalised in fp32 and rounded to bf16 at
# the same point on both sides, but a sum taken in another order can land
# on the neighbouring bf16 value (one ulp, 2^-8 relative); dk and dv are
# fp32 sums rounded once.
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
# The lse stays fp32 in both dtypes: fp32 sums in another order.
LSE_TOL = dict(rtol=1e-5, atol=1e-5)
# fp32 logits and gradients through a few layers.
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
H, DH = 2, 64
CASES = [(300, 128, 1), (520, 128, 1), (40, 8, 2)]


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, n, H, DH)).astype(np.float32) for _ in range(4)]


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype=dtype)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _jlse(lse, n):
    """JAX's lane-replicated [BH, Npad, 128] lse -> [B, H, N]."""
    return np.asarray(lse)[:, :n, 0].reshape(1, H, n)


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               err_msg=name, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n, block, halo", CASES)
def test_local_fwd_ref_matches_pallas(n, block, halo, dtype):
    """#12's plain version, out and lse, against ``_local_fwd`` with the
    lse: the edge blocks' clamped views are masked on the JAX side and
    never read on this one."""
    q, k, v, _ = _inputs(0, n)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    scale = DH ** -0.5
    jo, jl = jla._local_fwd(_j(q, jdt), _j(k, jdt), _j(v, jdt), block, halo, scale,
                            return_lse=True, interpret=True)
    to, tl = la.local_fwd_ref(_t(q, tdt), _t(k, tdt), _t(v, tdt), block, halo, scale,
                              return_lse=True)
    assert to.dtype == tdt and tl.dtype == torch.float32
    _close(to, jo, F32_TOL if dtype == "float32" else BF16_TOL, "out")
    np.testing.assert_allclose(tl.numpy(), _jlse(jl, n), **LSE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n, block, halo", CASES)
def test_local_bwd_ref_matches_pallas(n, block, halo, dtype):
    """#13's plain version against ``_local_bwd``, both fed JAX's forward
    output and lse; delta = rowsum(g * O) in fp32 on both sides."""
    q, k, v, g = _inputs(1, n)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    scale = DH ** -0.5
    jq, jk, jv, jg = (_j(a, jdt) for a in (q, k, v, g))
    jo, jl = jla._local_fwd(jq, jk, jv, block, halo, scale, return_lse=True,
                            interpret=True)
    want = jla._local_bwd(jq, jk, jv, jo, jg, jl, block, halo, scale, interpret=True)
    to = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(tdt)
    tg = _t(g, tdt)
    got = la.local_bwd_ref(_t(q, tdt), _t(k, tdt), _t(v, tdt), tg,
                           torch.from_numpy(np.array(_jlse(jl, n))), flash_delta(tg, to),
                           block, halo, scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tdt, name
        _close(a, w, F32_TOL if dtype == "float32" else BF16_TOL, name)


@pytest.mark.parametrize("n, block, halo", [(300, 128, 1), (40, 8, 2)])
def test_local_block_attention_autograd_matches_jax(n, block, halo):
    """The port's autograd route (CPU: the plain versions) against
    ``jax.vjp`` of JAX's ``local_block_attention`` in interpret mode."""
    q, k, v, g = _inputs(2, n)
    want, vjp = jax.vjp(lambda a, b, c: jla.local_block_attention(
        a, b, c, block, halo, None, True), _j(q), _j(k), _j(v))
    want_grads = vjp(_j(g))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    before = (la.local_block_attention.launches, la.local_block_attention.bwd_launches)
    out = la.local_block_attention(*leaves, block=block, halo=halo)
    out.backward(_t(g))
    assert (la.local_block_attention.launches,
            la.local_block_attention.bwd_launches) == before  # the CPU launches nothing
    _close(out, want, F32_TOL, "out")
    for name, t, w in zip(("dq", "dk", "dv"), leaves, want_grads):
        _close(t.grad, w, F32_TOL, name)


def test_local_block_attention_dense_case_is_flash():
    """At 200 tokens, block 128, halo 1 every block is within the halo of
    every other: JAX's dense case, plain attention (its flash_attention),
    forward and backward."""
    n = 200
    assert la.is_dense(n, 128, 1) and not la.is_dense(257, 128, 1)
    assert la.is_dense(384, 128, 2) and not la.is_dense(384, 128, 1)
    q, k, v, g = _inputs(3, n)
    want, vjp = jax.vjp(lambda a, b, c: jla.local_block_attention(
        a, b, c, 128, 1, None, True), _j(q), _j(k), _j(v))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    out = la.local_block_attention(*leaves)
    out.backward(_t(g))
    _close(out, want, F32_TOL, "out")
    for name, t, w in zip(("dq", "dk", "dv"), leaves, vjp(_j(g))):
        _close(t.grad, w, F32_TOL, name)


def test_local_block_attention_xla_matches_jax():
    q, k, v, _ = _inputs(4, 300)
    want = jla.local_block_attention_xla(_j(q), _j(k), _j(v), block=64, halo=2)
    _close(la.local_block_attention_xla(_t(q), _t(k), _t(v), block=64, halo=2), want,
           F32_TOL)


def test_multi_head_and_packed_attention_local_match_jax():
    """``'local'`` at JAX's defaults (block 128, halo 1): JAX's dispatch on
    the CPU runs the dense-mask twin, the port the plain #12."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 300, 2, 64)).astype(np.float32) for _ in range(3))
    want = jattention.multi_head_attention(_j(q), _j(k), _j(v), implementation="local")
    _close(multi_head_attention(_t(q), _t(k), _t(v), implementation="local"), want,
           F32_TOL)
    qkv = rng.standard_normal((2, 300, 3 * 2 * 64)).astype(np.float32)
    want = jattention.packed_qkv_attention(_j(qkv), 2, implementation="local")
    _close(packed_qkv_attention(_t(qkv), 2, implementation="local"), want, F32_TOL)


def test_local_attention_refuses_devices_without_a_kernel():
    q = torch.zeros(1, 300, 1, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        la.local_block_attention(q, q, q)
    with pytest.raises(ValueError, match="halo"):
        la.local_block_attention(torch.zeros(1, 300, 1, 64), torch.zeros(1, 300, 1, 64),
                                 torch.zeros(1, 300, 1, 64), halo=0)


# -- a small hybrid CurveViT --------------------------------------------------

#: 24 x 24 pixels along the Hilbert curve: 576 tokens in the local layer 0,
#: 432 after the merge in the local layer 1 (four curve blocks of the
#: merged sequence), then a global 'auto' layer; d = 128, 2 heads of 64.
HYBRID = dict(image_size=24, patch_size=1, num_classes=10, dim=128, depth=3, heads=2,
              dim_head=64, mlp_dim=256, merge_layers=(0,), merge_ratio=0.5,
              attn_impl=("local", "local", "auto"))


def test_small_hybrid_curvevit_matches_jax():
    """Logits and one train step's gradients (soft-target cross entropy)
    against JAX's hybrid CurveViT, fp32, parameters carried across by the
    converter."""
    jmodel = JCurveViT(**HYBRID)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 24, 24, 3)).astype(np.float32)
    y = np.array([1, 8])
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x))
        return jlosses.soft_target_cross_entropy(logits, jax.nn.one_hot(y, 10)), logits

    (want_loss, want_logits), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = load_flax_params(CurveViT(**HYBRID), params)
    logits = model(_t(x))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               **MODEL_TOL)
    loss = soft_target_cross_entropy(logits, torch.nn.functional.one_hot(
        torch.from_numpy(y), 10).float())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got = dict(jax.tree_util.tree_leaves_with_path(to_flax_grads(model)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want_grads):
        np.testing.assert_allclose(got[path], np.asarray(leaf),
                                   err_msg=jax.tree_util.keystr(path), **MODEL_TOL)


# -- routing and the registry ---------------------------------------------------


def test_layer_route_local_matches_jax_gates(monkeypatch):
    """A 'local' layer is never the fused block and goes to curve-local
    attention at every length, as JAX's packed entry point sends it on its
    chip (read by tracing it with ``jax.default_backend`` reading "tpu"
    and the kernel replaced by a recorder)."""
    from sfc_vit_tpu.models import simple_vit as jsimple_vit

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    taken = []

    def local(q, k, v, *a, **kw):
        taken.append("local")
        return q

    monkeypatch.setattr(jla, "local_block_attention", local)
    for n, d in ((576, 128), (12288, 384), (16384, 384), (196, 768)):
        assert not jsimple_vit._fused_attn_gate("local", n, d, d, jnp.bfloat16)
        taken.clear()
        jax.eval_shape(lambda a: jattention.packed_qkv_attention(
            a, d // 64, implementation="local"),
            jax.ShapeDtypeStruct((1, n, 3 * d), jnp.bfloat16))
        assert taken == ["local"]
        assert layer_route("local", n, d, d, 4 * d, 64)[0] == "local"
    assert layer_route("local", 16384, 384, 384, 1536, 64) == ("local", "fused_mlp")


def test_build_model_builds_the_hybrid_preset_on_cpu():
    cfg = preset_config("longctx-16k-hybrid")
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert isinstance(model, CurveViT)
    assert model.to_patch_embedding.n_patches == 128 * 128
    assert model.dtype == torch.bfloat16
    assert model.transformer.merge_layers == (1,)
    impls = [getattr(model.transformer, f"attn_{i}").attn_impl for i in range(cfg.depth)]
    assert impls == ["local", "local", "local", "auto"]
