"""The port's flash attention in float32 at head dims 64, 128 and 256, and
the LSE capture path, against the JAX package on the CPU.

On the card, fp32 tensors at these head dims run ``csrc/flash_fwd_f32.cu``
and ``csrc/flash_bwd_f32.cu`` (#8-#11's fp32 forms, held to the plain
versions by ``tests/test_torch_kernels.py`` and ``chip_smoke.py``'s
phase 18).  Here the wrappers run those plain versions, which are held to
JAX's ``flash_attention`` with its Pallas kernels in interpret mode: the
single step with the fused backward, the streaming forward with the
streaming backward (``_FUSED_BWD_MAX`` lowered on both sides), and nq !=
nk.  A depth-2 CurveViT past 1,024 tokens at Dh 64 and 128 is held to
JAX's model from the same flax parameters, and
``flash_attention_with_lse`` and ``utils.profiling.attention_rows`` to
JAX's.  Inputs come from ``np.random.default_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfc_vit_tpu.ops.flash_attention as jfa
import sfc_vit_tpu_torch.ops.flash_attention as fa
from sfc_vit_tpu import registry as jregistry
from sfc_vit_tpu.training import losses as jlosses
from sfc_vit_tpu.utils import profiling as jprofiling
from sfc_vit_tpu_torch.ops import _build
from sfc_vit_tpu_torch.registry import build_model, preset_config
from sfc_vit_tpu_torch.training import TrainState, make_optimizer, make_train_step
from sfc_vit_tpu_torch.utils import load_flax_params, profiling, to_flax_grads

#: fp32 operators: the same arithmetic summed in another order, within
#: 1e-5 of the largest |value|.
OP_FRAC = 1e-5
#: A depth-2 model's fp32 logits and gradients (PERF.md section 2's gate).
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _within(got, want, frac=OP_FRAC, name=""):
    """max |got - want| within ``frac`` of the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= frac * scale, f"{name}: max abs err {err} > {frac} x {scale}"


def _inputs(seed, nq, nk, dh, heads=2):
    rng = np.random.default_rng(seed)
    shapes = [(1, nq, heads, dh), (1, nk, heads, dh), (1, nk, heads, dh), (1, nq, heads, dh)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_flash_f32_head_dims_are_jaxs():
    """The fp32 kernels take every head dim JAX's ``auto`` sends to flash."""
    import sfc_vit_tpu.ops.attention as jattention

    assert _build.FLASH_F32_HEAD_DIMS == tuple(jattention._PALLAS_HEAD_DIMS)
    assert _build.flash_head_dims(torch.float32) == _build.FLASH_F32_HEAD_DIMS
    assert _build.flash_head_dims(torch.bfloat16) == _build.FLASH_HEAD_DIMS == (64,)
    assert _build.flash_head_dims(torch.float16) == ()


# (nq, nk, JAX's block_k, streaming backward): the single K step with the
# fused backward, the streaming forward (128-key steps) with the streaming
# backward, and nq != nk each way.
_CASES = [pytest.param(300, 300, None, False, id="single-fused"),
          pytest.param(300, 300, 128, True, id="streaming-streaming"),
          pytest.param(200, 300, None, False, id="200-300-fused"),
          pytest.param(300, 200, 128, True, id="300-200-streaming")]


@pytest.mark.parametrize("dh", [128, 256])
@pytest.mark.parametrize("nq, nk, block_k, streaming_bwd", _CASES)
def test_flash_attention_f32_matches_jax(monkeypatch, dh, nq, nk, block_k, streaming_bwd):
    """``flash_attention`` (CPU: the plain versions of #8-#11) against
    ``jax.grad`` of JAX's ``flash_attention`` in interpret mode, output
    and dq, dk, dv within 1e-5 of the largest |value|; the plain #8 in the
    form JAX ran, with its lse, against ``_flash_fwd``."""
    if streaming_bwd:
        monkeypatch.setattr(jfa, "_FUSED_BWD_MAX", 128)
        monkeypatch.setattr(fa, "FUSED_BWD_MAX", 128)
    q, k, v, g = _inputs(dh + nq + nk, nq, nk, dh)
    scale = dh ** -0.5

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, None, 128, block_k, None, True)
                       * jnp.asarray(g))

    want_out = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), None, 128, block_k, None, True)
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*leaves)
    (out * _t(g)).sum().backward()
    _within(out.detach().numpy(), want_out, name="out")
    for name, a, w in zip(("dq", "dk", "dv"), leaves, want):
        _within(a.grad.numpy(), w, name=name)
    jo, jl = jfa._flash_fwd(*map(jnp.asarray, (q, k, v)), scale, block_q=128, block_k=block_k,
                            return_lse=True, interpret=True)
    to, tl = fa.flash_fwd_ref(*map(_t, (q, k, v)), scale, block_k=block_k, return_lse=True)
    _within(to.numpy(), jo, name="flash_fwd_ref")
    _within(tl.numpy(), np.asarray(jl)[:, :nq, 0].reshape(1, 2, nq), name="lse")
    assert fa.flash_attention.f32_launches == 0  # the CPU path launches nothing


# -- a depth-2 CurveViT past 1,024 tokens ----------------------------------------


@pytest.mark.parametrize("dim_head", [64, 128])
def test_curvevit_past_1024_tokens_f32_matches_jax(dim_head):
    """longctx-16k's geometry at its CLI's default dtype (fp32), cut to 40
    x 40 pixels (1,600 tokens, 1,200 after the merge), d 64, depth 2, one
    head, MLP 128: every layer routes to flash.  Logits and one train
    step's gradients against JAX's model (its 'auto', plain XLA off its
    chip) from the same perturbed flax parameters."""
    cut = dict(img_size=40, embed_dim=64, depth=2, n_heads=1, dim_head=dim_head, mlp_dim=128,
               dtype=None, num_classes=10)
    rng = np.random.default_rng(dim_head)
    x = rng.standard_normal((2, 40, 40, 3)).astype(np.float32)
    y = np.array([3, 7], np.int32)
    jmodel = jregistry.build_model(jregistry.preset_config("longctx-16k", **cut))
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(x[:1]))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)

    def loss_fn(tree):
        logits = jmodel.apply({"params": tree}, jnp.asarray(x))
        return jlosses.soft_target_cross_entropy(logits, jax.nn.one_hot(y, 10)), logits

    (want_loss, want_logits), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    cfg = preset_config("longctx-16k", **cut)
    model = load_flax_params(build_model(cfg, device="cpu"), params)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        np.testing.assert_allclose(model(_t(x)).numpy(), np.asarray(want_logits), **MODEL_TOL)
    state = TrainState(model.train(), make_optimizer(model.parameters(), lambda _: 0.0,
                                                     grad_clip=float("inf")))
    m = make_train_step(10, use_mixing=False)(state, (torch.from_numpy(x), torch.from_numpy(y)),
                                              torch.Generator())
    np.testing.assert_allclose(float(m["loss"]), float(want_loss), rtol=1e-5)
    got = dict(jax.tree_util.tree_leaves_with_path(to_flax_grads(model)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want_grads):
        np.testing.assert_allclose(got[path], np.asarray(leaf),
                                   err_msg=jax.tree_util.keystr(path), **MODEL_TOL)


# -- the LSE capture path -------------------------------------------------------


@pytest.mark.parametrize("interpret", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_flash_attention_with_lse_and_rows_match_jax(dh, interpret):
    """``flash_attention_with_lse`` against JAX's (its chunked XLA
    logsumexp off its chip, or its Pallas #8 in interpret mode), then
    ``attention_rows`` from each side's own q, k and lse, within 1e-5 of
    the largest |value|; each row sums to 1 within 1e-5."""
    q, k, v, _ = _inputs(dh, 300, 300, dh)
    out, lse = fa.flash_attention_with_lse(*map(_t, (q, k, v)))
    jout, jlse = jfa.flash_attention_with_lse(*map(jnp.asarray, (q, k, v)), interpret=interpret,
                                              chunk=128)
    assert out.shape == (1, 300, 2, dh) and lse.shape == (1, 2, 300)
    _within(out.numpy(), jout, name="out")
    _within(lse.numpy(), jlse, name="lse")
    queries = [0, 7, 150, 299]
    rows = profiling.attention_rows(_t(q), _t(k), lse, queries)
    jrows = jprofiling.attention_rows(jnp.asarray(q), jnp.asarray(k), jlse,
                                      np.asarray(queries))
    assert rows.shape == (1, 2, 4, 300)
    _within(rows.numpy(), jrows, name="rows")
    np.testing.assert_allclose(rows.sum(-1).numpy(), 1.0, rtol=0, atol=1e-5)


def test_attention_rows_unwraps_captures_and_takes_a_scale():
    """A capture's one-element tuples are unwrapped, as JAX's are; an
    explicit scale is used for the logits."""
    q, k, _, _ = _inputs(9, 64, 80, 64)
    scale = 0.1
    s = torch.einsum("bqhd,bkhd->bhqk", _t(q), _t(k)) * scale
    lse = torch.logsumexp(s, -1)
    rows = profiling.attention_rows((_t(q),), [_t(k)], (lse,), torch.tensor([3, 60]), scale)
    want = jprofiling.attention_rows((jnp.asarray(q),), [jnp.asarray(k)],
                                     (jnp.asarray(lse.numpy()),), np.array([3, 60]), scale)
    _within(rows.numpy(), want, name="rows")
    _within(rows.numpy(), torch.softmax(s, -1)[:, :, [3, 60]].numpy(), name="softmax")
