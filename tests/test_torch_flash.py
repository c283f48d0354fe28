"""The port's plain flash-attention versions against the JAX package's
Pallas kernels #8-#11 in interpret mode.

``flash_fwd_ref``, ``flash_fused_bwd_ref``, ``flash_dq_ref`` and
``flash_dkv_ref`` (the plain versions of the CUDA kernels in
``csrc/flash_fwd_sm90.cu``, ``csrc/flash_bwd_fused_sm90.cu``,
``csrc/flash_bwd_dq_sm90.cu`` and ``csrc/flash_bwd_dkv_sm90.cu``) are held
against
``_flash_fwd``, ``_fused_bwd`` and ``_streaming_bwd`` at small lengths
(~300 tokens) with 128-row blocks forced, as ``tests/test_ops.py`` runs
them, and the port's ``flash_attention`` autograd route against
``jax.grad`` of JAX's with the streaming backward forced.  Inputs come
from ``np.random.default_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfc_vit_tpu.ops.flash_attention as jfa
import sfc_vit_tpu_torch.ops.flash_attention as fa
from sfc_vit_tpu_torch.ops import _build

# fp32: the same arithmetic summed in another order.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 inputs and outputs: p is rounded to bf16 at the same point on both
# sides, but a sum taken in another order can land on the neighbouring
# bf16 value of the output (one ulp, 2^-8 relative).
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
B, H, DH = 1, 2, 64


def _inputs(seed, nq=300, nk=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    nk = nq if nk is None else nk
    shapes = [(B, nq, H, DH), (B, nk, H, DH), (B, nk, H, DH), (B, nq, H, DH)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype=dtype)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _jlse(lse, b, h, nq):
    """JAX's lane-replicated [BH, Npad, 128] lse -> [B, H, Nq]."""
    return np.asarray(lse)[:, :nq, 0].reshape(b, h, nq)


@pytest.mark.parametrize("nq, nk, streaming", [
    (300, 300, True), (300, 300, False), (200, 300, True), (300, 200, False)])
def test_flash_fwd_ref_matches_pallas(nq, nk, streaming):
    """Streaming (128-key steps) and single-step forms, with the lse;
    nq != nk as the TPU kernel allows."""
    q, k, v, _ = _inputs(0, nq, nk)
    scale = DH ** -0.5
    block_k = 128 if streaming else None
    jo, jl = jfa._flash_fwd(_j(q), _j(k), _j(v), scale, block_q=128,
                            block_k=block_k, return_lse=True, interpret=True)
    to, tl = fa.flash_fwd_ref(_t(q), _t(k), _t(v), scale, block_q=128,
                              block_k=block_k, return_lse=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32_TOL)
    np.testing.assert_allclose(tl.numpy(), _jlse(jl, B, H, nq), **F32_TOL)


@pytest.mark.parametrize("streaming", [True, False])
def test_flash_fwd_ref_matches_pallas_bf16(streaming):
    """bf16: p rounded to bf16 unnormalised (streaming) or normalised
    (single step) before the fp32 P.V, on both sides."""
    q, k, v, _ = _inputs(1)
    scale = DH ** -0.5
    block_k = 128 if streaming else None
    jo = jfa._flash_fwd(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                        _j(v, jnp.bfloat16), scale, block_q=128, block_k=block_k,
                        interpret=True)
    to = fa.flash_fwd_ref(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                          _t(v, torch.bfloat16), scale, block_q=128, block_k=block_k)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)), **BF16_TOL)


def test_stream_block_k_is_a_width_jax_runs():
    """#8's streaming key tile (``_build.FLASH_STREAM_BLOCK_K``, the width
    the kernel rounds p against its running max at) is a width JAX's
    ``_flash_fwd`` runs: the plain version at that width against the
    Pallas kernel in interpret mode, bf16, over three key tiles."""
    bk = _build.FLASH_STREAM_BLOCK_K
    assert bk % 128 == 0
    q, k, v, _ = _inputs(5, 300, 2 * bk + 44)
    scale = DH ** -0.5
    jo = jfa._flash_fwd(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                        _j(v, jnp.bfloat16), scale, block_q=128, block_k=bk,
                        interpret=True)
    to = fa.flash_fwd_ref(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                          _t(v, torch.bfloat16), scale, block_q=128, block_k=bk)
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)), **BF16_TOL)


@pytest.mark.parametrize("nq, nk", [(300, 300), (200, 300)])
def test_flash_fused_bwd_ref_matches_pallas(nq, nk):
    q, k, v, g = _inputs(2, nq, nk)
    scale = DH ** -0.5
    want = jfa._fused_bwd(_j(q), _j(k), _j(v), _j(g), scale, block_q=128,
                          interpret=True)
    got = fa.flash_fused_bwd_ref(_t(q), _t(k), _t(v), _t(g), scale, block_q=128)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name, **F32_TOL)


# The plain versions' tiles: 128 x 128 (JAX's blocks here), and those of
# the CUDA kernels: #10 walks 64-key tiles, #11 64-query tiles.
@pytest.mark.parametrize("nq, nk, tile", [
    pytest.param(300, 300, 128, id="300-300"), pytest.param(200, 300, 128, id="200-300"),
    pytest.param(300, 200, 64, id="300-200-tile64"),
    pytest.param(333, 250, 64, id="333-250-tile64")])
def test_flash_streaming_bwd_refs_match_pallas(nq, nk, tile):
    """#10 and #11's plain versions against ``_streaming_bwd`` (128-row
    blocks), both fed the lse of JAX's streaming forward and delta =
    rowsum(g * O) over its output.  At ``tile`` 64, ``flash_dq_ref`` runs
    64-key tiles and ``flash_dkv_ref`` 64-query tiles, the CUDA kernels'
    loops, at ragged nq != nk: the tiling changes only the order of the
    fp32 sums."""
    q, k, v, g = _inputs(3, nq, nk)
    scale = DH ** -0.5
    jo, jl = jfa._flash_fwd(_j(q), _j(k), _j(v), scale, block_q=128, block_k=128,
                            return_lse=True, interpret=True)
    want = jfa._streaming_bwd(_j(q), _j(k), _j(v), jo, _j(g), jl, scale,
                              block_q=128, block_k=128, interpret=True)
    lse = _t(_jlse(jl, B, H, nq))
    delta = fa.flash_delta(_t(g), _t(jo))
    dq = fa.flash_dq_ref(_t(q), _t(k), _t(v), _t(g), lse, delta, scale,
                         block_q=128, block_k=tile)
    dk, dv = fa.flash_dkv_ref(_t(q), _t(k), _t(v), _t(g), lse, delta, scale,
                              block_q=tile, block_k=128)
    for name, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name, **F32_TOL)


@pytest.mark.parametrize("streaming_bwd", [True, False])
def test_flash_attention_autograd_matches_jax(streaming_bwd, monkeypatch):
    """The port's autograd route (CPU: the plain versions) against
    ``jax.grad`` of JAX's ``flash_attention`` in interpret mode, with
    ``_FUSED_BWD_MAX`` lowered on both sides to force the streaming pair
    at 300 tokens, or left as it is for the fused backward."""
    if streaming_bwd:
        monkeypatch.setattr(jfa, "_FUSED_BWD_MAX", 128)
        monkeypatch.setattr(fa, "FUSED_BWD_MAX", 128)
    q, k, v, g = _inputs(4)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, None, 128, 128, None, True) * _j(g))

    want_out = jfa.flash_attention(_j(q), _j(k), _j(v), None, 128, 128, None, True)
    want = jax.grad(jloss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **F32_TOL)
    for name, a, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name, **F32_TOL)
    assert fa.flash_attention.launches == 0  # the CPU path launches nothing


def test_flash_gates_read_jax_constants():
    assert fa.SINGLE_KSTEP_MAX == jfa._SINGLE_KSTEP_MAX
    assert fa.FUSED_BWD_MAX == jfa._FUSED_BWD_MAX
    for n in (196, 4096, 4097, 8192, 8193, 12288, 16384):
        assert fa.uses_single_kstep(n) == (jfa._auto_block_k(n) >= jfa._round_up(n, 128))
        assert fa.uses_fused_bwd(n, n) == (not jfa._use_streaming_bwd(n))


@pytest.mark.parametrize("dtype, dh, error, match", [
    (torch.float32, 64, ValueError, "no kernel for device"),
    (torch.bfloat16, 128, ValueError, "no kernel for device"),
    (torch.bfloat16, 256, ValueError, "no kernel for device"),
    (torch.float16, 64, NotImplementedError, "head dims 64, 128, 256"),
    (torch.bfloat16, 96, NotImplementedError, "head dims 64, 128, 256")])
def test_flash_attention_refuses_devices_without_a_kernel(dtype, dh, error, match):
    """Only a CPU tensor runs the plain versions: a form the kernels take
    (bf16 and fp32 at Dh 64, 128, 256) on a device without them raises, and
    the forms no kernel takes (another dtype or head dim, which the JAX
    package's dispatch never sends to flash) raise on any device but the
    CPU, naming what the kernels take (the same refusals on CUDA tensors
    are GPU tests in tests/test_torch_kernels.py)."""
    q = torch.zeros(1, 8, 1, dh, device="meta", dtype=dtype)
    with pytest.raises(error, match=match):
        fa.flash_attention(q, q, q)
