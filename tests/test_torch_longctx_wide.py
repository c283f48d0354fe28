"""Long context at every head dim and dtype the JAX package sends to its
kernels, against the JAX package on the CPU.

The plain versions of the flash kernels #8-#11 in bf16 at head dims 128
and 256 (``csrc/flash_wide.cuh``'s instances of ``csrc/flash_fwd_sm90.cu``,
``flash_bwd_dq_sm90.cu`` and ``flash_bwd_dkv_sm90.cu``) and of the
curve-local #12/#13 at those head dims in fp32 and bf16 (the fp32 ones the
windowed instances of ``csrc/flash_fwd_f32.cu`` and ``flash_bwd_f32.cu``)
are held against ``_flash_fwd``, ``_fused_bwd``, ``_streaming_bwd``,
``_local_fwd`` and ``_local_bwd`` in interpret mode at ragged lengths; #9
at those head dims runs #10's and #11's kernels, so their plain versions
are held against ``_fused_bwd`` too (the hybrid model at those head dims:
``tests/test_torch_hybrid_wide.py``).  Inputs come from
``np.random.default_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfc_vit_tpu.ops.attention as jattention
import sfc_vit_tpu.ops.flash_attention as jfa
import sfc_vit_tpu.ops.local_attention as jla
from sfc_vit_tpu_torch.ops import _build
from sfc_vit_tpu_torch.ops import flash_attention as fa
from sfc_vit_tpu_torch.ops import local_attention as la
from test_torch_local import BF16_TOL, F32_TOL, LSE_TOL

H = 2
WIDE = (128, 256)


def _inputs(seed, nq, dh, nk=None):
    rng = np.random.default_rng(seed)
    nk = nq if nk is None else nk
    shapes = [(1, nq, H, dh), (1, nk, H, dh), (1, nk, H, dh), (1, nq, H, dh)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype=dtype)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


def _jlse(lse, nq):
    """JAX's lane-replicated [BH, Npad, 128] lse -> [B, H, Nq]."""
    return np.asarray(lse)[:, :nq, 0].reshape(1, H, nq)


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               err_msg=name, **tol)


def test_flash_head_dims_are_every_one_jax_sends():
    """bf16 and fp32 take the head dims JAX's ``auto`` sends to flash and
    to 'local', and the wide instances' table lists every kernel there."""
    assert _build.FLASH_HEAD_DIMS == tuple(jattention._PALLAS_HEAD_DIMS)
    assert _build.FLASH_HEAD_DIMS == _build.FLASH_F32_HEAD_DIMS
    names = set(_build.FLASH_WIDE_FORMS)
    for dh in WIDE:
        for kind in ("flash_fwd", "flash_dq", "flash_dkv", "local_fwd", "local_bwd dq",
                     "local_bwd dkv"):
            assert any(n.startswith(f"{kind} dh{dh}") for n in names), (kind, dh)
    for dh in _build.FLASH_F32_HEAD_DIMS:
        assert f"local_fwd_f32 dh{dh}" in _build.F32_KERNEL_FORMS
        for part in ("dq", "dkv"):
            assert f"local_bwd_f32 {part} dh{dh}" in _build.F32_KERNEL_FORMS


# -- #12 / #13 at head dims 128 and 256 ----------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", WIDE)
def test_local_fwd_ref_matches_pallas_wide(dh, dtype):
    """#12's plain version, out and lse, against ``_local_fwd`` at 300
    tokens (a ragged third curve block), block 128, halo 1."""
    q, k, v, _ = _inputs(10 + dh, 300, dh)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    scale = dh ** -0.5
    jo, jl = jla._local_fwd(_j(q, jdt), _j(k, jdt), _j(v, jdt), 128, 1, scale,
                            return_lse=True, interpret=True)
    to, tl = la.local_fwd_ref(_t(q, tdt), _t(k, tdt), _t(v, tdt), 128, 1, scale,
                              return_lse=True)
    assert to.dtype == tdt and tl.dtype == torch.float32
    _close(to, jo, F32_TOL if dtype == "float32" else BF16_TOL, "out")
    np.testing.assert_allclose(tl.numpy(), _jlse(jl, 300), **LSE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", WIDE)
def test_local_bwd_ref_matches_pallas_wide(dh, dtype):
    """#13's plain version against ``_local_bwd``, both fed JAX's forward
    output and lse; delta = rowsum(g * O) in fp32 on both sides."""
    q, k, v, g = _inputs(20 + dh, 300, dh)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    scale = dh ** -0.5
    jq, jk, jv, jg = (_j(a, jdt) for a in (q, k, v, g))
    jo, jl = jla._local_fwd(jq, jk, jv, 128, 1, scale, return_lse=True, interpret=True)
    want = jla._local_bwd(jq, jk, jv, jo, jg, jl, 128, 1, scale, interpret=True)
    to, tg = _t(jo, tdt), _t(g, tdt)
    got = la.local_bwd_ref(_t(q, tdt), _t(k, tdt), _t(v, tdt), tg,
                           torch.from_numpy(np.array(_jlse(jl, 300))), fa.flash_delta(tg, to),
                           128, 1, scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tdt, name
        _close(a, w, F32_TOL if dtype == "float32" else BF16_TOL, name)


def test_local_attention_refuses_blocks_not_a_multiple_of_64():
    """The one form still without a kernel: a block that is not a multiple
    of 64 (JAX's dispatch calls 'local' at block 128 only) raises on any
    device but the CPU, naming its ROADMAP entry; the forms the kernels
    take raise only for want of a CUDA device."""
    for dtype in (torch.bfloat16, torch.float32):
        for dh in _build.FLASH_HEAD_DIMS:
            q = torch.zeros(1, 300, 1, dh, device="meta", dtype=dtype)
            with pytest.raises(NotImplementedError, match="queue 2 entry 3"):
                la.local_block_attention(q, q, q, block=96)
            with pytest.raises(ValueError, match="no kernel for device"):
                la.local_block_attention(q, q, q)
    q = torch.zeros(1, 300, 1, 96, device="meta", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="head dims 64, 128, 256"):
        la.local_block_attention(q, q, q)


# -- #8-#11 in bf16 at head dims 128 and 256 -----------------------------------


@pytest.mark.parametrize("streaming", [True, False])
@pytest.mark.parametrize("dh", WIDE)
def test_flash_fwd_ref_matches_pallas_bf16_wide(dh, streaming):
    """bf16: p rounded to bf16 unnormalised against the running max of
    128-key steps (streaming) or normalised (single step) before the fp32
    P.V, on both sides, with the lse; nq != nk."""
    q, k, v, _ = _inputs(30 + dh, 300, dh, nk=270)
    scale = dh ** -0.5
    block_k = _build.FLASH_STREAM_BLOCK_K if streaming else None
    jo, jl = jfa._flash_fwd(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16),
                            scale, block_q=128, block_k=block_k, return_lse=True,
                            interpret=True)
    to, tl = fa.flash_fwd_ref(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                              _t(v, torch.bfloat16), scale, block_q=128, block_k=block_k,
                              return_lse=True)
    assert to.dtype == torch.bfloat16
    _close(to, jo, BF16_TOL, "out")
    np.testing.assert_allclose(tl.numpy(), _jlse(jl, 300), **LSE_TOL)


@pytest.mark.parametrize("dh", WIDE)
def test_flash_streaming_bwd_refs_match_pallas_bf16_wide(dh):
    """#10 and #11's plain versions in bf16 at the kernels' 64-row tiles
    against ``_streaming_bwd`` (128-row blocks), both fed the lse of JAX's
    streaming forward and delta = rowsum(g * O) over its output."""
    q, k, v, g = _inputs(40 + dh, 200, dh, nk=150)
    scale = dh ** -0.5
    jq, jk, jv, jg = (_j(a, jnp.bfloat16) for a in (q, k, v, g))
    jo, jl = jfa._flash_fwd(jq, jk, jv, scale, block_q=128, block_k=128, return_lse=True,
                            interpret=True)
    want = jfa._streaming_bwd(jq, jk, jv, jo, jg, jl, scale, block_q=128, block_k=128,
                              interpret=True)
    tq, tk, tv, tg = (_t(a, torch.bfloat16) for a in (q, k, v, g))
    lse = torch.from_numpy(np.array(_jlse(jl, 200)))
    delta = fa.flash_delta(tg, _t(jo, torch.bfloat16))
    dq = fa.flash_dq_ref(tq, tk, tv, tg, lse, delta, scale, block_q=128, block_k=64)
    dk, dv = fa.flash_dkv_ref(tq, tk, tv, tg, lse, delta, scale, block_q=64, block_k=128)
    for name, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert a.dtype == torch.bfloat16, name
        _close(a, w, BF16_TOL, name)


@pytest.mark.parametrize("dh", WIDE)
def test_fused_bwd_as_dq_and_dkv_matches_pallas_bf16_wide(dh):
    """#9 at Dh 128 and 256 is #10's and #11's kernels: their plain
    versions, fed the forward's lse and delta = rowsum(g * O), against
    ``_fused_bwd`` (which recomputes the row sum and takes delta =
    rowsum(p * dp)) in bf16 at 200 tokens: the same fp32 sums, each
    rounded once."""
    q, k, v, g = _inputs(50 + dh, 200, dh)
    scale = dh ** -0.5
    jq, jk, jv, jg = (_j(a, jnp.bfloat16) for a in (q, k, v, g))
    want = jfa._fused_bwd(jq, jk, jv, jg, scale, block_q=128, interpret=True)
    tq, tk, tv, tg = (_t(a, torch.bfloat16) for a in (q, k, v, g))
    out, lse = fa.flash_fwd_ref(tq, tk, tv, scale, return_lse=True)
    delta = fa.flash_delta(tg, out)
    got = (fa.flash_dq_ref(tq, tk, tv, tg, lse, delta, scale, block_k=64),
           *fa.flash_dkv_ref(tq, tk, tv, tg, lse, delta, scale, block_q=64))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _close(a, w, BF16_TOL, name)
