"""The port's CUDA kernels against their plain PyTorch versions.

Tests marked ``gpu`` need an NVIDIA GPU (sm_90a) and nvcc; they skip
elsewhere.  Run them on the card with::

    python -m pytest tests/test_torch_kernels.py -q

The other tests check the launchers' argument validation and the build's
failure path, which need no card.  This file imports no JAX, so it runs
unchanged on a machine that has only PyTorch.
"""

import contextlib
import os
import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sfc_vit_tpu_torch.ops import _build
from sfc_vit_tpu_torch.ops.fused_attention_block import (
    attention_block_bwd,
    attention_block_bwd_ref,
    attention_block_ref,
    attention_block_train_fwd,
    attention_bwd_ref,
    attention_fwd_ref,
    fused_attention_block,
)
from sfc_vit_tpu_torch.ops.fused_mlp import (
    fused_mlp_block,
    fused_postnorm_tail,
    mlp_block_bwd,
    mlp_block_bwd_ref,
    mlp_block_ref,
    mlp_block_train_fwd,
    postnorm_tail_bwd,
    postnorm_tail_bwd_ref,
    postnorm_tail_kernel_ref,
    postnorm_tail_train_fwd,
)
from sfc_vit_tpu_torch.ops.flash_attention import _packed_xla_ref, packed_flash_attention
from sfc_vit_tpu_torch.ops.fused_torch_attention import (
    fused_torch_mha,
    torch_mha_bwd,
    torch_mha_bwd_ref,
    torch_mha_fwd_ref,
    torch_mha_train_fwd,
)
from sfc_vit_tpu_torch.ops.kernel_utils import ln_bwd_fp32, ln_fp32

# bf16 tolerance of tests/test_fused_attention_block.py: the kernels
# round at other points than the plain versions (fc1 kept fp32 through
# the GELU, residual added in fp32), a few bf16 ulps at |x| ~ 4.
BF16_TOL = dict(rtol=4e-2, atol=4e-2)
# One rounding to bf16 of the same fp32 sum, taken in another order.
ONE_ROUND_TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, *shape, scale=1.0, device="cuda", dtype=torch.bfloat16):
    a = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _mlp_args(rng, b, n, d, f, device):
    return (
        _randn(rng, b, n, d, device=device),
        _randn(rng, d, scale=0.1, device=device, dtype=torch.float32) + 1.0,
        _randn(rng, d, scale=0.1, device=device, dtype=torch.float32),
        _randn(rng, d, f, scale=d ** -0.5, device=device),
        _randn(rng, f, scale=0.1, device=device),
        _randn(rng, f, d, scale=f ** -0.5, device=device),
        _randn(rng, d, scale=0.1, device=device),
    )


def _attn_args(rng, b, n, d, heads, device, dh=64):
    inner = heads * dh
    return (
        _randn(rng, b, n, d, device=device),
        _randn(rng, d, scale=0.1, device=device, dtype=torch.float32) + 1.0,
        _randn(rng, d, scale=0.1, device=device, dtype=torch.float32),
        _randn(rng, d, 3 * inner, scale=d ** -0.5, device=device),
        _randn(rng, inner, d, scale=inner ** -0.5, device=device),
    )


# -- launchers, no card needed ------------------------------------------


def test_launchers_reject_cpu_tensors():
    a = torch.zeros(4, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.gemm(a, torch.zeros(8, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.ln_rows(a, torch.ones(8), torch.zeros(8), 1e-5)


@pytest.mark.parametrize("k, n", [(12, 8), (8, 12)])
def test_gemm_rejects_unaligned_widths(k, n):
    a = torch.zeros(4, k, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        _build.gemm(a, torch.zeros(k, n, dtype=torch.bfloat16))


@pytest.mark.parametrize("dh", [24, 320])
def test_attention_rejects_head_dims_the_kernels_do_not_take(dh):
    """A head dim that is not a multiple of 16 (24: 32 heads at d 768) or
    is over 256 (320) raises before any launch, naming ROADMAP F5's
    remainder, forward and backward."""
    qkv = torch.zeros(1, 4, 3 * 2 * dh, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="F5"):
        _build.attention_fwd(qkv, heads=2, n_valid=4, scale=1.0)
    att = torch.zeros(1, 4, 2 * dh, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="F5"):
        _build.attention_bwd(qkv, att, att, torch.zeros(1, 2, 4), heads=2,
                             n_valid=4, scale=1.0)


def test_backward_launchers_reject_what_the_kernels_do_not_take():
    a = torch.zeros(16, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="together"):
        _build.gemm(a, a, trans_a=True, trans_b=True)
    with pytest.raises(ValueError, match="multiples of 8"):  # trans_a: M % 8
        _build.gemm(torch.zeros(16, 12, dtype=torch.bfloat16), a, trans_a=True)
    with pytest.raises(ValueError, match="CUDA tensor"):  # ragged R is fine
        _build.gemm(torch.zeros(13, 8, dtype=torch.bfloat16),
                    torch.zeros(13, 8, dtype=torch.bfloat16), trans_a=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.ln_rows_bwd(a, torch.zeros(16, 8), torch.ones(8), a, 1e-5)
    with pytest.raises(ValueError, match="multiple of 8"):
        _build.act_bf16(torch.zeros(3, dtype=torch.bfloat16), "gelu")


def test_tail_launcher_options_are_checked():
    """The launcher options the post-norm tail adds: a bf16 cotangent with
    the two-row sum is not instantiated; the fp32 residual is fp32."""
    a = torch.zeros(16, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not instantiated"):
        _build.ln_rows_bwd(a, a, torch.ones(8), None, 1e-5, add_g=False, x_b=a)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.ln_rows(torch.zeros(16, 8), torch.ones(8), torch.zeros(8), 1e-5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.gemm(a, torch.zeros(8, 8, dtype=torch.bfloat16),
                    residual_f32=torch.zeros(16, 8))


def test_colsum_and_mask_arguments_are_checked():
    with pytest.raises(ValueError, match="multiple of 8"):
        _build.colsum(torch.zeros(4, 12, dtype=torch.bfloat16))
    qkv = torch.zeros(1, 4, 3 * 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="keep"):
        _build.attention_fwd(qkv, 1, 4, 1.0, mask=torch.ones(1, 1, 4, 4, dtype=torch.bool),
                             keep=0.0)


#: The fp32 launchers' options (#1-#4 in float32), each refused on the
#: CPU before any launch: (launcher, args, keywords, message).
_F32_REFUSALS = [
    ("gemm_f32", (torch.zeros(4, 8), torch.zeros(8, 8)), dict(act="tanh"), "activation"),
    ("gemm_f32", (torch.zeros(4, 8), torch.zeros(8, 8)), dict(z_in=torch.zeros(4, 8)),
     "z_in needs the activation"),
    ("gemm_f32", (torch.zeros(4, 8), torch.zeros(8, 8)),
     dict(residual=torch.zeros(4, 8), residual_f32=torch.zeros(4, 8)), "not both"),
    ("gemm_f32", (torch.zeros(4, 8), torch.zeros(8, 8)),
     dict(act="gelu", save_z=True, colsum=True, bias=torch.zeros(8)), "CUDA tensor"),
    ("gemm_f32", (torch.zeros(4, 8), torch.zeros(8, 8)), dict(out_dtype=torch.bfloat16),
     "stays fp32"),
    ("act_f32", (torch.zeros(6), "gelu"), {}, "multiple of 4"),
    ("act_f32", (torch.zeros(8), "tanh"), {}, "activation"),
    ("act_f32", (torch.zeros(8), "gelu"), {}, "CUDA tensor"),
    ("ln_rows", (torch.zeros(4, 8, dtype=torch.bfloat16), torch.ones(8), torch.zeros(8), 1e-5),
     dict(out_dtype=torch.float32), "fp32 x alone"),
    ("ln_rows", (torch.zeros(4, 8), torch.ones(8), torch.zeros(8), 1e-5),
     dict(out_dtype=torch.float32, with_f32=True), "fp32 x alone"),
    ("ln_rows", (torch.zeros(4, 8), torch.ones(8), torch.zeros(8), 1e-5),
     dict(out_dtype=torch.float16), "fp32 x alone"),
    ("ln_rows", (torch.zeros(4, 8), torch.ones(8), torch.zeros(8), 1e-5),
     dict(out_dtype=torch.float32), "CUDA tensor"),
    ("ln_rows_bwd", (torch.zeros(4, 8), torch.zeros(4, 8), torch.ones(8), None, 1e-5),
     dict(add_g=False, dx_f32=True), "fp32 form"),
    ("ln_rows_bwd", (torch.zeros(4, 8), torch.zeros(4, 8), torch.ones(8), None, 1e-5),
     dict(add_g=False, x_b=torch.zeros(4, 8, dtype=torch.bfloat16)), "fp32 form"),
    ("ln_rows_bwd", (torch.zeros(4, 8), torch.zeros(4, 8), torch.ones(8), torch.zeros(4, 8),
                     1e-5), dict(g_sum=True), "CUDA tensor"),
]


@pytest.mark.parametrize("name, args, kw, match", _F32_REFUSALS,
                         ids=[f"{r[0]}-{i}" for i, r in enumerate(_F32_REFUSALS)])
def test_f32_launcher_options_are_checked(name, args, kw, match):
    with pytest.raises(ValueError, match=match):
        getattr(_build, name)(*args, **kw)


@pytest.mark.parametrize("m, n, k, sms", [
    (768, 768, 50176, 132), (768, 3072, 50176, 132), (3072, 768, 50176, 132),
    (768, 2304, 50176, 132), (256, 256, 32768, 132), (768, 768, 50184, 114),
    (72, 8, 588, 132), (8, 8, 5, 132), (256, 768, 100_000, 1),
])
def test_gemm_split_plan_covers_k_exactly(m, n, k, sms):
    """The TN split plan: at least one split, at most GEMM_MAX_SPLITS; the
    K ranges the kernel takes start at 0, meet end to end, end at K, none
    empty, each but the last a whole number of 64-row blocks and at least
    GEMM_MIN_SPLIT_BLOCKS of them when there are several."""
    splits = _build.gemm_splits(m, n, k, True, sms)
    assert 1 <= splits <= _build.GEMM_MAX_SPLITS
    # csrc/gemm_bf16.cu's rule: split s takes ceil(ceil(K / 64) / splits)
    # blocks of 64 rows from block s times that, the last cut at K.
    per = -(-(-(-k // _build.GEMM_BLOCK_K)) // splits) * _build.GEMM_BLOCK_K
    ranges = [(s * per, min(k, (s + 1) * per)) for s in range(splits)]
    assert len(ranges) == splits and ranges[0][0] == 0 and ranges[-1][1] == k
    for (s0, e0), (s1, _) in zip(ranges, ranges[1:]):
        assert e0 == s1 and e0 % _build.GEMM_BLOCK_K == 0
    for start, end in ranges:
        assert end > start
        if splits > 1:
            assert end - start > (_build.GEMM_MIN_SPLIT_BLOCKS - 1) * _build.GEMM_BLOCK_K


@pytest.mark.parametrize("m, n, k, sms, splits", [
    (32768, 2304, 768, 132, 1), (2048, 768, 256, 132, 1), (2048, 256, 768, 132, 4),
    (768, 2304, 32768, 132, 6), (256, 768, 2048, 132, 11), (7, 9, 13, 132, 1)])
def test_gemm_f32_split_plan(m, n, k, sms, splits):
    """gemm_f32 splits K where the output has too few tiles to fill the
    persistent grid's waves (its cost model: waves x depth a split + each
    split's partial round trip), each range at least 128 deep, none
    empty."""
    per = _build.gemm_f32_split(m, n, k, sms)
    kb = -(-k // _build.GEMM_F32_BLOCK_K)
    assert -(-kb // per) == splits and (splits - 1) * per < kb
    assert splits == 1 or per >= _build.GEMM_F32_MIN_SPLIT_BLOCKS


@pytest.mark.parametrize("trans_b", [False, True])
def test_gemm_splits_only_the_weight_gradients(trans_b):
    """NN and NT products are never split, whatever their depth; a TN
    product with many output tiles for the SMs is not split either."""
    assert _build.gemm_splits(50176, 768, 3072, False, 132) == 1
    assert _build.gemm_splits(768, 768, 50176, False, 132) == 1
    assert _build.gemm_splits(768, 768, 50176, True, 132) > 1
    assert _build.gemm_splits(8192, 8192, 1024, True, 132) == 1


@pytest.mark.parametrize("dh, n, dropout, route", [
    (64, 1, False, "sm90"), (64, 196, False, "sm90"), (64, 256, False, "sm90"),
    (64, 257, False, "wmma"), (64, 196, True, "wmma"), (192, 64, False, "sm90"),
    (64, 1, True, "sm90"), (64, 64, True, "sm90"), (64, 192, True, "sm90"),
    (64, 193, True, "wmma"), (192, 1, False, "sm90"), (192, 65, False, "wmma"),
    (192, 1, True, "sm90"), (192, 64, True, "sm90"), (192, 65, True, "wmma"),
    (192, 1024, True, "wmma"), (32, 256, False, "sm90"), (48, 192, True, "sm90"),
    (48, 193, True, "wmma"), (96, 64, True, "sm90"), (96, 65, False, "wmma"),
    (128, 64, False, "sm90"), (128, 192, True, "wmma"), (160, 64, True, "sm90"),
    (256, 1, False, "wmma"), (256, 64, True, "wmma"),
])
def test_attention_bwd_route(dh, n, dropout, route):
    """Each (sub-heads, dropout) pair up to its named limit on
    csrc/attention_bwd_sm90.cu (#4 at Dh up to 64 without dropout to 256
    tokens; #6's masked forms there to 192 tokens and from Dh 80 to 192 at
    one 64-row tile, which covers the flagship's and 'hier''s shapes);
    longer rows, to family A's 1,024, and Dh 208 to 256 on
    csrc/attention_bwd.cu."""
    assert _build.ATTENTION_BWD_SM90_MAX_N == 256
    assert _build.ATTENTION_BWD_SM90_LIMITS == {
        (1, False): 256, (1, True): _build.ATTENTION_BWD_SM90_MAX_N_DROPOUT,
        (2, False): _build.ATTENTION_BWD_SM90_MAX_N_DH192,
        (2, True): _build.ATTENTION_BWD_SM90_MAX_N_DH192,
        (3, False): _build.ATTENTION_BWD_SM90_MAX_N_DH192,
        (3, True): _build.ATTENTION_BWD_SM90_MAX_N_DH192}
    assert _build.attention_bwd_route(dh, n, dropout) == route


@pytest.mark.parametrize("dh, n_valid, masked, route", [
    (64, 1, False, "one pass"), (64, 64, False, "one pass"), (64, 65, False, "one pass"),
    (64, 196, False, "one pass"), (64, 256, False, "one pass"), (64, 257, False, "two passes"),
    (64, 1024, False, "two passes"), (192, 1, False, "one pass"), (192, 64, False, "one pass"),
    (192, 65, False, "two passes"), (192, 1000, False, "two passes"), (64, 64, True, "one pass"),
    (64, 196, True, "two passes"), (192, 64, True, "one pass"), (64, 192, True, "one pass"),
    (64, 193, True, "two passes"), (192, 65, True, "two passes"), (64, 1024, True, "two passes"),
    (32, 256, False, "one pass"), (48, 257, False, "two passes"), (96, 192, False, "one pass"),
    (128, 193, False, "two passes"), (128, 128, True, "one pass"), (96, 129, True, "two passes"),
    (256, 64, False, "one pass"), (256, 65, True, "two passes"), (160, 64, True, "one pass"),
])
def test_attention_fwd_route(dh, n_valid, masked, route):
    """The attention forward runs on csrc/packed_attn_sm90.cu, unmasked
    (#1, #7) and with the dropout mask (#5): one pass up to
    PACKED_ONE_PASS_MAX_N keys by sub-heads (256 at Dh up to 64, ViT-B's
    196 included; 192 at Dh 80 to 128; 64 from Dh 144) or, masked,
    PACKED_ONE_PASS_MAX_N_MASKED (192 at Dh up to 64, which covers
    'hier''s fusion layers; 128 at Dh 80 to 128; 64 from Dh 144, the
    flagship), two passes beyond."""
    assert _build.PACKED_ONE_PASS_MAX_N == {1: 256, 2: 192, 3: 64, 4: 64}
    assert _build.PACKED_ONE_PASS_MAX_N_MASKED == {1: 192, 2: 128, 3: 64, 4: 64}
    assert _build.attention_fwd_route(dh, n_valid, masked) == route


def test_attention_fwd_has_no_wmma_instance():
    """Every (head dim the kernels take, length, masked or not) up to
    family A's 1,024 takes a csrc/packed_attn_sm90.cu form, one pass or
    two, and each sub-head count's one-pass limit, unmasked and masked, is
    its widest one-pass instance of that kind."""
    for masked in (False, True):
        for dh in range(16, _build.ATTENTION_MAX_HEAD_DIM + 1, 16):
            assert _build.attention_head_dim_ok(dh)
            for n in range(1, _build.PACKED_MAX_N + 1, 7):
                assert _build.attention_fwd_route(dh, n, masked) in ("one pass", "two passes")
    for limits, forms in ((_build.PACKED_ONE_PASS_MAX_N, _build.PACKED_ATTENTION_FORMS),
                          (_build.PACKED_ONE_PASS_MAX_N_MASKED,
                           _build.PACKED_ATTENTION_MASKED_FORMS)):
        for c, limit in limits.items():
            assert max(nk for d, nk in forms.values() if d == 64 * c) == limit
            assert (64 * c, 0) in forms.values()  # the two-pass form past it


@pytest.mark.parametrize("rows, d, per_sm, threads, blocks", [
    (50176, 768, 5, 96, 660), (32768, 768, 5, 96, 660), (32768, 256, 16, 32, 2112),
    (1000, 384, 8, 64, 250), (37, 3072, 1, 384, 10), (1, 8, 16, 32, 1), (0, 768, 5, 96, 0),
    (12544, 1024, 3, 128, 396),
])
def test_ln_rows_bwd_plan(rows, d, per_sm, threads, blocks):
    """csrc/ln_rows_bwd.cu's launch: a thread a 16-byte chunk of the row,
    rounded up to a warp, and at most one block a LN_BWD_ROWS rows, capped
    at what the card holds at once (132 SMs here); the workspace holds one
    row of column partials a block."""
    assert _build.LN_BWD_ROWS == 4 and _build.LN_BWD_MAX_D == 3072
    assert _build.ln_rows_bwd_plan(rows, d, per_sm, 132) == (threads, blocks)


@pytest.mark.parametrize("d", [0, 12, 3080, 4096])
def test_ln_rows_bwd_refuses_widths_it_has_no_thread_for(d):
    with pytest.raises(ValueError, match="multiple of 8 in"):
        _build.ln_rows_bwd_plan(10, d, 4, 132)
    a = torch.zeros(4, max(d, 1), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        _build.ln_rows_bwd(a, a.float(), torch.ones(max(d, 1)), a, 1e-5)


@pytest.mark.parametrize("d, route", [
    (768, "cluster"), (256, "cluster"), (128, "cluster"), (1024, "cluster"),
    (200, "chain"), (776, "chain"), (1152, "chain"),
])
def test_tail_fc2_route_by_width(d, route):
    """#15's fc2 + LN2: one cluster launch where D is whole 128-column
    tiles, at most GEMM_LN_MAX_CLUSTER (8) of them (the flagship's 768: 6,
    'hier''s 256: 2); other widths (not a multiple of 128, or past the
    cluster cap) take the fc2 GEMM and ln_rows as two launches.  The
    launcher refuses a width the cluster kernel does not take."""
    from sfc_vit_tpu_torch.ops.fused_mlp import tail_fc2_route

    assert _build.GEMM_LN_MAX_CLUSTER == 8
    assert tail_fc2_route(d) == route
    assert _build.gemm_layernorm_fits(d) == (route == "cluster")
    h = torch.zeros(4, 1024, dtype=torch.bfloat16)
    w2 = torch.zeros(1024, d, dtype=torch.bfloat16)
    rows, vec = torch.zeros(4, d, dtype=torch.bfloat16), torch.zeros(d)
    with pytest.raises(ValueError, match="CUDA tensor" if route == "cluster" else "multiple"):
        _build.gemm_layernorm(h, w2, vec, rows, rows, torch.zeros(4, 2), vec, vec, vec, vec,
                              1e-5)


def _rn32(v) -> np.float32:
    """The float32 nearest an exact rational (ties to even)."""
    from fractions import Fraction

    c = np.float32(float(v))
    cands = [np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf))]
    return min(cands, key=lambda f: (abs(Fraction(float(f)) - v),
                                     int(np.float32(f).view(np.uint32)) & 1))


@pytest.mark.parametrize("keep", [0.9, 0.5, 0.8, 0.3, 0.95, 0.123])
def test_div_rn_is_the_correctly_rounded_quotient(keep):
    """csrc/common.cuh's div_rn (the attention backward's x / keep, the
    LayerNorm form's sums / D): q = RN(x rk) with rk = RN(1 / keep), then
    RN(q + (x - q keep) rk) by fma, emulated exactly, equals float32
    x / keep (IEEE) for normal x over 60 decades."""
    from fractions import Fraction

    rng = np.random.default_rng(63)
    k = np.float32(keep)
    rk = _rn32(Fraction(1) / Fraction(float(k)))
    xs = (rng.standard_normal(400) * 10.0 ** rng.integers(-30, 30, 400)).astype(np.float32)
    for x in xs:
        q = _rn32(Fraction(float(x)) * Fraction(float(rk)))
        r = _rn32(Fraction(float(x)) - Fraction(float(q)) * Fraction(float(k)))
        got = _rn32(Fraction(float(r)) * Fraction(float(rk)) + Fraction(float(q)))
        assert got == np.float32(x) / k, (x, got)


def _old_torch_mha_bwd_dqkv(qkv, att, datt, lse, heads, n_valid, s, mask, keep):
    """The dqkv of ``torch_mha_bwd_ref`` as written before it called
    ``attention_bwd_ref`` (its inline formula), for the test below."""
    b, n, w = qkv.shape
    dh = w // (3 * heads)
    dt = qkv.dtype
    q, k, v = qkv.view(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4).float()
    logits = (q @ k.transpose(-1, -2)) * s
    logits[..., n_valid:] = -1e30
    da = datt.view(b, n, heads, dh).permute(0, 2, 1, 3).float()
    pf = torch.exp(logits - lse[..., None])
    maskf = mask.float()
    dv = ((pf / keep) * maskf).to(dt).float().transpose(-1, -2) @ da
    dp = ((da @ v.transpose(-1, -2)) / keep) * maskf
    delta = (da * att.view(b, n, heads, dh).permute(0, 2, 1, 3).float()).sum(-1, keepdim=True)
    ds = (pf * (dp - delta) * s).to(dt).float()
    dqkv = torch.stack([ds @ k, ds.transpose(-1, -2) @ q, dv])
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, n, w).to(dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, n, heads, dh, n_valid", [
    (2, 20, 2, 64, 13), (3, 16, 1, 192, 11), (2, 64, 2, 64, 50), (3, 64, 1, 192, 64),
])
def test_masked_attention_bwd_ref_is_the_torch_mha_bwd_formula(b, n, heads, dh, n_valid, dt):
    """The masked plain twin of the attention backward (#6's rounding
    points) gives, bit for bit, the dqkv that torch_mha_bwd_ref computed
    inline before it called attention_bwd_ref, at Dh 64 and 192 with a
    ragged n_valid; torch_mha_bwd_ref's dW_in with x the identity is that
    dqkv; and with a mask of ones, keep 1 and fp32 inputs it is the
    unmasked form."""
    rng = np.random.default_rng(60)
    s = dh ** -0.5
    qkv = _randn(rng, b, n, 3 * heads * dh, device="cpu", dtype=dt)
    att, lse = attention_fwd_ref(qkv, heads, n_valid, s)
    datt = _randn(rng, b, n, heads * dh, device="cpu", dtype=dt)
    mask = torch.from_numpy(rng.random((b, heads, n, n)) < 0.9)
    got = attention_bwd_ref(qkv, att, datt, lse, heads, n_valid, s, mask=mask, keep=0.9)
    want = _old_torch_mha_bwd_dqkv(qkv, att, datt, lse, heads, n_valid, s, mask, 0.9)
    assert torch.equal(got, want)
    if b * n == heads * dh:  # x = I: dW_in = x^T dqkv is dqkv itself
        d = heads * dh
        x = torch.eye(d, dtype=dt).view(b, n, d)
        w_in = _randn(rng, d, 3 * d, device="cpu", dtype=dt)
        w_out = _randn(rng, d, d, device="cpu", dtype=dt)
        g = _randn(rng, b, n, d, device="cpu", dtype=dt)
        gp = g.clone()
        gp[:, n_valid:] = 0  # pad rows add nothing (torch_mha_bwd_ref's contract)
        datt_g = (gp.reshape(-1, d).float() @ w_out.float().T).to(dt).view(b, n, d)
        dw_in = torch_mha_bwd_ref(x, g, w_in, w_out, mask, qkv, att, lse, heads, s,
                                  keep=0.9, n_actual=n_valid)[1]
        want = attention_bwd_ref(qkv, att, datt_g, lse, heads, n_valid, s, mask=mask,
                                 keep=0.9)
        assert torch.equal(dw_in, want.reshape(-1, 3 * d).float())
    if dt == torch.float32:
        ones = torch.ones_like(mask)
        assert torch.equal(
            attention_bwd_ref(qkv, att, datt, lse, heads, n_valid, s, mask=ones, keep=1.0),
            attention_bwd_ref(qkv, att, datt, lse, heads, n_valid, s))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here; the failure path needs none")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_cpu_wrappers_run_the_plain_versions():
    rng = np.random.default_rng(0)
    margs = _mlp_args(rng, 2, 5, 16, 32, "cpu")
    margs = tuple(t.float() for t in margs)
    before = fused_mlp_block.launches
    torch.testing.assert_close(fused_mlp_block(*margs), mlp_block_ref(*margs),
                               rtol=0, atol=0)
    aargs = tuple(t.float() for t in _attn_args(rng, 2, 5, 16, 2, "cpu"))
    torch.testing.assert_close(
        fused_attention_block(*aargs, heads=2),
        attention_block_ref(*aargs, heads=2), rtol=0, atol=0)
    assert fused_mlp_block.launches == before  # counts CUDA calls only


# -- kernels on the card ------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("rows, d", [(1, 8), (200, 768), (12544, 768)])
def test_ln_rows_matches_ln_fp32(cuda, rows, d):
    rng = np.random.default_rng(1)
    x = _randn(rng, rows, d, scale=3.0) + 0.5
    s = _randn(rng, d, dtype=torch.float32)
    b = _randn(rng, d, dtype=torch.float32)
    got = _build.ln_rows(x, s, b, 1e-5)
    torch.testing.assert_close(got.float(), ln_fp32(x, s, b).float(),
                               **ONE_ROUND_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("act", [None, "gelu", "relu"])
@pytest.mark.parametrize("r, k, n", [(1, 8, 8), (200, 64, 136),
                                     (333, 768, 2304), (12544, 3072, 768)])
def test_gemm_matches_fp32_product(cuda, r, k, n, act):
    rng = np.random.default_rng(2)
    a = _randn(rng, r, k)
    b = _randn(rng, k, n, scale=k ** -0.5)
    bias = _randn(rng, n, dtype=torch.float32)
    res = _randn(rng, r, n)
    got = _build.gemm(a, b, bias=bias, act=act, residual=res)
    want = a.float() @ b.float() + bias
    if act == "gelu":
        want = F.gelu(want)
    elif act == "relu":
        want = F.relu(want)
    want = (want + res.float()).to(torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), **ONE_ROUND_TOL)
    plain = _build.gemm(a, b)
    torch.testing.assert_close(
        plain.float(), (a.float() @ b.float()).bfloat16().float(),
        **ONE_ROUND_TOL)


def _attention_plain(qkv, heads, n_valid, scale):
    """fp32 logits, keys >= n_valid masked, P rounded to bf16 before P.V
    (the kernel's rounding point)."""
    b, n, w = qkv.shape
    dh = w // (3 * heads)
    q, k, v = qkv.view(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4).float()
    logits = q @ k.transpose(-1, -2) * scale
    logits[..., n_valid:] = -1e30
    p = torch.softmax(logits, dim=-1).bfloat16().float()
    return (p @ v).transpose(1, 2).reshape(b, n, heads * dh).bfloat16()


def _packed_lse64(qkv, heads, n_valid, scale):
    """log-sum-exp of each row's scaled logits over the valid keys, fp64."""
    b, n, w = qkv.shape
    q, k, _ = qkv.view(b, n, 3, heads, w // (3 * heads)).permute(2, 0, 3, 1, 4).double()
    return torch.logsumexp((q @ k[:, :, :n_valid].transpose(-1, -2)) * scale, dim=-1)


#: The head dims past 64 and 192 (ROADMAP F5), each on both sides of its
#: one-pass limit (256 keys at Dh 32 and 48, 192 at 96 and 128, 64 at 256),
#: ViT-B's pad-once 196 of 208 at Dh 96, and more items than the grid.
_NEW_HEAD_DIM_FWD_SHAPES = [
    (2, 256, 2, 32, 256), (2, 260, 2, 32, 257), (2, 200, 3, 48, 196), (2, 300, 2, 48, 300),
    (2, 192, 2, 96, 192), (2, 208, 2, 96, 196), (2, 192, 2, 128, 192), (2, 193, 2, 128, 193),
    (2, 64, 2, 256, 64), (2, 130, 2, 256, 100), (200, 64, 6, 128, 64), (100, 64, 3, 256, 64),
]
#: (b, n, heads, dh, n_valid): one 64-key tile, one key past it, ViT-B's
#: 196 (whole and ragged), the 200- and 256-column one-pass forms on either
#: side of 200 keys, the one-pass limit and one past it, the longest row, a
#: single token, and the unmasked Dh 192 in one pass and in two.
_ATTN_FWD_SHAPES = [
    (2, 64, 2, 64, 49), (2, 65, 2, 64, 65), (3, 196, 2, 64, 196), (2, 196, 12, 64, 150),
    (2, 200, 2, 64, 200), (2, 210, 2, 64, 201), (2, 256, 2, 64, 256), (2, 257, 2, 64, 257),
    (1, 1024, 2, 64, 1000), (1, 1, 1, 64, 1),
    (2, 64, 2, 192, 64), (2, 130, 2, 192, 100), (1, 1, 1, 192, 1),
    *_NEW_HEAD_DIM_FWD_SHAPES,
]


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, heads, dh, n_valid", _ATTN_FWD_SHAPES)
def test_attention_fwd_matches_plain(cuda, b, n, heads, dh, n_valid):
    """The unmasked attention forward (csrc/packed_attn_sm90.cu) against the
    plain formula, its lse against fp64 within the chip check's 1e-5, and
    the output with and without lse bit-equal."""
    rng = np.random.default_rng(3)
    s = dh ** -0.5
    qkv = _randn(rng, b, n, 3 * heads * dh)
    assert _build.attention_fwd_route(dh, n_valid, False) != "wmma"
    got, lse = _build.attention_fwd(qkv, heads, n_valid, s, with_lse=True)
    want = _attention_plain(qkv, heads, n_valid, s)
    torch.testing.assert_close(got.float(), want.float(), **ONE_ROUND_TOL)
    torch.testing.assert_close(lse.double(), _packed_lse64(qkv, heads, n_valid, s),
                               rtol=1e-5, atol=1e-5)
    ref_att, ref_lse = attention_fwd_ref(qkv, heads, n_valid, s)
    torch.testing.assert_close(got.float(), ref_att.float(), **ONE_ROUND_TOL)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, _build.attention_fwd(qkv, heads, n_valid, s))


#: Masked (#5) attention-forward shapes (b, n, heads, dh, n_valid, keep):
#: every masked instance (Dh 64: one pass over 64, 128 and 192 key
#: columns, two passes at 193, 1,000 and 1,024; Dh 192: one pass at 64, two
#: at 65, 128 and 1,000), the mask by TMA (n a multiple of 16) and by plain
#: loads (65, 193, 1,000), ragged n_valid, keep 0.9 and 1.0, and the
#: flagship's and 'hier''s shapes with enough items that every block of
#: the persistent grid takes several.
_MASKED_FWD_SHAPES = [
    (3, 64, 2, 64, 64, 0.9), (3, 65, 2, 64, 65, 0.9), (3, 192, 2, 64, 192, 0.9),
    (2, 193, 2, 64, 193, 0.9), (1, 1000, 2, 64, 990, 0.9), (1, 1024, 2, 64, 1024, 0.9),
    (3, 64, 2, 192, 64, 0.9), (3, 65, 2, 192, 65, 0.9), (2, 128, 2, 192, 128, 0.9),
    (1, 1000, 2, 192, 1000, 0.9), (3, 64, 2, 64, 50, 0.9), (3, 192, 2, 64, 150, 1.0),
    (3, 64, 2, 192, 41, 1.0), (2, 193, 2, 64, 130, 1.0), (300, 64, 4, 192, 64, 0.9),
    (300, 64, 4, 64, 64, 0.9), (100, 192, 4, 64, 192, 0.9),
    (3, 192, 2, 32, 192, 0.9), (3, 193, 2, 48, 193, 0.9), (3, 128, 2, 96, 128, 0.9),
    (3, 208, 2, 96, 196, 0.9), (3, 128, 2, 128, 128, 0.9), (3, 129, 2, 128, 129, 0.9),
    (3, 64, 2, 256, 64, 0.9), (3, 65, 2, 256, 65, 0.9), (200, 64, 6, 128, 64, 0.9),
    (100, 192, 2, 128, 192, 1.0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, heads, dh, n_valid, keep", _MASKED_FWD_SHAPES)
def test_masked_attention_fwd_matches_plain(cuda, b, n, heads, dh, n_valid, keep):
    """#5's attention (csrc/packed_attn_sm90.cu with the dropout mask)
    against attention_fwd_ref with the same mask within rtol/atol 4e-2, its
    lse (taken before the mask) within 1e-5, and the same bits on a second
    call."""
    rng = np.random.default_rng(56)
    s = dh ** -0.5
    qkv = _randn(rng, b, n, 3 * heads * dh)
    mask = torch.from_numpy(rng.random((b, heads, n, n)) < 0.9).to(cuda)
    route = _build.attention_fwd_route(dh, n_valid, True)
    limit = _build.PACKED_ONE_PASS_MAX_N_MASKED[_build.attention_subheads(dh)]
    assert route == ("one pass" if n_valid <= limit else "two passes")
    got, lse = _build.attention_fwd(qkv, heads, n_valid, s, with_lse=True, mask=mask, keep=keep)
    want, want_lse = attention_fwd_ref(qkv, heads, n_valid, s, mask=mask, keep=keep)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    again, again_lse = _build.attention_fwd(qkv, heads, n_valid, s, with_lse=True, mask=mask,
                                            keep=keep)
    assert torch.equal(got, again) and torch.equal(lse, again_lse)
    assert torch.equal(got, _build.attention_fwd(qkv, heads, n_valid, s, mask=mask,
                                                 keep=keep))


@pytest.mark.gpu
def test_unmasked_attention_past_the_packed_kernel_raises(cuda):
    """No fallback: an unmasked row longer than PACKED_MAX_N raises."""
    qkv = torch.zeros(1, _build.PACKED_MAX_N + 1, 3 * 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="over the kernel's"):
        _build.attention_fwd(qkv, 1, _build.PACKED_MAX_N + 1, 0.125)


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, d, f", [(2, 49, 128, 256), (4, 196, 768, 3072)])
def test_fused_mlp_block_matches_ref(cuda, b, n, d, f):
    args = _mlp_args(np.random.default_rng(4), b, n, d, f, cuda)
    before = fused_mlp_block.launches
    with torch.no_grad():
        got = fused_mlp_block(*args)
        want = mlp_block_ref(*args)
    assert fused_mlp_block.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, d, heads, n_actual", [
    (2, 64, 128, 2, 49), (2, 64, 128, 2, None), (4, 196, 768, 12, None),
    (4, 196, 768, 12, 150),
])
def test_fused_attention_block_matches_ref(cuda, b, n, d, heads, n_actual):
    args = _attn_args(np.random.default_rng(5), b, n, d, heads, cuda)
    before = fused_attention_block.launches
    with torch.no_grad():
        got = fused_attention_block(*args, heads=heads, n_actual=n_actual)
        want = attention_block_ref(*args, heads=heads, n_actual=n_actual)
    assert fused_attention_block.launches == before + 1
    real = n if n_actual is None else n_actual
    torch.testing.assert_close(got[:, :real].float(), want[:, :real].float(),
                               **BF16_TOL)


@pytest.mark.gpu
def test_grad_inputs_run_the_backward_kernels(cuda):
    """A CUDA input that requires grad goes through the autograd
    Functions: one forward and one backward launch per block."""
    args = _mlp_args(np.random.default_rng(6), 1, 4, 16, 32, cuda)
    w = args[3].clone().requires_grad_()
    before = (fused_mlp_block.launches, fused_mlp_block.bwd_launches)
    fused_mlp_block(args[0], args[1], args[2], w, *args[4:]).sum().backward()
    assert (fused_mlp_block.launches, fused_mlp_block.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    assert w.grad is not None and w.grad.dtype == torch.bfloat16
    aargs = list(_attn_args(np.random.default_rng(6), 1, 4, 128, 2, cuda))
    aargs[0].requires_grad_()
    before = (fused_attention_block.launches, fused_attention_block.bwd_launches)
    fused_attention_block(*aargs, heads=2).float().sum().backward()
    assert (fused_attention_block.launches,
            fused_attention_block.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(aargs[0].grad.float()).all()


# -- backward kernels on the card ----------------------------------------

# fp32 results summed in another order (atomics across blocks included).
F32_SUM_TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("m, k, n", [(8, 5, 8), (768, 1000, 3072),
                                     (3072, 12545, 768), (64, 200, 192)])
def test_gemm_tn_matches_fp32_product(cuda, m, k, n):
    """TN: a stored [K, M] (K = rows, ragged), the weight gradients."""
    rng = np.random.default_rng(10)
    a, b = _randn(rng, k, m), _randn(rng, k, n)
    want = a.float().T @ b.float()
    torch.testing.assert_close(_build.gemm(a, b, trans_a=True).float(),
                               want.bfloat16().float(), **ONE_ROUND_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("m, k, n", [(1, 8, 8), (333, 768, 3072),
                                     (12544, 3072, 768), (200, 2304, 768)])
def test_gemm_nt_matches_fp32_product(cuda, m, k, n):
    """NT: b stored [N, K], the products with W^T; bf16 and fp32 C."""
    rng = np.random.default_rng(11)
    a, b = _randn(rng, m, k), _randn(rng, n, k, scale=k ** -0.5)
    want = a.float() @ b.float().T
    torch.testing.assert_close(_build.gemm(a, b, trans_b=True).float(),
                               want.bfloat16().float(), **ONE_ROUND_TOL)
    got = _build.gemm(a, b, trans_b=True, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, **F32_SUM_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_gemm_save_z_and_dact_epilogues(cuda, act):
    rng = np.random.default_rng(12)
    r, d, f = 1000, 768, 3072
    x, w1, b1 = _randn(rng, r, d), _randn(rng, d, f, scale=d ** -0.5), \
        _randn(rng, f, dtype=torch.float32)
    h, z = _build.gemm(x, w1, bias=b1, act=act, save_z=True)
    pre = x.float() @ w1.float() + b1
    torch.testing.assert_close(z.float(), pre.bfloat16().float(), **ONE_ROUND_TOL)
    fwd = F.gelu(pre) if act == "gelu" else F.relu(pre)
    torch.testing.assert_close(h.float(), fwd.bfloat16().float(), **ONE_ROUND_TOL)
    torch.testing.assert_close(_build.act_bf16(z, act).float(),
                               (F.gelu(z.float()) if act == "gelu"
                                else F.relu(z.float())).bfloat16().float(),
                               **ONE_ROUND_TOL)
    g, w2 = _randn(rng, r, d), _randn(rng, f, d, scale=f ** -0.5)
    dz, db1 = _build.gemm(g, w2, trans_b=True, act=act, z_in=z, colsum=True)
    zf = z.float()
    dact = (0.5 * (1 + torch.erf(zf * 2 ** -0.5))
            + zf * torch.exp(-0.5 * zf * zf) * (2 * np.pi) ** -0.5
            if act == "gelu" else (zf > 0).float())
    want = (g.float() @ w2.float().T) * dact
    torch.testing.assert_close(dz.float(), want.bfloat16().float(), **ONE_ROUND_TOL)
    torch.testing.assert_close(db1, want.sum(0), **F32_SUM_TOL)
    assert torch.equal(db1, _build.gemm(g, w2, trans_b=True, act=act, z_in=z, colsum=True)[1])


def _gemm_operands(rng, form, r, n, k=768):
    """a, b stored as ``form`` reads them and the fp32 product: NN and NT
    a [R, K] (R output rows), TN a [R, K] read transposed (R = the
    contraction, K output rows)."""
    if form == "TN":
        a, b = _randn(rng, r, k), _randn(rng, r, n, scale=r ** -0.5)
        return a, b, a.float().T @ b.float()
    a = _randn(rng, r, k)
    if form == "NT":
        b = _randn(rng, n, k, scale=k ** -0.5)
        return a, b, a.float() @ b.float().T
    b = _randn(rng, k, n, scale=k ** -0.5)
    return a, b, a.float() @ b.float()


def _gemm(form, a, b, **kw):
    return _build.gemm(a, b, trans_a=form == "TN", trans_b=form == "NT", **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8, 72, 768, 2304])
@pytest.mark.parametrize("r", [196 * 3, 50176 + 8])
@pytest.mark.parametrize("form", ["NN", "NT", "TN"])
def test_gemm_forms_at_ragged_rows(cuda, form, r, n):
    """The TMA + wgmma GEMM in its three layouts at ragged R (rows, or the
    contraction of TN) and N down to 8, bf16 and fp32 C against the fp32
    product."""
    a, b, want = _gemm_operands(np.random.default_rng(50), form, r, n)
    torch.testing.assert_close(_gemm(form, a, b).float(), want.bfloat16().float(),
                               **ONE_ROUND_TOL)
    got = _gemm(form, a, b, out_dtype=torch.float32)
    torch.testing.assert_close(got, want, **F32_SUM_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("r, n", [(333, 136), (50176 + 8, 72)])
@pytest.mark.parametrize("form", ["NN", "NT", "TN"])
def test_gemm_epilogues_in_every_form(cuda, form, r, n):
    """Every epilogue term in every layout, in the contract's order (+ bias;
    z; act or act'(z); colsum; + residual; + residual_f32; one rounding),
    bf16 and fp32 C; TN at 50,184 rows runs split-K, whose second pass
    applies the epilogue."""
    rng = np.random.default_rng(51)
    a, b, prod = _gemm_operands(rng, form, r, n)
    m = prod.shape[0]
    bias = _randn(rng, n, dtype=torch.float32)
    res, res32 = _randn(rng, m, n), _randn(rng, m, n, dtype=torch.float32)
    pre = prod + bias
    c, z, cs = _gemm(form, a, b, bias=bias, act="gelu", residual=res,
                     save_z=True, colsum=True)
    torch.testing.assert_close(z.float(), pre.bfloat16().float(), **ONE_ROUND_TOL)
    torch.testing.assert_close(cs, F.gelu(pre).sum(0), rtol=1e-3, atol=1e-2)
    torch.testing.assert_close(c.float(), (F.gelu(pre) + res.float()).bfloat16().float(),
                               **ONE_ROUND_TOL)
    zin = _randn(rng, m, n)
    dz, db = _gemm(form, a, b, act="relu", z_in=zin, colsum=True,
                   residual_f32=res32, out_dtype=torch.float32)
    want = prod * (zin.float() > 0).float()
    torch.testing.assert_close(db, want.sum(0), rtol=1e-3, atol=1e-2)
    torch.testing.assert_close(dz, want + res32, **F32_SUM_TOL)


#: The persistent walk's edges (rows, K, N): one tile; fewer tiles than
#: SMs; 265 tiles (= 2 x 132 + 1: block 0 takes three, the others two);
#: K of one 64-deep slice; K not a multiple of 64 with ragged M and N; K
#: of 8.  TN reads ``rows`` as the contraction (split-K from 512 rows on)
#: and K as C's rows.
GEMM_EDGES = [(128, 768, 128), (1000, 768, 1024), (6784, 256, 640), (300, 64, 256),
                  (333, 200, 136), (77, 8, 24)]


def _epilogue_want(prod, bias=None, act=None, z_in=None, residual=None, residual_f32=None):
    """fp32 C (before its rounding), the rounded pre-activation and the
    column sums of ``_build.gemm``'s epilogue over the fp32 product."""
    pre = prod if bias is None else prod + bias
    if z_in is not None:
        z = z_in.float()
        grad = (0.5 * (1 + torch.erf(z * 2 ** -0.5)) + z * torch.exp(-0.5 * z * z)
                * (2 * np.pi) ** -0.5) if act == "gelu" else (z > 0).float()
        out = pre * grad
    else:
        out = F.gelu(pre) if act == "gelu" else F.relu(pre) if act == "relu" else pre
    cs = out.sum(0)
    if residual is not None:
        out = out + residual.float()
    if residual_f32 is not None:
        out = out + residual_f32
    return out, pre.bfloat16(), cs


@pytest.mark.gpu
@pytest.mark.parametrize("rows, k, n", GEMM_EDGES)
@pytest.mark.parametrize("form", ["NN", "NT", "TN"])
def test_gemm_edges(cuda, form, rows, k, n):
    """The plain product at the walk's edges, bf16 and fp32 C, against
    the fp32 product; the same bits on a second call."""
    a, b, want = _gemm_operands(np.random.default_rng(55), form, rows, n, k)
    got = _gemm(form, a, b)
    torch.testing.assert_close(got.float(), want.bfloat16().float(), **ONE_ROUND_TOL)
    assert torch.equal(got, _gemm(form, a, b))
    got = _gemm(form, a, b, out_dtype=torch.float32)
    torch.testing.assert_close(got, want, **F32_SUM_TOL)
    assert torch.equal(got, _gemm(form, a, b, out_dtype=torch.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("rows, k, n", [(333, 200, 136), (6784, 256, 640)])
@pytest.mark.parametrize("kind", ["none", "gelu", "relu", "gelu'", "relu'"])
@pytest.mark.parametrize("form", ["NN", "NT", "TN"])
def test_gemm_every_act_kind_and_epilogue_term(cuda, form, kind, rows, k, n):
    """Each act kind with each epilogue term: act (or none) with the bias,
    save_z, colsum and a bf16 residual into a bf16 C, then with an fp32
    residual into an fp32 C; act'(z_in) with colsum into a bf16 C, then
    with an fp32 residual into an fp32 C.  C, z and the column sums (one
    owner a 128-row tile, or a 32-row block after a split, the tiles added
    in order) give the same bits on a second call."""
    rng = np.random.default_rng(56)
    a, b, prod = _gemm_operands(rng, form, rows, n, k)
    m = prod.shape[0]
    bias = _randn(rng, n, dtype=torch.float32)
    res, res32 = _randn(rng, m, n), _randn(rng, m, n, dtype=torch.float32)
    act = None if kind == "none" else kind.rstrip("'")
    cs_tol = dict(rtol=1e-3, atol=1e-2)
    if kind.endswith("'"):
        zin = _randn(rng, m, n)
        calls = [dict(act=act, z_in=zin, colsum=True),
                 dict(act=act, z_in=zin, colsum=True, residual_f32=res32,
                      out_dtype=torch.float32)]
    else:
        calls = [dict(bias=bias, act=act, save_z=True, colsum=True, residual=res),
                 dict(bias=bias, act=act, colsum=True, residual_f32=res32,
                      out_dtype=torch.float32)]
    for kw in calls:
        outs = _gemm(form, a, b, **kw)
        c, *extra = outs
        want, want_z, want_cs = _epilogue_want(
            prod, kw.get("bias"), act, kw.get("z_in"), kw.get("residual"),
            kw.get("residual_f32"))
        if c.dtype == torch.float32:
            torch.testing.assert_close(c, want, **F32_SUM_TOL)
        else:
            torch.testing.assert_close(c.float(), want.bfloat16().float(), **ONE_ROUND_TOL)
        if kw.get("save_z"):
            torch.testing.assert_close(extra[0].float(), want_z.float(), **ONE_ROUND_TOL)
        torch.testing.assert_close(extra[-1], want_cs, **cs_tol)
        again = _gemm(form, a, b, **kw)
        assert torch.equal(c, again[0])
        assert torch.equal(extra[-1], again[-1])
        if kw.get("save_z"):
            assert torch.equal(extra[0], again[1])


@pytest.mark.gpu
def test_gemm_split_k_repeats_bit_for_bit(cuda):
    """dW_out's shape at ViT-B batch 256 (+ 8 ragged rows): the TN product
    is split, each output one fp32 sum in split order, so two calls give
    the same bits, in bf16 and fp32 C, and the fp32 C is the fp32 product."""
    rng = np.random.default_rng(52)
    r = 50176 + 8
    a, b, want = _gemm_operands(rng, "TN", r, 768)
    assert _build.gemm_splits(768, 768, r, True, _build._sm_count(a.device)) > 1
    first, second = (_gemm("TN", a, b, out_dtype=torch.float32) for _ in range(2))
    assert torch.equal(first, second)
    torch.testing.assert_close(first, want, **F32_SUM_TOL)
    assert torch.equal(_gemm("TN", a, b), _gemm("TN", a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, heads, n_valid", [
    (2, 64, 3, 50), (3, 196, 12, 150), (2, 196, 2, 196), (2, 200, 2, 199),
    (1, 256, 4, 100), (3, 1, 2, 1),
])
def test_attention_bwd_sm90_matches_plain(cuda, b, n, heads, n_valid):
    """#4's attention backward on csrc/attention_bwd_sm90.cu against
    attention_bwd_ref (its rounding points) at lengths around ViT-B's 196
    and up to the kernel's limit, keys masked past n_valid; two calls give
    the same bits (no atomics, no second kernel)."""
    assert _build.attention_bwd_route(64, n, False) == "sm90"
    rng = np.random.default_rng(53)
    s = 64 ** -0.5
    qkv = _randn(rng, b, n, 3 * heads * 64)
    att, lse = attention_fwd_ref(qkv, heads, n_valid, s)
    datt = _randn(rng, b, n, heads * 64)
    got = _build.attention_bwd(qkv, att, datt, lse, heads, n_valid, s)
    want = attention_bwd_ref(qkv, att, datt, lse, heads, n_valid, s)
    torch.testing.assert_close(got.float(), want.float(), **ONE_ROUND_TOL)
    assert torch.equal(got, _build.attention_bwd(qkv, att, datt, lse, heads, n_valid, s))


#: Masked (and Dh-192) attention-backward shapes (b, n, heads, dh, n_valid,
#: dropout): the flagship's [.., 64, 4 x 192] and 'hier''s level and
#: fusion layers [.., 64 | 192, 4 x 64] with enough (image, head) items
#: that every block takes several (the next item's tiles in flight);
#: ragged n_valid; one token and 37 (n * n not a multiple of 16: the mask
#: by plain loads); two tiles; Dh 192 without dropout; the flagship at 6
#: and 8 heads (Dh 128, 96), 'hier' at 8 (Dh 32), Dh 48 and 160.
_MASKED_BWD_SHAPES = [
    (96, 64, 4, 192, 64, True), (96, 64, 4, 64, 64, True), (80, 192, 4, 64, 192, True),
    (96, 64, 4, 192, 50, True), (80, 192, 4, 64, 150, True), (3, 1, 2, 192, 1, True),
    (3, 1, 2, 64, 1, True), (70, 37, 4, 64, 30, True), (70, 37, 4, 192, 37, True),
    (40, 100, 4, 64, 99, True), (96, 64, 4, 192, 57, False), (3, 1, 2, 192, 1, False),
    (96, 64, 6, 128, 64, True), (96, 64, 6, 128, 50, False), (96, 64, 8, 96, 64, True),
    (3, 37, 2, 96, 30, True), (80, 192, 8, 32, 192, True), (40, 256, 4, 32, 250, False),
    (80, 192, 4, 48, 150, True), (3, 64, 2, 160, 64, True),
]


def _attention_bwd_case(rng, b, n, heads, dh, n_valid, dropout, device="cuda"):
    """(qkv, att, datt, lse, mask or None, scale) for the attention backward."""
    s = dh ** -0.5
    qkv = _randn(rng, b, n, 3 * heads * dh, device=device)
    att, lse = attention_fwd_ref(qkv, heads, n_valid, s)
    datt = _randn(rng, b, n, heads * dh, device=device)
    mask = (torch.from_numpy(rng.random((b, heads, n, n)) < 0.9).to(device)
            if dropout else None)
    return qkv, att, datt, lse, mask, s


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, heads, dh, n_valid, dropout", _MASKED_BWD_SHAPES)
def test_attention_bwd_sm90_masked_matches_plain(cuda, b, n, heads, dh, n_valid, dropout):
    """#6's attention backward on csrc/attention_bwd_sm90.cu (the mask and
    keep 0.9, Dh 64 and 192) against the masked plain twin
    attention_bwd_ref within 2 % of its largest |value|; two calls give the
    same bits."""
    assert _build.attention_bwd_route(dh, n, dropout) == "sm90"
    qkv, att, datt, lse, mask, s = _attention_bwd_case(
        np.random.default_rng(55), b, n, heads, dh, n_valid, dropout)
    got = _build.attention_bwd(qkv, att, datt, lse, heads, n_valid, s, mask=mask, keep=0.9)
    want = attention_bwd_ref(qkv, att, datt, lse, heads, n_valid, s, mask=mask, keep=0.9)
    _within(got, want, 2e-2, "dqkv")
    assert torch.equal(got, _build.attention_bwd(qkv, att, datt, lse, heads, n_valid, s,
                                                 mask=mask, keep=0.9))


@pytest.mark.gpu
@pytest.mark.parametrize("dh, dropout, n", [
    (64, False, 256), (64, False, 257), (64, True, 192), (64, True, 193),
    (192, False, 64), (192, False, 65), (192, True, 64), (192, True, 65),
    (32, False, 256), (32, True, 193), (48, True, 192), (48, False, 257),
    (96, False, 64), (96, True, 65), (128, True, 64), (128, False, 65), (128, True, 196),
    (256, False, 64), (256, True, 65),
])
def test_attention_bwd_routes_on_either_side_of_the_limit(cuda, dh, dropout, n):
    """The same formula on both kernels: each (sub-heads, dropout) pair's
    limit on the Hopper kernel, one token more on csrc/attention_bwd.cu
    (Dh 256 always there), each held to attention_bwd_ref and to a second
    call (bit for bit)."""
    limit = _build.ATTENTION_BWD_SM90_LIMITS.get((_build.attention_subheads(dh), dropout), 0)
    assert _build.attention_bwd_route(dh, n, dropout) == ("sm90" if n <= limit else "wmma")
    qkv, att, datt, lse, mask, s = _attention_bwd_case(
        np.random.default_rng(54), 2, n, 2, dh, n - 3, dropout)
    got = _build.attention_bwd(qkv, att, datt, lse, 2, n - 3, s, mask=mask, keep=0.9)
    want = attention_bwd_ref(qkv, att, datt, lse, 2, n - 3, s, mask=mask, keep=0.9)
    if dropout:
        _within(got, want, 2e-2, "dqkv")
    else:
        torch.testing.assert_close(got.float(), want.float(), **ONE_ROUND_TOL)
    assert torch.equal(got, _build.attention_bwd(qkv, att, datt, lse, 2, n - 3, s, mask=mask,
                                                 keep=0.9))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh, n, dropout", [
    (96, 64, True), (96, 130, False), (32, 64, False), (48, 100, True), (160, 64, False),
    (96, 196, True),
])
def test_attention_never_writes_past_a_ragged_head(cuda, dtype, dh, n, dropout):
    """A ragged head (Dh not a multiple of 64) is read and written through
    boxes of 64 columns: the kernels' stores stop at Dh.  Each launch
    writes into a buffer filled with a sentinel and one row longer than
    its output (the last head's ragged box would reach into it): the
    output equals the wrapper's, and the sentinel past it is untouched,
    forward (out) and backward (dqkv, on the Hopper kernel and on
    attention_bwd.cu)."""
    rng = np.random.default_rng(71)
    b, heads = 3, 2
    qkv, att, datt, lse, mask, s = _attention_bwd_case(rng, b, n, heads, dh, n - 1, dropout)
    qkv, att, datt = qkv.to(dtype), att.to(dtype), datt.to(dtype)
    att, lse = _build.attention_fwd(qkv, heads, n - 1, s, with_lse=True, mask=mask, keep=0.9)
    mask_u8 = _build._mask_u8(mask)
    sentinel = 12345.0
    lib, stream = _build.library(), _build._stream()
    f32 = dtype == torch.float32

    def buffer(like):
        flat = torch.full((like.numel() + like.shape[-1],), sentinel, dtype=dtype, device=cuda)
        return flat, flat[:like.numel()].view_as(like)

    flat, out = buffer(att)
    fwd = lib.sfc_packed_attention_f32 if f32 else lib.sfc_packed_attention_bf16
    assert fwd(qkv.data_ptr(), out.data_ptr(), None, _build._ptr(mask_u8), b, n, heads, dh,
               n - 1, s, 0.9, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, _build.attention_fwd(qkv, heads, n - 1, s, mask=mask, keep=0.9))
    assert bool((flat[att.numel():] == sentinel).all())

    want = _build.attention_bwd(qkv, att, datt, lse, heads, n - 1, s, mask=mask, keep=0.9)
    delta = torch.empty((b, heads, n), dtype=torch.float32, device=cuda)
    args = (qkv.data_ptr(), att.data_ptr(), datt.data_ptr(), lse.data_ptr(),
            _build._ptr(mask_u8))
    tail = (b, n, heads, dh, n - 1, s, 0.9, stream)
    calls = ([lambda d: lib.sfc_attention_bwd_f32(*args, delta.data_ptr(), d, *tail)] if f32
             else [lambda d: lib.sfc_attention_bwd_bf16(*args, delta.data_ptr(), d, *tail)])
    if not f32 and _build.attention_bwd_route(dh, n, dropout) == "sm90":
        calls.append(lambda d: lib.sfc_attention_bwd_sm90_bf16(*args, d, *tail))
    for call in calls:
        flat, dqkv = buffer(qkv)
        assert call(dqkv.data_ptr()) == 0
        torch.cuda.synchronize()
        if f32 or len(calls) == 1 or call is calls[1]:
            assert torch.equal(dqkv, want)
        else:  # the WMMA kernel where the route picks the Hopper one
            _within(dqkv, want, 2e-2, "dqkv")
        assert bool((flat[qkv.numel():] == sentinel).all())


#: The F5 guard: the flagship at 6 and 8 heads (Dh 128, 96 at d 768) and
#: 'hier' at 2 (Dh 128 at d 256), which raised on the card before.
@pytest.mark.gpu
@pytest.mark.parametrize("model, heads", [("vit1d", 6), ("vit1d", 8), ("hier", 2)])
def test_head_dim_models_match_plain_path(cuda, model, heads):
    """A small flagship (or 'hier') at a head count that gives a head dim
    other than 64 and 192 on the card: served through #7 and trained one
    step through #5 and #6, each against the plain versions."""
    from unittest import mock

    import sfc_vit_tpu_torch.models.layers as layers
    import sfc_vit_tpu_torch.ops.attention as attention
    from sfc_vit_tpu_torch.ops.fused_torch_attention import torch_mha_train
    from sfc_vit_tpu_torch.registry import build_model, preset_config
    from sfc_vit_tpu_torch.serving import ServingEngine

    cfg = preset_config("flagship", model=model, img_size=16, depth=2, n_heads=heads,
                        dtype="bfloat16")
    net = build_model(cfg, generator=torch.Generator().manual_seed(0))
    x = _randn(np.random.default_rng(27), 6, 16, 16, 3)
    plain_packed = lambda qkv, heads, scale=None: _packed_xla_ref(  # noqa: E731
        qkv, heads, (qkv.shape[-1] // 3 // heads) ** -0.5)
    engine = ServingEngine(net, None, (16, 16, 3), batch_sizes=(8,), dtype=torch.bfloat16,
                           device=cuda)
    before = packed_flash_attention.launches
    got = engine.predict(x.float().cpu().numpy())
    assert packed_flash_attention.launches > before
    with torch.no_grad(), mock.patch.object(attention, "packed_flash_attention", plain_packed):
        want = net.eval()(x).float()
    # chip_smoke.py's logit gate: within 3 % of the largest |logit|
    err = float((torch.as_tensor(got).to(cuda) - want).abs().max())
    assert err <= 0.03 * float(want.abs().max()), err
    net.train()
    grads = []
    before = (fused_torch_mha.launches, fused_torch_mha.bwd_launches)
    for plain in (False, True):
        ctx = (mock.patch.object(layers, "fused_torch_mha", torch_mha_train) if plain
               else mock.patch.object(layers, "fused_torch_mha", fused_torch_mha))
        net.zero_grad()
        with ctx, layers.dropout_generator(torch.Generator(device=cuda).manual_seed(1)):
            net(x).float().sum().backward()
        grads.append([q.grad.float().clone() for q in net.parameters()])
    assert fused_torch_mha.launches > before[0] and fused_torch_mha.bwd_launches > before[1]
    for g, w in zip(*grads):
        assert float((g - w).norm() / w.norm()) <= 0.1


@pytest.mark.gpu
def test_gemm_and_attention_bwd_attrs_without_spills(cuda):
    """``flash_kernel_attrs`` lists the GEMM's nine instances (three
    layouts, three act kinds), its split-K sum, LayerNorm form (#15) and
    ``gemm_profile``'s instance, and the attention backward's seven
    instances (#4, #6; Dh 128's two among them) and the fp32 backward's by
    sub-heads, none with local memory (spills)."""
    attrs = _build.flash_kernel_attrs()
    names = ({f"gemm {f}" for f in _build.GEMM_FORMS}
             | set(_build.ATTENTION_BWD_SM90_FORMS)
             | {f for f in _build.F32_KERNEL_FORMS if f.startswith("attention_bwd_f32")})
    assert {"gemm NN LayerNorm", "gemm NN act", "gemm NN act profiled",
            "attention_bwd_sm90", "attention_bwd_sm90 dh128 dropout",
            "attention_bwd_f32 dkv dh256 masked"} <= names
    assert names <= set(attrs)
    for name in names:
        assert attrs[name]["local_bytes"] == 0, name
        assert 0 < attrs[name]["registers"] <= 255, name


def _ln_bwd_form(rng, form, rows, d):
    """Inputs and ``ln_rows_bwd`` keywords of form (a) x bf16, dxn fp32, +
    g and colsum(g) (#3, #4), (b) x bf16, dxn bf16, the fp32 dx and its
    column sums (#16's LN2) or (c) x + x_b, dxn fp32 (#16's LN1)."""
    x = _randn(rng, rows, d, scale=3.0) + 0.5
    s = _randn(rng, d, dtype=torch.float32)
    if form == "a":
        return (x, _randn(rng, rows, d, dtype=torch.float32), s, _randn(rng, rows, d),
                dict(g_sum=True))
    if form == "b":
        return x, _randn(rng, rows, d), s, None, dict(add_g=False, dx_f32=True, dx_sum=True)
    return (x, _randn(rng, rows, d, dtype=torch.float32), s, None,
            dict(add_g=False, x_b=_randn(rng, rows, d)))


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["a", "b", "c"])
@pytest.mark.parametrize("rows, d", [(1, 8), (200, 768), (50176, 768), (37, 3072),
                                     (1000, 256), (333, 384), (32768, 768), (513, 1024)])
def test_ln_rows_bwd_matches_plain(cuda, form, rows, d):
    rng = np.random.default_rng(13)
    x, dxn, s, g, kw = _ln_bwd_form(rng, form, rows, d)
    got = _build.ln_rows_bwd(x, dxn, s, g, 1e-5, **kw)
    xf = x.float() + (kw["x_b"].float() if "x_b" in kw else 0.0)
    want_dx, want_ds, want_db = ln_bwd_fp32(xf, dxn.float(), s)
    tol = dict(rtol=1e-4, atol=1e-4 * rows ** 0.5)
    dx, ds, db = got[:3]
    if form == "a":
        torch.testing.assert_close(dx.float(), (want_dx + g.float()).bfloat16().float(),
                                   **ONE_ROUND_TOL)
        torch.testing.assert_close(got[3], g.float().sum(0), **tol)
        dx_only = _build.ln_rows_bwd(x, dxn, s, g, 1e-5, add_g=False)[0]
        torch.testing.assert_close(dx_only.float(), want_dx.bfloat16().float(),
                                   **ONE_ROUND_TOL)
    else:
        torch.testing.assert_close(dx.float(), want_dx.bfloat16().float(), **ONE_ROUND_TOL)
    if form == "b":
        dx32, dxs = got[3:]
        torch.testing.assert_close(dx32, want_dx, rtol=1e-4, atol=1e-4)
        assert torch.equal(dx, dx32.bfloat16())
        torch.testing.assert_close(dxs, want_dx.sum(0), **tol)
    torch.testing.assert_close(ds, want_ds, **tol)
    torch.testing.assert_close(db, want_db, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["a", "b", "c"])
@pytest.mark.parametrize("rows, d", [(50176, 768), (32768, 256), (1001, 1024)])
def test_ln_rows_bwd_repeats_bit_for_bit(cuda, form, rows, d):
    """Every output, dscale, dbias, colsum(g) and colsum(dx) included, has
    the same bits on a second call: the column sums are taken per block and
    then over the blocks in block order, with no atomics."""
    rng = np.random.default_rng(15)
    x, dxn, s, g, kw = _ln_bwd_form(rng, form, rows, d)
    first = _build.ln_rows_bwd(x, dxn, s, g, 1e-5, **kw)
    second = _build.ln_rows_bwd(x, dxn, s, g, 1e-5, **kw)
    assert len(first) == {"a": 4, "b": 5, "c": 3}[form]
    for i, (u, v) in enumerate(zip(first, second)):
        assert torch.equal(u, v), i


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, heads, n_valid", [
    (2, 64, 2, 49), (3, 196, 2, 196), (2, 196, 12, 150), (1, 1, 1, 1),
    (1, 1024, 2, 1000),
])
def test_attention_lse_and_bwd_match_plain(cuda, b, n, heads, n_valid):
    rng = np.random.default_rng(14)
    s = 64 ** -0.5
    qkv = _randn(rng, b, n, 3 * heads * 64)
    assert _build.attention_fwd_route(64, n_valid, False) != "wmma"  # the packed kernel's lse
    out, lse = _build.attention_fwd(qkv, heads, n_valid, s, with_lse=True)
    assert torch.equal(out, _build.attention_fwd(qkv, heads, n_valid, s))
    att, want_lse = attention_fwd_ref(qkv, heads, n_valid, s)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    datt = _randn(rng, b, n, heads * 64)
    got = _build.attention_bwd(qkv, att, datt, want_lse, heads, n_valid, s)
    want = attention_bwd_ref(qkv, att, datt, want_lse, heads, n_valid, s)
    torch.testing.assert_close(got.float(), want.float(), **ONE_ROUND_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, d, f", [(2, 49, 128, 256), (4, 196, 768, 3072)])
def test_mlp_block_bwd_matches_ref(cuda, b, n, d, f):
    """Kernel backward against mlp_block_bwd_ref fed the same saved z,
    and the Function's gradients against the same."""
    args = _mlp_args(np.random.default_rng(15), b, n, d, f, cuda)
    g = _randn(np.random.default_rng(16), b, n, d)
    _, z = mlp_block_train_fwd(*args)
    got = mlp_block_bwd(args[0], g, *args[1:6], z, args[6])
    want = mlp_block_bwd_ref(args[0], g, *args[1:6], z, args[6])
    for name, a, w in zip(("dx", "dls", "dlb", "dw1", "db1", "dw2", "db2"), got, want):
        assert a.dtype == w.dtype, name
        torch.testing.assert_close(a.float(), w.float(), **BF16_TOL, msg=name)
    leaves = [t.clone().requires_grad_() for t in args]
    fused_mlp_block(*leaves).backward(g)
    for name, t, w in zip(("dx", "dls", "dlb", "dw1", "db1", "dw2", "db2"), leaves, want):
        torch.testing.assert_close(t.grad.float(), w.float(), **BF16_TOL, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, d, heads, n_actual", [
    (2, 64, 128, 2, 49), (2, 40, 128, 2, None), (4, 196, 768, 12, None),
    (4, 196, 768, 12, 150),
])
def test_attention_block_bwd_matches_ref(cuda, b, n, d, heads, n_actual):
    args = _attn_args(np.random.default_rng(17), b, n, d, heads, cuda)
    g = _randn(np.random.default_rng(18), b, n, d)
    _, qkv, att, lse = attention_block_train_fwd(*args, heads, n_actual=n_actual)
    got = attention_block_bwd(args[0], g, *args[1:], qkv, att, lse, heads,
                              n_actual=n_actual)
    want = attention_block_bwd_ref(args[0], g, *args[1:], qkv, att, lse, heads,
                                   n_actual=n_actual)
    names = ("dx", "dls", "dlb", "dw_qkv", "dw_out")
    for name, a, w in zip(names, got, want):
        assert a.dtype == w.dtype, name
        torch.testing.assert_close(a.float(), w.float(), **BF16_TOL, msg=name)
    if n_actual is not None:  # pad rows: g passes straight through
        torch.testing.assert_close(got[0][:, n_actual:], g[:, n_actual:],
                                   rtol=0, atol=0)
    leaves = [t.clone().requires_grad_() for t in args]
    fused_attention_block(*leaves, heads=heads, n_actual=n_actual).backward(g)
    for name, t, w in zip(names, leaves, want):
        torch.testing.assert_close(t.grad.float(), w.float(), **BF16_TOL, msg=name)


@pytest.mark.gpu
def test_fp32_cuda_input_raises(cuda):
    """An fp32 x beside bf16 weights is refused, not cast: the fp32 chain
    takes fp32 weights (tests of #1-#4 in fp32 below)."""
    args = _mlp_args(np.random.default_rng(7), 1, 4, 16, 32, cuda)
    with pytest.raises(ValueError, match="float32"):
        fused_mlp_block(args[0].float(), *args[1:])


@pytest.mark.gpu
def test_curvevit_kernel_path_matches_plain_path(cuda):
    from unittest import mock

    import sfc_vit_tpu_torch.models.simple_vit as simple_vit
    from sfc_vit_tpu_torch.models import CurveViT

    model = CurveViT(image_size=28, patch_size=4, num_classes=10, dim=128,
                     depth=2, heads=2, dim_head=64, mlp_dim=256, device=cuda,
                     generator=torch.Generator().manual_seed(0))
    model = model.to(torch.bfloat16).eval()
    x = _randn(np.random.default_rng(8), 5, 28, 28, 3)
    before = (fused_attention_block.launches, fused_mlp_block.launches)
    with torch.inference_mode():
        got = model(x)
        with mock.patch.multiple(simple_vit,
                                 fused_attention_block=attention_block_ref,
                                 fused_mlp_block=mlp_block_ref):
            want = model(x)
    assert (fused_attention_block.launches, fused_mlp_block.launches) == (
        before[0] + 2, before[1] + 2)
    assert got.shape == (5, 10) and torch.isfinite(got).all()
    # logits after two bf16 layers of each path
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2, atol=5e-2)


# -- family-A kernels (#5, #6, #7) on the card ---------------------------------

# The kernels and their plain versions round at the same points; sums in
# another order flip single roundings by one bf16 ulp.
def _mha_args(rng, b, n, d, heads, device, keep=0.9):
    return dict(
        x=_randn(rng, b, n, d, device=device),
        w_in=_randn(rng, d, 3 * d, scale=d ** -0.5, device=device),
        b_in=_randn(rng, 3 * d, scale=0.1, device=device),
        w_out=_randn(rng, d, d, scale=d ** -0.5, device=device),
        b_out=_randn(rng, d, scale=0.1, device=device),
        mask=torch.from_numpy(rng.random((b, heads, n, n)) < keep).to(device),
        g=_randn(rng, b, n, d, device=device))


_MHA_SHAPES = [(2, 24, 128, 2, 20), (8, 64, 768, 4, None), (4, 64, 768, 4, 50),
               (2, 130, 384, 2, 100)]


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, d, heads, n_actual", _MHA_SHAPES)
def test_torch_mha_fwd_matches_ref(cuda, b, n, d, heads, n_actual):
    a = _mha_args(np.random.default_rng(20), b, n, d, heads, cuda)
    args = [a[k] for k in ("x", "w_in", "b_in", "w_out", "b_out", "mask")]
    before = fused_torch_mha.launches
    got = torch_mha_train_fwd(*args, heads, keep=0.9, n_actual=n_actual)
    want = torch_mha_fwd_ref(*args, heads, keep=0.9, n_actual=n_actual, save_acts=True)
    assert fused_torch_mha.launches == before + 1
    for name, x, w in zip(("y", "qkv", "att"), got[:3], want[:3]):
        torch.testing.assert_close(x.float(), w.float(), **BF16_TOL, msg=name)
    torch.testing.assert_close(got[3], want[3], rtol=1e-3, atol=1e-3)
    with torch.no_grad():
        torch.testing.assert_close(fused_torch_mha(*args, heads, keep=0.9,
                                                   n_actual=n_actual),
                                   got[0], rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, d, heads, n_actual", _MHA_SHAPES)
def test_torch_mha_bwd_matches_ref(cuda, b, n, d, heads, n_actual):
    a = _mha_args(np.random.default_rng(21), b, n, d, heads, cuda)
    fwd = [a[k] for k in ("x", "w_in", "b_in", "w_out", "b_out", "mask")]
    _, qkv, att, lse = torch_mha_train_fwd(*fwd, heads, keep=0.9, n_actual=n_actual)
    saved = (a["x"], a["g"], a["w_in"], a["w_out"], a["mask"], qkv, att, lse)
    got = torch_mha_bwd(*saved, heads, keep=0.9, n_actual=n_actual)
    want = torch_mha_bwd_ref(*saved, heads, keep=0.9, n_actual=n_actual)
    for name, x, w in zip(("dx", "dw_in", "db_in", "dw_out", "db_out"), got, want):
        assert x.dtype == w.dtype, name
        scale = float(w.float().abs().max())
        assert float((x.float() - w.float()).abs().max()) <= 2e-2 * scale, name
    if n_actual is not None:
        assert not got[0][:, n_actual:].any()
    leaves = [t.clone().requires_grad_() for t in fwd[:5]]
    before = fused_torch_mha.bwd_launches
    fused_torch_mha(*leaves, a["mask"], heads, keep=0.9, n_actual=n_actual).backward(a["g"])
    assert fused_torch_mha.bwd_launches == before + 1
    for t, w in zip(leaves, want):
        assert t.grad.dtype == torch.bfloat16
        scale = float(w.float().abs().max())
        assert float((t.grad.float() - w.float()).abs().max()) <= 2e-2 * scale


def test_packed_attention_launcher_rejects_what_the_kernel_does_not_take():
    """#7's launcher: head dims that are multiples of 16 up to 256, N up to
    PACKED_MAX_N, n_valid in [1, N], and a CUDA tensor."""
    def qkv(n, dh, heads=2):
        return torch.zeros(1, n, 3 * heads * dh, dtype=torch.bfloat16)

    for dh in (192, 128, 96, 32):
        with pytest.raises(ValueError, match="CUDA tensor"):
            _build.attention_fwd(qkv(64, dh), 2, 64, 1.0)
    with pytest.raises(ValueError, match="a multiple of 16 up to 256"):
        _build.attention_fwd(qkv(64, 40), 2, 64, 1.0)
    with pytest.raises(ValueError, match="over the kernel's 1024 tokens"):
        _build.attention_fwd(qkv(_build.PACKED_MAX_N + 1, 64), 2, 64, 1.0)
    for n_valid in (0, 65):
        with pytest.raises(ValueError, match=r"n_valid=\d+ not in \[1, 64\]"):
            _build.attention_fwd(qkv(64, 64), 2, n_valid, 1.0)


def test_packed_flash_attention_on_the_cpu_runs_the_plain_version():
    """A CPU qkv takes ``_packed_xla_ref`` and launches nothing."""
    qkv = _randn(np.random.default_rng(24), 2, 70, 3 * 2 * 64, device="cpu")
    before = packed_flash_attention.launches
    with torch.no_grad():
        got = packed_flash_attention(qkv, 2)
    assert packed_flash_attention.launches == before
    torch.testing.assert_close(got, _packed_xla_ref(qkv, 2, 64 ** -0.5), rtol=0, atol=0)


#: (b, n, heads, dh): a short row, the flagship's eval shape at batch 16,
#: a ragged 200 (two passes, n not a multiple of 64), 'hier''s level and
#: fusion layers, the longest rows (two passes over 16 and 11 key tiles)
#: and more items than the persistent grid holds.
_PACKED_SHAPES = [(2, 24, 2, 64), (16, 64, 4, 192), (3, 200, 2, 192), (4, 64, 4, 64),
                  (2, 192, 4, 64), (2, 1024, 2, 64), (2, 700, 2, 192), (300, 64, 4, 192)]


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, heads, dh", _PACKED_SHAPES)
def test_packed_flash_attention_matches_plain(cuda, b, n, heads, dh):
    qkv = _randn(np.random.default_rng(22), b, n, 3 * heads * dh)
    before = packed_flash_attention.launches
    with torch.no_grad():
        got = packed_flash_attention(qkv, heads)
    assert packed_flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(), _packed_xla_ref(qkv, heads, dh ** -0.5).float(),
                               **ONE_ROUND_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("n, n_valid", [(64, 50), (300, 130)])
def test_packed_attention_masks_keys_past_n_valid(cuda, n, n_valid):
    """Keys at or past n_valid add nothing to the row sum: #7 equals the
    plain version on the first n_valid keys, in one pass and in two."""
    qkv = _randn(np.random.default_rng(25), 3, n, 3 * 2 * 192)
    got = _build.attention_fwd(qkv, 2, n_valid, 192 ** -0.5)
    q, k, v = qkv.view(3, n, 3, 2, 192).permute(2, 0, 3, 1, 4)
    logits = (q.float() @ k[:, :, :n_valid].float().transpose(-1, -2)) * 192 ** -0.5
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    want = (w @ v[:, :, :n_valid]).transpose(1, 2).reshape(3, n, 2 * 192)
    torch.testing.assert_close(got.float(), want.float(), **ONE_ROUND_TOL)


@pytest.mark.gpu
def test_packed_attention_repeats_bit_for_bit(cuda):
    """#7 gives the same bits on two calls: each output row is summed by
    the one item that owns it, with no atomics."""
    for n, dh in ((64, 192), (700, 64)):
        qkv = _randn(np.random.default_rng(26), 300, n, 3 * 4 * dh)
        first = _build.attention_fwd(qkv, 4, n, dh ** -0.5)
        assert torch.equal(_build.attention_fwd(qkv, 4, n, dh ** -0.5), first)


#: (rows, cols) of colsum: #6's db_out and db_in at the notebook's batch 32
#: (2,048 rows of 256 and 768), the flagship's batch 512 (32,768 of 768 and
#: 2,304), 'hier''s and the notebook's bf16 batch 512 (32,768 of 256), the
#: first pass's 1,000 x 2,304, and ragged rows 1, 150 and 2,049.
_COLSUM_SHAPES = [(2048, 256), (2048, 768), (32768, 768), (32768, 2304), (32768, 256),
                  (1000, 2304), (1, 768), (150, 256), (2049, 768)]


def _colsum_case(x, want):
    """colsum within 1e-4 / 1e-3 of ``want`` (fp32 sums in another order),
    equal bit for bit to kernel_utils.colsum_fixed_order under the same
    plan, and the same bits on a second call; the wrapper counts each
    call."""
    from sfc_vit_tpu_torch.ops.kernel_utils import colsum_fixed_order

    rows, cols = x.shape
    before = _build.colsum.launches
    got = _build.colsum(x)
    assert _build.colsum.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    plan = _build.colsum_plan(rows, cols, _build._sm_count(x.device))
    twin = colsum_fixed_order(x, plan)
    assert torch.equal(got.view(torch.int32), twin.view(torch.int32)), plan
    assert torch.equal(_build.colsum(x).view(torch.int32), got.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("rows, cols", _COLSUM_SHAPES)
def test_colsum_matches_sum(cuda, rows, cols):
    x = _randn(np.random.default_rng(23), rows, cols)
    _colsum_case(x, x.float().sum(0))


# -- the fp32 forms of #5, #6, #7 and #14 ----------------------------------------
#
# Each fp32 kernel against its plain version in fp32 (torch.matmul in full
# fp32: the ``cuda`` fixture clears the TF32 flags, which are off by
# default for matmul): the same arithmetic summed in another order, so
# every error is held within F32_TOL of its tensor's largest |value|.
F32_TOL = 1e-4


def _f32(rng, *shape, scale=1.0, device="cuda"):
    return _randn(rng, *shape, scale=scale, device=device, dtype=torch.float32)


#: (form, rows, k, n): the notebook's projections and weight gradients (x
#: [32 x 64, 256], the packed 768), the flagship's fp32 ones ([512 x 64,
#: 768], 2304), ragged edges and a deep split TN.
_GEMM_F32_SHAPES = [("NN", 2048, 256, 768), ("NN", 2048, 256, 256), ("NT", 2048, 256, 256),
                    ("NT", 2048, 768, 256), ("TN", 2048, 256, 768), ("TN", 2048, 256, 256),
                    ("NN", 32768, 768, 2304), ("NT", 32768, 2304, 768),
                    ("TN", 32768, 768, 2304), ("NN", 333, 200, 136), ("NT", 7, 13, 9),
                    ("TN", 5001, 72, 40)]


@pytest.mark.gpu
@pytest.mark.parametrize("form, rows, k, n", _GEMM_F32_SHAPES)
def test_gemm_f32_matches_matmul(cuda, form, rows, k, n):
    """csrc/gemm_f32.cu in its three layouts against torch.matmul in fp32,
    with the fp32 bias of the projections; split over K or not, it gives
    the same bits twice."""
    rng = np.random.default_rng(60)
    if form == "TN":  # a stored [K=rows, M=k], b [rows, n]: a weight gradient
        a, b = _f32(rng, rows, k), _f32(rng, rows, n)
        fn, want = lambda: _build.gemm_f32(a, b, trans_a=True), a.T @ b
    elif form == "NT":  # b stored [N, K]
        a, b = _f32(rng, rows, k), _f32(rng, n, k, scale=k ** -0.5)
        fn, want = lambda: _build.gemm_f32(a, b, trans_b=True), a @ b.T
    else:
        a, b, bias = _f32(rng, rows, k), _f32(rng, k, n, scale=k ** -0.5), _f32(rng, n)
        fn, want = lambda: _build.gemm_f32(a, b, bias=bias), a @ b + bias
    got = fn()
    _within(got, want, F32_TOL, form)
    assert torch.equal(fn(), got)


@pytest.mark.gpu
@pytest.mark.parametrize("rows, cols", _COLSUM_SHAPES)
def test_colsum_f32_matches_sum(cuda, rows, cols):
    x = _f32(np.random.default_rng(61), rows, cols)
    _within(_build.colsum(x), x.sum(0), F32_TOL)
    _colsum_case(x, x.sum(0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, n, d, heads", [(32, 64, 256, 4), (512, 64, 768, 4)])
def test_torch_mha_bwd_repeats_bit_for_bit(cuda, b, n, d, heads, dtype):
    """#6's chain (colsum, the GEMMs' split-K sums, the attention backward)
    gives the same five gradients bit for bit on a second call, at the
    notebook's and the flagship's shapes, in fp32 and bf16: every sum has
    one owner and a fixed order."""
    a = _mha_args(np.random.default_rng(66), b, n, d, heads, cuda)
    a = {k: v.to(dtype) if v.dtype == torch.bfloat16 else v for k, v in a.items()}
    fwd = [a[k] for k in ("x", "w_in", "b_in", "w_out", "b_out", "mask")]
    _, qkv, att, lse = torch_mha_train_fwd(*fwd, heads, keep=0.9)
    saved = (a["x"], a["g"], a["w_in"], a["w_out"], a["mask"], qkv, att, lse)
    first = torch_mha_bwd(*saved, heads, keep=0.9)
    second = torch_mha_bwd(*saved, heads, keep=0.9)
    for name, x, y in zip(("dx", "dw_in", "db_in", "dw_out", "db_out"), first, second):
        assert x.dtype == y.dtype and torch.equal(x, y), name


#: (b, n, heads, dh, n_valid): the notebook's layer ([32, 64], 4 heads of
#: 64), the flagship's fp32 layer (4 heads of 192), 'hier''s fusion
#: length, ragged rows and key limits, the longest rows, 1,024 tokens
#: (the 1-D tokenizer at patch 1), ViT-B's 196 tokens (one pass over 200
#: key columns), a ragged row just past the one-pass width (two passes),
#: and the head dims past 64 and 192 (32, 48, 96, 128, 256) on both sides
#: of their one-pass limits, Dh 32 at one tile without the dk/dv handoff.
_ATTN_F32_SHAPES = [(32, 64, 4, 64, 64), (64, 64, 4, 192, 64), (4, 64, 4, 192, 50),
                    (2, 192, 4, 64, 192), (3, 200, 2, 192, 130), (2, 1024, 2, 64, 1024),
                    (1, 1024, 2, 192, 1000), (2, 24, 2, 64, 20), (4, 196, 12, 64, 196),
                    (2, 300, 2, 64, 257), (32, 64, 8, 32, 64), (3, 200, 2, 48, 196),
                    (2, 192, 2, 96, 192), (2, 208, 2, 96, 196), (16, 64, 6, 128, 64),
                    (2, 193, 2, 128, 193), (8, 64, 3, 256, 64), (2, 130, 2, 256, 100),
                    (2, 40, 2, 32, 33)]


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b, n, heads, dh, n_valid", _ATTN_F32_SHAPES)
def test_attention_f32_matches_plain(cuda, b, n, heads, dh, n_valid, masked):
    """csrc/packed_attn_f32.cu (out and lse) against attention_fwd_ref, with
    and without #5's mask, and csrc/attention_bwd_f32.cu against
    attention_bwd_ref with the mask (#6's) and without it (#4's), fp32; the
    backward repeats bit for bit."""
    rng = np.random.default_rng(62)
    qkv = _f32(rng, b, n, 3 * heads * dh)
    datt = _f32(rng, b, n, heads * dh)
    mask = torch.from_numpy(rng.random((b, heads, n, n)) < 0.9).to(cuda) if masked else None
    keep = 0.9 if masked else 1.0
    s = dh ** -0.5
    att, lse = _build.attention_fwd(qkv, heads, n_valid, s, with_lse=True, mask=mask,
                                    keep=keep)
    want, want_lse = attention_fwd_ref(qkv, heads, n_valid, s, mask=mask, keep=keep)
    _within(att, want, F32_TOL, "att")
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    if not masked and n_valid == n:
        _within(_build.attention_fwd(qkv, heads, n, s), _packed_xla_ref(qkv, heads, s),
                F32_TOL, "packed")
    dqkv = _build.attention_bwd(qkv, att, datt, lse, heads, n_valid, s, mask=mask, keep=keep)
    want_d = attention_bwd_ref(qkv, att, datt, lse, heads, n_valid, s, mask=mask, keep=keep)
    for i, name in enumerate(("dq", "dk", "dv")):
        part = lambda t: t.view(b, n, 3, heads * dh)[:, :, i]  # noqa: E731
        _within(part(dqkv), part(want_d), F32_TOL, name)
    assert torch.equal(_build.attention_bwd(qkv, att, datt, lse, heads, n_valid, s,
                                            mask=mask, keep=keep), dqkv)


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dh, n, n_valid", [(64, 130, 60), (64, 256, 196), (192, 70, 50),
                                         (32, 256, 196), (96, 130, 60), (128, 192, 130),
                                         (256, 70, 50)])
def test_attention_f32_forms_match_plain(cuda, dh, n, n_valid, masked):
    """Every instance of csrc/packed_attn_f32.cu that covers n_valid (one
    pass over each width of key columns, and two passes), forced by
    _build.attention_fwd_f32_form, against attention_fwd_ref (out and lse)
    with and without #5's mask: the forms compute the same formula."""
    rng = np.random.default_rng(66)
    b, heads = 2, 2
    qkv = _f32(rng, b, n, 3 * heads * dh)
    mask = torch.from_numpy(rng.random((b, heads, n, n)) < 0.9).to(cuda) if masked else None
    keep = 0.9 if masked else 1.0
    s = dh ** -0.5
    want, want_lse = attention_fwd_ref(qkv, heads, n_valid, s, mask=mask, keep=keep)
    table = (_build.PACKED_ATTENTION_F32_MASKED_FORMS if masked
             else _build.PACKED_ATTENTION_F32_FORMS)
    forms = [nk for d, nk in table.values()
             if d == 64 * _build.attention_subheads(dh) and (nk == 0 or nk >= n_valid)]
    assert _build.attention_fwd_f32_columns(dh, n_valid, masked) in forms and 0 in forms
    for nk in forms:
        att, lse = _build.attention_fwd_f32_form(qkv, heads, n_valid, s, nk, with_lse=True,
                                                 mask=mask, keep=keep)
        _within(att, want, F32_TOL, f"att, {nk} columns")
        torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_attention_f32_runs_on_the_tensor_core_kernels(cuda):
    """The fp32 attention forward and backward, masked and not, at Dh 64
    and 192, one pass and two, launch csrc/packed_attn_f32.cu's and
    csrc/attention_bwd_f32.cu's wgmma kernels (the profiler's kernel names)
    and never the SIMT kernels they replaced."""
    rng = np.random.default_rng(67)
    calls = []
    for b, n, heads, dh, n_valid in ((2, 196, 2, 64, 196), (2, 300, 2, 64, 300),
                                     (4, 64, 2, 192, 64), (2, 130, 2, 192, 100)):
        qkv, datt = _f32(rng, b, n, 3 * heads * dh), _f32(rng, b, n, heads * dh)
        for masked in (False, True):
            mask = (torch.from_numpy(rng.random((b, heads, n, n)) < 0.9).to(cuda)
                    if masked else None)
            keep = 0.9 if masked else 1.0
            s = dh ** -0.5
            att, lse = _build.attention_fwd(qkv, heads, n_valid, s, with_lse=True, mask=mask,
                                            keep=keep)
            calls.append(lambda qkv=qkv, mask=mask, keep=keep, h=heads, nv=n_valid, s=s:
                         _build.attention_fwd(qkv, h, nv, s, with_lse=True, mask=mask, keep=keep))
            calls.append(lambda qkv=qkv, att=att, datt=datt, lse=lse, mask=mask, keep=keep,
                         h=heads, nv=n_valid, s=s:
                         _build.attention_bwd(qkv, att, datt, lse, h, nv, s, mask=mask,
                                              keep=keep))
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    for new in ("packed_attn_f32_sm90", "attention_bwd_f32_dq_sm90",
                "attention_bwd_f32_dkv_sm90"):
        assert any(new in nm for nm in names), (new, names)
    for old in ("packed_attn_f32_kernel", "attention_bwd_f32_dq_kernel",
                "attention_bwd_f32_dkv_kernel"):
        assert not any(old in nm for nm in names), (old, names)


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, d, heads, n_actual", [(32, 64, 256, 4, None),
                                                      (16, 64, 768, 4, None),
                                                      (4, 64, 768, 4, 50),
                                                      (2, 130, 384, 2, 100)])
def test_torch_mha_f32_matches_ref(cuda, b, n, d, heads, n_actual):
    """#5 and #6 in fp32 (the notebook's and the flagship's layers) against
    their plain versions, each through its own launch counter."""
    a = _mha_args(np.random.default_rng(63), b, n, d, heads, cuda)
    a = {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in a.items()}
    fwd = [a[k] for k in ("x", "w_in", "b_in", "w_out", "b_out", "mask")]
    before = (fused_torch_mha.f32_launches, fused_torch_mha.f32_bwd_launches,
              fused_torch_mha.launches)
    got = torch_mha_train_fwd(*fwd, heads, keep=0.9, n_actual=n_actual)
    want = torch_mha_fwd_ref(*fwd, heads, keep=0.9, n_actual=n_actual, save_acts=True)
    for name, x, w in zip(("y", "qkv", "att", "lse"), got, want):
        _within(x, w, F32_TOL, name)
    saved = (a["x"], a["g"], a["w_in"], a["w_out"], a["mask"], *got[1:])
    g_k = torch_mha_bwd(*saved, heads, keep=0.9, n_actual=n_actual)
    g_p = torch_mha_bwd_ref(*saved, heads, keep=0.9, n_actual=n_actual)
    for name, x, w in zip(("dx", "dw_in", "db_in", "dw_out", "db_out"), g_k, g_p):
        _within(x, w, F32_TOL, name)
    assert (fused_torch_mha.f32_launches, fused_torch_mha.f32_bwd_launches,
            fused_torch_mha.launches) == (before[0] + 1, before[1] + 1, before[2])


@pytest.mark.gpu
def test_family_a_kernels_refuse_fp16(cuda):
    """#5/#6, #7 and #14 take bfloat16 and float32; float16 raises, with no
    fall back to a plain version."""
    from sfc_vit_tpu_torch.ops import gather_project as gp

    a = _mha_args(np.random.default_rng(24), 1, 8, 128, 2, cuda)
    args = [a[k].half() for k in ("x", "w_in", "b_in", "w_out", "b_out")]
    with pytest.raises(NotImplementedError, match="bfloat16 or float32"):
        fused_torch_mha(*args, a["mask"], 2, keep=0.9)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="bfloat16 or float32"):
        packed_flash_attention(torch.zeros(1, 8, 3 * 128, device=cuda, dtype=torch.half), 2)
    lut = torch.arange(8, dtype=torch.int32, device=cuda)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="bfloat16 or float32"):
        gp.gather_project(torch.zeros(1, 8, 3, device=cuda, dtype=torch.half), lut,
                          torch.zeros(3, 16, device=cuda, dtype=torch.half))


#: (b, n, k, group, d): the notebook's 2-D tokenizer (64 patches of 4 x 4 x
#: 3, group 1), the 1-D tokenizer at patch 4 (1,024 pixels of 3 in groups of
#: 4) and patch 1, the flagship's three levels at batch 512, and ragged
#: widths (d not a multiple of 4 or of 128, features not of 32).
_GP_F32_SHAPES = [(32, 64, 48, 1, 256), (32, 1024, 3, 4, 256), (4, 1024, 3, 1, 256),
                  (512, 1024, 3, 16, 256), (512, 256, 12, 4, 256), (512, 64, 48, 1, 256),
                  (3, 50, 5, 3, 301), (2, 70, 13, 5, 130), (2, 4096, 3, 4, 256),
                  (2, 1024, 12, 4, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, k, group, d", _GP_F32_SHAPES)
def test_gather_project_f32_matches_plain(cuda, b, n, k, group, d):
    """csrc/gather_project_f32.cu (3xTF32 on the tensor cores) against
    gather_project_ref in fp32, with a bias and without, through its own
    launch counter; against the fp64 product within 2^-16 of |A| @ |W| +
    |bias| (the split's 1.25 x 2^-20 and the card's fp32 sum of three
    terms a feature, 144 at the main path's 48 features: the probe's
    bound for 96 terms is 2^-17); the same bits on a second call.  The
    last two shapes' images (48 KB) are over the shared buffer: the
    instances that gather from global memory, with chunks of 2 and of 6
    k8 steps."""
    from sfc_vit_tpu_torch.ops import gather_project as gp

    rng = np.random.default_rng(64)
    x = _f32(rng, b, n, k)
    lut = torch.from_numpy(rng.permutation(n)[:n // group * group].astype(np.int32)).to(cuda)
    w = _f32(rng, group * k, d, scale=(group * k) ** -0.5)
    bias = _f32(rng, d)
    before = (gp.gather_project.f32_launches, gp.gather_project.launches)
    a = x[:, lut.long()].reshape(b, -1, group * k).double()
    with torch.no_grad():
        for bvec in (bias, None):
            got = gp.gather_project(x, lut, w, bvec, group)
            _within(got, gp.gather_project_ref(x, lut, w, bvec, group), F32_TOL)
            exact, mag = a @ w.double(), a.abs() @ w.double().abs()
            if bvec is not None:
                exact, mag = exact + bvec.double(), mag + bvec.double().abs()
            assert bool(((got.double() - exact).abs() <= 2.0 ** -16 * mag).all())
            assert torch.equal(gp.gather_project(x, lut, w, bvec, group), got)
    assert (gp.gather_project.f32_launches, gp.gather_project.launches) == (
        before[0] + 4, before[1])


@pytest.mark.gpu
def test_gather_project_f32_and_colsum_run_on_the_redesigned_kernels(cuda):
    """#14 in fp32 (both item widths, shared and global x) launches
    csrc/gather_project_f32.cu's wgmma kernel and colsum its fixed-order
    kernels (the profiler's kernel names), never the first-pass kernels
    they replaced (the SIMT gather_project_f32_kernel, the atomic
    colsum_kernel)."""
    from sfc_vit_tpu_torch.ops import gather_project as gp

    rng = np.random.default_rng(68)
    calls = []
    for b, n, k, group in ((32, 64, 48, 1), (512, 64, 48, 1), (2, 4096, 3, 4)):
        x = _f32(rng, b, n, k)
        lut = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
        w = _f32(rng, group * k, 256)
        calls.append(lambda x=x, lut=lut, w=w, g=group: gp.gather_project(x, lut, w, None, g))
    for x in (_f32(rng, 2048, 768), _randn(rng, 32768, 768)):
        calls.append(lambda x=x: _build.colsum(x))
    torch.cuda.synchronize()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    for new in ("gather_project_f32_sm90", "colsum_partial_kernel", "slice_sum_kernel"):
        assert any(new in nm for nm in names), (new, names)
    for old in ("gather_project_f32_kernel", "colsum_kernel"):
        assert not any(old in nm for nm in names), (old, names)


@pytest.mark.gpu
@pytest.mark.parametrize("tokenizer, fused", [("2d", False), ("2d", True), ("1d", True)])
def test_notebook_kernel_path_matches_plain_path(cuda, tokenizer, fused):
    """A small notebook VisionTransformer in fp32 on the card: eval through
    #7's fp32 form (and #14's, fused), training through #5/#6's, each
    against the plain versions."""
    from unittest import mock

    import sfc_vit_tpu_torch.models.layers as layers
    import sfc_vit_tpu_torch.ops.attention as attention
    from sfc_vit_tpu_torch.ops import gather_project as gp
    from sfc_vit_tpu_torch.ops.fused_torch_attention import torch_mha_train
    from sfc_vit_tpu_torch.registry import build_model, preset_config

    cfg = preset_config("notebook", depth=2, tokenizer=tokenizer, fused=fused)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    x = _f32(np.random.default_rng(65), 6, 32, 32, 3)
    plain_packed = lambda qkv, heads, scale=None: _packed_xla_ref(  # noqa: E731
        qkv, heads, (qkv.shape[-1] // 3 // heads) ** -0.5)
    before = (packed_flash_attention.f32_launches, gp.gather_project.f32_launches)
    with torch.no_grad():
        got = model.eval()(x)
        with mock.patch.object(attention, "packed_flash_attention", plain_packed), \
                mock.patch.object(gp, "_launch", lambda x, lut, w, b, group:
                                  gp.gather_project_ref(x, lut, w, b, group)):
            want = model(x)
    assert (packed_flash_attention.f32_launches, gp.gather_project.f32_launches) == (
        before[0] + cfg.depth, before[1] + int(fused))
    _within(got, want, F32_TOL, "logits")
    model.train()
    grads = []
    for plain in (False, True):
        ctx = mock.patch.object(layers, "fused_torch_mha",
                                torch_mha_train if plain else fused_torch_mha)
        model.zero_grad()
        with ctx, layers.dropout_generator(torch.Generator(device=cuda).manual_seed(1)):
            model(x).sum().backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for g, w in zip(*grads):
        assert float((g - w).norm() / w.norm()) <= 1e-4


@pytest.mark.gpu
def test_flagship_kernel_path_matches_plain_path(cuda):
    """A small flagship on the card: eval through #7, training through #5
    and #6, each against the plain versions."""
    from unittest import mock

    import sfc_vit_tpu_torch.models.layers as layers
    import sfc_vit_tpu_torch.ops.attention as attention
    from sfc_vit_tpu_torch.ops.fused_torch_attention import torch_mha_train
    from sfc_vit_tpu_torch.registry import build_model, preset_config

    cfg = preset_config("flagship", img_size=16, depth=2, dtype="bfloat16")
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    x = _randn(np.random.default_rng(25), 6, 16, 16, 3)
    plain_packed = lambda qkv, heads, scale=None: _packed_xla_ref(  # noqa: E731
        qkv, heads, (qkv.shape[-1] // 3 // heads) ** -0.5)
    before = packed_flash_attention.launches
    with torch.no_grad():
        got = model.eval()(x)
        with mock.patch.object(attention, "packed_flash_attention", plain_packed):
            want = model(x)
    assert packed_flash_attention.launches == before + cfg.depth
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2, atol=5e-2)
    model.train()
    grads = []
    for plain in (False, True):
        ctx = (mock.patch.object(layers, "fused_torch_mha", torch_mha_train) if plain
               else mock.patch.object(layers, "fused_torch_mha", fused_torch_mha))
        model.zero_grad()
        with ctx, layers.dropout_generator(torch.Generator(device=cuda).manual_seed(1)):
            model(x).float().sum().backward()
        grads.append([p.grad.float().clone() for p in model.parameters()])
    for g, w in zip(*grads):
        assert float((g - w).norm() / w.norm()) <= 0.1


# -- flash attention (#8-#11) on the card --------------------------------------


def _flash_qkv(rng, b, nq, nk, heads, device, packed=False):
    """q [B, Nq, H, 64], k, v [B, Nk, H, 64] and g; with ``packed`` q, k, v
    are strided views of one packed projection (Nq = Nk)."""
    if packed:
        qkv = _randn(rng, b, nq, 3 * heads * 64, device=device)
        q, k, v = qkv.view(b, nq, 3, heads, 64).unbind(2)
    else:
        q = _randn(rng, b, nq, heads, 64, device=device)
        k = _randn(rng, b, nk, heads, 64, device=device)
        v = _randn(rng, b, nk, heads, 64, device=device)
    return q, k, v, _randn(rng, b, nq, heads, 64, device=device)


def _lse64(q, k, scale):
    """The fp64 log-sum-exp of each query's scaled logits, [B, H, Nq]."""
    qd, kd = q.double().transpose(1, 2), k.double().transpose(1, 2)
    return torch.logsumexp((qd @ kd.transpose(-1, -2)) * scale, dim=-1)


def _within(got, want, frac, name=""):
    """max |got - want| within ``frac`` of the largest |want|."""
    assert got.dtype == want.dtype, name
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= frac * scale, f"{name}: max abs err {err} > {frac} x {scale}"


# Ragged lengths that differ (nq, nk not multiples of 128), views of a
# packed projection, and one wave: batch x heads x tiles under the 132 SMs
# with 32 key tiles and 64 query tiles a block.  The edges of #10's and
# #11's tiles: nk not a multiple of 64 with nq a multiple of 128 (#11's
# last block holds a warpgroup of keys all past nk), nq not a multiple of
# 64, and several (b, h) with an odd nq (#9's and #11's lse / delta boxes
# round their start down to 16 bytes and read past nq into the next (b, h)).
_FLASH_SHAPES = [(2, 300, 300, 3, False), (1, 200, 333, 2, False),
                 (2, 1000, 777, 2, False), (2, 520, 520, 3, True),
                 (1, 1100, 1300, 3, False), (2, 1300, 1300, 3, True),
                 (1, 4096, 4096, 1, True), (1, 256, 300, 2, False),
                 (1, 330, 256, 2, False), (2, 333, 520, 3, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("streaming", [True, False])
@pytest.mark.parametrize("b, nq, nk, heads, packed", _FLASH_SHAPES)
def test_flash_fwd_matches_plain(cuda, streaming, b, nq, nk, heads, packed):
    """#8 in both forms, against its plain version at the kernel's key
    tile (streaming, ``_build.FLASH_STREAM_BLOCK_K``) or one step; the lse
    against fp64."""
    from sfc_vit_tpu_torch.ops import flash_attention as fa

    q, k, v, _ = _flash_qkv(np.random.default_rng(30), b, nq, nk, heads, cuda, packed)
    s = 64 ** -0.5
    out, lse = _build.flash_fwd(q, k, v, s, streaming=streaming, with_lse=True)
    want = fa.flash_fwd_ref(q, k, v, s,
                            block_k=_build.FLASH_STREAM_BLOCK_K if streaming else nk)
    torch.testing.assert_close(out.float(), want.float(), **ONE_ROUND_TOL)
    torch.testing.assert_close(lse.double(), _lse64(q, k, s), rtol=1e-5, atol=1e-5)
    assert torch.equal(_build.flash_fwd(q, k, v, s, streaming=streaming), out)


def test_wgmma_probe_rejects_what_it_does_not_take():
    a = torch.zeros(64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="form"):
        _build.wgmma_probe(a, a, "rr")
    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.wgmma_probe(a, a, "ss")


@pytest.mark.gpu
@pytest.mark.parametrize("form", _build.WGMMA_FORMS)
def test_wgmma_probe_matches_matmul(cuda, form):
    """One m64n64 wgmma over a depth of 64 in each operand form #8 and #9
    use (both operands K-major from swizzled shared memory, A from
    registers, B and A through the transpose bit) against the fp32 product
    of the same bf16 matrices: bf16 products are exact in fp32, so only
    the summation order differs."""
    rng = np.random.default_rng(40)
    a = _randn(rng, 64, 64, device=cuda)  # A [M, K]
    b = _randn(rng, 64, 64, device=cuda)  # B [K, N]
    a_stored = a.t().contiguous() if form == "ss_trans_ab" else a
    b_stored = b if form.endswith(("trans_b", "trans_ab")) else b.t().contiguous()
    got = _build.wgmma_probe(a_stored, b_stored, form)
    torch.testing.assert_close(got, a.float() @ b.float(), rtol=1e-5, atol=1e-3)


def test_wgmma_probe_tf32_rejects_what_it_does_not_take():
    a = torch.zeros(64, 32)
    with pytest.raises(ValueError, match="form"):
        _build.wgmma_probe_tf32(a, a, "rr")
    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.wgmma_probe_tf32(a, a, "rs")
    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.tf32_round(a)


def test_attention_fwd_f32_columns():
    """The fp32 forward's one-pass widths: the narrowest instance that
    covers n_valid (200 for ViT-B's 196), two passes (0) past 256 keys at
    Dh 64 (192 with the mask) and past 64 at Dh 192; each an instance of
    PACKED_ATTENTION_F32_FORMS (or its masked table), which the forced form
    refuses to run short."""
    want = {(64, 1): 64, (64, 64): 64, (64, 65): 128, (64, 192): 192, (64, 196): 200,
            (64, 200): 200, (64, 201): 256, (64, 256): 256, (64, 257): 0, (64, 1024): 0,
            (192, 50): 64, (192, 64): 64, (192, 65): 0, (32, 196): 200, (48, 256): 256,
            (96, 192): 192, (128, 130): 192, (128, 193): 0, (256, 64): 64, (256, 65): 0}
    for (dh, n_valid), nk in want.items():
        assert _build.attention_fwd_f32_columns(dh, n_valid) == nk, (dh, n_valid)
        c = _build.attention_subheads(dh)
        assert (64 * c, nk) in _build.PACKED_ATTENTION_F32_FORMS.values()
    # with the mask: one pass to 192 keys at Dh 64, 128 at Dh 80 to 128
    for (dh, n_valid), nk in {(64, 192): 192, (64, 196): 0, (64, 100): 128, (192, 64): 64,
                              (192, 65): 0, (96, 128): 128, (128, 129): 0,
                              (32, 192): 192}.items():
        assert _build.attention_fwd_f32_columns(dh, n_valid, masked=True) == nk, (dh, n_valid)
        c = _build.attention_subheads(dh)
        assert (64 * c, nk) in _build.PACKED_ATTENTION_F32_MASKED_FORMS.values()
    qkv = torch.zeros(1, 100, 3 * 64)
    with pytest.raises(ValueError, match="no instance"):
        _build.attention_fwd_f32_form(qkv, 1, 100, 0.125, 64)


#: fp32 values at the edges of TF32's rounding (ties, a carry into the next
#: binade and past the largest finite value, subnormals, zeros, inf, NaN).
_TF32_EDGES = [1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 1 + 2 ** -11 - 2 ** -23,
               2 - 2 ** -23, 3.4028234663852886e38, 2 ** -149, 0x1000 * 2 ** -149,
               0x7FFFFF * 2 ** -149, 2 ** -126, 0.0, -0.0, float("inf"), float("-inf"),
               float("nan")]


@pytest.mark.gpu
def test_tf32_round_matches_plain_bit_for_bit(cuda):
    """The device's cvt.rna.tf32.f32 against kernel_utils.tf32_round, its
    plain twin, bit for bit on the edge values and on 2^20 random bit
    patterns (every binade, NaNs and their payloads included); and
    csrc/gemm_f32.cu's split (sm90.cuh::tf32_split: big by two integer
    operations, small = x - big) against kernel_utils.tf32_split bit for
    bit on every finite one of them, NaN in, NaN small out."""
    from sfc_vit_tpu_torch.ops.kernel_utils import tf32_round, tf32_split
    rng = np.random.default_rng(41)
    bits = rng.integers(0, 2 ** 32, size=2 ** 20, dtype=np.uint64).astype(np.uint32)
    x = torch.cat([torch.tensor(_TF32_EDGES, dtype=torch.float32),
                   torch.from_numpy(bits.view(np.float32))])
    got = _build.tf32_round(x.to(cuda)).cpu()
    assert torch.equal(got.view(torch.int32), tf32_round(x).view(torch.int32))
    big, small = (t.cpu() for t in _build.tf32_split(x.to(cuda)))
    fin = torch.isfinite(x)
    for g, w in zip((big, small), tf32_split(x[fin])):
        assert torch.equal(g[fin].view(torch.int32), w.view(torch.int32))
    assert bool(torch.isnan(small[torch.isnan(x)]).all())


def _probe_operands(rng, cuda, exact: bool, k: int = 32):
    """a [64, k] and b [64, k] fp32 (b as stored, [N, K]; for k 64, the
    permuted form's, [K, N]); exact: rounded to TF32 first, so any product
    of them is exact in fp32."""
    from sfc_vit_tpu_torch.ops.kernel_utils import tf32_round
    a, b = (torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32)) for _ in "ab")
    if exact:
        a, b = tf32_round(a), tf32_round(b)
    return a.to(cuda), b.to(cuda)


def _probe_product(a, b, form):
    """The probe form's product in fp64 (b as the form stores it)."""
    return a.double() @ (b.double() if form == "rs_perm_split" else b.double().T)


@pytest.mark.gpu
@pytest.mark.parametrize("form", _build.WGMMA_TF32_FORMS)
def test_wgmma_probe_tf32_matches_matmul(cuda, form):
    """One m64n64 TF32 wgmma product in each operand form (A from
    registers or K-major shared memory, B K-major by TMA, over a depth of
    32; the 3xTF32 split of both; the fp32 attention's P V over a depth of
    64, A taken from an accumulator under the key permutation and B
    written transposed) against fp64, on operands already TF32: every
    product is exact, only the fp32 sum of K (the split: 3 K) terms errs."""
    k = 64 if form == "rs_perm_split" else 32
    a, b = _probe_operands(np.random.default_rng(42), cuda, exact=True, k=k)
    got = _build.wgmma_probe_tf32(a, b, form)
    want = _probe_product(a, b, form)
    mag = _probe_product(a.abs(), b.abs(), form)
    bound = 3 * k * 2 ** -24 * mag
    assert bool(((got.double() - want).abs() <= bound).all())


@pytest.mark.gpu
def test_wgmma_probe_tf32_takes_the_top_19_bits(cuda):
    """What the tensor cores take of an unrounded fp32 operand: its top 19
    bits (sign, exponent, 10 mantissa bits), the 13 below dropped, not
    rounded: kernel_utils.tf32_trunc.  So csrc/gemm_f32.cu rounds each
    operand's big part to nearest itself and leaves the small part, whose
    truncation costs 2^-21 of |x|, to them.  Relative to |a| @ |b|: the
    truncated operands' products, exact in fp32, summed in fp32 (at most
    32 x 2^-24 = 2^-19); rounding to nearest instead moves a sum by ~2^-14;
    the 3xTF32 split of the same operands lands within 2^-17 of the fp64
    product (its 1.25 x 2^-20 and the fp32 sum of 96 terms)."""
    from sfc_vit_tpu_torch.ops.kernel_utils import tf32_round, tf32_trunc as trunc
    a, b = _probe_operands(np.random.default_rng(43), cuda, exact=False)
    exact = a.double() @ b.double().T
    mag = a.double().abs() @ b.double().abs().T
    for form in ("rs", "ss"):
        got = _build.wgmma_probe_tf32(a, b, form).double()
        err_trunc = float(((got - trunc(a).double() @ trunc(b).double().T).abs() / mag).max())
        err_rna = float(((got - tf32_round(a).double() @ tf32_round(b).double().T).abs()
                         / mag).max())
        assert err_trunc <= 2 ** -17 < err_rna, (form, err_trunc, err_rna)
    split = _build.wgmma_probe_tf32(a, b, "rs_split").double()
    assert bool(((split - exact).abs() <= 2 ** -17 * mag).all())
    # the fp32 attention's P V (the key permutation, B transposed): depth
    # 64, so the fp32 sum of 192 terms may reach 2^-16.4
    a, b = _probe_operands(np.random.default_rng(46), cuda, exact=False, k=64)
    got = _build.wgmma_probe_tf32(a, b, "rs_perm_split").double()
    exact, mag = a.double() @ b.double(), a.double().abs() @ b.double().abs()
    assert bool(((got - exact).abs() <= 2 ** -16 * mag).all())


#: (form, rows, k, n) at ViT-B/16's widths: #2's fc1 (NN, K 768 -> 3,072),
#: #3's dz (NT, K 768 <- 3,072) and dW1 (TN, summed over 8,192 rows).
_GEMM_F32_VIT_FORMS = [("NN", 2048, 768, 3072), ("NT", 2048, 768, 3072), ("TN", 8192, 768, 3072)]


@pytest.mark.gpu
@pytest.mark.parametrize("form, rows, k, n", _GEMM_F32_VIT_FORMS)
def test_gemm_f32_vit_widths_against_fp64(cuda, form, rows, k, n):
    """gemm_f32 (3xTF32 on the tensor cores) and torch.matmul in fp32
    (cuBLAS, no TF32) each against the fp64 product at ViT-B/16's widths:
    both within 2^-16 of the largest entry of |op(a)| @ |op(b)| (fp32's
    own rounding of a K-term sum stays far inside it); the errors are
    printed side by side."""
    a, b, prod, layout = _gemm_f32_operands(np.random.default_rng(44), form, rows, k, n)
    oa = a.double().T if form == "TN" else a.double()
    ob = b.double().T if form == "NT" else b.double()
    exact, mag = oa @ ob, float((oa.abs() @ ob.abs()).max())
    got = _build.gemm_f32(a, b, **layout)
    err, err_cublas = (float((t.double() - exact).abs().max()) for t in (got, prod))
    print(f"gemm_f32 {form} [{exact.shape[0]} x {n}, K {oa.shape[1]}]: max abs err against "
          f"fp64 {err:.3g} (3xTF32), {err_cublas:.3g} (torch.matmul fp32); "
          f"bound {2 ** -16 * mag:.3g}")
    assert err <= 2 ** -16 * mag and err_cublas <= 2 ** -16 * mag


@pytest.mark.gpu
def test_gemm_f32_runs_on_the_tensor_core_kernel(cuda):
    """Every layout of gemm_f32, split over K or not, with and without the
    epilogue, launches csrc/gemm_f32.cu's gemm_f32_sm90 instances (the
    profiler's kernel names) and never the SIMT kernel it replaced."""
    rng = np.random.default_rng(45)
    calls = []
    for form, rows, k, n, kind in (("NN", 333, 200, 136, "all"), ("NT", 392, 384, 1536, "dz"),
                                   ("TN", 4096, 384, 384, "dz"), ("NT", 7, 13, 9, "all")):
        a, b, prod, layout = _gemm_f32_operands(rng, form, rows, k, n)
        kw = _epilogue_kw(rng, kind, prod.shape[0], n)
        calls += [lambda a=a, b=b, layout=layout, kw=kw: _build.gemm_f32(a, b, **layout, **kw),
                  lambda a=a, b=b, layout=layout: _build.gemm_f32(a, b, **layout)]
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    assert sum("gemm_f32_sm90" in nm for nm in names) >= 3, names
    assert not any("gemm_f32_kernel" in nm for nm in names), names


@pytest.mark.gpu
@pytest.mark.parametrize("b, nq, nk, heads, packed", _FLASH_SHAPES)
def test_flash_bwd_kernels_match_plain(cuda, b, nq, nk, heads, packed):
    """#10, #11 and #9 from the same saved lse and output: the streaming
    pair against its plain versions (the same arithmetic, one rounding
    each), #9 against JAX's fused arithmetic (its own lse and delta: a few
    bf16 ulps)."""
    from sfc_vit_tpu_torch.ops import flash_attention as fa

    q, k, v, g = _flash_qkv(np.random.default_rng(31), b, nq, nk, heads, cuda, packed)
    s = 64 ** -0.5
    out, lse = _build.flash_fwd(q, k, v, s, streaming=True, with_lse=True)
    delta = fa.flash_delta(g, out)
    dq = _build.flash_dq(q, k, v, g, lse, delta, s)
    dk, dv = _build.flash_dkv(q, k, v, g, lse, delta, s)
    want_dq = fa.flash_dq_ref(q, k, v, g, lse, delta, s)
    want_dk, want_dv = fa.flash_dkv_ref(q, k, v, g, lse, delta, s)
    for name, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv), (want_dq, want_dk, want_dv)):
        _within(a, w, 1e-2, name)
    dq32, dk9, dv9 = _build.flash_fused_bwd(q, k, v, g, lse, delta, s)
    assert dq32.dtype == torch.float32
    for name, a, w in zip(("dq", "dk", "dv"), (dq32.to(q.dtype), dk9, dv9),
                          fa.flash_fused_bwd_ref(q, k, v, g, s)):
        _within(a, w, 2e-2, name)


@pytest.mark.gpu
def test_flash_dq_dkv_repeat_bit_for_bit(cuda):
    """#10 and #11 give bit-identical results on two calls: each output
    row is summed by the one block that owns it, with no atomics."""
    from sfc_vit_tpu_torch.ops import flash_attention as fa

    q, k, v, g = _flash_qkv(np.random.default_rng(34), 2, 1000, 777, 3, cuda)
    s = 64 ** -0.5
    out, lse = _build.flash_fwd(q, k, v, s, streaming=True, with_lse=True)
    delta = fa.flash_delta(g, out)
    first = (_build.flash_dq(q, k, v, g, lse, delta, s),
             *_build.flash_dkv(q, k, v, g, lse, delta, s))
    second = (_build.flash_dq(q, k, v, g, lse, delta, s),
              *_build.flash_dkv(q, k, v, g, lse, delta, s))
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_flash_kernel_attrs_list_the_wgmma_kernels_without_spills(cuda):
    """``flash_kernel_attrs`` reports #1's and #7's eight instances (the
    one-pass forms to 128, 192, 200 and 256 keys at Dh 64 among them), #5's
    six masked ones, #16's three LayerNorm-backward instances, #8's two
    forms and #12's windowed instance of its single step, #9-#11, #13's
    windowed instances of #10's and #11's kernels and #14's two instances,
    none of them with local memory (spills)."""
    attrs = _build.flash_kernel_attrs()
    assert {"flash_fwd streaming", "flash_fwd single step", "local_fwd", "flash_fused_bwd",
            "flash_dq", "flash_dkv", "local_bwd dq", "local_bwd dkv",
            "packed_attention dh64 one pass",
            "packed_attention dh64 two passes", "packed_attention dh192 one pass",
            "packed_attention dh192 two passes", "packed_attention dh128 one pass 192 keys",
            "packed_attention masked dh256 two passes", "gather_project shared x",
            "gather_project global x"} <= set(attrs)
    assert (set(_build.PACKED_ATTENTION_FORMS) | set(_build.PACKED_ATTENTION_MASKED_FORMS)
            | set(_build.LN_ROWS_BWD_FORMS) <= set(attrs))
    for name, a in attrs.items():
        assert a["local_bytes"] == 0, name
        assert 0 < a["registers"] <= 255 and a["smem_bytes"] > 0, name


@pytest.mark.gpu
@pytest.mark.parametrize("n, fused_max", [(600, 8192), (600, 128)])
def test_flash_attention_autograd_counts_its_kernels(cuda, n, fused_max, monkeypatch):
    """``flash_attention`` under autograd launches #8 once and then #9, or
    #10 and #11 past ``FUSED_BWD_MAX``; its gradients match the plain
    route's."""
    from sfc_vit_tpu_torch.ops import flash_attention as fa

    monkeypatch.setattr(fa, "FUSED_BWD_MAX", fused_max)
    q, k, v, g = _flash_qkv(np.random.default_rng(32), 2, n, n, 2, cuda)
    counts = lambda: (fa.flash_attention.launches,  # noqa: E731
                      fa.flash_attention.fused_bwd_launches,
                      fa.flash_attention.dq_launches, fa.flash_attention.dkv_launches)
    grads = []
    for route in (fa.flash_attention, fa.flash_attention_ref):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = counts()
        route(*leaves).backward(g)
        grads.append([t.grad for t in leaves])
        if route is fa.flash_attention:
            fused = fused_max >= 8192
            assert tuple(a - b for a, b in zip(counts(), before)) == (
                1, int(fused), int(not fused), int(not fused))
        else:
            assert counts() == before
    for name, a, w in zip(("dq", "dk", "dv"), *grads):
        _within(a, w, 2e-2, name)


# -- flash attention in fp32 (#8-#11 at head dims 64, 128, 256) ----------------

# The fp32 gates (PERF.md section 2): outputs and gradients within 1e-4 of
# the largest |value| (the same arithmetic as the plain versions, the
# products 3xTF32, the sums in another order); the lse within 1e-5 of fp64.
FLASH_F32_FRAC = 1e-4
# (b, nq, nk, heads, packed): the 1-D tokenizer's 1,089 tokens as views of
# a packed projection (odd rows with several (b, h)), CurveViT-S/12's
# 4,096 (#8's single step, #9), a streaming length past 8,192 that is not
# a multiple of 64 (#8 streaming, #10 / #11), and nq != nk both ways.
_FLASH_F32_SHAPES = [(2, 1089, 1089, 3, True), (1, 4096, 4096, 2, False),
                     (1, 8300, 8300, 1, False), (2, 333, 520, 3, False),
                     (1, 1000, 777, 2, False)]


def _flash_f32(rng, b, nq, nk, heads, dh, device, packed=False):
    """fp32 q [B, Nq, H, Dh], k, v [B, Nk, H, Dh] and g; with ``packed`` q,
    k, v are strided views of one packed projection (Nq = Nk)."""
    if packed:
        qkv = _randn(rng, b, nq, 3 * heads * dh, device=device, dtype=torch.float32)
        q, k, v = qkv.view(b, nq, 3, heads, dh).unbind(2)
    else:
        q, k, v = (_randn(rng, b, n, heads, dh, device=device, dtype=torch.float32)
                   for n in (nq, nk, nk))
    return q, k, v, _randn(rng, b, nq, heads, dh, device=device, dtype=torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("b, nq, nk, heads, packed", _FLASH_F32_SHAPES)
def test_flash_f32_fwd_matches_plain(cuda, dh, b, nq, nk, heads, packed):
    """#8 in fp32, both forms (single step and streaming) at every shape,
    against its plain version; the lse against fp64; a second call bit for
    bit."""
    from sfc_vit_tpu_torch.ops import flash_attention as fa

    q, k, v, _ = _flash_f32(np.random.default_rng(50), b, nq, nk, heads, dh, cuda, packed)
    s = dh ** -0.5
    want = fa.flash_fwd_ref(q, k, v, s)
    lse64 = _lse64(q, k, s)
    for streaming in (False, True):
        out, lse = _build.flash_fwd(q, k, v, s, streaming=streaming, with_lse=True)
        _within(out, want, FLASH_F32_FRAC, f"out (streaming {streaming})")
        torch.testing.assert_close(lse.double(), lse64, rtol=1e-5, atol=1e-5)
        assert torch.equal(_build.flash_fwd(q, k, v, s, streaming=streaming), out)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("b, nq, nk, heads, packed", _FLASH_F32_SHAPES)
def test_flash_f32_bwd_matches_plain(cuda, dh, b, nq, nk, heads, packed):
    """#10, #11 and #9 in fp32 from the saved lse and output: each against
    its plain version within 1e-4 of the largest |value|, and bit for bit
    on a second call (one owner a row, no atomics)."""
    from sfc_vit_tpu_torch.ops import flash_attention as fa

    q, k, v, g = _flash_f32(np.random.default_rng(51), b, nq, nk, heads, dh, cuda, packed)
    s = dh ** -0.5
    out, lse = _build.flash_fwd(q, k, v, s, streaming=not fa.uses_single_kstep(nk),
                                with_lse=True)
    delta = fa.flash_delta(g, out)
    pair = (_build.flash_dq(q, k, v, g, lse, delta, s),
            *_build.flash_dkv(q, k, v, g, lse, delta, s))
    want = (fa.flash_dq_ref(q, k, v, g, lse, delta, s),
            *fa.flash_dkv_ref(q, k, v, g, lse, delta, s))
    for name, a, w in zip(("dq", "dk", "dv"), pair, want):
        _within(a, w, FLASH_F32_FRAC, name)
    fused = _build.flash_fused_bwd(q, k, v, g, lse, delta, s)
    for name, a, w in zip(("dq (#9)", "dk (#9)", "dv (#9)"), fused,
                          fa.flash_fused_bwd_ref(q, k, v, g, s)):
        _within(a, w, FLASH_F32_FRAC, name)
    again = (_build.flash_dq(q, k, v, g, lse, delta, s),
             *_build.flash_dkv(q, k, v, g, lse, delta, s))
    for name, a, b2 in zip(("dq", "dk", "dv"), pair, again):
        assert torch.equal(a, b2), name
    for name, a, b2 in zip(("dq (#9)", "dk (#9)", "dv (#9)"), fused,
                           _build.flash_fused_bwd(q, k, v, g, lse, delta, s)):
        assert torch.equal(a, b2), name


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("n, fused_max", [(1089, 8192), (1089, 128)])
def test_flash_f32_autograd_counts_its_kernels(cuda, dh, n, fused_max, monkeypatch):
    """``flash_attention`` on fp32 tensors under autograd launches #8's fp32
    form once and then #9's, or #10's and #11's past ``FUSED_BWD_MAX``
    (the ``f32_`` counters; the bf16 ones stay); its gradients match the
    plain route's within 1e-4, and ``flash_attention_with_lse`` gives the
    same output and the lse against fp64."""
    from sfc_vit_tpu_torch.ops import flash_attention as fa

    monkeypatch.setattr(fa, "FUSED_BWD_MAX", fused_max)
    q, k, v, g = _flash_f32(np.random.default_rng(52), 2, n, n, 2, dh, cuda, packed=True)
    f = fa.flash_attention
    counts = lambda: (f.f32_launches, f.f32_fused_bwd_launches,  # noqa: E731
                      f.f32_dq_launches, f.f32_dkv_launches, f.launches,
                      f.fused_bwd_launches, f.dq_launches, f.dkv_launches)
    grads, outs = [], []
    for route in (fa.flash_attention, fa.flash_attention_ref):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        before = counts()
        out = route(*leaves)
        out.backward(g)
        outs.append(out.detach())
        grads.append([t.grad for t in leaves])
        fused = fused_max >= 8192
        want = (1, int(fused), int(not fused), int(not fused)) if route is f else (0,) * 4
        assert tuple(a - b for a, b in zip(counts(), before)) == want + (0,) * 4
    _within(outs[0], outs[1], FLASH_F32_FRAC, "out")
    for name, a, w in zip(("dq", "dk", "dv"), *grads):
        _within(a, w, FLASH_F32_FRAC, name)
    before = f.f32_launches
    out, lse = fa.flash_attention_with_lse(q, k, v)
    assert f.f32_launches == before + 1
    assert torch.equal(out, outs[0])
    torch.testing.assert_close(lse.double(), _lse64(q, k, dh ** -0.5), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_flash_attention_refuses_what_the_kernels_do_not_take(cuda):
    from sfc_vit_tpu_torch.ops import flash_attention as fa

    for dh in (128, 256):  # bf16 past head dim 64
        q = torch.zeros(1, 8, 2, dh, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(NotImplementedError, match="queue 2 entry 2"):
            fa.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="queue 2 entry 2"):
        fa.flash_attention(q, q, q)  # head dim 32
    q = torch.zeros(1, 8, 2, 96, device=cuda)
    with pytest.raises(NotImplementedError, match="queue 2 entry 2"):
        fa.flash_attention(q, q, q)  # fp32 at head dim 96
    with pytest.raises(ValueError, match="16 bytes"):
        x = torch.zeros(1, 8, 2, 68, device=cuda, dtype=torch.bfloat16)[..., 2:66]
        _build.flash_fwd(x, x, x, 1.0, streaming=True)
    with pytest.raises(ValueError, match="16 bytes"):
        x = torch.zeros(1, 8, 2, 66, device=cuda)[..., 1:65]
        _build.flash_fwd(x, x, x, 1.0, streaming=True)


@pytest.mark.gpu
def test_long_context_model_kernel_path_matches_plain_path(cuda):
    """A small merged CurveViT past 1,024 tokens on the card: eval and one
    backward through #8 and #9 (and #10/#11 with the fused bound lowered),
    against the same model through the plain flash versions."""
    from unittest import mock

    import sfc_vit_tpu_torch.ops.attention as attention
    from sfc_vit_tpu_torch.ops import flash_attention as fa
    from sfc_vit_tpu_torch.registry import build_model, preset_config

    cfg = preset_config("longctx-16k", img_size=48, depth=3)  # 2,304 then 1,728 tokens
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    x = _randn(np.random.default_rng(33), 2, 48, 48, 3)
    plain = mock.patch.object(attention, "flash_attention", fa.flash_attention_ref)
    before = fa.flash_attention.launches
    with torch.no_grad():
        got = model(x)
        with plain:
            want = model(x)
    assert fa.flash_attention.launches == before + cfg.depth
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2, atol=5e-2)
    for fused_max in (8192, 128):
        with mock.patch.object(fa, "FUSED_BWD_MAX", fused_max):
            grads = []
            for ctx in (mock.patch.object(attention, "flash_attention", fa.flash_attention),
                        plain):
                model.zero_grad()
                with ctx:
                    model(x).float().sum().backward()
                grads.append([p.grad.float().clone() for p in model.parameters()])
        for g, w in zip(*grads):
            assert float((g - w).norm() / w.norm()) <= 0.1


# -- curve-local attention (#12, #13) and gather + projection (#14) ---------------


def test_local_and_gather_launchers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.local_fwd(q, q, q, 1.0, block=128, halo=1)
    with pytest.raises(ValueError, match="block a multiple of 64"):
        _build.local_fwd(q, q, q, 1.0, block=96, halo=1)
    with pytest.raises(ValueError, match="head dim 64"):
        x = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
        _build.local_bwd(x, x, x, x, None, None, 1.0, block=128, halo=1)
    x = torch.zeros(1, 8, 3, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.gather_project(x, torch.arange(8, dtype=torch.int32),
                              torch.zeros(3, 8, dtype=torch.bfloat16), None, 1)
    with pytest.raises(ValueError, match="LUT entries"):
        _build.gather_project(x, torch.arange(8, dtype=torch.int32),
                              torch.zeros(9, 8, dtype=torch.bfloat16), None, 3)


#: (b, n, heads, block, halo, packed): ragged lengths at the hybrid
#: preset's block 128 / halo 1 (one not a multiple of 64, one of 5,000
#: tokens), a window of five 64-blocks, q, k, v as views of one packed
#: projection, a 192 block straddling 128-row tiles (a kernel block's two
#: warpgroups meet different windows) and halo 2 at block 128.
_LOCAL_SHAPES = [(2, 300, 3, 128, 1, False), (1, 520, 2, 128, 1, True),
                 (1, 5000, 2, 128, 1, True), (2, 700, 2, 64, 2, False),
                 (1, 1000, 2, 192, 1, True), (1, 900, 2, 128, 2, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, heads, block, halo, packed", _LOCAL_SHAPES)
def test_local_kernels_match_plain(cuda, b, n, heads, block, halo, packed):
    """#12 (out and lse) and #13 (dq, dk, dv: the windowed instances of #10's
    and #11's kernels) against their plain versions fed the same inputs:
    one rounding of the same fp32 sums (and #13's two-term split of p and
    ds) per element; #13 gives the same bits on a second call (each output
    row summed by its one owner)."""
    from sfc_vit_tpu_torch.ops import local_attention as la
    from sfc_vit_tpu_torch.ops.flash_attention import flash_delta

    q, k, v, g = _flash_qkv(np.random.default_rng(40), b, n, n, heads, cuda, packed)
    s = 64 ** -0.5
    out, lse = _build.local_fwd(q, k, v, s, block, halo, with_lse=True)
    want, want_lse = la.local_fwd_ref(q, k, v, block, halo, s, return_lse=True)
    _within(out, want, 1e-2, "out")
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    assert torch.equal(_build.local_fwd(q, k, v, s, block, halo), out)
    delta = flash_delta(g, out)
    got = _build.local_bwd(q, k, v, g, lse, delta, s, block, halo)
    for name, a, w in zip(("dq", "dk", "dv"), got,
                          la.local_bwd_ref(q, k, v, g, lse, delta, block, halo, s)):
        _within(a, w, 1e-2, name)
    for name, a, w in zip(("dq", "dk", "dv"), got,
                          _build.local_bwd(q, k, v, g, lse, delta, s, block, halo)):
        assert torch.equal(a, w), name


@pytest.mark.gpu
@pytest.mark.parametrize("n", [200, 600])
def test_local_block_attention_autograd_counts_its_kernels(cuda, n):
    """At 600 tokens (block 128, halo 1) ``local_block_attention`` launches
    #12 once and #13 once; at 200 it is the dense case, flash attention;
    the gradients match the plain route's."""
    from sfc_vit_tpu_torch.ops import flash_attention as fa
    from sfc_vit_tpu_torch.ops import local_attention as la

    q, k, v, g = _flash_qkv(np.random.default_rng(41), 2, n, n, 2, cuda)
    counts = lambda: (la.local_block_attention.launches,  # noqa: E731
                      la.local_block_attention.bwd_launches, fa.flash_attention.launches)
    grads = []
    for route in (la.local_block_attention, la.local_block_attention_ref):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = counts()
        route(*leaves).backward(g)
        grads.append([t.grad for t in leaves])
        delta = tuple(a - b for a, b in zip(counts(), before))
        if route is la.local_block_attention_ref:
            assert delta == (0, 0, 0)
        else:
            assert delta == ((0, 0, 1) if la.is_dense(n, 128, 1) else (1, 1, 0))
    for name, a, w in zip(("dq", "dk", "dv"), *grads):
        _within(a, w, 2e-2, name)


@pytest.mark.gpu
def test_local_attention_refuses_what_the_kernels_do_not_take(cuda):
    from sfc_vit_tpu_torch.ops import local_attention as la

    q = torch.zeros(1, 600, 2, 64, device=cuda)
    with pytest.raises(NotImplementedError, match="queue 2 entry 3"):
        la.local_block_attention(q, q, q)  # fp32
    q = torch.zeros(1, 600, 2, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="queue 2 entry 3"):
        la.local_block_attention(q, q, q)  # head dim 32
    q = torch.zeros(1, 600, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="queue 2 entry 3"):
        la.local_block_attention(q, q, q, block=32)


#: (b, n, k, m, group, d, repeat): the flagship's three levels (a 32 px
#: image, D = 256) at batch 8, a ragged case with D past one 256-column
#: slice and repeated LUT entries (x gathered from global memory: an
#: image of 500 bytes), one with more features than a chunk (an image past
#: the shared buffer), batches of more items than twice the persistent
#: grid, and an image of 222 bytes (global memory) with repeats at D 64.
_GP_SHAPES = [(8, 1024, 3, 64, 16, 256, False), (8, 256, 12, 64, 4, 256, False),
              (8, 64, 48, 64, 1, 256, False), (3, 50, 5, 70, 3, 300, True),
              (2, 196, 768, 196, 1, 96, False), (600, 1024, 3, 64, 16, 256, False),
              (600, 64, 48, 64, 1, 256, False), (5, 37, 3, 20, 1, 64, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("b, n, k, m, group, d, repeat", _GP_SHAPES)
def test_gather_project_matches_plain(cuda, b, n, k, m, group, d, repeat, bias):
    """#14 against its plain version (the same order: fp32 sum, bias in
    fp32, one rounding): one bf16 rounding of a sum taken in another order."""
    from sfc_vit_tpu_torch.ops import gather_project as gp

    rng = np.random.default_rng(42)
    x = _randn(rng, b, n, k, device=cuda)
    lut = rng.integers(0, n, m * group) if repeat else rng.permutation(n)[:m * group]
    lut = torch.from_numpy(lut.astype(np.int32)).to(cuda)
    w = _randn(rng, group * k, d, scale=(group * k) ** -0.5, device=cuda)
    bvec = _randn(rng, d, device=cuda) if bias else None
    before = gp.gather_project.launches
    got = gp.gather_project(x, lut, w, bvec, group)
    assert gp.gather_project.launches == before + 1
    torch.testing.assert_close(got.float(), gp.gather_project_ref(x, lut, w, bvec, group)
                               .float(), **ONE_ROUND_TOL)


@pytest.mark.gpu
def test_gather_project_repeats_bit_for_bit(cuda):
    """#14 gives the same bits on two calls, from shared and from global
    memory: each output element is summed by the one item that owns it."""
    from sfc_vit_tpu_torch.ops import gather_project as gp

    rng = np.random.default_rng(44)
    for b, n, k, group, d in ((600, 256, 12, 4, 256), (3, 50, 5, 3, 300)):
        x = _randn(rng, b, n, k, device=cuda)
        lut = torch.from_numpy(rng.permutation(n)[:n // group * group].astype(np.int32)).to(cuda)
        w = _randn(rng, group * k, d, scale=(group * k) ** -0.5, device=cuda)
        bvec = _randn(rng, d, device=cuda)
        first = _build.gather_project(x, lut, w, bvec, group)
        assert torch.equal(_build.gather_project(x, lut, w, bvec, group), first)


@pytest.mark.gpu
def test_gather_project_grads_in_bf16_and_fp32(cuda):
    """Under autograd the forward is #14 (bf16 or its fp32 form) and the
    backward plain PyTorch: the gradients match those of the plain
    forward."""
    from sfc_vit_tpu_torch.ops import gather_project as gp

    rng = np.random.default_rng(43)
    x, w, bvec = (_randn(rng, 4, 64, 48, device=cuda),
                  _randn(rng, 48, 256, scale=48 ** -0.5, device=cuda),
                  _randn(rng, 256, device=cuda))
    lut = torch.from_numpy(rng.permutation(64).astype(np.int32)).to(cuda)
    g = _randn(rng, 4, 64, 256, device=cuda)
    grads = []
    for fn in (gp.gather_project, gp.gather_project_ref):
        leaves = [t.clone().requires_grad_() for t in (x, w, bvec)]
        fn(leaves[0], lut, leaves[1], leaves[2], 1).backward(g)
        grads.append([t.grad for t in leaves])
    for name, a, want in zip(("dx", "dw", "db"), *grads):
        _within(a, want, 2e-2, name)
    grads = []
    for fn in (gp.gather_project, gp.gather_project_ref):
        leaves = [t.float().requires_grad_() for t in (x, w, bvec)]
        fn(leaves[0], lut, leaves[1], leaves[2], 1).backward(g.float())
        grads.append([t.grad for t in leaves])
    for name, a, want in zip(("dx", "dw", "db"), *grads):
        _within(a, want, F32_TOL, name)


@pytest.mark.gpu
def test_hybrid_and_fused_flagship_kernel_paths_match_plain(cuda):
    """A hybrid CurveViT (three local layers and a global one, merged after
    layer 1; 48 x 48 px) and the fused flagship on the card: eval through
    #12 / #14 against the plain versions, one backward through #13."""
    from unittest import mock

    import sfc_vit_tpu_torch.ops.attention as attention
    from sfc_vit_tpu_torch.ops import gather_project as gp
    from sfc_vit_tpu_torch.ops import local_attention as la
    from sfc_vit_tpu_torch.registry import build_model, preset_config

    cfg = preset_config("longctx-16k-hybrid", img_size=48)  # 2,304 then 1,728 tokens
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    x = _randn(np.random.default_rng(44), 2, 48, 48, 3)
    plain = mock.patch.object(attention, "local_block_attention", la.local_block_attention_ref)
    before = la.local_block_attention.launches
    with torch.no_grad():
        got = model(x)
        with plain:
            want = model(x)
    assert la.local_block_attention.launches == before + 3
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2, atol=5e-2)
    grads = []
    for ctx in (mock.patch.object(attention, "local_block_attention",
                                  la.local_block_attention), plain):
        model.zero_grad()
        with ctx:
            model(x).float().sum().backward()
        grads.append([p.grad.float().clone() for p in model.parameters()])
    for g, w in zip(*grads):
        assert float((g - w).norm() / w.norm()) <= 0.1

    fused = build_model(preset_config("flagship", fused=True, dtype="bfloat16"),
                        generator=torch.Generator().manual_seed(0)).eval()
    unfused = build_model(preset_config("flagship", dtype="bfloat16"))
    unfused.load_state_dict(fused.state_dict())
    imgs = _randn(np.random.default_rng(45), 16, 32, 32, 3)
    before = gp.gather_project.launches
    with torch.no_grad():
        a, b = fused(imgs), unfused.eval()(imgs)
    assert gp.gather_project.launches == before + 3
    assert float((a.float() - b.float()).abs().max()) <= 0.03 * float(b.float().abs().max())


# -- the post-norm tail (#15, #16) on the card -----------------------------------


def _tail_args(rng, b, n, d, f, device):
    """x, attn, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b (bf16 tensors,
    fp32 LayerNorm parameters), as the encoder layer passes them."""
    ln = lambda shift: _randn(rng, d, scale=0.1, device=device,  # noqa: E731
                              dtype=torch.float32) + shift
    return (_randn(rng, b, n, d, device=device), _randn(rng, b, n, d, device=device),
            ln(1.0), ln(0.0), _randn(rng, d, f, scale=d ** -0.5, device=device),
            _randn(rng, f, scale=0.1, device=device),
            _randn(rng, f, d, scale=f ** -0.5, device=device),
            _randn(rng, d, scale=0.1, device=device), ln(1.0), ln(0.0))


#: (b, n, d, f): the flagship at MLP 1,024 and hier's levels, cut in
#: batch; F 2048; ragged row counts (1,000 and 37 rows); widths that take
#: fc2 and LN2 as two launches (200: not whole 128-column tiles; 1,152: a
#: cluster of 9).
_TAIL_SHAPES = [(8, 64, 768, 1024), (8, 64, 256, 1024), (4, 64, 256, 2048),
                (10, 100, 768, 1024), (1, 37, 256, 1024), (2, 50, 200, 1024),
                (1, 40, 1152, 1024)]
_TAIL_NAMES = ("ds", "dln1_s", "dln1_b", "dw1", "db1", "dw2", "db2", "dln2_s", "dln2_b")


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, d, f", _TAIL_SHAPES)
def test_postnorm_tail_fwd_matches_plain(cuda, b, n, d, f):
    """#15's serving and training forms against its plain version (the
    same rounding points): out, z and s2 each within 1 % of its largest
    |value| (an fp32 sum taken in another order flips a rounding)."""
    args = _tail_args(np.random.default_rng(50), b, n, d, f, cuda)
    before = (fused_postnorm_tail.launches, fused_postnorm_tail.train_launches)
    with torch.no_grad():
        out = fused_postnorm_tail(*args)
    got = postnorm_tail_train_fwd(*args)
    assert (fused_postnorm_tail.launches, fused_postnorm_tail.train_launches) == (
        before[0] + 1, before[1] + 1)
    want = postnorm_tail_kernel_ref(*args, save_acts=True)
    assert torch.equal(out, got[0])
    for name, x, w in zip(("out", "z", "s2"), got, want):
        assert x.shape == w.shape, name
        _within(x, w, 1e-2, name)


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, d, f", _TAIL_SHAPES)
def test_postnorm_tail_bwd_matches_plain(cuda, b, n, d, f):
    """#16 fed the saved z and s2 against its plain version, and the
    autograd route (#15's training form, then #16), every gradient within
    2 % of its largest |value|."""
    rng = np.random.default_rng(51)
    args = _tail_args(rng, b, n, d, f, cuda)
    g = _randn(rng, b, n, d, device=cuda)
    _, z, s2 = postnorm_tail_train_fwd(*args)
    saved = (args[0], args[1], g, z, s2, *args[2:7], args[8], args[9])
    got = postnorm_tail_bwd(*saved, b2=args[7])
    want = postnorm_tail_bwd_ref(*saved, b2=args[7])
    for name, x, w in zip(_TAIL_NAMES, got, want):
        _within(x, w, 2e-2, name)
    leaves = [t.clone().requires_grad_() for t in args]
    before = fused_postnorm_tail.bwd_launches
    fused_postnorm_tail(*leaves).backward(g)
    assert fused_postnorm_tail.bwd_launches == before + 1
    order = (0, 0, 1, 2, 3, 4, 5, 6, 7, 8)  # ds is the gradient of x and of attn
    for i, leaf in enumerate(leaves):
        _within(leaf.grad, want[order[i]], 2e-2, f"arg {i}")


@pytest.mark.gpu
@pytest.mark.parametrize("r, d", [(512 * 64, 768), (512 * 64, 256), (1000, 768), (1000, 256)])
def test_gemm_layernorm_cluster_matches_the_two_launches(cuda, r, d):
    """#15's fc2 + LN2 in one cluster launch at the flagship's and 'hier''s
    widths ([512, 64] rows) and a ragged 1,000 rows: the bf16 s2 it writes
    (with x2f rebuilt from x, attn and LN1's row stats) is the two-launch
    chain's (x2f read back in fp32; the same fp32 sum, rounded once) bit
    for bit; the output within one bf16 rounding of LN over the chain's
    fp32 s2; a second call gives the same bits."""
    rng = np.random.default_rng(61)
    f = 1024
    h = _randn(rng, r, f)
    w2 = _randn(rng, f, d, scale=f ** -0.5)
    b2 = _randn(rng, d, scale=0.1, dtype=torch.float32)
    x, attn = _randn(rng, r, d), _randn(rng, r, d)
    s1 = _randn(rng, d, scale=0.1, dtype=torch.float32) + 1.0
    b1 = _randn(rng, d, scale=0.1, dtype=torch.float32)
    s = _randn(rng, d, scale=0.1, dtype=torch.float32) + 1.0
    bias = _randn(rng, d, scale=0.1, dtype=torch.float32)
    _, x2f = _build.ln_rows(x, s1, b1, 1e-5, x_b=attn, with_f32=True)
    stats = _build.ln_rows(x, s1, b1, 1e-5, x_b=attn, with_stats=True)[1]
    ln1 = (x, attn, stats, s1, b1)
    out, s2b = _build.gemm_layernorm(h, w2, b2, *ln1, s, bias, 1e-5, save_input=True)
    s2 = _build.gemm(h, w2, bias=b2, residual_f32=x2f, out_dtype=torch.float32)
    chain, s2r = _build.ln_rows(s2, s, bias, 1e-5, with_rounded_input=True)
    assert torch.equal(s2b, s2r)  # x2f rebuilt from the stats: the same bits
    torch.testing.assert_close(out.float(), ln_fp32(s2, s, bias).bfloat16().float(),
                               **ONE_ROUND_TOL)
    torch.testing.assert_close(out.float(), chain.float(), **ONE_ROUND_TOL)
    assert torch.equal(out, _build.gemm_layernorm(h, w2, b2, *ln1, s, bias, 1e-5))


@pytest.mark.gpu
@pytest.mark.parametrize("d, clustered", [(768, True), (256, True), (200, False),
                                          (1152, False)])
def test_postnorm_tail_takes_the_cluster_launch_by_width(cuda, d, clustered):
    """#15 launches gemm_layernorm once a forward where D is whole
    128-column tiles, at most 8, and never elsewhere (fc2 and LN2 as two
    launches); both forms within 1 % of the plain version."""
    from unittest import mock

    import sfc_vit_tpu_torch.ops.fused_mlp as fm

    args = _tail_args(np.random.default_rng(62), 2, 40, d, 1024, cuda)
    calls = []

    def counted(*a, **k):
        calls.append(a[0].shape)
        return _build.gemm_layernorm(*a, **k)
    with mock.patch.object(fm, "gemm_layernorm", counted), torch.no_grad():
        out = fused_postnorm_tail(*args)
        got = postnorm_tail_train_fwd(*args)
    assert len(calls) == (2 if clustered else 0)
    assert torch.equal(out, got[0])
    want = postnorm_tail_kernel_ref(*args, save_acts=True)
    for name, x, w in zip(("out", "z", "s2"), got, want):
        _within(x, w, 1e-2, name)


@pytest.mark.gpu
def test_postnorm_tail_launcher_pieces_match_fp32(cuda):
    """The launcher options the tail adds, against fp32 formulas: LN over a
    two-row sum (with the fp32 output) and over fp32 rows (with the rounded
    input), the LN backward from a bf16 cotangent (fp32 dx and its column
    sums) and over a two-row sum, and the GEMM's fp32 residual."""
    rng = np.random.default_rng(52)
    r, d = 1000, 768
    x, a = _randn(rng, r, d, device=cuda), _randn(rng, r, d, device=cuda)
    s = _randn(rng, d, dtype=torch.float32)
    bias = _randn(rng, d, dtype=torch.float32)
    y, y32 = _build.ln_rows(x, s, bias, 1e-5, x_b=a, with_f32=True)
    want = ln_fp32(x.float() + a.float(), s, bias)
    torch.testing.assert_close(y32, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(y.float(), want.bfloat16().float(), **ONE_ROUND_TOL)
    xf = _randn(rng, r, d, dtype=torch.float32) * 3.0
    y, xr = _build.ln_rows(xf, s, bias, 1e-5, with_rounded_input=True)
    assert torch.equal(xr, xf.bfloat16())
    torch.testing.assert_close(y.float(), ln_fp32(xf, s, bias).bfloat16().float(),
                               **ONE_ROUND_TOL)
    g = _randn(rng, r, d, device=cuda)
    dx, ds, db, dx32, dxs = _build.ln_rows_bwd(x, g, s, None, 1e-5, add_g=False,
                                               dx_f32=True, dx_sum=True)
    want_dx, want_ds, want_db = ln_bwd_fp32(x, g.float(), s)
    tol = dict(rtol=1e-4, atol=1e-4 * r ** 0.5)
    torch.testing.assert_close(dx32, want_dx, rtol=1e-4, atol=1e-4)
    assert torch.equal(dx, dx32.bfloat16())
    torch.testing.assert_close(dxs, want_dx.sum(0), **tol)
    torch.testing.assert_close(ds, want_ds, **tol)
    torch.testing.assert_close(db, want_db, **tol)
    dxn = _randn(rng, r, d, dtype=torch.float32)
    dx, ds, db = _build.ln_rows_bwd(x, dxn, s, None, 1e-5, add_g=False, x_b=a)
    want_dx, want_ds, want_db = ln_bwd_fp32(x.float() + a.float(), dxn, s)
    torch.testing.assert_close(dx.float(), want_dx.bfloat16().float(), **ONE_ROUND_TOL)
    torch.testing.assert_close(ds, want_ds, **tol)
    torch.testing.assert_close(db, want_db, **tol)
    w = _randn(rng, d, 1024, scale=d ** -0.5, device=cuda)
    b1 = _randn(rng, 1024, dtype=torch.float32)
    res = _randn(rng, r, 1024, dtype=torch.float32)
    got = _build.gemm(x, w, bias=b1, residual_f32=res, out_dtype=torch.float32)
    want = x.float() @ w.float() + b1 + res
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
def test_postnorm_tail_refuses_other_dtypes(cuda):
    """A CUDA x in a dtype other than bf16 or fp32 raises before any launch,
    in both forms and in the backward; nothing falls back."""
    args = tuple(t.half() for t in _tail_args(np.random.default_rng(53), 1, 8, 128, 1024,
                                              cuda))
    t = fused_postnorm_tail
    before = (t.launches, t.train_launches, t.bwd_launches, t.f32_launches,
              t.f32_train_launches, t.f32_bwd_launches)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="bfloat16 or float32"):
        fused_postnorm_tail(*args)
    with pytest.raises(NotImplementedError, match="bfloat16 or float32"):
        fused_postnorm_tail(*(a.clone().requires_grad_() for a in args))
    g = args[0]
    z = torch.zeros(1, 8, 1024, dtype=torch.half, device=cuda)
    with pytest.raises(NotImplementedError, match="bfloat16 or float32"):
        postnorm_tail_bwd(args[0], args[1], g, z, args[0], *args[2:7], args[8], args[9])
    assert (t.launches, t.train_launches, t.bwd_launches, t.f32_launches,
            t.f32_train_launches, t.f32_bwd_launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("r, d", [(32768, 768), (32768, 256), (1000, 768), (37, 1024)])
def test_ln_rows_f32_two_row_sum_matches_plain(cuda, r, d):
    """``ln_rows`` over the fp32 sum of two fp32 rows, fp32 out (#15's LN1
    and #16's x2 in float32), against ``ln_fp32(x + x_b)`` within 1e-4 of
    the largest |value|, the same bits on a second call."""
    rng = np.random.default_rng(81)
    x, a = _f32(rng, r, d, scale=2.0), _f32(rng, r, d)
    s, bias = _f32(rng, d, scale=0.1) + 1.0, _f32(rng, d, scale=0.1)
    y = _build.ln_rows(x, s, bias, 1e-5, x_b=a, out_dtype=torch.float32)
    assert y.dtype == torch.float32 and y.shape == (r, d)
    _within(y, ln_fp32(x + a, s, bias, 1e-5), F32_TOL, "ln_rows x + x_b fp32")
    assert torch.equal(y, _build.ln_rows(x, s, bias, 1e-5, x_b=a, out_dtype=torch.float32))
    with pytest.raises(ValueError, match="expected torch.float32"):
        _build.ln_rows(x, s, bias, 1e-5, x_b=a.bfloat16(), out_dtype=torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("r, d", [(32768, 768), (32768, 256), (1000, 768), (37, 1024)])
def test_ln_rows_bwd_f32_tail_forms_match_plain(cuda, r, d):
    """``ln_rows_bwd``'s float32 forms on #16's path: (d) with the column
    sums of dx and no g (LN2's ds2 and db2), and (e) over the fp32 sum x +
    x_b (LN1's ds), against ``ln_bwd_fp32`` within 1e-4 of each output's
    largest |value|; every output, the column sums too, the same bits on a
    second call."""
    rng = np.random.default_rng(82)
    x, a, dxn = _f32(rng, r, d, scale=2.0), _f32(rng, r, d), _f32(rng, r, d)
    s = _f32(rng, d, scale=0.1) + 1.0
    calls = {
        "(d) + colsum(dx)": lambda: _build.ln_rows_bwd(x, dxn, s, None, 1e-5, add_g=False,
                                                       dx_sum=True),
        "(e) x + x_b": lambda: _build.ln_rows_bwd(x, dxn, s, None, 1e-5, add_g=False, x_b=a),
    }
    dx, ds, db = ln_bwd_fp32(x, dxn, s, 1e-5)
    dx_e, ds_e, db_e = ln_bwd_fp32(x + a, dxn, s, 1e-5)
    wants = {"(d) + colsum(dx)": (dx, ds, db, dx.sum(0)), "(e) x + x_b": (dx_e, ds_e, db_e)}
    for form, call in calls.items():
        got = call()
        assert len(got) == len(wants[form]), form
        for name, g, w in zip(("dx", "dscale", "dbias", "colsum(dx)"), got, wants[form]):
            _within(g, w, F32_TOL, f"{form} {name}")
        for u, v in zip(got, call()):
            assert torch.equal(u, v), form
    with pytest.raises(ValueError, match="no dx_f32"):
        _build.ln_rows_bwd(x, dxn, s, None, 1e-5, add_g=False, dx_f32=True)


#: (b, n, d): the flagship's fp32 layer at MLP 1,024 and 'hier''s width,
#: cut in batch, and ragged rows; F 1,024.
_TAIL_F32_SHAPES = [(8, 64, 768), (8, 64, 256), (10, 100, 768), (1, 37, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, d", _TAIL_F32_SHAPES)
def test_postnorm_tail_f32_matches_plain(cuda, b, n, d):
    """#15 in fp32, serving and training forms, and #16 in fp32 fed the
    saved z and s2, against ``postnorm_tail_kernel_ref`` /
    ``postnorm_tail_bwd_ref`` (in fp32 nothing rounds between the steps)
    within 1e-4 of each tensor's largest |value|; the autograd route too;
    the fp32 counters move and the bf16 ones do not."""
    rng = np.random.default_rng(83)
    args = _f32_args(_tail_args(rng, b, n, d, 1024, cuda))
    g = _f32(rng, b, n, d)
    t = fused_postnorm_tail
    bf16_before = (t.launches, t.train_launches, t.bwd_launches)
    before = (t.f32_launches, t.f32_train_launches, t.f32_bwd_launches)
    with torch.no_grad():
        out = fused_postnorm_tail(*args)
        got = postnorm_tail_train_fwd(*args)
    want = postnorm_tail_kernel_ref(*args, save_acts=True)
    assert torch.equal(out, got[0])
    for name, x, w in zip(("out", "z", "s2"), got, want):
        assert x.dtype == torch.float32 and x.shape == w.shape, name
        _within(x, w, F32_TOL, name)
    _, z, s2 = got
    saved = (args[0], args[1], g, z, s2, *args[2:7], args[8], args[9])
    grads = postnorm_tail_bwd(*saved, b2=args[7])
    want_g = postnorm_tail_bwd_ref(*saved, b2=args[7])
    for name, x, w in zip(_TAIL_NAMES, grads, want_g):
        assert x.dtype == torch.float32, name
        _within(x, w, F32_TOL, name)
    for u, v in zip(grads, postnorm_tail_bwd(*saved, b2=args[7])):
        assert torch.equal(u, v)  # fixed-order column sums
    leaves = [a.clone().requires_grad_() for a in args]
    fused_postnorm_tail(*leaves).backward(g)
    order = (0, 0, 1, 2, 3, 4, 5, 6, 7, 8)  # ds is the gradient of x and of attn
    for i, leaf in enumerate(leaves):
        _within(leaf.grad, want_g[order[i]], F32_TOL, f"arg {i}")
    assert (t.f32_launches, t.f32_train_launches, t.f32_bwd_launches) == (
        before[0] + 1, before[1] + 2, before[2] + 3)
    assert (t.launches, t.train_launches, t.bwd_launches) == bf16_before


@pytest.mark.gpu
@pytest.mark.parametrize("model, dtype", [("hier", None), ("vit1d", "bfloat16"),
                                          ("curvevit", "bfloat16"), ("curvevit", None)])
def test_remat_step_equals_plain_step_on_the_card(cuda, model, dtype):
    """Two train steps with ``remat=True`` against two without, from the same
    seeds, on the kernels: the loss and every gradient equal bit for bit
    (every kernel on these paths sums in a fixed order), the dropout
    generator left in the same state."""
    from sfc_vit_tpu_torch.registry import build_model, preset_config
    from sfc_vit_tpu_torch.training import (TrainState, make_optimizer, make_train_step,
                                            warmup_cosine)

    if model == "curvevit":
        cfg = dict(img_size=28, patch_size=4, embed_dim=128, depth=2, n_heads=2, mlp_dim=256)
        preset = "vit-b-16"
    else:
        cfg = dict(img_size=16, embed_dim=128, depth=1, n_heads=2, mlp_dim=1024, model=model)
        preset = "flagship"
    hw = cfg["img_size"]
    x = _randn(np.random.default_rng(84), 8, hw, hw, 3, dtype=torch.float32)
    y = torch.arange(8, device=cuda) % 10
    runs = []
    for remat in (False, True):
        net = build_model(preset_config(preset, remat=remat, dtype=dtype, **cfg),
                          generator=torch.Generator().manual_seed(0))
        state = TrainState(net, make_optimizer(net.parameters(), warmup_cosine(1e-3, 0, 10),
                                               grad_clip=1.0))
        step = make_train_step(10)
        gen, dgen = torch.Generator().manual_seed(1), torch.Generator(device=cuda).manual_seed(2)
        out = []
        for _ in range(2):
            m = step(state, (x, y), gen, dgen)
            out.append((m["loss"], [p.grad.clone() for p in net.parameters()]))
        runs.append((out, dgen.get_state()))
    (plain, plain_state), (remat, remat_state) = runs
    for (lp, gp), (lr, gr) in zip(plain, remat):
        assert torch.equal(lp, lr)
        assert all(torch.equal(a, b) for a, b in zip(gp, gr))
    assert torch.equal(plain_state, remat_state)


@pytest.mark.gpu
def test_family_a_tail_model_paths_match_plain(cuda):
    """A small flagship at MLP 1,024 (dropout 0, trained through #15/#16)
    and a small 'hier' (eval through #15 at d = 256) on the card, each
    against the plain versions of the tail."""
    from unittest import mock

    import sfc_vit_tpu_torch.models.layers as layers
    from sfc_vit_tpu_torch.models import VisionTransformer1D
    from sfc_vit_tpu_torch.registry import build_model, build_tokenizer, preset_config

    cfg = preset_config("flagship", img_size=16, depth=2, mlp_dim=1024, dtype="bfloat16")
    model = VisionTransformer1D(build_tokenizer(cfg), depth=2, mlp_dim=1024,
                                dropout_rate=0.0, dtype=torch.bfloat16, device=cuda,
                                generator=torch.Generator().manual_seed(0)).train()
    x = _randn(np.random.default_rng(54), 6, 16, 16, 3)
    grads = []
    before = (fused_postnorm_tail.train_launches, fused_postnorm_tail.bwd_launches)
    for plain in (False, True):
        model.zero_grad()
        ctx = (mock.patch.object(layers, "fused_postnorm_tail", postnorm_tail_kernel_ref)
               if plain else contextlib.nullcontext())
        # the head's dropout (0.5) draws the same masks on both paths
        with ctx, layers.dropout_generator(torch.Generator(device=cuda).manual_seed(1)):
            model(x).float().sum().backward()
        grads.append([p.grad.float().clone() for p in model.parameters()])
    assert (fused_postnorm_tail.train_launches, fused_postnorm_tail.bwd_launches) == (
        before[0] + 2, before[1] + 2)
    for g, w in zip(*grads):
        assert float((g - w).norm() / w.norm()) <= 0.1

    hier = build_model(preset_config("flagship", model="hier", img_size=16, depth=1,
                                     mlp_dim=1024, dtype="bfloat16"),
                       generator=torch.Generator().manual_seed(0)).eval()
    before = fused_postnorm_tail.launches
    with torch.no_grad():
        got = hier(x)
        with mock.patch.object(layers, "fused_postnorm_tail", postnorm_tail_kernel_ref):
            want = hier(x)
    assert fused_postnorm_tail.launches == before + 3 + 2
    assert float((got.float() - want.float()).abs().max()) <= 0.03 * float(
        want.float().abs().max())


# -- #1-#4 in fp32: the ViT-B/16 and ViT-S/16 presets at their own dtype -------


def _gemm_f32_operands(rng, form, rows, k, n):
    """(a, b, op(a) @ op(b) in fp32, gemm keywords) for a layout as the
    chains store it: TN a [K=rows, M=k]; NT b [N, K]; NN b [K, N]."""
    if form == "TN":
        a, b = _f32(rng, rows, k), _f32(rng, rows, n)
        return a, b, a.T @ b, dict(trans_a=True)
    a = _f32(rng, rows, k)
    if form == "NT":
        b = _f32(rng, n, k, scale=k ** -0.5)
        return a, b, a @ b.T, dict(trans_b=True)
    b = _f32(rng, k, n, scale=k ** -0.5)
    return a, b, a @ b, {}


#: (form, rows, k, n, epilogue): #2's fc1 (bias, GELU, z) and fc2 (bias,
#: residual), #1's output projection (residual), #3's dz (act'(z) with the
#: column sums), every epilogue at once with ReLU; at ViT-S/16's widths
#: (R 2 x 196), ragged (not multiples of 4 or 128), and TN forms whose K is
#: split (the epilogue then follows the ordered sum).
_GEMM_F32_EPILOGUES = [
    ("NN", 392, 384, 1536, "fc1"), ("NN", 392, 1536, 384, "fc2"),
    ("NN", 392, 384, 384, "residual"), ("NT", 392, 384, 1536, "dz"),
    ("NN", 333, 200, 136, "all"), ("NT", 7, 13, 9, "all"), ("NT", 130, 96, 130, "dz"),
    ("TN", 5001, 72, 40, "all"), ("TN", 4096, 384, 384, "dz"), ("TN", 1000, 200, 136, "fc1"),
]


def _epilogue_kw(rng, kind, m, n):
    bias, res, zin = _f32(rng, n), _f32(rng, m, n), _f32(rng, m, n)
    return {"fc1": dict(bias=bias, act="gelu", save_z=True),
            "fc2": dict(bias=bias, residual=res),
            "residual": dict(residual=res),
            "dz": dict(act="gelu", z_in=zin, colsum=True),
            "all": dict(bias=bias, act="relu", save_z=True, colsum=True, residual=res)}[kind]


@pytest.mark.gpu
@pytest.mark.parametrize("form, rows, k, n, kind", _GEMM_F32_EPILOGUES)
def test_gemm_f32_epilogues_match_plain(cuda, form, rows, k, n, kind):
    """csrc/gemm_f32.cu's epilogues (bias, z saved, exact-erf GELU or ReLU,
    act'(z_in), column sums, the fp32 residual, in gemm's order) against
    the same formula over torch.matmul in fp32, within 1e-4 of each
    output's largest |value|; the column sums have one owner and a fixed
    order, so every output repeats bit for bit."""
    rng = np.random.default_rng(70)
    a, b, prod, layout = _gemm_f32_operands(rng, form, rows, k, n)
    kw = _epilogue_kw(rng, kind, prod.shape[0], n)
    got = _build.gemm_f32(a, b, **layout, **kw)
    got = got if isinstance(got, tuple) else (got,)
    v = prod + kw["bias"] if "bias" in kw else prod
    z = v
    if "z_in" in kw:
        zi = kw["z_in"]
        v = v * (0.5 * (1 + torch.erf(zi * 2 ** -0.5)) + zi * torch.exp(-0.5 * zi * zi)
                 * 0.3989422804014327)
    elif kw.get("act"):
        v = F.gelu(v) if kw["act"] == "gelu" else F.relu(v)
    cs = v.sum(0)
    want = [v + kw["residual"] if "residual" in kw else v]
    if kw.get("save_z"):
        want.append(z)
    if kw.get("colsum"):
        want.append(cs)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _within(g, w, F32_TOL, f"{kind} output {i}")
    again = _build.gemm_f32(a, b, **layout, **kw)
    for g, h in zip(got, again if isinstance(again, tuple) else (again,)):
        assert torch.equal(g, h)


@pytest.mark.gpu
@pytest.mark.parametrize("rows, d", [(392, 384), (1568, 768), (1001, 1024), (37, 1536)])
def test_ln_rows_and_act_f32_match_plain(cuda, rows, d):
    """ln_rows's fp32 form (fp32 in, fp32 out) against ln_fp32, and
    act_f32 against F.gelu / F.relu, in fp32."""
    rng = np.random.default_rng(71)
    x = _f32(rng, rows, d, scale=2.0)
    s, bias = _f32(rng, d, scale=0.1) + 1.0, _f32(rng, d, scale=0.1)
    y = _build.ln_rows(x, s, bias, 1e-5, out_dtype=torch.float32)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, ln_fp32(x, s, bias, 1e-5), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="takes fp32 rows"):
        _build.ln_rows(x.bfloat16(), s, bias, 1e-5, out_dtype=torch.float32)
    torch.testing.assert_close(_build.act_f32(x, "gelu"), F.gelu(x), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(_build.act_f32(x, "relu"), F.relu(x), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("rows, d", [(50176, 768), (392, 384), (1001, 1024)])
def test_ln_rows_bwd_f32_matches_plain(cuda, rows, d):
    """ln_rows_bwd's form (d), fp32 throughout (#3's and #4's tail in
    float32), against ln_bwd_fp32 + g with colsum(g), within 1e-4 of each
    output's largest |value|, and bit for bit on a second call."""
    rng = np.random.default_rng(72)
    x, dxn, g = _f32(rng, rows, d, scale=2.0), _f32(rng, rows, d), _f32(rng, rows, d)
    s = _f32(rng, d, scale=0.1) + 1.0
    got = _build.ln_rows_bwd(x, dxn, s, g, 1e-5, add_g=True, g_sum=True)
    dx, ds, db = ln_bwd_fp32(x, dxn, s, 1e-5)
    for name, a, w in zip(("dx", "dscale", "dbias", "colsum(g)"), got,
                          (dx + g, ds, db, g.sum(0))):
        _within(a, w, F32_TOL, name)
    for u, v in zip(got, _build.ln_rows_bwd(x, dxn, s, g, 1e-5, add_g=True, g_sum=True)):
        assert torch.equal(u, v)


def _f32_args(args):
    return tuple(t.float() for t in args)


#: (b, n, d, heads, f, n_actual): ViT-B/16's layer (a few images), ViT-S/16's
#: width, and a ragged one (n_actual < N; R = 150, not a multiple of 128).
_BLOCK_F32_SHAPES = [(4, 196, 768, 12, 3072, None), (4, 196, 384, 6, 1536, None),
                     (3, 50, 128, 2, 256, 37), (2, 196, 768, 12, 3072, 150)]


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, d, heads, f, n_actual", _BLOCK_F32_SHAPES)
def test_fused_blocks_f32_match_ref(cuda, b, n, d, heads, f, n_actual):
    """#1-#4 in fp32 against their plain versions within 1e-4 of each
    tensor's largest |value| (real rows of #1's output; #4's dx in full),
    each through its fp32 launch counter and none of the bf16 ones; the
    autograd Functions' gradients too."""
    rng = np.random.default_rng(73)
    attn = _f32_args(_attn_args(rng, b, n, d, heads, cuda))
    mlp = _f32_args(_mlp_args(rng, b, n, d, f, cuda))
    g = _f32(rng, b, n, d)
    real = n if n_actual is None else n_actual
    counters = [(fused_attention_block, "f32_launches"), (fused_attention_block, "f32_bwd_launches"),
                (fused_mlp_block, "f32_launches"), (fused_mlp_block, "f32_bwd_launches"),
                (fused_attention_block, "launches"), (fused_attention_block, "bwd_launches"),
                (fused_mlp_block, "launches"), (fused_mlp_block, "bwd_launches")]
    before = [getattr(o, k) for o, k in counters]
    with torch.no_grad():
        got = fused_attention_block(*attn, heads, n_actual=n_actual)
        _within(got[:, :real], attention_block_ref(*attn, heads, n_actual=n_actual)[:, :real],
                F32_TOL, "#1 out")
        _within(fused_mlp_block(*mlp), mlp_block_ref(*mlp), F32_TOL, "#2 out")
        out, qkv, att, lse = attention_block_train_fwd(*attn, heads, n_actual=n_actual)
        got4 = attention_block_bwd(attn[0], g, *attn[1:], qkv, att, lse, heads,
                                   n_actual=n_actual)
        want4 = attention_block_bwd_ref(attn[0], g, *attn[1:], qkv, att, lse, heads,
                                        n_actual=n_actual)
        for name, x, w in zip(("dx", "dls", "dlb", "dw_qkv", "dw_out"), got4, want4):
            _within(x, w, F32_TOL, f"#4 {name}")
        _, z = mlp_block_train_fwd(*mlp)
        got3 = mlp_block_bwd(mlp[0], g, *mlp[1:6], z, mlp[6])
        want3 = mlp_block_bwd_ref(mlp[0], g, *mlp[1:6], z, mlp[6])
        for name, x, w in zip(("dx", "dls", "dlb", "dw1", "db1", "dw2", "db2"), got3, want3):
            _within(x, w, F32_TOL, f"#3 {name}")
    after = [getattr(o, k) for o, k in counters]
    assert [a - c for a, c in zip(after, before)] == [2, 1, 2, 1, 0, 0, 0, 0]
    leaves = [t.clone().requires_grad_() for t in mlp]
    fused_mlp_block(*leaves).backward(g)
    for name, t, w in zip(("dx", "dls", "dlb", "dw1", "db1", "dw2", "db2"), leaves, want3):
        _within(t.grad, w, F32_TOL, f"#3 autograd {name}")


@pytest.mark.gpu
def test_attention_bwd_f32_unmasked_repeats_bit_for_bit(cuda):
    """#4's attention backward in fp32 (no mask) at ViT-B's 196 tokens with
    ragged keys, the same bits on a second call."""
    rng = np.random.default_rng(74)
    qkv, datt = _f32(rng, 8, 196, 3 * 768), _f32(rng, 8, 196, 768)
    att, lse = _build.attention_fwd(qkv, 12, 150, 0.125, with_lse=True)
    first = _build.attention_bwd(qkv, att, datt, lse, 12, 150, 0.125)
    assert torch.equal(first, _build.attention_bwd(qkv, att, datt, lse, 12, 150, 0.125))


@pytest.mark.gpu
def test_fused_blocks_refuse_fp16(cuda):
    """#1-#4 take bfloat16 and float32; float16 raises NotImplementedError
    before any launch, with no fall back to a plain version."""
    rng = np.random.default_rng(75)
    attn = tuple(t.half() if t.dtype == torch.bfloat16 else t
                 for t in _attn_args(rng, 1, 8, 128, 2, cuda))
    mlp = tuple(t.half() if t.dtype == torch.bfloat16 else t
                for t in _mlp_args(rng, 1, 8, 128, 256, cuda))
    before = (fused_attention_block.f32_launches, fused_mlp_block.f32_launches,
              fused_attention_block.launches, fused_mlp_block.launches)
    for fn, args in ((fused_attention_block, attn + (2,)), (fused_mlp_block, mlp)):
        with torch.no_grad(), pytest.raises(NotImplementedError, match="bfloat16 or float32"):
            fn(*args)
        leaves = [t.clone().requires_grad_() for t in args[:5]] + list(args[5:])
        with pytest.raises(NotImplementedError, match="bfloat16 or float32"):
            fn(*leaves)
    assert before == (fused_attention_block.f32_launches, fused_mlp_block.f32_launches,
                      fused_attention_block.launches, fused_mlp_block.launches)


@pytest.mark.gpu
def test_curvevit_f32_kernel_path_matches_plain_path(cuda):
    """A small fp32 CurveViT (the ViT-S/16 preset at its own dtype, cut to
    d 128, 2 heads of 64, depth 2, MLP 256) on the card: served through
    ServingEngine(dtype=None) through #1/#2's fp32 kernels and one train
    step through #1-#4's, each against the plain path, within 1e-4 of the
    largest |logit| and relative L2 1e-4 per gradient."""
    from unittest import mock

    import sfc_vit_tpu_torch.models.simple_vit as simple_vit
    from sfc_vit_tpu_torch.registry import build_model, preset_config
    from sfc_vit_tpu_torch.serving import ServingEngine

    cfg = preset_config("vit-s-16", img_size=28, patch_size=4, embed_dim=128, n_heads=2,
                        depth=2, mlp_dim=256, num_classes=10)
    assert cfg.dtype is None
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    plain = mock.patch.multiple(simple_vit, fused_attention_block=attention_block_ref,
                                fused_mlp_block=mlp_block_ref)
    engine = ServingEngine(model, None, (28, 28, 3), batch_sizes=(4, 8), device=cuda)
    images = np.random.default_rng(76).standard_normal((11, 28, 28, 3)).astype(np.float32)
    before = (fused_attention_block.f32_launches, fused_mlp_block.f32_launches)
    got = engine.predict(images)
    assert (fused_attention_block.f32_launches - before[0],
            fused_mlp_block.f32_launches - before[1]) == (2 * 2, 2 * 2)
    with plain:
        want = engine.predict(images)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()
    model.train()
    x = torch.from_numpy(images[:6]).to(cuda)
    grads = []
    for ctx in (contextlib.nullcontext(), plain):
        model.zero_grad()
        with ctx:
            model(x).square().sum().backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for g, w in zip(*grads):
        assert float((g - w).norm() / w.norm()) <= 1e-4
