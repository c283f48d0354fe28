"""The port's CUDA kernels against their plain PyTorch versions.

Tests marked ``gpu`` need an NVIDIA GPU (sm_90a) and nvcc; they skip
elsewhere.  Run them on the card with::

    python -m pytest tests/test_torch_kernels.py -q

The other tests check the launchers' argument validation and the build's
failure path, which need no card.  This file imports no JAX, so it runs
unchanged on a machine that has only PyTorch.
"""

import os
import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sfc_vit_tpu_torch.ops import _build
from sfc_vit_tpu_torch.ops.fused_attention_block import (
    attention_block_ref,
    fused_attention_block,
)
from sfc_vit_tpu_torch.ops.fused_mlp import fused_mlp_block, mlp_block_ref
from sfc_vit_tpu_torch.ops.kernel_utils import ln_fp32

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


def test_attention_rejects_head_dim_other_than_64():
    qkv = torch.zeros(1, 4, 3 * 2 * 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="takes 64"):
        _build.attention_fwd(qkv, heads=2, n_valid=4, scale=1.0)


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


@pytest.mark.gpu
@pytest.mark.parametrize("b, n, heads, n_valid", [
    (2, 64, 2, 49), (3, 196, 2, 196), (2, 196, 12, 150), (1, 1, 1, 1),
    (1, 1024, 2, 1000),
])
def test_attention_fwd_matches_plain(cuda, b, n, heads, n_valid):
    rng = np.random.default_rng(3)
    qkv = _randn(rng, b, n, 3 * heads * 64)
    got = _build.attention_fwd(qkv, heads, n_valid, 64 ** -0.5)
    want = _attention_plain(qkv, heads, n_valid, 64 ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), **ONE_ROUND_TOL)


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
def test_grad_inputs_raise(cuda):
    args = _mlp_args(np.random.default_rng(6), 1, 4, 16, 32, cuda)
    w = args[3].clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="backward"):
        fused_mlp_block(args[0], args[1], args[2], w, *args[4:])
    aargs = list(_attn_args(np.random.default_rng(6), 1, 4, 128, 2, cuda))
    aargs[0].requires_grad_()
    with pytest.raises(NotImplementedError, match="backward"):
        fused_attention_block(*aargs, heads=2)


@pytest.mark.gpu
def test_fp32_cuda_input_raises(cuda):
    args = tuple(t.float() for t in _mlp_args(np.random.default_rng(7),
                                              1, 4, 16, 32, cuda))
    with pytest.raises(ValueError, match="bfloat16"):
        fused_mlp_block(*args)


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
