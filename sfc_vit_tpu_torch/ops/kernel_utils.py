"""Shared helpers for the port's kernels and their plain versions.

Counterpart of ``sfc_vit_tpu/ops/kernel_utils.py``; the Mosaic-only
helpers there (lane broadcasts, VMEM unroll estimates) have no use here.
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "ln_fp32", "ln_bwd_fp32", "round_up", "n_valid",
           "split_heads", "kernel_is_f32", "tf32_round",
           "tf32_trunc", "tf32_split", "matmul_3xtf32", "colsum_fixed_order"]

#: Masked-logit value: -1e30, never -inf, so a masked softmax gives 0
#: weights and no NaN.
NEG_INF = -1e30


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def n_valid(n: int, n_actual) -> int:
    """Keys a softmax sees under the ``n_actual`` contract: those before
    ``n_actual`` (all ``n`` when it is None)."""
    return n if n_actual is None else min(n_actual, n)


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, N, H*Dh] -> fp32 [B, H, N, Dh]."""
    b, n, w = t.shape
    return t.view(b, n, heads, w // heads).transpose(1, 2).float()


def kernel_is_f32(what: str, dtype: torch.dtype) -> bool:
    """Which kernels a CUDA tensor of ``dtype`` launches for #1-#7, #14
    and the post-norm tail #15/#16: True for float32 (the fp32 kernels:
    3xTF32 products on the tensor cores in ``csrc/gemm_f32.cu``, the
    attention and the tokenizer, the fp32 forms of ``ln_rows`` and
    ``ln_rows_bwd``), False for bfloat16 (the Hopper ``wgmma`` kernels).
    Any other dtype raises; nothing falls back to a plain version."""
    if dtype == torch.float32:
        return True
    if dtype == torch.bfloat16:
        return False
    raise NotImplementedError(
        f"{what}: no kernel computes in {dtype}; the kernels take bfloat16 or "
        "float32")


def ln_fp32(v: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """flax ``nn.LayerNorm`` semantics over the last axis: fp32 stats with
    the clamped fast-variance form (E[x^2] - E[x]^2), scale and bias in
    fp32, rounded back to the input dtype.

    The arithmetic of the ``ln_rows`` kernel; use this, not
    ``F.layer_norm`` (two-pass variance), wherever the port normalises.
    """
    vf = v.float()
    mean = vf.mean(dim=-1, keepdim=True)
    var = ((vf * vf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    vn = (vf - mean) * torch.rsqrt(var + eps)
    return (vn * scale.float() + bias.float()).to(v.dtype)


def ln_bwd_fp32(x: torch.Tensor, dxn: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5):
    """Backward of :func:`ln_fp32` from the fp32 cotangent ``dxn`` of its
    output, with the backward kernels' arithmetic: the statistics are
    recomputed from ``x``, ``dxh = dxn * scale`` and
    ``dx = inv * (dxh - mean(dxh) - xhat * mean(dxh * xhat))``.

    Returns ``(dx, dscale, dbias)`` in fp32; the sums run over every
    leading axis.  The plain version of ``csrc/ln_rows_bwd.cu``.
    """
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mean) * inv
    dxh = dxn * scale.float()
    m1 = dxh.mean(dim=-1, keepdim=True)
    m2 = (dxh * xhat).mean(dim=-1, keepdim=True)
    dx = inv * (dxh - m1 - xhat * m2)
    lead = tuple(range(x.dim() - 1))
    return dx, (dxn * xhat).sum(dim=lead), dxn.sum(dim=lead)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32``
    rounds it: to nearest, ties away from zero, on the bit pattern (add half
    of the 13 dropped bits' unit to the magnitude, clear them), so a carry
    moves up a binade and past the largest finite value to inf; subnormals
    keep their 13-bit grid.  Inf and NaN have the 13 bits cleared, not
    rounded (a NaN whose payload lies only there becomes inf), as the H100
    does.  fp32 out, the low 13 bits zero."""
    bits = x.float().contiguous().view(torch.int32)
    special = (bits & 0x7F800000) == 0x7F800000
    return ((torch.where(special, bits, bits + 0x1000)) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores take of an fp32 operand: its top 19 bits, the
    13 below TF32's mantissa cleared (the H100; ``tests/test_torch_kernels.py``
    shows it with ``_build.wgmma_probe_tf32``)."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """``x = big + small`` as ``csrc/gemm_f32.cu`` splits each fp32 operand:
    big = tf32(x) (:func:`tf32_round`'s bits for every finite x), small =
    x - big, exact in fp32 and left unrounded (the tensor cores drop its 13
    low bits: :func:`tf32_trunc`)."""
    x = x.float()
    big = tf32_round(x)
    return big, x - big


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain twin of ``csrc/gemm_f32.cu``'s product: ``a @ b`` (fp32
    [M, K] and [K, N]) from the split of each operand as the tensor cores
    see it, a_big b_small + a_small b_big + a_big b_big with each small
    part truncated to TF32, each term and their sum in fp64, so that what
    differs from the exact product is the split's error alone (within
    1.25 x 2^-20 of |a| @ |b|: ``tests/test_torch_tf32_split.py``).  fp64
    out; the kernel sums the same terms in fp32."""
    ab, as_ = tf32_split(a)
    bb, bs = tf32_split(b)
    ab, as_, bb, bs = ab.double(), tf32_trunc(as_).double(), bb.double(), tf32_trunc(bs).double()
    return ab @ bs + as_ @ bb + ab @ bb


def colsum_fixed_order(x: torch.Tensor, plan) -> torch.Tensor:
    """The fp32 column sums of ``x`` [R, C] (bf16 or fp32) added in
    ``csrc/colsum_bf16.cu``'s order under ``plan``
    (``ops/_build.py::colsum_plan``), so that the card's sums equal it bit
    for bit (fp32 adds round the same everywhere).  Per block (chunk,
    slice): row lane j of the block's L = 256 / lanes sums rows j, j + L,
    ... of the slice from 0 in turn; each warp's 32 / lanes row lanes meet
    in a butterfly (the first half plus the second, halving); the 8 warps
    are added in warp order.  Then the slices (``csrc/common.cuh``'s
    ``slice_sum_kernel``): warp w of 32 sums slices w, w + 32, ... from 0
    and the 32 warp sums are added in warp order.  Rows past a slice's end add
    -0.0, which leaves every sum's bits as they are.  Runs on any device."""
    rows, cols = x.shape
    lanes, slices, per = plan
    rw = 32 // lanes
    lanes_all = 8 * rw
    width = round_up(cols, 8 * lanes)
    steps = round_up(per, lanes_all) // lanes_all
    xs = torch.full((slices * per, width), -0.0, dtype=torch.float32, device=x.device)
    xs[:rows, :cols] = x.float()
    xs = xs.view(slices, per, width)
    if steps * lanes_all > per:
        xs = torch.cat([xs, xs.new_full((slices, steps * lanes_all - per, width), -0.0)], 1)
    xs = xs.view(slices, steps, lanes_all, width)
    acc = torch.zeros((slices, lanes_all, width), dtype=torch.float32, device=x.device)
    for i in range(steps):
        acc = acc + xs[:, i]
    v = acc.view(slices, 8, rw, width)
    h = rw
    while h > 1:
        h //= 2
        v = v[:, :, :h] + v[:, :, h:2 * h]
    v = v[:, :, 0]
    part = v[:, 0]
    for w in range(1, 8):
        part = part + v[:, w]
    groups = round_up(slices, 32) // 32
    pad = part.new_full((groups * 32 - slices, width), -0.0)
    p = torch.cat([part, pad]).view(groups, 32, width)
    t = torch.zeros((32, width), dtype=torch.float32, device=x.device)
    for g in range(groups):
        t = t + p[g]
    out = t[0]
    for w in range(1, 32):
        out = out + t[w]
    return out[:cols]
