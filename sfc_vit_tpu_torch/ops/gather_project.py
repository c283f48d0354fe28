"""Fused curve gather + projection (#14): the patch embedding of the fused
tokenizers.

Counterpart of ``sfc_vit_tpu/ops/gather_project.py``.  ``out[:, i] =
concat_p x[:, lut[i * group + p]] @ w + b``: every tokenizer's curve
reorder is a gather by a static LUT followed by a Dense projection, and
the kernel does both without writing the reordered [B, M * group, K]
tensor to device memory.

  * #14 ``_kernel`` -> ``csrc/gather_project.cu`` (:func:`gather_project`):
    the group curve-consecutive rows of each output token concatenated
    slot-major (feature ``p * K + kk`` multiplies ``w[p * K + kk]``), the
    product summed in fp32, the bias added in fp32, one rounding.  The TPU
    kernel's one-hot matmul is Mosaic's workaround for unaligned dynamic
    indexing; the Hopper kernel, persistent over (64 tokens, image, 256
    columns) items, brings each image's x into shared memory by one bulk
    copy and gathers it there through the LUT (from global memory where
    an image is large or not a multiple of 16 bytes), then multiplies by
    ``wgmma`` and writes the tile by TMA store.
  * in float32 (the 2-D and 1-D tokenizers' fused forms and the
    hierarchical levels when the model computes in fp32) ->
    ``csrc/gather_project_f32.cu``: the same persistent structure over
    (64 tokens, image, 64 or 32 columns) items, the product on the tensor
    cores as three TF32 products (3xTF32: W split into big and small TF32
    parts once a block, K-major; the gathered rows read through the LUT
    from the staged image into registers and split there), within 2^-19
    of |x| @ |w| of the exact product, the bias added to the fp32 sum.

:func:`gather_project_ref` is the kernel's plain version, in the kernel's
order; :func:`gather_project_xla` is JAX's XLA twin, which rounds the
product *before* adding the bias: in bf16 the two differ by that one
rounding.  The backward is plain PyTorch, as JAX's ``_gp_bwd`` is plain
XLA: dW and db in fp32, dx scattered back through the LUT with
``index_add_``, which holds for repeated indices too.

A CPU tensor runs :func:`gather_project_ref`; a CUDA tensor launches a
kernel (bfloat16 or float32) or raises.  ``gather_project.launches``
counts the bf16 launches, ``gather_project.f32_launches`` the fp32 ones.
The LUT's entries must lie in ``[0, N)``: the kernels read through them
unchecked, as the tokenizers' static LUTs are checked once when they are
built.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .kernel_utils import kernel_is_f32

__all__ = ["gather_project", "gather_project_ref", "gather_project_xla"]


def _grouped(x: torch.Tensor, lut: torch.Tensor, group: int) -> torch.Tensor:
    """[B, N, K] -> the gathered, grouped [B, M, group * K] (slot-major)."""
    g = x.index_select(1, lut)
    return g.reshape(x.shape[0], lut.numel() // group, group * x.shape[2])


def gather_project_xla(x: torch.Tensor, lut: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor] = None, group: int = 1) -> torch.Tensor:
    """JAX's reference path: gather, group, fp32 product rounded to the
    input dtype, *then* the bias added in that dtype."""
    out = (_grouped(x, lut, group).float() @ w.float()).to(x.dtype)
    return out if b is None else out + b.to(out.dtype)


def gather_project_ref(x: torch.Tensor, lut: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor] = None, group: int = 1) -> torch.Tensor:
    """Plain version of #14, in the kernel's order: gather, group
    slot-major, fp32 product, the bias added in fp32, one rounding."""
    acc = _grouped(x, lut, group).float() @ w.float()
    if b is not None:
        acc = acc + b.float()
    return acc.to(x.dtype)


def _launch(x, lut, w, b, group: int) -> torch.Tensor:
    """#14: the kernel for a CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cpu":
        return gather_project_ref(x, lut, w, b, group)
    if x.device.type != "cuda":
        raise ValueError(f"gather_project: no kernel for device {x.device}")
    f32 = kernel_is_f32("gather_project", x.dtype)
    out = _build.gather_project(x.contiguous(), lut.to(torch.int32).contiguous(),
                                w.contiguous(), None if b is None else b.contiguous(), group)
    if f32:
        gather_project.f32_launches += 1
    else:
        gather_project.launches += 1
    return out


class _GatherProject(torch.autograd.Function):
    """#14 forward; JAX's ``_gp_bwd`` backward in plain PyTorch."""

    @staticmethod
    def forward(ctx, x, lut, w, b, group):
        ctx.save_for_backward(x, lut, w)
        ctx.group, ctx.has_bias = group, b is not None
        ctx.b_dtype = None if b is None else b.dtype
        return _launch(x, lut, w, b, group)

    @staticmethod
    def backward(ctx, g):
        x, lut, w = ctx.saved_tensors
        bsz, n, k = x.shape
        g32 = g.float()
        xg = _grouped(x, lut, ctx.group).float()
        dw = (xg.reshape(-1, xg.shape[-1]).T @ g32.reshape(-1, g32.shape[-1])).to(w.dtype)
        db = g32.sum(dim=(0, 1)).to(ctx.b_dtype) if ctx.has_bias else None
        dxg = (g32 @ w.float().T).reshape(bsz, lut.numel(), k)
        dx = torch.zeros((bsz, n, k), dtype=torch.float32, device=x.device)
        dx.index_add_(1, lut, dxg)
        return dx.to(x.dtype), None, dw, db, None


def gather_project(x: torch.Tensor, lut: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor] = None, group: int = 1) -> torch.Tensor:
    """``out[:, i] = concat_p x[:, lut[i * group + p]] @ w + b``,
    differentiable in ``x``, ``w`` and ``b``.

    Args:
        x: [B, N, K] token features.
        lut: [M * group] integer gather indices into N (a permutation for
            the curve reorders; repeats allowed).
        w: [group * K, D] projection over the grouped rows.
        b: optional [D] bias.
        group: curve-consecutive rows concatenated per output token.

    Returns [B, M, D] in ``x``'s dtype.
    """
    if group < 1 or lut.numel() % group:
        raise ValueError(f"gather_project: {lut.numel()} LUT entries for group {group}")
    if w.shape[0] != group * x.shape[2]:
        raise ValueError(f"gather_project: w has {w.shape[0]} rows, the grouped rows "
                         f"{group * x.shape[2]} features")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        return _GatherProject.apply(x, lut, w, b, group)
    return _launch(x, lut, w, b, group)


gather_project.launches = 0
gather_project.f32_launches = 0
