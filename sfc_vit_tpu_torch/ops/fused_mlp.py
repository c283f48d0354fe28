"""Fused transformer-MLP block ``x + fc2(act(fc1(LN(x))))`` on Hopper,
forward and backward.

Counterpart of ``sfc_vit_tpu/ops/fused_mlp.py``.  The TPU kernels
``_mlp_kernel`` and ``_mlp_bwd_kernel`` run the whole block per row tile
with the hidden activation in VMEM; a Hopper block holds at most 227 KB
of shared memory, so here each is a chain of hand-written kernels
(``csrc/ln_rows.cu``, ``csrc/gemm_bf16.cu``, ``csrc/ln_rows_bwd.cu``).

Forward: ``ln_rows`` -> ``gemm`` (fc1, +b1, activation in fp32, one round
to bf16 -- the TPU kernel's rounding point; the training forward also
writes the pre-activation ``z`` rounded to bf16, the TPU's ``save_z``) ->
``gemm`` (fc2, +b2, +x in fp32, one round).

Backward (the TPU's ``with_z`` path, 4 GEMMs): ``ln_rows`` (recompute
xn) -> ``act_bf16`` (h = bf16(act(z))) -> ``gemm`` TN (dW2 = h^T g) ->
``gemm`` NT (dz = g W2^T * act'(z), db1 = colsum of the fp32 dz) ->
``gemm`` TN (dW1 = xn^T dz) -> ``gemm`` NT (dxn = dz W1^T, fp32) ->
``ln_rows_bwd`` (dx, dLN, db2 = colsum(g)).

The hidden ``[R, F]`` passes through L2/HBM between the GEMMs.

:func:`mlp_block_ref` is the plain forward, the counterpart of
``mlp_block_xla``: it rounds fc1's output to the input dtype before the
activation, as XLA's unfused graph does.  :func:`mlp_block_bwd_ref` is
the plain version of the backward kernel, with its rounding points.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import act_bf16, gemm, ln_rows, ln_rows_bwd
from .kernel_utils import ln_bwd_fp32, ln_fp32

__all__ = ["fused_mlp_block", "mlp_block_ref", "mlp_block_bwd_ref",
           "mlp_block_train_fwd", "mlp_block_bwd"]

_ACTIVATIONS = ("gelu", "relu")


def _check_activation(activation: str) -> None:
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unsupported activation {activation!r}")


def mlp_block_ref(x, ln_scale, ln_bias, w1, b1, w2, b2,
                  eps: float = 1e-5, activation: str = "gelu",
                  residual: bool = True) -> torch.Tensor:
    """Unfused formula (flax Dense/LayerNorm semantics), ``[B, N, D]``."""
    _check_activation(activation)
    xn = ln_fp32(x, ln_scale, ln_bias, eps)
    h = xn @ w1 + b1.to(x.dtype)
    h = F.gelu(h) if activation == "gelu" else F.relu(h)  # gelu: exact erf
    y = h @ w2 + b2.to(x.dtype)
    return x + y if residual else y


def _act_fp32(z: torch.Tensor, activation: str) -> torch.Tensor:
    return F.gelu(z) if activation == "gelu" else F.relu(z)


def _dact_fp32(z: torch.Tensor, activation: str) -> torch.Tensor:
    """act'(z); gelu' = Phi(z) + z * phi(z) (exact-erf gelu)."""
    if activation == "gelu":
        phi = torch.exp(z * z * -0.5) * 0.3989422804014327
        return 0.5 * (1.0 + torch.erf(z * 2.0 ** -0.5)) + z * phi
    return (z > 0.0).to(z.dtype)


def _z_ref(x, ln_scale, ln_bias, w1, b1, eps):
    """The training forward's saved pre-activation: fc1 summed in fp32
    with +b1, rounded once to the input dtype."""
    xn = ln_fp32(x, ln_scale, ln_bias, eps)
    return (xn.float() @ w1.float() + b1.float()).to(x.dtype)


def mlp_block_bwd_ref(x, g, ln_scale, ln_bias, w1, b1, w2, z, b2=None,
                      eps: float = 1e-5, activation: str = "gelu",
                      residual: bool = True):
    """Plain version of ``_mlp_bwd_kernel``'s ``with_z`` path.

    ``x``, ``g`` ``[B, N, D]``; ``z`` ``[B, N, F]`` is the saved
    pre-activation.  Products sum in fp32 over operands in the input
    dtype; ``h = act(z)`` and ``dz`` are rounded to it where the kernel
    rounds them.  Returns ``(dx, dln_scale, dln_bias, dw1, db1, dw2,
    db2)``, each in its input's dtype (``db2`` in ``b2``'s, or ``w2``'s
    when ``b2`` is None).
    """
    _check_activation(activation)
    d, f = w1.shape
    dt = x.dtype
    xn = ln_fp32(x, ln_scale, ln_bias, eps).reshape(-1, d).float()
    zf = z.reshape(-1, f).float()
    h = _act_fp32(zf, activation).to(dt).float()
    gf = g.reshape(-1, d).float()
    dw2 = h.T @ gf
    dz = (gf @ w2.float().T) * _dact_fp32(zf, activation)
    db1 = dz.sum(0)
    dzc = dz.to(dt).float()  # rounded where the backward GEMMs' operands round
    dw1 = xn.T @ dzc
    dxn = dzc @ w1.float().T
    dxf, dls, dlb = ln_bwd_fp32(x.reshape(-1, d), dxn, ln_scale, eps)
    if residual:
        dxf = dxf + gf
    return (dxf.to(dt).view(x.shape), dls.to(ln_scale.dtype),
            dlb.to(ln_bias.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
            dw2.to(w2.dtype), gf.sum(0).to((w2 if b2 is None else b2).dtype))


def _fwd_kernels(x, ln_scale, ln_bias, w1, b1, w2, b2, eps, activation,
                 residual, save_z):
    b, n, d = x.shape
    x2 = x.view(b * n, d)  # raises on a non-contiguous x
    xn = ln_rows(x2, ln_scale.float(), ln_bias.float(), eps)
    h = gemm(xn, w1, bias=b1.float(), act=activation, save_z=save_z)
    if save_z:
        h, z = h
    out = gemm(h, w2, bias=b2.float(), residual=x2 if residual else None)
    fused_mlp_block.launches += 1
    out = out.view(b, n, d)
    return (out, z.view(b, n, -1)) if save_z else out


def mlp_block_train_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2,
                        eps: float = 1e-5, activation: str = "gelu",
                        residual: bool = True):
    """The training forward, ``(out, z)`` with ``z`` the saved
    pre-activation (the TPU's ``save_z``).  Kernels for a CUDA ``x``;
    :func:`mlp_block_ref` and a plain ``z`` for a CPU one."""
    if x.device.type == "cpu":
        return (mlp_block_ref(x, ln_scale, ln_bias, w1, b1, w2, b2, eps,
                              activation, residual),
                _z_ref(x, ln_scale, ln_bias, w1, b1, eps))
    return _fwd_kernels(x, ln_scale, ln_bias, w1, b1, w2, b2, eps, activation,
                        residual, save_z=True)


def mlp_block_bwd(x, g, ln_scale, ln_bias, w1, b1, w2, z, b2=None,
                  eps: float = 1e-5, activation: str = "gelu",
                  residual: bool = True):
    """The backward from the saved ``z``, with the arguments and results
    of :func:`mlp_block_bwd_ref`, which it runs for a CPU ``x``.  A CUDA
    ``x`` launches the kernel chain (``fused_mlp_block.bwd_launches``
    counts it)."""
    if x.device.type == "cpu":
        return mlp_block_bwd_ref(x, g, ln_scale, ln_bias, w1, b1, w2, z, b2,
                                 eps, activation, residual)
    b, n, d = x.shape
    f = w1.shape[1]
    x2 = x.view(b * n, d)
    g2 = g.reshape(b * n, d).contiguous()
    z2 = z.view(b * n, f)
    lns = ln_scale.float()
    xn = ln_rows(x2, lns, ln_bias.float(), eps)
    h = act_bf16(z2, activation)
    dw2 = gemm(h, g2, trans_a=True)                         # [F, D]
    dz, db1 = gemm(g2, w2, trans_b=True, act=activation, z_in=z2,
                   colsum=True)                             # [R, F]
    dw1 = gemm(xn, dz, trans_a=True)                        # [D, F]
    dxn = gemm(dz, w1, trans_b=True, out_dtype=torch.float32)  # [R, D]
    dx, dls, dlb, db2 = ln_rows_bwd(x2, dxn, lns, g2, eps, add_g=residual,
                                    g_sum=True)
    fused_mlp_block.bwd_launches += 1
    return (dx.view(b, n, d), dls.to(ln_scale.dtype), dlb.to(ln_bias.dtype),
            dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to((w2 if b2 is None else b2).dtype))


class _FusedMLP(torch.autograd.Function):
    """Kernels #2 and #3 as one differentiable op: the forward saves x,
    the LN params, the weights and z (as ``_fm_fwd`` does); the backward
    is :func:`mlp_block_bwd`."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, eps, activation,
                residual):
        out, z = mlp_block_train_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                     eps, activation, residual)
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2, z)
        ctx.config = (eps, activation, residual)
        return out

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, w1, b1, w2, b2, z = ctx.saved_tensors
        eps, activation, residual = ctx.config
        grads = mlp_block_bwd(x, g.to(x.dtype), ln_scale, ln_bias, w1, b1, w2,
                              z, b2, eps, activation, residual)
        return (*grads, None, None, None)


def fused_mlp_block(x, ln_scale, ln_bias, w1, b1, w2, b2,
                    eps: float = 1e-5, activation: str = "gelu",
                    residual: bool = True) -> torch.Tensor:
    """``x + fc2(act(fc1(LN(x))))`` ([B, N, D] in and out), differentiable.

    A CPU ``x`` runs :func:`mlp_block_ref` (and, under autograd,
    :func:`mlp_block_bwd_ref` for the backward).  A CUDA ``x`` launches
    the kernels (bf16, Dense kernels ``[in, out]``) or raises; it never
    falls back.  ``fused_mlp_block.launches`` counts the CUDA forwards
    and ``fused_mlp_block.bwd_launches`` the CUDA backwards.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mlp_block: no kernel for device {x.device}")
    _check_activation(activation)
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedMLP.apply(*args, eps, activation, residual)
    if x.device.type == "cpu":
        return mlp_block_ref(*args, eps=eps, activation=activation,
                             residual=residual)
    return _fwd_kernels(*args, eps, activation, residual, save_z=False)


fused_mlp_block.launches = 0
fused_mlp_block.bwd_launches = 0
