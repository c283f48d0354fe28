"""Fused transformer-MLP block ``x + fc2(act(fc1(LN(x))))`` and family A's
post-norm layer tail on Hopper, forward and backward.

Counterpart of ``sfc_vit_tpu/ops/fused_mlp.py``.  The TPU kernels
``_mlp_kernel`` and ``_mlp_bwd_kernel`` run the whole block per row tile
with the hidden activation in VMEM; a Hopper block holds at most 227 KB
of shared memory, so here each is a chain of hand-written kernels
(``csrc/ln_rows.cu``, ``csrc/gemm_bf16.cu``, ``csrc/ln_rows_bwd.cu``), in
bf16 or in float32 (the ViT-B/16 and ViT-S/16 presets at their own
dtype): the same chain on the fp32 forms of ``ln_rows`` and
``ln_rows_bwd``, on ``csrc/gemm_f32.cu`` (3xTF32 on the tensor cores,
with the same epilogues: bias, exact-erf GELU or ReLU, z saved, act'(z),
fixed-order column sums, the fp32 residual) and its ``act_f32``, nothing
rounded.  ``kernel_utils.kernel_is_f32`` picks the chain; any other dtype
raises before a launch.  The description below is the bf16 chain's.

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

The post-norm tail (``_postnorm_tail_kernel`` #15 and
``_postnorm_tail_bwd_kernel`` #16) is everything of torch's
``nn.TransformerEncoderLayer`` after the attention:
``LN2(x2 + fc2(act(fc1(x2))))`` with ``x2 = LN1(x + attn)``.  On the TPU
each is one kernel per 256-row tile holding both weights in VMEM; at
D = 768, F = 1024 they do not fit a Hopper block, so each is a chain:

Forward (#15): ``ln_rows`` over the fp32 sum ``s1 = x + attn`` (``x2``
rounded for fc1, ``x2f`` kept in fp32) -> ``gemm`` (fc1, +b1, activation
in fp32, one rounding; the training form also writes ``z`` rounded) ->
``gemm_layernorm`` (fc2, +b2, + the fp32 ``x2f`` into the fp32 ``s2``, and
LN2 of each row of it in the same kernel: the row's 128-column tiles run as
one thread-block cluster and add their partial sums in rank order, so
``s2`` never passes through device memory in fp32; the output rounded
once, the training form also writes ``s2`` rounded).  There ``ln_rows``
saves each row's mean and rsqrt instead of the fp32 ``x2f``, and the
epilogue rebuilds ``x2f`` from x, attn and them, the same bits.  Where D is
not a whole number of 128-column tiles or needs a cluster of more than 8
(:func:`tail_fc2_route`), fc2 and LN2 are two launches instead: ``ln_rows``
also writes ``x2f``, ``gemm`` (the fp32 ``s2``) -> ``ln_rows`` over it.

Backward (#16, from the saved ``z`` and ``s2``, no recomputed GEMM):
``ln_rows_bwd`` over the bf16 ``s2`` and the bf16 cotangent (dLN2, the
fp32 ``ds2``, its rounding and ``db2 = colsum(ds2)``) -> ``act_bf16`` (h)
-> ``gemm`` TN (dW2 = h^T ds2) -> ``gemm`` NT (dz = ds2 W2^T * act'(z),
db1 = colsum of the fp32 dz) -> ``ln_rows`` (recompute x2) -> ``gemm`` TN
(dW1 = x2^T dz) -> ``gemm`` NT (dx2 = dz W1^T + the fp32 ds2, kept in
fp32) -> ``ln_rows_bwd`` over ``x + attn`` (dLN1 and the one cotangent
``ds`` of both x and attn).

In float32 (the flagship and ``'hier'`` at their presets' own dtype) both
are the same chains with nothing rounded, so ``x2`` and ``x2f`` are one
tensor: #15 is ``ln_rows`` over the fp32 ``x + attn`` -> ``gemm_f32`` (fc1,
+b1, relu; z saved) -> ``gemm_f32`` (fc2, +b2, + x2 into the fp32 ``s2``)
-> ``ln_rows`` over ``s2`` (two launches for fc2 and LN2 at every width:
no fp32 cluster form yet); #16 is ``ln_rows_bwd`` form (d) over ``s2`` (ds2,
dLN2, db2 = its column sums) -> ``act_f32`` -> ``gemm_f32`` TN (dW2) ->
NT (dz with db1) -> ``ln_rows`` (x2 again) -> TN (dW1) -> NT (dx2 + ds2)
-> ``ln_rows_bwd`` form (e) over ``x + attn``.

:func:`postnorm_tail_ref` is the plain unfused forward, the counterpart
of ``postnorm_tail_xla`` (each sum rounded as flax's layers round it);
:func:`postnorm_tail_kernel_ref` and :func:`postnorm_tail_bwd_ref` are
the plain versions of #15 and #16 with the kernels' rounding points.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import (act_bf16, act_f32, gemm, gemm_f32, gemm_layernorm, gemm_layernorm_fits,
                     ln_rows, ln_rows_bwd)
from .kernel_utils import kernel_is_f32, ln_bwd_fp32, ln_fp32

__all__ = ["fused_mlp_block", "mlp_block_ref", "mlp_block_bwd_ref",
           "mlp_block_train_fwd", "mlp_block_bwd", "fused_postnorm_tail",
           "postnorm_tail_ref", "postnorm_tail_kernel_ref", "postnorm_tail_bwd_ref",
           "postnorm_tail_train_fwd", "postnorm_tail_bwd", "tail_fc2_route"]

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
    f32 = kernel_is_f32("fused_mlp_block", x.dtype)
    mm = gemm_f32 if f32 else gemm
    b, n, d = x.shape
    x2 = x.view(b * n, d)  # raises on a non-contiguous x
    xn = ln_rows(x2, ln_scale.float(), ln_bias.float(), eps, out_dtype=x.dtype)
    h = mm(xn, w1, bias=b1.float(), act=activation, save_z=save_z)
    if save_z:
        h, z = h
    out = mm(h, w2, bias=b2.float(), residual=x2 if residual else None)
    if f32:
        fused_mlp_block.f32_launches += 1
    else:
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
    ``x`` launches the kernel chain, bf16 or fp32
    (``fused_mlp_block.bwd_launches`` and ``.f32_bwd_launches`` count
    them)."""
    if x.device.type == "cpu":
        return mlp_block_bwd_ref(x, g, ln_scale, ln_bias, w1, b1, w2, z, b2,
                                 eps, activation, residual)
    f32 = kernel_is_f32("fused_mlp_block", x.dtype)
    mm = gemm_f32 if f32 else gemm
    b, n, d = x.shape
    f = w1.shape[1]
    x2 = x.view(b * n, d)
    g2 = g.reshape(b * n, d).contiguous()
    z2 = z.view(b * n, f)
    lns = ln_scale.float()
    xn = ln_rows(x2, lns, ln_bias.float(), eps, out_dtype=x.dtype)
    h = (act_f32 if f32 else act_bf16)(z2, activation)
    dw2 = mm(h, g2, trans_a=True)                           # [F, D]
    del h
    dz, db1 = mm(g2, w2, trans_b=True, act=activation, z_in=z2,
                 colsum=True)                               # [R, F]
    dw1 = mm(xn, dz, trans_a=True)                          # [D, F]
    dxn = mm(dz, w1, trans_b=True, out_dtype=torch.float32)  # [R, D]
    del dz
    dx, dls, dlb, db2 = ln_rows_bwd(x2, dxn, lns, g2, eps, add_g=residual,
                                    g_sum=True)
    if f32:
        fused_mlp_block.f32_bwd_launches += 1
    else:
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
    the kernels (bf16 or fp32, every tensor in x's dtype apart from the
    fp32 LayerNorm parameters; Dense kernels ``[in, out]``) or raises, any
    other dtype before a launch; it never falls back.
    ``fused_mlp_block.launches`` and ``.bwd_launches`` count the bf16 CUDA
    forwards and backwards, ``.f32_launches`` and ``.f32_bwd_launches``
    the fp32 ones.
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
fused_mlp_block.f32_launches = 0
fused_mlp_block.f32_bwd_launches = 0


# -- the post-norm layer tail (#15, #16) ------------------------------------


def postnorm_tail_ref(x, attn, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b,
                      eps: float = 1e-5, activation: str = "relu") -> torch.Tensor:
    """Unfused formula, the counterpart of ``postnorm_tail_xla``: every sum
    and product rounded to the input dtype, as flax's LayerNorm and Dense
    round them."""
    _check_activation(activation)
    dt = x.dtype
    x2 = ln_fp32(x + attn, ln1_s, ln1_b, eps)
    h = _act_fp32(x2 @ w1 + b1.to(dt), activation)
    y = h @ w2 + b2.to(dt)
    return ln_fp32(x2 + y, ln2_s, ln2_b, eps)


def postnorm_tail_kernel_ref(x, attn, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s,
                             ln2_b, eps: float = 1e-5, activation: str = "relu",
                             save_acts: bool = False):
    """Plain version of ``_postnorm_tail_kernel`` (#15) with its rounding
    points: ``s1 = x + attn`` in fp32, never rounded; ``x2f = LN1(s1)``
    in fp32 and ``x2`` its rounding; fc1 summed in fp32 with +b1 through
    the activation, then rounded (``h``); ``s2 = h W2 + b2 + x2f`` in
    fp32; the output ``LN2(s2)`` rounded once.  With ``save_acts`` it
    returns ``(out, z, s2)``, z and s2 rounded to the input dtype."""
    _check_activation(activation)
    dt = x.dtype
    x2f = ln_fp32(x.float() + attn.float(), ln1_s, ln1_b, eps)
    z = x2f.to(dt).float() @ w1.float() + b1.float()
    h = _act_fp32(z, activation).to(dt).float()
    s2 = h @ w2.float() + b2.float() + x2f
    out = ln_fp32(s2, ln2_s, ln2_b, eps).to(dt)
    return (out, z.to(dt), s2.to(dt)) if save_acts else out


def postnorm_tail_bwd_ref(x, attn, g, z, s2, ln1_s, ln1_b, w1, b1, w2, ln2_s,
                          ln2_b, b2=None, eps: float = 1e-5,
                          activation: str = "relu"):
    """Plain version of ``_postnorm_tail_bwd_kernel`` (#16) from what the
    training forward saved (``z`` [.., F] and ``s2`` [.., D], rounded).

    LN1's statistics come again from ``x + attn`` (fp32) and LN2's from
    the saved ``s2``; ``ds2`` (LN2's backward) stays fp32 for ``db2`` and
    for the residual into ``dx2``, and is rounded as the GEMMs' operand;
    ``dz`` likewise.  Returns ``(ds, dln1_s, dln1_b, dw1, db1, dw2, db2,
    dln2_s, dln2_b)``: ``ds`` is the one cotangent of both ``x`` and
    ``attn``; each result in its input's dtype (``db2`` in ``b2``'s, or
    ``w2``'s when ``b2`` is None), every sum over the rows in fp32."""
    _check_activation(activation)
    d, f = w1.shape
    dt = x.dtype
    s1 = x.reshape(-1, d).float() + attn.reshape(-1, d).float()
    x2 = ln_fp32(s1, ln1_s, ln1_b, eps).to(dt).float()
    zf = z.reshape(-1, f).float()
    h = _act_fp32(zf, activation).to(dt).float()
    ds2, dls2, dlb2 = ln_bwd_fp32(s2.reshape(-1, d), g.reshape(-1, d).float(),
                                  ln2_s, eps)
    ds2b = ds2.to(dt).float()
    dw2 = h.T @ ds2b
    dz = (ds2b @ w2.float().T) * _dact_fp32(zf, activation)
    dzc = dz.to(dt).float()
    dw1 = x2.T @ dzc
    dx2 = dzc @ w1.float().T + ds2
    ds, dls1, dlb1 = ln_bwd_fp32(s1, dx2, ln1_s, eps)
    return (ds.to(dt).view(x.shape), dls1.to(ln1_s.dtype), dlb1.to(ln1_b.dtype),
            dw1.to(w1.dtype), dz.sum(0).to(b1.dtype), dw2.to(w2.dtype),
            ds2.sum(0).to((w2 if b2 is None else b2).dtype), dls2.to(ln2_s.dtype),
            dlb2.to(ln2_b.dtype))


def tail_fc2_route(d: int) -> str:
    """How #15 runs fc2 and LN2 at width ``d``: ``"cluster"`` (one
    ``gemm_layernorm`` launch, a thread-block cluster per row stripe) where
    ``d`` is whole 128-column tiles, at most 8 of them; else ``"chain"``
    (``gemm`` into the fp32 ``s2``, then ``ln_rows``).  Both compute the
    same formula; the shape alone picks."""
    return "cluster" if gemm_layernorm_fits(d) else "chain"


def _tail_kernels_f32(x2d, a2d, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b, eps,
                      activation, save_acts):
    """#15's float32 chain over rows [R, D]: ``out``, or ``(out, z, s2)``."""
    x2 = ln_rows(x2d, ln1_s.float(), ln1_b.float(), eps, x_b=a2d, out_dtype=torch.float32)
    h = gemm_f32(x2, w1, bias=b1.float(), act=activation, save_z=save_acts)
    if save_acts:
        h, z = h
    s2 = gemm_f32(h, w2, bias=b2.float(), residual=x2)
    del h, x2
    out = ln_rows(s2, ln2_s.float(), ln2_b.float(), eps, out_dtype=torch.float32)
    return (out, z, s2) if save_acts else out


def _tail_kernels(x, attn, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b, eps,
                  activation, save_acts):
    b, n, d = x.shape
    x2d = x.reshape(b * n, d).contiguous()
    a2d = attn.reshape(b * n, d).contiguous()
    if kernel_is_f32("fused_postnorm_tail", x.dtype):
        out = _tail_kernels_f32(x2d, a2d, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b, eps,
                                activation, save_acts)
        if not save_acts:
            fused_postnorm_tail.f32_launches += 1
            return out.view(b, n, d)
        fused_postnorm_tail.f32_train_launches += 1
        out, z, s2 = out
        return out.view(b, n, d), z.view(b, n, -1), s2.view(b, n, d)
    cluster = tail_fc2_route(d) == "cluster"
    l1s, l1b = ln1_s.float(), ln1_b.float()
    # The cluster form rebuilds LN1's fp32 output x2f from the row stats;
    # the chain reads it from device memory.
    x2, x2r = ln_rows(x2d, l1s, l1b, eps, x_b=a2d, with_f32=not cluster,
                      with_stats=cluster)
    h = gemm(x2, w1, bias=b1.float(), act=activation, save_z=save_acts)
    if save_acts:
        h, z = h
    del x2
    if cluster:
        out = gemm_layernorm(h, w2, b2.float(), x2d, a2d, x2r, l1s, l1b, ln2_s.float(),
                             ln2_b.float(), eps, save_input=save_acts)
    else:
        s2 = gemm(h, w2, bias=b2.float(), residual_f32=x2r, out_dtype=torch.float32)
        out = ln_rows(s2, ln2_s.float(), ln2_b.float(), eps, with_rounded_input=save_acts)
        del s2
    del h, x2r
    if not save_acts:
        fused_postnorm_tail.launches += 1
        return out.view(b, n, d)
    fused_postnorm_tail.train_launches += 1
    out, s2b = out
    return out.view(b, n, d), z.view(b, n, -1), s2b.view(b, n, d)


def postnorm_tail_train_fwd(x, attn, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b,
                            eps: float = 1e-5, activation: str = "relu"):
    """#15's training form, ``(out, z, s2)``: the kernels for a CUDA ``x``
    (``fused_postnorm_tail.train_launches`` counts the bf16 ones,
    ``.f32_train_launches`` the fp32 ones), :func:`postnorm_tail_kernel_ref`
    for a CPU one."""
    args = (x, attn, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b)
    if x.device.type == "cpu":
        return postnorm_tail_kernel_ref(*args, eps, activation, save_acts=True)
    return _tail_kernels(*args, eps, activation, save_acts=True)


def postnorm_tail_bwd(x, attn, g, z, s2, ln1_s, ln1_b, w1, b1, w2, ln2_s, ln2_b,
                      b2=None, eps: float = 1e-5, activation: str = "relu"):
    """#16: the backward from the saved ``z`` and ``s2``, with the
    arguments and results of :func:`postnorm_tail_bwd_ref`, which it runs
    for a CPU ``x``.  A CUDA ``x`` launches the kernel chain, bf16 or fp32
    (``fused_postnorm_tail.bwd_launches`` and ``.f32_bwd_launches`` count
    them)."""
    if x.device.type == "cpu":
        return postnorm_tail_bwd_ref(x, attn, g, z, s2, ln1_s, ln1_b, w1, b1, w2,
                                     ln2_s, ln2_b, b2, eps, activation)
    f32 = kernel_is_f32("fused_postnorm_tail", x.dtype)
    b, n, d = x.shape
    r = b * n
    rows = (x.reshape(r, d).contiguous(), attn.reshape(r, d).contiguous(),
            g.reshape(r, d).contiguous(), z.reshape(r, w1.shape[1]).contiguous(),
            s2.reshape(r, d).contiguous())
    if f32:
        grads = _tail_bwd_f32(*rows, ln1_s, ln1_b, w1, w2, ln2_s, eps, activation)
        fused_postnorm_tail.f32_bwd_launches += 1
    else:
        grads = _tail_bwd_bf16(*rows, ln1_s, ln1_b, w1, w2, ln2_s, eps, activation)
        fused_postnorm_tail.bwd_launches += 1
    ds, dls1, dlb1, dw1, db1, dw2, db2, dls2, dlb2 = grads
    return (ds.view(b, n, d), dls1.to(ln1_s.dtype), dlb1.to(ln1_b.dtype),
            dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to((w2 if b2 is None else b2).dtype), dls2.to(ln2_s.dtype),
            dlb2.to(ln2_b.dtype))


def _tail_bwd_f32(x2d, a2d, g2, z2, s2, ln1_s, ln1_b, w1, w2, ln2_s, eps, activation):
    """#16's float32 chain over rows [R, D]: ``(ds, dln1_s, dln1_b, dw1,
    db1, dw2, db2, dln2_s, dln2_b)``, nothing rounded (ds2 and dz enter the
    GEMMs as they are)."""
    ds2, dls2, dlb2, db2 = ln_rows_bwd(s2, g2, ln2_s.float(), None, eps, add_g=False,
                                       dx_sum=True)
    h = act_f32(z2, activation)
    dw2 = gemm_f32(h, ds2, trans_a=True)                             # [F, D]
    del h
    dz, db1 = gemm_f32(ds2, w2, trans_b=True, act=activation, z_in=z2,
                       colsum=True)                                  # [R, F]
    x2 = ln_rows(x2d, ln1_s.float(), ln1_b.float(), eps, x_b=a2d, out_dtype=torch.float32)
    dw1 = gemm_f32(x2, dz, trans_a=True)                             # [D, F]
    del x2
    dx2 = gemm_f32(dz, w1, trans_b=True, residual=ds2)               # [R, D]
    del dz, ds2
    ds, dls1, dlb1 = ln_rows_bwd(x2d, dx2, ln1_s.float(), None, eps, add_g=False,
                                 x_b=a2d)
    return ds, dls1, dlb1, dw1, db1, dw2, db2, dls2, dlb2


def _tail_bwd_bf16(x2d, a2d, g2, z2, s2, ln1_s, ln1_b, w1, w2, ln2_s, eps, activation):
    """#16's bf16 chain over rows [R, D], with :func:`_tail_bwd_f32`'s
    results."""
    ds2, dls2, dlb2, ds2f, db2 = ln_rows_bwd(s2, g2, ln2_s.float(), None, eps,
                                             add_g=False, dx_f32=True, dx_sum=True)
    h = act_bf16(z2, activation)
    dw2 = gemm(h, ds2, trans_a=True)                                 # [F, D]
    del h
    dz, db1 = gemm(ds2, w2, trans_b=True, act=activation, z_in=z2,
                   colsum=True)                                      # [R, F]
    del ds2
    x2 = ln_rows(x2d, ln1_s.float(), ln1_b.float(), eps, x_b=a2d)
    dw1 = gemm(x2, dz, trans_a=True)                                 # [D, F]
    del x2
    dx2 = gemm(dz, w1, trans_b=True, residual_f32=ds2f,
               out_dtype=torch.float32)                              # [R, D]
    del dz, ds2f
    ds, dls1, dlb1 = ln_rows_bwd(x2d, dx2, ln1_s.float(), None, eps, add_g=False,
                                 x_b=a2d)
    return ds, dls1, dlb1, dw1, db1, dw2, db2, dls2, dlb2


class _FusedPostnormTail(torch.autograd.Function):
    """Kernels #15 and #16 as one differentiable op: the forward is #15's
    training form and saves x, attn, the parameters, z and s2 (as
    ``_pt_fwd`` does); the backward is :func:`postnorm_tail_bwd`, its one
    cotangent ``ds`` returned for both x and attn."""

    @staticmethod
    def forward(ctx, x, attn, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b, eps,
                activation):
        out, z, s2 = postnorm_tail_train_fwd(x, attn, ln1_s, ln1_b, w1, b1, w2, b2,
                                             ln2_s, ln2_b, eps, activation)
        ctx.save_for_backward(x, attn, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b,
                              z, s2)
        ctx.config = (eps, activation)
        return out

    @staticmethod
    def backward(ctx, g):
        x, attn, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b, z, s2 = ctx.saved_tensors
        eps, activation = ctx.config
        ds, *grads = postnorm_tail_bwd(x, attn, g.to(x.dtype), z, s2, ln1_s, ln1_b,
                                       w1, b1, w2, ln2_s, ln2_b, b2, eps, activation)
        return (ds, ds.to(attn.dtype), *grads, None, None)


def fused_postnorm_tail(x, attn, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b,
                        eps: float = 1e-5, activation: str = "relu") -> torch.Tensor:
    """``LN2(x2 + fc2(act(fc1(x2))))`` with ``x2 = LN1(x + attn)`` ([B, N,
    D] in and out), differentiable: everything of a post-norm encoder
    layer after its attention.

    A CPU ``x`` runs :func:`postnorm_tail_kernel_ref` (and, under
    autograd, :func:`postnorm_tail_bwd_ref`).  A CUDA ``x`` launches the
    kernels (bf16 or fp32, every tensor in x's dtype apart from the fp32
    LayerNorm parameters; Dense kernels ``[in, out]``) or raises, any other
    dtype before a launch; it never falls back.
    ``fused_postnorm_tail.launches`` counts the bf16 CUDA forwards of the
    serving form, ``.train_launches`` those of the training form (which
    also saves z and s2) and ``.bwd_launches`` the bf16 CUDA backwards;
    ``.f32_launches``, ``.f32_train_launches`` and ``.f32_bwd_launches`` the
    fp32 ones.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_postnorm_tail: no kernel for device {x.device}")
    _check_activation(activation)
    args = (x, attn, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedPostnormTail.apply(*args, eps, activation)
    if x.device.type == "cpu":
        return postnorm_tail_kernel_ref(*args, eps, activation)
    return _tail_kernels(*args, eps, activation, save_acts=False)


fused_postnorm_tail.launches = 0
fused_postnorm_tail.train_launches = 0
fused_postnorm_tail.bwd_launches = 0
fused_postnorm_tail.f32_launches = 0
fused_postnorm_tail.f32_train_launches = 0
fused_postnorm_tail.f32_bwd_launches = 0
