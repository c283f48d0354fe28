"""Flash attention on [B, N, H, Dh] (#8-#11) and short-sequence attention
straight off the packed QKV projection (#7).

Counterpart of ``sfc_vit_tpu/ops/flash_attention.py``.

**Streaming flash attention** (:func:`flash_attention`): a
``torch.autograd.Function`` over q [B, Nq, H, Dh] and k, v [B, Nk, H, Dh]
(Nq != Nk allowed).  The TPU kernels it replaces and their Hopper
counterparts in bfloat16, all CUDA C++ for sm_90a:

  * #8 ``_fwd_kernel`` -> ``csrc/flash_fwd_sm90.cu`` (:func:`flash_fwd`;
    Hopper's ``wgmma`` products on tiles a TMA/mbarrier ring brings, the
    softmax in registers).  Its two formulas follow the key length, as
    JAX's do: while ``round_up(nk, 128) <= SINGLE_KSTEP_MAX`` a single K
    step (fp32 logits x scale, the row's max and sum, ``P = p / l``
    rounded to the input dtype, then an fp32 P.V); past it the streaming
    form (``p = exp(s - m_running)`` rounded *unnormalised*, the fp32
    accumulator rescaled by ``alpha``, the division by ``l`` at the end).
    The kernel streams ``_build.FLASH_STREAM_BLOCK_K`` (128) keys a tile,
    so its running max moves per 128 keys where the TPU's moved per
    1,024: JAX's formula at ``block_k`` 128.  It also writes the fp32
    log-sum-exp when autograd needs it.
  * #9 ``_fused_bwd_kernel`` -> ``csrc/flash_bwd_fused_sm90.cu``
    (:func:`flash_fused_bwd`; ``wgmma`` and TMA as #8), taken while
    ``round_up(max(nq, nk), 128) <= FUSED_BWD_MAX``.  The TPU kernel
    carries dK and dV across its sequential grid; Hopper blocks run in no
    order, so one block per key tile loops over the query tiles for dK
    and dV and adds dQ into an fp32 buffer by TMA bulk reduce-adds,
    computing the logits once.  It takes the forward's lse in place of
    the in-kernel row sum and ``delta = rowsum(g * O)`` over the bf16
    output in place of ``rowsum(p * dp)``: fp32- and bf16-ulp departures
    from JAX's arithmetic, and the reduce-adds make dQ's summation order
    change from run to run.
  * #10 ``_dq_kernel`` -> ``csrc/flash_bwd_dq_sm90.cu`` and #11
    ``_dkv_kernel`` -> ``csrc/flash_bwd_dkv_sm90.cu`` (:func:`flash_dq`,
    :func:`flash_dkv`; ``wgmma`` and TMA as #9) past ``FUSED_BWD_MAX``,
    from the forward's lse and ``delta = rowsum(g * O)`` over the bf16
    output O (JAX computes it in XLA, here in PyTorch beside the
    launches).  #11 is #9's loop without dQ: a block per 128 keys walks
    64-query tiles.  #10 is that loop transposed: a block per 128 queries
    walks 64-key tiles and keeps dq in registers.  Each output row has one
    owner, so both give the same result on every run.

The backward keeps p and ds in fp32, as JAX does: the kernels multiply
them with bf16 operands as a two-term bf16 split (``hi + lo``, about 16
bits of mantissa) on the tensor cores.  dK and dV sum in fp32 and are
cast to the input dtype once.

In float32 (the JAX CLI's default dtype: every long-context model a user
launches without ``--dtype``), at head dims 64, 128 and 256, the four run
``csrc/flash_fwd_f32.cu`` and ``csrc/flash_bwd_f32.cu``: every product
three TF32 products on ``wgmma`` (3xTF32, ``csrc/attn_f32.cuh``), a
block one warpgroup over 64 queries (or keys) of one (b, h), a head as
1, 2 or 4 sub-heads of 64 columns.  #8's single step is two passes over
64-key tiles (the row's max and sum, then P normalised before P V), its
streaming form one pass rescaling O by alpha and dividing by l at the
end: nothing is rounded to a narrower type, so both are JAX's formula
with only the order of the fp32 sums changed.  #10 is a dq kernel that
walks the key tiles, #11 a dk/dv kernel that walks the query tiles, both
from the forward's lse and ``delta = rowsum(g * O)``; #9 in fp32 is the
same two kernels (each output with one owner, no reduce-adds: the same
bits on every call, as every fp32 attention backward gives).
:func:`flash_attention_with_lse` returns #8's lse beside its output, the
LSE capture path.

Each kernel's plain version sits beside it, a tile loop that repeats
JAX's arithmetic with ``block_q`` / ``block_k`` as parameters (memory
O(tile x N), so they also run at 16,384 tokens on the card):
:func:`flash_fwd_ref`, :func:`flash_fused_bwd_ref`, :func:`flash_dq_ref`,
:func:`flash_dkv_ref`.  A CPU tensor runs them; a CUDA tensor launches
the kernels (bfloat16 at head dim 64, float32 at 64, 128 and 256) or
raises.  Launches are counted on :func:`flash_attention`: ``launches``
(#8), ``fused_bwd_launches`` (#9), ``dq_launches`` (#10) and
``dkv_launches`` (#11), and the fp32 forms' apart as ``f32_launches``,
``f32_fused_bwd_launches``, ``f32_dq_launches`` and ``f32_dkv_launches``.

**Packed attention** (:func:`packed_flash_attention`, #7): maps a packed
projection [B, N, 3*H*Dh] to [B, N, H*Dh] with an fp32 softmax and no
layout change between the QKV GEMM and the attention.  The TPU kernel
``_packed_kernel`` holds one image's whole packed block in VMEM; here it
is ``csrc/packed_attn_sm90.cu`` (:func:`_build.attention_fwd`): a
persistent Hopper kernel over (image, head, 64-query tile) items, a
producer warp's TMA ring of Q, K and V tiles read straight from the
packed projection, ``wgmma`` products, the softmax in registers (one pass
where one warpgroup holds the row beside the output, to 256 keys at head
dim 64 and 64 at 192, ``_build.PACKED_ONE_PASS_MAX_N``; two passes up to
1,024 keys) and a TMA
store of the output: fp32 logits times scale, ``P = p / l`` rounded to
the input dtype before an fp32 ``P V``.  Its bound on the H100 is the
bytes of qkv and of the output.  As in the JAX package, that kernel is
the inference path, for N up to ``_build.PACKED_MAX_N`` (JAX's
``_PACKED_MAX_N``).  In float32 it runs ``csrc/packed_attn_f32.cu``
(3xTF32 on ``wgmma``, the same one-pass and two-pass forms: the row's max
and sum, then P normalised before its fp32 product with V).  Under autograd
the JAX rule ``_pfa_fwd`` / ``_pfa_bwd`` applies, plain code there and
plain PyTorch here: the softmax in the input dtype with the weights
stored for the backward.  A CPU tensor runs :func:`_packed_xla_ref`; a
CUDA tensor launches a kernel (bfloat16 or float32, any head dim that
``_build.attention_head_dim_ok`` takes: a multiple of 16 up to 256) or
raises.  ``packed_flash_attention.launches`` counts the bf16
launches, ``packed_flash_attention.f32_launches`` the fp32 ones.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .kernel_utils import kernel_is_f32, round_up

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_with_lse", "flash_fwd",
           "flash_fused_bwd", "flash_dq", "flash_dkv", "flash_fwd_ref",
           "flash_fused_bwd_ref", "flash_dq_ref", "flash_dkv_ref",
           "flash_delta", "uses_fused_bwd", "uses_single_kstep",
           "packed_flash_attention", "_packed_xla_ref", "SINGLE_KSTEP_MAX",
           "FUSED_BWD_MAX"]

#: JAX's ``_SINGLE_KSTEP_MAX`` (``flash_attention.py:72``).  It chooses the
#: forward's *formula* (normalise then round, or round unnormalised
#: against a running max), so that the port computes what the reference
#: computes at each length; the crossover at which one form is faster
#: than the other on the H100 is still to measure.
SINGLE_KSTEP_MAX = 4096
#: JAX's ``_FUSED_BWD_MAX`` (``flash_attention.py:66``).  It chooses the
#: backward's formula (#9's in-kernel softmax and delta, or the streaming
#: pair's saved lse and ``rowsum(g * O)``) to match the reference; the
#: H100 crossover between #9 and #10 + #11 is still to measure.
FUSED_BWD_MAX = 8192


def uses_single_kstep(nk: int) -> bool:
    """JAX's forward form for ``nk`` keys (``_auto_block_k``)."""
    return round_up(nk, 128) <= SINGLE_KSTEP_MAX


def uses_fused_bwd(nq: int, nk: int) -> bool:
    """JAX's backward choice (``_use_streaming_bwd`` negated)."""
    return round_up(max(nq, nk), 128) <= FUSED_BWD_MAX


def _bhnd(t: torch.Tensor) -> torch.Tensor:
    """[B, N, H, Dh] -> a [B, H, N, Dh] view."""
    return t.permute(0, 2, 1, 3)


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return q.shape[-1] ** -0.5 if scale is None else scale


# ---------------------------------------------------------------------------
# Plain versions: tile loops with JAX's arithmetic
# ---------------------------------------------------------------------------


def flash_fwd_ref(q, k, v, scale: float, block_q: int = 512,
                  block_k: Optional[int] = None, return_lse: bool = False):
    """Plain version of #8: ``(out [B, Nq, H, Dh], lse fp32 [B, H, Nq])``
    (just ``out`` without ``return_lse``).

    ``block_k`` None takes JAX's ``_auto_block_k``: one K step while
    ``round_up(nk, 128) <= SINGLE_KSTEP_MAX``, else 1,024-key steps.  One
    step is the normalise-then-round softmax; several are the streaming
    form, ``p`` rounded against the running max of the steps so far.
    ``block_q`` only bounds memory (query rows are independent).
    """
    b, nq, h, dh = q.shape
    nk = k.shape[1]
    if block_k is None:
        block_k = round_up(nk, 128) if uses_single_kstep(nk) else 1024
    single = nk <= block_k
    dt = q.dtype
    kf, vf = _bhnd(k).float(), _bhnd(v).float()
    out = torch.empty((b, h, nq, dh), dtype=dt, device=q.device)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    for q0 in range(0, nq, block_q):
        qt = _bhnd(q)[:, :, q0:q0 + block_q].float()
        if single:
            s = (qt @ kf.transpose(-1, -2)) * scale
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(-1, keepdim=True)
            o = (p / l).to(dt).float() @ vf
            out[:, :, q0:q0 + block_q] = o.to(dt)
            lse[:, :, q0:q0 + block_q] = (m + torch.log(l))[..., 0]
            continue
        m = torch.full(qt.shape[:-1] + (1,), float("-inf"), device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qt.shape, dtype=torch.float32, device=q.device)
        for k0 in range(0, nk, block_k):
            s = (qt @ kf[:, :, k0:k0 + block_k].transpose(-1, -2)) * scale
            m_next = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_next)
            alpha = torch.exp(m - m_next)
            l = p.sum(-1, keepdim=True) + alpha * l
            acc = acc * alpha + p.to(dt).float() @ vf[:, :, k0:k0 + block_k]
            m = m_next
        inv = torch.where(l == 0.0, 1.0, 1.0 / l)
        out[:, :, q0:q0 + block_q] = (acc * inv).to(dt)
        lse[:, :, q0:q0 + block_q] = (m + torch.log(torch.where(l == 0.0, 1.0, l)))[..., 0]
    out = out.transpose(1, 2)
    return (out, lse) if return_lse else out


def flash_fused_bwd_ref(q, k, v, g, scale: float, block_q: int = 512):
    """Plain version of #9 (JAX's ``_fused_bwd_kernel``): per query tile
    the softmax recomputed from the logits (``p = e / sum(e)``, fp32),
    ``dv += p^T g``, ``dp = g v^T``, ``delta = rowsum(dp * p)``,
    ``ds = p (dp - delta) scale``, ``dq = ds k``, ``dk += ds^T q``, all
    fp32.  Returns ``(dq, dk, dv)`` [B, N, H, Dh] in the input dtypes."""
    b, nq, h, dh = q.shape
    kf, vf = _bhnd(k).float(), _bhnd(v).float()
    dq = torch.empty((b, h, nq, dh), dtype=q.dtype, device=q.device)
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, nq, block_q):
        qt = _bhnd(q)[:, :, q0:q0 + block_q].float()
        gt = _bhnd(g)[:, :, q0:q0 + block_q].float()
        s = (qt @ kf.transpose(-1, -2)) * scale
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e / e.sum(-1, keepdim=True)
        dv += p.transpose(-1, -2) @ gt
        dp = gt @ vf.transpose(-1, -2)
        delta = (dp * p).sum(-1, keepdim=True)
        ds = p * (dp - delta) * scale
        dq[:, :, q0:q0 + block_q] = (ds @ kf).to(q.dtype)
        dk += ds.transpose(-1, -2) @ qt
    return (dq.transpose(1, 2), dk.to(k.dtype).transpose(1, 2),
            dv.to(v.dtype).transpose(1, 2))


def flash_delta(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(g * O)`` in fp32 over the output O as stored,
    [B, H, Nq] (JAX's ``_streaming_bwd``, ``flash_attention.py:559-563``)."""
    return (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_dq_ref(q, k, v, g, lse, delta, scale: float, block_q: int = 512,
                 block_k: int = 1024):
    """Plain version of #10 (JAX's ``_dq_kernel``): ``p = exp(s - lse)``,
    ``dp = g v^T``, ``ds = p (dp - delta) scale``, ``dq += ds k`` over the
    key tiles in fp32, rounded once.  ``lse``, ``delta`` fp32 [B, H, Nq]."""
    b, nq, h, dh = q.shape
    nk = k.shape[1]
    kf, vf = _bhnd(k).float(), _bhnd(v).float()
    dq = torch.empty((b, h, nq, dh), dtype=q.dtype, device=q.device)
    for q0 in range(0, nq, block_q):
        qt = _bhnd(q)[:, :, q0:q0 + block_q].float()
        gt = _bhnd(g)[:, :, q0:q0 + block_q].float()
        ls = lse[:, :, q0:q0 + block_q, None]
        dl = delta[:, :, q0:q0 + block_q, None]
        acc = torch.zeros(qt.shape, dtype=torch.float32, device=q.device)
        for k0 in range(0, nk, block_k):
            kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
            p = torch.exp((qt @ kt.transpose(-1, -2)) * scale - ls)
            dp = gt @ vt.transpose(-1, -2)
            acc += (p * (dp - dl) * scale) @ kt
        dq[:, :, q0:q0 + block_q] = acc.to(q.dtype)
    return dq.transpose(1, 2)


def flash_dkv_ref(q, k, v, g, lse, delta, scale: float, block_q: int = 512,
                  block_k: int = 1024):
    """Plain version of #11 (JAX's ``_dkv_kernel``): per key tile, over
    the query tiles, ``dv += p^T g`` and ``dk += ds^T q`` in fp32, each
    rounded once to the input dtype.  Returns ``(dk, dv)``."""
    b, nq, h, dh = q.shape
    nk = k.shape[1]
    qf, gf = _bhnd(q).float(), _bhnd(g).float()
    dk = torch.empty((b, h, nk, dh), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, h, nk, dh), dtype=v.dtype, device=q.device)
    for k0 in range(0, nk, block_k):
        kt = _bhnd(k)[:, :, k0:k0 + block_k].float()
        vt = _bhnd(v)[:, :, k0:k0 + block_k].float()
        dk_acc = torch.zeros(kt.shape, dtype=torch.float32, device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for q0 in range(0, nq, block_q):
            qt, gt = qf[:, :, q0:q0 + block_q], gf[:, :, q0:q0 + block_q]
            s = (qt @ kt.transpose(-1, -2)) * scale
            p = torch.exp(s - lse[:, :, q0:q0 + block_q, None])
            dv_acc += p.transpose(-1, -2) @ gt
            dp = gt @ vt.transpose(-1, -2)
            ds = p * (dp - delta[:, :, q0:q0 + block_q, None]) * scale
            dk_acc += ds.transpose(-1, -2) @ qt
        dk[:, :, k0:k0 + block_k] = dk_acc.to(k.dtype)
        dv[:, :, k0:k0 + block_k] = dv_acc.to(v.dtype)
    return dk.transpose(1, 2), dv.transpose(1, 2)


# ---------------------------------------------------------------------------
# The kernels' wrappers: plain version for a CPU tensor, kernel for CUDA
# ---------------------------------------------------------------------------


def _check_device(q: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor the kernels take; False for a CPU one.  A
    dtype and head dim that no kernel takes raise on any other device."""
    if q.device.type == "cpu":
        return False
    if q.shape[-1] not in _build.flash_head_dims(q.dtype):
        raise NotImplementedError(
            f"{what}: {q.dtype} at head dim {q.shape[-1]} is not ported to the GPU "
            f"yet, the flash kernels take bfloat16 at head dim "
            f"{' or '.join(map(str, _build.FLASH_HEAD_DIMS))} and float32 at "
            f"{', '.join(map(str, _build.FLASH_F32_HEAD_DIMS))}: ROADMAP.md queue 2 "
            "entry 2 (kernels #8-#11 in bfloat16 at head dims 128 and 256)")
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    return True


def _count(name: str, q: torch.Tensor) -> None:
    """One launch of a flash kernel: the fp32 forms count apart
    (``f32_`` + ``name``)."""
    name = f"f32_{name}" if q.dtype == torch.float32 else name
    setattr(flash_attention, name, getattr(flash_attention, name) + 1)


def flash_fwd(q, k, v, scale: float, return_lse: bool = False):
    """#8: the attention output [B, Nq, H, Dh] (and the fp32 lse
    [B, H, Nq] with ``return_lse``), in JAX's form for this key length."""
    if not _check_device(q, "flash_attention"):
        return flash_fwd_ref(q, k, v, scale, return_lse=return_lse)
    res = _build.flash_fwd(q, k, v, scale, streaming=not uses_single_kstep(k.shape[1]),
                           with_lse=return_lse)
    _count("launches", q)
    return res


def flash_fused_bwd(q, k, v, out, lse, g, scale: float):
    """#9: ``(dq, dk, dv)`` in the input dtype.  The kernels read the
    forward's ``out`` and ``lse``; the plain version recomputes both."""
    if not _check_device(q, "flash_attention"):
        return flash_fused_bwd_ref(q, k, v, g, scale)
    dq, dk, dv = _build.flash_fused_bwd(q, k, v, g, lse, flash_delta(g, out), scale)
    _count("fused_bwd_launches", q)
    return dq.to(q.dtype), dk, dv


def flash_dq(q, k, v, g, lse, delta, scale: float):
    """#10: dq [B, Nq, H, Dh] in the input dtype."""
    if not _check_device(q, "flash_attention"):
        return flash_dq_ref(q, k, v, g, lse, delta, scale)
    dq = _build.flash_dq(q, k, v, g, lse, delta, scale)
    _count("dq_launches", q)
    return dq


def flash_dkv(q, k, v, g, lse, delta, scale: float):
    """#11: ``(dk, dv)`` [B, Nk, H, Dh] in the input dtype."""
    if not _check_device(q, "flash_attention"):
        return flash_dkv_ref(q, k, v, g, lse, delta, scale)
    dk, dv = _build.flash_dkv(q, k, v, g, lse, delta, scale)
    _count("dkv_launches", q)
    return dk, dv


class _Flash(torch.autograd.Function):
    """#8 with its lse saved, then #9 or #10 + #11 (JAX's ``_fa_fwd`` /
    ``_fa_bwd``).  ``plain`` runs the plain versions on any device (the
    comparison path, :func:`flash_attention_ref`)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, plain):
        fwd = flash_fwd_ref if plain else flash_fwd
        out, lse = fwd(q, k, v, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.plain = scale, plain
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        s, plain = ctx.scale, ctx.plain
        g = g.to(out.dtype)
        if uses_fused_bwd(q.shape[1], k.shape[1]):
            grads = (flash_fused_bwd_ref(q, k, v, g, s) if plain
                     else flash_fused_bwd(q, k, v, out, lse, g, s))
        else:
            delta = flash_delta(g, out)
            if plain:
                grads = (flash_dq_ref(q, k, v, g, lse, delta, s),
                         *flash_dkv_ref(q, k, v, g, lse, delta, s))
            else:
                grads = (flash_dq(q, k, v, g, lse, delta, s),
                         *flash_dkv(q, k, v, g, lse, delta, s))
        return (*grads, None, None)


def _attend(q, k, v, scale, plain: bool):
    s = _scale(q, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, s, plain)
    return flash_fwd_ref(q, k, v, s) if plain else flash_fwd(q, k, v, s)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Streaming flash attention, differentiable: q [B, Nq, H, Dh], k and
    v [B, Nk, H, Dh] -> [B, Nq, H, Dh].

    A CPU tensor runs the plain versions; a CUDA one the kernels #8-#11
    (bfloat16 at head dim 64, float32 at 64, 128 and 256; q/k/v rows
    16-byte aligned: the views of a packed projection need no copy) or
    raises.  It never falls back.
    """
    _check_device(q, "flash_attention")
    return _attend(q, k, v, scale, plain=False)


def flash_attention_ref(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """:func:`flash_attention` through the plain versions on any device:
    the comparison path for the kernels."""
    return _attend(q, k, v, scale, plain=True)


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: Optional[float] = None):
    """The attention output and the per-query log-sum-exp, ``(out [B, Nq,
    H, Dh], lse fp32 [B, H, Nq])``: the LSE capture path (JAX's
    ``flash_attention_with_lse``, ``flash_attention.py:851``).  With q, k
    and the lse, any rows of the attention weights rebuild in O(rows x N)
    (:func:`sfc_vit_tpu_torch.utils.profiling.attention_rows`), no [N, N]
    tensor made, so the capture observes the flash kernel itself at 4k+
    tokens.

    A CUDA tensor runs #8 with its lse (bfloat16 at head dim 64, float32
    at 64, 128 and 256; counted in ``flash_attention.launches`` or
    ``f32_launches``) or raises; a CPU one its plain version
    :func:`flash_fwd_ref`.  Not differentiable through the kernel."""
    return flash_fwd(q, k, v, _scale(q, scale), return_lse=True)


#: Launches of #8, #9, #10 and #11 on bf16 tensors; the ``f32_`` counts are
#: their fp32 forms' (``csrc/flash_fwd_f32.cu``, ``csrc/flash_bwd_f32.cu``).
flash_attention.launches = 0
flash_attention.fused_bwd_launches = 0
flash_attention.dq_launches = 0
flash_attention.dkv_launches = 0
flash_attention.f32_launches = 0
flash_attention.f32_fused_bwd_launches = 0
flash_attention.f32_dq_launches = 0
flash_attention.f32_dkv_launches = 0


# ---------------------------------------------------------------------------
# Packed-QKV short-sequence attention (#7)
# ---------------------------------------------------------------------------


def _split(qkv: torch.Tensor, heads: int):
    """q, k, v [B, H, N, Dh] views of the packed projection."""
    b, n, three_inner = qkv.shape
    return qkv.view(b, n, 3, heads, three_inner // (3 * heads)).permute(2, 0, 3, 1, 4)


def _merge(out: torch.Tensor) -> torch.Tensor:
    """[B, H, N, Dh] -> [B, N, H*Dh]."""
    b, h, n, dh = out.shape
    return out.transpose(1, 2).reshape(b, n, h * dh)


def _packed_xla_ref(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """The kernel's plain version (JAX's ``_packed_xla_ref``): fp32
    logits times ``scale``, fp32 softmax rounded to the input dtype, then
    the weighted sum."""
    q, k, v = _split(qkv, heads)
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return _merge(w @ v)


def _pfa_fwd(qkv: torch.Tensor, heads: int, scale: float):
    """The differentiated forward (JAX's ``_pfa_fwd``): logits and softmax
    in the input dtype; returns the output and ``(q, k, v, p)``."""
    q, k, v = _split(qkv, heads)
    sc = torch.tensor(scale, dtype=q.dtype, device=q.device)
    p = torch.softmax((q @ k.transpose(-1, -2)) * sc, dim=-1)
    return _merge(p @ v), (q, k, v, p)


def _pfa_bwd(res, g: torch.Tensor, scale: float) -> torch.Tensor:
    """JAX's ``_pfa_bwd``: the packed dqkv from the stored weights."""
    q, k, v, p = res
    b, h, n, dh = q.shape
    sc = torch.tensor(scale, dtype=q.dtype, device=q.device)
    gh = g.reshape(b, n, h, dh).transpose(1, 2)
    dp = gh @ v.transpose(-1, -2)
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * sc
    dqkv = torch.stack([ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ gh])
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, n, 3 * h * dh)


class _PackedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, scale):
        out, res = _pfa_fwd(qkv, heads, scale)
        ctx.save_for_backward(*res)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        return _pfa_bwd(ctx.saved_tensors, g, ctx.scale), None, None


def packed_flash_attention(qkv: torch.Tensor, heads: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Attention on a packed [B, N, 3*H*Dh] projection -> [B, N, H*Dh].

    Under autograd, JAX's store-weights rule.  Otherwise a CPU ``qkv``
    runs :func:`_packed_xla_ref` and a CUDA one kernel #7 (bfloat16, or
    its fp32 form), or raises for another dtype, a head dim the kernels
    do not take or N past ``_build.PACKED_MAX_N``.
    """
    b, n, three_inner = qkv.shape
    if three_inner % (3 * heads):
        raise ValueError(f"packed QKV feature dim {three_inner} must be "
                         f"divisible by 3*heads={3 * heads}")
    s = (three_inner // 3 // heads) ** -0.5 if scale is None else scale
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _PackedAttention.apply(qkv, heads, s)
    if qkv.device.type == "cpu":
        return _packed_xla_ref(qkv, heads, s)
    if qkv.device.type != "cuda":
        raise ValueError(f"packed_flash_attention: no kernel for device {qkv.device}")
    f32 = kernel_is_f32("packed_flash_attention", qkv.dtype)
    out = _build.attention_fwd(qkv.contiguous(), heads, n, s)
    if f32:
        packed_flash_attention.f32_launches += 1
    else:
        packed_flash_attention.launches += 1
    return out


packed_flash_attention.launches = 0
packed_flash_attention.f32_launches = 0
