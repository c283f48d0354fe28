"""The arithmetic of the fp32 attention kernels (``csrc/packed_attn_f32.cu``,
the forward of #1, #5 and #7; ``csrc/attention_bwd_f32.cu``, the backward
of #4 and #6) emulated in plain PyTorch on the CPU, against the JAX
package's Pallas forward in interpret mode and the port's plain versions.

Each kernel product is 3xTF32 (``ops/kernel_utils.py``'s split: a_big
b_small + a_small b_big + a_big b_big, each small part truncated to TF32 as
the tensor cores take it), added k8 step by k8 step into an fp32
accumulator.  Products that contract over keys (P V, dS K) or queries
(P^T dA, dS^T Q) take their A operand from the previous product's
accumulator and run over each group of 8 in the key permutation
(``csrc/attn_f32.cuh``): logical column c < 4 is key 2 c, c >= 4 is key 2
(c - 4) + 1.  The dk/dv kernel computes S^T = K Q^T and dP^T = V dA^T
itself, so its terms come in the other operand order.  The emulation
lives here; nothing on the main path uses it.  The inputs are the qkv,
att and lse that JAX's ``_fused_attn_block(..., interpret=True,
save_lse=True)`` saves (``tests/test_torch_ops_bwd.py``'s route), at 40
tokens with 29 real ones (Dh 64) and at Dh 192 with #5's/#6's mask.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfc_vit_tpu.ops import fused_attention_block as jfab
from sfc_vit_tpu_torch.ops.fused_attention_block import attention_bwd_ref, attention_fwd_ref
from sfc_vit_tpu_torch.ops.kernel_utils import tf32_split, tf32_trunc, matmul_3xtf32

#: The split's error against the exact product, relative to |a| @ |b|
#: (tests/test_torch_tf32_split.py).
SPLIT_BOUND = 2.0 ** -19
#: The port's fp32 gate: of the largest |value| (att, dqkv); lse absolute
#: and relative.
F32_TOL, LSE_TOL = 1e-4, 1e-5
KEEP = 0.9


def key_order(n: int) -> torch.Tensor:
    """The logical contraction order of n keys (a multiple of 8): within
    each group of 8, keys 0, 2, 4, 6, 1, 3, 5, 7."""
    c = torch.arange(n) % 8
    return torch.arange(n) - c + torch.where(c < 4, 2 * c, 2 * (c - 4) + 1)


def kernel_product(a: torch.Tensor, b: torch.Tensor, permuted: bool = False) -> torch.Tensor:
    """a @ b (fp32 [..., M, K] and [..., K, N]) as the kernels run it: K
    padded with zeros to a multiple of 8 (a tile's rows past n land as
    zero), taken in the key permutation where ``permuted``, each k8 step's
    three products (each an 8-term sum, exact in fp64) added in turn to an
    fp32 accumulator."""
    k = a.shape[-1]
    pad = -k % 8
    a = torch.nn.functional.pad(a.float(), (0, pad))
    b = torch.nn.functional.pad(b.float(), (0, 0, 0, pad))
    if permuted:
        order = key_order(k + pad)
        a, b = a[..., order], b[..., order, :]
    ab, as_ = tf32_split(a)
    bb, bs = tf32_split(b)
    ab, as_, bb, bs = ab.double(), tf32_trunc(as_).double(), bb.double(), tf32_trunc(bs).double()
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for s in range(0, k + pad, 8):
        for x, y in ((ab, bs), (as_, bb), (ab, bb)):
            acc = (acc.double() + x[..., s:s + 8] @ y[..., s:s + 8, :]).float()
    return acc


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, w = t.shape
    return t.view(b, n, heads, w // heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    b, h, n, dh = t.shape
    return t.transpose(1, 2).reshape(b, n, h * dh)


def emulate_fwd(qkv, heads, n_valid, scale, mask=None, keep=1.0, products=None):
    """csrc/packed_attn_f32.cu's forward: (att, lse); every product's
    operands appended to ``products`` (A, B, permuted)."""
    q, k, v = (_heads(t, heads) for t in qkv.float().chunk(3, dim=-1))
    s = kernel_product(q, k.transpose(-1, -2)) * scale
    s[..., n_valid:] = -1e30
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    lse_l = p.sum(-1, keepdim=True)
    pn = p / lse_l
    if mask is not None:
        pn = torch.where(mask, pn / keep, torch.zeros(()))
    att = kernel_product(pn, v, permuted=True)
    if products is not None:
        products += [(q, k.transpose(-1, -2), False), (pn, v, True)]
    return _merge(att), (m + torch.log(lse_l))[..., 0]


def emulate_bwd(qkv, att, datt, lse, heads, n_valid, scale, mask=None, keep=1.0,
                products=None):
    """csrc/attention_bwd_f32.cu's dq kernel and dk/dv kernel: dqkv."""
    q, k, v = (_heads(t, heads) for t in qkv.float().chunk(3, dim=-1))
    da, at = _heads(datt.float(), heads), _heads(att.float(), heads)
    delta = (da * at).sum(-1, keepdim=True)
    kept = mask if mask is not None else None

    def entries(s, dpn, lse_, delta_, kept_, key_axis):
        pn = torch.exp(s * scale - lse_)
        live = torch.arange(s.shape[key_axis]) < n_valid
        live = live.view(-1, 1) if key_axis == -2 else live
        pn = torch.where(live, pn, torch.zeros(()))
        if kept_ is None:
            return pn, pn * (dpn - delta_) * scale
        dp = torch.where(kept_, dpn / keep, torch.zeros(()))
        return torch.where(kept_, pn / keep, torch.zeros(())), pn * (dp - delta_) * scale

    # (1) dq: S = Q K^T, dP = dA V^T, dq = dS K over the keys (permuted).
    s = kernel_product(q, k.transpose(-1, -2))
    dpn = kernel_product(da, v.transpose(-1, -2))
    _, ds = entries(s, dpn, lse[..., None], delta, kept, -1)
    dq = kernel_product(ds, k, permuted=True)
    # (2) dk, dv: S^T = K Q^T, dP^T = V dA^T (rows keys), then dv = P^T dA
    # and dk = dS^T Q over the queries (permuted).
    st = kernel_product(k, q.transpose(-1, -2))
    dpt = kernel_product(v, da.transpose(-1, -2))
    kept_t = kept.transpose(-1, -2) if kept is not None else None
    pvt, dst = entries(st, dpt, lse[..., None, :], delta.transpose(-1, -2), kept_t, -2)
    dv = kernel_product(pvt, da, permuted=True)
    dk = kernel_product(dst, q, permuted=True)
    if products is not None:
        products += [(q, k.transpose(-1, -2), False), (da, v.transpose(-1, -2), False),
                     (ds, k, True), (k, q.transpose(-1, -2), False),
                     (v, da.transpose(-1, -2), False), (pvt, da, True), (dst, q, True)]
    return torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1)


def _jax_saved(seed, n, d, heads, n_actual):
    """qkv, att (rows below the real length) and lse [B, H, N] of JAX's
    Pallas training forward in interpret mode, as torch fp32."""
    rng = np.random.default_rng(seed)
    inner = d
    args = [rng.standard_normal((2, n, d)).astype(np.float32),
            (rng.standard_normal(d) * 0.1 + 1).astype(np.float32),
            (rng.standard_normal(d) * 0.1).astype(np.float32),
            (rng.standard_normal((d, 3 * inner)) * d ** -0.5).astype(np.float32),
            (rng.standard_normal((inner, d)) * inner ** -0.5).astype(np.float32)]
    dh = inner // heads
    _, qkv, att, lse = jfab._fused_attn_block(
        *map(jnp.asarray, args), heads=heads, scale=dh ** -0.5, eps=1e-5, interpret=True,
        n_actual=n_actual, save_acts=True, save_lse=True)
    to = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))  # noqa: E731
    return (to(qkv[:, :n]), to(att[:, :n]), to(jnp.transpose(lse[:, :n, :heads], (0, 2, 1))),
            torch.from_numpy(rng.standard_normal((2, n, inner)).astype(np.float32)))


#: (name, tokens, width, heads, real tokens, masked): ViT-B's head dim at a
#: ragged 40 tokens with 29 real ones; the flagship's head dim 192 with
#: the dropout mask.
CASES = [("dh64", 40, 128, 2, 29, False), ("dh192", 40, 384, 2, None, True)]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    _, n, d, heads, n_actual, masked = request.param
    qkv, att, lse, datt = _jax_saved(81, n, d, heads, n_actual)
    n_valid = n if n_actual is None else n_actual
    mask = None
    if masked:
        mask = torch.from_numpy(np.random.default_rng(82).random((2, heads, n, n)) < KEEP)
    return dict(qkv=qkv, att=att, lse=lse, datt=datt, heads=heads, n_valid=n_valid,
                scale=(d // heads) ** -0.5, mask=mask)


def _within(got, want, tol, name):
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), (name, err)


def test_key_order_is_a_bijection_on_every_group_of_8():
    order = key_order(64)
    for g in range(8):
        assert sorted(order[8 * g:8 * g + 8].tolist()) == list(range(8 * g, 8 * g + 8))
    assert order[:8].tolist() == [0, 2, 4, 6, 1, 3, 5, 7]
    # the A fragment (d[4 j], d[4 j + 2], d[4 j + 1], d[4 j + 3]) of thread
    # t holds logical columns t % 4 and t % 4 + 4 of rows r and r + 8: the
    # accumulator's columns 2 (t % 4) and 2 (t % 4) + 1
    for tq in range(4):
        assert order[tq] == 2 * tq and order[tq + 4] == 2 * tq + 1


def test_emulated_forward_matches_jax(case):
    """The forward's emulation against JAX's att and lse (the real rows),
    and with the mask against the port's attention_fwd_ref."""
    c = case
    att, lse = emulate_fwd(c["qkv"], c["heads"], c["n_valid"], c["scale"])
    nv = c["n_valid"]
    _within(att[:, :nv], c["att"][:, :nv], F32_TOL, "att")
    torch.testing.assert_close(lse[..., :nv], c["lse"][..., :nv], rtol=LSE_TOL, atol=LSE_TOL)
    if c["mask"] is not None:
        got, got_lse = emulate_fwd(c["qkv"], c["heads"], nv, c["scale"], c["mask"], KEEP)
        want, want_lse = attention_fwd_ref(c["qkv"], c["heads"], nv, c["scale"],
                                           mask=c["mask"], keep=KEEP)
        _within(got, want, F32_TOL, "att with the mask")
        torch.testing.assert_close(got_lse, want_lse, rtol=LSE_TOL, atol=LSE_TOL)


def test_emulated_backward_matches_plain(case):
    """Both backward kernels' emulation against attention_bwd_ref, with the
    mask where the case has one, on JAX's saved qkv, att and lse."""
    c = case
    kw = dict(mask=c["mask"], keep=KEEP) if c["mask"] is not None else {}
    args = (c["qkv"], c["att"], c["datt"], c["lse"], c["heads"], c["n_valid"], c["scale"])
    got = emulate_bwd(*args, **kw)
    want = attention_bwd_ref(*args, **kw)
    w = got.shape[-1] // 3
    for i, name in enumerate(("dq", "dk", "dv")):
        _within(got[..., i * w:(i + 1) * w], want[..., i * w:(i + 1) * w], F32_TOL, name)


def test_each_product_within_the_split_bound(case):
    """Every product of both kernels, taken in its contraction order (the
    key permutation where it has one), by the split summed exactly
    (matmul_3xtf32) against fp64: within 2^-19 of |a| @ |b|."""
    c = case
    products = []
    kw = dict(mask=c["mask"], keep=KEEP) if c["mask"] is not None else {}
    emulate_fwd(c["qkv"], c["heads"], c["n_valid"], c["scale"], products=products, **kw)
    emulate_bwd(c["qkv"], c["att"], c["datt"], c["lse"], c["heads"], c["n_valid"], c["scale"],
                products=products, **kw)
    assert len(products) == 9
    for i, (a, b, permuted) in enumerate(products):
        if permuted:  # 40 keys or queries: five whole groups of 8
            order = key_order(a.shape[-1])
            a, b = a[..., order], b[..., order, :]
        got = matmul_3xtf32(a, b)
        exact = a.double() @ b.double()
        mag = a.double().abs() @ b.double().abs()
        assert bool(((got - exact).abs() <= SPLIT_BOUND * mag).all()), i
