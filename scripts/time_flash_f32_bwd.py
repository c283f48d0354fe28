"""Time the port's fp32 flash-attention backward on the card: the dq kernel
(#10), the dk/dv kernel (#11), the fused backward #9 (in fp32 the same two
kernels) and the curve-local backward #13 (their windowed instances), at
the shapes of ``chip_smoke.py``'s phase 18 (its ``FLASH_F32_CASES``, the Dh
64 rows included as a check that they do not move) and the fp32 rows of
its ``LOCAL_WIDE_CASES``, through launcher calls every tree of the port has
(``_build.flash_dq``, ``flash_dkv``, ``flash_fused_bwd``, ``local_bwd``), so
that two trees can be compared in one call on one card:

    PYTHONPATH=<tree> python scripts/time_flash_f32_bwd.py --label <name>

Each (case, kernel) prints one JSON line: the call's time by one replay of
a CUDA graph of ``ITERS`` calls, the CUDA kernels it launched and their
device time (``torch.profiler``), the rate on nominal operations (#10 6,
#11 8, #9 10, #13 10 x B H Nq Nk Dh, or x B H Dh x the window's (query,
key) pairs) and on the operations the kernels execute (#10 6, #11 8, #9
and #13 14: S and dP are taken in both kernels), the bound (the nominal
operations at 3xTF32's 165 TFLOP/s, or the bytes at 3.35 TB/s where
larger), the largest error against the plain version (``flash_dq_ref`` /
``flash_dkv_ref`` / ``local_bwd_ref``, fed the same lse and delta) as a
fraction of its largest |value|, whether a second call gives the same
bits (and for #9 whether it equals #10 + #11 bit for bit), SDPA's fp32
autograd backward on contiguous q, k, v (dq, dk and dv in one call; with
the band mask for #13) with ``allow_tf32`` False and the CUDA kernels it
ran, and the card's name and power limit.  The timing helpers are
``time_attention_bwd_stream.py``'s, beside it.  Needs an NVIDIA GPU;
imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
from time_attention_bwd_stream import _graph_ms, _kernel_ms, _sdpa_bwd_ms

#: (label, b, nq, nk, heads, dh, packed): chip_smoke.py's FLASH_F32_CASES.
FLASH_CASES = (("CurveViT-S/12", 16, 4096, 4096, 6, 64, True),
               ("longctx-16k", 2, 16384, 16384, 6, 64, True),
               ("CurveViT-S/12, 3 heads of 128", 8, 4096, 4096, 3, 128, True),
               ("longctx-16k, 3 heads of 128", 2, 16384, 16384, 3, 128, True),
               ("CurveViT-S/12, 6 heads of 256", 8, 4096, 4096, 6, 256, True),
               ("ragged, Dh 256", 1, 8300, 9000, 2, 256, False),
               ("1-D tokenizer, 33 x 33 px", 32, 1089, 1089, 4, 64, True))
#: (label, b, n, heads, dh, packed): the fp32 rows of LOCAL_WIDE_CASES,
#: #13 at curve block 128, halo 1.
LOCAL_CASES = (("longctx-16k-hybrid", 2, 16384, 6, 64, True),
               ("longctx-16k-hybrid, 3 heads of 128", 2, 16384, 3, 128, True),
               ("ragged 5,000, Dh 256", 1, 5000, 2, 256, False))
BLOCK, HALO = 128, 1
PEAK_FLOPS, PEAK_BYTES = 165e12, 3.35e12  # 3xTF32 (a third of TF32's 495), HBM3
#: Nominal and executed operations per B H Nq Nk Dh (or per window pair).
UNITS = {"#10": (6, 6), "#11": (8, 8), "#9": (10, 14), "#13": (10, 14)}
ITERS = 5  # calls in the timed CUDA graph


def _frac(got, want) -> float:
    return max(float((a - w).abs().max() / w.abs().max()) for a, w in zip(got, want))


def _inputs(gen, b, nq, nk, h, dh, packed):
    if packed:
        qkv = torch.randn(b, nq, 3 * h * dh, generator=gen).cuda()
        q, k, v = qkv.view(b, nq, 3, h, dh).unbind(2)
    else:
        q, k, v = (torch.randn(b, n, h, dh, generator=gen).cuda() for n in (nq, nk, nk))
    return q, k, v, torch.randn(b, nq, h, dh, generator=gen).cuda()


def _sdpa(q, k, v, g, mask=None) -> dict:
    """SDPA's fp32 autograd backward (TF32 off): ms and its kernels."""
    assert not torch.backends.cuda.matmul.allow_tf32
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    gt = g.transpose(1, 2).contiguous()
    kernels = _kernel_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True),
                         iters=2)
    del qt, kt, vt, out, gt
    return dict(sdpa_bwd_ms=_sdpa_bwd_ms(q, k, v, g, mask), sdpa_kernels=sorted(kernels),
                sdpa_allow_tf32=False)


def _row(label, case, kernel, shape, run, got, want, repeats, extra, pairs, nbytes, sdpa,
         card) -> dict:
    nominal, executed = UNITS[kernel]
    ms = _graph_ms(run, ITERS)
    ops = nominal * pairs
    return dict(label=label, case=case, kernel=kernel, shape=shape, ms=ms,
                kernels_ms=_kernel_ms(run, iters=3), max_err_frac=_frac(got, want),
                repeats=repeats, **extra, **sdpa,
                bound_ms=max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3,
                bound_by="bytes" if nbytes / PEAK_BYTES > ops / PEAK_FLOPS else "operations",
                nominal_tflops=ops / ms / 1e9, executed_tflops=executed * pairs / ms / 1e9,
                card=card)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--label", default="tree")
    p.add_argument("--cases", default="", help="comma-separated case indices (default all)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to time", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sfc_vit_tpu_torch.ops import _build
    from sfc_vit_tpu_torch.ops import flash_attention as fa
    from sfc_vit_tpu_torch.ops import local_attention as la

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    pick = {int(i) for i in args.cases.split(",") if i}
    gen = torch.Generator().manual_seed(0)
    emit = lambda row: print(json.dumps(row), flush=True)  # noqa: E731
    for i, (case, b, nq, nk, h, dh, packed) in enumerate(FLASH_CASES):
        if pick and i not in pick:
            continue
        s = dh ** -0.5
        q, k, v, g = _inputs(gen, b, nq, nk, h, dh, packed)
        out, lse = _build.flash_fwd(q, k, v, s, streaming=not fa.uses_single_kstep(nk),
                                    with_lse=True)
        delta = fa.flash_delta(g, out)
        args_ = (q, k, v, g, lse, delta, s)
        want_dq = fa.flash_dq_ref(*args_)
        want_dkv = fa.flash_dkv_ref(*args_)
        sdpa = _sdpa(q, k, v, g)
        pairs, io = b * h * nq * nk * dh, 4 * b * h * dh
        vec = 8 * b * h * nq
        shape = [b, nq, nk, h, dh]
        dq = _build.flash_dq(*args_)
        emit(_row(args.label, case, "#10", shape, lambda: _build.flash_dq(*args_), (dq,),
                  (want_dq,), bool(torch.equal(dq, _build.flash_dq(*args_))), {}, pairs,
                  io * (3 * nq + 2 * nk) + vec, sdpa, card))
        dkv = _build.flash_dkv(*args_)
        again = _build.flash_dkv(*args_)
        emit(_row(args.label, case, "#11", shape, lambda: _build.flash_dkv(*args_), dkv,
                  want_dkv, all(torch.equal(x, y) for x, y in zip(dkv, again)), {}, pairs,
                  io * (2 * nq + 4 * nk) + vec, sdpa, card))
        fused = _build.flash_fused_bwd(*args_)
        same = all(torch.equal(x, y) for x, y in zip(fused, (dq, *dkv)))
        emit(_row(args.label, case, "#9", shape, lambda: _build.flash_fused_bwd(*args_), fused,
                  (want_dq, *want_dkv),
                  all(torch.equal(x, y) for x, y in zip(fused, _build.flash_fused_bwd(*args_))),
                  dict(fused_equals_pair=same), pairs, io * (3 * nq + 4 * nk) + vec, sdpa, card))
        del q, k, v, g, out, lse, delta, want_dq, want_dkv, dq, dkv, again, fused
        torch.cuda.empty_cache()
    for i, (case, b, n, h, dh, packed) in enumerate(LOCAL_CASES):
        if pick and len(FLASH_CASES) + i not in pick:
            continue
        s = dh ** -0.5
        q, k, v, g = _inputs(gen, b, n, n, h, dh, packed)
        out, lse = _build.local_fwd(q, k, v, s, BLOCK, HALO, with_lse=True)
        delta = fa.flash_delta(g, out)
        run = lambda: _build.local_bwd(q, k, v, g, lse, delta, s, BLOCK, HALO)  # noqa: E731
        got = run()
        want = la.local_bwd_ref(q, k, v, g, lse, delta, BLOCK, HALO, s)
        repeats = all(torch.equal(x, y) for x, y in zip(got, run()))
        ids = torch.arange(n, device="cuda") // BLOCK
        mask = (ids[:, None] - ids[None, :]).abs() <= HALO
        sdpa = _sdpa(q, k, v, g, mask)
        del mask
        pairs = sum((min(n, (j + 1) * BLOCK) - j * BLOCK)
                    * (min(n, (j + HALO + 1) * BLOCK) - max(0, (j - HALO) * BLOCK))
                    for j in range(-(-n // BLOCK)))
        emit(_row(args.label, case, "#13", [b, n, h, dh], run, got, want, repeats,
                  dict(block=BLOCK, halo=HALO), b * h * pairs * dh,
                  4 * b * n * h * dh * 7 + 8 * b * h * n, sdpa, card))
        del q, k, v, g, out, lse, delta, got, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
