"""Time the port's bf16 flash-attention backward at head dims 128 and 256
on the card: the dq kernel (#10), the dk/dv kernel (#11), the fused
backward #9 (at these head dims the same two kernels) and the curve-local
backward #13 (their windowed instances), at the long-context shapes of
``chip_smoke.py``'s phase 19 (its ``WIDE_CASES`` and the bf16 rows of
``LOCAL_WIDE_CASES``), through launcher calls every tree of the port has
(``_build.flash_dq``, ``flash_dkv``, ``flash_fused_bwd``, ``local_bwd``),
so that two trees can be compared in one call on one card:

    PYTHONPATH=<tree> python scripts/time_flash_wide_bwd.py --label <name>

Each (case, kernel) prints one JSON line: the call's time by one replay of
a CUDA graph of ``ITERS`` calls, the CUDA kernels it launched and their
device time (``torch.profiler``), its largest error against the plain
version (``flash_dq_ref`` / ``flash_dkv_ref`` / ``local_bwd_ref``, fed the
same lse and delta) as a fraction of the plain version's largest |value|,
whether a second call gives the same bits (and for #9 whether it equals
#10 + #11 bit for bit), SDPA's bf16 autograd backward on contiguous q, k,
v (dq, dk and dv in one call; with the band mask for #13), the bound (the
larger of the nominal operations over 989 TFLOP/s and the bytes over 3.35
TB/s: #10 6, #11 8, #9 10 x B H Nq Nk Dh, #13 10 x B H Dh x the window's
(query, key) pairs), the rate on the operations the kernels execute (#10
8, #11 12, #9 20 units: p and ds enter the products as a two-term bf16
split), and the card's name and power limit.  The timing helpers are
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

#: (label, b, nq, nk, heads, dh, packed): CurveViT-S/12 at 4,096 tokens
#: at 3 heads of 128 and 6 of 256 (#9), longctx-16k at 3 heads of 128
#: (#10, #11) and a ragged 8,300 x 9,000 at Dh 256; q, k, v as views of
#: one packed projection where ``packed``.
FLASH_CASES = (("CurveViT-S/12, 3 heads of 128", 8, 4096, 4096, 3, 128, True),
               ("longctx-16k, 3 heads of 128", 2, 16384, 16384, 3, 128, True),
               ("CurveViT-S/12, 6 heads of 256", 8, 4096, 4096, 6, 256, True),
               ("ragged, Dh 256", 1, 8300, 9000, 2, 256, False))
#: (label, b, n, heads, dh, packed): #13 at curve block 128, halo 1.
LOCAL_CASES = (("longctx-16k-hybrid, 3 heads of 128", 2, 16384, 3, 128, True),
               ("16,384 tokens, 2 heads of 256", 2, 16384, 2, 256, True),
               ("ragged 5,000, Dh 128", 1, 5000, 2, 128, False))
BLOCK, HALO = 128, 1
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
#: Nominal and executed operations per B H Nq Nk Dh (or per window pair).
UNITS = {"#10": (6, 8), "#11": (8, 12), "#9": (10, 20), "#13": (10, 20)}
ITERS = 10  # calls in the timed CUDA graph


def _frac(got, want) -> float:
    return max(float((a.float() - w.float()).abs().max() / w.float().abs().max())
               for a, w in zip(got, want))


def _inputs(gen, b, nq, nk, h, dh, packed):
    if packed:
        qkv = torch.randn(b, nq, 3 * h * dh, generator=gen).to("cuda", torch.bfloat16)
        q, k, v = qkv.view(b, nq, 3, h, dh).unbind(2)
    else:
        q, k, v = (torch.randn(b, n, h, dh, generator=gen).to("cuda", torch.bfloat16)
                   for n in (nq, nk, nk))
    return q, k, v, torch.randn(b, nq, h, dh, generator=gen).to("cuda", torch.bfloat16)


def _row(label, case, kernel, shape, run, got, want, repeats, extra, ops_pairs, nbytes,
         sdpa, card) -> dict:
    nominal, executed = UNITS[kernel]
    ms = _graph_ms(run, ITERS)
    ops = nominal * ops_pairs
    return dict(label=label, case=case, kernel=kernel, shape=shape, ms=ms,
                kernels_ms=_kernel_ms(run), max_err_frac=_frac(got, want), repeats=repeats,
                **extra, sdpa_bwd_ms=sdpa,
                bound_ms=max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3,
                bound_by="bytes" if nbytes / PEAK_BYTES > ops / PEAK_FLOPS else "operations",
                executed_tflops=executed * ops_pairs / ms / 1e9, card=card)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--label", default="tree")
    p.add_argument("--cases", default="", help="comma-separated case indices (default all)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to time", file=sys.stderr)
        return 1
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
        sdpa = _sdpa_bwd_ms(q, k, v, g)
        pairs, io = b * h * nq * nk * dh, 2 * b * h * dh
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
        sdpa = _sdpa_bwd_ms(q, k, v, g, mask)
        del mask
        pairs = sum((min(n, (j + 1) * BLOCK) - j * BLOCK)
                    * (min(n, (j + HALO + 1) * BLOCK) - max(0, (j - HALO) * BLOCK))
                    for j in range(-(-n // BLOCK)))
        emit(_row(args.label, case, "#13", [b, n, h, dh], run, got, want, repeats,
                  dict(block=BLOCK, halo=HALO), b * h * pairs * dh,
                  2 * b * n * h * dh * 7 + 8 * b * h * n, sdpa, card))
        del q, k, v, g, out, lse, delta, got, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
