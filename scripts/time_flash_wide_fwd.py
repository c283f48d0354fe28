"""Time the port's bf16 flash-attention forward at head dims 128 and 256
on the card: #8's single step and streaming forms and the curve-local
forward #12 (its windowed instance), at the long-context shapes of
``chip_smoke.py``'s phase 19 (its ``WIDE_CASES`` and the bf16 rows of
``LOCAL_WIDE_CASES``), through launcher calls every tree of the port has
(``_build.flash_fwd``, ``_build.local_fwd``), so that two trees can be
compared in one call on one card:

    PYTHONPATH=<tree> python scripts/time_flash_wide_fwd.py --label <name>

Each case prints one JSON line: the form JAX's gate takes at that key
length (one K step to 4,096 keys, else 128-key streaming steps), the
call's time (with the lse) by one replay of a CUDA graph of ``ITERS``
calls, the CUDA kernels it launched and their device time
(``torch.profiler``), its largest error against the plain version
(``flash_fwd_ref`` at the kernel's key steps, ``local_fwd_ref``) as a
fraction of the plain version's largest |value| and the lse's largest
error, whether a second call gives the same bits, SDPA's bf16 forward on
contiguous q, k, v (with the band mask for #12), the bound (the larger of
the nominal operations, 4 x B H Nq Nk Dh or 4 x B H Dh x the window's
pairs, over 989 TFLOP/s and the bytes of q, k, v, out and lse over 3.35
TB/s), the nominal rate, the rate on the operations the formula executes
(#8's single step 6 units, its first pass being logits only; the
streaming form 4), and the card's name and power limit.  The timing
helpers are ``time_attention_bwd_stream.py``'s, beside it.  Needs an
NVIDIA GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
from time_attention_bwd_stream import _graph_ms, _kernel_ms

#: (label, b, nq, nk, heads, dh, packed): CurveViT-S/12 at 4,096 tokens at
#: 3 heads of 128 and 6 of 256 (the single step), longctx-16k at 3 heads
#: of 128 and a ragged 8,300 x 9,000 at Dh 256 (streaming); q, k, v as
#: views of one packed projection where ``packed``.
FLASH_CASES = (("CurveViT-S/12, 3 heads of 128", 8, 4096, 4096, 3, 128, True),
               ("longctx-16k, 3 heads of 128", 2, 16384, 16384, 3, 128, True),
               ("CurveViT-S/12, 6 heads of 256", 8, 4096, 4096, 6, 256, True),
               ("ragged, Dh 256", 1, 8300, 9000, 2, 256, False))
#: (label, b, n, heads, dh, packed): #12 at curve block 128, halo 1.
LOCAL_CASES = (("longctx-16k-hybrid, 3 heads of 128", 2, 16384, 3, 128, True),
               ("16,384 tokens, 2 heads of 256", 2, 16384, 2, 256, True),
               ("ragged 5,000, Dh 128", 1, 5000, 2, 128, False))
BLOCK, HALO = 128, 1
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
#: Executed operations per B H Nq Nk Dh, by form.
UNITS = {"single step": 6, "streaming": 4}
ITERS = 10  # calls in the timed CUDA graph


def _inputs(gen, b, nq, nk, h, dh, packed):
    if packed:
        qkv = torch.randn(b, nq, 3 * h * dh, generator=gen).to("cuda", torch.bfloat16)
        return qkv.view(b, nq, 3, h, dh).unbind(2)
    return tuple(torch.randn(b, n, h, dh, generator=gen).to("cuda", torch.bfloat16)
                 for n in (nq, nk, nk))


def _sdpa_fwd_ms(q, k, v, mask=None) -> float:
    """SDPA's bf16 forward on contiguous [B, H, N, Dh] q, k, v, with
    ``mask`` as its boolean attention mask where given."""
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    with torch.no_grad():
        return _graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), ITERS)


def _row(label, case, kernel, shape, run, want, nominal_ops, nbytes, sdpa, card,
         **extra) -> dict:
    out, lse = run()
    again = run()
    ms = _graph_ms(run, ITERS)
    want_out, want_lse = want
    return dict(label=label, case=case, kernel=kernel, shape=shape, **extra, ms=ms,
                kernels_ms=_kernel_ms(run),
                max_err_frac=float((out.float() - want_out.float()).abs().max()
                                   / want_out.float().abs().max()),
                lse_max_abs_err=float((lse - want_lse).abs().max()),
                repeats=bool(torch.equal(out, again[0]) and torch.equal(lse, again[1])),
                sdpa_fwd_ms=sdpa,
                bound_ms=max(nominal_ops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3,
                bound_by=("bytes" if nbytes / PEAK_BYTES > nominal_ops / PEAK_FLOPS
                          else "operations"),
                nominal_tflops=nominal_ops / ms / 1e9, card=card)


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
        q, k, v = _inputs(gen, b, nq, nk, h, dh, packed)
        single = fa.uses_single_kstep(nk)
        form = "single step" if single else "streaming"
        want = fa.flash_fwd_ref(q, k, v, s, return_lse=True,
                                block_k=nk if single else _build.FLASH_STREAM_BLOCK_K)
        pairs = b * h * nq * nk * dh
        row = _row(args.label, case, "#8", [b, nq, nk, h, dh],
                   lambda: _build.flash_fwd(q, k, v, s, streaming=not single, with_lse=True),
                   want, 4 * pairs, 2 * b * h * dh * (2 * nq + 2 * nk) + 4 * b * h * nq,
                   _sdpa_fwd_ms(q, k, v), card, form=form, units=UNITS[form])
        row["executed_tflops"] = UNITS[form] * pairs / row["ms"] / 1e9
        emit(row)
        del q, k, v, want
        torch.cuda.empty_cache()
    for i, (case, b, n, h, dh, packed) in enumerate(LOCAL_CASES):
        if pick and len(FLASH_CASES) + i not in pick:
            continue
        s = dh ** -0.5
        q, k, v = _inputs(gen, b, n, n, h, dh, packed)
        want = la.local_fwd_ref(q, k, v, BLOCK, HALO, s, return_lse=True)
        ids = torch.arange(n, device="cuda") // BLOCK
        mask = (ids[:, None] - ids[None, :]).abs() <= HALO
        sdpa = _sdpa_fwd_ms(q, k, v, mask)
        del mask
        pairs = sum((min(n, (j + 1) * BLOCK) - j * BLOCK) * (hi - lo)
                    for j in range(-(-n // BLOCK))
                    for lo, hi in [la.window(j, n, BLOCK, HALO)])
        emit(_row(args.label, case, "#12", [b, n, h, dh],
                  lambda: _build.local_fwd(q, k, v, s, BLOCK, HALO, with_lse=True), want,
                  4 * b * h * pairs * dh, 2 * b * n * h * dh * 4 + 4 * b * h * n, sdpa, card,
                  block=BLOCK, halo=HALO))
        del q, k, v, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
