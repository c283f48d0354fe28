"""Time the port's fp32 flash-attention forward on the card: #8's single
step and streaming forms and the curve-local forward #12 (its windowed
instance), at the shapes of ``chip_smoke.py``'s phase 18 (its
``FLASH_F32_CASES``, the Dh 64 rows included) and the fp32 rows of its
``LOCAL_WIDE_CASES``, through launcher calls every tree of the port has
(``_build.flash_fwd``, ``_build.local_fwd``), so that two trees can be
compared in one call on one card:

    PYTHONPATH=<tree> python scripts/time_flash_f32_fwd.py --label <name>

Each case prints one JSON line: the form JAX's gate takes at that key
length (one K step to 4,096 keys, else streaming), the call's time (with
the lse) by one replay of a CUDA graph of ``ITERS`` calls, the CUDA
kernels it launched and their device time (``torch.profiler``), the rate
on the nominal operations (4 x B H Nq Nk Dh, or 4 x B H Dh x the window's
(query, key) pairs) and on the operations the tree's kernel executes (the
single step 6 units and streaming 4; 8 and 6 at Dh 256 where the kernel
is ``flash_fwd_f32_sm90``, whose walks there recompute the logits), the
bound (the nominal operations at 3xTF32's 165 TFLOP/s, or the bytes at
3.35 TB/s where larger), the largest error against the plain version
(``flash_fwd_ref`` at the kernel's key steps, ``local_fwd_ref``) as a
fraction of its largest |value|, the lse's largest error against fp64,
whether a second call gives the same bits, SDPA's fp32 forward on
contiguous q, k, v with ``allow_tf32`` False (with the band mask for #12)
and the CUDA kernels it ran, and the card's name and power limit.  The
timing helpers are ``time_attention_bwd_stream.py``'s, beside it.  Needs
an NVIDIA GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
from time_attention_bwd_stream import _graph_ms, _kernel_ms

#: (label, b, nq, nk, heads, dh, packed): chip_smoke.py's FLASH_F32_CASES.
FLASH_CASES = (("CurveViT-S/12", 16, 4096, 4096, 6, 64, True),
               ("longctx-16k", 2, 16384, 16384, 6, 64, True),
               ("CurveViT-S/12, 3 heads of 128", 8, 4096, 4096, 3, 128, True),
               ("longctx-16k, 3 heads of 128", 2, 16384, 16384, 3, 128, True),
               ("CurveViT-S/12, 6 heads of 256", 8, 4096, 4096, 6, 256, True),
               ("ragged, Dh 256", 1, 8300, 9000, 2, 256, False),
               ("1-D tokenizer, 33 x 33 px", 32, 1089, 1089, 4, 64, True))
#: (label, b, n, heads, dh, packed): the fp32 rows of LOCAL_WIDE_CASES, #12
#: at curve block 128, halo 1.
LOCAL_CASES = (("longctx-16k-hybrid", 2, 16384, 6, 64, True),
               ("longctx-16k-hybrid, 3 heads of 128", 2, 16384, 3, 128, True),
               ("ragged 5,000, Dh 256", 1, 5000, 2, 256, False))
BLOCK, HALO = 128, 1
PEAK_FLOPS, PEAK_BYTES = 165e12, 3.35e12  # 3xTF32 (a third of TF32's 495), HBM3
#: Executed operations per B H Nq Nk Dh by form; the first-pass kernel
#: ``flash_fwd_f32_sm90`` walked the keys twice at Dh 256.
UNITS = {"single step": 6, "streaming": 4}
UNITS_TWO_WALKS = {"single step": 8, "streaming": 6}
ITERS = 5  # calls in the timed CUDA graph


def _inputs(gen, b, nq, nk, h, dh, packed):
    if packed:
        qkv = torch.randn(b, nq, 3 * h * dh, generator=gen).cuda()
        return qkv.view(b, nq, 3, h, dh).unbind(2)
    return tuple(torch.randn(b, n, h, dh, generator=gen).cuda() for n in (nq, nk, nk))


def _lse64(q, k, scale, block=None, chunk: int = 512) -> torch.Tensor:
    """fp64 log-sum-exp of every query's scaled logits [B, H, Nq], over
    every key or (``block``) the curve-local window of block and HALO."""
    b, nq, h, _ = q.shape
    out = torch.empty(b, h, nq, dtype=torch.float64, device=q.device)
    kd = k.double().transpose(1, 2)
    for q0 in range(0, nq, chunk):
        q1 = min(nq, q0 + chunk)
        s = (q[:, q0:q1].double().transpose(1, 2) @ kd.transpose(-1, -2)) * scale
        if block is not None:
            qi = torch.arange(q0, q1, device=q.device) // block
            kj = torch.arange(k.shape[1], device=q.device) // block
            s.masked_fill_((qi[:, None] - kj[None, :]).abs() > HALO, float("-inf"))
        out[:, :, q0:q1] = torch.logsumexp(s, dim=-1)
    return out


def _sdpa(q, k, v, mask=None) -> dict:
    """SDPA's fp32 forward (TF32 off) on contiguous [B, H, N, Dh] q, k, v:
    ms and its kernels."""
    assert not torch.backends.cuda.matmul.allow_tf32
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def run():
        with torch.no_grad():
            return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    return dict(sdpa_fwd_ms=_graph_ms(run, ITERS), sdpa_kernels=sorted(_kernel_ms(run, iters=2)),
                sdpa_allow_tf32=False)


def _row(label, case, kernel, shape, run, want, lse64, form, pairs, nbytes, sdpa, card,
         **extra) -> dict:
    out, lse = run()
    again = run()
    ms = _graph_ms(run, ITERS)
    kernels = _kernel_ms(run, iters=3)
    two_walks = shape[-1] == 256 and any("flash_fwd_f32_sm90" in name for name in kernels)
    units = (UNITS_TWO_WALKS if two_walks else UNITS)[form]
    want_out, _ = want
    ops = 4 * pairs
    return dict(label=label, case=case, kernel=kernel, shape=shape, form=form, **extra, ms=ms,
                kernels_ms=kernels,
                max_err_frac=float((out - want_out).abs().max() / want_out.abs().max()),
                lse_max_abs_err_fp64=float((lse.double() - lse64).abs().max()),
                repeats=bool(torch.equal(out, again[0]) and torch.equal(lse, again[1])),
                **sdpa, bound_ms=max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3,
                bound_by="bytes" if nbytes / PEAK_BYTES > ops / PEAK_FLOPS else "operations",
                nominal_tflops=ops / ms / 1e9, executed_units=units,
                executed_tflops=units * pairs / ms / 1e9, card=card)


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
        q, k, v = _inputs(gen, b, nq, nk, h, dh, packed)
        single = fa.uses_single_kstep(nk)
        form = "single step" if single else "streaming"
        want = fa.flash_fwd_ref(q, k, v, s, return_lse=True,
                                block_k=nk if single else _build.FLASH_STREAM_BLOCK_K)
        emit(_row(args.label, case, "#8", [b, nq, nk, h, dh],
                  lambda: _build.flash_fwd(q, k, v, s, streaming=not single, with_lse=True),
                  want, _lse64(q, k, s), form, b * h * nq * nk * dh,
                  4 * b * h * dh * (2 * nq + 2 * nk) + 4 * b * h * nq, _sdpa(q, k, v), card))
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
        sdpa = _sdpa(q, k, v, mask)
        del mask
        pairs = sum((min(n, (j + 1) * BLOCK) - j * BLOCK) * (hi - lo)
                    for j in range(-(-n // BLOCK))
                    for lo, hi in [la.window(j, n, BLOCK, HALO)])
        emit(_row(args.label, case, "#12", [b, n, h, dh],
                  lambda: _build.local_fwd(q, k, v, s, BLOCK, HALO, with_lse=True), want,
                  _lse64(q, k, s, BLOCK), "single step", b * h * pairs * dh,
                  4 * b * n * h * dh * 4 + 4 * b * h * n, sdpa, card, block=BLOCK, halo=HALO))
        del q, k, v, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
