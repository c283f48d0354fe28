"""Time the port's packed attention forward and backward (#1, #4-#7) on the
card at the main paths' head dims 64 and 192, bf16 and fp32, through the
launcher calls every tree of the port since its fp32 attention has
(``_build.attention_fwd``, ``_build.attention_bwd``), so that two trees
can be compared in one call on one card:

    PYTHONPATH=<tree> python scripts/time_attention_head_dims.py --label <name>

Each case is timed by one replay of a CUDA graph of 20 calls, and the
fp32 backward's two kernels (dq, then dk/dv) apart by ``torch.profiler``;
each printed as one JSON line with the card's name and power limit.
Needs an NVIDIA GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

#: (label, b, n, heads, dh, masked): the forward's and backward's main-path
#: shapes at Dh 64 and 192: ViT-B/16 at batch 256 (196 tokens, 12 heads of
#: 64), the flagship at batch 512 (4 heads of 192) and 'hier''s level and
#: fusion layers (4 heads of 64 over 64 and 192 tokens), and the notebook's
#: fp32 layer at batch 32.
CASES = (("ViT-B/16", 256, 196, 12, 64, False), ("flagship", 512, 64, 4, 192, True),
         ("hier level", 512, 64, 4, 64, True), ("hier fusion", 512, 192, 4, 64, True),
         ("notebook", 32, 64, 4, 64, True))


def _graph_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_ms(fn, iters: int = 10) -> dict:
    """Device ms per call of each CUDA kernel ``fn`` launches, by name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
        if us > 0:
            out[e.key] = us / 1e3 / iters
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--label", default="tree")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to time", file=sys.stderr)
        return 1
    from sfc_vit_tpu_torch.ops import _build
    from sfc_vit_tpu_torch.ops.fused_attention_block import attention_fwd_ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator().manual_seed(0)
    for label, b, n, h, dh, masked in CASES:
        s = dh ** -0.5
        mask = (torch.rand(b, h, n, n, generator=gen) < 0.9).cuda() if masked else None
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn(b, n, 3 * h * dh, generator=gen).to("cuda", dtype)
            datt = torch.randn(b, n, h * dh, generator=gen).to("cuda", dtype)
            att, lse = attention_fwd_ref(qkv, h, n, s, mask=mask, keep=0.9)
            kw = dict(mask=mask, keep=0.9) if masked else {}
            row = dict(label=args.label, case=label, shape=[b, n, h, dh], masked=masked,
                       dtype=str(dtype).split(".")[-1], card=card,
                       fwd_ms=_graph_ms(lambda: _build.attention_fwd(qkv, h, n, s, **kw)),
                       fwd_lse_ms=_graph_ms(lambda: _build.attention_fwd(
                           qkv, h, n, s, with_lse=True, **kw)),
                       bwd_ms=_graph_ms(lambda: _build.attention_bwd(
                           qkv, att, datt, lse, h, n, s, **kw)))
            if dtype == torch.float32:
                row["bwd_kernels_ms"] = _kernel_ms(
                    lambda: _build.attention_bwd(qkv, att, datt, lse, h, n, s, **kw))
            print(json.dumps(row), flush=True)
            del qkv, datt, att, lse
        del mask
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
