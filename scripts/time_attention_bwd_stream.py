"""Time the port's bf16 packed attention backward (#4, and #6 with its
dropout mask) on the card at the shapes past the resident form's limits
and at the resident form's main-path shapes, through the launcher call
every tree of the port has (``_build.attention_bwd``), so that two trees
can be compared in one call on one card:

    PYTHONPATH=<tree> python scripts/time_attention_bwd_stream.py --label <name>

Each case prints one JSON line: the route the tree takes, the call's time
by one replay of a CUDA graph of 20 calls, the CUDA kernels it launched
and their device time (``torch.profiler``), its largest error against the
plain version ``attention_bwd_ref`` as a fraction of the plain version's
largest |value|, whether a second call gives the same bits, SDPA's bf16
autograd backward on contiguous q, k, v without the mask (a yardstick of
the unmasked work), the bound (the larger of 10 B H N^2 Dh over 989
TFLOP/s and the bytes over 3.35 TB/s: qkv, att, datt, lse and the mask
read, dqkv written), and the card's name and power limit.  Needs an
NVIDIA GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

#: (label, b, n, heads, dh, masked).  Past the resident form's limits:
#: 'hier''s fusion layers at 2 heads, the flagship at 3, the notebook's
#: 1-D tokenizer at patch 4 (256 tokens) and at patch 1 over 32 x 32 px
#: (1,024), ViT-B/16 at 384 px (576 tokens) and at 6 heads of 128.  Then
#: the resident form's main-path shapes: ViT-B/16 at batch 256, the
#: flagship, 'hier''s level and fusion layers.
CASES = (("hier fusion, 2 heads", 512, 192, 2, 128, True),
         ("hier fusion, 2 heads, #4", 512, 192, 2, 128, False),
         ("flagship, 3 heads", 512, 64, 3, 256, True),
         ("flagship, 3 heads, #4", 512, 64, 3, 256, False),
         ("1-D tokenizer, patch 4", 512, 256, 4, 64, True),
         ("1-D tokenizer, patch 1", 32, 1024, 4, 64, True),
         ("ViT-B/16 at 384 px", 64, 576, 12, 64, False),
         ("ViT-B/16, 6 heads of 128", 256, 196, 6, 128, False),
         ("ViT-B/16 (resident)", 256, 196, 12, 64, False),
         ("flagship (resident)", 512, 64, 4, 192, True),
         ("hier level (resident)", 512, 64, 4, 64, True),
         ("hier fusion (resident)", 512, 192, 4, 64, True))
KEEP = 0.9
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


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


def _events_ms(fn, iters: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
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


def _sdpa_bwd_ms(q, k, v, g, mask=None) -> float:
    """SDPA's bf16 autograd backward on contiguous [B, H, N, Dh] q, k, v,
    with ``mask`` as its boolean attention mask where given (CUDA events:
    autograd does not capture into a graph)."""
    q, k, v = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    g = g.transpose(1, 2).contiguous()
    return _events_ms(lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True), 10)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--label", default="tree")
    p.add_argument("--cases", default="", help="comma-separated case indices (default all)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to time", file=sys.stderr)
        return 1
    from sfc_vit_tpu_torch.ops import _build
    from sfc_vit_tpu_torch.ops.fused_attention_block import attention_bwd_ref, attention_fwd_ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    pick = {int(i) for i in args.cases.split(",") if i}
    gen = torch.Generator().manual_seed(0)
    for i, (label, b, n, h, dh, masked) in enumerate(CASES):
        if pick and i not in pick:
            continue
        s = dh ** -0.5
        mask = (torch.rand(b, h, n, n, generator=gen) < KEEP).cuda() if masked else None
        kw = dict(mask=mask, keep=KEEP) if masked else {}
        qkv = torch.randn(b, n, 3 * h * dh, generator=gen).to("cuda", torch.bfloat16)
        datt = torch.randn(b, n, h * dh, generator=gen).to("cuda", torch.bfloat16)
        att, lse = attention_fwd_ref(qkv, h, n, s, **kw)

        def run():
            return _build.attention_bwd(qkv, att, datt, lse, h, n, s, **kw)
        got = run()
        want = attention_bwd_ref(qkv, att, datt, lse, h, n, s, **kw)
        err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        repeats = bool(torch.equal(got, run()))
        plain_ms = _events_ms(lambda: attention_bwd_ref(qkv, att, datt, lse, h, n, s, **kw))
        del want
        q, k, v = qkv.view(b, n, 3, h, dh).unbind(2)
        sdpa_ms = _sdpa_bwd_ms(q, k, v, datt.view(b, n, h, dh))
        flops = 10 * b * h * n * n * dh
        nbytes = 2 * b * n * h * dh * (3 + 2 + 3) + 4 * b * h * n + (b * h * n * n if masked else 0)
        bound = max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3
        row = dict(label=args.label, case=label, shape=[b, n, h, dh], masked=masked,
                   route=_build.attention_bwd_route(dh, n, masked), ms=_graph_ms(run),
                   kernels_ms=_kernel_ms(run), max_err_frac=err, repeats=repeats,
                   plain_ms=plain_ms, sdpa_bwd_ms=sdpa_ms, bound_ms=bound,
                   bound_by="bytes" if nbytes / PEAK_BYTES > flops / PEAK_FLOPS else "operations",
                   card=card)
        print(json.dumps(row), flush=True)
        del qkv, datt, att, lse, mask, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
