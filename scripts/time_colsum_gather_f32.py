"""Time the port's ``colsum`` (#6's bias gradients) and #14's fp32 kernel
on the card, at the main path's shapes, through launcher calls that every
tree of the port since its fp32 kernels has (``_build.colsum(x)``,
``_build.gather_project(x, lut, w, bias, group)``), so that two trees can
be compared in one call on one card:

    PYTHONPATH=<tree> python scripts/time_colsum_gather_f32.py --label <name>

Each case is timed by one replay of a CUDA graph of 20 calls (the calls
last microseconds, under the Python launch path), twice, and printed as
one JSON line with the card's name and power limit.  Needs an NVIDIA GPU;
imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch


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


#: colsum: (rows, cols, dtype): the notebook's fp32 db_in and db_out at
#: batch 32, the flagship's bf16 and fp32 at batch 512, 'hier''s bf16.
COLSUM = ((2048, 768, torch.float32), (2048, 256, torch.float32),
          (32768, 768, torch.bfloat16), (32768, 2304, torch.bfloat16),
          (32768, 768, torch.float32), (32768, 2304, torch.float32),
          (32768, 256, torch.bfloat16))
#: #14 fp32: (label, batch, n, k, group), D = 256: the notebook's fused 2-D
#: tokenizer, the 1-D tokenizer at patch 4, the flagship's three levels.
GATHER = (("2-D, notebook", 32, 64, 48, 1), ("1-D at patch 4", 32, 1024, 3, 4),
          ("flagship level 0", 512, 1024, 3, 16), ("flagship level 1", 512, 256, 12, 4),
          ("flagship level 2", 512, 64, 48, 1))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--label", default="tree")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to time", file=sys.stderr)
        return 1
    from sfc_vit_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for rows, cols, dt in COLSUM:
            x = torch.randn(rows, cols, generator=gen).to("cuda", dt)
            ms = [_graph_ms(lambda: _build.colsum(x)) for _ in range(2)]
            print(json.dumps({"tree": args.label, "kernel": "colsum",
                              "shape": [rows, cols], "dtype": str(dt), "ms": ms,
                              "card": card}))
        for label, b, n, k, group in GATHER:
            x = torch.randn(b, n, k, generator=gen).cuda()
            lut = torch.randperm(n, generator=gen).to("cuda", torch.int32)
            w = (torch.randn(group * k, 256, generator=gen) * (group * k) ** -0.5).cuda()
            bias = torch.randn(256, generator=gen).cuda()
            ms = [_graph_ms(lambda: _build.gather_project(x, lut, w, bias, group))
                  for _ in range(2)]
            print(json.dumps({"tree": args.label, "kernel": "gather_project_f32",
                              "case": label, "x": [b, n, k], "group": group, "ms": ms,
                              "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
