"""Time and profile one train step of longctx-16k at 3 heads of ``dim_head``
128 at the JAX CLI's own fp32 (``preset_config("longctx-16k", dtype=None,
n_heads=3, dim_head=128, depth=2)``: 16,384 tokens, the flash kernels #8,
#10 and #11 in fp32 at Dh 128) at batch 2 on the card, through the entry
points every tree of the port has had since its fp32 long-context slice,
so that two trees can be compared in one call on one card:

    PYTHONPATH=<tree> python scripts/profile_longctx_f32_step.py --label <name>

Prints one JSON line: the step's time (host clock around 3 steps that end
in a synchronize, after 2 warm-up steps), the device time of each kernel
by name over 2 steps (``torch.profiler``), the device's busy time a step
and idle share, and the card's name and power limit.  The update's
learning rate is 0 and mixing is off, so every step does the same work
(``chip_smoke.py``'s phase 18 profiles the same step).  Needs an NVIDIA
GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

BATCH = 2


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--label", default="tree")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to time", file=sys.stderr)
        return 1
    from sfc_vit_tpu_torch.registry import build_model, preset_config
    from sfc_vit_tpu_torch.training import TrainState, make_optimizer, make_train_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    cfg = preset_config("longctx-16k", dtype=None, n_heads=3, dim_head=128, depth=2)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    state = TrainState(model, make_optimizer(model.parameters(), lambda _: 0.0,
                                             grad_clip=float("inf")))
    step = make_train_step(cfg.num_classes, use_mixing=False)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(BATCH, cfg.img_size, cfg.img_size, 3, generator=gen).cuda()
    y = torch.randint(0, cfg.num_classes, (BATCH,), generator=gen).cuda()

    def one():
        step(state, (x, y), torch.Generator())
    for _ in range(2):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        one()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 3 * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            one()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 2e3
    busy_ms = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
    tokens = (cfg.img_size // cfg.patch_size) ** 2
    print(json.dumps(dict(label=args.label, batch=BATCH, tokens=tokens, step_ms=step_ms,
                          busy_ms=busy_ms,
                          idle_share=1 - busy_ms * 2e3 / wall_us, kernels_ms=top, card=card)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
