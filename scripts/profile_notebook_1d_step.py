"""Time and profile one train step of the reference notebook's model over
the 1-D tokenizer at patch 4 (``preset_config("notebook", tokenizer="1d",
fused=True, dtype="bfloat16")``: 256 tokens, 4 heads of 64, dropout 0.1)
at batch 512 on the card, through the entry points every tree of the port
since its notebook slice has, so that two trees can be compared in one
call on one card:

    PYTHONPATH=<tree> python scripts/profile_notebook_1d_step.py --label <name>

Prints one JSON line: the step's time (host clock around 5 steps that end
in a synchronize, after 2 warm-up steps), the device time of each kernel
by name over 2 steps (``torch.profiler``), the device's busy time and idle
share, and the card's name and power limit.  The update's learning rate is
0, so every step does the same work.  Needs an NVIDIA GPU; imports no
JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

BATCH = 512


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
    cfg = preset_config("notebook", tokenizer="1d", fused=True, dtype="bfloat16")
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    state = TrainState(model, make_optimizer(model.parameters(), lambda _: 0.0,
                                             grad_clip=float("inf")))
    step = make_train_step(cfg.num_classes)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(BATCH, cfg.img_size, cfg.img_size, 3, generator=gen).cuda()
    y = torch.randint(0, cfg.num_classes, (BATCH,), generator=gen).cuda()
    dgen = torch.Generator(device="cuda").manual_seed(0)

    def one():
        step(state, (x, y), gen, dgen)
    for _ in range(2):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        one()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3

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
    print(json.dumps(dict(label=args.label, batch=BATCH, tokens=cfg.img_size ** 2 // 16,
                          step_ms=step_ms, img_per_s=BATCH / step_ms * 1e3,
                          busy_ms=busy_ms, idle_share=1 - busy_ms * 2e3 / wall_us,
                          kernels_ms=top, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
