#!/usr/bin/env python3
"""Drive the PyTorch port's ViT-B/16 serving path once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one
                                 # NVIDIA H100 (sm_90a) and nvcc

Phases, each of which raises (non-zero exit) on failure:

1. device: a CUDA device is present; prints its name and power limit;
2. build: compiles the hand-written kernels (sfc_vit_tpu_torch/csrc)
   with nvcc and loads them;
3. kernels: each fused block against its plain PyTorch version at the
   ViT-B/16 serving shapes (x [64, 196, 768] bf16, 12 heads of 64,
   F = 3072), with its error, tolerance and time beside the plain one;
4. slice: CurveViT ViT-B/16 (Hilbert order, bf16, random weights from a
   seed) behind ServingEngine(batch_sizes=(8, 64)) answers requests of
   1, 37 and 64 images; the logits must be finite, the kernel launch
   counters must equal depth x forwards, and the logits must agree with
   the same forward through the plain versions; prints img/s at batch 64.

The line before the last is one JSON object describing the kernels; the
last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

import sfc_vit_tpu_torch.models.simple_vit as simple_vit
from sfc_vit_tpu_torch.ops import _build
from sfc_vit_tpu_torch.ops.fused_attention_block import (
    attention_block_ref,
    fused_attention_block,
)
from sfc_vit_tpu_torch.ops.fused_mlp import fused_mlp_block, mlp_block_ref
from sfc_vit_tpu_torch.registry import build_model, preset_config
from sfc_vit_tpu_torch.serving import ServingEngine

B, N, D, HEADS, F = 64, 196, 768, 12, 3072
#: One block, bf16: the kernels round at other points than the plain
#: versions (fc1 kept in fp32 through the GELU, residuals added in fp32
#: before one rounding), a few bf16 ulps at |x| ~ 4.
BLOCK_TOL = dict(rtol=4e-2, atol=4e-2)
#: Logits after 12 bf16 layers of each path: per-layer rounding
#: differences compound through the residual stream (0.016 measured at
#: max |logit| ~3 on an H100).
LOGIT_TOL = dict(rtol=5e-2, atol=5e-2)
REQUESTS = (1, 37, 64)
BATCH_SIZES = (8, 64)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _agree(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float):
    """(max abs error, every element within atol + rtol * |want|)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return float(err.max()), bool((err <= atol + rtol * want.abs()).all())


def _ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call, CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _ab_ms(kernel, plain, iters: int = 20):
    """Times in turns (plain, kernel, kernel, plain) in one process."""
    p1, k1, k2, p2 = (_ms(f, iters) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def _randn(gen, *shape, scale=1.0, shift=0.0, dtype=torch.bfloat16):
    t = torch.randn(*shape, generator=gen) * scale + shift
    return t.to("cuda", dtype)


def phase_device() -> str:
    _check(torch.cuda.is_available(), "no CUDA device: the port's path needs one")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    info = _build.build()
    _build.library()
    print(f"build: nvcc {info['seconds']:.1f} s, build and load "
          f"{time.perf_counter() - t0:.1f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())


def phase_kernels(card: str) -> dict:
    gen = torch.Generator().manual_seed(0)
    x = _randn(gen, B, N, D)
    ln = (_randn(gen, D, scale=0.1, shift=1.0, dtype=torch.float32),
          _randn(gen, D, scale=0.1, dtype=torch.float32))
    mlp_w = (_randn(gen, D, F, scale=D ** -0.5), _randn(gen, F, scale=0.1),
             _randn(gen, F, D, scale=F ** -0.5), _randn(gen, D, scale=0.1))
    attn_w = (_randn(gen, D, 3 * D, scale=D ** -0.5),
              _randn(gen, D, D, scale=D ** -0.5))
    results = {}
    with torch.inference_mode():
        got, want = fused_mlp_block(x, *ln, *mlp_w), mlp_block_ref(x, *ln, *mlp_w)
        err, ok = _agree(got, want, **BLOCK_TOL)
        print(f"fused_mlp_block vs mlp_block_ref: max abs err {err:.4g} "
              f"(tolerance rtol {BLOCK_TOL['rtol']}, atol {BLOCK_TOL['atol']})")
        _check(ok, "fused_mlp_block disagrees with mlp_block_ref")
        ms, plain_ms = _ab_ms(lambda: fused_mlp_block(x, *ln, *mlp_w),
                              lambda: mlp_block_ref(x, *ln, *mlp_w))
        print(f"fused_mlp_block kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"x [{B}, {N}, {D}] F={F} bf16, {card}")
        results["fused_mlp_block"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

        errs = []
        for n_actual in (None, 150):
            got = fused_attention_block(x, *ln, *attn_w, HEADS, n_actual=n_actual)
            want = attention_block_ref(x, *ln, *attn_w, HEADS, n_actual=n_actual)
            real = N if n_actual is None else n_actual
            err, ok = _agree(got[:, :real], want[:, :real], **BLOCK_TOL)
            print(f"fused_attention_block vs attention_block_ref, n_actual="
                  f"{n_actual}: max abs err {err:.4g} on the {real} real rows "
                  f"(tolerance rtol {BLOCK_TOL['rtol']}, atol {BLOCK_TOL['atol']})")
            _check(ok, f"fused_attention_block disagrees at n_actual={n_actual}")
            errs.append(err)
        ms, plain_ms = _ab_ms(
            lambda: fused_attention_block(x, *ln, *attn_w, HEADS),
            lambda: attention_block_ref(x, *ln, *attn_w, HEADS))
        print(f"fused_attention_block kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, x [{B}, {N}, {D}] {HEADS} heads of 64 bf16, {card}")
        results["fused_attention_block"] = dict(max_abs_err=max(errs), ms=ms,
                                                plain_ms=plain_ms)
    return results


def _plain_blocks():
    """Route the model's blocks through the plain versions (comparison only)."""
    return mock.patch.multiple(simple_vit, fused_attention_block=attention_block_ref,
                               fused_mlp_block=mlp_block_ref)


def phase_slice(card: str) -> dict:
    cfg = preset_config("vit-b-16", curve="hilbert", num_classes=1000,
                        dtype="bfloat16")
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    engine = ServingEngine(model, None, (cfg.img_size, cfg.img_size, 3),
                           batch_sizes=BATCH_SIZES, dtype=torch.bfloat16,
                           device="cuda")
    rng = np.random.default_rng(0)
    requests = [rng.standard_normal((n, cfg.img_size, cfg.img_size, 3),
                                    dtype=np.float32) for n in REQUESTS]

    fused_attention_block.launches = 0
    fused_mlp_block.launches = 0
    outs = [engine.predict(r) for r in requests]
    launches = {"fused_attention_block": fused_attention_block.launches,
                "fused_mlp_block": fused_mlp_block.launches}

    forwards = sum(-(-n // BATCH_SIZES[-1]) for n in REQUESTS)
    for n, out in zip(REQUESTS, outs):
        print(f"request of {n} images -> logits {out.shape}, "
              f"finite {bool(np.isfinite(out).all())}")
        _check(out.shape == (n, cfg.num_classes), f"bad logits shape {out.shape}")
        _check(bool(np.isfinite(out).all()), "non-finite logits")
    print(f"launches over {forwards} forwards of depth {cfg.depth}: {launches}")
    for name, count in launches.items():
        _check(count == cfg.depth * forwards,
               f"{name} launched {count} times, expected {cfg.depth * forwards}")

    with _plain_blocks():
        plain = [engine.predict(r) for r in requests]
    err, ok = _agree(torch.from_numpy(np.concatenate(outs)),
                     torch.from_numpy(np.concatenate(plain)), **LOGIT_TOL)
    scale = float(np.abs(np.concatenate(plain)).max())
    print(f"logits, kernels vs plain versions: max abs err {err:.4g} (max "
          f"|logit| {scale:.4g}; tolerance rtol {LOGIT_TOL['rtol']}, atol "
          f"{LOGIT_TOL['atol']})")
    _check(ok, "served logits disagree with the plain-version forward")

    x64 = torch.from_numpy(requests[-1]).to("cuda", torch.bfloat16)
    with torch.inference_mode():
        fwd_ms = _ms(lambda: engine.model(x64), iters=10)
        with _plain_blocks():
            plain_fwd_ms = _ms(lambda: engine.model(x64), iters=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        engine.predict(requests[-1])
    serve_s = (time.perf_counter() - t0) / 5
    bs = BATCH_SIZES[-1]
    print(f"forward at batch {bs}: {fwd_ms:.3f} ms = {bs / fwd_ms * 1e3:.1f} "
          f"img/s (plain versions {plain_fwd_ms:.3f} ms = "
          f"{bs / plain_fwd_ms * 1e3:.1f} img/s), {card}")
    print(f"predict() of {bs} images, host to host: {serve_s * 1e3:.3f} ms = "
          f"{bs / serve_s:.1f} img/s, {card}")
    return launches


def main() -> int:
    card = phase_device()
    phase_build()
    kernels = phase_kernels(card)
    launches = phase_slice(card)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax"))
    _check(not leaked, f"the port imported {leaked}")
    entries = [
        dict(name="fused_attention_block", route="cuda",
             source="sfc_vit_tpu_torch/csrc/attention_fwd.cu",
             replaces="sfc_vit_tpu/ops/fused_attention_block.py:104"),
        dict(name="fused_mlp_block", route="cuda",
             source="sfc_vit_tpu_torch/csrc/gemm_bf16.cu",
             replaces="sfc_vit_tpu/ops/fused_mlp.py:104"),
    ]
    for e in entries:
        e.update(launches=launches[e["name"]], **kernels[e["name"]])
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
