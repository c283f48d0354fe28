#!/usr/bin/env python3
"""Drive the PyTorch port's ViT-B/16 serving path and train step, and the
family-A flagship's train step and serving path, once on one NVIDIA GPU.

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
3b. backward kernels: each block's CUDA backward against its plain
   version (``*_bwd_ref``) fed the same saved tensors at the train
   slice's shapes (x [256, 196, 768] bf16; attention with n_actual None
   and 150), every gradient's error beside its tolerance; each block's
   backward, and its forward + backward, timed against autograd of the
   plain forward;
5. train slice: Trainer + CurveViT ViT-B/16 (fp32 params, bf16 compute,
   mixup/cutmix on) for one epoch of 4 steps at batch 256 on
   synthetic_dataset(n=1024, hw=224, 1000 classes), then evaluate on 256
   images; the loss must be finite, every parameter must have moved and
   each block's backward must have launched depth x steps times; one step's
   gradients through the kernels against the plain blocks; train step
   img/s at batch 256 on both paths; a profile of the kernel path's step
   (device time by kernel, idle share).
6. flagship kernels: kernels #5 and #6 (``fused_torch_mha`` forward and
   backward, batch 512, 64 tokens, D = 768, 4 heads of 192, keep 0.9,
   one dropout mask for both; n_actual None and 50) and #7
   (``packed_flash_attention``, batch 256) against their plain versions,
   each error beside its tolerance; each timed beside its plain version,
   its bound, and for #7 ``F.scaled_dot_product_attention``.
7. flagship slice: ``build_model(preset_config("flagship",
   dtype="bfloat16"))`` on the card, ``Trainer.fit`` for one epoch of 4
   steps at batch 512 on synthetic_dataset(n=2048, hw=32, 10 classes),
   then ``evaluate`` on 512 images; every loss finite, every parameter
   moved, #5 and #6 launched depth x steps times and #7 depth x eval
   forwards; one train step (mixing and dropout on) through the kernels
   against the same step through the plain versions, the same draws;
   ``ServingEngine(batch_sizes=(16, 256))`` answers 1, 100 and 256
   images, logits against the plain forward; train img/s both paths,
   forward img/s at batch 256, peak memory, a profile of the train step.
   Then no module of jax, flax or the JAX package may have loaded.

The line before the last is one JSON object describing the kernels; the
last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import re
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as TF

import sfc_vit_tpu_torch.models.layers as fa_layers
import sfc_vit_tpu_torch.models.simple_vit as simple_vit
import sfc_vit_tpu_torch.ops.attention as fa_attention
from sfc_vit_tpu_torch.data import epoch_batches, make_eval_transform, synthetic_dataset
from sfc_vit_tpu_torch.ops import _build
from sfc_vit_tpu_torch.ops.fused_attention_block import (
    attention_block_bwd,
    attention_block_bwd_ref,
    attention_block_ref,
    attention_block_train_fwd,
    fused_attention_block,
)
from sfc_vit_tpu_torch.ops.flash_attention import _packed_xla_ref, packed_flash_attention
from sfc_vit_tpu_torch.ops.fused_torch_attention import (
    fused_torch_mha,
    torch_mha_bwd,
    torch_mha_bwd_ref,
    torch_mha_fwd_ref,
    torch_mha_train,
    torch_mha_train_fwd,
)
from sfc_vit_tpu_torch.ops.fused_mlp import (
    fused_mlp_block,
    mlp_block_bwd,
    mlp_block_bwd_ref,
    mlp_block_ref,
    mlp_block_train_fwd,
)
from sfc_vit_tpu_torch.registry import build_model, preset_config
from sfc_vit_tpu_torch.serving import ServingEngine
from sfc_vit_tpu_torch.training import (
    TrainConfig,
    Trainer,
    TrainState,
    make_optimizer,
    make_train_step,
)

DEVICE = "cuda"
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
TRAIN_B, TRAIN_STEPS = 256, 4
#: One block's backward, bf16, at batch 256: the kernels round dz, pn, ds
#: and dqkv to bf16 where the plain versions do, but sums taken in another
#: order flip some of those roundings by one ulp (2^-8), and the weight
#: gradients sum 50,176 rows; every error is held within this fraction of
#: its tensor's largest |value|.
BWD_TOL = 2e-2
#: Gradients of one train step (12 bf16 layers), kernels against the plain
#: blocks: relative L2 error of each parameter tensor's gradient.
GRAD_REL_TOL = 0.1
#: The family-A flagship: batch 512 (the CLI's and the reference's), 64
#: tokens, D = 768, 4 heads of 192, MLP 512, keep = 1 - 0.1.
FA_B, FA_N, FA_D, FA_HEADS, FA_KEEP = 512, 64, 768, 4, 0.9
FA_PACKED_B = 256
#: Served logits after 8 bf16 layers and the bf16 factorised head (a
#: 4,096-term sum), kernels against plain versions: within this fraction
#: of the largest |logit| (one bf16 ulp at |logit| 8-16 is 0.0625).
FA_LOGIT_TOL = 0.03
#: The fp32 log-sum-exp the training forward saves, against the same
#: function in fp64 of the qkv the kernel saved: fp32 sums and exp only.
LSE_TOL = dict(rtol=1e-5, atol=1e-5)
FA_TRAIN_STEPS = 4
FA_REQUESTS = (1, 100, 256)
FA_BATCH_SIZES = (16, 256)
#: The H100 SXM's published dense bf16 rate and memory rate (NVIDIA's data
#: sheet), the denominators of every bound.
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


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


def _bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def _randn(gen, *shape, scale=1.0, shift=0.0, dtype=torch.bfloat16):
    t = torch.randn(*shape, generator=gen) * scale + shift
    return t.to(DEVICE, dtype)


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
        r = B * N
        results["fused_mlp_block"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
            **_bound(4 * r * D * F, 2 * (2 * r * D + 2 * D * F + F + D) + 8 * D))

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
        results["fused_attention_block"] = dict(
            max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=None,
            **_bound(2 * r * D * 3 * D + 4 * B * HEADS * N * N * 64 + 2 * r * D * D,
                     2 * (2 * r * D + 4 * D * D) + 8 * D))
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


def _bwd_check(name: str, got, want, names) -> float:
    """Each gradient within BWD_TOL x its max |value|; returns the largest
    absolute error."""
    worst = 0.0
    for gname, a, w in zip(names, got, want):
        _check(a.dtype == w.dtype, f"{name} {gname}: dtype {a.dtype} != {w.dtype}")
        err = float((a.float() - w.float()).abs().max())
        scale = float(w.float().abs().max())
        print(f"  {gname}: max abs err {err:.4g}, max |value| {scale:.4g} "
              f"(tolerance {BWD_TOL} x max |value| = {BWD_TOL * scale:.4g})")
        _check(err <= BWD_TOL * scale, f"{name}: {gname} disagrees with the plain version")
        worst = max(worst, err)
    return worst


def _fwd_bwd(block, args, g, *, bwd_only: bool = False, **kw):
    """One forward + backward through ``block`` (autograd), grads dropped;
    with ``bwd_only`` the forward runs once here and each call is the
    backward alone."""
    leaves = [t.detach().clone().requires_grad_() for t in args]
    out = block(*leaves, **kw) if bwd_only else None

    def run():
        for t in leaves:
            t.grad = None
        if bwd_only:
            out.backward(g, retain_graph=True)
        else:
            block(*leaves, **kw).backward(g)
    return run


def phase_backward(card: str) -> dict:
    gen = torch.Generator().manual_seed(1)
    b = TRAIN_B
    x = _randn(gen, b, N, D)
    g = _randn(gen, b, N, D)
    ln = (_randn(gen, D, scale=0.1, shift=1.0, dtype=torch.float32),
          _randn(gen, D, scale=0.1, dtype=torch.float32))
    mlp_w = (_randn(gen, D, F, scale=D ** -0.5), _randn(gen, F, scale=0.1),
             _randn(gen, F, D, scale=F ** -0.5), _randn(gen, D, scale=0.1))
    attn_w = (_randn(gen, D, 3 * D, scale=D ** -0.5),
              _randn(gen, D, D, scale=D ** -0.5))
    results = {}

    with torch.no_grad():
        _, z = mlp_block_train_fwd(x, *ln, *mlp_w)
        got = mlp_block_bwd(x, g, *ln, *mlp_w[:3], z, mlp_w[3])
        want = mlp_block_bwd_ref(x, g, *ln, *mlp_w[:3], z, mlp_w[3])
    print(f"mlp_block_bwd vs mlp_block_bwd_ref, x [{b}, {N}, {D}] F={F}:")
    err = _bwd_check("mlp_block_bwd", got, want,
                     ("dx", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2"))
    del got, want
    ms, plain_ms = _ab_ms(
        lambda: mlp_block_bwd(x, g, *ln, *mlp_w[:3], z, mlp_w[3]),
        _fwd_bwd(mlp_block_ref, (x, *ln, *mlp_w), g, bwd_only=True), iters=10)
    del z
    both, both_plain = _ab_ms(_fwd_bwd(fused_mlp_block, (x, *ln, *mlp_w), g),
                              _fwd_bwd(mlp_block_ref, (x, *ln, *mlp_w), g), iters=10)
    print(f"fused_mlp_block backward: kernels {ms:.4f} ms, autograd backward "
          f"of the plain forward {plain_ms:.4f} ms; forward + backward: kernels "
          f"{both:.4f} ms, plain {both_plain:.4f} ms, {card}")
    r = b * N
    results["fused_mlp_block_bwd"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        **_bound(8 * r * D * F,
                 2 * (3 * r * D + r * F + 4 * D * F + 2 * F + 2 * D) + 16 * D))

    errs = []
    for n_actual in (None, 150):
        with torch.no_grad():
            _, qkv, att, lse = attention_block_train_fwd(x, *ln, *attn_w, HEADS,
                                                         n_actual=n_actual)
            got = attention_block_bwd(x, g, *ln, *attn_w, qkv, att, lse, HEADS,
                                      n_actual=n_actual)
            want = attention_block_bwd_ref(x, g, *ln, *attn_w, qkv, att, lse,
                                           HEADS, n_actual=n_actual)
        print(f"attention_block_bwd vs attention_block_bwd_ref, n_actual="
              f"{n_actual}, x [{b}, {N}, {D}] {HEADS} heads of 64:")
        errs.append(_bwd_check("attention_block_bwd", got, want,
                               ("dx", "dln_scale", "dln_bias", "dw_qkv", "dw_out")))
        if n_actual is not None:
            _check(torch.equal(got[0][:, n_actual:], g[:, n_actual:]),
                   "attention_block_bwd: pad rows do not pass g through")
        del got, want
    with torch.no_grad():  # n_actual=None's saved tensors for the timing
        _, qkv, att, lse = attention_block_train_fwd(x, *ln, *attn_w, HEADS)
    ms, plain_ms = _ab_ms(
        lambda: attention_block_bwd(x, g, *ln, *attn_w, qkv, att, lse, HEADS),
        _fwd_bwd(attention_block_ref, (x, *ln, *attn_w), g, bwd_only=True,
                 heads=HEADS), iters=10)
    del qkv, att, lse
    both, both_plain = _ab_ms(
        _fwd_bwd(fused_attention_block, (x, *ln, *attn_w), g, heads=HEADS),
        _fwd_bwd(attention_block_ref, (x, *ln, *attn_w), g, heads=HEADS), iters=10)
    print(f"fused_attention_block backward: kernels {ms:.4f} ms, autograd "
          f"backward of the plain forward {plain_ms:.4f} ms; forward + "
          f"backward: kernels {both:.4f} ms, plain {both_plain:.4f} ms, {card}")
    results["fused_attention_block_bwd"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=None,
        **_bound(4 * r * D * D + 12 * r * D * D + 10 * b * HEADS * N * N * 64,
                 2 * (3 * r * D + r * 3 * D + r * D + 8 * D * D) + 4 * b * HEADS * N
                 + 16 * D))
    return results


def _lr_zero_state(model) -> TrainState:
    """A state whose update changes nothing (lr 0, no clipping), so the
    gradients of a step stay readable and the params identical."""
    return TrainState(model, make_optimizer(model.parameters(), lambda _: 0.0,
                                            grad_clip=float("inf")))


def phase_train(card: str) -> dict:
    cfg = preset_config("vit-b-16", curve="hilbert", num_classes=1000,
                        dtype="bfloat16")
    model = build_model(cfg, device=DEVICE, generator=torch.Generator().manual_seed(0))
    stats = ((0.5,) * 3, (0.25,) * 3)  # the CLI's synthetic-data normalisation
    t0 = time.perf_counter()
    train_ds = synthetic_dataset(n=TRAIN_B * TRAIN_STEPS, hw=cfg.img_size,
                                 num_classes=cfg.num_classes, seed=0)
    test_ds = synthetic_dataset(n=TRAIN_B, hw=cfg.img_size,
                                num_classes=cfg.num_classes, seed=1)
    print(f"synthetic data: {len(train_ds)} + {len(test_ds)} images "
          f"{cfg.img_size}^2 in {time.perf_counter() - t0:.1f} s")
    tf = make_eval_transform(*stats, device=DEVICE)
    tcfg = TrainConfig(num_classes=cfg.num_classes, epochs=1, warmup_epochs=1)
    trainer = Trainer(model, tcfg, steps_per_epoch=TRAIN_STEPS)
    before = [p.detach().clone() for p in model.parameters()]

    fused_attention_block.launches = fused_mlp_block.launches = 0
    fused_attention_block.bwd_launches = fused_mlp_block.bwd_launches = 0
    record = trainer.fit(
        lambda: ((tf(x), y) for x, y in epoch_batches(train_ds, TRAIN_B, seed=0)),
        lambda: ((tf(x), y) for x, y in epoch_batches(
            test_ds, TRAIN_B, shuffle=False, drop_last=False)))
    torch.cuda.synchronize()
    launches = {"fused_attention_block_bwd": fused_attention_block.bwd_launches,
                "fused_mlp_block_bwd": fused_mlp_block.bwd_launches,
                "fused_attention_block": fused_attention_block.launches,
                "fused_mlp_block": fused_mlp_block.launches}
    print(f"Trainer.fit, 1 epoch of {TRAIN_STEPS} steps at batch {TRAIN_B} + "
          f"eval of {len(test_ds)}: {record}")
    print(f"launches over {TRAIN_STEPS} train steps + 1 eval batch of depth "
          f"{cfg.depth}: {launches}")
    _check(bool(np.isfinite(record["train_loss"])), "non-finite train loss")
    _check(bool(np.isfinite(record["test_loss"])), "non-finite eval loss")
    _check(trainer.state.step == TRAIN_STEPS, f"{trainer.state.step} steps taken")
    for name in ("fused_attention_block_bwd", "fused_mlp_block_bwd"):
        _check(launches[name] == cfg.depth * TRAIN_STEPS,
               f"{name} launched {launches[name]} times, expected "
               f"{cfg.depth * TRAIN_STEPS}")
    for name in ("fused_attention_block", "fused_mlp_block"):
        _check(launches[name] == cfg.depth * (TRAIN_STEPS + 1),
               f"{name} launched {launches[name]} times")
    still = [n for (n, p), q in zip(model.named_parameters(), before) if torch.equal(p, q)]
    _check(not still, f"parameters unchanged after {TRAIN_STEPS} steps: {still}")
    del before

    # One step from identical params and batch, kernels against plain blocks.
    x, y = next(epoch_batches(train_ds, TRAIN_B, seed=0))
    batch = (tf(x), torch.from_numpy(y).long().to(DEVICE))
    state = _lr_zero_state(model)
    step = make_train_step(cfg.num_classes, use_mixing=False)
    m_k = step(state, batch, torch.Generator())
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    with _plain_blocks():
        m_p = step(state, batch, torch.Generator())
    rel = {n: float((grads[n] - p.grad).norm() / p.grad.norm())
           for n, p in model.named_parameters()}
    worst = max(rel, key=rel.get)
    print(f"one train step, kernels vs plain blocks: loss {float(m_k['loss']):.6f} "
          f"vs {float(m_p['loss']):.6f}; gradient relative L2 error max "
          f"{rel[worst]:.4g} ({worst}), median {float(np.median(list(rel.values()))):.4g} "
          f"over {len(rel)} tensors (tolerance {GRAD_REL_TOL})")
    _check(rel[worst] <= GRAD_REL_TOL, "kernel-path gradients disagree with the plain path")
    del grads

    # Train step time at batch 256, mixing on, both paths in turns.
    mixing_step = make_train_step(cfg.num_classes)
    gen = torch.Generator().manual_seed(0)

    def step_ms(plain: bool, steps: int = 3) -> float:
        ctx = _plain_blocks() if plain else contextlib.nullcontext()
        with ctx:
            mixing_step(state, batch, gen)  # warm-up
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(steps):
                mixing_step(state, batch, gen)
            torch.cuda.synchronize()
        return (time.perf_counter() - t) / steps * 1e3

    p1, k1, k2, p2 = (step_ms(plain) for plain in (True, False, False, True))
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"train step at batch {TRAIN_B} (mixing, clip, AdamW): kernels "
          f"{k_ms:.2f} ms = {TRAIN_B / k_ms * 1e3:.1f} img/s, plain blocks "
          f"{p_ms:.2f} ms = {TRAIN_B / p_ms * 1e3:.1f} img/s, {card}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _profile(lambda: mixing_step(state, batch, gen), f"train step at batch {TRAIN_B}")
    return launches


#: The GEMM's three layouts, by template arguments <trans_a, trans_b>.
_GEMM_LABELS = {"gemm_bf16_kernel<false, false>": "gemm_bf16 NN (forward)",
                "gemm_bf16_kernel<false, true>": "gemm_bf16 NT (dX, dz, datt)",
                "gemm_bf16_kernel<true, false>": "gemm_bf16 TN (weight gradients)"}


def _kernel_label(name: str) -> str:
    short = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    for key, label in _GEMM_LABELS.items():
        if short.startswith(key):
            return label
    return re.split(r"[<(]", short, maxsplit=1)[0].strip()


def _profile(fn, what: str, steps: int = 2, top: int = 14) -> None:
    """Device time by kernel over ``steps`` calls of ``fn`` (torch.profiler,
    CUPTI), and the idle share: 1 - kernel time / host wall time of the
    window, which ends in a synchronize.  Tracing adds a few us per launch
    to the host side, so the idle share is an upper bound."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            label = _kernel_label(e.name)
            by_name[label] = by_name.get(label, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    _check(busy > 0, "the profiler saw no device time")
    print(f"profile of {steps} x {what}: device busy {busy / 1e3 / steps:.2f} ms of "
          f"{wall_us / 1e3 / steps:.2f} ms wall per call, idle share "
          f"{1 - busy / wall_us:.2%}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    for label, us in ranked[:top]:
        print(f"  {us / busy:7.2%}  {us / 1e3 / steps:9.3f} ms/call  {label}")
    if len(ranked) > top:
        rest = sum(us for _, us in ranked[top:])
        print(f"  {rest / busy:7.2%}  {rest / 1e3 / steps:9.3f} ms/call  "
              f"{len(ranked) - top} other kernels")


def _fa_inputs(gen, dgen):
    b, n, d = FA_B, FA_N, FA_D
    return dict(
        x=_randn(gen, b, n, d), g=_randn(gen, b, n, d),
        w_in=_randn(gen, d, 3 * d, scale=d ** -0.5), b_in=_randn(gen, 3 * d, scale=0.1),
        w_out=_randn(gen, d, d, scale=d ** -0.5), b_out=_randn(gen, d, scale=0.1),
        mask=torch.rand((b, FA_HEADS, n, n), device=DEVICE, generator=dgen) < FA_KEEP)


def _lse_of(qkv: torch.Tensor, heads: int, n_valid: int) -> torch.Tensor:
    """log-sum-exp over the valid keys of each query's scaled logits, in
    fp64, from the packed qkv: [B, H, N]."""
    b, n, w = qkv.shape
    q, k, _ = qkv.view(b, n, 3, heads, w // (3 * heads)).permute(2, 0, 3, 1, 4).double()
    logits = (q @ k[:, :, :n_valid].transpose(-1, -2)) * (w // (3 * heads)) ** -0.5
    return torch.logsumexp(logits, dim=-1)


def phase_fa_kernels(card: str) -> dict:
    """Kernels #5, #6 and #7 at the flagship's shapes against their plain
    versions, in bf16."""
    gen = torch.Generator().manual_seed(2)
    dgen = torch.Generator(device=DEVICE).manual_seed(2)
    a = _fa_inputs(gen, dgen)
    b, n, d, h = FA_B, FA_N, FA_D, FA_HEADS
    fwd = [a[k] for k in ("x", "w_in", "b_in", "w_out", "b_out", "mask")]
    results = {}
    errs, bwd_errs = [], []
    for n_actual in (None, 50):
        with torch.no_grad():
            got = torch_mha_train_fwd(*fwd, h, keep=FA_KEEP, n_actual=n_actual)
            want = torch_mha_fwd_ref(*fwd, h, keep=FA_KEEP, n_actual=n_actual,
                                     save_acts=True)
        for name, x, w in zip(("y", "qkv", "att"), got[:3], want[:3]):
            err, ok = _agree(x, w, **BLOCK_TOL)
            print(f"torch_mha_train_fwd vs torch_mha_fwd_ref, n_actual={n_actual}: "
                  f"{name} max abs err {err:.4g} (tolerance rtol {BLOCK_TOL['rtol']}, "
                  f"atol {BLOCK_TOL['atol']})")
            _check(ok, f"kernel #5 disagrees on {name} at n_actual={n_actual}")
            errs.append(err)
        lse_err, lse_ok = _agree(got[3], _lse_of(got[1], h, n_actual or n), **LSE_TOL)
        print(f"  lse: max abs err {lse_err:.4g} (tolerance rtol {LSE_TOL['rtol']}, "
              f"atol {LSE_TOL['atol']})")
        _check(lse_ok, "kernel #5: lse disagrees")
        _, qkv, att, lse = got
        saved = (a["x"], a["g"], a["w_in"], a["w_out"], a["mask"], qkv, att, lse)
        with torch.no_grad():
            g_k = torch_mha_bwd(*saved, h, keep=FA_KEEP, n_actual=n_actual)
            g_p = torch_mha_bwd_ref(*saved, h, keep=FA_KEEP, n_actual=n_actual)
        print(f"torch_mha_bwd vs torch_mha_bwd_ref, n_actual={n_actual}, "
              f"x [{b}, {n}, {d}] {h} heads of {d // h}:")
        bwd_errs.append(_bwd_check("torch_mha_bwd", g_k, g_p,
                                   ("dx", "dw_in", "db_in", "dw_out", "db_out")))
        if n_actual is not None:
            _check(not g_k[0][:, n_actual:].any(), "kernel #6: pad rows have dx")
        del got, want, g_k, g_p, qkv, att, lse
    r = b * n
    with torch.no_grad():
        _, qkv, att, lse = torch_mha_train_fwd(*fwd, h, keep=FA_KEEP)
        saved = (a["x"], a["g"], a["w_in"], a["w_out"], a["mask"], qkv, att, lse)
        ms, plain_ms = _ab_ms(lambda: torch_mha_train_fwd(*fwd, h, keep=FA_KEEP),
                              lambda: torch_mha_fwd_ref(*fwd, h, keep=FA_KEEP,
                                                        save_acts=True), iters=10)
        bms, bplain_ms = _ab_ms(lambda: torch_mha_bwd(*saved, h, keep=FA_KEEP),
                                lambda: torch_mha_bwd_ref(*saved, h, keep=FA_KEEP),
                                iters=10)
    attn_flops = 2 * b * h * n * n * (d // h)
    results["fused_torch_mha"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=None,
        **_bound(8 * r * d * d + 2 * attn_flops,
                 2 * (r * d + 4 * d * d + 4 * d + r * d + r * 3 * d + r * d)
                 + b * h * n * n + 4 * b * h * n))
    results["fused_torch_mha_bwd"] = dict(
        max_abs_err=max(bwd_errs), ms=bms, plain_ms=bplain_ms, library_ms=None,
        **_bound(16 * r * d * d + 5 * attn_flops,
                 2 * (2 * r * d + 4 * d * d + r * 3 * d + r * d + r * d)
                 + b * h * n * n + 4 * b * h * n + 4 * (4 * d * d + 4 * d)))
    print(f"fused_torch_mha (#5, training forward) kernels {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {results['fused_torch_mha']['bound_ms']:.4f} ms; "
          f"backward (#6) kernels {bms:.4f} ms, plain {bplain_ms:.4f} ms, bound "
          f"{results['fused_torch_mha_bwd']['bound_ms']:.4f} ms; x [{b}, {n}, {d}] "
          f"bf16, {card}.  No single PyTorch call computes either: SDPA's dropout "
          "cannot take a given mask.")
    del a, fwd, saved, qkv, att, lse

    pb = FA_PACKED_B
    qkv = _randn(gen, pb, n, 3 * d)
    s = (d // h) ** -0.5
    with torch.no_grad():
        got = packed_flash_attention(qkv, h)
        want = _packed_xla_ref(qkv, h, s)
        err, ok = _agree(got, want, **BLOCK_TOL)
        print(f"packed_flash_attention vs _packed_xla_ref, qkv [{pb}, {n}, {3 * d}]: "
              f"max abs err {err:.4g} (tolerance rtol {BLOCK_TOL['rtol']}, atol "
              f"{BLOCK_TOL['atol']})")
        _check(ok, "kernel #7 disagrees with _packed_xla_ref")
        q, k, v = (t.contiguous() for t in
                   qkv.view(pb, n, 3, h, d // h).permute(2, 0, 3, 1, 4))
        ms, plain_ms = _ab_ms(lambda: packed_flash_attention(qkv, h),
                              lambda: _packed_xla_ref(qkv, h, s))
        lib_ms = _ms(lambda: TF.scaled_dot_product_attention(q, k, v))
    results["packed_flash_attention"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        **_bound(4 * pb * h * n * n * (d // h), 2 * (pb * n * 3 * d + pb * n * d)))
    print(f"packed_flash_attention (#7) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"F.scaled_dot_product_attention {lib_ms:.4f} ms, bound "
          f"{results['packed_flash_attention']['bound_ms']:.4f} ms, qkv [{pb}, {n}, "
          f"{3 * d}] bf16, {card}")
    return results


def _plain_fa():
    """Route the flagship's attention through the plain versions
    (comparison only): torch_mha_train for #5/#6, _packed_xla_ref for #7."""
    plain_packed = lambda qkv, heads, scale=None: _packed_xla_ref(  # noqa: E731
        qkv, heads, (qkv.shape[-1] // 3 // heads) ** -0.5 if scale is None else scale)
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(fa_layers, "fused_torch_mha", torch_mha_train))
    stack.enter_context(mock.patch.object(fa_attention, "packed_flash_attention",
                                          plain_packed))
    return stack


def _reset_fa_counts():
    fused_torch_mha.launches = fused_torch_mha.bwd_launches = 0
    packed_flash_attention.launches = 0


def phase_fa_slice(card: str) -> dict:
    torch.cuda.reset_peak_memory_stats()
    cfg = preset_config("flagship", dtype="bfloat16")
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    _check(next(model.parameters()).device.type == "cuda", "build_model did not "
           "build on the card")
    stats = ((0.5,) * 3, (0.25,) * 3)
    b, steps = FA_B, FA_TRAIN_STEPS
    train_ds = synthetic_dataset(n=b * steps, hw=cfg.img_size,
                                 num_classes=cfg.num_classes, seed=0)
    test_ds = synthetic_dataset(n=b, hw=cfg.img_size, num_classes=cfg.num_classes,
                                seed=1)
    tf = make_eval_transform(*stats, device=DEVICE)
    trainer = Trainer(model, TrainConfig(num_classes=cfg.num_classes, epochs=1,
                                         warmup_epochs=1), steps_per_epoch=steps)
    before = [p.detach().clone() for p in model.parameters()]

    _reset_fa_counts()
    record = trainer.fit(
        lambda: ((tf(x), y) for x, y in epoch_batches(train_ds, b, seed=0)),
        lambda: ((tf(x), y) for x, y in epoch_batches(
            test_ds, b, shuffle=False, drop_last=False)))
    torch.cuda.synchronize()
    launches = {"fused_torch_mha": fused_torch_mha.launches,
                "fused_torch_mha_bwd": fused_torch_mha.bwd_launches,
                "packed_flash_attention (eval)": packed_flash_attention.launches}
    print(f"flagship Trainer.fit, 1 epoch of {steps} steps at batch {b} + eval of "
          f"{len(test_ds)}: {record}")
    print(f"launches over {steps} train steps + 1 eval batch of depth {cfg.depth}: "
          f"{launches}")
    _check(bool(np.isfinite(record["train_loss"])), "non-finite flagship train loss")
    _check(bool(np.isfinite(record["test_loss"])), "non-finite flagship eval loss")
    _check(trainer.state.step == steps, f"{trainer.state.step} steps taken")
    for name in ("fused_torch_mha", "fused_torch_mha_bwd"):
        _check(launches[name] == cfg.depth * steps,
               f"{name} launched {launches[name]} times, expected {cfg.depth * steps}")
    _check(launches["packed_flash_attention (eval)"] == cfg.depth,
           f"packed_flash_attention launched {launches['packed_flash_attention (eval)']}"
           f" times in eval, expected {cfg.depth}")
    still = [n for (n, p), q in zip(model.named_parameters(), before) if torch.equal(p, q)]
    _check(not still, f"flagship parameters unchanged after {steps} steps: {still}")
    del before

    # One step, kernels against plain versions: same params, batch, mixing
    # draws and dropout masks (both generators reseeded).
    x, y = next(epoch_batches(train_ds, b, seed=0))
    batch = (tf(x), torch.from_numpy(y).long().to(DEVICE))
    state = _lr_zero_state(model)
    step = make_train_step(cfg.num_classes)

    def one_step():
        return step(state, batch, torch.Generator().manual_seed(7),
                    torch.Generator(device=DEVICE).manual_seed(7))

    m_k = one_step()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    with _plain_fa():
        m_p = one_step()
    rel = {n: float((grads[n].float() - p.grad.float()).norm() / p.grad.float().norm())
           for n, p in model.named_parameters()}
    worst = max(rel, key=rel.get)
    print(f"flagship train step (mixing, dropout), kernels vs plain versions: loss "
          f"{float(m_k['loss']):.6f} vs {float(m_p['loss']):.6f}; gradient relative "
          f"L2 error max {rel[worst]:.4g} ({worst}), median "
          f"{float(np.median(list(rel.values()))):.4g} over {len(rel)} tensors "
          f"(tolerance {GRAD_REL_TOL})")
    _check(rel[worst] <= GRAD_REL_TOL, "flagship kernel-path gradients disagree "
           "with the plain path")
    del grads

    gen, dgen = torch.Generator().manual_seed(0), torch.Generator(device=DEVICE)

    def step_ms(plain: bool, n_steps: int = 3) -> float:
        with _plain_fa() if plain else contextlib.nullcontext():
            step(state, batch, gen, dgen)  # warm-up
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n_steps):
                step(state, batch, gen, dgen)
            torch.cuda.synchronize()
        return (time.perf_counter() - t) / n_steps * 1e3

    p1, k1, k2, p2 = (step_ms(plain) for plain in (True, False, False, True))
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"flagship train step at batch {b} (mixing, dropout, clip, AdamW): kernels "
          f"{k_ms:.2f} ms = {b / k_ms * 1e3:.1f} img/s, plain versions {p_ms:.2f} ms "
          f"= {b / p_ms * 1e3:.1f} img/s, {card}")
    print(f"flagship peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          "GiB")
    _profile(lambda: step(state, batch, gen, dgen), f"flagship train step at batch {b}")
    del state, batch

    # Serving: a copy of the trained model in bf16 behind the engine.
    engine = ServingEngine(copy.deepcopy(model), None, (cfg.img_size, cfg.img_size, 3),
                           batch_sizes=FA_BATCH_SIZES, dtype=torch.bfloat16,
                           device=DEVICE)
    rng = np.random.default_rng(3)
    requests = [rng.standard_normal((k, cfg.img_size, cfg.img_size, 3),
                                    dtype=np.float32) for k in FA_REQUESTS]
    _reset_fa_counts()
    outs = [engine.predict(r) for r in requests]
    launches["packed_flash_attention"] = packed_flash_attention.launches
    forwards = sum(-(-k // FA_BATCH_SIZES[-1]) for k in FA_REQUESTS)
    for k, out in zip(FA_REQUESTS, outs):
        print(f"flagship request of {k} images -> logits {out.shape}, finite "
              f"{bool(np.isfinite(out).all())}")
        _check(out.shape == (k, cfg.num_classes), f"bad logits shape {out.shape}")
        _check(bool(np.isfinite(out).all()), "non-finite flagship logits")
    print(f"packed_flash_attention launches over {forwards} served forwards of depth "
          f"{cfg.depth}: {launches['packed_flash_attention']}")
    _check(launches["packed_flash_attention"] == cfg.depth * forwards,
           "packed_flash_attention launch count disagrees with the served forwards")
    with _plain_fa():
        plain = [engine.predict(r) for r in requests]
    outs, plain = np.concatenate(outs), np.concatenate(plain)
    err, scale = float(np.abs(outs - plain).max()), float(np.abs(plain).max())
    print(f"flagship logits, kernels vs plain versions: max abs err {err:.4g} (max "
          f"|logit| {scale:.4g}; tolerance {FA_LOGIT_TOL} x max |logit| = "
          f"{FA_LOGIT_TOL * scale:.4g})")
    _check(err <= FA_LOGIT_TOL * scale,
           "served flagship logits disagree with the plain forward")
    xb = torch.from_numpy(requests[-1]).to(DEVICE, torch.bfloat16)
    bs = FA_BATCH_SIZES[-1]
    with torch.inference_mode():
        fwd_ms = _ms(lambda: engine.model(xb), iters=10)
        with _plain_fa():
            plain_fwd_ms = _ms(lambda: engine.model(xb), iters=10)
    print(f"flagship forward at batch {bs}: {fwd_ms:.3f} ms = {bs / fwd_ms * 1e3:.1f} "
          f"img/s (plain versions {plain_fwd_ms:.3f} ms = "
          f"{bs / plain_fwd_ms * 1e3:.1f} img/s), {card}")
    return launches


def main() -> int:
    card = phase_device()
    phase_build()
    kernels = phase_kernels(card)
    kernels.update(phase_backward(card))
    launches = phase_slice(card)
    launches.update({k: v for k, v in phase_train(card).items() if k.endswith("_bwd")})
    kernels.update(phase_fa_kernels(card))
    launches.update(phase_fa_slice(card))
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "sfc_vit_tpu"))
    _check(not leaked, f"the port imported {leaked}")
    entries = [
        dict(name="fused_attention_block", route="cuda",
             source="sfc_vit_tpu_torch/csrc/attention_fwd.cu",
             replaces="sfc_vit_tpu/ops/fused_attention_block.py:104"),
        dict(name="fused_mlp_block", route="cuda",
             source="sfc_vit_tpu_torch/csrc/gemm_bf16.cu",
             replaces="sfc_vit_tpu/ops/fused_mlp.py:104"),
        dict(name="fused_mlp_block_bwd", route="cuda",
             source="sfc_vit_tpu_torch/csrc/gemm_bf16.cu",
             replaces="sfc_vit_tpu/ops/fused_mlp.py:237"),
        dict(name="fused_attention_block_bwd", route="cuda",
             source="sfc_vit_tpu_torch/csrc/attention_bwd.cu",
             replaces="sfc_vit_tpu/ops/fused_attention_block.py:333"),
        dict(name="fused_torch_mha", route="cuda",
             source="sfc_vit_tpu_torch/csrc/attention_fwd.cu",
             replaces="sfc_vit_tpu/ops/fused_torch_attention.py:82"),
        dict(name="fused_torch_mha_bwd", route="cuda",
             source="sfc_vit_tpu_torch/csrc/attention_bwd.cu",
             replaces="sfc_vit_tpu/ops/fused_torch_attention.py:270"),
        dict(name="packed_flash_attention", route="cuda",
             source="sfc_vit_tpu_torch/csrc/attention_fwd.cu",
             replaces="sfc_vit_tpu/ops/flash_attention.py:907"),
    ]
    for e in entries:
        k = kernels[e["name"]]
        e.update(launches=launches[e["name"]], max_abs_err=k["max_abs_err"],
                 ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
                 bound_by=k["bound_by"], library_ms=k["library_ms"])
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
