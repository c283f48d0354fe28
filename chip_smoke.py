#!/usr/bin/env python3
"""Drive the PyTorch port's ViT-B/16 serving path and train step, the
family-A flagship's train step and serving path (also with its fused
tokenizer, and at MLP 1,024 through the post-norm tail, in bf16 and at its
own fp32), the hierarchical family-A model's (bf16 and fp32), the
long-context models' (16,384 tokens with token merge, its hybrid
local/global schedule, and 4,096) and the reference notebook's model's
(fp32 and bf16, 2-D and 1-D tokenizers) train steps and serving, the
ViT-B/16 preset's at its own fp32, per-layer remat, the flagship,
'hier' and ViT-B/16 at head dims other than 64 and 192, and the
long-context models at their own fp32 (head dims 64, 128, 256), once on
one NVIDIA GPU, the long-context kernels at every head dim and dtype
the JAX package sends them (the hybrid at its fp32, Dh 128 and 256 in
bf16), and #4's and #6's attention backward past its resident form's
limits (the notebook's 1-D tokenizer at 1,024 tokens, ViT-B/16 at 384
px).

    python3 chip_smoke.py        # from the repository root; needs one
                                 # NVIDIA H100 (sm_90a) and nvcc

Phases, each of which raises (non-zero exit) on failure:

1. device: a CUDA device is present; prints its name and power limit;
2. build: compiles the hand-written kernels (sfc_vit_tpu_torch/csrc)
   with nvcc and loads them (each source's seconds, the slowest four
   printed); prints ptxas's registers and spills and the
   runtime's registers and shared memory of the wgmma kernels (#1's and
   #7's packed-attention instances and #5's masked ones by sub-heads a
   head, #8-#11,
   #13's windowed instances of #10's and #11's kernels, #14, the GEMM's
   three forms, split-K sum and LayerNorm form (#15) and the attention
   backward's instances (#4, #6: the resident form's seven, the streamed
   form's dq and dk/dv kernels by sub-heads, with the mask and
   without)) and of the LayerNorm backward's
   three and the fp32 kernels of #1-#7 and #14 (``csrc/gemm_f32.cu``'s nine
   3xTF32 ``wgmma`` instances and its column sums; the fp32 attention's
   instances by sub-heads; #14's), and fails if any spills;
3. kernels: each fused block against its plain PyTorch version at the
   ViT-B/16 serving shapes (x [64, 196, 768] bf16, 12 heads of 64,
   F = 3072), with its error, tolerance and time beside the plain one;
   #2's three launches (ln_rows, fc1 + GELU, fc2 + the residual) each
   timed alone beside its bound ("#2's launches" lines; again at batch
   256 in 3b); then #1's attention alone (csrc/packed_attn_sm90.cu's one-pass form)
   at [64, 196, 12 x 64] against ``attention_fwd_ref``, timed beside its
   byte bound and SDPA's forward;
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
   plain forward (the WMMA kernels' recorded times printed beside); then
   each of the chains' GEMMs (the TMA + wgmma ``csrc/gemm_bf16.cu``: #3's
   dW2, dz, dW1, dxn, #4's datt, dW_out, dxn, dW_qkv, the forward's fc1
   with and without z, fc2 + the residual, the QKV and output
   projections) held to and timed against ``torch.matmul`` on the same
   operands, with TFLOP/s and the bound, and one fc1 tile's time split
   into its K loop, staging, finish8 and column sums from the kernel's
   clock64 stamps (``_build.gemm_profile``); and #4's attention backward
   (``csrc/attention_bwd_sm90.cu``) against its plain version, bit for bit
   on a second call, timed beside the streamed form at the same shape
   (``csrc/attention_bwd_stream_sm90.cu``) and SDPA's backward; #1's
   attention alone at [256, 196, 12 x 64] with its lse (the lse against
   fp64), timed beside its bound and SDPA's forward; and
   ``ln_rows_bwd`` (csrc/ln_rows_bwd.cu) alone in its three forms at the
   main paths' shapes ((a) [50,176, 768] of #3 and #4; (b) #16's LN2 and
   (c) its LN1 at [32,768, 768] and [32,768, 256]) against
   ``ln_bwd_fp32``, bit for bit on a second call, timed beside its byte
   bound and ``native_layer_norm_backward`` on the same rows (the
   yardstick of the plain LayerNorm-backward part only);
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
   (``packed_flash_attention``: the flagship's [256, 64, 2304] and serving
   batch 16, 'hier''s [256, 64, 768] and [256, 192, 768]) against their
   plain versions, each error beside its tolerance; each timed beside its
   plain version and its bound; #7 by CUDA-graph replay, beside
   ``F.scaled_dot_product_attention`` on contiguous copies of q, k and v;
   and #6's attention backward alone (``csrc/attention_bwd_sm90.cu`` with
   the mask) at the flagship's [512, 64, 4 x 192] and 'hier''s [512, 64,
   4 x 64] and [512, 192, 4 x 64] against the masked plain twin and a
   second call (bit for bit), in turns with the streamed form,
   beside its byte bound and SDPA's unmasked backward; then #5's attention
   alone (``csrc/packed_attn_sm90.cu``'s masked one-pass forms, with lse)
   at the same three shapes against ``attention_fwd_ref`` with the mask,
   its lse against fp64 and a second call (bit for bit), timed by
   CUDA-graph replay in turns with the plain version, beside its byte
   bound and SDPA's forward without dropout.
7. flagship slice: ``build_model(preset_config("flagship",
   dtype="bfloat16"))`` on the card, ``Trainer.fit`` for one epoch of 4
   steps at batch 512 on synthetic_dataset(n=2048, hw=32, 10 classes),
   then ``evaluate`` on 512 images; every loss finite, every parameter
   moved, #5 and #6 launched depth x steps times and #7 depth x eval
   forwards; one train step (mixing and dropout on) through the kernels
   against the same step through the plain versions, the same draws;
   ``ServingEngine(batch_sizes=(16, 256))`` answers 1, 100 and 256
   images, logits against the plain forward; train img/s both paths,
   forward img/s at batch 256, peak memory, a profile of the train step
   and one of the served forward at batch 256.
8. flash kernels: #8 (streaming) and #10 / #11 at the long-context
   preset's attention shape (batch 2, 16,384 tokens, 6 heads of 64, q, k,
   v as views of one packed projection), #8 (single K step) and #9 at
   CurveViT-S/12's (batch 16, 4,096 tokens) and a ragged case (3,000
   queries, 5,000 keys) through all four, each against its plain version
   with its error beside its tolerance and the lse against fp64 (#8's
   streaming form against the plain version at its 128-key tile,
   ``_build.FLASH_STREAM_BLOCK_K``); each timed beside its plain version,
   its bound, its achieved TFLOP/s (nominal, and executed where the
   kernel does more: #8's single step computes the logits twice, the
   backward kernels' two-term split doubles four products) and
   ``F.scaled_dot_product_attention`` (forward for #8 in both forms, its
   autograd backward for #9-#11); #10 and #11 also timed at the ragged
   case; #9 against #10 + #11 at 8,192 tokens, the length JAX's
   ``_FUSED_BWD_MAX`` hard-codes.
9. long-context slice: (a) ``build_model(preset_config("longctx-16k"))``
   (fp32 parameters, bf16 compute, token merge after layer 1):
   ``Trainer.fit`` for 4 steps at batch 2 on synthetic_dataset(hw=128,
   10 classes) plus an eval batch, then ``ServingEngine(batch_sizes=(1,
   4))`` answers 1 and 4 images; (b) CurveViT-S/12 at 4,096 tokens
   (``preset_config("vit-s-16", img_size=256, patch_size=4,
   num_classes=1000, dtype="bfloat16")``), 4 steps at batch 16, an eval
   batch, and the same serving.  For each: finite losses, every
   parameter moved, #8 launched depth x forwards and #10 + #11 (a) or #9
   (b) depth x steps, one step's gradients through the kernels against
   the plain versions (relative L2 per tensor), train img/s and tokens/s
   on both paths, serving img/s at batch 4, peak memory; a profile of one
   step of each.
10. local kernels: #12 (out and lse) and #13 (dq, dk, dv) at the hybrid
   preset's shapes (batch 2, 16,384 and 12,288 tokens, 6 heads of 64,
   block 128, halo 1, q, k, v as views of one packed projection) and a
   ragged 5,000 against their plain versions, each error beside its
   tolerance; 256 tokens must take the dense route (flash #8, not #12);
   at 16,384 each timed beside its plain version, its bound and
   ``F.scaled_dot_product_attention`` with a boolean band mask (forward
   for #12, its autograd backward for #13); #13 (the windowed instances
   of #10's and #11's kernels) and #12 (the windowed instance of #8's
   single step) also bit for bit on a second call at each length, #13's
   two launches timed apart at 16,384 and the whole at 12,288.
11. hybrid slice: ``build_model(preset_config("longctx-16k-hybrid"))``
   (three curve-local layers, then one global; merge after layer 1) as in
   9 (a): 4 steps at batch 2, an eval batch, 1 and 4 images served; #12
   launched 3 x (steps + eval + served forwards), #13 3 x steps, #8 once
   per forward and #10/#11 once per step for the global layer; one step's
   gradients against the plain versions; a profile of one step.
12. fused tokenizer: #14 at the flagship's three tokenizer levels (batch
   512: x [512, 1024, 3] in groups of 16, [512, 256, 12] in groups of 4,
   [512, 64, 48]; D = 256) against its plain version, timed by CUDA-graph
   replay beside each level's bound and ``index_select`` + ``F.linear``;
   then
   ``build_model(preset_config("flagship", fused=True,
   dtype="bfloat16"))`` trained 4 steps at batch 512, evaluated and
   served (1, 100, 256 images), #14 launched 3 x (steps + eval + served
   forwards), the served logits against the unfused flagship's at the same
   weights (3 % of the largest |logit|), forward img/s of both.
13. post-norm tail: first #15's launches each timed alone at [512, 64,
   768] and [512, 64, 256]: before (LN1 with the fp32 x2f, fc1, fc2 into
   the fp32 s2, LN2) and after (LN1 with row stats, fc1, fc2 + LN2 as one
   launch of thread-block clusters), and #16's eight launches (LN2
   backward, relu, dW2, dz, x2, dW1, dx2, LN1 backward) each with its
   bytes, operations and bound; then #15 (serving form; training
   form with z and s2) and
   #16 at the flagship's layer at MLP 1,024 (x, attn [512, 64, 768], F =
   1,024), hier's levels ([512, 64, 256]) and a ragged 1,000 rows against
   their plain versions (out, z, s2 within 1 %, each gradient within 2 %
   of its largest |value|), timed at the first two beside their bounds;
   then (b) ``VisionTransformer1D`` with ``preset_config("flagship",
   mlp_dim=1024, dtype="bfloat16")``'s fields and dropout 0 trained 4
   steps at batch 512 through #15's training form and #16, evaluated and
   served (1, 100, 256 images) through #15 and #7, and (c)
   ``build_model(preset_config("flagship", model="hier", mlp_dim=1024,
   dtype="bfloat16"))`` (dropout 0.1: #5/#6 and the unfused tail in
   training; #7 and #15 at d = 256 in eval and serving) the same way; for
   each the launch counts (layers x steps or forwards), every parameter
   moved, one step's gradients and the served logits against the plain
   versions, train and forward img/s, a profile of the train step.  Also
   #15 (both forms) and #16 in fp32 at the same shapes, within
   1e-4 of each tensor's largest |value| (#16 bit for bit twice), timed
   beside the fp32 bound (the products at 3xTF32's 165 TFLOP/s); and (b)
   and (c) again at the presets' own fp32 (no dtype named): the flagship
   through #15's fp32 training form and #16 fp32, 'hier' through #5/#6
   fp32, both served by ``ServingEngine(dtype=None)`` through #15 and #7
   in fp32; launch counts layers x steps in the fp32 counters and 0 in the
   bf16 ones, gradients within relative L2 1e-2 and logits within 1e-4 of
   the largest |logit| of the plain path.
14. notebook: the fp32 kernels of #5, #6, #7 and #14 (``csrc/gemm_f32.cu``,
   ``packed_attn_f32.cu``, ``attention_bwd_f32.cu``,
   ``gather_project_f32.cu``: each fp32 product as three TF32 products on
   ``wgmma``; #14's also bit for bit twice and against fp64) against
   their plain versions within 1e-4 of each tensor's largest |value| at the notebook's
   shapes (x [32, 64, 256], 4 heads of 64, mask at keep 0.9; its fused 2-D
   and 1-D tokenizers) and the flagship's fp32 ones ([512, 64, 768], 4 heads
   of 192; its three tokenizer levels), each timed beside its bound (the
   GEMMs' and the attention's products at 3xTF32's 165 TFLOP/s, the rest
   at fp32's 67, 3.35 TB/s; and every operation at 67) and a library call
   (torch.matmul fp32, each GEMM's product also against fp64; SDPA fp32
   without dropout, the attention's output also against fp64;
   ``index_select`` + ``F.linear``); ``colsum`` (#6's bias gradients) at
   the notebook's, the flagship's and 'hier''s shapes, bit for bit twice
   and equal to its plain twin ``kernel_utils.colsum_fixed_order``, by graph replay beside
   ``x.float().sum(0)`` and its byte bound; then
   ``build_model(preset_config("notebook"))`` trained 4 steps in fp32 at
   batch 32 (curves hilbert, raster, random), evaluated and served
   (``'random'`` refused by the engine), the same in bf16 with the fused
   tokenizer at batch 512 through the Hopper #5/#6/#7/#14, and the 1-D
   tokenizer at patch 4 (256 tokens), fused, in fp32 and bf16 (its bf16
   #6 backward on the streamed form, ``_build.attention_bwd.streamed_masked``
   counted): launch counts = layers x steps (``colsum`` twice that), eval
   batches and
   served forwards, every parameter moved, one step's gradients and the
   served logits against the plain versions.
15. ViT-B/16 at its own dtype (float32; the preset names none): (a) #1-#4
   in fp32 (``ln_rows`` / ``ln_rows_bwd``'s fp32 forms, ``csrc/gemm_f32.cu``
   with its epilogues, ``packed_attn_f32.cu`` and ``attention_bwd_f32.cu``
   without a mask) against their plain versions within 1e-4 of each
   tensor's largest |value|: #1 and #2 at batch 64, #3 and #4 at batch 256
   (timed in turns with the plain versions, beside the fp32 bound), ViT-S/16's
   width (d 384, 6 heads) and a ragged shape (n_actual 37 of 50 tokens, 150
   rows), checked; #3 and #4 (their column sums, the attention backward)
   bit for bit on a second call; #1's attention alone at [64, 196, 12 x 64]
   and, with lse, [256, 196, 12 x 64], and #4's attention backward alone
   at [256, 196, 12 x 64], beside SDPA fp32 (each forward's output also
   against fp64); the attention's one-pass form against its two passes at
   64 to 256 keys (ViT-B's served shape) and at the flagship's head dim
   192 (``_attention_f32_split``); each GEMM form of the chains
   at ViT-B/16's shapes against torch fp32, timed beside ``torch.matmul``
   fp32 (TF32 off) with each one's TFLOP/s, and each product (the kernel's
   and torch.matmul fp32's) against fp64; (b)
   ``build_model(preset_config("vit-b-16", curve="hilbert",
   num_classes=1000))`` with no dtype served by
   ``ServingEngine(batch_sizes=(8, 64), dtype=None)`` (1, 37, 64 images;
   #1/#2 fp32 launched 12 x forwards, logits within 1e-4 of the largest
   |logit| of the plain path) and trained by ``Trainer.fit`` for 4 steps
   at batch 256 plus an eval batch (#1-#4 fp32 launched 12 x steps, every
   parameter moved), one step's gradients against the plain blocks
   (relative L2 within 1e-2, max and median printed), forward and train
   step times on both paths, peak memory and a profile of the step.
16. remat: two train steps with ``remat=True`` and two without, from the
   same seeds, of 'hier' at MLP 1,024 at its own fp32 with dropout (batch
   512; its 24 level layers checkpointed, the fusion layers not, as in
   JAX) and of ViT-B/16 in bf16 (batch 256; every attention and MLP block
   checkpointed): every gradient and loss equal bit for bit, the dropout
   generator in the same state, the forward counters of the checkpointed
   layers doubled and the backward ones equal; each run's peak device
   memory and step time printed.
17. head dims (ROADMAP F5): (a) at Dh 32, 48, 96, 128 and 256 (the
   flagship's [512, 64, H x Dh] with H x Dh = 768, 'hier''s d 256 at Dh
   32, its fusion length 192 at Dh 128), in bf16 and fp32: #7 served, #1's
   attention with lse, #5's with the mask and lse, #4's and #6's
   attention backward (bit for bit twice) against their plain versions,
   each timed beside its plain version, SDPA and its bound ("head dims:"
   lines); (b) the flagship in bf16 at batch 512, dropout 0.1, at 6,
   8, 3 and 16 heads and at its own fp32 at 6, 'hier' in bf16 at 2 and 8
   heads, and ViT-B/16 at 6 heads of 128 at batch 256 in bf16 and fp32
   (depth cut to 2, one layer a level for 'hier'): 2 steps of
   ``Trainer.fit``, an eval batch and ``ServingEngine``, launch counts =
   layers x steps or forwards (the streamed form's at the flagship's 3
   heads, 'hier''s 2 and ViT-B/16's 6 of 128), one step's gradients and
   the served logits against the plain path.  The kernel line's attention
   entries gain a ``head_dims`` list of the widths (a) held.
18. long context in fp32 (the JAX CLI's default dtype): (a) #8-#11's fp32
   forms (``csrc/flash_fwd_f32.cu``, ``csrc/flash_bwd_f32.cu``: 3xTF32 on
   ``wgmma``) at CurveViT-S/12's [16, 4,096, 6 x 64] (#8's single step,
   #9), longctx-16k's [2, 16,384, 6 x 64] (#8 streaming, #10, #11), both
   at 3 heads of 128, CurveViT-S/12 at 6 heads of 256, a ragged 8,300 x
   9,000 at Dh 256 and the 1-D tokenizer's [32, 1,089, 4 x 64], q, k, v
   as views of the packed projection: each against its plain version
   within 1e-4 of its largest |value|, the lse against fp64, every output
   bit for bit on a second call, each timed beside its plain version, its
   bound (nominal operations at 3xTF32's 165 TFLOP/s) and SDPA fp32;
   ``flash_attention_with_lse`` on the card in bf16 at Dh 64 and fp32 at
   64, 128 and 256, ``utils.profiling.attention_rows`` of four queries
   against fp64; (b) CurveViT-S/12 at 4,096 tokens as its preset is (no
   dtype; batch 16, 4 steps) and longctx-16k at ``dtype=None`` (batch 2,
   4 steps), both at 3 heads of ``dim_head`` 128 and CurveViT-S/12 at
   ``dim_head`` 256 (depth 2, 2 steps, batch 8 and 2): ``Trainer.fit``,
   an eval batch and ``ServingEngine(dtype=None)``, the fp32 flash
   counters at layers x forwards and layers x steps (the bf16 ones at 0),
   every parameter moved, one step's gradients (relative L2 1e-2) and the
   logits (1e-4 of the largest |logit|) against the plain path; the first
   two's step times and profiles; and the 1-D tokenizer over 33 x 33
   pixels at patch 1 (family A, 1,089 tokens) evaluated and served the
   same way;
19. long context at every head dim and dtype the JAX package sends to
   its kernels: (a) #8-#11 in bf16 at Dh 128 and 256 (the wide instances
   of ``csrc/flash_fwd_sm90.cu``, ``flash_bwd_dq_sm90.cu`` and
   ``flash_bwd_dkv_sm90.cu``, ``csrc/flash_wide.cuh``) at phase 18's
   shapes past Dh 64 (#9 there is the dq and dk/dv kernels), and #12/#13
   at block 128, halo 1 in fp32 at [2, 16,384, 6 x 64], [2, 16,384, 3 x
   128] and a ragged [1, 5,000, 2 x 256] (the windowed instances of
   ``csrc/flash_fwd_f32.cu`` and ``flash_bwd_f32.cu``) and in bf16 at [2,
   16,384, 3 x 128], [2, 16,384, 2 x 256] and a ragged [1, 5,000, 2 x 128]:
   each against its plain version within 1 % (bf16) or 1e-4 (fp32) of its
   largest |value|, the lse against fp64, bit for bit on a second call,
   each timed beside its plain version, its bound and SDPA (with a band
   mask for #12/#13); (b) ``longctx-16k-hybrid`` at ``dtype=None`` (#12/#13
   fp32 in its three local layers), longctx-16k at 3 heads of 128 in bf16,
   the same with the hybrid schedule in bf16 and at ``dtype=None``, and
   CurveViT-S/12 at 4,096 tokens in bf16 at 3 heads of 128 and 6 of 256
   (depth 2): ``Trainer.fit``, an eval batch and a ``ServingEngine`` in the
   model's dtype, every flash and curve-local counter at layers x forwards
   or layers x steps in the model's dtype and 0 elsewhere, one step's
   gradients (relative L2 0.1 bf16, 1e-2 fp32) and the logits against the
   plain path; the first two's step times and profiles.
20. #4's and #6's attention backward past the resident form's limits:
   (a) the streamed form (``csrc/attention_bwd_stream_sm90.cu``) through
   ``_build.attention_bwd`` at 'hier''s fusion layers at 2 heads and the
   flagship at 3 (with the mask and without), the notebook's 1-D tokenizer
   at patch 4 and at patch 1 over 32 x 32 px (the mask), ViT-B/16 at 384
   px and at 6 heads of 128: against ``attention_bwd_ref`` within 2 % of
   the largest |value|, bit for bit twice, timed in turns with the plain
   version beside SDPA's backward and the bound ("streamed backward:"
   lines); (b) the notebook's 1-D tokenizer at patch 1 over 32 x 32 px
   (1,024 tokens, batch 32) and ViT-B/16 at 384 px (576 tokens, batch 64),
   bf16, full depth, 4 steps of ``Trainer.fit``, an eval batch and
   ``ServingEngine``: every attention backward on the streamed form
   (``_build.attention_bwd.streamed`` / ``.streamed_masked`` = layers x
   steps), one step's gradients and the logits against the plain path.
   Then no module of jax, flax or the JAX package may have loaded.  Each
   phase prints its seconds.

The line before the last is one JSON object describing the kernels; the
last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
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
import sfc_vit_tpu_torch.ops.flash_attention as flash
import sfc_vit_tpu_torch.ops.gather_project as gp
import sfc_vit_tpu_torch.ops.local_attention as local
from sfc_vit_tpu_torch.data import epoch_batches, make_eval_transform, synthetic_dataset
from sfc_vit_tpu_torch.ops import _build
from sfc_vit_tpu_torch.ops.fused_attention_block import (
    attention_block_bwd,
    attention_block_bwd_ref,
    attention_block_ref,
    attention_block_train_fwd,
    attention_bwd_ref,
    attention_fwd_ref,
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
    fused_postnorm_tail,
    mlp_block_bwd,
    mlp_block_bwd_ref,
    mlp_block_ref,
    mlp_block_train_fwd,
    postnorm_tail_bwd,
    postnorm_tail_bwd_ref,
    postnorm_tail_kernel_ref,
    postnorm_tail_train_fwd,
    tail_fc2_route,
)
from sfc_vit_tpu_torch.ops.kernel_utils import colsum_fixed_order, ln_bwd_fp32
from sfc_vit_tpu_torch.models import VisionTransformer1D
from sfc_vit_tpu_torch.registry import build_model, build_tokenizer, preset_config
from sfc_vit_tpu_torch.serving import ServingEngine
from sfc_vit_tpu_torch.tokenizers import patchify
from sfc_vit_tpu_torch.training import (
    TrainConfig,
    Trainer,
    TrainState,
    make_optimizer,
    make_train_step,
)
from sfc_vit_tpu_torch.utils.profiling import attention_rows

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
#: Flash kernels, bf16, against their plain versions at the kernels' own
#: rounding points (#8 at its 128-key steps): one rounding of an fp32 sum
#: taken in another order (and #10/#11's two-term bf16 split of p and ds,
#: ~2^-16 relative) flips an element by one bf16 ulp at most; every error
#: is held within this fraction of its tensor's largest |value|.
FLASH_TOL = 1e-2
#: #9 against JAX's fused arithmetic: it takes the forward's lse where the
#: TPU kernel divides by its own row sum, and delta = rowsum(g * O) over
#: the bf16 output where the TPU kernel takes rowsum(dp * p) in fp32 (a
#: 2^-9 relative error in each O element): a few bf16 ulps.
FLASH_FUSED_TOL = 2e-2
#: The long-context preset's attention (batch 2, 16,384 tokens, 6 heads of
#: 64) and CurveViT-S/12's at 4,096 tokens (batch 16).
LC_B, LC_N, LC_HEADS = 2, 16384, 6
VS_B, VS_N = 16, 4096
LC_STEPS, VS_STEPS = 4, 4
#: #8's streaming key tile: the plain version is compared at the same width.
STREAM_BK = _build.FLASH_STREAM_BLOCK_K
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


def _graph_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call of ``fn``, CUDA events around one
    replay of a CUDA graph of ``iters`` calls: for calls shorter than the
    Python launch path, which a loop of host launches would time instead."""
    fn()  # warm-up outside the capture: the kernel library, cuBLAS handles
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
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
    print("  slowest sources: " + ", ".join(f"{name} {sec:.1f} s"
                                            for name, sec in list(info["sources"].items())[:4]))
    for line in info["log"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())
    # The wgmma kernels #7-#11 and #14 (ptxas's lines above) as the
    # runtime sees them, with their dynamic shared memory.
    for name, attrs in _build.flash_kernel_attrs().items():
        print(f"  {name}: {attrs['registers']} registers, {attrs['local_bytes']} bytes "
              f"local, {attrs['smem_bytes']} bytes shared a block")
        _check(attrs["local_bytes"] == 0, f"{name} uses local memory (spills)")


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
        _mlp_split(card, B)

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
        _check(_build.attention_fwd_route(64, N, False) == "one pass",
               "#1's attention does not take the packed kernel's one-pass form")
        _attention_fwd_case(card, B, with_lse=False)
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
          f"{both:.4f} ms, plain {both_plain:.4f} ms, {card}; WMMA kernels "
          f"{WMMA_BWD_MS['fused_mlp_block_bwd']} ms")
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
          f"backward: kernels {both:.4f} ms, plain {both_plain:.4f} ms, {card}; "
          f"WMMA kernels {WMMA_BWD_MS['fused_attention_block_bwd']} ms")
    results["fused_attention_block_bwd"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=None,
        **_bound(4 * r * D * D + 12 * r * D * D + 10 * b * HEADS * N * N * 64,
                 2 * (3 * r * D + r * 3 * D + r * D + 8 * D * D) + 4 * b * HEADS * N
                 + 16 * D))
    _gemm_phase(card, b)
    _mlp_split(card, b)  # #2's launches (and ln_rows) at the training batch too
    _attention_bwd_phase(card, b)
    _attention_fwd_case(card, b, with_lse=True)
    for form, rows, d in LN_BWD_CASES:
        _ln_bwd_case(card, form, rows, d)
    return results


#: #3's and #4's times on the WMMA GEMM and csrc/attention_bwd.cu that
#: gemm_bf16.cu's TMA + wgmma design and attention_bwd_sm90.cu replaced,
#: recorded by this script on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md
#: section 6): printed beside this run's for reference only.
WMMA_BWD_MS = {"fused_mlp_block_bwd": 9.028, "fused_attention_block_bwd": 7.313}


def _gemm_phase(card: str, b: int) -> None:
    """Each GEMM of #3's and #4's chains and of the forwards #1 and #2
    (fc1 with and without the saved z, fc2 + the residual, the QKV and
    output projections) at ViT-B batch ``b`` through ``_build.gemm`` with
    the chain's epilogue, against ``torch.matmul`` on the same operands in
    turns: ms, TFLOP/s and the bound; each product without its epilogue
    held to ``torch.matmul``'s within one bf16 rounding (1 % of its
    largest |value|).  Then one fc1 tile's time split into its parts
    (``_gemm_epilogue_split``)."""
    gen = torch.Generator().manual_seed(5)
    r = b * N
    act = dict(h=_randn(gen, r, F), g=_randn(gen, r, D), xn=_randn(gen, r, D),
               dz=_randn(gen, r, F, scale=0.1), z=_randn(gen, r, F),
               att=_randn(gen, r, D), dqkv=_randn(gen, r, 3 * D, scale=0.1))
    w = dict(w1=_randn(gen, D, F, scale=D ** -0.5), w2=_randn(gen, F, D, scale=F ** -0.5),
             w_out=_randn(gen, D, D, scale=D ** -0.5),
             w_qkv=_randn(gen, D, 3 * D, scale=D ** -0.5),
             b1=_randn(gen, F, scale=0.1, dtype=torch.float32),
             b2=_randn(gen, D, scale=0.1, dtype=torch.float32))
    # (chain, label, a, b, trans_a, trans_b, epilogue, bytes of the epilogue's
    # extra tensors, output bytes per element)
    cases = [
        ("#2/#3 fwd", "NN fc1 z = xn W1 + b1, gelu, save z", act["xn"], w["w1"], False,
         False, dict(bias=w["b1"], act="gelu", save_z=True), 2 * r * F, 2),
        ("#3", "TN dW2 = h^T g", act["h"], act["g"], True, False, {}, 0, 2),
        ("#3", "NT dz = g W2^T * gelu'(z), db1", act["g"], w["w2"], False, True,
         dict(act="gelu", z_in=act["z"], colsum=True), 2 * r * F, 2),
        ("#3", "TN dW1 = xn^T dz", act["xn"], act["dz"], True, False, {}, 0, 2),
        ("#3", "NT dxn = dz W1^T (fp32)", act["dz"], w["w1"], False, True,
         dict(out_dtype=torch.float32), 0, 4),
        ("#4", "NT datt = gp W_out^T", act["g"], w["w_out"], False, True, {}, 0, 2),
        ("#4", "TN dW_out = att^T gp", act["att"], act["g"], True, False, {}, 0, 2),
        ("#4", "NT dxn = dqkv W_qkv^T (fp32)", act["dqkv"], w["w_qkv"], False, True,
         dict(out_dtype=torch.float32), 0, 4),
        ("#4", "TN dW_qkv = xn^T dqkv", act["xn"], act["dqkv"], True, False, {}, 0, 2),
        ("#2 served", "NN fc1 h = gelu(xn W1 + b1)", act["xn"], w["w1"], False, False,
         dict(bias=w["b1"], act="gelu"), 0, 2),
        ("#2", "NN fc2 out = h W2 + b2 + x", act["h"], w["w2"], False, False,
         dict(bias=w["b2"], residual=act["g"]), 2 * r * D, 2),
        ("#1", "NN qkv = xn W_qkv", act["xn"], w["w_qkv"], False, False, {}, 0, 2),
        ("#1", "NN out = att W_out + x", act["att"], w["w_out"], False, False,
         dict(residual=act["g"]), 2 * r * D, 2),
    ]
    print(f"GEMMs of #1-#4's chains at ViT-B batch {b} (R = {r}), kernel "
          f"(csrc/gemm_bf16.cu) and torch.matmul in turns, {card}:")
    for chain, label, a, bm, ta, tb, ep, extra, out_bytes in cases:
        m, k = (a.shape[1], a.shape[0]) if ta else a.shape
        n = bm.shape[0] if tb else bm.shape[1]
        opa = a.t() if ta else a
        opb = bm.t() if tb else bm
        got = _build.gemm(a, bm, trans_a=ta, trans_b=tb)
        _frac_err(f"{label} vs torch.matmul", got, torch.matmul(opa, opb), 1e-2)
        del got
        ms, mm_ms = _ab_ms(lambda: _build.gemm(a, bm, trans_a=ta, trans_b=tb, **ep),
                           lambda: torch.matmul(opa, opb))
        flops = 2 * m * n * k
        bound = _bound(flops, 2 * (m * k + k * n) + out_bytes * m * n + extra)
        print(f"  {chain} {label} [{m}, {n}, K {k}]: "
              f"kernel {ms:.4f} ms = {_tflops(flops, ms)}, torch.matmul {mm_ms:.4f} ms = "
              f"{_tflops(flops, mm_ms)} ({ms / mm_ms:.2f}x), bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']})")
    if hasattr(_build, "gemm_profile"):  # an earlier tree has no tile stamps
        _gemm_epilogue_split(card, act["xn"], w["w1"], w["b1"])


def _gemm_epilogue_split(card: str, xn, w1, b1) -> None:
    """One fc1 tile's time (NN, + b1, GELU, z saved: [R, 3072, K 768]) split
    into its K loop and its epilogue's parts, from the clock64 stamps of
    ``_build.gemm_profile`` (each block's first consumer thread; cycles
    turned into time by the globaltimer over each block's run): means over
    every tile of every block, beside the kernel's CUDA-event time."""
    r, n = xn.shape[0], w1.shape[1]
    c, z, st = _build.gemm_profile(xn, w1, b1)
    want_c, want_z = _build.gemm(xn, w1, bias=b1, act="gelu", save_z=True)
    _check(torch.equal(c, want_c) and torch.equal(z, want_z), "gemm_profile differs from gemm")
    ms = _ms(lambda: _build.gemm_profile(xn, w1, b1), iters=5)
    st = st.cpu().double()
    used = st[:, :, 4] > 0  # stamped tiles
    ns_per_cycle = []
    for blk in range(st.shape[0]):
        rows = st[blk][used[blk]]
        cyc, ns = rows[-1, 0] - rows[0, 0], rows[-1, 5] - rows[0, 5]
        if cyc > 0 and ns > 0:
            ns_per_cycle.append(float(ns / cyc))
    scale = sum(ns_per_cycle) / len(ns_per_cycle) / 1e3  # us a cycle
    tile = st[used]
    parts = ", ".join(f"{label} {float((tile[:, b] - tile[:, a]).mean()) * scale:.3f}"
                      for label, a, b in (("K loop", 0, 1), ("staging", 1, 2),
                                          ("finish8 + stores", 2, 3), ("column sums", 3, 4)))
    print(f"fc1's tile split ([{r}, {n}, K {xn.shape[1]}], + b1, gelu, save z; 128 x 128 tiles; "
          f"clock64 stamps of warpgroup 0), {card}: kernel {ms:.4f} ms; us a tile: {parts}; "
          f"whole {float((tile[:, 4] - tile[:, 0]).mean()) * scale:.3f} ({int(used.sum())} "
          f"tiles, {1e-3 / scale:.3f} GHz by the globaltimer)")


def _mlp_split(card: str, b: int) -> None:
    """#2's three launches one by one (each alone on the inputs
    ``fused_mlp_block`` gives it, by CUDA-graph replay: at batch 64 the LN
    is shorter than the Python launch path) at x [b, N, D], F: LN
    (ln_rows), fc1 + b1 + GELU (gemm NN) and fc2 + b2 + the residual (gemm
    NN), each with its bytes, operations and bound, and their sum
    (launchers an earlier tree also has, so a parent's run prints the
    before)."""
    gen = torch.Generator().manual_seed(15)
    r = b * N
    x = _randn(gen, r, D)
    ln_s = _randn(gen, D, scale=0.1, shift=1.0, dtype=torch.float32)
    ln_b = _randn(gen, D, scale=0.1, dtype=torch.float32)
    w1, w2 = _randn(gen, D, F, scale=D ** -0.5), _randn(gen, F, D, scale=F ** -0.5)
    b1 = _randn(gen, F, scale=0.1, dtype=torch.float32)
    b2 = _randn(gen, D, scale=0.1, dtype=torch.float32)
    xn = _build.ln_rows(x, ln_s, ln_b, 1e-5)
    h = _build.gemm(xn, w1, bias=b1, act="gelu")
    mm = 2 * r * D * F
    launches = [
        ("LN (ln_rows)", lambda: _build.ln_rows(x, ln_s, ln_b, 1e-5), 8 * r * D,
         4 * r * D + 8 * D),
        ("fc1 + b1, gelu (gemm NN)", lambda: _build.gemm(xn, w1, bias=b1, act="gelu"), mm,
         2 * (r * D + D * F + r * F) + 4 * F),
        ("fc2 + b2 + x (gemm NN)", lambda: _build.gemm(h, w2, bias=b2, residual=x), mm,
         2 * (r * F + F * D + 2 * r * D) + 4 * D),
    ]
    print(f"#2's launches at x [{b}, {N}, {D}], F={F}, device ms each (CUDA-graph replay), "
          f"{card}:")
    total = total_bound = 0.0
    for label, fn, flops, nbytes in launches:
        ms = _graph_ms(fn)
        bound = _bound(flops, nbytes)
        total += ms
        total_bound += bound["bound_ms"]
        print(f"  {label}: {ms:.4f} ms, {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
              f"{bound['bound_ms'] / ms:.0%} of it")
    print(f"  sum of the launches: {total:.4f} ms (their bounds' sum {total_bound:.4f} ms)")


def _stream_bwd(qkv, att, datt, lse, heads: int, n_valid: int, scale: float, mask=None,
                keep: float = 1.0):
    """The streamed form of the attention backward
    (csrc/attention_bwd_stream_sm90.cu) called directly, at a shape whose
    route is the resident form: the same formula, a yardstick of what
    streaming costs there."""
    b, n, w = qkv.shape
    dh = w // (3 * heads)
    delta = torch.empty((b, heads, n), dtype=torch.float32, device=DEVICE)
    out = torch.empty_like(qkv)
    _build._check(_build.library().sfc_attention_bwd_stream_bf16(
        qkv.data_ptr(), att.data_ptr(), datt.data_ptr(), lse.data_ptr(),
        _build._ptr(_build._mask_u8(mask)), delta.data_ptr(), out.data_ptr(), b, n, heads, dh,
        n_valid, scale, keep, _build._stream()), "attention_bwd (streamed form)")
    return out


def _attention_bwd_phase(card: str, b: int) -> None:
    """#4's attention backward at ViT-B batch ``b`` (csrc/attention_bwd_sm90.cu,
    the resident form) against its plain version, timed beside the
    streamed form at the same shape (csrc/attention_bwd_stream_sm90.cu,
    the same formula) and SDPA's autograd backward on contiguous [B, H, N,
    Dh] q, k, v."""
    gen = torch.Generator().manual_seed(6)
    s = 64 ** -0.5
    qkv = _randn(gen, b, N, 3 * D)
    att, lse = attention_fwd_ref(qkv, HEADS, N, s)
    datt = _randn(gen, b, N, D)
    _check(_build.attention_bwd_route(64, N, False) == "sm90", "#4's route is not the sm90 kernel")
    got = _build.attention_bwd(qkv, att, datt, lse, HEADS, N, s)
    print(f"attention backward of #4, [{b}, {N}, {HEADS}, 64], vs attention_bwd_ref:")
    _frac_err("dqkv", got, attention_bwd_ref(qkv, att, datt, lse, HEADS, N, s), 1e-2)
    _check(torch.equal(got, _build.attention_bwd(qkv, att, datt, lse, HEADS, N, s)),
           "the attention backward does not repeat bit for bit")

    def streamed():
        return _stream_bwd(qkv, att, datt, lse, HEADS, N, s)
    _frac_err("dqkv of the streamed form", streamed(), got, 1e-2)
    ms, stream_ms = _ab_ms(lambda: _build.attention_bwd(qkv, att, datt, lse, HEADS, N, s),
                           streamed)
    q, k, v = qkv.view(b, N, 3, HEADS, 64).unbind(2)
    _, sdpa_bwd = _sdpa_ms(q, k, v, datt.view(b, N, HEADS, 64))
    flops = 5 * 2 * b * HEADS * N * N * 64
    bound = _bound(flops, 2 * b * N * D * (3 + 2 + 3) + 4 * b * HEADS * N)
    print(f"attention backward [{b}, {N}, {HEADS}, 64]: kernel {ms:.4f} ms = "
          f"{_tflops(flops, ms)} nominal, the streamed form (csrc/attention_bwd_stream_sm90.cu) "
          f"{stream_ms:.4f} ms, SDPA backward {sdpa_bwd:.4f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), {card}")


#: #6's attention backward on the main paths (b, n, heads, dh): the
#: flagship's and 'hier''s level and fusion layers, keep 0.9.
MASKED_BWD_SHAPES = ((FA_B, FA_N, FA_HEADS, FA_D // FA_HEADS), (512, 64, 4, 64),
                     (512, 192, 4, 64))


def _masked_attention_bwd_phase(card: str) -> None:
    """#6's attention backward (csrc/attention_bwd_sm90.cu with the mask)
    at MASKED_BWD_SHAPES against the masked plain twin (BWD_TOL of its
    largest |value|) and a second call (bit for bit), timed in turns with
    the streamed form at the same shape (csrc/attention_bwd_stream_sm90.cu,
    the same formula) beside its byte bound; SDPA's backward without
    dropout on contiguous [B, H, N, Dh] q, k, v is printed as a yardstick
    for the unmasked work only."""
    gen = torch.Generator().manual_seed(7)
    for b, n, h, dh in MASKED_BWD_SHAPES:
        _check(_build.attention_bwd_route(dh, n, True) == "sm90",
               f"#6's route at [{b}, {n}, {h} x {dh}] is not the sm90 kernel")
        s = dh ** -0.5
        qkv = _randn(gen, b, n, 3 * h * dh)
        att, lse = attention_fwd_ref(qkv, h, n, s)
        datt = _randn(gen, b, n, h * dh)
        mask = torch.rand(b, h, n, n, generator=gen).lt(FA_KEEP).to(DEVICE)

        def run():
            return _build.attention_bwd(qkv, att, datt, lse, h, n, s, mask=mask, keep=FA_KEEP)
        got = run()
        print(f"attention backward of #6 with the mask, [{b}, {n}, {h} x {dh}], keep "
              f"{FA_KEEP}, vs attention_bwd_ref:")
        _frac_err("dqkv", got, attention_bwd_ref(qkv, att, datt, lse, h, n, s, mask=mask,
                                                 keep=FA_KEEP), BWD_TOL)
        _check(torch.equal(got, run()), "#6's attention backward does not repeat bit for bit")

        def streamed():
            return _stream_bwd(qkv, att, datt, lse, h, n, s, mask=mask, keep=FA_KEEP)
        _frac_err("dqkv of the streamed form", streamed(), got, BWD_TOL)
        ms, stream_ms = _ab_ms(run, streamed)
        _, plain_ms = _ab_ms(run, lambda: attention_bwd_ref(qkv, att, datt, lse, h, n, s,
                                                            mask=mask, keep=FA_KEEP))
        q, k, v = qkv.view(b, n, 3, h, dh).unbind(2)
        _, sdpa_bwd = _sdpa_ms(q, k, v, datt.view(b, n, h, dh))
        flops = 5 * 2 * b * h * n * n * dh
        nbytes = 2 * b * n * h * dh * (3 + 2 + 3) + b * h * n * n + 4 * b * h * n
        bound = _bound(flops, nbytes)
        print(f"attention backward of #6 [{b}, {n}, {h} x {dh}] with the mask: kernel "
              f"{ms:.4f} ms, the streamed form {stream_ms:.4f} ms ({stream_ms / ms:.2f}x), "
              f"plain version (attention_bwd_ref) {plain_ms:.4f} ms, "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.1f} GFLOP), {bound['bound_ms'] / ms:.1%} of it; SDPA backward "
              f"without dropout (a yardstick for the unmasked work only) {sdpa_bwd:.4f} ms; "
              f"{card}")
        del qkv, att, lse, datt, mask, got


def _masked_attention_fwd_case(card: str, b: int, n: int, h: int, dh: int,
                               check: bool = True) -> dict:
    """#5's attention alone (``_build.attention_fwd`` with the dropout mask
    and keep FA_KEEP, its lse: csrc/packed_attn_sm90.cu's masked forms) at
    [b, n, h x dh]: with ``check``, against ``attention_fwd_ref`` with the
    same mask (BLOCK_TOL), its lse against fp64 (LSE_TOL) and a second call
    (bit for bit); then timed by graph replay (:func:`_graph_ms`), with
    ``check`` in turns with the plain version, beside its byte bound and
    SDPA's forward without dropout on contiguous [b, h, n, dh] q, k, v (a
    yardstick for the unmasked work only: SDPA's dropout cannot take a
    given mask).  ``check=False`` times the kernel alone, through launchers
    an earlier tree also has."""
    gen = torch.Generator().manual_seed(13)
    s = dh ** -0.5
    qkv = _randn(gen, b, n, 3 * h * dh)
    mask = torch.rand(b, h, n, n, generator=gen).lt(FA_KEEP).to(DEVICE)
    shape = f"[{b}, {n}, {h} x {dh}]"

    def kern():
        return _build.attention_fwd(qkv, h, n, s, with_lse=True, mask=mask, keep=FA_KEEP)
    res = dict(max_abs_err=None, plain_ms=None)
    if check:
        _check(_build.attention_fwd_route(dh, n, True) == "one pass",
               f"#5's attention at {shape} does not take the one-pass masked form")

        def plain():
            return attention_fwd_ref(qkv, h, n, s, mask=mask, keep=FA_KEEP)
        (att, lse), (want, _) = kern(), plain()
        err, ok = _agree(att, want, **BLOCK_TOL)
        lse_err, lse_ok = _agree(lse, _lse_of(qkv, h, n), **LSE_TOL)
        print(f"#5's attention {shape}, mask, keep {FA_KEEP}, vs attention_fwd_ref with the "
              f"mask: max abs err {err:.4g} (tolerance rtol {BLOCK_TOL['rtol']}, atol "
              f"{BLOCK_TOL['atol']}); lse vs fp64 {lse_err:.4g} (tolerance {LSE_TOL['rtol']})")
        _check(ok and lse_ok, f"#5's attention disagrees with attention_fwd_ref at {shape}")
        again = kern()
        _check(torch.equal(att, again[0]) and torch.equal(lse, again[1]),
               f"#5's attention does not repeat bit for bit at {shape}")
        del att, lse, want, again
        p1, k1, k2, p2 = (_graph_ms(f) for f in (plain, kern, kern, plain))
        res.update(max_abs_err=err, plain_ms=(p1 + p2) / 2)
        ms = (k1 + k2) / 2
    else:
        ms = _graph_ms(kern)
    q, k, v = (t.contiguous() for t in qkv.view(b, n, 3, h, dh).permute(2, 0, 3, 1, 4))
    lib_ms = _graph_ms(lambda: TF.scaled_dot_product_attention(q, k, v))
    nbytes = 2 * b * n * 3 * h * dh + 2 * b * n * h * dh + b * h * n * n + 4 * b * h * n
    bound = _bound(4 * b * h * n * n * dh, nbytes)
    plain_txt = "" if res["plain_ms"] is None else f", plain {res['plain_ms']:.4f} ms"
    print(f"#5's attention {shape}, mask, with lse, by graph replay: kernel {ms:.4f} ms"
          f"{plain_txt}, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}; {nbytes / 1e6:.1f} MB), {bound['bound_ms'] / ms:.1%} of it; "
          f"SDPA forward without dropout (a yardstick for the unmasked work only) "
          f"{lib_ms:.4f} ms; {card}")
    res.update(ms=ms, library_ms=lib_ms, **bound)
    return res


def _attention_fwd_case(card: str, b: int, with_lse: bool) -> dict:
    """#1's attention alone at ViT-B's [b, N, HEADS x 64]: the unmasked
    ``_build.attention_fwd`` (csrc/packed_attn_sm90.cu, one pass over the
    196 keys) against ``attention_fwd_ref`` (BLOCK_TOL) and, with lse, its
    lse against the fp64 log-sum-exp (LSE_TOL); then timed in turns with
    the plain version, beside its byte bound and SDPA's forward on
    contiguous [b, HEADS, N, 64] q, k, v (the library yardstick)."""
    gen = torch.Generator().manual_seed(11)
    s = 64 ** -0.5
    qkv = _randn(gen, b, N, 3 * D)
    shape = f"[{b}, {N}, {HEADS} x 64]{' with lse' if with_lse else ''}"

    def kern():
        return _build.attention_fwd(qkv, HEADS, N, s, with_lse=with_lse)

    def plain():
        return attention_fwd_ref(qkv, HEADS, N, s)
    got, (want, _) = kern(), plain()
    att = got[0] if with_lse else got
    err, ok = _agree(att, want, **BLOCK_TOL)
    print(f"#1's attention {shape} vs attention_fwd_ref: max abs err {err:.4g} (tolerance "
          f"rtol {BLOCK_TOL['rtol']}, atol {BLOCK_TOL['atol']})")
    _check(ok, f"#1's attention disagrees with attention_fwd_ref at {shape}")
    if with_lse:
        lse_err, lse_ok = _agree(got[1], _lse_of(qkv, HEADS, N), **LSE_TOL)
        print(f"  lse vs fp64: max abs err {lse_err:.4g} (tolerance rtol {LSE_TOL['rtol']}, "
              f"atol {LSE_TOL['atol']})")
        _check(lse_ok, f"#1's attention: lse disagrees at {shape}")
    del got, want, att
    ms, plain_ms = _ab_ms(kern, plain)
    q, k, v = (t.contiguous() for t in qkv.view(b, N, 3, HEADS, 64).permute(2, 0, 3, 1, 4))
    lib_ms = _ms(lambda: TF.scaled_dot_product_attention(q, k, v))
    nbytes = 2 * b * N * 3 * D + 2 * b * N * D + (4 * b * HEADS * N if with_lse else 0)
    bound = _bound(4 * b * HEADS * N * N * 64, nbytes)
    print(f"#1's attention {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA forward "
          f"{lib_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
          f"{nbytes / 1e6:.1f} MB), {bound['bound_ms'] / ms:.1%} of it, {card}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, max_abs_err=err, **bound)


#: csrc/ln_rows_bwd.cu's three forms at their main-path shapes (form, rows,
#: D): (a) #3's and #4's at ViT-B batch 256; (b) #16's LN2 and (c) its LN1
#: on the flagship at MLP 1,024 (batch 512 x 64 tokens) and 'hier''s D 256.
LN_BWD_CASES = (("a", TRAIN_B * N, D), ("b", FA_B * FA_N, FA_D), ("c", FA_B * FA_N, FA_D),
                ("b", FA_B * FA_N, 256), ("c", FA_B * FA_N, 256))
_LN_BWD_LABELS = {"a": "(a) x bf16, dxn fp32, + g, colsum(g) (#3, #4)",
                  "b": "(b) x bf16, dxn bf16, fp32 dx and colsum(dx) (#16's LN2)",
                  "c": "(c) x + x_b, dxn fp32 (#16's LN1)"}


def _ln_bwd_case(card: str, form: str, rows: int, d: int, repeat: bool = True) -> dict:
    """One form of ``_build.ln_rows_bwd`` alone (csrc/ln_rows_bwd.cu) at
    [rows, d] against ``ln_bwd_fp32`` (dx within one bf16 rounding, the
    column sums within 1e-3 of their largest |value|) and, with ``repeat``,
    bit for bit on a second call; timed in turns with
    ``torch.ops.aten.native_layer_norm_backward`` on the same rows in bf16,
    beside its byte bound.  That call is the yardstick of the plain
    LayerNorm-backward part only: it neither adds g, nor writes the fp32
    dx, nor sums g or dx, and moves 6 bytes an element to this one's 10."""
    gen = torch.Generator().manual_seed(12)
    x = _randn(gen, rows, d, scale=3.0, shift=0.5)
    s = _randn(gen, d, dtype=torch.float32)
    g = None
    if form == "a":
        dxn, g = _randn(gen, rows, d, dtype=torch.float32), _randn(gen, rows, d)
        kw = dict(g_sum=True)
    elif form == "b":
        dxn, kw = _randn(gen, rows, d), dict(add_g=False, dx_f32=True, dx_sum=True)
    else:
        dxn = _randn(gen, rows, d, dtype=torch.float32)
        kw = dict(add_g=False, x_b=_randn(gen, rows, d))

    def run():
        return _build.ln_rows_bwd(x, dxn, s, g, 1e-5, **kw)
    label = f"ln_rows_bwd form {_LN_BWD_LABELS[form]} [{rows}, {d}]"
    print(f"{label} vs ln_bwd_fp32:")
    got = run()
    xf = x.float() + (kw["x_b"].float() if "x_b" in kw else 0.0)
    want_dx, want_ds, want_db = ln_bwd_fp32(xf, dxn.float(), s)
    if g is not None:
        want_dx = want_dx + g.float()
    err = _frac_err("dx", got[0], want_dx.to(torch.bfloat16), 1e-2)
    _frac_err("dscale", got[1], want_ds, 1e-3)
    _frac_err("dbias", got[2], want_db, 1e-3)
    if form == "a":
        _frac_err("colsum(g)", got[3], g.float().sum(0), 1e-3)
    if form == "b":
        _frac_err("colsum(dx)", got[4], want_dx.sum(0), 1e-3)
    if repeat:
        _check(all(torch.equal(u, v) for u, v in zip(got, run())),
               f"{label} does not repeat bit for bit")
    del got, want_dx, xf
    xn = x if form != "c" else (x.float() + kw["x_b"].float()).to(x.dtype)
    _, mean, rstd = torch.ops.aten.native_layer_norm(xn, [d], s.to(x.dtype), None, 1e-5)
    gy, w = dxn.to(x.dtype), s.to(x.dtype)

    def native():
        return torch.ops.aten.native_layer_norm_backward(gy, xn, [d], mean, rstd, w, None,
                                                         [True, True, False])
    ms, native_ms = _ab_ms(run, native)
    x_b = kw["x_b"].float() if "x_b" in kw else 0.0
    _, plain_ms = _ab_ms(run, lambda: ln_bwd_fp32(x.float() + x_b, dxn.float(), s))
    nbytes = rows * d * 10 + 4 * d * (1 + 2 + (form != "c"))
    bound = _bound(15 * rows * d, nbytes)
    print(f"{label}: kernel {ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
          f"{nbytes / 1e6:.1f} MB), {bound['bound_ms'] / ms:.1%} of it; plain version "
          f"(ln_bwd_fp32) {plain_ms:.4f} ms; native_layer_norm_backward on the same rows (bf16 "
          f"in and out, the plain LayerNorm-backward part only) {native_ms:.4f} ms; {card}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=native_ms, max_abs_err=err, **bound)


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


#: Kernels told apart by their template arguments: the GEMM's three
#: layouts <trans_a, trans_b, act kind>, #8's two forms and #12's instance.
_GEMM_LABELS = {"gemm_bf16_sm90<false, false, 3": "gemm_bf16 NN + LN2 (#15, clusters)",
                "gemm_f32_sm90<false, false": "gemm_f32 NN (forward; 3xTF32)",
                "gemm_f32_sm90<false, true": "gemm_f32 NT (dX, dz, datt; 3xTF32)",
                "gemm_f32_sm90<true, false": "gemm_f32 TN (weight gradients; 3xTF32)",
                "gemm_f32_sum_kernel": "gemm_f32 split-K sum",
                "gemm_bf16_sm90<false, false": "gemm_bf16 NN (forward)",
                "gemm_bf16_sm90<false, true": "gemm_bf16 NT (dX, dz, datt)",
                "gemm_bf16_sm90<true, false": "gemm_bf16 TN (weight gradients)",
                "gemm_splitk_sum": "gemm_bf16 TN split-K sum",
                "sfc::slice_sum_kernel": "slice_sum (colsum's and ln_rows_bwd's second launch)",
                "attention_bwd_sm90<1, false": "attention_bwd_sm90 (#4)",
                "attention_bwd_sm90": "attention_bwd_sm90 (#6: mask, Dh 192)",
                "flash_fwd_sm90<false, false>": "flash_fwd streaming (#8)",
                "flash_fwd_sm90<true, false>": "flash_fwd single K step (#8)",
                "flash_fwd_sm90<true, true>": "local_fwd (#12)",
                "flash_bwd_fused_sm90": "flash_bwd fused (#9)",
                "flash_bwd_dkv_sm90<true>": "local_bwd dk, dv (#13)",
                "flash_bwd_dq_sm90<true>": "local_bwd dq (#13)",
                "flash_bwd_dkv_sm90": "flash_dkv (#11)",
                "flash_bwd_dq_sm90": "flash_dq (#10)"}


def _kernel_label(name: str) -> str:
    short = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    for key, label in _GEMM_LABELS.items():
        if short.startswith(key):
            return label
    if short.startswith("packed_attn_sm90<"):  # <Dh, key columns, masked>
        return "packed_attn_sm90 masked (#5)" if ", true>" in short else "packed_attn_sm90"
    return re.split(r"[<(]", short, maxsplit=1)[0].strip()


#: Traces taken before a profile that disagrees with CUDA events is
#: reported as not measured.
_PROFILE_ATTEMPTS = 3


def _profile(fn, what: str, steps: int = 2, top: int = 14, also: tuple = ()):
    """Device time by kernel over ``steps`` calls of ``fn`` (torch.profiler,
    CUPTI), and the idle share: 1 - kernel time / host wall time of the
    window, which ends in a synchronize.  Tracing adds a few us per launch
    to the host side, so the idle share is an upper bound.

    The trace is held to CUDA events recorded around the same window: its
    span from the first kernel's start to the last one's end must cover at
    least 3/4 of the events' window.  Late in a long run a trace has come
    back with every kernel's time scaled down (by 0.5 and by 0.7) against
    CUDA events and the step's own timing; such a trace is taken again,
    and after ``_PROFILE_ATTEMPTS`` the breakdown is reported as not
    measured.
    Kernel times elsewhere in this script come from CUDA events.  Kernels
    whose label starts with one of ``also`` are listed even past the top.
    Returns the device-busy ms per call, or None when not measured."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(_PROFILE_ATTEMPTS):
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            start.record()
            for _ in range(steps):
                fn()
            end.record()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
        _check(bool(kernels), "the profiler saw no device time")
        span_us = (max(e.time_range.end for e in kernels)
                   - min(e.time_range.start for e in kernels))
        window_us = start.elapsed_time(end) * 1e3
        if span_us >= 0.75 * window_us:
            break
        print(f"profile of {what}: the trace spans {span_us / 1e3:.2f} ms of device time, "
              f"CUDA events {window_us / 1e3:.2f} ms; tracing again")
    else:
        print(f"profile of {what}: no trace agreed with CUDA events in "
              f"{_PROFILE_ATTEMPTS} attempts; the breakdown and idle share are not "
              "measured")
        return None
    by_name: dict = {}
    for e in kernels:
        label = _kernel_label(e.name)
        by_name[label] = by_name.get(label, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    print(f"profile of {steps} x {what}: device busy {busy / 1e3 / steps:.2f} ms of "
          f"{wall_us / 1e3 / steps:.2f} ms wall per call, idle share "
          f"{1 - busy / wall_us:.2%}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    for label, us in ranked[:top]:
        print(f"  {us / busy:7.2%}  {us / 1e3 / steps:9.3f} ms/call  {label}")
    if len(ranked) > top:
        rest = sum(us for _, us in ranked[top:])
        print(f"  {rest / busy:7.2%}  {rest / 1e3 / steps:9.3f} ms/call  "
              f"{len(ranked) - top} other kernels, among them:")
        for label, us in ranked[top:]:
            if label.startswith(also):
                print(f"  {us / busy:7.2%}  {us / 1e3 / steps:9.3f} ms/call  {label}")
    return busy / 1e3 / steps


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
    _masked_attention_bwd_phase(card)
    for mb, mn, mh, mdh in MASKED_BWD_SHAPES:  # #5's attention at the same shapes
        _masked_attention_fwd_case(card, mb, mn, mh, mdh)

    # #7 at the flagship's evaluation batch (the kernels line), its
    # serving batch 16 and 'hier''s level and fusion layers.
    results["packed_flash_attention"] = _packed_case(gen, card, FA_PACKED_B, n, d, h)
    for pb, pn, inner, ph in ((FA_BATCH_SIZES[0], n, d, h), (FA_PACKED_B, 64, 256, 4),
                              (FA_PACKED_B, 192, 256, 4)):
        _packed_case(gen, card, pb, pn, inner, ph)
    return results


def _packed_case(gen, card: str, b: int, n: int, inner: int, heads: int) -> dict:
    """#7 on a random packed qkv [b, n, 3 * inner] against ``_packed_xla_ref``
    (BLOCK_TOL), then timed by graph replay (:func:`_graph_ms`: a call lasts
    tens of microseconds, under the Python launch path) in turns with its
    plain version, and ``F.scaled_dot_product_attention`` on contiguous [b,
    heads, n, dh] copies of q, k and v made before the timing."""
    qkv = _randn(gen, b, n, 3 * inner)
    dh = inner // heads
    s = dh ** -0.5
    shape = f"qkv [{b}, {n}, {3 * inner}], {heads} heads of {dh}"
    with torch.no_grad():
        got = packed_flash_attention(qkv, heads)
        err, ok = _agree(got, _packed_xla_ref(qkv, heads, s), **BLOCK_TOL)
        print(f"packed_flash_attention vs _packed_xla_ref, {shape}: max abs err {err:.4g} "
              f"(tolerance rtol {BLOCK_TOL['rtol']}, atol {BLOCK_TOL['atol']})")
        _check(ok, f"kernel #7 disagrees with _packed_xla_ref at {shape}")
        q, k, v = (t.contiguous() for t in qkv.view(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4))
        kern = lambda: packed_flash_attention(qkv, heads)  # noqa: E731
        plain = lambda: _packed_xla_ref(qkv, heads, s)  # noqa: E731
        p1, k1, k2, p2 = (_graph_ms(f) for f in (plain, kern, kern, plain))
        lib_ms = _graph_ms(lambda: TF.scaled_dot_product_attention(q, k, v))
    t = dict(max_abs_err=err, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=lib_ms,
             **_bound(4 * b * heads * n * n * dh, 2 * (b * n * 3 * inner + b * n * inner)))
    print(f"packed_flash_attention (#7), {shape}, by graph replay: kernel {t['ms']:.4f} ms, "
          f"plain {t['plain_ms']:.4f} ms, "
          f"F.scaled_dot_product_attention {lib_ms:.4f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}), {card}")
    return t


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
    with torch.inference_mode():
        _profile(lambda: engine.model(xb), f"flagship serving forward at batch {bs}", steps=5)
    return launches


def _lse64_chunked(q, k, scale, chunk: int = 1024) -> torch.Tensor:
    """fp64 log-sum-exp of every query's scaled logits, [B, H, Nq], a
    chunk of queries at a time."""
    kd = k.double().transpose(1, 2)
    out = []
    for q0 in range(0, q.shape[1], chunk):
        qd = q[:, q0:q0 + chunk].double().transpose(1, 2)
        out.append(torch.logsumexp((qd @ kd.transpose(-1, -2)) * scale, dim=-1))
    return torch.cat(out, dim=-1)


def _frac_err(name: str, got, want, frac: float) -> float:
    """max |got - want| within ``frac`` x max |want|; returns the error."""
    _check(got.dtype == want.dtype, f"{name}: dtype {got.dtype} != {want.dtype}")
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    print(f"  {name}: max abs err {err:.4g}, max |value| {scale:.4g} (tolerance "
          f"{frac} x max |value| = {frac * scale:.4g})")
    _check(err <= frac * scale, f"{name} disagrees with its plain version")
    return err


def _packed_views(gen, b, n, heads):
    """q, k, v [B, N, H, 64] as views of one packed projection (the model's
    layout) and a cotangent g."""
    qkv = _randn(gen, b, n, 3 * heads * 64)
    q, k, v = qkv.view(b, n, 3, heads, 64).unbind(2)
    return q, k, v, _randn(gen, b, n, heads, 64)


def _sdpa_ms(q, k, v, g):
    """F.scaled_dot_product_attention forward and autograd-backward ms on
    contiguous [B, H, N, Dh] copies (the library yardstick; the port never
    calls it)."""
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    gt = g.transpose(1, 2).contiguous()
    with torch.no_grad():
        fwd = _ms(lambda: TF.scaled_dot_product_attention(qt, kt, vt), iters=5)
    out = TF.scaled_dot_product_attention(qt, kt, vt)

    def bwd():
        for t in (qt, kt, vt):
            t.grad = None
        out.backward(gt, retain_graph=True)
    return fwd, _ms(bwd, iters=5)


def _tflops(flops: float, ms: float) -> str:
    return f"{flops / ms / 1e9:.1f} TFLOP/s"


def _flash_bytes(b, nq, nk, h, *, n_bf16_q, n_bf16_k, n_fp32_q):
    """Bytes a flash call must move: bf16 [B, N, H, 64] tensors over the
    queries and the keys, fp32 [B, H, Nq] rows."""
    return 2 * 64 * h * b * (n_bf16_q * nq + n_bf16_k * nk) + 4 * b * h * nq * n_fp32_q


def phase_flash_kernels(card: str) -> dict:
    """Kernels #8-#11 at the long-context shapes against their plain
    versions, timed beside their bounds and SDPA."""
    gen = torch.Generator().manual_seed(4)
    s = 64 ** -0.5
    res = {k: dict(errs=[]) for k in ("flash_attention", "flash_attention_fused_bwd",
                                      "flash_attention_dq", "flash_attention_dkv")}
    with torch.no_grad():
        # Long-context preset: #8 streaming, #10, #11.
        b, n, h = LC_B, LC_N, LC_HEADS
        q, k, v, g = _packed_views(gen, b, n, h)
        print(f"#8 streaming, q/k/v [{b}, {n}, {h}, 64] views of qkv [{b}, {n}, "
              f"{3 * h * 64}] bf16:")
        out, lse = flash.flash_fwd(q, k, v, s, return_lse=True)
        want = flash.flash_fwd_ref(q, k, v, s, block_q=n, block_k=STREAM_BK)
        res["flash_attention"]["errs"].append(_frac_err("out", out, want, FLASH_TOL))
        lse_err, lse_ok = _agree(lse, _lse64_chunked(q, k, s), **LSE_TOL)
        print(f"  lse: max abs err {lse_err:.4g} against fp64 (tolerance rtol "
              f"{LSE_TOL['rtol']}, atol {LSE_TOL['atol']})")
        _check(lse_ok, "kernel #8: lse disagrees with the fp64 log-sum-exp")
        del want
        delta = flash.flash_delta(g, out)
        print(f"#10 / #11 from the saved out and lse:")
        dq = flash.flash_dq(q, k, v, g, lse, delta, s)
        res["flash_attention_dq"]["errs"].append(_frac_err(
            "dq", dq, flash.flash_dq_ref(q, k, v, g, lse, delta, s), FLASH_TOL))
        dk, dv = flash.flash_dkv(q, k, v, g, lse, delta, s)
        want_dk, want_dv = flash.flash_dkv_ref(q, k, v, g, lse, delta, s)
        res["flash_attention_dkv"]["errs"] += [
            _frac_err("dk", dk, want_dk, FLASH_TOL), _frac_err("dv", dv, want_dv, FLASH_TOL)]
        del dq, dk, dv, want_dk, want_dv
        t = res["flash_attention"]
        t["ms"], t["plain_ms"] = _ab_ms(lambda: flash.flash_fwd(q, k, v, s),
                                        lambda: flash.flash_fwd_ref(q, k, v, s, block_q=n,
                                                                    block_k=STREAM_BK),
                                        iters=3)
        t.update(_bound(4 * b * h * n * n * 64,
                        _flash_bytes(b, n, n, h, n_bf16_q=2, n_bf16_k=2, n_fp32_q=0)))
        t["shape"] = f"q/k/v [{b}, {n}, {h}, 64], streaming"
        t = res["flash_attention_dq"]
        t["ms"], t["plain_ms"] = _ab_ms(
            lambda: flash.flash_dq(q, k, v, g, lse, delta, s),
            lambda: flash.flash_dq_ref(q, k, v, g, lse, delta, s), iters=3)
        t.update(_bound(6 * b * h * n * n * 64,
                        _flash_bytes(b, n, n, h, n_bf16_q=3, n_bf16_k=2, n_fp32_q=2)))
        t = res["flash_attention_dkv"]
        t["ms"], t["plain_ms"] = _ab_ms(
            lambda: flash.flash_dkv(q, k, v, g, lse, delta, s),
            lambda: flash.flash_dkv_ref(q, k, v, g, lse, delta, s), iters=3)
        t.update(_bound(8 * b * h * n * n * 64,
                        _flash_bytes(b, n, n, h, n_bf16_q=2, n_bf16_k=4, n_fp32_q=2)))
    lib_fwd, lib_bwd = _sdpa_ms(q, k, v, g)
    res["flash_attention"]["library_ms"] = lib_fwd
    res["flash_attention_dq"]["library_ms"] = res["flash_attention_dkv"]["library_ms"] = lib_bwd
    work = b * h * n * n * 64
    for name, what, nominal, executed in (
            ("flash_attention", "#8 streaming", 4, 4), ("flash_attention_dq", "#10", 6, 8),
            ("flash_attention_dkv", "#11", 8, 12)):
        t = res[name]
        print(f"{what}: kernel {t['ms']:.3f} ms ({_tflops(nominal * work, t['ms'])} nominal, "
              f"{_tflops(executed * work, t['ms'])} executed), plain {t['plain_ms']:.3f} ms, "
              f"bound {t['bound_ms']:.3f} ms ({t['bound_by']}), "
              f"F.scaled_dot_product_attention "
              f"{'forward' if name == 'flash_attention' else 'backward (dq, dk, dv)'} "
              f"{t['library_ms']:.3f} ms; [{b}, {n}, {h}, 64] bf16, {card}")
    del q, k, v, g, out, lse, delta

    with torch.no_grad():
        # CurveViT-S/12 at 4,096 tokens: #8 single K step, #9.
        b, n, h = VS_B, VS_N, LC_HEADS
        q, k, v, g = _packed_views(gen, b, n, h)
        print(f"#8 single K step and #9, q/k/v [{b}, {n}, {h}, 64] views of a packed "
              f"projection:")
        out, lse = flash.flash_fwd(q, k, v, s, return_lse=True)
        res["flash_attention"]["errs"].append(
            _frac_err("out", out, flash.flash_fwd_ref(q, k, v, s), FLASH_TOL))
        lse_err, lse_ok = _agree(lse, _lse64_chunked(q, k, s), **LSE_TOL)
        print(f"  lse: max abs err {lse_err:.4g} against fp64")
        _check(lse_ok, "kernel #8 (single step): lse disagrees with the fp64 log-sum-exp")
        got = flash.flash_fused_bwd(q, k, v, out, lse, g, s)
        want = flash.flash_fused_bwd_ref(q, k, v, g, s)
        res["flash_attention_fused_bwd"]["errs"] += [
            _frac_err(nm, a, w, FLASH_FUSED_TOL) for nm, a, w in zip(("dq", "dk", "dv"), got, want)]
        del got, want
        ms1, plain1 = _ab_ms(lambda: flash.flash_fwd(q, k, v, s),
                             lambda: flash.flash_fwd_ref(q, k, v, s), iters=3)
        t = res["flash_attention_fused_bwd"]
        t["ms"], t["plain_ms"] = _ab_ms(
            lambda: flash.flash_fused_bwd(q, k, v, out, lse, g, s),
            lambda: flash.flash_fused_bwd_ref(q, k, v, g, s), iters=3)
        t.update(_bound(10 * b * h * n * n * 64,  # q, g, out, dq; k, v, dk, dv; lse
                        _flash_bytes(b, n, n, h, n_bf16_q=4, n_bf16_k=4, n_fp32_q=1)))
    lib_fwd, lib_bwd = _sdpa_ms(q, k, v, g)
    res["flash_attention_fused_bwd"]["library_ms"] = lib_bwd
    t = res["flash_attention_fused_bwd"]
    single = dict(ms=ms1, plain_ms=plain1, library_ms=lib_fwd,
                  **_bound(4 * b * h * n * n * 64,
                           _flash_bytes(b, n, n, h, n_bf16_q=2, n_bf16_k=2, n_fp32_q=0)))
    res["flash_attention"]["single_step"] = single
    work = b * h * n * n * 64
    print(f"#8 single K step: kernel {ms1:.3f} ms ({_tflops(4 * work, ms1)} nominal, "
          f"{_tflops(6 * work, ms1)} executed: the logits twice), plain {plain1:.3f} ms, "
          f"bound {single['bound_ms']:.3f} ms ({single['bound_by']}), SDPA forward "
          f"{lib_fwd:.3f} ms; #9: kernel {t['ms']:.3f} ms ({_tflops(10 * work, t['ms'])} "
          f"nominal, {_tflops(16 * work, t['ms'])} executed: the split doubles four "
          f"products), plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms "
          f"({t['bound_by']}), SDPA backward {lib_bwd:.3f} ms; [{b}, {n}, {h}, 64] bf16, "
          f"{card}")
    del q, k, v, g, out, lse

    with torch.no_grad():
        # Ragged: 3,000 queries against 5,000 keys (streaming forward, #9
        # by JAX's gate) through all four kernels.
        b, nq, nk, h = 2, 3000, 5000, LC_HEADS
        q, g = _randn(gen, b, nq, h, 64), _randn(gen, b, nq, h, 64)
        k, v = _randn(gen, b, nk, h, 64), _randn(gen, b, nk, h, 64)
        print(f"ragged: q [{b}, {nq}, {h}, 64], k/v [{b}, {nk}, {h}, 64]:")
        out, lse = flash.flash_fwd(q, k, v, s, return_lse=True)
        res["flash_attention"]["errs"].append(
            _frac_err("out", out, flash.flash_fwd_ref(q, k, v, s, block_q=nq, block_k=STREAM_BK),
                      FLASH_TOL))
        lse_err, lse_ok = _agree(lse, _lse64_chunked(q, k, s), **LSE_TOL)
        print(f"  lse: max abs err {lse_err:.4g} against fp64")
        _check(lse_ok, "kernel #8 (ragged): lse disagrees with the fp64 log-sum-exp")
        delta = flash.flash_delta(g, out)
        res["flash_attention_dq"]["errs"].append(_frac_err(
            "dq", flash.flash_dq(q, k, v, g, lse, delta, s),
            flash.flash_dq_ref(q, k, v, g, lse, delta, s), FLASH_TOL))
        res["flash_attention_dkv"]["errs"] += [
            _frac_err(nm, a, w, FLASH_TOL) for nm, a, w in zip(
                ("dk", "dv"), flash.flash_dkv(q, k, v, g, lse, delta, s),
                flash.flash_dkv_ref(q, k, v, g, lse, delta, s))]
        res["flash_attention_fused_bwd"]["errs"] += [
            _frac_err(nm, a, w, FLASH_FUSED_TOL) for nm, a, w in zip(
                ("dq (#9)", "dk (#9)", "dv (#9)"),
                flash.flash_fused_bwd(q, k, v, out, lse, g, s),
                flash.flash_fused_bwd_ref(q, k, v, g, s))]
        work = b * h * nq * nk * 64
        for what, fn, nominal, executed, counts in (
                ("#10", lambda: flash.flash_dq(q, k, v, g, lse, delta, s), 6, 8, (3, 2, 2)),
                ("#11", lambda: flash.flash_dkv(q, k, v, g, lse, delta, s), 8, 12, (2, 4, 2))):
            ms = _ms(fn, iters=5)
            bound = _bound(nominal * work, _flash_bytes(b, nq, nk, h, n_bf16_q=counts[0],
                                                        n_bf16_k=counts[1],
                                                        n_fp32_q=counts[2]))
            print(f"  {what}: kernel {ms:.3f} ms ({_tflops(nominal * work, ms)} nominal, "
                  f"{_tflops(executed * work, ms)} executed), bound {bound['bound_ms']:.3f} ms "
                  f"({bound['bound_by']}), {card}")
        del q, k, v, g, out, lse, delta

        # #9 against #10 + #11 at JAX's _FUSED_BWD_MAX (8,192 tokens).
        b, n, h = 4, flash.FUSED_BWD_MAX, LC_HEADS
        q, k, v, g = _packed_views(gen, b, n, h)
        out, lse = flash.flash_fwd(q, k, v, s, return_lse=True)

        def pair():
            d = flash.flash_delta(g, out)
            flash.flash_dq(q, k, v, g, lse, d, s)
            flash.flash_dkv(q, k, v, g, lse, d, s)
        fused_ms, pair_ms = _ab_ms(lambda: flash.flash_fused_bwd(q, k, v, out, lse, g, s),
                                   pair, iters=3)
        print(f"at {n} tokens (JAX's _FUSED_BWD_MAX), batch {b}, {h} heads of 64: #9 "
              f"{fused_ms:.3f} ms, #10 + #11 (with their delta) {pair_ms:.3f} ms "
              f"({'#9' if fused_ms < pair_ms else '#10 + #11'} faster); the gate stays "
              f"at {flash.FUSED_BWD_MAX}, {card}")
        del q, k, v, g, out, lse
    for t in res.values():
        t["max_abs_err"] = max(t.pop("errs"))
    return res


def _plain_longctx():
    """Route a family-B model through the plain versions of every kernel
    on its path (comparison only): flash #8-#11, curve-local #12/#13, the
    MLP blocks #2/#3 and the attention blocks #1/#4."""
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(fa_attention, "flash_attention",
                                          flash.flash_attention_ref))
    stack.enter_context(mock.patch.object(fa_attention, "local_block_attention",
                                          local.local_block_attention_ref))
    stack.enter_context(_plain_blocks())
    return stack


def _reset_flash_counts():
    f = flash.flash_attention
    f.launches = f.fused_bwd_launches = f.dq_launches = f.dkv_launches = 0
    local.local_block_attention.launches = local.local_block_attention.bwd_launches = 0


def _flash_counts() -> dict:
    """The launches of the flash (#8-#11) and curve-local (#12, #13) kernels."""
    f, lo = flash.flash_attention, local.local_block_attention
    return {"flash_attention": f.launches, "flash_attention_fused_bwd": f.fused_bwd_launches,
            "flash_attention_dq": f.dq_launches, "flash_attention_dkv": f.dkv_launches,
            "local_block_attention": lo.launches, "local_block_attention_bwd": lo.bwd_launches}


def _longctx_model(card: str, label: str, cfg, batch: int, steps: int,
                   bwd_kernels: tuple, profile: bool) -> dict:
    """Train, evaluate and serve one long-context model on the card; returns
    the flash and curve-local launch counts of its main path.  A layer
    scheduled ``'local'`` launches #12/#13, every other layer #8 and the
    backward kernels in ``bwd_kernels``."""
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    impls = (cfg.attn_impl,) * cfg.depth if isinstance(cfg.attn_impl, str) else cfg.attn_impl
    n_local = list(impls).count("local")
    n_global = cfg.depth - n_local
    n_tokens = (cfg.img_size // cfg.patch_size) ** 2
    stats = ((0.5,) * 3, (0.25,) * 3)
    train_ds = synthetic_dataset(n=batch * steps, hw=cfg.img_size,
                                 num_classes=cfg.num_classes, seed=0)
    test_ds = synthetic_dataset(n=batch, hw=cfg.img_size, num_classes=cfg.num_classes,
                                seed=1)
    tf = make_eval_transform(*stats, device=DEVICE)
    trainer = Trainer(model, TrainConfig(num_classes=cfg.num_classes, epochs=1,
                                         warmup_epochs=1), steps_per_epoch=steps)
    before = [p.detach().clone() for p in model.parameters()]
    _reset_flash_counts()
    record = trainer.fit(
        lambda: ((tf(x), y) for x, y in epoch_batches(train_ds, batch, seed=0)),
        lambda: ((tf(x), y) for x, y in epoch_batches(test_ds, batch, shuffle=False,
                                                      drop_last=False)))
    torch.cuda.synchronize()
    counts = _flash_counts()
    print(f"{label}: Trainer.fit, 1 epoch of {steps} steps at batch {batch} + eval of "
          f"{len(test_ds)}: {record}")
    print(f"{label}: launches over {steps} train steps + 1 eval batch of {n_global} "
          f"global and {n_local} local layers: {counts}")
    _check(bool(np.isfinite(record["train_loss"])), f"{label}: non-finite train loss")
    _check(bool(np.isfinite(record["test_loss"])), f"{label}: non-finite eval loss")
    _check(trainer.state.step == steps, f"{label}: {trainer.state.step} steps taken")
    want = {"flash_attention": n_global * (steps + 1),
            "local_block_attention": n_local * (steps + 1),
            "local_block_attention_bwd": n_local * steps}
    for name in ("flash_attention_fused_bwd", "flash_attention_dq", "flash_attention_dkv"):
        want[name] = n_global * steps if name in bwd_kernels else 0
    _check(counts == want, f"{label}: launches {counts}, expected {want}")
    still = [nm for (nm, p), q in zip(model.named_parameters(), before) if torch.equal(p, q)]
    _check(not still, f"{label}: parameters unchanged after {steps} steps: {still}")
    del before

    # One step from the same parameters and batch, kernels against plain.
    x, y = next(epoch_batches(train_ds, batch, seed=0))
    batch_t = (tf(x), torch.from_numpy(y).long().to(DEVICE))
    state = _lr_zero_state(model)
    step = make_train_step(cfg.num_classes, use_mixing=False)
    m_k = step(state, batch_t, torch.Generator())
    grads = {nm: p.grad.detach().clone() for nm, p in model.named_parameters()}
    with _plain_longctx():
        m_p = step(state, batch_t, torch.Generator())
    rel = {nm: float((grads[nm].float() - p.grad.float()).norm() / p.grad.float().norm())
           for nm, p in model.named_parameters()}
    worst = max(rel, key=rel.get)
    print(f"{label}: one train step, kernels vs plain versions: loss "
          f"{float(m_k['loss']):.6f} vs {float(m_p['loss']):.6f}; gradient relative L2 "
          f"error max {rel[worst]:.4g} ({worst}), median "
          f"{float(np.median(list(rel.values()))):.4g} over {len(rel)} tensors "
          f"(tolerance {GRAD_REL_TOL})")
    _check(rel[worst] <= GRAD_REL_TOL, f"{label}: kernel-path gradients disagree with "
           "the plain path")
    del grads

    mixing_step = make_train_step(cfg.num_classes)
    gen = torch.Generator().manual_seed(0)

    def step_ms(plain: bool, n_steps: int = 2) -> float:
        with _plain_longctx() if plain else contextlib.nullcontext():
            mixing_step(state, batch_t, gen)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_steps):
                mixing_step(state, batch_t, gen)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n_steps * 1e3

    p1, k1, k2, p2 = (step_ms(plain) for plain in (True, False, False, True))
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"{label}: train step at batch {batch} (mixing, clip, AdamW): kernels "
          f"{k_ms:.2f} ms = {batch / k_ms * 1e3:.2f} img/s = "
          f"{batch * n_tokens / k_ms * 1e3:.0f} tokens/s, plain versions {p_ms:.2f} ms "
          f"= {batch / p_ms * 1e3:.2f} img/s = {batch * n_tokens / p_ms * 1e3:.0f} "
          f"tokens/s, {card}")
    print(f"{label}: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        _profile(lambda: mixing_step(state, batch_t, gen),
                 f"{label} train step at batch {batch}", steps=1)
    del state, batch_t

    engine = ServingEngine(copy.deepcopy(model), None, (cfg.img_size, cfg.img_size, 3),
                           batch_sizes=(1, 4), dtype=torch.bfloat16, device=DEVICE)
    rng = np.random.default_rng(5)
    requests = [rng.standard_normal((k, cfg.img_size, cfg.img_size, 3), dtype=np.float32)
                for k in (1, 4)]
    _reset_flash_counts()
    outs = [engine.predict(r) for r in requests]
    served = flash.flash_attention.launches
    served_local = local.local_block_attention.launches
    for k, out in zip((1, 4), outs):
        _check(out.shape == (k, cfg.num_classes) and bool(np.isfinite(out).all()),
               f"{label}: bad served logits for {k} images")
    _check(served == 2 * n_global and served_local == 2 * n_local,
           f"{label}: #8 launched {served} and #12 {served_local} times over 2 served "
           f"forwards of {n_global} global and {n_local} local layers")
    with _plain_longctx():
        plain = [engine.predict(r) for r in requests]
    outs, plain = np.concatenate(outs), np.concatenate(plain)
    err, scale = float(np.abs(outs - plain).max()), float(np.abs(plain).max())
    print(f"{label}: served 1 and 4 images, logits finite; #8 launched {served} and #12 "
          f"{served_local} times over 2 forwards; kernels vs plain versions max abs err "
          f"{err:.4g} (max |logit| "
          f"{scale:.4g}; tolerance {FA_LOGIT_TOL} x max |logit|)")
    _check(err <= FA_LOGIT_TOL * scale, f"{label}: served logits disagree with the plain "
           "forward")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        engine.predict(requests[-1])
    serve_s = (time.perf_counter() - t0) / 3
    print(f"{label}: predict() of 4 images, host to host: {serve_s * 1e3:.2f} ms = "
          f"{4 / serve_s:.2f} img/s, {card}")
    counts["flash_attention"] += served
    counts["local_block_attention"] += served_local
    return counts


def phase_longctx(card: str) -> dict:
    """The long-context slice: the longctx-16k preset and CurveViT-S/12 at
    4,096 tokens, trained, evaluated and served through #8-#11."""
    a = _longctx_model(card, "longctx-16k", preset_config("longctx-16k"), LC_B,
                       LC_STEPS, ("flash_attention_dq", "flash_attention_dkv"),
                       profile=True)
    b = _longctx_model(card, "CurveViT-S/12 at 4,096 tokens",
                       preset_config("vit-s-16", img_size=256, patch_size=4,
                                     num_classes=1000, dtype="bfloat16"),
                       VS_B, VS_STEPS, ("flash_attention_fused_bwd",), profile=True)
    return {name: a[name] + b[name] for name in a}


#: The hybrid preset's curve-local attention: JAX's defaults, block 128 and
#: halo 1, at 16,384 tokens (layers 0-1) and 12,288 after the merge (layer 2).
LOCAL_BLOCK, LOCAL_HALO, LC_MERGED_N = 128, 1, 12288


def _window_pairs(n: int, block: int, halo: int) -> int:
    """(query, key) pairs of the curve-local mask at length ``n``: what the
    work of #12/#13 is counted on (the edge blocks' windows are shorter)."""
    pairs = 0
    for j in range(-(-n // block)):
        lo, hi = local.window(j, n, block, halo)
        pairs += (min(n, (j + 1) * block) - j * block) * (hi - lo)
    return pairs


def _band_mask(n: int, block: int, halo: int) -> torch.Tensor:
    """The boolean [N, N] curve-local mask (True where a query may attend)."""
    ids = torch.arange(n, device=DEVICE) // block
    return (ids[:, None] - ids[None, :]).abs() <= halo


def _sdpa_masked_ms(q, k, v, g, mask):
    """F.scaled_dot_product_attention with a boolean band mask, forward and
    autograd backward ms on contiguous [B, H, N, Dh] copies: one PyTorch
    call for the function #12/#13 compute (the library yardstick; the
    port never calls it)."""
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    gt = g.transpose(1, 2).contiguous()
    with torch.no_grad():
        fwd = _ms(lambda: TF.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                  iters=5)
    out = TF.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    def bwd():
        for t in (qt, kt, vt):
            t.grad = None
        out.backward(gt, retain_graph=True)
    return fwd, _ms(bwd, iters=5)


def _local_bwd_ms(card: str, n: int) -> float:
    """#13 alone (``local.local_bwd``, through launchers an earlier tree also
    has) at the hybrid preset's [LC_B, n, LC_HEADS, 64], block 128, halo 1,
    q, k, v views of one packed projection: CUDA-event ms of 20 calls."""
    gen = torch.Generator().manual_seed(14)
    s = 64 ** -0.5
    with torch.no_grad():
        q, k, v, g = _packed_views(gen, LC_B, n, LC_HEADS)
        out, lse = local.local_fwd(q, k, v, LOCAL_BLOCK, LOCAL_HALO, s, return_lse=True)
        delta = flash.flash_delta(g, out)
        ms = _ms(lambda: local.local_bwd(q, k, v, g, lse, delta, LOCAL_BLOCK, LOCAL_HALO, s))
    print(f"#13 alone, [{LC_B}, {n}, {LC_HEADS}, 64], block {LOCAL_BLOCK}, halo {LOCAL_HALO}: "
          f"{ms:.4f} ms, {card}")
    return ms


def phase_local_kernels(card: str) -> dict:
    """Kernels #12 and #13 at the hybrid preset's shapes (16,384 and 12,288
    tokens), a ragged length and the dense case against their plain
    versions; timed at 16,384 beside their bounds and SDPA with a band
    mask."""
    gen = torch.Generator().manual_seed(6)
    s = 64 ** -0.5
    blk, halo = LOCAL_BLOCK, LOCAL_HALO
    res = {"local_block_attention": dict(errs=[]), "local_block_attention_bwd": dict(errs=[])}
    b, h = LC_B, LC_HEADS
    for n in (LC_N, LC_MERGED_N, 5000):
        with torch.no_grad():
            q, k, v, g = _packed_views(gen, b, n, h)
            print(f"#12 / #13, block {blk}, halo {halo}, q/k/v [{b}, {n}, {h}, 64] views of "
                  f"qkv [{b}, {n}, {3 * h * 64}] bf16:")
            out, lse = local.local_fwd(q, k, v, blk, halo, s, return_lse=True)
            want, want_lse = local.local_fwd_ref(q, k, v, blk, halo, s, return_lse=True)
            res["local_block_attention"]["errs"].append(_frac_err("out", out, want, FLASH_TOL))
            lse_err, lse_ok = _agree(lse, want_lse, **LSE_TOL)
            print(f"  lse: max abs err {lse_err:.4g} against the plain version's fp32 lse "
                  f"(tolerance rtol {LSE_TOL['rtol']}, atol {LSE_TOL['atol']})")
            _check(lse_ok, "kernel #12: lse disagrees with its plain version")
            again, again_lse = local.local_fwd(q, k, v, blk, halo, s, return_lse=True)
            _check(torch.equal(out, again) and torch.equal(lse, again_lse),
                   f"kernel #12 does not repeat bit for bit at {n} tokens")
            print("  #12: out and lse the same bits on a second call")
            del again, again_lse
            delta = flash.flash_delta(g, out)
            got = local.local_bwd(q, k, v, g, lse, delta, blk, halo, s)
            want = local.local_bwd_ref(q, k, v, g, lse, delta, blk, halo, s)
            res["local_block_attention_bwd"]["errs"] += [
                _frac_err(nm, x, w, FLASH_TOL) for nm, x, w in zip(("dq", "dk", "dv"), got, want)]
            _check(all(torch.equal(x, y) for x, y in zip(
                got, local.local_bwd(q, k, v, g, lse, delta, blk, halo, s))),
                f"kernel #13 does not repeat bit for bit at {n} tokens")
            print("  #13: dq, dk, dv the same bits on a second call")
            del got, want
            if n != LC_N:
                continue
            dims = (b, n, n, h, 64)
            dq_ms, dkv_ms = (_ms(lambda f=f: f(q, k, v, g, lse, delta, s, dims, blk, halo))
                             for f in (_build._dq, _build._dkv))
            print(f"  #13's two launches: dq {dq_ms:.4f} ms, dk and dv {dkv_ms:.4f} ms "
                  f"(windowed csrc/flash_bwd_dq_sm90.cu, csrc/flash_bwd_dkv_sm90.cu), {card}")
            pairs = _window_pairs(n, blk, halo)
            t = res["local_block_attention"]
            t["ms"], t["plain_ms"] = _ab_ms(
                lambda: local.local_fwd(q, k, v, blk, halo, s, return_lse=True),
                lambda: local.local_fwd_ref(q, k, v, blk, halo, s, return_lse=True), iters=5)
            t.update(_bound(4 * b * h * pairs * 64,  # q, k, v, out; lse
                            _flash_bytes(b, n, n, h, n_bf16_q=2, n_bf16_k=2, n_fp32_q=1)))
            t = res["local_block_attention_bwd"]
            t["ms"], t["plain_ms"] = _ab_ms(
                lambda: local.local_bwd(q, k, v, g, lse, delta, blk, halo, s),
                lambda: local.local_bwd_ref(q, k, v, g, lse, delta, blk, halo, s), iters=5)
            t.update(_bound(12 * b * h * pairs * 64,  # q, g, dq; k, v, dk, dv; lse, delta
                            _flash_bytes(b, n, n, h, n_bf16_q=3, n_bf16_k=4, n_fp32_q=2)))
        if n == LC_N:
            mask = _band_mask(n, blk, halo)
            lib_fwd, lib_bwd = _sdpa_masked_ms(q, k, v, g, mask)
            del mask
            res["local_block_attention"]["library_ms"] = lib_fwd
            res["local_block_attention_bwd"]["library_ms"] = lib_bwd
            for name, what in (("local_block_attention", "#12 (with lse)"),
                               ("local_block_attention_bwd", "#13")):
                t = res[name]
                print(f"{what}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
                      f"{t['bound_ms']:.4f} ms ({t['bound_by']}), SDPA with a band mask "
                      f"{'forward' if name == 'local_block_attention' else 'backward'} "
                      f"{t['library_ms']:.4f} ms; [{b}, {n}, {h}, 64] bf16, {card}")
        del q, k, v, g, out, lse, delta

    # The dense case: 256 tokens at block 128, halo 1 is JAX's plain
    # attention (flash), never the local kernels.
    with torch.no_grad():
        q, k, v, _ = _packed_views(gen, b, 256, h)
        before = (local.local_block_attention.launches, flash.flash_attention.launches)
        got = local.local_block_attention(q, k, v, blk, halo)
        after = (local.local_block_attention.launches, flash.flash_attention.launches)
        _check(after == (before[0], before[1] + 1),
               f"256 tokens did not take the dense route: launches {before} -> {after}")
        print("dense case, 256 tokens (block 128, halo 1): flash attention #8, not #12:")
        res["local_block_attention"]["errs"].append(_frac_err(
            "out", got, local.local_block_attention_xla(q, k, v, blk, halo), FLASH_TOL))
    for t in res.values():
        t["max_abs_err"] = max(t.pop("errs"))
    _local_bwd_ms(card, LC_MERGED_N)  # the hybrid's third local layer, after the merge
    return res


def phase_hybrid(card: str) -> dict:
    """The hybrid long-context slice: ``longctx-16k-hybrid`` (three
    curve-local layers through #12/#13, one global through #8/#10/#11)
    trained, evaluated and served."""
    return _longctx_model(card, "longctx-16k-hybrid", preset_config("longctx-16k-hybrid"),
                          LC_B, LC_STEPS, ("flash_attention_dq", "flash_attention_dkv"),
                          profile=True)


def phase_gp_kernels(card: str) -> dict:
    """Kernel #14 at the fused flagship's three tokenizer levels (batch
    512, the model's own LUTs and random weights) against its plain
    version, timed beside its bound and ``index_select`` + ``F.linear``.
    The bias is random, standard normal: a fresh model's is zero, which
    would leave the kernel's fp32 bias epilogue unchecked.  A level's
    call lasts tens of microseconds, under the cost of the Python launch
    path, so all three are timed by graph replay (:func:`_graph_ms`).
    The times are the three levels' sums: one tokenizer forward."""
    gen = torch.Generator().manual_seed(7)
    cfg = preset_config("flagship", fused=True, dtype="bfloat16")
    tok = build_model(cfg, generator=torch.Generator().manual_seed(0)).patch_embed
    images = _randn(gen, FA_B, cfg.img_size, cfg.img_size, 3)
    t = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0, errs=[])
    with torch.no_grad():
        for i, pre in enumerate(tok.pre_patch_sizes):
            proj = getattr(tok, f"level_{i}").proj
            x = patchify(images, pre).contiguous()
            w, lut, grp = proj.kernel.to(torch.bfloat16), proj.lut, proj.group
            bias = _randn(gen, w.shape[1])
            bsz, n, kdim = x.shape
            m, d = lut.numel() // grp, w.shape[1]
            got = gp.gather_project(x, lut, w, bias, grp)
            print(f"#14 level {i}: x [{bsz}, {n}, {kdim}], group {grp} -> [{bsz}, {m}, {d}]:")
            t["errs"].append(_frac_err("out", got, gp.gather_project_ref(x, lut, w, bias, grp),
                                       FLASH_TOL))
            wt, lut64 = w.t().contiguous(), lut.long()
            kern = lambda: gp.gather_project(x, lut, w, bias, grp)  # noqa: E731
            plain = lambda: gp.gather_project_ref(x, lut, w, bias, grp)  # noqa: E731
            p1, k1, k2, p2 = (_graph_ms(f) for f in (plain, kern, kern, plain))
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            lib_ms = _graph_ms(lambda: TF.linear(
                x.index_select(1, lut64).reshape(bsz, m, grp * kdim), wt, bias))
            flops = 2 * bsz * m * grp * kdim * d
            nbytes = 2 * (bsz * n * kdim + grp * kdim * d + d + bsz * m * d) + 4 * m * grp
            level = _bound(flops, nbytes)
            print(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_select + F.linear "
                  f"{lib_ms:.4f} ms, bound {level['bound_ms']:.4f} ms ({level['bound_by']}), "
                  f"{card}")
            t["ms"] += ms
            t["plain_ms"] += plain_ms
            t["library_ms"] += lib_ms
            t["flops"] += flops
            t["bytes"] += nbytes
    t.update(_bound(t.pop("flops"), t.pop("bytes")))
    t["max_abs_err"] = max(t.pop("errs"))
    print(f"#14 over the three levels (one tokenizer forward at batch {FA_B}): kernel "
          f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}), index_select + F.linear {t['library_ms']:.4f} ms, {card}")
    return {"gather_project": t}


def phase_fused_flagship(card: str) -> dict:
    """The flagship with the fused tokenizer (``fused=True``): trained 4
    steps at batch 512, evaluated and served through #14; its served
    logits against the unfused flagship's at the same weights."""
    cfg = preset_config("flagship", fused=True, dtype="bfloat16")
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    levels = len(cfg.patch_size_list)
    stats = ((0.5,) * 3, (0.25,) * 3)
    b, steps = FA_B, FA_TRAIN_STEPS
    train_ds = synthetic_dataset(n=b * steps, hw=cfg.img_size,
                                 num_classes=cfg.num_classes, seed=0)
    test_ds = synthetic_dataset(n=b, hw=cfg.img_size, num_classes=cfg.num_classes, seed=1)
    tf = make_eval_transform(*stats, device=DEVICE)
    trainer = Trainer(model, TrainConfig(num_classes=cfg.num_classes, epochs=1,
                                         warmup_epochs=1), steps_per_epoch=steps)
    before = [p.detach().clone() for p in model.parameters()]
    gp.gather_project.launches = 0
    record = trainer.fit(
        lambda: ((tf(x), y) for x, y in epoch_batches(train_ds, b, seed=0)),
        lambda: ((tf(x), y) for x, y in epoch_batches(
            test_ds, b, shuffle=False, drop_last=False)))
    torch.cuda.synchronize()
    trained = gp.gather_project.launches
    print(f"fused flagship Trainer.fit, 1 epoch of {steps} steps at batch {b} + eval of "
          f"{len(test_ds)}: {record}")
    print(f"gather_project (#14) launches over {steps} train steps + 1 eval batch of "
          f"{levels} tokenizer levels: {trained}")
    _check(bool(np.isfinite(record["train_loss"])), "non-finite fused flagship train loss")
    _check(bool(np.isfinite(record["test_loss"])), "non-finite fused flagship eval loss")
    _check(trainer.state.step == steps, f"{trainer.state.step} steps taken")
    _check(trained == levels * (steps + 1), f"#14 launched {trained} times, expected "
           f"{levels * (steps + 1)}")
    still = [n for (n, p), q in zip(model.named_parameters(), before) if torch.equal(p, q)]
    _check(not still, f"fused flagship parameters unchanged after {steps} steps: {still}")
    del before

    engine = ServingEngine(copy.deepcopy(model), None, (cfg.img_size, cfg.img_size, 3),
                           batch_sizes=FA_BATCH_SIZES, dtype=torch.bfloat16, device=DEVICE)
    unfused = build_model(preset_config("flagship", dtype="bfloat16"))
    unfused.load_state_dict(model.state_dict())
    plain_engine = ServingEngine(unfused, None, (cfg.img_size, cfg.img_size, 3),
                                 batch_sizes=FA_BATCH_SIZES, dtype=torch.bfloat16,
                                 device=DEVICE)
    rng = np.random.default_rng(8)
    requests = [rng.standard_normal((k, cfg.img_size, cfg.img_size, 3), dtype=np.float32)
                for k in FA_REQUESTS]
    gp.gather_project.launches = 0
    outs = [engine.predict(r) for r in requests]
    served = gp.gather_project.launches
    forwards = sum(-(-k // FA_BATCH_SIZES[-1]) for k in FA_REQUESTS)
    for k, out in zip(FA_REQUESTS, outs):
        _check(out.shape == (k, cfg.num_classes) and bool(np.isfinite(out).all()),
               f"fused flagship: bad served logits for {k} images")
    _check(served == levels * forwards, f"#14 launched {served} times over {forwards} "
           f"served forwards of {levels} levels")
    want = np.concatenate([plain_engine.predict(r) for r in requests])
    outs = np.concatenate(outs)
    err, scale = float(np.abs(outs - want).max()), float(np.abs(want).max())
    print(f"fused flagship served {FA_REQUESTS} images, logits finite; #14 launched "
          f"{served} times over {forwards} forwards; against the unfused flagship at the "
          f"same weights: max abs err {err:.4g} (max |logit| {scale:.4g}; tolerance "
          f"{FA_LOGIT_TOL} x max |logit| = {FA_LOGIT_TOL * scale:.4g})")
    _check(err <= FA_LOGIT_TOL * scale, "fused flagship logits disagree with the unfused")
    xb = torch.from_numpy(requests[-1]).to(DEVICE, torch.bfloat16)
    bs = FA_BATCH_SIZES[-1]
    with torch.inference_mode():
        f1, u1, u2, f2 = (_ms(lambda m=m: m.model(xb), iters=10)
                          for m in (engine, plain_engine, plain_engine, engine))
    fused_ms, unfused_ms = (f1 + f2) / 2, (u1 + u2) / 2
    print(f"flagship forward at batch {bs}: fused tokenizer {fused_ms:.3f} ms = "
          f"{bs / fused_ms * 1e3:.1f} img/s, unfused {unfused_ms:.3f} ms = "
          f"{bs / unfused_ms * 1e3:.1f} img/s, {card}")
    return {"gather_project": trained + served}


#: The post-norm tail's shapes: the flagship at MLP 1,024 (one layer at
#: batch 512: x, attn [512, 64, 768], F = 1,024), hier's levels ([512, 64,
#: 256]) and a ragged 1,000 rows.  #15's outputs are held within
#: TAIL_TOL of their largest |value|: the kernels round where the plain
#: version does, but an fp32 sum in another order flips a rounding.
TAIL_SHAPES = ((512, 64, 768, 1024), (512, 64, 256, 1024), (10, 100, 768, 1024))
TAIL_TOL = 1e-2
TAIL_NAMES = ("ds", "dln1_s", "dln1_b", "dw1", "db1", "dw2", "db2", "dln2_s", "dln2_b")


def _tail_args(gen, b, n, d, f):
    """x, attn, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b as the encoder
    layer passes them (bf16; the LayerNorm parameters fp32)."""
    ln = lambda shift: _randn(gen, d, scale=0.1, shift=shift,  # noqa: E731
                              dtype=torch.float32)
    return (_randn(gen, b, n, d), _randn(gen, b, n, d), ln(1.0), ln(0.0),
            _randn(gen, d, f, scale=d ** -0.5), _randn(gen, f, scale=0.1),
            _randn(gen, f, d, scale=f ** -0.5), _randn(gen, d, scale=0.1), ln(1.0), ln(0.0))


def _tail_split(card: str, b: int, n: int, d: int, f: int) -> None:
    """#15's serving form launch by launch (CUDA events, each launch alone
    on the same inputs): before (LN1 with the fp32 x2f, fc1, fc2 into the
    fp32 s2, LN2 over it) and after (LN1 with each row's mean and rsqrt,
    fc1, fc2 + LN2 in one cluster launch that rebuilds x2f), each launch's
    bytes and bound beside it (a LayerNorm's few operations an element
    counted as none; a product's 2 R D F)."""
    gen = torch.Generator().manual_seed(10)
    x, attn, l1s, l1b, w1, b1, w2, b2, l2s, l2b = _tail_args(gen, b, n, d, f)
    r = b * n
    mm = 2 * r * d * f  # one product's operations
    x2d, a2d = x.view(r, d), attn.view(r, d)
    b1f, b2f = b1.float(), b2.float()
    x2, x2f = _build.ln_rows(x2d, l1s, l1b, 1e-5, x_b=a2d, with_f32=True)
    stats = _build.ln_rows(x2d, l1s, l1b, 1e-5, x_b=a2d, with_stats=True)[1]
    hh = _build.gemm(x2, w1, bias=b1f, act="relu")
    s2 = _build.gemm(hh, w2, bias=b2f, residual_f32=x2f, out_dtype=torch.float32)
    launches = [
        ("LN1 (ln_rows: x + attn -> x2, fp32 x2f)", "before",
         lambda: _build.ln_rows(x2d, l1s, l1b, 1e-5, x_b=a2d, with_f32=True), r * d * (4 + 2 + 4),
         0),
        ("LN1 (ln_rows: x + attn -> x2, row mean and rsqrt)", "after",
         lambda: _build.ln_rows(x2d, l1s, l1b, 1e-5, x_b=a2d, with_stats=True),
         r * d * (4 + 2) + 8 * r, 0),
        ("fc1 + b1, relu (gemm)", "both", lambda: _build.gemm(x2, w1, bias=b1f, act="relu"),
         2 * (r * d + d * f + r * f), mm),
        ("fc2 + b2 + x2f -> fp32 s2 (gemm)", "before",
         lambda: _build.gemm(hh, w2, bias=b2f, residual_f32=x2f, out_dtype=torch.float32),
         2 * (r * f + f * d) + 4 * r * d * 2, mm),
        ("LN2 over the fp32 s2 (ln_rows)", "before",
         lambda: _build.ln_rows(s2, l2s, l2b, 1e-5), r * d * (4 + 2), 0),
        ("fc2 + b2 + x2f rebuilt from x, attn and LN1's stats, LN2 (gemm_layernorm, "
         "clusters)", "after",
         lambda: _build.gemm_layernorm(hh, w2, b2f, x2d, a2d, stats, l1s, l1b, l2s, l2b, 1e-5),
         2 * (r * f + f * d) + 2 * 2 * r * d + 8 * r + 2 * r * d, mm),
    ]
    total = {"before": 0.0, "after": 0.0}
    bounds = {"before": 0.0, "after": 0.0}
    print(f"#15's launches at x, attn [{b}, {n}, {d}], F={f} (serving form), device ms "
          f"each (CUDA events), {card}:")
    for label, side, fn, nbytes, flops in launches:
        ms = _ms(fn)
        bound = _bound(flops, nbytes)
        for key in ("before", "after"):
            if side in (key, "both"):
                total[key] += ms
                bounds[key] += bound["bound_ms"]
        print(f"  [{side}] {label}: {ms:.4f} ms, {nbytes / 1e6:.1f} MB "
              f"({nbytes / ms / 1e6:.0f} GB/s), bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']})")
    print(f"  sum of the launches: before {total['before']:.4f} ms, after "
          f"{total['after']:.4f} ms; sum of their bounds: before {bounds['before']:.4f} ms, "
          f"after {bounds['after']:.4f} ms; {_build.gemm_layernorm_max_clusters(d)} clusters of "
          f"{d // 128} blocks fit the card at once, for {r // 128} row stripes")
    del x, attn, x2, x2f, stats, hh, s2


def _tail_bwd_split(card: str, b: int, n: int, d: int, f: int) -> None:
    """#16's launches one by one (CUDA events, each alone on the inputs
    ``postnorm_tail_bwd`` gives it) at x, attn [b, n, d], F = f, each with
    its bytes, operations and bound, and their sum."""
    gen = torch.Generator().manual_seed(13)
    x, attn, l1s, l1b, w1, b1, w2, b2, l2s, l2b = _tail_args(gen, b, n, d, f)
    r = b * n
    x2d, a2d = x.view(r, d), attn.view(r, d)
    g = _randn(gen, r, d)
    with torch.no_grad():
        _, z, s2 = postnorm_tail_train_fwd(x, attn, l1s, l1b, w1, b1, w2, b2, l2s, l2b)
    z2, s2d = z.reshape(r, f), s2.reshape(r, d)

    def ln2():
        return _build.ln_rows_bwd(s2d, g, l2s, None, 1e-5, add_g=False, dx_f32=True,
                                  dx_sum=True)
    ds2, _, _, ds2f, _ = ln2()
    h = _build.act_bf16(z2, "relu")
    dz, _ = _build.gemm(ds2, w2, trans_b=True, act="relu", z_in=z2, colsum=True)
    x2 = _build.ln_rows(x2d, l1s, l1b, 1e-5, x_b=a2d)
    dx2 = _build.gemm(dz, w1, trans_b=True, residual_f32=ds2f, out_dtype=torch.float32)
    mm = 2 * r * d * f
    # (label, launch, operations, bytes)
    launches = [
        ("LN2 backward (ln_rows_bwd form (b): ds2, fp32 ds2, db2, dLN2)", ln2, 15 * r * d,
         10 * r * d),
        ("act_bf16: h = relu(z)", lambda: _build.act_bf16(z2, "relu"), r * f, 4 * r * f),
        ("dW2 = h^T ds2 (gemm TN)", lambda: _build.gemm(h, ds2, trans_a=True), mm,
         2 * (r * f + r * d + f * d)),
        ("dz = ds2 W2^T * relu'(z), db1 (gemm NT)",
         lambda: _build.gemm(ds2, w2, trans_b=True, act="relu", z_in=z2, colsum=True), mm,
         2 * (r * d + f * d + 2 * r * f) + 4 * f),
        ("x2 = LN1(x + attn) recomputed (ln_rows)",
         lambda: _build.ln_rows(x2d, l1s, l1b, 1e-5, x_b=a2d), 8 * r * d, 6 * r * d),
        ("dW1 = x2^T dz (gemm TN)", lambda: _build.gemm(x2, dz, trans_a=True), mm,
         2 * (r * d + r * f + d * f)),
        ("dx2 = dz W1^T + fp32 ds2 (gemm NT)",
         lambda: _build.gemm(dz, w1, trans_b=True, residual_f32=ds2f, out_dtype=torch.float32),
         mm, 2 * (r * f + f * d) + 8 * r * d),
        ("LN1 backward (ln_rows_bwd form (c): ds, dLN1)",
         lambda: _build.ln_rows_bwd(x2d, dx2, l1s, None, 1e-5, add_g=False, x_b=a2d),
         15 * r * d, 10 * r * d),
    ]
    print(f"#16's launches at x, attn [{b}, {n}, {d}], F={f}, device ms each (CUDA events), "
          f"{card}:")
    total = total_bound = 0.0
    for label, fn, flops, nbytes in launches:
        ms = _ms(fn)
        bound = _bound(flops, nbytes)
        total += ms
        total_bound += bound["bound_ms"]
        print(f"  {label}: {ms:.4f} ms, {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    print(f"  sum of the launches: {total:.4f} ms (their bounds' sum {total_bound:.4f} ms)")
    del x, attn, g, z, s2, ds2, ds2f, h, dz, x2, dx2


def phase_tail_kernels(card: str) -> dict:
    """Kernels #15 (both forms) and #16 against their plain versions at
    TAIL_SHAPES; the first two timed beside their bounds.  The kernels
    line carries the flagship's shape (D = 768) and the largest error of
    every shape."""
    gen = torch.Generator().manual_seed(9)
    res, errs, bwd_errs = {}, [], []
    for b, n, d, f in TAIL_SHAPES[:2]:
        _check(tail_fc2_route(d) == "cluster", f"#15 at D={d} is not one cluster launch")
        _tail_split(card, b, n, d, f)
        _tail_bwd_split(card, b, n, d, f)
    for b, n, d, f in TAIL_SHAPES:
        args = _tail_args(gen, b, n, d, f)
        g = _randn(gen, b, n, d)
        with torch.no_grad():
            out = fused_postnorm_tail(*args)
            got = postnorm_tail_train_fwd(*args)
            want = postnorm_tail_kernel_ref(*args, save_acts=True)
            print(f"#15 vs postnorm_tail_kernel_ref, x, attn [{b}, {n}, {d}], F={f}:")
            _check(torch.equal(out, got[0]), "#15: the serving and training forms differ")
            errs += [_frac_err(name, x, w, TAIL_TOL)
                     for name, x, w in zip(("out", "z", "s2"), got, want)]
            del out, want
            _, z, s2 = got
            saved = (args[0], args[1], g, z, s2, *args[2:7], args[8], args[9])
            print(f"#16 vs postnorm_tail_bwd_ref, x, attn [{b}, {n}, {d}], F={f}:")
            bwd_errs.append(_bwd_check(
                "postnorm_tail_bwd", postnorm_tail_bwd(*saved, b2=args[7]),
                postnorm_tail_bwd_ref(*saved, b2=args[7]), TAIL_NAMES))
        if (b, n, d, f) not in TAIL_SHAPES[:2]:  # the ragged case: checked, not timed
            continue
        r = b * n
        with torch.no_grad():
            ms, plain_ms = _ab_ms(lambda: fused_postnorm_tail(*args),
                                  lambda: postnorm_tail_kernel_ref(*args), iters=10)
            tms, tplain_ms = _ab_ms(lambda: postnorm_tail_train_fwd(*args),
                                    lambda: postnorm_tail_kernel_ref(*args, save_acts=True),
                                    iters=10)
            bms, bplain_ms = _ab_ms(lambda: postnorm_tail_bwd(*saved, b2=args[7]),
                                    lambda: postnorm_tail_bwd_ref(*saved, b2=args[7]),
                                    iters=10)
        vec = 2 * (2 * d + f) + 4 * 4 * d  # b1, b2 (bf16); the LayerNorm vectors (fp32)
        fwd = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                   **_bound(4 * r * d * f, 2 * (3 * r * d + 2 * d * f) + vec))
        train_bound = _bound(4 * r * d * f, 2 * (4 * r * d + 2 * d * f + r * f) + vec)
        # x, attn, g, s2, ds; z; w1, w2, dw1, dw2; db1, db2 (bf16); ln1_s, ln1_b,
        # ln2_s and the four LayerNorm gradients (fp32)
        bwd = dict(ms=bms, plain_ms=bplain_ms, library_ms=None,
                   **_bound(8 * r * d * f, 2 * (5 * r * d + r * f + 4 * d * f + f + d)
                            + 4 * 7 * d))
        print(f"post-norm tail at x [{b}, {n}, {d}], F={f}, bf16, {card}: #15 serving form "
              f"kernels {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {fwd['bound_ms']:.4f} ms "
              f"({fwd['bound_by']}); training form kernels {tms:.4f} ms, plain "
              f"{tplain_ms:.4f} ms, bound {train_bound['bound_ms']:.4f} ms "
              f"({train_bound['bound_by']}); #16 kernels {bms:.4f} ms, plain "
              f"{bplain_ms:.4f} ms, bound {bwd['bound_ms']:.4f} ms ({bwd['bound_by']}).  "
              "No single PyTorch call does LN + MLP + two residuals + LN.")
        if d == 768:
            res["postnorm_tail"], res["postnorm_tail_bwd"] = fwd, bwd
        del args, g, got, z, s2, saved
    res["postnorm_tail"]["max_abs_err"] = max(errs)
    res["postnorm_tail_bwd"]["max_abs_err"] = max(bwd_errs)
    res.update(_tail_f32_cases(card))
    return res


def _tail_f32_cases(card: str) -> dict:
    """#15 (both forms) and #16 in fp32 (the flagship's and 'hier''s own
    dtype: ``ln_rows`` over the fp32 x + attn and over s2, ``gemm_f32``,
    ``act_f32``, ``ln_rows_bwd`` forms (d) and (e)) against their plain
    versions at TAIL_SHAPES, every tensor within F32_TOL of its largest
    |value|, #16 bit for bit on a second call; the first two shapes timed in
    turns with the plain versions beside the fp32 bound (the products, 4 and
    8 x R·D·F, at 3xTF32's 165 TFLOP/s; the bytes at 3.35 TB/s)."""
    gen = torch.Generator().manual_seed(19)
    res, errs, bwd_errs = {}, [], []
    for b, n, d, f in TAIL_SHAPES:
        args = tuple(t.float() for t in _tail_args(gen, b, n, d, f))
        g = _randn(gen, b, n, d, dtype=torch.float32)
        with torch.no_grad():
            out = fused_postnorm_tail(*args)
            got = postnorm_tail_train_fwd(*args)
            want = postnorm_tail_kernel_ref(*args, save_acts=True)
            print(f"#15 fp32 vs postnorm_tail_kernel_ref, x, attn [{b}, {n}, {d}], F={f}:")
            _check(torch.equal(out, got[0]), "#15 fp32: the serving and training forms differ")
            errs += [_frac_err(name, x, w, F32_TOL)
                     for name, x, w in zip(("out", "z", "s2"), got, want)]
            del out, want
            _, z, s2 = got
            saved = (args[0], args[1], g, z, s2, *args[2:7], args[8], args[9])
            print(f"#16 fp32 vs postnorm_tail_bwd_ref, x, attn [{b}, {n}, {d}], F={f}:")
            grads = postnorm_tail_bwd(*saved, b2=args[7])
            bwd_errs += [_frac_err(name, x, w, F32_TOL) for name, x, w in zip(
                TAIL_NAMES, grads, postnorm_tail_bwd_ref(*saved, b2=args[7]))]
            _check(all(torch.equal(u, v) for u, v in zip(
                grads, postnorm_tail_bwd(*saved, b2=args[7]))), "#16 fp32: a second call differs")
            del grads
        if (b, n, d, f) not in TAIL_SHAPES[:2]:  # the ragged case: checked, not timed
            continue
        r = b * n
        with torch.no_grad():
            ms, plain_ms = _ab_ms(lambda: fused_postnorm_tail(*args),
                                  lambda: postnorm_tail_kernel_ref(*args), iters=10)
            tms, tplain_ms = _ab_ms(lambda: postnorm_tail_train_fwd(*args),
                                    lambda: postnorm_tail_kernel_ref(*args, save_acts=True),
                                    iters=10)
            bms, bplain_ms = _ab_ms(lambda: postnorm_tail_bwd(*saved, b2=args[7]),
                                    lambda: postnorm_tail_bwd_ref(*saved, b2=args[7]),
                                    iters=10)
        vec = 4 * (f + 5 * d)  # b1, b2 and the four LayerNorm vectors
        fwd = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                   **_bound_f32(0, 4 * (3 * r * d + 2 * d * f) + vec, 4 * r * d * f))
        train_bound = _bound_f32(0, 4 * (4 * r * d + 2 * d * f + r * f) + vec, 4 * r * d * f)
        # x, attn, g, s2, ds; z; w1, w2, dw1, dw2; db1, db2, ln1_s, ln1_b,
        # ln2_s and the four LayerNorm gradients
        bwd = dict(ms=bms, plain_ms=bplain_ms, library_ms=None,
                   **_bound_f32(0, 4 * (5 * r * d + r * f + 4 * d * f + f + 8 * d),
                                8 * r * d * f))
        print(f"post-norm tail at x [{b}, {n}, {d}], F={f}, fp32, {card}: #15 serving form "
              f"kernels {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {fwd['bound_ms']:.4f} ms "
              f"({fwd['bound_by']}); training form kernels {tms:.4f} ms, plain "
              f"{tplain_ms:.4f} ms, bound {train_bound['bound_ms']:.4f} ms "
              f"({train_bound['bound_by']}); #16 kernels {bms:.4f} ms, plain "
              f"{bplain_ms:.4f} ms, bound {bwd['bound_ms']:.4f} ms ({bwd['bound_by']}).  "
              "No single PyTorch call does LN + MLP + two residuals + LN.")
        if d == 768:
            res["postnorm_tail_f32"], res["postnorm_tail_bwd_f32"] = fwd, bwd
        del args, g, got, z, s2, saved
    res["postnorm_tail_f32"]["max_abs_err"] = max(errs)
    res["postnorm_tail_bwd_f32"]["max_abs_err"] = max(bwd_errs)
    return res


def _plain_tail():
    """Route family A through the plain versions of every kernel on its
    path (comparison only): #5-#7 as :func:`_plain_fa`, the tail #15/#16
    through ``postnorm_tail_kernel_ref`` under autograd."""
    stack = _plain_fa()
    stack.enter_context(mock.patch.object(fa_layers, "fused_postnorm_tail",
                                          postnorm_tail_kernel_ref))
    return stack


#: Family A's counters, bf16 and fp32: (name, wrapper, attribute).
_TAIL_COUNTS = tuple(
    (f"{name}{sfx}{form}", fn, f"{pre}{attr}")
    for sfx, pre in (("", ""), ("_f32", "f32_"))
    for name, form, fn, attr in (
        ("postnorm_tail", "", fused_postnorm_tail, "launches"),
        ("postnorm_tail", " (training form)", fused_postnorm_tail, "train_launches"),
        ("postnorm_tail_bwd", "", fused_postnorm_tail, "bwd_launches"),
        ("fused_torch_mha", "", fused_torch_mha, "launches"),
        ("fused_torch_mha_bwd", "", fused_torch_mha, "bwd_launches"),
        ("packed_flash_attention", "", packed_flash_attention, "launches")))


def _tail_counts() -> dict:
    return {name: getattr(fn, attr) for name, fn, attr in _TAIL_COUNTS}


def _reset_tail_counts():
    for _, fn, attr in _TAIL_COUNTS:
        setattr(fn, attr, 0)


def _family_a_tail_model(card: str, label: str, model, cfg, layers: int,
                         dropout: bool, f32: bool = False) -> dict:
    """Train (4 steps at batch 512), evaluate and serve one family-A model
    whose layers take the post-norm tail, in bf16 or (``f32``) at its own
    fp32; returns the launch counts of its main path.  With dropout the
    layers train through #5/#6 and the unfused tail, without through the
    packed formula and #15/#16; eval and serving run #7 and #15's serving
    form in every layer.  Every counter of the other dtype must stay 0."""
    sfx = "_f32" if f32 else ""
    grad_tol, logit_tol = (F32_GRAD_REL_TOL, F32_TOL) if f32 else (GRAD_REL_TOL, FA_LOGIT_TOL)
    torch.cuda.reset_peak_memory_stats()
    stats = ((0.5,) * 3, (0.25,) * 3)
    b, steps = FA_B, FA_TRAIN_STEPS
    train_ds = synthetic_dataset(n=b * steps, hw=cfg.img_size,
                                 num_classes=cfg.num_classes, seed=0)
    test_ds = synthetic_dataset(n=b, hw=cfg.img_size, num_classes=cfg.num_classes, seed=1)
    tf = make_eval_transform(*stats, device=DEVICE)
    trainer = Trainer(model, TrainConfig(num_classes=cfg.num_classes, epochs=1,
                                         warmup_epochs=1), steps_per_epoch=steps)
    before = [p.detach().clone() for p in model.parameters()]
    _reset_tail_counts()
    record = trainer.fit(
        lambda: ((tf(x), y) for x, y in epoch_batches(train_ds, b, seed=0)),
        lambda: ((tf(x), y) for x, y in epoch_batches(
            test_ds, b, shuffle=False, drop_last=False)))
    torch.cuda.synchronize()
    counts = _tail_counts()
    print(f"{label}: Trainer.fit, 1 epoch of {steps} steps at batch {b} + eval of "
          f"{len(test_ds)}: {record}")
    print(f"{label}: launches over {steps} train steps + 1 eval batch of {layers} layers: "
          f"{counts}")
    _check(bool(np.isfinite(record["train_loss"])), f"{label}: non-finite train loss")
    _check(bool(np.isfinite(record["test_loss"])), f"{label}: non-finite eval loss")
    _check(trainer.state.step == steps, f"{label}: {trainer.state.step} steps taken")
    trained = layers * steps
    want = {name: 0 for name in counts}
    want.update({f"postnorm_tail{sfx}": layers, f"packed_flash_attention{sfx}": layers,
                 f"postnorm_tail{sfx} (training form)": 0 if dropout else trained,
                 f"postnorm_tail_bwd{sfx}": 0 if dropout else trained,
                 f"fused_torch_mha{sfx}": trained if dropout else 0,
                 f"fused_torch_mha_bwd{sfx}": trained if dropout else 0})
    _check(counts == want, f"{label}: launches {counts}, expected {want}")
    still = [nm for (nm, p), q in zip(model.named_parameters(), before) if torch.equal(p, q)]
    _check(not still, f"{label}: parameters unchanged after {steps} steps: {still}")
    del before

    # One step from the same parameters, batch and draws, kernels against plain.
    x, y = next(epoch_batches(train_ds, b, seed=0))
    batch = (tf(x), torch.from_numpy(y).long().to(DEVICE))
    state = _lr_zero_state(model)
    step = make_train_step(cfg.num_classes)

    def one_step():
        return step(state, batch, torch.Generator().manual_seed(7),
                    torch.Generator(device=DEVICE).manual_seed(7))

    m_k = one_step()
    grads = {nm: p.grad.detach().clone() for nm, p in model.named_parameters()}
    with _plain_tail():
        m_p = one_step()
    rel = {nm: float((grads[nm].float() - p.grad.float()).norm() / p.grad.float().norm())
           for nm, p in model.named_parameters()}
    worst = max(rel, key=rel.get)
    print(f"{label}: one train step (mixing{', dropout' if dropout else ''}), kernels vs "
          f"plain versions: loss {float(m_k['loss']):.6f} vs {float(m_p['loss']):.6f}; "
          f"gradient relative L2 error max {rel[worst]:.4g} ({worst}), median "
          f"{float(np.median(list(rel.values()))):.4g} over {len(rel)} tensors "
          f"(tolerance {grad_tol})")
    _check(rel[worst] <= grad_tol, f"{label}: kernel-path gradients disagree with "
           "the plain path")
    del grads

    gen, dgen = torch.Generator().manual_seed(0), torch.Generator(device=DEVICE)

    def step_ms(plain: bool, n_steps: int = 3) -> float:
        with _plain_tail() if plain else contextlib.nullcontext():
            step(state, batch, gen, dgen)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_steps):
                step(state, batch, gen, dgen)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n_steps * 1e3

    p1, k1, k2, p2 = (step_ms(plain) for plain in (True, False, False, True))
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"{label}: train step at batch {b} (mixing, clip, AdamW): kernels {k_ms:.2f} ms "
          f"= {b / k_ms * 1e3:.1f} img/s, plain versions {p_ms:.2f} ms = "
          f"{b / p_ms * 1e3:.1f} img/s, {card}")
    print(f"{label}: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _profile(lambda: step(state, batch, gen, dgen), f"{label} train step at batch {b}")
    del state, batch

    engine = ServingEngine(copy.deepcopy(model), None, (cfg.img_size, cfg.img_size, 3),
                           batch_sizes=FA_BATCH_SIZES, dtype=None if f32 else torch.bfloat16,
                           device=DEVICE)
    rng = np.random.default_rng(10)
    requests = [rng.standard_normal((k, cfg.img_size, cfg.img_size, 3), dtype=np.float32)
                for k in FA_REQUESTS]
    _reset_tail_counts()
    outs = [engine.predict(r) for r in requests]
    served = _tail_counts()
    forwards = sum(-(-k // FA_BATCH_SIZES[-1]) for k in FA_REQUESTS)
    for k, out in zip(FA_REQUESTS, outs):
        _check(out.shape == (k, cfg.num_classes) and bool(np.isfinite(out).all()),
               f"{label}: bad served logits for {k} images")
    want = {name: layers * forwards if name in (f"postnorm_tail{sfx}",
                                                f"packed_flash_attention{sfx}")
            else 0 for name in served}
    _check(served == want, f"{label}: served launches {served}, expected {want}")
    with _plain_tail():
        plain = np.concatenate([engine.predict(r) for r in requests])
    outs = np.concatenate(outs)
    err, scale = float(np.abs(outs - plain).max()), float(np.abs(plain).max())
    print(f"{label}: served {FA_REQUESTS} images, logits finite; #15 and #7 launched "
          f"{served[f'postnorm_tail{sfx}']} times each over {forwards} forwards of {layers} "
          f"layers; kernels vs plain versions max abs err {err:.4g} (max |logit| "
          f"{scale:.4g}; tolerance {logit_tol} x max |logit| = {logit_tol * scale:.4g})")
    _check(err <= logit_tol * scale, f"{label}: served logits disagree with the plain "
           "forward")
    xb = torch.from_numpy(requests[-1]).to(DEVICE, torch.float32 if f32 else torch.bfloat16)
    bs = FA_BATCH_SIZES[-1]

    def fwd_ms(plain: bool) -> float:
        with _plain_tail() if plain else contextlib.nullcontext():
            return _ms(lambda: engine.model(xb), iters=10)

    with torch.inference_mode():
        f1, q1, q2, f2 = (fwd_ms(plain) for plain in (False, True, True, False))
    fwd_ms, plain_fwd_ms = (f1 + f2) / 2, (q1 + q2) / 2
    print(f"{label}: forward at batch {bs}: {fwd_ms:.3f} ms = {bs / fwd_ms * 1e3:.1f} img/s "
          f"(plain versions {plain_fwd_ms:.3f} ms = {bs / plain_fwd_ms * 1e3:.1f} img/s), "
          f"{card}")
    return {name: counts[name] + served[name] + (
                counts[f"{name} (training form)"] if name == f"postnorm_tail{sfx}" else 0)
            for name in (f"postnorm_tail{sfx}", f"postnorm_tail_bwd{sfx}",
                         f"fused_torch_mha{sfx}", f"fused_torch_mha_bwd{sfx}",
                         f"packed_flash_attention{sfx}")}


def _flagship_at_mlp_1024(cfg):
    """``VisionTransformer1D`` from ``cfg``'s fields with dropout 0 (the
    registry has no dropout field), random weights from seed 0."""
    gen = torch.Generator().manual_seed(0)
    return VisionTransformer1D(
        build_tokenizer(cfg, generator=gen), depth=cfg.depth, n_heads=cfg.n_heads,
        mlp_dim=cfg.mlp_dim, num_classes=cfg.num_classes, dropout_rate=0.0,
        dtype=cfg.torch_dtype(), device=DEVICE, generator=gen)


def phase_tail_models(card: str, f32: bool = False) -> dict:
    """(b) the flagship at MLP 1,024 with dropout 0 and (c) 'hier' at MLP
    1,024, each trained, evaluated and served through the post-norm tail:
    in bf16, or (``f32``) at the presets' own dtype, float32 (no dtype
    named): #15/#16 and #5-#7 in fp32."""
    dt = {} if f32 else dict(dtype="bfloat16")
    tag = " fp32" if f32 else ""
    cfg = preset_config("flagship", mlp_dim=1024, **dt)
    flagship = _flagship_at_mlp_1024(cfg)
    a = _family_a_tail_model(card, f"flagship at MLP 1024{tag}, dropout 0", flagship, cfg,
                             cfg.depth, dropout=False, f32=f32)
    del flagship
    hcfg = preset_config("flagship", model="hier", mlp_dim=1024, **dt)
    hier = build_model(hcfg, generator=torch.Generator().manual_seed(0))
    h = _family_a_tail_model(card, f"hier at MLP 1024{tag}", hier, hcfg,
                             len(hcfg.patch_size_list) * hcfg.depth + 2, dropout=True, f32=f32)
    del hier
    torch.cuda.empty_cache()
    return {name: a[name] + h[name] for name in a}


#: The remat phase: ('hier' at MLP 1,024 in fp32 with dropout, batch 512;
#: ViT-B/16 in bf16, batch 256).
REMAT_STEPS = 2


def _remat_run(card: str, label: str, build, batch: int, img: int, classes: int,
               counters) -> None:
    """Two train steps (mixing, dropout where the model has it, clip,
    AdamW) of ``build(remat)`` without and with remat, from the same seeds
    and batch: the loss and every gradient of each step equal bit for bit,
    the dropout generator in the same state after them, the backward
    counters equal and the forward counters of the checkpointed layers
    doubled.  Prints each run's peak device memory and its second step's
    time.  ``counters``: (name, wrapper, attribute, the forward launches
    the checkpointed layers add, or None for a backward counter) of the
    path's kernels."""
    ds = synthetic_dataset(n=batch, hw=img, num_classes=classes, seed=0)
    x, y = next(epoch_batches(ds, batch, seed=0))
    tf = make_eval_transform((0.5,) * 3, (0.25,) * 3, device=DEVICE)
    batch_t = (tf(x), torch.from_numpy(y).long().to(DEVICE))
    runs = {}
    for remat in (False, True):
        model = build(remat)
        state = TrainState(model, make_optimizer(model.parameters(), lambda _: 1e-3,
                                                 grad_clip=1.0))
        step = make_train_step(classes)
        gen, dgen = torch.Generator().manual_seed(3), torch.Generator(device=DEVICE).manual_seed(4)
        for _, fn, attr, _ in counters:
            setattr(fn, attr, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = []
        for _ in range(REMAT_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = step(state, batch_t, gen, dgen)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            out.append((m["loss"], [p.grad.detach().clone() for p in model.parameters()]))
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts = {name: getattr(fn, attr) for name, fn, attr, _ in counters}
        print(f"remat {label}, remat={remat}: {REMAT_STEPS} steps at batch {batch}, peak "
              f"device memory {peak:.2f} GiB, second step {ms:.1f} ms (host clock), losses "
              f"{[round(float(lo), 6) for lo, _ in out]}, launches {counts}, {card}")
        runs[remat] = (out, dgen.get_state(), counts, peak, ms)
        del model, state, out
        torch.cuda.empty_cache()
    (plain, p_state, p_counts, p_peak, p_ms), (remat, r_state, r_counts, r_peak, r_ms) = (
        runs[False], runs[True])
    differ = sum(int(not torch.equal(a, b)) for (_, gp), (_, gr) in zip(plain, remat)
                 for a, b in zip(gp, gr))
    _check(all(torch.equal(lp, lr) for (lp, _), (lr, _) in zip(plain, remat)),
           f"remat {label}: the losses differ")
    _check(differ == 0, f"remat {label}: {differ} gradients differ from the plain steps'")
    _check(torch.equal(p_state, r_state), f"remat {label}: the dropout generator moved "
           "differently")
    for name, _, _, forward in counters:
        want = p_counts[name] + forward if forward is not None else p_counts[name]
        _check(r_counts[name] == want, f"remat {label}: {name} launched {r_counts[name]} "
               f"times, expected {want}")
    print(f"remat {label}: every gradient of {REMAT_STEPS} steps equal bit for bit "
          f"({len(plain[0][1])} tensors a step), the forward counters of the checkpointed "
          f"layers doubled; peak {p_peak:.2f} -> {r_peak:.2f} GiB, second step {p_ms:.1f} -> "
          f"{r_ms:.1f} ms, {card}")


def phase_remat(card: str) -> None:
    """``remat=True`` against ``remat=False`` on the card: 'hier' at MLP
    1,024 at its own fp32 with dropout (its 24 level layers checkpointed,
    the 2 fusion layers not, as in JAX: #5/#6 fp32, the unfused tail) at
    batch 512, and ViT-B/16 in bf16 (every attention and MLP block
    checkpointed: #1-#4) at batch 256."""
    hcfg = preset_config("flagship", model="hier", mlp_dim=1024)
    ckpt = len(hcfg.patch_size_list) * hcfg.depth * REMAT_STEPS
    m = fused_torch_mha
    _remat_run(
        card, "hier at MLP 1024 fp32, dropout",
        lambda remat: build_model(dataclasses.replace(hcfg, remat=remat),
                                  generator=torch.Generator().manual_seed(0)),
        FA_B, hcfg.img_size, hcfg.num_classes,
        (("fused_torch_mha_f32", m, "f32_launches", ckpt),
         ("fused_torch_mha_bwd_f32", m, "f32_bwd_launches", None),
         ("fused_torch_mha", m, "launches", 0), ("fused_torch_mha_bwd", m, "bwd_launches", 0)))
    vcfg = preset_config("vit-b-16", curve="hilbert", num_classes=1000, dtype="bfloat16")
    ckpt = vcfg.depth * REMAT_STEPS
    a, f = fused_attention_block, fused_mlp_block
    _remat_run(
        card, "ViT-B/16 bf16",
        lambda remat: build_model(dataclasses.replace(vcfg, remat=remat),
                                  generator=torch.Generator().manual_seed(0)),
        TRAIN_B, vcfg.img_size, vcfg.num_classes,
        (("fused_attention_block", a, "launches", ckpt),
         ("fused_mlp_block", f, "launches", ckpt),
         ("fused_attention_block_bwd", a, "bwd_launches", None),
         ("fused_mlp_block_bwd", f, "bwd_launches", None)))


#: The reference notebook's model in fp32 (``preset_config("notebook")``,
#: ``notebooks/hilbert.ipynb``'s batch 32): 64 tokens of D 256, 4 heads of
#: 64, MLP 256; and the flagship's own fp32 layer (dtype=None) at batch
#: 512: 64 tokens of D 768, 4 heads of 192.
NB_B, NB_N, NB_D, NB_HEADS = 32, 64, 256, 4
NB_STEPS = 4
NB_REQUESTS, NB_BATCH_SIZES = (1, 20, 32), (8, 32)
F32_SHAPES = ((NB_B, NB_N, NB_D, NB_HEADS), (FA_B, FA_N, FA_D, FA_HEADS))
#: Each fp32 kernel against its plain version: the same fp32 arithmetic
#: summed in another order (torch.matmul in full fp32: phase_device clears
#: the TF32 flags, and a float32 matmul does not use TF32 by default);
#: every error within this fraction of its tensor's largest |value|.
F32_TOL = 1e-4
#: One fp32 train step's gradients, kernels against plain versions: at
#: 2,048 rows one ReLU input within rounding of 0 flips between two fp32
#: summation orders and moves linear1's bias gradient by ~0.5 % (measured
#: on the CPU, tests/test_torch_notebook_model.py's KINK_GRAD).
F32_GRAD_REL_TOL = 1e-2
#: The H100 SXM's fp32 rate outside the tensor cores and its dense TF32
#: rate on them (NVIDIA's data sheet): the operations' denominators of the
#: fp32 kernels' bounds.  csrc/gemm_f32.cu runs each fp32 product as three
#: TF32 products (3xTF32), so its products are bounded at 495 / 3 = 165
#: TFLOP/s; the fp32 SIMT kernels (attention, #14) at 67.
PEAK_F32_FLOPS, PEAK_TF32_FLOPS = 67e12, 495e12
F32_SPLIT_PASSES = 3


def _graph_turns(kernel, plain, iters: int = 20):
    """:func:`_ab_ms` by graph replay (:func:`_graph_ms`), for calls shorter
    than the Python launch path."""
    p1, k1, k2, p2 = (_graph_ms(f, iters) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def _bound_f32(flops: float, nbytes: float, gemm_flops: float = 0.0) -> dict:
    """:func:`_bound` for the fp32 kernels: ``gemm_flops`` (the fp32
    products of ``csrc/gemm_f32.cu``) as three TF32 products each at the
    TF32 rate, the other ``flops`` at the fp32 FFMA rate, their times
    added; ``bound_ffma_ms`` holds every operation at the FFMA rate."""
    t_ops = (flops / PEAK_F32_FLOPS + F32_SPLIT_PASSES * gemm_flops / PEAK_TF32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_ffma_ms=max((flops + gemm_flops) / PEAK_F32_FLOPS * 1e3, t_bytes))


def _f32_row(name: str, shape: str, t: dict, card: str, library: str = "") -> None:
    """One fp32 row: the kernel, its plain version, both bounds, the library
    call (TF32 off) and, where the row has it, the forward output's max abs
    error against fp64 (``err64``)."""
    print(f"{name}, {shape}, fp32: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
          f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}; every operation at fp32 FFMA's "
          f"67 TFLOP/s: {t['bound_ffma_ms']:.4f} ms)"
          + (f", {library} {t['library_ms']:.4f} ms" if library else "")
          + (f", max abs err against fp64 {t['err64']:.3g}" if "err64" in t else "")
          + f", {card}")


def _attention_fp64_err(got, qkv, heads: int, n_valid: int, scale: float, mask=None,
                        keep: float = 1.0) -> float:
    """Max abs error of an attention output ``got`` [B, N, H*Dh] against
    the same attention in fp64 (keys at or past ``n_valid`` excluded, P
    normalised, then (P / keep) * mask), a few images at a time."""
    b, n, w = qkv.shape
    dh = w // (3 * heads)
    err, step = 0.0, max(1, 2 ** 27 // (heads * n * n))
    for i in range(0, b, step):
        q, k, v = qkv[i:i + step].double().view(-1, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
        logits = (q @ k.transpose(-1, -2)) * scale
        logits[..., n_valid:] = float("-inf")
        p = torch.softmax(logits, dim=-1)
        if mask is not None:
            p = (p / keep) * mask[i:i + step].double()
        want = (p @ v).transpose(1, 2).reshape(-1, n, heads * dh)
        err = max(err, float((got[i:i + step].double() - want).abs().max()))
    return err


def _gemm_f32_line(name: str, m: int, n: int, k: int, ms: float, lib_ms: float, nbytes: float,
                   err: float, err64: float, err64_lib: float, card: str) -> None:
    """One ``csrc/gemm_f32.cu`` form beside ``torch.matmul`` fp32 (TF32 off):
    times, TFLOP/s, both bounds (3xTF32 at 165 TFLOP/s, FFMA at 67), the
    error against the torch function (of the largest |value|) and each
    product's max abs error against fp64."""
    flops = 2 * m * n * k
    b = _bound_f32(0.0, nbytes, gemm_flops=flops)
    print(f"gemm_f32 {name} [{m} x {n}, K {k}]: kernel {ms:.4f} ms ({_tflops(flops, ms)}), "
          f"torch.matmul fp32 {lib_ms:.4f} ms ({_tflops(flops, lib_ms)}), bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}, 3xTF32 at 165 TFLOP/s; FFMA at 67: "
          f"{b['bound_ffma_ms']:.4f} ms), max abs err {err:.3g}; against fp64: kernel "
          f"{err64:.3g}, torch.matmul fp32 {err64_lib:.3g}, {card}")


def _fp64_errs(product, a, b) -> tuple:
    """Max abs error against the fp64 product ``a @ b`` (fp32 views as the
    product reads them) of ``product()`` (the kernel's product alone) and
    of ``torch.matmul`` fp32."""
    exact = a.double() @ b.double()
    err = float((product().double() - exact).abs().max())
    err_lib = float(((a @ b).double() - exact).abs().max())
    return err, err_lib


def _gemm_f32_cases(card: str, x2, w_in, b_in, g2, dqkv, w_out) -> None:
    """csrc/gemm_f32.cu alone in each form of #5's and #6's chains against
    torch.matmul (fp32), with its TFLOP/s and both bounds, and the product
    (the kernel's, and torch.matmul fp32's) against fp64."""
    cases = (("QKV NN + bias", lambda: _build.gemm_f32(x2, w_in, bias=b_in),
              lambda: torch.addmm(b_in, x2, w_in), (x2, w_in, b_in)),
             ("datt NT", lambda: _build.gemm_f32(g2, w_out, trans_b=True),
              lambda: g2 @ w_out.T, (g2, w_out)),
             ("dW_in TN", lambda: _build.gemm_f32(x2, dqkv, trans_a=True),
              lambda: x2.T @ dqkv, (x2, dqkv)),
             ("dx NT", lambda: _build.gemm_f32(dqkv, w_in, trans_b=True),
              lambda: dqkv @ w_in.T, (dqkv, w_in)))
    turns = _graph_turns if x2.shape[0] == NB_B * NB_N else _ab_ms
    views = {"QKV NN + bias": (x2, w_in), "datt NT": (g2, w_out.T), "dW_in TN": (x2.T, dqkv),
             "dx NT": (dqkv, w_in.T)}
    for name, kern, lib, operands in cases:
        got, want = kern(), lib()
        err = _frac_err(f"gemm_f32 {name}", got, want, F32_TOL)
        ms, lib_ms = turns(kern, lib, iters=10)
        a, b = views[name]
        product = kern if "bias" not in name else lambda: _build.gemm_f32(x2, w_in)
        err64, err64_lib = _fp64_errs(product, a, b)
        _gemm_f32_line(name, got.shape[0], got.shape[1], a.shape[1], ms, lib_ms,
                       4 * (got.numel() + sum(t.numel() for t in operands)), err, err64,
                       err64_lib, card)


def phase_notebook_kernels(card: str) -> dict:
    """The fp32 kernels of #5, #6, #7 and #14 against their plain versions
    at the notebook's shapes (x [32, 64, 256], 4 heads of 64, the mask at
    keep 0.9; the tokenizer over [32, 32, 32, 3] images) and at the
    flagship's fp32 shapes ([512, 64, 768], 4 heads of 192; its three
    tokenizer levels), each timed beside its bound (fp32 FFMA at 67
    TFLOP/s, 3.35 TB/s) and a library call: torch.matmul for the GEMM,
    SDPA without dropout for the attention (a yardstick only),
    ``index_select`` + ``F.linear`` for #14.  Returns the notebook shape's
    entries of the kernels line."""
    gen = torch.Generator().manual_seed(11)
    dgen = torch.Generator(device=DEVICE).manual_seed(11)
    results = {}
    for b, n, d, h in F32_SHAPES:
        shape = f"x [{b}, {n}, {d}], {h} heads of {d // h}"
        dh, r = d // h, b * n
        f32 = dict(dtype=torch.float32)
        x, g = _randn(gen, b, n, d, **f32), _randn(gen, b, n, d, **f32)
        w_in = _randn(gen, d, 3 * d, scale=d ** -0.5, **f32)
        b_in = _randn(gen, 3 * d, scale=0.1, **f32)
        w_out, b_out = _randn(gen, d, d, scale=d ** -0.5, **f32), _randn(gen, d, scale=0.1, **f32)
        mask = torch.rand((b, h, n, n), device=DEVICE, generator=dgen) < FA_KEEP
        fwd = (x, w_in, b_in, w_out, b_out, mask)
        with torch.no_grad():
            got = torch_mha_train_fwd(*fwd, h, keep=FA_KEEP)
            want = torch_mha_fwd_ref(*fwd, h, keep=FA_KEEP, save_acts=True)
            print(f"#5 fp32 (torch_mha_train_fwd vs torch_mha_fwd_ref), {shape}:")
            err5 = max(_frac_err(nm, a, w_, F32_TOL)
                       for nm, a, w_ in zip(("y", "qkv", "att", "lse"), got, want))
            _, qkv, att, lse = got
            saved = (x, g, w_in, w_out, mask, qkv, att, lse)
            g_k = torch_mha_bwd(*saved, h, keep=FA_KEEP)
            g_p = torch_mha_bwd_ref(*saved, h, keep=FA_KEEP)
            print(f"#6 fp32 (torch_mha_bwd vs torch_mha_bwd_ref), {shape}:")
            err6 = max(_frac_err(nm, a, w_, F32_TOL) for nm, a, w_ in zip(
                ("dx", "dw_in", "db_in", "dw_out", "db_out"), g_k, g_p))
            # the notebook's calls last tens of microseconds, under the Python
            # launch path: timed there by graph replay, in turns
            turns = _graph_turns if b == NB_B else _ab_ms
            ms5, plain5 = turns(lambda: torch_mha_train_fwd(*fwd, h, keep=FA_KEEP),
                                lambda: torch_mha_fwd_ref(*fwd, h, keep=FA_KEEP,
                                                          save_acts=True), iters=10)
            ms6, plain6 = turns(lambda: torch_mha_bwd(*saved, h, keep=FA_KEEP),
                                lambda: torch_mha_bwd_ref(*saved, h, keep=FA_KEEP), iters=10)
            attn_flops = 2 * b * h * n * n * dh
            t5 = dict(max_abs_err=err5, ms=ms5, plain_ms=plain5, library_ms=None,
                      **_bound_f32(0.0, 4 * (6 * r * d + 4 * d * d + 4 * d) + b * h * n * n
                                   + 4 * b * h * n, gemm_flops=8 * r * d * d + 2 * attn_flops))
            t6 = dict(max_abs_err=err6, ms=ms6, plain_ms=plain6, library_ms=None,
                      **_bound_f32(0.0, 4 * (7 * r * d + 8 * d * d + 4 * d) + b * h * n * n
                                   + 4 * b * h * n, gemm_flops=16 * r * d * d + 5 * attn_flops))
            _f32_row("#5 (gemm_f32 + packed_attn_f32 with the mask and lse + gemm_f32)",
                     shape, t5, card)
            _f32_row("#6 (colsum, gemm_f32 x 4, attention_bwd_f32)", shape, t6, card)
            dqkv = _randn(gen, r, 3 * d, **f32)
            _gemm_f32_cases(card, x.view(r, d), w_in, b_in, g.view(r, d), dqkv, w_out)

            # the attention alone, masked with lse (#5's) and its backward (#6's)
            s = dh ** -0.5
            datt = _randn(gen, b, n, d, **f32)
            a_k, l_k = _build.attention_fwd(qkv, h, n, s, with_lse=True, mask=mask, keep=FA_KEEP)
            a_p, l_p = attention_fwd_ref(qkv, h, n, s, mask=mask, keep=FA_KEEP)
            print(f"packed_attn_f32 with the mask and lse, qkv [{b}, {n}, {3 * d}]:")
            _frac_err("att", a_k, a_p, F32_TOL)
            _frac_err("lse", l_k, l_p, F32_TOL)
            q, k, v = (t.contiguous() for t in qkv.view(b, n, 3, h, dh).permute(2, 0, 3, 1, 4))
            kern = lambda: _build.attention_fwd(  # noqa: E731
                qkv, h, n, s, with_lse=True, mask=mask, keep=FA_KEEP)
            plain = lambda: attention_fwd_ref(qkv, h, n, s, mask=mask, keep=FA_KEEP)  # noqa: E731
            p1, k1, k2, p2 = (_graph_ms(f) for f in (plain, kern, kern, plain))
            t = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                     library_ms=_graph_ms(lambda: TF.scaled_dot_product_attention(q, k, v)),
                     err64=_attention_fp64_err(a_k, qkv, h, n, s, mask, FA_KEEP),
                     **_bound_f32(0.0, 4 * (4 * r * d + b * h * n) + b * h * n * n,
                                  gemm_flops=4 * b * h * n * n * dh))
            _f32_row("packed_attn_f32 (#5's attention alone, by graph replay)",
                     f"qkv [{b}, {n}, {3 * d}]", t, card, "SDPA fp32 forward without dropout")
            d_k = _build.attention_bwd(qkv, a_k, datt, l_k, h, n, s, mask=mask, keep=FA_KEEP)
            d_p = attention_bwd_ref(qkv, a_k, datt, l_k, h, n, s, mask=mask, keep=FA_KEEP)
            print(f"attention_bwd_f32 with the mask, qkv [{b}, {n}, {3 * d}]:")
            _frac_err("dqkv", d_k, d_p, F32_TOL)
            _check(torch.equal(_build.attention_bwd(qkv, a_k, datt, l_k, h, n, s, mask=mask,
                                                    keep=FA_KEEP), d_k),
                   "attention_bwd_f32 differs on a second call")
            bms, bplain = turns(
                lambda: _build.attention_bwd(qkv, a_k, datt, l_k, h, n, s, mask=mask,
                                             keep=FA_KEEP),
                lambda: attention_bwd_ref(qkv, a_k, datt, l_k, h, n, s, mask=mask,
                                          keep=FA_KEEP), iters=10)
            with torch.enable_grad():
                _, sdpa_bwd = _sdpa_ms(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), datt.view(b, n, h, dh))
            t = dict(ms=bms, plain_ms=bplain, library_ms=sdpa_bwd,
                     **_bound_f32(0.0, 4 * (8 * r * d + 2 * b * h * n) + b * h * n * n,
                                  gemm_flops=10 * b * h * n * n * dh))
            _f32_row("attention_bwd_f32 (#6's attention backward alone, bit for bit twice)",
                     f"qkv [{b}, {n}, {3 * d}]", t, card, "SDPA fp32 backward without dropout")

            # #7 in fp32: the eval and serving attention, no mask, no lse
            t7 = _packed_case_f32(card, qkv, h)
        if (b, n, d, h) == F32_SHAPES[0]:
            results.update(fused_torch_mha_f32=t5, fused_torch_mha_bwd_f32=t6,
                           packed_flash_attention_f32=t7)
        del fwd, saved, got, want, g_k, g_p, qkv, att, lse, mask
    results["gather_project_f32"] = _gp_f32_cases(card, gen)
    results["colsum"] = _colsum_cases(card, gen)
    return results


#: (rows, cols, dtype) of colsum, #6's bias gradients (db_out of gp, db_in
#: of dqkv): the notebook's fp32 step at batch 32, the flagship's batch 512
#: in bf16 and at its own fp32, 'hier''s and the notebook's bf16 at batch
#: 512 (256 and 768 columns).  The first is the kernels line's.
COLSUM_CASES = ((NB_B * NB_N, 3 * NB_D, torch.float32), (NB_B * NB_N, NB_D, torch.float32),
                (FA_B * FA_N, FA_D, torch.bfloat16), (FA_B * FA_N, 3 * FA_D, torch.bfloat16),
                (FA_B * FA_N, FA_D, torch.float32), (FA_B * FA_N, 3 * FA_D, torch.float32),
                (FA_B * FA_N, 256, torch.bfloat16))


def _colsum_cases(card: str, gen) -> dict:
    """``_build.colsum`` at each of :data:`COLSUM_CASES`, bit for bit twice
    and equal bit for bit to ``kernel_utils.colsum_fixed_order`` (its plain
    twin, same plan), within 1e-4 of ``x.float().sum(0)`` (the one PyTorch
    call for the same function), timed by graph replay in turns with it
    (library, kernel, kernel, library) beside the byte bound (x read once,
    the fp32 sums written once).  Returns the first case's entry of the
    kernels line."""
    first = None
    for rows, cols, dt in COLSUM_CASES:
        x = _randn(gen, rows, cols, dtype=dt)
        want = x.float().sum(0)
        label = f"[{rows}, {cols}] {str(dt).removeprefix('torch.')}"
        got = _build.colsum(x)
        plan = _build.colsum_plan(rows, cols, _build._sm_count(x.device))
        _check(torch.equal(_build.colsum(x).view(torch.int32), got.view(torch.int32)),
               f"colsum {label} differs on a second call")
        twin = colsum_fixed_order(x, plan)
        _check(torch.equal(twin.view(torch.int32), got.view(torch.int32)),
               f"colsum {label} {plan} differs from colsum_fixed_order")
        _frac_err(f"colsum {label}, {plan}", got, want, F32_TOL)
        kern = lambda: _build.colsum(x)  # noqa: E731
        lib = lambda: x.float().sum(0)  # noqa: E731
        l1, t1, t2, l2 = (_graph_ms(f) for f in (lib, kern, kern, lib))
        plain_ms = _ms(lambda: colsum_fixed_order(x, plan), iters=3)
        nbytes = x.numel() * x.element_size() + 4 * cols
        t = dict(max_abs_err=float((got - twin).abs().max()), ms=(t1 + t2) / 2,
                 plain_ms=plain_ms, library_ms=(l1 + l2) / 2, **_bound(rows * cols, nbytes))
        err64 = float((got.double() - x.double().sum(0)).abs().max())
        print(f"colsum {label} (#6's bias gradients, by graph replay): {t['ms']:.4f} ms, "
              f"x.float().sum(0) {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}: {nbytes / 1e6:.1f} MB; {t['bound_ms'] / t['ms']:.0%} of it), "
              f"plain twin {plain_ms:.3f} ms; bit for bit twice and equal to the twin; max abs "
              f"err against fp64 {err64:.3g}; {card}")
        first = first or t
    return first


def _packed_case_f32(card: str, qkv, heads: int) -> dict:
    """#7's fp32 form on ``qkv`` against ``_packed_xla_ref`` (F32_TOL), by
    graph replay in turns with it and beside SDPA fp32."""
    b, n, w = qkv.shape
    inner, dh = w // 3, w // 3 // heads
    s = dh ** -0.5
    print(f"packed_flash_attention fp32 (#7), qkv [{b}, {n}, {w}]:")
    err = _frac_err("out", packed_flash_attention(qkv, heads), _packed_xla_ref(qkv, heads, s),
                    F32_TOL)
    q, k, v = (t.contiguous() for t in qkv.view(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4))
    kern = lambda: packed_flash_attention(qkv, heads)  # noqa: E731
    plain = lambda: _packed_xla_ref(qkv, heads, s)  # noqa: E731
    p1, k1, k2, p2 = (_graph_ms(f) for f in (plain, kern, kern, plain))
    t = dict(max_abs_err=err, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
             library_ms=_graph_ms(lambda: TF.scaled_dot_product_attention(q, k, v)),
             err64=_attention_fp64_err(packed_flash_attention(qkv, heads), qkv, heads, n, s),
             **_bound_f32(0.0, 4 * (b * n * w + b * n * inner),
                          gemm_flops=4 * b * heads * n * n * dh))
    _f32_row("packed_flash_attention (#7, by graph replay)", f"qkv [{b}, {n}, {w}]", t, card,
             "SDPA fp32 forward")
    return t


def _gp_f32_cases(card: str, gen) -> dict:
    """#14's fp32 form at the notebook's fused 2-D tokenizer (x [32, 64, 48],
    group 1; the kernels line), its 1-D tokenizer at patch 4 (x [32, 1024,
    3], group 4) and the flagship's three fp32 levels at batch 512, with a
    random bias, against ``gather_project_ref`` and the fp64 product, bit for
    bit twice, by graph replay beside ``index_select`` + ``F.linear``; the
    kernel's instances' registers and shared memory first.  Returns the
    first case."""
    attrs = _build.flash_kernel_attrs()
    for name in _build.GATHER_PROJECT_F32_FORMS:
        a = attrs[name]
        print(f"{name}: {a['registers']} registers, {a['local_bytes']} bytes local, "
              f"{a['smem_bytes']} bytes shared a block")
    nb = preset_config("notebook", fused=True)
    flag = build_tokenizer(preset_config("flagship", fused=True))
    cases = [("2-D, notebook", build_tokenizer(nb).proj, NB_B, nb.patch_size),
             ("1-D at patch 4", build_tokenizer(preset_config(
                 "notebook", tokenizer="1d", fused=True)).proj, NB_B, 1)]
    cases += [(f"flagship level {i}", getattr(flag, f"level_{i}").proj, FA_B, pre)
              for i, pre in enumerate(flag.pre_patch_sizes)]
    first = None
    for label, proj, b, pre in cases:
        x = patchify(_randn(gen, b, 32, 32, 3, dtype=torch.float32), pre).contiguous()
        w = proj.kernel.reshape(-1, proj.kernel.shape[-1]).to(DEVICE)
        lut, grp = proj.lut.to(DEVICE), getattr(proj, "group", 1)
        bias = _randn(gen, w.shape[1], dtype=torch.float32)
        bsz, n, kdim = x.shape
        m, d = lut.numel() // grp, w.shape[1]
        print(f"gather_project_f32 (#14), {label}: x [{bsz}, {n}, {kdim}], group {grp} -> "
              f"[{bsz}, {m}, {d}]:")
        with torch.no_grad():
            got = gp.gather_project(x, lut, w, bias, grp)
            err = _frac_err("out", got, gp.gather_project_ref(x, lut, w, bias, grp), F32_TOL)
            _check(torch.equal(gp.gather_project(x, lut, w, bias, grp), got),
                   f"gather_project_f32 {label} differs on a second call")
            a64 = x.index_select(1, lut.long()).reshape(bsz, m, grp * kdim).double()
            exact = a64 @ w.double() + bias.double()
            mag = a64.abs() @ w.double().abs() + bias.double().abs()
            err64 = float((got.double() - exact).abs().max())
            _check(bool(((got.double() - exact).abs() <= 2.0 ** -16 * mag).all()),
                   f"gather_project_f32 {label}: over 2^-16 of |A| @ |W| + |bias| from fp64")
            wt, lut64 = w.t().contiguous(), lut.long()
            kern = lambda: gp.gather_project(x, lut, w, bias, grp)  # noqa: E731
            plain = lambda: gp.gather_project_ref(x, lut, w, bias, grp)  # noqa: E731
            p1, k1, k2, p2 = (_graph_ms(f) for f in (plain, kern, kern, plain))
            lib_ms = _graph_ms(lambda: TF.linear(
                x.index_select(1, lut64).reshape(bsz, m, grp * kdim), wt, bias))
        t = dict(max_abs_err=err, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=lib_ms,
                 err64=err64,
                 **_bound_f32(0.0, 4 * (bsz * n * kdim + grp * kdim * d + d + bsz * m * d)
                              + 4 * m * grp, gemm_flops=2 * bsz * m * grp * kdim * d))
        _f32_row("gather_project_f32 (#14, by graph replay)", label, t, card,
                 "index_select + F.linear")
        first = first or t
    return first


def _notebook_counts() -> dict:
    m, p, g = fused_torch_mha, packed_flash_attention, gp.gather_project
    return {"fused_torch_mha_f32": m.f32_launches, "fused_torch_mha_bwd_f32": m.f32_bwd_launches,
            "packed_flash_attention_f32": p.f32_launches, "gather_project_f32": g.f32_launches,
            "fused_torch_mha": m.launches, "fused_torch_mha_bwd": m.bwd_launches,
            "packed_flash_attention": p.launches, "gather_project": g.launches,
            "colsum": _build.colsum.launches}


def _reset_notebook_counts():
    m, p, g = fused_torch_mha, packed_flash_attention, gp.gather_project
    m.launches = m.bwd_launches = m.f32_launches = m.f32_bwd_launches = 0
    p.launches = p.f32_launches = g.launches = g.f32_launches = _build.colsum.launches = 0


def _plain_notebook():
    """Route the notebook's path through the plain versions (comparison
    only): #5-#7 as :func:`_plain_fa`, #14 through ``gather_project_ref``."""
    stack = _plain_fa()
    stack.enter_context(mock.patch.object(gp, "_launch", lambda x, lut, w, b, group:
                                          gp.gather_project_ref(x, lut, w, b, group)))
    return stack


def _notebook_run(card: str, label: str, cfg, batch: int, timed: bool = False,
                  streamed: bool = False) -> dict:
    """Train ``build_model(cfg)`` 4 steps at ``batch`` with the Trainer
    (mixing, dropout), evaluate it and serve it; the launch counts of its
    main path equal layers x steps (#5/#6; with ``streamed`` #6 on the
    streamed form, csrc/attention_bwd_stream_sm90.cu), layers x eval
    batches and served forwards (#7), steps + eval and served forwards
    (#14, fused).
    One step's gradients and the served logits against the plain
    versions; with ``timed``, the train step timed against the plain
    versions' in turns and profiled.  Returns the counts."""
    f32 = cfg.dtype is None
    suffix = "_f32" if f32 else ""
    fused = cfg.fused and cfg.curve != "random"
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    stats = ((0.5,) * 3, (0.25,) * 3)
    steps = NB_STEPS
    train_ds = synthetic_dataset(n=batch * steps, hw=cfg.img_size,
                                 num_classes=cfg.num_classes, seed=0)
    test_ds = synthetic_dataset(n=batch, hw=cfg.img_size, num_classes=cfg.num_classes, seed=1)
    tf = make_eval_transform(*stats, device=DEVICE)
    trainer = Trainer(model, TrainConfig(num_classes=cfg.num_classes, epochs=1,
                                         warmup_epochs=1), steps_per_epoch=steps)
    before = [p.detach().clone() for p in model.parameters()]
    t0 = time.perf_counter()
    _reset_notebook_counts()
    _reset_stream_counts()
    record = trainer.fit(
        lambda: ((tf(x), y) for x, y in epoch_batches(train_ds, batch, seed=0)),
        lambda: ((tf(x), y) for x, y in epoch_batches(
            test_ds, batch, shuffle=False, drop_last=False)))
    torch.cuda.synchronize()
    counts = {**_notebook_counts(), **_stream_counts()}
    print(f"{label}: Trainer.fit, {steps} steps at batch {batch} + eval of {len(test_ds)} "
          f"({time.perf_counter() - t0:.1f} s): {record}")
    _check(bool(np.isfinite(record["train_loss"])) and bool(np.isfinite(record["test_loss"])),
           f"{label}: non-finite loss")
    _check(trainer.state.step == steps, f"{label}: {trainer.state.step} steps taken")
    layers = cfg.depth
    want = {name: 0 for name in counts}
    want.update({"fused_torch_mha" + suffix: layers * steps,
                 "fused_torch_mha_bwd" + suffix: layers * steps,
                 "packed_flash_attention" + suffix: layers,
                 "gather_project" + suffix: (steps + 1) if fused else 0,
                 "colsum": 2 * layers * steps})
    want.update(_stream_want(layers if streamed else 0, True, steps))
    print(f"{label}: launches over {steps} steps + 1 eval batch of {layers} layers: {counts}")
    _check(counts == want, f"{label}: launches {counts}, expected {want}")
    still = [nm for (nm, p), q in zip(model.named_parameters(), before) if torch.equal(p, q)]
    _check(not still, f"{label}: parameters unchanged after {steps} steps: {still}")
    del before

    x, y = next(epoch_batches(train_ds, batch, seed=0))
    step_batch = (tf(x), torch.from_numpy(y).long().to(DEVICE))
    state = _lr_zero_state(model)
    step = make_train_step(cfg.num_classes)

    def one_step():
        return step(state, step_batch, torch.Generator().manual_seed(7),
                    torch.Generator(device=DEVICE).manual_seed(7))

    m_k = one_step()
    grads = {nm: p.grad.detach().clone() for nm, p in model.named_parameters()}
    with _plain_notebook():
        m_p = one_step()
    rel = {nm: float((grads[nm].float() - p.grad.float()).norm() / p.grad.float().norm())
           for nm, p in model.named_parameters()}
    worst = max(rel, key=rel.get)
    tol = F32_GRAD_REL_TOL if f32 else GRAD_REL_TOL
    print(f"{label}: one train step (mixing, dropout), kernels vs plain versions: loss "
          f"{float(m_k['loss']):.6f} vs {float(m_p['loss']):.6f}; gradient relative L2 error "
          f"max {rel[worst]:.4g} ({worst}), median {float(np.median(list(rel.values()))):.4g} "
          f"over {len(rel)} tensors (tolerance {tol})")
    _check(rel[worst] <= tol, f"{label}: kernel-path gradients disagree with the plain path")
    del grads
    if timed:
        gen, dgen = torch.Generator().manual_seed(0), torch.Generator(device=DEVICE)

        def step_ms(plain: bool, n_steps: int = 3) -> float:
            with _plain_notebook() if plain else contextlib.nullcontext():
                step(state, step_batch, gen, dgen)  # warm-up
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(n_steps):
                    step(state, step_batch, gen, dgen)
                torch.cuda.synchronize()
            return (time.perf_counter() - t) / n_steps * 1e3

        p1, k1, k2, p2 = (step_ms(plain) for plain in (True, False, False, True))
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"{label}: train step at batch {batch} (mixing, dropout, clip, AdamW): kernels "
              f"{k_ms:.2f} ms = {batch / k_ms * 1e3:.1f} img/s, plain versions {p_ms:.2f} ms "
              f"= {batch / p_ms * 1e3:.1f} img/s, {card}")
        _profile(lambda: step(state, step_batch, gen, dgen),
                 f"{label} train step at batch {batch}", also=("colsum",))
    del state

    if cfg.curve == "random":
        try:
            ServingEngine(model, None, (cfg.img_size, cfg.img_size, 3), device=DEVICE)
        except ValueError as e:
            print(f"{label}: ServingEngine refuses the model: {e}")
        else:
            raise RuntimeError(f"{label}: ServingEngine served a curve='random' model")
        return counts
    dt = None if f32 else torch.bfloat16
    sizes = NB_BATCH_SIZES if f32 else FA_BATCH_SIZES
    reqs = NB_REQUESTS if f32 else FA_REQUESTS
    engine = ServingEngine(copy.deepcopy(model), None, (cfg.img_size, cfg.img_size, 3),
                           batch_sizes=sizes, dtype=dt, device=DEVICE)
    rng = np.random.default_rng(12)
    requests = [rng.standard_normal((k, cfg.img_size, cfg.img_size, 3), dtype=np.float32)
                for k in reqs]
    _reset_notebook_counts()
    _reset_stream_counts()
    outs = [engine.predict(r) for r in requests]
    served = {**_notebook_counts(), **_stream_counts()}
    forwards = sum(-(-k // sizes[-1]) for k in reqs)
    want = {name: 0 for name in served}
    want.update({"packed_flash_attention" + suffix: layers * forwards,
                 "gather_project" + suffix: forwards if fused else 0})
    _check(served == want, f"{label}: served launches {served}, expected {want}")
    with _plain_notebook():
        plain = np.concatenate([engine.predict(r) for r in requests])
    outs = np.concatenate(outs)
    _check(bool(np.isfinite(outs).all()) and outs.shape == (sum(reqs), cfg.num_classes),
           f"{label}: bad served logits")
    err, scale = float(np.abs(outs - plain).max()), float(np.abs(plain).max())
    tol = F32_TOL if f32 else FA_LOGIT_TOL
    print(f"{label}: served {reqs} images through ServingEngine{sizes}, #7 launched "
          f"{served['packed_flash_attention' + suffix]} times over {forwards} forwards; "
          f"kernels vs plain versions max abs err {err:.4g} (max |logit| {scale:.4g}; "
          f"tolerance {tol} x max |logit| = {tol * scale:.4g})")
    _check(err <= tol * scale, f"{label}: served logits disagree with the plain forward")
    for name, count in served.items():
        counts[name] += count
    return counts


def phase_notebook(card: str) -> dict:
    """The reference notebook's model (``preset_config("notebook")``:
    ``VisionTransformer`` over the 2-D Hilbert tokenizer) trained in fp32 at
    the notebook's batch 32 through the fp32 kernels of #5/#6, evaluated
    and served through #7's, for the curves hilbert, raster and random (the
    last not served: it draws a permutation per step); the same in bf16 at
    batch 512 with the fused tokenizer through the Hopper #5/#6/#7/#14; and
    the 1-D tokenizer at patch 4 (256 tokens), fused, in fp32 and bf16."""
    t0 = time.perf_counter()
    total = {}
    runs = [(f"notebook fp32, {curve}", preset_config("notebook", curve=curve), NB_B)
            for curve in ("hilbert", "raster", "random")]
    runs += [("notebook bf16, fused", preset_config("notebook", fused=True, dtype="bfloat16"),
              FA_B),
             ("notebook 1-D patch 4 fp32, fused",
              preset_config("notebook", tokenizer="1d", fused=True), NB_B),
             ("notebook 1-D patch 4 bf16, fused",
              preset_config("notebook", tokenizer="1d", fused=True, dtype="bfloat16"), FA_B)]
    timed = ("notebook fp32, hilbert", "notebook bf16, fused")
    # 256 tokens with the mask: #6 past the resident form's 192, streamed
    streamed = ("notebook 1-D patch 4 bf16, fused",)
    for label, cfg, batch in runs:
        for name, count in _notebook_run(card, label, cfg, batch, label in timed,
                                         label in streamed).items():
            total[name] = total.get(name, 0) + count
    print(f"notebook phase: {time.perf_counter() - t0:.1f} s")
    return total


# -- 15. the ViT-B/16 preset at its own dtype: #1-#4 in fp32 ---------------------

#: (label, batch of the forward check, batch of the backward check, N, D,
#: heads, F, n_actual): ViT-B/16 at the serving and training batches (timed),
#: ViT-S/16's width and a ragged shape (n_actual < N, R = 150 rows, not a
#: multiple of 128), checked only.
VIT_F32_SHAPES = (("ViT-B/16", B, TRAIN_B, N, D, HEADS, F, None),
                  ("ViT-S/16", 8, 8, N, 384, 6, 1536, None),
                  ("ragged", 3, 3, 50, 128, 2, 256, 37))
_MLP_BWD_NAMES = ("dx", "dls", "dlb", "dw1", "db1", "dw2", "db2")
_ATTN_BWD_NAMES = ("dx", "dls", "dlb", "dw_qkv", "dw_out")


def _vit_f32_args(gen, b, n, d, heads, f):
    """fp32 inputs of #1 (x, LN, W_qkv, W_out) and #2 (x, LN, W1, b1, W2,
    b2) at one layer's widths, with the cotangent g."""
    f32 = dict(dtype=torch.float32)
    x = _randn(gen, b, n, d, **f32)
    ln = (_randn(gen, d, scale=0.1, shift=1.0, **f32), _randn(gen, d, scale=0.1, **f32))
    attn = (x, *ln, _randn(gen, d, 3 * d, scale=d ** -0.5, **f32),
            _randn(gen, d, d, scale=d ** -0.5, **f32))
    mlp = (x, *ln, _randn(gen, d, f, scale=d ** -0.5, **f32), _randn(gen, f, scale=0.1, **f32),
           _randn(gen, f, d, scale=f ** -0.5, **f32), _randn(gen, d, scale=0.1, **f32))
    return attn, mlp, _randn(gen, b, n, d, **f32)


def _vit_f32_blocks(card: str, label: str, bf: int, bb: int, n: int, d: int, heads: int,
                    f: int, n_actual, timed: bool) -> dict:
    """#1 and #2 in fp32 at batch ``bf``, #3 and #4 at ``bb``, each against
    its plain version within F32_TOL of each tensor's largest |value| (#1 on
    the real rows); #3 and #4 (their column sums and the attention
    backward) bit for bit on a second call.  With ``timed``, each timed in
    turns with its plain version beside its fp32 bound; returns the four
    kernels-line entries."""
    gen = torch.Generator().manual_seed(16)
    shape = f"[{{}}, {n}, {d}], {heads} heads of {d // heads}, F {f}" + (
        f", n_actual {n_actual}" if n_actual else "")
    real = n_actual or n
    out = {}
    with torch.no_grad():
        attn, mlp, _ = _vit_f32_args(gen, bf, n, d, heads, f)
        print(f"#1 fp32 (fused_attention_block vs attention_block_ref), {label} "
              f"{shape.format(bf)}:")
        err1 = _frac_err("out, real rows",
                         fused_attention_block(*attn, heads, n_actual=n_actual)[:, :real],
                         attention_block_ref(*attn, heads, n_actual=n_actual)[:, :real], F32_TOL)
        print(f"#2 fp32 (fused_mlp_block vs mlp_block_ref), {label} {shape.format(bf)}:")
        err2 = _frac_err("out", fused_mlp_block(*mlp), mlp_block_ref(*mlp), F32_TOL)
        r = bf * n
        if timed:
            ms1, p1 = _ab_ms(lambda: fused_attention_block(*attn, heads),
                             lambda: attention_block_ref(*attn, heads), iters=10)
            ms2, p2 = _ab_ms(lambda: fused_mlp_block(*mlp), lambda: mlp_block_ref(*mlp), iters=10)
            out["fused_attention_block_f32"] = dict(
                max_abs_err=err1, ms=ms1, plain_ms=p1, library_ms=None,
                **_bound_f32(0.0, 4 * (2 * r * d + 4 * d * d + 2 * d),
                             gemm_flops=8 * r * d * d + 4 * bf * heads * n * n * (d // heads)))
            out["fused_mlp_block_f32"] = dict(
                max_abs_err=err2, ms=ms2, plain_ms=p2, library_ms=None,
                **_bound_f32(0.0, 4 * (2 * r * d + 2 * d * f + f + 3 * d),
                             gemm_flops=4 * r * d * f))
            _f32_row("#1 (ln_rows, gemm_f32, packed_attn_f32, gemm_f32 + residual)",
                     shape.format(bf), out["fused_attention_block_f32"], card)
            _f32_row("#2 (ln_rows, gemm_f32 + bias + GELU, gemm_f32 + bias + residual)",
                     shape.format(bf), out["fused_mlp_block_f32"], card)
        del attn, mlp

        attn, mlp, g = _vit_f32_args(gen, bb, n, d, heads, f)
        _, z = mlp_block_train_fwd(*mlp)
        m_args = (mlp[0], g, *mlp[1:6], z, mlp[6])
        print(f"#3 fp32 (mlp_block_bwd vs mlp_block_bwd_ref), {label} {shape.format(bb)}:")
        got = mlp_block_bwd(*m_args)
        err3 = max(_frac_err(nm, a, w_, F32_TOL)
                   for nm, a, w_ in zip(_MLP_BWD_NAMES, got, mlp_block_bwd_ref(*m_args)))
        _check(all(torch.equal(u, v) for u, v in zip(got, mlp_block_bwd(*m_args))),
               f"#3 fp32 ({label}) differs on a second call")
        del got
        _, qkv, att, lse = attention_block_train_fwd(*attn, heads, n_actual=n_actual)
        a_args = (attn[0], g, *attn[1:], qkv, att, lse, heads)
        print(f"#4 fp32 (attention_block_bwd vs attention_block_bwd_ref), {label} "
              f"{shape.format(bb)}:")
        got = attention_block_bwd(*a_args, n_actual=n_actual)
        err4 = max(_frac_err(nm, a, w_, F32_TOL) for nm, a, w_ in zip(
            _ATTN_BWD_NAMES, got, attention_block_bwd_ref(*a_args, n_actual=n_actual)))
        _check(all(torch.equal(u, v) for u, v in zip(
            got, attention_block_bwd(*a_args, n_actual=n_actual))),
               f"#4 fp32 ({label}) differs on a second call")
        del got
        print(f"#3 and #4 fp32 ({label}): every output, the column sums and the attention "
              "backward included, bit for bit on a second call")
        if timed:
            r = bb * n
            ms3, p3 = _ab_ms(lambda: mlp_block_bwd(*m_args), lambda: mlp_block_bwd_ref(*m_args),
                             iters=10)
            ms4, p4 = _ab_ms(lambda: attention_block_bwd(*a_args),
                             lambda: attention_block_bwd_ref(*a_args), iters=10)
            out["fused_mlp_block_bwd_f32"] = dict(
                max_abs_err=err3, ms=ms3, plain_ms=p3, library_ms=None,
                **_bound_f32(0.0, 4 * (3 * r * d + r * f + 4 * d * f + f + 4 * d),
                             gemm_flops=8 * r * d * f))
            out["fused_attention_block_bwd_f32"] = dict(
                max_abs_err=err4, ms=ms4, plain_ms=p4, library_ms=None,
                **_bound_f32(0.0, 4 * (3 * r * d + 4 * r * d + 8 * d * d + 3 * d)
                             + 4 * bb * heads * n,
                             gemm_flops=16 * r * d * d + 10 * bb * heads * n * n * (d // heads)))
            _f32_row("#3 (ln_rows, act_f32, gemm_f32 TN, NT + act' + column sums, TN, NT, "
                     "ln_rows_bwd)", shape.format(bb), out["fused_mlp_block_bwd_f32"], card)
            _f32_row("#4 (ln_rows, gemm_f32 NT, attention_bwd_f32, TN, NT, TN, ln_rows_bwd)",
                     shape.format(bb), out["fused_attention_block_bwd_f32"], card)
            _vit_attention_f32(card, qkv, att, lse, g, heads)
    return out


def _vit_attention_f32(card: str, qkv, att, lse, g, heads: int) -> None:
    """#1's attention alone (``csrc/packed_attn_f32.cu``, no mask) at the
    serving batch without lse and the training batch with it, and #4's
    attention backward alone (``csrc/attention_bwd_f32.cu``, no mask) at the
    training batch, bit for bit on a second call, each against its plain
    version and timed in turns beside its bound and SDPA fp32 (forward;
    its autograd backward)."""
    bb, n, w = qkv.shape
    inner, dh = w // 3, w // 3 // heads
    s = dh ** -0.5
    for b, with_lse in ((B, False), (bb, True)):
        q_ = qkv[:b].contiguous()
        print(f"packed_attn_f32 (#1's attention alone), qkv [{b}, {n}, {w}]"
              f"{' with lse' if with_lse else ''}:")
        got = _build.attention_fwd(q_, heads, n, s, with_lse=with_lse)
        a_p, l_p = attention_fwd_ref(q_, heads, n, s)
        err = _frac_err("att", got[0] if with_lse else got, a_p, F32_TOL)
        if with_lse:
            _frac_err("lse", got[1], l_p, F32_TOL)
        qh, kh, vh = (t.contiguous() for t in q_.view(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4))
        ms, plain = _ab_ms(lambda: _build.attention_fwd(q_, heads, n, s, with_lse=with_lse),
                           lambda: attention_fwd_ref(q_, heads, n, s), iters=10)
        t = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                 library_ms=_ms(lambda: TF.scaled_dot_product_attention(qh, kh, vh), iters=10),
                 err64=_attention_fp64_err(got[0] if with_lse else got, q_, heads, n, s),
                 **_bound_f32(0.0, 4 * (4 * b * n * inner + (b * heads * n if with_lse else 0)),
                              gemm_flops=4 * b * heads * n * n * dh))
        _f32_row("packed_attn_f32 (#1's attention alone)",
                 f"[{b}, {n}, {heads} x {dh}]{' with lse' if with_lse else ''}", t, card,
                 "SDPA fp32 forward")
    datt = g.view(bb, n, -1)[:, :, :inner].contiguous()
    print(f"attention_bwd_f32 without a mask (#4's attention backward alone), qkv [{bb}, {n}, "
          f"{w}]:")
    got = _build.attention_bwd(qkv, att, datt, lse, heads, n, s)
    err = _frac_err("dqkv", got, attention_bwd_ref(qkv, att, datt, lse, heads, n, s), F32_TOL)
    _check(torch.equal(_build.attention_bwd(qkv, att, datt, lse, heads, n, s), got),
           "attention_bwd_f32 differs on a second call")
    ms, plain = _ab_ms(lambda: _build.attention_bwd(qkv, att, datt, lse, heads, n, s),
                       lambda: attention_bwd_ref(qkv, att, datt, lse, heads, n, s), iters=10)
    q, k, v = qkv.view(bb, n, 3, heads, dh).unbind(2)
    with torch.enable_grad():
        _, sdpa_bwd = _sdpa_ms(q, k, v, datt.view(bb, n, heads, dh))
    t = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=sdpa_bwd,
             **_bound_f32(0.0, 4 * (8 * bb * n * inner + bb * heads * n),
                          gemm_flops=10 * bb * heads * n * n * dh))
    _f32_row("attention_bwd_f32 (#4's attention backward alone, bit for bit twice)",
             f"[{bb}, {n}, {heads} x {dh}]", t, card, "SDPA fp32 backward")


def _vit_gemm_f32_cases(card: str) -> None:
    """``csrc/gemm_f32.cu`` in each form of #1-#4's fp32 chains at ViT-B/16's
    shapes (the forward's at batch 64, R = 12,544; the backward's at batch
    256, R = 50,176), its epilogue included, against the same function in
    torch fp32 (within F32_TOL of each output's largest |value|; the column
    sums bit for bit on a second call), timed in turns with ``torch.matmul``
    fp32 of the product alone, with TFLOP/s and both bounds; the product
    alone (the kernel's, and torch.matmul fp32's) against fp64."""
    gen = torch.Generator().manual_seed(17)
    f32 = dict(dtype=torch.float32)
    rf, rb = B * N, TRAIN_B * N
    xf, hf = _randn(gen, rf, D, **f32), _randn(gen, rf, F, **f32)
    attf = _randn(gen, rf, D, **f32)
    w_qkv, w_out = _randn(gen, D, 3 * D, scale=D ** -0.5, **f32), _randn(gen, D, D, scale=D ** -0.5, **f32)
    w1, w2 = _randn(gen, D, F, scale=D ** -0.5, **f32), _randn(gen, F, D, scale=F ** -0.5, **f32)
    b1, b2 = _randn(gen, F, scale=0.1, **f32), _randn(gen, D, scale=0.1, **f32)
    gb, zb = _randn(gen, rb, D, **f32), _randn(gen, rb, F, **f32)
    xb, attb, dzb = _randn(gen, rb, D, **f32), _randn(gen, rb, D, **f32), _randn(gen, rb, F, **f32)
    dqkv = _randn(gen, rb, 3 * D, **f32)
    gelu_grad = lambda z: (0.5 * (1 + torch.erf(z * 2 ** -0.5))  # noqa: E731
                           + z * torch.exp(-0.5 * z * z) * 0.3989422804014327)
    cases = (
        ("QKV NN (#1)", lambda: _build.gemm_f32(xf, w_qkv), lambda: (xf @ w_qkv,), xf, w_qkv,
         None),
        ("out NN + residual (#1)", lambda: _build.gemm_f32(attf, w_out, residual=xf),
         lambda: (attf @ w_out + xf,), attf, w_out, lambda: _build.gemm_f32(attf, w_out)),
        ("fc1 NN + b1 + GELU, z (#2)",
         lambda: _build.gemm_f32(xf, w1, bias=b1, act="gelu", save_z=True),
         lambda: (TF.gelu(xf @ w1 + b1), xf @ w1 + b1), xf, w1, lambda: _build.gemm_f32(xf, w1)),
        ("fc2 NN + b2 + residual (#2)", lambda: _build.gemm_f32(hf, w2, bias=b2, residual=xf),
         lambda: (hf @ w2 + b2 + xf,), hf, w2, lambda: _build.gemm_f32(hf, w2)),
        ("datt NT (#4)", lambda: _build.gemm_f32(gb, w_out, trans_b=True),
         lambda: (gb @ w_out.T,), gb, w_out.T, None),
        ("dW_out TN (#4)", lambda: _build.gemm_f32(attb, gb, trans_a=True),
         lambda: (attb.T @ gb,), attb.T, gb, None),
        ("dxn NT (#4)", lambda: _build.gemm_f32(dqkv, w_qkv, trans_b=True),
         lambda: (dqkv @ w_qkv.T,), dqkv, w_qkv.T, None),
        ("dW_qkv TN (#4)", lambda: _build.gemm_f32(xb, dqkv, trans_a=True),
         lambda: (xb.T @ dqkv,), xb.T, dqkv, None),
        ("dW2 TN (#3)", lambda: _build.gemm_f32(zb, gb, trans_a=True),
         lambda: (zb.T @ gb,), zb.T, gb, None),
        ("dz NT + act'(z), db1 column sums (#3)",
         lambda: _build.gemm_f32(gb, w2, trans_b=True, act="gelu", z_in=zb, colsum=True),
         lambda: ((gb @ w2.T) * gelu_grad(zb), ((gb @ w2.T) * gelu_grad(zb)).sum(0)),
         gb, w2.T, lambda: _build.gemm_f32(gb, w2, trans_b=True)),
        ("dW1 TN (#3)", lambda: _build.gemm_f32(xb, dzb, trans_a=True),
         lambda: (xb.T @ dzb,), xb.T, dzb, None),
        ("dxn NT (#3)", lambda: _build.gemm_f32(dzb, w1, trans_b=True),
         lambda: (dzb @ w1.T,), dzb, w1.T, None))
    for name, kern, plain, a, b_, product in cases:
        product = product or kern
        got = kern()
        got = got if isinstance(got, tuple) else (got,)
        want = plain()
        print(f"gemm_f32 {name}:")
        err = max(_frac_err(f"output {i}", u, v, F32_TOL) for i, (u, v) in enumerate(zip(got, want)))
        del want
        if "column sums" in name:
            _check(torch.equal(kern()[1], got[1]), "gemm_f32's column sums differ on a second call")
            print("  the column sums bit for bit on a second call")
        m, k, n = a.shape[0], a.shape[1], b_.shape[1]
        ms, lib_ms = _ab_ms(kern, lambda: a @ b_, iters=10)
        err64, err64_lib = _fp64_errs(product, a, b_)
        _gemm_f32_line(name, m, n, k, ms, lib_ms,
                       4 * (m * k + k * n + sum(t.numel() for t in got)), err, err64, err64_lib,
                       card)
        del got


#: (batch, heads, head dim, tokens) where :func:`_attention_f32_split` times
#: ``csrc/packed_attn_f32.cu``'s one-pass form against two passes: ViT-B's
#: served shape at 64 to 256 keys, the flagship's head dim 192 at 64.
F32_SPLIT_SHAPES = tuple((B, HEADS, 64, n) for n in (64, 128, 192, N, 256)) + (
    (FA_B, FA_HEADS, 192, FA_N),)


def _attention_f32_split(card: str) -> None:
    """Where ``csrc/packed_attn_f32.cu``'s one pass should give way to two:
    at each of :data:`F32_SPLIT_SHAPES` the one-pass form that
    ``_build.attention_fwd_f32_columns`` picks and the two-pass form of the
    same call (``_build.attention_fwd_f32_form``), each against
    ``attention_fwd_ref`` (F32_TOL), timed in turns."""
    gen = torch.Generator().manual_seed(18)
    for b, heads, dh, n in F32_SPLIT_SHAPES:
        qkv = _randn(gen, b, n, 3 * heads * dh, dtype=torch.float32)
        s = dh ** -0.5
        nk = _build.attention_fwd_f32_columns(dh, n)
        one = lambda: _build.attention_fwd_f32_form(qkv, heads, n, s, nk)  # noqa: E731
        two = lambda: _build.attention_fwd_f32_form(qkv, heads, n, s, 0)  # noqa: E731
        want = attention_fwd_ref(qkv, heads, n, s)[0]
        print(f"packed_attn_f32 forms, qkv [{b}, {n}, {3 * heads * dh}]:")
        _frac_err(f"one pass over {nk} key columns", one(), want, F32_TOL)
        _frac_err("two passes", two(), want, F32_TOL)
        ms_one, ms_two = _ab_ms(one, two, iters=10)
        print(f"packed_attn_f32 one pass over {nk} key columns {ms_one:.4f} ms, two passes "
              f"{ms_two:.4f} ms ({ms_two / ms_one:.2f}x), {heads} heads of {dh}, {card}")


def phase_vit_f32_kernels(card: str) -> dict:
    """#1-#4 in fp32 (the ViT-B/16 and ViT-S/16 presets at their own dtype)
    against their plain versions: ViT-B/16 (#1, #2 at batch 64; #3, #4 at
    256; timed, beside the fp32 bound), ViT-S/16's width and a ragged shape
    (checked); #1's attention alone and #4's attention backward alone beside
    SDPA fp32; each GEMM form beside torch.matmul fp32; the fp32 attention's
    one pass against two (:func:`_attention_f32_split`).  Returns the
    kernels-line entries."""
    t0 = time.perf_counter()
    out = {}
    for label, bf, bb, n, d, heads, f, n_actual in VIT_F32_SHAPES:
        out.update(_vit_f32_blocks(card, label, bf, bb, n, d, heads, f, n_actual,
                                   timed=label == "ViT-B/16"))
        torch.cuda.empty_cache()
    _vit_gemm_f32_cases(card)
    _attention_f32_split(card)
    torch.cuda.empty_cache()
    print(f"ViT fp32 kernels phase: {time.perf_counter() - t0:.1f} s")
    return out


_VIT_F32_COUNTS = (("fused_attention_block_f32", fused_attention_block, "f32_launches"),
                   ("fused_mlp_block_f32", fused_mlp_block, "f32_launches"),
                   ("fused_attention_block_bwd_f32", fused_attention_block, "f32_bwd_launches"),
                   ("fused_mlp_block_bwd_f32", fused_mlp_block, "f32_bwd_launches"),
                   ("fused_attention_block", fused_attention_block, "launches"),
                   ("fused_mlp_block", fused_mlp_block, "launches"),
                   ("fused_attention_block_bwd", fused_attention_block, "bwd_launches"),
                   ("fused_mlp_block_bwd", fused_mlp_block, "bwd_launches"))


def _vit_counts() -> dict:
    return {name: getattr(fn, attr) for name, fn, attr in _VIT_F32_COUNTS}


def _reset_vit_counts() -> None:
    for _, fn, attr in _VIT_F32_COUNTS:
        setattr(fn, attr, 0)


def phase_vit_f32(card: str) -> dict:
    """``build_model(preset_config("vit-b-16", curve="hilbert",
    num_classes=1000))`` with no dtype (fp32 throughout, as the preset and
    JAX's CLI compute): ``ServingEngine(batch_sizes=(8, 64), dtype=None)``
    answers 1, 37 and 64 images through #1 and #2 in fp32 (12 x forwards
    launches each, no bf16 launch), the served logits within F32_TOL of the
    largest |logit| of the plain path; ``Trainer.fit`` for 4 steps at batch
    256 plus an eval batch through #1-#4 in fp32 (12 x steps, 12 x (steps
    + 1) forwards), finite losses, every parameter moved; one step's
    gradients against the plain blocks (relative L2 per tensor within
    F32_GRAD_REL_TOL); forward and train step times on both paths in turns,
    peak memory and a profile of the step.  Returns the launch counts."""
    t0 = time.perf_counter()
    cfg = preset_config("vit-b-16", curve="hilbert", num_classes=1000)
    _check(cfg.dtype is None, "the vit-b-16 preset names a dtype")
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    _check(all(p.dtype == torch.float32 for p in model.parameters()), "non-fp32 parameters")
    engine = ServingEngine(copy.deepcopy(model), None, (cfg.img_size, cfg.img_size, 3),
                           batch_sizes=BATCH_SIZES, dtype=None, device=DEVICE)
    rng = np.random.default_rng(15)
    requests = [rng.standard_normal((k, cfg.img_size, cfg.img_size, 3), dtype=np.float32)
                for k in REQUESTS]
    _reset_vit_counts()
    outs = [engine.predict(r) for r in requests]
    served = _vit_counts()
    forwards = sum(-(-k // BATCH_SIZES[-1]) for k in REQUESTS)
    want = {name: 0 for name in served}
    want.update(fused_attention_block_f32=cfg.depth * forwards,
                fused_mlp_block_f32=cfg.depth * forwards)
    print(f"ViT-B/16 fp32: served {REQUESTS} images through ServingEngine{BATCH_SIZES} "
          f"(dtype None), launches over {forwards} forwards of depth {cfg.depth}: {served}")
    _check(served == want, f"ViT-B/16 fp32: served launches {served}, expected {want}")
    with _plain_blocks():
        plain = np.concatenate([engine.predict(r) for r in requests])
    outs = np.concatenate(outs)
    _check(bool(np.isfinite(outs).all()) and outs.shape == (sum(REQUESTS), cfg.num_classes),
           "ViT-B/16 fp32: bad served logits")
    err, scale = float(np.abs(outs - plain).max()), float(np.abs(plain).max())
    print(f"ViT-B/16 fp32: served logits, kernels vs plain blocks: max abs err {err:.4g} (max "
          f"|logit| {scale:.4g}; tolerance {F32_TOL} x max |logit| = {F32_TOL * scale:.4g})")
    _check(err <= F32_TOL * scale, "ViT-B/16 fp32: served logits disagree with the plain path")
    x64 = torch.from_numpy(requests[-1]).to(DEVICE)
    with torch.inference_mode():
        k1, p1 = _ab_ms(lambda: engine.model(x64), _plain_forward(engine.model, x64), iters=5)
    bs = BATCH_SIZES[-1]
    print(f"ViT-B/16 fp32: forward at batch {bs}: kernels {k1:.3f} ms = {bs / k1 * 1e3:.1f} "
          f"img/s, plain blocks {p1:.3f} ms = {bs / p1 * 1e3:.1f} img/s, {card}")
    del engine, x64

    stats = ((0.5,) * 3, (0.25,) * 3)
    train_ds = synthetic_dataset(n=TRAIN_B * TRAIN_STEPS, hw=cfg.img_size,
                                 num_classes=cfg.num_classes, seed=0)
    test_ds = synthetic_dataset(n=TRAIN_B, hw=cfg.img_size, num_classes=cfg.num_classes, seed=1)
    tf = make_eval_transform(*stats, device=DEVICE)
    trainer = Trainer(model, TrainConfig(num_classes=cfg.num_classes, epochs=1,
                                         warmup_epochs=1), steps_per_epoch=TRAIN_STEPS)
    before = [p.detach().clone() for p in model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    _reset_vit_counts()
    record = trainer.fit(
        lambda: ((tf(x), y) for x, y in epoch_batches(train_ds, TRAIN_B, seed=0)),
        lambda: ((tf(x), y) for x, y in epoch_batches(
            test_ds, TRAIN_B, shuffle=False, drop_last=False)))
    torch.cuda.synchronize()
    trained = _vit_counts()
    print(f"ViT-B/16 fp32: Trainer.fit, {TRAIN_STEPS} steps at batch {TRAIN_B} + eval of "
          f"{len(test_ds)} ({time.perf_counter() - t1:.1f} s): {record}")
    print(f"ViT-B/16 fp32: launches over {TRAIN_STEPS} train steps + 1 eval batch of depth "
          f"{cfg.depth}: {trained}")
    _check(bool(np.isfinite(record["train_loss"])) and bool(np.isfinite(record["test_loss"])),
           "ViT-B/16 fp32: non-finite loss")
    _check(trainer.state.step == TRAIN_STEPS, f"{trainer.state.step} steps taken")
    want = {name: 0 for name in trained}
    want.update(fused_attention_block_f32=cfg.depth * (TRAIN_STEPS + 1),
                fused_mlp_block_f32=cfg.depth * (TRAIN_STEPS + 1),
                fused_attention_block_bwd_f32=cfg.depth * TRAIN_STEPS,
                fused_mlp_block_bwd_f32=cfg.depth * TRAIN_STEPS)
    _check(trained == want, f"ViT-B/16 fp32: train launches {trained}, expected {want}")
    still = [nm for (nm, p), q in zip(model.named_parameters(), before) if torch.equal(p, q)]
    _check(not still, f"ViT-B/16 fp32: parameters unchanged after {TRAIN_STEPS} steps: {still}")
    del before

    x, y = next(epoch_batches(train_ds, TRAIN_B, seed=0))
    batch = (tf(x), torch.from_numpy(y).long().to(DEVICE))
    state = _lr_zero_state(model)
    step = make_train_step(cfg.num_classes, use_mixing=False)
    m_k = step(state, batch, torch.Generator())
    grads = {nm: p.grad.detach().clone() for nm, p in model.named_parameters()}
    with _plain_blocks():
        m_p = step(state, batch, torch.Generator())
    rel = {nm: float((grads[nm] - p.grad).norm() / p.grad.norm())
           for nm, p in model.named_parameters()}
    worst = max(rel, key=rel.get)
    print(f"ViT-B/16 fp32: one train step, kernels vs plain blocks: loss "
          f"{float(m_k['loss']):.6f} vs {float(m_p['loss']):.6f}; gradient relative L2 error "
          f"max {rel[worst]:.4g} ({worst}), median {float(np.median(list(rel.values()))):.4g} "
          f"over {len(rel)} tensors (tolerance {F32_GRAD_REL_TOL})")
    _check(rel[worst] <= F32_GRAD_REL_TOL,
           "ViT-B/16 fp32: kernel-path gradients disagree with the plain path")
    del grads

    mixing_step = make_train_step(cfg.num_classes)
    gen = torch.Generator().manual_seed(0)

    def step_ms(plain: bool, steps: int = 2) -> float:
        with _plain_blocks() if plain else contextlib.nullcontext():
            mixing_step(state, batch, gen)  # warm-up
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(steps):
                mixing_step(state, batch, gen)
            torch.cuda.synchronize()
        return (time.perf_counter() - t) / steps * 1e3

    p1, k1, k2, p2 = (step_ms(plain) for plain in (True, False, False, True))
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"ViT-B/16 fp32: train step at batch {TRAIN_B} (mixing, clip, AdamW): kernels "
          f"{k_ms:.2f} ms = {TRAIN_B / k_ms * 1e3:.1f} img/s, plain blocks {p_ms:.2f} ms = "
          f"{TRAIN_B / p_ms * 1e3:.1f} img/s, {card}")
    print(f"ViT-B/16 fp32: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _profile(lambda: mixing_step(state, batch, gen), f"ViT-B/16 fp32 train step at batch {TRAIN_B}")
    del state, model, trainer
    torch.cuda.empty_cache()
    print(f"ViT fp32 model phase: {time.perf_counter() - t0:.1f} s")
    return {name: served[name] + trained[name]
            for name in ("fused_attention_block_f32", "fused_mlp_block_f32",
                         "fused_attention_block_bwd_f32", "fused_mlp_block_bwd_f32")}


#: The head-dims phase (ROADMAP F5), (b, n, heads, dh): the flagship's
#: [512, 64, H x Dh] at H x Dh = 768 with 16, 8, 6 and 3 heads (Dh 48, 96,
#: 128, 256), 'hier''s d 256 at 8 heads (Dh 32), and its fusion length 192
#: at 2 heads (Dh 128).
HD_SHAPES = ((512, 64, 8, 32), (512, 64, 16, 48), (512, 64, 8, 96), (512, 64, 6, 128),
             (512, 64, 3, 256), (512, 192, 2, 128))
#: The kernel-line entries each shape holds against plain, in each dtype:
#: #7 served, #1's attention with its lse, #5's with the mask and lse,
#: #4's attention backward and #6's with the mask.
HD_ENTRIES = ("packed_flash_attention", "fused_attention_block", "fused_torch_mha",
              "fused_attention_block_bwd", "fused_torch_mha_bwd")
HD_STEPS = 2


def _hd_row(card: str, label: str, shape: str, kern, plain, lib, check,
            flops: float, nbytes: float, f32: bool) -> float:
    """One head-dims row: ``check(got, want)`` -> max abs error (it raises
    past its tolerance), then the kernel timed in turns with its plain
    version beside the library call and the bound (bf16 at 989 TFLOP/s,
    fp32 as three TF32 products at 495, bytes at 3.35 TB/s)."""
    err = check(kern(), plain())
    ms, plain_ms = _ab_ms(kern, plain, iters=10)
    lib_ms = _ms(lib, iters=10)
    bound = _bound_f32(0.0, nbytes, flops) if f32 else _bound(flops, nbytes)
    print(f"head dims: {label} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
          f"{lib_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), max abs err {err:.4g}, {card}")
    return err


def phase_head_dim_kernels(card: str) -> dict:
    """(a) The head dims past 64 and 192 (ROADMAP F5) at HD_SHAPES, in bf16
    and fp32: #7 served (``_build.attention_fwd`` against
    ``_packed_xla_ref``), #1's attention with its lse and #5's with the
    mask (keep FA_KEEP) against ``attention_fwd_ref`` (lse against fp64),
    #4's and #6's attention backward against ``attention_bwd_ref``, bit for
    bit on a second call; each timed beside its plain version, SDPA
    (forward, or its autograd backward, on contiguous [B, H, N, Dh] q, k,
    v, without the mask) and its bound.  Tolerances: bf16 forwards
    BLOCK_TOL, backwards BWD_TOL of the largest |value|; fp32 F32_TOL of
    the largest |value|.  Returns {kernel-line entry: [head dims held]}."""
    gen = torch.Generator().manual_seed(21)
    for b, n, h, dh in HD_SHAPES:
        s = dh ** -0.5
        mask = torch.rand(b, h, n, n, generator=gen).lt(FA_KEEP).to(DEVICE)
        for f32 in (False, True):
            dt = torch.float32 if f32 else torch.bfloat16
            qkv = _randn(gen, b, n, 3 * h * dh, dtype=dt)
            datt = _randn(gen, b, n, h * dh, dtype=dt)
            shape = f"[{b}, {n}, {h} x {dh}] {'fp32' if f32 else 'bf16'}"
            q, k, v = (t.contiguous() for t in qkv.view(b, n, 3, h, dh).permute(2, 0, 3, 1, 4))
            io, lse_b, mask_b = (4 if f32 else 2) * b * n * h * dh, 4 * b * h * n, b * h * n * n
            fwd_flops, bwd_flops = 4 * b * h * n * n * dh, 10 * b * h * n * n * dh
            lse64 = _lse_of(qkv, h, n)

            def out_err(got, want, what=shape):
                if f32:
                    return _frac_err(what, got, want, F32_TOL)
                err, ok = _agree(got, want, **BLOCK_TOL)
                _check(ok, f"{what}: kernel disagrees with its plain version")
                return err

            def with_lse(got, want):
                lse_err, ok = _agree(got[1], lse64, **LSE_TOL)
                _check(ok, f"{shape}: lse disagrees with fp64 ({lse_err:.4g})")
                return out_err(got[0], want[0])

            def sdpa():
                return TF.scaled_dot_product_attention(q, k, v)

            kw = [dict(), dict(mask=mask, keep=FA_KEEP)]
            fwd = [lambda kw=kw_: _build.attention_fwd(qkv, h, n, s, with_lse=True, **kw)
                   for kw_ in kw]
            ref = [lambda kw=kw_: attention_fwd_ref(qkv, h, n, s, **kw) for kw_ in kw]
            _hd_row(card, "#7 served", shape,
                    lambda: _build.attention_fwd(qkv, h, n, s),
                    lambda: _packed_xla_ref(qkv, h, s), sdpa, out_err, fwd_flops, 4 * io, f32)
            _hd_row(card, "#1's attention with lse", shape, fwd[0],
                    ref[0], sdpa, with_lse, fwd_flops, 4 * io + lse_b, f32)
            _hd_row(card, "#5's attention with the mask and lse", shape,
                    fwd[1], ref[1], sdpa, with_lse, fwd_flops, 4 * io + lse_b + mask_b, f32)
            qt, kt, vt = (t.detach().requires_grad_() for t in (q, k, v))
            out = TF.scaled_dot_product_attention(qt, kt, vt)
            g = datt.view(b, n, h, dh).transpose(1, 2).contiguous()

            def sdpa_bwd():
                for t in (qt, kt, vt):
                    t.grad = None
                out.backward(g, retain_graph=True)
            for i, label in enumerate(("#4's attention backward",
                                       "#6's attention backward with the mask")):
                att, lse = ref[i]()

                def kern(i=i, att=att, lse=lse):
                    return _build.attention_bwd(qkv, att, datt, lse, h, n, s, **kw[i])

                def bwd_err(got, want, kern=kern, label=label):
                    err = _frac_err(f"{label} {shape}", got, want, F32_TOL if f32 else BWD_TOL)
                    _check(torch.equal(got, kern()), f"{label} {shape}: not bit for bit twice")
                    return err
                _hd_row(card, label, shape, kern,
                        lambda i=i, att=att, lse=lse: attention_bwd_ref(qkv, att, datt, lse, h,
                                                                        n, s, **kw[i]),
                        sdpa_bwd, bwd_err, bwd_flops, 8 * io + lse_b + i * mask_b, f32)
            del qkv, datt, q, k, v, qt, kt, vt, out, g, lse64
        del mask
        torch.cuda.empty_cache()
    dims = sorted({dh for *_, dh in HD_SHAPES})  # each held, or the phase raised
    return {f"{e}{sfx}": dims for e in HD_ENTRIES for sfx in ("", "_f32")}


#: The streamed form's launch counters (csrc/attention_bwd_stream_sm90.cu),
#: by kernel-line entry: #4's without the mask, #6's with it.
_STREAM_COUNTS = (("attention_bwd_streamed", "streamed"),
                  ("attention_bwd_streamed_masked", "streamed_masked"))


def _stream_counts() -> dict:
    return {name: getattr(_build.attention_bwd, attr) for name, attr in _STREAM_COUNTS}


def _reset_stream_counts() -> None:
    for _, attr in _STREAM_COUNTS:
        setattr(_build.attention_bwd, attr, 0)


def _stream_want(streamed: int, family_a: bool, steps: int) -> dict:
    """The streamed form's launches over ``steps`` train steps of a model
    with ``streamed`` layers past the resident form's limits: #6's (with
    the dropout mask) in family A, #4's in family B."""
    want = {name: 0 for name, _ in _STREAM_COUNTS}
    want[_STREAM_COUNTS[bool(family_a)][0]] = streamed * steps
    return want


def _hd_model(card: str, label: str, cfg, batch: int, layers: int, family_a: bool,
              steps: int = HD_STEPS, streamed: int = 0) -> dict:
    """(b) One model at a head dim past 64 and 192: ``Trainer.fit`` for
    ``steps`` steps at ``batch`` plus an eval batch, finite losses and the
    kernels' launch counts (layers x steps in training, layers a forward;
    the streamed form of the attention backward, ``streamed`` of the
    layers x steps);
    one step's gradients (mixing, and family A's dropout, the same draws)
    against the plain path (GRAD_REL_TOL in bf16, F32_GRAD_REL_TOL in
    fp32); ``ServingEngine`` answers 1 and ``batch`` images, launches
    counted, logits within FA_LOGIT_TOL (bf16) or F32_TOL (fp32) of the
    largest |logit| of the plain path.  Returns the launch counts."""
    t0 = time.perf_counter()
    f32 = cfg.dtype is None
    sfx = "_f32" if f32 else ""
    counts, reset = (_tail_counts, _reset_tail_counts) if family_a else (_vit_counts,
                                                                        _reset_vit_counts)
    plain_path = _plain_fa if family_a else _plain_blocks
    grad_tol, logit_tol = (F32_GRAD_REL_TOL, F32_TOL) if f32 else (GRAD_REL_TOL, FA_LOGIT_TOL)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    stats = ((0.5,) * 3, (0.25,) * 3)
    train_ds = synthetic_dataset(n=batch * steps, hw=cfg.img_size,
                                 num_classes=cfg.num_classes, seed=0)
    test_ds = synthetic_dataset(n=batch, hw=cfg.img_size, num_classes=cfg.num_classes, seed=1)
    tf = make_eval_transform(*stats, device=DEVICE)
    trainer = Trainer(model, TrainConfig(num_classes=cfg.num_classes, epochs=1,
                                         warmup_epochs=1), steps_per_epoch=steps)
    reset()
    _reset_stream_counts()
    record = trainer.fit(
        lambda: ((tf(x), y) for x, y in epoch_batches(train_ds, batch, seed=0)),
        lambda: ((tf(x), y) for x, y in epoch_batches(
            test_ds, batch, shuffle=False, drop_last=False)))
    torch.cuda.synchronize()
    trained = {**counts(), **_stream_counts()}
    _check(bool(np.isfinite(record["train_loss"])) and bool(np.isfinite(record["test_loss"])),
           f"{label}: non-finite loss")
    _check(trainer.state.step == steps, f"{label}: {trainer.state.step} steps taken")
    layer_steps = layers * steps
    want = {name: 0 for name in trained}
    if family_a:
        want.update({f"fused_torch_mha{sfx}": layer_steps,
                     f"fused_torch_mha_bwd{sfx}": layer_steps,
                     f"packed_flash_attention{sfx}": layers})
    else:
        want.update({f"{blk}{sfx}": layer_steps + layers for blk in ("fused_attention_block",
                                                                    "fused_mlp_block")})
        want.update({f"{blk}_bwd{sfx}": layer_steps for blk in ("fused_attention_block",
                                                               "fused_mlp_block")})
    want.update(_stream_want(streamed, family_a, steps))
    print(f"{label}: Trainer.fit, {steps} steps at batch {batch} + eval of {len(test_ds)}: "
          f"{record}; launches {trained}")
    _check(trained == want, f"{label}: launches {trained}, expected {want}")

    x, y = next(epoch_batches(train_ds, batch, seed=0))
    data = (tf(x), torch.from_numpy(y).long().to(DEVICE))
    state = _lr_zero_state(model)
    step = make_train_step(cfg.num_classes)

    def one_step():
        return step(state, data, torch.Generator().manual_seed(7),
                    torch.Generator(device=DEVICE).manual_seed(7))
    m_k = one_step()
    grads = {nm: p.grad.detach().clone() for nm, p in model.named_parameters()}
    with plain_path():
        m_p = one_step()
    rel = {nm: float((grads[nm].float() - p.grad.float()).norm() / p.grad.float().norm())
           for nm, p in model.named_parameters()}
    worst = max(rel, key=rel.get)
    print(f"{label}: one train step, kernels vs plain path: loss {float(m_k['loss']):.6f} vs "
          f"{float(m_p['loss']):.6f}; gradient relative L2 error max {rel[worst]:.4g} "
          f"({worst}), median {float(np.median(list(rel.values()))):.4g} over {len(rel)} "
          f"tensors (tolerance {grad_tol})")
    _check(rel[worst] <= grad_tol, f"{label}: kernel-path gradients disagree with the plain "
           "path")
    del grads, state, data

    engine = ServingEngine(copy.deepcopy(model), None, (cfg.img_size, cfg.img_size, 3),
                           batch_sizes=(16, batch), dtype=cfg.torch_dtype(), device=DEVICE)
    rng = np.random.default_rng(22)
    requests = [rng.standard_normal((k, cfg.img_size, cfg.img_size, 3), dtype=np.float32)
                for k in (1, batch)]
    reset()
    _reset_stream_counts()
    outs = np.concatenate([engine.predict(r) for r in requests])
    served = {**counts(), **_stream_counts()}
    _check(not any(_stream_counts().values()), f"{label}: a served forward ran a backward")
    name = f"packed_flash_attention{sfx}" if family_a else f"fused_attention_block{sfx}"
    _check(served[name] == 2 * layers, f"{label}: served launches {served}")
    with plain_path():
        plain = np.concatenate([engine.predict(r) for r in requests])
    err, scale = float(np.abs(outs - plain).max()), float(np.abs(plain).max())
    print(f"{label}: served 1 and {batch} images, launches {served}; logits vs plain path max "
          f"abs err {err:.4g} (max |logit| {scale:.4g}; tolerance {logit_tol} x max |logit|); "
          f"{time.perf_counter() - t0:.1f} s, {card}")
    _check(bool(np.isfinite(outs).all()) and err <= logit_tol * scale,
           f"{label}: served logits disagree with the plain path")
    del model, trainer, engine
    torch.cuda.empty_cache()
    return {k: trained[k] + served[k] for k in trained}


def phase_head_dim_models(card: str) -> dict:
    """(b) Models at head dims past 64 and 192, depth cut to 2 (one layer a
    level for 'hier'): the flagship in bf16 at batch 512 with dropout 0.1
    at 6, 8, 3 and 16 heads (Dh 128, 96, 256, 48) and at its own fp32 at 6;
    'hier' in bf16 at 2 and 8 heads (Dh 128, 32); ViT-B/16 at 6 heads of
    128 at batch 256 in bf16 and at its own fp32.  Returns the summed
    launch counts."""
    runs = [(f"flagship, {k} heads of {768 // k}, bf16",
             preset_config("flagship", n_heads=k, depth=2, dtype="bfloat16"), FA_B, 2, True,
             2 if k == 3 else 0) for k in (6, 8, 3, 16)]
    runs.append(("flagship, 6 heads of 128, fp32", preset_config("flagship", n_heads=6, depth=2),
                 FA_B, 2, True, 0))
    runs += [(f"hier, {k} heads of {256 // k}, bf16",
              preset_config("flagship", model="hier", n_heads=k, depth=1, dtype="bfloat16"),
              FA_B, 3 + 2, True, 2 if k == 2 else 0) for k in (2, 8)]
    runs += [(f"ViT-B/16, 6 heads of 128, {tag}",
              preset_config("vit-b-16", curve="hilbert", num_classes=1000, n_heads=6,
                            dim_head=128, depth=2, **dt), TRAIN_B, 2, False, streamed)
             for tag, dt, streamed in (("bf16", dict(dtype="bfloat16"), 2), ("fp32", {}, 0))]
    total: dict = {}
    for label, cfg, batch, layers, family_a, streamed in runs:
        for k, v in _hd_model(card, label, cfg, batch, layers, family_a,
                              streamed=streamed).items():
            total[k] = total.get(k, 0) + v
    return total


# -- 18. long context at the JAX CLI's own fp32: #8-#11 in float32 -----------

#: (label, b, nq, nk, heads, dh, packed) of the fp32 flash kernels' checks:
#: the shapes phase 18's models give #8-#11 (CurveViT-S/12's 4,096 tokens:
#: #8's single step and #9; longctx-16k's 16,384: #8 streaming, #10, #11;
#: each at 3 heads of 128, and CurveViT-S/12 at 6 heads of 256), a ragged
#: nq != nk past both gates at Dh 256 (#8 streaming, #10 and #11 at C = 4)
#: and the 1-D tokenizer's 1,089 tokens (#8 on the projection's views,
#: rows of odd length).
FLASH_F32_CASES = (("CurveViT-S/12", VS_B, VS_N, VS_N, 6, 64, True),
                   ("longctx-16k", LC_B, LC_N, LC_N, 6, 64, True),
                   ("CurveViT-S/12, 3 heads of 128", 8, VS_N, VS_N, 3, 128, True),
                   ("longctx-16k, 3 heads of 128", LC_B, LC_N, LC_N, 3, 128, True),
                   ("CurveViT-S/12, 6 heads of 256", 8, VS_N, VS_N, 6, 256, True),
                   ("ragged, Dh 256", 1, 8300, 9000, 2, 256, False),
                   ("1-D tokenizer, 33 x 33 px", NB_B, 1089, 1089, 4, 64, True))
#: The kernel-line entries of #8-#11's fp32 forms and the case each one's
#: numbers come from (the others are printed and listed by head dim).
FLASH_F32_ENTRIES = {"flash_attention_f32": "longctx-16k",
                     "flash_attention_fused_bwd_f32": "CurveViT-S/12",
                     "flash_attention_dq_f32": "longctx-16k",
                     "flash_attention_dkv_f32": "longctx-16k"}
_FLASH_F32_COUNTS = (("flash_attention_f32", "f32_launches"),
                     ("flash_attention_fused_bwd_f32", "f32_fused_bwd_launches"),
                     ("flash_attention_dq_f32", "f32_dq_launches"),
                     ("flash_attention_dkv_f32", "f32_dkv_launches"),
                     ("flash_attention", "launches"),
                     ("flash_attention_fused_bwd", "fused_bwd_launches"),
                     ("flash_attention_dq", "dq_launches"),
                     ("flash_attention_dkv", "dkv_launches"))
LC_F32_STEPS, LC_F32_STEPS_WIDE = 4, 2


#: Every flash and curve-local counter, by kernel-line entry.
_LONG_COUNTS = (*((name, flash.flash_attention, attr) for name, attr in _FLASH_F32_COUNTS),
                ("local_block_attention", local.local_block_attention, "launches"),
                ("local_block_attention_bwd", local.local_block_attention, "bwd_launches"),
                ("local_block_attention_f32", local.local_block_attention, "f32_launches"),
                ("local_block_attention_bwd_f32", local.local_block_attention,
                 "f32_bwd_launches"))
def _long_counts() -> dict:
    return {name: getattr(obj, attr) for name, obj, attr in _LONG_COUNTS}


def _reset_long_counts() -> None:
    for _, obj, attr in _LONG_COUNTS:
        setattr(obj, attr, 0)


def _flash_case(card: str, gen, label, b, nq, nk, h, dh, packed,
                    dtype=torch.float32) -> dict:
    """#8 (in JAX's form for nk) and #9 or #10 + #11 (by JAX's gate) in
    fp32 (or, phase 19, bf16) at one shape: each output against its plain
    version within F32_TOL (bf16: FLASH_TOL) of its largest |value|, the
    lse against fp64, every output bit for bit on a second call; then each
    timed in turns with its plain version, beside its bound (nominal
    operations, 4 Nq Nk Dh for #8, 10 for #9, 6 for #10, 8 for #11, at
    3xTF32's 165 TFLOP/s, bf16's 989; the bytes of q, k, v, g, out, lse and
    the outputs at 3.35 TB/s) and SDPA in the same dtype (forward; its
    autograd backward for the backward kernels) on contiguous [B, H, N, Dh]
    copies.  In bf16 the streaming forward's plain version runs the
    kernel's 128-key steps, and #9 (at Dh 128 and 256 the dq and dk/dv
    kernels) is held against #10's and #11's plain versions fed the same
    lse and delta and against JAX's fused formula within FLASH_FUSED_TOL.
    Returns {entry: row}."""
    f32 = dtype == torch.float32
    tol, es, sfx, peak = (F32_TOL, 4, "_f32", 165e9) if f32 else (FLASH_TOL, 2, "", 989e9)
    s = dh ** -0.5
    if packed:
        qkv = _randn(gen, b, nq, 3 * h * dh, dtype=dtype)
        q, k, v = qkv.view(b, nq, 3, h, dh).unbind(2)
    else:
        q, k, v = (_randn(gen, b, n, h, dh, dtype=dtype) for n in (nq, nk, nk))
    g = _randn(gen, b, nq, h, dh, dtype=dtype)
    shape = f"q [{b}, {nq}, {h}, {dh}], k/v [{b}, {nk}, {h}, {dh}]{' views of qkv' if packed else ''}"
    single, fused = flash.uses_single_kstep(nk), flash.uses_fused_bwd(nq, nk)
    block_k = None if f32 or single else STREAM_BK

    def bound(ops: float, nbytes: float) -> dict:
        return _bound_f32(0.0, nbytes, ops) if f32 else _bound(ops, nbytes)
    print(f"{'fp32' if f32 else 'bf16'} flash, {label}: {shape}, "
          f"#8 {'single step' if single else 'streaming'}, {'#9' if fused else '#10 + #11'}:")
    rows = {}
    with torch.no_grad():
        out, lse = flash.flash_fwd(q, k, v, s, return_lse=True)
        err = _frac_err("out", out, flash.flash_fwd_ref(q, k, v, s, block_k=block_k), tol)
        lse_err, lse_ok = _agree(lse, _lse64_chunked(q, k, s), **LSE_TOL)
        print(f"  lse: max abs err {lse_err:.4g} against fp64")
        _check(lse_ok, f"{label}: #8's lse disagrees with the fp64 log-sum-exp")
        _check(torch.equal(flash.flash_fwd(q, k, v, s), out), f"{label}: #8 not bit for bit")
        if f32:
            # The fp32 forward's workspace (K's and V's split parts, the
            # pre-pass's output): the call's peak beyond what it returns.
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            again = flash.flash_fwd(q, k, v, s)
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - before - again.numel() * es
            ws = (es * _build.flash_f32_workspace(b, nk, h, dh)
                  if _build.flash_f32_prepass(dh, False) else 0)
            del again
            print(f"  #8's workspace: {ws / 2**20:.1f} MiB of K's and V's split parts; the "
                  f"call's peak beyond its output {extra / 2**20:.1f} MiB, {card}")
            _check(extra <= ws + 2**21, f"{label}: #8's peak memory past its workspace")
        io = es * b * h * dh * (nq + nk)
        rows["flash_attention" + sfx] = dict(
            errs=[err], shape=shape, form="single step" if single else "streaming",
            **bound(4 * b * h * nq * nk * dh, 2 * io + 4 * b * h * nq))
        delta = flash.flash_delta(g, out)
        if fused:
            def kern():
                return flash.flash_fused_bwd(q, k, v, out, lse, g, s)

            def plain():
                if f32:
                    return flash.flash_fused_bwd_ref(q, k, v, g, s)
                return (flash.flash_dq_ref(q, k, v, g, lse, delta, s),
                        *flash.flash_dkv_ref(q, k, v, g, lse, delta, s))
            parts = {"flash_attention_fused_bwd" + sfx: (kern, plain, 10, ("dq", "dk", "dv"))}
            if not f32:
                for nm, a, w in zip(("dq", "dk", "dv"), kern(),
                                    flash.flash_fused_bwd_ref(q, k, v, g, s)):
                    _frac_err(f"{nm} against JAX's fused formula", a, w, FLASH_FUSED_TOL)
        else:
            parts = {"flash_attention_dq" + sfx: (
                         lambda: (flash.flash_dq(q, k, v, g, lse, delta, s),),
                         lambda: (flash.flash_dq_ref(q, k, v, g, lse, delta, s),), 6, ("dq",)),
                     "flash_attention_dkv" + sfx: (
                         lambda: flash.flash_dkv(q, k, v, g, lse, delta, s),
                         lambda: flash.flash_dkv_ref(q, k, v, g, lse, delta, s), 8,
                         ("dk", "dv"))}
        for name, (kern, plain, ops, names) in parts.items():
            got, want = kern(), plain()
            errs = [_frac_err(nm, a, w, tol) for nm, a, w in zip(names, got, want)]
            _check(all(torch.equal(a, c) for a, c in zip(got, kern())),
                   f"{label}: {name} not bit for bit on a second call")
            del got, want
            rows[name] = dict(errs=errs, shape=shape, **bound(
                ops * b * h * nq * nk * dh,
                2 * io + 8 * b * h * nq + es * b * h * dh * (2 * nq + nk)))
            t = rows[name]
            t["ms"], t["plain_ms"] = _ab_ms(kern, plain, iters=3)
        t = rows["flash_attention" + sfx]
        t["ms"], t["plain_ms"] = _ab_ms(
            lambda: flash.flash_fwd(q, k, v, s),
            lambda: flash.flash_fwd_ref(q, k, v, s, block_k=block_k), iters=3)
    lib_fwd, lib_bwd = _sdpa_ms(q, k, v, g)
    for name, t in rows.items():
        t["library_ms"] = lib_fwd if name == "flash_attention" + sfx else lib_bwd
        nominal = t["bound_ms"] * peak if t["bound_by"] == "operations" else None
        print(f"  {name}: kernel {t['ms']:.3f} ms"
              + (f" ({_tflops(nominal, t['ms'])} nominal)" if nominal else "")
              + f", plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms "
              f"({t['bound_by']}), SDPA {'fp32' if f32 else 'bf16'} "
              f"{'forward' if name == 'flash_attention' + sfx else 'backward'} "
              f"{t['library_ms']:.3f} ms; max abs err {max(t['errs']):.4g}; {shape}, {card}")
    del q, k, v, g, out, lse, delta
    torch.cuda.empty_cache()
    return rows


def _lse_rows_case(card: str, gen, b, n, h, dh, dtype) -> None:
    """``flash_attention_with_lse`` on the card (#8 with its lse) and
    ``attention_rows`` of a few queries from it against fp64 softmax rows:
    within F32_TOL of the largest weight, each row summing to 1 within
    F32_TOL."""
    qkv = _randn(gen, b, n, 3 * h * dh, dtype=dtype)
    q, k, v = qkv.view(b, n, 3, h, dh).unbind(2)
    before = _long_counts()
    with torch.no_grad():
        out, lse = flash.flash_attention_with_lse(q, k, v)
    after = _long_counts()
    name = "flash_attention_f32" if dtype == torch.float32 else "flash_attention"
    _check(after[name] == before[name] + 1, f"flash_attention_with_lse: launches {after}")
    queries = [0, 1, n // 2, n - 1]
    rows = attention_rows(q, k, lse, queries)
    qd, kd = q[:, queries].double(), k.double()
    want = torch.softmax(torch.einsum("brhd,bnhd->bhrn", qd, kd) * dh ** -0.5, -1)
    err, scale = float((rows.double() - want).abs().max()), float(want.abs().max())
    dev = float((rows.double().sum(-1) - 1).abs().max())
    print(f"flash_attention_with_lse, {dtype} [{b}, {n}, {h}, {dh}]: out {tuple(out.shape)}, "
          f"lse {tuple(lse.shape)}; attention_rows of queries {queries} against fp64: max abs "
          f"err {err:.3g} (max weight {scale:.3g}), row sums within {dev:.3g} of 1 (tolerance "
          f"{F32_TOL}), {card}")
    _check(err <= F32_TOL * scale and dev <= F32_TOL,
           "attention_rows from the kernel's lse disagree with fp64")


def _entry_rows(by_case: dict, name: str, primary: str) -> dict:
    """The kernel-line row of ``name`` from ``primary``'s case, its error
    the largest over every case, the other cases' numbers under "cases"."""
    held = {label: rows[name] for label, rows in by_case.items() if name in rows}
    row = dict(held[primary])
    row["max_abs_err"] = max(e for r in held.values() for e in r["errs"])
    row["cases"] = {label: {k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                               "library_ms")}
                    for label, r in held.items() if label != primary}
    row.pop("errs")
    return row


def phase_flash_f32_kernels(card: str) -> dict:
    """(a) #8-#11 in fp32 at FLASH_F32_CASES (:func:`_flash_case`),
    and the LSE capture path on the card in bf16 at Dh 64 and fp32 at 64,
    128 and 256.  Returns the kernel-line rows of the four fp32 entries
    (each with its other cases by head dim)."""
    gen = torch.Generator().manual_seed(18)
    by_case = {case[0]: _flash_case(card, gen, *case) for case in FLASH_F32_CASES}
    for dh, dtype in ((64, torch.bfloat16), (64, torch.float32), (128, torch.float32),
                      (256, torch.float32)):
        _lse_rows_case(card, gen, 2, 4096, 2, dh, dtype)
    res = {name: _entry_rows(by_case, name, primary)
           for name, primary in FLASH_F32_ENTRIES.items()}
    res["flash_attention_f32"]["single_step"] = {
        k: by_case["CurveViT-S/12"]["flash_attention_f32"][k]
        for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    return res


def _long_model(card: str, label: str, cfg, batch: int, steps: int, bwd: str,
                family_a: bool = False, timed: bool = False) -> dict:
    """One long-context model on the card (phases 18 and 19), in bf16 or
    at its own fp32: ``Trainer.fit`` for ``steps`` steps at ``batch`` plus
    an eval batch (family A: the eval forward only), every loss finite,
    every parameter moved; the launches of the flash and curve-local
    kernels in the model's dtype (the ``_f32`` entries in fp32) at layers x
    forwards and layers x steps (a global layer's backward ``bwd``:
    "fused_bwd" or "dq" + "dkv"), every other counter at 0; one step's
    gradients against the plain path within GRAD_REL_TOL (bf16) or
    F32_GRAD_REL_TOL (fp32) relative L2, the eval logits within
    FA_LOGIT_TOL or F32_TOL of the largest |logit|; a ``ServingEngine`` in
    the model's dtype answers 1 and ``batch`` images (#8 and #12 launched
    twice a layer), logits against the plain path's.  Returns the launch
    counts."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    f32 = cfg.dtype is None
    _check(not f32 or all(p.dtype == torch.float32 for p in model.parameters()),
           f"{label}: not fp32")
    sfx = "_f32" if f32 else ""
    logit_tol, grad_tol = (F32_TOL, F32_GRAD_REL_TOL) if f32 else (FA_LOGIT_TOL, GRAD_REL_TOL)
    impls = (cfg.attn_impl,) * cfg.depth if isinstance(cfg.attn_impl, str) else cfg.attn_impl
    n_local = list(impls).count("local")
    n_global = cfg.depth - n_local
    tf = make_eval_transform((0.5,) * 3, (0.25,) * 3, device=DEVICE)
    test_ds = synthetic_dataset(n=batch, hw=cfg.img_size, num_classes=cfg.num_classes, seed=1)
    xe = tf(next(epoch_batches(test_ds, batch, shuffle=False, drop_last=False))[0])
    _reset_long_counts()
    want = {name: 0 for name in _long_counts()}
    if family_a:
        model.eval()
        with torch.no_grad():
            model(xe)
        torch.cuda.synchronize()
        counts = _long_counts()
        want["flash_attention" + sfx] = n_global
    else:
        train_ds = synthetic_dataset(n=batch * steps, hw=cfg.img_size,
                                     num_classes=cfg.num_classes, seed=0)
        trainer = Trainer(model, TrainConfig(num_classes=cfg.num_classes, epochs=1,
                                             warmup_epochs=1), steps_per_epoch=steps)
        before = [p.detach().clone() for p in model.parameters()]
        record = trainer.fit(
            lambda: ((tf(x), y) for x, y in epoch_batches(train_ds, batch, seed=0)),
            lambda: ((tf(x), y) for x, y in epoch_batches(test_ds, batch, shuffle=False,
                                                          drop_last=False)))
        torch.cuda.synchronize()
        counts = _long_counts()
        print(f"{label}: Trainer.fit, {steps} steps at batch {batch} + eval of "
              f"{len(test_ds)}: {record}")
        _check(bool(np.isfinite(record["train_loss"])) and
               bool(np.isfinite(record["test_loss"])), f"{label}: non-finite loss")
        _check(trainer.state.step == steps, f"{label}: {trainer.state.step} steps taken")
        still = [nm for (nm, p), q in zip(model.named_parameters(), before) if torch.equal(p, q)]
        _check(not still, f"{label}: parameters unchanged after {steps} steps: {still}")
        del before
        want["flash_attention" + sfx] = n_global * (steps + 1)
        for part in (("fused_bwd",) if bwd == "fused_bwd" else ("dq", "dkv")):
            want[f"flash_attention_{part}{sfx}"] = n_global * steps
        want["local_block_attention" + sfx] = n_local * (steps + 1)
        want["local_block_attention_bwd" + sfx] = n_local * steps
    print(f"{label}: launches of {n_global} global and {n_local} local layers: {counts}")
    _check(counts == want, f"{label}: launches {counts}, expected {want}")
    model.eval()
    with torch.no_grad():
        got = model(xe)
        with _plain_longctx():
            plain = model(xe)
    err, scale = float((got.float() - plain.float()).abs().max()), float(plain.abs().max())
    print(f"{label}: eval logits [{batch}, {cfg.num_classes}] vs plain path max abs err "
          f"{err:.4g} (max |logit| {scale:.4g}; tolerance {logit_tol} x max |logit|)")
    _check(bool(torch.isfinite(got).all()) and err <= logit_tol * scale,
           f"{label}: eval logits disagree with the plain path")

    if not family_a:
        x, y = next(epoch_batches(train_ds, batch, seed=0))
        data = (tf(x), torch.from_numpy(y).long().to(DEVICE))
        model.train()
        state = _lr_zero_state(model)
        step = make_train_step(cfg.num_classes, use_mixing=False)
        m_k = step(state, data, torch.Generator())
        grads = {nm: p.grad.detach().clone() for nm, p in model.named_parameters()}
        with _plain_longctx():
            m_p = step(state, data, torch.Generator())
        rel = {nm: float((grads[nm].float() - p.grad.float()).norm() / p.grad.float().norm())
               for nm, p in model.named_parameters()}
        worst = max(rel, key=rel.get)
        print(f"{label}: one train step, kernels vs plain path: loss {float(m_k['loss']):.6f} "
              f"vs {float(m_p['loss']):.6f}; gradient relative L2 error max {rel[worst]:.4g} "
              f"({worst}), median {float(np.median(list(rel.values()))):.4g} over {len(rel)} "
              f"tensors (tolerance {grad_tol})")
        _check(rel[worst] <= grad_tol, f"{label}: kernel-path gradients disagree with the "
               "plain path")
        del grads
        if timed:
            def step_ms(plain: bool) -> float:
                with _plain_longctx() if plain else contextlib.nullcontext():
                    step(state, data, torch.Generator())
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    for _ in range(2):
                        step(state, data, torch.Generator())
                    torch.cuda.synchronize()
                return (time.perf_counter() - t1) / 2 * 1e3
            k_ms, p_ms = step_ms(False), step_ms(True)
            n_tok = (cfg.img_size // cfg.patch_size) ** 2
            print(f"{label}: train step at batch {batch}: kernels {k_ms:.1f} ms = "
                  f"{batch * n_tok / k_ms * 1e3:.0f} tokens/s, plain path {p_ms:.1f} ms = "
                  f"{batch * n_tok / p_ms * 1e3:.0f} tokens/s, {card}")
            busy = _profile(lambda: step(state, data, torch.Generator()),
                            f"{label} train step at batch {batch}", steps=1)
            if busy is not None and label in BUSY_BEFORE:
                was, src = BUSY_BEFORE[label]
                print(f"{label}: device busy {busy:.2f} ms a step against {was} ms "
                      f"({src}), {busy / was - 1:+.1%}, {card}")
        del state, data

    engine = ServingEngine(copy.deepcopy(model), None, (cfg.img_size, cfg.img_size, 3),
                           batch_sizes=(1, batch), dtype=None if f32 else torch.bfloat16,
                           device=DEVICE)
    rng = np.random.default_rng(18)
    requests = [rng.standard_normal((k, cfg.img_size, cfg.img_size, 3), dtype=np.float32)
                for k in (1, batch)]
    _reset_long_counts()
    outs = np.concatenate([engine.predict(r) for r in requests])
    served = _long_counts()
    want = {name: 0 for name in served}
    want["flash_attention" + sfx] = 2 * n_global
    want["local_block_attention" + sfx] = 2 * n_local
    _check(served == want, f"{label}: served launches {served}, expected {want}")
    with _plain_longctx():
        plain = np.concatenate([engine.predict(r) for r in requests])
    err, scale = float(np.abs(outs - plain).max()), float(np.abs(plain).max())
    print(f"{label}: served 1 and {batch} images; launches {served}; logits vs plain path max "
          f"abs err {err:.4g} (max |logit| {scale:.4g}; tolerance {logit_tol} x max |logit|); "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{time.perf_counter() - t0:.1f} s, {card}")
    _check(bool(np.isfinite(outs).all()) and err <= logit_tol * scale,
           f"{label}: served logits disagree with the plain path")
    del model, engine
    torch.cuda.empty_cache()
    return {k: counts[k] + served[k] for k in counts}


def phase_flash_f32_models(card: str) -> dict:
    """(b) The long-context models at the JAX CLI's own fp32, through #8-#11
    in fp32: CurveViT-S/12 at 4,096 tokens as its preset is (no dtype;
    batch 16, 4 steps: #8's single step and #9), longctx-16k at
    ``dtype=None`` (batch 2, 4 steps: #8 streaming, #10, #11), both again
    at 3 heads of ``dim_head`` 128 and CurveViT-S/12 at ``dim_head`` 256
    (depth 2, 2 steps, batch 8 and 2), and the 1-D tokenizer over 33 x 33
    pixels at patch 1 (1,089 tokens; family A's eval and serving through
    #8 on the projection's views).  longctx-16k at 3 heads of 128 is also
    timed and profiled (one step: busy ms, idle share, top kernels; its
    busy time beside BUSY_BEFORE's, ``scripts/profile_longctx_f32_step.py``
    on the parent tree).  Returns the summed launch counts."""
    vs = dict(img_size=256, patch_size=4, num_classes=1000)
    fused, pair = "fused_bwd", "dq"
    runs = [("CurveViT-S/12 at 4,096 tokens, fp32", preset_config("vit-s-16", **vs), VS_B,
             LC_F32_STEPS, fused, dict(timed=True)),
            ("longctx-16k at dtype=None", preset_config("longctx-16k", dtype=None), LC_B,
             LC_F32_STEPS, pair, dict(timed=True)),
            ("CurveViT-S/12, 3 heads of 128, fp32",
             preset_config("vit-s-16", n_heads=3, dim_head=128, depth=2, **vs), 8,
             LC_F32_STEPS_WIDE, fused, {}),
            ("longctx-16k, 3 heads of 128, fp32",
             preset_config("longctx-16k", dtype=None, n_heads=3, dim_head=128, depth=2), LC_B,
             LC_F32_STEPS_WIDE, pair, dict(timed=True)),
            ("CurveViT-S/12, 6 heads of 256, fp32",
             preset_config("vit-s-16", dim_head=256, depth=2, **vs), 8, LC_F32_STEPS_WIDE,
             fused, {}),
            ("1-D tokenizer over 33 x 33 px at patch 1, fp32",
             preset_config("notebook", tokenizer="1d", img_size=33, patch_size=1), NB_B, 0,
             "", dict(family_a=True))]
    total: dict = {}
    for label, cfg, batch, steps, bwd, kw in runs:
        for k, v in _long_model(card, label, cfg, batch, steps, bwd, **kw).items():
            total[k] = total.get(k, 0) + v
    return total


# -- phase 19: long context at every head dim and dtype JAX sends ----------

#: #8-#11 in bf16 at head dims 128 and 256, at phase 18's long-context
#: shapes past Dh 64 ((label, b, nq, nk, heads, dh, packed)): #8's single
#: step and #9 at CurveViT-S/12's 4,096 tokens, #8 streaming, #10 and #11
#: at longctx-16k's 16,384 and at a ragged 8,300 x 9,000.
WIDE_CASES = (("CurveViT-S/12, 3 heads of 128", 8, VS_N, VS_N, 3, 128, True),
              ("longctx-16k, 3 heads of 128", LC_B, LC_N, LC_N, 3, 128, True),
              ("CurveViT-S/12, 6 heads of 256", 8, VS_N, VS_N, 6, 256, True),
              ("ragged, Dh 256", 1, 8300, 9000, 2, 256, False))
#: The kernel-line entries of #8-#11 in bf16 and the case each one's
#: numbers at the new head dims come from.
WIDE_ENTRIES = {"flash_attention": "longctx-16k, 3 heads of 128",
                "flash_attention_fused_bwd": "CurveViT-S/12, 3 heads of 128",
                "flash_attention_dq": "longctx-16k, 3 heads of 128",
                "flash_attention_dkv": "longctx-16k, 3 heads of 128"}
#: #12/#13 at block 128, halo 1 ((label, dtype, b, n, heads, dh, packed)):
#: in fp32 at the hybrid preset's 16,384 tokens with its 6 heads of 64 and
#: at 3 heads of 128, a ragged length at Dh 256; in bf16 at 3 heads of 128,
#: 2 of 256 and a ragged length.  The first of each dtype is the kernel
#: line's row.
LOCAL_WIDE_CASES = (
    ("longctx-16k-hybrid, fp32", torch.float32, LC_B, LC_N, LC_HEADS, 64, True),
    ("longctx-16k-hybrid, 3 heads of 128, fp32", torch.float32, LC_B, LC_N, 3, 128, True),
    ("ragged 5,000, Dh 256, fp32", torch.float32, 1, 5000, 2, 256, False),
    ("longctx-16k-hybrid, 3 heads of 128, bf16", torch.bfloat16, LC_B, LC_N, 3, 128, True),
    ("16,384 tokens, 2 heads of 256, bf16", torch.bfloat16, LC_B, LC_N, 2, 256, True),
    ("ragged 5,000, Dh 128, bf16", torch.bfloat16, 1, 5000, 2, 128, False))
WIDE_STEPS = 2
#: The device-busy ms of a timed phase-19 train step in an earlier tree's
#: run on an H100 80GB HBM3 at 700 W, printed beside this run's.
BUSY_BEFORE = {"longctx-16k, 3 heads of 128, bf16":
               (48.94, "the tree before the wide forward's redesign"),
               "longctx-16k, 3 heads of 128, fp32":
               (152.66, "the tree before the fp32 forward's redesign at every head dim, "
                        "this phase's profile")}
def _local_lse64(q, k, block: int, halo: int, scale: float) -> torch.Tensor:
    """The fp64 log-sum-exp of each query's scaled logits over its
    curve-local window, [B, H, N]."""
    n = q.shape[1]
    out = torch.empty(q.shape[0], q.shape[2], n, dtype=torch.float64, device=q.device)
    for j in range(-(-n // block)):
        q0, q1 = j * block, min(n, (j + 1) * block)
        lo, hi = local.window(j, n, block, halo)
        qd, kd = q[:, q0:q1].double().transpose(1, 2), k[:, lo:hi].double().transpose(1, 2)
        out[:, :, q0:q1] = torch.logsumexp((qd @ kd.transpose(-1, -2)) * scale, dim=-1)
    return out


def _local_wide_case(card: str, gen, label, dtype, b, n, h, dh, packed) -> dict:
    """#12 (out and lse) and #13 (dq, dk, dv) at block 128, halo 1 in
    ``dtype`` at one shape: each against its plain version within F32_TOL
    (fp32) or FLASH_TOL (bf16) of its largest |value|, the lse against the
    window's fp64 log-sum-exp, both bit for bit on a second call; each
    timed in turns with its plain version beside its bound (4 and 10
    nominal operations a (query, key) pair of the window: bf16 at 989
    TFLOP/s, fp32 as 3xTF32 at 165) and SDPA in the same dtype with a band
    mask.  Returns {entry: row}."""
    f32 = dtype == torch.float32
    tol, es, sfx = (F32_TOL, 4, "_f32") if f32 else (FLASH_TOL, 2, "")
    s, blk, halo = dh ** -0.5, LOCAL_BLOCK, LOCAL_HALO
    if packed:
        qkv = _randn(gen, b, n, 3 * h * dh, dtype=dtype)
        q, k, v = qkv.view(b, n, 3, h, dh).unbind(2)
    else:
        q, k, v = (_randn(gen, b, n, h, dh, dtype=dtype) for _ in range(3))
    g = _randn(gen, b, n, h, dh, dtype=dtype)
    shape = f"[{b}, {n}, {h}, {dh}] {'fp32' if f32 else 'bf16'}{' views of qkv' if packed else ''}"
    print(f"#12 / #13, {label}: block {blk}, halo {halo}, q/k/v {shape}:")
    pairs = _window_pairs(n, blk, halo)
    rows = {}
    with torch.no_grad():
        out, lse = local.local_fwd(q, k, v, blk, halo, s, return_lse=True)
        want = local.local_fwd_ref(q, k, v, blk, halo, s)
        err = _frac_err("out", out, want, tol)
        lse_err, lse_ok = _agree(lse, _local_lse64(q, k, blk, halo, s), **LSE_TOL)
        print(f"  lse: max abs err {lse_err:.4g} against the window's fp64 log-sum-exp")
        _check(lse_ok, f"{label}: #12's lse disagrees with fp64")
        again, again_lse = local.local_fwd(q, k, v, blk, halo, s, return_lse=True)
        _check(torch.equal(out, again) and torch.equal(lse, again_lse),
               f"{label}: #12 not bit for bit on a second call")
        del want, again, again_lse
        delta = flash.flash_delta(g, out)
        got = local.local_bwd(q, k, v, g, lse, delta, blk, halo, s)
        errs = [_frac_err(nm, x, w, tol) for nm, x, w in zip(
            ("dq", "dk", "dv"), got, local.local_bwd_ref(q, k, v, g, lse, delta, blk, halo, s))]
        _check(all(torch.equal(x, y) for x, y in zip(
            got, local.local_bwd(q, k, v, g, lse, delta, blk, halo, s))),
            f"{label}: #13 not bit for bit on a second call")
        del got
        io = es * b * n * h * dh
        fwd_b, bwd_b = 4 * io + 4 * b * h * n, 7 * io + 8 * b * h * n
        fwd_ops, bwd_ops = 4 * b * h * pairs * dh, 10 * b * h * pairs * dh
        rows["local_block_attention" + sfx] = dict(
            errs=[err], shape=shape,
            **(_bound_f32(0.0, fwd_b, fwd_ops) if f32 else _bound(fwd_ops, fwd_b)))
        rows["local_block_attention_bwd" + sfx] = dict(
            errs=errs, shape=shape,
            **(_bound_f32(0.0, bwd_b, bwd_ops) if f32 else _bound(bwd_ops, bwd_b)))
        t = rows["local_block_attention" + sfx]
        t["ms"], t["plain_ms"] = _ab_ms(
            lambda: local.local_fwd(q, k, v, blk, halo, s, return_lse=True),
            lambda: local.local_fwd_ref(q, k, v, blk, halo, s, return_lse=True), iters=3)
        t = rows["local_block_attention_bwd" + sfx]
        t["ms"], t["plain_ms"] = _ab_ms(
            lambda: local.local_bwd(q, k, v, g, lse, delta, blk, halo, s),
            lambda: local.local_bwd_ref(q, k, v, g, lse, delta, blk, halo, s), iters=3)
    mask = _band_mask(n, blk, halo)
    lib_fwd, lib_bwd = _sdpa_masked_ms(q, k, v, g, mask)
    del mask
    for name, t in rows.items():
        t["library_ms"] = lib_fwd if "bwd" not in name else lib_bwd
        print(f"  {name}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), SDPA with a band mask "
              f"{'backward' if 'bwd' in name else 'forward'} {t['library_ms']:.4f} ms; "
              f"max abs err {max(t['errs']):.4g}; {shape}, {card}")
    del q, k, v, g, out, lse, delta
    torch.cuda.empty_cache()
    return rows


def phase_wide_kernels(card: str) -> dict:
    """(19a) #8-#11 in bf16 at head dims 128 and 256 (:func:`_flash_case`
    in bf16 at WIDE_CASES: the streaming forward against its plain version
    at 128-key steps, #9 as the dq and dk/dv kernels against their plain
    versions fed the same lse and delta, and against JAX's fused formula
    within FLASH_FUSED_TOL) and #12/#13 in fp32 at Dh 64, 128, 256 and in
    bf16 at 128 and 256 (:func:`_local_wide_case` at LOCAL_WIDE_CASES).
    Returns {"rows": the fp32 local entries' kernel-line rows, "wide": the
    bf16 entries' rows at the new head dims}."""
    gen = torch.Generator().manual_seed(19)
    wide = {case[0]: _flash_case(card, gen, *case, dtype=torch.bfloat16)
            for case in WIDE_CASES}
    local_rows = {case[0]: _local_wide_case(card, gen, *case) for case in LOCAL_WIDE_CASES}
    out = {name: _entry_rows(wide, name, primary) for name, primary in WIDE_ENTRIES.items()}
    for sfx, primary in (("", "longctx-16k-hybrid, 3 heads of 128, bf16"),
                         ("_f32", "longctx-16k-hybrid, fp32")):
        for name in ("local_block_attention", "local_block_attention_bwd"):
            out[name + sfx] = _entry_rows(local_rows, name + sfx, primary)
    return out


def phase_wide_models(card: str) -> dict:
    """(19b) The long-context paths at every head dim and dtype JAX sends
    to #8-#13, each trained, evaluated and served (:func:`_long_model`):
    ``longctx-16k-hybrid`` at ``dtype=None`` (the JAX CLI's own fp32; #12/#13
    fp32 in its three local layers, #8/#10/#11 fp32 in the global one;
    batch 2, 4 steps), ``longctx-16k`` at 3 heads of 128 in its preset's
    bf16 (#8 streaming, #10, #11 at Dh 128; depth 4, batch 2, 4 steps),
    the same with the hybrid's schedule in bf16 and at ``dtype=None``
    (#12/#13 at Dh 128 in both dtypes; 2 steps), and CurveViT-S/12 at 4,096
    tokens in bf16 at 3 heads of 128 and 6 of 256 (#8's single step and #9;
    depth 2, batch 8 and 2, 2 steps).  Returns the summed launch counts."""
    vs = dict(img_size=256, patch_size=4, num_classes=1000, dtype="bfloat16")
    hybrid = ("local", "local", "local", "auto")
    wide = dict(n_heads=3, dim_head=128)
    runs = [("longctx-16k-hybrid at dtype=None",
             preset_config("longctx-16k-hybrid", dtype=None), LC_B, LC_STEPS, "dq",
             dict(timed=True)),
            ("longctx-16k, 3 heads of 128, bf16", preset_config("longctx-16k", **wide), LC_B,
             LC_STEPS, "dq", dict(timed=True)),
            ("longctx-16k hybrid schedule, 3 heads of 128, bf16",
             preset_config("longctx-16k", attn_impl=hybrid, **wide), LC_B, WIDE_STEPS, "dq",
             {}),
            ("longctx-16k hybrid schedule, 3 heads of 128, dtype=None",
             preset_config("longctx-16k", attn_impl=hybrid, dtype=None, **wide), LC_B,
             WIDE_STEPS, "dq", {}),
            ("CurveViT-S/12, 3 heads of 128, bf16",
             preset_config("vit-s-16", n_heads=3, dim_head=128, depth=2, **vs), 8, WIDE_STEPS,
             "fused_bwd", {}),
            ("CurveViT-S/12, 6 heads of 256, bf16",
             preset_config("vit-s-16", dim_head=256, depth=2, **vs), 2, WIDE_STEPS,
             "fused_bwd", {})]
    total: dict = {}
    for label, cfg, batch, steps, bwd, kw in runs:
        for k, v in _long_model(card, label, cfg, batch, steps, bwd, **kw).items():
            total[k] = total.get(k, 0) + v
    return total


# -- 20. #4's and #6's attention backward past the resident form's limits -----

#: (label, b, n, heads, dh, masked): the streamed form's shapes (every one
#: past ATTENTION_BWD_SM90_LIMITS): 'hier''s fusion layers at 2 heads and
#: the flagship at 3 (#6 with the mask, and #4 at the same shape), the
#: notebook's 1-D tokenizer at patch 4 and at patch 1 over 32 x 32 px
#: (#6), ViT-B/16 at 384 px and at 6 heads of 128 (#4).
STREAM_CASES = (("'hier' fusion, 2 heads", 512, 192, 2, 128, True),
                ("'hier' fusion, 2 heads", 512, 192, 2, 128, False),
                ("flagship, 3 heads", 512, 64, 3, 256, True),
                ("flagship, 3 heads", 512, 64, 3, 256, False),
                ("1-D tokenizer, patch 4", 512, 256, 4, 64, True),
                ("1-D tokenizer, patch 1", NB_B, 1024, 4, 64, True),
                ("ViT-B/16 at 384 px", 64, 576, 12, 64, False),
                ("ViT-B/16, 6 heads of 128", TRAIN_B, 196, 6, 128, False))
#: The kernel-line entries and the row of STREAM_CASES each one's numbers
#: come from (the others are listed in its ``cases``).
STREAM_ENTRIES = {"attention_bwd_streamed": 6, "attention_bwd_streamed_masked": 0}
STREAM_STEPS = 4


def phase_stream_kernels(card: str) -> dict:
    """(a) The streamed form of #4's and #6's attention backward
    (csrc/attention_bwd_stream_sm90.cu) alone at STREAM_CASES, through
    ``_build.attention_bwd`` (its route there): against ``attention_bwd_ref``
    within BWD_TOL of the largest |value| and bit for bit on a second call,
    timed in turns with the plain version, beside SDPA's bf16 autograd
    backward on contiguous [B, H, N, Dh] q, k, v without the mask (a
    yardstick of the unmasked work) and the bound (10 B H N^2 Dh
    operations; qkv, att, datt, lse and the mask read, dqkv written).
    Returns the two kernel-line entries' numbers."""
    gen = torch.Generator().manual_seed(24)
    rows = []
    for label, b, n, h, dh, masked in STREAM_CASES:
        _check(_build.attention_bwd_route(dh, n, masked) == "streamed",
               f"{label}: [{b}, {n}, {h} x {dh}] is not on the streamed form")
        s = dh ** -0.5
        qkv = _randn(gen, b, n, 3 * h * dh)
        datt = _randn(gen, b, n, h * dh)
        mask = torch.rand(b, h, n, n, generator=gen).lt(FA_KEEP).to(DEVICE) if masked else None
        kw = dict(mask=mask, keep=FA_KEEP) if masked else {}
        att, lse = attention_fwd_ref(qkv, h, n, s, **kw)

        def kern():
            return _build.attention_bwd(qkv, att, datt, lse, h, n, s, **kw)

        def plain():
            return attention_bwd_ref(qkv, att, datt, lse, h, n, s, **kw)
        shape = f"[{b}, {n}, {h} x {dh}]{' with the mask' if masked else ''}"
        got = kern()
        err = _frac_err(f"streamed backward, {label} {shape}", got, plain(), BWD_TOL)
        _check(torch.equal(got, kern()), f"{label} {shape}: not bit for bit on a second call")
        ms, plain_ms = _ab_ms(kern, plain, iters=10)
        q, k, v = qkv.view(b, n, 3, h, dh).unbind(2)
        _, sdpa_ms = _sdpa_ms(q, k, v, datt.view(b, n, h, dh))
        flops = 10 * b * h * n * n * dh
        nbytes = 2 * b * n * h * dh * (3 + 2 + 3) + 4 * b * h * n + (b * h * n * n if masked
                                                                       else 0)
        bound = _bound(flops, nbytes)
        print(f"streamed backward: {label} {shape}: kernel {ms:.4f} ms, plain (attention_bwd_ref) "
              f"{plain_ms:.4f} ms, SDPA backward{' without the mask' if masked else ''} "
              f"{sdpa_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP), {bound['bound_ms'] / ms:.1%} "
              f"of it, max abs err {err:.4g}; {card}")
        rows.append(dict(label=label, shape=[b, n, h, dh], masked=masked, ms=ms,
                         plain_ms=plain_ms, library_ms=sdpa_ms, max_abs_err=err, **bound))
        del qkv, datt, mask, att, lse, got, q, k, v
        torch.cuda.empty_cache()
    return {name: dict(rows[i], cases=[r for r in rows if r["masked"] == rows[i]["masked"]])
            for name, i in STREAM_ENTRIES.items()}


def phase_stream_models(card: str) -> dict:
    """(b) The models whose every attention backward is on the streamed
    form, in bf16 at full depth: the notebook's 1-D tokenizer at patch 1
    over 32 x 32 px (1,024 tokens, JAX's longest #6 row; batch 32, dropout
    0.1: #5 in two passes, #6 streamed) and ViT-B/16 at 384 px, the
    published fine-tuning resolution (576 tokens; batch 64: #1 in two
    passes, #4 streamed), each STREAM_STEPS steps of ``Trainer.fit``, an
    eval batch and ``ServingEngine``, launch counts = layers x steps (the
    streamed form's too) or forwards, one step's gradients and the served
    logits against the plain path.  Returns the summed launch counts."""
    runs = (("notebook 1-D patch 1 over 32 x 32 px, bf16",
             preset_config("notebook", tokenizer="1d", patch_size=1, dtype="bfloat16"),
             NB_B, True),
            ("ViT-B/16 at 384 px, bf16", preset_config("vit-b-16", img_size=384,
                                                       dtype="bfloat16"), 64, False))
    total: dict = {}
    for label, cfg, batch, family_a in runs:
        for k, v in _hd_model(card, label, cfg, batch, cfg.depth, family_a, steps=STREAM_STEPS,
                              streamed=cfg.depth).items():
            total[k] = total.get(k, 0) + v
    return total


def _plain_forward(model, x):
    """``model(x)`` through the plain blocks (a timing yardstick)."""
    def run():
        with _plain_blocks():
            return model(x)
    return run


def _timed(fn, *args, **kw):
    """``fn(*args, **kw)``, its seconds printed after it."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"phase {fn.__name__}{' (fp32)' if kw.get('f32') else ''}: "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    t0 = time.perf_counter()
    card = _timed(phase_device)
    _timed(phase_build)
    kernels = _timed(phase_kernels, card)
    kernels.update(_timed(phase_backward, card))
    launches = _timed(phase_slice, card)
    launches.update({k: v for k, v in _timed(phase_train, card).items() if k.endswith("_bwd")})
    kernels.update(_timed(phase_fa_kernels, card))
    launches.update(_timed(phase_fa_slice, card))
    kernels.update(_timed(phase_flash_kernels, card))
    launches.update(_timed(phase_longctx, card))
    kernels.update(_timed(phase_local_kernels, card))

    def add(counts: dict) -> None:
        launches.update({name: launches.get(name, 0) + n for name, n in counts.items()})

    add(_timed(phase_hybrid, card))
    kernels.update(_timed(phase_gp_kernels, card))
    launches.update(_timed(phase_fused_flagship, card))
    kernels.update(_timed(phase_tail_kernels, card))
    add(_timed(phase_tail_models, card))
    add(_timed(phase_tail_models, card, f32=True))
    kernels.update(_timed(phase_notebook_kernels, card))
    add(_timed(phase_notebook, card))
    kernels.update(_timed(phase_vit_f32_kernels, card))
    launches.update(_timed(phase_vit_f32, card))
    _timed(phase_remat, card)
    head_dims = _timed(phase_head_dim_kernels, card)
    add(_timed(phase_head_dim_models, card))
    kernels.update(_timed(phase_flash_f32_kernels, card))
    add(_timed(phase_flash_f32_models, card))
    wide = _timed(phase_wide_kernels, card)
    add(_timed(phase_wide_models, card))
    kernels.update(_timed(phase_stream_kernels, card))
    add(_timed(phase_stream_models, card))
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "sfc_vit_tpu"))
    _check(not leaked, f"the port imported {leaked}")
    entries = [
        dict(name="fused_attention_block", route="cuda",
             source="sfc_vit_tpu_torch/csrc/packed_attn_sm90.cu",
             replaces="sfc_vit_tpu/ops/fused_attention_block.py:104"),
        dict(name="fused_mlp_block", route="cuda",
             source="sfc_vit_tpu_torch/csrc/gemm_bf16.cu",
             replaces="sfc_vit_tpu/ops/fused_mlp.py:104"),
        dict(name="fused_mlp_block_bwd", route="cuda",
             source="sfc_vit_tpu_torch/csrc/gemm_bf16.cu",
             replaces="sfc_vit_tpu/ops/fused_mlp.py:237"),
        dict(name="fused_attention_block_bwd", route="cuda",
             source="sfc_vit_tpu_torch/csrc/attention_bwd_sm90.cu",
             replaces="sfc_vit_tpu/ops/fused_attention_block.py:333"),
        dict(name="fused_torch_mha", route="cuda",
             source="sfc_vit_tpu_torch/csrc/packed_attn_sm90.cu",
             replaces="sfc_vit_tpu/ops/fused_torch_attention.py:82"),
        dict(name="fused_torch_mha_bwd", route="cuda",
             source="sfc_vit_tpu_torch/csrc/attention_bwd_sm90.cu",
             replaces="sfc_vit_tpu/ops/fused_torch_attention.py:270"),
        dict(name="attention_bwd_streamed", route="cuda",
             source="sfc_vit_tpu_torch/csrc/attention_bwd_stream_sm90.cu",
             replaces="sfc_vit_tpu/ops/fused_attention_block.py:333"),
        dict(name="attention_bwd_streamed_masked", route="cuda",
             source="sfc_vit_tpu_torch/csrc/attention_bwd_stream_sm90.cu",
             replaces="sfc_vit_tpu/ops/fused_torch_attention.py:270"),
        dict(name="packed_flash_attention", route="cuda",
             source="sfc_vit_tpu_torch/csrc/packed_attn_sm90.cu",
             replaces="sfc_vit_tpu/ops/flash_attention.py:907"),
        dict(name="flash_attention", route="cuda",
             source="sfc_vit_tpu_torch/csrc/flash_fwd_sm90.cu",
             replaces="sfc_vit_tpu/ops/flash_attention.py:114"),
        dict(name="flash_attention_fused_bwd", route="cuda",
             source="sfc_vit_tpu_torch/csrc/flash_bwd_fused_sm90.cu",
             replaces="sfc_vit_tpu/ops/flash_attention.py:317"),
        dict(name="flash_attention_dq", route="cuda",
             source="sfc_vit_tpu_torch/csrc/flash_bwd_dq_sm90.cu",
             replaces="sfc_vit_tpu/ops/flash_attention.py:440"),
        dict(name="flash_attention_dkv", route="cuda",
             source="sfc_vit_tpu_torch/csrc/flash_bwd_dkv_sm90.cu",
             replaces="sfc_vit_tpu/ops/flash_attention.py:482"),
        dict(name="local_block_attention", route="cuda",
             source="sfc_vit_tpu_torch/csrc/flash_fwd_sm90.cu",
             replaces="sfc_vit_tpu/ops/local_attention.py:82"),
        dict(name="local_block_attention_bwd", route="cuda",
             source="sfc_vit_tpu_torch/csrc/flash_bwd_dkv_sm90.cu",
             replaces="sfc_vit_tpu/ops/local_attention.py:198"),
        dict(name="gather_project", route="cuda",
             source="sfc_vit_tpu_torch/csrc/gather_project.cu",
             replaces="sfc_vit_tpu/ops/gather_project.py:57"),
        dict(name="postnorm_tail", route="cuda",
             source="sfc_vit_tpu_torch/csrc/gemm_bf16.cu",
             replaces="sfc_vit_tpu/ops/fused_mlp.py:549"),
        dict(name="postnorm_tail_bwd", route="cuda",
             source="sfc_vit_tpu_torch/csrc/ln_rows_bwd.cu",
             replaces="sfc_vit_tpu/ops/fused_mlp.py:665"),
        dict(name="fused_torch_mha_f32", route="cuda",
             source="sfc_vit_tpu_torch/csrc/packed_attn_f32.cu",
             replaces="sfc_vit_tpu/ops/fused_torch_attention.py:82"),
        dict(name="fused_torch_mha_bwd_f32", route="cuda",
             source="sfc_vit_tpu_torch/csrc/attention_bwd_f32.cu",
             replaces="sfc_vit_tpu/ops/fused_torch_attention.py:270"),
        dict(name="packed_flash_attention_f32", route="cuda",
             source="sfc_vit_tpu_torch/csrc/packed_attn_f32.cu",
             replaces="sfc_vit_tpu/ops/flash_attention.py:907"),
        dict(name="gather_project_f32", route="cuda",
             source="sfc_vit_tpu_torch/csrc/gather_project_f32.cu",
             replaces="sfc_vit_tpu/ops/gather_project.py:57"),
        dict(name="colsum", route="cuda",
             source="sfc_vit_tpu_torch/csrc/colsum_bf16.cu",
             replaces="sfc_vit_tpu/ops/fused_torch_attention.py:316"),
        dict(name="fused_attention_block_f32", route="cuda",
             source="sfc_vit_tpu_torch/csrc/packed_attn_f32.cu",
             replaces="sfc_vit_tpu/ops/fused_attention_block.py:104"),
        dict(name="fused_mlp_block_f32", route="cuda",
             source="sfc_vit_tpu_torch/csrc/gemm_f32.cu",
             replaces="sfc_vit_tpu/ops/fused_mlp.py:104"),
        dict(name="fused_mlp_block_bwd_f32", route="cuda",
             source="sfc_vit_tpu_torch/csrc/gemm_f32.cu",
             replaces="sfc_vit_tpu/ops/fused_mlp.py:237"),
        dict(name="fused_attention_block_bwd_f32", route="cuda",
             source="sfc_vit_tpu_torch/csrc/attention_bwd_f32.cu",
             replaces="sfc_vit_tpu/ops/fused_attention_block.py:333"),
        dict(name="postnorm_tail_f32", route="cuda",
             source="sfc_vit_tpu_torch/csrc/gemm_f32.cu",
             replaces="sfc_vit_tpu/ops/fused_mlp.py:549"),
        dict(name="postnorm_tail_bwd_f32", route="cuda",
             source="sfc_vit_tpu_torch/csrc/ln_rows_bwd.cu",
             replaces="sfc_vit_tpu/ops/fused_mlp.py:665"),
        dict(name="flash_attention_f32", route="cuda",
             source="sfc_vit_tpu_torch/csrc/flash_fwd_f32.cu",
             replaces="sfc_vit_tpu/ops/flash_attention.py:114"),
        dict(name="flash_attention_fused_bwd_f32", route="cuda",
             source="sfc_vit_tpu_torch/csrc/flash_bwd_f32.cu",
             replaces="sfc_vit_tpu/ops/flash_attention.py:317"),
        dict(name="flash_attention_dq_f32", route="cuda",
             source="sfc_vit_tpu_torch/csrc/flash_bwd_f32.cu",
             replaces="sfc_vit_tpu/ops/flash_attention.py:440"),
        dict(name="flash_attention_dkv_f32", route="cuda",
             source="sfc_vit_tpu_torch/csrc/flash_bwd_f32.cu",
             replaces="sfc_vit_tpu/ops/flash_attention.py:482"),
        dict(name="local_block_attention_f32", route="cuda",
             source="sfc_vit_tpu_torch/csrc/flash_fwd_f32.cu",
             replaces="sfc_vit_tpu/ops/local_attention.py:82"),
        dict(name="local_block_attention_bwd_f32", route="cuda",
             source="sfc_vit_tpu_torch/csrc/flash_bwd_f32.cu",
             replaces="sfc_vit_tpu/ops/local_attention.py:198"),
    ]
    kernels.update({name: wide[name] for name in ("local_block_attention_f32",
                                                  "local_block_attention_bwd_f32")})
    for e in entries:
        k = kernels[e["name"]]
        e.update(launches=launches[e["name"]], max_abs_err=k["max_abs_err"],
                 ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
                 bound_by=k["bound_by"], library_ms=k["library_ms"])
        if "single_step" in k:  # #8's other form, timed at CurveViT-S/12's shape
            e["single_step"] = k["single_step"]
        if "cases" in k:  # the fp32 flash forms' other shapes and head dims
            e["cases"] = k["cases"]
        if e["name"] in head_dims:  # the widths past 64 and 192 held against plain
            e["head_dims"] = head_dims[e["name"]]
        if e["name"] in wide and not e["name"].endswith("_f32"):
            # the bf16 long-context kernels at Dh 128 and 256 (phase 19a)
            e["head_dims"] = list(_build.FLASH_HEAD_DIMS)
            e["wide"] = {k: wide[e["name"]][k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
                "cases")}
    print(f"chip_smoke.py: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
