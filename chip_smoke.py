#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card, ``nvcc`` and
``nvidia-smi``; it exits non-zero without them or without the repo's
sources.  Phases, each of which fails the run on any mismatch:

  1. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
     source, all started together), print ``ptxas -v``'s report and check
     that no Hopper (wgmma) kernel of K3, K4 or K5 spills and no VT kernel
     spills, print K2's and VT's registers a thread and K1's SASS
     instruction counts, and hold each
     kernel against its plain PyTorch version on edge-case inputs (K1 on
     both its entries: the (B, S, r) block entry and the grouped derive
     entry over ragged tables);
  2. the main path on ResNet18 at full width (20 conv layers, 224x224):
     ``capture_activations`` -> ``derive_profile`` (kernel engine: K1, one
     grouped launch for all 20 layers) -> ``allocate`` + ``simulate`` for
     the five Fig 8 policies -> ``run_batch`` over 5 policies x 64 PE
     counts, with K1's launch counts read before and after; then K1
     against its plain versions at the path's shapes (sample 256 and
     8192), the ``"torch"`` engine on the card against the
     ``"vectorized"`` engine on the host, the per-layer route against the
     grouped derive, and ``run_batch`` against the scalar ``simulate``;
  3. the same path on VGG11 at 64 images (one K1 launch for 8 layers);
  4. the card against the host path on a small VGG11 input;
  5. timings with CUDA events after warm-up: the stages, and K1 per derive
     at 256 and 8192 samples through its wrapper, alone (L2 flushed, and
     L2-resident), through the per-layer route, beside its bound and its
     plain version, and ``derive_profile`` grouped and per layer;
  6. K2 (the fused allocate + eval kernel) against its plain version on
     random problems (ties, warm starts, budget-0 rows, N not a multiple
     of 32);
  7. the fused DSE sweep on ResNet18 at full width: ``run_fused_sweep``
     (``engine="kernel"``: one K1 block-entry launch per geometry group, then K2 per
     chunk) over array rows 128 and 256 x ADC bits 1-8 x four policies x
     4,400 PE budgets from 1.0 to 2.5x the minimum (281,600 configs), with
     K1's and K2's launch counts set to 0 before and read after; then the
     ``"torch"`` engine on the same grid, the staged ``run_sweep`` on a
     64-budget sub-grid, and K2 against its plain version on every chunk of
     that sub-grid; the same for VGG11 on a smaller grid;
  8. K2's timings at every chunk the main path's sweep launches (both
     families, both geometry groups), each beside its bound and its plain
     version, and their sums over the sweep;
  9. K4 (flash attention) against its plain version: float32 and bfloat16,
     head dims 16, 64 and 128, s 1, 77, 200, 1000 and 1024, causal and not,
     Zamba2's prefill shape on the model's (b, s, h, hd) layout and
     Whisper-medium's (phase 21) non-causal shapes against 1500 keys; the
     scores rounded to the inputs' type (``round_scores``, the model's prompt
     attention) against the plain version with the same keyword; grouped kv
     heads at the dense models' prefill shapes in bf16 (48 q on 8 kv heads,
     32 on 2, 12 on 2, head dim 128), with and without ``round_scores``,
     timed beside SDPA, and small float32 shapes with groups of 1, 2, 6 and
     16;
 10. K5 (the SSD chunk kernel) against its plain version at the Zamba2 and
     Mamba2-370M prefill shapes, at two whose work queue is ragged, and at
     small ragged ones, y and S apart, each shape twice (each of K3, K4 and
     K5 has a tensor-core kernel for bf16 and a CUDA-core one for float32;
     both run here; K5's bf16 takes the Hopper kernel at the models' shapes
     and the mma.sync one at the small shapes, and refuses a shape neither
     takes);
 11. K3 (the zero-skip matmul) against its plain version in float32 and
     bf16: the reference's test shapes and masks, ragged M, N and K through
     the op, M over many waves of the persistent grid with ragged M and N
     (4000, 24576) @ (24576, 6100), Nemotron-4-15B's down-projection at its
     prefill and decode shapes; then the reference benchmark's structured
     input (half the tiles zero) at the prefill shape, timed against the
     dense input and ``torch.matmul``;
 12. Zamba2-1.2B at full width (38 Mamba2 layers, d_model 2048, the shared
     attention block at 6 sites) served through ``launch.serve``'s stages:
     random parameters from a seeded ``torch.Generator``, 4 prompts of 1024
     tokens, prefill with the cache, then 31 greedy decode steps, with K3's,
     K4's and K5's counts set to 0 before and read after (K4 6 and K5 38
     launches, all in the prefill); prefill ms and decode tokens/s by CUDA
     events after a warm-up, the device-busy share and the top kernels over
     the prefill and over one decode step (``torch.profiler``), the peak
     device memory, and each kernel per
     launch on the path's own inputs beside its bound, its plain version
     and the library call (K3 ``torch.matmul``, K4 SDPA);
 13. kernels against plain versions end to end: Zamba2-1.2B in float32, 2
     ragged prompts of 200 tokens and 4 tokens, once with the kernels and
     once with this script swapping the models' K3/K4/K5 entry points for
     the plain versions (logits within 1e-3 of max |logit|, equal tokens);
     and the SMOKE config on the card against the same parameters on the
     host;
 14. Mamba2-370M at full width (48 layers, d_state 128), 2 prompts of 512
     tokens and 8 tokens, with its timings (K5: 48 launches);
 15. the dense family at full width and depth, one model at a time, the
     same stages as 12: Nemotron-4-15B (32 layers, d_model 6144, squared
     ReLU: K3 32 launches per forward, K4 32 per prefill), GLM-4-9B (40
     layers, 32 q on 2 kv heads: K4 40) and Qwen2-VL-2B (28 layers, M-RoPE,
     qkv bias: K4 28), with the zero tiles K3 met on the path;
 16. Nemotron-4-15B in float32, kernels against plain versions end to end
     as in 13, and the five dense SMOKE configs on the card against the
     host;
 17. the fabric engines (VT, the virtual-time scan kernel): VGG11 and
     ResNet18 profiled by K1; the reference's fabric_tail grid (VGG11 at
     twice the minimum PEs, weight_based, blockwise and
     provision_latency_aware at 5 loads: 15 configs x 400 Poisson
     requests) through one run_batch, cold and warm, equal to FabricSim on
     the host; ResNet18's five policies in ClosedLoop(120, 40), each within
     10% of the analytic img/s, and blockwise in ClosedLoop(30, 12) equal to
     FabricSim; the fused sweep's fabric stage over 1,024 configs of the
     VGG11 half of the headline grid, equal to the staged sweep on the card
     and on 8 rows to the host scalar sweep; VT against its plain version
     (stats, transfers, fractional cycles); VT's times beside its bound (a
     one-thread FP64 add + min chain measured here, or the bytes), the
     device's busy share over the fused sweep, and VT's cycles a job by
     pool width and a (request, layer) on synthetic one-pool problems; the
     service-index draw (``csrc/service_draw.cu``) at the benchmark cells'
     sizes equal to the host's draw, timed alone, through its path and
     against the host's draw and upload, and its launches counted on every
     VT path of phases 17 and 18 (one draw a VT launch);
 18. the multi-chip half (slice 9): F8, VT on VGG11 blockwise at 10x to 20x
     the minimum PEs (pools wider than 512 servers) equal to FabricSim; the
     reference's multi-chip sweep (VGG11, 1 to 8 chips x 16 to 256 Gb/s
     links at equal silicon, placed by allocate_placed, 2 VT launches) with
     two points equal to FabricSim(placement=) on the host; the fused
     (placement x load) surface equal to the staged sweep at load 0.7; fleet
     replay of FLEET_REQUESTS sinusoidal Poisson requests through the
     streaming VT entry (the W=1 materialized baseline, the sketch within
     its bound of the exact percentiles, the stream equal to the baseline,
     the first requests equal to FabricSim(service_sampling="hash"), the
     kernel against its plain version, the segmented hold / grow replay
     with macro-jobs, each segment's launch beside its chain bound); the
     fault sweep (spares x rates, 600 requests) equal to the host's
     FabricSim(failures=) replays; the utilization report and the Perfetto
     trace of a placed 4-chip run;
 19. MoE serving (slice 10): the DeepSeek-V2 (MLA + MoE, 160 experts, top-6,
     2 shared) and Grok-1 (GQA + MoE, 8 experts, top-2) SMOKE configs on the
     card against the host (logits, tokens, routing records); each at full
     width, cut in depth to what the card holds (MOE_DEPTH: 3 of 60 and 2 of
     64 layers), served as in 12 and 15 (4 x 1024 tokens + 32; K4 once per
     Grok-1 layer in the prefill, no kernel for DeepSeek-V2's MLA, whose q/k
     head dim 192 and v head dim 128 K4 does not take); Grok-1 at its cut in
     float32, kernels against plain versions end to end; and the paper's
     expert replication on DeepSeek-V2 at full width: its prefill's routing
     captured (3 layers x 4096 tokens x 6), the histogram planned over 192
     slots, the max slot load and the dropped share measured from the
     records at the prefill's capacity before and after, beside the
     planner's predictions, the model redeployed with replicated banks (2
     layers) and prefilled, and one full-width layer in float32 at capacity
     factor 16 with replicas equal to it without.

 20. training (slice 11): K3, K4 and K5 under autograd (their
     ``torch.autograd.Function``s: the kernel forward, the plain version's
     gradient backward) against autograd of their plain versions at the
     training path's shapes (K4 bf16 with ``round_scores`` at Zamba2's (4,
     1024, 32 / 32, hd 64) and Qwen2-VL-2B's grouped (4, 1024, 12 / 2, hd
     128); K5 at Zamba2's 32 cells in bf16 and float32; K3 at Nemotron's
     down-projection in bf16); the nine non-enc-dec SMOKE configs in float32,
     the loss, every gradient and one ``make_train_step`` on the card (kernels)
     against the host (plain versions); Zamba2-1.2B at full width and depth
     in float32, one step's loss and gradients with the kernels against the
     plain versions swapped in; Zamba2-1.2B trained at full width and depth
     (bf16 on float32 masters, remat full, 4 x 1024 SyntheticLM tokens,
     AdamW, 8 steps; K4 12 and K5 112 launches a step, checked at each),
     with its step time, tokens/s, peak memory, busy share, top kernels and
     model-FLOPs share; and, under ``torch.use_deterministic_algorithms``,
     ``TrainRunner`` with injected failures equal to a clean run bit for bit
     on three SMOKE configs, and ``launch.train.main`` with ``--ckpt`` and
     ``--resume``;
 21. enc-dec (slice 12): Whisper-medium at full width and depth (24 + 24
     layers, d_model 1024, 16 heads of 64, vocab 51,865): K4 under
     autograd at the encoder's and cross-attention's training shapes
     (phase 9 holds K4 against its plain version at the encoder's
     non-causal (4, 1500) square and at cross-attention's 1, 64 and 448
     queries against 1500 keys, float32 and bf16, with and without
     ``round_scores``); served (4
     x 1500 frames, ``encode``, a 64-token prompt into the cache, 31
     ``make_encdec_decode_step`` calls; K4 72 launches in the prefill and 24
     a decode step, checked) with its timings, busy shares, peak memory and
     K4 per launch on the path's inputs beside its bound, plain version and
     SDPA; in float32, kernels against plain versions end to end; the SMOKE
     config card vs host (serving, loss, gradients, one step); trained 8
     steps (synth_batch, 4 x 1500 frames -> 448 tokens, AdamW, remat full,
     K4 144 launches a step, checked) with the loss falling; and the SMOKE
     config under ``TrainRunner`` with injected failures equal to a clean
     run bit for bit, and ``python -m repro_torch.examples.whisper_train``.

 22. distrib and launch (slice 13), on one-rank meshes over a process
     group of one rank (gloo on the host, NCCL on the card): (a)
     Zamba2-1.2B at full width and depth trained 4 steps by
     ``make_compressed_train_step`` on a (pod 1, data 1, model 1) mesh, the
     parameters DTensors placed by ``param_specs`` (K4 12 and K5 112
     launches a step, checked; the loss falling; every error-feedback
     residual within half its int8 scale), its step time beside phase 20's;
     (b) Grok-1 at full width cut to 2 layers, a 4 x 1024 prefill and 8
     decode steps through ``moe_fwd``'s EP path and ``gqa_fwd``'s mesh
     branch (K4 inside ``compat.shard_map``), logits and tokens against the
     local path from the same weights, and ``_decode_attn_seq_sharded`` at
     its decode shape against ``_sdpa``; (c) Qwen2-VL-2B's 28 layers through
     the GPipe schedule on a pipe-1 mesh, 4 microbatches of 1 x 1024,
     outputs and gradients against the layer loop; (d) the dry run of
     GLM-4-9B x train_4k on one pod (256 fake ranks) and DeepSeek-V2 x
     decode_32k on two (512), each in a process of its own on the host,
     their bytes, FLOPs, collectives and roofline on the H100's data sheet.

The line before the last is ``{"kernels": [...]}`` (each kernel's launches
on the main path, max |kernel - plain|, times and bound); the last line is
``{"ok": true, "device": {...}}``.  Numbers are this card's, printed beside
its name and power limit.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
LANE_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores, taken per integer op
# integer instruction rates a clock an SM for compute capability 9.0 (CUDA C++
# Programming Guide, "Arithmetic Instructions" throughput table): 32-bit
# integer add, shift and logic (LOP3, IADD3, SHF, LEA), and population count;
# times H100_SMS and the SM clock nvidia-smi reports (clocks.max.sm)
INT_OPS_PER_CLK_SM = 64
POPC_PER_CLK_SM = 16
H100_SMS = 132
FP64_OPS_PER_S = 34e12  # H100 SXM float64 rate outside the tensor cores (K2 uses no tensor core)
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate (K4's and K5's inputs on the path)
TF32_OPS_PER_S = 495e12  # H100 SXM dense TF32 tensor-core rate (K5's float32 weights of y, in bf16)
FIG8_MAX_MULT = 5.66  # the largest Fig 8 design size, in multiples of the minimum PEs
# the reference's headline fused grid (benchmarks/run.py:782-798): its
# ResNet18 half, array rows 128 and 256 x ADC bits 1-8 x four policies x
# 4,400 PE budgets from 1.0 to 2.5x the minimum
FUSED_ROWS = (128, 256)
FUSED_ADC_BITS = (1, 2, 3, 4, 5, 6, 7, 8)
FUSED_POLICIES = ("baseline", "weight_based", "perf_layerwise", "blockwise")
FUSED_R18_BUDGETS = 4400
FUSED_R18_MAX_MULT = 2.5
FUSED_VGG_BUDGETS = 400  # VGG11: the same axes at a smaller grid, 1.0 to 6.0x
FUSED_VGG_MAX_MULT = 6.0
FUSED_SUBGRID = 64  # budgets held against the staged run_sweep
K2_RTOL = 1e-12  # the reference's fused contract for float outputs
K4_TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # the reference's tests/test_kernels.py
# round_scores at N(0, 2^2) inputs: at most this share of entries more than
# one bf16 step (2^-7 of 1 + |plain|) from the plain version with the same
# keyword, and at least K4_APART of them from the one with the other keyword
K4_STEP_SHARE, K4_APART = 1e-3, 1e-2
# K5 vs plain, of 1 + |plain|: float32 as the reference's tests/test_kernels.py;
# bf16 one bf16 step (2^-7), tighter than its 5e-2: the plain version rounds
# the decayed B as the kernel does, so the two differ only by summation order
# and y's final rounding
K5_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# K5's Hopper kernel: Zamba2-1.2B's and Mamba2-370M's prefill shapes (nc, Q, H,
# P, N), then two whose work queue is ragged (groups of 4 and 3 heads, 280
# items; groups of 8 and 5, 225 items, at N 128)
K5_SHAPES = ((32, 128, 64, 64, 64), (8, 128, 32, 64, 128), (140, 128, 7, 64, 64), (45, 128, 37, 64, 128))
# K3 vs plain, of 1 + |plain|: bf16 as the reference's tests/test_kernels.py;
# float32 as its tests/test_zskip_masks.py for full-range gaussian inputs
K3_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
K3_WAVES = (4000, 24576, 6100)  # M over many persistent waves, ragged M and N
E2E_TOL = 1e-3  # kernels vs plain end to end, float32, of max |logit|
ZAMBA = dict(batch=4, prompt_len=1024, gen=32)  # the serving path at full width
MAMBA = dict(batch=2, prompt_len=512, gen=8)
DENSE = dict(batch=4, prompt_len=1024, gen=32)  # the dense family at full width and depth
DENSE_ARCHS = ("nemotron-4-15b", "glm4-9b", "qwen2-vl-2b")
DENSE_SMOKE = DENSE_ARCHS + ("qwen2.5-32b", "qwen1.5-110b")
NEMOTRON_DOWN = (4096, 24576, 6144)  # Nemotron-4-15B's prefill down-projection: 4 x 1024 rows, d_ff, d_model
DENSE_HEADS = {"nemotron-4-15b": (48, 8), "glm4-9b": (32, 2), "qwen2-vl-2b": (12, 2)}  # q and kv heads, hd 128
NEMOTRON_PEAK_GB = 69.0  # the reckoning of a bf16 prefill of 4 x 1024 on float32 parameters
E2E = dict(batch=2, prompt_len=200, gen=4)  # a ragged prompt: 200 = 128 + 72
# the MoE family (phase 19) at full width, cut in depth so that its float32
# weights fit the card beside a bf16 prefill of 4 x 1024 (by param_count:
# DeepSeek-V2 3.97e9 parameters a layer + 1.05e9 of embedding and head, about
# 52 GB at 3 layers; Grok-1 4.92e9 + 1.61e9, about 46 GB at 2)
MOE = dict(batch=4, prompt_len=1024, gen=32)
MOE_ARCHS = ("deepseek-v2-236b", "grok-1-314b")
MOE_DEPTH = {"deepseek-v2-236b": 3, "grok-1-314b": 2}
# expert replication on DeepSeek-V2: 160 experts + 32 replicas; the
# redeployed model keeps 2 layers (192 slots are 18.1 GB a layer); the
# replicas-vs-none check runs one layer in float32 at capacity factor 16 (no
# drops) on 2 prompts of 64 tokens
MOE_SLOTS = 192
MOE_REDEPLOY_DEPTH = 2
MOE_REPL_CHECK = dict(batch=2, prompt_len=64, capacity_factor=16.0)
MOE_REPL_TOL = 1e-5  # of max |logit|: replicas are copies
# phase 20, training (slice 11): Zamba2-1.2B at full width and depth as
# configs/zamba2_1_2b.py publishes it (bf16 compute on float32 masters, remat
# full), SyntheticLM batches and AdamW as launch.train sets them
TRAIN = dict(arch="zamba2-1.2b", batch=4, seq=1024, steps=8, lr=1e-3, warmup=5)
TRAIN_PEAK_GB = 30.0  # parameters, gradients, m and v are 18.7 GB; the float32 logits 0.52
TRAIN_E2E = dict(batch=2, seq=512)  # (c) float32 kernels vs plain at full width and depth
TRAIN_SMOKE = dict(batch=2, seq=32)
TRAIN_SMOKE_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)
TRAIN_SMOKE_ARCHS = ("zamba2-1.2b", "mamba2-370m") + DENSE_SMOKE + MOE_ARCHS
TRAIN_RUNNER_ARCHS = ("zamba2-1.2b", "nemotron-4-15b", "grok-1-314b")  # K4 + K5, K3, the MoE's scatters
TRAIN_RUNNER_STEPS = 8
TRAIN_RUNNER_FAILS = {4: 1, 7: 1}
K4_TRAIN_SHAPES = (("zamba2-1.2b", 4, 1024, 32, 32, 64), ("qwen2-vl-2b", 4, 1024, 12, 2, 128))
K5_TRAIN_SHAPE = (32, 128, 64, 64, 64)  # Zamba2-1.2B's cells at 4 x 1024
K3_TRAIN_SHAPE = NEMOTRON_DOWN
# (a) gradients of the Function against autograd of the plain version on the
# card, of max |plain grad|: K4's and K5's backward is autograd of a
# recomputation of the plain version on the same inputs (equal up to the
# order of float32 sums); K3's backward takes its products in bf16 where
# the plain version takes them in float32 and rounds: a bf16 step (2^-8)
K4_GRAD_TOL = K5_GRAD_TOL = 1e-5
K3_GRAD_TOL = 1e-2
# (b) card vs host in float32: loss relative; gradients of max |host grad| per
# leaf; updated parameters: at most TRAIN_PARAM_SHARE of all entries more than
# TRAIN_PARAM_TOL of their leaf's max |p| apart, every entry within 2 lr (1 +
# wd max |p|),
# as tests/test_torch_train_step.py holds the port to the reference (one
# AdamW step takes each gradient entry to about +-1, so an entry at the
# rounding noise may take another sign)
TRAIN_LOSS_TOL = 1e-5
TRAIN_CARD_HOST_TOL = 1e-4
TRAIN_PARAM_TOL, TRAIN_PARAM_SHARE = 1e-5, 1e-3
# (c) loss relative and gradients of max |plain grad| per leaf: within
# E2E_TOL, or within TRAIN_E2E_FACTOR times the distance that parameters
# perturbed by one float32 rounding give the plain versions' gradients (the
# gradients' own conditioning at 38 layers and the reference's Mamba2 init,
# ROADMAP F5)
TRAIN_E2E_TOL = 1e-3
TRAIN_E2E_FACTOR = 4.0
# phase 21, enc-dec (slice 12): Whisper-medium at full width and depth (24 +
# 24 layers, d_model 1024, 16 heads of 64, 1500 frames).  Serving: 4 x 1500
# frames, a 64-token decoder prompt into a cache of 96, 32 tokens generated.
# Training: 4 x 1500 frames and 448 decoder tokens (Whisper's published text
# context) on examples/whisper_train.py's synth_batch, AdamW as that example
# sets it.  The K4 checks: the encoder's non-causal (4, 1500) square and
# cross-attention's queries against the 1500 keys.
WHISPER = dict(batch=4, prompt_len=64, gen=32)
WHISPER_TRAIN = dict(batch=4, seq=448, steps=8, lr=1e-3, warmup=2)
WHISPER_TRAIN_PEAK_GB = 30.0  # parameters, gradients, m and v are 13.0 GB; logits 0.37; K4's recomputed scores 0.58 a call
WHISPER_E2E = dict(batch=2, prompt_len=200, gen=4)
WHISPER_SMOKE = dict(batch=2, prompt_len=12, gen=4)
WHISPER_K4_SQ = (1500, 1, 64, 448)  # against 1500 keys: the encoder's square, then cross-attention's queries
WHISPER_K4_GRAD = (("encoder", 4, 1500), ("cross", 4, 448))  # (b, sq) against 1500 keys, 16 heads of 64
WHISPER_RUNNER_FAILS = {4: 1, 7: 1}
# phase 22, distrib and launch (slice 13): one-rank meshes over a process
# group of one rank (gloo for the host, NCCL for the card, a FileStore).  (a)
# Zamba2-1.2B trained as phase 20 trains it, by make_compressed_train_step on
# a (pod 1, data 1, model 1) mesh; (b) Grok-1 cut to MOE_DEPTH layers as
# phase 19 serves it, on a (data 1, model 1) mesh through moe_fwd's EP path,
# then the sequence-sharded decode attention at its decode shape; (c)
# Qwen2-VL-2B's 28 layers through the GPipe schedule on a pipe-1 mesh; (d)
# two production-mesh dry-run cells on the host, in processes of their own
MESH_TRAIN_STEPS = 4
MESH_MOE = dict(batch=4, prompt_len=1024, gen=8)
MESH_MOE_TOL = 2e-3  # of max |logit|, if the mesh path is not equal to the local one (tests/test_distrib.py:163)
MESH_SEQ_DECODE_TOL = 1e-5  # float32, of max |out|
MESH_PIPE = dict(arch="qwen2-vl-2b", n_micro=4, mb=1, seq=1024)
MESH_DRYRUN = (("glm4-9b", "train_4k", False), ("deepseek-v2-236b", "decode_32k", True))
# the fabric phase: the reference's fabric_tail (benchmarks/run.py:349-379: VGG11
# profiled at 2 images, 128 samples; 2x the minimum PEs; 400 Poisson requests at
# 5 loads, arrival seed 5, service seed 3; latency-aware provisioning calibrated
# on 150 requests, no grants), its ResNet18 acceptance (tests/test_fabric_resnet18.py:
# 1 image, 64 samples; ClosedLoop(120, 40) within 10% of analytic;
# ClosedLoop(30, 12) equal to FabricSim) and 1,024 configs of the VGG11 half of
# the headline grid (benchmarks/run.py:782-798: 11,250 budgets from 1 to 6x)
FABRIC_VGG_PROFILE = dict(n_images=2, sample_patches=128)
FABRIC_R18_PROFILE = dict(n_images=1, sample_patches=64)
FABRIC_LOADS = (0.3, 0.5, 0.6, 0.7, 0.85)
FABRIC_TAIL_REQUESTS = 400
FABRIC_CALIB = 150
FABRIC_R18_LOOP = (120, 40)
FABRIC_R18_EQUAL = (30, 12)
FABRIC_VGG_HALF_BUDGETS = 11250
FABRIC_FUSED_CONFIGS = 1024
FABRIC_CHECK_REQUESTS = 40
# the multi-chip and fleet phase (slice 9): the reference's fabric_multichip
# (benchmarks/run.py:698-720: VGG11, chips 1, 2, 4, 8 x links 16, 64, 256 Gb/s
# at 2x the minimum PEs, 200 requests, ClosedLoop(60, 24), 64 samples, seed 0),
# its fused (placement x load) surface (:853-872: chips 1, 2, 4 x links 16, 64 x
# loads 0.3 to 0.8, 120 requests, ClosedLoop(40, 24)), fabric_fleet (:918-1034:
# VGG11 blockwise at 2x the minimum PEs, a two-cycle sinusoidal Poisson trace
# at 0.6 of capacity, amplitude 0.5, seed 0; hold and grow by [64, 128] arrays
# at n/3 and 2n/3; service seed 7; macro-jobs with tail_lanes 2; window 8) at
# FLEET_REQUESTS requests, and fabric_faults (:1036-1080: spares 0, 0.1, 0.25
# x rates 1e-9, 1e-8, 600 requests, seed 0); F8 at 10x to 20x the minimum PEs
MC_CHIPS = (1, 2, 4, 8)
MC_LINKS = (16.0, 64.0, 256.0)
MC_RUN = dict(n_requests=200, closed_requests=60, concurrency=24, sample_patches=64, seed=0)
MC_CHECK_REQUESTS = 40
FUSED_CHIP = dict(chips=(1, 2, 4), link_gbps=(16.0, 64.0))
FUSED_CHIP_LOADS = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8)
FUSED_CHIP_RUN = dict(n_requests=120, closed_requests=40, concurrency=24, seed=0)
FLEET_REQUESTS = 500_000  # the reference bench replays 10^6; cut so that the phase stays near 300 s
FLEET_HOST_REQUESTS = 2000  # the stream's first requests held against FabricSim on the host
FLEET_PLAIN_REQUESTS = 500  # the kernel against its plain version (on the host): the stream and each replay segment
FLEET_BUDGETS = (64, 128)
FAULT_RUN = dict(n_requests=600, seed=0)
F8_MULTS = (10, 12, 16, 20)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps=1, warmup=1, host_ahead=False):
    """Mean ms per call by CUDA events, after ``warmup`` calls.  With
    ``host_ahead`` the card first sleeps about a millisecond, so that the
    host has queued every call before the first runs and the time is the
    device's alone, not the host's cost per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if host_ahead:
        torch.cuda._sleep(2_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps, device):
    """Mean ms of one call by CUDA events around it, the L2 cache flushed
    before each: a sum over 256 MB (5x the L2) leaves it full of clean lines,
    so the call pays no write-back of the flush."""
    import torch

    flush = torch.ones(32 << 20, dtype=torch.int64, device=device)
    total = torch.empty((), dtype=torch.int64, device=device)
    fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in events:
        torch.sum(flush, 0, out=total)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def k2_problem(seed, n, c, warm, ties=True):
    """Numpy inputs of K2 drawn from small integer pools (priority ties are
    common): A variants of N unit bases, a one-hot map with uncovered cells,
    V = 2A bank slots, budgets with zeros.  The CPU tests draw the same
    problems (tests/test_torch_fused_kernel.py)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a, l, b = int(rng.integers(1, 4)), int(rng.integers(1, 6)), int(rng.integers(1, 40))
    base = rng.integers(1, 13, (a, n)).astype(np.float64)
    if not ties:
        base *= rng.random((a, n)) * 1e3
    cost = rng.integers(1, 5, n).astype(np.float64)
    owner = rng.integers(-1, n, (l, b))
    umap = np.zeros((n, l, b))
    li, bi = np.nonzero(owner >= 0)
    umap[owner[li, bi], li, bi] = 1.0
    v = 2 * a
    banks = (
        rng.integers(1, 50, (v, l, b)).astype(np.float64),
        rng.integers(50, 99, (v, l, b)).astype(np.float64),
        rng.integers(1, 50, (v, l)).astype(np.float64),
        rng.integers(50, 99, (v, l)).astype(np.float64),
        rng.integers(1, 50, (v, l)).astype(np.float64),
    )
    b_mask = rng.random((l, b)) < 0.8
    b_mask[:, 0] = True
    ppi = rng.integers(1, 100, l).astype(np.float64)
    width = rng.integers(1, 5, l).astype(np.float64)
    larr = rng.integers(1, 50, l).astype(np.float64)
    budgets = rng.integers(0, 60, c).astype(np.float64)
    budgets[:2] = 0.0
    a_idx = rng.integers(0, a, c).astype(np.int32)
    sel = rng.integers(0, v, c).astype(np.int32)
    layerwise = rng.random(c) < 0.5
    r0 = rng.integers(1, 4, (c, n)).astype(np.float64) if warm else np.ones((c, n))
    return (base, cost, umap, banks, b_mask, ppi, width, larr, budgets, a_idx, sel, layerwise, r0)


def k2_errors(got, want, what):
    """Replicas and leftover exactly equal; returns (max |err|, max relative
    err) over the float outputs (T, img/s, layer cycles, utilization)."""
    import torch

    for i, name in ((4, "replicas"), (5, "leftover")):
        check(torch.equal(got[i], want[i]), f"{what}: K2 {name} differ from the plain version")
    abs_err = rel_err = 0.0
    for g, w in zip(got[:4], want[:4]):
        d = (g - w).abs()
        abs_err = max(abs_err, float(d.max()) if d.numel() else 0.0)
        rel_err = max(rel_err, float((d / w.abs()).max()) if d.numel() else 0.0)
    check(rel_err <= K2_RTOL, f"{what}: K2 float outputs off by {rel_err} relative (limit {K2_RTOL})")
    return abs_err, rel_err


def k2_bound(args):
    """(bound ms, bound_by, ops, bytes) of one K2 call from its inputs.

    Operations, FP64: per config 80 bisection steps of 6 operations per unit
    (divide, ceil, max, subtract, multiply, add), one more such pass to set
    the replicas, and the eval: 5 per layer for a layer-wise config, 6 per
    valid (layer, block) cell otherwise, 4 per layer for the utilization.
    The residual grants after the bisection depend on ties and are left out,
    so this is a lower bound.  Bytes: every input read once, every output
    written once."""
    base, cost, umap, banks, b_mask, ppi, width, larr, budgets, a_idx, sel, lw, r0 = args
    C, N = r0.shape
    L = b_mask.shape[0]
    n_lw = int(lw.sum())
    cells = int(b_mask.sum())
    ops = C * (81 * N * 6 + 4 * L) + n_lw * 5 * L + (C - n_lw) * 6 * cells
    ins = (base, cost, umap, *banks, b_mask, ppi, width, larr, budgets, a_idx, sel, lw, r0)
    nbytes = sum(t.numel() * t.element_size() for t in ins) + C * 8 * (3 + 2 * L + N)
    ops_ms, bytes_ms = ops / FP64_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), ops, nbytes


# K1's grouped edge tables: (block rows, ((S, rows), ...)).  Rows 147 are not
# 16-byte aligned (ResNet18's conv1), 64 < 128 is one short block, 256 and 384
# exact multiples, 27 VGG11's conv1; S differs between entries and is 1 in some
K1_TABLES = (
    (128, ((37, 147), (1, 64), (130, 256), (5, 300), (3, 27))),
    (256, ((20, 147), (9, 600), (1, 256), (129, 384))),
    (64, ((300, 147), (257, 576))),
)
# K1's instructions, from ``cuobjdump -sass`` of the built kernel (int64
# cycles; LOP3, IADD3, IMAD, SHF, LEA and the like counted as integer ops):
# the copy of one 16-byte unit into shared memory (address arithmetic and
# the cp.async), the 16-word loop body (a full adder tree, 8 masked POPC and
# the sums), one leftover 16-byte unit, and the per-row tail (the per-plane
# counts, the zero-skip cost and the store).  (integer ops, POPC)
K1_SASS_STAGE = (17, 0)
K1_SASS_GROUP = (45, 8)
K1_SASS_UNIT = (22, 8)
K1_SASS_ROW = (140, 32)


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def k1_ops(qs, brs):
    """(integer ops, POPC) K1 executes on these (S, rows) matrices, from its
    SASS counts per staged 16-byte unit, per 16-word group, per leftover
    16-byte unit and per row (the aligned path; ResNet18's conv1 realigns
    its words too, about 1% of the bytes, not counted)."""
    n_int = n_popc = 0
    for q, br in zip(qs, brs):
        s, rows = q.shape
        for b in range(-(-rows // br)):
            units = -(-min(br, rows - b * br) // 16)
            groups, rest = divmod(units, 4)
            for i in range(2):
                per_row = (units * K1_SASS_STAGE[i] + groups * K1_SASS_GROUP[i] + rest * K1_SASS_UNIT[i]
                           + K1_SASS_ROW[i])
                if i == 0:
                    n_int += s * per_row
                else:
                    n_popc += s * per_row
    return n_int, n_popc


def k1_bound(qs, brs, clock_hz, out_bytes=8):
    """(bound ms, bound_by, bytes, int ops, POPC) of one grouped K1 launch:
    every input byte read once, one cycle count of ``out_bytes`` written a
    (sample, block) row; the operations priced at the integer rates, each
    type on its own unit (the larger of the two times)."""
    n_int, n_popc = k1_ops(qs, brs)
    rows = sum(q.shape[0] * -(-q.shape[1] // br) for q, br in zip(qs, brs))
    nbytes = sum(q.numel() for q in qs) + out_bytes * rows
    ops_s = max(n_int / (INT_OPS_PER_CLK_SM * H100_SMS * clock_hz),
                n_popc / (POPC_PER_CLK_SM * H100_SMS * clock_hz))
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), nbytes, n_int, n_popc


def k1_vs_plain_grouped(qs, brs, rows_per_read=8):
    """Max |kernel - plain| of K1's grouped entry, launches not counted."""
    from repro_torch.kernels.bitplane_profile import bitplane_grouped_cycles as k1g, bitplane_grouped_cycles_ref

    saved = k1g.launches
    got = k1g(qs, brs, rows_per_read=rows_per_read)
    want = bitplane_grouped_cycles_ref(qs, brs, rows_per_read=rows_per_read)
    k1g.launches = saved
    check(got.shape == want.shape, f"K1 grouped: {tuple(got.shape)} cycles, plain {tuple(want.shape)}")
    return int((got - want).abs().max()) if got.numel() else 0


def k1_edge_checks(dev):
    """K1's grouped entry against its plain version on the edge tables at
    rows_per_read 4, 8 and 16, random (half zeros), all 0 and all 0xFF."""
    import numpy as np
    import torch

    rng = np.random.default_rng(1)
    err = 0
    for br, shapes in K1_TABLES:
        for fill in (None, 0, 0xFF):
            qs = []
            for s, rows in shapes:
                q = (rng.integers(0, 256, (s, rows), dtype=np.uint8) if fill is None
                     else np.full((s, rows), fill, np.uint8))
                if fill is None:
                    q[rng.random((s, rows)) < 0.5] = 0
                qs.append(torch.from_numpy(q).to(dev))
            for rpr in (4, 8, 16):
                err = max(err, k1_vs_plain_grouped(qs, [br] * len(qs), rpr))
    torch.cuda.synchronize()
    check(err == 0, f"K1 grouped != plain on the edge tables: max err {err}")
    return err


def per_layer_derive(cap, spec):
    """``derive_profile``'s per-layer route before the grouped one: per
    layer, a padded transposed copy through K1's block entry, its output
    permuted and widened, and the densities and means layer by layer (20
    launches of K1 for ResNet18).  For timing beside the grouped derive."""
    from repro_torch.core.cim.profile import NetworkProfile, _block_density, _profile, _slice_bounds
    from repro_torch.kernels.bitplane_profile import bitplane_profile

    array = spec.layers[0].array
    layers = []
    for lc, layer in zip(cap.layers, spec.layers):
        starts, stops = _slice_bounds(layer)
        _, cyc = bitplane_profile(lc.sampled_q, block_rows=layer.array.rows,
                                  rows_per_read=array.rows_per_read, cycles_per_read=array.cycles_per_read)
        layers.append(_profile(layer, array, _block_density(lc, starts, stops), cyc, starts, stops))
    return NetworkProfile(spec.name, tuple(layers))


def k1_numbers(cap, spec, clock_hz, reps):
    """K1 per derive on this capture: through the grouped wrapper (L2 warm,
    as the derive meets it), alone (a prebuilt call on a cached table and a
    preallocated output) with L2 flushed before every launch and back to
    back with the host ahead, an int64 sum over as many bytes after the same
    flush (the card's streaming read rate in this run), the plain version, K1 through the per-layer route
    (a block launch a layer, with its padded copy), the bound, and ``derive_profile`` grouped and per layer.
    Launch counts are restored."""
    import torch

    import repro_torch as T
    from repro_torch.kernels.bitplane_profile import (
        bitplane_block_profile as k1,
        bitplane_grouped_cycles as k1g,
        bitplane_grouped_cycles_ref,
        bitplane_profile,
        grouped_plan,
        launch_plan,
    )

    qs = [lc.sampled_q for lc in cap.layers]
    brs = [l.array.rows for l in spec.layers]
    saved = (k1.launches, k1g.launches)
    plan = grouped_plan(qs, brs)
    out = torch.empty(plan.total, dtype=torch.int64, device=qs[0].device)
    n = {"ms": timed(lambda: k1g(qs, brs), reps=reps, warmup=3),
         "alone_l2_ms": timed(lambda: launch_plan(plan, out, None, 8, 8), reps=reps, warmup=3, host_ahead=True)}
    n["kernel_ms"] = cold_ms(lambda: launch_plan(plan, out, None, 8, 8), reps, out.device)
    # the card's streaming read rate in this run: one int64 sum over as many
    # bytes, after the same flush
    stream = torch.zeros(sum(q.numel() for q in qs) // 8, dtype=torch.int64, device=qs[0].device)
    n["stream_ms"] = cold_ms(lambda: stream.sum(), reps, out.device)
    del stream
    n["plain_ms"] = timed(lambda: bitplane_grouped_cycles_ref(qs, brs), reps=3)
    n["per_layer_ms"] = timed(lambda: [bitplane_profile(q, block_rows=br) for q, br in zip(qs, brs)], reps=reps)
    n["derive_ms"] = timed(lambda: T.derive_profile(cap, spec), reps=reps, warmup=2)
    n["derive_per_layer_ms"] = timed(lambda: per_layer_derive(cap, spec), reps=reps, warmup=2)
    k1.launches, k1g.launches = saved
    n["bound_ms"], n["bound_by"], n["nbytes"], n["int_ops"], n["popc"] = k1_bound(qs, brs, clock_hz)
    n["samples"] = qs[0].shape[0]
    return n


def device_busy(fn, counts=None):
    """One call of ``fn`` under ``torch.profiler``: (device busy share of the
    call's window, window ms, {kernel name: device ms}).  Busy time is the
    union of the device's activity (kernels, copies, sets) inside the
    window; it fails if nothing ran on the device.  A dict ``counts`` gets
    the number of device activities by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    mark = "chip_smoke_window"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(mark):
            fn()
            torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    win = [e for e in events if e.name == mark and e.device_type != cuda]
    check(len(win) == 1, f"profiler: {len(win)} windows")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev = [e for e in events if e.device_type == cuda and e.name != mark
           and e.time_range.end > w0 and e.time_range.start < w1]
    check(len(dev) > 0, "profiler: no device activity in the traced window")
    spans = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in dev)
    busy, (c0, c1) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > c1:
            busy += c1 - c0
            c0, c1 = a, b
        else:
            c1 = max(c1, b)
    busy += c1 - c0
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
        if counts is not None:
            counts[e.name] = counts.get(e.name, 0) + 1
    return busy / (w1 - w0), (w1 - w0) / 1e3, by_name


def fused_grid(network, n_budgets, max_mult, budgets_idx=None):
    """design_grid over FUSED_ROWS x FUSED_ADC_BITS x n_budgets PE budgets
    (``budgets_idx`` picks a subset of the multipliers) x FUSED_POLICIES."""
    import numpy as np

    from repro_torch import DEFAULT_ARRAY
    from repro_torch.dse import design_grid

    mults = np.linspace(1.0, max_mult, n_budgets)
    if budgets_idx is not None:
        mults = mults[budgets_idx]
    arrays = tuple(
        DEFAULT_ARRAY.variant(rows=r, cols=r, adc_bits=a) for r in FUSED_ROWS for a in FUSED_ADC_BITS
    )
    return design_grid(networks=(network,), policies=FUSED_POLICIES,
                       pe_multipliers=tuple(mults), arrays=arrays)


def same_sweep(a, b, what):
    """Discrete columns exactly equal, floats within K2_RTOL."""
    import numpy as np

    for col in ("arrays_used", "arrays_total"):
        check(np.array_equal(getattr(a, col), getattr(b, col)), f"{what}: {col} differ")
    worst = 0.0
    for col in ("total_cycles", "images_per_sec", "mean_utilization"):
        x, y = getattr(a, col), getattr(b, col)
        check(bool(np.isfinite(x).all()) and bool((x > 0).all()), f"{what}: {col} not finite and positive")
        worst = max(worst, float(np.max(np.abs(x - y) / np.abs(y))))
    check(worst <= K2_RTOL, f"{what}: float columns off by {worst} relative (limit {K2_RTOL})")
    return worst


def drive_fused(network, n_budgets, max_mult, label):
    """The fused sweep's main path on one network, with K1's and K2's counts
    set to 0 just before ``run_fused_sweep(engine="kernel")`` and read just
    after; then the checks of what came out.  Returns the numbers the
    summary prints."""
    import numpy as np
    import torch

    import repro_torch.dse.fused as fused_mod
    from repro_torch.dse import clear_caches, clear_fused_caches, get_fused_pipeline, run_fused_sweep, run_sweep
    from repro_torch.kernels.bitplane_profile import bitplane_block_profile as k1, bitplane_grouped_cycles as k1g
    from repro_torch.kernels.fused_alloc_eval import fused_alloc_eval as k2, fused_alloc_eval_ref as k2_plain

    clear_caches()
    clear_fused_caches()
    pts = fused_grid(network, n_budgets, max_mult)
    out = {"configs": len(pts)}

    k1.launches = k1g.launches = 0
    k2.launches = 0
    t0 = time.perf_counter()
    res_k = run_fused_sweep(pts, engine="kernel")
    torch.cuda.synchronize()
    out["kernel_cold_s"] = time.perf_counter() - t0
    out["k1_launches"], out["k2_launches"] = k1.launches + k1g.launches, k2.launches
    groups = len(FUSED_ROWS)
    check(out["k1_launches"] == groups and k1g.launches == 0,
          f"{label}: K1 launched {out['k1_launches']} times on the fused path ({k1g.launches} grouped), "
          f"want {groups} (one block-entry launch per geometry)")
    check(out["k2_launches"] > 0, f"{label}: K2 never launched on the fused path")
    print(f"{label}: fused main path ran over {len(pts)} configs, K1 launches {out['k1_launches']}, "
          f"K2 launches {out['k2_launches']} ({out['kernel_cold_s']:.3f} s with capture and derive)")

    # the torch engine on the same grid: the same answers
    t0 = time.perf_counter()
    res_t = run_fused_sweep(pts, engine="torch")
    out["torch_s"] = time.perf_counter() - t0
    out["kernel_vs_torch_rel"] = same_sweep(res_k, res_t, f"{label} kernel vs torch engine")
    print(f"{label}: kernel engine == torch engine over {len(pts)} configs "
          f"(arrays exact, max rel err {out['kernel_vs_torch_rel']:.3e}, limit {K2_RTOL})")
    # warm end to end times of both engines (pipelines and schedules cached)
    for eng in ("kernel", "torch"):
        saved = (k1.launches, k2.launches)
        t0 = time.perf_counter()
        run_fused_sweep(pts, engine=eng)
        torch.cuda.synchronize()
        out[f"{eng}_warm_s"] = time.perf_counter() - t0
        k1.launches, k2.launches = saved

    # the pipelines alone, from packed columns (no per-point Python work)
    packed = []
    for rows in FUSED_ROWS:
        rows_pts = [p for p in pts if p.array.rows == rows]
        packed.append((get_fused_pipeline(network, rows_pts[0].array, FUSED_ADC_BITS),
                       np.array([FUSED_ADC_BITS.index(p.array.adc_bits) for p in rows_pts], np.int32),
                       np.array([p.policy for p in rows_pts], dtype=object),
                       np.array([p.n_pes for p in rows_pts])))
    for eng in ("kernel", "torch"):
        saved = (k1.launches, k2.launches)
        t0 = time.perf_counter()
        for pipe, a_idx, pols, pes in packed:
            pipe(a_idx, pols, pes, engine=eng, need_dups=False)
        torch.cuda.synchronize()
        out[f"{eng}_pipelines_s"] = time.perf_counter() - t0
        k1.launches, k2.launches = saved
    out["packed"] = packed

    # a sub-grid of budgets: the staged path, the replica tensors, and K2
    # against its plain version on every chunk's own inputs
    sub = fused_grid(network, n_budgets, max_mult,
                     np.unique(np.linspace(0, n_budgets - 1, FUSED_SUBGRID).round().astype(int)))
    saved = (k1.launches, k2.launches)
    staged = run_sweep(sub, engine="batch")
    sub_k = run_fused_sweep(sub, engine="kernel")
    out["staged_rel"] = same_sweep(sub_k, staged, f"{label} fused vs staged")
    errs = []
    real_k2 = fused_mod.fused_alloc_eval

    def comparing(*args, **kw):
        got = real_k2(*args, **kw)
        want = k2_plain(*args, **kw)
        errs.append(k2_errors(got, want, f"{label} K2 at the path's shapes (N={args[0].shape[1]})"))
        return got

    fused_mod.fused_alloc_eval = comparing
    try:
        for rows in FUSED_ROWS:
            rows_pts = [p for p in sub if p.array.rows == rows]
            pipe = get_fused_pipeline(network, rows_pts[0].array, FUSED_ADC_BITS)
            a_idx = np.array([FUSED_ADC_BITS.index(p.array.adc_bits) for p in rows_pts], np.int32)
            pols = np.array([p.policy for p in rows_pts], dtype=object)
            pes = np.array([p.n_pes for p in rows_pts])
            got = pipe(a_idx, pols, pes, engine="kernel")
            want = pipe(a_idx, pols, pes, engine="torch")
            check(np.array_equal(got["dups_lb"], want["dups_lb"]), f"{label} rows {rows}: replica tensors differ")
    finally:
        fused_mod.fused_alloc_eval = real_k2
    torch.cuda.synchronize()
    k1.launches, k2.launches = saved
    out["max_abs_err"] = max(e[0] for e in errs)
    out["max_rel_err"] = max(e[1] for e in errs)
    print(f"{label}: fused == staged run_sweep over {len(sub)} configs (arrays exact, max rel err "
          f"{out['staged_rel']:.3e}); replica tensors of both engines equal; K2 == plain on "
          f"{len(errs)} chunks (replicas and leftover exact, float max abs err {out['max_abs_err']:.3e}, "
          f"max rel err {out['max_rel_err']:.3e}, limit {K2_RTOL})")

    # Fig 8 on the sweep's own numbers: rows 128, ADC 3 (the default array)
    n_top = max(p.n_pes for p in pts if p.array.rows == 128)
    ips = {p.policy: res_k.images_per_sec[i] for i, p in enumerate(pts)
           if p.array.rows == 128 and p.array.adc_bits == 3 and p.n_pes == n_top}
    print(f"{label} fig8 @ {n_top} PEs, rows 128, ADC 3: " + " ".join(f"{k}={v:.3f}" for k, v in ips.items())
          + f" blockwise_vs_weight={ips['blockwise'] / ips['weight_based']:.4f}x")
    return out


def k2_sweep_chunks(packed):
    """Every K2 call of the main path's sweep, recorded as it is made: the
    packed pipelines of ``drive_fused`` (one per geometry group) run once as
    ``run_fused_sweep`` runs them, each family's configs in chunks of 32,768.
    Returns [(rows, family, args, kwargs)] in launch order."""
    import repro_torch.dse.fused as fused_mod
    from repro_torch.kernels.fused_alloc_eval import fused_alloc_eval as k2

    calls = []
    real = fused_mod.fused_alloc_eval
    saved = k2.launches
    try:
        for pipe, a_idx, pols, pes in packed:
            def recording(*args, **kw):
                calls.append((pipe.base_array.rows, "layer" if args[0].shape[1] == pipe.L else "block", args, kw))
                return real(*args, **kw)

            fused_mod.fused_alloc_eval = recording
            pipe(a_idx, pols, pes, engine="kernel", need_dups=False)
    finally:
        fused_mod.fused_alloc_eval = real
        k2.launches = saved
    return calls


def k4_bound(b, sq, sk, h, hd, causal, elem_bytes, nkv=None):
    """(bound ms, bound_by, ops, bytes) of one K4 call: 2 products of
    2 * hd operations for each (query, visible key) pair at the inputs'
    rate (the bf16 tensor cores; float32 outside them), q read and o
    written once, and k and v read once with their ``nkv`` heads (``h``
    unless grouped)."""
    nkv = nkv or h
    m = min(sq, sk)
    pairs = (m * (m + 1) // 2 + (sq - m) * sk) if causal else sq * sk
    ops = 4 * b * h * hd * pairs
    nbytes = elem_bytes * b * hd * (2 * sq * h + 2 * sk * nkv)
    rate = BF16_OPS_PER_S if elem_bytes == 2 else LANE_OPS_PER_S
    ops_ms, bytes_ms = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), ops, nbytes


def k5_ops(nc, Q, H, P, N):
    """K5's operations by kind: (bf16 products, float32-weight products,
    element-wise).  Per cell the lower triangle of C B^T and per head S's
    (B decay)^T xdt (a multiply-add per (k, n, p)) take bf16 inputs; y's
    weights are float32 (a multiply-add per (q, k <= q, p)); per head a
    subtract, exponential and multiply per weight and the decayed B."""
    tri = Q * (Q + 1) // 2
    return nc * (2 * N * tri + H * 2 * Q * N * P), nc * H * 2 * P * tri, nc * H * (3 * tri + Q * N)


def k5_bound(nc, Q, H, P, N, elem_bytes):
    """(bound ms, bound_by, ops, bytes) of one K5 call: each kind of
    ``k5_ops`` at the rate of the unit that does it for the inputs' type
    (bf16 inputs: their products on the bf16 tensor cores, the float32
    weights' on the TF32 tensor cores, the element-wise work outside them;
    float32 inputs: all of it outside them), the kinds' times added; inputs
    read and outputs (y in the inputs' type, S float32) written once."""
    bf16_ops, f32w_ops, lane_ops = k5_ops(nc, Q, H, P, N)
    ops = bf16_ops + f32w_ops + lane_ops
    if elem_bytes == 2:
        ops_s = bf16_ops / BF16_OPS_PER_S + f32w_ops / TF32_OPS_PER_S + lane_ops / LANE_OPS_PER_S
    else:
        ops_s = ops / LANE_OPS_PER_S
    nbytes = elem_bytes * nc * (Q * H + 2 * Q * H * P + 2 * Q * N) + 4 * nc * H * N * P
    ops_ms, bytes_ms = ops_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), ops, nbytes


def k3_bound(mask, M, N, bm, bk, elem_bytes, out_bytes):
    """(bound ms, bound_by, ops, bytes) of one K3 call from its mask: the
    products of the live A tiles only (2 * N per A element of a live tile;
    a ragged last row tile counts its real rows) at the inputs' rate (bf16
    tensor cores; float32 outside them); the live A tiles, the B rows some
    live tile needs and the output, each once."""
    import torch

    live = mask.bool().cpu()
    rows = torch.full((live.shape[0],), bm, dtype=torch.int64)
    rows[-1] = M - bm * (live.shape[0] - 1)
    a_elems = int((live.sum(dim=1) * rows).sum()) * bk
    b_rows = int(live.any(dim=0).sum()) * bk
    ops = 2 * N * a_elems
    nbytes = elem_bytes * (a_elems + b_rows * N) + out_bytes * M * N
    rate = BF16_OPS_PER_S if elem_bytes == 2 else LANE_OPS_PER_S
    ops_ms, bytes_ms = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), ops, nbytes


def k5_raw_launch(cum, xdt, B, C, y, S):
    """A call that launches K5 into y and S with its C arguments built once
    (``ssd_scan._launch_args``): the kernel's own time, without the tens of
    microseconds of host work a Python call costs, which hide a small launch
    such as Mamba2-370M's."""
    from repro_torch.kernels.ssd_scan import _launch_args, _lib

    fn, args = _lib().ssd_chunk_launch, _launch_args(cum, xdt, B, C, y, S)

    def launch():
        check(fn(*args) == 0, "K5 launch refused")

    return launch


def rel_err(got, want):
    """(max |got - want|, max |got - want| / (1 + |want|)) in float32."""
    d = (got.float() - want.float()).abs()
    return float(d.max()), float((d / (1 + want.float().abs())).max())


def step_share(got, want):
    """The share of entries of ``got`` more than one bf16 step, 2^-7 of
    1 + |want|, from ``want``."""
    d = (got.float() - want.float()).abs()
    return float((d > 2.0 ** -7 * (1 + want.float().abs())).float().mean())


class swapped_ops:
    """Within the block, the models call ``k3``, ``k4`` and ``k5`` in place
    of their K3 / K4 / K5 entry points (``models.layers.zskip_matmul_op``,
    ``models.layers.flash_attention_op`` and ``models.ssm.ssd_chunk_op``);
    the package itself has no switch."""

    def __init__(self, k3, k4, k5):
        self.k3, self.k4, self.k5 = k3, k4, k5

    @classmethod
    def plain(cls):
        """The kernels' plain versions."""
        from repro_torch.kernels.flash_attention import flash_attention_op_ref
        from repro_torch.kernels.ssd_scan import ssd_chunk_ref
        from repro_torch.kernels.zskip_matmul import zskip_matmul_op_ref

        return cls(zskip_matmul_op_ref, flash_attention_op_ref, ssd_chunk_ref)

    def __enter__(self):
        import repro_torch.models.layers as layers
        import repro_torch.models.ssm as ssm

        self.saved = (layers.zskip_matmul_op, layers.flash_attention_op, ssm.ssd_chunk_op)
        layers.zskip_matmul_op, layers.flash_attention_op, ssm.ssd_chunk_op = self.k3, self.k4, self.k5
        return self

    def __exit__(self, *exc):
        import repro_torch.models.layers as layers
        import repro_torch.models.ssm as ssm

        layers.zskip_matmul_op, layers.flash_attention_op, ssm.ssd_chunk_op = self.saved
        return False


def path_inputs(params, cfg, prompts, cache_fn):
    """The first K3, K4 and K5 calls of one prefill, and the first K3 call of
    the decode step after it, recorded with their inputs (clones), and the
    zero tiles of every K3 input in that prefill and that decode step; the
    launches they make are not counted."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.kernels.ssd_scan import ssd_chunk as k5
    from repro_torch.kernels.zskip_matmul import zskip_matmul as k3
    from repro_torch.launch import serve

    seen = {"zero_tiles": {"prefill": [0, 0], "decode": [0, 0]}}
    stage = ["prefill"]

    def rec3(a, b, **kw):
        seen.setdefault("k3" if stage[0] == "prefill" else "k3_decode", ([a.clone(), b.clone()], kw))
        zero, tiles = ops.zero_tiles(a)
        seen["zero_tiles"][stage[0]][0] += zero
        seen["zero_tiles"][stage[0]][1] += tiles
        return ops.zskip_matmul_op(a, b, **kw)

    def rec4(*a, **kw):
        seen.setdefault("k4", ([t.clone() for t in a], kw))
        return ops.flash_attention_op(*a, **kw)

    def rec5(*a, **kw):
        seen.setdefault("k5", ([t.clone() for t in a], kw))
        return ops.ssd_chunk_op(*a, **kw)

    saved = (k3.launches, k4.launches, k5.launches)
    with swapped_ops(rec3, rec4, rec5):
        tok, _, cache = serve.prefill(params, cfg, prompts, cache_fn())
        if "k3" in seen:
            stage[0] = "decode"
            serve.decode(params, cfg, cache, tok, 1)
    torch.cuda.synchronize()
    k3.launches, k4.launches, k5.launches = saved
    return seen


def expected_launches(cfg, gen):
    """{kernel: (launches in the prefill, launches on the whole path)} of
    one prefill and ``gen - 1`` decode steps: K3 once per ``sq_relu`` MLP
    (dense, or an MoE's shared experts) and forward, K4 once per GQA layer or
    site in the prefill only (MLA takes none), K5 once per Mamba2 layer in the
    prefill only."""
    if cfg.family in ("dense", "moe"):
        mlp = cfg.family == "dense" or cfg.moe.n_shared
        k3 = cfg.n_layers if mlp and cfg.activation == "sq_relu" else 0
        k4 = cfg.n_layers if cfg.attn.kind == "gqa" else 0
        return {"k3": (k3, k3 * gen), "k4": (k4, k4), "k5": (0, 0)}
    n_sites = cfg.n_layers // cfg.shared_every if cfg.family == "hybrid" else 0
    return {"k3": (0, 0), "k4": (n_sites, n_sites), "k5": (cfg.n_layers, cfg.n_layers)}


def serve_full(arch, batch, prompt_len, gen, label, gpu, reps=3, n_layers=None):
    """The serving path of one FULL config on the card (cut to ``n_layers``
    if given): setup, then K3's, K4's and K5's counts set to 0 just before
    prefill + decode and read just after; the checks of what came out; then
    timings and the peak memory.  Returns the numbers the summary prints."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.kernels.ssd_scan import ssd_chunk as k5
    from repro_torch.kernels.zskip_matmul import zskip_matmul as k3
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.with_(n_layers=n_layers)
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, cache, prompts = serve.setup(cfg, batch, prompt_len, gen, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    out = {"setup_s": time.perf_counter() - t0, "params": n_params,
           "setup_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{label}: {cfg.n_layers} layers, {n_params} parameters (float32, seeded torch.Generator) on the card in "
          f"{out['setup_s']:.3f} s; {batch} prompts x {prompt_len} tokens, {gen} generated")

    def new_cache():
        return lm.init_cache(cfg, batch, prompt_len + gen, device=dev)

    kernels = {"k3": k3, "k4": k4, "k5": k5}
    want = expected_launches(cfg, gen)
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        tok, logits, cache = serve.prefill(params, cfg, prompts, cache)
        torch.cuda.synchronize()
        out["prefill_cold_s"] = time.perf_counter() - t0
        in_prefill = {n: k.launches for n, k in kernels.items()}
        rest, cache = serve.decode(params, cfg, cache, tok, gen - 1)
        torch.cuda.synchronize()
        on_path = {n: k.launches for n, k in kernels.items()}
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        for n in kernels:
            out[f"{n}_prefill"], out[f"{n}_launches"] = in_prefill[n], on_path[n]
            check((in_prefill[n], on_path[n]) == want[n],
                  f"{label}: {n.upper()} launched {in_prefill[n]} times in the prefill, {on_path[n]} on the "
                  f"path, want {want[n]}")
        print(f"{label}: main path ran (prefill + {gen - 1} decode steps), launches in the prefill / on the "
              f"path: " + ", ".join(f"{n.upper()} {in_prefill[n]} / {on_path[n]}" for n in kernels))

        # what came out
        toks = torch.cat([tok[:, None], rest], dim=1)
        check(tuple(logits.shape) == (batch, prompt_len, cfg.vocab) and logits.dtype == torch.bfloat16,
              f"{label}: logits {tuple(logits.shape)} {logits.dtype}")
        check(bool(torch.isfinite(logits).all()), f"{label}: non-finite prefill logits")
        check(tuple(toks.shape) == (batch, gen) and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
              f"{label}: tokens {tuple(toks.shape)}")
        for name, t in cache["layers"].items():
            if isinstance(t, torch.Tensor):
                check(bool(torch.isfinite(t).all()), f"{label}: non-finite cache {name}")
        for part in ("layers", "shared_sites"):
            if "len" in cache.get(part, {}):
                check(cache[part]["len"] == prompt_len + gen - 1, f"{label}: cache len {cache[part]['len']}")
        out["sample"] = toks[0, :8].tolist()
        del logits
        print(f"{label}: logits finite, shape {(batch, prompt_len, cfg.vocab)}; tokens of prompt 0: "
              f"{out['sample']}; peak device memory on the path {out['peak_gb']:.2f} GB "
              f"(torch.cuda.max_memory_allocated; {out['setup_peak_gb']:.2f} GB after setup)")

        # timings: prefill from a fresh cache, decode from the prefill's cache
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pre = []
        for _ in range(reps):
            c = new_cache()
            torch.cuda.synchronize()
            ev[0].record()
            serve.prefill(params, cfg, prompts, c)
            ev[1].record()
            ev[1].synchronize()
            pre.append(ev[0].elapsed_time(ev[1]))
        out["prefill_ms"] = pre
        dec = []
        for _ in range(2):
            c2 = new_cache()
            tok, c2 = serve.prefill(params, cfg, prompts, c2)[0::2]
            torch.cuda.synchronize()
            ev[0].record()
            serve.decode(params, cfg, c2, tok, gen - 1)
            ev[1].record()
            ev[1].synchronize()
            dec.append(ev[0].elapsed_time(ev[1]))
        del c, c2
        out["decode_ms"] = dec
        out["decode_tok_per_s"] = [batch * (gen - 1) / (ms * 1e-3) for ms in dec]
        share, win_ms, by_name = device_busy(lambda: serve.prefill(params, cfg, prompts, new_cache()))
        out["busy"], out["busy_window_ms"] = share, win_ms
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        print(f"{gpu}: {label} prefill ms (CUDA events, warm, {reps} runs): "
              + ", ".join(f"{x:.3f}" for x in pre)
              + f" (first, cold: {out['prefill_cold_s'] * 1e3:.3f} host ms); decode {gen - 1} steps: "
              + ", ".join(f"{x:.3f} ms = {t:.1f} tok/s" for x, t in zip(dec, out["decode_tok_per_s"])))
        print(f"{gpu}: {label} prefill under torch.profiler: window {win_ms:.3f} ms, device busy {share:.4f} "
              f"(idle {1 - share:.4f}); top device time: " + "; ".join(f"{n[:60]} {t:.3f} ms" for n, t in top))
        c3 = new_cache()
        tok3, c3 = serve.prefill(params, cfg, prompts, c3)[0::2]
        dshare, dwin_ms, dby_name = device_busy(lambda: serve.decode(params, cfg, c3, tok3, 1))
        del c3
        out["decode_busy"], out["decode_window_ms"] = dshare, dwin_ms
        dtop = sorted(dby_name.items(), key=lambda kv: -kv[1])[:5]
        print(f"{gpu}: {label} one decode step under torch.profiler: window {dwin_ms:.3f} ms, device busy "
              f"{dshare:.4f} (idle {1 - dshare:.4f}); top device time: "
              + "; ".join(f"{n[:60]} {t:.3f} ms" for n, t in dtop))
        out["seen"] = path_inputs(params, cfg, prompts, new_cache)
        zt = out["seen"]["zero_tiles"]
        if out["k3_launches"]:
            print(f"{label}: K3 zero tiles (128 x 128, skipped) on the path: prefill {zt['prefill'][0]} of "
                  f"{zt['prefill'][1]} = {zt['prefill'][0] / zt['prefill'][1]:.6f}, one decode step "
                  f"{zt['decode'][0]} of {zt['decode'][1]} = {zt['decode'][0] / zt['decode'][1]:.6f}")
    del params, cache
    torch.cuda.empty_cache()
    return out


def k4_numbers(q, k, v, kw, label, per, count, host_ahead=False):
    """K4 per launch on the inputs (q, k, v) and keywords ``kw`` of one of
    the path's calls: the op, its plain version and
    ``scaled_dot_product_attention`` timed, held against the plain version,
    beside its bound; printed with ``label`` and ``per`` (the launches it
    stands for, ``count``).  With ``host_ahead`` the times are the device's
    alone (see ``timed``), for calls shorter than the host's cost of one."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_op_ref

    b, sq, h, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # (b, h, s, hd) views
    ms = timed(lambda: ops.flash_attention_op(q, k, v, **kw), reps=20, host_ahead=host_ahead)
    plain_ms = timed(lambda: flash_attention_op_ref(q, k, v, **kw), reps=5)
    lib_ms = timed(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=kw["causal"], enable_gqa=nkv != h),
                   reps=20, host_ahead=host_ahead)
    err, rel = rel_err(ops.flash_attention_op(q, k, v, **kw), flash_attention_op_ref(q, k, v, **kw))
    check(rel <= K4_TOL[str(q.dtype).split(".")[1]], f"{label}: K4 vs plain on the path's inputs {rel}")
    bound, by, n_ops, nbytes = k4_bound(b, sq, sk, h, hd, kw["causal"], q.element_size(), nkv)
    print(f"{label} K4 per launch at q {tuple(q.shape)}, {sk} keys on {nkv} kv heads, {q.dtype}, {kw}: "
          f"{ms:.4f} ms ({per}: {ms * count:.3f} ms), plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention{' (enable_gqa)' if nkv != h else ''} {lib_ms:.4f} ms (kernel / SDPA "
          f"{ms / lib_ms:.3f}x), bound {bound:.4f} ms ({by}: {n_ops:.4e} ops at {BF16_OPS_PER_S / 1e12:.0f} "
          f"TFLOP/s bf16, {nbytes} B at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), {n_ops / (ms * 1e-3) / 1e12:.2f} "
          f"TFLOP/s achieved{' (device time alone)' if host_ahead else ''}; max |kernel - plain| {err:.3e} "
          f"(relative to 1 + |plain|: {rel:.3e})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by, err=err)


def kernel_numbers(path, gpu, label):
    """K3, K4 and K5 per launch on the path's own first inputs, for those the
    path ran: kernel, plain version, the library call (K3: ``torch.matmul``,
    K4: ``scaled_dot_product_attention``) and bounds.  ``path``: what
    ``serve_full`` returned."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.kernels.ssd_scan import ssd_chunk as k5, ssd_chunk_ref
    from repro_torch.kernels.zskip_matmul import _launch as k3_launch, block_mask, zskip_matmul as k3, zskip_matmul_op_ref

    seen = path["seen"]
    launches = {n: path[f"{n}_prefill"] for n in ("k3", "k4", "k5")}
    res = {}
    saved = (k3.launches, k4.launches, k5.launches)
    for key in ("k3", "k3_decode"):
        if key not in seen:
            continue
        (a, b), kw = seen[key]
        M, K = a.shape
        N = b.shape[1]
        ms = timed(lambda: ops.zskip_matmul_op(a, b, **kw), reps=20)
        mask = block_mask(a)
        kernel_ms = timed(lambda: k3_launch(a, b, mask, 128, 128, a.dtype), reps=20)
        plain_ms = timed(lambda: zskip_matmul_op_ref(a, b), reps=5)
        lib_ms = timed(lambda: torch.matmul(a, b), reps=20)
        err, rel = rel_err(ops.zskip_matmul_op(a, b, **kw), zskip_matmul_op_ref(a, b))
        tol = K3_TOL[str(a.dtype).split(".")[1]]
        check(rel <= tol, f"{label}: K3 vs plain on the path's inputs {rel} (limit {tol})")
        bound, by, n_ops, nbytes = k3_bound(mask, M, N, 128, 128, a.element_size(), a.element_size())
        res[key] = dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                        bound_by=by, err=err)
        print(f"{gpu}: {label} K3 per launch ({'prefill' if key == 'k3' else 'decode'}) at ({M}, {K}) @ ({K}, {N}) "
              f"{a.dtype}, the op with its mask: {ms:.4f} ms ({launches['k3']} per forward: "
              f"{ms * launches['k3']:.3f} ms), the kernel alone {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.matmul {lib_ms:.4f} ms (kernel / matmul {kernel_ms / lib_ms:.3f}x, op / matmul "
              f"{ms / lib_ms:.3f}x), bound {bound:.4f} ms ({by}: {n_ops:.4e} ops at {BF16_OPS_PER_S / 1e12:.0f} "
              f"TFLOP/s bf16, {nbytes} B at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), "
              f"{n_ops / (kernel_ms * 1e-3) / 1e12:.2f} TFLOP/s achieved by the kernel; "
              f"max |kernel - plain| {err:.3e} (relative to 1 + |plain|: {rel:.3e})")
    if "k4" in seen:
        (q, k, v), kw = seen["k4"]
        res["k4"] = k4_numbers(q, k, v, kw, f"{gpu}: {label}", f"{launches['k4']} per prefill", launches["k4"])
    if "k5" in seen:
        (cum, xdt, B, C), kw = seen["k5"]
        nc, Q, H, P = xdt.shape
        N = B.shape[-1]
        ms = timed(lambda: ops.ssd_chunk_op(cum, xdt, B, C, **kw), reps=20)
        y, st = ops.ssd_chunk_op(cum, xdt, B, C, **kw)
        kernel_ms = timed(k5_raw_launch(cum, xdt, B, C, y, st), reps=50)  # into y and S again
        plain_ms = timed(lambda: ssd_chunk_ref(cum, xdt, B, C), reps=5)
        y, st = ops.ssd_chunk_op(cum, xdt, B, C, **kw)
        yp, sp = ssd_chunk_ref(cum, xdt, B, C)
        err = rel = 0.0
        for g, w in ((y, yp), (st, sp)):
            e, r = rel_err(g, w)
            err, rel = max(err, e), max(rel, r)
        tol = K5_TOL[str(xdt.dtype).split(".")[1]]
        check(rel <= tol, f"{label}: K5 vs plain on the path's inputs {rel} (limit {tol})")
        bound, by, n_ops, nbytes = k5_bound(nc, Q, H, P, N, xdt.element_size())
        res["k5"] = dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound,
                         bound_by=by, err=err)
        print(f"{gpu}: {label} K5 per launch at cells {nc}, Q {Q}, H {H}, P {P}, N {N} {xdt.dtype}: {ms:.4f} ms "
              f"through the wrapper ({launches['k5']} per prefill: {ms * launches['k5']:.3f} ms), the kernel alone "
              f"{kernel_ms:.4f} ms ({nbytes / (kernel_ms * 1e-3) / 1e12:.3f} TB/s), plain {plain_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by}: {nbytes} B at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; {n_ops:.4e} ops, bf16 "
              f"products at {BF16_OPS_PER_S / 1e12:.0f}, float32-weight products at {TF32_OPS_PER_S / 1e12:.0f} "
              f"(TF32), element-wise at {LANE_OPS_PER_S / 1e12:.0f} TFLOP/s), "
              f"{n_ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s achieved; max |kernel - plain| {err:.3e} "
              f"(relative to 1 + |plain|: {rel:.3e}); library_ms: null (no single PyTorch call computes the SSD "
              f"chunk terms)")
    torch.cuda.synchronize()
    k3.launches, k4.launches, k5.launches = saved
    return res


def end_to_end_vs_plain(arch, seed, n_layers=None):
    """``arch`` at full width in float32 (cut to ``n_layers`` if given),
    ``E2E`` prompts, with the kernels
    (each launched as often as ``expected_launches`` says) and then with the
    plain versions swapped in (no launch): logits within ``E2E_TOL`` of max
    |logit|, tokens equal."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.kernels.ssd_scan import ssd_chunk as k5
    from repro_torch.kernels.zskip_matmul import zskip_matmul as k3
    from repro_torch.launch import serve
    from repro_torch.models import lm

    dev = torch.device("cuda")
    saved = (k3.launches, k4.launches, k5.launches)
    cfg = get_config(arch).with_(dtype="float32")
    if n_layers is not None:
        cfg = cfg.with_(n_layers=n_layers)
    b, s, gen = E2E["batch"], E2E["prompt_len"], E2E["gen"]
    params, _, prompts = serve.setup(cfg, b, s, gen, device=dev, seed=seed)
    want_kernels = tuple(n[1] for n in expected_launches(cfg, gen).values())
    runs = {}
    with torch.inference_mode():
        for name, swap in (("kernels", None), ("plain", swapped_ops.plain())):
            cache = lm.init_cache(cfg, b, s + gen, device=dev)
            before = (k3.launches, k4.launches, k5.launches)
            if swap is None:
                tok, logits, cache = serve.prefill(params, cfg, prompts, cache)
                rest, cache = serve.decode(params, cfg, cache, tok, gen - 1)
            else:
                with swap:
                    tok, logits, cache = serve.prefill(params, cfg, prompts, cache)
                    rest, cache = serve.decode(params, cfg, cache, tok, gen - 1)
            torch.cuda.synchronize()
            used = (k3.launches - before[0], k4.launches - before[1], k5.launches - before[2])
            want = want_kernels if swap is None else (0, 0, 0)
            check(used == want, f"end to end {arch}, {name}: K3/K4/K5 launched {used}, want {want}")
            runs[name] = (logits.float(), torch.cat([tok[:, None], rest], dim=1))
            del logits, cache
    (lk, tk), (lp, tp) = runs["kernels"], runs["plain"]
    rel = float((lk - lp).abs().max() / lp.abs().max())
    check(bool(torch.isfinite(lk).all()), f"end to end {arch}: non-finite logits")
    check(rel <= E2E_TOL, f"end to end {arch}: kernels vs plain logits off by {rel} of max |logit| (limit {E2E_TOL})")
    check(torch.equal(tk, tp), f"end to end {arch}: tokens differ {tk.tolist()} vs {tp.tolist()}")
    print(f"{arch} float32 ({cfg.n_layers} layers), {b} prompts x {s} tokens + {gen}: kernels (K3/K4/K5 launches {want_kernels}) vs plain "
          f"versions end to end, logits max |diff| {rel:.3e} of max |logit| (limit {E2E_TOL}), tokens equal "
          f"{tk[0].tolist()}")
    del params, runs, lk, lp
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    k3.launches, k4.launches, k5.launches = saved
    return rel


def smoke_card_vs_host(arch):
    """The SMOKE config in float32: the same parameters on the host (plain
    versions) and on the card (kernels, each launched as often as
    ``expected_launches`` says), a prompt of 40 and 3 decode steps; logits
    within 1e-4 of max |logit|, tokens and (MoE) routing records equal."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.kernels.ssd_scan import ssd_chunk as k5
    from repro_torch.kernels.zskip_matmul import zskip_matmul as k3
    from repro_torch.launch import serve
    from repro_torch.models import layers, lm

    saved = (k3.launches, k4.launches, k5.launches)
    small = get_config(arch, smoke=True).with_(dtype="float32")
    host = lm.init_params(small, generator=torch.Generator().manual_seed(0), device="cpu")
    card = lm.LM(small, None, torch.device("cuda"))
    card.load_state_dict(host.state_dict())
    toks = torch.randint(0, small.vocab, (2, 40), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        outs = []
        for model, d in ((host, "cpu"), (card, "cuda")):
            with layers.capture_routing() as records:
                cache = lm.init_cache(small, 2, 44, device=d)
                tok, logits, cache = serve.prefill(model, small, toks.to(d), cache)
                rest, _ = serve.decode(model, small, cache, tok, 3)
            outs.append((logits.float().cpu(), torch.cat([tok[:, None], rest], dim=1).cpu(), records))
    torch.cuda.synchronize()
    used = (k3.launches - saved[0], k4.launches - saved[1], k5.launches - saved[2])
    want = tuple(n[1] for n in expected_launches(small, 4).values())
    check(used == want, f"smoke {arch}: K3/K4/K5 launched {used} on the card, want {want}")
    rel_s = float((outs[0][0] - outs[1][0]).abs().max() / outs[0][0].abs().max())
    check(rel_s <= 1e-4 and torch.equal(outs[0][1], outs[1][1]),
          f"smoke {arch}: card vs host logits {rel_s}, tokens {outs[0][1].tolist()} vs {outs[1][1].tolist()}")
    rec_h, rec_c = outs[0][2], outs[1][2]
    check(len(rec_h) == len(rec_c) and all(np.array_equal(a, b) for a, b in zip(rec_h, rec_c)),
          f"smoke {arch}: routing records differ between card and host")
    routed = f", {len(rec_c)} routing records equal" if rec_c else ""
    print(f"{arch} SMOKE float32: card (K3/K4/K5 launches {used}) vs host (plain versions), logits max |diff| "
          f"{rel_s:.3e} of max |logit| (limit 1e-4), tokens equal{routed}")
    k3.launches, k4.launches, k5.launches = saved
    return rel_s


def k4_card_checks():
    """K4 against its plain version at the serving path's sizes and edge cases: returns the
    max |err| per dtype."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention as k4, flash_attention_op_ref, flash_attention_ref

    dev = torch.device("cuda")
    saved = k4.launches
    rng = np.random.default_rng(0)
    worst = {}
    apart = {False: (0.0, 1.0), True: (0.0, 1.0)}
    for dt in ("float32", "bfloat16"):
        tol, tdt = K4_TOL[dt], getattr(torch, dt)
        for hd in (16, 64, 128):
            for s in (1, 77, 200, 1000, 1024):
                q, k, v = (torch.from_numpy(rng.standard_normal((8, s, hd), dtype=np.float32)).to(dev, tdt)
                           for _ in range(3))
                for causal in (True, False):
                    got, want = k4(q, k, v, causal=causal), flash_attention_ref(q, k, v, causal)
                    err = float((got.float() - want.float()).abs().max())
                    check(err <= tol, f"K4 {dt} hd {hd} s {s} causal {causal}: max |err| {err} > {tol}")
                    worst[dt] = max(worst.get(dt, 0.0), err)
        q, k, v = (torch.from_numpy(rng.standard_normal((4, 1024, 32, 64), dtype=np.float32)).to(dev, tdt)
                   for _ in range(3))
        err = float((ops.flash_attention_op(q, k, v, causal=True).float()
                     - flash_attention_op_ref(q, k, v, causal=True).float()).abs().max())
        check(err <= tol, f"K4 {dt} on the model layout (4, 1024, 32, 64): max |err| {err}")
        worst[dt] = max(worst[dt], err)
        # the scores rounded to the inputs' type first (the model's prompt
        # attention), grouped 4 q on 2 kv heads, ragged s; unit-scale inputs,
        # as the tolerance assumes: where two float32 sums of a score fall on
        # two sides of a bf16 rounding boundary they round one step apart
        for hd in (16, 64, 128):
            q = torch.from_numpy(rng.standard_normal((2, 200, 4, hd), dtype=np.float32)).to(dev, tdt)
            k, v = (torch.from_numpy(rng.standard_normal((2, 200, 2, hd), dtype=np.float32)).to(dev, tdt)
                    for _ in range(2))
            for causal in (True, False):
                err, rel = rel_err(ops.flash_attention_op(q, k, v, causal=causal, round_scores=True),
                                   flash_attention_op_ref(q, k, v, causal, round_scores=True))
                check(rel <= tol, f"K4 {dt} hd {hd} causal {causal} round_scores: max |err| {err}, relative to "
                                  f"1 + |plain| {rel}")
                worst[dt] = max(worst[dt], err)
        # the same at N(0, 2^2), where the rounding moves about a tenth of
        # the outputs by more than a step: the kernel with either keyword
        # is held to the plain version with the same one by the share of
        # entries a step apart (a rounding flip moves a few entries by more
        # than the tolerance), and must be apart from the other one
        if dt == "bfloat16":
            for hd in (64, 128):
                for s in (200, 1024):
                    q = torch.from_numpy(2 * rng.standard_normal((2, s, 12, hd), dtype=np.float32)).to(dev, tdt)
                    k, v = (torch.from_numpy(2 * rng.standard_normal((2, s, 2, hd), dtype=np.float32)).to(dev, tdt)
                            for _ in range(2))
                    want = {r: flash_attention_op_ref(q, k, v, True, round_scores=r) for r in (False, True)}
                    for rounded in (False, True):
                        got = ops.flash_attention_op(q, k, v, causal=True, round_scores=rounded)
                        same, other = step_share(got, want[rounded]), step_share(got, want[not rounded])
                        check(same <= K4_STEP_SHARE and other >= K4_APART,
                              f"K4 bf16 N(0, 4) (2, {s}, 12 q / 2 kv, {hd}) round_scores={rounded}: share more "
                              f"than a step from the plain version with the same keyword {same} (limit "
                              f"{K4_STEP_SHARE}), with the other {other} (at least {K4_APART})")
                        apart[rounded] = (max(apart[rounded][0], same), min(apart[rounded][1], other))
        # fewer or more keys than queries (the causal mask counts both from 0)
        for sq, sk in ((200, 77), (77, 200)):
            q = torch.from_numpy(rng.standard_normal((8, sq, 64), dtype=np.float32)).to(dev, tdt)
            k, v = (torch.from_numpy(rng.standard_normal((8, sk, 64), dtype=np.float32)).to(dev, tdt)
                    for _ in range(2))
            for causal in (True, False):
                err = float((k4(q, k, v, causal=causal).float() - flash_attention_ref(q, k, v, causal).float()).abs().max())
                check(err <= tol, f"K4 {dt} sq {sq} sk {sk} causal {causal}: max |err| {err}")
                worst[dt] = max(worst[dt], err)
        # rows that are not 16-byte aligned: float32 reads them by stride, bf16 copies them first
        for s in (77, 1000):
            q, k, v = (torch.from_numpy(rng.standard_normal((8, s, 65), dtype=np.float32)).to(dev, tdt)[..., :64]
                       for _ in range(3))
            for causal in (True, False):
                err = float((k4(q, k, v, causal=causal).float() - flash_attention_ref(q, k, v, causal).float()).abs().max())
                check(err <= tol, f"K4 {dt} s {s} causal {causal}, unaligned rows: max |err| {err}")
                worst[dt] = max(worst[dt], err)
    for dt, err in encdec_k4_checks().items():
        worst[dt] = max(worst[dt], err)
    torch.cuda.synchronize()
    k4.launches = saved
    print("K4 vs plain, float32 and bfloat16 x hd (16, 64, 128) x s (1, 77, 200, 1000, 1024) x causal and not, "
          "(4, 1024, 32, 64) by stride, round_scores at (2, 200, 4 q / 2 kv heads, hd 16 / 64 / 128; held "
          "relative to 1 + |plain|), sq != sk, and rows not 16-byte aligned: max |err| "
          + ", ".join(f"{d} {e:.3e} (limit {K4_TOL[d]})" for d, e in worst.items()))
    print("K4 bf16 round_scores told apart at N(0, 2^2), (2, 200 / 1024, 12 q / 2 kv heads, hd 64 / 128), causal: "
          + "; ".join(f"round_scores={r}: at most {a[0]:.3e} of entries a step from the plain version with the "
                      f"same keyword (limit {K4_STEP_SHARE}), at least {a[1]:.3e} from the other (limit {K4_APART})"
                      for r, a in apart.items()))
    return max(worst.values())


def k5_card_checks():
    """K5 against its plain version at the path's shapes (the Hopper kernel
    in bf16), at shapes whose work queue is ragged, and at small ones (the
    mma.sync kernel in bf16); y and S held apart, each relative to
    1 + |plain|, as the reference's allclose.  Each shape runs twice: the
    work queue must be back at zero after a launch."""
    import numpy as np
    import torch

    from repro_torch.kernels.ssd_scan import ssd_chunk as k5, ssd_chunk_ref

    dev = torch.device("cuda")
    saved = k5.launches
    rng = np.random.default_rng(1)
    worst_abs, worst_rel = 0.0, {}
    shapes = K5_SHAPES + ((3, 32, 4, 16, 32), (5, 16, 3, 16, 16), (3, 48, 5, 24, 48), (2, 77, 5, 24, 40))
    ragged = shapes[-1]  # Q and N off the bf16 kernels' multiples of 16: float32 only
    for dt in ("float32", "bfloat16"):
        tdt = getattr(torch, dt)
        for nc, Q, H, P, N in shapes:
            dtv = np.log1p(np.exp(rng.standard_normal((nc, Q, H)))) * 0.1
            ins = [np.cumsum(-dtv, axis=1), rng.standard_normal((nc, Q, H, P)) * 0.5,
                   rng.standard_normal((nc, Q, N)), rng.standard_normal((nc, Q, N))]
            cum, xdt, B, C = (torch.from_numpy(a.astype(np.float32)).to(dev, tdt) for a in ins)
            if dt == "bfloat16" and (nc, Q, H, P, N) == ragged:
                try:
                    k5(cum, xdt, B, C)
                except ValueError:
                    continue
                raise AssertionError(f"K5 bfloat16 took {ragged}, a shape its kernel does not take")
            yp, sp = ssd_chunk_ref(cum, xdt, B, C)
            for rep in range(2):
                y, st = k5(cum, xdt, B, C)
                for g, w, what in ((y.float(), yp.float(), "y"), (st, sp, "S")):
                    d = (g - w).abs()
                    rel = float((d / (1 + w.abs())).max())
                    check(rel <= K5_TOL[dt], f"K5 {dt} {(nc, Q, H, P, N)} launch {rep} {what}: err {rel}")
                    worst_abs = max(worst_abs, float(d.max()))
                    worst_rel[(dt, what)] = max(worst_rel.get((dt, what), 0.0), rel)
    torch.cuda.synchronize()
    k5.launches = saved
    print(f"K5 vs plain, float32 and bfloat16 at {shapes} (nc, Q, H, P, N; bfloat16 refuses {ragged}; the "
          f"first four on the Hopper kernel in bfloat16), each twice: max |err| {worst_abs:.3e}; relative to "
          f"1 + |plain| " + ", ".join(f"{d} {w} {e:.3e} (limit {K5_TOL[d]})" for (d, w), e in worst_rel.items()))
    return worst_abs


def k3_card_checks(gpu):
    """K3 against its plain version in float32 and bf16: the reference's
    test shapes (derived masks; random masks at four densities with tiles of
    64 and 128, all-zero and all-ones among them; both output types),
    ragged M, N and K through the op, and Nemotron-4-15B's down-projection
    at its prefill and decode shapes in bf16.  Then the structured input of
    the reference's kernel benchmark (half the 128 x 128 tiles of A zero, a
    checkerboard) scaled to the prefill shape, timed against the same shape
    dense.  Returns (max |err|, the timings)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.zskip_matmul import (
        block_mask,
        block_mask_ref,
        zskip_matmul as k3,
        zskip_matmul_op_ref,
        zskip_matmul_ref,
    )

    dev = torch.device("cuda")
    saved = k3.launches
    rng = np.random.default_rng(3)
    worst_abs, worst_rel = 0.0, {}

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    def held(got, want, tol, what):
        nonlocal worst_abs
        err, rel = rel_err(got, want)
        check(rel <= tol, f"K3 {what}: max |err| {err}, relative to 1 + |plain| {rel} (limit {tol})")
        worst_abs = max(worst_abs, err)
        return rel

    for dt in ("float32", "bfloat16"):
        tdt, tol = getattr(torch, dt), K3_TOL[dt]
        rels = []
        for M, K, N in ((128, 128, 128), (256, 384, 128), (384, 256, 256)):
            keep = torch.from_numpy(rng.random((M // 128, K // 128)) < 0.5).to(dev)
            a = (torch.relu(randn(M, K)) * keep.repeat_interleave(128, 0).repeat_interleave(128, 1)).to(tdt)
            b = randn(K, N).to(tdt)
            mask = block_mask(a)
            check(torch.equal(mask, block_mask_ref(a, 128, 128)), f"K3 {dt} {(M, K, N)}: device mask")
            rels.append(held(k3(a, b, mask), zskip_matmul_ref(a, b, mask, 128, 128), tol, f"{dt} {(M, K, N)}"))
        # the reference's random-mask shapes; in bf16 also a grid of many blocks
        # (in float32 its full-range sums over K = 2048 differ from cuBLAS's
        # by more than the reference's 1e-4, a matter of summation order)
        shapes = ((128, 256, 128, 64), (192, 64, 128, 64), (64, 320, 192, 64), (128, 128, 128, 128))
        for M, K, N, t in shapes + (((1024, 2048, 512, 128),) if dt == "bfloat16" else ()):
            a, b = randn(M, K).to(tdt), randn(K, N).to(tdt)
            for density in (0.0, 0.3, 0.7, 1.0):
                mask = torch.from_numpy((rng.random((M // t, K // t)) < density).astype(np.int32)).to(dev)
                for out in (torch.float32, torch.bfloat16):
                    got = k3(a, b, mask, bm=t, bn=t, bk=t, out_dtype=out)
                    want = zskip_matmul_ref(a, b, mask, t, t, out)
                    o_tol = K3_TOL["bfloat16"] if out == torch.bfloat16 else tol
                    rels.append(held(got, want, o_tol, f"{dt} {(M, K, N)} tile {t} density {density} out {out}"))
                    if density == 0.0:
                        check(not got.float().any(), f"K3 {dt} {(M, K, N)}: all-zero mask, nonzero output")
        for M, K, N in ((400, 1024, 512), (4, 4096, 1024), (4, 256, 64), (400, 256, 64), (130, 200, 64)):
            a, b = torch.relu(randn(M, K)).to(tdt), randn(K, N).to(tdt)
            rels.append(held(ops.zskip_matmul_op(a, b), zskip_matmul_op_ref(a, b), tol, f"{dt} op ragged {(M, K, N)}"))
        worst_rel[dt] = max(rels)

    # bf16: M over many waves of the persistent grid, ragged M and N (N off
    # TMA's 8-element rows: the op copies B with zero columns added)
    M, K, N = K3_WAVES
    a = torch.relu(randn(M, K)).to(torch.bfloat16)
    b = (randn(K, N) / K ** 0.5).to(torch.bfloat16)
    worst_rel[f"{M} x {N}"] = held(ops.zskip_matmul_op(a, b), zskip_matmul_op_ref(a, b), K3_TOL["bfloat16"],
                                   f"many waves {(M, K, N)}")
    del a, b

    # Nemotron-4-15B's down-projection: relu(x @ w_up)^2 rows against w_down, bf16
    timing = {}
    M_pre, FF, D = NEMOTRON_DOWN
    b = (randn(FF, D) / FF ** 0.5).to(torch.bfloat16)
    for M in (4, M_pre):
        a = torch.square(torch.relu(randn(M, FF))).to(torch.bfloat16)
        worst_rel[f"nemotron {M} rows"] = held(ops.zskip_matmul_op(a, b), zskip_matmul_op_ref(a, b), K3_TOL["bfloat16"],
                                               f"Nemotron down-projection ({M}, {FF}) @ ({FF}, {D})")
    # the structured input of benchmarks/run.py:269-272 at the prefill shape
    # (a checkerboard of 128 x 128 tiles), against the same activations with
    # no zero tile
    dense = torch.relu(randn(M_pre, FF)).to(torch.bfloat16)
    tiles = torch.arange(M_pre // 128, device=dev)[:, None] + torch.arange(FF // 128, device=dev)[None, :]
    keep = (tiles % 2 == 0).repeat_interleave(128, 0).repeat_interleave(128, 1)
    structured = dense * keep.to(torch.bfloat16)
    for name, a in (("dense", dense), ("structured", structured)):
        mask = block_mask(a)
        held(ops.zskip_matmul_op(a, b), zskip_matmul_op_ref(a, b), K3_TOL["bfloat16"], f"{name} ({M_pre}, {FF})")
        ms = timed(lambda: ops.zskip_matmul_op(a, b), reps=10)
        kernel_ms = timed(lambda: k3(a, b, mask), reps=10)
        lib_ms = timed(lambda: torch.matmul(a, b), reps=10)
        bound, by, n_ops, nbytes = k3_bound(mask, M_pre, D, 128, 128, 2, 2)
        zero = int(mask.numel() - mask.sum())
        timing[name] = dict(ms=ms, kernel_ms=kernel_ms, library_ms=lib_ms, bound_ms=bound, zero=zero)
        print(f"{gpu}: K3 {name} input ({M_pre}, {FF}) @ ({FF}, {D}) bf16, {zero} of {mask.numel()} A tiles zero: "
              f"op {ms:.4f} ms (mask + kernel), kernel alone {kernel_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms "
              f"(kernel / matmul {kernel_ms / lib_ms:.3f}x, op / matmul {ms / lib_ms:.3f}x), bound with the skipped "
              f"tiles' work taken out {bound:.4f} ms ({by}: {n_ops:.4e} ops, {nbytes} B), "
              f"{n_ops / (kernel_ms * 1e-3) / 1e12:.2f} TFLOP/s achieved on the live tiles")
    print(f"{gpu}: K3 structured vs dense at the prefill shape: kernel {timing['dense']['kernel_ms'] / timing['structured']['kernel_ms']:.3f}x "
          f"faster with half the tiles skipped (the bound: {timing['dense']['bound_ms'] / timing['structured']['bound_ms']:.3f}x)")
    torch.cuda.synchronize()
    k3.launches = saved
    print("K3 vs plain, float32 and bfloat16: the reference's test shapes with derived masks, random masks at "
          "densities 0, 0.3, 0.7, 1 with tiles of 64 and 128 and both output types, ragged M, N and K through the "
          "op, Nemotron's down-projection at 4 and 4096 rows, the structured and dense prefill inputs: max |err| "
          f"{worst_abs:.3e}; relative to 1 + |plain| "
          + ", ".join(f"{d} {e:.3e}" for d, e in worst_rel.items()) + f" (limits {K3_TOL})")
    del dense, structured, b, a
    torch.cuda.empty_cache()
    return worst_abs, timing


def k4_grouped_checks(gpu):
    """Grouped kv heads in K4 against the plain version: the dense models'
    prefill shapes in bf16, causal (Nemotron-4-15B 48 q on 8 kv heads,
    GLM-4-9B 32 on 2, Qwen2-VL-2B 12 on 2, head dim 128), each timed beside
    its bound and SDPA with ``enable_gqa``; and small float32 shapes with
    groups of 1, 2, 6 and 16, causal and not.  Returns the max |err|."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention as k4, flash_attention_op_ref

    dev = torch.device("cuda")
    saved = k4.launches
    rng = np.random.default_rng(4)
    worst = 0.0

    def randn(*shape, dt):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dt)

    b, s = DENSE["batch"], DENSE["prompt_len"]
    for label, (nq, nkv) in DENSE_HEADS.items():
        q = randn(b, s, nq, 128, dt=torch.bfloat16)
        k, v = (randn(b, s, nkv, 128, dt=torch.bfloat16) for _ in range(2))
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = timed(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, enable_gqa=True), reps=20)
        bound, by, n_ops, nbytes = k4_bound(b, s, s, nq, 128, True, 2, nkv)
        # the Pallas kernel's function, and the model's (scores rounded to bf16 first)
        for rounded in (False, True):
            err, rel = rel_err(ops.flash_attention_op(q, k, v, causal=True, round_scores=rounded),
                               flash_attention_op_ref(q, k, v, True, round_scores=rounded))
            check(rel <= K4_TOL["bfloat16"], f"K4 grouped {label} round_scores={rounded}: relative err {rel}")
            worst = max(worst, err)
            ms = timed(lambda: ops.flash_attention_op(q, k, v, causal=True, round_scores=rounded), reps=20)
            print(f"{gpu}: K4 grouped at {label}'s prefill shape ({b}, {s}, {nq} q / {nkv} kv heads, 128) bf16 "
                  f"causal, round_scores={rounded}: {ms:.4f} ms, scaled_dot_product_attention (enable_gqa) "
                  f"{lib_ms:.4f} ms (kernel / SDPA {ms / lib_ms:.3f}x), bound {bound:.4f} ms ({by}: {n_ops:.4e} ops, "
                  f"{nbytes} B), {n_ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s achieved; max |kernel - plain| {err:.3e}")
    for group in (1, 2, 6, 16):
        for causal in (True, False):
            q = randn(2, 77, 2 * group, 64, dt=torch.float32)
            k, v = (randn(2, 77, 2, 64, dt=torch.float32) for _ in range(2))
            err, rel = rel_err(ops.flash_attention_op(q, k, v, causal=causal),
                               flash_attention_op_ref(q, k, v, causal))
            check(rel <= K4_TOL["float32"], f"K4 grouped float32 group {group} causal {causal}: {rel}")
            worst = max(worst, err)
    torch.cuda.synchronize()
    k4.launches = saved
    print(f"K4 grouped vs plain: bf16 at the three dense prefill shapes with and without round_scores, float32 "
          f"with groups 1, 2, 6, 16: max |err| {worst:.3e}")
    return worst


# ---------------------------------------------------------------- the fabric
class VTRecorder:
    """Keeps the arguments of every VT call the fabric's entry points make
    (``fabric.vtime`` and ``dse.fused`` bind ``vtime_scan`` by name), so the
    kernel can be timed on the path's own inputs afterwards.  The calls go
    through unchanged."""

    def __enter__(self):
        import repro_torch.dse.fused as fused_mod
        import repro_torch.fabric.vtime as vtime_mod
        from repro_torch.kernels.vtime_scan import vtime_scan

        self.mods, self.real, self.calls = (fused_mod, vtime_mod), vtime_scan, []

        def recording(*args, **kw):
            self.calls.append((args, kw))
            return vtime_scan(*args, **kw)

        for mod in self.mods:
            mod.vtime_scan = recording
        return self

    def __exit__(self, *exc):
        for mod in self.mods:
            mod.vtime_scan = self.real


def vt_chain_ns(device, with_min=True, iters=1 << 22) -> float:
    """ns a step of one thread's dependent chain x <- min(x + s, y) in FP64,
    VT's min (a compare and a select), or of x <- x + s alone
    (``vtime_chain_probe_launch``, built with VT), by CUDA events."""
    import ctypes

    import torch

    from repro_torch.kernels import _build

    fn = _build.load("vtime_scan").vtime_chain_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double, ctypes.c_double, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    x = torch.zeros(1, dtype=torch.float64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    check(fn(x.data_ptr(), 1024, 1.0, float("inf"), int(with_min), stream) == 0, "VT chain probe: launch failed")
    ms = timed(lambda: fn(x.data_ptr(), iters, 1.0, float("inf"), int(with_min), stream), reps=3)
    return ms * 1e6 / iters


def vt_paths(lanes, blocks, jobs, n, conc, chain):
    """(critical-path job steps, its ns, serial job steps) of a launch's
    longest config: the longest dependency path through the (request,
    layer) grid (``kernels.vtime_scan.critical_path``), each job priced at
    the probe's add alone where every pool of its layer has at most one
    server, else add + min (``chain`` = (add + min ns, add ns)); the serial
    chain is every job of a config one after another (N x sum_l jobs_l), the
    bound before stages."""
    import numpy as np

    from repro_torch.kernels.vtime_scan import chain_weights, critical_path

    jobs = np.broadcast_to(np.asarray(jobs, dtype=np.int64), (lanes.shape[0], len(blocks)))
    w = chain_weights(lanes, blocks, chain[1], chain[0])
    keys = {(tuple(j), tuple(x)) for j, x in zip(jobs.tolist(), w.tolist())}
    crit_ns = max(critical_path(j, n, conc, x) for j, x in keys)
    crit_steps = max(critical_path(j, n, conc) for j in {k[0] for k in keys})
    return int(crit_steps), crit_ns, int(n * jobs.sum(axis=1).max())


def stage_jobs(plan, jobs):
    """Each stage's jobs a request (the most over configs) under ``plan``."""
    import numpy as np

    top = np.asarray(jobs, dtype=np.int64).reshape(-1, plan.split[-1]).max(axis=0)
    return [int(top[a:b].sum()) for a, b in zip(plan.split[:-1], plan.split[1:])]


def vt_work(args, kw):
    """(bytes a call must move, FP64 operations this run's data needs) for
    one VT call: the sample indices, the tables, the lanes, variants,
    arrivals and transfers read once and the outputs written once; the
    operations are, per job and pool with d servers, one add and d max + d
    min (pools without servers do none)."""
    import numpy as np

    tables, idx, patches, variant, lanes = args
    n = kw["n_requests"]
    C = len(variant)
    ln = np.asarray(lanes, dtype=np.int64)
    nbytes = tables.flat.numel() * 8 + idx.numel() * 4 + ln.size * 4 + C * 4
    for key in ("arrivals", "xfer"):
        if kw.get(key) is not None:
            nbytes += kw[key].numel() * 8
    nbytes += 2 * C * n * 8 + (2 * C * len(patches) * 8 if kw.get("collect_stats") else 0)
    ops, off = 0, 0
    for b, p in zip(tables.blocks, patches):
        d = ln[:, off : off + b]
        off += b
        ops += n * p * int(((1 + 2 * d) * (d > 0)).sum())
    return nbytes, ops


def vt_numbers(call, chain_ns, reps):
    """VT on one recorded call's inputs: ms through the wrapper (with its
    checks) and alone (the packed problem, CUDA events), and its bound: the
    larger of the critical path (``vt_paths``) and the bytes at the
    memory's rate.  The old serial chain (every job of the longest config
    one after another at one add + min) is kept beside it.  No launch may
    read below its bound."""
    import numpy as np

    from repro_torch.kernels import vtime_scan as vtk

    args, kw = call
    saved = vtk.vtime_scan.launches
    ms = timed(lambda: vtk.vtime_scan(*args, **kw), reps=reps)
    stats = kw.get("collect_stats", False)
    packed = vtk._pack(vtk._prepare(*args, kw["n_requests"], kw.get("arrivals"), kw.get("concurrency"),
                                    kw.get("xfer")), stats)
    kernel_ms = timed(lambda: vtk._launch(packed, stats), reps=reps)
    vtk.vtime_scan.launches = saved
    nbytes, ops = vt_work(args, kw)
    lanes = np.asarray(args[4])
    blocks, patches = list(args[0].blocks), list(args[2])
    crit_steps, crit_ns, steps = vt_paths(lanes, blocks, patches, kw["n_requests"], kw.get("concurrency"), chain_ns)
    chain_ms, serial_ms = crit_ns * 1e-6, steps * chain_ns[0] * 1e-6
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = dict(ms=ms, kernel_ms=kernel_ms, steps=steps, crit_steps=crit_steps, nbytes=nbytes, ops=ops,
               chain_ms=chain_ms, serial_ms=serial_ms, bytes_ms=bytes_ms, ops_ms=ops / FP64_OPS_PER_S * 1e3,
               bound_ms=max(chain_ms, bytes_ms), bound_by="operations" if chain_ms >= bytes_ms else "bytes",
               configs=len(args[3]), plan=packed.plan, stage_jobs=stage_jobs(packed.plan, patches))
    check(kernel_ms >= out["bound_ms"], f"VT read {kernel_ms:.4f} ms, below its bound {out['bound_ms']:.4f} ms")
    return out


def plan_text(n):
    p = n["plan"]
    return (f"S {p.stages}, split {list(p.split)} (jobs a request by stage {n['stage_jobs']}), {p.threads} threads "
            f"({p.consumer_warps} warps on the pools, {p.loader_warps} staging), KMAX {p.kmax}, chunks of {p.chunk}, "
            f"{p.state_stride} lanes of state a stage in {'shared' if p.smem_state else 'global'} memory")


def vt_line(gpu, label, n, cold_s=None, warm_s=None):
    extra = ""
    if warm_s is not None:
        extra = f"; run_batch {warm_s * 1e3:.3f} ms warm, {cold_s * 1e3:.3f} ms cold (host clock, synchronised)"
    print(f"{gpu}: VT {label}: {n['configs']} configs ({plan_text(n)}): {n['kernel_ms']:.4f} ms alone, "
          f"{n['ms']:.4f} ms through the wrapper; {n['steps'] / (n['kernel_ms'] * 1e-3):.4e} job steps/s a config; bound {n['bound_ms']:.4f} ms ({n['bound_by']}: critical path "
          f"{n['crit_steps']} job steps, {n['chain_ms']:.4f} ms; bytes {n['bytes_ms']:.4f} ms for {n['nbytes']} B; "
          f"all FP64 work {n['ops_ms']:.4f} ms for {n['ops']:.4e} ops at {FP64_OPS_PER_S / 1e12:.0f} TFLOP/s), alone "
          f"at {n['kernel_ms'] / n['bound_ms']:.2f}x the bound; old serial chain {n['steps']} job steps, "
          f"{n['serial_ms']:.4f} ms (alone at {n['kernel_ms'] / n['serial_ms']:.2f}x it){extra}")


def spread_cycles(rng, shape, mean=200.0, cv=0.1):
    """Integer service cycles at the benchmark cells' spread: a standard
    deviation of ``cv`` of the mean (their profiles' samples read 0.10 to
    0.12 of it), at least 1 cycle."""
    import numpy as np

    return np.maximum(1.0, np.rint(rng.normal(mean, cv * mean, shape)))


def vt_lane_costs(gpu, dev, clock_hz):
    """VT's cost by path on synthetic problems (random integer cycles, one
    config, 100 Poisson requests, one stage): cycles a job for one pool of
    d servers and 1,024 jobs a request (a thread runs d <= 8, a warp more:
    one by one up to 32, in merged epochs from 33 to 512, the widest of the
    KMAX 16 build, one by one again above, 686 F8's widest pool, in the KMAX
    32 build), with service times of 20 to 400 cycles and again at the
    cells' spread (``spread_cycles``; ``JOB_CYCLES`` for pools of more than
    8 servers comes from this row), and cycles a (request, layer) for 20
    layers of one one-job pool."""
    import numpy as np
    import torch

    from repro_torch.kernels import vtime_scan as vtk

    rng = np.random.default_rng(7)

    def ms_of(L, P, d, n=100, spread=False):
        tables = vtk.vt_tables([torch.as_tensor((spread_cycles(rng, (1, 128, 1)) if spread else
                                                 rng.integers(20, 400, (1, 128, 1))).astype(np.float64), device=dev)
                                for _ in range(L)])
        idx = torch.as_tensor(np.concatenate([rng.integers(0, 128, n * P) for _ in range(L)]).astype(np.int32),
                              device=dev)
        arr = torch.as_tensor(np.cumsum(rng.exponential(1e4, (1, n)), axis=1), device=dev)
        saved = vtk.vtime_scan.launches
        packed = vtk._pack(vtk._prepare(tables, idx, [P] * L, np.zeros(1), np.full((1, L), d), n, arr, None, None))
        if L > 1:  # one stage, so that the (request, layer) cost is not shared out among stages
            packed = packed._replace(plan=vtk.kernel_plan(np.full((1, L), d), [1] * L, [P] * L, stages=1))
        ms = timed(lambda: vtk._launch(packed, False), reps=3)
        vtk.vtime_scan.launches = saved
        return ms * 1e-3 * clock_hz / n

    per_job = {d: ms_of(1, 1024, d) / 1024 for d in (1, 2, 4, 8, 32, 64, 128, 256, 512, 686)}
    at_spread = {d: ms_of(1, 1024, d, spread=True) / 1024 for d in (32, 64, 128, 256, 512, 686, 1024)}
    per_layer = ms_of(20, 1, 1) / 20
    print(f"{gpu}: VT cycles a job by servers in the pool (one 1,024-job pool, one stage; a thread runs <= 8, a "
          f"warp more): " + ", ".join(f"{d}: {c:.1f}" for d, c in per_job.items())
          + "; at the cells' spread: " + ", ".join(f"{d}: {c:.1f}" for d, c in at_spread.items())
          + f"; a (request, layer) of one job costs {per_layer:.0f} cycles (staging, barrier, completion)")
    return per_job, at_spread, per_layer


def draw_numbers(gpu, dev, seed=3_000_000_019, reps=20):
    """The service-index draw at the benchmark cells' sizes, equal to the
    host's: the kernel's device time (``torch.profiler``, ``reps``
    launches), the card's whole path (``service_indices``: the plan,
    numpy's layers and their copy, the launch) and its plain version (the
    host's draw and ``upload_indices``), each by the host clock to a
    synchronize; beside the bytes bound (4 B written an index, 4 more read
    a copied one, at 3.35 TB/s).  Returns {cell: numbers}."""
    import numpy as np
    import torch

    import repro_torch as T
    from repro_torch.fabric.vtime import sample_service_indices, service_indices, upload_indices
    from repro_torch.kernels import service_draw as sd

    r18 = [l.patches_per_image for l in T.resnet18_imagenet().layers]
    vgg = [l.patches_per_image for l in T.vgg11_cifar10().layers]
    cells = (("resnet18.closed_query", [(min(64, p), p) for p in r18], 120),
             ("resnet18.dse_tail", [(min(128, p), p) for p in r18], 200),
             ("vgg11.tail_query", [(min(128, 2 * p), p) for p in vgg], 400))

    def wall_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    out = {}
    for label, dims, n in cells:
        def plain():
            return upload_indices(sample_service_indices(np.random.default_rng(seed), dims, n), dev)

        def card():
            return service_indices(seed, dims, n, dev)

        want, got = plain(), card()
        check(torch.equal(got, want), f"{label}: the card's draw != the host's")
        plan = sd.draw_plan(seed, dims, n)
        host = torch.from_numpy(plan.host).to(dev) if plan.host.size else None
        flat = torch.empty(plan.total, dtype=torch.int32, device=dev)
        before = sd.service_draw.launches

        def launches():
            for _ in range(reps):
                sd.service_draw(plan, host, flat)

        _, _, by_name = device_busy(launches)
        check(sd.service_draw.launches == before + reps, f"{label}: {sd.service_draw.launches - before} launches")
        kernel_ms = sum(ms for name, ms in by_name.items() if "service_draw_kernel" in name) / reps
        check(kernel_ms > 0, f"{label}: no service_draw_kernel in the trace")
        err = int((flat - want).abs().max())
        check(err == 0, f"{label}: the launch != the host's (max abs diff {err})")
        nbytes = 4 * plan.total + 4 * plan.host.size
        bound_ms = nbytes / 3.35e12 * 1e3
        out[label] = dict(indices=plan.total, host_indices=int(plan.host.size), max_abs_err=err, kernel_ms=kernel_ms,
                          bound_ms=bound_ms, path_ms=wall_ms(card), plain_ms=wall_ms(plain))
        o = out[label]
        print(f"{gpu}: draw {label}: {plan.total:,} indices ({o['host_indices']:,} numpy's), kernel "
              f"{kernel_ms:.4f} ms against {bound_ms:.4f} ({nbytes:,} B; {bound_ms / kernel_ms:.3f} of the bound), "
              f"the card's path {o['path_ms']:.3f} ms, the host's draw and upload {o['plain_ms']:.3f} ms")
    return out


def draw_entry(draw, fab, mcf):
    """The draw's entry of the ``kernels`` line: its launches on the main
    path (phases 17 and 18, by path), max |kernel - host draw| and its
    times at ``resnet18.closed_query``'s size beside every cell's
    (``draw_numbers``)."""
    return {
        "name": "service_draw",
        "route": "cuda",
        "source": "src/repro_torch/csrc/service_draw.cu",
        "replaces": "the host's draw and upload_indices (src/repro_torch/fabric/vtime.py), no Pallas kernel",
        "launches": sum(fab["draw_launches"].values()) + sum(mcf["draw_launches"].values()),
        "launches_by_path": {**fab["draw_launches"], **mcf["draw_launches"]},
        "max_abs_err": max(d["max_abs_err"] for d in draw.values()),
        # resnet18.closed_query's draw (3,627,960 indices); the kernel alone by
        # torch.profiler, the path and its plain version by the host clock
        "ms": draw["resnet18.closed_query"]["path_ms"],
        "kernel_ms": draw["resnet18.closed_query"]["kernel_ms"],
        "plain_ms": draw["resnet18.closed_query"]["plain_ms"],
        "bound_ms": draw["resnet18.closed_query"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "cells": draw,
    }


def fabric_phase(gpu, dev):
    """The fabric engines on the card (slice 8): profiles by K1, then (1) the
    reference's fabric_tail grid on VGG11, (2) ResNet18's closed loop, (3)
    the fused sweep's fabric stage over 1,024 VGG11 configs, (4) VT against
    its plain version, (5) VT's numbers and its cost by path.  Each path's
    VT count and draw count (``service_draw``, one a VT launch on the card)
    are set to 0 just before it and read just after."""
    import numpy as np
    import torch

    import repro_torch as T
    from repro_torch.dse import FabricEval, clear_caches, clear_fused_caches, design_grid, run_fused_sweep, run_sweep
    from repro_torch.fabric import (
        ClosedLoop, FabricSim, PoissonOpen, VirtualTimeFabric, provision_latency_aware, shift_profile,
    )
    from repro_torch.kernels.service_draw import service_draw as sd
    from repro_torch.kernels.vtime_scan import vtime_scan as vt, vtime_scan_ref as vt_plain

    t_phase = time.perf_counter()
    out = {"launches": {}, "draw_launches": {}}

    def zero():
        vt.launches = sd.launches = 0

    def count(path):
        """Record a path's VT and draw launches; each VT launch takes one draw."""
        out["launches"][path], out["draw_launches"][path] = vt.launches, sd.launches
        check(sd.launches == vt.launches, f"{path}: {sd.launches} draws on the card for {vt.launches} VT launches")

    chain_ns = (vt_chain_ns(dev), vt_chain_ns(dev, with_min=False))  # (add + min, add alone)
    print(f"{gpu}: one thread's dependent FP64 add + min: {chain_ns[0]:.3f} ns a step; add alone "
          f"{chain_ns[1]:.3f} ns")

    profiles = {}
    for name, fn, kw in (("vgg11", T.vgg11_cifar10, FABRIC_VGG_PROFILE), ("resnet18", T.resnet18_imagenet, FABRIC_R18_PROFILE)):
        spec = fn()
        profiles[name] = (spec, T.derive_profile(T.capture_activations(spec, device=dev, **kw), spec))

    # ---- (1) fabric_tail: VGG11 at 2x the minimum PEs, 15 configs x 400 Poisson requests
    spec, prof = profiles["vgg11"]
    pes = spec.min_pes() * 2
    wb = T.allocate(spec, prof, "weight_based", pes)
    bw = T.allocate(spec, prof, "blockwise", pes)
    cap = T.simulate(spec, prof, bw, n_images=64).images_per_sec
    zero()
    t0 = time.perf_counter()
    vt_prov = VirtualTimeFabric(spec, prof, lane_quantum=8, device=dev)
    las = {f: provision_latency_aware(spec, prof, pes, offered_ips=f * cap, calib_requests=FABRIC_CALIB,
                                      grants=0, vt=vt_prov) for f in FABRIC_LOADS}
    torch.cuda.synchronize()
    prov_s = time.perf_counter() - t0
    count("provision")
    check(vt.launches == 2 * len(FABRIC_LOADS),
          f"provision_latency_aware: VT launched {vt.launches} times, want {2 * len(FABRIC_LOADS)}")
    allocs, procs, labels = [], [], []
    for f in FABRIC_LOADS:
        proc = PoissonOpen(FABRIC_TAIL_REQUESTS, f * cap / 1e8, seed=5)
        for pol, a in (("weight_based", wb), ("blockwise", bw), ("latency_aware", las[f])):
            allocs.append(a)
            procs.append(proc)
            labels.append((pol, f))
    lanes_max = max(int(np.max(a.layer_dups if a.layer_dups is not None else np.concatenate(a.block_dups)))
                    for a in allocs)
    vtf = VirtualTimeFabric(spec, prof, device=dev)
    zero()
    with VTRecorder() as rec:
        t0 = time.perf_counter()
        cold = vtf.run_batch(allocs, procs, seed=3)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = vtf.run_batch(allocs, procs, seed=3)
        warm_s = time.perf_counter() - t0
    count("fabric_tail")
    check(vt.launches == 2, f"fabric_tail: VT launched {vt.launches} times, want 2 (cold and warm)")
    check(np.array_equal(cold.completions, res.completions), "fabric_tail: cold != warm")
    t0 = time.perf_counter()
    host = [FabricSim(spec, prof, a, seed=3).run(p) for a, p in zip(allocs, procs)]
    host_s = time.perf_counter() - t0
    for i, r in enumerate(host):
        check(np.array_equal(res.completions[i], r.completions) and np.array_equal(res.arrivals[i], r.arrivals),
              f"fabric_tail {labels[i]}: VT != FabricSim")
        check(np.isfinite(res.completions[i]).all() and res.completions.shape[1] == FABRIC_TAIL_REQUESTS,
              f"fabric_tail {labels[i]}: completions")
    p99 = {pol: res.latency(i).p99 * 1e3 / 1e8 for i, (pol, f) in enumerate(labels) if f == 0.7}
    print(f"fabric_tail (vgg11 @ {pes} PEs, {len(allocs)} configs x {FABRIC_TAIL_REQUESTS} Poisson requests, "
          f"loads {FABRIC_LOADS}): VT == FabricSim on every config (arrivals and completions equal); "
          f"largest lanes a pool {lanes_max}; p99 @ 0.7 load: " + " ".join(f"{k}={v:.4f} ms" for k, v in p99.items())
          + f"; host FabricSim {host_s:.3f} s for the 15 configs, VT run_batch {warm_s:.4f} s warm "
          f"({cold_s:.4f} s cold); provisioning {prov_s:.3f} s (10 VT launches)")
    tail = vt_numbers(rec.calls[-1], chain_ns, reps=5)
    vt_line(gpu, "fabric_tail", tail, cold_s, warm_s)
    out["tail"] = tail

    # ---- (2) ResNet18: five policies in a closed loop, and blockwise equal to FabricSim
    spec, prof = profiles["resnet18"]
    pes = spec.min_pes() * 2
    r_allocs = [T.allocate(spec, prof, p, pes) for p in T.POLICIES]
    lanes_max = max(int(np.max(a.layer_dups if a.layer_dups is not None else np.concatenate(a.block_dups)))
                    for a in r_allocs)
    vtr = VirtualTimeFabric(spec, prof, device=dev)
    zero()
    with VTRecorder() as rec:
        t0 = time.perf_counter()
        res = vtr.run_batch(r_allocs, ClosedLoop(*FABRIC_R18_LOOP), seed=1)
        r18_s = time.perf_counter() - t0
    count("resnet18_loop")
    check(vt.launches == 1, f"resnet18 closed loop: VT launched {vt.launches} times, want 1")
    worst = 0.0
    for k, a in enumerate(r_allocs):
        ana = T.simulate(spec, prof, a, n_images=64).images_per_sec
        rel = abs(res.images_per_sec[k] / ana - 1.0)
        worst = max(worst, rel)
        check(rel <= 0.10, f"resnet18 {a.policy}: closed loop {res.images_per_sec[k]:.1f} img/s vs analytic "
                           f"{ana:.1f} (off {rel:.3f}, limit 0.10)")
        print(f"resnet18 {a.policy:16s} closed loop {FABRIC_R18_LOOP}: {res.images_per_sec[k]:12.3f} img/s, "
              f"analytic {ana:12.3f} ({rel * 100:.3f}% apart)")
    r18 = vt_numbers(rec.calls[-1], chain_ns, reps=2)
    vt_line(gpu, f"resnet18 five policies, ClosedLoop{FABRIC_R18_LOOP}, largest lanes a pool {lanes_max}", r18,
            r18_s, r18_s)
    out["r18"] = r18
    bwr = r_allocs[T.POLICIES.index("blockwise")]
    zero()
    got = vtr.run_batch([bwr], ClosedLoop(*FABRIC_R18_EQUAL), seed=1)
    count("resnet18_equal")
    t0 = time.perf_counter()
    want = FabricSim(spec, prof, bwr, seed=1).run(ClosedLoop(*FABRIC_R18_EQUAL))
    r18_host_s = time.perf_counter() - t0
    check(np.array_equal(got.completions[0], want.completions) and np.array_equal(got.arrivals[0], want.arrivals),
          "resnet18 blockwise: VT != FabricSim")
    print(f"resnet18 blockwise ClosedLoop{FABRIC_R18_EQUAL}: VT == FabricSim (host {r18_host_s:.3f} s); "
          f"every policy's closed loop within {worst * 100:.3f}% of analytic (limit 10%)")

    # ---- (3) the fused sweep's fabric stage over 1,024 VGG11 configs
    arrays = tuple(T.DEFAULT_ARRAY.variant(rows=r, cols=r, adc_bits=a) for r in FUSED_ROWS for a in FUSED_ADC_BITS)
    half = design_grid(networks=("vgg11",), policies=FUSED_POLICIES, arrays=arrays,
                       pe_multipliers=tuple(np.linspace(1.0, 6.0, FABRIC_VGG_HALF_BUDGETS)))
    step = len(half) // FABRIC_FUSED_CONFIGS
    pts = half[::step][:FABRIC_FUSED_CONFIGS]
    del half
    clear_caches()
    clear_fused_caches()
    fe = FabricEval()
    run_fused_sweep(pts[:8], fabric=fe, device=dev)  # capture, derive and tables outside the count
    zero()
    with VTRecorder() as rec:
        t0 = time.perf_counter()
        fused = run_fused_sweep(pts, fabric=fe, device=dev)
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - t0
    count("fused")
    check(vt.launches == len(FUSED_ROWS), f"fused fabric stage: VT launched {vt.launches} times, want {len(FUSED_ROWS)}")
    zero()
    t0 = time.perf_counter()
    staged = run_sweep(pts, fabric=fe, engine="batch", device=dev)
    staged_s = time.perf_counter() - t0
    count("staged")
    for col in ("arrays_used", "images_per_sec", "p50_cycles", "p95_cycles", "p99_cycles"):
        x, y = getattr(fused, col), getattr(staged, col)
        check(np.array_equal(x, y), f"fused fabric stage != staged sweep on {col}")
        check(bool(np.isfinite(x).all()), f"fused fabric stage: {col} not finite")
    pick = []
    for pol in FUSED_POLICIES:
        rows = [i for i, p in enumerate(pts) if p.policy == pol]
        pick += [rows[0], rows[-1]] if rows else []
    check(len(pick) == 2 * len(FUSED_POLICIES), f"fused grid: {len(pick)} rows spread over the policies")
    t0 = time.perf_counter()
    scalar = run_sweep([pts[i] for i in pick], fabric=fe, engine="scalar", device=dev)
    scalar_s = time.perf_counter() - t0
    for col in ("p50_cycles", "p95_cycles", "p99_cycles"):
        check(np.array_equal(getattr(fused, col)[pick], getattr(scalar, col)), f"fused != host scalar on {col}")
    share, win_ms, by_name = device_busy(lambda: run_fused_sweep(pts, fabric=fe, device=dev))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    print(f"fused fabric stage (vgg11, {len(pts)} configs, every {step}th point of the {FABRIC_VGG_HALF_BUDGETS}-budget "
          f"VGG11 half of the headline grid, load 0.7, 200 requests, seed 0): p50/p95/p99 == staged run_sweep "
          f"(batch, VT on the card, {out['launches']['staged']} launches) on every row, and == the host scalar "
          f"sweep (FabricSim) on {len(pick)} rows spread over the policies; run_fused_sweep {fused_s:.3f} s, "
          f"staged {staged_s:.3f} s, host scalar {scalar_s:.3f} s for {len(pick)} rows")
    print(f"{gpu}: fused sweep with its fabric stage under torch.profiler: window {win_ms:.3f} ms, device busy "
          f"{share:.4f} (idle {1 - share:.4f}); top device time: " + "; ".join(f"{n[:50]} {t:.3f} ms" for n, t in top))
    fused_n = vt_numbers(max(rec.calls, key=lambda c: len(c[0][3])), chain_ns, reps=5)
    vt_line(gpu, "fused fabric stage (largest group)", fused_n)
    out["fused"] = fused_n
    out["fused_busy"] = share

    # ---- (4) VT against its plain version on the card: stats, transfers, fractional cycles
    spec, prof = profiles["vgg11"]
    pes = spec.min_pes() * 2
    trio = [wb, bw, las[0.7]]
    rng = np.random.default_rng(0)

    class Placement:
        def __init__(self, x):
            self.stage_transfer = x

    places = [Placement(rng.random(len(spec.layers)) * 300.0) for _ in trio]
    live = shift_profile(prof, {2: 1.3, 3: 1.7})
    cases = (
        ("open loop, stats, transfers", VirtualTimeFabric(spec, prof, device=dev),
         PoissonOpen(FABRIC_CHECK_REQUESTS, 0.6 * cap / 1e8, seed=2), places),
        ("closed loop, stats", VirtualTimeFabric(spec, prof, device=dev), ClosedLoop(FABRIC_CHECK_REQUESTS, 8), None),
        ("fractional cycles, stats", VirtualTimeFabric(spec, prof, live_prof=live, device=dev),
         PoissonOpen(FABRIC_CHECK_REQUESTS, 0.6 * cap / 1e8, seed=2), None),
    )
    err, plain_ms, check_n = 0.0, None, None
    for label, vtc, proc, pl in cases:
        saved = vt.launches
        with VTRecorder() as rec:
            vtc.run_batch(trio, proc, seed=4, placements=pl, collect_stats=True)
        args, kw = rec.calls[-1]
        got = vt(*args, **kw)
        t0 = time.perf_counter()
        want = vt_plain(*args, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        vt.launches = saved
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), f"VT != plain ({label})")
        for g, w in zip(got[2:], want[2:]):
            rel = float(((g - w).abs() / w.abs().clamp_min(1e-300)).max())
            check(rel <= 1e-12, f"VT busy/wait vs plain ({label}): rel err {rel}")
            err = max(err, float((g - w).abs().max()))
        if plain_ms is None:
            plain_ms = plain_s * 1e3
            check_n = vt_numbers((args, kw), chain_ns, reps=5)
        print(f"VT vs plain on the card, vgg11 {len(trio)} configs x {FABRIC_CHECK_REQUESTS} requests, {label}: "
              f"arrivals and completions equal, busy and wait within rtol 1e-12 (max abs diff {err:.3e})")
    print(f"{gpu}: VT at the check's size (open loop, stats, transfers): {check_n['kernel_ms']:.4f} ms alone, "
          f"{check_n['ms']:.4f} ms through the wrapper; plain version {plain_ms:.3f} ms (host clock, one call)")
    out.update(max_abs_err=err, plain_ms=plain_ms, check=check_n)
    out["lane_costs"] = vt_lane_costs(gpu, dev, sm_clock_hz())
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{gpu}: fabric phase {out['phase_s']:.3f} s; VT launches by path: {json.dumps(out['launches'])}; "
          f"draws on the card by path: {json.dumps(out['draw_launches'])}")
    out["chain_ns"], out["vgg11"] = chain_ns, profiles["vgg11"]
    return out


class StreamRecorder:
    """Keeps the arguments of every streaming VT call ``fabric.fleet`` makes
    (it binds ``vtime_stream`` by name) and times each by CUDA events,
    through the wrapper and alone (``_stream_launch``, after the checks), so
    that a long replay need not run twice to be timed.  The calls go
    through unchanged; ``times()`` synchronises and returns both lists in
    ms."""

    def __enter__(self):
        import torch

        import repro_torch.fabric.fleet as fleet_mod
        from repro_torch.kernels import vtime_scan as vtk

        self.mod, self.vtk = fleet_mod, vtk
        self.real, self.real_launch = vtk.vtime_stream, vtk._stream_launch
        self.calls, self.events, self.launch_events = [], [], []

        def pair():
            return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

        def recording(*args, **kw):
            self.calls.append((args, kw))
            a, b = pair()
            a.record()
            out = self.real(*args, **kw)
            b.record()
            self.events.append((a, b))
            return out

        def launch(p, emit):
            a, b = pair()
            a.record()
            out = self.real_launch(p, emit)
            b.record()
            self.launch_events.append((a, b))
            return out

        fleet_mod.vtime_stream, vtk._stream_launch = recording, launch
        return self

    def __exit__(self, *exc):
        self.mod.vtime_stream, self.vtk._stream_launch = self.real, self.real_launch

    def times(self):
        import torch

        torch.cuda.synchronize()
        return ([a.elapsed_time(b) for a, b in self.events], [a.elapsed_time(b) for a, b in self.launch_events])


def stream_work(args, kw):
    """(jobs a request (C, L), bytes, FP64 operations) of one streaming VT
    call: a layer's jobs are its macro-jobs, then the exact tail; the bytes
    are the tables, lanes and arrivals read once, the carry (lanes, ring,
    sketch, moments, horizon) read and written once, and the emitted (C, N)
    pairs written; the operations are, per job and pool with d lanes, one
    add and d max + d min."""
    import numpy as np

    tables, variant, lanes, carry = args
    n, C, L = kw["n_requests"], len(variant), len(tables.blocks)
    patches = list(kw["patches"])
    plans = np.ones((C, L, 2), dtype=np.int64) * np.array([1, 0]) \
        if kw.get("plans") is None else np.broadcast_to(np.asarray(kw["plans"]), (C, L, 2))
    jobs = plans[..., 1] + np.asarray(patches)[None, :] - plans[..., 1] * plans[..., 0]  # (C, L)
    ln = np.asarray(lanes, dtype=np.int64)
    nbytes = tables.flat.numel() * 8 + ln.size * 4 + C * 4
    nbytes += 2 * sum(t.numel() * 8 for t in carry)
    if kw.get("arrivals") is not None:
        nbytes += C * n * 8
    if kw.get("emit"):
        nbytes += 2 * C * n * 8
    ops, off = 0, 0
    for li, b in enumerate(tables.blocks):
        d = ln[:, off : off + b]
        off += b
        ops += int((n * jobs[:, li] * ((1 + 2 * d) * (d > 0)).sum(axis=1)).sum())
    return jobs, nbytes, ops


def stream_numbers(call, chain_ns, ms, kernel_ms):
    """One recorded streaming launch: its times (through the wrapper and
    alone, from ``StreamRecorder``) beside its bound, the larger of the
    critical path (``vt_paths`` over the plans' jobs) and the bytes at the
    memory's rate, and the old serial chain.  No launch may read below its
    bound."""
    import numpy as np

    from repro_torch.kernels import vtime_scan as vtk

    args, kw = call
    jobs, nbytes, ops = stream_work(args, kw)
    tables, variant, lanes = args[:3]
    p = vtk._prepare_stream(tables, variant, lanes, args[3], kw["n_requests"], kw.get("patches"), kw.get("salts"),
                            kw.get("idx"), kw.get("plans"), kw.get("r0", 0), kw.get("arrivals"),
                            kw.get("concurrency"), kw.get("xfer"), kw.get("sketch", (32, 0)))
    plan = vtk._stream_plan(p)
    crit_steps, crit_ns, steps = vt_paths(np.asarray(lanes), list(tables.blocks), jobs,
                                          kw["n_requests"], kw.get("concurrency"), chain_ns)
    chain_ms, serial_ms, bytes_ms = crit_ns * 1e-6, steps * chain_ns[0] * 1e-6, nbytes / HBM_BYTES_PER_S * 1e3
    out = dict(ms=ms, kernel_ms=kernel_ms, steps=steps, crit_steps=crit_steps, nbytes=nbytes, ops=ops,
               chain_ms=chain_ms, serial_ms=serial_ms, bytes_ms=bytes_ms, bound_ms=max(chain_ms, bytes_ms),
               bound_by="operations" if chain_ms >= bytes_ms else "bytes", n=kw["n_requests"],
               configs=len(variant), plan=plan, stage_jobs=stage_jobs(plan, jobs))
    check(kernel_ms >= out["bound_ms"],
          f"vtime_stream read {kernel_ms:.3f} ms, below its bound {out['bound_ms']:.3f} ms")
    return out


def stream_vs_plain(call, n):
    """Re-run one recorded streaming call on its own carry, plans and
    ``r0``, cut to its first ``n`` requests and with ``emit``: the kernel on
    the card against its plain version on the host.  Every carried tensor
    and the emitted arrivals and completions must be equal.  The launch
    made here is not counted.  Returns (the kernel's completions, the
    largest difference, the plain version's seconds)."""
    import torch

    from repro_torch.kernels.vtime_scan import StreamState, VTTables, vtime_stream as vs, vtime_stream_ref as vs_plain

    args, kw = call
    kw = dict(kw, n_requests=n, emit=True)
    if kw.get("arrivals") is not None:
        kw["arrivals"] = kw["arrivals"][:, :n]
    saved = vs.launches
    got_c, got_y = vs(*args, **kw)
    vs.launches = saved

    def to_host(x):
        if isinstance(x, VTTables):
            return x._replace(flat=x.flat.cpu(), tbl_off=x.tbl_off.cpu())
        if isinstance(x, StreamState):
            return StreamState(*(t.cpu() for t in x))
        return x.cpu() if isinstance(x, torch.Tensor) else x

    args_h = [to_host(a) for a in args]
    kw_h = {k: to_host(v) for k, v in kw.items()}
    t0 = time.perf_counter()
    want_c, want_y = vs_plain(*args_h, **kw_h)
    plain_s = time.perf_counter() - t0
    err = 0.0
    for name, g, w in zip((*want_c._fields, "arrivals", "completions"), (*got_c, *got_y), (*want_c, *want_y)):
        check(torch.equal(g.cpu(), w), f"vtime_stream != plain ({name}, r0 {kw.get('r0', 0)}, {n} requests)")
        err = max(err, float((g.cpu() - w).abs().nan_to_num(0.0).max()))
    return got_y[1].cpu().numpy(), err, plain_s


def multichip_fleet_phase(gpu, dev, fab):
    """The multi-chip half on the card (slice 9): (1) F8, VT on pools wider
    than 512 servers; (2) the reference's multi-chip sweep; (3) its fused
    (placement x load) surface; (4) fleet replay with the streaming VT
    entry; (5) the fault sweep; (6) observability on a placed run.  Each
    path's VT and streaming counts are set to 0 just before it and read
    just after."""
    import numpy as np
    import torch

    import repro_torch as T
    from repro_torch.core.cim import FabricTopology, allocate_placed
    from repro_torch.dse import (
        MULTICHIP_OBJECTIVES, chip_grid, fault_grid, get_profiled, pareto_frontier, run_fault_sweep,
        run_fused_multichip_sweep, run_multichip_sweep,
    )
    from repro_torch.fabric import (
        CoarsenConfig, FabricSim, LatencySketch, PoissonOpen, SinusoidalPoisson, TraceReplay, VirtualTimeFabric,
        arrival_times, degrade_plan, generate_failure_trace, run_stream, run_trace_segments, segment_growth_plan,
    )
    from repro_torch.fabric.vtime import pool_lanes
    from repro_torch.kernels.service_draw import service_draw as sd
    from repro_torch.kernels.vtime_scan import vtime_scan as vt, vtime_stream as vs
    from repro_torch.obs import build_trace, utilization_report, validate_trace

    t_phase = time.perf_counter()
    chain_ns = fab["chain_ns"]
    out = {"launches": {}, "stream_launches": {}, "draw_launches": {}}

    def zero():
        vt.launches = sd.launches = 0

    def count(path):
        """Record a path's VT and draw launches; each VT launch takes one draw."""
        out["launches"][path], out["draw_launches"][path] = vt.launches, sd.launches
        check(sd.launches == vt.launches, f"{path}: {sd.launches} draws on the card for {vt.launches} VT launches")

    # ---- (1) F8: VGG11 blockwise at 10x to 20x its minimum PEs through VT
    spec, prof = fab["vgg11"]
    allocs = [T.allocate(spec, prof, "blockwise", spec.min_pes() * m) for m in F8_MULTS]
    widest = [int(pool_lanes(spec, a).max()) for a in allocs]
    check(max(widest) > 512, f"F8: no pool wider than 512 servers at {F8_MULTS}x ({widest})")
    cap = T.simulate(spec, prof, allocs[0]).images_per_sec
    proc = PoissonOpen(FABRIC_CHECK_REQUESTS, 0.6 * cap / 1e8, seed=1)
    zero()
    with VTRecorder() as rec:
        res = VirtualTimeFabric(spec, prof, device=dev).run_batch(allocs, proc, seed=0)
    count("f8")
    check(vt.launches == 1, f"F8: VT launched {vt.launches} times, want 1")
    for m, a, w, got in zip(F8_MULTS, allocs, widest, res.completions):
        want = FabricSim(spec, prof, a, seed=0).run(proc)
        check(np.array_equal(got, want.completions), f"F8 {m}x ({w} servers): VT != FabricSim")
    f8 = vt_numbers(rec.calls[-1], chain_ns, reps=3)
    print(f"F8: vgg11 blockwise at {F8_MULTS}x the minimum PEs (widest pool {widest} servers), "
          f"{FABRIC_CHECK_REQUESTS} Poisson requests: VT (one launch) == FabricSim on every config")
    vt_line(gpu, f"F8 (widest pool {max(widest)} servers)", f8)
    out["f8"] = f8

    # ---- (2) the multi-chip sweep: VGG11, chips x links at equal silicon
    pts = chip_grid(networks=("vgg11",), chips=MC_CHIPS, link_gbps=MC_LINKS, pe_multiplier=2.0)
    run_multichip_sweep(pts[:1], device=dev, **MC_RUN)  # capture and derive outside the count and the clock
    zero()
    t0 = time.perf_counter()
    mc = run_multichip_sweep(pts, device=dev, **MC_RUN)
    torch.cuda.synchronize()
    mc_s = time.perf_counter() - t0
    count("multichip")
    check(vt.launches == 2, f"multichip sweep: VT launched {vt.launches} times, want 2 (closed and open loop)")
    for i, p in enumerate(mc.points):
        check(np.isfinite(mc.images_per_sec[i]) and mc.images_per_sec[i] > 0 and mc.p99_cycles[i] >= mc.p50_cycles[i],
              f"multichip {p.n_chips} chips @ {p.link_gbps}: columns")
        print(f"multichip vgg11 {p.n_chips} chips @ {p.link_gbps:5.0f} Gb/s ({p.n_pes_total} PEs): "
              f"{mc.images_per_sec[i]:12.3f} img/s, p99 {mc.p99_cycles[i] / 1e5:.4f} ms, "
              f"max stage transfer {mc.max_stage_transfer[i]:.1f} cycles, {int(mc.n_crossings[i])} crossings")
    frontier = pareto_frontier(mc, MULTICHIP_OBJECTIVES)
    check(any(mc.points[i].n_chips == 1 for i in frontier), "multichip: no one-chip design on the frontier")
    sspec, sprof = get_profiled("vgg11", T.DEFAULT_ARRAY, sample_patches=MC_RUN["sample_patches"], device=dev)
    picks = [next(p for p in pts if p.n_chips == c and p.link_gbps == 16.0) for c in (1, 8)]
    placed = [allocate_placed(sspec, sprof, "blockwise", p.topology()) for p in picks]
    gaps = np.random.default_rng(0).exponential(1.0, size=MC_CHECK_REQUESTS)
    procs = [TraceReplay(np.cumsum(gaps) / (0.7 * mc.images_per_sec[pts.index(p)] / 1e8)) for p in picks]
    got = VirtualTimeFabric(sspec, sprof, lane_quantum=8, device=dev).run_batch(
        [pa.allocation for pa in placed], procs, seed=0, placements=[pa.placement for pa in placed])
    for k, (p, pa, pr) in enumerate(zip(picks, placed, procs)):
        want = FabricSim(sspec, sprof, pa.allocation, seed=0, placement=pa.placement).run(pr)
        check(np.array_equal(got.completions[k], want.completions), f"multichip {p.n_chips} chips: VT != FabricSim")
    print(f"{gpu}: multichip sweep over {len(pts)} points ({MC_RUN['n_requests']} requests, "
          f"ClosedLoop({MC_RUN['closed_requests']}, {MC_RUN['concurrency']})): {mc_s:.3f} s, 2 VT launches; "
          f"frontier {[(mc.points[i].n_chips, mc.points[i].link_gbps) for i in frontier]}; 1 and 8 chips at 16 Gb/s "
          f"== FabricSim(placement=) on the host at {MC_CHECK_REQUESTS} requests")

    # ---- (3) the fused (placement x load) surface against the staged sweep at 0.7
    cpts = chip_grid(networks=("vgg11",), **FUSED_CHIP)
    run_fused_multichip_sweep(cpts[:1], load_fracs=(0.7,), device=dev, **FUSED_CHIP_RUN)
    zero()
    t0 = time.perf_counter()
    fused = run_fused_multichip_sweep(cpts, load_fracs=FUSED_CHIP_LOADS, device=dev, **FUSED_CHIP_RUN)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    count("fused_multichip")
    check(vt.launches == 2, f"fused multichip surface: VT launched {vt.launches} times, want 2")
    t0 = time.perf_counter()
    staged = {lf: run_multichip_sweep(cpts, load_frac=lf, device=dev, **FUSED_CHIP_RUN) for lf in FUSED_CHIP_LOADS}
    staged_s = time.perf_counter() - t0
    s07, k07 = staged[0.7], FUSED_CHIP_LOADS.index(0.7)
    want = np.stack([s07.p50_cycles, s07.p95_cycles, s07.p99_cycles], axis=1)
    check(np.allclose(fused.pcts[:, k07, :], want, rtol=1e-12, atol=0)
          and np.allclose(fused.images_per_sec, s07.images_per_sec, rtol=1e-12, atol=0),
          "fused multichip surface != staged sweep at load 0.7")
    print(f"{gpu}: fused multichip surface, {len(cpts)} points x {len(FUSED_CHIP_LOADS)} loads "
          f"({fused.n_evaluations} evaluations, 2 VT launches): {fused_s:.3f} s; the staged sweep, one run per "
          f"load: {staged_s:.3f} s; equal at load 0.7 within rtol 1e-12")

    # ---- (4) fleet replay: the streaming VT entry
    fspec = T.vgg11_cifar10()
    fprof = T.profile_network(fspec, n_images=2, device=dev)
    bw = T.allocate(fspec, fprof, "blockwise", fspec.min_pes() * 2)
    cap = T.simulate(fspec, fprof, bw, n_images=64).images_per_sec
    vtf = VirtualTimeFabric(fspec, fprof, device=dev)
    plan = segment_growth_plan(fspec, fprof, bw, budgets=list(FLEET_BUDGETS))
    n = FLEET_REQUESTS
    rate = 0.6 * cap / 1e8
    times = arrival_times(SinusoidalPoisson(n, base_rate=rate, period=n / rate / 2.0, amplitude=0.5, seed=0))
    segs = [[bw, plan[0]], [bw, plan[1]], [bw, plan[2]]]
    bounds = [float(times[n // 3]), float(times[2 * n // 3])]
    coarsen = CoarsenConfig(tail_lanes=2)
    vs.launches = 0
    t0 = time.perf_counter()
    base = run_stream(vtf, [bw, plan[0]], TraceReplay(times), seed=7, window=1, materialize=True)
    base_s = time.perf_counter() - t0
    out["stream_launches"]["baseline"] = vs.launches
    check(vs.launches == 1, f"fleet baseline: {vs.launches} streaming launches, want 1")
    check(base.completions.shape == (2, n) and np.isfinite(base.completions).all(), "fleet baseline: completions")
    exact = base.exact_percentiles
    sk_err = float(np.max(np.abs(base.percentiles - exact) / exact))
    bound_rel = base.sketches[0].config.rel_error
    check(sk_err <= bound_rel, f"fleet: sketch percentiles {sk_err:.4f} from exact (bound {bound_rel})")
    vs.launches = 0
    t0 = time.perf_counter()
    with StreamRecorder() as rec_stream:
        stream = run_stream(vtf, [bw, plan[0]], TraceReplay(times), seed=7)
    stream_s = time.perf_counter() - t0
    out["stream_launches"]["stream"] = vs.launches
    check(vs.launches == 1, f"fleet stream: {vs.launches} streaming launches, want 1")
    for a, b in zip(base.sketches, stream.sketches):
        check(np.array_equal(a.counts, b.counts) and (a.n, a.min, a.max) == (b.n, b.min, b.max),
              "fleet: stream sketch != materialized baseline")
        check(abs(a.mean / b.mean - 1) <= 1e-12 and abs(a.m2 / b.m2 - 1) <= 1e-9, "fleet: moments")
    check(np.array_equal(base.makespan, stream.makespan), "fleet: stream horizon != baseline")
    h = FLEET_HOST_REQUESTS
    t0 = time.perf_counter()
    host = FabricSim(fspec, fprof, bw, seed=7, service_sampling="hash").run(TraceReplay(times[:h]))
    host_s = time.perf_counter() - t0
    check(np.array_equal(base.completions[0, :h], host.completions)
          and np.array_equal(base.completions[1, :h], host.completions),
          f"fleet: the first {h} requests != FabricSim(service_sampling='hash')")
    # the kernel against its plain version from a fresh carry, with emit
    m = FLEET_PLAIN_REQUESTS
    got_comp, stream_err, plain_s = stream_vs_plain(rec_stream.calls[-1], m)
    check(np.array_equal(got_comp, base.completions[:, :m]), "vtime_stream (emit) != the baseline's first requests")
    vs.launches = 0
    with StreamRecorder() as rec:
        t0 = time.perf_counter()
        fleet = run_trace_segments(vtf, segs, times, bounds, seed=7, window=8, coarsen=coarsen)
        torch.cuda.synchronize()
        fleet_s = time.perf_counter() - t0
    out["stream_launches"]["replay"] = vs.launches
    check(vs.launches == 3, f"fleet replay: {vs.launches} streaming launches, want 3 (one a segment)")
    check(all(s.n == n for s in fleet.sketches) and np.isfinite(fleet.percentiles).all(), "fleet replay: sketches")
    # every segment's launch against its plain version, on that segment's
    # own carry (the previous launch's lanes after the boundary, +inf where a
    # pool has fewer servers than slots) and macro-job plans
    seg_plain_s = 0.0
    for k, call in enumerate(rec.calls):
        plans = call[1]["plans"]
        check(plans is not None and int(np.asarray(plans)[..., 0].max()) > 1,
              f"fleet segment {k}: no macro-jobs in its plans")
        _, err, ps = stream_vs_plain(call, m)
        stream_err, seg_plain_s = max(stream_err, err), seg_plain_s + ps
    seg_nums = [stream_numbers(c, chain_ns, ms, kms) for c, ms, kms in zip(rec.calls, *rec.times())]
    full = stream_numbers(rec_stream.calls[-1], chain_ns, *(t[-1] for t in rec_stream.times()))
    rps = n / fleet_s
    print(f"fleet (vgg11 blockwise @ {fspec.min_pes() * 2} PEs, {n} requests of a two-cycle sinusoidal Poisson trace "
          f"at 0.6 of capacity, hold vs grow by {list(FLEET_BUDGETS)} arrays at n/3 and 2n/3): W=1 materialized "
          f"baseline {base_s:.3f} s; sketch percentiles within {sk_err:.5f} of exact (bound {bound_rel}); the "
          f"uncoarsened stream ({stream_s:.3f} s) == the baseline's buckets, n, min, max and horizon; the first {h} "
          f"requests == FabricSim(service_sampling='hash') on the host ({host_s:.3f} s); the kernel == its plain "
          f"version on {m} requests from a fresh carry (plain {plain_s:.3f} s on the host)")
    print(f"fleet replay: each segment's launch == its plain version on the segment's own carry and macro-job "
          f"plans, first {m} requests (plain {seg_plain_s:.3f} s on the host)")
    print(f"{gpu}: fleet replay, 3 segments x 1 streaming launch, coarsened (tail_lanes 2), window 8: "
          f"{fleet_s:.3f} s, {rps:.1f} requests replayed/s; stall cycles hold/grow "
          f"{fleet.total_stall_cycles.tolist()}; p50/p95/p99 ms hold "
          f"{(fleet.percentiles[0] / 1e5).round(4).tolist()}, grow {(fleet.percentiles[1] / 1e5).round(4).tolist()}")
    for k, sn in enumerate(seg_nums):
        print(f"{gpu}: fleet segment {k} ({sn['n']} requests, {sn['configs']} configs, {plan_text(sn)}): launch "
              f"alone {sn['kernel_ms']:.3f} ms, through the wrapper {sn['ms']:.3f} ms; bound {sn['bound_ms']:.3f} ms "
              f"(critical path {sn['crit_steps']} job steps, {sn['chain_ms']:.3f} ms; bytes {sn['bytes_ms']:.4f} ms); "
              f"alone at {sn['kernel_ms'] / sn['bound_ms']:.2f}x the bound; old serial chain {sn['steps']} steps x "
              f"{chain_ns[0]:.3f} ns = {sn['serial_ms']:.3f} ms ({sn['kernel_ms'] / sn['serial_ms']:.2f}x)")
    print(f"{gpu}: vtime_stream, uncoarsened, {n} requests x 2 configs ({plan_text(full)}): alone "
          f"{full['kernel_ms']:.3f} ms, through the wrapper {full['ms']:.3f} ms, bound {full['bound_ms']:.3f} ms "
          f"({full['bound_by']}: critical path {full['crit_steps']} job steps), alone at "
          f"{full['kernel_ms'] / full['bound_ms']:.2f}x; old serial chain {full['steps']} steps, "
          f"{full['serial_ms']:.3f} ms ({full['kernel_ms'] / full['serial_ms']:.2f}x); "
          f"{full['steps'] / (full['kernel_ms'] * 1e-3):.4e} job steps/s a config")
    out.update(stream=full, stream_plain_ms=plain_s * 1e3, stream_err=stream_err, fleet_s=fleet_s, segs=seg_nums,
               plain_n=FLEET_PLAIN_REQUESTS)

    # ---- (5) the fault sweep: spares x failure rates, replayed on the stream
    fpts = fault_grid(networks=("vgg11",))
    vs.launches = 0
    t0 = time.perf_counter()
    faults = run_fault_sweep(fpts, device=dev, **FAULT_RUN)
    torch.cuda.synchronize()
    faults_s = time.perf_counter() - t0
    out["stream_launches"]["faults"] = vs.launches
    # the host: the same plans replayed by the event engine at the same hash
    gaps = np.random.default_rng(FAULT_RUN["seed"]).exponential(1.0, size=FAULT_RUN["n_requests"])
    t0 = time.perf_counter()
    for i, p in enumerate(fpts):
        spec_p, prof_p = get_profiled(p.network, p.array, device=dev)
        free = p.n_pes * 64 - spec_p.n_arrays
        reserve = int(free * p.spare_fraction)
        a = T.allocate(spec_p, prof_p, p.policy, p.n_pes, free_budget=free - reserve)
        tms = np.cumsum(gaps) / (0.6 * T.simulate(spec_p, prof_p, a).images_per_sec / 1e8)
        tr = generate_failure_trace(spec_p, a, horizon=float(tms[-1]), seed=FAULT_RUN["seed"],
                                    rate_per_array=p.rate_per_array, repair_cycles=p.repair_cycles)
        dp = degrade_plan(spec_p, prof_p, a, tr, spare_arrays=reserve)
        r = FabricSim(spec_p, prof_p, a, seed=FAULT_RUN["seed"], failures=dp, service_sampling="hash").run(
            TraceReplay(tms))
        sk = LatencySketch.from_latencies(r.completions - tms)
        check(dp.availability() == faults.availability[i], f"fault point {i}: availability")
        check(np.array_equal(sk.percentiles((50.0, 99.0)), [faults.p50_cycles[i], faults.p99_cycles[i]]),
              f"fault point {i}: p50 / p99 != the host's FabricSim replay")
    fault_host_s = time.perf_counter() - t0
    corner = max(range(len(fpts)), key=lambda i: (fpts[i].spare_fraction, fpts[i].rate_per_array))
    print(f"{gpu}: fault sweep, {len(fpts)} points x {FAULT_RUN['n_requests']} requests: {faults_s:.3f} s, "
          f"{vs.launches} streaming launches (one a segment); availability and p50 / p99 == FabricSim(failures=, "
          f"hash) on the host ({fault_host_s:.3f} s); stress corner (spare {fpts[corner].spare_fraction}, rate "
          f"{fpts[corner].rate_per_array}): availability {faults.availability[corner]:.6f}; killed "
          f"{faults.n_killed.tolist()}")

    # ---- (6) observability on a placed 4-chip run
    pes = sspec.min_pes() * 2
    topo = FabricTopology.split(4, pes + (-pes) % 4, link_gbps=16.0)
    pa = allocate_placed(sspec, sprof, "blockwise", topo)
    sim = FabricSim(sspec, sprof, pa.allocation, seed=3, record_timeline=True, stats=True, placement=pa.placement)
    r = sim.run(PoissonOpen(12, 2000.0 / 1e8, seed=5))
    rep = utilization_report(r)
    trace = build_trace(sim, r, placement=pa.placement)
    n_spans = validate_trace(trace)
    chips = {e["args"]["name"] for e in trace["traceEvents"] if e["ph"] == "M" and e["name"] == "process_name"}
    check(n_spans > 0 and len(chips - {"requests"}) > 1, "observability: trace")
    check(np.allclose(rep.duty_cycle + rep.barrier_frac + rep.reprogram_frac + rep.starved_frac, 1.0),
          "observability: utilization fractions do not sum to 1")
    print(f"observability: 4-chip placed vgg11 run ({pa.placement.n_crossings} crossings): {n_spans} trace spans "
          f"over {len(chips) - 1} chip processes, schema valid; mean duty cycle {rep.mean_duty_cycle:.4f}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{gpu}: multichip and fleet phase {out['phase_s']:.3f} s; VT launches {json.dumps(out['launches'])}; "
          f"draws on the card {json.dumps(out['draw_launches'])}; streaming launches "
          f"{json.dumps(out['stream_launches'])}")
    return out



def moe_slot_loads(records, replication, capacity):
    """Per record (N, k) of expert ids, dispatched round robin over the
    replicas as ``moe_fwd`` dispatches them: (the most tokens on one slot,
    the share of the N * k assignments past a slot's capacity)."""
    import numpy as np

    from repro_torch.models.layers import expert_replication_table

    table = expert_replication_table(replication)
    out = []
    for eids in records:
        n, k = eids.shape
        starts, counts = table[eids, 0], table[eids, 1]
        rr = np.arange(n)[:, None] + np.arange(k)[None]
        slot = starts + np.where(counts > 1, rr % counts, 0)
        load = np.bincount(slot.reshape(-1), minlength=int(sum(replication)))
        out.append((int(load.max()), float(np.maximum(load - capacity, 0).sum() / (n * k))))
    return out


class dropped_assignments:
    """Within the block, each ``moe_fwd`` call appends the number of its
    assignments its buckets dropped (``~keep``) to the list it yields."""

    def __enter__(self):
        import repro_torch.models.layers as layers

        self.saved = layers._route_and_bucket
        self.counts = []

        def rec(*a, **kw):
            expert_in, state = self.saved(*a, **kw)
            self.counts.append(int((~state[2]).sum()))
            return expert_in, state

        layers._route_and_bucket = rec
        return self.counts

    def __exit__(self, *exc):
        import repro_torch.models.layers as layers

        layers._route_and_bucket = self.saved
        return False


def redeploy(params, rcfg, replication):
    """The replicated deployment of ``params`` (an LM whose layers are
    consumed): an LM for ``rcfg`` (its first ``rcfg.n_layers`` layers) whose
    expert banks are ``params``' slots gathered by ``np.repeat(arange(E),
    replication)`` (replicas are copies), every other tensor ``params``' own.
    The later layers are freed first and each bank as its copy is made, so
    the card never holds both models; the new module is built on the meta
    device and its tensors assigned."""
    import numpy as np
    import torch

    from repro_torch.models import lm

    idx = torch.as_tensor(np.repeat(np.arange(len(replication)), replication), device=params.embed.device)
    del params.layers[rcfg.n_layers:]
    for layer in params.layers:
        bank = layer.moe.experts
        for name in [n for n, _ in bank.named_parameters()]:
            setattr(bank, name, torch.nn.Parameter(getattr(bank, name).index_select(0, idx), requires_grad=False))
    model = lm.LM(rcfg, None, torch.device("meta"))
    model.load_state_dict(params.state_dict(), assign=True)
    return model


def moe_replication_phase(gpu):
    """The paper's expert replication on DeepSeek-V2 at full width: profile
    the cut model's prefill routing, plan ``MOE_SLOTS`` slots, measure the
    max slot load and the dropped share before and after from the records
    (checked against the buckets' own drops), redeploy with replicated banks
    and prefill; then one float32 layer with replicas equal to it without."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.alloc import drop_rate, expected_max_load, plan_replication
    from repro_torch.launch import serve
    from repro_torch.models import layers, lm

    arch = "deepseek-v2-236b"
    dev = torch.device("cuda")
    cfg = get_config(arch).with_(n_layers=MOE_DEPTH[arch])
    b, s = MOE["batch"], MOE["prompt_len"]
    n_tok, k, n_exp = b * s, cfg.moe.top_k, cfg.moe.n_experts
    params, cache, prompts = serve.setup(cfg, b, s, 1, device=dev, seed=0)
    with torch.inference_mode():
        with dropped_assignments() as drops, layers.capture_routing() as records:
            serve.prefill(params, cfg, prompts, cache)
    del cache
    check(len(records) == cfg.n_layers and all(r.shape == (n_tok, k) for r in records),
          f"replication: records {[r.shape for r in records]}")
    hist = np.bincount(np.concatenate([r.reshape(-1) for r in records]), minlength=n_exp).astype(np.float64)
    hist /= hist.sum()
    plan = plan_replication(hist, slot_budget=MOE_SLOTS)
    check(plan.n_physical == MOE_SLOTS, f"replication: {plan.n_physical} slots")
    cap0 = layers._moe_capacity(cfg, n_tok, n_exp)
    cap1 = layers._moe_capacity(cfg, n_tok, plan.n_physical)
    before = moe_slot_loads(records, (1,) * n_exp, cap0)
    after = moe_slot_loads(records, plan.replication, cap1)
    check([round(d * n_tok * k) for _, d in before] == drops,
          f"replication: dispatch drops {[d for _, d in before]} vs the buckets' {drops}")
    pred = {
        "max_load": (expected_max_load(hist, n_tok, k), expected_max_load(plan, n_tok, k)),
        "drop": (drop_rate(hist, n_tok, k, cfg.moe.capacity_factor),
                 drop_rate(plan, n_tok, k, cfg.moe.capacity_factor)),
    }
    hot = np.argsort(-hist)[:4]
    print(f"{gpu}: {arch} ({cfg.n_layers} layers) expert replication: routing of the prefill captured "
          f"({len(records)} layers x {n_tok} tokens x {k}), histogram max {hist.max():.5f} / mean {1 / n_exp:.5f} "
          f"(hottest experts {hot.tolist()}), plan over {plan.n_physical} slots: {sum(r > 1 for r in plan.replication)} "
          f"experts replicated, at most {max(plan.replication)} replicas, expected balance {plan.balance:.4f}")
    for i, ((m0, d0), (m1, d1)) in enumerate(zip(before, after)):
        print(f"{gpu}: {arch} layer {i}: measured max slot load {m0} tokens at capacity {cap0} ({n_exp} slots) -> {m1} "
              f"at capacity {cap1} ({plan.n_physical} slots); dropped share {d0:.6f} -> {d1:.6f}")
    print(f"{gpu}: {arch} planner's predictions for {n_tok} tokens x {k} (expected_max_load, drop_rate at capacity "
          f"factor {cfg.moe.capacity_factor}): max slot load {pred['max_load'][0]:.2f} -> {pred['max_load'][1]:.2f}, "
          f"dropped share {pred['drop'][0]:.6f} -> {pred['drop'][1]:.6f}")

    # redeploy: the first MOE_REDEPLOY_DEPTH layers with replicated banks
    rcfg = cfg.with_(n_layers=MOE_REDEPLOY_DEPTH, moe=dataclasses.replace(cfg.moe, replication=plan.replication))
    model = redeploy(params, rcfg, plan.replication)
    del params
    torch.cuda.empty_cache()
    check(tuple(model.layers[0].moe.experts.w_up.shape) == (plan.n_physical, cfg.d_model, cfg.moe.d_ff_expert),
          f"replication: redeployed bank {tuple(model.layers[0].moe.experts.w_up.shape)}")
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        with dropped_assignments() as rdrops, layers.capture_routing() as rrec:
            _, logits, _ = serve.prefill(model, rcfg, prompts, lm.init_cache(rcfg, b, s + 1, device=dev))
        torch.cuda.synchronize()
        ms = timed(lambda: serve.prefill(model, rcfg, prompts, lm.init_cache(rcfg, b, s + 1, device=dev)), reps=3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(bool(torch.isfinite(logits).all()), "replication: non-finite logits after redeploying")
    real = moe_slot_loads(rrec, plan.replication, cap1)
    check([round(d * n_tok * k) for _, d in real] == rdrops,
          f"replication: redeployed dispatch drops {real} vs the buckets' {rdrops}")
    print(f"{gpu}: {arch} redeployed with {plan.n_physical} slots ({rcfg.n_layers} layers, "
          f"{sum(p.numel() for p in model.parameters())} parameters): prefill {ms:.3f} ms (CUDA events, warm), "
          f"logits finite, peak {peak:.2f} GB; measured on its own routing: "
          + "; ".join(f"layer {i} max slot load {m} dropped share {d:.6f}" for i, (m, d) in enumerate(real)))
    out = {"before": before, "after": after, "redeployed": real, "pred": pred, "plan_balance": plan.balance,
           "redeploy_prefill_ms": ms}
    del model, logits
    torch.cuda.empty_cache()

    # one FULL-width layer in float32 with no drops: replicas change nothing
    b1, s1, cf = MOE_REPL_CHECK["batch"], MOE_REPL_CHECK["prompt_len"], MOE_REPL_CHECK["capacity_factor"]
    one = get_config(arch).with_(n_layers=1, dtype="float32")
    one = one.with_(moe=dataclasses.replace(one.moe, capacity_factor=cf))
    params, _, toks = serve.setup(one, b1, s1, 1, device=dev, seed=2)
    rone = one.with_(moe=dataclasses.replace(one.moe, replication=plan.replication))
    with torch.inference_mode():
        want = lm.forward(params, one, toks)[0].float()
        model = redeploy(params, rone, plan.replication)
        got = lm.forward(model, rone, toks)[0].float()
    rel = float((got - want).abs().max() / want.abs().max())
    check(rel <= MOE_REPL_TOL, f"replication: float32 logits with replicas off by {rel} of max |logit|")
    print(f"{arch} one layer float32, {b1} x {s1} tokens, capacity factor {cf}: logits with {plan.n_physical} slots "
          f"vs {one.moe.n_experts}, max |diff| {rel:.3e} of max |logit| (limit {MOE_REPL_TOL})")
    out["replicas_rel"] = rel
    del params, model, want, got
    torch.cuda.empty_cache()
    return out


def moe_phase(gpu):
    """Phase 19: the MoE family on the card.  Returns Grok-1's path and K4
    numbers for the summary line."""
    import torch

    t0 = time.perf_counter()
    for arch in MOE_ARCHS:
        smoke_card_vs_host(arch)
    moe, knum = {}, {}
    for arch in MOE_ARCHS:
        moe[arch] = serve_full(arch, **MOE, label=arch, gpu=gpu, n_layers=MOE_DEPTH[arch])
        knum[arch] = kernel_numbers(moe[arch], gpu, arch)
        del moe[arch]["seen"]
    end_to_end_vs_plain("grok-1-314b", 3, n_layers=MOE_DEPTH["grok-1-314b"])
    repl = moe_replication_phase(gpu)
    for arch in MOE_ARCHS:
        d = moe[arch]
        print(f"{gpu}: {arch} ({MOE_DEPTH[arch]} layers) summary: prefill {min(d['prefill_ms']):.3f} ms (best of "
              f"{len(d['prefill_ms'])}), decode {max(d['decode_tok_per_s']):.1f} tok/s (best of 2) = "
              f"{min(d['decode_ms']) / (MOE['gen'] - 1):.3f} ms a step, device busy {d['busy']:.4f} over the prefill, "
              f"peak {d['peak_gb']:.2f} GB, launches K4 {d['k4_launches']}")
    print(f"{gpu}: phase 19 (MoE serving) took {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    return {"moe": moe, "knum": knum, "repl": repl}


# ---------------------------------------------------------------- phase 20


def train_launches(cfg):
    """{kernel: launches in one train step}: the forward's (``expected_launches``
    of a prefill) and one more for each remat recomputation that runs the
    kernel.  A recomputation stops once it has rebuilt what the backward
    saved: a hybrid group's runs through (its shared block comes last), so
    with remat K4 runs twice a site and K5 three times a grouped layer and
    twice a remainder layer; in the other families each layer runs twice,
    or, in blocks of k (k not 1 or L), three times but the last of a block
    twice."""
    from repro_torch.models.lm import _block_size

    fwd = {n: v[0] for n, v in expected_launches(cfg, 1).items()}
    L = cfg.n_layers
    if cfg.remat == "none":
        return fwd
    if cfg.family == "hybrid":
        main = L // cfg.shared_every * cfg.shared_every
        return {"k3": 0, "k4": 2 * fwd["k4"], "k5": 3 * main + 2 * (L - main)}
    k = _block_size(L)
    per_layer = 2 if k in (1, L) else 3 - 1 / k
    return {n: round(c * per_layer) for n, c in fwd.items()}


def encdec_launches(cfg):
    """{stage: K4 launches} of the enc-dec model: a serving prefill (encode,
    then a prompt into an empty cache) and ``make_encdec_prefill_step`` once
    per encoder layer and twice per decoder layer (self and cross); a decode
    step once per decoder layer (cross only: the self-attention over the
    cache is plain torch); a train step the prefill's, and under remat once
    more, since each layer is checkpointed alone and its recomputation runs
    through its attention to the MLP's saved down-projection."""
    fwd = cfg.n_encoder_layers + 2 * cfg.n_layers
    return {"prefill": fwd, "decode_step": cfg.n_layers, "prefill_step": fwd,
            "train_step": fwd if cfg.remat == "none" else 2 * fwd}


def _kernel_counts():
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.kernels.ssd_scan import ssd_chunk as k5
    from repro_torch.kernels.zskip_matmul import zskip_matmul as k3

    return {"k3": k3, "k4": k4, "k5": k5}


def function_vs_plain(op, plain, inputs, reps=3):
    """An op's autograd Function against autograd of its plain version on the
    same card inputs, through sum(out * w) with seeded w per output: (forward
    max |err| relative to max |plain|, per-input gradient max |err| relative
    to max |plain grad|, ms of forward + backward through the op and through
    the plain version).  The launches it makes are not counted."""
    import torch

    counts = _kernel_counts()
    saved = {n: k.launches for n, k in counts.items()}
    dev = inputs[0].device
    with torch.no_grad():
        shapes = [o.shape for o in (lambda o: o if isinstance(o, tuple) else (o,))(plain(*inputs))]
    g = torch.Generator(device=dev).manual_seed(11)
    weights = [torch.randn(s, generator=g, device=dev) for s in shapes]

    def run(fn):
        xs = [x.detach().requires_grad_(True) for x in inputs]
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        sum((o.float() * w).sum() for o, w in zip(outs, weights)).backward()
        return [o.detach() for o in outs], [x.grad for x in xs]

    (outs, grads), (outs_p, grads_p) = run(op), run(plain)
    torch.cuda.synchronize()

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))

    fwd = max(rel(a, b) for a, b in zip(outs, outs_p))
    grad = [rel(a, b) for a, b in zip(grads, grads_p)]
    ms, plain_ms = timed(lambda: run(op), reps=reps), timed(lambda: run(plain), reps=reps)
    for n, k in counts.items():
        k.launches = saved[n]
    return fwd, grad, ms, plain_ms


def train_kernel_grad_checks(gpu):
    """Phase 20 (a): K3, K4 and K5 under autograd against autograd of their
    plain versions on the card, at the training path's shapes.  Returns
    {kernel: {"grad_err", "fwd_err", "ms", "plain_ms"}} at the first shape."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_op, flash_attention_op_ref
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref
    from repro_torch.kernels.zskip_matmul import zskip_matmul_op, zskip_matmul_op_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for label, b, s, h, nkv, hd in K4_TRAIN_SHAPES:
        q = torch.randn((b, s, h, hd), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((b, s, nkv, hd), generator=g, device=dev).bfloat16() for _ in range(2))
        kw = dict(causal=True, round_scores=True)
        fwd, grad, ms, plain_ms = function_vs_plain(lambda *t: flash_attention_op(*t, **kw),
                                                    lambda *t: flash_attention_op_ref(*t, **kw), (q, k, v))
        check(fwd <= K4_TOL["bfloat16"] and max(grad) <= K4_GRAD_TOL,
              f"K4 under autograd at {label}'s {(b, s, h, nkv, hd)}: forward {fwd}, grads {grad} (limit {K4_GRAD_TOL})")
        out.setdefault("k4", dict(grad_err=0.0, fwd_err=0.0, ms=ms, plain_ms=plain_ms))
        out["k4"]["grad_err"] = max(out["k4"]["grad_err"], *grad)
        out["k4"]["fwd_err"] = max(out["k4"]["fwd_err"], fwd)
        print(f"{gpu}: K4 under autograd at {label}'s (b {b}, s {s}, {h} q / {nkv} kv heads, hd {hd}) bf16, "
              f"round_scores: forward max |err| {fwd:.3e} of max |plain|, gradients of q, k, v "
              + ", ".join(f"{e:.3e}" for e in grad) + f" of max |plain grad| (limit {K4_GRAD_TOL}); forward + "
              f"backward {ms:.3f} ms through the Function, {plain_ms:.3f} ms through the plain version")
    nc, Q, H, P, N = K5_TRAIN_SHAPE
    for dt in ("bfloat16", "float32"):
        tdt = getattr(torch, dt)
        cum = torch.cumsum(-torch.rand((nc, Q, H), generator=g, device=dev) * 0.05, dim=1).to(tdt)
        xdt = torch.randn((nc, Q, H, P), generator=g, device=dev).to(tdt)
        B, C = (torch.randn((nc, Q, N), generator=g, device=dev).to(tdt) for _ in range(2))
        fwd, grad, ms, plain_ms = function_vs_plain(ssd_chunk, ssd_chunk_ref, (cum, xdt, B, C))
        check(fwd <= K5_TOL[dt] and max(grad) <= K5_GRAD_TOL,
              f"K5 under autograd {dt}: forward {fwd}, grads {grad} (limit {K5_GRAD_TOL})")
        if dt == "bfloat16":
            out["k5"] = dict(grad_err=max(grad), fwd_err=fwd, ms=ms, plain_ms=plain_ms)
        else:
            out["k5"]["grad_err"] = max(out["k5"]["grad_err"], *grad)
        print(f"{gpu}: K5 under autograd at Zamba2's {nc} cells x Q {Q} x {H} heads x P {P}, N {N} {dt}: forward "
              f"max |err| {fwd:.3e} of max |plain| (y and S), gradients of cum, xdt, B, C "
              + ", ".join(f"{e:.3e}" for e in grad) + f" of max |plain grad| (limit {K5_GRAD_TOL}); forward + "
              f"backward {ms:.3f} ms through the Function, {plain_ms:.3f} ms through the plain version")
    M, K, N = K3_TRAIN_SHAPE
    a = torch.relu(torch.randn((M, K), generator=g, device=dev)).square_().bfloat16()
    w = (torch.randn((K, N), generator=g, device=dev) / K ** 0.5).bfloat16()
    fwd, grad, ms, plain_ms = function_vs_plain(zskip_matmul_op, zskip_matmul_op_ref, (a, w), reps=2)
    check(fwd <= K3_TOL["bfloat16"] and max(grad) <= K3_GRAD_TOL,
          f"K3 under autograd at {(M, K, N)}: forward {fwd}, grads {grad} (limit {K3_GRAD_TOL})")
    out["k3"] = dict(grad_err=max(grad), fwd_err=fwd, ms=ms, plain_ms=plain_ms)
    print(f"{gpu}: K3 under autograd at Nemotron-4-15B's down-projection ({M}, {K}) @ ({K}, {N}) bf16: forward "
          f"max |err| {fwd:.3e} of max |plain|, gradients of A, B " + ", ".join(f"{e:.3e}" for e in grad)
          + f" of max |plain grad| (limit {K3_GRAD_TOL}; bf16 products against the plain version's float32 ones); "
          f"forward + backward {ms:.3f} ms through the Function, {plain_ms:.3f} ms through the plain version")
    del a, w
    torch.cuda.empty_cache()
    return out


def _leaf_rel(got: dict, want: dict) -> dict:
    return {n: float((got[n].float() - want[n].float()).abs().max() / want[n].float().abs().max().clamp_min(1e-30))
            for n in want}


def updated_params_check(got: dict, want: dict, label: str):
    """Parameters after one AdamW step (TRAIN_SMOKE_OPT's lr, decay 0.1) on
    the card against the host: every entry within 2 lr (1 + wd max |p|), at
    most TRAIN_PARAM_SHARE of all entries more than TRAIN_PARAM_TOL of their
    leaf's max |p| apart.  Returns (entries off, entries, max |diff|)."""
    lr, wd = TRAIN_SMOKE_OPT["lr"], 0.1
    off, total, pmax = 0, 0, 0.0
    for n in want:
        d = (got[n] - want[n]).abs()
        scale = float(want[n].abs().max())
        off += int((d > TRAIN_PARAM_TOL * scale).sum())
        total += d.numel()
        pmax = max(pmax, float(d.max()))
        check(float(d.max()) <= 2 * lr * (1 + wd * scale), f"{label}: {n} moved {float(d.max())} apart")
    check(off / total <= TRAIN_PARAM_SHARE, f"{label}: {off} of {total} updated entries off")
    return off, total, pmax


def train_smoke_card_vs_host(arch, gpu):
    """Phase 20 (b): the SMOKE config in float32 from one set of parameters,
    the loss and every gradient, then one ``make_train_step``, on the host
    (plain versions) and on the card (kernels, each launched as often as
    ``train_launches`` says).  Returns the card's launches in the step."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step

    counts = _kernel_counts()
    small = get_config(arch, smoke=True).with_(dtype="float32")
    host = lm.init_params(small, generator=torch.Generator().manual_seed(0), device="cpu")
    card = lm.LM(small, None, torch.device("cuda"))
    card.load_state_dict(host.state_dict())
    b = SyntheticLM(DataConfig(vocab=small.vocab, seq_len=TRAIN_SMOKE["seq"], global_batch=TRAIN_SMOKE["batch"]),
                    device="cpu").batch(0)
    res = []
    for model, d in ((host, "cpu"), (card, "cuda")):
        batch = {k: v.to(d) for k, v in b.items()}
        for p in model.parameters():
            p.requires_grad_(True)
        loss = lm.loss_fn(model, small, batch["tokens"], batch["targets"])
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        missing = [n for n, gr in grads.items() if gr is None]
        check(not missing, f"train smoke {arch} on {d}: no gradient for {missing}")
        grads = {n: gr.detach().cpu() for n, gr in grads.items()}
        for p in model.parameters():
            p.grad = None
            p.requires_grad_(False)
        state = adamw_init(model)
        before = {n: k.launches for n, k in counts.items()}
        model, state, m = make_train_step(small, AdamWConfig(**TRAIN_SMOKE_OPT))(model, state, batch)
        used = {n: k.launches - before[n] for n, k in counts.items()}
        res.append((float(loss.detach()), grads, float(m["loss"]),
                    {n: p.detach().cpu() for n, p in model.named_parameters()}, used))
    torch.cuda.synchronize()
    (lh, gh, mh, ph, _), (lc, gc, mc, pc, used) = res
    want = train_launches(small)
    check(used == want, f"train smoke {arch}: K3/K4/K5 launched {used} in the card's step, want {want}")
    check(all(bool(torch.isfinite(v).all()) for v in gc.values()), f"train smoke {arch}: non-finite card gradients")
    loss_rel = max(abs(lc - lh) / abs(lh), abs(mc - mh) / abs(mh))
    check(loss_rel <= TRAIN_LOSS_TOL, f"train smoke {arch}: card loss {lc} vs host {lh}")
    gerr = _leaf_rel(gc, gh)
    worst = max(gerr, key=gerr.get)
    check(gerr[worst] <= TRAIN_CARD_HOST_TOL, f"train smoke {arch}: gradient of {worst} off by {gerr[worst]}")
    off, total, pmax = updated_params_check(pc, ph, f"train smoke {arch}")
    print(f"{gpu}: {arch} SMOKE float32 train step, card (K3/K4/K5 launches {tuple(used.values())}) vs host (plain "
          f"versions): loss {lc:.6f} vs {lh:.6f} ({loss_rel:.3e} relative, limit {TRAIN_LOSS_TOL}); all "
          f"{len(gc)} parameters have a gradient, worst leaf {worst} {gerr[worst]:.3e} of max |host grad| (limit "
          f"{TRAIN_CARD_HOST_TOL}); updated parameters: {off} of {total} entries more than {TRAIN_PARAM_TOL} of their "
          f"leaf's max |p| apart (limit a share of {TRAIN_PARAM_SHARE}), max |diff| {pmax:.3e} (limit 2 lr (1 + wd "
          f"max |p|))")
    return used


def train_e2e_vs_plain(gpu):
    """Phase 20 (c): Zamba2-1.2B at full width and depth in float32, remat as
    published: one step's loss and every gradient with the kernels, then with
    the plain versions swapped in (no launch), and, as the gradients'
    conditioning, the plain versions again on parameters perturbed by about
    one float32 rounding (each times 1 + 2^-23 N(0, 1)).  The kernels' run
    must stay within TRAIN_E2E_TOL of the plain one, or within
    TRAIN_E2E_FACTOR times the perturbed run's distance."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import lm

    dev = torch.device("cuda")
    counts = _kernel_counts()
    saved = {n: k.launches for n, k in counts.items()}
    cfg = get_config(TRAIN["arch"]).with_(dtype="float32")
    params = lm.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    b = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_E2E["seq"], global_batch=TRAIN_E2E["batch"]),
                    device=dev).batch(0)
    originals = {n: p.detach().clone() for n, p in params.named_parameters()}
    for p in params.parameters():
        p.requires_grad_(True)
    runs = {}
    for name in ("kernels", "plain", "perturbed"):
        swap = contextlib.nullcontext() if name == "kernels" else swapped_ops.plain()
        if name == "perturbed":
            g = torch.Generator(device=dev).manual_seed(4)
            with torch.no_grad():
                for p in params.parameters():
                    p.add_(p * torch.randn(p.shape, generator=g, device=dev) * 2.0 ** -23)
        before = {n: k.launches for n, k in counts.items()}
        with swap:
            loss = lm.loss_fn(params, cfg, b["tokens"], b["targets"])
            loss.backward()
        torch.cuda.synchronize()
        used = {n: k.launches - before[n] for n, k in counts.items()}
        want = train_launches(cfg) if name == "kernels" else {"k3": 0, "k4": 0, "k5": 0}
        check(used == want, f"train end to end, {name}: K3/K4/K5 launched {used}, want {want}")
        runs[name] = (float(loss.detach()), {n: p.grad for n, p in params.named_parameters()})
        for p in params.parameters():
            p.grad = None
    (lk, gk), (lp, gp), (lq, gq) = runs["kernels"], runs["plain"], runs["perturbed"]
    missing = [n for n, gr in gk.items() if gr is None]
    check(not missing, f"train end to end: no gradient for {missing}")
    loss_rel, loss_cond = abs(lk - lp) / abs(lp), abs(lq - lp) / abs(lp)
    gerr, gcond = _leaf_rel(gk, gp), _leaf_rel(gq, gp)
    worst, cond = max(gerr, key=gerr.get), max(gcond.values())
    limit = max(TRAIN_E2E_TOL, TRAIN_E2E_FACTOR * cond)
    check(loss_rel <= max(TRAIN_E2E_TOL, TRAIN_E2E_FACTOR * loss_cond) and gerr[worst] <= limit,
          f"train end to end: loss {lk} vs {lp}, gradient of {worst} off by {gerr[worst]} (limit {limit}; "
          f"perturbed parameters move the plain gradients by up to {cond})")
    share = sum(e > TRAIN_E2E_TOL for e in gerr.values())
    print(f"{gpu}: {cfg.name} float32 at full width and depth ({cfg.n_layers} layers, remat {cfg.remat}), "
          f"{TRAIN_E2E['batch']} x {TRAIN_E2E['seq']} tokens, one step's loss and gradients, kernels (K3/K4/K5 "
          f"launches {tuple(train_launches(cfg).values())}) vs plain versions: loss {lk:.7f} vs {lp:.7f} "
          f"({loss_rel:.3e} relative; the perturbed run {loss_cond:.3e}), worst of {len(gk)} gradients {worst} "
          f"{gerr[worst]:.3e} of max |plain grad|, {share} leaves above {TRAIN_E2E_TOL}; the plain versions on "
          f"parameters perturbed by one float32 rounding move them by up to {cond:.3e} (worst "
          f"{max(gcond, key=gcond.get)}); limit max({TRAIN_E2E_TOL}, {TRAIN_E2E_FACTOR} x that) = {limit:.3e}")
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.copy_(originals[n])
    del params, runs, gk, gp, gq, originals
    torch.cuda.empty_cache()
    for n, k in counts.items():
        k.launches = saved[n]
    return {"loss_rel": loss_rel, "grad_rel": gerr[worst], "grad_cond": cond}


def train_full(gpu):
    """Phase 20 (d): Zamba2-1.2B trained at full width and depth, bf16
    compute on float32 masters, remat as published: ``SyntheticLM`` batches,
    AdamW as ``launch.train`` sets it, ``make_train_step``, TRAIN["steps"]
    steps with K3's, K4's and K5's counts set to 0 just before each step and
    read just after.  Returns the numbers the summary prints."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step

    dev = torch.device("cuda")
    counts = _kernel_counts()
    cfg = get_config(TRAIN["arch"])
    bsz, seq, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    state = adamw_init(params)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=bsz), device=dev)
    step = make_train_step(cfg, AdamWConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"], total_steps=steps))
    n_params = sum(p.numel() for p in params.parameters())
    torch.cuda.synchronize()
    setup_gb = torch.cuda.max_memory_allocated() / 1e9
    want = train_launches(cfg)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    losses, ms, launched = [], [], []
    for s in range(steps):
        batch = data.batch(s)
        torch.cuda.synchronize()
        for k in counts.values():
            k.launches = 0
        ev[0].record()
        params, state, m = step(params, state, batch)
        ev[1].record()
        ev[1].synchronize()
        used = {n: k.launches for n, k in counts.items()}
        check(used == want, f"train {cfg.name} step {s}: K3/K4/K5 launched {used}, want {want}")
        launched.append(used)
        losses.append(float(m["loss"]))
        ms.append(ev[0].elapsed_time(ev[1]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(x) for x in losses), f"train {cfg.name}: losses {losses}")
    check(losses[-1] < losses[0], f"train {cfg.name}: loss did not fall, {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in params.parameters()), f"train {cfg.name}: non-finite parameters")
    check(peak_gb <= TRAIN_PEAK_GB, f"train {cfg.name}: peak {peak_gb:.2f} GB over {TRAIN_PEAK_GB}")
    tokens = bsz * seq
    warm = ms[1:]
    best = min(warm)
    flops = 6 * n_params * tokens
    out = dict(n_params=n_params, losses=losses, ms=ms, peak_gb=peak_gb, setup_gb=setup_gb, launches=want,
               tok_per_s=tokens / (best * 1e-3), mfu=flops / (best * 1e-3) / BF16_OPS_PER_S, flops=flops)
    print(f"{gpu}: {cfg.name} trained at full width and depth: {cfg.n_layers} Mamba2 layers, d_model {cfg.d_model}, "
          f"{cfg.n_layers // cfg.shared_every} shared-attention sites, vocab {cfg.vocab}, {n_params} parameters "
          f"(float32 masters, {cfg.dtype} compute, remat {cfg.remat}); {steps} make_train_step steps of SyntheticLM "
          f"batches {bsz} x {seq}, AdamW lr {TRAIN['lr']} warmup {TRAIN['warmup']} total {steps}; launches per step "
          f"K3 {want['k3']}, K4 {want['k4']}, K5 {want['k5']} (checked at every step; {steps * want['k5']} K5 and "
          f"{steps * want['k4']} K4 over the run); losses " + ", ".join(f"{x:.4f}" for x in losses))
    print(f"{gpu}: {cfg.name} train step ms (CUDA events, one step each): " + ", ".join(f"{x:.2f}" for x in ms)
          + f"; warm best {best:.2f} ms, mean {sum(warm) / len(warm):.2f} ms = {out['tok_per_s']:.0f} tokens/s at "
          f"best; model FLOPs 6 x {n_params} parameters x {tokens} tokens = {flops:.4e} a step (the layers' "
          f"products, forward and backward; attention's s^2 terms and remat's recomputation not counted), "
          f"{out['mfu']:.4f} of the {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16 peak; peak device memory {peak_gb:.2f} "
          f"GB (torch.cuda.max_memory_allocated; {setup_gb:.2f} GB after setup; limit {TRAIN_PEAK_GB})")
    # where a step goes: the loss and backward, then the update, apart (one
    # more step, written out as make_train_step runs it), by CUDA events and
    # by the host's clock up to the end of each part's enqueue
    from repro_torch.optim.adamw import adamw_update, named

    batch = data.batch(steps)
    ps = named(params)
    for p in ps.values():
        p.requires_grad_(True)
    ev3 = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    ev3[0].record()
    loss = lm.loss_fn(params, cfg, batch["tokens"], batch["targets"])
    loss.backward()
    ev3[1].record()
    h1 = time.perf_counter()
    adamw_update(AdamWConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"], total_steps=steps),
                 {k: p.grad for k, p in ps.items()}, params, state)
    ev3[2].record()
    h2 = time.perf_counter()
    ev3[2].synchronize()
    for p in ps.values():
        p.grad = None
        p.requires_grad_(False)
    out.update(fwd_bwd_ms=ev3[0].elapsed_time(ev3[1]), update_ms=ev3[1].elapsed_time(ev3[2]),
               fwd_bwd_host_ms=(h1 - h0) * 1e3, update_host_ms=(h2 - h1) * 1e3)
    print(f"{gpu}: {cfg.name} one more step in parts: loss + backward {out['fwd_bwd_ms']:.2f} ms (CUDA events; the "
          f"host enqueued it in {out['fwd_bwd_host_ms']:.2f} ms), AdamW update over {len(ps)} tensors "
          f"{out['update_ms']:.2f} ms (host {out['update_host_ms']:.2f} ms)")
    n_dev = {}
    share, win_ms, by_name = device_busy(lambda: step(params, state, data.batch(steps + 1)), n_dev)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out.update(busy=share, busy_window_ms=win_ms, top=top, device_ops=sum(n_dev.values()))
    print(f"{gpu}: {cfg.name} one train step under torch.profiler: window {win_ms:.3f} ms, device busy {share:.4f} "
          f"(idle {1 - share:.4f}), {out['device_ops']} device kernels and copies ({win_ms * 1e3 / out['device_ops']:.1f} "
          f"us of window each); top device time: "
          + "; ".join(f"{n[:60]} {t:.3f} ms ({n_dev[n]}x)" for n, t in top))
    del params, state
    torch.cuda.empty_cache()
    return out


def train_runner_checks(gpu):
    """Phase 20 (e): under ``torch.use_deterministic_algorithms(True)``, for
    each TRAIN_RUNNER_ARCHS SMOKE config: one step alone, then ``TrainRunner``
    clean and with injected failures (restore from the last checkpoint and
    replay), the replayed run equal to the clean one bit for bit (parameters,
    AdamW moments, every step's loss); then ``launch.train.main`` with
    ``--ckpt`` and then ``--resume``."""
    import io
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import train as launch_train
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import FaultInjector, RunnerConfig, TrainRunner
    from repro_torch.train.step import make_train_step

    dev = torch.device("cuda")
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for arch in TRAIN_RUNNER_ARCHS:
                cfg = get_config(arch, smoke=True)
                data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SMOKE["seq"],
                                              global_batch=TRAIN_SMOKE["batch"]), device=dev)
                step = make_train_step(cfg, AdamWConfig(**TRAIN_SMOKE_OPT))

                def fresh():
                    model = lm.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
                    return model, adamw_init(model)

                step(*fresh(), data.batch(0))  # a step alone: any non-deterministic op raises here
                runs = {}
                for name, hook in (("clean", None), ("faulty", FaultInjector(fail_at=dict(TRAIN_RUNNER_FAILS)))):
                    runner = TrainRunner(RunnerConfig(ckpt_dir=os.path.join(tmp, arch, name), ckpt_every=3),
                                         step, lambda s: data.batch(s), fault_hook=hook)
                    params, state = runner.run(*fresh(), TRAIN_RUNNER_STEPS)
                    last = {h.step: h.metrics["loss"] for h in runner.history}
                    runs[name] = (params, state, last, runner.restores)
                (pc, sc, lc, _), (pf, sf, lf, restores) = runs["clean"], runs["faulty"]
                check(restores == len(TRAIN_RUNNER_FAILS), f"runner {arch}: {restores} restores")
                diff = max(float((a - b).abs().max()) for a, b in zip(pc.parameters(), pf.parameters()))
                mdiff = max(float((sc[k][n] - sf[k][n]).abs().max()) for k in ("m", "v") for n in sc["m"])
                check(diff == 0.0 and mdiff == 0.0 and lc == lf and int(sc["step"]) == int(sf["step"]),
                      f"runner {arch}: replayed run differs from the clean one: parameters {diff}, moments {mdiff}, "
                      f"losses {lc} vs {lf}")
                out[arch] = restores
                print(f"{gpu}: {arch} SMOKE ({cfg.dtype}) TrainRunner, {TRAIN_RUNNER_STEPS} steps, checkpoints every "
                      f"3, failures injected at steps {sorted(TRAIN_RUNNER_FAILS)}: {restores} restores and replays; "
                      f"parameters, AdamW moments and every step's loss equal to the clean run bit for bit "
                      f"(torch.use_deterministic_algorithms); losses " + ", ".join(f"{lc[s]:.4f}" for s in sorted(lc)))
            ck = os.path.join(tmp, "launch")
            argv = ["--arch", "zamba2-1.2b", "--smoke", "--batch", "2", "--seq", "32", "--ckpt", ck,
                    "--ckpt-every", "3", "--device", "cuda"]
            lines = []
            for extra in (["--steps", "6"], ["--steps", "8", "--resume"]):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    check(launch_train.main(argv + extra) == 0, f"launch.train {extra}: non-zero")
                lines.append(buf.getvalue().strip().splitlines())
            first, second = json.loads(lines[0][-1]), json.loads(lines[1][-1])
            check(first["steps"] == 6 and math.isfinite(first["last_loss"]), f"launch.train: {first}")
            check("resumed from step 6" in lines[1] and second["steps"] == 2 and math.isfinite(second["last_loss"]),
                  f"launch.train --resume: {lines[1]}")
            with np.load(os.path.join(ck, "step_00000008", "arrays.npz")) as npz:
                keys = set(npz.files)
                wz = npz["params/layers/mamba/wz"].shape
            zs = get_config("zamba2-1.2b", smoke=True)
            check({"opt/step", "params/embed", "opt/m/layers/mamba/wz", "params/shared_block/attn/wq"} <= keys
                  and wz == (zs.n_layers, zs.d_model, zs.ssm.d_inner(zs.d_model)),
                  f"launch.train checkpoint keys {sorted(keys)[:8]}..., wz {wz}")
            print(f"{gpu}: launch.train.main on the card: 6 steps with --ckpt, then --resume to 8 (resumed from step "
                  f"6): {first} / {second}; checkpoint in the reference's layout ({len(keys)} arrays, "
                  f"params/layers/mamba/wz {wz})")
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def train_phase(gpu):
    """Phase 20: training on the card.  Returns the numbers of the summary
    and the kernels line."""
    import torch

    t0 = time.perf_counter()
    grads = train_kernel_grad_checks(gpu)
    smoke = {arch: train_smoke_card_vs_host(arch, gpu) for arch in TRAIN_SMOKE_ARCHS}
    e2e = train_e2e_vs_plain(gpu)
    full = train_full(gpu)
    runner = train_runner_checks(gpu)
    print(f"{gpu}: phase 20 (training) took {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    return {"grads": grads, "smoke": smoke, "e2e": e2e, "full": full, "runner": runner}


# ---------------------------------------------------------------- phase 21


def encdec_k4_checks():
    """K4 against its plain version at Whisper-medium's shapes (part of
    ``k4_card_checks``), 16 heads of 64 against 1500 keys, non-causal: the
    encoder's (4, 1500) square (1500 keys are 23.4 tiles of 64: every row
    block masks a ragged last tile) and cross-attention's 1, 64 and 448
    queries, float32 and bf16, with and without ``round_scores``.  Returns
    the max |err| per dtype."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention as k4, flash_attention_op_ref

    dev = torch.device("cuda")
    cfg = get_config("whisper-medium")
    nh, nkv, hd = cfg.attn_dims()
    sk = cfg.encoder_seq
    saved = k4.launches
    rng = np.random.default_rng(21)
    worst = {}
    for dt in ("float32", "bfloat16"):
        tol, tdt = K4_TOL[dt], getattr(torch, dt)
        k, v = (torch.from_numpy(rng.standard_normal((4, sk, nkv, hd), dtype=np.float32)).to(dev, tdt)
                for _ in range(2))
        for sq in WHISPER_K4_SQ:
            q = torch.from_numpy(rng.standard_normal((4, sq, nh, hd), dtype=np.float32)).to(dev, tdt)
            for rounded in (False, True):
                before = k4.launches
                got = ops.flash_attention_op(q, k, v, causal=False, round_scores=rounded)
                torch.cuda.synchronize()
                check(k4.launches == before + 1, f"K4 whisper sq {sq}: no launch")
                err, rel = rel_err(got, flash_attention_op_ref(q, k, v, False, round_scores=rounded))
                # as k4_card_checks holds them: max |err| without the rounding,
                # relative to 1 + |plain| with it
                check((rel if rounded else err) <= tol,
                      f"K4 {dt} whisper (4, {sq}, {nh}, {hd}) against {sk} keys, non-causal, round_scores "
                      f"{rounded}: max |err| {err}, relative to 1 + |plain| {rel} (limit {tol})")
                worst[dt] = max(worst.get(dt, 0.0), err)
    torch.cuda.synchronize()
    k4.launches = saved
    print(f"K4 vs plain at Whisper-medium's shapes, (4, sq, {nh} heads, hd {hd}) against {sk} keys, non-causal, "
          f"sq in {WHISPER_K4_SQ}, with and without round_scores: max |err| "
          + ", ".join(f"{d} {e:.3e} (limit {K4_TOL[d]})" for d, e in worst.items()))
    return worst


def encdec_k4_grad_checks(gpu):
    """Phase 21 (b): K4 under autograd (bf16, non-causal, round_scores)
    against autograd of its plain version at the encoder's and
    cross-attention's training shapes.  Returns the worst gradient error,
    and the encoder shape's forward + backward ms through the Function and
    through the plain version."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_op, flash_attention_op_ref

    dev = torch.device("cuda")
    cfg = get_config("whisper-medium")
    nh, nkv, hd = cfg.attn_dims()
    g = torch.Generator(device=dev).manual_seed(21)
    kw = dict(causal=False, round_scores=True)
    out = dict(grad_err=0.0)
    for label, b, sq in WHISPER_K4_GRAD:
        q = torch.randn((b, sq, nh, hd), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((b, cfg.encoder_seq, nkv, hd), generator=g, device=dev).bfloat16() for _ in range(2))
        fwd, grad, ms, plain_ms = function_vs_plain(lambda *t: flash_attention_op(*t, **kw),
                                                    lambda *t: flash_attention_op_ref(*t, **kw), (q, k, v))
        check(fwd <= K4_TOL["bfloat16"] and max(grad) <= K4_GRAD_TOL,
              f"K4 under autograd at whisper's {label} shape: forward {fwd}, grads {grad} (limit {K4_GRAD_TOL})")
        out["grad_err"] = max(out["grad_err"], *grad)
        out.setdefault("ms", ms)
        out.setdefault("plain_ms", plain_ms)
        print(f"{gpu}: K4 under autograd at Whisper-medium's {label} shape (b {b}, sq {sq} against "
              f"{cfg.encoder_seq} keys, {nh} heads, hd {hd}) bf16, non-causal, round_scores: forward max |err| "
              f"{fwd:.3e} of max |plain|, gradients of q, k, v " + ", ".join(f"{e:.3e}" for e in grad)
              + f" of max |plain grad| (limit {K4_GRAD_TOL}); forward + backward {ms:.3f} ms through the "
              f"Function, {plain_ms:.3f} ms through the plain version")
    torch.cuda.empty_cache()
    return out


def encdec_path_inputs(params, cfg, frames, prompts, cache):
    """The first K4 call of each kind on the serving path, with its inputs
    (clones): the encoder's (``enc``), cross-attention's over the prompt
    (``cross_prompt``) and at a decode step (``cross_decode``), recorded
    over encode, the prompt and one decode step; the launches they make are
    not counted."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.models import encdec
    from repro_torch.train.step import make_encdec_decode_step

    seen = {}
    stage = ["enc"]

    def rec4(q, k, v, **kw):
        kind = stage[0] if stage[0] != "prompt" else "self" if kw["causal"] else "cross_prompt"
        seen.setdefault(kind, ([q.clone(), k.clone(), v.clone()], kw))
        return ops.flash_attention_op(q, k, v, **kw)

    saved = k4.launches
    with swapped_ops(ops.zskip_matmul_op, rec4, ops.ssd_chunk_op):
        enc = encdec.encode(params, cfg, frames)
        stage[0] = "prompt"
        logits, cache = encdec.decode(params, cfg, prompts, enc, cache)
        stage[0] = "cross_decode"
        make_encdec_decode_step(cfg)(params, cache, enc, torch.argmax(logits[:, -1], -1)[:, None])
    torch.cuda.synchronize()
    k4.launches = saved
    check({"enc", "cross_prompt", "cross_decode", "self"} <= set(seen), f"whisper path inputs: {sorted(seen)}")
    return seen


def encdec_serve(gpu):
    """Phase 21 (c): Whisper-medium served at full width and depth on the
    card: random parameters and N(0, 1) frames from one seeded generator,
    ``encode``, the prompt into an empty cache (``decode``), then
    ``gen - 1`` ``make_encdec_decode_step`` calls, with K4's count set to 0
    just before and read after the prefill and the decode; the prefill step
    apart; what came out; timings, busy shares, peak memory and K4 per
    launch on the path's own inputs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.models import encdec
    from repro_torch.train.step import make_encdec_decode_step, make_encdec_prefill_step

    dev = torch.device("cuda")
    cfg = get_config("whisper-medium")
    b, plen, gen = WHISPER["batch"], WHISPER["prompt_len"], WHISPER["gen"]
    label = "whisper-medium"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    params = encdec.init_encdec_params(cfg, generator=g, device=dev)
    frames = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=g, device=dev)
    prompts = torch.randint(0, cfg.vocab, (b, plen), generator=g, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    out = {"setup_s": time.perf_counter() - t0, "params": n_params}
    print(f"{label}: {cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder layers, {n_params} parameters (float32, "
          f"seeded torch.Generator) on the card in {out['setup_s']:.3f} s; {b} x {cfg.encoder_seq} frames, "
          f"prompts of {plen} tokens, {gen} generated")
    want = encdec_launches(cfg)
    step = make_encdec_decode_step(cfg)
    prefill_step = make_encdec_prefill_step(cfg)

    def new_cache():
        return encdec.init_decoder_cache(cfg, b, plen + gen, device=dev)

    def prefill(cache):
        enc = encdec.encode(params, cfg, frames)
        logits, cache = encdec.decode(params, cfg, prompts, enc, cache)
        return enc, logits, cache

    def decode(enc, cache, tok, steps, counted=False):
        toks = []
        for i in range(steps):
            before = k4.launches
            tok, cache = step(params, cache, enc, tok[:, None])
            check(not counted or k4.launches - before == want["decode_step"],
                  f"{label}: decode step {i} launched K4 {k4.launches - before} times, want {want['decode_step']}")
            toks.append(tok)
        return torch.stack(toks, dim=1), cache

    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        k4.launches = 0
        enc, logits, cache = prefill(new_cache())
        torch.cuda.synchronize()
        in_prefill = k4.launches
        tok = torch.argmax(logits[:, -1], dim=-1)
        rest, cache = decode(enc, cache, tok, gen - 1, counted=True)
        torch.cuda.synchronize()
        on_path = k4.launches
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        path_want = (want["prefill"], want["prefill"] + (gen - 1) * want["decode_step"])
        check((in_prefill, on_path) == path_want,
              f"{label}: K4 launched {in_prefill} times in the prefill, {on_path} on the path, want {path_want}")
        k4.launches = 0
        last = prefill_step(params, frames, prompts)
        torch.cuda.synchronize()
        check(k4.launches == want["prefill_step"],
              f"{label}: make_encdec_prefill_step launched K4 {k4.launches} times, want {want['prefill_step']}")
        out.update(k4_prefill=in_prefill, k4_launches=on_path, k4_decode_step=want["decode_step"],
                   k4_prefill_step=k4.launches)
        print(f"{label}: main path ran (encode, the prompt into the cache, {gen - 1} decode steps), K4 launches in the "
              f"prefill / on the path: {in_prefill} / {on_path} ({cfg.n_encoder_layers} encoder, {cfg.n_layers} "
              f"decoder self, {cfg.n_layers} cross, then {want['decode_step']} cross at each decode step, checked "
              f"at each); "
              f"make_encdec_prefill_step {k4.launches}")

        # what came out
        toks = torch.cat([tok[:, None], rest], dim=1)
        check(tuple(enc.shape) == (b, cfg.encoder_seq, cfg.d_model) and enc.dtype == torch.bfloat16
              and bool(torch.isfinite(enc).all()), f"{label}: encoder output {tuple(enc.shape)} {enc.dtype}")
        check(tuple(logits.shape) == (b, plen, cfg.vocab) and logits.dtype == torch.bfloat16
              and bool(torch.isfinite(logits).all()), f"{label}: logits {tuple(logits.shape)} {logits.dtype}")
        check(tuple(toks.shape) == (b, gen) and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
              f"{label}: tokens {tuple(toks.shape)}")
        check(cache["layers"]["len"] == plen + gen - 1 and bool(torch.isfinite(cache["layers"]["k"]).all())
              and bool(torch.isfinite(cache["layers"]["v"]).all()), f"{label}: cache len {cache['layers']['len']}")
        # the prefill step (no cache) computes the same last logits
        same = float((last.float() - logits[:, -1].float()).abs().max() / logits[:, -1].float().abs().max())
        check(same <= E2E_TOL, f"{label}: make_encdec_prefill_step's logits {same} of max |logit| from the prefill's")
        out["sample"] = toks[0, :8].tolist()
        del logits, last
        print(f"{label}: encoder output and logits finite, shapes {(b, cfg.encoder_seq, cfg.d_model)} and "
              f"{(b, plen, cfg.vocab)}; make_encdec_prefill_step's last logits {same:.3e} of max |logit| from the "
              f"cached prefill's; tokens of prompt 0: {out['sample']}; peak device memory on the path "
              f"{out['peak_gb']:.2f} GB (torch.cuda.max_memory_allocated)")

        # timings (CUDA events, warm)
        out["encode_ms"] = timed(lambda: encdec.encode(params, cfg, frames), reps=3)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pre = []
        for _ in range(3):
            c = new_cache()
            torch.cuda.synchronize()
            ev[0].record()
            prefill(c)
            ev[1].record()
            ev[1].synchronize()
            pre.append(ev[0].elapsed_time(ev[1]))
        out["prefill_ms"] = pre
        out["prefill_step_ms"] = timed(lambda: prefill_step(params, frames, prompts), reps=3)
        dec = []
        for _ in range(2):
            enc2, lg2, c2 = prefill(new_cache())
            tok2 = torch.argmax(lg2[:, -1], dim=-1)
            torch.cuda.synchronize()
            ev[0].record()
            decode(enc2, c2, tok2, gen - 1)
            ev[1].record()
            ev[1].synchronize()
            dec.append(ev[0].elapsed_time(ev[1]))
        del c, c2, lg2
        out["decode_ms"] = dec
        out["decode_tok_per_s"] = [b * (gen - 1) / (ms * 1e-3) for ms in dec]
        share, win_ms, by_name = device_busy(lambda: prefill(new_cache()))
        out["busy"], out["busy_window_ms"] = share, win_ms
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        print(f"{gpu}: {label} encode {out['encode_ms']:.3f} ms; prefill (encode + the prompt into the cache) ms "
              f"(CUDA events, warm): " + ", ".join(f"{x:.3f}" for x in pre)
              + f"; make_encdec_prefill_step {out['prefill_step_ms']:.3f} ms; decode {gen - 1} steps: "
              + ", ".join(f"{x:.3f} ms = {t:.1f} tok/s" for x, t in zip(dec, out["decode_tok_per_s"])))
        print(f"{gpu}: {label} prefill under torch.profiler: window {win_ms:.3f} ms, device busy {share:.4f} "
              f"(idle {1 - share:.4f}); top device time: " + "; ".join(f"{n[:60]} {t:.3f} ms" for n, t in top))
        enc3, lg3, c3 = prefill(new_cache())
        tok3 = torch.argmax(lg3[:, -1], dim=-1)
        dshare, dwin_ms, dby_name = device_busy(lambda: decode(enc3, c3, tok3, 1))
        del c3, lg3
        out["decode_busy"], out["decode_window_ms"] = dshare, dwin_ms
        dtop = sorted(dby_name.items(), key=lambda kv: -kv[1])[:5]
        print(f"{gpu}: {label} one decode step under torch.profiler: window {dwin_ms:.3f} ms, device busy "
              f"{dshare:.4f} (idle {1 - dshare:.4f}); top device time: "
              + "; ".join(f"{n[:60]} {t:.3f} ms" for n, t in dtop))
        seen = encdec_path_inputs(params, cfg, frames, prompts, new_cache())
        del enc, enc2, enc3, cache
    out["k4"] = {}
    for key, what, count in (("enc", "encoder", cfg.n_encoder_layers),
                             ("cross_prompt", "cross-attention over the prompt", cfg.n_layers),
                             ("cross_decode", "cross-attention at a decode step", cfg.n_layers)):
        (q, k, v), kw = seen[key]
        out["k4"][key] = k4_numbers(q, k, v, kw, f"{gpu}: {label} {what}:", f"{count} per "
                                    + ("decode step" if key == "cross_decode" else "prefill"), count,
                                    host_ahead=True)
    del params, seen
    torch.cuda.empty_cache()
    return out


def encdec_e2e_vs_plain(gpu):
    """Phase 21 (d): Whisper-medium at full width and depth in float32,
    WHISPER_E2E: encode, the prompt into the cache and greedy decode steps
    with K4 (launched as ``encdec_launches`` says), then with the plain
    version swapped in (no launch): prefill logits within E2E_TOL of max
    |logit|, tokens equal."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.models import encdec
    from repro_torch.train.step import make_encdec_decode_step

    dev = torch.device("cuda")
    saved = k4.launches
    cfg = get_config("whisper-medium").with_(dtype="float32")
    b, plen, gen = WHISPER_E2E["batch"], WHISPER_E2E["prompt_len"], WHISPER_E2E["gen"]
    g = torch.Generator(device=dev).manual_seed(2)
    params = encdec.init_encdec_params(cfg, generator=g, device=dev)
    frames = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=g, device=dev)
    prompts = torch.randint(0, cfg.vocab, (b, plen), generator=g, device=dev)
    want = encdec_launches(cfg)
    step = make_encdec_decode_step(cfg)
    runs = {}
    with torch.inference_mode():
        for name, swap in (("kernels", contextlib.nullcontext()), ("plain", swapped_ops.plain())):
            before = k4.launches
            with swap:
                enc = encdec.encode(params, cfg, frames)
                logits, cache = encdec.decode(params, cfg, prompts, enc, encdec.init_decoder_cache(cfg, b, plen + gen,
                                                                                                 device=dev))
                tok = torch.argmax(logits[:, -1], dim=-1)
                toks = [tok]
                for _ in range(gen - 1):
                    tok, cache = step(params, cache, enc, tok[:, None])
                    toks.append(tok)
            torch.cuda.synchronize()
            used = k4.launches - before
            expect = want["prefill"] + (gen - 1) * want["decode_step"] if name == "kernels" else 0
            check(used == expect, f"end to end whisper-medium, {name}: K4 launched {used}, want {expect}")
            runs[name] = (logits.float(), torch.stack(toks, dim=1))
            del logits, cache, enc
    (lk, tk), (lp, tp) = runs["kernels"], runs["plain"]
    rel = float((lk - lp).abs().max() / lp.abs().max())
    check(bool(torch.isfinite(lk).all()), "end to end whisper-medium: non-finite logits")
    check(rel <= E2E_TOL, f"end to end whisper-medium: kernels vs plain logits off by {rel} (limit {E2E_TOL})")
    check(torch.equal(tk, tp), f"end to end whisper-medium: tokens differ {tk.tolist()} vs {tp.tolist()}")
    print(f"{gpu}: whisper-medium float32 ({cfg.n_encoder_layers} + {cfg.n_layers} layers), {b} x "
          f"{cfg.encoder_seq} frames, prompts of {plen} + {gen} tokens: kernels (K4 launches "
          f"{want['prefill'] + (gen - 1) * want['decode_step']}) vs plain versions end to end, logits max |diff| "
          f"{rel:.3e} of max |logit| (limit {E2E_TOL}), tokens equal {tk[0].tolist()}")
    del params, runs, lk, lp
    torch.cuda.empty_cache()
    k4.launches = saved
    return rel


def encdec_smoke_card_vs_host(gpu):
    """Phase 21 (e): the Whisper SMOKE config in float32 from one set of
    parameters on the host (plain versions) and on the card (K4): encode, a
    prompt into the cache and greedy decode steps (logits within 1e-4 of
    max |logit|, tokens equal); then the loss and every gradient and one
    ``make_encdec_train_step`` on random frames, tokens and targets, within
    phase 20's card-vs-host tolerances.  (Not on the example's synth_batch:
    its tokens are one constant a sequence, so every decoder position holds
    the same values, the self-attention's output does not depend on its
    scores, and its wq and wk get a gradient of zero up to rounding, about
    1e-8 of the others', which no two devices round alike.)"""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.models import encdec
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.step import make_encdec_decode_step, make_encdec_train_step

    saved = k4.launches
    small = get_config("whisper-medium", smoke=True).with_(dtype="float32")
    b, plen, gen = WHISPER_SMOKE["batch"], WHISPER_SMOKE["prompt_len"], WHISPER_SMOKE["gen"]
    host = encdec.init_encdec_params(small, generator=torch.Generator().manual_seed(0), device="cpu")
    card = encdec.EncDec(small, None, torch.device("cuda"))
    card.load_state_dict(host.state_dict())
    g = torch.Generator().manual_seed(1)
    frames = torch.randn((b, small.encoder_seq, small.d_model), generator=g)
    toks = torch.randint(0, small.vocab, (b, plen), generator=g)
    seq = torch.randint(0, small.vocab, (b, TRAIN_SMOKE["seq"] + 1), generator=g)
    want = encdec_launches(small)
    step = make_encdec_decode_step(small)
    serve, train = [], []
    for model, d in ((host, "cpu"), (card, "cuda")):
        before = k4.launches
        with torch.inference_mode():
            enc = encdec.encode(model, small, frames.to(d))
            logits, cache = encdec.decode(model, small, toks.to(d), enc, encdec.init_decoder_cache(small, b, plen + gen,
                                                                                                 device=d))
            tok = torch.argmax(logits[:, -1], dim=-1)
            out = [tok]
            for _ in range(gen - 1):
                tok, cache = step(model, cache, enc, tok[:, None])
                out.append(tok)
        torch.cuda.synchronize()
        serve.append((logits.float().cpu(), torch.stack(out, 1).cpu(), k4.launches - before))
        batch = {"frames": frames.to(d), "tokens": seq[:, :-1].to(d), "targets": seq[:, 1:].to(d)}
        for p in model.parameters():
            p.requires_grad_(True)
        loss = encdec.encdec_loss_fn(model, small, batch["frames"], batch["tokens"], batch["targets"])
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        missing = [n for n, gr in grads.items() if gr is None]
        check(not missing, f"whisper smoke on {d}: no gradient for {missing}")
        grads = {n: gr.detach().cpu() for n, gr in grads.items()}
        for p in model.parameters():
            p.grad = None
            p.requires_grad_(False)
        before = k4.launches
        model, state, m = make_encdec_train_step(small, AdamWConfig(**TRAIN_SMOKE_OPT))(model, adamw_init(model), batch)
        train.append((float(loss.detach()), grads, float(m["loss"]),
                      {n: p.detach().cpu() for n, p in model.named_parameters()}, k4.launches - before))
    torch.cuda.synchronize()
    (lh, th, _), (lc, tc, used) = serve
    serve_want = want["prefill"] + (gen - 1) * want["decode_step"]
    check(used == serve_want, f"whisper smoke: K4 launched {used} on the card's serving path, want {serve_want}")
    rel_s = float((lh - lc).abs().max() / lh.abs().max())
    check(rel_s <= 1e-4 and torch.equal(th, tc), f"whisper smoke: card vs host logits {rel_s}, tokens "
                                                 f"{th.tolist()} vs {tc.tolist()}")
    (llh, gh, mh, ph, _), (llc, gc, mc, pc, tused) = train
    check(tused == want["train_step"], f"whisper smoke: K4 launched {tused} in the card's step, want "
                                       f"{want['train_step']}")
    loss_rel = max(abs(llc - llh) / abs(llh), abs(mc - mh) / abs(mh))
    check(loss_rel <= TRAIN_LOSS_TOL, f"whisper smoke: card loss {llc} vs host {llh}")
    gerr = _leaf_rel(gc, gh)
    worst = max(gerr, key=gerr.get)
    check(gerr[worst] <= TRAIN_CARD_HOST_TOL, f"whisper smoke: gradient of {worst} off by {gerr[worst]}")
    off, total, pmax = updated_params_check(pc, ph, "whisper smoke")
    print(f"{gpu}: whisper-medium SMOKE float32, card (K4) vs host (plain versions): serving (K4 launches {used}) "
          f"logits max |diff| {rel_s:.3e} of max |logit| (limit 1e-4), tokens equal {tc[0].tolist()}; train step (K4 "
          f"launches {tused}) loss {llc:.6f} vs {llh:.6f} ({loss_rel:.3e} relative, limit {TRAIN_LOSS_TOL}), all "
          f"{len(gc)} parameters have a gradient, worst leaf {worst} {gerr[worst]:.3e} of max |host grad| (limit "
          f"{TRAIN_CARD_HOST_TOL}); updated parameters: {off} of {total} entries more than {TRAIN_PARAM_TOL} of their "
          f"leaf's max |p| apart, max |diff| {pmax:.3e}")
    k4.launches = saved
    return {"serve_rel": rel_s, "grad_rel": gerr[worst]}


def encdec_train_full(gpu):
    """Phase 21 (f): Whisper-medium trained at full width and depth, bf16
    compute on float32 masters, remat as published: examples/whisper_train.py's
    synth_batch at WHISPER_TRAIN, AdamW as that example sets it with the run's
    step count as its total, ``make_encdec_train_step``, K4's count set to 0
    just before each step and read just after."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.examples.whisper_train import synth_batch
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.models import encdec
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.step import make_encdec_train_step

    dev = torch.device("cuda")
    cfg = get_config("whisper-medium")
    bsz, seq, steps = WHISPER_TRAIN["batch"], WHISPER_TRAIN["seq"], WHISPER_TRAIN["steps"]
    torch.cuda.reset_peak_memory_stats()
    params = encdec.init_encdec_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    state = adamw_init(params)
    opt = AdamWConfig(lr=WHISPER_TRAIN["lr"], warmup_steps=WHISPER_TRAIN["warmup"], total_steps=steps)
    step = make_encdec_train_step(cfg, opt)
    n_params = sum(p.numel() for p in params.parameters())
    n_enc = sum(p.numel() for p in params.enc_layers.parameters()) + params.enc_norm.scale.numel()
    torch.cuda.synchronize()
    setup_gb = torch.cuda.max_memory_allocated() / 1e9
    want = encdec_launches(cfg)["train_step"]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    losses, ms = [], []
    for s in range(steps):
        batch = synth_batch(cfg, s, batch=bsz, seq=seq, device=dev)
        torch.cuda.synchronize()
        k4.launches = 0
        ev[0].record()
        params, state, m = step(params, state, batch)
        ev[1].record()
        ev[1].synchronize()
        check(k4.launches == want, f"train whisper-medium step {s}: K4 launched {k4.launches}, want {want}")
        losses.append(float(m["loss"]))
        ms.append(ev[0].elapsed_time(ev[1]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(x) for x in losses), f"train whisper-medium: losses {losses}")
    check(losses[-1] < losses[0], f"train whisper-medium: loss did not fall, {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in params.parameters()), "train whisper-medium: non-finite parameters")
    check(peak_gb <= WHISPER_TRAIN_PEAK_GB, f"train whisper-medium: peak {peak_gb:.2f} GB over {WHISPER_TRAIN_PEAK_GB}")
    tokens, frames = bsz * seq, bsz * cfg.encoder_seq
    best = min(ms[1:])
    flops = 6 * (n_enc * frames + (n_params - n_enc) * tokens)
    out = dict(n_params=n_params, n_enc=n_enc, losses=losses, ms=ms, peak_gb=peak_gb, setup_gb=setup_gb,
               launches=want, tok_per_s=tokens / (best * 1e-3), frames_per_s=frames / (best * 1e-3),
               mfu=flops / (best * 1e-3) / BF16_OPS_PER_S, flops=flops)
    print(f"{gpu}: whisper-medium trained at full width and depth: {cfg.n_encoder_layers} + {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab}, {n_params} parameters ({n_enc} in the encoder; float32 masters, "
          f"{cfg.dtype} compute, remat {cfg.remat}); {steps} make_encdec_train_step steps of synth_batch {bsz} x "
          f"{cfg.encoder_seq} frames -> {seq} tokens, AdamW lr {opt.lr} warmup {opt.warmup_steps} total {steps}; K4 "
          f"launches a step {want} (checked at every step); losses " + ", ".join(f"{x:.4f}" for x in losses))
    print(f"{gpu}: whisper-medium train step ms (CUDA events, one step each): " + ", ".join(f"{x:.2f}" for x in ms)
          + f"; warm best {best:.2f} ms, mean {sum(ms[1:]) / len(ms[1:]):.2f} ms = {out['tok_per_s']:.0f} decoder "
          f"tokens/s ({out['frames_per_s']:.0f} frames/s) at best; model FLOPs 6 x ({n_enc} encoder parameters x "
          f"{frames} frames + {n_params - n_enc} decoder and head parameters x {tokens} tokens) = {flops:.4e} a step "
          f"(attention's s^2 terms, the cross K/V's 1500-frame products and remat's recomputation not counted "
          f"apart), {out['mfu']:.4f} of the {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16 peak; peak device memory "
          f"{peak_gb:.2f} GB (torch.cuda.max_memory_allocated; {setup_gb:.2f} GB after setup; limit "
          f"{WHISPER_TRAIN_PEAK_GB})")
    n_dev = {}
    share, win_ms, by_name = device_busy(lambda: step(params, state, synth_batch(cfg, steps, batch=bsz, seq=seq,
                                                                                 device=dev)), n_dev)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out.update(busy=share, busy_window_ms=win_ms, device_ops=sum(n_dev.values()))
    print(f"{gpu}: whisper-medium one train step under torch.profiler (its batch made on the host inside the "
          f"window): window {win_ms:.3f} ms, device busy {share:.4f} (idle {1 - share:.4f}), {out['device_ops']} "
          f"device kernels and copies; top device time: " + "; ".join(f"{n[:60]} {t:.3f} ms ({n_dev[n]}x)"
                                                                     for n, t in top))
    del params, state
    torch.cuda.empty_cache()
    return out


def encdec_runner_checks(gpu):
    """Phase 21 (g): under ``torch.use_deterministic_algorithms(True)``, the
    Whisper SMOKE config on the card: one step alone, then ``TrainRunner``
    clean and with injected failures on examples/whisper_train.py's
    synth_batch, the replayed run equal to the clean one bit for bit; then
    that example's ``main`` on the card (10 steps, checkpoints every 5, the
    loss falling)."""
    import io
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.examples import whisper_train
    from repro_torch.models import encdec
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import FaultInjector, RunnerConfig, TrainRunner
    from repro_torch.train.step import make_encdec_train_step

    dev = torch.device("cuda")
    cfg = get_config("whisper-medium", smoke=True)
    step = make_encdec_train_step(cfg, AdamWConfig(**TRAIN_SMOKE_OPT))

    def fresh():
        model = encdec.init_encdec_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        return model, adamw_init(model)

    def batch(s):
        return whisper_train.synth_batch(cfg, s, device=dev)

    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            step(*fresh(), batch(0))  # a step alone: any non-deterministic op raises here
            runs = {}
            for name, hook in (("clean", None), ("faulty", FaultInjector(fail_at=dict(WHISPER_RUNNER_FAILS)))):
                runner = TrainRunner(RunnerConfig(ckpt_dir=os.path.join(tmp, name), ckpt_every=3), step, batch,
                                     fingerprint="whisper-smoke", fault_hook=hook)
                params, state = runner.run(*fresh(), TRAIN_RUNNER_STEPS)
                runs[name] = (params, state, {h.step: h.metrics["loss"] for h in runner.history}, runner.restores)
            (pc, sc, lc, _), (pf, sf, lf, restores) = runs["clean"], runs["faulty"]
            check(restores == len(WHISPER_RUNNER_FAILS), f"runner whisper: {restores} restores")
            diff = max(float((a - b).abs().max()) for a, b in zip(pc.parameters(), pf.parameters()))
            mdiff = max(float((sc[k][n] - sf[k][n]).abs().max()) for k in ("m", "v") for n in sc["m"])
            check(diff == 0.0 and mdiff == 0.0 and lc == lf and int(sc["step"]) == int(sf["step"]),
                  f"runner whisper: replayed run differs from the clean one: parameters {diff}, moments {mdiff}, "
                  f"losses {lc} vs {lf}")
            print(f"{gpu}: whisper-medium SMOKE ({cfg.dtype}) TrainRunner, {TRAIN_RUNNER_STEPS} steps, checkpoints "
                  f"every 3, failures injected at steps {sorted(WHISPER_RUNNER_FAILS)}: {restores} restores and "
                  f"replays; parameters, AdamW moments and every step's loss equal to the clean run bit for bit "
                  f"(torch.use_deterministic_algorithms); losses " + ", ".join(f"{lc[s]:.4f}" for s in sorted(lc)))
            ck = os.path.join(tmp, "example")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                check(whisper_train.main(["--steps", "10", "--ckpt", ck, "--device", "cuda"]) == 0,
                      "whisper_train: non-zero")
            res = json.loads(buf.getvalue().strip().splitlines()[-1])
            check(res["last"] < res["first"], f"whisper_train on the card did not learn: {res}")
            with np.load(os.path.join(ck, "step_00000010", "arrays.npz")) as npz:
                keys = set(npz.files)
                wk = npz["params/dec_layers/cross/wk"].shape
            check({"params/enc_layers/attn/wq", "opt/m/dec_layers/cross/wq", "opt/step"} <= keys
                  and wk == (cfg.n_layers, cfg.d_model, cfg.d_model), f"whisper_train checkpoint keys, wk {wk}")
            print(f"{gpu}: python -m repro_torch.examples.whisper_train --steps 10 --device cuda: {res}; checkpoint "
                  f"in the reference's layout ({len(keys)} arrays, params/dec_layers/cross/wk {wk})")
    finally:
        torch.use_deterministic_algorithms(False)
    return {"restores": restores, "example": res}


def encdec_phase(gpu):
    """Phase 21: Whisper-medium (enc-dec) served and trained on the card
    (K4 at its shapes against the plain version is part of phase 9,
    ``k4_card_checks``).  Returns the numbers of the summary and the kernels
    line."""
    import torch

    t0 = time.perf_counter()
    grads = encdec_k4_grad_checks(gpu)
    serve = encdec_serve(gpu)
    e2e = encdec_e2e_vs_plain(gpu)
    smoke = encdec_smoke_card_vs_host(gpu)
    full = encdec_train_full(gpu)
    runner = encdec_runner_checks(gpu)
    print(f"{gpu}: phase 21 (enc-dec; K4 at its shapes against the plain version ran in phase 9) took "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    return {"grads": grads, "serve": serve, "e2e": e2e, "smoke": smoke, "full": full, "runner": runner}


def _full(t):
    """A DTensor's whole value (a plain tensor as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def mesh_dryrun_start():
    """Phase 22 (d): the two production-mesh dry-run cells, each in a
    process of its own (a fake process group of 256 or 512 ranks cannot
    share this process with the card's group), kept off the card."""
    import tempfile

    out_dir = Path(tempfile.mkdtemp(prefix="dryrun_"))
    src = str(Path(__file__).resolve().parent / "src")
    env = dict(os.environ, PYTHONPATH=src, CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape, multi in MESH_DRYRUN:
        out = out_dir / f"{arch}_{shape}.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
               "--multi-pod", "on" if multi else "off", "--out", str(out)]
        procs.append((arch, shape, multi, out, time.perf_counter(),
                      subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


def mesh_dryrun_finish(gpu, procs):
    """Phase 22 (d): wait for the dry-run processes and print each cell's
    record: bytes a device, FLOPs, collective bytes by op, the bottleneck and
    the roofline share against one H100's data sheet (a static count, not a
    measurement)."""
    recs = []
    try:
        for arch, shape, multi, path, t0, proc in procs:
            log, _ = proc.communicate(timeout=600)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0, f"dry run {arch} x {shape} failed:\n{log[-3000:]}")
            rec = json.loads(path.read_text())[0]
            check(rec["status"] == "ok", f"dry run {arch} x {shape}: {rec}")
            roof, mem = rec["roofline"], rec["memory"]
            check(roof["flops"] > 0 and roof["collective_bytes"] > 0, f"dry run {arch} x {shape}: nothing counted")
            rec["wall_s"] = wall
            recs.append(rec)
            print(f"{gpu}: dry run {arch} x {shape} on {rec['chips']} fake ranks ({'two pods' if multi else 'one pod'}; "
                  f"one rank's step under FakeTensorMode on the host, traced in {rec['trace_s']} s, {wall:.1f} s of "
                  f"process): bytes a device {(mem['argument_bytes'] + mem['temp_bytes']) / 1e9:.2f} GB (arguments "
                  f"{mem['argument_bytes'] / 1e9:.3f}, live op outputs at the peak {mem['temp_bytes'] / 1e9:.2f}, "
                  f"unfused), FLOPs {roof['flops']:.4e} over all chips (model {roof['model_flops']:.4e}, useful "
                  f"{roof['useful_flop_fraction']:.4f}), HBM bytes {roof['bytes']:.4e}, collective bytes "
                  + ", ".join(f"{k} {v:.4e} ({rec['collectives']['count'][k]}x)"
                              for k, v in sorted(rec["collectives"]["bytes"].items()))
                  + f"; terms compute {roof['compute_s']:.4f} s, memory {roof['memory_s']:.4f} s, collective "
                  f"{roof['collective_s']:.4f} s: bottleneck {roof['bottleneck']}, roofline_fraction "
                  f"{roof['roofline_fraction']:.4f} (H100 SXM data sheet: 989 TFLOP/s bf16, 3.35 TB/s, NVLink "
                  f"450 GB/s a direction; static count, not measured)")
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return recs


def mesh_train(gpu, plain_ms):
    """Phase 22 (a): Zamba2-1.2B at full width and depth trained by
    ``make_compressed_train_step`` on a (pod 1, data 1, model 1) mesh, the
    parameters placed by ``param_specs``: MESH_TRAIN_STEPS steps of phase
    20's batches, K4's and K5's counts set to 0 just before each step and
    read just after, the loss falling, and every error-feedback residual
    within half its tensor's int8 scale."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distrib.sharding import distribute, param_specs
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim import compress
    from repro_torch.train.step import make_compressed_train_step

    dev = torch.device("cuda")
    counts = _kernel_counts()
    cfg = get_config(TRAIN["arch"])
    bsz, seq, steps = TRAIN["batch"], TRAIN["seq"], MESH_TRAIN_STEPS
    torch.cuda.reset_peak_memory_stats()
    mesh = make_device_mesh((1, 1, 1), ("pod", "data", "model"), "cuda")
    params = lm.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    state, ef = adamw_init(params), compress.init_error_feedback(params)
    distribute(params, param_specs(cfg, params, mesh), mesh)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=bsz), device=dev)
    seen = []  # (scale, max |residual|) of every tensor the ring reduced, device tensors
    ring = compress.compressed_psum

    def recording(x, group=None, generator=None):
        mean, err = ring(x, group, generator)
        seen.append((compress.quantize_int8(x)[1], err.abs().max()))
        return mean, err

    compress.compressed_psum = recording  # the step looks it up when it is made
    try:
        step = make_compressed_train_step(cfg, AdamWConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"],
                                                            total_steps=steps), mesh)
    finally:
        compress.compressed_psum = ring
    want = train_launches(cfg)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    losses, ms, largest = [], [], 0.0
    for s in range(steps):
        batch = data.batch(s)
        seen.clear()
        torch.cuda.synchronize()
        for k in counts.values():
            k.launches = 0
        ev[0].record()
        params, state, ef, m = step(params, state, ef, batch)
        ev[1].record()
        ev[1].synchronize()
        used = {n: k.launches for n, k in counts.items()}
        check(used == want, f"mesh train {cfg.name} step {s}: K3/K4/K5 launched {used}, want {want}")
        losses.append(float(m["loss"]))
        ms.append(ev[0].elapsed_time(ev[1]))
        worst = max(float(_full(e)) / float(_full(sc)) for sc, e in seen)
        # |x / scale - round(x / scale)| <= 1/2, less the float32 rounding of
        # the quotient (|x / scale| <= 127: half an ulp, 2^-18, at most)
        check(worst <= 0.5 + 2.0**-17, f"mesh train step {s}: a residual is {worst:.7f} of its int8 scale (> 1/2)")
        largest = max(largest, worst)
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], f"mesh train: losses {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    best = min(ms[1:])
    out = dict(losses=losses, ms=ms, best_ms=best, launches=want, peak_gb=peak_gb, n_tensors=len(seen),
               largest_residual=largest)
    print(f"{gpu}: phase 22 (a) {cfg.name} at full width and depth (remat {cfg.remat}) trained {steps} steps by "
          f"make_compressed_train_step on a (pod 1, data 1, model 1) NCCL mesh, parameters placed by param_specs as "
          f"DTensors, SyntheticLM {bsz} x {seq}: losses " + ", ".join(f"{x:.4f}" for x in losses)
          + f"; launches a step K3 {want['k3']}, K4 {want['k4']}, K5 {want['k5']} (checked at each); "
          f"{len(seen)} tensors through the int8 ring a step, every residual within half its scale (the largest "
          f"{largest:.7f} of it); step ms "
          "(CUDA events) " + ", ".join(f"{x:.2f}" for x in ms) + f"; warm best {best:.2f} ms against phase 20's "
          f"make_train_step {plain_ms:.2f} ms ({best / plain_ms:.3f}x: the mesh machinery, DTensor dispatch and the "
          f"int8 round trip on one card); peak {peak_gb:.2f} GB")
    del params, state, ef, step, seen, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_moe(gpu):
    """Phase 22 (b): Grok-1 at full width cut to MOE_DEPTH layers, served on
    the local path and then, from the same weights, on a (data 1, model 1)
    mesh through moe_fwd's EP path and gqa_fwd's mesh branch (K4 inside
    compat.shard_map): prefill logits and decode tokens against the local
    path's; then the sequence-sharded decode attention called at Grok-1's
    decode shape on the one-rank mesh, held against _sdpa on the same cache
    in float32."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.distrib import compat
    from repro_torch.distrib.compat import P
    from repro_torch.distrib.context import use_mesh
    from repro_torch.distrib.sharding import cache_specs, data_specs, distribute, moe_ep_axes, param_specs
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import layers, lm
    from repro_torch.train.step import _greedy, make_decode_step

    arch = "grok-1-314b"
    cfg = get_config(arch).with_(n_layers=MOE_DEPTH[arch])
    bsz, prompt_len, gen = MESH_MOE["batch"], MESH_MOE["prompt_len"], MESH_MOE["gen"]
    dev = torch.device("cuda")
    k4 = _kernel_counts()["k4"]
    mesh = make_device_mesh((1, 1), ("data", "model"), "cuda")
    check(moe_ep_axes(cfg, mesh) == ("data", "model"), f"{arch}: EP axes {moe_ep_axes(cfg, mesh)}")
    params, cache, prompts = serve.setup(cfg, bsz, prompt_len, gen, device=dev, seed=0)
    decode_step = make_decode_step(cfg)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def run(c, toks, warm_cache):
        lm.forward(params, cfg, toks, cache=warm_cache)  # warm-up, into a cache of its own
        torch.cuda.synchronize()
        k4.launches = 0
        ev[0].record()
        logits, c = lm.forward(params, cfg, toks, cache=c)
        tok = _greedy(logits)
        ev[1].record()
        ev[1].synchronize()
        prefill_ms, in_prefill = ev[0].elapsed_time(ev[1]), k4.launches
        out = [tok]
        ev[0].record()
        for _ in range(gen):
            t = _full(tok)[:, None]
            tok, c = decode_step(params, c, t if not hasattr(toks, "placements")
                                 else distribute(t, data_specs(mesh, bsz), mesh))
            out.append(tok)
        ev[1].record()
        ev[1].synchronize()
        return logits, torch.stack([_full(t) for t in out], 1), prefill_ms, ev[0].elapsed_time(ev[1]) / gen, in_prefill

    with torch.inference_mode():
        local_logits, local_toks, l_ms, l_dms, l_k4 = run(cache, prompts,
                                                          lm.init_cache(cfg, bsz, prompt_len + gen, device=dev))
        local_logits = local_logits.float()
        del cache
        distribute(params, param_specs(cfg, params, mesh), mesh)
        def placed_cache():
            c = lm.init_cache(cfg, bsz, prompt_len + gen, device=dev)
            return distribute(c, cache_specs(cfg, c, mesh), mesh)

        mcache = placed_cache()
        with use_mesh(mesh), compat.auto_region():
            mesh_logits, mesh_toks, m_ms, m_dms, m_k4 = run(mcache, distribute(prompts, data_specs(mesh, bsz), mesh),
                                                            placed_cache())
        mesh_logits = _full(mesh_logits).float()
        diff = float((mesh_logits - local_logits).abs().max() / local_logits.abs().max())
        equal = bool(torch.equal(mesh_logits, local_logits))
        check(equal or diff <= MESH_MOE_TOL, f"{arch} mesh vs local: logits {diff:.3e} of max |logit|")
        check(torch.equal(mesh_toks, local_toks), f"{arch} mesh vs local: tokens differ")
        check(m_k4 == l_k4 == cfg.n_layers, f"{arch}: K4 launched {m_k4} (mesh) / {l_k4} (local), want {cfg.n_layers}")
        del local_logits, mesh_logits
        # the sequence-sharded decode attention at Grok-1's decode shape
        nh, nkv, hd = cfg.attn_dims()
        kv_len = prompt_len + gen
        g = torch.Generator(device=dev).manual_seed(3)
        q = torch.randn((bsz, 1, nh, hd), generator=g, device=dev)
        k, v = (torch.randn((bsz, kv_len, nkv, hd), generator=g, device=dev) for _ in range(2))
        with use_mesh(mesh), compat.auto_region():
            pl = compat.placements(P(("data",), "model", None, None), mesh)
            got = layers._decode_attn_seq_sharded(
                distribute_tensor(q, mesh, compat.placements(P(("data",), None, None, None), mesh)),
                distribute_tensor(k, mesh, pl), distribute_tensor(v, mesh, pl), kv_len, mesh)
        want = layers._sdpa(q, k, v, True, q_offset=kv_len - 1, kv_len=kv_len)
        seq_err = float((_full(got) - want).abs().max() / want.abs().max())
        check(seq_err <= MESH_SEQ_DECODE_TOL, f"{arch}: sequence-sharded decode {seq_err:.3e} from _sdpa")
    out = dict(diff=diff, equal=equal, prefill_ms=m_ms, local_prefill_ms=l_ms, decode_ms=m_dms,
               local_decode_ms=l_dms, k4_launches=m_k4, seq_err=seq_err)
    print(f"{gpu}: phase 22 (b) {arch} at full width, {cfg.n_layers} layers, {bsz} x {prompt_len} prefill + {gen} "
          f"decode steps on a (data 1, model 1) NCCL mesh through moe_fwd's EP path (all_to_all over ('data', "
          f"'model')) and gqa_fwd's mesh branch: logits {'equal to' if equal else f'{diff:.3e} of max |logit| from'} "
          f"the local path's, tokens equal; K4 {m_k4} launches in the prefill (inside compat.shard_map); prefill "
          f"{m_ms:.2f} ms against {l_ms:.2f} ms local (CUDA events, after a warm-up prefill), a decode step "
          f"{m_dms:.2f} ms against {l_dms:.2f} ms (the mean of {gen}, the first included); _decode_attn_seq_sharded at ({bsz}, 1, {nh} / {nkv}, {hd}) over {kv_len} keys in "
          f"float32 {seq_err:.3e} of max |out| from _sdpa (limit {MESH_SEQ_DECODE_TOL})")
    del params, mcache, got, want, q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_pipeline(gpu):
    """Phase 22 (c): Qwen2-VL-2B's 28 layers at full width through the GPipe
    schedule (make_pipeline_fn) on a pipe-1 mesh, MESH_PIPE microbatches,
    the stage's parameters the layers' stacked: outputs against the plain
    layer loop on the same inputs, then a backward through the schedule and
    its gradients against the loop's."""
    import torch
    from torch.func import functional_call

    from repro_torch.configs import get_config
    from repro_torch.distrib.pipeline import make_pipeline_fn, stack_stages
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import lm

    cfg = get_config(MESH_PIPE["arch"])
    n_micro, mb, seq = MESH_PIPE["n_micro"], MESH_PIPE["mb"], MESH_PIPE["seq"]
    dev = torch.device("cuda")
    k4 = _kernel_counts()["k4"]
    model = lm.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    template = model.layers[0]
    names = [n for n, _ in template.named_parameters()]
    stacked = {n: torch.stack([dict(layer.named_parameters())[n].detach() for layer in model.layers]) for n in names}
    stages, _ = stack_stages(stacked, [1.0] * cfg.n_layers, 1)
    stages = {n: t.detach().requires_grad_(True) for n, t in stages.items()}
    positions = torch.arange(seq, device=dev)[None].expand(mb, seq)
    g = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (n_micro, mb, seq), generator=g, device=dev)
    xs = model.embed.detach()[toks].to(getattr(torch, cfg.dtype))

    def stage_fn(sp, x):
        for i in range(next(iter(sp.values())).shape[0]):
            x = functional_call(template, {n: sp[n][i] for n in names}, (x, positions))[0]
        return x

    mesh = make_device_mesh((1,), ("pipe",), "cuda")
    fn = make_pipeline_fn(stage_fn, mesh, n_micro=n_micro)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    k4.launches = 0
    ev[0].record()
    out = fn(stages, xs).to_local()
    ev[1].record()
    (out.float() ** 2).sum().backward()
    ev[2].record()
    ev[2].synchronize()
    pipe_launches = k4.launches
    fwd_ms, bwd_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    check(pipe_launches == n_micro * cfg.n_layers,
          f"pipeline: K4 launched {pipe_launches}, want {n_micro * cfg.n_layers} (a layer a microbatch; the backward "
          "is autograd of the plain version)")
    grads = {n: t.grad[0] for n, t in stages.items()}
    with torch.no_grad():
        ev[0].record()
        fn(stages, xs)
        ev[1].record()
        ev[1].synchronize()
    warm_fwd_ms = ev[0].elapsed_time(ev[1])
    # the plain loop over the layers, from the same inputs
    for p in model.parameters():
        p.requires_grad_(True)
    with torch.no_grad():
        ev[0].record()
        for m in range(n_micro):
            x = xs[m]
            for layer in model.layers:
                x = layer(x, positions)[0]
        ev[1].record()
        ev[1].synchronize()
    warm_loop_ms = ev[0].elapsed_time(ev[1])
    ev[0].record()
    ys = []
    for m in range(n_micro):
        x = xs[m]
        for layer in model.layers:
            x = layer(x, positions)[0]
        ys.append(x)
    ref = torch.stack(ys)
    ev[1].record()
    (ref.float() ** 2).sum().backward()
    ev[2].record()
    ev[2].synchronize()
    loop_fwd_ms, loop_bwd_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    out_err = float((out.detach().float() - ref.detach().float()).abs().max() / ref.detach().float().abs().max())
    grad_err = max(float((grads[n] - torch.stack([dict(l.named_parameters())[n].grad for l in model.layers])).abs().max()
                         / torch.stack([dict(l.named_parameters())[n].grad for l in model.layers]).abs().max())
                   for n in names)
    check(out_err == 0.0 or out_err <= 1e-6, f"pipeline: outputs {out_err:.3e} from the layer loop's")
    check(grad_err <= 1e-5, f"pipeline: gradients {grad_err:.3e} from the layer loop's")
    print(f"{gpu}: phase 22 (c) {cfg.name} at full width and depth ({cfg.n_layers} layers, grouped K4) through "
          f"make_pipeline_fn on a pipe-1 NCCL mesh, {n_micro} microbatches of {mb} x {seq}: outputs "
          f"{'equal to' if out_err == 0 else f'{out_err:.3e} of max from'} the layer loop's, gradients of sum(out^2) "
          f"over the stacked stage {grad_err:.3e} of max from the loop's; K4 {pipe_launches} launches (a layer a "
          f"microbatch; its backward is autograd of the plain version); schedule forward {fwd_ms:.2f} ms (first "
          f"run), backward {bwd_ms:.2f} ms against the loop's {loop_fwd_ms:.2f} / {loop_bwd_ms:.2f} ms; forward again "
          f"without gradients {warm_fwd_ms:.2f} ms against the loop's {warm_loop_ms:.2f} ms (CUDA events; bubble "
          f"(P-1)/(M+P-1) = 0 at one stage)")
    res = dict(out_err=out_err, grad_err=grad_err, k4_launches=pipe_launches, fwd_ms=fwd_ms, bwd_ms=bwd_ms,
               loop_fwd_ms=loop_fwd_ms, loop_bwd_ms=loop_bwd_ms, warm_fwd_ms=warm_fwd_ms, warm_loop_ms=warm_loop_ms)
    del model, stages, grads, stacked, out, ref, ys
    gc.collect()
    torch.cuda.empty_cache()
    return res


def mesh_phase(gpu, plain_train_ms):
    """Phase 22: distrib and launch on one card (the module docstring).  The
    dry-run processes run on the host while (a) to (c) run on the card."""
    import tempfile

    import torch
    import torch.distributed as dist

    t0 = time.perf_counter()
    procs = mesh_dryrun_start()
    try:
        store = dist.FileStore(tempfile.mktemp(prefix="mesh_store_"), 1)
        dist.init_process_group("cpu:gloo,cuda:nccl", store=store, rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        try:
            train = mesh_train(gpu, plain_train_ms)
            moe = mesh_moe(gpu)
            pipe = mesh_pipeline(gpu)
        finally:
            dist.destroy_process_group()
        dry = mesh_dryrun_finish(gpu, procs)
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"{gpu}: phase 22 (distrib and launch) took {time.perf_counter() - t0:.1f} s")
    return {"train": train, "moe": moe, "pipe": pipe, "dry": dry}


def main() -> int:
    # phase 20 holds a replayed training run to a clean one bit for bit under
    # torch.use_deterministic_algorithms, whose cuBLAS calls need a fixed
    # workspace set before the first of them (32 MiB, as the card's default)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))

    import numpy as np

    import repro_torch as T
    from repro_torch.core.cim.profile import ActivationCapture, LayerCapture
    from repro_torch.dse.engine import run_batch, to_allocation
    from repro_torch.kernels import _build
    from repro_torch.kernels.bitplane_profile import (
        bitplane_block_profile as k1,
        bitplane_block_profile_ref as k1_plain,
        bitplane_grouped_cycles as k1g,
    )
    from repro_torch.kernels.fused_alloc_eval import (
        fused_alloc_eval as k2,
        fused_alloc_eval_ref as k2_plain,
    )

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    print(gpu)
    clock_hz = sm_clock_hz()
    print(f"SM clock (clocks.max.sm) {clock_hz / 1e6:.0f} MHz: integer ops "
          f"{INT_OPS_PER_CLK_SM * H100_SMS * clock_hz / 1e12:.2f} T/s, POPC {POPC_PER_CLK_SM * H100_SMS * clock_hz / 1e12:.2f} T/s")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- 1. build, and the kernel against its plain version on edge cases
    t0 = time.perf_counter()
    logs = _build.build("bitplane_profile", "fused_alloc_eval", "zskip_matmul", "flash_attention", "ssd_chunk",
                        "vtime_scan", "service_draw")
    print(f"build: K1, K2, K3, K4, K5, VT and the draw in {time.perf_counter() - t0:.3f} s (wall, seven nvcc "
          f"processes together)")
    for name, log in logs.items():
        print(f"[nvcc {name}]\n{log.strip()}")
    check("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" in logs["service_draw"],
          "service_draw: the kernel keeps a stack frame or spills (its layer table copied to local memory?)")
    # the Hopper kernels of K3, K4 and K5 keep their accumulators in registers
    # (a library built before this run is checked by the log kept beside it)
    for name in ("zskip_matmul", "flash_attention", "ssd_chunk"):
        props = [b for b in logs[name].split("Function properties for ")[1:] if "wgmma_kernel" in b.split()[0]]
        check(props, f"{name}: no ptxas report of its wgmma kernels in the build log")
        for block in props:
            check("0 bytes spill stores, 0 bytes spill loads" in block, f"{name}: a wgmma kernel spills:\n{block}")
        print(f"ptxas: {name}'s wgmma kernels ({len(props)}) spill nothing")
    k2_regs = [(b.split("EEEv")[0].rsplit("ILi", 1)[-1], b.split("Used ", 1)[1].split(" registers")[0],
                b.split(" bytes spill stores")[0].rsplit(" ", 1)[-1])
               for b in logs["fused_alloc_eval"].split("Function properties for ")[1:] if "Used " in b]
    check(k2_regs, "fused_alloc_eval: no ptxas report of its kernels in the build log")
    print("ptxas: K2's registers a thread (bytes spilled), by units a lane (0: from memory): "
          + ", ".join(f"{u}: {r} ({sp})" for u, r, sp in sorted(k2_regs)))
    vt_regs = [(b.split("vtime_scan_kernelILi")[1].split("EEEv")[0].replace("ELb", ", stats "),
                b.split("Used ", 1)[1].split(" registers")[0])
               for b in logs["vtime_scan"].split("Function properties for ")[1:] if "vtime_scan_kernel" in b.split()[0]]
    check(len(vt_regs) == 8, f"vtime_scan: {len(vt_regs)} kernels in the ptxas report, want 8")
    for block in logs["vtime_scan"].split("Function properties for ")[1:]:
        check("0 bytes spill stores, 0 bytes spill loads" in block, f"vtime_scan: a kernel spills:\n{block}")
    print("ptxas: VT's registers a thread by (KMAX, stats), none spilling: "
          + "; ".join(f"{k}: {r}" for k, r in sorted(vt_regs)))
    vs_regs = [(b.split("vtime_stream_kernelILi")[1].split("EEEv")[0], b.split("Used ", 1)[1].split(" registers")[0])
               for b in logs["vtime_scan"].split("Function properties for ")[1:] if "vtime_stream_kernel" in b.split()[0]]
    check(len(vs_regs) == 4, f"vtime_scan: {len(vs_regs)} streaming kernels in the ptxas report, want 4")
    print("ptxas: the streaming entry's registers a thread by KMAX, none spilling: "
          + "; ".join(f"{k}: {r}" for k, r in sorted(vs_regs)))
    max_err = 0
    rng = np.random.default_rng(0)
    for r in (128, 64, 37):
        for rpr in (4, 8, 16):
            for fill in (None, 0, 0xFF):
                q = (rng.integers(0, 256, (5, 300, r), dtype=np.uint8) if fill is None
                     else np.full((5, 300, r), fill, np.uint8))
                qt = torch.from_numpy(q).to(dev)
                got, want = k1(qt, rows_per_read=rpr), k1_plain(qt, rows_per_read=rpr)
                for g, w in zip(got, want):
                    max_err = max(max_err, int((g.long() - w.long()).abs().max()))
    torch.cuda.synchronize()
    check(max_err == 0, f"K1 != plain on edge cases: max err {max_err}")
    print(f"K1 block entry vs plain, r in (128, 64, 37) x rows_per_read in (4, 8, 16) x (random, 0, 0xFF): max |err| 0")
    max_err = max(max_err, k1_edge_checks(dev))
    print(f"K1 grouped entry vs plain on {len(K1_TABLES)} ragged tables (block rows 128, 256, 64; rows 147, 27, "
          f"64, 300, 600, 576; S 1 to 300) x rows_per_read (4, 8, 16) x (random, 0, 0xFF): max |err| 0")
    sass = subprocess.run(["cuobjdump", "-sass", str(_build.library_path("bitplane_profile"))],
                          capture_output=True, text=True, timeout=120)
    ops = {}
    for fn in sass.stdout.split("Function : ")[1:]:
        name = fn.split()[0]
        counts = {}
        for line in fn.splitlines():
            parts = line.split("*/")
            if len(parts) > 1 and parts[1].strip():
                op = parts[1].split()[0].split(".")[0]
                if op.startswith("@"):
                    op = parts[1].split()[1].split(".")[0]
                counts[op] = counts.get(op, 0) + 1
        ops[name] = counts
    check(sass.returncode == 0 and ops, f"cuobjdump -sass of K1 failed: {sass.stderr[:500]}")
    for name, counts in ops.items():
        top = sorted(counts.items(), key=lambda kv: -kv[1])[:14]
        print(f"K1 SASS {name}: {sum(counts.values())} instructions; " + ", ".join(f"{k} {v}" for k, v in top))

    def blocks_of(cap, spec):
        out = []
        for lc, layer in zip(cap.layers, spec.layers):
            s, rows = lc.sampled_q.shape
            nb = layer.n_blocks
            padded = lc.sampled_q.new_zeros((s, nb * layer.array.rows))
            padded[:, :rows] = lc.sampled_q
            out.append(padded.view(s, nb, layer.array.rows).transpose(0, 1).contiguous())
        return out

    def k1_vs_plain(blocks) -> int:
        err = 0
        for b in blocks:
            for g, w in zip(k1(b), k1_plain(b)):
                err = max(err, int((g.long() - w.long()).abs().max()))
        return err

    def to_host(cap):
        return ActivationCapture(cap.network, cap.n_images, cap.sample_patches, cap.seed, tuple(
            LayerCapture(lc.name, lc.rowbits.cpu(), lc.sampled_q.cpu(), lc.n_patches, lc.patches_per_image)
            for lc in cap.layers))

    def same_profile(a, b, what):
        for x, y in zip(a.layers, b.layers, strict=True):
            for f in ("block_density", "mean_cycles", "cycles_sample", "baseline_block_cycles"):
                check(torch.equal(getattr(x, f).cpu(), getattr(y, f).cpu()), f"{what}: {x.name}.{f}")

    def drive(spec, n_images, label):
        """The main path, with K1's counts (its grouped entry and its block
        entry) set to 0 before and read after."""
        L = len(spec.layers)
        m = spec.min_pes()
        k1.launches = k1g.launches = 0
        cap = T.capture_activations(spec, n_images=n_images, batch_images=8, sample_patches=256, device=dev)
        prof = T.derive_profile(cap, spec)  # engine None on the card: the kernel
        after_derive = k1g.launches + k1.launches
        pes2 = m * 2
        sims = {p: T.simulate(spec, prof, T.allocate(spec, prof, p, pes2)) for p in T.POLICIES}
        pes_grid = np.unique(np.linspace(m, int(m * FIG8_MAX_MULT), 64).round().astype(np.int64))
        policies = np.repeat(np.array(T.POLICIES, dtype=object), pes_grid.size)
        n_pes = np.tile(pes_grid, len(T.POLICIES))
        batch, res = run_batch(spec, prof, policies, n_pes)
        torch.cuda.synchronize()
        launches = k1g.launches + k1.launches
        check(pes_grid.size == 64, f"{label}: {pes_grid.size} PE counts")
        check(after_derive == 1 and launches == 1 and k1.launches == 0,
              f"{label}: K1 launched {after_derive} times in derive, {launches} on the path "
              f"({k1.launches} by its block entry), want 1 (one grouped launch for {L} layers)")
        print(f"{label}: main path ran, K1 launches {launches} (one grouped launch for {L} layers)")

        # what came out: shapes, finiteness, the paper's ordering
        for lp, layer in zip(prof.layers, spec.layers):
            check(lp.cycles_sample.shape == (min(256, n_images * layer.patches_per_image), layer.n_blocks),
                  f"{label}: {layer.name} cycles_sample {tuple(lp.cycles_sample.shape)}")
            check(lp.cycles_sample.device.type == "cuda", f"{label}: profile left the card")
        for p, s in sims.items():
            check(np.isfinite(s.images_per_sec) and s.images_per_sec > 0, f"{label} {p}: ips {s.images_per_sec}")
            check(bool(torch.isfinite(s.layer_utilization).all()) and s.layer_utilization.shape == (L,),
                  f"{label} {p}: utilization")
            print(f"{label} {p:16s} @ {pes2} PEs: {s.images_per_sec:12.3f} img/s  mean util {s.mean_utilization:.4f}")
        ips = {p: s.images_per_sec for p, s in sims.items()}
        check(ips["blockwise"] >= ips["perf_layerwise"] >= ips["weight_based"],
              f"{label}: Fig 8 ordering broken {ips}")

        def ratios(ips):
            bw = ips["blockwise"]
            return (f"blockwise_vs_weight={bw / ips['weight_based']:.4f}x "
                    f"vs_baseline={bw / ips['baseline']:.4f}x "
                    f"vs_perf_layerwise={bw / ips['perf_layerwise']:.4f}x")

        print(f"{label} fig8 @ {pes2} PEs (2x min): {ratios(ips)}")
        big = int(m * FIG8_MAX_MULT)
        ips_big = {p: T.run_policy(spec, prof, p, big).images_per_sec for p in T.POLICIES}
        print(f"{label} fig8 @ {big} PEs ({FIG8_MAX_MULT}x min): {ratios(ips_big)}")
        print(f"{label} fig9 utilization @ {pes2} PEs: " + " ".join(
            f"{p}={sims[p].mean_utilization:.4f}" for p in ("weight_based", "perf_layerwise", "blockwise")))

        # run_batch against the scalar path, config by config
        worst = 0.0
        for i in range(len(batch)):
            a = T.allocate(spec, prof, str(policies[i]), int(n_pes[i]))
            got = to_allocation(batch, i, spec)
            same = (np.array_equal(got.layer_dups, a.layer_dups) if a.layer_dups is not None
                    else all(np.array_equal(x, y) for x, y in zip(got.block_dups, a.block_dups)))
            check(same and got.arrays_used == a.arrays_used, f"{label}: replicas differ at config {i}")
            s = T.simulate(spec, prof, a)
            for bv, sv in ((res.images_per_sec[i], torch.tensor(s.images_per_sec, dtype=torch.float64)),
                           (res.layer_cycles[i], s.layer_cycles), (res.layer_utilization[i], s.layer_utilization)):
                rel = ((bv.cpu() - sv.cpu()).abs() / sv.cpu().abs()).max().item()
                worst = max(worst, rel)
        check(worst <= 1e-9, f"{label}: run_batch vs simulate rel err {worst}")
        print(f"{label}: run_batch over {len(batch)} configs == scalar simulate (max rel err {worst:.3e}, limit 1e-9)")
        return cap, prof, launches

    # ---- 2. ResNet18 at full width
    spec = T.resnet18_imagenet()
    check((spec.n_arrays, spec.n_blocks, spec.min_pes()) == (5472, 247, 86), "ResNet18 tiling")
    cap, prof, r18_launches = drive(spec, 16, "resnet18")
    brs = [l.array.rows for l in spec.layers]
    err256 = max(k1_vs_plain(blocks_of(cap, spec)), k1_vs_plain_grouped([lc.sampled_q for lc in cap.layers], brs))
    cap8k = T.capture_activations(spec, n_images=16, batch_images=8, sample_patches=8192, device=dev)
    err8k = max(k1_vs_plain(blocks_of(cap8k, spec)), k1_vs_plain_grouped([lc.sampled_q for lc in cap8k.layers], brs))
    torch.cuda.synchronize()
    check(err256 == 0 and err8k == 0, f"K1 != plain at the path's shapes: {err256}, {err8k}")
    print("resnet18: K1 == plain at sample 256 and 8192, grouped over all 20 layers and by the block entry "
          "on every layer's blocks (max |err| 0)")
    same_profile(per_layer_derive(cap, spec), prof, "per-layer route vs grouped derive")
    same_profile(T.derive_profile(cap, spec, engine="torch"),
                 T.derive_profile(to_host(cap), spec, engine="vectorized"), "torch on card vs vectorized on host")
    same_profile(prof, T.derive_profile(cap, spec, engine="torch"), "kernel vs torch engine")
    print("resnet18: kernel engine == torch engine on the card == vectorized engine on the host")

    # ---- 3. VGG11
    vspec = T.vgg11_cifar10()
    vcap, vprof, vgg_launches = drive(vspec, 64, "vgg11")
    check(k1_vs_plain(blocks_of(vcap, vspec)) == 0, "vgg11: K1 != plain")
    check(k1_vs_plain_grouped([lc.sampled_q for lc in vcap.layers], [l.array.rows for l in vspec.layers]) == 0,
          "vgg11: K1 grouped != plain")
    same_profile(T.derive_profile(vcap, vspec, engine="torch"),
                 T.derive_profile(to_host(vcap), vspec, engine="vectorized"), "vgg11 torch on card vs vectorized on host")
    same_profile(vprof, T.derive_profile(vcap, vspec, engine="torch"), "vgg11 kernel vs torch engine")
    print("vgg11: K1 == plain (grouped and block entry); kernel engine == torch engine on the card == "
          "vectorized engine on the host")

    # ---- 4. the card against the host path on a small input (same seed ->
    # same host-drawn images and weights)
    small = dict(n_images=2, sample_patches=64)
    c_card = T.capture_activations(vspec, device=dev, **small)
    c_host = T.capture_activations(vspec, device="cpu", **small)
    diffs = [int((a.sampled_q.cpu().long() - b.sampled_q.long()).abs().max())
             for a, b in zip(c_card.layers, c_host.layers)]
    print(f"small vgg11 capture, card vs host: max |q diff| per layer {diffs}")
    # the first conv quantizes the images themselves: exact; deeper layers
    # see float32 matmuls summed in another order, held to the reference's
    # cross-environment tolerance (density atol 1e-2, cycles rtol 2e-2)
    check(diffs[0] == 0, f"card capture of conv1 differs from host: {diffs}")
    for a, b in zip(T.derive_profile(c_card, vspec).layers, T.derive_profile(c_host, vspec).layers):
        check(abs(a.density - b.density) <= 1e-2, f"small vgg11 {a.name}: density")
        ca, cb = float(a.mean_cycles.mean()), float(b.mean_cycles.mean())
        check(abs(ca / cb - 1) <= 2e-2, f"small vgg11 {a.name}: mean cycles {ca} vs {cb}")
    c_moved = ActivationCapture(c_host.network, c_host.n_images, c_host.sample_patches, c_host.seed, tuple(
        LayerCapture(lc.name, lc.rowbits.to(dev), lc.sampled_q.to(dev), lc.n_patches, lc.patches_per_image)
        for lc in c_host.layers))
    p_card, p_host = T.derive_profile(c_moved, vspec), T.derive_profile(c_host, vspec)
    same_profile(p_card, p_host, "small vgg11 kernel on card vs vectorized on host")
    for p in T.POLICIES:
        a_card = T.allocate(vspec, p_card, p, vspec.min_pes() * 2)
        a_host = T.allocate(vspec, p_host, p, vspec.min_pes() * 2)
        check(a_card.arrays_used == a_host.arrays_used, f"small vgg11 {p}: arrays used")
        s_card, s_host = T.simulate(vspec, p_card, a_card), T.simulate(vspec, p_host, a_host)
        rel = abs(s_card.images_per_sec / s_host.images_per_sec - 1)
        check(rel <= 1e-9, f"small vgg11 {p}: card vs host rel err {rel}")
    print("small vgg11: card == host (derive exact, replicas exact, img/s within 1e-9)")

    # ---- 5. timings (CUDA events, after warm-up)
    def capture():
        return T.capture_activations(spec, n_images=16, batch_images=8, sample_patches=256, device=dev)

    m = spec.min_pes()
    allocs = [T.allocate(spec, prof, p, 2 * m) for p in T.POLICIES]
    pes_grid = np.unique(np.linspace(m, int(m * FIG8_MAX_MULT), 64).round().astype(np.int64))
    policies = np.repeat(np.array(T.POLICIES, dtype=object), pes_grid.size)
    n_pes = np.tile(pes_grid, len(T.POLICIES))
    stage_ms = {
        "capture": timed(capture, reps=3),
        "derive": timed(lambda: T.derive_profile(cap, spec), reps=5),
        "allocate_5_policies": timed(lambda: [T.allocate(spec, prof, p, 2 * m) for p in T.POLICIES], reps=5),
        "simulate_5_policies": timed(lambda: [T.simulate(spec, prof, a) for a in allocs], reps=5),
        "run_batch_320": timed(lambda: run_batch(spec, prof, policies, n_pes), reps=3),
    }
    print(f"{gpu}: resnet18 stage ms: " + json.dumps(stage_ms))

    main = k1_numbers(cap, spec, clock_hz, reps=50)
    big = k1_numbers(cap8k, spec, clock_hz, reps=10)
    del cap8k
    for tag, n in (("sample 256 (main path)", main), ("sample 8192", big)):
        print(f"{gpu}: K1 per ResNet18 derive (1 launch, 20 layers), {tag}: {n['ms']:.4f} ms through the wrapper; "
              f"alone {n['kernel_ms']:.4f} ms with L2 flushed before each launch "
              f"({n['nbytes'] / (n['kernel_ms'] * 1e-3) / 1e12:.3f} TB/s; an int64 sum over its input's bytes after "
              f"the same flush {n['stream_ms']:.4f} ms), {n['alone_l2_ms']:.4f} ms back to back (L2 warm); "
              f"plain {n['plain_ms']:.4f} ms; bound {n['bound_ms']:.4f} ms ({n['bound_by']}: {n['nbytes']} B at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; {n['int_ops']} integer ops at {INT_OPS_PER_CLK_SM}/clk/SM, "
              f"{n['popc']} POPC at {POPC_PER_CLK_SM}/clk/SM), alone at {n['bound_ms'] / n['kernel_ms']:.3f} of it; "
              f"K1 through the per-layer route (20 block launches with their copies) {n['per_layer_ms']:.4f} ms; "
              f"derive_profile {n['derive_ms']:.4f} ms grouped, {n['derive_per_layer_ms']:.4f} ms per layer")
    print("K1 library_ms: null (no single PyTorch call computes bit-plane popcounts)")

    # ---- 6. K2 against its plain version on random problems
    k2_abs = k2_rel = 0.0
    n_cases = (1, 5, 20, 31, 32, 33, 64, 100, 247, 300)
    for seed in range(4 * len(n_cases)):
        n = n_cases[seed % len(n_cases)]
        args = [tuple(torch.as_tensor(b, device=dev) for b in x) if isinstance(x, tuple)
                else torch.as_tensor(x, device=dev)
                for x in k2_problem(seed, n, 513, seed % 2 == 1, seed % 3 != 0)]
        saved = k2.launches
        got = k2(*args, n_images=64, clock_hz=1e8)
        want = k2_plain(*args, n_images=64, clock_hz=1e8)
        torch.cuda.synchronize()
        k2.launches = saved
        a_err, r_err = k2_errors(got, want, f"K2 random problem {seed} (N={n})")
        k2_abs, k2_rel = max(k2_abs, a_err), max(k2_rel, r_err)
    print(f"K2 vs plain on {4 * len(n_cases)} random problems (N in {n_cases}, 513 configs each, ties, "
          f"warm starts, budget-0 rows): replicas and leftover exact, float max abs err {k2_abs:.3e}, "
          f"max rel err {k2_rel:.3e} (limit {K2_RTOL})")

    # ---- 7. the fused DSE sweep on ResNet18 at full width
    r18 = drive_fused("resnet18", FUSED_R18_BUDGETS, FUSED_R18_MAX_MULT, "resnet18 fused")

    # ---- 8. K2 at every chunk the main path's sweep launches, beside its bound
    from repro_torch.kernels.fused_alloc_eval import _launch, _prepare, kernel_plan

    chunks = k2_sweep_chunks(r18["packed"])
    check(len(chunks) == r18["k2_launches"],
          f"K2: {len(chunks)} chunks recorded, the main path launched {r18['k2_launches']}")
    k2_stats, k2_sweep = None, dict(ms=0.0, kernel_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for rows, fam, args, kw in chunks:
        saved = k2.launches
        ms = timed(lambda: k2(*args, **kw), reps=5)
        prepared = _prepare(*args)
        kernel_ms = timed(lambda: _launch(prepared, kw["n_images"], kw["clock_hz"]), reps=10)
        plain_ms = timed(lambda: k2_plain(*args, **kw), reps=1)
        k2.launches = saved
        bound_ms, bound_by, ops, nbytes = k2_bound(args)
        C, N = args[-1].shape
        V, L, B = args[3][0].shape
        for key, v in (("ms", ms), ("kernel_ms", kernel_ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
            k2_sweep[key] += v
        if k2_stats is None and fam == "block" and rows == 128:  # the first full block-family chunk
            k2_stats = dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        print(f"{gpu}: K2 rows {rows}, {fam} family, {C} configs x {N} units ({kernel_plan(N, V, L, B)}): "
              f"{ms:.4f} ms through the wrapper, {kernel_ms:.4f} ms without its checks "
              f"({ops / (kernel_ms * 1e-3) / 1e12:.2f} TFLOP/s), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}: {ops:.4e} FP64 ops at {FP64_OPS_PER_S / 1e12:.0f} TFLOP/s, {nbytes} B at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; a division counted as one operation)")
    print(f"{gpu}: K2 over the sweep's {len(chunks)} launches: {k2_sweep['ms']:.4f} ms through the wrapper, "
          f"{k2_sweep['kernel_ms']:.4f} ms without its checks, plain {k2_sweep['plain_ms']:.3f} ms, bounds "
          f"{k2_sweep['bound_ms']:.4f} ms; launches x (time - bound) "
          f"{k2_sweep['kernel_ms'] - k2_sweep['bound_ms']:.4f} ms")
    del chunks
    print("K2 library_ms: null (no single PyTorch call computes a greedy allocation)")
    print(f"{gpu}: resnet18 fused sweep over {r18['configs']} configs, s: "
          f"kernel engine {r18['kernel_warm_s']:.3f} (cold, with capture and derive: "
          f"{r18['kernel_cold_s']:.3f}), torch engine {r18['torch_warm_s']:.3f} (first run {r18['torch_s']:.3f}); "
          f"the two pipelines alone from packed columns: kernel {r18['kernel_pipelines_s']:.3f}, "
          f"torch {r18['torch_pipelines_s']:.3f}")
    for eng in ("kernel", "torch"):
        saved = (k1.launches, k2.launches)
        share, win_ms, by_name = device_busy(
            lambda: [pipe(a, p, n, engine=eng, need_dups=False) for pipe, a, p, n in r18["packed"]])
        k1.launches, k2.launches = saved
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        print(f"{gpu}: resnet18 fused pipelines, {eng} engine, torch.profiler: window {win_ms:.3f} ms, "
              f"device busy {share:.4f} (idle {1 - share:.4f}); top device time: "
              + "; ".join(f"{name[:60]} {t:.3f} ms" for name, t in top))

    vgg = drive_fused("vgg11", FUSED_VGG_BUDGETS, FUSED_VGG_MAX_MULT, "vgg11 fused")
    print(f"{gpu}: vgg11 fused sweep over {vgg['configs']} configs, s: kernel engine {vgg['kernel_warm_s']:.3f}, "
          f"torch engine {vgg['torch_warm_s']:.3f}")

    # ---- 9. K4 against its plain version, equal and grouped kv heads
    k4_err = max(k4_card_checks(), k4_grouped_checks(gpu))

    # ---- 10. K5 against its plain version
    k5_err = k5_card_checks()

    # ---- 11. K3 against its plain version, and its structured input
    k3_err, _ = k3_card_checks(gpu)

    # ---- 12. Zamba2-1.2B serving at full width
    zamba = serve_full("zamba2-1.2b", **ZAMBA, label="zamba2-1.2b", gpu=gpu)
    znum = kernel_numbers(zamba, gpu, "zamba2-1.2b")

    # ---- 13. kernels against plain versions end to end, and SMOKE card vs host
    end_to_end_vs_plain("zamba2-1.2b", 1)
    smoke_card_vs_host("zamba2-1.2b")

    # ---- 14. Mamba2-370M serving at full width
    mamba = serve_full("mamba2-370m", **MAMBA, label="mamba2-370m", gpu=gpu)
    mnum = kernel_numbers(mamba, gpu, "mamba2-370m")

    # ---- 15. the dense family at full width and depth, one model at a time
    dense, dnum = {}, {}
    for arch in DENSE_ARCHS:
        dense[arch] = serve_full(arch, **DENSE, label=arch, gpu=gpu)
        dnum[arch] = kernel_numbers(dense[arch], gpu, arch)
        del dense[arch]["seen"]
    nem = dense["nemotron-4-15b"]
    print(f"{gpu}: nemotron-4-15b peak device memory on the path {nem['peak_gb']:.2f} GB "
          f"(reckoned about {NEMOTRON_PEAK_GB} GB: 62.5 float32 weights + head cast + logits + one MLP + cache)")
    for arch in DENSE_ARCHS:
        d = dense[arch]
        print(f"{gpu}: {arch} summary: prefill {min(d['prefill_ms']):.3f} ms (best of {len(d['prefill_ms'])}), "
              f"decode {max(d['decode_tok_per_s']):.1f} tok/s (best of 2), device busy {d['busy']:.4f} over the "
              f"prefill, peak {d['peak_gb']:.2f} GB, launches K3 {d['k3_launches']}, K4 {d['k4_launches']}")

    # ---- 16. kernels against plain versions end to end: Nemotron-4-15B in
    # float32 (K3 on every forward, K4 in the prefill); the SMOKE dense configs
    end_to_end_vs_plain("nemotron-4-15b", 2)
    for arch in DENSE_SMOKE:
        smoke_card_vs_host(arch)

    # ---- 17. the fabric engines: fabric_tail, ResNet18's closed loop, the
    # fused sweep's fabric stage, VT against its plain version
    fab = fabric_phase(gpu, dev)
    draw = draw_numbers(gpu, dev)

    # ---- 18. the multi-chip half: F8, the multi-chip sweeps, fleet replay
    # with the streaming VT entry, the fault sweep, observability
    mcf = multichip_fleet_phase(gpu, dev, fab)

    # ---- 19. MoE serving: DeepSeek-V2 (MLA) and Grok-1 (K4) cut in depth,
    # and the expert replication flow
    moe = moe_phase(gpu)
    gnum = moe["knum"]["grok-1-314b"]["k4"]

    # ---- 20. training: K3, K4 and K5 under autograd, every family's SMOKE
    # step card vs host, Zamba2-1.2B trained at full width and depth, the
    # fault-tolerant runner and the launcher
    train = train_phase(gpu)
    tg, tfull = train["grads"], train["full"]

    # ---- 21. enc-dec: Whisper-medium at full width and depth, K4 on the
    # encoder's bidirectional attention and on cross-attention, served and
    # trained, the example's flow through the fault-tolerant runner
    ed = encdec_phase(gpu)
    ek4, eserve = ed["serve"]["k4"], ed["serve"]

    # ---- 22. distrib and launch: training, MoE serving and the GPipe
    # schedule on one-rank meshes, and two production-mesh dry-run cells
    mp = mesh_phase(gpu, min(tfull["ms"][1:]))

    nnum = dnum["nemotron-4-15b"]
    print(gpu)
    print(json.dumps({"kernels": [{
        "name": "bitplane_profile",
        "route": "cuda",
        "source": "src/repro_torch/csrc/bitplane_profile.cu",
        "replaces": "src/repro/kernels/bitplane_profile.py:37",
        "launches": r18_launches,
        "max_abs_err": max(max_err, err256, err8k),
        "ms": main["ms"],  # per ResNet18 derive at 256 samples, through the grouped wrapper
        "kernel_ms": main["kernel_ms"],  # the kernel alone, L2 flushed before each launch
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "ms_8192": big["ms"],
        "kernel_ms_8192": big["kernel_ms"],
        "bound_ms_8192": big["bound_ms"],
    }, {
        "name": "fused_alloc_eval",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fused_alloc_eval.cu",
        "replaces": "src/repro/kernels/fused_alloc_eval.py:48",
        "launches": r18["k2_launches"],
        "max_abs_err": max(k2_abs, r18["max_abs_err"], vgg["max_abs_err"]),
        "ms": k2_stats["ms"],  # the first full block-family chunk (rows 128), through the wrapper
        "kernel_ms": k2_stats["kernel_ms"],
        "plain_ms": k2_stats["plain_ms"],
        "bound_ms": k2_stats["bound_ms"],
        "bound_by": k2_stats["bound_by"],
        "library_ms": None,
        "sweep_ms": k2_sweep["ms"],  # every launch of the main path's sweep, summed
        "sweep_kernel_ms": k2_sweep["kernel_ms"],
        "sweep_bound_ms": k2_sweep["bound_ms"],
    }, {
        "name": "zskip_matmul",
        "route": "cuda",
        "source": "src/repro_torch/csrc/zskip_matmul.cu",
        "replaces": "src/repro/kernels/zskip_matmul.py:28",
        "launches": nem["k3_launches"],
        "max_abs_err": max(k3_err, nnum["k3"]["err"], nnum["k3_decode"]["err"]),
        "ms": nnum["k3"]["ms"],  # the op the path calls: the mask pass and the kernel
        "kernel_ms": nnum["k3"]["kernel_ms"],  # the kernel alone, through its wrapper
        "plain_ms": nnum["k3"]["plain_ms"],
        "bound_ms": nnum["k3"]["bound_ms"],
        "bound_by": nnum["k3"]["bound_by"],
        "library_ms": nnum["k3"]["library_ms"],
        "train_launches": train["smoke"]["nemotron-4-15b"]["k3"],  # per Nemotron-4-15B SMOKE train step
        "train_grad_max_rel_err": tg["k3"]["grad_err"],  # Nemotron's down-projection, of max |plain grad|
        "train_fwd_bwd_ms": tg["k3"]["ms"],  # forward + backward through the autograd Function
        "train_plain_fwd_bwd_ms": tg["k3"]["plain_ms"],
        "backward": "torch.matmul in the operands' type (no backward kernel)",
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "launches": nem["k4_launches"],
        "max_abs_err": max(k4_err, znum["k4"]["err"], gnum["err"], *(dnum[a]["k4"]["err"] for a in DENSE_ARCHS),
                           *(x["err"] for x in ek4.values())),
        "ms": nnum["k4"]["ms"],
        "plain_ms": nnum["k4"]["plain_ms"],
        "bound_ms": nnum["k4"]["bound_ms"],
        "bound_by": nnum["k4"]["bound_by"],
        "library_ms": nnum["k4"]["library_ms"],
        "grok_1_launches": moe["moe"]["grok-1-314b"]["k4_launches"],  # Grok-1 at MOE_DEPTH layers
        "grok_1_ms": gnum["ms"],
        "grok_1_plain_ms": gnum["plain_ms"],
        "grok_1_bound_ms": gnum["bound_ms"],
        "grok_1_library_ms": gnum["library_ms"],
        "train_launches": tfull["launches"]["k4"],  # per Zamba2-1.2B train step (forward, group recompute)
        "train_grad_max_rel_err": tg["k4"]["grad_err"],
        "train_fwd_bwd_ms": tg["k4"]["ms"],  # Zamba2's shape
        "train_plain_fwd_bwd_ms": tg["k4"]["plain_ms"],
        "backward": "autograd of a recomputation of the plain version (no backward kernel)",
        "whisper_prefill_launches": eserve["k4_prefill"],  # encode + the prompt into an empty cache
        "whisper_decode_launches": eserve["k4_decode_step"],  # per decode step (cross-attention only)
        "whisper_train_launches": ed["full"]["launches"],  # per train step, remat full
        # per launch on the serving path's own bf16 inputs (device time alone):
        # the encoder's (4, 1500) non-causal square, cross-attention over the
        # 64-token prompt and at a decode step, each against 1500 keys
        **{f"whisper_{tag}_{key}": ek4[part][key] for tag, part in (("enc", "enc"), ("cross64", "cross_prompt"),
                                                                  ("cross1", "cross_decode"))
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "whisper_train_grad_max_rel_err": ed["grads"]["grad_err"],
        "mesh_train_launches": mp["train"]["launches"]["k4"],  # phase 22 (a): per compressed step on the mesh
        "mesh_moe_prefill_launches": mp["moe"]["k4_launches"],  # phase 22 (b): Grok-1's EP prefill, in shard_map
        "mesh_pipeline_launches": mp["pipe"]["k4_launches"],  # phase 22 (c): the schedule, forward and backward
    }, {
        "name": "ssd_chunk",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:30",
        "launches": zamba["k5_launches"],
        "max_abs_err": max(k5_err, znum["k5"]["err"], mnum["k5"]["err"]),
        "ms": znum["k5"]["ms"],
        "kernel_ms": znum["k5"]["kernel_ms"],
        "plain_ms": znum["k5"]["plain_ms"],
        "bound_ms": znum["k5"]["bound_ms"],
        "bound_by": znum["k5"]["bound_by"],
        "library_ms": None,
        "train_launches": tfull["launches"]["k5"],  # per Zamba2-1.2B train step (forward, two recomputes)
        "train_grad_max_rel_err": tg["k5"]["grad_err"],
        "train_fwd_bwd_ms": tg["k5"]["ms"],
        "train_plain_fwd_bwd_ms": tg["k5"]["plain_ms"],
        "backward": "autograd of a recomputation of the plain version (no backward kernel)",
        "mesh_train_launches": mp["train"]["launches"]["k5"],  # phase 22 (a): per compressed step on the mesh
    }, {
        "name": "vtime_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/vtime_scan.cu",
        "replaces": "src/repro/fabric/vtime.py:629",  # the jitted scan (:629-674), no Pallas kernel
        "launches": sum(fab["launches"].values()) + sum(mcf["launches"].values()),
        "max_abs_err": fab["max_abs_err"],
        "ms": fab["tail"]["ms"],  # fabric_tail, 15 configs x 400 requests, through the wrapper
        "kernel_ms": fab["tail"]["kernel_ms"],
        "plain_ms": fab["plain_ms"],  # at the check's size: 3 configs x 40 requests
        "ms_at_check": fab["check"]["kernel_ms"],
        "bound_ms": fab["tail"]["bound_ms"],
        "bound_by": fab["tail"]["bound_by"],
        "library_ms": None,
        "stages": fab["tail"]["plan"].stages,
        "serial_chain_ms": fab["tail"]["serial_ms"],  # the bound before stages: every job one after another
        "resnet18_kernel_ms": fab["r18"]["kernel_ms"],
        "resnet18_bound_ms": fab["r18"]["bound_ms"],
        "fused_kernel_ms": fab["fused"]["kernel_ms"],
        "fused_bound_ms": fab["fused"]["bound_ms"],
        "fused_device_busy": fab["fused_busy"],
        "f8_kernel_ms": mcf["f8"]["kernel_ms"],
        "f8_bound_ms": mcf["f8"]["bound_ms"],
    }, draw_entry(draw, fab, mcf), {
        "name": "vtime_stream",
        "route": "cuda",
        "source": "src/repro_torch/csrc/vtime_scan.cu",
        "replaces": "src/repro/fabric/fleet.py:145",  # the jitted streaming scan (:104-210), no Pallas kernel
        "launches": sum(mcf["stream_launches"].values()),
        "max_abs_err": mcf["stream_err"],
        "ms": mcf["stream"]["ms"],  # the uncoarsened stream, FLEET_REQUESTS x 2 configs, through the wrapper
        "kernel_ms": mcf["stream"]["kernel_ms"],
        "plain_ms": mcf["stream_plain_ms"],  # at FLEET_PLAIN_REQUESTS requests, on the host
        "plain_requests": mcf["plain_n"],
        "bound_ms": mcf["stream"]["bound_ms"],
        "bound_by": mcf["stream"]["bound_by"],
        "stages": mcf["stream"]["plan"].stages,
        "serial_chain_ms": mcf["stream"]["serial_ms"],
        "library_ms": None,
        "segment_kernel_ms": [x["kernel_ms"] for x in mcf["segs"]],
        "segment_bound_ms": [x["bound_ms"] for x in mcf["segs"]],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
