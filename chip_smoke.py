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
     and Zamba2's prefill shape on the model's (b, s, h, hd) layout; the
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
     pool width and a (request, layer) on synthetic one-pool problems;
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

The line before the last is ``{"kernels": [...]}`` (each kernel's launches
on the main path, max |kernel - plain|, times and bound); the last line is
``{"ok": true, "device": {...}}``.  Numbers are this card's, printed beside
its name and power limit.
"""

from __future__ import annotations

import json
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


def device_busy(fn):
    """One call of ``fn`` under ``torch.profiler``: (device busy share of the
    call's window, window ms, {kernel name: device ms}).  Busy time is the
    union of the device's activity (kernels, copies, sets) inside the
    window; it fails if nothing ran on the device."""
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


def kernel_numbers(path, gpu, label):
    """K3, K4 and K5 per launch on the path's own first inputs, for those the
    path ran: kernel, plain version, the library call (K3: ``torch.matmul``,
    K4: ``scaled_dot_product_attention``) and bounds.  ``path``: what
    ``serve_full`` returned."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention as k4, flash_attention_op_ref
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
        b, s, h, hd = q.shape
        nkv = k.shape[2]
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # (b, h, s, hd) views
        ms = timed(lambda: ops.flash_attention_op(q, k, v, **kw), reps=20)
        plain_ms = timed(lambda: flash_attention_op_ref(q, k, v, **kw), reps=5)
        lib_ms = timed(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=kw["causal"],
                                                              enable_gqa=nkv != h), reps=20)
        err, rel = rel_err(ops.flash_attention_op(q, k, v, **kw), flash_attention_op_ref(q, k, v, **kw))
        check(rel <= K4_TOL[str(q.dtype).split(".")[1]], f"{label}: K4 vs plain on the path's inputs {rel}")
        bound, by, n_ops, nbytes = k4_bound(b, s, s, h, hd, kw["causal"], q.element_size(), nkv)
        res["k4"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by, err=err)
        print(f"{gpu}: {label} K4 per launch at q {tuple(q.shape)}, kv heads {nkv}, {q.dtype}, {kw}: "
              f"{ms:.4f} ms ({launches['k4']} per prefill: {ms * launches['k4']:.3f} ms), plain {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention{' (enable_gqa)' if nkv != h else ''} {lib_ms:.4f} ms (kernel / SDPA "
              f"{ms / lib_ms:.3f}x), bound "
              f"{bound:.4f} ms ({by}: {n_ops:.4e} ops at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16, {nbytes} B), "
              f"{n_ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s achieved; max |kernel - plain| {err:.3e} "
              f"(relative to 1 + |plain|: {rel:.3e})")
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


def vt_work(args, kw):
    """(serial job steps of the longest config, bytes a call must move, FP64
    operations this run's data needs) for one VT call: a config's chain is
    N x sum_l P_l jobs; the bytes are the sample indices, the tables, the
    lanes, variants, arrivals and transfers read once and the outputs
    written once; the operations are, per job and pool with d servers, one
    add and d max + d min (pools without servers do none)."""
    tables, idx, variant, lanes = args
    n = kw["n_requests"]
    C = variant.shape[0]
    patches = [int(i.shape[1]) for i in idx]
    steps = n * sum(patches)
    nbytes = sum(t.numel() * 8 for t in tables) + sum(i.numel() * 4 for i in idx) + lanes.numel() * 4 + C * 4
    for key in ("arrivals", "xfer"):
        if kw.get(key) is not None:
            nbytes += kw[key].numel() * 8
    nbytes += 2 * C * n * 8 + (2 * C * len(idx) * 8 if kw.get("collect_stats") else 0)
    ops, off = 0, 0
    ln = lanes.cpu().long()
    for t, p in zip(tables, patches):
        b = t.shape[2]
        d = ln[:, off : off + b]
        off += b
        ops += n * p * int(((1 + 2 * d) * (d > 0)).sum())
    return steps, nbytes, ops


def vt_numbers(call, chain_ns, reps):
    """VT on one recorded call's inputs: ms through the wrapper (with its
    checks) and alone (the packed problem, CUDA events), and its bound: the
    larger of the chain (the longest config's serial jobs x one dependent
    FP64 add + min) and the bytes at the memory's rate."""
    from repro_torch.kernels import vtime_scan as vtk

    args, kw = call
    saved = vtk.vtime_scan.launches
    ms = timed(lambda: vtk.vtime_scan(*args, **kw), reps=reps)
    packed = vtk._pack(vtk._prepare(*args, kw["n_requests"], kw.get("arrivals"), kw.get("concurrency"),
                                    kw.get("xfer")))
    kernel_ms = timed(lambda: vtk._launch(packed, kw.get("collect_stats", False)), reps=reps)
    vtk.vtime_scan.launches = saved
    steps, nbytes, ops = vt_work(args, kw)
    chain_ms = steps * chain_ns * 1e-6
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(ms=ms, kernel_ms=kernel_ms, steps=steps, nbytes=nbytes, ops=ops, chain_ms=chain_ms,
                bytes_ms=bytes_ms, ops_ms=ops / FP64_OPS_PER_S * 1e3, bound_ms=max(chain_ms, bytes_ms),
                bound_by="operations" if chain_ms >= bytes_ms else "bytes", configs=args[2].shape[0],
                plan=packed.plan)


def vt_line(gpu, label, n, cold_s=None, warm_s=None):
    extra = ""
    if warm_s is not None:
        extra = f"; run_batch {warm_s * 1e3:.3f} ms warm, {cold_s * 1e3:.3f} ms cold (host clock, synchronised)"
    print(f"{gpu}: VT {label}: {n['configs']} configs, {n['steps']} serial job steps each "
          f"({n['plan'].threads} threads, {n['plan'].consumer_warps} warps on the pools, KMAX {n['plan'].kmax}, "
          f"chunks of {n['plan'].chunk}, "
          f"{n['plan'].state_stride} lanes of state in "
          f"{'shared' if n['plan'].smem_state else 'global'} memory): {n['kernel_ms']:.4f} ms alone, "
          f"{n['ms']:.4f} ms through the wrapper; {n['steps'] / (n['kernel_ms'] * 1e-3):.4e} job steps/s a config; "
          f"bound {n['bound_ms']:.4f} ms ({n['bound_by']}: chain {n['chain_ms']:.4f} ms, bytes "
          f"{n['bytes_ms']:.4f} ms for {n['nbytes']} B, all FP64 work {n['ops_ms']:.4f} ms for {n['ops']:.4e} ops "
          f"at {FP64_OPS_PER_S / 1e12:.0f} TFLOP/s), alone at {n['kernel_ms'] / n['bound_ms']:.2f}x the bound{extra}")


def vt_lane_costs(gpu, dev, clock_hz):
    """VT's cost by path on synthetic problems (random integer cycles, one
    config, 100 Poisson requests): cycles a job for one pool of d servers
    and 1,024 jobs a request (a thread runs d <= 8, a warp more), and
    cycles a (request, layer) for 20 layers of one one-job pool."""
    import numpy as np
    import torch

    from repro_torch.kernels import vtime_scan as vtk

    rng = np.random.default_rng(7)

    def ms_of(L, P, d, n=100):
        tables = [torch.as_tensor(rng.integers(20, 400, (1, 128, 1)).astype(np.float64), device=dev)
                  for _ in range(L)]
        idx = [torch.as_tensor(rng.integers(0, 128, (n, P)), dtype=torch.int32, device=dev) for _ in range(L)]
        lanes = torch.full((1, L), d, dtype=torch.int32, device=dev)
        arr = torch.as_tensor(np.cumsum(rng.exponential(1e4, (1, n)), axis=1), device=dev)
        saved = vtk.vtime_scan.launches
        packed = vtk._pack(vtk._prepare(tables, idx, torch.zeros(1, dtype=torch.int32, device=dev), lanes, n, arr,
                                        None, None))
        ms = timed(lambda: vtk._launch(packed, False), reps=3)
        vtk.vtime_scan.launches = saved
        return ms * 1e-3 * clock_hz / n

    per_job = {d: ms_of(1, 1024, d) / 1024 for d in (1, 2, 4, 8, 32, 64, 128, 256)}
    per_layer = ms_of(20, 1, 1) / 20
    print(f"{gpu}: VT cycles a job by servers in the pool (one 1,024-job pool; a thread runs <= 8, a warp more): "
          + ", ".join(f"{d}: {c:.1f}" for d, c in per_job.items())
          + f"; a (request, layer) of one job costs {per_layer:.0f} cycles (staging, barrier, completion)")
    return per_job, per_layer


def fabric_phase(gpu, dev):
    """The fabric engines on the card (slice 8): profiles by K1, then (1) the
    reference's fabric_tail grid on VGG11, (2) ResNet18's closed loop, (3)
    the fused sweep's fabric stage over 1,024 VGG11 configs, (4) VT against
    its plain version, (5) VT's numbers and its cost by path.  Each path's
    VT count is set to 0 just before it and read just after."""
    import numpy as np
    import torch

    import repro_torch as T
    from repro_torch.dse import FabricEval, clear_caches, clear_fused_caches, design_grid, run_fused_sweep, run_sweep
    from repro_torch.fabric import (
        ClosedLoop, FabricSim, PoissonOpen, VirtualTimeFabric, provision_latency_aware, shift_profile,
    )
    from repro_torch.kernels.vtime_scan import vtime_scan as vt, vtime_scan_ref as vt_plain

    t_phase = time.perf_counter()
    out = {"launches": {}}
    chain_ns = vt_chain_ns(dev)
    print(f"{gpu}: one thread's dependent FP64 add + min: {chain_ns:.3f} ns a step; add alone "
          f"{vt_chain_ns(dev, with_min=False):.3f} ns")

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
    vt.launches = 0
    t0 = time.perf_counter()
    vt_prov = VirtualTimeFabric(spec, prof, lane_quantum=8, device=dev)
    las = {f: provision_latency_aware(spec, prof, pes, offered_ips=f * cap, calib_requests=FABRIC_CALIB,
                                      grants=0, vt=vt_prov) for f in FABRIC_LOADS}
    torch.cuda.synchronize()
    prov_s = time.perf_counter() - t0
    out["launches"]["provision"] = vt.launches
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
    vt.launches = 0
    with VTRecorder() as rec:
        t0 = time.perf_counter()
        cold = vtf.run_batch(allocs, procs, seed=3)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = vtf.run_batch(allocs, procs, seed=3)
        warm_s = time.perf_counter() - t0
    out["launches"]["fabric_tail"] = vt.launches
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
    vt.launches = 0
    with VTRecorder() as rec:
        t0 = time.perf_counter()
        res = vtr.run_batch(r_allocs, ClosedLoop(*FABRIC_R18_LOOP), seed=1)
        r18_s = time.perf_counter() - t0
    out["launches"]["resnet18_loop"] = vt.launches
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
    vt.launches = 0
    got = vtr.run_batch([bwr], ClosedLoop(*FABRIC_R18_EQUAL), seed=1)
    out["launches"]["resnet18_equal"] = vt.launches
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
    vt.launches = 0
    with VTRecorder() as rec:
        t0 = time.perf_counter()
        fused = run_fused_sweep(pts, fabric=fe, device=dev)
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - t0
    out["launches"]["fused"] = vt.launches
    check(vt.launches == len(FUSED_ROWS), f"fused fabric stage: VT launched {vt.launches} times, want {len(FUSED_ROWS)}")
    vt.launches = 0
    t0 = time.perf_counter()
    staged = run_sweep(pts, fabric=fe, engine="batch", device=dev)
    staged_s = time.perf_counter() - t0
    out["launches"]["staged"] = vt.launches
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
    fused_n = vt_numbers(max(rec.calls, key=lambda c: c[0][2].shape[0]), chain_ns, reps=5)
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
    print(f"{gpu}: fabric phase {out['phase_s']:.3f} s; VT launches by path: {json.dumps(out['launches'])}")
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
    """(serial job steps of one config, bytes, FP64 operations) of one
    streaming VT call: a config's chain is N x sum_l (its layer's jobs:
    macro-jobs, then the exact tail); the bytes are the tables, lanes and
    arrivals read once, the carry (lanes, ring, sketch, moments, horizon)
    read and written once, and the emitted (C, N) pairs written; the
    operations are, per job and pool with d lanes, one add and d max + d
    min."""
    import numpy as np

    tables, variant, lanes, carry = args
    n = kw["n_requests"]
    patches = [int(i.shape[1]) for i in kw["idx"]] if kw.get("idx") is not None else list(kw["patches"])
    plans = np.ones((variant.shape[0], len(tables), 2), dtype=np.int64) * np.array([1, 0]) \
        if kw.get("plans") is None else np.broadcast_to(np.asarray(kw["plans"]), (variant.shape[0], len(tables), 2))
    jobs = plans[..., 1] + np.asarray(patches)[None, :] - plans[..., 1] * plans[..., 0]  # (C, L)
    steps = int(n * jobs.sum(axis=1).max())
    nbytes = sum(t.numel() * 8 for t in tables) + lanes.numel() * 4 + variant.numel() * 4
    nbytes += 2 * sum(t.numel() * 8 for t in carry)
    if kw.get("arrivals") is not None:
        nbytes += variant.shape[0] * n * 8
    if kw.get("emit"):
        nbytes += 2 * variant.shape[0] * n * 8
    ln = lanes.cpu().long().numpy()
    ops, off = 0, 0
    for li, t in enumerate(tables):
        b = t.shape[2]
        d = ln[:, off : off + b]
        off += b
        ops += int((n * jobs[:, li] * ((1 + 2 * d) * (d > 0)).sum(axis=1)).sum())
    return steps, nbytes, ops


def stream_numbers(call, chain_ns, ms, kernel_ms):
    """One recorded streaming launch: its times (through the wrapper and
    alone, from ``StreamRecorder``) beside its bound, the larger of the
    chain (one config's serial job steps x one dependent FP64 add + min)
    and the bytes at the memory's rate."""
    args, kw = call
    steps, nbytes, ops = stream_work(args, kw)
    chain_ms, bytes_ms = steps * chain_ns * 1e-6, nbytes / HBM_BYTES_PER_S * 1e3
    return dict(ms=ms, kernel_ms=kernel_ms, steps=steps, nbytes=nbytes, ops=ops, chain_ms=chain_ms,
                bytes_ms=bytes_ms, bound_ms=max(chain_ms, bytes_ms),
                bound_by="operations" if chain_ms >= bytes_ms else "bytes", n=kw["n_requests"],
                configs=args[1].shape[0])


def stream_vs_plain(call, n):
    """Re-run one recorded streaming call on its own carry, plans and
    ``r0``, cut to its first ``n`` requests and with ``emit``: the kernel on
    the card against its plain version on the host.  Every carried tensor
    and the emitted arrivals and completions must be equal.  The launch
    made here is not counted.  Returns (the kernel's completions, the
    largest difference, the plain version's seconds)."""
    import torch

    from repro_torch.kernels.vtime_scan import vtime_stream as vs, vtime_stream_ref as vs_plain

    args, kw = call
    kw = dict(kw, n_requests=n, emit=True)
    if kw.get("arrivals") is not None:
        kw["arrivals"] = kw["arrivals"][:, :n]
    if kw.get("idx") is not None:
        kw["idx"] = [i[:n] for i in kw["idx"]]
    saved = vs.launches
    got_c, got_y = vs(*args, **kw)
    vs.launches = saved
    to_host = lambda x: [t.cpu() for t in x] if isinstance(x, list) else x.cpu()
    args_h = [type(a)(*(t.cpu() for t in a)) if hasattr(a, "_fields") else to_host(a) for a in args]
    kw_h = {k: to_host(v) if isinstance(v, torch.Tensor) or (isinstance(v, list) and k == "idx") else v
            for k, v in kw.items()}
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
    from repro_torch.kernels.vtime_scan import vtime_scan as vt, vtime_stream as vs
    from repro_torch.obs import build_trace, utilization_report, validate_trace

    t_phase = time.perf_counter()
    chain_ns = fab["chain_ns"]
    out = {"launches": {}, "stream_launches": {}}

    # ---- (1) F8: VGG11 blockwise at 10x to 20x its minimum PEs through VT
    spec, prof = fab["vgg11"]
    allocs = [T.allocate(spec, prof, "blockwise", spec.min_pes() * m) for m in F8_MULTS]
    widest = [int(pool_lanes(spec, a).max()) for a in allocs]
    check(max(widest) > 512, f"F8: no pool wider than 512 servers at {F8_MULTS}x ({widest})")
    cap = T.simulate(spec, prof, allocs[0]).images_per_sec
    proc = PoissonOpen(FABRIC_CHECK_REQUESTS, 0.6 * cap / 1e8, seed=1)
    vt.launches = 0
    with VTRecorder() as rec:
        res = VirtualTimeFabric(spec, prof, device=dev).run_batch(allocs, proc, seed=0)
    out["launches"]["f8"] = vt.launches
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
    vt.launches = 0
    t0 = time.perf_counter()
    mc = run_multichip_sweep(pts, device=dev, **MC_RUN)
    torch.cuda.synchronize()
    mc_s = time.perf_counter() - t0
    out["launches"]["multichip"] = vt.launches
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
    vt.launches = 0
    t0 = time.perf_counter()
    fused = run_fused_multichip_sweep(cpts, load_fracs=FUSED_CHIP_LOADS, device=dev, **FUSED_CHIP_RUN)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    out["launches"]["fused_multichip"] = vt.launches
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
        print(f"{gpu}: fleet segment {k} ({sn['n']} requests, {sn['configs']} configs, {sn['steps']} serial job steps): "
              f"launch alone {sn['kernel_ms']:.3f} ms, through the wrapper {sn['ms']:.3f} ms; chain bound "
              f"{sn['chain_ms']:.3f} ms ({sn['steps']} steps x {chain_ns:.3f} ns), bytes {sn['bytes_ms']:.4f} ms; "
              f"alone at {sn['kernel_ms'] / sn['bound_ms']:.2f}x the bound")
    print(f"{gpu}: vtime_stream, uncoarsened, {n} requests x 2 configs ({full['steps']} steps): alone "
          f"{full['kernel_ms']:.3f} ms, through the wrapper {full['ms']:.3f} ms, bound {full['bound_ms']:.3f} ms "
          f"({full['bound_by']}), {full['steps'] / (full['kernel_ms'] * 1e-3):.4e} job steps/s a config")
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
          f"streaming launches {json.dumps(out['stream_launches'])}")
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


def main() -> int:
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
                        "vtime_scan")
    print(f"build: K1, K2, K3, K4, K5 and VT in {time.perf_counter() - t0:.3f} s (wall, six nvcc processes together)")
    for name, log in logs.items():
        print(f"[nvcc {name}]\n{log.strip()}")
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

    # ---- 18. the multi-chip half: F8, the multi-chip sweeps, fleet replay
    # with the streaming VT entry, the fault sweep, observability
    mcf = multichip_fleet_phase(gpu, dev, fab)

    # ---- 19. MoE serving: DeepSeek-V2 (MLA) and Grok-1 (K4) cut in depth,
    # and the expert replication flow
    moe = moe_phase(gpu)
    gnum = moe["knum"]["grok-1-314b"]["k4"]

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
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "launches": nem["k4_launches"],
        "max_abs_err": max(k4_err, znum["k4"]["err"], gnum["err"], *(dnum[a]["k4"]["err"] for a in DENSE_ARCHS)),
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
        "resnet18_kernel_ms": fab["r18"]["kernel_ms"],
        "resnet18_bound_ms": fab["r18"]["bound_ms"],
        "fused_kernel_ms": fab["fused"]["kernel_ms"],
        "fused_bound_ms": fab["fused"]["bound_ms"],
        "fused_device_busy": fab["fused_busy"],
        "f8_kernel_ms": mcf["f8"]["kernel_ms"],
        "f8_bound_ms": mcf["f8"]["bound_ms"],
    }, {
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
        "library_ms": None,
        "segment_kernel_ms": [x["kernel_ms"] for x in mcf["segs"]],
        "segment_bound_ms": [x["bound_ms"] for x in mcf["segs"]],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
