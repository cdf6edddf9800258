#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card, ``nvcc`` and
``nvidia-smi``; it exits non-zero without them or without the repo's
sources.  Phases, each of which fails the run on any mismatch:

  1. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
     source, all started together) and hold each kernel against its plain
     PyTorch version on edge-case inputs;
  2. the main path on ResNet18 at full width (20 conv layers, 224x224):
     ``capture_activations`` -> ``derive_profile`` (kernel engine: K1, one
     launch per layer) -> ``allocate`` + ``simulate`` for the five Fig 8
     policies -> ``run_batch`` over 5 policies x 64 PE counts, with K1's
     launch count read before and after; then K1 against its plain
     version at the path's shapes (sample 256 and 8192), the ``"torch"``
     engine on the card against the ``"vectorized"`` engine on the host,
     and ``run_batch`` against the scalar ``simulate``;
  3. the same path on VGG11 at 64 images;
  4. the card against the host path on a small VGG11 input;
  5. timings with CUDA events after warm-up;
  6. K2 (the fused allocate + eval kernel) against its plain version on
     random problems (ties, warm starts, budget-0 rows, N not a multiple
     of 32);
  7. the fused DSE sweep on ResNet18 at full width: ``run_fused_sweep``
     (``engine="kernel"``: one K1 launch per geometry group, then K2 per
     chunk) over array rows 128 and 256 x ADC bits 1-8 x four policies x
     4,400 PE budgets from 1.0 to 2.5x the minimum (281,600 configs), with
     K1's and K2's launch counts set to 0 before and read after; then the
     ``"torch"`` engine on the same grid, the staged ``run_sweep`` on a
     64-budget sub-grid, and K2 against its plain version on every chunk of
     that sub-grid; the same for VGG11 on a smaller grid;
  8. K2's timings at the main path's chunk, beside its bound.

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
FP64_OPS_PER_S = 34e12  # H100 SXM float64 rate outside the tensor cores (K2 uses no tensor core)
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


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps=1, warmup=1):
    """Mean ms per call by CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    from repro_torch.kernels.bitplane_profile import bitplane_block_profile as k1
    from repro_torch.kernels.fused_alloc_eval import fused_alloc_eval as k2, fused_alloc_eval_ref as k2_plain

    clear_caches()
    clear_fused_caches()
    pts = fused_grid(network, n_budgets, max_mult)
    out = {"configs": len(pts)}

    k1.launches = 0
    k2.launches = 0
    t0 = time.perf_counter()
    res_k = run_fused_sweep(pts, engine="kernel")
    torch.cuda.synchronize()
    out["kernel_cold_s"] = time.perf_counter() - t0
    out["k1_launches"], out["k2_launches"] = k1.launches, k2.launches
    groups = len(FUSED_ROWS)
    check(out["k1_launches"] == groups,
          f"{label}: K1 launched {out['k1_launches']} times on the fused path, want {groups} (one per geometry)")
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


def k2_chunk_args(network, rows):
    """The K2 calls the main path makes for one geometry group, recorded as
    they are made (first chunk of each family): (layer-family args,
    block-family args), with their keyword arguments."""
    import numpy as np

    import repro_torch.dse.fused as fused_mod
    from repro_torch.dse import get_fused_pipeline
    from repro_torch.kernels.fused_alloc_eval import fused_alloc_eval as k2

    pts = [p for p in fused_grid(network, FUSED_R18_BUDGETS, FUSED_R18_MAX_MULT) if p.array.rows == rows]
    pipe = get_fused_pipeline(network, pts[0].array, FUSED_ADC_BITS)
    seen = {}
    real = fused_mod.fused_alloc_eval

    def recording(*args, **kw):
        seen.setdefault(args[0].shape[1], (args, kw))
        return real(*args, **kw)

    saved = k2.launches
    fused_mod.fused_alloc_eval = recording
    try:
        pipe(np.array([FUSED_ADC_BITS.index(p.array.adc_bits) for p in pts], np.int32),
             np.array([p.policy for p in pts], dtype=object), np.array([p.n_pes for p in pts]),
             engine="kernel", need_dups=False)
    finally:
        fused_mod.fused_alloc_eval = real
        k2.launches = saved
    return seen[pipe.L], seen[pipe.N]


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
    )
    from repro_torch.kernels.fused_alloc_eval import (
        fused_alloc_eval as k2,
        fused_alloc_eval_ref as k2_plain,
    )

    dev = torch.device("cuda")
    gpu = gpu_line()
    print(gpu)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- 1. build, and the kernel against its plain version on edge cases
    t0 = time.perf_counter()
    logs = _build.build("bitplane_profile", "fused_alloc_eval")
    print(f"build: K1 and K2 in {time.perf_counter() - t0:.3f} s (wall, two nvcc processes together)")
    for name, log in logs.items():
        print(f"[nvcc {name}]\n{log.strip()}")
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
    print(f"K1 vs plain, r in (128, 64, 37) x rows_per_read in (4, 8, 16) x (random, 0, 0xFF): max |err| 0")

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
        """The main path, with K1's count set to 0 before and read after."""
        L = len(spec.layers)
        m = spec.min_pes()
        k1.launches = 0
        cap = T.capture_activations(spec, n_images=n_images, batch_images=8, sample_patches=256, device=dev)
        prof = T.derive_profile(cap, spec)  # engine None on the card: the kernel
        after_derive = k1.launches
        pes2 = m * 2
        sims = {p: T.simulate(spec, prof, T.allocate(spec, prof, p, pes2)) for p in T.POLICIES}
        pes_grid = np.unique(np.linspace(m, int(m * FIG8_MAX_MULT), 64).round().astype(np.int64))
        policies = np.repeat(np.array(T.POLICIES, dtype=object), pes_grid.size)
        n_pes = np.tile(pes_grid, len(T.POLICIES))
        batch, res = run_batch(spec, prof, policies, n_pes)
        torch.cuda.synchronize()
        launches = k1.launches
        check(pes_grid.size == 64, f"{label}: {pes_grid.size} PE counts")
        check(after_derive == L and launches == L,
              f"{label}: K1 launched {after_derive} times in derive, {launches} on the path, want {L}")
        print(f"{label}: main path ran, K1 launches {launches} (one per layer)")

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
    err256 = k1_vs_plain(blocks_of(cap, spec))
    cap8k = T.capture_activations(spec, n_images=16, batch_images=8, sample_patches=8192, device=dev)
    err8k = k1_vs_plain(blocks_of(cap8k, spec))
    torch.cuda.synchronize()
    check(err256 == 0 and err8k == 0, f"K1 != plain at the path's shapes: {err256}, {err8k}")
    print("resnet18: K1 == plain on every layer's blocks at sample 256 and 8192 (max |err| 0)")
    same_profile(T.derive_profile(cap, spec, engine="torch"),
                 T.derive_profile(to_host(cap), spec, engine="vectorized"), "torch on card vs vectorized on host")
    same_profile(prof, T.derive_profile(cap, spec, engine="torch"), "kernel vs torch engine")
    print("resnet18: kernel engine == torch engine on the card == vectorized engine on the host")

    # ---- 3. VGG11
    vspec = T.vgg11_cifar10()
    vcap, vprof, _ = drive(vspec, 64, "vgg11")
    check(k1_vs_plain(blocks_of(vcap, vspec)) == 0, "vgg11: K1 != plain")

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

    def k1_numbers(blocks, reps):
        saved = k1.launches
        ms = timed(lambda: [k1(b) for b in blocks], reps=reps)
        plain_ms = timed(lambda: [k1_plain(b) for b in blocks], reps=reps)
        k1.launches = saved
        nbytes = sum(b.numel() + 36 * b.shape[0] * b.shape[1] for b in blocks)
        ops = sum(6 * b.numel() for b in blocks)  # and + popc + add per 4-byte word and plane
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / LANE_OPS_PER_S * 1e3
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations", nbytes=nbytes)

    main = k1_numbers(blocks_of(cap, spec), reps=50)
    big = k1_numbers(blocks_of(cap8k, spec), reps=10)
    for tag, n in (("sample 256 (main path)", main), ("sample 8192", big)):
        print(f"{gpu}: K1 per derive (20 launches), {tag}: {n['ms']:.4f} ms "
              f"({n['ms'] / 20 * 1e3:.2f} us/launch), plain {n['plain_ms']:.4f} ms, "
              f"bound {n['bound_ms']:.4f} ms ({n['bound_by']}, {n['nbytes']} B), "
              f"{n['nbytes'] / (n['ms'] * 1e-3) / 1e9:.1f} GB/s")
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

    # ---- 8. K2 at the main path's chunk, beside its bound
    from repro_torch.kernels.fused_alloc_eval import _launch, _prepare

    k2_stats = {}
    for tag, (args, kw) in zip(("layer", "block"), k2_chunk_args("resnet18", 128)):
        saved = k2.launches
        ms = timed(lambda: k2(*args, **kw), reps=20)
        prepared = _prepare(*args)
        kernel_ms = timed(lambda: _launch(prepared, kw["n_images"], kw["clock_hz"]), reps=20)
        plain_ms = timed(lambda: k2_plain(*args, **kw), reps=2)
        k2.launches = saved
        bound_ms, bound_by, ops, nbytes = k2_bound(args)
        C, N = args[-1].shape
        k2_stats[tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        print(f"{gpu}: K2 {tag} family, rows 128, one launch of {C} configs x {N} units: {ms:.4f} ms "
              f"through the wrapper ({ms / C * 1e6:.2f} ns/config), {kernel_ms:.4f} ms without its "
              f"checks, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}: {ops:.4e} FP64 ops at {FP64_OPS_PER_S / 1e12:.0f} TFLOP/s, {nbytes} B at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), {ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s achieved")
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

    print(gpu)
    print(json.dumps({"kernels": [{
        "name": "bitplane_profile",
        "route": "cuda",
        "source": "src/repro_torch/csrc/bitplane_profile.cu",
        "replaces": "src/repro/kernels/bitplane_profile.py:37",
        "launches": r18_launches,
        "max_abs_err": max(max_err, err256, err8k),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
    }, {
        "name": "fused_alloc_eval",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fused_alloc_eval.cu",
        "replaces": "src/repro/kernels/fused_alloc_eval.py:48",
        "launches": r18["k2_launches"],
        "max_abs_err": max(k2_abs, r18["max_abs_err"], vgg["max_abs_err"]),
        "ms": k2_stats["block"]["ms"],
        "plain_ms": k2_stats["block"]["plain_ms"],
        "bound_ms": k2_stats["block"]["bound_ms"],
        "bound_by": k2_stats["block"]["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
