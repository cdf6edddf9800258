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
  5. timings with CUDA events after warm-up.

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
FIG8_MAX_MULT = 5.66  # the largest Fig 8 design size, in multiples of the minimum PEs


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

    dev = torch.device("cuda")
    gpu = gpu_line()
    print(gpu)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- 1. build, and the kernel against its plain version on edge cases
    t0 = time.perf_counter()
    logs = _build.build("bitplane_profile")
    print(f"build: K1 in {time.perf_counter() - t0:.3f} s (wall, nvcc included)")
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
