"""Timing-only variants of VT's pools and streaming loaders on the card, in one call.

Builds edited copies of ``src/repro_torch/csrc/vtime_scan.cu`` into
``build/vt_variants/`` (one ``nvcc`` each, all started together, with the
library's own flags) and times each through the wrappers' launch paths:

* ``kernel``: the kernel as it is;
* ``full``: every job one by one (``kMerge`` false), a job rewriting every
  lane of its pool, as before merged epochs;
* ``gate0``, ``gate4``, ``gate16``: a pool merges epochs in a layer of at
  least 0, 4 or 16 epochs' jobs a request (8 in the kernel);
* ``nomerge32``: the KMAX 32 build's pools of 33 to 512 servers take
  every job one by one (they merge epochs in the kernel);
* ``quarter``: epochs while a quarter epoch's jobs are left, one by one
  after an epoch of less than a quarter of its jobs (half in the kernel);
* ``nb_down``: epochs of 64 and 128 jobs from 128 and 256 servers on
  (86 and 171 in the kernel);
* ``me_half``: those, of up to half a pool's servers (three quarters in
  the kernel);
* ``shuffle``: every build's warp pool keeps lanes 0 and 1 on every thread,
  lane 1 coming back from its owner by a shuffle (``warp_replicas`` false);
* ``replicas``: every build's warp pool keeps lanes 0..2 on every thread,
  advanced with each end, so the shuffle that brings lane 3 has two jobs of
  slack (``warp_replicas`` true);
* ``pieces``: the streaming loaders always take the piecewise fold that a
  macro-job of more than 1,024 patches needs;
* ``int_thread``: a pool of 2 to 8 servers compares its lanes' bit patterns
  as integers (exact for non-negative doubles) instead of as doubles;
* ``int_all``: every min and max of the kernel, and those compares, on the
  bit patterns.

The variants are for timing only: nothing checks their results (the
kernel's own tests hold the ``kernel`` build).  It prints the card's name
and power limit, then per variant, twice over in turns: cycles a job of one
pool of d servers (1,024 jobs a request, 60 requests; service times of 20 to
400 cycles, then at the cells' spread, a standard deviation of a tenth of
the mean, then at that spread in one request of 32,768 jobs), the share of
jobs that deep inserts sent one by one in those two, of a layer of k such
pools, of a layer of a pool wider than 512 beside a narrower one (the KMAX
32 build, at the cells' spread), the ms of one launch over many configs of
8 layers of 4 to 16 pools,
of F8's launch (VGG11 blockwise at 10x to 20x its minimum PEs, 40
requests, the profile ``chip_smoke.py`` takes), and of two streaming
launches of VGG11 at 2x its minimum PEs (5,000 requests exact, 40,000
coarsened).  Run on a machine with the card: ``python3 chip_vt_variants.py
[variant ...]`` (every variant when none is named).
"""

import ctypes
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

DMIN = "__device__ __forceinline__ double dmin(double a, double b) { return b < a ? b : a; }\n"
DMAX = "__device__ __forceinline__ double dmax(double a, double b) { return b > a ? b : a; }\n"
LT = ("__device__ __forceinline__ bool lt(double a, double b) {\n"
      "  return __double_as_longlong(a) < __double_as_longlong(b);\n}\n")
INT_THREAD = [(DMAX, DMAX + LT),
              ("const bool pn = k + 1 < K && f[(k + 1) % K] < end;",
               "const bool pn = k + 1 < K && lt(f[(k + 1) % K], end);")]
INT_ALL = INT_THREAD + [
    (DMIN, "__device__ __forceinline__ double dmin(double a, double b) {\n"
           "  return __double_as_longlong(b) < __double_as_longlong(a) ? b : a;\n}\n"),
    (DMAX, "__device__ __forceinline__ double dmax(double a, double b) {\n"
           "  return __double_as_longlong(b) > __double_as_longlong(a) ? b : a;\n}\n")]


WARP = "__host__ __device__ constexpr bool warp_replicas(int kmax) { return kmax == 32; }"
PIECES = "    if (np <= kWarpRows) fold_rows<false>"
MERGE = "constexpr bool kMerge = true;"
NB = "  const int nb = d >= 171 ? 4 : d >= 86 ? 2 : 1;"
ME = "  const int me = min(32 * nb, 3 * d / 4);"
LEFT = "    while (back == 0 && 2 * (nj - j) >= ms.me) {"
SHORT = "      if (2 * o.jobs < min(ms.me, nj - j)) {"
GATE = "constexpr int kMinEpochs = 8;"
BUILDS = "return kMerge && kmax > 1; }"
VARIANTS = {
    "kernel": [],
    "full": [(MERGE, MERGE.replace("true", "false"))],
    "gate0": [(GATE, GATE.replace("8", "0"))],
    "gate4": [(GATE, GATE.replace("8", "4"))],
    "gate16": [(GATE, GATE.replace("8", "16"))],
    "nomerge32": [(BUILDS, BUILDS.replace("kmax > 1", "(kmax == 4 || kmax == 16)"))],
    "nb_down": [(NB, NB.replace("171", "256").replace("86", "128"))],
    "quarter": [(LEFT, LEFT.replace("2 * (nj - j)", "4 * (nj - j)")), (SHORT, SHORT.replace("2 * o.jobs", "4 * o.jobs"))],
    "me_half": [(NB, NB.replace("171", "256").replace("86", "128")), (ME, ME.replace("3 * d / 4", "d / 2"))],
    "shuffle": [(WARP, WARP.replace("kmax == 32", "false && kmax"))],
    "replicas": [(WARP, WARP.replace("kmax == 32", "true || kmax"))],
    "pieces": [(PIECES, PIECES.replace("np <= kWarpRows", "false"))],
    "int_thread": INT_THREAD,
    "int_all": INT_ALL,
}


def build(src: str, names) -> dict:
    from repro_torch.kernels import _build

    out_dir = ROOT / "build" / "vt_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        edits, text = VARIANTS[name], src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the text to replace occurs {text.count(old)} times")
            text = text.replace(old, new)
        cu, lib = out_dir / f"vt_{name}.cu", out_dir / f"lib_{name}.so"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.EXTRA_FLAGS["vtime_scan"], "-I", str(_build.CSRC),
               "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log[-3000:]}")
        spills = sorted({int(n) for n in re.findall(r"(\d+) bytes spill stores", log)})
        print(f"{name}: built, spill stores {spills}", flush=True)
        libs[name] = lib
    return libs


def main(names) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_vt_variants.py needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import vtime_scan as vtk

    t0 = time.time()
    libs = build((ROOT / "src/repro_torch/csrc/vtime_scan.cu").read_text(), names)
    print(f"built {len(libs)} variants in {time.time() - t0:.1f} s", flush=True)
    argtypes = vtk._launcher().argtypes
    gpu = cs.gpu_line()
    dev = torch.device("cuda")
    clock = cs.sm_clock_hz()
    print(f"{gpu}; SM clock {clock / 1e6:.0f} MHz", flush=True)

    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    deep_share = {}

    def cycles(d, pools=1, P=1024, n=60, seed=7, spread=False, key=None):
        """cycles a job step of one layer of ``pools`` pools of d servers (or
        of pools of the widths in a tuple d), one config; service times 20
        to 400 cycles, or at the cells' spread; the share of jobs that deep
        inserts sent one by one kept under ``key``"""
        widths = np.array(d if isinstance(d, tuple) else [d] * pools)
        pools = len(widths)
        rng = np.random.default_rng(seed)
        svc = cs.spread_cycles(rng, (1, 128, pools)) if spread else rng.integers(20, 400, (1, 128, pools))
        tables = vtk.vt_tables([torch.as_tensor(svc.astype(np.float64), device=dev)])
        idx = torch.as_tensor(rng.integers(0, 128, n * P).astype(np.int32), device=dev)
        arr = torch.as_tensor(np.cumsum(rng.exponential(1e4, (1, n)), axis=1), device=dev)
        packed = vtk._pack(vtk._prepare(tables, idx, [P], np.zeros(1), widths[None], n, arr, None, None))
        if key is not None:
            deep = torch.zeros(1, dtype=torch.int64, device=dev)
            vtk._launch(packed, False, deep)
            deep_share[key] = int(deep.item()) / (n * P * pools)
        return timed(lambda: vtk._launch(packed, False)) * 1e-3 * clock / (n * P)

    def many(C, top, seed=3, n=40, spread=False):
        """(ms, S, KMAX) of one launch over C configs of 8 layers of 4 to 16
        pools of 1 to ``top`` servers; service times 20 to 400 cycles, or at
        the cells' spread"""
        rng = np.random.default_rng(seed)
        shapes = [(64, int(rng.integers(4, 17)), int(rng.integers(16, 513))) for _ in range(8)]
        tables = vtk.vt_tables([torch.as_tensor((cs.spread_cycles(rng, (1, s, b)) if spread else
                                                 rng.integers(20, 400, (1, s, b))).astype(np.float64), device=dev)
                                for s, b, _ in shapes])
        idx = torch.as_tensor(np.concatenate([rng.integers(0, s, (n, p)).ravel() for s, _, p in shapes])
                              .astype(np.int32), device=dev)
        lanes = rng.integers(1, top + 1, (C, sum(b for _, b, _ in shapes)))
        arr = torch.as_tensor(np.cumsum(rng.exponential(1e5, (C, n)), axis=1), device=dev)
        packed = vtk._pack(vtk._prepare(tables, idx, [p for _, _, p in shapes], np.zeros(C), lanes, n, arr, None,
                                        None))
        return timed(lambda: vtk._launch(packed, False)), packed.plan.stages, packed.plan.kmax

    # F8's launch and two streaming launches, recorded from the fabric's
    # own calls on the kernel as it is, then replayed on each variant
    import repro_torch as T
    from repro_torch.fabric import CoarsenConfig, PoissonOpen, VirtualTimeFabric
    from repro_torch.fabric.fleet import run_stream
    from repro_torch.kernels import _build

    _build.build("bitplane_profile")
    spec = T.vgg11_cifar10()
    prof = T.derive_profile(T.capture_activations(spec, device=dev, **cs.FABRIC_VGG_PROFILE), spec)
    calls, real_launch, real_stream = {}, vtk._launch, vtk._stream_launch

    def recorder(key, real):
        def launch(*args):
            calls[key] = args
            return real(*args)
        return launch

    vtk._launch = recorder("f8", real_launch)
    allocs = [T.allocate(spec, prof, "blockwise", spec.min_pes() * m) for m in cs.F8_MULTS]
    cap = T.simulate(spec, prof, allocs[0]).images_per_sec
    VirtualTimeFabric(spec, prof, device=dev).run_batch(allocs, PoissonOpen(40, 0.6 * cap / 1e8, seed=1), seed=0)
    vtk._launch = real_launch
    pair = [T.allocate(spec, prof, p, spec.min_pes() * 2) for p in ("blockwise", "weight_based")]
    cap = T.simulate(spec, prof, pair[0]).images_per_sec
    vt = VirtualTimeFabric(spec, prof, device=dev)
    for key, n, co in (("exact", 5000, None), ("coarse", 40000, CoarsenConfig(tail_lanes=2))):
        vtk._stream_launch = recorder(key, real_stream)
        run_stream(vt, pair, PoissonOpen(n, 0.6 * cap / 1e8, seed=2), seed=3, coarsen=co)
    vtk._stream_launch = real_stream
    torch.cuda.synchronize()
    print(f"F8: {calls['f8'][0].p.variant.shape[0]} configs x {calls['f8'][0].p.n_requests} requests; streams: "
          + ", ".join(f"{k} {calls[k][0].p.n_requests} requests x {calls[k][0].p.variant.shape[0]} configs"
                      for k in ("exact", "coarse")), flush=True)
    stream_argtypes = vtk._stream_launcher().argtypes

    widths = (1, 2, 4, 8, 32, 64, 128, 256, 512, 686)
    spread = (32, 44, 51, 64, 128, 163, 217, 256, 512)
    layers = ((32, 8), (128, 4), (256, 4), (512, 2))
    mixed = ((686, 217), (686, 64), (1024, 163))
    wide = ((513, 256), (513, 64), (15, 128))
    print("round variant | cycles a job, one pool of d servers: " + " ".join(f"{d}" for d in widths)
          + " | at the cells' spread: " + " ".join(f"{d}" for d in spread)
          + " | the same, one request of 32,768 jobs (steady) | the deep inserts' share, 1,024 / 32,768 jobs"
          + " | the same, 20 to 400: " + " ".join(f"{d}" for d in widths)
          + " | a layer of k pools of d: " + " ".join(f"{d}x{k}" for d, k in layers)
          + " | a layer of two pools, the cells' spread: " + " ".join(f"{a}+{b}" for a, b in mixed)
          + " | ms of a launch, C configs of up to d servers: " + " ".join(f"{c}<={d}" for c, d in wide)
          + ", the first two at the cells' spread"
          + " | ms of F8's launch | ms of the exact and the coarsened stream", flush=True)
    for rnd in range(2):
        for name, lib in libs.items():
            so = ctypes.CDLL(str(lib))
            fn, fs = so.vtime_scan_launch, so.vtime_stream_launch
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fs.argtypes, fs.restype = stream_argtypes, ctypes.c_int
            vtk._launcher, vtk._stream_launcher = (lambda fn=fn: fn), (lambda fs=fs: fs)
            vtk._clusters.cache_clear()
            row = [cycles(d, key=("wide", d)) for d in widths] + [cycles(d, pools=k) for d, k in layers]
            two = [cycles(m, spread=True) for m in mixed]
            narrow = [cycles(d, spread=True, key=("spread", d)) for d in spread]
            steady = [cycles(d, spread=True, P=32768, n=2, key=("steady", d)) for d in spread]
            ms = [many(c, d) for c, d in wide] + [many(c, d, spread=True) for c, d in wide[:2]]
            f8 = timed(lambda: vtk._launch(*calls["f8"]))
            st = [timed(lambda k=k: vtk._stream_launch(*calls[k]), reps=1) for k in ("exact", "coarse")]
            print(f"{rnd} {name} | " + " ".join(f"{c:.1f}" for c in row[: len(widths)]) + " | "
                  + " ".join(f"{c:.1f}" for c in narrow) + " | steady " + " ".join(f"{c:.1f}" for c in steady)
                  + " | deep " + " ".join(f"{deep_share[('spread', d)]:.3f}/{deep_share[('steady', d)]:.3f}"
                                          for d in spread)
                  + " | deep, 20 to 400 " + " ".join(f"{deep_share[('wide', d)]:.3f}" for d in widths) + " | "
                  + " ".join(f"{c:.1f}" for c in row[len(widths):]) + " | "
                  + " ".join(f"{c:.1f}" for c in two) + " | "
                  + " ".join(f"{m:.3f} (S {s}, KMAX {k})" for m, s, k in ms)
                  + f" | {f8:.3f} (S {calls['f8'][0].plan.stages}) | " + " ".join(f"{m:.1f}" for m in st),
                  flush=True)
    print("VARIANTS OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
