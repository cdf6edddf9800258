// K2: fused greedy allocate + replica scatter + throughput eval, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel fused_alloc_eval_kernel
// (src/repro/kernels/fused_alloc_eval.py:48), which walked blocks of configs
// on one TPU core with the bank stacks and the one-hot unit map resident in
// VMEM.
//
// For every config c it computes, in its own body:
//   1. the lock-step greedy of core/alloc/greedy.py (greedy_batch_kernel) on
//      the allocation bases of variant a_idx[c], from warm start r0[c]:
//      80 bisection steps on the makespan target, then the residual loop that
//      grants the argmax-latency unit (lowest index on ties) until the
//      slowest unit is unaffordable;
//   2. the scatter of the unit replicas onto the (L, B) replica matrix:
//      dups[l, b] = 1 + (r[u] - 1) for the unit u covering cell (l, b), and 1
//      where no unit covers it (the reference's one-hot product, which is
//      exact, written as a direct read through a per-cell unit index);
//   3. the _eval_kernel formulas (core/cim/simulate.py) on bank slot sel[c]:
//      per-layer makespan (layer-wise barrier or independent blocks), the
//      total cycles T, images/s and per-layer utilization.
// In:  base (A, N), cost (N), cell_unit (L*B) int32 (-1 = uncovered),
//      mean / max (V, L, B), pm_mean / pm_max / busy (V, L), b_mask (L, B)
//      uint8, ppi / width / layer_arrays (L); per config budget (C),
//      a_idx (C) int32, sel (C) int32, layerwise (C) uint8, r0 (C, N).
// Out: T, ips, rem (C), layer_T, util (C, L), r (C, N).  All float64.
//
// Exactness.  Every operation is an IEEE double operation in the
// reference's order: '/' and ceil() are correctly rounded, and the products
// that feed sums are written __dmul_rn / __dadd_rn so that nvcc cannot
// contract them into fused multiply-adds (the build keeps -fmad at its
// default; the intrinsics pin these sites).  The sums (bisection spend,
// alive arrays) add integer-valued doubles below 2^53, which are exact in
// any order, so the warp-shuffle sums equal the reference's; each sum is
// broadcast from lane 0 so that every branch is warp-uniform.  The residual
// loop keeps each unit's latency base / r and recomputes only the granted
// unit's: the same double, computed once per grant instead of N times.
//
// What bounds it: FP64 operations.  The bisection alone does about
// 80 * N * 6 double operations per config (a division, ceil, max, subtract,
// multiply and add per unit and step), about 1.2e5 for ResNet18's 247 block
// units, against about 4.3 KB read and written per config.  The division is
// itself a sequence of about ten FMA-class instructions, which the bound
// counts as one operation.  The design keeps that arithmetic fed:
//   * one warp per config, lanes strided over the N units; for N <= 256 the
//     kernel is templated on the units a lane holds (ceil(N / 32) <= 8) and
//     keeps each unit's base, warm start, cost, replicas and latency in
//     registers for the 80 steps and the residual loop (a larger N reads
//     them from memory at every step, its replicas kept in the output row);
//   * one correctly rounded reciprocal of the water level per bisection
//     step, and per unit its quotient from two exact FMA corrections
//     (quot(): bit-identical to '/', five FP64 operations in place of a
//     division's ten or so; the steps whose level lies outside the range
//     where that is proven divide);
//   * persistent blocks of 16 warps (32 where a lane holds one unit), one
//     per SM, each warp taking the next config from a counter
//     (the two zeroed ints of the wrapper's work queue), so FP64 latency is
//     hidden by the configs in flight and configs whose residual loops
//     differ in length balance out;
//   * the eval's tables (the bank stacks, the per-layer vectors, the unit
//     index and mask of the cells) staged in shared memory once per block
//     when they fit beside the warps' replica rows (the wrapper decides; else
//     they are read from global memory, where they stay in L2), and each
//     warp's replicas in a shared row for the scatter.
//
// The kernel allocates nothing and does not synchronise; it runs on the
// caller's stream.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // the most shared memory a block may use

struct Args {
  const double* base;        // (A, N)
  const double* cost;        // (N)
  const int32_t* cell_unit;  // (L * B)
  const double* mean;        // (V, L, B)
  const double* maxb;        // (V, L, B)
  const double* pmn;         // (V, L)
  const double* pmx;         // (V, L)
  const double* busy;        // (V, L)
  const uint8_t* bmask;      // (L, B)
  const double* ppi;         // (L)
  const double* width;       // (L)
  const double* larr;        // (L)
  const double* budget;      // (C)
  const int32_t* a_idx;      // (C)
  const int32_t* sel;        // (C)
  const uint8_t* lw;         // (C)
  const double* r0;          // (C, N)
  double* T;                 // (C)
  double* ips;               // (C)
  double* layer_T;           // (C, L)
  double* util;              // (C, L)
  double* r;                 // (C, N)
  double* rem;               // (C)
  int* sched;                // (2,) int32, zero at launch and left zero: the configs' counter
  int C, N, L, B, V, staged;
  double n_images, clock_hz;
};

// The eval's tables, in shared memory when staged: the doubles, then the
// cells' unit index, then their mask.
__host__ __device__ inline size_t staged_bytes(int V, int L, int B) {
  const size_t vlb = (size_t)V * L * B, vl = (size_t)V * L, lb = (size_t)L * B;
  return sizeof(double) * (2 * vlb + 3 * vl + 3 * (size_t)L) + sizeof(int32_t) * lb + lb;
}

// configs in flight per block, one a warp: 32 where a config holds one unit
// a lane (its steps are short; 60 registers a thread fit 1,024 threads), else
// 16 (more registers a thread)
__host__ __device__ constexpr int warps_for(int upl) { return upl == 1 ? 32 : 16; }

// the warps' replica rows (register path only)
__host__ __device__ inline size_t row_bytes(int upl, int N) {
  return upl > 0 ? sizeof(double) * warps_for(upl) * (size_t)N : 0;
}

// NaN-propagating, like torch.maximum / jnp.maximum
__device__ __forceinline__ double dmax(double a, double b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ double dmin(double a, double b) { return (a < b || a != a) ? a : b; }

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __dadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return __shfl_sync(kFull, v, 0);
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = dmax(v, __shfl_xor_sync(kFull, v, o));
  return __shfl_sync(kFull, v, 0);
}

__device__ __forceinline__ double warp_min(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = dmin(v, __shfl_xor_sync(kFull, v, o));
  return __shfl_sync(kFull, v, 0);
}

// the warp-wide argmax of (value, unit): the larger value, the lower unit on a tie
__device__ __forceinline__ void warp_argmax(double& best, int& bi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double ov = __shfl_xor_sync(kFull, best, o);
    const int oi = __shfl_xor_sync(kFull, bi, o);
    if (ov > best || (ov == best && oi < bi)) {
      best = ov;
      bi = oi;
    }
  }
}

// b / m correctly rounded, from rcp = RN(1 / m): q0 = RN(b rcp) is within 2
// ulps of b / m; one correction q0 + (b - q0 m) rcp (the remainder exact in
// an FMA) brings it within half an ulp plus 2^-104 of it, so faithful; a
// second is then RN(b / m) by Markstein's theorem (y = RN(1 / m), q faithful,
// no overflow or underflow: the caller keeps b / m and m in [2^-1000, 2^1000]
// or b = 0, where every step gives 0).  Five FP64 operations in place of a
// division's reciprocal refinement per unit.
__device__ __forceinline__ double quot(double b, double m, double rcp) {
  double q = __dmul_rn(b, rcp);
  q = __fma_rn(__fma_rn(-q, m, b), rcp, q);
  return __fma_rn(__fma_rn(-q, m, b), rcp, q);
}

struct Tables {
  const double *mean, *maxb, *pmn, *pmx, *busy, *ppi, *width, *larr;
  const int32_t* cell_unit;
  const uint8_t* bmask;
};

// 1. the greedy for config c, units held in registers (UPL units a lane:
// unit lane + 32 t); leaves the replicas in `rrow` (shared) and the output
// row, and returns the leftover budget
template <int UPL>
__device__ __forceinline__ double greedy_regs(const Args& a, long long c, int lane, double* rrow) {
  const int N = a.N;
  const double* base = a.base + (long long)a.a_idx[c] * N;
  const double* r0p = a.r0 + c * N;
  const double budget = a.budget[c];
  // units past N are neutral: base 0, warm start 1, cost 0 (they add 0 to
  // every spend and are never the argmax)
  double bs[UPL], r0[UPL], co[UPL], r[UPL], lat[UPL];
  double hi = -INFINITY, min_cost = INFINITY, b_max = 0.0, b_min = INFINITY;
#pragma unroll
  for (int t = 0; t < UPL; ++t) {
    const int u = lane + 32 * t;
    const bool live = u < N;
    bs[t] = live ? base[u] : 0.0;
    r0[t] = live ? r0p[u] : 1.0;
    co[t] = live ? a.cost[u] : 0.0;
    if (live) {
      hi = dmax(hi, bs[t] / r0[t]);
      min_cost = dmin(min_cost, co[t]);
    }
    b_max = fmax(b_max, fabs(bs[t]));
    if (bs[t] != 0.0) b_min = fmin(b_min, fabs(bs[t]));
  }
  // ---- 1a. bisection bracket: hi = max_i base_i / r0_i, lo provably infeasible
  hi = dmax(warp_max(hi), 1e-300);  // degenerate all-zero rows
  min_cost = warp_min(min_cost);
  double lo = hi / (2.0 * (2.0 + dmax(budget, 0.0) / min_cost));
  // levels at which quot() is exact for every unit: each nonzero base / mid
  // and mid itself in [2^-1000, 2^1000] (any real bracket; others divide)
  const double fast_lo = fmax(0x1p-1000, warp_max(b_max) * 0x1p-1000);
  const double fast_hi = fmin(0x1p1000, warp_min(b_min) * 0x1p1000);

  // ---- 1b. 80 bisection steps: the tightest affordable water level
  for (int it = 0; it < 80; ++it) {
    const double mid = 0.5 * (lo + hi);
    double spend = 0.0;
    if (mid >= fast_lo && mid <= fast_hi) {  // the same for every lane
      const double rcp = __drcp_rn(mid);
      // (max(r0, c) - r0) cost summed as (x + |x|) cost with x = c - r0:
      // x + |x| is 2 max(x, 0) exactly and doubling commutes with every
      // rounding here, so half the sum is the reference's, bit for bit,
      // without max's two compares
      double twice = 0.0;
#pragma unroll
      for (int t = 0; t < UPL; ++t) {
        const double x = ceil(quot(bs[t], mid, rcp)) - r0[t];
        twice = __dadd_rn(twice, __dmul_rn(__dadd_rn(x, fabs(x)), co[t]));
      }
      spend = 0.5 * twice;
    } else {
#pragma unroll
      for (int t = 0; t < UPL; ++t) {
        const double ru = dmax(r0[t], ceil(bs[t] / mid));
        spend = __dadd_rn(spend, __dmul_rn(ru - r0[t], co[t]));
      }
    }
    if (warp_sum(spend) <= budget) {
      hi = mid;
    } else {
      lo = mid;
    }
  }
  // back off 1e-9 relative: grants within roundoff of the boundary go to 1c
  const double lam = hi * (1.0 + 1e-9);
  double spent = 0.0;
#pragma unroll
  for (int t = 0; t < UPL; ++t) {
    r[t] = dmax(r0[t], ceil(bs[t] / lam));
    spent = __dadd_rn(spent, __dmul_rn(r[t] - r0[t], co[t]));
    lat[t] = lane + 32 * t < N ? bs[t] / r[t] : -INFINITY;
  }
  double rem = budget - warp_sum(spent);

  // ---- 1c. residual loop: grant the argmax-latency unit while affordable
  for (;;) {
    double best = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int t = 0; t < UPL; ++t) {
      if (lane + 32 * t < N && (bi == INT_MAX || lat[t] > best)) {  // strict: the first maximum
        best = lat[t];
        bi = lane + 32 * t;
      }
    }
    warp_argmax(best, bi);
    const double ci = a.cost[bi];
    if (!(ci <= rem)) break;  // the slowest unit is unaffordable: final
    if ((bi & 31) == lane) {
#pragma unroll
      for (int t = 0; t < UPL; ++t) {
        if (t == (bi >> 5)) {
          r[t] += 1.0;
          lat[t] = bs[t] / r[t];
        }
      }
    }
    rem -= ci;
  }
  double* rout = a.r + c * N;
#pragma unroll
  for (int t = 0; t < UPL; ++t) {
    const int u = lane + 32 * t;
    if (u < N) {
      rrow[u] = r[t];
      rout[u] = r[t];
    }
  }
  __syncwarp();  // every lane's replicas are visible to the warp's scatter
  return rem;
}

// 1. the greedy for config c with the units read from memory at every step
// (any N); the replicas live in the output row.  Lane k owns units k, k + 32, ...
__device__ __forceinline__ double greedy_mem(const Args& a, long long c, int lane) {
  const int N = a.N;
  const double* base = a.base + (long long)a.a_idx[c] * N;
  const double* r0 = a.r0 + c * N;
  const double* cost = a.cost;
  double* r = a.r + c * N;
  const double budget = a.budget[c];

  double hi = -INFINITY, min_cost = INFINITY;
  for (int u = lane; u < N; u += 32) {
    hi = dmax(hi, base[u] / r0[u]);
    min_cost = dmin(min_cost, cost[u]);
  }
  hi = dmax(warp_max(hi), 1e-300);
  min_cost = warp_min(min_cost);
  double lo = hi / (2.0 * (2.0 + dmax(budget, 0.0) / min_cost));
  for (int it = 0; it < 80; ++it) {
    const double mid = 0.5 * (lo + hi);
    double spend = 0.0;
    for (int u = lane; u < N; u += 32) {
      const double ru = dmax(r0[u], ceil(base[u] / mid));
      spend = __dadd_rn(spend, __dmul_rn(ru - r0[u], cost[u]));
    }
    if (warp_sum(spend) <= budget) {
      hi = mid;
    } else {
      lo = mid;
    }
  }
  const double lam = hi * (1.0 + 1e-9);
  double spent = 0.0;
  for (int u = lane; u < N; u += 32) {
    const double ru = dmax(r0[u], ceil(base[u] / lam));
    r[u] = ru;
    spent = __dadd_rn(spent, __dmul_rn(ru - r0[u], cost[u]));
  }
  double rem = budget - warp_sum(spent);
  for (;;) {
    double best = -INFINITY;
    int bi = INT_MAX;
    for (int u = lane; u < N; u += 32) {
      const double lat = base[u] / r[u];
      if (bi == INT_MAX || lat > best) {
        best = lat;
        bi = u;
      }
    }
    warp_argmax(best, bi);
    const double ci = cost[bi];
    if (!(ci <= rem)) break;
    if ((bi & 31) == lane) r[bi] += 1.0;
    rem -= ci;
  }
  __syncwarp();  // every lane's replica writes are visible to the warp below
  return rem;
}

// 2 + 3. scatter and eval of config c from its replicas `rr`; lane k takes
// layers k, k + 32, ...
__device__ __forceinline__ void scatter_eval(const Args& a, const Tables& tb, long long c, int lane,
                                             const double* rr, double rem) {
  const int L = a.L, B = a.B;
  const long long s = a.sel[c];
  const bool lw = a.lw[c] != 0;
  double* layer_T = a.layer_T + c * L;
  double* util = a.util + c * L;
  double t_max = -INFINITY;
  for (int l = lane; l < L; l += 32) {
    const double p = tb.ppi[l] * a.n_images;
    const int32_t* cu = tb.cell_unit + (long long)l * B;
    double lt, alive;
    if (lw) {
      const double d_layer = cu[0] < 0 ? 1.0 : 1.0 + (rr[cu[0]] - 1.0);
      lt = dmax(tb.pmn[s * L + l] * p / d_layer, tb.pmx[s * L + l]);
      alive = tb.larr[l] * d_layer;
    } else {
      const double* mean = tb.mean + (s * L + l) * B;
      const double* maxb = tb.maxb + (s * L + l) * B;
      lt = -INFINITY;
      alive = 0.0;
      for (int b = 0; b < B; ++b) {
        if (!tb.bmask[(long long)l * B + b]) continue;
        const double d = cu[b] < 0 ? 1.0 : 1.0 + (rr[cu[b]] - 1.0);
        lt = dmax(lt, dmax(mean[b] * p / d, maxb[b]));
        alive = __dadd_rn(alive, __dmul_rn(d, tb.width[l]));
      }
    }
    layer_T[l] = lt;
    util[l] = alive;  // scratch until T is known
    t_max = dmax(t_max, lt);
  }
  const double T = warp_max(t_max);
  for (int l = lane; l < L; l += 32) {
    const double busy_c = tb.busy[s * L + l] * (tb.ppi[l] * a.n_images) * tb.width[l];
    util[l] = busy_c / (util[l] * T);
  }
  if (lane == 0) {
    a.rem[c] = rem;
    a.T[c] = T;
    a.ips[c] = a.n_images / (T / a.clock_hz);
  }
}

template <typename E>
__device__ __forceinline__ E* stage_copy(uint8_t*& dst, const E* src, size_t n) {
  E* out = reinterpret_cast<E*>(dst);
  for (size_t k = threadIdx.x; k < n; k += blockDim.x) out[k] = src[k];
  dst += n * sizeof(E);
  return out;
}

// UPL: units a lane holds in registers (N <= 32 UPL); 0: any N, from memory
template <int UPL>
__global__ void __launch_bounds__(warps_for(UPL) * 32, 1) fused_alloc_eval_kernel(const Args a) {
  constexpr int kWarps = warps_for(UPL);
  extern __shared__ double smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double* rrow = smem + (size_t)warp * a.N;  // this warp's replicas (UPL > 0)
  Tables tb{a.mean, a.maxb, a.pmn, a.pmx, a.busy, a.ppi, a.width, a.larr, a.cell_unit, a.bmask};
  if (a.staged) {  // the same for every thread of the block
    uint8_t* dst = reinterpret_cast<uint8_t*>(smem) + row_bytes(UPL, a.N);
    const size_t vlb = (size_t)a.V * a.L * a.B, vl = (size_t)a.V * a.L, lb = (size_t)a.L * a.B;
    tb.mean = stage_copy(dst, a.mean, vlb);
    tb.maxb = stage_copy(dst, a.maxb, vlb);
    tb.pmn = stage_copy(dst, a.pmn, vl);
    tb.pmx = stage_copy(dst, a.pmx, vl);
    tb.busy = stage_copy(dst, a.busy, vl);
    tb.ppi = stage_copy(dst, a.ppi, (size_t)a.L);
    tb.width = stage_copy(dst, a.width, (size_t)a.L);
    tb.larr = stage_copy(dst, a.larr, (size_t)a.L);
    tb.cell_unit = stage_copy(dst, a.cell_unit, lb);
    tb.bmask = stage_copy(dst, a.bmask, lb);
    __syncthreads();
  }
  // Warp w of block b starts on config b * kWarps + w; each later config is
  // the number of warps plus a ticket from sched[0].  Every warp that starts
  // on a config takes exactly one ticket past C (its last); the warp that
  // takes the last of those resets the counter to 0 for the next launch.
  const int warps = (int)gridDim.x * kWarps;
  const int starters = warps < a.C ? warps : a.C;
  int c = (int)blockIdx.x * kWarps + warp;
  while (c < a.C) {
    double rem;
    if constexpr (UPL > 0) {
      rem = greedy_regs<UPL>(a, c, lane, rrow);
      scatter_eval(a, tb, c, lane, rrow, rem);
      __syncwarp();  // the scatter has read this warp's replica row
    } else {
      rem = greedy_mem(a, c, lane);
      scatter_eval(a, tb, c, lane, a.r + (long long)c * a.N, rem);
    }
    int next = 0;
    if (lane == 0) {
      next = atomicAdd(a.sched, 1) + warps;
      if (next >= a.C && atomicAdd(a.sched + 1, 1) == starters - 1) {
        atomicExch(a.sched, 0);
        atomicExch(a.sched + 1, 0);
      }
    }
    c = __shfl_sync(kFull, next, 0);
  }
}

int sm_count(int device) {
  static int cache[64] = {};
  if (device < 0 || device >= 64) return 0;
  if (cache[device] == 0 && cudaDeviceGetAttribute(&cache[device], cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    cache[device] = 0;
  return cache[device];
}

template <int UPL>
int launch(const Args& a, size_t smem, int device, cudaStream_t stream) {
  static size_t smem_set[64] = {};  // the shared-memory limit raised so far, per device
  if (smem > 48 * 1024 && smem > smem_set[device]) {
    cudaError_t e = cudaFuncSetAttribute(fused_alloc_eval_kernel<UPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set[device] = smem;
  }
  const int sms = sm_count(device);
  constexpr int kWarps = warps_for(UPL);
  const long long blocks = ((long long)a.C + kWarps - 1) / kWarps;
  fused_alloc_eval_kernel<UPL><<<(unsigned)(blocks < sms ? blocks : sms), kWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a launch at (N, V, L, B) needs: the warps'
// replica rows (N <= 256) and, when `staged`, the eval's tables.
extern "C" long long fused_alloc_eval_smem_bytes(int N, int V, int L, int B, int staged) {
  const int upl = N <= 256 ? (N + 31) / 32 : 0;
  return (long long)(row_bytes(upl, N) + (staged ? staged_bytes(V, L, B) : 0));
}

// Plain C entry point, loaded with ctypes.  Pointers are device pointers of
// contiguous tensors on `device`; `stream` is a cudaStream_t; `sched` two
// int32 that are 0, and stay 0 after the launch (the configs' counter; one
// pair per stream); `staged` 1 stages the eval's tables in shared memory
// (the caller has checked that they fit).  The caller has checked the
// indices (a_idx < A, sel < V, cell_unit < N), that cost > 0 and that every
// budget is finite.  Returns cudaGetLastError() after the launch (0 when
// the launch was accepted).
extern "C" int fused_alloc_eval_launch(
    const void* base, const void* cost, const void* cell_unit, const void* mean,
    const void* maxb, const void* pmn, const void* pmx, const void* busy, const void* bmask,
    const void* ppi, const void* width, const void* larr, const void* budget,
    const void* a_idx, const void* sel, const void* lw, const void* r0, void* T, void* ips,
    void* layer_T, void* util, void* r, void* rem, long long C, int N, int L, int B, int V,
    int staged, double n_images, double clock_hz, int* sched, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C == 0) return 0;
  if (C > INT_MAX - 4096 || N < 1 || sm_count(device) == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)fused_alloc_eval_smem_bytes(N, V, L, B, staged);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  Args a;
  a.base = static_cast<const double*>(base);
  a.cost = static_cast<const double*>(cost);
  a.cell_unit = static_cast<const int32_t*>(cell_unit);
  a.mean = static_cast<const double*>(mean);
  a.maxb = static_cast<const double*>(maxb);
  a.pmn = static_cast<const double*>(pmn);
  a.pmx = static_cast<const double*>(pmx);
  a.busy = static_cast<const double*>(busy);
  a.bmask = static_cast<const uint8_t*>(bmask);
  a.ppi = static_cast<const double*>(ppi);
  a.width = static_cast<const double*>(width);
  a.larr = static_cast<const double*>(larr);
  a.budget = static_cast<const double*>(budget);
  a.a_idx = static_cast<const int32_t*>(a_idx);
  a.sel = static_cast<const int32_t*>(sel);
  a.lw = static_cast<const uint8_t*>(lw);
  a.r0 = static_cast<const double*>(r0);
  a.T = static_cast<double*>(T);
  a.ips = static_cast<double*>(ips);
  a.layer_T = static_cast<double*>(layer_T);
  a.util = static_cast<double*>(util);
  a.r = static_cast<double*>(r);
  a.rem = static_cast<double*>(rem);
  a.sched = sched;
  a.C = (int)C;
  a.N = N;
  a.L = L;
  a.B = B;
  a.V = V;
  a.staged = staged != 0;
  a.n_images = n_images;
  a.clock_hz = clock_hz;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (N <= 256 ? (N + 31) / 32 : 0) {
    case 1: return launch<1>(a, smem, device, s);
    case 2: return launch<2>(a, smem, device, s);
    case 3: return launch<3>(a, smem, device, s);
    case 4: return launch<4>(a, smem, device, s);
    case 5: return launch<5>(a, smem, device, s);
    case 6: return launch<6>(a, smem, device, s);
    case 7: return launch<7>(a, smem, device, s);
    case 8: return launch<8>(a, smem, device, s);
    default: return launch<0>(a, smem, device, s);
  }
}
