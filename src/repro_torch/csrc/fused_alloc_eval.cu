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
// broadcast from lane 0 so that every branch is warp-uniform.
//
// What bounds it: FP64 operations.  The bisection alone does about
// 80 * N * 6 double operations per config (a division, ceil, max, subtract,
// multiply and add per unit and step; the division is itself a short
// sequence of FMAs), about 1.2e5 for ResNet18's 247 block units, against
// about 4.3 KB read and written per config.  The design keeps everything in
// registers and L1/L2 rather than staging it: one warp per config, lanes
// strided over the N units for the greedy and over the L layers for the
// eval; the per-config state (replicas) lives in the output row itself, and
// the small bank stacks (V * L * B doubles) are read from global memory,
// where they stay in L2.  Staging the banks and bases in shared memory and
// one persistent block per SM are left for a later change.
//
// The kernel allocates nothing and does not synchronise; it runs on the
// caller's stream.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

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
  long long C;
  int N, L, B;
  double n_images, clock_hz;
};

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

__global__ void __launch_bounds__(kWarpsPerBlock * 32) fused_alloc_eval_kernel(const Args a) {
  const long long c = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= a.C) return;  // the same for every lane of a warp
  const int N = a.N, L = a.L, B = a.B;
  const double* base = a.base + (long long)a.a_idx[c] * N;
  const double* r0 = a.r0 + c * N;
  const double* cost = a.cost;
  double* r = a.r + c * N;
  const double budget = a.budget[c];

  // ---- 1a. bisection bracket: hi = max_i base_i / r0_i, lo provably infeasible
  double hi = -INFINITY, min_cost = INFINITY;
  for (int u = lane; u < N; u += 32) {
    hi = dmax(hi, base[u] / r0[u]);
    min_cost = dmin(min_cost, cost[u]);
  }
  hi = dmax(warp_max(hi), 1e-300);  // degenerate all-zero rows
  min_cost = warp_min(min_cost);
  double lo = hi / (2.0 * (2.0 + dmax(budget, 0.0) / min_cost));

  // ---- 1b. 80 bisection steps: the tightest affordable water level
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
  // back off 1e-9 relative: grants within roundoff of the boundary go to 1c
  const double lam = hi * (1.0 + 1e-9);
  double spent = 0.0;
  for (int u = lane; u < N; u += 32) {
    const double ru = dmax(r0[u], ceil(base[u] / lam));
    r[u] = ru;
    spent = __dadd_rn(spent, __dmul_rn(ru - r0[u], cost[u]));
  }
  double rem = budget - warp_sum(spent);

  // ---- 1c. residual loop: grant the argmax-latency unit while affordable.
  // Lane k owns units k, k + 32, ...; only the owner reads or writes r[u].
  for (;;) {
    double best = -INFINITY;
    int bi = INT_MAX;
    for (int u = lane; u < N; u += 32) {
      const double lat = base[u] / r[u];
      if (bi == INT_MAX || lat > best) {  // strict: the first maximum
        best = lat;
        bi = u;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const double ov = __shfl_xor_sync(kFull, best, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (ov > best || (ov == best && oi < bi)) {  // lower index wins a tie
        best = ov;
        bi = oi;
      }
    }
    const double ci = cost[bi];
    if (!(ci <= rem)) break;  // the slowest unit is unaffordable: final
    if ((bi & 31) == lane) r[bi] += 1.0;
    rem -= ci;
  }
  __syncwarp();  // every lane's replica writes are visible to the warp below
  if (lane == 0) a.rem[c] = rem;

  // ---- 2 + 3. scatter and eval; lane k takes layers k, k + 32, ...
  const long long s = a.sel[c];
  const bool lw = a.lw[c] != 0;
  double* layer_T = a.layer_T + c * L;
  double* util = a.util + c * L;
  double t_max = -INFINITY;
  for (int l = lane; l < L; l += 32) {
    const double p = a.ppi[l] * a.n_images;
    const int32_t* cu = a.cell_unit + (long long)l * B;
    double lt, alive;
    if (lw) {
      const double d_layer = cu[0] < 0 ? 1.0 : 1.0 + (r[cu[0]] - 1.0);
      lt = dmax(a.pmn[s * L + l] * p / d_layer, a.pmx[s * L + l]);
      alive = a.larr[l] * d_layer;
    } else {
      const double* mean = a.mean + (s * L + l) * B;
      const double* maxb = a.maxb + (s * L + l) * B;
      lt = -INFINITY;
      alive = 0.0;
      for (int b = 0; b < B; ++b) {
        if (!a.bmask[(long long)l * B + b]) continue;
        const double d = cu[b] < 0 ? 1.0 : 1.0 + (r[cu[b]] - 1.0);
        lt = dmax(lt, dmax(mean[b] * p / d, maxb[b]));
        alive = __dadd_rn(alive, __dmul_rn(d, a.width[l]));
      }
    }
    layer_T[l] = lt;
    util[l] = alive;  // scratch until T is known
    t_max = dmax(t_max, lt);
  }
  const double T = warp_max(t_max);
  for (int l = lane; l < L; l += 32) {
    const double busy_c = a.busy[s * L + l] * (a.ppi[l] * a.n_images) * a.width[l];
    util[l] = busy_c / (util[l] * T);
  }
  if (lane == 0) {
    a.T[c] = T;
    a.ips[c] = a.n_images / (T / a.clock_hz);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Pointers are device pointers of
// contiguous tensors on `device`; `stream` is a cudaStream_t.  The caller
// has checked the indices (a_idx < A, sel < V, cell_unit < N), that cost > 0
// and that every budget is finite.  Returns cudaGetLastError() after the
// launch (0 when the launch was accepted).
extern "C" int fused_alloc_eval_launch(
    const void* base, const void* cost, const void* cell_unit, const void* mean,
    const void* maxb, const void* pmn, const void* pmx, const void* busy, const void* bmask,
    const void* ppi, const void* width, const void* larr, const void* budget,
    const void* a_idx, const void* sel, const void* lw, const void* r0, void* T, void* ips,
    void* layer_T, void* util, void* r, void* rem, long long C, int N, int L, int B,
    double n_images, double clock_hz, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C == 0) return 0;
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
  a.C = C;
  a.N = N;
  a.L = L;
  a.B = B;
  a.n_images = n_images;
  a.clock_hz = clock_hz;
  const long long grid = (C + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_alloc_eval_kernel<<<(unsigned)grid, kWarpsPerBlock * 32, 0,
                            reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
