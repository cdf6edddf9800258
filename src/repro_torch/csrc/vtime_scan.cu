// VT: the virtual-time scan of the fabric engines, for Hopper (sm_90a).
//
// No Pallas kernel of the reference does this: it is the counterpart of the
// reference's batched virtual-time engine, one jax.jit(jax.vmap(...)) of
// run_fabric_kernel per sub-batch (src/repro/fabric/vtime.py:629-674), whose
// loop over requests and jobs is a lax.scan that runs on the device.  In
// eager PyTorch that recurrence would cost five to seven kernel launches a
// job; here it is one launch for every (allocation, trace) pair of a call.
//
// What it computes, for config c (one allocation with its arrival trace):
// requests r = 0..N-1 in order run through layers l = 0..L-1.  Layer l has
// B_l FIFO server pools; pool p holds lanes[c, pool] servers, whose
// free-times are kept as a sorted multiset (+inf marks an absent server).
// Request r enters layer l at t (after the stage transfer xfer[c, l], when
// given) and brings one job per patch j < P_l to every pool, with service
// time svc = table_l[variant[c]][idx_l[r, j], p].  Every free-time is first
// clamped to t; each job then takes the earliest-free server:
//     end = f_0 + svc,   f_i <- min(max(f_i, end), f_{i+1})   (f_D = +inf)
// (vtime.dispatch_step, a sorted insert of `end`).  The layer's completion is
// the largest end over the pools that have servers, and at least t; it is
// the request's ready time at layer l+1.  Open loop: request r arrives at
// arrivals[c, r].  Closed loop: it enters at the completion of request
// r - conc, and the first conc requests at 0.
// Out: t_arr, comp (C, N); with STATS, per layer the service cycles
// dispatched (busy) and the queue waits f_0 - t (wait), (C, L).
//
// Exactness.  Completions are bit-identical to the reference's engines:
// every operation is an IEEE double add (__dadd_rn), min or max, in the
// reference's order per job, and max is exact in any order.  Pools with no
// servers (the layer-wise dataflow's pools 1.. in the fused sweep's variant
// table) hold only +inf lanes, which no job changes, so they are skipped.
// The busy and wait sums are taken per thread, then per warp, then per
// block, an order other than the reference's: they agree to rtol 1e-12.
// The library is compiled with --fmad=false besides.
//
// What bounds it: latency.  The jobs of one pool are a serial chain (each
// takes lane 0 of the state the previous one left), and the layers of one
// request are serial, so a config is one chain of sum_l P_l jobs a request;
// the configs are independent.  A job costs one dependent FP64 add and a
// min on that chain: service times are >= 0 (the wrapper checks), so the
// job's end is >= lane 0 and lane 0's sorted insert is min(end, f_1).  The
// design:
//   * one block per config; the pools of a layer run in parallel, with a
//     __syncthreads per staged chunk and one per (request, layer), for the
//     layer's completion;
//   * a pool of at most 8 servers runs on one thread, its lanes in
//     registers (1, 2, 4 or 8; one server is a plain running sum); a wider
//     pool runs on a whole warp, 1 to 16 lanes a thread, lane 0 broadcast
//     by a shuffle and each thread's upper neighbour lane by another; the
//     kernel is built for the widest pool of a launch (KMAX 1, 4, 16, or 32
//     lanes a thread), so narrower launches keep fewer registers;
//   * min and max are a compare and a select (fmin / fmax add NaN handling,
//     four instructions each; there are no NaNs here);
//   * the service times are staged in shared memory a chunk of jobs at a
//     time by the whole block (every (job, pool) load of the chunk in
//     flight together: the sample index, then the cycle row, read across
//     the pools of a layer at neighbouring addresses), in two alternating
//     buffers; a pool's thread reads the next 8 jobs' times ahead;
//   * each config's pool state (a power of two of lanes a pool, at least 32
//     for a warp's) lives in shared memory when it fits, else in a global
//     scratch row per config;
//   * a pool wider than 512 servers (more than a warp's registers hold)
//     runs, in the build for such launches (KMAX 32), on a warp with its
//     lanes in that state memory: the warp reads
//     lane 0 for the job's end and rewrites the sorted insert a row of 32
//     lanes at a time, stopping at the first row that the end does not
//     reach (every lane above it is >= end and keeps its value).  Its cost
//     a job grows with the insert's position, not with the pool's width
//     alone.  A pool may hold up to 65,536 servers.
// A launch fills one SM per config; a call with few configs leaves the
// card mostly idle, in the nature of a per-config serial recurrence.
//
// The second entry, vtime_stream_launch, is the streaming replay of the
// fleet (the reference's _run_stream_kernel, src/repro/fabric/fleet.py:
// 104-164): the same pool code over a segment of requests whose service
// indices are hashed in the kernel (fabric.vtime.hash_service_indices) or
// read from presampled tables, whose jobs may be coarsened into macro-jobs
// (vtime._chunk_services, a left fold of K patches), whose latencies fold
// into a log-bucket sketch, min / max and Welford moments
// (fabric.metrics.sketch_update), and whose lane state, closed-loop ring,
// sketch and horizon come from the caller and go back to it, so that one
// launch continues the previous one.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 64;
constexpr int kMaxPools = 1024;
constexpr int kMaxThreads = 512;
constexpr int kSmallPool = 8;  // pools of at most this many servers run on one thread
constexpr int kWarpLanes = 512;  // the widest pool a warp holds in registers (16 lanes a thread)
constexpr int kAhead = 8;  // jobs whose service times are read ahead
constexpr size_t kMaxSmem = 232448;  // the most shared memory a block may use
constexpr size_t kStaticSmem = 12 * 1024;  // room kept for the kernel's own shared arrays

struct Args {
  const double* tables;     // per layer, per variant: (S_l, B_l) row-major
  const long long* tbl_off; // (L, V) offsets into tables
  const long long* meta;    // (L, 4): B_l, P_l, pool offset, offset into idx
  const int32_t* idx;       // per layer (N, P_l) sample indices, layer-major
  const int32_t* variant;   // (C)
  const int32_t* lanes;     // (C, Ptot) servers per pool
  const double* arrivals;   // (C, N), or null for the closed loop
  const double* xfer;       // (C, L), or null
  double* t_arr;            // (C, N)
  double* comp;             // (C, N)
  double* busy;             // (C, L), STATS only
  double* wait;             // (C, L), STATS only
  double* gstate;           // (C, state_stride), when the state is not in shared memory
  long long state_stride;   // doubles of pool state a config
  int N, L, V, Ptot, conc;  // conc 0: open loop
  int chunk;                // doubles of service times staged at a time (>= every B_l)
  int consumer_warps;       // warps that run the pools; the rest stage service times
  int smem_state;
};

// min and max of non-NaN doubles as a compare and a select: the reference's
// np.minimum / np.maximum on these values, without fmin's NaN handling
__device__ __forceinline__ double dmin(double a, double b) { return b < a ? b : a; }
__device__ __forceinline__ double dmax(double a, double b) { return b > a ? b : a; }

__device__ __forceinline__ int pow2_ceil(int d) { return d <= 1 ? 1 : 1 << (32 - __clz(d - 1)); }

// lanes of state a pool holds: a power of two for a small pool (one thread),
// 32 lanes or more for a pool a warp runs
__device__ __forceinline__ int pool_cap(int d) {
  return d == 0 ? 0 : d <= kSmallPool ? pow2_ceil(d) : max(32, pow2_ceil(d));
}

// A small pool's jobs j < nj of a chunk on one thread, K lanes in registers;
// job j's service time is sv[j * B].  The service times are >= 0 (the
// wrapper checks), so end = f_0 + s >= f_0 and the sorted insert's lane 0 is
// min(end, f_1), exactly; with one server the lane is end itself and the
// ends only grow, so the last is the largest.  Jobs run 8 at a time with
// the next 8 times read ahead, unguarded, then the rest one by one.
template <int K, bool STATS>
__device__ double run_thread(double* st, const double* sv, int nj, int B, double t, double& bs, double& ws) {
  double f[K];
#pragma unroll
  for (int k = 0; k < K; ++k) f[k] = dmax(st[k], t);
  double mx = -CUDART_INF;
  auto step = [&](double s) {
    const double end = __dadd_rn(f[0], s);
    if (STATS) {
      bs = __dadd_rn(bs, s);
      ws = __dadd_rn(ws, __dsub_rn(f[0], t));
    }
    if (K == 1) {
      f[0] = end;
    } else {
      f[0] = dmin(end, f[1 % K]);
#pragma unroll
      for (int k = 1; k < K; ++k) f[k] = k + 1 < K ? dmin(dmax(f[k], end), f[(k + 1) % K]) : dmax(f[k], end);
      mx = dmax(mx, end);
    }
  };
  int j = 0;
  if (nj >= kAhead) {
    double cur[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) cur[u] = sv[u * B];
    for (; j + kAhead <= nj; j += kAhead) {
      double nxt[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) nxt[u] = j + kAhead + u < nj ? sv[(j + kAhead + u) * B] : 0.0;
#pragma unroll
      for (int u = 0; u < kAhead; ++u) step(cur[u]);
#pragma unroll
      for (int u = 0; u < kAhead; ++u) cur[u] = nxt[u];
    }
  }
  for (; j < nj; ++j) step(sv[j * B]);
  if (K == 1 && nj > 0) mx = f[0];
#pragma unroll
  for (int k = 0; k < K; ++k) st[k] = f[k];
  return mx;
}

// A wide pool's jobs of a chunk on a whole warp: lane w holds the pool's
// lanes w*K .. w*K+K-1, and every thread also keeps the pool's lanes 0 and
// 1 (z0, z1).  A job's end is z0 + s and the new lane 0 is min(end, z1) on
// every thread, so the chain is an add and a min; the new lane 1 comes from
// its owner by a shuffle that overlaps the next job's add, and each
// thread's upper neighbour lane (old value) by another.  Every thread
// computes the same end, so the warp's maximum is uniform.
template <int K, bool STATS>
__device__ double run_warp(double* st, const double* sv, int nj, int B, double t, int w, double& bs, double& ws) {
  constexpr unsigned kFull = 0xffffffffu;
  double f[K];
#pragma unroll
  for (int k = 0; k < K; ++k) f[k] = dmax(st[w * K + k], t);
  // lane 1 is thread 0's f[1] (K > 1) or thread 1's f[0]
  double z0 = __shfl_sync(kFull, f[0], 0);
  double z1 = __shfl_sync(kFull, f[K > 1 ? 1 : 0], K > 1 ? 0 : 1);
  double mx = -CUDART_INF;
  auto step = [&](double s) {
    double above = __shfl_down_sync(kFull, f[0], 1);
    if (w == 31) above = CUDART_INF;
    const double end = __dadd_rn(z0, s);
    if (STATS && w == 0) {
      bs = __dadd_rn(bs, s);
      ws = __dadd_rn(ws, __dsub_rn(z0, t));
    }
    z0 = dmin(end, z1);
    f[0] = w == 0 ? z0 : dmin(dmax(f[0], end), K > 1 ? f[1 % K] : above);
#pragma unroll
    for (int k = 1; k < K; ++k) f[k] = dmin(dmax(f[k], end), k + 1 < K ? f[(k + 1) % K] : above);
    z1 = __shfl_sync(kFull, f[K > 1 ? 1 : 0], K > 1 ? 0 : 1);
    mx = dmax(mx, end);
  };
  int j = 0;
  if (nj >= kAhead) {
    double cur[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) cur[u] = sv[u * B];
    for (; j + kAhead <= nj; j += kAhead) {
      double nxt[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) nxt[u] = j + kAhead + u < nj ? sv[(j + kAhead + u) * B] : 0.0;
#pragma unroll
      for (int u = 0; u < kAhead; ++u) step(cur[u]);
#pragma unroll
      for (int u = 0; u < kAhead; ++u) cur[u] = nxt[u];
    }
  }
  for (; j < nj; ++j) step(sv[j * B]);
#pragma unroll
  for (int k = 0; k < K; ++k) st[w * K + k] = f[k];
  return mx;
}

// A pool wider than kWarpLanes on a whole warp, its `cap` lanes (a power of
// two, > 512) in the state memory `st`, sorted ascending (+inf: absent).
// The clamp to t and each job's sorted insert touch only the rows of 32
// lanes below the first row whose lowest lane is already >= the value
// written: lanes at or above it keep their values (they are >= end, so
// min(max(f, end), f_next) = f).  A lane below `end` becomes
// min(end, f_next), with f_next read before any lane of its row changes.
template <bool STATS>
__device__ double run_mem(double* st, const double* sv, int nj, int B, double t, int cap, int w, double& bs,
                          double& ws) {
  constexpr unsigned kFull = 0xffffffffu;
  for (int m = 0; m < cap; m += 32) {
    const double x = st[m + w];
    const double top = __shfl_sync(kFull, x, 31);
    if (x < t) st[m + w] = t;
    if (top >= t) break;
  }
  __syncwarp();
  double mx = -CUDART_INF;
  for (int j = 0; j < nj; ++j) {
    const double s = sv[j * B];
    const double z0 = st[0];
    const double end = __dadd_rn(z0, s);
    if (STATS && w == 0) {
      bs = __dadd_rn(bs, s);
      ws = __dadd_rn(ws, __dsub_rn(z0, t));
    }
    __syncwarp();
    for (int m = 0; m < cap; m += 32) {
      const int i = m + w;
      const double a = st[i];
      const double up = i + 1 < cap ? st[i + 1] : CUDART_INF;
      const double next_row = __shfl_sync(kFull, up, 31);
      __syncwarp();
      if (a < end) st[i] = dmin(end, up);
      __syncwarp();
      if (next_row >= end) break;
    }
    mx = dmax(mx, end);
  }
  return mx;
}

// Stage one chunk's service times, [job][pool], for the pools that have
// servers: thread `first` of `step` loaders takes every step-th element,
// 8 at a time, the 8 sample indices in flight together, then the 8 times.
__device__ __forceinline__ void stage(double* dst, const double* tbl, const int32_t* ix, const int* lanes, int nj,
                                      int B, int first, int step) {
  const int n = nj * B;
  for (int e0 = first; e0 < n; e0 += 8 * step) {
    int row[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * step;
      row[u] = e < n ? __ldg(ix + e / B) : 0;
    }
    double v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * step, pp = e - (e / B) * B;
      v[u] = e < n && lanes[pp] ? __ldg(tbl + (size_t)row[u] * B + pp) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * step;
      if (e < n) dst[e] = v[u];
    }
  }
}

// One chunk of a layer's jobs over its pools, by the consumer threads: a
// pool of at most 8 servers on one thread, a wider one on a warp (lanes in
// registers up to 512, in state memory above).  Folds each pool's largest
// end into mx and, with STATS, the service and wait sums into bs / ws.
template <int KMAX, bool STATS>
__device__ __forceinline__ void run_pools(double* state, const int* s_off, const int* s_lanes, int po, int B,
                                          const double* sv, int nj, double t, int tid, int nc, int warp, int lane,
                                          int consumer_warps, double& mx, double& bs, double& ws) {
  // small pools: a thread each
  for (int p = tid; p < B; p += nc) {
    const int d = s_lanes[po + p];
    if (d < 1 || d > kSmallPool) continue;
    double* st = state + s_off[po + p];
    double m;
    switch (d) {
      case 1: m = run_thread<1, STATS>(st, sv + p, nj, B, t, bs, ws); break;
      case 2: m = run_thread<2, STATS>(st, sv + p, nj, B, t, bs, ws); break;
      case 3: case 4: m = run_thread<4, STATS>(st, sv + p, nj, B, t, bs, ws); break;
      default: m = run_thread<8, STATS>(st, sv + p, nj, B, t, bs, ws); break;
    }
    mx = dmax(mx, m);
  }
  __syncwarp();
  // wide pools: a warp each (warp-uniform branches)
  for (int p = warp; p < B; p += consumer_warps) {
    const int d = s_lanes[po + p];
    if (d <= kSmallPool) continue;
    double* st = state + s_off[po + p];
    double b2 = 0.0, w2 = 0.0, m;
    const int k = pow2_ceil(d) / 32;  // lanes a thread: 1 to KMAX
    if (d > kWarpLanes) {
      // the host gives a launch with such a pool the KMAX 32 build
      if constexpr (KMAX == 32) m = run_mem<STATS>(st, sv + p, nj, B, t, pool_cap(d), lane, b2, w2);
      else __trap();
    } else if constexpr (KMAX == 1) {
      m = run_warp<1, STATS>(st, sv + p, nj, B, t, lane, b2, w2);
    } else if constexpr (KMAX == 4) {
      m = k <= 1   ? run_warp<1, STATS>(st, sv + p, nj, B, t, lane, b2, w2)
          : k == 2 ? run_warp<2, STATS>(st, sv + p, nj, B, t, lane, b2, w2)
                   : run_warp<4, STATS>(st, sv + p, nj, B, t, lane, b2, w2);
    } else {
      m = k <= 1   ? run_warp<1, STATS>(st, sv + p, nj, B, t, lane, b2, w2)
          : k == 2 ? run_warp<2, STATS>(st, sv + p, nj, B, t, lane, b2, w2)
          : k == 4 ? run_warp<4, STATS>(st, sv + p, nj, B, t, lane, b2, w2)
          : k == 8 ? run_warp<8, STATS>(st, sv + p, nj, B, t, lane, b2, w2)
                   : run_warp<16, STATS>(st, sv + p, nj, B, t, lane, b2, w2);
    }
    mx = dmax(mx, m);
    if (STATS) {
      bs = __dadd_rn(bs, b2);
      ws = __dadd_rn(ws, w2);
    }
  }
}

// KMAX: the most lanes a thread of a wide pool holds in this launch (1: up
// to 32 servers a pool, 4: 128, 16: 512; 32: any pool wider, whose lanes
// stay in state memory, beside the others); fewer registers for smaller
// ones.  The two widest builds run at most 256 threads.  VT's KMAX 16
// build without STATS keeps two blocks an SM (128 registers: the fused
// sweep's fabric stage launches hundreds of configs); every other 256-thread
// build, and the streaming entry's (a few configs a launch), asks for one
// and may keep 255.
// The block's first `consumer_warps` warps run the pools; the rest stage the
// next chunk's service times meanwhile (the chunks of every (request,
// layer) in order form one sequence, whose addresses do not depend on the
// times).  One barrier a chunk; a layer's last chunk's barrier also carries
// the layer's completion.
template <int KMAX, bool STATS>
__global__ void __launch_bounds__(KMAX >= 16 ? kMaxThreads / 2 : kMaxThreads, KMAX == 16 && !STATS ? 2 : 1) vtime_scan_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ long long s_tbl[kMaxLayers], s_io[kMaxLayers];
  __shared__ int s_nb[kMaxLayers], s_np[kMaxLayers], s_po[kMaxLayers];
  __shared__ int s_off[kMaxPools], s_lanes[kMaxPools];
  __shared__ double s_red[2][kMaxThreads / 32];
  __shared__ double s_bsum[2][kMaxThreads / 32], s_wsum[2][kMaxThreads / 32];
  __shared__ double s_acc_b[kMaxLayers], s_acc_w[kMaxLayers];

  const int c = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int nc = 32 * a.consumer_warps;  // consumer threads; the others stage
  const bool loader = tid >= nc;
  const int v = a.variant[c];
  for (int l = tid; l < a.L; l += nthreads) {
s_tbl[l] = a.tbl_off[(size_t)l * a.V + v];
s_nb[l] = (int)a.meta[4 * l];
s_np[l] = (int)a.meta[4 * l + 1];
s_po[l] = (int)a.meta[4 * l + 2];
s_io[l] = a.meta[4 * l + 3];
s_acc_b[l] = 0.0;
s_acc_w[l] = 0.0;
  }
  for (int q = tid; q < a.Ptot; q += nthreads) s_lanes[q] = a.lanes[(size_t)c * a.Ptot + q];
  __syncthreads();
  if (tid == 0) {  // each pool's first lane in this config's state
int off = 0;
for (int q = 0; q < a.Ptot; ++q) {
  s_off[q] = off;
  off += pool_cap(s_lanes[q]);
}
  }
  // dynamic shared memory: two buffers of staged service times, then the
  // pool state when it lives here
  double* sbuf = reinterpret_cast<double*>(smem_raw);
  double* state = a.smem_state ? sbuf + 2 * a.chunk : a.gstate + (size_t)c * a.state_stride;
  // the first chunk, by every thread
  stage(sbuf, a.tables + s_tbl[0], a.idx + s_io[0], s_lanes + s_po[0], min(a.chunk / s_nb[0], s_np[0]), s_nb[0],
    tid, nthreads);
  __syncthreads();
  for (int q = warp; q < a.Ptot; q += nwarps) {
const int d = s_lanes[q], cap = pool_cap(d);
for (int i = lane; i < cap; i += 32) state[s_off[q] + i] = i < d ? 0.0 : CUDART_INF;
  }
  __syncthreads();

  double t = 0.0, t0 = 0.0, t_prev = 0.0, mx = -CUDART_INF, bs = 0.0, ws = 0.0;
  int parity = 0, cb = 0;
  int r = 0, l = 0, j0 = 0;
  while (r < a.N) {
const int B = s_nb[l], P = s_np[l], po = s_po[l];
const int per = a.chunk / B;  // jobs a chunk
const int nj = min(per, P - j0);
if (j0 == 0) {
  if (l == 0) {
    if (a.conc == 0) t = a.arrivals[(size_t)c * a.N + r];
    else if (r < a.conc) t = 0.0;
    else if (a.conc == 1) t = t_prev;
    // written by thread 0 at the end of request r - conc; the barriers
    // of request r - 1 have synchronised the block since
    else t = a.comp[(size_t)c * a.N + r - a.conc];
    t0 = t;
  }
  if (a.xfer) t = __dadd_rn(t, a.xfer[(size_t)c * a.L + l]);
}
// the chunk after this one
int r2 = r, l2 = l, j2 = j0 + per;
const bool last = j2 >= P;  // this layer's last chunk
if (last) {
  j2 = 0;
  if (++l2 == a.L) {
    l2 = 0;
    ++r2;
  }
}
const double* sv = sbuf + cb * a.chunk;
if (loader) {
  if (r2 < a.N) {
    const int B2 = s_nb[l2];
    stage(sbuf + (cb ^ 1) * a.chunk, a.tables + s_tbl[l2], a.idx + s_io[l2] + (size_t)r2 * s_np[l2] + j2,
          s_lanes + s_po[l2], min(a.chunk / B2, s_np[l2] - j2), B2, tid - nc, nthreads - nc);
  }
} else {
  run_pools<KMAX, STATS>(state, s_off, s_lanes, po, B, sv, nj, t, tid, nc, warp, lane, a.consumer_warps, mx,
                         bs, ws);
}
if (last) {
#pragma unroll
  for (int o = 16; o; o >>= 1) mx = dmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (STATS) {
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      bs = __dadd_rn(bs, __shfl_down_sync(0xffffffffu, bs, o));
      ws = __dadd_rn(ws, __shfl_down_sync(0xffffffffu, ws, o));
    }
  }
  if (lane == 0) {
    s_red[parity][warp] = mx;
    if (STATS) {
      s_bsum[parity][warp] = bs;
      s_wsum[parity][warp] = ws;
    }
  }
}
// the chunk's barrier: the staging buffers alternate, so the next
// chunk's staging cannot overtake this one's reads; the layer-end
// buffers alternate by layer for the same reason
__syncthreads();
cb ^= 1;
if (last) {
  double done = lane < nwarps ? s_red[parity][lane] : -CUDART_INF;
#pragma unroll
  for (int o = 16; o; o >>= 1) done = dmax(done, __shfl_xor_sync(0xffffffffu, done, o));
  if (STATS && tid == 0) {
    double sb = 0.0, sw = 0.0;
    for (int w = 0; w < nwarps; ++w) {
      sb = __dadd_rn(sb, s_bsum[parity][w]);
      sw = __dadd_rn(sw, s_wsum[parity][w]);
    }
    s_acc_b[l] = __dadd_rn(s_acc_b[l], sb);
    s_acc_w[l] = __dadd_rn(s_acc_w[l], sw);
  }
  t = dmax(done, t);
  parity ^= 1;
  mx = -CUDART_INF;
  bs = ws = 0.0;
  if (l + 1 == a.L) {
    if (tid == 0) {
      a.t_arr[(size_t)c * a.N + r] = t0;
      a.comp[(size_t)c * a.N + r] = t;
    }
    t_prev = t;
  }
}
r = r2;
l = l2;
j0 = j2;
  }
  if (STATS && tid == 0) {
for (int q = 0; q < a.L; ++q) {
  a.busy[(size_t)c * a.L + q] = s_acc_b[q];
  a.wait[(size_t)c * a.L + q] = s_acc_w[q];
}
  }
}

template <int KMAX, bool STATS>
int launch(const Args& a, int C, int threads, size_t smem, cudaStream_t stream) {
  static size_t smem_set[64] = {};  // the shared-memory limit raised so far, per device
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 - kStaticSmem && smem > smem_set[device]) {
    e = cudaFuncSetAttribute(vtime_scan_kernel<KMAX, STATS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set[device] = smem;
  }
  vtime_scan_kernel<KMAX, STATS><<<C, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool STATS>
int dispatch(const Args& a, int C, int kmax, int threads, size_t smem, cudaStream_t s) {
  switch (kmax) {
    case 1: return launch<1, STATS>(a, C, threads, smem, s);
    case 4: return launch<4, STATS>(a, C, threads, smem, s);
    case 16: return launch<16, STATS>(a, C, threads, smem, s);
    case 32: return launch<32, STATS>(a, C, threads, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Pointers are device pointers of
// contiguous tensors on the current device; `stream` is a cudaStream_t.
// `state_stride` is the doubles of pool state a config needs: the sum over
// its pools of pool_cap(lanes) (a power of two up to 8 for a pool of at most
// 8 servers, max(32, the power of two) above).  `kmax` is 1, 4, 16 or
// 32: at least the lanes a warp's thread holds for the widest pool
// (pow2(servers) / 32), and 32 when a pool is wider than 512 servers.
// `chunk` is the doubles of service times staged at a time, at least every layer's pool count; the dynamic shared memory is two
// such buffers and, with `smem_state` 1, the pool state (the caller has
// checked it fits), else the state is in `gstate` (C x state_stride
// doubles).  `threads` is a multiple of 32, at most 512, of which the first
// 32 * `consumer_warps` run the pools (enough for every layer's pools and
// its wide pools, or as many as fit) and at least one warp stages; 256
// threads at most for kmax 16 and 32, whose threads hold up to 16 lanes.  The caller has
// checked every index (variant < V, sample index < S_l), lanes <= 65536,
// service times >= 0 and not NaN, L <= 64 and Ptot <= 1024.  Returns
// cudaGetLastError() after the launch (0 when the launch was accepted).
extern "C" int vtime_scan_launch(const void* tables, const void* tbl_off, const void* meta, const void* idx,
                                 const void* variant, const void* lanes, const void* arrivals, const void* xfer,
                                 void* t_arr, void* comp, void* busy, void* wait, void* gstate, long long state_stride,
                                 int C, int N, int L, int V, int Ptot, int conc, int kmax, int chunk, int threads,
                                 int consumer_warps, int smem_state, int stats, void* stream) {
  if (C == 0 || N == 0) return 0;
  if (L < 1 || L > kMaxLayers || Ptot < 1 || Ptot > kMaxPools || threads < 32 || threads > kMaxThreads ||
      threads % 32 || chunk < 1 || consumer_warps < 1 || 32 * consumer_warps >= threads ||
      (kmax >= 16 && threads > kMaxThreads / 2))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.tables = static_cast<const double*>(tables);
  a.tbl_off = static_cast<const long long*>(tbl_off);
  a.meta = static_cast<const long long*>(meta);
  a.idx = static_cast<const int32_t*>(idx);
  a.variant = static_cast<const int32_t*>(variant);
  a.lanes = static_cast<const int32_t*>(lanes);
  a.arrivals = static_cast<const double*>(arrivals);
  a.xfer = static_cast<const double*>(xfer);
  a.t_arr = static_cast<double*>(t_arr);
  a.comp = static_cast<double*>(comp);
  a.busy = static_cast<double*>(busy);
  a.wait = static_cast<double*>(wait);
  a.gstate = static_cast<double*>(gstate);
  a.state_stride = state_stride;
  a.N = N;
  a.L = L;
  a.V = V;
  a.Ptot = Ptot;
  a.conc = conc;
  a.chunk = chunk;
  a.consumer_warps = consumer_warps;
  a.smem_state = smem_state != 0;
  const size_t smem = (2 * (size_t)chunk + (a.smem_state ? (size_t)state_stride : 0)) * sizeof(double);
  if (smem > kMaxSmem - kStaticSmem) return (int)cudaErrorInvalidValue;
  if (!a.smem_state && gstate == nullptr) return (int)cudaErrorInvalidValue;
  if (conc == 0 && arrivals == nullptr) return (int)cudaErrorInvalidValue;
  if (stats && (busy == nullptr || wait == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return stats ? dispatch<true>(a, C, kmax, threads, smem, s) : dispatch<false>(a, C, kmax, threads, smem, s);
}

namespace {

// fabric.vtime.hash_service_indices for one (salt, request, patch): uint32
// arithmetic wraps as numpy's does
__device__ __forceinline__ uint32_t hash_index(uint32_t salt, uint32_t r, uint32_t p) {
  uint32_t h = (p + 1u) * 0x9E3779B9u;
  h = h + (r + 1u) * 0x85EBCA6Bu + salt;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

struct StreamArgs {
  const double* tables;      // per layer, per variant: (S_l, B_l) row-major
  const long long* tbl_off;  // (L, V) offsets into tables
  const long long* meta;     // (L, 5): B_l, P_l, pool offset, offset into idx, S_l
  const uint32_t* salts;     // (L) hash salts (hash mode)
  const int32_t* idx;        // per layer (N, P_l) presampled indices, or null: hash mode
  const int32_t* plans;      // (C, L, 2) macro-job plan (K, n_bulk); (1, 0) exact
  const int32_t* variant;    // (C)
  const int32_t* lanes;      // (C, Ptot) lane slots per pool (0: no servers)
  const double* arrivals;    // (C, N), or null for the closed loop
  const double* xfer;        // (C, L), or null
  double* state;             // (C, state_stride) lane free-times, in and out
  double* ring;              // (C, ring_len) closed-loop completions, in and out
  double* counts;            // (C, n_bins) sketch bucket counts, in and out
  double* moments;           // (C, 5): n, min, max, mean, m2, in and out
  double* horizon;           // (C) largest completion, in and out
  double* t_arr;             // (C, N) with emit, else null
  double* comp;              // (C, N) with emit, else null
  long long state_stride;
  long long r0;              // global id of the first request
  int N, L, V, Ptot, conc, ring_len, chunk, consumer_warps, smem_state;
  int n_bins, bins_per_octave, min_exp;
};

// Stage one chunk of a layer's jobs j0 .. j0 + nj - 1, [job][pool], for the
// pools that have servers.  Job jj < n_bulk is the left fold of the K
// patches jj*K .. jj*K+K-1 (vtime._chunk_services), a later job one patch;
// a patch's sample row is hashed from (salt, r, patch) or read from `ix`.
// Eight elements at a time, their loads in flight together.
__device__ __forceinline__ void stage_stream(double* dst, const double* tbl, const int32_t* ix, uint32_t salt,
                                             uint32_t r, int S, const int* lanes, int j0, int nj, int B, int K,
                                             int nbulk, int first, int step) {
  const int n = nj * B;
  for (int e0 = first; e0 < n; e0 += 8 * step) {
    int p0[8], k[8], pp[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * step, jj = j0 + e / B;
      pp[u] = e - (e / B) * B;
      const bool live = e < n && lanes[pp[u]];
      k[u] = !live ? 0 : jj < nbulk ? K : 1;
      p0[u] = jj < nbulk ? jj * K : nbulk * K + (jj - nbulk);
    }
    const int kmax = max(max(max(k[0], k[1]), max(k[2], k[3])), max(max(k[4], k[5]), max(k[6], k[7])));
    double v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = 0.0;
    for (int q = 0; q < kmax; ++q) {
      double x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        x[u] = 0.0;
        if (q < k[u]) {
          const int p = p0[u] + q;
          const int row = ix ? __ldg(ix + p) : (int)(hash_index(salt, r, (uint32_t)p) % (uint32_t)S);
          x[u] = __ldg(tbl + (size_t)row * B + pp[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (q < k[u]) v[u] = q == 0 ? x[u] : __dadd_rn(v[u], x[u]);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * step;
      if (e < n) dst[e] = v[u];
    }
  }
}

// fabric.metrics.sketch_bucket: frexp, the sub-bucket floor((2m - 1) F),
// clipped to the histogram
__device__ __forceinline__ int sketch_bucket(double lat, int F, int min_exp, int n_bins) {
  const double v = dmax(lat, ldexp(1.0, min_exp));
  int e;
  const double m = frexp(v, &e);
  const int sub = (int)floor(__dmul_rn(__dsub_rn(__dmul_rn(m, 2.0), 1.0), (double)F));
  const int b = (e - (min_exp + 1)) * F + sub;
  return min(max(b, 0), n_bins - 1);
}

// The streaming replay: VT's loop over (request, layer, chunk) with the
// caller's lane state, hashed (or given) indices, macro-jobs, and the
// per-request sketch, moments, horizon and ring kept by thread 0.
template <int KMAX>
__global__ void __launch_bounds__(KMAX >= 16 ? kMaxThreads / 2 : kMaxThreads, 1) vtime_stream_kernel(StreamArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ long long s_tbl[kMaxLayers], s_io[kMaxLayers];
  __shared__ int s_nb[kMaxLayers], s_np[kMaxLayers], s_po[kMaxLayers], s_ns[kMaxLayers];
  __shared__ int s_k[kMaxLayers], s_bulk[kMaxLayers], s_jobs[kMaxLayers];
  __shared__ uint32_t s_salt[kMaxLayers];
  __shared__ int s_off[kMaxPools], s_lanes[kMaxPools];
  __shared__ double s_red[2][kMaxThreads / 32];

  const int c = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int nc = 32 * a.consumer_warps;
  const bool loader = tid >= nc;
  const int v = a.variant[c];
  for (int l = tid; l < a.L; l += nthreads) {
    s_tbl[l] = a.tbl_off[(size_t)l * a.V + v];
    s_nb[l] = (int)a.meta[5 * l];
    s_np[l] = (int)a.meta[5 * l + 1];
    s_po[l] = (int)a.meta[5 * l + 2];
    s_io[l] = a.meta[5 * l + 3];
    s_ns[l] = (int)a.meta[5 * l + 4];
    s_salt[l] = a.salts ? a.salts[l] : 0u;
    const int K = a.plans[((size_t)c * a.L + l) * 2], nb = a.plans[((size_t)c * a.L + l) * 2 + 1];
    s_k[l] = K;
    s_bulk[l] = nb;
    s_jobs[l] = nb + s_np[l] - nb * K;  // macro-jobs, then the exact tail
  }
  for (int q = tid; q < a.Ptot; q += nthreads) s_lanes[q] = a.lanes[(size_t)c * a.Ptot + q];
  __syncthreads();
  if (tid == 0) {
    int off = 0;
    for (int q = 0; q < a.Ptot; ++q) {
      s_off[q] = off;
      off += pool_cap(s_lanes[q]);
    }
  }
  double* sbuf = reinterpret_cast<double*>(smem_raw);
  double* gstate = a.state + (size_t)c * a.state_stride;
  double* state = a.smem_state ? sbuf + 2 * a.chunk : gstate;
  auto stage_at = [&](double* dst, int i, int l, int j0, int first, int step) {
    const int B = s_nb[l];
    const int32_t* ix = a.idx ? a.idx + s_io[l] + (size_t)i * s_np[l] : nullptr;
    stage_stream(dst, a.tables + s_tbl[l], ix, s_salt[l], (uint32_t)(a.r0 + i), s_ns[l], s_lanes + s_po[l], j0,
                 min(a.chunk / B, s_jobs[l] - j0), B, s_k[l], s_bulk[l], first, step);
  };
  stage_at(sbuf, 0, 0, 0, tid, nthreads);
  if (a.smem_state)
    for (long long i = tid; i < a.state_stride; i += nthreads) state[i] = gstate[i];
  __syncthreads();

  // thread 0's sketch state
  double n_seen = 0.0, mn = 0.0, mxl = 0.0, mean = 0.0, m2 = 0.0, hor = 0.0;
  if (tid == 0) {
    const double* mo = a.moments + (size_t)c * 5;
    n_seen = mo[0];
    mn = mo[1];
    mxl = mo[2];
    mean = mo[3];
    m2 = mo[4];
    hor = a.horizon[c];
  }
  double* counts = a.counts + (size_t)c * a.n_bins;
  double* ring = a.ring + (size_t)c * a.ring_len;

  double t = 0.0, t0 = 0.0, t_prev = 0.0, mx = -CUDART_INF, bs = 0.0, ws = 0.0;
  int parity = 0, cb = 0;
  int i = 0, l = 0, j0 = 0;
  while (i < a.N) {
    const int B = s_nb[l], Pj = s_jobs[l], po = s_po[l];
    const int per = a.chunk / B;
    const int nj = min(per, Pj - j0);
    if (j0 == 0) {
      if (l == 0) {
        if (a.conc == 0) t = a.arrivals[(size_t)c * a.N + i];
        // request i's slot was last written by request i - conc (carried in
        // when i < conc); with conc 1 that is the previous request, whose
        // write by thread 0 no barrier separates from this read
        else if (a.conc == 1 && i > 0) t = t_prev;
        else t = ring[(a.r0 + i) % a.conc];
        t0 = t;
      }
      if (a.xfer) t = __dadd_rn(t, a.xfer[(size_t)c * a.L + l]);
    }
    int i2 = i, l2 = l, j2 = j0 + per;
    const bool last = j2 >= Pj;
    if (last) {
      j2 = 0;
      if (++l2 == a.L) {
        l2 = 0;
        ++i2;
      }
    }
    const double* sv = sbuf + cb * a.chunk;
    if (loader) {
      if (i2 < a.N) stage_at(sbuf + (cb ^ 1) * a.chunk, i2, l2, j2, tid - nc, nthreads - nc);
    } else {
      run_pools<KMAX, false>(state, s_off, s_lanes, po, B, sv, nj, t, tid, nc, warp, lane, a.consumer_warps, mx,
                             bs, ws);
    }
    if (last) {
#pragma unroll
      for (int o = 16; o; o >>= 1) mx = dmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) s_red[parity][warp] = mx;
    }
    __syncthreads();
    cb ^= 1;
    if (last) {
      double done = lane < nwarps ? s_red[parity][lane] : -CUDART_INF;
#pragma unroll
      for (int o = 16; o; o >>= 1) done = dmax(done, __shfl_xor_sync(0xffffffffu, done, o));
      t = dmax(done, t);
      parity ^= 1;
      mx = -CUDART_INF;
      if (l + 1 == a.L) {
        if (tid == 0) {
          if (a.comp) {
            a.t_arr[(size_t)c * a.N + i] = t0;
            a.comp[(size_t)c * a.N + i] = t;
          }
          if (a.conc) ring[(a.r0 + i) % a.conc] = t;
          const double lat = __dsub_rn(t, t0);
          counts[sketch_bucket(lat, a.bins_per_octave, a.min_exp, a.n_bins)] += 1.0;
          const double n1 = __dadd_rn(n_seen, 1.0);
          const double d = __dsub_rn(lat, mean);
          mean = __dadd_rn(mean, __ddiv_rn(d, n1));
          m2 = __dadd_rn(m2, __dmul_rn(d, __dsub_rn(lat, mean)));
          n_seen = n1;
          mn = dmin(mn, lat);
          mxl = dmax(mxl, lat);
          hor = dmax(hor, t);
        }
        t_prev = t;
      }
    }
    i = i2;
    l = l2;
    j0 = j2;
  }
  if (tid == 0) {
    double* mo = a.moments + (size_t)c * 5;
    mo[0] = n_seen;
    mo[1] = mn;
    mo[2] = mxl;
    mo[3] = mean;
    mo[4] = m2;
    a.horizon[c] = hor;
  }
  if (a.smem_state) {
    __syncthreads();
    for (long long q = tid; q < a.state_stride; q += nthreads) gstate[q] = state[q];
  }
}

template <int KMAX>
int launch_stream(const StreamArgs& a, int C, int threads, size_t smem, cudaStream_t stream) {
  static size_t smem_set[64] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 - kStaticSmem && smem > smem_set[device]) {
    e = cudaFuncSetAttribute(vtime_stream_kernel<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set[device] = smem;
  }
  vtime_stream_kernel<KMAX><<<C, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Streaming entry, loaded with ctypes; pointers as for vtime_scan_launch.
// `n` requests (the segment's valid ones) with global ids r0 .. r0 + n - 1.
// `state` (C x state_stride) holds each config's lanes, pool by pool at
// pool_cap(lanes) lanes each, sorted ascending with +inf for absent
// servers; it is read at the start and written back at the end, as are
// `ring` (C x ring_len, the closed loop's last completions by slot r %
// conc), `counts` (C x n_bins), `moments` (C x 5: n, min, max, mean, m2)
// and `horizon` (C).  `salts` (L uint32) selects hashed indices, `idx`
// presampled ones (one of them is null); `plans` (C x L x 2 int32) are the
// macro-job plans (K, n_bulk), (1, 0) for exact jobs, and with `idx` they
// must be exact.  `t_arr` / `comp` (C x n) are written when not null.  The
// caller has checked every index, lanes <= 65536, service times >= 0, L <=
// 64, Ptot <= 1024, K >= 1 and n_bulk * K <= P_l.  `kmax`, `chunk`,
// `threads`, `consumer_warps` and `smem_state` as for vtime_scan_launch.
extern "C" int vtime_stream_launch(const void* tables, const void* tbl_off, const void* meta, const void* salts,
                                   const void* idx, const void* plans, const void* variant, const void* lanes,
                                   const void* arrivals, const void* xfer, void* state, long long state_stride,
                                   void* ring, int ring_len, void* counts, int n_bins, int bins_per_octave,
                                   int min_exp, void* moments, void* horizon, void* t_arr, void* comp, long long r0,
                                   int C, int N, int L, int V, int Ptot, int conc, int kmax, int chunk, int threads,
                                   int consumer_warps, int smem_state, void* stream) {
  if (C == 0 || N == 0) return 0;
  if (L < 1 || L > kMaxLayers || Ptot < 1 || Ptot > kMaxPools || threads < 32 || threads > kMaxThreads ||
      threads % 32 || chunk < 1 || consumer_warps < 1 || 32 * consumer_warps >= threads ||
      (kmax >= 16 && threads > kMaxThreads / 2) || n_bins < 1 || bins_per_octave < 1 || ring_len < 1 ||
      (salts == nullptr) == (idx == nullptr) || (conc == 0 && arrivals == nullptr) ||
      ((t_arr == nullptr) != (comp == nullptr)))
    return (int)cudaErrorInvalidValue;
  StreamArgs a;
  a.tables = static_cast<const double*>(tables);
  a.tbl_off = static_cast<const long long*>(tbl_off);
  a.meta = static_cast<const long long*>(meta);
  a.salts = static_cast<const uint32_t*>(salts);
  a.idx = static_cast<const int32_t*>(idx);
  a.plans = static_cast<const int32_t*>(plans);
  a.variant = static_cast<const int32_t*>(variant);
  a.lanes = static_cast<const int32_t*>(lanes);
  a.arrivals = static_cast<const double*>(arrivals);
  a.xfer = static_cast<const double*>(xfer);
  a.state = static_cast<double*>(state);
  a.ring = static_cast<double*>(ring);
  a.counts = static_cast<double*>(counts);
  a.moments = static_cast<double*>(moments);
  a.horizon = static_cast<double*>(horizon);
  a.t_arr = static_cast<double*>(t_arr);
  a.comp = static_cast<double*>(comp);
  a.state_stride = state_stride;
  a.r0 = r0;
  a.N = N;
  a.L = L;
  a.V = V;
  a.Ptot = Ptot;
  a.conc = conc;
  a.ring_len = ring_len;
  a.chunk = chunk;
  a.consumer_warps = consumer_warps;
  a.smem_state = smem_state != 0;
  a.n_bins = n_bins;
  a.bins_per_octave = bins_per_octave;
  a.min_exp = min_exp;
  const size_t smem = (2 * (size_t)chunk + (a.smem_state ? (size_t)state_stride : 0)) * sizeof(double);
  if (smem > kMaxSmem - kStaticSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (kmax) {
    case 1: return launch_stream<1>(a, C, threads, smem, s);
    case 4: return launch_stream<4>(a, C, threads, smem, s);
    case 16: return launch_stream<16>(a, C, threads, smem, s);
    case 32: return launch_stream<32>(a, C, threads, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

namespace {

// One thread, `iters` dependent steps x <- min(x + s, y) (`with_min` 1) or
// x <- x + s: the latency of the FP64 add and min that sit on VT's chain of
// jobs, for chip_smoke.py's bound.
__global__ void vtime_chain_probe_kernel(double* x, long long iters, double s, double y, int with_min) {
  double v = x[0];
  if (with_min) {
    for (long long i = 0; i < iters; ++i) v = dmin(__dadd_rn(v, s), y);
  } else {
    for (long long i = 0; i < iters; ++i) v = __dadd_rn(v, s);
  }
  x[0] = v;
}

}  // namespace

// Measurement entry: launches the one-thread chain above on `stream`.
extern "C" int vtime_chain_probe_launch(void* x, long long iters, double s, double y, int with_min, void* stream) {
  vtime_chain_probe_kernel<<<1, 1, 0, reinterpret_cast<cudaStream_t>(stream)>>>(static_cast<double*>(x), iters, s, y,
                                                                                 with_min);
  return (int)cudaGetLastError();
}
