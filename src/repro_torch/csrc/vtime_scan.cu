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
//     kernel is built for the widest pool of a launch (KMAX 1, 4 or 16
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
//     scratch row per config.
// A launch fills one SM per config; a call with few configs leaves the
// card mostly idle, in the nature of a per-config serial recurrence.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 64;
constexpr int kMaxPools = 1024;
constexpr int kMaxThreads = 512;
constexpr int kSmallPool = 8;  // pools of at most this many servers run on one thread
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

// KMAX: the most lanes a thread of a wide pool holds in this launch (1: up
// to 32 servers a pool, 4: 128, 16: 512); fewer registers for smaller ones
// (the widest build runs at most 256 threads, so it may keep 255).
// The block's first `consumer_warps` warps run the pools; the rest stage the
// next chunk's service times meanwhile (the chunks of every (request,
// layer) in order form one sequence, whose addresses do not depend on the
// times).  One barrier a chunk; a layer's last chunk's barrier also carries
// the layer's completion.
template <int KMAX, bool STATS>
__global__ void __launch_bounds__(KMAX == 16 ? kMaxThreads / 2 : kMaxThreads) vtime_scan_kernel(Args a) {
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
      for (int p = warp; p < B; p += a.consumer_warps) {
        const int d = s_lanes[po + p];
        if (d <= kSmallPool) continue;
        double* st = state + s_off[po + p];
        double b2 = 0.0, w2 = 0.0, m;
        const int k = pow2_ceil(d) / 32;  // lanes a thread: 1 to KMAX
        if constexpr (KMAX == 1) {
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
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Pointers are device pointers of
// contiguous tensors on the current device; `stream` is a cudaStream_t.
// `state_stride` is the doubles of pool state a config needs: the sum over
// its pools of pool_cap(lanes) (a power of two up to 8 for a pool of at most
// 8 servers, max(32, the power of two) above, at most 512).  `kmax` is 1, 4
// or 16, at least the lanes a warp's thread holds for the widest pool
// (pow2(servers) / 32).  `chunk` is the doubles of service times staged at a
// time, at least every layer's pool count; the dynamic shared memory is two
// such buffers and, with `smem_state` 1, the pool state (the caller has
// checked it fits), else the state is in `gstate` (C x state_stride
// doubles).  `threads` is a multiple of 32, at most 512, of which the first
// 32 * `consumer_warps` run the pools (enough for every layer's pools and
// its wide pools, or as many as fit) and at least one warp stages; 256
// threads at most for kmax 16, whose threads hold up to 16 lanes.  The caller has
// checked every index (variant < V, sample index < S_l), lanes <= 512,
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
      (kmax == 16 && threads > kMaxThreads / 2))
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
