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
// every operation is an IEEE double add (__dadd_rn), a compare or a select,
// in the reference's order per job, and max is exact in any order.  With
// sorted lanes and end >= f_0, min(max(f_k, end), f_{k+1}) is
//     (f_{k+1} < end) ? f_{k+1} : (f_k < end) ? end : f_k,
// one compare a lane (f_{k+1} < end is the next lane's compare) and two
// selects, the same value bit for bit.  Pools with no servers hold only
// +inf lanes, which no job changes, so they are skipped.  The busy and wait
// sums are taken per thread, then per warp, then per stage, an order other
// than the reference's: they agree to rtol 1e-12.  The library is compiled
// with --fmad=false besides.
//
// What bounds it: latency along the critical path.  The jobs of one pool
// are a serial chain (each takes lane 0 of the state the previous one
// left), each link an add and a min (an add alone for one server).  Request
// r at layer l depends on r at layer l-1 (its ready time) and on r-1 at
// layer l (the pools' state), and a closed loop adds r - conc at the last
// layer before r at layer 0; so the layers of a config form a wavefront,
// and its time is the longest path through that (r, l) grid, not the sum
// of every job (kernels/vtime_scan.py critical_path).  The design:
//   * a config runs on a thread-block cluster of S blocks (S <= 8), its
//     layers split into S contiguous stages (the host balances the stages'
//     work).  Each stage's block holds its own layers' pool state and
//     stages its own service times.  A stage hands each request's ready
//     time (and its arrival) to the next stage through a ring of slots in
//     the next block's shared memory (distributed shared memory), with a
//     release / acquire count a side and a credit back, so no slot is
//     overwritten unread; a closed loop's last stage publishes completions
//     to stage 0 the same way.  Stage s runs request r while stage s+1 runs
//     request r-1;
//   * in a stage block, consumer warps run the pools and loader warps stage
//     service times into a ring of four chunk buffers, a loader warp a
//     chunk, signalled by each buffer's ready count and each consumer
//     warp's done count, so the loaders run up to three chunks ahead of the
//     slowest warp
//     and the consumers meet no block-wide barrier: one barrier of the
//     consumers a (request, layer), for the layer's completion;
//   * a pool of at most 8 servers runs on one thread, its lanes in
//     registers (1, 2, 4 or 8; one server is a plain running sum); a wider
//     pool runs on a whole warp, 1 to 32 lanes a thread, every thread also
//     keeping lanes 0 and 1: a job's chain is an add and a min, and lane 1
//     comes back from its owner by a shuffle (the KMAX 32 build keeps lanes
//     0..kRep on every thread instead, which takes that shuffle off the
//     chain); a pool of 33 to 512 servers, in a layer of at least 8
//     epochs' jobs a request, takes its jobs an epoch of up to 128 at a
//     time instead, when no end of the epoch falls among the lanes it
//     pops: the warp computes the epoch's ends at once and merges them,
//     sorted, into the lanes the epoch leaves (see merge_epoch);
//   * the kernel is built for the widest pool of a launch (KMAX 1, 4, 16 or
//     32 lanes a thread), so narrower launches keep fewer registers;
//   * each stage's pool state (a power of two of lanes a pool, at least 32
//     for a warp's) lives in shared memory when it fits, else in a global
//     scratch row per block;
//   * a pool wider than 1,024 servers (more than a warp's registers hold)
//     runs, in the KMAX 32 build, on a warp with its lanes in that state
//     memory: lane 0 comes from registers (replicas of lanes 0..kRep on
//     every thread, advanced with each end), and the warp
//     rewrites the sorted insert a row of 32 lanes at a time, stopping at
//     the first row that the end does not reach.  A pool may hold up to
//     65,536 servers.
// A launch with few configs still leaves most SMs idle, in the nature of a
// per-config recurrence: the clusters take S of them a config.
//
// The second entry, vtime_stream_launch, is the streaming replay of the
// fleet (the reference's _run_stream_kernel, src/repro/fabric/fleet.py:
// 104-164): the same stages over a segment of requests whose service
// indices are hashed in the kernel (fabric.vtime.hash_service_indices) or
// read from presampled tables, whose jobs may be coarsened into macro-jobs
// (vtime._chunk_services, a left fold of K patches), whose latencies fold
// into a log-bucket sketch, min / max and Welford moments
// (fabric.metrics.sketch_update), and whose lane state, closed-loop ring,
// sketch and horizon come from the caller and go back to it, so that one
// launch continues the previous one.  Each stage's loaders hash a chunk's
// sample rows once (not once a pool), then gather and fold; each stage
// reads and writes back only its own pools' lanes of the carry; the last
// stage keeps the sketch, moments, horizon and ring.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLayers = 64;
constexpr int kMaxPools = 1024;
constexpr int kMaxThreads = 512;  // the shared arrays' room; a build's own bound is build_threads

// The threads a block of a build runs at most (__launch_bounds__): 384 for
// KMAX 1 and 4 (170 registers a thread), 256 for the wider builds (255
// registers), and 192 for VT's KMAX 16 build without STATS, which keeps two
// blocks an SM (170 registers: the fused sweep's fabric stage launches
// hundreds of configs).  The host reads it back through vtime_max_threads.
constexpr int build_threads(int kmax, bool stats, bool stream) {
  return kmax <= 4 ? 384 : kmax == 16 && !stats && !stream ? 192 : 256;
}
constexpr int kMaxStages = 8;  // the portable cluster size
constexpr int kSmallPool = 8;  // pools of at most this many servers run on one thread
constexpr int kRegLanes = 1024;  // the widest pool a warp holds in registers (32 lanes a thread)
constexpr int kRep = 2;  // a pool in the state memory keeps its lanes 0..kRep in registers on every thread
constexpr int kBufs = 4;  // staging buffers of service times in a stage's ring
constexpr int kSlots = 16;  // slots of the ring between two stages
constexpr int kWarpRows = 1024;  // sample rows a streaming loader warp hashes once a chunk
constexpr size_t kMaxSmem = 232448;  // the most shared memory a block may use
constexpr size_t kStaticSmem = 20 * 1024;  // room kept for the kernel's own shared arrays
constexpr unsigned long long kTrapNs = 20ull * 1000 * 1000 * 1000;  // a wait this long is a fault

struct Args {
  const double* tables;      // per layer, per variant: (S_l, B_l) row-major
  const long long* tbl_off;  // (L, V) offsets into tables
  const long long* meta;     // (L, 5): B_l, P_l, pool offset, offset into idx, S_l
  const uint32_t* salts;     // (L) hash salts (streaming, hash mode), else null
  const int32_t* idx;        // per layer (N, P_l) sample indices, layer-major, or null (hash mode)
  const int32_t* plans;      // (C, L, 2) macro-job plans (K, n_bulk) (streaming), else null: exact
  const int32_t* variant;    // (C)
  const int32_t* lanes;      // (C, Ptot) servers (lane slots) per pool
  const double* arrivals;    // (C, N), or null for the closed loop
  const double* xfer;        // (C, L), or null
  double* t_arr;             // (C, N), or null (streaming without emit)
  double* comp;              // (C, N), or null (streaming without emit)
  double* busy;              // (C, L), STATS only
  double* wait;              // (C, L), STATS only
  unsigned long long* deep;  // VT: (1) jobs that epochs cut short by a deep insert sent one by one, or null
  double* state;             // scan: (C * S, state_stride) scratch rows; streaming: (C, carry_stride) carry
  double* ring;              // streaming: (C, ring_len) closed-loop completions, in and out
  double* counts;            // streaming: (C, n_bins) sketch bucket counts, in and out
  double* moments;           // streaming: (C, 5): n, min, max, mean, m2, in and out
  double* horizon;           // streaming: (C) largest completion, in and out
  long long state_stride;    // doubles of pool state one stage's block holds
  long long carry_stride;    // streaming: doubles of a config's carried state row
  long long r0;              // streaming: global id of the first request
  int N, L, V, Ptot, conc;   // conc 0: open loop
  int ring_len, n_bins, bins_per_octave, min_exp;
  int chunk;                 // doubles of service times a staging buffer holds (>= every B_l)
  int consumer_warps;        // warps that run the pools; the rest stage service times
  int smem_state;
  int stages;                // S, the cluster's blocks: stage s runs layers split[s] .. split[s+1]-1
  int split[kMaxStages + 1];
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

// ------------------------------------------------------------ synchronisation
// Counts in shared memory, read with acquire and written with release: at
// block scope between a stage's loaders and consumers, at cluster scope
// between stages (the writer stores into the reader's shared memory through
// cluster.map_shared_rank).  A wait of more than kTrapNs traps, so that a
// pipeline out of step ends in a CUDA error, not a hang.
template <bool CLUSTER>
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  if (CLUSTER) asm volatile("ld.acquire.cluster.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  else asm volatile("ld.acquire.cta.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <bool CLUSTER>
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  if (CLUSTER) asm volatile("st.release.cluster.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
  else asm volatile("st.release.cta.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// wait until *p >= target (modulo 2^32)
template <bool CLUSTER, bool SLEEP>
__device__ __forceinline__ void wait_for(const unsigned* p, unsigned target) {
  if ((int)(ld_acquire<CLUSTER>(p) - target) >= 0) return;
  const unsigned long long t0 = now_ns();
  for (unsigned n = 1;; ++n) {
    if (SLEEP) __nanosleep(64);
    if ((int)(ld_acquire<CLUSTER>(p) - target) >= 0) return;
    if ((n & 1023u) == 0 && now_ns() - t0 > kTrapNs) __trap();
  }
}

__device__ __forceinline__ void bar_named(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------------ the pools
// A small pool's jobs j < nj of a chunk on one thread, K lanes in registers;
// job j's service time is sv[j * B].  The service times are >= 0 (the
// wrapper checks), so end = f_0 + s >= f_0 and the sorted insert's lane 0 is
// min(end, f_1), exactly; with one server the lane is end itself and the
// ends only grow, so the last is the largest.  Jobs run 8 at a time with
// the next 8 times read ahead, unguarded, then the rest one by one.
template <int K, bool STATS>
__device__ double run_thread(double* st, const double* sv, int nj, int B, double t, double& bs, double& ws) {
  constexpr int kAhead = 8;
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
      bool pk = true;  // f_0 < end, or end == f_0 (then either branch keeps the value)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool pn = k + 1 < K && f[(k + 1) % K] < end;
        f[k] = pn ? f[(k + 1) % K] : pk ? end : f[k];
        pk = pn;
      }
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

// The replicas of a pool's lanes 0..kRep on every thread, advanced by
// one job with end: z_k <- (z_{k+1} < end) ? z_{k+1} : (z_k < end) ? end : z_k,
// lane kRep + 1's old value `g` read from the state memory.
__device__ __forceinline__ void advance_replicas(double (&z)[kRep + 1], double g, double end) {
  bool pk = true;
#pragma unroll
  for (int k = 0; k <= kRep; ++k) {
    const double up = k < kRep ? z[k + 1 > kRep ? kRep : k + 1] : g;
    const bool pn = up < end;
    z[k] = pn ? up : pk ? end : z[k];
    pk = pn;
  }
}

// A wide pool's jobs of a chunk on a whole warp: lane w holds the pool's
// lanes w*K .. w*K+K-1, and every thread also keeps the pool's lanes 0 and
// 1 (z0, z1).  A job's end is z0 + s and the new lane 0 is min(end, z1) on
// every thread, so the chain is an add and a min; the new lane 1 comes from
// its owner by a shuffle that overlaps the next job's add, and each
// thread's upper neighbour lane (old value) by another.  Every thread
// computes the same end, so the warp's maximum is uniform.
template <int K, bool STATS>
__device__ double run_warp_shuffle(double* st, const double* sv, int nj, int B, double t, int w, double& bs,
                                   double& ws) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int kAhead = 8;  // service times read ahead
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

// The same on a whole warp with replicas z of lanes 0..kRep on every
// thread, advanced with the warp-uniform end: the chain from one end to the
// next is an add, a compare and a select on registers, and lane kRep + 1
// (old value) reaches the replicas by a shuffle from its owner issued a
// job ahead, which lane k of the replicas needs only kRep - k jobs later.
// More instructions a job than the shuffle's chain saves, except in the
// widest pools (chip_vt_variants.py).
template <int K, bool STATS>
__device__ double run_warp_replicas(double* st, const double* sv, int nj, int B, double t, int w, double& bs,
                                    double& ws) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int kAhead = K == 1 ? 8 : K >= 8 ? 2 : 4;  // service times read ahead: more for quicker jobs
  constexpr int go = (kRep + 1) / K, gk = (kRep + 1) % K;  // owner thread and slot of lane kRep + 1
  double f[K], z[kRep + 1];
#pragma unroll
  for (int k = 0; k < K; ++k) f[k] = dmax(st[w * K + k], t);
#pragma unroll
  for (int k = 0; k <= kRep; ++k) z[k] = dmax(st[k], t);
  double g = dmax(st[kRep + 1], t);
  double mx = -CUDART_INF;
  auto step = [&](double s) {
    double above = __shfl_down_sync(kFull, f[0], 1);
    if (w == 31) above = CUDART_INF;
    const double end = __dadd_rn(z[0], s);
    if (STATS && w == 0) {
      bs = __dadd_rn(bs, s);
      ws = __dadd_rn(ws, __dsub_rn(z[0], t));
    }
    advance_replicas(z, g, end);
    bool pk = f[0] < end;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const double up = k + 1 < K ? f[(k + 1) % K] : above;
      const bool pn = up < end;
      f[k] = pn ? up : pk ? end : f[k];
      pk = pn;
    }
    g = __shfl_sync(kFull, f[gk], go);
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

// The warp pool a build runs: replicas in the KMAX 32 build (pools wider
// than 512 servers), the shuffle of lane 1 in the others, whichever
// measured faster for that build on the H100 (chip_vt_variants.py).
__host__ __device__ constexpr bool warp_replicas(int kmax) { return kmax == 32; }

template <int K, int KMAX, bool STATS>
__device__ __forceinline__ double run_warp(double* st, const double* sv, int nj, int B, double t, int w, double& bs,
                                           double& ws) {
  if constexpr (warp_replicas(KMAX)) return run_warp_replicas<K, STATS>(st, sv, nj, B, t, w, bs, ws);
  else return run_warp_shuffle<K, STATS>(st, sv, nj, B, t, w, bs, ws);
}

// A pool wider than kRegLanes on a whole warp, its `cap` lanes (a power of
// two) in the state memory `st`, sorted ascending (+inf: absent).  Lanes
// 0..kRep are replicated in registers on every thread, so a job's end does
// not wait on the state memory; the sorted insert then rewrites only the rows
// of 32 lanes below the first row whose lowest lane is already >= end:
// lanes at or above it keep their values (they are >= end, so min(max(f,
// end), f_next) = f).  A lane below `end` becomes min(end, f_next), with
// f_next read before any lane of its row changes.
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
  double z[kRep + 1];
#pragma unroll
  for (int k = 0; k <= kRep; ++k) z[k] = st[k];
  double mx = -CUDART_INF;
  for (int j = 0; j < nj; ++j) {
    const double s = sv[j * B];
    const double g = st[kRep + 1];  // lane kRep + 1 before this job
    const double end = __dadd_rn(z[0], s);
    if (STATS && w == 0) {
      bs = __dadd_rn(bs, s);
      ws = __dadd_rn(ws, __dsub_rn(z[0], t));
    }
    advance_replicas(z, g, end);
    __syncwarp();
    for (int m = 0; m < cap; m += 32) {
      const int i = m + w;
      const double a = st[i];
      const double up = i + 1 < cap ? st[i + 1] : CUDART_INF;
      const double next_row = __shfl_sync(kFull, up, 31);
      __syncwarp();
      if (a < end) st[i] = up < end ? up : end;
      __syncwarp();
      if (next_row >= end) break;
    }
    mx = dmax(mx, end);
  }
  return mx;
}

// ------------------------------------------------------------ merged epochs
// A warp pool of 33 to 512 servers (kMergeTop; every build but KMAX 1)
// takes its jobs an epoch of up to `me` at a time (at most 128, three
// quarters of its servers: merge_shape), its lanes f_0 <= ... <= f_{d-1}
// sorted in the pool state.  Job i of the epoch pops f_i and ends at e_i =
// f_i + s_i as long as no earlier end of the epoch is below f_i: then the
// jobs one by one pop f_0, f_1, ... in turn.  Thread w holds jobs w, w +
// 32, ...: the warp computes every end at once, and one vote finds whether
// any end is below the last pop f_{me-1}; if one is (a deep insert), a
// prefix-min scan of the ends finds the first job whose pop an earlier end
// undercuts, and the epoch ends before it (the pops it does not take go
// back in among its ends).  The new lanes are the sorted union of the
// lanes the epoch leaves and its ends: the multiset the jobs
// one by one leave, so the same array, bit for bit.  The ends are sorted
// descending by a bitonic network and merged with the lanes the epoch
// leaves (ascending, +inf above them) by a bitonic merge, in registers, 32
// lanes a register, then written back: a job costs a share of the epoch's
// shuffles, not a pass over every lane.  A chunk's last jobs take an epoch
// of their own, when they are at least half of one.  An epoch cut to less
// than half its jobs (a deep insert) sends the next jobs one by one through
// the lanes in registers (run_warp): me of them, and twice as many after
// each further such epoch, up to 16 me; so do a chunk's last jobs short of
// half an epoch (run_merged).  A layer of fewer than kMinEpochs epochs' jobs
// a request runs them one by one (run_pools): an epoch's code is long (its
// networks unrolled, a copy for each shape), and launches whose blocks go
// through pools of many widths with few jobs each lost by it (513 configs
// of 16 to 512 jobs a layer and pools of 1 to 256 servers: 2.2x the time
// of one by one at 0 epochs, 1.7x at 4, 1.1x at 8; chip_vt_variants.py).
// chip_vt_variants.py times kMerge false: every job one by one.
constexpr bool kMerge = true;
constexpr int kMergeTop = 512;  // the widest pool that merges epochs
constexpr int kMinEpochs = 8;   // epochs' jobs a layer needs a request to merge them

// the builds whose warp pools merge epochs (the KMAX 1 build holds no pool
// wider than 32)
__host__ __device__ constexpr bool merge_build(int kmax) { return kMerge && kmax > 1; }

__host__ __device__ constexpr bool merge_pool(int d, int kmax) {
  return merge_build(kmax) && d > 32 && d <= kMergeTop;
}

// a pool of d servers: nb registers of ends (an epoch of me <= 32 nb jobs)
// and t registers in all, which hold the d - me lanes the epoch leaves and
// then the ends
struct MergeShape {
  int nb, me, t;
};
__device__ __forceinline__ MergeShape merge_shape(int d) {
  const int nb = d >= 171 ? 4 : d >= 86 ? 2 : 1;
  const int me = min(32 * nb, 3 * d / 4);
  return {nb, me, pow2_ceil(nb + (d - me + 31) / 32)};
}

// a <- the lower of the two, b <- the higher
__device__ __forceinline__ void cx(double& a, double& b) {
  const bool sw = b < a;
  const double lo = sw ? b : a;
  b = sw ? a : b;
  a = lo;
}

// thread w's value after a compare-exchange with lane w ^ dd: the lower of
// the two when `low`, else the higher
__device__ __forceinline__ double cx_lane(double x, int dd, bool low) {
  const double y = __shfl_xor_sync(0xffffffffu, x, dd);
  return (y < x) == low ? y : x;
}

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

// the 32 NB values e[k] of threads w (value 32 k + w) sorted descending
// (the loops count exponents, so that they unroll and every index is a
// register)
template <int NB>
__device__ __forceinline__ void bitonic_sort_desc(double (&e)[NB], int w) {
#pragma unroll
  for (int ls = 1; ls <= ilog2(32 * NB); ++ls) {
#pragma unroll
    for (int ld = ls - 1; ld >= 0; --ld) {
      const int size = 1 << ls, dd = 1 << ld;
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        // the block of `size` values this one is in ascends (the last one
        // descends, and so the whole)
        const bool up = size >= 32 ? ((32 * k) & size) != 0 : (w & size) != 0;
        if (dd >= 32) {
          const int r = dd / 32;
          if (!(k & r)) {
            if (up) cx(e[k], e[k | r]);
            else cx(e[k | r], e[k]);
          }
        } else {
          e[k] = cx_lane(e[k], dd, ((w & dd) == 0) == up);
        }
      }
    }
  }
}

// a bitonic sequence of the 32 T values g[k] of threads w merged ascending
template <int T>
__device__ __forceinline__ void bitonic_merge_asc(double (&g)[T], int w) {
#pragma unroll
  for (int ld = ilog2(16 * T); ld >= 0; --ld) {
    const int dd = 1 << ld;
#pragma unroll
    for (int k = 0; k < T; ++k) {
      if (dd >= 32) {
        if (!(k & (dd / 32))) cx(g[k], g[k | (dd / 32)]);
      } else {
        g[k] = cx_lane(g[k], dd, (w & dd) == 0);
      }
    }
  }
}

// what an epoch took: its jobs (at least 1), and this thread's largest end
// and, with STATS, service and wait sums
struct EpochOut {
  double mx, bs, ws;
  int jobs;
};

// One epoch of up to min(me, left) jobs, job i's service time sv[i * B],
// on a pool's d sorted lanes st, already clamped to t, by lane w of its
// warp (a call of its own, so that its registers do not crowd run_warp's).
// It pops lanes 0..me-1 in any case: those of jobs it does not take go back
// in with its ends.
template <int NB, int T, bool STATS>
__device__ __noinline__ EpochOut merge_epoch(double* st, const double* sv, int B, double t, int d, int me, int left,
                                             int w) {
  constexpr unsigned kFull = 0xffffffffu;
  double q[NB], s[NB], e[NB], g[T];
  const double last = st[me - 1];
  int n = min(me, left);
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const int v = 32 * k + w;
    q[k] = v < me ? st[v] : 0.0;
    s[k] = v < n ? sv[(size_t)v * B] : 0.0;
  }
  // the lanes the epoch leaves, ascending, then +inf
#pragma unroll
  for (int k = 0; k < T - NB; ++k) {
    const int u = 32 * k + w;
    g[k] = u < d - me ? st[me + u] : CUDART_INF;
  }
  bool deep = false;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const int v = 32 * k + w;
    e[k] = v < n ? __dadd_rn(q[k], s[k]) : CUDART_INF;
    deep |= e[k] < last;
  }
  if (__any_sync(kFull, deep)) {
    // the first job whose pop is above an earlier end: the ends' prefix
    // minimum, a row of 32 at a time (shuffles up), carried across rows
    double carry = CUDART_INF;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      double x = e[k];
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const double y = __shfl_up_sync(kFull, x, o);
        if (w >= o) x = dmin(x, y);
      }
      double before = __shfl_up_sync(kFull, x, 1);
      before = dmin(w == 0 ? CUDART_INF : before, carry);
      const unsigned cut = __ballot_sync(kFull, 32 * k + w < n && before < q[k]);
      if (cut) n = min(n, 32 * k + __ffs(cut) - 1);
      carry = dmin(carry, __shfl_sync(kFull, x, 31));
    }
  }
  // the pops the epoch does not take stay lanes: they go in with the ends
#pragma unroll
  for (int k = 0; k < NB; ++k)
    if (32 * k + w >= n && 32 * k + w < me) e[k] = q[k];
  EpochOut out{-CUDART_INF, 0.0, 0.0, n};
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    if (32 * k + w < n) {
      out.mx = dmax(out.mx, e[k]);
      if (STATS) {
        out.bs = __dadd_rn(out.bs, s[k]);
        out.ws = __dadd_rn(out.ws, __dsub_rn(q[k], t));
      }
    }
  }
  bitonic_sort_desc<NB>(e, w);
#pragma unroll
  for (int k = 0; k < NB; ++k) g[T - NB + k] = e[k];
  bitonic_merge_asc<T>(g, w);
  __syncwarp();  // every thread has read the lanes before any is written
#pragma unroll
  for (int k = 0; k < T; ++k)
    if (32 * k + w < d) st[32 * k + w] = g[k];
  __syncwarp();
  return out;
}

// an epoch of the pool's shape (merge_shape); the KMAX 4 build holds pools
// of at most 128 servers
template <int KMAX, bool STATS>
__device__ __forceinline__ EpochOut merge_epoch_of(MergeShape m, double* st, const double* sv, int B, double t, int d,
                                                   int left, int w) {
  if (m.nb == 1)
    return m.t == 2 ? merge_epoch<1, 2, STATS>(st, sv, B, t, d, m.me, left, w)
                    : merge_epoch<1, 4, STATS>(st, sv, B, t, d, m.me, left, w);
  if constexpr (KMAX == 4) {
    return merge_epoch<2, 4, STATS>(st, sv, B, t, d, m.me, left, w);
  } else {
    if (m.nb == 2)
      return m.t == 4 ? merge_epoch<2, 4, STATS>(st, sv, B, t, d, m.me, left, w)
                      : merge_epoch<2, 8, STATS>(st, sv, B, t, d, m.me, left, w);
    return m.t == 8 ? merge_epoch<4, 8, STATS>(st, sv, B, t, d, m.me, left, w)
                    : merge_epoch<4, 16, STATS>(st, sv, B, t, d, m.me, left, w);
  }
}

// A warp pool's jobs one by one, its lanes in registers, K a thread (1 to
// KMAX, pow2(servers) / 32), or in the state memory above 1,024 servers
template <int KMAX, bool STATS>
__device__ __forceinline__ double run_warp_of(double* st, const double* sv, int nj, int B, double t, int d, int w,
                                              double& bs, double& ws) {
  const int k = pow2_ceil(d) / 32;
  if constexpr (KMAX == 1) {
    return run_warp<1, KMAX, STATS>(st, sv, nj, B, t, w, bs, ws);
  } else if constexpr (KMAX == 4) {
    return k <= 1   ? run_warp<1, KMAX, STATS>(st, sv, nj, B, t, w, bs, ws)
           : k == 2 ? run_warp<2, KMAX, STATS>(st, sv, nj, B, t, w, bs, ws)
                    : run_warp<4, KMAX, STATS>(st, sv, nj, B, t, w, bs, ws);
  } else if constexpr (KMAX == 16) {
    return k <= 1   ? run_warp<1, KMAX, STATS>(st, sv, nj, B, t, w, bs, ws)
           : k == 2 ? run_warp<2, KMAX, STATS>(st, sv, nj, B, t, w, bs, ws)
           : k == 4 ? run_warp<4, KMAX, STATS>(st, sv, nj, B, t, w, bs, ws)
           : k == 8 ? run_warp<8, KMAX, STATS>(st, sv, nj, B, t, w, bs, ws)
                    : run_warp<16, KMAX, STATS>(st, sv, nj, B, t, w, bs, ws);
  } else {
    // the host gives a launch with a pool wider than 512 the KMAX 32 build
    return d > kRegLanes ? run_mem<STATS>(st, sv, nj, B, t, pool_cap(d), w, bs, ws)
           : k <= 1      ? run_warp<1, KMAX, STATS>(st, sv, nj, B, t, w, bs, ws)
           : k == 2      ? run_warp<2, KMAX, STATS>(st, sv, nj, B, t, w, bs, ws)
           : k == 4      ? run_warp<4, KMAX, STATS>(st, sv, nj, B, t, w, bs, ws)
           : k == 8      ? run_warp<8, KMAX, STATS>(st, sv, nj, B, t, w, bs, ws)
           : k == 16     ? run_warp<16, KMAX, STATS>(st, sv, nj, B, t, w, bs, ws)
                         : run_warp<32, KMAX, STATS>(st, sv, nj, B, t, w, bs, ws);
  }
}

// what a merging pool's chunk took: this thread's largest end and, with
// STATS, service and wait sums, and the jobs short epochs sent one by one
struct MergedOut {
  double mx, bs, ws;
  unsigned deep;
};

// A merging pool's chunk of nj jobs (merge_pool) by lane w of its warp: its
// lanes clamped to t, then epochs while half an epoch's jobs are left;
// after an epoch that takes less than half the jobs it could, the next me
// jobs one by one (twice as many after each further such epoch, up to 16
// me), as the chunk's last jobs short of half an epoch.  An epoch costs
// what 0.3 to 0.6 of its jobs one by one would (the narrower the pool, the
// more: chip_vt_variants.py).  A call of its own, so that the merging does not
// crowd the other pools' registers.
template <int KMAX, bool STATS>
__device__ __noinline__ MergedOut run_merged(double* st, const double* sv, int nj, int B, double t, int d, int w) {
  const MergeShape ms = merge_shape(d);
  // every lane clamped to t, a row of 32 at a time up to the first row
  // whose top is >= t
  for (int r = 0; r < d; r += 32) {
    const int u = r + w;
    const double x = u < d ? st[u] : CUDART_INF;
    if (x < t) st[u] = t;
    if (__shfl_sync(0xffffffffu, x, 31) >= t) break;
  }
  __syncwarp();
  MergedOut out{-CUDART_INF, 0.0, 0.0, 0u};
  int back = 0, cuts = 0;  // jobs to run one by one before the next epoch; short epochs in a row
  for (int j = 0; j < nj;) {
    while (back == 0 && 2 * (nj - j) >= ms.me) {
      const EpochOut o = merge_epoch_of<KMAX, STATS>(ms, st, sv + (size_t)j * B, B, t, d, nj - j, w);
      out.mx = dmax(out.mx, o.mx);
      if (STATS) {
        out.bs = __dadd_rn(out.bs, o.bs);
        out.ws = __dadd_rn(out.ws, o.ws);
      }
      if (2 * o.jobs < min(ms.me, nj - j)) {
        back = ms.me << min(cuts++, 4);
        out.deep += min(back, nj - j - o.jobs);
      } else {
        cuts = 0;
      }
      j += o.jobs;
    }
    const int n = min(nj - j, back > 0 ? back : ms.me);
    back = 0;
    if (n > 0) {
      double b2 = 0.0, w2 = 0.0;
      out.mx = dmax(out.mx, run_warp_of<KMAX, STATS>(st, sv + (size_t)j * B, n, B, t, d, w, b2, w2));
      if (STATS) {
        out.bs = __dadd_rn(out.bs, b2);
        out.ws = __dadd_rn(out.ws, w2);
      }
      __syncwarp();  // its lanes are written before an epoch reads them
      j += n;
    }
  }
  return out;
}

// One chunk of nj of a layer's pj jobs a request over its pools, by the
// consumer threads: the layer's pools of at most 8 servers a thread each,
// the wider ones a warp each (lists built once a block, so that no warp
// takes two pools while another idles).  Folds each pool's largest end into mx (per thread: the
// layer's completion reduces it over the warp), the jobs that merging
// pools' short epochs sent one by one into `deep` and, with STATS, the
// service and wait sums into bs / ws.
template <int KMAX, bool STATS>
__device__ __forceinline__ void run_pools(double* state, const int* s_off, const int* s_lanes, const int* list,
                                          int n_small, int n_wide, int po, int B, const double* sv, int nj, int pj,
                                          double t, int tid, int nc, int warp, int lane, int consumer_warps, double& mx,
                                          double& bs, double& ws, unsigned& deep) {
  for (int i = tid; i < n_small; i += nc) {
    const int p = list[i];
    const int d = s_lanes[po + p];
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
  for (int i = warp; i < n_wide; i += consumer_warps) {  // warp-uniform
    const int p = list[n_small + i];
    const int d = s_lanes[po + p];
    double* st = state + s_off[po + p];
    double b2 = 0.0, w2 = 0.0, m;
    if constexpr (merge_build(KMAX)) {
      if (merge_pool(d, KMAX) && pj >= kMinEpochs * merge_shape(d).me) {
        const MergedOut o = run_merged<KMAX, STATS>(st, sv + p, nj, B, t, d, lane);
        m = o.mx;
        b2 = o.bs;
        w2 = o.ws;
        deep += o.deep;
      } else {
        m = run_warp_of<KMAX, STATS>(st, sv + p, nj, B, t, d, lane, b2, w2);
      }
    } else {
      m = run_warp_of<KMAX, STATS>(st, sv + p, nj, B, t, d, lane, b2, w2);
    }
    mx = dmax(mx, m);
    if (STATS) {
      bs = __dadd_rn(bs, b2);
      ws = __dadd_rn(ws, w2);
    }
  }
}

// ------------------------------------------------------------------- staging
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

// first patch of streaming job jj: macro-jobs jj < nbulk fold K patches each
__device__ __forceinline__ int first_patch(int jj, int K, int nbulk) {
  return jj < nbulk ? jj * K : nbulk * K + (jj - nbulk);
}

// Gather and left-fold, for the elements e < n of a streaming chunk
// ([job][pool], jobs from j0), the patches whose sample rows lie in `rows`:
// the chunk's patches q0 .. q1 - 1 (relative to its first, p_lo).  Eight
// elements a thread at a time, their loads in flight together.  With
// PIECES a macro-job may have begun in an earlier piece: its fold goes on
// from the partial sum that piece left in `dst`.
template <bool PIECES>
__device__ __forceinline__ void fold_rows(double* dst, const int* rows, const double* tbl, const int* lanes, int j0,
                                          int n, int B, int K, int nbulk, int p_lo, int q0, int q1, int first,
                                          int step) {
  for (int e0 = first; e0 < n; e0 += 8 * step) {
    int a[8], k[8], pp[8];  // an element's first row in `rows` (-1: its fold goes on) and its count there
    double v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * step, jj = j0 + e / B;
      pp[u] = e - (e / B) * B;
      const bool live = e < n && lanes[pp[u]];
      const int p0 = first_patch(jj, K, nbulk) - p_lo, kj = jj < nbulk ? K : 1;
      if (PIECES) {
        a[u] = p0 < q0 ? -1 : p0 - q0;
        k[u] = live ? max(0, min(p0 + kj, q1) - max(p0, q0)) : 0;
        v[u] = live && p0 < q0 ? dst[e] : 0.0;
      } else {
        a[u] = p0;
        k[u] = live ? kj : 0;
        v[u] = 0.0;
      }
    }
    const int kmax = max(max(max(k[0], k[1]), max(k[2], k[3])), max(max(k[4], k[5]), max(k[6], k[7])));
    for (int q = 0; q < kmax; ++q) {
      double x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        x[u] = q < k[u] ? __ldg(tbl + (size_t)rows[(PIECES ? max(a[u], 0) : a[u]) + q] * B + pp[u]) : 0.0;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (q < k[u]) v[u] = q == 0 && (!PIECES || a[u] >= 0) ? x[u] : __dadd_rn(v[u], x[u]);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * step;
      if (e < n) dst[e] = v[u];
    }
  }
}

// Stage one streaming chunk of a layer's jobs j0 .. j0 + nj - 1, [job][pool],
// for the pools that have servers, by one loader warp.  Job jj < n_bulk is
// the left fold of the K patches jj*K .. jj*K+K-1 (vtime._chunk_services), a
// later job one patch.  The chunk's patches are contiguous: first their
// sample rows, hashed from (salt, r, patch) or read from `ix`, once each
// into the warp's `rows` (not once a pool); then the gathers and folds.
// A chunk spans more than kWarpRows patches only when it is one macro-job
// of K > kWarpRows patches: then the rows are taken kWarpRows at a time.
__device__ __forceinline__ void stage_stream(double* dst, int* rows, const double* tbl, const int32_t* ix,
                                             uint32_t salt, uint32_t r, int S, const int* lanes, int j0, int nj,
                                             int B, int K, int nbulk, int first, int step) {
  const int p_lo = first_patch(j0, K, nbulk);
  const int last = j0 + nj - 1;
  const int np = first_patch(last, K, nbulk) + (last < nbulk ? K : 1) - p_lo;
  for (int q0 = 0; q0 < np; q0 += kWarpRows) {
    const int q1 = min(np, q0 + kWarpRows);
    if (q0) __syncwarp();  // every thread is done with the previous piece's rows
    for (int q = q0 + first; q < q1; q += step) {
      const int p = p_lo + q;
      rows[q - q0] = ix ? __ldg(ix + p) : (int)(hash_index(salt, r, (uint32_t)p) % (uint32_t)S);
    }
    __syncwarp();
    if (np <= kWarpRows) fold_rows<false>(dst, rows, tbl, lanes, j0, nj * B, B, K, nbulk, p_lo, 0, np, first, step);
    else fold_rows<true>(dst, rows, tbl, lanes, j0, nj * B, B, K, nbulk, p_lo, q0, q1, first, step);
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

// ------------------------------------------------------------------ a stage
// One block of a config's cluster: stage s = the block's rank, layers
// split[s] .. split[s+1]-1.  The first 32 * consumer_warps threads run the
// pools; the rest stage service times.  Both walk the same sequence of
// chunks: requests in order, the stage's layers in order, `per` jobs a
// chunk.
template <int KMAX, bool STATS, bool STREAM>
__device__ __forceinline__ void vt_stage(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ long long s_tbl[kMaxLayers], s_io[kMaxLayers];
  __shared__ int s_nb[kMaxLayers], s_np[kMaxLayers], s_po[kMaxLayers], s_ns[kMaxLayers];
  __shared__ int s_k[kMaxLayers], s_bulk[kMaxLayers], s_jobs[kMaxLayers], s_per[kMaxLayers];
  __shared__ int s_nsmall[kMaxLayers], s_nwide[kMaxLayers];
  __shared__ uint32_t s_salt[kMaxLayers];
  __shared__ double s_xfer[kMaxLayers], s_acc_b[kMaxLayers], s_acc_w[kMaxLayers];
  __shared__ int s_off[kMaxPools + 1], s_lanes[kMaxPools], s_list[kMaxPools];
  __shared__ double s_red[2][kMaxThreads / 32], s_bsum[2][kMaxThreads / 32], s_wsum[2][kMaxThreads / 32];
  __shared__ double s_slot[kSlots][2];  // (ready time, arrival) of request r in slot r % kSlots
  __shared__ double s_mom[6];  // streaming, last stage: n, min, max, mean, m2, horizon
  __shared__ double s_t0;  // stage 0: the current request's arrival
  __shared__ int s_base;
  __shared__ unsigned s_ready[kBufs];  // buffer b holds chunk s_ready[b] - 1
  __shared__ unsigned s_wdone[kMaxThreads / 32];  // chunks each consumer warp is done with
  __shared__ unsigned s_head;    // requests handed in by the previous stage
  __shared__ unsigned s_credit;  // requests the next stage has taken out of its slots
  __shared__ unsigned s_done;    // stage 0 of a closed loop: completions the last stage has published

  cg::cluster_group cluster = cg::this_cluster();
  const int S = a.stages;
  const int s = (int)cluster.block_rank();
  const int c = blockIdx.x / S;
  const int lo = a.split[s], hi = a.split[s + 1];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int cw = a.consumer_warps, nc = 32 * cw;
  const bool loader = tid >= nc;
  const int v = a.variant[c];
  for (int l = tid; l < a.L; l += nthreads) {
    s_tbl[l] = a.tbl_off[(size_t)l * a.V + v];
    const int B = (int)a.meta[5 * l], P = (int)a.meta[5 * l + 1];
    s_nb[l] = B;
    s_np[l] = P;
    s_po[l] = (int)a.meta[5 * l + 2];
    s_io[l] = a.meta[5 * l + 3];
    s_ns[l] = (int)a.meta[5 * l + 4];
    s_salt[l] = a.salts ? a.salts[l] : 0u;
    const int K = a.plans ? a.plans[((size_t)c * a.L + l) * 2] : 1;
    const int nb = a.plans ? a.plans[((size_t)c * a.L + l) * 2 + 1] : 0;
    s_k[l] = K;
    s_bulk[l] = nb;
    s_jobs[l] = nb + P - nb * K;  // macro-jobs, then the exact tail
    s_per[l] = max(1, min(a.chunk / B, STREAM ? kWarpRows / K : a.chunk));
    s_xfer[l] = a.xfer ? a.xfer[(size_t)c * a.L + l] : 0.0;
    s_acc_b[l] = 0.0;
    s_acc_w[l] = 0.0;
  }
  for (int q = tid; q < a.Ptot; q += nthreads) s_lanes[q] = a.lanes[(size_t)c * a.Ptot + q];
  if (tid == 0) {
    s_head = s_credit = s_done = 0u;
  }
  if (tid < kMaxThreads / 32) s_wdone[tid] = 0u;
  if (tid < kBufs) s_ready[tid] = 0u;
  __syncthreads();
  if (tid == 0) {
    // each pool's first lane in the config's state, then the stage's pools
    // relative to the stage's first; per layer the small pools, then the wide
    int off = 0;
    for (int q = 0; q < a.Ptot; ++q) {
      s_off[q] = off;
      off += pool_cap(s_lanes[q]);
    }
    s_off[a.Ptot] = off;
    const int base = s_off[s_po[lo]];
    s_base = base;
    for (int q = s_po[lo]; q <= s_po[hi - 1] + s_nb[hi - 1]; ++q) s_off[q] -= base;
    for (int l = lo; l < hi; ++l) {
      const int po = s_po[l], B = s_nb[l];
      int n = 0;
      for (int p = 0; p < B; ++p)
        if (s_lanes[po + p] >= 1 && s_lanes[po + p] <= kSmallPool) s_list[po + n++] = p;
      s_nsmall[l] = n;
      for (int p = 0; p < B; ++p)
        if (s_lanes[po + p] > kSmallPool) s_list[po + n++] = p;
      s_nwide[l] = n - s_nsmall[l];
    }
  }
  __syncthreads();
  const int q_lo = s_po[lo], q_hi = s_po[hi - 1] + s_nb[hi - 1];
  const int span = s_off[q_hi];  // the stage's lanes of state
  // dynamic shared memory: kBufs buffers of staged service times, the pool
  // state when it lives here, the streaming loaders' rows
  double* sbuf = reinterpret_cast<double*>(smem_raw);
  double* gst = STREAM ? a.state + (size_t)c * a.carry_stride + s_base : a.state + (size_t)blockIdx.x * a.state_stride;
  double* state = a.smem_state ? sbuf + (size_t)kBufs * a.chunk : gst;
  int* rows = reinterpret_cast<int*>(sbuf + (size_t)kBufs * a.chunk + (a.smem_state ? a.state_stride : 0));
  if (STREAM) {
    if (a.smem_state)
      for (int i = tid; i < span; i += nthreads) state[i] = gst[i];
  } else {
    for (int q = q_lo + warp; q < q_hi; q += nwarps) {
      const int d = s_lanes[q], cap = pool_cap(d);
      for (int i = lane; i < cap; i += 32) state[s_off[q] + i] = i < d ? 0.0 : CUDART_INF;
    }
  }
  // every block's counts and slots are set before any other block writes them
  cluster.sync();

  if (loader) {
    // loader warp lw stages chunks k = lw, lw + nlw, ... on its own, so that
    // as many chunks as there are loader warps are in flight at once
    const int lw = warp - cw, nlw = nwarps - cw;
    int* wrows = rows + lw * kWarpRows;
    unsigned k = 0;
    for (int r = 0; r < a.N; ++r) {
      for (int l = lo; l < hi; ++l) {
        const int B = s_nb[l], Pj = s_jobs[l], per = s_per[l];
        for (int j0 = 0; j0 < Pj; j0 += per, ++k) {
          if (k % nlw != (unsigned)lw) continue;
          // chunk k takes the buffer of chunk k - kBufs: every consumer warp
          // is done with it (a warp without pools may be chunks ahead of one
          // with many, so each warp counts its own)
          if (k >= (unsigned)kBufs)
            for (int w = 0; w < cw; ++w) wait_for<false, true>(&s_wdone[w], k - kBufs + 1);
          double* dst = sbuf + (size_t)(k % kBufs) * a.chunk;
          const int nj = min(per, Pj - j0);
          if (STREAM) {
            const int32_t* ix = a.idx ? a.idx + s_io[l] + (size_t)r * s_np[l] : nullptr;
            stage_stream(dst, wrows, a.tables + s_tbl[l], ix, s_salt[l], (uint32_t)(a.r0 + r), s_ns[l],
                         s_lanes + s_po[l], j0, nj, B, s_k[l], s_bulk[l], lane, 32);
          } else {
            stage(dst, a.tables + s_tbl[l], a.idx + s_io[l] + (size_t)r * s_np[l] + j0, s_lanes + s_po[l], nj, B, lane,
                  32);
          }
          __syncwarp();
          if (lane == 0) st_release<false>(&s_ready[k % kBufs], k + 1);
        }
      }
    }
  } else {
    const bool first = s == 0, final = s == S - 1;
    double t = 0.0, t_prev = 0.0, mx = -CUDART_INF, bs = 0.0, ws = 0.0;
    unsigned deep = 0;  // this warp's jobs that short epochs sent one by one
    if (STREAM && final && tid == 0) {  // the sketch's moments and horizon, kept by thread 0 of the last stage
      for (int i = 0; i < 5; ++i) s_mom[i] = a.moments[(size_t)c * 5 + i];
      s_mom[5] = a.horizon[c];
    }
    double* ring = STREAM ? a.ring + (size_t)c * a.ring_len : nullptr;
    double arr_next = first && a.conc == 0 ? a.arrivals[(size_t)c * a.N] : 0.0;
    int parity = 0;
    unsigned k = 0;
    for (int r = 0; r < a.N; ++r) {
      if (first) {
        if (a.conc == 0) {
          t = arr_next;
          if (r + 1 < a.N) arr_next = a.arrivals[(size_t)c * a.N + r + 1];
        } else if (r < a.conc) {
          // a closed loop's first requests: 0, or the carried ring
          t = STREAM ? ring[(a.r0 + r) % a.conc] : 0.0;
        } else if (S == 1 && a.conc == 1) {
          t = t_prev;
        } else if (S == 1) {
          // written by thread 0 at the end of request r - conc; the
          // consumers' barriers of request r - 1 have ordered it since
          t = STREAM ? ring[(a.r0 + r) % a.conc] : a.comp[(size_t)c * a.N + r - a.conc];
        } else {
          wait_for<true, false>(&s_done, (unsigned)(r - a.conc + 1));
          t = STREAM ? __ldcg(ring + (a.r0 + r) % a.conc) : __ldcg(a.comp + (size_t)c * a.N + r - a.conc);
        }
        if (tid == 0) s_t0 = t;  // the request's arrival, which only thread 0 reads
      } else {
        wait_for<true, false>(&s_head, (unsigned)(r + 1));
        t = s_slot[r % kSlots][0];
      }
      for (int l = lo; l < hi; ++l) {
        if (a.xfer) t = __dadd_rn(t, s_xfer[l]);
        const int B = s_nb[l], Pj = s_jobs[l], per = s_per[l], po = s_po[l];
        for (int j0 = 0; j0 < Pj; j0 += per, ++k) {
          wait_for<false, false>(&s_ready[k % kBufs], k + 1);
          run_pools<KMAX, STATS>(state, s_off, s_lanes, s_list + po, s_nsmall[l], s_nwide[l], po, B,
                                 sbuf + (size_t)(k % kBufs) * a.chunk, min(per, Pj - j0), Pj, t, tid, nc, warp, lane,
                                 cw, mx, bs, ws, deep);
          __syncwarp();
          if (lane == 0) st_release<false>(&s_wdone[warp], k + 1);
        }
        // the layer's completion: one barrier of the consumers; the
        // reduction buffers alternate by layer, so a warp that runs ahead
        // cannot overwrite what a slower one still reads
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
        bar_named(1, nc);
        double done = s_red[parity][0], done2 = -CUDART_INF;
        for (int w = 1; w < cw; w += 2) {
          done = dmax(done, s_red[parity][w]);
          if (w + 1 < cw) done2 = dmax(done2, s_red[parity][w + 1]);
        }
        if (STATS && tid == 0) {
          double sb = 0.0, sw = 0.0;
          for (int w = 0; w < cw; ++w) {
            sb = __dadd_rn(sb, s_bsum[parity][w]);
            sw = __dadd_rn(sw, s_wsum[parity][w]);
          }
          s_acc_b[l] = __dadd_rn(s_acc_b[l], sb);
          s_acc_w[l] = __dadd_rn(s_acc_w[l], sw);
        }
        t = dmax(dmax(done, done2), t);
        parity ^= 1;
        mx = -CUDART_INF;
        bs = ws = 0.0;
      }
      // the request leaves the stage
      if (tid == 0) {
        const double t0 = first ? s_t0 : s_slot[r % kSlots][1];
        if (!final) {
          // wait for the next stage to have taken request r - kSlots out of its slot
          wait_for<true, false>(&s_credit, (unsigned)(r - kSlots + 1));
          double* slot = cluster.map_shared_rank(&s_slot[r % kSlots][0], s + 1);
          slot[0] = t;
          slot[1] = t0;
          st_release<true>(cluster.map_shared_rank(&s_head, s + 1), (unsigned)(r + 1));
        } else {
          if (a.comp) {
            a.t_arr[(size_t)c * a.N + r] = t0;
            a.comp[(size_t)c * a.N + r] = t;
          }
          if (STREAM) {
            if (a.conc) ring[(a.r0 + r) % a.conc] = t;
            const double lat = __dsub_rn(t, t0);
            a.counts[(size_t)c * a.n_bins + sketch_bucket(lat, a.bins_per_octave, a.min_exp, a.n_bins)] += 1.0;
            const double n1 = __dadd_rn(s_mom[0], 1.0);
            const double d = __dsub_rn(lat, s_mom[3]);
            const double mean = __dadd_rn(s_mom[3], __ddiv_rn(d, n1));
            s_mom[4] = __dadd_rn(s_mom[4], __dmul_rn(d, __dsub_rn(lat, mean)));
            s_mom[3] = mean;
            s_mom[0] = n1;
            s_mom[1] = dmin(s_mom[1], lat);
            s_mom[2] = dmax(s_mom[2], lat);
            s_mom[5] = dmax(s_mom[5], t);
          }
          // stage 0 of a closed loop reads this completion from global memory
          if (a.conc && S > 1) st_release<true>(cluster.map_shared_rank(&s_done, 0), (unsigned)(r + 1));
        }
        // every consumer has read this request's slot (the layer barriers since)
        if (!first) st_release<true>(cluster.map_shared_rank(&s_credit, s - 1), (unsigned)(r + 1));
      }
      __syncwarp();
      t_prev = t;
    }
    if (STATS && tid == 0) {
      for (int l = lo; l < hi; ++l) {
        a.busy[(size_t)c * a.L + l] = s_acc_b[l];
        a.wait[(size_t)c * a.L + l] = s_acc_w[l];
      }
    }
    if (STREAM && final && tid == 0) {
      for (int i = 0; i < 5; ++i) a.moments[(size_t)c * 5 + i] = s_mom[i];
      a.horizon[c] = s_mom[5];
    }
    if (a.deep && lane == 0 && deep) atomicAdd(a.deep, (unsigned long long)deep);
    if (STREAM && a.smem_state) {
      bar_named(1, nc);
      for (int i = tid; i < span; i += nc) gst[i] = state[i];
    }
  }
  // no block leaves while another may still write its shared memory
  cluster.sync();
}

// KMAX: the most lanes a thread of a wide pool holds in this launch (1: up
// to 32 servers a pool, 4: 128, 16: 512; 32: any pool wider, up to 1,024 in
// registers and above in the state memory); fewer registers for smaller
// ones.  Threads a block: build_threads.
template <int KMAX, bool STATS>
__global__ void __launch_bounds__(build_threads(KMAX, STATS, false), KMAX == 16 && !STATS ? 2 : 1)
    vtime_scan_kernel(Args a) {
  vt_stage<KMAX, STATS, false>(a);
}

template <int KMAX>
__global__ void __launch_bounds__(build_threads(KMAX, false, true), 1) vtime_stream_kernel(Args a) {
  vt_stage<KMAX, false, true>(a);
}

template <class Kernel>
cudaError_t raise_smem(Kernel kernel, size_t smem, size_t* smem_set) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 - kStaticSmem && smem > smem_set[device]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set[device] = smem;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int grid, int S, int threads, size_t smem,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch C clusters of a.stages blocks, or with `clusters` not null only
// ask how many such clusters can be resident at once.  A refused launch
// returns its error; it is never retried with fewer stages.
template <class Kernel>
int launch_or_query(Kernel kernel, size_t* smem_set, const Args& a, int C, int threads, size_t smem,
                    cudaStream_t stream, int* clusters) {
  cudaError_t e = raise_smem(kernel, smem, smem_set);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(attr, C * a.stages, a.stages, threads, smem, stream);
  if (clusters) return (int)cudaOccupancyMaxActiveClusters(clusters, (const void*)kernel, &cfg);
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool STATS>
int dispatch_scan(const Args& a, int C, int kmax, int threads, size_t smem, cudaStream_t s, int* clusters) {
  static size_t smem_set[4][64] = {};  // the shared-memory limit raised so far, per build and device
  switch (kmax) {
    case 1: return launch_or_query(vtime_scan_kernel<1, STATS>, smem_set[0], a, C, threads, smem, s, clusters);
    case 4: return launch_or_query(vtime_scan_kernel<4, STATS>, smem_set[1], a, C, threads, smem, s, clusters);
    case 16: return launch_or_query(vtime_scan_kernel<16, STATS>, smem_set[2], a, C, threads, smem, s, clusters);
    case 32: return launch_or_query(vtime_scan_kernel<32, STATS>, smem_set[3], a, C, threads, smem, s, clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_stream(const Args& a, int C, int kmax, int threads, size_t smem, cudaStream_t s, int* clusters) {
  static size_t smem_set[4][64] = {};
  switch (kmax) {
    case 1: return launch_or_query(vtime_stream_kernel<1>, smem_set[0], a, C, threads, smem, s, clusters);
    case 4: return launch_or_query(vtime_stream_kernel<4>, smem_set[1], a, C, threads, smem, s, clusters);
    case 16: return launch_or_query(vtime_stream_kernel<16>, smem_set[2], a, C, threads, smem, s, clusters);
    case 32: return launch_or_query(vtime_stream_kernel<32>, smem_set[3], a, C, threads, smem, s, clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch shape both entries check: stages S >= 1 over a split that
// starts at 0, ends at L and gives every stage a layer; threads a multiple
// of 32 with at least one loader warp; dynamic shared memory within the
// block's room.
bool bad_shape(const Args& a, const int* split, int threads, int kmax, bool stats, bool stream, size_t smem) {
  if (a.L < 1 || a.L > kMaxLayers || a.Ptot < 1 || a.Ptot > kMaxPools || threads < 32 ||
      threads > build_threads(kmax, stats, stream) || threads % 32 || a.chunk < 1 || a.consumer_warps < 1 ||
      32 * a.consumer_warps >= threads || a.stages < 1 || smem > kMaxSmem - kStaticSmem)
    return true;
  if (a.stages > kMaxStages || split == nullptr || split[0] != 0 || split[a.stages] != a.L) return true;
  for (int i = 0; i < a.stages; ++i)
    if (split[i + 1] <= split[i]) return true;
  return false;
}

void copy_split(Args& a, const int* split) {
  for (int i = 0; i <= kMaxStages; ++i) a.split[i] = split && i <= a.stages && a.stages <= kMaxStages ? split[i] : 0;
}

size_t smem_of(const Args& a, bool stream, int threads) {
  return (kBufs * (size_t)a.chunk + (a.smem_state ? (size_t)a.state_stride : 0)) * sizeof(double) +
         (stream ? (size_t)max(0, threads / 32 - a.consumer_warps) * kWarpRows * sizeof(int) : 0);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Pointers are device pointers of
// contiguous tensors on the current device (`split` a host array of S + 1
// ints); `stream` is a cudaStream_t.  `meta` is (L, 5): B_l, P_l, pool
// offset, offset into idx, S_l.  The launch is C clusters of `stages`
// blocks; block s of a cluster runs layers split[s] .. split[s+1] - 1.
// `state_stride` is the doubles of pool state one stage's block needs: the
// largest sum over a stage's pools of pool_cap(lanes) (a power of two up to
// 8 for a pool of at most 8 servers, max(32, the power of two) above).
// `kmax` is 1, 4, 16 or 32: at least the lanes a warp's thread holds for
// the widest pool (pow2(servers) / 32), and 32 when a pool is wider than
// 512 servers.  `chunk` is the doubles of service times staged at a time,
// at least every layer's pool count; the dynamic shared memory is four such
// buffers and, with `smem_state` 1, the pool state (the caller has checked
// it fits), else the state is in `gstate` (C * stages x state_stride
// doubles).  `threads` is a multiple of 32, at most build_threads(kmax,
// stats, stream), of which the first 32 * `consumer_warps` run the pools
// and at least one warp stages.  `deep`, one uint64 or null, has the
// launch's jobs that epochs cut short by a deep insert sent one by one
// added to it (run_merged).  With `clusters` not null nothing is
// launched: *clusters gets how many such clusters the device holds at once
// (cudaOccupancyMaxActiveClusters).  The caller has checked every index
// (variant < V, sample index < S_l), lanes <= 65536, service times >= 0 and
// not NaN, L <= 64 and Ptot <= 1024.  Returns cudaGetLastError() after the
// launch (0 when it was accepted); a cluster shape the device refuses
// returns its error.
extern "C" int vtime_scan_launch(const void* tables, const void* tbl_off, const void* meta, const void* idx,
                                 const void* variant, const void* lanes, const void* arrivals, const void* xfer,
                                 void* t_arr, void* comp, void* busy, void* wait, void* gstate, void* deep,
                                 long long state_stride,
                                 int C, int N, int L, int V, int Ptot, int conc, int kmax, int chunk, int threads,
                                 int consumer_warps, int smem_state, int stats, int stages, const int* split,
                                 void* stream, int* clusters) {
  Args a = {};
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
  a.deep = static_cast<unsigned long long*>(deep);
  a.state = static_cast<double*>(gstate);
  a.state_stride = state_stride;
  a.N = N;
  a.L = L;
  a.V = V;
  a.Ptot = Ptot;
  a.conc = conc;
  a.chunk = chunk;
  a.consumer_warps = consumer_warps;
  a.smem_state = smem_state != 0;
  a.stages = stages;
  copy_split(a, split);
  const size_t smem = smem_of(a, false, threads);
  if (bad_shape(a, split, threads, kmax, stats != 0, false, smem)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (!clusters) {
    if (C == 0 || N == 0) return 0;
    if (!a.smem_state && gstate == nullptr) return (int)cudaErrorInvalidValue;
    if (conc == 0 && arrivals == nullptr) return (int)cudaErrorInvalidValue;
    if (stats && (busy == nullptr || wait == nullptr)) return (int)cudaErrorInvalidValue;
  }
  return stats ? dispatch_scan<true>(a, C, kmax, threads, smem, s, clusters)
               : dispatch_scan<false>(a, C, kmax, threads, smem, s, clusters);
}

// Streaming entry, loaded with ctypes; pointers, `meta`, `stages`, `split`,
// `clusters` as for vtime_scan_launch.  `n` requests (the segment's valid
// ones) with global ids r0 .. r0 + n - 1.  `state` (C x state_stride)
// holds each config's lanes, pool by pool at pool_cap(lanes) lanes each,
// sorted ascending with +inf for absent servers; each stage reads its own
// pools' lanes at the start and writes them back at the end, as the last
// stage does `ring` (C x ring_len, the closed loop's last completions by
// slot r % conc), `counts` (C x n_bins), `moments` (C x 5: n, min, max,
// mean, m2) and `horizon` (C).  `stage_stride` is the doubles of lanes one
// stage holds (in shared memory with `smem_state`).  `salts` (L uint32)
// selects hashed indices, `idx` presampled ones (one of them is null);
// `plans` (C x L x 2 int32) are the macro-job plans (K, n_bulk), (1, 0) for
// exact jobs, and with `idx` they must be exact.  `t_arr` / `comp` (C x n)
// are written when not null.  The caller has checked every index, lanes <=
// 65536, service times >= 0, L <= 64, Ptot <= 1024, K >= 1 and n_bulk * K
// <= P_l.  `kmax`, `chunk`, `threads` and `consumer_warps` as for
// vtime_scan_launch.
extern "C" int vtime_stream_launch(const void* tables, const void* tbl_off, const void* meta, const void* salts,
                                   const void* idx, const void* plans, const void* variant, const void* lanes,
                                   const void* arrivals, const void* xfer, void* state, long long state_stride,
                                   void* ring, int ring_len, void* counts, int n_bins, int bins_per_octave,
                                   int min_exp, void* moments, void* horizon, void* t_arr, void* comp, long long r0,
                                   int C, int N, int L, int V, int Ptot, int conc, int kmax, int chunk, int threads,
                                   int consumer_warps, int smem_state, long long stage_stride, int stages,
                                   const int* split, void* stream, int* clusters) {
  Args a = {};
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
  a.carry_stride = state_stride;
  a.state_stride = stage_stride;
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
  a.stages = stages;
  copy_split(a, split);
  const size_t smem = smem_of(a, true, threads);
  if (bad_shape(a, split, threads, kmax, false, true, smem) || n_bins < 1 || bins_per_octave < 1 || ring_len < 1 ||
      stage_stride > state_stride)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (!clusters) {
    if (C == 0 || N == 0) return 0;
    if ((salts == nullptr) == (idx == nullptr) || plans == nullptr || (conc == 0 && arrivals == nullptr) ||
        ((t_arr == nullptr) != (comp == nullptr)))
      return (int)cudaErrorInvalidValue;
  }
  return dispatch_stream(a, C, kmax, threads, smem, s, clusters);
}

namespace {

template <class Kernel>
int max_threads(Kernel kernel) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  return e == cudaSuccess ? attr.maxThreadsPerBlock : -(int)e;
}

}  // namespace

// The threads a block of the build for `kmax` (1, 4, 16 or 32) may run, its
// launch bound as the device reports it (cudaFuncGetAttributes), for VT
// with or without `stats` or for the streaming entry (`stream`); minus the
// CUDA error when the query fails.
extern "C" int vtime_max_threads(int kmax, int stats, int stream) {
  if (stream) {
    switch (kmax) {
      case 1: return max_threads(vtime_stream_kernel<1>);
      case 4: return max_threads(vtime_stream_kernel<4>);
      case 16: return max_threads(vtime_stream_kernel<16>);
      case 32: return max_threads(vtime_stream_kernel<32>);
    }
  } else if (stats) {
    switch (kmax) {
      case 1: return max_threads(vtime_scan_kernel<1, true>);
      case 4: return max_threads(vtime_scan_kernel<4, true>);
      case 16: return max_threads(vtime_scan_kernel<16, true>);
      case 32: return max_threads(vtime_scan_kernel<32, true>);
    }
  } else {
    switch (kmax) {
      case 1: return max_threads(vtime_scan_kernel<1, false>);
      case 4: return max_threads(vtime_scan_kernel<4, false>);
      case 16: return max_threads(vtime_scan_kernel<16, false>);
      case 32: return max_threads(vtime_scan_kernel<32, false>);
    }
  }
  return -(int)cudaErrorInvalidValue;
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
