// K3: zero-skip matmul, for Hopper (sm_90a).
//
// Replaces the Pallas kernel zskip_matmul_kernel
// (src/repro/kernels/zskip_matmul.py:28), which walked a (M/bm, N/bn, K/bk)
// grid on one TPU core with K innermost, carried a (bm, bn) float32 sum in
// VMEM from one K step to the next, and skipped the accumulation of every A
// tile whose int32 entry in the (M/bm, K/bk) block mask is 0.
//
// It computes o = A_masked @ B, A (M, K) and B (K, N) of one type (float32
// or bf16), where A_masked is A with every (bm, bk) tile whose mask entry is
// 0 set to zero, summed in float32 and written in float32 or bf16.  The mask
// has ceil(M / bm) rows: a ragged last row tile counts only its real rows,
// and ragged N is masked here too.  K must be a multiple of bk, and bm and
// bk are 64 or 128, so every (64 x 64) tile of A that a warpgroup multiplies
// lies in one mask tile.
//
// What bounds it on this card: at Nemotron-4-15B's prefill down-projection,
// (4096, 24576) @ (24576, 6144) in bf16, operations: 1.24e12 of them take
// 1.25 ms on the bf16 tensor cores, while the 0.55 GB of inputs and output
// take 0.165 ms at the memory's rate.  At its decode shape (4 rows) it is
// bytes: B's 0.30 GB take 0.090 ms.  What the bf16 design does about it:
//   * The usual Hopper GEMM shape.  A persistent grid, one block per SM,
//     takes (128 x 256) output tiles (and, for a small grid, K splits of
//     them) from a work queue (hopper::next_unit), so blocks whose tiles
//     are mostly dead take more of them.  In each block one producer thread
//     issues TMA loads
//     (cp.async.bulk.tensor, 128-byte swizzle) of A's (128 x 64) and B's
//     (64 x 256) tiles into a ring of kStages stages, under full/empty
//     mbarrier pairs; two consumer warpgroups each own 64 output rows and
//     run wgmma m64n256k16 on the stages that have arrived, keeping one
//     stage's products in flight while the next arrives.  So one tile's
//     epilogue overlaps the next tile's loads, and B is read once per 128
//     rows of A (the old 64 x 128 tile read it once per 64).  setmaxnreg
//     moves registers from the producer to the consumers, whose (64 x 256)
//     float32 accumulator is 128 registers a thread.
//   * B stays (K, N) row-major: wgmma reads it as an MN-major operand
//     (the descriptor's transpose bit).  The tensor maps are encoded at
//     every launch (the model casts its weight afresh for every product,
//     so B's pointer changes every call).
//   * The skip.  A consumer warpgroup reads its own mask flag per 64-wide K
//     step (with bm = 64 the two warpgroups' rows lie in different mask
//     rows) and skips its products on a dead step while still releasing
//     the stage; the producer loads a step (A and B) when either half is
//     live and skips it when both are dead.  Producer and consumers read
//     the same flags from the mask in the same order (a warp reads 32
//     steps' flags with one load a lane and a ballot), so they walk the
//     same sequence of stages.
//   * Ragged edges: TMA fills the parts of a box past M, N or K with zeros,
//     and the epilogue stores only real rows and columns.  TMA needs 16-byte
//     aligned bases and row strides; the wrapper copies an operand that is
//     not (kernels/zskip_matmul.py).
//   * Decode (4 rows): the 4 real rows sit in a zero-filled 64-row box of
//     the first warpgroup (the second has no row and skips every product),
//     and K is split across blocks so that 24 output tiles still fill the
//     SMs; each split streams its slice of B through the same TMA ring and
//     writes a float32 partial into a workspace that the caller allocated,
//     and a second kernel sums the splits in order.  Operand swapping (N as
//     wgmma's M) would waste less tensor work, but decode is bound by B's
//     bytes, which both read once, and the zero-filled box keeps one kernel.
// float32 runs on the CUDA cores in float32 (no TF32: the plain version's
// products are full float32), one block per 64 x 64 output tile.  No
// kernel allocates or synchronises; all run on the caller's stream (the
// wrapper allocates the work queue, two zeroed ints, once per stream).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

struct Args {
  const void* a;
  const void* b;
  const int* mask;  // (ceil(M / bm), mask_cols) int32, 0 = skip
  void* o;
  float* ws;  // (splits, M, N) float32 partials when splits > 1
  int M, N, K;
  long long lda, ldb, ldo;  // row strides in elements; columns are contiguous
  int bm, bk, mask_cols;
  int out_bf16;
  int chunks_per_split, splits;  // K steps of the kernel per split, number of splits
};

__device__ __forceinline__ void store_out(const Args& p, int row, int col, float v) {
  if (p.splits > 1) {
    p.ws[((long long)blockIdx.z * p.M + row) * p.N + col] = v;
  } else if (p.out_bf16) {
    static_cast<__nv_bfloat16*>(p.o)[row * p.ldo + col] = __float2bfloat16(v);
  } else {
    static_cast<float*>(p.o)[row * p.ldo + col] = v;
  }
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores: a (64 x 64) output tile per block of 256
// threads, 4 x 4 outputs a thread, K steps of 16 staged in shared memory (A
// transposed so that a thread reads its 4 rows as one float4).
constexpr int FM = 64, FN = 64, FK = 16, kFThreads = 256;

__global__ void __launch_bounds__(kFThreads) zskip_f32_kernel(const Args p) {
  __shared__ __align__(16) float As[FK][FM];
  __shared__ __align__(16) float Bs[FK][FN];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n0 = blockIdx.x * FN, m0 = blockIdx.y * FM;
  const float* A = static_cast<const float*>(p.a);
  const float* B = static_cast<const float*>(p.b);
  const int* mrow = p.mask + (long long)(m0 / p.bm) * p.mask_cols;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nk = p.K / FK;
  const int kc0 = blockIdx.z * p.chunks_per_split, kc1 = min(nk, kc0 + p.chunks_per_split);
  for (int kc = kc0; kc < kc1; ++kc) {
    const int k0 = kc * FK;
    if (mrow[k0 / p.bk] == 0) continue;  // the same flag for the whole block
    __syncthreads();                      // the previous step is consumed
    {
      const int r = tid >> 2, kq = (tid & 3) * 4, row = m0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) As[kq + j][r] = row < p.M ? A[row * p.lda + k0 + kq + j] : 0.f;
    }
    {
      const int k = tid >> 4, cq = (tid & 15) * 4;
      const float* src = B + (long long)(k0 + k) * p.ldb + n0 + cq;
#pragma unroll
      for (int j = 0; j < 4; ++j) Bs[k][cq + j] = n0 + cq + j < p.N ? src[j] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < p.N) store_out(p, row, col, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (wgmma, TMA, warp specialised, persistent).
constexpr int HM = 128, HN = 256, HK = 64;  // block tile: rows, columns, K step
constexpr int kStages = 4;
constexpr int kHThreads = 384;  // warpgroups 0 and 1 consume, 2 produces
constexpr uint32_t kABytes = HM * HK * 2;  // one (128 x 64) box of A
constexpr uint32_t kBBox = HK * 64 * 2;    // one (64 x 64) box of B
constexpr uint32_t kBBytes = HN / 64 * kBBox;
constexpr uint32_t kStageBytes = kABytes + kBBytes;
// the ring's barriers, the schedule's two slots (barriers and unit numbers), 1024 for alignment
constexpr size_t kHSmem = kStages * kStageBytes + (2 * kStages + 4) * sizeof(uint64_t) + 2 * sizeof(int) + 1024;

struct HArgs {
  const int* mask;  // (ceil(M / bm), mask_cols) int32, 0 = skip
  void* o;
  float* ws;  // (splits, M, N) float32 partials when splits > 1
  int* sched;  // (2,) int32, zero at launch and left zero: the work queue (hopper::next_unit)
  int M, N, K;
  long long ldo;
  int bm, bk, mask_cols;
  int out_bf16;
  int steps_per_split, splits;  // K steps of 64 per split, number of splits
  int m_tiles, tiles;           // output tiles: along M, in all
};

// the work unit u: its output tile (m0, n0) and its K steps [k0, k1)
struct Unit {
  int m0, n0, split, k0, k1;
};

__device__ __forceinline__ Unit unit_of(const HArgs& p, int u) {
  Unit w;
  const int tile = u % p.tiles;
  w.split = u / p.tiles;
  w.m0 = (tile % p.m_tiles) * HM;
  w.n0 = (tile / p.m_tiles) * HN;
  w.k0 = w.split * p.steps_per_split;
  w.k1 = min(p.K / HK, w.k0 + p.steps_per_split);
  return w;
}

// the mask row of the 64 rows from `row` on, or null when they lie past M
__device__ __forceinline__ const int* mask_row(const HArgs& p, int row) {
  return row < p.M ? p.mask + (long long)(row / p.bm) * p.mask_cols : nullptr;
}

// bit i: whether step kb + i (< k1) of these 64 rows is live; one load a
// lane and a ballot, so a warp reads 32 steps' flags at once
__device__ __forceinline__ uint32_t live_bits(const HArgs& p, const int* mrow, int kb, int k1, int lane) {
  const int kc = kb + lane;
  const bool live = mrow != nullptr && kc < k1 && __ldg(mrow + kc * HK / p.bk) != 0;
  return __ballot_sync(0xffffffffu, live);
}

__global__ void __launch_bounds__(kHThreads, 1)
    zskip_wgmma_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
                       const HArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* sched_full = empty + kStages;  // the schedule: the producer's next unit, two slots
  uint64_t* sched_empty = sched_full + 2;
  volatile int* sched_unit = reinterpret_cast<int*>(sched_empty + 2);
  const int wg = threadIdx.x / 128;
  const int n_units = p.tiles * p.splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&sched_full[s], 1);
      hopper::mbar_init(&sched_empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: warp 8 reads the flags, its lane 0 issues the loads and
    // takes the block's next unit from the work queue once the current one is
    // loaded (so a block whose units are cheap, being mostly dead, takes
    // more of them), and passes it to the consumers
    hopper::regs_dealloc<40>();
    if (threadIdx.x / 32 == 8) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        hopper::prefetch_tensormap(&tmA);
        hopper::prefetch_tensormap(&tmB);
      }
      int stage = 0, slot = 0;
      uint32_t phase = 0, sphase = 0;
      for (int u = blockIdx.x; u < n_units;) {
        const Unit w = unit_of(p, u);
        const int* m0row = mask_row(p, w.m0);
        const int* m1row = mask_row(p, w.m0 + 64);
        for (int kb = w.k0; kb < w.k1; kb += 32) {
          uint32_t steps = live_bits(p, m0row, kb, w.k1, lane) | live_bits(p, m1row, kb, w.k1, lane);
          while (steps != 0) {
            const int kc = kb + __ffs(steps) - 1;
            steps &= steps - 1;
            if (lane == 0) {
              hopper::mbar_wait(&empty[stage], phase ^ 1);
              uint8_t* st = smem + stage * kStageBytes;
              hopper::mbar_expect_tx(&full[stage], kStageBytes);
              hopper::tma_load_2d(st, &tmA, &full[stage], kc * HK, w.m0);
#pragma unroll
              for (int j = 0; j < HN / 64; ++j)
                hopper::tma_load_2d(st + kABytes + j * kBBox, &tmB, &full[stage], w.n0 + 64 * j, kc * HK);
            }
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
        int next = 0;
        if (lane == 0) {
          next = hopper::next_unit(p.sched, n_units);
          hopper::mbar_wait(&sched_empty[slot], sphase ^ 1);
          sched_unit[slot] = next;
          hopper::mbar_arrive(&sched_full[slot]);
        }
        u = __shfl_sync(0xffffffffu, next, 0);
        if (++slot == 2) {
          slot = 0;
          sphase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
    hopper::regs_alloc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, c = lane & 3;
    const bool vec = (p.N % 2 == 0) && (p.splits > 1 || p.ldo % 2 == 0);
    int stage = 0, slot = 0;
    uint32_t phase = 0, sphase = 0;
    float acc[HN / 2];
    for (int u = blockIdx.x; u < n_units;) {
      const Unit w = unit_of(p, u);
      const int row0 = w.m0 + 64 * wg;
      const int* mine = mask_row(p, row0);
      const int* other = mask_row(p, w.m0 + 64 * (1 - wg));
#pragma unroll
      for (int i = 0; i < HN / 2; ++i) acc[i] = 0.f;
      int held = -1;  // the stage whose products may still be in flight
      for (int kb = w.k0; kb < w.k1; kb += 32) {
        const uint32_t my_steps = live_bits(p, mine, kb, w.k1, lane);
        uint32_t steps = my_steps | live_bits(p, other, kb, w.k1, lane);
        while (steps != 0) {
          const int i = __ffs(steps) - 1;
          steps &= steps - 1;
          const bool my_live = (my_steps >> i) & 1;
          hopper::mbar_wait(&full[stage], phase);
          if (my_live) {
            const uint8_t* st = smem + stage * kStageBytes;
            hopper::fence_regs(acc);
            hopper::wgmma_fence();
#pragma unroll
            for (int t = 0; t < HK / 16; ++t) {
              const uint64_t da = hopper::desc_sw128(st + wg * (kABytes / 2) + t * 32, 16, 1024);
              const uint64_t db = hopper::desc_sw128(st + kABytes + t * 16 * 128, kBBox, 1024);
              hopper::wgmma_m64n256k16_ss<1>(acc, da, db, 1);
            }
            hopper::wgmma_commit();
            hopper::fence_regs(acc);
            hopper::wgmma_wait<1>();  // the previous step's products are done
          } else {
            hopper::wgmma_wait<0>();
          }
          if (held >= 0) {
            __syncwarp();
            if (lane == 0) hopper::mbar_arrive(&empty[held]);
          }
          held = stage;
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (held >= 0) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[held]);
      }
      // the next unit, as the producer took it
      hopper::mbar_wait(&sched_full[slot], sphase);
      const int next = sched_unit[slot];
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&sched_empty[slot]);
      if (++slot == 2) {
        slot = 0;
        sphase ^= 1;
      }
      u = next;
      // epilogue: thread (warp, g, c) holds rows 16 warp + g (+ 8), columns 8 j + 2 c (+ 1)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 16 * warp + g + 8 * half;
        if (row >= p.M) continue;
#pragma unroll
        for (int j = 0; j < HN / 8; ++j) {
          const int col = w.n0 + 8 * j + 2 * c;
          const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
          if (col >= p.N) continue;
          const bool pair = vec && col + 1 < p.N;
          if (p.splits > 1) {
            float* dst = p.ws + ((long long)w.split * p.M + row) * p.N + col;
            if (pair) {
              *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
            } else {
              dst[0] = v0;
              if (col + 1 < p.N) dst[1] = v1;
            }
          } else if (p.out_bf16) {
            __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.o) + row * p.ldo + col;
            if (pair) {
              *reinterpret_cast<uint32_t*>(dst) = hopper::pack_bf16(v0, v1);
            } else {
              dst[0] = __float2bfloat16(v0);
              if (col + 1 < p.N) dst[1] = __float2bfloat16(v1);
            }
          } else {
            float* dst = static_cast<float*>(p.o) + row * p.ldo + col;
            if (pair) {
              *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
            } else {
              dst[0] = v0;
              if (col + 1 < p.N) dst[1] = v1;
            }
          }
        }
      }
    }
  }
}

// Encodes A's and B's tensor maps and launches the persistent kernel.
int launch_wgmma(const Args& a, int* sched, cudaStream_t stream, int device) {
  CUtensorMap tmA, tmB;
  {
    const uint64_t dims[2] = {(uint64_t)a.K, (uint64_t)a.M};
    const uint64_t strides[1] = {(uint64_t)a.lda * 2};
    const uint32_t box[2] = {HK, HM};
    int err = hopper::encode_bf16_map(&tmA, a.a, 2, dims, strides, box);
    if (err) return err;
  }
  {
    const uint64_t dims[2] = {(uint64_t)a.N, (uint64_t)a.K};
    const uint64_t strides[1] = {(uint64_t)a.ldb * 2};
    const uint32_t box[2] = {64, HK};
    int err = hopper::encode_bf16_map(&tmB, a.b, 2, dims, strides, box);
    if (err) return err;
  }
  HArgs p;
  p.mask = a.mask;
  p.o = a.o;
  p.ws = a.ws;
  p.sched = sched;
  p.M = a.M;
  p.N = a.N;
  p.K = a.K;
  p.ldo = a.ldo;
  p.bm = a.bm;
  p.bk = a.bk;
  p.mask_cols = a.mask_cols;
  p.out_bf16 = a.out_bf16;
  p.steps_per_split = a.chunks_per_split;
  p.splits = a.splits;
  p.m_tiles = (a.M + HM - 1) / HM;
  p.tiles = p.m_tiles * ((a.N + HN - 1) / HN);
  const int sms = hopper::sm_count(device);
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  static bool smem_set[64] = {};  // the shared-memory limit, raised once per device
  if (!smem_set[device]) {
    cudaError_t err = cudaFuncSetAttribute(zskip_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kHSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set[device] = true;
  }
  const int grid = p.tiles * p.splits < sms ? p.tiles * p.splits : sms;
  zskip_wgmma_kernel<<<grid, kHThreads, kHSmem, stream>>>(tmA, tmB, p);
  return (int)cudaGetLastError();
}

// the splits' partials summed in split order, then written in the output type
__global__ void zskip_reduce_kernel(const Args p) {
  const long long total = (long long)p.M * p.N;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int z = 0; z < p.splits; ++z) s += p.ws[z * total + i];
  const long long row = i / p.N, col = i - row * p.N;
  if (p.out_bf16)
    static_cast<__nv_bfloat16*>(p.o)[row * p.ldo + col] = __float2bfloat16(s);
  else
    static_cast<float*>(p.o)[row * p.ldo + col] = s;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  a (M, K), b (K, N) device
// pointers of one type (dtype 0: float32, 1: bfloat16) with row strides lda,
// ldb and contiguous columns; mask (ceil(M / bm), mask_cols = K / bk) int32;
// o (M, N) with row stride ldo, float32 (out_bf16 0) or bf16 (1); ws a
// (splits, M, N) float32 workspace when splits > 1, else unused; sched two
// int32 that are 0, and stay 0 after the launch (bf16 only: the persistent
// kernel's work queue; one pair per stream).  K is a
// multiple of bk; bm and bk are 64 or 128; chunks_per_split counts the
// kernel's K steps (16 for float32, 64 for bf16) and splits *
// chunks_per_split covers K.  For bf16, a and b start on 16 bytes and lda
// and ldb are multiples of 8 (TMA's alignment).  The caller has checked all
// of this.  Returns a CUDA error code: that of the tensor maps' encoding,
// else cudaGetLastError() after the launches (0 when they were accepted).
extern "C" int zskip_matmul_launch(const void* a, const void* b, const int* mask, void* o,
                                   float* ws, int* sched, int dtype, int out_bf16, int M, int N, int K,
                                   long long lda, long long ldb, long long ldo, int bm, int bk,
                                   int mask_cols, int chunks_per_split, int splits, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M == 0 || N == 0) return 0;
  if ((bm != 64 && bm != 128) || (bk != 64 && bk != 128) || K % bk != 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  Args p;
  p.a = a;
  p.b = b;
  p.mask = mask;
  p.o = o;
  p.ws = ws;
  p.M = M;
  p.N = N;
  p.K = K;
  p.lda = lda;
  p.ldb = ldb;
  p.ldo = ldo;
  p.bm = bm;
  p.bk = bk;
  p.mask_cols = mask_cols;
  p.out_bf16 = out_bf16;
  p.chunks_per_split = chunks_per_split;
  p.splits = splits;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM, splits);
    zskip_f32_kernel<<<grid, kFThreads, 0, s>>>(p);
    err = cudaGetLastError();
  } else if (dtype == 1) {
    err = (cudaError_t)launch_wgmma(p, sched, s, device);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = (long long)M * N;
  zskip_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(p);
  return (int)cudaGetLastError();
}
