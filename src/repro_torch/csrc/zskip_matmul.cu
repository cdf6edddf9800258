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
// bk are 64 or 128, so every (TM, TK) tile of A that a block stages lies in
// one mask tile.
//
// What bounds it on this card: at Nemotron-4-15B's prefill down-projection,
// (4096, 24576) @ (24576, 6144) in bf16, operations: 1.24e12 of them take
// 1.25 ms on the bf16 tensor cores, while the 0.55 GB of inputs and output
// take 0.165 ms at the memory's rate.  At its decode shape (4 rows) it is
// bytes: B's 0.30 GB take 0.090 ms.  The design does this about it:
//   * bf16 runs on the tensor cores (mma.sync m16n8k16, float32 sums; A and
//     B staged in shared memory, fragments read with ldmatrix); float32 runs
//     on the CUDA cores in float32 (no TF32: the plain version's products
//     are full float32).
//   * One block per output tile with a loop over K inside it, in place of
//     the Pallas grid's innermost axis.  The block reads one mask flag per K
//     step; where it is 0 the block skips both the loads of that A tile and
//     of the matching B rows, and the products.
//   * A grid with fewer blocks than the card has SMs (decode: 4 rows) splits
//     K across blocks; each split writes a float32 partial into a workspace
//     that the caller allocated, and a second kernel sums the splits in order
//     and writes the output.  So decode streams B with 6x more blocks in
//     flight.
// No wgmma, TMA or cp.async pipeline yet: the loads of one K step complete
// before its products start.  Neither kernel allocates or synchronises; both
// run on the caller's stream.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
// bf16 on the tensor cores: a (64 x 128) output tile per block of 4 warps,
// each warp 32 rows x 64 columns (2 x 8 tiles of m16n8, 64 float32 sums a
// thread).  K steps of 64: the block stages A's (64 x 64) tile and B's
// (64 x 128) rows in shared memory as bf16 (rows padded by 16 bytes, so the
// ldmatrix row addresses fall on distinct banks), then per 16-wide slice a
// warp reads its A fragments with ldmatrix and its B fragments with
// ldmatrix.trans (B is row-major, K by N) and runs 16 mma.sync.
constexpr int TM = 64, TN = 128, TK = 64, kThreads = 128;
constexpr int LDA_S = TK + 8, LDB_S = TN + 8;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* ptr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* ptr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a b for one m16n8k16 tile
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// eight bf16 from src, those at or past `valid` read as zero
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* src, int valid, bool vec) {
  if (vec && valid >= 8) return *reinterpret_cast<const uint4*>(src);
  __align__(16) __nv_bfloat16 t[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) t[e] = e < valid ? src[e] : __ushort_as_bfloat16(0);
  return *reinterpret_cast<const uint4*>(t);
}

__global__ void __launch_bounds__(kThreads) zskip_mma_kernel(const Args p) {
  __shared__ __align__(16) __nv_bfloat16 As[TM * LDA_S];
  __shared__ __align__(16) __nv_bfloat16 Bs[TK * LDB_S];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(p.a);
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(p.b);
  const int* mrow = p.mask + (long long)(m0 / p.bm) * p.mask_cols;
  const bool a_vec = reinterpret_cast<uintptr_t>(A) % 16 == 0 && p.lda % 8 == 0;
  const bool b_vec = reinterpret_cast<uintptr_t>(B) % 16 == 0 && p.ldb % 8 == 0;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int nk = p.K / TK;
  const int kc0 = blockIdx.z * p.chunks_per_split, kc1 = min(nk, kc0 + p.chunks_per_split);
  for (int kc = kc0; kc < kc1; ++kc) {
    const int k0 = kc * TK;
    if (mrow[k0 / p.bk] == 0) continue;  // the same flag for the whole block
    __syncthreads();                      // the previous step is consumed
    for (int i = tid; i < TM * (TK / 8); i += kThreads) {
      const int r = i >> 3, ch = i & 7, row = m0 + r;
      const uint4 val = row < p.M ? load8(A + row * p.lda + k0 + ch * 8, 8, a_vec)
                                  : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(As + r * LDA_S + ch * 8) = val;
    }
    for (int i = tid; i < TK * (TN / 8); i += kThreads) {
      const int r = i >> 4, ch = i & 15, col = n0 + ch * 8;
      const uint4 val = col < p.N ? load8(B + (long long)(k0 + r) * p.ldb + col, p.N - col, b_vec)
                                  : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(Bs + r * LDB_S + ch * 8) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(af[mt], As + (wm * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDA_S +
                                kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, Bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB_S +
                                   wn * 64 + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + mt * 16 + g + (e >> 1) * 8;
        const int col = n0 + wn * 64 + nt * 8 + 2 * c + (e & 1);
        if (row < p.M && col < p.N) store_out(p, row, col, acc[mt][nt][e]);
      }
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
// (splits, M, N) float32 workspace when splits > 1, else unused.  K is a
// multiple of bk; bm and bk are 64 or 128; chunks_per_split counts the
// kernel's K steps (16 for float32, 64 for bf16) and splits *
// chunks_per_split covers K.  The caller has checked all of this.  Returns
// cudaGetLastError() after the launches (0 when they were accepted).
extern "C" int zskip_matmul_launch(const void* a, const void* b, const int* mask, void* o,
                                   float* ws, int dtype, int out_bf16, int M, int N, int K,
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
  } else if (dtype == 1) {
    const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, splits);
    zskip_mma_kernel<<<grid, kThreads, 0, s>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = (long long)M * N;
  zskip_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(p);
  return (int)cudaGetLastError();
}
