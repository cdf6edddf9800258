// K5: the Mamba2 SSD per-chunk terms, for Hopper (sm_90a).
//
// Replaces the Pallas kernel _ssd_chunk_kernel (src/repro/kernels/ssd_scan.py:30),
// which ran one TPU grid step per (chunk cell, head block) with the cell's
// B, C and (Q, Q) score matrix in VMEM.
//
// For every cell c (one chunk of one sequence) and head h it computes
//     scores[q, k] = C[q] . B[k]                                     (float32)
//     y[q, h, :]   = sum_{k <= q} scores[q, k] exp(cum[q, h] - cum[k, h]) xdt[k, h, :]
//     S[h, n, :]   = sum_k bw[k, n] xdt[k, h, :],
//                    bw[k, n] = B[k, n] * T(exp(cum[Q-1, h] - cum[k, h])), rounded to T
// with the Pallas kernel's types: cum is read as float32, the exponentials,
// scores and sums are float32, y is written in xdt's type T and S in float32,
// and bw (and the decay in it) is rounded to B's type T as the Pallas kernel's
// `B * decay.astype(B.dtype)` rounds it.  The upper triangle of
// exp(cum[q] - cum[k]) (k > q) overflows and is masked before the exponential.
// In:  cum (nc, Q, H), xdt (nc, Q, H, P), B and C (nc, Q, N), all of type T
//      (dtype 0: float32, 1: bfloat16), contiguous, 16-byte aligned in bf16.
// Out: y (nc, Q, H, P) of type T, S (nc, H, N, P) float32, contiguous.
//
// What bounds it in bf16: bytes.  Per cell, Q^2 N / 2 multiply-adds for the
// scores and per head Q^2 P / 2 for y and Q N P for S: at the Zamba2 prefill
// (32 cells, Q 128, H 64, P 64, N 64) about 4.4e9 operations, under 0.01 ms
// on the tensor cores, against 0.03 ms for its 102 MB of inputs and outputs
// (xdt read once, y and S written once: a third each).  So the design moves
// those bytes at the memory's rate and keeps everything else on the chip.
//
// Three kernels, chosen by type and shape in the C entry point (never as a
// fallback):
//   * bf16 at the models' shapes, Q 128, P 64, N 64 or 128 (Zamba2-1.2B and
//     Mamba2-370M): the Hopper kernel at the end of this file (wgmma fed by
//     TMA, warp specialised, persistent);
//   * bf16 at other shapes with Q <= 128, Q and N multiples of 16 and P of 8
//     (the SMOKE configs and the tests' small shapes): the mma.sync kernel
//     below;
//   * float32: the CUDA-core kernel, float32 throughout, any shape that fits.
// The bf16 kernels read 16-byte pieces: the caller passes 16-byte aligned
// tensors.  The entry point takes `hb`, the heads a block (or a work item of
// the Hopper kernel) serves, chosen by the caller to fill the card.
//
// CUDA-core kernel (float32, simple first): one block of 512 threads per
// (cell, head block of `hb` heads).  The block
// stages B and C in shared memory (zero-padded rows, read four floats at a
// time), computes the lower triangle of the scores once into a (Q, Q + 1)
// array, and then, head by head, stages that head's cum column and xdt tile
// (in C's space, which the scores no longer need) and the decays to the
// chunk end.
// Each thread then owns (row, 16 columns) pieces of y and of S and sums over
// the keys in registers; y's weights use the fast exponential (__expf,
// a few ulp).  At Q 128, N 128 this is 200 KB of dynamic shared memory, so
// one block runs on an SM at a time.  No kernel allocates or synchronises;
// all run on the caller's stream (the wrapper allocates the Hopper kernel's
// work queue, two zeroed ints, once per stream).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kCols = 16;  // output columns (p) per thread item
constexpr size_t kMaxSmem = 232448;  // the most shared memory a block may use

// Row strides in floats.  B and C rows are zero-padded to a multiple of 4
// plus 4 (float4 loads, and rows that fall on distinct banks); xdt rows to
// a multiple of kCols, so a thread's 16 columns need no bound check.
__host__ __device__ inline int ld_n(int N) { return (N + 3) / 4 * 4 + 4; }
__host__ __device__ inline int ld_p(int P) { return (P + kCols - 1) / kCols * kCols; }
__host__ __device__ inline int ld_x(int N, int P) { return ld_n(N) > ld_p(P) ? ld_n(N) : ld_p(P); }

__host__ __device__ inline size_t smem_bytes(int Q, int N, int P) {
  // scores (Q, Q + 1), B (Q, ld_n), C then xdt (Q, ld_x), cum and decay (Q each)
  return sizeof(float) *
         ((size_t)Q * (Q + 1) + (size_t)Q * ld_n(N) + (size_t)Q * ld_x(N, P) + 2 * (size_t)Q);
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ cum, const float* __restrict__ xdt,
                 const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ S, int Q, int H, int P, int N, int hb) {
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned rows
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldq = Q + 1, ldn = ld_n(N), ldp = ld_p(P);
  float* bs = smem;                   // (Q, ldn) B
  float* cx = bs + Q * ldn;           // (Q, ldn) C; then (Q, ldp) xdt of one head
  float* sc = cx + Q * ld_x(N, P);    // (Q, Q + 1) scores, lower triangle
  float* cumh = sc + Q * ldq;         // (Q) cum of one head
  float* dec = cumh + Q;              // (Q) exp(cum[Q-1] - cum[k])

  const long long c = blockIdx.x;
  const int h0 = blockIdx.y * hb;
  const int h1 = min(H, h0 + hb);
  const int tid = threadIdx.x;

  const float* Bc = Bm + c * Q * N;
  const float* Cc = Cm + c * Q * N;
  for (int i = tid; i < Q * ldn; i += kThreads) {
    const int r = i / ldn, n = i - r * ldn;
    bs[i] = n < N ? Bc[r * N + n] : 0.f;
    cx[i] = n < N ? Cc[r * N + n] : 0.f;
  }
  __syncthreads();
  const int n4 = ldn / 4 - 1;  // float4 groups holding the N columns
  for (int i = tid; i < Q * Q; i += kThreads) {
    const int q = i / Q, k = i - q * Q;
    if (k > q) continue;
    const float4* cq = reinterpret_cast<const float4*>(cx + q * ldn);
    const float4* bk = reinterpret_cast<const float4*>(bs + k * ldn);
    float a = 0.f;
    for (int g = 0; g < n4; ++g) {
      const float4 u = cq[g], v = bk[g];
      a = fmaf(u.x, v.x, a);
      a = fmaf(u.y, v.y, a);
      a = fmaf(u.z, v.z, a);
      a = fmaf(u.w, v.w, a);
    }
    sc[q * ldq + k] = a;
  }

  const int pch = ldp / kCols;
  const int n_y = Q * pch, n_items = n_y + N * pch;
  const int rounds = (n_items + kThreads - 1) / kThreads;
  for (int h = h0; h < h1; ++h) {
    __syncthreads();  // the scores are done, or the previous head is consumed
    for (int i = tid; i < Q; i += kThreads) cumh[i] = cum[(c * Q + i) * H + h];
    for (int i = tid; i < Q * ldp; i += kThreads) {
      const int r = i / ldp, p = i - r * ldp;
      cx[i] = p < P ? xdt[((c * Q + r) * H + h) * P + p] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < Q; i += kThreads) dec[i] = expf(cumh[Q - 1] - cumh[i]);
    __syncthreads();

    // Items: y rows, longest (last row) first, then S rows; handed out in
    // snake order (thread t takes item t, then item 2 * kThreads - 1 - t, ...)
    // so that the threads with short y rows take the S rows.
    for (int rnd = 0; rnd < rounds; ++rnd) {
      const int i = (rnd & 1) ? (rnd + 1) * kThreads - 1 - tid : rnd * kThreads + tid;
      if (i >= n_items) continue;
      float a[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u) a[u] = 0.f;
      if (i < n_y) {
        // y[q, h, p0:p0+16] = sum_{k <= q} scores[q, k] exp(cum[q] - cum[k]) xdt[k, p0:p0+16]
        const int q = Q - 1 - i / pch, p0 = (i % pch) * kCols;
        const float cq = cumh[q];
        for (int k = 0; k <= q; ++k) {
          const float w = sc[q * ldq + k] * __expf(cq - cumh[k]);
          const float4* xk = reinterpret_cast<const float4*>(cx + k * ldp + p0);
#pragma unroll
          for (int g = 0; g < kCols / 4; ++g) {
            const float4 x = xk[g];
            a[4 * g] = fmaf(w, x.x, a[4 * g]);
            a[4 * g + 1] = fmaf(w, x.y, a[4 * g + 1]);
            a[4 * g + 2] = fmaf(w, x.z, a[4 * g + 2]);
            a[4 * g + 3] = fmaf(w, x.w, a[4 * g + 3]);
          }
        }
        float* yq = y + ((c * Q + q) * H + h) * (long long)P + p0;
#pragma unroll
        for (int u = 0; u < kCols; ++u)
          if (p0 + u < P) yq[u] = a[u];
      } else {
        // S[h, n, p0:p0+16] = sum_k B[k, n] decay[k] xdt[k, p0:p0+16]
        const int j = i - n_y;
        const int n = j / pch, p0 = (j % pch) * kCols;
        for (int k = 0; k < Q; ++k) {
          const float bw = bs[k * ldn + n] * dec[k];
          const float4* xk = reinterpret_cast<const float4*>(cx + k * ldp + p0);
#pragma unroll
          for (int g = 0; g < kCols / 4; ++g) {
            const float4 x = xk[g];
            a[4 * g] = fmaf(bw, x.x, a[4 * g]);
            a[4 * g + 1] = fmaf(bw, x.y, a[4 * g + 1]);
            a[4 * g + 2] = fmaf(bw, x.z, a[4 * g + 2]);
            a[4 * g + 3] = fmaf(bw, x.w, a[4 * g + 3]);
          }
        }
        float* Sn = S + ((c * H + h) * (long long)N + n) * P + p0;
#pragma unroll
        for (int u = 0; u < kCols; ++u)
          if (p0 + u < P) Sn[u] = a[u];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores with mma.sync, for the bf16 shapes the Hopper
// kernel does not take: Q <= 128 with Q and N multiples of 16 and P of 8 (the
// SMOKE configs' chunks and the tests' small shapes; the caller refuses other
// bf16 shapes).
//
// One block of 8 warps per (cell, head block).  B, C, the head's xdt tile
// and the decayed B are staged in shared memory as bf16, rows padded by 16
// bytes so that ldmatrix row addresses fall on distinct banks.
//   scores: C B^T with mma.sync m16n8k16 (bf16 products are exact in
//           float32, the sums float32, as the Pallas kernel's dot); warp w
//           computes row tile w up to the diagonal, into a float32 array.
//   y:      (scores * exp(cum_q - cum_k)) xdt with mma.sync m16n8k8 tf32: the
//           weights are formed in float32 and split into two tf32 values,
//           w = hi + lo, each multiplied by xdt (exact in tf32), so the
//           products keep about 21 bits of the float32 weight.  Warp w takes
//           row tile w for the first half of P and row tile R-1-w for the
//           second, so the causal work is even across warps.
//   S:      (B * T(decay))^T xdt with mma.sync m16n8k16 bf16: the decayed B
//           is rounded to bf16 as the Pallas kernel rounds it, so the products
//           are exact and the sums float32; the (n, p) tiles are dealt out
//           round-robin.
// The split weights are the one step coarser than the Pallas kernel's
// float32 product (about 2^-21 relative); it is far below y's own rounding
// to bf16.
constexpr int kTcWarps = 8;
constexpr int kTcThreads = kTcWarps * 32;

__host__ __device__ inline int tc_ld(int n) { return n + 8; }  // bf16 row stride

__host__ __device__ inline size_t tc_smem_bytes(int Q, int N, int P) {
  // scores (Q, Q + 4) float32, cum and decay (Q each) float32; B and C-then-BW
  // (Q, N + 8) bf16 each; xdt (Q, P + 8) bf16
  return sizeof(float) * ((size_t)Q * (Q + 4) + 2 * (size_t)Q) +
         sizeof(__nv_bfloat16) * ((size_t)Q * (2 * tc_ld(N) + tc_ld(P)));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(kTcThreads)
ssd_chunk_tc_kernel(const __nv_bfloat16* __restrict__ cum, const __nv_bfloat16* __restrict__ xdt,
                    const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ S, int Q, int H, int P,
                    int N, int hb) {
  extern __shared__ float4 smem4[];
  const int ldn = tc_ld(N), ldp = tc_ld(P), ldq = Q + 4;
  float* sc = reinterpret_cast<float*>(smem4);  // (Q, Q + 4) scores, lower triangle
  float* cumh = sc + Q * ldq;                   // (Q)
  float* dec = cumh + Q;                        // (Q) exp(cum[Q-1] - cum[k]), rounded to bf16
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(dec + Q);  // (Q, N + 8) B
  __nv_bfloat16* cw = bs + Q * ldn;   // (Q, N + 8) C; then per head BW = B * decay
  __nv_bfloat16* xs = cw + Q * ldn;   // (Q, P + 8) xdt of one head

  const long long c = blockIdx.x;
  const int h0 = blockIdx.y * hb;
  const int h1 = min(H, h0 + hb);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int R = Q / 16;  // row tiles

  {  // B and C of the cell, 16 bytes at a time
    const int nch = N / 8;
    const __nv_bfloat16* Bc = Bm + c * Q * N;
    const __nv_bfloat16* Cc = Cm + c * Q * N;
    for (int i = tid; i < Q * nch; i += kTcThreads) {
      const int r = i / nch, ch = i - r * nch;
      *reinterpret_cast<uint4*>(bs + r * ldn + ch * 8) = *reinterpret_cast<const uint4*>(Bc + r * N + ch * 8);
      *reinterpret_cast<uint4*>(cw + r * ldn + ch * 8) = *reinterpret_cast<const uint4*>(Cc + r * N + ch * 8);
    }
  }
  __syncthreads();
  if (warp < R) {  // scores of row tile `warp`, keys up to its diagonal
    const int r = warp;
    for (int np = 0; np <= r; ++np) {  // 16 keys at a time
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t af[4], bf[4];
        ldsm_x4(af, cw + (r * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldn + kk * 16 + (lane >> 4) * 8);
        ldsm_x4(bf, bs + (np * 16 + (lane & 7) + (lane >> 4) * 8) * ldn + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[0], af, bf[0], bf[1]);
        mma_bf16(acc[1], af, bf[2], bf[3]);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int col = np * 16 + t * 8 + 2 * q4;
        *reinterpret_cast<float2*>(sc + (r * 16 + g) * ldq + col) = make_float2(acc[t][0], acc[t][1]);
        *reinterpret_cast<float2*>(sc + (r * 16 + g + 8) * ldq + col) = make_float2(acc[t][2], acc[t][3]);
      }
    }
  }

  const int T = P / 8;             // tiles of 8 columns of P
  const int half = (T + 1) / 2;    // the first half's tiles
  const int n_s = (N / 16) * T;    // S items: (16 rows of N, 8 columns of P)
  for (int h = h0; h < h1; ++h) {
    __syncthreads();  // the scores are done, or the previous head is consumed
    {
      const int pch = P / 8;
      for (int i = tid; i < Q * pch; i += kTcThreads) {
        const int r = i / pch, ch = i - r * pch;
        *reinterpret_cast<uint4*>(xs + r * ldp + ch * 8) =
            *reinterpret_cast<const uint4*>(xdt + ((c * Q + r) * H + h) * (long long)P + ch * 8);
      }
      const float last = __bfloat162float(cum[(c * Q + Q - 1) * H + h]);
      for (int i = tid; i < Q; i += kTcThreads) {
        const float ci = __bfloat162float(cum[(c * Q + i) * H + h]);
        cumh[i] = ci;
        dec[i] = __bfloat162float(__float2bfloat16_rn(expf(last - ci)));
      }
    }
    __syncthreads();
    for (int i = tid; i < Q * N; i += kTcThreads) {  // BW = B * T(decay), rounded to bf16
      const int r = i / N, n = i - r * N;
      cw[r * ldn + n] = __float2bfloat16_rn(__bfloat162float(bs[r * ldn + n]) * dec[r]);
    }
    __syncthreads();

    // y: this warp's two (row tile, half of P) items
    for (int part = 0; part < 2; ++part) {
      const int r = part == 0 ? warp : R - 1 - warp;
      if (warp >= R) continue;
      const int t0 = part == 0 ? 0 : half, t1 = part == 0 ? half : T;
      if (t0 >= t1) continue;
      float acc[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
      const int qa = r * 16 + g, qb = qa + 8;
      const float ca = cumh[qa], cb = cumh[qb];
      for (int k0 = 0; k0 < (r + 1) * 16; k0 += 8) {
        const int ka = k0 + q4, kb = ka + 4;
        const float cka = cumh[ka], ckb = cumh[kb];
        const float w[4] = {ka <= qa ? sc[qa * ldq + ka] * __expf(ca - cka) : 0.f,
                            ka <= qb ? sc[qb * ldq + ka] * __expf(cb - cka) : 0.f,
                            kb <= qa ? sc[qa * ldq + kb] * __expf(ca - ckb) : 0.f,
                            kb <= qb ? sc[qb * ldq + kb] * __expf(cb - ckb) : 0.f};
        uint32_t hi[4], lo[4];  // w = hi + lo, each a tf32 value
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hi[e] = to_tf32(w[e]);
          lo[e] = to_tf32(w[e] - __uint_as_float(hi[e]));
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          if (t0 + t >= t1) break;
          const int col = (t0 + t) * 8 + g;
          const uint32_t b0 = __float_as_uint(__bfloat162float(xs[ka * ldp + col]));
          const uint32_t b1 = __float_as_uint(__bfloat162float(xs[kb * ldp + col]));
          mma_tf32(acc[t], hi, b0, b1);
          mma_tf32(acc[t], lo, b0, b1);
        }
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if (t0 + t >= t1) break;
        const int col = (t0 + t) * 8 + 2 * q4;
        *reinterpret_cast<uint32_t*>(y + ((c * Q + qa) * H + h) * (long long)P + col) = pack_bf16(acc[t][0], acc[t][1]);
        *reinterpret_cast<uint32_t*>(y + ((c * Q + qb) * H + h) * (long long)P + col) = pack_bf16(acc[t][2], acc[t][3]);
      }
    }

    // S[h, n, p] = sum_k BW[k, n] xdt[k, p]: (16 n x 8 p) tiles, round-robin
    for (int it = warp; it < n_s; it += kTcWarps) {
      const int nt = it / T, pt = it - nt * T;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < Q; k0 += 16) {
        uint32_t af[4], b0, b1;
        // A = BW^T (n x k), read transposed from BW stored (k, n)
        ldsm_x4_trans(af, cw + (k0 + (lane & 7) + (lane >> 4) * 8) * ldn + nt * 16 + ((lane >> 3) & 1) * 8);
        // B = xdt (k x p), read transposed from its (k, p) rows; lanes 16-31 repeat 0-15
        ldsm_x2_trans(b0, b1, xs + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldp + pt * 8);
        mma_bf16(acc, af, b0, b1);
      }
      const int n = nt * 16 + g, col = pt * 8 + 2 * q4;
      float* Sh = S + (c * H + h) * (long long)N * P;
      *reinterpret_cast<float2*>(Sh + n * (long long)P + col) = make_float2(acc[0], acc[1]);
      *reinterpret_cast<float2*>(Sh + (n + 8) * (long long)P + col) = make_float2(acc[2], acc[3]);
    }
  }
}

// the shapes the mma.sync kernel takes
bool tc_shape_ok(int Q, int N, int P) {
  return Q >= 16 && Q <= 16 * kTcWarps && Q % 16 == 0 && N % 16 == 0 && P % 8 == 0 && P <= 128 &&
         tc_smem_bytes(Q, N, P) <= kMaxSmem;
}

// ---------------------------------------------------------------------------
// bf16 at the models' shapes (Q 128, P 64, N 64 or 128) on Hopper: wgmma fed
// by TMA, warp specialised, persistent.
//
// Work items are (cell, group of `hb` heads); one block per SM takes them
// from a work queue (hopper::next_unit).  Warp 8 produces: per item it loads
// the cell's B and C with TMA (3-D maps over (nc, Q, N), 64 columns of N a
// 128-byte swizzled box), and per head the (Q x P) xdt tile out of
// (nc, Q, H, P) through a 4-D map into a ring of stages; beside each tile it
// puts the head's cum column (plain loads: a column of one head is strided
// by H, no TMA box) and the decays to the chunk's end, rounded to bf16, into
// the stage, so the next heads' bytes are in flight while the current one is
// consumed.  Warpgroups 0 and 1 consume, query rows 0-63 and 64-127:
//   scores  C B^T with wgmma (SS, both operands K-major), once per item,
//           kept in registers across the item's heads; warpgroup 0 computes
//           keys 0-63 only (keys 64-127 are masked for all its rows);
//   y       per head, the score fragment weighted in registers by
//           exp(cum_q - cum_k) (masked to -inf above the diagonal before the
//           exponential), then wgmma RS with the weights as the A operand
//           and the xdt tile as the MN-major B operand, as K4's P V;
//   S       (B T(decay))^T xdt: the warpgroup that owns a 64-row tile of N
//           writes BW = B T(decay) rounded to bf16 into C's space (C is not
//           needed after the scores) and runs wgmma SS with BW as the
//           MN-major A operand and xdt as the MN-major B operand.  At N 64
//           warpgroup 0 computes S (its y covers half the keys); at N 128
//           each warpgroup one tile.
// Precision of y: the float32 weight w is split into two bf16 pieces,
// hi = bf16(w) and lo = bf16(w - hi) (w - hi is exact), so w is kept to 16
// significant bits (within about 2^-17 of it); each piece times a bf16 xdt
// is exact in float32 and the sums are float32.  Two pieces, not three: a
// third would keep 24 bits for half again the y products' cost, and the
// 2^-17 already lies far below y's own rounding to bf16 (2^-9).  (The
// mma.sync kernel splits into two tf32 parts instead; wgmma takes bf16, not
// tf32, from registers.)
// Outputs: each warpgroup stages its y tile (64 rows x 128 bytes, bf16) and
// its S tile (64 rows of N x 64 float32, two 128-byte swizzled boxes) in
// shared memory, double-buffered, and one thread writes them with TMA stores
// (y strided by H P through a 4-D map; S through a 3-D float32 map over
// (nc H, N, P)).
constexpr int kWQ = 128;                    // rows of a cell
constexpr int kWThreads = 384;              // warpgroups 0 and 1 consume, warp 8 produces
constexpr uint32_t kBox = 128 * 128;        // 128 rows of 128 bytes
constexpr uint32_t kHalfBox = 64 * 128;     // 64 rows of 128 bytes
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
struct WLayout {
  static constexpr int kTiles = N / 64;                    // 64-column boxes of B and C; 64-row tiles of S
  static constexpr int kStages = N == 64 ? 4 : 3;          // xdt ring
  static constexpr uint32_t kB = 0;                        // B: kTiles boxes of (Q rows, 64 columns)
  static constexpr uint32_t kC = kB + kTiles * kBox;       // C, then BW
  static constexpr uint32_t kX = kC + kTiles * kBox;       // xdt ring: (Q rows, P = 64 columns) a stage
  static constexpr uint32_t kY = kX + kStages * kBox;      // y staging: [warpgroup][buffer] 64 rows
  static constexpr uint32_t kS = kY + 4 * kHalfBox;        // S staging: [tile][buffer] 2 boxes of 64 x 32 float
  static constexpr uint32_t kCum = kS + kTiles * 4 * kHalfBox;  // per stage: cum[Q], decay[Q] (float)
  static constexpr uint32_t kBar = kCum + kStages * 2 * kWQ * 4;
  static constexpr int kBars = 2 * kStages + 6;  // full, empty per stage; bc_full, bc_empty; sched full, empty x 2
  static constexpr uint32_t kItem = kBar + kBars * 8;
  static constexpr size_t kSmem = kItem + 2 * sizeof(int) + 1024;  // 1024: alignment of the boxes
};

struct WArgs {
  const __nv_bfloat16* cum;  // (nc, Q, H)
  int nc, H, hb, groups;     // groups = ceil(H / hb) work items per cell
  int* sched;                // (2,) int32, zero at launch and left zero: the work queue
};

struct WItem {
  int cell, h0, nh;
};

__device__ __forceinline__ WItem w_item(const WArgs& a, int i) {
  WItem w;
  w.cell = i / a.groups;
  w.h0 = (i - w.cell * a.groups) * a.hb;
  w.nh = min(a.hb, a.H - w.h0);
  return w;
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Warpgroup W (query rows 64 W .. 64 W + 63) of the consumers.  KEYS: the
// keys its scores cover (64 for warpgroup 0, 128 for warpgroup 1).
template <int N, int W>
__device__ __forceinline__ void wgmma_consume(uint8_t* smem, const WArgs& a, const CUtensorMap* tmY,
                                              const CUtensorMap* tmS) {
  using L = WLayout<N>;
  constexpr int KEYS = W == 0 ? 64 : 128;
  constexpr bool kDoS = N == 128 || W == 0;  // this warpgroup computes S's tile W
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = bar;
  uint64_t* empty = bar + L::kStages;
  uint64_t* bc_full = bar + 2 * L::kStages;
  uint64_t* bc_empty = bc_full + 1;
  uint64_t* sched_full = bc_full + 2;
  uint64_t* sched_empty = sched_full + 2;
  volatile int* sched_item = reinterpret_cast<volatile int*>(smem + L::kItem);
  const uint8_t* bs = smem + L::kB;
  uint8_t* cs = smem + L::kC;
  const int n_items = a.nc * a.groups;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c4 = lane & 3;
  const int rho0 = 16 * warp + g;  // this thread's rows of the warpgroup's 64: rho0, rho0 + 8
  const int q0 = 64 * W + rho0;
  int stage = 0, jh = 0;  // the ring's stage and phase; heads stored so far (staging buffer jh & 1)
  uint32_t phase = 0;
  for (int i = blockIdx.x, j = 0; i < n_items; ++j) {
    const WItem w = w_item(a, i);
    hopper::mbar_wait(bc_full, j & 1);
    // scores of this warpgroup's rows against keys 0 .. KEYS - 1
    float s[KEYS / 2];
    hopper::fence_regs(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint64_t da = hopper::desc_sw128(cs + (kk / 4) * kBox + W * kHalfBox + (kk % 4) * 32, 16, 1024);
      const uint64_t db = hopper::desc_sw128(bs + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024);
      if constexpr (KEYS == 64) {
        hopper::wgmma_m64n64k16_ss<0, 0>(s, da, db, kk > 0);
      } else {
        hopper::wgmma_m64n128k16_ss<0>(s, da, db, kk > 0);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    named_sync(1, 256);  // both warpgroups have read C: BW may overwrite it

    for (int hh = 0; hh < w.nh; ++hh) {
      const int h = w.h0 + hh;
      const int buf = jh & 1;
      // the stores that read staging buffer `buf` (two heads ago) are done
      if (tid == 0) hopper::bulk_wait_read<1>();
      hopper::mbar_wait(&full[stage], phase);
      const float* cum = reinterpret_cast<const float*>(smem + L::kCum) + stage * 2 * kWQ;
      const float* dec = cum + kWQ;
      const uint8_t* xs = smem + L::kX + stage * kBox;
      uint8_t* bw = cs + W * kBox;
      if constexpr (kDoS) {
        // BW = B * T(decay) rounded to bf16, 16 bytes (8 columns of one row k) at a time;
        // the swizzle moves 16-byte pieces only within their row
        const uint8_t* src = bs + W * kBox;
#pragma unroll 2
        for (int ci = tid; ci < kBox / 16; ci += 128) {
          const float d = dec[ci >> 3];
          uint4 v = *reinterpret_cast<const uint4*>(src + ci * 16);
          uint32_t* pv = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pv[e] = hopper::pack_bf16(__uint_as_float(pv[e] << 16) * d, __uint_as_float(pv[e] & 0xffff0000u) * d);
          *reinterpret_cast<uint4*>(bw + ci * 16) = v;
        }
        hopper::fence_proxy_async();
      }
      named_sync(2 + W, 128);  // BW is written and staging buffer `buf` is free

      float sacc[32];
      if constexpr (kDoS) {  // S tile W = BW^T xdt, issued now, waited for after the weights
        hopper::fence_regs(sacc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWQ / 16; ++kk) {
          const uint64_t da = hopper::desc_sw128(bw + kk * 2048, kBox, 1024);
          const uint64_t db = hopper::desc_sw128(xs + kk * 2048, kBox, 1024);
          hopper::wgmma_m64n64k16_ss<1, 1>(sacc, da, db, kk > 0);
        }
        hopper::wgmma_commit();
        hopper::fence_regs(sacc);
      }

      // y's weights: the score fragment times exp(cum_q - cum_k), as two bf16 pieces
      uint32_t hi[KEYS / 16][4], lo[KEYS / 16][4];
      const float cq0 = cum[q0], cq1 = cum[q0 + 8];
#pragma unroll
      for (int kt = 0; kt < KEYS / 16; ++kt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int jj = 2 * kt + half;
          const int k = 8 * jj + 2 * c4;  // this thread's keys k, k + 1
          const float2 ck = *reinterpret_cast<const float2*>(cum + k);
          const float w00 = s[4 * jj] * hopper::exp2_ftz((k <= q0 ? cq0 - ck.x : -INFINITY) * kLog2e);
          const float w01 = s[4 * jj + 1] * hopper::exp2_ftz((k + 1 <= q0 ? cq0 - ck.y : -INFINITY) * kLog2e);
          const float w10 = s[4 * jj + 2] * hopper::exp2_ftz((k <= q0 + 8 ? cq1 - ck.x : -INFINITY) * kLog2e);
          const float w11 = s[4 * jj + 3] * hopper::exp2_ftz((k + 1 <= q0 + 8 ? cq1 - ck.y : -INFINITY) * kLog2e);
          const uint32_t h0 = hopper::pack_bf16(w00, w01), h1 = hopper::pack_bf16(w10, w11);
          hi[kt][2 * half] = h0;
          hi[kt][2 * half + 1] = h1;
          lo[kt][2 * half] = hopper::pack_bf16(w00 - __uint_as_float(h0 << 16), w01 - __uint_as_float(h0 & 0xffff0000u));
          lo[kt][2 * half + 1] =
              hopper::pack_bf16(w10 - __uint_as_float(h1 << 16), w11 - __uint_as_float(h1 & 0xffff0000u));
        }
      }

      if constexpr (kDoS) {  // S into its staging buffer: rows n of the tile, 32 columns a box
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sacc);
        uint8_t* st = smem + L::kS + (W * 2 + buf) * 2 * kHalfBox;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int pc = (8 * jj + 2 * c4) & 31;
          const uint32_t off = (jj >> 2) * kHalfBox + ((((pc >> 2) ^ g) << 4) | ((pc & 3) * 4));
          *reinterpret_cast<float2*>(st + off + rho0 * 128) = make_float2(sacc[4 * jj], sacc[4 * jj + 1]);
          *reinterpret_cast<float2*>(st + off + (rho0 + 8) * 128) = make_float2(sacc[4 * jj + 2], sacc[4 * jj + 3]);
        }
      }

      float yacc[32];
      hopper::fence_regs(yacc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < KEYS / 16; ++kt) {
        const uint64_t db = hopper::desc_sw128(xs + kt * 2048, kBox, 1024);
        hopper::wgmma_m64n64k16_rs<1>(yacc, hi[kt], db, kt > 0);
        hopper::wgmma_m64n64k16_rs<1>(yacc, lo[kt], db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(yacc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);  // this warp is done with the stage
      if (++stage == L::kStages) {
        stage = 0;
        phase ^= 1;
      }

      // y into its staging buffer (bf16 pairs), then both tiles out by TMA
      uint8_t* yt = smem + L::kY + (W * 2 + buf) * kHalfBox;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const uint32_t off = ((jj ^ g) << 4) + 4 * c4;
        *reinterpret_cast<uint32_t*>(yt + rho0 * 128 + off) = hopper::pack_bf16(yacc[4 * jj], yacc[4 * jj + 1]);
        *reinterpret_cast<uint32_t*>(yt + (rho0 + 8) * 128 + off) =
            hopper::pack_bf16(yacc[4 * jj + 2], yacc[4 * jj + 3]);
      }
      hopper::fence_proxy_async();
      named_sync(2 + W, 128);
      if (tid == 0) {
        hopper::tma_store_4d(tmY, yt, 0, h, 64 * W, w.cell);
        if constexpr (kDoS) {
          const uint8_t* st = smem + L::kS + (W * 2 + buf) * 2 * kHalfBox;
          hopper::tma_store_3d(tmS, st, 0, 64 * W, w.cell * a.H + h);
          hopper::tma_store_3d(tmS, st + kHalfBox, 32, 64 * W, w.cell * a.H + h);
        }
        hopper::bulk_commit();
      }
      ++jh;
    }
    // B and C (now BW) are read: the producer may load the next item's
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bc_empty);
    // the next item, as the producer took it
    const int sb = j & 1;
    hopper::mbar_wait(&sched_full[sb], (j >> 1) & 1);
    i = sched_item[sb];
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&sched_empty[sb]);
  }
  if (tid == 0) hopper::bulk_wait<0>();  // every store has landed before the block ends
}

template <int N>
__global__ void __launch_bounds__(kWThreads, 1)
    ssd_chunk_wgmma_kernel(const __grid_constant__ CUtensorMap tmX, const __grid_constant__ CUtensorMap tmB,
                           const __grid_constant__ CUtensorMap tmC, const __grid_constant__ CUtensorMap tmY,
                           const __grid_constant__ CUtensorMap tmS, const WArgs a) {
  using L = WLayout<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = bar;
  uint64_t* empty = bar + L::kStages;
  uint64_t* bc_full = bar + 2 * L::kStages;
  uint64_t* bc_empty = bc_full + 1;
  uint64_t* sched_full = bc_full + 2;
  uint64_t* sched_empty = sched_full + 2;
  volatile int* sched_item = reinterpret_cast<volatile int*>(smem + L::kItem);
  const int n_items = a.nc * a.groups;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      hopper::mbar_init(&full[s], 2);   // the tile's bytes (with the producer's arrival) and its cum column
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_init(bc_full, 1);
    hopper::mbar_init(bc_empty, 8);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&sched_full[s], 1);
      hopper::mbar_init(&sched_empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    hopper::regs_dealloc<56>();
    if (threadIdx.x < 256 + 32) {
      // ---- producer warp: per item B and C, per head the xdt tile (lane 0,
      // TMA) and the head's cum column and decays (all lanes)
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        hopper::prefetch_tensormap(&tmX);
        hopper::prefetch_tensormap(&tmB);
        hopper::prefetch_tensormap(&tmC);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int i = blockIdx.x, j = 0; i < n_items; ++j) {
        const WItem w = w_item(a, i);
        if (lane == 0) {
          hopper::mbar_wait(bc_empty, (j & 1) ^ 1);
          hopper::mbar_expect_tx(bc_full, 2 * L::kTiles * kBox);
          for (int x = 0; x < L::kTiles; ++x) {
            hopper::tma_load_3d(smem + L::kB + x * kBox, &tmB, bc_full, 64 * x, 0, w.cell);
            hopper::tma_load_3d(smem + L::kC + x * kBox, &tmC, bc_full, 64 * x, 0, w.cell);
          }
        }
        for (int hh = 0; hh < w.nh; ++hh) {
          const int h = w.h0 + hh;
          if (lane == 0) {
            hopper::mbar_wait(&empty[stage], phase ^ 1);
            hopper::mbar_expect_tx(&full[stage], kBox);
            hopper::tma_load_4d(smem + L::kX + stage * kBox, &tmX, &full[stage], 0, h, 0, w.cell);
          }
          __syncwarp();  // the stage is free for every lane
          float v[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            v[r] = __bfloat162float(a.cum[((long long)w.cell * kWQ + lane + 32 * r) * a.H + h]);
          const float last = __shfl_sync(0xffffffffu, v[3], 31);
          float* cd = reinterpret_cast<float*>(smem + L::kCum) + stage * 2 * kWQ;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            cd[lane + 32 * r] = v[r];
            cd[kWQ + lane + 32 * r] = __bfloat162float(__float2bfloat16_rn(expf(last - v[r])));
          }
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&full[stage]);
          if (++stage == L::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        int next = 0;
        if (lane == 0) {
          next = hopper::next_unit(a.sched, n_items);
          const int sb = j & 1;
          hopper::mbar_wait(&sched_empty[sb], ((j >> 1) & 1) ^ 1);
          sched_item[sb] = next;
          hopper::mbar_arrive(&sched_full[sb]);
        }
        i = __shfl_sync(0xffffffffu, next, 0);
      }
    }
  } else {
    hopper::regs_alloc<224>();
    if (wg == 0) {
      wgmma_consume<N, 0>(smem, a, &tmY, &tmS);
    } else {
      wgmma_consume<N, 1>(smem, a, &tmY, &tmS);
    }
  }
}

// the shapes the Hopper kernel takes
bool wgmma_shape_ok(int Q, int N, int P) { return Q == kWQ && P == 64 && (N == 64 || N == 128); }

template <int N>
int launch_wgmma(const void* cum, const void* xdt, const void* B, const void* C, void* y, void* S, long long nc,
                 int H, int hb, int* sched, int device, cudaStream_t stream) {
  using L = WLayout<N>;
  constexpr int P = 64;
  CUtensorMap tmX, tmB, tmC, tmY, tmS;
  // xdt and y: (nc, Q, H, P) as [P, H, Q, nc], a box one head's rows
  const uint64_t dx[4] = {(uint64_t)P, (uint64_t)H, (uint64_t)kWQ, (uint64_t)nc};
  const uint64_t sx[3] = {(uint64_t)P * 2, (uint64_t)H * P * 2, (uint64_t)kWQ * H * P * 2};
  const uint32_t bx[4] = {64, 1, (uint32_t)kWQ, 1}, by[4] = {64, 1, 64, 1};
  // B and C: (nc, Q, N) as [N, Q, nc], 64 columns a box
  const uint64_t dbc[3] = {(uint64_t)N, (uint64_t)kWQ, (uint64_t)nc};
  const uint64_t sbc[2] = {(uint64_t)N * 2, (uint64_t)kWQ * N * 2};
  const uint32_t bbc[3] = {64, (uint32_t)kWQ, 1};
  // S: (nc, H, N, P) float32 as [P, N, nc H], a box 32 columns (128 bytes) of 64 rows
  const uint64_t ds[3] = {(uint64_t)P, (uint64_t)N, (uint64_t)nc * H};
  const uint64_t ss[2] = {(uint64_t)P * 4, (uint64_t)N * P * 4};
  const uint32_t bs[3] = {32, 64, 1};
  int err = hopper::encode_bf16_map(&tmX, xdt, 4, dx, sx, bx);
  if (!err) err = hopper::encode_bf16_map(&tmY, y, 4, dx, sx, by);
  if (!err) err = hopper::encode_bf16_map(&tmB, B, 3, dbc, sbc, bbc);
  if (!err) err = hopper::encode_bf16_map(&tmC, C, 3, dbc, sbc, bbc);
  if (!err) err = hopper::encode_f32_map(&tmS, S, 3, ds, ss, bs);
  if (err) return err;
  WArgs a;
  a.cum = static_cast<const __nv_bfloat16*>(cum);
  a.nc = (int)nc;
  a.H = H;
  a.hb = hb;
  a.groups = (H + hb - 1) / hb;
  a.sched = sched;
  const int sms = hopper::sm_count(device);
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  auto kernel = ssd_chunk_wgmma_kernel<N>;
  static bool smem_set[64] = {};  // the shared-memory limit, raised once per device
  if (!smem_set[device]) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
    if (e != cudaSuccess) return (int)e;
    smem_set[device] = true;
  }
  const long long items = nc * a.groups;
  kernel<<<(unsigned)(items < sms ? items : sms), kWThreads, L::kSmem, stream>>>(tmX, tmB, tmC, tmY, tmS, a);
  return (int)cudaGetLastError();
}

int launch_tc(const void* cum, const void* xdt, const void* B, const void* C, void* y, void* S,
              long long nc, int Q, int H, int P, int N, int hb, int* sched, int device, cudaStream_t stream) {
  const void* ptr[6] = {cum, xdt, B, C, y, S};  // read and written in 16-byte pieces
  for (int i = 0; i < 6; ++i)
    if (reinterpret_cast<uintptr_t>(ptr[i]) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (wgmma_shape_ok(Q, N, P)) {
    if (nc * ((H + hb - 1) / hb) >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    return N == 64 ? launch_wgmma<64>(cum, xdt, B, C, y, S, nc, H, hb, sched, device, stream)
                   : launch_wgmma<128>(cum, xdt, B, C, y, S, nc, H, hb, sched, device, stream);
  }
  if (!tc_shape_ok(Q, N, P)) return (int)cudaErrorInvalidValue;
  const size_t smem = tc_smem_bytes(Q, N, P);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)nc, (unsigned)((H + hb - 1) / hb));
  ssd_chunk_tc_kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(cum), static_cast<const __nv_bfloat16*>(xdt),
      static_cast<const __nv_bfloat16*>(B), static_cast<const __nv_bfloat16*>(C),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(S), Q, H, P, N, hb);
  return (int)cudaGetLastError();
}

int launch_f32(const void* cum, const void* xdt, const void* B, const void* C, void* y, void* S,
               long long nc, int Q, int H, int P, int N, int hb, cudaStream_t stream) {
  const size_t smem = smem_bytes(Q, N, P);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)nc, (unsigned)((H + hb - 1) / hb));
  ssd_chunk_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(cum), static_cast<const float*>(xdt), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y), static_cast<float*>(S), Q, H, P, N, hb);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a launch of type `dtype` at (Q, N, P) needs,
// or -1 where no bf16 kernel takes the shape; the caller refuses shapes above
// 232,448 bytes and those at -1.
extern "C" long long ssd_chunk_smem_bytes(int dtype, int Q, int N, int P) {
  if (dtype == 0) return (long long)smem_bytes(Q, N, P);
  if (wgmma_shape_ok(Q, N, P)) return N == 64 ? (long long)WLayout<64>::kSmem : (long long)WLayout<128>::kSmem;
  return tc_shape_ok(Q, N, P) ? (long long)tc_smem_bytes(Q, N, P) : -1;
}

// Plain C entry point, loaded with ctypes.  Pointers are device pointers of
// contiguous tensors on `device`: cum, xdt, B, C and y of one type (dtype 0:
// float32, 1: bfloat16), S float32.  nc cells of Q positions, H heads of
// width P, state size N; `hb` heads per block (per work item of the Hopper
// kernel); `sched` two int32 that are 0, and stay 0 after the launch (the
// Hopper kernel's work queue; one pair per stream).  Returns a CUDA error
// code: that of the tensor maps' encoding, else cudaGetLastError() after
// the launch (0 when it was accepted).
extern "C" int ssd_chunk_launch(const void* cum, const void* xdt, const void* B, const void* C,
                                void* y, void* S, int dtype, long long nc, int Q, int H, int P,
                                int N, int hb, int* sched, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nc == 0 || H == 0) return 0;
  if (hb < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(cum, xdt, B, C, y, S, nc, Q, H, P, N, hb, s);
  if (dtype == 1) return launch_tc(cum, xdt, B, C, y, S, nc, Q, H, P, N, hb, sched, device, s);
  return (int)cudaErrorInvalidValue;
}
