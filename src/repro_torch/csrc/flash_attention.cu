// K4: flash attention forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel _fa_kernel (src/repro/kernels/flash_attention.py:31),
// which walked a (batch*heads, q blocks, kv blocks) grid on one TPU core and
// carried the online-softmax state (m, l, acc) in VMEM from one kv step to the
// next.
//
// For every (batch, head) and every query row i it computes
//     o[i] = sum_j softmax_j(scale * q[i] . k[j]) v[j],   scale = 1/sqrt(hd),
// over the keys j < sk, and with j <= i when causal (positions counted from 0
// in q and in k, as the Pallas kernel counts them).  As in the Pallas kernel
// the scores and the softmax state are float32, the probabilities are rounded
// to v's type before the product with v, the products are summed in float32,
// and o = acc / max(l, 1e-30) is written in q's type.  Unlike it, any sq and
// sk are taken: the ragged last tiles are masked here.
//
// Layout: each of q, k, v, o is addressed as [b, s, h, d] with element strides
// (stride_b, stride_s, stride_h) given by the caller and d contiguous, so both
// the (bh, s, hd) layout of the Pallas kernel (H = 1) and the model's
// (b, s, h, hd) layout run without a transpose.  Grouped kv heads: k and v
// hold H / G heads, and query head h reads kv head h / G (G = 1: one kv head
// per query head), the grouping of the reference model's _sdpa_block
// (src/repro/models/layers.py:125-145); k and v are never repeated per head.
//
// What bounds it: bytes, barely.  At the Zamba2 prefill shape (128 heads x
// 1024 tokens, hd 64, causal, bf16) it does about 1.7e10 floating-point
// operations on 67 MB of inputs and outputs: 0.017 ms on the bf16 tensor
// cores, 0.020 ms at the memory's rate.
//
// Two kernels, one per type:
//   * bf16: the tensor-core kernel below (mma.sync m16n8k16), 64 query rows
//     and 64-key tiles per block; it reads rows in 16-byte pieces, so the
//     caller passes 16-byte aligned rows (every tensor the model passes;
//     the wrapper copies others);
//   * float32: the CUDA-core kernel, one thread per query row, float32
//     products throughout (the reference's float32 tolerance, 2e-5, rules
//     out tf32), any strides.
//
// CUDA-core kernel (float32, simple first): one thread per query row, 64
// rows per block; one block per (batch, head, 64-row query tile).  The block
// stages 32 keys and their values at a time in shared memory (every thread
// reads the same key at the same time: a broadcast, four floats per load),
// and each thread keeps its running max, denominator and the hd accumulators
// in registers, with its query row in registers too for hd <= 64 (in shared
// memory, one padded row per thread, for hd 128).  The softmax streams key by
// key: a key above the running max rescales the sums once, every key adds
// p = exp(s - m) to the denominator and p times v to the accumulators.  This
// is the Pallas kernel's online softmax with a tile of one key (p cast to
// v's type, float32, is p).  Causal:
// tiles of keys past the block's last row are skipped, as the Pallas kernel
// skips kv blocks above the diagonal, and each row stops at its diagonal.
// Neither kernel allocates or synchronises; both run on the caller's stream.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;  // query rows per block, one per thread
constexpr int kKeys = 32;  // keys per shared-memory tile

struct Strides {
  long long b, s, h;  // in elements; d is contiguous
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq_, sk_, sv_, so_;
  int H, G, Sq, Sk, causal;  // G: query heads per kv head
  float scale;
};

template <int HD>
constexpr bool kQInRegisters = HD <= 64;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kKeys * HD + (kQInRegisters<HD> ? 0 : kRows * (HD + 1)));
}

template <int HD>
__global__ void __launch_bounds__(kRows) flash_attention_kernel(const Args a) {
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned rows
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem;              // (kKeys, HD)
  float* vs = ks + kKeys * HD;   // (kKeys, HD)
  float* qs = vs + kKeys * HD;   // (kRows, HD + 1), only when q is not in registers

  const int tiles = (a.Sq + kRows - 1) / kRows;
  const long long bh = blockIdx.x / tiles;
  const int qt = (int)(blockIdx.x - bh * tiles);
  const long long b = bh / a.H;
  const int h = (int)(bh - b * a.H);
  const int tid = threadIdx.x;
  const int row0 = qt * kRows;
  const int row = row0 + tid;
  const bool live = row < a.Sq;

  const float* q = static_cast<const float*>(a.q) + b * a.sq_.b + h * a.sq_.h;
  const int hk = h / a.G;
  const float* k = static_cast<const float*>(a.k) + b * a.sk_.b + hk * a.sk_.h;
  const float* v = static_cast<const float*>(a.v) + b * a.sv_.b + hk * a.sv_.h;
  float* o = static_cast<float*>(a.o) + b * a.so_.b + h * a.so_.h;

  float qr[kQInRegisters<HD> ? HD : 1];
  if constexpr (kQInRegisters<HD>) {
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = live ? q[row * a.sq_.s + d] : 0.f;
  } else {
    for (int i = tid; i < kRows * HD; i += kRows) {
      const int r = i / HD, d = i - r * HD;
      qs[r * (HD + 1) + d] = row0 + r < a.Sq ? q[(row0 + r) * a.sq_.s + d] : 0.f;
    }
  }

  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  // causal: keys past the block's last row are masked for every row
  const int kv_end = a.causal ? min(a.Sk, row0 + kRows) : a.Sk;
  for (int k0 = 0; k0 < kv_end; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kKeys * HD; i += kRows) {
      const int j = i / HD, d = i - j * HD;
      const bool in = k0 + j < a.Sk;
      ks[i] = in ? k[(k0 + j) * a.sk_.s + d] : 0.f;
      vs[i] = in ? v[(k0 + j) * a.sv_.s + d] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    // keys of this tile visible to this row: [k0, j_end)
    const int j_end = min(kKeys, (a.causal ? min(a.Sk, row + 1) : a.Sk) - k0);
#pragma unroll 1
    for (int j = 0; j < j_end; ++j) {
      const float4* kj = reinterpret_cast<const float4*>(ks + j * HD);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 kv4 = kj[d4];
        float q0, q1, q2, q3;
        if constexpr (kQInRegisters<HD>) {
          q0 = qr[4 * d4]; q1 = qr[4 * d4 + 1]; q2 = qr[4 * d4 + 2]; q3 = qr[4 * d4 + 3];
        } else {
          const float* qrow = qs + tid * (HD + 1) + 4 * d4;
          q0 = qrow[0]; q1 = qrow[1]; q2 = qrow[2]; q3 = qrow[3];
        }
        dot = fmaf(q0, kv4.x, dot);
        dot = fmaf(q1, kv4.y, dot);
        dot = fmaf(q2, kv4.z, dot);
        dot = fmaf(q3, kv4.w, dot);
      }
      const float sj = dot * a.scale;
      if (sj > m) {  // a new running max: rescale what was summed so far
        const float alpha = expf(m - sj);  // 0 at the first key (m = -inf)
        l *= alpha;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] *= alpha;
        m = sj;
      }
      const float p = expf(sj - m);
      l += p;
      const float4* vj = reinterpret_cast<const float4*>(vs + j * HD);
#pragma unroll
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 v4 = vj[d4];
        acc[4 * d4] = fmaf(p, v4.x, acc[4 * d4]);
        acc[4 * d4 + 1] = fmaf(p, v4.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, v4.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, v4.w, acc[4 * d4 + 3]);
      }
    }
  }

  if (live) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < HD; ++d) o[row * a.so_.s + d] = acc[d] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync m16n8k16 (bf16 in, float32 sums).
//
// One block of 4 warps per (batch, head, 64-row query tile); each warp owns
// 16 query rows.  The block stages Q once and then 64 keys and their values
// at a time in shared memory as bf16 (rows padded by 16 bytes so that the
// ldmatrix row addresses fall on distinct banks).  Per key tile a warp
// computes its (16 x 64) scores with mma.sync from Q fragments kept in
// registers, scales and masks them (ragged keys, causal diagonal), updates
// its rows' running max and denominator (float32; each row's 4 lanes agree
// by two shuffles), rounds the probabilities to bf16 straight from the score
// accumulators into A fragments, and adds P V to the float32 output
// accumulators (V read with ldmatrix.trans).  This is the Pallas kernel's
// online softmax with 64-key tiles.  A warp whose rows all lie before a
// causal tile skips it.
constexpr int kMmaRows = 64;  // query rows per block, 16 per warp
constexpr int kMmaKeys = 64;  // keys per tile
constexpr int kMmaThreads = 128;

template <int HD>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (kMmaRows + 2 * kMmaKeys) * (HD + 8);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a b for one m16n8k16 tile: a (16 x 16, row-major fragments), b (16 x 8)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads) flash_attention_mma_kernel(const Args a) {
  constexpr int LD = HD + 8;  // shared row stride, bf16 elements
  constexpr int kChunks = HD / 8;  // 16-byte pieces of a row
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // (kMmaRows, LD)
  __nv_bfloat16* ks = qs + kMmaRows * LD;                       // (kMmaKeys, LD)
  __nv_bfloat16* vs = ks + kMmaKeys * LD;                       // (kMmaKeys, LD)

  const int tiles = (a.Sq + kMmaRows - 1) / kMmaRows;
  const long long bh = blockIdx.x / tiles;
  const int qt = (int)(blockIdx.x - bh * tiles);
  const long long b = bh / a.H;
  const int h = (int)(bh - b * a.H);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int row0 = qt * kMmaRows;
  const int rg = row0 + warp * 16 + g;  // this lane's rows: rg and rg + 8
  const int warp_last = row0 + warp * 16 + 15;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.sq_.b + h * a.sq_.h;
  const int hk = h / a.G;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.sk_.b + hk * a.sk_.h;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.sv_.b + hk * a.sv_.h;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + b * a.so_.b + h * a.so_.h;

  for (int i = tid; i < kMmaRows * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, ch = i - r * kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < a.Sq) val = *reinterpret_cast<const uint4*>(q + (row0 + r) * a.sq_.s + ch * 8);
    *reinterpret_cast<uint4*>(qs + r * LD + ch * 8) = val;
  }
  __syncthreads();
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk * 16 +
                            (lane >> 4) * 8);

  float acc[HD / 8][4];
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int kv_end = a.causal ? min(a.Sk, row0 + kMmaRows) : a.Sk;
  for (int k0 = 0; k0 < kv_end; k0 += kMmaKeys) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kMmaKeys * kChunks; i += kMmaThreads) {
      const int r = i / kChunks, ch = i - r * kChunks;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < a.Sk) {
        kv = *reinterpret_cast<const uint4*>(k + (k0 + r) * a.sk_.s + ch * 8);
        vv = *reinterpret_cast<const uint4*>(v + (k0 + r) * a.sv_.s + ch * 8);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + ch * 8) = kv;
      *reinterpret_cast<uint4*>(vs + r * LD + ch * 8) = vv;
    }
    __syncthreads();
    if (a.causal && k0 > warp_last) continue;  // no key of this tile is visible to this warp

    // scores S = Q K^T for the warp's 16 rows x 64 keys: 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // scale, mask, and the online softmax of rows rg (e = 0, 1) and rg + 8 (e = 2, 3)
    float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + nt * 8 + 2 * c + (e & 1);
        const int row = rg + (e >> 1) * 8;
        const bool visible = kj < a.Sk && (!a.causal || kj <= row);
        s[nt][e] = visible ? s[nt][e] * a.scale : -INFINITY;
      }
      mt0 = fmaxf(mt0, fmaxf(s[nt][0], s[nt][1]));
      mt1 = fmaxf(mt1, fmaxf(s[nt][2], s[nt][3]));
    }
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 1));
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 2));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 1));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 2));
    const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
    // a row with no visible key yet keeps m = -inf; 0 stands in as its reference
    const float ref0 = mn0 == -INFINITY ? 0.f : mn0, ref1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = expf(m0 - ref0), al1 = expf(m1 - ref1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - ref0);
      s[nt][1] = expf(s[nt][1] - ref0);
      s[nt][2] = expf(s[nt][2] - ref1);
      s[nt][3] = expf(s[nt][3] - ref1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      acc[dn][0] *= al0;
      acc[dn][1] *= al0;
      acc[dn][2] *= al1;
      acc[dn][3] *= al1;
    }

    // acc += P V: P rounded to bf16 from the score accumulators, 16 keys a step
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]), pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                                  (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    const int d = dn * 8 + 2 * c;
    if (rg < a.Sq)
      *reinterpret_cast<uint32_t*>(o + rg * a.so_.s + d) = pack_bf16(acc[dn][0] * inv0, acc[dn][1] * inv0);
    if (rg + 8 < a.Sq)
      *reinterpret_cast<uint32_t*>(o + (rg + 8) * a.so_.s + d) =
          pack_bf16(acc[dn][2] * inv1, acc[dn][3] * inv1);
  }
}

template <int HD>
int launch_mma(const Args& a, long long BH, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<HD>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_mma_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long grid = BH * ((a.Sq + kMmaRows - 1) / kMmaRows);
  flash_attention_mma_kernel<HD><<<(unsigned)grid, kMmaThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the tensor-core kernel reads 16-byte pieces of rows: base pointers and
// row strides must allow it
bool rows_aligned(const Args& a) {
  const Strides st[4] = {a.sq_, a.sk_, a.sv_, a.so_};
  const void* ptr[4] = {a.q, a.k, a.v, a.o};
  for (int i = 0; i < 4; ++i) {
    if (reinterpret_cast<uintptr_t>(ptr[i]) % 16 != 0) return false;
    if (st[i].b % 8 != 0 || st[i].s % 8 != 0 || st[i].h % 8 != 0) return false;
  }
  return true;
}

template <int HD>
int launch_f32(const Args& a, long long BH, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long grid = BH * ((a.Sq + kRows - 1) / kRows);
  flash_attention_kernel<HD><<<(unsigned)grid, kRows, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch_f32(const Args& a, int hd, long long BH, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_f32<16>(a, BH, stream);
    case 32: return launch_f32<32>(a, BH, stream);
    case 64: return launch_f32<64>(a, BH, stream);
    case 128: return launch_f32<128>(a, BH, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_bf16(const Args& a, int hd, long long BH, cudaStream_t stream) {
  if (!rows_aligned(a)) return (int)cudaErrorMisalignedAddress;
  switch (hd) {
    case 16: return launch_mma<16>(a, BH, stream);
    case 32: return launch_mma<32>(a, BH, stream);
    case 64: return launch_mma<64>(a, BH, stream);
    case 128: return launch_mma<128>(a, BH, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q, k, v, o are device pointers on
// `device` of one type (dtype 0: float32, 1: bfloat16, 16-byte aligned rows),
// addressed as [b, s, h, d] with the given element strides and d contiguous; B * H
// (batch, query head) pairs, H / G kv heads in k and v, sq query rows, sk
// keys, head dim hd in {16, 32, 64, 128}.  The caller has checked shapes and types.  Returns cudaGetLastError()
// after the launch (0 when the launch was accepted).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, long long B, int H,
    int G, int sq, int sk, int hd, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || H == 0 || sq == 0) return 0;
  if (G < 1 || H % G != 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.sq_ = Strides{qsb, qss, qsh};
  a.sk_ = Strides{ksb, kss, ksh};
  a.sv_ = Strides{vsb, vss, vsh};
  a.so_ = Strides{osb, oss, osh};
  a.H = H;
  a.G = G;
  a.Sq = sq;
  a.Sk = sk;
  a.causal = causal;
  a.scale = (float)(1.0 / std::sqrt((double)hd));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long BH = B * H;
  if (dtype == 0) return dispatch_f32(a, hd, BH, s);
  if (dtype == 1) return dispatch_bf16(a, hd, BH, s);
  return (int)cudaErrorInvalidValue;
}
