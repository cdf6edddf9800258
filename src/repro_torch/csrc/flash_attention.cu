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
// sk are taken: the ragged last tiles are masked here.  With round_scores
// (the model's prompt attention) each q . k is rounded to bf16 before the
// float32 scale, as the reference model's _sdpa_block rounds its bf16
// einsum (src/repro/models/layers.py:131): one conversion each way a score.
//
// Layout: each of q, k, v, o is addressed as [b, s, h, d] with element strides
// (stride_b, stride_s, stride_h) given by the caller and d contiguous, so both
// the (bh, s, hd) layout of the Pallas kernel (H = 1) and the model's
// (b, s, h, hd) layout run without a transpose.  Grouped kv heads: k and v
// hold H / G heads, and query head h reads kv head h / G (G = 1: one kv head
// per query head), the grouping of the reference model's _sdpa_block
// (src/repro/models/layers.py:125-145); k and v are never repeated per head.
//
// What bounds it, causal at (4, 1024) in bf16: operations at the dense
// models' head dim 128 (Nemotron-4-15B, 48 q heads: 5.2e10 of them, 0.052 ms
// on the bf16 tensor cores, against 0.035 ms for its 117 MB of q, k, v and o
// at the memory's rate); bytes, barely, at Zamba2's (32 heads of 64: 0.017
// ms of operations, 0.020 ms of bytes).
//
// Kernels, by type and head dim:
//   * bf16, hd 64 and 128 (every shape of the serving path): the Hopper
//     kernel below (wgmma fed by TMA, warp specialised, persistent; grouped
//     heads packed into a block so each key tile it loads serves two query
//     heads).  It reads rows through TMA, so the caller passes rows that
//     start on 16 bytes (every tensor the model passes; the wrapper copies
//     others);
//   * bf16, hd 16 and 32 (the tests' small shapes only): the mma.sync
//     m16n8k16 kernel, 64 query rows and 64-key tiles per block, chosen by
//     head dim in the C entry point (never as a fallback);
//   * float32: the CUDA-core kernel, one thread per query row, float32
//     products throughout (the reference's float32 tolerance, 2e-5, rules
//     out tf32), any strides.

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
// No kernel allocates or synchronises; all run on the caller's stream (the
// wrapper allocates the Hopper kernel's work queue, two zeroed ints, once
// per stream).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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
// bf16 at head dims 16 and 32, on the tensor cores: mma.sync m16n8k16 (bf16
// in, float32 sums).
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

template <int HD, bool ROUND>
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
        const float x = ROUND ? __bfloat162float(__float2bfloat16_rn(s[nt][e])) : s[nt][e];
        s[nt][e] = visible ? x * a.scale : -INFINITY;
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

// ---------------------------------------------------------------------------
// bf16, head dims 64 and 128, on Hopper: wgmma with TMA, warp specialised.
//
// A block serves up to two units of 64 query rows that read the same kv head:
// two query heads of one group at the same 64 rows (the group's heads packed
// into the block's 128 rows), or, with a group of one, two neighbouring row
// tiles of one head.  One producer thread loads the units' Q tiles once, then
// the kv head's K and V tiles of kKv keys into a ring of stages with TMA (a
// 4-D tensor map over the [b, s, h, d] layout, d innermost, 64 columns of
// 128 bytes a box), under full/empty mbarriers; each key tile it loads is
// used by both units.  Each of two consumer warpgroups owns one unit and per
// key tile runs two wgmma products: S = Q K^T (Q and K from shared memory, K
// as the K-major B operand) and O += P V (P in registers as the A operand,
// rounded to bf16 in place from S's accumulators; V as the MN-major B
// operand), with the float32 online softmax between them.  Causal: the
// producer loads the key tiles up to the later unit's diagonal; a unit
// releases the tiles past its own without computing, and masks only the
// tiles that cross its diagonal or the ragged end of the keys.  The two
// warpgroups take turns at the tensor cores (named barriers), so one's
// softmax runs while the other's products do.  The blocks are persistent,
// one per SM: they take the work items (a pair of units) from a work queue
// (hopper::next_unit), the longest query tiles first, and the producer
// loads the next item's Q tiles (two Q buffers) and first key tiles while
// the consumers finish the current one and store it.
constexpr int kKv = 128;  // keys per tile
constexpr int kWThreads = 384;  // warpgroups 0 and 1 consume, 2 produces

template <int HD>
struct WLayout {
  static constexpr int kBoxes = HD / 64;                  // 64-column boxes of a row
  static constexpr uint32_t kQUnit = kBoxes * 64 * 128;   // one unit's Q tile
  static constexpr uint32_t kKvBox = kKv * 128;           // one 64-column box of a key tile
  static constexpr uint32_t kKvBytes = kBoxes * kKvBox;   // K (or V) of one key tile
  static constexpr int kStages = HD == 64 ? 3 : 2;
  static constexpr uint32_t kStage = 2 * kKvBytes;
  // two Q buffers of two units, the ring, its barriers, the Q buffers' and
  // the schedule's (two slots), the slots' item numbers, 1024 for alignment
  static constexpr size_t kSmem =
      4 * kQUnit + kStages * kStage + (8 + 2 * kStages) * sizeof(uint64_t) + 2 * sizeof(int) + 1024;
};

struct WArgs {
  void* o;
  Strides so_;
  int B, Hkv, G, Sq, Sk, causal;
  int q_tiles, pairs;  // 64-row query tiles; unit pairs (work items) per (batch, kv head)
  float scale_log2;    // log2(e) / sqrt(hd)
  int* sched;          // (2,) int32, zero at launch and left zero: the work queue (hopper::next_unit)
};

// unit u of kv head hk: query head, first row, key tiles (0: no unit)
struct WUnit {
  int head, row0, tiles;
};

__device__ __forceinline__ WUnit w_unit(const WArgs& a, int hk, int u) {
  WUnit w{hk * a.G, 0, 0};
  if (u >= a.q_tiles * a.G) return w;
  w.head += u % a.G;
  w.row0 = (u / a.G) * 64;
  const int keys = a.causal ? min(a.Sk, w.row0 + 64) : a.Sk;
  w.tiles = (keys + kKv - 1) / kKv;
  return w;
}

// work item i (0 = the longest): its batch row, kv head and pair of units
struct WItem {
  int b, hk;
  WUnit u[2];
};

__device__ __forceinline__ WItem w_item(const WArgs& a, int i) {
  const int bhk_count = a.B * a.Hkv;
  const int pair = a.pairs - 1 - i / bhk_count;
  const int bhk = i % bhk_count;
  WItem w;
  w.b = bhk / a.Hkv;
  w.hk = bhk % a.Hkv;
  w.u[0] = w_unit(a, w.hk, 2 * pair);
  w.u[1] = w_unit(a, w.hk, 2 * pair + 1);
  return w;
}

template <int HD, bool ROUND>
__global__ void __launch_bounds__(kWThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tmQ, const __grid_constant__ CUtensorMap tmK,
                                 const __grid_constant__ CUtensorMap tmV, const WArgs a) {
  using L = WLayout<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                      // 2 buffers of (2 units, kBoxes, 64 rows, 128 bytes)
  uint8_t* kvs = smem + 4 * L::kQUnit;     // stages of (K, V), each (kBoxes, kKv keys, 128 bytes)
  uint64_t* full = reinterpret_cast<uint64_t*>(kvs + L::kStages * L::kStage);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_full = empty + L::kStages;   // per Q buffer
  uint64_t* q_empty = q_full + 2;
  uint64_t* sched_full = q_empty + 2;      // the schedule: the producer's next item, two slots
  uint64_t* sched_empty = sched_full + 2;
  volatile int* sched_item = reinterpret_cast<int*>(sched_empty + 2);
  const int n_items = a.pairs * a.B * a.Hkv;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&q_full[s], 1);
      hopper::mbar_init(&q_empty[s], 8);
      hopper::mbar_init(&sched_full[s], 1);
      hopper::mbar_init(&sched_empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: per item, the units' Q tiles into the item's Q buffer,
    // then the kv head's key tiles into the ring; then the block's next item
    // from the work queue (so the items, longest first, go to whichever block
    // is free), passed to the consumers
    hopper::regs_dealloc<40>();
    if (threadIdx.x == 256) {
      hopper::prefetch_tensormap(&tmQ);
      hopper::prefetch_tensormap(&tmK);
      hopper::prefetch_tensormap(&tmV);
      int stage = 0;
      uint32_t phase = 0;
      for (int i = blockIdx.x, j = 0; i < n_items; ++j) {
        const WItem w = w_item(a, i);
        const int buf = j & 1;
        uint8_t* q = qs + buf * 2 * L::kQUnit;
        hopper::mbar_wait(&q_empty[buf], ((j >> 1) & 1) ^ 1);
        hopper::mbar_expect_tx(&q_full[buf], (w.u[1].tiles > 0 ? 2 : 1) * L::kQUnit);
        for (int x = 0; x < L::kBoxes; ++x) {
          hopper::tma_load_4d(q + x * 8192, &tmQ, &q_full[buf], 64 * x, w.u[0].head, w.u[0].row0, w.b);
          if (w.u[1].tiles > 0)
            hopper::tma_load_4d(q + L::kQUnit + x * 8192, &tmQ, &q_full[buf], 64 * x, w.u[1].head,
                                w.u[1].row0, w.b);
        }
        const int n_tiles = max(w.u[0].tiles, w.u[1].tiles);
        for (int t = 0; t < n_tiles; ++t) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = kvs + stage * L::kStage;
          hopper::mbar_expect_tx(&full[stage], L::kStage);
          for (int x = 0; x < L::kBoxes; ++x) {
            hopper::tma_load_4d(st + x * L::kKvBox, &tmK, &full[stage], 64 * x, w.hk, t * kKv, w.b);
            hopper::tma_load_4d(st + L::kKvBytes + x * L::kKvBox, &tmV, &full[stage], 64 * x, w.hk, t * kKv, w.b);
          }
          if (++stage == L::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        i = hopper::next_unit(a.sched, n_items);
        hopper::mbar_wait(&sched_empty[buf], ((j >> 1) & 1) ^ 1);
        sched_item[buf] = i;
        hopper::mbar_arrive(&sched_full[buf]);
      }
    }
  } else {
    // ---- consumers: warpgroup wg computes unit wg of each item
    hopper::regs_alloc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, c = lane & 3;
    int stage = 0;  // the ring's stage and phase at the current item's first key tile
    uint32_t phase = 0;
    // warpgroup 0 takes the first turn
    if (wg == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    for (int i = blockIdx.x, j = 0; i < n_items; ++j) {
      const WItem w = w_item(a, i);
      const WUnit me = wg == 0 ? w.u[0] : w.u[1];
      const int n_tiles = max(w.u[0].tiles, w.u[1].tiles);
      const int r0 = me.row0 + 16 * warp + g;  // this thread's rows: r0 and r0 + 8
      const int buf = j & 1;
      const uint8_t* q = qs + (buf * 2 + wg) * L::kQUnit;
      float o[HD / 2];
#pragma unroll
      for (int x = 0; x < HD / 2; ++x) o[x] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

      // key tile t of this item lies in ring stage (stage + t) % kStages
      auto ring = [&](int t) { return (stage + t) % L::kStages; };
      auto wait_tile = [&](int t) {
        hopper::mbar_wait(&full[ring(t)], phase ^ (((stage + t) / L::kStages) & 1));
      };
      auto release_tile = [&](int t) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[ring(t)]);
      };
      // named barrier 1 + wg: this warpgroup's turn at the tensor cores,
      // passed to the other warpgroup (2 - wg) after each run
      auto turn_wait = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory"); };
      auto turn_pass = [&]() { asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory"); };
      // S = Q K^T of tile t into sd, issued and committed, not waited for
      auto issue_scores = [&](float (&sd)[kKv / 2], int t) {
        const uint8_t* ks = kvs + ring(t) * L::kStage;
        hopper::fence_regs(sd);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint64_t dq = hopper::desc_sw128(q + (kk / 4) * 8192 + (kk % 4) * 32, 16, 1024);
          const uint64_t dk = hopper::desc_sw128(ks + (kk / 4) * L::kKvBox + (kk % 4) * 32, 16, 1024);
          hopper::wgmma_m64n128k16_ss<0>(sd, dq, dk, kk > 0);
        }
        hopper::wgmma_commit();
        hopper::fence_regs(sd);
      };
      // the online softmax of tile t's scores s into P (bf16, rounded from
      // the score accumulators), and O rescaled
      auto softmax = [&](float (&s)[kKv / 2], uint32_t (&p)[kKv / 16][4], int t) {
        // mask, then the online softmax of rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3)
        const int k0 = t * kKv;
        const bool edge = k0 + kKv > a.Sk || (a.causal && k0 + kKv - 1 > me.row0);
        float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < kKv / 8; ++jj) {
          if (ROUND) {  // two scores a conversion (cvt.rn.bf16x2.f32), unpacked by shift and mask
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              const uint32_t u = hopper::pack_bf16(s[4 * jj + e], s[4 * jj + e + 1]);
              s[4 * jj + e] = __uint_as_float(u << 16);
              s[4 * jj + e + 1] = __uint_as_float(u & 0xffff0000u);
            }
          }
          if (edge) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kj = k0 + 8 * jj + 2 * c + (e & 1);
              const int row = r0 + 8 * (e >> 1);
              if (kj >= a.Sk || (a.causal && kj > row)) s[4 * jj + e] = -INFINITY;
            }
          }
          mt0 = fmaxf(mt0, fmaxf(s[4 * jj], s[4 * jj + 1]));
          mt1 = fmaxf(mt1, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
        }
        mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 1));
        mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 2));
        mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 1));
        mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 2));
        // the running max in log2 units (the max of the raw scores times the
        // positive scale); each probability is 2^(s scale - max), one FFMA
        const float mn0 = fmaxf(m0, mt0 * a.scale_log2), mn1 = fmaxf(m1, mt1 * a.scale_log2);
        // a row with no visible key yet keeps m = -inf; 0 stands in as its reference
        const float ref0 = mn0 == -INFINITY ? 0.f : mn0, ref1 = mn1 == -INFINITY ? 0.f : mn1;
        const float al0 = hopper::exp2_ftz(m0 - ref0), al1 = hopper::exp2_ftz(m1 - ref1);
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int jj = 0; jj < kKv / 8; ++jj) {
          s[4 * jj] = hopper::exp2_ftz(fmaf(s[4 * jj], a.scale_log2, -ref0));
          s[4 * jj + 1] = hopper::exp2_ftz(fmaf(s[4 * jj + 1], a.scale_log2, -ref0));
          s[4 * jj + 2] = hopper::exp2_ftz(fmaf(s[4 * jj + 2], a.scale_log2, -ref1));
          s[4 * jj + 3] = hopper::exp2_ftz(fmaf(s[4 * jj + 3], a.scale_log2, -ref1));
          ps0 += s[4 * jj] + s[4 * jj + 1];
          ps1 += s[4 * jj + 2] + s[4 * jj + 3];
        }
#pragma unroll
        for (int kt = 0; kt < kKv / 16; ++kt) {
          p[kt][0] = hopper::pack_bf16(s[8 * kt], s[8 * kt + 1]);
          p[kt][1] = hopper::pack_bf16(s[8 * kt + 2], s[8 * kt + 3]);
          p[kt][2] = hopper::pack_bf16(s[8 * kt + 4], s[8 * kt + 5]);
          p[kt][3] = hopper::pack_bf16(s[8 * kt + 6], s[8 * kt + 7]);
        }
        l0 = l0 * al0 + ps0;
        l1 = l1 * al1 + ps1;
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int jj = 0; jj < HD / 8; ++jj) {
          o[4 * jj] *= al0;
          o[4 * jj + 1] *= al0;
          o[4 * jj + 2] *= al1;
          o[4 * jj + 3] *= al1;
        }
      };
      // O += P V of tile t, 16 keys a product, issued and committed
      auto issue_pv = [&](const uint32_t (&p)[kKv / 16][4], int t) {
        const uint8_t* vs = kvs + ring(t) * L::kStage + L::kKvBytes;
        hopper::fence_regs(o);
        hopper::wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < kKv / 16; ++kt) {
          const uint64_t dv = hopper::desc_sw128(vs + kt * 16 * 128, L::kKvBox, 1024);
          if constexpr (HD == 128) {
            hopper::wgmma_m64n128k16_rs<1>(o, p[kt], dv, 1);
          } else {
            hopper::wgmma_m64n64k16_rs<1>(o, p[kt], dv, 1);
          }
        }
        hopper::wgmma_commit();
        hopper::fence_regs(o);
      };

      hopper::mbar_wait(&q_full[buf], (j >> 1) & 1);
      float s[kKv / 2];
      // Per key tile t: the softmax of S_t, then a run of tensor-core work,
      // O += P_t V_t and then S_{t+1} = Q K_{t+1}^T.  The two warpgroups
      // take turns at their runs (named barriers 1 and 2, n_tiles + 1 runs
      // an item for both), so one's softmax overlaps the other's products.
      turn_wait();
      if (me.tiles > 0) {
        wait_tile(0);
        issue_scores(s, 0);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
      }
      turn_pass();
      for (int t = 0; t < n_tiles; ++t) {
        uint32_t p[kKv / 16][4];
        if (t < me.tiles) softmax(s, p, t);
        turn_wait();
        if (t < me.tiles) {
          issue_pv(p, t);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(o);
        }
        if (t + 1 < me.tiles) {
          wait_tile(t + 1);
          issue_scores(s, t + 1);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(s);
        }
        turn_pass();
        if (t >= me.tiles) wait_tile(t);  // a tile past this unit's diagonal, loaded for the other
        release_tile(t);
      }
      phase ^= ((stage + n_tiles) / L::kStages) & 1;
      stage = (stage + n_tiles) % L::kStages;

      // the Q buffer is read: the producer may load the item after next into it
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&q_empty[buf]);
      // the next item, as the producer took it
      hopper::mbar_wait(&sched_full[buf], (j >> 1) & 1);
      i = sched_item[buf];
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&sched_empty[buf]);
      if (me.tiles == 0) continue;
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o) + w.b * a.so_.b + me.head * a.so_.h;
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj) {
        const int d = 8 * jj + 2 * c;
        if (r0 < a.Sq)
          *reinterpret_cast<uint32_t*>(out + r0 * a.so_.s + d) =
              hopper::pack_bf16(o[4 * jj] * inv0, o[4 * jj + 1] * inv0);
        if (r0 + 8 < a.Sq)
          *reinterpret_cast<uint32_t*>(out + (r0 + 8) * a.so_.s + d) =
              hopper::pack_bf16(o[4 * jj + 2] * inv1, o[4 * jj + 3] * inv1);
      }
    }
    // warpgroup 1 passed the turn once more than warpgroup 0 took it
    if (wg == 0) asm volatile("bar.sync 1, 256;\n" ::: "memory");
  }
}

// a 4-D tensor map over t = [b, s, h, d] (d contiguous) read in boxes of
// (64 columns, one head, `rows` positions, one batch row)
int map_bshd(CUtensorMap* map, const void* t, const Strides& st, long long B, int S, int H, int hd, int rows) {
  const uint64_t dims[4] = {(uint64_t)hd, (uint64_t)H, (uint64_t)S, (uint64_t)B};
  // a single head's stride is never stepped; any legal value stands in for 0
  const uint64_t strides[3] = {(uint64_t)(H > 1 ? st.h : hd) * 2, (uint64_t)st.s * 2, (uint64_t)st.b * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return hopper::encode_bf16_map(map, t, 4, dims, strides, box);
}

template <int HD, bool ROUND>
int launch_wgmma(const Args& a, long long B, int* sched, int device, cudaStream_t stream) {
  using L = WLayout<HD>;
  const int Hkv = a.H / a.G;
  CUtensorMap tmQ, tmK, tmV;
  int err = map_bshd(&tmQ, a.q, a.sq_, B, a.Sq, a.H, HD, 64);
  if (!err) err = map_bshd(&tmK, a.k, a.sk_, B, a.Sk, Hkv, HD, kKv);
  if (!err) err = map_bshd(&tmV, a.v, a.sv_, B, a.Sk, Hkv, HD, kKv);
  if (err) return err;
  WArgs w;
  w.o = a.o;
  w.so_ = a.so_;
  w.B = (int)B;
  w.Hkv = Hkv;
  w.G = a.G;
  w.Sq = a.Sq;
  w.Sk = a.Sk;
  w.causal = a.causal;
  w.q_tiles = (a.Sq + 63) / 64;
  w.pairs = (w.q_tiles * a.G + 1) / 2;
  w.scale_log2 = a.scale * 1.4426950408889634f;
  w.sched = sched;
  auto kernel = flash_attention_wgmma_kernel<HD, ROUND>;
  const int sms = hopper::sm_count(device);
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  static bool smem_set[64] = {};  // the shared-memory limit, raised once per device
  if (!smem_set[device]) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
    if (e != cudaSuccess) return (int)e;
    smem_set[device] = true;
  }
  const long long items = (long long)w.pairs * B * Hkv;
  kernel<<<(unsigned)(items < sms ? items : sms), kWThreads, L::kSmem, stream>>>(tmQ, tmK, tmV, w);
  return (int)cudaGetLastError();
}

template <int HD, bool ROUND>
int launch_mma(const Args& a, long long BH, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<HD>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_mma_kernel<HD, ROUND>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long grid = BH * ((a.Sq + kMmaRows - 1) / kMmaRows);
  flash_attention_mma_kernel<HD, ROUND><<<(unsigned)grid, kMmaThreads, smem, stream>>>(a);
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

int dispatch_bf16(const Args& a, int hd, long long BH, long long B, bool round, int* sched, int device,
                  cudaStream_t stream) {
  if (!rows_aligned(a)) return (int)cudaErrorMisalignedAddress;
  switch (hd) {
    case 16: return round ? launch_mma<16, true>(a, BH, stream) : launch_mma<16, false>(a, BH, stream);
    case 32: return round ? launch_mma<32, true>(a, BH, stream) : launch_mma<32, false>(a, BH, stream);
    case 64:
      return round ? launch_wgmma<64, true>(a, B, sched, device, stream)
                   : launch_wgmma<64, false>(a, B, sched, device, stream);
    case 128:
      return round ? launch_wgmma<128, true>(a, B, sched, device, stream)
                   : launch_wgmma<128, false>(a, B, sched, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q, k, v, o are device pointers on
// `device` of one type (dtype 0: float32, 1: bfloat16, 16-byte aligned rows),
// addressed as [b, s, h, d] with the given element strides and d contiguous;
// B * H (batch, query head) pairs, H / G kv heads in k and v, sq query rows,
// sk keys, head dim hd in {16, 32, 64, 128}; round_scores rounds q . k to
// bf16 before the scale (bf16 only); sched two int32 that are 0, and stay 0
// after the launch (the bf16 Hopper kernel's work queue, hd 64 and 128; one
// pair per stream).  The caller has checked shapes
// and types.  Returns a CUDA error code: that of the tensor maps' encoding,
// else cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, long long B, int H,
    int G, int sq, int sk, int hd, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, int causal, int round_scores, int* sched, int device, void* stream) {
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
  if (dtype == 1) return dispatch_bf16(a, hd, BH, B, round_scores != 0, sched, device, s);
  return (int)cudaErrorInvalidValue;
}
