// The fabric's service-index draw, for Hopper (sm_90a).
//
// Replaces, on the card, the host's draw of the service-sample indices
// (fabric/vtime.py sample_service_indices: numpy's
// default_rng(seed).integers(0, S_l, (n, ppi_l)) layer after layer) and
// the copy of their int32 buffer to the card (upload_indices).  Its
// numbers are numpy's, bit for bit: the host's plan
// (kernels/service_draw.py draw_plan) gives each layer the PCG64 state
// numpy would start it from, and the kernel computes any draw of a layer
// from that state.  One launch a draw.
//
// The stream.  PCG64 steps a 128-bit state s <- s * MULT + inc and outputs
// rotr64(hi ^ lo, hi >> 58) of the stepped state.  numpy's integers takes
// 32-bit halves of the outputs, low half first; the first index of a layer
// may take a high half the generator kept from the layer before (the
// plan's buffered half).  For S a power of two Lemire's method never
// rejects, and the index is (half * S) >> 32 = half >> (32 - log2 S).  So
// output u of a layer (its indices b + 2u and b + 2u + 1, b = 1 after a
// buffered half) is the output of the state u + 1 steps after the layer's
// start, which a jump-ahead reaches in one 128-bit multiply-add a set bit
// of u + 1: 2^i steps take s to A_i * s + inc * G_i, with A_i and G_i from
// a table the wrapper uploads once a device.
//
// In:  a table of up to 64 layers, passed by value (no copy of it to the
//      card): each layer's mode (drawn, all zeros, or copied from the
//      host's part: a layer whose S is not a power of two, drawn by numpy),
//      its offset and count in the flat buffer, its first block, and for a
//      drawn layer its start state, log2 S and buffered half; the
//      generator's increment; the jump table; the host's part on the card.
// Out: the flat int32 buffer VT reads, every layer's (n, ppi_l) indices
//      ravelled and concatenated in layer order.
//
// Design.  A block of 256 threads takes 4,096 outputs of one layer (8,192
// indices); thread t of warp w starts at output u0 = 32 * 16 * w + t of
// its block's run, jumps there once (at most 64 multiply-adds, about 20
// for the cells' layers), then takes outputs u0, u0 + 32, ... 16 times,
// a jump of 32 steps (one multiply-add, as a single step costs) between
// them.  So a warp's stores of one step cover 256 contiguous bytes, and
// the 128-bit arithmetic (four 64-bit multiplies a step) is a few percent
// of the time the stores take.  A layer of S == 1 is written with zeros;
// a copied layer is read from the host's part (VT's ResNet18 cells: the
// five 7x7 layers, S = 49, 0.81% of the indices).
//
// What bounds it: the bytes written, 4 a index (and 4 read a copied
// index): 48.4 MB a fused-sweep call (two draws of 6.05 M indices),
// 14.5 MB a ResNet18 closed-loop query, 2.3 MB a VGG11 tail query; at
// 3.35 TB/s 14.4, 4.3 and 0.7 us.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxLayers = 64;
constexpr int kThreads = 256;
constexpr int kRun = 16;                   // outputs a thread, 32 apart
constexpr int kUnits = kThreads * kRun;    // outputs (index pairs) a block
constexpr int kDraw = 0, kCopy = 2;        // a layer's mode (1: all zeros)
constexpr int kBuffered = 16;              // on a drawn layer's mode: index 0 takes the buffered half

struct U128 {
  unsigned long long lo, hi;
};

// One layer, as kernels/service_draw.py's _Layer lays it out.
struct Layer {
  unsigned long long state_lo, state_hi;   // drawn: the start state; copied: state_lo is its offset in host
  long long offset, count;                 // its indices in the flat buffer
  int block0;                              // its first block
  int mode;                                // kDraw (+ kBuffered), 1 (all zeros) or kCopy
  int shift;                               // drawn: 32 - log2 S
  unsigned int half;                       // drawn and buffered: the buffered half
};
static_assert(sizeof(Layer) == 48, "Layer must match the wrapper's ctypes structure");

struct Params {
  U128 inc;
  int n_layers;
  Layer layer[kMaxLayers];
};
static_assert(sizeof(Params) <= 4000, "the layer table must fit in the kernel's 4 KB of parameters");

__device__ __forceinline__ U128 mul(U128 a, U128 b) {  // a * b mod 2^128
  U128 r;
  r.lo = a.lo * b.lo;
  r.hi = __umul64hi(a.lo, b.lo) + a.lo * b.hi + a.hi * b.lo;
  return r;
}

__device__ __forceinline__ U128 mad(U128 a, U128 s, U128 c) {  // a * s + c mod 2^128
  U128 r = mul(a, s);
  const unsigned long long lo = r.lo + c.lo;
  r.hi += c.hi + (lo < r.lo ? 1ull : 0ull);
  r.lo = lo;
  return r;
}

__device__ __forceinline__ unsigned long long output(U128 s) {  // XSL-RR
  const unsigned long long x = s.hi ^ s.lo;
  const unsigned rot = (unsigned)(s.hi >> 58);
  return (x >> rot) | (x << ((64u - rot) & 63u));
}

// jump: 64 pairs (A_i, G_i), pair i the jump of 2^i steps.
__global__ void __launch_bounds__(kThreads) service_draw_kernel(
    const __grid_constant__ Params p, const U128* __restrict__ jump, const int* __restrict__ host,
    int* __restrict__ out) {
  int l = 0;  // the last layer starting at or before this block (block0 does not decrease)
  for (int k = 1; k < p.n_layers; ++k)
    if (p.layer[k].block0 <= (int)blockIdx.x) l = k;
  const Layer& L = p.layer[l];
  const long long count = L.count;
  const int mode = L.mode & (kBuffered - 1);
  const int b = mode == kDraw && (L.mode & kBuffered) ? 1 : 0;
  const long long units = (count - b + 1) >> 1;
  long long u = (long long)(blockIdx.x - L.block0) * kUnits + (threadIdx.x >> 5) * (32 * kRun) + (threadIdx.x & 31);
  int* o = out + L.offset;
  if (mode == kDraw) {
    const unsigned shift = (unsigned)L.shift;
    if (b && u == 0) o[0] = (int)(L.half >> shift);
    if (u >= units) return;
    U128 s = {L.state_lo, L.state_hi};
    unsigned long long k = (unsigned long long)u + 1;
    for (int i = 0; k; ++i, k >>= 1)
      if (k & 1) s = mad(jump[2 * i], s, mul(p.inc, jump[2 * i + 1]));
    const U128 a32 = jump[10], c32 = mul(p.inc, jump[11]);  // 2^5 = 32 steps
#pragma unroll 4
    for (int r = 0; r < kRun && u < units; ++r, u += 32) {
      const unsigned long long x = output(s);
      const long long j = b + 2 * u;
      o[j] = (int)((unsigned)x >> shift);
      if (j + 1 < count) o[j + 1] = (int)((unsigned)(x >> 32) >> shift);
      s = mad(a32, s, c32);
    }
  } else {
    const int* src = host + (mode == kCopy ? (long long)L.state_lo : 0);
    for (int r = 0; r < kRun && u < units; ++r, u += 32) {
      const long long j = 2 * u;
      o[j] = mode == kCopy ? src[j] : 0;
      if (j + 1 < count) o[j + 1] = mode == kCopy ? src[j + 1] : 0;
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  `layers` is a host array of
// n_layers Layer (the wrapper has checked each: a drawn layer's S is a
// power of two from 2, block0 the blocks of the layers before it); `jump`,
// `host` (null when no layer is copied) and `out` are device pointers;
// `stream` a cudaStream_t on the current device.  Returns
// cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int service_draw_launch(const void* layers, int n_layers, int blocks, unsigned long long inc_lo,
                                   unsigned long long inc_hi, const void* jump, const void* host, void* out,
                                   void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || blocks < 0) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  Params p = {};
  p.inc.lo = inc_lo;
  p.inc.hi = inc_hi;
  p.n_layers = n_layers;
  memcpy(p.layer, layers, sizeof(Layer) * (size_t)n_layers);
  service_draw_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const U128*>(jump), static_cast<const int*>(host), static_cast<int*>(out));
  return (int)cudaGetLastError();
}
