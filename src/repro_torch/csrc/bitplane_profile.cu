// K1: bit-plane popcount and zero-skip cycles, for Hopper (sm_90a).
//
// Replaces the Pallas kernel bitplane_profile_kernel
// (src/repro/kernels/bitplane_profile.py:37), which ran one TPU grid step per
// crossbar block over a (S, r) int32 tile.
//
// For every (block b, sample s) row of r quantized uint8 word-line inputs it
// counts the '1' bits of each of the 8 bit-planes (plane 0 = MSB, the
// np.unpackbits order) and folds them into the zero-skip cost
//     cycles = cycles_per_read * sum_p max(1, ceil(ones_p / rows_per_read)).
// In:  q (B, S, r) uint8, contiguous; rows past a block's true extent are
//      zero-padded by the caller.
// Out: ones (B, 8, S) int32 and cycles (B, S) int32, bit-identical to the
//      Pallas kernel.  The Pallas wrapper widened q to int32 first; this
//      kernel reads the bytes as they are.
//
// What bounds it: bytes.  It reads B*S*r bytes once and writes 36*B*S bytes
// (8 int32 counts and 1 int32 cycle count per row), and does about 6 integer
// operations per byte read, far below the card's arithmetic rate.  At the
// profiler's sample sizes (a megabyte or so per layer) a launch is too short
// to reach the memory rate, so it is launch-bound.
//
// Design (simple first): one warp per (b, s) row.  Each lane reads 4 bytes
// at a time as one uint32 and, for plane p, adds
// __popc(w & (0x01010101u << (7 - p))); the warp walks the row 128 bytes per
// step.  When r is not a multiple of 4 (or the base is not 4-byte aligned)
// the lanes assemble the word byte by byte with a masked tail instead.  The
// 8 counts are summed over the warp with __reduce_add_sync, and lane 0 writes
// them and the cycle count.  The kernel allocates nothing and does not
// synchronise; it runs on the caller's stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPlanes = 8;
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bitplane_profile_kernel(const uint8_t* __restrict__ q, int32_t* __restrict__ ones,
                        int32_t* __restrict__ cycles, long long n_rows, int S, int r,
                        int rows_per_read, int cycles_per_read) {
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // the same for every lane of a warp
  const uint8_t* src = q + row * (long long)r;
  const bool words = ((r & 3) == 0) && ((reinterpret_cast<uintptr_t>(q) & 3) == 0);

  unsigned cnt[kPlanes];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) cnt[p] = 0u;

  for (int base = 0; base < r; base += 128) {
    const int off = base + lane * 4;
    uint32_t w = 0u;
    if (words) {
      if (off < r) w = *reinterpret_cast<const uint32_t*>(src + off);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (off + k < r) w |= (uint32_t)src[off + k] << (8 * k);
    }
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) cnt[p] += __popc(w & (0x01010101u << (7 - p)));
  }

#pragma unroll
  for (int p = 0; p < kPlanes; ++p) cnt[p] = __reduce_add_sync(0xffffffffu, cnt[p]);

  if (lane == 0) {
    const long long b = row / S;
    const long long s = row - b * S;
    int total = 0;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      ones[(b * kPlanes + p) * S + s] = (int32_t)cnt[p];
      const int reads = ((int)cnt[p] + rows_per_read - 1) / rows_per_read;
      total += reads > 1 ? reads : 1;
    }
    cycles[row] = cycles_per_read * total;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Pointers are device pointers of
// contiguous tensors on `device`; `stream` is a cudaStream_t.  Returns
// cudaGetLastError() after the launch (0 when the launch was accepted).
extern "C" int bitplane_profile_launch(const void* q, void* ones, void* cycles, int B,
                                       int S, int r, int rows_per_read,
                                       int cycles_per_read, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n_rows = (long long)B * S;
  if (n_rows == 0) return 0;
  const long long grid = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bitplane_profile_kernel<<<(unsigned)grid, kWarpsPerBlock * 32, 0,
                            reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<int32_t*>(ones),
      static_cast<int32_t*>(cycles), n_rows, S, r, rows_per_read, cycles_per_read);
  return (int)cudaGetLastError();
}
