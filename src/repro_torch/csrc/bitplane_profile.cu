// K1: bit-plane popcount and zero-skip cycles, for Hopper (sm_90a), one
// grouped launch for every layer of a derive.
//
// Replaces the Pallas kernel bitplane_profile_kernel
// (src/repro/kernels/bitplane_profile.py:37), which ran one TPU grid step per
// crossbar block over a zero-padded (S, r) int32 tile.
//
// For every (sample s, block b) row of quantized uint8 word-line inputs it
// counts the '1' bits of each of the 8 bit-planes (plane 0 = MSB, the
// np.unpackbits order) and folds them into the zero-skip cost
//     cycles = cycles_per_read * sum_p max(1, ceil(ones_p / rows_per_read)).
//
// The problem is a table of entries, one per layer (kernels/bitplane_profile.py
// builds it).  An entry is a uint8 matrix read in place: block b of sample s
// holds the bytes q + s*stride_s + b*stride_b + [0, nb), nb = min(block_rows,
// rows - b*block_rows).  A layer's (S, rows) sampled_q has stride_s = rows
// and stride_b = block_rows, so its last block may be short; the bytes it
// lacks count 0 ones and every plane still costs the 1-read floor, exactly
// as the Pallas kernel's zero-padded block.  The (B, S, r) block entry is the
// one-entry case with stride_s = r, stride_b = S*r and rows = B*r.
// Out: cycles at out_off + s*cs_s + b*cs_b, int64 for the derive (each
// layer's (S, B) after the last) or int32 for the block entry ((B, S)); the
// per-plane counts at ones + (b*8 + p)*S + s (the Pallas (B, 8, S) layout,
// for the one-entry block case) only when the caller passes a ones buffer.
//
// What bounds it: bytes, at the profiler's sample sizes.  It reads each input
// byte once and writes 8 (or 4) bytes per row.  The first design (one POPC
// per plane per 4-byte word, 2 per byte) was bound by the card's 16 POPC a
// clock an SM instead; this one reduces a row's words first with a
// carry-save (Harley-Seal) adder tree of LOP3 full adders: counters of
// weight 1, 2, 4, 8 and, every 16 words, a "sixteens" word.  Bit j of a
// counter word belongs to plane 7 - (j mod 8), so
//     ones_p = sum_k 2^k popc(c_k & (0x01010101 << (7 - p))),
// 48 POPC and about 110 LOP3 for a 128-byte row (0.375 POPC a byte, from
// cuobjdump -sass), against 256 POPC before.
//
// Design: one thread owns one (sample, block) row, so no lane reduces with
// another.  A block of 128 threads takes a work item, (entry, block, 128
// samples), stages its rows through shared memory and costs them.  Each
// staged row is padded to an odd number of 16-byte units so that threads
// reading their own rows 16 bytes at a time do not conflict on banks.
// Neighbouring samples' rows lie stride_s bytes apart in device memory; the
// copy walks (row, 16-byte unit) pairs in order, with 16-byte cp.async where
// the entry is 16-byte aligned (every layer whose row count is a multiple of
// 16).  Otherwise (ResNet18's conv1, 147 rows) it copies the 4-byte words
// that cover each row's segment with 4-byte cp.async, and the row's own
// thread shifts them into place (a funnel shift a word) and zeroes the
// bytes past the block's end.  The grid is persistent: as many blocks as
// fit on the card at once (no more than there are items), block k taking
// items k, k + grid, ...; each copies the table into shared memory once,
// finds an item's entry there by binary search, and copies the next item's
// tile into a second buffer while it costs the current one, so a block's
// copies overlap its own arithmetic.  The ceil division by rows_per_read is
// a multiply-high by a reciprocal (exact for n * d < 2^32; the wrapper
// bounds both).  One launch covers every item of every entry: one launch
// per derive.  The kernel allocates nothing and does not synchronise; it
// runs on the caller's stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPlanes = 8;
constexpr int kThreads = 128;  // samples per work item: a thread owns a row

// one entry of the problem table, 16 int64 (kernels/bitplane_profile.py
// writes the same order)
struct Entry {
  long long q;          // device address of the entry's bytes
  long long S;          // samples
  long long rows;       // bytes per sample over all blocks (the last may be short)
  long long br;         // block rows
  long long stride_s;   // bytes between samples
  long long stride_b;   // bytes between blocks
  long long out_off;    // first cycle of the entry in the output
  long long cs_s;       // cycles' stride between samples
  long long cs_b;       // cycles' stride between blocks
  long long item_start; // first work item of the entry
  long long tiles;      // ceil(S / kThreads)
  long long aligned;    // q, stride_s, stride_b, rows and br are multiples of 16
  long long pad[4];
};
static_assert(sizeof(Entry) == 16 * 8, "table rows are 16 int64");

__device__ __forceinline__ uint32_t xor3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t maj3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xE8;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// full adder on 32 one-bit lanes: (l, a, b) -> l = sum bit, returns carry
__device__ __forceinline__ uint32_t csa(uint32_t& l, uint32_t a, uint32_t b) {
  const uint32_t h = maj3(l, a, b);
  l = xor3(l, a, b);
  return h;
}

__device__ __forceinline__ void add_planes(uint32_t (&acc)[kPlanes], uint32_t w) {
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) acc[p] += __popc(w & (0x01010101u << (7 - p)));
}

// floor(n / d) for n * d < 2^32, by the reciprocal m = ceil(2^32 / d), d >= 2
__device__ __forceinline__ uint32_t div_by(uint32_t n, uint32_t d, uint32_t m) {
  return d == 1u ? n : __umulhi(n, m);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// one work item, decoded from the table in shared memory
struct Item {
  const uint8_t* src;  // the tile's first byte: sample s0, block b
  long long stride_s;
  long long s0, b;
  int e, ns, nb, units;
  bool aligned;
};

// the largest entry whose first item is at most `item` owns it (an entry
// without items starts where the next one does, so it never owns one)
__device__ __forceinline__ Item decode(const Entry* tab, int n_entries, long long item) {
  int lo = 0, hi = n_entries - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab[mid].item_start <= item) lo = mid; else hi = mid - 1;
  }
  const Entry& en = tab[lo];
  const int local = (int)(item - en.item_start);
  const int tiles = (int)en.tiles;
  Item it;
  it.e = lo;
  it.b = local / tiles;
  it.s0 = (long long)(local - (int)it.b * tiles) * kThreads;
  it.ns = (int)min((long long)kThreads, en.S - it.s0);
  it.nb = (int)min(en.br, en.rows - it.b * en.br);  // this block's bytes a row
  it.units = (it.nb + 15) >> 4;                      // 16-byte units a row
  it.stride_s = en.stride_s;
  it.src = reinterpret_cast<const uint8_t*>(en.q) + it.s0 * en.stride_s + it.b * en.stride_b;
  it.aligned = en.aligned != 0;
  return it;
}

// starts the cp.async copies of an item's (ns x nb) tile into `tile`:
// (row, unit) pairs in order, so a warp reads whole row segments
__device__ __forceinline__ void stage(const Item& it, uint8_t* tile, int row_pitch) {
  if (it.aligned) {
    const uint32_t m = 0xFFFFFFFFu / (uint32_t)it.units + 1u;  // exact for id * units < 2^32
    for (int id = threadIdx.x; id < it.ns * it.units; id += kThreads) {
      const int r = (int)div_by((uint32_t)id, (uint32_t)it.units, m);
      const int u = id - r * it.units;
      cp_async16(tile + r * row_pitch + 16 * u, it.src + r * it.stride_s + 16 * u);
    }
  } else {
    // a row's segment starts at any byte: copy the 4-byte words that cover
    // it (they lie in the 4-byte granules the segment touches), at most
    // 4 * units + 1 of them, to the row's start; the row's own thread
    // shifts them into place before costing it
    const int words = 4 * it.units + 1;
    const uint32_t m = 0xFFFFFFFFu / (uint32_t)words + 1u;  // words >= 5
    for (int id = threadIdx.x; id < it.ns * words; id += kThreads) {
      const int r = (int)__umulhi((uint32_t)id, m);
      const int k = id - r * words;
      const uint8_t* seg = it.src + r * it.stride_s;
      const int off = (int)(reinterpret_cast<uintptr_t>(seg) & 3);
      if (4 * k < off + it.nb) cp_async4(tile + r * row_pitch + 4 * k, seg - off + 4 * k);
    }
  }
}

// this thread's row of a staged item: popcounts, zero-skip cost, stores
template <typename Cyc>
__device__ __forceinline__ void cost_row(const Item& it, const Entry& en, uint8_t* tile, int row_pitch,
                                         Cyc* __restrict__ cycles, int32_t* __restrict__ ones,
                                         uint32_t rpr, uint32_t rpr_m, int cycles_per_read) {
  const int t = threadIdx.x;
  if (t >= it.ns) return;
  const int units = it.units;
  if (!it.aligned) {
    // in place, word by word from the front: word j of the row is bytes
    // off + 4j .. off + 4j + 3 of the copied words, and bytes past nb are 0
    uint32_t* w = reinterpret_cast<uint32_t*>(tile + t * row_pitch);
    const int shift = 8 * (int)(reinterpret_cast<uintptr_t>(it.src + t * it.stride_s) & 3);
    for (int j = 0; j < 4 * units; ++j) {
      const uint32_t v = __funnelshift_r(w[j], w[j + 1], shift);
      const int left = it.nb - 4 * j;
      w[j] = left >= 4 ? v : left <= 0 ? 0u : v & (0xFFFFFFFFu >> (32 - 8 * left));
    }
  }

  // the row's words through a carry-save adder tree
  const uint4* row = reinterpret_cast<const uint4*>(tile + t * row_pitch);
  uint32_t c1 = 0u, c2 = 0u, c4 = 0u, c8 = 0u;
  uint32_t hi[kPlanes];  // weight-16 counts per plane
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) hi[p] = 0u;
  int i = 0;
  for (; i + 4 <= units; i += 4) {  // 16 words
    uint32_t fours[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 a = row[i + 2 * h];
      const uint4 z = row[i + 2 * h + 1];
      const uint32_t twosA = csa(c1, a.x, a.y);
      const uint32_t twosB = csa(c1, a.z, a.w);
      const uint32_t foursA = csa(c2, twosA, twosB);
      const uint32_t twosC = csa(c1, z.x, z.y);
      const uint32_t twosD = csa(c1, z.z, z.w);
      const uint32_t foursB = csa(c2, twosC, twosD);
      fours[h] = csa(c4, foursA, foursB);  // an eights word
    }
    add_planes(hi, csa(c8, fours[0], fours[1]));
  }
  for (; i < units; ++i) {  // the last 1 to 3 units: half adders up the chain
    const uint4 a = row[i];
    const uint32_t twosA = csa(c1, a.x, a.y);
    const uint32_t twosB = csa(c1, a.z, a.w);
    const uint32_t fours = csa(c2, twosA, twosB);
    const uint32_t eights = c4 & fours;
    c4 ^= fours;
    const uint32_t sixteens = c8 & eights;
    c8 ^= eights;
    add_planes(hi, sixteens);
  }

  // per-plane counts and the zero-skip cost
  const long long s = it.s0 + t;
  int total = 0;
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    const uint32_t mask = 0x01010101u << (7 - p);
    const uint32_t n = 16u * hi[p] + 8u * __popc(c8 & mask) + 4u * __popc(c4 & mask) +
                       2u * __popc(c2 & mask) + (uint32_t)__popc(c1 & mask);
    if (ones != nullptr) ones[(it.b * kPlanes + p) * en.S + s] = (int32_t)n;
    const uint32_t reads = div_by(n + rpr - 1u, rpr, rpr_m);
    total += reads > 1u ? (int)reads : 1;
  }
  cycles[en.out_off + s * en.cs_s + it.b * en.cs_b] = (Cyc)(cycles_per_read * total);
}

// persistent: block k takes items k, k + grid, k + 2 grid, ...; the table is
// copied to shared memory once, and each item's tile is copied while the
// previous one is costed (two buffers)
template <typename Cyc>
__global__ void __launch_bounds__(kThreads)
bitplane_grouped_kernel(const Entry* __restrict__ table, int n_entries, long long n_items,
                        Cyc* __restrict__ cycles, int32_t* __restrict__ ones, int row_pitch,
                        int rows_per_read, int cycles_per_read) {
  extern __shared__ __align__(16) uint8_t smem[];  // the table, then two tiles of kThreads rows
  Entry* tab = reinterpret_cast<Entry*>(smem);
  uint8_t* bufs = smem + (size_t)n_entries * sizeof(Entry);
  const int buf_bytes = kThreads * row_pitch;
  {
    const long long* g = reinterpret_cast<const long long*>(table);
    long long* d = reinterpret_cast<long long*>(tab);
    for (int k = threadIdx.x; k < n_entries * 16; k += kThreads) d[k] = g[k];
  }
  __syncthreads();
  const uint32_t rpr = (uint32_t)rows_per_read;
  const uint32_t rpr_m = 0xFFFFFFFFu / rpr + 1u;

  long long item = blockIdx.x;
  Item cur = decode(tab, n_entries, item);
  stage(cur, bufs, row_pitch);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int which = 0;; which ^= 1) {
    const long long next = item + gridDim.x;
    const bool more = next < n_items;
    Item nxt;
    if (more) {
      nxt = decode(tab, n_entries, next);
      stage(nxt, bufs + (which ^ 1) * buf_bytes, row_pitch);
    }
    // the current tile's copies are the older of at most two groups
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    cost_row(cur, tab[cur.e], bufs + which * buf_bytes, row_pitch, cycles, ones, rpr, rpr_m,
             cycles_per_read);
    if (!more) break;
    __syncthreads();  // every row of this buffer is read before it is refilled
    cur = nxt;
    item = next;
  }
}

// blocks a launch takes: every SM full at this shared memory, no more blocks
// than items; the occupancy is asked once per (device, shared memory size),
// and the kernel's shared-memory limit only ever raised
template <typename Cyc>
int grid_for(int device, size_t smem, long long n_items, int* grid) {
  struct Seen { int device; size_t smem; int blocks; };
  static Seen seen[32];
  static int n_seen = 0;
  static size_t smem_limit[64] = {};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > smem_limit[device]) {
    cudaError_t err = cudaFuncSetAttribute(bitplane_grouped_kernel<Cyc>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_limit[device] = smem;
  }
  int blocks = 0;
  for (int k = 0; k < n_seen; ++k)
    if (seen[k].device == device && seen[k].smem == smem) blocks = seen[k].blocks;
  if (blocks == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bitplane_grouped_kernel<Cyc>, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    blocks = per_sm * sms;
    if (n_seen < 32) seen[n_seen++] = Seen{device, smem, blocks};
  }
  *grid = (int)min((long long)blocks, n_items);
  return 0;
}

template <typename Cyc>
int launch(const void* table, int n_entries, long long n_items, void* cycles, void* ones, int row_pitch,
           int rows_per_read, int cycles_per_read, int device, cudaStream_t stream) {
  const size_t smem = (size_t)n_entries * sizeof(Entry) + 2 * (size_t)kThreads * row_pitch;
  int grid = 0;
  const int rc = grid_for<Cyc>(device, smem, n_items, &grid);
  if (rc != 0) return rc;
  bitplane_grouped_kernel<Cyc><<<grid, kThreads, smem, stream>>>(
      static_cast<const Entry*>(table), n_entries, n_items, static_cast<Cyc*>(cycles),
      static_cast<int32_t*>(ones), row_pitch, rows_per_read, cycles_per_read);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  `table` is a device array of
// n_entries rows of 16 int64 (the Entry fields above); `cycles` is int64
// when `wide` is non-zero, else int32; `ones` may be null.  `row_pitch` is
// the shared-memory bytes a staged row takes: a multiple of 16, an odd
// number of 16-byte units, more than every entry's block rows.  Returns
// cudaGetLastError() after the launch (0 when the launch was accepted), or
// the error of the occupancy query that sized the grid.
extern "C" int bitplane_grouped_launch(const void* table, int n_entries, long long n_items, void* cycles,
                                       int wide, void* ones, int row_pitch, int rows_per_read,
                                       int cycles_per_read, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_items == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return wide ? launch<long long>(table, n_entries, n_items, cycles, ones, row_pitch, rows_per_read,
                                  cycles_per_read, device, st)
              : launch<int32_t>(table, n_entries, n_items, cycles, ones, row_pitch, rows_per_read,
                                cycles_per_read, device, st);
}
