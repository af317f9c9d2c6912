// K6 compact_positions — the exclusive prefix sum of an emit mask, the
// stable append behind enqueue, for sm_90a.
//
// Replaces: src/repro/kernels/compact/kernel.py, compact_positions (the
// Pallas kernel _compact_kernel).
//
// Computes, for every row b of a rank-stacked (B, n) bool mask:
//   pos[b, i]  = #{j < i : mask[b, j]}            ((B, n) int32)
//   total[b]   = #{j : mask[b, j]}                ((B,) int32)
//
// Bound on the H100: bytes (1 B of mask read, 4 B of position written per
// lane).  The arithmetic is one add per lane.  At (8, 1,048,576), VoPaT's
// enqueue, that is 41.9 MB: 0.0125 ms at 3.35 TB/s.
//
// Design: one launch, a single pass with a decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back";
// CUB's DeviceScan scheme).  The TPU kernel carried the running sum across
// sequential grid steps in SMEM; blocks here run in no order, and counting
// the tiles in one launch and scanning them in a second would read the mask
// twice.  Here:
//   - a block scans one tile of 8192 lanes (1,024 blocks at VoPaT's
//     (8, 1,048,576): one wave on 132 SMs): each warp owns 1024 contiguous
//     lanes as 8 groups of 128, and thread k takes lanes 4k..4k+3 of each
//     group, so a warp's mask load of a group is 128 contiguous bytes (one
//     4-byte load a thread where n % 4 == 0, bytes otherwise) and its store
//     of the group's positions 512 contiguous bytes (one int4 a thread);
//   - each thread turns its mask bytes into 0/1 and counts each group with
//     __dp4a; the 8 counts, packed one byte each into two words, take two
//     warp scans (a byte sums at most 128), and one pass over the 8 warp
//     totals in shared memory gives each warp its base and the tile's sum;
//   - the tile's prefix comes from the decoupled look-back of
//     csrc/lookback.cuh over one 64-bit status word a (row, tile), run by
//     warp 0;
//   - the last tile of a row writes total[b], so no output needs a fill.
// The tile index is blockIdx.x and the row blockIdx.y, so a tile waits
// only on blocks with lower linear indices.  The status words are scratch
// the caller keeps per device (shared with K4); when the caller passes
// epoch 1 (a new scratch, or the epoch counter wrapped), the words are
// cleared first with one cudaMemsetAsync.
// It is a scan, not an atomic append: a lane's position depends only on
// the lanes before it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 8;                                  // 4-lane groups a thread
constexpr int kWarpLanes = 32 * 4 * kGroups;                // 1024 lanes a warp
constexpr int64_t kTile = (int64_t)kWarps * kWarpLanes;     // 8192 lanes a block
constexpr unsigned kFull = 0xffffffffu;

// 0x00 stays 0, any other byte becomes 1
__device__ __forceinline__ uint32_t bytes_to_bits(uint32_t x) {
  return ((((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u) >> 7;
}

__device__ __forceinline__ unsigned warp_inclusive_sum(unsigned x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Lane i of a tile: warp w = i / 1024, group q = (i / 128) % 8, thread k =
// (i / 4) % 32 of the warp, byte i % 4 of the thread's 4-lane group.
__global__ void __launch_bounds__(kThreads) compact_kernel(
    const uint8_t* __restrict__ mask, int32_t* __restrict__ pos, int32_t* __restrict__ total,
    unsigned long long* __restrict__ status, int64_t n, uint32_t n_tiles, uint32_t epoch,
    bool vec_load, bool vec_store) {
  __shared__ int warp_sums[kWarps];
  __shared__ int tile_prefix;
  const int64_t b = blockIdx.y;
  const uint32_t t = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t first = (int64_t)t * kTile + (int64_t)warp * kWarpLanes + 4 * lane;
  const uint8_t* m_row = mask + b * n;
  int32_t* p_row = pos + b * n;

  // the thread's 8 groups of 4 lanes, one 0/1 byte a lane; packed[h] holds
  // the counts (0..4) of groups 4h..4h+3, one byte each
  uint32_t bits[kGroups];
  unsigned packed[kGroups / 4] = {};
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    const int64_t i = first + 128 * q;
    uint32_t m = 0u;
    if (vec_load) {
      if (i < n) m = __ldg(reinterpret_cast<const unsigned*>(m_row + i));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i + k < n) m |= (uint32_t)m_row[i + k] << (8 * k);
    }
    bits[q] = bytes_to_bits(m);
    packed[q >> 2] += __dp4a(bits[q], 0x01010101u, 0u) << (8 * (q & 3));
  }

  // warp scans of the packed counts (a field sums at most 32 x 4 = 128)
  unsigned incl[kGroups / 4], wtot[kGroups / 4];
#pragma unroll
  for (int h = 0; h < kGroups / 4; ++h) {
    incl[h] = warp_inclusive_sum(packed[h], lane);
    wtot[h] = __shfl_sync(kFull, incl[h], 31);
  }
  int warp_total = 0;
#pragma unroll
  for (int q = 0; q < kGroups; ++q) warp_total += (int)((wtot[q >> 2] >> (8 * (q & 3))) & 0xffu);
  if (lane == 0) warp_sums[warp] = warp_total;
  __syncthreads();
  int before = 0, agg = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int s = warp_sums[k];
    before += k < warp ? s : 0;
    agg += s;
  }

  // the tile's prefix: decoupled look-back by warp 0
  if (warp == 0) {
    unsigned long long* st_row = status + b * (int64_t)n_tiles;
    if (lane == 0) lookback::publish_aggregate(st_row, t, agg, epoch);
    const int prefix = lookback::exclusive_prefix(st_row, t, agg, epoch, lane);
    if (lane == 0) tile_prefix = prefix;
  }
  __syncthreads();

  if (t == n_tiles - 1 && threadIdx.x == 0) total[b] = tile_prefix + agg;
  // a warp's store of group q covers 512 contiguous bytes
  int group_base = tile_prefix + before;
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    const int shift = 8 * (q & 3);
    const int own = (int)((packed[q >> 2] >> shift) & 0xffu);
    int run = group_base + (int)((incl[q >> 2] >> shift) & 0xffu) - own;
    group_base += (int)((wtot[q >> 2] >> shift) & 0xffu);
    int4 v;
    v.x = run; run += (int)(bits[q] & 1u);
    v.y = run; run += (int)((bits[q] >> 8) & 1u);
    v.z = run; run += (int)((bits[q] >> 16) & 1u);
    v.w = run;
    const int64_t i = first + 128 * q;
    if (vec_store && i + 4 <= n) {
      *reinterpret_cast<int4*>(p_row + i) = v;
    } else {
      if (i < n) p_row[i] = v.x;
      if (i + 1 < n) p_row[i + 1] = v.y;
      if (i + 2 < n) p_row[i + 2] = v.z;
      if (i + 3 < n) p_row[i + 3] = v.w;
    }
  }
}

}  // namespace

// mask (B, n) bool, pos (B, n) int32, total (B,) int32, both written in
// full; status: status_words 64-bit words of scratch kept by the caller,
// at least B * ceil(n / 8192); epoch in [1, 2^30), a new one each call on
// this scratch, 1 clearing the scratch first.  n < 2^31.
extern "C" int rafi_compact_positions(const void* mask, void* pos, void* total,
                                      void* status, int64_t status_words, int64_t rows,
                                      int64_t n, int64_t epoch, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  if (epoch < 1 || epoch >= (1 << 30) || status_words < rows * n_tiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (epoch == 1) {
    const cudaError_t rc = cudaMemsetAsync(status, 0, status_words * sizeof(unsigned long long), s);
    if (rc != cudaSuccess) return (int)rc;
  }
  const bool vec_load = n % 4 == 0 && (uintptr_t)mask % 4 == 0;
  const bool vec_store = n % 4 == 0 && (uintptr_t)pos % 16 == 0;
  compact_kernel<<<dim3((unsigned)n_tiles, (unsigned)rows), kThreads, 0, s>>>(
      (const uint8_t*)mask, (int32_t*)pos, (int32_t*)total, (unsigned long long*)status, n,
      (uint32_t)n_tiles, (uint32_t)epoch, vec_load, vec_store);
  return (int)cudaGetLastError();
}
