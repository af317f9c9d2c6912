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
// lane).  The arithmetic is one add per lane.
//
// Design: a tile scan in two launches over a (tile, row) grid.  The TPU
// kernel carried the running sum across sequential grid steps in SMEM;
// blocks here run in no order, so
//   1. tile_count: each block counts its tile of 4096 lanes
//      (__syncthreads_count over 16 strided passes) into tile_sums[b, t];
//   2. tile_scan: each block sums the counts of the tiles before its own
//      (at most n / 4096 reads), then scans its tile in 16 passes of 256
//      lanes: a warp scan with __shfl_up_sync, the eight warp totals
//      scanned by warp 0, and a running sum carried from pass to pass.
//      The block of the last tile writes total[b].
// Lane k*256 + tid of a tile is handled by thread tid in pass k, so every
// load and store of a warp is coalesced.  It is a scan, not an atomic
// append: a lane's position depends only on the lanes before it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPasses = 16;
constexpr int64_t kTile = (int64_t)kThreads * kPasses;  // 4096 lanes
constexpr unsigned kFull = 0xffffffffu;

__global__ void tile_count_kernel(const uint8_t* __restrict__ mask,
                                  int32_t* __restrict__ tile_sums, int64_t n,
                                  int64_t n_tiles) {
  const int64_t b = blockIdx.y;
  const int64_t lo = (int64_t)blockIdx.x * kTile;
  const uint8_t* m_row = mask + b * n;
  int total = 0;
  for (int k = 0; k < kPasses; ++k) {
    const int64_t i = lo + k * kThreads + threadIdx.x;
    total += __syncthreads_count(i < n && m_row[i] != 0);
  }
  if (threadIdx.x == 0) tile_sums[b * n_tiles + blockIdx.x] = total;
}

// Exclusive scan of one value per thread across the block; *block_total
// receives the sum over the block.  Uses and releases warp_sums.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* block_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *block_total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}

__global__ void tile_scan_kernel(const uint8_t* __restrict__ mask,
                                 const int32_t* __restrict__ tile_sums,
                                 int32_t* __restrict__ pos,
                                 int32_t* __restrict__ total, int64_t n,
                                 int64_t n_tiles) {
  __shared__ int warp_sums[kWarps];
  const int64_t b = blockIdx.y;
  const int64_t t = blockIdx.x;
  // base of this tile: the counts of every tile before it
  int partial = 0;
  for (int64_t u = threadIdx.x; u < t; u += kThreads) partial += tile_sums[b * n_tiles + u];
  int base;
  block_exclusive_scan(partial, warp_sums, &base);

  const int64_t lo = t * kTile;
  const uint8_t* m_row = mask + b * n;
  int32_t* p_row = pos + b * n;
  int running = base;
  for (int k = 0; k < kPasses; ++k) {
    const int64_t i = lo + k * kThreads + threadIdx.x;
    const int v = (i < n && m_row[i] != 0) ? 1 : 0;
    int pass_total;
    const int excl = block_exclusive_scan(v, warp_sums, &pass_total);
    if (i < n) p_row[i] = running + excl;
    running += pass_total;
  }
  if (t == n_tiles - 1 && threadIdx.x == 0) total[b] = running;
}

}  // namespace

// mask (B, n) bool, pos (B, n) int32, total (B,) int32 (zeroed by the
// caller), tile_sums (B, ceil(n / 4096)) int32 scratch.  n < 2^31.
// Returns cudaGetLastError() after the two launches.
extern "C" int rafi_compact_positions(const void* mask, void* pos, void* total,
                                      void* tile_sums, int64_t rows, int64_t n,
                                      void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  const dim3 grid((unsigned)n_tiles, (unsigned)rows);
  cudaStream_t s = (cudaStream_t)stream;
  tile_count_kernel<<<grid, kThreads, 0, s>>>((const uint8_t*)mask,
                                              (int32_t*)tile_sums, n, n_tiles);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  tile_scan_kernel<<<grid, kThreads, 0, s>>>(
      (const uint8_t*)mask, (const int32_t*)tile_sums, (int32_t*)pos,
      (int32_t*)total, n, n_tiles);
  return (int)cudaGetLastError();
}
