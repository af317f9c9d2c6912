// K4 rank_and_histogram and K5 scatter_rows — the sort-free bucket-scatter
// marshal, for sm_90a.
//
// Replaces: src/repro/kernels/bucket_scatter/kernel.py, rank_and_histogram
// (the Pallas kernel _rank_hist_kernel) and scatter_rows
// (_scatter_rows_kernel).
//
// K4, for every row b of a rank-stacked (B, C) destination array and its
// (B,) count vector:
//   d_clean[b, i] = (i < count[b] && 0 <= dest < R) ? dest : R
//   rank[b, i]    = #{j < i : d_clean[b, j] == d_clean[b, i]}
//   hist[b, d]    = #{i : d_clean[b, i] == d}            ((B, R+1) int32)
// so that base[d_clean] + rank is the stable sort's placement.
// K5: out[b, dstpos[b, i], :] = src[b, i, :] over (B, N, W) 32-bit words;
//   rows whose position is negative or >= num_slots are dropped.  The caller
//   zero-fills out, so unclaimed slots are zero.  Valid positions are
//   distinct, so no two writes meet.
//
// Bound on the H100: bytes.  K4 reads 4 B of dest and writes 8 B (d_clean,
// rank) per lane; K5 reads each row that lands and writes the whole output
// (its zero-fill included).  The arithmetic is index math.
//
// Design of K4.  The TPU kernel counted through float32 MXU prefix matmuls
// (exact below 2^24) and carried a running histogram across sequential
// grid steps.  Blocks here run in no order, and counts are int32, so:
//   1. tile_hist: one warp per tile of 1024 lanes writes d_clean and
//      histograms the tile into shared-memory bins (integer atomics,
//      deterministic sums) -> tile_hist[b, t, :];
//   2. tile_base: one warp per (row, bucket) turns the column
//      tile_hist[b, :, d] into its exclusive prefix over tiles (warp scan
//      with __shfl_up_sync, 32 tiles per step) and writes hist[b, d];
//   3. tile_rank: one warp per tile starts from its tile's bucket bases in
//      shared memory and walks its 1024 lanes 32 at a time, in lane order:
//      __match_any_sync groups the lanes of one bucket, a lane's rank is the
//      base plus the popcount of its group's earlier lanes, and the group's
//      leader then advances the base.  No atomic decides a rank, so ranks
//      are the stable lane-order ranks.
// Design of K5: one thread per 32-bit word of src, grid-stride over a
// (word tile, rank) grid, 32-bit index math inside a rank (as K1).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileIters = 32;
constexpr int64_t kTile = 32 * kTileIters;  // lanes per warp tile
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksPerRank = 2048;

__global__ void tile_hist_kernel(const int32_t* __restrict__ dest,
                                 const int32_t* __restrict__ count,
                                 int32_t* __restrict__ d_clean,
                                 int32_t* __restrict__ tile_hist, int64_t cap,
                                 int64_t n_tiles, int num_ranks) {
  extern __shared__ int32_t bins[];  // num_ranks + 1
  const int64_t b = blockIdx.y, t = blockIdx.x;
  for (int i = threadIdx.x; i <= num_ranks; i += 32) bins[i] = 0;
  __syncwarp();
  const int64_t cnt = count[b];
  const int64_t lo = t * kTile;
  for (int k = 0; k < kTileIters; ++k) {
    const int64_t lane = lo + k * 32 + threadIdx.x;
    if (lane < cap) {
      const int32_t d = dest[b * cap + lane];
      const int32_t dc = (lane < cnt && d >= 0 && d < num_ranks) ? d : num_ranks;
      d_clean[b * cap + lane] = dc;
      atomicAdd(&bins[dc], 1);
    }
  }
  __syncwarp();
  int32_t* row = tile_hist + (b * n_tiles + t) * (num_ranks + 1);
  for (int i = threadIdx.x; i <= num_ranks; i += 32) row[i] = bins[i];
}

// blockIdx.x = bucket d, blockIdx.y = row b; one warp
__global__ void tile_base_kernel(int32_t* __restrict__ tile_hist,
                                 int32_t* __restrict__ hist, int64_t n_tiles,
                                 int num_ranks) {
  const int64_t b = blockIdx.y, d = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t stride = num_ranks + 1;
  int32_t* col = tile_hist + b * n_tiles * stride + d;
  int running = 0;
  for (int64_t t0 = 0; t0 < n_tiles; t0 += 32) {
    const int64_t t = t0 + lane;
    const int v = t < n_tiles ? col[t * stride] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (t < n_tiles) col[t * stride] = running + x - v;
    running += __shfl_sync(kFull, x, 31);
  }
  if (lane == 0) hist[b * stride + d] = running;
}

__global__ void tile_rank_kernel(const int32_t* __restrict__ d_clean,
                                 const int32_t* __restrict__ tile_base,
                                 int32_t* __restrict__ rank, int64_t cap,
                                 int64_t n_tiles, int num_ranks) {
  extern __shared__ int32_t base[];  // num_ranks + 1
  const int64_t b = blockIdx.y, t = blockIdx.x;
  const int lane_id = threadIdx.x;
  const int32_t* src = tile_base + (b * n_tiles + t) * (num_ranks + 1);
  for (int i = lane_id; i <= num_ranks; i += 32) base[i] = src[i];
  __syncwarp();
  const unsigned earlier = (1u << lane_id) - 1u;
  const int64_t lo = t * kTile;
  for (int k = 0; k < kTileIters; ++k) {
    const int64_t lane = lo + k * 32 + lane_id;
    const int32_t d = lane < cap ? d_clean[b * cap + lane] : -1;
    const unsigned group = __match_any_sync(kFull, d);
    const int r = d >= 0 ? base[d] + __popc(group & earlier) : 0;
    __syncwarp();  // every lane has read base[d] before a leader moves it
    if (d >= 0 && (__ffs(group) - 1) == lane_id) base[d] += __popc(group);
    __syncwarp();
    if (lane < cap) rank[b * cap + lane] = r;
  }
}

__global__ void scatter_rows_kernel(const int32_t* __restrict__ src,
                                    const int32_t* __restrict__ dstpos,
                                    int32_t* __restrict__ out, uint32_t n,
                                    uint32_t w, uint32_t num_slots) {
  const int64_t b = blockIdx.y;
  const int32_t* src_b = src + b * (int64_t)n * w;
  const int32_t* pos_b = dstpos + b * (int64_t)n;
  int32_t* out_b = out + b * (int64_t)num_slots * w;
  const uint32_t total = n * w;
  for (uint32_t e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const uint32_t i = e / w;
    const uint32_t col = e - i * w;
    const int32_t p = pos_b[i];
    if (p >= 0 && (uint32_t)p < num_slots) out_b[(int64_t)p * w + col] = src_b[e];
  }
}

}  // namespace

// dest (B, C), count (B,) int32 -> d_clean (B, C), rank (B, C),
// hist (B, R+1) int32; tile_hist (B, ceil(C / 1024), R+1) int32 scratch.
// C < 2^31, R + 1 <= 12288.  Returns cudaGetLastError() after the three
// launches.
extern "C" int rafi_rank_and_histogram(const void* dest, const void* count,
                                       void* d_clean, void* rank, void* hist,
                                       void* tile_hist, int64_t rows,
                                       int64_t cap, int64_t num_ranks,
                                       void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n_tiles = cap > 0 ? (cap + kTile - 1) / kTile : 1;
  const size_t smem = (size_t)(num_ranks + 1) * sizeof(int32_t);
  const int r = (int)num_ranks;
  int rc;
  if (cap > 0) {
    tile_hist_kernel<<<dim3((unsigned)n_tiles, (unsigned)rows), 32, smem, s>>>(
        (const int32_t*)dest, (const int32_t*)count, (int32_t*)d_clean,
        (int32_t*)tile_hist, cap, n_tiles, r);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
  } else {
    cudaMemsetAsync(tile_hist, 0, (size_t)rows * (num_ranks + 1) * sizeof(int32_t), s);
  }
  tile_base_kernel<<<dim3((unsigned)(num_ranks + 1), (unsigned)rows), 32, 0, s>>>(
      (int32_t*)tile_hist, (int32_t*)hist, n_tiles, r);
  if ((rc = (int)cudaGetLastError()) != 0 || cap == 0) return rc;
  tile_rank_kernel<<<dim3((unsigned)n_tiles, (unsigned)rows), 32, smem, s>>>(
      (const int32_t*)d_clean, (const int32_t*)tile_hist, (int32_t*)rank, cap,
      n_tiles, r);
  return (int)cudaGetLastError();
}

// src (B, N, W), dstpos (B, N) int32 -> out (B, num_slots, W), zero-filled
// by the caller; N*W and num_slots*W < 2^31.
extern "C" int rafi_scatter_rows(const void* src, const void* dstpos, void* out,
                                 int64_t rows, int64_t n, int64_t w,
                                 int64_t num_slots, void* stream) {
  if (rows > 0 && n * w > 0) {
    int64_t blocks = (n * w + kThreads - 1) / kThreads;
    blocks = blocks < kMaxBlocksPerRank ? blocks : kMaxBlocksPerRank;
    scatter_rows_kernel<<<dim3((unsigned)blocks, (unsigned)rows), kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const int32_t*)src, (const int32_t*)dstpos, (int32_t*)out,
        (uint32_t)n, (uint32_t)w, (uint32_t)num_slots);
  }
  return (int)cudaGetLastError();
}
