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
// Design of K4: one launch, a single pass with the decoupled look-back of
// csrc/lookback.cuh carried over to a vector of R+1 counts.  The TPU kernel
// counted through float32 MXU prefix matmuls (exact below 2^24) and carried
// a running histogram across sequential grid steps; blocks here run in no
// order, and counts are int32.  A block of W warps (8, fewer where R+1 is
// large: its shared memory holds W x 1024 lanes and (W+1)(R+1) counts)
// takes one tile of W x 1024 lanes:
//   1. one thread stages the tile's destinations in shared memory with one
//      bulk copy (cp.async.bulk, completing on an mbarrier; a ragged last
//      tile, or a dest row off 16 bytes, with 4-byte loads);
//   2. each warp walks its 1024 lanes 32 at a time: a lane writes d_clean
//      (a coalesced store), the lanes of one bucket find each other with
//      __match_any_sync, a lane's rank in the warp is the warp's running
//      count of its bucket (shared memory) plus the popcount of its group's
//      earlier lanes, and the group's leader then advances the count.  No
//      atomic decides a rank, so ranks are the stable lane-order ranks.  A
//      lane leaves (d << 10) | that rank in its shared word, so no register
//      array lives through the kernel (a version that kept the 32 lanes of
//      a thread in registers spilled or ran at 2 blocks an SM);
//   3. one thread a bucket scans the warps' counts into each warp's base
//      and the tile's aggregate, and publishes the aggregate in the
//      bucket's status word of this (row, tile);
//   4. warp w looks back for buckets w, w + W, ...: the bucket's prefix
//      over the row's earlier tiles;
//   5. rank = prefix[d] + warp base[d] + rank in the warp, one coalesced
//      store; the row's last tile writes hist.
// Status words are scratch the caller keeps per device (shared with K6):
// per (row, bucket) one word a tile, bucket-major, so a look-back window of
// 32 tiles reads 256 contiguous bytes.  With a new epoch each call they
// need no reset; epoch 1 clears them first with one cudaMemsetAsync.
//
// Design of K5: one thread per 32-bit word of src, grid-stride over a
// (word tile, rank) grid, 32-bit index math inside a rank (as K1).
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSteps = 32;                  // 32-lane steps a warp
constexpr int kWarpLanes = 32 * kSteps;     // 1024 lanes a warp
constexpr int kMaxWarps = 8;
constexpr int kMaxShared = 232448 - 16;     // a block's opt-in shared memory on sm_90, less the mbarrier
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksPerRank = 2048;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Dynamic shared memory: the tile's lanes (warps x 1024 int32, warp w's
// 1024 lanes at w x 1024: the tile in order), then (warps + 1) x (R+1)
// int32: row w < warps holds warp w's counts, then its base; row `warps`
// the tile's aggregate, then its prefix.
__global__ void __launch_bounds__(kMaxWarps * 32) rank_hist_kernel(
    const int32_t* __restrict__ dest, const int32_t* __restrict__ count,
    int32_t* __restrict__ d_clean, int32_t* __restrict__ rank, int32_t* __restrict__ hist,
    unsigned long long* __restrict__ status, int64_t cap, uint32_t n_tiles, int num_ranks,
    uint32_t epoch, bool aligned) {
  extern __shared__ __align__(16) int32_t sm[];
  __shared__ alignas(8) unsigned long long bar;
  const int nb = num_ranks + 1, warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b = blockIdx.y;
  const uint32_t t = blockIdx.x;
  // lane indices within a row fit 32 bits (C < 2^31, tiles past C do not exist)
  const uint32_t n = (uint32_t)cap, tile_lanes = warps * kWarpLanes;
  const uint32_t first = t * tile_lanes, m = min(n - first, tile_lanes);
  const int32_t* d_row = dest + b * cap;
  int32_t* c_row = d_clean + b * cap;
  int32_t* r_row = rank + b * cap;
  int32_t* lanes = sm + warp * kWarpLanes;  // this warp's lanes
  int32_t* counts = sm + tile_lanes;
  int32_t* wcount = counts + warp * nb;
  int32_t* tile = counts + warps * nb;

  // 1. the tile's destinations into shared memory: one bulk copy
  const bool bulk = aligned && m == tile_lanes;
  const uint32_t bar_a = smem_addr(&bar);
  if (bulk && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_a));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_a),
                 "r"(m * 4) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(sm)), "l"(d_row + first), "r"(m * 4), "r"(bar_a) : "memory");
  }
  if (!bulk)
    for (uint32_t i = threadIdx.x; i < m; i += blockDim.x) sm[i] = d_row[first + i];
  for (int i = threadIdx.x; i < (warps + 1) * nb; i += blockDim.x) counts[i] = 0;
  __syncthreads();  // counts zeroed, the barrier initialised, the 4-byte copy done
  if (bulk) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0; "
          "selp.u32 %0, 1, 0, p; }"
          : "=r"(done) : "r"(bar_a) : "memory");
    }
  }

  // 2. step k of warp w: lanes w x 1024 + 32 k + 0..31 of the tile.  A lane
  // writes d_clean, finds the lanes of its bucket with __match_any_sync and
  // leaves (d << 10) | its rank in the warp (< 1024) in its shared word.
  const uint32_t cnt = (uint32_t)min(max(count[b], 0), (int32_t)n);
  const uint32_t base = first + warp * kWarpLanes + lane;
  const unsigned earlier = (1u << lane) - 1u;
  for (int k = 0; k < kSteps; ++k) {
    const uint32_t i = base + 32 * k;
    int d = -1;  // past the row's end
    if (i < n) {
      const int v = lanes[32 * k + lane];
      d = (i < cnt && v >= 0 && v < num_ranks) ? v : num_ranks;
      c_row[i] = d;
    }
    const unsigned group = __match_any_sync(kFull, d);
    if (d >= 0) lanes[32 * k + lane] = (d << 10) | (wcount[d] + __popc(group & earlier));
    __syncwarp();  // every lane has read wcount[d] before a leader moves it
    if (d >= 0 && (__ffs(group) - 1) == lane) wcount[d] += __popc(group);
    __syncwarp();
  }
  __syncthreads();

  // 3. per bucket: the warps' bases, the tile's aggregate, published
  for (int d = threadIdx.x; d < nb; d += blockDim.x) {
    int run = 0;
    for (int w = 0; w < warps; ++w) {
      const int c = counts[w * nb + d];
      counts[w * nb + d] = run;
      run += c;
    }
    tile[d] = run;
    lookback::publish_aggregate(status + (b * nb + d) * n_tiles, t, run, epoch);
  }
  __syncthreads();

  // 4. per bucket: the prefix over the row's earlier tiles
  for (int d = warp; d < nb; d += warps) {
    const int agg = tile[d];
    const int prefix = lookback::exclusive_prefix(status + (b * nb + d) * n_tiles, t, agg, epoch, lane);
    __syncwarp();  // every lane has read tile[d]
    if (lane == 0) {
      if (t == n_tiles - 1) hist[b * nb + d] = prefix + agg;
      tile[d] = prefix;
    }
  }
  __syncthreads();

  // 5. rank = prefix + warp base + rank in the warp
  for (int k = 0; k < kSteps; ++k) {
    const uint32_t i = base + 32 * k;
    const int v = lanes[32 * k + lane], d = v >> 10;
    if (i < n) r_row[i] = tile[d] + wcount[d] + (v & 1023);
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
// hist (B, R+1) int32, all written in full; status: status_words 64-bit
// words of scratch kept by the caller, at least B * (R+1) * ceil(C / 1024);
// epoch in [1, 2^30), a new one each call on this scratch, 1 clearing the
// scratch first.  0 < C < 2^31, R + 1 <= 12288, B <= 65535.
extern "C" int rafi_rank_and_histogram(const void* dest, const void* count, void* d_clean,
                                       void* rank, void* hist, void* status,
                                       int64_t status_words, int64_t rows, int64_t cap,
                                       int64_t num_ranks, int64_t epoch, void* stream) {
  if (rows <= 0 || cap <= 0) return (int)cudaGetLastError();
  const int64_t nb = num_ranks + 1;
  // shared memory: warps x 1024 lanes + (warps + 1) x nb counts
  const int64_t per_warp = (kWarpLanes + nb) * (int64_t)sizeof(int32_t);
  int warps = (int)((kMaxShared - nb * (int64_t)sizeof(int32_t)) / per_warp);
  warps = warps < kMaxWarps ? warps : kMaxWarps;
  if (warps < 1 || epoch < 1 || epoch >= (1 << 30)) return (int)cudaErrorInvalidValue;
  const int64_t n_tiles = (cap + (int64_t)warps * kWarpLanes - 1) / ((int64_t)warps * kWarpLanes);
  if (status_words < rows * nb * n_tiles) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (epoch == 1) {
    const cudaError_t rc = cudaMemsetAsync(status, 0, status_words * sizeof(unsigned long long), s);
    if (rc != cudaSuccess) return (int)rc;
  }
  const size_t smem = (size_t)warps * per_warp + nb * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        rank_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  rank_hist_kernel<<<dim3((unsigned)n_tiles, (unsigned)rows), warps * 32, smem, s>>>(
      (const int32_t*)dest, (const int32_t*)count, (int32_t*)d_clean, (int32_t*)rank,
      (int32_t*)hist, (unsigned long long*)status, cap, (uint32_t)n_tiles, (int)num_ranks,
      (uint32_t)epoch, (uintptr_t)dest % 16 == 0 && cap % 4 == 0);
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
