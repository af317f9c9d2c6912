// K3 pack_and_histogram — the sort marshal's plan pass, for sm_90a.
//
// Replaces: src/repro/kernels/sort_keys/kernel.py, pack_and_histogram
// (the Pallas kernel _pack_hist_kernel).
//
// Computes, for every rank b of a rank-stacked (B, C) destination array and
// its (B,) count vector, in one pass:
//   d_clean = (lane < count[b] && 0 <= dest < R) ? dest : R
//   key     = (d_clean << idx_bits) | lane        (a uint32 value)
//   hist[b, d_clean] += 1                         ((B, R+1) int32)
// Keys are written as int64 holding the uint32 value, so that torch.sort
// orders them correctly even when the key's top bit is set
// (bit_length(R+1) + idx_bits == 32).
//
// Bound on the H100: bytes (4 B of dest read, 8 B of key written per lane;
// the histogram is (B, R+1) int32, negligible).  The arithmetic is a few
// integer operations per lane.
//
// Design: a grid over (lane tile, rank).  Each block packs its tile's keys
// and histograms them into R+1 shared-memory bins with integer atomicAdd,
// then adds its non-zero bins to the zeroed global histogram.  Integer
// atomics commute, so the result is deterministic.  The TPU kernel carried
// the histogram across sequential grid steps; blocks here run in no order,
// so the cross-block sum is the global atomic.  A later PR could write
// 32-bit keys as 16-byte vectors and aggregate bins per warp first.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;  // lanes per block: 16 per thread

__global__ void pack_hist_kernel(const int32_t* __restrict__ dest,
                                 const int32_t* __restrict__ count,
                                 int64_t* __restrict__ keys,
                                 int32_t* __restrict__ hist,
                                 int64_t cap, int num_ranks, int idx_bits) {
  extern __shared__ int32_t bins[];  // num_ranks + 1
  const int64_t b = blockIdx.y;
  for (int i = threadIdx.x; i <= num_ranks; i += blockDim.x) bins[i] = 0;
  __syncthreads();

  const int64_t lo = (int64_t)blockIdx.x * kTile;
  const int64_t hi = lo + kTile < cap ? lo + kTile : cap;
  const int64_t cnt = count[b];
  const int32_t* d_row = dest + b * cap;
  int64_t* k_row = keys + b * cap;
  for (int64_t lane = lo + threadIdx.x; lane < hi; lane += blockDim.x) {
    const int32_t d = d_row[lane];
    const bool valid = lane < cnt && d >= 0 && d < num_ranks;
    const uint32_t dc = valid ? (uint32_t)d : (uint32_t)num_ranks;
    const uint32_t key = (dc << idx_bits) | (uint32_t)lane;
    k_row[lane] = (int64_t)key;
    atomicAdd(&bins[dc], 1);
  }
  __syncthreads();

  int32_t* h_row = hist + b * (num_ranks + 1);
  for (int i = threadIdx.x; i <= num_ranks; i += blockDim.x) {
    const int32_t v = bins[i];
    if (v) atomicAdd(&h_row[i], v);
  }
}

}  // namespace

// dest (B, C) int32, count (B,) int32 -> keys (B, C) int64, hist (B, R+1)
// int32, which the caller has zeroed.  Returns cudaGetLastError().
extern "C" int rafi_pack_and_histogram(const void* dest, const void* count,
                                       void* keys, void* hist, int64_t rows,
                                       int64_t cap, int num_ranks, int idx_bits,
                                       void* stream) {
  if (rows <= 0 || cap <= 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((cap + kTile - 1) / kTile), (unsigned)rows);
  const size_t smem = (size_t)(num_ranks + 1) * sizeof(int32_t);
  pack_hist_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)dest, (const int32_t*)count, (int64_t*)keys,
      (int32_t*)hist, cap, num_ranks, idx_bits);
  return (int)cudaGetLastError();
}
