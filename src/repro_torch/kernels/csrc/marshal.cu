// K1 gather_rows and K2 unmarshal — the packed payload's two passes around
// the exchange — and K7 marshal, the two-pass marshal's segment copy, for
// sm_90a.
//
// Replaces: src/repro/kernels/marshal/kernel.py, gather_rows (the Pallas
// kernel _gather_rows_kernel), unmarshal (_unmarshal_kernel) and marshal
// (_marshal_kernel).
//
// K1: out[b, i, :] = src[b, clip(idx[b, i], 0, C-1), :] over rank-stacked
//     (B, C, W) 32-bit words.  The caller has composed the destination-sort
//     permutation with the padded send layout (idx = perm[off[r] + s]), so
//     this one gather is the sort marshal's whole send-side payload pass.
// K2: receive compaction of rank-stacked (B, G, S, W) received blocks:
//     block g's first counts[b, g] rows land at clip(off[b, g], 0, cap) + s
//     in a (B, cap, W) output; rows at or past cap are cut (§3.3).  The
//     caller zero-fills the output, so every row no block writes is zero.
//     Offsets are the exclusive prefix of the counts, so valid rows never
//     collide and the scatter has no races.
// K7: out[b, r, s, :] = sorted[b, clip(off[b, r], 0, C-S) + s, :] — each
//     peer's contiguous S-row segment of a destination-sorted (B, C, W)
//     buffer into the (B, R, S, W) send layout (the cross-check of K1's
//     fused marshal: sort first, then copy segments).
//
// Bound on the H100: bytes.  K1 reads each gathered row and writes each
// output row once; K2 reads each valid received row and writes the output;
// K7 reads each segment row and writes the output.  None does arithmetic
// beyond index math.
//
// Design: one thread per 32-bit word, grid-stride, a 2-D grid of (word
// tile, rank).  Inside a rank the word index stays 32-bit (the wrapper
// checks that one rank's words fit), so splitting it into (row, word) costs
// 32-bit divisions; every address is a 64-bit offset (at the smoke shapes
// B*G*S*W is 46 M words).  A first version split a 64-bit flat index with
// two 64-bit divisions per word and ran slower than torch.gather.
// Neighbouring threads touch neighbouring words of a row, so a warp's
// accesses coalesce within and across rows.  W = 5 (Particle) and W = 11
// (Ray44) are not multiples of 4, so 16-byte vector loads do not apply; a
// later PR could stage rows through shared memory or pad the wire format
// to a multiple of four words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksPerRank = 2048;

dim3 grid_for(int64_t per_rank, int64_t rows) {
  int64_t n = (per_rank + kThreads - 1) / kThreads;
  n = n < kMaxBlocksPerRank ? n : kMaxBlocksPerRank;
  return dim3((unsigned)(n > 0 ? n : 1), (unsigned)rows);
}

// blockIdx.y = rank b; e = i * w + col indexes rank b's (n, w) output words
__global__ void gather_rows_kernel(const int32_t* __restrict__ src,
                                   const int32_t* __restrict__ idx,
                                   int32_t* __restrict__ out, uint32_t cap,
                                   uint32_t n, uint32_t w) {
  const int64_t b = blockIdx.y;
  const int32_t* src_b = src + b * (int64_t)cap * w;
  const int32_t* idx_b = idx + b * (int64_t)n;
  int32_t* out_b = out + b * (int64_t)n * w;
  const uint32_t total = n * w;
  for (uint32_t e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const uint32_t i = e / w;
    const uint32_t col = e - i * w;
    int32_t r = idx_b[i];
    r = r < 0 ? 0 : (r >= (int32_t)cap ? (int32_t)cap - 1 : r);
    out_b[e] = src_b[(int64_t)r * w + col];
  }
}

// blockIdx.y = rank b; e = (g * slot + s) * w + col indexes rank b's
// received words
__global__ void unmarshal_kernel(const int32_t* __restrict__ recv,
                                 const int32_t* __restrict__ off,
                                 const int32_t* __restrict__ counts,
                                 int32_t* __restrict__ out, uint32_t g_blocks,
                                 uint32_t slot, uint32_t w, uint32_t cap) {
  const int64_t b = blockIdx.y;
  const int32_t* recv_b = recv + b * (int64_t)g_blocks * slot * w;
  const int32_t* off_b = off + b * (int64_t)g_blocks;
  const int32_t* cnt_b = counts + b * (int64_t)g_blocks;
  int32_t* out_b = out + b * (int64_t)cap * w;
  const uint32_t total = g_blocks * slot * w;
  for (uint32_t e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const uint32_t row = e / w;
    const uint32_t col = e - row * w;
    const uint32_t g = row / slot;
    const int64_t s = row - g * slot;
    if (s >= cnt_b[g]) continue;
    int64_t o = off_b[g];
    o = o < 0 ? 0 : (o > (int64_t)cap ? (int64_t)cap : o);
    const int64_t dst = o + s;
    if (dst >= (int64_t)cap) continue;
    out_b[dst * w + col] = recv_b[e];
  }
}

// blockIdx.y = rank b; e = (r * slot + s) * w + col indexes rank b's
// (R, S, W) output words
__global__ void marshal_kernel(const int32_t* __restrict__ sorted,
                               const int32_t* __restrict__ off,
                               int32_t* __restrict__ out, uint32_t cap,
                               uint32_t num_ranks, uint32_t slot, uint32_t w) {
  const int64_t b = blockIdx.y;
  const int32_t* sorted_b = sorted + b * (int64_t)cap * w;
  const int32_t* off_b = off + b * (int64_t)num_ranks;
  int32_t* out_b = out + b * (int64_t)num_ranks * slot * w;
  const uint32_t total = num_ranks * slot * w;
  const int32_t hi = (int32_t)(cap - slot);
  for (uint32_t e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const uint32_t row = e / w;
    const uint32_t col = e - row * w;
    const uint32_t r = row / slot;
    const uint32_t s = row - r * slot;
    int32_t o = off_b[r];
    o = o < 0 ? 0 : (o > hi ? hi : o);
    out_b[e] = sorted_b[((int64_t)o + s) * w + col];
  }
}

}  // namespace

// src (B, C, W), idx (B, N) int32 -> out (B, N, W); N*W and C*W < 2^31.
extern "C" int rafi_gather_rows(const void* src, const void* idx, void* out,
                                int64_t rows, int64_t cap, int64_t n,
                                int64_t w, void* stream) {
  if (rows > 0 && n * w > 0) {
    gather_rows_kernel<<<grid_for(n * w, rows), kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)src, (const int32_t*)idx, (int32_t*)out, (uint32_t)cap,
        (uint32_t)n, (uint32_t)w);
  }
  return (int)cudaGetLastError();
}

// recv (B, G, S, W), off (B, G), counts (B, G) int32 -> out (B, cap, W),
// zero-filled by the caller; G*S*W and capacity*W < 2^31.
extern "C" int rafi_unmarshal(const void* recv, const void* off,
                              const void* counts, void* out, int64_t rows,
                              int64_t g_blocks, int64_t slot, int64_t w,
                              int64_t cap, void* stream) {
  if (rows > 0 && g_blocks * slot * w > 0) {
    unmarshal_kernel<<<grid_for(g_blocks * slot * w, rows), kThreads, 0,
                       (cudaStream_t)stream>>>(
        (const int32_t*)recv, (const int32_t*)off, (const int32_t*)counts,
        (int32_t*)out, (uint32_t)g_blocks, (uint32_t)slot, (uint32_t)w,
        (uint32_t)cap);
  }
  return (int)cudaGetLastError();
}

// sorted (B, C, W), off (B, R) int32 -> out (B, R, S, W); S <= C,
// R*S*W and C*W < 2^31.
extern "C" int rafi_marshal(const void* sorted, const void* off, void* out,
                            int64_t rows, int64_t cap, int64_t num_ranks,
                            int64_t slot, int64_t w, void* stream) {
  if (rows > 0 && num_ranks * slot * w > 0) {
    marshal_kernel<<<grid_for(num_ranks * slot * w, rows), kThreads, 0,
                     (cudaStream_t)stream>>>(
        (const int32_t*)sorted, (const int32_t*)off, (int32_t*)out,
        (uint32_t)cap, (uint32_t)num_ranks, (uint32_t)slot, (uint32_t)w);
  }
  return (int)cudaGetLastError();
}
