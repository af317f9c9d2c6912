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
// K2: receive compaction of rank-stacked (B, G, S, W) received blocks into
//     a (B, cap, W) output: block g's rows s < clip(counts[b, g], 0, S)
//     land at clip(off[b, g], 0, cap) + s; rows at or past cap are cut
//     (§3.3); every row no block covers is zero.  Where blocks overlap, the
//     highest g wins, as in the Pallas kernel's sequential grid.
// K7: out[b, r, s, :] = sorted[b, clip(off[b, r], 0, C-S) + s, :] — each
//     peer's contiguous S-row segment of a destination-sorted (B, C, W)
//     buffer into the (B, R, S, W) send layout (the cross-check of K1's
//     fused marshal: sort first, then copy segments).
//
// Bound on the H100: bytes.  K1 reads each gathered row and writes each
// output row once; K2 reads each row that lands and writes the output; K7
// reads each segment row and writes the output.  None does arithmetic
// beyond index math.  K2 at the Fig-8 shape (recv (8, 8, 65536, 11), cap
// 262,144, rank 0 overflowing) moves 169.6 MB: 0.051 ms at 3.35 TB/s.
//
// K1 and K7: one thread per 32-bit word, grid-stride, a 2-D grid of (word
// tile, rank).  Inside a rank the word index stays 32-bit (the wrapper
// checks that one rank's words fit), so splitting it into (row, word) costs
// 32-bit divisions; every address is a 64-bit offset.  A first version
// split a 64-bit flat index with two 64-bit divisions per word and ran
// slower than torch.gather.  Neighbouring threads touch neighbouring words
// of a row, so a warp's accesses coalesce within and across rows.
//
// K2 is output-driven, so it needs no memset of the output (a thread per
// received word would have to zero the rows no block covers first, and would
// spend two divisions a word on slots that mostly do not land). Each block
// first turns the rank's G offsets and counts into a table in shared memory:
// the word range [start_g, end_g) of the output that block g fills and the
// source base g*S*W - start_g, so a covered output word e reads recv word
// base_g + e; no division is needed.  Each thread then owns 4 consecutive
// output words, finds the block that covers each by a scan from the highest
// g down (at most G <= 1024 entries, read as shared-memory broadcasts), and
// writes the 4 words as one int4 store where cap*W % 4 == 0 (scalar stores
// otherwise); a word no block covers is written as 0. The 4 source words are
// one 16-byte load where they are consecutive and aligned, 4-byte loads
// otherwise.  Every output word is written exactly once, so the wrapper
// allocates the output with torch.empty, and only the words that land are
// read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksPerRank = 2048;
constexpr int64_t kMaxUnmarshalBlocks = 1024;  // K2's shared table: 12 KB

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

// blockIdx.y = rank b; each thread owns output words [e0, e0 + 4) of rank
// b's (cap, w) output.  Dynamic shared memory: 3 * g_blocks int32.
__global__ void __launch_bounds__(kThreads) unmarshal_kernel(
    const int32_t* __restrict__ recv, const int32_t* __restrict__ off,
    const int32_t* __restrict__ counts, int32_t* __restrict__ out,
    uint32_t g_blocks, uint32_t slot, uint32_t w, uint32_t cap) {
  extern __shared__ int32_t table[];
  int32_t* t_start = table;                 // first output word of block g
  int32_t* t_end = table + g_blocks;        // one past its last
  int32_t* t_base = table + 2 * g_blocks;   // recv word = t_base[g] + e
  const int64_t b = blockIdx.y;
  const int32_t* off_b = off + b * (int64_t)g_blocks;
  const int32_t* cnt_b = counts + b * (int64_t)g_blocks;
  for (uint32_t g = threadIdx.x; g < g_blocks; g += blockDim.x) {
    int64_t o = off_b[g], n = cnt_b[g];
    o = o < 0 ? 0 : (o > (int64_t)cap ? (int64_t)cap : o);
    n = n < 0 ? 0 : (n > (int64_t)slot ? (int64_t)slot : n);
    const int64_t end = o + n < (int64_t)cap ? o + n : (int64_t)cap;
    t_start[g] = (int32_t)(o * w);
    t_end[g] = (int32_t)(end * w);
    t_base[g] = (int32_t)((int64_t)g * slot * w - o * w);
  }
  __syncthreads();

  const int32_t* recv_b = recv + b * (int64_t)g_blocks * slot * w;
  int32_t* out_b = out + b * (int64_t)cap * w;
  const uint32_t total = cap * w;
  const bool vec_store = (total & 3u) == 0;
  const uint32_t stride = 4u * gridDim.x * blockDim.x;
  for (uint32_t e0 = 4u * (blockIdx.x * blockDim.x + threadIdx.x); e0 < total; e0 += stride) {
    int32_t src[4] = {-1, -1, -1, -1};  // recv word of each output word
    unsigned todo = 0xFu;
    for (int g = (int)g_blocks - 1; g >= 0 && todo; --g) {
      int lo = t_start[g] - (int32_t)e0, hi = t_end[g] - (int32_t)e0;
      lo = lo < 0 ? 0 : (lo > 4 ? 4 : lo);
      hi = hi < 0 ? 0 : (hi > 4 ? 4 : hi);
      if (lo >= hi) continue;
      const unsigned cover = ((1u << hi) - 1u) & ~((1u << lo) - 1u);
      const unsigned take = cover & todo;
      const int32_t base = t_base[g] + (int32_t)e0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (take >> k & 1u) src[k] = base + k;
      todo &= ~cover;
    }
    int4 v;
    const int32_t* p = recv_b + src[0];
    if (src[0] >= 0 && src[1] == src[0] + 1 && src[2] == src[0] + 2 && src[3] == src[0] + 3 &&
        ((uintptr_t)p & 15u) == 0) {
      v = __ldg(reinterpret_cast<const int4*>(p));
    } else {
      v.x = src[0] >= 0 ? __ldg(recv_b + src[0]) : 0;
      v.y = src[1] >= 0 ? __ldg(recv_b + src[1]) : 0;
      v.z = src[2] >= 0 ? __ldg(recv_b + src[2]) : 0;
      v.w = src[3] >= 0 ? __ldg(recv_b + src[3]) : 0;
    }
    if (vec_store) {
      *reinterpret_cast<int4*>(out_b + e0) = v;
    } else {
      out_b[e0] = v.x;
      if (e0 + 1 < total) out_b[e0 + 1] = v.y;
      if (e0 + 2 < total) out_b[e0 + 2] = v.z;
      if (e0 + 3 < total) out_b[e0 + 3] = v.w;
    }
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
// every word written (the caller allocates it uninitialised); G <= 1024,
// G*S*W and cap*W < 2^31.
extern "C" int rafi_unmarshal(const void* recv, const void* off,
                              const void* counts, void* out, int64_t rows,
                              int64_t g_blocks, int64_t slot, int64_t w,
                              int64_t cap, void* stream) {
  if (g_blocks > kMaxUnmarshalBlocks) return (int)cudaErrorInvalidValue;
  if (rows > 0 && cap * w > 0) {
    unmarshal_kernel<<<grid_for((cap * w + 3) / 4, rows), kThreads,
                       3 * g_blocks * sizeof(int32_t), (cudaStream_t)stream>>>(
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
