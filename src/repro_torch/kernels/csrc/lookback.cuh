// The decoupled look-back shared by K4 (csrc/bucket_scatter.cu) and K6
// (csrc/compact.cu): a single-pass prefix over tiles that the card runs in
// no order (Merrill and Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back"; CUB's DeviceScan scheme).
//
// A sequence of tiles 0, 1, ... owns one 64-bit status word a tile: the
// flag and the call's epoch in the high 32 bits, the tile's value in the
// low 32.  Flag and value share one word, so relaxed loads and stores
// suffice: no other memory is published with it (an acquire load at gpu
// scope would also invalidate the SM's L1 on every spin).  A tile first
// publishes its own sum (AGGREGATE; tile 0 its INCLUSIVE prefix at once);
// one warp then looks back 32 predecessors at a time, waiting while any
// lane up to the nearest INCLUSIVE one is unpublished, sums them, and
// publishes its own INCLUSIVE prefix.  A tile waits only on tiles of lower
// linear block index, which the card has dispatched before it, so the
// wait always ends.  Words left by earlier calls carry another epoch and
// read as unpublished, so the scratch needs no reset between calls; the
// caller clears it when the epoch starts again at 1.
#pragma once
#include <stdint.h>

namespace lookback {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kAggregate = 1, kInclusive = 2;  // status flags

__device__ __forceinline__ void store_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long status_word(uint32_t tag, int32_t value) {
  return ((unsigned long long)tag << 32) | (uint32_t)value;
}

// One thread: tile t's own sum into its word st[t] (tile 0: its prefix).
__device__ __forceinline__ void publish_aggregate(unsigned long long* st, uint32_t t, int agg,
                                                  uint32_t epoch) {
  store_relaxed(&st[t], status_word((epoch << 2) | (t == 0 ? kInclusive : kAggregate), agg));
}

// Warp-collective, after publish_aggregate: the sum over tiles 0 .. t-1 of
// the sequence st; publishes tile t's INCLUSIVE prefix (that sum + agg).
__device__ __forceinline__ int exclusive_prefix(unsigned long long* st, uint32_t t, int agg,
                                                uint32_t epoch, int lane) {
  if (t == 0) return 0;
  const uint32_t tag_agg = (epoch << 2) | kAggregate, tag_inc = (epoch << 2) | kInclusive;
  int prefix = 0;
  int64_t nearest = (int64_t)t - 1;  // lane k reads tile nearest - k
  for (;;) {
    const int64_t j = nearest - lane;
    unsigned long long s;
    unsigned inc, upto;
    for (;;) {
      s = j >= 0 ? load_relaxed(&st[j]) : status_word(tag_inc, 0);
      const uint32_t tag = (uint32_t)(s >> 32);
      inc = __ballot_sync(kFull, tag == tag_inc);
      // lanes up to the nearest inclusive prefix (all 32 if none)
      upto = inc ? ((inc & (0u - inc)) << 1) - 1u : kFull;
      const unsigned unready = __ballot_sync(kFull, tag != tag_inc && tag != tag_agg);
      if (!(unready & upto)) break;
    }
    int v = (upto >> lane & 1u) ? (int32_t)(uint32_t)s : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    prefix += v;
    if (inc) break;
    nearest -= 32;
  }
  if (lane == 0) store_relaxed(&st[t], status_word(tag_inc, prefix + agg));
  return prefix;
}

}  // namespace lookback
