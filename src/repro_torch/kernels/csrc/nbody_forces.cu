// K9 pairwise_accel — softened all-pairs gravity for the N-body app (§5.5),
// for sm_90a.
//
// Replaces: src/repro/kernels/nbody_forces/kernel.py, pairwise_accel (the
// Pallas kernel _forces_kernel).
//
// Computes, for every row b of rank-stacked xi (B, N, 3), xj (B, M, 3) and
// mj (B, M), all float32:
//   out[b, i] = Σ_j mj[b, j] · (xj[b, j] − xi[b, i]) · rsqrt(r²)³,
//   r² = |xj[b, j] − xi[b, i]|² + eps2
// G is folded in by the caller.  A source of zero mass adds exactly zero
// (r² ≥ eps2 > 0, so rsqrt is finite).
//
// Bound on the H100: float32 arithmetic.  About 20 operations a pair (an
// FMA counted as two) against 67e12 a second; the bytes (16 per source and
// 24 per target) are negligible beside B·N·M pairs.  rsqrt runs on the
// special-function units, 16 a clock per SM, about 4.2e12 a second at
// 1.98 GHz; at one rsqrt per 20 operations that is about 80% of the float32
// bound, so it sets no tighter limit.
//
// Design: the classic all-pairs kernel.  One thread per target holds the
// target's (x, y, z) and its acceleration in registers; grid (N / 256, B).
// The block walks the sources in tiles of 256 float4 (x, y, z, m) staged in
// shared memory, each thread loading one; the ragged last tile is padded
// with m = 0.  The TPU kernel carried the (TI, 3) sum across sequential
// steps of its j grid axis; blocks here run in no order, so the loop over
// tiles inside the block takes the j axis's place.  The unrolled inner loop
// is 3 subtractions, 3 FMAs for r², one rsqrt, 3 multiplies and 3 FMAs.
// The rsqrt is rsqrt.approx.ftz.f32, the instruction rsqrtf compiles to
// under -ftz: without it rsqrtf adds a fix-up for subnormal inputs, and r²
// ≥ ε², which the wrapper requires to be a normal float, is never
// subnormal.
// Summation in three levels: 16 sources into a group sum, the 16 group sums
// of a tile into a tile sum, and the tile sums into the running total with
// Kahan compensation.  A plain sequential sum over 262,144 sources would
// err by about √M ulps, and even one 256-source sequential sum per tile
// errs most where a tile holds heavy sources (the octant monopoles, all in
// the last tile).  A tile whose sum is exactly zero (all padding) is
// skipped, so zero-mass sources leave every bit of the result as it was
// without them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;  // sources staged per tile
constexpr int kGroup = 16;       // sources per group sum

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void kahan_add(float& sum, float& comp, float x) {
  if (x == 0.0f) return;
  const float y = x - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

__global__ void __launch_bounds__(kThreads)
pairwise_accel_kernel(const float* __restrict__ xi,
                      const float* __restrict__ xj,
                      const float* __restrict__ mj, float* __restrict__ out,
                      int64_t n, int64_t m, float eps2) {
  __shared__ float4 src[kTile];
  const int64_t b = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const float* xib = xi + b * n * 3;
  const float* xjb = xj + b * m * 3;
  const float* mjb = mj + b * m;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (i < n) {
    px = xib[3 * i];
    py = xib[3 * i + 1];
    pz = xib[3 * i + 2];
  }
  float ax = 0.0f, ay = 0.0f, az = 0.0f;  // running totals
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;  // their Kahan compensations
  for (int64_t base = 0; base < m; base += kTile) {
    const int64_t j = base + threadIdx.x;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j < m) s = make_float4(xjb[3 * j], xjb[3 * j + 1], xjb[3 * j + 2], mjb[j]);
    __syncthreads();  // every thread is done with the previous tile
    src[threadIdx.x] = s;
    __syncthreads();
    float tx = 0.0f, ty = 0.0f, tz = 0.0f;
    for (int g = 0; g < kTile; g += kGroup) {
      float gx = 0.0f, gy = 0.0f, gz = 0.0f;
#pragma unroll
      for (int k = g; k < g + kGroup; ++k) {
        const float4 q = src[k];
        const float dx = q.x - px, dy = q.y - py, dz = q.z - pz;
        const float r2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, eps2)));
        const float inv = rsqrt_ftz(r2);
        const float w = q.w * (inv * inv * inv);
        gx = fmaf(w, dx, gx);
        gy = fmaf(w, dy, gy);
        gz = fmaf(w, dz, gz);
      }
      tx += gx;
      ty += gy;
      tz += gz;
    }
    kahan_add(ax, cx, tx);
    kahan_add(ay, cy, ty);
    kahan_add(az, cz, tz);
  }
  if (i < n) {
    float* o = out + (b * n + i) * 3;
    o[0] = ax;
    o[1] = ay;
    o[2] = az;
  }
}

}  // namespace

// xi (B, N, 3), xj (B, M, 3), mj (B, M) float32 -> out (B, N, 3) float32.
extern "C" int rafi_pairwise_accel(const void* xi, const void* xj,
                                   const void* mj, void* out, int64_t b,
                                   int64_t n, int64_t m, float eps2,
                                   void* stream) {
  if (b > 0 && n > 0) {
    dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)b);
    pairwise_accel_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)xi, (const float*)xj, (const float*)mj, (float*)out, n,
        m, eps2);
  }
  return (int)cudaGetLastError();
}
