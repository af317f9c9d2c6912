// K10 track — K Woodcock (delta-tracking) steps per ray through a
// Gaussian-blob density, for sm_90a.
//
// Replaces: src/repro/kernels/delta_tracking/kernel.py, track (the Pallas
// kernel _track_kernel).
//
// Computes, for N rays with origins o, dirs d (N, 3), t0, t_exit (N,),
// uniforms u (N, K, 2) and blobs (G, 5) = (cx, cy, cz, s, amp), all
// float32, and for k < steps while the ray's status is STILL (0):
//   t_new = t − log1pf(−u[k, 0]) / μ̄;   p = o + t_new·d
//   σ = Σ_g amp_g · expf((−0.5·|p − c_g|²) / (s_g·s_g))   (g in index order)
//   t_new ≥ t_exit → EXITED (2);  else u[k, 1]·μ̄ < σ → HIT (1)
//   t = t_new
// and writes t (N,) float32 and status (N,) int32.
//
// Bound on the H100.  A ray reads 12 + 12 + 4 + 4 B and 8 B of uniforms for
// each step it takes, and writes 8 B.  The walk ends at the first status
// change, so the bytes depend on the data: the VoPaT scene's 777,924 camera
// rays take 5.88 steps on average at K = 8 (half of them stop early), so
// 87 B a ray, 0.0202 ms at 3.35 TB/s, where a fixed K = 8 would count 104.
// Instruction issue is what bounds the kernel: a step is an IEEE log1pf, a
// division and, for each of the G = 6 blobs, eleven rounded operations, a
// division and an IEEE expf.  Its fast path is 219 SASS instructions, and
// one thread a ray keeps 80% of the lanes busy (a warp runs as long as its
// longest ray), so the steps need 0.0374 ms of issue at 1.98 GHz, and the
// kernel runs at about 73% of that rate (tools/k10_variants.py).  The
// design cuts instructions a step:
//   - blob constants once a block: s² (the same __fmul_rn), 2·s² and
//     −½·__frcp_rn(s²) go to shared memory, so a step recomputes no s·s.  A
//     step reads them with loads the compiler keeps in the loop: hoisted,
//     they took 80–96 registers a thread (2–3 blocks an SM) and ran slower;
//   - each division is Markstein's correction from the correctly rounded
//     reciprocal y: q0 = a·y, r = b·q0 − a (exact in one FMA), q = q0 − r·y,
//     __fdiv_rn(a, b) bit for bit while a, b and the quotient stay well
//     inside the normal range: 3 instructions where __fdiv_rn takes about
//     10 and a branch.  A step checks that range once, without a branch,
//     and runs again with __fdiv_rn where it fails (never, on the scene's
//     rays).  tools/k10_variants.py holds both divisions bit-equal to
//     __fdiv_rn over every float of the ranges at the scene's divisors and
//     on random pairs;
//   - loads: a thread reads its ray's o, d, t0 and t_exit once, and a
//     step's two uniforms as one 8-byte load issued a step ahead; steps a
//     ray does not take are never read;
//   - for G ≤ 8 the blob count is a template argument, so the blob loop is
//     unrolled and its terms interleave; other G loop at run time;
//   - the register budget is cut to 6 blocks of 256 threads an SM (40
//     registers, no spill).
// Tried and measured slower (tools/k10_variants.py): lane refill, where a
// warp keeps 32 rays in flight over a span of rays and a lane whose ray
// stops takes the span's next ray (its loads stall the warp, and taking a
// ray costs about as many instructions a step as the idle lanes it saves),
// also with the next ray held in registers; a grid of the resident blocks
// in a grid-stride loop.
// Every operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn, __fmaf_rn) in the plain version's order, so nvcc contracts
// nothing; expf and log1pf are the IEEE-accurate CUDA math functions (no
// --use_fast_math, no __expf), the same ones torch's elementwise kernels
// call on the card.  A ray's bits never depend on its thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef RAFI_TRACK_THREADS  // tools/k10_variants.py builds other block shapes
#define RAFI_TRACK_THREADS 256
#endif
#ifndef RAFI_TRACK_MIN_BLOCKS
#define RAFI_TRACK_MIN_BLOCKS 6
#endif
constexpr int kThreads = RAFI_TRACK_THREADS;
// blocks an SM the register budget is cut for (__launch_bounds__)
constexpr int kMinBlocks = RAFI_TRACK_MIN_BLOCKS;
constexpr int64_t kMaxBlocks = 132 * 32 * 256 / kThreads;
constexpr int kStill = 0, kHit = 1, kExited = 2;
// |p| at most 2^28 and blob centres at most 2^28 keep r² below 2^61
constexpr float kBox = 0x1p28f;
// Markstein's correction is exact when |a| and the divisor b both lie in
// [2^-60, 2^60]: the reciprocal, the product a·y and the quotient are normal,
// and the residual's bits (a multiple of 2^-107 or more) fit a float.
constexpr float kDivLo = 0x1p-60f, kDivHi = 0x1p60f;

// The least |a| for which a / b takes the exact fast path: +inf (never)
// when b lies outside [2^-60, 2^60].
__device__ __forceinline__ float div_lo(float b) {
  return (b >= kDivLo && b <= kDivHi) ? kDivLo : __int_as_float(0x7f800000);
}

// Markstein's quotient a / b from y = __frcp_rn(b): q0 = a·y, r = b·q0 − a
// (exact in one FMA), q0 − r·y.  Equal bit for bit to __fdiv_rn(a, b) when
// div_exact(a, div_lo(b)) holds (and for a = ±0).
__device__ __forceinline__ float div_fast(float a, float b, float y) {
  const float q0 = __fmul_rn(a, y);
  return __fmaf_rn(-__fmaf_rn(b, q0, -a), y, q0);
}

__device__ __forceinline__ bool div_exact(float a, float lo) {
  return fabsf(a) >= lo && fabsf(a) <= kDivHi;
}

// One blob's constants: c = (cx, cy, cz, amp); w = (2·s², −½·__frcp_rn(s²),
// the least r² of the exact path, s²), with s² = __fmul_rn(s, s).
struct Blob {
  float4 c, w;
};

__device__ __forceinline__ Blob make_blob(const float* q) {
  const float s2 = __fmul_rn(q[3], q[3]);
  return {make_float4(q[0], q[1], q[2], q[4]),
          make_float4(__fmul_rn(2.0f, s2), __fmul_rn(-0.5f, __frcp_rn(s2)),
                      __fmul_rn(2.0f, div_lo(s2)), s2)};
}

// (−0.5·r2) / s² by Markstein's correction with a = −r2/2 folded into the
// constants: q0 = r2·(−y/2), 2·(s²·q0 − a) = 2·s²·q0 + r2 (exact),
// q0 + that·(−y/2).  Equal bit for bit to
// __fdiv_rn(__fmul_rn(−0.5f, r2), s²) when gauss_exact(r2, w) holds.
__device__ __forceinline__ float gauss_fast(float r2, const float4& w) {
  const float q0 = __fmul_rn(r2, w.y);
  return __fmaf_rn(__fmaf_rn(w.x, q0, r2), w.y, q0);
}

__device__ __forceinline__ bool gauss_exact(float r2, const float4& w) {
  return r2 >= w.z && r2 <= 2.0f * kDivHi;
}

// a / b and (−0.5·r2) / s², each equal bit for bit to __fdiv_rn: the fast
// path where it is exact, else __fdiv_rn itself.
__device__ __forceinline__ float div_rn(float a, float b, float y, float lo) {
  return div_exact(a, lo) ? div_fast(a, b, y) : __fdiv_rn(a, b);
}

__device__ __forceinline__ float gauss_arg(float r2, const float4& w) {
  return gauss_exact(r2, w) ? gauss_fast(r2, w) : __fdiv_rn(__fmul_rn(-0.5f, r2), w.w);
}

// A launch's constants: μ̄, __frcp_rn(μ̄), div_lo(μ̄) (the least |log1p(−u₀)|
// of the fast path), and lo2, the least r² for which every blob's division
// takes the fast path exactly (+inf when a blob's s² or centre lies outside
// the range the fast path needs).
struct Scene {
  float m, y, lo, lo2;
};

template <int G>
__device__ __forceinline__ Scene make_scene(float maj, const Blob* sb, int g) {
  float lo2 = 2.0f * kDivLo;
#pragma unroll
  for (int b = 0; b < (G > 0 ? G : g); ++b) {
    const Blob& q = sb[b];
    if (!(q.w.z == lo2 && fabsf(q.c.x) <= kBox && fabsf(q.c.y) <= kBox && fabsf(q.c.z) <= kBox))
      lo2 = __int_as_float(0x7f800000);
  }
  return {maj, __frcp_rn(maj), div_lo(maj), lo2};
}

// Shared-memory loads the compiler keeps where they stand: it would hoist
// every blob constant out of the step loop into registers (48 of them at
// G = 6, 80-96 registers a thread, 2-3 blocks an SM), where two 16- or
// 8-byte loads a blob a step cost less than the warps that hoisting loses.
__device__ __forceinline__ float4 lds4(const float4& v) {
  float4 r;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
               : "r"((unsigned)__cvta_generic_to_shared(&v)));
  return r;
}

__device__ __forceinline__ float2 lds2(const float4& v) {
  float2 r;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(r.x), "=f"(r.y)
               : "r"((unsigned)__cvta_generic_to_shared(&v)));
  return r;
}

// σ(p) over the blobs in index order, G > 0 the blob count (0: g).  FAST:
// every blob division takes Markstein's path, and ``exact`` is cleared
// where an r² lies below lo2; else each division takes gauss_arg.
template <int G, bool FAST>
__device__ __forceinline__ float density(float px, float py, float pz, const Blob* sb, int g,
                                         float lo2, bool& exact) {
  float sigma = 0.0f;
#pragma unroll
  for (int b = 0; b < (G > 0 ? G : g); ++b) {
    const float4 c = lds4(sb[b].c);
    const float ex = __fsub_rn(px, c.x), ey = __fsub_rn(py, c.y), ez = __fsub_rn(pz, c.z);
    const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez));
    float arg;
    if (FAST) {
      const float2 w = lds2(sb[b].w);
      exact &= r2 >= lo2;
      arg = gauss_fast(r2, make_float4(w.x, w.y, 0.0f, 0.0f));
    } else {
      arg = gauss_arg(r2, lds4(sb[b].w));
    }
    sigma = __fadd_rn(sigma, __fmul_rn(c.w, expf(arg)));
  }
  return sigma;
}

// One Woodcock step of a ray still tracking, from t with this step's
// uniforms uk: moves t to t_new and returns the status (STILL, HIT or
// EXITED).  Every division takes the fast path, and the step checks once,
// without a branch, that all were exact: |log1p(−u₀)| at least sc.lo, p
// inside ±2^28 (which a non-finite quotient fails too) and every r² at
// least sc.lo2.  Where one was not, the step runs again with exact
// divisions.
template <int G>
__device__ __forceinline__ int woodcock_step(float ox, float oy, float oz, float dx, float dy,
                                             float dz, float te, float& t, float2 uk,
                                             const Blob* sb, int g, const Scene& sc) {
  const float lg = log1pf(-uk.x);
  float t_new = __fsub_rn(t, div_fast(lg, sc.m, sc.y));
  float px = __fadd_rn(ox, __fmul_rn(t_new, dx));
  float py = __fadd_rn(oy, __fmul_rn(t_new, dy));
  float pz = __fadd_rn(oz, __fmul_rn(t_new, dz));
  bool exact = (fabsf(lg) >= sc.lo) & (fabsf(px) <= kBox) & (fabsf(py) <= kBox) &
               (fabsf(pz) <= kBox);
  float sigma = density<G, true>(px, py, pz, sb, g, sc.lo2, exact);
  if (!exact) {
    t_new = __fsub_rn(t, __fdiv_rn(lg, sc.m));
    px = __fadd_rn(ox, __fmul_rn(t_new, dx));
    py = __fadd_rn(oy, __fmul_rn(t_new, dy));
    pz = __fadd_rn(oz, __fmul_rn(t_new, dz));
    sigma = density<G, false>(px, py, pz, sb, g, sc.lo2, exact);
  }
  t = t_new;
  return t_new >= te ? kExited : (__fmul_rn(uk.y, sc.m) < sigma ? kHit : kStill);
}

// One thread a ray (a grid-stride loop past kMaxBlocks blocks).  A ray's
// two uniforms of step k + 1 are loaded as one 8-byte word while step k
// runs.
template <int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks) track_kernel(
    const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ t0,
    const float* __restrict__ t_exit, const float2* __restrict__ u,
    const float* __restrict__ blobs, float* __restrict__ t_out, int32_t* __restrict__ status_out,
    int64_t n, int64_t k_stride, int steps, int g, float maj) {
  extern __shared__ Blob sb[];  // (G,)
  for (int b = threadIdx.x; b < g; b += blockDim.x) sb[b] = make_blob(blobs + 5 * b);
  __syncthreads();
  const Scene sc = make_scene<G>(maj, sb, g);
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float te = t_exit[i];
    const float2* uk_next = u + i * k_stride;
    float t = t0[i];
    int status = kStill;
    float2 uk = steps > 0 ? *uk_next : make_float2(0.0f, 0.0f);
    for (int k = 1; k <= steps && status == kStill; ++k) {
      const float2 ahead = k < steps ? *++uk_next : uk;
      status = woodcock_step<G>(ox, oy, oz, dx, dy, dz, te, t, uk, sb, g, sc);
      uk = ahead;
    }
    t_out[i] = t;
    status_out[i] = status;
  }
}

template <int G>
cudaError_t launch_g(const void* o, const void* d, const void* t0, const void* t_exit,
                     const void* u, const void* blobs, void* t_out, void* status_out, int64_t n,
                     int64_t k_stride, int64_t steps, int64_t g, float maj, int64_t blocks,
                     cudaStream_t stream) {
  const size_t smem = (size_t)g * sizeof(Blob);
  if (blocks <= 0) {  // one thread a ray, as far as kMaxBlocks reaches
    blocks = (n + kThreads - 1) / kThreads;
    blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  }
  track_kernel<G><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const float*)o, (const float*)d, (const float*)t0, (const float*)t_exit,
      (const float2*)u, (const float*)blobs, (float*)t_out, (int32_t*)status_out, n, k_stride,
      (int)steps, (int)g, maj);
  return cudaGetLastError();
}

// The launch at ``blocks`` blocks (0: one thread a ray), the blob loop
// unrolled for G <= 8.
cudaError_t launch_track(const void* o, const void* d, const void* t0, const void* t_exit,
                         const void* u, const void* blobs, void* t_out, void* status_out,
                         int64_t n, int64_t k_stride, int64_t steps, int64_t g, float maj,
                         int64_t blocks, cudaStream_t stream) {
  if (n <= 0) return cudaGetLastError();
#define RAFI_TRACK_G(G)                                                                       \
  case G:                                                                                     \
    return launch_g<G>(o, d, t0, t_exit, u, blobs, t_out, status_out, n, k_stride, steps, g, \
                       maj, blocks, stream);
  switch (g) {
    RAFI_TRACK_G(1)
    RAFI_TRACK_G(2)
    RAFI_TRACK_G(3)
    RAFI_TRACK_G(4)
    RAFI_TRACK_G(5)
    RAFI_TRACK_G(6)
    RAFI_TRACK_G(7)
    RAFI_TRACK_G(8)
    default:
      return launch_g<0>(o, d, t0, t_exit, u, blobs, t_out, status_out, n, k_stride, steps, g,
                         maj, blocks, stream);
  }
#undef RAFI_TRACK_G
}

__global__ void quotients_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                 float* __restrict__ q, float* __restrict__ q_gauss, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float bi = b[i];
    q[i] = div_rn(a[i], bi, __frcp_rn(bi), div_lo(bi));
    // b = s: the blob division (−0.5·a) / (s·s), a taking the role of r²
    const float s[5] = {0.0f, 0.0f, 0.0f, bi, 0.0f};
    q_gauss[i] = gauss_arg(a[i], make_blob(s).w);
  }
}

}  // namespace

// origins, dirs (N, 3), t0, t_exit (N,), uniforms (N, K, 2) on 8 bytes,
// blobs (G, 5) float32 -> t (N,) float32, status (N,) int32; steps <= K.
extern "C" int rafi_track(const void* o, const void* d, const void* t0,
                          const void* t_exit, const void* u, const void* blobs,
                          void* t_out, void* status_out, int64_t n,
                          int64_t k_stride, int64_t steps, int64_t g,
                          float maj, void* stream) {
  return (int)launch_track(o, d, t0, t_exit, u, blobs, t_out, status_out, n, k_stride, steps, g,
                           maj, 0, (cudaStream_t)stream);
}

// The kernel's two divisions, elementwise over (n,) float32, to hold them
// against IEEE division: q = a / b by div_rn, and q_gauss = (−0.5·a) / (b·b)
// by gauss_arg, with b·b rounded as the blob constants round s·s.
extern "C" int rafi_track_quotients(const void* a, const void* b, void* q, void* q_gauss,
                                    int64_t n, void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    quotients_kernel<<<(unsigned)(blocks < 132 * 32 ? blocks : 132 * 32), kThreads, 0,
                       (cudaStream_t)stream>>>((const float*)a, (const float*)b, (float*)q,
                                               (float*)q_gauss, n);
  }
  return (int)cudaGetLastError();
}
