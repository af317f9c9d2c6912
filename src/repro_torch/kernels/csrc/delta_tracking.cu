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
// Bound on the H100: bytes.  Per ray 12 + 12 + 4 + 4 B in, 8·K B of
// uniforms, 8 B out: 104 B at K = 8; the arithmetic (about 10·G operations
// and G expf a step) is small beside it at the VoPaT scene's G = 6.
//
// Design: one thread per ray, grid-stride; the blobs are copied to shared
// memory once per block.  Every operation is an explicitly rounded
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn) in the plain
// version's order, so nvcc contracts nothing into an FMA; expf and log1pf
// are the IEEE-accurate CUDA math functions (no --use_fast_math), the same
// ones torch's elementwise kernels call on the card.  A ray that is no
// longer STILL skips its density evaluation: the reference computes it and
// throws it away.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;
constexpr int kStill = 0, kHit = 1, kExited = 2;

__global__ void track_kernel(const float* __restrict__ o,
                             const float* __restrict__ d,
                             const float* __restrict__ t0,
                             const float* __restrict__ t_exit,
                             const float* __restrict__ u,
                             const float* __restrict__ blobs,
                             float* __restrict__ t_out,
                             int32_t* __restrict__ status_out, int64_t n,
                             int64_t k_stride, int64_t steps, int64_t g,
                             float maj) {
  extern __shared__ float sb[];  // (G, 5)
  for (int64_t k = threadIdx.x; k < g * 5; k += blockDim.x) sb[k] = blobs[k];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float te = t_exit[i];
    const float* ui = u + i * k_stride * 2;
    float t = t0[i];
    int32_t status = kStill;
    for (int64_t k = 0; k < steps && status == kStill; ++k) {
      const float u0 = ui[2 * k], u1 = ui[2 * k + 1];
      const float t_new = __fsub_rn(t, __fdiv_rn(log1pf(-u0), maj));
      const float px = __fadd_rn(ox, __fmul_rn(t_new, dx));
      const float py = __fadd_rn(oy, __fmul_rn(t_new, dy));
      const float pz = __fadd_rn(oz, __fmul_rn(t_new, dz));
      float sigma = 0.0f;
      for (int64_t b = 0; b < g; ++b) {
        const float* q = sb + 5 * b;
        const float ex = __fsub_rn(px, q[0]), ey = __fsub_rn(py, q[1]),
                    ez = __fsub_rn(pz, q[2]);
        const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                                   __fmul_rn(ez, ez));
        const float e = expf(__fdiv_rn(__fmul_rn(-0.5f, r2), __fmul_rn(q[3], q[3])));
        sigma = __fadd_rn(sigma, __fmul_rn(q[4], e));
      }
      if (t_new >= te) {
        status = kExited;
      } else if (__fmul_rn(u1, maj) < sigma) {
        status = kHit;
      }
      t = t_new;
    }
    t_out[i] = t;
    status_out[i] = status;
  }
}

}  // namespace

// origins, dirs (N, 3), t0, t_exit (N,), uniforms (N, K, 2), blobs (G, 5)
// float32 -> t (N,) float32, status (N,) int32; steps <= K.
extern "C" int rafi_track(const void* o, const void* d, const void* t0,
                          const void* t_exit, const void* u, const void* blobs,
                          void* t_out, void* status_out, int64_t n,
                          int64_t k_stride, int64_t steps, int64_t g,
                          float maj, void* stream) {
  if (n > 0) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
    const size_t smem = (size_t)g * 5 * sizeof(float);
    track_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const float*)t0, (const float*)t_exit,
        (const float*)u, (const float*)blobs, (float*)t_out, (int32_t*)status_out,
        n, k_stride, steps, g, maj);
  }
  return (int)cudaGetLastError();
}
