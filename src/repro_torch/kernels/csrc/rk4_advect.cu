// K8 rk4_step — one RK4 step per particle on an analytic field, for sm_90a.
//
// Replaces: src/repro/kernels/rk4_advect/kernel.py, rk4_step (the Pallas
// kernel _rk4_kernel).
//
// Computes, for pos (N, 3) float32:
//   k1 = v(p); k2 = v(p + h*k1); k3 = v(p + h*k2); k4 = v(p + dt*k3)
//   new_pos = p + dt6 * (((k1 + 2*k2) + 2*k3) + k4);  vel = k1
// with h = 0.5*dt and dt6 = dt/6 rounded to float32 by the caller, and v one
// of three fields chosen at run time: 0 ABC, 1 tornado, 2 Taylor-Green,
// with parameters (a, b, c).  The operation order follows the Pallas
// kernel.  Built without --use_fast_math, so sinf/cosf/sqrtf stay
// IEEE-accurate; nvcc may still contract a*b + c into one FMA, which is why
// the kernel agrees with the plain PyTorch version to 1e-5, not bit for bit.
//
// Bound on the H100: bytes (12 B read, 24 B written per particle) against
// about 60 float32 operations and 24 sin/cos per particle, well under the
// card's float32 rate at this byte count.
//
// Design: one thread per particle, grid-stride; the three coordinates are
// read as scalars (a 12-byte stride).  A later PR could read positions as
// float4 through shared memory or fuse the trace write of the app.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 64;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 velocity(float x, float y, float z, int field,
                                       float a, float b, float c) {
  switch (field) {
    case 0:  // ABC
      return {a * sinf(z) + c * cosf(y), b * sinf(x) + a * cosf(z),
              c * sinf(y) + b * cosf(x)};
    case 1: {  // tornado
      const float r2 = x * x + y * y + 1e-3f;
      const float swirl = a / r2;
      return {-y * swirl, x * swirl, b + c * sqrtf(r2)};
    }
    default:  // Taylor-Green
      return {a * cosf(x) * sinf(y) * sinf(z), -a * sinf(x) * cosf(y) * sinf(z),
              c * sinf(x) * sinf(y) * cosf(z)};
  }
}

__global__ void rk4_kernel(const float* __restrict__ pos,
                           float* __restrict__ new_pos,
                           float* __restrict__ vel, int64_t n, int field,
                           float h, float dt, float dt6, float a, float b,
                           float c) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float px = pos[3 * i], py = pos[3 * i + 1], pz = pos[3 * i + 2];
    const V3 k1 = velocity(px, py, pz, field, a, b, c);
    const V3 k2 = velocity(px + h * k1.x, py + h * k1.y, pz + h * k1.z, field, a, b, c);
    const V3 k3 = velocity(px + h * k2.x, py + h * k2.y, pz + h * k2.z, field, a, b, c);
    const V3 k4 = velocity(px + dt * k3.x, py + dt * k3.y, pz + dt * k3.z, field, a, b, c);
    new_pos[3 * i] = px + dt6 * (((k1.x + 2.0f * k2.x) + 2.0f * k3.x) + k4.x);
    new_pos[3 * i + 1] = py + dt6 * (((k1.y + 2.0f * k2.y) + 2.0f * k3.y) + k4.y);
    new_pos[3 * i + 2] = pz + dt6 * (((k1.z + 2.0f * k2.z) + 2.0f * k3.z) + k4.z);
    vel[3 * i] = k1.x;
    vel[3 * i + 1] = k1.y;
    vel[3 * i + 2] = k1.z;
  }
}

}  // namespace

// pos (N, 3) float32 -> new_pos (N, 3), vel (N, 3) float32.
extern "C" int rafi_rk4_step(const void* pos, void* new_pos, void* vel,
                             int64_t n, int field, float h, float dt, float dt6,
                             float a, float b, float c, void* stream) {
  if (n > 0) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
    rk4_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)pos, (float*)new_pos, (float*)vel, n, field, h, dt, dt6,
        a, b, c);
  }
  return (int)cudaGetLastError();
}
