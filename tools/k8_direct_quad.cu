// K8 rk4_step with the other I/O design, kept to time it beside the one the
// port ships (tools/k8_io_variants.py builds and times both).
//
// It includes csrc/rk4_advect.cu, so its arithmetic (rk4_particle) is the
// port's and only the way the bytes move differs: the grid's thread i
// (grid-stride) takes particles 4i .. 4i+3, 48 bytes, straight from device
// memory as three 16-byte loads, and stores three 16-byte words to each
// output, where the base lies on 16 bytes (a warp's accesses cover 1,536
// contiguous bytes); the last 4-particle group of a ragged N, and a pos off
// a 16-byte boundary, take 4-byte accesses.
#include "../src/repro_torch/kernels/csrc/rk4_advect.cu"

namespace {

constexpr int64_t kMaxBlocks = 132 * 64;

template <int FIELD>
__global__ void __launch_bounds__(kThreads) rk4_quad_kernel(
    const float* __restrict__ pos, float* __restrict__ new_pos, float* __restrict__ vel,
    int64_t n, bool vec_in, bool vec_out, float h, float dt, float dt6, float a, float b,
    float c) {
  const int64_t groups = (n + 3) / 4, floats = 3 * n;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += (int64_t)gridDim.x * blockDim.x) {
    const int64_t f0 = 12 * g;
    const bool whole = f0 + 12 <= floats;
    float p[12], np[12], v[12];
    if (whole && vec_in) {
      const float4* src = reinterpret_cast<const float4*>(pos + f0);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float4 w = __ldg(src + j);
        p[4 * j] = w.x;
        p[4 * j + 1] = w.y;
        p[4 * j + 2] = w.z;
        p[4 * j + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 12; ++j) p[j] = f0 + j < floats ? pos[f0 + j] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      rk4_particle<FIELD>(p + 3 * k, np + 3 * k, v + 3 * k, h, dt, dt6, a, b, c);
    if (whole && vec_out) {
      float4* dn = reinterpret_cast<float4*>(new_pos + f0);
      float4* dv = reinterpret_cast<float4*>(vel + f0);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        dn[j] = make_float4(np[4 * j], np[4 * j + 1], np[4 * j + 2], np[4 * j + 3]);
        dv[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        if (f0 + j < floats) {
          new_pos[f0 + j] = np[j];
          vel[f0 + j] = v[j];
        }
      }
    }
  }
}

}  // namespace

// The signature of rafi_rk4_step.
extern "C" int rafi_rk4_step_quad(const void* pos, void* new_pos, void* vel, int64_t n,
                                  int field, float h, float dt, float dt6, float a, float b,
                                  float c, void* stream) {
  if (field < 0 || field > 2) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    int64_t blocks = ((n + 3) / 4 + kThreads - 1) / kThreads;
    blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
    const bool vec_in = (uintptr_t)pos % 16 == 0;
    const bool vec_out = (uintptr_t)new_pos % 16 == 0 && (uintptr_t)vel % 16 == 0;
    auto kernel = field == 0 ? rk4_quad_kernel<0> : field == 1 ? rk4_quad_kernel<1>
                                                               : rk4_quad_kernel<2>;
    kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)pos, (float*)new_pos, (float*)vel, n, vec_in, vec_out, h, dt, dt6, a, b, c);
  }
  return (int)cudaGetLastError();
}
