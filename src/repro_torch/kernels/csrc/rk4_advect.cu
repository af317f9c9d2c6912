// K8 rk4_step — one RK4 step per particle on an analytic field, for sm_90a.
//
// Replaces: src/repro/kernels/rk4_advect/kernel.py, rk4_step (the Pallas
// kernel _rk4_kernel).
//
// Computes, for pos (N, 3) float32:
//   k1 = v(p); k2 = v(p + h*k1); k3 = v(p + h*k2); k4 = v(p + dt*k3)
//   new_pos = p + dt6 * (((k1 + 2*k2) + 2*k3) + k4);  vel = k1
// with h = 0.5*dt and dt6 = dt/6 rounded to float32 by the caller, and v one
// of three fields: 0 ABC, 1 tornado, 2 Taylor-Green, with parameters
// (a, b, c).  The operation order follows the Pallas kernel; the products
// that feed a sum are fused (one rounding, not two), so the kernel agrees
// with the plain PyTorch version to 1e-5, not bit for bit.
//
// Bound on the H100: bytes (12 B read, 24 B written a particle: 0.0113 ms
// at 1,048,576 particles), with instruction issue close behind: an
// IEEE-accurate sine or cosine is a range reduction, a branch to the slow
// path for large arguments and a polynomial.
//
// Design:
//   - each evaluation of the ABC or Taylor-Green field needs the sine and
//     cosine of x, y and z: three sincosf calls share one range reduction a
//     coordinate, where sinf and cosf made six (ABC) or nine
//     (Taylor-Green) calls.  No fast math and no __sinf: IEEE accuracy;
//   - the arithmetic is written out with __fmaf_rn, __fmul_rn, __fadd_rn,
//     __fdiv_rn and __fsqrt_rn, which nvcc neither contracts nor splits, so
//     a particle's result does not depend on its thread, its slot in the
//     thread or the path its bytes took (the streamlines oracle holds a
//     particle bit for bit across ranks, where it sits in another lane);
//   - the bytes move in bulk: a block stages its tile of 1,024 particles
//     (12,288 bytes) in shared memory with Hopper's 1-D bulk copy
//     (cp.async.bulk, completing on an mbarrier), each thread computes 4
//     particles from shared memory (a stride of 3 words: no bank
//     conflicts), writes both outputs back to shared memory, and one
//     thread stores the two tiles with two bulk copies.  A ragged last
//     tile, or a pointer off a 16-byte boundary (a view), moves through the
//     same shared tiles in 4-byte accesses.  The kernel needs 32 registers,
//     so 64 warps an SM hide the latency of the copies and of the trig.
//     (A design with 4 particles a thread in 16-byte loads and stores
//     straight from device memory measured slower; tools/k8_io_variants.py
//     times both);
//   - the field is a template argument: no branch in the particle loop.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct V3 {
  float x, y, z;
};

template <int FIELD>
__device__ __forceinline__ V3 velocity(float x, float y, float z, float a, float b, float c) {
  if (FIELD == 1) {  // tornado
    const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), 1e-3f);
    const float swirl = __fdiv_rn(a, r2);
    return {__fmul_rn(-y, swirl), __fmul_rn(x, swirl), __fmaf_rn(c, __fsqrt_rn(r2), b)};
  }
  float sx, cx, sy, cy, sz, cz;
  sincosf(x, &sx, &cx);
  sincosf(y, &sy, &cy);
  sincosf(z, &sz, &cz);
  if (FIELD == 0)  // ABC
    return {__fmaf_rn(a, sz, __fmul_rn(c, cy)), __fmaf_rn(b, sx, __fmul_rn(a, cz)),
            __fmaf_rn(c, sy, __fmul_rn(b, cx))};
  // Taylor-Green
  return {__fmul_rn(__fmul_rn(__fmul_rn(a, cx), sy), sz),
          __fmul_rn(__fmul_rn(__fmul_rn(-a, sx), cy), sz),
          __fmul_rn(__fmul_rn(__fmul_rn(c, sx), sy), cz)};
}

// One particle: p[0..2] -> np[0..2] (new position), v[0..2] (k1).
template <int FIELD>
__device__ __forceinline__ void rk4_particle(const float* p, float* np, float* v, float h,
                                             float dt, float dt6, float a, float b, float c) {
  const V3 k1 = velocity<FIELD>(p[0], p[1], p[2], a, b, c);
  const V3 k2 = velocity<FIELD>(__fmaf_rn(h, k1.x, p[0]), __fmaf_rn(h, k1.y, p[1]),
                                __fmaf_rn(h, k1.z, p[2]), a, b, c);
  const V3 k3 = velocity<FIELD>(__fmaf_rn(h, k2.x, p[0]), __fmaf_rn(h, k2.y, p[1]),
                                __fmaf_rn(h, k2.z, p[2]), a, b, c);
  const V3 k4 = velocity<FIELD>(__fmaf_rn(dt, k3.x, p[0]), __fmaf_rn(dt, k3.y, p[1]),
                                __fmaf_rn(dt, k3.z, p[2]), a, b, c);
  np[0] = __fmaf_rn(dt6, __fadd_rn(__fmaf_rn(2.0f, k3.x, __fmaf_rn(2.0f, k2.x, k1.x)), k4.x), p[0]);
  np[1] = __fmaf_rn(dt6, __fadd_rn(__fmaf_rn(2.0f, k3.y, __fmaf_rn(2.0f, k2.y, k1.y)), k4.y), p[1]);
  np[2] = __fmaf_rn(dt6, __fadd_rn(__fmaf_rn(2.0f, k3.z, __fmaf_rn(2.0f, k2.z, k1.z)), k4.z), p[2]);
  v[0] = k1.x;
  v[1] = k1.y;
  v[2] = k1.z;
}

constexpr int kTileParticles = 4 * kThreads;
constexpr uint32_t kTileBytes = kTileParticles * 12;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Block t takes particles 1024 t .. 1024 t + 1023; thread i of the block
// particles i, i + 256, i + 512 and i + 768 of the tile.
template <int FIELD>
__global__ void __launch_bounds__(kThreads) rk4_kernel(
    const float* __restrict__ pos, float* __restrict__ new_pos, float* __restrict__ vel,
    int64_t n, bool aligned, float h, float dt, float dt6, float a, float b, float c) {
  __shared__ alignas(128) float s_pos[3 * kTileParticles];
  __shared__ alignas(128) float s_vel[3 * kTileParticles];
  __shared__ alignas(8) unsigned long long bar;
  const int64_t first = (int64_t)blockIdx.x * kTileParticles;
  const int64_t m = n - first < kTileParticles ? n - first : kTileParticles;
  const bool bulk = aligned && m == kTileParticles;
  const uint32_t bar_a = smem_addr(&bar);
  if (bulk) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_a));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_a),
                   "r"(kTileBytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          ::"r"(smem_addr(s_pos)), "l"(pos + 3 * first), "r"(kTileBytes), "r"(bar_a) : "memory");
    }
    __syncthreads();  // the barrier is initialised before anyone waits on it
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0; "
          "selp.u32 %0, 1, 0, p; }"
          : "=r"(done) : "r"(bar_a) : "memory");
    }
  } else {
    for (int64_t i = threadIdx.x; i < 3 * m; i += kThreads) s_pos[i] = pos[3 * first + i];
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < m) {
      float p[3] = {s_pos[3 * i], s_pos[3 * i + 1], s_pos[3 * i + 2]}, np[3], v[3];
      rk4_particle<FIELD>(p, np, v, h, dt, dt6, a, b, c);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        s_pos[3 * i + j] = np[j];  // a thread rewrites only its own particles
        s_vel[3 * i + j] = v[j];
      }
    }
  }
  if (bulk) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to the bulk copy
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   ::"l"(new_pos + 3 * first), "r"(smem_addr(s_pos)), "r"(kTileBytes) : "memory");
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   ::"l"(vel + 3 * first), "r"(smem_addr(s_vel)), "r"(kTileBytes) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // shared memory stays live
    }
  } else {
    __syncthreads();
    for (int64_t i = threadIdx.x; i < 3 * m; i += kThreads) {
      new_pos[3 * first + i] = s_pos[i];
      vel[3 * first + i] = s_vel[i];
    }
  }
}

}  // namespace

// pos (N, 3) float32 -> new_pos (N, 3), vel (N, 3) float32; pos may start
// anywhere a float may (a view), the outputs too.  N < 2^31 * 1024.
extern "C" int rafi_rk4_step(const void* pos, void* new_pos, void* vel, int64_t n, int field,
                             float h, float dt, float dt6, float a, float b, float c,
                             void* stream) {
  if (field < 0 || field > 2) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int64_t blocks = (n + kTileParticles - 1) / kTileParticles;
    const bool aligned = ((uintptr_t)pos | (uintptr_t)new_pos | (uintptr_t)vel) % 16 == 0;
    auto kernel = field == 0 ? rk4_kernel<0> : field == 1 ? rk4_kernel<1> : rk4_kernel<2>;
    kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)pos, (float*)new_pos, (float*)vel, n, aligned, h, dt, dt6, a, b, c);
  }
  return (int)cudaGetLastError();
}
