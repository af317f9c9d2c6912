// K10 track's designs side by side, and the checks of its division, for
// tools/k10_variants.py.
//
// It includes csrc/delta_tracking.cu, so the shipped kernel (rafi_track and
// its launcher launch_track) and its helpers (make_blob, the divisions,
// density, woodcock_step) are the port's own.  Beside them:
//   - rafi_track_parent: the kernel the port shipped before, verbatim: one
//     thread a ray, __fdiv_rn in every division and s·s in every blob term;
//   - rafi_track_variant: the shipped arithmetic with other thread maps and
//     loads: at_use (one thread a ray, a step's uniforms as two 4-byte loads
//     at the step), refill (no idle lanes: lane refill over a span of rays
//     a warp, a new ray loaded when a lane takes it) and refill with the
//     next ray held (loaded while the lane's current ray runs);
//   - rafi_track_blocks: the shipped kernel at a given grid, and with the
//     blob loop left to run time (unrolled = 0);
//   - fast_only_kernel, never launched: the shipped step without its rare
//     exact pass, so its SASS counts what a step executes;
//   - rafi_track_blocks_per_sm: resident blocks an SM of three designs;
//   - rafi_div_sweep and rafi_div_random: count the quotients where the
//     kernel's divisions differ from __fdiv_rn in any bit, over every float
//     of a range at given divisors, and over random pairs.
#include "../src/repro_torch/kernels/csrc/delta_tracking.cu"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- parent
constexpr int64_t kParentMaxBlocks = 132 * 32;

__global__ void parent_kernel(const float* __restrict__ o,
                              const float* __restrict__ d,
                              const float* __restrict__ t0,
                              const float* __restrict__ t_exit,
                              const float* __restrict__ u,
                              const float* __restrict__ blobs,
                              float* __restrict__ t_out,
                              int32_t* __restrict__ status_out, int64_t n,
                              int64_t k_stride, int64_t steps, int64_t g,
                              float maj) {
  extern __shared__ float parent_sb[];  // (G, 5); its own name, as its type differs
  float* sb = parent_sb;
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

// ---------------------------------------------------------------- at_use
// The shipped thread map and arithmetic with the parent's loads: a step's
// two uniforms as two 4-byte loads at the step that uses them.
template <int G>
__global__ void __launch_bounds__(kThreads) at_use_kernel(
    const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ t0,
    const float* __restrict__ t_exit, const float* __restrict__ u,
    const float* __restrict__ blobs, float* __restrict__ t_out, int32_t* __restrict__ status_out,
    int64_t n, int64_t k_stride, int steps, int g, float maj) {
  extern __shared__ Blob sb[];
  for (int b = threadIdx.x; b < g; b += blockDim.x) sb[b] = make_blob(blobs + 5 * b);
  __syncthreads();
  const Scene sc = make_scene<G>(maj, sb, g);
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float te = t_exit[i];
    const float* ui = u + i * k_stride * 2;
    float t = t0[i];
    int status = kStill;
    for (int k = 0; k < steps && status == kStill; ++k)
      status = woodcock_step<G>(ox, oy, oz, dx, dy, dz, te, t, make_float2(ui[2 * k], ui[2 * k + 1]),
                                sb, g, sc);
    t_out[i] = t;
    status_out[i] = status;
  }
}

// ------------------------------------------------------------- fast_only
// The shipped kernel's step without the rare exact pass: never launched (it
// would be wrong where a division leaves the fast path's range); its SASS
// is what a step of the shipped kernel executes.
template <int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks) fast_only_kernel(
    const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ t0,
    const float* __restrict__ t_exit, const float2* __restrict__ u,
    const float* __restrict__ blobs, float* __restrict__ t_out, int32_t* __restrict__ status_out,
    int64_t n, int64_t k_stride, int steps, int g, float maj) {
  extern __shared__ Blob sb[];
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
    bool exact = true;
    for (int k = 1; k <= steps && status == kStill; ++k) {
      const float2 ahead = k < steps ? *++uk_next : uk;
      const float lg = log1pf(-uk.x);
      const float t_new = __fsub_rn(t, div_fast(lg, sc.m, sc.y));
      const float px = __fadd_rn(ox, __fmul_rn(t_new, dx));
      const float py = __fadd_rn(oy, __fmul_rn(t_new, dy));
      const float pz = __fadd_rn(oz, __fmul_rn(t_new, dz));
      exact &= (fabsf(lg) >= sc.lo) & (fabsf(px) <= kBox) & (fabsf(py) <= kBox) &
               (fabsf(pz) <= kBox);
      const float sigma = density<G, true>(px, py, pz, sb, g, sc.lo2, exact);
      t = t_new;
      status = t_new >= te ? kExited : (__fmul_rn(uk.y, sc.m) < sigma ? kHit : kStill);
      uk = ahead;
    }
    t_out[i] = t;
    status_out[i] = status + !exact;
  }
}

// ---------------------------------------------------------------- refill
// No idle lanes: each warp owns a span of ceil(N / warps) rays and keeps 32
// in flight; a lane whose ray stops (a status change, or its K steps done)
// stores it and takes the span's next ray not yet started (__ballot_sync,
// __popc).  PEND: each lane also holds its next ray, loaded while the
// current one runs, so a new ray starts without waiting on its loads; else
// a lane loads its new ray when it takes it.
struct Ray {
  float ox, oy, oz, dx, dy, dz, te, t;
  float2 uk;
  int64_t i;
};

__device__ __forceinline__ void load_ray(Ray& r, int64_t i, const float* o, const float* d,
                                         const float* t0, const float* t_exit, const float2* u,
                                         int64_t k_stride) {
  r.i = i;
  r.ox = o[3 * i], r.oy = o[3 * i + 1], r.oz = o[3 * i + 2];
  r.dx = d[3 * i], r.dy = d[3 * i + 1], r.dz = d[3 * i + 2];
  r.t = t0[i], r.te = t_exit[i];
  r.uk = u[i * k_stride];
}

template <int G, bool PEND>
__global__ void __launch_bounds__(kThreads) refill_kernel(
    const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ t0,
    const float* __restrict__ t_exit, const float2* __restrict__ u,
    const float* __restrict__ blobs, float* __restrict__ t_out, int32_t* __restrict__ status_out,
    int64_t n, int64_t k_stride, int steps, int g, float maj, int64_t span) {
  extern __shared__ Blob sb[];
  for (int b = threadIdx.x; b < g; b += blockDim.x) sb[b] = make_blob(blobs + 5 * b);
  __syncthreads();
  const Scene sc = make_scene<G>(maj, sb, g);
  const unsigned lane_lt = (1u << (threadIdx.x & 31)) - 1u;
  const int64_t warp = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  int64_t next = warp * span;
  const int64_t end = next + span < n ? next + span : n;
  Ray cur, pend;
  int k = 0;
  bool live = false, has = false;
  for (;;) {
    if (PEND && !live && has) cur = pend, live = true, has = false, k = 0;
    const bool want = PEND ? !has : !live;
    const unsigned req = __ballot_sync(kFull, want);
    if (req != 0u && next < end) {
      const int64_t j = next + __popc(req & lane_lt);
      if (want && j < end) {
        if (PEND) {
          load_ray(pend, j, o, d, t0, t_exit, u, k_stride);
          has = true;
        } else {
          load_ray(cur, j, o, d, t0, t_exit, u, k_stride);
          live = true, k = 0;
        }
      }
      next += __popc(req);
    }
    if (PEND && !live && has) cur = pend, live = true, has = false, k = 0;
    if (next >= end && !__any_sync(kFull, live || has)) break;
    if (!live) continue;
    const float2 ahead = k + 1 < steps ? u[cur.i * k_stride + k + 1] : cur.uk;
    const int status = woodcock_step<G>(cur.ox, cur.oy, cur.oz, cur.dx, cur.dy, cur.dz, cur.te,
                                        cur.t, cur.uk, sb, g, sc);
    cur.uk = ahead;
    if (status != kStill || ++k == steps) {
      t_out[cur.i] = cur.t;
      status_out[cur.i] = status;
      live = false;
    }
  }
}

// ------------------------------------------------------------ the divisions
__device__ __forceinline__ uint64_t splitmix(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

// bad[0] += quotients a / b with div_rn != __fdiv_rn, bad[1] += (−0.5·a) / s²
// with gauss_arg != __fdiv_rn(__fmul_rn(−0.5, a), s·s), at a = −x (the
// division) and a = x (the blob term, x as r²).
__device__ __forceinline__ void count_pair(float x, float b, float s, unsigned long long& bad_div,
                                           unsigned long long& bad_gauss) {
  const float a = -x;
  bad_div += __float_as_uint(div_rn(a, b, __frcp_rn(b), div_lo(b))) !=
             __float_as_uint(__fdiv_rn(a, b));
  const float blob[5] = {0.0f, 0.0f, 0.0f, s, 0.0f};
  bad_gauss += __float_as_uint(gauss_arg(x, make_blob(blob).w)) !=
               __float_as_uint(__fdiv_rn(__fmul_rn(-0.5f, x), __fmul_rn(s, s)));
}

// Every float x in [0, x_hi] (bit patterns 0 .. x_hi_bits) against the
// divisor div and the blob size s.
__global__ void div_sweep_kernel(uint32_t x_hi_bits, float div, float s,
                                 unsigned long long* __restrict__ bad) {
  unsigned long long bd = 0, bg = 0;
  for (uint64_t bits = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x; bits <= x_hi_bits;
       bits += (uint64_t)gridDim.x * blockDim.x)
    count_pair(__uint_as_float((uint32_t)bits), div, s, bd, bg);
  if (bd) atomicAdd(bad, bd);
  if (bg) atomicAdd(bad + 1, bg);
}

// n random pairs: x = x_hi·2^(−e·v)·(1 − w/2) (v, w uniform, e = x_octaves), the divisor
// log-uniform in [div_lo, div_hi], s uniform in [s_lo, s_hi].
__global__ void div_random_kernel(uint64_t seed, int64_t n, float x_hi, float x_octaves,
                                  float dlo, float dhi, float s_lo, float s_hi,
                                  unsigned long long* __restrict__ bad) {
  unsigned long long bd = 0, bg = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint64_t h = splitmix(seed ^ (uint64_t)i);
    float v[4];
    for (int j = 0; j < 4; ++j, h = splitmix(h)) v[j] = (float)(h >> 40) * 0x1p-24f;
    const float x = x_hi * exp2f(-x_octaves * v[0]) * (1.0f - 0.5f * v[1]);
    const float b = dlo * exp2f(log2f(dhi / dlo) * v[2]);
    count_pair(x, b, s_lo + (s_hi - s_lo) * v[3], bd, bg);
  }
  if (bd) atomicAdd(bad, bd);
  if (bg) atomicAdd(bad + 1, bg);
}

// which: 0 at_use (at ``blocks``, 0: one thread a ray); 1 refill; 2 refill
// with the next ray held (both at ``blocks``, 0: the resident blocks).
template <int G>
cudaError_t launch_variant(int which, const void* o, const void* d, const void* t0,
                           const void* t_exit, const void* u, const void* blobs, void* t_out,
                           void* status_out, int64_t n, int64_t k_stride, int64_t steps,
                           int64_t g, float maj, int64_t blocks, cudaStream_t stream) {
  const size_t smem = (size_t)g * sizeof(Blob);
  const int64_t need = (n + kThreads - 1) / kThreads;
  if (which == 0) {
    if (blocks <= 0) blocks = need < kMaxBlocks ? need : kMaxBlocks;
    at_use_kernel<G><<<(unsigned)blocks, kThreads, smem, stream>>>(
        (const float*)o, (const float*)d, (const float*)t0, (const float*)t_exit,
        (const float*)u, (const float*)blobs, (float*)t_out, (int32_t*)status_out, n, k_stride,
        (int)steps, (int)g, maj);
    return cudaGetLastError();
  }
  auto kernel = which == 1 ? &refill_kernel<G, false> : &refill_kernel<G, true>;
  if (blocks <= 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    blocks = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  }
  blocks = blocks < need ? blocks : need;
  const int64_t warps = blocks * kWarps, span = (n + warps - 1) / warps;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const float*)o, (const float*)d, (const float*)t0, (const float*)t_exit,
      (const float2*)u, (const float*)blobs, (float*)t_out, (int32_t*)status_out, n, k_stride,
      (int)steps, (int)g, maj, span);
  return cudaGetLastError();
}

}  // namespace

#define RAFI_TRACK_ARGS                                                                         \
  const void *o, const void *d, const void *t0, const void *t_exit, const void *u,              \
      const void *blobs, void *t_out, void *status_out, int64_t n, int64_t k_stride,            \
      int64_t steps, int64_t g, float maj
#define RAFI_TRACK_PASS o, d, t0, t_exit, u, blobs, t_out, status_out, n, k_stride, steps, g, maj

// Keeps fast_only_kernel<6> in the library for its SASS; never called.
extern "C" void* rafi_track_fast_only() { return (void*)&fast_only_kernel<6>; }

extern "C" int rafi_track_parent(RAFI_TRACK_ARGS, void* stream) {
  if (n > 0) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    blocks = blocks < kParentMaxBlocks ? blocks : kParentMaxBlocks;
    const size_t smem = (size_t)g * 5 * sizeof(float);
    parent_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const float*)t0, (const float*)t_exit,
        (const float*)u, (const float*)blobs, (float*)t_out, (int32_t*)status_out,
        n, k_stride, steps, g, maj);
  }
  return (int)cudaGetLastError();
}

// The variants at ``blocks`` blocks (0: their default); the blob loop
// unrolled for G = 6, else at run time.
extern "C" int rafi_track_variant(int which, RAFI_TRACK_ARGS, int64_t blocks, void* stream) {
  if (n <= 0) return 0;
  return (int)(g == 6 ? launch_variant<6>(which, RAFI_TRACK_PASS, blocks, (cudaStream_t)stream)
                      : launch_variant<0>(which, RAFI_TRACK_PASS, blocks, (cudaStream_t)stream));
}

// The shipped kernel at ``blocks`` blocks (0: from occupancy); unrolled = 0
// leaves the blob loop to run time whatever G is.
extern "C" int rafi_track_blocks(RAFI_TRACK_ARGS, int64_t blocks, int unrolled, void* stream) {
  if (n <= 0) return 0;
  if (unrolled) return (int)launch_track(RAFI_TRACK_PASS, blocks, (cudaStream_t)stream);
  return (int)launch_g<0>(RAFI_TRACK_PASS, blocks, (cudaStream_t)stream);
}

// Blocks resident on an SM at g = 6 blobs (the occupancy API): which = 0
// the shipped kernel, 1 refill, 2 refill with the next ray held.
extern "C" int rafi_track_blocks_per_sm(int which) {
  int per_sm = 0;
  const size_t smem = 6 * sizeof(Blob);
  if (which == 0) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, track_kernel<6>, kThreads, smem);
  if (which == 1) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, refill_kernel<6, false>, kThreads, smem);
  if (which == 2) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, refill_kernel<6, true>, kThreads, smem);
  return per_sm;
}

extern "C" int rafi_div_sweep(uint32_t x_hi_bits, float div, float s, void* bad, void* stream) {
  div_sweep_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(x_hi_bits, div, s,
                                                               (unsigned long long*)bad);
  return (int)cudaGetLastError();
}

extern "C" int rafi_div_random(uint64_t seed, int64_t n, float x_hi, float x_octaves, float dlo,
                               float dhi, float s_lo, float s_hi, void* bad, void* stream) {
  div_random_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(
      seed, n, x_hi, x_octaves, dlo, dhi, s_lo, s_hi, (unsigned long long*)bad);
  return (int)cudaGetLastError();
}
