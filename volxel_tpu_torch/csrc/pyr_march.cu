// DDA null-collision march over the premultiplied majorant pyramid.
//
// Replaces the Pallas kernel volxel_tpu/render/pyrmarch.py: pyr_march ->
// _pyr_march_call, kernel from _kernel_factory. Plain version:
// volxel_tpu_torch/render/pyrmarch.py: pyr_march_plain.
//
// What bounds it on an H100: latency, not bytes or FLOPs. A step is one
// dependent 4-byte fetch from the stacked pyramid (4 MiB at 512^3, so it
// stays in the 50 MB L2 after the first touch) followed by ~40 scalar f32
// ops whose result decides the next fetch's address. Lanes diverge: a ray
// through empty space parks after a few coarse steps, one through tissue
// takes dozens of fine ones (the 1024-step cap bounds the worst).
//
// Design: one thread per ray, 128 threads a block, no shared memory. The
// TPU kernel needed the pyramid resident in VMEM and each fetch as a
// one-hot int8 matrix product because Mosaic cannot gather; here a fetch
// is a read-only-cache load (__ldg) of the f32 table, and many resident
// warps hide its latency. Each thread leaves the loop as soon as its ray
// parks, so a warp costs its slowest lane, not the wavefront's. Every f32
// operation is written in the order of the plain version and the library
// is built with --fmad=false, so nothing is contracted into an FMA and the
// parked states are bit-equal to the plain version on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kKindIdle = 0;
constexpr int kKindColl = 1;
constexpr int kKindDone = 2;
constexpr int kThreads = 128;

// torch.minimum / torch.clamp_min semantics: a NaN operand gives NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// one axis of the DDA step: distance along the ray to the next brick
// boundary at cell size `dim` (dda.glsl:10-16)
__device__ __forceinline__ float axis_step(float c, float dim, float r) {
  const float off = r >= 0.0f ? dim + 0.5f : -0.5f;
  return (floorf(c / dim) * dim + off - c) * r;
}

__global__ void __launch_bounds__(kThreads) pyr_march_kernel(
    const float* __restrict__ maj, int bz, int by, int bx, int ex, int ey, int ez,
    const float* __restrict__ ipos, const float* __restrict__ idir, const float* __restrict__ ri,
    const float* __restrict__ t_in, const float* __restrict__ tau_in, const float* __restrict__ mip_in,
    const float* __restrict__ far_in, const int* __restrict__ budget_in,
    const bool* __restrict__ running_in, float* __restrict__ t_out, float* __restrict__ tau_out,
    float* __restrict__ mip_out, float* __restrict__ maj_out, int* __restrict__ kind_out,
    int* __restrict__ budget_out, int n, int steps_cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = t_in[i];
  float tau = tau_in[i];
  float mip = mip_in[i];
  int budget = budget_in[i];
  const bool run = running_in[i];
  float maj_o = 0.0f;
  int kind = (run && budget <= 0) ? kKindDone : kKindIdle;
  bool march = run && budget > 0;
  if (march) {
    const float px = ipos[3 * i], py = ipos[3 * i + 1], pz = ipos[3 * i + 2];
    const float dx = idir[3 * i], dy = idir[3 * i + 1], dz = idir[3 * i + 2];
    const float rx = ri[3 * i], ry = ri[3 * i + 1], rz = ri[3 * i + 2];
    const float far = far_in[i];
    for (int k = 0; march && k < steps_cap; ++k) {
      const int mi = clampi(static_cast<int>(floorf(mip + 0.5f)), 0, 3);
      const float cx = px + t * dx;
      const float cy = py + t * dy;
      const float cz = pz + t * dz;
      // _majorant_coords: floor -> clip to the extent -> brick index
      const int vx = clampi(static_cast<int>(floorf(cx)), 0, ex - 1) >> 3;
      const int vy = clampi(static_cast<int>(floorf(cy)), 0, ey - 1) >> 3;
      const int vz = clampi(static_cast<int>(floorf(cz)), 0, ez - 1) >> 3;
      const float m = __ldg(maj + ((static_cast<int64_t>(mi) * bz + vz) * by + vy) * bx + vx);
      const float dim = static_cast<float>(8 << mi);
      const float dt = min_nan(min_nan(axis_step(cx, dim, rx), axis_step(cy, dim, ry)),
                               axis_step(cz, dim, rz));
      const float t_new = t + dt;
      const float tau_new = tau - m * dt;
      const bool collided = tau_new <= 0.0f;
      const float t_coll = t_new + tau_new / max_nan(m, 1e-20f);
      const bool escaped = t_coll >= far;
      const bool out_far = !collided && t_new >= far;
      const bool cont = !collided && !out_far;

      t = collided ? t_coll : t_new;
      if (!collided) {
        tau = tau_new;
        mip = fminf(mip + 0.25f, 3.0f);
      }
      budget -= 1;
      if (collided && !escaped) {
        maj_o = m;
        kind = kKindColl;
      } else if (!cont || budget <= 0) {
        kind = kKindDone;  // escaped at the collision, left the box, or capped
      }
      march = cont && budget > 0;
    }
  }
  t_out[i] = t;
  tau_out[i] = tau;
  mip_out[i] = mip;
  maj_out[i] = maj_o;
  kind_out[i] = kind;
  budget_out[i] = budget;
}

}  // namespace

extern "C" int vx_pyr_march(const float* maj, int bz, int by, int bx, int ex, int ey, int ez,
                            const float* ipos, const float* idir, const float* ri, const float* t,
                            const float* tau, const float* mip, const float* far, const int* budget,
                            const bool* running, float* t_out, float* tau_out, float* mip_out,
                            float* maj_out, int* kind_out, int* budget_out, int n, int steps_cap,
                            cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    pyr_march_kernel<<<blocks, kThreads, 0, stream>>>(
        maj, bz, by, bx, ex, ey, ez, ipos, idir, ri, t, tau, mip, far, budget, running, t_out,
        tau_out, mip_out, maj_out, kind_out, budget_out, n, steps_cap);
  }
  return static_cast<int>(cudaGetLastError());
}
