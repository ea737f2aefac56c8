// One kernel per default-mode leg: each lane marches over the premultiplied
// majorant pyramid to its next collision candidate, decodes and draws
// there, and marches on until it ends.
//
// Replaces the Pallas kernel volxel_tpu/render/pyrmarch.py: pyr_march
// (_pyr_march_call, kernel from _kernel_factory) together with the loop
// bodies that follow it in volxel_tpu/render/modes.py: sample_volume_dda_pyr
// (:796-821) and transmittance_dda_pyr (:866-903), which decode the density
// at each collision candidate (trilinear, then the transfer LUT's NEAREST
// row with range rejection: the LUT site of the Pallas kernel
// volxel_tpu/render/mxu_gather.py: mxu_gather_f32) and make the draws.
// Plain versions: volxel_tpu_torch/render/ddaleg.py: dda_leg_sample_plain
// and dda_leg_shadow_plain, rounds of pyr_march_plain and one
// dda_collide_*_plain while any lane runs.
//
// Why one launch gives the rounds' result: every lane is independent. Its
// step budget, its RNG words and its march state are its own, and a march
// round of the plain version never cuts a lane short (it runs past any
// budget). So a lane that marches and collides until it ends computes, bit
// for bit, what the rounds compute for it.
//
// What bounds it on an H100: latency, not bytes or FLOPs. A march step is
// one dependent 4-byte fetch from the stacked pyramid (4 MiB at 512^3, so
// it stays in the 50 MB L2) and ~40 scalar f32 operations whose result
// decides the next fetch's address; a collision reads eight bf16 taps of
// the 256 MiB field, in four to eight 32-byte sectors (the x neighbours
// share one 15 times in 16). Lanes diverge: a ray
// through empty space ends after a few coarse steps, one through tissue
// takes dozens of fine ones and restarts after every null collision.
//
// Design: one thread per lane, lanes in pixel order, 128 threads a block,
// the lane's state in registers, the pyramid and the field read through
// the read-only cache (__ldg). A warp lives until its slowest lane ends;
// in exchange there is no round boundary: one lane's scattered taps overlap
// other lanes' march steps, no lane state goes through device memory
// between rounds, and a leg is one launch with no host sync. Every lane
// writes its outputs once.
//
// Bit-equality with the plain version: every f32 operation is the plain
// version's, in its order, under the rules of leg_common.cuh (built with
// --fmad=true, every other operation a never-contracted intrinsic, the log
// and the IEEE division out of line). The march's c / dim is
// c * 2^-(3 + mip), which rounds the same real number (dim is a power of
// two) and needs no division. t_coll = t_new + tau_new / maj is computed
// only at a collision, the one step whose t it becomes. vx_neg_log1m
// exposes the same -log(1 - xi) so that a check can hold it against
// torch.log over all 2^24 values xi takes. The constants 0.1, 1e-20 and
// 2.0 are rounded to f32 once, as PyTorch rounds a Python scalar against
// an f32 tensor.

#include "leg_common.cuh"

namespace {

constexpr float kSpeedUp = 0.25f;   // pyrmarch.MIP_SPEED_UP
constexpr float kSpeedDown = 2.0f;  // collide.MIP_SPEED_DOWN

// one axis of the DDA step: distance along the ray to the next brick
// boundary at cell size dim = 2^(3 + mip) (dda.glsl:10-16); inv_dim is
// 1 / dim, exact
__device__ __forceinline__ float axis_step(float c, float dim, float inv_dim, float r) {
  const float off = r >= 0.0f ? __fadd_rn(dim, 0.5f) : -0.5f;
  return __fmul_rn(__fsub_rn(__fadd_rn(__fmul_rn(floorf(__fmul_rn(c, inv_dim)), dim), off), c), r);
}

// one lane's ray and march state
struct Lane {
  float p[3], d[3], r[3];
  float far, t, tau, mip;
  int budget;
};

// pyrmarch.pyr_march_plain for one lane: march from (t, tau, mip) to the
// next collision candidate. True there, with `m` the majorant of the
// collision step; false where the lane escapes at its collision, leaves
// past `far` or spends its budget (also when it starts with none left).
__device__ __forceinline__ bool march(const Volume& v, Lane& l, float& m) {
  while (l.budget > 0) {
    const int mi = clampi(static_cast<int>(floorf(__fadd_rn(l.mip, 0.5f))), 0, 3);
    float c[3];
    for (int a = 0; a < 3; ++a) c[a] = __fadd_rn(l.p[a], __fmul_rn(l.t, l.d[a]));
    // _majorant_coords: floor -> clip to the extent -> brick index
    const int vx = clampi(static_cast<int>(floorf(c[0])), 0, v.ex - 1) >> 3;
    const int vy = clampi(static_cast<int>(floorf(c[1])), 0, v.ey - 1) >> 3;
    const int vz = clampi(static_cast<int>(floorf(c[2])), 0, v.ez - 1) >> 3;
    m = __ldg(v.maj + ((static_cast<int64_t>(mi) * v.bz + vz) * v.by + vy) * v.bx + vx);
    const float dim = static_cast<float>(8 << mi);
    const float inv_dim = __int_as_float((127 - 3 - mi) << 23);  // 2^-(3 + mi)
    const float dt = min_nan(min_nan(axis_step(c[0], dim, inv_dim, l.r[0]), axis_step(c[1], dim, inv_dim, l.r[1])),
                             axis_step(c[2], dim, inv_dim, l.r[2]));
    const float t_new = __fadd_rn(l.t, dt);
    const float tau_new = __fsub_rn(l.tau, __fmul_rn(m, dt));
    l.budget -= 1;
    if (tau_new <= 0.0f) {  // collided: t moves to the collision point
      l.t = __fadd_rn(t_new, div_rn(tau_new, max_nan(m, 1e-20f)));
      return !(l.t >= l.far);  // a collision past far is an escape
    }
    l.t = t_new;
    l.tau = tau_new;
    l.mip = clamp_max(__fadd_rn(l.mip, kSpeedUp), 3.0f);
    if (t_new >= l.far) return false;  // left the box
  }
  return false;  // the budget is spent
}

// the per-lane operands both legs read and the outputs both write
struct Lanes {
  const float *ipos, *idir, *ri, *far, *t, *tau, *mip;
  const int64_t* state;
  const bool* running;
  int cap;
  int64_t* state_out;
  int* budget_out;
  long long n;
};

__device__ __forceinline__ Lane load_lane(const Lanes& a, long long i) {
  Lane l;
  for (int k = 0; k < 3; ++k) {
    l.p[k] = a.ipos[3 * i + k];
    l.d[k] = a.idir[3 * i + k];
    l.r[k] = a.ri[3 * i + k];
  }
  l.far = a.far[i];
  l.t = a.t[i];
  l.tau = a.tau[i];
  l.mip = a.mip[i];
  l.budget = a.cap;
  return l;
}

__device__ __forceinline__ void load_state(const Lanes& a, long long i, uint32_t (&s)[4]) {
  for (int j = 0; j < 4; ++j) s[j] = static_cast<uint32_t>(a.state[4 * i + j]);
}

__device__ __forceinline__ void store_common(const Lanes& a, long long i, const uint32_t (&s)[4], int budget) {
  for (int j = 0; j < 4; ++j) a.state_out[4 * i + j] = static_cast<int64_t>(s[j]);
  a.budget_out[i] = budget;
}

// modes.sample_volume_dda's leg (dda.glsl:65-98): at each collision the
// real/null draw; a real collision ends the lane with the LUT colour, a
// null one redraws tau, steps the mip down, and the lane marches on
__global__ void __launch_bounds__(kThreads) dda_leg_sample_kernel(Volume v, Lanes a, bool* __restrict__ hit_out,
                                                                  float* __restrict__ t_out,
                                                                  float* __restrict__ rgb_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  uint32_t s[4];
  load_state(a, i, s);
  float t = a.t[i];
  int budget = a.cap;
  bool hit = false;
  float rgb[3] = {1.0f, 1.0f, 1.0f};
  if (a.running[i]) {
    Lane l = load_lane(a, i);
    const float vol_maj = __ldg(v.scalars + kVolMaj);
    float m;
    while (march(v, l, m)) {
      const float4 rgba = decode(v, l.p, l.d, l.t);
      if (__fmul_rn(next_float(s), m) < __fmul_rn(vol_maj, rgba.w)) {
        hit = true;
        rgb[0] = rgba.x;
        rgb[1] = rgba.y;
        rgb[2] = rgba.z;
        break;
      }
      l.tau = neg_log1m(next_float(s));
      l.mip = clamp_min(__fsub_rn(l.mip, kSpeedDown), 0.0f);
    }
    t = l.t;
    budget = l.budget;
  }
  store_common(a, i, s, budget);
  hit_out[i] = hit;
  t_out[i] = t;
  for (int k = 0; k < 3; ++k) rgb_out[3 * i + k] = rgb[k];
}

// modes.transmittance_dda's leg (dda.glsl:21-62): at each collision the
// real/null draw, the ratio at a real one (the reference's quirk 1 -
// vol_maj / maj, or 1 - d / maj when `physical`), russian roulette under
// 0.1 (a killed lane ends with tr = 0 before the tau draw), then the tau
// redraw and the mip step-down, and the lane marches on
template <bool kPhysical>
__global__ void __launch_bounds__(kThreads) dda_leg_shadow_kernel(Volume v, Lanes a, const float* __restrict__ tr_in,
                                                                  float* __restrict__ tr_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  uint32_t s[4];
  load_state(a, i, s);
  float tr = tr_in[i];
  int budget = a.cap;
  if (a.running[i]) {
    Lane l = load_lane(a, i);
    const float vol_maj = __ldg(v.scalars + kVolMaj);
    float m;
    while (march(v, l, m)) {
      const float d = __fmul_rn(vol_maj, decode(v, l.p, l.d, l.t).w);
      if (__fmul_rn(next_float(s), m) < d) {  // real
        tr = __fmul_rn(tr, clamp_min(__fsub_rn(1.0f, div_rn(kPhysical ? d : vol_maj,
                                                            clamp_min(m, static_cast<float>(1e-20)))), 0.0f));
        if (tr < static_cast<float>(0.1)) {
          if (next_float(s) < __fsub_rn(1.0f, tr)) {
            tr = 0.0f;
            break;
          }
          tr = div_rn(tr, clamp_min(tr, static_cast<float>(1e-20)));
        }
      }
      l.tau = neg_log1m(next_float(s));
      l.mip = clamp_min(__fsub_rn(l.mip, kSpeedDown), 0.0f);
    }
    budget = l.budget;
  }
  store_common(a, i, s, budget);
  tr_out[i] = tr;
}

__global__ void __launch_bounds__(kThreads) neg_log1m_kernel(const float* __restrict__ xi, float* __restrict__ out,
                                                             long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = neg_log1m(xi[i]);
}

}  // namespace

extern "C" int vx_dda_leg_sample(const float* maj, int bz, int by, int bx, const uint16_t* dense, int ny, int nx,
                                 int ex, int ey, int ez, const float* lut, int lut_k, const float* scalars,
                                 const float* ipos, const float* idir, const float* ri, const float* far,
                                 const float* t, const float* tau, const float* mip, const int64_t* state,
                                 const bool* running, int cap, int64_t* state_out, bool* hit_out, float* t_out,
                                 float* rgb_out, int* budget_out, long long n, cudaStream_t stream) {
  if (n > 0) {
    const Volume v{maj, bz, by, bx, dense, ny, nx, ex, ey, ez, reinterpret_cast<const float4*>(lut), lut_k,
                   scalars};
    const Lanes a{ipos, idir, ri, far, t, tau, mip, state, running, cap, state_out, budget_out, n};
    dda_leg_sample_kernel<<<blocks_for(n), kThreads, 0, stream>>>(v, a, hit_out, t_out, rgb_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vx_dda_leg_shadow(const float* maj, int bz, int by, int bx, const uint16_t* dense, int ny, int nx,
                                 int ex, int ey, int ez, const float* lut, int lut_k, const float* scalars,
                                 const float* ipos, const float* idir, const float* ri, const float* far,
                                 const float* t, const float* tau, const float* mip, const int64_t* state,
                                 const bool* running, const float* tr, int cap, int physical, int64_t* state_out,
                                 float* tr_out, int* budget_out, long long n, cudaStream_t stream) {
  if (n > 0) {
    const Volume v{maj, bz, by, bx, dense, ny, nx, ex, ey, ez, reinterpret_cast<const float4*>(lut), lut_k,
                   scalars};
    const Lanes a{ipos, idir, ri, far, t, tau, mip, state, running, cap, state_out, budget_out, n};
    if (physical) {
      dda_leg_shadow_kernel<true><<<blocks_for(n), kThreads, 0, stream>>>(v, a, tr, tr_out);
    } else {
      dda_leg_shadow_kernel<false><<<blocks_for(n), kThreads, 0, stream>>>(v, a, tr, tr_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// -log(1 - xi) as the leg kernels compute it, for a check against
// torch.log; on no render path
extern "C" int vx_neg_log1m(const float* xi, float* out, long long n, cudaStream_t stream) {
  if (n > 0) neg_log1m_kernel<<<blocks_for(n), kThreads, 0, stream>>>(xi, out, n);
  return static_cast<int>(cudaGetLastError());
}
