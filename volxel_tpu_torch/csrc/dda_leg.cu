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
// version's, in its order. -log(1 - xi) must round as ATen's log does, and
// ATen builds its log kernel with nvcc's default --fmad=true, so this file
// is built with --fmad=true (kernels.FMAD_SOURCES) and every f32 sum,
// difference and product below is written with __fadd_rn, __fsub_rn or
// __fmul_rn, which are never contracted into an FMA. The two functions
// whose own code needs FFMA, the log and the IEEE division (its correctly
// rounded sequence), are kept out of line, so a SASS listing of the leg
// kernels shows no FFMA at all (chip_smoke.py checks it). The march's
// c / dim is c * 2^-(3 + mip), which rounds the same real number (dim is a
// power of two) and needs no division. t_coll = t_new + tau_new / maj is
// computed only at a collision, the one step whose t it becomes.
// vx_neg_log1m exposes the same -log(1 - xi) so that a check can hold it
// against torch.log over all 2^24 values xi takes. min_nan / max_nan give
// NaN for a NaN operand as torch.amin and torch.clamp_min do, clamp_min /
// clamp_max keep a NaN value; the float -> int casts are static_cast, as
// ATen's are (NaN lands on 0, +-inf saturates); the constants 0.1, 1e-20
// and 2.0 are rounded to f32 once, as PyTorch rounds a Python scalar
// against an f32 tensor; a tap outside the extent reads 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kSpeedUp = 0.25f;   // pyrmarch.MIP_SPEED_UP
constexpr float kSpeedDown = 2.0f;  // collide.MIP_SPEED_DOWN
// layout of the (5,) f32 scalars, as render/tilemarch.volume_scalars
constexpr int kInvMaj = 0, kVolMaj = 1, kDenScale = 2, kRangeLo = 3, kRangeHi = 4;

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
// torch.clamp_min(v, lo) and clamp_max(v, hi): a NaN v is returned as it is
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_max(float v, float hi) { return v != v ? v : fminf(v, hi); }
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// the two functions whose code holds FFMA, out of line (see above)
__device__ __noinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __noinline__ float neg_log1m(float xi) { return -logf(__fsub_rn(1.0f, xi)); }

__device__ __forceinline__ uint32_t rotl(uint32_t x, int k) { return (x << k) | (x >> (32 - k)); }

// xoshiro128++ step and its top-24-bit float (random.glsl:80-106)
__device__ __forceinline__ float next_float(uint32_t (&s)[4]) {
  const uint32_t result = rotl(s[0] + s[2], 7) + s[0];
  const uint32_t t = s[1] << 9;
  s[2] ^= s[0];
  s[3] ^= s[1];
  s[1] ^= s[2];
  s[0] ^= s[3];
  s[2] ^= t;
  s[3] = rotl(s[3], 11);
  return __fmul_rn(static_cast<float>(result >> 8), 1.0f / 16777216.0f);
}

// one axis of the DDA step: distance along the ray to the next brick
// boundary at cell size dim = 2^(3 + mip) (dda.glsl:10-16); inv_dim is
// 1 / dim, exact
__device__ __forceinline__ float axis_step(float c, float dim, float inv_dim, float r) {
  const float off = r >= 0.0f ? __fadd_rn(dim, 0.5f) : -0.5f;
  return __fmul_rn(__fsub_rn(__fadd_rn(__fmul_rn(floorf(__fmul_rn(c, inv_dim)), dim), off), c), r);
}

// what every lane of a launch reads: the pyramid, the field, the LUT and
// the volume's scalars
struct Volume {
  const float* maj;
  int bz, by, bx;
  const uint16_t* dense;
  int ny, nx, ex, ey, ez;
  const float4* lut;
  int lut_k;
  const float* scalars;
};

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

// sampling.lookup_density_trilinear at one point, times inv_maj: the eight
// taps in _TAPS order (dz outer, dx inner), weights ((wx * wy) * wz), the
// products summed one after another
__device__ __forceinline__ float trilinear_norm(const Volume& v, const float (&pos)[3]) {
  long long base[3];
  float w1[3][2];
  for (int a = 0; a < 3; ++a) {
    const float p = __fsub_rn(pos[a], 0.5f);
    base[a] = static_cast<long long>(floorf(p));
    const float f = __fsub_rn(p, static_cast<float>(base[a]));
    w1[a][0] = __fsub_rn(1.0f, f);
    w1[a][1] = f;
  }
  const long long ext[3] = {v.ex, v.ey, v.ez};
  float acc = 0.0f;
  for (int k = 0; k < 8; ++k) {
    const int off[3] = {k & 1, (k >> 1) & 1, k >> 2};
    long long c[3];
    bool inside = true;
    for (int a = 0; a < 3; ++a) {
      // int64 wrap-around, as ATen's int64 add
      c[a] = static_cast<long long>(static_cast<unsigned long long>(base[a]) + off[a]);
      inside = inside && c[a] >= 0 && c[a] < ext[a];
    }
    float tap = 0.0f;
    if (inside) {
      const uint16_t bits = __ldg(v.dense + (c[2] * v.ny + c[1]) * v.nx + c[0]);
      tap = __uint_as_float(static_cast<uint32_t>(bits) << 16);  // bf16 -> f32 is exact
    }
    const float w = __fmul_rn(__fmul_rn(w1[0][off[0]], w1[1][off[1]]), w1[2][off[2]]);
    const float term = __fmul_rn(tap, w);
    acc = k == 0 ? term : __fadd_rn(acc, term);
  }
  return __fmul_rn(__fmul_rn(__ldg(v.scalars + kDenScale), acc), __ldg(v.scalars + kInvMaj));
}

// collide._parked's decode at the lane's collision point: the density,
// then the LUT's NEAREST row (gather.lookup_transfer_plain), 0 where the
// sample range rejects it
__device__ __forceinline__ float4 decode(const Volume& v, const Lane& l) {
  const float pos[3] = {__fadd_rn(l.p[0], __fmul_rn(l.t, l.d[0])), __fadd_rn(l.p[1], __fmul_rn(l.t, l.d[1])),
                        __fadd_rn(l.p[2], __fmul_rn(l.t, l.d[2]))};
  const float d = trilinear_norm(v, pos);
  const bool rejected = d < __ldg(v.scalars + kRangeLo) || d > __ldg(v.scalars + kRangeHi);
  long long j = static_cast<long long>(floorf(__fmul_rn(d, static_cast<float>(v.lut_k))));
  j = j < 0 ? 0 : (j > v.lut_k - 1 ? v.lut_k - 1 : j);
  return rejected ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : __ldg(v.lut + j);
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
      const float4 rgba = decode(v, l);
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
      const float d = __fmul_rn(vol_maj, decode(v, l).w);
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

int blocks_for(long long n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

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
