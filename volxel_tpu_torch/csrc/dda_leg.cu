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
// What bounds it on an H100 (PERF.md section 6): not bytes (the parent
// kernels ran at 22% and 32% of their bytes
// bound) and not the majorant fetches' latency. The stacked pyramid (4 MiB
// at 512^3) is read by warps whose lanes walk neighbouring bricks, so a
// step's fetch is a short wait: with every load replaced by a register
// constant the camera leg takes 0.20 ms against 0.21 with memory, and
// fetches issued 2 to 4 steps ahead made both legs slower (each collision
// refills them, and they cost registers). What sets the time is the
// instructions each lane issues, ~80 a march step and ~230 a collision
// with its log and division, its chain of dependent arithmetic, and how
// the warp executes the march and the collisions: lanes diverge (a ray
// through empty space ends after a few coarse steps, one through tissue
// takes dozens of fine ones and restarts after every null collision). A
// loop that marches every lane to its next collision and then decodes
// runs each round as long as the round's slowest lane: 584,091 warp step
// iterations for the camera leg's 5,966,093 steps at a 1080p sample, where
// one step an iteration takes 299,079.
//
// Design: one thread per lane, lanes in pixel order, 128 threads a block,
// the lane's state in registers, the pyramid and the field read through
// the read-only cache (__ldg). One march step an iteration: a lane whose
// step collides decodes there (leg_common.cuh's fetch and decode, the
// eight taps in flight together) and makes its draws, while the others
// have marched on; then every lane of the warp issues its next step's
// fetch together. The pyramid's index is 32 bits (ddaleg.py refuses a
// pyramid of 2^31 entries). __launch_bounds__(kThreads, 1): with the block
// size alone ptxas gave the camera leg 56 registers and it ran slower. A
// warp lives until its slowest lane ends; a leg is one launch with no host
// sync, and every lane writes its outputs once.
//
// Bit-equality with the plain version: every f32 operation is the plain
// version's, in its order, under the rules of leg_common.cuh (built with
// --fmad=true, every other operation a never-contracted intrinsic, the log
// and the IEEE division out of line). The march's c / dim is
// c * 2^-(3 + mip), which rounds the same real number (dim is a power of
// two) and needs no division. t_coll = t_new + tau_new / maj is computed
// only at a collision, the one step whose t it becomes. Only the
// collision test reads a step's majorant, so where the march goes between
// collisions does not depend on the values it reads
// (tests/test_torch_ddaleg.py). vx_neg_log1m
// exposes the same -log(1 - xi) so that a check can hold it against
// torch.log over all 2^24 values xi takes. The constants 0.1, 1e-20 and
// 2.0 are rounded to f32 once, as PyTorch rounds a Python scalar against
// an f32 tensor.
//
// Render-time volume slabs: vx_dda_leg_*_slabs launch the same legs over a
// SlabField (leg_common.cuh), each collision's taps read from the slab of
// the owner of its base z through the slabs' pointer table, and with the
// trilinear sum rounded to bf16 where the grid asks for it (round_taps).
// They are kernels of their own, so the dense kernels keep their code.
//
// Park forms (a vz row across nodes, parallel/migrate.py):
// vx_dda_leg_*_slabs_park launch the slab legs over a table whose slabs on
// other nodes are null. A lane parks at a collision whose taps lie in such a
// slab, before the taps' fetch (leg_common.cuh's parked_owner), and writes
// its t, mip, majorant m, budget and words (and tr) with the slab's index;
// a lane given `resume` starts at that collision's fetch. Each lane's budget
// is an input, so a resumed lane keeps what it has left. The park forms are
// the legs' kPark instantiations (walk's test and entry under if constexpr),
// kernels of their own, so the dense and slab forms keep their code; where
// no slab is absent a park form is its slab form.

#include "leg_common.cuh"

namespace {

// the blocks per SM the kernels' launch bounds name
constexpr int kMinBlocks = 1;

constexpr float kSpeedUp = 0.25f;   // pyrmarch.MIP_SPEED_UP
constexpr float kSpeedDown = 2.0f;  // collide.MIP_SPEED_DOWN

// one axis of the DDA step: distance along the ray to the next brick
// boundary at cell size dim = 2^(3 + mip) (dda.glsl:10-16); inv_dim is
// 1 / dim, exact
__device__ __forceinline__ float axis_step(float c, float dim, float inv_dim, float r) {
  const float off = r >= 0.0f ? __fadd_rn(dim, 0.5f) : -0.5f;
  return __fmul_rn(__fsub_rn(__fadd_rn(__fmul_rn(floorf(__fmul_rn(c, inv_dim)), dim), off), c), r);
}

// the majorant pyramid a launch reads: (4, bz, by, bx) f32, fewer than 2^31
// entries (ddaleg.py checks it)
struct Pyramid {
  const float* maj;
  int bz, by, bx;
};

// one lane's ray and march state, and its next step, issued: the step's
// majorant (in flight), its DDA step and the t it reaches
struct Lane {
  float p[3], d[3], r[3];
  float far, t, tau, mip;
  int budget;
  float m, dt, t_new;
};

// the step from (t, mip): pyrmarch.pyr_march_plain's majorant fetch (a
// 32-bit index) and DDA step
template <class F>
__device__ __forceinline__ void issue(const Pyramid& g, const F& v, Lane& l) {
  const int mi = clampi(static_cast<int>(floorf(__fadd_rn(l.mip, 0.5f))), 0, 3);
  float c[3];
  for (int a = 0; a < 3; ++a) c[a] = __fadd_rn(l.p[a], __fmul_rn(l.t, l.d[a]));
  // _majorant_coords: floor -> clip to the extent -> brick index
  const int vx = clampi(static_cast<int>(floorf(c[0])), 0, v.ex - 1) >> 3;
  const int vy = clampi(static_cast<int>(floorf(c[1])), 0, v.ey - 1) >> 3;
  const int vz = clampi(static_cast<int>(floorf(c[2])), 0, v.ez - 1) >> 3;
  l.m = __ldg(g.maj + (((mi * g.bz + vz) * g.by + vy) * g.bx + vx));
  const float dim = static_cast<float>(8 << mi);
  const float inv_dim = __int_as_float((127 - 3 - mi) << 23);  // 2^-(3 + mi)
  l.dt = min_nan(min_nan(axis_step(c[0], dim, inv_dim, l.r[0]), axis_step(c[1], dim, inv_dim, l.r[1])),
                 axis_step(c[2], dim, inv_dim, l.r[2]));
  l.t_new = __fadd_rn(l.t, l.dt);
}

// one lane's march and its collisions until it ends, one march step an
// iteration: the step's collision test; at a collision its t, the taps'
// fetch and decode, and `collide`, which makes the leg's draws (the tau
// redraw among them) and returns whether the lane ended; then the next
// step, issued by every lane of the warp together. The lane ends where it
// escapes at a collision, leaves past `far` or spends its budget (also
// when it starts with none left), as pyr_march_plain's rounds end it.
// kPark (the park forms) adds, under if constexpr only, so that the other
// instantiations keep their code: a lane with `resume` starts with the
// collision at its t (majorant l.m, mip and budget as the collision left
// them), and at each collision the taps' slab is tested before the fetch:
// a lane whose slab is absent stops there. Returns that slab's index, else
// -1.
template <bool kPark, class F, class Collide>
__device__ __forceinline__ int walk(const Pyramid& g, const F& v, Lane& l, bool resume, Collide collide) {
  const Scalars c = load_scalars(v);
  int parked = -1;
  if constexpr (kPark) {
    if (resume) {  // the collision at t, as in the loop
      parked = parked_owner(v, l.p, l.d, l.t);
      if (parked >= 0) return parked;
      Taps taps;
      fetch(v, l.p, l.d, l.t, taps);
      if (collide(c, decode(v, c, taps), l)) return parked;
      l.mip = clamp_min(__fsub_rn(l.mip, kSpeedDown), 0.0f);
    }
  }
  if (l.budget <= 0) return parked;
  issue(g, v, l);
  for (;;) {
    const float tau_new = __fsub_rn(l.tau, __fmul_rn(l.m, l.dt));
    l.budget -= 1;
    if (tau_new <= 0.0f) {  // collided: t moves to the collision point
      l.t = __fadd_rn(l.t_new, div_rn(tau_new, max_nan(l.m, 1e-20f)));
      if (l.t >= l.far) break;  // a collision past far is an escape
      if constexpr (kPark) {
        parked = parked_owner(v, l.p, l.d, l.t);
        if (parked >= 0) break;
      }
      Taps taps;
      fetch(v, l.p, l.d, l.t, taps);
      if (collide(c, decode(v, c, taps), l)) break;
      l.mip = clamp_min(__fsub_rn(l.mip, kSpeedDown), 0.0f);
    } else {
      l.t = l.t_new;
      l.tau = tau_new;
      l.mip = clamp_max(__fadd_rn(l.mip, kSpeedUp), 3.0f);
      if (l.t_new >= l.far) break;  // left the box
    }
    if (l.budget <= 0) break;
    issue(g, v, l);
  }
  return parked;
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

// the park forms' per-lane inputs and outputs beside Lanes (whose cap they
// do not read)
struct Parks {
  const float* m;       // a resumed lane's majorant at its collision
  const int* budget;    // each lane's steps left
  const bool* resume;   // start at the collision at t, with the taps' fetch
  float* mip_out;       // a parked lane's mip (the input mip elsewhere)
  float* m_out;         // a parked lane's majorant (0 elsewhere)
  int* park_out;        // the absent slab a lane parked at (-1 elsewhere)
};

// a running lane's march state; kPark: its budget and majorant from `k`
template <bool kPark>
__device__ __forceinline__ Lane start_lane(const Lanes& a, const Parks& k, long long i) {
  Lane l = load_lane(a, i);
  if constexpr (kPark) {
    l.budget = k.budget[i];
    l.m = k.m[i];
  }
  return l;
}

// kPark: where the lane parked, its mip and majorant
__device__ __forceinline__ void store_park(const Parks& k, long long i, int parked, float mip, float m) {
  k.mip_out[i] = mip;
  k.m_out[i] = m;
  k.park_out[i] = parked;
}

// modes.sample_volume_dda's leg (dda.glsl:65-98): at each collision the
// real/null draw; a real collision ends the lane with the LUT colour, a
// null one redraws tau, steps the mip down, and the lane marches on.
// kPark: the park form (walk), with `k`'s inputs and outputs.
template <bool kPark, class F>
__device__ __forceinline__ void sample_leg(const Pyramid& g, const F& v, const Lanes& a, const Parks& k,
                                           bool* __restrict__ hit_out, float* __restrict__ t_out,
                                           float* __restrict__ rgb_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  uint32_t s[4];
  load_state(a, i, s);
  float t = a.t[i];
  int budget = kPark ? k.budget[i] : a.cap;
  int parked = -1;
  float mip = 0.0f, m = 0.0f;
  if constexpr (kPark) mip = a.mip[i];
  bool hit = false;
  float rgb[3] = {1.0f, 1.0f, 1.0f};
  if (a.running[i]) {
    Lane w = start_lane<kPark>(a, k, i);
    parked = walk<kPark>(g, v, w, kPark && k.resume[i], [&](const Scalars& c, const float4& rgba, Lane& l) {
      if (__fmul_rn(next_float(s), l.m) < __fmul_rn(c.vol_maj, rgba.w)) {
        hit = true;
        rgb[0] = rgba.x;
        rgb[1] = rgba.y;
        rgb[2] = rgba.z;
        return true;
      }
      l.tau = neg_log1m(next_float(s));
      return false;
    });
    t = w.t;
    budget = w.budget;
    if (kPark && parked >= 0) {
      mip = w.mip;
      m = w.m;
    }
  }
  store_common(a, i, s, budget);
  if constexpr (kPark) store_park(k, i, parked, mip, m);
  hit_out[i] = hit;
  t_out[i] = t;
  for (int c = 0; c < 3; ++c) rgb_out[3 * i + c] = rgb[c];
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) dda_leg_sample_kernel(Pyramid g, Field v, Lanes a,
                                                                             bool* __restrict__ hit_out,
                                                                             float* __restrict__ t_out,
                                                                             float* __restrict__ rgb_out) {
  sample_leg<false>(g, v, a, Parks{}, hit_out, t_out, rgb_out);
}

// the same over z-slabs
template <bool kRound>
__global__ void __launch_bounds__(kThreads, kMinBlocks) dda_leg_sample_slabs_kernel(Pyramid g, SlabField<kRound> v,
                                                                                   Lanes a, bool* __restrict__ hit_out,
                                                                                   float* __restrict__ t_out,
                                                                                   float* __restrict__ rgb_out) {
  sample_leg<false>(g, v, a, Parks{}, hit_out, t_out, rgb_out);
}

// and its park form
template <bool kRound>
__global__ void __launch_bounds__(kThreads, kMinBlocks) dda_leg_sample_park_kernel(
    Pyramid g, SlabField<kRound> v, Lanes a, Parks k, bool* __restrict__ hit_out, float* __restrict__ t_out,
    float* __restrict__ rgb_out) {
  sample_leg<true>(g, v, a, k, hit_out, t_out, rgb_out);
}

// modes.transmittance_dda's leg (dda.glsl:21-62): at each collision the
// real/null draw, the ratio at a real one (the reference's quirk 1 -
// vol_maj / maj, or 1 - d / maj when `physical`), russian roulette under
// 0.1 (a killed lane ends with tr = 0 before the tau draw), then the tau
// redraw and the mip step-down, and the lane marches on. kPark: the park
// form, which writes each lane's t too.
template <bool kPhysical, bool kPark, class F>
__device__ __forceinline__ void shadow_leg(const Pyramid& g, const F& v, const Lanes& a, const Parks& k,
                                           const float* __restrict__ tr_in, float* __restrict__ tr_out,
                                           float* __restrict__ t_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  uint32_t s[4];
  load_state(a, i, s);
  float tr = tr_in[i];
  int budget = kPark ? k.budget[i] : a.cap;
  int parked = -1;
  float t = 0.0f, mip = 0.0f, m = 0.0f;
  if constexpr (kPark) {
    t = a.t[i];
    mip = a.mip[i];
  }
  if (a.running[i]) {
    Lane w = start_lane<kPark>(a, k, i);
    parked = walk<kPark>(g, v, w, kPark && k.resume[i], [&](const Scalars& c, const float4& rgba, Lane& l) {
      const float d = __fmul_rn(c.vol_maj, rgba.w);
      if (__fmul_rn(next_float(s), l.m) < d) {  // real
        tr = __fmul_rn(tr, clamp_min(__fsub_rn(1.0f, div_rn(kPhysical ? d : c.vol_maj,
                                                            clamp_min(l.m, static_cast<float>(1e-20)))), 0.0f));
        if (tr < static_cast<float>(0.1)) {
          if (next_float(s) < __fsub_rn(1.0f, tr)) {
            tr = 0.0f;
            return true;
          }
          tr = div_rn(tr, clamp_min(tr, static_cast<float>(1e-20)));
        }
      }
      l.tau = neg_log1m(next_float(s));
      return false;
    });
    budget = w.budget;
    if constexpr (kPark) {
      t = w.t;
      if (parked >= 0) {
        mip = w.mip;
        m = w.m;
      }
    }
  }
  store_common(a, i, s, budget);
  tr_out[i] = tr;
  if constexpr (kPark) {
    store_park(k, i, parked, mip, m);
    t_out[i] = t;
  }
}

template <bool kPhysical>
__global__ void __launch_bounds__(kThreads, kMinBlocks) dda_leg_shadow_kernel(Pyramid g, Field v, Lanes a,
                                                                             const float* __restrict__ tr_in,
                                                                             float* __restrict__ tr_out) {
  shadow_leg<kPhysical, false>(g, v, a, Parks{}, tr_in, tr_out, nullptr);
}

// the same over z-slabs
template <bool kPhysical, bool kRound>
__global__ void __launch_bounds__(kThreads, kMinBlocks) dda_leg_shadow_slabs_kernel(Pyramid g, SlabField<kRound> v,
                                                                                   Lanes a,
                                                                                   const float* __restrict__ tr_in,
                                                                                   float* __restrict__ tr_out) {
  shadow_leg<kPhysical, false>(g, v, a, Parks{}, tr_in, tr_out, nullptr);
}

// and its park form
template <bool kPhysical, bool kRound>
__global__ void __launch_bounds__(kThreads, kMinBlocks) dda_leg_shadow_park_kernel(
    Pyramid g, SlabField<kRound> v, Lanes a, Parks k, const float* __restrict__ tr_in, float* __restrict__ tr_out,
    float* __restrict__ t_out) {
  shadow_leg<kPhysical, true>(g, v, a, k, tr_in, tr_out, t_out);
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
    const Pyramid g{maj, bz, by, bx};
    const Field v = make_field(dense, ny, nx, ex, ey, ez, lut, lut_k, scalars);
    const Lanes a{ipos, idir, ri, far, t, tau, mip, state, running, cap, state_out, budget_out, n};
    dda_leg_sample_kernel<<<blocks_for(n), kThreads, 0, stream>>>(g, v, a, hit_out, t_out, rgb_out);
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
    const Pyramid g{maj, bz, by, bx};
    const Field v = make_field(dense, ny, nx, ex, ey, ez, lut, lut_k, scalars);
    const Lanes a{ipos, idir, ri, far, t, tau, mip, state, running, cap, state_out, budget_out, n};
    if (physical) {
      dda_leg_shadow_kernel<true><<<blocks_for(n), kThreads, 0, stream>>>(g, v, a, tr, tr_out);
    } else {
      dda_leg_shadow_kernel<false><<<blocks_for(n), kThreads, 0, stream>>>(g, v, a, tr, tr_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vx_dda_leg_sample_slabs(const float* maj, int bz, int by, int bx, const uint16_t* const* slabs,
                                       int slab, int round_taps, int ny, int nx, int ex, int ey, int ez,
                                       const float* lut, int lut_k, const float* scalars, const float* ipos,
                                       const float* idir, const float* ri, const float* far, const float* t,
                                       const float* tau, const float* mip, const int64_t* state, const bool* running,
                                       int cap, int64_t* state_out, bool* hit_out, float* t_out, float* rgb_out,
                                       int* budget_out, long long n, cudaStream_t stream) {
  if (n > 0) {
    const Pyramid g{maj, bz, by, bx};
    const Lanes a{ipos, idir, ri, far, t, tau, mip, state, running, cap, state_out, budget_out, n};
    if (round_taps) {
      dda_leg_sample_slabs_kernel<true><<<blocks_for(n), kThreads, 0, stream>>>(
          g, make_slab_field<true>(slabs, slab, ny, nx, ex, ey, ez, lut, lut_k, scalars), a, hit_out, t_out, rgb_out);
    } else {
      dda_leg_sample_slabs_kernel<false><<<blocks_for(n), kThreads, 0, stream>>>(
          g, make_slab_field<false>(slabs, slab, ny, nx, ex, ey, ez, lut, lut_k, scalars), a, hit_out, t_out, rgb_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kRound>
void launch_shadow_slabs(const Pyramid& g, const SlabField<kRound>& v, const Lanes& a, const float* tr, int physical,
                         float* tr_out, cudaStream_t stream) {
  if (physical) {
    dda_leg_shadow_slabs_kernel<true, kRound><<<blocks_for(a.n), kThreads, 0, stream>>>(g, v, a, tr, tr_out);
  } else {
    dda_leg_shadow_slabs_kernel<false, kRound><<<blocks_for(a.n), kThreads, 0, stream>>>(g, v, a, tr, tr_out);
  }
}

extern "C" int vx_dda_leg_shadow_slabs(const float* maj, int bz, int by, int bx, const uint16_t* const* slabs,
                                       int slab, int round_taps, int ny, int nx, int ex, int ey, int ez,
                                       const float* lut, int lut_k, const float* scalars, const float* ipos,
                                       const float* idir, const float* ri, const float* far, const float* t,
                                       const float* tau, const float* mip, const int64_t* state, const bool* running,
                                       const float* tr, int cap, int physical, int64_t* state_out, float* tr_out,
                                       int* budget_out, long long n, cudaStream_t stream) {
  if (n > 0) {
    const Pyramid g{maj, bz, by, bx};
    const Lanes a{ipos, idir, ri, far, t, tau, mip, state, running, cap, state_out, budget_out, n};
    if (round_taps) {
      launch_shadow_slabs(g, make_slab_field<true>(slabs, slab, ny, nx, ex, ey, ez, lut, lut_k, scalars), a, tr,
                          physical, tr_out, stream);
    } else {
      launch_shadow_slabs(g, make_slab_field<false>(slabs, slab, ny, nx, ex, ey, ez, lut, lut_k, scalars), a, tr,
                          physical, tr_out, stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vx_dda_leg_sample_slabs_park(const float* maj, int bz, int by, int bx, const uint16_t* const* slabs,
                                            int slab, int round_taps, int ny, int nx, int ex, int ey, int ez,
                                            const float* lut, int lut_k, const float* scalars, const float* ipos,
                                            const float* idir, const float* ri, const float* far, const float* t,
                                            const float* tau, const float* mip, const int64_t* state,
                                            const bool* running, const float* m, const int* budget,
                                            const bool* resume, int64_t* state_out, bool* hit_out, float* t_out,
                                            float* rgb_out, int* budget_out, float* mip_out, float* m_out,
                                            int* park_out, long long n, cudaStream_t stream) {
  if (n > 0) {
    const Pyramid g{maj, bz, by, bx};
    const Lanes a{ipos, idir, ri, far, t, tau, mip, state, running, 0, state_out, budget_out, n};
    const Parks k{m, budget, resume, mip_out, m_out, park_out};
    if (round_taps) {
      dda_leg_sample_park_kernel<true><<<blocks_for(n), kThreads, 0, stream>>>(
          g, make_slab_field<true>(slabs, slab, ny, nx, ex, ey, ez, lut, lut_k, scalars), a, k, hit_out, t_out,
          rgb_out);
    } else {
      dda_leg_sample_park_kernel<false><<<blocks_for(n), kThreads, 0, stream>>>(
          g, make_slab_field<false>(slabs, slab, ny, nx, ex, ey, ez, lut, lut_k, scalars), a, k, hit_out, t_out,
          rgb_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kRound>
void launch_shadow_park(const Pyramid& g, const SlabField<kRound>& v, const Lanes& a, const Parks& k, const float* tr,
                        int physical, float* tr_out, float* t_out, cudaStream_t stream) {
  if (physical) {
    dda_leg_shadow_park_kernel<true, kRound><<<blocks_for(a.n), kThreads, 0, stream>>>(g, v, a, k, tr, tr_out, t_out);
  } else {
    dda_leg_shadow_park_kernel<false, kRound><<<blocks_for(a.n), kThreads, 0, stream>>>(g, v, a, k, tr, tr_out, t_out);
  }
}

extern "C" int vx_dda_leg_shadow_slabs_park(const float* maj, int bz, int by, int bx, const uint16_t* const* slabs,
                                            int slab, int round_taps, int ny, int nx, int ex, int ey, int ez,
                                            const float* lut, int lut_k, const float* scalars, const float* ipos,
                                            const float* idir, const float* ri, const float* far, const float* t,
                                            const float* tau, const float* mip, const int64_t* state,
                                            const bool* running, const float* m, const int* budget,
                                            const bool* resume, const float* tr, int physical, int64_t* state_out,
                                            float* tr_out, int* budget_out, float* t_out, float* mip_out,
                                            float* m_out, int* park_out, long long n, cudaStream_t stream) {
  if (n > 0) {
    const Pyramid g{maj, bz, by, bx};
    const Lanes a{ipos, idir, ri, far, t, tau, mip, state, running, 0, state_out, budget_out, n};
    const Parks k{m, budget, resume, mip_out, m_out, park_out};
    if (round_taps) {
      launch_shadow_park(g, make_slab_field<true>(slabs, slab, ny, nx, ex, ey, ez, lut, lut_k, scalars), a, k, tr,
                         physical, tr_out, t_out, stream);
    } else {
      launch_shadow_park(g, make_slab_field<false>(slabs, slab, ny, nx, ex, ey, ez, lut, lut_k, scalars), a, k, tr,
                         physical, tr_out, t_out, stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// the warps that leg `leg`'s kernel (0 camera, 1 shadow, 2 shadow with
// physical shadows) keeps resident on one SM of the current card
extern "C" int vx_dda_leg_resident_warps(int leg, int* warps) {
  int blocks = 0;
  const void* kernel = leg == 0   ? reinterpret_cast<const void*>(dda_leg_sample_kernel)
                       : leg == 1 ? reinterpret_cast<const void*>(dda_leg_shadow_kernel<false>)
                                  : reinterpret_cast<const void*>(dda_leg_shadow_kernel<true>);
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  *warps = blocks * kThreads / 32;
  return static_cast<int>(err);
}

// enable peer access from the current card to card `peer` (nothing to do
// for the card itself or where it is enabled already), so that a leg on this
// card can load from a slab there; an error where the cards cannot
extern "C" int vx_enable_peer_access(int peer) {
  int device = 0, can = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || peer == device) return static_cast<int>(err);
  err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    (void)cudaGetLastError();  // clear it: an enabled peer is what was asked for
    return static_cast<int>(cudaSuccess);
  }
  return static_cast<int>(err);
}

// -log(1 - xi) as the leg kernels compute it, for a check against
// torch.log; on no render path
extern "C" int vx_neg_log1m(const float* xi, float* out, long long n, cudaStream_t stream) {
  if (n > 0) neg_log1m_kernel<<<blocks_for(n), kThreads, 0, stream>>>(xi, out, n);
  return static_cast<int>(cudaGetLastError());
}
