// One kernel per no_dda leg: delta tracking (the camera leg) and ratio
// tracking (the shadow leg) against the global majorant, each lane until it
// ends.
//
// Replaces the event loops of volxel_tpu/render/modes.py:
// _simple_sample_loop (:1290-1343, after sample_volume_simple's setup) and
// _simple_transmittance_loop (:1467-1522, after transmittance_simple's),
// whose every event decodes the density (trilinear, then the transfer
// LUT's NEAREST row with range rejection: the last render site of the
// Pallas kernel volxel_tpu/render/mxu_gather.py: mxu_gather_f32) and makes
// the draws (normal.glsl:8-55). Plain versions:
// volxel_tpu_torch/render/trackleg.py: track_leg_sample_plain and
// track_leg_shadow_plain, the event loop over the lanes still running.
//
// Why one launch gives the event loop's result: the JAX loop caps all
// lanes with one global counter (it < TRACKING_MAX_EVENTS), but every lane
// enters at event 0 and a lane that stops never runs again, so at global
// event k every running lane has had exactly k events: a per-lane cap of
// `cap` events is the same cap. Each lane's words, t and tr are its own.
//
// What bounds it on an H100: latency. An event is eight bf16 taps of the
// field at a point that the previous event's draw decided (four to eight
// 32-byte sectors), one 16-byte LUT row, two or three draws, a log and a
// few dozen f32 operations; nothing of the next event can start before
// them. Lanes diverge: a ray through air takes a few long free flights, one
// through tissue hundreds of short ones.
//
// Design: one thread per lane, lanes in pixel order, 128 threads a block,
// the lane's state in registers, the field and the LUT read through the
// read-only cache (__ldg). A warp lives until its slowest lane ends; in
// exchange a leg is one launch with no host sync, one lane's taps overlap
// other lanes' arithmetic, and no lane state goes through device memory
// between events. Every lane writes its outputs once, with the events it
// has left of `cap`.
//
// Bit-equality with the plain version: leg_common.cuh's rules, and every
// f32 operation the plain version's in its order: p_real = (vol_maj * a) *
// inv_maj; t - log(1 - xi) * inv_maj with log(1 - xi) = -neg_log1m(xi)
// exactly (negation is exact); tr * (1 - d * inv_maj); the renormalisation
// tr / clamp_min(tr, 1e-20) an IEEE division. The constants 0.1 and 1e-20
// are rounded to f32 once, as PyTorch rounds a Python scalar against an
// f32 tensor.

#include "leg_common.cuh"

namespace {

// the per-lane operands both legs read and the outputs both write
struct Tracks {
  const float *ipos, *idir, *far, *t;
  const int64_t* state;
  const bool* running;
  int cap;
  int64_t* state_out;
  int* events_out;
  long long n;
};

// one lane's ray
struct Ray {
  float p[3], d[3], far;
};

__device__ __forceinline__ Ray load_ray(const Tracks& a, long long i) {
  Ray r;
  for (int k = 0; k < 3; ++k) {
    r.p[k] = a.ipos[3 * i + k];
    r.d[k] = a.idir[3 * i + k];
  }
  r.far = a.far[i];
  return r;
}

__device__ __forceinline__ void load_state(const Tracks& a, long long i, uint32_t (&s)[4]) {
  for (int j = 0; j < 4; ++j) s[j] = static_cast<uint32_t>(a.state[4 * i + j]);
}

__device__ __forceinline__ void store_common(const Tracks& a, long long i, const uint32_t (&s)[4], int events) {
  for (int j = 0; j < 4; ++j) a.state_out[4 * i + j] = static_cast<int64_t>(s[j]);
  a.events_out[i] = events;
}

// the next free flight: t - log(1 - xi) * inv_maj
__device__ __forceinline__ float fly(float t, float xi, float inv_maj) {
  return __fsub_rn(t, __fmul_rn(-neg_log1m(xi), inv_maj));
}

// modes.sample_volume_simple's leg (normal.glsl:36-55): at each event the
// decode and the real/null draw; a real collision ends the lane with the
// LUT colour, a null one draws the next free flight
__global__ void __launch_bounds__(kThreads) track_leg_sample_kernel(Volume v, Tracks a, bool* __restrict__ hit_out,
                                                                    float* __restrict__ t_out,
                                                                    float* __restrict__ rgb_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  uint32_t s[4];
  load_state(a, i, s);
  float t = a.t[i];
  int events = a.cap;
  bool hit = false;
  float rgb[3] = {1.0f, 1.0f, 1.0f};
  if (a.running[i]) {
    const Ray r = load_ray(a, i);
    const float vol_maj = __ldg(v.scalars + kVolMaj), inv_maj = __ldg(v.scalars + kInvMaj);
    while (events > 0) {
      const float4 rgba = decode(v, r.p, r.d, t);
      events -= 1;
      if (next_float(s) < __fmul_rn(__fmul_rn(vol_maj, rgba.w), inv_maj)) {
        hit = true;
        rgb[0] = rgba.x;
        rgb[1] = rgba.y;
        rgb[2] = rgba.z;
        break;
      }
      t = fly(t, next_float(s), inv_maj);
      if (!(t < r.far)) break;
    }
  }
  store_common(a, i, s, events);
  hit_out[i] = hit;
  t_out[i] = t;
  for (int k = 0; k < 3; ++k) rgb_out[3 * i + k] = rgb[k];
}

// modes.transmittance_simple's leg (normal.glsl:8-33): at each event the
// decode and tr *= 1 - d / majorant; russian roulette under 0.1 (a killed
// lane ends with tr = 0 before the free-flight draw), then the next free
// flight
__global__ void __launch_bounds__(kThreads) track_leg_shadow_kernel(Volume v, Tracks a,
                                                                    const float* __restrict__ tr_in,
                                                                    float* __restrict__ tr_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  uint32_t s[4];
  load_state(a, i, s);
  float tr = tr_in[i];
  int events = a.cap;
  if (a.running[i]) {
    const Ray r = load_ray(a, i);
    const float vol_maj = __ldg(v.scalars + kVolMaj), inv_maj = __ldg(v.scalars + kInvMaj);
    float t = a.t[i];
    while (events > 0) {
      const float d = __fmul_rn(vol_maj, decode(v, r.p, r.d, t).w);
      events -= 1;
      tr = __fmul_rn(tr, __fsub_rn(1.0f, __fmul_rn(d, inv_maj)));
      if (tr < static_cast<float>(0.1)) {
        if (next_float(s) < __fsub_rn(1.0f, tr)) {
          tr = 0.0f;
          break;
        }
        tr = div_rn(tr, clamp_min(tr, static_cast<float>(1e-20)));
      }
      t = fly(t, next_float(s), inv_maj);
      if (!(t < r.far)) break;
    }
  }
  store_common(a, i, s, events);
  tr_out[i] = tr;
}

}  // namespace

extern "C" int vx_track_leg_sample(const uint16_t* dense, int ny, int nx, int ex, int ey, int ez, const float* lut,
                                   int lut_k, const float* scalars, const float* ipos, const float* idir,
                                   const float* far, const float* t, const int64_t* state, const bool* running,
                                   int cap, int64_t* state_out, bool* hit_out, float* t_out, float* rgb_out,
                                   int* events_out, long long n, cudaStream_t stream) {
  if (n > 0) {
    const Volume v{nullptr, 0, 0, 0, dense, ny, nx, ex, ey, ez, reinterpret_cast<const float4*>(lut), lut_k,
                   scalars};
    const Tracks a{ipos, idir, far, t, state, running, cap, state_out, events_out, n};
    track_leg_sample_kernel<<<blocks_for(n), kThreads, 0, stream>>>(v, a, hit_out, t_out, rgb_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vx_track_leg_shadow(const uint16_t* dense, int ny, int nx, int ex, int ey, int ez, const float* lut,
                                   int lut_k, const float* scalars, const float* ipos, const float* idir,
                                   const float* far, const float* t, const int64_t* state, const bool* running,
                                   const float* tr, int cap, int64_t* state_out, float* tr_out, int* events_out,
                                   long long n, cudaStream_t stream) {
  if (n > 0) {
    const Volume v{nullptr, 0, 0, 0, dense, ny, nx, ex, ey, ez, reinterpret_cast<const float4*>(lut), lut_k,
                   scalars};
    const Tracks a{ipos, idir, far, t, state, running, cap, state_out, events_out, n};
    track_leg_shadow_kernel<<<blocks_for(n), kThreads, 0, stream>>>(v, a, tr, tr_out);
  }
  return static_cast<int>(cudaGetLastError());
}
