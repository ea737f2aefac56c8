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
// `cap` events is the same cap. Each lane's words, t and tr are its own,
// so its outputs do not depend on which thread tracks it or on the other
// lanes of the launch.
//
// What bounds it on an H100: not bytes (the kernels run at 13-22% of their
// bytes bound) but each lane's chain of events and the instructions they
// issue. An event's point is the previous event's free flight, and an
// event is ~170-180 SASS instructions besides the out-of-line log: the
// cell and predicates of the eight bf16 taps, the trilinear sum, the LUT
// row, two or three xoshiro draws. With every load replaced by a register
// constant (issue-only variants, PERF.md section 6) the
// camera leg takes ~0.9 ms at a 1080p sample, with its taps fetched only
// when an event is reached ~1.7 ms: fetched then, the taps' latency sits on
// the chain. Lanes diverge: a ray through air takes a few long free
// flights, one through tissue hundreds of short ones, and a warp lives
// until its slowest lane ends (warp efficiency 0.78 in the camera leg, 0.22
// in the shadow leg, whose median lane takes 3 events).
//
// Design: one thread per lane, lanes in pixel order, 128 threads a block,
// the lane's state in registers. The kernels declare
// __launch_bounds__(kThreads, 1): with the block size alone, ptxas saved
// registers (40 instead of 48 in the shadow leg) by issuing the z + 1 rows'
// four taps only after the first four were decoded, two memory round trips
// an event, and the shadow leg took 0.49 ms instead of 0.36.
// - The tap fetch and decode are leg_common.cuh's, which the default legs
//   share: the cell located with 32-bit saturating casts, one 64-bit index
//   for its first corner (a 32-bit one measured no faster), each of the
//   eight 2-byte loads predicated on its tap being inside.
// - Events ahead, in the camera leg: it keeps the taps of the next
//   kSampleAhead events in flight while it decodes the current one. A null
//   event takes exactly two draws (real/null, then the free flight) and a
//   real one ends the lane, so the point of event k + j is a function of
//   the lane's words and t alone: a second copy of the words (q) takes each
//   real/null draw (kept for the event it belongs to) and each free flight,
//   while the true words (s) advance as the events resolve. The arithmetic
//   and its order are the plain version's; only when the loads are issued
//   changes, and what was fetched past the lane's end is dropped. The ring
//   of kSampleAhead + 1 events is unrolled, so every slot stays in
//   registers.
// - The shadow leg fetches each event's taps when it takes the event. Its
//   speculation (no roulette draw, the point re-derived after one) and a
//   persistent grid refilled per warp or per lane from a device counter
//   were measured and left out, as were x taps paired in one 4- or 8-byte
//   load in both legs (their unpacking costs more instructions than the
//   loads save) and more events ahead in the camera leg (registers): at
//   1080p there are about as many running shadow lanes as resident
//   threads, so refills recover little, and their votes and atomics cost
//   more (PERF.md section 6).
//
// Bit-equality with the plain version: leg_common.cuh's rules, and every
// f32 operation the plain version's in its order: p_real = (vol_maj * a) *
// inv_maj; t - log(1 - xi) * inv_maj with log(1 - xi) = -neg_log1m(xi)
// exactly (negation is exact); tr * (1 - d * inv_maj); the renormalisation
// tr / clamp_min(tr, 1e-20) an IEEE division; the LUT row clamp(floor(y),
// 0, K - 1) as floor(clamp(y, 0, K - 1)) (fmaxf takes a NaN y to 0, as the
// cast does). The constants 0.1 and 1e-20 are rounded to f32 once, as
// PyTorch rounds a Python scalar against an f32 tensor.
//
// Render-time volume slabs: vx_track_leg_*_slabs launch the same legs over
// a SlabField (leg_common.cuh), as kernels of their own.
//
// Park forms (a vz row across nodes, parallel/migrate.py):
// vx_track_leg_*_slabs_park launch them over a table whose slabs on other
// nodes are null, from each lane's events left. An event's taps are issued
// ahead of it, so the park test (leg_common.cuh's parked_owner) goes where
// an event is issued: an event whose taps lie in an absent slab is issued
// without loads, and a lane that reaches it parks there, before its decode
// and draws, with its t, words and events (and tr) as they are, which is
// all the state of a lane: the same kernel resumes it. They are other
// instantiations (Lane's kPark), so the dense and slab forms keep their code.

#include <type_traits>
#include <utility>

#include "leg_common.cuh"

namespace {

// the camera leg's events whose taps are in flight beyond the one it
// decodes (the shadow leg's: none)
constexpr int kSampleAhead = 2;
static_assert(kSampleAhead >= 1, "the camera leg's real/null draw is kept in its event's slot");
constexpr int kSample = 0, kShadow = 1;

// the per-lane operands both legs read and the outputs they write
struct Tracks {
  const float *ipos, *idir, *far, *t;
  const int64_t* state;
  const bool* running;
  const float* tr_in;
  int cap;
  int64_t* state_out;
  int* events_out;
  bool* hit_out;
  float *t_out, *rgb_out, *tr_out;
  long long n;
};

// one event in flight: its t, its real/null draw (camera leg) and its taps
struct Event {
  float t, xr;
  Taps taps;
};

// the park forms' event: also the absent slab its taps lie in (-1: loaded)
struct ParkEvent : Event {
  int owner;
};

// the park forms' per-lane input and output beside Tracks (whose cap they
// do not read)
struct TrackParks {
  const int* events_in;  // each lane's events left
  int* park_out;         // the absent slab a lane parked at (-1 elsewhere)
};

// the next free flight: t - log(1 - xi) * inv_maj
__device__ __forceinline__ float fly(float t, float xi, float inv_maj) {
  return __fsub_rn(t, __fmul_rn(-neg_log1m(xi), inv_maj));
}

// the taps of an event at t, issued
template <class F>
__device__ __forceinline__ void fetch(const F& v, const float (&p)[3], const float (&d)[3], float t, Event& e) {
  e.t = t;
  fetch(v, p, d, t, e.taps);
}

// the same where an absent slab parks the lane: no loads for such an event
template <class F>
__device__ __forceinline__ void fetch(const F& v, const float (&p)[3], const float (&d)[3], float t, ParkEvent& e) {
  e.t = t;
  e.owner = parked_owner(v, p, d, t);
  if (e.owner < 0) fetch(v, p, d, t, e.taps);
}

// one lane of a leg: its operands, its words (s the true ones, q the
// events ahead's), its ring of kAhead + 1 events, its outputs; kPark: a
// park form's lane, which stops at an event of an absent slab (`parked`)
template <int Leg, bool kPark = false>
struct Lane {
  static constexpr int kAhead = Leg == kSample ? kSampleAhead : 0, kRing = kAhead + 1;
  using Slot = std::conditional_t<kPark, ParkEvent, Event>;
  long long i;
  Scalars c;
  uint32_t s[4], q[4];
  float p[3], d[3], far, t, tr;
  int events, parked;
  bool hit;
  float rgb[3];
  Slot ring[kRing];

  __host__ __device__ static constexpr int at(int phase, int k) { return (phase + k) % kRing; }

  // the lane's words, t and outputs as a lane that does not run leaves them
  __device__ __forceinline__ void begin(const Tracks& a, long long lane) {
    i = lane;
    for (int j = 0; j < 4; ++j) s[j] = static_cast<uint32_t>(a.state[4 * i + j]);
    t = a.t[i];
    events = a.cap;
    hit = false;
    rgb[0] = rgb[1] = rgb[2] = 1.0f;
    if constexpr (Leg == kShadow) tr = a.tr_in[i];
  }
  // the ray of a running lane, and its first kAhead events fetched
  template <class F>
  __device__ __forceinline__ void start(const F& v, const Tracks& a) {
    for (int k = 0; k < 3; ++k) {
      p[k] = a.ipos[3 * i + k];
      d[k] = a.idir[3 * i + k];
    }
    far = a.far[i];
    if constexpr (kAhead > 0) {
      for (int j = 0; j < 4; ++j) q[j] = s[j];
      fetch(v, p, d, t, ring[0]);
#pragma unroll
      for (int k = 1; k < kAhead; ++k) fetch_next(v, ring[k - 1], ring[k]);
    }
  }

  // the camera leg's event after `prev`, fetched before `prev` is decoded:
  // q's next draw is prev's real/null draw, the one after it the free
  // flight to `next`
  template <class F>
  __device__ __forceinline__ void fetch_next(const F& v, Slot& prev, Slot& next) {
    if constexpr (Leg == kSample) prev.xr = next_float(q);
    fetch(v, p, d, fly(prev.t, next_float(q), c.inv_maj), next);
  }

  __device__ __forceinline__ void finish(const Tracks& a) const {
    for (int j = 0; j < 4; ++j) a.state_out[4 * i + j] = static_cast<int64_t>(s[j]);
    a.events_out[i] = events;
    if constexpr (Leg == kSample) {
      a.hit_out[i] = hit;
      a.t_out[i] = t;
      for (int k = 0; k < 3; ++k) a.rgb_out[3 * i + k] = rgb[k];
    } else {
      a.tr_out[i] = tr;
    }
  }

  // one event at ring phase `Phase`; returns whether the lane ended
  template <int Phase, class F>
  __device__ __forceinline__ bool step(const F& v) {
    Slot& cur = ring[at(Phase, 0)];
    if constexpr (kAhead == 0) {
      fetch(v, p, d, t, cur);
    } else {
      fetch_next(v, ring[at(Phase, kAhead - 1)], ring[at(Phase, kAhead)]);
    }
    if constexpr (kPark) {
      if (cur.owner >= 0) {  // its taps lie in an absent slab: park before its decode and draws
        parked = cur.owner;
        return true;
      }
    }
    const float4 rgba = decode(v, c, cur.taps);
    events -= 1;
    if constexpr (Leg == kSample) {
      // modes.sample_volume_simple's event (normal.glsl:36-55): a real
      // collision ends the lane with the LUT colour (one draw), a null one
      // flies on (two draws)
      (void)next_float(s);
      if (cur.xr < __fmul_rn(__fmul_rn(c.vol_maj, rgba.w), c.inv_maj)) {
        hit = true;
        rgb[0] = rgba.x;
        rgb[1] = rgba.y;
        rgb[2] = rgba.z;
        return true;
      }
      (void)next_float(s);
      t = ring[at(Phase, 1)].t;
    } else {
      // modes.transmittance_simple's event (normal.glsl:8-33): tr *= 1 -
      // d / majorant; russian roulette under 0.1 (a killed lane ends with
      // tr = 0 before the free-flight draw), then the free flight
      tr = __fmul_rn(tr, __fsub_rn(1.0f, __fmul_rn(__fmul_rn(c.vol_maj, rgba.w), c.inv_maj)));
      if (tr < static_cast<float>(0.1)) {
        if (next_float(s) < __fsub_rn(1.0f, tr)) {
          tr = 0.0f;
          return true;
        }
        tr = div_rn(tr, clamp_min(tr, static_cast<float>(1e-20)));
      }
      t = fly(t, next_float(s), c.inv_maj);
    }
    return !(t < far) || events <= 0;
  }

  // the events until the lane ends, the ring's phases unrolled
  template <class F, int... Phase>
  __device__ __forceinline__ bool cycle(const F& v, std::integer_sequence<int, Phase...>) {
    return (step<Phase>(v) || ...);
  }
};

template <int Leg, class F>
__device__ __forceinline__ void track(const F& v, const Tracks& a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  Lane<Leg> lane;
  lane.c = load_scalars(v);
  lane.begin(a, i);
  if (a.running[i]) {
    lane.start(v, a);
    while (!lane.cycle(v, std::make_integer_sequence<int, Lane<Leg>::kRing>{})) {
    }
  }
  lane.finish(a);
}

// track's park form: each lane's events from the inputs; it writes where
// each lane parked, and the shadow leg a parked lane's t (the input t
// elsewhere)
template <int Leg, class F>
__device__ __forceinline__ void track_park(const F& v, const Tracks& a, const TrackParks& k) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  Lane<Leg, true> lane;
  lane.c = load_scalars(v);
  lane.begin(a, i);
  lane.events = k.events_in[i];
  lane.parked = -1;
  if (a.running[i]) {
    lane.start(v, a);
    while (!lane.cycle(v, std::make_integer_sequence<int, Lane<Leg, true>::kRing>{})) {
    }
  }
  lane.finish(a);
  k.park_out[i] = lane.parked;
  if constexpr (Leg == kShadow) a.t_out[i] = lane.parked >= 0 ? lane.t : a.t[i];
}

__global__ void __launch_bounds__(kThreads, 1) track_leg_sample_kernel(Field v, Tracks a) { track<kSample>(v, a); }
__global__ void __launch_bounds__(kThreads, 1) track_leg_shadow_kernel(Field v, Tracks a) { track<kShadow>(v, a); }

// the same over z-slabs
template <bool kRound>
__global__ void __launch_bounds__(kThreads, 1) track_leg_sample_slabs_kernel(SlabField<kRound> v, Tracks a) {
  track<kSample>(v, a);
}
template <bool kRound>
__global__ void __launch_bounds__(kThreads, 1) track_leg_shadow_slabs_kernel(SlabField<kRound> v, Tracks a) {
  track<kShadow>(v, a);
}

// the park forms
template <bool kRound>
__global__ void __launch_bounds__(kThreads, 1) track_leg_sample_park_kernel(SlabField<kRound> v, Tracks a,
                                                                           TrackParks k) {
  track_park<kSample>(v, a, k);
}
template <bool kRound>
__global__ void __launch_bounds__(kThreads, 1) track_leg_shadow_park_kernel(SlabField<kRound> v, Tracks a,
                                                                           TrackParks k) {
  track_park<kShadow>(v, a, k);
}

template <bool kRound>
void launch_park(int leg, const SlabField<kRound>& v, const Tracks& a, const TrackParks& k, cudaStream_t stream) {
  if (leg == kSample) {
    track_leg_sample_park_kernel<kRound><<<blocks_for(a.n), kThreads, 0, stream>>>(v, a, k);
  } else {
    track_leg_shadow_park_kernel<kRound><<<blocks_for(a.n), kThreads, 0, stream>>>(v, a, k);
  }
}

int launch_park(int leg, const uint16_t* const* slabs, int slab, int round_taps, int ny, int nx, int ex, int ey,
                int ez, const float* lut, int lut_k, const float* scalars, const Tracks& a, const TrackParks& k,
                cudaStream_t stream) {
  if (a.n > 0) {
    if (round_taps) {
      launch_park(leg, make_slab_field<true>(slabs, slab, ny, nx, ex, ey, ez, lut, lut_k, scalars), a, k, stream);
    } else {
      launch_park(leg, make_slab_field<false>(slabs, slab, ny, nx, ex, ey, ez, lut, lut_k, scalars), a, k, stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kRound>
void launch_slabs(int leg, const SlabField<kRound>& v, const Tracks& a, cudaStream_t stream) {
  if (leg == kSample) {
    track_leg_sample_slabs_kernel<kRound><<<blocks_for(a.n), kThreads, 0, stream>>>(v, a);
  } else {
    track_leg_shadow_slabs_kernel<kRound><<<blocks_for(a.n), kThreads, 0, stream>>>(v, a);
  }
}

int launch_slabs(int leg, const uint16_t* const* slabs, int slab, int round_taps, int ny, int nx, int ex, int ey,
                 int ez, const float* lut, int lut_k, const float* scalars, const Tracks& a, cudaStream_t stream) {
  if (a.n > 0) {
    if (round_taps) {
      launch_slabs(leg, make_slab_field<true>(slabs, slab, ny, nx, ex, ey, ez, lut, lut_k, scalars), a, stream);
    } else {
      launch_slabs(leg, make_slab_field<false>(slabs, slab, ny, nx, ex, ey, ez, lut, lut_k, scalars), a, stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

using Kernel = void (*)(Field, Tracks);

Kernel kernel_of(int leg) { return leg == kSample ? track_leg_sample_kernel : track_leg_shadow_kernel; }

int launch(int leg, const uint16_t* dense, int ny, int nx, int ex, int ey, int ez, const float* lut, int lut_k,
           const float* scalars, const Tracks& a, cudaStream_t stream) {
  if (a.n > 0) {
    const Field v = make_field(dense, ny, nx, ex, ey, ez, lut, lut_k, scalars);
    kernel_of(leg)<<<blocks_for(a.n), kThreads, 0, stream>>>(v, a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vx_track_leg_sample(const uint16_t* dense, int ny, int nx, int ex, int ey, int ez, const float* lut,
                                   int lut_k, const float* scalars, const float* ipos, const float* idir,
                                   const float* far, const float* t, const int64_t* state, const bool* running,
                                   int cap, int64_t* state_out, bool* hit_out, float* t_out, float* rgb_out,
                                   int* events_out, long long n, cudaStream_t stream) {
  const Tracks a{ipos, idir, far, t, state, running, nullptr, cap, state_out, events_out, hit_out, t_out, rgb_out,
                 nullptr, n};
  return launch(kSample, dense, ny, nx, ex, ey, ez, lut, lut_k, scalars, a, stream);
}

extern "C" int vx_track_leg_shadow(const uint16_t* dense, int ny, int nx, int ex, int ey, int ez, const float* lut,
                                   int lut_k, const float* scalars, const float* ipos, const float* idir,
                                   const float* far, const float* t, const int64_t* state, const bool* running,
                                   const float* tr, int cap, int64_t* state_out, float* tr_out, int* events_out,
                                   long long n, cudaStream_t stream) {
  const Tracks a{ipos, idir, far, t, state, running, tr, cap, state_out, events_out, nullptr, nullptr, nullptr,
                 tr_out, n};
  return launch(kShadow, dense, ny, nx, ex, ey, ez, lut, lut_k, scalars, a, stream);
}

extern "C" int vx_track_leg_sample_slabs(const uint16_t* const* slabs, int slab, int round_taps, int ny, int nx,
                                         int ex, int ey, int ez, const float* lut, int lut_k, const float* scalars,
                                         const float* ipos, const float* idir, const float* far, const float* t,
                                         const int64_t* state, const bool* running, int cap, int64_t* state_out,
                                         bool* hit_out, float* t_out, float* rgb_out, int* events_out, long long n,
                                         cudaStream_t stream) {
  const Tracks a{ipos, idir, far, t, state, running, nullptr, cap, state_out, events_out, hit_out, t_out, rgb_out,
                 nullptr, n};
  return launch_slabs(kSample, slabs, slab, round_taps, ny, nx, ex, ey, ez, lut, lut_k, scalars, a, stream);
}

extern "C" int vx_track_leg_shadow_slabs(const uint16_t* const* slabs, int slab, int round_taps, int ny, int nx,
                                         int ex, int ey, int ez, const float* lut, int lut_k, const float* scalars,
                                         const float* ipos, const float* idir, const float* far, const float* t,
                                         const int64_t* state, const bool* running, const float* tr, int cap,
                                         int64_t* state_out, float* tr_out, int* events_out, long long n,
                                         cudaStream_t stream) {
  const Tracks a{ipos, idir, far, t, state, running, tr, cap, state_out, events_out, nullptr, nullptr, nullptr,
                 tr_out, n};
  return launch_slabs(kShadow, slabs, slab, round_taps, ny, nx, ex, ey, ez, lut, lut_k, scalars, a, stream);
}

extern "C" int vx_track_leg_sample_slabs_park(const uint16_t* const* slabs, int slab, int round_taps, int ny,
                                              int nx, int ex, int ey, int ez, const float* lut, int lut_k,
                                              const float* scalars, const float* ipos, const float* idir,
                                              const float* far, const float* t, const int64_t* state,
                                              const bool* running, const int* events_in, int64_t* state_out,
                                              bool* hit_out, float* t_out, float* rgb_out, int* events_out,
                                              int* park_out, long long n, cudaStream_t stream) {
  const Tracks a{ipos, idir, far, t, state, running, nullptr, 0, state_out, events_out, hit_out, t_out, rgb_out,
                 nullptr, n};
  return launch_park(kSample, slabs, slab, round_taps, ny, nx, ex, ey, ez, lut, lut_k, scalars, a,
                     TrackParks{events_in, park_out}, stream);
}

extern "C" int vx_track_leg_shadow_slabs_park(const uint16_t* const* slabs, int slab, int round_taps, int ny,
                                              int nx, int ex, int ey, int ez, const float* lut, int lut_k,
                                              const float* scalars, const float* ipos, const float* idir,
                                              const float* far, const float* t, const int64_t* state,
                                              const bool* running, const int* events_in, const float* tr,
                                              int64_t* state_out, float* tr_out, int* events_out, float* t_out,
                                              int* park_out, long long n, cudaStream_t stream) {
  const Tracks a{ipos, idir, far, t, state, running, tr, 0, state_out, events_out, nullptr, t_out, nullptr, tr_out,
                 n};
  return launch_park(kShadow, slabs, slab, round_taps, ny, nx, ex, ey, ez, lut, lut_k, scalars, a,
                     TrackParks{events_in, park_out}, stream);
}

// the warps that leg `leg`'s kernel (0 camera, 1 shadow) keeps resident on
// one SM of the current card
extern "C" int vx_track_leg_resident_warps(int leg, int* warps) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel_of(leg), kThreads, 0);
  *warps = blocks * kThreads / 32;
  return static_cast<int>(err);
}
