// Design variants of the no_dda leg kernels (volxel_tpu_torch/csrc/track_leg.cu),
// each one template instantiation, for examples/trackleg_variants.py.
//
// Every variant computes what track_leg_sample_plain / track_leg_shadow_plain
// compute, bit for bit, under the rules of leg_common.cuh (the file is built
// with the flags kernels.FMAD_SOURCES gives track_leg.cu); the parameters
// change only how the taps are addressed and loaded, when they are issued,
// and which thread takes which lane:
//
//   I     the tap index type: uint64_t (the parent's 64-bit form) or
//         uint32_t (after the exact 64-bit inside test);
//   K     bf16 elements per load: 1 (eight 2-byte loads an event), 2 or 4
//         (one aligned 4- or 8-byte unit holds both x taps of a (y, z) row,
//         a second 2-byte load where the pair straddles two units);
//   D     events whose taps are in flight beyond the current one (0: none);
//         the camera leg's next t needs no decode (a null event takes two
//         draws, a real one ends the lane), the shadow leg's is speculated
//         on no roulette draw and re-derived when one comes;
//   R     0: one thread per lane in pixel order; 1: a persistent grid whose
//         warps take 32 lanes from a device counter once all theirs ended;
//         2: the same, each lane refilled as it ends (warp-aggregated
//         atomics);
//   Fake  issue-only: every load replaced by a register constant that
//         depends on its address (the address arithmetic stays), the lane's
//         event count forced from a recorded run; not bit-equal.
//
// Each variant also adds its warps' iterations (lane-events resident / 32)
// to work[1]; work[0] is the lane counter of R >= 1.

#include <algorithm>
#include <type_traits>

#include "leg_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSample = 0, kShadow = 1;
constexpr float kMagic = 12582912.0f;       // 1.5 * 2^23
constexpr float kMagicRange = 4194304.0f;  // 2^22

template <int... J>
struct Seq {};
template <int N, int... J>
struct MakeSeq : MakeSeq<N - 1, N - 1, J...> {};
template <int... J>
struct MakeSeq<0, J...> {
  using type = Seq<J...>;
};

template <typename I_, int K_, int D_, int R_, bool Fake_, bool Lean_, bool Tight_ = false>
struct Cfg {
  using I = I_;
  static constexpr int K = K_, D = D_, R = R_;
  static constexpr bool Fake = Fake_, Lean = Lean_, Tight = Tight_;
  using Unit = typename std::conditional<K_ == 4, unsigned long long, uint32_t>::type;
};

struct Grid {
  const uint16_t* dense;
  int ny, nx;
  long long ex, ey, ez;
  unsigned long long nunits2, nunits4;  // whole 4- and 8-byte units of the field
  const float4* lut;
  int lut_k;
  const float* scalars;
  long long plane;       // nx * ny
  float lut_kf, lut_top;  // K and K - 1 as f32
};

struct Tracks {
  const float *ipos, *idir, *far, *t;
  const int64_t* state;
  const bool* running;
  const float* tr_in;
  const int* forced;  // Fake: the events left at which each lane stopped
  int cap;
  int64_t* state_out;
  int* events_out;
  bool* hit_out;
  float *t_out, *rgb_out, *tr_out;
  unsigned long long* work;
  long long n;
};

__device__ __forceinline__ float fly(float t, float xi, float inv_maj) {
  return __fsub_rn(t, __fmul_rn(-neg_log1m(xi), inv_maj));
}

// one xoshiro128++ step whose draw is not needed
__device__ __forceinline__ void advance(uint32_t (&s)[4]) { (void)next_float(s); }

// a load that Fake replaces by a constant the compiler cannot fold (the
// address is never 1), so that the address arithmetic stays
template <bool Fake, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (!Fake) {
    return __ldg(p);
  } else {
    uint32_t r;
    asm volatile("{\n .reg .pred q;\n setp.eq.u64 q, %1, 1;\n selp.b32 %0, 0, 0x3f003f00, q;\n}"
                 : "=r"(r)
                 : "l"(reinterpret_cast<unsigned long long>(p)));
    if constexpr (sizeof(T) == 8) {
      return static_cast<T>((static_cast<unsigned long long>(r) << 32) | r);
    } else {
      return static_cast<T>(r);
    }
  }
}

// the taps of one event, in flight: per (y, z) row the unit that holds the
// first valid x tap and, where needed, the second tap alone
template <class C>
struct Slot {
  float t, xr;  // xr: the camera leg's real/null draw of this event (D >= 1)
  float f[3];   // the trilinear fractions
  typename C::Unit a[4];
  uint32_t b[4];
  uint32_t bits[8];  // Tight: each tap's bf16 bits, 0 outside the extent
  uint32_t meta;  // per row r, bits 5r..: v0, v1, the second tap loaded alone, the first tap's place in its unit
};

template <class C>
__device__ __forceinline__ uint32_t half_of(typename C::Unit a, int p) {
  if constexpr (C::K == 1) {
    return a;
  } else {
    return static_cast<uint32_t>(a >> (16 * p)) & 0xffffu;
  }
}

// sampling.lookup_density_trilinear's taps at p + t * d: locate the cell
// exactly as the 64-bit form does (the same casts, the same wrap-around,
// the same inside test), narrow the index only after it, and issue the
// loads
// Tight (K == 1): the cell located with 32-bit saturating casts, which
// reject exactly the taps the 64-bit casts reject (a base of 2^31 or more,
// or below -2^31, has both offsets outside any extent < 2^31; NaN lands on
// 0 in both), and float(base) of the 64-bit form as floor(q) clamped to
// +-2^63 (where the 64-bit cast saturates; a NaN gives NaN either way);
// one index for the cell's first corner, the other taps at constant
// offsets from it, each load predicated on its tap being inside
template <class C>
__device__ __forceinline__ void issue_tight(const Grid& v, const float (&p)[3], const float (&d)[3], float t,
                                            Slot<C>& s) {
  s.t = t;
  const float pos[3] = {__fadd_rn(p[0], __fmul_rn(t, d[0])), __fadd_rn(p[1], __fmul_rn(t, d[1])),
                        __fadd_rn(p[2], __fmul_rn(t, d[2]))};
  const int ext[3] = {static_cast<int>(v.ex), static_cast<int>(v.ey), static_cast<int>(v.ez)};
  int b[3];
  bool in[3][2];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float q = __fsub_rn(pos[a], 0.5f);
    b[a] = __float2int_rd(q);
    s.f[a] = __fsub_rn(q, fminf(fmaxf(floorf(q), -0x1p63f), 0x1p63f));
    in[a][0] = static_cast<unsigned>(b[a]) < static_cast<unsigned>(ext[a]);
    in[a][1] = static_cast<unsigned>(b[a]) + 1u < static_cast<unsigned>(ext[a]);
  }
  // the four (y, z) rows of the cell, the x + 1 tap two bytes on; with a
  // uint32_t index every inside tap's index and the corner's fit in int32
  using I = typename C::I;
  const uint16_t* row[4];
  if constexpr (sizeof(I) == 4) {
    const int i0 = static_cast<int>((static_cast<uint32_t>(b[2]) * v.ny + static_cast<uint32_t>(b[1])) * v.nx +
                                    static_cast<uint32_t>(b[0]));
    const int i2 = static_cast<int>(static_cast<uint32_t>(i0) + static_cast<uint32_t>(v.plane));
    row[0] = v.dense + i0;
    row[1] = v.dense + static_cast<int>(static_cast<uint32_t>(i0) + v.nx);
    row[2] = v.dense + i2;
    row[3] = v.dense + static_cast<int>(static_cast<uint32_t>(i2) + v.nx);
  } else {
    const long long i0 = (static_cast<long long>(b[2]) * v.ny + b[1]) * v.nx + b[0];
    row[0] = v.dense + i0;
    row[1] = row[0] + v.nx;
    row[2] = row[0] + v.plane;
    row[3] = row[2] + v.nx;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t x = 0;
    if (in[0][k & 1] && in[1][(k >> 1) & 1] && in[2][k >> 2]) x = load<C::Fake>(row[k >> 1] + (k & 1));
    s.bits[k] = x;
  }
}

template <class C>
__device__ __forceinline__ void issue(const Grid& v, const float (&p)[3], const float (&d)[3], float t,
                                      Slot<C>& s) {
  if constexpr (C::Tight) {
    issue_tight(v, p, d, t, s);
    return;
  }
  using I = typename C::I;
  s.t = t;
  const float pos[3] = {__fadd_rn(p[0], __fmul_rn(t, d[0])), __fadd_rn(p[1], __fmul_rn(t, d[1])),
                        __fadd_rn(p[2], __fmul_rn(t, d[2]))};
  const long long ext[3] = {v.ex, v.ey, v.ez};
  long long base[3];
  bool in[3][2];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float q = __fsub_rn(pos[a], 0.5f);
    if (C::Lean && fabsf(q) < kMagicRange) {
      // |q| < 2^22: floor(q) + 1.5 * 2^23 rounded down is exact, and its
      // bits less those of 1.5 * 2^23 are floor(q); float(base) is floor(q)
      const float m = __fadd_rd(q, kMagic);
      const int b = __float_as_int(m) - __float_as_int(kMagic);
      base[a] = b;
      s.f[a] = __fsub_rn(q, __fsub_rn(m, kMagic));
      in[a][0] = b >= 0 && b < ext[a];
      in[a][1] = b + 1 >= 0 && b + 1 < ext[a];
    } else {
      base[a] = static_cast<long long>(floorf(q));
      s.f[a] = __fsub_rn(q, static_cast<float>(base[a]));
      const long long c1 = static_cast<long long>(static_cast<unsigned long long>(base[a]) + 1);
      in[a][0] = base[a] >= 0 && base[a] < ext[a];
      in[a][1] = c1 >= 0 && c1 < ext[a];
    }
  }
  s.meta = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int dy = r & 1, dz = r >> 1;
    const bool row_ok = in[1][dy] && in[2][dz];
    const bool v0 = row_ok && in[0][0], v1 = row_ok && in[0][1];
    s.a[r] = 0;
    s.b[r] = 0;
    bool alone = false;
    int at = 0;
    if (v0 || v1) {
      const I cz = static_cast<I>(static_cast<unsigned long long>(base[2]) + dz);
      const I cy = static_cast<I>(static_cast<unsigned long long>(base[1]) + dy);
      const I row = (cz * static_cast<I>(v.ny) + cy) * static_cast<I>(v.nx);
      // x1 == 0 where only the second tap is inside
      const I first = v0 ? row + static_cast<I>(base[0]) : row;
      if constexpr (C::K == 1) {
        s.a[r] = load<C::Fake>(v.dense + first);
        alone = v0 && v1;
      } else {
        const I u = first / C::K;
        at = static_cast<int>(first % C::K);
        const bool partial = u >= static_cast<I>(C::K == 2 ? v.nunits2 : v.nunits4);
        if (partial) {
          s.a[r] = load<C::Fake>(v.dense + first);
          at = 0;
        } else {
          s.a[r] = load<C::Fake>(reinterpret_cast<const typename C::Unit*>(v.dense) + u);
        }
        alone = v0 && v1 && (partial || at == C::K - 1);
      }
      if (alone) s.b[r] = load<C::Fake>(v.dense + first + 1);
    }
    s.meta |= (static_cast<uint32_t>(v0) | static_cast<uint32_t>(v1) << 1 | static_cast<uint32_t>(alone) << 2 |
               static_cast<uint32_t>(at) << 3)
              << (5 * r);
  }
}

// the decode of a slot's event: the trilinear sum in _TAPS order (dz
// outer, dx inner), weights ((wx * wy) * wz), then the LUT's NEAREST row
// with range rejection
template <class C>
__device__ __forceinline__ float4 consume(const Grid& v, const Slot<C>& s, float den_scale, float inv_maj,
                                          float lo, float hi) {
  float w1[3][2];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    w1[a][0] = __fsub_rn(1.0f, s.f[a]);
    w1[a][1] = s.f[a];
  }
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if constexpr (C::Tight) {
      const float tap = __uint_as_float(s.bits[k] << 16);
      const float w = __fmul_rn(__fmul_rn(w1[0][k & 1], w1[1][(k >> 1) & 1]), w1[2][k >> 2]);
      const float term = __fmul_rn(tap, w);
      acc = k == 0 ? term : __fadd_rn(acc, term);
      continue;
    }
    const int dx = k & 1, r = k >> 1;
    const uint32_t m = s.meta >> (5 * r);
    const bool v0 = m & 1, v1 = (m >> 1) & 1, alone = (m >> 2) & 1;
    const int at = (m >> 3) & 3;
    uint32_t bits;
    if (dx == 0) {
      bits = v0 ? half_of<C>(s.a[r], at) : 0u;
    } else {
      bits = !v1 ? 0u : (!v0 ? half_of<C>(s.a[r], at) : (alone ? s.b[r] : half_of<C>(s.a[r], at + 1)));
    }
    const float tap = __uint_as_float(bits << 16);
    const float w = __fmul_rn(__fmul_rn(w1[0][dx], w1[1][(k >> 1) & 1]), w1[2][k >> 2]);
    const float term = __fmul_rn(tap, w);
    acc = k == 0 ? term : __fadd_rn(acc, term);
  }
  const float dn = __fmul_rn(__fmul_rn(den_scale, acc), inv_maj);
  const bool rejected = dn < lo || dn > hi;
  if constexpr (C::Tight) {
    // floor(clamp(y, 0, K - 1)) == clamp(floor(y), 0, K - 1) for integer
    // bounds; fmaxf takes a NaN y to 0 as the 64-bit cast does; K <= 2^24
    const float y = fminf(fmaxf(__fmul_rn(dn, v.lut_kf), 0.0f), v.lut_top);
    float4 row = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (!rejected) {
      if constexpr (C::Fake) {
        const float c = __uint_as_float(load<true>(reinterpret_cast<const uint32_t*>(v.lut + __float2int_rd(y))) &
                                        0x3f7fffffu);
        row = make_float4(c, c, c, c);
      } else {
        row = __ldg(v.lut + __float2int_rd(y));
      }
    }
    return row;
  }
  long long j;
  if constexpr (C::Lean) {
    // clamp(floor(y), 0, K - 1) == floor(clamp(y, 0, K - 1)) for integer
    // bounds; fmaxf takes a NaN y to 0 as the cast does; K <= 2^22
    const float y = fminf(fmaxf(__fmul_rn(dn, static_cast<float>(v.lut_k)), 0.0f), static_cast<float>(v.lut_k - 1));
    j = __float_as_int(__fadd_rd(y, kMagic)) - __float_as_int(kMagic);
  } else {
    j = static_cast<long long>(floorf(__fmul_rn(dn, static_cast<float>(v.lut_k))));
    j = j < 0 ? 0 : (j > v.lut_k - 1 ? v.lut_k - 1 : j);
  }
  if constexpr (C::Fake) {
    const float c = __uint_as_float(load<true>(reinterpret_cast<const uint32_t*>(v.lut + j)) & 0x3f7fffffu);
    return rejected ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : make_float4(c, c, c, c);
  } else {
    return rejected ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : __ldg(v.lut + j);
  }
}

// one lane of a leg: its operands, its words (s the true ones, q the
// speculation's), its ring of D + 1 slots, its outputs
template <class C, int Leg>
struct Lane {
  static constexpr int D = C::D, N = C::D + 1;
  long long i;
  uint32_t s[4], q[4];
  float p[3], d[3], far, t, tr;
  int events, stop, steps;
  bool hit;
  float rgb[3];
  Slot<C> sl[N];

  __host__ __device__ static constexpr int at(int j, int k) { return (j + k) % N; }

  // load lane i; a lane that does not run writes its outputs at once.
  // Returns whether it runs.
  template <int J>
  __device__ __forceinline__ bool begin(const Grid& v, const Tracks& a, long long lane, float inv_maj) {
    i = lane;
    for (int j = 0; j < 4; ++j) s[j] = static_cast<uint32_t>(a.state[4 * i + j]);
    t = a.t[i];
    events = a.cap;
    hit = false;
    rgb[0] = rgb[1] = rgb[2] = 1.0f;
    if constexpr (Leg == kShadow) tr = a.tr_in[i];
    if (!a.running[i]) {
      finish(a);
      return false;
    }
    for (int k = 0; k < 3; ++k) {
      p[k] = a.ipos[3 * i + k];
      d[k] = a.idir[3 * i + k];
    }
    far = a.far[i];
    if constexpr (C::Fake) stop = a.forced[i];
    if constexpr (D >= 1) {
      for (int j = 0; j < 4; ++j) q[j] = s[j];
      issue(v, p, d, t, sl[at(J, 0)]);
#pragma unroll
      for (int k = 1; k < D; ++k) {
        Slot<C>& prev = sl[at(J, k - 1)];
        if constexpr (Leg == kSample) prev.xr = next_float(q);
        issue(v, p, d, fly(prev.t, next_float(q), inv_maj), sl[at(J, k)]);
      }
    }
    return true;
  }

  __device__ __forceinline__ void finish(const Tracks& a) {
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

  // one event at ring phase J; returns whether the lane ended
  template <int J>
  __device__ __forceinline__ bool step(const Grid& v, float vol_maj, float inv_maj, float den_scale, float lo,
                                       float hi) {
    ++steps;
    Slot<C>& cur = sl[at(J, 0)];
    if constexpr (D == 0) {
      issue(v, p, d, t, cur);
    } else {
      Slot<C>& last = sl[at(J, D - 1)];
      if constexpr (Leg == kSample) last.xr = next_float(q);
      issue(v, p, d, fly(last.t, next_float(q), inv_maj), sl[at(J, D)]);
    }
    const float4 rgba = consume(v, cur, den_scale, inv_maj, lo, hi);
    events -= 1;
    const bool last_event = C::Fake && events == stop;
    if constexpr (Leg == kSample) {
      float xr;
      if constexpr (D == 0) {
        xr = next_float(s);
      } else {
        xr = cur.xr;
        advance(s);
      }
      const bool real = xr < __fmul_rn(__fmul_rn(vol_maj, rgba.w), inv_maj);
      if (C::Fake ? last_event : real) {
        hit = C::Fake ? real : true;
        rgb[0] = rgba.x;
        rgb[1] = rgba.y;
        rgb[2] = rgba.z;
        return true;
      }
      if constexpr (D == 0) {
        t = fly(t, next_float(s), inv_maj);
      } else {
        advance(s);
        t = sl[at(J, 1)].t;
      }
    } else {
      const float dens = __fmul_rn(vol_maj, rgba.w);
      tr = __fmul_rn(tr, __fsub_rn(1.0f, __fmul_rn(dens, inv_maj)));
      bool roulette = false;
      if (tr < static_cast<float>(0.1)) {
        if (next_float(s) < __fsub_rn(1.0f, tr) && !C::Fake) {
          tr = 0.0f;
          return true;
        }
        tr = div_rn(tr, clamp_min(tr, static_cast<float>(1e-20)));
        roulette = true;
      }
      if (C::Fake && last_event) return true;
      if (D == 0 || roulette) {
        t = fly(t, next_float(s), inv_maj);
      } else {
        advance(s);
        t = sl[at(J, 1)].t;
      }
      if constexpr (D >= 1) {
        // the speculation assumed no roulette draw: re-derive the slots
        // ahead from the true t and words
        if (roulette && t < far && events > 0) {
          for (int j = 0; j < 4; ++j) q[j] = s[j];
          issue(v, p, d, t, sl[at(J, 1)]);
#pragma unroll
          for (int k = 2; k <= D; ++k) issue(v, p, d, fly(sl[at(J, k - 1)].t, next_float(q), inv_maj), sl[at(J, k)]);
        }
      }
    }
    if (!C::Fake && !(t < far)) return true;
    return events <= 0;
  }
};

template <class C, int Leg>
struct Run {
  using L = Lane<C, Leg>;
  const Grid& v;
  const Tracks& a;
  L& lane;
  float vol_maj, inv_maj, den_scale, lo, hi;
  unsigned long long rounds_run;  // R == 2: the warp's rounds with a lane running

  // the events of one lane until it ends, the ring phases unrolled
  template <int... J>
  __device__ __forceinline__ bool cycle(Seq<J...>) {
    return (lane.template step<J>(v, vol_maj, inv_maj, den_scale, lo, hi) || ...);
  }
  __device__ __forceinline__ void track() {
    while (!cycle(typename MakeSeq<L::N>::type{})) {
    }
  }

  // R == 2: one warp round at phase J: refill the lanes that ended, then
  // one event of each running lane. Returns whether the warp is done.
  template <int J>
  __device__ __forceinline__ bool round(bool& busy, bool& drained, int me) {
    for (;;) {
      const unsigned need = __ballot_sync(kFull, !busy && !drained);
      if (!need) break;
      const int leader = __ffs(need) - 1;
      unsigned long long base = 0;
      if (me == leader) base = atomicAdd(a.work, static_cast<unsigned long long>(__popc(need)));
      base = __shfl_sync(kFull, base, leader);
      if (!busy && !drained) {
        const long long i = static_cast<long long>(base) + __popc(need & ((1u << me) - 1u));
        if (i >= a.n) {
          drained = true;
        } else {
          busy = lane.template begin<J>(v, a, i, inv_maj);
        }
      }
    }
    if (!__any_sync(kFull, busy)) return true;
    ++rounds_run;
    if (busy && lane.template step<J>(v, vol_maj, inv_maj, den_scale, lo, hi)) {
      lane.finish(a);
      busy = false;
    }
    return false;
  }
  template <int... J>
  __device__ __forceinline__ bool rounds(bool& busy, bool& drained, int me, Seq<J...>) {
    return (round<J>(busy, drained, me) || ...);
  }
};

template <class C, int Leg>
__device__ __forceinline__ void leg_body(const Grid& v, const Tracks& a) {
  const float* sc = v.scalars;
  Lane<C, Leg> lane;
  lane.steps = 0;
  Run<C, Leg> run{v, a, lane, __ldg(sc + kVolMaj), __ldg(sc + kInvMaj), __ldg(sc + kDenScale), __ldg(sc + kRangeLo),
                  __ldg(sc + kRangeHi), 0ull};
  const int me = threadIdx.x & 31;
  unsigned long long iterations = 0;
  if constexpr (C::R == 0) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i < a.n && lane.template begin<0>(v, a, i, run.inv_maj)) {
      run.track();
      lane.finish(a);
    }
    iterations = __reduce_max_sync(kFull, static_cast<unsigned>(lane.steps));
  } else if constexpr (C::R == 1) {
    for (;;) {
      unsigned long long base = 0;
      if (me == 0) base = atomicAdd(a.work, 32ull);
      base = __shfl_sync(kFull, base, 0);
      if (static_cast<long long>(base) >= a.n) break;
      lane.steps = 0;
      const long long i = static_cast<long long>(base) + me;
      if (i < a.n && lane.template begin<0>(v, a, i, run.inv_maj)) {
        run.track();
        lane.finish(a);
      }
      iterations += __reduce_max_sync(kFull, static_cast<unsigned>(lane.steps));
    }
  } else {
    bool busy = false, drained = false;
    while (!run.rounds(busy, drained, me, typename MakeSeq<Lane<C, Leg>::N>::type{})) {
    }
    iterations = run.rounds_run;
  }
  if (me == 0) atomicAdd(a.work + 1, iterations);
}

// the variants, by number: I, K, D, R, Fake, Lean, the blocks per SM the
// launch bounds ask for (0: none), and Tight where it is set
#define VARIANTS(X)                                \
  X(0, uint64_t, 1, 0, 0, false, false, 0)         \
  X(1, uint32_t, 1, 0, 0, false, false, 0)         \
  X(2, uint32_t, 2, 0, 0, false, false, 0)         \
  X(3, uint32_t, 4, 0, 0, false, false, 0)         \
  X(4, uint32_t, 2, 1, 0, false, false, 0)         \
  X(5, uint32_t, 2, 2, 0, false, false, 0)         \
  X(6, uint32_t, 2, 4, 0, false, false, 0)         \
  X(7, uint32_t, 2, 0, 1, false, false, 0)         \
  X(8, uint32_t, 2, 0, 2, false, false, 0)         \
  X(9, uint32_t, 2, 1, 2, false, false, 0)         \
  X(10, uint32_t, 1, 1, 0, false, false, 0)        \
  X(11, uint32_t, 2, 2, 2, false, false, 0)        \
  X(12, uint32_t, 2, 0, 0, true, false, 0)         \
  X(13, uint32_t, 2, 1, 0, true, false, 0)         \
  X(14, uint32_t, 2, 1, 2, true, false, 0)         \
  X(15, uint32_t, 1, 0, 0, false, true, 0)         \
  X(16, uint32_t, 1, 1, 0, false, true, 0)         \
  X(17, uint32_t, 1, 2, 0, false, true, 0)         \
  X(18, uint32_t, 1, 1, 0, false, true, 8)         \
  X(19, uint32_t, 1, 0, 0, true, true, 0)          \
  X(20, uint32_t, 1, 1, 0, true, true, 0)          \
  X(21, uint32_t, 1, 1, 1, false, true, 0)         \
  X(22, uint64_t, 1, 1, 0, false, true, 0)         \
  X(23, uint32_t, 1, 0, 0, false, true, 10)        \
  X(24, uint32_t, 1, 0, 0, false, false, 0, true)  \
  X(25, uint32_t, 1, 1, 0, false, false, 0, true)  \
  X(26, uint32_t, 1, 2, 0, false, false, 0, true)  \
  X(27, uint32_t, 1, 0, 0, true, false, 0, true)   \
  X(28, uint32_t, 1, 1, 0, true, false, 0, true)   \
  X(29, uint64_t, 1, 0, 0, false, false, 0, true)  \
  X(30, uint64_t, 1, 1, 0, false, false, 0, true)  \
  X(31, uint32_t, 1, 1, 0, false, false, 8, true)  \
  X(32, uint32_t, 1, 1, 2, false, false, 0, true)  \
  X(33, uint32_t, 1, 0, 1, false, false, 0, true)  \
  X(34, uint32_t, 1, 3, 0, false, false, 0, true)  \
  X(35, uint32_t, 1, 4, 0, false, false, 0, true)  \
  X(36, uint32_t, 1, 2, 0, true, false, 0, true)   \
  X(37, uint32_t, 1, 2, 0, false, false, 4, true)  \
  X(38, uint64_t, 1, 2, 0, false, false, 0, true)

// one kernel per variant and leg, named variant<num>_<leg>
#define BOUNDS(MINB) __launch_bounds__(kThreads, (MINB) > 0 ? (MINB) : 1)
#define KERNELS(num, I, K, D, R, FAKE, LEAN, MINB, ...)                                     \
  __global__ void BOUNDS(MINB) variant##num##_sample(Grid v, Tracks a) {              \
    leg_body<Cfg<I, K, D, R, FAKE, LEAN, ##__VA_ARGS__>, kSample>(v, a);                              \
  }                                                                                     \
  __global__ void BOUNDS(MINB) variant##num##_shadow(Grid v, Tracks a) {              \
    leg_body<Cfg<I, K, D, R, FAKE, LEAN, ##__VA_ARGS__>, kShadow>(v, a);                              \
  }
VARIANTS(KERNELS)
#undef KERNELS

int launch(void (*kernel)(Grid, Tracks), bool persistent, const Grid& v, const Tracks& a, int* regs, int* per_sm,
           cudaStream_t stream) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks_per_sm = 0, device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel, kThreads, 0);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (regs) *regs = attr.numRegs;
  if (per_sm) *per_sm = blocks_per_sm;
  if (a.n <= 0) return 0;
  err = cudaMemsetAsync(a.work, 0, 2 * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long lanes = (a.n + kThreads - 1) / kThreads;
  const long long blocks = persistent ? std::min<long long>(static_cast<long long>(sms) * blocks_per_sm, lanes) : lanes;
  kernel<<<static_cast<int>(blocks), kThreads, 0, stream>>>(v, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant `variant` of leg `leg` (0 camera, 1 shadow) over n lanes; with
// n == 0 only reports the kernel's registers and resident blocks per SM.
// work: two zeroed-here u64 (the lane counter, the warps' iterations).
extern "C" int vx_trackleg_variant(int leg, int variant, const uint16_t* dense, long long numel, int ny, int nx,
                                   int ex, int ey, int ez, const float* lut, int lut_k, const float* scalars,
                                   const float* ipos, const float* idir, const float* far, const float* t,
                                   const int64_t* state, const bool* running, const float* tr, const int* forced,
                                   int cap, int64_t* state_out, bool* hit_out, float* t_out, float* rgb_out,
                                   float* tr_out, int* events_out, unsigned long long* work, long long n, int* regs,
                                   int* per_sm, cudaStream_t stream) {
  const Grid v{dense,
                ny,
                nx,
                ex,
                ey,
                ez,
                static_cast<unsigned long long>(numel / 2),
                static_cast<unsigned long long>(numel / 4),
                reinterpret_cast<const float4*>(lut),
                lut_k,
                scalars,
                static_cast<long long>(nx) * ny,
                static_cast<float>(lut_k),
                static_cast<float>(lut_k - 1)};
  const Tracks a{ipos, idir, far, t, state, running, tr, forced, cap, state_out, events_out, hit_out, t_out, rgb_out,
                 tr_out, work, n};
#define CASE(num, I, K, D, R, FAKE, LEAN, MINB, ...) \
  case num:                         \
    return launch(leg == 0 ? variant##num##_sample : variant##num##_shadow, R != 0, v, a, regs, per_sm, stream);
  switch (variant) {
    VARIANTS(CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CASE
}

extern "C" int vx_trackleg_variant_count() {
#define COUNT(num, I, K, D, R, FAKE, LEAN, MINB, ...) +1
  return 0 VARIANTS(COUNT);
#undef COUNT
}
