// Design variants of the default-mode leg kernels
// (volxel_tpu_torch/csrc/dda_leg.cu), each one template instantiation, for
// examples/ddaleg_variants.py.
//
// Every variant but the issue-only ones computes what dda_leg_sample_plain /
// dda_leg_shadow_plain (the reference's shadow quirk) compute, bit for bit,
// under the rules of leg_common.cuh (the file is built with the flags
// kernels.FMAD_SOURCES gives dda_leg.cu); the parameters change only how
// the majorants and the taps are addressed and loaded, when they are
// issued, and how the march and the collisions share a loop:
//
//   K      march steps whose majorant fetches are in flight (1: each step's
//          fetch waits for the step before it, as in the parent);
//   MinB   the blocks per SM the launch bounds name (0: the block size
//          alone, as in the parent);
//   Old    the collision's taps in the former form (a 64-bit index per tap, an
//          `if (inside)` per load) instead of leg_common.cuh's fetch;
//   Late   the next segment's first fetches issued when the march resumes,
//          after the draws (the parent's order), not before the decode;
//   Flat   0: the nested loop (march to the next collision, then decode);
//          1: one march step an iteration, the collision's decode and draws
//          in the same iteration on the lanes that collide, each branch
//          issuing its lane's next step, the ring rotated instead of
//          unrolled into phases; 2: the same with the next step issued
//          after the branches, by the warp's lanes together (csrc/dda_leg.cu
//          at K = 1);
//   Narrow a 32-bit pyramid index;
//   Comp   1: levels 1-3 read from their distinct values (compact copies,
//          level mi at (vz >> mi, vy >> mi, vx >> mi)); 2: levels 2-3 from
//          compact copies in shared memory, which a persistent grid loads
//          once per resident block;
//   Packed the lanes taken in the order `order` gives, the running ones first
//          (ddaleg_variants.py partitions them on the card), so that a warp
//          holds 32 running lanes where the pixel order leaves idle ones
//          among them;
//   Fake   issue-only: every load replaced by a register constant that
//          depends on its address (the address arithmetic stays); each
//          lane takes the plain run's segments (forced: the steps of each
//          march round, whether it ends in a decode, whether the lane ends
//          there), read once a segment; not bit-equal.

#include <algorithm>
#include <utility>

#include "leg_common.cuh"

namespace {

constexpr int kSample = 0, kShadow = 1;
constexpr float kSpeedUp = 0.25f, kSpeedDown = 2.0f;
constexpr int kMarching = 0, kCollided = 1, kEnded = 2;
// a forced segment's flags: it ends in a collision that is decoded; it is
// the lane's last
constexpr int kSegDecode = 1 << 13, kSegLast = 1 << 14, kSegSteps = kSegDecode - 1;

template <int K_, int MinB_, bool Old_, bool Late_, int Flat_, bool Narrow_, int Comp_, bool Fake_,
          bool Packed_ = false>
struct Cfg {
  static constexpr int K = K_, MinB = MinB_, Comp = Comp_, Flat = Flat_;
  static constexpr bool Old = Old_, Late = Late_, Narrow = Narrow_, Fake = Fake_, Packed = Packed_;
};

struct Pyramid {
  const float* maj;
  int bz, by, bx;
  const float* level[4];  // Comp: compact levels 1-3 (level[0] unused)
  int lz[4], ly[4], lx[4];
};

struct Lanes {
  const float *ipos, *idir, *ri, *far, *t, *tau, *mip;
  const int64_t* state;
  const bool* running;
  const float* tr_in;
  const int* forced_at;       // Fake: where each lane's segments start in forced_seg (n + 1)
  const int16_t* forced_seg;  // Fake: steps | kSegDecode | kSegLast per segment
  const int* order;           // Packed: the lane each thread takes
  int cap;
  int64_t* state_out;
  int* budget_out;
  bool* hit_out;
  float *t_out, *rgb_out, *tr_out;
  long long n;
};

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
    if constexpr (sizeof(T) == 2) {
      return static_cast<T>(r & 0xffffu);
    } else {
      return __uint_as_float(r);
    }
  }
}

__device__ __forceinline__ float axis_step(float c, float dim, float inv_dim, float r) {
  const float off = r >= 0.0f ? __fadd_rn(dim, 0.5f) : -0.5f;
  return __fmul_rn(__fsub_rn(__fadd_rn(__fmul_rn(floorf(__fmul_rn(c, inv_dim)), dim), off), c), r);
}

// the former decode: a 64-bit index and an `if (inside)` per tap
template <bool Fake>
__device__ __forceinline__ float4 decode_old(const Field& v, const Scalars& sc, const float (&p)[3],
                                             const float (&d)[3], float t) {
  const float pos[3] = {__fadd_rn(p[0], __fmul_rn(t, d[0])), __fadd_rn(p[1], __fmul_rn(t, d[1])),
                        __fadd_rn(p[2], __fmul_rn(t, d[2]))};
  long long base[3];
  float w1[3][2];
  for (int a = 0; a < 3; ++a) {
    const float q = __fsub_rn(pos[a], 0.5f);
    base[a] = static_cast<long long>(floorf(q));
    const float f = __fsub_rn(q, static_cast<float>(base[a]));
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
      c[a] = static_cast<long long>(static_cast<unsigned long long>(base[a]) + off[a]);
      inside = inside && c[a] >= 0 && c[a] < ext[a];
    }
    float tap = 0.0f;
    if (inside) {
      const uint16_t bits = load<Fake>(v.dense + (c[2] * v.ny + c[1]) * v.nx + c[0]);
      tap = __uint_as_float(static_cast<uint32_t>(bits) << 16);
    }
    const float w = __fmul_rn(__fmul_rn(w1[0][off[0]], w1[1][off[1]]), w1[2][off[2]]);
    const float term = __fmul_rn(tap, w);
    acc = k == 0 ? term : __fadd_rn(acc, term);
  }
  const float dn = __fmul_rn(__fmul_rn(sc.den_scale, acc), sc.inv_maj);
  const bool rejected = dn < sc.range_lo || dn > sc.range_hi;
  const int lut_k = static_cast<int>(v.lut_k);
  long long j = static_cast<long long>(floorf(__fmul_rn(dn, v.lut_k)));
  j = j < 0 ? 0 : (j > lut_k - 1 ? lut_k - 1 : j);
  if constexpr (Fake) {
    const float c = load<true>(reinterpret_cast<const float*>(v.lut + j));
    return rejected ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : make_float4(c, c, c, c);
  } else {
    return rejected ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : __ldg(v.lut + j);
  }
}

// leg_common.cuh's fetch, its loads replaced where Fake
template <bool Fake>
__device__ __forceinline__ void fetch_taps(const Field& v, const float (&p)[3], const float (&d)[3], float t,
                                           Taps& e) {
  if constexpr (!Fake) {
    fetch(v, p, d, t, e);
  } else {
    const float pos[3] = {__fadd_rn(p[0], __fmul_rn(t, d[0])), __fadd_rn(p[1], __fmul_rn(t, d[1])),
                          __fadd_rn(p[2], __fmul_rn(t, d[2]))};
    const int ext[3] = {v.ex, v.ey, v.ez};
    int b[3];
    bool in[3][2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float q = __fsub_rn(pos[a], 0.5f);
      b[a] = __float2int_rd(q);
      e.f[a] = __fsub_rn(q, fminf(fmaxf(floorf(q), -0x1p63f), 0x1p63f));
      in[a][0] = static_cast<unsigned>(b[a]) < static_cast<unsigned>(ext[a]);
      in[a][1] = static_cast<unsigned>(b[a]) + 1u < static_cast<unsigned>(ext[a]);
    }
    const uint16_t* row[4];
    row[0] = v.dense + ((static_cast<long long>(b[2]) * v.ny + b[1]) * v.nx + b[0]);
    row[1] = row[0] + v.nx;
    row[2] = row[0] + v.plane;
    row[3] = row[2] + v.nx;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint32_t x = 0;
      if (in[0][k & 1] && in[1][(k >> 1) & 1] && in[2][k >> 2]) x = load<true>(row[k >> 1] + (k & 1));
      e.bits[k] = x;
    }
  }
}

// leg_common.cuh's decode, its LUT load replaced where Fake
template <bool Fake>
__device__ __forceinline__ float4 decode_taps(const Field& v, const Scalars& c, const Taps& e) {
  if constexpr (!Fake) {
    return decode(v, c, e);
  } else {
    float w1[3][2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      w1[a][0] = __fsub_rn(1.0f, e.f[a]);
      w1[a][1] = e.f[a];
    }
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float w = __fmul_rn(__fmul_rn(w1[0][k & 1], w1[1][(k >> 1) & 1]), w1[2][k >> 2]);
      const float term = __fmul_rn(__uint_as_float(e.bits[k] << 16), w);
      acc = k == 0 ? term : __fadd_rn(acc, term);
    }
    const float dn = __fmul_rn(__fmul_rn(c.den_scale, acc), c.inv_maj);
    float4 rgba = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (!(dn < c.range_lo || dn > c.range_hi)) {
      const float x = load<true>(reinterpret_cast<const float*>(
          v.lut + __float2int_rd(fminf(fmaxf(__fmul_rn(dn, v.lut_k), 0.0f), v.lut_top))));
      rgba = make_float4(x, x, x, x);
    }
    return rgba;
  }
}

template <class C>
struct March {
  static constexpr int K = C::K;
  float p[3], d[3], r[3];
  float far, t, tau;
  int budget;
  float ct, cmip;
  float rm[K], rdt[K], rt[K], rmip[K];  // the ring
  float m, mip;
  int seg_at, seg_left, seg_flags;  // Fake: the next segment, the current one's steps left and flags

  __device__ __forceinline__ float majorant(const Pyramid& g, const float* __restrict__ smem, int mi, int vz, int vy,
                                            int vx) const {
    if constexpr (C::Comp == 1) {
      if (mi > 0) {
        return load<C::Fake>(g.level[mi] + ((vz >> mi) * g.ly[mi] + (vy >> mi)) * g.lx[mi] + (vx >> mi));
      }
    } else if constexpr (C::Comp == 2) {
      if (mi >= 2) {
        const int base = mi == 2 ? 0 : g.lz[2] * g.ly[2] * g.lx[2];
        return smem[base + ((vz >> mi) * g.ly[mi] + (vy >> mi)) * g.lx[mi] + (vx >> mi)];
      }
    }
    if constexpr (C::Narrow) {
      return load<C::Fake>(g.maj + (((mi * g.bz + vz) * g.by + vy) * g.bx + vx));
    } else {
      return load<C::Fake>(g.maj + ((static_cast<int64_t>(mi) * g.bz + vz) * g.by + vy) * g.bx + vx);
    }
  }

  __device__ __forceinline__ void issue(const Pyramid& g, const float* smem, const Field& v, float& sm, float& sdt,
                                        float& st, float& smip) {
    const int mi = clampi(static_cast<int>(floorf(__fadd_rn(cmip, 0.5f))), 0, 3);
    float c[3];
    for (int a = 0; a < 3; ++a) c[a] = __fadd_rn(p[a], __fmul_rn(ct, d[a]));
    const int vx = clampi(static_cast<int>(floorf(c[0])), 0, v.ex - 1) >> 3;
    const int vy = clampi(static_cast<int>(floorf(c[1])), 0, v.ey - 1) >> 3;
    const int vz = clampi(static_cast<int>(floorf(c[2])), 0, v.ez - 1) >> 3;
    sm = majorant(g, smem, mi, vz, vy, vx);
    const float dim = static_cast<float>(8 << mi);
    const float inv_dim = __int_as_float((127 - 3 - mi) << 23);
    sdt = min_nan(min_nan(axis_step(c[0], dim, inv_dim, r[0]), axis_step(c[1], dim, inv_dim, r[1])),
                  axis_step(c[2], dim, inv_dim, r[2]));
    st = __fadd_rn(ct, sdt);
    smip = cmip;
    ct = st;
    cmip = clamp_max(__fadd_rn(cmip, kSpeedUp), 3.0f);
  }

  __device__ __forceinline__ void begin(const Pyramid& g, const float* smem, const Field& v, float mip0) {
    ct = t;
    cmip = mip0;
#pragma unroll
    for (int k = 0; k < K; ++k) issue(g, smem, v, rm[k], rdt[k], rt[k], rmip[k]);
  }

  // Fake: the lane's next forced segment; false where it has none or one of
  // no steps (the lane ends)
  __device__ __forceinline__ bool segment(const Lanes& a) {
    const int e = a.forced_seg[seg_at++];
    seg_left = e & kSegSteps;
    seg_flags = e & ~kSegSteps;
    return seg_left > 0;
  }

  // a step's test: kCollided, kEnded (left the box, spent its budget) or
  // kMarching; Fake: the forced segment's
  __device__ __forceinline__ int test(float tau_new, float t_new) {
    if constexpr (C::Fake) {
      if (--seg_left > 0) return kMarching;
      return seg_flags & kSegDecode ? kCollided : kEnded;
    } else {
      if (tau_new <= 0.0f) return kCollided;
      return t_new >= far || budget <= 0 ? kEnded : kMarching;
    }
  }

  template <int J>
  __device__ __forceinline__ int step(const Pyramid& g, const float* smem, const Field& v) {
    const float tau_new = __fsub_rn(tau, __fmul_rn(rm[J], rdt[J]));
    budget -= 1;
    const int res = test(tau_new, rt[J]);
    if (res == kCollided) {
      t = __fadd_rn(rt[J], div_rn(tau_new, max_nan(rm[J], 1e-20f)));
      m = rm[J];
      mip = rmip[J];
      return !C::Fake && t >= far ? kEnded : kCollided;
    }
    t = rt[J];
    tau = tau_new;
    if (res == kEnded) return kEnded;
    issue(g, smem, v, rm[J], rdt[J], rt[J], rmip[J]);
    return kMarching;
  }

  template <int... J>
  __device__ __forceinline__ int cycle(const Pyramid& g, const float* smem, const Field& v,
                                       std::integer_sequence<int, J...>) {
    int res = kMarching;
    (void)(((res = step<J>(g, smem, v)) == kMarching) && ...);
    return res;
  }

  __device__ __forceinline__ bool next(const Pyramid& g, const float* smem, const Field& v) {
    int res;
    while ((res = cycle(g, smem, v, std::make_integer_sequence<int, K>{})) == kMarching) {
    }
    return res == kCollided;
  }

  // whether the lane goes on after a collision's draws: its budget (Fake:
  // the forced segments) left
  __device__ __forceinline__ bool goes_on(const Lanes& a) {
    if constexpr (C::Fake) {
      return !(seg_flags & kSegLast) && segment(a);
    } else {
      return budget > 0;
    }
  }
};

// the draws of a collision; true where the lane ends
template <class C, int Leg>
__device__ __forceinline__ bool collide(const Scalars& c, const float4& rgba, March<C>& w, uint32_t (&s)[4],
                                        bool& hit, float (&rgb)[3], float& tr) {
  if constexpr (Leg == kSample) {
    if (__fmul_rn(next_float(s), w.m) < __fmul_rn(c.vol_maj, rgba.w)) {
      hit = true;
      rgb[0] = rgba.x;
      rgb[1] = rgba.y;
      rgb[2] = rgba.z;
      if (!C::Fake) return true;
    }
  } else {
    const float dd = __fmul_rn(c.vol_maj, rgba.w);
    if (__fmul_rn(next_float(s), w.m) < dd) {
      tr = __fmul_rn(tr, clamp_min(__fsub_rn(1.0f, div_rn(c.vol_maj, clamp_min(w.m, static_cast<float>(1e-20)))),
                                   0.0f));
      if (tr < static_cast<float>(0.1)) {
        if (next_float(s) < __fsub_rn(1.0f, tr) && !C::Fake) {
          tr = 0.0f;
          return true;
        }
        tr = div_rn(tr, clamp_min(tr, static_cast<float>(1e-20)));
      }
    }
  }
  w.tau = neg_log1m(next_float(s));
  return false;
}

template <class C>
__device__ __forceinline__ float4 decode_at(const Field& v, const Scalars& c, const March<C>& w) {
  if constexpr (C::Old) {
    return decode_old<C::Fake>(v, c, w.p, w.d, w.t);
  } else {
    Taps taps;
    fetch_taps<C::Fake>(v, w.p, w.d, w.t, taps);
    return decode_taps<C::Fake>(v, c, taps);
  }
}

template <class C, int Leg>
__device__ __forceinline__ void lane_body(const Pyramid& g, const float* smem, const Field& v, const Lanes& a,
                                          long long i) {
  uint32_t s[4];
  for (int j = 0; j < 4; ++j) s[j] = static_cast<uint32_t>(a.state[4 * i + j]);
  float t = a.t[i], tr = Leg == kShadow ? a.tr_in[i] : 0.0f;
  int budget = a.cap;
  bool hit = false;
  float rgb[3] = {1.0f, 1.0f, 1.0f};
  if (a.running[i]) {
    March<C> w;
    for (int k = 0; k < 3; ++k) {
      w.p[k] = a.ipos[3 * i + k];
      w.d[k] = a.idir[3 * i + k];
      w.r[k] = a.ri[3 * i + k];
    }
    w.far = a.far[i];
    w.t = t;
    w.tau = a.tau[i];
    w.budget = a.cap;
    const Scalars c = load_scalars(v);
    const float mip0 = a.mip[i];
    bool go = w.budget > 0;
    if constexpr (C::Fake) {
      w.seg_at = a.forced_at[i];
      go = a.forced_at[i + 1] > w.seg_at && w.segment(a);
    }
    if constexpr (C::Flat == 0) {
      if (go) w.begin(g, smem, v, mip0);
      while (go && w.next(g, smem, v)) {
        go = w.goes_on(a);
        const float mip1 = clamp_min(__fsub_rn(w.mip, kSpeedDown), 0.0f);
        float4 rgba;
        if constexpr (C::Old) {
          if (!C::Late) w.begin(g, smem, v, mip1);
          rgba = decode_old<C::Fake>(v, c, w.p, w.d, w.t);
        } else {
          Taps taps;
          fetch_taps<C::Fake>(v, w.p, w.d, w.t, taps);
          if (!C::Late) w.begin(g, smem, v, mip1);
          rgba = decode_taps<C::Fake>(v, c, taps);
        }
        if (collide<C, Leg>(c, rgba, w, s, hit, rgb, tr)) break;
        if (C::Late && go) w.begin(g, smem, v, mip1);
      }
    } else if constexpr (C::Flat == 1) {
      // one step an iteration, each branch issuing its lane's next step
      if (go) w.begin(g, smem, v, mip0);
      while (go) {
        const float sm = w.rm[0], sdt = w.rdt[0], st = w.rt[0], smip = w.rmip[0];
#pragma unroll
        for (int k = 0; k + 1 < C::K; ++k) {
          w.rm[k] = w.rm[k + 1];
          w.rdt[k] = w.rdt[k + 1];
          w.rt[k] = w.rt[k + 1];
          w.rmip[k] = w.rmip[k + 1];
        }
        const float tau_new = __fsub_rn(w.tau, __fmul_rn(sm, sdt));
        w.budget -= 1;
        const int res = w.test(tau_new, st);
        if (res == kCollided) {
          w.t = __fadd_rn(st, div_rn(tau_new, max_nan(sm, 1e-20f)));
          w.m = sm;
          w.mip = smip;
          if (!C::Fake && w.t >= w.far) break;
          go = w.goes_on(a);
          Taps taps;
          fetch_taps<C::Fake>(v, w.p, w.d, w.t, taps);
          w.begin(g, smem, v, clamp_min(__fsub_rn(smip, kSpeedDown), 0.0f));
          if (collide<C, Leg>(c, decode_taps<C::Fake>(v, c, taps), w, s, hit, rgb, tr)) break;
        } else {
          w.t = st;
          w.tau = tau_new;
          if (res == kEnded) break;
          w.issue(g, smem, v, w.rm[C::K - 1], w.rdt[C::K - 1], w.rt[C::K - 1], w.rmip[C::K - 1]);
        }
      }
    } else {
      // one step an iteration, the next step issued after the branches by
      // the warp's lanes together
      if (go) {
        w.begin(g, smem, v, mip0);
        for (;;) {
          const float tau_new = __fsub_rn(w.tau, __fmul_rn(w.rm[0], w.rdt[0]));
          w.budget -= 1;
          const int res = w.test(tau_new, w.rt[0]);
          if (res == kCollided) {
            w.t = __fadd_rn(w.rt[0], div_rn(tau_new, max_nan(w.rm[0], 1e-20f)));
            w.m = w.rm[0];
            w.mip = w.rmip[0];
            if (!C::Fake && w.t >= w.far) break;
            if (collide<C, Leg>(c, decode_at(v, c, w), w, s, hit, rgb, tr) || !w.goes_on(a)) break;
            // the next segment's steps 0 .. K - 2 into slots 1 .. K - 1: the
            // shift below makes them 0 .. K - 2 and issues step K - 1
            w.ct = w.t;
            w.cmip = clamp_min(__fsub_rn(w.mip, kSpeedDown), 0.0f);
#pragma unroll
            for (int k = 1; k < C::K; ++k) w.issue(g, smem, v, w.rm[k], w.rdt[k], w.rt[k], w.rmip[k]);
          } else {
            w.t = w.rt[0];
            w.tau = tau_new;
            if (res == kEnded) break;
          }
#pragma unroll
          for (int k = 0; k + 1 < C::K; ++k) {
            w.rm[k] = w.rm[k + 1];
            w.rdt[k] = w.rdt[k + 1];
            w.rt[k] = w.rt[k + 1];
            w.rmip[k] = w.rmip[k + 1];
          }
          w.issue(g, smem, v, w.rm[C::K - 1], w.rdt[C::K - 1], w.rt[C::K - 1], w.rmip[C::K - 1]);
        }
      }
    }
    t = w.t;
    budget = w.budget;
  }
  for (int j = 0; j < 4; ++j) a.state_out[4 * i + j] = static_cast<int64_t>(s[j]);
  a.budget_out[i] = budget;
  if constexpr (Leg == kSample) {
    a.hit_out[i] = hit;
    a.t_out[i] = t;
    for (int k = 0; k < 3; ++k) a.rgb_out[3 * i + k] = rgb[k];
  } else {
    a.tr_out[i] = tr;
  }
}

template <class C, int Leg>
__device__ __forceinline__ void leg_body(const Pyramid& g, const Field& v, const Lanes& a) {
  if constexpr (C::Comp == 2) {
    // a persistent grid: levels 2-3 loaded into shared memory once per block
    extern __shared__ float smem[];
    const int n2 = g.lz[2] * g.ly[2] * g.lx[2], n3 = g.lz[3] * g.ly[3] * g.lx[3];
    for (int k = threadIdx.x; k < n2 + n3; k += blockDim.x) {
      smem[k] = k < n2 ? __ldg(g.level[2] + k) : __ldg(g.level[3] + (k - n2));
    }
    __syncthreads();
    const long long blocks = (a.n + kThreads - 1) / kThreads;
    for (long long b = blockIdx.x; b < blocks; b += gridDim.x) {
      const long long i = b * kThreads + threadIdx.x;
      if (i < a.n) lane_body<C, Leg>(g, smem, v, a, i);
    }
  } else {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i < a.n) lane_body<C, Leg>(g, nullptr, v, a, C::Packed ? a.order[i] : i);
  }
}

// the variants, by number: K, MinB, Old, Late, Flat, Narrow, Comp, Fake and
// Packed where it is set
#define VARIANTS(X)                                    \
  X(0, 1, 0, true, true, 0, false, 0, false)            \
  X(1, 1, 1, false, true, 0, false, 0, false)           \
  X(2, 1, 1, false, false, 0, false, 0, false)          \
  X(3, 2, 1, false, false, 0, false, 0, false)          \
  X(4, 3, 1, false, false, 0, false, 0, false)          \
  X(5, 4, 1, false, false, 0, false, 0, false)          \
  X(6, 1, 1, false, false, 1, false, 0, false)          \
  X(7, 1, 1, false, false, 2, false, 0, false)          \
  X(8, 1, 1, false, false, 2, true, 0, false)           \
  X(9, 1, 0, false, false, 2, true, 0, false)           \
  X(10, 1, 4, false, false, 2, true, 0, false)          \
  X(11, 1, 1, false, false, 2, true, 1, false)          \
  X(12, 1, 1, false, false, 2, true, 2, false)          \
  X(13, 2, 1, false, false, 2, true, 0, false)          \
  X(14, 1, 1, false, false, 2, true, 0, false, true)    \
  X(15, 1, 0, true, true, 0, false, 0, true)            \
  X(16, 1, 1, false, false, 2, true, 0, true)

// MinB 0: the block size alone
#define BOUNDS_0 __launch_bounds__(kThreads)
#define BOUNDS_1 __launch_bounds__(kThreads, 1)
#define BOUNDS_4 __launch_bounds__(kThreads, 4)
#define BOUNDS(MINB) BOUNDS_##MINB
#define KERNELS(num, K, MINB, OLD, LATE, FLAT, NARROW, COMP, FAKE, ...)                         \
  __global__ void BOUNDS(MINB) variant##num##_sample(Pyramid g, Field v, Lanes a) {              \
    leg_body<Cfg<K, MINB, OLD, LATE, FLAT, NARROW, COMP, FAKE, ##__VA_ARGS__>, kSample>(g, v, a); \
  }                                                                                              \
  __global__ void BOUNDS(MINB) variant##num##_shadow(Pyramid g, Field v, Lanes a) {              \
    leg_body<Cfg<K, MINB, OLD, LATE, FLAT, NARROW, COMP, FAKE, ##__VA_ARGS__>, kShadow>(g, v, a); \
  }
VARIANTS(KERNELS)
#undef KERNELS

int launch(void (*kernel)(Pyramid, Field, Lanes), bool persistent, size_t smem, const Pyramid& g, const Field& v,
           const Lanes& a, int* regs, int* per_sm, cudaStream_t stream) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks_per_sm = 0, device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel, kThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (regs) *regs = attr.numRegs;
  if (per_sm) *per_sm = blocks_per_sm;
  if (a.n <= 0) return 0;
  const long long lanes = (a.n + kThreads - 1) / kThreads;
  const long long blocks = persistent ? std::min<long long>(static_cast<long long>(sms) * blocks_per_sm, lanes) : lanes;
  kernel<<<static_cast<int>(blocks), kThreads, smem, stream>>>(g, v, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant `variant` of leg `leg` (0 camera, 1 shadow with the reference's
// quirk) over n lanes; with n == 0 only reports the kernel's registers and
// resident blocks per SM. levels: the compact levels 1-3 (null unless the
// variant reads them) with their (z, y, x) sizes in dims[3 * (level - 1)].
extern "C" int vx_ddaleg_variant(int leg, int variant, const float* maj, int bz, int by, int bx,
                                 const float* const* levels, const int* dims, const uint16_t* dense, int ny, int nx,
                                 int ex, int ey, int ez, const float* lut, int lut_k, const float* scalars,
                                 const float* ipos, const float* idir, const float* ri, const float* far,
                                 const float* t, const float* tau, const float* mip, const int64_t* state,
                                 const bool* running, const float* tr, const int* forced_at,
                                 const int16_t* forced_seg, const int* order, int cap,
                                 int64_t* state_out, bool* hit_out, float* t_out, float* rgb_out, float* tr_out,
                                 int* budget_out, long long n, int* regs, int* per_sm, cudaStream_t stream) {
  Pyramid g{maj, bz, by, bx, {nullptr, nullptr, nullptr, nullptr}, {0, 0, 0, 0}, {0, 0, 0, 0}, {0, 0, 0, 0}};
  size_t smem = 0;
  if (levels) {
    for (int l = 1; l < 4; ++l) {
      g.level[l] = levels[l - 1];
      g.lz[l] = dims[3 * (l - 1)];
      g.ly[l] = dims[3 * (l - 1) + 1];
      g.lx[l] = dims[3 * (l - 1) + 2];
    }
    smem = sizeof(float) * (static_cast<size_t>(g.lz[2]) * g.ly[2] * g.lx[2] + static_cast<size_t>(g.lz[3]) * g.ly[3] * g.lx[3]);
  }
  const Field v = make_field(dense, ny, nx, ex, ey, ez, lut, lut_k, scalars);
  const Lanes a{ipos, idir, ri, far, t, tau, mip, state, running, tr, forced_at, forced_seg, order, cap, state_out, budget_out,
                hit_out, t_out, rgb_out, tr_out, n};
#define CASE(num, K, MINB, OLD, LATE, FLAT, NARROW, COMP, FAKE, ...)                                                  \
  case num:                                                                                                     \
    return launch(leg == 0 ? variant##num##_sample : variant##num##_shadow, COMP == 2, COMP == 2 ? smem : 0, g, \
                  v, a, regs, per_sm, stream);
  switch (variant) {
    VARIANTS(CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CASE
}
