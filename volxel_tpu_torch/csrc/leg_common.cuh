// Device code shared by the render legs' kernels (dda_leg.cu, track_leg.cu):
// the launch shape, the scalars' layout, the xoshiro128++ draw, the log and
// the IEEE division; and the one tap fetch and decode of both leg families
// (the field a launch reads, the eight bf16 taps, the trilinear density,
// then the transfer LUT's NEAREST row with range rejection: the LUT site of
// the Pallas kernel volxel_tpu/render/mxu_gather.py: mxu_gather_f32). The
// fetch only issues the loads, so a kernel can keep them in flight while
// it does other work, and decodes when it needs the density.
//
// Both files are built with --fmad=true (kernels.FMAD_SOURCES), so that
// -log(1 - xi) rounds as ATen's log does (ATen builds its log kernel with
// nvcc's default --fmad=true). Every other f32 sum, difference and product
// is written with __fadd_rn, __fsub_rn or __fmul_rn, which are never
// contracted into an FMA, in the plain versions' order. The two functions
// whose own code needs FFMA, the log and the IEEE division (its correctly
// rounded sequence), are kept out of line, so a SASS listing of the leg
// kernels shows no FFMA in their own code (chip_smoke.py checks it).
// min_nan / max_nan give NaN for a NaN operand as torch.amin and
// torch.clamp_min do, clamp_min / clamp_max keep a NaN value; the float ->
// int casts are static_cast, as ATen's are (NaN lands on 0, +-inf
// saturates); a tap outside the extent reads 0.
//
// A launch reads its field from one dense array (Field) or from z-slabs
// (SlabField, render-time volume slabs: render/sampling.SlabGrid), through a
// table of the slabs' device pointers on the launching card; a slab on
// another card is read with peer loads. Slab v holds z slices [v * slab -
// kSlabHalo, (v + 1) * slab + kSlabHalo), so the owner of a stencil's
// clipped base z holds all of its taps, and the fetch indexes from that
// slab's row as it would from the dense field's. The leg kernels are
// templates over the field type; the Field instantiation is the kernel as
// it is without slabs. The park forms (parked_owner) are kernels of their
// own over a SlabField, so the dense and slab forms keep their code.
//
// csrc/rng.cu, the per-ray RNG's seeding and draws, includes this header
// for next_float, so the legs and the RNG draw one stream; it is built with
// --fmad=false, which changes nothing there (the float's one product is
// exact).
//
// csrc/shade.cu, gradient shading, includes it for the tap fetch at a point
// (fetch_at) and the trilinear sum (trilinear), so its six lookups read and
// sum the taps as the legs do.
//
// kernels.build compiles csrc/*.cu only, so this header is never compiled
// alone; kernels.library_path hashes it with the sources.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
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

// what every lane of a leg reads: the field, the LUT and the volume's
// scalars (render/tilemarch.volume_scalars, on the card)
struct Field {
  const uint16_t* dense;
  int ny, nx, ex, ey, ez;
  long long plane;  // nx * ny
  const float4* lut;
  float lut_k, lut_top;  // K and K - 1 as f32
  const float* scalars;
  static constexpr bool kRoundTaps = false;
};

inline Field make_field(const uint16_t* dense, int ny, int nx, int ex, int ey, int ez, const float* lut, int lut_k,
                        const float* scalars) {
  return Field{dense, ny, nx, ex, ey, ez, static_cast<long long>(nx) * ny, reinterpret_cast<const float4*>(lut),
               static_cast<float>(lut_k), static_cast<float>(lut_k - 1), scalars};
}

constexpr int kSlabHalo = 2;  // sampling.SLAB_HALO

// the same, the field in z-slabs of `slab` owned slices each (slab +
// 2 * kSlabHalo slices of ny * nx stored), `slabs` the table of their
// pointers; kRound rounds each trilinear sum to bf16 (SlabGrid.tap_dtype)
template <bool kRound>
struct SlabField {
  const uint16_t* const* slabs;
  int slab;
  int ny, nx, ex, ey, ez;
  long long plane;
  const float4* lut;
  float lut_k, lut_top;
  const float* scalars;
  static constexpr bool kRoundTaps = kRound;
};

template <bool kRound>
inline SlabField<kRound> make_slab_field(const uint16_t* const* slabs, int slab, int ny, int nx, int ex, int ey, int ez,
                                         const float* lut, int lut_k, const float* scalars) {
  return SlabField<kRound>{slabs, slab, ny, nx, ex, ey, ez, static_cast<long long>(nx) * ny,
                           reinterpret_cast<const float4*>(lut), static_cast<float>(lut_k),
                           static_cast<float>(lut_k - 1), scalars};
}

// the first corner of a cell (x, y, z), dense or in the slab of the owner of
// its clipped z (a row whose taps are all outside is never loaded)
__device__ __forceinline__ const uint16_t* corner(const Field& v, const int (&b)[3]) {
  return v.dense + ((static_cast<long long>(b[2]) * v.ny + b[1]) * v.nx + b[0]);
}
template <bool kRound>
__device__ __forceinline__ const uint16_t* corner(const SlabField<kRound>& v, const int (&b)[3]) {
  const int owner = clampi(b[2], 0, v.ez - 1) / v.slab;
  const long long lz = static_cast<long long>(b[2]) - static_cast<long long>(owner) * v.slab + kSlabHalo;
  return v.slabs[owner] + ((lz * v.ny + b[1]) * v.nx + b[0]);
}

// The park forms' test (a vz row across nodes: slabs on another node have a
// null pointer in the table, render/sampling.SlabGrid): the slab of the owner
// of the clipped base z of the stencil at p + t * d, located as fetch locates
// it, where that slab is absent; -1 where it can be read. A lane parks there
// before the taps' loads are issued (parallel/migrate.py moves it to the
// slab's owner, which resumes it).
template <bool kRound>
__device__ __forceinline__ int parked_owner(const SlabField<kRound>& v, const float (&p)[3], const float (&d)[3],
                                            float t) {
  const float z = __fadd_rn(p[2], __fmul_rn(t, d[2]));
  const int owner = clampi(__float2int_rd(__fsub_rn(z, 0.5f)), 0, v.ez - 1) / v.slab;
  return v.slabs[owner] == nullptr ? owner : -1;
}

// the volume's scalars, read once by each thread
struct Scalars {
  float vol_maj, inv_maj, den_scale, range_lo, range_hi;
};

template <class F>
__device__ __forceinline__ Scalars load_scalars(const F& v) {
  return Scalars{__ldg(v.scalars + kVolMaj), __ldg(v.scalars + kInvMaj), __ldg(v.scalars + kDenScale),
                 __ldg(v.scalars + kRangeLo), __ldg(v.scalars + kRangeHi)};
}

// one decode's taps in flight: the trilinear fractions and each tap's bf16
// bits (0 outside the extent)
struct Taps {
  float f[3];
  uint32_t bits[8];
};

// sampling.lookup_density_trilinear's taps at p + t * d, issued. The cell
// is located with 32-bit saturating casts, which reject exactly the taps
// that the 64-bit casts of the plain form reject (a base of 2^31 or more,
// or below -2^31, has both offsets outside any extent; NaN lands on 0 in
// both), and float(base) of the 64-bit form is floor(q) clamped to +-2^63,
// where that cast saturates. One 64-bit index for the cell's first corner,
// so a field may hold more than 2^31 elements, the four (y, z) rows from
// it, the x + 1 tap two bytes on, each of the eight 2-byte loads
// predicated on its tap being inside (0 outside). On slabs the first corner
// lies in the slab of the owner of the clipped base z (corner).
// fetch_at issues them at an index-space point, fetch at p + t * d.
template <class F>
__device__ __forceinline__ void fetch_at(const F& v, const float (&pos)[3], Taps& e) {
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
  row[0] = corner(v, b);
  row[1] = row[0] + v.nx;
  row[2] = row[0] + v.plane;
  row[3] = row[2] + v.nx;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t x = 0;
    if (in[0][k & 1] && in[1][(k >> 1) & 1] && in[2][k >> 2]) x = __ldg(row[k >> 1] + (k & 1));
    e.bits[k] = x;
  }
}

template <class F>
__device__ __forceinline__ void fetch(const F& v, const float (&p)[3], const float (&d)[3], float t, Taps& e) {
  const float pos[3] = {__fadd_rn(p[0], __fmul_rn(t, d[0])), __fadd_rn(p[1], __fmul_rn(t, d[1])),
                        __fadd_rn(p[2], __fmul_rn(t, d[2]))};
  fetch_at(v, pos, e);
}

// the trilinear sum of fetched taps (sampling.trilinear_sum): in _TAPS
// order (dz outer, dx inner), weights ((wx * wy) * wz), the products summed
// one after another; a field with kRoundTaps rounds the sum to bf16 and
// back.
template <class F>
__device__ __forceinline__ float trilinear(const Taps& e) {
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
    const float term = __fmul_rn(__uint_as_float(e.bits[k] << 16), w);  // bf16 -> f32 is exact
    acc = k == 0 ? term : __fadd_rn(acc, term);
  }
  if constexpr (F::kRoundTaps) acc = __bfloat162float(__float2bfloat16_rn(acc));
  return acc;
}

// the decode of fetched taps: the trilinear sum times den_scale and
// inv_maj, then the LUT's NEAREST row (gather.lookup_transfer_plain), 0
// where the sample range rejects the density. The row clamp(floor(y), 0,
// K - 1) is floor(clamp(y, 0, K - 1)) (fmaxf takes a NaN y to 0, as the
// 64-bit cast does).
template <class F>
__device__ __forceinline__ float4 decode(const F& v, const Scalars& c, const Taps& e) {
  const float dn = __fmul_rn(__fmul_rn(c.den_scale, trilinear<F>(e)), c.inv_maj);
  float4 rgba = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (!(dn < c.range_lo || dn > c.range_hi)) {
    rgba = __ldg(v.lut + __float2int_rd(fminf(fmaxf(__fmul_rn(dn, v.lut_k), 0.0f), v.lut_top)));
  }
  return rgba;
}

inline int blocks_for(long long n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

}  // namespace
