// Device code shared by the render legs' kernels (dda_leg.cu, track_leg.cu):
// the launch shape, the scalars' layout, the xoshiro128++ draw, the log and
// the IEEE division; and the default legs' collision decode (dda_leg.cu:
// the volume a launch reads, the trilinear density, then the transfer
// LUT's NEAREST row with range rejection: the LUT site of the Pallas kernel
// volxel_tpu/render/mxu_gather.py: mxu_gather_f32). track_leg.cu keeps its
// own tap fetch and decode, the same arithmetic in fewer instructions.
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
// kernels.build compiles csrc/*.cu only, so this header is never compiled
// alone; kernels.library_path hashes it with the sources.

#pragma once

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

// what every lane of a launch reads: the field, the LUT and the volume's
// scalars, and for the default legs the premultiplied majorant pyramid
// (null in the tracking legs, which march against the global majorant)
struct Volume {
  const float* maj;
  int bz, by, bx;
  const uint16_t* dense;
  int ny, nx, ex, ey, ez;
  const float4* lut;
  int lut_k;
  const float* scalars;
};

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

// the decode at the point p + t * d: the density, then the LUT's NEAREST
// row (gather.lookup_transfer_plain), 0 where the sample range rejects it
__device__ __forceinline__ float4 decode(const Volume& v, const float (&p)[3], const float (&d)[3], float t) {
  const float pos[3] = {__fadd_rn(p[0], __fmul_rn(t, d[0])), __fadd_rn(p[1], __fmul_rn(t, d[1])),
                        __fadd_rn(p[2], __fmul_rn(t, d[2]))};
  const float dn = trilinear_norm(v, pos);
  const bool rejected = dn < __ldg(v.scalars + kRangeLo) || dn > __ldg(v.scalars + kRangeHi);
  long long j = static_cast<long long>(floorf(__fmul_rn(dn, static_cast<float>(v.lut_k))));
  j = j < 0 ? 0 : (j > v.lut_k - 1 ? v.lut_k - 1 : j);
  return rejected ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : __ldg(v.lut + j);
}

inline int blocks_for(long long n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

}  // namespace
