// DDA collision step: the default mode's decode and draws at the lanes the
// march parked, one launch per march round.
//
// Folds the transfer-LUT site of the Pallas kernel
// volxel_tpu/render/mxu_gather.py: mxu_gather_f32 (called for the LUT from
// volxel_tpu/render/sampling.py:820) into the loop bodies of
// volxel_tpu/render/modes.py: sample_volume_dda_pyr (:796-821) and
// transmittance_dda_pyr (:866-903), which decode the density at each
// collision candidate (trilinear, then the LUT) and draw the real/null test
// and what follows it. Plain versions: volxel_tpu_torch/render/collide.py:
// dda_collide_sample_plain and dda_collide_shadow_plain.
//
// What bounds it on an H100: the parked lanes' scattered reads. A round
// reads one byte (`running`) of every lane, and of each parked lane its
// ray, t, majorant and words and eight bf16 taps of the 256 MiB field,
// which does not stay in the 50 MB L2: the early rounds of a 1080p sample
// park hundreds of thousands of lanes, each tap in its own cache line. A
// round took ~11 us on average (PERF.md, section 6), several times its
// bytes bound and the ~3 us of a launch. The design is the plain one, one
// thread per lane over all lanes, with nothing staged: the gain is the
// ~170 PyTorch launches per round (a nonzero, gathers and scatters of the
// parked lanes, the decode, the LUT fetch, int64 RNG emulation) that one
// launch replaces.
// Lanes that are not parked are left as they are; state, tau, mip, running
// and the leg's outputs (hit and rgb, or tr) are updated in place.
//
// Bit-equality with the plain version: every f32 operation is the plain
// version's, in its order. -log(1 - xi) must round as ATen's log does, and
// ATen builds its log kernel with nvcc's default --fmad=true, so this file
// is built with --fmad=true too (kernels.FMAD_SOURCES) and every f32 sum,
// difference, product and quotient below is written with __fadd_rn,
// __fsub_rn, __fmul_rn or __fdiv_rn, which are never contracted into an
// FMA. vx_neg_log1m exposes the same -logf(1 - xi) so that a check can hold
// it against torch.log over all 2^24 values xi takes. The float -> int64
// casts are static_cast, as ATen's copy does (NaN lands on 0, +-inf
// saturates); clamp_min and maximum keep their NaN operand; the constants
// 0.1, 1e-20 and 2.0 are rounded to f32 once, as PyTorch rounds a Python
// scalar against an f32 tensor; a tap outside the extent reads 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKindColl = 1;
constexpr int kKindDone = 2;
constexpr float kSpeedDown = 2.0f;  // collide.MIP_SPEED_DOWN
// layout of the (5,) f32 scalars, as render/tilemarch.volume_scalars
constexpr int kInvMaj = 0, kVolMaj = 1, kDenScale = 2, kRangeLo = 3, kRangeHi = 4;

// torch.clamp_min(v, lo): a NaN v is returned as it is
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }

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

// the draw's value without consuming it (rng_where with a False mask)
__device__ __forceinline__ float peek_float(const uint32_t (&s)[4]) {
  uint32_t c[4] = {s[0], s[1], s[2], s[3]};
  return next_float(c);
}

__device__ __forceinline__ float neg_log1m(float xi) { return -logf(__fsub_rn(1.0f, xi)); }

// sampling.lookup_density_trilinear at one point, times inv_maj: the eight
// taps in _TAPS order (dz outer, dx inner), weights ((wx * wy) * wz), the
// products summed one after another
__device__ __forceinline__ float trilinear_norm(const uint16_t* __restrict__ dense, int ny, int nx, int ex,
                                                int ey, int ez, const float (&pos)[3], float density_scale,
                                                float inv_maj) {
  long long base[3];
  float w1[3][2];
  for (int a = 0; a < 3; ++a) {
    const float p = __fsub_rn(pos[a], 0.5f);
    base[a] = static_cast<long long>(floorf(p));
    const float f = __fsub_rn(p, static_cast<float>(base[a]));
    w1[a][0] = __fsub_rn(1.0f, f);
    w1[a][1] = f;
  }
  const long long ext[3] = {ex, ey, ez};
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
      const uint16_t bits = __ldg(dense + (c[2] * ny + c[1]) * nx + c[0]);
      tap = __uint_as_float(static_cast<uint32_t>(bits) << 16);  // bf16 -> f32 is exact
    }
    const float w = __fmul_rn(__fmul_rn(w1[0][off[0]], w1[1][off[1]]), w1[2][off[2]]);
    const float term = __fmul_rn(tap, w);
    acc = k == 0 ? term : __fadd_rn(acc, term);
  }
  return __fmul_rn(__fmul_rn(density_scale, acc), inv_maj);
}

// gather.lookup_transfer_plain: NEAREST row, 0 where rejected by the range
__device__ __forceinline__ float4 lookup_transfer(const float4* __restrict__ lut, int k, float d, float lo,
                                                  float hi) {
  const bool rejected = d < lo || d > hi;
  long long j = static_cast<long long>(floorf(__fmul_rn(d, static_cast<float>(k))));
  j = j < 0 ? 0 : (j > k - 1 ? k - 1 : j);
  return rejected ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : __ldg(lut + j);
}

struct Lanes {
  const uint16_t* dense;
  int ny, nx, ex, ey, ez;
  const float4* lut;
  int lut_k;
  const float* scalars;
  const float* ipos;
  const float* idir;
  const float* t;
  const float* maj;
  const int* kind;
  int64_t* state;
  float* tau;
  float* mip;
  bool* running;
  long long n;
};

// the parked lane's decoded rgba; false where the lane is not parked (a
// lane whose march is done stops running here)
__device__ __forceinline__ bool parked(const Lanes& a, long long i, float4& rgba) {
  if (!a.running[i]) return false;
  const int kind = a.kind[i];
  if (kind == kKindDone) a.running[i] = false;
  if (kind != kKindColl) return false;
  const float t = a.t[i];
  const float pos[3] = {__fadd_rn(a.ipos[3 * i], __fmul_rn(t, a.idir[3 * i])),
                        __fadd_rn(a.ipos[3 * i + 1], __fmul_rn(t, a.idir[3 * i + 1])),
                        __fadd_rn(a.ipos[3 * i + 2], __fmul_rn(t, a.idir[3 * i + 2]))};
  const float d = trilinear_norm(a.dense, a.ny, a.nx, a.ex, a.ey, a.ez, pos, __ldg(a.scalars + kDenScale),
                                 __ldg(a.scalars + kInvMaj));
  rgba = lookup_transfer(a.lut, a.lut_k, d, __ldg(a.scalars + kRangeLo), __ldg(a.scalars + kRangeHi));
  return true;
}

__device__ __forceinline__ void load_state(const Lanes& a, long long i, uint32_t (&s)[4]) {
  for (int j = 0; j < 4; ++j) s[j] = static_cast<uint32_t>(a.state[4 * i + j]);
}

__device__ __forceinline__ void store_state(const Lanes& a, long long i, const uint32_t (&s)[4]) {
  for (int j = 0; j < 4; ++j) a.state[4 * i + j] = static_cast<int64_t>(s[j]);
}

// modes.sample_volume_dda's round (dda.glsl:81-96): the real/null draw;
// a real collision ends the lane with the LUT colour, a null one redraws
// tau and steps the mip down
__global__ void __launch_bounds__(kThreads) dda_collide_sample_kernel(Lanes a, bool* __restrict__ hit,
                                                                      float* __restrict__ rgb) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float4 rgba;
  if (i >= a.n || !parked(a, i, rgba)) return;
  uint32_t s[4];
  load_state(a, i, s);
  const float d = __fmul_rn(__ldg(a.scalars + kVolMaj), rgba.w);
  const float xi1 = next_float(s);
  if (__fmul_rn(xi1, a.maj[i]) < d) {
    rgb[3 * i] = rgba.x;
    rgb[3 * i + 1] = rgba.y;
    rgb[3 * i + 2] = rgba.z;
    hit[i] = true;
    a.running[i] = false;
  } else {
    a.tau[i] = neg_log1m(next_float(s));
    a.mip[i] = clamp_min(__fsub_rn(a.mip[i], kSpeedDown), 0.0f);
  }
  store_state(a, i, s);
}

// modes.transmittance_dda's round (dda.glsl:36-61): the real/null draw, the
// ratio at a real collision (the reference's quirk 1 - vol_maj / maj, or
// 1 - d / maj when `physical`), russian roulette under 0.1 (a killed lane
// stops with tr = 0 before the tau draw), then the tau redraw and the mip
// step-down
template <bool kPhysical>
__global__ void __launch_bounds__(kThreads) dda_collide_shadow_kernel(Lanes a, float* __restrict__ tr) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float4 rgba;
  if (i >= a.n || !parked(a, i, rgba)) return;
  uint32_t s[4];
  load_state(a, i, s);
  const float vol_maj = __ldg(a.scalars + kVolMaj);
  const float d = __fmul_rn(vol_maj, rgba.w);
  const float maj = a.maj[i];
  const bool real = __fmul_rn(next_float(s), maj) < d;
  const float safe_maj = clamp_min(maj, static_cast<float>(1e-20));
  const float ratio = clamp_min(__fsub_rn(1.0f, __fdiv_rn(kPhysical ? d : vol_maj, safe_maj)), 0.0f);
  float tr_new = tr[i];
  if (real) tr_new = __fmul_rn(tr_new, ratio);
  const bool rr_active = real && tr_new < static_cast<float>(0.1);
  bool killed = false;
  if (rr_active) {
    killed = next_float(s) < __fsub_rn(1.0f, tr_new);
    if (!killed) tr_new = __fdiv_rn(tr_new, clamp_min(tr_new, static_cast<float>(1e-20)));
  }
  tr[i] = killed ? 0.0f : tr_new;
  // a killed lane keeps its words; its tau is the next draw's, unconsumed
  a.tau[i] = neg_log1m(killed ? peek_float(s) : next_float(s));
  a.mip[i] = clamp_min(__fsub_rn(a.mip[i], kSpeedDown), 0.0f);
  if (killed) a.running[i] = false;
  store_state(a, i, s);
}

__global__ void __launch_bounds__(kThreads) neg_log1m_kernel(const float* __restrict__ xi,
                                                             float* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = neg_log1m(xi[i]);
}

int blocks_for(long long n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

Lanes lanes(const uint16_t* dense, int ny, int nx, int ex, int ey, int ez, const float* lut, int lut_k,
            const float* scalars, const float* ipos, const float* idir, const float* t, const float* maj,
            const int* kind, int64_t* state, float* tau, float* mip, bool* running, long long n) {
  return Lanes{dense, ny, nx, ex, ey, ez, reinterpret_cast<const float4*>(lut), lut_k, scalars, ipos, idir, t,
               maj, kind, state, tau, mip, running, n};
}

}  // namespace

extern "C" int vx_dda_collide_sample(const uint16_t* dense, int ny, int nx, int ex, int ey, int ez,
                                     const float* lut, int lut_k, const float* scalars, const float* ipos,
                                     const float* idir, const float* t, const float* maj, const int* kind,
                                     int64_t* state, float* tau, float* mip, bool* running, bool* hit,
                                     float* rgb, long long n, cudaStream_t stream) {
  if (n > 0) {
    dda_collide_sample_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        lanes(dense, ny, nx, ex, ey, ez, lut, lut_k, scalars, ipos, idir, t, maj, kind, state, tau, mip,
              running, n),
        hit, rgb);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vx_dda_collide_shadow(const uint16_t* dense, int ny, int nx, int ex, int ey, int ez,
                                     const float* lut, int lut_k, const float* scalars, const float* ipos,
                                     const float* idir, const float* t, const float* maj, const int* kind,
                                     int64_t* state, float* tau, float* mip, bool* running, float* tr,
                                     int physical, long long n, cudaStream_t stream) {
  if (n > 0) {
    const Lanes a = lanes(dense, ny, nx, ex, ey, ez, lut, lut_k, scalars, ipos, idir, t, maj, kind, state, tau,
                          mip, running, n);
    if (physical) {
      dda_collide_shadow_kernel<true><<<blocks_for(n), kThreads, 0, stream>>>(a, tr);
    } else {
      dda_collide_shadow_kernel<false><<<blocks_for(n), kThreads, 0, stream>>>(a, tr);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// -logf(1 - xi) as the collision kernels compute it, for a check against
// torch.log; on no render path
extern "C" int vx_neg_log1m(const float* xi, float* out, long long n, cudaStream_t stream) {
  if (n > 0) neg_log1m_kernel<<<blocks_for(n), kThreads, 0, stream>>>(xi, out, n);
  return static_cast<int>(cudaGetLastError());
}
