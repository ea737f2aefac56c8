// The environment's per-lane work (environment.glsl:19-86): the
// hierarchical warp sample with its radiance, pdf and direction, and the
// equirect lookup with, or in place of its radiance, the escape's pdf.
//
// Replaces the plain version volxel_tpu_torch/scene/environment.py
// (sample_environment_plain, lookup_environment_plain, pdf_environment_plain,
// lookup_environment_pdf_plain), which takes ~30 ATen ops over every lane at
// each of the warp's nine levels, then the bilinear tap and the texel fetch
// through gather_f32: ~609 launches a bounce of the path tracer. The JAX
// package's volxel_tpu/scene/environment.py is jnp with its table fetches in
// the Pallas kernel mxu_gather_f32 (volxel_tpu/render/mxu_gather.py), whose
// environment sites these kernels fold in.
//
// What bounds it on an H100: launches, then bytes. A warp sample reads two
// uniforms (8 B a lane) and writes the radiance, the pdf and the direction
// (28 B), 75 MB at 1080p, 0.022 ms at 3.35 TB/s; a lookup reads a direction
// (12 B) and writes 12 B of radiance and 4 B of pdf. The importance pyramid
// (1.4 MB) and the map stay in the 50 MB L2; a lane's nine levels are a
// chain of dependent 4-word loads.
//
// Design: one thread a lane, one launch a call. The warp's position and
// uniforms stay in registers through the nine levels, which are unrolled,
// so each level's size is a constant; the bilinear tap and the texel are
// loaded directly, with the indices gather_f32's callers compute.
//
// Bit-equality with the plain version, which runs one ATen kernel an op:
// every f32 sum, difference and product is written with __fadd_rn /
// __fsub_rn / __fmul_rn (never contracted) in the plain version's order,
// divisions by a tensor are IEEE (__fdiv_rn), and a division by a Python
// scalar is a product with its f32 reciprocal, as ATen computes it
// (1.0f / float(2 pi)); the scalars are the f32 values ATen converts the
// Python floats to, written in hex. atan2f, acosf, sinf and cosf are the
// math library's accurate functions, which ATen's kernels call; the file is
// built with --fmad=true (kernels.FMAD_SOURCES), as ATen builds those, so
// that their own code is compiled as there. sinf and cosf sit in
// out-of-line functions so that the compiler cannot fuse a sin and a cos of
// one angle into one sincos. clamp and clamp_min keep a NaN as ATen's do;
// float -> int casts are static_cast, as ATen's are (NaN lands on 0, +-inf
// saturates); torch.remainder on int32 is a floor modulo.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kImpDim = 512;  // scene.environment.IMP_DIM
constexpr int kImpLevels = 10;  // imp_mips[0] (512^2) .. imp_mips[9] (1^2)

// the f32 scalars of the plain version's ops
constexpr float kInv2Pi = 0x1.45f306p-3f;   // / (2.0 * math.pi): 1.0f / float(2 pi)
constexpr float kInvPi = 0x1.45f306p-2f;    // / math.pi: 1.0f / float(pi)
constexpr float kPi = 0x1.921fb6p+1f;       // * math.pi
constexpr float kTwoPiSq = 0x1.3bd3ccp+4f;  // * (2.0 * math.pi * math.pi)
constexpr float kInv4Pi = 0x1.45f306p-4f;   // * (1.0 / (4.0 * math.pi))
constexpr float kTiny = 0x1.5798eep-27f;    // clamp_min(., 1e-8)
constexpr float kSinMin = 0x1.0c6f7ap-20f;  // clamp_min(sin_t, 1e-6)
constexpr float kInvDim = 0x1p-9f;          // * (1.0 / IMP_DIM)
constexpr float kLuma0 = 0x1.b38cdap-3f, kLuma1 = 0x1.6e2974p-1f, kLuma2 = 0x1.279aaep-4f;  // rays.luma

// the pdf a lookup writes (vx_env_lookup's `pdf`)
constexpr int kNoPdf = 0, kReferencePdf = 1, kPhysicalPdf = 2;

// what every lane reads: the (h, w, 3) map, the pyramid, the strength
struct EnvMap {
  const float* map;
  int h, w;
  const float* mips[kImpLevels];
  const float* strength;
};

// torch.clamp_min / torch.clamp on f32: a NaN value is returned as it is
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp(float v, float lo, float hi) { return v != v ? v : fminf(fmaxf(v, lo), hi); }
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }
// torch.remainder on int32
__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}
__device__ __noinline__ float sin_f(float x) { return sinf(x); }
__device__ __noinline__ float cos_f(float x) { return cosf(x); }

// strength * _bilinear_wrap_clamp(map, u, v): the four taps of GL
// REPEAT in u and CLAMP_TO_EDGE in v, each row clamped on its own, weighted
// t00 (1 - fx)(1 - fy) + t10 fx (1 - fy) + t01 (1 - fx) fy + t11 fx fy
__device__ __forceinline__ void radiance(const EnvMap& e, float u, float v, float (&le)[3]) {
  const float x = __fsub_rn(__fmul_rn(u, static_cast<float>(e.w)), 0.5f);
  const float y = __fsub_rn(__fmul_rn(v, static_cast<float>(e.h)), 0.5f);
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = __fsub_rn(x, x0), fy = __fsub_rn(y, y0);
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  const int x0i = floor_mod(static_cast<int>(x0), e.w);
  const int x1i = floor_mod(x0i + 1, e.w);
  const int yi = static_cast<int>(y0);
  const int y0i = clampi(yi, 0, e.h - 1);
  const int y1i = clampi(static_cast<int>(static_cast<unsigned>(yi) + 1u), 0, e.h - 1);  // int32 wraps, as ATen's
  const float* t00 = e.map + 3 * (y0i * e.w + x0i);
  const float* t10 = e.map + 3 * (y0i * e.w + x1i);
  const float* t01 = e.map + 3 * (y1i * e.w + x0i);
  const float* t11 = e.map + 3 * (y1i * e.w + x1i);
  const float strength = __ldg(e.strength);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float s = __fadd_rn(__fmul_rn(__fmul_rn(__ldg(t00 + c), gx), gy), __fmul_rn(__fmul_rn(__ldg(t10 + c), fx), gy));
    s = __fadd_rn(s, __fmul_rn(__fmul_rn(__ldg(t01 + c), gx), fy));
    s = __fadd_rn(s, __fmul_rn(__fmul_rn(__ldg(t11 + c), fx), fy));
    le[c] = __fmul_rn(strength, s);
  }
}

__device__ __forceinline__ long long lane_index() {
  return static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
}

inline int blocks_for(long long n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

// sample_environment: the warp from the (n, 2) uniforms down the pyramid's
// nine levels to a texel of imp_mips[0] and a position in it, then the
// direction, the radiance there and the texel's pdf
template <bool kPhysical>
__global__ void __launch_bounds__(kThreads)
    env_sample_kernel(const EnvMap e, const float* __restrict__ rnd, float* __restrict__ le_out,
                      float* __restrict__ pdf_out, float* __restrict__ w_out, long long n) {
  const long long i = lane_index();
  if (i >= n) return;
  float px = rnd[2 * i], py = rnd[2 * i + 1];
  int pos_x = 0, pos_y = 0;
#pragma unroll
  for (int mip = kImpLevels - 2; mip >= 0; --mip) {
    const int dim = kImpDim >> mip;
    const float* flat = e.mips[mip] + ((pos_y * 2) * dim + pos_x * 2);
    const float w00 = __ldg(flat), w10 = __ldg(flat + 1), w01 = __ldg(flat + dim), w11 = __ldg(flat + dim + 1);
    const float q0 = __fadd_rn(w00, w01);  // left column
    const float q1 = __fadd_rn(w10, w11);  // right column
    const float d = __fdiv_rn(q0, clamp_min(__fadd_rn(q0, q1), kTiny));
    const bool go_right = px >= d;
    const float ev = __fdiv_rn(go_right ? w10 : w00, clamp_min(go_right ? q1 : q0, kTiny));
    px = go_right ? __fdiv_rn(__fsub_rn(px, d), clamp_min(__fsub_rn(1.0f, d), kTiny)) : __fdiv_rn(px, clamp_min(d, kTiny));
    pos_x = pos_x * 2 + static_cast<int>(go_right);
    const bool go_up = py >= ev;
    py = go_up ? __fdiv_rn(__fsub_rn(py, ev), clamp_min(__fsub_rn(1.0f, ev), kTiny)) : __fdiv_rn(py, clamp_min(ev, kTiny));
    pos_y = pos_y * 2 + static_cast<int>(go_up);
  }
  const float uv_x = __fmul_rn(__fadd_rn(static_cast<float>(pos_x), px), kInvDim);
  const float uv_y = __fmul_rn(__fadd_rn(static_cast<float>(pos_y), py), kInvDim);
  const float theta = __fmul_rn(clamp(__fsub_rn(1.0f, uv_y), 0.0f, 1.0f), kPi);
  const float phi = __fmul_rn(__fsub_rn(__fmul_rn(clamp(uv_x, 0.0f, 1.0f), 2.0f), 1.0f), kPi);
  const float sin_t = sin_f(theta);
  w_out[3 * i] = __fmul_rn(sin_t, cos_f(phi));
  w_out[3 * i + 1] = cos_f(theta);
  w_out[3 * i + 2] = __fmul_rn(sin_t, sin_f(phi));

  float le[3];
  radiance(e, uv_x, uv_y, le);
#pragma unroll
  for (int c = 0; c < 3; ++c) le_out[3 * i + c] = le[c];

  const float ratio = __fdiv_rn(__ldg(e.mips[0] + (pos_y * kImpDim + pos_x)), __ldg(e.mips[kImpLevels - 1]));
  if constexpr (kPhysical) {
    pdf_out[i] = __fdiv_rn(ratio, __fmul_rn(clamp_min(sin_t, kSinMin), kTwoPiSq));
  } else {
    pdf_out[i] = __fmul_rn(ratio, kInv4Pi);
  }
}

// lookup_environment and pdf_environment on the (n, 3) directions: _dir_to_uv
// once, then the radiance (written where kRadiance, and read by the
// reference's pdf) and the pdf kPdf
template <bool kRadiance, int kPdf>
__global__ void __launch_bounds__(kThreads)
    env_lookup_kernel(const EnvMap e, const float* __restrict__ dir, float* __restrict__ le_out,
                      float* __restrict__ pdf_out, long long n) {
  const long long i = lane_index();
  if (i >= n) return;
  const float dx = dir[3 * i], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
  const float y = clamp(dy, -1.0f, 1.0f);
  const float u = __fadd_rn(__fmul_rn(atan2f(dz, dx), kInv2Pi), 0.5f);
  const float v = __fsub_rn(1.0f, __fmul_rn(acosf(y), kInvPi));
  if constexpr (kRadiance || kPdf == kReferencePdf) {
    float le[3];
    radiance(e, u, v, le);
    if constexpr (kRadiance) {
#pragma unroll
      for (int c = 0; c < 3; ++c) le_out[3 * i + c] = le[c];
    }
    if constexpr (kPdf == kReferencePdf) {
      const float luma = __fadd_rn(__fadd_rn(__fmul_rn(le[0], kLuma0), __fmul_rn(le[1], kLuma1)), __fmul_rn(le[2], kLuma2));
      pdf_out[i] = __fmul_rn(__fdiv_rn(luma, __ldg(e.mips[kImpLevels - 1])), kInv4Pi);
    }
  }
  if constexpr (kPdf == kPhysicalPdf) {
    const int tx = clampi(static_cast<int>(__fmul_rn(u, static_cast<float>(kImpDim))), 0, kImpDim - 1);
    const int ty = clampi(static_cast<int>(__fmul_rn(v, static_cast<float>(kImpDim))), 0, kImpDim - 1);
    const float sin_t = __fsqrt_rn(clamp_min(__fsub_rn(1.0f, __fmul_rn(y, y)), 0.0f));
    const float texel = __ldg(e.mips[0] + (ty * kImpDim + tx));
    pdf_out[i] = __fdiv_rn(__fdiv_rn(texel, __ldg(e.mips[kImpLevels - 1])), __fmul_rn(clamp_min(sin_t, kSinMin), kTwoPiSq));
  }
}

EnvMap make_env(const float* map, int h, int w, const float* const* mips, const float* strength) {
  EnvMap e{map, h, w, {}, strength};
  for (int k = 0; k < kImpLevels; ++k) e.mips[k] = mips[k];
  return e;
}

template <bool kRadiance, int kPdf>
void launch_lookup(const EnvMap& e, const float* dir, float* le_out, float* pdf_out, long long n,
                   cudaStream_t stream) {
  env_lookup_kernel<kRadiance, kPdf><<<blocks_for(n), kThreads, 0, stream>>>(e, dir, le_out, pdf_out, n);
}

}  // namespace

// map: (h, w, 3) f32; mips: a host array of the ten importance levels'
// device pointers, level k (512 >> k)^2 f32; strength: one device f32;
// rnd: (n, 2) f32; physical: 0 or 1; le_out, w_out: (n, 3) f32; pdf_out: n f32
extern "C" int vx_env_sample(const float* map, int h, int w, const float* const* mips, const float* strength,
                             const float* rnd, int physical, float* le_out, float* pdf_out, float* w_out,
                             long long n, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const EnvMap e = make_env(map, h, w, mips, strength);
  if (physical) {
    env_sample_kernel<true><<<blocks_for(n), kThreads, 0, stream>>>(e, rnd, le_out, pdf_out, w_out, n);
  } else {
    env_sample_kernel<false><<<blocks_for(n), kThreads, 0, stream>>>(e, rnd, le_out, pdf_out, w_out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// map, h, w, mips, strength: as vx_env_sample; dir: (n, 3) f32; pdf: 0 none,
// 1 the reference's (luma over the mean, over 4 pi), 2 the physical one;
// le_out: null or (n, 3) f32; pdf_out: null (pdf 0) or n f32
extern "C" int vx_env_lookup(const float* map, int h, int w, const float* const* mips, const float* strength,
                             const float* dir, int pdf, float* le_out, float* pdf_out, long long n,
                             cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (h <= 0 || w <= 0 || pdf < kNoPdf || pdf > kPhysicalPdf || (pdf == kNoPdf) != (pdf_out == nullptr) ||
      (pdf == kNoPdf && le_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EnvMap e = make_env(map, h, w, mips, strength);
  if (le_out != nullptr) {
    switch (pdf) {
      case kNoPdf: launch_lookup<true, kNoPdf>(e, dir, le_out, pdf_out, n, stream); break;
      case kReferencePdf: launch_lookup<true, kReferencePdf>(e, dir, le_out, pdf_out, n, stream); break;
      default: launch_lookup<true, kPhysicalPdf>(e, dir, le_out, pdf_out, n, stream); break;
    }
  } else if (pdf == kReferencePdf) {
    launch_lookup<false, kReferencePdf>(e, dir, le_out, pdf_out, n, stream);
  } else {
    launch_lookup<false, kPhysicalPdf>(e, dir, le_out, pdf_out, n, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
