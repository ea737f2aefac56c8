// Hable filmic tonemap + exposure + gamma for display (blit.frag:17-35).
//
// Replaces the Pallas kernel volxel_tpu/render/pallas_ops.py:
// tonemap_display_pallas (kernel _tonemap_kernel). Plain version:
// volxel_tpu_torch/render/pallas_ops.py: tonemap_plain.
//
// What bounds it on an H100: the instruction issue rate. At 1080p it reads
// and writes 6,220,800 floats each (49.8 MB in all, 14.9 us at 3.35 TB/s),
// and per float it runs two IEEE divisions and an accurate powf, ~140 SASS
// instructions (the static count of the kernel's own code, slow paths
// included). On an H100 at 700 W the map alone, with no load and no store,
// takes 26.9 us at 1080p, more than a 16-byte copy of the buffer (19.0 us;
// PERF.md section 6).
//
// Design: one thread per float4 and a grid sized to the work, so that no
// thread walks a grid-stride loop and as many warps as the card holds hide
// each other's loads behind their maps. Two, four or eight float4s a
// thread with all their loads issued first measured no faster (two) or
// slower (four, eight; PERF.md section 6): more loads in flight
// do not help a kernel whose map costs more than its memory traffic. Loads
// and stores are streaming (__ldcs / __stcs): the display copy is read
// once, by the host. A buffer that is not 16-byte aligned takes a scalar
// path, one float a thread, and so do the last n % 4 floats.
//
// Bit-equality with the plain version: the curve constants are folded in
// double and rounded to float once, as Python folds them for the plain
// version; the map's products and sums are written with __fmul_rn /
// __fadd_rn / __fsub_rn in the plain version's order, the divisions are
// IEEE (no reciprocal for / white), and powf is the math library's
// accurate one, which ATen's torch.pow calls. The file is built with
// --fmad=true (kernels.FMAD_SOURCES), as ATen builds its pow kernel, so
// that powf's own code is compiled as there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kA = 0.15f;
constexpr float kB = 0.50f;
constexpr float kCB = static_cast<float>(0.10 * 0.50);
constexpr float kDE = static_cast<float>(0.20 * 0.02);
constexpr float kDF = static_cast<float>(0.20 * 0.30);
constexpr float kEF = static_cast<float>(0.02 / 0.30);

// ((x * (A x + CB) + DE) / (x * (A x + B) + DF)) - EF
__device__ __forceinline__ float hable(float x) {
  const float ax = __fmul_rn(kA, x);
  const float num = __fadd_rn(__fmul_rn(x, __fadd_rn(ax, kCB)), kDE);
  const float den = __fadd_rn(__fmul_rn(x, __fadd_rn(ax, kB)), kDF);
  return __fsub_rn(__fdiv_rn(num, den), kEF);
}

__device__ __forceinline__ float map_one(float v, float exposure, float white, float inv_gamma) {
  const float mapped = __fdiv_rn(hable(__fmul_rn(exposure, v)), white);
  // torch.clamp_min keeps a NaN; fmaxf alone would turn it into 0
  const float c = mapped != mapped ? mapped : fmaxf(mapped, 0.0f);
  return powf(c, inv_gamma);
}

__device__ __forceinline__ float4 map4(float4 v, float exposure, float white, float inv_gamma) {
  return make_float4(map_one(v.x, exposure, white, inv_gamma), map_one(v.y, exposure, white, inv_gamma),
                     map_one(v.z, exposure, white, inv_gamma), map_one(v.w, exposure, white, inv_gamma));
}

__device__ __forceinline__ long long thread_index() {
  return static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
}

__global__ void __launch_bounds__(kThreads) tonemap_kernel(const float4* __restrict__ src, float4* __restrict__ dst,
                                                           long long n4, float exposure, float inv_gamma) {
  const long long j = thread_index();
  if (j < n4) __stcs(dst + j, map4(__ldcs(src + j), exposure, hable(11.2f), inv_gamma));
}

// the same map one float a thread, over the floats [first, n): a
// misaligned buffer, or the n % 4 floats after the float4s
__global__ void __launch_bounds__(kThreads) tonemap_scalar_kernel(const float* __restrict__ src,
                                                                  float* __restrict__ dst, long long first,
                                                                  long long n, float exposure, float inv_gamma) {
  const long long j = first + thread_index();
  if (j < n) __stcs(dst + j, map_one(__ldcs(src + j), exposure, hable(11.2f), inv_gamma));
}

int blocks_for(long long items) { return static_cast<int>((items + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int vx_tonemap(const float* src, float* dst, long long n, float exposure, float inv_gamma,
                          cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const bool aligned = reinterpret_cast<uintptr_t>(src) % 16 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  const long long n4 = aligned ? n / 4 : 0;
  if (n4 > 0) {
    tonemap_kernel<<<blocks_for(n4), kThreads, 0, stream>>>(reinterpret_cast<const float4*>(src),
                                                            reinterpret_cast<float4*>(dst), n4, exposure, inv_gamma);
  }
  if (4 * n4 < n) {
    tonemap_scalar_kernel<<<blocks_for(n - 4 * n4), kThreads, 0, stream>>>(src, dst, 4 * n4, n, exposure,
                                                                          inv_gamma);
  }
  return static_cast<int>(cudaGetLastError());
}
