// Hable filmic tonemap + exposure + gamma for display (blit.frag:17-35).
//
// Replaces the Pallas kernel volxel_tpu/render/pallas_ops.py:
// tonemap_display_pallas (kernel _tonemap_kernel). Plain version:
// volxel_tpu_torch/render/pallas_ops.py: tonemap_plain.
//
// What bounds it on an H100: memory bandwidth. At 1080p it reads and
// writes 6,220,800 floats each (49.8 MB in all) and does ~15 flops and one
// powf per float, far below the card's compute rate.
//
// Design: a grid-stride loop over the flat 3N floats, 4 floats per thread
// per iteration through 16-byte loads and stores where the buffer is
// 16-byte aligned (torch allocations are), with a scalar loop for the
// tail. The grid is capped at a few waves of blocks so each thread streams
// several vectors. The curve constants are folded in double and rounded to
// float once, as Python folds them for the plain version.

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

__device__ __forceinline__ float hable(float x) {
  return ((x * (kA * x + kCB) + kDE) / (x * (kA * x + kB) + kDF)) - kEF;
}

__device__ __forceinline__ float map_one(float v, float exposure, float white, float inv_gamma) {
  const float mapped = hable(exposure * v) / white;
  // torch.clamp_min keeps a NaN; fmaxf alone would turn it into 0
  const float c = mapped != mapped ? mapped : fmaxf(mapped, 0.0f);
  return powf(c, inv_gamma);
}

__global__ void __launch_bounds__(kThreads) tonemap_kernel(const float* __restrict__ src,
                                                           float* __restrict__ dst, long long n,
                                                           float exposure, float inv_gamma) {
  const float white = hable(11.2f);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool aligned = (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(dst) % 16 == 0);
  long long done = 0;
  if (aligned) {
    const long long n4 = n / 4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (long long j = first; j < n4; j += stride) {
      const float4 v = s4[j];
      d4[j] = make_float4(map_one(v.x, exposure, white, inv_gamma),
                          map_one(v.y, exposure, white, inv_gamma),
                          map_one(v.z, exposure, white, inv_gamma),
                          map_one(v.w, exposure, white, inv_gamma));
    }
    done = n4 * 4;
  }
  for (long long j = done + first; j < n; j += stride) {
    dst[j] = map_one(src[j], exposure, white, inv_gamma);
  }
}

}  // namespace

extern "C" int vx_tonemap(const float* src, float* dst, long long n, float exposure,
                          float inv_gamma, cudaStream_t stream) {
  if (n > 0) {
    long long blocks = (n / 4 + kThreads - 1) / kThreads;
    if (blocks < 1) blocks = 1;
    if (blocks > 132 * 8) blocks = 132 * 8;  // a few waves on 132 SMs
    tonemap_kernel<<<static_cast<int>(blocks), kThreads, 0, stream>>>(src, dst, n, exposure,
                                                                     inv_gamma);
  }
  return static_cast<int>(cudaGetLastError());
}
