// One level of the environment importance pyramid: 2x2 mean pooling.
//
// Replaces the Pallas kernel volxel_tpu/render/pallas_ops.py:
// build_importance_pyramid_pallas (kernel _pyramid_kernel), which built all
// nine levels in one call as pooling-operator matrix products on the MXU.
// Plain version: volxel_tpu_torch/render/pallas_ops.py:
// build_importance_pyramid_plain. The wrapper launches this kernel once per
// level, nine times for the 512^2 base.
//
// What bounds it on an H100: launch latency. The whole pyramid reads
// 1.33 MiB and writes 0.33 MiB, a few microseconds of memory traffic, so
// the nine dependent launches cost more than the work.
//
// Design: one thread per output texel, each reading its 2x2 block as two
// 8-byte row loads (the output row's source rows are contiguous in x).
// Matrix products are not needed: the TPU used them only because its
// vector unit cannot reshape across lanes cheaply. The sum is taken as
// (row 0) + (row 1) of per-row pairs and multiplied by 0.25, exact scaling.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    pool2x2_kernel(const float* __restrict__ src, float* __restrict__ dst, int out_h, int out_w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= out_h * out_w) return;
  const int y = i / out_w;
  const int x = i - y * out_w;
  const int in_w = 2 * out_w;
  const float2 r0 = *reinterpret_cast<const float2*>(src + (2 * y) * in_w + 2 * x);
  const float2 r1 = *reinterpret_cast<const float2*>(src + (2 * y + 1) * in_w + 2 * x);
  dst[i] = ((r0.x + r0.y) + (r1.x + r1.y)) * 0.25f;
}

}  // namespace

extern "C" int vx_pool2x2(const float* src, float* dst, int out_h, int out_w, cudaStream_t stream) {
  const int n = out_h * out_w;
  if (n > 0) {
    pool2x2_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(src, dst, out_h, out_w);
  }
  return static_cast<int>(cudaGetLastError());
}
