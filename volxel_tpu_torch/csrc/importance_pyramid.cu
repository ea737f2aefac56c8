// The environment importance pyramid: nine levels of 2x2 mean pooling of
// the 512^2 base (256^2 ... 1^2), in one launch.
//
// Replaces the Pallas kernel volxel_tpu/render/pallas_ops.py:
// build_importance_pyramid_pallas (kernel _pyramid_kernel), which built all
// nine levels in one call as pooling-operator matrix products on the MXU.
// Plain version: volxel_tpu_torch/render/pallas_ops.py:
// build_importance_pyramid_plain. Matrix products are not needed: the TPU
// used them only because its vector unit cannot reshape across lanes
// cheaply.
//
// What bounds it on an H100: latency, not bytes. The whole pyramid reads
// 1 MiB and writes 0.33 MiB, about 0.4 us at the card's memory rate, less
// than one launch; each level depends on the one before it.
//
// Design: one launch of 64 blocks, each owning a 64x64 tile of the base.
// A block reads its tile with 16-byte loads (all in flight at once) and
// pools it through six levels in shared memory, writing each level's part
// to global memory; its last texel is one texel of the 8x8 level. Then a
// __threadfence() and an atomic ticket: the block that takes the last
// ticket reads the 8x8 level back and builds 4^2, 2^2 and 1^2, then resets
// the ticket for the next launch (so builds on one card run one after
// another, as they do on one stream). The nine levels are consecutive in
// one output buffer (level l at sum over j < l of (512 >> j)^2 floats, each
// 16-byte aligned). A texel is ((top-left + top-right) + (bottom-left +
// bottom-right)) * 0.25, the plain version's order; the file is built with
// --fmad=false, so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kDim = 512;                 // the base's edge (IMP_DIM)
constexpr int kLevels = 9;                // 256^2 ... 1^2 (IMP_BASE_MIP)
constexpr int kTile = 64;                 // a block's tile of the base
constexpr int kTiles = kDim / kTile;      // 8 x 8 blocks
constexpr int kThreads = 256;
constexpr int kBlockLevels = 6;           // 32^2 ... 1^2 of a tile
constexpr int kTopDim = kDim >> kBlockLevels;  // 8: the level the blocks end on

__device__ unsigned int pyramid_ticket = 0;

// the offset of level l (1-based) in the output buffer
__host__ __device__ constexpr int level_offset(int l) {
  int off = 0;
  for (int j = 1; j < l; ++j) off += (kDim >> j) * (kDim >> j);
  return off;
}

__device__ __forceinline__ float pool(float a, float b, float c, float d) { return ((a + b) + (c + d)) * 0.25f; }

// texels of level `dim` (edge) in shared memory `src` -> level dim / 2 in
// `dst` (shared, may be null) and at (y0 + y, x0 + x) of the global level l
// of edge `gdim`
__device__ __forceinline__ void pool_level(const float* src, float* dst, int dim, float* out, int l, int gdim, int y0,
                                           int x0) {
  const int half = dim / 2;
  for (int i = threadIdx.x; i < half * half; i += blockDim.x) {
    const int y = i / half, x = i - y * half;
    const float* r0 = src + 2 * y * dim + 2 * x;
    const float v = pool(r0[0], r0[1], r0[dim], r0[dim + 1]);
    if (dst) dst[i] = v;
    out[level_offset(l) + (y0 + y) * gdim + x0 + x] = v;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) importance_pyramid_kernel(const float* __restrict__ base,
                                                                      float* __restrict__ out) {
  __shared__ float lv[2][(kTile / 2) * (kTile / 2)];  // two levels of the tile, ping-pong
  __shared__ bool last;
  const int tx = blockIdx.x % kTiles, ty = blockIdx.x / kTiles;

  // level 1: each thread pools two 2x4 blocks of the tile (two float4 rows
  // each) into two pairs of texels; all four loads issued first
  constexpr int kQuads = kTile / 4;                     // float4s a tile row
  constexpr int kItems = (kTile / 2) * kQuads;          // (row pair, float4) items: 512
  constexpr int kPerThread = kItems / kThreads;         // 2
  float4 top[kPerThread], bottom[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int item = threadIdx.x + j * kThreads;
    const int y = item / kQuads, q = item - y * kQuads;
    const float* row = base + (ty * kTile + 2 * y) * kDim + tx * kTile + 4 * q;
    top[j] = __ldg(reinterpret_cast<const float4*>(row));
    bottom[j] = __ldg(reinterpret_cast<const float4*>(row + kDim));
  }
  constexpr int kL1 = kTile / 2;  // 32
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int item = threadIdx.x + j * kThreads;
    const int y = item / kQuads, q = item - y * kQuads;
    const float2 v = make_float2(pool(top[j].x, top[j].y, bottom[j].x, bottom[j].y),
                                 pool(top[j].z, top[j].w, bottom[j].z, bottom[j].w));
    lv[0][y * kL1 + 2 * q] = v.x;
    lv[0][y * kL1 + 2 * q + 1] = v.y;
    *reinterpret_cast<float2*>(out + level_offset(1) + (ty * kL1 + y) * (kDim / 2) + tx * kL1 + 2 * q) = v;
  }
  __syncthreads();

  // levels 2..6 of the tile; level 6 is one texel of the 8x8 level
  int dim = kL1;
#pragma unroll
  for (int l = 2; l <= kBlockLevels; ++l) {
    pool_level(lv[l % 2], l < kBlockLevels ? lv[(l + 1) % 2] : nullptr, dim, out, l, kDim >> l, ty * (dim / 2),
               tx * (dim / 2));
    dim /= 2;
  }

  // the last block to finish builds levels 7..9 from the 8x8 level
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&pyramid_ticket, 1u) == kTiles * kTiles - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* top_level = lv[0];
  for (int i = threadIdx.x; i < kTopDim * kTopDim; i += blockDim.x) top_level[i] = __ldcg(out + level_offset(kBlockLevels) + i);
  __syncthreads();
  dim = kTopDim;
#pragma unroll
  for (int l = kBlockLevels + 1; l <= kLevels; ++l) {
    pool_level(lv[(l + 1) % 2], lv[l % 2], dim, out, l, kDim >> l, 0, 0);
    dim /= 2;
  }
  if (threadIdx.x == 0) pyramid_ticket = 0;
}

static_assert(level_offset(kLevels + 1) == (kDim * kDim - 1) / 3, "the nine levels hold (512^2 - 1) / 3 texels");

}  // namespace

// the nine levels of the (512, 512) f32 base (16-byte aligned) into `out`
// ((512^2 - 1) / 3 floats, level after level)
extern "C" int vx_importance_pyramid(const float* base, float* out, cudaStream_t stream) {
  importance_pyramid_kernel<<<kTiles * kTiles, kThreads, 0, stream>>>(base, out);
  return static_cast<int>(cudaGetLastError());
}
