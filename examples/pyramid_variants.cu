// Design variants of the importance pyramid (csrc/importance_pyramid.cu),
// for examples/pyramid_variants.py: the nine levels of the 512^2 base in one
// launch of one thread-block cluster, with no ticket.
//
// Cluster<C>: a cluster of C blocks (8, the portable size, or 16, which the
// launch allows as a non-portable size), block r owning rows [r * 512 / C,
// (r + 1) * 512 / C) of the base. Each block reads its rows with 16-byte
// loads (all in flight at once) and pools them through the levels whose
// rows it owns alone, writing each to global memory, down to one row of the
// (C x C) level; after a cluster barrier, block 0 reads the other blocks'
// rows of that level from their shared memory (distributed shared memory),
// then all blocks meet at a second barrier (so that no block's shared
// memory goes away while block 0 reads it) and block 0 builds the levels
// above. Every texel is ((top-left + top-right) + (bottom-left +
// bottom-right)) * 0.25 of the level below, the plain version's order (the
// file is built with --fmad=false), so each variant is bit-equal to it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kDim = 512;   // the base's edge
constexpr int kLevels = 9;  // 256^2 ... 1^2

__host__ __device__ constexpr int level_offset(int l) {
  int off = 0;
  for (int j = 1; j < l; ++j) off += (kDim >> j) * (kDim >> j);
  return off;
}

__host__ __device__ constexpr int log2i(int v) { return v <= 1 ? 0 : 1 + log2i(v / 2); }

__device__ __forceinline__ float pool(float a, float b, float c, float d) { return ((a + b) + (c + d)) * 0.25f; }

// rows x cols texels of a level in shared memory `src` -> level l (its rows
// from row0 of the global level of edge kDim >> l) in `dst` (shared, may be
// null) and in global memory
__device__ __forceinline__ void pool_rows(const float* src, float* dst, int rows, int cols, float* out, int l,
                                          int row0) {
  const int h = rows / 2, w = cols / 2, edge = kDim >> l;
  for (int i = threadIdx.x; i < h * w; i += blockDim.x) {
    const int y = i / w, x = i - y * w;
    const float* r0 = src + 2 * y * cols + 2 * x;
    const float v = pool(r0[0], r0[1], r0[cols], r0[cols + 1]);
    if (dst) dst[i] = v;
    out[level_offset(l) + (row0 + y) * edge + x] = v;
  }
  __syncthreads();
}

template <int C, int kThreads>
__device__ __forceinline__ void cluster_body(const float* __restrict__ base, float* __restrict__ out) {
  constexpr int kRows = kDim / C;          // a block's rows of the base
  constexpr int kOwn = log2i(kRows);       // the levels a block builds alone
  constexpr int kL1 = (kRows / 2) * (kDim / 2);
  __shared__ float a_buf[kL1];             // levels 1, 3, 5, ...
  __shared__ float b_buf[kL1 / 4];         // levels 2, 4, ...; block 0's top levels
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());

  // level 1: each item is two float4 rows of the base, pooled into two texels
  constexpr int kQuads = kDim / 4;
  constexpr int kItems = (kRows / 2) * kQuads;
  constexpr int kPer = kItems / kThreads;
  static_assert(kItems % kThreads == 0, "the items split evenly");
  float4 top[kPer], bottom[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int item = threadIdx.x + j * kThreads;
    const int y = item / kQuads, q = item - y * kQuads;
    const float* row = base + (r * kRows + 2 * y) * kDim + 4 * q;
    top[j] = __ldg(reinterpret_cast<const float4*>(row));
    bottom[j] = __ldg(reinterpret_cast<const float4*>(row + kDim));
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int item = threadIdx.x + j * kThreads;
    const int y = item / kQuads, q = item - y * kQuads;
    const float2 v = make_float2(pool(top[j].x, top[j].y, bottom[j].x, bottom[j].y),
                                 pool(top[j].z, top[j].w, bottom[j].z, bottom[j].w));
    a_buf[y * (kDim / 2) + 2 * q] = v.x;
    a_buf[y * (kDim / 2) + 2 * q + 1] = v.y;
    *reinterpret_cast<float2*>(out + level_offset(1) + (r * (kRows / 2) + y) * (kDim / 2) + 2 * q) = v;
  }
  __syncthreads();
  int rows = kRows / 2, cols = kDim / 2;
#pragma unroll
  for (int l = 2; l <= kOwn; ++l) {
    pool_rows(l % 2 ? b_buf : a_buf, l % 2 ? a_buf : b_buf, rows, cols, out, l, r * (rows / 2));
    rows /= 2;
    cols /= 2;
  }
  // each block holds one row (C texels) of the (C x C) level kOwn
  float* mine = kOwn % 2 ? a_buf : b_buf;
  cluster.sync();
  if (r == 0) {
    for (int i = threadIdx.x; i < C * C; i += blockDim.x) {
      const float* remote = cluster.map_shared_rank(mine, i / C);
      (kOwn % 2 ? b_buf : a_buf)[i] = remote[i % C];
    }
  }
  cluster.sync();
  if (r != 0) return;
  float* src = kOwn % 2 ? b_buf : a_buf;
  float* dst = kOwn % 2 ? a_buf : b_buf;
  int dim = C;
#pragma unroll
  for (int l = kOwn + 1; l <= kLevels; ++l) {
    pool_rows(src, dst, dim, dim, out, l, 0);
    float* t = src;
    src = dst;
    dst = t;
    dim /= 2;
  }
}

__global__ void __cluster_dims__(8, 1, 1) __launch_bounds__(1024) cluster8_kernel(const float* base, float* out) {
  cluster_body<8, 1024>(base, out);
}

__global__ void __cluster_dims__(16, 1, 1) __launch_bounds__(512) cluster16_kernel(const float* base, float* out) {
  cluster_body<16, 512>(base, out);
}

}  // namespace

// variant 0: a cluster of 8 blocks of 1024 threads; 1: of 16 blocks of 512
extern "C" int vx_pyramid_variant(int variant, const float* base, float* out, cudaStream_t stream) {
  if (variant == 0) {
    cluster8_kernel<<<8, 1024, 0, stream>>>(base, out);
  } else if (variant == 1) {
    const cudaError_t err = cudaFuncSetAttribute(cluster16_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    cluster16_kernel<<<16, 512, 0, stream>>>(base, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
