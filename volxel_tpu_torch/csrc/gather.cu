// Exact f32 table fetch by flat index, and the fused transfer-LUT fetch.
//
// Replaces the Pallas kernel volxel_tpu/render/mxu_gather.py:
// mxu_gather_f32 -> _mxu_gather_call (kernel _gather_kernel). Plain
// versions: volxel_tpu_torch/render/gather.py: gather_f32_plain and
// lookup_transfer_plain.
//
// Not carried over: the TPU cannot gather per lane, so the JAX package
// splits each f32 table into four byte planes (pack_gather_table) and
// selects a lane's word with a one-hot int8 matrix product, then rebuilds
// the bits with shifts. A Hopper thread loads the word itself, so there is
// no packing, no probe and no table-size cap.
//
// gather_f32: what bounds it on an H100 is bytes. It takes int32 indices,
// as the TPU kernel does, so a word moves 8 bytes (4 of index read, 4 of
// result written); the tables it reads (an environment map, the 1 MiB
// importance base) stay in the 50 MB L2. The design moves those bytes in
// 16-byte accesses: each thread of a grid of at most eight waves walks
// the words four at a time (grid-stride), loading four indices with one int4
// load where the index pointer is 16-byte aligned at that word and storing
// four results with one uint4 store. The words before the output's first
// 16-byte boundary and the last (n - head) mod 4 are done one at a time by
// the first threads of the same launch. The index and output streams are
// read and written once, so they take the streaming hints (__ldcs,
// __stcs) and leave L2 to the table. The 32-bit word is copied, so NaN
// payloads and denormals pass unchanged; a negative index wraps as in
// PyTorch's indexing; an index outside [-numel, numel) gives 0.
//
// lookup_transfer: one pass per decode round over a few thousand to a few
// hundred thousand lanes, 20 bytes each (density in, rgba out) and a
// 16-byte LUT row from L1. On an NVIDIA H100 80GB HBM3 at 700 W a call is
// a few microseconds, close to a bare launch, so what bounds it is
// launches: the gain over the plain version's ~6 launches is the count
// of launches, and folding the collision decode into the march kernel is
// what removes them. It follows sampling.lookup_transfer op for op: the
// rejection compares, floor(density * k) as an f32 multiply, the cast to
// int64 (static_cast, as ATen's copy does: NaN lands on 0, +-inf
// saturates), the clamp to [0, k-1] in int64, the 4-channel fetch and +0
// on rejection.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
// the grid: at most this many waves of full SMs (2048 threads each); each
// thread then walks a few groups
constexpr int kWaves = 8;

__device__ __forceinline__ uint32_t fetch(const uint32_t* __restrict__ table, int i, long long table_n) {
  long long j = i;
  if (j < 0) j += table_n;  // torch indexing wraps negative indices
  return (j >= 0 && j < table_n) ? __ldg(table + j) : 0u;
}

__global__ void __launch_bounds__(kThreads) gather_f32_kernel(const uint32_t* __restrict__ table,
                                                              const int32_t* __restrict__ idx,
                                                              uint32_t* __restrict__ out, long long n,
                                                              long long table_n) {
  const long long head = min(n, static_cast<long long>(((16 - (reinterpret_cast<uintptr_t>(out) & 15)) & 15) >> 2));
  const long long groups = (n - head) >> 2;
  const long long tail = head + 4 * groups;
  const bool idx_vec = (reinterpret_cast<uintptr_t>(idx + head) & 15) == 0;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // at most 3 words before the first group and 3 after the last
  if (first < head) __stcs(out + first, fetch(table, __ldcs(idx + first), table_n));
  if (tail + first < n) __stcs(out + tail + first, fetch(table, __ldcs(idx + tail + first), table_n));
  for (long long g = first; g < groups; g += stride) {
    const long long i = head + 4 * g;
    int4 j;
    if (idx_vec) {
      j = __ldcs(reinterpret_cast<const int4*>(idx + i));
    } else {
      j = make_int4(__ldcs(idx + i), __ldcs(idx + i + 1), __ldcs(idx + i + 2), __ldcs(idx + i + 3));
    }
    __stcs(reinterpret_cast<uint4*>(out + i), make_uint4(fetch(table, j.x, table_n), fetch(table, j.y, table_n),
                                                        fetch(table, j.z, table_n), fetch(table, j.w, table_n)));
  }
}

__global__ void __launch_bounds__(kThreads) lookup_transfer_kernel(const uint4* __restrict__ lut, int k,
                                                                   const float* __restrict__ range,
                                                                   const float* __restrict__ density,
                                                                   uint4* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float d = density[i];
  const bool rejected = (d < __ldg(range)) || (d > __ldg(range + 1));
  long long j = static_cast<long long>(floorf(d * static_cast<float>(k)));
  j = j < 0 ? 0 : (j > k - 1 ? k - 1 : j);
  out[i] = rejected ? make_uint4(0u, 0u, 0u, 0u) : __ldg(lut + j);
}

int blocks_for(long long n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int vx_gather_f32(const uint32_t* table, const int32_t* idx, uint32_t* out, long long n,
                             long long table_n, cudaStream_t stream) {
  if (n > 0) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long most = static_cast<long long>(sms) * (2048 / kThreads) * kWaves;
    const long long blocks = std::min(most, std::max(1LL, (n / 4 + kThreads - 1) / kThreads));
    gather_f32_kernel<<<static_cast<int>(blocks), kThreads, 0, stream>>>(table, idx, out, n, table_n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vx_lookup_transfer(const float* lut, int k, const float* range, const float* density,
                                  float* out_rgba, long long n, cudaStream_t stream) {
  if (n > 0) {
    lookup_transfer_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        reinterpret_cast<const uint4*>(lut), k, range, density, reinterpret_cast<uint4*>(out_rgba), n);
  }
  return static_cast<int>(cudaGetLastError());
}
