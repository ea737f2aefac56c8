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
// What bounds it on an H100: launches and bytes, not operations. A call
// moves 8 bytes of index and 4 of result per lane (20 bytes of density
// and rgba per lane for the LUT fetch) and does one or two loads; the
// tables it reads (a 2 KiB LUT, an environment map, the 1 MiB importance
// base) stay in L2. At the path's sizes (thousands to millions of lanes)
// a call is a few microseconds of device time, so the gain over the plain
// version is in launches: the fused LUT fetch is one launch where the
// plain version issues about six.
//
// gather_f32 copies the 32-bit word, so NaN payloads and denormals pass
// unchanged. lookup_transfer follows sampling.lookup_transfer op for op:
// the rejection compares, floor(density * k) as an f32 multiply, the cast
// to int64 (static_cast, as ATen's copy does: NaN lands on 0, +-inf
// saturates), the clamp to [0, k-1] in int64, the 4-channel fetch and +0
// on rejection.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) gather_f32_kernel(const uint32_t* __restrict__ table,
                                                              const int64_t* __restrict__ idx,
                                                              uint32_t* __restrict__ out, long long n,
                                                              long long table_n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long j = idx[i];
  if (j < 0) j += table_n;  // torch indexing wraps negative indices
  out[i] = (j >= 0 && j < table_n) ? __ldg(table + j) : 0u;
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

extern "C" int vx_gather_f32(const uint32_t* table, const int64_t* idx, uint32_t* out, long long n,
                             long long table_n, cudaStream_t stream) {
  if (n > 0) {
    gather_f32_kernel<<<blocks_for(n), kThreads, 0, stream>>>(table, idx, out, n, table_n);
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
