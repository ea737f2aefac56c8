// Raymarch step loops (the camera leg and the shadow leg), and nearest-tap
// density sums.
//
// Replaces the Pallas kernels of volxel_tpu/render/tilemarch.py:
// tile_march_sample (call :670, kernel from _sample_kernel_factory) and
// tile_march_sums (call :330, _sums_kernel_factory); the shadow leg's loop
// (volxel_tpu/render/modes.py: transmittance_raymarch, :1950-1960) had no
// TPU kernel, and folds in the transfer-LUT site of mxu_gather_f32
// (volxel_tpu/render/mxu_gather.py:196) there. Plain versions:
// volxel_tpu_torch/render/tilemarch.py: tile_march_sample_plain,
// tile_march_transmittance_plain and tile_march_sums_plain.
//
// Not carried over: Mosaic cannot gather per lane, so the TPU kernels pack
// rays into (T, 16, 384) micro-tiles, stream a block window of the dense
// field into VMEM per (tile, step) at precomputed block corners, select
// each lane's tap with one-hot matrix products, and freeze a lane whose
// tap support leaves the window so that an XLA loop can resume it
// (O_MISS / O_TAU, modes._raymarch_resume). Here a thread gathers its own
// tap with one load, so there is no packing, window, freeze or fallback,
// any bounce's rays can use the kernel (no tile coherence is needed), and
// the sums kernel has no window-miss output.
//
// What bounds the step loops on an H100: the instructions a step issues
// and the latency of its dependent gather, not bytes. A step is nine
// xoshiro128++ draws, the cubic weights, nine reservoir compares (each an
// IEEE division), one 2-byte tap of the 256 MiB bf16 field (which does not
// stay in the 50 MB L2) whose address depends on the draws, and the LUT:
// 409 SASS instructions in the camera loop's body for sm_90a, 399.5 a step
// in the shadow loop's; a camera lane stops at its hit, a shadow lane takes
// every step.
//
// Design (both loops): one thread per lane, 128 threads a block, and every
// lane writes all its outputs (a lane outside the box copies its words and
// writes the defaults). Lanes come in pixel order and a warp's rays take
// their steps together, so at each step their taps fall at about the same
// depth along neighbouring rays and share cache lines (warp efficiency 0.89
// and 0.92 at a 1080p raymarch sample). Each camera thread leaves its loop
// at its hit, so a warp costs its slowest lane. The f32 transfer LUT is
// staged in shared memory once per block. Designs of the camera loop
// measured on an H100 and left out (PERF.md, section 6): the state updated
// in place, a lane outside the box returning after reading `valid`; one
// wave of persistent blocks whose warps take valid lanes from a pool filled
// by an atomic counter, a thread taking the next ray when its own ends or
// the warp refilling when all its rays are done (both about 1.7 times this
// kernel's time); deciding the reservoir compare against a reciprocal
// estimate before the division (5-8% slower: it issues no fewer
// instructions); the division's own fast path without its range check
// (FCHK) and slow-path branch, taken where every axis's fraction lies in
// [0, 1] and `/` elsewhere (about 11% slower).
//
// The shadow loop has its own body (march_shadow): with no early out, the
// taps of the next two steps are in flight while a step's tap is consumed,
// under __launch_bounds__(128, 1) so that ptxas issues them ahead of their
// uses; the cell is located, the box tested and the LUT row formed in 32
// bits (__float2int_rd, unsigned compares, a clamped float), and the tap
// is indexed in 32 bits where the extent allows. Measured against it on an
// H100 (examples/tilemarch_variants.py; PERF.md, section 6): 1 or 4 taps
// ahead, each step consumed before its slot is refilled, two sets of slots
// in turns, 40 or 48 resident warps forced by the launch bounds, the LUT
// staged only by blocks with a lane inside the box or read from global
// memory, and the inside lanes packed by a kernel on the card (its copy of
// the outside lanes' words counted): each slower or no faster.
//
// Every f32 operation follows the plain version's order and the library is
// built with --fmad=false, so outputs are bit-equal to it on the card; the
// constants 1/6 and 1e-3 are rounded to f32 once, as PyTorch rounds a
// Python scalar, and torch.minimum / clamp_min NaN propagation is kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// torch.minimum and torch.clamp_min on the card: a NaN operand is returned
// as it is (its payload too)
__device__ __forceinline__ float min_nan(float a, float b) { return a != a ? a : (b != b ? b : fminf(a, b)); }
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }

__device__ __forceinline__ uint32_t rotl(uint32_t x, int k) { return (x << k) | (x >> (32 - k)); }

// xoshiro128++ step and the top-24-bit float (random.glsl:80-106)
__device__ __forceinline__ float next_float(uint32_t (&s)[4]) {
  const uint32_t result = rotl(s[0] + s[2], 7) + s[0];
  const uint32_t t = s[1] << 9;
  s[2] ^= s[0];
  s[3] ^= s[1];
  s[1] ^= s[2];
  s[0] ^= s[3];
  s[2] ^= t;
  s[3] = rotl(s[3], 11);
  return static_cast<float>(result >> 8) * (1.0f / 16777216.0f);
}

// bf16 -> f32 is exact: the bf16 bits are the f32's top half
__device__ __forceinline__ float dense_tap(const uint16_t* __restrict__ dense, int ny, int nx, int x,
                                           int y, int z) {
  const uint16_t bits = __ldg(dense + (static_cast<int64_t>(z) * ny + y) * nx + x);
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

__device__ __forceinline__ bool inside(int x, int y, int z, int ex, int ey, int ez) {
  return x >= 0 && x < ex && y >= 0 && y < ey && z >= 0 && z < ez;
}

// cubic B-spline weights of sampling.stochastic_tricubic_offsets, term for term
__device__ __forceinline__ void cubic_weights(float t, float (&w)[4]) {
  const float sixth = static_cast<float>(1.0 / 6.0);
  const float t2 = t * t;
  const float t3 = t * t2;
  w[0] = sixth * (((-t3 + 3.0f * t2) - 3.0f * t) + 1.0f);
  w[1] = sixth * ((3.0f * t3 - 6.0f * t2) + 4.0f);
  w[2] = sixth * (((-3.0f * t3 + 3.0f * t2) + 3.0f * t) + 1.0f);
  w[3] = sixth * t3;
}

struct March {
  const uint16_t* dense;
  int ny, nx, ex, ey, ez;
  const float* ipos;
  const float* idir;
  const float* start;
  const float* dt;
  const float* far;
  const bool* valid;
  const float* tau_target;  // the camera leg's hit test; null for the shadow leg
  const int64_t* state;
  const float* lut;
  int lut_k;
  const float* scalars;
  int64_t* state_out;
  bool* hit;       // camera leg
  float* t_out;    // camera leg
  float* rgb_out;  // camera leg
  float* tau_out;  // shadow leg
  int n;
  int steps;
};

// the camera leg's step loop: each lane stops at its first step with tau >=
// tau_target
__device__ __forceinline__ void march_camera(const March& a, const float* __restrict__ s_lut) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int64_t i3 = 3 * static_cast<int64_t>(i), i4 = 4 * static_cast<int64_t>(i);
  uint32_t s[4];
  for (int j = 0; j < 4; ++j) s[j] = static_cast<uint32_t>(a.state[i4 + j]);
  float tau = 0.0f;
  bool hit = false;
  float t_hit = 0.0f;
  float rgb[3] = {1.0f, 1.0f, 1.0f};
  if (a.valid[i]) {
    const float inv_maj = __ldg(a.scalars + 0);
    const float vol_maj = __ldg(a.scalars + 1);
    const float density_scale = __ldg(a.scalars + 2);
    const float range_lo = __ldg(a.scalars + 3);
    const float range_hi = __ldg(a.scalars + 4);
    const float px = a.ipos[i3], py = a.ipos[i3 + 1], pz = a.ipos[i3 + 2];
    const float dx = a.idir[i3], dy = a.idir[i3 + 1], dz = a.idir[i3 + 2];
    const float start = a.start[i], dt = a.dt[i], far = a.far[i];
    const float tau_target = a.tau_target[i];
    for (int k = 0; k < a.steps; ++k) {
      const float t = min_nan(start + static_cast<float>(k) * dt, far);
      // stochastic_tricubic_offsets: p = pos - 0.5, a reservoir over taps
      // 1..3 per axis with one rng3 draw (x, y, z) per tap
      const float p[3] = {(px + t * dx) - 0.5f, (py + t * dy) - 0.5f, (pz + t * dz) - 0.5f};
      int base[3];
      float w[3][4];
      float sum_w[3];
      int pick[3] = {0, 0, 0};
      for (int c = 0; c < 3; ++c) {
        base[c] = static_cast<int>(floorf(p[c]));
        cubic_weights(p[c] - static_cast<float>(base[c]), w[c]);
        sum_w[c] = w[c][0];
      }
      for (int tap = 1; tap <= 3; ++tap) {
        for (int c = 0; c < 3; ++c) sum_w[c] = sum_w[c] + w[c][tap];
        for (int c = 0; c < 3; ++c) {
          const float r = next_float(s);
          if (r < w[c][tap] / clamp_min(sum_w[c], static_cast<float>(1e-3))) pick[c] = tap;
        }
      }
      const int x = base[0] + pick[0] - 1, y = base[1] + pick[1] - 1, z = base[2] + pick[2] - 1;
      const float voxel = inside(x, y, z, a.ex, a.ey, a.ez) ? dense_tap(a.dense, a.ny, a.nx, x, y, z) : 0.0f;
      const float dens = (density_scale * voxel) * inv_maj;
      // lookup_transfer: NEAREST with range rejection (common.glsl:78-83)
      const bool rejected = dens < range_lo || dens > range_hi;
      long long li = static_cast<long long>(floorf(dens * static_cast<float>(a.lut_k)));
      li = li < 0 ? 0 : (li > a.lut_k - 1 ? a.lut_k - 1 : li);
      const float alpha = rejected ? 0.0f : s_lut[4 * li + 3];
      tau = tau + (alpha * vol_maj) * dt;
      if (tau >= tau_target) {
        hit = true;
        t_hit = t;
        for (int c = 0; c < 3; ++c) rgb[c] = rejected ? 0.0f : s_lut[4 * li + c];
        break;
      }
    }
  }
  for (int j = 0; j < 4; ++j) a.state_out[i4 + j] = static_cast<int64_t>(s[j]);
  a.hit[i] = hit;
  a.t_out[i] = t_hit;
  for (int c = 0; c < 3; ++c) a.rgb_out[i3 + c] = rgb[c];
}

// The shadow leg's step loop, a body of its own beside the camera leg's.
// Every lane inside the box takes all `steps` steps, and a
// step's tap address depends on its t and its draws, never on tau, so the
// taps of later steps can be in flight while a step's tap is consumed, with
// nothing speculated. At step k the draws and the tap of step k + kAhead
// are issued, then step k's tap is consumed (its LUT row, then tau); the
// draws and the sums keep the plain order, so the words and tau are the
// same bits. kNarrow: a 32-bit tap index, for a field whose extent holds at
// most 2^31 elements (the launch picks it).
constexpr int kAhead = 2;

// a shadow lane's ray and the volume's scalars
struct ShadowLane {
  float o[3], d[3], start, dt, far;
  float inv_maj, vol_maj, density_scale, range_lo, range_hi, lut_k, lut_top;
};

// step k's t, the reservoir's nine draws and its tap's load, issued (0
// outside the extent). The cell is located with __float2int_rd, the floor
// and the saturating int cast of the plain form in one (NaN lands on 0), and
// the box test is three unsigned compares.
template <bool kNarrow>
__device__ __forceinline__ uint32_t issue_tap(const March& a, const ShadowLane& l, int k, uint32_t (&s)[4]) {
  const float t = min_nan(l.start + static_cast<float>(k) * l.dt, l.far);
  const float p[3] = {(l.o[0] + t * l.d[0]) - 0.5f, (l.o[1] + t * l.d[1]) - 0.5f, (l.o[2] + t * l.d[2]) - 0.5f};
  int base[3];
  float w[3][4];
  float sum_w[3];
  int pick[3] = {0, 0, 0};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    base[c] = __float2int_rd(p[c]);
    cubic_weights(p[c] - static_cast<float>(base[c]), w[c]);
    sum_w[c] = w[c][0];
  }
#pragma unroll
  for (int tap = 1; tap <= 3; ++tap) {
#pragma unroll
    for (int c = 0; c < 3; ++c) sum_w[c] = sum_w[c] + w[c][tap];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float r = next_float(s);
      if (r < w[c][tap] / clamp_min(sum_w[c], static_cast<float>(1e-3))) pick[c] = tap;
    }
  }
  const int x = base[0] + pick[0] - 1, y = base[1] + pick[1] - 1, z = base[2] + pick[2] - 1;
  uint32_t bits = 0;
  if (static_cast<unsigned>(x) < static_cast<unsigned>(a.ex) && static_cast<unsigned>(y) < static_cast<unsigned>(a.ey) &&
      static_cast<unsigned>(z) < static_cast<unsigned>(a.ez)) {
    if constexpr (kNarrow) {
      bits = __ldg(a.dense + (static_cast<unsigned>(z) * a.ny + y) * a.nx + x);
    } else {
      bits = __ldg(a.dense + (static_cast<int64_t>(z) * a.ny + y) * a.nx + x);
    }
  }
  return bits;
}

// a step's tap consumed: bf16 -> f32 (exact; +0 outside), the LUT's NEAREST
// row with range rejection as floor(clamp(y, 0, K - 1)) in 32 bits (fmaxf
// takes a NaN y to row 0, as the plain form's 64-bit cast and clamp do),
// then tau += (alpha * vol_maj) * dt
__device__ __forceinline__ float consume_tap(const ShadowLane& l, const float* __restrict__ s_lut, uint32_t bits,
                                             float tau) {
  const float dens = (l.density_scale * __uint_as_float(bits << 16)) * l.inv_maj;
  const int row = __float2int_rd(fminf(fmaxf(dens * l.lut_k, 0.0f), l.lut_top));
  const float alpha = (dens < l.range_lo || dens > l.range_hi) ? 0.0f : s_lut[4 * row + 3];
  return tau + (alpha * l.vol_maj) * l.dt;
}

template <bool kNarrow>
__device__ __forceinline__ void march_shadow(const March& a, const float* __restrict__ s_lut) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int64_t i3 = 3 * static_cast<int64_t>(i), i4 = 4 * static_cast<int64_t>(i);
  uint32_t s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = static_cast<uint32_t>(a.state[i4 + j]);
  float tau = 0.0f;
  if (a.valid[i]) {
    const ShadowLane l{{a.ipos[i3], a.ipos[i3 + 1], a.ipos[i3 + 2]},
                       {a.idir[i3], a.idir[i3 + 1], a.idir[i3 + 2]},
                       a.start[i], a.dt[i], a.far[i],
                       __ldg(a.scalars + 0), __ldg(a.scalars + 1), __ldg(a.scalars + 2), __ldg(a.scalars + 3),
                       __ldg(a.scalars + 4), static_cast<float>(a.lut_k), static_cast<float>(a.lut_k - 1)};
    uint32_t ring[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) ring[j] = j < a.steps ? issue_tap<kNarrow>(a, l, j, s) : 0u;
    for (int k = 0; k < a.steps; k += kAhead) {
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const uint32_t bits = ring[j];
        if (k + j + kAhead < a.steps) ring[j] = issue_tap<kNarrow>(a, l, k + j + kAhead, s);
        if (k + j < a.steps) tau = consume_tap(l, s_lut, bits, tau);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) a.state_out[i4 + j] = static_cast<int64_t>(s[j]);
  a.tau_out[i] = tau;
}

__device__ __forceinline__ const float* stage_lut(const March& a, float* s_lut) {
  for (int j = threadIdx.x; j < 4 * a.lut_k; j += blockDim.x) s_lut[j] = a.lut[j];
  __syncthreads();
  return s_lut;
}

__global__ void __launch_bounds__(kThreads) tile_march_sample_kernel(March a) {
  extern __shared__ float s_lut[];  // lut_k x 4
  march_camera(a, stage_lut(a, s_lut));
}

// one block an SM named, so that ptxas keeps the taps' loads ahead of
// their uses (it may take the registers for it)
template <bool kNarrow>
__global__ void __launch_bounds__(kThreads, 1) tile_march_transmittance_kernel(March a) {
  extern __shared__ float s_lut[];  // lut_k x 4
  march_shadow<kNarrow>(a, stage_lut(a, s_lut));
}

using MarchKernel = void (*)(March);

// the shadow leg's kernel for the field: a 32-bit tap index where the
// extent holds at most 2^31 elements (every tap it loads lies inside it)
MarchKernel transmittance_kernel(int ny, int nx, int ez) {
  return static_cast<long long>(ez) * ny * nx <= (1LL << 31) ? tile_march_transmittance_kernel<true>
                                                             : tile_march_transmittance_kernel<false>;
}

__global__ void __launch_bounds__(kThreads) tile_march_sums_kernel(
    const uint16_t* __restrict__ dense, int ny, int nx, int ex, int ey, int ez,
    const float* __restrict__ ipos, const float* __restrict__ idir, const float* __restrict__ start_in,
    const float* __restrict__ dt_in, const float* __restrict__ far_in, const bool* __restrict__ valid,
    float* __restrict__ sums, int n, int steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  if (valid[i]) {
    const float px = ipos[3 * i], py = ipos[3 * i + 1], pz = ipos[3 * i + 2];
    const float dx = idir[3 * i], dy = idir[3 * i + 1], dz = idir[3 * i + 2];
    const float start = start_in[i], dt = dt_in[i], far = far_in[i];
    for (int k = 0; k < steps; ++k) {
      const float t = min_nan(start + static_cast<float>(k) * dt, far);
      const int x = static_cast<int>(floorf((px + t * dx) - 0.5f));
      const int y = static_cast<int>(floorf((py + t * dy) - 0.5f));
      const int z = static_cast<int>(floorf((pz + t * dz) - 0.5f));
      acc = acc + (inside(x, y, z, ex, ey, ez) ? dense_tap(dense, ny, nx, x, y, z) : 0.0f);
    }
  }
  sums[i] = acc;
}

int launch_march(MarchKernel kernel, const March& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(a.lut_k);
  kernel<<<(a.n + kThreads - 1) / kThreads, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vx_tile_march_sample(const uint16_t* dense, int ny, int nx, int ex, int ey, int ez,
                                    const float* ipos, const float* idir, const float* start,
                                    const float* dt, const float* far, const bool* valid,
                                    const float* tau_target, const int64_t* state, const float* lut,
                                    int lut_k, const float* scalars, int64_t* state_out, bool* hit,
                                    float* t_out, float* rgb_out, int n, int steps, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const March a{dense, ny, nx, ex, ey, ez, ipos, idir, start, dt, far, valid, tau_target, state, lut, lut_k,
                scalars, state_out, hit, t_out, rgb_out, nullptr, n, steps};
  return launch_march(tile_march_sample_kernel, a, stream);
}

extern "C" int vx_tile_march_transmittance(const uint16_t* dense, int ny, int nx, int ex, int ey, int ez,
                                           const float* ipos, const float* idir, const float* start,
                                           const float* dt, const float* far, const bool* valid,
                                           const int64_t* state, const float* lut, int lut_k,
                                           const float* scalars, int64_t* state_out, float* tau_out, int n,
                                           int steps, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const March a{dense, ny, nx, ex, ey, ez, ipos, idir, start, dt, far, valid, nullptr, state, lut, lut_k,
                scalars, state_out, nullptr, nullptr, nullptr, tau_out, n, steps};
  return launch_march(transmittance_kernel(ny, nx, ez), a, stream);
}

// the warps that kernel `kernel` (0 the camera leg, 1 the shadow leg with a
// 32-bit tap index, 2 with a 64-bit one) keeps resident on one SM of the
// current card with a LUT of lut_k rows staged
extern "C" int vx_tile_march_resident_warps(int kernel, int lut_k, int* warps) {
  int blocks = 0;
  const void* fn = kernel == 0   ? reinterpret_cast<const void*>(tile_march_sample_kernel)
                   : kernel == 1 ? reinterpret_cast<const void*>(tile_march_transmittance_kernel<true>)
                                 : reinterpret_cast<const void*>(tile_march_transmittance_kernel<false>);
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, sizeof(float) * 4 * static_cast<size_t>(lut_k));
  *warps = blocks * kThreads / 32;
  return static_cast<int>(err);
}

extern "C" int vx_tile_march_sums(const uint16_t* dense, int ny, int nx, int ex, int ey, int ez,
                                  const float* ipos, const float* idir, const float* start, const float* dt,
                                  const float* far, const bool* valid, float* sums, int n, int steps,
                                  cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    tile_march_sums_kernel<<<blocks, kThreads, 0, stream>>>(dense, ny, nx, ex, ey, ez, ipos, idir, start,
                                                            dt, far, valid, sums, n, steps);
  }
  return static_cast<int>(cudaGetLastError());
}
