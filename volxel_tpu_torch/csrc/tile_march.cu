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
// 409 SASS instructions in the loop body for sm_90a; a camera lane stops
// at its hit, a shadow lane takes every step.
//
// Design (both loops): one thread per lane, 128 threads a block, and every
// lane writes all its outputs (a lane outside the box copies its words and
// writes the defaults). Lanes come in pixel order and a warp's rays take
// their steps together, so at each step their taps fall at about the same
// depth along neighbouring rays and share cache lines. Each thread leaves
// its loop at its hit, so a warp costs its slowest lane. The f32 transfer
// LUT is staged in shared memory once per block. Designs measured on an
// H100 and left out (PERF.md, section 6): the state updated in place, a
// lane outside the box returning after reading `valid` (K5 no faster; the
// shadow loop 0.02 ms faster, 0.07% of a raymarch sample, which does not
// pay for a second interface); one wave of persistent blocks whose warps
// take valid lanes from a pool filled by an atomic counter, a thread
// taking the next ray when its own ends or the warp refilling when all its
// rays are done (both about 1.7 times this kernel's time); deciding the
// reservoir compare against a reciprocal estimate before the division
// (5-8% slower: it issues no fewer instructions); the division's own fast
// path without its range check (FCHK) and slow-path branch, taken where
// every axis's fraction lies in [0, 1] and `/` elsewhere (about 11%
// slower).
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

template <bool kCamera>
__device__ __forceinline__ void march(const March& a, const float* __restrict__ s_lut) {
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
    const float tau_target = kCamera ? a.tau_target[i] : 0.0f;
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
      if (kCamera && tau >= tau_target) {
        hit = true;
        t_hit = t;
        for (int c = 0; c < 3; ++c) rgb[c] = rejected ? 0.0f : s_lut[4 * li + c];
        break;
      }
    }
  }
  for (int j = 0; j < 4; ++j) a.state_out[i4 + j] = static_cast<int64_t>(s[j]);
  if (kCamera) {
    a.hit[i] = hit;
    a.t_out[i] = t_hit;
    for (int c = 0; c < 3; ++c) a.rgb_out[i3 + c] = rgb[c];
  } else {
    a.tau_out[i] = tau;
  }
}

__device__ __forceinline__ const float* stage_lut(const March& a, float* s_lut) {
  for (int j = threadIdx.x; j < 4 * a.lut_k; j += blockDim.x) s_lut[j] = a.lut[j];
  __syncthreads();
  return s_lut;
}

__global__ void __launch_bounds__(kThreads) tile_march_sample_kernel(March a) {
  extern __shared__ float s_lut[];  // lut_k x 4
  march<true>(a, stage_lut(a, s_lut));
}

__global__ void __launch_bounds__(kThreads) tile_march_transmittance_kernel(March a) {
  extern __shared__ float s_lut[];  // lut_k x 4
  march<false>(a, stage_lut(a, s_lut));
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

int launch_march(void (*kernel)(March), const March& a, cudaStream_t stream) {
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
  return launch_march(tile_march_transmittance_kernel, a, stream);
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
