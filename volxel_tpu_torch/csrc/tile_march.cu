// Raymarch camera-leg step loop, and nearest-tap density sums.
//
// Replaces the Pallas kernels of volxel_tpu/render/tilemarch.py:
// tile_march_sample (call :670, kernel from _sample_kernel_factory) and
// tile_march_sums (call :330, _sums_kernel_factory). Plain versions:
// volxel_tpu_torch/render/tilemarch.py: tile_march_sample_plain and
// tile_march_sums_plain.
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
// What bounds it on an H100: the latency of dependent gathers, not bytes.
// The bf16 dense field is 256 MiB at 512^3, so it does not stay in the
// 50 MB L2. A step's tap address depends on that step's draws and the
// next step's exit test on the tap, so a thread has one 2-byte load in
// flight at a time; a step is that load plus ~120 integer and f32 ops
// (nine xoshiro128++ draws, the cubic weights, the reservoir compares).
// Lanes come in pixel order, so a warp's 32 rays are neighbours on screen
// and their taps fall in nearby cache lines; many resident warps (128
// threads a block, no block-wide state but the LUT) hide the rest. Each
// thread leaves its loop at its hit, so a warp costs its slowest lane.
// The 128x4 f32 transfer LUT is staged in shared memory once per block.
//
// Every f32 operation follows the plain version's order and the library is
// built with --fmad=false, so outputs are bit-equal to it on the card; the
// constants 1/6 and 1e-3 are rounded to f32 once, as PyTorch rounds a
// Python scalar, and torch.minimum / clamp_min NaN propagation is kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

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

__global__ void __launch_bounds__(kThreads) tile_march_sample_kernel(
    const uint16_t* __restrict__ dense, int ny, int nx, int ex, int ey, int ez,
    const float* __restrict__ ipos, const float* __restrict__ idir, const float* __restrict__ start_in,
    const float* __restrict__ dt_in, const float* __restrict__ far_in, const bool* __restrict__ valid,
    const float* __restrict__ tau_target_in, const int64_t* __restrict__ state_in,
    const float* __restrict__ lut, int lut_k, const float* __restrict__ scalars,
    int64_t* __restrict__ state_out, bool* __restrict__ hit_out, float* __restrict__ t_out,
    float* __restrict__ rgb_out, int n, int steps) {
  extern __shared__ float s_lut[];  // lut_k x 4
  for (int j = threadIdx.x; j < 4 * lut_k; j += blockDim.x) s_lut[j] = lut[j];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t s[4];
  for (int j = 0; j < 4; ++j) s[j] = static_cast<uint32_t>(state_in[4 * i + j]);
  bool hit = false;
  float t_hit = 0.0f;
  float rgb[3] = {1.0f, 1.0f, 1.0f};

  if (valid[i]) {
    const float inv_maj = __ldg(scalars + 0);
    const float vol_maj = __ldg(scalars + 1);
    const float density_scale = __ldg(scalars + 2);
    const float range_lo = __ldg(scalars + 3);
    const float range_hi = __ldg(scalars + 4);
    const float px = ipos[3 * i], py = ipos[3 * i + 1], pz = ipos[3 * i + 2];
    const float dx = idir[3 * i], dy = idir[3 * i + 1], dz = idir[3 * i + 2];
    const float start = start_in[i], dt = dt_in[i], far = far_in[i];
    const float tau_target = tau_target_in[i];
    float tau = 0.0f;
    for (int k = 0; k < steps; ++k) {
      const float t = min_nan(start + static_cast<float>(k) * dt, far);
      // stochastic_tricubic_offsets: p = pos - 0.5, a reservoir over taps
      // 1..3 per axis with one rng3 draw (x, y, z) per tap
      const float p[3] = {(px + t * dx) - 0.5f, (py + t * dy) - 0.5f, (pz + t * dz) - 0.5f};
      int base[3];
      float w[3][4];
      float sum_w[3];
      int pick[3] = {0, 0, 0};
      for (int a = 0; a < 3; ++a) {
        base[a] = static_cast<int>(floorf(p[a]));
        cubic_weights(p[a] - static_cast<float>(base[a]), w[a]);
        sum_w[a] = w[a][0];
      }
      for (int tap = 1; tap <= 3; ++tap) {
        for (int a = 0; a < 3; ++a) sum_w[a] = sum_w[a] + w[a][tap];
        for (int a = 0; a < 3; ++a) {
          const float r = next_float(s);
          if (r < w[a][tap] / max_nan(sum_w[a], static_cast<float>(1e-3))) pick[a] = tap;
        }
      }
      const int x = base[0] + pick[0] - 1, y = base[1] + pick[1] - 1, z = base[2] + pick[2] - 1;
      const float voxel = inside(x, y, z, ex, ey, ez) ? dense_tap(dense, ny, nx, x, y, z) : 0.0f;
      const float dens = (density_scale * voxel) * inv_maj;
      // lookup_transfer: NEAREST with range rejection (common.glsl:78-83)
      const bool rejected = dens < range_lo || dens > range_hi;
      long long li = static_cast<long long>(floorf(dens * static_cast<float>(lut_k)));
      li = li < 0 ? 0 : (li > lut_k - 1 ? lut_k - 1 : li);
      const float alpha = rejected ? 0.0f : s_lut[4 * li + 3];
      const float tau_new = tau + (alpha * vol_maj) * dt;
      tau = tau_new;
      if (tau_new >= tau_target) {
        hit = true;
        t_hit = t;
        for (int c = 0; c < 3; ++c) rgb[c] = rejected ? 0.0f : s_lut[4 * li + c];
        break;
      }
    }
  }
  for (int j = 0; j < 4; ++j) state_out[4 * i + j] = static_cast<int64_t>(s[j]);
  hit_out[i] = hit;
  t_out[i] = t_hit;
  for (int c = 0; c < 3; ++c) rgb_out[3 * i + c] = rgb[c];
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

}  // namespace

extern "C" int vx_tile_march_sample(const uint16_t* dense, int ny, int nx, int ex, int ey, int ez,
                                    const float* ipos, const float* idir, const float* start,
                                    const float* dt, const float* far, const bool* valid,
                                    const float* tau_target, const int64_t* state, const float* lut,
                                    int lut_k, const float* scalars, int64_t* state_out, bool* hit_out,
                                    float* t_out, float* rgb_out, int n, int steps, cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    const size_t smem = sizeof(float) * 4 * static_cast<size_t>(lut_k);
    tile_march_sample_kernel<<<blocks, kThreads, smem, stream>>>(
        dense, ny, nx, ex, ey, ez, ipos, idir, start, dt, far, valid, tau_target, state, lut, lut_k,
        scalars, state_out, hit_out, t_out, rgb_out, n, steps);
  }
  return static_cast<int>(cudaGetLastError());
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
