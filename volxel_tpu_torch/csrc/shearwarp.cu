// Shear-warp DVR intermediate image: every slice of a permuted (Z, Y, X)
// bf16 volume classified through the transfer LUT, placed by its shear
// (bilinear, 4 taps) and composited front to back.
//
// Replaces the Pallas kernel volxel_tpu/render/shearwarp.py: _sw_kernel,
// behind both shearwarp_intermediate_pallas (static canvas, call :332) and
// _shearwarp_intermediate_pallas_dyn (fixed canvas, call :475). Plain
// version: volxel_tpu_torch/render/shearwarp.py:
// shearwarp_intermediate_plain. The caller computes the canvas size and
// the six scalars (sx, sy, tx, ty, inv_maj, sigma_dt) by either canvas's
// rule; this kernel serves both.
//
// Not carried over: the TPU grid runs one slice per step with the
// accumulators in VMEM, rolls a padded (8, 128)-aligned canvas by the
// slice's integer shift, and gathers the LUT 128 lanes at a time. Here one
// thread owns one intermediate pixel (r, c) and loops over the slices, so
// its colour and transmittance stay in registers and one launch renders
// the image. There is no early out: the JAX kernel skips the remaining
// slices once max(t) <= 1e-4 over the canvas, but the canvas's last row
// only ever receives taps weighted by fy = 0 (its slice sits at the clip's
// upper bound, an integer), so its t stays 1 and the test never passes.
//
// Per slice z, in the plain version's op order (the library is built with
// --fmad=false): uy = clamp(sy * z + ty, 0, out_h - y_n - 1), the same for
// ux; iy = floor(uy), fy = uy - iy; the taps (r-iy, c-ix), (r-iy-1, c-ix),
// (r-iy, c-ix-1), (r-iy-1, c-ix-1) with weights (1-fy)(1-fx), fy(1-fx),
// (1-fy)fx, fy fx, each product left to right and the four summed in that
// order. A tap inside the slice is classified (LUT row
// clamp(floor(v * inv_maj * k), 0, k-1), alpha = 1 - exp(-a * sigma_dt));
// a tap outside contributes rgb = 0 and alpha = 0, not the class of 0,
// since the JAX kernel pads after classifying. Then c += (t * a_w) * rgb_w
// and t *= 1 - a_w. A pixel with no tap inside the slice is left alone:
// its update would add +0 and multiply by 1.
//
// What bounds it on an H100: at 512^3 on the 1024^2 fixed canvas the
// volume is 268 MB of bf16 read once (0.08 ms at 3.35 TB/s) and the output
// 16.8 MB. This plain design reads each voxel through L1 four times (once
// per neighbouring pixel that taps it) and classifies it four times, exp
// included; a warp's 32 pixels are neighbours in a row, so their taps are
// coalesced 2-byte loads. Tiling slices through shared memory and
// classifying each voxel once are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

struct Tap {
  float r, g, b, a;
};

__device__ __forceinline__ Tap classify(const uint16_t* __restrict__ slice, int x_n, int y, int x,
                                        const float4* lut, int k, float inv_maj, float sigma_dt) {
  // bf16 -> f32 is exact: the bf16 bits are the f32's top half
  const float v = __uint_as_float(static_cast<uint32_t>(__ldg(slice + static_cast<int64_t>(y) * x_n + x)) << 16);
  long long j = static_cast<long long>(floorf(v * inv_maj * static_cast<float>(k)));
  j = j < 0 ? 0 : (j > k - 1 ? k - 1 : j);
  const float4 e = lut[j];
  return Tap{e.x, e.y, e.z, 1.0f - expf(-e.w * sigma_dt)};
}

__global__ void __launch_bounds__(kBlockX * kBlockY) shearwarp_kernel(
    const uint16_t* __restrict__ vol, int z_n, int y_n, int x_n, const float4* __restrict__ lut_g, int k,
    const float* __restrict__ params, int out_h, int out_w, float* __restrict__ c_out,
    float* __restrict__ t_out) {
  extern __shared__ float4 lut[];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int j = tid; j < k; j += blockDim.x * blockDim.y) lut[j] = lut_g[j];
  __syncthreads();

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= out_h || c >= out_w) return;
  const float sx = params[0], sy = params[1], tx = params[2], ty = params[3];
  const float inv_maj = params[4], sigma_dt = params[5];
  const float hi_y = static_cast<float>(out_h - y_n - 1);
  const float hi_x = static_cast<float>(out_w - x_n - 1);
  const Tap zero{0.0f, 0.0f, 0.0f, 0.0f};

  float cr = 0.0f, cg = 0.0f, cb = 0.0f, t = 1.0f;
  for (int z = 0; z < z_n; ++z) {
    const float zf = static_cast<float>(z);
    const float uy = fminf(fmaxf(sy * zf + ty, 0.0f), hi_y);
    const float ux = fminf(fmaxf(sx * zf + tx, 0.0f), hi_x);
    const int iy = static_cast<int>(floorf(uy));
    const int ix = static_cast<int>(floorf(ux));
    const int y0 = r - iy;  // tap rows y0 (weight 1-fy) and y0-1 (fy)
    const int x0 = c - ix;  // tap cols x0 (weight 1-fx) and x0-1 (fx)
    if (y0 < 0 || y0 > y_n || x0 < 0 || x0 > x_n) continue;
    const float fy = uy - static_cast<float>(iy);
    const float fx = ux - static_cast<float>(ix);
    const float wy = 1.0f - fy;
    const float wx = 1.0f - fx;
    const uint16_t* slice = vol + static_cast<int64_t>(z) * y_n * x_n;
    const bool in_y0 = y0 < y_n, in_y1 = y0 >= 1, in_x0 = x0 < x_n, in_x1 = x0 >= 1;
    const Tap p00 = (in_y0 && in_x0) ? classify(slice, x_n, y0, x0, lut, k, inv_maj, sigma_dt) : zero;
    const Tap p10 = (in_y1 && in_x0) ? classify(slice, x_n, y0 - 1, x0, lut, k, inv_maj, sigma_dt) : zero;
    const Tap p01 = (in_y0 && in_x1) ? classify(slice, x_n, y0, x0 - 1, lut, k, inv_maj, sigma_dt) : zero;
    const Tap p11 = (in_y1 && in_x1) ? classify(slice, x_n, y0 - 1, x0 - 1, lut, k, inv_maj, sigma_dt) : zero;
#define VX_BILERP(ch) (((p00.ch * wy) * wx + (p10.ch * fy) * wx) + (p01.ch * wy) * fx) + (p11.ch * fy) * fx
    const float a_w = VX_BILERP(a);
    const float r_w = VX_BILERP(r);
    const float g_w = VX_BILERP(g);
    const float b_w = VX_BILERP(b);
#undef VX_BILERP
    const float ta = t * a_w;
    cr = cr + ta * r_w;
    cg = cg + ta * g_w;
    cb = cb + ta * b_w;
    t = t * (1.0f - a_w);
  }
  const int64_t p = static_cast<int64_t>(r) * out_w + c;
  c_out[3 * p] = cr;
  c_out[3 * p + 1] = cg;
  c_out[3 * p + 2] = cb;
  t_out[p] = t;
}

}  // namespace

extern "C" int vx_shearwarp_intermediate(const uint16_t* vol, int z_n, int y_n, int x_n, const float* lut,
                                         int k, const float* params, int out_h, int out_w, float* c_out,
                                         float* t_out, cudaStream_t stream) {
  if (out_h > 0 && out_w > 0) {
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid((out_w + kBlockX - 1) / kBlockX, (out_h + kBlockY - 1) / kBlockY);
    const size_t shared = static_cast<size_t>(k) * sizeof(float4);
    shearwarp_kernel<<<grid, block, shared, stream>>>(vol, z_n, y_n, x_n, reinterpret_cast<const float4*>(lut),
                                                      k, params, out_h, out_w, c_out, t_out);
  }
  return static_cast<int>(cudaGetLastError());
}
