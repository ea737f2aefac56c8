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
// slice's integer shift, and gathers the LUT 128 lanes at a time. There is
// no early out: the JAX kernel skips the remaining slices once
// max(t) <= 1e-4 over the canvas, but the canvas's last row only ever
// receives taps weighted by fy = 0 (its slice sits at the clip's upper
// bound, an integer), so its t stays 1 and the test never passes.
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
// and t *= 1 - a_w.
//
// Design. A warp owns a tile of the intermediate image 31 pixels wide and
// 6 tall; each lane owns the 6 pixels of one column, with their colour and
// transmittance in registers. Warps share nothing but the LUT, so the slice
// loop has no block barrier: each warp runs at its own pace and the SM
// hides one warp's waits behind the others' work.
//   - Before the slice loop the warp finds the slices whose
//     (y_n + 1) x (x_n + 1) footprint reaches its tile. The shift is
//     monotone in z, so they form one range [z_lo, z_hi], and the warp
//     loops over that range alone (warp-uniform; on the 1024^2 fixed
//     canvas of 512^3 this drops ~3/4 of the pixel-slice pairs). Each slice
//     of the range is tested again, so nothing rests on the monotonicity.
//   - The per-slice scalars (iy, ix, fy, fx, 1-fy, 1-fx) are computed once
//     per warp, 32 slices at a time (one per lane), into a ring of 64 in
//     shared memory that every lane reads.
//   - For each slice the warp copies the 7 x 32 bf16 patch its taps read
//     from the slice into shared memory with 16-byte cp.async, three
//     buffers deep: the next two slices' patches are in flight while this
//     one is classified and composited. A patch row starts at any bf16
//     column, so each row is copied as the aligned 16-byte chunks that
//     cover it, at most five.
//   - Lane l classifies the patch's column l once per slice, row by row,
//     through a LUT that holds alpha' = 1 - exp(-a * sigma_dt) in place of
//     a (one exp per LUT row per block, not one per voxel). A cell outside
//     the slice is (0, 0, 0, 0). The right-hand tap of a pixel is column
//     l + 1, which lane l + 1 classified: a shuffle brings it over, so each
//     voxel of the patch is classified once and the classified patch does
//     not go through shared memory. Lane 31 only classifies; its pixel
//     belongs to the next warp's tile, which is why a tile is 31 wide.
//   - Walking down its column, a lane keeps the row it shares with the next
//     pixel in registers.
//   - Opaque tiles. Once every pixel of the warp's tile has t = +-0 (and
//     every class is finite), its colour can no longer change: t * a_w is
//     +-0, so c + (+-0 * rgb_w) is c. Only the sign of t can still flip,
//     where a blended alpha rounds above 1, so from then on the warp blends
//     the alpha channel alone, in the same order (a float LUT of alpha',
//     one shuffle per cell, no colour). Tested after every slice. At the
//     Renderer's density most voxels with any opacity stop a ray within a
//     few slices, so tiles over matter turn opaque early: on an NVIDIA H100
//     80GB HBM3 at 700 W, K7 at the bench view takes 0.97 ms where no tile
//     turns opaque, 0.78 ms on the Renderer's default transfer and 0.61 ms
//     on the bench's (chip_smoke.py, phase 3).
// Why the zero cells are exact: a pixel whose taps all miss the slice, and
// that the one-thread-per-pixel form skipped, now reads four zero cells.
// Every weight is >= 0, so each product and the blended alpha and colour
// are +0; c starts at +0 and adding +0 to a float that is not -0 leaves it
// unchanged, and c never becomes -0 (+0 + -0 is +0); t * (1 - (+0)) is t
// exactly. So while t stays finite (alpha in [0, 1], as any LUT with
// a >= 0 and sigma_dt >= 0 gives), the result is bit-equal to skipping.
//
// Tile size: 6 rows keep a lane at ~80 registers (24 of them the pixels'
// colour and transmittance) while the halo costs 7/6 * 32/31 = 1.2
// classifications per voxel-footprint pixel (4 in the one-thread-per-pixel
// form). A block is 4 warps stacked into a 31 x 24 tile: 1462 blocks on the
// 1024^2 canvas, 6 blocks per SM by registers, so ~1.8 waves of blocks whose
// work varies with how many slices reach them; the warps of a block finish
// independently. Of the forms tried on an NVIDIA H100 80GB HBM3 at 700 W
// (4, 5, 6, 8 and 16 rows; a 32 x 16 block tile whose 128 threads classify
// into a float4 patch in shared memory between two barriers per slice),
// 6 rows in warp tiles was the fastest on the bench scene and about as
// fast as the best on a translucent one.
//
// What bounds it on an H100: at 512^3 on the 1024^2 fixed canvas the
// volume is 268 MB of bf16 read once (0.08 ms at 3.35 TB/s). The work the
// function needs is each voxel's LUT index, one exp per LUT row, the 4-tap
// composite (~37 f32 operations) of each footprint pixel and slice while
// its t is not +-0, and the alpha blend alone after: ~5.7 Gop (0.085 ms at
// 67 TFLOP/s) where no pixel turns opaque, ~1.9 Gop on the bench scene, so
// the bytes set the bound. Bit-equality forbids the fused multiply-add, so
// the 4-tap blend and the composite are ~53 separate f32 instructions per
// pixel and slice, and the kernel is held back by the instructions it
// issues: those, the classification (~20 per voxel), the shuffles and the
// copies' index work, about 3.5 warp instructions per pixel and slice in
// all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpW = 31;  // pixel columns of a warp's tile (lane 31 only classifies)
constexpr int kWarpH = 6;   // pixel rows of a warp's tile, one column per lane
constexpr int kWarps = 4;   // warps of a block, their tiles stacked vertically
constexpr int kThreads = 32 * kWarps;
constexpr int kPatchH = kWarpH + 1;
// a raw patch row: 32 bf16 from any column, copied as 16-byte chunks
constexpr int kRowChunks = 5;
constexpr int kRawRow = kRowChunks * 8;
constexpr int kRawCells = kPatchH * kRawRow;
// raw patch buffers of a warp: the copies of the next kStages - 1 slices
// are in flight while one slice is classified and composited
constexpr int kStages = 3;
// the per-slice scalars of a warp: a ring of 64, refilled 32 at a time
constexpr int kRing = 64;
// the raw buffers come first in shared memory, then the LUT's float4 rows
static_assert(kWarps * kStages * kRawCells * sizeof(uint16_t) % sizeof(float4) == 0, "LUT alignment");

struct SliceShift {
  int iy, ix;
  float fy, fx, wy, wx;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most kStages - 1 groups of this thread's copies are
// pending: those of the slices after the current one
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// the slice's clamped shift, as the plain version's slice_shifts computes it
__device__ __forceinline__ SliceShift slice_shift(int z, const float* p, float hi_y, float hi_x) {
  const float zf = static_cast<float>(z);
  const float uy = fminf(fmaxf(p[1] * zf + p[3], 0.0f), hi_y);
  const float ux = fminf(fmaxf(p[0] * zf + p[2], 0.0f), hi_x);
  SliceShift s;
  s.iy = static_cast<int>(floorf(uy));
  s.ix = static_cast<int>(floorf(ux));
  s.fy = uy - static_cast<float>(s.iy);
  s.fx = ux - static_cast<float>(s.ix);
  s.wy = 1.0f - s.fy;
  s.wx = 1.0f - s.fx;
  return s;
}

// does the footprint [iy, iy + y_n] x [ix, ix + x_n] reach the tile?
__device__ __forceinline__ bool reaches(const SliceShift& s, int y_n, int x_n, int r0, int c0) {
  return s.iy <= r0 + kWarpH - 1 && s.iy + y_n >= r0 && s.ix <= c0 + kWarpW - 1 && s.ix + x_n >= c0;
}

// Start the copy of slice z's patch: rows vy0 .. vy0 + 8 and columns
// vx0 .. vx0 + 31 of the slice, where they lie inside it. Row pr's valid
// columns [a, b] are copied as the 16-byte chunks that hold them; the
// chunk holding element (row + a) starts `mis` elements before it, where
// mis = (m0 + row + a) mod 8 and m0 is the volume pointer's own offset
// from 16 bytes in elements. A chunk that reaches past the volume's first
// or last element stays inside the 16 bytes around a valid one.
__device__ __forceinline__ void stage_patch(const uint16_t* __restrict__ vol, int m0, int z, int y_n, int x_n,
                                            int vy0, int vx0, int lane, uint16_t* raw) {
  const int a = max(vx0, 0);
  const int b = min(vx0 + 31, x_n - 1);
  if (a > b) return;
  for (int task = lane; task < kPatchH * kRowChunks; task += 32) {
    const int pr = task / kRowChunks;
    const int q = task - pr * kRowChunks;
    const int vy = vy0 + pr;
    if (vy < 0 || vy >= y_n) continue;
    const long long row = (static_cast<long long>(z) * y_n + vy) * x_n;
    const long long first = ((m0 + row + a) & ~7LL) - m0;
    const long long last = ((m0 + row + b) & ~7LL) - m0;
    const long long chunk = first + 8LL * q;
    if (chunk <= last) cp_async16(raw + pr * kRawRow + 8 * q, vol + chunk);
  }
}

__device__ __forceinline__ float4 shfl_down1(const float4 v) {
  return make_float4(__shfl_down_sync(0xffffffffu, v.x, 1), __shfl_down_sync(0xffffffffu, v.y, 1),
                     __shfl_down_sync(0xffffffffu, v.z, 1), __shfl_down_sync(0xffffffffu, v.w, 1));
}

__global__ void __launch_bounds__(kThreads) shearwarp_kernel(
    const uint16_t* __restrict__ vol, int z_n, int y_n, int x_n, const float4* __restrict__ lut_g, int k,
    const float* __restrict__ params, int out_h, int out_w, float* __restrict__ c_out,
    float* __restrict__ t_out) {
  extern __shared__ float4 smem[];
  __shared__ SliceShift rings[kWarps][kRing];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint16_t* raw = reinterpret_cast<uint16_t*>(smem) + warp * kStages * kRawCells;
  float4* lut = smem + kWarps * kStages * kRawCells * sizeof(uint16_t) / sizeof(float4);
  float* lut_alpha = reinterpret_cast<float*>(lut + k);
  SliceShift* ring = rings[warp];
  const int r0 = (blockIdx.y * kWarps + warp) * kWarpH;
  const int c0 = blockIdx.x * kWarpW;
  float p[6];
  for (int i = 0; i < 6; ++i) p[i] = params[i];
  const float inv_maj = p[4], sigma_dt = p[5];
  const float kf = static_cast<float>(k);  // exact: k <= 3072
  const float hi_y = static_cast<float>(out_h - y_n - 1);
  const float hi_x = static_cast<float>(out_w - x_n - 1);
  const int m0 = static_cast<int>((reinterpret_cast<uintptr_t>(vol) >> 1) & 7);

  // the LUT with alpha' = 1 - exp(-a * sigma_dt) in place of a: a voxel's
  // class is a function of its row, so each row's exp is taken once
  bool finite = true;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    float4 e = lut_g[j];
    e.w = 1.0f - expf(-e.w * sigma_dt);
    finite = finite && isfinite(e.x) && isfinite(e.y) && isfinite(e.z) && isfinite(e.w);
    lut[j] = e;
    lut_alpha[j] = e.w;
  }
  // with every class finite, a pixel whose t is +-0 keeps its colour
  const bool may_freeze = __syncthreads_and(finite);

  // the slices that reach the warp's tile
  int z_lo = z_n, z_hi = -1;
  for (int z = lane; z < z_n; z += 32) {
    if (reaches(slice_shift(z, p, hi_y, hi_x), y_n, x_n, r0, c0)) {
      z_lo = min(z_lo, z);
      z_hi = max(z_hi, z);
    }
  }
  z_lo = __reduce_min_sync(0xffffffffu, z_lo);
  z_hi = __reduce_max_sync(0xffffffffu, z_hi);

  float cr[kWarpH], cg[kWarpH], cb[kWarpH], t[kWarpH];
#pragma unroll
  for (int i = 0; i < kWarpH; ++i) {
    cr[i] = 0.0f;
    cg[i] = 0.0f;
    cb[i] = 0.0f;
    t[i] = 1.0f;
  }

  bool opaque = false;  // warp-uniform: every pixel of the tile has t = +-0
  if (z_lo <= z_hi) {  // warp-uniform
    ring[lane] = slice_shift(z_lo + lane, p, hi_y, hi_x);
    ring[32 + lane] = slice_shift(z_lo + 32 + lane, p, hi_y, hi_x);
    __syncwarp();
    for (int j = 0; j < kStages - 1; ++j) {
      if (z_lo + j <= z_hi) {
        const SliceShift& s = ring[j];
        stage_patch(vol, m0, z_lo + j, y_n, x_n, r0 - s.iy - 1, c0 - s.ix - 1, lane, raw + j * kRawCells);
      }
      cp_async_commit();
    }
    for (int z = z_lo; z <= z_hi; ++z) {
      const int j = z - z_lo;
      // every lane is done with the buffer and the ring entries rewritten below
      __syncwarp();
      if (j > 0 && (j & 31) == 0) {
        // the half of the ring that held slices z-32 .. z-1 takes z+32 .. z+63
        ring[(j + 32 + lane) & (kRing - 1)] = slice_shift(z + 32 + lane, p, hi_y, hi_x);
        __syncwarp();
      }
      const int ahead = j + kStages - 1;
      if (z_lo + ahead <= z_hi) {
        const SliceShift& s = ring[ahead & (kRing - 1)];
        stage_patch(vol, m0, z_lo + ahead, y_n, x_n, r0 - s.iy - 1, c0 - s.ix - 1, lane,
                    raw + (ahead % kStages) * kRawCells);
      }
      cp_async_commit();
      cp_async_wait_stage();
      __syncwarp();  // every lane's copies of slice z have landed
      const SliceShift s = ring[j & (kRing - 1)];
      if (!reaches(s, y_n, x_n, r0, c0)) continue;  // warp-uniform
      const int vy0 = r0 - s.iy - 1;
      const int vx = c0 - s.ix - 1 + lane;  // the patch column this lane classifies
      const int a = max(c0 - s.ix - 1, 0);
      const bool in_x = vx >= 0 && vx < x_n;
      auto inside = [&](int pr) { return in_x && vy0 + pr >= 0 && vy0 + pr < y_n; };
      const uint16_t* buf = raw + (j % kStages) * kRawCells;
      const unsigned plane = static_cast<unsigned>(z) * static_cast<unsigned>(y_n);
      // The LUT row of cell (pr, lane) of the patch. Branch-free, so the
      // rows' loads overlap: a cell outside the slice reads buf[0] and
      // row 0, and the caller replaces its class by 0.
      auto lut_row = [&](int pr) {
        const int vy = vy0 + pr;
        const unsigned row = (plane + static_cast<unsigned>(vy)) * static_cast<unsigned>(x_n);
        const int mis = static_cast<int>((m0 + row + a) & 7u);
        const int at = inside(pr) ? pr * kRawRow + mis + vx - a : 0;
        // bf16 -> f32 is exact: the bf16 bits are the f32's top half
        const float v = __uint_as_float(static_cast<uint32_t>(buf[at]) << 16);
        // clamp(floor(x), 0, k-1) in f32 picks the row the int64 clamp of
        // the plain version picks, NaN included (both give row 0)
        return static_cast<int>(fminf(fmaxf(floorf(v * inv_maj * kf), 0.0f), kf - 1.0f));
      };
      // cell (pr, lane) of the patch: classified, or 0 outside the slice
      auto cell = [&](int pr) {
        const float4 e = lut[lut_row(pr)];
        return inside(pr) ? e : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      };
      const float fy = s.fy, fx = s.fx, wy = s.wy, wx = s.wx;
#define VX_BILERP(ch) \
  (((dn_r.ch * wy) * wx + (up_r.ch * fy) * wx) + (dn_l.ch * wy) * fx) + (up_l.ch * fy) * fx
      if (!opaque) {
        // pixel row i taps cells (i + 1, l + 1) = p00, (i, l + 1) = p10,
        // (i + 1, l) = p01 and (i, l) = p11
        float4 up_l = cell(0);
        float4 up_r = shfl_down1(up_l);
#pragma unroll
        for (int i = 0; i < kWarpH; ++i) {
          const float4 dn_l = cell(i + 1);
          const float4 dn_r = shfl_down1(dn_l);
          const float a_w = VX_BILERP(w);
          const float r_w = VX_BILERP(x);
          const float g_w = VX_BILERP(y);
          const float b_w = VX_BILERP(z);
          const float ta = t[i] * a_w;
          cr[i] = cr[i] + ta * r_w;
          cg[i] = cg[i] + ta * g_w;
          cb[i] = cb[i] + ta * b_w;
          t[i] = t[i] * (1.0f - a_w);
          up_l = dn_l;
          up_r = dn_r;
        }
        if (may_freeze) {
          bool zero = true;
#pragma unroll
          for (int i = 0; i < kWarpH; ++i) zero = zero && (t[i] == 0.0f || r0 + i >= out_h);
          // lane 31's pixel and pixels off the canvas are never written
          opaque = __all_sync(0xffffffffu, zero || lane >= kWarpW || c0 + lane >= out_w);
        }
      } else {
        // Every pixel has t = +-0 and every class is finite, so t * a_w is
        // +-0, c + (+-0 * rgb_w) is c (c is never -0), and t stays +-0:
        // only its sign can still change, where a blended alpha rounds
        // above 1. So the alpha channel alone is blended, in the same order.
        auto alpha = [&](int pr) {
          const float e = lut_alpha[lut_row(pr)];
          return inside(pr) ? e : 0.0f;
        };
        float up_l = alpha(0);
        float up_r = __shfl_down_sync(0xffffffffu, up_l, 1);
#pragma unroll
        for (int i = 0; i < kWarpH; ++i) {
          const float dn_l = alpha(i + 1);
          const float dn_r = __shfl_down_sync(0xffffffffu, dn_l, 1);
          const float a_w = (((dn_r * wy) * wx + (up_r * fy) * wx) + (dn_l * wy) * fx) + (up_l * fy) * fx;
          t[i] = t[i] * (1.0f - a_w);
          up_l = dn_l;
          up_r = dn_r;
        }
      }
#undef VX_BILERP
    }
  }

  const int c = c0 + lane;
  if (lane < kWarpW && c < out_w) {
#pragma unroll
    for (int i = 0; i < kWarpH; ++i) {
      const int r = r0 + i;
      if (r < out_h) {
        const int64_t q = static_cast<int64_t>(r) * out_w + c;
        c_out[3 * q] = cr[i];
        c_out[3 * q + 1] = cg[i];
        c_out[3 * q + 2] = cb[i];
        t_out[q] = t[i];
      }
    }
  }
}

}  // namespace

extern "C" int vx_shearwarp_intermediate(const uint16_t* vol, int z_n, int y_n, int x_n, const float* lut,
                                         int k, const float* params, int out_h, int out_w, float* c_out,
                                         float* t_out, cudaStream_t stream) {
  if (out_h <= 0 || out_w <= 0) return static_cast<int>(cudaGetLastError());
  const size_t shared = kWarps * kStages * kRawCells * sizeof(uint16_t) + static_cast<size_t>(k) * (sizeof(float4) + sizeof(float));
  if (shared > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(shearwarp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((out_w + kWarpW - 1) / kWarpW, (out_h + kWarps * kWarpH - 1) / (kWarps * kWarpH));
  shearwarp_kernel<<<grid, kThreads, shared, stream>>>(vol, z_n, y_n, x_n, reinterpret_cast<const float4*>(lut), k,
                                                       params, out_h, out_w, c_out, t_out);
  return static_cast<int>(cudaGetLastError());
}
