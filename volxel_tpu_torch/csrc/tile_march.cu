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
// and their chain, not bytes. A step is nine xoshiro128++ draws, the cubic
// weights, nine reservoir compares (each an IEEE division), one 2-byte tap
// of the 256 MiB bf16 field (which does not stay in the 50 MB L2) whose
// address depends on the draws, and the LUT; waiting on the tap is ~2-8% of
// a loop's time (their issue-only twins, PERF.md section 6). A camera lane
// stops at its hit, a shadow lane takes every step. What bounds the sums:
// their taps' traffic through L2, not instructions (an issue-only twin
// takes a quarter of the time).
//
// Design (both loops): one thread per lane, 128 threads a block, and every
// lane writes all its outputs (a lane outside the box copies its words and
// writes the defaults). Lanes come in pixel order and a warp's rays take
// their steps together, so at each step their taps fall at about the same
// depth along neighbouring rays and share cache lines (warp efficiency 0.89
// and 0.92 at a 1080p raymarch sample). The f32 transfer LUT is staged in
// shared memory once per block. The loops share one step body (issue_tap,
// consume_tap): the cell located with __float2int_rd, the box tested with
// unsigned compares, the LUT row formed as a clamped float, all in 32 bits,
// the reservoir's divisor clamped by one max.NaN, and the tap indexed in 32
// bits where the extent allows (a 64-bit index otherwise). The camera loop
// issues and consumes each step in turn and leaves at its hit, so a warp
// costs its slowest lane. The shadow loop, with no early out, keeps the taps
// of the next two steps in flight while a step's tap is consumed, under
// __launch_bounds__(128, 1) so that ptxas issues them ahead of their uses.
//
// Designs measured on an H100 and left out (PERF.md, section 6). Camera
// loop: the taps of 1 or 2 later steps issued
// before a step's hit test, speculatively, each slot keeping the words
// before its draws (40-60 more instructions a step for the ~2% that memory
// takes); the reservoir's compares decided exactly in f64 without the
// division (more instructions, and the quarter-rate conversions);
// __launch_bounds__(128, 1); a grid of 6 or 8 blocks an SM walking the
// lanes; and, earlier, the state updated in place, a pool of persistent
// blocks refilled from an atomic counter (about 1.7 times the time), the
// compare decided against a reciprocal estimate, the division's fast path
// without its range check. Shadow loop: 1 or 4 taps ahead, each step
// consumed before its slot is refilled, two sets of slots in turns, 40 or
// 48 resident warps forced by the launch bounds, the LUT staged only by
// blocks with a lane inside the box or read from global memory, the inside
// lanes packed by a kernel on the card, the f64 compare. Sums: 4-32 steps'
// loads in flight on a grid of a block per 128 lanes (no faster: the taps
// of the many rays in flight thrash L2), grids of 1, 3, 4, 6 or 8 blocks
// an SM.
//
// Every f32 operation follows the plain version's order and the library is
// built with --fmad=false, so outputs are bit-equal to it on the card; the
// constants 1/6 and 1e-3 are rounded to f32 once, as PyTorch rounds a
// Python scalar, and torch.minimum's NaN propagation is kept (clamp_min's
// where it can show: divisor).
//
// Render-time volume slabs: vx_tile_march_*_slabs launch both step loops
// over z-slabs (Slabs: the slabs' pointer table), each step's tap read from
// the slab of the owner of its base cell's clamped z, as kernels of their
// own. The sums read the dense field only (they are on no render path).
//
// Park forms (a vz row across nodes, parallel/migrate.py):
// vx_tile_march_*_slabs_park launch both step loops over a table whose
// slabs on other nodes are null, from each lane's step index and tau. A lane
// parks before a step whose base cell's owner is absent, before that step's
// draws (Slabs::absent_owner), with its step index, tau and words as they
// are, and the same kernel resumes it from that step. The shadow loop issues
// the taps of later steps ahead, so its test goes where a step's tap is
// issued, and the steps before it are still consumed. They are the step
// loops' kPark instantiations, kernels of their own, so the dense and slab
// forms keep their code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// torch.minimum on the card: a NaN operand is returned as it is (its
// payload too)
__device__ __forceinline__ float min_nan(float a, float b) { return a != a ? a : (b != b ? b : fminf(a, b)); }

// the reservoir's divisor torch.clamp_min(sum_w, 1e-3) as one max.NaN: a NaN
// sum gives a NaN, though not always its own payload; the divisor only ever
// divides, and a NaN quotient's compare is false whatever its payload
__device__ __forceinline__ float divisor(float sum_w) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(sum_w), "f"(static_cast<float>(1e-3)));
  return d;
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

// Both step loops share one step body: issue_tap, step k's draws and its
// tap's load, and consume_tap, the LUT and tau. A step's tap address depends
// on its t and its draws, never on tau, so the taps of later steps can be in
// flight while a step's tap is consumed. The draws and the sums keep the
// plain order, so the words and tau are the same bits. kNarrow: a 32-bit tap
// index, for a field whose extent holds at most 2^31 elements (the launch
// picks it).

// a lane's ray and the volume's scalars
struct Lane {
  float o[3], d[3], start, dt, far;
  float inv_maj, vol_maj, density_scale, range_lo, range_hi, lut_k, lut_top;
};

__device__ __forceinline__ Lane load_lane(const March& a, int i) {
  const int64_t i3 = 3 * static_cast<int64_t>(i);
  return Lane{{a.ipos[i3], a.ipos[i3 + 1], a.ipos[i3 + 2]},
              {a.idir[i3], a.idir[i3 + 1], a.idir[i3 + 2]},
              a.start[i], a.dt[i], a.far[i],
              __ldg(a.scalars + 0), __ldg(a.scalars + 1), __ldg(a.scalars + 2), __ldg(a.scalars + 3),
              __ldg(a.scalars + 4), static_cast<float>(a.lut_k), static_cast<float>(a.lut_k - 1)};
}

__device__ __forceinline__ float step_t(const Lane& l, int k) { return min_nan(l.start + static_cast<float>(k) * l.dt, l.far); }

// the cell of a coordinate: __float2int_rd is the floor and the plain form's
// saturating int cast in one (NaN lands on 0)
__device__ __forceinline__ int cell_of(float p) { return __float2int_rd(p); }

// Where a step's tap is read: the dense field (Dense), or the z-slab of the
// owner of the clamped z of the reservoir's base cell (Slabs: the table of
// the slabs' pointers, each slab holding z slices [owner * slab -
// kSlabHalo, (owner + 1) * slab + kSlabHalo), which hold every tap the pick
// can reach, offsets -1..+2). `field` returns the array and sets `z0`, the
// global z of its first slice.
constexpr int kSlabHalo = 2;  // sampling.SLAB_HALO

struct Dense {
  __device__ __forceinline__ const uint16_t* field(const March& a, int, int& z0) const {
    z0 = 0;
    return a.dense;
  }
};

struct Slabs {
  const uint16_t* const* slabs;
  int slab;
  __device__ __forceinline__ const uint16_t* field(const March& a, int base_z, int& z0) const {
    const int owner = min(max(base_z, 0), a.ez - 1) / slab;
    z0 = owner * slab - kSlabHalo;
    return slabs[owner];
  }
  // the park forms' test: the owner of step k's base cell (located as
  // issue_tap locates it) where its slab is absent (a null pointer: another
  // node's), else -1
  __device__ __forceinline__ int absent_owner(const March& a, const Lane& l, int k) const {
    const float t = step_t(l, k);
    const int owner = min(max(cell_of((l.o[2] + t * l.d[2]) - 0.5f), 0), a.ez - 1) / slab;
    return slabs[owner] == nullptr ? owner : -1;
  }
};

// the park forms' per-lane inputs and outputs beside March
struct TileParks {
  const int* step_in;   // each lane's next step
  const float* tau_in;  // and its tau so far
  float* tau_out;       // the camera leg's tau (the shadow leg writes March's)
  int* step_out;        // a parked lane's step (the input step elsewhere)
  int* park_out;        // the absent slab a lane parked at (-1 elsewhere)
};

// a cell's tap bits (0 outside the extent: three unsigned compares), from
// `field` whose first slice is z0; kNarrow indexes the field in 32 bits
template <bool kNarrow>
__device__ __forceinline__ uint32_t tap_bits(const March& a, const uint16_t* field, int z0, int x, int y, int z) {
  uint32_t bits = 0;
  if (static_cast<unsigned>(x) < static_cast<unsigned>(a.ex) && static_cast<unsigned>(y) < static_cast<unsigned>(a.ey) &&
      static_cast<unsigned>(z) < static_cast<unsigned>(a.ez)) {
    if constexpr (kNarrow) {
      bits = __ldg(field + (static_cast<unsigned>(z - z0) * a.ny + y) * a.nx + x);
    } else {
      bits = __ldg(field + (static_cast<int64_t>(z - z0) * a.ny + y) * a.nx + x);
    }
  }
  return bits;
}

// step k's t, the reservoir's nine draws and its tap's load, issued
template <bool kNarrow, class Src>
__device__ __forceinline__ uint32_t issue_tap(const March& a, const Src& src, const Lane& l, int k, uint32_t (&s)[4]) {
  const float t = step_t(l, k);
  const float p[3] = {(l.o[0] + t * l.d[0]) - 0.5f, (l.o[1] + t * l.d[1]) - 0.5f, (l.o[2] + t * l.d[2]) - 0.5f};
  int base[3];
  float w[3][4];
  float sum_w[3];
  int pick[3] = {0, 0, 0};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    base[c] = cell_of(p[c]);
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
      if (r < w[c][tap] / divisor(sum_w[c])) pick[c] = tap;
    }
  }
  int z0;
  const uint16_t* field = src.field(a, base[2], z0);
  return tap_bits<kNarrow>(a, field, z0, base[0] + pick[0] - 1, base[1] + pick[1] - 1, base[2] + pick[2] - 1);
}

// a step's tap consumed: bf16 -> f32 (exact; +0 outside), the LUT's NEAREST
// row with range rejection (common.glsl:78-83) as floor(clamp(y, 0, K - 1))
// in 32 bits (fmaxf takes a NaN y to row 0, as the plain form's 64-bit cast
// and clamp do), then tau += (alpha * vol_maj) * dt. `row` and `out` (the
// density rejected) give the camera leg its colour at a hit.
__device__ __forceinline__ float consume_tap(const Lane& l, const float* __restrict__ s_lut, uint32_t bits,
                                             float tau, const float*& row, bool& out) {
  const float dens = (l.density_scale * __uint_as_float(bits << 16)) * l.inv_maj;
  out = dens < l.range_lo || dens > l.range_hi;
  row = s_lut + 4 * __float2int_rd(fminf(fmaxf(dens * l.lut_k, 0.0f), l.lut_top));
  return tau + ((out ? 0.0f : row[3]) * l.vol_maj) * l.dt;
}

// The camera leg's step loop: each lane stops at its first step with tau >=
// tau_target, so a step's tap is issued and consumed in turn (taps of later
// steps issued ahead of the hit test, with each slot's words kept, measured
// slower: PERF.md, section 6). kPark (the park forms, over Slabs): each
// lane starts from p's step and tau, and stops before a step of an absent
// slab, before that step's draws.
template <bool kNarrow, bool kPark, class Src>
__device__ __forceinline__ void march_camera(const March& a, const Src& src, const float* __restrict__ s_lut,
                                             const TileParks& p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int64_t i3 = 3 * static_cast<int64_t>(i), i4 = 4 * static_cast<int64_t>(i);
  uint32_t s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = static_cast<uint32_t>(a.state[i4 + j]);
  bool hit = false;
  float t_hit = 0.0f;
  float rgb[3] = {1.0f, 1.0f, 1.0f};
  float tau = 0.0f;
  int step = 0, parked = -1;
  if constexpr (kPark) {
    tau = p.tau_in[i];
    step = p.step_in[i];
  }
  if (a.valid[i]) {
    const Lane l = load_lane(a, i);
    const float tau_target = a.tau_target[i];
    int k_hit = -1;  // the step that hit, its LUT row and whether it was rejected
    const float* row_hit = s_lut;
    bool out_hit = false;
    for (int k = step; k < a.steps; ++k) {
      if constexpr (kPark) {
        parked = src.absent_owner(a, l, k);
        if (parked >= 0) {
          step = k;
          break;
        }
      }
      const float* row;
      bool out;
      tau = consume_tap(l, s_lut, issue_tap<kNarrow>(a, src, l, k, s), tau, row, out);
      if (tau >= tau_target) {
        k_hit = k;
        row_hit = row;
        out_hit = out;
        break;
      }
    }
    if (k_hit >= 0) {
      hit = true;
      t_hit = step_t(l, k_hit);
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = out_hit ? 0.0f : row_hit[c];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) a.state_out[i4 + j] = static_cast<int64_t>(s[j]);
  a.hit[i] = hit;
  a.t_out[i] = t_hit;
#pragma unroll
  for (int c = 0; c < 3; ++c) a.rgb_out[i3 + c] = rgb[c];
  if constexpr (kPark) {
    p.tau_out[i] = tau;
    p.step_out[i] = step;
    p.park_out[i] = parked;
  }
}

// The shadow leg's step loop: every lane inside the box takes all `steps`
// steps, with nothing speculated. At step k the draws and the tap of step k
// + kShadowAhead are issued, then step k's tap is consumed. kPark: each lane
// starts from p's step and tau; a step's tap is issued unless the lane
// stops before it, and a step of an absent slab stops it there (the steps
// issued before it are still consumed).
constexpr int kShadowAhead = 2;

// the shadow loop's issue of step k's tap; kPark: unless step k's base
// cell's slab is absent, where the lane stops (stop, parked) with no draws
template <bool kNarrow, bool kPark, class Src>
__device__ __forceinline__ uint32_t issue_step(const March& a, const Src& src, const Lane& l, int k, uint32_t (&s)[4],
                                               int& stop, int& parked) {
  if constexpr (kPark) {
    const int owner = src.absent_owner(a, l, k);
    if (owner >= 0) {
      stop = k;
      parked = owner;
      return 0u;
    }
  }
  return issue_tap<kNarrow>(a, src, l, k, s);
}

template <bool kNarrow, bool kPark, class Src>
__device__ __forceinline__ void march_shadow(const March& a, const Src& src, const float* __restrict__ s_lut,
                                             const TileParks& p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int64_t i4 = 4 * static_cast<int64_t>(i);
  uint32_t s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = static_cast<uint32_t>(a.state[i4 + j]);
  float tau = 0.0f;
  int step = 0, parked = -1;
  if constexpr (kPark) {
    tau = p.tau_in[i];
    step = p.step_in[i];
  }
  if (a.valid[i]) {
    const Lane l = load_lane(a, i);
    int stop = a.steps;  // kPark: the step the lane parks at
    const int& end = kPark ? stop : a.steps;  // a.steps itself elsewhere, so those forms keep their code
    uint32_t ring[kShadowAhead];
    const float* row;
    bool out;
#pragma unroll
    for (int j = 0; j < kShadowAhead; ++j) {
      ring[j] = step + j < end ? issue_step<kNarrow, kPark>(a, src, l, step + j, s, stop, parked) : 0u;
    }
    for (int k = step; k < end; k += kShadowAhead) {
#pragma unroll
      for (int j = 0; j < kShadowAhead; ++j) {
        const uint32_t bits = ring[j];
        if (k + j + kShadowAhead < end) {
          ring[j] = issue_step<kNarrow, kPark>(a, src, l, k + j + kShadowAhead, s, stop, parked);
        }
        if (k + j < end) tau = consume_tap(l, s_lut, bits, tau, row, out);
      }
    }
    if (parked >= 0) step = stop;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) a.state_out[i4 + j] = static_cast<int64_t>(s[j]);
  a.tau_out[i] = tau;
  if constexpr (kPark) {
    p.step_out[i] = step;
    p.park_out[i] = parked;
  }
}

__device__ __forceinline__ const float* stage_lut(const March& a, float* s_lut) {
  for (int j = threadIdx.x; j < 4 * a.lut_k; j += blockDim.x) s_lut[j] = a.lut[j];
  __syncthreads();
  return s_lut;
}

template <bool kNarrow>
__global__ void __launch_bounds__(kThreads) tile_march_sample_kernel(March a) {
  extern __shared__ float s_lut[];  // lut_k x 4
  march_camera<kNarrow, false>(a, Dense{}, stage_lut(a, s_lut), TileParks{});
}

// the same over z-slabs
template <bool kNarrow>
__global__ void __launch_bounds__(kThreads) tile_march_sample_slabs_kernel(March a, Slabs src) {
  extern __shared__ float s_lut[];  // lut_k x 4
  march_camera<kNarrow, false>(a, src, stage_lut(a, s_lut), TileParks{});
}

// one block an SM named, so that ptxas keeps the taps' loads ahead of
// their uses (it may take the registers for it)
template <bool kNarrow>
__global__ void __launch_bounds__(kThreads, 1) tile_march_transmittance_kernel(March a) {
  extern __shared__ float s_lut[];  // lut_k x 4
  march_shadow<kNarrow, false>(a, Dense{}, stage_lut(a, s_lut), TileParks{});
}

// the same over z-slabs
template <bool kNarrow>
__global__ void __launch_bounds__(kThreads, 1) tile_march_transmittance_slabs_kernel(March a, Slabs src) {
  extern __shared__ float s_lut[];  // lut_k x 4
  march_shadow<kNarrow, false>(a, src, stage_lut(a, s_lut), TileParks{});
}

// the park forms
template <bool kNarrow>
__global__ void __launch_bounds__(kThreads) tile_march_sample_park_kernel(March a, Slabs src, TileParks p) {
  extern __shared__ float s_lut[];  // lut_k x 4
  march_camera<kNarrow, true>(a, src, stage_lut(a, s_lut), p);
}

template <bool kNarrow>
__global__ void __launch_bounds__(kThreads, 1) tile_march_transmittance_park_kernel(March a, Slabs src,
                                                                                   TileParks p) {
  extern __shared__ float s_lut[];  // lut_k x 4
  march_shadow<kNarrow, true>(a, src, stage_lut(a, s_lut), p);
}

// tile_march_sums. A lane's steps lie a 64th of its box chord apart, so its
// taps share no cache line; the taps of rays of neighbouring pixels, in
// this and the next image rows, do. So a grid of kSumsBlocksPerSM blocks an
// SM walks the lanes at the grid's stride: the lanes in flight at once are
// a strip of a few image rows, whose lines the next strip finds in L2. A
// lane issues the loads of kSumsChunk steps before it adds any of them, in
// the plain order; a last guarded chunk takes a `steps` that is not a
// multiple of kSumsChunk (0 included).
constexpr int kSumsChunk = 16;
constexpr int kSumsBlocksPerSM = 2;

template <bool kNarrow>
__device__ __forceinline__ uint32_t sums_tap(const March& a, const Lane& l, int k) {
  const float t = step_t(l, k);
  return tap_bits<kNarrow>(a, a.dense, 0, cell_of((l.o[0] + t * l.d[0]) - 0.5f),
                           cell_of((l.o[1] + t * l.d[1]) - 0.5f), cell_of((l.o[2] + t * l.d[2]) - 0.5f));
}

template <bool kNarrow>
__device__ __forceinline__ float sums_lane(const March& a, int i) {
  float acc = 0.0f;
  if (a.valid[i]) {
    const int64_t i3 = 3 * static_cast<int64_t>(i);
    const Lane l{{a.ipos[i3], a.ipos[i3 + 1], a.ipos[i3 + 2]}, {a.idir[i3], a.idir[i3 + 1], a.idir[i3 + 2]},
                 a.start[i], a.dt[i], a.far[i]};
    int k = 0;
    for (; k + kSumsChunk <= a.steps; k += kSumsChunk) {
      uint32_t bits[kSumsChunk];
#pragma unroll
      for (int j = 0; j < kSumsChunk; ++j) bits[j] = sums_tap<kNarrow>(a, l, k + j);
#pragma unroll
      for (int j = 0; j < kSumsChunk; ++j) acc = acc + __uint_as_float(bits[j] << 16);
    }
    uint32_t bits[kSumsChunk];
#pragma unroll
    for (int j = 0; j < kSumsChunk; ++j) bits[j] = k + j < a.steps ? sums_tap<kNarrow>(a, l, k + j) : 0u;
#pragma unroll
    for (int j = 0; j < kSumsChunk; ++j) {
      if (k + j < a.steps) acc = acc + __uint_as_float(bits[j] << 16);
    }
  }
  return acc;
}

template <bool kNarrow>
__global__ void __launch_bounds__(kThreads) tile_march_sums_kernel(March a, float* __restrict__ sums) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += gridDim.x * blockDim.x) sums[i] = sums_lane<kNarrow>(a, i);
}

using MarchKernel = void (*)(March);

// a 32-bit tap index where the extent holds at most 2^31 elements (every tap
// a kernel loads lies inside it)
bool narrow(int ny, int nx, int ez) { return static_cast<long long>(ez) * ny * nx <= (1LL << 31); }

int launch_march(MarchKernel kernel, const March& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(a.lut_k);
  kernel<<<(a.n + kThreads - 1) / kThreads, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

using SlabsKernel = void (*)(March, Slabs);

// the slab forms: kNarrow where one slab (slab + 2 * kSlabHalo slices)
// holds at most 2^31 elements
int launch_slabs(SlabsKernel narrow_kernel, SlabsKernel wide_kernel, const March& a, const Slabs& src,
                 cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(a.lut_k);
  const auto kernel = narrow(a.ny, a.nx, src.slab + 2 * kSlabHalo) ? narrow_kernel : wide_kernel;
  kernel<<<(a.n + kThreads - 1) / kThreads, kThreads, smem, stream>>>(a, src);
  return static_cast<int>(cudaGetLastError());
}

using ParkKernel = void (*)(March, Slabs, TileParks);

int launch_park(ParkKernel narrow_kernel, ParkKernel wide_kernel, const March& a, const Slabs& src,
                const TileParks& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(a.lut_k);
  const auto kernel = narrow(a.ny, a.nx, src.slab + 2 * kSlabHalo) ? narrow_kernel : wide_kernel;
  kernel<<<(a.n + kThreads - 1) / kThreads, kThreads, smem, stream>>>(a, src, p);
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
  return launch_march(narrow(ny, nx, ez) ? tile_march_sample_kernel<true> : tile_march_sample_kernel<false>, a,
                      stream);
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
  return launch_march(
      narrow(ny, nx, ez) ? tile_march_transmittance_kernel<true> : tile_march_transmittance_kernel<false>, a,
      stream);
}

extern "C" int vx_tile_march_sample_slabs(const uint16_t* const* slabs, int slab, int ny, int nx, int ex, int ey,
                                          int ez, const float* ipos, const float* idir, const float* start,
                                          const float* dt, const float* far, const bool* valid,
                                          const float* tau_target, const int64_t* state, const float* lut,
                                          int lut_k, const float* scalars, int64_t* state_out, bool* hit,
                                          float* t_out, float* rgb_out, int n, int steps, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const March a{nullptr, ny, nx, ex, ey, ez, ipos, idir, start, dt, far, valid, tau_target, state, lut, lut_k,
                scalars, state_out, hit, t_out, rgb_out, nullptr, n, steps};
  return launch_slabs(tile_march_sample_slabs_kernel<true>, tile_march_sample_slabs_kernel<false>, a,
                      Slabs{slabs, slab}, stream);
}

extern "C" int vx_tile_march_transmittance_slabs(const uint16_t* const* slabs, int slab, int ny, int nx, int ex,
                                                 int ey, int ez, const float* ipos, const float* idir,
                                                 const float* start, const float* dt, const float* far,
                                                 const bool* valid, const int64_t* state, const float* lut, int lut_k,
                                                 const float* scalars, int64_t* state_out, float* tau_out, int n,
                                                 int steps, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const March a{nullptr, ny, nx, ex, ey, ez, ipos, idir, start, dt, far, valid, nullptr, state, lut, lut_k,
                scalars, state_out, nullptr, nullptr, nullptr, tau_out, n, steps};
  return launch_slabs(tile_march_transmittance_slabs_kernel<true>, tile_march_transmittance_slabs_kernel<false>, a,
                      Slabs{slabs, slab}, stream);
}

extern "C" int vx_tile_march_sample_slabs_park(const uint16_t* const* slabs, int slab, int ny, int nx, int ex,
                                               int ey, int ez, const float* ipos, const float* idir,
                                               const float* start, const float* dt, const float* far,
                                               const bool* valid, const float* tau_target, const int64_t* state,
                                               const float* lut, int lut_k, const float* scalars, const int* step_in,
                                               const float* tau_in, int64_t* state_out, bool* hit, float* t_out,
                                               float* rgb_out, float* tau_out, int* step_out, int* park_out, int n,
                                               int steps, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const March a{nullptr, ny, nx, ex, ey, ez, ipos, idir, start, dt, far, valid, tau_target, state, lut, lut_k,
                scalars, state_out, hit, t_out, rgb_out, nullptr, n, steps};
  return launch_park(tile_march_sample_park_kernel<true>, tile_march_sample_park_kernel<false>, a,
                     Slabs{slabs, slab}, TileParks{step_in, tau_in, tau_out, step_out, park_out}, stream);
}

extern "C" int vx_tile_march_transmittance_slabs_park(const uint16_t* const* slabs, int slab, int ny, int nx, int ex,
                                                      int ey, int ez, const float* ipos, const float* idir,
                                                      const float* start, const float* dt, const float* far,
                                                      const bool* valid, const int64_t* state, const float* lut,
                                                      int lut_k, const float* scalars, const int* step_in,
                                                      const float* tau_in, int64_t* state_out, float* tau_out,
                                                      int* step_out, int* park_out, int n, int steps,
                                                      cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const March a{nullptr, ny, nx, ex, ey, ez, ipos, idir, start, dt, far, valid, nullptr, state, lut, lut_k,
                scalars, state_out, nullptr, nullptr, nullptr, tau_out, n, steps};
  return launch_park(tile_march_transmittance_park_kernel<true>, tile_march_transmittance_park_kernel<false>, a,
                     Slabs{slabs, slab}, TileParks{step_in, tau_in, nullptr, step_out, park_out}, stream);
}

// the warps that kernel `kernel` keeps resident on one SM of the current
// card, with a LUT of lut_k rows staged by the step loops: 0 and 1 the
// camera leg's with a 32-bit and a 64-bit tap index, 2 and 3 the shadow
// leg's, 4 and 5 the sums' (whose grid holds kSumsBlocksPerSM blocks an SM)
extern "C" int vx_tile_march_resident_warps(int kernel, int lut_k, int* warps) {
  const void* fns[] = {reinterpret_cast<const void*>(tile_march_sample_kernel<true>),
                       reinterpret_cast<const void*>(tile_march_sample_kernel<false>),
                       reinterpret_cast<const void*>(tile_march_transmittance_kernel<true>),
                       reinterpret_cast<const void*>(tile_march_transmittance_kernel<false>),
                       reinterpret_cast<const void*>(tile_march_sums_kernel<true>),
                       reinterpret_cast<const void*>(tile_march_sums_kernel<false>)};
  if (kernel < 0 || kernel > 5) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kernel < 4 ? sizeof(float) * 4 * static_cast<size_t>(lut_k) : 0;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[kernel], kThreads, smem);
  if (kernel >= 4 && blocks > kSumsBlocksPerSM) blocks = kSumsBlocksPerSM;
  *warps = blocks * kThreads / 32;
  return static_cast<int>(err);
}

extern "C" int vx_tile_march_sums(const uint16_t* dense, int ny, int nx, int ex, int ey, int ez,
                                  const float* ipos, const float* idir, const float* start, const float* dt,
                                  const float* far, const bool* valid, float* sums, int n, int steps,
                                  cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const March a{dense, ny, nx, ex, ey, ez, ipos, idir, start, dt, far, valid, nullptr, nullptr, nullptr, 0,
                nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, n, steps};
  const int blocks = (n + kThreads - 1) / kThreads;
  const auto kernel = narrow(ny, nx, ez) ? tile_march_sums_kernel<true> : tile_march_sums_kernel<false>;
  kernel<<<blocks < kSumsBlocksPerSM * sms ? blocks : kSumsBlocksPerSM * sms, kThreads, 0, stream>>>(a, sums);
  return static_cast<int>(cudaGetLastError());
}
