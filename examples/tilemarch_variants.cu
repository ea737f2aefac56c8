// Design variants of the raymarch step loops and the nearest-tap sums
// (volxel_tpu_torch/csrc/tile_march.cu), each one template instantiation, for
// examples/tilemarch_variants.py: the shadow leg's step loop
// (tile_march_transmittance), the camera leg's (tile_march_sample) and
// tile_march_sums.
//
// Every variant but the issue-only ones computes what its plain version
// (tile_march_transmittance_plain, tile_march_sample_plain,
// tile_march_sums_plain) computes, bit for bit, on every output of every lane
// (the file is built with the flags kernels.py gives tile_march.cu,
// --fmad=false); the parameters change only when a step's tap is issued, how
// its address, its box test, its reservoir compares and its LUT row are
// formed, where the LUT is read from and which lanes a warp takes:
//
//   D      steps whose taps are in flight: at step k the draws and the tap
//          of step k + D are issued, then step k's tap is consumed (the LUT,
//          then tau). 0: each step's tap is issued and consumed in turn (the
//          parent's order). The draws keep their order, so the words and tau
//          do not change. In the camera leg the later steps are speculative:
//          each slot keeps the words as they were before its own draws, and a
//          lane that hits at step k leaves the words before step k + 1's
//          draws (taps loaded past a hit are bytes only);
//   Order  with D > 0 (shadow leg): 0, step k + D issued before step k is
//          consumed (ptxas keeps a slot's old and new tap in two registers
//          and moves the new one into the old one's at the loop's back edge,
//          which waits on the load just issued); 1, step k consumed first and
//          step k + D issued into its slot after, so the two are never live
//          together (D - 1 steps' draws then lie between a tap's load and its
//          use); 2, as 0 over two sets of D slots used in turns, the loop
//          unrolled over 2 D steps, so that no move is needed;
//   MinB   the blocks per SM the launch bounds name (0: the block size alone,
//          as in the parent; 1 lets ptxas take registers for loads issued
//          early, 10 and 12 hold it to 48 and 40 registers, 40 and 48
//          resident warps);
//   Tight  the 32-bit forms: the cell located by a saturating float -> int
//          cast of the floor (__float2int_rd), the box test as three
//          unsigned compares, the LUT row as floor(clamp(y, 0, K - 1)) cast
//          to 32 bits (csrc/leg_common.cuh's decode), in place of floorf and
//          static_cast, six signed compares and a 64-bit clamp;
//   Narrow a 32-bit tap index (the caller passes it only for a field of
//          fewer than 2^31 elements);
//   Lut    0: the LUT staged in shared memory by every block (the parent);
//          1: staged only by a block that holds a lane inside the box;
//          2: each alpha read from global memory (__ldg), nothing staged;
//   Fake   issue-only: every tap replaced by a register constant that
//          depends on its address (the address arithmetic stays): not
//          bit-equal; the shadow leg's words unchanged, and the camera leg
//          given tau targets at which its constant taps hit at the steps
//          where the real ones do (its words and hits unchanged);
//   Packed the lanes inside the box taken from a list that a pack kernel
//          builds on the card (one atomic per warp: the list is in warp
//          order, its length is read on the card, so there is no host
//          sync); that kernel also writes the outside lanes' outputs (their
//          words unchanged, tau 0). The march's grid is sized to n, and a
//          block past the list's end returns before it stages the LUT;
//   Div    the reservoir's nine compares r < w / s: 0, by the IEEE division
//          (the parent); 1, exactly, in f64 and without a division
//          (draw_below);
//   NanMax the reservoir's divisor clamp_min(sum_w, 1e-3) as one max.NaN
//          (divisor) in place of a compare and a select;
//   Cap    (camera leg, sums) 0: one thread a lane, a block per 128 lanes (the
//          parent); C: a grid of C blocks an SM (4 C resident warps at most)
//          whose threads walk the lanes at the grid's stride, so that fewer
//          rays' taps are in flight on an SM at once;
//   Chunk  (sums) steps whose taps are loaded before any of them is added:
//          0, one step loaded and added in turn, in a loop of runtime length
//          (the parent); C, C steps' loads issued, then added in the plain
//          order, and a last guarded chunk for a `steps` that is not a
//          multiple of C.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <int D_, int MinB_, bool Tight_, bool Narrow_, int Lut_, bool Fake_, bool Packed_, int Order_, int Div_ = 0,
          bool NanMax_ = false>
struct Cfg {
  static constexpr int D = D_, MinB = MinB_, Lut = Lut_, Order = Order_, Div = Div_;
  static constexpr bool Tight = Tight_, Narrow = Narrow_, Fake = Fake_, Packed = Packed_, NanMax = NanMax_;
};

// the helpers of csrc/tile_march.cu, as they are there
__device__ __forceinline__ float min_nan(float a, float b) { return a != a ? a : (b != b ? b : fminf(a, b)); }
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ uint32_t rotl(uint32_t x, int k) { return (x << k) | (x >> (32 - k)); }

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

__device__ __forceinline__ void cubic_weights(float t, float (&w)[4]) {
  const float sixth = static_cast<float>(1.0 / 6.0);
  const float t2 = t * t;
  const float t3 = t * t2;
  w[0] = sixth * (((-t3 + 3.0f * t2) - 3.0f * t) + 1.0f);
  w[1] = sixth * ((3.0f * t3 - 6.0f * t2) + 4.0f);
  w[2] = sixth * (((-3.0f * t3 + 3.0f * t2) + 3.0f * t) + 1.0f);
  w[3] = sixth * t3;
}

// a tap load that Fake replaces by the constant `fake` in a way the compiler
// cannot fold (the address is never 1), so that the address arithmetic stays
template <bool Fake>
__device__ __forceinline__ uint32_t load_tap(const uint16_t* p, uint32_t fake) {
  if constexpr (!Fake) {
    return __ldg(p);
  } else {
    uint32_t r;
    asm volatile("{\n .reg .pred q;\n setp.eq.u64 q, %1, 1;\n selp.b32 %0, 0, %2, q;\n}"
                 : "=r"(r)
                 : "l"(reinterpret_cast<unsigned long long>(p)), "r"(fake));
    return r;
  }
}

// u < RN(w / s) for a draw u = m 2^-24 and s = clamp_min(sum_w, 1e-3), by the
// IEEE division (Div 0) or exactly without one (Div 1). u and its successor u+
// are adjacent floats, so RN(w / s) > u iff RN(w / s) >= u+, iff w / s > M =
// (u + u+) / 2, or w / s == M and the tie rounds to u+ (whose significand is
// even where u's is odd). s is at least 1e-3 or NaN, so w / s > M iff w > M s;
// M has at most 25 significant bits and s 24, so M s is exact in f64 (and M s
// >= 2^-150 * 1e-3 stays normal there). A NaN compares false on both sides;
// w == M s == inf (w and s both infinite) is a NaN quotient, kept out of the
// tie.
template <int Div>
__device__ __forceinline__ bool draw_below(float u, float w, float s) {
  if constexpr (Div == 0) {
    return u < w / s;
  } else {
    const uint32_t ub = __float_as_uint(u);
    const double mid = 0.5 * (static_cast<double>(u) + static_cast<double>(__uint_as_float(ub + 1u)));
    const double ms = mid * static_cast<double>(s);
    const double wd = static_cast<double>(w);
    return wd > ms || (wd == ms && (ub & 1u) != 0u && wd < __longlong_as_double(0x7ff0000000000000LL));
  }
}

// the reservoir's divisor clamp_min(v, 1e-3): by a compare and a select
// (NanMax false, the parent), or by one max.NaN (any NaN for a NaN v, which
// only ever divides: the quotient is NaN and its compare false either way)
template <bool NanMax>
__device__ __forceinline__ float divisor(float v) {
  const float lo = static_cast<float>(1e-3);
  if constexpr (NanMax) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(lo));
    return r;
  } else {
    return clamp_min(v, lo);
  }
}

struct March {
  const uint16_t* dense;
  int ny, nx, ex, ey, ez;
  const float *ipos, *idir, *start, *dt, *far;
  const bool* valid;
  const int64_t* state;
  const float* lut;
  int lut_k;
  const float* scalars;
  int64_t* state_out;
  float* tau_out;
  const int* order;  // Packed: the lanes inside the box, `*count` of them
  const int* count;
  int n;
  int steps;
  const float* tau_target;  // camera leg
  bool* hit;
  float* t_out;
  float* rgb_out;
  uint32_t fake;  // Fake: the bf16 bits every tap reads
};

// what a lane's steps read
struct Ray {
  float p[3], d[3], start, dt, far;
};

// the first half of step k: its t, the reservoir's nine draws, the picked
// tap and its load, issued (0 outside the extent)
template <class C>
__device__ __forceinline__ uint32_t issue_step(const March& a, const Ray& r, int k, uint32_t (&s)[4]) {
  const float t = min_nan(r.start + static_cast<float>(k) * r.dt, r.far);
  const float p[3] = {(r.p[0] + t * r.d[0]) - 0.5f, (r.p[1] + t * r.d[1]) - 0.5f, (r.p[2] + t * r.d[2]) - 0.5f};
  int base[3];
  float w[3][4];
  float sum_w[3];
  int pick[3] = {0, 0, 0};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    base[c] = C::Tight ? __float2int_rd(p[c]) : static_cast<int>(floorf(p[c]));
    cubic_weights(p[c] - static_cast<float>(base[c]), w[c]);
    sum_w[c] = w[c][0];
  }
#pragma unroll
  for (int tap = 1; tap <= 3; ++tap) {
#pragma unroll
    for (int c = 0; c < 3; ++c) sum_w[c] = sum_w[c] + w[c][tap];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float u = next_float(s);
      if (draw_below<C::Div>(u, w[c][tap], divisor<C::NanMax>(sum_w[c]))) pick[c] = tap;
    }
  }
  const int x = base[0] + pick[0] - 1, y = base[1] + pick[1] - 1, z = base[2] + pick[2] - 1;
  bool in;
  if constexpr (C::Tight) {
    in = static_cast<unsigned>(x) < static_cast<unsigned>(a.ex) && static_cast<unsigned>(y) < static_cast<unsigned>(a.ey) &&
         static_cast<unsigned>(z) < static_cast<unsigned>(a.ez);
  } else {
    in = x >= 0 && x < a.ex && y >= 0 && y < a.ey && z >= 0 && z < a.ez;
  }
  uint32_t bits = 0;
  if (in) {
    if constexpr (C::Narrow) {
      const unsigned idx = (static_cast<unsigned>(z) * a.ny + y) * a.nx + x;
      bits = load_tap<C::Fake>(a.dense + idx, a.fake);
    } else {
      bits = load_tap<C::Fake>(a.dense + (static_cast<int64_t>(z) * a.ny + y) * a.nx + x, a.fake);
    }
  }
  return bits;
}

struct Consts {
  float inv_maj, vol_maj, density_scale, range_lo, range_hi, lut_k, lut_top;
};

// the second half of a step: the tap's density, the LUT with range
// rejection and tau += (alpha * vol_maj) * dt
template <class C>
__device__ __forceinline__ float consume_step(const March& a, const Consts& q, const float* __restrict__ lut,
                                              uint32_t bits, float dt, float tau) {
  const float voxel = __uint_as_float(bits << 16);  // bf16 -> f32 is exact; +0 outside
  const float dens = (q.density_scale * voxel) * q.inv_maj;
  const bool rejected = dens < q.range_lo || dens > q.range_hi;
  float alpha;
  if constexpr (C::Tight) {
    const int row = __float2int_rd(fminf(fmaxf(dens * q.lut_k, 0.0f), q.lut_top));
    alpha = rejected ? 0.0f : (C::Lut == 2 ? __ldg(lut + 4 * row + 3) : lut[4 * row + 3]);
  } else {  // the parent's row
    long long li = static_cast<long long>(floorf(dens * static_cast<float>(a.lut_k)));
    li = li < 0 ? 0 : (li > a.lut_k - 1 ? a.lut_k - 1 : li);
    alpha = rejected ? 0.0f : (C::Lut == 2 ? __ldg(lut + 4 * li + 3) : lut[4 * li + 3]);
  }
  return tau + (alpha * q.vol_maj) * dt;
}

template <class C>
__device__ __forceinline__ void shadow_body(const March& a, float* s_lut) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool inside = false;
  if constexpr (C::Packed) {
    const int count = *a.count;
    if (static_cast<int>(blockIdx.x * blockDim.x) >= count) return;  // the whole block: before any barrier
    if (i < count) {
      i = a.order[i];
      inside = true;
    }
  } else {
    inside = i < a.n && a.valid[i];
  }
  const float* lut = a.lut;
  if constexpr (C::Lut == 0) {
    for (int j = threadIdx.x; j < 4 * a.lut_k; j += blockDim.x) s_lut[j] = a.lut[j];
    __syncthreads();
    lut = s_lut;
  } else if constexpr (C::Lut == 1) {
    if (__syncthreads_or(inside)) {
      for (int j = threadIdx.x; j < 4 * a.lut_k; j += blockDim.x) s_lut[j] = a.lut[j];
      __syncthreads();
    }
    lut = s_lut;
  }
  if (C::Packed ? !inside : i >= a.n) return;
  const int64_t i3 = 3 * static_cast<int64_t>(i), i4 = 4 * static_cast<int64_t>(i);
  uint32_t s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = static_cast<uint32_t>(a.state[i4 + j]);
  float tau = 0.0f;
  if (inside) {
    const Consts q{__ldg(a.scalars + 0), __ldg(a.scalars + 1), __ldg(a.scalars + 2), __ldg(a.scalars + 3),
                   __ldg(a.scalars + 4), static_cast<float>(a.lut_k), static_cast<float>(a.lut_k - 1)};
    const Ray r{{a.ipos[i3], a.ipos[i3 + 1], a.ipos[i3 + 2]}, {a.idir[i3], a.idir[i3 + 1], a.idir[i3 + 2]},
                a.start[i], a.dt[i], a.far[i]};
    if constexpr (C::D == 0) {
      for (int k = 0; k < a.steps; ++k) tau = consume_step<C>(a, q, lut, issue_step<C>(a, r, k, s), r.dt, tau);
    } else {
      uint32_t ring[C::D];
#pragma unroll
      for (int j = 0; j < C::D; ++j) ring[j] = j < a.steps ? issue_step<C>(a, r, j, s) : 0u;
      if constexpr (C::Order == 2) {
        uint32_t pong[C::D];
        for (int k = 0; k < a.steps; k += 2 * C::D) {
#pragma unroll
          for (int j = 0; j < C::D; ++j) {
            if (k + j + C::D < a.steps) pong[j] = issue_step<C>(a, r, k + j + C::D, s);
            if (k + j < a.steps) tau = consume_step<C>(a, q, lut, ring[j], r.dt, tau);
          }
#pragma unroll
          for (int j = 0; j < C::D; ++j) {
            if (k + j + 2 * C::D < a.steps) ring[j] = issue_step<C>(a, r, k + j + 2 * C::D, s);
            if (k + j + C::D < a.steps) tau = consume_step<C>(a, q, lut, pong[j], r.dt, tau);
          }
        }
      } else {
      for (int k = 0; k < a.steps; k += C::D) {
#pragma unroll
        for (int j = 0; j < C::D; ++j) {
          if constexpr (C::Order == 1) {
            if (k + j < a.steps) tau = consume_step<C>(a, q, lut, ring[j], r.dt, tau);
            if (k + j + C::D < a.steps) ring[j] = issue_step<C>(a, r, k + j + C::D, s);
          } else {
            const uint32_t bits = ring[j];
            if (k + j + C::D < a.steps) ring[j] = issue_step<C>(a, r, k + j + C::D, s);
            if (k + j < a.steps) tau = consume_step<C>(a, q, lut, bits, r.dt, tau);
          }
        }
      }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) a.state_out[i4 + j] = static_cast<int64_t>(s[j]);
  a.tau_out[i] = tau;
}


// a camera step's tap consumed: tau as in consume_step, and the LUT row and
// its rejection, which give the colour at a hit
template <class C>
__device__ __forceinline__ float consume_camera(const March& a, const Consts& q, const float* __restrict__ lut,
                                                uint32_t bits, float dt, float tau, const float*& row,
                                                bool& rejected) {
  const float voxel = __uint_as_float(bits << 16);
  const float dens = (q.density_scale * voxel) * q.inv_maj;
  rejected = dens < q.range_lo || dens > q.range_hi;
  if constexpr (C::Tight) {
    row = lut + 4 * __float2int_rd(fminf(fmaxf(dens * q.lut_k, 0.0f), q.lut_top));
  } else {  // the parent's row
    long long li = static_cast<long long>(floorf(dens * static_cast<float>(a.lut_k)));
    li = li < 0 ? 0 : (li > a.lut_k - 1 ? a.lut_k - 1 : li);
    row = lut + 4 * li;
  }
  const float alpha = rejected ? 0.0f : row[3];
  return tau + (alpha * q.vol_maj) * dt;
}

__device__ __forceinline__ void copy_words(uint32_t (&to)[4], const uint32_t (&from)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) to[j] = from[j];
}

// the camera leg's step loop: each lane stops at its first step with tau >=
// tau_target; with D > 0 the draws and taps of the next D steps are issued
// before a step's hit test, each slot with the words before its draws
template <class C>
__device__ __forceinline__ void camera_lane(const March& a, const float* lut, int i) {
  if (i >= a.n) return;
  const int64_t i3 = 3 * static_cast<int64_t>(i), i4 = 4 * static_cast<int64_t>(i);
  uint32_t s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = static_cast<uint32_t>(a.state[i4 + j]);
  bool hit = false;
  float t_hit = 0.0f;
  float rgb[3] = {1.0f, 1.0f, 1.0f};
  if (a.valid[i]) {
    const Consts q{__ldg(a.scalars + 0), __ldg(a.scalars + 1), __ldg(a.scalars + 2), __ldg(a.scalars + 3),
                   __ldg(a.scalars + 4), static_cast<float>(a.lut_k), static_cast<float>(a.lut_k - 1)};
    const Ray r{{a.ipos[i3], a.ipos[i3 + 1], a.ipos[i3 + 2]}, {a.idir[i3], a.idir[i3 + 1], a.idir[i3 + 2]},
                a.start[i], a.dt[i], a.far[i]};
    const float target = a.tau_target[i];
    float tau = 0.0f;
    int k_hit = -1;  // the step that hit, its LUT row and rejection
    const float* row_hit = lut;
    bool rejected_hit = false;
    if constexpr (C::D == 0) {
      for (int k = 0; k < a.steps; ++k) {
        const float* row;
        bool rejected;
        tau = consume_camera<C>(a, q, lut, issue_step<C>(a, r, k, s), r.dt, tau, row, rejected);
        if (tau >= target) {
          k_hit = k;
          row_hit = row;
          rejected_hit = rejected;
          break;
        }
      }
    } else {
      uint32_t ring[C::D];
      uint32_t before[C::D][4];
#pragma unroll
      for (int j = 0; j < C::D; ++j) {
        ring[j] = 0u;
        copy_words(before[j], s);
        if (j < a.steps) ring[j] = issue_step<C>(a, r, j, s);
      }
      for (int k = 0; k_hit < 0 && k < a.steps; k += C::D) {
#pragma unroll
        for (int j = 0; j < C::D; ++j) {
          const int kk = k + j;
          if (kk >= a.steps) break;
          const uint32_t bits = ring[j];
          if (kk + C::D < a.steps) {
            copy_words(before[j], s);
            ring[j] = issue_step<C>(a, r, kk + C::D, s);
          }
          const float* row;
          bool rejected;
          tau = consume_camera<C>(a, q, lut, bits, r.dt, tau, row, rejected);
          if (tau >= target) {
            k_hit = kk;
            row_hit = row;
            rejected_hit = rejected;
            // the words before step kk + 1's draws, where that step was issued
            if (kk + 1 < a.steps) copy_words(s, before[(j + 1) % C::D]);
            break;
          }
        }
      }
    }
    if (k_hit >= 0) {
      hit = true;
      t_hit = min_nan(r.start + static_cast<float>(k_hit) * r.dt, r.far);
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = rejected_hit ? 0.0f : row_hit[c];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) a.state_out[i4 + j] = static_cast<int64_t>(s[j]);
  a.hit[i] = hit;
  a.t_out[i] = t_hit;
#pragma unroll
  for (int c = 0; c < 3; ++c) a.rgb_out[i3 + c] = rgb[c];
}

// a sums step: its t and its nearest tap's bits (0 outside the extent)
template <bool Tight, bool Narrow, bool Fake>
__device__ __forceinline__ uint32_t sums_tap(const March& a, const Ray& r, int k) {
  const float t = min_nan(r.start + static_cast<float>(k) * r.dt, r.far);
  int cell[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float p = (r.p[c] + t * r.d[c]) - 0.5f;
    cell[c] = Tight ? __float2int_rd(p) : static_cast<int>(floorf(p));
  }
  const int x = cell[0], y = cell[1], z = cell[2];
  const bool in = Tight ? (static_cast<unsigned>(x) < static_cast<unsigned>(a.ex) &&
                           static_cast<unsigned>(y) < static_cast<unsigned>(a.ey) &&
                           static_cast<unsigned>(z) < static_cast<unsigned>(a.ez))
                        : (x >= 0 && x < a.ex && y >= 0 && y < a.ey && z >= 0 && z < a.ez);
  if (!in) return 0u;
  if constexpr (Narrow) {
    return load_tap<Fake>(a.dense + (static_cast<unsigned>(z) * a.ny + y) * a.nx + x, a.fake);
  } else {
    return load_tap<Fake>(a.dense + (static_cast<int64_t>(z) * a.ny + y) * a.nx + x, a.fake);
  }
}

// tile_march_sums' lane: Chunk steps' taps loaded before they are added in
// the plain order (0: one step loaded and added in turn)
template <int Chunk, bool Tight, bool Narrow, bool Fake>
__device__ __forceinline__ void sums_lane(const March& a, int i) {
  if (i >= a.n) return;
  float acc = 0.0f;
  if (a.valid[i]) {
    const int64_t i3 = 3 * static_cast<int64_t>(i);
    const Ray r{{a.ipos[i3], a.ipos[i3 + 1], a.ipos[i3 + 2]}, {a.idir[i3], a.idir[i3 + 1], a.idir[i3 + 2]},
                a.start[i], a.dt[i], a.far[i]};
    if constexpr (Chunk == 0) {
      for (int k = 0; k < a.steps; ++k) acc = acc + __uint_as_float(sums_tap<Tight, Narrow, Fake>(a, r, k) << 16);
    } else {
      int k = 0;
      for (; k + Chunk <= a.steps; k += Chunk) {
        uint32_t bits[Chunk];
#pragma unroll
        for (int j = 0; j < Chunk; ++j) bits[j] = sums_tap<Tight, Narrow, Fake>(a, r, k + j);
#pragma unroll
        for (int j = 0; j < Chunk; ++j) acc = acc + __uint_as_float(bits[j] << 16);
      }
      uint32_t bits[Chunk];
#pragma unroll
      for (int j = 0; j < Chunk; ++j) bits[j] = k + j < a.steps ? sums_tap<Tight, Narrow, Fake>(a, r, k + j) : 0u;
#pragma unroll
      for (int j = 0; j < Chunk; ++j) {
        if (k + j < a.steps) acc = acc + __uint_as_float(bits[j] << 16);
      }
    }
  }
  a.tau_out[i] = acc;
}

// the lanes of a block: one a thread, or with Cap > 0 (a grid of Cap blocks
// an SM) every lane the grid's stride reaches
template <int Cap, class Lane>
__device__ __forceinline__ void each_lane(const March& a, Lane lane) {
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (Cap == 0) {
    lane(first);
  } else {
    for (int i = first; i < a.n; i += gridDim.x * blockDim.x) lane(i);
  }
}

// the pack kernel of the Packed variants: the inside lanes' indices, one
// atomic per warp; the outside lanes' outputs
__global__ void __launch_bounds__(kThreads) pack_kernel(March a, int* order, int* count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool inside = i < a.n && a.valid[i];
  const unsigned ballot = __ballot_sync(0xffffffffu, inside);
  const int lane = threadIdx.x & 31;
  int first = 0;
  if (lane == 0 && ballot) first = atomicAdd(count, __popc(ballot));
  first = __shfl_sync(0xffffffffu, first, 0);
  if (inside) {
    order[first + __popc(ballot & ((1u << lane) - 1u))] = i;
  } else if (i < a.n) {
    const int64_t i4 = 4 * static_cast<int64_t>(i);
#pragma unroll
    for (int j = 0; j < 4; ++j) a.state_out[i4 + j] = a.state[i4 + j];
    a.tau_out[i] = 0.0f;
  }
}

// the shadow leg's variants, by number: D, MinB, Tight, Narrow, Lut, Fake,
// Packed, Order, Div, NanMax (examples/tilemarch_variants.py names them)
#define VARIANTS(X)                                   \
  X(0, 0, 0, false, false, 0, false, false, 0, 0, false)   \
  X(1, 0, 0, false, false, 0, true, false, 0, 0, false)    \
  X(2, 1, 1, false, false, 0, false, false, 0, 0, false)   \
  X(3, 2, 1, false, false, 0, false, false, 0, 0, false)   \
  X(4, 4, 1, false, false, 0, false, false, 0, 0, false)   \
  X(5, 2, 0, false, false, 0, false, false, 0, 0, false)   \
  X(6, 0, 0, true, false, 0, false, false, 0, 0, false)    \
  X(7, 0, 0, false, false, 1, false, false, 0, 0, false)   \
  X(8, 0, 0, false, false, 2, false, false, 0, 0, false)   \
  X(9, 1, 1, true, false, 0, false, false, 0, 0, false)    \
  X(10, 2, 1, true, false, 0, false, false, 0, 0, false)   \
  X(11, 4, 1, true, false, 0, false, false, 0, 0, false)   \
  X(12, 2, 1, true, true, 0, false, false, 0, 0, false)    \
  X(13, 2, 1, true, false, 1, false, false, 0, 0, false)   \
  X(14, 2, 1, true, false, 2, false, false, 0, 0, false)   \
  X(15, 2, 1, true, false, 0, false, true, 0, 0, false)    \
  X(16, 2, 1, true, false, 0, true, false, 0, 0, false)    \
  X(17, 0, 0, false, false, 0, false, true, 0, 0, false)   \
  X(18, 0, 10, true, false, 0, false, false, 0, 0, false)  \
  X(19, 0, 12, true, false, 0, false, false, 0, 0, false)  \
  X(20, 1, 10, true, false, 0, false, false, 0, 0, false)  \
  X(21, 2, 10, true, false, 0, false, false, 0, 0, false)  \
  X(22, 2, 12, true, false, 0, false, false, 0, 0, false)  \
  X(23, 2, 10, true, false, 2, false, false, 0, 0, false)  \
  X(24, 0, 10, true, false, 0, true, false, 0, 0, false)   \
  X(25, 2, 1, true, false, 0, false, false, 1, 0, false)   \
  X(26, 3, 1, true, false, 0, false, false, 1, 0, false)   \
  X(27, 4, 1, true, false, 0, false, false, 1, 0, false)   \
  X(28, 2, 1, true, true, 0, false, false, 1, 0, false)    \
  X(29, 2, 1, true, false, 0, true, false, 1, 0, false)    \
  X(30, 3, 1, true, true, 0, false, false, 1, 0, false)    \
  X(31, 1, 1, true, false, 0, false, false, 2, 0, false)   \
  X(32, 2, 1, true, false, 0, false, false, 2, 0, false)   \
  X(33, 2, 1, true, true, 0, false, false, 2, 0, false)    \
  X(34, 2, 1, true, false, 0, true, false, 2, 0, false)  \
  X(35, 2, 1, true, true, 0, false, false, 0, 1, false)  \
  X(36, 2, 1, true, true, 0, false, false, 0, 0, true)

#define BOUNDS_0 __launch_bounds__(kThreads)
#define BOUNDS_1 __launch_bounds__(kThreads, 1)
#define BOUNDS_10 __launch_bounds__(kThreads, 10)
#define BOUNDS_12 __launch_bounds__(kThreads, 12)
#define BOUNDS(MINB) BOUNDS_##MINB
#define KERNELS(num, D, MINB, TIGHT, NARROW, LUT, FAKE, PACKED, ORDER, DIV, NANMAX)              \
  __global__ void BOUNDS(MINB) variant##num##_shadow(March a) {                                 \
    extern __shared__ float s_lut[];                                                             \
    shadow_body<Cfg<D, MINB, TIGHT, NARROW, LUT, FAKE, PACKED, ORDER, DIV, NANMAX>>(a, s_lut);   \
  }
VARIANTS(KERNELS)
#undef KERNELS

// the camera leg's variants: D, MinB, Tight, Narrow, Fake, Div, Cap, NanMax
#define SAMPLE_VARIANTS(X)                 \
  X(0, 0, 0, false, false, false, 0, 0, false)    \
  X(1, 0, 0, false, false, true, 0, 0, false)     \
  X(2, 0, 0, true, false, false, 0, 0, false)     \
  X(3, 0, 0, true, true, false, 0, 0, false)      \
  X(4, 0, 1, true, true, false, 0, 0, false)      \
  X(5, 1, 1, true, true, false, 0, 0, false)      \
  X(6, 2, 1, true, true, false, 0, 0, false)      \
  X(7, 1, 0, true, true, false, 0, 0, false)      \
  X(8, 2, 0, true, true, false, 0, 0, false)      \
  X(9, 0, 0, false, false, false, 1, 0, false)    \
  X(10, 0, 1, true, true, false, 1, 0, false)     \
  X(11, 1, 1, true, true, false, 1, 0, false)     \
  X(12, 2, 1, true, true, false, 1, 0, false)     \
  X(13, 0, 1, true, true, true, 0, 0, false)      \
  X(14, 1, 1, true, true, true, 0, 0, false)      \
  X(15, 2, 1, true, true, true, 0, 0, false)      \
  X(16, 1, 1, true, false, false, 0, 0, false)    \
  X(17, 0, 0, true, true, false, 0, 8, false)     \
  X(18, 0, 0, true, true, false, 0, 6, false)     \
  X(19, 0, 0, true, true, true, 0, 0, false)  \
  X(20, 0, 0, true, true, false, 0, 0, true)   \
  X(21, 0, 0, true, true, true, 0, 0, true)
#define SAMPLE_KERNELS(num, D, MINB, TIGHT, NARROW, FAKE, DIV, CAP, NANMAX)                  \
  __global__ void BOUNDS(MINB) variant##num##_sample(March a) {                              \
    extern __shared__ float s_lut[];                                                         \
    for (int j = threadIdx.x; j < 4 * a.lut_k; j += blockDim.x) s_lut[j] = a.lut[j];         \
    __syncthreads();                                                                         \
    each_lane<CAP>(a, [&](int i) {                                                           \
      camera_lane<Cfg<D, MINB, TIGHT, NARROW, 0, FAKE, false, 0, DIV, NANMAX>>(a, s_lut, i); \
    });                                                                                      \
  }
SAMPLE_VARIANTS(SAMPLE_KERNELS)
#undef SAMPLE_KERNELS

// tile_march_sums' variants: Chunk, Tight, Narrow, Fake, Cap
#define SUMS_VARIANTS(X)               \
  X(0, 0, false, false, false, 0)      \
  X(1, 0, false, false, true, 0)       \
  X(2, 0, true, true, false, 0)        \
  X(3, 4, true, true, false, 0)        \
  X(4, 8, true, true, false, 0)        \
  X(5, 16, true, true, false, 0)       \
  X(6, 8, false, false, false, 0)      \
  X(7, 16, false, false, false, 0)     \
  X(8, 16, true, false, false, 0)      \
  X(9, 16, true, true, true, 0)        \
  X(10, 32, true, true, false, 0)      \
  X(11, 0, false, false, false, 8)     \
  X(12, 0, false, false, false, 6)     \
  X(13, 0, false, false, false, 4)     \
  X(14, 16, true, true, false, 8)      \
  X(15, 16, true, true, false, 6)      \
  X(16, 16, true, true, false, 4)      \
  X(17, 16, true, false, false, 6)     \
  X(18, 32, true, true, false, 6)      \
  X(19, 8, true, true, false, 6)       \
  X(20, 16, true, false, false, 4)     \
  X(21, 0, true, true, false, 6)       \
  X(22, 16, true, true, false, 2)      \
  X(23, 0, true, true, false, 2)       \
  X(24, 16, true, true, false, 1)      \
  X(25, 16, true, true, false, 3)      \
  X(26, 32, true, true, false, 2)      \
  X(27, 8, true, true, false, 2)       \
  X(28, 16, true, false, false, 2)     \
  X(29, 0, false, false, false, 2)     \
  X(30, 16, true, true, true, 2)       \
  X(31, 32, true, true, false, 1)      \
  X(32, 4, true, true, false, 2)
#define SUMS_KERNELS(num, CHUNK, TIGHT, NARROW, FAKE, CAP)                                     \
  __global__ void __launch_bounds__(kThreads) variant##num##_sums(March a) {                    \
    each_lane<CAP>(a, [&](int i) { sums_lane<CHUNK, TIGHT, NARROW, FAKE>(a, i); });             \
  }
SUMS_VARIANTS(SUMS_KERNELS)
#undef SUMS_KERNELS

int launch(void (*kernel)(March), bool packed, size_t smem, const March& a, int* order, int* count, int* regs,
           int* per_sm, cudaStream_t stream, int cap = 0) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks_per_sm = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (regs) *regs = attr.numRegs;
  if (per_sm) *per_sm = blocks_per_sm;
  if (a.n <= 0) return 0;
  int blocks = (a.n + kThreads - 1) / kThreads;
  if (cap > 0) {
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    blocks = blocks < cap * sms ? blocks : cap * sms;
  }
  if (packed) {
    err = cudaMemsetAsync(count, 0, sizeof(int), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    pack_kernel<<<blocks, kThreads, 0, stream>>>(a, order, count);
  }
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant `variant` of the shadow leg's step loop over n lanes (order and
// count: scratch of n ints and one int, used by the packed variants); with
// n == 0 only reports the kernel's registers and resident blocks per SM
extern "C" int vx_tilemarch_variant(int variant, const uint16_t* dense, int ny, int nx, int ex, int ey, int ez,
                                    const float* ipos, const float* idir, const float* start, const float* dt,
                                    const float* far, const bool* valid, const int64_t* state, const float* lut,
                                    int lut_k, const float* scalars, int64_t* state_out, float* tau_out, int* order,
                                    int* count, int n, int steps, int* regs, int* per_sm, cudaStream_t stream) {
  const March a{dense,   ny,        nx,      ex,    ey,    ez,    ipos,    idir,    start,   dt,
                far,     valid,     state,   lut,   lut_k, scalars, state_out, tau_out, order, count,
                n,       steps,     nullptr, nullptr, nullptr, nullptr, 0x3f00u};
  const size_t lut_bytes = sizeof(float) * 4 * static_cast<size_t>(lut_k);
#define CASE(num, D, MINB, TIGHT, NARROW, LUT, FAKE, PACKED, ORDER, DIV, NANMAX) \
  case num:                                                  \
    return launch(variant##num##_shadow, PACKED, LUT == 2 ? 0 : lut_bytes, a, order, count, regs, per_sm, stream);
  switch (variant) {
    VARIANTS(CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CASE
}

// variant `variant` of the camera leg's step loop over n lanes, every tap of
// an issue-only variant reading the bf16 bits `fake`; with n == 0 only reports
// the kernel's registers and resident blocks per SM
extern "C" int vx_tilemarch_sample_variant(int variant, const uint16_t* dense, int ny, int nx, int ex, int ey,
                                           int ez, const float* ipos, const float* idir, const float* start,
                                           const float* dt, const float* far, const bool* valid,
                                           const float* tau_target, const int64_t* state, const float* lut,
                                           int lut_k, const float* scalars, int64_t* state_out, bool* hit,
                                           float* t_out, float* rgb_out, unsigned fake, int n, int steps, int* regs,
                                           int* per_sm, cudaStream_t stream) {
  const March a{dense,   ny,        nx,      ex,      ey,      ez,      ipos,      idir,    start,   dt,
                far,     valid,     state,   lut,     lut_k,   scalars, state_out, nullptr, nullptr, nullptr,
                n,       steps,     tau_target, hit,  t_out,   rgb_out, fake};
  const size_t lut_bytes = sizeof(float) * 4 * static_cast<size_t>(lut_k);
#define CASE(num, D, MINB, TIGHT, NARROW, FAKE, DIV, CAP, NANMAX) \
  case num:                                              \
    return launch(variant##num##_sample, false, lut_bytes, a, nullptr, nullptr, regs, per_sm, stream, CAP);
  switch (variant) {
    SAMPLE_VARIANTS(CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CASE
}

// variant `variant` of tile_march_sums over n lanes; with n == 0 only
// reports the kernel's registers and resident blocks per SM
extern "C" int vx_tilemarch_sums_variant(int variant, const uint16_t* dense, int ny, int nx, int ex, int ey, int ez,
                                         const float* ipos, const float* idir, const float* start, const float* dt,
                                         const float* far, const bool* valid, float* sums, int n, int steps,
                                         int* regs, int* per_sm, cudaStream_t stream) {
  const March a{dense,   ny,      nx,      ex,      ey,      ez,      ipos,    idir,    start,   dt,
                far,     valid,   nullptr, nullptr, 0,       nullptr, nullptr, sums,    nullptr, nullptr,
                n,       steps,   nullptr, nullptr, nullptr, nullptr, 0x3f00u};
#define CASE(num, CHUNK, TIGHT, NARROW, FAKE, CAP) \
  case num:                                       \
    return launch(variant##num##_sums, false, 0, a, nullptr, nullptr, regs, per_sm, stream, CAP);
  switch (variant) {
    SUMS_VARIANTS(CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CASE
}
