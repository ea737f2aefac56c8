// Design variants of the raymarch shadow leg's step loop
// (tile_march_transmittance, volxel_tpu_torch/csrc/tile_march.cu), each one
// template instantiation, for examples/tilemarch_variants.py.
//
// Every variant but the issue-only ones computes what
// tile_march_transmittance_plain computes, bit for bit, on the state and tau
// of every lane (the file is built with the flags kernels.py gives
// tile_march.cu, --fmad=false); the parameters change only when a step's tap
// is issued, how its address, its box test and its LUT row are formed, where
// the LUT is read from and which lanes a warp takes:
//
//   D      steps whose taps are in flight: at step k the draws and the tap
//          of step k + D are issued, then step k's tap is consumed (the LUT,
//          then tau). 0: each step's tap is issued and consumed in turn (the
//          parent's order). The draws keep their order, so the words and tau
//          do not change;
//   Order  with D > 0: 0, step k + D issued before step k is consumed (ptxas
//          keeps a slot's old and new tap in two registers and moves the new
//          one into the old one's at the loop's back edge, which waits on the
//          load just issued); 1, step k consumed first and step k + D issued
//          into its slot after, so the two are never live together (D - 1
//          steps' draws then lie between a tap's load and its use); 2, as 0
//          over two sets of D slots used in turns, the loop unrolled over
//          2 D steps, so that no move is needed;
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
//          depends on its address (the address arithmetic stays); not
//          bit-equal in tau, the words unchanged;
//   Packed the lanes inside the box taken from a list that a pack kernel
//          builds on the card (one atomic per warp: the list is in warp
//          order, its length is read on the card, so there is no host
//          sync); that kernel also writes the outside lanes' outputs (their
//          words unchanged, tau 0). The march's grid is sized to n, and a
//          block past the list's end returns before it stages the LUT.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <int D_, int MinB_, bool Tight_, bool Narrow_, int Lut_, bool Fake_, bool Packed_, int Order_>
struct Cfg {
  static constexpr int D = D_, MinB = MinB_, Lut = Lut_, Order = Order_;
  static constexpr bool Tight = Tight_, Narrow = Narrow_, Fake = Fake_, Packed = Packed_;
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

// a tap load that Fake replaces by a constant the compiler cannot fold (the
// address is never 1), so that the address arithmetic stays
template <bool Fake>
__device__ __forceinline__ uint32_t load_tap(const uint16_t* p) {
  if constexpr (!Fake) {
    return __ldg(p);
  } else {
    uint32_t r;
    asm volatile("{\n .reg .pred q;\n setp.eq.u64 q, %1, 1;\n selp.b32 %0, 0, 0x3f00, q;\n}"
                 : "=r"(r)
                 : "l"(reinterpret_cast<unsigned long long>(p)));
    return r;
  }
}

struct Shadow {
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
};

// what a lane's steps read
struct Ray {
  float p[3], d[3], start, dt, far;
};

// the first half of step k: its t, the reservoir's nine draws, the picked
// tap and its load, issued (0 outside the extent)
template <class C>
__device__ __forceinline__ uint32_t issue_step(const Shadow& a, const Ray& r, int k, uint32_t (&s)[4]) {
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
      if (u < w[c][tap] / clamp_min(sum_w[c], static_cast<float>(1e-3))) pick[c] = tap;
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
      bits = load_tap<C::Fake>(a.dense + idx);
    } else {
      bits = load_tap<C::Fake>(a.dense + (static_cast<int64_t>(z) * a.ny + y) * a.nx + x);
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
__device__ __forceinline__ float consume_step(const Shadow& a, const Consts& q, const float* __restrict__ lut,
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
__device__ __forceinline__ void shadow_body(const Shadow& a, float* s_lut) {
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

// the pack kernel of the Packed variants: the inside lanes' indices, one
// atomic per warp; the outside lanes' outputs
__global__ void __launch_bounds__(kThreads) pack_kernel(Shadow a, int* order, int* count) {
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

// the variants, by number: D, MinB, Tight, Narrow, Lut, Fake, Packed, Order
// (examples/tilemarch_variants.py names them)
#define VARIANTS(X)                                   \
  X(0, 0, 0, false, false, 0, false, false, 0)   \
  X(1, 0, 0, false, false, 0, true, false, 0)    \
  X(2, 1, 1, false, false, 0, false, false, 0)   \
  X(3, 2, 1, false, false, 0, false, false, 0)   \
  X(4, 4, 1, false, false, 0, false, false, 0)   \
  X(5, 2, 0, false, false, 0, false, false, 0)   \
  X(6, 0, 0, true, false, 0, false, false, 0)    \
  X(7, 0, 0, false, false, 1, false, false, 0)   \
  X(8, 0, 0, false, false, 2, false, false, 0)   \
  X(9, 1, 1, true, false, 0, false, false, 0)    \
  X(10, 2, 1, true, false, 0, false, false, 0)   \
  X(11, 4, 1, true, false, 0, false, false, 0)   \
  X(12, 2, 1, true, true, 0, false, false, 0)    \
  X(13, 2, 1, true, false, 1, false, false, 0)   \
  X(14, 2, 1, true, false, 2, false, false, 0)   \
  X(15, 2, 1, true, false, 0, false, true, 0)    \
  X(16, 2, 1, true, false, 0, true, false, 0)    \
  X(17, 0, 0, false, false, 0, false, true, 0)   \
  X(18, 0, 10, true, false, 0, false, false, 0)  \
  X(19, 0, 12, true, false, 0, false, false, 0)  \
  X(20, 1, 10, true, false, 0, false, false, 0)  \
  X(21, 2, 10, true, false, 0, false, false, 0)  \
  X(22, 2, 12, true, false, 0, false, false, 0)  \
  X(23, 2, 10, true, false, 2, false, false, 0)  \
  X(24, 0, 10, true, false, 0, true, false, 0)   \
  X(25, 2, 1, true, false, 0, false, false, 1)   \
  X(26, 3, 1, true, false, 0, false, false, 1)   \
  X(27, 4, 1, true, false, 0, false, false, 1)   \
  X(28, 2, 1, true, true, 0, false, false, 1)    \
  X(29, 2, 1, true, false, 0, true, false, 1)    \
  X(30, 3, 1, true, true, 0, false, false, 1)    \
  X(31, 1, 1, true, false, 0, false, false, 2)   \
  X(32, 2, 1, true, false, 0, false, false, 2)   \
  X(33, 2, 1, true, true, 0, false, false, 2)    \
  X(34, 2, 1, true, false, 0, true, false, 2)

#define BOUNDS_0 __launch_bounds__(kThreads)
#define BOUNDS_1 __launch_bounds__(kThreads, 1)
#define BOUNDS_10 __launch_bounds__(kThreads, 10)
#define BOUNDS_12 __launch_bounds__(kThreads, 12)
#define BOUNDS(MINB) BOUNDS_##MINB
#define KERNELS(num, D, MINB, TIGHT, NARROW, LUT, FAKE, PACKED, ORDER)              \
  __global__ void BOUNDS(MINB) variant##num##_shadow(Shadow a) {                    \
    extern __shared__ float s_lut[];                                                \
    shadow_body<Cfg<D, MINB, TIGHT, NARROW, LUT, FAKE, PACKED, ORDER>>(a, s_lut);   \
  }
VARIANTS(KERNELS)
#undef KERNELS

int launch(void (*kernel)(Shadow), bool packed, size_t smem, const Shadow& a, int* order, int* count, int* regs,
           int* per_sm, cudaStream_t stream) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks_per_sm = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (regs) *regs = attr.numRegs;
  if (per_sm) *per_sm = blocks_per_sm;
  if (a.n <= 0) return 0;
  const int blocks = (a.n + kThreads - 1) / kThreads;
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
  const Shadow a{dense, ny,  nx,        ex,      ey,      ez,    ipos,  idir, start, dt, far,
                 valid, state, lut, lut_k, scalars, state_out, tau_out, order, count, n, steps};
  const size_t lut_bytes = sizeof(float) * 4 * static_cast<size_t>(lut_k);
#define CASE(num, D, MINB, TIGHT, NARROW, LUT, FAKE, PACKED, ORDER) \
  case num:                                                  \
    return launch(variant##num##_shadow, PACKED, LUT == 2 ? 0 : lut_bytes, a, order, count, regs, per_sm, stream);
  switch (variant) {
    VARIANTS(CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CASE
}
