// Gradient shading's per-lane work after the legs: the hit point, the six
// trilinear lookups of the central-difference gradient, the normal and its
// facing flip, Blinn-Phong with the shadow leg's transmittance, the select
// against the background and sanitize.
//
// Replaces no TPU kernel: the JAX package's volxel_tpu/render/shading.py is
// jnp. Plain version: volxel_tpu_torch/render/shading.py: shade_hits_plain,
// which takes ~290 ATen launches a 1080p frame (each of the six lookups
// builds, clips and gathers (n, 8, 3) int64 tap coordinates, ~400 MB
// written and read a lookup) and ~27 device ms of a 30 ms frame on an H100.
//
// What bounds it on an H100: bytes. A lane streams ~69 B (origin 12, or 0
// for one origin expanded over the lanes; direction 12, t 4, hit 1, rgb 12,
// shadow 4, background 12 in; radiance 12 out): 143 MB at 1080p, 0.043 ms
// at 3.35 TB/s. Its 48 bf16 taps lie in at most 24 32-byte sectors (1.6 GB
// at 1080p if no two lanes shared one); the hits of neighbouring pixels
// are coherent, so they share most sectors, which stay in the 50 MB L2.
//
// Design: one thread a lane, one pass, nothing but the radiance written to
// device memory. The hit point and its index-space position stay in
// registers; the six lookups' 48 predicated loads are issued before any
// is summed (leg_common.cuh's fetch_at, read-only __ldg), then each sum is
// taken as the legs take theirs (trilinear). A lane that missed loads no
// tap. The field is a dense array (Field) or z-slabs read through the
// slabs' pointer table (SlabField, bf16-rounded sums where the grid's
// tap_dtype asks), as the legs read it.
//
// Bit-equality with the plain version: every f32 sum, difference and
// product is written with __fadd_rn / __fsub_rn / __fmul_rn in the plain
// version's order, divisions are IEEE (div_rn), the square root is
// __fsqrt_rn (ATen's sqrtf is correctly rounded), and the Python scalars
// are their f32 values. ATen's reduction over the three components of
// `.sum(dim=-1)` and `torch.linalg.norm(..., dim=-1)` runs two threads to an
// output: the first accumulates components 0 and 2 in two accumulators, the
// second component 1, so the result is ((0 + x0) + (0 + x2)) + (0 + x1);
// the norm's `acc + x * x` contracts to an FMA, which from acc = 0 is the
// rounded square (sum3, norm3). torch.pow(x, 32.0) calls the math
// library's accurate powf with the exponent as a run-time value; the file
// is built with --fmad=true (kernels.FMAD_SOURCES), as ATen builds its pow
// kernel, so that powf's own code is compiled as there, and takes the
// exponent as an argument. clamp_min keeps a NaN as ATen's does.

#include "leg_common.cuh"

namespace {

// the f32 values of render/shading.py's constants
constexpr float kAmbient = 0x1.333334p-3f;  // K_AMBIENT 0.15
constexpr float kDiffuse = 0.75f;           // K_DIFFUSE
constexpr float kSpecular = 0.25f;          // K_SPECULAR
constexpr float kTiny = 0x1.5798eep-27f;    // clamp_min(., 1e-8)

// what every lane reads and writes besides the field
struct Lanes {
  const float* origin;
  long long origin_step;  // floats from one lane's origin to the next: 3, or 0 for one origin
  const float* direction;
  const float* t;
  const bool* hit;
  const float* rgb;
  const float* shadow;
  const float* bg;  // nullptr: black
  const float* transform_inv;  // (4, 4) world -> index
  const float* density_scale;
  const float* light_dir;
  float shininess;
  float* out;
  long long n;
};

// (x).sum(dim=-1) and the square of torch.linalg.norm(x, dim=-1) over three
// components, as ATen's reduction kernel sums them (see above)
__device__ __forceinline__ float sum3(const float (&x)[3]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(0.0f, x[0]), __fadd_rn(0.0f, x[2])), __fadd_rn(0.0f, x[1]));
}
__device__ __forceinline__ float norm3(const float (&x)[3]) {
  const float sq[3] = {__fmul_rn(x[0], x[0]), __fmul_rn(x[1], x[1]), __fmul_rn(x[2], x[2])};
  return __fsqrt_rn(sum3(sq));
}

template <class F>
__global__ void __launch_bounds__(kThreads) shade_kernel(F v, Lanes a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const float d[3] = {a.direction[3 * i], a.direction[3 * i + 1], a.direction[3 * i + 2]};
  float c[3] = {0.0f, 0.0f, 0.0f};
  if (a.hit[i]) {
    // hit_pos = origin + t * direction, then world_to_index_point
    const float t = a.t[i];
    const float* o = a.origin + i * a.origin_step;
    const float hp[3] = {__fadd_rn(o[0], __fmul_rn(t, d[0])), __fadd_rn(o[1], __fmul_rn(t, d[1])),
                         __fadd_rn(o[2], __fmul_rn(t, d[2]))};
    float ip[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float* m = a.transform_inv + 4 * j;
      const float s = __fadd_rn(__fadd_rn(__fmul_rn(hp[0], __ldg(m)), __fmul_rn(hp[1], __ldg(m + 1))),
                                __fmul_rn(hp[2], __ldg(m + 2)));
      ip[j] = __fadd_rn(s, __ldg(m + 3));
    }
    // density_gradient: the taps at ipos + offset and ipos - offset, each
    // axis's offset a unit vector, all issued first
    Taps e[3][2];
#pragma unroll
    for (int axis = 0; axis < 3; ++axis) {
      float hi[3], lo[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float off = k == axis ? 1.0f : 0.0f;
        hi[k] = __fadd_rn(ip[k], off);
        lo[k] = __fsub_rn(ip[k], off);
      }
      fetch_at(v, hi, e[axis][0]);
      fetch_at(v, lo, e[axis][1]);
    }
    const float ds = __ldg(a.density_scale);
    float g[3];
#pragma unroll
    for (int axis = 0; axis < 3; ++axis) {
      const float hi = __fmul_rn(ds, trilinear<F>(e[axis][0]));
      const float lo = __fmul_rn(ds, trilinear<F>(e[axis][1]));
      g[axis] = __fmul_rn(__fsub_rn(hi, lo), 0.5f);
    }
    // the normal, flipped toward the viewer
    const float len = clamp_min(norm3(g), kTiny);
    float nrm[3], facing[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      nrm[k] = div_rn(-g[k], len);
      facing[k] = __fmul_rn(nrm[k], -d[k]);
    }
    if (sum3(facing) < 0.0f) {
#pragma unroll
      for (int k = 0; k < 3; ++k) nrm[k] = -nrm[k];
    }
    // Blinn-Phong
    float l[3], nl[3], h[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      l[k] = -__ldg(a.light_dir + k);
      nl[k] = __fmul_rn(nrm[k], l[k]);
      h[k] = __fsub_rn(l[k], d[k]);
    }
    const float n_dot_l = clamp_min(sum3(nl), 0.0f);
    const float hlen = clamp_min(norm3(h), kTiny);
    float nh[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) nh[k] = __fmul_rn(nrm[k], div_rn(h[k], hlen));
    const float spec = powf(clamp_min(sum3(nh), 0.0f), a.shininess);
    const float shadow = a.shadow[i];
    const float lit = __fadd_rn(kAmbient, __fmul_rn(kDiffuse, __fmul_rn(n_dot_l, shadow)));
    const float glint = __fmul_rn(kSpecular, __fmul_rn(spec, shadow));
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = __fadd_rn(__fmul_rn(a.rgb[3 * i + k], lit), glint);
  } else if (a.bg != nullptr) {
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = a.bg[3 * i + k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) a.out[3 * i + k] = isfinite(c[k]) ? c[k] : 0.0f;  // sanitize
}

template <class F>
int launch(const F& v, const Lanes& a, cudaStream_t stream) {
  if (a.n > 0) shade_kernel<F><<<blocks_for(a.n), kThreads, 0, stream>>>(v, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The field is `dense` (ny, nx its rows' and columns' sizes) or, where
// `dense` is null, the z-slabs of `slabs` (`slab` owned slices each; their
// sums rounded to bf16 where `round_taps`); the extent is (ex, ey, ez).
extern "C" int vx_shade(const uint16_t* dense, const uint16_t* const* slabs, int slab, int round_taps, int ny,
                        int nx, int ex, int ey, int ez, const float* transform_inv, const float* density_scale,
                        const float* light_dir, float shininess, const float* origin, long long origin_step,
                        const float* direction, const float* t, const bool* hit, const float* rgb,
                        const float* shadow, const float* bg, float* out, long long n, cudaStream_t stream) {
  const Lanes a{origin, origin_step, direction, t, hit, rgb, shadow, bg, transform_inv, density_scale, light_dir,
                shininess, out, n};
  if (dense != nullptr) return launch(make_field(dense, ny, nx, ex, ey, ez, nullptr, 0, nullptr), a, stream);
  if (round_taps) return launch(make_slab_field<true>(slabs, slab, ny, nx, ex, ey, ez, nullptr, 0, nullptr), a, stream);
  return launch(make_slab_field<false>(slabs, slab, ny, nx, ex, ey, ez, nullptr, 0, nullptr), a, stream);
}
