// The per-ray RNG (random.glsl:41-106): TEA seeding of xoshiro128++ states
// and their draws.
//
// Replaces the plain version volxel_tpu_torch/render/rng.py (seed_rays,
// rng, rng2, rng3 and their *_where forms), which carries each 32-bit word
// in an int64 tensor and takes ~22 masked int64 ops a TEA round, ~40 a
// draw and a torch.where a masked draw, each a kernel over 16 MB arrays.
// The JAX package's volxel_tpu/render/rng.py is plain jnp: there is no TPU
// kernel behind this file.
//
// What bounds it on an H100: a seeding reads the pixel indices (8 B a lane)
// and writes the four words (32 B), 83 MB at 1080p, 0.025 ms at 3.35 TB/s;
// its 32 TEA rounds are ~420 integer instructions a lane. A draw reads and
// writes the words (64 B a lane), the mask (1 B) and 4-12 B of floats.
//
// Design: one thread a lane, the four words in registers from load to
// store; one launch a seeding and one a draw call. The state stays an
// (..., 4) int64 tensor of words in [0, 2^32), as the legs and the callers
// take it; a lane's 32 bytes are loaded and stored as two 16-byte words.
// The xoshiro step and its float are leg_common.cuh's next_float, so the
// legs and this file draw one stream. The only float op is
// float(r >> 8) * 2^-24, exact, so --fmad does not matter. A masked draw
// writes the value on every lane and stores the old words where the mask
// is false, as the plain torch.where does: its outputs are bit-equal to the
// plain version's at every lane.

#include "leg_common.cuh"

namespace {

__device__ __forceinline__ uint32_t tea(uint32_t v0, uint32_t v1) {
  uint32_t s0 = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s0 += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  return v0;
}

__device__ __forceinline__ long long wang_hash(uint32_t x) {
  x = (x ^ 61u) ^ (x >> 16);
  x *= 9u;
  x ^= x >> 4;
  x *= 0x27D4EB2Du;
  x ^= x >> 15;
  return static_cast<long long>(x);
}

__device__ __forceinline__ long long lane_index() {
  return static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
}

// state[i] = the xoshiro words of tea(42 * pixel[i], frame) expanded by
// Wang hashes of seed + 0..3; frame is frame[i] or, without a frame array,
// frame_word
template <typename P, typename F>
__global__ void __launch_bounds__(kThreads)
    rng_seed_kernel(const P* __restrict__ pixel, const F* __restrict__ frame, uint32_t frame_word,
                    longlong2* __restrict__ state, long long n) {
  const long long i = lane_index();
  if (i >= n) return;
  const uint32_t f = frame != nullptr ? static_cast<uint32_t>(frame[i]) : frame_word;
  const uint32_t seed = tea(42u * static_cast<uint32_t>(pixel[i]), f);
  state[2 * i] = make_longlong2(wang_hash(seed), wang_hash(seed + 1u));
  state[2 * i + 1] = make_longlong2(wang_hash(seed + 2u), wang_hash(seed + 3u));
}

// K draws a lane: out[i * K + k] the k-th float; state_out[i] the advanced
// words, or state[i] where mask (when given) is false there
template <int K>
__global__ void __launch_bounds__(kThreads)
    rng_draw_kernel(const longlong2* __restrict__ state, const uint8_t* __restrict__ mask,
                    longlong2* __restrict__ state_out, float* __restrict__ out, long long n) {
  const long long i = lane_index();
  if (i >= n) return;
  const longlong2 a = state[2 * i];
  const longlong2 b = state[2 * i + 1];
  uint32_t s[4] = {static_cast<uint32_t>(a.x), static_cast<uint32_t>(a.y), static_cast<uint32_t>(b.x),
                   static_cast<uint32_t>(b.y)};
#pragma unroll
  for (int k = 0; k < K; ++k) out[K * i + k] = next_float(s);
  if (mask == nullptr || mask[i]) {
    state_out[2 * i] = make_longlong2(s[0], s[1]);
    state_out[2 * i + 1] = make_longlong2(s[2], s[3]);
  } else {
    state_out[2 * i] = a;
    state_out[2 * i + 1] = b;
  }
}

template <typename P>
void launch_seed(const P* pixel, const void* frame, int frame_bytes, uint32_t frame_word, longlong2* state,
                 long long n, cudaStream_t stream) {
  if (frame_bytes == 4) {
    rng_seed_kernel<<<blocks_for(n), kThreads, 0, stream>>>(pixel, static_cast<const int*>(frame), frame_word,
                                                            state, n);
  } else {
    rng_seed_kernel<<<blocks_for(n), kThreads, 0, stream>>>(pixel, static_cast<const long long*>(frame),
                                                            frame_word, state, n);
  }
}

}  // namespace

// pixel: n int32 (pixel_bytes 4) or int64 (8) indices; frame: null (every
// lane takes frame_word) or n int32 / int64 frames (frame_bytes); state:
// (n, 4) int64, 16-byte aligned
extern "C" int vx_rng_seed(const void* pixel, int pixel_bytes, const void* frame, int frame_bytes,
                           unsigned frame_word, long long* state, long long n, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if ((pixel_bytes != 4 && pixel_bytes != 8) || (frame != nullptr && frame_bytes != 4 && frame_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* words = reinterpret_cast<longlong2*>(state);
  if (pixel_bytes == 4) {
    launch_seed(static_cast<const int*>(pixel), frame, frame_bytes, frame_word, words, n, stream);
  } else {
    launch_seed(static_cast<const long long*>(pixel), frame, frame_bytes, frame_word, words, n, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// state, state_out: (n, 4) int64, 16-byte aligned; mask: null or n bools;
// out: (n, k) f32, k in 1..3
extern "C" int vx_rng_draw(const long long* state, const uint8_t* mask, long long* state_out, float* out, int k,
                           long long n, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const auto* in = reinterpret_cast<const longlong2*>(state);
  auto* words = reinterpret_cast<longlong2*>(state_out);
  switch (k) {
    case 1:
      rng_draw_kernel<1><<<blocks_for(n), kThreads, 0, stream>>>(in, mask, words, out, n);
      break;
    case 2:
      rng_draw_kernel<2><<<blocks_for(n), kThreads, 0, stream>>>(in, mask, words, out, n);
      break;
    case 3:
      rng_draw_kernel<3><<<blocks_for(n), kThreads, 0, stream>>>(in, mask, words, out, n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
