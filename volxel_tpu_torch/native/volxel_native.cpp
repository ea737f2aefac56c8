// volxel_native — host-side ingest kernels (C++17, no external deps).
//
// Native counterpart of the reference's Rust/WASM preprocessor
// (dicom_preprocessor/src/{lib,brick}.rs), redesigned:
//   * one-pass u16 scan: histogram + min/max (lib.rs:87-102 role)
//   * brick-grid construction (brick.rs:76-205 role): dilated per-brick
//     min/max, constant-brick elision, bump-allocated atlas, range mips —
//     multithreaded over brick slabs (the reference serialized this and
//     left "TODO: this was multithreaded" comments, brick.rs:90,125)
//
// Exposed as a C ABI for ctypes. All 3D buffers are z-major (Z, Y, X),
// matching Buf3D (buf3d.rs:26-28) and the Python side.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int BRICK = 8;
constexpr int DILATE = 2;

// float32 -> IEEE float16 bits (round-to-nearest-even), then back.
// Mirrors the f16 round-trip the reference's encode_range performs
// (brick.rs:19-28 via the `half` crate).
uint16_t f32_to_f16_bits(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000u;
  int32_t exp = (int32_t)((x >> 23) & 0xFF) - 127 + 15;
  uint32_t mant = x & 0x7FFFFFu;
  if (exp <= 0) {
    if (exp < -10) return (uint16_t)sign;  // underflow -> signed zero
    mant |= 0x800000u;
    uint32_t shift = (uint32_t)(14 - exp);
    uint32_t half = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1);
    uint32_t mid = 1u << (shift - 1);
    if (rem > mid || (rem == mid && (half & 1))) half++;
    return (uint16_t)(sign | half);
  }
  if (exp >= 31) return (uint16_t)(sign | 0x7C00u);  // overflow -> inf
  uint32_t half = (uint32_t)(exp << 10) | (mant >> 13);
  uint32_t rem = mant & 0x1FFFu;
  if (rem > 0x1000u || (rem == 0x1000u && (half & 1))) half++;
  return (uint16_t)(sign | half);
}

float f16_bits_to_f32(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FFu;
  uint32_t x;
  if (exp == 0) {
    if (mant == 0) {
      x = sign;
    } else {
      exp = 127 - 15 + 1;
      while (!(mant & 0x400u)) {
        mant <<= 1;
        exp--;
      }
      mant &= 0x3FFu;
      x = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    x = sign | 0x7F800000u | (mant << 13);
  } else {
    x = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}

float f16_round(float f) { return f16_bits_to_f32(f32_to_f16_bits(f)); }

inline int num_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? (int)n : 1;
}

template <typename F>
void parallel_for(int64_t begin, int64_t end, F&& fn) {
  int threads = std::min<int64_t>(num_threads(), end - begin);
  if (threads <= 1) {
    for (int64_t i = begin; i < end; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(begin);
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&] {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= end) return;
        fn(i);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// One-pass u16 pixel scan: accumulate histogram (bins entries) and min/max.
void volxel_scan_u16(const uint16_t* data, int64_t n, uint32_t* histogram,
                     int64_t bins, uint16_t* out_min, uint16_t* out_max) {
  uint16_t lo = 0xFFFF, hi = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint16_t v = data[i];
    if (v < bins) histogram[v]++;
    lo = std::min(lo, v);
    hi = std::max(hi, v);
  }
  *out_min = lo;
  *out_max = hi;
}

// Brick-grid construction from a dense z-major (ez, ey, ex) float volume.
//
// Outputs (caller-allocated):
//   range_lo / range_hi : (bz*by*bx) float, f16-rounded
//   indirection         : (bz*by*bx * 3) int32 (x, y, z), zeros if constant
//   occupied            : (bz*by*bx) uint8 mask
// Returns the occupied-brick count. Atlas fill is a second pass
// (volxel_fill_atlas) once the caller has sized the pruned atlas.
int64_t volxel_brick_ranges(const float* data, int64_t ex, int64_t ey,
                            int64_t ez, int64_t bx, int64_t by, int64_t bz,
                            float* range_lo, float* range_hi,
                            int32_t* indirection, uint8_t* occupied) {
  auto lookup = [&](int64_t x, int64_t y, int64_t z) -> float {
    if (x < 0 || y < 0 || z < 0 || x >= ex || y >= ey || z >= ez) return 0.0f;
    return data[(z * ey + y) * ex + x];
  };

  parallel_for(0, bz, [&](int64_t cz) {
    for (int64_t cy = 0; cy < by; ++cy) {
      for (int64_t cx = 0; cx < bx; ++cx) {
        float lo = 3.4e38f, hi = -3.4e38f;
        // dilated window [-2, BRICK+2)^3 (brick.rs:99-112)
        for (int64_t dz = -DILATE; dz < BRICK + DILATE; ++dz) {
          int64_t z = cz * BRICK + dz;
          for (int64_t dy = -DILATE; dy < BRICK + DILATE; ++dy) {
            int64_t y = cy * BRICK + dy;
            if (z < 0 || z >= ez || y < 0 || y >= ey) {
              // whole x-run may still touch in-bounds x; zeros dominate
              lo = std::min(lo, 0.0f);
              hi = std::max(hi, 0.0f);
              continue;
            }
            for (int64_t dx = -DILATE; dx < BRICK + DILATE; ++dx) {
              float v = lookup(cx * BRICK + dx, y, z);
              lo = std::min(lo, v);
              hi = std::max(hi, v);
            }
          }
        }
        int64_t idx = (cz * by + cy) * bx + cx;
        occupied[idx] = (lo != hi) ? 1 : 0;
        range_lo[idx] = f16_round(lo);
        range_hi[idx] = f16_round(hi);
      }
    }
  });

  // bump allocation in z-major scan order (brick.rs:131-134) — sequential
  // prefix pass (cheap relative to the window scan)
  int64_t counter = 0;
  for (int64_t i = 0; i < bz * by * bx; ++i) {
    if (occupied[i]) {
      int64_t slot = counter++;
      indirection[i * 3 + 0] = (int32_t)(slot % bx);
      indirection[i * 3 + 1] = (int32_t)((slot / bx) % by);
      indirection[i * 3 + 2] = (int32_t)(slot / (bx * by));
    } else {
      indirection[i * 3 + 0] = indirection[i * 3 + 1] = indirection[i * 3 + 2] = 0;
    }
  }
  return counter;
}

// Fill the pruned atlas (az, by*8, bx*8) with u8-encoded voxels
// (brick.rs:137-145): quantized against the decoded f16 ranges.
void volxel_fill_atlas(const float* data, int64_t ex, int64_t ey, int64_t ez,
                       int64_t bx, int64_t by, int64_t bz,
                       const float* range_lo, const float* range_hi,
                       const int32_t* indirection, const uint8_t* occupied,
                       uint8_t* atlas, int64_t az) {
  const int64_t ax = bx * BRICK, ay = by * BRICK;
  (void)az;
  auto lookup = [&](int64_t x, int64_t y, int64_t z) -> float {
    if (x < 0 || y < 0 || z < 0 || x >= ex || y >= ey || z >= ez) return 0.0f;
    return data[(z * ey + y) * ex + x];
  };

  parallel_for(0, bz, [&](int64_t cz) {
    for (int64_t cy = 0; cy < by; ++cy) {
      for (int64_t cx = 0; cx < bx; ++cx) {
        int64_t idx = (cz * by + cy) * bx + cx;
        if (!occupied[idx]) continue;
        float lo = range_lo[idx], hi = range_hi[idx];
        float width = hi - lo;
        int64_t px = (int64_t)indirection[idx * 3 + 0] * BRICK;
        int64_t py = (int64_t)indirection[idx * 3 + 1] * BRICK;
        int64_t pz = (int64_t)indirection[idx * 3 + 2] * BRICK;
        for (int64_t dz = 0; dz < BRICK; ++dz) {
          for (int64_t dy = 0; dy < BRICK; ++dy) {
            for (int64_t dx = 0; dx < BRICK; ++dx) {
              float v = lookup(cx * BRICK + dx, cy * BRICK + dy, cz * BRICK + dz);
              // true f32 division + floor(x+0.5), matching the numpy
              // builder op-for-op (encoding.py encode_voxel) — a
              // reciprocal-multiply or lround can differ by one step on
              // exact .5 boundaries
              float norm = width > 0 ? (v - lo) / width : 0.0f;
              norm = std::min(1.0f, std::max(0.0f, norm));
              if (width <= 0) norm = 0.0f;
              atlas[((pz + dz) * ay + (py + dy)) * ax + (px + dx)] =
                  (uint8_t)std::floor(255.0f * norm + 0.5f);
            }
          }
        }
      }
    }
  });
}

// JPEG lossless (process 14) scan decode: Huffman diffs + prediction.
// Bit-exact counterpart of ingest/jpeg.py::_decode_lossless's inner loop —
// the hot path of compressed CT ingest (the reference decodes via the
// dicom-pixeldata jpeg feature, Cargo.toml:25). `lut` is the Python-built
// 64K peek table: (code length << 16) | symbol for every 16-bit prefix.
// Decodes n_samples starting at flat index start_idx of a (h, w) image.
// Returns samples decoded, or -1 on an invalid Huffman code.
int64_t volxel_jpeg_lossless_chunk(
    const uint8_t* data, int64_t nbytes, const uint32_t* lut, int32_t* out,
    int64_t w, int64_t h, int64_t start_idx, int64_t n_samples,
    int32_t predictor, int32_t default_pred) {
  (void)h;
  int64_t bitpos = 0;
  const int64_t nbits = nbytes * 8;
  bool first_of_interval = true;
  for (int64_t i = 0; i < n_samples; ++i) {
    if (bitpos + 16 > nbits + 64) return -1;  // padded reads past data => bad
    int64_t byte = bitpos >> 3;
    int sh = (int)(bitpos & 7);
    uint32_t win = ((uint32_t)data[byte] << 16) |
                   ((uint32_t)data[byte + 1] << 8) | (uint32_t)data[byte + 2];
    uint32_t peek = (win >> (8 - sh)) & 0xFFFF;
    uint32_t v = lut[peek];
    int len = (int)(v >> 16);
    if (len == 0) return -1;
    int s = (int)(v & 0xFFFF);
    bitpos += len;
    int32_t diff;
    if (s == 16) {
      diff = 32768;
    } else if (s == 0) {
      diff = 0;
    } else {
      byte = bitpos >> 3;
      sh = (int)(bitpos & 7);
      uint64_t win4 = ((uint64_t)data[byte] << 24) |
                      ((uint64_t)data[byte + 1] << 16) |
                      ((uint64_t)data[byte + 2] << 8) |
                      (uint64_t)data[byte + 3];
      uint32_t bits = (uint32_t)((win4 >> (32 - sh - s)) & ((1u << s) - 1));
      bitpos += s;
      // T.81 F.2.2.1 sign extension
      diff = (bits < (1u << (s - 1))) ? (int32_t)bits - (1 << s) + 1
                                      : (int32_t)bits;
    }
    int64_t j = start_idx + i;
    int64_t y = j / w, x = j - y * w;
    int32_t px;
    if (first_of_interval || (y == 0 && x == 0)) {
      px = default_pred;
      first_of_interval = false;
    } else if (y == 0) {
      px = out[j - 1];
    } else if (x == 0) {
      px = out[j - w];
    } else {
      int32_t ra = out[j - 1], rb = out[j - w], rc = out[j - w - 1];
      switch (predictor) {
        case 1: px = ra; break;
        case 2: px = rb; break;
        case 3: px = rc; break;
        case 4: px = ra + rb - rc; break;
        case 5: px = ra + ((rb - rc) >> 1); break;
        case 6: px = rb + ((ra - rc) >> 1); break;
        default: px = (ra + rb) >> 1; break;
      }
    }
    out[j] = (px + diff) & 0xFFFF;
  }
  return n_samples;
}

// OpenEXR ImfHuf entropy decode — the per-symbol loop of
// piz.py:huf_uncompress. `data` is the padded entropy buffer; bits
// [start_bit, end_bit) hold the payload. `lut` has 1<<16 entries of
// (code_len << 32) | symbol for codes up to 16 bits; longer codes are
// looked up in the sorted `long_keys` array (key = code_len << 58 | code)
// with `long_syms` parallel to it. `rlc` is the run-length pseudo-symbol.
// Returns symbols written, or -1 truncated / -2 invalid code / -3 bad run.
int64_t volxel_huf_decode(const uint8_t* data, int64_t start_bit,
                          int64_t end_bit, const uint64_t* lut,
                          const uint64_t* long_keys, const uint32_t* long_syms,
                          int64_t n_long, int64_t rlc, uint16_t* out,
                          int64_t n_out) {
  constexpr int kMaxCodeLen = 58;
  int64_t bitpos = start_bit;
  int64_t k = 0;
  auto read_be64 = [&](int64_t byte) {
    uint64_t w = 0;
    for (int i = 0; i < 8; ++i) w = (w << 8) | data[byte + i];
    return w;
  };
  while (k < n_out) {
    if (bitpos >= end_bit) return -1;
    int64_t byte = bitpos >> 3;
    int sh = (int)(bitpos & 7);
    uint32_t peek = (uint32_t)(((((uint32_t)data[byte] << 16) |
                                 ((uint32_t)data[byte + 1] << 8) |
                                 (uint32_t)data[byte + 2]) >>
                                (8 - sh)) &
                               0xFFFFu);
    uint64_t v = lut[peek];
    int64_t len = (int64_t)(v >> 32);
    uint32_t sym;
    if (len) {
      sym = (uint32_t)(v & 0xFFFFFFFFu);
      bitpos += len;
    } else {
      // long code (>16 bits): extend bit by bit against the sorted keys
      uint64_t w = read_be64(byte);
      uint64_t w2 = ((uint64_t)data[byte + 8] << 8) | data[byte + 9];
      // top 80 bits from `byte` as one value; codes start sh bits in
      unsigned __int128 window = ((unsigned __int128)w << 16) | w2;
      int total = 72 - sh;  // bits available past sh within the first 9 bytes
      bool found = false;
      sym = 0;
      for (int l = 17; l <= kMaxCodeLen && l <= total; ++l) {
        uint64_t code =
            (uint64_t)(window >> (80 - sh - l)) & ((1ull << l) - 1);
        uint64_t key = ((uint64_t)l << kMaxCodeLen) | code;
        const uint64_t* lo = long_keys;
        const uint64_t* hi = long_keys + n_long;
        const uint64_t* it = std::lower_bound(lo, hi, key);
        if (it != hi && *it == key) {
          sym = long_syms[it - lo];
          bitpos += l;
          found = true;
          break;
        }
      }
      if (!found) return -2;
    }
    if ((int64_t)sym == rlc) {
      int64_t rb = bitpos >> 3;
      int rsh = (int)(bitpos & 7);
      uint32_t run =
          ((((uint32_t)data[rb] << 8) | (uint32_t)data[rb + 1]) >>
           (8 - rsh)) &
          0xFFu;
      bitpos += 8;
      if (k == 0 || k + (int64_t)run > n_out) return -3;
      uint16_t prev = out[k - 1];
      for (uint32_t i = 0; i < run; ++i) out[k + i] = prev;
      k += run;
    } else {
      out[k] = (uint16_t)sym;
      k += 1;
    }
  }
  return k;
}

// Full ImfHuf decode: header + code-length table + canonical codes +
// decode LUT + the symbol loop above, all native (the per-chunk table
// build in Python dominated large PIZ decodes). `data`/`data_len` is the
// complete huf blob (20-byte header first) padded with >=16 zero bytes by
// the caller beyond data_len. Same return convention as volxel_huf_decode,
// plus -4 for a corrupt header/table.
int64_t volxel_huf_uncompress(const uint8_t* data, int64_t data_len,
                              uint16_t* out, int64_t n_out) {
  constexpr int kEncSize = 65537;
  constexpr int kMaxCodeLen = 58;
  constexpr int kShortZerorun = 59;
  constexpr int kLongZerorun = 63;
  constexpr int kShortestLongRun = 2 + kLongZerorun - kShortZerorun;
  if (data_len < 20) return -4;
  auto rd32 = [&](int64_t off) {
    return (uint32_t)data[off] | ((uint32_t)data[off + 1] << 8) |
           ((uint32_t)data[off + 2] << 16) | ((uint32_t)data[off + 3] << 24);
  };
  int64_t im = rd32(0), iM = rd32(4);
  int64_t n_bits = rd32(12);
  if (im < 0 || im >= kEncSize || iM < 0 || iM >= kEncSize) return -4;

  const uint8_t* tbl = data + 20;
  // bit reader (big-endian), mirrors piz.py _BitReader
  int64_t pos = 0;
  auto read_bits = [&](int n) -> uint32_t {
    int64_t byte = pos >> 3;
    int sh = (int)(pos & 7);
    uint64_t w = 0;
    for (int i = 0; i < 8; ++i) w = (w << 8) | tbl[byte + i];
    pos += n;
    return (uint32_t)((w >> (64 - sh - n)) & ((1u << n) - 1));
  };

  std::vector<int32_t> lengths(kEncSize, 0);
  // read_bits fetches an 8-byte window at tbl[pos>>3]; the caller pads the
  // buffer with >=16 zero bytes past data_len, so reserving the window keeps
  // every fetch (including the follow-on 8-bit zero-run read below, which can
  // advance pos by 6 first) inside the padded allocation.
  int64_t max_table_bits = (data_len - 20 + 8) * 8;
  for (int64_t i = im; i <= iM;) {
    if (pos >= max_table_bits) return -4;
    uint32_t l = read_bits(6);
    if (l == kLongZerorun) {
      if (pos >= max_table_bits) return -4;
      i += read_bits(8) + kShortestLongRun;
    } else if (l >= kShortZerorun) {
      i += l - kShortZerorun + 2;
    } else {
      lengths[i] = (int32_t)l;
      i += 1;
    }
    if (i > iM + 1) return -4;
  }

  // canonical codes (hufCanonicalCodeTable)
  uint64_t n_per_len[59] = {0};
  for (int64_t s = im; s <= iM; ++s)
    if (lengths[s] > 0) n_per_len[lengths[s]]++;
  uint64_t c = 0, start[59] = {0};
  for (int i = 58; i > 0; --i) {
    uint64_t nc = (c + n_per_len[i]) >> 1;
    start[i] = c;
    c = nc;
  }
  std::vector<uint64_t> lut(1u << 16, 0);
  std::vector<uint64_t> long_keys;
  std::vector<uint32_t> long_syms;
  {
    uint64_t counters[59];
    std::memcpy(counters, start, sizeof(start));
    for (int64_t s = im; s <= iM; ++s) {
      int l = lengths[s];
      if (l <= 0) continue;
      uint64_t code = counters[l]++;
      if (l <= 16) {
        uint64_t lo = code << (16 - l);
        uint64_t hi = lo + (1ull << (16 - l));
        if (hi > (1u << 16)) return -4;
        uint64_t v = ((uint64_t)l << 32) | (uint64_t)s;
        for (uint64_t j = lo; j < hi; ++j) lut[j] = v;
      } else {
        if (l > kMaxCodeLen) return -4;
        long_keys.push_back(((uint64_t)l << kMaxCodeLen) | code);
        long_syms.push_back((uint32_t)s);
      }
    }
    // canonical construction emits codes sorted by (length asc, sym asc);
    // key order needs a sort since length is the high field
    std::vector<size_t> order(long_keys.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](size_t a, size_t b) {
      return long_keys[a] < long_keys[b];
    });
    std::vector<uint64_t> sk(long_keys.size());
    std::vector<uint32_t> ss(long_syms.size());
    for (size_t i = 0; i < order.size(); ++i) {
      sk[i] = long_keys[order[i]];
      ss[i] = long_syms[order[i]];
    }
    long_keys.swap(sk);
    long_syms.swap(ss);
  }

  int64_t base = (pos + 7) & ~7ll;  // entropy data starts byte-aligned
  // n_bits is attacker-controlled; volxel_huf_decode reads up to 10 bytes at
  // the current bit position (and the RLE branch up to ~8 bytes past end_bit),
  // so the end bit must leave that window inside the 16-byte-padded buffer:
  // max read byte = (end_bit-1)/8 + 9 <= data_len - 20 + 15.
  if (n_bits < 0 || base + n_bits > (data_len - 20 + 7) * 8) return -4;
  return volxel_huf_decode(tbl, base, base + n_bits, lut.data(),
                           long_keys.data(), long_syms.data(),
                           (int64_t)long_keys.size(), iM, out, n_out);
}

}  // extern "C"
