// PPMd var.I (PPMd8) decoder — native port of volxel_tpu/ingest/ppmd.py.
//
// The Python model is the behavioral spec: it is verified
// function-by-function against the canonical Ppmd8 decoder bundled in
// libarchive (tests/test_ppmd.py, examples/ppmd_differential.py), and
// this port must match it byte-for-byte — pinned by the
// native-vs-Python differential in tests/test_ppmd.py. Pure-Python
// decode runs ~10-20 KB/s, far too slow for real method-98 DICOM
// archives; this decoder is the ingest path, the Python one stays as
// the reference/fallback (and the encoder, used by tests only, stays
// Python).
//
// Entry point (ctypes):
//   int64_t volxel_ppmd_decompress(src, src_len, order, mem_mb,
//                                  restore_method, out, out_cap)
//   returns bytes written; negative on error:
//     -1 corrupt stream (bad symbol/escape threshold, or the model left
//        the valid region — the canonical implementation's
//        CUT_OFF/FREEZE undefined-behavior edge case)
//     -3 unexpected end marker before out_cap bytes (caller passes the
//        exact member size as out_cap and expects it to be reached)
//     -4 bad parameters / allocation failure (reserved: -2)

#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace {

constexpr int UNIT_SIZE = 12;
constexpr int N_INDEXES = 38;
constexpr int MAX_FREQ = 124;
constexpr int INT_BITS = 7;
constexpr int PERIOD_BITS = 7;
constexpr uint32_t BIN_SCALE = 1u << (INT_BITS + PERIOD_BITS);

constexpr uint32_t TOP = 1u << 24;
constexpr uint32_t BOT = 1u << 15;

const uint16_t K_INIT_BIN_ESC[8] = {0x3CDD, 0x1F3F, 0x59BF, 0x48F3,
                                    0x64A1, 0x5ABC, 0x6632, 0x6051};
const uint8_t EXP_ESCAPE[16] = {25, 14, 9, 7, 5, 5, 4, 4,
                                4,  3,  3, 3, 2, 2, 2, 2};

struct Tables {
  uint32_t i2u[N_INDEXES];
  uint8_t u2i[128];
  uint8_t ns2indx[260];
  uint8_t ns2bsindx[256];
  Tables() {
    int k = 0;
    for (int i = 0; i < N_INDEXES; ++i) {
      int step = i >= 12 ? 4 : (i >> 2) + 1;
      for (int s = 0; s < step; ++s) u2i[k++] = (uint8_t)i;
      i2u[i] = (uint32_t)k;
    }
    for (int i = 0; i < 5; ++i) ns2indx[i] = (uint8_t)i;
    int m = 5, kk = 1;
    for (int i = 5; i < 260; ++i) {
      ns2indx[i] = (uint8_t)m;
      if (--kk == 0) {
        ++m;
        kk = m - 4;
      }
    }
    for (int i = 0; i < 256; ++i)
      ns2bsindx[i] = i == 0 ? 0 : (i == 1 ? 2 : (i < 11 ? 4 : 6));
  }
};
const Tables T;

// ---------------------------------------------------------------------------
// Subbotin carryless range decoder (ppmd.py _RangeDecoder)
// ---------------------------------------------------------------------------

struct RangeDec {
  const uint8_t* data;
  int64_t len, pos;
  uint32_t low, range, code;
  bool bad = false;  // zero-width symbol / zero total on a corrupt stream

  void init(const uint8_t* d, int64_t n) {
    data = d;
    len = n;
    pos = 0;
    low = 0;
    range = 0xFFFFFFFFu;
    code = 0;
    for (int i = 0; i < 4; ++i) code = (code << 8) | byte();
  }
  uint8_t byte() { return pos < len ? data[pos++] : 0; }
  void normalize() {
    while (true) {
      if (((low ^ (low + range))) < TOP) {
      } else if (range < BOT) {
        range = (0u - low) & (BOT - 1);
      } else {
        break;
      }
      code = (code << 8) | byte();
      low <<= 8;
      range <<= 8;
    }
  }
  uint32_t threshold(uint32_t total) {
    // garbage contexts on corrupt streams can carry total == 0, and an
    // inflated escape freq_sum can exceed the normalized range — either
    // would divide by zero. Returning UINT32_MAX makes every caller
    // take its >= total corrupt branch.
    if (total == 0) {
      bad = true;
      return 0xFFFFFFFFu;
    }
    range /= total;
    if (range == 0) return 0xFFFFFFFFu;
    return (code - low) / range;
  }
  void decode(uint32_t start, uint32_t size) {
    if (size == 0) {
      // range would collapse to 0 and normalize() would never terminate
      bad = true;
      return;
    }
    low += start * range;
    range *= size;
    normalize();
  }
  int decode_bit(uint32_t size0) {
    uint32_t r = range >> 14;
    uint32_t bound = r * size0;
    if ((code - low) < bound) {
      range = bound;
      normalize();
      return 0;
    }
    low += bound;
    range = r * (BIN_SCALE - size0);
    normalize();
    return 1;
  }
};

// ---------------------------------------------------------------------------
// Model (ppmd.py _Pool + _Model). One flat pool; node layouts identical:
//   state (6B): symbol u8 | freq u8 | successor u32le
//   context (12B): num_stats u8 (count-1) | flags u8 | summ u16 |
//                  stats u32 | suffix u32  (one-state inline at +2)
//   free node: stamp 0xFFFFFFFF @0 | next u32 @4 | nu u32 @8
// ---------------------------------------------------------------------------

struct Model {
  uint8_t* mem = nullptr;
  int64_t size = 0;
  uint32_t free_list[N_INDEXES];
  uint32_t stamps[N_INDEXES];  // free-node counts (canonical Stamps)
  bool corrupt = false;  // model left the valid region (canonical UB)
  int glue_count = 0;
  uint32_t text = 0, units_start = 0, lo_unit = 0, hi_unit = 0;

  int order = 0;
  int restore_method = 0;
  uint32_t min_context = 0, max_context = 0, found_state = 0;
  int order_fall = 0;
  int32_t init_rl = 0, run_length = 0;
  int prev_success = 0;
  int init_esc = 0;

  uint16_t see_summ[24][32];
  uint8_t see_shift[24][32];
  uint8_t see_count[24][32];
  uint16_t bin_summ[25][64];

  ~Model() { std::free(mem); }

  // -- raw accessors. Bounds-guarded: a CUT_OFF/FREEZE edge case can
  // leave stale refs whose deref the CANONICAL implementation does as
  // undefined behavior; we flag `corrupt` instead and the decode loop
  // returns a typed error (mirrors the Python model's IndexError path).
  bool oob(uint32_t o, uint32_t n) {
    if ((int64_t)o + n > size) {
      corrupt = true;
      return true;
    }
    return false;
  }
  uint32_t rd32(uint32_t o) {
    if (oob(o, 4)) return 0;
    uint32_t v;
    std::memcpy(&v, mem + o, 4);
    return v;
  }
  void wr32(uint32_t o, uint32_t v) {
    if (oob(o, 4)) return;
    std::memcpy(mem + o, &v, 4);
  }
  uint16_t rd16(uint32_t o) {
    if (oob(o, 2)) return 0;
    uint16_t v;
    std::memcpy(&v, mem + o, 2);
    return v;
  }
  void wr16(uint32_t o, uint16_t v) {
    if (oob(o, 2)) return;
    std::memcpy(mem + o, &v, 2);
  }
  uint8_t rd8(uint32_t o) {
    if (oob(o, 1)) return 0;
    return mem[o];
  }
  void wr8(uint32_t o, uint8_t v) {
    if (oob(o, 1)) return;
    mem[o] = v;
  }

  uint8_t ctx_num_stats(uint32_t c) { return rd8(c); }
  void set_ctx_num_stats(uint32_t c, uint8_t v) { wr8(c, v); }
  uint8_t ctx_flags(uint32_t c) { return rd8(c + 1); }
  void set_ctx_flags(uint32_t c, uint8_t v) { wr8(c + 1, v); }
  uint16_t ctx_summ(uint32_t c) { return rd16(c + 2); }
  void set_ctx_summ(uint32_t c, uint32_t v) { wr16(c + 2, (uint16_t)v); }
  uint32_t ctx_stats(uint32_t c) { return rd32(c + 4); }
  void set_ctx_stats(uint32_t c, uint32_t v) { wr32(c + 4, v); }
  uint32_t ctx_suffix(uint32_t c) { return rd32(c + 8); }
  void set_ctx_suffix(uint32_t c, uint32_t v) { wr32(c + 8, v); }
  uint32_t one_state(uint32_t c) const { return c + 2; }

  uint8_t st_sym(uint32_t s) { return rd8(s); }
  void set_st_sym(uint32_t s, uint8_t v) { wr8(s, v); }
  uint8_t st_freq(uint32_t s) { return rd8(s + 1); }
  void set_st_freq(uint32_t s, uint8_t v) { wr8(s + 1, v); }
  uint32_t st_succ(uint32_t s) { return rd32(s + 2); }
  void set_st_succ(uint32_t s, uint32_t v) { wr32(s + 2, v); }
  void copy_state(uint32_t dst, uint32_t src) {
    if (oob(dst, 6) || oob(src, 6)) return;
    std::memmove(mem + dst, mem + src, 6);
  }
  void swap_states(uint32_t a, uint32_t b) {
    if (oob(a, 6) || oob(b, 6)) return;
    uint8_t tmp[6];
    std::memcpy(tmp, mem + a, 6);
    std::memcpy(mem + a, mem + b, 6);
    std::memcpy(mem + b, tmp, 6);
  }
  uint32_t stats_addr(uint32_t c, uint32_t i = 0) {
    return ctx_stats(c) + 6 * i;
  }

  // -- suballocator (ppmd.py _Pool) ----------------------------------------
  void pool_init() {
    for (int i = 0; i < N_INDEXES; ++i) free_list[i] = 0;
    for (int i = 0; i < N_INDEXES; ++i) stamps[i] = 0;
    text = 0;
    hi_unit = (uint32_t)size;
    uint32_t diff = UNIT_SIZE * (uint32_t)(size / 8 / UNIT_SIZE * 7);
    lo_unit = units_start = hi_unit - diff;
    glue_count = 0;
  }
  void push_node(uint32_t ref, int indx) {
    wr32(ref, 0xFFFFFFFFu);
    wr32(ref + 4, free_list[indx]);
    wr32(ref + 8, T.i2u[indx]);
    free_list[indx] = ref;
    ++stamps[indx];
  }
  uint32_t pop_node(int indx) {
    uint32_t ref = free_list[indx];
    free_list[indx] = rd32(ref + 4);
    --stamps[indx];
    return ref;
  }
  void split_block(uint32_t ref, int old_indx, int new_indx) {
    uint32_t nu = T.i2u[old_indx] - T.i2u[new_indx];
    uint32_t p = ref + T.i2u[new_indx] * UNIT_SIZE;
    int i = T.u2i[nu - 1];
    if (T.i2u[i] != nu) {
      uint32_t k = T.i2u[i - 1];
      push_node(p + k * UNIT_SIZE, (int)(nu - k - 1));
      nu = k;
      i = T.u2i[nu - 1];
    }
    push_node(p, i);
  }
  void glue_free_blocks() {
    glue_count = 0x2000;
    for (int i = 0; i < N_INDEXES; ++i) stamps[i] = 0;
    if (lo_unit != hi_unit) wr32(lo_unit, 0);
    // collect + glue (ppmd.py glue_free_blocks; disassembly 0x221c9)
    // the chain uses the node next fields in place; gather refs first
    uint32_t out_cap = 0;
    for (int i = 0; i < N_INDEXES; ++i) {
      uint32_t r = free_list[i];
      while (r) {
        ++out_cap;
        r = rd32(r + 4);
      }
    }
    uint32_t* out = (uint32_t*)std::malloc(sizeof(uint32_t) * (out_cap + 1));
    uint32_t n_out = 0;
    for (int i = 0; i < N_INDEXES; ++i) {
      uint32_t ref = free_list[i];
      free_list[i] = 0;
      while (ref) {
        uint32_t nxt = rd32(ref + 4);
        uint32_t nu = rd32(ref + 8);
        if (nu) {
          out[n_out++] = ref;
          while (true) {
            uint32_t adj = ref + nu * UNIT_SIZE;
            if ((int64_t)adj + 12 > size || rd32(adj) != 0xFFFFFFFFu) break;
            uint32_t anu = rd32(adj + 8);
            if (anu == 0) break;
            nu += anu;
            wr32(adj + 8, 0);
            wr32(ref + 8, nu);
          }
        }
        ref = nxt;
      }
    }
    for (uint32_t j = 0; j < n_out; ++j) {
      uint32_t ref = out[j];
      uint32_t sz = rd32(ref + 8);
      if (!sz) continue;
      uint32_t pos = ref;
      while (sz > 128) {
        push_node(pos, N_INDEXES - 1);
        sz -= 128;
        pos += 128 * UNIT_SIZE;
      }
      int i = T.u2i[sz - 1];
      if (T.i2u[i] != sz) {
        --i;
        uint32_t k = sz - T.i2u[i];
        push_node(pos + (sz - k) * UNIT_SIZE, (int)k - 1);
      }
      push_node(pos, i);
    }
    std::free(out);
  }
  uint32_t alloc_units_rare(int indx) {
    if (glue_count == 0) {
      glue_free_blocks();
      if (free_list[indx]) return pop_node(indx);
    }
    int i = indx;
    while (true) {
      if (++i == N_INDEXES) {
        uint32_t num_bytes = T.i2u[indx] * UNIT_SIZE;
        --glue_count;
        if (units_start - text > num_bytes) {
          units_start -= num_bytes;
          return units_start;
        }
        return 0;
      }
      if (free_list[i]) break;
    }
    uint32_t ref = pop_node(i);
    split_block(ref, i, indx);
    return ref;
  }
  uint32_t alloc_units(int indx) {
    if (free_list[indx]) return pop_node(indx);
    uint32_t num_bytes = T.i2u[indx] * UNIT_SIZE;
    if (num_bytes <= hi_unit - lo_unit) {
      uint32_t ref = lo_unit;
      lo_unit += num_bytes;
      return ref;
    }
    return alloc_units_rare(indx);
  }
  uint32_t alloc_context() {
    if (hi_unit != lo_unit) {
      hi_unit -= UNIT_SIZE;
      return hi_unit;
    }
    if (free_list[0]) return pop_node(0);
    return alloc_units_rare(0);
  }
  uint32_t shrink_units(uint32_t old_ref, uint32_t old_nu, uint32_t new_nu) {
    int i0 = T.u2i[old_nu - 1];
    int i1 = T.u2i[new_nu - 1];
    if (i0 == i1) return old_ref;
    if (free_list[i1]) {
      uint32_t ref = pop_node(i1);
      std::memcpy(mem + ref, mem + old_ref, (size_t)new_nu * UNIT_SIZE);
      push_node(old_ref, i0);
      return ref;
    }
    split_block(old_ref, i0, i1);
    return old_ref;
  }
  uint32_t expand_units(uint32_t old_ref, uint32_t old_nu) {
    int i0 = T.u2i[old_nu - 1];
    int i1 = T.u2i[old_nu];
    if (i0 == i1) return old_ref;
    uint32_t ref = alloc_units(i1);
    if (ref) {
      std::memcpy(mem + ref, mem + old_ref, (size_t)old_nu * UNIT_SIZE);
      push_node(old_ref, i0);
    }
    return ref;
  }
  void free_units(uint32_t ref, uint32_t nu) { push_node(ref, T.u2i[nu - 1]); }

  // -- model lifecycle (ppmd.py restart) -----------------------------------
  bool init(int ord, int64_t mem_bytes, int restore) {
    if (ord < 2 || ord > 16) return false;
    order = ord;
    restore_method = restore;
    size = mem_bytes;
    mem = (uint8_t*)std::calloc((size_t)size, 1);
    if (!mem) return false;
    restart();
    return true;
  }

  void restart() {
    pool_init();
    order_fall = order;
    init_rl = -(order < 12 ? order : 12) - 1;
    run_length = init_rl;
    prev_success = 0;
    init_esc = 0;

    uint32_t c = alloc_context();
    min_context = max_context = c;
    set_ctx_suffix(c, 0);
    set_ctx_num_stats(c, 255);
    set_ctx_flags(c, 0);
    set_ctx_summ(c, 256 + 1);
    uint32_t stats = lo_unit;
    lo_unit += (256 / 2) * UNIT_SIZE;
    set_ctx_stats(c, stats);
    for (int i = 0; i < 256; ++i) {
      uint32_t s = stats + 6 * i;
      set_st_sym(s, (uint8_t)i);
      set_st_freq(s, 1);
      set_st_succ(s, 0);
    }
    found_state = stats;

    int k = 0;
    for (int row = 0; row < 25; ++row) {
      while (T.ns2indx[k] == row) ++k;
      for (int col8 = 0; col8 < 8; ++col8) {
        uint16_t val =
            (uint16_t)(BIN_SCALE - K_INIT_BIN_ESC[col8] / (uint32_t)(k + 1));
        for (int m = 0; m < 64; m += 8) bin_summ[row][col8 + m] = val;
      }
    }
    k = 0;
    for (int row = 0; row < 24; ++row) {
      uint8_t v = T.ns2indx[3 + k];
      ++k;
      while (3 + k < 260 && T.ns2indx[3 + k] == v) ++k;
      uint16_t summ = (uint16_t)((2 * k + 5) << (PERIOD_BITS - 4));
      for (int col = 0; col < 32; ++col) {
        see_summ[row][col] = summ;
        see_shift[row][col] = PERIOD_BITS - 4;
        see_count[row][col] = 7;
      }
    }
  }

  // -- create_successors (ppmd.py) -----------------------------------------
  uint32_t create_successors(bool skip, uint32_t s1, uint32_t start) {
    uint32_t c = start ? start : min_context;
    uint32_t up_branch = st_succ(found_state);
    uint8_t fsym = st_sym(found_state);
    uint32_t ps[64];
    int n_ps = 0;
    int hops = 0;
    if (!skip) ps[n_ps++] = found_state;
    while (ctx_suffix(c)) {
      if (++hops > 1 << 16) {  // suffix cycle in a garbage model
        corrupt = true;
        return 0;
      }
      c = ctx_suffix(c);
      uint32_t s;
      if (s1) {
        s = s1;
        s1 = 0;
      } else if (ctx_num_stats(c) != 0) {
        s = stats_addr(c);
        {
          int steps = 0;
          while (st_sym(s) != fsym && !corrupt && ++steps < 4096) s += 6;
          if (steps >= 4096) corrupt = true;
        }
        if (st_freq(s) < MAX_FREQ - 9) {
          set_st_freq(s, st_freq(s) + 1);
          set_ctx_summ(c, ctx_summ(c) + 1);
        }
      } else {
        s = one_state(c);
        if (st_freq(s) <= 23 && ctx_num_stats(ctx_suffix(c)) == 0)
          set_st_freq(s, st_freq(s) + 1);
      }
      uint32_t successor = st_succ(s);
      if (successor != up_branch) {
        c = successor;
        if (n_ps == 0) return c;
        break;
      }
      if (n_ps < 64) ps[n_ps++] = s;
    }

    uint8_t up_symbol = mem[up_branch];
    uint32_t up_successor = up_branch + 1;
    uint8_t flags =
        (uint8_t)((up_symbol >= 0x40 ? 0x08 : 0) + (fsym >= 0x40 ? 0x10 : 0));

    uint32_t up_freq;
    if (ctx_num_stats(c) == 0) {
      up_freq = st_freq(one_state(c));
    } else {
      uint32_t s = stats_addr(c);
      {
        int steps = 0;
        while (st_sym(s) != up_symbol && !corrupt && ++steps < 4096) s += 6;
        if (steps >= 4096) corrupt = true;
      }
      uint32_t cf = (uint32_t)st_freq(s) - 1;
      uint32_t s0 = (uint32_t)ctx_summ(c) - ctx_num_stats(c) - cf;
      up_freq = 1 + (2 * cf <= s0 ? (uint32_t)(5 * cf > s0)
                                  : (2 * s0 + cf - 3) / s0);
    }

    for (int i = n_ps - 1; i >= 0; --i) {
      uint32_t c1 = alloc_context();
      if (!c1) return 0;
      set_ctx_num_stats(c1, 0);
      set_ctx_flags(c1, flags);
      uint32_t one = one_state(c1);
      set_st_sym(one, up_symbol);
      set_st_freq(one, (uint8_t)up_freq);
      set_st_succ(one, up_successor);
      set_ctx_suffix(c1, c);
      set_st_succ(ps[i], c1);
      c = c1;
    }
    return c;
  }

  // -- rescale (ppmd.py) ---------------------------------------------------
  void rescale() {
    uint32_t c = min_context;
    uint32_t stats = stats_addr(c);
    uint32_t s = found_state;
    if (s != stats) {
      uint8_t tmp[6];
      std::memcpy(tmp, mem + s, 6);
      while (s != stats) {
        copy_state(s, s - 6);
        s -= 6;
      }
      std::memcpy(mem + stats, tmp, 6);
    }
    s = stats;
    int32_t esc_freq = (int32_t)ctx_summ(c) - st_freq(s);
    set_st_freq(s, st_freq(s) + 4);
    int adder = order_fall != 0 ? 1 : 0;
    set_st_freq(s, (uint8_t)((st_freq(s) + adder) >> 1));
    uint32_t sum_freq = st_freq(s);
    uint32_t num_stats = (uint32_t)ctx_num_stats(c) + 1;
    for (uint32_t i = 0; i < num_stats - 1; ++i) {
      s += 6;
      esc_freq -= st_freq(s);
      set_st_freq(s, (uint8_t)((st_freq(s) + adder) >> 1));
      sum_freq += st_freq(s);
      if (st_freq(s) > st_freq(s - 6)) {
        uint32_t s1 = s;
        uint8_t tmp[6];
        std::memcpy(tmp, mem + s1, 6);
        uint8_t tf = tmp[1];
        while (s1 != stats && tf > st_freq(s1 - 6)) {
          copy_state(s1, s1 - 6);
          s1 -= 6;
        }
        std::memcpy(mem + s1, tmp, 6);
      }
    }
    if (st_freq(s) == 0) {
      uint32_t i = 0;
      while (st_freq(s) == 0) {
        ++i;
        s -= 6;
      }
      esc_freq += (int32_t)i;
      uint32_t new_count = num_stats - i;
      set_ctx_num_stats(c, (uint8_t)(new_count - 1));
      if (new_count == 1) {
        // modern Ppmd8 collapse (pinned by the differential harness):
        // freq = ceil(2*freq / esc_freq) capped at MAX_FREQ/3; flags
        // keep 0x10 and recompute 0x08 from the surviving symbol
        uint8_t tmp[6];
        std::memcpy(tmp, mem + stats, 6);
        uint32_t freq = (2u * tmp[1] + (uint32_t)esc_freq - 1) /
                        (uint32_t)esc_freq;
        if (freq > MAX_FREQ / 3) freq = MAX_FREQ / 3;
        tmp[1] = (uint8_t)freq;
        free_units(stats, (num_stats + 1) >> 1);
        uint32_t one = one_state(c);
        std::memcpy(mem + one, tmp, 6);
        set_ctx_flags(c, (uint8_t)((ctx_flags(c) & 0x10) +
                                   (tmp[0] >= 0x40 ? 0x08 : 0)));
        found_state = one;
        return;
      }
      uint32_t n0 = (num_stats + 1) >> 1;
      uint32_t n1 = (new_count + 1) >> 1;
      if (n0 != n1) set_ctx_stats(c, shrink_units(stats, n0, n1));
    }
    set_ctx_summ(c, sum_freq + (uint32_t)esc_freq - ((uint32_t)esc_freq >> 1));
    set_ctx_flags(c, ctx_flags(c) | 0x04);
    found_state = stats_addr(c);
  }

  // -- memory-exhaustion restoration (ppmd.py restore_model/cut_off;
  //    canonical 0x22f40/0x22b90) ------------------------------------------
  void special_free_unit(uint32_t ref) {
    if (ref == units_start)
      units_start += UNIT_SIZE;
    else
      push_node(ref, 0);
  }

  void refresh(uint32_t c, uint32_t old_nu, int scale) {
    uint32_t i = ctx_num_stats(c);
    uint32_t stats = shrink_units(ctx_stats(c), old_nu, (i + 2) >> 1);
    set_ctx_stats(c, stats);
    uint32_t s = stats;
    uint32_t flags = (ctx_flags(c) & (0x10 + 0x04 * scale)) +
                     (st_sym(s) >= 0x40 ? 0x08 : 0);
    int32_t esc = (int32_t)ctx_summ(c) - st_freq(s);
    uint32_t f = (uint32_t)(st_freq(s) + scale) >> scale;
    set_st_freq(s, (uint8_t)f);
    uint32_t summ = f;
    for (uint32_t k = 0; k < i; ++k) {
      s += 6;
      esc -= st_freq(s);
      f = (uint32_t)(st_freq(s) + scale) >> scale;
      set_st_freq(s, (uint8_t)f);
      summ += f;
      flags |= st_sym(s) >= 0x40 ? 0x08 : 0;
    }
    set_ctx_summ(c, summ + (uint32_t)((esc + scale) >> scale));
    set_ctx_flags(c, (uint8_t)flags);
  }

  static constexpr int CUTOFF_KEEP_ORDER = 9;

  uint32_t cut_off(uint32_t c, int ord) {
    if (corrupt) return 0;
    uint32_t ns = ctx_num_stats(c);
    if (ns == 0) {
      uint32_t one = one_state(c);
      uint32_t succ = st_succ(one);
      if (succ < units_start) {
        special_free_unit(c);
        return 0;
      }
      if (ord < order)
        set_st_succ(one, cut_off(succ, ord + 1));
      else
        set_st_succ(one, 0);
      if (st_succ(one) != 0 || ord <= CUTOFF_KEEP_ORDER) return c;
      special_free_unit(c);
      return 0;
    }

    uint32_t nu = (ns + 2) >> 1;
    uint32_t stats = ctx_stats(c);
    if (stats <= units_start + 0x4000) {
      int i = T.u2i[nu - 1];
      uint32_t head = free_list[i];
      if (head >= stats && head != 0) {
        head = pop_node(i);
        if (!oob(head, nu * UNIT_SIZE) && !oob(stats, nu * UNIT_SIZE))
          std::memcpy(mem + head, mem + stats, (size_t)nu * UNIT_SIZE);
        if (stats == units_start)
          units_start += T.i2u[i] * UNIT_SIZE;
        else
          push_node(stats, i);
        stats = head;
      }
    }
    set_ctx_stats(c, stats);

    int32_t tmp = (int32_t)ns;
    for (int32_t pos = (int32_t)ns; pos >= 0; --pos) {
      uint32_t s = stats + 6 * (uint32_t)pos;
      uint32_t succ = st_succ(s);
      if (succ < units_start) {
        set_st_succ(s, 0);
        uint32_t s2 = stats + 6 * (uint32_t)tmp;
        if (!oob(s, 6) && !oob(s2, 6)) {
          uint8_t sym_freq[2] = {mem[s], mem[s + 1]};
          std::memmove(mem + s, mem + s2, 6);
          mem[s2] = sym_freq[0];
          mem[s2 + 1] = sym_freq[1];
          std::memset(mem + s2 + 2, 0, 4);
        }
        --tmp;
      } else if (ord < order) {
        set_st_succ(s, cut_off(succ, ord + 1));
      } else {
        set_st_succ(s, 0);
      }
    }

    if (tmp != (int32_t)ns && ord != 0) {
      set_ctx_num_stats(c, (uint8_t)tmp);
      if (tmp < 0) {
        push_node(stats, T.u2i[nu - 1]);
        special_free_unit(c);
        return 0;
      }
      if (tmp == 0) {
        uint32_t flags = (ctx_flags(c) & 0x10) + (rd8(stats) >= 0x40 ? 0x08 : 0);
        uint32_t one = one_state(c);
        copy_state(one, stats);
        push_node(stats, T.u2i[nu - 1]);
        set_st_freq(one, (uint8_t)((st_freq(one) + 11) >> 3));
        set_ctx_flags(c, (uint8_t)flags);
        return c;
      }
      refresh(c, nu, ctx_summ(c) > 16u * (uint32_t)tmp ? 1 : 0);
    }
    return c;
  }

  void expand_text_area() {
    uint32_t count[N_INDEXES] = {0};
    if (lo_unit != hi_unit) wr32(lo_unit, 0);
    while (!corrupt && rd32(units_start) == 0xFFFFFFFFu) {
      uint32_t nu = rd32(units_start + 8);
      if (nu == 0 || nu > 128) {
        corrupt = true;
        break;
      }
      wr32(units_start, 0);
      count[T.u2i[nu - 1]] += 1;
      units_start += nu * UNIT_SIZE;
    }
    for (int i = 0; i < N_INDEXES; ++i) {
      uint32_t k = count[i];
      if (!k) continue;
      uint32_t prev = 0;  // 0 = list head
      uint32_t ref = free_list[i];
      while (k && ref) {
        uint32_t nxt = rd32(ref + 4);
        if (rd32(ref) == 0) {
          if (prev == 0)
            free_list[i] = nxt;
          else
            wr32(prev + 4, nxt);
          --stamps[i];
          --k;
        } else {
          prev = ref;
        }
        ref = nxt;
      }
    }
  }

  int64_t used_memory() {
    int64_t free_units = 0;
    for (int i = 0; i < N_INDEXES; ++i)
      free_units += (int64_t)T.i2u[i] * stamps[i];
    return size - (int64_t)(hi_unit - lo_unit) -
           (int64_t)(units_start - text) - free_units * UNIT_SIZE;
  }

  void restore_model(uint32_t ctx_error) {
    text = 0;
    uint32_t c = max_context;
    int hops = 0;
    while (c != ctx_error && !corrupt && ++hops < 1 << 20) {
      uint32_t ns = (uint32_t)ctx_num_stats(c) - 1;
      set_ctx_num_stats(c, (uint8_t)ns);
      if (ns == 0) {
        uint32_t stats = ctx_stats(c);
        uint32_t flags =
            (ctx_flags(c) & 0x10) + (rd8(stats) >= 0x40 ? 0x08 : 0);
        uint32_t one = one_state(c);
        copy_state(one, stats);
        special_free_unit(stats);
        set_st_freq(one, (uint8_t)((st_freq(one) + 11) >> 3));
        set_ctx_flags(c, (uint8_t)flags);
      } else {
        refresh(c, (ns + 3) >> 1, 0);
      }
      c = ctx_suffix(c);
    }
    while (c != min_context && !corrupt && ++hops < 1 << 20) {
      if (ctx_num_stats(c) == 0) {
        uint32_t one = one_state(c);
        set_st_freq(one, (uint8_t)(st_freq(one) - (st_freq(one) >> 1)));
      } else {
        uint32_t summ = (uint32_t)ctx_summ(c) + 4;
        set_ctx_summ(c, summ);
        if (summ > 128u + 4u * ctx_num_stats(c))
          refresh(c, ((uint32_t)ctx_num_stats(c) + 2) >> 1, 1);
      }
      c = ctx_suffix(c);
    }
    if (hops >= 1 << 20) corrupt = true;

    if (restore_method == 0 || used_memory() < size >> 1) {
      restart();
      return;
    }
    uint32_t root = max_context;
    while (ctx_suffix(root) && !corrupt) root = ctx_suffix(root);
    max_context = root;
    int rounds = 0;
    do {
      cut_off(root, 0);
      expand_text_area();
    } while (!corrupt && used_memory() > 3 * (size >> 2) && ++rounds < 64);
    glue_count = 0;
    order_fall = order;
    // NOTE: MinContext deliberately left stale here (canonical tail,
    // 0x23264); the caller's NextContext syncs MinContext = MaxContext
    // after every UpdateModel return.
  }

  // -- update_model (ppmd.py) ----------------------------------------------
  bool exhausted(uint32_t ctx_error) {
    if (restore_method != 0) {
      restore_model(ctx_error);
      return true;
    }
    restart();
    return true;
  }

  bool update_model() {
    uint32_t f_state = found_state;
    uint32_t f_freq = st_freq(f_state);
    uint8_t f_symbol = st_sym(f_state);
    uint32_t f_successor = st_succ(f_state);
    uint32_t mc = min_context;

    uint32_t sfx_state = 0;
    if (f_freq < MAX_FREQ / 4 && ctx_suffix(mc)) {
      uint32_t c = ctx_suffix(mc);
      uint32_t s;
      if (ctx_num_stats(c) == 0) {
        s = one_state(c);
        if (st_freq(s) < 32) set_st_freq(s, st_freq(s) + 1);
      } else {
        s = stats_addr(c);
        if (st_sym(s) != f_symbol) {
          int steps = 0;
          while (st_sym(s) != f_symbol && !corrupt && ++steps < 4096) s += 6;
          if (steps >= 4096) corrupt = true;
          if (st_freq(s) >= st_freq(s - 6)) {
            swap_states(s, s - 6);
            s -= 6;
          }
        }
        if (st_freq(s) < MAX_FREQ - 9) {
          set_st_freq(s, st_freq(s) + 2);
          set_ctx_summ(c, ctx_summ(c) + 2);
        }
      }
      sfx_state = s;
    }

    if (order_fall == 0) {
      uint32_t c = create_successors(true, sfx_state, 0);
      if (!c) {
        // canonical 0x238e1: zero the stale text-pointer successor
        set_st_succ(f_state, 0);
        return exhausted(max_context);
      }
      min_context = max_context = c;
      set_st_succ(f_state, c);
      return true;
    }

    wr8(text, f_symbol);
    ++text;
    uint32_t successor = text;
    if (text >= units_start) return exhausted(max_context);

    if (f_successor) {
      if (f_successor <= text) {
        f_successor = create_successors(false, sfx_state, 0);
        if (!f_successor) return exhausted(max_context);
      }
      if (--order_fall == 0) {
        successor = f_successor;
        if (max_context != min_context) --text;
      }
    } else {
      // fresh symbol: modern UpdateModel suffix-chain walk (ppmd.py)
      set_st_succ(f_state, successor);
      ++order_fall;
      uint32_t c = mc;
      uint32_t s1 = sfx_state;  // canonical 0x23514: first walked context
      // reuses the suffix-update's state unbumped, then clears it
      int walk_hops = 0;
      while (true) {
        if (corrupt || ++walk_hops > 1 << 16) {
          corrupt = true;
          return exhausted(max_context);
        }
        uint32_t sfx = ctx_suffix(c);
        if (!sfx) {
          f_successor = c;
          break;
        }
        c = sfx;
        uint32_t s;
        if (s1) {
          s = s1;
          s1 = 0;
        } else if (ctx_num_stats(c) != 0) {
          s = stats_addr(c);
          int steps = 0;
          while (st_sym(s) != f_symbol && !corrupt && ++steps < 4096) s += 6;
          if (steps >= 4096) corrupt = true;
          if (st_freq(s) <= MAX_FREQ - 10) {
            set_st_freq(s, st_freq(s) + 2);
            set_ctx_summ(c, ctx_summ(c) + 2);
          }
        } else {
          s = one_state(c);
          if (st_freq(s) <= 31) set_st_freq(s, st_freq(s) + 1);
        }
        uint32_t tgt = st_succ(s);
        if (tgt == 0) {
          set_st_succ(s, successor);
          ++order_fall;
          continue;
        }
        if (tgt <= successor) {
          uint32_t save = found_state;
          found_state = s;
          uint32_t cs = create_successors(false, 0, c);
          found_state = save;
          if (!cs) return exhausted(max_context);
          set_st_succ(s, cs);
          tgt = cs;
        }
        f_successor = tgt;
        break;
      }
      if (--order_fall == 0) {
        successor = f_successor;
        if (max_context != min_context) --text;
      }
    }

    uint32_t ns = (uint32_t)ctx_num_stats(mc) + 1;
    uint32_t s0 = (uint32_t)ctx_summ(mc) - ns - (f_freq - 1);
    for (uint32_t c = max_context; c != mc; c = ctx_suffix(c)) {
      uint32_t ns1 = (uint32_t)ctx_num_stats(c) + 1;
      if (ns1 != 1) {
        if ((ns1 & 1) == 0) {
          uint32_t new_stats = expand_units(ctx_stats(c), ns1 >> 1);
          if (!new_stats) return exhausted(c);
          set_ctx_stats(c, new_stats);
        }
        // disassembly 0x2344e: both operands in count-1 form
        set_ctx_summ(c, ctx_summ(c) + (3 * (ns1 - 1) + 1 < ns - 1 ? 1 : 0));
      } else {
        uint32_t new_stats = alloc_units(0);
        if (!new_stats) return exhausted(c);
        copy_state(new_stats, one_state(c));
        set_ctx_stats(c, new_stats);
        uint32_t freq = st_freq(new_stats);
        if (freq < MAX_FREQ / 4 - 1)
          freq += freq;
        else
          freq = MAX_FREQ - 4;
        set_st_freq(new_stats, (uint8_t)freq);
        // disassembly 0x235e6: +1 only when count > 3
        set_ctx_summ(c, freq + init_esc + (ns > 3 ? 1 : 0));
      }
      uint32_t cf = 2 * f_freq * (ctx_summ(c) + 6);
      uint32_t sf = s0 + ctx_summ(c);
      if (cf < 6 * sf) {
        cf = 1 + (cf > sf ? 1 : 0) + (cf >= 4 * sf ? 1 : 0);
        set_ctx_summ(c, ctx_summ(c) + 4);
      } else {
        // disassembly 0x23477: strict > on the 9/12/15 thresholds
        cf = 4 + (cf > 9 * sf ? 1 : 0) + (cf > 12 * sf ? 1 : 0) +
             (cf > 15 * sf ? 1 : 0);
        set_ctx_summ(c, ctx_summ(c) + cf);
      }
      uint32_t s = stats_addr(c, ns1);
      set_st_succ(s, successor);
      set_st_sym(s, f_symbol);
      set_st_freq(s, (uint8_t)cf);
      set_ctx_num_stats(c, (uint8_t)ns1);
      set_ctx_flags(c, ctx_flags(c) | (f_symbol >= 0x40 ? 0x08 : 0));
    }
    max_context = min_context = f_successor;
    return true;
  }

  bool next_context() {
    uint32_t c = st_succ(found_state);
    if (order_fall == 0 && c >= units_start) {
      min_context = max_context = c;
      return true;
    }
    bool ok = update_model();
    // canonical NextContext (0x23a9c): MinContext = MaxContext after
    // EVERY UpdateModel return (re-anchors after a cutoff restore)
    min_context = max_context;
    return ok;
  }

  bool update1(uint32_t s) {
    set_st_freq(s, st_freq(s) + 4);
    set_ctx_summ(min_context, ctx_summ(min_context) + 4);
    if (st_freq(s) > st_freq(s - 6)) {
      swap_states(s, s - 6);
      s -= 6;
      found_state = s;
      if (st_freq(s) > MAX_FREQ) rescale();
    } else {
      found_state = s;
    }
    return next_context();
  }

  bool update1_0(uint32_t s) {
    // disassembly 0x23a58: setge — 2*freq >= SummFreq
    prev_success = 2 * (uint32_t)st_freq(s) >= ctx_summ(min_context) ? 1 : 0;
    run_length += prev_success;
    set_ctx_summ(min_context, ctx_summ(min_context) + 4);
    set_st_freq(s, st_freq(s) + 4);
    found_state = s;
    if (st_freq(s) > MAX_FREQ) rescale();
    return next_context();
  }

  bool update_bin(uint32_t s) {
    if (st_freq(s) < 196) set_st_freq(s, st_freq(s) + 1);
    prev_success = 1;
    ++run_length;
    found_state = s;
    return next_context();
  }

  bool update2(uint32_t s) {
    set_st_freq(s, st_freq(s) + 4);
    set_ctx_summ(min_context, ctx_summ(min_context) + 4);
    found_state = s;
    if (st_freq(s) > MAX_FREQ) rescale();
    run_length = init_rl;
    bool ok = update_model();
    min_context = max_context;  // canonical Update2 tail
    return ok;
  }

  // -- probability selection ------------------------------------------------
  void bin_index(uint32_t c, int* row, int* col) {
    uint32_t one = one_state(c);
    *row = T.ns2indx[st_freq(one) - 1];
    uint32_t suffix = ctx_suffix(c);
    *col = prev_success + T.ns2bsindx[ctx_num_stats(suffix)] + ctx_flags(c) +
           (int)(((uint32_t)run_length >> 26) & 0x20);
  }
  void bin_update0(int row, int col) {
    uint16_t prob = bin_summ[row][col];
    bin_summ[row][col] = (uint16_t)(prob + (1u << INT_BITS) -
                                    ((prob + (1u << (PERIOD_BITS - 2))) >>
                                     PERIOD_BITS));
  }
  void bin_update1(int row, int col) {
    uint16_t prob = bin_summ[row][col];
    bin_summ[row][col] =
        (uint16_t)(prob - ((prob + (1u << (PERIOD_BITS - 2))) >> PERIOD_BITS));
    init_esc = EXP_ESCAPE[(bin_summ[row][col] >> 10) & 0x3F];
  }
  // returns esc_freq; row/col via pointers, row < 0 => dummy see
  uint32_t make_esc_freq(uint32_t c, uint32_t num_masked, int* row, int* col) {
    uint32_t nm1 = ctx_num_stats(c);
    if (nm1 != 0xFF) {
      uint32_t suffix = ctx_suffix(c);
      *row = T.ns2indx[nm1 + 2] - 3;
      *col = (ctx_summ(c) > 11 * (nm1 + 1) ? 1 : 0) +
             2 * (2 * nm1 < (uint32_t)ctx_num_stats(suffix) + (num_masked - 1)
                      ? 1
                      : 0) +
             ctx_flags(c);
      uint16_t summ = see_summ[*row][*col];
      uint32_t r = summ >> see_shift[*row][*col];
      see_summ[*row][*col] = (uint16_t)(summ - r);
      return r + (r == 0 ? 1 : 0);
    }
    *row = -1;
    return 1;
  }
  void see_update(int row, int col) {
    if (row < 0) return;
    if (see_shift[row][col] < PERIOD_BITS) {
      if (--see_count[row][col] == 0) {
        see_summ[row][col] = (uint16_t)(see_summ[row][col] << 1);
        see_count[row][col] = (uint8_t)(3 << see_shift[row][col]);
        ++see_shift[row][col];
      }
    }
  }
  void see_add(int row, int col, uint32_t freq_sum) {
    if (row < 0) return;
    see_summ[row][col] = (uint16_t)(see_summ[row][col] + freq_sum);
  }
};

// -- one decode step (ppmd.py _decode_symbol) -------------------------------
// returns symbol 0..255, -1 end marker, -10 corrupt, -11 exhausted w/ 1|2
int decode_symbol(Model& m, RangeDec& rc) {
  uint8_t mask[256];
  uint32_t num_masked;
  uint32_t mc = m.min_context;
  if (m.corrupt || rc.bad || m.oob(mc, 12)) return -10;
  if (m.ctx_num_stats(mc) != 0) {
    uint32_t s = m.stats_addr(mc);
    uint32_t summ = m.ctx_summ(mc);
    uint32_t count = rc.threshold(summ);
    uint32_t hi_cnt = m.st_freq(s);
    if (count < hi_cnt) {
      rc.decode(0, hi_cnt);
      int sym = m.st_sym(s);
      m.update1_0(s);
      if (m.corrupt) return -10;
      return sym;
    }
    m.prev_success = 0;
    uint32_t i = m.ctx_num_stats(mc);
    uint32_t found = 0;
    bool have = false;
    while (i) {
      s += 6;
      hi_cnt += m.st_freq(s);
      if (hi_cnt > count) {
        found = s;
        have = true;
        break;
      }
      --i;
    }
    if (have) {
      rc.decode(hi_cnt - m.st_freq(found), m.st_freq(found));
      int sym = m.st_sym(found);
      m.update1(found);
      if (m.corrupt) return -10;
      return sym;
    }
    if (count >= summ) return -10;
    rc.decode(hi_cnt, summ - hi_cnt);
    std::memset(mask, 0, 256);
    s = m.stats_addr(mc);
    for (uint32_t j = 0; j <= m.ctx_num_stats(mc); ++j) {
      mask[m.st_sym(s)] = 1;
      s += 6;
    }
    num_masked = (uint32_t)m.ctx_num_stats(mc) + 1;
  } else {
    uint32_t one = m.one_state(mc);
    int row, col;
    m.bin_index(mc, &row, &col);
    uint16_t prob = m.bin_summ[row][col];
    if (rc.decode_bit(prob) == 0) {
      m.bin_update0(row, col);
      int sym = m.st_sym(one);
      m.update_bin(one);
      if (m.corrupt) return -10;
      return sym;
    }
    m.bin_update1(row, col);
    std::memset(mask, 0, 256);
    mask[m.st_sym(one)] = 1;
    m.prev_success = 0;
    num_masked = 1;
  }

  int esc_hops = 0;
  while (true) {
    if (++esc_hops > 1 << 16) return -10;  // suffix cycle
    ++m.order_fall;
    uint32_t nmc = m.ctx_suffix(m.min_context);
    if (!nmc) return -1;
    m.min_context = nmc;
    while ((uint32_t)m.ctx_num_stats(nmc) + 1 == num_masked) {
      if (++esc_hops > 1 << 16) return -10;
      ++m.order_fall;
      nmc = m.ctx_suffix(nmc);
      if (!nmc) return -1;
      m.min_context = nmc;
    }
    if (m.corrupt || m.oob(nmc, 12)) return -10;
    uint32_t hi_cnt = 0;
    uint32_t s = m.stats_addr(nmc);
    uint32_t cands[256];
    uint32_t n_cands = 0;
    for (uint32_t j = 0; j <= m.ctx_num_stats(nmc); ++j) {
      if (!mask[m.st_sym(s)]) {
        hi_cnt += m.st_freq(s);
        cands[n_cands++] = s;
      }
      s += 6;
    }
    int row, col;
    uint32_t esc_freq = m.make_esc_freq(nmc, num_masked, &row, &col);
    uint32_t freq_sum = hi_cnt + esc_freq;
    uint32_t count = rc.threshold(freq_sum);
    if (count < hi_cnt) {
      uint32_t acc = 0;
      uint32_t sel = 0;
      for (uint32_t j = 0; j < n_cands; ++j) {
        sel = cands[j];
        acc += m.st_freq(sel);
        if (acc > count) break;
      }
      rc.decode(acc - m.st_freq(sel), m.st_freq(sel));
      m.see_update(row, col);
      int sym = m.st_sym(sel);
      m.update2(sel);
      if (m.corrupt) return -10;
      return sym;
    }
    if (count >= freq_sum) return -10;
    rc.decode(hi_cnt, freq_sum - hi_cnt);
    m.see_add(row, col, freq_sum);
    for (uint32_t j = 0; j < n_cands; ++j) mask[m.st_sym(cands[j])] = 1;
    num_masked = (uint32_t)m.ctx_num_stats(nmc) + 1;
  }
}

}  // namespace

extern "C" {

int64_t volxel_ppmd_decompress(const uint8_t* src, int64_t src_len, int order,
                               int mem_mb, int restore_method, uint8_t* out,
                               int64_t out_cap) {
  if (order < 2 || order > 16 || mem_mb < 1 || mem_mb > 256 ||
      restore_method < 0 || restore_method > 2)
    return -4;
  Model m;
  if (!m.init(order, (int64_t)mem_mb << 20, restore_method)) return -4;
  RangeDec rc;
  rc.init(src, src_len);
  int64_t n = 0;
  while (n < out_cap) {
    int sym = decode_symbol(m, rc);
    if (sym == -1) return -3;   // early end marker
    if (sym < 0) return -1;     // corrupt / left the valid region
    out[n++] = (uint8_t)sym;
  }
  return n;
}

// Unsized decode (no exact length known): stops at the end marker.
// Returns bytes written, or the same negative codes; -3 if out_cap was
// reached before the marker.
int64_t volxel_ppmd_decompress_to_marker(const uint8_t* src, int64_t src_len,
                                         int order, int mem_mb,
                                         int restore_method, uint8_t* out,
                                         int64_t out_cap) {
  if (order < 2 || order > 16 || mem_mb < 1 || mem_mb > 256 ||
      restore_method < 0 || restore_method > 2)
    return -4;
  Model m;
  if (!m.init(order, (int64_t)mem_mb << 20, restore_method)) return -4;
  RangeDec rc;
  rc.init(src, src_len);
  int64_t n = 0;
  while (true) {
    int sym = decode_symbol(m, rc);
    if (sym == -1) return n;
    if (sym < 0) return -1;
    if (n >= out_cap) return -3;
    out[n++] = (uint8_t)sym;
  }
}

}  // extern "C"
