"""PPMd variant I rev 1 (PPMd8) codec — ZIP compression method 98.

Parity target: the reference ingests ZIP archives through the Rust `zip`
crate with the `ppmd` feature enabled
(dicom_preprocessor/Cargo.toml:30, via `ppmd-rust`), so
PPMd-compressed DICOM zips load there. This module implements both
directions of Dmitry Shkarin's PPMd var.I — the modern (7-Zip 21.x era)
revision with per-context Flags, quantized NS2Indx[260], BinSumm[25][64]
and See[24][32] — over the Subbotin carryless range coder, clean-room
from the published algorithm, with behavioral details verified against
the canonical decoder bundled in this system's libarchive by driving it
directly through ctypes (tests/test_ppmd.py).

Verification status (tests/test_ppmd.py):
  * round-trips: full coverage (all data classes, orders 2..16);
  * canonical conformance: the canonical decoder reproduces our streams
    byte-for-byte INCLUDING the end marker across every tested data
    class (text, binary, runs, 16-bit medical-like data, source code),
    orders 2..16, and small pools that force rescale cascades, free-list
    glue and full model restarts. The last five divergences were pinned
    by full-tree differential against libarchive's Ppmd8 plus objdump of
    its UpdateModel/Rescale/AllocUnitsRare (offsets cited inline):
    strict > on the 9/12/15*sf thresholds, the one-state rescale
    collapse formula (2f+esc-1)//esc capped at MAX_FREQ/3 with flags
    recompute, the one-state grow +1 only when count > 3, the multi grow
    compare in count-1 form on both sides, prev_success >= (not >), and
    the canonical glue-free-blocks pass with its node stamps.

Stream format:
  * ZIP method 98 payload = 2-byte LE parameter word + range-coded data:
    order = (w & 0xF) + 1, memory = ((w >> 4) & 0xFF) + 1 MiB,
    restoration method = w >> 12.
  * End of stream is coded as an escape below the order(-1) root.

Memory-exhaustion restoration: ALL three methods are implemented and
conformance-tested against pool exhaustion — RESTART (0) drops the
model; CUT_OFF (1) and FREEZE (2) run the canonical RestoreModel/CutOff
tree surgery (ported from the libarchive Ppmd8 disassembly, which
treats the two identically: RestoreMethod is read nowhere else,
0x2308c). One documented edge: UnitsStart can grow mid-CutOff and
invalidate successors kept earlier in the recursion, after which the
CANONICAL implementation reads undefined memory (this area of Ppmd8 has
CVE history); both our decoders detect the boundary and raise a typed
error instead. Our encoder defaults to restoration method 0.
"""

from __future__ import annotations

UNIT_SIZE = 12
N_INDEXES = 38
MAX_FREQ = 124
INT_BITS = 7
PERIOD_BITS = 7
BIN_SCALE = 1 << (INT_BITS + PERIOD_BITS)
MAX_ORDER = 16

TOP = 1 << 24
BOT = 1 << 15
M32 = 0xFFFFFFFF

K_INIT_BIN_ESC = (0x3CDD, 0x1F3F, 0x59BF, 0x48F3, 0x64A1, 0x5ABC, 0x6632, 0x6051)
EXP_ESCAPE = (25, 14, 9, 7, 5, 5, 4, 4, 4, 3, 3, 3, 2, 2, 2, 2)


class PpmdError(Exception):
    """Corrupt or unsupported PPMd stream."""


def _build_unit_tables():
    i2u = [0] * N_INDEXES
    u2i = [0] * 128
    k = 0
    for i in range(N_INDEXES):
        step = 4 if i >= 12 else (i >> 2) + 1
        for _ in range(step):
            u2i[k] = i
            k += 1
        i2u[i] = k
    return tuple(i2u), tuple(u2i)


I2U, U2I = _build_unit_tables()


def _build_ns2indx():
    t = [0] * 260
    for i in range(5):
        t[i] = i
    m, k = 5, 1
    for i in range(5, 260):
        t[i] = m
        k -= 1
        if k == 0:
            m += 1
            k = m - 4
    return tuple(t)


NS2INDX = _build_ns2indx()
# suffix-context size class, indexed by actual symbol count - 1
NS2BSINDX = tuple(0 if i == 0 else 2 if i == 1 else 4 if i < 11 else 6 for i in range(256))
HB2FLAG = tuple(8 if i >= 0x40 else 0 for i in range(256))


# ---------------------------------------------------------------------------
# Carryless range coder (Subbotin), as used by PPMd var.I. Matches the
# canonical zip-side decoder in libarchive bit-for-bit: 4-byte code
# init, and normalization shifting while (low ^ (low+range)) < 2^24,
# with the underflow fixup range = (-low) & (2^15 - 1) when range < 2^15.
# (The decoder there keeps Code relative and tracks Low separately;
# keeping Code absolute and comparing against code-low is algebraically
# identical, including the normalization schedule.)
# ---------------------------------------------------------------------------


class _RangeEncoder:
    def __init__(self):
        self.low = 0
        self.range = M32
        self.out = bytearray()

    def _normalize(self):
        low, rng = self.low, self.range
        while True:
            if ((low ^ (low + rng)) & M32) < TOP:
                pass
            elif rng < BOT:
                rng = (-low) & (BOT - 1)
            else:
                break
            self.out.append((low >> 24) & 0xFF)
            low = (low << 8) & M32
            rng = (rng << 8) & M32
        self.low, self.range = low, rng

    def encode(self, start, size, total):
        if size <= 0 or total <= 0:
            raise PpmdError("corrupt PPMd model state (zero width/total)")
        r = self.range // total
        if r == 0:
            raise PpmdError("corrupt PPMd model state (range underflow)")
        self.low = (self.low + start * r) & M32
        self.range = r * size
        self._normalize()

    def encode_bit0(self, size0):
        self.range = (self.range >> 14) * size0
        self._normalize()

    def encode_bit1(self, size0):
        r = self.range >> 14
        self.low = (self.low + r * size0) & M32
        self.range = r * (BIN_SCALE - size0)
        self._normalize()

    def flush(self):
        for _ in range(4):
            self.out.append((self.low >> 24) & 0xFF)
            self.low = (self.low << 8) & M32
        return bytes(self.out)


class _RangeDecoder:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.low = 0
        self.range = M32
        self.code = 0
        for _ in range(4):
            self.code = ((self.code << 8) | self._byte()) & M32

    def _byte(self):
        if self.pos < len(self.data):
            b = self.data[self.pos]
            self.pos += 1
            return b
        return 0  # canonical decoders read past the end as zeros

    def _normalize(self):
        low, rng, code = self.low, self.range, self.code
        while True:
            if ((low ^ (low + rng)) & M32) < TOP:
                pass
            elif rng < BOT:
                rng = (-low) & (BOT - 1)
            else:
                break
            code = ((code << 8) | self._byte()) & M32
            low = (low << 8) & M32
            rng = (rng << 8) & M32
        self.low, self.range, self.code = low, rng, code

    def threshold(self, total):
        # a garbage context (reachable only on corrupt streams) can carry
        # summ 0; and range >= 2^15 after normalization can still fall
        # below an inflated escape freq_sum — both would divide by zero
        if total <= 0:
            raise PpmdError("corrupt PPMd stream (zero total)")
        self.range //= total
        if self.range == 0:
            raise PpmdError("corrupt PPMd stream (range underflow)")
        return ((self.code - self.low) & M32) // self.range

    def decode(self, start, size):
        if size <= 0:
            # zero-width symbol (corrupt stream): range would collapse to
            # 0 and the normalization loop below would never terminate
            raise PpmdError("corrupt PPMd stream (zero symbol width)")
        self.low = (self.low + start * self.range) & M32
        self.range *= size
        self._normalize()

    def decode_bit(self, size0):
        r = self.range >> 14
        bound = r * size0
        if ((self.code - self.low) & M32) < bound:
            self.range = bound
            self._normalize()
            return 0
        self.low = (self.low + bound) & M32
        self.range = r * (BIN_SCALE - size0)
        self._normalize()
        return 1


# ---------------------------------------------------------------------------
# Model memory: one flat pool, text from the bottom, tree from the top.
# Node layouts (byte offsets inside the pool):
#   state   (6 B): symbol u8 | freq u8 | successor u32le
#   context (12 B): num_stats u16le (ACTUAL symbol count) |
#                   summ_freq u16le | stats u32le | suffix u32le
#   a one-symbol context stores its single state inline at offset +2
#   (its successor aliases the stats field — the canonical union layout).
# ---------------------------------------------------------------------------


class _Pool:
    def __init__(self, size):
        self.size = size
        self.mem = bytearray(size)
        self.free_list = [0] * N_INDEXES
        # per-index free-node counts (canonical Stamps, p+0x1c0): only
        # read by RestoreModel's used-memory estimate
        self.stamps = [0] * N_INDEXES
        self.glue_count = 0
        self.text = 0
        self.units_start = 0
        self.lo_unit = 0
        self.hi_unit = 0

    def init(self):
        self.free_list = [0] * N_INDEXES
        self.stamps = [0] * N_INDEXES
        self.text = 0
        self.hi_unit = self.size
        diff = UNIT_SIZE * (self.size // 8 // UNIT_SIZE * 7)
        self.lo_unit = self.units_start = self.hi_unit - diff
        self.glue_count = 0

    # Free-list node layout (canonical var.I suballocator; disassembly
    # 0x220dc): stamp 0xFFFFFFFF at +0, next ref at +4, unit count at +8.
    # The stamp is what GlueFreeBlocks uses to recognize an adjacent free
    # block, so the layout is load-bearing for conformance.
    def _push(self, ref, indx):
        self.mem[ref : ref + 4] = b"\xff\xff\xff\xff"
        self.mem[ref + 4 : ref + 8] = self.free_list[indx].to_bytes(4, "little")
        self.mem[ref + 8 : ref + 12] = I2U[indx].to_bytes(4, "little")
        self.free_list[indx] = ref
        self.stamps[indx] += 1

    def _pop(self, indx):
        ref = self.free_list[indx]
        self.free_list[indx] = int.from_bytes(
            self.mem[ref + 4 : ref + 8], "little"
        )
        self.stamps[indx] -= 1
        return ref

    def glue_free_blocks(self):
        """Merge adjacent free blocks (canonical GlueFreeBlocks, inlined in
        AllocUnitsRare at 0x221c9): collect every free node list-by-list,
        absorb address-adjacent free nodes into the first one encountered,
        then re-insert each glued run back into the free lists in 128-unit
        chunks plus an index-aligned head/tail split. Resets glue_count to
        0x2000 (disassembly 0x221f5 — not PPMdI's 255)."""
        mem = self.mem
        self.glue_count = 0x2000
        self.stamps = [0] * N_INDEXES  # rebuilt by the _push calls below
        if self.lo_unit != self.hi_unit:
            # stamp 0 at LoUnit stops gluing from running into virgin space
            mem[self.lo_unit : self.lo_unit + 4] = b"\x00\x00\x00\x00"

        def rd32(o):
            return int.from_bytes(mem[o : o + 4], "little")

        out = []
        for i in range(N_INDEXES):
            ref = self.free_list[i]
            self.free_list[i] = 0
            while ref:
                nxt = rd32(ref + 4)
                nu = rd32(ref + 8)
                if nu:
                    out.append(ref)
                    while True:
                        adj = ref + nu * UNIT_SIZE
                        if adj + 12 > self.size or rd32(adj) != 0xFFFFFFFF:
                            break
                        anu = rd32(adj + 8)
                        if anu == 0:
                            break
                        nu += anu
                        mem[adj + 8 : adj + 12] = b"\x00\x00\x00\x00"
                        mem[ref + 8 : ref + 12] = nu.to_bytes(4, "little")
                ref = nxt
        for ref in out:
            sz = rd32(ref + 8)
            if sz == 0:
                continue
            pos = ref
            while sz > 128:
                self._push(pos, N_INDEXES - 1)
                sz -= 128
                pos += 128 * UNIT_SIZE
            i = U2I[sz - 1]
            if I2U[i] != sz:
                i -= 1
                k = sz - I2U[i]
                self._push(pos + (sz - k) * UNIT_SIZE, k - 1)
            self._push(pos, i)

    def split_block(self, ref, old_indx, new_indx):
        nu = I2U[old_indx] - I2U[new_indx]
        p = ref + I2U[new_indx] * UNIT_SIZE
        i = U2I[nu - 1]
        if I2U[i] != nu:
            k = I2U[i - 1]
            self._push(p + k * UNIT_SIZE, nu - k - 1)
            nu = k
            i = U2I[nu - 1]
        self._push(p, i)

    def alloc_units_rare(self, indx):
        if self.glue_count == 0:
            self.glue_free_blocks()
            if self.free_list[indx]:
                return self._pop(indx)
        i = indx
        while True:
            i += 1
            if i == N_INDEXES:
                num_bytes = I2U[indx] * UNIT_SIZE
                self.glue_count -= 1
                if self.units_start - self.text > num_bytes:
                    self.units_start -= num_bytes
                    return self.units_start
                return 0
            if self.free_list[i]:
                break
        ref = self._pop(i)
        self.split_block(ref, i, indx)
        return ref

    def alloc_units(self, indx):
        if self.free_list[indx]:
            return self._pop(indx)
        num_bytes = I2U[indx] * UNIT_SIZE
        if num_bytes <= self.hi_unit - self.lo_unit:
            ref = self.lo_unit
            self.lo_unit += num_bytes
            return ref
        return self.alloc_units_rare(indx)

    def alloc_context(self):
        if self.hi_unit != self.lo_unit:
            self.hi_unit -= UNIT_SIZE
            return self.hi_unit
        if self.free_list[0]:
            return self._pop(0)
        return self.alloc_units_rare(0)

    def shrink_units(self, old_ref, old_nu, new_nu):
        i0 = U2I[old_nu - 1]
        i1 = U2I[new_nu - 1]
        if i0 == i1:
            return old_ref
        if self.free_list[i1]:
            ref = self._pop(i1)
            self.mem[ref : ref + new_nu * UNIT_SIZE] = self.mem[
                old_ref : old_ref + new_nu * UNIT_SIZE
            ]
            self._push(old_ref, i0)
            return ref
        self.split_block(old_ref, i0, i1)
        return old_ref

    def expand_units(self, old_ref, old_nu):
        i0 = U2I[old_nu - 1]
        i1 = U2I[old_nu]
        if i0 == i1:
            return old_ref
        ref = self.alloc_units(i1)
        if ref:
            self.mem[ref : ref + old_nu * UNIT_SIZE] = self.mem[
                old_ref : old_ref + old_nu * UNIT_SIZE
            ]
            self._push(old_ref, i0)
        return ref

    def free_units(self, ref, nu):
        self._push(ref, U2I[nu - 1])


class _Model:
    """Shared PPMd var.I model; encoder and decoder drive the identical
    update machinery so both sides evolve the same statistics."""

    def __init__(self, order, mem_bytes, restore_method=0):
        if not (2 <= order <= MAX_ORDER):
            raise PpmdError(f"unsupported PPMd order {order}")
        self.order = order
        self.restore_method = restore_method
        self.pool = _Pool(mem_bytes)
        self.see_summ = [[0] * 32 for _ in range(24)]
        self.see_shift = [[0] * 32 for _ in range(24)]
        self.see_count = [[0] * 32 for _ in range(24)]
        self.bin_summ = [[0] * 64 for _ in range(25)]
        self.restart()

    # -- raw accessors ------------------------------------------------------
    def ctx_num_stats(self, c):
        """Count-1 byte: 0 = one-symbol context, 255 = full root."""
        return self.pool.mem[c]

    def set_ctx_num_stats(self, c, v):
        self.pool.mem[c] = v & 0xFF

    def ctx_flags(self, c):
        return self.pool.mem[c + 1]

    def set_ctx_flags(self, c, v):
        self.pool.mem[c + 1] = v & 0xFF

    def ctx_summ_freq(self, c):
        return int.from_bytes(self.pool.mem[c + 2 : c + 4], "little")

    def set_ctx_summ_freq(self, c, v):
        self.pool.mem[c + 2 : c + 4] = (v & 0xFFFF).to_bytes(2, "little")

    def ctx_stats(self, c):
        return int.from_bytes(self.pool.mem[c + 4 : c + 8], "little")

    def set_ctx_stats(self, c, v):
        self.pool.mem[c + 4 : c + 8] = v.to_bytes(4, "little")

    def ctx_suffix(self, c):
        return int.from_bytes(self.pool.mem[c + 8 : c + 12], "little")

    def set_ctx_suffix(self, c, v):
        self.pool.mem[c + 8 : c + 12] = v.to_bytes(4, "little")

    def one_state(self, c):
        return c + 2

    def st_symbol(self, s):
        return self.pool.mem[s]

    def set_st_symbol(self, s, v):
        self.pool.mem[s] = v & 0xFF

    def st_freq(self, s):
        return self.pool.mem[s + 1]

    def set_st_freq(self, s, v):
        self.pool.mem[s + 1] = v & 0xFF

    def st_successor(self, s):
        return int.from_bytes(self.pool.mem[s + 2 : s + 6], "little")

    def set_st_successor(self, s, v):
        self.pool.mem[s + 2 : s + 6] = v.to_bytes(4, "little")

    def copy_state(self, dst, src):
        self.pool.mem[dst : dst + 6] = self.pool.mem[src : src + 6]

    def swap_states(self, a, b):
        mem = self.pool.mem
        tmp = bytes(mem[a : a + 6])
        mem[a : a + 6] = mem[b : b + 6]
        mem[b : b + 6] = tmp

    # -- model lifecycle ----------------------------------------------------
    def restart(self):
        p = self.pool
        p.init()
        self.order_fall = self.order
        self.init_rl = -(self.order if self.order < 12 else 12) - 1
        self.run_length = self.init_rl
        self.prev_success = 0
        self.init_esc = 0

        c = p.alloc_context()
        self.min_context = self.max_context = c
        self.set_ctx_suffix(c, 0)
        self.set_ctx_num_stats(c, 255)  # count-1 of 256
        self.set_ctx_flags(c, 0)
        self.set_ctx_summ_freq(c, 256 + 1)
        stats = p.lo_unit
        p.lo_unit += (256 // 2) * UNIT_SIZE
        self.set_ctx_stats(c, stats)
        for i in range(256):
            s = stats + 6 * i
            self.set_st_symbol(s, i)
            self.set_st_freq(s, 1)
            self.set_st_successor(s, 0)
        self.found_state = stats

        # BinSumm[25][64]: per-row divisor = (last freq-1 index mapping to
        # the row) + 2, via an NS2Indx scan (canonical RestartModel)
        k = 0
        for row in range(25):
            while NS2INDX[k] == row:
                k += 1
            for col8 in range(8):
                val = BIN_SCALE - K_INIT_BIN_ESC[col8] // (k + 1)
                for m in range(0, 64, 8):
                    self.bin_summ[row][col8 + m] = val
        # See[24][32]: Summ = (2 * scan + 5) << 3, Shift 3, Count 7; the
        # scan advances one NS2Indx bucket (starting at index 3) per row
        k = 0
        for row in range(24):
            v = NS2INDX[3 + k]
            k += 1
            while 3 + k < 260 and NS2INDX[3 + k] == v:
                k += 1
            summ = ((2 * k + 5) << (PERIOD_BITS - 4)) & 0xFFFF
            for col in range(32):
                self.see_summ[row][col] = summ
                self.see_shift[row][col] = PERIOD_BITS - 4
                self.see_count[row][col] = 7

    # -- helpers ------------------------------------------------------------
    def _stats_addr(self, c, i=0):
        return self.ctx_stats(c) + 6 * i

    def create_successors(self, skip, s1=0, start=0):
        """Materialize the pending context chain for FoundState.

        s1, when given, is the state for the FIRST walked suffix context
        (already located — and statistics-updated — by the caller's
        suffix-update step), so it is used without a re-scan or bump;
        every later walked context is scanned and has its matched state
        bumped (+1 for multi contexts below MAX_FREQ-9; +1 for one-state
        contexts while freq <= 23 and their own suffix is one-state too).
        """
        p = self.pool
        c = start or self.min_context
        up_branch = self.st_successor(self.found_state)
        fsym = self.st_symbol(self.found_state)
        ps = []
        if not skip:
            ps.append(self.found_state)
        while self.ctx_suffix(c):
            c = self.ctx_suffix(c)
            if s1:
                s, s1 = s1, 0
            elif self.ctx_num_stats(c) != 0:
                s = self._stats_addr(c)
                while self.st_symbol(s) != fsym:
                    s += 6
                if self.st_freq(s) < MAX_FREQ - 9:
                    self.set_st_freq(s, self.st_freq(s) + 1)
                    self.set_ctx_summ_freq(c, self.ctx_summ_freq(c) + 1)
            else:
                s = self.one_state(c)
                if (
                    self.st_freq(s) <= 23
                    and self.ctx_num_stats(self.ctx_suffix(c)) == 0
                ):
                    self.set_st_freq(s, self.st_freq(s) + 1)
            successor = self.st_successor(s)
            if successor != up_branch:
                c = successor
                if not ps:
                    return c
                break
            ps.append(s)

        up_symbol = p.mem[up_branch]
        up_successor = up_branch + 1
        flags = (0x08 if up_symbol >= 0x40 else 0) + (
            0x10 if fsym >= 0x40 else 0
        )

        if self.ctx_num_stats(c) == 0:
            up_freq = self.st_freq(self.one_state(c))
        else:
            s = self._stats_addr(c)
            while self.st_symbol(s) != up_symbol:
                s += 6
            cf = self.st_freq(s) - 1
            s0 = self.ctx_summ_freq(c) - self.ctx_num_stats(c) - cf
            up_freq = 1 + (
                (1 if 5 * cf > s0 else 0)
                if 2 * cf <= s0
                else (2 * s0 + cf - 3) // s0
            )

        for s_ref in reversed(ps):
            c1 = p.alloc_context()
            if not c1:
                return 0
            self.set_ctx_num_stats(c1, 0)
            self.set_ctx_flags(c1, flags)
            one = self.one_state(c1)
            self.set_st_symbol(one, up_symbol)
            self.set_st_freq(one, up_freq)
            self.set_st_successor(one, up_successor)
            self.set_ctx_suffix(c1, c)
            self.set_st_successor(s_ref, c1)
            c = c1
        return c

    def rescale(self):
        c = self.min_context
        stats = self._stats_addr(c)
        s = self.found_state
        if s != stats:
            tmp = bytes(self.pool.mem[s : s + 6])
            while s != stats:
                self.copy_state(s, s - 6)
                s -= 6
            self.pool.mem[stats : stats + 6] = tmp
        s = stats
        esc_freq = self.ctx_summ_freq(c) - self.st_freq(s)
        self.set_st_freq(s, self.st_freq(s) + 4)
        adder = 1 if self.order_fall != 0 else 0
        self.set_st_freq(s, (self.st_freq(s) + adder) >> 1)
        sum_freq = self.st_freq(s)
        num_stats = self.ctx_num_stats(c) + 1  # actual count
        for _ in range(num_stats - 1):
            s += 6
            esc_freq -= self.st_freq(s)
            self.set_st_freq(s, (self.st_freq(s) + adder) >> 1)
            sum_freq += self.st_freq(s)
            if self.st_freq(s) > self.st_freq(s - 6):
                s1 = s
                tmp = bytes(self.pool.mem[s1 : s1 + 6])
                tmp_freq = tmp[1]
                while s1 != stats and tmp_freq > self.st_freq(s1 - 6):
                    self.copy_state(s1, s1 - 6)
                    s1 -= 6
                self.pool.mem[s1 : s1 + 6] = tmp
        if self.st_freq(s) == 0:
            i = 0
            while self.st_freq(s) == 0:
                i += 1
                s -= 6
            esc_freq += i
            new_count = num_stats - i
            self.set_ctx_num_stats(c, new_count - 1)
            if new_count == 1:
                # modern Ppmd8 collapse: freq = ceil(2*freq / esc_freq),
                # capped at MAX_FREQ/3; flags keep 0x10 and recompute 0x08
                # from the surviving symbol (pinned by the differential
                # harness on rescale-in-run inputs: canon lands exactly on
                # the 124//3 == 41 cap)
                tmp = bytearray(self.pool.mem[stats : stats + 6])
                freq = (2 * tmp[1] + esc_freq - 1) // esc_freq
                if freq > MAX_FREQ // 3:
                    freq = MAX_FREQ // 3
                tmp[1] = freq
                self.pool.free_units(stats, (num_stats + 1) >> 1)
                one = self.one_state(c)
                self.pool.mem[one : one + 6] = tmp
                self.set_ctx_flags(
                    c,
                    (self.ctx_flags(c) & 0x10)
                    + (0x08 if tmp[0] >= 0x40 else 0),
                )
                self.found_state = one
                return
            n0 = (num_stats + 1) >> 1
            n1 = (new_count + 1) >> 1
            if n0 != n1:
                self.set_ctx_stats(c, self.pool.shrink_units(stats, n0, n1))
        self.set_ctx_summ_freq(c, sum_freq + esc_freq - (esc_freq >> 1))
        # canonical marks rescaled contexts; the bit feeds the SEE column
        self.set_ctx_flags(c, self.ctx_flags(c) | 0x04)
        self.found_state = self._stats_addr(c)

    # -- memory-exhaustion restoration (canonical RestoreModel/CutOff;
    #    libarchive disassembly 0x22f40/0x22b90 — this revision treats
    #    FREEZE identically to CUT_OFF: RestoreMethod is read nowhere
    #    else) ------------------------------------------------------------

    def _special_free_unit(self, ref):
        """SpecialFreeUnit: a single unit adjacent to UnitsStart expands
        the text area instead of entering the free lists (0x2310a)."""
        p = self.pool
        if ref == p.units_start:
            p.units_start += UNIT_SIZE
        else:
            p._push(ref, 0)

    def refresh(self, c, old_nu, scale):
        """Canonical Refresh (0x22810): shrink the stats block to the
        post-restore count, rescale freqs by (f+scale)>>scale, recompute
        flags from the surviving symbols (keeps 0x04 only when scale)."""
        i = self.ctx_num_stats(c)  # count-1
        stats = self.pool.shrink_units(self.ctx_stats(c), old_nu, (i + 2) >> 1)
        self.set_ctx_stats(c, stats)
        s = stats
        flags = (self.ctx_flags(c) & (0x10 + 0x04 * scale)) + (
            0x08 if self.st_symbol(s) >= 0x40 else 0
        )
        esc = self.ctx_summ_freq(c) - self.st_freq(s)
        f = (self.st_freq(s) + scale) >> scale
        self.set_st_freq(s, f)
        summ = f
        for _ in range(i):
            s += 6
            esc -= self.st_freq(s)
            f = (self.st_freq(s) + scale) >> scale
            self.set_st_freq(s, f)
            summ += f
            flags |= 0x08 if self.st_symbol(s) >= 0x40 else 0
        self.set_ctx_summ_freq(c, summ + ((esc + scale) >> scale))
        self.set_ctx_flags(c, flags)

    CUTOFF_KEEP_ORDER = 9  # one-state contexts at order <= 9 survive a
    # dead successor (0x22bd9)

    def cut_off(self, c, order):
        """Canonical CutOff (0x22b90): prune the subtree at `c`, dropping
        states whose successors fell into the discarded text area; returns
        the (possibly moved) context ref, or 0 if freed."""
        p = self.pool
        ns = self.ctx_num_stats(c)
        if ns == 0:
            one = self.one_state(c)
            succ = self.st_successor(one)
            if succ < p.units_start:
                self._special_free_unit(c)
                return 0
            if order < self.order:
                self.set_st_successor(one, self.cut_off(succ, order + 1))
            else:
                self.set_st_successor(one, 0)
            if self.st_successor(one) != 0 or order <= self.CUTOFF_KEEP_ORDER:
                return c
            self._special_free_unit(c)
            return 0

        nu = (ns + 2) >> 1
        stats = self.ctx_stats(c)
        # MoveUnitsUp: when the stats block sits within 16 KiB of the
        # text boundary and a higher free block of the same class exists,
        # relocate upward so the boundary can expand (0x22c18)
        if stats <= p.units_start + 0x4000:
            i = U2I[nu - 1]
            head = p.free_list[i]
            if head >= stats and head != 0:
                head = p._pop(i)
                p.mem[head : head + nu * UNIT_SIZE] = p.mem[
                    stats : stats + nu * UNIT_SIZE
                ]
                if stats == p.units_start:
                    p.units_start += I2U[i] * UNIT_SIZE
                else:
                    p._push(stats, i)
                stats = head
        self.set_ctx_stats(c, stats)

        tmp = ns
        for pos in range(ns, -1, -1):
            s = stats + 6 * pos
            succ = self.st_successor(s)
            if succ < p.units_start:
                # dead state: zero successor, swap to the tail (0x22d1c —
                # the tail slot keeps only (sym, freq), successor zeroed)
                self.set_st_successor(s, 0)
                s2 = stats + 6 * tmp
                sym_freq = bytes(p.mem[s : s + 2])
                p.mem[s : s + 6] = p.mem[s2 : s2 + 6]
                p.mem[s2 : s2 + 2] = sym_freq
                p.mem[s2 + 2 : s2 + 6] = b"\x00\x00\x00\x00"
                tmp -= 1
            elif order < self.order:
                self.set_st_successor(s, self.cut_off(succ, order + 1))
            else:
                self.set_st_successor(s, 0)

        if tmp != ns and order != 0:
            self.set_ctx_num_stats(c, tmp & 0xFF)
            if tmp < 0:
                p._push(stats, U2I[nu - 1])
                self._special_free_unit(c)
                return 0
            if tmp == 0:
                flags = (self.ctx_flags(c) & 0x10) + (
                    0x08 if p.mem[stats] >= 0x40 else 0
                )
                one = self.one_state(c)
                p.mem[one : one + 6] = bytes(p.mem[stats : stats + 6])
                p._push(stats, U2I[nu - 1])
                self.set_st_freq(one, (self.st_freq(one) + 11) >> 3)
                self.set_ctx_flags(c, flags)
                return c
            self.refresh(
                c, nu, 1 if self.ctx_summ_freq(c) > 16 * tmp else 0
            )
        return c

    def expand_text_area(self):
        """Canonical ExpandTextArea (inlined at 0x23154): reclaim free
        nodes sitting directly above UnitsStart into the text area, then
        unlink exactly those (stamp-cleared) nodes from the free lists."""
        p = self.pool
        mem = p.mem
        count = [0] * N_INDEXES
        if p.lo_unit != p.hi_unit:
            mem[p.lo_unit : p.lo_unit + 4] = b"\x00\x00\x00\x00"
        while int.from_bytes(mem[p.units_start : p.units_start + 4], "little") == 0xFFFFFFFF:
            nu = int.from_bytes(mem[p.units_start + 8 : p.units_start + 12], "little")
            if not (1 <= nu <= 128):
                # stale stamp over garbage: the canonical would walk into
                # undefined memory here; surface the valid-region boundary
                raise IndexError("corrupt free node in text-area expansion")
            mem[p.units_start : p.units_start + 4] = b"\x00\x00\x00\x00"
            count[U2I[nu - 1]] += 1
            p.units_start += nu * UNIT_SIZE
        for i in range(N_INDEXES):
            k = count[i]
            if not k:
                continue
            prev = None  # None = list head
            ref = p.free_list[i]
            while k and ref:
                nxt = int.from_bytes(mem[ref + 4 : ref + 8], "little")
                if int.from_bytes(mem[ref : ref + 4], "little") == 0:
                    if prev is None:
                        p.free_list[i] = nxt
                    else:
                        mem[prev + 4 : prev + 8] = nxt.to_bytes(4, "little")
                    p.stamps[i] -= 1
                    k -= 1
                else:
                    prev = ref
                ref = nxt

    def _used_memory(self):
        p = self.pool
        free_units = sum(I2U[i] * p.stamps[i] for i in range(N_INDEXES))
        return (
            p.size
            - (p.hi_unit - p.lo_unit)
            - (p.units_start - p.text)
            - free_units * UNIT_SIZE
        )

    def restore_model(self, ctx_error):
        """Canonical RestoreModel (0x22f40): undo the half-applied update
        (phase 1: contexts that already gained the new symbol; phase 2:
        freq decay down to MinContext), then either restart or cut the
        tree until it fits in 3/4 of the pool."""
        p = self.pool
        p.text = 0
        c = self.max_context
        while c != ctx_error:
            ns = self.ctx_num_stats(c) - 1
            self.set_ctx_num_stats(c, ns & 0xFF)
            if ns == 0:
                stats = self.ctx_stats(c)
                flags = (self.ctx_flags(c) & 0x10) + (
                    0x08 if p.mem[stats] >= 0x40 else 0
                )
                one = self.one_state(c)
                p.mem[one : one + 6] = bytes(p.mem[stats : stats + 6])
                self._special_free_unit(stats)
                self.set_st_freq(one, (self.st_freq(one) + 11) >> 3)
                self.set_ctx_flags(c, flags)
            else:
                self.refresh(c, (ns + 3) >> 1, 0)
            c = self.ctx_suffix(c)
        while c != self.min_context:
            if self.ctx_num_stats(c) == 0:
                one = self.one_state(c)
                self.set_st_freq(one, self.st_freq(one) - (self.st_freq(one) >> 1))
            else:
                summ = self.ctx_summ_freq(c) + 4
                self.set_ctx_summ_freq(c, summ)
                if summ > 128 + 4 * self.ctx_num_stats(c):
                    self.refresh(c, (self.ctx_num_stats(c) + 2) >> 1, 1)
            c = self.ctx_suffix(c)

        if self.restore_method == 0 or self._used_memory() < p.size >> 1:
            self.restart()
            return
        root = self.max_context
        while self.ctx_suffix(root):
            root = self.ctx_suffix(root)
        self.max_context = root
        while True:
            self.cut_off(root, 0)
            self.expand_text_area()
            if self._used_memory() <= 3 * (p.size >> 2):
                break
        p.glue_count = 0
        self.order_fall = self.order
        # NOTE: the canonical leaves MinContext untouched here (verified
        # in the disassembly tail, 0x23264) — replicated for conformance.

    def _exhausted(self, ctx_error=None):
        """Pool exhausted mid-update: RESTART (method 0) drops the whole
        model; CUT_OFF/FREEZE (methods 1/2) run the canonical RestoreModel
        tree surgery (this Ppmd8 revision treats them identically)."""
        if self.restore_method != 0:
            self.restore_model(
                ctx_error if ctx_error is not None else self.max_context
            )
            return
        self.restart()

    def update_model(self):
        p = self.pool
        f_state = self.found_state
        f_freq = self.st_freq(f_state)
        f_symbol = self.st_symbol(f_state)
        f_successor = self.st_successor(f_state)
        mc = self.min_context

        sfx_state = 0  # the state the suffix-update located (s1 below)
        if f_freq < MAX_FREQ // 4 and self.ctx_suffix(mc):
            c = self.ctx_suffix(mc)
            if self.ctx_num_stats(c) == 0:
                s = self.one_state(c)
                if self.st_freq(s) < 32:
                    self.set_st_freq(s, self.st_freq(s) + 1)
            else:
                s = self._stats_addr(c)
                if self.st_symbol(s) != f_symbol:
                    while self.st_symbol(s) != f_symbol:
                        s += 6
                    if self.st_freq(s) >= self.st_freq(s - 6):
                        self.swap_states(s, s - 6)
                        s -= 6
                if self.st_freq(s) < MAX_FREQ - 9:
                    self.set_st_freq(s, self.st_freq(s) + 2)
                    self.set_ctx_summ_freq(c, self.ctx_summ_freq(c) + 2)
            sfx_state = s

        if self.order_fall == 0:
            c = self.create_successors(True, s1=sfx_state)
            if not c:
                # canonical 0x238e1: the found state's stale text-pointer
                # successor is zeroed before restoring
                self.set_st_successor(f_state, 0)
                self._exhausted(self.max_context)
                return
            self.min_context = self.max_context = c
            self.set_st_successor(f_state, c)
            return

        p.mem[p.text] = f_symbol
        p.text += 1
        successor = p.text
        if p.text >= p.units_start:
            self._exhausted(self.max_context)
            return

        if f_successor:
            if f_successor <= p.text:  # points into the text area
                f_successor = self.create_successors(False, s1=sfx_state)
                if not f_successor:
                    self._exhausted(self.max_context)
                    return
            self.order_fall -= 1
            if self.order_fall == 0:
                successor = f_successor
                if self.max_context != self.min_context:
                    p.text -= 1
        else:
            # fresh symbol: the modern UpdateModel walks the suffix
            # chain, linking every context whose matching state has no
            # successor yet to the new text position (bumping its
            # frequency), until it meets a state that already leads
            # somewhere — that state's target becomes the new context.
            self.set_st_successor(f_state, successor)
            self.order_fall += 1
            c = mc
            s1 = sfx_state  # canonical 0x23514: the suffix-update's state
            # is reused, unbumped, for the first walked context (cleared
            # after one use, 0x2350b) — same pass-through as in
            # create_successors
            while True:
                sfx = self.ctx_suffix(c)
                if not sfx:
                    f_successor = c  # whole chain linked; land at the root
                    break
                c = sfx
                if s1:
                    s, s1 = s1, 0
                elif self.ctx_num_stats(c) != 0:
                    s = self._stats_addr(c)
                    while self.st_symbol(s) != f_symbol:
                        s += 6
                    if self.st_freq(s) <= MAX_FREQ - 10:
                        self.set_st_freq(s, self.st_freq(s) + 2)
                        self.set_ctx_summ_freq(c, self.ctx_summ_freq(c) + 2)
                else:
                    s = self.one_state(c)
                    if self.st_freq(s) <= 31:
                        self.set_st_freq(s, self.st_freq(s) + 1)
                tgt = self.st_successor(s)
                if tgt == 0:
                    self.set_st_successor(s, successor)
                    self.order_fall += 1
                    continue
                if tgt <= successor:  # a text position: materialize it
                    save = self.found_state
                    self.found_state = s
                    cs = self.create_successors(False, start=c)
                    self.found_state = save
                    if not cs:
                        self._exhausted(self.max_context)
                        return
                    self.set_st_successor(s, cs)
                    tgt = cs
                f_successor = tgt
                break
            self.order_fall -= 1
            if self.order_fall == 0:
                successor = f_successor
                if self.max_context != self.min_context:
                    p.text -= 1

        ns = self.ctx_num_stats(mc) + 1
        s0 = self.ctx_summ_freq(mc) - ns - (f_freq - 1)
        c = self.max_context
        while c != mc:
            ns1 = self.ctx_num_stats(c) + 1
            if ns1 != 1:
                if (ns1 & 1) == 0:
                    new_stats = p.expand_units(self.ctx_stats(c), ns1 >> 1)
                    if not new_stats:
                        self._exhausted(c)
                        return
                    self.set_ctx_stats(c, new_stats)
                # disassembly 0x2344e: 3*NumStats+1 < NumStats_mc with BOTH
                # operands in count-1 form, so the right side is ns - 1
                self.set_ctx_summ_freq(
                    c,
                    self.ctx_summ_freq(c)
                    + (1 if 3 * (ns1 - 1) + 1 < ns - 1 else 0),
                )
            else:
                new_stats = p.alloc_units(0)
                if not new_stats:
                    self._exhausted(c)
                    return
                self.copy_state(new_stats, self.one_state(c))
                self.set_ctx_stats(c, new_stats)
                freq = self.st_freq(new_stats)
                if freq < MAX_FREQ // 4 - 1:
                    freq += freq
                else:
                    freq = MAX_FREQ - 4
                self.set_st_freq(new_stats, freq)
                # disassembly 0x235e6: cmpl $2 against NumStats (count-1),
                # seta — i.e. the +1 applies only when count > 3
                self.set_ctx_summ_freq(
                    c, freq + self.init_esc + (1 if ns > 3 else 0)
                )
            cf = 2 * f_freq * (self.ctx_summ_freq(c) + 6)
            sf = s0 + self.ctx_summ_freq(c)
            if cf < 6 * sf:
                cf = 1 + (1 if cf > sf else 0) + (1 if cf >= 4 * sf else 0)
                self.set_ctx_summ_freq(c, self.ctx_summ_freq(c) + 4)
            else:
                # canonical var.I uses STRICT > here (unlike Ppmd7's >=);
                # pinned by the differential harness at cf == 12*sf
                cf = (
                    4
                    + (1 if cf > 9 * sf else 0)
                    + (1 if cf > 12 * sf else 0)
                    + (1 if cf > 15 * sf else 0)
                )
                self.set_ctx_summ_freq(c, self.ctx_summ_freq(c) + cf)
            s = self._stats_addr(c, ns1)
            self.set_st_successor(s, successor)
            self.set_st_symbol(s, f_symbol)
            self.set_st_freq(s, cf)
            self.set_ctx_num_stats(c, ns1)  # count-1 of the grown set
            self.set_ctx_flags(
                c, self.ctx_flags(c) | (0x08 if f_symbol >= 0x40 else 0)
            )
            c = self.ctx_suffix(c)
        self.max_context = self.min_context = f_successor

    def next_context(self):
        c = self.st_successor(self.found_state)
        if self.order_fall == 0 and c >= self.pool.units_start:
            self.min_context = self.max_context = c
        else:
            self.update_model()
            # canonical NextContext (0x23a9c): MinContext = MaxContext
            # after EVERY UpdateModel return — this is what re-anchors
            # the decode context at the root after a cutoff restore
            self.min_context = self.max_context

    def update1(self, s):
        self.set_st_freq(s, self.st_freq(s) + 4)
        self.set_ctx_summ_freq(self.min_context, self.ctx_summ_freq(self.min_context) + 4)
        if self.st_freq(s) > self.st_freq(s - 6):
            self.swap_states(s, s - 6)
            s -= 6
            self.found_state = s
            if self.st_freq(s) > MAX_FREQ:
                self.rescale()
        else:
            self.found_state = s
        self.next_context()

    def update1_0(self, s):
        # disassembly 0x23a58: setge — 2*freq >= SummFreq (Ppmd7 uses >)
        self.prev_success = (
            1 if 2 * self.st_freq(s) >= self.ctx_summ_freq(self.min_context) else 0
        )
        self.run_length += self.prev_success
        self.set_ctx_summ_freq(self.min_context, self.ctx_summ_freq(self.min_context) + 4)
        self.set_st_freq(s, self.st_freq(s) + 4)
        self.found_state = s
        if self.st_freq(s) > MAX_FREQ:
            self.rescale()
        self.next_context()

    def update_bin(self, s):
        if self.st_freq(s) < 196:
            self.set_st_freq(s, self.st_freq(s) + 1)
        self.prev_success = 1
        self.run_length += 1
        self.found_state = s
        self.next_context()

    def update2(self, s):
        self.set_st_freq(s, self.st_freq(s) + 4)
        self.set_ctx_summ_freq(self.min_context, self.ctx_summ_freq(self.min_context) + 4)
        self.found_state = s
        if self.st_freq(s) > MAX_FREQ:
            self.rescale()
        self.run_length = self.init_rl
        self.update_model()
        self.min_context = self.max_context  # canonical Update2 tail

    # -- probability selection ---------------------------------------------
    def bin_index(self, c):
        one = self.one_state(c)
        row = NS2INDX[self.st_freq(one) - 1]
        suffix = self.ctx_suffix(c)
        col = (
            self.prev_success
            + NS2BSINDX[self.ctx_num_stats(suffix)]
            + self.ctx_flags(c)
            + ((self.run_length >> 26) & 0x20)
        )
        return row, col

    def bin_update0(self, row, col):
        prob = self.bin_summ[row][col]
        self.bin_summ[row][col] = (
            prob + (1 << INT_BITS) - ((prob + (1 << (PERIOD_BITS - 2))) >> PERIOD_BITS)
        ) & 0xFFFF

    def bin_update1(self, row, col):
        prob = self.bin_summ[row][col]
        self.bin_summ[row][col] = (
            prob - ((prob + (1 << (PERIOD_BITS - 2))) >> PERIOD_BITS)
        ) & 0xFFFF
        self.init_esc = EXP_ESCAPE[(self.bin_summ[row][col] >> 10) & 0x3F]

    def make_esc_freq(self, c, num_masked_count):
        nm1 = self.ctx_num_stats(c)  # count - 1
        if nm1 != 0xFF:
            suffix = self.ctx_suffix(c)
            row = NS2INDX[nm1 + 2] - 3
            col = (
                (1 if self.ctx_summ_freq(c) > 11 * (nm1 + 1) else 0)
                + 2
                * (
                    1
                    if 2 * nm1
                    < self.ctx_num_stats(suffix) + (num_masked_count - 1)
                    else 0
                )
                + self.ctx_flags(c)
            )
            summ = self.see_summ[row][col]
            r = summ >> self.see_shift[row][col]
            self.see_summ[row][col] = (summ - r) & 0xFFFF
            esc_freq = r + (1 if r == 0 else 0)
            return (row, col), esc_freq
        return None, 1

    def see_update(self, see):
        if see is None:
            return
        row, col = see
        if self.see_shift[row][col] < PERIOD_BITS:
            self.see_count[row][col] -= 1
            if self.see_count[row][col] == 0:
                self.see_summ[row][col] = (self.see_summ[row][col] << 1) & 0xFFFF
                self.see_count[row][col] = 3 << self.see_shift[row][col]
                self.see_shift[row][col] += 1

    def see_add(self, see, freq_sum):
        if see is None:
            return
        row, col = see
        self.see_summ[row][col] = (self.see_summ[row][col] + freq_sum) & 0xFFFF


# ---------------------------------------------------------------------------
# Symbol coding: one step of decode/encode against the shared model
# ---------------------------------------------------------------------------


def _decode_symbol(m: _Model, rc: _RangeDecoder):
    mc = m.min_context
    if m.ctx_num_stats(mc) != 0:
        s = m._stats_addr(mc)
        summ = m.ctx_summ_freq(mc)
        count = rc.threshold(summ)
        hi_cnt = m.st_freq(s)
        if count < hi_cnt:
            rc.decode(0, hi_cnt)
            sym = m.st_symbol(s)
            m.update1_0(s)
            return sym
        m.prev_success = 0
        i = m.ctx_num_stats(mc)
        found = None
        while i:
            s += 6
            f = m.st_freq(s)
            hi_cnt += f
            if hi_cnt > count:
                found = s
                break
            i -= 1
        if found is not None:
            rc.decode(hi_cnt - m.st_freq(found), m.st_freq(found))
            sym = m.st_symbol(found)
            m.update1(found)
            return sym
        if count >= summ:
            raise PpmdError("corrupt PPMd stream (symbol threshold)")
        rc.decode(hi_cnt, summ - hi_cnt)
        mask = bytearray(256)
        s = m._stats_addr(mc)
        for _ in range(m.ctx_num_stats(mc) + 1):
            mask[m.st_symbol(s)] = 1
            s += 6
        num_masked = m.ctx_num_stats(mc) + 1
    else:
        one = m.one_state(mc)
        row, col = m.bin_index(mc)
        prob = m.bin_summ[row][col]
        if rc.decode_bit(prob) == 0:
            m.bin_update0(row, col)
            sym = m.st_symbol(one)
            m.update_bin(one)
            return sym
        m.bin_update1(row, col)
        mask = bytearray(256)
        mask[m.st_symbol(one)] = 1
        m.prev_success = 0
        num_masked = 1

    while True:
        m.order_fall += 1
        mc = m.ctx_suffix(m.min_context)
        if not mc:
            return -1  # end of stream
        m.min_context = mc
        while m.ctx_num_stats(mc) + 1 == num_masked:
            m.order_fall += 1
            mc = m.ctx_suffix(mc)
            if not mc:
                return -1
            m.min_context = mc
        hi_cnt = 0
        s = m._stats_addr(mc)
        candidates = []
        for _ in range(m.ctx_num_stats(mc) + 1):
            if not mask[m.st_symbol(s)]:
                hi_cnt += m.st_freq(s)
                candidates.append(s)
            s += 6
        see, esc_freq = m.make_esc_freq(mc, num_masked)
        freq_sum = hi_cnt + esc_freq
        count = rc.threshold(freq_sum)
        if count < hi_cnt:
            acc = 0
            for s in candidates:
                acc += m.st_freq(s)
                if acc > count:
                    break
            rc.decode(acc - m.st_freq(s), m.st_freq(s))
            m.see_update(see)
            sym = m.st_symbol(s)
            m.update2(s)
            return sym
        if count >= freq_sum:
            raise PpmdError("corrupt PPMd stream (escape threshold)")
        rc.decode(hi_cnt, freq_sum - hi_cnt)
        m.see_add(see, freq_sum)
        for s in candidates:
            mask[m.st_symbol(s)] = 1
        num_masked = m.ctx_num_stats(mc) + 1


def _encode_symbol(m: _Model, rc: _RangeEncoder, sym: int):
    """Encode one symbol; sym = -1 encodes the end-of-stream marker
    (never found anywhere, escapes out below the root)."""
    mc = m.min_context
    if m.ctx_num_stats(mc) != 0:
        s = m._stats_addr(mc)
        summ = m.ctx_summ_freq(mc)
        if m.st_symbol(s) == sym:
            rc.encode(0, m.st_freq(s), summ)
            m.update1_0(s)
            return
        low = m.st_freq(s)
        m.prev_success = 0
        i = m.ctx_num_stats(mc)
        found = None
        while i:
            s += 6
            if m.st_symbol(s) == sym:
                found = s
                break
            low += m.st_freq(s)
            i -= 1
        if found is not None:
            rc.encode(low, m.st_freq(found), summ)
            m.update1(found)
            return
        # escape: the symbol is absent from this context
        hi_cnt = 0
        s2 = m._stats_addr(mc)
        mask = bytearray(256)
        for _ in range(m.ctx_num_stats(mc) + 1):
            hi_cnt += m.st_freq(s2)
            mask[m.st_symbol(s2)] = 1
            s2 += 6
        rc.encode(hi_cnt, summ - hi_cnt, summ)
        num_masked = m.ctx_num_stats(mc) + 1
    else:
        one = m.one_state(mc)
        row, col = m.bin_index(mc)
        prob = m.bin_summ[row][col]
        if m.st_symbol(one) == sym:
            rc.encode_bit0(prob)
            m.bin_update0(row, col)
            m.update_bin(one)
            return
        rc.encode_bit1(prob)
        m.bin_update1(row, col)
        mask = bytearray(256)
        mask[m.st_symbol(one)] = 1
        m.prev_success = 0
        num_masked = 1

    while True:
        m.order_fall += 1
        mc = m.ctx_suffix(m.min_context)
        if not mc:
            return  # end marker complete (escaped below the root)
        m.min_context = mc
        while m.ctx_num_stats(mc) + 1 == num_masked:
            m.order_fall += 1
            mc = m.ctx_suffix(mc)
            if not mc:
                return
            m.min_context = mc
        hi_cnt = 0
        low = 0
        s_found = None
        s = m._stats_addr(mc)
        candidates = []
        for _ in range(m.ctx_num_stats(mc) + 1):
            if not mask[m.st_symbol(s)]:
                if m.st_symbol(s) == sym:
                    s_found = s
                    low = hi_cnt
                hi_cnt += m.st_freq(s)
                candidates.append(s)
            s += 6
        see, esc_freq = m.make_esc_freq(mc, num_masked)
        freq_sum = hi_cnt + esc_freq
        if s_found is not None:
            rc.encode(low, m.st_freq(s_found), freq_sum)
            m.see_update(see)
            m.update2(s_found)
            return
        rc.encode(hi_cnt, esc_freq, freq_sum)
        m.see_add(see, freq_sum)
        for s in candidates:
            mask[m.st_symbol(s)] = 1
        num_masked = m.ctx_num_stats(mc) + 1


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def compress(
    data: bytes, order: int = 8, mem_mb: int = 16, restore_method: int = 0
) -> bytes:
    """PPMd var.I compress. Returns the raw range-coded stream
    (no ZIP parameter word; see zip_compress)."""
    m = _Model(order, mem_mb << 20, restore_method)
    rc = _RangeEncoder()
    try:
        for b in data:
            _encode_symbol(m, rc, b)
        _encode_symbol(m, rc, -1)  # end marker: escapes out below the root
    except IndexError:
        # CUT_OFF/FREEZE edge case: UnitsStart can grow mid-CutOff and
        # invalidate successors kept earlier in the recursion, after
        # which the CANONICAL implementation walks garbage memory
        # (undefined behavior; this area of Ppmd8 has CVE history).
        # We refuse to emit such a stream instead.
        raise PpmdError(
            "PPMd model entered the canonical implementation's "
            "undefined-behavior region (CUT_OFF/FREEZE restoration edge "
            "case); use restoration method 0"
        ) from None
    return rc.flush()


def decompress(
    data: bytes,
    order: int = 8,
    mem_mb: int = 16,
    size: int | None = None,
    restore_method: int = 0,
) -> bytes:
    """PPMd var.I decompress (raw stream). Stops at the end marker or
    after `size` bytes when given (ZIP members carry the exact size).

    Decodes natively (native/volxel_ppmd.cpp, a port of the model below,
    pinned equal by tests/test_ppmd.py) when the library is available —
    the pure-Python model runs ~10-20 KB/s, far too slow for real
    method-98 DICOM archives; it remains the reference implementation
    and the fallback."""
    from volxel_tpu_torch.native.loader import native_available
    from volxel_tpu_torch.native.loader import ppmd_decompress as native_ppmd

    if not (2 <= order <= MAX_ORDER):
        raise PpmdError(f"unsupported PPMd order {order}")
    if native_available():
        rc, out = native_ppmd(data, order, mem_mb, restore_method, size)
        if rc >= 0:
            return out
        if rc == -1:
            raise PpmdError("corrupt PPMd stream (symbol threshold)")
        if rc == -3:
            raise PpmdError("unexpected PPMd end marker")
        raise PpmdError(f"PPMd decode failed (native rc={rc})")
    m = _Model(order, mem_mb << 20, restore_method)
    rc = _RangeDecoder(data)
    out = bytearray()
    try:
        while size is None or len(out) < size:
            sym = _decode_symbol(m, rc)
            if sym < 0:
                if size is not None and len(out) < size:
                    raise PpmdError("unexpected PPMd end marker")
                break
            out.append(sym)
    except IndexError:
        raise PpmdError(
            "corrupt PPMd stream (model left the valid region — the "
            "canonical decoder would read undefined memory here)"
        ) from None
    return bytes(out)


def zip_compress(
    data: bytes, order: int = 8, mem_mb: int = 16, restore_method: int = 0
) -> bytes:
    """Compress with the ZIP method-98 parameter word prepended."""
    if not (2 <= order <= 16 and 1 <= mem_mb <= 256 and 0 <= restore_method <= 2):
        raise PpmdError("parameters out of range for the ZIP header")
    w = (order - 1) | ((mem_mb - 1) << 4) | (restore_method << 12)
    return w.to_bytes(2, "little") + compress(data, order, mem_mb, restore_method)


def zip_decompress(data: bytes, size: int | None = None) -> bytes:
    """Decompress a ZIP method-98 member (parameter word + stream)."""
    if len(data) < 2:
        raise PpmdError("PPMd member shorter than its parameter word")
    w = int.from_bytes(data[:2], "little")
    order = (w & 0xF) + 1
    mem_mb = ((w >> 4) & 0xFF) + 1
    restor = w >> 12
    if restor > 2:
        raise PpmdError(f"unknown PPMd restoration method {restor}")
    return decompress(data[2:], order, mem_mb, size, restore_method=restor)
