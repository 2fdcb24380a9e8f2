// VariantQC's record classification and RohHunter's ROH products for Hopper
// (sm_90a): the device side of `variant_classify_into` and
// `roh_products_into` in ngsbits_tpu_torch/ops/variants.py, one launch each
// on the caller's stream.
//
//   variant_classify  V1: the nine record counts of VariantQC (passing,
//                     known, high impact, homozygous, indel, transition,
//                     transversion, mosaic, heterozygous), added into nine
//                     int64 counters. Not a TPU kernel: it replaces the JAX
//                     package's host loops over every record
//                     (ngsbits_tpu/qc/variant_stats.py:49-144, and the het
//                     count of `phasing`, :147-165).
//   roh_products      H1: for each [start, end] index range the product of
//                     af * af over the range, in index order, in double.
//                     Not a TPU kernel: it replaces the host product of
//                     `_Roh.q_score` (ngsbits_tpu/tools/roh_hunter.py:51-59).
//
// V1's input is the records' fields packed on the host into one flat byte
// buffer: REF, ALT, FILTER, INFO, FORMAT and the first sample's field of
// record i are bytes [offsets[6i + k], offsets[6i + k + 1]) for k = 0..5,
// the buffer 16-byte aligned and padded to a multiple of 16 bytes. The work
// is one read of those bytes (INFO is most of them: a VEP CSQ of one to four
// transcripts, about 424 bytes a record) and a few compares a byte, so it is
// bound by the bytes. The semantics are the port's host accessors'
// (ngsbits_tpu_torch/io/vcf.py): FILTER passes when empty, "." or "PASS";
// INFO's CSQ and RS values are those of the first entry whose key is exactly
// CSQ (RS), a flag giving "TRUE"; "|rs" and "|HIGH|" count where they lie
// wholly inside the CSQ value; GT is the sample's field at the index of the
// first FORMAT key "GT".
//
// V1's design: a team of 32 lanes (a warp) takes a record at a time, so
// that its loads are coalesced and its lanes do not wait on each other's
// field lengths. Its per-byte tests are integer operations, which Hopper
// issues at half the rate of the others: the design keeps them few.
// - Groups. A team takes 32 consecutive records at a time. Lane k loads
//   record k's seven offsets (contiguous) and stages them as 32-bit offsets
//   from the record's first 16-byte chunk with its step count, and with the
//   FILTER test tests record k's FILTER (its one or two chunks loaded at
//   once): a ballot gives the records that count, and a failing record reads
//   nothing more.
// - Steps. The team reads a record's chunks from REF's through the one that
//   holds byte offsets[6i + 6] (the record's end, a virtual separator) in
//   steps of 32 chunks, 512 bytes: each lane one 16-byte load that skips L1
//   (ld.global.nc.L1::no_allocate) into a register one step ahead, stored
//   into the team's ring of four 512-byte slots in shared memory when the
//   step begins. So the next step's loads, or the next record's, are in
//   flight while a step is evaluated, a lane reads the 8 bytes before its
//   chunk (the previous lane's, or the previous step's) from the ring, and
//   one warp sync a step suffices. The buffer is padded to 16 bytes: a chunk
//   that holds a record byte never leaves it. One step covers the average
//   record; a longer one takes more with its state carried (an INFO over
//   64 KiB takes 128).
// - INFO's keys. An entry starts at INFO's start or after ';'. Where some
//   lane holds a ';' (a zero-byte test on its words), each lane takes the
//   entries that start after its ';' in [o - 4, o + 12) (its chunk starting
//   at o): the key and its terminator, four bytes, lie in this step, or at
//   and past INFO's end, where the entry ends; the lane holding INFO's end
//   takes the rest. A key counts when it is exactly CSQ (RS) followed by
//   ';', '=' or INFO's end; the first over the team (a ballot, then __ffs)
//   is the record's, a flag shadowing a later value. The RS value's first
//   two bytes come from the ring.
// - The CSQ value. It ends at the first ';' at or after its start (a ballot
//   of exact ';' masks where some lane holds one) or at INFO's end. "|rs" and
//   "|HIGH|" count when they start at or after its start and end before its
//   end; a lane tests its 16 positions (4-byte words ending at each, funnel
//   shifts over its chunk and the 8 bytes before it) only where some lane
//   holds their last two bytes ("rs", "H|": zero-halfword tests of its words
//   and of its words shifted a byte). The 8 bytes before a chunk carry a
//   pattern across the 512-byte seam, counted once.
// - The short fields. REF's byte and ALT's first two come from the ring;
//   FORMAT and the sample's first 64 bytes are copied from the ring to the
//   team's shared memory. After the group's steps, lane k finishes record k:
//   the first FORMAT key GT and the sample's value at its index (past the
//   64 bytes from the buffer), the indel, transition or transversion, then
//   a ballot a count.
// - Counts. Lane k keeps count k; a block sums them in shared memory and
//   adds them into the counters with one 64-bit atomic a counter.
//
// H1 takes the markers' allele frequencies as float64 (each a float32 value,
// so a * a is exact in double) and [k, 2] int64 inclusive index ranges. It
// multiplies each range's squares in index order with __dmul_rn, which nvcc
// neither contracts nor reassociates, so the product is bit-equal to the
// host's `p *= float(af) ** 2` (its pow(x, 2.0) is x * x, exact for a float32
// x), subnormals and underflow to 0 included. A range outside [0, m) gives
// NaN; an empty range (start > end) gives 1. The work is one read of 8 bytes
// a marker covered and 16 a range, but the product is a chain of dependent
// multiplies: the longest range's chain bounds the launch.
// - The early exit. A square is +0, positive finite, +inf or NaN, so once
//   the product leaves the positive finite numbers (RohHunter's af is at
//   least 0.01: a long run's product underflows to 0 within a few hundred
//   markers) only a few squares can still change it (h1_changes), and one
//   order-free test over the rest of the range settles it. The serial part
//   is the chain up to the exit, not the range. A NaN product is final
//   (h1_changes).
// - A warp a long range: lanes load a 32-marker chunk each chunk, coalesced,
//   kH1Ahead chunks ahead, and stage its squares in shared memory; the chain
//   reads them as broadcasts, so only the multiply's latency is serial.
//   Short ranges (a run's raw runs: most hold a few markers) are a lane's.
// - The rests. A chain that exits at 0 or +inf lists its rest; the block's
//   threads then test all its rests' markers at once, many loads in flight,
//   and multiply each product by its first changing square (a NaN comes
//   from the card's own multiply, as in the plain version).

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCounters = 9;
enum Counter { kPassing, kKnown, kHigh, kHom, kIndel, kTi, kTv, kMosaic, kHet };
constexpr int kFields = 6;  // REF, ALT, FILTER, INFO, FORMAT, the first sample

// V1's shape
constexpr int kLanes = 32;                      // lanes a record: a team
constexpr int kTeams = kThreads / kLanes;       // teams a block
constexpr int kGroup = 32;                      // records whose offsets a team stages at once
constexpr int kStep = 16 * kLanes;              // bytes a step: a 16-byte chunk a lane
constexpr int kSlots = 4;                       // steps a team's ring holds
constexpr int kRing = kSlots * kStep;
constexpr int kV1BlocksPerSm = 3;               // V1's grid cap and register budget
constexpr int kTail = 64;                       // FORMAT and sample bytes copied a record
constexpr int kFar = 1 << 30;                   // offsets from a record's base are clamped to it
constexpr int kRebaseSteps = 1 << 20;           // steps between moves of a record's base
static_assert(kGroup <= kLanes, "a lane tests one record's FILTER");
static_assert(kCounters <= kLanes, "a lane keeps one count");
static_assert((kSlots & (kSlots - 1)) == 0, "ring offsets wrap by a mask");

constexpr unsigned word4(char a, char b, char c, char d) {
    return static_cast<unsigned char>(a) | static_cast<unsigned char>(b) << 8 |
           static_cast<unsigned char>(c) << 16 | static_cast<unsigned>(static_cast<unsigned char>(d)) << 24;
}
// the words the tests compare, lowest byte first: a key's first bytes after
// its ';', and the 4-byte words ending at a pattern's positions
constexpr unsigned kCsq = word4('C', 'S', 'Q', 0);          // & 0x00FFFFFF: "CSQ"
constexpr unsigned kRs = word4('R', 'S', 0, 0);             // & 0x0000FFFF: "RS"
constexpr unsigned kPipeRs = word4(0, '|', 'r', 's');       // & 0xFFFFFF00: "|rs"
constexpr unsigned kIghPipe = word4('I', 'G', 'H', '|');    // "|HIGH|": the last four bytes
constexpr unsigned kPipeH = word4(0, 0, '|', 'H');          // & 0xFFFF0000, four bytes earlier
constexpr unsigned kPass = word4('P', 'A', 'S', 'S');
constexpr unsigned kRsPair2 = word4('r', 's', 'r', 's');    // a pair's two bytes, twice
constexpr unsigned kHPipe2 = word4('H', '|', 'H', '|');
constexpr unsigned kSemis = 0x3B3B3B3Bu;  // ';' four times

// One 16-byte load that does not allocate in L1: each chunk is read once.
__device__ __forceinline__ uint4 load_once(const uint4* p) {
    uint4 v;
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
    return v;
}

__device__ __forceinline__ unsigned byte_of(const uint4& v, int k) {
    const unsigned w = k < 8 ? (k < 4 ? v.x : v.y) : (k < 12 ? v.z : v.w);
    return (w >> ((k & 3) * 8)) & 0xFFu;
}

// Bit 4i + j for byte j of word i that equals the byte of c4 (c4 holds it
// four times): 0x80 in each zero byte of w ^ c4, exact, then the four high
// bits gathered by one multiply (their partial products never overlap).
__device__ __forceinline__ unsigned equal_bits(unsigned w, unsigned c4) {
    const unsigned x = w ^ c4;
    const unsigned z = ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x | 0x7F7F7F7Fu);
    return (z * 0x00204081u) >> 28;
}

__device__ __forceinline__ unsigned chunk_bits(const uint4& v, unsigned c4) {
    return equal_bits(v.x, c4) | equal_bits(v.y, c4) << 4 | equal_bits(v.z, c4) << 8 |
           equal_bits(v.w, c4) << 12;
}

// Non-zero when some byte (halfword) of v is 0; exact as a test.
__device__ __forceinline__ unsigned zero_byte(unsigned v) {
    return (v - 0x01010101u) & ~v & 0x80808080u;
}
__device__ __forceinline__ unsigned zero_half(unsigned v) {
    return (v - 0x00010001u) & ~v & 0x80008000u;
}

// Bits e of a lane's 16 positions o + e that lie in [lo, hi].
__device__ __forceinline__ unsigned span_bits(int o, int lo, int hi) {
    const int ia = min(max(lo - o, 0), 16), ib = min(max(hi - o + 1, 0), 16);
    return ((1u << ib) - 1u) & ~((1u << ia) - 1u);
}

// Bits k of the 20 positions base + k that lie in [lo, hi].
__device__ __forceinline__ unsigned span_bits20(int base, int lo, int hi) {
    const int ia = min(max(lo - base, 0), 20), ib = min(max(hi - base + 1, 0), 20);
    return ((1u << ib) - 1u) & ~((1u << ia) - 1u);
}

// The four bytes [e - 3, e] of a lane's window as one word (byte e highest),
// e in [-4, 15] from its chunk's start; w holds bytes [-8, 16).
__device__ __forceinline__ unsigned ending_at(const unsigned (&w)[6], int e) {
    const int b = e + 5, k = b >> 2, s = (b & 3) * 8;
    return s == 0 ? w[k] : __funnelshift_r(w[k], w[k + 1], s);
}

__device__ __forceinline__ bool transition(unsigned ref, unsigned alt) {
    return (alt == 'A' && ref == 'G') || (alt == 'G' && ref == 'A') ||
           (alt == 'T' && ref == 'C') || (alt == 'C' && ref == 'T');
}

// The lanes that take a record: a warp's kLanes lanes from `base`.
struct Team {
    int lane;
    int base;
    unsigned mask;

    __device__ __forceinline__ unsigned ballot(bool p) const {
        return (__ballot_sync(mask, p) & mask) >> base;
    }
    __device__ __forceinline__ bool any(bool p) const { return __any_sync(mask, p); }
    __device__ __forceinline__ unsigned from(unsigned v, int l) const {
        return __shfl_sync(mask, v, base + l);
    }
    __device__ __forceinline__ void sync() const { __syncwarp(mask); }
};

// Brings a step's chunks into the team's ring: each lane loads its chunk
// into a register one step ahead and stores it into the step's slot when the
// step begins.
struct Stage {
    unsigned char* ring;
    uint4 next;

    __device__ explicit Stage(unsigned char* r) : ring(r), next(make_uint4(0, 0, 0, 0)) {}

    // Starts loading chunks [first, first + loaded) for step `seq` of the team.
    __device__ __forceinline__ void issue(const uint4* chunks, long long first, int loaded,
                                          unsigned seq, int lane) {
        (void)seq;
        next = lane < loaded ? load_once(chunks + first + lane) : make_uint4(0, 0, 0, 0);
    }
    // Puts step `seq` into its slot; the team synchronises before reading it.
    __device__ __forceinline__ void land(unsigned seq, int lane) {
        *reinterpret_cast<uint4*>(ring + (seq & (kSlots - 1)) * kStep + 16 * lane) = next;
    }
};

// FILTER of one record, by one lane: passes when empty, "." or "PASS";
// `mosaic` when one of its ';'-separated entries is "mosaic". Its first two
// chunks are loaded at once; a longer FILTER loads a chunk at a time past them.
__device__ void scan_filter(const uint4* chunks, long long s, long long e, bool& passing,
                            bool& mosaic) {
    const long long c0 = s >> 4;
    long long cb = c0 + 1;  // the chunk in b
    uint4 a = make_uint4(0, 0, 0, 0), b = a;
    if (e > s) {
        a = load_once(chunks + c0);
        if (((e - 1) >> 4) > c0) b = load_once(chunks + cb);
    }
    unsigned head = 0;  // the first four bytes
    int pos = 0;
    bool ok = true;
    mosaic = false;
    for (long long p = s; p <= e; ++p) {
        unsigned c = ';';  // the end closes the last entry
        if (p < e) {
            const long long k = p >> 4;
            if (k != c0 && k != cb) {
                b = load_once(chunks + k);
                cb = k;
            }
            const uint4 chunk = k == c0 ? a : b;
            c = byte_of(chunk, static_cast<int>(p & 15));
            if (p - s < 4) head |= c << (8 * (p - s));
        }
        if (c == ';') {
            mosaic |= ok && pos == 6;
            pos = 0;
            ok = true;
        } else {
            ok = ok && pos < 6 && c == static_cast<unsigned char>("mosaic"[pos]);
            if (++pos > 6) pos = 7;
        }
    }
    const long long len = e - s;
    passing = len == 0 || (len == 1 && head == '.') || (len == 4 && head == kPass);
}

// GT, by one lane: the sample's field at the index of the first FORMAT key
// "GT" (FORMAT bytes [f4, f5), the sample's [f5, f6), read by `at`): 1
// homozygous ("1/1", "1|1"), 2 heterozygous ("0/1", "1/0", "0|1", "1|0"), 0
// else (no such key; an empty FORMAT has none; a field past the sample's last
// is empty).
template <class At>
__device__ int genotype(long long f4, long long f5, long long f6, const At& at) {
    int gi = -1;
    if (f5 > f4) {
        int index = 0, pos = 0;
        bool ok = true;
        for (long long p = f4; p <= f5; ++p) {
            const unsigned c = p < f5 ? at(p) : ':';
            if (c == ':') {
                if (ok && pos == 2) {
                    gi = index;
                    break;
                }
                ++index;
                pos = 0;
                ok = true;
            } else {
                ok = ok && pos < 2 && c == static_cast<unsigned char>("GT"[pos]);
                if (++pos > 2) pos = 3;
            }
        }
    }
    if (gi < 0) return 0;
    int field = 0;
    long long start = f5;
    for (long long p = f5; p < f6 && field < gi; ++p) {
        if (at(p) == ':') {
            ++field;
            start = p + 1;
        }
    }
    if (field < gi) return 0;
    long long end = start;
    while (end < f6 && at(end) != ':') ++end;
    if (end - start != 3) return 0;
    const unsigned a = at(start), sep = at(start + 1), b = at(start + 2);
    if (sep != '/' && sep != '|') return 0;
    if (a == '1' && b == '1') return 1;
    if ((a == '0' && b == '1') || (a == '1' && b == '0')) return 2;
    return 0;
}

// A position as an offset from `base`, clamped to [-kFar, kFar].
__device__ __forceinline__ int offset_from(long long x, long long base) {
    const long long d = x - base;
    return static_cast<int>(d < -kFar ? -kFar : (d > kFar ? kFar : d));
}

// One record's state as its steps go by, the same in every lane of the team.
// Positions are offsets from `base` (its first chunk's first byte, moved
// ahead every kRebaseSteps steps), so that a lane works in 32 bits.
struct Record {
    const long long* f;  // its seven offsets (global memory; read only past kFar)
    long long c0;        // its first chunk
    long long base;
    int steps;
    long long held;      // its chunks that hold its bytes
    int r[kFields + 1];  // f as offsets from base
    bool csq_found, csq_open, rs_found, rs_pending, known, high;
    int vs;              // the open CSQ value's first byte
    int rs_at;           // the RS value's second byte, still to test
    unsigned taps;       // REF's byte, ALT's first two

    // From the team's staged copy (stage_record): rec, its offsets from base
    // and its steps; first, its first chunk.
    __device__ __forceinline__ void start(const long long* offsets, const int* rec,
                                          long long first) {
        f = offsets;
        c0 = first;
        base = c0 << 4;
        const int4 a = *reinterpret_cast<const int4*>(rec);
        const int4 b = *reinterpret_cast<const int4*>(rec + 4);
        r[0] = a.x;
        r[1] = a.y;
        r[2] = a.z;
        r[3] = a.w;
        r[4] = b.x;
        r[5] = b.y;
        r[6] = b.z;
        steps = b.w;
        // past kFar, from its 64-bit end in global memory
        held = r[6] < kFar ? (r[6] + 15) >> 4 : (__ldg(f + 6) - base + 15) >> 4;
        csq_found = csq_open = rs_found = rs_pending = known = high = false;
        vs = rs_at = 0;
        taps = 0;
    }

    // Moves base ahead by kRebaseSteps steps (a record over 2^29 bytes).
    __device__ __forceinline__ void rebase() {
        constexpr int shift = kRebaseSteps * kStep;
        base += shift;
#pragma unroll
        for (int k = 0; k <= kFields; ++k) r[k] = offset_from(__ldg(f + k), base);
        vs = vs - shift < -kFar ? -kFar : vs - shift;
        rs_at -= shift;
    }

    // The first key over the team: its position and whether a value follows
    // (a lane's first key k, of bit k of `keys`, shuffled as 2k + value).
    __device__ __forceinline__ static bool first_key(unsigned keys, unsigned values, int base,
                                                     const Team& t, int& at, bool& value) {
        const unsigned lanes = t.ballot(keys != 0);
        if (!lanes) return false;
        const int k = __ffs(keys) - 1;
        const int l = __ffs(lanes) - 1;
        const unsigned kv = t.from(static_cast<unsigned>(2 * k) | ((values >> k) & 1u), l);
        at = base + 16 * l + static_cast<int>(kv >> 1);
        value = kv & 1u;
        return true;
    }

    // Keys CSQ and RS: an entry starts at INFO's start or after ';'. A lane
    // takes the entries that start after its ';' at p in [o - 4, o + 12)
    // (INFO's start as a ';' at i0 - 1): their key and its terminator, bytes
    // p + 1 .. p + 4 (read from the ring), lie in this step, or at and past
    // INFO's end, where the entry ends; the lane that holds INFO's end takes
    // the rest of them.
    __device__ __forceinline__ void info_keys(const unsigned (&w)[6], int o, int s0,
                                              const unsigned char* ring, int sb,
                                              unsigned any_semis, const Team& t) {
        const int i0 = r[3], i1 = r[4];
        if (!t.any((any_semis | zero_byte(w[1] ^ kSemis)) != 0 || (i0 - 1 >= o - 4 && i0 - 1 < o + 16)))
            return;
        // bit k: a ';' at o - 4 + k
        unsigned starts = (equal_bits(w[1], kSemis) | equal_bits(w[2], kSemis) << 4 |
                           equal_bits(w[3], kSemis) << 8 | equal_bits(w[4], kSemis) << 12 |
                           equal_bits(w[5], kSemis) << 16);
        if (i0 - 1 >= o - 4 && i0 - 1 < o + 16) starts |= 1u << (i0 - 1 - (o - 4));
        const int hi = i1 >= o && i1 < o + 16 ? i1 - 1 : o + 11;  // the lane with INFO's end: all
        starts &= span_bits20(o - 4, i0 - 1, min(hi, i1 - 1));
        if (!t.any(starts != 0)) return;
        unsigned csq = 0, rs = 0, csq_val = 0, rs_val = 0;
        while (starts) {
            const int k = __ffs(starts) - 1;  // the ';' at p = o - 4 + k
            starts &= starts - 1;
            const int p = o - 4 + k;
            const int a = sb + p + 1 - s0;  // bytes p + 1 .. p + 4 from the ring
            const unsigned u = __funnelshift_r(
                *reinterpret_cast<const unsigned*>(ring + (a & (kRing - 4))),
                *reinterpret_cast<const unsigned*>(ring + ((a + 4) & (kRing - 4))), (a & 3) * 8);
            const unsigned t4 = u >> 24, t3 = (u >> 16) & 0xFFu;
            if ((u & 0x00FFFFFFu) == kCsq && p + 4 <= i1 &&
                (p + 4 == i1 || t4 == ';' || t4 == '=')) {
                csq |= 1u << k;
                csq_val |= static_cast<unsigned>(p + 4 < i1 && t4 == '=') << k;
            }
            if ((u & 0xFFFFu) == kRs && p + 3 <= i1 && (p + 3 == i1 || t3 == ';' || t3 == '=')) {
                rs |= 1u << k;
                rs_val |= static_cast<unsigned>(p + 3 < i1 && t3 == '=') << k;
            }
        }
        int at;
        bool value;
        if (!csq_found && first_key(csq, csq_val, s0 - 4, t, at, value)) {
            csq_found = true;
            csq_open = value;
            vs = at + 5;  // the ';' at `at`, then "CSQ="
        }
        if (!rs_found && first_key(rs, rs_val, s0 - 4, t, at, value)) {
            rs_found = true;
            rs_pending = value;
            rs_at = at + 5;  // ";RS=", then "rs"'s second byte
        }
    }

    // The open CSQ value: its end (its ';' or INFO's end), and "|rs" and
    // "|HIGH|" wholly inside it. Lanes test their 16 positions for a pattern
    // only where some lane holds the pattern's last two bytes.
    __device__ __forceinline__ void csq_value(const unsigned (&w)[6], const uint4& v, int o, int s0,
                                              int s1, unsigned any_semis, const Team& t) {
        const int i1 = r[4];
        int ve = kFar + 1;  // past this step
        if (t.any(o + 15 >= vs && o < i1 && any_semis)) {
            const unsigned semis = chunk_bits(v, kSemis) & span_bits(o, vs, i1 - 1);
            const unsigned lanes = t.ballot(semis != 0);
            if (lanes) {
                const int l = __ffs(lanes) - 1;
                ve = s0 + 16 * l + __ffs(t.from(semis, l)) - 1;
            }
        }
        if (ve > kFar && i1 < s1) ve = i1;
        unsigned rs_pairs = 0, h_pairs = 0;
#pragma unroll
        for (int k = 2; k < 6; ++k) {
            const unsigned shifted = __funnelshift_r(w[k - 1], w[k], 24);
            rs_pairs |= zero_half(w[k] ^ kRsPair2) | zero_half(shifted ^ kRsPair2);
            h_pairs |= zero_half(w[k] ^ kHPipe2) | zero_half(shifted ^ kHPipe2);
        }
        const bool inside = o + 15 >= vs + 2 && o < ve;
        if (!high && t.any(inside && h_pairs)) {
            unsigned m = 0;
#pragma unroll
            for (int e = 0; e < 16; ++e)
                m |= static_cast<unsigned>(ending_at(w, e) == kIghPipe &&
                                           (ending_at(w, e - 4) & 0xFFFF0000u) == kPipeH) << e;
            high = t.any((m & span_bits(o, vs + 5, ve - 1)) != 0);
        }
        if (!known && t.any(inside && rs_pairs)) {
            unsigned m = 0;
#pragma unroll
            for (int e = 0; e < 16; ++e)
                m |= static_cast<unsigned>((ending_at(w, e) & 0xFFFFFF00u) == kPipeRs) << e;
            known = t.any((m & span_bits(o, vs + 2, ve - 1)) != 0);
        }
        csq_open = ve > kFar && !(known && high);
    }

    // Step s, in the ring's slot at byte sb; FORMAT and the sample's first
    // kTail bytes are copied to `tail`.
    __device__ __forceinline__ void step(int s, const unsigned char* ring, int sb,
                                         unsigned char* tail, const Team& t) {
        if (s > 0 && (s & (kRebaseSteps - 1)) == 0) rebase();
        const int s0 = (s & (kRebaseSteps - 1)) * kStep;
        const int n = min(kLanes, (r[6] >> 4) + 1 - (s0 >> 4));
        const int s1 = s0 + 16 * n;
        const auto at = [&](int p) -> unsigned { return ring[(sb + p - s0) & (kRing - 1)]; };
        const int i0 = r[3], i1 = r[4];
        if (s0 <= i1 && s1 > i0 && (!(csq_found && rs_found) || csq_open || rs_pending)) {
            const int o = s0 + 16 * t.lane;
            const uint4 v = *reinterpret_cast<const uint4*>(ring + sb + 16 * t.lane);
            const uint2 back =
                *reinterpret_cast<const uint2*>(ring + ((sb + 16 * t.lane - 8) & (kRing - 1)));
            const unsigned w[6] = {back.x, back.y, v.x, v.y, v.z, v.w};
            // whether the lane holds a ';'
            const unsigned any_semis = zero_byte(v.x ^ kSemis) | zero_byte(v.y ^ kSemis) |
                                       zero_byte(v.z ^ kSemis) | zero_byte(v.w ^ kSemis);
            if (!(csq_found && rs_found)) info_keys(w, o, s0, ring, sb, any_semis, t);
            if (rs_pending && rs_at < s1) {  // the RS value starts with "rs"
                known |= rs_at < i1 && at(rs_at - 1) == 'r' && at(rs_at) == 's';
                rs_pending = false;
            }
            if (csq_open) csq_value(w, v, o, s0, s1, any_semis, t);
        }
        // REF's byte and ALT's first two, where this step holds them
        if (r[0] < s1 && r[1] + 1 >= s0) {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const int p = k == 0 ? r[0] : r[1] + k - 1;
                if (p >= s0 && p < s1) taps |= at(p) << (8 * k);
            }
        }
        // FORMAT and the sample's first kTail bytes
        const int t1 = min(r[6], r[4] + kTail);
        if (r[4] < s1 && t1 > s0) {
            for (int j = 0; j < kTail && r[4] + j < t1; j += kLanes) {
                const int p = r[4] + j + t.lane;
                if (p < t1 && p >= s0 && p < s1) tail[j + t.lane] = at(p);
            }
        }
    }
};

// Record g's offsets `f`, by lane: its first chunk c0, and into `rec` its
// offsets from byte 16 * c0 (clamped to kFar) and its steps (over chunks
// through the one holding byte f[6]).
__device__ __forceinline__ void stage_record(const long long (&f)[kFields + 1], long long& c0,
                                             int* rec) {
    c0 = f[0] >> 4;
    const long long base = c0 << 4;
    int r[kFields + 1];
#pragma unroll
    for (int k = 0; k <= kFields; ++k) {
        const long long d = f[k] - base;  // f[k] >= base
        r[k] = static_cast<int>(d < kFar ? d : kFar);
    }
    const int steps = static_cast<int>(((static_cast<unsigned long long>(f[6] - base) >> 4) +
                                        kLanes) / kLanes);
    *reinterpret_cast<int4*>(rec) = make_int4(r[0], r[1], r[2], r[3]);
    *reinterpret_cast<int4*>(rec + 4) = make_int4(r[4], r[5], r[6], steps);
}

// The counts of a record, by one lane, bit k for count k: its offsets from
// its staged copy (rec, c0; those in global memory, fg, past kFar), `taps`,
// `known` and `high` as its steps left them, FORMAT and the sample from
// `tail` (their first kTail bytes) and past them from the buffer.
__device__ unsigned record_bits(const int* rec, long long c0, const long long* fg, unsigned taps,
                                bool known, bool high, const unsigned char* tail,
                                const unsigned char* data) {
    long long f[kFields + 1];
    const bool near = rec[kFields] < kFar;
#pragma unroll
    for (int k = 0; k <= kFields; ++k) f[k] = near ? (c0 << 4) + rec[k] : __ldg(fg + k);
    const long long f4 = f[4];
    const int gt = genotype(f4, f[5], f[6], [&](long long p) -> unsigned {
        return p - f4 < kTail ? tail[p - f4] : __ldg(data + p);
    });
    const long long ref_len = f[1] - f[0], alt_bytes = f[2] - f[1];
    const unsigned ref0 = taps & 0xFFu, alt0 = (taps >> 8) & 0xFFu, alt1 = taps >> 16;
    // ALT's first allele: none, one base, or longer
    const int alt_len = alt_bytes == 0 || alt0 == ',' ? 0 : (alt_bytes == 1 || alt1 == ',' ? 1 : 2);
    const bool indel = (alt_len == 2 && ref_len == 1) || (alt_len == 1 && ref_len > 1);
    const bool ti = !indel && alt_len == 1 && ref_len == 1 && transition(ref0, alt0);
    return 1u << kPassing | static_cast<unsigned>(known) << kKnown |
           static_cast<unsigned>(high) << kHigh | static_cast<unsigned>(gt == 1) << kHom |
           static_cast<unsigned>(indel) << kIndel | static_cast<unsigned>(ti) << kTi |
           static_cast<unsigned>(!indel && !ti) << kTv | static_cast<unsigned>(gt == 2) << kHet;
}

__global__ void __launch_bounds__(kThreads, kV1BlocksPerSm)
variant_classify_kernel(const unsigned char* __restrict__ data,
                        const long long* __restrict__ offsets, long long n, int filter,
                        unsigned long long* __restrict__ out) {
    __shared__ __align__(16) unsigned char s_ring[kTeams][kRing];
    __shared__ __align__(16) int s_rec[kTeams][kGroup][8];  // stage_record's
    __shared__ long long s_c0[kTeams][kGroup];
    __shared__ unsigned char s_tail[kTeams][kGroup][kTail];
    __shared__ unsigned s_counts[kCounters];
    if (threadIdx.x < kCounters) s_counts[threadIdx.x] = 0;
    __syncthreads();
    const int team_id = threadIdx.x / kLanes;
    const int lane = threadIdx.x % kLanes;
    const int base = (threadIdx.x & 31) - lane;
    const Team t{lane, base, kLanes == 32 ? 0xFFFFFFFFu : ((1u << kLanes) - 1u) << base};
    unsigned char* ring = s_ring[team_id];
    const uint4* chunks = reinterpret_cast<const uint4*>(data);
    Stage stage(ring);
    // a team takes records [lo, hi), in groups of kGroup
    const long long teams = static_cast<long long>(gridDim.x) * kTeams;
    const long long me = static_cast<long long>(blockIdx.x) * kTeams + team_id;
    const long long lo = n * me / teams, hi = n * (me + 1) / teams;
    unsigned count = 0;  // lane k: count k
    unsigned seq = 0;    // the team's steps so far: the ring's slot
    for (long long g = lo; g < hi; g += kGroup) {
        const int cnt = static_cast<int>(hi - g < kGroup ? hi - g : kGroup);
        // lane k: record g + k's seven offsets, contiguous in `offsets`
        long long f[kFields + 1];
#pragma unroll
        for (int k = 0; k <= kFields; ++k)
            f[k] = lane < cnt ? __ldg(offsets + kFields * (g + lane) + k) : 0;
        t.sync();  // the last group's records and tails are no longer read
        if (lane < cnt) stage_record(f, s_c0[team_id][lane], s_rec[team_id][lane]);
        t.sync();
        unsigned take = cnt == 32 ? 0xFFFFFFFFu : (1u << cnt) - 1u;  // records that count
        if (filter) {
            bool passing = false, mosaic = false;
            if (lane < cnt) scan_filter(chunks, f[2], f[3], passing, mosaic);
            take = t.ballot(lane < cnt && passing);
            const unsigned m = __popc(t.ballot(lane < cnt && !passing && mosaic));
            if (lane == kMosaic) count += m;
        }
        if (!take) continue;
        const unsigned counted = take;
        // lane k: what record k's steps found
        bool my_known = false, my_high = false;
        unsigned my_taps = 0;
        int i = __ffs(take) - 1;
        Record r;
        r.start(offsets + kFields * (g + i), s_rec[team_id][i], s_c0[team_id][i]);
        stage.issue(chunks, r.c0, static_cast<int>(min(r.held, static_cast<long long>(kLanes))),
                    seq, lane);
        for (int s = 0;;) {
            // the slot this step lands in held step seq - kSlots: every lane
            // has passed the sync after step seq - 1 landed, so is done with it
            stage.land(seq, lane);
            // the next step's loads: this record's, or the next record's first
            int next = i;
            if (s + 1 < r.steps) {
                const long long first = static_cast<long long>(s + 1) * kLanes;
                const long long left = r.held - first;
                stage.issue(chunks, r.c0 + first,
                            left < 0 ? 0 : static_cast<int>(left < kLanes ? left : kLanes),
                            seq + 1, lane);
            } else {
                take &= take - 1;
                next = take ? __ffs(take) - 1 : -1;
                if (next >= 0)
                    stage.issue(chunks, s_c0[team_id][next],
                                min((s_rec[team_id][next][6] + 15) >> 4, kLanes), seq + 1, lane);
            }
            t.sync();  // the step's slot is whole
            r.step(s, ring, static_cast<int>(seq & (kSlots - 1)) * kStep, s_tail[team_id][i], t);
            ++seq;
            if (++s < r.steps) continue;
            if (lane == i) {
                my_known = r.known;
                my_high = r.high;
                my_taps = r.taps;
            }
            if (next < 0) break;
            i = next;
            s = 0;
            r.start(offsets + kFields * (g + i), s_rec[team_id][i], s_c0[team_id][i]);
        }
        t.sync();  // the tails are whole
        // each lane its record's counts
        const unsigned bits = (counted >> lane) & 1u
            ? record_bits(s_rec[team_id][lane], s_c0[team_id][lane], offsets + kFields * (g + lane),
                          my_taps, my_known, my_high, s_tail[team_id][lane], data)
            : 0u;
#pragma unroll
        for (int k = 0; k < kCounters; ++k) {
            const unsigned c = __popc(t.ballot((bits >> k) & 1u));
            if (lane == k) count += c;
        }
    }
    if (lane < kCounters && count) atomicAdd(&s_counts[lane], count);
    __syncthreads();
    if (threadIdx.x < kCounters && s_counts[threadIdx.x])
        atomicAdd(out + threadIdx.x, static_cast<unsigned long long>(s_counts[threadIdx.x]));
}


// ------------------------------------------------------------------ H1
// H1's shape
constexpr int kH1Warps = 16;                 // warps a block
constexpr int kH1Threads = 32 * kH1Warps;
constexpr int kH1BlocksPerSm = 2;            // the grid's cap and the register budget
constexpr int kH1Short = 16;                 // a range of at most this many markers is a lane's
constexpr int kH1Ahead = 4;                  // chunks of 32 markers a chain loads ahead
constexpr int kH1Loads = 8;                  // loads a thread has in flight testing the rests
constexpr int kH1Rests = 32 * kH1Warps;      // a block's rests: at most one a lane a round
constexpr long long kH1None = 0x7FFFFFFFFFFFFFFFLL;

__device__ __forceinline__ double h1_inf() { return __longlong_as_double(0x7FF0000000000000LL); }

// What a chain leaves when its product p has left the positive finite
// numbers for 0 or +inf: range r's markers [q, e] are still to be tested.
struct H1Rest {
    long long r, q, e;
    double p;
};

struct H1Shared {
    H1Rest rest[kH1Rests];
    long long first[kH1Rests];          // a rest's first marker whose square changes its p
    long long off[kH1Rests + 1];        // rest i's markers are [off[i], off[i + 1]) flattened
    alignas(16) double chunk[kH1Warps][32];  // the squares a warp's chain multiplies next
    int n;                              // rests listed
};

// Whether a square can change a product p that is 0 or +inf (a square is
// +0, positive finite, +inf or NaN, so p is never negative): 0 times +inf
// or NaN is NaN, +inf times 0 or NaN is NaN. A NaN product is final: the
// card's multiply returns its first NaN operand's bits, quieted, and the
// plain version multiplies p first (scripts/h1_variants.py's probe). The
// compiler orders a multiply's operands as it likes, so no multiply here
// takes two NaNs.
__device__ __forceinline__ bool h1_changes(double p, double sq) {
    return p == 0.0 ? !(sq < h1_inf()) : !(sq > 0.0);
}

// A short range's product by one lane: its loads first (1.0 past its end:
// times 1.0 every product is itself, a NaN's bits too), then the chain; a
// chain that ends NaN is run again, stopping at the first NaN.
__device__ __forceinline__ double h1_short(const double* __restrict__ af, long long s,
                                           long long e) {
    double sq[kH1Short];
#pragma unroll
    for (int j = 0; j < kH1Short; ++j) sq[j] = j <= e - s ? __ldg(af + s + j) : 1.0;
#pragma unroll
    for (int j = 0; j < kH1Short; ++j) sq[j] = __dmul_rn(sq[j], sq[j]);
    double p = 1.0;
#pragma unroll
    for (int j = 0; j < kH1Short; ++j) p = __dmul_rn(p, sq[j]);
    if (p != p) {
        p = 1.0;
        for (int j = 0; j < kH1Short && p == p; ++j) p = __dmul_rn(p, sq[j]);
    }
    return p;
}

// Range r = [s, e], longer than kH1Short, by the warp, in chunks of 32
// markers: lane j loads marker j of the chunk kH1Ahead chunks ahead, and
// squares it into the warp's staging row when its chunk comes (1.0 past
// the range's end, as in h1_short); every lane
// multiplies the row in index order (two squares a 16-byte broadcast read),
// so all hold the same p. The chain ends with the range, or at the end of
// the chunk in which p left the positive finite numbers: the chunk's
// multiplies past that marker are the plain product's own, and the rest of
// the range goes on the block's list (0 or +inf) or is moot (NaN). A chunk
// that ends NaN is multiplied again from its start, stopping at the first
// NaN, so that no multiply took two NaNs.
__device__ void h1_chain(const double* __restrict__ af, long long r, long long s, long long e,
                         int lane, double* row, H1Shared& sh, double* __restrict__ out) {
    double ahead[kH1Ahead];
#pragma unroll
    for (int d = 0; d < kH1Ahead; ++d) {
        const long long i = s + 32 * d + lane;
        ahead[d] = i <= e ? __ldg(af + i) : 0.0;
    }
    const double2* pairs = reinterpret_cast<const double2*>(row);
    double p = 1.0;
    for (long long c = s;; c += 32) {
        const double a = ahead[0];
#pragma unroll
        for (int d = 0; d + 1 < kH1Ahead; ++d) ahead[d] = ahead[d + 1];
        const long long i = c + 32 * kH1Ahead + lane;
        ahead[kH1Ahead - 1] = i <= e ? __ldg(af + i) : 0.0;
        __syncwarp();  // the last chunk is multiplied
        row[lane] = c + lane <= e ? __dmul_rn(a, a) : 1.0;
        __syncwarp();
        const double p0 = p;
#pragma unroll 4  // 4 reads ahead of the multiplies: more would spill
        for (int j = 0; j < 16; ++j) {
            const double2 v = pairs[j];
            p = __dmul_rn(__dmul_rn(p, v.x), v.y);
        }
        if (p != p) {
            p = p0;
            for (int j = 0; j < 32 && p == p; ++j) p = __dmul_rn(p, row[j]);
        }
        if (e - c < 32 || p != p) {
            if (lane == 0) out[r] = p;
            return;
        }
        if (!(p > 0.0 && p < h1_inf())) {
            if (lane == 0) sh.rest[atomicAdd(&sh.n, 1)] = H1Rest{r, c + 32, e, p};
            return;
        }
    }
}

// Settles the block's rests, with every thread of the block: one sweep
// finds each rest's first marker whose square changes its p (h1_changes),
// the threads taking the rests' markers flattened, kH1Loads loads each in
// flight, and keeping the least index a rest with a shared atomic; then p
// times that square (the plain product's own multiply: its NaN has the
// card's bits) or p is the product.
__device__ void h1_settle(const double* __restrict__ af, H1Shared& sh, double* __restrict__ out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();  // the list is whole
    const int n = sh.n;
    if (n == 0) return;
    if (warp == 0) {
        long long carry = 0;
        for (int base = 0; base < n; base += 32) {
            const int i = base + lane;
            long long len = i < n ? sh.rest[i].e - sh.rest[i].q + 1 : 0;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const long long t = __shfl_up_sync(0xffffffffu, len, o);
                if (lane >= o) len += t;
            }
            if (i < n) {
                sh.off[i + 1] = carry + len;
                sh.first[i] = kH1None;
            }
            carry += __shfl_sync(0xffffffffu, len, 31);
        }
        if (lane == 0) sh.off[0] = 0;
    }
    __syncthreads();
    const long long total = sh.off[n];
    int lo = 0;  // the rest of the thread's last marker
    for (long long f0 = threadIdx.x; f0 < total;
         f0 += static_cast<long long>(kH1Threads) * kH1Loads) {
        double a[kH1Loads];
        int at[kH1Loads];
#pragma unroll
        for (int u = 0; u < kH1Loads; ++u) {
            const long long f = f0 + static_cast<long long>(u) * kH1Threads;
            while (lo + 1 < n && sh.off[lo + 1] <= f) ++lo;  // the rest that holds f
            at[u] = f < total ? lo : -1;
            a[u] = f < total ? __ldg(af + sh.rest[lo].q + (f - sh.off[lo])) : 0.0;
        }
#pragma unroll
        for (int u = 0; u < kH1Loads; ++u) {
            const int i = at[u];
            if (i >= 0 && h1_changes(sh.rest[i].p, __dmul_rn(a[u], a[u])))
                atomicMin(&sh.first[i], sh.rest[i].q + (f0 + static_cast<long long>(u) *
                                                        kH1Threads - sh.off[i]));
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kH1Threads) {
        double p = sh.rest[i].p;
        const long long j = sh.first[i];
        if (j != kH1None) {
            const double a = __ldg(af + j);
            p = __dmul_rn(p, __dmul_rn(a, a));
        }
        out[sh.rest[i].r] = p;
    }
    if (threadIdx.x == 0) sh.n = 0;  // the next round's pushes follow a barrier
}

// H1: a warp takes `group` ranges a round, strided by the grid's warps
// (lane j the range `first + j * step`), so that the long runs of one ROH
// segment, which come in a row, fall to different warps: lane j reads its
// range's bounds and takes it alone when it is short (or empty, or outside
// [0, m): NaN), the warp chains the longer ones one after another, then
// the block settles the rests they listed.
__global__ void __launch_bounds__(kH1Threads, kH1BlocksPerSm)
roh_products_kernel(const double* __restrict__ af, long long m,
                    const long long* __restrict__ ranges, long long k, int group,
                    double* __restrict__ out) {
    __shared__ H1Shared sh;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) sh.n = 0;
    const long long warps = static_cast<long long>(gridDim.x) * kH1Warps;
    for (long long base = 0; base < k; base += warps * group) {
        __syncthreads();  // the last round's list is read
        const long long first = base + blockIdx.x * kH1Warps + warp, step = warps;
        const long long r = first + lane * step;
        long long s = 0, e = -1;
        bool chain = false;
        if (lane < group && r < k) {
            s = ranges[2 * r];
            e = ranges[2 * r + 1];
            if (s < 0 || e >= m) out[r] = __longlong_as_double(0x7FF8000000000000LL);  // NaN
            else if (e - s < kH1Short) out[r] = h1_short(af, s, e);
            else chain = true;
        }
        for (unsigned todo = __ballot_sync(0xffffffffu, chain); todo; todo &= todo - 1) {
            const int l = __ffs(todo) - 1;
            h1_chain(af, first + l * step, __shfl_sync(0xffffffffu, s, l),
                     __shfl_sync(0xffffffffu, e, l), lane, sh.chunk[warp], sh, out);
        }
        h1_settle(af, sh, out);
    }
}

// A block a kH1Warps ranges up to the cap, then up to 32 ranges a warp: at
// a run's raw runs (tens of thousands of ranges, most a few markers) a lane
// a range, at its final regions (a few hundred) a warp one.
void h1_launch(const double* af, long long m, const long long* ranges, long long k,
               double* out, cudaStream_t stream) {
    const long long cap = static_cast<long long>(ngs::sm_count()) * kH1BlocksPerSm;
    long long blocks = (k + kH1Warps - 1) / kH1Warps;
    if (blocks > cap) blocks = cap;
    long long group = (k + blocks * kH1Warps - 1) / (blocks * kH1Warps);
    if (group > 32) group = 32;
    roh_products_kernel<<<static_cast<int>(blocks), kH1Threads, 0, stream>>>(
        af, m, ranges, k, static_cast<int>(group), out);
}
// -------------------------------------------------------------- H1 ends

int grid_v1(long long n) {
    const long long blocks = (n + kTeams * kGroup - 1) / (kTeams * kGroup);
    const long long cap = static_cast<long long>(ngs::sm_count()) * kV1BlocksPerSm;
    return static_cast<int>(blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" {

// V1: adds the nine counts of records [0, n) into out[9] (int64). data is
// 16-byte aligned, its length a multiple of 16; offsets holds 6n + 1 values.
int ngs_variant_classify(const unsigned char* data, const long long* offsets, long long n,
                         int filter, unsigned long long* out, cudaStream_t stream) {
    if (n <= 0) return 0;
    variant_classify_kernel<<<grid_v1(n), kThreads, 0, stream>>>(data, offsets, n, filter, out);
    return static_cast<int>(cudaGetLastError());
}

// H1: writes out[r] = the ordered product of af[i] * af[i] over
// i in [ranges[2r], ranges[2r + 1]] for r in [0, k).
int ngs_roh_products(const double* af, long long m, const long long* ranges, long long k,
                     double* out, cudaStream_t stream) {
    if (k <= 0) return 0;
    h1_launch(af, m, ranges, k, out, stream);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
