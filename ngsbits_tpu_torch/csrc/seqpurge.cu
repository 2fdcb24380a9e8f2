// SeqPurge device kernels for Hopper (sm_90a): the three count scans of one
// batch of read pairs (ngsbits_tpu_torch/ops/seqpurge.py). The decisions on
// these counts are made on the card by seqpurge_decide.cu.
//
//   insert_scan       K2: for each pair and offset o, matches and mismatches
//                     of seq1[j-o] against seq2rc[j] over o <= j < min_len
//                     (replaces the Pallas `_insert_scan_kernel` in
//                     ngsbits_tpu/ops/pallas_kernels.py)
//   adapter_evidence  for each pair and offset, the adapter windows of
//                     `overlap` bases starting at len2-o on both reads
//                     (replaces the XLA `adapter_evidence` in
//                     ngsbits_tpu/ops/seqpurge.py)
//   adapter_scan      for each read and offset o, read[o+i] against
//                     adapter[i] for i < a_size
//                     (replaces the XLA `adapter_scan` in
//                     ngsbits_tpu/ops/seqpurge.py)
//
// A position is skipped when either side is 'N'. All outputs are [B, L]
// indexed by offset, written in full (zeros where nothing counts): int16
// for K2 (counts of at most L <= 24,576), one byte for the adapter scans
// (counts of at most their 64-base window).
//
// K2 does B * n(n+1)/2 byte compares per batch for pairs of overlap n (each
// input byte is compared about n/2 times). Its TPU kernel rolled a VMEM tile
// per offset and wrote transposed [L, B] tiles to keep its stores
// lane-aligned. Its first port here (one block per pair, one thread per
// offset, a byte per compare, int32 stores) took about five instructions
// and two shared loads per compare, left warps of short diagonals idle
// beside long ones and retired a block after one pair. Now a block stages
// a tile of pairs, compares four bytes per 32-bit operation, gives each
// thread eight offsets and their mirror (every thread walks as far), and
// writes int16 counts by coalesced stores. It is still bound by integer
// instructions, not bytes (see below).
//
// Each launcher takes raw pointers, sizes and the stream, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "launch.cuh"

namespace {

constexpr int kN = 'N';
constexpr int kMaxAdapter = 64;
using AdapterCount = uint8_t;  // ops/seqpurge.py::ADAPTER_COUNT: at most kMaxAdapter

// ---------------------------------------------------------------------------
// The adapter scans. For each (pair, offset) they compare a window of w
// bases (10 for adapter_evidence, 20 for adapter_scan on the main path)
// with an adapter and write 4 (evidence) or 2 (scan) one-byte counts.
//
// What bounds them on this card: with int32 counts, the bytes they wrote
// (24 MB and 12 MB at B=10000, L=151; about 7 and 4 us at 3.35 TB/s), with
// the compares close behind; one-byte counts leave a quarter of those
// stores, and the compares come first. Their first design (one thread per (pair, offset), a 64-bit
// division per item, one byte load and two bounds tests per window
// position, the adapters passed by value and indexed at run time, which
// gives every thread a local copy) ran at about a tenth of that bound.
//
// This design:
//   - A block owns a tile of R rows (about kTileItems (row, offset) items).
//     Their bytes are one span of device memory: 16-byte cp.async copies
//     bring it into shared memory in one round trip, started while the
//     block counts its previous tile. The block then stages each row once
//     as 32-bit words, with 'N' at every position outside [0, min(len, L))
//     and in a pad around the row.
//     An 'N' and a position outside the read are both skipped, so windows
//     need no bounds tests. adapter_evidence's cap i < o on read 2 is the
//     same as p < len2 for p = len2 - o + i, so read 2's staged row covers
//     it too. A window that starts further left than the pad, or right of
//     the row, is moved to the pad's edge or the row's end: it counts
//     nothing either way.
//   - The adapters are __grid_constant__ parameters in 4-byte words, with
//     a mask of the bytes that count (inside the window, not 'N'); no
//     thread copies them.
//   - Four bytes per compare: a window word is a funnel shift of two
//     aligned shared words; equal and non-'N' bytes are flagged in bit 7
//     of each byte by a carry that stays inside the byte (exact for every
//     byte value), masked and summed per byte lane, with one __dp4a per
//     count at the end.
//   - At the main path's sizes (windows of 9 to 12 bases for evidence, 17
//     to 20 for the scan) a template fixes the word count (3 and 5); other
//     windows, up to 64 bases, take a run-time word count.
//   - adapter_scan, which its compares bound, at the main path's sizes and
//     with no 'N' in the adapter: the positions that count come from two
//     16-bit prefix counts of the staged row's non-'N' bytes, written when
//     the row is staged, so only the equality test runs per word.
//     adapter_evidence, which its stores bound, was slower that way: its
//     staging of two rows per pair grew and it saved nothing it waits on.
//   - Offsets run along the lanes; the next item's row and offset come by
//     an addition (no division). A warp stores 128 contiguous bytes per
//     output.
// ---------------------------------------------------------------------------

constexpr int kScanThreads = 256;
constexpr int kTileItems = 2048;      // (row, offset) items a tile aims at
constexpr int kTileSmem = 32 * 1024;  // shared bytes a tile stays under where a row allows
constexpr int kMaxWords = kMaxAdapter / 4;
constexpr unsigned kNNNN = 0x4E4E4E4Eu;

// An adapter window in 4-byte words (base i in byte i % 4 of word i / 4),
// and 0x80 in each byte that counts: inside the window and not 'N'.
struct Window {
    unsigned a[kMaxWords];
    unsigned m[kMaxWords];
    int n;   // bases
    int nw;  // words: ceil(bases / 4)
};

// True when every base of the window counts (no 'N'): then the positions
// that count are the window's non-'N' row bytes, a difference of two prefix
// counts of the staged row.
bool all_count(const Window& w) {
    for (int i = 0; i < w.n; ++i)
        if (!((w.m[i / 4] >> (8 * (i % 4))) & 0x80u)) return false;
    return true;
}

Window make_window(const void* bytes, int n) {
    Window w;
    memset(&w, 0, sizeof(w));
    n = n < 0 ? 0 : (n > kMaxAdapter ? kMaxAdapter : n);
    const uint8_t* c = static_cast<const uint8_t*>(bytes);
    for (int i = 0; i < n; ++i) {
        w.a[i / 4] |= static_cast<unsigned>(c[i]) << (8 * (i % 4));
        if (c[i] != kN) w.m[i / 4] |= 0x80u << (8 * (i % 4));
    }
    w.n = n;
    w.nw = (n + 3) / 4;
    return w;
}

// Bit 7 of each byte is set where that byte of x is not 0: the low seven
// bits plus 0x7F carry into bit 7 unless they are 0, and never out of the
// byte. The other bits are junk; callers mask with the window's 0x80 flags.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned x) {
    return ((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x;
}

// Matches (m) and, unless PREFIX, counted positions (t) of the window that
// starts at byte `base` of a staged row.
template <int NW, bool PREFIX>
__device__ __forceinline__ void window_counts(const unsigned* __restrict__ row, int base,
                                              const Window& ad, int& m, int& t) {
    const unsigned* w = row + (base >> 2);
    const unsigned sh = (base & 3) * 8;
    const int nw = NW ? NW : ad.nw;
    unsigned lo = w[0], eq = 0, ok = 0;  // per byte lane: at most 16 each
#pragma unroll
    for (int k = 0; k < (NW ? NW : kMaxWords); ++k) {
        if (!NW && k >= nw) break;
        const unsigned hi = w[k + 1];
        const unsigned win = __funnelshift_r(lo, hi, sh);
        lo = hi;
        eq += (~nonzero_bytes(win ^ ad.a[k]) & ad.m[k]) >> 7;
        if (!PREFIX) ok += (nonzero_bytes(win ^ kNNNN) & ad.m[k]) >> 7;
    }
    m = static_cast<int>(__dp4a(eq, 0x01010101u, 0u));
    if (!PREFIX) t = static_cast<int>(__dp4a(ok, 0x01010101u, 0u));
}

// Counted positions of the window at byte `base` when every adapter base
// counts: the non-'N' bytes of [base, base + n), from the row's prefix counts.
__device__ __forceinline__ int prefix_count(const unsigned* __restrict__ pre, int base, int n) {
    const unsigned short* p = reinterpret_cast<const unsigned short*>(pre);
    return static_cast<int>(p[base + n]) - static_cast<int>(p[base]);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return min(max(x, lo), hi);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts copying rows b0 .. b0 + rows - 1 of src ([B, L] bytes, one span of
// device memory) into raw, after a 16-byte margin, as the 16-byte chunks
// that cover the span (each holds a byte of it, so none leaves its
// allocation), and the rows' lengths into lens. Returns the byte of raw where
// the first row starts. One round trip to device memory per tile, with no
// thread waiting on it until the block does.
__device__ __forceinline__ int prefetch_rows(unsigned* raw, int* lens, const uint8_t* src,
                                             const int* len, long long b0, int rows, int L) {
    const uintptr_t first = reinterpret_cast<uintptr_t>(src + b0 * L);
    const uintptr_t a0 = first & ~uintptr_t(15);
    const int chunks = static_cast<int>((first + static_cast<uintptr_t>(rows) * L - a0 + 15) >> 4);
    for (int k = threadIdx.x; k < chunks; k += blockDim.x)
        cp_async16(raw + 4 + 4 * k, reinterpret_cast<const void*>(a0 + 16 * k));
    if (len)
        for (int r = threadIdx.x; r < rows; r += blockDim.x) cp_async4(lens + r, len + b0 + r);
    return 16 + static_cast<int>(first - a0);
}

// Bytes p0 .. p0 + 3 of a read whose bytes start at byte `at` of raw, each
// 'N' outside [0, len). Only a word with a byte inside the read touches raw.
__device__ __forceinline__ unsigned staged_word(const unsigned* __restrict__ raw, int at, int len,
                                                int p0) {
    const int lo = clampi(-p0, 0, 4), hi = clampi(len - p0, 0, 4);  // bytes [lo, hi) inside
    if (lo >= hi) return kNNNN;
    const int g = at + p0;  // at least at - 3: inside the margin
    const unsigned x = __funnelshift_r(raw[g >> 2], raw[(g >> 2) + 1], (g & 3) * 8);
    const unsigned keep = (0xFFFFFFFFu << (8 * lo)) & (0xFFFFFFFFu >> (8 * (4 - hi)));
    return (x & keep) | (kNNNN & ~keep);
}

// One warp builds a staged row from its read's bytes, which start at byte
// `at` of raw: word c holds bytes 4c - pad .. 4c - pad + 3 of the read, each
// 'N' outside [0, len).
// With PREFIX it also writes pre: for each byte c of the row, 16 bits
// counting the non-'N' bytes before it (a warp scan over the words).
template <bool PREFIX>
__device__ __forceinline__ void stage_row(unsigned* __restrict__ dst, unsigned* __restrict__ pre,
                                          const unsigned* __restrict__ raw, int at, int len,
                                          int s4, int pad, int lane) {
    unsigned carry = 0;  // non-'N' bytes in the words of earlier passes
    for (int c0 = 0; c0 < s4; c0 += 32) {
        const int c = c0 + lane;
        const unsigned word = c < s4 ? staged_word(raw, at, len, 4 * c - pad) : kNNNN;
        if (c < s4) dst[c] = word;
        if (PREFIX) {
            const unsigned f = nonzero_bytes(word ^ kNNNN) & 0x80808080u;
            const unsigned n = __popc(f);
            unsigned incl = n;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const unsigned y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
                if (lane >= d) incl += y;
            }
            const unsigned p0c = carry + incl - n;
            carry += __shfl_sync(0xFFFFFFFFu, incl, 31);
            if (c < s4) {
                const unsigned p1 = p0c + ((f >> 7) & 1), p2 = p1 + ((f >> 15) & 1);
                const unsigned p3 = p2 + ((f >> 23) & 1);
                pre[2 * c] = p0c | (p1 << 16);
                pre[2 * c + 1] = p2 | (p3 << 16);
            }
        }
    }
}

// Staged row length in words for windows of nw words, pad bytes on the
// left: the furthest window starts at pad + L and reads nw + 1 words.
inline int staged_words(int L, int nw, int pad) { return pad / 4 + nw + 1 + (L + 3) / 4; }

// Words of raw space for R rows: the span rounded to 16 bytes, a 16-byte
// margin on each side and 16 bytes for the span's offset in its first chunk.
inline int raw_words(int R, int L) { return ((R * L + 15) / 16 * 16 + 48) / 4; }

// ---------------------------------------------------------------------------
// adapter_evidence. Window position p = len2 - o + i for i < w:
//   read 1: p in [0, len1), compared with a1[i]
//   read 2: p in [0, len2) (and i < o, the same), compared with a2[i]
// Both staged rows carry a pad of 4 * nw bytes on the left.
// Per tile: the copies of this tile land (started during the last one);
// the rows are staged; the next tile's copies start; the items are counted.
// ---------------------------------------------------------------------------

template <int NW>
__global__ void __launch_bounds__(kScanThreads, 4) adapter_evidence_kernel(
    const uint8_t* __restrict__ read1, const uint8_t* __restrict__ read2,
    const int* __restrict__ len1, const int* __restrict__ len2, int B, int L, int R, int s4,
    int rw, const __grid_constant__ Window a1, const __grid_constant__ Window a2,
    AdapterCount* __restrict__ m1, AdapterCount* __restrict__ mm1, AdapterCount* __restrict__ m2,
    AdapterCount* __restrict__ mm2) {
    extern __shared__ __align__(16) unsigned smem[];
    unsigned* raw1 = smem;                 // rw words each: the tile's bytes as copied
    unsigned* raw2 = raw1 + rw;
    unsigned* s1 = raw2 + rw;              // R staged rows of read 1, then of read 2
    unsigned* s2 = s1 + R * s4;
    int* l1s = reinterpret_cast<int*>(s2 + R * s4);  // lengths as copied
    int* l2s = l1s + R;
    int* s_len2 = l2s + R;                 // len2 clamped for window starts
    const int pad = 4 * (NW ? NW : a1.nw);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r0 = threadIdx.x / L, o0 = threadIdx.x % L;
    const int dr = blockDim.x / L, dor = blockDim.x % L;
    const long long step = static_cast<long long>(gridDim.x) * R;
    long long b0 = static_cast<long long>(blockIdx.x) * R;
    int off1 = 0, off2 = 0;
    if (b0 < B) {
        const int rows = static_cast<int>(min(static_cast<long long>(R), B - b0));
        off1 = prefetch_rows(raw1, l1s, read1, len1, b0, rows, L);
        off2 = prefetch_rows(raw2, l2s, read2, len2, b0, rows, L);
    }
    for (; b0 < B; b0 += step) {
        const int rows = static_cast<int>(min(static_cast<long long>(R), B - b0));
        cp_async_wait_all();
        __syncthreads();  // the tile's bytes have landed; the last tile is counted
        for (int r = warp; r < rows; r += blockDim.x >> 5) {
            const int l2 = l2s[r];
            stage_row<false>(s1 + r * s4, nullptr, raw1, off1 + r * L, clampi(l1s[r], 0, L), s4,
                             pad, lane);
            stage_row<false>(s2 + r * s4, nullptr, raw2, off2 + r * L, clampi(l2, 0, L), s4, pad,
                             lane);
            if (lane == 0) s_len2[r] = clampi(l2, -pad, 2 * L);
        }
        __syncthreads();  // staged: raw and the copied lengths are free
        const long long next = b0 + step;
        if (next < B) {
            const int nrows = static_cast<int>(min(static_cast<long long>(R), B - next));
            off1 = prefetch_rows(raw1, l1s, read1, len1, next, nrows, L);
            off2 = prefetch_rows(raw2, l2s, read2, len2, next, nrows, L);
        }
        const int n = rows * L;
        const size_t out0 = static_cast<size_t>(b0) * L;
        int r = r0, o = o0;
        for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
            const int base = pad + clampi(s_len2[r] - o, -pad, L);
            int c1, t1, c2, t2;
            window_counts<NW, false>(s1 + r * s4, base, a1, c1, t1);
            window_counts<NW, false>(s2 + r * s4, base, a2, c2, t2);
            m1[out0 + idx] = c1;
            mm1[out0 + idx] = t1 - c1;
            m2[out0 + idx] = c2;
            mm2[out0 + idx] = t2 - c2;
            o += dor;
            r += dr;
            if (o >= L) {
                o -= L;
                ++r;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// adapter_scan. Window position o + i for i < a_size; no left pad. The
// same tile loop as adapter_evidence, on one read.
// ---------------------------------------------------------------------------

template <int NW, bool PREFIX>
__global__ void __launch_bounds__(kScanThreads, 4) adapter_scan_kernel(
    const uint8_t* __restrict__ read, const int* __restrict__ length, int B, int L, int R,
    int s4, int rw, const __grid_constant__ Window ad, AdapterCount* __restrict__ matches,
    AdapterCount* __restrict__ mismatches) {
    extern __shared__ __align__(16) unsigned smem[];
    unsigned* raw = smem;                                  // rw words
    unsigned* rows_s = raw + rw;                           // R staged rows
    const int pw = PREFIX ? 2 * s4 : 0;                    // prefix counts per row
    unsigned* pre = rows_s + R * s4;
    int* lens = reinterpret_cast<int*>(pre + R * pw);      // lengths as copied
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r0 = threadIdx.x / L, o0 = threadIdx.x % L;
    const int dr = blockDim.x / L, dor = blockDim.x % L;
    const long long step = static_cast<long long>(gridDim.x) * R;
    long long b0 = static_cast<long long>(blockIdx.x) * R;
    int off = 0;
    if (b0 < B)
        off = prefetch_rows(raw, lens, read, length, b0,
                            static_cast<int>(min(static_cast<long long>(R), B - b0)), L);
    for (; b0 < B; b0 += step) {
        const int rows = static_cast<int>(min(static_cast<long long>(R), B - b0));
        cp_async_wait_all();
        __syncthreads();
        for (int r = warp; r < rows; r += blockDim.x >> 5)
            stage_row<PREFIX>(rows_s + r * s4, pre + r * pw, raw, off + r * L,
                              clampi(lens[r], 0, L), s4, 0, lane);
        __syncthreads();
        const long long next = b0 + step;
        if (next < B)
            off = prefetch_rows(raw, lens, read, length, next,
                                static_cast<int>(min(static_cast<long long>(R), B - next)), L);
        const int n = rows * L;
        const size_t out0 = static_cast<size_t>(b0) * L;
        int r = r0, o = o0;
        for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
            int m, t;
            window_counts<NW, PREFIX>(rows_s + r * s4, o, ad, m, t);
            if (PREFIX) t = prefix_count(pre + r * pw, o, ad.n);
            matches[out0 + idx] = m;
            mismatches[out0 + idx] = t - m;
            o += dor;
            r += dr;
            if (o >= L) {
                o -= L;
                ++r;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// K2, insert_scan. For pair b, n = clamp(min_len[b], 0, L); offset o < n
// compares seq1[i] with seq2rc[i + o] for i in [0, n - o).
//
// What bounds it: integer instructions, not bytes. Per word of seq1 a unit
// runs about 30 logic, shift and add operations and 16 __dp4a for 32
// compares; at the main path's batch that loop takes about two thirds of
// the time, and the tile's copy in and its counts' copy out, which every
// block does in step with the others, most of the rest.
//
// A block owns a tile of R pairs (about kInsertThreads units, below). The
// rows' bytes come in by 16-byte cp.async and are staged once per row as
// (word, flags): bytes 4c .. 4c + 3 and 0x80 in each byte that is not 'N',
// with 'N' at every position at or past n, so that no loop tests a bound.
//
// One 32-bit operation compares four positions. For seq1's word k (one
// broadcast load for the lanes of a pair) and the window of seq2rc at byte
// 4k + o, a funnel shift of two aligned words:
//   matched: no bit of seq1 ^ window is set in the byte (the in-byte carry
//            of nonzero_bytes) and seq1's byte is not 'N' (its flag),
//            summed by __dp4a (128 per match);
//   counted: __dp4a of the two flag words (128 * 128 per position where
//            neither byte is 'N'), with no mask;
// mismatches are the counted positions less the matched ones.
//
// A unit is a pair and a pair of groups of four offsets, 8p .. 8p + 7: the
// windows of offset 8p + 4 + s at word k are those of 8p + s at word k + 1,
// so each window is shifted once and compared twice. Group pair p walks
// ceil(n/4) - 2p words. The triangle is folded: a unit takes group pair u
// and its mirror P - 1 - u (P = ceil(ceil(n/4) / 2)), about ceil(n/4) + 2
// words in all, so the units of a pair walk as far as each other. Offsets
// in [8P, L) are written 0 by the units in turn. Per word: two 8-byte
// shared loads, six funnel shifts, and per offset three or four logic and
// add operations and two __dp4a (three for rows whose bytes are all below
// 128, which real reads are; four, exact for every byte value, otherwise).
// The counts go to a shared tile, 16 bytes per group pair, and the tile
// leaves as one contiguous span of each output.
// ---------------------------------------------------------------------------

using Count = int16_t;                // K2's outputs
constexpr int kInsertThreads = 128;   // threads of a K2 block: one unit each per tile

// One warp stages a row of n bytes (at byte `at` of raw) as W (word, flags).
// Returns whether a byte of the row has bit 7 set.
__device__ __forceinline__ bool stage_flagged(uint2* __restrict__ dst,
                                              const unsigned* __restrict__ raw, int at, int n,
                                              int W, int lane) {
    unsigned high = 0;
    for (int c = lane; c < W; c += 32) {
        const unsigned w = staged_word(raw, at, n, 4 * c);
        dst[c] = make_uint2(w, nonzero_bytes(w ^ kNNNN) & 0x80808080u);
        high |= w;
    }
    return __any_sync(0xFFFFFFFFu, high & 0x80808080u);
}

// Adds seq1's word x (flags xf) against a window w (flags f) of seq2rc.
// With SEVEN (no byte of either row has bit 7 set) the bytes of x ^ w are
// below 128, so adding 0x7F to each sets its bit 7 exactly where it is not
// 0 and never carries out of it: one operation less than nonzero_bytes.
template <bool SEVEN>
__device__ __forceinline__ void count_word(unsigned x, unsigned xf, unsigned w, unsigned f,
                                           unsigned& m, unsigned& t) {
    const unsigned d = x ^ w;
    const unsigned differ = SEVEN ? d + 0x7F7F7F7Fu : nonzero_bytes(d);
    m = __dp4a(~differ & xf, 0x01010101u, m);
    t = __dp4a(xf, f, t);
}

// Eight counts at dst, 16-byte aligned in shared memory.
__device__ __forceinline__ void store8(Count* dst, const unsigned (&v)[8]) {
    if constexpr (sizeof(Count) == 2) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16,
                                                    v[4] | v[5] << 16, v[6] | v[7] << 16);
    } else {
        reinterpret_cast<uint4*>(dst)[0] = make_uint4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<uint4*>(dst)[1] = make_uint4(v[4], v[5], v[6], v[7]);
    }
}

// Matches and mismatches of offsets 8p .. 8p + 7 over `words` words of a
// pair's staged seq1 (a) and seq2rc (c), into its rows of counts.
template <bool SEVEN>
__device__ __forceinline__ void insert_pair(const uint2* __restrict__ a,
                                            const uint2* __restrict__ c, int p, int words,
                                            Count* __restrict__ m_row,
                                            Count* __restrict__ mm_row) {
    unsigned m[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // 128 per match
    unsigned t[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // 128 * 128 per counted position
    const int g = 2 * p;
    uint2 mid = c[g + 1];
    unsigned w0[4], f0[4];  // windows of offsets 4g + s at word k: bytes 4(k + g) + s
    {
        const uint2 lo = c[g];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            w0[s] = __funnelshift_r(lo.x, mid.x, 8 * s);
            f0[s] = __funnelshift_r(lo.y, mid.y, 8 * s);
        }
    }
    for (int k = 0; k < words; ++k) {
        const uint2 x = a[k];
        const uint2 hi = c[g + k + 2];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            const unsigned w1 = s ? __funnelshift_r(mid.x, hi.x, 8 * s) : mid.x;  // offset 4g + 4 + s
            const unsigned f1 = s ? __funnelshift_r(mid.y, hi.y, 8 * s) : mid.y;
            count_word<SEVEN>(x.x, x.y, w0[s], f0[s], m[s], t[s]);
            count_word<SEVEN>(x.x, x.y, w1, f1, m[4 + s], t[4 + s]);
            w0[s] = w1;
            f0[s] = f1;
        }
        mid = hi;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        m[j] >>= 7;
        t[j] = (t[j] >> 14) - m[j];
    }
    store8(m_row + 8 * p, m);
    store8(mm_row + 8 * p, t);
}

// A unit: group pair u of a pair with G groups below n (P pairs of groups),
// and its mirror P - 1 - u.
template <bool SEVEN>
__device__ __forceinline__ void insert_unit(const uint2* __restrict__ a,
                                            const uint2* __restrict__ c, int u, int G, int P,
                                            Count* __restrict__ m_row,
                                            Count* __restrict__ mm_row) {
    insert_pair<SEVEN>(a, c, u, G - 2 * u, m_row, mm_row);
    const int v = P - 1 - u;
    if (v > u) insert_pair<SEVEN>(a, c, v, G - 2 * v, m_row, mm_row);
}

// Per tile: the rows' bytes are copied into shared memory, staged, and
// counted into a shared tile of counts ([2][R][Lp], over the copies' space);
// the tile's counts are one span of each output, written by coalesced stores.
// At the main path's batch a block counts one tile.
__global__ void __launch_bounds__(kInsertThreads) insert_scan_kernel(
    const uint8_t* __restrict__ seq1, const uint8_t* __restrict__ seq2rc,
    const int* __restrict__ min_len, int B, int L, int R, int U, int W, int rw, int io,
    Count* __restrict__ matches, Count* __restrict__ mismatches) {
    extern __shared__ __align__(16) unsigned smem[];
    unsigned* raw1 = smem;                            // rw words each: the tile as copied,
    unsigned* raw2 = raw1 + rw;
    Count* counts = reinterpret_cast<Count*>(smem);   // then its counts (io words in all)
    uint2* s1 = reinterpret_cast<uint2*>(smem + io);  // R staged rows of seq1, then of seq2rc
    uint2* s2 = s1 + R * W;
    int* lens = reinterpret_cast<int*>(s2 + R * W);   // min_len as copied
    int* ns = lens + R;                               // 2n of each row, + 1 if a byte has bit 7
    const int Lp = (L + 7) & ~7;                      // a row of counts: group pair p at 8p
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
    const int r0 = threadIdx.x / U, u0 = threadIdx.x % U;
    const int dr = blockDim.x / U, du = blockDim.x % U;
    const unsigned zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (long long b0 = static_cast<long long>(blockIdx.x) * R; b0 < B;
         b0 += static_cast<long long>(gridDim.x) * R) {
        const int rows = static_cast<int>(min(static_cast<long long>(R), B - b0));
        const int off1 = prefetch_rows(raw1, lens, seq1, min_len, b0, rows, L);
        const int off2 = prefetch_rows(raw2, nullptr, seq2rc, nullptr, b0, rows, L);
        cp_async_wait_all();
        __syncthreads();  // the tile's bytes have landed
        for (int r = warp; r < rows; r += warps) {
            const int n = clampi(lens[r], 0, L);
            const bool high = stage_flagged(s1 + r * W, raw1, off1 + r * L, n, W, lane) |
                              stage_flagged(s2 + r * W, raw2, off2 + r * L, n, W, lane);
            if (lane == 0) ns[r] = 2 * n + high;
        }
        __syncthreads();  // staged: the copies' space takes the counts
        int r = r0, u = u0;
        for (int idx = threadIdx.x; idx < rows * U; idx += blockDim.x) {
            const int G = ((ns[r] >> 1) + 3) >> 2;  // groups of four offsets below n
            const int P = (G + 1) >> 1;             // pairs of groups
            const uint2* a = s1 + r * W;
            const uint2* c = s2 + r * W;
            Count* m_row = counts + r * Lp;
            Count* mm_row = counts + (R + r) * Lp;
            if (2 * u < P) {
                if (ns[r] & 1)
                    insert_unit<false>(a, c, u, G, P, m_row, mm_row);
                else
                    insert_unit<true>(a, c, u, G, P, m_row, mm_row);
            }
            for (int q = P + u; 8 * q < L; q += U) {  // past the pair's overlap
                store8(m_row + 8 * q, zero);
                store8(mm_row + 8 * q, zero);
            }
            u += du;
            r += dr;
            if (u >= U) {
                u -= U;
                ++r;
            }
        }
        __syncthreads();  // counted
        const size_t out0 = static_cast<size_t>(b0) * L;
        for (int r = warp; r < rows; r += warps)
            for (int o = lane; o < L; o += 32) {
                matches[out0 + r * L + o] = counts[r * Lp + o];
                mismatches[out0 + r * L + o] = counts[(R + r) * Lp + o];
            }
        __syncthreads();  // written: the next tile's copies may land
    }
}

// Rows per tile: about `aim` items of `per_row` each, under kTileSmem bytes
// of shared memory where one row allows it.
int tile_rows(int per_row, int aim, int row_bytes) {
    int r = aim / per_row;
    if (r > kTileSmem / row_bytes) r = kTileSmem / row_bytes;
    return r < 1 ? 1 : r;
}

template <typename Kernel>
int scan_grid(Kernel kernel, int B, int R, size_t smem, int* grid) {
    if (smem > 48 * 1024) {  // rows past ~24,000 bases: allowed for this launch
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const long long tiles = (static_cast<long long>(B) + R - 1) / R;
    const long long cap = 8LL * ngs::sm_count();  // 8 blocks of 256 threads fill an SM
    *grid = static_cast<int>(tiles < cap ? tiles : cap);
    return 0;
}

}  // namespace

extern "C" {

// B >= 1, 1 <= L <= 24576 (about 8 L bytes of shared memory for one row);
// matches, mismatches: [B, L] int16. The wrapper checks.
int ngs_insert_scan(const void* seq1, const void* seq2rc, const void* min_len,
                    int B, int L, void* matches, void* mismatches, void* stream) {
    const int W = (L + 3) / 4 + 2;   // staged words per row: the windows read two past ceil(L/4)
    const int U = (L + 15) / 16;     // units per pair: ceil(L/8) group pairs, folded in two
    const int Lp = (L + 7) / 8 * 8;  // a row of counts in shared memory
    const int R = tile_rows(U, kInsertThreads, 4 * L + 16 * W + 48);
    const int rw = raw_words(R, L);
    const int count_words = static_cast<int>(2 * R * Lp * sizeof(Count) / 4);
    const int io = 2 * rw > count_words ? 2 * rw : count_words;  // a multiple of 4
    const size_t smem = (static_cast<size_t>(io) + 4 * static_cast<size_t>(R) * W + 2 * R) * 4;
    int grid = 0;
    if (const int err = scan_grid(insert_scan_kernel, B, R, smem, &grid)) return err;
    insert_scan_kernel<<<grid, kInsertThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(seq1), static_cast<const uint8_t*>(seq2rc),
        static_cast<const int*>(min_len), B, L, R, U, W, rw, io, static_cast<Count*>(matches),
        static_cast<Count*>(mismatches));
    return static_cast<int>(cudaGetLastError());
}

// B >= 1, 1 <= L <= 24576, n1 == n2 <= 64; m1 .. mm2: [B, L] uint8. The
// wrapper checks.
int ngs_adapter_evidence(const void* read1, const void* read2, const void* len1,
                         const void* len2, int B, int L, const void* a1, int n1,
                         const void* a2, int n2, void* m1, void* mm1, void* m2,
                         void* mm2, void* stream) {
    const Window w1 = make_window(a1, n1), w2 = make_window(a2, n2);
    const int s4 = staged_words(L, w1.nw, 4 * w1.nw);
    const int R = tile_rows(L, kTileItems, 2 * (4 * s4 + L) + 12);
    const int rw = raw_words(R, L);
    const size_t smem = (2 * static_cast<size_t>(rw) + 2 * static_cast<size_t>(R) * s4 + 3 * R) * 4;
    // the main path's windows (9 to 12 bases), else the run-time word count
    auto kernel = w1.nw == 3 ? adapter_evidence_kernel<3> : adapter_evidence_kernel<0>;
    int grid = 0;
    if (const int err = scan_grid(kernel, B, R, smem, &grid)) return err;
    kernel<<<grid, kScanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(read1), static_cast<const uint8_t*>(read2),
        static_cast<const int*>(len1), static_cast<const int*>(len2), B, L, R, s4, rw, w1, w2,
        static_cast<AdapterCount*>(m1), static_cast<AdapterCount*>(mm1),
        static_cast<AdapterCount*>(m2), static_cast<AdapterCount*>(mm2));
    return static_cast<int>(cudaGetLastError());
}

// B >= 1, 1 <= L <= 24576, a_size <= 64; matches, mismatches: [B, L] uint8.
// The wrapper checks.
int ngs_adapter_scan(const void* read, const void* length, int B, int L,
                     const void* adapter, int a_size, void* matches,
                     void* mismatches, void* stream) {
    const Window ad = make_window(adapter, a_size);
    const int s4 = staged_words(L, ad.nw, 0);
    // the main path's prefixes (17 to 20 bases, no 'N'), else the general kernel
    const bool fast = ad.nw == 5 && all_count(ad);
    const int words = fast ? 3 * s4 : s4;  // staged row and prefix counts
    const int R = tile_rows(L, kTileItems, 4 * words + L + 4);
    const int rw = raw_words(R, L);
    const size_t smem = (static_cast<size_t>(rw) + static_cast<size_t>(R) * words + R) * 4;
    auto kernel = fast ? adapter_scan_kernel<5, true> : adapter_scan_kernel<0, false>;
    int grid = 0;
    if (const int err = scan_grid(kernel, B, R, smem, &grid)) return err;
    kernel<<<grid, kScanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(read), static_cast<const int*>(length), B, L, R, s4, rw, ad,
        static_cast<AdapterCount*>(matches), static_cast<AdapterCount*>(mismatches));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
