// ReadQC device kernels for Hopper (sm_90a): the stream step of
// ngsbits_tpu_torch/ops/readqc.py, as three launches on the caller's stream.
//
//   readqc_unpack  packed 2-bit codes + 1-bit N mask + 6/8-bit quals
//                  -> ASCII [B, L] bases and quals
//                  (replaces the XLA `unpack` in ngsbits_tpu/ops/readqc.py)
//   readqc_batch   K1: per-cycle A/C/G/T/N counts, per-cycle quality sums,
//                  base-quality histogram, per-read quality sums
//                  (replaces the Pallas `_readqc_kernel` in
//                  ngsbits_tpu/ops/pallas_kernels.py)
//   readqc_tails   per-read tail statistics: Q20 reads, mean-quality
//                  histograms, read-length histogram, read/base counts
//                  (replaces the per-read tail of the XLA `step` in
//                  ngsbits_tpu/ops/readqc.py)
//
// All three are bound by device-memory bytes: K1 reads two bytes per base
// and writes almost nothing; unpack reads ~1.1 and writes two bytes per
// base; tails reads eight bytes per read. The design keeps every
// partial sum on chip (registers, shared memory) and touches device memory
// once per input byte; what leaves a block goes out as 64-bit atomics into the
// caller's int64 accumulators, so counts never wrap over a long run.
//
// Each launcher takes raw pointers, sizes and the stream, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kQHist = 100;        // base_qualities_ array size
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned long long u64;

__device__ __forceinline__ void add64(long long* p, long long v) {
    // two's-complement add: also right for negative quality sums
    atomicAdd(reinterpret_cast<u64*>(p), static_cast<u64>(v));
}

// ---------------------------------------------------------------------------
// K1. What bounds it on this card: bytes, and close behind them integer
// operations. It must read the bytes inside the reads (two per base) and
// does about a dozen int32 operations per base, so at 3.35 TB/s and 16.7 T
// op/s the two limits are near each other; the design keeps bytes in flight
// and spends few operations per byte. Measured on the H100 it is the
// instructions (per 16-byte chunk, and per block at its end) that set its
// time, at about 3x the bytes bound (PERF.md).
//
// The first design (one thread per column walking 128 rows one at a time,
// a length load and two one-byte loads per step, a shared histogram and
// shared atomics for every partial sum) kept about 1.5 KB in flight per SM:
// its time was set by the serial row chain, not by bytes.
//
// This design:
//   - A thread owns a chunk of 16 columns. A block of 256 threads covers up
//     to 32 chunks (a column pass of 512 columns) times 256 / chunks row
//     groups, and walks a contiguous range of rows; rows wider than a pass
//     take further passes. The range's lengths are staged in shared memory
//     first, so no load waits on another.
//   - Each thread keeps a private ring of kDepth steps in shared memory and
//     fills it with 16-byte cp.async copies of its own chunk of the next
//     rows (chunks past a read's length are not copied): 32 KB in flight per
//     block without holding registers, and no barrier, since a thread reads
//     only what it copied.
//   - Per-column counts stay in registers as packed byte counters (four
//     columns to a word). A base's code comes from four of its bits (about
//     three operations per byte for all five codes, checked exactly by
//     rebuilding the bytes); chunks holding other bytes take a per-byte
//     equality test against "AAAA", "CCCC", ... instead. Valid positions
//     and quality sums (16-bit lanes) likewise.
//   - A read's quality sum is a byte dot product per word, one sub-warp
//     reduction (__reduce_add_sync over the lanes of its row group) per row
//     and one shared add per row and warp.
//   - The histogram is one shared word per quality byte. Measured on the
//     H100, lanes of a warp that add into one word (binned qualities) cost
//     no more than lanes on distinct words, and one copy per lane was no
//     faster (scripts/k1_variants.py).
//   - At the end of a range (or before a byte counter could wrap) the
//     counters go through the ring's memory: each thread stores its words,
//     and one thread per (chunk, word) sums them over the row groups and
//     adds into the block's column sums, with no atomics. Each column's
//     int64 add happens once per block, two blocks per SM.
//   - L % 16 != 0 or inputs not 16-byte aligned: the same kernel loads the
//     valid bytes of a chunk one at a time (the scalar path).
// On the TPU the grid ran in order and kept its outputs resident between
// steps; here blocks run in any order and add their sums with 64-bit atomics.
// ---------------------------------------------------------------------------

constexpr int kK1Threads = 256;
constexpr int kChunk = 16;                       // columns per thread: one 16-byte copy
constexpr int kPassChunks = 32;                  // chunks per column pass
constexpr int kPassCols = kChunk * kPassChunks;  // columns per pass
constexpr int kTileRows = 1024;                  // rows whose lengths and sums stay in shared memory
constexpr int kDepth = 4;                        // steps in each thread's copy ring
constexpr int kHistBins = 256;                   // one bin per quality byte
constexpr int kSwarRows = 255;                   // rows a byte counter can take
constexpr int kColSums = 7;                      // A C G T N, valid, quality
constexpr int kAccWords = 32;                    // words of K1Acc

struct K1Acc {
    unsigned cnt[5][4];  // byte counters per base code (A C G T N), 4 words
    unsigned nv[4];      // byte counters of valid positions
    unsigned qlo[4];     // 16-bit quality sums of bytes 0 and 2 of each word
    unsigned qhi[4];     // ... of bytes 1 and 3
};

// shared memory of one block, in bytes
constexpr int kRingBytes = kDepth * 2 * kK1Threads * 16;
constexpr int kHistBytes = kHistBins * 4;
constexpr int kColBytes = kColSums * kPassCols * 4;
constexpr int kK1Smem = kRingBytes + kHistBytes + kColBytes + 2 * kTileRows * 4;
static_assert(kRingBytes >= kAccWords * kK1Threads * 4, "the ring holds the flush");

__device__ __forceinline__ unsigned splat_code(int k) {
    return 0x01010101u * (k == 0 ? 'A' : k == 1 ? 'C' : k == 2 ? 'G' : k == 3 ? 'T' : 'N');
}

// valid columns (0..16) of the chunk at c0 in a read of length len (0..L)
__device__ __forceinline__ int chunk_valid(int len, int c0) {
    return min(max(len - c0, 0), kChunk);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the valid bytes of a chunk, one at a time (the scalar path)
__device__ __forceinline__ uint4 load_bytes(const uint8_t* __restrict__ p, int n) {
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
        if (j < n) w[j >> 2] |= static_cast<unsigned>(__ldg(p + j)) << (8 * (j & 3));
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// Exact per-byte equality of the valid bytes of b with each code, into the
// byte counters: (low 7 bits ^ code) + 0x7F sets bit 7 unless the byte
// equals the code (no carry into the next byte); bytes with the top bit set
// never match. m8: 0xFF in each valid byte.
__device__ __forceinline__ void count_exact(K1Acc& a, int w, unsigned b, unsigned m8) {
    const unsigned ok = m8 & ~b & 0x80808080u;
    const unsigned b7 = b & 0x7F7F7F7Fu;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        const unsigned x = (b7 ^ splat_code(k)) + 0x7F7F7F7Fu;
        a.cnt[k][w] += (~x & ok) >> 7;
    }
}

// One row's chunk of n valid columns into the counters and the histogram;
// returns the chunk's sum of quality bytes.
//
// Bases: for a byte y in ACGTN, bits 1-4 name the code (A: bits 1, 2
// clear; C: 1 set, 2 clear; G: 1, 2 set, 3 clear; T: bit 4; N: bit 3).
// The flags are checked by rebuilding the word from them: where any valid
// byte is not rebuilt (not in ACGTN), the chunk takes count_exact instead.
__device__ __forceinline__ unsigned k1_chunk(K1Acc& a, const uint4& bv,
                                             const uint4& qv, int n,
                                             unsigned* s_hist) {
    const unsigned bw[4] = {bv.x, bv.y, bv.z, bv.w};
    const unsigned qw[4] = {qv.x, qv.y, qv.z, qv.w};
    constexpr unsigned k01 = 0x01010101u;
    unsigned m8[4], flag[5][4];
    bool acgtn = true;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
        // 0xFF in each valid byte (little-endian: column 4w + j is byte j)
        m8[w] = __funnelshift_lc(0xFFFFFFFFu, 0u, max(8 * n - 32 * w, 0));
        const unsigned y = bw[w] & m8[w];
        const unsigned x1 = y >> 1, x2 = y >> 2, x3 = y >> 3, x4 = y >> 4;
        flag[0][w] = ~x1 & ~x2 & m8[w] & k01;
        flag[1][w] = x1 & ~x2 & k01;
        flag[2][w] = x1 & x2 & ~x3 & k01;
        flag[3][w] = x4 & k01;
        flag[4][w] = x3 & k01;
        acgtn &= flag[0][w] * 'A' + flag[1][w] * 'C' + flag[2][w] * 'G' +
                 flag[3][w] * 'T' + flag[4][w] * 'N' == y;
    }
    unsigned part = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
        if (acgtn) {
#pragma unroll
            for (int k = 0; k < 5; ++k) a.cnt[k][w] += flag[k][w];
        } else {
            count_exact(a, w, bw[w], m8[w]);
        }
        a.nv[w] += m8[w] & k01;
        const unsigned q = qw[w] & m8[w];
        part = __dp4a(q, k01, part);
        a.qlo[w] += q & 0x00FF00FFu;
        a.qhi[w] += (q >> 8) & 0x00FF00FFu;
        // masked bytes land in bin 0, which is below Q0 and never read
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const unsigned byte = (q >> (8 * j)) & 0xFFu;
            atomicAdd(s_hist + byte, 1u);
        }
    }
    return part;
}

// Every thread's counters into the block's column sums (all threads call
// it, with the copy ring drained); zeroes the counters.
__device__ __forceinline__ void k1_flush(K1Acc& a, bool active, unsigned* s_stage,
                                         unsigned* s_col, int cpp, int rows_per) {
    const int tid = threadIdx.x;
    __syncthreads();
    // words x: A C G T N (x = 4k + w), valid (20 + w), quality (24 + w, 28 + w)
#pragma unroll
    for (int w = 0; w < 4; ++w) {
#pragma unroll
        for (int k = 0; k < 5; ++k)
            s_stage[(4 * k + w) * kK1Threads + tid] = active ? a.cnt[k][w] : 0u;
        s_stage[(20 + w) * kK1Threads + tid] = active ? a.nv[w] : 0u;
        s_stage[(24 + w) * kK1Threads + tid] = active ? a.qlo[w] : 0u;
        s_stage[(28 + w) * kK1Threads + tid] = active ? a.qhi[w] : 0u;
    }
    a = K1Acc{};
    __syncthreads();
    // one thread per (chunk, word): byte counters sum into 16-bit lanes
    // (at most 256 row groups of at most 255), quality words into 32 bits
    for (int item = tid; item < cpp * kAccWords; item += kK1Threads) {
        const int cl = item % cpp;
        const int x = item / cpp;
        unsigned s0 = 0, s1 = 0;
        for (int rg = 0; rg < rows_per; ++rg) {
            const unsigned v = s_stage[x * kK1Threads + rg * cpp + cl];
            if (x < 24) {
                s0 += v & 0x00FF00FFu;
                s1 += (v >> 8) & 0x00FF00FFu;
            } else {
                s0 += v & 0xFFFFu;
                s1 += v >> 16;
            }
        }
        const int w = x & 3;
        const int col = cl * kChunk + 4 * w;
        if (x < 24) {  // A C G T N, then valid: columns 4w + 0..3
            unsigned* dst = s_col + (x >> 2) * kPassCols + col;
            dst[0] += s0 & 0xFFFFu;
            dst[1] += s1 & 0xFFFFu;
            dst[2] += s0 >> 16;
            dst[3] += s1 >> 16;
        } else {  // quality: bytes 0 and 2 (x < 28), else 1 and 3
            unsigned* dst = s_col + 6 * kPassCols + col + (x < 28 ? 0 : 1);
            dst[0] += s0;
            dst[2] += s1;
        }
    }
    __syncthreads();
}

// The pass's column sums into the int64 outputs; zeroes them.
__device__ __forceinline__ void k1_columns_out(unsigned* s_col, int col0, int ncols,
                                               int ldc, long long* counts5,
                                               long long* qsum_cycle) {
    for (int c = threadIdx.x; c < ncols; c += kK1Threads) {
#pragma unroll
        for (int k = 0; k < 5; ++k) {
            const unsigned v = s_col[k * kPassCols + c];
            if (v) add64(counts5 + k * static_cast<size_t>(ldc) + col0 + c, v);
        }
        const long long qs = static_cast<long long>(s_col[6 * kPassCols + c]) -
                             33LL * s_col[5 * kPassCols + c];
        if (qs) add64(qsum_cycle + col0 + c, qs);
#pragma unroll
        for (int k = 0; k < kColSums; ++k) s_col[k * kPassCols + c] = 0;
    }
}

template <bool kVec16>
__global__ void __launch_bounds__(kK1Threads, 2)
readqc_batch_kernel(const uint8_t* __restrict__ bases,
                    const uint8_t* __restrict__ quals,
                    const int* __restrict__ lengths, int B, int L, int ldc,
                    int block_rows, long long* __restrict__ counts5,
                    long long* __restrict__ qsum_cycle,
                    long long* __restrict__ qhist,
                    int* __restrict__ read_qsum) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint4* s_ring = reinterpret_cast<uint4*>(smem);  // [kDepth][2][kK1Threads]
    unsigned* s_hist = reinterpret_cast<unsigned*>(smem + kRingBytes);
    unsigned* s_col = s_hist + kHistBins;
    unsigned* s_row = s_col + kColSums * kPassCols;
    int* s_len = reinterpret_cast<int*>(s_row + kTileRows);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int nchunks = (L + kChunk - 1) / kChunk;
    const int npass = (nchunks + kPassChunks - 1) / kPassChunks;
    const int cpp = min(nchunks, kPassChunks);  // chunks per row group
    const int rows_per = kK1Threads / cpp;       // row groups
    const int cl = tid % cpp;
    const int rg = tid / cpp;
    const bool active = rg < rows_per;
    // the lanes of this warp in this thread's row group reduce a row together
    const int wbase = tid & ~31;
    const int g0 = max(rg * cpp, wbase) - wbase;
    const int g1 = min(rg * cpp + cpp, wbase + 32) - wbase;
    const unsigned gmask = __funnelshift_lc(0xFFFFFFFFu, 0u, g1 - g0) << g0;
    const bool leader = lane == g0;

    for (int i = tid; i < kHistBins + kColSums * kPassCols + kTileRows; i += kK1Threads)
        s_hist[i] = 0;  // s_hist, s_col and s_row are contiguous

    K1Acc acc = {};
    int acc_rows = 0;
    const int rb = blockIdx.x * block_rows;
    const int re = min(B, rb + block_rows);
    for (int t0 = rb; t0 < re; t0 += kTileRows) {
        const int nrows = min(kTileRows, re - t0);
        __syncthreads();
        for (int i = tid; i < nrows; i += kK1Threads)
            s_len[i] = min(max(__ldg(lengths + t0 + i), 0), L);
        __syncthreads();
        const int nsteps = active && rg < nrows ? (nrows - rg + rows_per - 1) / rows_per : 0;
        const int per_tile = (nrows + rows_per - 1) / rows_per;  // the same in every thread
        if (npass == 1 && acc_rows + per_tile > kSwarRows) {
            k1_flush(acc, active, reinterpret_cast<unsigned*>(s_ring), s_col, cpp, rows_per);
            acc_rows = 0;
        }
        acc_rows += per_tile;
        for (int p = 0; p < npass; ++p) {
            const int c0 = (p * kPassChunks + cl) * kChunk;
            auto prefetch = [&](int s) {
                if (kVec16 && s < nsteps) {
                    const int i = rg + s * rows_per;
                    if (chunk_valid(s_len[i], c0) > 0) {
                        const size_t off = static_cast<size_t>(t0 + i) * L + c0;
                        uint4* slot = s_ring + (s % kDepth) * 2 * kK1Threads + tid;
                        cp_async16(slot, bases + off);
                        cp_async16(slot + kK1Threads, quals + off);
                    }
                }
                cp_async_commit();
            };
#pragma unroll
            for (int s = 0; s < kDepth - 1; ++s) prefetch(s);
            for (int s = 0; s < nsteps; ++s) {
                prefetch(s + kDepth - 1);
                cp_async_wait<kDepth - 1>();
                const int i = rg + s * rows_per;
                const int n = chunk_valid(s_len[i], c0);
                unsigned part = 0;
                if (n > 0) {
                    uint4 b, q;
                    if (kVec16) {
                        const uint4* slot = s_ring + (s % kDepth) * 2 * kK1Threads + tid;
                        b = slot[0];
                        q = slot[kK1Threads];
                    } else {
                        const size_t off = static_cast<size_t>(t0 + i) * L + c0;
                        b = load_bytes(bases + off, n);
                        q = load_bytes(quals + off, n);
                    }
                    // one body for whole and partial chunks: the lanes of a
                    // warp hold both, and two bodies would run one after the other
                    part = k1_chunk(acc, b, q, n, s_hist);
                }
                part = __reduce_add_sync(gmask, part);
                if (leader && part) atomicAdd(&s_row[i], part);
            }
            cp_async_wait<0>();
            if (npass > 1) {
                k1_flush(acc, active, reinterpret_cast<unsigned*>(s_ring), s_col, cpp, rows_per);
                k1_columns_out(s_col, p * kPassCols, min(kPassCols, L - p * kPassCols),
                               ldc, counts5, qsum_cycle);
            }
        }
        __syncthreads();
        for (int i = tid; i < nrows; i += kK1Threads) {
            // modulo 2^32, as the int64 sum cast to int32
            read_qsum[t0 + i] = static_cast<int>(s_row[i] - 33u * static_cast<unsigned>(s_len[i]));
            s_row[i] = 0;
        }
    }
    if (npass == 1) {
        k1_flush(acc, active, reinterpret_cast<unsigned*>(s_ring), s_col, cpp, rows_per);
        k1_columns_out(s_col, 0, L, ldc, counts5, qsum_cycle);
    }
    // quality bytes 33..132 are q = 0..99
    if (tid < kQHist && s_hist[33 + tid]) add64(qhist + tid, s_hist[33 + tid]);
}

// ---------------------------------------------------------------------------
// Unpack (replaces the XLA `unpack` of ngsbits_tpu/ops/readqc.py:144). What
// bounds it on this card: bytes. A column costs 1.125 packed bytes in (6-bit
// quals; 1.375 with 8-bit) and two ASCII bytes out, against about six
// integer operations, so the bytes take about three times as long as the
// operations at 3.35 TB/s and 16.7 T op/s. So the loads and stores are wide
// and the operations per byte few:
//   - All five arrays are contiguous and L % 8 == 0, so the bytes of columns
//     8k..8k+7 of the flattened batch lie at a fixed multiple of k in each
//     (codes 2k, N mask k, 6-bit quals 6k, 8-bit quals 8k, outputs 8k),
//     whatever the row. A thread's chunk index is its 32-bit place in the
//     grid; no row or column is computed.
//   - A chunk is 16 columns: one 32-bit word of codes, one 16-bit word of
//     the N mask, three 32-bit words of 6-bit quals or one 16-byte vector of
//     8-bit quals in; one 16-byte store each of bases and quals out. A
//     thread loads both of its chunks before it converts either.
//   - Bases: the codes' 2-bit fields and the mask's bits are spread into
//     nibbles (code | N << 2), and __byte_perm picks each byte from "ACGT"
//     or "NNNN". 6-bit quals: four fields spread into bytes, + 0x21 each;
//     8-bit quals: __vadd4 (modulo 256 a byte).
//   - Arrays not aligned for 16-column chunks take 8-column chunks (2 bytes
//     of codes, 1 of mask, 6 or 8 of quals, 8-byte stores) or, where those
//     are not aligned either, byte loads and 4-byte stores (the wrapper
//     refuses outputs that are not 4-byte aligned). An odd last 8 columns of
//     a batch take the byte path.
// The caller hands it only the rows that hold reads: K1 reads no byte of a
// row of length 0.
// ---------------------------------------------------------------------------

constexpr int kUnpackThreads = 256;
constexpr int kUnpackPer = 2;                // chunks a thread, loaded before either is converted
constexpr unsigned kACGT = 0x54474341u;      // "ACGT", little-endian
constexpr unsigned kNNNN = 0x4E4E4E4Eu;      // "NNNN"
constexpr unsigned kPlus33 = 0x21212121u;

// A chunk's packed bytes, little-endian: codes (2 bits a column), mask (1 bit
// a column), quals (6- or 8-bit fields; 6-bit fields leave a zero word last,
// for the funnel shifts)
struct Packed {
    unsigned codes, mask;
    unsigned q[4];
};

// 2-bit fields of the low 16 bits -> the low two bits of each nibble
__device__ __forceinline__ unsigned spread2(unsigned x) {
    x &= 0xFFFFu;
    x = (x | (x << 8)) & 0x00FF00FFu;
    x = (x | (x << 4)) & 0x0F0F0F0Fu;
    return (x | (x << 2)) & 0x33333333u;
}

// the low 8 bits -> bit 2 of each nibble
__device__ __forceinline__ unsigned spread1(unsigned x) {
    x &= 0xFFu;
    x = (x | (x << 12)) & 0x000F000Fu;
    x = (x | (x << 6)) & 0x03030303u;
    return ((x | (x << 3)) & 0x11111111u) << 2;
}

// four 6-bit fields (bits 0..23; higher bits ignored) -> four bytes, + 33 each
__device__ __forceinline__ unsigned quals6(unsigned v) {
    return ((v & 0x3Fu) | ((v << 2) & 0x3F00u) | ((v << 4) & 0x3F0000u) |
            ((v << 6) & 0x3F000000u)) + kPlus33;
}

// ASCII bases and quals of kCols (8 or 16) columns, kCols / 4 words each
template <int kCols>
__device__ __forceinline__ void unpack_words(const Packed& p, bool q8, unsigned* bo,
                                             unsigned* qo) {
#pragma unroll
    for (int h = 0; h < kCols / 8; ++h) {
        const unsigned sel = spread2(p.codes >> (16 * h)) | spread1(p.mask >> (8 * h));
        bo[2 * h] = __byte_perm(kACGT, kNNNN, sel);
        bo[2 * h + 1] = __byte_perm(kACGT, kNNNN, sel >> 16);
    }
#pragma unroll
    for (int k = 0; k < kCols / 4; ++k) {
        if (q8) {
            qo[k] = __vadd4(p.q[k], kPlus33);
        } else {  // group k's three bytes start at byte 3k
            const int w = 3 * k / 4;
            qo[k] = quals6(__funnelshift_r(p.q[w], p.q[w + 1], 8 * (3 * k % 4)));
        }
    }
}

// chunk g of kCols (8 or 16) columns by vector loads at its natural alignment
template <int kCols>
__device__ __forceinline__ Packed load_chunk(const uint8_t* __restrict__ pb,
                                             const uint8_t* __restrict__ nm,
                                             const uint8_t* __restrict__ pq, bool q8,
                                             unsigned g) {
    Packed p = {};
    const size_t i = g;
    if constexpr (kCols == 16) {
        p.codes = __ldg(reinterpret_cast<const unsigned*>(pb) + i);
        p.mask = __ldg(reinterpret_cast<const unsigned short*>(nm) + i);
        if (q8) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(pq) + i);
            p.q[0] = v.x, p.q[1] = v.y, p.q[2] = v.z, p.q[3] = v.w;
        } else {
            const unsigned* w = reinterpret_cast<const unsigned*>(pq) + 3 * i;
            p.q[0] = __ldg(w), p.q[1] = __ldg(w + 1), p.q[2] = __ldg(w + 2);
        }
    } else {
        p.codes = __ldg(reinterpret_cast<const unsigned short*>(pb) + i);
        p.mask = __ldg(nm + i);
        if (q8) {
            const uint2 v = __ldg(reinterpret_cast<const uint2*>(pq) + i);
            p.q[0] = v.x, p.q[1] = v.y;
        } else {
            const unsigned short* w = reinterpret_cast<const unsigned short*>(pq) + 3 * i;
            p.q[0] = __ldg(w) | static_cast<unsigned>(__ldg(w + 1)) << 16;
            p.q[1] = __ldg(w + 2);
        }
    }
    return p;
}

template <int kCols>
__device__ __forceinline__ void store_chunk(uint8_t* __restrict__ bases,
                                            uint8_t* __restrict__ quals, unsigned g,
                                            const unsigned* bo, const unsigned* qo) {
    const size_t i = g;
    if constexpr (kCols == 16) {
        reinterpret_cast<uint4*>(bases)[i] = make_uint4(bo[0], bo[1], bo[2], bo[3]);
        reinterpret_cast<uint4*>(quals)[i] = make_uint4(qo[0], qo[1], qo[2], qo[3]);
    } else {
        reinterpret_cast<uint2*>(bases)[i] = make_uint2(bo[0], bo[1]);
        reinterpret_cast<uint2*>(quals)[i] = make_uint2(qo[0], qo[1]);
    }
}

// 8 columns (octet o) by byte loads and 4-byte stores: any input alignment
__device__ __forceinline__ void unpack_octet(const uint8_t* __restrict__ pb,
                                             const uint8_t* __restrict__ nm,
                                             const uint8_t* __restrict__ pq, bool q8,
                                             unsigned o, uint8_t* __restrict__ bases,
                                             uint8_t* __restrict__ quals) {
    const size_t i = o;
    Packed p = {};
    p.codes = __ldg(pb + 2 * i) | static_cast<unsigned>(__ldg(pb + 2 * i + 1)) << 8;
    p.mask = __ldg(nm + i);
    const int n = q8 ? 8 : 6;
    const uint8_t* q = pq + n * i;
#pragma unroll
    for (int j = 0; j < 8; ++j)
        if (j < n) p.q[j >> 2] |= static_cast<unsigned>(__ldg(q + j)) << (8 * (j & 3));
    unsigned bo[2], qo[2];
    unpack_words<8>(p, q8, bo, qo);
    unsigned* b = reinterpret_cast<unsigned*>(bases) + 2 * i;
    unsigned* u = reinterpret_cast<unsigned*>(quals) + 2 * i;
    b[0] = bo[0], b[1] = bo[1], u[0] = qo[0], u[1] = qo[1];
}

// kCols 16 or 8: chunks by vector loads and stores; 0: octets by unpack_octet.
// n8: 8-column octets in the batch (B * L / 8).
template <int kCols>
__global__ void __launch_bounds__(kUnpackThreads)
readqc_unpack_kernel(const uint8_t* __restrict__ pb, const uint8_t* __restrict__ nm,
                     const uint8_t* __restrict__ pq, unsigned n8, bool q8,
                     uint8_t* __restrict__ bases, uint8_t* __restrict__ quals) {
    const unsigned g0 = blockIdx.x * (kUnpackThreads * kUnpackPer) + threadIdx.x;
    if constexpr (kCols == 0) {
#pragma unroll
        for (int k = 0; k < kUnpackPer; ++k) {
            const unsigned o = g0 + k * kUnpackThreads;
            if (o < n8) unpack_octet(pb, nm, pq, q8, o, bases, quals);
        }
    } else {
        const unsigned n = n8 / (kCols / 8);  // whole chunks
        Packed p[kUnpackPer];
#pragma unroll
        for (int k = 0; k < kUnpackPer; ++k) {
            const unsigned g = g0 + k * kUnpackThreads;
            if (g < n) p[k] = load_chunk<kCols>(pb, nm, pq, q8, g);
        }
#pragma unroll
        for (int k = 0; k < kUnpackPer; ++k) {
            const unsigned g = g0 + k * kUnpackThreads;
            if (g < n) {
                unsigned bo[kCols / 4], qo[kCols / 4];
                unpack_words<kCols>(p[k], q8, bo, qo);
                store_chunk<kCols>(bases, quals, g, bo, qo);
            } else if (kCols == 16 && g == n && (n8 & 1)) {
                unpack_octet(pb, nm, pq, q8, n8 - 1, bases, quals);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Tails (replaces the per-read tail of the XLA `step`,
// ngsbits_tpu/ops/readqc.py:183). It reads eight bytes a read and adds into
// a few hundred int64 words, so its bytes bound is a fraction of a
// microsecond; what it costs is latency: the launch, one round of loads, and
// the adds that leave its blocks. The reads of a batch share a length and a
// few mean qualities, so adds from every warp into the carries would queue on
// a handful of L2 addresses; each block counts first:
//   - A thread per read, 256 to a block: 256 blocks at B=65536, 64 at
//     SeqPurge's -qc bucket. Grids of 4 to 16 reads a thread were slower on
//     the H100, with 16-byte loads too, and 2 no faster: a thread's reads go
//     one after another through a division and three shared adds, and that
//     chain, not the loads, sets the time (scripts/k1_variants.py --kernel
//     tails).
//   - One 32-bit floor division a read decides every rule: with
//     qsum = h*len + r (0 <= r < len), the rounded mean is h + (2r >= len),
//     Q20 is h >= 20, and the qdist bin is h (59 when h == 60 and r == 0;
//     dropped above that, or below 0). Exact for every int32 sum.
//   - The histograms are block-private 32-bit words in shared memory: 100
//     bins of rounded means, 60 of qdist, and Lc + 1 of lengths while Lc <
//     kLenCap (only long-read buckets reach the cap; past it len_hist takes
//     warp-aggregated global atomics, as before). Each nonzero bin leaves
//     the block with one 64-bit add.
//   - q20, reads and bases: a warp sum, a shared sum, one add per block.
// Integer rules, exactly as the XLA step:
//   rounded mean  (2*qsum + len) // (2*len), clipped to 0..99
//   Q20 read      qsum >= 20*len
//   qdist bin     qsum // len; qsum == 60*len -> bin 59; qsum > 60*len dropped
// ---------------------------------------------------------------------------

constexpr int kTailThreads = 256;
constexpr int kTailPer = 1;                         // reads a thread
constexpr int kTailRows = kTailThreads * kTailPer;  // reads a block
constexpr int kReadQBins = 100;
constexpr int kQDistBins = 60;
constexpr int kLenCap = 4096;  // len_hist in shared memory while Lc < kLenCap

__device__ __forceinline__ void warp_hist_add(long long* hist, int idx, bool take) {
    const unsigned active = __ballot_sync(kFull, take);
    if (take) {
        const unsigned peers = __match_any_sync(active, idx);
        if ((threadIdx.x & 31) == __ffs(peers) - 1) add64(hist + idx, __popc(peers));
    }
}

// one into s[bin], none where bin < 0. The lanes of a warp mostly share a
// bin; aggregating them first by __match_any_sync was slower on the H100
// (scripts/k1_variants.py --kernel tails).
__device__ __forceinline__ void shared_add(unsigned* s, int bin) {
    if (bin >= 0) atomicAdd(s + bin, 1u);
}

// the carry word of shared bin i: rounded means, then qdist, then lengths
__device__ __forceinline__ long long* tail_bin(int i, long long* read_q_hist,
                                               long long* qdist, long long* len_hist) {
    return i < kReadQBins ? read_q_hist + i
           : i < kReadQBins + kQDistBins ? qdist + (i - kReadQBins)
                                         : len_hist + (i - kReadQBins - kQDistBins);
}

__global__ void __launch_bounds__(kTailThreads)
readqc_tails_kernel(const int* __restrict__ read_qsum,
                    const int* __restrict__ lengths, int B, int n_valid, int Lc,
                    long long* __restrict__ q20,
                    long long* __restrict__ read_q_hist, long long* __restrict__ qdist,
                    long long* __restrict__ len_hist, long long* __restrict__ n_reads,
                    long long* __restrict__ bases) {
    __shared__ unsigned s_hist[kReadQBins + kQDistBins + kLenCap];
    __shared__ u64 s_sum[3];  // q20, reads, bases
    unsigned* s_rq = s_hist;
    unsigned* s_qd = s_hist + kReadQBins;
    unsigned* s_len = s_qd + kQDistBins;
    const int tid = threadIdx.x;
    const bool shared_len = Lc < kLenCap;
    const int nbins = kReadQBins + kQDistBins + (shared_len ? Lc + 1 : 0);
    for (int i = tid; i < nbins; i += kTailThreads) s_hist[i] = 0;
    if (tid < 3) s_sum[tid] = 0;

    // this thread's reads: r0 + kTailThreads * i
    const int r0 = blockIdx.x * kTailRows + tid;
    int len[kTailPer], rq[kTailPer];
#pragma unroll
    for (int i = 0; i < kTailPer; ++i) {
        const int r = r0 + kTailThreads * i;
        len[i] = r < B ? __ldg(lengths + r) : 0;
        rq[i] = r < B ? __ldg(read_qsum + r) : 0;
    }
    __syncthreads();  // the histograms are zeroed

    long long my_bases = 0;
    unsigned my_q20 = 0, my_reads = 0;
    // every read's bins, then the adds; -1: no bin
    int rq_bin[kTailPer], qd_bin[kTailPer], len_bin[kTailPer];
#pragma unroll
    for (int i = 0; i < kTailPer; ++i) {
        const int r = r0 + kTailThreads * i;
        const int l = len[i];  // 0 past B
        const bool real = r < B && r < n_valid;
        const bool valid = real && l > 0;
        const int d = valid ? l : 1;
        int h = rq[i] / d, rem = rq[i] - h * d;
        if (rem < 0) --h, rem += d;
        my_bases += l;
        my_reads += real;
        my_q20 += valid && h >= 20;
        rq_bin[i] = valid ? min(max(h + (rem >= d - rem), 0), kReadQBins - 1) : -1;
        qd_bin[i] = valid && h >= 0 && (h < 60 || (h == 60 && rem == 0)) ? min(h, 59) : -1;
        len_bin[i] = real ? min(max(l, 0), Lc) : -1;
    }
    // every lane runs every step: warp_hist_add needs the whole warp
#pragma unroll
    for (int i = 0; i < kTailPer; ++i) {
        shared_add(s_rq, rq_bin[i]);
        shared_add(s_qd, qd_bin[i]);
        if (shared_len) {
            shared_add(s_len, len_bin[i]);
        } else {
            warp_hist_add(len_hist, max(len_bin[i], 0), len_bin[i] >= 0);
        }
    }
    my_q20 = __reduce_add_sync(kFull, my_q20);
    my_reads = __reduce_add_sync(kFull, my_reads);
    for (int o = 16; o; o >>= 1) my_bases += __shfl_xor_sync(kFull, my_bases, o);
    if ((tid & 31) == 0) {
        atomicAdd(&s_sum[0], static_cast<u64>(my_q20));
        atomicAdd(&s_sum[1], static_cast<u64>(my_reads));
        atomicAdd(&s_sum[2], static_cast<u64>(my_bases));
    }
    __syncthreads();
    // each nonzero bin leaves the block once
    for (int i = tid; i < nbins; i += kTailThreads) {
        const unsigned c = s_hist[i];
        if (c) add64(tail_bin(i, read_q_hist, qdist, len_hist), c);
    }
    if (tid == 0) {
        if (s_sum[0]) add64(q20, s_sum[0]);
        if (s_sum[1]) add64(n_reads, s_sum[1]);
        if (s_sum[2]) add64(bases, s_sum[2]);
    }
}

}  // namespace

extern "C" {

int ngs_readqc_batch(const void* bases, const void* quals, const void* lengths,
                     int B, int L, int ldc, void* counts5, void* qsum_cycle,
                     void* qhist, void* read_qsum, void* stream) {
    // two blocks per SM, the rows spread evenly over them
    const long long blocks = 2LL * ngs::sm_count();
    int block_rows = static_cast<int>((B + blocks - 1) / blocks);
    // column passes add their sums per block and pass: at least 32 rows
    if ((L + kChunk - 1) / kChunk > kPassChunks && block_rows < 32) block_rows = 32;
    // a block sums at most 2^24 rows in its 32-bit shared counters
    if (block_rows > (1 << 24)) block_rows = 1 << 24;
    const int grid = static_cast<int>((B + static_cast<long long>(block_rows) - 1) / block_rows);
    const bool vec16 = L % kChunk == 0 &&
                       ((reinterpret_cast<uintptr_t>(bases) |
                         reinterpret_cast<uintptr_t>(quals)) % 16) == 0;
    const auto kernel = vec16 ? readqc_batch_kernel<true> : readqc_batch_kernel<false>;
    // more than 48 KB of shared memory: allowed once per kernel and device
    static bool allowed[64][2];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!allowed[dev][vec16]) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kK1Smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        allowed[dev][vec16] = true;
    }
    kernel<<<grid, kK1Threads, kK1Smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bases), static_cast<const uint8_t*>(quals),
        static_cast<const int*>(lengths), B, L, ldc, block_rows,
        static_cast<long long*>(counts5), static_cast<long long*>(qsum_cycle),
        static_cast<long long*>(qhist), static_cast<int*>(read_qsum));
    return static_cast<int>(cudaGetLastError());
}

int ngs_readqc_unpack(const void* pb, const void* nm, const void* pq, int B,
                      int L, int qual_bits, void* bases, void* quals,
                      void* stream) {
    const long long n8 = static_cast<long long>(B) * (L / 8);
    if (n8 <= 0) return static_cast<int>(cudaSuccess);
    if (n8 > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);  // 32-bit indices
    const bool q8 = qual_bits == 8;
    const auto aligned = [](const void* p, uintptr_t a) {
        return reinterpret_cast<uintptr_t>(p) % a == 0;
    };
    const bool vec16 = aligned(bases, 16) && aligned(quals, 16) && aligned(pb, 4) &&
                       aligned(nm, 2) && aligned(pq, q8 ? 16 : 4);
    const bool vec8 = aligned(bases, 8) && aligned(quals, 8) && aligned(pb, 2) &&
                      aligned(pq, q8 ? 8 : 2);
    // 16-column chunks, and the odd last octet; else one chunk an octet
    const long long chunks = vec16 ? (n8 + 1) / 2 : n8;
    const long long per_block = kUnpackThreads * kUnpackPer;
    const int grid = static_cast<int>((chunks + per_block - 1) / per_block);
    const auto kernel = vec16  ? readqc_unpack_kernel<16>
                        : vec8 ? readqc_unpack_kernel<8>
                               : readqc_unpack_kernel<0>;
    kernel<<<grid, kUnpackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(pb), static_cast<const uint8_t*>(nm),
        static_cast<const uint8_t*>(pq), static_cast<unsigned>(n8), q8,
        static_cast<uint8_t*>(bases), static_cast<uint8_t*>(quals));
    return static_cast<int>(cudaGetLastError());
}

int ngs_readqc_tails(const void* read_qsum, const void* lengths, int B,
                     int n_valid, int direction, int Lc, void* q20,
                     void* read_q_hist, void* qdist1, void* qdist2,
                     void* len_hist, void* n_fwd, void* n_rev, void* bases,
                     void* stream) {
    if (B <= 0) return static_cast<int>(cudaSuccess);
    if (B > 0x7FFFFFFF - kTailRows) return static_cast<int>(cudaErrorInvalidValue);
    const bool fwd = direction == 0;
    readqc_tails_kernel<<<(B + kTailRows - 1) / kTailRows, kTailThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(read_qsum), static_cast<const int*>(lengths), B,
        n_valid, Lc, static_cast<long long*>(q20),
        static_cast<long long*>(read_q_hist),
        static_cast<long long*>(fwd ? qdist1 : qdist2),
        static_cast<long long*>(len_hist),
        static_cast<long long*>(fwd ? n_fwd : n_rev),
        static_cast<long long*>(bases));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
