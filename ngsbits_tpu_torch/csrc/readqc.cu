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
// Unpack. One thread per group of four columns: one byte of 2-bit codes, a
// nibble of the N mask, three bytes of 6-bit quals (or four 8-bit ones), and
// one 32-bit store each of ASCII bases and quals. L is a multiple of 8, and
// the outputs are 4-byte aligned (the wrapper checks both).
// ---------------------------------------------------------------------------

__global__ void readqc_unpack_kernel(const uint8_t* __restrict__ pb,
                                     const uint8_t* __restrict__ nm,
                                     const uint8_t* __restrict__ pq, int B,
                                     int L, int qual_bits,
                                     uint8_t* __restrict__ bases,
                                     uint8_t* __restrict__ quals) {
    const int G = L / 4;
    const long long n = static_cast<long long>(B) * G;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
         g < n; g += stride) {
        const long long r = g / G;
        const int j = static_cast<int>(g - r * G);
        const unsigned codes = pb[r * G + j];
        const unsigned nbits = (nm[r * (L / 8) + j / 2] >> ((j & 1) * 4)) & 0xFu;
        unsigned qv;
        if (qual_bits == 8) {
            const uint8_t* p = pq + r * L + 4 * j;
            qv = p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<unsigned>(p[3]) << 24);
        } else {
            const uint8_t* p = pq + r * (3 * G) + 3 * j;
            const unsigned v = p[0] | (p[1] << 8) | (p[2] << 16);
            qv = (v & 63u) | (((v >> 6) & 63u) << 8) | (((v >> 12) & 63u) << 16) |
                 (((v >> 18) & 63u) << 24);
        }
        unsigned bout = 0, qout = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const unsigned code = (codes >> (2 * k)) & 3u;
            // "ACGT" packed little-endian: 'A'=0x41 'C'=0x43 'G'=0x47 'T'=0x54
            const unsigned base =
                ((nbits >> k) & 1u) ? 'N' : ((0x54474341u >> (8 * code)) & 0xFFu);
            bout |= base << (8 * k);
            qout |= ((((qv >> (8 * k)) & 0xFFu) + 33u) & 0xFFu) << (8 * k);
        }
        reinterpret_cast<unsigned*>(bases + r * L)[j] = bout;
        reinterpret_cast<unsigned*>(quals + r * L)[j] = qout;
    }
}

// ---------------------------------------------------------------------------
// Tails. One thread per read. The three histograms take warp-aggregated
// atomics: lanes with the same bin elect one lane, which adds the lane count
// (reads in one batch mostly share a length and a few mean qualities, so a
// warp issues a handful of atomics). The scalar counts are reduced per block
// and added once per block. Integer rules, exactly as the XLA step:
//   rounded mean  (2*qsum + len) // (2*len), clipped to 0..99
//   Q20 read      qsum >= 20*len
//   qdist bin     qsum // len; qsum == 60*len -> bin 59; qsum > 60*len dropped
// ---------------------------------------------------------------------------

constexpr int kTailThreads = 256;

__device__ __forceinline__ long long floor_div(long long a, long long b) {
    // b > 0
    return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ void warp_hist_add(long long* hist, int idx, bool take) {
    const unsigned active = __ballot_sync(kFull, take);
    if (take) {
        const unsigned peers = __match_any_sync(active, idx);
        if ((threadIdx.x & 31) == __ffs(peers) - 1) add64(hist + idx, __popc(peers));
    }
}

__global__ void __launch_bounds__(kTailThreads)
readqc_tails_kernel(const int* __restrict__ read_qsum,
                    const int* __restrict__ lengths, int B, int n_valid, int Lc,
                    long long* __restrict__ q20, long long* __restrict__ read_q_hist,
                    long long* __restrict__ qdist, long long* __restrict__ len_hist,
                    long long* __restrict__ n_reads, long long* __restrict__ bases) {
    __shared__ long long s_sum[3];  // q20, reads, bases
    if (threadIdx.x < 3) s_sum[threadIdx.x] = 0;
    __syncthreads();
    long long my_q20 = 0, my_reads = 0, my_bases = 0;
    const int stride = gridDim.x * blockDim.x;
    // every lane runs the same number of iterations: the warp intrinsics
    // below need the whole warp
    for (int base = blockIdx.x * blockDim.x; base < B; base += stride) {
        const int r = base + threadIdx.x;
        const bool in = r < B;
        const long long len = in ? lengths[r] : 0;
        const long long rq = in ? read_qsum[r] : 0;
        const bool real = in && r < n_valid;
        const bool valid = real && len > 0;
        my_bases += len;
        my_reads += real;
        int rq_idx = 0, qd_idx = 0;
        bool qd_take = false;
        if (valid) {
            my_q20 += rq >= 20 * len;
            const long long rounded = floor_div(2 * rq + len, 2 * len);
            rq_idx = static_cast<int>(rounded < 0 ? 0 : (rounded > 99 ? 99 : rounded));
            long long h = floor_div(rq, len);
            if (rq == 60 * len) h = 59;
            qd_take = rq <= 60 * len && h >= 0;
            qd_idx = static_cast<int>(h);
        }
        const int len_idx = static_cast<int>(len < 0 ? 0 : (len > Lc ? Lc : len));
        warp_hist_add(read_q_hist, rq_idx, valid);
        warp_hist_add(qdist, qd_idx, qd_take);
        warp_hist_add(len_hist, len_idx, real);
    }
    for (int o = 16; o; o >>= 1) {
        my_q20 += __shfl_xor_sync(kFull, my_q20, o);
        my_reads += __shfl_xor_sync(kFull, my_reads, o);
        my_bases += __shfl_xor_sync(kFull, my_bases, o);
    }
    if ((threadIdx.x & 31) == 0) {
        atomicAdd(reinterpret_cast<u64*>(&s_sum[0]), static_cast<u64>(my_q20));
        atomicAdd(reinterpret_cast<u64*>(&s_sum[1]), static_cast<u64>(my_reads));
        atomicAdd(reinterpret_cast<u64*>(&s_sum[2]), static_cast<u64>(my_bases));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
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
    const int threads = 256;
    readqc_unpack_kernel<<<ngs::grid_for(static_cast<long long>(B) * (L / 4), threads),
                           threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(pb), static_cast<const uint8_t*>(nm),
        static_cast<const uint8_t*>(pq), B, L, qual_bits,
        static_cast<uint8_t*>(bases), static_cast<uint8_t*>(quals));
    return static_cast<int>(cudaGetLastError());
}

int ngs_readqc_tails(const void* read_qsum, const void* lengths, int B,
                     int n_valid, int direction, int Lc, void* q20,
                     void* read_q_hist, void* qdist1, void* qdist2,
                     void* len_hist, void* n_fwd, void* n_rev, void* bases,
                     void* stream) {
    const bool fwd = direction == 0;
    readqc_tails_kernel<<<ngs::grid_for(B, kTailThreads), kTailThreads, 0,
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
