// Coverage and pileup-count kernels for Hopper (sm_90a): the device side of
// ngsbits_tpu_torch/ops/device_reduce.py, each a launch on the caller's
// stream (C2: a memset of its scratch, then one launch; R2: three).
//
//   coverage_add       C1: +1 at diff[start], -1 at diff[end_excl] for each
//                      span, into a [span + 1] int32 difference array (with
//                      no ends, unit spans at the starts) (replaces the
//                      sort-and-search of the XLA `_cov_eval_fn` in
//                      ngsbits_tpu/ops/device_reduce.py, behind
//                      DeviceCoverage)
//   coverage_add_reads C1's read form: MappingQC's usable on-target reads
//                      (start, end, and the ROI's range of regions each
//                      overlaps), each clipped on the card to every region in
//                      its range and added at the flattened ROI's positions
//                      (replaces the same sort-and-search together with the
//                      host's flattening before it, the `np.repeat` chain of
//                      `MappingScan.process` in ngsbits_tpu/qc/mapping_stats.py)
//   coverage_add_records  C1's record form: a batch's alignment records
//                      (positions, CIGARs, with -min_baseq qualities) walked
//                      on the card into the same difference array, mapped
//                      into a dense box or a panel's merged blocks (replaces
//                      the same sort-and-search together with the host's
//                      span making and -min_baseq expansion before it,
//                      `_expand_baseq_positions` and `_compute_chr_coverage`
//                      in ngsbits_tpu/qc/coverage.py)
//   coverage_finalize  C2: prefix sum of the difference array, then the depth
//                      histogram of ngsbits_tpu/qc/mapping_stats.py
//                      (`_depth_histogram_metrics`) and the count of
//                      positions at or above half the mean depth; optionally
//                      the dense coverage as well, or only that
//   region_sums        R1: the coverage summed over each region (replaces
//                      the host prefix sums of `region_sum` in
//                      ngsbits_tpu/qc/coverage.py)
//   runs_count/write   R2: the runs of positions of each region whose
//                      coverage is below a cutoff, or at or above it
//                      (replaces the host masks of `low_or_high_coverage`)
//   bincount_add       B1: counts[idx] += 1 into int32 counters (replaces the
//                      sort-and-search of DeviceBincount in
//                      ngsbits_tpu/ops/device_reduce.py)
//
// The JAX package sorts and searches because XLA serialises scatter on the
// TPU. On Hopper integer atomics are exact and independent of order, so C1
// and B1 are scatters: each reads its indices once (4 or 8 bytes an entry)
// and the counters they hit stay in the 50 MB L2 between batches. At
// MappingQC's batch sizes (tens of thousands of spans, about a thousand
// pileup hits) each takes about a launch's latency (PERF.md); past that the
// atomics' throughput at the L2 bounds them, worst where many entries of a
// warp hit one counter (a read start shared by duplicates, a SNP under every
// read of a pile): a warp first groups equal indices (__match_any_sync) and
// one lane adds the group's size, so a hot counter takes one atomic a warp.
//
// C1's read form takes 16 bytes a read where the span form took 8 bytes a
// (read, region) pair made on the host. Most reads overlap one region, but
// a long spliced alignment may overlap many: a warp takes 32 reads, scans
// their counts of regions and deals the (read, region) pairs out to its
// lanes 32 at a time (a lane finds its pair's read by a search of five
// shuffles in the scan), so a read over many regions is spread over the warp
// instead of holding one lane while the others wait. A lane loads its
// region's bounds and offset (neighbouring reads hit neighbouring regions:
// L1 and L2), clips the read to them and adds with the same warp-grouped
// atomics. Its bound by bytes is a fraction of a microsecond at MappingQC's
// batches; like the span form it takes about a launch's latency.
//
// C1's record form takes what the host used to expand. Without -min_baseq
// a thread walks a record's CIGAR and adds its reference span. With it a
// warp takes a record: its lanes scan the record's ops (32 at a time) for
// their reference and query offsets, a lane adds each D or N op, and the
// warp walks each M, = or X op in groups of five steps of 32 bases, every
// quality byte of a group loaded (coalesced) before any is tested; a
// ballot of `qual >= min_baseq` a step (the previous step's last bit
// carried in) gives the differences of the counted bases' mask, so a run of
// k counted bases is one +1 and one -1, where the host expansion made k
// unit spans. A boundary at genomic position x goes to the number of
// accumulator positions before x: clamped into a box, or, in a panel's
// merged blocks, found by a binary search, so a span over gaps and many
// blocks is still two boundaries, and a run outside adds nothing; an op
// that lies in one block (most do) maps its boundaries by their offset
// there. Its bound by bytes (4 a CIGAR word, 1 a quality) is a few
// microseconds, and it takes about thirty times that at a batch of the
// exome BAM: a record's chain of dependent loads (key, offsets, CIGAR,
// block search, qualities), its instructions and its scattered atomics.
// Neither a shared-memory window for the atomics, nor a warp taking a run
// of neighbouring records and trying its last block first, nor loading an
// op's qualities before its search was faster (PERF.md).
//
// C2 is bound by bytes: it must read the [span + 1] int32 array once (55 MB
// at MappingQC's 13.9 Mb panel, 1 GB at chr1's whole length) and, in its
// dense mode, write the coverage once. It is one pass with a decoupled
// look-back (Merrill and Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", NVIDIA 2016), where a pass of tile sums before the
// scan would read the array twice, and a block that summed every earlier
// tile's sum would make the work quadratic in the span. A block takes the
// next tile of 8192 positions from a counter, so a tile only ever waits on
// tiles already running. Each warp stages its 1024 positions into shared
// memory with coalesced 16-byte loads, and each lane takes its 32
// consecutive ones from there (swizzled: no bank conflicts). The block scans
// its tile in registers and publishes the tile's sum in a 64-bit status word
// (a flag and an int32, release and acquire at GPU scope); warp 0 reads the
// 32 status words before it at once, adds sums back to the nearest inclusive
// prefix and publishes its own. The look-back's waits still take about a
// fifth of the time at chr1's length, and more at a few waves of blocks
// (PERF.md); five blocks of 256 threads an SM (a register cap) keep more
// loads in flight than four. The status words and the counter are cleared
// by the launcher (one memset), so a launch on reused scratch, or a graph's
// replay, starts clean. Every position is then binned into a histogram in
// shared memory, its bin by a multiply-high with the step's reciprocal and
// one correction, not a division; neighbouring positions have nearly the
// same depth, so each thread adds a run of equal bins at once, and only the
// histogram and one count leave the card. The coverage tools ask for the
// dense coverage alone: that variant has no histogram and no atomics, and
// writes the coverage back through the staging buffer with coalesced
// 16-byte stores.
//
// R1 and R2 read the dense coverage where C2 left it, so only per-region
// results cross PCIe (8 bytes a region; 12 a run) instead of the coverage.
// Both are bound by bytes, 4 a position of each region. The regions come as
// int32 starts and the int64 exclusive prefix of their lengths (`offsets`):
// the concatenated regions are cut into equal tiles of positions, and a
// tile's first region is found by a search in `offsets`, so one long region
// is spread over many warps and many short ones share a warp.
//
// R1 sizes its tiles from the work: as many tiles as the grid has warps,
// rounded up to 32 positions and at most 8192, so an exome chromosome's
// panel (a few thousand regions of 100-400 bp, under a million positions)
// keeps every warp of the grid busy where tiles of 8192 busied about a
// hundred. A warp finds its first region by a search of 32 probes a step
// and holds the next 32 regions' bounds and starts in its lanes, so a piece
// (the part of one region in the tile) needs no load of its bounds. Pieces
// of at least 32 positions are summed by the whole warp with 16-byte loads
// (coalesced), reduced in the warp and added into the region's int64 total
// with one atomic; the run of shorter pieces before such a piece is summed a
// lane a piece, each lane adding its own region's total with one atomic, so
// a warp spends no reduction on a region of a few positions. One region over
// a whole chromosome stays bound by its loads (8192 positions a warp): with
// the grid's four blocks an SM declared to the compiler it keeps more of them
// in flight (64 registers a thread, where it chose 36 without).
//
// R2 reads the coverage once. A warp takes 1024 region positions, a 32-bit
// mask word a lane. It finds its first region by a search of 32 probes a
// step, holds the next 32 regions' bounds in its lanes, and walks its tile's
// pieces (a piece: the part of one region in the tile) with no load of the
// coverage in the walk; in each piece it loads 8 words' worth of coverage at
// once (coalesced, 8 loads in flight a lane) and a ballot turns each 32
// positions into the hit bits of one mask word. The count pass writes the
// mask (1 bit a region position: 31 MB at chr1 against the coverage's 1 GB)
// and counts run starts and ends per block from the mask words, their
// neighbours' bits (a shuffle; two loads at the tile's edges) and the
// region-start and region-end bits of the walk: a run starts at a hit whose
// predecessor is not hit or in another region, and ends likewise. One block
// scans the block counts; the write pass reads only the mask and the
// regions, and each lane writes the runs of its word at the scanned
// offsets, so the k-th start and the k-th end form the k-th run. The count
// pass reads about 2 TB/s at chr1's length (PERF.md); more loads in flight
// a warp, or more warps, did not make it faster.
//
// Each launcher takes raw pointers, sizes and the stream, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kAddThreads = 256;
constexpr int kTileThreads = 256;
constexpr int kPerThread = 32;                      // positions a thread scans
constexpr int kTile = kTileThreads * kPerThread;    // 8192 positions a block
constexpr int kWarpSpan = 32 * kPerThread;          // positions a warp stages
constexpr int kStageBytes = 4 * kTile;              // C2's staging buffer
constexpr int kMaxBins = 4096;                      // histogram bins in shared memory
constexpr int kRegionThreads = 256;                 // R1, R2: 8 warps a block
constexpr int kSumTile = 8192;                      // R1: the most region positions a tile holds
constexpr int kSumTileStep = 32;                    // R1: tiles are a multiple of this
constexpr int kShortPiece = 32;                     // R1: shorter pieces are summed a lane each
constexpr int kRunWarpSpan = 1024;                  // R2: region positions a warp takes
constexpr int kRunBlock = kRegionThreads / 32 * kRunWarpSpan;  // R2: ... a block takes
constexpr int kRunWords = kRunBlock / 32;           // R2: mask words a block
constexpr int kRunBatch = 8;                        // R2: mask words of loads in flight
constexpr int kScanThreads = 1024;                  // R2: the block that scans block counts
constexpr int kMatchSteps = 5;                      // C1 records: 32-base steps loaded at once

typedef unsigned long long u64;

// C2's tile status words: a flag in the high half, an int32 in the low one
// (0: nothing published yet)
constexpr u64 kAggregate = 1ull << 32;   // the tile's own sum
constexpr u64 kInclusive = 2ull << 32;   // the sum of the tile and every tile before it

// One atomic per group of equal keys in the warp; key < 0 adds nothing.
// Every lane of the warp must call it (the callers' loops are warp-uniform).
__device__ __forceinline__ void warp_grouped_add(int* counters, int key, int delta) {
    const unsigned peers = __match_any_sync(kFull, key);
    const int lane = threadIdx.x & 31;
    if (key >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(counters + key, delta * __popc(peers));
}

// ---------------------------------------------------------------------------
// C1 and B1: warp-uniform grid-stride loops over the entries
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kAddThreads)
coverage_add_kernel(const int* __restrict__ starts, const int* __restrict__ ends,
                    long long n, int span, int* __restrict__ diff) {
    const long long warp = (static_cast<long long>(blockIdx.x) * kAddThreads + threadIdx.x) >> 5;
    const long long warps = (static_cast<long long>(gridDim.x) * kAddThreads) >> 5;
    const int lane = threadIdx.x & 31;
    for (long long base = warp * 32; base < n; base += warps * 32) {
        const long long i = base + lane;
        int s = -1, e = -1;
        if (i < n) {
            s = __ldg(starts + i);
            e = ends != nullptr ? __ldg(ends + i) : s + 1;
            // a span of length 0 adds nothing; so does an index outside
            // [0, span], which the caller's contract excludes
            if (s == e || s < 0 || s > span || e < 0 || e > span) s = e = -1;
        }
        warp_grouped_add(diff, s, 1);
        warp_grouped_add(diff, e, -1);
    }
}

// C1's read form. reads: int32 [4, k], rows the 1-based start, the inclusive
// end and the range [i0, i1) of regions; regions: int32 [3, n], rows the
// 1-based inclusive start and end and the flattened offset of each region.
// A warp takes 32 reads and their pairs with the regions of their ranges, 32
// pairs a step; each lane clips its pair's read to its region and adds +1 at
// the clip's flattened start and -1 past its end. An empty clip adds
// nothing; ranges are clamped into [0, n] (the caller's contract excludes
// ranges outside it) and no index past `span` is written.
__global__ void __launch_bounds__(kAddThreads)
coverage_add_reads_kernel(const int* __restrict__ reads, int k, const int* __restrict__ regions,
                          int n, int span, int* __restrict__ diff) {
    const long long warp = (static_cast<long long>(blockIdx.x) * kAddThreads + threadIdx.x) >> 5;
    const long long warps = (static_cast<long long>(gridDim.x) * kAddThreads) >> 5;
    const int lane = threadIdx.x & 31;
    const int* r_start = regions;
    const int* r_end = regions + n;
    const int* r_off = regions + 2LL * n;
    for (long long base = warp * 32; base < k; base += warps * 32) {
        const long long i = base + lane;
        int qs = 0, qe = 0, i0 = 0, count = 0;
        if (i < k) {
            qs = __ldg(reads + i);
            qe = __ldg(reads + k + i);
            i0 = max(__ldg(reads + 2LL * k + i), 0);
            count = max(min(__ldg(reads + 3LL * k + i), n) - i0, 0);
        }
        int incl = count;  // the lanes' pairs, scanned
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += y;
        }
        const int excl = incl - count;
        const int pairs = __shfl_sync(kFull, incl, 31);
        for (int p0 = 0; p0 < pairs; p0 += 32) {
            const int p = p0 + lane;
            // the lane whose read holds pair p: the number of lanes whose
            // scan ends at or before p
            int owner = 0;
#pragma unroll
            for (int s = 16; s > 0; s >>= 1) {
                const int v = __shfl_sync(kFull, incl, owner + s - 1);
                if (v <= p) owner += s;
            }
            const int a = __shfl_sync(kFull, qs, owner);
            const int b = __shfl_sync(kFull, qe, owner);
            const int r = __shfl_sync(kFull, i0, owner) + p - __shfl_sync(kFull, excl, owner);
            int s = -1, e = -1;
            if (p < pairs) {
                const int rs = __ldg(r_start + r);
                const int lo = max(a, rs), hi = min(b, __ldg(r_end + r));
                if (lo <= hi) {
                    s = __ldg(r_off + r) + (lo - rs);
                    e = s + (hi - lo) + 1;
                    if (s < 0 || e > span) s = e = -1;
                }
            }
            warp_grouped_add(diff, s, 1);
            warp_grouped_add(diff, e, -1);
        }
    }
}

__global__ void __launch_bounds__(kAddThreads)
bincount_add_kernel(const int* __restrict__ idx, long long n, int size,
                    int* __restrict__ counts) {
    const long long warp = (static_cast<long long>(blockIdx.x) * kAddThreads + threadIdx.x) >> 5;
    const long long warps = (static_cast<long long>(gridDim.x) * kAddThreads) >> 5;
    const int lane = threadIdx.x & 31;
    for (long long base = warp * 32; base < n; base += warps * 32) {
        const long long i = base + lane;
        int k = -1;
        if (i < n) {
            k = __ldg(idx + i);
            if (k >= size) k = -1;  // outside the counters: the contract excludes it
        }
        warp_grouped_add(counts, k, 1);
    }
}

// ---------------------------------------------------------------------------
// C1's record form
// ---------------------------------------------------------------------------

// BAM's CIGAR ops M I D N S H P = X (0-8), as bit masks: those that consume
// the reference, those that consume the query, and the aligned bases that
// -min_baseq tests. Codes 9-15 consume nothing.
constexpr unsigned kRefOps = 0x18Du;     // M D N = X
constexpr unsigned kQueryOps = 0x193u;   // M I S = X
constexpr unsigned kMatchOps = 0x181u;   // M = X

// The accumulator's positions: blocks of genomic positions [bs[j], be[j])
// (0-based, sorted, disjoint), block j at offset off[j] of the difference
// array of `span` positions; a dense box is one block.
struct Blocks {
    const long long* bs;
    const long long* be;
    const long long* off;
    int n;
    int span;

    // the first block that ends past x (n: none)
    __device__ __forceinline__ int find(long long x) const {
        int lo = 0, hi = n;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (__ldg(be + mid) > x) hi = mid;
            else lo = mid + 1;
        }
        return lo;
    }

    // The number of accumulator positions before genomic position x, given
    // j = find(x): where a run's boundary at x goes. A run [a, b) then adds
    // +1 at index(a) and -1 at index(b), which covers exactly its positions
    // inside the blocks; outside them index(a) == index(b).
    __device__ __forceinline__ int index(long long x, int j) const {
        if (j >= n) return span;
        const long long d = x - __ldg(bs + j);
        const long long i = __ldg(off + j) + (d > 0 ? d : 0);
        return i < 0 ? 0 : (i < span ? static_cast<int>(i) : span);
    }

    __device__ __forceinline__ int index(long long x) const { return index(x, find(x)); }
};

__device__ __forceinline__ void add_run(const Blocks& g, long long a, long long b, int* diff) {
    const int ia = g.index(a), ib = g.index(b);
    if (ia != ib) {
        atomicAdd(diff + ia, 1);
        atomicAdd(diff + ib, -1);
    }
}

// Without -min_baseq: a thread a record, its reference span [pos, pos +
// the lengths of M, D, N, = and X). Records whose key is not `ref` (the
// host's filter, or another chromosome) add nothing.
__global__ void __launch_bounds__(kAddThreads)
coverage_records_kernel(const int* __restrict__ pos, const int* __restrict__ keep,
                        const long long* __restrict__ cigar_off,
                        const unsigned* __restrict__ cigar, int r0, int r1, int ref, Blocks g,
                        int* __restrict__ diff) {
    const long long stride = static_cast<long long>(gridDim.x) * kAddThreads;
    for (long long r = r0 + static_cast<long long>(blockIdx.x) * kAddThreads + threadIdx.x;
         r < r1; r += stride) {
        if (__ldg(keep + r) != ref) continue;
        const long long c1 = __ldg(cigar_off + r + 1);
        long long len = 0;
        for (long long c = __ldg(cigar_off + r); c < c1; ++c) {
            const unsigned w = __ldg(cigar + c);
            if ((kRefOps >> (w & 0xF)) & 1) len += w >> 4;
        }
        const long long a = __ldg(pos + r);
        add_run(g, a, a + len, diff);
    }
}

// Whether each lane's base of a group of kMatchSteps steps of 32 bases,
// from base g0 of an op of m bases, counts: its quality at or above
// min_baseq as an unsigned byte. `qp` points at the op's first quality byte
// and `avail` bytes of the record follow it; a base past them has no
// quality (no SEQ) and counts, as the byte 0xFF ("no qualities") does, and
// no other record's bytes are read. Every load is issued before any is
// tested.
__device__ __forceinline__ void load_group(bool (&counts)[kMatchSteps],
                                           const unsigned char* __restrict__ qp, int avail,
                                           int m, int g0, int min_baseq) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < kMatchSteps; ++k) {
        const int i = g0 + 32 * k + lane;
        counts[k] = i < m && (i < avail ? static_cast<int>(__ldg(qp + i)) : 0xFF) >= min_baseq;
    }
}

// The counted bases of one M, = or X op of `len` bases, the first at
// genomic position a and query offset qa of a record with n quality bytes
// at q, added by the whole warp (its arguments warp-uniform) as the
// differences of their mask: +1 where a counted base follows one that is
// not, -1 where a base that is not counted (or the op's end) follows one
// that is, so a run of counted bases is one +1 and one -1 and a lane adds
// at most one of them a step; a ballot a step, its last bit carried into the
// next.
__device__ __forceinline__ void add_match_runs(const Blocks& g, long long a, long long len,
                                               const unsigned char* __restrict__ q, long long n,
                                               long long qa, int min_baseq, int* diff) {
    const int lane = threadIdx.x & 31;
    // when the whole op lies in one block, a boundary's index is its offset
    // there, with no search; an op with no accumulator position is skipped
    const int j = g.find(a);
    const bool inside = j < g.n && __ldg(g.bs + j) <= a && a + len <= __ldg(g.be + j);
    if (!inside && g.index(a, j) == g.index(a + len)) return;
    const int at = inside ? static_cast<int>(__ldg(g.off + j) + a - __ldg(g.bs + j)) : 0;
    const int m = static_cast<int>(len);  // < 2^28
    const long long left = n - qa;
    const int avail = left <= 0 ? 0 : (left < m ? static_cast<int>(left) : m);
    const unsigned char* qp = q + (qa < n ? qa : n);
    unsigned carry = 0;
    for (int g0 = 0; g0 <= m; g0 += 32 * kMatchSteps) {  // the op's end is a boundary too
        bool counts[kMatchSteps];
        load_group(counts, qp, avail, m, g0, min_baseq);
#pragma unroll
        for (int k = 0; k < kMatchSteps; ++k) {
            const unsigned bits = __ballot_sync(kFull, counts[k]);
            const int d = static_cast<int>((bits >> lane) & 1) -
                          static_cast<int>((((bits << 1) | carry) >> lane) & 1);
            carry = bits >> 31;
            const int i = g0 + 32 * k + lane;
            if (d != 0) atomicAdd(diff + (inside ? at + i : g.index(a + i)), d);
        }
    }
}

// With -min_baseq: a warp a record. The lanes take 32 ops at a time and
// scan their reference and query lengths for each op's offsets; a lane adds
// its D or N op whole (always covered), then the warp walks each M, = or X
// op.
__global__ void __launch_bounds__(kAddThreads)
coverage_records_baseq_kernel(const int* __restrict__ pos, const int* __restrict__ keep,
                              const long long* __restrict__ cigar_off,
                              const unsigned* __restrict__ cigar,
                              const long long* __restrict__ qual_off,
                              const unsigned char* __restrict__ qual, int r0, int r1, int ref,
                              int min_baseq, Blocks g, int* __restrict__ diff) {
    const int lane = threadIdx.x & 31;
    const long long warps = (static_cast<long long>(gridDim.x) * kAddThreads) >> 5;
    for (long long r = r0 + ((static_cast<long long>(blockIdx.x) * kAddThreads + threadIdx.x) >> 5);
         r < r1; r += warps) {
        if (__ldg(keep + r) != ref) continue;  // warp-uniform
        const long long c_end = __ldg(cigar_off + r + 1);
        const long long q0 = __ldg(qual_off + r);
        const long long n = __ldg(qual_off + r + 1) - q0;
        long long ref_at = __ldg(pos + r), q_at = 0;  // where the next 32 ops begin
        for (long long c = __ldg(cigar_off + r); c < c_end; c += 32) {
            const unsigned word = c + lane < c_end ? __ldg(cigar + c + lane) : 0u;
            const unsigned op = word & 0xF;  // past the ops: M of length 0
            const long long len = word >> 4;
            const long long rl = (kRefOps >> op) & 1 ? len : 0;
            const long long ql = (kQueryOps >> op) & 1 ? len : 0;
            long long rs = rl, qs = ql;  // inclusive scans over the lanes that hold ops
            const long long ops = c_end - c;
            for (int o = 1; o < ops && o < 32; o <<= 1) {
                const long long ru = __shfl_up_sync(kFull, rs, o);
                const long long qu = __shfl_up_sync(kFull, qs, o);
                if (lane >= o) {
                    rs += ru;
                    qs += qu;
                }
            }
            const long long op_ref = ref_at + rs - rl, op_q = q_at + qs - ql;
            if (op == 2 || op == 3) add_run(g, op_ref, op_ref + len, diff);
            for (unsigned m = __ballot_sync(kFull, ((kMatchOps >> op) & 1) && len > 0); m;
                 m &= m - 1) {
                const int src = __ffs(m) - 1;
                add_match_runs(g, __shfl_sync(kFull, op_ref, src), __shfl_sync(kFull, len, src),
                               qual + q0, n, __shfl_sync(kFull, op_q, src), min_baseq, diff);
            }
            ref_at += __shfl_sync(kFull, rs, 31);
            q_at += __shfl_sync(kFull, qs, 31);
        }
    }
}

// ---------------------------------------------------------------------------
// C2
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T block_sum(T x, T* shared /* [kTileThreads / 32] */) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();  // shared may still be read by an earlier call
    if (lane == 0) shared[warp] = x;
    __syncthreads();
    T total = 0;
#pragma unroll
    for (int w = 0; w < kTileThreads / 32; ++w) total += shared[w];
    return total;
}

__device__ __forceinline__ u64 load_acquire(const u64* p) {
    u64 v;
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void store_release(u64* p, u64 v) {
    asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The 16-byte slot of a warp's staging buffer that holds its int4 number i
// (of kWarpSpan / 4): eight lanes reading eight consecutive int4 of one
// lane's positions, or eight lanes' neighbouring int4, hit eight different
// bank groups.
__device__ __forceinline__ int swizzle(int i) {
    return i ^ ((i >> 3) & 7);
}

// The sum of the tiles before `tile` (> 0), returned to every thread of the
// block: warp 0's lanes read the status words of the 32 tiles before the
// window's end at once, wait until every tile up to the nearest inclusive
// prefix has published, and add values back to it; without one, the window
// moves 32 tiles back. Tile 0 publishes its inclusive prefix without
// waiting, so the walk ends. Lane 0 then publishes this tile's inclusive
// prefix (`aggregate` its own sum), and `shared` passes the sum to the
// other warps.
__device__ __forceinline__ int look_back(u64* status, int tile, int aggregate, int* shared) {
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 32) {
        int before = 0;
        for (int end = tile - 1;; end -= 32) {
            const int j = end - lane;  // lane 0: the nearest tile
            u64 s = j >= 0 ? load_acquire(status + j) : kInclusive;
            unsigned inclusive;
            for (;;) {
                const unsigned waiting = __ballot_sync(kFull, (s >> 32) == 0);
                inclusive = __ballot_sync(kFull, (s & kInclusive) != 0);
                // the lanes up to the nearest inclusive prefix, all without one
                const unsigned needed = inclusive ? (inclusive & (0u - inclusive)) * 2 - 1 : kFull;
                if (!(waiting & needed)) break;
                if ((s >> 32) == 0) s = load_acquire(status + j);
            }
            int v = static_cast<int>(static_cast<unsigned>(s));
            if (inclusive && lane > __ffs(inclusive) - 1) v = 0;  // behind the nearest
            before += __reduce_add_sync(kFull, v);
            if (inclusive) break;
        }
        if (lane == 0) {
            store_release(status + tile, kInclusive | static_cast<unsigned>(before + aggregate));
            *shared = before;
        }
    }
    __syncthreads();
    return *shared;
}

// C2 in one pass: the prefix sum of the tile the block takes from `ticket`,
// with the tiles before it from the status words; then the histogram, the
// half-depth count and the optional dense coverage; without kHist only the
// dense coverage. Dynamic shared memory: the staging buffer, then (kHist)
// `bins` counters.
template <bool kHist>
__global__ void __launch_bounds__(kTileThreads, 5)
coverage_scan_kernel(const int* __restrict__ diff, int span, u64* __restrict__ status,
                     unsigned* __restrict__ ticket, int step, int hist_max, int bins,
                     int half_depth, u64* __restrict__ hist, u64* __restrict__ half,
                     int* __restrict__ cov_out, bool vec_out) {
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned* sh_hist = reinterpret_cast<unsigned*>(smem + kStageBytes);
    __shared__ int sh_tile, sh_before;
    __shared__ int warp_sums[kTileThreads / 32];
    __shared__ unsigned long long partial64[kTileThreads / 32];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) sh_tile = static_cast<int>(atomicAdd(ticket, 1u));
    if (kHist) {
        for (int b = threadIdx.x; b < bins; b += kTileThreads) sh_hist[b] = 0;
    }
    __syncthreads();
    const int tile = sh_tile;
    if (kHist && tile == 0) {
        // the outputs every block adds into: cleared before tile 0 publishes,
        // which every other block waits to see (directly or through the
        // prefixes that follow it) before it adds
        for (int b = threadIdx.x; b < bins; b += kTileThreads) hist[b] = 0;
        if (threadIdx.x == 0) *half = 0;
        __threadfence();
    }

    // this warp's positions: staged with coalesced 16-byte loads, then each
    // lane's kPerThread consecutive ones from shared memory
    const long long w0 = static_cast<long long>(tile) * kTile + warp * kWarpSpan;
    const long long p0 = w0 + lane * kPerThread;
    int4* stage = reinterpret_cast<int4*>(smem) + warp * (kWarpSpan / 4);
    const bool full = w0 + kWarpSpan <= span;
    int v[kPerThread];
    if (full) {
        const int4* src = reinterpret_cast<const int4*>(diff + w0);
        int4 x[kPerThread / 4];
#pragma unroll
        for (int k = 0; k < kPerThread / 4; ++k) x[k] = __ldg(src + lane + 32 * k);
#pragma unroll
        for (int k = 0; k < kPerThread / 4; ++k) stage[swizzle(lane + 32 * k)] = x[k];
        __syncwarp();
#pragma unroll
        for (int k = 0; k < kPerThread / 4; ++k) {
            const int4 q = stage[swizzle(lane * (kPerThread / 4) + k)];
            v[4 * k] = q.x; v[4 * k + 1] = q.y; v[4 * k + 2] = q.z; v[4 * k + 3] = q.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) v[k] = p0 + k < span ? __ldg(diff + p0 + k) : 0;
    }
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) mine += v[k];

    // scan of the threads' sums: in the warp, then over warps; the tile's sum
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int warp_before = 0, aggregate = 0;
#pragma unroll
    for (int w = 0; w < kTileThreads / 32; ++w) {
        const int s = warp_sums[w];
        warp_before += w < warp ? s : 0;
        aggregate += s;
    }
    if (threadIdx.x == 0)
        store_release(status + tile, (tile == 0 ? kInclusive : kAggregate) |
                                         static_cast<unsigned>(aggregate));
    int before = 0;
    if (tile > 0) {
        before = look_back(status, tile, aggregate, &sh_before);
        __threadfence();  // what the tiles before published, before this block adds
    }
    int cov = before + warp_before + incl - mine;

    // walk the positions, adding runs of one bin at once. A depth's bin
    // without a branch: below 0 or from `cut` on dropped (as unsigned, a
    // negative depth is past any cut), else depth / step by a multiply-high
    // and one correction, clamped into the last bin.
    const long long last = static_cast<long long>(span) - p0;  // positions of this thread < last
    const unsigned magic = 0xffffffffu / static_cast<unsigned>(step);  // quotient - 1 or exact
    const long long cut_depth = max(static_cast<long long>(bins) * step,
                                    static_cast<long long>(hist_max) + 1);
    const unsigned cut = static_cast<unsigned>(min(cut_depth, 0x80000000LL));
    unsigned long long at_half = 0;
    int run_bin = -1;
    unsigned run = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
        cov += v[k];
        v[k] = cov;
        if (kHist && k < last) {
            at_half += cov >= half_depth;
            const unsigned u = static_cast<unsigned>(cov);
            unsigned q = __umulhi(u, magic);
            q += u - q * static_cast<unsigned>(step) >= static_cast<unsigned>(step);
            const int b = u < cut ? min(static_cast<int>(q), bins - 1) : -1;
            if (b != run_bin) {
                if (run_bin >= 0) atomicAdd(sh_hist + run_bin, run);
                run_bin = b;
                run = 0;
            }
            ++run;
        }
    }
    if (cov_out != nullptr) {
        if (full && vec_out) {
            // each lane overwrites only the slots it read; then coalesced stores
#pragma unroll
            for (int k = 0; k < kPerThread / 4; ++k)
                stage[swizzle(lane * (kPerThread / 4) + k)] =
                    make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
            __syncwarp();
            int4* dst = reinterpret_cast<int4*>(cov_out + w0);
#pragma unroll
            for (int k = 0; k < kPerThread / 4; ++k) dst[lane + 32 * k] = stage[swizzle(lane + 32 * k)];
        } else {
#pragma unroll
            for (int k = 0; k < kPerThread; ++k)
                if (k < last) cov_out[p0 + k] = v[k];
        }
    }
    if (!kHist) return;
    if (run_bin >= 0) atomicAdd(sh_hist + run_bin, run);
    at_half = block_sum(at_half, partial64);  // its __syncthreads also covers sh_hist
    for (int b = threadIdx.x; b < bins; b += kTileThreads)
        if (sh_hist[b]) atomicAdd(hist + b, static_cast<u64>(sh_hist[b]));
    if (threadIdx.x == 0 && at_half) atomicAdd(half, at_half);
}

// ---------------------------------------------------------------------------
// R1 and R2: per-region results over the dense coverage
// ---------------------------------------------------------------------------

// The region that holds region position q (0 <= q < offsets[n]): the last r
// with offsets[r] <= q. Every lane of a warp may call it with its own q.
__device__ __forceinline__ int region_of(const long long* __restrict__ offsets, int n,
                                         long long q) {
    int lo = 0, hi = n - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (__ldg(offsets + mid) <= q) lo = mid;
        else hi = mid - 1;
    }
    return lo;
}

// cov[p0] + ... + cov[p0 + len - 1] over the warp (every lane gets the
// total): scalar loads up to the first 16-byte boundary (cov itself is
// 16-byte aligned), then 16 bytes a lane, then the tail.
__device__ __forceinline__ long long warp_range_sum(const int* __restrict__ cov, long long p0,
                                                    int len, int lane) {
    const int* base = cov + p0;
    int head = static_cast<int>((4 - (p0 & 3)) & 3);
    if (head > len) head = len;
    long long acc = lane < head ? __ldg(base + lane) : 0;
    const int body = (len - head) >> 2;
    const int4* v = reinterpret_cast<const int4*>(base + head);
#pragma unroll 4
    for (int i = lane; i < body; i += 32) {
        const int4 x = __ldg(v + i);
        acc += static_cast<long long>(x.x) + x.y + x.z + x.w;
    }
    const int tail = head + (body << 2);
    if (lane < len - tail) acc += __ldg(base + tail + lane);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
    return acc;
}

__device__ __forceinline__ bool is_hit(int c, long long cutoff, bool high) {
    return high ? c >= cutoff : c < cutoff;
}

// One step of a search the whole warp shares for the region that holds q,
// known to lie in [lo, hi]: 32 probes at once narrow the range about 32
// times, where a binary search takes log2(n) loads one after another.
__device__ __forceinline__ void warp_probe(const long long* __restrict__ offsets, long long q,
                                           int& lo, int& hi) {
    const int lane = threadIdx.x & 31;
    // probes at lo + ceil((hi - lo)(lane + 1) / 32): lane 31's is hi
    const int at = lo + static_cast<int>((static_cast<long long>(hi - lo) * (lane + 1) + 31) / 32);
    const int k = __popc(__ballot_sync(kFull, __ldg(offsets + at) <= q));
    const int at_k = __shfl_sync(kFull, at, k & 31);
    const int at_below = __shfl_sync(kFull, at, (k + 31) & 31);
    if (k > 0) lo = at_below;   // lanes < k probe regions starting at or before q
    if (k < 32) hi = at_k - 1;
}

// region_of for a q the whole warp shares.
__device__ __forceinline__ int warp_region_of(const long long* __restrict__ offsets, int n,
                                              long long q) {
    int lo = 0, hi = n - 1;  // the region is in [lo, hi]
    while (lo < hi) warp_probe(offsets, q, lo, hi);
    return lo;
}

// cov[a] + ... + cov[a + len - 1] by one lane: scalar loads up to the first
// 16-byte boundary, then 16 bytes at a time, then the tail.
__device__ __forceinline__ long long lane_range_sum(const int* __restrict__ cov, long long a,
                                                    int len) {
    const int* base = cov + a;
    int head = static_cast<int>((4 - (a & 3)) & 3);
    if (head > len) head = len;
    long long acc = 0;
    for (int i = 0; i < head; ++i) acc += __ldg(base + i);
    const int body = (len - head) >> 2;
    const int4* v = reinterpret_cast<const int4*>(base + head);
#pragma unroll 4
    for (int i = 0; i < body; ++i) {
        const int4 x = __ldg(v + i);
        acc += static_cast<long long>(x.x) + x.y + x.z + x.w;
    }
    for (int i = head + (body << 2); i < len; ++i) acc += __ldg(base + i);
    return acc;
}

// R1: warps stride over tiles of region positions, as many tiles as the
// grid has warps (a multiple of kSumTileStep positions, at most kSumTile);
// each adds every region's piece of its tile into out[r] (zeroed by the
// launcher). Lane j holds offsets[win + j] and starts[win + j] of the
// window of regions win .. win + 31; a step takes the pieces of the window's
// regions from r on: those before the first piece of kShortPiece or more
// positions a lane each, then that piece by the whole warp.
__global__ void __launch_bounds__(kRegionThreads, 4)
region_sums_kernel(const int* __restrict__ cov, const int* __restrict__ starts,
                   const long long* __restrict__ offsets, int n, u64* __restrict__ out) {
    const long long total = __ldg(offsets + n);
    const int lane = threadIdx.x & 31;
    const long long warps = static_cast<long long>(gridDim.x) * (kRegionThreads / 32);
    long long tile = (total + warps - 1) / warps;
    tile = min(max((tile + kSumTileStep - 1) / kSumTileStep * kSumTileStep,
                   static_cast<long long>(kSumTileStep)),
               static_cast<long long>(kSumTile));
    const long long tiles = (total + tile - 1) / tile;
    for (long long t = (static_cast<long long>(blockIdx.x) * kRegionThreads + threadIdx.x) >> 5;
         t < tiles; t += warps) {
        long long q = t * tile;
        const long long q_end = min(q + tile, total);
        // the region r that holds q (r < n, offsets[r] <= q): the search
        // stops within 32 regions of it, and the window's loads end it
        int win = 0, last = n - 1;
        while (last - win >= 32) warp_probe(offsets, q, win, last);
        long long win_lo = __ldg(offsets + min(win + lane, n));
        int win_start = __ldg(starts + min(win + lane, n - 1));
        int r = win + __popc(__ballot_sync(kFull, win + lane <= last && win_lo <= q)) - 1;
        while (q < q_end) {
            if (r - win >= 31) {  // lane 31 has no end in the window
                win = r;
                win_lo = __ldg(offsets + min(win + lane, n));
                win_start = __ldg(starts + min(win + lane, n - 1));
            }
            // this lane's region win + lane: its piece [ps, pe) of the tile
            const long long hi = __shfl_down_sync(kFull, win_lo, 1);
            const bool in = lane >= r - win && lane < 31 && win_lo < q_end;
            const long long ps = max(win_lo, q), pe = min(hi, q_end);
            const int len = in && pe > ps ? static_cast<int>(pe - ps) : 0;
            const long long at = win_start + (ps - win_lo);  // its first coverage position
            const unsigned valid = __ballot_sync(kFull, in);   // lanes r - win .. g
            const unsigned longs = __ballot_sync(kFull, len >= kShortPiece);
            const int f = longs ? __ffs(longs) - 1 : 32;
            if (lane < f && len > 0)
                atomicAdd(out + win + lane, static_cast<u64>(lane_range_sum(cov, at, len)));
            if (longs) {
                const long long sum = warp_range_sum(cov, __shfl_sync(kFull, at, f),
                                                     __shfl_sync(kFull, len, f), lane);
                if (lane == 0) atomicAdd(out + win + f, static_cast<u64>(sum));
                q = __shfl_sync(kFull, pe, f);
                r = win + f + 1;
            } else {
                // the last region of the window that starts in the tile: the
                // tile ends in it, or the next step takes the region after it
                const int g = 31 - __clz(valid);
                q = __shfl_sync(kFull, pe, g);
                r = win + g + 1;
            }
        }
    }
}

// R2: warp w of block b takes region positions [q_begin, q_begin + 1024),
// q_begin = b * kRunBlock + w * kRunWarpSpan, lane l the mask word of
// positions q_begin + 32l ..; `mask` holds a word for every 32 positions of
// the blocks' range. Count pass (kWrite false): the hit bits into `mask`,
// and the block's numbers of run starts and run ends into scan[b] and
// scan[blocks + b]. Write pass: scan holds their exclusive prefixes; each
// start writes (region, position) into out[0][i], out[1][i], each end its
// position into out[2][i]. Both walk the tile's pieces the same way for the
// region-start and region-end bits; only the count pass reads the coverage.
template <bool kWrite>
__global__ void __launch_bounds__(kRegionThreads)
runs_kernel(const int* __restrict__ cov, const int* __restrict__ starts,
            const long long* __restrict__ offsets, int n, long long cutoff, bool high,
            int blocks, unsigned* __restrict__ mask, long long* __restrict__ scan,
            int n_runs, int* __restrict__ out) {
    __shared__ int warp_counts[2][kRegionThreads / 32];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long total = min(__ldg(offsets + n), static_cast<long long>(blocks) * kRunBlock);
    const long long q_begin = static_cast<long long>(blockIdx.x) * kRunBlock + warp * kRunWarpSpan;
    const long long q_end = min(q_begin + kRunWarpSpan, total);
    const long long word = q_begin / 32 + lane;
    unsigned hits = 0, region_starts = 0, region_ends = 0;  // this lane's word
    bool hit_before = false, hit_after = false;  // the positions next to the tile
    if (q_begin < q_end) {
        int r = warp_region_of(offsets, n, q_begin);
        // regions win .. win + 31: lane j holds offsets[win + j] and starts[win + j]
        int win = r;
        long long win_lo = __ldg(offsets + min(win + lane, n));
        int win_start = __ldg(starts + min(win + lane, n - 1));
        for (long long q = q_begin;; ++r) {
            if (r - win >= 31) {
                win = r;
                win_lo = __ldg(offsets + min(win + lane, n));
                win_start = __ldg(starts + min(win + lane, n - 1));
            }
            const long long lo = __shfl_sync(kFull, win_lo, r - win);
            const long long hi = __shfl_sync(kFull, win_lo, r - win + 1);
            const long long qb = min(hi, q_end);
            if (qb > q) {  // a region of length 0 has no piece
                const long long at = __shfl_sync(kFull, win_start, r - win) - lo;  // + q: coverage position
                const int d0 = static_cast<int>(q - q_begin), d1 = static_cast<int>(qb - 1 - q_begin);
                if (q == lo && lane == (d0 >> 5)) region_starts |= 1u << (d0 & 31);
                if (qb == hi && lane == (d1 >> 5)) region_ends |= 1u << (d1 & 31);
                if (!kWrite) {
                    if (q == q_begin && q > lo && lane == 0)
                        hit_before = is_hit(__ldg(cov + at + q - 1), cutoff, high);
                    if (qb == q_end && q_end < hi && lane == 31)
                        hit_after = is_hit(__ldg(cov + at + q_end), cutoff, high);
                    for (int w = d0 >> 5; w <= (d1 >> 5); w += kRunBatch) {
                        int c[kRunBatch];
                        bool in[kRunBatch];
#pragma unroll
                        for (int k = 0; k < kRunBatch; ++k) {
                            const long long x = q_begin + 32 * (w + k) + lane;
                            in[k] = x >= q && x < qb;
                            c[k] = in[k] ? __ldg(cov + at + x) : 0;
                        }
#pragma unroll
                        for (int k = 0; k < kRunBatch; ++k) {
                            const unsigned b = __ballot_sync(kFull, in[k] && is_hit(c[k], cutoff, high));
                            if (lane == w + k) hits |= b;
                        }
                    }
                }
                q = qb;
            }
            if (q >= q_end) break;
        }
    }
    if (kWrite) {
        hits = mask[word];
        if (lane == 0 && q_begin > 0 && q_begin < q_end) hit_before = mask[word - 1] >> 31;
        if (lane == 31 && q_end < total) hit_after = mask[word + 1] & 1u;
    } else {
        mask[word] = hits;
    }
    // a run starts at a hit whose predecessor is not hit or in another
    // region, and ends at a hit whose successor is not hit or in another
    const unsigned up = __shfl_up_sync(kFull, hits, 1), down = __shfl_down_sync(kFull, hits, 1);
    const unsigned prev = (hits << 1) | (lane == 0 ? static_cast<unsigned>(hit_before) : up >> 31);
    const unsigned next = (hits >> 1) | ((lane == 31 ? static_cast<unsigned>(hit_after) : down & 1u) << 31);
    const unsigned begins = hits & ~(prev & ~region_starts);
    const unsigned ends = hits & ~(next & ~region_ends);
    const int n_begin = __popc(begins), n_end = __popc(ends);
    if (!kWrite) {
        const int wb = __reduce_add_sync(kFull, n_begin), we = __reduce_add_sync(kFull, n_end);
        if (lane == 0) {
            warp_counts[0][warp] = wb;
            warp_counts[1][warp] = we;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            long long sb = 0, se = 0;
            for (int w = 0; w < kRegionThreads / 32; ++w) {
                sb += warp_counts[0][w];
                se += warp_counts[1][w];
            }
            scan[blockIdx.x] = sb;
            scan[blocks + blockIdx.x] = se;
        }
        return;
    }
    // this lane's offsets: the block's, the warps' before it, the lanes' before it
    int ib = n_begin, ie = n_end;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int yb = __shfl_up_sync(kFull, ib, o), ye = __shfl_up_sync(kFull, ie, o);
        if (lane >= o) {
            ib += yb;
            ie += ye;
        }
    }
    if (lane == 31) {
        warp_counts[0][warp] = ib;
        warp_counts[1][warp] = ie;
    }
    __syncthreads();
    long long at_begin = scan[blockIdx.x] + ib - n_begin;
    long long at_end = scan[blocks + blockIdx.x] + ie - n_end;
    for (int w = 0; w < warp; ++w) {
        at_begin += warp_counts[0][w];
        at_end += warp_counts[1][w];
    }
    unsigned bits = begins | ends;
    if (bits == 0) return;
    const long long x0 = q_begin + 32 * lane;
    int r = region_of(offsets, n, x0 + __ffs(bits) - 1);
    long long lo = __ldg(offsets + r), hi = __ldg(offsets + r + 1);
    long long at = __ldg(starts + r) - lo;
    while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1;
        const long long x = x0 + b;
        while (x >= hi) {
            ++r;
            lo = hi;
            hi = __ldg(offsets + r + 1);
            at = __ldg(starts + r) - lo;
        }
        const int p = static_cast<int>(at + x);
        if ((begins >> b) & 1u) {
            out[at_begin] = r;
            out[n_runs + at_begin] = p;
            ++at_begin;
        }
        if ((ends >> b) & 1u) out[2LL * n_runs + at_end++] = p;
    }
}

// R2 between its passes: block b turns scan[b * count .. (b + 1) * count)
// (the count pass's blocks' numbers of run starts, then of run ends) into
// its exclusive prefix in place and writes the total at scan[2 * count + b],
// or -1 where the regions hold more positions than the coverage (capacity).
__global__ void __launch_bounds__(kScanThreads)
runs_scan_kernel(long long* __restrict__ scan, int count,
                 const long long* __restrict__ offsets, int n, long long capacity) {
    __shared__ long long warp_sums[kScanThreads / 32];
    long long* a = scan + static_cast<long long>(blockIdx.x) * count;
    const int per = (count + kScanThreads - 1) / kScanThreads;
    const int b = min(static_cast<int>(threadIdx.x) * per, count);
    const int e = min(b + per, count);
    long long mine = 0;
    for (int i = b; i < e; ++i) mine += a[i];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    long long incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        long long w = warp_sums[lane];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const long long y = __shfl_up_sync(kFull, w, o);
            if (lane >= o) w += y;
        }
        warp_sums[lane] = w;
    }
    __syncthreads();
    long long run = (warp > 0 ? warp_sums[warp - 1] : 0) + incl - mine;
    for (int i = b; i < e; ++i) {
        const long long v = a[i];
        a[i] = run;
        run += v;
    }
    if (threadIdx.x == kScanThreads - 1)
        scan[2LL * count + blockIdx.x] = __ldg(offsets + n) > capacity ? -1 : run;
}

int add_grid(long long n) {
    const long long want = (n + kAddThreads - 1) / kAddThreads;
    const long long most = 8LL * ngs::sm_count();
    return static_cast<int>(want < most ? (want > 0 ? want : 1) : most);
}

// R2's blocks for regions over a coverage of `positions`, and the int64
// scratch they take: the mask (kRunWords 32-bit words a block), then the
// block counts of run starts and of run ends, then the two totals.
long long runs_blocks(long long positions) {
    return (positions + kRunBlock - 1) / kRunBlock;
}

long long runs_scratch(long long blocks) {
    return blocks * (kRunWords / 2 + 2) + 2;
}

// R2's count (kWrite false) or write pass on the caller's scratch.
template <bool kWrite>
int runs_pass(const void* cov, long long cov_len, const void* starts, const void* offsets,
              int n, long long cutoff, int is_high, void* scratch, int n_runs, void* out,
              cudaStream_t s) {
    const long long blocks = runs_blocks(cov_len);
    if (n < 1 || blocks < 1 || blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    unsigned* mask = static_cast<unsigned*>(scratch);
    long long* scan = static_cast<long long*>(scratch) + blocks * (kRunWords / 2);
    runs_kernel<kWrite><<<static_cast<int>(blocks), kRegionThreads, 0, s>>>(
        static_cast<const int*>(cov), static_cast<const int*>(starts),
        static_cast<const long long*>(offsets), n, cutoff, is_high != 0,
        static_cast<int>(blocks), mask, scan, n_runs, static_cast<int*>(out));
    cudaError_t err = cudaGetLastError();
    if (kWrite || err != cudaSuccess) return static_cast<int>(err);
    runs_scan_kernel<<<2, kScanThreads, 0, s>>>(scan, static_cast<int>(blocks),
                                                static_cast<const long long*>(offsets), n,
                                                cov_len);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// ends may be null: unit spans at the starts.
int ngs_coverage_add(const void* starts, const void* ends, long long n, int span,
                     void* diff, void* stream) {
    coverage_add_kernel<<<add_grid(n), kAddThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(starts), static_cast<const int*>(ends), n, span,
        static_cast<int*>(diff));
    return static_cast<int>(cudaGetLastError());
}

// C1's read form: reads int32 [4, k], regions int32 [3, n] (see the kernel).
int ngs_coverage_add_reads(const void* reads, int k, const void* regions, int n, int span,
                           void* diff, void* stream) {
    if (k < 0 || n < 0 || span < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (k == 0) return static_cast<int>(cudaSuccess);
    coverage_add_reads_kernel<<<add_grid(k), kAddThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(reads), k, static_cast<const int*>(regions), n, span,
        static_cast<int*>(diff));
    return static_cast<int>(cudaGetLastError());
}

// C1's record form: records [r0, r1) whose key is `ref`; blocks int64
// [3, n_blocks] (starts, ends, offsets); qual_off and qual are read only
// with min_baseq > 0.
int ngs_coverage_add_records(const void* pos, const void* keep, const void* cigar_off,
                             const void* cigar, const void* qual_off, const void* qual, int r0,
                             int r1, int ref, int min_baseq, const void* blocks, int n_blocks,
                             int span, void* diff, void* stream) {
    if (r0 < 0 || r1 < r0 || n_blocks < 1 || span < 0 ||
        (min_baseq > 0 && (qual_off == nullptr || qual == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (r0 == r1) return static_cast<int>(cudaSuccess);
    const long long* b = static_cast<const long long*>(blocks);
    const Blocks g{b, b + n_blocks, b + 2LL * n_blocks, n_blocks, span};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long n = static_cast<long long>(r1) - r0;
    if (min_baseq > 0)
        coverage_records_baseq_kernel<<<add_grid(32 * n), kAddThreads, 0, s>>>(
            static_cast<const int*>(pos), static_cast<const int*>(keep),
            static_cast<const long long*>(cigar_off), static_cast<const unsigned*>(cigar),
            static_cast<const long long*>(qual_off), static_cast<const unsigned char*>(qual), r0,
            r1, ref, min_baseq, g, static_cast<int*>(diff));
    else
        coverage_records_kernel<<<add_grid(n), kAddThreads, 0, s>>>(
            static_cast<const int*>(pos), static_cast<const int*>(keep),
            static_cast<const long long*>(cigar_off), static_cast<const unsigned*>(cigar), r0, r1,
            ref, g, static_cast<int*>(diff));
    return static_cast<int>(cudaGetLastError());
}

int ngs_bincount_add(const void* idx, long long n, int size, void* counts, void* stream) {
    bincount_add_kernel<<<add_grid(n), kAddThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(idx), n, size, static_cast<int*>(counts));
    return static_cast<int>(cudaGetLastError());
}

// C2's scratch for a span, in int64: a status word a tile of kTile
// positions, then the counter that hands out the tiles.
long long ngs_coverage_scratch(int span) {
    return (static_cast<long long>(span) + kTile - 1) / kTile + 1;
}

// scratch: ngs_coverage_scratch(span) int64, cleared here; diff 16-byte
// aligned; cov_out may be null.
int ngs_coverage_finalize(const void* diff, int span, int step, int hist_max, int bins,
                          int half_depth, void* scratch, void* hist, void* half, void* cov_out,
                          void* stream) {
    // bins == 0: the dense coverage alone (hist and half unused)
    const long long tiles = ngs_coverage_scratch(span) - 1;
    if (span < 1 || step < 1 || bins < 0 || bins > kMaxBins ||
        (bins == 0 && cov_out == nullptr) || (bins > 0 && (hist == nullptr || half == nullptr)) ||
        reinterpret_cast<uintptr_t>(diff) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    u64* status = static_cast<u64*>(scratch);
    cudaError_t err = cudaMemsetAsync(status, 0, (tiles + 1) * sizeof(u64), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = kStageBytes + 4 * static_cast<size_t>(bins);
    auto kernel = bins > 0 ? coverage_scan_kernel<true> : coverage_scan_kernel<false>;
    if (smem > 48 * 1024) {  // past about 4,070 bins: allowed for this launch
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<static_cast<int>(tiles), kTileThreads, smem, s>>>(
        static_cast<const int*>(diff), span, status, reinterpret_cast<unsigned*>(status + tiles),
        step, hist_max, bins, half_depth, static_cast<u64*>(hist), static_cast<u64*>(half),
        static_cast<int*>(cov_out), reinterpret_cast<uintptr_t>(cov_out) % 16 == 0);
    return static_cast<int>(cudaGetLastError());
}

// R1: out [n] int64; cov 16-byte aligned.
int ngs_region_sums(const void* cov, const void* starts, const void* offsets, int n,
                    void* out, void* stream) {
    if (n < 1 || reinterpret_cast<uintptr_t>(cov) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(n) * sizeof(u64), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    region_sums_kernel<<<4 * ngs::sm_count(), kRegionThreads, 0, s>>>(
        static_cast<const int*>(cov), static_cast<const int*>(starts),
        static_cast<const long long*>(offsets), n, static_cast<u64*>(out));
    return static_cast<int>(cudaGetLastError());
}

// R2's scratch, in int64, for regions over a coverage of `positions`.
long long ngs_runs_scratch(long long positions) {
    return runs_scratch(runs_blocks(positions));
}

// R2's passes on ngs_runs_scratch(cov_len) int64 of scratch; the count pass
// leaves the totals of run starts and ends in its last two.
int ngs_runs_count(const void* cov, long long cov_len, const void* starts, const void* offsets,
                   int n, long long cutoff, int is_high, void* scratch, void* stream) {
    return runs_pass<false>(cov, cov_len, starts, offsets, n, cutoff, is_high, scratch, 0,
                            nullptr, static_cast<cudaStream_t>(stream));
}

// out [3, n_runs] int32: region, first and last position of each run.
int ngs_runs_write(const void* cov, long long cov_len, const void* starts, const void* offsets,
                   int n, long long cutoff, int is_high, void* scratch, int n_runs, void* out,
                   void* stream) {
    if (n_runs < 1) return static_cast<int>(cudaErrorInvalidValue);
    return runs_pass<true>(cov, cov_len, starts, offsets, n, cutoff, is_high, scratch, n_runs,
                           out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
