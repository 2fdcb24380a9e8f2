// The pileup's record forms for Hopper (sm_90a): the device side of
// `pileup_add_records_into`, `pileup_indels_into` and `pileup_regions_into`
// in ngsbits_tpu_torch/ops/device_reduce.py, each one launch on the caller's
// stream a BAM batch, all on the same uploaded records.
//
//   pileup_add_records  B1's record form: a batch's alignment records
//                       (positions, keys from the host's flag filter, MAPQ,
//                       CIGARs, 4-bit bases and qualities) walked on the card
//                       to the SNP loci they cover, counting each locus' A,
//                       C, G and T bases, its deletions and, when asked, the
//                       reads over it and those of MAPQ 0 (replaces the
//                       host's per-op expansion, its join against the loci
//                       and its base, deletion and MAPQ-0 counts in
//                       ngsbits_tpu/qc/pileup.py:126-251, and
//                       `DeviceBincount`, ngsbits_tpu/ops/device_reduce.py:135,
//                       after them)
//   pileup_indels       B1's indel form: the same records' I and D ops within
//                       a window of the loci, each (record, locus) hit with
//                       the op's query offset and CIGAR word, for the host to
//                       key as '+SEQ' or '-LEN' (replaces the JAX package's
//                       host loop over every I and D op of every selected
//                       record in ngsbits_tpu/qc/pileup.py:278-364, a
//                       search of the loci each)
//   pileup_regions      B1's region form: the same records over indel regions
//                       of varying length, each region's reads, MAPQ-0 reads
//                       and spanning depth (N ops over it taken off), and each
//                       I and D op of a spanning record inside it as a hit for
//                       the host to key as '+SEQ' or '-REFSEQ' (replaces the
//                       JAX package's host get_indels,
//                       ngsbits_tpu/qc/variant_details.py:134-208: a numpy
//                       filter of each batch for each region and a Python
//                       CIGAR walk of each record over it)
//
// The JAX package expands every CIGAR op of every selected record on the host
// and joins the M and D ops against each chromosome's sorted loci with
// searchsorted; the device only counts the (locus, base) pairs that come out.
// Here the card takes the records as they were decoded. A thread takes a
// record: it sums its CIGAR's reference lengths for its span and searches
// its chromosome's loci (a per-ref_id [lo, hi) table into the loci, sorted
// by position within each chromosome) for the first one at or after its
// start. Most records of a panel's BAM reach no locus (a few percent do at
// the exome's 3,218 contamination SNPs) and stop there, so a thread a record
// keeps every lane on a search of its own where a warp a record would leave
// 31 lanes idle. A record that reaches a locus adds itself to the reads over
// each of them (before the MAPQ cut) and, at MAPQ 0, to their MAPQ-0 count;
// if its MAPQ passes it walks its CIGAR once beside a pointer into the loci:
// each reference-consuming op moves the pointer past the loci it covers; an
// M, = or X op counts the base at each of them whose code is A, C, G or T
// and whose quality byte is at least min_baseq (0xFF, "no qualities",
// counts), a D op a deletion, and an N op nothing. A locus past the record's
// SEQ (a record with M ops and l_seq 0, or a CIGAR longer than its SEQ) has
// no base and counts nowhere: no other record's bytes are read. Duplicate
// loci each count, as the host's searchsorted ranges count them.
//
// The counters (4 + 1 + 2 int32 a locus, in sorted-locus order) are a few
// tens of kB: they stay in the L2 for the whole sweep, and the atomics into
// them are exact in any order. Its bound by bytes is what it must read: 16
// bytes a record (position, key, MAPQ, the CIGAR offsets) and, for the
// records that reach a locus, their CIGAR words, offsets into the bases and
// one base and one quality byte a locus they cover; at MappingQC's batches
// that is well under a microsecond, and one launch a batch takes about a
// launch's latency (PERF.md).
//
// The indel form also takes a thread a record: most records have no I or D op
// and stop after one pass over their CIGAR words. Each I or D op lies at g,
// pos + 1 plus the reference consumed before it, and makes a hit at each locus
// of its chromosome within the window of g, duplicates included. An I op whose
// bases lie past the record's SEQ makes no hit: no other record's bytes are
// read. The launch is short (a few thousand records that reach a locus, a few
// hundred I and D ops, tens of hits), so its time is the launch and its
// slowest thread's chain of dependent loads; the design shortens both:
//
// - one device operation a launch: the hit count lives in an 8-byte scratch
//   word the caller zeroes once (with a 4-byte count of finished blocks
//   beside it), not in a memset before each launch. An I or D op's hits
//   claim their slots together with one 64-bit atomic on it (an atomic a hit
//   queued 121,095 atomics on that one word at 200,000 loci); the last block
//   to finish (a fence, then a ticket on the block count) moves the count
//   into out[0] and zeroes both words, so the next launch on the stream finds
//   them clean (a CUDA graph of launches too). Each block's first thread
//   prefetches the scratch into the L2 as it starts. A launch that fails
//   leaves the words as they were, and the caller raises.
// - a short chain of loads a record: its key, MAPQ, CIGAR and SEQ offsets
//   and position are loaded together before any branch on them; the per-
//   ref_id table (up to kStagedRefs references) and the loci the batch can
//   reach (up to kStagedLoci) are staged in shared memory by each block while
//   its first records' loads are in flight; CIGAR words come four at a
//   time. An I or D op searches its record's loci afresh: a pointer moved
//   forward from the record's first op (g never decreases along a CIGAR) was
//   no faster at VcfMerge's launches or at 200,000 loci (PERF.md).
// - the loci the batch can reach: the host's pre-filter finds each record's
//   range of loci within its span widened by the window, and the launch takes
//   [lo_cut, hi_cut), the smallest range of the sorted loci that holds all of
//   them (a coordinate-sorted batch reaches a few hundred loci); each
//   record's range of its chromosome's loci is cut to it. Past kStagedLoci
//   the searches read the loci in global memory.
//
// The host reckons the capacity before the launch (the batch's I and D ops
// times the most loci in any 2 * window + 1 positions); past it the kernel
// only counts, so the wrapper raises and never drops a hit. The hits come
// back in one copy with their count; their order is the atomics', and the
// host counts them into a dict a locus, so no output depends on it.
//
// The region form also takes a thread a record. It sums the record's span
// from its CIGAR, searches its chromosome's regions (sorted by start, a
// per-ref_id [lo, hi) table with the chromosome's longest region beside it)
// for the first that starts at or after the span's start less that longest
// region, and walks the regions from there while they start within the span:
// each that ends at or after the span's start overlaps. It counts the read
// there (and at MAPQ 0 the MAPQ-0 read, and nothing more); where the record
// spans the region it adds 1 to its depth less each N op from g at or before
// the start to g + len at or past the end, and each I or D op at start <= g
// <= end claims a slot with one 64-bit atomic and writes (record, region,
// query offset, CIGAR index, g). A batch that reaches the regions holds a few
// thousand records and a few hundred hits, so the launch is its latency and
// one thread's chain of dependent loads; the counters (12 bytes a region)
// stay in the L2. The design shortens the chain as the indel form's does:
//
// - one device operation a launch: the hit count lives in a 64-bit word of
//   the caller's scratch, zeroed once, with the count of finished blocks in
//   its top 24 bits. Each block's thread 0 adds its ticket to that word
//   after the block's barrier, so the word's own order puts every hit of a
//   block before its ticket: the ticket that finds all other blocks'
//   returns the whole count, which that block writes into out[0] before it
//   clears the word. The next launch (or a CUDA graph's replay) finds it
//   clean; a launch that fails leaves it as it was, and the caller raises.
//   Unlike the indel form's ticket on a second word, this needs no fence,
//   which waited for the block's atomics on the counters to drain.
// - a short chain of loads a record: its key, MAPQ, CIGAR offsets and
//   position are loaded before any branch on them, the table's three words
//   together, and each region's start and end together; CIGAR words come
//   four at a time. The first walk gives the span and whether the record
//   holds an I, D or N op. A record without one (most 151 bp reads) walks no
//   further: it adds 1 to the depth of each region it spans and makes no
//   hit. Only a record with one walks its CIGAR again over each region it
//   spans, four words at a time, and stops once g is past the region's start
//   and end. The regions and the table are read in global memory (through
//   the L1): staging them in shared memory was measured and bought nothing.
// - the regions the batch can reach: the host's pre-filter finds each
//   record's range of regions, and the launch takes [lo_cut, hi_cut), the
//   smallest range of the sorted regions that holds all of them; each
//   record's range of its chromosome's regions is cut to it.
//
// Its bound by bytes: 16 bytes a record, the CIGAR words of records that
// reach a region, the regions and table, 40 bytes a hit and the counters
// written once.
//
// The launchers take raw pointers, sizes and the stream, and return
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;

// BAM's CIGAR ops M I D N S H P = X (0-8), as bit masks: those that consume
// the reference and those that consume the query. Codes 9-15 consume
// nothing.
constexpr unsigned kRefOps = 0x18Du;     // M D N = X
constexpr unsigned kQueryOps = 0x193u;   // M I S = X
constexpr unsigned kMatchOps = 0x181u;   // M = X
constexpr unsigned kInsertion = 1u;
constexpr unsigned kDeletion = 2u;
constexpr unsigned kSkip = 3u;

// A, C, G, T's 4-bit codes (1, 2, 4, 8) to 0-3; every other code to -1.
__device__ __forceinline__ int base_index(unsigned code) {
    return code == 1u ? 0 : code == 2u ? 1 : code == 4u ? 2 : code == 8u ? 3 : -1;
}

// The first locus in [lo, hi) at or after x (hi: none).
__device__ __forceinline__ int lower_bound(const int* __restrict__ loci, int lo, int hi,
                                           long long x) {
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(loci + mid) < x) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// A thread a record. keep: the record's ref_id where the host's flag filter
// kept it, else -1; table: int32 [2, n_refs], each ref_id's range [lo, hi)
// of the sorted loci (1-based positions); counts [n_loci, 4], dels, mapped
// and mapq0 [n_loci] int32 (mapped and mapq0 null: not counted).
__global__ void __launch_bounds__(kThreads)
pileup_records_kernel(const int* __restrict__ pos, const int* __restrict__ keep,
                      const unsigned char* __restrict__ mapq,
                      const long long* __restrict__ cigar_off,
                      const unsigned* __restrict__ cigar, const long long* __restrict__ seq_off,
                      const unsigned char* __restrict__ seq, const unsigned char* __restrict__ qual,
                      int n, const int* __restrict__ loci, const int* __restrict__ table,
                      int n_refs, int min_mapq, int min_baseq, int* __restrict__ counts,
                      int* __restrict__ dels, int* __restrict__ mapped, int* __restrict__ mapq0) {
    const int stride = gridDim.x * kThreads;
    for (int r = blockIdx.x * kThreads + threadIdx.x; r < n; r += stride) {
        const int key = __ldg(keep + r);
        if (key < 0 || key >= n_refs) continue;
        const int lo = __ldg(table + key), hi = __ldg(table + n_refs + key);
        if (lo >= hi) continue;
        const long long c0 = __ldg(cigar_off + r), c1 = __ldg(cigar_off + r + 1);
        long long span = 0;
        for (long long c = c0; c < c1; ++c) {
            const unsigned w = __ldg(cigar + c);
            if ((kRefOps >> (w & 0xF)) & 1) span += w >> 4;
        }
        const long long start = static_cast<long long>(__ldg(pos + r)) + 1;  // 1-based
        const long long end = start + span - 1;                              // inclusive
        const int first = lower_bound(loci, lo, hi, start);
        if (first >= hi || __ldg(loci + first) > end) continue;  // reaches no locus
        const int q = __ldg(mapq + r);
        if (mapped != nullptr) {
            for (int j = first; j < hi && __ldg(loci + j) <= end; ++j) {
                atomicAdd(mapped + j, 1);
                if (q == 0) atomicAdd(mapq0 + j, 1);
            }
        }
        if (q < min_mapq) continue;
        const long long s0 = __ldg(seq_off + r);
        const long long l_seq = __ldg(seq_off + r + 1) - s0;
        long long ref_at = start, q_at = 0;  // where the next op begins
        int j = first;                       // the first locus at or after ref_at
        for (long long c = c0; c < c1 && j < hi; ++c) {
            const unsigned w = __ldg(cigar + c);
            const unsigned op = w & 0xF;
            const long long len = w >> 4;
            if ((kRefOps >> op) & 1) {
                const long long op_end = ref_at + len - 1;
                for (int x; j < hi && (x = __ldg(loci + j)) <= op_end; ++j) {
                    if (op == kDeletion) {
                        atomicAdd(dels + j, 1);
                    } else if ((kMatchOps >> op) & 1) {
                        const long long qi = q_at + (x - ref_at);
                        if (qi >= l_seq) continue;  // past the record's SEQ: no base
                        const int b = base_index(__ldg(seq + s0 + qi));
                        if (b >= 0 && static_cast<int>(__ldg(qual + s0 + qi)) >= min_baseq)
                            atomicAdd(counts + 4LL * j + b, 1);
                    }
                }
                ref_at += len;
            }
            if ((kQueryOps >> op) & 1) q_at += len;
        }
    }
}

constexpr int kStagedLoci = 4096;   // the most loci a launch stages in shared memory
constexpr int kStagedRefs = 1024;   // the most references whose table it stages

// The first locus in [lo, hi) at or after x (hi: none), on loci in shared or
// global memory.
__device__ __forceinline__ int first_at_or_after(const int* loci, int lo, int hi,
                                                 long long x) {
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (loci[mid] < x) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// B1's indel form, a thread a record; the blocks walk the records in steps of
// the grid, a block's threads together, so all of them reach the barrier
// after the staging. seq_off: the records' offsets into their bases (l_seq
// from its differences); lo_cut, hi_cut: the range of the sorted loci the
// records can reach; count, done: the caller's scratch (zero before the
// launch, zero after it); out: int64 [1 + 4 * capacity], the count of hits
// (written by the last block), then each hit's record, locus (in the sorted
// loci), the op's query offset and its CIGAR word.
template <bool kStageTable, bool kStageLoci>
__global__ void __launch_bounds__(kThreads)
pileup_indels_kernel(const int* __restrict__ pos, const int* __restrict__ keep,
                     const unsigned char* __restrict__ mapq,
                     const long long* __restrict__ cigar_off, const unsigned* __restrict__ cigar,
                     const long long* __restrict__ seq_off, int n,
                     const int* __restrict__ loci, const int* __restrict__ table, int n_refs,
                     int lo_cut, int hi_cut, int min_mapq, int window,
                     unsigned long long* __restrict__ count, unsigned* __restrict__ done,
                     long long* __restrict__ out, long long capacity) {
    extern __shared__ int staged[];  // the table (kStageTable), then the loci (kStageLoci)
    int* staged_loci = staged + (kStageTable ? 2 * n_refs : 0);
    const int* tab = kStageTable ? staged : table;
    const int* cut = kStageLoci ? staged_loci : loci + lo_cut;  // cut[j]: loci[lo_cut + j]
    const int first = blockIdx.x * kThreads;
    const int stride = gridDim.x * kThreads;
    // the scratch into the L2 for the atomics, while the records' loads are issued
    if (threadIdx.x == 0) asm volatile("prefetch.global.L2 [%0];" ::"l"(count));
    for (int base = first; base < n; base += stride) {
        const int r = min(base + static_cast<int>(threadIdx.x), n - 1);
        // the record's columns, every load issued before a branch on any
        const int key = __ldg(keep + r);
        const int q = __ldg(mapq + r);
        const long long c0 = __ldg(cigar_off + r), c1 = __ldg(cigar_off + r + 1);
        const long long l_seq = __ldg(seq_off + r + 1) - __ldg(seq_off + r);
        long long ref_at = static_cast<long long>(__ldg(pos + r)) + 1, q_at = 0;
        if (base == first) {  // once a block, while those loads are in flight
            if (kStageTable)
                for (int i = threadIdx.x; i < 2 * n_refs; i += kThreads)
                    staged[i] = __ldg(table + i);
            if (kStageLoci)
                for (int i = threadIdx.x; i < hi_cut - lo_cut; i += kThreads)
                    staged_loci[i] = __ldg(loci + lo_cut + i);
            __syncthreads();
        }
        if (base + static_cast<int>(threadIdx.x) >= n || key < 0 || key >= n_refs ||
            q < min_mapq)
            continue;
        const int lo = max(tab[key], lo_cut) - lo_cut;
        const int hi = min(tab[n_refs + key], hi_cut) - lo_cut;
        if (lo >= hi) continue;
        auto visit = [&](unsigned word) {
            const unsigned op = word & 0xF;  // 15 past the CIGAR: consumes nothing
            const long long len = word >> 4;
            if (op == kDeletion || (op == kInsertion && q_at + len <= l_seq)) {
                const int j = first_at_or_after(cut, lo, hi, ref_at - window);
                int end = j;
                while (end < hi && cut[end] <= ref_at + window) ++end;
                if (end > j) {  // the op's hits: one atomic claims their slots
                    unsigned long long slot =
                        atomicAdd(count, static_cast<unsigned long long>(end - j));
                    for (int t = j; t < end && slot < static_cast<unsigned long long>(capacity);
                         ++t, ++slot) {
                        long long* h = out + 1 + 4 * slot;
                        h[0] = r;
                        h[1] = lo_cut + t;
                        h[2] = q_at;
                        h[3] = static_cast<long long>(word);
                    }
                }
            }
            if ((kRefOps >> op) & 1) ref_at += len;
            if ((kQueryOps >> op) & 1) q_at += len;
        };
        for (long long c = c0; c < c1; c += 4) {  // four words in flight
            const unsigned w0 = __ldg(cigar + c);
            const unsigned w1 = c + 1 < c1 ? __ldg(cigar + c + 1) : 0xFu;
            const unsigned w2 = c + 2 < c1 ? __ldg(cigar + c + 2) : 0xFu;
            const unsigned w3 = c + 3 < c1 ? __ldg(cigar + c + 3) : 0xFu;
            visit(w0);
            visit(w1);
            visit(w2);
            visit(w3);
        }
    }
    // the last block to finish: the count into out[0], the scratch cleared
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        if (atomicAdd(done, 1u) == gridDim.x - 1) {
            out[0] = static_cast<long long>(atomicExch(count, 0ULL));
            atomicExch(done, 0u);
        }
    }
}

// B1's region form: the ops that make a spanning record walk its CIGAR
// again (I, D and N); its count word, the hits in the low 40 bits and the
// finished blocks above them.
constexpr unsigned kWalkOps = (1u << kInsertion) | (1u << kDeletion) | (1u << kSkip);
constexpr int kBlockShift = 40;
constexpr unsigned long long kHitMask = (1ULL << kBlockShift) - 1;

// The reference a CIGAR word consumes (0 past the CIGAR: its word is 0xF).
__device__ __forceinline__ long long ref_length(unsigned word) {
    return ((kRefOps >> (word & 0xF)) & 1) ? static_cast<long long>(word >> 4) : 0;
}

// B1's region form, a thread a record. regions: starts and ends, int32
// [n_regions] each, 1-based inclusive, sorted by start within each
// reference's range; table: int32 [3, n_refs], each ref_id's range [lo, hi)
// and its longest region's end - start; lo_cut, hi_cut: the range of the
// sorted regions the records can reach; counters: int32 [n_regions] each,
// mapped, mapq0 and depth; count: the caller's scratch word (zero before
// the launch, zero after it); out: int64 [1 + 5 * capacity], the count of
// hits (written by the last block), then each hit's record, region, the
// op's query offset, its index in cigar and its 1-based reference position.
__global__ void __launch_bounds__(kThreads)
pileup_regions_kernel(const int* __restrict__ pos, const int* __restrict__ keep,
                      const unsigned char* __restrict__ mapq,
                      const long long* __restrict__ cigar_off,
                      const unsigned* __restrict__ cigar, int n,
                      const int* __restrict__ starts, const int* __restrict__ ends,
                      const int* __restrict__ table, int n_refs, int lo_cut, int hi_cut,
                      int* __restrict__ mapped, int* __restrict__ mapq0, int* __restrict__ depth,
                      unsigned long long* __restrict__ count, long long* __restrict__ out,
                      long long capacity) {
    const int* st = starts + lo_cut;  // st[j], en[j]: region lo_cut + j's start and end
    const int* en = ends + lo_cut;
    const int stride = gridDim.x * kThreads;
    // the scratch into the L2 for the atomics, while the records' loads are issued
    if (threadIdx.x == 0) asm volatile("prefetch.global.L2 [%0];" ::"l"(count));
    for (int r = blockIdx.x * kThreads + threadIdx.x; r < n; r += stride) {
        // the record's columns, every load issued before a branch on any
        const int key = __ldg(keep + r);
        const int q = __ldg(mapq + r);
        const long long c0 = __ldg(cigar_off + r), c1 = __ldg(cigar_off + r + 1);
        const long long r_start = static_cast<long long>(__ldg(pos + r)) + 1;  // 1-based
        if (key < 0 || key >= n_refs) continue;
        const int lo = max(__ldg(table + key), lo_cut) - lo_cut;
        const int hi = min(__ldg(table + n_refs + key), hi_cut) - lo_cut;
        const int longest = __ldg(table + 2 * n_refs + key);
        if (lo >= hi) continue;
        // the first walk: the span, and which ops the record holds
        long long span = 0;
        unsigned held = 0;
        for (long long c = c0; c < c1; c += 4) {  // four words in flight
            const unsigned w0 = __ldg(cigar + c);
            const unsigned w1 = c + 1 < c1 ? __ldg(cigar + c + 1) : 0xFu;
            const unsigned w2 = c + 2 < c1 ? __ldg(cigar + c + 2) : 0xFu;
            const unsigned w3 = c + 3 < c1 ? __ldg(cigar + c + 3) : 0xFu;
            span += ref_length(w0) + ref_length(w1) + ref_length(w2) + ref_length(w3);
            held |= (1u << (w0 & 0xF)) | (1u << (w1 & 0xF)) | (1u << (w2 & 0xF)) |
                    (1u << (w3 & 0xF));
        }
        const long long r_end = r_start + span - 1;  // inclusive
        const bool walk = (held & kWalkOps) != 0;
        for (int j = first_at_or_after(st, lo, hi, r_start - longest); j < hi; ++j) {
            const long long s = __ldg(st + j), e = __ldg(en + j);  // both in flight
            if (s > r_end) break;
            if (e < r_start) continue;  // starts within reach but ends before the read
            atomicAdd(mapped + lo_cut + j, 1);
            if (q == 0) {
                atomicAdd(mapq0 + lo_cut + j, 1);
                continue;
            }
            if (r_start > s || r_end < e) continue;  // does not span the region
            int delta = 1;
            if (walk) {  // the second walk, over this region
                long long g = r_start, q_at = 0;  // where the next op begins
                // an op past both the start (an N op's g) and the end (an I or
                // D op's) counts nowhere; an empty region's end lies before it
                const long long last = s > e ? s : e;
                auto visit = [&](unsigned word, long long c) {
                    const unsigned op = word & 0xF;  // 15 past the CIGAR: consumes nothing
                    const long long len = word >> 4;
                    if (op == kSkip) {
                        if (g <= s && g + len >= e) --delta;
                    } else if ((op == kInsertion || op == kDeletion) && s <= g && g <= e) {
                        const unsigned long long slot = atomicAdd(count, 1ULL) & kHitMask;
                        if (slot < static_cast<unsigned long long>(capacity)) {
                            long long* h = out + 1 + 5 * slot;
                            h[0] = r;
                            h[1] = lo_cut + j;
                            h[2] = q_at;
                            h[3] = c;
                            h[4] = g;
                        }
                    }
                    if ((kRefOps >> op) & 1) g += len;
                    if ((kQueryOps >> op) & 1) q_at += len;
                };
                for (long long c = c0; c < c1 && g <= last; c += 4) {  // nothing more past it
                    const unsigned w0 = __ldg(cigar + c);
                    const unsigned w1 = c + 1 < c1 ? __ldg(cigar + c + 1) : 0xFu;
                    const unsigned w2 = c + 2 < c1 ? __ldg(cigar + c + 2) : 0xFu;
                    const unsigned w3 = c + 3 < c1 ? __ldg(cigar + c + 3) : 0xFu;
                    visit(w0, c);
                    visit(w1, c + 1);
                    visit(w2, c + 2);
                    visit(w3, c + 3);
                }
            }
            atomicAdd(depth + lo_cut + j, delta);
        }
    }
    // the last block to finish: the count into out[0], the word cleared. The
    // barrier orders each of the block's hits before its ticket, all on one
    // word, so the ticket that finds every other block's returns every hit.
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned long long seen = atomicAdd(count, 1ULL << kBlockShift);
        if ((seen >> kBlockShift) == gridDim.x - 1) {
            out[0] = static_cast<long long>(seen & kHitMask);
            atomicExch(count, 0ULL);
        }
    }
}

int grid_for(long long n) {
    const long long want = (n + kThreads - 1) / kThreads;
    const long long most = 16LL * ngs::sm_count();
    return static_cast<int>(want < most ? (want > 0 ? want : 1) : most);
}

}  // namespace

extern "C" {

// B1's record form: records [0, n); loci int32 [n_loci]; table int32
// [2, n_refs]; mapped and mapq0 may be null (both or neither).
int ngs_pileup_add_records(const void* pos, const void* keep, const void* mapq,
                           const void* cigar_off, const void* cigar, const void* seq_off,
                           const void* seq, const void* qual, int n, const void* loci,
                           int n_loci, const void* table, int n_refs, int min_mapq,
                           int min_baseq, void* counts, void* dels, void* mapped, void* mapq0,
                           void* stream) {
    if (n < 0 || n_loci < 0 || n_refs < 0 || (mapped == nullptr) != (mapq0 == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0 || n_loci == 0 || n_refs == 0) return static_cast<int>(cudaSuccess);
    pileup_records_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(pos), static_cast<const int*>(keep),
        static_cast<const unsigned char*>(mapq), static_cast<const long long*>(cigar_off),
        static_cast<const unsigned*>(cigar), static_cast<const long long*>(seq_off),
        static_cast<const unsigned char*>(seq), static_cast<const unsigned char*>(qual), n,
        static_cast<const int*>(loci), static_cast<const int*>(table), n_refs, min_mapq,
        min_baseq, static_cast<int*>(counts), static_cast<int*>(dels),
        static_cast<int*>(mapped), static_cast<int*>(mapq0));
    return static_cast<int>(cudaGetLastError());
}

// B1's indel form: records [0, n); loci int32 [n_loci]; table int32
// [2, n_refs]; [lo_cut, hi_cut) within [0, n_loci]: the loci the records can
// reach; out int64 [1 + 4 * capacity]; scratch: 16 bytes, zero before the
// first launch, left zero by each (one launch at a time on a scratch).
int ngs_pileup_indels(const void* pos, const void* keep, const void* mapq,
                      const void* cigar_off, const void* cigar, const void* seq_off, int n,
                      const void* loci, int n_loci, const void* table, int n_refs, int lo_cut,
                      int hi_cut, int min_mapq, int window, void* out, long long capacity,
                      void* scratch, void* stream) {
    if (n < 0 || n_loci < 0 || n_refs < 0 || window < 0 || capacity < 0 || lo_cut < 0 ||
        lo_cut > hi_cut || hi_cut > n_loci || scratch == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0 || n_loci == 0 || n_refs == 0) return static_cast<int>(cudaSuccess);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool stage_table = n_refs <= kStagedRefs;
    const bool stage_loci = hi_cut - lo_cut <= kStagedLoci;
    const size_t shared =
        sizeof(int) * ((stage_table ? 2 * n_refs : 0) + (stage_loci ? hi_cut - lo_cut : 0));
    auto* count = static_cast<unsigned long long*>(scratch);
    auto* done = reinterpret_cast<unsigned*>(count + 1);
    auto kernel = stage_table ? (stage_loci ? pileup_indels_kernel<true, true>
                                            : pileup_indels_kernel<true, false>)
                              : (stage_loci ? pileup_indels_kernel<false, true>
                                            : pileup_indels_kernel<false, false>);
    kernel<<<grid_for(n), kThreads, shared, s>>>(
        static_cast<const int*>(pos), static_cast<const int*>(keep),
        static_cast<const unsigned char*>(mapq), static_cast<const long long*>(cigar_off),
        static_cast<const unsigned*>(cigar), static_cast<const long long*>(seq_off), n,
        static_cast<const int*>(loci), static_cast<const int*>(table), n_refs, lo_cut, hi_cut,
        min_mapq, window, count, done, static_cast<long long*>(out), capacity);
    return static_cast<int>(cudaGetLastError());
}

// B1's region form: records [0, n); regions int32 [2, n_regions]; table
// int32 [3, n_refs]; [lo_cut, hi_cut) within [0, n_regions]: the regions the
// records can reach; counters int32 [3, n_regions]; out int64 [1 + 5 *
// capacity]; scratch: 16 bytes, zero before the first launch, left zero by
// each (one launch at a time on a scratch).
int ngs_pileup_regions(const void* pos, const void* keep, const void* mapq,
                       const void* cigar_off, const void* cigar, int n, const void* regions,
                       int n_regions, const void* table, int n_refs, int lo_cut, int hi_cut,
                       void* counters, void* out, long long capacity, void* scratch,
                       void* stream) {
    if (n < 0 || n_regions < 0 || n_refs < 0 || capacity < 0 || lo_cut < 0 || lo_cut > hi_cut ||
        hi_cut > n_regions || scratch == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0 || lo_cut == hi_cut || n_refs == 0) return static_cast<int>(cudaSuccess);
    auto* count = static_cast<unsigned long long*>(scratch);
    const int* reg = static_cast<const int*>(regions);
    int* cnt = static_cast<int*>(counters);
    pileup_regions_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(pos), static_cast<const int*>(keep),
        static_cast<const unsigned char*>(mapq), static_cast<const long long*>(cigar_off),
        static_cast<const unsigned*>(cigar), n, reg, reg + n_regions,
        static_cast<const int*>(table), n_refs, lo_cut, hi_cut, cnt, cnt + n_regions,
        cnt + 2LL * n_regions, count, static_cast<long long*>(out), capacity);
    return static_cast<int>(cudaGetLastError());
}

// The hits of the indel or region form on their way to the host: out's first
// words int64 (the count, then the hits) copied into host (pinned memory),
// then event recorded, both queued on the caller's stream after the launch.
int ngs_copy_hits(const void* out, void* host, long long words, void* event, void* stream) {
    if (words < 1 || out == nullptr || host == nullptr || event == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t copied = cudaMemcpyAsync(host, out, sizeof(long long) * words,
                                               cudaMemcpyDeviceToHost, s);
    if (copied != cudaSuccess) return static_cast<int>(copied);
    return static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(event), s));
}

// For the tests: the device operations a launcher queues. ngs_capture_begin
// starts capturing the caller's stream (not the legacy default stream) into a
// graph; ngs_capture_end ends the capture, writes the graph's number of nodes
// to nodes (int64) and destroys the graph. Nothing captured runs.
int ngs_capture_begin(void* stream) {
    return static_cast<int>(cudaStreamBeginCapture(static_cast<cudaStream_t>(stream),
                                                   cudaStreamCaptureModeThreadLocal));
}

int ngs_capture_end(void* stream, void* nodes) {
    cudaGraph_t graph = nullptr;
    cudaError_t err = cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &graph);
    if (err != cudaSuccess) return static_cast<int>(err);
    size_t count = 0;
    err = cudaGraphGetNodes(graph, nullptr, &count);
    cudaGraphDestroy(graph);
    *static_cast<long long*>(nodes) = static_cast<long long>(count);
    return static_cast<int>(err);
}

}  // extern "C"
