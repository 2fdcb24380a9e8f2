// The contamination pileup's record form for Hopper (sm_90a): the device side
// of `pileup_add_records_into` in ngsbits_tpu_torch/ops/device_reduce.py, one
// launch on the caller's stream a BAM batch.
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
// The launcher takes raw pointers, sizes and the stream, and returns
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
constexpr unsigned kDeletion = 2u;

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

}  // extern "C"
