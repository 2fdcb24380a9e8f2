// SeqPurge's per-pair decisions for Hopper (sm_90a): from the three scans'
// counts (csrc/seqpurge.cu) to each pair's insert offset and trimmed
// lengths, error correction in place, and the batch's statistics.
//
//   seqpurge_decide  replaces the host decisions of the JAX package,
//                    ngsbits_tpu/qc/seqpurge.py:267-382 (numpy) and
//                    ngsbits_tpu/native/seqpurge.cpp:116-339 (C++): the
//                    insert match, -ec, the adapter match of pairs without
//                    an insert, trimQuality, trimN and the statistics.
//
// One warp owns one pair at a time; its lanes stride over offsets and
// positions. Per pair, in the reference's order:
//   1. insert: offsets 1 <= o < min(len1, len2) that pass the ratio test
//      100*m/tot >= match_perc (float64), the binomial tail
//      table[tot][m] <= mep and the adapter evidence (at most maxmm
//      mismatches on one read for o < 10, p1*p2 <= mep from o = 10 on);
//      the smallest p wins, the smallest offset among equal p (a (p, o)
//      warp min-reduction), as numpy's argmin and the C++'s strict `<`;
//   2. with -ec, insert pairs: the overlap's mismatches go to the base of
//      higher quality, in place; each lane reads only the two positions it
//      may write, so the lanes need no ordering among themselves;
//   3. pairs without an insert: the first offset of each read whose
//      adapter-prefix counts pass the same two tests (a ballot per 32
//      offsets), each read's offset standing in for the other's if missing;
//   4. trimQuality (the last window from the 3' end whose quality sum
//      reaches qcut * qwin, then trailing bases below qcut) and trimN (the
//      first run of ncut Ns), each by ballots over 32 positions;
//   5. statistics: int counters in shared memory, added into the int64
//      accumulators once per block (exact in any order).
//
// Float64 is IEEE here as on the host: the ratio and the product of the two
// evidence p-values use __dmul_rn/__ddiv_rn, so no contraction into an FMA
// can change a decision. The table is the host's, looked up, never
// recomputed.
//
// It is bound by bytes: per pair it reads the insert counts (K2's, int16)
// up to the overlap, the adapter counts of pairs without an insert up to
// their first hit, and the bases and qualities the trims look at, each
// once; its operations are a few per byte. A warp per pair keeps every read of a
// count array coalesced along the offset axis.
//
// Bytes past a read's length are never read. The launcher returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kMaxLen = 1000;   // statistics histograms, as the host's
constexpr int kWarps = 8;       // warps (pairs in flight) per block
constexpr unsigned kFull = 0xffffffffu;

// accumulator layout, as ops/seqpurge.py::ACC_FIELDS
constexpr int kTrimmedInsert = 0;
constexpr int kTrimmedAdapter = 1;
constexpr int kTrimmedQ = 2;
constexpr int kTrimmedN = 3;
constexpr int kBasesRemaining = 4;
constexpr int kAcons1 = kBasesRemaining + kMaxLen;
constexpr int kAcons2 = kAcons1 + 40 * 5;
constexpr int kMismatchR1 = kAcons2 + 40 * 5;
constexpr int kMismatchR2 = kMismatchR1 + kMaxLen;
constexpr int kErrorsPerRead = kMismatchR2 + kMaxLen;
constexpr int kAccSize = kErrorsPerRead + kMaxLen;

struct Params {
    double match_perc, mep;
    int qcut, qwin, qoff, ncut, ec;
};

__device__ __forceinline__ uint8_t complement(uint8_t c) {
    switch (c) {
        case 'A': return 'T';
        case 'C': return 'G';
        case 'G': return 'C';
        case 'T': return 'A';
        default: return c;  // 'N' and any other byte map to themselves
    }
}

__device__ __forceinline__ int base_index(uint8_t c) {
    switch (c) {
        case 'A': return 0;
        case 'C': return 1;
        case 'G': return 2;
        case 'T': return 3;
        case 'N': return 4;
        default: return -1;
    }
}

// 100.0 * m / tot < match_perc, rounded as the host rounds it
__device__ __forceinline__ bool below_ratio(int m, int tot, double match_perc) {
    return __ddiv_rn(__dmul_rn(100.0, static_cast<double>(m)),
                     static_cast<double>(tot)) < match_perc;
}

// first offset o < len whose adapter-prefix counts pass both tests, or -1
__device__ int first_hit(const int* __restrict__ am, const int* __restrict__ amm,
                         int len, const double* __restrict__ table, int T,
                         const Params& p, int lane) {
    for (int base = 0; base < len; base += 32) {
        const int o = base + lane;
        bool hit = false;
        if (o < len) {
            const int m = am[o];
            const int t = m + amm[o];
            // t == 0 passes the ratio test (the host's ratio is NaN there)
            if (!(t > 0 && below_ratio(m, t, p.match_perc)))
                hit = table[static_cast<long long>(t) * T + m] <= p.mep;
        }
        const unsigned bits = __ballot_sync(kFull, hit);
        if (bits) return base + __ffs(bits) - 1;
    }
    return -1;
}

// trimQuality (FastqFileStream.cpp:52-87 as the SeqPurge goldens pin it)
__device__ int trim_quality(const uint8_t* __restrict__ qual, int count,
                            const Params& p, int lane) {
    if (count < p.qwin) return count;
    const int need = p.qcut * p.qwin;
    // the largest window start i in [0, count - qwin] whose sum reaches need
    int start = -1;
    for (int hi = count - p.qwin; hi >= 0 && start < 0; hi -= 32) {
        const int i = hi - lane;
        bool ok = false;
        if (i >= 0) {
            int sum = 0;
            for (int k = 0; k < p.qwin; ++k) sum += static_cast<int>(qual[i + k]) - p.qoff;
            ok = sum >= need;
        }
        const unsigned bits = __ballot_sync(kFull, ok);
        if (bits) start = hi - (__ffs(bits) - 1);
    }
    if (start < 0) return 0;
    // then strip trailing bases below the cutoff
    for (int hi = start + p.qwin - 1; hi >= 0; hi -= 32) {
        const int i = hi - lane;
        const bool ok = i >= 0 && static_cast<int>(qual[i]) - p.qoff >= p.qcut;
        const unsigned bits = __ballot_sync(kFull, ok);
        if (bits) return hi - (__ffs(bits) - 1) + 1;
    }
    return 0;
}

// trimN (FastqFileStream.cpp:89-115): the first run of ncut Ns cuts the read
// at the run's start
__device__ int trim_n(const uint8_t* __restrict__ bases, int count, int ncut,
                      int lane) {
    if (count < ncut) return count;
    int carry = 0;  // Ns in a row ending just before this chunk
    for (int base = 0; base < count; base += 32) {
        const int j = base + lane;
        const unsigned ns = __ballot_sync(kFull, j < count && bases[j] == 'N');
        // length of the run of Ns ending at this lane
        const unsigned upto = lane == 31 ? kFull : (2u << lane) - 1u;
        const unsigned gaps = ~ns & upto;
        const int run = gaps ? lane - (31 - __clz(gaps))
                             : lane + 1 + carry;
        const unsigned hits = __ballot_sync(kFull, ((ns >> lane) & 1u) && run >= ncut);
        if (hits) return base + __ffs(hits) - 1 - ncut + 1;
        carry = ns == kFull ? carry + 32 : __clz(~ns);
    }
    return count;
}

__global__ void __launch_bounds__(kWarps * 32) seqpurge_decide_kernel(
        const int* __restrict__ scans, const int16_t* __restrict__ ins,
        uint8_t* bases, uint8_t* quals, const int* __restrict__ lens, const double* __restrict__ table, int T,
        int B, int L, Params p, int* __restrict__ out,
        unsigned long long* __restrict__ acc) {
    __shared__ int s_acc[kAccSize];
    for (int i = threadIdx.x; i < kAccSize; i += blockDim.x) s_acc[i] = 0;
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const long long BL = static_cast<long long>(B) * L;
    for (int b = blockIdx.x * kWarps + (threadIdx.x >> 5); b < B;
         b += gridDim.x * kWarps) {
        const long long row = static_cast<long long>(b) * L;
        const int16_t* m_ins = ins + row;
        const int16_t* mm_ins = ins + BL + row;
        const int* m1 = scans + row;
        const int* mm1 = scans + BL + row;
        const int* m2 = scans + 2 * BL + row;
        const int* mm2 = scans + 3 * BL + row;
        uint8_t* s1 = bases + row;
        uint8_t* s2 = bases + BL + row;
        uint8_t* q1 = quals + row;
        uint8_t* q2 = quals + BL + row;
        const int l1 = min(max(lens[b], 0), L);
        const int l2 = min(max(lens[B + b], 0), L);
        const int ml = min(l1, l2);

        // ---- 1. insert match (AnalysisWorker.cpp:141-266) ----
        double best_p = HUGE_VAL;
        int best_o = 0x7fffffff;
        for (int o = 1 + lane; o < ml; o += 32) {
            const int m = m_ins[o];
            const int tot = m + mm_ins[o];
            if (tot == 0 || below_ratio(m, tot, p.match_perc)) continue;
            const double pv = table[static_cast<long long>(tot) * T + m];
            if (!(pv <= p.mep)) continue;
            bool ok;
            if (o < 10) {
                const int maxmm = o < 3 ? 0 : (o < 6 ? 1 : 2);
                ok = mm1[o] <= maxmm || mm2[o] <= maxmm;
            } else {
                const int a = m1[o], c = m2[o];
                const double p1 = table[static_cast<long long>(a + mm1[o]) * T + a];
                const double p2 = table[static_cast<long long>(c + mm2[o]) * T + c];
                ok = __dmul_rn(p1, p2) <= p.mep;
            }
            if (ok && pv < best_p) {  // offsets rise along a lane: the first wins
                best_p = pv;
                best_o = o;
            }
        }
        for (int s = 16; s > 0; s >>= 1) {
            const double op = __shfl_xor_sync(kFull, best_p, s);
            const int oo = __shfl_xor_sync(kFull, best_o, s);
            if (op < best_p || (op == best_p && oo < best_o)) {
                best_p = op;
                best_o = oo;
            }
        }
        const int best = best_o == 0x7fffffff ? -1 : best_o;

        int new1 = l1, new2 = l2;
        if (best >= 0) {
            const int nl = l2 - best;
            new1 = min(l1, nl);
            new2 = min(l2, nl);
            if (lane == 0) atomicAdd(&s_acc[kTrimmedInsert], 2);
            // consensus adapter pileups (AnalysisWorker.cpp:278-290)
            for (int w = lane; w < 40; w += 32) {
                const int pos = nl + w;
                if (pos < l1) {
                    const int bi = base_index(s1[pos]);
                    if (bi >= 0) atomicAdd(&s_acc[kAcons1 + w * 5 + bi], 1);
                }
                if (pos < l2) {
                    const int bi = base_index(s2[pos]);
                    if (bi >= 0) atomicAdd(&s_acc[kAcons2 + w * 5 + bi], 1);
                }
            }
            // ---- 2. error correction (AnalysisWorker.cpp:19-77) ----
            if (p.ec) {
                const int count = min(new1, new2);
                int mismatches = 0;
                for (int pos = lane; pos < count; pos += 32) {
                    const int i2 = count - 1 - pos;
                    const uint8_t b1v = s1[pos], b2v = s2[i2];
                    if (b1v == complement(b2v)) continue;
                    ++mismatches;
                    const uint8_t q1v = q1[pos], q2v = q2[i2];
                    if (q1v > q2v) {         // read 2's base loses
                        s2[i2] = complement(b1v);
                        q2[i2] = q1v;
                        atomicAdd(&s_acc[kMismatchR2 + i2], 1);
                    } else if (q1v < q2v) {  // read 1's base loses
                        s1[pos] = complement(b2v);
                        q1[pos] = q2v;
                        atomicAdd(&s_acc[kMismatchR1 + pos], 1);
                    }
                }
                for (int s = 16; s > 0; s >>= 1)
                    mismatches += __shfl_xor_sync(kFull, mismatches, s);
                if (lane == 0 && mismatches > 0 && mismatches < kMaxLen)
                    atomicAdd(&s_acc[kErrorsPerRead + mismatches], 1);
                __syncwarp();  // the trims read what the lanes wrote
            }
        } else {
            // ---- 3. adapter match (AnalysisWorker.cpp:304-427) ----
            const int off_f = first_hit(scans + 4 * BL + row, scans + 5 * BL + row,
                                        l1, table, T, p, lane);
            const int off_r = first_hit(scans + 6 * BL + row, scans + 7 * BL + row,
                                        l2, table, T, p, lane);
            if (off_f != -1 || off_r != -1) {
                new1 = min(new1, off_f != -1 ? off_f : off_r);
                new2 = min(new2, off_r != -1 ? off_r : off_f);
                if (lane == 0) atomicAdd(&s_acc[kTrimmedAdapter], 2);
            }
        }

        // ---- 4. quality, then N trimming ----
        int trimmed_q = 0, trimmed_n = 0;
        if (p.qcut > 0) {
            const int t1 = trim_quality(q1, new1, p, lane);
            const int t2 = trim_quality(q2, new2, p, lane);
            trimmed_q = (t1 < new1) + (t2 < new2);
            new1 = t1;
            new2 = t2;
        }
        if (p.ncut > 0) {
            const int t1 = trim_n(s1, new1, p.ncut, lane);
            const int t2 = trim_n(s2, new2, p.ncut, lane);
            trimmed_n = (t1 < new1) + (t2 < new2);
            new1 = t1;
            new2 = t2;
        }

        // ---- 5. per-pair results and statistics (OutputWorker.cpp:34-77) ----
        if (lane == 0) {
            out[b] = best;
            out[B + b] = new1;
            out[2 * B + b] = new2;
            if (trimmed_q) atomicAdd(&s_acc[kTrimmedQ], trimmed_q);
            if (trimmed_n) atomicAdd(&s_acc[kTrimmedN], trimmed_n);
            if (new1 < kMaxLen) atomicAdd(&s_acc[kBasesRemaining + new1], 1);
            if (new2 < kMaxLen) atomicAdd(&s_acc[kBasesRemaining + new2], 1);
        }
    }

    __syncthreads();
    for (int i = threadIdx.x; i < kAccSize; i += blockDim.x)
        if (s_acc[i]) atomicAdd(&acc[i], static_cast<unsigned long long>(s_acc[i]));
}

}  // namespace

extern "C" {

// scans: [8, B, L] int32 (evidence m1, mm1, m2, mm2; adapter prefix counts
// of read 1 and read 2); ins: [2, B, L] int16 (K2's insert m, mm); bases,
// quals: [2, B, L] uint8 (read 1 then read 2, corrected in place with ec);
// lens: [2, B] int32 in [0, L];
// table: [T, T] float64 with T >= L and T > the adapters' lengths;
// out: [3, B] int32 (insert offset or -1, new len1, new len2), written;
// acc: [acc_size] int64, added into. Returns 0 or the CUDA error.
int ngs_seqpurge_decide(const void* scans, const void* ins, void* bases, void* quals,
                        const void* lens, const void* table, int T, int B, int L,
                        double match_perc, double mep, int qcut, int qwin,
                        int qoff, int ncut, int ec, void* out, void* acc,
                        int acc_size, void* stream) {
    if (acc_size != kAccSize) return cudaErrorInvalidValue;
    if (B <= 0) return cudaSuccess;
    const Params p{match_perc, mep, qcut, qwin, qoff, ncut, ec};
    long long blocks = (static_cast<long long>(B) + kWarps - 1) / kWarps;
    const long long cap = 4LL * ngs::sm_count();  // each block flushes its counters once
    if (blocks > cap) blocks = cap;
    seqpurge_decide_kernel<<<static_cast<int>(blocks), kWarps * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(scans), static_cast<const int16_t*>(ins),
        static_cast<uint8_t*>(bases), static_cast<uint8_t*>(quals),
        static_cast<const int*>(lens),
        static_cast<const double*>(table), T, B, L, p, static_cast<int*>(out),
        static_cast<unsigned long long*>(acc));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
