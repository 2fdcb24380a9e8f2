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
// Per pair, in the reference's order, one warp's lanes striding over
// offsets and positions:
//   1. insert: offsets 1 <= o < min(len1, len2) that pass the ratio test
//      100*m/tot >= match_perc, the binomial tail table[tot][m] <= mep and
//      the adapter evidence (at most maxmm mismatches on one read for
//      o < 10, p1*p2 <= mep from o = 10 on); the smallest p wins, the
//      smallest offset among equal p (a (p, o) warp min-reduction), as
//      numpy's argmin and the C++'s strict `<`;
//   2. with -ec, insert pairs: the overlap's mismatches go to the base of
//      higher quality, in place; each lane reads only the two positions it
//      may write, so the lanes need no ordering among themselves;
//   3. pairs without an insert: the first offset of each read whose
//      adapter-prefix counts pass the same two tests (a ballot per 32
//      offsets), each read's offset standing in for the other's if missing;
//   4. trimQuality (the last window from the 3' end whose quality sum
//      reaches qcut * qwin, then trailing bases below qcut) and trimN (the
//      first run of ncut Ns), by ballots over 16 positions of each read or
//      32 of one; trimN first looks for an aligned word of four Ns, without
//      which no run of seven or more exists;
//   5. statistics: int counters in shared memory, added into the int64
//      accumulators once per block (exact in any order).
//
// What bounds it. The work is a few operations per byte, so the floor is
// the bytes its inputs need it to read (K2's int16 counts up to the
// overlap, the one-byte adapter counts of pairs without an insert, the
// bases of the final reads). Its first version (a warp per pair, every
// count, base and quality loaded from device memory in lock-step with the
// decisions, a float64 division and a table gather at every offset
// examined, 528 blocks each zeroing and flushing all 4,404 counters) was
// bound by latency: 15 to 30 dependent round trips to device memory a
// pair. This design, each part measured by scripts/scan_variants.py
// --kernel decide:
//   - Each warp decides its own pairs (a grid-stride loop) and first stages
//     each pair in shared memory: K2's two rows of counts, the four rows of
//     adapter-prefix counts, both mates' bases and qualities, each row as
//     one 1-D bulk copy (cp.async.bulk, lane j copying row j) of the
//     16-byte chunks that cover it (each chunk holds a byte of its row, so
//     none leaves the row's allocation; rows need no alignment), completing
//     on an mbarrier. The copies of the warp's next pair are in flight
//     while it decides this one (two buffers a warp), and so is the load of
//     its lengths. The staged path is compiled apart (a template), so its
//     rows are addressed as shared memory. The evidence counts (X4) are
//     read where they lie, only at the few offsets that pass the insert
//     test.
//   - The per-offset tests are integer. For a fixed total tot = m + mm the
//     two tests are monotone in m, so the wrapper builds once per table
//     and parameters the least passing m for each tot, from the same
//     float64 expressions, and checks the monotony
//     (ops/seqpurge.py::decide_thresholds). A lane tests m >= need[tot]
//     from shared memory: no division, no gather. The insert scan first
//     marks its passing offsets in a mask, then looks up only those. The
//     table is read only for values a decision needs: a candidate's p and
//     the product of the two evidence p-values (__dmul_rn: no contraction
//     into an FMA can change a decision), so every decision stays exact.
//   - The adapter match steps through both reads at once; in the trims
//     each half-warp takes one read, so one ballot serves both. The N trim
//     looks for an aligned word of four Ns, 16 bytes a lane, before it
//     looks for runs.
//   - A grid of kBlocksPerSM blocks an SM, all resident at once; without
//     -ec only the first 1,404 counters are zeroed and flushed.
//   - Rows too wide for the staging buffers (from 498 bases on) are read where
//     they lie in device memory, by the same code.
// What bounds it now: the decisions' chains of dependent steps (loads,
// ballots, shuffles) at 32 warps an SM, and the staging, whose chunks (about
// 20.6 MB at B=10000, L=151, twice the bytes the decisions need) every
// warp's first pair waits for; see PERF.md.
//
// Bytes past a read's length are copied with its row but decide nothing.
// With -ec the corrected bases and qualities are written both to the
// staged copy (the trims read them) and to device memory. The launcher
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kMaxLen = 1000;           // statistics histograms, as the host's
constexpr int kWarps = 8;               // warps a block, each deciding its own pairs
constexpr int kBlocksPerSM = 4;         // the grid's blocks an SM
constexpr int kStageLimit = 96 * 1024;  // staging bytes a block (two buffers a warp) at most
constexpr int kAdapterTot = 65;         // adapter counts add up to at most 64
constexpr int kSpans = 10;              // rows staged a pair
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

// The batch where it lies in device memory.
struct Batch {
    const uint8_t* scans;  // [8, B, L]: evidence m1, mm1, m2, mm2; prefix m, mm of read 1, read 2
    const int16_t* ins;    // [2, B, L]: K2's m, mm
    uint8_t* bases;        // [2, B, L]
    uint8_t* quals;        // [2, B, L]
    const int* lens;       // [2, B]
    int B, L;
};

// The per-offset tests: the least passing m for each total (shared memory)
// and the table (device memory).
struct Tests {
    const int* need_ins;  // [L]: a total of K2's counts is below L
    const int* need_ad;   // [kAdapterTot]
    const double* table;  // [T, T]
    int T;
};

// One pair's rows: staged in shared memory, or where they lie.
struct Rows {
    const int16_t *m_ins, *mm_ins;              // K2's counts
    const uint8_t *am1, *amm1, *am2, *amm2;     // adapter-prefix counts
    uint8_t *s1, *s2, *q1, *q2;                 // bases and qualities
    int l1, l2;
};

__host__ __device__ inline int slot_bytes(int bytes) { return (bytes + 30) / 16 * 16; }

// A pair's staging buffer: the 16-byte chunks that cover each span.
__host__ __device__ inline int stage_bytes(int L) {
    return 2 * slot_bytes(2 * L) + 8 * slot_bytes(L);
}

// Span j of the pair whose rows start at element `row`: K2's m, mm (int16);
// prefix m, mm of read 1, of read 2; bases of read 1, 2; qualities of read 1, 2.
__device__ __forceinline__ uintptr_t span_addr(const Batch& x, int j, long long row) {
    const long long BL = static_cast<long long>(x.B) * x.L;
    if (j < 2) return reinterpret_cast<uintptr_t>(x.ins + j * BL + row);
    if (j < 6) return reinterpret_cast<uintptr_t>(x.scans + (j + 2) * BL + row);
    if (j < 8) return reinterpret_cast<uintptr_t>(x.bases + (j - 6) * BL + row);
    return reinterpret_cast<uintptr_t>(x.quals + (j - 8) * BL + row);
}

__device__ __forceinline__ int span_slot(int j, int L) {
    return j < 2 ? j * slot_bytes(2 * L) : 2 * slot_bytes(2 * L) + (j - 2) * slot_bytes(L);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned phase) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(phase) : "memory");
    return done;
}

// One warp starts copying pair b's spans into buf, one 1-D bulk copy a span
// (lane j copies span j), completing on the mbarrier `bar`.
__device__ __forceinline__ void stage_pair(const Batch& x, int b, uint8_t* buf, unsigned bar,
                                           int lane) {
    const long long row = static_cast<long long>(b) * x.L;
    const uintptr_t a = span_addr(x, lane < kSpans ? lane : 0, row);
    const uintptr_t a0 = a & ~uintptr_t(15);
    const int span = lane < 2 ? 2 * x.L : x.L;
    const unsigned bytes = lane < kSpans && x.L ? (a + span - a0 + 15) & ~uintptr_t(15) : 0;
    const unsigned total = __reduce_add_sync(kFull, bytes);
    if (lane == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     ::"r"(bar), "r"(total) : "memory");
    __syncwarp();
    if (bytes)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n"
            ::"r"(smem_addr(buf + span_slot(lane, x.L))), "l"(a0), "r"(bytes), "r"(bar)
            : "memory");
}

// Pair b's rows (lengths l1, l2) in buf as stage_pair left them (STAGED:
// the compiler then addresses them as shared memory), or where they lie.
template <bool STAGED>
__device__ __forceinline__ Rows pair_rows(const Batch& x, int b, uint8_t* buf, int l1,
                                          int l2) {
    const long long row = static_cast<long long>(b) * x.L;
    uint8_t* p[kSpans];
#pragma unroll
    for (int j = 0; j < kSpans; ++j) {
        const uintptr_t a = span_addr(x, j, row);
        p[j] = STAGED ? buf + span_slot(j, x.L) + (static_cast<unsigned>(a) & 15)
                      : reinterpret_cast<uint8_t*>(a);
    }
    Rows r;
    r.m_ins = reinterpret_cast<const int16_t*>(p[0]);
    r.mm_ins = reinterpret_cast<const int16_t*>(p[1]);
    r.am1 = p[2];
    r.amm1 = p[3];
    r.am2 = p[4];
    r.amm2 = p[5];
    r.s1 = p[6];
    r.s2 = p[7];
    r.q1 = p[8];
    r.q2 = p[9];
    r.l1 = l1;
    r.l2 = l2;
    return r;
}

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

// The insert match's test at one offset (tot > 0, the ratio test and the
// tail), as m against the least passing m for tot.
__device__ __forceinline__ bool insert_passes(int m, int tot, const Tests& t) {
    return m >= t.need_ins[tot];
}

// The adapter match's (tot == 0 passes the ratio test).
__device__ __forceinline__ bool adapter_passes(int m, int tot, const Tests& t) {
    return m >= t.need_ad[tot];
}

// The first offset o < len of each read whose adapter-prefix counts pass,
// or -1; both reads in each step of 32 offsets.
__device__ __forceinline__ void first_hits(const Rows& r, int l1, int l2, const Tests& t,
                                           int lane, int& off_f, int& off_r) {
    off_f = off_r = -1;
    for (int base = 0; (off_f < 0 && base < l1) || (off_r < 0 && base < l2); base += 32) {
        const int o = base + lane;
        bool h1 = false, h2 = false;
        if (off_f < 0 && o < l1) {
            const int m = r.am1[o];
            h1 = adapter_passes(m, m + r.amm1[o], t);
        }
        if (off_r < 0 && o < l2) {
            const int m = r.am2[o];
            h2 = adapter_passes(m, m + r.amm2[o], t);
        }
        const unsigned b1 = __ballot_sync(kFull, h1), b2 = __ballot_sync(kFull, h2);
        if (b1) off_f = base + __ffs(b1) - 1;
        if (b2) off_r = base + __ffs(b2) - 1;
    }
}

// trimQuality (FastqFileStream.cpp:52-87 as the SeqPurge goldens pin it),
// half-warp h on read h, 16 positions a step: the last window of qwin bases
// from the 3' end whose quality sum reaches qcut * qwin, then trailing bases
// below qcut. Reads shorter than the window keep their length.
__device__ __forceinline__ void trim_quality(const uint8_t* q1, const uint8_t* q2, int& n1,
                                             int& n2, const Params& p, int lane) {
    const int h = lane >> 4, sub = lane & 15;
    const uint8_t* q = h ? q2 : q1;
    const int n = h ? n2 : n1;
    const int need = p.qwin * (p.qcut + p.qoff);  // on the quality bytes
    int hi = n - p.qwin;  // the window start this half's lane 0 tests
    int top = -1;         // then the position it tests
    int res = n < p.qwin ? n : 0;
    while (__any_sync(kFull, hi >= 0)) {
        const int i = hi - sub;
        bool ok = false;
        if (hi >= 0 && i >= 0) {
            int sum = 0;
#pragma unroll 4
            for (int j = 0; j < p.qwin; ++j) sum += q[i + j];
            ok = sum >= need;
        }
        const unsigned mine = (__ballot_sync(kFull, ok) >> (16 * h)) & 0xFFFFu;
        if (hi >= 0) {
            if (mine) {
                top = hi - (__ffs(mine) - 1) + p.qwin - 1;
                hi = -1;
            } else {
                hi -= 16;
            }
        }
    }
    const int cut = p.qcut + p.qoff;
    while (__any_sync(kFull, top >= 0)) {
        const int i = top - sub;
        const bool ok = top >= 0 && i >= 0 && q[i] >= cut;
        const unsigned mine = (__ballot_sync(kFull, ok) >> (16 * h)) & 0xFFFFu;
        if (top >= 0) {
            if (mine) {
                res = top - (__ffs(mine) - 1) + 1;
                top = -1;
            } else {
                top -= 16;
            }
        }
    }
    n1 = __shfl_sync(kFull, res, 0);
    n2 = __shfl_sync(kFull, res, 16);
}

// trimN (FastqFileStream.cpp:89-115) on one read: the first run of ncut Ns
// cuts the read at the run's start.
__device__ __forceinline__ int trim_n_run(const uint8_t* bases, int count, int ncut, int lane) {
    int carry = 0;  // Ns in a row ending just before this chunk
    for (int base = 0; base < count; base += 32) {
        const int j = base + lane;
        const unsigned ns = __ballot_sync(kFull, j < count && bases[j] == 'N');
        // length of the run of Ns ending at this lane
        const unsigned upto = lane == 31 ? kFull : (2u << lane) - 1u;
        const unsigned gaps = ~ns & upto;
        const int run = gaps ? lane - (31 - __clz(gaps)) : lane + 1 + carry;
        const unsigned hits = __ballot_sync(kFull, ((ns >> lane) & 1u) && run >= ncut);
        if (hits) return base + __ffs(hits) - 1 - ncut + 1;
        carry = ns == kFull ? carry + 32 : __clz(~ns);
    }
    return count;
}

// trimN on both reads. A run of 7 or more Ns holds an aligned word of four
// Ns, so for ncut >= 7 half-warp h first looks for one in read h, 16 bytes
// a lane (the 16-byte chunks that hold its bases); only a read with one
// takes the search for runs.
__device__ __forceinline__ void trim_n(const uint8_t* s1, const uint8_t* s2, int& n1, int& n2,
                                       int ncut, int lane) {
    bool look1 = n1 >= ncut, look2 = n2 >= ncut;
    if (ncut >= 7 && (look1 || look2)) {
        const int h = lane >> 4;
        const uint8_t* s = h ? s2 : s1;
        const int n = h ? (look2 ? n2 : 0) : (look1 ? n1 : 0);
        const int off = static_cast<int>(reinterpret_cast<uintptr_t>(s) & 15);
        const uint4* chunk = reinterpret_cast<const uint4*>(s - off);
        bool run = false;
        // chunk c holds bases 16c - off .. 16c - off + 15; word k of it from 16c - off + 4k
        for (int c = lane & 15; 16 * c - off < n; c += 16) {
            const uint4 v = chunk[c];
            const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int first = 16 * c - off + 4 * k;
                run |= w[k] == 0x4E4E4E4Eu && first >= 0 && first + 3 < n;
            }
        }
        const unsigned runs = __ballot_sync(kFull, run);
        look1 = look1 && (runs & 0xFFFFu);
        look2 = look2 && (runs >> 16);
    }
    if (look1) n1 = trim_n_run(s1, n1, ncut, lane);
    if (look2) n2 = trim_n_run(s2, n2, ncut, lane);
}

// One warp decides pair b from its rows r.
__device__ __forceinline__ void decide_pair(const Batch& x, int b, const Rows& r, const Tests& t,
                            const Params& p, int lane, int* s_acc, int* __restrict__ out) {
    const long long BL = static_cast<long long>(x.B) * x.L;
    const long long row = static_cast<long long>(b) * x.L;
    const uint8_t* m1 = x.scans + row;  // the evidence counts, where they lie
    const uint8_t* mm1 = m1 + BL;
    const uint8_t* m2 = m1 + 2 * BL;
    const uint8_t* mm2 = m1 + 3 * BL;
    const double* table = t.table;
    const long long T = t.T;
    const int l1 = min(max(r.l1, 0), x.L);
    const int l2 = min(max(r.l2, 0), x.L);
    const int ml = min(l1, l2);

    // ---- 1. insert match (AnalysisWorker.cpp:141-266) ----
    double best_p = HUGE_VAL;
    int best_o = 0x7fffffff;
    for (int o0 = 1; o0 < ml; o0 += 32 * 32) {
        unsigned pass = 0;  // bit k: offset o0 + 32 k + lane passes the insert test
#pragma unroll 4
        for (int k = 0; k < 32; ++k) {
            const int o = o0 + 32 * k + lane;
            if (o0 + 32 * k >= ml) break;
            if (o < ml) {
                const int m = r.m_ins[o];
                if (insert_passes(m, m + r.mm_ins[o], t)) pass |= 1u << k;
            }
        }
        for (; pass; pass &= pass - 1) {  // the candidates, offsets rising along a lane
            const int o = o0 + 32 * (__ffs(pass) - 1) + lane;
            const int m = r.m_ins[o];
            const double pv = table[(m + r.mm_ins[o]) * T + m];
            bool ok;
            if (o < 10) {
                const int maxmm = o < 3 ? 0 : (o < 6 ? 1 : 2);
                ok = mm1[o] <= maxmm || mm2[o] <= maxmm;
            } else {
                const int a = m1[o], c = m2[o];
                const double p1 = table[(a + mm1[o]) * T + a];
                const double p2 = table[(c + mm2[o]) * T + c];
                ok = __dmul_rn(p1, p2) <= p.mep;
            }
            if (ok && pv < best_p) {  // the first of equal p along a lane wins
                best_p = pv;
                best_o = o;
            }
        }
    }
    // lanes with a candidate: none, one (its offset), or a (p, o) min-reduction
    const unsigned cand = __ballot_sync(kFull, best_o != 0x7fffffff);
    int best = -1;
    if (cand & (cand - 1)) {
        for (int s = 16; s > 0; s >>= 1) {
            const double op = __shfl_xor_sync(kFull, best_p, s);
            const int oo = __shfl_xor_sync(kFull, best_o, s);
            if (op < best_p || (op == best_p && oo < best_o)) {
                best_p = op;
                best_o = oo;
            }
        }
        best = best_o;
    } else if (cand) {
        best = __shfl_sync(kFull, best_o, __ffs(cand) - 1);
    }

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
                const int bi = base_index(r.s1[pos]);
                if (bi >= 0) atomicAdd(&s_acc[kAcons1 + w * 5 + bi], 1);
            }
            if (pos < l2) {
                const int bi = base_index(r.s2[pos]);
                if (bi >= 0) atomicAdd(&s_acc[kAcons2 + w * 5 + bi], 1);
            }
        }
        // ---- 2. error correction (AnalysisWorker.cpp:19-77) ----
        if (p.ec) {
            uint8_t* g1 = x.bases + row;  // the corrected reads go back here too
            uint8_t* g2 = g1 + BL;
            uint8_t* gq1 = x.quals + row;
            uint8_t* gq2 = gq1 + BL;
            const int count = min(new1, new2);
            int mismatches = 0;
            for (int pos = lane; pos < count; pos += 32) {
                const int i2 = count - 1 - pos;
                const uint8_t b1v = r.s1[pos], b2v = r.s2[i2];
                if (b1v == complement(b2v)) continue;
                ++mismatches;
                const uint8_t q1v = r.q1[pos], q2v = r.q2[i2];
                if (q1v > q2v) {         // read 2's base loses
                    r.s2[i2] = g2[i2] = complement(b1v);
                    r.q2[i2] = gq2[i2] = q1v;
                    atomicAdd(&s_acc[kMismatchR2 + i2], 1);
                } else if (q1v < q2v) {  // read 1's base loses
                    r.s1[pos] = g1[pos] = complement(b2v);
                    r.q1[pos] = gq1[pos] = q2v;
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
        int off_f, off_r;
        first_hits(r, l1, l2, t, lane, off_f, off_r);
        if (off_f != -1 || off_r != -1) {
            new1 = min(new1, off_f != -1 ? off_f : off_r);
            new2 = min(new2, off_r != -1 ? off_r : off_f);
            if (lane == 0) atomicAdd(&s_acc[kTrimmedAdapter], 2);
        }
    }

    // ---- 4. quality, then N trimming ----
    int trimmed_q = 0, trimmed_n = 0;
    if (p.qcut > 0) {
        int t1 = new1, t2 = new2;
        trim_quality(r.q1, r.q2, t1, t2, p, lane);
        trimmed_q = (t1 < new1) + (t2 < new2);
        new1 = t1;
        new2 = t2;
    }
    if (p.ncut > 0) {
        int t1 = new1, t2 = new2;
        trim_n(r.s1, r.s2, t1, t2, p.ncut, lane);
        trimmed_n = (t1 < new1) + (t2 < new2);
        new1 = t1;
        new2 = t2;
    }

    // ---- 5. per-pair results and statistics (OutputWorker.cpp:34-77) ----
    if (lane == 0) {
        out[b] = best;
        out[x.B + b] = new1;
        out[2 * x.B + b] = new2;
        if (trimmed_q) atomicAdd(&s_acc[kTrimmedQ], trimmed_q);
        if (trimmed_n) atomicAdd(&s_acc[kTrimmedN], trimmed_n);
        if (new1 < kMaxLen) atomicAdd(&s_acc[kBasesRemaining + new1], 1);
        if (new2 < kMaxLen) atomicAdd(&s_acc[kBasesRemaining + new2], 1);
    }
}

// One warp's pairs b, b + stride, ...: staged (the copies of the next pair
// in flight while one is decided; the first pair's started by the caller)
// or read where they lie. l1, l2: pair b's lengths.
template <bool STAGED>
__device__ __forceinline__ void decide_pairs(const Batch& x, int b, int stride, int l1, int l2,
                                             uint8_t* buf, uint8_t* next, unsigned bar,
                                             const Tests& t, const Params& p, int lane,
                                             int* s_acc, int* __restrict__ out) {
    unsigned bar_next = bar + 8, phase = 0, phase_next = 0;
    for (; b < x.B; b += stride) {
        const int nb = b + stride;
        int n1 = 0, n2 = 0;
        if (nb < x.B) {
            n1 = x.lens[nb];
            n2 = x.lens[x.B + nb];
            if (STAGED) {
                // the last decisions' reads and writes of `next` come before the copy's
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                __syncwarp();
                stage_pair(x, nb, next, bar_next, lane);
            }
        }
        if (STAGED) {
            while (!mbar_try_wait(bar, phase)) {
            }
            phase ^= 1;
        }
        decide_pair(x, b, pair_rows<STAGED>(x, b, buf, l1, l2), t, p, lane, s_acc, out);
        __syncwarp();  // buf is free for the pair after next
        uint8_t* const done = buf;
        buf = next;
        next = done;
        const unsigned bar_done = bar, phase_done = phase;
        bar = bar_next;
        bar_next = bar_done;
        phase = phase_next;
        phase_next = phase_done;
        l1 = n1;
        l2 = n2;
    }
}

// Shared memory: two staging buffers a warp (`stage` bytes each; 0 when the
// rows are read where they lie), the counters, then the thresholds.
__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSM) seqpurge_decide_kernel(
        Batch x, const int* __restrict__ need, const double* __restrict__ table, int T,
        Params p, int stage, int* __restrict__ out, unsigned long long* __restrict__ acc) {
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ unsigned long long s_bar[2 * kWarps];  // a warp's two buffers' barriers
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int* s_acc = reinterpret_cast<int*>(smem + 2 * kWarps * stage);
    int* s_need = s_acc + kAccSize;  // [L] insert thresholds, [kAdapterTot] adapter ones
    uint8_t* buf = smem + 2 * warp * stage;
    const unsigned bar = smem_addr(&s_bar[2 * warp]);
    const int stride = gridDim.x * kWarps;
    const int b = blockIdx.x * kWarps + warp;
    int l1 = 0, l2 = 0;
    if (stage && lane == 0) {
        mbar_init(bar);
        mbar_init(bar + 8);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    if (b < x.B) {
        l1 = x.lens[b];
        l2 = x.lens[x.B + b];
        if (stage) stage_pair(x, b, buf, bar, lane);
    }
    const int used = p.ec ? kAccSize : kMismatchR1;  // the -ec histograms stay 0 without -ec
    for (int i = threadIdx.x; i < used; i += blockDim.x) s_acc[i] = 0;
    for (int i = threadIdx.x; i < x.L + kAdapterTot; i += blockDim.x)
        s_need[i] = i < x.L ? need[i] : need[T + i - x.L];
    __syncthreads();
    const Tests t{s_need, s_need + x.L, table, T};
    if (stage)
        decide_pairs<true>(x, b, stride, l1, l2, buf, buf + stage, bar, t, p, lane, s_acc, out);
    else
        decide_pairs<false>(x, b, stride, l1, l2, nullptr, nullptr, 0, t, p, lane, s_acc, out);

    __syncthreads();
    for (int i = threadIdx.x; i < used; i += blockDim.x)
        if (s_acc[i]) atomicAdd(&acc[i], static_cast<unsigned long long>(s_acc[i]));
}

}  // namespace

extern "C" {

// scans: [8, B, L] uint8 (evidence m1, mm1, m2, mm2; adapter prefix counts
// of read 1 and read 2); ins: [2, B, L] int16 (K2's insert m, mm); bases,
// quals: [2, B, L] uint8 (read 1 then read 2, corrected in place with ec);
// lens: [2, B] int32 in [0, L]; need: [2, T] int32, the least passing m
// for each total (ops/seqpurge.py::decide_thresholds: the insert test's,
// then the adapter test's); table: [T, T] float64 with T >= L and T > 64;
// the counts as the scans write them (a total of K2's below L, of the
// adapter scans' at most 64);
// out: [3, B] int32 (insert offset or -1, new len1, new len2), written;
// acc: [acc_size] int64, added into. Returns 0 or the CUDA error.
int ngs_seqpurge_decide(const void* scans, const void* ins, void* bases, void* quals,
                        const void* lens, const void* need, const void* table, int T, int B,
                        int L, double match_perc, double mep, int qcut, int qwin, int qoff,
                        int ncut, int ec, void* out, void* acc, int acc_size, void* stream) {
    if (acc_size != kAccSize) return cudaErrorInvalidValue;
    if (B <= 0) return cudaSuccess;
    const Params p{match_perc, mep, qcut, qwin, qoff, ncut, ec};
    const int per = stage_bytes(L);
    const int stage = 2 * kWarps * per <= kStageLimit ? per : 0;  // else rows stay where they lie
    const size_t smem = 2 * static_cast<size_t>(kWarps) * stage +
                        4 * static_cast<size_t>(kAccSize + L + kAdapterTot);
    static size_t allowed = 48 * 1024;  // dynamic shared memory the kernel may take
    if (smem > allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            seqpurge_decide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        allowed = smem;
    }
    long long blocks = (static_cast<long long>(B) + kWarps - 1) / kWarps;
    const long long cap = static_cast<long long>(kBlocksPerSM) * ngs::sm_count();
    if (blocks > cap) blocks = cap;
    const Batch x{static_cast<const uint8_t*>(scans), static_cast<const int16_t*>(ins),
                  static_cast<uint8_t*>(bases), static_cast<uint8_t*>(quals),
                  static_cast<const int*>(lens), B, L};
    seqpurge_decide_kernel<<<static_cast<int>(blocks), kWarps * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        x, static_cast<const int*>(need), static_cast<const double*>(table), T, p, stage,
        static_cast<int*>(out), static_cast<unsigned long long*>(acc));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
