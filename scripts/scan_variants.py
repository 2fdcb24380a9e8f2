#!/usr/bin/env python3
"""SeqPurge's kernels beside variants of themselves, timed on the card: the
adapter scans (``adapter_evidence``, ``adapter_scan``), K2
(``insert_scan``) or D, the decisions (``seqpurge_decide``).

    python3 scripts/scan_variants.py [--kernel adapters|insert|decide] [--parent DIR]

Builds variants of ``ngsbits_tpu_torch/csrc/seqpurge.cu`` (the scans) or
``csrc/seqpurge_decide.cu`` (D) under build/scan_variants/ (one nvcc per
variant, all at once), each a copy of the source with checked text
substitutions, and times the kernels at the main path's batch: B=10000
pairs, L=151; for the scans the pairs of ``ops/selfcheck.py::pairs``, the
TruSeq adapters, a window of 10 bases (evidence) and a prefix of 20 (scan);
for D ``selfcheck.decide_case`` (a library with adapters, its scans'
counts and qualities), without and with -ec.

``--kernel adapters`` (the default). Design variants (outputs held equal to
the plain version first):

  as built       the source unchanged
  no prefix      adapter_scan tests every window word for 'N' (as built
                 at the main path's sizes: the positions that count from
                 two prefix counts of the staged row; adapter_evidence
                 does not use them, so it is as built here)
  run-time words the kernels for other windows: a run-time word count and,
                 for adapter_scan, no prefix counts (as built: the
                 template's 3 and 5 words)
  4 per thread   a thread owns four consecutive items and writes 4-byte
                 stores of four one-byte counts (tiles of a multiple of
                 four rows, so every tile's outputs start 4-byte aligned)
  8 blocks/SM    __launch_bounds__ for 8 blocks of 256 threads (32
                 registers; as built: 4 blocks, up to 64)
  2 blocks/SM, 4 blocks/SM   grids of at most 2 or 4 blocks per SM, so a
                 block counts several tiles and copies the next tile's rows
                 while it counts one (as built: 8, about one tile each at
                 the main path's batch)
  tiles of 512, tiles of 8192   (row, offset) items a tile aims at (as
                 built: 2048)

Ablations, which leave out part of the work to show what it costs (their
outputs are wrong and not checked):

  no compares    staging and stores, no compares
  no stores      staging and compares, no output written
  stores only    no staging of rows and no compares (the tiles' copies
                 remain): the same grid writes the outputs
  empty          every block returns at once: launch and scheduling alone

``--kernel insert``: K2 with int16 outputs. Design variants:

  as built       the source unchanged
  int32 stores   int32 outputs (as built: int16)
  no fold        a unit takes one group pair, no mirror (as built: group
                 pairs u and P - 1 - u, the folded triangle)
  exact only     every pair takes the compare that is exact for bytes with
                 bit 7 set (as built: pairs without such bytes take one
                 operation less per word)
  unroll 2       the word loop unrolled twice
  masked counts  the counted positions as __dp4a of the ANDed flags (as
                 built: __dp4a of the two flag words, no AND)
  64 threads, 256 threads   threads of a block, one unit each per tile
                 (as built: 128)
  grid 16/SM     grids of at most 16 blocks per SM (as built: 8)

and the ablations no compares, stores only and empty, as above (stores
only keeps the tiles' copies and the zeros past short overlaps), and:

  no stores      the counts land in shared memory, none is written out
  no counted     no __dp4a of the flag words (the counted positions)
  m by xor       a logic operation in place of the matches' __dp4a
  adds for dp4a  an addition in place of each __dp4a

``--kernel decide``: D. Design variants (outputs, accumulators and
corrected reads held equal to the plain version first):

  as built          the source unchanged
  float64 tests     the per-offset ratio test and table lookup at every
                    offset examined (as built: m against the least passing
                    m for its total, from shared memory)
  unstaged          every row read where it lies in device memory (as
                    built: each pair's rows staged by cp.async, the next
                    pair's copies in flight while one is decided)
  adapters unstaged the adapter-prefix counts read where they lie, only
                    for pairs without an insert (as built: staged with the
                    rest)
  no prefetch       each pair's copies waited for as soon as they are
                    issued (as built: the next pair's overlap this one)
  grid 2/SM, grid 3/SM   blocks an SM (as built: 4, the first version's
                    cap, now resident at once)
  16 warps          warps a block, 2 blocks an SM (as built: 8)
  window of 5       the quality window's length a constant 5, the main
                    path's (as built: qwin, a parameter)

Ablations (outputs wrong, not checked):

  stage only     the copies in, no decisions
  no insert scan no offset of the insert match examined
  no adapter match   no adapter-prefix search
  no flush       no int64 atomics of the block's counters at the end
  no trims       no quality and no N trim
  no N trim      no N trim
  no decisions   no insert scan, no adapter match, no trims: the staging,
                 the per-pair results and the statistics remain
  empty          every block returns at once

Yardstick, not a scan: ``zero_``, PyTorch's ``zero_()`` of the kernel's
output tensors (the same bytes written, one launch per output; not for D).

Times: device time of 10 calls captured in a CUDA graph (L2-warm) and one
call after a 128 MB overwrite and read (cold), as chip_smoke.py times
kernels. D with -ec finds the reads corrected by its first call on every
later one. With ``--parent DIR`` (a checkout of another commit), that
commit's source is built and timed too, with the output types it writes
(int32 adapter counts before their one-byte counts, int32 K2 counts before
int16) and, for D, its own arguments (int32 adapter counts, no thresholds
before them). Prints one line per variant and kernel and, last, one JSON
line with every result. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ngsbits_tpu_torch.ops import _build, selfcheck  # noqa: E402

PEAK_BYTES = 3.35e12
OUT = ROOT / "build" / "scan_variants"
B, L = 10000, 151
A1 = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
A2 = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
OVERLAP, A_SIZE = 10, 20

_EV_STORES = ("            m1[out0 + idx] = c1;\n"
              "            mm1[out0 + idx] = t1 - c1;\n"
              "            m2[out0 + idx] = c2;\n"
              "            mm2[out0 + idx] = t2 - c2;\n")
_SC_STORES = ("            matches[out0 + idx] = m;\n"
              "            mismatches[out0 + idx] = t - m;\n")
_EV_COUNTS = ("            const int base = pad + clampi(s_len2[r] - o, -pad, L);\n"
              "            int c1, t1, c2, t2;\n"
              "            window_counts<NW, false>(s1 + r * s4, base, a1, c1, t1);\n"
              "            window_counts<NW, false>(s2 + r * s4, base, a2, c2, t2);\n")
_SC_COUNTS = ("            int m, t;\n"
              "            window_counts<NW, PREFIX>(rows_s + r * s4, o, ad, m, t);\n"
              "            if (PREFIX) t = prefix_count(pre + r * pw, o, ad.n);\n")
# the same counts for item j of four, at row rr and offset oo
_EV_QUAD = ("                    const int base = pad + clampi(s_len2[rr] - oo, -pad, L);\n"
            "                    window_counts<NW, false>(s1 + rr * s4, base, a1, c1[j], t1[j]);\n"
            "                    window_counts<NW, false>(s2 + rr * s4, base, a2, c2[j], t2[j]);\n")
_SC_QUAD = ("                    window_counts<NW, PREFIX>(rows_s + rr * s4, oo, ad, m[j], t[j]);\n"
            "                    if (PREFIX) t[j] = prefix_count(pre + rr * pw, oo, ad.n);\n")
_EV_STAGE = ("            stage_row<false>(s1 + r * s4, nullptr, raw1, off1 + r * L, clampi(l1s[r], 0, L), s4,\n"
             "                             pad, lane);\n"
             "            stage_row<false>(s2 + r * s4, nullptr, raw2, off2 + r * L, clampi(l2, 0, L), s4, pad,\n"
             "                             lane);\n")
_SC_STAGE = ("            stage_row<PREFIX>(rows_s + r * s4, pre + r * pw, raw, off + r * L,\n"
             "                              clampi(lens[r], 0, L), s4, 0, lane);\n")
_EV_HEAD = "    int* s_len2 = l2s + R;                 // len2 clamped for window starts\n"
_SC_HEAD = "    int* lens = reinterpret_cast<int*>(pre + R * pw);      // lengths as copied\n"


_TAIL = ("            o += dor;\n"
         "            r += dr;\n"
         "            if (o >= L) {\n"
         "                o -= L;\n"
         "                ++r;\n"
         "            }\n"
         "        }\n")


def _quad(counts: str, stores: str, body: str,
          pairs: list[tuple[str, str, str, str]]) -> tuple[str, str]:
    """The compute loop with four consecutive items per thread and 16-byte
    stores; ``body`` counts item j; ``pairs``: (match count, position
    count, matches output, mismatches output)."""
    old = ("        int r = r0, o = o0;\n"
           "        for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {\n"
           + counts + stores + _TAIL)
    decl = "".join(f"            int {c}[4] = {{0, 0, 0, 0}}, {t}[4] = {{0, 0, 0, 0}};\n"
                   for c, t, _, _ in pairs)
    vec, one = "", ""
    for c, t, mo, mmo in pairs:
        vec += (f"                *reinterpret_cast<uchar4*>({mo} + out0 + i4) = "
                f"make_uchar4({c}[0], {c}[1], {c}[2], {c}[3]);\n"
                f"                *reinterpret_cast<uchar4*>({mmo} + out0 + i4) = make_uchar4("
                f"{t}[0] - {c}[0], {t}[1] - {c}[1], {t}[2] - {c}[2], {t}[3] - {c}[3]);\n")
        one += (f"                    if (i4 + j < n) {mo}[out0 + i4 + j] = {c}[j];\n"
                f"                    if (i4 + j < n) {mmo}[out0 + i4 + j] = {t}[j] - {c}[j];\n")
    new = ("        const int dr4 = 4 * blockDim.x / L, do4 = 4 * blockDim.x % L;\n"
           "        int r = 4 * threadIdx.x / L, o = 4 * threadIdx.x % L;\n"
           "        for (int i4 = 4 * threadIdx.x; i4 < n; i4 += 4 * blockDim.x) {\n"
           + decl +
           "            int rr = r, oo = o;\n"
           "#pragma unroll\n"
           "            for (int j = 0; j < 4; ++j) {\n"
           "                if (i4 + j < n) {\n"
           + body +
           "                }\n"
           "                if (++oo == L) {\n"
           "                    oo = 0;\n"
           "                    ++rr;\n"
           "                }\n"
           "            }\n"
           "            if (i4 + 4 <= n) {\n"
           + vec +
           "            } else {\n"
           "#pragma unroll\n"
           "                for (int j = 0; j < 4; ++j) {\n"
           + one +
           "                }\n"
           "            }\n"
           "            o += do4;\n"
           "            r += dr4;\n"
           "            if (o >= L) {\n"
           "                o -= L;\n"
           "                ++r;\n"
           "            }\n"
           "        }\n")
    return old, new


_QUAD = [
    _quad(_EV_COUNTS, _EV_STORES, _EV_QUAD,
          [("c1", "t1", "m1", "mm1"), ("c2", "t2", "m2", "mm2")]),
    _quad(_SC_COUNTS, _SC_STORES, _SC_QUAD, [("m", "t", "matches", "mismatches")]),
    ("    if (r > kTileSmem / row_bytes) r = kTileSmem / row_bytes;\n",
     "    if (r > kTileSmem / row_bytes) r = kTileSmem / row_bytes;\n"
     "    if (r >= 4) r &= ~3;  // every tile's outputs start 4-byte aligned\n"),
]

# name: (substitutions, ablation)
ADAPTER_VARIANTS = {
    "as built": ([], False),
    "no prefix": ([("? adapter_scan_kernel<5, true>", "? adapter_scan_kernel<5, false>")], False),
    "run-time words": ([("? adapter_evidence_kernel<3>", "? adapter_evidence_kernel<0>"),
                        ("? adapter_scan_kernel<5, true>", "? adapter_scan_kernel<0, false>")],
                       False),
    "4 per thread": (_QUAD, False),
    "8 blocks/SM": ([("__launch_bounds__(kScanThreads, 4) adapter_evidence_kernel(",
                      "__launch_bounds__(kScanThreads, 8) adapter_evidence_kernel("),
                     ("__launch_bounds__(kScanThreads, 4) adapter_scan_kernel(",
                      "__launch_bounds__(kScanThreads, 8) adapter_scan_kernel(")], False),
    "2 blocks/SM": ([("8LL * ngs::sm_count();", "2LL * ngs::sm_count();")], False),
    "4 blocks/SM": ([("8LL * ngs::sm_count();", "4LL * ngs::sm_count();")], False),
    "tiles of 512": ([("constexpr int kTileItems = 2048;", "constexpr int kTileItems = 512;")],
                     False),
    "tiles of 8192": ([("constexpr int kTileItems = 2048;", "constexpr int kTileItems = 8192;")],
                      False),
    "no compares": ([(_EV_COUNTS, "            const int c1 = o, t1 = r, c2 = idx, t2 = n;\n"),
                     (_SC_COUNTS, "            const int m = o, t = r;\n")], True),
    "no stores": ([(_EV_STORES, "            if ((c1 ^ t1 ^ c2 ^ t2) == B + 0x40000000) "
                                "m1[out0 + idx] = c1;\n"),
                   (_SC_STORES, "            if ((m ^ t) == B + 0x40000000) "
                                "matches[out0 + idx] = m;\n")], True),
    "stores only": ([(_EV_STAGE, ""), (_SC_STAGE, "            ;\n"),
                     (_EV_COUNTS, "            const int c1 = o, t1 = r, c2 = idx, t2 = n;\n"),
                     (_SC_COUNTS, "            const int m = o, t = r;\n")], True),
    "empty": ([(_EV_HEAD, _EV_HEAD + "    if (B > 0) return;\n"),
               (_SC_HEAD, _SC_HEAD + "    if (B > 0) return;\n")], True),
}


_IN_COMPARE = ("    for (int k = 0; k < words; ++k) {\n"
               "        const uint2 x = a[k];\n"
               "        const uint2 hi = c[g + k + 2];\n"
               "#pragma unroll\n"
               "        for (int s = 0; s < 4; ++s) {\n"
               "            const unsigned w1 = s ? __funnelshift_r(mid.x, hi.x, 8 * s) : mid.x;"
               "  // offset 4g + 4 + s\n"
               "            const unsigned f1 = s ? __funnelshift_r(mid.y, hi.y, 8 * s) : mid.y;\n"
               "            count_word<SEVEN>(x.x, x.y, w0[s], f0[s], m[s], t[s]);\n"
               "            count_word<SEVEN>(x.x, x.y, w1, f1, m[4 + s], t[4 + s]);\n"
               "            w0[s] = w1;\n"
               "            f0[s] = f1;\n"
               "        }\n"
               "        mid = hi;\n"
               "    }\n")
_IN_NO_COMPARE = "    m[0] = 128u * words + w0[1] + f0[2];\n    t[1] = 16384u * g;\n"
_IN_STORES = ("                matches[out0 + r * L + o] = counts[r * Lp + o];\n"
              "                mismatches[out0 + r * L + o] = counts[(R + r) * Lp + o];\n")
_IN_STAGE = ("            const bool high = stage_flagged(s1 + r * W, raw1, off1 + r * L, n, W, lane) |\n"
             "                              stage_flagged(s2 + r * W, raw2, off2 + r * L, n, W, lane);\n")
_IN_MIRROR = "    if (v > u) insert_pair<SEVEN>(a, c, v, G - 2 * v, m_row, mm_row);\n"
_IN_LOOP = "    for (int k = 0; k < words; ++k) {\n        const uint2 x = a[k];\n"
_IN_HEAD = "    const int Lp = (L + 7) & ~7;                      // a row of counts: group pair p at 8p\n"
_IN_THREADS = "constexpr int kInsertThreads = 128;"

INSERT_VARIANTS = {
    "as built": ([], False),
    "int32 stores": ([("using Count = int16_t;", "using Count = int;")], False),
    "no fold": ([(_IN_MIRROR, ""), ("            if (2 * u < P) {\n", "            if (u < P) {\n"),
                 ("    const int U = (L + 15) / 16;", "    const int U = (L + 7) / 8;")], False),
    "exact only": ([("                if (ns[r] & 1)\n", "                if (true)\n")], False),
    "unroll 2": ([(_IN_LOOP, "#pragma unroll 2\n" + _IN_LOOP)], False),
    "masked counts": ([("    t = __dp4a(xf, f, t);\n", "    t = __dp4a(xf & f, 0x01010101u, t);\n"),
                       ("t[j] = (t[j] >> 14) - m[j];", "t[j] = (t[j] >> 7) - m[j];")], False),
    "64 threads": ([(_IN_THREADS, "constexpr int kInsertThreads = 64;")], False),
    "256 threads": ([(_IN_THREADS, "constexpr int kInsertThreads = 256;")], False),
    "grid 16/SM": ([("8LL * ngs::sm_count();", "16LL * ngs::sm_count();")], False),
    "no compares": ([(_IN_COMPARE, _IN_NO_COMPARE)], True),
    "no stores": ([(_IN_STORES, "                if (counts[r * Lp + o] == 0x4000 + L) "
                                "matches[out0 + o] = 0;\n")], True),
    "adds for dp4a": ([("    m = __dp4a(~differ & xf, 0x01010101u, m);\n"
                        "    t = __dp4a(xf, f, t);\n",
                        "    m += ~differ & xf;\n    t += xf ^ f;\n")], True),
    "no counted": ([("    t = __dp4a(xf, f, t);\n", "")], True),
    "m by xor": ([("    m = __dp4a(~differ & xf, 0x01010101u, m);\n",
                   "    m ^= ~differ & xf;\n")], True),
    "stores only": ([(_IN_STAGE, "            const bool high = false;\n"),
                     (_IN_COMPARE, _IN_NO_COMPARE)], True),
    "empty": ([(_IN_HEAD, _IN_HEAD + "    if (B > 0) return;\n")], True),
}
_D_DECIDE = "        decide_pair(x, b, pair_rows<STAGED>(x, b, buf, l1, l2), t, p, lane, s_acc, out);\n"
_D_FLUSH = "        if (s_acc[i]) atomicAdd(&acc[i], static_cast<unsigned long long>(s_acc[i]));\n"
_D_RATIO = "__ddiv_rn(__dmul_rn(100.0, static_cast<double>(m)), static_cast<double>(tot))"
_D_TAIL = "t.table[static_cast<long long>(tot) * t.T + m] <= p.mep"
_D_HEAD = "    extern __shared__ __align__(16) uint8_t smem[];\n"
_D_FIRST_HITS = "        first_hits(r, l1, l2, t, lane, off_f, off_r);\n"


def _d_float64_tests() -> list[tuple[str, str]]:
    """The per-offset float64 tests in place of the thresholds: both tests
    rewritten whole, with the parameters they need, and every caller passes
    them."""
    subs = []
    for name, row, test in (
            ("insert", "need_ins", f"tot > 0 && !({_D_RATIO} < p.match_perc)"),
            ("adapter", "need_ad", f"!(tot > 0 && {_D_RATIO} < p.match_perc)")):
        head = f"__device__ __forceinline__ bool {name}_passes(int m, int tot, const Tests& t"
        subs.append((f"{head}) {{\n    return m >= t.{row}[tot];\n",
                     f"{head}, const Params& p) {{\n    return {test} && {_D_TAIL};\n"))
    for call in ("adapter_passes(m, m + r.amm1[o], t", "adapter_passes(m, m + r.amm2[o], t",
                 "insert_passes(m, m + r.mm_ins[o], t"):
        subs.append((call + ")", call + ", p)"))
    subs.append(("const Tests& t,\n                                           int lane, int& off_f",
                 "const Tests& t,\n                                           const Params& p, "
                 "int lane, int& off_f"))
    subs.append((_D_FIRST_HITS, _D_FIRST_HITS.replace("t, lane", "t, p, lane")))
    return subs


DECIDE_VARIANTS = {
    "as built": ([], False),
    "float64 tests": (_d_float64_tests(), False),
    "unstaged": ([("    const int stage = 2 * kWarps * per <= kStageLimit ? per : 0;",
                   "    const int stage = 0 * per;")], False),
    "adapters unstaged": ([("    const unsigned bytes = lane < kSpans && x.L ?",
                            "    const unsigned bytes = lane < kSpans && (lane < 2 || lane >= 6) && x.L ?"),
                           ("        p[j] = STAGED ? buf + span_slot",
                            "        p[j] = STAGED && (j < 2 || j >= 6) ? buf + span_slot")], False),
    "no prefetch": ([("                stage_pair(x, nb, next, bar_next, lane);\n",
                      "                stage_pair(x, nb, next, bar_next, lane);\n"
                      "                while (!mbar_try_wait(bar_next, phase_next)) {\n"
                      "                }\n")], False),
    "grid 2/SM": ([("constexpr int kBlocksPerSM = 4;", "constexpr int kBlocksPerSM = 2;")], False),
    "grid 3/SM": ([("constexpr int kBlocksPerSM = 4;", "constexpr int kBlocksPerSM = 3;")], False),
    "16 warps": ([("constexpr int kWarps = 8;", "constexpr int kWarps = 16;"),
                  ("constexpr int kBlocksPerSM = 4;", "constexpr int kBlocksPerSM = 2;")], False),
    "stage only": ([(_D_DECIDE, "        ;\n")], True),
    "no insert scan": ([("    for (int o0 = 1; o0 < ml; o0 += 32 * 32) {\n",
                         "    for (int o0 = 1; o0 < 0 * ml; o0 += 32 * 32) {\n")], True),
    "no adapter match": ([(_D_FIRST_HITS, "        off_f = off_r = -1;\n")], True),
    "no flush": ([(_D_FLUSH, "        ;\n")], True),
    "no trims": ([("    if (p.qcut > 0) {\n", "    if (false) {\n"),
                  ("    if (p.ncut > 0) {\n", "    if (false) {\n")], True),
    "no N trim": ([("    if (p.ncut > 0) {\n", "    if (false) {\n")], True),
    "no decisions": ([("    for (int o0 = 1; o0 < ml; o0 += 32 * 32) {\n",
                       "    for (int o0 = 1; o0 < 0 * ml; o0 += 32 * 32) {\n"),
                      (_D_FIRST_HITS, "        off_f = off_r = -1;\n"),
                      ("    if (p.qcut > 0) {\n", "    if (false) {\n"),
                      ("    if (p.ncut > 0) {\n", "    if (false) {\n")], True),
    "window of 5": ([("            for (int j = 0; j < p.qwin; ++j) sum += q[i + j];\n",
                      "            for (int j = 0; j < 5; ++j) sum += q[i + j];\n")], False),
    "empty": ([(_D_HEAD, _D_HEAD + "    if (x.B > 0) return;\n")], True),
}

# --kernel: (source, variants, the kernels whose ptxas lines to print)
FAMILIES = {"adapters": ("seqpurge.cu", ADAPTER_VARIANTS, "adapter"),
            "insert": ("seqpurge.cu", INSERT_VARIANTS, "insert_scan"),
            "decide": ("seqpurge_decide.cu", DECIDE_VARIANTS, "seqpurge_decide")}


def _variant_source(source: str, subs: list[tuple[str, str]]) -> str:
    text = (_build.CSRC / source).read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"substitution anchor not found once: {old!r}")
        text = text.replace(old, new)
    return text


def _build_all(source: str, variants: dict, parent: Path | None,
               entry: str) -> dict[str, tuple[ctypes.CDLL, str]]:
    """One library per variant (and the parent's), nvcc all at once; prints
    ptxas's lines for the kernels whose names hold ``entry``. Returns name:
    (library, its source text)."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "launch.cuh").write_text((_build.CSRC / "launch.cuh").read_text())
    sources = {}
    for i, (name, (subs, _)) in enumerate(variants.items()):
        sources[name] = OUT / f"variant{i}.cu"
        sources[name].write_text(_variant_source(source, subs))
    if parent is not None:
        sources["parent"] = parent / "ngsbits_tpu_torch" / "csrc" / source
    libs = {name: OUT / f"variant{i}.so" for i, name in enumerate(sources)}
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", str(libs[name]),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    loaded = {}
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        shown = False
        for line in log.splitlines():
            if "Compiling entry" in line:
                shown = entry in line
            if shown and ("registers" in line or "stack" in line or "smem" in line):
                print(f"  [{name}] {line.strip()}")
        lib = ctypes.CDLL(str(libs[name]))
        text = sources[name].read_text()
        if source == "seqpurge.cu":
            lib.ngs_adapter_evidence.argtypes = [p, p, p, p, i, i, p, i, p, i, p, p, p, p, p]
            lib.ngs_adapter_scan.argtypes = [p, p, i, i, p, i, p, p, p]
            lib.ngs_insert_scan.argtypes = [p, p, p, i, i, p, p, p]
            fns = (lib.ngs_adapter_evidence, lib.ngs_adapter_scan, lib.ngs_insert_scan)
        else:  # D, with the thresholds' pointer where that source takes it
            ptrs = 7 if _thresholds(text) else 6
            lib.ngs_seqpurge_decide.argtypes = [p] * ptrs + [i, i, i, d, d, i, i, i, i, i,
                                                             p, p, i, p]
            fns = (lib.ngs_seqpurge_decide,)
        for fn in fns:
            fn.restype = ctypes.c_int
        loaded[name] = (lib, text)
    return loaded


def _thresholds(decide_source: str) -> bool:
    """True where D takes the thresholds and one-byte adapter counts."""
    return "const void* need" in decide_source


def _out_dtype(family: str, text: str) -> torch.dtype:
    """The scans' output type of a variant or of the parent, from its source."""
    if family == "insert":
        return (selfcheck.pk.INSERT_COUNT if "using Count = int16_t;" in text
                else torch.int32)
    return selfcheck.sp.ADAPTER_COUNT if "using AdapterCount" in text else torch.int32


def _ptrs(*ts):
    return [ctypes.c_void_p(t.data_ptr()) for t in ts]


def _stream():  # the current one, which a CUDA graph's capture replaces
    return torch.cuda.current_stream().cuda_stream


def _scan_kernels(family: str, dev: torch.device) -> dict:
    """name: (bytes needed, fresh outputs for a library's source, plain
    version into outputs, launch on a library into outputs)."""
    read1, read2, seq2rc, len1, len2, min_len = (
        torch.from_numpy(a).to(dev) for a in selfcheck.pairs(B, L, seed=B))

    def fresh(n):
        return lambda text: [torch.empty((B, L), dtype=_out_dtype(family, text),
                                         device=dev) for _ in range(n)]

    if family == "insert":
        return {"insert_scan": (
            2 * B * L + 4 * B + 4 * B * L, fresh(2),
            lambda out: selfcheck.pk.insert_scan_plain(read1, seq2rc, min_len, *out),
            lambda lib, out: lib.ngs_insert_scan(*_ptrs(read1, seq2rc, min_len), B, L,
                                                 *_ptrs(*out), _stream()))}
    w1, w2, ad = A1[:OVERLAP], A2[:OVERLAP], A1[:A_SIZE]
    return {
        "adapter_evidence": (
            2 * B * L + 8 * B + 4 * B * L, fresh(4),
            lambda out: selfcheck.sp.adapter_evidence_plain(read1, read2, len1, len2,
                                                            w1, w2, *out),
            lambda lib, out: lib.ngs_adapter_evidence(
                *_ptrs(read1, read2, len1, len2), B, L, w1, len(w1), w2, len(w2),
                *_ptrs(*out), _stream())),
        "adapter_scan": (
            B * L + 4 * B + 2 * B * L, fresh(2),
            lambda out: selfcheck.sp.adapter_scan_plain(read1, len1, ad, *out),
            lambda lib, out: lib.ngs_adapter_scan(*_ptrs(read1, len1), B, L, ad, len(ad),
                                                  *_ptrs(*out), _stream())),
    }


def _decide_kernels(dev: torch.device) -> dict:
    """D without and with -ec, as ``_scan_kernels``: outputs are the
    results, the accumulators and the reads it corrects, fresh copies."""
    kernels = {}
    for ec in (False, True):
        case = selfcheck.decide_case(B, L, dev, A1, A2, ec=ec, seed=B + L)
        scans, ins, bases, quals, lens, table, need, params = case.inputs
        scans32 = scans.to(torch.int32)
        T = table.shape[0]

        def fresh(text, bases=bases, quals=quals):
            return [torch.empty((3, B), dtype=torch.int32, device=dev),
                    torch.zeros(selfcheck.sp.ACC_SIZE, dtype=torch.int64, device=dev),
                    bases.clone(), quals.clone()]

        def plain(out, c=(scans, ins, lens, table, params)):
            scans_, ins_, lens_, table_, params_ = c
            selfcheck.sp.seqpurge_decide_plain(scans_, ins_, out[2], out[3], lens_, table_,
                                               out[0], out[1], **params_)

        def launch(lib, out, c=(scans, scans32, ins, lens, need, table, T, params)):
            scans_, scans32_, ins_, lens_, need_, table_, T_, pr = c
            lib_, text = lib
            head = (_ptrs(scans_, ins_, out[2], out[3], lens_, need_, table_)
                    if _thresholds(text) else
                    _ptrs(scans32_, ins_, out[2], out[3], lens_, table_))
            return lib_.ngs_seqpurge_decide(
                *head, T_, B, L, pr["match_perc"], pr["mep"], pr["qcut"], pr["qwin"],
                pr["qoff"], pr["ncut"], int(pr["ec"]), *_ptrs(out[0], out[1]),
                selfcheck.sp.ACC_SIZE, _stream())

        kernels["seqpurge_decide" + (" -ec" if ec else "")] = (case.bytes, fresh, plain,
                                                               launch)
    return kernels


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(FAMILIES), default="adapters",
                    help="which kernels to time beside their variants")
    ap.add_argument("--parent", type=Path,
                    help="a checkout of another commit whose kernels to time too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    source, variants, entry = FAMILIES[args.kernel]
    libs = _build_all(source, variants, args.parent, entry)
    decide = args.kernel == "decide"
    kernels = _decide_kernels(dev) if decide else _scan_kernels(args.kernel, dev)
    if not decide:  # the scans' launches take a library alone
        kernels = {k: (n, fresh, plain, lambda lib, out, f=launch: f(lib[0], out))
                   for k, (n, fresh, plain, launch) in kernels.items()}

    results = []
    for kname, (nbytes, fresh, plain, launch) in kernels.items():
        bound_ms = nbytes / PEAK_BYTES * 1e3
        built = (_build.CSRC / source).read_text()
        want = fresh(built)
        plain(want)
        calls = {}
        for name, lib in libs.items():
            out = fresh(lib[1])

            def call(lib=lib, out=out, name=name):
                rc = launch(lib, out)
                if rc:
                    raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
            call()
            torch.cuda.synchronize()
            if not variants.get(name, ([], False))[1] and not all(
                    torch.equal(g.to(torch.int64), w.to(torch.int64))
                    for g, w in zip(out, want)):
                print(f"{kname:20s} {name:17s} DIFFERS from the plain version: not timed")
                results.append(dict(kernel=kname, variant=name, differs=True))
                continue
            calls[name] = call
        if not decide:
            zeroed = fresh(built)
            calls["zero_"] = lambda z=zeroed: [t.zero_() for t in z]
        for name, call in calls.items():
            ablation = name == "zero_" or variants.get(name, ([], False))[1]
            ms = selfcheck.device_ms(call)
            cold = selfcheck.cold_ms(call)
            print(f"{kname:20s} {name:17s} device {ms:.4f} ms, cold {cold:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_ms / cold:.1%} of it cold)"
                  + (" [ablation]" if ablation else ""), flush=True)
            results.append(dict(kernel=kname, variant=name, ablation=ablation, ms=ms,
                                cold_ms=cold, bound_ms=bound_ms))
    print(json.dumps({"scan_variants": results}))
    return 1 if any(r.get("differs") for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
