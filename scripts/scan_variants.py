#!/usr/bin/env python3
"""SeqPurge's scans beside variants of themselves, timed on the card: the
adapter scans (``adapter_evidence``, ``adapter_scan``) or K2
(``insert_scan``).

    python3 scripts/scan_variants.py [--kernel adapters|insert] [--parent DIR]

Builds variants of ``ngsbits_tpu_torch/csrc/seqpurge.cu`` under
build/scan_variants/ (one nvcc per variant, all at once), each a copy of the
source with checked text substitutions, and times the kernels at the main
path's batch: B=10000 pairs, L=151, the pairs of ``ops/selfcheck.py::pairs``;
for the adapter scans the TruSeq adapters, a window of 10 bases (evidence)
and a prefix of 20 (scan).

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
  4 per thread   a thread owns four consecutive items and writes 16-byte
                 stores (tiles of a multiple of four rows, so every tile's
                 outputs start 16-byte aligned)
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

Yardstick, not a scan: ``zero_``, PyTorch's ``zero_()`` of the kernel's
output tensors (the same bytes written, one launch per output).

Times: device time of 10 calls captured in a CUDA graph (L2-warm) and one
call after a 128 MB overwrite and read (cold), as chip_smoke.py times
kernels. With ``--parent DIR`` (a checkout of another commit), that
commit's seqpurge.cu is built and timed too, its K2 with int32 outputs (as
K2 wrote them before its int16 counts). Prints one line per variant and
kernel and, last, one JSON line with every result. Needs a CUDA device.
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
        vec += (f"                *reinterpret_cast<int4*>({mo} + out0 + i4) = "
                f"make_int4({c}[0], {c}[1], {c}[2], {c}[3]);\n"
                f"                *reinterpret_cast<int4*>({mmo} + out0 + i4) = make_int4("
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
     "    if (r >= 4) r &= ~3;  // every tile's outputs start 16-byte aligned\n"),
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
VARIANTS = {"adapters": ADAPTER_VARIANTS, "insert": INSERT_VARIANTS}
INT32_OUTPUTS = ("int32 stores", "parent")  # K2 variants whose outputs are int32


def _variant_source(subs: list[tuple[str, str]]) -> str:
    text = (_build.CSRC / "seqpurge.cu").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"substitution anchor not found once: {old!r}")
        text = text.replace(old, new)
    return text


def _build_all(variants: dict, parent: Path | None,
               entry: str) -> dict[str, ctypes.CDLL]:
    """One library per variant (and the parent's), nvcc all at once; prints
    ptxas's lines for the kernels whose names hold ``entry``."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "launch.cuh").write_text((_build.CSRC / "launch.cuh").read_text())
    sources = {}
    for i, (name, (subs, _)) in enumerate(variants.items()):
        sources[name] = OUT / f"variant{i}.cu"
        sources[name].write_text(_variant_source(subs))
    if parent is not None:
        sources["parent"] = parent / "ngsbits_tpu_torch" / "csrc" / "seqpurge.cu"
    libs = {name: OUT / f"variant{i}.so" for i, name in enumerate(sources)}
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", str(libs[name]),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    loaded = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        shown = False
        for line in log.splitlines():
            if "Compiling entry" in line:
                shown = entry in line
            if shown and ("registers" in line or "stack" in line):
                print(f"  [{name}] {line.strip()}")
        lib = ctypes.CDLL(str(libs[name]))
        lib.ngs_adapter_evidence.argtypes = [p, p, p, p, i, i, p, i, p, i, p, p, p, p, p]
        lib.ngs_adapter_scan.argtypes = [p, p, i, i, p, i, p, p, p]
        lib.ngs_insert_scan.argtypes = [p, p, p, i, i, p, p, p]
        for fn in (lib.ngs_adapter_evidence, lib.ngs_adapter_scan, lib.ngs_insert_scan):
            fn.restype = ctypes.c_int
        loaded[name] = lib
    return loaded


def _ptrs(*ts):
    return [ctypes.c_void_p(t.data_ptr()) for t in ts]


def _kernels(family: str, dev: torch.device) -> dict:
    """name: (bytes needed, plain version into outputs, outputs, launch on a
    library into outputs)."""
    read1, read2, seq2rc, len1, len2, min_len = (
        torch.from_numpy(a).to(dev) for a in selfcheck.pairs(B, L, seed=B))

    def stream():  # the current one, which a CUDA graph's capture replaces
        return torch.cuda.current_stream().cuda_stream

    if family == "insert":
        return {"insert_scan": (
            2 * B * L + 4 * B + 4 * B * L,
            lambda out: selfcheck.pk.insert_scan_plain(read1, seq2rc, min_len, *out), 2,
            lambda lib, out: lib.ngs_insert_scan(*_ptrs(read1, seq2rc, min_len), B, L,
                                                 *_ptrs(*out), stream()))}
    w1, w2, ad = A1[:OVERLAP], A2[:OVERLAP], A1[:A_SIZE]
    return {
        "adapter_evidence": (
            2 * B * L + 8 * B + 16 * B * L,
            lambda out: selfcheck.sp.adapter_evidence_plain(read1, read2, len1, len2,
                                                            w1, w2, *out), 4,
            lambda lib, out: lib.ngs_adapter_evidence(
                *_ptrs(read1, read2, len1, len2), B, L, w1, len(w1), w2, len(w2),
                *_ptrs(*out), stream())),
        "adapter_scan": (
            B * L + 4 * B + 8 * B * L,
            lambda out: selfcheck.sp.adapter_scan_plain(read1, len1, ad, *out), 2,
            lambda lib, out: lib.ngs_adapter_scan(*_ptrs(read1, len1), B, L, ad, len(ad),
                                                  *_ptrs(*out), stream())),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(VARIANTS), default="adapters",
                    help="which scans to time beside their variants")
    ap.add_argument("--parent", type=Path,
                    help="a checkout of another commit whose scans to time too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    variants = VARIANTS[args.kernel]
    libs = _build_all(variants, args.parent,
                      "insert_scan" if args.kernel == "insert" else "adapter")

    def outputs(n, name=""):
        dtype = torch.int32
        if args.kernel == "insert" and name not in INT32_OUTPUTS:
            dtype = selfcheck.pk.INSERT_COUNT
        return [torch.empty((B, L), dtype=dtype, device=dev) for _ in range(n)]

    results = []
    for kname, (nbytes, plain, n_out, launch) in _kernels(args.kernel, dev).items():
        bound_ms = nbytes / PEAK_BYTES * 1e3
        want = outputs(n_out)
        plain(want)
        calls = {}
        for name, lib in libs.items():
            out = outputs(n_out, name)

            def call(lib=lib, out=out, name=name):
                rc = launch(lib, out)
                if rc:
                    raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
            call()
            torch.cuda.synchronize()
            if not variants.get(name, ([], False))[1] and not all(
                    torch.equal(g.to(torch.int32), w.to(torch.int32))
                    for g, w in zip(out, want)):
                print(f"{kname:16s} {name:14s} DIFFERS from the plain version: not timed")
                results.append(dict(kernel=kname, variant=name, differs=True))
                continue
            calls[name] = call
        zeroed = outputs(n_out)
        calls["zero_"] = lambda z=zeroed: [t.zero_() for t in z]
        for name, call in calls.items():
            ablation = name == "zero_" or variants.get(name, ([], False))[1]
            ms = selfcheck.device_ms(call)
            cold = selfcheck.cold_ms(call)
            print(f"{kname:16s} {name:14s} device {ms:.4f} ms, cold {cold:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_ms / cold:.1%} of it cold)"
                  + (" [ablation]" if ablation else ""), flush=True)
            results.append(dict(kernel=kname, variant=name, ablation=ablation, ms=ms,
                                cold_ms=cold, bound_ms=bound_ms))
    print(json.dumps({"scan_variants": results}))
    return 1 if any(r.get("differs") for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
