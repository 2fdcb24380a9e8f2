#!/usr/bin/env python3
"""K1 (``readqc_batch``) beside variants of itself, timed on the card.

    python3 scripts/k1_variants.py [--parent DIR]

Builds variants of ``ngsbits_tpu_torch/csrc/readqc.cu`` under
build/k1_variants/ (one nvcc per variant, all at once), each a copy of the
source with checked text substitutions, and times their ``ngs_readqc_batch``
on K1's inputs of chip_smoke.py: the main path's full batch of 151 bp reads
at B=65536, L=192 with binned and with uniform qualities, and SeqPurge's -qc
bucket. Design variants (outputs held equal to the plain version first):

  as built       the source unchanged
  lane hist      the histogram replicated per lane ([256][32] words), so no
                 two lanes of a warp ever add into one word
  1 block/SM, 4 blocks/SM   launch shapes (as built: 2)
  512 threads    one block of 512 threads per SM (as built: two of 256)
  ring 8, ring 10            steps in each thread's copy ring (as built: 4)

Ablations, which leave out part of the work to show what it costs (their
outputs are wrong and not checked):

  no histogram   no shared atomics for the quality histogram
  no bases       no base counting (bit flags or exact compares)
  no epilogue    the block ends after its rows: no flush of the counters,
                 no int64 adds, no histogram adds
  no int64 adds  the epilogue without its 64-bit atomics to the outputs
  copies only    the chunks are copied into the ring and read, no counting
  stream read    no K1 at all: the same grid reads every byte of both
                 [B, L] arrays with 16-byte loads (2BL bytes), a yardstick
                 for the data path
  empty          every block returns at once: launch and scheduling alone

Yardstick, not K1: ``torch max``, PyTorch's max over the whole [B, L] bases
and quals (2BL bytes read, the bytes past the reads included).

Times: device time of 10 calls captured in a CUDA graph (L2-warm) and one
call after a 128 MB overwrite and read (cold), as chip_smoke.py times
kernels, and one call after the overwrite alone (the L2 then holds dirty
lines that the call's misses write back). With ``--parent DIR`` (a checkout of another commit), that
commit's readqc.cu is built and timed too. Prints one line per variant and
input and, last, one JSON line with every result. Needs a CUDA device.
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
OUT = ROOT / "build" / "k1_variants"
INPUTS = [  # label, B, L, qual_bits, profile, read length, valid rows
    ("B=65536 L=192 151bp binned", 65536, 192, 6, "binned", 151, 65536),
    ("B=65536 L=192 151bp uniform", 65536, 192, 6, "uniform", 151, 65536),
    ("B=16384 L=192 10000x151bp binned", 16384, 192, 6, "binned", 151, 10000),
]

_LANE_HIST = [
    ("constexpr int kHistBytes = kHistBins * 4;",
     "constexpr int kHistBytes = kHistBins * 32 * 4;"),
    ("atomicAdd(s_hist + byte, 1u);",
     "atomicAdd(s_hist + ((byte << 5) | (threadIdx.x & 31)), 1u);"),
    ("unsigned* s_col = s_hist + kHistBins;", "unsigned* s_col = s_hist + kHistBins * 32;"),
    ("i < kHistBins + kColSums", "i < kHistBins * 32 + kColSums"),
    ("    if (tid < kQHist && s_hist[33 + tid]) add64(qhist + tid, s_hist[33 + tid]);",
     "    if (tid < kQHist) {\n        unsigned v = 0;\n"
     "        for (int l = 0; l < 32; ++l) v += s_hist[((33 + tid) << 5) | ((l + tid) & 31)];\n"
     "        if (v) add64(qhist + tid, v);\n    }"),
]
# name: (substitutions, ablation)
VARIANTS = {
    "as built": ([], False),
    "lane hist": (_LANE_HIST, False),
    "1 block/SM": ([("2LL * ngs::sm_count()", "1LL * ngs::sm_count()")], False),
    "4 blocks/SM": ([("2LL * ngs::sm_count()", "4LL * ngs::sm_count()")], False),
    "512 threads": ([("constexpr int kK1Threads = 256;", "constexpr int kK1Threads = 512;"),
                     ("__launch_bounds__(kK1Threads, 2)", "__launch_bounds__(kK1Threads, 1)"),
                     ("2LL * ngs::sm_count()", "1LL * ngs::sm_count()")], False),
    "ring 8": ([("constexpr int kDepth = 4;", "constexpr int kDepth = 8;")], False),
    "ring 10": ([("constexpr int kDepth = 4;", "constexpr int kDepth = 10;")], False),
    "no histogram": ([("atomicAdd(s_hist + byte, 1u);", "")], True),
    "no bases": ([("        if (acgtn) {", "        if (false) {"),
                  ("            count_exact(a, w, bw[w], m8[w]);", "")], True),
    "no epilogue": ([("    if (npass == 1) {\n",
                      "    unsigned sink = 0;  // every counter stays live\n"
                      "    for (int w = 0; w < 4; ++w) {\n"
                      "        for (int k = 0; k < 5; ++k) sink ^= acc.cnt[k][w];\n"
                      "        sink ^= acc.nv[w] ^ acc.qlo[w] ^ acc.qhi[w];\n"
                      "    }\n"
                      "    if (sink == 0x9E3779B9u) read_qsum[0] = static_cast<int>(sink);\n"
                      "    return;\n    if (npass == 1) {\n")], True),
    "no int64 adds": ([
        ("            if (v) add64(counts5 + k * static_cast<size_t>(ldc) + col0 + c, v);", ""),
        ("        if (qs) add64(qsum_cycle + col0 + c, qs);", ""),
        ("    if (tid < kQHist && s_hist[33 + tid]) add64(qhist + tid, s_hist[33 + tid]);", "")],
        True),
    "copies only": ([("    const unsigned bw[4] = {bv.x, bv.y, bv.z, bv.w};",
                      "    a.cnt[0][0] += bv.x ^ bv.y ^ bv.z ^ bv.w;\n"
                      "    return qv.x + qv.y + qv.z + qv.w;\n"
                      "    const unsigned bw[4] = {bv.x, bv.y, bv.z, bv.w};")], True),
    "stream read": ([("    extern __shared__ __align__(16) unsigned char smem[];",
                      "    if (B > 0) {\n"
                      "        const size_t n16 = static_cast<size_t>(B) * L / 16;\n"
                      "        const size_t step = static_cast<size_t>(gridDim.x) * blockDim.x;\n"
                      "        unsigned x = 0;\n"
                      "        for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;\n"
                      "             i < n16; i += step) {\n"
                      "            const uint4 b = __ldg(reinterpret_cast<const uint4*>(bases) + i);\n"
                      "            const uint4 q = __ldg(reinterpret_cast<const uint4*>(quals) + i);\n"
                      "            x += b.x ^ b.y ^ b.z ^ b.w ^ q.x ^ q.y ^ q.z ^ q.w;\n"
                      "        }\n"
                      "        if (x == 0x9E3779B9u) read_qsum[0] = static_cast<int>(x);\n"
                      "        return;\n"
                      "    }\n"
                      "    extern __shared__ __align__(16) unsigned char smem[];")], True),
    "empty": ([("    extern __shared__ __align__(16) unsigned char smem[];",
                "    if (B > 0) return;\n"
                "    extern __shared__ __align__(16) unsigned char smem[];")], True),
}


def _variant_source(subs: list[tuple[str, str]]) -> str:
    text = (_build.CSRC / "readqc.cu").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"substitution anchor not found once: {old!r}")
        text = text.replace(old, new)
    return text


def _build_all(parent: Path | None) -> dict[str, ctypes.CDLL]:
    """One library per variant (and the parent's), nvcc all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "launch.cuh").write_text((_build.CSRC / "launch.cuh").read_text())
    sources = {}
    for i, (name, (subs, _)) in enumerate(VARIANTS.items()):
        sources[name] = OUT / f"variant{i}.cu"
        sources[name].write_text(_variant_source(subs))
    if parent is not None:
        sources["parent"] = parent / "ngsbits_tpu_torch" / "csrc" / "readqc.cu"
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
        lib = ctypes.CDLL(str(libs[name]))
        lib.ngs_readqc_batch.argtypes = [p, p, p, i, i, i, p, p, p, p, p]
        lib.ngs_readqc_batch.restype = ctypes.c_int
        loaded[name] = lib
    return loaded


def _ptrs(*ts):
    return [ctypes.c_void_p(t.data_ptr()) for t in ts]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="a checkout of another commit whose K1 to time too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = _build_all(args.parent)
    results = []
    for i, (label, B, L, qual_bits, profile, read_len, n_valid) in enumerate(INPUTS):
        (case,) = [c for c in selfcheck.cases(B, L, qual_bits, dev, seed=i,
                                              profile=profile, read_len=read_len,
                                              n_valid=n_valid)
                   if c.name == "readqc_batch"]
        bound_ms = case.bytes / PEAK_BYTES * 1e3
        case.plain()
        _, want = case.outputs()
        bases, quals, lengths = case.inputs
        calls = {}
        for name, lib in libs.items():
            out = [torch.zeros_like(w) for w in want]

            def call(lib=lib, out=out, name=name):
                rc = lib.ngs_readqc_batch(*_ptrs(bases, quals, lengths), B, L, L,
                                          *_ptrs(*out),
                                          torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
            call()
            torch.cuda.synchronize()
            if not VARIANTS.get(name, ([], False))[1] and not all(
                    torch.equal(g, w) for g, w in zip(out, want)):
                raise AssertionError(f"{label} {name}: differs from the plain version")
            calls[name] = call
        # yardstick, not K1: PyTorch reads both [B, L] arrays whole
        calls["torch max"] = lambda: (bases.max(), quals.max())
        for name, call in calls.items():
            ablation = name == "torch max" or VARIANTS.get(name, ([], False))[1]
            ms = selfcheck.device_ms(call)
            cold = selfcheck.cold_ms(call)
            dirty = selfcheck.cold_ms(call, clean=False)
            print(f"{label:34s} {name:14s} device {ms:.4f} ms, cold {cold:.4f} ms "
                  f"(dirty L2 {dirty:.4f}), bound {bound_ms:.4f} ms "
                  f"({bound_ms / cold:.1%} of it cold)"
                  + (" [not K1]" if ablation else ""), flush=True)
            results.append(dict(input=label, variant=name, ablation=ablation, ms=ms,
                                cold_ms=cold, cold_dirty_ms=dirty, bound_ms=bound_ms))
    print(json.dumps({"k1_variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
