#!/usr/bin/env python3
"""The ReadQC stream's kernels beside variants of themselves, timed on the card.

    python3 scripts/k1_variants.py [--kernel batch|unpack|tails] [--parent DIR]

Builds variants of ``ngsbits_tpu_torch/csrc/readqc.cu`` under
build/k1_variants/ (one nvcc per variant, all at once), each a copy of the
source with checked text substitutions, and times one of its three kernels:
K1 (``--kernel batch``, the default), unpack or tails. Design variants have
their outputs held equal to the plain version first; ablations leave out part
of the work to show what it costs (their outputs are wrong and not checked).
With ``--parent DIR`` (a checkout of another commit), that commit's
readqc.cu is built and its kernel timed too, as ``parent``.

K1 (``readqc_batch``) on K1's inputs of chip_smoke.py: the main path's full
batch of 151 bp reads at B=65536, L=192 with binned and with uniform
qualities, and SeqPurge's -qc bucket (B=16384, 10,000 reads).

  as built       the source unchanged
  lane hist      the histogram replicated per lane ([256][32] words), so no
                 two lanes of a warp ever add into one word
  1 block/SM, 4 blocks/SM   launch shapes (as built: 2)
  512 threads    one block of 512 threads per SM (as built: two of 256)
  ring 8, ring 10            steps in each thread's copy ring (as built: 4)
  ablations      no histogram (no shared atomics for the quality histogram);
                 no bases (no base counting); no epilogue (no flush of the
                 counters, no int64 or histogram adds); no int64 adds;
                 copies only (the chunks copied into the ring and read, no
                 counting); stream read (no K1: the same grid reads both
                 [B, L] arrays whole with 16-byte loads); empty (every block
                 returns at once: launch and scheduling alone)
  torch max      yardstick, not K1: PyTorch's max over both [B, L] arrays

unpack (``readqc_unpack``) on the rows the stream step hands it: the main
path's batch (B=65536 reads at L=192, 6-bit quals) and SeqPurge's -qc bucket
(B=16384, its 10,000 reads). Bound: packed bytes in + 2 x rows x L out.

  as built       16-column chunks, two a thread
  8-column       8-column chunks only (2-byte codes, 8-byte stores)
  byte loads     the byte path only (byte loads, 4-byte stores)
  1 chunk/thread, 4 chunks/thread   chunks a thread (as built: 2)
  all rows       as built on all B rows of the bucket (padding included),
                 as the stream step did before it handed unpack only reads
  ablations      no quals, no bases (that output neither converted nor
                 stored), empty
  zero_          yardstick: PyTorch's zero_() of the two [rows, L] outputs

tails (``readqc_tails``) on K1's per-read sums of the same two batches.
Bound: 8 B bytes in and the carries.

  as built       a thread per read, per-block shared histograms, each
                 nonzero bin flushed once a block
  warp match     the lanes of a warp on one shared bin add once
                 (__match_any_sync), not one by one
  last block     the blocks write partial histograms to a buffer, and the
                 last block to finish sums them and adds each bin once
  2, 4 and 16 reads/thread   smaller grids (as built: one read a thread)
  128 threads    blocks of 128 threads (as built: 256): twice the blocks
  len_hist global  len_hist by warp-aggregated global atomics, as past the
                 shared cap
  ablations      no histograms (no shared atomics), no division (a shift in
                 place of each read's division), no flush (no int64 adds of
                 the bins), empty

Times: device time of 10 calls captured in a CUDA graph (L2-warm) and one
call after a 128 MB overwrite and read (cold), as chip_smoke.py times
kernels. K1 adds one call after the overwrite alone (the L2 then holds dirty
lines that the call's misses write back); unpack and tails take the cold
time three times, to show its spread. Prints one line per variant and input
and, last, one JSON line with every result. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ngsbits_tpu_torch.ops import _build, selfcheck  # noqa: E402
from ngsbits_tpu_torch.ops import pallas_kernels as pk  # noqa: E402
from ngsbits_tpu_torch.ops.readqc import pack_batch, stream_carry_init  # noqa: E402

PEAK_BYTES = 3.35e12
OUT = ROOT / "build" / "k1_variants"
BATCH_INPUTS = [  # label, B, L, qual_bits, profile, read length, valid rows
    ("B=65536 L=192 151bp binned", 65536, 192, 6, "binned", 151, 65536),
    ("B=65536 L=192 151bp uniform", 65536, 192, 6, "uniform", 151, 65536),
    ("B=16384 L=192 10000x151bp binned", 16384, 192, 6, "binned", 151, 10000),
]
# unpack's and tails': ReadQC's main batch and SeqPurge's -qc bucket
STREAM_INPUTS = [BATCH_INPUTS[0], BATCH_INPUTS[2]]

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
BATCH_VARIANTS = {
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


_TAIL_FLUSH = """    // each nonzero bin leaves the block once
    for (int i = tid; i < nbins; i += kTailThreads) {
        const unsigned c = s_hist[i];
        if (c) add64(tail_bin(i, read_q_hist, qdist, len_hist), c);
    }
"""
_LAST_BLOCK = """    // the last block to finish sums every block's partial histograms
    {
        __shared__ bool s_last;
        unsigned* part = g_tail_part + blockIdx.x * kTailStride;
        for (int i = tid; i < nbins; i += kTailThreads) part[i] = s_hist[i];
        __threadfence();
        __syncthreads();
        if (tid == 0) s_last = atomicAdd(&g_tail_ticket, 1u) == gridDim.x - 1;
        __syncthreads();
        if (s_last) {
            __threadfence();
            for (int i = tid; i < nbins; i += kTailThreads) {
                unsigned c = 0;
                for (unsigned b = 0; b < gridDim.x; ++b)
                    c += __ldcg(g_tail_part + b * kTailStride + i);
                if (c) add64(tail_bin(i, read_q_hist, qdist, len_hist), c);
            }
            if (tid == 0) g_tail_ticket = 0;
        }
    }
"""
_TAIL_KERNEL = "__global__ void __launch_bounds__(kTailThreads)\nreadqc_tails_kernel("
# the partials of at most 512 blocks (B=65536 takes 65536 / kTailRows)
_TAIL_GLOBALS = ("constexpr int kTailStride = kReadQBins + kQDistBins + kLenCap;\n"
                 "__device__ unsigned g_tail_part[512 * kTailStride];\n"
                 "__device__ unsigned g_tail_ticket;\n\n")
_LANE_ADD = "    if (bin >= 0) atomicAdd(s + bin, 1u);\n"
_WARP_MATCH = """    const unsigned peers = __match_any_sync(kFull, bin);
    if (bin >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(s + bin, __popc(peers));
"""
_UNPACK_START = ("    const unsigned g0 = blockIdx.x * (kUnpackThreads * kUnpackPer) + "
                 "threadIdx.x;\n")
# name: (substitutions, ablation); None: the built kernel called another way
UNPACK_VARIANTS = {
    "as built": ([], False),
    "8-column": ([("    const bool vec16 = aligned", "    const bool vec16 = false && aligned")],
                 False),
    "byte loads": ([("    const bool vec16 = aligned", "    const bool vec16 = false && aligned"),
                    ("    const bool vec8 = aligned", "    const bool vec8 = false && aligned")],
                   False),
    "1 chunk/thread": ([("constexpr int kUnpackPer = 2;", "constexpr int kUnpackPer = 1;")],
                       False),
    "4 chunks/thread": ([("constexpr int kUnpackPer = 2;", "constexpr int kUnpackPer = 4;")],
                        False),
    "all rows": (None, False),
    "no quals": ([("        reinterpret_cast<uint4*>(quals)[i] = "
                   "make_uint4(qo[0], qo[1], qo[2], qo[3]);\n", "")], True),
    "no bases": ([("        reinterpret_cast<uint4*>(bases)[i] = "
                   "make_uint4(bo[0], bo[1], bo[2], bo[3]);\n", "")], True),
    "empty": ([(_UNPACK_START, "    if (n8 > 0) return;\n" + _UNPACK_START)], True),
}
TAIL_VARIANTS = {
    "as built": ([], False),
    "last block": ([(_TAIL_FLUSH, _LAST_BLOCK), (_TAIL_KERNEL, _TAIL_GLOBALS + _TAIL_KERNEL)],
                   False),
    "2 reads/thread": ([("constexpr int kTailPer = 1;", "constexpr int kTailPer = 2;")], False),
    "4 reads/thread": ([("constexpr int kTailPer = 1;", "constexpr int kTailPer = 4;")], False),
    "16 reads/thread": ([("constexpr int kTailPer = 1;", "constexpr int kTailPer = 16;")],
                        False),
    "128 threads": ([("constexpr int kTailThreads = 256;", "constexpr int kTailThreads = 128;")],
                    False),
    "len_hist global": ([("constexpr int kLenCap = 4096;", "constexpr int kLenCap = 0;")],
                        False),
    "warp match": ([(_LANE_ADD, _WARP_MATCH)], False),
    "no histograms": ([(_LANE_ADD, "    if (bin == 0x7FFFFFFF) s[0] = 0;\n")], True),
    "no division": ([("        int h = rq[i] / d, rem = rq[i] - h * d;",
                      "        int h = rq[i] >> 7, rem = rq[i] & 127;")], True),
    "no flush": ([("        if (c) add64(tail_bin(i, read_q_hist, qdist, len_hist), c);",
                   "        if (c == 0x9E3779B9u) add64(q20, c);  // keeps the bins live")],
                 True),
    "empty": ([("    __shared__ unsigned s_hist[", "    if (B > 0) return;\n"
                "    __shared__ unsigned s_hist[")], True),
}

VARIANTS = {"batch": BATCH_VARIANTS, "unpack": UNPACK_VARIANTS, "tails": TAIL_VARIANTS}


def _variant_source(subs: list[tuple[str, str]]) -> str:
    text = (_build.CSRC / "readqc.cu").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"substitution anchor not found once: {old!r}")
        text = text.replace(old, new)
    return text


def _build_all(variants: dict, parent: Path | None) -> dict[str, ctypes.CDLL]:
    """One library per variant (and the parent's), nvcc all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "launch.cuh").write_text((_build.CSRC / "launch.cuh").read_text())
    sources = {}
    for i, (name, (subs, _)) in enumerate(variants.items()):
        if subs is None:  # a way of calling the built kernel, not a source
            continue
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
        lib.ngs_readqc_unpack.argtypes = [p, p, p, i, i, i, p, p, p]
        lib.ngs_readqc_tails.argtypes = [p, p, i, i, i, i, p, p, p, p, p, p, p, p, p]
        for fn in (lib.ngs_readqc_batch, lib.ngs_readqc_unpack, lib.ngs_readqc_tails):
            fn.restype = ctypes.c_int
        loaded[name] = lib
    return loaded


def _ptrs(*ts):
    return [ctypes.c_void_p(t.data_ptr()) for t in ts]


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _launched(name: str, rc: int):
    if rc:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _batch_calls(libs, dev, i, B, L, qual_bits, profile, read_len, n_valid):
    """K1: (bound bytes, {name: (call, check or None)})."""
    (case,) = [c for c in selfcheck.cases(B, L, qual_bits, dev, seed=i, profile=profile,
                                          read_len=read_len, n_valid=n_valid)
               if c.name == "readqc_batch"]
    case.plain()
    _, want = case.outputs()
    bases, quals, lengths = case.inputs
    calls = {}
    for name, lib in libs.items():
        out = [torch.zeros_like(w) for w in want]

        def call(lib=lib, out=out, name=name):
            _launched(name, lib.ngs_readqc_batch(*_ptrs(bases, quals, lengths), B, L, L,
                                                 *_ptrs(*out), _stream()))
        calls[name] = (call, lambda out=out: all(torch.equal(g, w) for g, w in zip(out, want)))
    calls["torch max"] = (lambda: (bases.max(), quals.max()), None)
    return case.bytes, calls


def _unpack_calls(libs, dev, i, B, L, qual_bits, profile, read_len, n_valid):
    """unpack on the first n_valid rows (all B for ``all rows``)."""
    arrays = selfcheck.reads(B, L, qual_bits, seed=i, profile=profile, read_len=read_len,
                             n_valid=n_valid)
    packed = [torch.from_numpy(a).to(dev) for a in pack_batch(*arrays[:2], qual_bits)]
    calls = {}
    for name in [*libs, "all rows"]:
        lib = libs["as built" if name == "all rows" else name]
        rows = B if name == "all rows" else n_valid
        ins = [t[:rows] for t in packed]
        out = [torch.empty((rows, L), dtype=torch.uint8, device=dev) for _ in range(2)]
        want = [torch.empty_like(t) for t in out]
        pk.readqc_unpack_plain(*ins, qual_bits, *want)

        def call(lib=lib, ins=ins, out=out, rows=rows, name=name):
            _launched(name, lib.ngs_readqc_unpack(*_ptrs(*ins), rows, L, qual_bits,
                                                  *_ptrs(*out), _stream()))
        calls[name] = (call, lambda out=out, want=want: all(
            torch.equal(g, w) for g, w in zip(out, want)))
        if name == "as built":
            zero_out = out
    calls["zero_"] = (lambda: [t.zero_() for t in zero_out], None)
    bound_bytes = sum(t[:n_valid].numel() for t in packed) + 2 * n_valid * L
    return bound_bytes, calls


def _tails_calls(libs, dev, i, B, L, qual_bits, profile, read_len, n_valid):
    """tails on K1's per-read sums, into zeroed carries."""
    arrays = selfcheck.reads(B, L, qual_bits, seed=i, profile=profile, read_len=read_len,
                             n_valid=n_valid)
    bases, quals, lengths = (torch.from_numpy(a).to(dev) for a in arrays[:3])
    *sums, read_qsum = [torch.zeros(s, dtype=d, device=dev) for s, d in
                        (((5, L), torch.int64), (L, torch.int64), (100, torch.int64),
                         (B, torch.int32))]
    pk.readqc_batch_plain(bases, quals, lengths, *sums, read_qsum)
    want = stream_carry_init(L, dev)
    pk.readqc_tails_plain(read_qsum, lengths, n_valid, 0, want)
    calls = {}
    for name, lib in libs.items():
        carry = stream_carry_init(L, dev)
        tails = [carry[k] for k in pk.TAIL_KEYS]

        def call(lib=lib, tails=tails, name=name):
            _launched(name, lib.ngs_readqc_tails(*_ptrs(read_qsum, lengths), B, n_valid, 0,
                                                 L, *_ptrs(*tails), _stream()))
        calls[name] = (call, lambda carry=carry: all(
            torch.equal(carry[k], want[k]) for k in pk.TAIL_KEYS))
    return 8 * B + 8 * sum(want[k].numel() for k in pk.TAIL_KEYS), calls


RUNNERS = {"batch": (BATCH_INPUTS, _batch_calls), "unpack": (STREAM_INPUTS, _unpack_calls),
           "tails": (STREAM_INPUTS, _tails_calls)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=tuple(VARIANTS), default="batch",
                    help="the kernel whose variants to time (default: K1)")
    ap.add_argument("--parent", type=Path,
                    help="a checkout of another commit whose kernel to time too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    variants = VARIANTS[args.kernel]
    libs = _build_all(variants, args.parent)
    inputs, make_calls = RUNNERS[args.kernel]
    results = []
    for i, (label, *shape) in enumerate(inputs):
        bound_bytes, calls = make_calls(libs, dev, i, *shape)
        bound_ms = bound_bytes / PEAK_BYTES * 1e3
        for name, (call, check) in calls.items():
            ablation = check is None or variants.get(name, ([], False))[1]
            if check is not None:
                call()
                torch.cuda.synchronize()
                if not ablation and not check():
                    raise AssertionError(f"{label} {name}: differs from the plain version")
            ms = selfcheck.device_ms(call)
            got = dict(input=label, variant=name, ablation=ablation, ms=ms,
                       bound_ms=bound_ms)
            if args.kernel == "batch":
                got["cold_ms"] = selfcheck.cold_ms(call)
                got["cold_dirty_ms"] = selfcheck.cold_ms(call, clean=False)
                extra = f"(dirty L2 {got['cold_dirty_ms']:.4f})"
            else:
                colds = [selfcheck.cold_ms(call) for _ in range(3)]
                got["cold_ms"], got["cold_runs_ms"] = statistics.median(colds), colds
                extra = "(" + ", ".join(f"{c:.4f}" for c in colds) + ")"
            print(f"{args.kernel} {label:34s} {name:16s} device {ms:.4f} ms, cold "
                  f"{got['cold_ms']:.4f} ms {extra}, bound {bound_ms:.4f} ms "
                  f"({bound_ms / got['cold_ms']:.1%} of it cold)"
                  + (" [ablation or yardstick]" if ablation else ""), flush=True)
            results.append(got)
    print(json.dumps({"k1_variants": results, "kernel": args.kernel}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
