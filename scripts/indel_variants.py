#!/usr/bin/env python3
"""B1's indel form (``pileup_indels``) beside variants of itself, timed on the card.

    python3 scripts/indel_variants.py [--parent DIR] [--launch FILE] [--rounds 3]

Builds variants of ``ngsbits_tpu_torch/csrc/pileup.cu`` under
build/indel_variants/ (one nvcc per variant, all at once), each a copy of the
source with checked text substitutions that switch parts of the design off,
and times ``ngs_pileup_indels`` of each at two launches: the median launch
of VcfMerge's re-calling (``--launch FILE``: its inputs as ``chip_smoke.py
--phase callers --save-indel-launch FILE`` saves them; without it a
synthetic batch like it: 3,674 records of 151 bp over a 6 Mb window of
one chromosome, each reaching one of the 4,088 loci, one in about 20 with an I or D
op) and ``selfcheck.INDEL_EDGES``' case of 200,000 loci on one chromosome
(more than the kernel stages in shared memory: its searches read global
memory). With ``--parent DIR`` (a checkout of another commit, e.g. ``git
archive HEAD~1 | tar -x -C build/parent``) that commit's pileup.cu is built
and timed too, as ``parent``, with the arguments its launcher takes (before
the loci range and the scratch: every locus, and a memset of the count
before each launch).

The design's four parts, each switched on alone (the others off) and off
alone:

  memset removed   the count kept in a scratch the caller zeroes once (and
                   each block prefetches into the L2), which the last block
                   to finish moves into out[0] and clears (off: a memset of
                   out[0] before each launch, the count there)
  loads hoisted    a record's key, MAPQ, CIGAR and SEQ offsets and position
                   loaded before any branch on them, CIGAR words four at a
                   time (off: the first design's chain, key, then table,
                   MAPQ, offsets, one word at a time)
  one atomic an op an I or D op's hits claim their slots with one atomic
                   (off: an atomic a hit)
  shared memory    the table and the reached loci staged in shared memory
                   (off: both read in global memory)

``none`` has all four off (the first design at the narrowed loci range);
``empty kernel`` is an ablation (a kernel that returns at once: the launch's
floor; outputs not checked). Every other variant's hits are held equal to
the plain version's at every locus before it is timed.

Times: device time of 10 calls captured in a CUDA graph (L2-warm) and one
call after a 128 MB overwrite and read (cold), as chip_smoke.py times
kernels; ``--rounds`` rounds, each timing every variant in turn (warm, then
cold); the median and each round's. Prints one line per variant and shape
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

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ngsbits_tpu_torch.ops import _build, selfcheck  # noqa: E402
from ngsbits_tpu_torch.ops import device_reduce as dr  # noqa: E402

OUT = ROOT / "build" / "indel_variants"
LARGE = "200,000 loci on one chromosome, in global memory"

_EPILOGUE = """    // the last block to finish: the count into out[0], the scratch cleared
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        if (atomicAdd(done, 1u) == gridDim.x - 1) {
            out[0] = static_cast<long long>(atomicExch(count, 0ULL));
            atomicExch(done, 0u);
        }
    }
"""
_SCRATCH = "    auto* count = static_cast<unsigned long long*>(scratch);\n"
_MEMSET = """    const cudaError_t cleared = cudaMemsetAsync(out, 0, sizeof(long long), s);
    if (cleared != cudaSuccess) return static_cast<int>(cleared);
    auto* count = static_cast<unsigned long long*>(out);
"""
_RECORD = """        // the record's columns, every load issued before a branch on any
        const int key = __ldg(keep + r);
        const int q = __ldg(mapq + r);
        const long long c0 = __ldg(cigar_off + r), c1 = __ldg(cigar_off + r + 1);
        const long long l_seq = __ldg(seq_off + r + 1) - __ldg(seq_off + r);
        long long ref_at = static_cast<long long>(__ldg(pos + r)) + 1, q_at = 0;
"""
_CHECKS = """        if (base + static_cast<int>(threadIdx.x) >= n || key < 0 || key >= n_refs ||
            q < min_mapq)
            continue;
        const int lo = max(tab[key], lo_cut) - lo_cut;
        const int hi = min(tab[n_refs + key], hi_cut) - lo_cut;
        if (lo >= hi) continue;
"""
_CHAIN = """        if (base + static_cast<int>(threadIdx.x) >= n || key < 0 || key >= n_refs)
            continue;
        const int lo = max(tab[key], lo_cut) - lo_cut;
        const int hi = min(tab[n_refs + key], hi_cut) - lo_cut;
        if (lo >= hi || static_cast<int>(__ldg(mapq + r)) < min_mapq) continue;
        const long long c0 = __ldg(cigar_off + r), c1 = __ldg(cigar_off + r + 1);
        const long long l_seq = __ldg(seq_off + r + 1) - __ldg(seq_off + r);
        long long ref_at = static_cast<long long>(__ldg(pos + r)) + 1, q_at = 0;
"""
_ONE_WORD = "        for (long long c = c0; c < c1; ++c) visit(__ldg(cigar + c));\n"
_WORDS = """        for (long long c = c0; c < c1; c += 4) {  // four words in flight
            const unsigned w0 = __ldg(cigar + c);
            const unsigned w1 = c + 1 < c1 ? __ldg(cigar + c + 1) : 0xFu;
            const unsigned w2 = c + 2 < c1 ? __ldg(cigar + c + 2) : 0xFu;
            const unsigned w3 = c + 3 < c1 ? __ldg(cigar + c + 3) : 0xFu;
            visit(w0);
            visit(w1);
            visit(w2);
            visit(w3);
        }
"""
_PREFETCH = """    // the scratch into the L2 for the atomics, while the records' loads are issued
    if (threadIdx.x == 0) asm volatile("prefetch.global.L2 [%0];" ::"l"(count));
"""
_OP_ATOMIC = """                int end = j;
                while (end < hi && cut[end] <= ref_at + window) ++end;
                if (end > j) {  // the op's hits: one atomic claims their slots
                    unsigned long long slot =
                        atomicAdd(count, static_cast<unsigned long long>(end - j));
                    for (int t = j; t < end && slot < static_cast<unsigned long long>(capacity);
                         ++t, ++slot) {
"""
_HIT_ATOMIC = """                for (int t = j; t < hi && cut[t] <= ref_at + window; ++t) {
                    const unsigned long long slot = atomicAdd(count, 1ULL);
                    if (slot < static_cast<unsigned long long>(capacity)) {
"""

# each part of the design switched off
OFF = {
    "memset removed": [(_EPILOGUE, ""), (_SCRATCH, _MEMSET), (_PREFETCH, "")],
    "loads hoisted": [(_WORDS, _ONE_WORD),
                      (_RECORD, "        const int key = __ldg(keep + r);\n"),
                      (_CHECKS, _CHAIN)],
    "one atomic an op": [(_OP_ATOMIC, _HIT_ATOMIC)],
    "shared memory": [("constexpr int kStagedLoci = 4096;", "constexpr int kStagedLoci = -1;"),
                      ("constexpr int kStagedRefs = 1024;", "constexpr int kStagedRefs = -1;")],
}
_ABLATIONS = {"empty kernel"}


def _variants() -> dict[str, list[tuple[str, str]]]:
    parts = list(OFF)
    got = {"as built": []}
    for p in parts:
        got[f"{p} alone"] = [s for q in parts if q != p for s in OFF[q]]
    got["none"] = [s for q in parts for s in OFF[q]]
    for p in parts:
        got[f"without {p}"] = list(OFF[p])
    got["empty kernel"] = [("    extern __shared__ int staged[];",
                            "    if (n > 0) return;\n    extern __shared__ int staged[];")]
    return got


def _variant_source(subs: list[tuple[str, str]]) -> str:
    text = (_build.CSRC / "pileup.cu").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"substitution anchor not found once: {old!r}")
        text = text.replace(old, new)
    return text


def _build_all(parent: Path | None) -> dict[str, tuple[ctypes.CDLL, bool]]:
    """One library per variant (and the parent's), nvcc all at once:
    {name: (library, whether its launcher takes the loci range and a
    scratch)}."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "launch.cuh").write_text((_build.CSRC / "launch.cuh").read_text())
    sources = {}
    for i, (name, subs) in enumerate(_variants().items()):
        sources[name] = OUT / f"variant{i}.cu"
        sources[name].write_text(_variant_source(subs))
    if parent is not None:
        sources["parent"] = parent / "ngsbits_tpu_torch" / "csrc" / "pileup.cu"
    libs = {name: OUT / f"variant{i}.so" for i, name in enumerate(sources)}
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", str(libs[name]), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    loaded = {}
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        entry = ""
        for line in log.splitlines():  # ptxas' lines of the indel form's kernels
            if "Compiling entry" in line:
                entry = line
            elif "indels" in entry and ("registers" in line or "spill" in line):
                print(f"  {name}: {line.strip()}")
        lib = ctypes.CDLL(str(libs[name]))
        ranged = "lo_cut" in sources[name].read_text()
        lib.ngs_pileup_indels.argtypes = (
            [p, p, p, p, p, p, i, p, i, p, i, i, i, i, i, p, ll, p, p] if ranged
            else [p, p, p, p, p, p, i, p, i, p, i, i, i, p, ll, p])
        lib.ngs_pileup_indels.restype = ctypes.c_int
        loaded[name] = (lib, ranged)
    return loaded


def _median_like(dev: torch.device, seed: int = 0):
    """A synthetic batch like VcfMerge's median launch: (records, engine,
    min_mapq, window, capacity, loci range). 4,088 loci over 24 chromosomes
    of 8 Mb, 3,674 sorted 151 bp records on chromosome 5, each over one of
    that chromosome's loci in a 6 Mb window (a BAM batch's share of the
    genome); one record in about 21 with one I or D op of 1-4 bases."""
    rng = np.random.default_rng(seed)
    chrs = rng.integers(1, 25, size=4088)
    pos = rng.integers(1, 8_000_000, size=4088)
    near = np.flatnonzero((chrs == 5) & (pos >= 1_500_000) & (pos < 7_500_000))
    n = 3674
    over = pos[rng.choice(near, size=n)]
    starts = np.sort(over - rng.integers(0, 151, size=n) - 1)  # 0-based
    cigars, n_cigar = [], []
    for _ in range(n):
        if rng.random() < 176 / n:
            a, ln = int(rng.integers(10, 140)), int(rng.integers(1, 5))
            op = int(rng.integers(1, 3))
            tail = 151 - a - (ln if op == 1 else 0)
            ops = [(a << 4), (ln << 4) | op, (tail << 4)]
        else:
            ops = [151 << 4]
        cigars += ops
        n_cigar.append(len(ops))
    cigar = np.array(cigars, np.uint32)
    cigar_off = np.concatenate(([0], np.cumsum(n_cigar))).astype(np.int64)
    seq_off = np.arange(n + 1, dtype=np.int64) * 151
    keys = np.full(n, 4, np.int32)
    engine = dr.DevicePileup(chrs, pos, np.arange(1, 25), device=dev, indel_window=1,
                             count_bases=False)
    ops, lens = cigar & 0xF, (cigar >> 4).astype(np.int64)
    rec_of = np.repeat(np.arange(n), n_cigar)
    ends = starts + np.bincount(rec_of, weights=lens * np.isin(ops, [0, 2]), minlength=n)
    _, cut = engine.reaching(starts, ends.astype(np.int64), keys)
    rec = dr.upload_records(starts.astype(np.int32), keys, cigar_off, cigar, seq_off,
                            np.full(151 * n, 30, np.uint8), seq=np.full(151 * n, 1, np.uint8),
                            mapq=np.full(n, 60, np.uint8), device=dev)
    capacity = dr.count_indel_ops(cigar) * engine.indel_depth
    return rec, engine.loci, engine.table, 20, 1, capacity, cut


def _saved(path: Path, dev: torch.device):
    got = torch.load(path)
    rec = dr.Records(**{k: v.to(dev) for k, v in got["rec"].items()})
    return (rec, got["loci"].to(dev), got["table"].to(dev), got["min_mapq"], got["window"],
            got["capacity"], tuple(got["loci_range"]))


def _calls(libs: dict, inputs) -> dict:
    """{name: (call, check or None)}: each library's launch into its own
    output (and scratch), and a check of one launch's hits against the
    plain version at every locus."""
    rec, loci, table, mq, window, capacity, cut = inputs
    want = selfcheck.sorted_hits(dr.pileup_indels_plain(rec, loci, table, mq, window))
    calls = {}
    for name, (lib, ranged) in libs.items():
        out = dr.indel_out(capacity, loci.device)
        scratch = dr.indel_scratch(loci.device)
        head = [rec.pos.data_ptr(), rec.keep.data_ptr(), rec.mapq.data_ptr(),
                rec.cigar_off.data_ptr(), rec.cigar.data_ptr(), rec.qual_off.data_ptr(),
                rec.pos.shape[0], loci.data_ptr(), loci.shape[0], table.data_ptr(),
                table.shape[1]]
        args = (head + [cut[0], cut[1], mq, window, out.data_ptr(), capacity, scratch.data_ptr()]
                if ranged else head + [mq, window, out.data_ptr(), capacity])

        def call(lib=lib, args=args, name=name):
            rc = lib.ngs_pileup_indels(*args, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")

        def check(call=call, out=out):
            call()
            torch.cuda.synchronize()
            count = int(out[0])
            hits = out[1:1 + 4 * count].view(-1, 4)
            return count <= capacity and torch.equal(selfcheck.sorted_hits(hits), want)
        calls[name] = (call, None if name in _ABLATIONS else check)
    return calls, want.shape[0]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of another commit to time too")
    ap.add_argument("--launch", type=Path,
                    help="the median launch's inputs, saved by chip_smoke.py "
                         "--save-indel-launch")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("indel_variants: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = _build_all(args.parent)
    shapes = {
        ("VcfMerge's median launch" if args.launch else "a batch like VcfMerge's median "
         "launch"): _saved(args.launch, dev) if args.launch else _median_like(dev),
        LARGE: (lambda r, e, mq, w, cap, cut: (r, e.loci, e.table, mq, w, cap, cut))(
            *selfcheck.indel_edge_inputs(LARGE, dev)),
    }
    results = []
    for what, inputs in shapes.items():
        rec, loci, _, mq, window, capacity, cut = inputs
        calls, hits = _calls(libs, inputs)
        for name, (_, check) in calls.items():
            if check is not None and not (check() and check()):
                raise AssertionError(f"{what}, {name}: differs from the plain version")
        ops = dr.count_indel_ops(rec.cigar.cpu().numpy().view(np.uint32))
        print(f"{what}: {rec.pos.shape[0]} records, {ops} I and D ops, {hits} hits at "
              f"{loci.shape[0]} loci ({cut[1] - cut[0]} reached), window {window}, min_mapq "
              f"{mq}, capacity {capacity}: every variant but the ablations equals the plain "
              f"version, twice on its scratch", flush=True)
        warm = {name: [] for name in calls}
        cold = {name: [] for name in calls}
        for _ in range(args.rounds):
            for name, (call, _) in calls.items():
                warm[name].append(selfcheck.device_ms(call))
                cold[name].append(selfcheck.cold_ms(call))
        for name in calls:
            got = dict(shape=what, variant=name, ms=statistics.median(warm[name]),
                       warm_runs_ms=warm[name], cold_ms=statistics.median(cold[name]),
                       cold_runs_ms=cold[name])
            print(f"{name:32s} device {got['ms']:.4f} ms ("
                  + ", ".join(f"{w:.4f}" for w in warm[name]) + f"), cold {got['cold_ms']:.4f} "
                  f"ms (" + ", ".join(f"{c:.4f}" for c in cold[name]) + ")"
                  + (" [ablation, not checked]" if name in _ABLATIONS else ""), flush=True)
            results.append(got)
    print(json.dumps({"indel_variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
