#!/usr/bin/env python3
"""B1's region form (``pileup_regions``) beside variants of itself, timed on the card.

    python3 scripts/region_variants.py [--parent DIR] [--launch FILE] [--rounds 3]

Builds variants of ``ngsbits_tpu_torch/csrc/pileup.cu`` under
build/region_variants/ (one nvcc per variant, all at once), each a copy of
the source with checked text substitutions in the region form's kernel and
launcher that switch parts of the design off, and times
``ngs_pileup_regions`` of each at two launches: the median launch of the
variant-details tools (``--launch FILE``: its inputs as ``chip_smoke.py
--phase annotate --save-region-launch FILE`` saves them; without it a
synthetic batch like it: 4,385 sorted records of 151 bp over a 6 Mb window
of one chromosome of 24, one in ten with an I or D op, over 1,467 regions of
1-12 bases) and ``selfcheck.REGION_EDGES``' case of about 6,000 reached
regions (long and short regions over a 20 kb window: each thread walks
many of them). With ``--parent DIR`` (a checkout of another commit, e.g.
``git archive HEAD~1 | tar -x -C build/parent``) that commit's pileup.cu is
built and timed too, as ``parent``, with the arguments its launcher takes
(before the regions range and the scratch: every region, and a memset of
the count before each launch).

The design's three parts, each switched on alone (the others off) and off
alone:

  memset removed   the count kept in a scratch word the caller zeroes once
                   (and each block prefetches into the L2), with the
                   finished blocks' tickets in its top bits; the last block
                   to finish moves it into out[0] and clears it (off: a
                   memset of out[0] before each launch, the count there)
  loads hoisted    a record's key, MAPQ, CIGAR offsets and position loaded
                   before any branch on them, the table's three words
                   together, a region's start and end together, CIGAR words
                   four at a time in both walks (off: the first design's
                   chain, key, then table, offsets, one word at a time, then
                   position and MAPQ; a region's end after its start's test)
  walk skipped     a record without an I, D or N op adds 1 to the depth of
                   each region it spans without walking its CIGAR again
                   (off: every spanning record walks it)

``none`` has all three off (the first design at the narrowed regions
range); ``fenced ticket`` the design with the indel form's move of the
count (a fence, then a ticket on the scratch's second word, then the count
exchanged) in place of its own (the hits and the tickets on one word, no
fence); ``empty kernel`` (a kernel that returns at once: the launch's
floor) is an ablation, its output not checked. Every other variant's
counters and hits are held equal to the plain version's over every region
before it is timed.

Times: device time of 10 calls captured in a CUDA graph (L2-warm) and one
call after a 128 MB overwrite and read (cold), as chip_smoke.py times
kernels; ``--rounds`` rounds, each timing every variant in turn (warm, then
cold); the median and each round's. Prints ptxas' registers and spills of
each variant's region kernels, one line per variant and shape and, last,
one JSON line with every result. Needs a CUDA device.
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

OUT = ROOT / "build" / "region_variants"
LARGE = "6,000 regions reached"
# the region form's kernel and its launcher: the substitutions apply there alone
KERNEL = ("// B1's region form: the ops that make a spanning record walk its CIGAR",
          "int grid_for(long long n")
LAUNCHER = ("// B1's region form: records [0, n);", "// The hits of the indel or region form")

_EPILOGUE = """    // the last block to finish: the count into out[0], the word cleared. The
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
"""
# the indel form's move: a fence, a ticket on the scratch's second word, the
# count exchanged
_FENCED = """    // the last block to finish: the count into out[0], the scratch cleared
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned* done = reinterpret_cast<unsigned*>(count + 1);
        __threadfence();
        if (atomicAdd(done, 1u) == gridDim.x - 1) {
            out[0] = static_cast<long long>(atomicExch(count, 0ULL));
            atomicExch(done, 0u);
        }
    }
"""
_PREFETCH = """    // the scratch into the L2 for the atomics, while the records' loads are issued
    if (threadIdx.x == 0) asm volatile("prefetch.global.L2 [%0];" ::"l"(count));
"""
_SCRATCH = "    auto* count = static_cast<unsigned long long*>(scratch);\n"
_MEMSET = """    const cudaError_t cleared =
        cudaMemsetAsync(out, 0, sizeof(long long), static_cast<cudaStream_t>(stream));
    if (cleared != cudaSuccess) return static_cast<int>(cleared);
    auto* count = static_cast<unsigned long long*>(out);
"""
_RECORD = """        // the record's columns, every load issued before a branch on any
        const int key = __ldg(keep + r);
        const int q = __ldg(mapq + r);
        const long long c0 = __ldg(cigar_off + r), c1 = __ldg(cigar_off + r + 1);
        const long long r_start = static_cast<long long>(__ldg(pos + r)) + 1;  // 1-based
        if (key < 0 || key >= n_refs) continue;
        const int lo = max(__ldg(table + key), lo_cut) - lo_cut;
        const int hi = min(__ldg(table + n_refs + key), hi_cut) - lo_cut;
        const int longest = __ldg(table + 2 * n_refs + key);
        if (lo >= hi) continue;
"""
_CHAINED_RECORD = """        const int key = __ldg(keep + r);
        if (key < 0 || key >= n_refs) continue;
        const int lo = max(__ldg(table + key), lo_cut) - lo_cut;
        const int hi = min(__ldg(table + n_refs + key), hi_cut) - lo_cut;
        if (lo >= hi) continue;
        const int longest = __ldg(table + 2 * n_refs + key);
"""
_FIRST_WALK = """        // the first walk: the span, and which ops the record holds
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
"""
_CHAINED_WALK = """        const long long c0 = __ldg(cigar_off + r), c1 = __ldg(cigar_off + r + 1);
        long long span = 0;
        unsigned held = 0;
        for (long long c = c0; c < c1; ++c) {
            const unsigned w = __ldg(cigar + c);
            span += ref_length(w);
            held |= 1u << (w & 0xF);
        }
        const long long r_start = static_cast<long long>(__ldg(pos + r)) + 1;
        const int q = __ldg(mapq + r);
"""
_BOUNDS = """            const long long s = __ldg(st + j), e = __ldg(en + j);  // both in flight
            if (s > r_end) break;
"""
_CHAINED_BOUNDS = """            const long long s = __ldg(st + j);
            if (s > r_end) break;
            const long long e = __ldg(en + j);
"""
_SECOND_WALK = """                for (long long c = c0; c < c1 && g <= last; c += 4) {  // nothing more past it
                    const unsigned w0 = __ldg(cigar + c);
                    const unsigned w1 = c + 1 < c1 ? __ldg(cigar + c + 1) : 0xFu;
                    const unsigned w2 = c + 2 < c1 ? __ldg(cigar + c + 2) : 0xFu;
                    const unsigned w3 = c + 3 < c1 ? __ldg(cigar + c + 3) : 0xFu;
                    visit(w0, c);
                    visit(w1, c + 1);
                    visit(w2, c + 2);
                    visit(w3, c + 3);
                }
"""
_ONE_WORD = """                for (long long c = c0; c < c1 && g <= last; ++c) visit(__ldg(cigar + c), c);
"""

# each part of the design switched off: (where, old, new)
OFF = {
    "memset removed": [("kernel", _EPILOGUE, ""), ("kernel", _PREFETCH, ""),
                       ("launcher", _SCRATCH, _MEMSET)],
    "loads hoisted": [("kernel", _RECORD, _CHAINED_RECORD),
                      ("kernel", _FIRST_WALK, _CHAINED_WALK),
                      ("kernel", _BOUNDS, _CHAINED_BOUNDS),
                      ("kernel", _SECOND_WALK, _ONE_WORD)],
    "walk skipped": [("kernel", "const bool walk = (held & kWalkOps) != 0;",
                      "const bool walk = true;")],
}
_ABLATIONS = {"empty kernel"}


def _variants() -> dict[str, list[tuple[str, str, str]]]:
    parts = list(OFF)
    got = {"as built": []}
    for p in parts:
        got[f"{p} alone"] = [s for q in parts if q != p for s in OFF[q]]
    got["none"] = [s for q in parts for s in OFF[q]]
    for p in parts:
        got[f"without {p}"] = list(OFF[p])
    got["fenced ticket"] = [("kernel", _EPILOGUE, _FENCED)]
    got["empty kernel"] = [("kernel", "    const int* st = starts + lo_cut;",
                            "    if (n > 0) return;\n    const int* st = starts + lo_cut;")]
    return got


def _variant_source(subs: list[tuple[str, str, str]]) -> str:
    text = (_build.CSRC / "pileup.cu").read_text()
    spans = {}
    for where, (a, b) in (("kernel", KERNEL), ("launcher", LAUNCHER)):
        i = text.index(a)
        spans[where] = (i, text.index(b, i))
    pieces = {where: text[i:j] for where, (i, j) in spans.items()}
    for where, old, new in subs:
        if pieces[where].count(old) != 1:
            raise RuntimeError(f"substitution anchor not found once in the {where}: {old!r}")
        pieces[where] = pieces[where].replace(old, new)
    (ki, kj), (li, lj) = spans["kernel"], spans["launcher"]
    return (text[:ki] + pieces["kernel"] + text[kj:li] + pieces["launcher"] + text[lj:])


def _build_all(parent: Path | None) -> dict[str, tuple[ctypes.CDLL, bool]]:
    """One library per variant (and the parent's), nvcc all at once:
    {name: (library, whether its launcher takes the regions range and a
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
        for line in log.splitlines():  # ptxas' lines of the region form's kernel
            if "Compiling entry" in line:
                entry = line
            elif "regions" in entry and ("registers" in line or "spill" in line):
                print(f"  {name}: {line.strip()}")
        lib = ctypes.CDLL(str(libs[name]))
        ranged = "lo_cut" in sources[name].read_text().split(LAUNCHER[0])[1]
        lib.ngs_pileup_regions.argtypes = (
            [p, p, p, p, p, i, p, i, p, i, i, i, p, p, ll, p, p] if ranged
            else [p, p, p, p, p, i, p, i, p, i, p, p, ll, p])
        lib.ngs_pileup_regions.restype = ctypes.c_int
        loaded[name] = (lib, ranged)
    return loaded


def _median_like(dev: torch.device, seed: int = 0):
    """A synthetic batch like the variant-details tools' median launch:
    (records, regions, table, capacity, regions range). 1,467 regions of
    1-12 bases over 24 chromosomes of 8 Mb, 4,385 sorted 151 bp records on
    chromosome 5 in a 6 Mb window, each over one of that chromosome's
    regions; one record in ten with one I or D op of 1-4 bases inside its
    region."""
    rng = np.random.default_rng(seed)
    chrs = rng.integers(1, 25, size=1467)
    starts = rng.integers(1, 8_000_000, size=1467)
    ends = starts + rng.integers(0, 12, size=1467)
    near = np.flatnonzero((chrs == 5) & (starts >= 1_500_000) & (starts < 7_500_000))
    n = 4385
    at = rng.choice(near, size=n)
    pos = np.sort(starts[at] - rng.integers(20, 130, size=n) - 1)  # 0-based
    cigars, n_cigar = [], []
    for k in range(n):
        if rng.random() < 0.1:
            a, ln = int(rng.integers(20, 130)), int(rng.integers(1, 5))
            op = int(rng.integers(1, 3))
            tail = 151 - a - (ln if op == 1 else 0)
            ops = [(a << 4), (ln << 4) | op, (tail << 4)]
        else:
            ops = [151 << 4]
        cigars += ops
        n_cigar.append(len(ops))
    cigar = np.array(cigars, np.uint32)
    cigar_off = np.concatenate(([0], np.cumsum(n_cigar))).astype(np.int64)
    keys = np.full(n, 4, np.int32)
    engine = dr.DeviceRegions(chrs, starts, ends, np.arange(1, 25), device=dev)
    ops, lens = cigar & 0xF, (cigar >> 4).astype(np.int64)
    rec_of = np.repeat(np.arange(n), n_cigar)
    r_ends = pos + np.bincount(rec_of, weights=lens * np.isin(ops, [0, 2]), minlength=n)
    _, cut = engine.reaching(pos, r_ends.astype(np.int64), keys)
    rec = dr.upload_records(pos.astype(np.int32), keys, cigar_off, cigar,
                            mapq=np.where(rng.random(n) < 0.03, 0, 60).astype(np.uint8),
                            device=dev)
    return rec, engine.regions, engine.table, selfcheck.region_capacity(rec, engine), cut


def _saved(path: Path, dev: torch.device):
    got = torch.load(path)
    rec = dr.Records(**{k: v.to(dev) for k, v in got["rec"].items()})
    return (rec, got["regions"].to(dev), got["table"].to(dev), got["capacity"],
            tuple(got["regions_range"]))


def _large(dev: torch.device):
    rec, engine, capacity, cut = selfcheck.region_edge_inputs(LARGE, dev)
    return rec, engine.regions, engine.table, capacity, cut


def _calls(libs: dict, inputs):
    """{name: (call, check or None)}: each library's launch into its own
    counters and output (and scratch), and a check of one launch's counters
    and hits against the plain version over every region."""
    rec, regions, table, capacity, cut = inputs
    n = regions.shape[1]
    want_counters = torch.zeros((dr.REGION_COUNTERS, n), dtype=torch.int32, device=regions.device)
    want = selfcheck.sorted_region_hits(dr.pileup_regions_plain(rec, regions, table,
                                                                want_counters))
    calls = {}
    for name, (lib, ranged) in libs.items():
        counters = torch.zeros_like(want_counters)
        out = dr.region_out(capacity, regions.device)
        scratch = dr.indel_scratch(regions.device)
        head = [rec.pos.data_ptr(), rec.keep.data_ptr(), rec.mapq.data_ptr(),
                rec.cigar_off.data_ptr(), rec.cigar.data_ptr(), rec.pos.shape[0],
                regions.data_ptr(), n, table.data_ptr(), table.shape[1]]
        args = (head + [cut[0], cut[1], counters.data_ptr(), out.data_ptr(), capacity,
                        scratch.data_ptr()] if ranged
                else head + [counters.data_ptr(), out.data_ptr(), capacity])

        def call(lib=lib, args=args, name=name):
            rc = lib.ngs_pileup_regions(*args, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")

        def check(call=call, out=out, counters=counters, scratch=scratch):
            """What differs from the plain version after one launch ('' if nothing)."""
            counters.zero_()
            call()
            torch.cuda.synchronize()
            count = int(out[0])
            if count != want.shape[0]:
                return (f"{count} hits, the plain version {want.shape[0]}; scratch "
                        f"{scratch.tolist()}")
            hits = selfcheck.sorted_region_hits(out[1:1 + dr.REGION_HIT * count].view(
                -1, dr.REGION_HIT))
            rows = [int((counters[k] != want_counters[k]).sum()) for k in range(3)]
            if any(rows) or not torch.equal(hits, want):
                bad = (hits != want).any(1).nonzero().flatten()[:3].tolist()
                return (f"counters differ at {rows} regions (mapped, mapq0, depth); hits "
                        f"differ at rows {bad}: {hits[bad].tolist()} against "
                        f"{want[bad].tolist()}")
            return ""
        calls[name] = (call, None if name in _ABLATIONS else check)
    return calls, want.shape[0]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of another commit to time too")
    ap.add_argument("--launch", type=Path,
                    help="the median launch's inputs, saved by chip_smoke.py "
                         "--save-region-launch")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("region_variants: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = _build_all(args.parent)
    shapes = {
        ("the variant-details tools' median launch" if args.launch
         else "a batch like the variant-details tools' median launch"):
            _saved(args.launch, dev) if args.launch else _median_like(dev),
        LARGE: _large(dev),
    }
    results = []
    for what, inputs in shapes.items():
        rec, regions, _, capacity, cut = inputs
        calls, hits = _calls(libs, inputs)
        for name, (_, check) in calls.items():
            if check is not None:
                wrong = check() or check()
                if wrong:
                    raise AssertionError(f"{what}, {name}: differs from the plain version: "
                                         f"{wrong}")
        ops = dr.count_indel_ops(rec.cigar.cpu().numpy().view(np.uint32))
        print(f"{what}: {rec.pos.shape[0]} records, {ops} I and D ops, {hits} hits at "
              f"{regions.shape[1]} regions ({cut[1] - cut[0]} reached), capacity {capacity}: "
              f"every variant but the ablations equals the plain version, twice on its "
              f"scratch", flush=True)
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
    print(json.dumps({"region_variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
