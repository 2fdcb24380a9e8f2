#!/usr/bin/env python3
"""H1 (RohHunter's ordered products of af²) beside variants of itself, timed on the card.

    python3 scripts/h1_variants.py [--parent DIR] [--rounds 3]

Builds variants of ``ngsbits_tpu_torch/csrc/variants.cu`` under
build/h1_variants/ (one nvcc per variant, all at once, with chip_smoke.py's
H1 probe beside them), each a copy of the source with checked text
substitutions, and times ``ngs_roh_products`` of each at the two H1 launches
of the first RohHunter run of ``chip_smoke.py``'s variants phase: its VCF
(``synth.wgs_vcf``, seed 101, 551,069 records over chr1, chr2 and chrX's
first 50 Mb) and ``roh_beds``' BEDs, RohHunter ``-var_af_keys_vep
gnomAD_AF,AF -exclude -annotate`` run on the card, the inputs of its raw
runs' launch and its final regions' copied as it makes them. With
``--parent DIR`` (a checkout of another commit, e.g. ``git archive HEAD~1 |
tar -x -C build/parent``) that commit's variants.cu is built and timed too,
as ``parent``.

  as built          a warp a long range (chunks of 32 markers, 4 ahead,
                    squares staged in shared memory), a lane a range of at
                    most 16 markers, a warp's ranges strided by the grid's
                    warps; the chain exits where the product leaves the
                    positive finite numbers and the block's 16 warps test
                    the rests together, 8 loads a thread in flight
  rest by its warp  the warp that exits tests its own rest alone (ballots
                    over 8 chunks at a time), no block list
  a thread a range  the early exit, then the same thread tests the rest
  a block a range   a block a long range, without a sort by length: every
                    range a block, its squares staged in shared memory 2,048 at a
                    time by the block, the chain (and past the exit the
                    test) by one thread from shared memory
  8 warps           warps a block (4 blocks an SM)
  16 loads          loads a thread keeps in flight testing the rests
  2 / 8 ahead       chunks a chain loads ahead
  short 8 / 24      the longest range a lane takes alone
  unroll 8 / 16     the chunk's 16-byte reads unrolled 8 or 16 deep (4 as
                    built: the reads a chain issues ahead of its multiplies)
  1 block/SM        the register budget of one block an SM (128 a thread)
  prefetch          each lane's long range's first chunk prefetched to L1
                    before the warp chains the group's long ranges
  consecutive groups  a warp's ranges consecutive (a ROH segment's long runs
                    then fall to one warp)
  groups of 32      32 ranges a warp whatever the count (fewer blocks)

Every variant is held equal to the plain version first, as bit patterns:
at ``selfcheck.roh_cases``' edges and at both launches (the parent at the
launches; at the edges its differing products are counted: a chain that
multiplies two NaNs takes the one its compiler put first). Times: device time of
10 calls captured in a CUDA graph (L2-warm) and one call after a 128 MB
overwrite and read (cold), as chip_smoke.py times kernels; ``--rounds``
rounds, each timing every variant in turn, the order reversed every other
round; the median and each round's. Beside them: the launch's bound (bytes
over 3.35 TB/s), its longest range and longest chain before an exit
(``selfcheck.roh_chain``), and the chain floor (that chain times one
dependent float64 multiply's latency, from a one-thread chain of 2^22
``__dmul_rn``, plus an empty kernel's cold time). Then what the card's
multiply makes of NaN operands: ``__dmul_rn`` and PyTorch's ``*`` on pairs of
NaNs (payloads, signs, signalling) and other values, both orders. Last, one
JSON line with every result. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (VARIANT_BP_PER_RECORD, VARIANT_CHROMS, VARIANT_CHRX,  # noqa: E402
                        h1_floors, load_h1_probe, start_h1_probe)
from ngsbits_tpu_torch.ops import _build, selfcheck  # noqa: E402
from ngsbits_tpu_torch.ops import variants as vops  # noqa: E402

PEAK_BYTES = 3.35e12
OUT = ROOT / "build" / "h1_variants"


def _const(name: str, old: str, new: str) -> tuple[str, str]:
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


_PUSH = ("            if (lane == 0) sh.rest[atomicAdd(&sh.n, 1)] = H1Rest{r, c + 32, e, p};\n"
         "            return;\n")
_CHAIN_NOTE = "// Range r = [s, e], longer than kH1Short, by the warp"
_WARP_REST = [(_PUSH, "            h1_warp_rest(af, r, c + 32, e, p, lane, out);\n"
                      "            return;\n"),
              (_CHAIN_NOTE, """// The rest [q, e] of range r by the warp alone: ballots over kH1Loads
// chunks at a time find the first square that changes p.
__device__ void h1_warp_rest(const double* __restrict__ af, long long r, long long q, long long e,
                             double p, int lane, double* __restrict__ out) {
    while (q <= e) {
        long long first = kH1None;
        for (long long c = q; c <= e && first == kH1None; c += 32 * kH1Loads) {
            double a[kH1Loads];
#pragma unroll
            for (int u = 0; u < kH1Loads; ++u) {
                const long long i = c + 32 * u + lane;
                a[u] = i <= e ? __ldg(af + i) : 1.0;
            }
#pragma unroll
            for (int u = 0; u < kH1Loads; ++u) {
                const long long i = c + 32 * u + lane;
                const unsigned hit = __ballot_sync(0xffffffffu, i <= e &&
                                                   h1_changes(p, __dmul_rn(a[u], a[u])));
                if (hit && first == kH1None) first = c + 32 * u + __ffs(hit) - 1;
            }
        }
        if (first == kH1None) break;
        const double a = __ldg(af + first);
        p = __dmul_rn(p, __dmul_rn(a, a));  // NaN: final
        break;
    }
    if (lane == 0) out[r] = p;
}

""" + _CHAIN_NOTE)]
_KERNEL_NOTE = "// H1: a warp takes `group` ranges a round, strided by the grid's warps"
_END = "// -------------------------------------------------------------- H1 ends"
_THREAD = """__global__ void __launch_bounds__(256)
roh_products_kernel(const double* __restrict__ af, long long m,
                    const long long* __restrict__ ranges, long long k,
                    double* __restrict__ out) {
    for (long long r = blockIdx.x * 256LL + threadIdx.x; r < k; r += gridDim.x * 256LL) {
        const long long s = ranges[2 * r], e = ranges[2 * r + 1];
        if (s < 0 || e >= m) {
            out[r] = __longlong_as_double(0x7FF8000000000000LL);
            continue;
        }
        double p = 1.0;
        long long i = s;
        for (; i <= e && p > 0.0 && p < h1_inf(); ++i) {
            const double a = __ldg(af + i);
            p = __dmul_rn(p, __dmul_rn(a, a));
        }
#pragma unroll 8
        for (; i <= e && p == p; ++i) {
            const double a = __ldg(af + i), sq = __dmul_rn(a, a);
            if (h1_changes(p, sq)) p = __dmul_rn(p, sq);
        }
        out[r] = p;
    }
}

void h1_launch(const double* af, long long m, const long long* ranges, long long k,
               double* out, cudaStream_t stream) {
    const long long cap = static_cast<long long>(ngs::sm_count()) * 8;
    long long blocks = (k + 255) / 256;
    if (blocks > cap) blocks = cap;
    roh_products_kernel<<<static_cast<int>(blocks), 256, 0, stream>>>(af, m, ranges, k, out);
}
"""
_BLOCK = """__global__ void __launch_bounds__(256)
roh_products_kernel(const double* __restrict__ af, long long m,
                    const long long* __restrict__ ranges, long long k,
                    double* __restrict__ out) {
    __shared__ double sq[2048];
    for (long long r = blockIdx.x; r < k; r += gridDim.x) {
        const long long s = ranges[2 * r], e = ranges[2 * r + 1];
        if (s < 0 || e >= m) {
            if (threadIdx.x == 0) out[r] = __longlong_as_double(0x7FF8000000000000LL);
            continue;
        }
        double p = 1.0;
        for (long long c = s; c <= e; c += 2048) {
            const int n = static_cast<int>(e - c + 1 < 2048 ? e - c + 1 : 2048);
            __syncthreads();
            for (int j = threadIdx.x; j < n; j += 256) {
                const double a = __ldg(af + c + j);
                sq[j] = __dmul_rn(a, a);
            }
            __syncthreads();
            if (threadIdx.x == 0) {
                int j = 0;
                for (; j < n && p > 0.0 && p < h1_inf(); ++j) p = __dmul_rn(p, sq[j]);
                for (; j < n && p == p; ++j)
                    if (h1_changes(p, sq[j])) p = __dmul_rn(p, sq[j]);
            }
        }
        if (threadIdx.x == 0) out[r] = p;
    }
}

void h1_launch(const double* af, long long m, const long long* ranges, long long k,
               double* out, cudaStream_t stream) {
    const long long cap = static_cast<long long>(ngs::sm_count()) * 8;
    roh_products_kernel<<<static_cast<int>(k < cap ? k : cap), 256, 0, stream>>>(
        af, m, ranges, k, out);
}
"""
VARIANTS = {
    "as built": [],
    "rest by its warp": _WARP_REST,
    "a thread a range": [(None, _THREAD)],
    "a block a range": [(None, _BLOCK)],
    "8 warps": [_const("kH1Warps", "16", "8"), _const("kH1BlocksPerSm", "2", "4")],
    "16 loads": [_const("kH1Loads", "8", "16")],
    "2 ahead": [_const("kH1Ahead", "4", "2")],
    "8 ahead": [_const("kH1Ahead", "4", "8")],
    "short 8": [_const("kH1Short", "16", "8")],
    "short 24": [_const("kH1Short", "16", "24")],
    "unroll 8": [("#pragma unroll 4  // 4 reads", "#pragma unroll 8  // 4 reads")],
    "unroll 16": [("#pragma unroll 4  // 4 reads", "#pragma unroll 16  // 4 reads")],
    "1 block/SM": [_const("kH1BlocksPerSm", "2", "1")],
    "prefetch": [("            else chain = true;\n",
                  "            else {\n"
                  "                chain = true;  // its first chunk into L1 while others chain\n"
                  "                asm volatile(\"prefetch.global.L1 [%0];\" ::\"l\"(af + s));\n"
                  "                asm volatile(\"prefetch.global.L1 [%0];\" ::\"l\"(af + s + 16));\n"
                  "            }\n")],
    "consecutive groups": [("base + blockIdx.x * kH1Warps + warp, step = warps;",
                            "base + (blockIdx.x * kH1Warps + warp) * group, step = 1;")],
    "groups of 32": [("    long long group = (k + blocks * kH1Warps - 1) / (blocks * kH1Warps);\n",
                      "    blocks = (k + 32 * kH1Warps - 1) / (32 * kH1Warps);\n"
                      "    long long group = 32;\n")],
}


def variant_source(subs: list[tuple[str | None, str]]) -> str:
    """variants.cu with each (old, new) substituted; old None: the H1 kernel
    and its launcher (from its note to the section's end)."""
    text = (_build.CSRC / "variants.cu").read_text()
    for old, new in subs:
        if old is None:
            a, b = text.index(_KERNEL_NOTE), text.index(_END)
            text = text[:a] + new + text[b:]
            continue
        if text.count(old) != 1:
            raise RuntimeError(f"substitution anchor not found once: {old!r}")
        text = text.replace(old, new)
    return text


def _build_all(parent: Path | None) -> tuple[dict[str, ctypes.CDLL], object]:
    """One library per variant (and the parent's), nvcc all at once, and the
    H1 probe; prints ptxas' registers and spills of each one's H1 kernel."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "launch.cuh").write_text((_build.CSRC / "launch.cuh").read_text())
    sources = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        sources[name] = OUT / f"variant{i}.cu"
        sources[name].write_text(variant_source(subs))
    if parent is not None:
        sources["parent"] = parent / "ngsbits_tpu_torch" / "csrc" / "variants.cu"
    libs = {name: OUT / f"variant{i}.so" for i, name in enumerate(sources)}
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", str(libs[name]), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    probe = start_h1_probe(OUT)
    loaded = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        h1 = False
        for line in log.splitlines():
            if "Compiling entry" in line or "Function properties" in line:
                h1 = "roh_products" in line
            elif h1 and ("registers" in line or "spill" in line):
                print(f"  {name}: {line.strip()}")
        lib = ctypes.CDLL(str(libs[name]))
        p = ctypes.c_void_p
        lib.ngs_roh_products.argtypes = [p, ctypes.c_longlong, p, ctypes.c_longlong, p, p]
        lib.ngs_roh_products.restype = ctypes.c_int
        loaded[name] = lib
    return loaded, load_h1_probe(*probe)


def _phase_launches(dev: torch.device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The inputs of the H1 launches of the variants phase's first RohHunter
    run (the raw runs', the final regions'), as it makes them on the card."""
    from ngsbits_tpu_torch.tools import get_tool, roh_hunter
    from ngsbits_tpu_torch.utils import synth
    lengths = {c: synth.GRCH38_LENGTHS[c] for c in VARIANT_CHROMS}
    lengths["chrX"] = VARIANT_CHRX
    OUT.mkdir(parents=True, exist_ok=True)
    vcf = OUT / "wgs.vcf"
    segments = synth.wgs_vcf(vcf, lengths, seed=101,
                             n_records=sum(lengths.values()) // VARIANT_BP_PER_RECORD)
    beds = [OUT / "roh_exclude.bed", OUT / "roh_genes.bed", OUT / "roh_plain.bed"]
    synth.roh_beds(beds[0], beds[1:], lengths, segments, seed=102)
    got = []
    products = roh_hunter.roh_products_into

    def capture(af, ranges, out):
        products(af, ranges, out)
        got.append((af.clone(), ranges.clone()))

    roh_hunter.roh_products_into = capture
    try:
        rc = get_tool("RohHunter")().execute(
            ["-in", str(vcf), "-var_af_keys_vep", "gnomAD_AF,AF", "-exclude", str(beds[0]),
             "-annotate", str(beds[1]), str(beds[2]), "-out", str(OUT / "roh.tsv")])
    finally:
        roh_hunter.roh_products_into = products
    if rc != 0 or len(got) != 2:
        raise RuntimeError(f"RohHunter exited {rc} after {len(got)} H1 launches, not 2")
    vcf.unlink()
    return [(af.to(dev), ranges.to(dev)) for af, ranges in got]


def _calls(libs: dict, af: torch.Tensor, ranges: torch.Tensor) -> dict:
    """{name: (call, check)}: each library's launch into its own output, and
    a check of one launch: the outputs whose bit patterns differ from the
    plain version's."""
    want = torch.empty(ranges.shape[0], dtype=torch.float64, device=af.device)
    vops.roh_products_plain(af, ranges, want)
    calls = {}
    for name, lib in libs.items():
        out = torch.full_like(want, 12345.0)

        def call(lib=lib, out=out, name=name):
            rc = lib.ngs_roh_products(af.data_ptr(), af.shape[0], ranges.data_ptr(),
                                      ranges.shape[0], out.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")

        def check(call=call, out=out):
            out.fill_(12345.0)
            call()
            torch.cuda.synchronize()
            return int((out.view(torch.int64) != want.view(torch.int64)).sum())
        calls[name] = (call, check)
    return calls


NAN_BITS = (0x7FF8000000000000, 0x7FF8000000000123, 0xFFF8000000000000, 0xFFF8000000000077,
            0x7FF4000000000000, 0xFFF0000000000001)


def _nan_probe(probe, dev: torch.device) -> dict:
    """``__dmul_rn`` and PyTorch's ``*`` on the card over pairs of a NaN and
    another value (other NaNs, 0, 2, 1e-300, +inf, -inf), both orders."""
    nans = torch.from_numpy(np.array(NAN_BITS, dtype=np.uint64).view(np.float64))
    others = torch.cat([nans, torch.tensor([0.0, 2.0, 1e-300, float("inf"), -float("inf")],
                                           dtype=torch.float64)])
    a = nans.repeat_interleave(len(others))
    b = others.repeat(len(nans))
    a, b = torch.cat([a, b]).to(dev), torch.cat([b, a]).to(dev)
    mine = torch.empty_like(a)
    if probe.ngs_probe_mul(a.data_ptr(), b.data_ptr(), mine.data_ptr(), a.shape[0],
                           torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("the multiply probe did not launch")
    theirs = a * b
    torch.cuda.synchronize()
    bits = [[v & (2 ** 64 - 1) for v in x.view(torch.int64).cpu().tolist()]
            for x in (a, b, mine, theirs)]
    is_nan = lambda v: v & ~(1 << 63) > 0x7FF0000000000000  # noqa: E731
    quiet = lambda v: v | (1 << 51)  # noqa: E731
    kinds: dict = {}
    for x, y, z in zip(*bits[:3]):
        pair = "two NaNs" if is_nan(x) and is_nan(y) else "a NaN and a value"
        kind = ("the first, quieted" if z == quiet(x) else "the second, quieted"
                if z == quiet(y) else f"{z:016x}")
        kinds.setdefault(pair, {}).setdefault(kind, 0)
        kinds[pair][kind] += 1
    return {"pairs": [tuple(f"{v:016x}" for v in r) for r in zip(*bits)],
            "torch_equals_dmul": bits[2] == bits[3], "results": kinds}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="a checkout of another commit whose H1 to time too")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("h1_variants: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    libs, probe = _build_all(args.parent)
    print(f"built {len(libs)} libraries and the probe in {time.perf_counter() - t0:.1f} s",
          flush=True)
    nan = _nan_probe(probe, dev)
    print("the card's multiply of a NaN and another value (a, b, __dmul_rn(a, b), torch a * b):")
    for row in nan["pairs"]:
        print("  " + " ".join(row))
    print(f"torch's * equals __dmul_rn on every pair: {nan['torch_equals_dmul']}; "
          f"__dmul_rn's results: {nan['results']}", flush=True)
    floors = h1_floors(probe)
    print(f"a dependent float64 multiply {floors['dmul_ns']:.3f} ns ({floors['dmul_cycles']:.2f} "
          f"SM cycles); an empty kernel {floors['launch_ms']:.4f} ms, cold "
          f"{floors['launch_cold_ms']:.4f} ms", flush=True)
    _, edges = selfcheck.roh_cases(dev)[0]
    af_e, ranges_e = (x for x in edges.inputs)
    for name, (_, check) in _calls(libs, af_e, ranges_e).items():
        differ = check()
        if differ and name != "parent":
            raise AssertionError(f"{name}: differs from the plain version at the edges")
        if differ:  # its chain may multiply two NaNs, in the order its compiler chose
            print(f"parent: {differ} of the edges' {ranges_e.shape[0]} products differ from "
                  f"the plain version's", flush=True)
    print("every variant equals the plain version at the edges", flush=True)
    t0 = time.perf_counter()
    launches = _phase_launches(dev)
    print(f"the variants phase's first RohHunter run in {time.perf_counter() - t0:.1f} s",
          flush=True)
    results = []
    for label, (af, ranges) in zip(("raw runs", "final regions"), launches):
        case = selfcheck.roh_products_case(af, ranges)
        chain = selfcheck.roh_chain(af.cpu().numpy(), ranges.cpu().numpy())
        bound_ms = case.bytes / PEAK_BYTES * 1e3
        floor_ms = chain["longest_chain"] * floors["dmul_ns"] * 1e-6 + floors["launch_cold_ms"]
        launch = (f"{label}: {ranges.shape[0]} ranges over {af.shape[0]} markers, "
                  f"{case.bytes // 8 - 3 * ranges.shape[0]} covered, longest range "
                  f"{chain['longest_range']}, longest chain to exit {chain['longest_chain']}")
        print(f"{launch}; bound {bound_ms:.4f} ms, chain floor {floor_ms:.4f} ms", flush=True)
        calls = _calls(libs, af, ranges)
        for name, (_, check) in calls.items():
            if check():
                raise AssertionError(f"{name}: {label}: differs from the plain version")
        warm: dict = {name: [] for name in calls}
        cold: dict = {name: [] for name in calls}
        for k in range(args.rounds):
            for name in (list(calls) if k % 2 == 0 else list(reversed(calls))):
                warm[name].append(selfcheck.device_ms(calls[name][0]))
                cold[name].append(selfcheck.cold_ms(calls[name][0]))
        for name in calls:
            got = dict(launch=label, variant=name, ms=statistics.median(warm[name]),
                       warm_runs_ms=warm[name], cold_ms=statistics.median(cold[name]),
                       cold_runs_ms=cold[name], bound_ms=bound_ms, chain_floor_ms=floor_ms,
                       **chain)
            print(f"{label}: {name:17s} device {got['ms']:.4f} ms ("
                  + ", ".join(f"{w:.4f}" for w in warm[name]) + f"), cold {got['cold_ms']:.4f} "
                  "ms (" + ", ".join(f"{c:.4f}" for c in cold[name]) + f"); of the cold time "
                  f"the bound {bound_ms / got['cold_ms']:.1%}, the chain floor "
                  f"{floor_ms / got['cold_ms']:.1%}", flush=True)
            results.append(got)
    print(json.dumps({"h1_variants": results, "floors": floors,
                      "nan_probe": {k: v for k, v in nan.items() if k != "pairs"}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
