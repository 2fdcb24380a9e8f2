#!/usr/bin/env python3
"""V1 (VariantQC's record classification) beside variants of itself, timed on the card.

    python3 scripts/v1_variants.py [--parent DIR] [--rounds 3] [--sections]

Builds variants of ``ngsbits_tpu_torch/csrc/variants.cu`` under
build/v1_variants/ (one nvcc per variant, all at once), each a copy of the
source with checked text substitutions, and times ``ngs_variant_classify``
of each at the two launches of the variants phase of ``chip_smoke.py``: its
VCF (``synth.wgs_vcf``, seed 101, 551,069 records over chr1, chr2 and chrX's
first 50 Mb), parsed and packed as VariantQC packs it, with ``-ignore_filter``
(every record counts) and with the FILTER test. With ``--parent DIR`` (a
checkout of another commit, e.g. ``git archive HEAD~1 | tar -x -C
build/parent``) that commit's variants.cu is built and timed too, as
``parent``.

  as built        a warp a record, its chunks in 512-byte steps, each lane's
                  16-byte load one step ahead in a register, staged into a
                  ring of four slots in shared memory; the offsets of 32
                  records a warp in one pass; 3 blocks an SM
  bulk copies     the step's chunks copied into the ring's slot by one
                  cp.async.bulk a step (lane 0), completing on an mbarrier a
                  slot, one step ahead: no register holds the next step
  half a warp     16 lanes a record, 256-byte steps, two records a warp at
                  once (groups of 16 records)
  one record a warp   the offsets of one record staged at a time (groups of 1)
  2, 4, 6 blocks/SM   the grid's cap and __launch_bounds__
  ablations (counts wrong, not checked): loads only (the steps land, nothing
                  is evaluated), no INFO scan (INFO's masks skipped), empty
                  kernel (the launch of a kernel that returns at once)

With ``--sections`` a copy of the kernel as built whose warps time their
sections with clock64() (lane 0 adds each section's cycles into shared
memory; the launch returns the sums over all warps in place of the counts)
runs once at each launch, and the script prints each section's share of the
warps' cycles: the group's set-up (offsets, FILTER), landing a step and
issuing the next one's loads, INFO (its keys and the CSQ value within it),
REF's and ALT's bytes, the FORMAT and sample copy and the group's end (a
lane a record). The shares are of cycles that warps spend, stalls included.

Every variant but the ablations is held equal to the plain version first:
at both launches, at ``selfcheck.VARIANT_EDGES`` and at
``selfcheck.variant_seams()``, each with and without the FILTER test.

Times: device time of 10 calls captured in a CUDA graph (L2-warm; the
launch's 233.5 MB of fields do not fit the L2) and one call after a 128 MB
overwrite and read (cold), as chip_smoke.py times kernels; ``--rounds``
rounds, each timing every variant in turn (warm, then cold), the order
reversed every other round; the median and each round's. Bound: the bytes
the counts need (``selfcheck.variant_needed_bytes``) and the offsets they
need, read once, over 3.35 TB/s. Prints each variant's ptxas line, one line
per variant and launch and, last, one JSON line with every result. Needs a
CUDA device.
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

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import VARIANT_BP_PER_RECORD, VARIANT_CHROMS, VARIANT_CHRX  # noqa: E402
from ngsbits_tpu_torch.ops import _build, selfcheck  # noqa: E402
from ngsbits_tpu_torch.ops import variants as vops  # noqa: E402

PEAK_BYTES = 3.35e12
OUT = ROOT / "build" / "v1_variants"


def _const(name: str, old: str, new: str) -> tuple[str, str]:
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


_STAGE = """struct Stage {
    unsigned char* ring;
    uint4 next;

    __device__ explicit Stage(unsigned char* r) : ring(r), next(make_uint4(0, 0, 0, 0)) {}

    // Starts loading chunks [first, first + loaded) for step `seq` of the team.
    __device__ __forceinline__ void issue(const uint4* chunks, long long first, int loaded,
                                          unsigned seq, int lane) {
        (void)seq;
        next = lane < loaded ? load_once(chunks + first + lane) : make_uint4(0, 0, 0, 0);
    }
    // Puts step `seq` into its slot; the team synchronises before reading it.
    __device__ __forceinline__ void land(unsigned seq, int lane) {
        *reinterpret_cast<uint4*>(ring + (seq & (kSlots - 1)) * kStep + 16 * lane) = next;
    }
};"""
# one bulk copy a step into the ring's slot, an mbarrier a slot
_BULK_STAGE = """struct Stage {
    unsigned char* ring;
    unsigned bars;  // the team's kSlots mbarriers (shared addresses)

    __device__ Stage(unsigned char* r, unsigned long long* b, int lane)
        : ring(r), bars(static_cast<unsigned>(__cvta_generic_to_shared(b))) {
        if (lane == 0) {
            for (int k = 0; k < kSlots; ++k)
                asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\\n" ::"r"(bars + 8 * k)
                             : "memory");
            asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
        }
        __syncwarp();
    }

    __device__ __forceinline__ void issue(const uint4* chunks, long long first, int loaded,
                                          unsigned seq, int lane) {
        if (lane != 0) return;
        const unsigned bar = bars + 8 * (seq & (kSlots - 1));
        const unsigned bytes = 16u * static_cast<unsigned>(loaded);
        asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n" ::"r"(bar),
                     "r"(bytes) : "memory");
        if (bytes)
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                " [%0], [%1], %2, [%3];\\n"
                ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(
                      ring + (seq & (kSlots - 1)) * kStep))),
                  "l"(chunks + first), "r"(bytes), "r"(bar)
                : "memory");
    }
    __device__ __forceinline__ void land(unsigned seq, int lane) {
        (void)lane;
        const unsigned bar = bars + 8 * (seq & (kSlots - 1)), parity = (seq / kSlots) & 1u;
        unsigned done = 0;
        while (!done)
            asm volatile(
                "{\\n .reg .pred p;\\n"
                " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
                " selp.u32 %0, 1, 0, p;\\n}\\n"
                : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
};"""
_BULK = [(_STAGE, _BULK_STAGE),
         ("    __shared__ unsigned s_counts[kCounters];\n",
          "    __shared__ unsigned s_counts[kCounters];\n"
          "    __shared__ unsigned long long s_bar[kTeams][kSlots];\n"),
         ("    Stage stage(ring);\n", "    Stage stage(ring, s_bar[team_id], lane);\n")]
_STEP = ("            r.step(s, ring, static_cast<int>(seq & (kSlots - 1)) * kStep, "
         "s_tail[team_id][i], t);\n")
_INFO = "(!(csq_found && rs_found) || csq_open || rs_pending)) {"
_ABLATIONS = {"loads only", "no INFO scan", "empty kernel"}
VARIANTS = {
    "as built": [],
    "bulk copies": _BULK,
    "half a warp": [_const("kLanes", "32", "16"), _const("kGroup", "32", "16")],
    "one record a warp": [_const("kGroup", "32", "1")],
    "2 blocks/SM": [_const("kV1BlocksPerSm", "3", "2")],
    "4 blocks/SM": [_const("kV1BlocksPerSm", "3", "4")],
    "6 blocks/SM": [_const("kV1BlocksPerSm", "3", "6")],
    "loads only": [(_STEP, "            count += ring[(seq & (kSlots - 1)) * kStep + 16 * lane];\n")],
    "no INFO scan": [(_INFO, _INFO.replace(")) {", ") && n < 0) {"))],
    "empty kernel": [("    if (threadIdx.x < kCounters) s_counts[threadIdx.x] = 0;\n",
                      "    if (n > 0) return;\n"
                      "    if (threadIdx.x < kCounters) s_counts[threadIdx.x] = 0;\n")],
}


SECTIONS = ("group", "land", "INFO", "INFO keys", "INFO value", "taps", "FORMAT copy",
            "group end", "total")
def _sections() -> list[tuple[str, str]]:
    """As built, each of SECTIONS timed by clock64(); out[k] gets section k's
    cycles summed over the warps (the counts are not computed)."""
    return [
        ("// The lanes that take a record: a warp's kLanes lanes from `base`.\n",
         "__shared__ unsigned long long* s_sections[kTeams];\n"
         "__device__ __forceinline__ void section(int k, long long cycles) {\n"
         "    if (threadIdx.x % kLanes == 0) s_sections[threadIdx.x / kLanes][k] += cycles;\n"
         "}\n\n// The lanes that take a record: a warp's kLanes lanes from `base`.\n"),
        ("    __shared__ unsigned s_counts[kCounters];\n",
         "    __shared__ unsigned s_counts[kCounters];\n"
         "    __shared__ unsigned long long s_cycles[kTeams][9];\n"),
        ("    const uint4* chunks = reinterpret_cast<const uint4*>(data);\n",
         "    const uint4* chunks = reinterpret_cast<const uint4*>(data);\n"
         "    if (lane < 9) s_cycles[team_id][lane] = 0;\n"
         "    s_sections[team_id] = s_cycles[team_id];\n    __syncwarp();\n"
         "    const long long k_t0 = clock64();\n"),
        ("        const int cnt = static_cast<int>(hi - g < kGroup ? hi - g : kGroup);\n",
         "        const long long t0 = clock64();\n"
         "        const int cnt = static_cast<int>(hi - g < kGroup ? hi - g : kGroup);\n"),
        ("        if (!take) continue;\n", "        section(0, clock64() - t0);\n"
         "        if (!take) continue;\n"),
        ("            stage.land(seq, lane);\n",
         "            const long long t1 = clock64();\n            stage.land(seq, lane);\n"),
        ("            t.sync();  // the step's slot is whole\n",
         "            t.sync();  // the step's slot is whole\n            section(1, clock64() - t1);\n"),
        ("        if (s0 <= i1 && s1 > i0 && (!(csq_found",
         "        const long long t2 = clock64();\n        if (s0 <= i1 && s1 > i0 && (!(csq_found"),
        ("            if (!(csq_found && rs_found)) info_keys(w, o, s0, ring, sb, any_semis, t);\n",
         "            const long long t3 = clock64();\n"
         "            if (!(csq_found && rs_found)) info_keys(w, o, s0, ring, sb, any_semis, t);\n"
         "            section(3, clock64() - t3);\n"),
        ("            if (csq_open) csq_value(w, v, o, s0, s1, any_semis, t);\n        }\n",
         "            const long long t4 = clock64();\n"
         "            if (csq_open) csq_value(w, v, o, s0, s1, any_semis, t);\n"
         "            section(4, clock64() - t4);\n        }\n        section(2, clock64() - t2);\n"
         "        const long long t5 = clock64();\n"),
        ("        // FORMAT and the sample's first kTail bytes\n",
         "        section(5, clock64() - t5);\n        const long long t6 = clock64();\n"
         "        // FORMAT and the sample's first kTail bytes\n"),
        ("                if (p < t1 && p >= s0 && p < s1) tail[j + t.lane] = at(p);\n"
         "            }\n        }\n",
         "                if (p < t1 && p >= s0 && p < s1) tail[j + t.lane] = at(p);\n"
         "            }\n        }\n        section(6, clock64() - t6);\n"),
        ("        t.sync();  // the tails are whole\n",
         "        const long long t7 = clock64();\n        t.sync();  // the tails are whole\n"),
        ("            if (lane == k) count += c;\n        }\n    }\n",
         "            if (lane == k) count += c;\n        }\n        section(7, clock64() - t7);\n"
         "    }\n"),
        ("    if (lane < kCounters && count) atomicAdd(&s_counts[lane], count);\n"
         "    __syncthreads();\n    if (threadIdx.x < kCounters && s_counts[threadIdx.x])\n"
         "        atomicAdd(out + threadIdx.x, static_cast<unsigned long long>(s_counts[threadIdx.x]));\n",
         "    section(8, clock64() - k_t0);\n    __syncwarp();\n"
         "    if (lane < 9) atomicAdd(out + lane, s_cycles[team_id][lane]);\n"),
    ]


def variant_source(subs: list[tuple[str, str]]) -> str:
    text = (_build.CSRC / "variants.cu").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"substitution anchor not found once: {old!r}")
        text = text.replace(old, new)
    return text


def _build_all(parent: Path | None, sections: bool) -> dict[str, ctypes.CDLL]:
    """One library per variant (the parent's, and with `sections` the timed
    copy's), nvcc all at once; prints ptxas' registers and spills of each
    one's V1 kernel."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "launch.cuh").write_text((_build.CSRC / "launch.cuh").read_text())
    sources = {}
    for i, (name, subs) in enumerate({**VARIANTS, **({"sections": _sections()} if sections
                                                     else {})}.items()):
        sources[name] = OUT / f"variant{i}.cu"
        sources[name].write_text(variant_source(subs))
    if parent is not None:
        sources["parent"] = parent / "ngsbits_tpu_torch" / "csrc" / "variants.cu"
    libs = {name: OUT / f"variant{i}.so" for i, name in enumerate(sources)}
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", str(libs[name]), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    loaded = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines, v1 = log.splitlines(), False
        for line in lines:
            if "Compiling entry" in line or "Function properties" in line:
                v1 = "variant_classify" in line
            elif v1 and ("registers" in line or "spill" in line):
                print(f"  {name}: {line.strip()}")
        lib = ctypes.CDLL(str(libs[name]))
        p = ctypes.c_void_p
        lib.ngs_variant_classify.argtypes = [p, p, ctypes.c_longlong, ctypes.c_int, p, p]
        lib.ngs_variant_classify.restype = ctypes.c_int
        loaded[name] = lib
    return loaded


def _phase_launch(dev: torch.device):
    """The variants phase's VCF, parsed and packed as VariantQC packs it."""
    from ngsbits_tpu_torch.io.vcf import VcfFile
    from ngsbits_tpu_torch.utils import synth
    lengths = {c: synth.GRCH38_LENGTHS[c] for c in VARIANT_CHROMS}
    lengths["chrX"] = VARIANT_CHRX
    OUT.mkdir(parents=True, exist_ok=True)
    vcf = OUT / "wgs.vcf"
    synth.wgs_vcf(vcf, lengths, seed=101, n_records=sum(lengths.values()) // VARIANT_BP_PER_RECORD)
    v = VcfFile.from_file(str(vcf))
    first = [s[0] if s else b"" for s in v.samples]
    data, offsets = vops.pack_fields([v.refs, v.alts, v.filters, v.infos, v.format_keys, first])
    vcf.unlink()
    return data.to(dev), offsets.to(dev)


def _calls(libs: dict, data: torch.Tensor, offsets: torch.Tensor, filter_: bool) -> dict:
    """{name: (call, check or None)}: each library's launch into its own
    counters, and a check of one launch's counts against the plain version."""
    n = (offsets.shape[0] - 1) // vops.FIELDS
    want = torch.zeros(len(vops.COUNTERS), dtype=torch.int64, device=data.device)
    vops.variant_classify_plain(data, offsets, filter_, want)
    calls = {}
    for name, lib in libs.items():
        out = torch.zeros(len(vops.COUNTERS), dtype=torch.int64, device=data.device)

        def call(lib=lib, out=out, name=name):
            rc = lib.ngs_variant_classify(data.data_ptr(), offsets.data_ptr(), n, int(filter_),
                                          out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")

        def check(call=call, out=out):
            out.zero_()
            call()
            torch.cuda.synchronize()
            return torch.equal(out, want)
        calls[name] = (call, None if name in _ABLATIONS else check)
    return calls


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="a checkout of another commit whose V1 to time too")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--sections", action="store_true",
                    help="also time the sections of the kernel as built (clock64)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("v1_variants: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    libs = _build_all(args.parent, args.sections)
    timed = libs.pop("sections", None)
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    for label, cols in (("edges", selfcheck.variant_edge_columns()),
                        ("seams", selfcheck.variant_seams())):
        data, offsets = (x.to(dev) for x in vops.pack_fields(cols))
        for filter_ in (True, False):
            for name, (_, check) in _calls(libs, data, offsets, filter_).items():
                if check is not None and not check():
                    raise AssertionError(f"{name}: {label}, filter {filter_}: differs from the "
                                         f"plain version")
    print("every variant equals the plain version at the edges and the seams, with and "
          "without the FILTER test", flush=True)
    t0 = time.perf_counter()
    data, offsets = _phase_launch(dev)
    n = (offsets.shape[0] - 1) // vops.FIELDS
    print(f"the variants phase's VCF: {n} records, {int(offsets[-1])} bytes of fields "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    results = []
    for filter_ in (False, True):
        launch = f"{n} records, {'the FILTER test' if filter_ else '-ignore_filter'}"
        needed, counted = selfcheck.variant_needed_bytes(data, offsets, filter_)
        offset_bytes = 8 * (2 * n + 4 * counted if filter_ else offsets.shape[0])
        bound_ms = (needed + offset_bytes + 72) / PEAK_BYTES * 1e3
        if timed is not None:
            cycles = torch.zeros(len(vops.COUNTERS), dtype=torch.int64, device=dev)
            timed.ngs_variant_classify(data.data_ptr(), offsets.data_ptr(), n, int(filter_),
                                       cycles.data_ptr(), torch.cuda.current_stream().cuda_stream)
            total = cycles.tolist()
            shares = {k: v / total[-1] for k, v in zip(SECTIONS, total)}
            print(f"{launch}: sections, shares of the warps' cycles: "
                  + ", ".join(f"{k} {v:.1%}" for k, v in shares.items()), flush=True)
            results.append(dict(launch=launch, variant="sections", shares=shares, cycles=total))
        calls = _calls(libs, data, offsets, filter_)
        for name, (_, check) in calls.items():
            if check is not None and not check():
                raise AssertionError(f"{name}: {launch}: differs from the plain version")
        warm: dict = {name: [] for name in calls}
        cold: dict = {name: [] for name in calls}
        for k in range(args.rounds):
            for name in (list(calls) if k % 2 == 0 else list(reversed(calls))):
                warm[name].append(selfcheck.device_ms(calls[name][0]))
                cold[name].append(selfcheck.cold_ms(calls[name][0]))
        for name, (_, check) in calls.items():
            got = dict(launch=launch, variant=name, ms=statistics.median(warm[name]),
                       warm_runs_ms=warm[name], cold_ms=statistics.median(cold[name]),
                       cold_runs_ms=cold[name], bound_ms=bound_ms, needed_bytes=needed,
                       counted=counted)
            print(f"{launch}: {name:18s} device {got['ms']:.4f} ms ("
                  + ", ".join(f"{w:.4f}" for w in warm[name]) + f"), cold {got['cold_ms']:.4f} ms ("
                  + ", ".join(f"{c:.4f}" for c in cold[name]) + f"), bound {bound_ms:.4f} ms "
                  f"({bound_ms / got['cold_ms']:.1%} of it cold)"
                  + (" [ablation, not checked]" if check is None else ""), flush=True)
            results.append(got)
    print(json.dumps({"v1_variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
