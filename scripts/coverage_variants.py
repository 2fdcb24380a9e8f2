#!/usr/bin/env python3
"""C2 (the coverage prefix sum), R1 (region sums), R2 (threshold runs) and C1's record form beside variants of themselves, timed on the card.

    python3 scripts/coverage_variants.py [--kernel finalize|sums|runs|records] [--parent DIR]

Builds variants of ``ngsbits_tpu_torch/csrc/coverage.cu`` under
build/coverage_variants/ (one nvcc per variant, all at once), each a copy of
the source with checked text substitutions, and times C2
(``--kernel finalize``, the default: the dense mode alone and the histogram
mode), R1 (``--kernel sums``: its memset and kernel), R2 (``--kernel
runs``: both passes, without the fetch of the totals between them) or C1's
record form (``--kernel records``). Every variant's
outputs are held equal to the plain version first. With ``--parent DIR`` (a
checkout of another commit, e.g. ``git archive HEAD~1 | tar -x -C
build/parent``), that commit's coverage.cu is built and its kernel timed
too, as ``parent``, with the scratch and arguments that source takes (a
``tile_sums`` buffer for C2 and a scan buffer for R2 before the single-pass
designs; C1's record form only from a commit that has it).

Shapes, as the coverage tools and MappingQC hand them to the kernels:

  C2  the dense mode at chr1's whole box (248,956,422 positions, coverage
      about 30 with random steps, as tests/test_torch_kernels_gpu.py makes
      it) and at the exome's largest flattened box (773,011 positions, depth
      about 24); the histogram mode at MappingQC's launch (span 13,861,233,
      step 5, hist_max 599, 120 bins, half depth 12, depth about 24)
  R1  chr1's box as one region; the exome's largest box as BedCoverage
      hands it over (3,574 unmerged regions of 100-400 bp over its 773,011
      positions, depth about 24); a dense panel of 250,000 regions of
      1-200 bp over 60,000,017 positions (``selfcheck.r1_regions``: tiles
      of 8,192 positions with many pieces each)
  R2  chr1's box as one region (cutoff 29, about 30 everywhere) and the
      exome's largest box: 2,728 touching regions over its 773,011
      positions (cutoff 20)

  as built       the source unchanged (C2: tiles of 8192 positions, 256
                 threads, 5 blocks an SM; R2: 8 mask words of loads in flight)
  C2: divide each  the histogram's bin by an integer division (as built: a
                 multiply-high by the step's reciprocal and one correction)
  C2: cp.async   the tile staged by cp.async (as built: 16-byte loads into
                 registers, then stores to shared memory)
  C2: block look-back  the block reads 256 status words a step, a thread
                 each (as built: warp 0 reads 32 a step)
  C2: wait for all 32  a look-back step waits until all 32 tiles it read
                 have published (as built: those up to the nearest
                 inclusive prefix)
  C2 ablations (outputs wrong, not checked): no look-back (each tile takes
                 0 as the sum before it), no bin adds (no shared atomics)
  C2: no block cap, 4 blocks/SM, 6 blocks/SM   register caps by
                 __launch_bounds__ (as built: 5 blocks of 256 threads an SM)
  C2: 128 threads, 512 threads   tiles of 4096 and 16,384 positions (10
                 and 2 blocks an SM)
  R1: tiles of 8192              every tile 8,192 positions, however
                 little the work (the first design's tiling; as built: as many
                 tiles as the grid has warps, 32 to 8,192 positions each)
  R1: no lane pieces             every piece summed by the whole warp (as
                 built: pieces under 32 positions a lane each)
  R1: lane pieces under 128      pieces under 128 positions a lane each
  R1: unroll 8                   the warp's 16-byte loads unrolled 8 times
                 (as built: 4)
  R1: no block cap               __launch_bounds__ without a count of blocks
                 (as built: 4 blocks an SM, as the grid has; 64 registers)
  R1: 6 blocks/SM, 8 blocks/SM   a grid of 6 or 8 blocks an SM with the
                 register cap for as many (smaller tiles where the work is
                 small, more warps resident)
  R1 ablations (outputs wrong, not checked): no memset (the launcher's
                 clearing of the sums), empty kernel (a memset and a launch
                 that returns at once: the floor of a launcher call)
  R2: batch 4, batch 16          mask words of loads in flight a warp
  R2: 6 blocks/SM, 8 blocks/SM   register caps by __launch_bounds__
  torch.cumsum   C2's yardstick: one PyTorch call for the dense coverage
  C1 records: one batch as the exome BAM's pass hands it (65,536 sorted
                 records of 151 bp, 53,500 kept, most near 2,163 panel
                 blocks of a chromosome's 8 Mb; qualities drawn a base from
                 Q2/12/23/37 as utils/synth.py writes them), with
                 -min_baseq 20 and without (a thread a record, unchanged
                 by the variants)
  records: steps 1, steps 8      32-base steps whose quality bytes a lane
                 loads before testing them (as built: 5)
  records: no block fast path    a binary search at every boundary (as
                 built: an op in one block maps its boundaries by offset)
  records: a thread a record     -min_baseq's records walked a thread each,
                 the bases of an op one at a time (as built: a warp a record)
  records ablations (outputs wrong, not checked): no atomics, no quality
                 loads (every base with SEQ counts)

Times: device time of 10 calls captured in a CUDA graph (L2-warm) and one
call after a 128 MB overwrite and read (cold), as chip_smoke.py times
kernels, each three times; the median and the three. Bound: C2 reads the
difference array once and writes its outputs once; R2 reads 4 bytes a
region position, the regions' starts and offsets, and writes the totals and
12 bytes a run; C1's record form what ``selfcheck.coverage_add_records_case``
counts. Prints one line per variant and shape and, last, one JSON line with
every result. Needs a CUDA device.
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

PEAK_BYTES = 3.35e12
OUT = ROOT / "build" / "coverage_variants"
CHR1 = 248_956_422
EXOME_BOX, EXOME_REGIONS = 773_011, 2_728
MQ_SPAN = 13_861_233

_BIN = """            const unsigned u = static_cast<unsigned>(cov);
            unsigned q = __umulhi(u, magic);
            q += u - q * static_cast<unsigned>(step) >= static_cast<unsigned>(step);
            const int b = u < cut ? min(static_cast<int>(q), bins - 1) : -1;
"""
_DIVIDE = """            int b = -1;
            if (cov >= 0) {
                b = cov / step;
                if (b >= bins) b = cov <= hist_max ? bins - 1 : -1;
            }
"""
_STAGED_LOADS = """        int4 x[kPerThread / 4];
#pragma unroll
        for (int k = 0; k < kPerThread / 4; ++k) x[k] = __ldg(src + lane + 32 * k);
#pragma unroll
        for (int k = 0; k < kPerThread / 4; ++k) stage[swizzle(lane + 32 * k)] = x[k];
"""
_CP_ASYNC = """#pragma unroll
        for (int k = 0; k < kPerThread / 4; ++k) {
            const unsigned to = static_cast<unsigned>(
                __cvta_generic_to_shared(stage + swizzle(lane + 32 * k)));
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                         ::"r"(to), "l"(src + lane + 32 * k) : "memory");
        }
        asm volatile("cp.async.wait_all;" ::: "memory");
"""
_C2_BOUNDS = "__global__ void __launch_bounds__(kTileThreads, 5)\ncoverage_scan_kernel("


def _function(name: str) -> str:
    """The text of a device function of coverage.cu, its signature's line to
    its closing brace."""
    text = (_build.CSRC / "coverage.cu").read_text()
    start = text.index(f"__device__ __forceinline__ int {name}(")
    return text[start:text.index("\n}\n", start) + 3]


_BLOCK_LOOK_BACK = """__device__ __forceinline__ int look_back(u64* status, int tile, int aggregate, int* shared) {
    constexpr int kWarps = kTileThreads / 32;
    __shared__ unsigned flags[2 * kWarps];
    __shared__ int partial[kWarps];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int before = 0;
    for (int end = tile - 1;; end -= kTileThreads) {
        const int j = end - static_cast<int>(threadIdx.x);
        u64 s = j >= 0 ? load_acquire(status + j) : kInclusive;
        int nearest;
        for (;;) {
            const unsigned waiting = __ballot_sync(kFull, (s >> 32) == 0);
            const unsigned inclusive = __ballot_sync(kFull, (s & kInclusive) != 0);
            __syncthreads();
            if (lane == 0) {
                flags[warp] = waiting;
                flags[kWarps + warp] = inclusive;
            }
            __syncthreads();
            nearest = kTileThreads;
            bool wait = false;
            for (int w = 0; w < kWarps; ++w) {
                const unsigned inc = flags[kWarps + w];
                wait |= (flags[w] & (inc ? (inc & (0u - inc)) * 2 - 1 : kFull)) != 0;
                if (inc) {
                    nearest = 32 * w + __ffs(inc) - 1;
                    break;
                }
            }
            if (!wait) break;
            if ((s >> 32) == 0) s = load_acquire(status + j);
        }
        const int v = static_cast<int>(threadIdx.x) <= nearest
                          ? static_cast<int>(static_cast<unsigned>(s)) : 0;
        before += block_sum(v, partial);
        if (nearest < kTileThreads) break;
    }
    if (threadIdx.x == 0)
        store_release(status + tile, kInclusive | static_cast<unsigned>(before + aggregate));
    return before;
}
"""
_NEEDED = "const unsigned needed = inclusive ? (inclusive & (0u - inclusive)) * 2 - 1 : kFull;"
_ABLATIONS = {"no look-back", "no bin adds"}  # outputs wrong: timed, not checked
FINALIZE_VARIANTS = {
    "as built": [],
    "divide each": [(_BIN, _DIVIDE)],
    "cp.async": [(_STAGED_LOADS, _CP_ASYNC)],
    "block look-back": [(_function("look_back"), _BLOCK_LOOK_BACK)],
    "wait for all 32": [(_NEEDED, "const unsigned needed = kFull;")],
    "no block cap": [(_C2_BOUNDS, _C2_BOUNDS.replace("(kTileThreads, 5)", "(kTileThreads)"))],
    "4 blocks/SM": [(_C2_BOUNDS, _C2_BOUNDS.replace("(kTileThreads, 5)", "(kTileThreads, 4)"))],
    "6 blocks/SM": [(_C2_BOUNDS, _C2_BOUNDS.replace("(kTileThreads, 5)", "(kTileThreads, 6)"))],
    "no look-back": [("(tile == 0 ? kInclusive : kAggregate)", "kInclusive"),
                     ("before = look_back(status, tile, aggregate, &sh_before);", "before = 0;")],
    "no bin adds": [("                if (run_bin >= 0) atomicAdd(sh_hist + run_bin, run);\n",
                     "                if (run_bin == 0x7fffffff) sh_hist[0] = run;\n")],
    # the same registers a thread: 1,280 threads an SM
    "128 threads": [("constexpr int kTileThreads = 256;", "constexpr int kTileThreads = 128;"),
                    (_C2_BOUNDS, _C2_BOUNDS.replace("(kTileThreads, 5)", "(kTileThreads, 10)"))],
    "512 threads": [("constexpr int kTileThreads = 256;", "constexpr int kTileThreads = 512;"),
                    (_C2_BOUNDS, _C2_BOUNDS.replace("(kTileThreads, 5)", "(kTileThreads, 2)"))],
}
_R2_BOUNDS = "__global__ void __launch_bounds__(kRegionThreads)\nruns_kernel("
RUNS_VARIANTS = {
    "as built": [],
    "6 blocks/SM": [(_R2_BOUNDS, _R2_BOUNDS.replace("(kRegionThreads)", "(kRegionThreads, 6)"))],
    "8 blocks/SM": [(_R2_BOUNDS, _R2_BOUNDS.replace("(kRegionThreads)", "(kRegionThreads, 8)"))],
    "batch 4": [("constexpr int kRunBatch = 8;", "constexpr int kRunBatch = 4;")],
    "batch 16": [("constexpr int kRunBatch = 8;", "constexpr int kRunBatch = 16;")],
}
_STEPS = "constexpr int kMatchSteps = 5;"
_INSIDE = "const bool inside = j < g.n && __ldg(g.bs + j) <= a && a + len <= __ldg(g.be + j);"
_EVENT = "if (d != 0) atomicAdd(diff + (inside ? at + i : g.index(a + i)), d);"
_C2_HEADER = "// ---------------------------------------------------------------------------\n// C2\n"
_LANE_KERNEL = """// -min_baseq with a thread a record: its ops in turn, the bases of an M, = or
// X op one at a time (unrolled), a run's boundaries added when it closes
__global__ void __launch_bounds__(kAddThreads)
coverage_records_lane_kernel(const int* __restrict__ pos, const int* __restrict__ keep,
                             const long long* __restrict__ cigar_off,
                             const unsigned* __restrict__ cigar,
                             const long long* __restrict__ qual_off,
                             const unsigned char* __restrict__ qual, int r0, int r1, int ref,
                             int min_baseq, Blocks g, int* __restrict__ diff) {
    const long long stride = static_cast<long long>(gridDim.x) * kAddThreads;
    for (long long r = r0 + static_cast<long long>(blockIdx.x) * kAddThreads + threadIdx.x;
         r < r1; r += stride) {
        if (__ldg(keep + r) != ref) continue;
        const long long c_end = __ldg(cigar_off + r + 1);
        const long long q0 = __ldg(qual_off + r);
        const long long n = __ldg(qual_off + r + 1) - q0;
        const unsigned char* q = qual + q0;
        long long x = __ldg(pos + r), qi = 0;
        for (long long c = __ldg(cigar_off + r); c < c_end; ++c) {
            const unsigned w = __ldg(cigar + c);
            const unsigned op = w & 0xF;
            const long long len = w >> 4;
            if (((kMatchOps >> op) & 1) && len > 0) {
                const int j = g.find(x);
                const bool inside = j < g.n && __ldg(g.bs + j) <= x && x + len <= __ldg(g.be + j);
                if (inside || g.index(x, j) != g.index(x + len)) {
                    const int at = inside ? static_cast<int>(__ldg(g.off + j) + x - __ldg(g.bs + j)) : 0;
                    const int m = static_cast<int>(len);
                    const long long left = n - qi;
                    const int avail = left <= 0 ? 0 : (left < m ? static_cast<int>(left) : m);
                    const unsigned char* qp = q + (qi < n ? qi : n);
                    int start = -1;
#pragma unroll 8
                    for (int i = 0; i <= m; ++i) {
                        const bool counts = i < m && (i < avail ? static_cast<int>(__ldg(qp + i)) : 0xFF) >= min_baseq;
                        if (counts && start < 0) {
                            start = i;
                        } else if (!counts && start >= 0) {
                            atomicAdd(diff + (inside ? at + start : g.index(x + start)), 1);
                            atomicAdd(diff + (inside ? at + i : g.index(x + i)), -1);
                            start = -1;
                        }
                    }
                }
            } else if (op == 2 || op == 3) {
                add_run(g, x, x + len, diff);
            }
            if ((kRefOps >> op) & 1) x += len;
            if ((kQueryOps >> op) & 1) qi += len;
        }
    }
}

"""
_BASEQ_LAUNCH = "coverage_records_baseq_kernel<<<add_grid(32 * n), kAddThreads, 0, s>>>("
RECORDS_VARIANTS = {
    "as built": [],
    "steps 1": [(_STEPS, _STEPS.replace("5", "1"))],
    "steps 8": [(_STEPS, _STEPS.replace("5", "8"))],
    "no block fast path": [(_INSIDE, "const bool inside = false;")],
    "a thread a record": [(_C2_HEADER, _LANE_KERNEL + _C2_HEADER),
                          (_BASEQ_LAUNCH,
                           "coverage_records_lane_kernel<<<add_grid(n), kAddThreads, 0, s>>>(")],
    "no atomics": [(_EVENT, "if (d == 0x7fff) diff[0] = inside ? at + i : g.index(a + i);")],
    "no quality loads": [("(i < avail ? static_cast<int>(__ldg(qp + i)) : 0xFF)",
                          "(i < avail ? 40 : 0xFF)")],
}
_ABLATIONS.add("no quality loads")
_ABLATIONS.add("no atomics")
_TILE_STEP = "constexpr int kSumTileStep = 32;"
_SHORT = "constexpr int kShortPiece = 32;"
_WARP_SUM = "#pragma unroll 4\n    for (int i = lane; i < body; i += 32) {"
_R1_BOUNDS = "__global__ void __launch_bounds__(kRegionThreads, 4)\nregion_sums_kernel("
_R1_GRID = "region_sums_kernel<<<4 * ngs::sm_count()"
SUMS_VARIANTS = {
    "as built": [],
    "tiles of 8192": [(_TILE_STEP, _TILE_STEP.replace("32", "8192"))],
    "no lane pieces": [(_SHORT, _SHORT.replace("32", "1"))],
    "lane pieces under 128": [(_SHORT, _SHORT.replace("32", "128"))],
    "unroll 8": [(_WARP_SUM, _WARP_SUM.replace("unroll 4", "unroll 8"))],
    "no block cap": [(_R1_BOUNDS, _R1_BOUNDS.replace("(kRegionThreads, 4)", "(kRegionThreads)"))],
    "6 blocks/SM": [(_R1_BOUNDS, _R1_BOUNDS.replace(", 4)", ", 6)")),
                    (_R1_GRID, _R1_GRID.replace("4 *", "6 *"))],
    "8 blocks/SM": [(_R1_BOUNDS, _R1_BOUNDS.replace(", 4)", ", 8)")),
                    (_R1_GRID, _R1_GRID.replace("4 *", "8 *"))],
    "no memset": [("    cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(n) * "
                   "sizeof(u64), s);\n    if (err != cudaSuccess) return static_cast<int>(err);\n",
                   "")],
    "empty kernel": [(_R1_BOUNDS + "const int* __restrict__ cov, const int* __restrict__ "
                      "starts,\n                   const long long* __restrict__ offsets, int n, "
                      "u64* __restrict__ out) {\n",
                      _R1_BOUNDS + "const int* __restrict__ cov, const int* __restrict__ "
                      "starts,\n                   const long long* __restrict__ offsets, int n, "
                      "u64* __restrict__ out) {\n    if (n > 0) return;\n")],
}
_ABLATIONS.update({"no memset", "empty kernel"})
VARIANTS = {"finalize": FINALIZE_VARIANTS, "sums": SUMS_VARIANTS, "runs": RUNS_VARIANTS,
            "records": RECORDS_VARIANTS}


def _variant_source(subs: list[tuple[str, str]]) -> str:
    text = (_build.CSRC / "coverage.cu").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"substitution anchor not found once: {old!r}")
        text = text.replace(old, new)
    return text


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The launchers' arguments (the same before the single-pass designs) and
    the scratch sizes (then: C2's int32 tile sums, R2's tiles; such a
    library gets ``first_designs``)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    parent = lib.first_designs = hasattr(lib, "ngs_coverage_tiles")
    lib.ngs_coverage_finalize.argtypes = [p, i, i, i, i, i, p, p, p, p, p]
    lib.ngs_runs_count.argtypes = [p, ll, p, p, i, ll, i, p, p]
    lib.ngs_runs_write.argtypes = [p, ll, p, p, i, ll, i, p, i, p, p]
    lib.ngs_region_sums.argtypes = [p, p, p, i, p, p]
    sizes = ((lib.ngs_coverage_tiles, i), (lib.ngs_runs_tiles, ll)) if parent else \
        ((lib.ngs_coverage_scratch, i), (lib.ngs_runs_scratch, ll))
    for fn, arg in sizes:
        fn.argtypes = [arg]
        fn.restype = ctypes.c_int if parent else ll
    for fn in (lib.ngs_coverage_finalize, lib.ngs_runs_count, lib.ngs_runs_write,
               lib.ngs_region_sums):
        fn.restype = ctypes.c_int
    if hasattr(lib, "ngs_coverage_add_records"):
        lib.ngs_coverage_add_records.argtypes = [p, p, p, p, p, p, i, i, i, i, p, i, i, p, p]
        lib.ngs_coverage_add_records.restype = ctypes.c_int
    return lib


def _build_all(variants: dict, parent: Path | None) -> dict[str, ctypes.CDLL]:
    """One library per variant (and the parent's), nvcc all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "launch.cuh").write_text((_build.CSRC / "launch.cuh").read_text())
    sources = {}
    for i, (name, subs) in enumerate(variants.items()):
        sources[name] = OUT / f"variant{i}.cu"
        sources[name].write_text(_variant_source(subs))
    if parent is not None:
        sources["parent"] = parent / "ngsbits_tpu_torch" / "csrc" / "coverage.cu"
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
        loaded[name] = _bind(ctypes.CDLL(str(libs[name])))
    return loaded


def _p(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _launched(name: str, rc: int):
    if rc:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _chr1_diff(dev) -> torch.Tensor:
    """Coverage about 30 over chr1's box with random steps of +-1."""
    gen = torch.Generator(device=dev).manual_seed(5)
    diff = torch.zeros(CHR1 + 1, dtype=torch.int32, device=dev)
    diff[0] = 30
    at = torch.randint(0, CHR1 - 1000, (2_000_000,), device=dev, generator=gen)
    length = torch.randint(1, 1000, (2_000_000,), device=dev, generator=gen)
    sign = torch.randint(0, 2, (2_000_000,), device=dev, generator=gen).to(torch.int32) * 2 - 1
    diff.index_add_(0, at, sign)
    diff.index_add_(0, at + length, -sign)
    return diff


def _diff(span: int, depth: int, seed: int, dev) -> torch.Tensor:
    """Reads of 1-400 bases at ``depth`` on average, anywhere in the span."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, span, size=span * depth // 200)
    ends = np.minimum(starts + rng.integers(1, 400, size=starts.shape[0]), span)
    return selfcheck.coverage_diff(starts, ends, span, dev)


def _exome_regions(seed: int = 3):
    """2,728 touching regions over the exome's flattened box, as its merged
    panel gives them: int64 (starts, inclusive ends)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(100, 460, size=EXOME_REGIONS).astype(np.float64)
    lengths = np.maximum(1, np.round(lengths * EXOME_BOX / lengths.sum())).astype(np.int64)
    lengths[-1] += EXOME_BOX - lengths.sum()
    ends = np.cumsum(lengths) - 1
    return ends - lengths + 1, ends


def _finalize_calls(libs, dev):
    """Yields (shape label, bound bytes, {name: (call, check or None)}), one
    shape at a time: the calls read the loop's inputs while it waits."""
    for label, diff, hist in (
            (f"dense, chr1's box ({CHR1})", _chr1_diff(dev), None),
            (f"dense, the exome's largest box ({EXOME_BOX})", _diff(EXOME_BOX, 24, 1, dev), None),
            (f"histogram, MappingQC's launch ({MQ_SPAN})", _diff(MQ_SPAN, 24, 2, dev),
             (5, 599, 120, 12))):
        span = diff.shape[0] - 1
        step, hist_max, bins, half_depth = hist or (1, 0, 0, 0)
        want_h = torch.zeros(bins, dtype=torch.int64, device=dev)
        want_half = torch.zeros(1, dtype=torch.int64, device=dev)
        want_c = torch.zeros(span, dtype=torch.int32, device=dev) if hist is None else None
        dr.coverage_finalize_plain(diff, step, hist_max, half_depth,
                                   want_h if hist else None, want_half if hist else None, want_c)
        calls = {}
        for name, lib in libs.items():
            h = torch.zeros(bins, dtype=torch.int64, device=dev) if hist else None
            half = torch.zeros(1, dtype=torch.int64, device=dev) if hist else None
            cov = torch.zeros(span, dtype=torch.int32, device=dev) if hist is None else None
            if lib.first_designs:  # int32 tile sums
                scratch = torch.empty(lib.ngs_coverage_tiles(span), dtype=torch.int32, device=dev)
            else:
                scratch = torch.empty(lib.ngs_coverage_scratch(span), dtype=torch.int64,
                                      device=dev)

            def call(lib=lib, h=h, half=half, cov=cov, scratch=scratch, name=name):
                _launched(name, lib.ngs_coverage_finalize(
                    _p(diff), span, step, hist_max, bins, half_depth, _p(scratch), _p(h),
                    _p(half), _p(cov), _stream()))

            def check(h=h, half=half, cov=cov, name=name):
                if name in _ABLATIONS:
                    return True
                if hist:
                    return torch.equal(h, want_h) and torch.equal(half, want_half)
                return torch.equal(cov, want_c)
            calls[name] = (call, check)
        if hist is None:
            calls["torch.cumsum"] = (
                lambda diff=diff, span=span: torch.cumsum(diff[:span], 0, dtype=torch.int32), None)
        out_bytes = 8 * (bins + 1) if hist else 4 * span
        yield label, 4 * (span + 1) + out_bytes, calls


def _runs_calls(libs, dev):
    """As ``_finalize_calls``, for R2."""
    chr1_cov = torch.cumsum(_chr1_diff(dev)[:-1], 0).to(torch.int32)
    exome_cov = torch.cumsum(_diff(EXOME_BOX, 24, 1, dev)[:-1], 0).to(torch.int32)
    for label, cov, (rs, re), cutoff in (
            (f"chr1's box as one region ({CHR1}), cutoff 29", chr1_cov,
             (np.array([0]), np.array([CHR1 - 1])), 29),
            (f"the exome's largest box ({EXOME_BOX}, {EXOME_REGIONS} regions), cutoff 20",
             exome_cov, _exome_regions(), 20)):
        s, off = (torch.from_numpy(a).to(dev) for a in dr.region_offsets(rs, re))
        n = s.shape[0]
        want = dr.threshold_runs_plain(cov, s, off, cutoff, False)
        n_runs = want.shape[1]
        if n_runs == 0:
            raise RuntimeError(f"{label}: no runs to write")
        calls = {}
        for name, lib in libs.items():
            out = torch.zeros(3, n_runs, dtype=torch.int32, device=dev)
            scratch = torch.empty(2 * lib.ngs_runs_tiles(cov.shape[0]) + 2 if lib.first_designs
                                  else lib.ngs_runs_scratch(cov.shape[0]),
                                  dtype=torch.int64, device=dev)

            def call(lib=lib, out=out, scratch=scratch, name=name):
                _launched(f"{name} count", lib.ngs_runs_count(
                    _p(cov), cov.shape[0], _p(s), _p(off), n, cutoff, 0, _p(scratch), _stream()))
                _launched(f"{name} write", lib.ngs_runs_write(
                    _p(cov), cov.shape[0], _p(s), _p(off), n, cutoff, 0, _p(scratch), n_runs,
                    _p(out), _stream()))
            calls[name] = (call, lambda out=out: torch.equal(out, want))
        total = int(off[-1])
        yield label + f": {n_runs} runs", 4 * total + 12 * n + 8 + 16 + 12 * n_runs, calls


EXOME_UNMERGED = 3_574  # the exome's largest box as BedCoverage hands it to R1


def _sums_calls(libs, dev):
    """As ``_finalize_calls``, for R1 (the parent's too: its arguments are
    the same)."""
    chr1_cov = torch.cumsum(_chr1_diff(dev)[:-1], 0).to(torch.int32)
    rng = np.random.default_rng(6)
    es = np.sort(rng.integers(0, EXOME_BOX - 400, size=EXOME_UNMERGED))
    exome = (es, es + rng.integers(99, 400, size=EXOME_UNMERGED))
    dense_span, ds, de = selfcheck.r1_regions("dense panel", seed=7)
    for label, cov, (rs, re) in (
            (f"chr1's box as one region ({CHR1})", chr1_cov, (np.array([0]), np.array([CHR1 - 1]))),
            (f"the exome's largest box ({EXOME_BOX}, {EXOME_UNMERGED} regions)",
             torch.cumsum(_diff(EXOME_BOX, 24, 1, dev)[:-1], 0).to(torch.int32), exome),
            (f"a dense panel ({dense_span}, {len(ds)} regions of 1-200 bp)",
             torch.cumsum(_diff(dense_span, 4, 8, dev)[:-1], 0).to(torch.int32), (ds, de))):
        case = selfcheck.region_sums_case(cov, rs, re)
        s, off = (torch.from_numpy(a).to(dev) for a in dr.region_offsets(rs, re))
        n = s.shape[0]
        case.plain()
        want = case.outputs()[1][0]
        calls = {}
        for name, lib in libs.items():
            out = torch.zeros(n, dtype=torch.int64, device=dev)

            def call(lib=lib, out=out, name=name):
                _launched(name, lib.ngs_region_sums(_p(cov), _p(s), _p(off), n, _p(out),
                                                    _stream()))
            calls[name] = (call, lambda out=out, name=name: name in _ABLATIONS
                           or torch.equal(out, want))
        yield label, case.bytes, calls
        del cov, calls


# the exome BAM's median batch (chip_smoke.py, a chromosome's 8 Mb): its
# panel's merged blocks and the part of the chromosome the batch spans
EXOME_BLOCKS, EXOME_CHROM, BATCH_SPAN, KEPT = 2_163, 8_000_000, 3_200_000, 53_500
_QUALS = np.array([2] * 3 + [12] * 6 + [23] * 17 + [37] * 102, dtype=np.uint8)


def _exome_batch(seed: int = 4):
    """(columns of a sorted batch of 65,536 records of 151 bp, the panel's
    blocks as int64 [3, n], span): 151M with a few clips, deletions and
    insertions; 80% of the reads near a block; 53,500 kept."""
    rng = np.random.default_rng(seed)
    bs = np.sort(rng.choice(EXOME_CHROM // 3000, EXOME_BLOCKS, replace=False)) * 3000
    be = bs + rng.integers(100, 400, size=EXOME_BLOCKS)
    n = 65_536
    near = rng.random(n) < 0.8
    in_batch = np.flatnonzero(bs < BATCH_SPAN)
    at = bs[rng.choice(in_batch, size=n)] + rng.integers(-250, 400, size=n)
    pos = np.sort(np.where(near, at, rng.integers(0, BATCH_SPAN, size=n))).astype(np.int32)
    shapes = [[(151, 0)], [(20, 4), (131, 0)], [(70, 0), (2, 2), (81, 0)],
              [(60, 0), (1, 1), (90, 0)]]
    pick = rng.choice(4, size=n, p=[0.9, 0.04, 0.03, 0.03])
    ops = [shapes[k] for k in pick]
    cigar = np.array([(ln << 4) | op for o in ops for ln, op in o], dtype=np.uint32)
    cigar_off = np.concatenate(([0], np.cumsum([len(o) for o in ops]))).astype(np.int64)
    seq_off = np.arange(n + 1, dtype=np.int64) * 151
    qual = _QUALS[rng.integers(0, len(_QUALS), size=151 * n)]
    keep = np.zeros(n, dtype=bool)
    keep[rng.choice(n, KEPT, replace=False)] = True
    rec = dr.upload_records(pos, np.where(keep, 0, -1), cigar_off, cigar, seq_off, qual,
                            device="cuda")
    off = np.concatenate(([0], np.cumsum(be - bs)[:-1]))
    blocks = torch.tensor(np.stack([bs, be, off]), device="cuda")
    return rec, blocks, int((be - bs).sum())


def _records_calls(libs, dev):
    """As ``_finalize_calls``, for C1's record form: the batch with
    -min_baseq 20 and without; the coverages (prefix sums) are compared."""
    if "parent" in libs and not hasattr(libs["parent"], "ngs_coverage_add_records"):
        raise ValueError("the parent has no C1 record form to time")
    rec, blocks, span = _exome_batch()
    n = rec.pos.shape[0]
    for min_baseq in (20, 0):
        case = selfcheck.coverage_add_records_case(rec, 0, n, 0, min_baseq, blocks, span)
        case.plain()
        want = case.outputs()[1][0]
        calls = {}
        for name, lib in libs.items():
            diff = torch.zeros(span + 1, dtype=torch.int32, device=dev)

            def call(lib=lib, diff=diff, name=name):
                _launched(name, lib.ngs_coverage_add_records(
                    _p(rec.pos), _p(rec.keep), _p(rec.cigar_off), _p(rec.cigar),
                    _p(rec.qual_off), _p(rec.qual), 0, n, 0, min_baseq, _p(blocks),
                    blocks.shape[1], span, _p(diff), _stream()))

            def check(diff=diff, name=name):
                return name in _ABLATIONS or torch.equal(
                    torch.cumsum(diff[:span].to(torch.int64), 0), want)
            calls[name] = (call, check)
        yield (f"records, -min_baseq {min_baseq}: {n} records, {KEPT} kept, "
               f"{EXOME_BLOCKS} blocks", case.bytes, calls)


RUNNERS = {"finalize": _finalize_calls, "sums": _sums_calls, "runs": _runs_calls,
           "records": _records_calls}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=tuple(VARIANTS), default="finalize",
                    help="the kernel whose variants to time (default: C2)")
    ap.add_argument("--parent", type=Path,
                    help="a checkout of another commit whose kernel to time too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("coverage_variants: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = _build_all(VARIANTS[args.kernel], args.parent)
    results = []
    for label, bound_bytes, calls in RUNNERS[args.kernel](libs, dev):
        bound_ms = bound_bytes / PEAK_BYTES * 1e3
        for name, (call, check) in calls.items():
            if check is not None:
                call()
                torch.cuda.synchronize()
                if not check():
                    raise AssertionError(f"{label} {name}: differs from the plain version")
            warm = [selfcheck.device_ms(call) for _ in range(3)]
            cold = [selfcheck.cold_ms(call) for _ in range(3)]
            got = dict(kernel=args.kernel, shape=label, variant=name, ms=statistics.median(warm),
                       warm_runs_ms=warm, cold_ms=statistics.median(cold), cold_runs_ms=cold,
                       bound_ms=bound_ms)
            print(f"{args.kernel} {label:58s} {name:14s} device {got['ms']:.4f} ms ("
                  + ", ".join(f"{w:.4f}" for w in warm) + f"), cold {got['cold_ms']:.4f} ms ("
                  + ", ".join(f"{c:.4f}" for c in cold) + f"), bound {bound_ms:.4f} ms "
                  f"({bound_ms / got['cold_ms']:.1%} of it cold)"
                  + (" [yardstick]" if check is None else "")
                  + (" [ablation, not checked]" if name in _ABLATIONS else ""), flush=True)
            results.append(got)
        del calls
        torch.cuda.empty_cache()
    print(json.dumps({"coverage_variants": results, "kernel": args.kernel}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
