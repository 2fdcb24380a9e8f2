#!/usr/bin/env python3
"""Every kernel wrapper's time a call from Python beside its kernel's device time, for this tree and another commit's, in turns.

    python3 scripts/wrapper_calls.py [--parent DIR]

For each wrapper of ``ngsbits_tpu_torch.ops.KERNELS`` whose case both trees'
``ops/selfcheck.py`` can make, at the main path's small launches (where a
call's host work is about as long as the kernel): ``call_ms``, 10
back-to-back wrapper calls between two CUDA events (the wrapper's checks,
its ctypes call and the launch included; R2's fetch of its totals too), and
``ms``, the same 10 calls captured in a CUDA graph and replayed (device time
alone; R2's two passes without the fetch). Their difference is what the
wrapper's host side costs a call. Each tree runs in a process of its own
that imports its own package and builds its own kernels; with ``--parent
DIR`` (a checkout of another commit, e.g. ``git archive HEAD | tar -x -C
build/parent``) in turns: parent, this, this, parent. Prints a table of the
medians (each side's two runs) and, last, one JSON line with every run.
Needs a CUDA device.

For C1's read form this tree also prints what its call is made of, host
microseconds a call by ``time.perf_counter`` over 20,000 calls: the
device check (``_route``), the three tensor checks, the stream handle, the
library, the ctypes call of the launcher with no reads (it returns before
launching), the whole wrapper call (launch included) and ``index_add_`` on
the same work.

Inputs (``ops/selfcheck.py``, seeded): ReadQC's three kernels at SeqPurge's
``-qc`` bucket (B=16,384 rows, 10,000 reads of 151 bp); K2, the adapter
scans and the decisions at SeqPurge's batch (B=10,000 pairs, L=151); C1's
span form at MappingQC's median launch (45,693 spans into 13,861,233
positions) and its read form at about that launch (32,000 reads over 24
chromosomes of 2,500 regions); C2 with its histogram and in its dense mode
at 1,000,003 positions; B1 at MappingQC's median launch (1,420 indices into
12,872 counters); R1 at 3,574 regions of 1-400 bp over 773,011 positions;
R2 at 2,000 disjoint regions there; C1's record form at 5,000 records.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
A1 = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
A2 = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"


def _cases(dev):
    """(wrapper name, case) for every wrapper this tree's selfcheck can
    make a case of."""
    import numpy as np
    import torch
    from ngsbits_tpu_torch.ops import device_reduce as dr
    from ngsbits_tpu_torch.ops import selfcheck as sc

    def t(a):
        return torch.from_numpy(a).to(dev)

    for case in sc.cases(16384, 192, 6, dev, seed=1, profile="binned", read_len=151,
                         n_valid=10000):
        yield case.name, case
    for case in sc.seqpurge_cases(10000, 151, dev, A1, A2, a_size=20, seed=2):
        yield case.name, case
    yield "seqpurge_decide", sc.decide_case(10000, 151, dev, A1, A2, seed=3)
    span = 13_861_233
    s, e = sc.coverage_spans(span, 45_693, seed=4)
    yield "coverage_add", sc.coverage_add_case(t(s), t(e), span)
    if hasattr(sc, "coverage_add_reads_case"):
        (_, rs, re), (_, qs, qe, i0, i1) = sc.roi_reads(32_000, seed=5, n_chroms=24,
                                                        n_regions=2500, width=8_000_000)
        rspan = int((re - rs + 1).sum())
        regions = dr.DeviceCoverage(rspan, dev, regions=np.stack([rs, re])).regions
        reads = t(np.stack([qs, qe, i0, i1]).astype(np.int32))
        case = sc.coverage_add_reads_case(reads, regions, rspan)
        case.inputs = (reads, regions, torch.zeros(rspan + 1, dtype=torch.int32, device=dev))
        yield "coverage_add_reads", case
    span = 1_000_003
    s, e = sc.coverage_spans(span, span // 20, seed=6)
    diff = sc.coverage_diff(s, e, span, dev)
    yield "coverage_finalize", sc.coverage_finalize_case(diff, 5, 599, 120, 12)
    yield "coverage_finalize (dense)", sc.coverage_dense_case(diff)
    yield "bincount_add", sc.bincount_case(t(sc.pileup_indices(3218, 1420, seed=7)), 4 * 3218)
    box = 773_011
    cov = torch.cumsum(sc.coverage_diff(*sc.coverage_spans(box, box // 10, seed=8), box,
                                        dev)[:-1], 0).to(torch.int32)
    yield "region_sums", sc.region_sums_case(cov, *sc.coverage_regions(box, 3574, seed=9))
    yield "threshold_runs", sc.threshold_runs_case(
        cov, *sc.coverage_regions(box, 2000, seed=10, disjoint=True), 20, False)
    cols = sc.alignment_records(5000, seed=11, width=30_000)
    keys = sc.records_keys(cols, (cols["flag"] & 0x704) == 0)
    rec = dr.upload_records(cols["pos"], keys, cols["cigar_off"], cols["cigar"],
                            device=dev)
    blocks = torch.tensor([[0], [40_000], [0]], device=dev)
    yield "coverage_add_records", sc.coverage_add_records_case(rec, 0, len(keys), 0, 0,
                                                               blocks, 40_000)


def _host_us(fn, calls: int = 20_000) -> float:
    import time
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def _read_form_parts(case) -> dict:
    """Host microseconds a call of each part of C1's read form's wrapper."""
    import torch
    from ngsbits_tpu_torch.ops import device_reduce as dr
    reads, regions, diff = case.inputs
    lib = dr._lib()
    k, n = reads.shape[1], regions.shape[1]
    empty = reads[:, :0]
    idx = torch.cat([reads[0], reads[1]]).to(torch.int64).clamp(0, diff.shape[0] - 1)
    ones = torch.ones(idx.shape[0], dtype=torch.int32, device=diff.device)
    return {
        "_route": _host_us(lambda: dr._route(reads, regions, diff)),
        "three _check": _host_us(lambda: (dr._check("reads", reads, torch.int32, (4, k)),
                                          dr._check("regions", regions, torch.int32, (3, n)),
                                          dr._check("diff", diff, torch.int32,
                                                    (diff.shape[0],)))),
        "_stream": _host_us(lambda: dr._stream(diff)),
        "_lib": _host_us(dr._lib),
        "ctypes call, no reads": _host_us(lambda: lib.ngs_coverage_add_reads(
            empty.data_ptr(), 0, regions.data_ptr(), n, diff.shape[0] - 1, diff.data_ptr(),
            dr._stream(diff))),
        "wrapper call": _host_us(case.kernel, 5_000),
        "index_add_": _host_us(lambda: diff.index_add_(0, idx, ones), 5_000),
    }


def child() -> int:
    """This process's tree: every case's call and device times, as JSON."""
    import torch
    from ngsbits_tpu_torch.ops import _build
    from ngsbits_tpu_torch.ops import selfcheck as sc
    _build.library()
    dev = torch.device("cuda")
    out = {}
    for name, case in _cases(dev):
        case.kernel()
        case.plain()
        torch.cuda.synchronize()
        if sc.max_abs_err(case):
            raise AssertionError(f"{name}: differs from its plain version")
        out[name] = dict(call_ms=sc.call_ms(case.kernel),
                         ms=sc.device_ms(case.device_fn or case.kernel))
        if name == "coverage_add_reads":
            out[name]["host_us"] = _read_form_parts(case)
    print(json.dumps(out))
    return 0


def _run(tree: Path) -> dict:
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child"],
                         cwd=tree, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                             [str(tree), *filter(None, [os.environ.get("PYTHONPATH")])])))
    if res.returncode != 0:
        raise RuntimeError(f"{tree}: exited {res.returncode}:\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of another commit to time too")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("wrapper_calls: no CUDA device available", file=sys.stderr)
        return 1
    if args.child:
        sys.path.insert(0, os.getcwd())
        return child()
    order = ["parent", "this", "this", "parent"] if args.parent else ["this", "this"]
    trees = {"this": ROOT, "parent": args.parent}
    runs = [(side, _run(trees[side].resolve())) for side in order]
    names = list(dict.fromkeys(n for _, r in runs for n in r))
    print(f"{'wrapper':28s}" + "".join(f"{side + ' ' + k:>20s}" for side in dict.fromkeys(order)
                                       for k in ("call ms", "device ms", "host ms")))
    for name in names:
        row = f"{name:28s}"
        for side in dict.fromkeys(order):
            got = [r[name] for s, r in runs if s == side and name in r]
            if not got:
                row += f"{'-':>20s}" * 3
                continue
            call = statistics.median(g["call_ms"] for g in got)
            dev = statistics.median(g["ms"] for g in got)
            row += f"{call:20.4f}{dev:20.4f}{call - dev:20.4f}"
        print(row)
    for side, r in runs:
        if "host_us" in r.get("coverage_add_reads", {}):
            print(f"{side}: C1's read form, host us a call: " + ", ".join(
                f"{k} {v:.2f}" for k, v in r["coverage_add_reads"]["host_us"].items()))
    print(json.dumps({"wrapper_calls": [{"tree": s, "times": r} for s, r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
