#!/usr/bin/env python3
"""Every kernel wrapper's time a call from Python beside its kernel's device time, for this tree and another commit's, in turns.

    python3 scripts/wrapper_calls.py [--parent DIR] [--rounds N]

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
the same work. For B1's region form each tree prints the same of its own
wrapper (``pileup_regions_into``): the device check, the tensor checks,
the library, the ctypes call with no records, the launch alone, a pinned
host buffer and a device output of the call's size allocated, the
non-blocking copy of the output into a pinned buffer and a CUDA event made
and recorded (by torch; and, where the tree has ``ngs_copy_hits``, both
queued by the kernel library), the wait on an event that has passed, and
the whole call, its hits waited for at once and as the sweep makes it
(``wait=False``, the hits read after the next call), and, where the tree
has a ``HitRing``, a slot taken and given back and the hits copied out of
it; the parts that queue work on the card are timed over 200 calls without
the wait after them. For both B1 forms each tree also prints its engine's
call (``DeviceRegions.add``; ``DevicePileup.add`` with the record form
off) over 2,000 calls, as the sweep makes it (the previous launch's hits
read after each launch) and with its hits read at once: the engines'
output and pinned buffers are part of what is timed. ``--rounds N``
repeats the turns N times.

Inputs (``ops/selfcheck.py``, seeded): ReadQC's three kernels at SeqPurge's
``-qc`` bucket (B=16,384 rows, 10,000 reads of 151 bp); K2, the adapter
scans and the decisions at SeqPurge's batch (B=10,000 pairs, L=151); C1's
span form at MappingQC's median launch (45,693 spans into 13,861,233
positions) and its read form at about that launch (32,000 reads over 24
chromosomes of 2,500 regions); C2 with its histogram and in its dense mode
at 1,000,003 positions; B1 at MappingQC's median launch (1,420 indices into
12,872 counters); R1 at 3,574 regions of 1-400 bp over 773,011 positions;
R2 at 2,000 disjoint regions there; C1's record form at 5,000 records; B1's
indel form at ``selfcheck.INDEL_EDGES``' "sorted, window 0" (4,000 sorted
records, 318 hits, capacity 11,756) and its region form at
``REGION_EDGES``' "sorted, three chromosomes, one without regions" (4,000
sorted records over 810 regions, 424 hits), each tree's wrapper on its own
design (this tree's on a scratch and a ring of pinned slots its case
keeps).
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
    if hasattr(sc, "pileup_indel_edge_case"):
        yield "pileup_indels", sc.pileup_indel_edge_case("sorted, window 0", dev)
    if hasattr(sc, "pileup_region_edge_case"):
        yield "pileup_regions", sc.pileup_region_edge_case(
            "sorted, three chromosomes, one without regions", dev)


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


def _enqueue_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` that queues work on the card, by
    ``time.perf_counter`` over ``calls`` calls without the wait for the card
    after them (a few hundred calls fit the launch queue, so the host's
    cost is what is timed, not the card's)."""
    import time
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


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


def _region_parts() -> dict:
    """Host microseconds a call of each part of B1's region form's wrapper,
    on this tree's API (with or without the regions range, the scratch and
    the ring); parts that queue work on the card by ``_enqueue_us``."""
    import torch
    from ngsbits_tpu_torch.ops import device_reduce as dr
    from ngsbits_tpu_torch.ops import selfcheck as sc
    dev = torch.device("cuda")
    got = sc.region_edge_inputs("sorted, three chromosomes, one without regions", dev)
    rec, eng, capacity = got[:3]
    regions, table, counters = eng.regions, eng.table, eng.counters
    out = dr.region_out(capacity, dev)
    tensors = (rec.pos, rec.keep, rec.mapq, rec.cigar_off, rec.cigar, regions, table,
               counters, out)
    lib = dr._lib()
    ranged = len(lib.ngs_pileup_regions.argtypes) > 14
    scratch = dr.indel_scratch(dev)
    tail = ([0, regions.shape[1], counters.data_ptr(), out.data_ptr(), capacity,
             scratch.data_ptr()] if ranged else [counters.data_ptr(), out.data_ptr(), capacity])
    empty = [rec.pos.data_ptr(), rec.keep.data_ptr(), rec.mapq.data_ptr(),
             rec.cigar_off.data_ptr(), rec.cigar.data_ptr(), 0, regions.data_ptr(),
             regions.shape[1], table.data_ptr(), table.shape[1], *tail]
    launch = ((lambda: dr._pileup_regions_launch(rec, regions, table, counters, out,
                                                 (0, regions.shape[1]), scratch)) if ranged
              else (lambda: dr._pileup_regions_launch(rec, regions, table, counters, out)))
    pinned = torch.empty(out.shape[0], dtype=torch.int64, pin_memory=True)
    passed = torch.cuda.Event()
    passed.record()
    torch.cuda.synchronize()

    def event():
        e = torch.cuda.Event()
        e.record(torch.cuda.current_stream(dev))

    kw = dict(scratch=scratch, ring=dr.HitRing()) if ranged else {}
    last: list = []  # the last call's hits, read after the next call

    def sweep_call():
        h = dr.pileup_regions_into(rec, regions, table, counters, out, wait=False, **kw)
        if last:
            last.pop().hits()
        last.append(h)

    parts = {
        "_route": _host_us(lambda: dr._route(*tensors)),
        "_region_args": _host_us(lambda: dr._region_args(rec, regions, table, counters, out)),
        "_lib": _host_us(dr._lib),
        "ctypes call, no records": _host_us(lambda: lib.ngs_pileup_regions(
            *empty, dr._stream(out))),
        "launch alone": _enqueue_us(launch),
        "pinned buffer allocated": _host_us(
            lambda: torch.empty(out.shape[0], dtype=torch.int64, pin_memory=True), 5_000),
        "device output allocated": _host_us(lambda: dr.region_out(capacity, dev), 5_000),
        "copy queued (torch)": _enqueue_us(lambda: pinned.copy_(out, non_blocking=True)),
        "event made and recorded (torch)": _enqueue_us(event),
    }
    if hasattr(lib, "ngs_copy_hits"):
        ring = dr.HitRing()
        slot = ring.take(out.shape[0])
        parts["copy and event queued (library)"] = _enqueue_us(lambda: lib.ngs_copy_hits(
            out.data_ptr(), slot.ptr, out.shape[0], slot.handle, dr._stream(out)))
        parts["slot taken and given back (ring)"] = _host_us(
            lambda: ring.give(ring.take(out.shape[0])), 5_000)
        hits = dr.pileup_region_pairs(rec, regions, table)[2].shape[0]
        words = slot.view[1:1 + dr.REGION_HIT * hits]
        parts[f"{hits} hits copied out of the slot"] = _host_us(
            lambda: torch.from_numpy(words.reshape(-1, dr.REGION_HIT).copy()), 5_000)
    parts.update({
        "wait on a passed event": _host_us(passed.synchronize),
        "wrapper call, hits waited for": _host_us(
            lambda: dr.pileup_regions_into(rec, regions, table, counters, out, **kw), 2_000),
        "wrapper call as the sweep makes it": _host_us(sweep_call, 2_000),
    })
    return parts


def _engine_calls(calls: int = 2_000) -> dict:
    """Host microseconds a call of each B1 form's engine as the sweep makes
    it (``DeviceRegions.add``, ``DevicePileup.add`` with the record form
    off: a launch, the hits' copy queued, the previous launch's hits read),
    and with its hits read at once, over ``calls`` calls each, on this
    tree's API; the region form at ``REGION_EDGES``' "sorted, three
    chromosomes, one without regions", the indel form at ``INDEL_EDGES``'
    "sorted, window 0"."""
    import inspect
    import torch
    from ngsbits_tpu_torch.ops import device_reduce as dr
    from ngsbits_tpu_torch.ops import selfcheck as sc
    dev = torch.device("cuda")
    rec, eng, capacity, *cut = sc.region_edge_inputs(
        "sorted, three chromosomes, one without regions", dev)
    ranged = "regions_range" in inspect.signature(eng.add).parameters
    region_add = (lambda: eng.add(rec, capacity // eng.depth, *(cut if ranged else [])))
    irec, ieng, mq, _, icap, icut = sc.indel_edge_inputs("sorted, window 0", dev)
    ieng.count_bases = False
    indel_add = (lambda: ieng.add(irec, mq, 0, icap // ieng.indel_depth, icut))
    got = {}
    for name, add in (("pileup_regions", region_add), ("pileup_indels", indel_add)):
        last: list = []

        def sweep_call(add=add, last=last):
            h = add()
            if last:
                last.pop().hits()
            last.append(h)

        got[name] = {"engine call as the sweep makes it": _host_us(sweep_call, calls),
                     "engine call, hits read at once": _host_us(lambda: add().hits(), calls)}
        if last:
            last.pop().hits()
    return got


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
        if name == "pileup_regions":
            out[name]["host_us"] = _region_parts()
    for name, parts in _engine_calls().items():
        out.setdefault(name, {}).setdefault("host_us", {}).update(parts)
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
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of the turns (parent, this, this, parent each)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("wrapper_calls: no CUDA device available", file=sys.stderr)
        return 1
    if args.child:
        sys.path.insert(0, os.getcwd())
        return child()
    order = (["parent", "this", "this", "parent"] if args.parent else ["this", "this"]) * args.rounds
    trees = {"this": ROOT, "parent": args.parent}
    runs = [(side, _run(trees[side].resolve())) for side in order]
    names = list(dict.fromkeys(n for _, r in runs for n in r))
    print(f"{'wrapper':28s}" + "".join(f"{side + ' ' + k:>20s}" for side in dict.fromkeys(order)
                                       for k in ("call ms", "device ms", "host ms")))
    for name in names:
        row = f"{name:28s}"
        for side in dict.fromkeys(order):
            got = [r[name] for s, r in runs if s == side and "call_ms" in r.get(name, {})]
            if not got:
                row += f"{'-':>20s}" * 3
                continue
            call = statistics.median(g["call_ms"] for g in got)
            dev = statistics.median(g["ms"] for g in got)
            row += f"{call:20.4f}{dev:20.4f}{call - dev:20.4f}"
        print(row)
    for side, r in runs:
        for name, what in (("coverage_add_reads", "C1's read form"),
                           ("pileup_regions", "B1's region form"),
                           ("pileup_indels", "B1's indel form")):
            if "host_us" in r.get(name, {}):
                print(f"{side}: {what}, host us a call: " + ", ".join(
                    f"{k} {v:.2f}" for k, v in r[name]["host_us"].items()))
    print(json.dumps({"wrapper_calls": [{"tree": s, "times": r} for s, r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
