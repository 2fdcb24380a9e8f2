#!/usr/bin/env python3
"""Where the port's ReadQC spends its time: host timers and a device trace.

    python3 scripts/profile_readqc.py [--reads 2000000] [--runs 2]

Writes the paired gzip FASTQ that chip_smoke.py drives (2 x N reads x 151 bp,
seeded) under build/profile_readqc/ and removes it at the end. Then:

1. decode  FastqReader alone over in1 (padded [B, L] batches): the host
           decode rate.
2. runs    the port's ReadQC CLI (qcML out) --runs times, the first of them
           a warm-up, with host timers on the consumer thread's calls:
           ``_bucket``, ``pack_batch``, ``stream_step`` (on a card: the
           enqueue only), the rest of ``DeviceReadStream.update`` (the
           host-to-device copies) and ``fold_into``.
3. trace   one more run under torch.profiler: device time and count per
           kernel and copy, and the device busy share, the union of the
           device's activity intervals over the run's wall time.

The device is the one NGSBITS_TORCH_DEVICE names (cuda by default). On the
CPU the trace holds no device activity and the busy share is not measured.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import shutil
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
READ_LEN = 151


def _union_us(intervals: list[tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


@contextlib.contextmanager
def host_timers(seconds: dict):
    """Time the consumer's calls inside ``DeviceReadStream.update`` and
    ``fold_into``, adding into ``seconds``."""
    from ngsbits_tpu_torch.qc import read_stats as rs

    def timed(key, fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                seconds[key] += time.perf_counter() - t0
        return wrapper

    targets = [(rs, "pack_batch", "pack_batch"), (rs, "stream_step", "stream_step"),
               (rs.ReadStatistics, "_bucket", "bucket"),
               (rs.DeviceReadStream, "update", "update"),
               (rs.DeviceReadStream, "fold_into", "fold_into")]
    missing = object()
    saved = [(owner, attr, vars(owner).get(attr, missing))
             for owner, attr, _ in targets]
    for owner, attr, key in targets:
        fn = timed(key, getattr(owner, attr))
        static = isinstance(inspect.getattr_static(owner, attr), staticmethod)
        setattr(owner, attr, staticmethod(fn) if static else fn)
    try:
        yield
    finally:
        for owner, attr, old in saved:
            if old is missing:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _readqc(args: list[str], dev: torch.device) -> float:
    from ngsbits_tpu_torch.__main__ import main as port_main
    t0 = time.perf_counter()
    rc = port_main(args)
    _sync(dev)
    if rc != 0:
        raise RuntimeError(f"ReadQC exited {rc}")
    return time.perf_counter() - t0


def copies(chrome: Path) -> dict:
    """Count and bytes of each kind of memory copy in an exported trace
    (kineto's ``gpu_memcpy`` events carry their bytes)."""
    kinds: dict = defaultdict(lambda: [0, 0])
    for e in json.loads(chrome.read_text()).get("traceEvents", []):
        if e.get("cat") == "gpu_memcpy":
            kinds[e["name"]][0] += 1
            kinds[e["name"]][1] += int(e.get("args", {}).get("bytes", 0))
    return dict(kinds)


def trace(args: list[str], dev: torch.device, top: int = 10, run=None,
          chrome: Path | None = None) -> dict:
    """One tool run (``run(args, dev)`` returning its wall seconds; ReadQC by
    default) under torch.profiler; prints device time per name and returns
    the wall seconds, device busy milliseconds and busy share. With
    ``chrome`` on a card the trace is also written there, and the count and
    bytes of each kind of copy are printed and returned under ``copies``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        wall = (run or _readqc)(args, dev)
    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = defaultdict(lambda: [0.0, 0])
    for e in on_device:
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in on_device])
    print(f"traced run: wall {wall:.3f} s; device activity {len(on_device)} events")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {us / 1000:10.3f} ms {n:6d}  {us / n / 1000:8.4f} ms each  {name[:70]}")
    if dev.type != "cuda":
        print("device busy share: not measured (no device)")
        return {"wall_s": wall, "busy_ms": None, "busy_share": None}
    if not on_device:
        raise RuntimeError("the trace holds no device activity")
    share = busy_us / 1e6 / wall
    print(f"device busy {busy_us / 1000:.3f} ms = {100 * share:.3f}% of the wall")
    result = {"wall_s": wall, "busy_ms": busy_us / 1000, "busy_share": share}
    if chrome is not None:
        prof.export_chrome_trace(str(chrome))
        result["copies"] = copies(chrome)
        for name, (n, nbytes) in sorted(result["copies"].items()):
            print(f"  copies {name}: {n}, {nbytes} bytes")
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=2_000_000, help="reads per mate")
    ap.add_argument("--runs", type=int, default=2, help="timed ReadQC runs")
    ap.add_argument("--work", type=Path, default=ROOT / "build" / "profile_readqc")
    opts = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from ngsbits_tpu_torch.io.fastq import FastqReader
    from ngsbits_tpu_torch.utils.backend import device
    from ngsbits_tpu_torch.utils.synth import synth_fastq

    dev = device()
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True)
        print(smi.stdout.strip().splitlines()[0])
    opts.work.mkdir(parents=True, exist_ok=True)
    try:
        f1, f2 = opts.work / "in1.fastq.gz", opts.work / "in2.fastq.gz"
        t0 = time.perf_counter()
        synth_fastq(f1, opts.reads, READ_LEN, seed=42)
        synth_fastq(f2, opts.reads, READ_LEN, seed=43)
        print(f"generated 2 x {opts.reads} reads in {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        n = sum(len(batch.bases) for batch in FastqReader(str(f1)))
        print(f"decode alone (in1): {n / (time.perf_counter() - t0):.0f} reads/s")

        args = ["ReadQC", "-in1", str(f1), "-in2", str(f2),
                "-out", str(opts.work / "ReadQC.qcML")]
        total = 2 * opts.reads
        for i in range(opts.runs):
            seconds: dict = defaultdict(float)
            with host_timers(seconds):
                wall = _readqc(args, dev)
            rest = seconds["update"] - (seconds["bucket"] + seconds["pack_batch"]
                                        + seconds["stream_step"])
            print(f"run {i}: wall {wall:.3f} s, {total / wall:.0f} reads/s; host s: "
                  + ", ".join(f"{k} {seconds[k]:.3f}" for k in
                              ("bucket", "pack_batch", "stream_step", "update",
                               "fold_into"))
                  + f"; update's copies and rest {rest:.3f}")
        trace(args, dev)
    finally:
        shutil.rmtree(opts.work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
