#!/usr/bin/env python3
"""Where the port's SeqPurge spends its time, beside the JAX package's host
route on the same input.

    python3 scripts/profile_seqpurge.py [--pairs 2000000] [--runs 2]

Writes the seeded short-insert read pairs that chip_smoke.py drives
(2 x N pairs x 151 bp, ``utils/synth.py::synth_pairs``) under
build/profile_seqpurge/ and removes them at the end. Then:

1. runs   the port's SeqPurge CLI (``-qc``, ``-summary``) --runs times, the
          first a warm-up: wall, pairs/s, the consumer thread's seconds
          (``process_batch``, waits for decoded batches, ``write_batch`` and
          the writers' close; the rest is set-up and the reports) and the
          engine's seconds by stage
          (qc; prepare = copy into the pinned buffer, upload, reverse
          complement; scans = device time of the three scans on a card;
          fetch = the wait for the device and the copy back; decisions =
          device time of seqpurge_decide plus the host's fold).
2. trace  one more run under torch.profiler: device time and count per
          kernel and copy, the device busy share (the union of the
          device's activity intervals over the run's wall time), and the
          bytes of each kind of copy, in all and per batch of 10,000 pairs.
3. host   the JAX package's SeqPurge on the same files in a subprocess
          (JAX_PLATFORMS=cpu; its default route, native C++ where its host
          library builds and loads, which it prints), timed inside that
          process; the port's FASTQs, summary and qcML must equal its
          outputs.

The device is the one NGSBITS_TORCH_DEVICE names (cuda by default). On the
CPU the trace holds no device activity and the busy share is not measured.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import os
import shutil
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).resolve().parent))
from profile_readqc import _sync, trace  # noqa: E402  (sibling script)

BATCH = 10000   # SeqPurge's default -block_size

# The JAX package's SeqPurge, timed inside its own process so that the
# interpreter's start is left out, as it is for the port.
# It prints whether its native C++ route is available (else it runs its numpy
# route), then its seconds.
_REF_RUN = ("import sys, time; from ngsbits_tpu.__main__ import main; "
            "from ngsbits_tpu.qc.seqpurge import SeqPurgeEngine; "
            "print(SeqPurgeEngine.native_available()); "
            "t0 = time.perf_counter(); rc = main(sys.argv[1:]); "
            "print(time.perf_counter() - t0); sys.exit(rc)")


def _args(d: Path, f1: Path, f2: Path) -> list[str]:
    d.mkdir(parents=True, exist_ok=True)
    return ["SeqPurge", "-in1", str(f1), "-in2", str(f2),
            "-out1", str(d / "out1.fastq.gz"), "-out2", str(d / "out2.fastq.gz"),
            "-qc", str(d / "qc.qcML"), "-summary", str(d / "summary.txt")]


@contextlib.contextmanager
def consumer_timers(seconds: dict):
    """Host seconds on SeqPurge's consumer thread, added into ``seconds``:
    ``process_batch``, ``decode wait`` (waiting for the next pair of decoded
    batches), ``write_batch`` (blocks while a writer's queue is full) and
    ``writers' close`` (the writers' backlog at the end)."""
    from ngsbits_tpu_torch.io.fastq import FastqWriter
    from ngsbits_tpu_torch.qc.seqpurge import SeqPurgeEngine
    from ngsbits_tpu_torch.tools import seq_purge

    def timed(key, fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                seconds[key] += time.perf_counter() - t0
        return wrapper

    prefetch_paired = seq_purge.prefetch_paired

    def timed_pairs(*args, **kw):
        it = prefetch_paired(*args, **kw)
        try:
            while True:
                t0 = time.perf_counter()
                item = next(it, None)
                seconds["decode wait"] += time.perf_counter() - t0
                if item is None:
                    return
                yield item
        finally:
            it.close()

    saved = [(SeqPurgeEngine, "process_batch"), (FastqWriter, "write_batch"),
             (FastqWriter, "close"), (seq_purge, "prefetch_paired")]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr in saved]
    SeqPurgeEngine.process_batch = timed("process_batch", SeqPurgeEngine.process_batch)
    FastqWriter.write_batch = timed("write_batch", FastqWriter.write_batch)
    FastqWriter.close = timed("writers' close", FastqWriter.close)
    seq_purge.prefetch_paired = timed_pairs
    try:
        yield
    finally:
        for owner, attr, old in saved:
            setattr(owner, attr, old)


def _seqpurge(args: list[str], dev: torch.device):
    from ngsbits_tpu_torch.tools.seq_purge import SeqPurgeTool
    tool = SeqPurgeTool()
    t0 = time.perf_counter()
    rc = tool.execute(args[1:])
    _sync(dev)
    if rc != 0:
        raise RuntimeError(f"SeqPurge exited {rc}")
    return time.perf_counter() - t0, tool.engine.seconds


def _same(port: Path, ref: Path):
    for name in sorted(p.name for p in ref.iterdir()):
        a, b = port / name, ref / name
        if name.endswith(".gz"):
            same = gzip.decompress(a.read_bytes()) == gzip.decompress(b.read_bytes())
        elif name.endswith(".qcML"):
            drop = [[x for x in p.read_text().splitlines() if "creation " not in x]
                    for p in (a, b)]
            same = drop[0] == drop[1]
        else:
            same = a.read_bytes() == b.read_bytes()
        if not same:
            raise AssertionError(f"{name}: the port differs from the JAX package")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=2_000_000, help="read pairs")
    ap.add_argument("--runs", type=int, default=2, help="timed SeqPurge runs")
    ap.add_argument("--work", type=Path, default=ROOT / "build" / "profile_seqpurge")
    opts = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from ngsbits_tpu_torch.utils.backend import device
    from ngsbits_tpu_torch.utils.synth import synth_pairs

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
        synth_pairs(f1, f2, opts.pairs, seed=7)
        print(f"generated 2 x {opts.pairs} reads in {time.perf_counter() - t0:.2f} s")

        args = _args(opts.work / "port", f1, f2)
        for i in range(opts.runs):
            consumer: dict = defaultdict(float)
            with consumer_timers(consumer):
                wall, seconds = _seqpurge(args, dev)
            print(f"run {i}: wall {wall:.3f} s, {opts.pairs / wall:.0f} pairs/s; "
                  "seconds by stage: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
            rest = wall - sum(consumer.values())
            print("  consumer thread: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in consumer.items())
                  + f", rest {rest:.3f} s")
        traced = trace(args, dev, run=lambda a, d: _seqpurge(a, d)[0], top=14,
                       chrome=opts.work / "trace.json" if dev.type == "cuda" else None)
        batches = -(-opts.pairs // BATCH)
        for name, (n, nbytes) in sorted(traced.get("copies", {}).items()):
            print(f"{name}: {nbytes / batches:.0f} bytes per batch in {n / batches:.2f} "
                  f"copies ({batches} batches)")

        ref_args = _args(opts.work / "ref", f1, f2)
        res = subprocess.run([sys.executable, "-c", _REF_RUN, *ref_args], cwd=ROOT,
                             env=dict(os.environ, JAX_PLATFORMS="cpu"),
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"the JAX package's SeqPurge exited "
                               f"{res.returncode}:\n{res.stderr}")
        *_, native, ref_s = res.stdout.strip().splitlines()
        ref_s = float(ref_s)
        _same(opts.work / "port", opts.work / "ref")
        route = "native C++" if native == "True" else "numpy (no native library)"
        print(f"JAX package host route ({route}): {ref_s:.3f} s, "
              f"{opts.pairs / ref_s:.0f} pairs/s; outputs identical to the port's")
    finally:
        shutil.rmtree(opts.work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
