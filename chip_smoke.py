#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phase kernels]

Phases, each of which raises on failure (the script then exits non-zero):

1. probe    a CUDA device is required; prints the card's name and power
            limit, and the toolchain (torch's CUDA, nvcc, triton).
2. build    compiles the port's host library (g++, native/ngshost.cpp) and
            its kernels (nvcc, one process per csrc/*.cu, all at once) side
            by side; prints the seconds of each.
3. kernels  each kernel against its plain torch version on the card, integer
            outputs equal. K1 at six inputs (``K1_INPUTS``): the main path's
            (B=65536 reads of 151 bp in the L=192 bucket, 6-bit quals binned
            to Q2/12/23/37), the same with uniform quals, ragged lengths with
            6- and 8-bit quals, SeqPurge's -qc bucket (B=16384, 10,000 reads)
            and long reads (B=1024, L=10240); unpack and tails at each, timed
            at the first and at the -qc bucket (unpack on the rows that hold
            reads, as the stream step hands them: 65,536 and 10,000).
            SeqPurge's three scans at their main path's batch (B=10000 pairs,
            L=151) and at a ragged B=1237, L=250, with adapters with and
            without N and adapter prefixes of 15 and 20 bases (off the main
            batch: random bytes past the reads and all-N pairs); K2 also on
            wide rows at the edges of its contract (B=1000, L=1000 and B=3,
            L=24,576: min_len below 0 and above L, bytes outside ACGTN,
            all-N pairs, random bytes past min_len); its
            decisions (``seqpurge_decide``) on the scans of a library with
            adapters at the main batch, with and without -ec, at B=1237,
            L=250 and at B=1237, L=999 (rows too wide to stage, read where
            they lie; per-pair results, accumulators and corrected reads
            equal). Times per
            call (``ops/selfcheck.py``): ``ms`` device time (10 calls captured
            in a CUDA graph, replays between CUDA events, median of 5,
            L2-warm); ``call_ms`` the same 10 calls made from Python (the
            wrapper's host work included); ``cold_ms`` (every kernel at its
            main input) one call after a 128 MB overwrite
            and read, median of 20, and the share of the bound against it;
            ``plain_ms`` as ``call_ms``.
            ``--phase kernels`` stops here.
4. readqc   a seeded paired gzip FASTQ (2 x 2,000,000 reads x 151 bp) through
            the port's ReadQC CLI on the card, qcML then TXT, with every launch
            count reset before and read after (each ReadQC kernel's
            ``launches`` and ``launches_by_tool["ReadQC"]``, from the qcML run);
            then the first 200,000 reads of
            each file through ReadQC on the card and through the port's CPU
            route (NGSBITS_TORCH_DEVICE=cpu, a subprocess): qcML and TXT must
            be byte-identical once ``creation `` lines are dropped.
5. seqpurge seeded read pairs of a short-insert library (2 x 2,000,000 x 151
            bp) through the port's SeqPurge CLI on the card with -qc and
            -summary, counts reset before and read after: all seven kernels
            launched, the decisions once per batch of 10,000 pairs (200
            times), and neither jax nor the JAX package loaded; each kernel's
            ``launches_by_tool["SeqPurge"]`` (the ReadQC kernels run on its
            -qc stream at B=16384). Prints
            pairs/s and the seconds by stage (scans and decisions: device
            time). Then the first 100,000 pairs on the card and on the
            CPU route, with the default flags and once with -ec -out3:
            decompressed FASTQs and the summary identical, qcML identical once
            ``creation `` lines are dropped.

The CPU route is where the plain kernel versions run; the CPU tests hold them
against the JAX package. This script imports only torch, numpy, the stdlib and
ngsbits_tpu_torch. Before its last line it prints one JSON line with the
kernels' records (the times at each kernel's main shape, K1's at each
input under ``inputs``, unpack's and tails' at both of their shapes under
``shapes``; ``bound_ms`` is the larger of bytes over 3.35 TB/s and
integer operations over 16.7 T/s, K1's bytes those inside the reads, K2's
operations its compares four to a 32-bit operation, the decisions' bytes
the counts and bases that their inputs need them to read).
The last line is {"ok": true, "device": {...}}. Data is written under
build/chip_smoke/ and removed at the end.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import shutil
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
N_READS, READ_LEN = 2_000_000, 151
RQ_PREFIX, SP_PREFIX = 200_000, 100_000
A1 = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
A2 = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
ADAPTERS = {"default": (A1, A2),
            "with_n": (b"AGANCGGAAGNGCACACGTC", b"NGATCGGAAGAGCGTCGTGN")}
# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s; int32 operations/s,
# 132 SMs x 64 INT32 lanes x 1.98 GHz
PEAK_BYTES, PEAK_INT_OPS = 3.35e12, 16.7e12
KERNELS = {  # name: (source, the TPU/XLA function it replaces)
    "readqc_unpack": ("ngsbits_tpu_torch/csrc/readqc.cu", "ngsbits_tpu/ops/readqc.py:144"),
    "readqc_batch": ("ngsbits_tpu_torch/csrc/readqc.cu", "ngsbits_tpu/ops/pallas_kernels.py:53"),
    "readqc_tails": ("ngsbits_tpu_torch/csrc/readqc.cu", "ngsbits_tpu/ops/readqc.py:183"),
    "insert_scan": ("ngsbits_tpu_torch/csrc/seqpurge.cu", "ngsbits_tpu/ops/pallas_kernels.py:153"),
    "adapter_evidence": ("ngsbits_tpu_torch/csrc/seqpurge.cu", "ngsbits_tpu/ops/seqpurge.py:123"),
    "adapter_scan": ("ngsbits_tpu_torch/csrc/seqpurge.cu", "ngsbits_tpu/ops/seqpurge.py:147"),
    # not a TPU kernel: the JAX package's host decisions (and native/seqpurge.cpp:116)
    "seqpurge_decide": ("ngsbits_tpu_torch/csrc/seqpurge_decide.cu",
                        "ngsbits_tpu/qc/seqpurge.py:267"),
}
SP_BATCH = 10000  # SeqPurge's -block_size: one decisions launch per batch


def phase(name: str):
    print(f"== {name}", flush=True)


def run(cmd: list[str], **kw) -> subprocess.CompletedProcess:
    res = subprocess.run(cmd, capture_output=True, text=True, **kw)
    if res.returncode != 0:
        raise RuntimeError(f"{cmd[0]} exited {res.returncode}:\n{res.stderr}")
    return res


# ------------------------------------------------------------------ phases

def probe():
    phase("probe")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA runtime {torch.version.cuda}, "
          f"devices {torch.cuda.device_count()}, {torch.cuda.get_device_name(0)}")
    from ngsbits_tpu_torch.ops import _build
    nvcc = _build.nvcc_path()
    print(f"nvcc {nvcc}: {run([nvcc, '--version']).stdout.strip().splitlines()[-1]}")
    try:
        import triton
        print(f"triton {triton.__version__} imports")
    except ImportError as exc:
        print(f"triton does not import: {exc}")


def build():
    phase("build")
    from ngsbits_tpu_torch.io import native
    from ngsbits_tpu_torch.ops import _build
    host: dict = {}

    def build_host():
        try:
            host["result"] = native.build()
        except Exception as exc:  # noqa: BLE001 — re-raised below
            host["error"] = exc

    t = threading.Thread(target=build_host)
    t.start()
    so, seconds = _build.build()
    t.join()
    if "error" in host:
        raise host["error"]
    hso, hseconds = host["result"]
    print(f"built {hso.relative_to(ROOT)} (g++) in {hseconds:.2f} s")
    print(f"built {so.relative_to(ROOT)} (nvcc) in {seconds:.2f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())
    _build.library()
    native.get_lib()


# K1's inputs: (label, B, L, qual_bits, quality profile, read length or None
# for ragged lengths 0..L, valid rows or None for all but the last eighth).
# The first is the main path's: full ReadQC batches of 151 bp reads from a
# binning instrument.
K1_INPUTS = [
    ("B=65536 L=192 151bp binned", 65536, 192, 6, "binned", 151, 65536),
    ("B=65536 L=192 151bp uniform", 65536, 192, 6, "uniform", 151, 65536),
    ("B=65536 L=192 ragged uniform", 65536, 192, 6, "uniform", None, None),
    ("B=65536 L=192 ragged uniform 8-bit", 65536, 192, 8, "uniform", None, None),
    ("B=16384 L=192 10000x151bp binned", 16384, 192, 6, "binned", 151, 10000),
    ("B=1024 L=10240 ragged uniform 8-bit", 1024, 10240, 8, "uniform", None, None),
]
# where unpack and tails are timed: ReadQC's batch and SeqPurge's -qc bucket
STREAM_SHAPES = (K1_INPUTS[0][0], K1_INPUTS[4][0])


def _check_equal(case, label: str) -> int:
    from ngsbits_tpu_torch.ops import selfcheck
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    err = selfcheck.max_abs_err(case)
    if err != 0:
        raise AssertionError(f"{case.name} ({label}) differs from its plain "
                             f"version: max abs err {err}")
    return err


def _record(records: dict, case, label: str, main_shape: bool,
            cold: bool = False) -> dict:
    """Checks the case, times it and returns its numbers; at the kernel's
    main shape they become its record's."""
    from ngsbits_tpu_torch.ops import selfcheck
    err = _check_equal(case, label)
    bytes_ms = case.bytes / PEAK_BYTES * 1e3
    ops_ms = case.ops / PEAK_INT_OPS * 1e3
    got = dict(shape=label, ms=selfcheck.device_ms(case.kernel),
               call_ms=selfcheck.call_ms(case.kernel),
               plain_ms=selfcheck.call_ms(case.plain),
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bytes=case.bytes)
    if cold:
        got["cold_ms"] = selfcheck.cold_ms(case.kernel)
    print(f"{case.name:16s} {label}: equal; device {got['ms']:.4f} ms"
          + (f", cold {got['cold_ms']:.4f} ms ({got['bound_ms'] / got['cold_ms']:.1%} "
             f"of the bound)" if cold else "")
          + f", per wrapper call {got['call_ms']:.4f} ms, plain "
          f"{got['plain_ms']:.4f} ms; bound {got['bound_ms']:.4f} ms "
          f"({case.bytes} B, {case.ops} int ops)", flush=True)
    source, replaces = KERNELS[case.name]
    rec = records.setdefault(case.name, {
        "name": case.name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": 0, "max_abs_err": 0})
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    if main_shape:
        rec.update({k: v for k, v in got.items() if k != "bytes"}, library_ms=None)
    return got


def kernels(dev: torch.device) -> dict:
    """Every kernel against its plain version; device, per-call and plain
    times. K1 at each of ``K1_INPUTS`` (warm and cold); unpack and tails at
    each, timed (warm and cold) at ``STREAM_SHAPES``; the scans and the
    decisions warm and cold at their main inputs, K2 also at its edges."""
    from ngsbits_tpu_torch.ops import selfcheck
    records: dict = {}
    phase("kernels: ReadQC")
    k1, stream = [], {"readqc_unpack": [], "readqc_tails": []}
    for i, (label, B, L, qual_bits, profile, read_len, n_valid) in enumerate(K1_INPUTS):
        for case in selfcheck.cases(B, L, qual_bits, dev, seed=i, profile=profile,
                                    read_len=read_len, n_valid=n_valid):
            if case.name == "readqc_batch":
                k1.append(_record(records, case, label, i == 0, cold=True))
            elif label in STREAM_SHAPES:
                stream[case.name].append(_record(records, case, label, i == 0, cold=True))
            else:
                _check_equal(case, label)
    records["readqc_batch"]["inputs"] = k1
    for name, shapes in stream.items():
        records[name]["shapes"] = shapes
    phase("kernels: SeqPurge at B=10000, L=151 and B=1237, L=250 (random bytes "
          "past the reads, all-N pairs); K2 at B=1000, L=1000 and B=3, L=24576 "
          "(its edges)")
    for (B, L) in ((10000, 151), (1237, 250)):
        for name, (a1, a2) in sorted(ADAPTERS.items()):
            for a_size in (20, 15):
                main = (B, L, name, a_size) == (10000, 151, "default", 20)
                for case in selfcheck.seqpurge_cases(B, L, dev, a1, a2, a_size=a_size,
                                                     seed=B + a_size, dirty=not main):
                    _record(records, case, f"B={B} L={L} {name} a_size={a_size}", main,
                            cold=main)
    for B, L in ((1000, 1000), (3, 24576)):
        case = selfcheck.insert_case(*(torch.from_numpy(a).to(dev) for a in
                                       selfcheck.insert_edge_pairs(B, L, seed=B + L)))
        label = f"B={B} L={L} edges"
        _check_equal(case, label)
        print(f"{case.name:16s} {label}: equal", flush=True)
    phase("kernels: SeqPurge decisions at B=10000, L=151 (with and without -ec), "
          "B=1237, L=250 and B=1237, L=999 (random bytes past the reads, all-N pairs)")
    for B, L, name, ec in ((SP_BATCH, READ_LEN, "default", False),
                           (SP_BATCH, READ_LEN, "default", True),
                           (1237, 250, "default", False), (1237, 250, "with_n", True),
                           (1237, 999, "default", True)):
        main = (B, L, ec) == (SP_BATCH, READ_LEN, False)
        case = selfcheck.decide_case(B, L, dev, *ADAPTERS[name], ec=ec, seed=B + L,
                                     dirty=L != READ_LEN)
        label = f"B={B} L={L} {name}{' -ec' if ec else ''}"
        if main:
            _record(records, case, label, True, cold=True)
        else:
            _check_equal(case, label)
            print(f"{case.name:16s} {label}: equal", flush=True)
    return records


def _drop_creation(path: Path) -> list[str]:
    return [line for line in path.read_text().splitlines() if "creation " not in line]


def _reset():
    from ngsbits_tpu_torch.ops import KERNELS as wrappers
    for k in wrappers:
        k.launches = 0


def _launches() -> dict:
    from ngsbits_tpu_torch.ops import KERNELS as wrappers
    return {k.__name__.removesuffix("_into"): k.launches for k in wrappers}


def _port(args: list[str]):
    """A port tool in this process, on the card: (tool, seconds)."""
    from ngsbits_tpu_torch.tools import get_tool
    tool = get_tool(args[0])()
    t0 = time.perf_counter()
    rc = tool.execute(args[1:])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"port {args[0]} exited {rc}")
    return tool, seconds


def _port_on_cpu(args: list[str]):
    """A port tool on its CPU route, in a subprocess."""
    run([sys.executable, "-m", "ngsbits_tpu_torch", *args], cwd=ROOT,
        env=dict(os.environ, NGSBITS_TORCH_DEVICE="cpu"))


def _prefix(src: Path, dst: Path, n_reads: int):
    """The first n_reads records of a gzip FASTQ, as gzip."""
    with gzip.open(src, "rb") as fin, gzip.open(dst, "wb", compresslevel=1) as fout:
        for _ in range(4 * n_reads):
            fout.write(fin.readline())


def _jax_loaded() -> list[str]:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "ngsbits_tpu"))


def readqc(records: dict):
    phase(f"readqc: 2 x {N_READS} reads x {READ_LEN} bp")
    from ngsbits_tpu_torch.utils.synth import synth_fastq
    f1, f2 = WORK / "rq1.fastq.gz", WORK / "rq2.fastq.gz"
    t0 = time.perf_counter()
    synth_fastq(f1, N_READS, READ_LEN, seed=42)
    synth_fastq(f2, N_READS, READ_LEN, seed=43)
    print(f"generated {f1.stat().st_size + f2.stat().st_size} gzip bytes in "
          f"{time.perf_counter() - t0:.2f} s")
    total = 2 * N_READS
    for fmt, flags in (("qcML", []), ("txt", ["-txt"])):
        out = WORK / f"ReadQC.{fmt}"
        _reset()
        _, seconds = _port(["ReadQC", "-in1", str(f1), "-in2", str(f2),
                            "-out", str(out), *flags])
        launches = _launches()
        for name in ("readqc_unpack", "readqc_batch", "readqc_tails"):
            if launches[name] == 0:
                raise AssertionError(f"{name} was not launched by ReadQC: {launches}")
            if fmt == "qcML":
                records[name]["launches"] = launches[name]
                records[name]["launches_by_tool"] = {"ReadQC": launches[name]}
        if fmt == "txt" and f"read count: {total}" not in out.read_text():
            raise AssertionError("TXT output lacks the expected read count")
        print(f"ReadQC {fmt} on {torch.cuda.get_device_name(0)}: {seconds:.3f} s, "
              f"{total / seconds:.0f} reads/s; launches {launches}")

    p1, p2 = WORK / "rq1.prefix.fastq.gz", WORK / "rq2.prefix.fastq.gz"
    _prefix(f1, p1, RQ_PREFIX)
    _prefix(f2, p2, RQ_PREFIX)
    for fmt, flags in (("qcML", []), ("txt", ["-txt"])):
        out = WORK / f"ReadQC.prefix.{fmt}"  # one path: qcML records the command line
        args = ["ReadQC", "-in1", str(p1), "-in2", str(p2), "-out", str(out), *flags]
        _port(args)
        on_card = out.replace(out.with_name(f"card.{out.name}"))
        _port_on_cpu(args)
        if _drop_creation(on_card) != _drop_creation(out):
            raise AssertionError(f"ReadQC {fmt}: card and CPU route differ")
        print(f"ReadQC {fmt} on 2 x {RQ_PREFIX} reads: card == CPU route")
    if _jax_loaded():
        raise AssertionError(f"the port loaded {_jax_loaded()}")


def _seqpurge_args(d: Path, i1: Path, i2: Path, extra: list[str]) -> list[str]:
    d.mkdir(parents=True, exist_ok=True)
    return ["SeqPurge", "-in1", str(i1), "-in2", str(i2),
            "-out1", str(d / "out1.fastq.gz"), "-out2", str(d / "out2.fastq.gz"),
            "-qc", str(d / "qc.qcML"), "-summary", str(d / "summary.txt"),
            *[a.format(d=d) for a in extra]]


def _same_outputs(card: Path, cpu: Path):
    names = sorted(p.name for p in card.iterdir())
    if names != sorted(p.name for p in cpu.iterdir()):
        raise AssertionError(f"outputs differ: {names}")
    for name in names:
        a, b = card / name, cpu / name
        if name.endswith(".gz"):
            same = gzip.decompress(a.read_bytes()) == gzip.decompress(b.read_bytes())
        elif name.endswith(".qcML"):
            same = _drop_creation(a) == _drop_creation(b)
        else:
            same = a.read_bytes() == b.read_bytes()
        if not same:
            raise AssertionError(f"SeqPurge {name}: card and CPU route differ")
    return names


def seqpurge(records: dict):
    phase(f"seqpurge: 2 x {N_READS} pairs x {READ_LEN} bp, -qc -summary")
    from ngsbits_tpu_torch.utils.synth import synth_pairs
    f1, f2 = WORK / "sp1.fastq.gz", WORK / "sp2.fastq.gz"
    t0 = time.perf_counter()
    synth_pairs(f1, f2, N_READS, seed=7, read_len=READ_LEN)
    print(f"generated {f1.stat().st_size + f2.stat().st_size} gzip bytes in "
          f"{time.perf_counter() - t0:.2f} s")
    _reset()
    tool, seconds = _port(_seqpurge_args(WORK / "sp_full", f1, f2, []))
    launches = _launches()
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched by SeqPurge -qc: {launches}")
    if launches["seqpurge_decide"] != N_READS // SP_BATCH:
        raise AssertionError(f"seqpurge_decide launched {launches['seqpurge_decide']} "
                             f"times, not once per batch ({N_READS // SP_BATCH})")
    for name in ("insert_scan", "adapter_evidence", "adapter_scan", "seqpurge_decide"):
        records[name]["launches"] = launches[name]
    for name, rec in records.items():
        rec.setdefault("launches_by_tool", {})["SeqPurge"] = launches[name]
    if _jax_loaded():
        raise AssertionError(f"the port loaded {_jax_loaded()}")
    summary = (WORK / "sp_full" / "summary.txt").read_text()
    if f"Reads (forward + reverse): {2 * N_READS}" not in summary:
        raise AssertionError("the summary lacks the expected read count")
    print(summary.split("\n\nForward adapter")[0])
    stages = tool.engine.seconds
    split = ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
    print(f"SeqPurge on {torch.cuda.get_device_name(0)}: {seconds:.3f} s, "
          f"{N_READS / seconds:.0f} pairs/s; seconds by stage: {split} "
          f"(scans: device time of the three scans; decisions: device time of "
          f"seqpurge_decide plus the host's fold of its accumulators; the rest "
          f"host time on the consumer thread); decisions + fetch "
          f"{stages['decisions'] + stages['fetch']:.3f} s; launches {launches}")

    p1, p2 = WORK / "sp1.prefix.fastq.gz", WORK / "sp2.prefix.fastq.gz"
    _prefix(f1, p1, SP_PREFIX)
    _prefix(f2, p2, SP_PREFIX)
    for label, extra in (("defaults", []), ("-ec -out3", ["-ec", "-out3", "{d}/single"])):
        _port(_seqpurge_args(WORK / "sp_card", p1, p2, extra))
        _port_on_cpu(_seqpurge_args(WORK / "sp_cpu", p1, p2, extra))
        names = _same_outputs(WORK / "sp_card", WORK / "sp_cpu")
        print(f"SeqPurge {label} on {SP_PREFIX} pairs: card == CPU route ({', '.join(names)})")
        shutil.rmtree(WORK / "sp_card")
        shutil.rmtree(WORK / "sp_cpu")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", choices=("all", "kernels"), default="all",
                    help="'kernels' stops after the kernels phase (no "
                         "ReadQC or SeqPurge run, so no launch counts)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import ngsbits_tpu_torch  # noqa: F401  fails outside a checkout of the repo
    os.environ["NGSBITS_TORCH_DEVICE"] = "cuda"
    dev = torch.device("cuda")
    probe()
    build()
    records = kernels(dev)
    if args.phase == "all":
        WORK.mkdir(parents=True, exist_ok=True)
        try:
            readqc(records)
            seqpurge(records)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
