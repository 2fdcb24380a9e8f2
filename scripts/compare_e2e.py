#!/usr/bin/env python3
"""ReadQC, SeqPurge and MappingQC end to end: this checkout against another, in turns.

    python3 scripts/compare_e2e.py --other DIR [--reads 2000000]
                                   [--tools ReadQC,SeqPurge,MappingQC]

Writes the inputs chip_smoke.py drives (a seeded paired gzip FASTQ of
2 x N reads x 151 bp for ReadQC, seeded short-insert read pairs for
SeqPurge, the synthetic exome for MappingQC: genome, panel and a BAM of
N pairs, ``-roi -read_qc`` with the contamination check) under
build/compare_e2e/, then runs each tool in a fresh process from each
checkout (``python -c``, the checkout's own ``ngsbits_tpu_torch``), in the
order other, this, this, other, so that a drift of the shared host shows in
both. Each process times ``tool.execute`` itself, from the call to the last
device synchronisation; a first run per checkout on a short prefix builds
its libraries, untimed. Prints reads/s (both mates; MappingQC: the BAM's
records) or pairs/s per run, with the tool's seconds by stage (SeqPurge's
engine, MappingQC's passes), and, last, one JSON line with every run. The
device is the one NGSBITS_TORCH_DEVICE names (cuda by default).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WORK = ROOT / "build" / "compare_e2e"
READ_LEN = 151

_RUN = """
import json, sys, time, torch
sys.path.insert(0, '.')
from ngsbits_tpu_torch.tools import get_tool
tool = get_tool(sys.argv[1])()
t0 = time.perf_counter()
rc = tool.execute(sys.argv[2:])
if torch.cuda.is_available():
    torch.cuda.synchronize()
seconds = time.perf_counter() - t0
print(json.dumps(getattr(getattr(tool, "engine", None), "seconds", None)
                 or getattr(tool, "seconds", {})))
print(seconds, rc)
"""


def _run(tree: Path, args: list[str]) -> tuple[float, dict]:
    res = subprocess.run([sys.executable, "-c", _RUN, *args], cwd=tree,
                         capture_output=True, text=True, env=dict(os.environ))
    if res.returncode != 0:
        raise RuntimeError(f"{tree}: {args[0]} failed:\n{res.stderr[-4000:]}")
    *_, stages, last = res.stdout.splitlines()
    seconds, rc = last.split()
    if rc != "0":
        raise RuntimeError(f"{tree}: {args[0]} exited {rc}:\n{res.stderr[-4000:]}")
    return float(seconds), json.loads(stages)


def _prefix(src: Path, dst: Path, n_reads: int):
    import gzip
    with gzip.open(src, "rb") as fin, gzip.open(dst, "wb", compresslevel=1) as fout:
        for _ in range(4 * n_reads):
            fout.write(fin.readline())


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="the checkout to compare with (e.g. the parent commit)")
    ap.add_argument("--reads", type=int, default=2_000_000,
                    help="reads per mate and pairs (default 2,000,000)")
    ap.add_argument("--tools", default="ReadQC,SeqPurge,MappingQC",
                    help="the tools to compare, comma-separated (default: all three)")
    args = ap.parse_args(argv)
    tools = args.tools.split(",")
    sys.path.insert(0, str(ROOT))
    from ngsbits_tpu_torch.utils import synth
    from ngsbits_tpu_torch.utils.synth import synth_fastq, synth_pairs

    WORK.mkdir(parents=True, exist_ok=True)
    trees = {"other": args.other.resolve(), "this": ROOT}
    try:
        rq = [WORK / "rq1.fastq.gz", WORK / "rq2.fastq.gz"]
        sp = [WORK / "sp1.fastq.gz", WORK / "sp2.fastq.gz"]
        mq = [WORK / "mq.bam", WORK / "mq.bed", WORK / "mq.fa"]
        if "ReadQC" in tools:
            synth_fastq(rq[0], args.reads, READ_LEN, seed=42)
            synth_fastq(rq[1], args.reads, READ_LEN, seed=43)
        synth_pairs(sp[0], sp[1], args.reads if "SeqPurge" in tools else 10_000, seed=7,
                    read_len=READ_LEN)
        small = [WORK / "small1.fastq.gz", WORK / "small2.fastq.gz"]
        for src, dst in zip(sp, small):
            _prefix(src, dst, 10_000)
        if "MappingQC" in tools:  # a synthetic exome: 24 chromosomes of 8 Mb
            lengths = {f"chr{c}": 8_000_000 for c in [*range(1, 23), "X", "Y"]}
            chrom, pos, ref, alt, _ = synth.known_snvs(lengths)
            genome = synth.synth_genome(mq[2], lengths, seed=11, set_bases=[
                (name, pos[chrom == k], ref[chrom == k]) for k, name in enumerate(lengths)])
            roi = synth.synth_roi(mq[1], genome, 60_000, seed=12, anchors=(chrom, pos - 1))
            synth.synth_bam(mq[0], genome, args.reads, seed=13, roi=roi,
                            snps=(chrom, pos - 1, alt))

        def readqc(name, files):
            return ["ReadQC", "-in1", str(files[0]), "-in2", str(files[1]),
                    "-out", str(WORK / f"{name}.qcML")]

        def seqpurge(name, files):
            return ["SeqPurge", "-in1", str(files[0]), "-in2", str(files[1]),
                    "-out1", str(WORK / f"{name}.1.fastq.gz"),
                    "-out2", str(WORK / f"{name}.2.fastq.gz"),
                    "-qc", str(WORK / f"{name}.sp.qcML"),
                    "-summary", str(WORK / f"{name}.summary.txt")]

        for name, tree in trees.items():  # builds each checkout's libraries
            _run(tree, seqpurge(f"warm_{name}", small))
        def mappingqc(name, files):
            return ["MappingQC", "-in", str(files[0]), "-roi", str(files[1]), "-ref",
                    str(files[2]), "-out", str(WORK / f"{name}.mq.qcML"), "-read_qc",
                    str(WORK / f"{name}.rq.qcML")]

        runs = []
        for tool, make, count, files in (("ReadQC", readqc, 2 * args.reads, rq),
                                         ("SeqPurge", seqpurge, args.reads, sp),
                                         ("MappingQC", mappingqc, 2 * args.reads, mq)):
            if tool not in tools:
                continue
            for i, name in enumerate(("other", "this", "this", "other")):
                seconds, stages = _run(trees[name], make(f"{name}{i}", files))
                unit = "pairs/s" if tool == "SeqPurge" else "reads/s"
                split = ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
                print(f"{tool:8s} {name:5s} run {i}: {seconds:.3f} s, "
                      f"{count / seconds:.0f} {unit}" + (f"; {split}" if split else ""),
                      flush=True)
                runs.append(dict(tool=tool, tree=name, seconds=seconds,
                                 rate=count / seconds, unit=unit, stages=stages))
        print(json.dumps({"compare_e2e": runs}))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
