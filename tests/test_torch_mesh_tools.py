"""The port's tools on the mesh route (``NGSBITS_MESH=1``) on the CPU: ReadQC
(-out1/-out2), SeqPurge (-out1/-out2, -qc, -summary), MappingQC -roi -read_qc
(with and without the contamination check), BedCoverage
and BedLowCoverage -min_baseq 20, as ranks of gloo process groups of 1 (in
this process, through a group of its own), 2 and 3 (``mesh.spawn_ranks``).
Each output must be byte-identical to the port without the mesh and to the
JAX package's, apart from qcML ``creation `` lines (FASTQs decompressed).

The inputs come from ``utils/synth.py``. Each tool sees a batch wider than
every world and one narrower than the widest: ReadQC a second file pair of
one read, SeqPurge a last block of one pair, MappingQC a BAM of one pair,
BedCoverage a second BAM of one pair. Also: only rank 0 writes, a rank
that raises ends the run with a non-zero exit on every rank, and work that
takes longer than the group's timeout (rank 0's writers, every rank's
contamination check) does not make a peer's collective time out.
"""

import gzip
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

pytest.importorskip("jax")

from ngsbits_tpu.__main__ import main as jax_main

from ngsbits_tpu_torch.__main__ import main as port_main
from ngsbits_tpu_torch.parallel import mesh
from ngsbits_tpu_torch.utils import synth

RANK_TIMEOUT = 120
CPU_ENV = {"NGSBITS_TORCH_DEVICE": "cpu", "OMP_NUM_THREADS": "1", "NGSBITS_MESH": "1"}
LENGTHS = {"chr1": 1_500_000, "chr2": 1_000_000}

# job -> (tool, arguments; {d} the inputs, {o} the job's output directory)
JOBS = {
    "ReadQC": ("ReadQC", ["-in1", "{d}/r1.fastq.gz", "{d}/t1.fastq.gz", "-in2",
                          "{d}/r2.fastq.gz", "{d}/t2.fastq.gz", "-out", "{o}/out.qcML",
                          "-out1", "{o}/o1.fastq.gz", "-out2", "{o}/o2.fastq.gz"]),
    "SeqPurge": ("SeqPurge", ["-in1", "{d}/p1.fastq.gz", "-in2", "{d}/p2.fastq.gz",
                              "-out1", "{o}/o1.fastq.gz", "-out2", "{o}/o2.fastq.gz",
                              "-qc", "{o}/qc.qcML", "-summary", "{o}/summary.txt",
                              "-block_size", "1000"]),
    "MappingQC": ("MappingQC", ["-in", "{d}/x.bam", "-roi", "{d}/roi.bed", "-ref",
                                "{d}/g.fa", "-out", "{o}/out.qcML", "-read_qc",
                                "{o}/read_qc.qcML", "-no_cont"]),
    "MappingQC-cont": ("MappingQC", ["-in", "{d}/x.bam", "-roi", "{d}/roi.bed", "-ref",
                                     "{d}/g.fa", "-out", "{o}/out.qcML", "-read_qc",
                                     "{o}/read_qc.qcML"]),
    "MappingQC-one-pair": ("MappingQC", ["-in", "{d}/one.bam", "-roi", "{d}/roi.bed", "-ref",
                                         "{d}/g.fa", "-out", "{o}/out.qcML", "-read_qc",
                                         "{o}/read_qc.qcML", "-no_cont"]),
    "BedCoverage": ("BedCoverage", ["-bam", "{d}/x.bam", "{d}/one.bam", "-in", "{d}/roi.bed",
                                    "-out", "{o}/out.bed"]),
    "BedLowCoverage": ("BedLowCoverage", ["-bam", "{d}/x.bam", "-in", "{d}/roi.bed",
                                          "-cutoff", "20", "-min_baseq", "20", "-out",
                                          "{o}/out.bed"]),
}

_RANK = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
from ngsbits_tpu_torch.tools import get_tool
store = os.environ["NGSBITS_MESH_INIT"]
rcs = []
for k, (tool, args) in enumerate(json.loads(sys.argv[1])):
    os.environ["NGSBITS_MESH_INIT"] = f"{store}.{k}"  # a group of its own each run
    rcs.append(get_tool(tool)().execute(args))
print(json.dumps(rcs))
"""


def _args(job: str, d: Path, o: Path) -> list[str]:
    return [a.format(d=d, o=o) for a in JOBS[job][1]]


def _outputs(o: Path) -> dict:
    """Every file of a job's output directory, as compared: FASTQs
    decompressed, qcML without ``creation `` lines."""
    got = {}
    for p in sorted(o.iterdir()):
        data = p.read_bytes()
        if p.name.endswith(".gz"):
            data = gzip.decompress(data)
        elif p.name.endswith(".qcML"):
            data = b"".join(l for l in data.splitlines(True) if b"creation " not in l)
        got[p.name] = data
    return got


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The jobs' inputs, seeded."""
    d = tmp_path_factory.mktemp("mesh_tools")
    synth.synth_fastq(d / "r1.fastq.gz", 3001, 151, seed=1)
    synth.synth_fastq(d / "r2.fastq.gz", 3001, 151, seed=2)
    synth.synth_fastq(d / "t1.fastq.gz", 1, 151, seed=3)
    synth.synth_fastq(d / "t2.fastq.gz", 1, 151, seed=4)
    synth.synth_pairs(d / "p1.fastq.gz", d / "p2.fastq.gz", 2001, seed=5, read_len=151)
    chrom, pos, ref, alt, af = synth.known_snvs(LENGTHS)
    genome = synth.synth_genome(d / "g.fa", LENGTHS, seed=6, set_bases=[
        (name, pos[chrom == k], ref[chrom == k]) for k, name in enumerate(LENGTHS)])
    roi = synth.synth_roi(d / "roi.bed", genome, 120, seed=7, anchors=(chrom, pos - 1))
    synth.synth_bam(d / "x.bam", genome, 6000, seed=8, roi=roi, snps=(chrom, pos - 1, alt))
    synth.synth_bam(d / "one.bam", genome, 1, seed=9, roi=roi)
    return d


@pytest.fixture(scope="module")
def runs(inputs):
    """Every job's outputs: {"jax" | "port" | world: {job: {file: bytes}}}."""
    d = inputs
    out: dict = {}
    mp = pytest.MonkeyPatch()
    # one intra-op thread, as in the ranks: torch's thread pool slows these
    # small runs many times over when the test workers fill the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mp.setenv("NGSBITS_TORCH_DEVICE", "cpu")
        for var in ("NGSBITS_MESH", mesh.INIT_ENV, "WORLD_SIZE", "RANK", "MASTER_ADDR"):
            mp.delenv(var, raising=False)
        for name, main in (("jax", jax_main), ("port", port_main)):
            out[name] = {}
            for job, (tool, _) in JOBS.items():
                o = d / name / job
                o.mkdir(parents=True)
                assert main([tool, *_args(job, d, o)]) == 0, (name, job)
                out[name][job] = _outputs(o)
        # a world of one: this process, through a group of its own
        mp.setenv("NGSBITS_MESH", "1")
        out[1] = {}
        for job, (tool, _) in JOBS.items():
            o = d / "world1" / job
            o.mkdir(parents=True)
            assert port_main([tool, *_args(job, d, o)]) == 0, job
            assert not mesh.active()
            out[1][job] = _outputs(o)
    finally:
        mp.undo()
        torch.set_num_threads(threads)

    def world(n):
        jobs = []
        for job, (tool, _) in JOBS.items():
            o = d / f"world{n}" / job
            o.mkdir(parents=True)
            jobs.append((tool, _args(job, d, o)))
        res = mesh.spawn_ranks(n, [sys.executable, "-c", _RANK, json.dumps(jobs)],
                               env=CPU_ENV, timeout=RANK_TIMEOUT)
        for r, p in enumerate(res):
            assert p.returncode == 0, f"world {n}, rank {r}: {p.stderr[-3000:]}"
            assert json.loads(p.stdout.strip().splitlines()[-1]) == [0] * len(jobs), p.stderr
        return {job: _outputs(d / f"world{n}" / job) for job in JOBS}

    with ThreadPoolExecutor(2) as pool:
        out.update(zip((2, 3), pool.map(world, (2, 3))))
    return out


@pytest.mark.parametrize("world", (1, 2, 3))
@pytest.mark.parametrize("job", sorted(JOBS))
def test_mesh_output_equals_the_port_and_the_jax_package(runs, job, world):
    got, port, jax = runs[world][job], runs["port"][job], runs["jax"][job]
    assert sorted(got) == sorted(port) == sorted(jax)
    assert got, job
    for name in got:
        assert got[name] == port[name], f"{job} {name}: the mesh differs from the port"
        assert got[name] == jax[name], f"{job} {name}: the mesh differs from the JAX package"


def test_reports_read_what_the_inputs_hold(runs):
    """The comparisons above compare reports that count every read."""
    assert b'name="read count" description="Total number of reads (forward and reverse ' \
           b'reads of paired-end sequencing count as two reads)." value="6004"' in \
           runs[3]["ReadQC"]["out.qcML"]
    assert b"Reads (forward + reverse): 4002" in runs[3]["SeqPurge"]["summary.txt"]
    assert b'value="12000"' in runs[3]["MappingQC"]["read_qc.qcML"]
    assert b"SNV allele frequency deviation" in runs[3]["MappingQC-cont"]["out.qcML"]
    assert runs[3]["ReadQC"]["o1.fastq.gz"].count(b"\n") == 4 * 3002


# Work that one rank does alone, or that every rank does after its last
# collective but one, is slowed past a short group timeout: rank 0's writers
# (ReadQC -out1/-out2: BATCH_DELAY a batch, four batches) and the
# contamination check (TAIL_DELAY on every rank). A rank that went ahead would
# wait at its next collective longer than STEP_TIMEOUT and fail there.
STEP_TIMEOUT, BATCH_DELAY, TAIL_DELAY = 6, 2, 8
_SLOWED = r"""
import datetime, sys, time
import torch
torch.set_num_threads(1)
from ngsbits_tpu_torch.io import fastq
from ngsbits_tpu_torch.parallel import mesh
from ngsbits_tpu_torch.qc import mapping_stats
from ngsbits_tpu_torch.tools import get_tool
mesh.TIMEOUT = datetime.timedelta(seconds=%d)
def slowed(f, seconds):
    def run(*a, **k):
        time.sleep(seconds)
        return f(*a, **k)
    return run
fastq.FastqWriter.write_batch = slowed(fastq.FastqWriter.write_batch, %d)
mapping_stats.contamination = slowed(mapping_stats.contamination, %d)
sys.exit(get_tool(sys.argv[1])().execute(sys.argv[2:]))
""" % (STEP_TIMEOUT, BATCH_DELAY, TAIL_DELAY)
SLOWED_JOBS = ("ReadQC", "MappingQC-cont")


@pytest.fixture(scope="module")
def slowed(inputs):
    """Each slowed job as two ranks: their exit codes, stderr and outputs."""
    def run(job):
        o = inputs / "slowed" / job
        o.mkdir(parents=True)
        res = mesh.spawn_ranks(2, [sys.executable, "-c", _SLOWED, JOBS[job][0],
                                   *_args(job, inputs, o)], env=CPU_ENV, timeout=RANK_TIMEOUT)
        return [(p.returncode, p.stderr[-3000:]) for p in res], _outputs(o)

    with ThreadPoolExecutor(2) as pool:
        return dict(zip(SLOWED_JOBS, pool.map(run, SLOWED_JOBS)))


@pytest.mark.parametrize("job", SLOWED_JOBS)
def test_ranks_stay_in_step_past_the_group_timeout(runs, slowed, job):
    """Rank 0's writers and the contamination check each take longer than
    the group's timeout; every rank still exits 0 with the world of one's
    outputs."""
    rcs, got = slowed[job]
    assert [rc for rc, _ in rcs] == [0, 0], rcs
    assert got == runs[1][job]


_RAISING = r"""
import os, sys
import torch
torch.set_num_threads(1)
from ngsbits_tpu_torch.qc import read_stats
from ngsbits_tpu_torch.tools import get_tool
if os.environ["RANK"] == "1":
    def fail(self, batch, direction):
        raise RuntimeError("rank 1 fails on its first batch")
    read_stats.ReadStatistics.update_batch = fail
sys.exit(get_tool("ReadQC")().execute(sys.argv[1:]))
"""


@pytest.mark.parametrize("n", (2, 3))
def test_a_rank_that_raises_ends_the_run_on_every_rank(tmp_path, n):
    """Rank 1 raises inside the tool: it leaves the group, the others' next
    collective fails, and every rank exits non-zero well inside the
    timeout; no rank wrote the report."""
    synth.synth_fastq(tmp_path / "r.fastq.gz", 50, 151, seed=11)
    out = tmp_path / "out.qcML"
    res = mesh.spawn_ranks(n, [sys.executable, "-c", _RAISING, "-in1",
                               str(tmp_path / "r.fastq.gz"), "-out", str(out)],
                           env=CPU_ENV, timeout=RANK_TIMEOUT)
    assert all(p.returncode not in (0, None) and p.returncode > 0 for p in res), \
        [(p.returncode, p.stderr[-500:]) for p in res]
    assert "rank 1 fails on its first batch" in res[1].stderr
    assert not out.exists()


def test_only_rank_0_writes(tmp_path):
    """ReadQC -txt without -out writes its report to STDOUT: rank 0's
    carries it, rank 1's is empty."""
    synth.synth_fastq(tmp_path / "r.fastq.gz", 20, 151, seed=12)
    res = mesh.spawn_ranks(2, [sys.executable, "-m", "ngsbits_tpu_torch", "ReadQC", "-in1",
                               str(tmp_path / "r.fastq.gz"), "-txt"], env=CPU_ENV,
                           timeout=RANK_TIMEOUT)
    assert [p.returncode for p in res] == [0, 0], [p.stderr[-500:] for p in res]
    assert "read count: 20\n" in res[0].stdout
    assert res[1].stdout == ""
