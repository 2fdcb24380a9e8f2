"""Coverage tools: BedCoverage, BedLowCoverage, BedHighCoverage and
BedAnnotateFreq.

Counterpart of ``ngsbits_tpu/tools/coverage_tools.py`` (BedReadCount stays
with the JAX package: it does no device work). Behavioral reference: ngs-bits
src/BedCoverage/main.cpp, src/BedLowCoverage/main.cpp,
src/BedHighCoverage/main.cpp, src/BedAnnotateFreq/main.cpp.

``seconds`` holds, after a run, the seconds of the BAM pass (host decode and
filter, C1), the finalize (C2, then R1 or R2, and their fetch) and the
output; ``finalizes`` each finalize's (positions, bytes fetched).
With ``NGSBITS_MESH`` set, BedCoverage, BedLowCoverage and BedHighCoverage
run as ranks of a process group, each passing its share of every batch to C1
(``parallel/mesh.py``); rank 0 writes the output.
BedAnnotateFreq's pileups run B1's record form, one sweep of each BAM; its
``seconds`` hold the set-up (the BED), the pileups (``pileup``, and their
``sweep`` and ``fetch``) and the output.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from ..core.intervals import BedFile
from ..parallel import mesh
from ..qc import coverage as cov
from ..qc import pileup as pm
from .toolbase import ToolBase, ToolError


def _base_name(path: str) -> str:
    # QFileInfo::baseName — up to the first dot
    return os.path.basename(path).split(".")[0]


class _CoverageTool(ToolBase):
    mesh_route = True

    def __init__(self):
        super().__init__()
        self.stats: dict = {}

    @property
    def seconds(self) -> dict:
        return {k: self.stats.get(k, 0.0) for k in ("pass", "finalize", "output")}

    @property
    def finalizes(self) -> list:
        return self.stats.get("finalizes", [])


class BedCoverageTool(_CoverageTool):
    name = "BedCoverage"
    description = "Annotates a BED file with the average coverage of the regions from one or several BAM/CRAM file(s)."

    def setup(self):
        self.add_infile_list("bam", "Input BAM/CRAM file(s).")
        self.add_int("min_mapq", "Minimum mapping quality.", optional=True, default=1)
        self.add_infile("in", "Input BED file. If unset, reads from STDIN.", optional=True)
        self.add_int("decimals", "Number of decimals used in output.", optional=True, default=2)
        self.add_outfile("out", "Output BED file. If unset, writes to STDOUT.", optional=True)
        self.add_infile("ref", "Reference genome for CRAM support (mandatory if CRAM is used).", optional=True)
        self.add_flag("clear", "Clear previous annotation columns before annotating (starting from 4th column).")
        self.add_int("threads", "Number of threads used.", optional=True, default=1)
        self.add_flag("random_access", "Use random access via index to get reads from BAM/CRAM instead of chromosome-wise sweep. Random access is quite slow, especially on CRAM, so use it only if a small subset of the file needs to be accessed.")
        self.add_flag("debug", "Enable debug output.")
        self.add_flag("skip_mismapped", "Skip reads with mapping quality less than 20 that are not properly paired (they are often mis-mapped).")

    def main(self):
        f = BedFile.from_file(self.get("in"))
        if self.get_flag("clear"):
            f.headers = []
            f.clear_annotations()
        header = "#chr\tstart\tend"
        for bam in self.get_infile_list("bam"):
            cov.avg_coverage(f, bam, self.get_int("min_mapq"), self.get_int("threads"),
                             self.get_int("decimals"), self.get_flag("skip_mismapped"),
                             stats=self.stats)
            header += "\t" + _base_name(bam)
        f.headers.append(header.encode())
        if mesh.writes():
            f.store(self.get("out"))


class _LowOrHighBase(_CoverageTool):
    is_high = False

    def setup(self):
        self.add_infile("bam", "Input BAM/CRAM file.")
        self.add_int("cutoff", "Minimum depth to consider a base 'high coverage'.")
        self.add_infile("in", "Input BED file containing the regions of interest. If unset, reads from STDIN.", optional=True)
        self.add_flag("random_access", "Use random access via index to get reads from BAM/CRAM instead of chromosome-wise sweep. Random access is quite slow, so use it only if a small subset of the file needs to be accessed.")
        self.add_outfile("out", "Output BED file. If unset, writes to STDOUT.", optional=True)
        self.add_int("min_mapq", "Minimum mapping quality to consider a read.", optional=True, default=1)
        self.add_int("min_baseq", "Minimum base quality to consider a base.", optional=True, default=0)
        self.add_infile("ref", "Reference genome for CRAM support (mandatory if CRAM is used).", optional=True)
        self.add_int("threads", "Number of threads used.", optional=True, default=1)
        self.add_flag("debug", "Enable debug output.")

    def main(self):
        in_path = self.get("in")
        bam = self.get("bam")
        f = BedFile.from_file(in_path)
        f.merge(True, True)
        output = cov.low_or_high_coverage(f, bam, self.get_int("cutoff"),
                                          self.get_int("min_mapq"), self.get_int("min_baseq"),
                                          self.get_int("threads"), self.is_high,
                                          stats=self.stats)
        if not self.is_high:
            output.headers.append(b"#BAM: " + os.path.basename(bam).encode())
            output.headers.append(b"#ROI: " + os.path.basename(in_path or "").encode())
            output.headers.append(b"#ROI regions: " + str(len(f)).encode())
            output.headers.append(b"#ROI bases: " + str(f.base_count()).encode())
        if mesh.writes():
            output.store(self.get("out"))


class BedLowCoverageTool(_LowOrHighBase):
    name = "BedLowCoverage"
    description = "Detects low-coverage regions from a BAM/CRAM file."
    is_high = False


class BedHighCoverageTool(_LowOrHighBase):
    name = "BedHighCoverage"
    description = "Detects high-coverage regions from a BAM/CRAM file."
    is_high = True


class BedAnnotateFreqTool(ToolBase):
    """Behavioral reference: ngs-bits src/BedAnnotateFreq/main.cpp (pileup at
    single-base regions; min_baseq default 25, proper pairs unless long_read)."""

    name = "BedAnnotateFreq"
    description = "Extracts base counts and depth in the given regions from a BAM/CRAM files."

    def setup(self):
        self.add_infile_list("bam", "Input BAM/CRAM file(s).")
        self.add_infile("in", "Input BED file. If unset, reads from STDIN.", optional=True)
        self.add_outfile("out", "Output TSV file. If unset, writes to STDOUT.", optional=True)
        self.add_infile("ref", "Reference genome for CRAM support (mandatory if CRAM is used).", optional=True)
        self.add_int("min_mapq", "Minimum mapping quality.", optional=True, default=20)
        self.add_int("min_baseq", "Minimum base quality.", optional=True, default=25)
        self.add_flag("long_read", "Support long reads (> 1kb).")

    def main(self):
        bams = self.get_infile_list("bam")
        for bam in bams:
            cov.check_bam(bam)
        min_mapq = self.get_int("min_mapq")
        min_baseq = self.get_int("min_baseq")
        long_read = self.get_flag("long_read")

        t0 = time.perf_counter()
        f = BedFile.from_file(self.get("in"))
        for line in f.lines:
            if line.length() != 1:
                raise ToolError("BED file contains region with length > 1, which is not "
                                f"supported: {line.chr.str_normalized(True)}:{line.start}-"
                                f"{line.end}")
        chr_nums = np.array([l.chr.num for l in f.lines], dtype=np.int64)
        positions = np.array([l.end for l in f.lines], dtype=np.int64)
        self.seconds = {"setup": time.perf_counter() - t0}

        t0, stats = time.perf_counter(), {}
        per_bam = [pm.pileup_at_positions(bam, chr_nums, positions, min_mapq=min_mapq,
                                          include_not_properly_paired=long_read,
                                          min_baseq=min_baseq, stats=stats) for bam in bams]
        self.seconds["pileup"] = time.perf_counter() - t0
        self.seconds.update(stats)

        t0 = time.perf_counter()
        rows = ["#chr\tstart\tend\tsample\tA\tC\tG\tT\ttotal"]
        for i, line in enumerate(f.lines):
            for j, bam in enumerate(bams):
                counts = per_bam[j].counts[i]
                sample = os.path.basename(bam).split(".")[0]
                # reference writes BedLine::toString(false) = 'chr:start-end'
                # as ONE field (header has separate chr/start/end — quirk kept)
                rows.append(f"{line.chr.str}:{line.start}-{line.end}\t{sample}"
                            f"\t{counts[0]}\t{counts[1]}\t{counts[2]}\t{counts[3]}"
                            f"\t{int(counts.sum())}")
        text = "".join(r + "\n" for r in rows)
        out = self.get("out")
        if out:
            with open(out, "w") as fh:
                fh.write(text)
        else:
            sys.stdout.write(text)
        self.seconds["output"] = time.perf_counter() - t0


TOOLS = {
    "BedAnnotateFreq": BedAnnotateFreqTool,
    "BedCoverage": BedCoverageTool,
    "BedLowCoverage": BedLowCoverageTool,
    "BedHighCoverage": BedHighCoverageTool,
}
