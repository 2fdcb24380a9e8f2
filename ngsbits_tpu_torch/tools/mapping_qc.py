"""MappingQC — QC metrics based on mapped NGS reads.

Counterpart of ``ngsbits_tpu/tools/mapping_qc.py``, with the same flags. The
ROI depth (C1, C2) and the contamination pileup (B1's record form: the
records' CIGARs walked to the SNP loci) run on the port's device, as does
``-read_qc`` (unpack, K1, tails). ``seconds`` holds
the host seconds of each stage after ``execute``, under the names ``-debug``
prints (raw read QC, main QC, contamination check), and in ROI mode those of
the main QC's BAM pass (``scan``) and depth finalize (``finalize``).
There is no settings.ini: ``-ref`` is required. CRAM input is not ported.
With ``NGSBITS_MESH`` set, each rank of a process group runs ``-read_qc``'s
stream and the ROI depth on its reads (``parallel/mesh.py``). Every rank then
runs the contamination check and ``-somatic_custom_bed`` on the whole BAM, as
every rank runs ``MappingScan``'s host counters: a rank that skipped them would
wait for rank 0 at the closing collective as long as they take, past the
group's timeout on a large BAM. Rank 0 alone writes the outputs.

Behavioral reference: ngs-bits src/MappingQC/main.cpp:53-188 (roi/wgs/rna
mode dispatch + contamination + somatic custom depth + optional read QC).
"""

from __future__ import annotations

import os
import sys

from ..core import resources
from ..core.intervals import BedFile
from ..core.qcml import QCCollection
from ..parallel import mesh
from ..qc import mapping_stats
from ..qc.read_stats import ReadStatistics, update_from_bam
from ..utils.trace import StageTimer
from .toolbase import ToolBase, ToolError


class MappingQCTool(ToolBase):
    name = "MappingQC"
    description = "Calculates QC metrics based on mapped NGS reads."
    mesh_route = True

    def setup(self):
        self.add_infile("in", "Input BAM file.")
        self.add_outfile("out", "Output qcML file. If unset, writes to STDOUT.", optional=True)
        self.add_infile("roi", "Input target region BED file (for panel, WES, etc.).", optional=True)
        self.add_flag("wgs", "WGS mode without target region. Genome information is taken from the BAM/CRAM file.")
        self.add_flag("rna", "RNA mode without target region. Genome information is taken from the BAM/CRAM file.")
        self.add_flag("txt", "Writes TXT format instead of qcML.")
        self.add_int("min_mapq", "Minmum mapping quality to consider a read mapped.", optional=True, default=1)
        self.add_flag("no_cont", "Disables sample contamination calculation, e.g. for tumor or non-human samples.")
        self.add_flag("debug", "Enables verbose debug outout.")
        self.add_enum("build", "Genome build used to generate the input (needed for WGS and contamination only).",
                      optional=True, valid=["hg19", "hg38", "non_human"], default="hg38")
        self.add_infile("ref", "Reference genome FASTA file.", optional=True)
        self.add_flag("cfdna", "Add additional QC parameters for cfDNA samples. Only supported mit '-roi'.")
        self.add_infile("somatic_custom_bed", "Somatic custom region of interest (subpanel of actual roi). If specified, additional depth metrics will be calculated.", optional=True)
        self.add_outfile("read_qc", "If set, a read QC file in qcML format is created (just like ReadQC/SeqPurge).", optional=True)
        self.add_flag("single_end", "Enable single-end mode. Use for ONT, PacBio and Roche. Illumina single-end data is auto-detected based on paired reads.")

    def main(self):
        roi_file = self.get("roi")
        wgs = self.get_flag("wgs")
        rna = self.get_flag("rna")
        in_file = self.get("in")
        ref_file = self.get_ref()
        if not ref_file:
            raise ToolError("Reference genome FASTA unset in both command-line and settings.ini file!")
        cfdna = self.get_flag("cfdna")
        min_mapq = self.get_int("min_mapq")
        single_end = self.get_flag("single_end")

        n_modes = (1 if roi_file else 0) + wgs + rna
        if n_modes != 1:
            raise ToolError("You have to use exactly one of the parameters 'roi', 'wgs', or 'rna' !")
        if cfdna and not roi_file:
            raise ToolError("The flag 'cfdna' can only be used with parameter 'roi'!")

        timer = StageTimer(enabled=self.get_flag("debug"))
        self.seconds = timer.seconds

        read_qc = self.get("read_qc").strip() if self.get("read_qc") else ""
        if read_qc:
            with timer.stage("Performing raw read QC"):
                stats = ReadStatistics(single_end=single_end)
                update_from_bam(stats, in_file, single_end)
                result = stats.get_result()
                if mesh.writes():
                    result.store_to_qcml(read_qc, [in_file], "")

        parameters = []
        build = self.get_enum("build")
        with timer.stage("Performing main QC"):
            if wgs:
                if build == "non_human":
                    metrics = mapping_stats.mapping_no_roi(in_file, ref_file, min_mapq)
                else:
                    qc_bed = resources.omim_qc_bed(build)
                    metrics = mapping_stats.mapping_wgs(in_file, qc_bed, min_mapq, ref_file)
                parameters.append("-wgs")
            elif rna:
                metrics = mapping_stats.mapping_no_roi(in_file, ref_file, min_mapq)
                parameters.append("-rna")
            else:
                roi = BedFile.from_file(roi_file)
                roi.merge()
                metrics = mapping_stats.mapping_roi(roi, in_file, ref_file, min_mapq, cfdna,
                                                    seconds=self.seconds)
                parameters += ["-roi", os.path.basename(roi_file)]
                if cfdna:
                    parameters.append("-cfdna")

        metrics_cont = QCCollection()
        if not self.get_flag("no_cont") and build != "non_human":
            with timer.stage("Performing contamination check"):
                metrics_cont = mapping_stats.contamination(
                    build, in_file, roi_file or "", 20, 50, single_end)

        somatic_bed = self.get("somatic_custom_bed")
        if somatic_bed:
            custom = BedFile.from_file(somatic_bed)
            custom.merge()
            metrics.insert(mapping_stats.somatic_custom_depth(custom, in_file, ref_file, min_mapq))
            parameters.append("-somatic_custom_bed " + somatic_bed)

        if single_end:
            parameters.append("-single_end")

        if not mesh.writes():
            return
        out = self.get("out")
        if self.get_flag("txt"):
            lines = metrics.to_string_list()
            lines.append("")
            lines.extend(metrics_cont.to_string_list())
            text = "".join(l + "\n" for l in lines)
            if out:
                with open(out, "w") as fh:
                    fh.write(text)
            else:
                sys.stdout.write(text)
        else:
            metrics.insert(metrics_cont)
            metrics.store_to_qcml(out if out else None, [in_file], " ".join(parameters))


TOOLS = {"MappingQC": MappingQCTool}
