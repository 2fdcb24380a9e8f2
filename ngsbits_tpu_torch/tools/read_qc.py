"""ReadQC — QC metrics on unprocessed NGS reads, on a torch device.

Counterpart of ``ngsbits_tpu/tools/read_qc.py``: the same flags and outputs.
One consumer folds the prefetched batches into the device stream (the route
the JAX tool takes on a device, too); the device comes from
``NGSBITS_TORCH_DEVICE``. With ``NGSBITS_MESH`` set, each rank of a process
group streams its reads of each batch (``parallel/mesh.py``) and rank 0
writes every output; with ``-out1``/``-out2`` the ranks meet after each batch.
"""

from __future__ import annotations

import sys

from ..io.fastq import FastqReader, FastqWriter
from ..parallel import mesh
from ..qc.read_stats import FORWARD, REVERSE, ReadStatistics
from ..utils.backend import device
from ..utils.prefetch import prefetch
from .toolbase import ToolBase, ToolError


def _consume(stats: ReadStatistics, reader: FastqReader, direction: int,
             writer: FastqWriter | None, step: bool = False) -> int:
    """Fold every batch of ``reader`` into ``stats`` (decode runs ahead in
    a prefetch thread) and copy it to ``writer``; returns the read count.
    With ``step``, the ranks meet after every batch (``mesh.in_step``)."""
    for batch in prefetch(reader, depth=2):
        stats.update_batch(batch, direction)
        if writer is not None:
            writer.write_batch(batch)
        if step:
            mesh.in_step()
    return reader.reads_seen


class ReadQCTool(ToolBase):
    name = "ReadQC"
    description = "Calculates QC metrics on unprocessed NGS reads."
    changelog = [
        (2023, 4, 18, "Added support for LongRead"),
        (2021, 2, 3, "Added option to write out merged input FASTQs (out1/out2)."),
        (2016, 8, 19, "Added support for multiple input files."),
    ]
    mesh_route = True

    def setup(self):
        self.add_infile_list("in1", "Forward input gzipped FASTQ file(s).")
        self.add_infile_list("in2", "Reverse input gzipped FASTQ file(s) for paired-end mode (same number of cycles/reads as 'in1').", optional=True)
        self.add_outfile("out", "Output qcML file. If unset, writes to STDOUT.", optional=True)
        self.add_flag("txt", "Writes TXT format instead of qcML.")
        self.add_outfile("out1", "If set, writes merged forward FASTQs to this file (gzipped).", optional=True)
        self.add_outfile("out2", "If set, writes merged reverse FASTQs to this file (gzipped)", optional=True)
        self.add_int("compression_level", "Output FASTQ compression level from 1 (fastest) to 9 (best compression).", optional=True, default=1)
        self.add_flag("long_read", "Support long reads (> 1kb).")

    def execute(self, argv):
        # the qcML records the command line
        self._parameters = " ".join(argv)
        return super().execute(argv)

    def main(self):
        in1 = self.get_infile_list("in1")
        in2 = self.get_infile_list("in2")
        if in2 and len(in1) != len(in2):
            raise ToolError("Input file lists 'in1' and 'in2' differ in counts!")

        long_read = self.get_flag("long_read")
        compression_level = self.get_int("compression_level")
        writes = mesh.writes()
        # rank 0 alone copies the reads to -out1/-out2: under a group the
        # ranks meet after every batch, so that no rank waits for that copy
        # at the merge for the whole run's length
        step = mesh.active() and bool(self.get_outfile("out1") or self.get_outfile("out2"))
        out1 = self.get_outfile("out1") if writes else ""
        out2 = self.get_outfile("out2") if writes else ""
        w1 = FastqWriter(out1, compression_level) if out1 else None
        w2 = FastqWriter(out2, compression_level) if out2 else None

        # reference quirk kept from the JAX tool: -long_read is what turns on
        # the single-end extras (and the 8-bit quality packing)
        stats = ReadStatistics(single_end=long_read, device=device())

        infiles = []
        for i, f1 in enumerate(in1):
            n1 = _consume(stats, FastqReader(f1, keep_headers=w1 is not None,
                                             long_read=long_read), FORWARD, w1, step)
            infiles.append(f1)
            if i < len(in2):
                n2 = _consume(stats, FastqReader(in2[i], keep_headers=w2 is not None,
                                                 long_read=long_read), REVERSE, w2, step)
                if n1 != n2:
                    raise ToolError(f"Differing number of reads in file '{f1}' and '{in2[i]}'!")
                infiles.append(in2[i])

        metrics = stats.get_result()
        if not writes:
            return
        out = self.get_outfile("out")
        if self.get_flag("txt"):
            text = "".join(line + "\n" for line in metrics.to_string_list())
            if out:
                with open(out, "w") as fh:
                    fh.write(text)
            else:
                sys.stdout.write(text)
        else:
            metrics.store_to_qcml(out if out else None, infiles, self._parameters)

        if w1:
            w1.close()
        if w2:
            w2.close()


TOOLS = {"ReadQC": ReadQCTool}
