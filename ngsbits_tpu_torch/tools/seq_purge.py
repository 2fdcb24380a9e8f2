"""SeqPurge — adapter trimming for paired-end data, on a torch device.

Counterpart of ``ngsbits_tpu/tools/seq_purge.py``: the same flags and
outputs. Behavioral reference: ngs-bits src/SeqPurge/main.cpp:17-104 and
ThreadCoordinator.cpp (read -> analyze -> write). Here the two mates decode
on two prefetch threads, one consumer runs the engine (scans and per-pair
decisions on the device that ``NGSBITS_TORCH_DEVICE`` names), and each output
stream compresses on its own writer thread. ``-threads`` is accepted and
changes no output: there is one consumer, which feeds the device. With
``NGSBITS_MESH`` set, each rank of a process group runs the insert scan on its
pairs and the ``-qc`` stream on its reads (``parallel/mesh.py``), the rest of
each batch whole; rank 0 writes every output.
"""

from __future__ import annotations

import sys

from ..io.fastq import FastqReader, FastqWriter
from ..parallel import mesh
from ..qc.read_stats import ReadStatistics
from ..qc.seqpurge import SeqPurgeEngine, SeqPurgeParams
from ..utils.backend import device
from ..utils.prefetch import prefetch_paired
from ..utils.trace import ProgressReporter
from .toolbase import ToolBase, ToolError


class SeqPurgeTool(ToolBase):
    name = "SeqPurge"
    description = "Removes adapter sequences from paired-end sequencing data."
    mesh_route = True

    def setup(self):
        self.add_infile_list("in1", "Forward input gzipped FASTQ file(s).")
        self.add_infile_list("in2", "Reverse input gzipped FASTQ file(s).")
        self.add_outfile("out1", "Forward output gzipped FASTQ file.")
        self.add_outfile("out2", "Reverse output gzipped FASTQ file.")
        self.add_string("a1", "Forward adapter sequence (at least 15 bases).", optional=True, default="AGATCGGAAGAGCACACGTCTGAACTCCAGTCA")
        self.add_string("a2", "Reverse adapter sequence (at least 15 bases).", optional=True, default="AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT")
        self.add_float("match_perc", "Minimum percentage of matching bases for sequence/adapter matches.", optional=True, default=80.0)
        self.add_float("mep", "Maximum error probability of insert and adapter matches.", optional=True, default=0.000001)
        self.add_int("qcut", "Quality trimming cutoff for trimming from the end of reads using a sliding window approach. Set to 0 to disable.", optional=True, default=15)
        self.add_int("qwin", "Quality trimming window size.", optional=True, default=5)
        self.add_int("qoff", "Quality trimming FASTQ score offset.", optional=True, default=33)
        self.add_int("ncut", "Number of subsequent Ns to trimmed using a sliding window approach from the front of reads. Set to 0 to disable.", optional=True, default=7)
        self.add_int("min_len", "Minimum read length after adapter trimming. Shorter reads are discarded.", optional=True, default=30)
        self.add_int("threads", "The number of threads used for trimming (up to three additional threads are used for reading and writing).", optional=True, default=1)
        self.add_outfile("out3", "Name prefix of singleton read output files (if only one read of a pair is discarded).", optional=True)
        self.add_outfile("summary", "Write summary/progress to this file instead of STDOUT.", optional=True)
        self.add_outfile("qc", "If set, a read QC file in qcML format is created (just like ReadQC).", optional=True)
        self.add_int("block_size", "Number of FASTQ entries processed in one block.", optional=True, default=10000)
        self.add_int("block_prefetch", "Number of blocks that may be pre-fetched into memory.", optional=True, default=32)
        self.add_flag("ec", "Enable error-correction of adapter-trimmed reads (only those with insert match).")
        self.add_flag("debug", "Enables debug output (use only with one thread).")
        self.add_int("progress", "Enables progress output at the given interval in milliseconds (disabled by default).", optional=True, default=-1)
        self.add_int("compression_level", "Output FASTQ compression level from 1 (fastest) to 9 (best compression).", optional=True, default=1)

    def main(self):
        in1 = self.get_infile_list("in1")
        in2 = self.get_infile_list("in2")
        if len(in1) != len(in2):
            raise ToolError("Input file lists 'in1' and 'in2' differ in counts!")
        a1 = self.get("a1").strip().encode()
        a2 = self.get("a2").strip().encode()
        if len(a1) < 15:
            raise ToolError(f"Forward adapter {a1.decode()} too short!")
        if len(a2) < 15:
            raise ToolError(f"Reverse adapter {a2.decode()} too short!")

        params = SeqPurgeParams(
            a1=a1, a2=a2,
            match_perc=self.get_float("match_perc"),
            mep=self.get_float("mep"),
            qcut=self.get_int("qcut"), qwin=self.get_int("qwin"),
            qoff=self.get_int("qoff"), ncut=self.get_int("ncut"),
            min_len=self.get_int("min_len"), ec=self.get_flag("ec"))

        dev = device()
        qc_file = self.get("qc")
        qc = ReadStatistics(single_end=False, device=dev) if qc_file else None
        self.engine = engine = SeqPurgeEngine(params, qc=qc, device=dev)

        level = self.get_int("compression_level")
        writes = mesh.writes()
        w1 = FastqWriter(self.get("out1"), level) if writes else None
        w2 = FastqWriter(self.get("out2"), level) if writes else None
        out3 = self.get("out3")
        w3 = FastqWriter(out3 + "_R1.fastq.gz", level) if out3 and writes else None
        w4 = FastqWriter(out3 + "_R2.fastq.gz", level) if out3 and writes else None

        block = self.get_int("block_size")
        min_len = params.min_len
        # -progress: periodic throughput status lines into the summary
        # stream, like the reference (ThreadCoordinator.cpp:56-81)
        summary_path = self.get("summary") if writes else ""
        summary_stream = open(summary_path, "w") if summary_path else sys.stdout
        progress = ProgressReporter(self.get_int("progress") if writes else -1,
                                    stream=summary_stream)
        # -block_prefetch bounds the decoded blocks held in memory
        # (reference: ring of block_prefetch AnalysisJob blocks); the unit
        # here is one block_size batch per queue slot and stream
        depth = min(64, max(1, self.get_int("block_prefetch") // 2))

        processed_reads = 0
        for f1, f2 in zip(in1, in2):
            r1 = FastqReader(f1, batch_reads=block, keep_headers=True,
                             flat_headers=True)
            r2 = FastqReader(f2, batch_reads=block, keep_headers=True,
                             flat_headers=True)
            for b1, b2 in prefetch_paired(r1, r2, depth=depth):
                if b1 is None or b2 is None or len(b1) != len(b2):
                    raise ToolError(f"Differing number of reads in file '{f1}' and '{f2}'!")
                new_len1, new_len2 = engine.process_batch(b1, b2)
                processed_reads += 2 * len(b1)
                keep_pair = (new_len1 >= min_len) & (new_len2 >= min_len)
                if writes:
                    w1.write_batch(b1, keep_pair, new_len1)
                    w2.write_batch(b2, keep_pair, new_len2)
                if out3:
                    only1 = ~keep_pair & (new_len1 >= min_len)
                    only2 = ~keep_pair & (new_len2 >= min_len)
                    if writes:
                        w3.write_batch(b1, only1, new_len1)
                        w4.write_batch(b2, only2, new_len2)
                    removed = (int(only1.sum()) + int(only2.sum())
                               + 2 * int((~keep_pair & ~only1 & ~only2).sum()))
                else:
                    removed = 2 * int((~keep_pair).sum())
                engine.stats.reads_removed += removed
                progress.update(processed_reads=processed_reads)

        # every rank folds the -qc stream (a collective under a process group)
        qc_result = qc.get_result() if qc_file else None
        if not writes:
            return
        w1.close()
        w2.close()
        if w3 is not None:
            w3.close()
            w4.close()

        engine.write_summary(summary_stream, a1, a2)
        if params.ec:
            engine.write_ec_summary(summary_stream)
        if summary_path:
            summary_stream.close()

        if qc_file:
            # the reference's SeqPurge qcML carries no 'source file' entries
            qc_result.store_to_qcml(qc_file, [], "")


TOOLS = {"SeqPurge": SeqPurgeTool}
