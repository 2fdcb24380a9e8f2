"""Raw-read QC accumulator (ReadQC engine) on a torch device.

Counterpart of ``ngsbits_tpu/qc/read_stats.py``. Behavioral reference:
ngs-bits ``StatisticsReads`` (cppNGS/StatisticsReads.cpp): exact metric
semantics including qcML accessions QC:2000005..QC:2000149 and the
single-end/long-read extras (N50 QC:2000131, read-length histogram
QC:2000132, median/mode Q scores QC:2000144-147).

Every batch goes to ``DeviceReadStream``, whose int64 carries stay on the
device until ``fold_into`` lands them in the host fields; the report assembly
(``get_result``) runs on the host in float64, as in the JAX package. Under a
process group (``parallel/mesh.py``) each rank streams its rows of each batch,
and ``fold_into`` merges the ranks' carries with one ``all_reduce``.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import torch

from ..core.histogram import Histogram
from ..core.plots import BarPlot, LinePlot
from ..core.qcml import QCCollection, QCValue
from ..io.fastq import FastqBatch
from ..ops.readqc import (CARRY_KEYS, QHIST_SIZE, carry_to_numpy, pack_batch,
                          stream_carry_grow, stream_carry_init, stream_step)
from ..parallel import mesh
from ..utils.backend import device as default_device

FORWARD = 0
REVERSE = 1


class ReadStatistics:
    def __init__(self, single_end: bool = False,
                 device: torch.device | None = None):
        self.single_end = single_end
        self.device = default_device() if device is None else torch.device(device)
        self._stream: DeviceReadStream | None = None
        self.c_forward = 0
        self.c_reverse = 0
        self.read_lengths: Counter = Counter()
        self.bases_sequenced = 0
        self.c_read_q20 = 0
        # grown on demand, indexed by cycle
        self.pileups = np.zeros((5, 0), dtype=np.int64)      # A,C,G,T,N x cycle
        self.qualsum1 = np.zeros(0, dtype=np.int64)           # forward, per cycle
        self.qualsum2 = np.zeros(0, dtype=np.int64)           # reverse, per cycle
        self.base_qualities = np.zeros(QHIST_SIZE, dtype=np.int64)
        self.read_qualities = np.zeros(100, dtype=np.int64)
        self.qscore_dist_r1 = Histogram(0, 60, 1)
        self.qscore_dist_r2 = Histogram(0, 60, 1)

    def _grow(self, cycles: int):
        if cycles > self.pileups.shape[1]:
            extra = cycles - self.pileups.shape[1]
            self.pileups = np.pad(self.pileups, ((0, 0), (0, extra)))
            self.qualsum1 = np.pad(self.qualsum1, (0, extra))
            self.qualsum2 = np.pad(self.qualsum2, (0, extra))

    @staticmethod
    def _bucket(batch: FastqBatch):
        """Pad [B, L] to shape buckets: L to a multiple of 64 (a power of two
        past 512), as ``pack_batch`` needs, and B to a power of two of at
        least 1024. Padding rows have length 0 and contribute nothing to any
        statistic."""
        B, L = batch.bases.shape
        if L <= 512:
            Lb = max(64, -(-L // 64) * 64)
        else:  # long reads: power-of-two buckets
            Lb = 1 << int(L - 1).bit_length()
        Bb = max(1024, 1 << (int(B - 1).bit_length())) if B else 1024
        bases = np.zeros((Bb, Lb), dtype=np.uint8)
        quals = np.zeros((Bb, Lb), dtype=np.uint8)
        bases[:B, :L] = batch.bases
        quals[:B, :L] = batch.quals
        lengths = np.zeros(Bb, dtype=np.int32)
        lengths[:B] = batch.lengths
        return bases, quals, lengths

    def _device_stream(self) -> "DeviceReadStream":
        if self._stream is None:
            # single_end is how ReadQC routes -long_read (quality range up
            # to Q93, beyond 6-bit packing)
            self._stream = DeviceReadStream(
                qual_bits=8 if self.single_end else 6, device=self.device)
        return self._stream

    def merge(self, other: "ReadStatistics"):
        """Fold another accumulator into this one (every statistic is
        additive)."""
        if other._stream is not None:
            # land the other accumulator's device carries in its host
            # fields first, then merge those
            other._stream.fold_into(other)
            other._stream = None
        self.c_forward += other.c_forward
        self.c_reverse += other.c_reverse
        self.read_lengths.update(other.read_lengths)
        self.bases_sequenced += other.bases_sequenced
        self.c_read_q20 += other.c_read_q20
        self._grow(other.pileups.shape[1])
        L = other.pileups.shape[1]
        self.pileups[:, :L] += other.pileups
        self.qualsum1[:L] += other.qualsum1
        self.qualsum2[:L] += other.qualsum2
        self.base_qualities += other.base_qualities
        self.read_qualities += other.read_qualities
        for mine, theirs in ((self.qscore_dist_r1, other.qscore_dist_r1),
                             (self.qscore_dist_r2, other.qscore_dist_r2)):
            mine._bins += theirs._bins
            mine._count += theirs._count

    def update_batch(self, batch: FastqBatch, direction: int):
        if len(batch) == 0:
            return
        self._device_stream().update(batch, direction)

    def get_result(self) -> QCCollection:
        if self._stream is not None:
            self._stream.fold_into(self)
            self._stream = None
        out = QCCollection()
        total_reads = self.c_forward + self.c_reverse
        c_base_n = int(self.pileups[4].sum())
        c_base_gc = int(self.pileups[1].sum() + self.pileups[2].sum())
        bases_total = int(self.pileups.sum())

        out.insert(QCValue.from_int(
            "read count", total_reads,
            "Total number of reads (forward and reverse reads of paired-end sequencing count as two reads).",
            "QC:2000005"))
        keys = sorted(self.read_lengths.keys())
        longest_read = keys[-1] if keys else 0
        is_longread = self.single_end and longest_read >= 10000
        if len(keys) < 4:
            lengths_str = ", ".join(str(k) for k in keys)
        else:
            lengths_str = f"{keys[0]}-{longest_read}"
        out.insert(QCValue.from_string(
            "read length", lengths_str,
            "Raw read length of a single read before trimming. Comma-separated list of lenghs or length range, if reads have different lengths.",
            "QC:2000006"))
        out.insert(QCValue.from_double(
            "bases sequenced (MB)", self.bases_sequenced / 1000000.0,
            "Bases sequenced in total (in megabases).", "QC:2000049"))
        out.insert(QCValue.from_double(
            "Q20 read percentage", 100.0 * self.c_read_q20 / total_reads,
            "The percentage of reads with a mean base quality score greater than Q20.",
            "QC:2000007"))
        c_base_q20 = int(self.base_qualities[20:].sum())
        c_base_q30 = int(self.base_qualities[30:].sum())
        out.insert(QCValue.from_double(
            "Q20 base percentage", 100.0 * c_base_q20 / bases_total,
            "The percentage of bases with a minimum quality score of Q20.", "QC:2000148"))
        out.insert(QCValue.from_double(
            "Q30 base percentage", 100.0 * c_base_q30 / bases_total,
            "The percentage of bases with a minimum quality score of Q30.", "QC:2000008"))
        out.insert(QCValue.from_double(
            "no base call percentage", 100.0 * c_base_n / bases_total,
            "The percentage of bases without base call (N).", "QC:2000009"))
        out.insert(QCValue.from_double(
            "gc content percentage", 100.0 * c_base_gc / (bases_total - c_base_n),
            "The percentage of bases that are called to be G or C.", "QC:2000010"))

        if self.single_end:
            bases = 0
            n50 = 0
            for k in sorted(self.read_lengths.keys(), reverse=True):
                bases += k * self.read_lengths[k]
                if bases > self.bases_sequenced // 2:
                    n50 = k
                    break
            out.insert(QCValue.from_int(
                "N50 read length (bp)", n50,
                "Minimum read length to reach 50% of sequenced bases.", "QC:2000131"))

        n95 = -1
        if is_longread:
            bases = 0
            for k in sorted(self.read_lengths.keys()):
                bases += k * self.read_lengths[k]
                if bases > 0.95 * self.bases_sequenced:
                    n95 = k
                    break
            if longest_read <= 100000:
                n95 = int(math.ceil(n95 / 1000.0) * 1000)
            else:
                n95 = int(math.ceil(n95 / 10000.0) * 10000)

        cycles = longest_read
        if is_longread:
            cycles = min(n95, cycles)

        # base distribution plot
        with np.errstate(divide="ignore", invalid="ignore"):
            p = self.pileups[:, :cycles].astype(np.float64)
            depth_no_n = p[:4].sum(axis=0)
            line = {c: 100.0 * p[i] / depth_no_n for i, c in enumerate("ACGT")}
            line["N"] = 100.0 * p[4] / (depth_no_n + p[4])
            line["GC"] = line["G"] + line["C"]
        line_x = np.arange(1, cycles + 1, dtype=np.float64)
        plot = LinePlot()
        plot.set_xlabel("cycle")
        plot.set_ylabel("base [%]")
        plot.set_yrange(0.0, 100.0)
        plot.set_xvalues(line_x)
        for c in ["A", "C", "G", "T", "N", "GC"]:
            plot.add_line(line[c], c)
        out.insert(QCValue.image_from_base64(
            "base distribution plot", plot.to_base64(),
            "Base distribution plot per cycle.", "QC:2000011"))

        # mean Q score per cycle plot
        depth_cycle = self.pileups.sum(axis=0)[:cycles].astype(np.float64)
        if self.c_reverse > 0:
            depth_cycle = np.floor_divide(depth_cycle.astype(np.int64), 2).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            q1 = self.qualsum1[:cycles] / depth_cycle
            q2 = self.qualsum2[:cycles] / depth_cycle
        plot2 = LinePlot()
        plot2.set_xlabel("cycle")
        plot2.set_ylabel("mean Q score")
        plot2.set_yrange(0.0, 41.5)
        plot2.set_xvalues(line_x)
        plot2.add_line(q1, "forward reads")
        if self.c_reverse > 0:
            plot2.add_line(q2, "reverse reads")
        out.insert(QCValue.image_from_base64(
            "Q score plot", plot2.to_base64(),
            "Mean Q score per cycle for forward/reverse reads.", "QC:2000012"))

        # read Q score distribution plot
        plot2b = LinePlot()
        plot2b.set_xlabel("read Q score")
        plot2b.set_ylabel("reads [%]")
        plot2b.set_yrange(0, 100)
        plot2b.set_xvalues(self.qscore_dist_r1.x_coords())
        plot2b.add_line(self.qscore_dist_r1.y_coords(True), "forward reads")
        if self.c_reverse > 0:
            plot2b.add_line(self.qscore_dist_r2.y_coords(True), "reverse reads")
        out.insert(QCValue.image_from_base64(
            "read Q score distribution", plot2b.to_base64(),
            "Distrubition of the mean forward/reverse Q score for each read.", "QC:2000138"))

        if self.single_end:
            first_key = keys[0] if keys else 0
            hist_min = max(0, first_key - 20)
            hist_max = (n95 if is_longread else longest_read) + 20
            read_length_hist = Histogram(hist_min, hist_max, (hist_max - hist_min) / 60)
            for k in sorted(self.read_lengths.keys()):
                read_length_hist.inc_array(
                    np.full(self.read_lengths[k], k, dtype=np.float64), ignore_bounds=True)

            plot3 = BarPlot()
            plot3.set_xlabel("read length (bp)")
            plot3.set_ylabel("reads [%]")
            plot3.set_yrange(0, read_length_hist.max_value(True) + 1)
            plot3.set_xrange(-2, read_length_hist.bin_count() + 2)
            bins = []
            for x in read_length_hist.x_coords():
                bins.append(str(int(x)) if int(x) % 10 == 0 else "")
            plot3.set_values(read_length_hist.y_coords(True), bins)
            out.insert(QCValue.image_from_base64(
                "Read length histogram", plot3.to_base64(),
                "Histogram of read lengths", "QC:2000132"))

            # median/mode base Q score (mode ignores the peak at 50)
            values = []
            labels = []
            max_count = 0
            mode_base_q = 0
            median_base_q = -1
            bases_checked = 0
            for i in range(61):
                labels.append(str(i))
                base_count = int(self.base_qualities[i])
                values.append(100.0 * base_count / self.bases_sequenced)
                if base_count >= max_count:
                    max_count = base_count
                    if i < 50:
                        mode_base_q = i
                bases_checked += base_count
                if median_base_q == -1 and bases_checked * 2 >= self.bases_sequenced:
                    median_base_q = i
            plot4 = BarPlot()
            plot4.set_xlabel("Q score")
            plot4.set_ylabel("bases [%]")
            plot4.set_yrange(0, 100)
            plot4.set_xrange(0, 60)
            plot4.set_values(values, labels)
            out.insert(QCValue.image_from_base64(
                "base Q score histogram", plot4.to_base64(),
                "Histogram of base Q scores.", "QC:2000143"))
            out.insert(QCValue.from_int(
                "median base Q score", median_base_q,
                "Median Q score of all bases of the sample.", "QC:2000144"))
            out.insert(QCValue.from_int(
                "mode base Q score", mode_base_q,
                "Most frequent Q score of all bases of the sample.", "QC:2000145"))

            # median/mode read Q score
            max_count = 0
            mode_read_q = 0
            median_read_q = -1
            reads_checked = 0
            for i in range(len(self.read_qualities)):
                read_count = int(self.read_qualities[i])
                if read_count >= max_count:
                    max_count = read_count
                    mode_read_q = i
                reads_checked += read_count
                if median_read_q == -1 and reads_checked * 2 >= self.c_forward:
                    median_read_q = i
            out.insert(QCValue.from_int(
                "median read Q score", median_read_q,
                "Median Q score of all reads of the sample.", "QC:2000146"))
            out.insert(QCValue.from_int(
                "mode read Q score", mode_read_q,
                "Most frequent Q score of all reads of the sample.", "QC:2000147"))

        return out


def bam_batch_ascii(batch) -> tuple[np.ndarray, np.ndarray]:
    """A BAM batch's flat bases as ASCII and its qualities + 33 (wrapping in
    uint8, as the JAX package's per-record ``qual + 33`` does)."""
    from ..io.bam import SEQ_NIBBLE_ASCII
    return SEQ_NIBBLE_ASCII[batch.seq], batch.qual + np.uint8(33)


def bam_batch_to_fastq_batch(batch, sel: np.ndarray, ascii=None) -> FastqBatch:
    """The selected BAM records as a padded FastqBatch for the raw-read QC
    engine (StatisticsReads::update(BamAlignment) semantics: bases as
    stored, raw qualities + 33). The host library copies each selected
    record's row out of the batch's flat ASCII arrays (``bam_batch_ascii``,
    made once a batch) into ``[n, Lmax]`` rows, zero-padded; the JAX package
    builds the same rows in a Python loop over the records."""
    from ..io.native import get_lib
    flat_b, flat_q = bam_batch_ascii(batch) if ascii is None else ascii
    idx = np.flatnonzero(sel)
    offs = np.ascontiguousarray(batch.seq_off[idx], dtype=np.int64)
    lengths = np.ascontiguousarray(batch.l_seq[idx], dtype=np.int32)
    n = len(idx)
    lmax = int(lengths.max()) if n else 0
    bases = np.empty((n, lmax), dtype=np.uint8)
    quals = np.empty((n, lmax), dtype=np.uint8)
    bad = np.zeros(3, dtype=np.int64)
    lib = get_lib()
    for flat, out in ((flat_b, bases), (flat_q, quals)):
        lib.ngs_pad_gather(flat.ctypes.data, offs, lengths, n, lmax, out, 0, 0, bad)
    return FastqBatch(bases=bases, quals=quals, lengths=lengths)


def update_from_bam(stats: ReadStatistics, bam_file: str, single_end: bool):
    """Stream a BAM through the raw-read QC engine
    (StatisticsReads::update(BamAlignment), StatisticsReads.cpp:83-158):
    primary records, split by mate unless ``single_end``."""
    from ..io.bam import BamReader, FLAG_READ1, FLAG_SECONDARY, FLAG_SUPPLEMENTARY
    reader = BamReader(bam_file)
    for batch in reader:
        primary = (batch.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) == 0
        ascii = bam_batch_ascii(batch)
        if single_end:
            stats.update_batch(bam_batch_to_fastq_batch(batch, primary, ascii), FORWARD)
        else:
            fwd = primary & ((batch.flag & FLAG_READ1) != 0)
            rev = primary & ~((batch.flag & FLAG_READ1) != 0)
            if fwd.any():
                stats.update_batch(bam_batch_to_fastq_batch(batch, fwd, ascii), FORWARD)
            if rev.any():
                stats.update_batch(bam_batch_to_fastq_batch(batch, rev, ascii), REVERSE)
    reader.close()


class DeviceReadStream:
    """Device-resident ReadQC accumulation (StatisticsReads.cpp:26-81).

    Per batch, the packed reads (``pack_batch``: 2-bit codes, 1-bit N mask,
    6- or 8-bit quals) are copied to the device and folded into int64 carries
    there by ``stream_step``; nothing comes back until ``fold_into``. The
    upload is a blocking copy from pageable memory, so it waits for the
    previous batch's kernels. The carries cannot overflow in practice, so
    the JAX class's periodic spill to the host is gone."""

    def __init__(self, qual_bits: int = 6, device: torch.device | None = None):
        self.qual_bits = qual_bits  # 8 for the long-read quality range
        self.device = default_device() if device is None else torch.device(device)
        self.carry: dict | None = None
        self.spill: dict | None = None
        self.scratch: dict = {}

    def update(self, batch: FastqBatch, direction: int):
        lo, hi = mesh.rows(len(batch))
        if hi - lo < len(batch):  # this rank's reads of the batch
            if lo == hi:
                return
            batch = FastqBatch(bases=batch.bases[lo:hi], quals=batch.quals[lo:hi],
                               lengths=batch.lengths[lo:hi])
        bases, quals, lengths = ReadStatistics._bucket(batch)
        Lb = bases.shape[1]
        pb, nm, pq = pack_batch(bases, quals, self.qual_bits)
        if self.carry is None:
            self.carry = stream_carry_init(Lb, self.device)
        else:
            self.carry = stream_carry_grow(self.carry, Lb)
        dev = self.device
        stream_step(self.carry, torch.from_numpy(pb).to(dev),
                    torch.from_numpy(nm).to(dev), torch.from_numpy(pq).to(dev),
                    torch.from_numpy(lengths).to(dev), len(batch),
                    0 if direction == FORWARD else 1, self.qual_bits,
                    self.scratch)

    def _merge_ranks(self):
        """Under a process group, every rank's carries summed into each
        rank's: the ranks agree on the cycle count (``all_reduce`` MAX), grow
        their carries to it (a rank that took no read starts from zeros), and
        sum all of them in one ``all_reduce``."""
        width = torch.tensor([0 if self.carry is None else self.carry["counts5"].shape[1]],
                             dtype=torch.int64, device=self.device)
        L = int(mesh.all_reduce_(width, op=mesh.dist.ReduceOp.MAX)[0])
        if L == 0:
            return
        carry = (stream_carry_init(L, self.device) if self.carry is None
                 else stream_carry_grow(self.carry, L))
        flat = mesh.all_reduce_(torch.cat([carry[k].reshape(-1) for k in CARRY_KEYS]))
        sizes = [carry[k].numel() for k in CARRY_KEYS]
        self.carry = {k: part.view(carry[k].shape)
                      for k, part in zip(CARRY_KEYS, flat.split(sizes))}

    def _spill(self):
        # land the carries on the host as the int64 spill that fold_into
        # folds, and start afresh
        if mesh.active():
            self._merge_ranks()
        if self.carry is None:
            return
        self.spill = carry_to_numpy(self.carry)
        self.carry = None

    def fold_into(self, stats: "ReadStatistics"):
        self._spill()
        s = self.spill
        if s is None:
            return
        # trim trailing cycles no read reached (bucket padding)
        lens_present = np.flatnonzero(s["len_hist"])
        true_l = int(lens_present[-1]) + 1 if len(lens_present) else 0
        stats._grow(true_l)
        stats.pileups[:, :true_l] += s["counts5"][:, :true_l]
        stats.qualsum1[:true_l] += s["qsum1"][:true_l]
        stats.qualsum2[:true_l] += s["qsum2"][:true_l]
        stats.base_qualities += s["qhist"]
        stats.read_qualities += s["read_q_hist"]
        stats.c_read_q20 += int(s["q20"])
        stats.qscore_dist_r1.add_counts(s["qdist1"])
        stats.qscore_dist_r2.add_counts(s["qdist2"])
        for i in range(len(s["len_hist"])):  # bin i = reads of length i
            if s["len_hist"][i]:
                stats.read_lengths[i] += int(s["len_hist"][i])
        stats.c_forward += int(s["n_fwd"])
        stats.c_reverse += int(s["n_rev"])
        stats.bases_sequenced += int(s["bases"])
        self.spill = None
