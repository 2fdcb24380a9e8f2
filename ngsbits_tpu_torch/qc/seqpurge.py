"""SeqPurge trimming engine: count scans and per-pair decisions on a torch
device, the statistics folded on the host.

Counterpart of ``ngsbits_tpu/qc/seqpurge.py``. Behavioral reference: ngs-bits
SeqPurge (AnalysisWorker.cpp:79-457, OutputWorker.cpp:19-106,
Auxilary.h:100-280, FastqFileStream.cpp:52-115 for trimQuality/trimN).

Per batch, the host copies the bases and quals of both mates, padded to one
width L, and their lengths into one pinned buffer, and one copy takes them to
the device. There the reverse complement of read 2 is gathered through a
complement table, the three scans fill ``[B, L]`` counts (the insert match
two int16, the adapter evidence at each candidate insert and the adapter
prefix on each mate eight one-byte), and one launch of ``seqpurge_decide``
turns them into each pair's insert offset and new lengths, corrects the
reads with -ec, and adds the batch's statistics into int64 accumulators.
Every p-value comparison is made against the exact binomial-tail table
(core/basicstats.py) in float64, as the host makes it, or against integer
thresholds built from those comparisons, so decisions are bit-identical to
the JAX package's.
One copy brings back the per-pair results and the accumulators (with -ec also
the corrected reads); no count array leaves the device. Under a process group
(``parallel/mesh.py``) K2 runs on each rank's pairs and its counts are
gathered into the whole batch's on every rank (``insert_scan_rows``); the
rest of the batch stays whole on every rank, as on the JAX package's mesh
route, and the ``-qc`` stream takes each rank's reads. There is no host-only
route: everything runs on the device the engine was given (on the CPU the
kernels' plain versions).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, fields

import numpy as np
import torch

from ..core.basicstats import match_probability_table
from ..io import native
from ..io.fastq import FastqBatch
from ..ops.pallas_kernels import INSERT_COUNT
from ..ops.seqpurge import (ACC_SIZE, ADAPTER_COUNT, COUNTERS, MAXLEN, SCAN_ROWS,
                            acc_fields, adapter_evidence_into, adapter_scan_into,
                            complement_table, decide_thresholds, seqpurge_decide_into)
from ..parallel import mesh
from ..utils.backend import device as default_device
from .read_stats import FORWARD, REVERSE, ReadStatistics

@dataclass
class SeqPurgeParams:
    a1: bytes = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
    a2: bytes = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
    match_perc: float = 80.0
    mep: float = 0.000001
    qcut: int = 15
    qwin: int = 5
    qoff: int = 33
    ncut: int = 7
    min_len: int = 30
    ec: bool = False
    adapter_overlap: int = 10

    @property
    def a_size(self) -> int:
        return min(20, len(self.a1), len(self.a2))


@dataclass
class SeqPurgeStats:
    read_num: int = 0
    bases_remaining: np.ndarray = field(default_factory=lambda: np.zeros(MAXLEN, dtype=np.int64))
    acons1: np.ndarray = field(default_factory=lambda: np.zeros((40, 5), dtype=np.int64))
    acons2: np.ndarray = field(default_factory=lambda: np.zeros((40, 5), dtype=np.int64))
    reads_trimmed_insert: float = 0.0
    reads_trimmed_adapter: float = 0.0
    reads_trimmed_q: float = 0.0
    reads_trimmed_n: float = 0.0
    reads_removed: float = 0.0
    bases_perc_trim_sum: float = 0.0
    # error correction stats
    mismatch_r1: np.ndarray = field(default_factory=lambda: np.zeros(MAXLEN, dtype=np.int64))
    mismatch_r2: np.ndarray = field(default_factory=lambda: np.zeros(MAXLEN, dtype=np.int64))
    errors_per_read: np.ndarray = field(default_factory=lambda: np.zeros(MAXLEN, dtype=np.int64))


_ARRAY_FIELDS = ("bases_remaining", "acons1", "acons2", "mismatch_r1",
                 "mismatch_r2", "errors_per_read")


def stats_to_dict(stats) -> dict:
    """Every field of a ``SeqPurgeStats`` (this one or the JAX package's, which
    has the same fields) as plain values: int64 arrays copied, floats and the
    read count as they are."""
    return {f.name: (np.array(getattr(stats, f.name), dtype=np.int64)
                     if f.name in _ARRAY_FIELDS else getattr(stats, f.name))
            for f in fields(SeqPurgeStats)}


def stats_from_dict(d: dict) -> SeqPurgeStats:
    """A ``SeqPurgeStats`` from ``stats_to_dict``'s output, e.g. to start
    the port's and the JAX package's engine from the same non-zero stats."""
    names = {f.name for f in fields(SeqPurgeStats)}
    if set(d) != names:
        raise KeyError(f"stats fields differ: {sorted(set(d) ^ names)}")
    return SeqPurgeStats(**{k: (np.array(v, dtype=np.int64) if k in _ARRAY_FIELDS
                                else v) for k, v in d.items()})


class SeqPurgeEngine:
    def __init__(self, params: SeqPurgeParams, qc: ReadStatistics | None = None,
                 device: torch.device | None = None):
        self.p = params
        self.stats = SeqPurgeStats()
        self.qc = qc
        self.device = default_device() if device is None else torch.device(device)
        self.table = torch.from_numpy(match_probability_table(0.25, MAXLEN)).to(self.device)
        self.need = decide_thresholds(self.table, params.match_perc, params.mep)
        self._complement = complement_table(self.device)
        self._decide = dict(match_perc=params.match_perc, mep=params.mep,
                            qcut=params.qcut, qwin=params.qwin, qoff=params.qoff,
                            ncut=params.ncut, ec=params.ec)
        # one batch's buffer on the device and its pinned host twin (on the
        # CPU the same tensor), grown as batches need
        self._work = self._host = None
        # host seconds per stage (the scans: device seconds on a card)
        self.seconds = dict.fromkeys(("qc", "prepare", "scans", "fetch",
                                      "decisions"), 0.0)

    def _buffers(self, B: int, L: int):
        """Views of one batch in the device buffer and in its host twin, at
        byte offsets: accumulators (int64) | results [3, B] (int32) | bases
        and quals [4, B, L] (uint8: read 1, read 2, their quals) | lengths
        [2, B] (int32). The upload covers the last two parts, the fetch the
        first two (and the reads with -ec). Bytes past a read's length are
        whatever the buffer last held; nothing reads them."""
        parts = (("acc", torch.int64, (ACC_SIZE,)), ("out", torch.int32, (3, B)),
                 ("reads", torch.uint8, (4, B, L)), ("lens", torch.int32, (2, B)))
        offsets, size = {}, 0
        for name, dtype, shape in parts:
            offsets[name] = size
            size += dtype.itemsize * math.prod(shape)
        offsets["end"] = size
        if self._work is None or self._work.numel() < size:
            self._work = torch.empty(size, dtype=torch.uint8, device=self.device)
            self._host = (torch.empty(size, dtype=torch.uint8, pin_memory=True)
                          if self.device.type == "cuda" else self._work)
        views = [{name: buf[offsets[name]:offsets[name] + dtype.itemsize
                            * math.prod(shape)].view(dtype).view(shape)
                  for name, dtype, shape in parts} for buf in (self._work, self._host)]
        return views[0], views[1], offsets

    def process_batch(self, b1: FastqBatch, b2: FastqBatch):
        """Trim one batch of read pairs. Returns (len1, len2), the new
        lengths; with -ec the bases/quals of b1/b2 are corrected in place."""
        p = self.p
        B = len(b1)
        if len(b2) != B:
            raise ValueError(f"batches of {B} and {len(b2)} reads")

        # raw-read QC (before trimming)
        t0 = time.perf_counter()
        if self.qc is not None:
            self.qc.update_batch(b1, FORWARD)
            self.qc.update_batch(b2, REVERSE)
        t1 = time.perf_counter()
        self.seconds["qc"] += t1 - t0

        # header check
        h1 = b1.headers
        h2 = b2.headers
        if b1.has_flat_headers() and b2.has_flat_headers():
            bad = native.get_lib().ngs_headers_match(
                np.ascontiguousarray(b1.h1_flat), b1.h1_starts,
                np.ascontiguousarray(b1.h1_lens, dtype=np.int32),
                np.ascontiguousarray(b2.h1_flat), b2.h1_starts,
                np.ascontiguousarray(b2.h1_lens, dtype=np.int32), B)
            if bad >= 0:
                t1 = b1.header_bytes(int(bad)).split(b" ")[0]
                t2 = b2.header_bytes(int(bad)).split(b" ")[0]
                if t1.endswith(b"/1") and t2.endswith(b"/2"):
                    t1 = t1[:-2]
                    t2 = t2[:-2]
                raise ValueError(
                    f"Headers of reads do not match:\n{t1.decode()}\n{t2.decode()}")
        elif h1 is not None and h2 is not None:
            for a, b in zip(h1, h2):
                t1 = a.split(b" ")[0]
                t2 = b.split(b" ")[0]
                if t1.endswith(b"/1") and t2.endswith(b"/2"):
                    t1 = t1[:-2]
                    t2 = t2[:-2]
                if t1 != t2:
                    raise ValueError(
                        f"Headers of reads do not match:\n{t1.decode()}\n{t2.decode()}")

        len1 = b1.lengths.astype(np.int32)
        len2 = b2.lengths.astype(np.int32)
        if int(len1.max(initial=0)) >= MAXLEN or int(len2.max(initial=0)) >= MAXLEN:
            raise ValueError(f"Read length unsupported! A maximum read length of {MAXLEN} is supported!")
        L = max(b1.bases.shape[1], b2.bases.shape[1])

        # ---- prepare: one upload of both mates' reads and lengths ----
        t1 = time.perf_counter()
        dev, host, offsets = self._buffers(B, L)
        reads = host["reads"].numpy()
        for row, a in enumerate((b1.bases, b2.bases, b1.quals, b2.quals)):
            reads[row, :, :a.shape[1]] = a
        lens = host["lens"].numpy()
        lens[0] = len1
        lens[1] = len2
        on_card = self.device.type == "cuda"
        if on_card:
            up = slice(offsets["reads"], offsets["end"])
            self._work[up].copy_(self._host[up], non_blocking=True)
        seq1, read2 = dev["reads"][:2]
        d_len1, d_len2 = dev["lens"]
        # reverse complement of read 2 through the complement table, 0 past len2
        idx = d_len2[:, None] - 1 - torch.arange(L, dtype=torch.int32, device=self.device)
        seq2rc = torch.where(idx >= 0, self._complement[
            torch.gather(read2, 1, idx.clamp(min=0).long()).long()], 0)
        min_len = torch.minimum(d_len1, d_len2)
        t2 = time.perf_counter()
        self.seconds["prepare"] += t2 - t1

        # ---- the three scans, then the decisions, on the same stream ----
        if on_card:
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            marks[0].record()
        ins = torch.empty((2, B, L), dtype=INSERT_COUNT, device=self.device)
        scans = torch.empty((SCAN_ROWS, B, L), dtype=ADAPTER_COUNT, device=self.device)
        mesh.insert_scan_rows(seq1, seq2rc, min_len, ins)
        adapter_evidence_into(seq1, read2, d_len1, d_len2,
                              p.a1[:p.adapter_overlap], p.a2[:p.adapter_overlap],
                              *scans[:4])
        adapter_scan_into(seq1, d_len1, p.a1[:p.a_size], scans[4], scans[5])
        adapter_scan_into(read2, d_len2, p.a2[:p.a_size], scans[6], scans[7])
        t3 = time.perf_counter()
        if on_card:
            marks[1].record()
        dev["acc"].zero_()
        seqpurge_decide_into(scans, ins, dev["reads"][:2], dev["reads"][2:], dev["lens"],
                             self.table, self.need, dev["out"], dev["acc"], **self._decide)
        if on_card:
            marks[2].record()
        t4 = time.perf_counter()

        # ---- fetch: per-pair results and accumulators (and -ec's reads) ----
        end = offsets["lens"] if p.ec else offsets["reads"]
        if on_card:
            self._host[:end].copy_(self._work[:end], non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        out = host["out"].numpy()
        new_len1 = out[1].copy()
        new_len2 = out[2].copy()
        if p.ec:
            for row, a in enumerate((b1.bases, b2.bases, b1.quals, b2.quals)):
                a[:] = reads[row, :, :a.shape[1]]
        t5 = time.perf_counter()

        # ---- fold the batch's statistics ----
        self._fold(acc_fields(host["acc"].numpy()), B, len1, len2, new_len1, new_len2)
        t6 = time.perf_counter()
        if on_card:
            self.seconds["scans"] += marks[0].elapsed_time(marks[1]) / 1000.0
            self.seconds["decisions"] += marks[1].elapsed_time(marks[2]) / 1000.0
        else:
            self.seconds["scans"] += t3 - t2
            self.seconds["decisions"] += t4 - t3
        self.seconds["fetch"] += t5 - t4
        self.seconds["decisions"] += t6 - t5
        return new_len1, new_len2

    def _fold(self, acc: dict, B: int, len1, len2, new_len1, new_len2):
        """Adds one batch's accumulators into ``self.stats``; the removed
        bases' share is summed here, over the new lengths, as the JAX
        package's numpy route sums it (OutputWorker.cpp:34-77)."""
        s = self.stats
        for name, n in zip(COUNTERS, acc["counters"]):
            setattr(s, name, getattr(s, name) + int(n))
        for name in _ARRAY_FIELDS:
            getattr(s, name)[...] += acc[name]
        s.read_num += 2 * B
        nz1 = len1 > 0
        s.bases_perc_trim_sum += float(
            ((len1[nz1] - new_len1[nz1]) / len1[nz1]).sum())
        nz2 = len2 > 0
        s.bases_perc_trim_sum += float(
            ((len2[nz2] - new_len2[nz2]) / len2[nz2]).sum())

    # ------------- summary -------------
    def write_summary(self, out, params_a1: bytes, params_a2: bytes):
        """TrimmingStatistics::writeStatistics (Auxilary.h:166-221)."""
        s = self.stats
        w = out.write
        from decimal import ROUND_HALF_UP, Decimal

        def fmt2(v):
            if v != v:
                return "nan"
            return f"{Decimal(v).quantize(Decimal('0.01'), rounding=ROUND_HALF_UP):.2f}"

        w(f"Reads (forward + reverse): {s.read_num}\n\n")
        w(f"Reads trimmed by insert match: {int(s.reads_trimmed_insert)}\n")
        w(f"Reads trimmed by adapter match: {int(s.reads_trimmed_adapter)}\n")
        w(f"Reads trimmed by quality: {int(s.reads_trimmed_q)}\n")
        w(f"Reads trimmed by N stretches: {int(s.reads_trimmed_n)}\n")
        trimmed = s.reads_trimmed_insert + s.reads_trimmed_adapter
        w(f"Trimmed reads: {int(trimmed)} of {s.read_num} ({fmt2(100.0 * trimmed / s.read_num)}%)\n")
        w(f"Removed reads: {int(s.reads_removed)} of {s.read_num} ({fmt2(100.0 * s.reads_removed / s.read_num)}%)\n")
        w(f"Removed bases: {fmt2(100.0 * s.bases_perc_trim_sum / s.read_num)}%\n\n")

        for name, acons, given in (("Forward", s.acons1, params_a1),
                                   ("Reverse", s.acons2, params_a2)):
            seq = []
            for i in range(40):
                depth = int(acons[i, :4].sum())
                if depth < 20:
                    break
                mx = int(acons[i, :4].max())
                if mx / depth <= 0.5:
                    seq.append("N")
                else:
                    seq.append("ACGT"[int(np.argmax(acons[i, :4]))])
            w(f"{name} adapter sequence (given)    : {given.decode()}\n")
            w(f"{name} adapter sequence (consensus): {''.join(seq)}\n")
        w("\n")

        w("Read length distribution after trimming:\n")
        mx = MAXLEN - 1
        while mx > 0 and s.bases_remaining[mx] == 0:
            mx -= 1
        for i in range(mx + 1):
            w(f"{str(i).rjust(4)}: {int(s.bases_remaining[i])}\n")

    def write_ec_summary(self, out):
        s = self.stats
        w = out.write
        for title, arr in (("Read error per cycle (read 1):", s.mismatch_r1),
                           ("Read error per cycle (read 2):", s.mismatch_r2),
                           ("Read error count distribution:", s.errors_per_read)):
            w("\n")
            w(title + "\n")
            mx = MAXLEN - 1
            while mx > 0 and arr[mx] == 0:
                mx -= 1
            for i in range(1, mx + 1):
                w(f"{str(i).rjust(4)}: {int(arr[i])}\n")
