"""Mapping QC engines (MappingQC).

Counterpart of ``ngsbits_tpu/qc/mapping_stats.py``. The ROI depth runs on the
port's device: each batch's spans are scattered into a difference array there
(C1, ``ops/device_reduce.py::DeviceCoverage``) and one finalize makes the
depth histogram and the half-depth count from it (C2), so only a few hundred
integers come back. On ``NGSBITS_TORCH_DEVICE=cpu`` the same calls take the
kernels' plain versions; there is no size threshold. Under a process group
(``parallel/mesh.py``) each rank's share of each batch's usable reads goes to
C1, and the ranks' difference arrays are summed (``all_reduce``) before C2;
the host counters stay whole on every rank, as on the JAX package's mesh
route. WGS's QC-region coverage and ``somatic_custom_depth`` stay host numpy,
as in the JAX package.

Behavioral reference: ngs-bits Statistics::mapping (ROI mode,
cppNGS/Statistics.cpp:343-803), mapping (no-ROI, :805-989), mapping_wgs
(:990-1360), contamination (:2333-2386), yxRatio (:2658-2697).

Design: the reference's per-alignment loop becomes one sequential
batched pass with vectorized counters:
  * running-max read length (order-dependent trimmed-base quirk) via
    np.maximum.accumulate with cross-batch carry
  * near/on-target tests via searchsorted on merged ROI arrays (O(1)/read)
  * usable-base overlap sums via region-length prefix sums (only the first
    and last overlapped region need clipping)
  * base-resolution ROI coverage as a diff array over the *flattened* ROI
    coordinate space (size = roi bases), prefix-summed and binned once at
    the end
  * insert-size/GC/duplication histograms via bincount
"""

from __future__ import annotations

import math
import time

import numpy as np

from ..core.chromosome import Chromosome
from ..core.histogram import Histogram
from ..core.intervals import BedFile
from ..core.qcml import QCCollection
from ..core import resources
from ..io.bam import (BamBatch, BamReader, FLAG_DUPLICATE, FLAG_PAIRED,
                      FLAG_PROPER_PAIR, FLAG_READ1, FLAG_SECONDARY,
                      FLAG_SUPPLEMENTARY, FLAG_UNMAPPED)
from ..io.fasta import FastaFileIndex, gc_content
from ..core.plots import LinePlot
from ..ops.device_reduce import DeviceCoverage
from ..parallel import mesh
from ..utils.prefetch import prefetch
from .pileup import pileup_at_positions
from .variant_stats import add_qc_plot, add_qc_value


class RoiLookup:
    """Merged+sorted ROI with O(1) vectorized overlap queries."""

    def __init__(self, bed: BedFile):
        chrs, starts, ends = bed.columns()
        self.n = len(starts)
        self.starts = starts
        self.ends = ends
        self.lengths = ends - starts + 1
        self.flat_off = np.concatenate(([0], np.cumsum(self.lengths)))
        self.len_prefix = self.flat_off  # same thing
        self.chr_slices: dict[int, tuple[int, int]] = {}
        if self.n:
            change = np.flatnonzero(np.diff(chrs)) + 1
            bounds = np.concatenate(([0], change, [self.n]))
            for k in range(len(bounds) - 1):
                self.chr_slices[int(chrs[bounds[k]])] = (int(bounds[k]), int(bounds[k + 1]))

    def overlap_range(self, chr_num: int, qs: np.ndarray, qe: np.ndarray):
        """[i0, i1) global region-index range overlapping each query
        (regions are disjoint+sorted per chromosome)."""
        sl = self.chr_slices.get(chr_num)
        if sl is None:
            z = np.zeros(len(qs), dtype=np.int64)
            return z, z
        lo, hi = sl
        s = self.starts[lo:hi]
        e = self.ends[lo:hi]
        i0 = np.searchsorted(e, qs, side="left")
        i1 = np.searchsorted(s, qe, side="right")
        i1 = np.maximum(i1, i0)
        return i0 + lo, i1 + lo

    def overlap_sum(self, i0: np.ndarray, i1: np.ndarray, qs: np.ndarray, qe: np.ndarray):
        """Sum of clipped overlaps with regions [i0, i1) per query."""
        has = i1 > i0
        total = np.zeros(len(qs), dtype=np.int64)
        if has.any():
            a = i0[has]
            b = i1[has] - 1
            full = self.len_prefix[b + 1] - self.len_prefix[a]
            left_clip = np.maximum(qs[has] - self.starts[a], 0)
            right_clip = np.maximum(self.ends[b] - qe[has], 0)
            total[has] = full - left_clip - right_clip
        return total


def _tag_int(tags: np.ndarray, key: bytes) -> int:
    """Parse an integer tag value from a raw BAM tag blob (returns 0 if
    absent, like BamAlignment::tagi)."""
    i = 0
    n = len(tags)
    b = tags.tobytes()
    while i + 3 <= n:
        tag = b[i:i + 2]
        typ = b[i + 2:i + 3]
        i += 3
        if typ in b"cC":
            val = b[i]; size = 1
            if typ == b"c" and val > 127:
                val -= 256
        elif typ in b"sS":
            val = int.from_bytes(b[i:i + 2], "little", signed=(typ == b"s")); size = 2
        elif typ in b"iI":
            val = int.from_bytes(b[i:i + 4], "little", signed=(typ == b"i")); size = 4
        elif typ == b"f":
            import struct
            val = struct.unpack("<f", b[i:i + 4])[0]; size = 4
        elif typ in b"AZHJ" or typ == b"Z":
            end = b.index(b"\x00", i) if typ in b"ZH" else i
            if typ == b"A":
                size = 1
            else:
                size = end - i + 1
            val = None
        elif typ == b"B":
            sub = b[i:i + 1]
            cnt = int.from_bytes(b[i + 1:i + 5], "little")
            esz = {b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4, b"f": 4}[sub]
            size = 5 + cnt * esz
            val = None
        else:
            return 0
        if tag == key and val is not None:
            return int(val)
        i += size
    return 0


class MappingScan:
    """Single sequential pass accumulating all mapping() counters."""

    def __init__(self, roi: RoiLookup | None = None, cfdna: bool = False,
                 min_mapq: int = 1, dropout: RoiLookup | None = None,
                 gc_bin_of_chunk: np.ndarray | None = None,
                 nonspecial_ontarget: bool = False):
        self.roi = roi
        self.cfdna = cfdna
        self.min_mapq = min_mapq
        self.dropout = dropout
        self.gc_bin_of_chunk = gc_bin_of_chunk
        self.nonspecial_ontarget = nonspecial_ontarget

        self.al_total = 0
        self.al_mapped = 0
        self.al_ontarget = 0
        self.al_neartarget = 0
        self.al_dup = 0
        self.al_proper_paired = 0
        self.insert_size_read_count = 0
        self.insert_size_sum = 0.0
        self.insert_hist = np.zeros(200, dtype=np.int64)   # Histogram(0,999,5)
        self.bases_trimmed = 0.0
        self.bases_mapped = 0.0
        self.bases_clipped = 0.0
        self.bases_usable = 0
        self.bases_usable_no_overlap = 0
        self.bases_usable_dp = np.zeros(5, dtype=np.int64)
        self.bases_usable_raw = 0
        self.dp_hist = np.zeros(4, dtype=np.int64)          # Histogram(0.5,4.5,1)
        self.max_length = 0
        self.paired_end = False
        self.reads_per_ref: np.ndarray | None = None
        # the ROI depth's difference array lives on the device (C1's read
        # form per batch, C2 once at the end), the ROI's regions beside it;
        # DeviceCoverage checks that the flattened ROI fits int32 coordinates
        self._roi_dev = (DeviceCoverage(int(roi.flat_off[-1]),
                                        regions=np.stack([roi.starts, roi.ends]))
                         if roi is not None else None)
        self.gc_chunk_weights = (np.zeros(dropout.n, dtype=np.float64)
                                 if dropout is not None else None)
        self._chr_num_cache: np.ndarray | None = None

    def _ref_nums(self, reader: BamReader) -> np.ndarray:
        if self._chr_num_cache is None:
            self._chr_num_cache = np.array(
                [Chromosome(n).num for n in reader.ref_names], dtype=np.int64)
            self.reads_per_ref = np.zeros(len(reader.ref_names), dtype=np.int64)
        return self._chr_num_cache

    def process(self, batch: BamBatch, reader: BamReader):
        ref_nums = self._ref_nums(reader)
        flag = batch.flag
        primary = (flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) == 0
        p_idx = np.flatnonzero(primary)
        if len(p_idx) == 0:
            return
        self.al_total += len(p_idx)
        pf = flag[p_idx]
        lengths = batch.l_seq[p_idx].astype(np.int64)
        if (pf & FLAG_PAIRED).any():
            self.paired_end = True

        # reads per ref (for yx ratio)
        rid = batch.ref_id[p_idx]
        valid_rid = rid >= 0
        if valid_rid.any():
            np.add.at(self.reads_per_ref, rid[valid_rid], 1)

        # running max length + trimmed bases (order-dependent)
        runmax = np.maximum.accumulate(np.maximum(lengths, self.max_length))
        shorter = lengths < runmax
        self.bases_trimmed += float((runmax[shorter] - lengths[shorter]).sum())
        if len(lengths):
            self.max_length = int(runmax[-1])

        mapped = primary & ((flag & FLAG_UNMAPPED) == 0)
        m_idx = np.flatnonzero(mapped)
        self.al_mapped += len(m_idx)
        self.bases_mapped += float(batch.l_seq[m_idx].sum())

        # per-read clipped bases + spliced flag from flat cigar
        ops = (batch.cigar & 0xF).astype(np.int64)
        lens = (batch.cigar >> 4).astype(np.int64)
        co = batch.cigar_off
        n_ops = co[1:] - co[:-1]
        read_of_op = np.repeat(np.arange(len(batch)), n_ops)
        mapped_op = mapped[read_of_op]
        is_clip = ((ops == 4) | (ops == 5)) & mapped_op
        self.bases_clipped += float(lens[is_clip].sum())
        spliced = np.zeros(len(batch), dtype=bool)
        skip_ops = (ops == 3) & mapped_op
        spliced[read_of_op[skip_ops]] = True

        ends = batch.end_positions()  # 0-based exclusive == 1-based inclusive
        starts = batch.pos.astype(np.int64) + 1

        # ---- ROI / on-target logic ----
        if self.roi is not None and len(m_idx):
            rids = batch.ref_id[m_idx]
            chrs = ref_nums[rids]
            near = np.zeros(len(m_idx), dtype=bool)
            on_i0 = np.zeros(len(m_idx), dtype=np.int64)
            on_i1 = np.zeros(len(m_idx), dtype=np.int64)
            for cn in np.unique(chrs):
                seg = np.flatnonzero(chrs == cn)
                g = m_idx[seg]
                qs = starts[g]
                qe = ends[g]
                n0, n1 = self.roi.overlap_range(int(cn), qs - 250, qe + 250)
                near[seg] = n1 > n0
                i0, i1 = self.roi.overlap_range(int(cn), qs, qe)
                on_i0[seg] = i0
                on_i1[seg] = i1
            self.al_neartarget += int(near.sum())
            on = on_i1 > on_i0
            self.al_ontarget += int(on.sum())

            on_seg = np.flatnonzero(on)
            g = m_idx[on_seg]                       # global batch indices
            dp_vals = np.zeros(len(on_seg), dtype=np.int64)
            if self.cfdna:
                for k, gi in enumerate(g):
                    t = batch.tags[batch.tags_off[gi]:batch.tags_off[gi + 1]]
                    dp_vals[k] = _tag_int(t, b"DP")
                nz = dp_vals != 0
                if nz.any():
                    np.add.at(self.dp_hist, np.minimum(dp_vals[nz], 4) - 1, 1)

            usable = ((batch.flag[g] & FLAG_DUPLICATE) == 0) & (batch.mapq[g] >= self.min_mapq)
            u = np.flatnonzero(usable)
            if len(u):
                gu = g[u]
                i0 = on_i0[on_seg[u]]
                i1 = on_i1[on_seg[u]]
                qs = starts[gu]
                qe = ends[gu]
                ol = self.roi.overlap_sum(i0, i1, qs, qe)
                self.bases_usable += int(ol.sum())
                self.bases_usable_no_overlap += int(ol.sum())
                dpu = np.minimum(dp_vals[u], 4)
                np.add.at(self.bases_usable_dp, dpu, ol)
                self.bases_usable_raw += int((ol * (dp_vals[u] + 1)).sum())

                # flattened-ROI coverage: the card clips each read to each
                # region of its range (under a process group, this rank's
                # share of the reads; mapping_roi sums the ranks' arrays)
                lo, hi = mesh.rows(len(qs))
                self._roi_dev.add_reads(qs[lo:hi], qe[lo:hi], i0[lo:hi], i1[lo:hi])

                # paired-end mate-overlap subtraction
                fl = batch.flag[gu]
                tlen = batch.tlen[gu].astype(np.int64)
                rl = batch.l_seq[gu].astype(np.int64)
                cand = (((fl & FLAG_READ1) != 0) & ((fl & FLAG_PAIRED) != 0)
                        & ((fl & FLAG_PROPER_PAIR) != 0) & ~spliced[gu]
                        & (2 * rl > np.abs(tlen)))
                ci = np.flatnonzero(cand)
                if len(ci):
                    ov_len = 2 * rl[ci] - np.abs(tlen[ci])
                    left = tlen[ci] > 0
                    ov_start = np.where(left, qs[ci] + rl[ci] - ov_len, qs[ci])
                    ov_end = ov_start + ov_len - 1
                    chrs_c = ref_nums[batch.ref_id[gu[ci]]]
                    for cn in np.unique(chrs_c):
                        seg2 = np.flatnonzero(chrs_c == cn)
                        j0, j1 = self.roi.overlap_range(int(cn), ov_start[seg2], ov_end[seg2])
                        sub = self.roi.overlap_sum(j0, j1, ov_start[seg2], ov_end[seg2])
                        self.bases_usable_no_overlap -= int(sub.sum())

            # GC statistics: ALL on-target reads (incl. dup/low-mapq)
            if self.dropout is not None and len(g):
                chrs_g = ref_nums[batch.ref_id[g]]
                for cn in np.unique(chrs_g):
                    seg3 = np.flatnonzero(chrs_g == cn)
                    gg = g[seg3]
                    d0, d1 = self.dropout.overlap_range(int(cn), starts[gg], ends[gg])
                    cnt = d1 - d0
                    nz = np.flatnonzero(cnt > 0)
                    if len(nz) == 0:
                        continue
                    w = 1.0 / cnt[nz]
                    rep = np.repeat(np.arange(len(nz)), cnt[nz])
                    chunks = np.repeat(d0[nz], cnt[nz]) + (
                        np.arange(int(cnt[nz].sum()), dtype=np.int64)
                        - np.repeat(np.concatenate(([0], np.cumsum(cnt[nz][:-1]))), cnt[nz]))
                    np.add.at(self.gc_chunk_weights, chunks, np.repeat(w, cnt[nz]))
        elif self.nonspecial_ontarget and len(m_idx):
            chrs = ref_nums[batch.ref_id[m_idx]]
            nonspecial = (chrs > 0) & (chrs < 1004)
            self.al_ontarget += int(nonspecial.sum())
            usable = (nonspecial & ((batch.flag[m_idx] & FLAG_DUPLICATE) == 0)
                      & (batch.mapq[m_idx] >= self.min_mapq))
            ulen = batch.l_seq[m_idx][usable].astype(np.int64)
            self.bases_usable += int(ulen.sum())
            if self.paired_end:
                self.bases_usable_no_overlap += int(ulen.sum())

        # ---- insert size ----
        proper = primary & ((flag & FLAG_PAIRED) != 0) & ((flag & FLAG_PROPER_PAIR) != 0)
        self.al_proper_paired += int(proper.sum())
        ins_sel = proper & ~spliced
        ins = np.abs(batch.tlen[ins_sel].astype(np.int64))
        small = ins < 1000
        self.insert_size_read_count += int(small.sum())
        self.insert_size_sum += float(ins[small].sum())
        np.add.at(self.insert_hist, np.minimum(ins[small] // 5, 199), 1)

        # no-ROI mode: mate-overlap correction on insert-size-qualified read1
        if self.roi is None and self.nonspecial_ontarget:
            q = (ins_sel & ((flag & FLAG_READ1) != 0)
                 & ((flag & FLAG_DUPLICATE) == 0) & (batch.mapq >= self.min_mapq))
            qi = np.flatnonzero(q)
            if len(qi):
                li = batch.l_seq[qi].astype(np.int64)
                ti = np.abs(batch.tlen[qi].astype(np.int64))
                ok = (ti < 1000) & (2 * li > ti)
                self.bases_usable_no_overlap -= int((2 * li[ok] - ti[ok]).sum())

        self.al_dup += int(((pf & FLAG_DUPLICATE) != 0).sum())


def _gc_prepare(bed: BedFile, ref: FastaFileIndex):
    """Chunk the ROI into 100bp pieces and compute per-chunk GC bin.

    One reference read per parent ROI region (chunks are consecutive
    after BedFile.chunk) + prefix-sum slicing — instead of one
    FastaFileIndex.seq() call per 100bp chunk. Identical bins: the
    GC ratio per chunk is the same double division."""
    dropout = BedFile()
    dropout.lines = [type(l)(l.chr, l.start, l.end, []) for l in bed.lines]
    dropout.chunk(100)
    n = len(dropout.lines)
    bins = np.full(n, -1, dtype=np.int64)
    gc_roi = np.zeros(101, dtype=np.float64)
    parents = bed.lines
    pi = 0
    i = 0
    while i < n:
        line = dropout.lines[i]
        while pi < len(parents) and not (
                parents[pi].chr == line.chr
                and parents[pi].start <= line.start
                and line.end <= parents[pi].end):
            pi += 1
        if pi >= len(parents):
            # unexpected layout — per-chunk fallback for the remainder
            for j in range(i, n):
                l = dropout.lines[j]
                gc = gc_content(ref.seq(l.chr, l.start, l.length()))
                if math.isfinite(gc):
                    b = int(math.floor(100.0 * gc))
                    bins[j] = b
                    gc_roi[b] += 1.0
            break
        parent = parents[pi]
        # find all consecutive chunks belonging to this parent
        j = i
        while j < n:
            l = dropout.lines[j]
            if not (l.chr == parent.chr and parent.start <= l.start
                    and l.end <= parent.end):
                break
            j += 1
        # process them in bounded windows (a parent can be a whole
        # chromosome — don't materialize chromosome-scale prefix sums)
        window = 4 << 20
        k = i
        while k < j:
            k_end = k
            win_start = dropout.lines[k].start
            while k_end < j and dropout.lines[k_end].end - win_start < window:
                k_end += 1
            if k_end == k:          # single chunk larger than the window
                k_end = k + 1
            win_end = dropout.lines[k_end - 1].end
            block = ref.seq(parent.chr, win_start, win_end - win_start + 1)
            arr = np.frombuffer(block, dtype=np.uint8)
            is_gc = (arr == ord("G")) | (arr == ord("C")) | (arr == ord("g")) | (arr == ord("c"))
            is_at = (arr == ord("A")) | (arr == ord("T")) | (arr == ord("a")) | (arr == ord("t"))
            cg = np.concatenate(([0], np.cumsum(is_gc, dtype=np.int32)))
            ca = np.concatenate(([0], np.cumsum(is_at, dtype=np.int32)))
            blen = len(arr)
            for jj in range(k, k_end):
                l = dropout.lines[jj]
                s = min(l.start - win_start, blen)
                e = min(l.end - win_start + 1, blen)
                gcn = int(cg[e] - cg[s])
                atn = int(ca[e] - ca[s])
                if gcn + atn:
                    b = int(math.floor(100.0 * (gcn / (gcn + atn))))
                    bins[jj] = b
                    gc_roi[b] += 1.0
            k = k_end
        i = j
        pi += 1
    return dropout, bins, gc_roi[:100], gc_roi


def _dropout_metrics(gc_roi: np.ndarray, gc_reads: np.ndarray):
    gc_sum = gc_roi.sum()
    read_sum = gc_reads.sum()
    at_dropout = 0.0
    gc_dropout = 0.0
    roi_perc = []
    read_perc = []
    for i in range(100):
        rp = 100.0 * gc_roi[i] / gc_sum if gc_sum else math.nan
        gp = 100.0 * gc_reads[i] / read_sum if read_sum else math.nan
        roi_perc.append(rp)
        read_perc.append(gp)
        diff = rp - gp
        if diff > 0:
            if i <= 50:
                at_dropout += diff
            if i >= 50:
                gc_dropout += diff
    return at_dropout, gc_dropout, roi_perc, read_perc


def _depth_histogram_params(avg_depth: float, is_cfdna: bool, adaptive: bool):
    """(half_depth, hist_max, hist_step), all integers, from the mean depth
    (Statistics.cpp's adaptive depth histogram)."""
    half_depth = int(np.floor(0.5 * avg_depth + 0.5)) if avg_depth >= 0 else 0
    hist_max = 599
    hist_step = 5
    if adaptive:
        if avg_depth > 200:
            hist_max += 400
            hist_step += 5
        if avg_depth > 500:
            hist_max += 500
        if avg_depth > 1000:
            hist_max += 1000
        if is_cfdna:
            hist_max = 20000
            hist_step = 500
    return half_depth, hist_max, hist_step


def _depth_histogram_metrics(cov: np.ndarray, roi_bases: int, avg_depth: float,
                             is_cfdna: bool, adaptive: bool):
    """The depth histogram and half-depth count of a dense host coverage
    array (WGS's QC regions, the somatic custom panel)."""
    half_depth, hist_max, hist_step = _depth_histogram_params(avg_depth, is_cfdna,
                                                              adaptive)
    hist = Histogram(0, hist_max, hist_step)
    bc = hist.bin_count()
    # single-bincount formulation (cov can be 10^7+ elements): values above
    # the last bin are clamped into it while <= hist_max, dropped beyond —
    # same result as masking cov <= hist_max then clamping
    d = cov // hist_step
    counts_all = np.bincount(d)
    counts = np.zeros(bc, dtype=counts_all.dtype)
    take = min(bc, len(counts_all))
    counts[:take] = counts_all[:take]
    if len(counts_all) > bc:
        tail = cov[d >= bc]
        counts[bc - 1] += int((tail <= hist_max).sum())
    hist.add_counts(counts.astype(np.float64))
    bases_half = int(np.count_nonzero(cov >= half_depth))
    return hist, bases_half


def yx_ratio(scan: MappingScan, reader: BamReader):
    ref_nums = scan._ref_nums(reader)
    names = [Chromosome(n).num for n in reader.ref_names]
    have_x = 1001 in names
    have_y = 1002 in names
    if not have_x or not have_y:
        return math.nan
    reads_x = int(scan.reads_per_ref[[i for i, n in enumerate(names) if n == 1001]].sum())
    reads_y = int(scan.reads_per_ref[[i for i, n in enumerate(names) if n == 1002]].sum())
    if reads_x == 0:
        return math.nan
    return reads_y / reads_x


def _common_output(output: QCCollection, scan: MappingScan, dup_na_text: str):
    add_qc_value(output, "QC:2000052", "clipped base percentage",
                 100.0 * scan.bases_clipped / scan.bases_mapped)
    add_qc_value(output, "QC:2000020", "mapped read percentage",
                 100.0 * scan.al_mapped / scan.al_total)
    add_qc_value(output, "QC:2000021", "on-target read percentage",
                 100.0 * scan.al_ontarget / scan.al_total)


def _insert_hist_obj(scan: MappingScan) -> Histogram:
    h = Histogram(0, 999, 5)
    h.add_counts(scan.insert_hist.astype(np.float64))
    return h


def _insert_plot(output, scan):
    h = _insert_hist_obj(scan)
    plot = LinePlot()
    plot.set_xlabel("insert size")
    plot.set_ylabel("reads [%]")
    plot.set_xvalues(h.x_coords())
    plot.add_line(h.y_coords(True))
    add_qc_plot(output, "QC:2000038", "insert size distribution plot", plot.to_base64())


def _depth_plot(output, hist: Histogram):
    plot = LinePlot()
    plot.set_xlabel("depth of coverage")
    plot.set_ylabel("target region [%]")
    plot.set_xvalues(hist.x_coords())
    plot.add_line(hist.y_coords(True))
    add_qc_plot(output, "QC:2000037", "depth distribution plot", plot.to_base64())


def _gc_plot(output, roi_perc, read_perc):
    plot = LinePlot()
    plot.set_xlabel("GC bin")
    plot.set_ylabel("count [%]")
    plot.set_xvalues(np.arange(100, dtype=np.float64))
    plot.add_line(roi_perc, "target region")
    plot.add_line(read_perc, "reads")
    add_qc_plot(output, "QC:2000061", "GC bias plot", plot.to_base64())


def _yx_output(output, scan, reader):
    r = yx_ratio(scan, reader)
    if not math.isnan(r):
        add_qc_value(output, "QC:2000139", "chrY/chrX read ratio", f"{r:.4f}")


_DEPTH_LEVELS = [10, 20, 30, 50, 60, 100, 200, 500]
_DEPTH_ACCESSIONS = ["QC:2000026", "QC:2000027", "QC:2000028", "QC:2000029",
                     "QC:2000099", "QC:2000030", "QC:2000031", "QC:2000032"]
_CFDNA_LEVELS = [1000, 2500, 5000, 7500, 10000, 15000]
_CFDNA_ACCESSIONS = ["QC:2000065", "QC:2000066", "QC:2000067", "QC:2000068",
                     "QC:2000069", "QC:2000070"]


def _depth_level_values(output, hist: Histogram, roi_bases: int, levels, accessions):
    for depth, acc in zip(levels, accessions):
        b0 = hist._index(depth)
        cov_bases = float(hist._bins[b0:].sum())
        add_qc_value(output, acc, f"target region {depth}x percentage",
                     100.0 * cov_bases / roi_bases)


def mapping_roi(bed: BedFile, bam_file: str, ref_file: str, min_mapq: int = 1,
                is_cfdna: bool = False, seconds: dict | None = None) -> QCCollection:
    """ROI mode (Statistics.cpp:343-803). With ``seconds``, adds the host
    seconds of the BAM pass (``scan``: decode wait, the scan and C1's
    uploads and launches) and of the depth finalize (``finalize``: C2 and
    its fetch) into it."""
    seconds = {} if seconds is None else seconds
    if not bed.is_merged_and_sorted():
        raise ValueError("Merged and sorted BED file required for coverage details statistics!")
    roi = RoiLookup(bed)
    roi_bases = int(roi.flat_off[-1])

    ref = FastaFileIndex(ref_file)
    dropout_bed, gc_bins, gc_roi, _full = _gc_prepare(bed, ref)
    dropout = RoiLookup(dropout_bed)

    scan = MappingScan(roi=roi, cfdna=is_cfdna, min_mapq=min_mapq,
                       dropout=dropout, gc_bin_of_chunk=gc_bins)
    reader = BamReader(bam_file)
    # decode-ahead thread: BAM inflation overlaps the analysis pass (the
    # reference's read/analyze thread split); only this thread touches the
    # device
    t0 = time.perf_counter()
    for batch in prefetch(reader, depth=2):
        scan.process(batch, reader)
    reader.close()
    seconds["scan"] = seconds.get("scan", 0.0) + time.perf_counter() - t0

    # chunk weights -> per-bin read weights
    gc_reads = np.zeros(100, dtype=np.float64)
    valid = gc_bins >= 0
    np.add.at(gc_reads, gc_bins[valid], scan.gc_chunk_weights[valid])
    at_dropout, gc_dropout, roi_perc, read_perc = _dropout_metrics(gc_roi, gc_reads)

    t0 = time.perf_counter()
    avg_depth = scan.bases_usable / roi_bases
    half_depth, hist_max, hist_step = _depth_histogram_params(avg_depth, is_cfdna,
                                                              adaptive=True)
    hist = Histogram(0, hist_max, hist_step)
    mesh.sum_ranks_(scan._roi_dev.diff)
    counts, bases_half = scan._roi_dev.histogram(hist_step, hist_max,
                                                 hist.bin_count(), half_depth)
    hist.add_counts(counts.astype(np.float64))
    seconds["finalize"] = seconds.get("finalize", 0.0) + time.perf_counter() - t0

    output = QCCollection()
    add_qc_value(output, "QC:2000019", "trimmed base percentage",
                 100.0 * scan.bases_trimmed / scan.al_total / scan.max_length)
    _common_output(output, scan, "")
    add_qc_value(output, "QC:2000057", "near-target read percentage",
                 100.0 * scan.al_neartarget / scan.al_total)
    if scan.paired_end:
        add_qc_value(output, "QC:2000022", "properly-paired read percentage",
                     100.0 * scan.al_proper_paired / scan.al_total)
        add_qc_value(output, "QC:2000023", "insert size",
                     scan.insert_size_sum / scan.insert_size_read_count)
        add_qc_value(output, "QC:2000150", "target region read depth (no ol)",
                     scan.bases_usable_no_overlap / roi_bases)
    else:
        add_qc_value(output, "QC:2000022", "properly-paired read percentage", "n/a (single end)")
        add_qc_value(output, "QC:2000023", "insert size", "n/a (single end)")
    if scan.al_dup == 0:
        add_qc_value(output, "QC:2000024", "duplicate read percentage",
                     "n/a (no duplicates marked or duplicates removed during data analysis)")
    else:
        add_qc_value(output, "QC:2000024", "duplicate read percentage",
                     100.0 * scan.al_dup / scan.al_total)
    add_qc_value(output, "QC:2000050", "bases usable (MB)", scan.bases_usable / 1000000.0)
    add_qc_value(output, "QC:2000025", "target region read depth", avg_depth)

    cumsum_depth = np.zeros(5)
    if is_cfdna:
        running = 0.0
        for i in range(4, -1, -1):
            running += scan.bases_usable_dp[i] / roi_bases
            cumsum_depth[i] = running
        for i in range(2, 5):
            add_qc_value(output, f"QC:200007{i - 1}",
                         f"target region read depth {i}-fold duplication", cumsum_depth[i])
        add_qc_value(output, "QC:2000074", "raw target region read depth",
                     scan.bases_usable_raw / roi_bases)

    levels = list(_DEPTH_LEVELS)
    accessions = list(_DEPTH_ACCESSIONS)
    if is_cfdna:
        levels += _CFDNA_LEVELS
        accessions += _CFDNA_ACCESSIONS
    _depth_level_values(output, hist, roi_bases, levels, accessions)
    add_qc_value(output, "QC:2000058", "target region half depth percentage",
                 100.0 * bases_half / roi_bases)
    add_qc_value(output, "QC:2000059", "AT dropout", at_dropout)
    add_qc_value(output, "QC:2000060", "GC dropout", gc_dropout)

    _depth_plot(output, hist)
    if scan.paired_end:
        _insert_plot(output, scan)
    if is_cfdna and scan.dp_hist.sum() != 0:
        h = Histogram(0.5, 4.5, 1)
        h.add_counts(scan.dp_hist.astype(np.float64))
        plot = LinePlot()
        plot.set_xlabel("duplicates")
        plot.set_ylabel("fragments [%]")
        plot.set_yrange(0, 100)
        plot.set_xvalues(h.x_coords())
        plot.add_line(h.y_coords(True))
        add_qc_plot(output, "QC:2000075", "fragment duplication distribution plot",
                    plot.to_base64())
        plot4 = LinePlot()
        plot4.set_xlabel("minimum number of duplicates")
        plot4.set_ylabel("depth of coverage")
        plot4.set_xvalues(np.arange(1, 5, dtype=np.float64))
        plot4.add_line(cumsum_depth[1:])
        add_qc_plot(output, "QC:2000076", "duplication-coverage plot", plot4.to_base64())
    _gc_plot(output, roi_perc, read_perc)
    reader2 = BamReader(bam_file)
    _yx_output(output, scan, reader2)
    reader2.close()
    return output


def _genome_size_nonspecial(reader: BamReader) -> int:
    total = 0
    for name, length in zip(reader.ref_names, reader.ref_lengths):
        if Chromosome(name).is_non_special():
            total += int(length)
    return total


def _genome_n_bases(reader: BamReader, ref: FastaFileIndex) -> float:
    total = 0.0
    for name in reader.ref_names:
        c = Chromosome(name)
        if c.is_non_special():
            total += ref.n_count(c)
    return total


def mapping_no_roi(bam_file: str, ref_file: str, min_mapq: int = 1) -> QCCollection:
    """No-ROI mode for RNA/non-human (Statistics.cpp:805-989)."""
    scan = MappingScan(roi=None, min_mapq=min_mapq, nonspecial_ontarget=True)
    reader = BamReader(bam_file)
    for batch in prefetch(reader, depth=2):
        scan.process(batch, reader)
    scan.bases_usable -= int(scan.bases_clipped)

    ref = FastaFileIndex(ref_file)
    no_base = _genome_n_bases(reader, ref)
    genome = _genome_size_nonspecial(reader)

    output = QCCollection()
    add_qc_value(output, "QC:2000019", "trimmed base percentage",
                 100.0 * scan.bases_trimmed / scan.al_total / scan.max_length)
    _common_output(output, scan, "")
    if scan.paired_end:
        add_qc_value(output, "QC:2000022", "properly-paired read percentage",
                     100.0 * scan.al_proper_paired / scan.al_total)
        add_qc_value(output, "QC:2000023", "insert size",
                     scan.insert_size_sum / scan.insert_size_read_count)
        add_qc_value(output, "QC:2000150", "target region read depth (no ol)",
                     scan.bases_usable_no_overlap / (genome - no_base))
    else:
        add_qc_value(output, "QC:2000022", "properly-paired read percentage", "n/a (single end)")
        add_qc_value(output, "QC:2000023", "insert size", "n/a (single end)")
    if scan.al_dup == 0:
        add_qc_value(output, "QC:2000024", "duplicate read percentage",
                     "n/a (duplicates not marked or removed during data analysis)")
    else:
        add_qc_value(output, "QC:2000024", "duplicate read percentage",
                     100.0 * scan.al_dup / scan.al_total)
    add_qc_value(output, "QC:2000050", "bases usable (MB)", scan.bases_usable / 1000000.0)
    add_qc_value(output, "QC:2000025", "target region read depth",
                 scan.bases_usable / (genome - no_base))
    if scan.paired_end and scan.insert_hist.sum() > 0:
        _insert_plot(output, scan)
    _yx_output(output, scan, reader)
    reader.close()
    return output


def mapping_wgs(bam_file: str, qc_bed: BedFile | None, min_mapq: int, ref_file: str) -> QCCollection:
    """WGS mode (Statistics.cpp:990-1360): global pass + QC-region pass."""
    roi_available = qc_bed is not None and len(qc_bed)
    roi_bed = BedFile()
    if roi_available:
        roi_bed.lines = [type(l)(l.chr, l.start, l.end, []) for l in qc_bed.lines]
        if not roi_bed.is_merged_and_sorted():
            roi_bed.sort()
            roi_bed.merge()

    scan = MappingScan(roi=None, min_mapq=min_mapq, nonspecial_ontarget=True)
    reader = BamReader(bam_file)
    for batch in prefetch(reader, depth=2):
        scan.process(batch, reader)
    scan.bases_usable -= int(scan.bases_clipped)

    ref = FastaFileIndex(ref_file)

    # pass 2: QC-region coverage + GC (sequential scan filtered to ROI)
    at_dropout = gc_dropout = 0.0
    roi_perc = read_perc = None
    hist = None
    bases_half = 0
    bases_usable_roi = 0
    roi_bases = 0
    if roi_available:
        roi = RoiLookup(roi_bed)
        roi_bases = int(roi.flat_off[-1])
        dropout_bed, gc_bins, gc_roi, _ = _gc_prepare(roi_bed, ref)
        dropout = RoiLookup(dropout_bed)
        cov_diff = np.zeros(roi_bases + 1, dtype=np.int64)
        gc_chunk_w = np.zeros(dropout.n, dtype=np.float64)
        reader2 = BamReader(bam_file)
        ref_nums = np.array([Chromosome(n).num for n in reader2.ref_names], dtype=np.int64)
        for batch in reader2:
            flag = batch.flag
            sel = (flag & (0x100 | 0x800 | 0x4)) == 0
            idx = np.flatnonzero(sel & (batch.ref_id >= 0))
            if len(idx) == 0:
                continue
            ends = batch.end_positions()
            starts = batch.pos.astype(np.int64) + 1
            chrs = ref_nums[batch.ref_id[idx]]
            for cn in np.unique(chrs):
                seg = idx[chrs == cn]
                qs = starts[seg]
                qe = ends[seg]
                i0, i1 = roi.overlap_range(int(cn), qs, qe)
                mult = i1 - i0
                onz = np.flatnonzero(mult > 0)
                if len(onz) == 0:
                    continue
                # GC statistics (per overlapped roi region => weight = mult)
                d0, d1 = dropout.overlap_range(int(cn), qs[onz], qe[onz])
                dcnt = d1 - d0
                dnz = np.flatnonzero(dcnt > 0)
                if len(dnz):
                    w = mult[onz][dnz] / dcnt[dnz]
                    chunks = np.repeat(d0[dnz], dcnt[dnz]) + (
                        np.arange(int(dcnt[dnz].sum()), dtype=np.int64)
                        - np.repeat(np.concatenate(([0], np.cumsum(dcnt[dnz][:-1]))), dcnt[dnz]))
                    np.add.at(gc_chunk_w, chunks, np.repeat(w, dcnt[dnz]))
                # usable + coverage (per overlapped region)
                g = seg[onz]
                usable = (((batch.flag[g] & 0x400) == 0) & (batch.mapq[g] >= min_mapq))
                u = np.flatnonzero(usable)
                if len(u):
                    gu = g[u]
                    m = mult[onz][u]
                    bases_usable_roi += int((batch.l_seq[gu].astype(np.int64) * m).sum())
                    cnt = m
                    rep_i0 = i0[onz][u]
                    regions = np.repeat(rep_i0, cnt) + (
                        np.arange(int(cnt.sum()), dtype=np.int64)
                        - np.repeat(np.concatenate(([0], np.cumsum(cnt[:-1]))), cnt))
                    rep = np.repeat(np.arange(len(gu)), cnt)
                    r_start = roi.starts[regions]
                    r_end = roi.ends[regions]
                    ol_s = np.maximum(r_start, starts[gu][rep])
                    ol_e = np.minimum(r_end, ends[gu][rep])
                    ok = ol_s <= ol_e
                    flat_s = roi.flat_off[regions[ok]] + (ol_s[ok] - r_start[ok])
                    flat_e = flat_s + (ol_e[ok] - ol_s[ok])
                    np.add.at(cov_diff, flat_s, 1)
                    np.add.at(cov_diff, flat_e + 1, -1)
        reader2.close()
        gc_reads = np.zeros(100, dtype=np.float64)
        valid = gc_bins >= 0
        np.add.at(gc_reads, gc_bins[valid], gc_chunk_w[valid])
        at_dropout, gc_dropout, roi_perc, read_perc = _dropout_metrics(gc_roi, gc_reads)
        cov = np.cumsum(cov_diff)[:-1][:roi_bases]
        avg_depth = bases_usable_roi / roi_bases
        hist, bases_half = _depth_histogram_metrics(cov, roi_bases, avg_depth,
                                                    False, adaptive=False)

    no_base = _genome_n_bases(reader, ref)
    genome = _genome_size_nonspecial(reader)

    output = QCCollection()
    if scan.paired_end:
        add_qc_value(output, "QC:2000019", "trimmed base percentage",
                     100.0 * scan.bases_trimmed / scan.al_total / scan.max_length)
    else:
        add_qc_value(output, "QC:2000019", "trimmed base percentage", "n/a (single end)")
    _common_output(output, scan, "")
    if scan.paired_end:
        add_qc_value(output, "QC:2000022", "properly-paired read percentage",
                     100.0 * scan.al_proper_paired / scan.al_total)
        add_qc_value(output, "QC:2000023", "insert size",
                     scan.insert_size_sum / scan.insert_size_read_count)
        add_qc_value(output, "QC:2000150", "target region read depth (no ol)",
                     scan.bases_usable_no_overlap / (genome - no_base))
    else:
        add_qc_value(output, "QC:2000022", "properly-paired read percentage", "n/a (single end)")
        add_qc_value(output, "QC:2000023", "insert size", "n/a (single end)")
    if scan.al_dup == 0:
        add_qc_value(output, "QC:2000024", "duplicate read percentage",
                     "n/a (duplicates not marked or removed during data analysis)")
    else:
        add_qc_value(output, "QC:2000024", "duplicate read percentage",
                     100.0 * scan.al_dup / scan.al_total)
    add_qc_value(output, "QC:2000050", "bases usable (MB)", scan.bases_usable / 1000000.0)
    add_qc_value(output, "QC:2000025", "target region read depth",
                 scan.bases_usable / (genome - no_base))

    if roi_available:
        _depth_level_values(output, hist, roi_bases, _DEPTH_LEVELS, _DEPTH_ACCESSIONS)
        add_qc_value(output, "QC:2000058", "target region half depth percentage",
                     100.0 * bases_half / roi_bases)
        add_qc_value(output, "QC:2000059", "AT dropout", at_dropout)
        add_qc_value(output, "QC:2000060", "GC dropout", gc_dropout)
        _depth_plot(output, hist)
    if scan.paired_end and scan.insert_hist.sum() > 0:
        _insert_plot(output, scan)
    if roi_available:
        _gc_plot(output, roi_perc, read_perc)
    _yx_output(output, scan, reader)
    reader.close()
    return output


def contamination(build: str, bam_file: str, roi_file: str = "", min_cov: int = 20,
                  min_snps: int = 50, include_not_properly_paired: bool = False) -> QCCollection:
    """SNV allele-frequency deviation (Statistics.cpp:2333-2386)."""
    roi = None
    if roi_file:
        roi = BedFile.from_file(roi_file)
        roi.sort()
    snps = resources.known_variants(build, True, 0.2, 0.8, roi=roi)

    n = len(snps)
    chr_nums = np.array([snps.chr_of(i).num for i in range(n)], dtype=np.int64)
    positions = snps.pos.copy()
    res = pileup_at_positions(bam_file, chr_nums, positions, min_mapq=1,
                              include_not_properly_paired=include_not_properly_paired,
                              min_baseq=13)  # getPileup default (BamReader.h:417)
    depth = res.depth()
    from .pileup import BASE2IDX
    ref_idx = np.array([BASE2IDX.get(snps.refs[i][:1], 0) for i in range(n)], dtype=np.int64)
    alt_idx = np.array([BASE2IDX.get(snps.alts[i].split(b",")[0][:1], 0) for i in range(n)], dtype=np.int64)
    freq = res.frequency(ref_idx, alt_idx)

    ok = (depth >= min_cov) & np.isfinite(freq)
    passed = int(ok.sum())
    hist = Histogram(0, 1, 0.05)
    hist.inc_array(freq[ok])

    off = 0.0
    for i in list(range(1, 6)) + list(range(14, 19)):
        off += hist.bin_value(i, True)
    output = QCCollection()
    value = "n/a" if passed < min_snps else f"{_qt_fixed(off, 2)}"
    add_qc_value(output, "QC:2000051", "SNV allele frequency deviation", value)
    return output


def _qt_fixed(v: float, p: int) -> str:
    from decimal import ROUND_HALF_UP, Decimal
    if v != v:
        return "nan"
    return f"{Decimal(v).quantize(Decimal(1).scaleb(-p), rounding=ROUND_HALF_UP):.{p}f}"


def somatic_custom_depth(bed: BedFile, bam_file: str, ref_file: str,
                         min_mapq: int = 1) -> QCCollection:
    """Somatic subpanel depth metrics (Statistics.cpp:1574-1711)."""
    if not bed.is_merged_and_sorted():
        raise ValueError("Merged and sorted BED file required for depth details statistics!")
    roi = RoiLookup(bed)
    roi_bases = int(roi.flat_off[-1])
    cov_diff = np.zeros(roi_bases + 1, dtype=np.int64)
    bases_usable = 0

    reader = BamReader(bam_file)
    ref_nums = np.array([Chromosome(n).num for n in reader.ref_names], dtype=np.int64)
    for batch in prefetch(reader, depth=2):
        flag = batch.flag
        sel = ((flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY | FLAG_UNMAPPED)) == 0)
        idx = np.flatnonzero(sel & (batch.ref_id >= 0))
        if len(idx) == 0:
            continue
        ends = batch.end_positions()
        starts = batch.pos.astype(np.int64) + 1
        chrs = ref_nums[batch.ref_id[idx]]
        usable = ((flag[idx] & FLAG_DUPLICATE) == 0) & (batch.mapq[idx] >= min_mapq)
        for cn in np.unique(chrs):
            seg = idx[(chrs == cn)]
            useg = usable[chrs == cn]
            qs = starts[seg]
            qe = ends[seg]
            i0, i1 = roi.overlap_range(int(cn), qs, qe)
            on = (i1 > i0) & useg
            u = np.flatnonzero(on)
            if len(u) == 0:
                continue
            ol = roi.overlap_sum(i0[u], i1[u], qs[u], qe[u])
            bases_usable += int(ol.sum())
            cnt = i1[u] - i0[u]
            regions = np.repeat(i0[u], cnt) + (
                np.arange(int(cnt.sum()), dtype=np.int64)
                - np.repeat(np.concatenate(([0], np.cumsum(cnt[:-1]))), cnt))
            rep = np.repeat(np.arange(len(u)), cnt)
            r_start = roi.starts[regions]
            r_end = roi.ends[regions]
            ol_s = np.maximum(r_start, qs[u][rep])
            ol_e = np.minimum(r_end, qe[u][rep])
            flat_s = roi.flat_off[regions] + (ol_s - r_start)
            flat_e = flat_s + (ol_e - ol_s)
            np.add.at(cov_diff, flat_s, 1)
            np.add.at(cov_diff, flat_e + 1, -1)
    reader.close()

    cov = np.cumsum(cov_diff)[:-1][:roi_bases]
    avg_depth = bases_usable / roi_bases
    hist, _half = _depth_histogram_metrics(cov, roi_bases, avg_depth, False, adaptive=True)

    output = QCCollection()
    add_qc_value(output, "QC:2000097", "somatic custom target region read depth", avg_depth)
    accessions = ["QC:2000090", "QC:2000091", "QC:2000092", "QC:2000093",
                  "QC:2000098", "QC:2000094", "QC:2000095", "QC:2000096"]
    for depth, acc in zip(_DEPTH_LEVELS, accessions):
        b0 = hist._index(depth)
        cov_bases = float(hist._bins[b0:].sum())
        add_qc_value(output, acc, f"somatic custom target {depth}x percentage",
                     100.0 * cov_bases / roi_bases)
    return output
