"""Coverage engines of BedCoverage, BedLowCoverage and BedHighCoverage.

Counterpart of ``ngsbits_tpu/qc/coverage.py``, trimmed to those three tools
(BedReadCount does no device work and stays with the JAX package) and to one
route: every chromosome's coverage lives on the device from the first BAM
batch until its per-region results are fetched. No mesh, no host difference
array and no device cumsum of one (X9): C2 makes the dense coverage on the
card, where R1 sums it over regions and R2 finds its threshold runs, so only
one int64 a region (BedCoverage) or three int32 a run (BedLow/HighCoverage)
come back.

Behavioral reference: ngs-bits Statistics::lowOrHighCoverage/avgCoverage
(cppNGS/Statistics.cpp:2534-2804) with WorkerLowOrHighCoverage.cpp and
WorkerAverageCoverage.cpp:

- read filters: duplicate, secondary, supplementary and unmapped records
  skipped, mapq >= min_mapq; avgCoverage optionally skips records that are
  not properly paired with mapq < 20;
- a record covers its alignment's reference span (CIGAR ref-consuming ops;
  deletions and ref-skips count);
- min_baseq > 0: M/=/X bases with quality < min_baseq are left out; D/N
  positions always count;
- low/high output: threshold runs per region, annotations kept, then a
  final merge(true, true, true).

A chromosome's regions are one dense box (``_ChrCoverage``: the box from the
first region's start to the last one's end) or, when they cover a small part
of a large box, the flattened regions (``_ChrCoverageSparse``), by the JAX
package's rule (``_make_acc``). Either is a ``DeviceCoverage`` whose blocks of
genomic positions (the box; the merged regions) are uploaded once. The BAM
pass filters each batch on the host (flags, MAPQ, the chromosome), uploads
the batch's positions, CIGARs and keys, with ``-min_baseq`` its qualities
too, in one copy, and launches C1's record form once per chromosome of the
batch: the card walks the CIGARs, applies ``-min_baseq`` and maps the spans
into the box or the flattened regions. Under a process group
(``parallel/mesh.py``) each rank's share of each batch's kept records goes to
C1, and each accumulator's difference array is summed over the ranks
(``all_reduce``) after the pass, before its C2.
"""

from __future__ import annotations

import time
from decimal import ROUND_HALF_UP, Decimal

import numpy as np

from ..core.chromosome import Chromosome
from ..core.intervals import BedFile, BedLine
from ..io.bam import (BamBatch, BamReader, FLAG_DUPLICATE, FLAG_PROPER_PAIR,
                      FLAG_SECONDARY, FLAG_SUPPLEMENTARY, FLAG_UNMAPPED)
from ..ops.device_reduce import DeviceCoverage, upload_records
from ..parallel import mesh


def _alignment_filter(batch: BamBatch, min_mapq: int, skip_mismapped: bool = False) -> np.ndarray:
    flag = batch.flag
    sel = (flag & (FLAG_DUPLICATE | FLAG_SECONDARY | FLAG_SUPPLEMENTARY | FLAG_UNMAPPED)) == 0
    sel &= batch.mapq >= min_mapq
    if skip_mismapped:
        sel &= ~(((flag & FLAG_PROPER_PAIR) == 0) & (batch.mapq < 20))
    return sel


class _Accumulator:
    """What both routes share: the device engine and the per-region results
    in its coordinates (``_to_acc`` maps 1-based inclusive regions)."""

    dev: DeviceCoverage

    def _to_acc(self, starts: np.ndarray, ends: np.ndarray):
        raise NotImplementedError

    def region_sums(self, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
        """int64 coverage sums of the regions (1-based inclusive)."""
        return self.dev.region_sums(*self._to_acc(starts, ends))

    def runs(self, starts: np.ndarray, ends: np.ndarray, cutoff: int, is_high: bool):
        """(region index, first, last) of each threshold run, ``first`` and
        ``last`` as 0-based offsets into their region."""
        s, e = self._to_acc(starts, ends)
        region, first, last = self.dev.runs(s, e, cutoff, is_high)
        return region, first - s[region], last - s[region]


class _ChrCoverage(_Accumulator):
    """Coverage over one chromosome's ROI bounding box ``lo..hi`` (1-based
    inclusive): spans are clipped to the box."""

    def __init__(self, lo: int, hi: int):
        self.lo = lo
        self.hi = hi
        self.dev = DeviceCoverage(hi - lo + 1, blocks=np.array([[lo - 1], [hi]]))

    def add_spans(self, starts: np.ndarray, ends: np.ndarray):
        """Add alignment spans (1-based inclusive), clipped to [lo, hi]."""
        s = np.maximum(starts, self.lo)
        e = np.minimum(ends, self.hi)
        ok = s <= e
        self.dev.add(s[ok] - self.lo, e[ok] - self.lo + 1)

    def add_positions(self, pos: np.ndarray):
        """Add one at each position (1-based) inside the box."""
        self.dev.add(pos[(pos >= self.lo) & (pos <= self.hi)] - self.lo)

    def _to_acc(self, starts, ends):
        return np.asarray(starts) - self.lo, np.asarray(ends) - self.lo


class _ChrCoverageSparse(_Accumulator):
    """Coverage in flattened-ROI coordinates: memory scales with the ROI's
    bases, not with its bounding box (e.g. a genome-wide panel of small
    regions). ``add_spans`` and ``add_positions`` flatten on the host before
    C1; ``DeviceCoverage.add_records`` flattens on the card."""

    def __init__(self, starts: np.ndarray, ends: np.ndarray):
        # merge the (sorted) ROI intervals into disjoint blocks
        ms, me = [], []
        for s, e in zip(starts, ends):
            if ms and s <= me[-1] + 1:
                me[-1] = max(me[-1], e)
            else:
                ms.append(s)
                me.append(e)
        self.ms = np.asarray(ms, dtype=np.int64)
        self.me = np.asarray(me, dtype=np.int64)
        self.off = np.concatenate(([0], np.cumsum(self.me - self.ms + 1)))
        self.total = int(self.off[-1])
        self.dev = DeviceCoverage(self.total, blocks=np.stack([self.ms - 1, self.me]))

    def add_spans(self, starts: np.ndarray, ends: np.ndarray):
        n = len(self.ms)
        if n == 0 or len(starts) == 0:
            return
        starts = starts.astype(np.int64)
        ends = ends.astype(np.int64)
        # first block whose end >= span start; advance per round until the
        # block start passes the span end (rounds = max blocks per span)
        i = np.searchsorted(self.me, starts, side="left")
        flat_s, flat_e = [], []
        while True:
            ii = np.minimum(i, n - 1)
            act = (i < n) & (self.ms[ii] <= ends) & (starts <= self.me[ii])
            more = (i < n) & (self.ms[ii] <= ends)
            if not more.any():
                break
            j = ii[act]
            flat_s.append(np.maximum(starts[act], self.ms[j]) - self.ms[j] + self.off[j])
            flat_e.append(np.minimum(ends[act], self.me[j]) - self.ms[j] + self.off[j])
            i = i + more
        if flat_s:
            self.dev.add(np.concatenate(flat_s), np.concatenate(flat_e) + 1)

    def add_positions(self, pos: np.ndarray):
        if len(pos) == 0 or len(self.ms) == 0:
            return
        pos = pos.astype(np.int64)
        j = np.searchsorted(self.ms, pos, side="right") - 1
        ok = (j >= 0) & (pos <= self.me[np.maximum(j, 0)])
        jj = j[ok]
        self.dev.add(self.off[jj] + pos[ok] - self.ms[jj])

    def _to_acc(self, starts, ends):
        # every ROI region is contained in exactly one merged block
        starts = np.asarray(starts, dtype=np.int64)
        j = np.searchsorted(self.ms, starts, side="right") - 1
        fs = self.off[j] + starts - self.ms[j]
        return fs, fs + (np.asarray(ends, dtype=np.int64) - starts)


def _roi_by_chr(bed: BedFile):
    """chromosome num -> (Chromosome, list of line indices, lo, hi)"""
    out = {}
    for i, l in enumerate(bed.lines):
        key = l.chr.num
        if key not in out:
            out[key] = [l.chr, [], l.start, l.end]
        ent = out[key]
        ent[1].append(i)
        ent[2] = min(ent[2], l.start)
        ent[3] = max(ent[3], l.end)
    return out


def _make_acc(bed: BedFile, idxs, lo: int, hi: int):
    """Dense accumulator over the bounding box, or sparse (flattened-ROI
    coordinates) when the ROI covers a small fraction of a large span."""
    span = hi - lo + 1
    s = np.array([bed.lines[i].start for i in idxs], dtype=np.int64)
    e = np.array([bed.lines[i].end for i in idxs], dtype=np.int64)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    run_end = np.maximum.accumulate(e)
    bases = int(np.sum(np.maximum(e - np.maximum(s, np.concatenate(([s[0]], run_end[:-1] + 1))) + 1, 0))) if len(s) else 0
    if span > 4_000_000 and span > 8 * max(bases, 1):
        return _ChrCoverageSparse(s, e)
    return _ChrCoverage(lo, hi)


def _line_bounds(bed: BedFile, idxs) -> tuple[np.ndarray, np.ndarray]:
    starts = np.array([bed.lines[i].start for i in idxs], dtype=np.int64)
    ends = np.array([bed.lines[i].end for i in idxs], dtype=np.int64)
    return starts, ends


def check_bam(bam_file: str):
    if str(bam_file).split("?", 1)[0].endswith(".cram"):
        raise ValueError(f"'{bam_file}': the PyTorch port reads BAM only; CRAM input "
                         f"is served by the JAX package (ngsbits_tpu)")


def _compute_chr_coverage(bed: BedFile, bam_file: str, min_mapq: int, min_baseq: int,
                          skip_mismapped: bool = False, threads: int = 4):
    """One pass over the BAM; returns ({chr_num: accumulator}, ROI by
    chromosome). ``threads`` sizes the BGZF inflate pool (at least 4, the
    reader's default). The file is always swept: the port has no index
    route, which gives the same counts as the JAX package's own sweep when
    no index is found."""
    check_bam(bam_file)
    by_chr = _roi_by_chr(bed)
    accs: dict[int, _Accumulator] = {}
    for num, (chr_, idxs, lo, hi) in by_chr.items():
        accs[num] = _make_acc(bed, idxs, lo, hi)

    reader = BamReader(bam_file, n_threads=max(4, threads))
    ref_num = np.array([Chromosome(n).num for n in reader.ref_names], dtype=np.int64)
    want = np.zeros(len(ref_num) + 1, dtype=bool)
    for i, rn in enumerate(ref_num):
        want[i] = rn in accs

    device = next(iter(accs.values())).dev.device if accs else None
    for batch in reader:
        sel = _alignment_filter(batch, min_mapq, skip_mismapped)
        rid = batch.ref_id
        sel &= (rid >= 0) & want[np.clip(rid, 0, len(ref_num) - 1)]
        if not sel.any():
            continue
        # a record's key: its chromosome where it is kept, else -1; each
        # launch takes the range of records that holds its chromosome's
        idx = np.flatnonzero(sel)
        lo, hi = mesh.rows(len(idx))
        if hi - lo < len(idx):  # this rank's share of the kept records
            idx = idx[lo:hi]
            if not len(idx):
                continue
            sel = np.zeros_like(sel)
            sel[idx] = True
        rids = rid[idx]
        quals = (batch.seq_off, batch.qual) if min_baseq > 0 else ()
        rec = upload_records(batch.pos, np.where(sel, rid, -1), batch.cigar_off,
                             batch.cigar, *quals, device=device)
        for r in np.unique(rids):
            at = idx[rids == r]
            accs[int(ref_num[r])].dev.add_records(rec, int(at[0]), int(at[-1]) + 1, int(r),
                                                  min_baseq)
    reader.close()
    for acc in accs.values():
        mesh.sum_ranks_(acc.dev.diff)
    return accs, by_chr


def _stage(stats: dict | None, name: str, t0: float) -> float:
    t = time.perf_counter()
    if stats is not None:
        stats[name] = stats.get(name, 0.0) + t - t0
    return t


def _fetched(stats: dict | None, acc: _Accumulator):
    """Records the bytes that one accumulator's finalize brought back and
    the positions it spans."""
    if stats is not None:
        stats.setdefault("finalizes", []).append((acc.dev.span, acc.dev.fetched))


def low_or_high_coverage(bed: BedFile, bam_file: str, cutoff: int, min_mapq: int,
                         min_baseq: int, threads: int, is_high: bool,
                         stats: dict | None = None) -> BedFile:
    """The runs of each region where the coverage is below ``cutoff`` (at or
    above it with ``is_high``), with the region's annotations, merged.
    ``stats`` (optional) gets the seconds of the BAM pass, the finalize and
    the output, and each finalize's (span, bytes fetched)."""
    t0 = time.perf_counter()
    accs, by_chr = _compute_chr_coverage(bed, bam_file, min_mapq, min_baseq,
                                         threads=threads)
    t0 = _stage(stats, "pass", t0)
    output = BedFile()
    for num, (chr_, idxs, lo, hi) in by_chr.items():
        t0 = time.perf_counter()
        acc = accs.pop(num)
        region, first, last = acc.runs(*_line_bounds(bed, idxs), cutoff, is_high)
        _fetched(stats, acc)
        del acc
        t0 = _stage(stats, "finalize", t0)
        for k, s, e in zip(region.tolist(), first.tolist(), last.tolist()):
            line = bed.lines[idxs[k]]
            output.append(BedLine(line.chr, line.start + s, line.start + e,
                                  list(line.annotations)))
        _stage(stats, "output", t0)
    t0 = time.perf_counter()
    output.merge(True, True, True)
    _stage(stats, "output", t0)
    return output


def avg_coverage(bed: BedFile, bam_file: str, min_mapq: int, threads: int,
                 decimals: int, skip_mismapped: bool = False, stats: dict | None = None):
    """Appends the mean depth to each region's annotations (reference
    semantics: the sum of clipped alignment overlaps / the region's
    length). ``stats`` as for ``low_or_high_coverage``."""
    t0 = time.perf_counter()
    accs, by_chr = _compute_chr_coverage(bed, bam_file, min_mapq, 0,
                                         skip_mismapped=skip_mismapped,
                                         threads=threads)
    t0 = _stage(stats, "pass", t0)
    for num, (chr_, idxs, lo, hi) in by_chr.items():
        t0 = time.perf_counter()
        acc = accs.pop(num)
        totals = acc.region_sums(*_line_bounds(bed, idxs))
        _fetched(stats, acc)
        del acc
        t0 = _stage(stats, "finalize", t0)
        for i, total in zip(idxs, totals.tolist()):
            line = bed.lines[i]
            line.annotations.append(_fmt_fixed(total / line.length(), decimals).encode())
        _stage(stats, "output", t0)


def _fmt_fixed(v: float, decimals: int) -> str:
    if v != v:
        return "nan"
    d = Decimal(v).quantize(Decimal(1).scaleb(-decimals), rounding=ROUND_HALF_UP)
    return f"{d:.{decimals}f}"
