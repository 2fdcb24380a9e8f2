"""Coverage and pileup-count engines on a torch device: C1, C2, R1, R2 and B1;
and the similarity's exact moments, X7.

Counterpart of ``DeviceCoverage`` and ``DeviceBincount`` in
``ngsbits_tpu/ops/device_reduce.py``, and of the host's region sums and
threshold runs in ``ngsbits_tpu/qc/coverage.py``. The JAX package buffers
spans and indices on the host and sorts and searches them on the device in
one finalize, because XLA serialises scatter on the TPU. Here the state lives
on the device from the first batch and each batch is scattered into it at once
by a hand-written kernel (``csrc/coverage.cu``), with integer atomics that are
exact in any order:

- C1 ``coverage_add_into``: +1 at ``diff[start]``, -1 at ``diff[end_excl]``
  into a ``[span + 1]`` int32 difference array (without ends: unit spans at
  the starts), for spans made on the host (the coverage tools'
  accumulators' ``add_spans`` and ``add_positions``);
- C1's read form ``coverage_add_reads_into``: MappingQC's usable on-target
  reads (start, end and the ROI's range of regions each overlaps, 16 bytes a
  read) clipped on the card to every region of their range, into the same
  difference array over the flattened ROI;
- C1's record form ``coverage_add_records_into``: a BAM batch's records
  (``Records``: positions, CIGARs and, for ``-min_baseq``, qualities, all
  uploaded at once by ``upload_records``) walked on the card into the same
  difference array, their spans (or their runs of bases at or above
  ``-min_baseq``, and their D and N ops) mapped into a dense box or a
  panel's merged blocks, for the coverage tools;
- C2 ``coverage_finalize_into``: its prefix sum, binned into the depth
  histogram of ``qc/mapping_stats.py::_depth_histogram_metrics`` (bins of
  ``cov // step``; values above the last bin clamped into it up to
  ``hist_max`` and dropped beyond), and the count of positions at or above
  ``half_depth``; optionally the dense coverage too, or only that;
- R1 ``region_sums_into``: the coverage summed over each region (int64);
- R2 ``threshold_runs``: the runs of positions in each region whose
  coverage is below a cutoff (or at or above it);
- B1 ``bincount_add_into``: ``counts[idx] += 1`` into int32 counters (no
  main path launches it since B1's record form);
- B1's record form ``pileup_add_records_into`` (``csrc/pileup.cu``): a BAM
  batch's records (``Records`` with bases, qualities and MAPQ) walked on the
  card to a set of SNP loci (``DevicePileup``), counting each locus' bases,
  deletions and, when asked, the reads and MAPQ-0 reads over it, for the
  contamination pileup and the pileup callers;
- B1's indel form ``pileup_indels_into`` (``csrc/pileup.cu``): the same
  uploaded records' I and D ops within a window of the loci, each hit
  (record, locus, query offset, CIGAR word) written into a buffer whose
  capacity the host reckons before the launch, its count kept in a scratch
  word the engine zeroes once; the hits and their count come back in one
  non-blocking copy a batch (``IndelHits``), which ``DevicePileup``'s
  caller waits for only after it has launched the next batch, for
  VcfMerge's re-calling;
- B1's region form ``pileup_regions_into`` (``csrc/pileup.cu``): the same
  uploaded records over indel regions of varying length (``DeviceRegions``):
  each region's reads, MAPQ-0 reads and spanning depth as int32 atomics, and
  each I and D op of a spanning record inside it as a hit (record, region,
  query offset, CIGAR index, reference position) for the host to key, for
  the variant-details path (VcfAnnotateFrequency, VariantAnnotateFrequency,
  VariantAnnotateASE, VcfCalculatePRS);
- X7 ``correlation_moments_into`` (``csrc/similarity.cu``): the five exact
  sums sx, sy, sxx, syy and sxy of two vectors of doubled genotypes, for
  ``genotype_moments`` and ``pearson_from_genotypes`` (the JAX package's
  ``_corr_fn`` and the function of that name).

R1 and R2 take regions as int32 ``starts`` and the int64 exclusive prefix of
their lengths (``region_offsets``): region ``r`` is positions
``starts[r] .. starts[r] + offsets[r + 1] - offsets[r] - 1``. The kernels cut
the concatenated regions into equal tiles and find a tile's region by a
binary search in ``offsets``.

Each wrapper follows the port's dispatch rule (``ops/pallas_kernels.py``):
tensors on the CPU take the plain version (``index_add_`` and ``cumsum``
for C1 and C2, the pairs of reads and regions and ``index_add_`` for C1's
read form, the per-base expansion and ``index_add_`` for C1's record form,
``cumsum`` and differences for R1, masks and ``nonzero`` for R2,
``torch.bincount`` for B1, the per-op expansion and ``searchsorted`` join
against the loci for B1's record form and the same expansion and join of
the I and D ops for its indel form and of records against regions for its
region form, five ``torch.sum``s for X7), tensors on a
CUDA device launch the kernel
on the current stream after checking device, dtype, shape and contiguity,
or raise. Each counts its launches in ``launches`` (B1's forms under a
lock: SampleIdentity's and VcfMerge's threads launch them at once). The engines take the
device from ``utils/backend.py`` and use no size threshold.

Uploads are blocking copies from pageable memory: a batch's numpy arrays may
be reused as soon as ``add`` returns, and no host buffer is shared with a
kernel that may still be running.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..utils.backend import device as default_device
from .pallas_kernels import _check, _launched, _lib, _ptr, _route, _stream

MAX_BINS = 4096        # C2 keeps its histogram in shared memory
INT32_LIMIT = 2**31 - 1
CUTOFF_LIMIT = 2**62   # R2's cutoff is clamped to +-this (coverage is int32)


_COUNT_LOCK = threading.Lock()  # launch counts of wrappers that threads share


def _optional_ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


# --------------------------------------------------------------------------
# C1: spans into the difference array
# --------------------------------------------------------------------------

def coverage_add_plain(starts, ends, diff):
    ones = torch.ones(starts.shape[0], dtype=diff.dtype, device=diff.device)
    s = starts.to(torch.int64)
    diff.index_add_(0, s, ones)
    diff.index_add_(0, s + 1 if ends is None else ends.to(torch.int64), -ones)


def coverage_add_into(starts: torch.Tensor, ends: torch.Tensor | None,
                      diff: torch.Tensor) -> None:
    """C1: for each span ``(starts[i], ends[i])`` (int32 ``[n]``, half-open,
    ``0 <= start <= end <= span``) adds +1 at ``diff[start]`` and -1 at
    ``diff[end]`` of the int32 ``[span + 1]`` difference array. Without
    ``ends`` each span is the one position ``starts[i]`` (``< span``)."""
    tensors = (starts, diff) + (() if ends is None else (ends,))
    if _route(*tensors) == "cpu":
        return coverage_add_plain(starts, ends, diff)
    n = starts.shape[0]
    _check("starts", starts, torch.int32, (n,))
    if ends is not None:
        _check("ends", ends, torch.int32, (n,))
    _check("diff", diff, torch.int32, (diff.shape[0],))
    if n == 0:
        return
    rc = _lib().ngs_coverage_add(_ptr(starts), _optional_ptr(ends), n,
                                 diff.shape[0] - 1, _ptr(diff), _stream(diff))
    _launched("coverage_add", rc)
    coverage_add_into.launches += 1


coverage_add_into.launches = 0


# --------------------------------------------------------------------------
# C1's read form: reads clipped to the ROI's regions
# --------------------------------------------------------------------------

def coverage_add_reads_plain(reads, regions, diff):
    qs, qe, i0, i1 = reads.to(torch.int64)
    rs, re, off = regions.to(torch.int64)
    n = rs.shape[0]
    i0 = i0.clamp(0, n)
    count = (i1.clamp(max=n) - i0).clamp(min=0)
    # every (read, region) pair of the reads' ranges
    read_of = torch.repeat_interleave(torch.arange(qs.shape[0], device=diff.device), count)
    first = torch.cumsum(count, 0) - count
    r = i0[read_of] + torch.arange(read_of.shape[0], device=diff.device) - first[read_of]
    lo = torch.maximum(rs[r], qs[read_of])
    hi = torch.minimum(re[r], qe[read_of])
    hit = lo <= hi
    s = (off[r] + lo - rs[r])[hit]
    ones = torch.ones(s.shape[0], dtype=diff.dtype, device=diff.device)
    diff.index_add_(0, s, ones)
    diff.index_add_(0, s + (hi - lo)[hit] + 1, -ones)


def coverage_add_reads_into(reads: torch.Tensor, regions: torch.Tensor,
                            diff: torch.Tensor) -> None:
    """C1's read form, the counterpart of MappingQC's flattening of its
    reads onto the ROI (``ngsbits_tpu/qc/mapping_stats.py:284-305``) and of
    X6 after it: ``reads`` int32 ``[4, k]`` holds each read's 1-based start,
    inclusive end and range ``[i0, i1)`` of regions; ``regions`` int32 ``[3,
    n]`` each region's 1-based inclusive start and end and its offset in the
    flattened ROI (``DeviceCoverage`` makes it). For each read and each
    region of its range, the read clipped to the region adds +1 at the
    clip's flattened start and -1 past its end of the int32 ``[span + 1]``
    difference array; an empty clip adds nothing. ``DeviceCoverage.add_reads``
    checks the reads against the contract (ranges within ``[0, n]``, ``i0 <=
    i1``, ``end >= start - 1``) before the upload."""
    if _route(reads, regions, diff) == "cpu":
        return coverage_add_reads_plain(reads, regions, diff)
    k = reads.shape[1] if reads.dim() == 2 else -1
    n = regions.shape[1] if regions.dim() == 2 else -1
    _check("reads", reads, torch.int32, (4, k))
    _check("regions", regions, torch.int32, (3, n))
    _check("diff", diff, torch.int32, (diff.shape[0],))
    if k == 0:
        return
    rc = _lib().ngs_coverage_add_reads(_ptr(reads), k, _ptr(regions), n, diff.shape[0] - 1,
                                       _ptr(diff), _stream(diff))
    _launched("coverage_add_reads", rc)
    coverage_add_reads_into.launches += 1


coverage_add_reads_into.launches = 0


# --------------------------------------------------------------------------
# C1's record form: a batch's alignment records into the difference array
# --------------------------------------------------------------------------

# BAM's CIGAR ops M I D N S H P = X (0-8): those that consume the reference,
# those that consume the query, and the aligned bases that -min_baseq tests;
# codes 9-15 consume nothing
_CIGAR_REF = (1, 0, 1, 1, 0, 0, 0, 1, 1) + (0,) * 7
_CIGAR_QUERY = (1, 1, 0, 0, 1, 0, 0, 1, 1) + (0,) * 7
_CIGAR_MATCH = (1, 0, 0, 0, 0, 0, 0, 1, 1) + (0,) * 7
_ALIGN = 16  # bytes: where each column starts in the upload


class Records(NamedTuple):
    """One BAM batch's alignment columns on a device, as C1's and B1's
    record forms take them: int32 ``pos [N]`` (0-based leftmost), int32
    ``keep [N]`` (a record's key: its ``ref_id`` where the host's filter
    keeps it, else -1), int64 ``cigar_off [N + 1]`` into the int32
    ``cigar`` words (BAM's ``len << 4 | op``), for ``-min_baseq`` and the
    pileup int64 ``qual_off [N + 1]`` (the batch's ``seq_off``) into the
    uint8 ``qual`` bytes, and for the pileup the uint8 4-bit base codes
    ``seq`` at the same offsets and the uint8 ``mapq [N]`` (None
    without)."""
    pos: torch.Tensor
    keep: torch.Tensor
    cigar_off: torch.Tensor
    cigar: torch.Tensor
    qual_off: torch.Tensor | None = None
    qual: torch.Tensor | None = None
    seq: torch.Tensor | None = None
    mapq: torch.Tensor | None = None


def _check_offsets(name: str, off: np.ndarray, n: int, size: int):
    if len(off) != n + 1 or off[0] < 0 or off[-1] > size or (np.diff(off) < 0).any():
        raise ValueError(f"{name}: {len(off)} offsets into {size} entries are not "
                         f"{n + 1} non-decreasing offsets within them")


def upload_records(pos: np.ndarray, keep: np.ndarray, cigar_off: np.ndarray,
                   cigar: np.ndarray, qual_off: np.ndarray | None = None,
                   qual: np.ndarray | None = None, seq: np.ndarray | None = None,
                   mapq: np.ndarray | None = None,
                   device: torch.device | None = None) -> Records:
    """A batch's columns (``Records``' types; ``cigar`` as BAM's uint32
    words) on ``device`` in one copy: one host buffer with each column at a
    16-byte aligned offset, and views of its copy. The offsets are checked
    on the host first, so the kernel reads only inside its columns. ``seq``
    shares ``qual_off`` with ``qual`` and needs it."""
    n = len(pos)
    _check_offsets("cigar_off", np.asarray(cigar_off), n, len(cigar))
    cols = dict(pos=np.asarray(pos, dtype=np.int32), keep=np.asarray(keep, dtype=np.int32),
                cigar_off=np.asarray(cigar_off, dtype=np.int64),
                cigar=np.asarray(cigar, dtype=np.uint32).view(np.int32))
    if len(cols["keep"]) != n:
        raise ValueError(f"keep: {len(cols['keep'])} keys for {n} records")
    if qual is not None:
        _check_offsets("qual_off", np.asarray(qual_off), n, len(qual))
        cols.update(qual_off=np.asarray(qual_off, dtype=np.int64),
                    qual=np.asarray(qual, dtype=np.uint8))
    if seq is not None:
        if qual is None or len(seq) != len(qual):
            raise ValueError(f"seq: {len(seq)} bases need as many quality bytes at the "
                             f"same offsets")
        cols["seq"] = np.asarray(seq, dtype=np.uint8)
    if mapq is not None:
        if len(mapq) != n:
            raise ValueError(f"mapq: {len(mapq)} values for {n} records")
        cols["mapq"] = np.asarray(mapq, dtype=np.uint8)
    at = np.cumsum([0] + [-(-c.nbytes // _ALIGN) * _ALIGN for c in cols.values()])
    buf = np.empty(int(at[-1]), dtype=np.uint8)
    for c, a in zip(cols.values(), at):
        buf[a:a + c.nbytes] = c.view(np.uint8)
    dev = default_device() if device is None else torch.device(device)
    got = torch.from_numpy(buf).to(dev)
    return Records(**{name: got[a:a + c.nbytes].view(torch.from_numpy(c[:0]).dtype)
                      for (name, c), a in zip(cols.items(), at)})


def _table(values: tuple, op: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64, device=op.device)[op]


def _exclusive_in_segments(v: torch.Tensor, first: torch.Tensor,
                           seg: torch.Tensor) -> torch.Tensor:
    """The sums of ``v`` before each element within its segment (``seg``:
    the segment of each element, ``first``: each segment's first element)."""
    before = torch.cumsum(v, 0) - v
    return before - before[first[seg]]


def _flat_index(blocks: torch.Tensor, span: int, x: torch.Tensor) -> torch.Tensor:
    """The number of accumulator positions before each genomic position
    ``x``: where a run's boundary at ``x`` goes in the difference array
    (``blocks`` as ``coverage_add_records_into`` takes them)."""
    bs, be, off = blocks
    n = bs.shape[0]
    j = torch.searchsorted(be, x, right=True)
    jj = j.clamp(max=n - 1)
    inside = (off[jj] + (x - bs[jj]).clamp(min=0)).clamp(max=span)
    return torch.where(j < n, inside, span)


def _expand_cigars(rec: Records, r: torch.Tensor):
    """The CIGAR ops of records ``r``: (the position in ``r`` of each op's
    record, each record's first op, op codes, lengths), int64."""
    dev = r.device
    c0 = rec.cigar_off[r]
    n_ops = rec.cigar_off[r + 1] - c0
    rec_of = torch.repeat_interleave(torch.arange(r.shape[0], device=dev), n_ops)
    first = torch.cumsum(n_ops, 0) - n_ops
    word = rec.cigar[c0[rec_of] + torch.arange(rec_of.shape[0], device=dev)
                     - first[rec_of]].to(torch.int64) & 0xFFFFFFFF
    return rec_of, first, word & 0xF, word >> 4


def coverage_add_records_plain(rec: Records, r0, r1, ref, min_baseq, blocks, diff):
    dev = diff.device
    span = diff.shape[0] - 1
    r = torch.arange(r0, r1, device=dev)
    r = r[rec.keep[r0:r1] == ref]
    rec_of, first, op, length = _expand_cigars(rec, r)
    ref_len = length * _table(_CIGAR_REF, op)
    pos = rec.pos[r].to(torch.int64)
    if min_baseq <= 0:  # a record's reference span
        starts = pos
        ends = pos + torch.zeros_like(pos).index_add_(0, rec_of, ref_len)
    else:
        ref_at = pos[rec_of] + _exclusive_in_segments(ref_len, first, rec_of)
        q_at = _exclusive_in_segments(length * _table(_CIGAR_QUERY, op), first, rec_of)
        dn = (op == 2) | (op == 3)  # D, N: always covered
        m = (_table(_CIGAR_MATCH, op) == 1) & (length > 0)
        # every base of the M, = and X ops: its position, query offset and record
        m_len = length[m]
        op_of = torch.repeat_interleave(torch.arange(m_len.shape[0], device=dev), m_len)
        within = (torch.arange(op_of.shape[0], device=dev)
                  - (torch.cumsum(m_len, 0) - m_len)[op_of])
        x = ref_at[m][op_of] + within
        qi = q_at[m][op_of] + within
        rb = r[rec_of[m]][op_of]
        q0 = rec.qual_off[rb]
        has = qi < rec.qual_off[rb + 1] - q0  # past the record's bytes: no quality
        q = torch.full_like(qi, 0xFF)
        q[has] = rec.qual[(q0 + qi)[has]].to(torch.int64)
        x = x[q >= min_baseq]
        starts = torch.cat([ref_at[dn], x])
        ends = torch.cat([ref_at[dn] + length[dn], x + 1])
    ones = torch.ones(starts.shape[0], dtype=diff.dtype, device=dev)
    diff.index_add_(0, _flat_index(blocks, span, starts), ones)
    diff.index_add_(0, _flat_index(blocks, span, ends), -ones)


def coverage_add_records_into(rec: Records, r0: int, r1: int, ref: int, min_baseq: int,
                              blocks: torch.Tensor, diff: torch.Tensor) -> None:
    """C1's record form, the counterpart of the host's span making and
    ``-min_baseq`` expansion (``ngsbits_tpu/qc/coverage.py:243-300``,
    ``:376-390``) and of X6 after them: for each record ``r0 <= r < r1``
    whose key ``rec.keep[r]`` is ``ref``, adds into the int32 ``[span +
    1]`` difference array its reference span ``[pos, pos + the lengths of
    its M, D, N, = and X ops)``, or with ``min_baseq > 0`` its D and N ops
    and the runs of its M, = and X bases whose quality is at least
    ``min_baseq`` (unsigned bytes; a base past the record's quality bytes
    has none and counts, as 0xFF does). Positions map into the accumulator's
    ``blocks``, int64 ``[3, n]``: genomic starts and exclusive ends
    (0-based, sorted, disjoint) and each block's offset in the array (a
    dense box is one block); a run adds +1 and -1 at the number of
    accumulator positions before its start and its end, so the coverage
    ``cumsum(diff)[:span]`` counts its positions inside the blocks. Only
    that coverage is the contract, not the difference array."""
    with_qual = min_baseq > 0
    if with_qual and (rec.qual_off is None or rec.qual is None):
        raise ValueError("min_baseq > 0 needs the records' qualities")
    n = rec.pos.shape[0]
    if not 0 <= r0 <= r1 <= n:
        raise ValueError(f"records [{r0}, {r1}) of a batch of {n}")
    tensors = (rec.pos, rec.keep, rec.cigar_off, rec.cigar, blocks, diff) + (
        (rec.qual_off, rec.qual) if with_qual else ())
    if _route(*tensors) == "cpu":
        return coverage_add_records_plain(rec, r0, r1, ref, min_baseq, blocks, diff)
    _check("pos", rec.pos, torch.int32, (n,))
    _check("keep", rec.keep, torch.int32, (n,))
    _check("cigar_off", rec.cigar_off, torch.int64, (n + 1,))
    _check("cigar", rec.cigar, torch.int32, (rec.cigar.shape[0],))
    if with_qual:
        _check("qual_off", rec.qual_off, torch.int64, (n + 1,))
        _check("qual", rec.qual, torch.uint8, (rec.qual.shape[0],))
    n_blocks = blocks.shape[1] if blocks.dim() == 2 else 0
    if n_blocks < 1:
        raise ValueError(f"blocks: shape {tuple(blocks.shape)}, expected (3, n) with n >= 1")
    _check("blocks", blocks, torch.int64, (3, n_blocks))
    _check("diff", diff, torch.int32, (diff.shape[0],))
    if r0 == r1:
        return
    rc = _lib().ngs_coverage_add_records(
        _ptr(rec.pos), _ptr(rec.keep), _ptr(rec.cigar_off), _ptr(rec.cigar),
        _optional_ptr(rec.qual_off if with_qual else None),
        _optional_ptr(rec.qual if with_qual else None), r0, r1, int(ref),
        min(int(min_baseq), 256), _ptr(blocks), n_blocks, diff.shape[0] - 1, _ptr(diff),
        _stream(diff))
    _launched("coverage_add_records", rc)
    coverage_add_records_into.launches += 1


coverage_add_records_into.launches = 0


# --------------------------------------------------------------------------
# C2: prefix sum, depth histogram, half-depth count
# --------------------------------------------------------------------------

def coverage_finalize_plain(diff, step, hist_max, half_depth, hist, half,
                            cov=None):
    span = diff.shape[0] - 1
    c = torch.cumsum(diff[:span].to(torch.int64), 0)
    if cov is not None:
        cov.copy_(c.to(cov.dtype))
    if hist is None:
        return
    d = torch.div(c, step, rounding_mode="floor")
    bins = hist.shape[0]
    counts = torch.bincount(d, minlength=bins)
    hist.copy_(counts[:bins])
    if counts.shape[0] > bins:
        hist[bins - 1] += ((d >= bins) & (c <= hist_max)).sum()
    half.fill_(int((c >= half_depth).sum()))


def coverage_finalize_into(diff: torch.Tensor, step: int, hist_max: int,
                           half_depth: int, hist: torch.Tensor | None,
                           half: torch.Tensor | None,
                           cov: torch.Tensor | None = None) -> None:
    """C2, the counterpart of the prefix sum at ``mapping_stats.py:636-641``
    and of ``_depth_histogram_metrics``: from the int32 ``[span + 1]``
    difference array, the coverage ``cov[p] = diff[0] + ... + diff[p]`` for
    ``p < span``, binned into ``hist [bins]`` (int64, written in full) by
    ``cov // step``, values past the last bin clamped into it while
    ``cov <= hist_max`` and dropped beyond; ``half [1]`` (int64) gets the
    count of positions with ``cov >= half_depth``; ``cov [span]`` (int32),
    when given, the dense coverage. With ``hist`` and ``half`` None only
    the dense coverage is made (the histogram parameters are not read)."""
    if (hist is None) != (half is None):
        raise ValueError("hist and half are given together or not at all")
    if hist is None and cov is None:
        raise ValueError("nothing to compute: no histogram and no dense coverage")
    step, hist_max, half_depth = int(step), int(hist_max), int(half_depth)
    if hist is not None and step < 1:
        raise ValueError(f"step must be at least 1, got {step}")
    tensors = (diff,) + tuple(t for t in (hist, half, cov) if t is not None)
    if _route(*tensors) == "cpu":
        return coverage_finalize_plain(diff, step, hist_max, half_depth, hist,
                                       half, cov)
    span, bins = diff.shape[0] - 1, 0 if hist is None else hist.shape[0]
    if hist is not None and not 1 <= bins <= MAX_BINS:
        raise ValueError(f"hist: {bins} bins, the kernel takes 1 to {MAX_BINS}")
    _check("diff", diff, torch.int32, (span + 1,), align=16)
    if hist is not None:
        _check("hist", hist, torch.int64, (bins,))
        _check("half", half, torch.int64, (1,))
    if cov is not None:
        _check("cov", cov, torch.int32, (span,))
    if span == 0:
        if hist is not None:
            hist.zero_()
            half.zero_()
        return
    lib = _lib()
    # the tiles' status words and the tile counter, cleared by the launcher
    scratch = torch.empty(lib.ngs_coverage_scratch(span), dtype=torch.int64,
                          device=diff.device)
    rc = lib.ngs_coverage_finalize(
        _ptr(diff), span, max(step, 1), hist_max, bins, half_depth, _ptr(scratch),
        _optional_ptr(hist), _optional_ptr(half), _optional_ptr(cov), _stream(diff))
    _launched("coverage_finalize", rc)
    coverage_finalize_into.launches += 1


coverage_finalize_into.launches = 0


# --------------------------------------------------------------------------
# R1 and R2: per-region results from the dense coverage
# --------------------------------------------------------------------------

def region_offsets(starts: np.ndarray, ends: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(int32 starts, int64 ``[R + 1]`` exclusive prefix of the lengths) of
    regions given as inclusive bounds, the form R1 and R2 take."""
    starts = np.asarray(starts, dtype=np.int64)
    lengths = np.asarray(ends, dtype=np.int64) - starts + 1
    if len(lengths) and lengths.min() < 1:
        raise ValueError("a region ends before it starts")
    offsets = np.zeros(len(starts) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return starts.astype(np.int32), offsets


def _check_regions(cov, starts, offsets) -> int:
    n = starts.shape[0]
    _check("cov", cov, torch.int32, (cov.shape[0],), align=16)
    _check("starts", starts, torch.int32, (n,))
    _check("offsets", offsets, torch.int64, (n + 1,))
    return n


def _region_ends(starts, offsets):
    return starts.to(torch.int64) + (offsets[1:] - offsets[:-1]) - 1


def region_sums_plain(cov, starts, offsets, out):
    ps = torch.zeros(cov.shape[0] + 1, dtype=torch.int64, device=cov.device)
    torch.cumsum(cov.to(torch.int64), 0, out=ps[1:])
    out.copy_(ps[_region_ends(starts, offsets) + 1] - ps[starts.to(torch.int64)])


def region_sums_into(cov: torch.Tensor, starts: torch.Tensor,
                     offsets: torch.Tensor, out: torch.Tensor) -> None:
    """R1, the counterpart of ``_ChrCoverage.region_sum``
    (``ngsbits_tpu/qc/coverage.py:131-134``, ``:236-240``): ``out[r]``
    (int64 ``[R]``) is the sum of the int32 coverage ``cov`` over region
    ``r``, regions as ``region_offsets`` gives them and within
    ``[0, len(cov))``. Regions may overlap and repeat."""
    if _route(cov, starts, offsets, out) == "cpu":
        return region_sums_plain(cov, starts, offsets, out)
    n = _check_regions(cov, starts, offsets)
    _check("out", out, torch.int64, (n,))
    if n == 0:
        return
    rc = _lib().ngs_region_sums(_ptr(cov), _ptr(starts), _ptr(offsets), n,
                                _ptr(out), _stream(cov))
    _launched("region_sums", rc)
    region_sums_into.launches += 1


region_sums_into.launches = 0


def _clamp_cutoff(cutoff: int) -> int:
    """Any integer cutoff, within +-2^62: the same tests of int32 coverage."""
    return max(-CUTOFF_LIMIT, min(int(cutoff), CUTOFF_LIMIT))


def _hit(values: torch.Tensor, cutoff: int, is_high: bool) -> torch.Tensor:
    cutoff = _clamp_cutoff(cutoff)
    return values >= cutoff if is_high else values < cutoff


def _too_many_positions(total: int, span: int):
    raise ValueError(f"regions of {total} positions over a coverage of {span}: "
                     f"R2 takes disjoint regions")


def threshold_runs_plain(cov, starts, offsets, cutoff, is_high):
    dev = cov.device
    lengths = offsets[1:] - offsets[:-1]
    total = int(offsets[-1])
    if total > cov.shape[0]:
        _too_many_positions(total, cov.shape[0])
    # the coverage position of each region position, and its mask
    pos = torch.repeat_interleave(starts.to(torch.int64) - offsets[:-1], lengths)
    pos += torch.arange(total, dtype=torch.int64, device=dev)
    hit = _hit(cov[pos].to(torch.int64), cutoff, is_high)
    # a run starts where the position before is not hit or in another region
    same = torch.ones(total, dtype=torch.bool, device=dev)
    same[offsets[:-1][lengths > 0]] = False
    before = torch.zeros_like(hit)
    before[1:] = hit[:-1] & same[1:]
    begins = torch.nonzero(hit & ~before).flatten()
    after = torch.zeros_like(hit)
    after[:-1] = hit[1:] & same[1:]
    ends = torch.nonzero(hit & ~after).flatten()
    region = torch.searchsorted(offsets[1:], begins, right=True)
    return torch.stack([region, pos[begins], pos[ends]]).to(torch.int32)


RUNS_COUNT_BYTES = 16  # R2's first fetch: the totals of run starts and ends


def runs_scratch(cov: torch.Tensor) -> torch.Tensor:
    """The int64 scratch of R2's passes for regions over ``cov``: the hit
    mask (a bit a region position), the blocks' counts of run starts and of
    run ends (scanned in place), then the two totals."""
    return torch.empty(_lib().ngs_runs_scratch(cov.shape[0]), dtype=torch.int64,
                       device=cov.device)


def runs_count(cov, starts, offsets, cutoff, is_high, scratch):
    """R2's first pass (two launches): the hit mask, run starts and ends
    counted per block, then scanned; the totals land in ``scratch[-2:]``
    (-1 when the regions hold more positions than ``cov``)."""
    rc = _lib().ngs_runs_count(_ptr(cov), cov.shape[0], _ptr(starts), _ptr(offsets),
                               starts.shape[0], cutoff, int(is_high), _ptr(scratch),
                               _stream(cov))
    _launched("threshold_runs (count)", rc)


def runs_write(cov, starts, offsets, cutoff, is_high, scratch, out):
    """R2's second pass, from the mask and ``offsets`` (the coverage is not
    read): each block writes its runs at its scanned offsets into
    ``out [3, n]``."""
    rc = _lib().ngs_runs_write(_ptr(cov), cov.shape[0], _ptr(starts), _ptr(offsets),
                               starts.shape[0], cutoff, int(is_high), _ptr(scratch),
                               out.shape[1], _ptr(out), _stream(cov))
    _launched("threshold_runs (write)", rc)


def threshold_runs(cov: torch.Tensor, starts: torch.Tensor, offsets: torch.Tensor,
                   cutoff: int, is_high: bool) -> torch.Tensor:
    """R2, the counterpart of the runs loop of ``low_or_high_coverage``
    (``ngsbits_tpu/qc/coverage.py:404-419``): the maximal runs of positions
    of each region whose coverage is ``< cutoff`` (``>= cutoff`` with
    ``is_high``), as int32 ``[3, n]`` rows (region index, first position,
    last position) in region order, then position order. Regions as
    ``region_offsets`` gives them, disjoint and within ``[0, len(cov))``; a
    run never crosses from one region into the next. On the card: a pass
    that reads the coverage once into a hit mask and counts run starts and
    ends per block, a scan of the counts, one fetch of the totals
    (``RUNS_COUNT_BYTES``), and a pass that writes the runs from the
    mask."""
    cutoff = _clamp_cutoff(cutoff)
    if _route(cov, starts, offsets) == "cpu":
        return threshold_runs_plain(cov, starts, offsets, cutoff, is_high)
    n = _check_regions(cov, starts, offsets)
    if n == 0 or cov.shape[0] == 0:
        return torch.zeros(3, 0, dtype=torch.int32, device=cov.device)
    scratch = runs_scratch(cov)
    runs_count(cov, starts, offsets, cutoff, is_high, scratch)
    n_begin, n_end = scratch[-2:].tolist()
    if n_begin < 0:
        _too_many_positions(int(offsets[-1]), cov.shape[0])
    if n_begin != n_end:
        raise RuntimeError(f"threshold_runs: {n_begin} run starts, {n_end} run ends")
    out = torch.empty(3, n_begin, dtype=torch.int32, device=cov.device)
    if n_begin:
        runs_write(cov, starts, offsets, cutoff, is_high, scratch, out)
    threshold_runs.launches += 1
    return out


threshold_runs.launches = 0


# --------------------------------------------------------------------------
# B1: counters
# --------------------------------------------------------------------------

def bincount_add_plain(idx, counts):
    size = counts.shape[0]
    got = torch.bincount(idx.to(torch.int64), minlength=size)[:size]
    counts += got.to(counts.dtype)


def bincount_add_into(idx: torch.Tensor, counts: torch.Tensor) -> None:
    """B1: ``counts[idx[i]] += 1`` for int32 ``idx [n]`` with
    ``0 <= idx < size``, into int32 ``counts [size]``."""
    if _route(idx, counts) == "cpu":
        return bincount_add_plain(idx, counts)
    n = idx.shape[0]
    _check("idx", idx, torch.int32, (n,))
    _check("counts", counts, torch.int32, (counts.shape[0],))
    if n == 0:
        return
    rc = _lib().ngs_bincount_add(_ptr(idx), n, counts.shape[0], _ptr(counts),
                                 _stream(counts))
    _launched("bincount_add", rc)
    bincount_add_into.launches += 1


bincount_add_into.launches = 0


# --------------------------------------------------------------------------
# B1's record form: a batch's alignment records walked to the SNP loci
# --------------------------------------------------------------------------

# a base's byte (4-bit codes A=1, C=2, G=4, T=8) to the counters' 0-3; others -1
_BASE_INDEX = (-1, 0, 1, -1, 2, -1, -1, -1, 3) + (-1,) * 247
DELETION = 4  # ``pileup_hits``' base of a deletion


def _locus_keys(loci: torch.Tensor) -> torch.Tensor:
    """int64 keys of the loci that sort as they do and keep each
    chromosome's loci apart: the number of the non-decreasing run of
    positions a locus lies in, then its position (a chromosome's loci lie in
    one run)."""
    p = loci.to(torch.int64)
    run = torch.zeros_like(p)
    run[1:] = torch.cumsum((p[1:] < p[:-1]).to(torch.int64), 0)
    return (run << 33) + p + (1 << 31)


def _search(keys: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, x: torch.Tensor,
            right: bool) -> torch.Tensor:
    """For each (range ``[lo, hi)`` of the loci, 1-based position ``x``) the
    first locus of the range after ``x`` (``right``) or at or after it,
    clamped into ``[lo, hi]``."""
    run = keys[lo.clamp(max=keys.shape[0] - 1)] >> 33
    q = (run << 33) + x.clamp(-(1 << 31), (1 << 32) - 1) + (1 << 31)
    return torch.searchsorted(keys, q, right=right).clamp(min=lo).minimum(hi)


def _pairs(a: torch.Tensor, b: torch.Tensor):
    """Every (i, j) with ``a[i] <= j < b[i]``, in order of i then j."""
    count = (b - a).clamp(min=0)
    i = torch.repeat_interleave(torch.arange(a.shape[0], device=a.device), count)
    j = a[i] + torch.arange(i.shape[0], device=a.device) - (torch.cumsum(count, 0) - count)[i]
    return i, j


def _pileup_records(rec: Records, loci: torch.Tensor, table: torch.Tensor):
    """The records with a key and loci on their chromosome: (records, the
    loci's keys, each record's range ``[lo, hi)`` of its chromosome's loci,
    the first locus at or after its start and the end of those up to its
    end, and its ops: the position in the records of each op's record, its
    code, length, 1-based reference start and offset in the query)."""
    dev = loci.device
    n_refs = table.shape[1]
    key = rec.keep.to(torch.int64)
    r = torch.nonzero((key >= 0) & (key < n_refs)).flatten()
    lo, hi = table[0][key[r]].to(torch.int64), table[1][key[r]].to(torch.int64)
    some = lo < hi
    r, lo, hi = r[some], lo[some], hi[some]
    keys = _locus_keys(loci) if loci.shape[0] else torch.zeros(1, dtype=torch.int64, device=dev)
    rec_of, first_op, op, length = _expand_cigars(rec, r)
    ref_len = length * _table(_CIGAR_REF, op)
    start = rec.pos[r].to(torch.int64) + 1
    ref_at = start[rec_of] + _exclusive_in_segments(ref_len, first_op, rec_of)
    q_at = _exclusive_in_segments(length * _table(_CIGAR_QUERY, op), first_op, rec_of)
    end = start - 1 + torch.zeros_like(start).index_add_(0, rec_of, ref_len)
    a = _search(keys, lo, hi, start, right=False)
    b = _search(keys, lo, hi, end, right=True)
    return r, keys, lo, hi, a, b, (rec_of, op, length, ref_at, q_at)


def pileup_hits(rec: Records, loci: torch.Tensor, table: torch.Tensor, min_mapq: int,
                min_baseq: int):
    """The counts of B1's record form one by one: (record, locus, base,
    quality), int64, in order of record, op and locus: each base of an M, =
    or X op at a locus whose code is A, C, G or T (``base`` 0-3) and whose
    quality byte is at least ``min_baseq``, and each D op over a locus
    (``base`` ``DELETION``, quality -1), of the records with a key and a
    MAPQ of at least ``min_mapq``. A locus past its record's SEQ has no
    base. The pileup's fragment route (``count_fragments``) takes its bases
    from here, on the host."""
    r, keys, lo, hi, a, b, (rec_of, op, length, ref_at, q_at) = _pileup_records(rec, loci, table)
    passes = rec.mapq[r].to(torch.int64) >= min(max(int(min_mapq), 0), 256)
    is_match = _table(_CIGAR_MATCH, op) == 1
    o = torch.nonzero(((passes & (b > a))[rec_of]) & (is_match | (op == 2))).flatten()
    ro = rec_of[o]
    k, j = _pairs(_search(keys, lo[ro], hi[ro], ref_at[o], right=False),
                  _search(keys, lo[ro], hi[ro], ref_at[o] + length[o] - 1, right=True))
    o, ro = o[k], ro[k]   # each (op, locus) pair's op and record
    rec_k = r[ro]
    qi = q_at[o] + loci[j].to(torch.int64) - ref_at[o]
    s0 = rec.qual_off[rec_k]
    has = is_match[o] & (qi < rec.qual_off[rec_k + 1] - s0)  # past the SEQ: no base
    base = torch.full_like(qi, -1)
    qual = torch.full_like(qi, -1)
    at = (s0 + qi)[has]
    base[has] = _table(_BASE_INDEX, rec.seq[at].to(torch.int64))
    qual[has] = rec.qual[at].to(torch.int64)
    counted = has & (base >= 0) & (qual >= min(max(int(min_baseq), 0), 256))
    base[~is_match[o]] = DELETION
    keep = counted | ~is_match[o]
    return rec_k[keep], j[keep], base[keep], qual[keep]


def pileup_add_records_plain(rec, loci, table, min_mapq, min_baseq, counts, dels,
                             mapped=None, mapq0=None):
    n = loci.shape[0]
    if n == 0:
        return
    if mapped is not None:
        r, _, _, _, a, b, _ = _pileup_records(rec, loci, table)
        for out, mask in ((mapped, b > a), (mapq0, (b > a) & (rec.mapq[r] == 0))):
            ev = torch.zeros(n + 1, dtype=torch.int64, device=loci.device)
            ev.index_add_(0, a[mask], torch.ones_like(a[mask]))
            ev.index_add_(0, b[mask], -torch.ones_like(b[mask]))
            out += torch.cumsum(ev[:n], 0).to(out.dtype)
    _, j, base, _ = pileup_hits(rec, loci, table, min_mapq, min_baseq)
    is_base = base < DELETION
    ones = torch.ones_like(j, dtype=counts.dtype)
    counts.view(-1).index_add_(0, (j * 4 + base)[is_base], ones[is_base])
    dels.index_add_(0, j[~is_base], ones[~is_base])


def pileup_add_records_into(rec: Records, loci: torch.Tensor, table: torch.Tensor,
                            min_mapq: int, min_baseq: int, counts: torch.Tensor,
                            dels: torch.Tensor, mapped: torch.Tensor | None = None,
                            mapq0: torch.Tensor | None = None) -> None:
    """B1's record form, the counterpart of the contamination pileup's host
    join (``ngsbits_tpu/qc/pileup.py:126-251``: per-op expansion, the
    searchsorted join against the loci, base and quality gather, deletion
    and MAPQ-0 counts) and of ``DeviceBincount`` after it: for each record
    of the batch ``rec`` (positions, keys, MAPQ, CIGARs, bases and
    qualities) whose key ``k`` (its ``ref_id``, or -1 where the host's
    filter drops it) has loci, those in ``loci[table[0, k]:table[1, k]]``
    (int32 1-based positions, sorted within each such range; ``table`` int32
    ``[2, n_refs]``) that lie in its reference span ``[pos + 1, pos + the
    lengths of its M, D, N, = and X ops]``: ``mapped`` and ``mapq0`` (when
    given, int32 ``[n]``) count it at each of them, ``mapq0`` only at MAPQ 0;
    if its MAPQ is at least ``min_mapq``, ``counts`` (int32 ``[n, 4]``)
    counts the A, C, G or T base at each locus under an M, = or X op whose
    quality byte is at least ``min_baseq`` (0xFF counts; a locus past the
    record's SEQ has no base) and ``dels`` (int32 ``[n]``) each locus under a
    D op. N ops and clips count nothing; duplicate loci each count."""
    if (mapped is None) != (mapq0 is None):
        raise ValueError("mapped and mapq0 are given together or not at all")
    if rec.qual is None or rec.seq is None or rec.mapq is None:
        raise ValueError("the pileup needs the records' bases, qualities and MAPQ")
    tracked = () if mapped is None else (mapped, mapq0)
    tensors = (rec.pos, rec.keep, rec.mapq, rec.cigar_off, rec.cigar, rec.qual_off, rec.seq,
               rec.qual, loci, table, counts, dels) + tracked
    if _route(*tensors) == "cpu":
        return pileup_add_records_plain(rec, loci, table, min_mapq, min_baseq, counts, dels,
                                        mapped, mapq0)
    n_rec, n = rec.pos.shape[0], loci.shape[0]
    n_refs = table.shape[1] if table.dim() == 2 else -1
    _check("pos", rec.pos, torch.int32, (n_rec,))
    _check("keep", rec.keep, torch.int32, (n_rec,))
    _check("mapq", rec.mapq, torch.uint8, (n_rec,))
    _check("cigar_off", rec.cigar_off, torch.int64, (n_rec + 1,))
    _check("cigar", rec.cigar, torch.int32, (rec.cigar.shape[0],))
    _check("qual_off", rec.qual_off, torch.int64, (n_rec + 1,))
    _check("qual", rec.qual, torch.uint8, (rec.qual.shape[0],))
    _check("seq", rec.seq, torch.uint8, (rec.qual.shape[0],))
    _check("loci", loci, torch.int32, (n,))
    _check("table", table, torch.int32, (2, n_refs))
    _check("counts", counts, torch.int32, (n, 4))
    _check("dels", dels, torch.int32, (n,))
    for name, t in zip(("mapped", "mapq0"), tracked):
        _check(name, t, torch.int32, (n,))
    if n_rec == 0 or n == 0 or n_refs == 0:
        return
    rc = _lib().ngs_pileup_add_records(
        _ptr(rec.pos), _ptr(rec.keep), _ptr(rec.mapq), _ptr(rec.cigar_off), _ptr(rec.cigar),
        _ptr(rec.qual_off), _ptr(rec.seq), _ptr(rec.qual), n_rec, _ptr(loci), n, _ptr(table),
        n_refs, min(max(int(min_mapq), 0), 256), min(max(int(min_baseq), 0), 256),
        _ptr(counts), _ptr(dels), _optional_ptr(mapped), _optional_ptr(mapq0), _stream(counts))
    _launched("pileup_add_records", rc)
    with _COUNT_LOCK:
        pileup_add_records_into.launches += 1


pileup_add_records_into.launches = 0


# --------------------------------------------------------------------------
# B1's indel form: the I and D ops of a batch's records near the loci
# --------------------------------------------------------------------------

INDEL_HIT = 4  # int64 columns of an indel hit: record, locus, query offset, CIGAR word
INDEL_STAGED_LOCI = 4096  # csrc/pileup.cu's kStagedLoci: past it the loci stay in global memory


def _indel_window(window: int) -> int:
    if int(window) < 0 or int(window) > INT32_LIMIT:
        raise ValueError(f"indel window {window}: it must lie in [0, 2^31)")
    return int(window)


def pileup_indels_plain(rec: Records, loci: torch.Tensor, table: torch.Tensor,
                        min_mapq: int, window: int,
                        loci_range: tuple[int, int] | None = None) -> torch.Tensor:
    """The hits of B1's indel form one by one, int64 ``[k, 4]``: (record,
    locus, the op's offset in the query, its CIGAR word), in order of
    record, op and locus. A hit is each I or D op of a record with a key
    and a MAPQ of at least ``min_mapq`` at each locus of its chromosome
    within ``window`` of the op's reference position ``g`` (``pos + 1`` plus
    the reference its record consumed before the op): ``|g - locus| <=
    window``. An I op whose bases lie past its record's SEQ has none and
    makes no hit; a D op needs no bases. With ``loci_range`` ``(lo, hi)``
    only the sorted loci ``[lo, hi)`` count (each chromosome's range cut to
    it)."""
    window = _indel_window(window)
    if loci.shape[0] == 0:
        return torch.zeros((0, INDEL_HIT), dtype=torch.int64, device=loci.device)
    if loci_range is not None:
        table = table.clamp(*loci_range)
    r, keys, lo, hi, _, _, (rec_of, op, length, ref_at, q_at) = _pileup_records(rec, loci, table)
    passes = rec.mapq[r].to(torch.int64) >= min(max(int(min_mapq), 0), 256)
    l_seq = (rec.qual_off[r + 1] - rec.qual_off[r])[rec_of]
    o = torch.nonzero(passes[rec_of] & ((op == 2) | ((op == 1) & (q_at + length <= l_seq)))
                      ).flatten()
    ro = rec_of[o]
    k, j = _pairs(_search(keys, lo[ro], hi[ro], ref_at[o] - window, right=False),
                  _search(keys, lo[ro], hi[ro], ref_at[o] + window, right=True))
    o, ro = o[k], ro[k]   # each (op, locus) pair's op and record
    return torch.stack([r[ro], j, q_at[o], (length[o] << 4) | op[o]], dim=1)


def indel_out(capacity: int, device: torch.device) -> torch.Tensor:
    """The output ``pileup_indels_into`` takes for ``capacity`` hits: int64
    ``[1 + 4 * capacity]``, the count of hits, then the hits."""
    return torch.empty(1 + INDEL_HIT * int(capacity), dtype=torch.int64, device=device)


def indel_scratch(device: torch.device) -> torch.Tensor:
    """The scratch ``pileup_indels_into`` keeps its count in on the card:
    int64 ``[2]``, zero; each launch leaves it zero. One launch at a time
    on a scratch: an engine keeps its own."""
    return torch.zeros(2, dtype=torch.int64, device=device)


class _Slot:
    """A ring slot: a pinned int64 buffer (and a numpy view of it), the CUDA
    event recorded after each copy into it, and their raw handles for the
    kernel library."""
    __slots__ = ("buffer", "view", "ptr", "event", "handle")

    def __init__(self):
        self.buffer = self.view = self.ptr = None
        self.event = torch.cuda.Event()
        self.event.record()  # made now, so its handle exists
        self.handle = self.event.cuda_event

    def fit(self, words: int):
        if self.buffer is None or self.buffer.shape[0] < words:
            size = max(int(words), 0 if self.buffer is None else 2 * self.buffer.shape[0])
            self.buffer = torch.empty(size, dtype=torch.int64, pin_memory=True)
            self.view, self.ptr = self.buffer.numpy(), self.buffer.data_ptr()


class HitRing:
    """Pinned host buffers that the hits of B1's indel and region forms are
    copied into, each with the CUDA event recorded after its copy: a launch
    takes a free slot (made, or grown to twice its size or more, only where
    none free is large enough); ``IndelHits.hits()`` copies the hits out of
    their slot and gives it back, so no slot is overwritten before its hits
    are read. A caller that holds several launches unread holds as many
    slots; the sweep, which reads a launch's hits after launching the next,
    holds two. An engine keeps one ring, so a call allocates no pinned
    memory once the ring is warm. One thread at a time on a ring."""

    def __init__(self):
        self.free: list[_Slot] = []

    def take(self, words: int) -> _Slot:
        slot = self.free.pop() if self.free else _Slot()
        slot.fit(words)
        return slot

    def give(self, slot: _Slot):
        self.free.append(slot)


class IndelHits:
    """One launch's hits of B1's indel form (or its region form) on their
    way to the host: the count and hits as int64 words (numpy; on the card a
    ring slot's pinned buffer, filled by a copy queued behind the launch,
    and the CUDA event recorded after it; on the CPU route a copy of the
    output, no event). ``hits()`` waits for the event, the only wait, then
    returns the hits, int64 ``[count, width]`` (on the card copied out of
    the slot, which goes back to its ring), or raises past the capacity; a
    second call returns the same."""

    def __init__(self, got: np.ndarray, capacity: int, event=None, width: int = INDEL_HIT,
                 name: str = "pileup_indels", ring: HitRing | None = None,
                 slot: _Slot | None = None):
        self.got, self.capacity, self.event = got, capacity, event
        self.width, self.name = width, name
        self.ring, self.slot = ring, slot
        self.count, self._hits = None, None

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
            self.event = None

    def hits(self) -> torch.Tensor:
        if self.count is None:
            self.wait()
            self.count = count = int(self.got[0])
            if count <= self.capacity:
                h = self.got[1:1 + self.width * count].reshape(-1, self.width)
                self._hits = torch.from_numpy(h if self.ring is None else h.copy())
            if self.ring is not None:  # the hits are out of the slot: it takes another copy
                self.ring.give(self.slot)
            self.got = self.ring = self.slot = None
        if self._hits is None:
            raise RuntimeError(f"{self.name}: {self.count} hits past the capacity of "
                               f"{self.capacity} reckoned before the launch")
        return self._hits


def _hits_to_host(out: torch.Tensor, capacity: int, width: int, name: str,
                  ring: HitRing | None) -> IndelHits:
    """The hits of a launch on the card on their way to the host: one
    non-blocking copy of ``out`` (count and hits) into a slot of ``ring`` (a
    ring of its own without one) and one event recorded after it, both
    queued by the kernel library (``ngs_copy_hits``)."""
    ring = HitRing() if ring is None else ring
    words = out.shape[0]
    slot = ring.take(words)
    rc = _lib().ngs_copy_hits(_ptr(out), slot.ptr, words, slot.handle, _stream(out))
    if rc != 0:
        raise RuntimeError(f"{name}: the copy of its hits failed with CUDA error {rc}")
    return IndelHits(slot.view[:words], capacity, slot.event, width=width, name=name, ring=ring,
                     slot=slot)


def _grown(buf: torch.Tensor | None, words: int, device: torch.device) -> torch.Tensor:
    """An engine's device output for ``words`` int64 words: ``buf``, or a new
    buffer of twice its size or more where it is too small (the caller takes
    its first ``words``)."""
    if buf is None or buf.shape[0] < words:
        size = max(words, 0 if buf is None else 2 * buf.shape[0])
        buf = torch.empty(size, dtype=torch.int64, device=device)
    return buf


def _indel_args(rec: Records, loci: torch.Tensor, table: torch.Tensor,
                out: torch.Tensor) -> tuple[int, int, int, int]:
    """Checks the indel form's arguments: (records, loci, references,
    capacity)."""
    n_rec, n = rec.pos.shape[0], loci.shape[0]
    n_refs = table.shape[1] if table.dim() == 2 else -1
    if out.dim() != 1 or out.shape[0] < 1 or (out.shape[0] - 1) % INDEL_HIT:
        raise ValueError(f"out: shape {tuple(out.shape)}, expected [1 + 4 * capacity]")
    _check("pos", rec.pos, torch.int32, (n_rec,))
    _check("keep", rec.keep, torch.int32, (n_rec,))
    _check("mapq", rec.mapq, torch.uint8, (n_rec,))
    _check("cigar_off", rec.cigar_off, torch.int64, (n_rec + 1,))
    _check("cigar", rec.cigar, torch.int32, (rec.cigar.shape[0],))
    _check("qual_off", rec.qual_off, torch.int64, (n_rec + 1,))
    _check("loci", loci, torch.int32, (n,))
    _check("table", table, torch.int32, (2, n_refs))
    _check("out", out, torch.int64, (out.shape[0],))
    return n_rec, n, n_refs, (out.shape[0] - 1) // INDEL_HIT


def _loci_range(loci_range: tuple[int, int] | None, n: int) -> tuple[int, int]:
    lo, hi = (0, n) if loci_range is None else (int(loci_range[0]), int(loci_range[1]))
    if not 0 <= lo <= hi <= n:
        raise ValueError(f"loci range [{lo}, {hi}): it must lie within [0, {n}]")
    return lo, hi


def _pileup_indels_launch(rec: Records, loci: torch.Tensor, table: torch.Tensor,
                          min_mapq: int, window: int, out: torch.Tensor,
                          loci_range: tuple[int, int], scratch: torch.Tensor) -> None:
    """The indel form's launch on the card alone, without the wrapper's
    checks, count and fetch: for the device timings, which capture launches
    in a CUDA graph (the scratch is left zero by each)."""
    n_rec, n, n_refs = rec.pos.shape[0], loci.shape[0], table.shape[1]
    rc = _lib().ngs_pileup_indels(
        _ptr(rec.pos), _ptr(rec.keep), _ptr(rec.mapq), _ptr(rec.cigar_off), _ptr(rec.cigar),
        _ptr(rec.qual_off), n_rec, _ptr(loci), n, _ptr(table), n_refs, loci_range[0],
        loci_range[1], min(max(int(min_mapq), 0), 256), window, _ptr(out),
        (out.shape[0] - 1) // INDEL_HIT, _ptr(scratch), _stream(out))
    _launched("pileup_indels", rc)


def pileup_indels_into(rec: Records, loci: torch.Tensor, table: torch.Tensor,
                       min_mapq: int, window: int, out: torch.Tensor, *,
                       loci_range: tuple[int, int] | None = None,
                       scratch: torch.Tensor | None = None, ring: HitRing | None = None,
                       wait: bool = True) -> torch.Tensor | IndelHits:
    """B1's indel form, the counterpart of the JAX package's host
    ``indel_pileup_at_positions`` (``ngsbits_tpu/qc/pileup.py:278-364``: a
    Python loop over every I and D op of every selected record, a search of
    its chromosome's loci each): the hits of ``pileup_indels_plain`` for the
    batch ``rec`` (positions, keys, MAPQ, CIGARs and SEQ offsets) at
    ``loci`` and ``table`` as ``pileup_add_records_into`` takes them,
    written into ``out`` (``indel_out``: int64 ``[1 + 4 * capacity]``, the
    count first; on the card in any order) and returned on the host as
    int64 ``[count, 4]``: one copy of ``out``. ``loci_range`` ``(lo, hi)``:
    the sorted loci the records can reach (``DevicePileup.reaching``; all
    of them without it): a narrower range gives the same hits. ``scratch``
    (``indel_scratch``, on the card): where the launch keeps its count; a
    fresh one without it. The copy goes into a slot of ``ring`` (``HitRing``;
    a ring of its own without one). With ``wait=False`` the copy is queued
    behind the launch and an ``IndelHits`` returned, whose ``hits()`` waits
    for it. The caller reckons the capacity before the launch (a batch's I
    and D ops times the most loci within any ``2 * window + 1`` positions);
    past it the kernel only counts, and the hits raise on every route."""
    window = _indel_window(window)
    tensors = (rec.pos, rec.keep, rec.mapq, rec.cigar_off, rec.cigar, rec.qual_off, loci,
               table, out)
    if any(t is None for t in tensors):
        raise ValueError("the indel pileup needs the records' SEQ offsets and MAPQ")
    n_rec, n, n_refs, capacity = _indel_args(rec, loci, table, out)
    cut = _loci_range(loci_range, n)
    if _route(*tensors) == "cpu":
        hits = pileup_indels_plain(rec, loci, table, min_mapq, window, cut)
        count = hits.shape[0]
        out[0] = count
        if count <= capacity:
            out[1:1 + INDEL_HIT * count] = hits.flatten()
        got = IndelHits(out[:1 + INDEL_HIT * min(count, capacity)].numpy().copy(), capacity)
    elif n_rec == 0 or n == 0 or n_refs == 0:
        out[:1].zero_()
        got = IndelHits(np.zeros(1, np.int64), capacity)
    else:
        if scratch is None:
            scratch = indel_scratch(out.device)
        _check("scratch", scratch, torch.int64, (2,))
        _route(out, scratch)
        _pileup_indels_launch(rec, loci, table, min_mapq, window, out, cut, scratch)
        with _COUNT_LOCK:
            pileup_indels_into.launches += 1
        got = _hits_to_host(out, capacity, INDEL_HIT, "pileup_indels", ring)
    return got.hits() if wait else got


pileup_indels_into.launches = 0


def count_indel_ops(cigar: np.ndarray) -> int:
    """The I and D ops among BAM CIGAR words (uint32 ``len << 4 | op``)."""
    op = np.asarray(cigar) & 0xF
    return int(np.count_nonzero((op == 1) | (op == 2)))


# --------------------------------------------------------------------------
# B1's region form: a batch's records over indel regions
# --------------------------------------------------------------------------

# int64 columns of a region hit: record, region, the op's query offset, its
# index among the batch's CIGAR words, its reference position g
REGION_HIT = 5
REGION_COUNTERS = 3  # int32 rows of the counters: mapped, mapq0, depth


def pileup_region_pairs(rec: Records, regions: torch.Tensor, table: torch.Tensor,
                        regions_range: tuple[int, int] | None = None):
    """B1's region form one (record, region) pair at a time: the pairs of a
    record with a key and a region of its chromosome that overlap, in order
    of record and region (``pairs``: int64 ``[p, 4]``: record, region, 1 at
    MAPQ 0, what the pair adds to the region's depth: 1 less the record's N
    ops over the region where the record spans it and its MAPQ is not 0,
    else 0; and ``spans``, bool ``[p]``: the record spans the region and its
    MAPQ is not 0), and the hits, int64 ``[k, 5]`` in order of pair and op:
    (record, region, the op's query offset, its index in ``rec.cigar``, its
    1-based reference position ``g``) for each I or D op of a spanning
    record with ``start <= g <= end``. ``pileup_regions_plain`` sums the
    pairs; the fragment route (``count_fragments``) takes them one by
    one. With ``regions_range`` ``(lo, hi)`` only the sorted regions ``[lo,
    hi)`` count (each reference's range cut to it): a range that holds every
    region the records overlap (``DeviceRegions.reaching``'s) gives the same
    pairs and hits."""
    dev = regions.device
    n_refs = table.shape[1]
    if regions_range is not None:
        table = torch.cat([table[:2].clamp(*regions_range), table[2:]])
    key = rec.keep.to(torch.int64)
    r = torch.nonzero((key >= 0) & (key < n_refs)).flatten()
    lo, hi, longest = (table[row][key[r]].to(torch.int64) for row in range(3))
    some = lo < hi
    r, lo, hi, longest = r[some], lo[some], hi[some], longest[some]
    starts, ends = regions[0].to(torch.int64), regions[1].to(torch.int64)
    keys = (_locus_keys(regions[0]) if regions.shape[1]
            else torch.zeros(1, dtype=torch.int64, device=dev))
    rec_of, first_op, op, length = _expand_cigars(rec, r)
    ref_len = length * _table(_CIGAR_REF, op)
    r_start = rec.pos[r].to(torch.int64) + 1
    ref_at = r_start[rec_of] + _exclusive_in_segments(ref_len, first_op, rec_of)
    q_at = _exclusive_in_segments(length * _table(_CIGAR_QUERY, op), first_op, rec_of)
    r_end = r_start - 1 + torch.zeros_like(r_start).index_add_(0, rec_of, ref_len)
    # each record with each region of its chromosome that starts within its
    # span less the longest region, kept where the region ends in the span
    i, j = _pairs(_search(keys, lo, hi, r_start - longest, right=False),
                  _search(keys, lo, hi, r_end, right=True))
    over = ends[j] >= r_start[i]
    i, j = i[over], j[over]
    zero = rec.mapq[r[i]] == 0
    spans = ~zero & (r_start[i] <= starts[j]) & (r_end[i] >= ends[j])
    delta = spans.to(torch.int64)
    # each spanning pair with each I, D and N op of its record
    o = torch.nonzero((op == 1) | (op == 2) | (op == 3)).flatten()
    per = torch.arange(r.shape[0], device=dev)
    oa = torch.searchsorted(rec_of[o], per, right=False)
    ob = torch.searchsorted(rec_of[o], per, right=True)
    sp = torch.nonzero(spans).flatten()
    k, m = _pairs(oa[i[sp]], ob[i[sp]])
    p, ok = sp[k], o[m]   # the pair and the op
    g, s, e = ref_at[ok], starts[j[p]], ends[j[p]]
    skips = (op[ok] == 3) & (g <= s) & (g + length[ok] >= e)
    delta.index_add_(0, p[skips], -torch.ones_like(p[skips]))
    hit = (op[ok] != 3) & (s <= g) & (g <= e)
    p, ok = p[hit], ok[hit]
    word = rec.cigar_off[r[rec_of[ok]]] + ok - first_op[rec_of[ok]]
    hits = torch.stack([r[i[p]], j[p], q_at[ok], word, ref_at[ok]], dim=1)
    pairs = torch.stack([r[i], j, zero.to(torch.int64), delta], dim=1)
    return pairs, spans, hits


def pileup_regions_plain(rec: Records, regions: torch.Tensor, table: torch.Tensor,
                         counters: torch.Tensor,
                         regions_range: tuple[int, int] | None = None) -> torch.Tensor:
    pairs, _, hits = pileup_region_pairs(rec, regions, table, regions_range)
    j = pairs[:, 1]
    for row, values in enumerate((torch.ones_like(j), pairs[:, 2], pairs[:, 3])):
        counters[row].index_add_(0, j, values.to(counters.dtype))
    return hits


def region_out(capacity: int, device: torch.device) -> torch.Tensor:
    """The output ``pileup_regions_into`` takes for ``capacity`` hits: int64
    ``[1 + 5 * capacity]``, the count of hits, then the hits."""
    return torch.empty(1 + REGION_HIT * int(capacity), dtype=torch.int64, device=device)


def _region_args(rec: Records, regions: torch.Tensor, table: torch.Tensor,
                 counters: torch.Tensor, out: torch.Tensor) -> tuple[int, int, int, int]:
    """Checks the region form's arguments: (records, regions, references,
    capacity)."""
    n_rec = rec.pos.shape[0]
    n = regions.shape[1] if regions.dim() == 2 else -1
    n_refs = table.shape[1] if table.dim() == 2 else -1
    if out.dim() != 1 or out.shape[0] < 1 or (out.shape[0] - 1) % REGION_HIT:
        raise ValueError(f"out: shape {tuple(out.shape)}, expected [1 + 5 * capacity]")
    _check("pos", rec.pos, torch.int32, (n_rec,))
    _check("keep", rec.keep, torch.int32, (n_rec,))
    _check("mapq", rec.mapq, torch.uint8, (n_rec,))
    _check("cigar_off", rec.cigar_off, torch.int64, (n_rec + 1,))
    _check("cigar", rec.cigar, torch.int32, (rec.cigar.shape[0],))
    _check("regions", regions, torch.int32, (2, n))
    _check("table", table, torch.int32, (3, n_refs))
    _check("counters", counters, torch.int32, (REGION_COUNTERS, n))
    _check("out", out, torch.int64, (out.shape[0],))
    return n_rec, n, n_refs, (out.shape[0] - 1) // REGION_HIT


def _pileup_regions_launch(rec: Records, regions: torch.Tensor, table: torch.Tensor,
                           counters: torch.Tensor, out: torch.Tensor,
                           regions_range: tuple[int, int], scratch: torch.Tensor) -> None:
    """The region form's launch on the card alone, without the wrapper's
    checks, count and fetch: for the device timings, which capture launches
    in a CUDA graph (the scratch is left zero by each)."""
    rc = _lib().ngs_pileup_regions(
        _ptr(rec.pos), _ptr(rec.keep), _ptr(rec.mapq), _ptr(rec.cigar_off), _ptr(rec.cigar),
        rec.pos.shape[0], _ptr(regions), regions.shape[1], _ptr(table), table.shape[1],
        regions_range[0], regions_range[1], _ptr(counters), _ptr(out),
        (out.shape[0] - 1) // REGION_HIT, _ptr(scratch), _stream(out))
    _launched("pileup_regions", rc)


def pileup_regions_into(rec: Records, regions: torch.Tensor, table: torch.Tensor,
                        counters: torch.Tensor, out: torch.Tensor, *,
                        regions_range: tuple[int, int] | None = None,
                        scratch: torch.Tensor | None = None, ring: HitRing | None = None,
                        wait: bool = True) -> torch.Tensor | IndelHits:
    """B1's region form, the counterpart of the JAX package's host
    ``get_indels`` (``ngsbits_tpu/qc/variant_details.py:134-208``: a numpy
    filter of each batch for each indel region, a Python walk of the CIGAR
    of each record over it): for each record of the batch ``rec``
    (positions, keys, MAPQ and CIGARs) whose key ``k`` has regions, those of
    ``regions[:, table[0, k]:table[1, k]]`` (int32 ``[2, n]``: 1-based
    inclusive starts and ends, sorted by start within each such range;
    ``table`` int32 ``[3, n_refs]``, each reference's range and its longest
    region's ``end - start``) that overlap its span ``[pos + 1, end]``:
    ``counters`` (int32 ``[3, n]``) counts it in row 0, at MAPQ 0 also in row
    1 and nothing more; else, where it spans the region, adds 1 less its N
    ops from ``g <= start`` to ``g + len >= end`` to row 2, and each of its I
    and D ops with ``start <= g <= end`` is a hit (``pileup_region_pairs``),
    written into ``out`` (``region_out``: int64 ``[1 + 5 * capacity]``, the
    count first; on the card in any order) and returned on the host as int64
    ``[count, 5]``. ``regions_range`` ``(lo, hi)``: the sorted regions the
    records can reach (``DeviceRegions.reaching``; all of them without it):
    a narrower range gives the same counters and hits. ``scratch``
    (``indel_scratch``, on the card): where the launch keeps its count; a
    fresh one without it. The copy goes into a slot of ``ring`` (``HitRing``;
    a ring of its own without one). With ``wait=False`` the copy is queued
    behind the launch and an ``IndelHits`` returned, whose ``hits()`` waits
    for it. The caller reckons the capacity before the launch (a batch's I
    and D ops times the most regions over any one position); past it the
    kernel only counts, and the hits raise on every route."""
    tensors = (rec.pos, rec.keep, rec.mapq, rec.cigar_off, rec.cigar, regions, table,
               counters, out)
    if any(t is None for t in tensors):
        raise ValueError("the region pileup needs the records' MAPQ")
    n_rec, n, n_refs, capacity = _region_args(rec, regions, table, counters, out)
    lo, hi = (0, n) if regions_range is None else (int(regions_range[0]),
                                                   int(regions_range[1]))
    if not 0 <= lo <= hi <= n:
        raise ValueError(f"regions range [{lo}, {hi}): it must lie within [0, {n}]")
    if _route(*tensors) == "cpu":
        hits = pileup_regions_plain(rec, regions, table, counters, (lo, hi))
        count = hits.shape[0]
        out[0] = count
        if count <= capacity:
            out[1:1 + REGION_HIT * count] = hits.flatten()
        got = IndelHits(out[:1 + REGION_HIT * min(count, capacity)].numpy().copy(), capacity,
                        width=REGION_HIT, name="pileup_regions")
    elif n_rec == 0 or lo == hi or n_refs == 0:
        out[:1].zero_()
        got = IndelHits(np.zeros(1, np.int64), capacity, width=REGION_HIT,
                        name="pileup_regions")
    else:
        if scratch is None:
            scratch = indel_scratch(out.device)
        _check("scratch", scratch, torch.int64, (2,))
        _route(out, scratch)
        _pileup_regions_launch(rec, regions, table, counters, out, (lo, hi), scratch)
        with _COUNT_LOCK:
            pileup_regions_into.launches += 1
        got = _hits_to_host(out, capacity, REGION_HIT, "pileup_regions", ring)
    return got.hits() if wait else got


pileup_regions_into.launches = 0


# --------------------------------------------------------------------------
# X7: the similarity's exact moments
# --------------------------------------------------------------------------

_GENOTYPE_ALIGN = 16  # upload_genotypes pads each row to this many bytes


def correlation_moments_plain(genotypes, out):
    x = genotypes[0].to(torch.int64)
    y = genotypes[1].to(torch.int64)
    out += torch.stack([x.sum(), y.sum(), (x * x).sum(), (y * y).sum(), (x * y).sum()])


def correlation_moments_into(genotypes: torch.Tensor, out: torch.Tensor) -> None:
    """X7, the counterpart of the JAX package's ``_corr_fn`` moments
    (``ngsbits_tpu/ops/device_reduce.py:167-181``): adds the five sums sx,
    sy, sxx, syy and sxy of the rows x and y of uint8 ``genotypes [2, n]``
    into int64 ``out [5]``, exactly for any n. Both routes check the
    arguments first."""
    n = genotypes.shape[1] if genotypes.dim() == 2 else -1
    _check("genotypes", genotypes, torch.uint8, (2, n))
    _check("out", out, torch.int64, (5,))
    if _route(genotypes, out) == "cpu":
        return correlation_moments_plain(genotypes, out)
    if n == 0:
        return
    rc = _lib().ngs_correlation_moments(_ptr(genotypes), n, _ptr(out), _stream(out))
    _launched("correlation_moments", rc)
    correlation_moments_into.launches += 1


correlation_moments_into.launches = 0


def upload_genotypes(x: np.ndarray, y: np.ndarray,
                     device: torch.device | None = None) -> torch.Tensor:
    """Genotype vectors x and y (0, 0.5 or 1) as X7 takes them: the doubled
    values in a uint8 ``[2, m]`` tensor on ``device``, each row zero-padded
    to a multiple of 16 bytes (the pads leave every sum unchanged and start
    row y on a 16-byte boundary)."""
    n = len(x)
    if len(y) != n:
        raise ValueError(f"genotype vectors of {n} and {len(y)} values")
    x2 = np.rint(np.asarray(x, dtype=np.float64) * 2)
    y2 = np.rint(np.asarray(y, dtype=np.float64) * 2)
    if not (np.isin(x2, (0.0, 1.0, 2.0)).all() and np.isin(y2, (0.0, 1.0, 2.0)).all()):
        raise ValueError("genotypes must be 0, 0.5 or 1")
    m = -(-n // _GENOTYPE_ALIGN) * _GENOTYPE_ALIGN
    buf = np.zeros((2, m), dtype=np.uint8)
    buf[0, :n] = x2
    buf[1, :n] = y2
    return torch.from_numpy(buf).to(default_device() if device is None else torch.device(device))


def genotype_moments(x: np.ndarray, y: np.ndarray,
                     device: torch.device | None = None) -> list[int]:
    """X7's five exact sums ``[sx, sy, sxx, syy, sxy]`` of the doubled
    genotype vectors x and y (0, 0.5 or 1): one upload to ``device``, one
    launch, one fetch of 40 bytes. The sums are int64, so there is no limit
    on n."""
    g = upload_genotypes(x, y, device)
    out = torch.zeros(5, dtype=torch.int64, device=g.device)
    correlation_moments_into(g, out)
    return out.tolist()


def pearson_from_moments(n: int, sums: list[int]) -> float:
    """Pearson correlation of n genotype pairs formed in float64 on the host
    from their five exact sums (``genotype_moments``); NaN where either
    vector is constant."""
    sx, sy, sxx, syy, sxy = sums
    num = n * sxy - sx * sy
    den = np.sqrt(float(n * sxx - sx * sx)) * np.sqrt(float(n * syy - sy * sy))
    if den == 0.0:
        return float("nan")
    return float(num / den)


def pearson_from_genotypes(x: np.ndarray, y: np.ndarray,
                           device: torch.device | None = None) -> float:
    """Pearson correlation of genotype vectors (values in {0, 0.5, 1}): the
    exact integer moments of the doubled genotypes on ``device`` (X7), r
    formed from them in float64 on the host; NaN where either vector is
    constant. Mathematically identical to ``core/basicstats.correlation``;
    rounding differs only below 1e-12, so a value printed to a few decimals
    can differ at an exact tie (``qc/sample_similarity.py::tie_band`` finds
    those from the sums)."""
    return pearson_from_moments(len(x), genotype_moments(x, y, device))


# --------------------------------------------------------------------------
# engines with the JAX package's API
# --------------------------------------------------------------------------

def _upload(rows: list[np.ndarray], dev: torch.device) -> torch.Tensor:
    """int32 ``[len(rows), n]`` on ``dev`` in one copy (each row written
    once into the host buffer; values must fit int32)."""
    buf = np.empty((len(rows), len(rows[0])), dtype=np.int32)
    for k, r in enumerate(rows):
        buf[k] = r
    return torch.from_numpy(buf).to(dev)


class DeviceCoverage:
    """Coverage of one span (positions 0..span-1), its difference array on
    the device: ``add`` scatters each batch of spans at once (C1);
    ``add_reads`` clips each batch of reads to ``regions`` given at set-up
    (C1's read form); ``add_records`` walks a batch's alignment records on
    the device (C1's record form), into ``blocks`` of genomic positions
    given at set-up;
    ``histogram`` returns the depth histogram and the half-depth count (C2);
    ``region_sums`` (C2's dense mode, then R1) and ``runs`` (then R2) return
    per-region results; ``coverage_at`` and ``finalize`` take the dense
    coverage from the same dense mode. ``fetched`` counts the bytes copied
    back to the host."""

    def __init__(self, span: int, device: torch.device | None = None,
                 blocks: np.ndarray | None = None, regions: np.ndarray | None = None):
        """``blocks`` (optional): int64 ``[2, n]``, the genomic starts and
        exclusive ends (0-based, sorted, disjoint) of the positions the span
        holds, in order (a dense box is one block), for ``add_records``;
        uploaded here once, with each block's offset. ``regions``
        (optional): ``[2, n]``, the 1-based inclusive starts and ends of the
        regions whose positions the span holds end to end (a ROI, flattened),
        for ``add_reads``; uploaded here once as int32 ``[3, n]`` with each
        region's offset."""
        if span + 1 > INT32_LIMIT:
            raise ValueError(f"span {span}: int32 coordinates need span < 2^31 - 1")
        self.span = span
        self.device = default_device() if device is None else torch.device(device)
        self.diff = torch.zeros(span + 1, dtype=torch.int32, device=self.device)
        self.fetched = 0
        self.blocks = None
        if blocks is not None:
            bs, be = np.asarray(blocks, dtype=np.int64)
            lengths = be - bs
            if not len(bs) or lengths.min() < 1 or (bs[1:] < be[:-1]).any() or \
                    lengths.sum() != span:
                raise ValueError(f"blocks must be sorted, disjoint and non-empty, "
                                 f"and hold the span's {span} positions")
            off = np.concatenate(([0], np.cumsum(lengths)[:-1]))
            self.blocks = torch.from_numpy(np.stack([bs, be, off])).to(self.device)
        self.regions = None
        if regions is not None:
            rs, re = np.asarray(regions, dtype=np.int64).reshape(2, -1)
            lengths = re - rs + 1
            if (len(rs) and (lengths.min() < 0 or rs.min() < -INT32_LIMIT
                             or re.max() > INT32_LIMIT)) or lengths.sum() != span:
                raise ValueError(f"regions must end no earlier than the base before their "
                                 f"start, lie within int32 and hold the span's {span} "
                                 f"positions")
            off = np.concatenate(([0], np.cumsum(lengths)[:-1]))
            self.regions = _upload([rs, re, off], self.device)

    def add(self, starts: np.ndarray, ends_excl: np.ndarray | None = None):
        """Adds the half-open spans ``[starts[i], ends_excl[i])``, or without
        ``ends_excl`` the positions ``starts[i]`` one each. Raises
        ValueError, on every device, for a span outside ``[0, span]`` or one
        that ends before it starts."""
        if not len(starts):
            return
        s = np.asarray(starts, dtype=np.int64)
        e = s + 1 if ends_excl is None else np.asarray(ends_excl, dtype=np.int64)
        if s.min() < 0 or e.max() > self.span or (e - s).min() < 0:
            i = int(np.argmax((s < 0) | (e > self.span) | (e < s)))
            raise ValueError(f"span [{s[i]}, {e[i]}) is outside the coverage's "
                             f"positions [0, {self.span}] or ends before it starts")
        if ends_excl is None:
            coverage_add_into(_upload([s], self.device)[0], None, self.diff)
        else:
            se = _upload([s, e], self.device)
            coverage_add_into(se[0], se[1], self.diff)

    def add_reads(self, starts: np.ndarray, ends: np.ndarray, i0: np.ndarray,
                  i1: np.ndarray):
        """Adds each read ``[starts[i], ends[i]]`` (1-based, inclusive)
        clipped to each of the regions ``i0[i] <= r < i1[i]``, in one upload
        of 16 bytes a read (``coverage_add_reads_into``). Raises ValueError,
        on every device, for a range outside ``[0, n]`` or with ``i1 < i0``,
        or a read that ends before it starts (``end < start - 1``)."""
        if self.regions is None:
            raise ValueError("add_reads needs the coverage's regions")
        if not len(starts):
            return
        s, e, a, b = (np.asarray(c, dtype=np.int64) for c in (starts, ends, i0, i1))
        n = self.regions.shape[1]
        if (a.min() < 0 or b.max() > n or (b - a).min() < 0 or (e - s).min() < -1
                or s.min() < -INT32_LIMIT or e.max() > INT32_LIMIT):
            i = int(np.argmax((a < 0) | (b > n) | (b < a) | (e < s - 1)
                              | (s < -INT32_LIMIT) | (e > INT32_LIMIT)))
            raise ValueError(f"read [{s[i]}, {e[i]}] with regions [{a[i]}, {b[i]}) is outside "
                             f"the contract: ranges within [0, {n}], reads within int32 that "
                             f"end no earlier than the base before their start")
        coverage_add_reads_into(_upload([s, e, a, b], self.device), self.regions, self.diff)

    def add_records(self, rec: Records, r0: int, r1: int, ref: int, min_baseq: int):
        """Adds the records ``r0 <= r < r1`` of a batch whose key is ``ref``
        (``coverage_add_records_into``) at the positions of ``blocks``."""
        if self.blocks is None:
            raise ValueError("add_records needs the coverage's blocks of positions")
        coverage_add_records_into(rec, r0, r1, ref, min_baseq, self.blocks, self.diff)

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        out = t.cpu().numpy()
        self.fetched += out.nbytes
        return out

    def histogram(self, step: int, hist_max: int, bins: int,
                  half_depth: int) -> tuple[np.ndarray, int]:
        """(int64 counts of the ``bins`` depth bins, positions at or above
        ``half_depth``): all that comes back from the card."""
        out = torch.empty(bins + 1, dtype=torch.int64, device=self.device)
        coverage_finalize_into(self.diff, step, hist_max, half_depth, out[:bins],
                               out[bins:])
        got = self._fetch(out)
        return got[:bins], int(got[bins])

    def dense(self) -> torch.Tensor:
        """The int32 coverage ``[span]`` on the device (C2 without its
        histogram)."""
        cov = torch.empty(self.span, dtype=torch.int32, device=self.device)
        coverage_finalize_into(self.diff, 1, 0, 0, None, None, cov)
        return cov

    def _regions(self, starts: np.ndarray, ends: np.ndarray):
        starts = np.asarray(starts, dtype=np.int64)
        ends = np.asarray(ends, dtype=np.int64)
        if len(starts) and (starts.min() < 0 or ends.max() >= self.span):
            raise ValueError(f"regions must lie within [0, {self.span})")
        s, off = region_offsets(starts, ends)
        return (torch.from_numpy(s).to(self.device),
                torch.from_numpy(off).to(self.device))

    def region_sums(self, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
        """int64 coverage sums over the regions ``[starts[r], ends[r]]``
        (inclusive)."""
        out = torch.empty(len(starts), dtype=torch.int64, device=self.device)
        if len(starts):
            region_sums_into(self.dense(), *self._regions(starts, ends), out)
        return self._fetch(out)

    def runs(self, starts: np.ndarray, ends: np.ndarray, cutoff: int,
             is_high: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(region index, first, last) of each run of positions of the
        regions ``[starts[r], ends[r]]`` whose coverage is below ``cutoff``
        (at or above it with ``is_high``), in region then position order."""
        if not len(starts):
            z = np.zeros(0, dtype=np.int32)
            return z, z, z
        got = threshold_runs(self.dense(), *self._regions(starts, ends), cutoff, is_high)
        self.fetched += RUNS_COUNT_BYTES if got.is_cuda else 0
        region, first, last = self._fetch(got)
        return region, first, last

    def coverage_at(self, pos: np.ndarray) -> np.ndarray:
        """Coverage at the given positions (each in [0, span))."""
        if len(pos) == 0:
            return np.zeros(0, dtype=np.int64)
        idx = torch.from_numpy(np.asarray(pos, dtype=np.int64)).to(self.device)
        return self._fetch(self.dense()[idx].to(torch.int64))

    def finalize(self) -> np.ndarray:
        """Dense coverage over the full span (int64)."""
        out = self._fetch(self.dense().to(torch.int64))
        self.diff = None
        return out


class DeviceBincount:
    """Counter array engine (B1's index form, the JAX package's
    ``DeviceBincount``): int32 counters on the device, each batch of indices
    counted at once (B1), fetched once at the end as int64. The pileup
    counts through ``DevicePileup``."""

    def __init__(self, size: int, device: torch.device | None = None):
        self.size = size
        self.device = default_device() if device is None else torch.device(device)
        self.counts = torch.zeros(size, dtype=torch.int32, device=self.device)

    def add(self, idx: np.ndarray):
        if len(idx):
            bincount_add_into(_upload([idx], self.device)[0], self.counts)

    def finalize(self) -> np.ndarray:
        out = self.counts.to(torch.int64).cpu().numpy()
        self.counts = None
        return out


class DevicePileup:
    """Pileup counters at a set of loci on the device (B1's record form):
    the loci, sorted by chromosome and position, and a table of each
    reference's range of them, uploaded once; int32 base, deletion and
    (with ``track_mapq0``) read and MAPQ-0 counters in one buffer on the
    device; ``reaching`` picks a batch's records that reach a locus (on the
    host), ``add`` counts a batch's records at once, ``finalize`` fetches
    the counters once as int64, in the loci's own order. With
    ``indel_window`` ``add`` also finds the I and D ops within that many
    bases of a locus (B1's indel form) on the same upload and returns them
    on their way to the host (``IndelHits``: one copy a batch, waited for
    by whoever asks for its hits); without ``count_bases`` it launches only
    that form."""

    def __init__(self, chr_nums: np.ndarray, positions: np.ndarray, ref_nums: np.ndarray,
                 track_mapq0: bool = False, device: torch.device | None = None,
                 indel_window: int | None = None, count_bases: bool = True):
        """``chr_nums``, ``positions``: each locus' chromosome number and
        1-based position (any order, duplicates allowed); ``ref_nums``: the
        chromosome number of each of the BAM's references (its ``ref_id``s)."""
        pos = np.asarray(positions, dtype=np.int64)
        chrs = np.asarray(chr_nums, dtype=np.int64)
        n = self.n = len(pos)
        if n and (pos.min() < -INT32_LIMIT or pos.max() > INT32_LIMIT):
            raise ValueError("loci positions must lie within int32")
        if 7 * n > INT32_LIMIT:
            raise ValueError(f"{n} loci: the counters need fewer than 2^31 / 7")
        if not count_bases and indel_window is None:
            raise ValueError("a pileup without base counts needs an indel window")
        self.device = default_device() if device is None else torch.device(device)
        self.order = np.lexsort((pos, chrs))
        s_chr = chrs[self.order]
        refs = np.asarray(ref_nums, dtype=np.int64)
        table = np.stack([np.searchsorted(s_chr, refs, "left"),
                          np.searchsorted(s_chr, refs, "right")]).astype(np.int32)
        self._host_loci, self._host_table = pos[self.order], table.reshape(2, len(refs))
        self.loci = torch.from_numpy(pos[self.order].astype(np.int32)).to(self.device)
        self.table = torch.from_numpy(self._host_table).to(self.device)
        self.count_bases = count_bases
        self.indel_window = None if indel_window is None else _indel_window(indel_window)
        # the most loci (duplicates included) in any 2 * window + 1 positions of
        # one chromosome: how many hits one I or D op can make
        self.indel_depth = 0
        if self.indel_window is not None and n:
            key = (s_chr - s_chr.min()) * (1 << 34) + self._host_loci + (1 << 31)
            self.indel_depth = int((np.searchsorted(key, key + 2 * self.indel_window, "right")
                                    - np.arange(n)).max())
        # the indel form's count, zeroed once: each launch leaves it zero; its
        # output on the card and the pinned slots of its copies, grown as needed
        self.scratch = (None if self.indel_window is None
                        else indel_scratch(self.device))
        self.hits_out, self.ring = None, HitRing()
        self.out = torch.zeros((7 if track_mapq0 else 5) * n, dtype=torch.int32,
                               device=self.device)
        self.counts = self.out[:4 * n].view(n, 4)
        self.dels = self.out[4 * n:5 * n]
        self.mapped = self.out[5 * n:6 * n] if track_mapq0 else None
        self.mapq0 = self.out[6 * n:] if track_mapq0 else None

    def reaching(self, pos: np.ndarray, ends: np.ndarray,
                 keys: np.ndarray) -> tuple[np.ndarray, tuple[int, int]]:
        """The host's pre-filter: which records' reference spans (0-based
        ``pos`` to the 1-based inclusive ``ends``) hold a locus of their
        key's chromosome, by two searches a chromosome in the batch, and
        ``(lo, hi)``, the smallest range of the sorted loci that holds every
        locus in those spans (``(0, 0)``: none). Only these records need to
        go up: the others count nowhere. With an indel window ``w`` the span
        is ``[pos + 1 - w, ends + 1 + w]``: an I op after a record's last
        aligned base lies at ``ends + 1``. B1 counts bases, deletions and
        reads over a locus on the record's own span, so a record that only
        the widening keeps counts nothing there."""
        loci, table = self._host_loci, self._host_table
        w = self.indel_window
        lo_pad, hi_pad = (0, 0) if w is None else (w, w + 1)
        reach = np.zeros(len(keys), dtype=bool)
        cut_lo, cut_hi = self.n, 0
        kept = np.flatnonzero((keys >= 0) & (keys < table.shape[1]))
        for ref in np.unique(keys[kept]):
            lo, hi = table[:, ref]
            if lo < hi:
                rr = kept[keys[kept] == ref]
                a = np.searchsorted(loci[lo:hi], pos[rr].astype(np.int64) + 1 - lo_pad, "left")
                b = np.searchsorted(loci[lo:hi], ends[rr].astype(np.int64) + hi_pad, "right")
                some = b > a
                reach[rr[some]] = True
                if some.any():
                    cut_lo = min(cut_lo, int(lo + a[some].min()))
                    cut_hi = max(cut_hi, int(lo + b[some].max()))
        return reach, ((cut_lo, cut_hi) if cut_lo < cut_hi else (0, 0))

    def add(self, rec: Records, min_mapq: int, min_baseq: int, indel_ops: int = 0,
            loci_range: tuple[int, int] | None = None) -> IndelHits | None:
        """Counts one batch's records (``pileup_add_records_into``); with
        an indel window also launches their indel form
        (``pileup_indels_into`` on the engine's scratch, output and ring,
        its capacity ``indel_ops``, the batch's I and D ops, times
        ``indel_depth``, at the loci ``loci_range`` from ``reaching``; no
        launch without an I or D op) and returns its hits on their way to
        the host, without a wait (else None)."""
        if self.count_bases:
            pileup_add_records_into(rec, self.loci, self.table, min_mapq, min_baseq,
                                    self.counts, self.dels, self.mapped, self.mapq0)
        capacity = indel_ops * self.indel_depth
        if self.indel_window is None or capacity == 0:
            return None
        words = 1 + INDEL_HIT * capacity
        self.hits_out = _grown(self.hits_out, words, self.device)
        return pileup_indels_into(rec, self.loci, self.table, min_mapq, self.indel_window,
                                  self.hits_out[:words], loci_range=loci_range,
                                  scratch=self.scratch, ring=self.ring, wait=False)

    def finalize(self) -> dict[str, np.ndarray]:
        """int64 ``counts [n, 4]``, ``dels``, and with ``track_mapq0``
        ``mapped`` and ``mapq0`` ``[n]``, in the loci's order: one fetch."""
        got = self.out.to(torch.int64).cpu().numpy()
        n, order = self.n, self.order
        fields = {"counts": got[:4 * n].reshape(n, 4), "dels": got[4 * n:5 * n]}
        if self.mapped is not None:
            fields.update(mapped=got[5 * n:6 * n], mapq0=got[6 * n:])
        result = {}
        for name, sorted_values in fields.items():
            result[name] = np.empty_like(sorted_values)
            result[name][order] = sorted_values
        self.out = self.counts = self.dels = self.mapped = self.mapq0 = None
        return result


class DeviceRegions:
    """Indel regions' counters on the device (B1's region form): the
    regions, sorted by chromosome, start and end, and a table of each
    reference's range of them with its longest region, uploaded once; int32
    ``mapped``, ``mapq0`` and ``depth`` counters in one buffer on the
    device; ``reaching`` picks a batch's records that may overlap a region
    (on the host) and the range of the regions they reach, ``add`` launches
    the form on a batch's uploaded records and returns its hits on their way
    to the host (``IndelHits``: one copy a batch into a slot of the engine's
    ``HitRing``, from an output on the card kept from batch to batch),
    ``finalize`` fetches the counters once as int64, in the regions' own
    order."""

    def __init__(self, chr_nums: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                 ref_nums: np.ndarray, device: torch.device | None = None):
        """``chr_nums``, ``starts``, ``ends``: each region's chromosome
        number and 1-based inclusive start and end (any order, duplicates
        and overlaps allowed); ``ref_nums``: the chromosome number of each
        of the BAM's references (its ``ref_id``s)."""
        s = np.asarray(starts, dtype=np.int64)
        e = np.asarray(ends, dtype=np.int64)
        chrs = np.asarray(chr_nums, dtype=np.int64)
        n = self.n = len(s)
        if n and (min(s.min(), e.min()) < -INT32_LIMIT or max(s.max(), e.max()) > INT32_LIMIT):
            raise ValueError("region bounds must lie within int32")
        if REGION_COUNTERS * n > INT32_LIMIT:
            raise ValueError(f"{n} regions: the counters need fewer than 2^31 / 3")
        self.device = default_device() if device is None else torch.device(device)
        self.order = np.lexsort((e, s, chrs))
        s_chr, s_start, s_end = chrs[self.order], s[self.order], e[self.order]
        refs = np.asarray(ref_nums, dtype=np.int64)
        lo = np.searchsorted(s_chr, refs, "left")
        hi = np.searchsorted(s_chr, refs, "right")
        width = np.maximum(s_end - s_start, 0)
        longest = np.array([int(width[a:b].max()) if b > a else 0 for a, b in zip(lo, hi)],
                           dtype=np.int64)
        self._host_starts, self._host_lo, self._host_hi = s_start, lo, hi
        self._host_longest = longest
        table = np.stack([lo, hi, longest]).astype(np.int32).reshape(3, len(refs))
        self.regions = torch.from_numpy(np.stack([s_start, s_end]).astype(np.int32)).to(
            self.device)
        self.table = torch.from_numpy(table).to(self.device)
        # the most regions over any one position of a chromosome: how many
        # hits one I or D op can make
        self.depth = 0
        real = np.flatnonzero(s_start <= s_end)
        if len(real):
            at = np.concatenate([s_start[real], s_end[real] + 1])
            step = np.concatenate([np.ones(len(real), np.int64), -np.ones(len(real), np.int64)])
            c = np.concatenate([s_chr[real], s_chr[real]])
            self.depth = int(np.cumsum(step[np.lexsort((step, at, c))]).max())
        self.counters = torch.zeros((REGION_COUNTERS, n), dtype=torch.int32, device=self.device)
        # the launches' count, zeroed once: each launch leaves it zero; their
        # output on the card and the pinned slots of their copies, grown as needed
        self.scratch = indel_scratch(self.device)
        self.hits_out, self.ring = None, HitRing()

    def reaching(self, pos: np.ndarray, ends: np.ndarray,
                 keys: np.ndarray) -> tuple[np.ndarray, tuple[int, int]]:
        """The host's pre-filter: which records' reference spans (0-based
        ``pos`` to the 1-based inclusive ``ends``) may overlap a region of
        their key's chromosome: a region starts within the span widened on
        the left by the chromosome's longest region (two searches a
        chromosome in the batch); and ``(lo, hi)``, the smallest range of the
        sorted regions that holds every region those searches find (``(0,
        0)``: none). Only these records need to go up: the others overlap no
        region."""
        reach = np.zeros(len(keys), dtype=bool)
        n_refs = len(self._host_lo)
        cut_lo, cut_hi = self.n, 0
        kept = np.flatnonzero((keys >= 0) & (keys < n_refs))
        for ref in np.unique(keys[kept]):
            lo, hi = self._host_lo[ref], self._host_hi[ref]
            if lo < hi:
                rr = kept[keys[kept] == ref]
                starts = self._host_starts[lo:hi]
                a = np.searchsorted(starts, pos[rr].astype(np.int64) + 1
                                    - self._host_longest[ref], "left")
                b = np.searchsorted(starts, ends[rr].astype(np.int64), "right")
                some = b > a
                reach[rr[some]] = True
                if some.any():
                    cut_lo = min(cut_lo, int(lo + a[some].min()))
                    cut_hi = max(cut_hi, int(lo + b[some].max()))
        return reach, ((cut_lo, cut_hi) if cut_lo < cut_hi else (0, 0))

    def add(self, rec: Records, indel_ops: int,
            regions_range: tuple[int, int] | None = None) -> IndelHits:
        """Launches the region form on one batch's records
        (``pileup_regions_into`` into the engine's counters, on its scratch,
        output and ring, its capacity ``indel_ops``, the batch's I and D
        ops, times ``depth``, at the regions ``regions_range`` from
        ``reaching``) and returns its hits on their way to the host, without
        a wait."""
        words = 1 + REGION_HIT * indel_ops * self.depth
        self.hits_out = _grown(self.hits_out, words, self.device)
        return pileup_regions_into(rec, self.regions, self.table, self.counters,
                                   self.hits_out[:words], regions_range=regions_range,
                                   scratch=self.scratch, ring=self.ring, wait=False)

    def finalize(self) -> dict[str, np.ndarray]:
        """int64 ``mapped``, ``mapq0`` and ``depth`` ``[n]``, in the
        regions' order: one fetch."""
        got = self.counters.to(torch.int64).cpu().numpy()
        result = {}
        for row, name in enumerate(("mapped", "mapq0", "depth")):
            result[name] = np.empty(self.n, dtype=np.int64)
            result[name][self.order] = got[row]
        self.counters = None
        return result
