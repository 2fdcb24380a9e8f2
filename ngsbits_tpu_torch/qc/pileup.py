"""Batched pileup engine: base counts at SNP positions.

Counterpart of ``PileupResult`` and ``pileup_at_positions`` in
``ngsbits_tpu/qc/pileup.py``. One sequential sweep of the BAM (the JAX
package's route without an index: the same counts; the BAI route is not
ported), its batches decoded on a prefetch thread. For each batch the host
marks the records its flag filter keeps (a record's key: its ``ref_id``,
else -1), keeps those whose reference span holds a locus (one pair of
searches a chromosome: a few percent of a panel's BAM) and uploads their
columns in one copy; B1's record form (``DevicePileup``,
``ops/device_reduce.py``, ``csrc/pileup.cu``) walks their CIGARs to the loci
on the card and counts bases, deletions and, with ``track_mapq0``, the reads
and the MAPQ-0 reads over each locus, always (the JAX package's size
threshold is not carried over). The counters are fetched once, at the end.
Uploading every record instead (about 21 MB of bases and qualities a batch
of 65,536) was slower end to end on the H100 (``PERF.md``). With ``count_fragments`` (name-based dedup) the counting
stays on the host, as in the JAX package: the same record form's plain
version on the CPU gives each (read, locus, base, quality) in record order,
and the dedup is the JAX package's loop. A locus past its record's SEQ (a
record with M ops but no SEQ) has no base and counts nowhere, where the JAX
package reads the next record's bytes (``ROADMAP.md`` F9). A record without
a reference (``ref_id`` -1) counts nowhere. ``indel_pileup_at_positions`` is
not ported yet.

Behavioral reference: ngs-bits BamReader::getPileup (cppNGS/BamReader.cpp:
809-878): skip secondary/supplementary/duplicate/unmapped; optionally require
properly-paired; mapq>=min_mapq; base at position extracted by CIGAR walk
(M/=/X only — deletions/skips don't contribute A/C/G/T counts);
optional fragment dedup by read name (disagreeing pair bases: higher quality
wins, base-vs-deletion removes both).
"""

from __future__ import annotations

import numpy as np

from ..core.chromosome import Chromosome
from ..io.bam import (BamBatch, BamReader, FLAG_DUPLICATE, FLAG_PROPER_PAIR,
                      FLAG_SECONDARY, FLAG_SUPPLEMENTARY, FLAG_UNMAPPED)
from ..ops.device_reduce import DELETION, DevicePileup, pileup_hits, upload_records
from ..utils.prefetch import prefetch

_DROPPED = FLAG_SECONDARY | FLAG_SUPPLEMENTARY | FLAG_DUPLICATE | FLAG_UNMAPPED


class PileupResult:
    """counts[N, 4] = A/C/G/T counts per locus (same order as input loci);
    dels[N] = deletion ('-') counts (Pileup::incDel)."""

    def __init__(self, n: int):
        self.counts = np.zeros((n, 4), dtype=np.int64)
        self.dels = np.zeros(n, dtype=np.int64)
        # filled when track_mapq0=True: flag-passing reads overlapping each
        # locus, and how many of them have mapq 0 (BamReader::getPileup
        # reads_mapped/reads_mapq0)
        self.mapped = np.zeros(n, dtype=np.int64)
        self.mapq0 = np.zeros(n, dtype=np.int64)

    def mapq0_frac(self) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return self.mapq0 / self.mapped

    def depth(self, count_del: bool = False) -> np.ndarray:
        d = self.counts.sum(axis=1)
        return d + self.dels if count_del else d

    def frequency(self, ref_idx: np.ndarray, alt_idx: np.ndarray) -> np.ndarray:
        """mut/(wt+mut) per locus; NaN where wt+mut == 0 (Pileup.h:83-91)."""
        n = len(self.counts)
        wt = self.counts[np.arange(n), ref_idx]
        mut = self.counts[np.arange(n), alt_idx]
        with np.errstate(divide="ignore", invalid="ignore"):
            return mut / (wt + mut)


BASE2IDX = {b"A": 0, b"C": 1, b"G": 2, b"T": 3}


def base_index(seq: bytes) -> int:
    return BASE2IDX.get(seq, -1)


def record_keys(batch: BamBatch, include_not_properly_paired: bool) -> np.ndarray:
    """Each record's key for the pileup: its ``ref_id`` where the flag
    filter keeps it (not secondary, supplementary, duplicate or unmapped
    and, unless ``include_not_properly_paired``, properly paired), else
    -1."""
    sel = (batch.flag & _DROPPED) == 0
    if not include_not_properly_paired:
        sel &= (batch.flag & FLAG_PROPER_PAIR) != 0
    return np.where(sel, batch.ref_id, -1).astype(np.int32)


def pileup_at_positions(bam_file: str, chr_nums: np.ndarray, positions: np.ndarray,
                        min_mapq: int = 1, include_not_properly_paired: bool = False,
                        min_baseq: int = 0, count_fragments: bool = False,
                        reader: BamReader | None = None,
                        track_mapq0: bool = False) -> PileupResult:
    """Pileup base counts at the given loci.

    chr_nums: [N] chromosome numbers, positions: [N] 1-based positions.
    Loci need not be sorted; the engine sorts them and puts the counts back
    in their order.
    """
    n = len(positions)
    result = PileupResult(n)
    if n == 0:
        return result

    own_reader = reader is None
    if own_reader:
        reader = BamReader(bam_file)
    ref_num = np.array([Chromosome(nm).num for nm in reader.ref_names], dtype=np.int64)
    engine = DevicePileup(chr_nums, positions, ref_num, track_mapq0,
                          device="cpu" if count_fragments else None)
    frag_best: dict = {}
    for batch in prefetch(reader, depth=2):
        keys = record_keys(batch, include_not_properly_paired)
        reach = engine.reaching(batch.pos, batch.end_positions(), keys)
        if not reach.all():  # only the records that reach a locus go up
            if not reach.any():
                continue
            batch, keys = batch.subset(reach), keys[reach]
        rec = upload_records(batch.pos, keys, batch.cigar_off, batch.cigar, batch.seq_off,
                             batch.qual, seq=batch.seq, mapq=batch.mapq, device=engine.device)
        if count_fragments:
            _count_fragments(batch, rec, engine, min_mapq, min_baseq, frag_best,
                             result.counts)
            if not track_mapq0:
                continue
        engine.add(rec, min_mapq, min_baseq)
    if own_reader:  # the prefetch thread has finished with it
        reader.close()
    got = engine.finalize()

    if count_fragments:  # no deletion counts, as in the JAX package
        for (_name, snp_idx), (code, _q) in frag_best.items():
            result.counts[snp_idx, code] += 1
    else:
        result.counts, result.dels = got["counts"], got["dels"]
    if track_mapq0:
        result.mapped, result.mapq0 = got["mapped"], got["mapq0"]
    return result


def _count_fragments(batch: BamBatch, rec, engine: DevicePileup, min_mapq: int,
                     min_baseq: int, frag_best: dict, counts: np.ndarray):
    """The reference's fragment dedup over one batch's bases at the loci
    (``pileup_hits``, in record order), on the host: the first read of a
    name at a locus waits in ``frag_best``; the second replaces its base
    only when it differs and has the higher quality."""
    records, loci, base, qual = (t.numpy() for t in pileup_hits(
        rec, engine.loci, engine.table, min_mapq, min_baseq))
    is_base = base < DELETION
    for r, j, code, q in zip(records[is_base].tolist(), engine.order[loci[is_base]].tolist(),
                             base[is_base].tolist(), qual[is_base].tolist()):
        key = (batch.name(r), j)
        if key in frag_best:
            # reference: first read already counted; second read of the pair
            # replaces it only when higher quality
            prev_code, prev_q = frag_best.pop(key)
            if prev_code != code and prev_q < q:
                counts[j, code] += 1
            else:
                counts[j, prev_code] += 1
        else:
            frag_best[key] = (code, q)
