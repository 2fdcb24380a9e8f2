"""Batched pileup engine: base counts and indels at SNP positions.

Counterpart of ``PileupResult``, ``pileup_at_positions`` and
``indel_pileup_at_positions`` in ``ngsbits_tpu/qc/pileup.py``. One
sequential sweep of the BAM (the JAX package's route without an index: the
same counts; the BAI route is not ported), its batches decoded on a prefetch thread. For each batch the host
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
a reference (``ref_id`` -1) counts nowhere.

The indels (``indel_window``, and ``indel_pileup_at_positions``, which asks
for nothing else) come from the same sweep and the same upload: B1's indel
form (``pileup_indels_into``) finds each I and D op within the window of a
locus on the card, at the loci the pre-filter found the batch can reach,
and hands back its (record, locus, query offset, CIGAR word) in one
non-blocking copy a batch; the host waits for a batch's copy only after it
has launched the next batch (or at the end of the sweep), then keys each hit
from its own copy of that batch, kept until then, ``+`` and the inserted
bases or ``-`` and the deleted length, and counts it into the locus' dict.
The JAX package sweeps the BAM twice for the two (VcfMerge's re-calling)
and loops over every I and D op in Python. The pre-filter then keeps a
record whose span, widened by the window on each side and one more base on
the right, holds a locus. An insertion whose bases
lie past its record's SEQ counts nowhere, where the JAX package keys it with
the next record's bases (``ROADMAP.md`` F11); a deletion needs no bases.

The variant-details path's indel regions (``regions``: the JAX package's
``get_indels``, ``ngsbits_tpu/qc/variant_details.py:115-216``, a second
sweep there) come from the same sweep and upload too: the pre-filter also
keeps a record that may overlap a region (``DeviceRegions.reaching``), B1's
region form (``pileup_regions_into``) counts each region's reads, MAPQ-0
reads and spanning depth on the card and hands back each I and D op inside
a spanned region, and the host keys those hits a launch later
(``RegionKeys``: ``+`` and the bases, ``-`` and the reference's bases). With
``count_fragments`` the regions are counted on the host, from the plain
version's pairs in record order and the JAX package's name dedup
(``RegionFragments``).

Behavioral reference: ngs-bits BamReader::getPileup (cppNGS/BamReader.cpp:
809-878): skip secondary/supplementary/duplicate/unmapped; optionally require
properly-paired; mapq>=min_mapq; base at position extracted by CIGAR walk
(M/=/X only — deletions/skips don't contribute A/C/G/T counts);
optional fragment dedup by read name (disagreeing pair bases: higher quality
wins, base-vs-deletion removes both).
"""

from __future__ import annotations

import time

import numpy as np

from ..core.chromosome import Chromosome
from ..io.bam import (SEQ_NIBBLE_ASCII, BamBatch, BamReader, FLAG_DUPLICATE,
                      FLAG_PROPER_PAIR, FLAG_SECONDARY, FLAG_SUPPLEMENTARY, FLAG_UNMAPPED)
from ..ops.device_reduce import (DELETION, DevicePileup, DeviceRegions, count_indel_ops,
                                 pileup_hits, pileup_region_pairs, upload_records)
from ..utils.prefetch import prefetch

_DROPPED = FLAG_SECONDARY | FLAG_SUPPLEMENTARY | FLAG_DUPLICATE | FLAG_UNMAPPED


class PileupResult:
    """counts[N, 4] = A/C/G/T counts per locus (same order as input loci);
    dels[N] = deletion ('-') counts (Pileup::incDel); with an indel window
    ``indels[N]``, each locus' dict of ``+SEQ``/``-LEN`` bytes to counts."""

    def __init__(self, n: int):
        self.counts = np.zeros((n, 4), dtype=np.int64)
        self.dels = np.zeros(n, dtype=np.int64)
        self.indels: list[dict] | None = None
        # filled when track_mapq0=True: flag-passing reads overlapping each
        # locus, and how many of them have mapq 0 (BamReader::getPileup
        # reads_mapped/reads_mapq0)
        self.mapped = np.zeros(n, dtype=np.int64)
        self.mapq0 = np.zeros(n, dtype=np.int64)
        self.regions: RegionCounts | None = None

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


class RegionCounts:
    """Each indel region's flag-passing reads that overlap it (``mapped``),
    those of MAPQ 0 (``mapq0``), its depth (the reads of MAPQ above 0 that
    span it, less those whose N op covers it; with ``count_fragments`` less
    the second read of each fragment) and its ``indels``: a list a region of
    ``+SEQ`` and ``-REFSEQ`` bytes in BAM order, then CIGAR order (the JAX
    package's ``get_indels``)."""

    def __init__(self, n: int):
        self.mapped = np.zeros(n, dtype=np.int64)
        self.mapq0 = np.zeros(n, dtype=np.int64)
        self.depth = np.zeros(n, dtype=np.int64)
        self.indels: list[list[bytes]] = [[] for _ in range(n)]


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
                        track_mapq0: bool = False,
                        indel_window: int | None = None,
                        stats: dict | None = None, regions: list | None = None,
                        fasta=None) -> PileupResult:
    """Pileup base counts at the given loci.

    chr_nums: [N] chromosome numbers, positions: [N] 1-based positions.
    Loci need not be sorted; the engine sorts them and puts the counts back
    in their order. With ``indel_window`` the same sweep also fills
    ``indels`` as ``indel_pileup_at_positions`` does (not with
    ``count_fragments``: no caller asks for both). With ``regions``
    (``(Chromosome, start, end)`` each, 1-based inclusive) it also fills
    ``regions`` (``RegionCounts``: the variant-details path's indel regions,
    their deletions keyed from ``fasta``; no MAPQ or base-quality cut).
    ``stats`` (optional) gains the host seconds of the sweep (``sweep``:
    decode wait, filter, upload, the indels' keys) and of the engines'
    launches and fetches (``fetch``: the launches, the waits for the indel
    and region forms' copies, the counters' fetch once).
    """
    if indel_window is not None and count_fragments:
        raise ValueError("the indel pileup does not count fragments")
    return _sweep(bam_file, chr_nums, positions, reader, min_mapq=min_mapq,
                  include_not_properly_paired=include_not_properly_paired, min_baseq=min_baseq,
                  count_fragments=count_fragments, track_mapq0=track_mapq0,
                  indel_window=indel_window, count_bases=True, stats=stats,
                  regions=regions, fasta=fasta)


def indel_pileup_at_positions(bam_file: str, chr_nums: np.ndarray, positions: np.ndarray,
                              window: int = 1, min_mapq: int = 1,
                              include_not_properly_paired: bool = False,
                              stats: dict | None = None) -> list[dict]:
    """Indel sequences at the given loci, per locus as a dict
    '+SEQ'/'-LEN' -> count.

    Behavioral reference: BamAlignment::extractIndelsByCIGAR
    (cppNGS/BamReader.cpp:375-438): an I op at genome offset g (1-based start
    + consumed M/D/N) is reported when |g - pos| <= window as '+<inserted
    bases>'; a D op as '-<len>'. Window 0 means exact position only. The
    sweep launches B1's indel form alone: no base counts. ``stats`` as for
    ``pileup_at_positions``.
    """
    return _sweep(bam_file, chr_nums, positions, None, min_mapq=min_mapq,
                  include_not_properly_paired=include_not_properly_paired, min_baseq=0,
                  count_fragments=False, track_mapq0=False, indel_window=window,
                  count_bases=False, stats=stats).indels


def _sweep(bam_file: str, chr_nums: np.ndarray, positions: np.ndarray,
           reader: BamReader | None, *, min_mapq: int, include_not_properly_paired: bool,
           min_baseq: int, count_fragments: bool, track_mapq0: bool,
           indel_window: int | None, count_bases: bool, stats: dict | None,
           regions: list | None = None, fasta=None) -> PileupResult:
    """One sweep of the BAM (without ``count_bases``: the indels alone, no
    B1 record form launched). With ``regions`` (``(Chromosome, start, end)``
    a region, 1-based inclusive) the same sweep fills ``result.regions``
    (B1's region form, ``DeviceRegions``; its deletions keyed from
    ``fasta``); the regions take no MAPQ or base-quality cut. With
    ``count_fragments`` both the loci's bases and the regions are counted on
    the host, from the plain versions on the CPU."""
    t0, in_engine = time.perf_counter(), 0.0
    n = len(positions)
    n_reg = 0 if regions is None else len(regions)
    result = PileupResult(n)
    if indel_window is not None:
        result.indels = [dict() for _ in range(n)]
    if regions is not None:
        result.regions = RegionCounts(n_reg)
    if n == 0 and n_reg == 0:
        return result

    own_reader = reader is None
    if own_reader:
        reader = BamReader(bam_file)
    ref_num = np.array([Chromosome(nm).num for nm in reader.ref_names], dtype=np.int64)
    device = "cpu" if count_fragments else None
    engine = (DevicePileup(chr_nums, positions, ref_num, track_mapq0, device=device,
                           indel_window=indel_window, count_bases=count_bases) if n else None)
    spans = None if not n_reg else DeviceRegions(
        np.array([c.num for c, _, _ in regions], dtype=np.int64),
        np.array([s for _, s, _ in regions], dtype=np.int64),
        np.array([e for _, _, e in regions], dtype=np.int64), ref_num, device=device)
    keys_of = RegionKeys(regions, fasta) if n_reg else None
    frag_best: dict = {}
    frag_regions = RegionFragments(n_reg) if count_fragments and n_reg else None
    # the last launches' batch and hits, keyed after the next launch
    pending: list = []

    def key_pending():
        nonlocal in_engine
        for keyer, held, got in pending:
            t = time.perf_counter()
            hits = got.hits()  # the copy was queued a launch ago: no wait on the newest batch
            in_engine += time.perf_counter() - t
            if hits.shape[0]:
                keyer(held, hits.numpy())
        pending.clear()

    def key_indels(held, hits):
        _count_indels(held, hits, engine.order, result.indels)

    def key_regions(held, hits):
        keys_of.add_hits(held, hits, spans.order, result.regions.indels)

    for batch in prefetch(reader, depth=2):
        keys = record_keys(batch, include_not_properly_paired)
        ends = batch.end_positions()
        reach, loci_range = (engine.reaching(batch.pos, ends, keys) if engine is not None
                             else (np.zeros(len(keys), dtype=bool), None))
        to_loci, to_regions, regions_range = bool(reach.any()), False, None
        if spans is not None:
            near, regions_range = spans.reaching(batch.pos, ends, keys)
            reach, to_regions = reach | near, bool(near.any())
        if not reach.all():  # only the records that reach a locus or region go up
            if not reach.any():
                continue
            batch, keys = batch.subset(reach), keys[reach]
        bases = engine is not None
        rec = upload_records(batch.pos, keys, batch.cigar_off, batch.cigar,
                             batch.seq_off if bases else None, batch.qual if bases else None,
                             seq=batch.seq if bases else None, mapq=batch.mapq,
                             device=(engine if engine is not None else spans).device)
        if count_fragments:
            if engine is not None:
                _count_fragments(batch, rec, engine, min_mapq, min_baseq, frag_best,
                                 result.counts)
                if track_mapq0:
                    engine.add(rec, min_mapq, min_baseq)
            if frag_regions is not None:
                frag_regions.add(batch, rec, spans, keys_of, result.regions)
            continue
        t1 = time.perf_counter()
        launched = []
        if to_loci:
            got = engine.add(rec, min_mapq, min_baseq,
                             count_indel_ops(batch.cigar) if indel_window is not None else 0,
                             loci_range)
            if got is not None:
                launched.append((key_indels, batch, got))
        if to_regions:
            launched.append((key_regions, batch, spans.add(rec, count_indel_ops(batch.cigar),
                                                           regions_range)))
        in_engine += time.perf_counter() - t1
        if launched:
            key_pending()
            pending.extend(launched)
    key_pending()
    if own_reader:  # the prefetch thread has finished with it
        reader.close()
    t1 = time.perf_counter()
    got = engine.finalize() if engine is not None else {}
    if spans is not None:
        if frag_regions is not None:
            frag_regions.finish(result.regions)
        else:
            for name, values in spans.finalize().items():
                setattr(result.regions, name, values)
    if stats is not None:
        stats["sweep"] = stats.get("sweep", 0.0) + t1 - t0 - in_engine
        stats["fetch"] = stats.get("fetch", 0.0) + in_engine + time.perf_counter() - t1

    if engine is None:
        return result
    if count_fragments:  # no deletion counts, as in the JAX package
        for (_name, snp_idx), (code, _q) in frag_best.items():
            result.counts[snp_idx, code] += 1
    elif count_bases:
        result.counts, result.dels = got["counts"], got["dels"]
    if track_mapq0:
        result.mapped, result.mapq0 = got["mapped"], got["mapq0"]
    return result


def _count_indels(batch: BamBatch, hits: np.ndarray, order: np.ndarray, indels: list[dict]):
    """Counts a batch's indel hits (record, sorted locus, query offset,
    CIGAR word) into each locus' dict, keyed from the host's copy of the
    batch: ``+`` and the inserted bases of an I op, ``-`` and the length of
    a D op. Sorted first, so the dicts fill in the same order on every
    route."""
    hits = hits[np.lexsort((hits[:, 1], hits[:, 2], hits[:, 0]))]
    seq_off = batch.seq_off
    for r, j, q, word in hits.tolist():
        length = word >> 4
        if word & 0xF == 1:
            s = int(seq_off[r]) + q
            key = b"+" + SEQ_NIBBLE_ASCII[batch.seq[s:s + length]].tobytes()
        else:
            key = b"-%d" % length
        d = indels[order[j]]
        d[key] = d.get(key, 0) + 1


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


class RegionKeys:
    """Keys the region form's hits from the host's copy of their batch: an I
    op as ``+`` and its bases (those within its record's SEQ: an insertion
    past it keeps the bases its record holds, where the JAX package reads
    the next record's, ``ROADMAP.md`` F13), a D op as ``-`` and the
    reference's bases at ``g`` (``-`` alone where the FASTA has none there),
    each reference read once a ``(chromosome, g, length)``."""

    def __init__(self, regions: list, fasta):
        self.regions, self.fasta = regions, fasta
        self.cache: dict = {}

    def key(self, batch: BamBatch, region: int, record: int, q_at: int, word: int,
            g: int) -> bytes:
        length = word >> 4
        if word & 0xF == 1:
            s = int(batch.seq_off[record]) + q_at
            last = min(s + length, int(batch.seq_off[record + 1]))
            return b"+" + SEQ_NIBBLE_ASCII[batch.seq[s:last]].tobytes()
        chr_ = self.regions[region][0]
        at = (chr_.num, g, length)
        ref = self.cache.get(at)
        if ref is None:
            try:
                ref = self.fasta.seq(chr_, g, length, True)
            except Exception:  # noqa: BLE001 — the JAX package's _seq: any failure is no bases
                ref = b""
            self.cache[at] = ref
        return b"-" + ref

    def add_hits(self, batch: BamBatch, hits: np.ndarray, order: np.ndarray,
                 indels: list[list[bytes]]):
        """Appends a batch's hits (record, sorted region, query offset,
        CIGAR index, g) to each region's list, sorted by record and CIGAR
        index first: BAM order, then CIGAR order, on every route."""
        hits = hits[np.lexsort((hits[:, 1], hits[:, 3], hits[:, 0]))]
        cigar = batch.cigar
        for r, j, q, c, g in hits.tolist():
            k = int(order[j])
            indels[k].append(self.key(batch, k, r, q, int(cigar[c]), g))


class RegionFragments:
    """The region form's fragment route (``count_fragments``), on the host:
    the plain version's (record, region) pairs and hits in record order, and
    the JAX package's name dedup (``ngsbits_tpu/qc/variant_details.py:
    197-208``): a region's second read of a name takes 1 off its depth, or 2
    and its first read's last indel where the two reads' last indels
    differ, else its own last indel."""

    def __init__(self, n: int):
        self.read_names: list[dict] = [dict() for _ in range(n)]
        self.to_remove: list[list[int]] = [[] for _ in range(n)]

    def add(self, batch: BamBatch, rec, spans: DeviceRegions, keys: RegionKeys,
            out: RegionCounts):
        pairs, spanning, hits = (t.numpy() for t in pileup_region_pairs(
            rec, spans.regions, spans.table))
        order = spans.order
        np.add.at(out.mapped, order[pairs[:, 1]], 1)
        np.add.at(out.mapq0, order[pairs[:, 1]], pairs[:, 2])
        h = 0  # the hits come in order of pair, then op
        for (r, j, _zero, delta), spans_it in zip(pairs.tolist(), spanning.tolist()):
            if not spans_it:
                continue
            k = int(order[j])
            res = out.indels[k]
            read_variant, indel_idx = b"NONE", -1
            while h < len(hits) and hits[h, 0] == r and hits[h, 1] == j:
                _, _, q, c, g = hits[h].tolist()
                read_variant = keys.key(batch, k, r, q, int(batch.cigar[c]), g)
                indel_idx = len(res)
                res.append(read_variant)
                h += 1
            out.depth[k] += delta
            name = batch.name(r)
            names = self.read_names[k]
            if name in names:
                prev_var, prev_idx = names.pop(name)
                if prev_var != read_variant:
                    out.depth[k] -= 2
                    self.to_remove[k].append(prev_idx)
                else:
                    out.depth[k] -= 1
                    self.to_remove[k].append(indel_idx)
            else:
                names[name] = (read_variant, indel_idx)

    def finish(self, out: RegionCounts):
        for k, res in enumerate(out.indels):
            for idx in sorted(self.to_remove[k], reverse=True):
                if idx == -1:
                    continue
                del res[idx]
