"""Seeded synthetic inputs: single reads for ReadQC, read pairs for
SeqPurge, and a genome, a target panel and coordinate-sorted read pairs (BAM)
for MappingQC; for the coverage tools also a dense panel and a whole-genome
panel at GRCh38's chromosome lengths; single-sample VCFs for
SampleSimilarity; a trio's germline SNVs and indels (``trio_variants``) with
a single-sample VCF each (``trio_vcfs``) for VcfMerge and
TrioMaternalContamination; for the variant-details tools a GSvar made from
a VCF (``vcf_gsvar``), a VCF bgzipped with a tabix index (``bgzip_tabix``)
and a PRS VCF (``prs_vcf``); for SomaticQC a tumor/normal pair's somatic
variants (``somatic_variants``: the tumor BAM takes its SNVs through
``synth_bam``'s ``somatic``) and a somatic VCF in each FORMAT flavour the
plots read (``somatic_vcf``); for RnaQC its splicing and expression TSVs
(``rna_tsvs``); for VariantQC and RohHunter a WGS-shaped single-sample VCF
with a VEP CSQ, phase blocks and planted ROH segments (``wgs_vcf``) and
RohHunter's exclude and annotation BEDs (``roh_beds``), and a small VCF of
homozygous runs whose AF may be +inf or NaN (``roh_af_vcf``). Everything is drawn
from a numpy seed;
the BAM writer is the port's own (BGZF with zlib), so nothing here needs
another package."""

from __future__ import annotations

import gzip
import struct
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..io import bgzf
from ..io.bam import BamBatch

# the default adapters of SeqPurge (Illumina TruSeq)
ADAPTER1 = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
ADAPTER2 = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMPLEMENT = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMPLEMENT[_a] = _b


def _records(names: np.ndarray, bases: np.ndarray, quals: np.ndarray) -> bytes:
    """FASTQ text of fixed-width records: ``names`` [n, h] (with '@'),
    ``bases``/``quals`` [n, L], all uint8."""
    n, h = names.shape
    L = bases.shape[1]
    m = np.empty((n, h + 2 * L + 5), dtype=np.uint8)
    m[:, :h] = names
    m[:, h] = 10
    m[:, h + 1: h + 1 + L] = bases
    m[:, h + 1 + L: h + 4 + L] = np.frombuffer(b"\n+\n", dtype=np.uint8)
    m[:, h + 4 + L: h + 4 + 2 * L] = quals
    m[:, -1] = 10
    return m.tobytes()


def synth_pairs(path1: Path, path2: Path, n_pairs: int, seed: int,
                read_len: int = 151, a1: bytes = ADAPTER1,
                a2: bytes = ADAPTER2):
    """Paired FASTQ as a short-insert library gives SeqPurge: fragments of a
    fixed 5 Mb synthetic genome, insert length drawn around 200 bp (sd 70,
    clipped to 40-600), so a large share of pairs read into the adapter.
    Read 1 is the fragment, then ``a1``, then random bases; read 2 the
    reverse complement of the fragment, then ``a2``, then random bases; both
    cut to ``read_len``. Then ~0.5% substitutions, ~0.05% single Ns, a run
    of 8 Ns in one read of 500, and qualities on a falling curve (Q38 at the
    start to Q24 at the end, with per-read jitter), a fifth of the reads
    ending in a low-quality tail that quality trimming removes; N calls get
    Q2. Headers end in /1 and /2. gzip level 1, one member per file."""
    rng = np.random.default_rng(seed)
    chunk = 250_000
    L = read_len
    genome = _ACGT[rng.integers(0, 4, size=5_000_000)]
    cols = np.arange(L)
    curve = (38 - (cols * 14) // max(L - 1, 1)).astype(np.int8)
    # each file compresses on its own thread (zlib releases the GIL) while
    # the next chunk is drawn
    with open(path1, "wb") as raw1, open(path2, "wb") as raw2, \
            ThreadPoolExecutor(max_workers=2) as pool:
        gz1 = gzip.GzipFile(fileobj=raw1, mode="wb", compresslevel=1, mtime=0)
        gz2 = gzip.GzipFile(fileobj=raw2, mode="wb", compresslevel=1, mtime=0)
        writes = []
        done = 0
        while done < n_pairs:
            n = min(chunk, n_pairs - done)
            insert = np.clip(np.rint(rng.normal(200, 70, size=n)), 40, 600).astype(np.int64)
            start = rng.integers(0, len(genome) - 600, size=n)
            inside = cols[None, :] < insert[:, None]
            past = np.maximum(cols[None, :] - insert[:, None], 0)
            reads = []
            for adapter, forward in ((a1, True), (a2, False)):
                tail = _ACGT[rng.integers(0, 4, size=(n, L), dtype=np.uint8)]
                k = min(len(adapter), L)
                tail[:, :k] = np.frombuffer(adapter, dtype=np.uint8)[:k]
                tail = np.take_along_axis(tail, past, axis=1)
                if forward:
                    frag = genome[start[:, None] + np.minimum(cols[None, :], insert[:, None] - 1)]
                else:
                    frag = _COMPLEMENT[genome[start[:, None] + np.maximum(
                        insert[:, None] - 1 - cols[None, :], 0)]]
                bases = np.where(inside, frag, tail).reshape(-1)
                sub = rng.integers(0, n * L, size=int(rng.binomial(n * L, 0.005)))
                bases[sub] = _ACGT[rng.integers(0, 4, size=len(sub))]
                q = (curve[None, :] + rng.integers(-3, 4, size=(n, 1), dtype=np.int8)
                     + rng.integers(-2, 3, size=(n, L), dtype=np.int8))
                tail_from = np.where(rng.random(size=n) < 0.2,
                                     L - rng.integers(10, 50, size=n), L)
                drop = cols[None, :] >= tail_from[:, None]
                q[drop] = rng.integers(2, 12, size=int(drop.sum()), dtype=np.int8)
                q = q.reshape(-1)
                is_n = rng.integers(0, n * L, size=int(rng.binomial(n * L, 0.0005)))
                run = np.flatnonzero(rng.random(size=n) < 0.002)
                run_at = run * L + rng.integers(0, L - 8, size=len(run))
                is_n = np.concatenate([is_n, (run_at[:, None] + np.arange(8)).reshape(-1)])
                bases[is_n] = ord("N")
                q[is_n] = 2
                quals = (np.clip(q, 2, 41) + 33).astype(np.uint8)
                reads.append((bases.reshape(n, L), quals.reshape(n, L)))
            for w in writes:
                w.result()
            writes = []
            for gz, mate, (bases, quals) in ((gz1, 1, reads[0]), (gz2, 2, reads[1])):
                names = "".join(f"@p{done + i:010d}/{mate}" for i in range(n))
                names = np.frombuffer(names.encode(), dtype=np.uint8).reshape(n, -1)
                writes.append(pool.submit(gz.write, _records(names, bases, quals)))
            done += n
        for w in writes:
            w.result()
        gz1.close()
        gz2.close()


def synth_fastq(path: Path, n_reads: int, read_len: int, seed: int):
    """Synthetic FASTQ with realistic compressibility: reads are windows of a
    fixed 5 Mb genome with ~0.5% mismatches, qualities a smooth per-cycle
    curve with small per-read jitter; gzip level 1, one member."""
    rng = np.random.default_rng(seed)
    chunk = 250_000
    hdr_w = 12  # "@r0000000000"
    rec_len = hdr_w + 1 + read_len + 1 + 2 + read_len + 1
    bases_lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = bases_lut[rng.integers(0, 4, size=5_000_000)]
    gwin = np.lib.stride_tricks.sliding_window_view(genome, read_len)
    qual_curve = np.clip(
        70 - (np.arange(read_len) * 12) // read_len
        + rng.integers(-2, 3, size=read_len), 35, 73).astype(np.uint8)
    with open(path, "wb") as raw:
        gz = gzip.GzipFile(fileobj=raw, mode="wb", compresslevel=1, mtime=0)
        written = 0
        while written < n_reads:
            n = min(chunk, n_reads - written)
            m = np.zeros((n, rec_len), dtype=np.uint8)
            headers = "".join(f"@r{written + i:010d}" for i in range(n))
            m[:, :hdr_w] = np.frombuffer(headers.encode(), dtype=np.uint8).reshape(n, hdr_w)
            m[:, hdr_w] = 10
            reads = gwin[rng.integers(0, len(gwin), size=n)].copy()
            mut = rng.random(size=reads.shape) < 0.005
            reads[mut] = bases_lut[rng.integers(0, 4, size=int(mut.sum()))]
            m[:, hdr_w + 1: hdr_w + 1 + read_len] = reads
            m[:, hdr_w + 1 + read_len] = 10
            m[:, hdr_w + 2 + read_len] = ord("+")
            m[:, hdr_w + 3 + read_len] = 10
            quals = np.clip(qual_curve[None, :].astype(np.int16)
                            + rng.integers(-1, 2, size=(n, 1)), 33, 73)
            m[:, hdr_w + 4 + read_len: hdr_w + 4 + 2 * read_len] = quals.astype(np.uint8)
            m[:, -1] = 10
            gz.write(m.tobytes())
            written += n
        gz.close()


# ---------------------------------------------------------------- MappingQC

@dataclass
class Genome:
    """Chromosomes of a synthetic genome, all in one ASCII array."""
    names: list[str]
    lengths: np.ndarray    # int64 [n]
    offsets: np.ndarray    # int64 [n + 1] into seq
    seq: np.ndarray        # uint8 ASCII


GAP = 1000  # each chromosome starts with this many N (a telomere-like gap)


def synth_genome(path: Path, lengths: dict[str, int], seed: int,
                 set_bases=None) -> Genome:
    """A FASTA of uniform random ACGT, 60 bases a line, each chromosome
    starting with ``GAP`` N, and its ``.fai``. ``set_bases`` is an iterable
    of (name, 1-based positions, ASCII bases) written over the random bases
    (the reference alleles of known SNPs)."""
    rng = np.random.default_rng(seed)
    names = list(lengths)
    lens = np.array([lengths[n] for n in names], dtype=np.int64)
    offsets = np.concatenate(([0], np.cumsum(lens)))
    seq = _ACGT[rng.integers(0, 4, size=int(offsets[-1]), dtype=np.uint8)]
    for k in range(len(names)):
        seq[offsets[k]:offsets[k] + min(GAP, int(lens[k]) // 10)] = ord("N")
    index = {n: k for k, n in enumerate(names)}
    for name, pos, bases in set_bases or ():
        if name in index:
            k = index[name]
            pos = np.asarray(pos, dtype=np.int64)
            ok = (pos >= 1) & (pos <= lens[k])
            seq[offsets[k] + pos[ok] - 1] = np.asarray(bases, dtype=np.uint8)[ok]
    fai = []
    with open(path, "wb") as fh:
        at = 0
        for k, name in enumerate(names):
            head = f">{name}\n".encode()
            fh.write(head)
            at += len(head)
            fai.append(f"{name}\t{lens[k]}\t{at}\t60\t61\n")
            chrom = seq[offsets[k]:offsets[k + 1]]
            full = len(chrom) // 60
            rows = np.empty((full, 61), dtype=np.uint8)
            rows[:, :60] = chrom[:full * 60].reshape(full, 60)
            rows[:, 60] = 10
            body = rows.tobytes()
            if len(chrom) % 60:
                body += chrom[full * 60:].tobytes() + b"\n"
            fh.write(body)
            at += len(body)
    Path(str(path) + ".fai").write_text("".join(fai))
    return Genome(names, lens, offsets, seq)


def known_snvs(lengths: dict[str, int], build: str = "hg38"):
    """The bundled known SNVs (single-base REF and ALT, one allele) that lie
    on the chromosomes of ``lengths`` within their length: (chromosome
    indices into ``lengths``, 1-based positions, ASCII REF, ASCII ALT, AF),
    in file order."""
    from ..core.resources import _known_snps_vcf
    v = _known_snps_vcf(build)
    index = {n.encode(): k for k, n in enumerate(lengths)}
    limit = [lengths[n] for n in lengths]
    keep = [i for i in range(len(v))
            if v.chr_strs[i] in index and v.pos[i] <= limit[index[v.chr_strs[i]]]
            and len(v.refs[i]) == 1 and len(v.alts[i]) == 1]
    chrom = np.array([index[v.chr_strs[i]] for i in keep], dtype=np.int64)
    pos = v.pos[keep].astype(np.int64)
    ref = np.array([v.refs[i][0] for i in keep], dtype=np.uint8)
    alt = np.array([v.alts[i][0] for i in keep], dtype=np.uint8)
    af = np.array([float(v[i].info("AF") or 0.0) for i in keep])
    return chrom, pos, ref, alt, af


def synth_roi(path: Path, genome: Genome, n_regions: int, seed: int,
              anchors=None, min_len: int = 100, max_len: int = 400):
    """A BED panel of ``n_regions`` exon-like regions of ``min_len`` to
    ``max_len`` bases: one around each anchor (``(chromosome indices,
    0-based positions)``, e.g. known SNPs), the rest at random, weighted by
    chromosome length. Regions may overlap (the tool merges them). Returns
    (chromosome index, 0-based start, exclusive end), sorted."""
    rng = np.random.default_rng(seed)
    width = rng.integers(min_len, max_len + 1, size=n_regions)
    chrom = rng.choice(len(genome.names), size=n_regions,
                       p=genome.lengths / genome.lengths.sum())
    room = genome.lengths[chrom] - GAP - width - 1
    start = GAP + rng.integers(0, 1 << 62, size=n_regions) % room
    if anchors is not None:
        a_chr, a_pos = (np.asarray(x, dtype=np.int64)[:n_regions] for x in anchors)
        k = len(a_chr)
        chrom[:k] = a_chr
        start[:k] = np.clip(a_pos - rng.integers(10, width[:k] - 10),
                            GAP, genome.lengths[a_chr] - width[:k] - 1)
    end = start + width
    order = np.lexsort((start, chrom))
    chrom, start, end = chrom[order], start[order], end[order]
    Path(path).write_text("".join(f"{genome.names[c]}\t{s}\t{e}\n"
                                  for c, s, e in zip(chrom, start, end)))
    return chrom, start, end


# GRCh38's primary chromosomes and their lengths (the assembly's .fai)
GRCH38_LENGTHS = {
    "chr1": 248_956_422, "chr2": 242_193_529, "chr3": 198_295_559,
    "chr4": 190_214_555, "chr5": 181_538_259, "chr6": 170_805_979,
    "chr7": 159_345_973, "chr8": 145_138_636, "chr9": 138_394_717,
    "chr10": 133_797_422, "chr11": 135_086_622, "chr12": 133_275_309,
    "chr13": 114_364_328, "chr14": 107_043_718, "chr15": 101_991_189,
    "chr16": 90_338_345, "chr17": 83_257_441, "chr18": 80_373_285,
    "chr19": 58_617_616, "chr20": 64_444_167, "chr21": 46_709_983,
    "chr22": 50_818_468, "chrX": 156_040_895, "chrY": 57_227_415,
}


def synth_dense_panel(path: Path, lengths: dict[str, int], seed: int,
                      min_len: int = 1_000, max_len: int = 50_000):
    """A BED panel of regions of ``min_len`` to ``max_len`` bases, on each
    chromosome of ``lengths`` from ``GAP`` on, with gaps drawn from the same
    range between them: about half of each chromosome is covered. Returns
    (chromosome index, 0-based start, exclusive end), sorted."""
    rng = np.random.default_rng(seed)
    rows = []
    for k, name in enumerate(lengths):
        at = GAP
        while True:
            start = at + int(rng.integers(min_len, max_len + 1))
            end = start + int(rng.integers(min_len, max_len + 1))
            if end > lengths[name]:
                break
            rows.append((k, start, end))
            at = end
    chrom, start, end = (np.array(c, dtype=np.int64) for c in zip(*rows))
    Path(path).write_text("".join(f"{list(lengths)[c]}\t{s}\t{e}\n"
                                  for c, s, e in zip(chrom, start, end)))
    return chrom, start, end


def whole_genome_panel(path: Path, lengths: dict[str, int] = GRCH38_LENGTHS):
    """A BED panel of one region a chromosome, each its whole length."""
    Path(path).write_text("".join(f"{name}\t0\t{n}\n" for name, n in lengths.items()))


# 4-bit BAM code of an ASCII base
_NIBBLE = np.full(256, 15, dtype=np.uint8)
for _v, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    _NIBBLE[_c] = _v
_QUAL_LUT = np.array([2] * 3 + [12] * 6 + [23] * 17 + [37] * 102, dtype=np.uint8)
_FIXED = np.dtype([("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
                   ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                   ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
                   ("next_ref_id", "<i4"), ("next_pos", "<i4"), ("tlen", "<i4")])
_BGZF_LEVEL = 1      # zlib level of write_bam's blocks
_BGZF_THREADS = 8    # threads compressing write_bam's blocks
_BAM_READ_LEN = 151   # synth_bam's read length
_BAM_ON_TARGET = 0.8  # synth_bam's share of fragments centred in a region
_BAM_CHUNK = 1 << 16  # records synth_bam builds (and draws bases for) at once


def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """SAM spec's reg2bin for 0-based [beg, end)."""
    end = end - 1
    out = np.zeros(len(beg), dtype=np.int64)
    done = np.zeros(len(beg), dtype=bool)
    for shift, first in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = first + (beg[hit] >> shift)
        done |= hit
    return out


def _rows(flat: np.ndarray, starts: np.ndarray, width: int) -> np.ndarray:
    """``[len(starts), width]``: row i is ``flat[starts[i]:starts[i] + width]``."""
    return flat[starts[:, None] + np.arange(width)]


def _encode_records(b: BamBatch) -> bytes:
    """BAM records of a batch (bases as 4-bit codes, one a byte). Records
    with the same field lengths are built together as rows of a matrix;
    the records' rows, each cut to its length, are the output in order."""
    n = len(b)
    l_name = np.diff(b.name_off) + 1
    l_seq = b.l_seq.astype(np.int64)
    n_cig = b.n_cigar.astype(np.int64)
    l_tags = np.diff(b.tags_off)
    size = 36 + l_name + 4 * n_cig + (l_seq + 1) // 2 + l_seq + l_tags
    fixed = np.zeros(n, dtype=_FIXED)
    fixed["block_size"] = size - 4
    fixed["ref_id"] = b.ref_id
    fixed["pos"] = b.pos
    fixed["l_read_name"] = l_name
    fixed["mapq"] = b.mapq
    pos = b.pos.astype(np.int64)
    fixed["bin"] = _reg2bin(pos, np.maximum(b.end_positions(), pos + 1))
    fixed["n_cigar"] = n_cig
    fixed["flag"] = b.flag
    fixed["l_seq"] = l_seq
    fixed["next_ref_id"] = b.mate_ref_id
    fixed["next_pos"] = b.mate_pos
    fixed["tlen"] = b.tlen
    fixed = fixed.view(np.uint8).reshape(n, 36)
    names = np.frombuffer(b.names, dtype=np.uint8)
    cigar = b.cigar.astype("<u4").view(np.uint8)
    mat = np.zeros((n, int(size.max()) if n else 0), dtype=np.uint8)
    shape = np.stack([l_name, n_cig, l_seq, l_tags], axis=1)
    # one int64 key a record for its field lengths (each below 2^16 here)
    key = (((l_name << 16 | n_cig) << 16 | l_seq) << 16 | l_tags
           if (shape < 1 << 16).all() else None)
    if key is None:
        _, group = np.unique(shape, axis=0, return_inverse=True)
    else:
        _, group = np.unique(key, return_inverse=True)
    group = group.reshape(-1)
    order = np.argsort(group, kind="stable")
    bounds = np.flatnonzero(np.diff(group[order])) + 1
    for idx in np.split(order, bounds):
        ln, nc, ls, lt = (int(v) for v in shape[idx[0]])
        seq = _rows(b.seq, b.seq_off[idx], ls)
        if ls % 2:
            seq = np.pad(seq, ((0, 0), (0, 1)))
        parts = [fixed[idx], _rows(names, b.name_off[idx], ln - 1),
                 np.zeros((len(idx), 1), np.uint8),   # the name's NUL
                 _rows(cigar, 4 * b.cigar_off[idx], 4 * nc),
                 (seq[:, 0::2] << 4) | seq[:, 1::2],   # two bases a byte
                 _rows(b.qual, b.seq_off[idx], ls), _rows(b.tags, b.tags_off[idx], lt)]
        block = np.concatenate(parts, axis=1)
        mat[idx, :block.shape[1]] = block
    return mat[np.arange(mat.shape[1])[None, :] < size[:, None]].tobytes()


def _bgzf_block(data: bytes) -> bytes:
    return bgzf.block(data, _BGZF_LEVEL)


def write_bam(path: Path, ref_names: list[str], ref_lengths, batches):
    """A BAM file (BGZF, zlib level 1) of the records in ``batches``
    (``BamBatch``es in file order), with a coordinate-sorted header; blocks
    are compressed on 8 threads."""
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{int(l)}\n" for n, l in zip(ref_names, ref_lengths))
    head = [b"BAM\1", struct.pack("<i", len(text)), text.encode(),
            struct.pack("<i", len(ref_names))]
    for n, l in zip(ref_names, ref_lengths):
        head += [struct.pack("<i", len(n) + 1), n.encode() + b"\0",
                 struct.pack("<i", int(l))]
    pending = b"".join(head)
    with open(path, "wb") as fh, ThreadPoolExecutor(max_workers=_BGZF_THREADS) as pool:
        def flush(data: bytes, final: bool) -> bytes:
            cut = len(data) if final else len(data) - len(data) % bgzf.BLOCK_DATA
            blocks = [data[i:i + bgzf.BLOCK_DATA] for i in range(0, cut, bgzf.BLOCK_DATA)]
            for block in pool.map(_bgzf_block, blocks):
                fh.write(block)
            return data[cut:]

        for batch in batches:
            pending = flush(pending + _encode_records(batch), final=False)
        flush(pending, final=True)
        fh.write(bgzf.EOF_BLOCK)


def _sites_in_reads(at: np.ndarray, start: np.ndarray, rows: np.ndarray, length: int):
    """Each (read, site) pair of the sorted genome offsets ``at`` within
    the reads ``rows`` (``length`` bases from ``start``): the read, the
    site's index and its column in the read."""
    lo = np.searchsorted(at, start[rows])
    hi = np.searchsorted(at, start[rows] + length)
    hits = hi - lo
    row = np.repeat(rows, hits)
    h = np.repeat(lo, hits) + np.arange(int(hits.sum())) - np.repeat(
        np.cumsum(hits) - hits, hits)
    return row, h, at[h] - start[row]


def synth_bam(path: Path, genome: Genome, n_pairs: int, seed: int, roi=None,
              snps=None, dp_tags: bool = False, max_records: int | None = None,
              indels=None, somatic=None, _chunk: int = _BAM_CHUNK):
    """Coordinate-sorted read pairs of ``genome`` as an exome library gives
    MappingQC, written by ``write_bam``:

    - fragments of N(250, 70) bases (clipped to 151..999); 80% centred in
      a region of ``roi`` (``synth_roi``'s return) with N(0, 50) jitter,
      the rest uniform over the genome (chrX and chrY included), read 1
      forward or reverse at random;
    - reads of 151 bases, 93% of them 151M, 2% each a leading or a trailing
      soft clip (5-30 bases) or a deletion (1-5 bases), 1% an insertion (1-4);
    - 8% of the pairs flagged duplicate, 1% not properly paired, 0.5% with
      one mate unmapped (placed at its mate); 3% of the reads MAPQ 0, 5%
      MAPQ 1-59, the rest 60;
    - bases from the genome with 0.3% substitutions and 0.05% N; at ``snps``
      (``(chromosome indices, 0-based positions, ASCII alt alleles)``) 30%
      heterozygous (the alt allele in half of the reads) and 10% homozygous
      alternative, on the reads without clips or indels (with a fourth
      array of genotypes, 1 heterozygous and 2 homozygous, those instead of
      the draw); binned qualities (Q2/Q12/Q23/Q37);
    - at ``indels`` (``(chromosome indices, 0-based positions of the VCF
      base, inserted ASCII bytes (b"" for a deletion), deleted lengths (0
      for an insertion))``, and optionally genotypes as for ``snps``) germline
      insertions and deletions of 1-4 bases after that base: 30%
      heterozygous (on the reads of one haplotype of the pair) and 10%
      homozygous unless genotypes are given, on the reads without clips or
      indels that hold the site at least 5 bases from their start and 10
      from their end (one site a read), which become reads with an I or a D
      op there. Without ``indels`` nothing more is drawn, so every other
      file's bytes are as before;
    - at ``somatic`` (``(chromosome indices, 0-based positions, ASCII alt
      alleles, allele share)``, a tumor's SNVs) the alt allele on a share of
      the reads without clips or indels, in steps of 1/32 (the base's own
      draw decides, so nothing more is drawn and ``somatic=None`` keeps
      every other file's bytes); over a germline SNP of ``snps`` it wins;
    - tags RG:Z, and with ``dp_tags`` a DP:C of 1-5 (cfDNA duplicate counts).

    ``max_records`` writes only the first records of the sorted file: a
    prefix of the same data. ``_chunk`` is how many records are built at
    once; a prefix is the same data only with the same ``_chunk``."""
    rng = np.random.default_rng(seed)
    L = _BAM_READ_LEN
    n = n_pairs
    lens = genome.lengths
    margin = GAP + 100
    insert = np.clip(np.rint(rng.normal(250, 70, size=n)), L, 999).astype(np.int64)
    chrom = rng.choice(len(lens), size=n, p=lens / lens.sum())
    start = margin + rng.integers(0, 1 << 62, size=n) % (lens[chrom] - insert - 2 * margin)
    if roi is not None:
        r_chr, r_start, r_end = (np.asarray(x, dtype=np.int64) for x in roi)
        on = np.flatnonzero(rng.random(n) < _BAM_ON_TARGET)
        w = (r_end - r_start).astype(np.float64)
        r = rng.choice(len(r_chr), size=len(on), p=w / w.sum())
        centre = r_start[r] + rng.integers(0, 1 << 62, size=len(on)) % (r_end[r] - r_start[r])
        chrom[on] = r_chr[r]
        start[on] = np.clip(centre - insert[on] // 2 + np.rint(rng.normal(0, 50, size=len(on))),
                            margin, lens[r_chr[r]] - insert[on] - margin).astype(np.int64)

    # reads 0..n-1 are the pairs' left mates, n..2n-1 their right mates
    m = 2 * n
    pair = np.concatenate([np.arange(n), np.arange(n)])
    left = np.arange(m) < n
    r1_left = rng.random(n) < 0.5
    read1 = np.concatenate([r1_left, ~r1_left])
    cls = rng.choice(5, size=m, p=[0.93, 0.02, 0.02, 0.02, 0.01])
    clip = rng.integers(5, 31, size=m)
    dlen = rng.integers(1, 6, size=m)
    ilen = rng.integers(1, 5, size=m)
    split = rng.integers(30, L - 30, size=m)
    span = np.select([cls == 1, cls == 2, cls == 3, cls == 4],
                     [L - clip, L - clip, L + dlen, L - ilen], L)
    frag_chr = np.concatenate([chrom, chrom])
    pos = np.where(left, np.concatenate([start, start]),
                   np.concatenate([start + insert, start + insert]) - span)
    unmapped = np.zeros(m, dtype=bool)
    um_pair = np.flatnonzero(rng.random(n) < 0.005)
    um_mate = rng.random(len(um_pair)) < 0.5
    unmapped[np.where(um_mate, um_pair, um_pair + n)] = True
    mate = np.concatenate([np.arange(n, m), np.arange(n)])
    pos = np.where(unmapped, pos[mate], pos)
    end = np.where(unmapped, pos, pos + span)
    lo = np.minimum(pos[:n], pos[n:])
    hi = np.maximum(end[:n], end[n:])
    tlen_abs = np.concatenate([hi - lo, hi - lo])
    first = np.where(pos == pos[mate], read1, pos < pos[mate])
    tlen = np.where(first, tlen_abs, -tlen_abs)
    pair_um = unmapped | unmapped[mate]
    tlen[pair_um] = 0
    proper = ~pair_um & np.concatenate([rng.random(n) >= 0.01] * 2)
    dup = np.concatenate([rng.random(n) < 0.08] * 2)
    reverse = ~left
    flag = (0x1 | np.where(proper, 0x2, 0) | np.where(unmapped, 0x4, 0)
            | np.where(unmapped[mate], 0x8, 0) | np.where(reverse, 0x10, 0)
            | np.where(reverse[mate], 0x20, 0) | np.where(read1, 0x40, 0x80)
            | np.where(dup, 0x400, 0)).astype(np.uint16)
    u = rng.random(m)
    mapq = np.where(u < 0.03, 0, np.where(u < 0.08, rng.integers(1, 60, size=m), 60))
    mapq = np.where(unmapped, 0, mapq).astype(np.uint8)
    cls = np.where(unmapped, -1, cls)
    dp = rng.choice(np.array([1, 1, 1, 1, 2, 2, 3, 4, 5]), size=m)

    # variant SNPs in genome coordinates: 30% heterozygous, 10% homozygous
    snp_at = np.zeros(0, np.int64)
    snp_alt = np.zeros(0, np.uint8)
    snp_hom = np.zeros(0, bool)
    if snps is not None:
        s_chr, s_pos, s_alt = (np.asarray(x) for x in snps[:3])
        if len(snps) > 3:
            gt = np.asarray(snps[3])
            var, hom = gt > 0, gt == 2
        else:
            z = rng.random(len(s_chr))
            var, hom = z < 0.4, z >= 0.3
        g = genome.offsets[s_chr[var].astype(np.int64)] + s_pos[var].astype(np.int64)
        order_g = np.argsort(g, kind="stable")
        snp_at, snp_alt = g[order_g], s_alt[var][order_g].astype(np.uint8)
        snp_hom = hom[var][order_g]
    som_at = np.zeros(0, np.int64)
    som_alt = np.zeros(0, np.uint8)
    som_cut = 0
    if somatic is not None:
        s_chr, s_pos, s_alt = (np.asarray(x) for x in somatic[:3])
        g = genome.offsets[s_chr.astype(np.int64)] + s_pos.astype(np.int64)
        order_g = np.argsort(g, kind="stable")
        som_at, som_alt = g[order_g], s_alt[order_g].astype(np.uint8)
        som_cut = int(round(float(somatic[3]) * 32))

    # germline indels: plain reads over a site become reads with an I or a D
    # op after its base (classes 4 and 3 with the site's split and length)
    ins_site = np.full(m, -1, np.int64)
    ins_bases = np.zeros((0, 4), np.uint8)
    if indels is not None:
        i_chr, i_pos, i_seq, i_del = indels[:4]
        i_del = np.asarray(i_del, dtype=np.int64)
        i_len = np.array([len(x) for x in i_seq], dtype=np.int64)
        if len(indels) > 4:
            gt = np.asarray(indels[4])
        else:
            z = rng.random(len(i_del))
            gt = np.where(z < 0.3, 1, np.where(z < 0.4, 2, 0))
        haplotype = np.concatenate([rng.random(n) < 0.5] * 2)
        var = np.flatnonzero(gt > 0)
        g = (genome.offsets[np.asarray(i_chr, dtype=np.int64)[var]]
             + np.asarray(i_pos, dtype=np.int64)[var])
        order_g = np.argsort(g, kind="stable")
        var, g = var[order_g], g[order_g]
        g_start = genome.offsets[frag_chr] + pos
        cand = np.flatnonzero(cls == 0)   # mapped, no clip or indel
        at = np.searchsorted(g, g_start[cand] + 5)
        has = at < len(g)
        cand, at = cand[has], at[has]
        col = g[at] - g_start[cand]
        site = var[at]
        carry = (col < _BAM_READ_LEN - 10) & ((gt[site] == 2) | haplotype[cand])
        cand, col, site = cand[carry], col[carry], site[carry]
        is_ins = i_len[site] > 0
        cls[cand] = np.where(is_ins, 4, 3)
        split[cand] = col + 1
        ilen[cand] = np.where(is_ins, i_len[site], ilen[cand])
        dlen[cand] = np.where(is_ins, dlen[cand], i_del[site])
        ins_site[cand[is_ins]] = site[is_ins]
        ins_bases = np.zeros((len(i_len), 4), np.uint8)
        for k, x in enumerate(i_seq):
            ins_bases[k, :len(x)] = np.frombuffer(bytes(x), dtype=np.uint8)

    order = np.lexsort((~read1, pair, pos, frag_chr))
    if max_records is not None:
        order = order[:max_records]
    names = np.frombuffer("".join(f"p{i:09d}" for i in range(n)).encode(),
                          dtype=np.uint8).reshape(n, 10)
    rg = np.frombuffer(b"RGZgrp1\0", dtype=np.uint8)
    cig_lut = {0: ([0], [None]), 1: ([4, 0], ["clip", "rest"]),
               2: ([0, 4], ["rest", "clip"]), 3: ([0, 2, 0], ["split", "dlen", "tail"]),
               4: ([0, 1, 0], ["split", "ilen", "itail"])}
    cols = np.arange(L, dtype=np.int32)
    if genome.offsets[-1] >= 1 << 31:
        raise ValueError("the genome must have fewer than 2^31 bases")

    def batches():
        for c0 in range(0, len(order), _chunk):
            idx = order[c0:c0 + _chunk]
            k = len(idx)
            c = cls[idx]
            # each chunk draws from its own generator, always a full chunk's
            # worth, so a prefix of the records gets the same bytes: one
            # 32-bit word a base, its low 16 bits the error draw, then two
            # bits of a random base, the heterozygous coin, and its top byte
            # the quality
            word = np.random.default_rng([seed, c0 // _chunk]).integers(
                0, 1 << 32, size=(_chunk, L), dtype=np.uint32)[:k]
            err = word.view(np.uint16)[:, 0::2]
            quals = _QUAL_LUT[word.view(np.uint8)[:, 3::4] & 127]
            # reference offset of each query base; -1 where the base is not
            # on the reference (soft clip, insertion) or the read is unmapped
            off = np.broadcast_to(cols, (k, L)).astype(np.int32)
            for cc in (1, 2, 3, 4):
                r = np.flatnonzero(c == cc)
                if len(r) == 0:
                    continue
                q = cols[None, :]
                cl, sp = clip[idx[r], None], split[idx[r], None]
                if cc == 1:
                    off[r] = np.where(q < cl, -1, q - cl)
                elif cc == 2:
                    off[r] = np.where(q >= L - cl, -1, q)
                elif cc == 3:
                    off[r] = np.where(q < sp, q, q + dlen[idx[r], None])
                else:
                    il = ilen[idx[r], None]
                    off[r] = np.where(q < sp, q, np.where(q < sp + il, -1, q - il))
            off[c < 0] = -1
            start = (genome.offsets[frag_chr[idx]] + pos[idx]).astype(np.int32)
            bases = genome.seq[start[:, None] + np.maximum(off, 0)]
            # random bases off the reference and at 0.3% substitutions
            fix = np.flatnonzero((off < 0).reshape(-1) | (err < 197).reshape(-1))
            bases.reshape(-1)[fix] = _ACGT[(word.reshape(-1)[fix] >> 16) & 3]
            # germline insertions' bases
            rows = np.flatnonzero(ins_site[idx] >= 0)
            if len(rows):
                si, sp = ins_site[idx[rows]], split[idx[rows]]
                for t in range(4):
                    put = t < ilen[idx[rows]]
                    bases[rows[put], sp[put] + t] = ins_bases[si[put], t]
            # SNP alleles on the reads without clips or indels
            plain = np.flatnonzero(c == 0)
            row, h, col = _sites_in_reads(snp_at, start, plain, L)
            take = snp_hom[h] | ((word[row, col] & (1 << 18)) != 0)
            bases[row[take], col[take]] = snp_alt[h[take]]
            if len(som_at):  # somatic SNVs: bits 19-23 of the base's draw
                row, h, col = _sites_in_reads(som_at, start, plain, L)
                take = ((word[row, col] >> 19) & 31) < som_cut
                bases[row[take], col[take]] = som_alt[h[take]]
            is_n = err >= 65503                              # 0.05% N calls
            bases[is_n] = ord("N")
            quals[is_n] = 2
            # CIGARs
            n_cig = np.select([c < 0, c == 0, c <= 2], [0, 1, 2], 3)
            part = {"clip": clip[idx], "rest": L - clip[idx], "split": split[idx],
                    "dlen": dlen[idx], "tail": L - split[idx], "ilen": ilen[idx],
                    "itail": L - split[idx] - ilen[idx]}
            cig = np.zeros((k, 3), dtype=np.uint32)
            for cc, (ops, lens_of) in cig_lut.items():
                sel = c == cc
                for j, (op, key) in enumerate(zip(ops, lens_of)):
                    ln = L if key is None else part[key][sel]
                    cig[sel, j] = (np.asarray(ln, dtype=np.uint32) << 4) | op
            cig_keep = np.arange(3)[None, :] < n_cig[:, None]
            tag_len = 8 + (4 if dp_tags else 0)
            tags = np.zeros((k, tag_len), dtype=np.uint8)
            tags[:, :8] = rg
            if dp_tags:
                tags[:, 8:11] = np.frombuffer(b"DPC", dtype=np.uint8)
                tags[:, 11] = dp[idx]
            yield BamBatch(
                ref_id=frag_chr[idx].astype(np.int32), pos=pos[idx].astype(np.int32),
                flag=flag[idx], mapq=mapq[idx], l_seq=np.full(k, L, np.int32),
                n_cigar=n_cig.astype(np.int32), tlen=tlen[idx].astype(np.int32),
                mate_ref_id=frag_chr[idx].astype(np.int32),
                mate_pos=pos[mate[idx]].astype(np.int32),
                cigar=cig[cig_keep], cigar_off=np.concatenate(([0], np.cumsum(n_cig))),
                seq=_NIBBLE[bases.reshape(-1)], qual=quals.reshape(-1),
                seq_off=np.arange(k + 1, dtype=np.int64) * L,
                names=names[pair[idx]].tobytes(),
                name_off=np.arange(k + 1, dtype=np.int64) * 10,
                tags=tags.reshape(-1), tags_off=np.arange(k + 1, dtype=np.int64) * tag_len)

    write_bam(path, genome.names, genome.lengths, batches())


# ---------------------------------------------------------------- SampleSimilarity

_GENOTYPES = ("0/0", "0/1", "1/1")
_VCF_SHARED = 0.8       # synth_vcfs' share of keys common to all files
_VCF_CONCORDANCE = 0.9  # and of common keys whose GT equals the first file's


def synth_vcfs(paths, n_variants: int, seed: int,
               lengths: dict[str, int] = GRCH38_LENGTHS, constant: str | None = None):
    """Single-sample VCFs of ``n_variants`` SNVs each, for SampleSimilarity's
    VCF mode: 80% of the keys (chromosome, position, REF, ALT) are common to
    all files, the rest is each file's own, at uniform positions over
    ``lengths``; FORMAT ``GT:DP`` with GT 0/0, 0/1 or 1/1, the first file's
    drawn at random and each other file's equal to it at 90% of the common
    keys, as two samples of one person (with ``constant``, every GT of every
    file is that one). Each file is sorted by chromosome (in ``lengths``'
    order) and position."""
    rng = np.random.default_rng(seed)
    paths = list(paths)
    common = int(round(n_variants * _VCF_SHARED))
    total = common + (n_variants - common) * len(paths)
    names = list(lengths)
    lens = np.array([lengths[n] for n in names], dtype=np.int64)
    starts = np.concatenate(([0], np.cumsum(lens)))
    at = np.zeros(0, dtype=np.int64)
    while len(at) < total:  # distinct genome offsets
        at = np.unique(np.concatenate([at, rng.integers(0, starts[-1], size=total)]))
    at = rng.permutation(at)[:total]
    chrom = np.searchsorted(starts, at, side="right") - 1
    pos = at - starts[chrom] + 1
    ref = rng.integers(0, 4, size=total)
    alt = (ref + rng.integers(1, 4, size=total)) % 4
    first = rng.integers(0, 3, size=total)
    for k, path in enumerate(paths):
        own = np.arange(common + k * (n_variants - common), common + (k + 1) * (n_variants - common))
        rows = np.concatenate([np.arange(common), own])
        gt = first[rows].copy()
        if k:
            redraw = np.flatnonzero(rng.random(len(rows)) >= _VCF_CONCORDANCE)
            gt[redraw] = rng.integers(0, 3, size=len(redraw))
        order = np.lexsort((pos[rows], chrom[rows]))
        dp = rng.integers(10, 60, size=len(rows))
        lines = ["##fileformat=VCFv4.2",
                 '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
                 '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">',
                 f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tsample{k}"]
        for i in order:
            r = rows[i]
            g = constant or _GENOTYPES[gt[i]]
            lines.append(f"{names[chrom[r]]}\t{pos[r]}\t.\t{'ACGT'[ref[r]]}\t{'ACGT'[alt[r]]}\t"
                         f"50\tPASS\t.\tGT:DP\t{g}:{dp[i]}")
        Path(path).write_text("\n".join(lines) + "\n")


# ------------------------------------------------------- VcfMerge and the trio

_TRIO = ("mother", "father", "child")
_TRIO_UNCALLED = 0.03   # trio_vcfs' share of a sample's variants left out of its VCF
_TRIO_SPECIAL = 0.01    # and of its calls flagged mosaic, low_mappability or targeted


@dataclass
class TrioVariants:
    """A trio's germline variants at a shared set of sites: chromosome
    indices, 0-based positions of the VCF base, REF and ALT (ASCII bytes)
    and the genotypes ``gt [3, n]`` (0, 1 heterozygous, 2 homozygous) of
    mother, father and child."""
    chrom: np.ndarray
    pos: np.ndarray
    ref: list
    alt: list
    gt: np.ndarray

    def snps(self, sample: int):
        """``synth_bam``'s ``snps`` for one sample: its SNVs with genotypes."""
        k = np.flatnonzero(np.array([len(r) == len(a) == 1 for r, a in zip(self.ref, self.alt)]))
        return (self.chrom[k], self.pos[k],
                np.array([self.alt[i][0] for i in k], dtype=np.uint8), self.gt[sample, k])

    def indels(self, sample: int):
        """``synth_bam``'s ``indels`` for one sample: its insertions and
        deletions with genotypes."""
        k = np.flatnonzero(np.array([len(r) != 1 or len(a) != 1
                                     for r, a in zip(self.ref, self.alt)]))
        return (self.chrom[k], self.pos[k], [self.alt[i][1:] for i in k],
                np.array([len(self.ref[i]) - 1 for i in k], dtype=np.int64), self.gt[sample, k])


def trio_variants(genome: Genome, roi, n_sites: int, seed: int, known=None,
                  indel_share: float = 0.1) -> TrioVariants:
    """Germline variants of a trio at ``n_sites`` sites in the panel
    ``roi`` (``synth_roi``'s return), plus the ``known`` SNVs
    (``(chromosome indices, 1-based positions, ASCII ALT)``) as SNVs: the
    random sites at least 12 bases from each other and from the known ones,
    ``indel_share`` of them insertions or deletions of 1-4 bases, the rest
    SNVs; each parent's genotype 0, 1 or 2 at 1:2:1, the child's one allele
    drawn from each parent."""
    rng = np.random.default_rng(seed)
    r_chr, r_start, r_end = (np.asarray(x, dtype=np.int64) for x in roi)
    w = (r_end - r_start).astype(np.float64)
    k_chr = np.zeros(0, np.int64) if known is None else np.asarray(known[0], dtype=np.int64)
    k_pos = np.zeros(0, np.int64) if known is None else np.asarray(known[1], dtype=np.int64) - 1
    taken = np.concatenate(([-(1 << 40)], np.sort(genome.offsets[k_chr] + k_pos), [1 << 62]))
    chrom, pos = np.zeros(0, np.int64), np.zeros(0, np.int64)
    while len(chrom) < n_sites:
        r = rng.choice(len(r_chr), size=2 * n_sites, p=w / w.sum())
        c = r_chr[r]
        room = np.maximum(r_end[r] - r_start[r] - 10, 1)
        p = r_start[r] + 5 + rng.integers(0, 1 << 62, size=len(r)) % room
        g = np.concatenate([genome.offsets[chrom] + pos, genome.offsets[c] + p])
        c, p = np.concatenate([chrom, c]), np.concatenate([pos, p])
        first = np.unique(g, return_index=True)[1]   # each offset once, sorted
        c, p, g = c[first], p[first], g[first]
        at = np.searchsorted(taken, g)   # the sentinels keep at in [1, len - 1]
        near = (taken[at] - g < 12) | (g - taken[at - 1] < 12)
        apart = np.ones(len(g), dtype=bool)
        apart[1:] = np.diff(g) >= 12
        keep = np.flatnonzero(~near & apart)
        if len(keep) > n_sites:
            keep = np.sort(rng.choice(keep, size=n_sites, replace=False))
        chrom, pos = c[keep], p[keep]
    n = len(chrom)
    ref_base = genome.seq[genome.offsets[chrom] + pos]
    alt_base = _ACGT[(np.searchsorted(_ACGT, ref_base) + rng.integers(1, 4, size=n)) % 4]
    kind = np.where(rng.random(n) < indel_share, rng.integers(1, 3, size=n), 0)  # 1 ins, 2 del
    size = rng.integers(1, 5, size=n)
    ins = _ACGT[rng.integers(0, 4, size=(n, 4))]
    refs, alts = [], []
    for i in range(n):
        base = bytes(ref_base[i:i + 1])
        if kind[i] == 1:
            refs.append(base)
            alts.append(base + ins[i, :size[i]].tobytes())
        elif kind[i] == 2:
            at = genome.offsets[chrom[i]] + pos[i]
            refs.append(genome.seq[at:at + 1 + size[i]].tobytes())
            alts.append(base)
        else:
            refs.append(base)
            alts.append(bytes(alt_base[i:i + 1]))
    if known is not None:
        chrom = np.concatenate([k_chr, chrom])
        pos = np.concatenate([k_pos, pos])
        refs = [bytes(genome.seq[genome.offsets[c] + p:genome.offsets[c] + p + 1])
                for c, p in zip(k_chr, k_pos)] + refs
        alts = [bytes([a]) for a in np.asarray(known[2])] + alts
    order = np.lexsort((pos, chrom))
    chrom, pos = chrom[order], pos[order]
    refs, alts = [refs[i] for i in order], [alts[i] for i in order]
    m = len(chrom)
    parents = rng.choice(3, size=(2, m), p=[0.25, 0.5, 0.25])
    # a heterozygous parent passes its alternative allele at a coin's toss
    passed = np.where(parents == 1, rng.random((2, m)) < 0.5, parents == 2)
    gt = np.vstack([parents, passed.sum(axis=0)[None, :]]).astype(np.int64)
    return TrioVariants(chrom, pos, refs, alts, gt)


def trio_vcfs(paths, variants: TrioVariants, genome: Genome, seed: int):
    """The trio's single-sample VCFs (mother, father, child in ``paths``'
    order), sorted: each sample's variants (its genotype 1 or 2) but a
    share ``_TRIO_UNCALLED`` left out, so VcfMerge's re-calling has work;
    FORMAT ``GT:DP:AF`` (DP 10-60, AF near 0.5 or 1), QUAL 5-100, FILTER
    ``PASS`` and for a share ``_TRIO_SPECIAL`` each ``mosaic``,
    ``low_mappability`` or ``targeted``; a ``##SAMPLE`` line each."""
    rng = np.random.default_rng(seed)
    for s, path in enumerate(paths):
        name = _TRIO[s]
        called = np.flatnonzero((variants.gt[s] > 0)
                                & (rng.random(len(variants.chrom)) >= _TRIO_UNCALLED))
        special = rng.choice(4, size=len(called),
                             p=[1 - 3 * _TRIO_SPECIAL] + [_TRIO_SPECIAL] * 3)
        dp = rng.integers(10, 61, size=len(called))
        af = np.where(variants.gt[s, called] == 2, 1.0,
                      np.clip(rng.normal(0.5, 0.08, size=len(called)), 0.1, 0.9))
        qual = rng.integers(5, 101, size=len(called))
        lines = ["##fileformat=VCFv4.2",
                 f"##SAMPLE=<ID={name},Gender=n/a,IsTumor=no,DiseaseStatus=affected>",
                 '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
                 '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">',
                 '##FORMAT=<ID=AF,Number=1,Type=Float,Description="Allele frequency">',
                 f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{name}"]
        flt = ("PASS", "mosaic", "low_mappability", "targeted")
        for k, i in enumerate(called):
            g = "1/1" if variants.gt[s, i] == 2 else "0/1"
            lines.append(f"{genome.names[variants.chrom[i]]}\t{variants.pos[i] + 1}\t.\t"
                         f"{variants.ref[i].decode()}\t{variants.alt[i].decode()}\t{qual[k]}\t"
                         f"{flt[special[k]]}\t.\tGT:DP:AF\t{g}:{dp[k]}:{af[k]:.3f}")
        Path(path).write_text("\n".join(lines) + "\n")


# ------------------------------------------- the variant-details path's inputs

def vcf_gsvar(src, dst, seed: int, somatic: bool = False):
    """A GSvar file made from the single-sample VCF ``src`` (the
    variant-details tools' input): its variants in GSvar coordinates
    (``qc/variant_details.py::gsvar_from_vcf``), a genotype column named
    after the sample (``het`` for GT 0/1, ``hom`` for 1/1, ``wt`` else), the
    VCF's FILTER (``PASS`` left empty) and QUAL as ``filter`` and
    ``quality`` columns, a ``gene`` column, a ``##SAMPLE`` line and
    ``##DESCRIPTION`` and ``##FILTER`` lines. With ``somatic``:
    ``##ANALYSISTYPE=SOMATIC_SINGLESAMPLE`` and a ``tumor_af`` column
    (0.05-0.95, a few 0)."""
    from ..qc.variant_details import gsvar_from_vcf
    rng = np.random.default_rng(seed)
    rows = [l.split("\t") for l in Path(src).read_text().splitlines()
            if l and not l.startswith("##")]
    name = rows[0][9]
    lines = ["##GENOME_BUILD=GRCh38",
             "##ANALYSISTYPE=" + ("SOMATIC_SINGLESAMPLE" if somatic else "GERMLINE_SINGLESAMPLE"),
             f"##SAMPLE=<ID={name},Gender=n/a,IsTumor={'yes' if somatic else 'no'},"
             f"DiseaseStatus=affected>",
             f"##DESCRIPTION={name}=Genotype of sample {name}.",
             "##DESCRIPTION=filter=Annotations for filtering and ranking variants.",
             "##FILTER=mosaic=Variant called as mosaic.",
             "##FILTER=low_mappability=Low mappability region.",
             "#chr\tstart\tend\tref\tobs\t" + "\t".join(
                 [name, "filter", "quality"] + (["tumor_af"] if somatic else []) + ["gene"])]
    af = np.where(rng.random(len(rows)) < 0.03, 0.0, rng.uniform(0.05, 0.95, size=len(rows)))
    for i, f in enumerate(rows[1:]):
        s, e, r, o = gsvar_from_vcf(int(f[1]), f[3].encode(), f[4].encode())
        gt = f[9].split(":")[0].replace("|", "/")
        row = [f[0], str(s), str(e), r.decode(), o.decode(),
               {"0/1": "het", "1/0": "het", "1/1": "hom"}.get(gt, "wt"),
               "" if f[6] == "PASS" else f[6], f"QUAL={f[5]}"]
        if somatic:
            row.append(f"{af[i]:.4f}")
        row.append(f"GENE{i % 97}")
        lines.append("\t".join(row))
    Path(dst).write_text("\n".join(lines) + "\n")


def bgzip_tabix(src, dst):
    """``src`` (a sorted VCF) as BGZF at ``dst`` with a tabix index at
    ``dst.tbi``: blocks of whole lines, at most 0xFF00 bytes each; the
    index's bins (``_reg2bin`` of each line's 0-based ``[pos - 1, pos - 1 +
    len(REF))``), their chunks of virtual offsets and each chromosome's
    linear index of 16 kb windows, as tabix writes them for a VCF."""
    data = Path(src).read_bytes()
    lines = [l + b"\n" for l in data.split(b"\n") if l]
    blocks: list[list[bytes]] = [[]]
    size = 0
    for line in lines:
        if len(line) > bgzf.BLOCK_DATA:
            raise ValueError("a line longer than a BGZF block")
        if size + len(line) > bgzf.BLOCK_DATA:
            blocks.append([])
            size = 0
        blocks[-1].append(line)
        size += len(line)
    names: list[bytes] = []
    bins: list[dict] = []
    linear: list[dict] = []
    coffset = 0
    with open(dst, "wb") as fh:
        for block in blocks:
            uoff = 0
            for line in block:
                start, end = (coffset << 16) | uoff, (coffset << 16) | (uoff + len(line))
                uoff += len(line)
                if line.startswith(b"#"):
                    continue
                fields = line.split(b"\t", 4)
                if not names or names[-1] != fields[0]:
                    names.append(fields[0])
                    bins.append({})
                    linear.append({})
                beg = int(fields[1]) - 1
                stop = beg + max(1, len(fields[3]))
                b = int(_reg2bin(np.array([beg]), np.array([stop]))[0])
                chunks = bins[-1].setdefault(b, [])
                if chunks and chunks[-1][1] == start:
                    chunks[-1][1] = end
                else:
                    chunks.append([start, end])
                for w in range(beg >> 14, ((stop - 1) >> 14) + 1):
                    linear[-1].setdefault(w, start)
            raw = bgzf.block(b"".join(block), 6)
            fh.write(raw)
            coffset += len(raw)
        fh.write(bgzf.EOF_BLOCK)
    nm = b"".join(n + b"\0" for n in names)
    index = [b"TBI\1", struct.pack("<8i", len(names), 2, 1, 2, 0, ord("#"), 0, len(nm)), nm]
    for ref_bins, ref_linear in zip(bins, linear):
        index.append(struct.pack("<i", len(ref_bins)))
        for b, chunks in ref_bins.items():
            index.append(struct.pack("<Ii", b, len(chunks)))
            index += [struct.pack("<QQ", c0, c1) for c0, c1 in chunks]
        n_intv = max(ref_linear) + 1 if ref_linear else 0
        offsets, last = [], 0
        for w in range(n_intv):
            last = ref_linear.get(w, last)
            offsets.append(last)
        index.append(struct.pack("<i", n_intv) + struct.pack(f"<{n_intv}Q", *offsets))
    Path(str(dst) + ".tbi").write_bytes(bgzf.bgzf_compress(b"".join(index)))


def prs_vcf(path, variants: TrioVariants, genome: Genome, n: int, seed: int,
            pgs_id: str = "PGS000001", multi_allelic: bool = False):
    """A PRS VCF (VcfCalculatePRS's ``-prs``) of ``n`` of ``variants``'
    sites, each at a position no other site shares (the tool refuses a
    position where the sample holds more than two alleles):
    ``WEIGHT`` (N(0, 0.2)) and ``POP_AF`` (0.01-0.99) each, a tenth
    ``IMPUTE``, a tenth ``REF_IS_EFFECT_ALLELE`` (some with ``OTHER_ALLELE``),
    a twentieth with ALT ``.``; the comment lines the tool requires
    (``pgs_id``, ``trait``, ``build``, ``pgp_id``, ``citation``) and 100
    increasing ``percentiles`` around the scores the weights give. With
    ``multi_allelic`` one site gets a second ALT."""
    rng = np.random.default_rng(seed)
    key = variants.chrom.astype(np.int64) * (1 << 40) + variants.pos
    _, at, count = np.unique(key, return_index=True, return_counts=True)
    pick = np.sort(rng.choice(at[count == 1], size=n, replace=False))
    weight = rng.normal(0.0, 0.2, size=n)
    pop_af = rng.uniform(0.01, 0.99, size=n)
    kind = rng.choice(4, size=n, p=[0.75, 0.1, 0.1, 0.05])  # plain, IMPUTE, REF_IS_EFFECT, ALT '.'
    mean = float((2 * weight * pop_af).sum())
    spread = float(np.sqrt((4 * weight ** 2 * pop_af * (1 - pop_af)).sum())) or 1.0
    percentiles = np.sort(mean + spread * rng.normal(size=100))
    lines = ["##fileformat=VCFv4.2",
             f"##pgs_id={pgs_id}",
             "##trait=Synthetic trait",
             "##build=GRCh38",
             f"##pgp_id=PGP{pgs_id[3:]}",
             "##citation=Synthetic et al. (2026)",
             "##percentiles=" + ",".join(f"{p:.6f}" for p in percentiles),
             '##INFO=<ID=WEIGHT,Number=1,Type=Float,Description="Weight">',
             '##INFO=<ID=POP_AF,Number=1,Type=Float,Description="Population AF">',
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    for k, i in enumerate(pick):
        ref, alt = variants.ref[i].decode(), variants.alt[i].decode()
        info = [f"WEIGHT={weight[k]:.5f}", f"POP_AF={pop_af[k]:.4f}"]
        if kind[k] == 1:
            info.append("IMPUTE")
        elif kind[k] == 2:
            info.append("REF_IS_EFFECT_ALLELE")
            if k % 2:
                info.append("OTHER_ALLELE=" + alt)
        elif kind[k] == 3:
            alt = "."
        if multi_allelic and k == n // 2:
            alt += ",T" if alt != "T" else ",G"
        lines.append(f"{genome.names[variants.chrom[i]]}\t{variants.pos[i] + 1}\trs{i}\t{ref}\t"
                     f"{alt}\t.\t.\t{';'.join(info)}")
    Path(path).write_text("\n".join(lines) + "\n")


# ------------------------------------------------------- SomaticQC and RnaQC

# filters of the variants that fail (the first eight are those SomaticQC's
# mutation burden leaves out, ngs-bits Statistics.cpp:1468-1477)
SOMATIC_FILTERS = ("freq-nor", "freq-tum", "depth-nor", "depth-tum", "lt-3-reads", "LowEVS",
                   "LowDepth", "weak-evidence", "off-target")
SOMATIC_FLAVOURS = ("strelka", "freebayes", "fa", "af", "vaf")
SOMATIC_INDEL_SHARE = 0.1  # of somatic_variants' sites
SOMATIC_PASS_SHARE = 0.7


@dataclass
class SomaticVariants:
    """A tumor's somatic variants: chromosome indices, 0-based positions of
    the VCF base, REF and ALT (ASCII bytes), FILTER (``PASS`` or filters
    joined by ``;``), the tumor's allele share and gnomAD AF (NaN: none)."""
    chrom: np.ndarray
    pos: np.ndarray
    ref: list
    alt: list
    filters: list
    share: float
    gnomad: np.ndarray

    def snvs(self):
        """``synth_bam``'s ``somatic``: the SNVs at the tumor's share."""
        k = np.flatnonzero(np.array([len(r) == len(a) == 1 for r, a in zip(self.ref, self.alt)],
                                    dtype=bool))
        return (self.chrom[k], self.pos[k],
                np.array([self.alt[i][0] for i in k], dtype=np.uint8), self.share)


def somatic_variants(genome: Genome, roi, n: int, seed: int, share: float,
                     on_known=None) -> SomaticVariants:
    """``n`` somatic variants at sites of the panel ``roi`` (``synth_roi``'s
    return; ``trio_variants``' placement: at least 12 bases apart), sorted:
    ``SOMATIC_INDEL_SHARE`` of them insertions or deletions of 1-4 bases,
    the rest SNVs; ``SOMATIC_PASS_SHARE`` PASS, the rest one of
    ``SOMATIC_FILTERS`` (a tenth of those two); gnomAD AF on about half (a
    fifth of those above 1%). The
    SNVs go into the tumor's reads at ``share``. ``on_known`` (``(chromosome
    indices, 1-based positions)`` of known SNPs) adds an SNV at each of
    those positions."""
    sites = trio_variants(genome, roi, n, seed, indel_share=SOMATIC_INDEL_SHARE)
    rng = np.random.default_rng([seed, 1])
    chrom, pos, ref, alt = sites.chrom, sites.pos, list(sites.ref), list(sites.alt)
    if on_known is not None:
        k_chr = np.asarray(on_known[0], dtype=np.int64)
        k_pos = np.asarray(on_known[1], dtype=np.int64) - 1
        k_ref = genome.seq[genome.offsets[k_chr] + k_pos]
        k_alt = _ACGT[(np.searchsorted(_ACGT, k_ref) + rng.integers(1, 4, size=len(k_chr))) % 4]
        chrom, pos = np.concatenate([chrom, k_chr]), np.concatenate([pos, k_pos])
        ref += [bytes([b]) for b in k_ref]
        alt += [bytes([b]) for b in k_alt]
        order = np.lexsort((pos, chrom))
        chrom, pos = chrom[order], pos[order]
        ref, alt = [ref[i] for i in order], [alt[i] for i in order]
    m = len(chrom)
    fail = rng.random(m) >= SOMATIC_PASS_SHARE
    first = rng.integers(0, len(SOMATIC_FILTERS), size=m)
    second = rng.integers(0, len(SOMATIC_FILTERS), size=m)
    two = rng.random(m) < 0.1
    filters = ["PASS" if not fail[i] else SOMATIC_FILTERS[first[i]] + (
        ";" + SOMATIC_FILTERS[second[i]] if two[i] and second[i] != first[i] else "")
        for i in range(m)]
    gnomad = np.where(rng.random(m) < 0.5, np.nan,
                      np.where(rng.random(m) < 0.2, rng.uniform(0.011, 0.5, size=m),
                               rng.uniform(0.0, 0.01, size=m)))
    return SomaticVariants(chrom, pos, ref, alt, filters, share, gnomad)


def somatic_vcf(path, variants: SomaticVariants, genome: Genome, seed: int, flavour: str,
                gnomad: bool = True):
    """A somatic VCF of ``variants`` with the sample columns ``tumor`` and
    ``normal`` (SomaticQC matches them to the BAMs' file names, so the BAMs
    are ``tumor.bam`` and ``normal.bam``), read counts drawn from the allele shares at a depth of
    40-120, in one ``flavour`` of FORMAT that SomaticQC's plots read:
    ``strelka`` (SNVs ``AU:CU:GU:TU`` as ``tier1,tier2``, indels
    ``TAR:TIR``), ``freebayes`` (``AO:RO``), ``fa`` (``FA``), ``af``
    (``AF``) or ``vaf`` (the tumor's ``VAF`` and the normal's in the INFO
    field ``normal_AF``). With ``gnomad`` the header declares
    ``gnomADg_AF`` and the variants that have one carry it."""
    if flavour not in SOMATIC_FLAVOURS:
        raise ValueError(f"unknown flavour '{flavour}'")
    rng = np.random.default_rng(seed)
    m = len(variants.chrom)
    dp = rng.integers(40, 121, size=(2, m))
    af = np.vstack([np.clip(rng.normal(variants.share, 0.05, size=m), 0.02, 0.9),
                    np.where(rng.random(m) < 0.9, 0.0, rng.uniform(0.0, 0.05, size=m))])
    alt_n = rng.binomial(dp, af)
    lines = ["##fileformat=VCFv4.2", "##source=synthetic somatic caller",
             "##SAMPLE=<ID=tumor,Gender=n/a,IsTumor=yes>",
             "##SAMPLE=<ID=normal,Gender=n/a,IsTumor=no>"]
    if gnomad:
        lines.append('##INFO=<ID=gnomADg_AF,Number=A,Type=Float,Description="gnomAD AF">')
    if flavour == "vaf":
        lines.append('##INFO=<ID=normal_AF,Number=1,Type=Float,Description="Normal AF">')
    formats = {"strelka": [("DP", "Integer"), ("AU", "Integer"), ("CU", "Integer"),
                           ("GU", "Integer"), ("TU", "Integer"), ("TAR", "Integer"),
                           ("TIR", "Integer")],
               "freebayes": [("GT", "String"), ("DP", "Integer"), ("RO", "Integer"),
                             ("AO", "Integer")],
               "fa": [("GT", "String"), ("DP", "Integer"), ("FA", "Float")],
               "af": [("GT", "String"), ("DP", "Integer"), ("AF", "Float")],
               "vaf": [("GT", "String"), ("DP", "Integer"), ("VAF", "Float")]}[flavour]
    lines += [f'##FORMAT=<ID={k},Number=.,Type={t},Description="{k}">' for k, t in formats]
    for f in SOMATIC_FILTERS:
        lines.append(f'##FILTER=<ID={f},Description="Filter {f}">')
    lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ttumor\tnormal")
    for i in range(m):
        ref, alt = variants.ref[i], variants.alt[i]
        snv = len(ref) == len(alt) == 1
        info = []
        if gnomad and np.isfinite(variants.gnomad[i]):
            info.append(f"gnomADg_AF={variants.gnomad[i]:.5f}")
        samples = []
        for s in range(2):
            d, a = int(dp[s, i]), int(alt_n[s, i])
            if flavour == "strelka":
                if snv:
                    n = {b: (d - a) if b == ref[0] else (a if b == alt[0] else 0)
                         for b in b"ACGT"}
                    keys = "DP:AU:CU:GU:TU"
                    samples.append(f"{d}:" + ":".join(f"{n[b]},{n[b] + 1}" for b in b"ACGT"))
                else:
                    keys = "DP:TAR:TIR"
                    samples.append(f"{d}:{d - a},{d - a + 2}:{a},{a + 1}")
            elif flavour == "freebayes":
                keys = "GT:DP:RO:AO"
                samples.append(f"{'0/1' if a else '0/0'}:{d}:{d - a}:{a}")
            else:
                key = {"fa": "FA", "af": "AF", "vaf": "VAF"}[flavour]
                keys = f"GT:DP:{key}"
                samples.append(f"{'0/1' if a else '0/0'}:{d}:{a / d:.4f}")
        if flavour == "vaf":
            info.append(f"normal_AF={alt_n[1, i] / dp[1, i]:.4f}")
        lines.append(f"{genome.names[variants.chrom[i]]}\t{variants.pos[i] + 1}\t.\t"
                     f"{ref.decode()}\t{alt.decode()}\t{int(rng.integers(5, 100))}\t"
                     f"{variants.filters[i]}\t{';'.join(info) or '.'}\t{keys}\t"
                     + "\t".join(samples))
    Path(path).write_text("\n".join(lines) + "\n")


def rna_tsvs(splicing, expression, n_genes: int, seed: int):
    """RnaQC's inputs: a splicing TSV (a gene a row, ``aberrant_frac``
    0-0.2) and an expression TSV (``tpm`` 0-50, ``zscore`` -5 to 5 or
    ``n/a``), each with a ``##`` comment and a ``#`` header line."""
    rng = np.random.default_rng(seed)
    frac = rng.uniform(0.0, 0.2, size=n_genes)
    rows = [f"GENE{i}\t{int(rng.integers(0, 500))}\t{frac[i]:.4f}" for i in range(n_genes)]
    Path(splicing).write_text("##splicing by gene\n#gene\tspliced_reads\taberrant_frac\n"
                              + "\n".join(rows) + "\n")
    tpm = rng.exponential(5.0, size=n_genes)
    z = rng.uniform(-5.0, 5.0, size=n_genes)
    na = rng.random(n_genes) < 0.1
    rows = [f"ENSG{i:011d}\tGENE{i}\t{tpm[i]:.3f}\t{'n/a' if na[i] else f'{z[i]:.3f}'}"
            for i in range(n_genes)]
    Path(expression).write_text("##expression\n#gene_id\tgene_name\ttpm\tzscore\n"
                                + "\n".join(rows) + "\n")


# ------------------------------------------------------- VariantQC and RohHunter

WGS_DENSITY = 700   # wgs_vcf's bases a record
VEP_FIELDS = ("Allele", "Consequence", "IMPACT", "SYMBOL", "Gene", "Feature_Type", "Feature",
              "BIOTYPE", "EXON", "INTRON", "HGVSc", "HGVSp", "Existing_variation", "gnomAD_AF",
              "AF")
_WGS_FILTERS = ("PASS", ".", "low_qual", "mosaic", "low_qual;mosaic")
_WGS_FILTER_P = (0.80, 0.05, 0.08, 0.04, 0.03)
_CONSEQUENCES = ("intron_variant", "missense_variant", "synonymous_variant",
                 "upstream_gene_variant", "stop_gained", "frameshift_variant",
                 "splice_region_variant&intron_variant", "3_prime_UTR_variant")
_IMPACTS = ("MODIFIER", "LOW", "MODERATE")


def wgs_vcf(path, lengths: dict[str, int], seed: int, n_records: int | None = None,
            n_roh: tuple[int, int] = (20, 40),
            roh_size: tuple[int, int] = (1_000_000, 15_000_000)) -> list[tuple[str, int, int]]:
    """A single-sample VCF shaped like a whole genome's for VariantQC and
    RohHunter, over the chromosomes of ``lengths`` (in that order, which must
    be the chromosomes' sort order): ``n_records`` records (default one per
    ``WGS_DENSITY`` bases) at uniform distinct positions. Returns the planted
    ROH segments ``(chromosome, start, end)``, 1-based.

    - 20-40 (``n_roh``) planted ROH segments of 1-15 Mb (``roh_size``), about
      95% homozygous with two or three heterozygous islands; outside them
      about 35% of the records homozygous;
    - about 12% indels of 1-6 bases, 2% MNPs, 3% multi-allelic records;
    - FILTER PASS (80%), ``.``, ``low_qual``, ``mosaic`` and
      ``low_qual;mosaic``; QUAL 5-200; FORMAT ``GT:DP:PS`` with DP 5-80 (a
      few non-integer), phase blocks of about 40 records (PS the block's
      first position, ``|`` genotypes) and gaps of ``.``; a few records
      ``GT:DP`` only;
    - INFO DP, MQ, QD, ``AF`` (a Beta draw, missing on 5%), a ``DB`` flag on
      some, a VEP ``CSQ`` (``VEP_FIELDS``) of one to four transcripts on 90%
      of the records (``Existing_variation`` with an rs id on 60%, HIGH
      impact on about 1%, ``gnomAD_AF`` missing on a tenth of the
      transcripts), ``RS=`` on a third of the others (a tenth without the
      ``rs`` prefix)."""
    rng = np.random.default_rng(seed)
    names = list(lengths)
    lens = np.array([lengths[c] for c in names], dtype=np.int64)
    starts = np.concatenate(([0], np.cumsum(lens)))
    n = int(n_records if n_records is not None else starts[-1] // WGS_DENSITY)
    at = np.unique(rng.integers(0, starts[-1], size=n + n // 10 + 10))
    at = np.sort(rng.choice(at, size=min(n, len(at)), replace=False))
    n = len(at)
    chrom = np.searchsorted(starts, at, side="right") - 1
    pos = at - starts[chrom] + 1

    # planted ROH segments, disjoint, each inside one chromosome
    segments: list[tuple[int, int, int]] = []
    want = int(rng.integers(n_roh[0], n_roh[1] + 1))
    for _ in range(want * 20):
        if len(segments) == want:
            break
        c = int(rng.integers(0, len(names)))
        size = int(rng.integers(roh_size[0], roh_size[1] + 1))
        if size >= lens[c]:
            continue
        s = int(rng.integers(1, lens[c] - size + 1))
        if any(c == c2 and s <= e2 and s2 <= s + size - 1 for c2, s2, e2 in segments):
            continue
        segments.append((c, s, s + size - 1))
    segments.sort()
    p_hom = np.full(n, 0.35)
    for c, s, e in segments:
        inside = (chrom == c) & (pos >= s) & (pos <= e)
        p_hom[inside] = 0.95
        idx = np.flatnonzero(inside)
        for _ in range(int(rng.integers(2, 4)) if len(idx) > 20 else 0):
            k = int(rng.integers(0, len(idx) - 8))
            p_hom[idx[k:k + int(rng.integers(3, 9))]] = 0.3
    hom = rng.random(n) < p_hom
    other = rng.random(n)   # non-hom: 0/1 mostly, a few 0/0, ./. and 1/2

    kind = rng.choice(4, size=n, p=[0.83, 0.12, 0.02, 0.03])   # SNV, indel, MNP, multi-allelic
    filt = rng.choice(len(_WGS_FILTERS), size=n, p=_WGS_FILTER_P)
    qual = rng.uniform(5.0, 200.0, size=n)
    dp = rng.integers(5, 81, size=n)
    dp_odd = rng.random(n) < 0.005
    af = rng.beta(0.6, 2.5, size=n)
    af_missing = rng.random(n) < 0.05
    db = rng.random(n) < 0.2
    has_csq = rng.random(n) < 0.9
    n_tx = rng.integers(1, 5, size=n)
    has_rs = rng.random(n) < 0.6
    high = rng.random(n) < 0.01
    rs_info = rng.random(n) < 1 / 3
    no_ps = rng.random(n) < 0.005
    bases = "ACGT"

    # phase blocks: runs of about 40 records with one PS, gaps of about 4 '.'
    ps = np.full(n, -1, dtype=np.int64)
    i = 0
    while i < n:
        k = int(rng.geometric(1 / 40))
        block = slice(i, min(i + k, n))
        same = chrom[block] == chrom[i]
        j = i + int(np.argmin(same)) if not same.all() else block.stop
        ps[i:j] = pos[i]
        i = j + int(rng.geometric(1 / 4)) - 1
    lines = ["##fileformat=VCFv4.2",
             '##FILTER=<ID=low_qual,Description="Low quality variant">',
             '##FILTER=<ID=mosaic,Description="Mosaic variant">',
             '##INFO=<ID=DP,Number=1,Type=Integer,Description="Total depth">',
             '##INFO=<ID=MQ,Number=1,Type=Float,Description="Mapping quality">',
             '##INFO=<ID=QD,Number=1,Type=Float,Description="Quality by depth">',
             '##INFO=<ID=AF,Number=A,Type=Float,Description="Allele frequency">',
             '##INFO=<ID=DB,Number=0,Type=Flag,Description="dbSNP membership">',
             '##INFO=<ID=RS,Number=1,Type=String,Description="dbSNP id">',
             '##INFO=<ID=CSQ,Number=.,Type=String,Description="Consequence annotations from '
             'Ensembl VEP. Format: ' + "|".join(VEP_FIELDS) + '">',
             '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
             '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">',
             '##FORMAT=<ID=PS,Number=1,Type=Integer,Description="Phase set">']
    lines += [f"##contig=<ID={c},length={lengths[c]}>" for c in names]
    lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tsample")
    draws = rng.integers(0, 1 << 30, size=(n, 8)).tolist()
    # Python scalars: the loop below formats every record
    kind, filt, qual, dp, dp_odd, af, af_missing, db, has_csq, n_tx, has_rs, high, rs_info, \
        no_ps, hom, other, ps, pos, chrom = (a.tolist() for a in (
            kind, filt, qual, dp, dp_odd, af, af_missing, db, has_csq, n_tx, has_rs, high,
            rs_info, no_ps, hom, other, ps, pos, chrom))
    for i in range(n):
        d = draws[i]
        ref = bases[d[0] % 4]
        alt = bases[(d[0] + 1 + d[1] % 3) % 4]
        if kind[i] == 1:
            extra = "".join(bases[(d[2] >> (2 * k)) % 4] for k in range(1 + d[3] % 6))
            if d[4] % 2:
                alt = ref + extra
            else:
                ref, alt = ref + extra, ref
        elif kind[i] == 2:
            ref += bases[d[2] % 4]
            alt += bases[(d[2] + 1) % 4]
        elif kind[i] == 3:
            alt += "," + bases[(d[0] + 1 + (d[1] + 1) % 3) % 4]
        phased = ps[i] >= 0
        sep = "|" if phased else "/"
        if hom[i]:
            gt = f"1{sep}1"
        elif other[i] < 0.01:
            gt = "./."
        elif other[i] < 0.02:
            gt = f"0{sep}0"
        elif kind[i] == 3 and other[i] < 0.5:
            gt = f"1{sep}2"
        else:
            gt = f"1{sep}0" if phased and d[5] % 2 else f"0{sep}1"
        depth = f"{dp[i]}.5" if dp_odd[i] else str(dp[i])
        info = [f"DP={dp[i] * 2}", "MQ=60.00", f"QD={qual[i] / dp[i]:.2f}"]
        if not af_missing[i]:
            info.append(f"AF={af[i]:.5f}")
        if db[i]:
            info.append("DB")
        if has_csq[i]:
            txs = []
            for t in range(n_tx[i]):
                gene = 1000 + (d[6] + t) % 20000
                impact = "HIGH" if high[i] and t == 0 else _IMPACTS[(d[7] + t) % 3]
                existing = f"rs{d[6] % 90000000 + 1000}" if has_rs[i] else ""
                if has_rs[i] and t % 2:
                    existing += f"&COSV{d[7] % 9000000}"
                gnomad = "" if (d[5] >> t) % 10 == 0 else f"{af[i] * (1 + t / 10):.5g}"
                txs.append(f"{alt.split(',')[0]}|{_CONSEQUENCES[(d[7] >> t) % 8]}|{impact}|"
                           f"GENE{gene}|ENSG{gene:011d}|Transcript|ENST{gene + t:011d}.{t + 1}|"
                           f"protein_coding|{t + 1}/12||ENST{gene + t:011d}.{t + 1}:"
                           f"c.{pos[i] % 3000}{ref[0]}>{alt[0]}||{existing}|{gnomad}|"
                           f"{af[i]:.4f}")
            info.append("CSQ=" + ",".join(txs))
        elif rs_info[i]:
            info.append(f"RS={'rs' if d[7] % 10 else ''}{d[6] % 90000000 + 1000}")
        fmt, sample = ("GT:DP", f"{gt}:{depth}") if no_ps[i] else \
            ("GT:DP:PS", f"{gt}:{depth}:{ps[i] if phased else '.'}")
        lines.append(f"{names[chrom[i]]}\t{pos[i]}\t.\t{ref}\t{alt}\t{qual[i]:.2f}\t"
                     f"{_WGS_FILTERS[filt[i]]}\t{';'.join(info)}\t{fmt}\t{sample}")
    Path(path).write_text("\n".join(lines) + "\n")
    return [(names[c], s, e) for c, s, e in segments]


def roh_beds(exclude, annotate, lengths: dict[str, int], segments, seed: int):
    """RohHunter's BEDs over the chromosomes of ``lengths`` (in their sort
    order): ``exclude``, sorted but not merged: a centromere-like gap of
    about 1.2% of each chromosome's length in its middle, about 40 small
    gaps (0.002-0.02% of a chromosome), some of them overlapping one another,
    and one inside each of two thirds of ``segments`` (so runs break there);
    ``annotate`` two paths: the first gene-like regions named ``GENE<i>`` in
    a fourth column, written in random order (RohHunter sorts it), the
    second three columns only (its annotations read ``yes``)."""
    rng = np.random.default_rng(seed)
    names = list(lengths)
    rows: list[tuple[int, int, int]] = []
    for c, name in enumerate(names):
        size = lengths[name]
        gap = max(int(size * 0.012), 10)
        mid = size // 2 + int(rng.integers(-size // 10, size // 10 + 1))
        rows.append((c, mid, mid + gap))
        for _ in range(40 // len(names) + 1):
            s = int(rng.integers(0, size - 1))
            w = max(int(size * rng.uniform(2e-5, 2e-4)), 2)
            rows.append((c, s, min(s + w, size)))
            if rng.random() < 0.3:  # an overlapping neighbour
                rows.append((c, s + w // 2, min(s + 2 * w, size)))
    for name, s, e in segments:
        if rng.random() < 2 / 3:
            c = names.index(name)
            at = int(rng.integers(s + (e - s) // 4, s + 3 * (e - s) // 4))
            rows.append((c, at, at + max((e - s) // 200, 2)))
    rows.sort()
    Path(exclude).write_text("".join(f"{names[c]}\t{s}\t{e}\n" for c, s, e in rows))
    genes = []
    for i in range(300):
        c = int(rng.integers(0, len(names)))
        s = int(rng.integers(0, lengths[names[c]] - 2))
        genes.append(f"{names[c]}\t{s}\t{min(s + int(rng.integers(1_000, 200_000)), lengths[names[c]])}"
                     f"\tGENE{i}")
    Path(annotate[0]).write_text("\n".join(rng.permutation(genes)) + "\n")
    plain = []
    for c, name in enumerate(names):
        for s in np.sort(rng.integers(0, lengths[name] - 2, size=20)):
            plain.append(f"{name}\t{s}\t{min(int(s) + int(rng.integers(500, 50_000)), lengths[name])}")
    Path(annotate[1]).write_text("\n".join(plain) + "\n")


def roh_af_vcf(path, af: str, at: int, seed: int):
    """A single-sample VCF for RohHunter whose AF may not be finite: chr1, a
    marker every 1,000 bases, homozygous runs of 300, 300, 60 and 500 markers,
    each after 20 heterozygous ones (so no two merge), QUAL 50, DP 30, INFO
    ``AF`` drawn from 0.01-0.3 (written with four decimals: a run's product
    of af² reaches 0 within 310 markers), except marker ``at`` of the last
    run, whose AF is ``af`` as written (``inf``, ``1e39``, ``nan``)."""
    rng = np.random.default_rng(seed)
    lines = ["##fileformat=VCFv4.2",
             '##INFO=<ID=AF,Number=A,Type=Float,Description="Allele frequency">',
             '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
             '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Depth">',
             "##contig=<ID=chr1,length=248956422>",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tsample"]
    pos, runs = 1_000, (300, 300, 60, 500)
    for k, n in enumerate(runs):
        for j in range(20 + n):
            value = (af if k == len(runs) - 1 and j - 20 == at
                     else f"{rng.uniform(0.01, 0.3):.4f}")
            gt = "0/1" if j < 20 else "1/1"
            lines.append(f"chr1\t{pos}\t.\tA\tG\t50\tPASS\tAF={value}\tGT:DP\t{gt}:30")
            pos += 1_000
    Path(path).write_text("\n".join(lines) + "\n")
