"""Each kernel beside its plain version, on the same inputs.

``cases`` builds, for one batch shape, the inputs the ReadQC stream step gives
each of its kernels (packed reads for unpack, ASCII reads for K1, per-read
sums for tails); ``seqpurge_cases`` the inputs SeqPurge's engine gives its
three scans (padded read pairs of a short-insert library), and
``decide_case`` those its decisions get (the scans' counts of such pairs,
with qualities). All come from a numpy seed and return one ``Case`` per
kernel: ``kernel()`` runs the wrapper, ``plain()`` the plain torch version,
each into its own outputs.
``batch_case`` makes K1's case for any ``[B, L]``, and ``reads`` takes quality
profiles, fixed read lengths and bytes past the lengths that are not zero;
``insert_case`` makes K2's for any rows, and ``insert_edge_pairs`` rows at
the edges of its contract.
``coverage_add_case``, ``coverage_finalize_case`` and ``bincount_case`` make
MappingQC's (C1, C2, B1) on ``coverage_spans`` and ``pileup_indices``, and
``coverage_add_reads_case`` its C1 read form on ``roi_reads``;
``coverage_dense_case`` (C2 without its histogram), ``region_sums_case``
(R1) and ``threshold_runs_case`` (R2) the coverage tools', on
``coverage_regions`` and (R1) ``r1_regions``; ``coverage_add_records_case``
their C1 record form, on ``alignment_records`` (a BAM batch's columns with
every CIGAR op, bases and MAPQ); ``pileup_case`` the contamination
pileup's B1 record form, on those records at ``pileup_loci``
(``pileup_edge_case``: at ``PILEUP_EDGES`` with ``PILEUP_PARAMS``);
``pileup_indels_case`` its indel form (VcfMerge's re-calling), on those
records at ``indel_loci`` (``indel_edge_inputs`` and
``pileup_indel_edge_case``: at ``INDEL_EDGES``, at the loci range the host's
pre-filter finds from ``record_ends``); ``pileup_regions_case`` its region
form (the variant-details path), on those records (``spanless``: some of no
reference span) over ``indel_regions`` (``region_edge_columns``,
``region_edge_inputs`` and ``pileup_region_edge_case``: at ``REGION_EDGES``,
at the regions range the host's pre-filter finds);
``correlation_moments_case`` the similarity's X7, on ``genotype_rows``
(with a grid: on that many blocks, ``correlation_moments_on_grid``, through
the library's test entry); ``genotype_overlaps`` and ``f10_overlaps`` the
seeded overlaps where the similarity's two forms of r print apart (F10);
``variant_classify_case`` VariantQC's V1 on packed records
(``variant_cases``: at ``VARIANT_EDGES``, no records, ``variant_seams``'
records, whose patterns, keys and fields lie at every offset of a 16-byte
chunk and across the 512-byte steps in which V1 reads a record, and
``variant_fuzz``'s random records) and ``roh_products_case`` RohHunter's H1 (``roh_cases``: at
``roh_edge_inputs`` and ``roh_exit_edges``, the ranges where its early exit
decides), its float64 products compared as bit patterns; ``roh_chain`` the
longest range and the longest chain before an exit.
``max_abs_err`` compares the two after both ran once. Each case also counts
the work the function must do on its inputs: ``bytes`` (each input read once,
each output written once; for K1 only the bytes inside the reads) and ``ops``
(integer operations: compares and additions; for the scans, the compares
that these inputs need, four to a 32-bit operation). ``device_ms``,
``cold_ms`` and ``call_ms`` time a call on the card; ``device_ops`` counts
the device operations a call queues. ``chip_smoke.py``,
``scripts/k1_variants.py`` and the ``gpu``-marked tests use them.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass
from decimal import ROUND_HALF_UP, Decimal
from typing import Callable

import numpy as np
import torch

from ..core.basicstats import correlation
from . import device_reduce as dr
from . import pallas_kernels as pk
from . import seqpurge as sp
from . import variants as vops
from .readqc import QHIST_SIZE, pack_batch, stream_carry_init


@dataclass
class Case:
    name: str
    wrapper: Callable          # the wrapper whose launches this case counts
    kernel: Callable[[], None]
    plain: Callable[[], None]
    outputs: Callable[[], tuple[list, list]]  # (kernel outputs, plain outputs)
    bytes: int = 0             # least bytes moved: inputs once, outputs once
    ops: int = 0               # integer operations on these inputs
    inputs: tuple = ()         # K1's (bases, quals, lengths); D's, see decide_case_for
    # the launches alone, without the wrapper's fetch between them, for the
    # timings that capture a CUDA graph (R2); None: ``kernel``
    device_fn: Callable[[], None] | None = None


PROFILES = ("uniform", "binned", "wide")
BINNED_Q = np.array([2, 12, 23, 37])  # the four bins of NovaSeq 6000's RTA3


def reads(B: int, L: int, qual_bits: int, seed: int = 0,
          profile: str = "uniform", read_len: int | None = None,
          n_valid: int | None = None, dirty: bool = False):
    """Reads as the bucketed main path has them: ~2% N, lengths 0..L (some
    0) or, with ``read_len``, every read ``min(read_len, L)`` long, and the
    rows from ``n_valid`` on padding of length 0 (default: the last eighth).

    Quality profiles: ``uniform`` draws each quality from Q0..Q41 (Q0..Q93
    with ``qual_bits=8``); ``binned`` uses only Q2/Q12/Q23/Q37, in runs along
    the read, as binning instruments write them; ``wide`` draws each base
    and quality byte from 0..255 (bases outside ACGTN, qualities below Q0
    and past Q99; only for K1, not packable).
    Bytes past a read's length are 0, or random bytes with ``dirty``."""
    if profile not in PROFILES:
        raise ValueError(f"profile must be one of {PROFILES}, got {profile!r}")
    rng = np.random.default_rng(seed)
    bases = rng.choice(np.frombuffer(b"ACGTN", dtype=np.uint8), size=(B, L),
                       p=[0.245, 0.245, 0.245, 0.245, 0.02])
    if profile == "uniform":
        qmax = 126 if qual_bits == 8 else 74
        quals = rng.integers(33, qmax + 1, size=(B, L)).astype(np.uint8)
    elif profile == "binned":
        # a new bin at about one cycle in eight, mostly the top one
        start = rng.choice(4, size=(B, 1), p=[0.05, 0.1, 0.15, 0.7])
        change = rng.random((B, L)) < 0.125
        step = np.where(change, rng.choice(4, size=(B, L), p=[0.05, 0.1, 0.15, 0.7]), 0)
        idx = np.maximum.accumulate(np.where(change, np.arange(L)[None, :], -1), axis=1)
        binned = np.where(idx >= 0, step[np.arange(B)[:, None], np.maximum(idx, 0)], start)
        quals = (BINNED_Q[binned] + 33).astype(np.uint8)
    else:
        bases = rng.integers(0, 256, size=(B, L)).astype(np.uint8)
        bases[rng.random((B, L)) < 0.5] = ord("A")  # still counts
        quals = rng.integers(0, 256, size=(B, L)).astype(np.uint8)
    if read_len is None:
        lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    else:
        lengths = np.full(B, min(read_len, L), np.int32)
    n_valid = B - B // 8 if n_valid is None else n_valid
    lengths[n_valid:] = 0
    mask = np.arange(L)[None, :] < lengths[:, None]
    if dirty:
        fill_b, fill_q = (rng.integers(0, 256, size=(B, L)).astype(np.uint8)
                          for _ in range(2))
    else:
        fill_b = fill_q = np.uint8(0)
    return (np.where(mask, bases, fill_b).astype(np.uint8),
            np.where(mask, quals, fill_q).astype(np.uint8), lengths, n_valid)


def _k1_outputs(B: int, L: int, device: torch.device) -> list:
    return [torch.zeros((5, L), dtype=torch.int64, device=device),
            torch.zeros(L, dtype=torch.int64, device=device),
            torch.zeros(QHIST_SIZE, dtype=torch.int64, device=device),
            torch.zeros(B, dtype=torch.int32, device=device)]


def batch_case(bases: torch.Tensor, quals: torch.Tensor,
               lengths: torch.Tensor) -> Case:
    """K1 on ``[B, L]`` ASCII reads. Bytes: those inside the reads (two per
    base), the lengths, ``read_qsum`` and the int64 outputs; operations:
    five compares and two additions per base inside the reads."""
    B, L = bases.shape
    kk, kp = _k1_outputs(B, L, bases.device), _k1_outputs(B, L, bases.device)
    inside = int(lengths.to(torch.int64).clamp(0, L).sum())
    return Case("readqc_batch", pk.readqc_batch_into,
                lambda: pk.readqc_batch_into(bases, quals, lengths, *kk),
                lambda: pk.readqc_batch_plain(bases, quals, lengths, *kp),
                lambda: (kk, kp),
                bytes=2 * inside + 4 * B + 4 * B + 8 * (6 * L + QHIST_SIZE),
                ops=7 * inside, inputs=(bases, quals, lengths))


def cases(B: int, L: int, qual_bits: int, device: torch.device,
          seed: int = 0, profile: str = "uniform", read_len: int | None = None,
          n_valid: int | None = None) -> list[Case]:
    """unpack, K1 and tails on one batch of ``reads`` (the same keywords),
    each on what the stream step hands it: unpack the first ``n_valid`` rows,
    K1 and tails all B."""
    if L % 8:
        raise ValueError(f"L must be a multiple of 8, got {L}")
    bases_np, quals_np, lengths_np, n_valid = reads(
        B, L, qual_bits, seed, profile=profile, read_len=read_len, n_valid=n_valid)
    packed = [torch.from_numpy(a).to(device)
              for a in pack_batch(bases_np, quals_np, qual_bits)]
    lengths = torch.from_numpy(lengths_np).to(device)

    def u8(rows=B):
        return torch.empty((rows, L), dtype=torch.uint8, device=device)

    # unpack on the rows that hold reads, as the stream step hands them
    reads_only = [t[:n_valid] for t in packed]
    uk, up = (u8(n_valid), u8(n_valid)), (u8(n_valid), u8(n_valid))
    unpack = Case("readqc_unpack", pk.readqc_unpack_into,
                  lambda: pk.readqc_unpack_into(*reads_only, qual_bits, *uk),
                  lambda: pk.readqc_unpack_plain(*reads_only, qual_bits, *up),
                  lambda: (list(uk), list(up)),
                  bytes=sum(t.numel() for t in reads_only) + 2 * n_valid * L,
                  ops=2 * n_valid * L)

    # K1 on what unpack gives it
    ascii_b, ascii_q = u8(), u8()
    pk.readqc_unpack_plain(*packed, qual_bits, ascii_b, ascii_q)
    batch = batch_case(ascii_b, ascii_q, lengths)

    # tails on K1's per-read sums
    *sums, read_qsum = _k1_outputs(B, L, device)
    pk.readqc_batch_plain(ascii_b, ascii_q, lengths, *sums, read_qsum)
    ck, cp = stream_carry_init(L, device), stream_carry_init(L, device)
    tails = Case("readqc_tails", pk.readqc_tails_into,
                 lambda: pk.readqc_tails_into(read_qsum, lengths, n_valid, 0, ck),
                 lambda: pk.readqc_tails_plain(read_qsum, lengths, n_valid, 0, cp),
                 lambda: ([ck[k] for k in pk.TAIL_KEYS],
                          [cp[k] for k in pk.TAIL_KEYS]),
                 bytes=8 * B + 8 * sum(ck[k].numel() for k in pk.TAIL_KEYS),
                 ops=8 * B)
    return [unpack, batch, tails]


_ACGTN = np.frombuffer(b"ACGTN", dtype=np.uint8)
_COMPLEMENT = np.zeros(256, dtype=np.uint8)
for _a, _c in zip(b"ACGTN", b"TGCAN"):
    _COMPLEMENT[_a] = _c


def pairs(B: int, L: int, seed: int = 0, dirty: bool = False):
    """Read pairs as SeqPurge's engine pads them: lengths mostly L with a
    tenth of each mate ragged (read 1 any length, read 2 below 10), ~1% N,
    and two pairs in three a short insert (read 2 the reverse complement of
    read 1's first n bases, then other bases). With ``dirty`` the bytes past
    each read's length are random and every 16th pair is all N. Returns
    read1, read2, seq2rc ([B, L] uint8) and len1, len2, min_len ([B]
    int32)."""
    rng = np.random.default_rng(seed)
    len1 = np.full(B, L, np.int32)
    len2 = np.full(B, L, np.int32)
    ragged = rng.random(B) < 0.1
    len1[ragged] = rng.integers(0, L + 1, size=int(ragged.sum()))
    ragged = rng.random(B) < 0.1
    len2[ragged] = rng.integers(0, min(L, 9) + 1, size=int(ragged.sum()))
    read1 = _ACGTN[rng.choice(5, size=(B, L), p=[0.2475] * 4 + [0.01])]
    read2 = _ACGTN[rng.choice(5, size=(B, L), p=[0.2475] * 4 + [0.01])]
    pos = np.arange(L)[None, :]
    rows = np.arange(B)[:, None]
    insert = (rng.random(B) * np.minimum(len1, len2)).astype(np.int64)
    short = (rng.random(B) < 2 / 3)[:, None] & (pos < insert[:, None])
    mirrored = read1[rows, np.maximum(insert[:, None] - 1 - pos, 0)]
    read2 = np.where(short, _COMPLEMENT[mirrored], read2)
    if dirty:
        read1[7::16] = read2[7::16] = ord("N")
    fill = [rng.integers(0, 256, size=(B, L)).astype(np.uint8) if dirty else 0
            for _ in range(3)]
    read1 = np.where(pos < len1[:, None], read1, fill[0]).astype(np.uint8)
    read2 = np.where(pos < len2[:, None], read2, fill[1]).astype(np.uint8)
    idx2 = len2[:, None] - 1 - pos
    seq2rc = np.where(idx2 >= 0, _COMPLEMENT[read2[rows, np.maximum(idx2, 0)]], fill[2])
    return (read1, read2, seq2rc.astype(np.uint8), len1, len2,
            np.minimum(len1, len2))


def seqpurge_cases(B: int, L: int, device: torch.device, a1: bytes, a2: bytes,
                   a_size: int = 20, overlap: int = 10, seed: int = 0,
                   dirty: bool = False) -> list[Case]:
    """K2, adapter_evidence (windows ``a1[:overlap]`` and ``a2[:overlap]``)
    and adapter_scan (``a1[:a_size]`` on read 1) at ``[B, L]``, on
    ``pairs`` (the same ``dirty``). Operations: the adapter scans' compares
    of each window base at each position, four to a 32-bit operation, as
    their kernels make them."""
    read1, read2, seq2rc, len1, len2, min_len = (
        torch.from_numpy(a).to(device) for a in pairs(B, L, seed, dirty))
    w1, w2, ad = a1[:overlap], a2[:overlap], a1[:a_size]

    def out(n):
        return [torch.empty((B, L), dtype=sp.ADAPTER_COUNT, device=device)
                for _ in range(n)]

    ek, ep = out(4), out(4)
    evidence = Case("adapter_evidence", sp.adapter_evidence_into,
                    lambda: sp.adapter_evidence_into(read1, read2, len1, len2,
                                                     w1, w2, *ek),
                    lambda: sp.adapter_evidence_plain(read1, read2, len1, len2,
                                                      w1, w2, *ep),
                    lambda: (ek, ep),
                    bytes=2 * B * L + 8 * B + 4 * B * L,
                    ops=-(-2 * len(w1) * B * L // 4))
    sk, sq = out(2), out(2)
    scan = Case("adapter_scan", sp.adapter_scan_into,
                lambda: sp.adapter_scan_into(read1, len1, ad, *sk),
                lambda: sp.adapter_scan_plain(read1, len1, ad, *sq),
                lambda: (sk, sq),
                bytes=B * L + 4 * B + 2 * B * L, ops=-(-len(ad) * B * L // 4))
    return [insert_case(read1, seq2rc, min_len), evidence, scan]


def insert_case(seq1: torch.Tensor, seq2rc: torch.Tensor,
                min_len: torch.Tensor) -> Case:
    """K2 on these ``[B, L]`` rows. Bytes: both rows, ``min_len`` and the
    int16 outputs; operations: the ``n(n+1)/2`` compares of each pair of
    overlap ``n = clamp(min_len, 0, L)``, four to a 32-bit operation."""
    B, L = seq1.shape

    def out():
        return [torch.empty((B, L), dtype=pk.INSERT_COUNT, device=seq1.device)
                for _ in range(2)]

    n = min_len.clamp(0, L).to(torch.int64)
    ik, ip = out(), out()
    return Case("insert_scan", pk.insert_scan_into,
                lambda: pk.insert_scan_into(seq1, seq2rc, min_len, *ik),
                lambda: pk.insert_scan_plain(seq1, seq2rc, min_len, *ip),
                lambda: (ik, ip),
                bytes=2 * B * L + 4 * B + 4 * B * L,
                ops=-(-int((n * (n + 1) // 2).sum()) // 4))


def insert_edge_pairs(B: int, L: int, seed: int = 0):
    """Rows for K2 at the edges of its contract: ``seq1``, ``seq2rc``
    (``[B, L]`` uint8) and ``min_len`` (``[B]`` int32). Every fourth pair
    overlaps (``seq2rc`` repeats ``seq1`` shifted by a random offset) and
    every fifth is one base repeated, so counts run up to ``min_len``; the
    bases are ACGTN with ~2% N, or any byte value in every third pair; three
    pairs in seven are all N on one side or both; ``min_len`` is any of 0..L,
    with some pairs at -1, 0, L and above L. Bytes past ``min_len`` are
    random."""
    rng = np.random.default_rng(seed)
    seq1 = _ACGTN[rng.choice(5, size=(B, L), p=[0.245] * 4 + [0.02])]
    seq2 = _ACGTN[rng.choice(5, size=(B, L), p=[0.245] * 4 + [0.02])]
    wild = np.arange(B) % 3 == 1
    seq1[wild] = rng.integers(0, 256, size=(int(wild.sum()), L))
    seq2[wild] = rng.integers(0, 256, size=(int(wild.sum()), L))
    shift = rng.integers(0, L, size=B)
    pos = np.arange(L)[None, :]
    overlap = (np.arange(B) % 4 == 0)[:, None] & (pos >= shift[:, None])
    shifted = seq1[np.arange(B)[:, None], np.maximum(pos - shift[:, None], 0)]
    seq2 = np.where(overlap, shifted, seq2)
    same = np.arange(B) % 5 == 2
    seq1[same] = ord("C")
    seq2[same] = ord("C")
    k = np.arange(B) % 7
    seq1[(k == 3) | (k == 5)] = ord("N")
    seq2[(k == 4) | (k == 5)] = ord("N")
    min_len = rng.integers(0, L + 1, size=B).astype(np.int64)
    special = np.array([-1, 0, L, L + 1, L + 1000, 2**31 - 1])
    pick = rng.random(B) < 0.3
    min_len[pick] = special[rng.integers(0, len(special), size=int(pick.sum()))]
    past = pos >= np.clip(min_len, 0, L)[:, None]
    seq1 = np.where(past, rng.integers(0, 256, size=(B, L)), seq1).astype(np.uint8)
    seq2 = np.where(past, rng.integers(0, 256, size=(B, L)), seq2).astype(np.uint8)
    return seq1, seq2, min_len.astype(np.int32)


def adapter_pairs(B: int, L: int, a1: bytes, a2: bytes, seed: int = 0,
                  dirty: bool = False):
    """Read pairs of a short-insert library as the engine pads them, with
    what the decisions look for: inserts of 0..2L bases, so about half the
    pairs read through their insert into the adapter (``a1`` after read 1's
    insert, ``a2`` after read 2's) and on into random bases. ~1% N, 2% of
    read 2's bases replaced (errors for -ec to correct), a run of 8 Ns in
    every tenth read 1, lengths mostly L with a tenth of each mate of any
    length. With ``dirty`` the bytes past each read are random and every
    16th pair is all N. Returns what ``pairs`` returns."""
    rng = np.random.default_rng(seed)
    len1 = np.full(B, L, np.int32)
    len2 = np.full(B, L, np.int32)
    for ln in (len1, len2):
        ragged = rng.random(B) < 0.1
        ln[ragged] = rng.integers(0, L + 1, size=int(ragged.sum()))
    insert = rng.integers(0, 2 * L + 1, size=B)[:, None]
    frag = _ACGTN[rng.choice(5, size=(B, 2 * L), p=[0.2475] * 4 + [0.01])]
    pos = np.arange(L)[None, :]
    rows = np.arange(B)[:, None]
    past = pos - insert   # position in the read's tail

    def tail(adapter: bytes):
        a = np.frombuffer(adapter, dtype=np.uint8)
        rand = _ACGTN[rng.integers(0, 4, size=(B, L))]
        return np.where(past < len(a), a[np.clip(past, 0, len(a) - 1)], rand)

    read1 = np.where(past < 0, frag[:, :L], tail(a1))
    mirrored = _COMPLEMENT[frag[rows, np.clip(insert - 1 - pos, 0, 2 * L - 1)]]
    read2 = np.where(past < 0, mirrored, tail(a2))
    flip = rng.random((B, L)) < 0.02
    read2 = np.where(flip, _ACGTN[rng.integers(0, 4, size=(B, L))], read2)
    for b in np.flatnonzero((np.arange(B) % 10 == 3) & (len1 >= 8)):
        start = (7 * b) % (int(len1[b]) - 7)
        read1[b, start:start + 8] = ord("N")
    if dirty:
        read1[7::16] = read2[7::16] = ord("N")
    fill = [rng.integers(0, 256, size=(B, L)) if dirty else 0 for _ in range(3)]
    read1 = np.where(pos < len1[:, None], read1, fill[0]).astype(np.uint8)
    read2 = np.where(pos < len2[:, None], read2, fill[1]).astype(np.uint8)
    idx2 = len2[:, None] - 1 - pos
    seq2rc = np.where(idx2 >= 0, _COMPLEMENT[read2[rows, np.maximum(idx2, 0)]], fill[2])
    return (read1, read2, seq2rc.astype(np.uint8), len1, len2,
            np.minimum(len1, len2))


PARAMS = dict(match_perc=80.0, mep=1e-6, qcut=15, qwin=5, qoff=33, ncut=7)


def pair_quals(len1, len2, L: int, seed: int = 0, dirty: bool = False):
    """``[2, B, L]`` uint8 qualities for ``pairs``: Q2..Q41, a fifth of the
    reads ending in a tail of Q2..Q12 (for the quality trim); bytes past the
    lengths 0, or random with ``dirty``."""
    rng = np.random.default_rng(seed)
    pos = np.arange(L)[None, :]
    out = []
    for ln in (len1, len2):
        B = len(ln)
        q = rng.integers(2, 42, size=(B, L))
        tail = np.where(rng.random(B) < 0.2, rng.integers(1, 40, size=B), 0)
        q = np.where(pos >= (ln - tail)[:, None], rng.integers(2, 13, size=(B, L)), q)
        fill = rng.integers(0, 256, size=(B, L)) if dirty else 0
        out.append(np.where(pos < ln[:, None], q + 33, fill).astype(np.uint8))
    return np.stack(out)


def seqpurge_scans(read1, read2, seq2rc, len1, len2, min_len, a1: bytes,
                   a2: bytes, a_size: int = 20, overlap: int = 10):
    """The engine's scan outputs for these tensors, through the scans'
    wrappers (the kernels on a card): ``scans`` ``[8, B, L]`` one-byte (the
    adapter scans') and ``ins`` ``[2, B, L]`` int16 (K2's)."""
    B, L = read1.shape
    ins = torch.empty((2, B, L), dtype=pk.INSERT_COUNT, device=read1.device)
    scans = torch.empty((sp.SCAN_ROWS, B, L), dtype=sp.ADAPTER_COUNT, device=read1.device)
    pk.insert_scan_into(read1, seq2rc, min_len, ins[0], ins[1])
    sp.adapter_evidence_into(read1, read2, len1, len2, a1[:overlap], a2[:overlap],
                             *scans[:4])
    sp.adapter_scan_into(read1, len1, a1[:a_size], scans[4], scans[5])
    sp.adapter_scan_into(read2, len2, a2[:a_size], scans[6], scans[7])
    return scans, ins


def tie_pairs(L: int, seed: int = 0):
    """Pairs whose best insert p-value is reached at two or more offsets,
    for the adapters ``POLY``; rows of 700 and 712 bases need L >= 712.

    Short rows: read 1 all A with one N at min_len - 6, read 2 all T but its
    last five bases C. Offsets 5 and 6 then both compare min_len - 6
    matching bases and nothing else, the smallest p of the row; 5 wins.
    Long rows: the same without the N and with 150 C, so that offsets up to
    about 150 count the same matches over windows that shrink with the
    offset, and every offset from somewhat below 150 to 162 matches over
    more than 537 bases, where the tail underflows to 0.0; the smallest of
    them wins, a tie that spans lanes of a warp. Returns what ``pairs``
    returns, and ``[2, B, L]`` qualities of Q2..Q41."""
    rows = []
    for n in (16, 17, 40, 63, 64, 65, 100, 151):
        r1 = np.full(n, ord("A"), np.uint8)
        r1[n - 6] = ord("N")
        r2 = np.full(n, ord("T"), np.uint8)
        r2[-5:] = ord("C")
        rows.append((r1, r2))
    for n in (700, 712):
        r2 = np.full(n, ord("T"), np.uint8)
        r2[-150:] = ord("C")
        rows.append((np.full(n, ord("A"), np.uint8), r2))
    B = len(rows)
    read1 = np.zeros((B, L), np.uint8)
    read2 = np.zeros((B, L), np.uint8)
    len1 = np.zeros(B, np.int32)
    len2 = np.zeros(B, np.int32)
    for i, (r1, r2) in enumerate(rows):
        read1[i, :len(r1)], read2[i, :len(r2)] = r1, r2
        len1[i], len2[i] = len(r1), len(r2)
    pos = np.arange(L)[None, :]
    rows_ = np.arange(B)[:, None]
    idx2 = len2[:, None] - 1 - pos
    seq2rc = np.where(idx2 >= 0, _COMPLEMENT[read2[rows_, np.maximum(idx2, 0)]], 0)
    rng = np.random.default_rng(seed)
    inside = np.stack([pos < len1[:, None], pos < len2[:, None]])
    quals = np.where(inside, rng.integers(35, 75, size=(2, B, L)), 0).astype(np.uint8)
    return (read1, read2, seq2rc.astype(np.uint8), len1, len2, np.minimum(len1, len2),
            quals)


POLY = (b"A" * 20, b"T" * 20)   # adapters that the homopolymer pairs match


def decide_case(B: int, L: int, device: torch.device, a1: bytes, a2: bytes,
                ec: bool = False, seed: int = 0, dirty: bool = False,
                **params) -> Case:
    """``seqpurge_decide`` on the scans of ``adapter_pairs`` (the same
    ``dirty``) with ``pair_quals``; see ``decide_case_for``."""
    read1, read2, seq2rc, len1, len2, min_len = adapter_pairs(B, L, a1, a2, seed, dirty)
    quals = pair_quals(len1, len2, L, seed, dirty)
    return decide_case_for(read1, read2, seq2rc, len1, len2, min_len, quals, device,
                           a1, a2, ec, **params)


def decide_case_for(read1, read2, seq2rc, len1, len2, min_len, quals,
                    device: torch.device, a1: bytes, a2: bytes,
                    ec: bool = False, **params) -> Case:
    """``seqpurge_decide`` on the scans of these numpy pairs (as ``pairs``
    returns them) with these ``[2, B, L]`` qualities and SeqPurge's default
    parameters (``PARAMS``, each overridden by ``params``). The kernel and
    the plain version each correct their own
    copy of the reads with ``ec``. ``inputs``: (scans, ins, bases, quals,
    lens, table, need, params), the reads as given (never corrected).

    Bytes: the counts the decisions must read (insert counts at offsets
    1..min_len-1, two int16; adapter counts of pairs without an insert up to
    each read's first hit, or its length, two bytes), the bases of the final
    reads (the N trim reads at least those), lengths, results and
    accumulators; a floor, leaving out the evidence counts and table entries
    at the candidates and the quality trim's reads. Operations: 4 per offset
    examined."""
    from ..core.basicstats import match_probability_table
    B, L = read1.shape
    t = [torch.from_numpy(a).to(device) for a in (read1, read2, seq2rc, len1, len2, min_len)]
    scans, ins = seqpurge_scans(*t, a1, a2)
    table = torch.from_numpy(match_probability_table(0.25, sp.MAXLEN)).to(device)
    lens = torch.stack(t[3:5])
    params = dict(PARAMS, ec=ec, **params)
    need = sp.decide_thresholds(table, params["match_perc"], params["mep"])

    def inputs():
        return (torch.from_numpy(np.stack([read1, read2])).to(device),
                torch.from_numpy(quals.copy()).to(device),
                torch.empty((3, B), dtype=torch.int32, device=device),
                torch.zeros(sp.ACC_SIZE, dtype=torch.int64, device=device))

    kb, kq, kout, kacc = inputs()
    pb, pq, pout, pacc = inputs()
    # the work these inputs need, from the plain version's own steps
    cb, cq, cout, cacc = inputs()
    sp.seqpurge_decide_plain(scans, ins, cb, cq, lens, table, cout, cacc, **params)
    best = sp.insert_offsets_plain(scans, ins, lens, table, params["match_perc"],
                                   params["mep"])
    hits = sp.first_hits_plain(scans, lens, table, params["match_perc"], params["mep"])
    ln = lens.to(torch.int64)
    inserts = int((ln.min(0).values - 1).clamp(min=0).sum())
    adapters = 0
    for hit, n in zip(hits, ln):
        adapters += int(torch.where(hit >= 0, hit + 1, n)[best < 0].sum())
    return Case("seqpurge_decide", sp.seqpurge_decide_into,
                lambda: sp.seqpurge_decide_into(scans, ins, kb, kq, lens, table, need,
                                                kout, kacc, **params),
                lambda: sp.seqpurge_decide_plain(scans, ins, pb, pq, lens, table, pout,
                                                 pacc, **params),
                lambda: ([kout, kacc, kb, kq], [pout, pacc, pb, pq]),
                bytes=4 * inserts + 2 * adapters + int(cout[1:].to(torch.int64).sum())
                + 8 * B + 12 * B + 8 * sp.ACC_SIZE,
                ops=4 * (inserts + adapters), inputs=(scans, ins, *inputs()[:2], lens,
                                                      table, need, params))


# --------------------------------------------------------------------------
# MappingQC: C1, C2, B1
# --------------------------------------------------------------------------

def coverage_spans(span: int, n: int, seed: int = 0, max_len: int = 400,
                   pile: int = 0, pile_len: int = 50):
    """``n`` half-open spans over positions 0..span-1 as the host makes them
    for C1's span form (int32 starts and exclusive ends): lengths 0..``max_len``
    (some 0), clipped to the span, some starting at 0 and some ending at
    ``span``; then ``pile`` spans over one window of ``pile_len`` positions,
    for coverage far above the histogram's range."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, span + 1, size=n)
    ends = np.minimum(starts + rng.integers(0, max_len + 1, size=n), span)
    edge = rng.random(n)
    starts[edge < 0.01] = 0
    ends[edge > 0.99] = span
    if pile:
        at = int(rng.integers(0, max(span - pile_len, 0) + 1))
        starts = np.concatenate([starts, np.full(pile, at)])
        ends = np.concatenate([ends, np.full(pile, min(at + pile_len, span))])
    return starts.astype(np.int32), ends.astype(np.int32)


def coverage_add_case(starts: torch.Tensor, ends: torch.Tensor, span: int) -> Case:
    """C1 adding the spans into a ``[span + 1]`` difference array. Bytes:
    the two int32 indices of each span, read once (the counters it adds
    into stay in L2 between batches); operations: two atomic additions a
    span."""
    dk, dp = (torch.zeros(span + 1, dtype=torch.int32, device=starts.device)
              for _ in range(2))
    n = starts.shape[0]
    return Case("coverage_add", dr.coverage_add_into,
                lambda: dr.coverage_add_into(starts, ends, dk),
                lambda: dr.coverage_add_plain(starts, ends, dp),
                lambda: ([dk], [dp]), bytes=8 * n, ops=2 * n)


def roi_reads(n: int, seed: int = 0, n_chroms: int = 3, n_regions: int = 60,
              width: int = 100_000):
    """A ROI and ``n`` reads as MappingQC's scan hands them to C1's read
    form. The ROI: ``n_regions`` sorted, disjoint regions of 1-400 bp a
    chromosome (some of one base, some touching the one before) on each of
    ``n_chroms`` chromosomes of ``width`` bases, as int64 (chromosome,
    1-based start, inclusive end), chromosome by chromosome. The reads, on
    every chromosome: int64 (chromosome, 1-based start, inclusive end, and
    the range ``[i0, i1)`` of the ROI's regions each overlaps, as
    ``RoiLookup.overlap_range`` finds it), mostly 20-300 bp near the
    regions, with reads that end at a region's first base or start at its
    last, reads in no region, reads of no reference length (``end = start -
    1``), reads over many regions (up to 30 kb, as a spliced alignment
    spans) and reads over the ROI's last region."""
    rng = np.random.default_rng(seed)
    rc, rs, re = [], [], []
    for c in range(n_chroms):
        gaps = rng.integers(1, 2 * width // n_regions, size=n_regions)
        lens = rng.integers(1, 401, size=n_regions)
        lens[::9] = 1
        gaps[5::11] = 1    # touching the region before
        s = 1 + np.cumsum(gaps) + np.concatenate(([0], np.cumsum(lens[:-1])))
        rc.append(np.full(n_regions, c))
        rs.append(s)
        re.append(s + lens - 1)
    rc, rs, re = (np.concatenate(a).astype(np.int64) for a in (rc, rs, re))
    k = rng.integers(0, n_regions * n_chroms, size=n)  # a region each read is near
    chrom = rc[k]
    qs = rs[k] + rng.integers(-300, 300, size=n)
    qe = qs + rng.integers(19, 300, size=n)
    kind = rng.random(n)
    at_end = kind < 0.05                   # a read ending at its region's first base
    qe[at_end] = rs[k][at_end]
    qs[at_end] = qe[at_end] - rng.integers(0, 150, size=int(at_end.sum()))
    at_start = (kind >= 0.05) & (kind < 0.10)   # ... starting at its last
    qs[at_start] = re[k][at_start]
    qe[at_start] = qs[at_start] + rng.integers(0, 150, size=int(at_start.sum()))
    empty = (kind >= 0.10) & (kind < 0.13)
    qe[empty] = qs[empty] - 1              # no reference length
    long = (kind >= 0.13) & (kind < 0.16)
    qe[long] = qs[long] + rng.integers(1000, 30_000, size=int(long.sum()))
    last = (kind >= 0.16) & (kind < 0.18)   # over the ROI's last region
    chrom[last] = n_chroms - 1
    qs[last] = rs[-1] + rng.integers(-200, int(re[-1] - rs[-1]) + 1, size=int(last.sum()))
    qe[last] = qs[last] + rng.integers(0, 300, size=int(last.sum()))
    off = kind >= 0.97                    # in no region: past a chromosome's last one
    qs[off] = re[(chrom[off] + 1) * n_regions - 1] + rng.integers(1, 5000, size=int(off.sum()))
    qe[off] = qs[off] + 150
    qs = np.maximum(qs, 1)
    qe = np.maximum(qe, qs - 1)
    i0, i1 = np.zeros(n, np.int64), np.zeros(n, np.int64)
    for c in range(n_chroms):
        m = chrom == c
        lo = c * n_regions
        i0[m] = lo + np.searchsorted(re[lo:lo + n_regions], qs[m], side="left")
        i1[m] = np.maximum(lo + np.searchsorted(rs[lo:lo + n_regions], qe[m], side="right"),
                           i0[m])
    return (rc, rs, re), (chrom, qs, qe, i0, i1)


def coverage_add_reads_case(reads: torch.Tensor, regions: torch.Tensor, span: int) -> Case:
    """C1's read form adding the reads (int32 ``[4, k]``) clipped to the
    regions (int32 ``[3, n]``, as ``DeviceCoverage`` holds them) into a
    ``[span + 1]`` difference array; kernel and plain version add at the
    same indices, so the arrays themselves are compared. Bytes: 16 a read
    and 12 a region that a read's range holds, read once (the counters it
    adds into stay in L2 between batches); operations: two atomic additions
    a (read, region) pair."""
    dk, dp = (torch.zeros(span + 1, dtype=torch.int32, device=reads.device)
              for _ in range(2))
    k, n = reads.shape[1], regions.shape[1]
    _, _, i0, i1 = reads.cpu().numpy().astype(np.int64)
    i0 = np.clip(i0, 0, n)
    i1 = np.maximum(np.clip(i1, 0, n), i0)
    held = np.zeros(n + 1, dtype=np.int64)   # regions in some read's range
    np.add.at(held, i0, 1)
    np.add.at(held, i1, -1)
    regions_read = int((np.cumsum(held)[:n] > 0).sum())
    return Case("coverage_add_reads", dr.coverage_add_reads_into,
                lambda: dr.coverage_add_reads_into(reads, regions, dk),
                lambda: dr.coverage_add_reads_plain(reads, regions, dp),
                lambda: ([dk], [dp]), bytes=16 * k + 12 * regions_read,
                ops=2 * int((i1 - i0).sum()))


def coverage_diff(starts: np.ndarray, ends: np.ndarray, span: int,
                  device: torch.device) -> torch.Tensor:
    """The int32 difference array of the spans (as C1 leaves it)."""
    diff = np.zeros(span + 1, dtype=np.int64)
    np.add.at(diff, starts, 1)
    np.add.at(diff, ends, -1)
    return torch.from_numpy(diff.astype(np.int32)).to(device)


def coverage_finalize_case(diff: torch.Tensor, step: int, hist_max: int,
                           bins: int, half_depth: int, dense: bool = False) -> Case:
    """C2 on a difference array: histogram and half-depth count, and with
    ``dense`` the dense coverage too. Bytes: the array read once, the
    outputs written once; operations: an addition and two compares a
    position."""
    dev = diff.device
    span = diff.shape[0] - 1

    def outputs():
        return [torch.zeros(bins, dtype=torch.int64, device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev)] + (
            [torch.zeros(span, dtype=torch.int32, device=dev)] if dense else [])

    ok, op = outputs(), outputs()
    return Case("coverage_finalize", dr.coverage_finalize_into,
                lambda: dr.coverage_finalize_into(diff, step, hist_max, half_depth, *ok),
                lambda: dr.coverage_finalize_plain(diff, step, hist_max, half_depth, *op),
                lambda: (ok, op),
                bytes=4 * (span + 1) + 8 * (bins + 1) + (4 * span if dense else 0),
                ops=3 * span)


def coverage_dense_case(diff: torch.Tensor) -> Case:
    """C2 making only the dense coverage. Bytes: the array read once, the
    coverage written once; operations: an addition a position."""
    span = diff.shape[0] - 1
    ck, cp = (torch.zeros(span, dtype=torch.int32, device=diff.device) for _ in range(2))
    return Case("coverage_finalize", dr.coverage_finalize_into,
                lambda: dr.coverage_finalize_into(diff, 1, 0, 0, None, None, ck),
                lambda: dr.coverage_finalize_plain(diff, 1, 0, 0, None, None, cp),
                lambda: ([ck], [cp]), bytes=4 * (span + 1) + 4 * span, ops=span)


def coverage_regions(span: int, n: int, seed: int = 0, max_len: int = 400,
                     disjoint: bool = False):
    """``n`` regions over positions 0..span-1 as (int64 starts, inclusive
    ends), with the edges the tools give R1 and R2: regions of one base, one
    at position 0, one ending at the last position, one over the whole span;
    with ``disjoint`` sorted regions that neither overlap nor touch (as a
    merged panel), else in random order, overlapping and repeated."""
    rng = np.random.default_rng(seed)
    if disjoint:
        gaps = rng.integers(1, max_len + 1, size=n)
        lens = rng.integers(1, max_len + 1, size=n)
        lens[::7] = 1
        starts = np.cumsum(gaps) + np.concatenate(([0], np.cumsum(lens[:-1])))
        starts -= starts[0]
        ends = starts + lens - 1
        keep = ends < span
        starts, ends = starts[keep], ends[keep]
        if len(ends):
            ends[-1] = span - 1
        return starts.astype(np.int64), ends.astype(np.int64)
    starts = rng.integers(0, span, size=n)
    ends = np.minimum(starts + rng.integers(0, max_len, size=n), span - 1)
    ends[::7] = starts[::7]
    edges_s = np.array([0, span - 1, 0, 0, span - 1])
    edges_e = np.array([0, span - 1, span - 1, span - 1, span - 1])
    starts = np.concatenate([starts, edges_s, starts[:3]])
    ends = np.concatenate([ends, edges_e, ends[:3]])
    return starts.astype(np.int64), ends.astype(np.int64)


# R1's inputs that its tiling treats differently (``r1_regions``)
R1_KINDS = ("exome", "straddling", "overlapping", "longer than a tile", "one position",
            "dense panel")


def r1_regions(kind: str, seed: int = 0) -> tuple[int, np.ndarray, np.ndarray]:
    """(span, int64 starts, inclusive ends) of regions over positions
    0..span-1 that R1's tiling treats differently: ``exome`` 3,000
    disjoint 1-400 bp regions over a box of 1,000,003 positions (tiles of a
    few hundred positions, a piece or two each); ``straddling`` 20,000
    regions of 1-60 positions laid end to end, so tiles begin and end inside
    them at every phase and most pieces are summed a lane each; ``overlapping``
    3,000 regions of 1-400 bp in random order, overlapping and repeated;
    ``longer than a tile`` 2,000 short regions and 12 of 9,000-40,000
    positions (more than a tile's 8,192) among them; ``one position`` 5,000
    regions of one position, a fifth of them repeated; ``dense panel``
    250,000 disjoint 1-400 bp regions over 60,000,017 positions (tiles of
    8,192 with many pieces each, for the card only)."""
    rng = np.random.default_rng(seed)
    if kind == "exome":
        span = 1_000_003
        return (span, *coverage_regions(span, 3000, seed=seed, disjoint=True))
    if kind == "straddling":
        lens = rng.integers(1, 61, size=20_000)
        starts = np.concatenate(([0], np.cumsum(lens[:-1])))
        return int(lens.sum()) + 5, starts, starts + lens - 1
    if kind == "overlapping":
        span = 200_003
        return (span, *coverage_regions(span, 3000, seed=seed))
    if kind == "longer than a tile":
        span = 700_001
        s, e = coverage_regions(span, 2000, seed=seed, max_len=100, disjoint=True)
        ls = rng.integers(0, span - 40_000, size=12)
        le = ls + rng.integers(9_000, 40_000, size=12)
        order = rng.permutation(len(s) + 12)
        return span, np.concatenate([s, ls])[order], np.concatenate([e, le])[order]
    if kind == "one position":
        span = 50_021
        s = rng.integers(0, span, size=5000)
        s[::5] = s[1::5]
        return span, s, s.copy()
    if kind == "dense panel":
        span = 60_000_017
        return (span, *coverage_regions(span, 250_000, seed=seed, disjoint=True, max_len=200))
    raise ValueError(f"no R1 regions of kind {kind!r}")


def _region_tensors(cov: torch.Tensor, starts: np.ndarray, ends: np.ndarray):
    s, off = dr.region_offsets(starts, ends)
    return (torch.from_numpy(s).to(cov.device), torch.from_numpy(off).to(cov.device),
            int(off[-1]))


def region_sums_case(cov: torch.Tensor, starts: np.ndarray, ends: np.ndarray) -> Case:
    """R1 summing the int32 coverage over the regions (inclusive bounds).
    Bytes: 4 a position of each region, the regions' starts and offsets
    read once, 8 a region written; operations: an addition a position."""
    s, off, total = _region_tensors(cov, starts, ends)
    n = s.shape[0]
    ok, op = (torch.zeros(n, dtype=torch.int64, device=cov.device) for _ in range(2))
    return Case("region_sums", dr.region_sums_into,
                lambda: dr.region_sums_into(cov, s, off, ok),
                lambda: dr.region_sums_plain(cov, s, off, op),
                lambda: ([ok], [op]), bytes=4 * total + 12 * n + 8 + 8 * n, ops=total)


def threshold_runs_case(cov: torch.Tensor, starts: np.ndarray, ends: np.ndarray,
                        cutoff: int, is_high: bool) -> Case:
    """R2 finding the runs below ``cutoff`` (at or above with ``is_high``)
    in disjoint regions. Bytes: 4 a position of each region, the regions'
    starts and offsets read once, the two totals and 12 a run written (the
    runs that these inputs have); operations: a compare a position.
    ``device_fn`` launches both passes into outputs sized by a first call,
    without the fetch between them."""
    s, off, total = _region_tensors(cov, starts, ends)
    got: dict = {}

    def kernel():
        got["kernel"] = dr.threshold_runs(cov, s, off, cutoff, is_high)

    def plain():
        got["plain"] = dr.threshold_runs_plain(cov, s, off, cutoff, is_high)

    n_runs = int(dr.threshold_runs_plain(cov, s, off, cutoff, is_high).shape[1])
    case = Case("threshold_runs", dr.threshold_runs, kernel, plain,
                lambda: ([got["kernel"]], [got["plain"]]),
                bytes=4 * total + 12 * s.shape[0] + 8 + 16 + 12 * n_runs, ops=total)
    if cov.is_cuda:
        scratch = dr.runs_scratch(cov)
        out = torch.empty(3, max(n_runs, 1), dtype=torch.int32, device=cov.device)

        def device_fn():
            dr.runs_count(cov, s, off, cutoff, is_high, scratch)
            if n_runs:
                dr.runs_write(cov, s, off, cutoff, is_high, scratch, out)

        case.device_fn = device_fn
    return case


# BAM's CIGAR ops M I D N S H P = X, drawn with these weights
_OP_WEIGHTS = np.array([0.40, 0.08, 0.08, 0.06, 0.08, 0.05, 0.03, 0.11, 0.11])
_QUERY_OPS = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=bool)
_MATCH_OPS = np.array([1, 0, 0, 0, 0, 0, 0, 1, 1], dtype=bool)


def alignment_records(n: int, seed: int = 0, start: int = 0, width: int = 20_000,
                      n_refs: int = 1, ordered: bool = True, long_n: int = 0,
                      no_seq: float = 0.02, no_qual: float = 0.05, max_ops: int = 8):
    """``n`` alignment records as numpy columns of a BAM batch (``ref_id``,
    ``pos``, ``flag``, ``mapq``, ``l_seq``, ``n_cigar``, ``cigar``,
    ``cigar_off``, ``qual``, ``seq_off``): positions over ``[start, start +
    width)`` on ``n_refs`` chromosomes, coordinate-sorted unless not
    ``ordered``; 1 to ``max_ops`` CIGAR ops a record (a few none), every op (M I D N S H P
    = X) with lengths 1-40, N ops up to ``long_n`` bases (when given);
    qualities 0-41, a share ``no_qual`` of the records all 0xFF ("no
    qualities") and a share ``no_seq`` with no SEQ (``l_seq`` 0 though
    their CIGAR has M ops); some duplicates, secondary, supplementary and
    unmapped records and MAPQ 0, which the tools' filter drops; ``seq``, the
    4-bit base codes at the qualities' offsets (``seq_off``): mostly A, C,
    G and T, some N and a few other codes."""
    rng = np.random.default_rng(seed)
    n_ops = rng.integers(1, max_ops + 1, size=n)
    n_ops[rng.random(n) < 0.02] = 0
    total = int(n_ops.sum())
    op = rng.choice(9, size=total, p=_OP_WEIGHTS)
    length = rng.integers(1, 41, size=total)
    if long_n:
        is_n = op == 3
        length[is_n] = rng.integers(1, long_n + 1, size=int(is_n.sum()))
    cigar = (length.astype(np.uint32) << 4) | op.astype(np.uint32)
    cigar_off = np.concatenate(([0], np.cumsum(n_ops))).astype(np.int64)
    rec_of = np.repeat(np.arange(n), n_ops)
    qlen = np.bincount(rec_of, weights=length * _QUERY_OPS[op], minlength=n).astype(np.int64)
    l_seq = np.where(rng.random(n) < no_seq, 0, qlen).astype(np.int32)
    seq_off = np.concatenate(([0], np.cumsum(l_seq))).astype(np.int64)
    qual = rng.integers(0, 42, size=int(seq_off[-1])).astype(np.uint8)
    for r in np.flatnonzero(rng.random(n) < no_qual):
        qual[seq_off[r]:seq_off[r + 1]] = 0xFF
    ref_id = rng.integers(0, n_refs, size=n).astype(np.int32)
    pos = rng.integers(start, start + width, size=n).astype(np.int32)
    if ordered:
        order = np.lexsort((pos, ref_id))
        ref_id, pos = ref_id[order], pos[order]
    flag = rng.choice(np.array([0, 0x400, 0x100, 0x800, 0x4, 0x2, 0x1, 0x10], np.uint16),
                      size=n, p=[0.5, 0.05, 0.03, 0.02, 0.02, 0.2, 0.1, 0.08])
    mapq = np.where(rng.random(n) < 0.05, 0, rng.integers(1, 61, size=n)).astype(np.uint8)
    seq = rng.choice(np.array([1, 2, 4, 8, 15, 0, 3], np.uint8), size=len(qual),
                     p=[0.23, 0.23, 0.23, 0.23, 0.04, 0.02, 0.02])
    return dict(ref_id=ref_id, pos=pos, flag=flag, mapq=mapq, l_seq=l_seq,
                n_cigar=n_ops.astype(np.int32), cigar=cigar, cigar_off=cigar_off,
                qual=qual, seq_off=seq_off, seq=seq)


def records_keys(cols: dict, keep: np.ndarray) -> np.ndarray:
    """C1's record form's keys: a record's ``ref_id`` where ``keep``, else
    -1."""
    return np.where(keep, cols["ref_id"], -1).astype(np.int32)


def coverage_add_records_case(rec: dr.Records, r0: int, r1: int, ref: int,
                              min_baseq: int, blocks: torch.Tensor, span: int) -> Case:
    """C1's record form adding records ``[r0, r1)`` with key ``ref`` into a
    ``[span + 1]`` difference array at ``blocks`` (int64 ``[3, n]``). The
    outputs compared are the coverages (prefix sums of the arrays): where a
    run of bases goes in as one span on the card, the plain version adds its
    positions one by one. Bytes: what the kernel must read once: 4 a
    record's key, 4 a kept record's position, 8 an offset of its CIGAR (and
    of its qualities), 4 a CIGAR word, with ``min_baseq`` one quality byte a
    base of its M, = and X ops, and the blocks (atomics not counted);
    operations: an addition a CIGAR word and a compare a quality byte."""
    dk, dp = (torch.zeros(span + 1, dtype=torch.int32, device=rec.pos.device)
              for _ in range(2))
    keys = rec.keep[r0:r1].cpu().numpy()
    kept = np.flatnonzero(keys == ref) + r0
    off = rec.cigar_off.cpu().numpy()
    words = int((off[kept + 1] - off[kept]).sum())
    match_bases = 0
    if min_baseq > 0 and len(kept):
        cig = rec.cigar.cpu().numpy().view(np.uint32)
        at = np.concatenate([np.arange(off[r], off[r + 1]) for r in kept]).astype(np.int64)
        op = cig[at] & 0xF
        match_bases = int(((cig[at] >> 4) * (op < 9) * _MATCH_OPS[np.minimum(op, 8)]).sum())
    offsets = 8 * (len(kept) + 1) * (2 if min_baseq > 0 else 1)
    nbytes = 4 * (r1 - r0) + 4 * len(kept) + offsets + 4 * words + match_bases + 24 * blocks.shape[1]
    return Case("coverage_add_records", dr.coverage_add_records_into,
                lambda: dr.coverage_add_records_into(rec, r0, r1, ref, min_baseq, blocks, dk),
                lambda: dr.coverage_add_records_plain(rec, r0, r1, ref, min_baseq, blocks, dp),
                lambda: ([torch.cumsum(dk[:span].to(torch.int64), 0)],
                         [torch.cumsum(dp[:span].to(torch.int64), 0)]),
                bytes=nbytes, ops=words + match_bases)


def pileup_loci(cols: dict, n: int, seed: int = 0, n_refs: int = 1, edges: int = 0,
                duplicates: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(chromosome numbers, 1-based positions) of ``n`` loci, unsorted, over
    the records of ``alignment_records``' columns: random positions in
    their range on chromosomes ``1..n_refs`` (a record's ``ref_id`` r is
    chromosome r + 1), ``edges`` more at the first and last base of random
    ops of random records, and ``duplicates`` repeats of loci already
    drawn."""
    rng = np.random.default_rng(seed)
    lo, hi = int(cols["pos"].min()) + 1, int(cols["pos"].max()) + 400
    chrs = rng.integers(1, n_refs + 1, size=n)
    pos = rng.integers(lo, hi, size=n)
    if edges:
        op, length = cols["cigar"] & 0xF, (cols["cigar"] >> 4).astype(np.int64)
        ref_len = length * np.isin(op, [0, 2, 3, 7, 8])
        rec_of = np.repeat(np.arange(len(cols["pos"])), np.diff(cols["cigar_off"]))
        before = np.cumsum(ref_len) - ref_len
        start = (cols["pos"][rec_of].astype(np.int64) + 1 + before
                 - before[cols["cigar_off"][:-1][rec_of]])
        pick = rng.choice(np.flatnonzero(ref_len > 0), size=edges)
        at_end = rng.random(edges) < 0.5
        pos = np.concatenate([pos, start[pick] + np.where(at_end, ref_len[pick] - 1, 0)])
        chrs = np.concatenate([chrs, cols["ref_id"][rec_of[pick]].astype(np.int64) + 1])
    if duplicates:
        again = rng.integers(0, len(pos), size=duplicates)
        pos, chrs = np.concatenate([pos, pos[again]]), np.concatenate([chrs, chrs[again]])
    shuffle = rng.permutation(len(pos))
    return chrs[shuffle].astype(np.int64), pos[shuffle].astype(np.int64)


def pileup_case(rec: dr.Records, loci: torch.Tensor, table: torch.Tensor, min_mapq: int,
                min_baseq: int, track_mapq0: bool) -> Case:
    """B1's record form counting a batch's records at ``loci`` (``table``:
    each reference's range of them, as ``DevicePileup`` holds them), with
    MAPQ-0 counters or without, into counters of their own. Bytes, a floor
    of what the kernel must read once: 16 a record (its position, key, MAPQ
    and CIGAR offset), the loci and the table; for the records that reach a
    locus, their CIGAR words, one more offset and one base and one quality
    byte a base it counts; the counters written once (atomics not counted).
    Operations: an addition a CIGAR word of those records and a compare a
    locus they reach."""
    n = loci.shape[0]
    outs = [torch.zeros((7 if track_mapq0 else 5) * n, dtype=torch.int32, device=loci.device)
            for _ in range(2)]
    views = [(o[:4 * n].view(n, 4), o[4 * n:5 * n],
              *((o[5 * n:6 * n], o[6 * n:]) if track_mapq0 else ())) for o in outs]
    _, _, _, _, a, b, (rec_of, _, _, _, _) = dr._pileup_records(rec, loci, table)
    reach = b > a
    words = int(reach[rec_of].sum())
    bases = int((dr.pileup_hits(rec, loci, table, min_mapq, min_baseq)[2] < dr.DELETION).sum())
    nbytes = (16 * rec.pos.shape[0] + 4 * n + 4 * table.numel() + 4 * words
              + 8 * int(reach.sum()) + 2 * bases + 4 * outs[0].numel())
    return Case("pileup_add_records", dr.pileup_add_records_into,
                lambda: dr.pileup_add_records_into(rec, loci, table, min_mapq, min_baseq,
                                                   *views[0]),
                lambda: dr.pileup_add_records_plain(rec, loci, table, min_mapq, min_baseq,
                                                    *views[1]),
                lambda: ([outs[0]], [outs[1]]), bytes=nbytes,
                ops=words + int((b - a).clamp(min=0).sum()))


# B1's record form at its edges: alignment_records' arguments (each with
# records without SEQ, 0xFF qualities, every CIGAR op, MAPQ 0 and flags the
# filter drops); the loci lie on all but the last chromosome
PILEUP_EDGES = {
    "sorted, three chromosomes, one without loci": dict(n=4000, seed=51, width=20_000,
                                                        n_refs=3),
    "unsorted, two chromosomes": dict(n=4000, seed=52, width=20_000, n_refs=3, ordered=False),
    "a pile on a few loci": dict(n=3000, seed=53, start=5000, width=40, n_refs=2),
    "long N ops": dict(n=3000, seed=54, width=200_000, n_refs=2, long_n=20_000),
}
# (min_mapq, min_baseq, track_mapq0, include_not_properly_paired)
PILEUP_PARAMS = ((1, 13, False, False), (0, 0, True, True), (20, 20, True, False),
                 (1, 13, True, True), (1, 256, False, True))


def pileup_keys(cols: dict, include_not_properly_paired: bool) -> np.ndarray:
    """The pileup's keys of ``alignment_records``' columns: a record's
    ``ref_id`` unless it is secondary, supplementary, a duplicate or
    unmapped or (unless ``include_not_properly_paired``) not properly
    paired, else -1."""
    flag = cols["flag"]
    keep = (flag & 0xD04) == 0
    if not include_not_properly_paired:
        keep &= (flag & 0x2) != 0
    return records_keys(cols, keep)


def pileup_edge_case(label: str, params: tuple, device: torch.device) -> Case:
    """B1's record form on ``PILEUP_EDGES[label]``'s records at 300 random
    loci, 300 at the first or last base of an op and 30 repeated, with
    ``PILEUP_PARAMS``' ``params``."""
    args = PILEUP_EDGES[label]
    min_mapq, min_baseq, track_mapq0, npp = params
    cols = alignment_records(**args)
    n_refs = args.get("n_refs", 1)
    chrs, pos = pileup_loci(cols, 300, seed=args["seed"], n_refs=max(n_refs - 1, 1),
                            edges=300, duplicates=30)
    engine = dr.DevicePileup(chrs, pos, np.arange(1, n_refs + 1), track_mapq0, device)
    rec = dr.upload_records(cols["pos"], pileup_keys(cols, npp), cols["cigar_off"],
                            cols["cigar"], cols["seq_off"], cols["qual"], seq=cols["seq"],
                            mapq=cols["mapq"], device=device)
    return pileup_case(rec, engine.loci, engine.table, min_mapq, min_baseq, track_mapq0)


def indel_loci(cols: dict, n: int, seed: int = 0, n_refs: int = 1, window: int = 1,
               duplicates: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(chromosome numbers, 1-based positions) of loci for B1's indel form,
    unsorted, over ``alignment_records``' columns on chromosomes
    ``1..n_refs``: ``n`` at random in their range, ``n`` at an I or D op's
    reference position ``g`` (``pos + 1`` plus the reference before the op:
    an I op first in its record at its first aligned base, last past its
    last) offset by ``-window``, 0 or ``window`` (the window's edges and its
    middle) and a few by ``window + 1`` (just outside), and ``duplicates``
    repeats of loci already drawn."""
    rng = np.random.default_rng(seed)
    lo, hi = int(cols["pos"].min()) + 1, int(cols["pos"].max()) + 400
    chrs = rng.integers(1, n_refs + 1, size=n)
    pos = rng.integers(lo, hi, size=n)
    op, length = cols["cigar"] & 0xF, (cols["cigar"] >> 4).astype(np.int64)
    ref_len = length * np.isin(op, [0, 2, 3, 7, 8])
    rec_of = np.repeat(np.arange(len(cols["pos"])), np.diff(cols["cigar_off"]))
    before = np.cumsum(ref_len) - ref_len
    g = (cols["pos"][rec_of].astype(np.int64) + 1 + before
         - before[cols["cigar_off"][:-1][rec_of]])
    indel = np.flatnonzero(np.isin(op, [1, 2]) & (cols["ref_id"][rec_of] < n_refs))
    pick = rng.choice(indel, size=n)
    shift = rng.choice(np.array([-window, 0, window, -window - 1, window + 1]), size=n,
                       p=[0.3, 0.3, 0.3, 0.05, 0.05])
    pos = np.concatenate([pos, g[pick] + shift])
    chrs = np.concatenate([chrs, cols["ref_id"][rec_of[pick]].astype(np.int64) + 1])
    if duplicates:
        again = rng.integers(0, len(pos), size=duplicates)
        pos, chrs = np.concatenate([pos, pos[again]]), np.concatenate([chrs, chrs[again]])
    shuffle = rng.permutation(len(pos))
    return chrs[shuffle].astype(np.int64), pos[shuffle].astype(np.int64)


def indel_capacity(rec: dr.Records, chrs: np.ndarray, pos: np.ndarray,
                   window: int) -> int:
    """What ``DevicePileup.add`` reckons for B1's indel form: the records'
    I and D ops times the most loci in any ``2 * window + 1`` positions of
    one chromosome."""
    engine = dr.DevicePileup(chrs, pos, np.zeros(0, np.int64), device="cpu",
                             indel_window=window, count_bases=False)
    return dr.count_indel_ops(rec.cigar.cpu().numpy().view(np.uint32)) * engine.indel_depth


def sorted_hits(hits: torch.Tensor) -> torch.Tensor:
    """Hits in order of record, query offset, CIGAR word and locus (the
    kernel writes them in any order)."""
    h = hits.cpu()
    if h.shape[0] == 0:
        return h
    key = np.lexsort(tuple(h[:, c].numpy() for c in (1, 3, 2, 0)))
    return h[torch.from_numpy(key)]


def pileup_indels_case(rec: dr.Records, loci: torch.Tensor, table: torch.Tensor,
                       min_mapq: int, window: int, capacity: int,
                       loci_range: tuple[int, int] | None = None) -> Case:
    """B1's indel form finding a batch's I and D ops within ``window`` of
    ``loci`` into an output of ``capacity`` hits (``indel_capacity``), at
    the loci ``loci_range`` (``DevicePileup.reaching``'s; all without it)
    and on a scratch and a ring of pinned slots of its own; the outputs
    compared are the kernel's hits and the plain version's over every locus,
    both sorted. Bytes, a floor
    of what the kernel must read and write once: 16 a record (its position,
    key, MAPQ and CIGAR offset), the loci and the table, the CIGAR words of
    the records whose key has loci and whose MAPQ passes, one more offset a
    record with an I op (its SEQ's end), and 32 a hit and the count
    written. Operations: a compare a CIGAR word of those records and a
    locus a hit."""
    out = dr.indel_out(capacity, loci.device)
    scratch, ring = dr.indel_scratch(loci.device), dr.HitRing()
    cut = (0, loci.shape[0]) if loci_range is None else loci_range
    got: dict = {}
    r, _, _, _, _, _, (rec_of, op, _, _, _) = dr._pileup_records(rec, loci, table)
    passes = (rec.mapq[r].to(torch.int64) >= min(max(int(min_mapq), 0), 256))[rec_of]
    words = int(passes.sum())
    with_ins = int(torch.unique(rec_of[passes & (op == 1)]).shape[0])
    hits = dr.pileup_indels_plain(rec, loci, table, min_mapq, window).shape[0]
    nbytes = (16 * rec.pos.shape[0] + 4 * loci.shape[0] + 4 * table.numel() + 4 * words
              + 8 * with_ins + 32 * hits + 8)

    def kernel():
        got["kernel"] = dr.pileup_indels_into(rec, loci, table, min_mapq, window, out,
                                              loci_range=cut, scratch=scratch, ring=ring)

    def plain():
        got["plain"] = dr.pileup_indels_plain(rec, loci, table, min_mapq, window)

    return Case("pileup_indels", dr.pileup_indels_into, kernel, plain,
                lambda: ([sorted_hits(got["kernel"])], [sorted_hits(got["plain"])]),
                bytes=nbytes, ops=words + hits,
                inputs=(rec, loci, table, min_mapq, window, out, cut, scratch, ring),
                device_fn=lambda: dr._pileup_indels_launch(rec, loci, table, min_mapq,
                                                           window, out, cut, scratch))


def record_ends(cols: dict) -> np.ndarray:
    """Each record's 1-based inclusive reference end (``BamBatch.
    end_positions``) of ``alignment_records``' columns."""
    op, length = cols["cigar"] & 0xF, (cols["cigar"] >> 4).astype(np.int64)
    rec_of = np.repeat(np.arange(len(cols["pos"])), np.diff(cols["cigar_off"]))
    ref_len = np.bincount(rec_of, weights=length * np.isin(op, [0, 2, 3, 7, 8]),
                          minlength=len(cols["pos"])).astype(np.int64)
    return cols["pos"].astype(np.int64) + ref_len


# B1's indel form at its edges: alignment_records' arguments (every CIGAR op,
# so I and D ops first and last in records, records without SEQ, MAPQ 0 and
# flags the filter drops), the window and MAPQ cut of each case, and its loci:
# indel_loci's n (300 by default) on its n_refs chromosomes (all but the
# records' last by default) and ``far`` more on chromosome 2 past the
# records' reach, so that chromosome's range of the loci the batch reaches is
# empty. The loci a launch reaches are staged in shared memory up to
# dr.INDEL_STAGED_LOCI and searched in global memory past it (200,000 loci).
INDEL_EDGES = {
    "sorted, window 0": (dict(n=4000, seed=61, width=20_000, n_refs=3), 0, 1, {}),
    "unsorted, window 1": (dict(n=4000, seed=62, width=20_000, n_refs=3, ordered=False), 1, 1,
                           {}),
    "a pile, window 1, min_mapq 20": (dict(n=3000, seed=63, start=5000, width=60, n_refs=2),
                                      1, 20, {}),
    "window 3, min_mapq 0": (dict(n=4000, seed=64, width=20_000, n_refs=3), 3, 0, {}),
    "200,000 loci on one chromosome, in global memory": (
        dict(n=4000, seed=65, width=20_000, n_refs=2), 1, 1, dict(n=100_000, n_refs=1)),
    "a chromosome whose reached range is empty": (
        dict(n=4000, seed=66, width=20_000, n_refs=3), 1, 1, dict(n_refs=1, far=300)),
}


def indel_edge_inputs(label: str, device: torch.device):
    """``INDEL_EDGES[label]``'s batch on ``device`` as the sweep hands it to
    B1's indel form: (records, the engine, min_mapq, window, capacity, the
    loci range ``DevicePileup.reaching`` finds), the filter's keys with not
    properly paired records kept, every record up."""
    args, window, min_mapq, at = INDEL_EDGES[label]
    cols = alignment_records(**args)
    n_refs = args.get("n_refs", 1)
    chrs, pos = indel_loci(cols, at.get("n", 300), seed=args["seed"],
                           n_refs=at.get("n_refs", max(n_refs - 1, 1)), window=window,
                           duplicates=60)
    if at.get("far"):
        beyond = int(cols["pos"].max()) + 10_000 + window
        chrs = np.concatenate([chrs, np.full(at["far"], 2)])
        pos = np.concatenate([pos, beyond + np.arange(at["far"]) * 3])
    engine = dr.DevicePileup(chrs, pos, np.arange(1, n_refs + 1), device=device,
                             indel_window=window, count_bases=False)
    keys = pileup_keys(cols, True)
    _, loci_range = engine.reaching(cols["pos"], record_ends(cols), keys)
    rec = dr.upload_records(cols["pos"], keys, cols["cigar_off"], cols["cigar"],
                            cols["seq_off"], cols["qual"], seq=cols["seq"], mapq=cols["mapq"],
                            device=device)
    return rec, engine, min_mapq, window, indel_capacity(rec, chrs, pos, window), loci_range


def pileup_indel_edge_case(label: str, device: torch.device) -> Case:
    """B1's indel form on ``INDEL_EDGES[label]``'s records at their loci:
    random, at the window's edges and middle around I and D ops and 60
    repeated, at the loci range the pre-filter finds."""
    rec, engine, min_mapq, window, capacity, loci_range = indel_edge_inputs(label, device)
    return pileup_indels_case(rec, engine.loci, engine.table, min_mapq, window, capacity,
                              loci_range)


def spanless(cols: dict, share: float, seed: int = 0) -> dict:
    """``alignment_records``' columns with a ``share`` of the records made
    reads of no reference span: their M, = and X ops become I ops (the same
    query) and their D and N ops H ops (no query), so only I, S, H and P ops
    remain and a record's end lies before its start."""
    rng = np.random.default_rng(seed)
    pick = rng.random(len(cols["pos"])) < share
    rec_of = np.repeat(np.arange(len(cols["pos"])), np.diff(cols["cigar_off"]))
    op, length = cols["cigar"] & 0xF, cols["cigar"] >> 4
    on = pick[rec_of]
    op = np.where(on & _MATCH_OPS[np.minimum(op, 8)], 1, op)
    op = np.where(on & np.isin(op, [2, 3]), 5, op)
    return dict(cols, cigar=((length << 4) | op).astype(np.uint32))


def indel_regions(cols: dict, n: int, seed: int = 0, n_refs: int = 1, longest: int = 500,
                  duplicates: int = 0, missing: int = 0):
    """(chromosome numbers, 1-based inclusive starts and ends) of indel
    regions for B1's region form over ``alignment_records``' columns on
    chromosomes ``1..n_refs``, unsorted: ``n`` at random in their range, of
    0-60 bases and a tenth of 100 to ``longest``; ``n`` around an I or D
    op's reference position ``g`` with ``g`` at their start, their end, inside
    or just outside; ``n // 4`` exactly a record's span or one base inside
    it at either end; ``n // 4`` under a long N op (from its ``g``, or inside
    it), where the spanning read's N op takes it off the depth; ``duplicates``
    repeats, and ``missing`` more on a chromosome the BAM lacks."""
    rng = np.random.default_rng(seed)
    lo, hi = int(cols["pos"].min()) + 1, int(cols["pos"].max()) + 400
    op, length = cols["cigar"] & 0xF, (cols["cigar"] >> 4).astype(np.int64)
    ref_len = length * np.isin(op, [0, 2, 3, 7, 8])
    rec_of = np.repeat(np.arange(len(cols["pos"])), np.diff(cols["cigar_off"]))
    before = np.cumsum(ref_len) - ref_len
    g = (cols["pos"][rec_of].astype(np.int64) + 1 + before
         - before[cols["cigar_off"][:-1][rec_of]])
    on = cols["ref_id"][rec_of] < n_refs
    chrs, starts, ends = [], [], []

    def add(c, s, e):
        chrs.append(np.asarray(c, np.int64))
        starts.append(np.asarray(s, np.int64))
        ends.append(np.asarray(e, np.int64))

    width = np.where(rng.random(n) < 0.1, rng.integers(100, longest + 1, size=n),
                     rng.integers(0, 61, size=n))
    s0 = rng.integers(lo, hi, size=n)
    add(rng.integers(1, n_refs + 1, size=n), s0, s0 + width)
    pick = rng.choice(np.flatnonzero(np.isin(op, [1, 2]) & on), size=n)
    left = rng.choice(np.array([0, 0, 1, 2, 5, -1]), size=n)
    right = rng.choice(np.array([0, 0, 1, 3, 6, -1]), size=n)
    add(cols["ref_id"][rec_of[pick]] + 1, g[pick] - left, g[pick] + right)
    spans = np.flatnonzero((cols["ref_id"] < n_refs) & (np.diff(cols["cigar_off"]) > 0))
    rec = rng.choice(spans, size=n // 4)
    r_start = cols["pos"][rec].astype(np.int64) + 1
    r_end = r_start - 1 + np.bincount(rec_of, weights=ref_len,
                                      minlength=len(cols["pos"])).astype(np.int64)[rec]
    inset = rng.integers(0, 2, size=(2, n // 4))
    add(cols["ref_id"][rec] + 1, r_start + inset[0], r_end - inset[1])
    skips = np.flatnonzero((op == 3) & (length > 20) & on)
    if len(skips):
        k = rng.choice(skips, size=n // 4)
        inner = rng.random(n // 4) < 0.5
        add(cols["ref_id"][rec_of[k]] + 1, g[k] + np.where(inner, 5, 0),
            g[k] + length[k] - np.where(inner, 5, 0))
    chrs, starts, ends = (np.concatenate(x) for x in (chrs, starts, ends))
    if duplicates:
        again = rng.integers(0, len(starts), size=duplicates)
        chrs, starts, ends = (np.concatenate([x, x[again]]) for x in (chrs, starts, ends))
    if missing:
        s0 = rng.integers(lo, hi, size=missing)
        chrs = np.concatenate([chrs, np.full(missing, n_refs + 7)])
        starts, ends = np.concatenate([starts, s0]), np.concatenate([ends, s0 + 20])
    shuffle = rng.permutation(len(starts))
    return chrs[shuffle], starts[shuffle], ends[shuffle]


def region_capacity(rec: dr.Records, engine: dr.DeviceRegions) -> int:
    """What the sweep reckons for B1's region form: the records' I and D
    ops times the most regions over any one position."""
    return dr.count_indel_ops(rec.cigar.cpu().numpy().view(np.uint32)) * engine.depth


def sorted_region_hits(hits: torch.Tensor) -> torch.Tensor:
    """Region hits in order of record, CIGAR index and region (the kernel
    writes them in any order)."""
    h = hits.cpu()
    if h.shape[0] == 0:
        return h
    key = np.lexsort(tuple(h[:, c].numpy() for c in (1, 3, 0)))
    return h[torch.from_numpy(key)]


def pileup_regions_case(rec: dr.Records, regions: torch.Tensor, table: torch.Tensor,
                        capacity: int, regions_range: tuple[int, int] | None = None) -> Case:
    """B1's region form over a batch's records at ``regions`` (``table``:
    each reference's range of them and its longest, as ``DeviceRegions``
    holds them) into counters of its own and an output of ``capacity``
    hits, at the regions ``regions_range`` (``DeviceRegions.reaching``'s;
    all without it), on a scratch and a ring of pinned slots of its own; the
    outputs compared are the counters and the hits, sorted, the plain
    version's over every region. Bytes, a floor of what the kernel must read
    and write once: 16 a record (its position, key, MAPQ and CIGAR offset),
    the CIGAR words of the records that overlap a region, the regions and
    the table, 40 a hit and 12 a region (the counters) written once.
    Operations: a compare a CIGAR word of those records and an (record,
    region) pair."""
    n = regions.shape[1]
    counters = [torch.zeros((dr.REGION_COUNTERS, n), dtype=torch.int32, device=regions.device)
                for _ in range(2)]
    out = dr.region_out(capacity, regions.device)
    scratch, ring = dr.indel_scratch(regions.device), dr.HitRing()
    cut = (0, n) if regions_range is None else tuple(regions_range)
    got: dict = {}
    pairs, _, hits = dr.pileup_region_pairs(rec, regions, table)
    reached = torch.unique(pairs[:, 0])
    off = rec.cigar_off[reached]
    words = int((rec.cigar_off[reached + 1] - off).sum())
    nbytes = (16 * rec.pos.shape[0] + 4 * words + 4 * regions.numel() + 4 * table.numel()
              + 40 * hits.shape[0] + 12 * n + 8)

    def kernel():
        got["kernel"] = dr.pileup_regions_into(rec, regions, table, counters[0], out,
                                               regions_range=cut, scratch=scratch, ring=ring)

    def plain():
        got["plain"] = dr.pileup_regions_plain(rec, regions, table, counters[1])

    return Case("pileup_regions", dr.pileup_regions_into, kernel, plain,
                lambda: ([counters[0], sorted_region_hits(got["kernel"])],
                         [counters[1], sorted_region_hits(got["plain"])]),
                bytes=nbytes, ops=words + pairs.shape[0],
                inputs=(rec, regions, table, counters[0], out, cut, scratch, ring),
                device_fn=lambda: dr._pileup_regions_launch(rec, regions, table, counters[0],
                                                            out, cut, scratch))


# B1's region form at its edges: alignment_records' arguments (every CIGAR op,
# so I and D ops first and last in records and an I and a D op at one g,
# records without SEQ, MAPQ 0 and flags the filter drops), the share of reads
# of no reference span, and indel_regions' arguments (regions on all but the
# records' last chromosome by default: random, long, around I and D ops, at
# records' spans, under long N ops, repeated, on a chromosome the BAM lacks;
# ``refs``, not indel_regions', the BAM's references where they are more than
# the records'); a launch that reaches about 6,000 regions, dense and up to
# 500 bases long, so that each thread walks many of them; and a table of
# 1,100 references.
REGION_EDGES = {
    "sorted, three chromosomes, one without regions": (
        dict(n=4000, seed=71, width=20_000, n_refs=3), 0.0, dict(n=300, duplicates=40,
                                                                 missing=20)),
    "unsorted, reads of no reference span": (
        dict(n=4000, seed=72, width=20_000, n_refs=3, ordered=False), 0.05,
        dict(n=300, duplicates=40)),
    "a pile over overlapping regions": (
        dict(n=3000, seed=73, start=5000, width=80, n_refs=2), 0.02,
        dict(n=200, duplicates=60, longest=150)),
    "long N ops over regions (RNA)": (
        dict(n=3000, seed=74, width=200_000, n_refs=2, long_n=20_000), 0.0,
        dict(n=300, duplicates=20, missing=10)),
    "6,000 regions reached": (
        dict(n=4000, seed=75, width=20_000, n_refs=3), 0.0, dict(n=2500, duplicates=100)),
    "1,100 references": (
        dict(n=4000, seed=76, width=20_000, n_refs=3), 0.0, dict(n=300, missing=20,
                                                                 refs=1100)),
}


def region_edge_columns(label: str, transform: Callable[[dict], dict] | None = None):
    """``REGION_EDGES[label]``'s records (``alignment_records``' columns,
    some made of no reference span by ``spanless``, then ``transform``ed)
    and regions: (columns, chromosome numbers, starts, ends, the number of
    the BAM's references)."""
    args, no_span, at = REGION_EDGES[label]
    at = dict(at)
    n_refs = args.get("n_refs", 1)
    refs = at.pop("refs", n_refs)
    cols = alignment_records(**args)
    if no_span:
        cols = spanless(cols, no_span, seed=args["seed"])
    if transform is not None:
        cols = transform(cols)
    chrs, starts, ends = indel_regions(cols, seed=args["seed"], n_refs=max(n_refs - 1, 1), **at)
    return cols, chrs, starts, ends, refs


def region_edge_inputs(label: str, device: torch.device):
    """``REGION_EDGES[label]``'s batch on ``device`` as the sweep hands it to
    B1's region form: (records, the engine, capacity, the regions range
    ``DeviceRegions.reaching`` finds), the filter's keys with not properly
    paired records kept, every record up."""
    cols, chrs, starts, ends, refs = region_edge_columns(label)
    engine = dr.DeviceRegions(chrs, starts, ends, np.arange(1, refs + 1), device=device)
    keys = pileup_keys(cols, True)
    _, regions_range = engine.reaching(cols["pos"], record_ends(cols), keys)
    rec = dr.upload_records(cols["pos"], keys, cols["cigar_off"], cols["cigar"],
                            mapq=cols["mapq"], device=device)
    return rec, engine, region_capacity(rec, engine), regions_range


def pileup_region_edge_case(label: str, device: torch.device) -> Case:
    """B1's region form on ``REGION_EDGES[label]``'s records at their
    regions, at the regions range the pre-filter finds."""
    rec, engine, capacity, regions_range = region_edge_inputs(label, device)
    return pileup_regions_case(rec, engine.regions, engine.table, capacity, regions_range)


def device_ops(fn: Callable[[], None], device: torch.device) -> int:
    """The device operations (kernels, memsets, copies) one call of ``fn``
    queues on the card: the call captured on a side stream into a CUDA graph
    by the kernel library (``ngs_capture_begin``/``ngs_capture_end``), the
    graph's nodes counted; nothing captured runs. ``fn`` must queue its work
    on the current stream and must not synchronise."""
    import ctypes
    lib = dr._lib()
    side = torch.cuda.Stream(device)
    nodes = ctypes.c_longlong(0)
    torch.cuda.synchronize(device)
    with torch.cuda.stream(side):
        handle = side.cuda_stream
        rc = lib.ngs_capture_begin(handle)
        if rc:
            raise RuntimeError(f"ngs_capture_begin failed with error {rc}")
        try:
            fn()
        finally:
            rc = lib.ngs_capture_end(handle, ctypes.addressof(nodes))
    if rc:
        raise RuntimeError(f"ngs_capture_end failed with error {rc}")
    return int(nodes.value)


def pileup_indices(n_snps: int, n: int, seed: int = 0, hot: int = 0):
    """``n`` counter indices ``snp * 4 + base`` over ``n_snps`` loci as the
    contamination pileup gives B1, in runs of reads over neighbouring loci;
    ``hot`` more on one locus (a deep pile)."""
    rng = np.random.default_rng(seed)
    snp = np.sort(rng.integers(0, n_snps, size=n))
    base = rng.choice(4, size=n, p=[0.7, 0.1, 0.1, 0.1])
    idx = snp * 4 + base
    if hot:
        at = int(rng.integers(0, n_snps))
        idx = np.concatenate([idx, at * 4 + rng.integers(0, 4, size=hot)])
    return idx.astype(np.int32)


def bincount_case(idx: torch.Tensor, size: int) -> Case:
    """B1 counting the indices into ``size`` int32 counters. Bytes: the
    int32 indices read once (the counters stay in L2 between batches);
    operations: an atomic addition an index."""
    ck, cp = (torch.zeros(size, dtype=torch.int32, device=idx.device) for _ in range(2))
    n = idx.shape[0]
    return Case("bincount_add", dr.bincount_add_into,
                lambda: dr.bincount_add_into(idx, ck),
                lambda: dr.bincount_add_plain(idx, cp),
                lambda: ([ck], [cp]), bytes=4 * n, ops=n)


GENOTYPE_KINDS = ("related", "constant", "all 2", "all 255")


def genotype_rows(n: int, seed: int = 0, kind: str = "related") -> np.ndarray:
    """Doubled genotypes ``[2, n]`` uint8 (0, 1, 2) as
    ``pearson_from_genotypes`` uploads them: ``related``, the second row
    equal to the first at nine in ten positions (two samples of one
    person); ``constant``, the first row all 1 (the NaN route); ``all 2``,
    the first row all 2 (sxx = 4n: past 2^31 from n = 2^29); ``all 255``,
    both rows all 255 (out of the genotypes' range, within X7's contract: a
    16-byte step adds 16 * 255^2 to a 32-bit partial, its most)."""
    if kind not in GENOTYPE_KINDS:
        raise ValueError(f"kind must be one of {GENOTYPE_KINDS}, got {kind!r}")
    if kind == "all 255":
        return np.full((2, n), 255, dtype=np.uint8)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, size=n, dtype=np.uint8)
    if kind == "related":
        x = np.where(rng.random(n) < 0.9, y, rng.integers(0, 3, size=n, dtype=np.uint8))
    else:
        x = np.full(n, 1 if kind == "constant" else 2, dtype=np.uint8)
    return np.stack([x, y])


def genotype_overlaps(seed: int = 0):
    """Seeded overlaps of 2-39 genotype pairs, without end: (x2, y2), the
    doubled genotypes (int64 0, 1 and 2) of two samples' shared variants."""
    rng = np.random.default_rng(seed)
    while True:
        n = int(rng.integers(2, 40))
        yield rng.integers(0, 3, n), rng.integers(0, 3, n)


def print4(v: float) -> str:
    """SampleSimilarity's correlation column: four decimals, half up."""
    return f"{Decimal(v).quantize(Decimal(1).scaleb(-4), rounding=ROUND_HALF_UP):.4f}"


def f10_overlaps(count: int, seed: int = 0) -> dict[str, list]:
    """The first ``count`` overlaps of ``genotype_overlaps(seed)`` (as
    genotypes: 0, 0.5 and 1) of each kind whose r from the exact moments
    prints (``print4``) otherwise than the centred float64 form's: ``zero``,
    r = 0 exactly (the centred form prints -0.0000), and ``tie``, another
    exact tie at the fifth decimal (``ROADMAP.md`` F10). The moments are
    summed in numpy and r formed as ``dr.pearson_from_moments`` forms it.
    The two forms are within 1e-12 of each other, so only an r within that
    of a multiple of 1/20000 (a rounding boundary of ``print4``, 0 among
    them) can print otherwise: the prints are compared where 20000·r lies
    within 1e-6 of an integer."""
    found: dict[str, list] = {"zero": [], "tie": []}
    for x2, y2 in genotype_overlaps(seed):
        sums = [int(x2.sum()), int(y2.sum()), int(x2 @ x2), int(y2 @ y2), int(x2 @ y2)]
        exact = dr.pearson_from_moments(len(x2), sums)
        if exact == exact and abs(20000 * exact - round(20000 * exact)) <= 1e-6 \
                and print4(exact) != print4(correlation(x2 / 2, y2 / 2)):
            kind = found["zero" if exact == 0 else "tie"]
            if len(kind) < count:
                kind.append((x2 / 2, y2 / 2))
        if all(len(v) == count for v in found.values()):
            return found


def correlation_moments_on_grid(genotypes: torch.Tensor, out: torch.Tensor, grid: int) -> None:
    """X7's kernel on a grid of ``grid`` blocks whatever n is (so that a
    thread can walk past the steps after which it widens its 32-bit
    partials), through the library's test entry; checks as the wrapper
    does; not counted in the wrapper's launches."""
    n = genotypes.shape[1] if genotypes.dim() == 2 else -1
    dr._check("genotypes", genotypes, torch.uint8, (2, n))
    dr._check("out", out, torch.int64, (5,))
    if genotypes.device.type != "cuda" or out.device != genotypes.device:
        raise ValueError("the test entry takes tensors on one CUDA device")
    rc = dr._lib().ngs_correlation_moments_grid(dr._ptr(genotypes), n, dr._ptr(out), grid,
                                                 dr._stream(out))
    dr._launched("correlation_moments_grid", rc)


def correlation_moments_case(genotypes: torch.Tensor, grid: int | None = None) -> Case:
    """X7 on doubled genotypes ``[2, n]`` (with ``grid``: on that many
    blocks, ``correlation_moments_on_grid``). Bytes: the 2n genotype bytes
    read once, the five int64 sums written; operations: three products and
    five additions a pair."""
    n = genotypes.shape[1]
    ok, op = (torch.zeros(5, dtype=torch.int64, device=genotypes.device) for _ in range(2))
    if grid is None:
        kernel = lambda: dr.correlation_moments_into(genotypes, ok)  # noqa: E731
    else:
        kernel = lambda: correlation_moments_on_grid(genotypes, ok, grid)  # noqa: E731
    return Case("correlation_moments", dr.correlation_moments_into, kernel,
                lambda: dr.correlation_moments_plain(genotypes, op),
                lambda: ([ok], [op]), bytes=2 * n + 40, ops=8 * n)


# ------------------------------------------------ V1 and H1: VariantQC, RohHunter

# V1's edges: (REF, ALT, FILTER, INFO, FORMAT, the first sample's field), as
# the parse leaves them (GT first where FORMAT has it; REF and ALT upper-cased
# by the parse, here also lower-case)
_LONG_INFO = b"CSQ=" + b"A|intron_variant|MODIFIER|" * 2700 + b"x|rs9"   # over 64 KiB
VARIANT_EDGES = [
    (b"A", b"G", b"PASS", b"", b"GT", b"1/1"),                       # no INFO
    (b"C", b"T", b".", b".", b"GT", b"0/1"),                         # INFO "."
    (b"G", b"A", b"", b"CSQ", b"GT:DP", b"1|1:30"),                  # CSQ a flag
    (b"T", b"C", b"PASS", b"CSQ;CSQ=A|x|HIGH|rs1", b"GT", b"1|0"),   # the flag shadows
    (b"A", b"C", b"PASS", b"CSQ=", b"GT", b"0|1"),                   # CSQ empty
    (b"A", b"T", b"PASS", b"CSQX=|rs|HIGH|;XCSQ=|rs;CS=|rs", b"GT", b"1/1"),
    (b"AC", b"A", b"PASS", b"CSQ=|rs", b"GT", b"1/1"),               # |rs at the start
    (b"A", b"AT", b"PASS", b"DP=3;CSQ=a|HIGH|", b"GT", b"0/1"),      # |HIGH| at the end
    (b"A", b"G", b"PASS", b"CSQ=|HIGH|;RS=rs5", b"GT", b"./."),
    (b"A", b"G", b"PASS", b"CSQ=x|r;s|HIGH", b"DP", b"30"),         # no match across ';'
    (b"G", b"A", b"PASS", b"RS=rs123", b"DP:GT", b"30:1/1"),         # RS without CSQ
    (b"G", b"C", b"PASS", b"RS=12;RS=rs1", b"GT", b"1/1"),           # the first RS counts
    (b"C", b"G", b"PASS", b"RS;RS=rs1", b"GT", b"1/1"),              # RS a flag
    (b"C", b"G", b"PASS", b"RS=r;RSX=rs1;AF=0.5", b"GT", b"1/1"),
    (b"A", b"G,T", b"PASS", b"CSQ=||rs", b"GT", b"1/2"),             # multi-allelic
    (b"A", b",G", b"PASS", b"CSQ=|HI|HIGH|", b"GT", b"0/1"),         # ALT's first allele empty
    (b"g", b"a", b"PASS", b"CSQ=|r|rs", b"GT", b"1/1"),              # lower case: transversion
    (b"AC", b"GT", b"PASS", b"CSQ=|HIGH||", b"GT", b"1/1"),          # MNP
    (b"ACG", b"A,AT", b"PASS", b"", b"GT", b"0/1"),
    (b"A", b"G", b"PASS;low", b"CSQ=|rs", b"GT", b"1/1"),
    (b"A", b"G", b"mosaic", b"CSQ=|rs", b"GT", b"1/1"),
    (b"A", b"G", b"low;mosaic", b"", b"GT", b"0/1"),
    (b"A", b"G", b"mosaicX;mosaic2", b"", b"GT", b"0/1"),
    (b"A", b"G", b"low", b"", b"", b""),                             # no FORMAT
    (b"C", b"T", b"PASS", _LONG_INFO, b"GT", b"1|1"),
    (b"C", b"T", b"PASS", b"CSQ=" + b"x" * 70_000 + b"|HIGH|", b"GTX:GT", b"1/1:0/1"),
    (b"T", b"C", b"PASS", b"A=1;CSQ=b=c|rs", b"PS:GT", b"1:1/0"),
    (b"T", b"G", b".", b"CSQ=|rs", b"GT:GT", b"1/1:0/1"),            # the first GT key counts
    (b"", b"", b"PASS", b";;CSQ=;", b"GT", b"1/1:"),
    (b"A", b"G", b"PASS", b"CSQ=x", b"GT", b"0/1/1"),
]
_FUZZ_INFO = b"CSQRsrHIG|=;,x."
_FUZZ_FILTERS = [b"PASS", b".", b"", b"mosaic", b"low;mosaic", b"PASS;mosaic", b"mosaic;",
                 b"PAS", b"PASSx", b"mosai", b";mosaic", b"low"]
_FUZZ_FORMATS = [b"GT", b"DP", b"GT:DP", b"DP:GT", b"", b".", b"GTX:GT", b"G:T", b"GT:GT"]
_FUZZ_GTS = [b"0/1", b"1|1", b"1/1", b"./.", b"1/0", b"0|1", b"1|0", b"0/0", b"", b"1/2",
             b"11", b"1-1"]


def variant_fuzz(n: int, seed: int = 0) -> list[list[bytes]]:
    """V1's inputs at random: ``n`` records as six columns (REF, ALT,
    FILTER, INFO, FORMAT, the first sample's field), INFO a random string
    over ``CSQRsrHIG|=;,x.`` (so CSQ and RS keys, flags, empty entries and
    the patterns at every boundary occur), FILTER, FORMAT and GT drawn from
    the edges' kinds, REF and ALT of 0-3 bases of ``ACGTacg,``."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(_FUZZ_INFO, dtype=np.uint8)
    bases = np.frombuffer(b"ACGTacg,", dtype=np.uint8)
    cols: list[list[bytes]] = [[] for _ in range(6)]
    lens = rng.integers(0, 60, size=n)
    for i in range(n):
        cols[0].append(bases[rng.integers(0, 7, size=int(rng.integers(0, 4)))].tobytes())
        cols[1].append(bases[rng.integers(0, 8, size=int(rng.integers(0, 4)))].tobytes())
        cols[2].append(_FUZZ_FILTERS[int(rng.integers(0, len(_FUZZ_FILTERS)))])
        cols[3].append(alphabet[rng.integers(0, len(alphabet), size=int(lens[i]))].tobytes())
        fk = _FUZZ_FORMATS[int(rng.integers(0, len(_FUZZ_FORMATS)))]
        cols[4].append(fk)
        vals = [_FUZZ_GTS[int(rng.integers(0, len(_FUZZ_GTS)))]
                for _ in range(fk.count(b":") + 1 if fk else 0)]
        cols[5].append(b":".join(vals[:int(rng.integers(0, len(vals) + 1))]))
    return cols


def variant_edge_columns() -> list[list[bytes]]:
    """``VARIANT_EDGES`` as six columns."""
    return [list(c) for c in zip(*VARIANT_EDGES)]


# V1's seams: offsets from the 16-byte chunk that holds a record's first byte,
# where V1's team reads the record in steps of 32 such chunks (512 bytes):
# every offset of the second and third lanes' chunks and across the first
# step's end
SEAM_OFFSETS = tuple(range(16, 48)) + tuple(range(496, 528))
SEAM_ALIGNS = (0, 9)   # the record's first byte in its chunk
SEAM_INFO_LENGTHS = (511, 512, 513, 1025)
_GENOTYPES = (b"1/1", b"0|1", b"1|0", b"0/1", b"1|1", b"1/2")


def _pad(m: int) -> bytes:
    """An INFO prefix of m bytes that ends an entry (``;``), or nothing."""
    return b"F=" + b"x" * (m - 3) + b";" if m >= 3 else b";" * m


def _seam_record(kind: str, d: int, k: int) -> tuple:
    """A record (six fields) whose feature of ``kind`` starts at byte d of
    the record (REF "A", ALT "G", FILTER "PASS" unless the kind moves them,
    so INFO starts at byte 6); k varies what is around it."""
    gt = _GENOTYPES[k % len(_GENOTYPES)]
    if kind == "CSQ=":         # the key's C at d; its value holds both patterns
        return (b"A", b"G", b"PASS", _pad(d - 6) + b"CSQ=A|x|HIGH|y|rs1", b"GT", gt)
    if kind == ";RS=rs":       # the separator before the key at d
        return (b"A", b"G", b"PASS", b"D" * (d - 6) + b";RS=rs" + b"7" * (k % 3), b"GT", gt)
    if kind == "|rs":          # inside a CSQ value: its '|' at d
        return (b"C", b"T", b"PASS", b"CSQ=" + b"x" * (d - 10) + b"|rs" + b"9" * (k % 2),
                b"GT:DP", gt + b":7")
    if kind == "|HIGH|":
        return (b"G", b"A", b"PASS", b"CSQ=" + b"x" * (d - 10) + b"|HIGH|" + b"|" * (k % 2),
                b"GT", gt)
    if kind == "CSQ value end":   # the value's ';' at d: the patterns after it are another entry's
        return (b"T", b"C", b"PASS", b"CSQ=" + b"x" * (d - 13) + b"|rs;Z=|HIGH|rs", b"GT", gt)
    if kind == "ALT ,":        # the first ',' of ALT at d: long first allele, then one base
        if k % 2:
            return (b"A" * (d - 1), b"G,T", b"PASS", b"", b"GT", gt)
        return (b"A", b"C" * (d - 1) + b",T", b"PASS", b"DP=1", b"GT", gt)
    if kind == "GT key":       # FORMAT's key GT at d, after k % 3 other keys
        m = min(d - 7, 20)
        other = (b"", b"DP:", b"GTX:AD:")[k % 3]
        m = max(m - len(other), 0)
        info = b"D" * (d - 7 - m - len(other))
        fmt = b"K" * m + b":" + other + b"GT:DP"
        index = fmt.split(b":").index(b"GT")
        return (b"A", b"G", b"PASS", info, fmt, b":".join([b"5"] * index + [gt, b"9"]))
    if kind == "GT value":     # the sample's GT value at d, its ':' or the field's end after it
        j = min(d - 12, 20)
        return (b"A", b"G", b"PASS", b"D" * (d - 12 - j), b"DP:GT",
                b"3" * j + b":" + gt + (b":5" if k % 2 else b""))
    raise ValueError(kind)


SEAM_KINDS = ("CSQ=", ";RS=rs", "|rs", "|HIGH|", "CSQ value end", "ALT ,", "GT key", "GT value")


def _long_info(length: int, k: int) -> bytes:
    """An INFO of ``length`` bytes: a CSQ value that ends in both patterns,
    an RS value at its end, or CSQ a flag at its end."""
    if k == 0:
        return b"CSQ=" + b"x" * (length - 13) + b"|rs|HIGH|"
    if k == 1:
        return b"A=" + b"y" * (length - 9) + b";RS=rs1"
    return b"DP=" + b"z" * (length - 7) + b";CSQ"


def _long_format(keys: int, k: int) -> tuple[bytes, bytes]:
    """FORMAT with ``keys`` keys before GT (and one after on odd k), and a
    sample with a value for each (one short on every third k)."""
    fmt = b":".join(b"K%d" % j for j in range(keys)) + b":GT" + (b":DP" if k % 2 else b"")
    vals = [b"%d" % (j * 37 % 1000) for j in range(keys)] + [_GENOTYPES[k % len(_GENOTYPES)]]
    if k % 3 == 2:
        vals = vals[:-1]
    return fmt, b":".join(vals)


def variant_seams(kind: str | None = None) -> list[list[bytes]]:
    """V1's seam records as six columns: for each of ``SEAM_KINDS`` (or the
    one named) a record with the feature at each of ``SEAM_OFFSETS`` from
    its first chunk, at each of ``SEAM_ALIGNS``, after a leading record
    whose length puts the record's first byte there (its FILTER PASS, low,
    mosaic or ".": failing ones too). ``"long INFO"``: INFOs of
    ``SEAM_INFO_LENGTHS`` bytes, each three ways; ``"long FORMAT"``: FORMATs
    of 1-40 keys before GT, so that FORMAT and the sample run past the 64
    bytes of them that the kernel copies a record."""
    cols: list[list[bytes]] = [[] for _ in range(vops.FIELDS)]
    at = 0   # the packed bytes so far

    def add(rec):
        nonlocal at
        for c, v in zip(cols, rec):
            c.append(v)
        at += sum(map(len, rec))

    def lead(align: int, k: int):
        filt = (b"PASS", b"low", b"mosaic", b".")[k % 4]
        base = 1 + 1 + len(filt) + 2 + 2 + 3
        add((b"C", b"T", filt, b"L=" + b"z" * ((align - at - base) % 16), b"GT", b"0/1"))

    kinds = SEAM_KINDS + ("long INFO", "long FORMAT") if kind is None else (kind,)
    k = 0
    for name in kinds:
        if name == "long FORMAT":
            for keys in range(1, 41):
                lead(keys % 16, k)
                add((b"A", b"G", b"PASS", b"DP=9", *_long_format(keys, k)))
                k += 1
            continue
        if name == "long INFO":
            for align in (0, 1, 7, 15):
                for length in SEAM_INFO_LENGTHS:
                    for j in range(3):
                        lead(align, k)
                        add((b"A", b"G", b"PASS", _long_info(length, j), b"GT",
                             _GENOTYPES[k % len(_GENOTYPES)]))
                        k += 1
            continue
        for align in SEAM_ALIGNS:
            for t in SEAM_OFFSETS:
                lead(align, k)
                add(_seam_record(name, t - align, k))
                k += 1
    return cols


def _entry_ends(data, starts, ends, semis, n: int, key: bytes) -> torch.Tensor:
    """The end (its ``;`` or INFO's end) of the first INFO entry whose key is
    ``key``, flag or value, a record each; -1 where there is none."""
    pos, rec = vops._entries(data, starts, ends, vops._positions(data, key), key, 3, ord(";"),
                             (ord("="),))
    out = torch.full((n,), -1, dtype=torch.int64, device=data.device)
    out[rec] = torch.minimum(vops._next(semis, pos + len(key)), ends[rec * vops.FIELDS + 3])
    return out


def variant_needed_bytes(data: torch.Tensor, offsets: torch.Tensor,
                         filter_: bool) -> tuple[int, int]:
    """The field bytes V1's counts need from these records, each read once
    in order, and the number of records that count. The bytes: with
    ``filter_`` every record's FILTER, and of the records
    that count (all without ``filter_``): ALT up to and with its first
    ``,``; REF's byte where REF and ALT's first allele are one base each
    (else their lengths, from the offsets, decide); INFO up to and with the
    ``;`` that ends the later of its first CSQ and first RS entries (the whole
    of INFO where either is missing: a scan must reach its end to know);
    FORMAT up to the first key ``GT`` and the byte after it (the whole of it
    where there is none); the sample's field up to its GT value and at most
    four bytes of that value with its end (a longer value is no genotype;
    nothing of the field where FORMAT has no GT, all of it where the field
    has too few values). A CSQ value is counted whole, though a scan that
    has found ``|rs`` and ``|HIGH|`` in it could stop there."""
    n = (offsets.shape[0] - 1) // vops.FIELDS
    if n == 0:
        return 0, 0
    starts, ends = offsets[:-1], offsets[1:]
    field = starts.view(n, vops.FIELDS).t().contiguous()
    field_end = ends.view(n, vops.FIELDS).t().contiguous()
    flen = field_end - field
    big = int(data.shape[0]) + 1
    semis = vops._sentinel(torch.nonzero(data == ord(";")).flatten(), big)
    colons = vops._sentinel(torch.nonzero(data == ord(":")).flatten(), big)
    commas = vops._sentinel(torch.nonzero(data == ord(",")).flatten(), big)

    b = [vops._at(data, field[2] + j) for j in range(4)]
    passing = (flen[2] == 0) | ((flen[2] == 1) & (b[0] == ord("."))) | \
        ((flen[2] == 4) & (b[0] == ord("P")) & (b[1] == ord("A")) & (b[2] == ord("S"))
         & (b[3] == ord("S")))
    counted = passing if filter_ else torch.ones(n, dtype=torch.bool, device=data.device)

    alt_first = torch.minimum(vops._next(commas, field[1]), field_end[1]) - field[1]
    alt = torch.minimum(alt_first + 1, flen[1])
    ref = ((flen[0] == 1) & (alt_first == 1)).to(torch.int64)

    csq = _entry_ends(data, starts, ends, semis, n, b"CSQ")
    rs = _entry_ends(data, starts, ends, semis, n, b"RS")
    info = torch.where((csq >= 0) & (rs >= 0),
                       torch.minimum(torch.maximum(csq, rs) + 1, field_end[3]),
                       field_end[3]) - field[3]

    fmt = flen[4].clone()
    sample = torch.zeros(n, dtype=torch.int64, device=data.device)
    pos, rec = vops._entries(data, starts, ends, vops._positions(data, b"GT"), b"GT", 4,
                             ord(":"))
    fmt[rec] = torch.minimum(pos + 3, field_end[4][rec]) - field[4][rec]
    ki = torch.searchsorted(colons, pos) - torch.searchsorted(colons, field[4][rec])
    ss, se = field[5][rec], field_end[5][rec]
    after = colons[(torch.searchsorted(colons, ss) + ki - 1).clamp(0, colons.shape[0] - 1)]
    has = (ki == 0) | (after < se)
    gs = torch.where(ki == 0, ss, after + 1)
    ge = torch.minimum(vops._next(colons, gs), se)
    sample[rec] = torch.where(has, gs - ss + torch.clamp(ge - gs + (ge < se).to(torch.int64),
                                                         max=4), se - ss)

    per = ref + alt + info + fmt + sample
    total = int(per[counted].sum()) + (int(flen[2].sum()) if filter_ else 0)
    return total, int(counted.sum())


def variant_classify_case(data: torch.Tensor, offsets: torch.Tensor, filter_: bool) -> Case:
    """V1 on packed records (``variants.pack_fields``). Bytes: the field
    bytes the counts need (``variant_needed_bytes``) and the offsets they
    need (with ``filter_``: FILTER's two a record and four more a record
    that counts; without: all of them), read once, the nine int64 counts
    written; operations: a compare a needed field byte."""
    n = (offsets.shape[0] - 1) // vops.FIELDS
    field_bytes, counted = variant_needed_bytes(data, offsets, filter_)
    offset_bytes = 8 * (2 * n + 4 * counted if filter_ else offsets.shape[0])
    ok, op = (torch.zeros(len(vops.COUNTERS), dtype=torch.int64, device=data.device)
              for _ in range(2))
    return Case("variant_classify", vops.variant_classify_into,
                lambda: vops.variant_classify_into(data, offsets, filter_, ok),
                lambda: vops.variant_classify_plain(data, offsets, filter_, op),
                lambda: ([ok], [op]), bytes=field_bytes + offset_bytes + 72,
                ops=field_bytes)


VARIANT_FUZZ = 20_000   # random records of ``variant_cases``


def variant_cases(device: torch.device, seed: int = 0) -> list:
    """V1 at its edges (``VARIANT_EDGES``, no records, ``variant_seams``'
    records and ``VARIANT_FUZZ`` records of ``variant_fuzz``), with and
    without the FILTER test: (label, case)."""
    out = []
    for label, cols in (("edges", variant_edge_columns()), ("no records", [[]] * 6),
                        ("seams", variant_seams()),
                        (f"{VARIANT_FUZZ} random records", variant_fuzz(VARIANT_FUZZ, seed))):
        data, offsets = (t.to(device) for t in vops.pack_fields(cols))
        for filter_ in (True, False):
            out.append((f"{label}{'' if filter_ else ' -ignore_filter'}",
                        variant_classify_case(data, offsets, filter_)))
    return out


def roh_products_case(af: torch.Tensor, ranges: torch.Tensor) -> Case:
    """H1 on float64 allele frequencies and ``[k, 2]`` inclusive ranges;
    its outputs compared as their bit patterns. Bytes: 8 a marker covered
    (each range's markers read once), 16 a range read and 8 a product
    written; operations: two multiplies a marker covered."""
    k = ranges.shape[0]
    ok, op = (torch.zeros(k, dtype=torch.float64, device=af.device) for _ in range(2))
    m = af.shape[0]
    s, e = ranges[:, 0], ranges[:, 1]
    covered = int(torch.where((s >= 0) & (e < m), (e - s + 1).clamp(min=0), 0).sum()) if k else 0
    return Case("roh_products", vops.roh_products_into,
                lambda: vops.roh_products_into(af, ranges, ok),
                lambda: vops.roh_products_plain(af, ranges, op),
                lambda: ([ok.view(torch.int64)], [op.view(torch.int64)]),
                bytes=8 * covered + 24 * k, ops=2 * covered, inputs=(af, ranges))


def roh_edge_inputs(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """H1's edges: 1,000 allele frequencies (float32 values as float64, as
    RohHunter keeps them: Beta draws, 0.01 floors, some exactly 0, a block
    of 1e-30s and 1e-6s whose products go subnormal and then underflow to
    0, a block near 1) and ranges: single markers (first, last and others),
    the whole array, runs over the zeros, into and past the subnormal block,
    an empty range and two outside the array (NaN)."""
    rng = np.random.default_rng(seed)
    m = 1_000
    af = np.maximum(rng.beta(0.6, 2.5, size=m), 0.01).astype(np.float32)
    af[100:110] = 0.0
    af[200:215] = np.float32(1e-30)   # af² 1e-60: five make 1e-300
    af[205:208] = np.float32(1e-6)    # then 1e-312 (subnormal), then 0
    af[300:340] = np.float32(0.999999)
    ranges = [(0, 0), (m - 1, m - 1), (5, 5), (0, m - 1), (95, 105), (100, 100), (200, 204),
              (200, 205), (200, 206), (200, 214), (190, 230), (300, 339), (7, 6), (-1, 3),
              (m - 2, m)]
    starts = np.sort(rng.integers(0, m, size=300))
    ranges += [(int(a), int(min(a + rng.integers(0, 60), m - 1))) for a in starts]
    return af.astype(np.float64), np.array(ranges, dtype=np.int64)


def roh_exit(sq: np.ndarray) -> int:
    """The index of the first square at which the ordered product of ``sq``
    (float64) leaves the positive finite numbers, or -1 where it never does
    (``multiply.accumulate`` multiplies in index order)."""
    with np.errstate(over="ignore", under="ignore", invalid="ignore"):
        p = np.multiply.accumulate(sq)
    left = np.flatnonzero(~((p > 0) & (p < np.inf)))
    return int(left[0]) if len(left) else -1


ROH_NANS = (0x7FF8000000000123, 0xFFF8000000000000, 0xFFF0000000000001, 0x7FF4000000000000)


def roh_exit_edges(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """H1's early exit at its edges: float64 allele frequencies in blocks and
    ranges over them. Long runs (1,600 markers of ``roh_edge_inputs``'
    Beta draws) whose product reaches 0 and then meets one +inf or NaN af:
    at the first marker after the exit, within the exit's 32-marker chunk,
    at the range's last marker and 1,000 markers past the exit; +inf before
    any 0 (a -inf af); a product that overflows to +inf (af 1e30) and then
    meets a 0; NaN af with a payload, with the sign bit set, signalling,
    and two different ones in one range; -0.0 and -inf af; 4,000 markers at
    af 1.0 (no exit: the chain's worst case); ranges whose start and end
    fall at each offset of a 32-marker chunk, and whose exit does; a range
    of one and of eight and nine markers around an exit."""
    rng = np.random.default_rng(seed)
    blocks: list[np.ndarray] = []
    ranges: list[tuple[int, int]] = []
    nans = [np.array([b], dtype=np.uint64).view(np.float64)[0] for b in ROH_NANS]

    def block(af) -> int:
        blocks.append(np.asarray(af, dtype=np.float64))
        return sum(len(b) for b in blocks) - len(blocks[-1])

    def run(size: int) -> np.ndarray:
        return np.maximum(rng.beta(0.6, 2.5, size=size), 0.01).astype(np.float32).astype(
            np.float64)

    for bad in (np.inf, nans[0]):
        for where in ("after", "chunk", "last", "far"):
            af = run(1_600)
            x = roh_exit(af * af)
            while x % 32 > 29:  # room after the exit within its chunk
                af = af[1:]
                x -= 1
            j = {"after": x + 1, "chunk": x + 2 + (29 - x % 32) // 2, "last": len(af) - 1,
                 "far": x + 1_000}[where]
            af[j] = bad
            b = block(af)
            ranges += [(b, b + len(af) - 1), (b, b + j - 1), (b + x, b + len(af) - 1)]
    af = run(1_200)  # +inf before any 0, then a 0: NaN
    af[10], af[900] = -np.inf, 0.0
    b = block(af)
    ranges += [(b, b + 899), (b, b + 1_199), (b + 10, b + 10), (b + 11, b + 1_199)]
    af = np.concatenate([np.full(10, np.float32(1e30), np.float64), run(60), [-0.0], run(1_000)])
    b = block(af)  # overflow to +inf at the 6th marker, then a 0 (-0.0): NaN
    ranges += [(b, b + 69), (b, b + len(af) - 1), (b + 3, b + 75), (b + 70, b + 70)]
    for k, nan in enumerate(nans):  # a NaN before the exit, after it, and two NaNs
        af = run(1_500)
        x = roh_exit(af * af)
        af[x // 2] = nan
        af[x + 40 + k] = nans[(k + 1) % len(nans)]
        af[x + 700] = -np.inf
        b = block(af)
        ranges += [(b, b + len(af) - 1), (b + x // 2, b + x // 2), (b + x // 2 + 1, b + x + 40 + k),
                   (b + x // 2 + 1, b + len(af) - 1), (b + x + 41 + k, b + len(af) - 1)]
    b = block(np.ones(4_000))
    ranges += [(b, b + 3_999), (b + 1, b + 3_998)]
    af = run(400)  # every start, end and exit offset of a chunk
    af[300], af[306] = 0.0, np.inf
    b = block(af)
    for o in range(32):
        ranges += [(b + o, b + o + 40 + o), (b + 300 - 64 - o, b + 310 + o),
                   (b + 300 - o, b + 306), (b + 300 - o, b + 305), (b + 299, b + 299 + o)]
    ranges += [(b + 300, b + 300), (b + 292, b + 299), (b + 292, b + 300), (b + 298, b + 306)]
    return np.concatenate(blocks), np.array(ranges, dtype=np.int64)


def roh_chain(af: np.ndarray, ranges: np.ndarray) -> dict:
    """What bounds H1 at these inputs: the longest range in [0, m), and the
    longest chain of dependent multiplies before the product leaves the
    positive finite numbers (a range's length where it never does)."""
    m, longest, chain = len(af), 0, 0
    for s, e in ranges.tolist():
        if s < 0 or e >= m or e < s:
            continue
        longest = max(longest, e - s + 1)
        if e - s + 1 <= chain:
            continue  # cannot beat the longest chain so far
        with np.errstate(over="ignore", invalid="ignore"):
            x = roh_exit(af[s:e + 1] * af[s:e + 1])
        chain = max(chain, x + 1 if x >= 0 else e - s + 1)
    return {"longest_range": longest, "longest_chain": chain}


def roh_cases(device: torch.device, seed: int = 0) -> list:
    """H1 at its edges, ``roh_edge_inputs`` and ``roh_exit_edges`` joined
    (the former's ranges as they were, the latter's after its 1,000
    markers, and ranges outside the joined array), and with no range:
    (label, case)."""
    af0, r0 = roh_edge_inputs(seed)
    af1, r1 = roh_exit_edges(seed)
    m = len(af0) + len(af1)
    out = np.array([(m - 2, m), (m, m), (-3, -1), (5, m + 7), (1 << 62, 5)], dtype=np.int64)
    af = torch.from_numpy(np.concatenate([af0, af1])).to(device)
    ranges = torch.from_numpy(np.concatenate([r0, r1 + len(af0), out])).to(device)
    return [("edges", roh_products_case(af, ranges)),
            ("no ranges", roh_products_case(af, torch.zeros((0, 2), dtype=torch.int64,
                                                            device=device)))]


def device_ms(fn: Callable[[], None], calls: int = 10, runs: int = 5) -> float:
    """Device milliseconds per call, without the host's work in the wrapper:
    ``calls`` calls captured once in a CUDA graph, the graph replayed between
    two CUDA events; the median of ``runs`` replays, after warm-up. Inputs
    that fit the L2 cache stay there from one call to the next."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def cold_ms(fn: Callable[[], None], runs: int = 20,
            flush_bytes: int = 128 << 20, clean: bool = True) -> float:
    """Device milliseconds of one call that finds its inputs outside the L2
    cache: each call follows an overwrite of a ``flush_bytes`` buffer, with
    CUDA events around the call alone; the median of ``runs``. With
    ``clean`` the buffer is also read after the overwrite, so the L2 holds
    clean lines and the call does not pay for writing back the overwrite's
    dirty ones. A spin of about half a millisecond on the card follows, so
    the call is queued before the card is free and the wrapper's host work
    is not in the time (without it a wrapper with 50 us of Python work came
    out up to 0.04 ms slow, now and then, on the H100). Five unrecorded
    rounds come first: without them the first cold timing in a process came
    out up to three times the later ones on the H100."""
    fn()
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    times = []
    for i in range(runs + 5):  # the first five warm the loop up
        torch.cuda.synchronize()
        flush.fill_(i & 0xFF)
        if clean:
            flush.max()
        torch.cuda._sleep(1_000_000)  # clock cycles
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[5:])


def call_ms(fn: Callable[[], None], runs: int = 5, calls: int = 10) -> float:
    """Milliseconds per wrapper call, host work included: the median over
    ``runs`` of ``calls`` back-to-back calls between two CUDA events, after
    warm-up. For a kernel the difference to ``device_ms`` is the wrapper's
    host overhead; for a plain version (which may synchronise or allocate,
    and so cannot be captured in a graph) it is the time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def max_abs_err(case: Case) -> int:
    """Largest absolute difference between kernel and plain outputs (after
    each ran the same number of times). Integer outputs: 0 means equal."""
    got, want = case.outputs()
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise ValueError(f"{case.name}: output {tuple(g.shape)}/{g.dtype} "
                             f"vs plain {tuple(w.shape)}/{w.dtype}")
        if g.numel():
            d = (g.to(torch.int64) - w.to(torch.int64)).abs().max()
            err = max(err, int(d))
    return err
