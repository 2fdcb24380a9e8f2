"""B1's indel form on the CPU: ``pileup_indels_plain`` (through
``DevicePileup``, ``indel_pileup_at_positions`` and
``pileup_at_positions(..., indel_window=w)``) against the JAX package's
``ngsbits_tpu/qc/pileup.py::indel_pileup_at_positions`` (its host loop) and
``pileup_at_positions`` on the same seeded batches
(``selfcheck.alignment_records``: every CIGAR op, so insertions first and
last in records; built as both packages' ``BamBatch`` and handed to both as
their reader) and on synthetic BAMs with germline indels
(``utils/synth.py``): loci at the window's edges and middle, just outside
it, duplicate and unsorted, a chromosome without loci, window 0/1/3,
min_mapq 0/1/20, ``include_not_properly_paired``; the one sweep against the
JAX package's two. Records without SEQ that hold an I op are kept out of the
parity inputs (ROADMAP F11: the JAX package keys such an insertion with the
next record's bases; ``test_an_insertion_past_its_records_seq_...`` shows
it); the others are handed to the JAX package with N bases of their query
length (F9). Integer outputs and dicts: exact equality."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ngsbits_tpu.io.bam import BamBatch as JaxBatch  # noqa: E402
from ngsbits_tpu.qc import pileup as jax_pileup  # noqa: E402

from ngsbits_tpu_torch.io.bam import BamBatch as PortBatch  # noqa: E402
from ngsbits_tpu_torch.ops import device_reduce as dr  # noqa: E402
from ngsbits_tpu_torch.ops import selfcheck  # noqa: E402
from ngsbits_tpu_torch.qc import pileup as port_pileup  # noqa: E402
from ngsbits_tpu_torch.utils import synth  # noqa: E402

REFS = ["chr1", "chr2", "chr3"]   # chromosome numbers 1-3; chr3 gets no loci
CODES = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6, "=": 7, "X": 8}
NIBBLE = {ord("A"): 1, ord("C"): 2, ord("G"): 4, ord("T"): 8, ord("N"): 15}


@pytest.fixture(autouse=True)
def _cpu_route(monkeypatch):
    monkeypatch.setenv("NGSBITS_TORCH_DEVICE", "cpu")


def _query_lengths(cols: dict) -> np.ndarray:
    n = len(cols["pos"])
    op, length = cols["cigar"] & 0xF, (cols["cigar"] >> 4).astype(np.int64)
    rec_of = np.repeat(np.arange(n), np.diff(cols["cigar_off"]))
    return np.bincount(rec_of, weights=length * np.isin(op, [0, 1, 4, 7, 8]),
                       minlength=n).astype(np.int64)


def _subset(cols: dict, keep: np.ndarray) -> dict:
    """The records ``keep`` (a boolean mask) of ``alignment_records``'
    columns."""
    rows = np.flatnonzero(keep)
    co, so = cols["cigar_off"], cols["seq_off"]
    cig = np.concatenate([np.arange(co[r], co[r + 1]) for r in rows] + [np.zeros(0, int)])
    seq = np.concatenate([np.arange(so[r], so[r + 1]) for r in rows] + [np.zeros(0, int)])
    n_cigar, l_seq = cols["n_cigar"][rows], cols["l_seq"][rows]
    return dict(ref_id=cols["ref_id"][rows], pos=cols["pos"][rows], flag=cols["flag"][rows],
                mapq=cols["mapq"][rows], l_seq=l_seq, n_cigar=n_cigar,
                cigar=cols["cigar"][cig.astype(np.int64)],
                cigar_off=np.concatenate(([0], np.cumsum(n_cigar))).astype(np.int64),
                qual=cols["qual"][seq.astype(np.int64)], seq=cols["seq"][seq.astype(np.int64)],
                seq_off=np.concatenate(([0], np.cumsum(l_seq))).astype(np.int64))


def _without_seqless_insertions(cols: dict) -> dict:
    """The batch less its records without SEQ that hold an I op (F11)."""
    op = cols["cigar"] & 0xF
    rec_of = np.repeat(np.arange(len(cols["pos"])), np.diff(cols["cigar_off"]))
    has_i = np.bincount(rec_of[op == 1], minlength=len(cols["pos"])) > 0
    return _subset(cols, ~(has_i & (cols["l_seq"] == 0)))


def _with_n(cols: dict) -> dict:
    """Each record without SEQ given N bases (and 0xFF qualities) of its
    query length, for the JAX package (F9)."""
    l_seq = np.where(cols["l_seq"] == 0, _query_lengths(cols), cols["l_seq"]).astype(np.int32)
    so = cols["seq_off"]

    def fill(column, value):
        parts = [column[a:b] if ls else np.full(m, value, np.uint8)
                 for a, b, ls, m in zip(so[:-1], so[1:], cols["l_seq"], l_seq)]
        return np.concatenate(parts + [np.zeros(0, np.uint8)])

    return dict(cols, l_seq=l_seq, seq=fill(cols["seq"], 15), qual=fill(cols["qual"], 0xFF),
                seq_off=np.concatenate(([0], np.cumsum(l_seq))).astype(np.int64))


def _batch(cls, cols: dict):
    n = len(cols["pos"])
    z = np.zeros(n, np.int32)
    names = [b"r%d" % (i // 2) for i in range(n)]
    name_off = np.concatenate(([0], np.cumsum([len(x) for x in names]))).astype(np.int64)
    return cls(ref_id=cols["ref_id"], pos=cols["pos"], flag=cols["flag"], mapq=cols["mapq"],
               l_seq=cols["l_seq"], n_cigar=cols["n_cigar"], tlen=z, mate_ref_id=z,
               mate_pos=z, cigar=cols["cigar"], cigar_off=cols["cigar_off"], seq=cols["seq"],
               qual=cols["qual"], seq_off=cols["seq_off"], names=b"".join(names),
               name_off=name_off, tags=np.zeros(0, np.uint8), tags_off=np.zeros(n + 1, np.int64))


class _Reader:
    """Batches handed to the pileups as the reader they open."""

    def __init__(self, batches):
        self.batches = batches
        self.ref_names = REFS

    def __iter__(self):
        return iter(self.batches)

    def close(self):
        pass


def _readers(monkeypatch, batches: list[dict]):
    """Both packages' pileups open readers of these batches (the JAX package
    with N bases where there is no SEQ)."""
    monkeypatch.setattr(jax_pileup, "BamReader",
                        lambda *a, **k: _Reader([_batch(JaxBatch, _with_n(c)) for c in batches]))
    monkeypatch.setattr(port_pileup, "BamReader",
                        lambda *a, **k: _Reader([_batch(PortBatch, c) for c in batches]))


def _seeded(seed: int, window: int, ordered: bool = True):
    """Two batches of seeded records over three chromosomes (no records
    without SEQ holding an I op) and loci on the first two: random, at the
    window's edges and middle around I and D ops, just outside, repeated,
    unsorted."""
    batches = [_without_seqless_insertions(selfcheck.alignment_records(
        2000, seed=seed + k, width=20_000, n_refs=3, ordered=ordered)) for k in range(2)]
    chrs, pos = selfcheck.indel_loci(batches[0], 600, seed=seed, n_refs=2, window=window,
                                     duplicates=40)
    return batches, chrs, pos


def _total(indels: list[dict]) -> int:
    return sum(sum(d.values()) for d in indels)


@pytest.mark.parametrize("npp", [False, True], ids=["proper pairs", "not properly paired"])
@pytest.mark.parametrize("min_mapq", [0, 1, 20])
@pytest.mark.parametrize("window", [0, 1, 3])
def test_indel_pileup_matches_the_jax_package_on_seeded_batches(monkeypatch, window, min_mapq,
                                                                 npp):
    batches, chrs, pos = _seeded(100 + 10 * window + min_mapq, window, ordered=not npp)
    _readers(monkeypatch, batches)
    kw = dict(window=window, min_mapq=min_mapq, include_not_properly_paired=npp)
    want = jax_pileup.indel_pileup_at_positions("", chrs, pos, **kw)
    got = port_pileup.indel_pileup_at_positions("", chrs, pos, **kw)
    assert got == want
    assert _total(want) > 50
    keys = {k[:1] for d in want for k in d}
    assert keys == {b"+", b"-"}


SWEEPS = {  # (window, pileup_at_positions' arguments)
    "VcfMerge's": (1, dict(min_mapq=20, min_baseq=0)),
    "long reads": (1, dict(min_mapq=20, min_baseq=0, include_not_properly_paired=True)),
    "window 0, mapq0 counters": (0, dict(min_mapq=1, min_baseq=13, track_mapq0=True)),
    "window 3, min_mapq 0": (3, dict(min_mapq=0, min_baseq=20, track_mapq0=True,
                                     include_not_properly_paired=True)),
}


@pytest.mark.parametrize("name", list(SWEEPS))
def test_one_sweep_equals_the_jax_packages_two(monkeypatch, name):
    """``pileup_at_positions(..., indel_window=w)``: the base and deletion
    counts (and MAPQ-0 counters) of the JAX package's ``pileup_at_positions``
    and the dicts of its ``indel_pileup_at_positions``, from one sweep; the
    records only the widened span keeps count as no read over a locus."""
    window, kw = SWEEPS[name]
    batches, chrs, pos = _seeded(200 + window, window)
    _readers(monkeypatch, batches)
    want = jax_pileup.pileup_at_positions("", chrs, pos, **kw)
    want_indels = jax_pileup.indel_pileup_at_positions(
        "", chrs, pos, window=window, min_mapq=kw["min_mapq"],
        include_not_properly_paired=kw.get("include_not_properly_paired", False))
    got = port_pileup.pileup_at_positions("", chrs, pos, indel_window=window, **kw)
    for field in ("counts", "dels", "mapped", "mapq0"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), field)
    assert got.indels == want_indels and _total(want_indels) > 50
    assert want.counts.sum() > 100 and want.dels.sum() > 0


def _record(pos: int, ops: list[tuple[str, int]], seq: bytes, flag: int = 0x3,
            mapq: int = 60, ref_id: int = 0) -> dict:
    return dict(pos=pos, cigar=[(n << 4) | CODES[o] for o, n in ops],
                seq=[NIBBLE[b] for b in seq], flag=flag, mapq=mapq, ref_id=ref_id)


def _columns(records: list[dict]) -> dict:
    l_seq = np.array([len(r["seq"]) for r in records], np.int32)
    n_cigar = np.array([len(r["cigar"]) for r in records], np.int32)
    return dict(ref_id=np.array([r["ref_id"] for r in records], np.int32),
                pos=np.array([r["pos"] for r in records], np.int32),
                flag=np.array([r["flag"] for r in records], np.uint16),
                mapq=np.array([r["mapq"] for r in records], np.uint8), l_seq=l_seq,
                n_cigar=n_cigar,
                cigar=np.array([w for r in records for w in r["cigar"]], np.uint32),
                cigar_off=np.concatenate(([0], np.cumsum(n_cigar))).astype(np.int64),
                seq=np.array([b for r in records for b in r["seq"]], np.uint8),
                qual=np.full(int(l_seq.sum()), 30, np.uint8),
                seq_off=np.concatenate(([0], np.cumsum(l_seq))).astype(np.int64))


# 0-based pos 99 (1-based 100): an insertion before the first aligned base
# (g = 100), M over 100-104, a deletion of 2 at 105 (g = 105), M over
# 107-109, an insertion after the last aligned base (g = 110), a clip
EDGES = _record(99, [("S", 1), ("I", 2), ("M", 5), ("D", 2), ("M", 3), ("I", 3), ("S", 1)],
                b"GCAACGTAGGTTTAA")


@pytest.mark.parametrize("window", [0, 1, 3])
def test_indels_at_a_records_first_and_last_base(monkeypatch, window):
    """An insertion before the first aligned base and one past the last, a
    deletion between: each counted at the loci within the window of its
    ``g``, at the window's edges and not one past them, twice at a repeated
    locus; a second chromosome's locus at the same position counts nothing
    (the records are on chr1), a record on chr3 (no loci) nothing."""
    other = dict(EDGES, ref_id=2)
    cols = _columns([EDGES, other])
    g = {"+CA": 100, "-2": 105, "+TTA": 110}
    loci = sorted({p + d for p in g.values() for d in (-window - 1, -window, 0, window,
                                                        window + 1)})
    pos = np.array(loci + [105, 105])
    chrs = np.array([1] * len(loci) + [1, 2])
    _readers(monkeypatch, [cols])
    want = jax_pileup.indel_pileup_at_positions("", chrs, pos, window=window)
    got = port_pileup.indel_pileup_at_positions("", chrs, pos, window=window)
    assert got == want
    for locus, c, d in zip(pos, chrs, got):
        expected = {k.encode(): 1 for k, at in g.items() if abs(at - locus) <= window and c == 1}
        assert d == expected, (locus, c)


@pytest.mark.parametrize("where", ["before another record", "last in its batch"])
def test_an_insertion_past_its_records_seq_counts_nowhere(monkeypatch, where):
    """F11: a record with an I op and ``l_seq`` 0. The JAX package slices
    the batch's bases at its ``seq_off`` plus the op's query offset: it keys
    the insertion with the next record's bases, or with a shorter slice (or
    none) for the batch's last record. The port reads no other record's
    bytes: the insertion counts nowhere. The record's D op needs no bases
    and counts on both."""
    no_seq = _record(99, [("M", 3), ("I", 2), ("M", 3), ("D", 1), ("M", 2)], b"")
    other = _record(1999, [("M", 6)], b"GTACGT")
    records = [no_seq, other] if where == "before another record" else [other, no_seq]
    cols = _columns(records)
    chrs, pos = np.ones(2, np.int64), np.array([103, 106])
    monkeypatch.setattr(jax_pileup, "BamReader",
                        lambda *a, **k: _Reader([_batch(JaxBatch, cols)]))
    jx = jax_pileup.indel_pileup_at_positions("", chrs, pos)
    _readers(monkeypatch, [cols])
    got = port_pileup.indel_pileup_at_positions("", chrs, pos)
    if where == "before another record":
        assert jx[0] == {b"+CG": 1}   # the next record's bases at the op's query offset
    else:
        assert jx[0] == {b"+": 1}     # past the batch's end: an empty slice
    assert got[0] == {}
    assert jx[1] == got[1] == {b"-1": 1}


def test_a_record_without_a_reference_counts_nowhere(monkeypatch):
    """A record whose ``ref_id`` is -1 but whose flags pass the filter: the
    port gives it no key and counts nothing; the JAX package reads its
    chromosome as the last reference's (``ref_num[-1]``) and counts it
    there."""
    lost = _record(99, [("M", 3), ("D", 2), ("M", 3)], b"ACGTAC", ref_id=-1)
    cols = _columns([lost])
    chrs, pos = np.array([3]), np.array([103])
    _readers(monkeypatch, [cols])
    assert jax_pileup.indel_pileup_at_positions("", chrs, pos) == [{b"-2": 1}]
    assert port_pileup.indel_pileup_at_positions("", chrs, pos) == [{}]


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    """A synthetic BAM with germline SNVs and indels on two chromosomes and
    a third without loci, and its loci: each site's VCF position and the
    base after it, unsorted, some repeated."""
    d = tmp_path_factory.mktemp("indels")
    lengths = {"chr1": 700_000, "chr2": 500_000, "chr3": 200_000}
    genome = synth.synth_genome(d / "g.fa", lengths, seed=91)
    roi = synth.synth_roi(d / "roi.bed", genome, 150, seed=92)
    trio = synth.trio_variants(genome, roi, 600, seed=93, indel_share=0.3)
    synth.synth_bam(d / "x.bam", genome, 12_000, seed=94, roi=roi, snps=trio.snps(0),
                    indels=trio.indels(0))
    keep = trio.chrom < 2
    rng = np.random.default_rng(95)
    chrs = np.concatenate([trio.chrom[keep] + 1] * 2)
    pos = np.concatenate([trio.pos[keep] + 1, trio.pos[keep] + 2])
    again = rng.integers(0, len(pos), size=40)
    order = rng.permutation(len(pos) + 40)
    return (d / "x.bam", np.concatenate([chrs, chrs[again]])[order],
            np.concatenate([pos, pos[again]])[order])


@pytest.mark.parametrize("npp", [False, True], ids=["proper pairs", "not properly paired"])
@pytest.mark.parametrize("min_mapq", [0, 1, 20])
@pytest.mark.parametrize("window", [0, 1, 3])
def test_indel_pileup_matches_the_jax_package_on_a_synthetic_bam(bam, window, min_mapq, npp):
    """The whole file, both packages' readers: the same dicts from the
    indels alone and from the sweep with the base counts."""
    path, chrs, pos = bam
    kw = dict(min_mapq=min_mapq, include_not_properly_paired=npp)
    want = jax_pileup.indel_pileup_at_positions(str(path), chrs, pos, window=window, **kw)
    assert port_pileup.indel_pileup_at_positions(str(path), chrs, pos, window=window,
                                                 **kw) == want
    both = port_pileup.pileup_at_positions(str(path), chrs, pos, indel_window=window,
                                           min_baseq=0, **kw)
    assert both.indels == want and _total(want) > 500
    np.testing.assert_array_equal(
        both.counts, jax_pileup.pileup_at_positions(str(path), chrs, pos, **kw).counts)


def test_each_batch_launches_the_indel_form_once_and_the_indels_alone_no_b1(bam, monkeypatch):
    """The indel pileup alone never reaches B1's record form; the sweep with
    both calls each once a batch that holds a record reaching a locus, the
    indel form only where those records hold an I or D op, with a capacity
    of their I and D ops times the loci's densest window."""
    from ngsbits_tpu_torch.io import bam as port_bam
    path, chrs, pos = bam
    b1, indel = [], []
    real_b1, real_indel = dr.pileup_add_records_into, dr.pileup_indels_into
    monkeypatch.setattr(dr, "pileup_add_records_into",
                        lambda rec, *a: b1.append(rec.pos.shape[0]) or real_b1(rec, *a))
    monkeypatch.setattr(dr, "pileup_indels_into",
                        lambda rec, loci, table, mq, w, out, **kw: indel.append(out.shape[0])
                        or real_indel(rec, loci, table, mq, w, out, **kw))
    port_pileup.indel_pileup_at_positions(str(path), chrs, pos)
    assert b1 == [] and len(indel) >= 1
    b1.clear()
    indel.clear()
    reader = port_bam.BamReader(str(path), batch_records=1000)
    port_pileup.pileup_at_positions(str(path), chrs, pos, reader=reader, indel_window=1)
    reader.close()
    assert len(b1) >= 20 and 10 <= len(indel) <= len(b1)
    eng = dr.DevicePileup(chrs, pos, np.array([1, 2, 3]), device="cpu", indel_window=1)
    assert all((n - 1) % (4 * eng.indel_depth) == 0 for n in indel)


def test_the_capacity_is_the_densest_window_times_the_ops():
    """``indel_depth``: the most loci, duplicates included, in any 2w + 1
    positions of one chromosome; loci of two chromosomes never share a
    window."""
    chrs = np.array([1, 1, 1, 1, 1, 2, 2, 2])
    pos = np.array([12, 10, 11, 12, 20, 13, 13, 9])
    for window, depth in ((0, 2), (1, 4), (3, 4), (5, 5)):
        eng = dr.DevicePileup(chrs, pos, np.array([1, 2]), device="cpu", indel_window=window,
                              count_bases=False)
        assert eng.indel_depth == depth, window
    assert dr.count_indel_ops(np.array([(3 << 4) | 1, (5 << 4) | 2, (9 << 4) | 0, 2],
                                       np.uint32)) == 3


def _batch_on_cpu(seed: int = 7):
    cols = selfcheck.alignment_records(1500, seed=seed, width=10_000, n_refs=2)
    chrs, pos = selfcheck.indel_loci(cols, 200, seed=seed, n_refs=2, window=1, duplicates=20)
    eng = dr.DevicePileup(chrs, pos, np.array([1, 2]), device="cpu", indel_window=1,
                          count_bases=False)
    rec = dr.upload_records(cols["pos"], selfcheck.pileup_keys(cols, True), cols["cigar_off"],
                            cols["cigar"], cols["seq_off"], cols["qual"], seq=cols["seq"],
                            mapq=cols["mapq"], device="cpu")
    return rec, eng


def test_the_wrapper_raises_past_its_capacity_and_counts_no_launch_on_the_cpu():
    """A capacity below the hits raises on the CPU as on the card (past it
    the kernel only counts); at the reckoned capacity the hits are the plain
    version's, written after their count; the CPU route counts no launch."""
    rec, eng = _batch_on_cpu()
    hits = dr.pileup_indels_plain(rec, eng.loci, eng.table, 1, 1)
    assert hits.shape[0] > 50
    before = dr.pileup_indels_into.launches
    with pytest.raises(RuntimeError, match="capacity"):
        dr.pileup_indels_into(rec, eng.loci, eng.table, 1, 1,
                              dr.indel_out(hits.shape[0] - 1, torch.device("cpu")))
    capacity = dr.count_indel_ops(rec.cigar.numpy().view(np.uint32)) * eng.indel_depth
    out = dr.indel_out(capacity, torch.device("cpu"))
    got = dr.pileup_indels_into(rec, eng.loci, eng.table, 1, 1, out)
    assert torch.equal(got, hits) and int(out[0]) == hits.shape[0]
    assert torch.equal(out[1:1 + 4 * hits.shape[0]].view(-1, 4), hits)
    assert dr.pileup_indels_into.launches == before
    case = selfcheck.pileup_indels_case(rec, eng.loci, eng.table, 1, 1, capacity)
    case.kernel()
    case.plain()
    assert selfcheck.max_abs_err(case) == 0 and case.bytes > 16 * rec.pos.shape[0]


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    rec, eng = _batch_on_cpu(8)
    out = dr.indel_out(100, torch.device("cpu"))
    with pytest.raises(TypeError):
        dr.pileup_indels_into(rec._replace(mapq=rec.mapq.to(torch.int32)), eng.loci, eng.table,
                              1, 1, out)
    with pytest.raises(TypeError):
        dr.pileup_indels_into(rec, eng.loci, eng.table, 1, 1, out.to(torch.int32))
    with pytest.raises(ValueError, match="out"):
        dr.pileup_indels_into(rec, eng.loci, eng.table, 1, 1, out[:3])
    with pytest.raises(ValueError, match="window"):
        dr.pileup_indels_into(rec, eng.loci, eng.table, 1, -1, out)
    with pytest.raises(ValueError, match="SEQ offsets"):
        dr.pileup_indels_into(rec._replace(qual_off=None), eng.loci, eng.table, 1, 1, out)
    with pytest.raises(ValueError, match="device type"):
        meta = {k: getattr(rec, k).to("meta") for k in rec._fields}
        dr.pileup_indels_into(rec._replace(**meta), eng.loci.to("meta"), eng.table.to("meta"),
                              1, 1, out.to("meta"))
    with pytest.raises(ValueError, match="fragments"):
        port_pileup.pileup_at_positions("", np.ones(1), np.ones(1), count_fragments=True,
                                        indel_window=1)
    with pytest.raises(ValueError, match="indel window"):
        dr.DevicePileup(np.ones(1), np.ones(1), np.array([1]), device="cpu", count_bases=False)


# ------------------------------------------------- the sweep's deferred keys

def _batches_over(starts: list[int], seed: int) -> list[dict]:
    """Sorted batches of seeded records on chr1 and chr2, batch k over
    ``[starts[k], starts[k] + 20,000)`` (no records without SEQ holding an
    I op)."""
    return [_without_seqless_insertions(selfcheck.alignment_records(
        1500, seed=seed + k, start=s, width=20_000, n_refs=2)) for k, s in enumerate(starts)]


def _loci_near(batches: list[dict], which: list[int], seed: int, window: int = 1):
    chrs, pos = zip(*(selfcheck.indel_loci(batches[k], 200, seed=seed + k, n_refs=2,
                                           window=window, duplicates=10) for k in which))
    return np.concatenate(chrs), np.concatenate(pos)


LAYOUTS = {  # batches whose records reach loci, of three
    "the last batch alone": [2],
    "every batch": [0, 1, 2],
    "none reached in the middle": [0, 2],
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_deferred_keys_match_the_jax_package(monkeypatch, layout):
    """Three batches over disjoint ranges, loci near the ops of some: the
    last launch's hits are keyed at the sweep's end, a batch that reaches
    no locus launches nothing and keeps the one before it pending; the
    dicts equal the JAX package's, from one launch a batch with loci."""
    batches = _batches_over([0, 100_000, 200_000], seed=300)
    chrs, pos = _loci_near(batches, LAYOUTS[layout], seed=310)
    _readers(monkeypatch, batches)
    launched = []
    real = dr.pileup_indels_into
    monkeypatch.setattr(dr, "pileup_indels_into",
                        lambda rec, *a, **kw: launched.append(rec.pos.shape[0])
                        or real(rec, *a, **kw))
    want = jax_pileup.indel_pileup_at_positions("", chrs, pos, window=1)
    got = port_pileup.indel_pileup_at_positions("", chrs, pos, window=1)
    assert got == want and _total(want) > 50
    assert len(launched) == len(LAYOUTS[layout])


def test_the_sweep_keys_a_batch_after_the_next_launch(monkeypatch):
    """On the CPU route as on the card: a launch's hits are asked for only
    once the next batch has been launched, or after the last launch, each
    launch's once."""
    batches = _batches_over([0, 100_000, 200_000, 300_000], seed=320)
    chrs, pos = _loci_near(batches, [0, 1, 3], seed=330)
    _readers(monkeypatch, batches)
    events = []
    add, hits = dr.DevicePileup.add, dr.IndelHits.hits

    def spy_add(self, *a, **kw):
        got = add(self, *a, **kw)
        if got is not None:
            events.append(("launch", got))
        return got

    def spy_hits(self):
        events.append(("hits", self))
        return hits(self)

    monkeypatch.setattr(dr.DevicePileup, "add", spy_add)
    monkeypatch.setattr(dr.IndelHits, "hits", spy_hits)
    port_pileup.indel_pileup_at_positions("", chrs, pos, window=1)
    launches = [h for kind, h in events if kind == "launch"]
    assert len(launches) == 3
    assert [kind for kind, _ in events] == ["launch", "launch", "hits", "launch", "hits", "hits"]
    assert [h for kind, h in events if kind == "hits"] == launches


def test_an_over_capacity_batch_mid_sweep_raises_and_keys_no_later_batch(monkeypatch):
    """The second of three batches is given too small a capacity (one I or
    D op): the sweep raises on the CPU route once it asks for that batch's
    hits, after launching the third, whose hits are never keyed; the first
    batch's were."""
    batches = _batches_over([0, 100_000, 200_000], seed=340)
    chrs, pos = _loci_near(batches, [0, 1, 2], seed=350)
    _readers(monkeypatch, batches)
    ops, keyed = [], []
    real_ops, real_key = port_pileup.count_indel_ops, port_pileup._count_indels

    def count_ops(cigar):
        ops.append(real_ops(cigar))
        return 1 if len(ops) == 2 else ops[-1]

    monkeypatch.setattr(port_pileup, "count_indel_ops", count_ops)
    monkeypatch.setattr(port_pileup, "_count_indels", lambda batch, hits, *a:
                        keyed.append(len(hits)) or real_key(batch, hits, *a))
    with pytest.raises(RuntimeError, match="capacity"):
        port_pileup.indel_pileup_at_positions("", chrs, pos, window=1)
    assert len(ops) == 3 and min(ops) > 1
    assert len(keyed) == 1 and keyed[0] > 0


@pytest.mark.parametrize("hits", [False, True], ids=["no hits", "hits"])
def test_a_batch_with_indel_ops_and_zero_capacity(hits):
    """A capacity of 0 on a batch that holds I and D ops: its hits are none
    where no op lies near a locus, and raise where some do (on the CPU
    route as on the card; waited for or not)."""
    rec, eng = _batch_on_cpu(9)
    assert dr.count_indel_ops(rec.cigar.numpy().view(np.uint32)) > 100
    loci, table = eng.loci, eng.table
    if not hits:  # every locus far past the records
        loci = loci + 1_000_000
    want = dr.pileup_indels_plain(rec, loci, table, 1, 1).shape[0]
    assert (want > 0) == hits
    pending = dr.pileup_indels_into(rec, loci, table, 1, 1, dr.indel_out(0, torch.device("cpu")),
                                    wait=False)
    if hits:
        with pytest.raises(RuntimeError, match="capacity of 0"):
            pending.hits()
    else:
        assert pending.hits().shape == (0, 4)


def _loci_with_far(cols: dict, seed: int, window: int):
    """``indel_loci`` on chr1 and chr2, 300 more on each past the records'
    reach and 100 on chr3 past it too."""
    chrs, pos = selfcheck.indel_loci(cols, 300, seed=seed, n_refs=2, window=window,
                                     duplicates=20)
    far = int(cols["pos"].max()) + 5_000 + np.arange(300) * 7
    return (np.concatenate([chrs, np.ones(300, np.int64), np.full(300, 2), np.full(100, 3)]),
            np.concatenate([pos, far, far, far[:100]]))


@pytest.mark.parametrize("ordered", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("window", [0, 1, 3])
def test_the_reached_loci_range_gives_the_hits_of_every_locus(window, ordered):
    """``DevicePileup.reaching``'s range of the loci a batch can reach (each
    record's span widened by the window): the hits at that range, of the
    plain version and of the wrapper on the CPU route, equal those at every
    locus, for the whole batch and for the records the sweep sends up; the
    range leaves out the loci past the records."""
    cols = selfcheck.alignment_records(3000, seed=360 + window, width=20_000, n_refs=3,
                                       ordered=ordered)
    chrs, pos = _loci_with_far(cols, 370 + window, window)
    eng = dr.DevicePileup(chrs, pos, np.array([1, 2, 3]), device="cpu", indel_window=window,
                          count_bases=False)
    keys = selfcheck.pileup_keys(cols, True)
    reach, (lo, hi) = eng.reaching(cols["pos"], selfcheck.record_ends(cols), keys)
    assert lo < hi and hi - lo <= eng.n - 400 and reach.any() and not reach.all()
    sent = _subset(cols, reach)
    for batch, k in ((cols, keys), (sent, keys[reach])):
        rec = dr.upload_records(batch["pos"], k, batch["cigar_off"], batch["cigar"],
                                batch["seq_off"], batch["qual"], seq=batch["seq"],
                                mapq=batch["mapq"], device="cpu")
        full = dr.pileup_indels_plain(rec, eng.loci, eng.table, 1, window)
        cut = dr.pileup_indels_plain(rec, eng.loci, eng.table, 1, window, (lo, hi))
        capacity = dr.count_indel_ops(batch["cigar"]) * eng.indel_depth
        got = dr.pileup_indels_into(rec, eng.loci, eng.table, 1, window,
                                    dr.indel_out(capacity, torch.device("cpu")),
                                    loci_range=(lo, hi))
        assert full.shape[0] > 50
        assert torch.equal(cut, full) and torch.equal(got, full)


@pytest.mark.parametrize("label", sorted(selfcheck.INDEL_EDGES))
def test_indel_edges_at_their_reached_range_equal_every_locus(label):
    """Each of ``selfcheck.INDEL_EDGES`` on the CPU route at the range its
    pre-filter finds, against the plain version at every locus; one case
    reaches more loci than the kernel stages in shared memory, one has a
    chromosome with loci whose reached range is empty."""
    rec, eng, mq, window, capacity, (lo, hi) = selfcheck.indel_edge_inputs(
        label, torch.device("cpu"))
    case = selfcheck.pileup_indels_case(rec, eng.loci, eng.table, mq, window, capacity, (lo, hi))
    case.kernel()
    case.plain()
    assert selfcheck.max_abs_err(case) == 0 and case.outputs()[0][0].shape[0] > 50
    table = eng.table.numpy()
    if "global memory" in label:
        assert hi - lo > dr.INDEL_STAGED_LOCI
    else:
        assert hi - lo <= dr.INDEL_STAGED_LOCI
    if "empty" in label:  # chromosome 2 has loci, none of them in the range
        assert table[0, 1] < table[1, 1] and (table[1, 1] <= lo or table[0, 1] >= hi)


@pytest.mark.parametrize("length", [2**27, 2**28 - 1])
def test_a_deletion_of_2_27_bases_or_more_is_keyed_by_its_length(monkeypatch, length):
    """A D op whose CIGAR word is 2^31 or more (a length of 2^27 or more):
    the word goes up as int32 and comes back as its unsigned value, keyed
    ``-LEN`` as the JAX package keys it; an insertion after it counts at
    its own g."""
    rec = _record(99, [("M", 10), ("D", length), ("M", 10), ("I", 2), ("M", 5)],
                  b"ACGTACGTACGTACGTACGTGGACGTA")
    cols = _columns([rec])
    assert cols["cigar"][1] >= 2**31
    g_ins = 100 + 10 + length + 10
    chrs, pos = np.ones(3, np.int64), np.array([110, 111, g_ins])
    _readers(monkeypatch, [cols])
    want = jax_pileup.indel_pileup_at_positions("", chrs, pos, window=1)
    got = port_pileup.indel_pileup_at_positions("", chrs, pos, window=1)
    key = b"-%d" % length
    assert got == want == [{key: 1}, {key: 1}, {b"+GG": 1}]


def test_the_wrapper_refuses_a_loci_range_outside_the_loci():
    rec, eng = _batch_on_cpu(10)
    out = dr.indel_out(100, torch.device("cpu"))
    for bad in ((-1, 5), (5, 4), (0, eng.n + 1)):
        with pytest.raises(ValueError, match="loci range"):
            dr.pileup_indels_into(rec, eng.loci, eng.table, 1, 1, out, loci_range=bad)
