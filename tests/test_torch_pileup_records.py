"""B1's record form on the CPU: ``pileup_add_records_plain`` (through
``DevicePileup`` and ``qc/pileup.py::pileup_at_positions``) against the JAX
package's ``ngsbits_tpu/qc/pileup.py::pileup_at_positions`` (its host route,
as the JAX tests run it) on the same seeded batches
(``selfcheck.alignment_records`` with bases and MAPQ, built as both
packages' ``BamBatch`` and handed to both as a reader) and on synthetic BAMs
(``utils/synth.py``): every CIGAR op, loci at op edges, duplicate and
unsorted loci, several chromosomes and one without loci, ``min_mapq``
0/1/20, ``min_baseq`` 0/13/20, ``include_not_properly_paired``,
``track_mapq0``, the fragment route. Records with M ops but no SEQ
(ROADMAP F9) are handed to the JAX package with ``N`` bases of their query
length, so both count nothing there; ``test_a_record_without_seq_...`` shows
what the JAX package does without that. Also one launch a batch, the sweep
through a prefetch thread, and the wrapper's checks. Integer outputs: exact
equality."""

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
FIELDS = ("counts", "dels", "mapped", "mapq0")


@pytest.fixture(autouse=True)
def _cpu_route(monkeypatch):
    monkeypatch.setenv("NGSBITS_TORCH_DEVICE", "cpu")


def _query_lengths(cols: dict) -> np.ndarray:
    n = len(cols["pos"])
    op, length = cols["cigar"] & 0xF, (cols["cigar"] >> 4).astype(np.int64)
    rec_of = np.repeat(np.arange(n), np.diff(cols["cigar_off"]))
    return np.bincount(rec_of, weights=length * np.isin(op, [0, 1, 4, 7, 8]),
                       minlength=n).astype(np.int64)


def _with_n(cols: dict) -> dict:
    """The batch with each record that has no SEQ given ``N`` bases (and
    0xFF qualities) of its query length: what the JAX package must be
    handed to read no other record's bytes (ROADMAP F9)."""
    l_seq = np.where(cols["l_seq"] == 0, _query_lengths(cols), cols["l_seq"]).astype(np.int32)
    so = cols["seq_off"]

    def fill(column, value):
        parts = [column[a:b] if ls else np.full(m, value, np.uint8)
                 for a, b, ls, m in zip(so[:-1], so[1:], cols["l_seq"], l_seq)]
        return np.concatenate(parts + [np.zeros(0, np.uint8)])

    return dict(cols, l_seq=l_seq, seq=fill(cols["seq"], 15), qual=fill(cols["qual"], 0xFF),
                seq_off=np.concatenate(([0], np.cumsum(l_seq))).astype(np.int64))


def _batch(cls, cols: dict):
    """A ``BamBatch`` of either package from ``alignment_records``'
    columns; neighbouring records share a name (pairs, for the fragment
    route)."""
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
    """Batches handed to ``pileup_at_positions`` as its reader."""

    def __init__(self, batches):
        self.batches = batches
        self.ref_names = REFS

    def __iter__(self):
        return iter(self.batches)


def _both(batches: list[dict], chrs, pos, **kw):
    """(the JAX package's result on the batches with N bases where there is
    no SEQ, the port's on the batches as they are)."""
    want = jax_pileup.pileup_at_positions(
        "", chrs, pos, reader=_Reader([_batch(JaxBatch, _with_n(c)) for c in batches]), **kw)
    got = port_pileup.pileup_at_positions(
        "", chrs, pos, reader=_Reader([_batch(PortBatch, c) for c in batches]), **kw)
    return want, got


def _assert_equal(got, want):
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), field)


def _seeded(seed: int, n: int = 2000, ordered: bool = True):
    """Two batches of seeded records over three chromosomes and their loci
    on the first two: random, at the first and last base of ops, repeated,
    unsorted."""
    batches = [selfcheck.alignment_records(n, seed=seed + k, width=20_000, n_refs=3,
                                           ordered=ordered) for k in range(2)]
    chrs, pos = selfcheck.pileup_loci(batches[0], 400, seed=seed, n_refs=2, edges=300,
                                      duplicates=40)
    return batches, chrs, pos


PARAMS = {
    "contamination": dict(min_mapq=1, min_baseq=13),
    "mapq0 min_mapq 0": dict(min_mapq=0, include_not_properly_paired=True, track_mapq0=True),
    "min_mapq 20 min_baseq 20": dict(min_mapq=20, min_baseq=20, track_mapq0=True),
    "min_baseq 0": dict(min_mapq=1, min_baseq=0, include_not_properly_paired=True),
    "min_mapq 0 min_baseq 13": dict(min_mapq=0, min_baseq=13),
    "not properly paired, mapq0": dict(min_mapq=1, min_baseq=20,
                                       include_not_properly_paired=True, track_mapq0=True),
    "fragments": dict(min_mapq=1, min_baseq=13, count_fragments=True,
                      include_not_properly_paired=True),
    "fragments, mapq0": dict(min_mapq=0, count_fragments=True, track_mapq0=True),
}


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("name", list(PARAMS))
def test_pileup_matches_the_jax_package_on_seeded_batches(name, seed):
    batches, chrs, pos = _seeded(10 * seed, ordered=seed == 1)
    want, got = _both(batches, chrs, pos, **PARAMS[name])
    _assert_equal(got, want)
    assert want.counts.sum() > 50
    if PARAMS[name].get("track_mapq0"):
        assert want.mapq0.sum() > 0
    if not PARAMS[name].get("count_fragments"):
        assert want.dels.sum() > 0


def _record(pos: int, ops: list[tuple[str, int]], seq: bytes, flag: int = 0x3,
            mapq: int = 60, qual: int = 30, ref_id: int = 0) -> dict:
    codes = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6, "=": 7, "X": 8}
    base = {ord("A"): 1, ord("C"): 2, ord("G"): 4, ord("T"): 8, ord("N"): 15}
    return dict(pos=pos, cigar=[(n << 4) | codes[o] for o, n in ops],
                seq=[base[b] for b in seq], flag=flag, mapq=mapq, qual=qual, ref_id=ref_id)


def _columns(records: list[dict]) -> dict:
    l_seq = np.array([len(r["seq"]) for r in records], np.int32)
    n_cigar = np.array([len(r["cigar"]) for r in records], np.int32)
    seq = np.array([b for r in records for b in r["seq"]], np.uint8)
    return dict(ref_id=np.array([r["ref_id"] for r in records], np.int32),
                pos=np.array([r["pos"] for r in records], np.int32),
                flag=np.array([r["flag"] for r in records], np.uint16),
                mapq=np.array([r["mapq"] for r in records], np.uint8), l_seq=l_seq,
                n_cigar=n_cigar,
                cigar=np.array([w for r in records for w in r["cigar"]], np.uint32),
                cigar_off=np.concatenate(([0], np.cumsum(n_cigar))).astype(np.int64),
                seq=seq, qual=np.array([r["qual"] for r in records for _ in r["seq"]], np.uint8),
                seq_off=np.concatenate(([0], np.cumsum(l_seq))).astype(np.int64))


# 0-based pos 99, 1-based: a clip of 2 bases, M over 100-102 (ACG), I, D over
# 103-104, N over 105-107, = over 108-109 (TA), X at 110 (C), a clip, H
EDGES = _record(99, [("S", 2), ("M", 3), ("I", 2), ("D", 2), ("N", 3), ("=", 2), ("X", 1),
                     ("S", 1), ("H", 4)], b"GGACGTTTACT")


@pytest.mark.parametrize("min_baseq", [0, 13, 20])
def test_every_cigar_op_at_its_first_and_last_base(min_baseq):
    """Loci at the first and last base of each op, one before and one past
    the record, and a repeated locus: bases from M, = and X, deletions from
    D, nothing from N, I, S or H; the quality of one record below 20."""
    low = dict(EDGES, qual=15)
    cols = _columns([EDGES, low, dict(EDGES, mapq=0)])
    pos = np.array([99, 100, 102, 103, 104, 105, 107, 108, 109, 110, 111, 100, 108])
    chrs = np.ones(len(pos), np.int64)
    want, got = _both([cols], chrs, pos, min_mapq=1, min_baseq=min_baseq, track_mapq0=True)
    _assert_equal(got, want)
    counted = 2 if min_baseq <= 15 else 1
    # A at 100 (twice: a repeated locus), C at 102, T at 108 and 109, C at 110
    np.testing.assert_array_equal(got.counts.sum(axis=1),
                                  [0, counted, counted, 0, 0, 0, 0, counted, counted, counted,
                                   0, counted, counted])
    np.testing.assert_array_equal(got.dels, [0, 0, 0, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(got.mapped, [0, 3, 3, 3, 3, 3, 3, 3, 3, 3, 0, 3, 3])
    np.testing.assert_array_equal(got.mapq0, [0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1])


@pytest.mark.parametrize("where", ["before another record", "last in its batch"])
def test_a_record_without_seq_reads_no_other_records_bytes(where):
    """F9: a record with M ops and ``l_seq`` 0. The JAX package indexes the
    batch's bases at its ``seq_off`` plus the query offset: it counts the
    next record's base at the locus, or raises IndexError for the batch's
    last record. The port has no base there and counts nothing."""
    no_seq = _record(99, [("M", 5)], b"")
    other = _record(1999, [("M", 5)], b"GGGGG")
    records = [no_seq, other] if where == "before another record" else [other, no_seq]
    cols = _columns(records)
    chrs, pos = np.ones(1, np.int64), np.array([102])
    reader = _Reader([_batch(JaxBatch, cols)])
    if where == "last in its batch":
        with pytest.raises(IndexError):
            jax_pileup.pileup_at_positions("", chrs, pos, reader=reader)
    else:
        jx = jax_pileup.pileup_at_positions("", chrs, pos, reader=reader)
        assert jx.counts[0].tolist() == [0, 0, 1, 0]   # the next record's G
    got = port_pileup.pileup_at_positions("", chrs, pos, reader=_Reader([_batch(PortBatch, cols)]))
    assert got.counts.sum() == 0 and got.dels.sum() == 0
    frag = port_pileup.pileup_at_positions("", chrs, pos, count_fragments=True,
                                           reader=_Reader([_batch(PortBatch, cols)]))
    assert frag.counts.sum() == 0
    # handed N bases of its query length, the JAX package counts nothing either
    want, got = _both([cols], chrs, pos)
    _assert_equal(got, want)
    assert want.counts.sum() == 0


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    """A synthetic BAM on two chromosomes with SNPs, and its loci: the
    bundled SNVs of both, some repeated."""
    d = tmp_path_factory.mktemp("pileup")
    lengths = {"chr1": 1_000_000, "chr2": 600_000, "chr3": 200_000}
    chrom, pos, ref, alt, _ = synth.known_snvs(lengths)
    genome = synth.synth_genome(d / "g.fa", lengths, seed=5, set_bases=[
        (name, pos[chrom == k], ref[chrom == k]) for k, name in enumerate(lengths)])
    roi = synth.synth_roi(d / "roi.bed", genome, 120, seed=6, anchors=(chrom, pos - 1))
    synth.synth_bam(d / "x.bam", genome, 6000, seed=7, roi=roi, snps=(chrom, pos - 1, alt))
    nums = np.array([1, 2, 3], dtype=np.int64)[chrom]
    keep = chrom < 2   # no loci on chr3
    rng = np.random.default_rng(8)
    again = rng.integers(0, int(keep.sum()), size=50)
    chrs = np.concatenate([nums[keep], nums[keep][again]])
    loci = np.concatenate([pos[keep], pos[keep][again]])
    return d / "x.bam", chrs, loci


@pytest.mark.parametrize("name", ["contamination", "mapq0 min_mapq 0", "min_mapq 20 min_baseq 20",
                                  "fragments"])
def test_pileup_matches_the_jax_package_on_a_synthetic_bam(bam, name, monkeypatch):
    """Batches of 1,000 records (the port's reader), the whole file (the
    JAX package's): the same counts."""
    from ngsbits_tpu_torch.io import bam as port_bam
    path, chrs, loci = bam
    kw = PARAMS[name]
    want = jax_pileup.pileup_at_positions(str(path), chrs, loci, **kw)
    reader = port_bam.BamReader(str(path), batch_records=1000)
    got = port_pileup.pileup_at_positions(str(path), chrs, loci, reader=reader, **kw)
    reader.close()
    _assert_equal(got, want)
    assert want.counts.sum() > 1000


def test_one_launch_a_batch_and_no_bincount(bam, monkeypatch):
    """The sweep hands each batch that holds a kept record reaching a locus
    to the engine once (one ``pileup_add_records_into`` a batch) with just
    those records (the host's pre-filter), through a prefetch thread, and
    never reaches B1's index form."""
    from ngsbits_tpu_torch.io import bam as port_bam
    path, chrs, loci = bam
    calls, threads = [], []
    real = dr.pileup_add_records_into
    monkeypatch.setattr(dr, "pileup_add_records_into",
                        lambda rec, *a: calls.append(rec.pos.shape[0]) or real(rec, *a))
    monkeypatch.setattr(dr, "bincount_add_into", lambda *a: pytest.fail("B1 reached"))
    import ngsbits_tpu_torch.qc.pileup as mod
    real_prefetch = mod.prefetch
    monkeypatch.setattr(mod, "prefetch", lambda it, depth: threads.append(depth)
                        or real_prefetch(it, depth))
    by_chr = {c: np.sort(loci[chrs == c]) for c in np.unique(chrs)}
    kept = []
    for b in port_bam.BamReader(str(path), batch_records=1000):
        keys, ends = port_pileup.record_keys(b, False), b.end_positions()
        reach = sum(1 for r in np.flatnonzero(keys >= 0)
                    if ((by_chr.get(keys[r] + 1, loci[:0]) > b.pos[r])
                        & (by_chr.get(keys[r] + 1, loci[:0]) <= ends[r])).any())
        if reach:
            kept.append(reach)
    reader = port_bam.BamReader(str(path), batch_records=1000)
    port_pileup.pileup_at_positions(str(path), chrs, loci, reader=reader, min_mapq=1,
                                    min_baseq=13)
    reader.close()
    assert calls == kept and len(kept) >= 10 and threads == [2]


def test_plain_version_counts_into_the_counters_it_is_given():
    """The plain version adds into the caller's counters (two batches into
    one set equal the sums of each alone) and takes the MAPQ-0 counters
    only together; the selfcheck case runs both versions (both plain on
    the CPU) to the same outputs."""
    batches, chrs, pos = _seeded(5)
    eng = dr.DevicePileup(chrs, pos, np.array([1, 2, 3]), track_mapq0=True, device="cpu")
    alone = []
    for cols in batches:
        keys = selfcheck.records_keys(cols, (cols["flag"] & 0x704) == 0)
        rec = dr.upload_records(cols["pos"], keys, cols["cigar_off"], cols["cigar"],
                                cols["seq_off"], cols["qual"], seq=cols["seq"],
                                mapq=cols["mapq"], device="cpu")
        one = dr.DevicePileup(chrs, pos, np.array([1, 2, 3]), track_mapq0=True, device="cpu")
        one.add(rec, 1, 13)
        alone.append(one.finalize())
        eng.add(rec, 1, 13)
        case = selfcheck.pileup_case(rec, eng.loci, eng.table, 1, 13, True)
        case.kernel()
        case.plain()
        assert selfcheck.max_abs_err(case) == 0 and case.bytes > 16 * len(keys)
    both = eng.finalize()
    for field in FIELDS:
        np.testing.assert_array_equal(both[field], alone[0][field] + alone[1][field])
    with pytest.raises(ValueError, match="together"):
        dr.pileup_add_records_into(rec, eng.loci, eng.table, 1, 13,
                                   torch.zeros(len(pos), 4, dtype=torch.int32),
                                   torch.zeros(len(pos), dtype=torch.int32),
                                   torch.zeros(len(pos), dtype=torch.int32), None)


def test_wrapper_refuses_records_without_bases_and_other_devices():
    cols = selfcheck.alignment_records(50, seed=3)
    rec = dr.upload_records(cols["pos"], np.zeros(50, np.int32), cols["cigar_off"],
                            cols["cigar"], cols["seq_off"], cols["qual"], seq=cols["seq"],
                            mapq=cols["mapq"], device="cpu")
    loci = torch.tensor([5, 9], dtype=torch.int32)
    table = torch.tensor([[0], [2]], dtype=torch.int32)
    counts, dels = torch.zeros(2, 4, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="bases, qualities and MAPQ"):
        dr.pileup_add_records_into(rec._replace(seq=None), loci, table, 1, 13, counts, dels)
    with pytest.raises(ValueError, match="device type"):
        meta = torch.zeros(2, dtype=torch.int32, device="meta")
        dr.pileup_add_records_into(rec._replace(**{k: getattr(rec, k).to("meta") for k in
                                                   rec._fields}), meta, table.to("meta"), 1,
                                   13, counts.to("meta"), meta)
    with pytest.raises(ValueError, match="seq"):
        dr.upload_records(cols["pos"], np.zeros(50, np.int32), cols["cigar_off"],
                          cols["cigar"], seq=cols["seq"])
    with pytest.raises(ValueError, match="mapq"):
        dr.upload_records(cols["pos"], np.zeros(50, np.int32), cols["cigar_off"],
                          cols["cigar"], mapq=cols["mapq"][:10])
    with pytest.raises(ValueError, match="int32"):
        dr.DevicePileup(np.ones(1), np.array([2**31]), np.array([1]), device="cpu")
    before = dr.pileup_add_records_into.launches
    dr.pileup_add_records_into(rec, loci, table, 1, 13, counts, dels)  # CPU: no launch
    assert dr.pileup_add_records_into.launches == before
