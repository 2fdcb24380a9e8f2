"""C1's record form on the CPU: ``coverage_add_records_plain``, through
``DeviceCoverage.add_records`` and C2's dense mode, against the JAX
package's host route on the same seeded batches (``selfcheck.alignment_records``,
built as both packages' ``BamBatch``): ``_expand_baseq_positions`` with
``_ChrCoverage`` / ``_ChrCoverageSparse`` (``add_positions``, ``add_spans``,
``finalize``), or without ``-min_baseq`` the records' spans from
``end_positions``, as ``ngsbits_tpu/qc/coverage.py:376-390`` makes them.
Every CIGAR op, N ops over several merged blocks, reads over a box's edges
and outside it, qualities of 0xFF, ``-min_baseq`` 0, 20 and 30, several
chromosomes in a batch, unsorted records, records the filter drops inside a
launch's range, and records with M ops but no SEQ. Integer outputs: exact
equality. Also the coverage tools' pass (one launch a batch and
chromosome, no host expansion) and the wrapper's checks."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ngsbits_tpu.io.bam import BamBatch as JaxBatch  # noqa: E402
from ngsbits_tpu.qc import coverage as jax_cov  # noqa: E402

from ngsbits_tpu_torch.io.bam import BamBatch as PortBatch  # noqa: E402
from ngsbits_tpu_torch.io.bam import BamReader  # noqa: E402
from ngsbits_tpu_torch.ops import device_reduce as dr  # noqa: E402
from ngsbits_tpu_torch.ops import selfcheck  # noqa: E402
from ngsbits_tpu_torch.qc import coverage as port_cov  # noqa: E402
from ngsbits_tpu_torch.utils import synth  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _cpu_route(monkeypatch):
    monkeypatch.setenv("NGSBITS_TORCH_DEVICE", "cpu")


def _batch(cls, cols: dict):
    """A ``BamBatch`` of either package from ``alignment_records``' columns."""
    n = len(cols["pos"])
    z = np.zeros(n, np.int32)
    empty = np.zeros(n + 1, np.int64)
    return cls(ref_id=cols["ref_id"], pos=cols["pos"], flag=cols["flag"], mapq=cols["mapq"],
               l_seq=cols["l_seq"], n_cigar=cols["n_cigar"], tlen=z, mate_ref_id=z,
               mate_pos=z, cigar=cols["cigar"], cigar_off=cols["cigar_off"],
               seq=np.zeros(len(cols["qual"]), np.uint8), qual=cols["qual"],
               seq_off=cols["seq_off"], names=b"", name_off=empty,
               tags=np.zeros(0, np.uint8), tags_off=empty)


def _with_ff(cols: dict) -> dict:
    """The batch with each record that has no SEQ given 0xFF qualities ("no
    qualities") of its query length: what the JAX package must be handed
    to read no other record's bytes (ROADMAP F8)."""
    op, length = cols["cigar"] & 0xF, (cols["cigar"] >> 4).astype(np.int64)
    rec_of = np.repeat(np.arange(len(cols["pos"])), np.diff(cols["cigar_off"]))
    qlen = np.bincount(rec_of, weights=length * np.isin(op, [0, 1, 4, 7, 8]),
                       minlength=len(cols["pos"])).astype(np.int64)
    l_seq = np.where(cols["l_seq"] == 0, qlen, cols["l_seq"]).astype(np.int32)
    parts = [cols["qual"][a:b] if ls else np.full(n, 0xFF, np.uint8) for a, b, ls, n in
             zip(cols["seq_off"][:-1], cols["seq_off"][1:], cols["l_seq"], l_seq)]
    return dict(cols, l_seq=l_seq, qual=np.concatenate(parts + [np.zeros(0, np.uint8)]),
                seq_off=np.concatenate(([0], np.cumsum(l_seq))).astype(np.int64))


def _jax_coverage(acc, cols: dict, sel: np.ndarray, ref: int, min_baseq: int) -> np.ndarray:
    """The JAX package's host route for the records of ``ref`` in ``sel``,
    those without SEQ given 0xFF qualities (``_with_ff``)."""
    batch = _batch(JaxBatch, _with_ff(cols))
    idx = np.flatnonzero(sel & (cols["ref_id"] == ref))
    if min_baseq > 0:
        m_pos, _, dn_s, dn_e = jax_cov._expand_baseq_positions(batch, idx, min_baseq)
        acc.add_positions(m_pos)
        if len(dn_s):
            acc.add_spans(dn_s, dn_e)
    elif len(idx):
        acc.add_spans(batch.pos[idx].astype(np.int64) + 1, batch.end_positions()[idx])
    acc.finalize()
    return acc._cov


def _port_coverage(acc, cols: dict, sel: np.ndarray, ref: int, min_baseq: int,
                   launches: list | None = None) -> np.ndarray:
    """The port's: one upload of the batch, one launch for ``ref`` over the
    range of records that holds its kept ones."""
    quals = (cols["seq_off"], cols["qual"]) if min_baseq > 0 else ()
    rec = dr.upload_records(cols["pos"], selfcheck.records_keys(cols, sel), cols["cigar_off"],
                            cols["cigar"], *quals, device=CPU)
    at = np.flatnonzero(sel & (cols["ref_id"] == ref))
    if len(at):
        acc.dev.add_records(rec, int(at[0]), int(at[-1]) + 1, ref, min_baseq)
        if launches is not None:
            launches.append((int(at[0]), int(at[-1]) + 1))
    return acc.dev.dense().to(torch.int64).numpy()


def _sparse_regions(start: int, width: int, seed: int):
    """Regions of 20-300 bp every 0.5-3 kb (1-based inclusive), some
    touching the one before."""
    rng = np.random.default_rng(seed)
    s = start + np.cumsum(rng.integers(500, 3000, size=width // 1500))
    s = s[s < start + width]
    e = s + rng.integers(20, 300, size=len(s))
    s[3::11] = e[2::11][:len(s[3::11])] + 1
    return s.astype(np.int64), e.astype(np.int64)


# name: (alignment_records' arguments, the chromosome, the accumulator)
CASES = {
    "box inside the reads": (dict(n=3000, seed=1, start=1000, width=20_000), 0,
                             ("box", 5001, 15000)),
    "box past the reads": (dict(n=2000, seed=2, start=1000, width=8_000), 0,
                           ("box", 500, 30_000)),
    "sparse, long N ops": (dict(n=3000, seed=3, start=1000, width=200_000, long_n=20_000), 0,
                           ("sparse", 1000, 200_000)),
    "several chromosomes": (dict(n=3000, seed=4, start=1000, width=20_000, n_refs=3), 1,
                            ("box", 3001, 14000)),
    "unsorted": (dict(n=3000, seed=5, start=1000, width=20_000, n_refs=2, ordered=False), 1,
                 ("box", 2001, 18000)),
    "unsorted, sparse": (dict(n=3000, seed=6, start=1000, width=200_000, n_refs=2,
                              ordered=False, long_n=5_000), 0, ("sparse", 1000, 200_000)),
}


def _accumulators(kind, a, b, seed):
    if kind == "box":
        return jax_cov._ChrCoverage(a, b), port_cov._ChrCoverage(a, b)
    rs, re = _sparse_regions(a, b, seed)
    return jax_cov._ChrCoverageSparse(rs, re), port_cov._ChrCoverageSparse(rs, re)


@pytest.mark.parametrize("min_baseq", [0, 20, 30])
@pytest.mark.parametrize("name", sorted(CASES))
def test_record_form_matches_the_jax_expansion_and_accumulators(name, min_baseq):
    """The coverage equals the JAX package's host route. The tools' filter
    drops duplicates, secondary, supplementary, unmapped and MAPQ-0 records
    inside the launch's range, and records of other chromosomes lie there
    too (several chromosomes, unsorted)."""
    args, ref, (kind, a, b) = CASES[name]
    cols = selfcheck.alignment_records(**args)
    sel = port_cov._alignment_filter(_batch(PortBatch, cols), 1)
    assert (~sel).sum() > 0 and (cols["qual"] == 0xFF).any() and (cols["l_seq"] == 0).any()
    jax_acc, port_acc = _accumulators(kind, a, b, args["seed"])
    assert getattr(jax_acc, "_dev", None) is None  # the host route
    launches = []
    got = _port_coverage(port_acc, cols, sel, ref, min_baseq, launches)
    want = _jax_coverage(jax_acc, cols, sel, ref, min_baseq)
    assert got.max() > 0 and len(launches) == 1
    r0, r1 = launches[0]
    assert (cols["ref_id"][r0:r1] != ref).any() or (~sel[r0:r1]).any()
    np.testing.assert_array_equal(got, want)


def test_long_n_ops_cross_several_blocks():
    """The sparse case's longest N ops span several merged blocks (more
    than four times the widest step between region starts; the JAX
    package's ``add_spans`` loops over the blocks, the record form adds two
    boundaries)."""
    args, _, (_, a, b) = CASES["sparse, long N ops"]
    cols = selfcheck.alignment_records(**args)
    rs, re = _sparse_regions(a, b, args["seed"])
    op, length = cols["cigar"] & 0xF, cols["cigar"] >> 4
    assert len(rs) > 50 and length[op == 3].max() > 4 * np.diff(rs).max()


@pytest.mark.parametrize("min_baseq", [20, 30])
def test_batches_added_in_turn_match_the_jax_package(min_baseq):
    """Three batches (three uploads) into one difference array, each with
    records of two chromosomes, the accumulator a sparse panel."""
    rs, re = _sparse_regions(1000, 100_000, 7)
    jax_acc = jax_cov._ChrCoverageSparse(rs, re)
    port_acc = port_cov._ChrCoverageSparse(rs, re)
    for seed in (8, 9, 10):
        cols = selfcheck.alignment_records(1500, seed=seed, start=1000, width=100_000, n_refs=2,
                                           long_n=3000)
        sel = port_cov._alignment_filter(_batch(PortBatch, cols), 1)
        quals = (cols["seq_off"], cols["qual"])
        rec = dr.upload_records(cols["pos"], selfcheck.records_keys(cols, sel),
                                cols["cigar_off"], cols["cigar"], *quals, device=CPU)
        at = np.flatnonzero(sel & (cols["ref_id"] == 1))
        port_acc.dev.add_records(rec, int(at[0]), int(at[-1]) + 1, 1, min_baseq)
        batch = _batch(JaxBatch, _with_ff(cols))
        m_pos, _, dn_s, dn_e = jax_cov._expand_baseq_positions(batch, at, min_baseq)
        jax_acc.add_positions(m_pos)
        jax_acc.add_spans(dn_s, dn_e)
    jax_acc.finalize()
    np.testing.assert_array_equal(port_acc.dev.dense().to(torch.int64).numpy(), jax_acc._cov)


def _no_seq_batch():
    """Record 0: 20M 5D 30M with no SEQ (l_seq 0); record 1 after it: 50M
    with qualities of 2, below every -min_baseq tested."""
    cigar = np.array([(20 << 4) | 0, (5 << 4) | 2, (30 << 4) | 0, (50 << 4) | 0], np.uint32)
    return dict(ref_id=np.zeros(2, np.int32), pos=np.array([1000, 1100], np.int32),
                flag=np.zeros(2, np.uint16), mapq=np.full(2, 60, np.uint8),
                l_seq=np.array([0, 50], np.int32), n_cigar=np.array([3, 1], np.int32),
                cigar=cigar, cigar_off=np.array([0, 3, 4], np.int64),
                qual=np.full(50, 2, np.uint8), seq_off=np.array([0, 0, 50], np.int64))


@pytest.mark.parametrize("min_baseq", [20, 30])
def test_a_record_without_seq_reads_no_other_records_bytes(min_baseq):
    """A record with M ops and no SEQ has no qualities: its bases count, as
    0xFF's do. The port equals the JAX package on the same record given 0xFF
    qualities of its query length; it does not take the next record's bytes
    (the JAX package's expansion indexes the batch's flat qualities with the
    record's offset, which reaches into the next record: ROADMAP F8)."""
    cols = _no_seq_batch()
    sel = np.ones(2, bool)
    port_acc = port_cov._ChrCoverage(900, 1300)
    got = _port_coverage(port_acc, cols, sel, 0, min_baseq)
    want = _jax_coverage(jax_cov._ChrCoverage(900, 1300), cols, sel, 0, min_baseq)
    assert _with_ff(cols)["qual"][:50].tolist() == [0xFF] * 50
    np.testing.assert_array_equal(got, want)
    assert got[1000 - 899:1055 - 899].min() == 1  # record 0's 55 reference bases
    assert got[1055 - 899:1100 - 899].max() == 0 and got[1100 - 899:].max() == 0


def test_zero_length_and_unknown_ops_add_nothing():
    """A record with no CIGAR, one with ops of length 0, and CIGAR codes
    past X (9-15) consume nothing, on the reference or the query."""
    cigar = np.array([(0 << 4) | 0, (4 << 4) | 9, (10 << 4) | 0, (3 << 4) | 15], np.uint32)
    cols = dict(pos=np.array([10, 20, 30], np.int32), cigar=cigar,
                cigar_off=np.array([0, 0, 1, 4], np.int64),
                qual=np.full(10, 40, np.uint8), seq_off=np.array([0, 0, 0, 10], np.int64))
    keys = np.zeros(3, np.int32)
    for min_baseq in (0, 20):
        rec = dr.upload_records(cols["pos"], keys, cols["cigar_off"], cols["cigar"],
                                cols["seq_off"], cols["qual"], device=CPU)
        dc = dr.DeviceCoverage(100, CPU, blocks=np.array([[0], [100]]))
        dc.add_records(rec, 0, 3, 0, min_baseq)
        cov = dc.dense().numpy()
        assert cov[30:40].tolist() == [1] * 10 and cov.sum() == 10


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    """A synthetic BAM of 2,500 pairs on three chromosomes and its panel."""
    d = tmp_path_factory.mktemp("coverage_records")
    lengths = {"chr1": 600_000, "chr2": 300_000, "chr3": 200_000}
    genome = synth.synth_genome(d / "g.fa", lengths, seed=21)
    rows = synth.synth_roi(d / "roi.bed", genome, 60, seed=22)
    synth.synth_bam(d / "x.bam", genome, 2500, seed=23, roi=rows)
    return d


@pytest.mark.parametrize("min_baseq", [0, 20])
def test_the_pass_launches_once_a_batch_and_chromosome(bam, monkeypatch, min_baseq):
    """The coverage tools' pass hands each batch's records over in one upload
    and adds them with one launch of the record form per chromosome of the
    batch: no host expansion, no span upload (``DeviceCoverage.add``)."""
    from ngsbits_tpu_torch.core.intervals import BedFile
    batch_records = 700
    monkeypatch.setattr(port_cov, "BamReader",
                        lambda f, n_threads=4: BamReader(f, n_threads, batch_records))
    assert not hasattr(port_cov, "_expand_baseq_positions")
    calls, uploads = [], []
    add_records, upload = dr.DeviceCoverage.add_records, port_cov.upload_records

    def counted(self, rec, r0, r1, ref, q):
        calls.append((len(uploads), ref))
        assert q == min_baseq and (rec.qual is not None) == (min_baseq > 0)
        add_records(self, rec, r0, r1, ref, q)

    def refused(self, *args):
        raise AssertionError("the coverage pass uploaded spans")

    monkeypatch.setattr(dr.DeviceCoverage, "add_records", counted)
    monkeypatch.setattr(dr.DeviceCoverage, "add", refused)
    monkeypatch.setattr(port_cov, "upload_records",
                        lambda *a, **k: uploads.append(1) or upload(*a, **k))
    bed = BedFile.from_file(str(bam / "roi.bed"))
    port_cov._compute_chr_coverage(bed, str(bam / "x.bam"), 1, min_baseq)
    want, k = [], 0  # (batches uploaded so far, chromosome) of each launch
    with BamReader(str(bam / "x.bam"), 4, batch_records) as reader:
        in_panel = np.isin(reader.ref_names, sorted({line.chr.str for line in bed.lines}))
        for batch in reader:
            sel = port_cov._alignment_filter(batch, 1) & (batch.ref_id >= 0)
            sel &= in_panel[np.maximum(batch.ref_id, 0)]
            if sel.any():
                k += 1
                want += [(k, int(r)) for r in np.unique(batch.ref_id[sel])]
    assert calls == want and len(uploads) == k > 3 and len(calls) > k
    assert sorted({r for _, r in calls}) == [0, 1, 2]


def test_selfcheck_case_agrees_on_the_cpu():
    """The case chip_smoke.py holds kernel against plain on the card: on the
    CPU both sides run the plain version and must agree."""
    cols = selfcheck.alignment_records(1000, seed=11, start=0, width=10_000, n_refs=2)
    keys = selfcheck.records_keys(cols, cols["flag"] == 0)
    rec = dr.upload_records(cols["pos"], keys, cols["cigar_off"], cols["cigar"],
                            cols["seq_off"], cols["qual"], device=CPU)
    blocks = torch.tensor([[100, 4000], [3000, 9000], [0, 2900]])
    for min_baseq in (0, 20):
        c = selfcheck.coverage_add_records_case(rec, 0, 1000, 1, min_baseq, blocks, 7900)
        c.kernel()
        c.plain()
        assert selfcheck.max_abs_err(c) == 0
        assert c.outputs()[0][0].max() > 0 and c.bytes > 0 and c.ops > 0


def test_wrapper_takes_the_plain_version_on_the_cpu_and_counts_no_launch():
    cols = selfcheck.alignment_records(300, seed=12)
    rec = dr.upload_records(cols["pos"], np.zeros(300, np.int32), cols["cigar_off"],
                            cols["cigar"], cols["seq_off"], cols["qual"], device=CPU)
    assert rec.seq is None and rec.mapq is None  # the pileup's columns, not asked for
    uploaded = [t for t in rec if t is not None]
    assert [t.dtype for t in uploaded] == [torch.int32, torch.int32, torch.int64, torch.int32,
                                           torch.int64, torch.uint8]
    assert all(t.data_ptr() % 16 == 0 for t in uploaded)
    np.testing.assert_array_equal(rec.cigar.numpy().view(np.uint32), cols["cigar"])
    before = dr.coverage_add_records_into.launches
    diff = torch.zeros(20_001, dtype=torch.int32)
    dr.coverage_add_records_into(rec, 0, 300, 0, 20, torch.tensor([[0], [20_000], [0]]), diff)
    assert int(diff.abs().sum()) > 0
    assert dr.coverage_add_records_into.launches == before


def test_record_form_refuses_what_it_does_not_take():
    cols = selfcheck.alignment_records(50, seed=13)
    args = (cols["pos"], np.zeros(50, np.int32), cols["cigar_off"], cols["cigar"])
    with pytest.raises(ValueError, match="offsets"):
        dr.upload_records(cols["pos"], args[1], cols["cigar_off"][::-1], cols["cigar"])
    with pytest.raises(ValueError, match="offsets"):
        dr.upload_records(*args, cols["seq_off"], cols["qual"][:-1])
    with pytest.raises(ValueError, match="keys"):
        dr.upload_records(cols["pos"], args[1][:-1], *args[2:])
    rec = dr.upload_records(*args, device=CPU)
    dc = dr.DeviceCoverage(100, CPU, blocks=np.array([[0, 50], [40, 110]]))
    with pytest.raises(ValueError, match="qualities"):
        dc.add_records(rec, 0, 50, 0, 20)
    with pytest.raises(ValueError, match="records"):
        dc.add_records(rec, 10, 51, 0, 0)
    with pytest.raises(ValueError, match="blocks"):
        dr.DeviceCoverage(100, CPU).add_records(rec, 0, 50, 0, 0)
    for bad in ([[0, 30], [40, 100]], [[0, 40], [50, 90]], [[0], [0]]):
        with pytest.raises(ValueError, match="blocks"):
            dr.DeviceCoverage(100 if bad[0] != [0] else 0, CPU, blocks=np.array(bad))
