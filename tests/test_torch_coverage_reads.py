"""C1's read form and R1's new tiling on the CPU, against the JAX package.

MappingQC hands C1's read form its usable on-target reads with the ROI's
range of regions each overlaps, and the card clips them to the regions. Here
both packages' ``MappingScan.process`` run on the same seeded batches
(``selfcheck.roi_reads``, built as both packages' ``BamBatch``): the port's
flattened ROI coverage (``DeviceCoverage.add_reads``, the plain version on
the CPU, then C2's dense mode) against the JAX package's flattening
(``ngsbits_tpu/qc/mapping_stats.py:284-305``) into its host difference array
and into X6 (``DeviceCoverage``, jitted on the CPU): reads at region edges,
over several regions, in no region, over the ROI's last region, of no
reference length, several chromosomes, an empty batch. The read form's
out-of-contract input raises one ValueError on every route. R1's plain
version, through the coverage tools' accumulator, against the JAX package's
``region_sum`` at the region sets its tiling treats differently
(``selfcheck.r1_regions``). Integer outputs: exact equality."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ngsbits_tpu.io.bam import BamBatch as JaxBatch  # noqa: E402
from ngsbits_tpu.ops.device_reduce import DeviceCoverage as JaxCoverage  # noqa: E402
from ngsbits_tpu.qc import coverage as jax_cov  # noqa: E402
from ngsbits_tpu.qc import mapping_stats as jax_ms  # noqa: E402

from ngsbits_tpu_torch.core.chromosome import Chromosome  # noqa: E402
from ngsbits_tpu_torch.io.bam import BamBatch as PortBatch  # noqa: E402
from ngsbits_tpu_torch.ops import device_reduce as dr  # noqa: E402
from ngsbits_tpu_torch.ops import selfcheck  # noqa: E402
from ngsbits_tpu_torch.qc import coverage as port_cov  # noqa: E402
from ngsbits_tpu_torch.qc import mapping_stats as port_ms  # noqa: E402

CPU = torch.device("cpu")
REFS = ["chr1", "chr2", "chrX"]


@pytest.fixture(autouse=True)
def _host_routes(monkeypatch):
    """The port on its CPU route; the JAX package's scan on its host route."""
    monkeypatch.setenv("NGSBITS_TORCH_DEVICE", "cpu")
    for var in ("NGSBITS_MESH", "NGSBITS_DEVICE_ENGINES"):
        monkeypatch.delenv(var, raising=False)


def _roi(module, rc, rs, re):
    nums = np.array([Chromosome(r).num for r in REFS], dtype=np.int32)
    return module.RoiLookup(SimpleNamespace(columns=lambda: (nums[rc], rs, re)))


def _batch(cls, chrom, qs, qe, seed):
    """A ``BamBatch`` of either package with one record a read: a single M
    op over ``[qs, qe]`` (10 soft-clipped bases where ``qe = qs - 1``);
    some duplicates and MAPQ 0 (on target, not usable), the rest usable."""
    rng = np.random.default_rng(seed)
    n = len(qs)
    length = qe - qs + 1
    cigar = np.where(length > 0, length << 4, (10 << 4) | 4).astype(np.uint32)
    l_seq = np.where(length > 0, length, 10).astype(np.int32)
    flag = np.where(rng.random(n) < 0.05, 0x400, 0).astype(np.uint16)
    mapq = np.where(rng.random(n) < 0.05, 0, 60).astype(np.uint8)
    seq_off = np.concatenate(([0], np.cumsum(l_seq))).astype(np.int64)
    z32, z64 = np.zeros(n, np.int32), np.zeros(n + 1, np.int64)
    return cls(ref_id=chrom.astype(np.int32), pos=(qs - 1).astype(np.int32), flag=flag,
               mapq=mapq, l_seq=l_seq, n_cigar=np.ones(n, np.int32), tlen=z32,
               mate_ref_id=np.full(n, -1, np.int32), mate_pos=z32, cigar=cigar,
               cigar_off=np.arange(n + 1, dtype=np.int64),
               seq=np.zeros(int(seq_off[-1]), np.uint8), qual=np.zeros(int(seq_off[-1]), np.uint8),
               seq_off=seq_off, names=b"", name_off=z64, tags=np.zeros(0, np.uint8),
               tags_off=z64)


SUBSETS = ("several chromosomes", "at region edges", "over several regions", "in no region",
           "the ROI's last region", "no reference length", "an empty batch")


def _subset(name, rs, re, reads):
    chrom, qs, qe, i0, i1 = reads
    last = np.maximum(i1 - 1, 0)
    on = i1 > i0
    pick = {"several chromosomes": np.ones(len(qs), bool),
            "at region edges": on & ((qe == rs[i0.clip(max=len(rs) - 1)]) | (qs == re[last])),
            "over several regions": i1 - i0 > 1,
            "in no region": ~on,
            "the ROI's last region": i1 == len(rs),
            "no reference length": qe == qs - 1,
            "an empty batch": np.zeros(len(qs), bool)}[name]
    return tuple(a[pick] for a in reads)


@pytest.mark.parametrize("name", SUBSETS)
def test_read_form_matches_the_jax_flattening_into_x6_and_the_host_array(name):
    """Both scans on the same batches: the port's difference array (C1's
    read form) equals the JAX package's host difference array, and its
    dense coverage (C2) equals that array's prefix sum and X6's, fed the
    JAX package's flattened spans."""
    (rc, rs, re), reads = selfcheck.roi_reads(3000, seed=5)
    chrom, qs, qe, i0, i1 = _subset(name, rs, re, reads)
    if name != "an empty batch":
        assert len(qs) >= 20
    port_roi, jax_roi = _roi(port_ms, rc, rs, re), _roi(jax_ms, rc, rs, re)
    for c in range(len(REFS)):  # the ranges are the scan's own
        m = chrom == c
        got = port_roi.overlap_range(Chromosome(REFS[c]).num, qs[m], qe[m])
        np.testing.assert_array_equal(got[0], i0[m])
        np.testing.assert_array_equal(got[1], i1[m])
    span = int(port_roi.flat_off[-1])
    port = port_ms.MappingScan(port_roi)
    host = jax_ms.MappingScan(jax_roi)
    x6 = jax_ms.MappingScan(jax_roi)
    assert host.roi_cov_diff is not None and host._roi_dev is None
    x6._roi_dev, x6.roi_cov_diff = JaxCoverage(span), None
    reader = SimpleNamespace(ref_names=REFS)
    for b in range(0, max(len(qs), 1), 700):  # batches of 700 reads
        sl = slice(b, b + 700)
        port.process(_batch(PortBatch, chrom[sl], qs[sl], qe[sl], b), reader)
        for scan in (host, x6):
            scan.process(_batch(JaxBatch, chrom[sl], qs[sl], qe[sl], b), reader)
    np.testing.assert_array_equal(port._roi_dev.diff.numpy(), host.roi_cov_diff)
    want = np.cumsum(host.roi_cov_diff)[:-1]
    got = port._roi_dev.dense().to(torch.int64).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x6._roi_dev.finalize())
    assert (port.bases_usable, port.al_ontarget) == (host.bases_usable, host.al_ontarget)
    if name not in ("in no region", "no reference length", "an empty batch"):
        assert want.max() > 0


def test_add_reads_without_the_scan_equals_the_span_form_on_the_host_spans():
    """``DeviceCoverage.add_reads`` on every read of a batch, off-target
    ones included (their ranges are empty), against C1's span form fed the
    spans the JAX package's flattening makes of the same reads."""
    (rc, rs, re), (chrom, qs, qe, i0, i1) = selfcheck.roi_reads(2000, seed=6)
    roi = _roi(port_ms, rc, rs, re)
    span = int(roi.flat_off[-1])
    cnt = i1 - i0
    rep = np.repeat(np.arange(len(qs)), cnt)
    regions = np.repeat(i0, cnt) + (np.arange(int(cnt.sum()))
                                    - np.repeat(np.concatenate(([0], np.cumsum(cnt[:-1]))), cnt))
    ol_s = np.maximum(rs[regions], qs[rep])
    ol_e = np.minimum(re[regions], qe[rep])
    flat_s = roi.flat_off[regions] + ol_s - rs[regions]
    spans = dr.DeviceCoverage(span, CPU)
    spans.add(flat_s, flat_s + ol_e - ol_s + 1)
    reads = dr.DeviceCoverage(span, CPU, regions=np.stack([rs, re]))
    reads.add_reads(qs, qe, i0, i1)
    assert torch.equal(reads.diff, spans.diff)
    before = dr.coverage_add_reads_into.launches
    reads.add_reads(qs[:0], qe[:0], i0[:0], i1[:0])  # an empty batch
    assert torch.equal(reads.diff, spans.diff)
    assert dr.coverage_add_reads_into.launches == before


BAD_READS = {"range below 0": ([10, 20], [60, 70], [0, -1], [1, 1]),
             "range past the regions": ([10, 20], [60, 70], [0, 2], [1, 4]),
             "range that ends before it starts": ([10, 20], [60, 70], [0, 2], [1, 1]),
             "read that ends before it starts": ([10, 20], [60, 17], [0, 0], [1, 1]),
             "read past int32": ([10, 20], [60, 2**31], [0, 0], [1, 1])}


@pytest.mark.parametrize("name", sorted(BAD_READS))
def test_out_of_contract_reads_raise_the_same_error_on_every_route(name):
    """F7 stays closed: ``DeviceCoverage.add_reads`` checks each batch on
    the host before the upload, so the CPU route and the card
    (tests/test_torch_kernels_gpu.py) raise the same ValueError and add
    nothing. A read of no reference length (``end = start - 1``) is in the
    contract and adds nothing."""
    dc = dr.DeviceCoverage(200, CPU, regions=np.array([[1, 101, 151], [100, 150, 200]]))
    with pytest.raises(ValueError, match="outside the contract"):
        dc.add_reads(*(np.array(c) for c in BAD_READS[name]))
    assert int(dc.diff.abs().sum()) == 0
    dc.add_reads(np.array([10, 95]), np.array([9, 105]), np.array([0, 0]), np.array([1, 2]))
    assert dc.dense().tolist() == [0] * 94 + [1] * 11 + [0] * 95


def test_regions_are_checked_at_set_up():
    with pytest.raises(ValueError, match="span's 10 positions"):
        dr.DeviceCoverage(10, CPU, regions=np.array([[1, 20], [5, 25]]))
    with pytest.raises(ValueError, match="add_reads needs"):
        dr.DeviceCoverage(10, CPU).add_reads(np.array([1]), np.array([2]), np.array([0]),
                                             np.array([0]))
    with pytest.raises(ValueError, match="device type"):
        dr.coverage_add_reads_into(torch.zeros((4, 2), dtype=torch.int32, device="meta"),
                                   torch.zeros((3, 1), dtype=torch.int32, device="meta"),
                                   torch.zeros(4, dtype=torch.int32, device="meta"))


def _r1_coverage(span, seed):
    s, e = selfcheck.coverage_spans(span, max(span // 10, 4), seed=seed, pile=700)
    return selfcheck.coverage_diff(s, e, span, CPU)


CPU_R1_KINDS = [k for k in selfcheck.R1_KINDS if k != "dense panel"]


@pytest.mark.parametrize("kind", CPU_R1_KINDS)
def test_region_sums_match_the_host_region_sum_where_the_tiling_differs(kind):
    """R1's plain version, through the coverage tools' accumulator, against
    ``_ChrCoverage.region_sum`` (the JAX package's host prefix sums,
    ``ngsbits_tpu/qc/coverage.py:131-134``, ``:236-240``)."""
    span, rs, re = selfcheck.r1_regions(kind, seed=3)
    lo = 1001
    rng = np.random.default_rng(4)
    s = rng.integers(lo - 300, lo + span, size=span // 10 + 5)
    e = s + rng.integers(0, 400, size=len(s))
    want = jax_cov._ChrCoverage(lo, lo + span - 1)
    assert want._dev is None
    want.add_spans(s, e)
    want.finalize()
    got = port_cov._ChrCoverage(lo, lo + span - 1)
    got.add_spans(s, e)
    sums = got.region_sums(rs + lo, re + lo)
    np.testing.assert_array_equal(
        sums, [want.region_sum(int(a) + lo, int(b) + lo) for a, b in zip(rs, re)])


@pytest.mark.parametrize("case", ["coverage_add_reads", *(f"region_sums {k}"
                                                          for k in CPU_R1_KINDS)])
def test_selfcheck_cases_agree_on_the_cpu(case):
    """The cases chip_smoke.py and the ``gpu`` tests hold kernel against
    plain on the card: on the CPU both sides run the plain version and must
    agree, with a bound to state."""
    if case == "coverage_add_reads":
        (rc, rs, re), (chrom, qs, qe, i0, i1) = selfcheck.roi_reads(3000, seed=7)
        span = int((re - rs + 1).sum())
        regions = dr.DeviceCoverage(span, CPU, regions=np.stack([rs, re])).regions
        reads = torch.from_numpy(np.stack([qs, qe, i0, i1]).astype(np.int32))
        c = selfcheck.coverage_add_reads_case(reads, regions, span)
    else:
        span, rs, re = selfcheck.r1_regions(case.split(" ", 1)[1], seed=8)
        cov = torch.cumsum(_r1_coverage(span, 9)[:span], 0).to(torch.int32)
        c = selfcheck.region_sums_case(cov, rs, re)
    c.kernel()
    c.plain()
    assert selfcheck.max_abs_err(c) == 0
    assert c.bytes > 0 and c.ops > 0
