"""The port's RohHunter on its CPU route against the JAX package's tool
(JAX_PLATFORMS=cpu) on the same seeded files: the TSV byte-identical across
``-var_af_keys``, ``-var_af_keys_vep``, ``-exclude`` (runs broken by it,
merges refused by it), ``-annotate`` with two BEDs, ``-inc_chrx``, the
output filters and the merge thresholds, and the same exit code and message
where the tool refuses its input (two samples, no DP header, QUAL ``.`` with
``-var_min_q`` above 0, an unsorted exclude BED, a VEP field or CSQ that is
not there), and on VCFs whose AF reads ``inf`` after a run's product
reached 0 or before, ``1e39`` (float32 overflow) or ``nan`` (which ``max``
drops). H1's plain version (``ops/variants.py::roh_products_plain``)
bit-equal to the host's ordered product of ``_Roh.q_score`` and its Q equal
to the JAX package's; at the early exit's edges (``selfcheck.roh_exit_edges``:
products of 0, +inf and NaN, NaN payloads) equal to it with any two NaNs
equal; ``selfcheck.roh_chain`` against a walk of each range;
``DeviceExclude`` against the JAX package's ``ChromosomalIndex.matching_index``
on an unmerged BED.

Inputs (numpy seeds, ``utils/synth.py``): ``wgs_vcf`` over three chromosomes
of 0.4-1 Mb (about 3,300 records, five planted ROH segments of 100-300 kb),
``roh_beds``' exclude BED (sorted, unmerged, gaps inside planted segments)
and its two annotation BEDs, and small hand-written VCFs and BEDs for the
refusals."""

import numpy as np
import pytest
import torch

from ngsbits_tpu.core.intervals import BedFile as JaxBed
from ngsbits_tpu.core.intervals import ChromosomalIndex as JaxIndex
from ngsbits_tpu.tools import roh_hunter as jax_roh

from helpers import execute
from ngsbits_tpu_torch.__main__ import main as port_main
from ngsbits_tpu_torch.core.chromosome import Chromosome
from ngsbits_tpu_torch.core.intervals import BedFile
from ngsbits_tpu_torch.ops import KERNELS, selfcheck
from ngsbits_tpu_torch.ops import variants as vops
from ngsbits_tpu_torch.tools import roh_hunter
from ngsbits_tpu_torch.utils import synth

LENGTHS = {"chr1": 1_000_000, "chr2": 800_000, "chrX": 400_000}
SMALL = ("##fileformat=VCFv4.2\n"
         '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
         "{dp}"
         "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{samples}\n")
DP = '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Depth">\n'


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("roh_hunter")
    segments = synth.wgs_vcf(d / "wgs.vcf", LENGTHS, seed=81, n_roh=(5, 5),
                             roh_size=(100_000, 300_000))
    synth.roh_beds(d / "exclude.bed", [d / "genes.bed", d / "plain.bed"], LENGTHS, segments,
                   seed=82)
    rows = (d / "exclude.bed").read_text().splitlines()
    (d / "unsorted.bed").write_text("\n".join(rows[1:] + rows[:1]) + "\n")
    (d / "multi.vcf").write_text(SMALL.format(dp=DP, samples="a\tb")
                                 + "chr1\t5\t.\tA\tG\t50\tPASS\t.\tGT:DP\t1/1:30\t0/1:30\n")
    (d / "nodp.vcf").write_text(SMALL.format(dp="", samples="a")
                                + "chr1\t5\t.\tA\tG\t50\tPASS\t.\tGT\t1/1\n")
    (d / "noqual.vcf").write_text(SMALL.format(dp=DP, samples="a")
                                  + "chr1\t5\t.\tA\tG\t50\tPASS\t.\tGT:DP\t1/1:30\n"
                                  + "chr1\t9\t.\tA\tG\t.\tPASS\t.\tGT:DP\t1/1:30\n")
    for name, (af, at) in AF_VCFS.items():
        synth.roh_af_vcf(d / f"{name}.vcf", af, at, seed=87)
    return d


def _roh(*extra):
    return ["-in", "{d}/wgs.vcf", *extra]


EXCLUDE = ("-exclude", "{d}/exclude.bed")
# roh_af_vcf's files: (the AF written, its marker in the last run); the run's
# product of af² is 0 from its 310th marker at the latest
AF_VCFS = {"af_inf_after_0": ("inf", 450), "af_inf_before_0": ("inf", 5),
           "af_1e39": ("1e39", 450), "af_nan": ("nan", 450)}
CASES = {
    # name: (arguments, expected exit code)
    "defaults": (_roh(), 0),
    "var_af_keys": (_roh("-var_af_keys", "AF"), 0),
    "var_af_keys_vep": (_roh("-var_af_keys_vep", "gnomAD_AF,AF"), 0),
    "both af keys": (_roh("-var_af_keys", "AF", "-var_af_keys_vep", "AF"), 0),
    "af above 1": (_roh("-var_af_keys", "AF,QD"), 0),   # Q below 0: no region
    "exclude": (_roh("-var_af_keys", "AF", *EXCLUDE), 0),
    "exclude annotate": (_roh("-var_af_keys_vep", "gnomAD_AF,AF", *EXCLUDE, "-annotate",
                              "{d}/genes.bed", "{d}/plain.bed"), 0),
    "inc_chrx": (_roh("-var_af_keys", "AF", "-inc_chrx"), 0),
    "inc_chrx exclude": (_roh("-inc_chrx", *EXCLUDE), 0),
    "output filters": (_roh("-var_af_keys", "AF", "-roh_min_q", "60", "-roh_min_markers", "8",
                            "-roh_min_size", "5"), 0),
    "loose merges": (_roh("-var_af_keys", "AF", *EXCLUDE, "-ext_marker_perc", "10",
                          "-ext_size_perc", "90", "-ext_max_het_perc", "20",
                          "-roh_min_markers", "5", "-roh_min_size", "2"), 0),
    "no merges": (_roh("-ext_marker_perc", "0", "-ext_size_perc", "0", "-ext_max_het_perc",
                       "0", "-roh_min_markers", "3", "-roh_min_size", "1"), 0),
    "depth and quality": (_roh("-var_min_dp", "40", "-var_min_q", "120", "-roh_min_markers",
                               "5", "-roh_min_size", "2"), 0),
    "var_min_q 0 with QUAL .": (["-in", "{d}/noqual.vcf", "-var_min_q", "0"], 0),
    "two samples": (["-in", "{d}/multi.vcf"], 1),
    "no DP header": (["-in", "{d}/nodp.vcf"], 1),
    "QUAL .": (["-in", "{d}/noqual.vcf"], 1),
    "unsorted exclude": (_roh("-exclude", "{d}/unsorted.bed"), 1),
    "unknown VEP field": (_roh("-var_af_keys_vep", "gnomAD_AF,foo"), 1),
    "no CSQ": (["-in", "{d}/noqual.vcf", "-var_af_keys_vep", "AF", "-var_min_q", "0"], 1),
    # the last run's product: 0 then NaN (dropped, where 0 would print 10000),
    # +inf throughout (Q -inf: dropped), NaN, and as without the NaN AF
    **{f"af {af} at {at}": (["-in", f"{{d}}/{name}.vcf", "-var_af_keys", "AF"], 0)
       for name, (af, at) in AF_VCFS.items()},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_roh_hunter_matches_the_jax_package(inputs, tmp_path, monkeypatch, capsys, name):
    monkeypatch.setenv("NGSBITS_TORCH_DEVICE", "cpu")
    args, rc = CASES[name]
    got = []
    for label, run in (("jax", lambda a: execute("RohHunter", a)),
                       ("port", lambda a: port_main(["RohHunter", *a]))):
        out = tmp_path / f"{label}.tsv"
        assert run([a.format(d=inputs) for a in args] + ["-out", str(out)]) == rc
        err = [l for l in capsys.readouterr().err.splitlines() if l.startswith("Exception")]
        got.append((out.read_text() if out.exists() else None, err))
    assert got[0] == got[1]
    text, err = got[1]
    if rc:
        assert err and text is None
        return
    assert text.startswith("#chr\tstart\tend\tnumber of markers")
    if name not in ("var_min_q 0 with QUAL .", "af above 1"):
        assert len(text.splitlines()) > 3


def _runs(tmp_path, args):
    assert port_main(["RohHunter", *args, "-out", str(tmp_path / "o.tsv")]) == 0
    return [l.split("\t") for l in (tmp_path / "o.tsv").read_text().splitlines()[1:]]


def test_the_exclude_bed_breaks_runs_and_refuses_merges(inputs, tmp_path, monkeypatch):
    """With the exclude BED some neighbouring homozygous markers are split
    by a gap (the device's second query finds overlaps), some merge is
    refused by the host's ``matching_index`` (a hit while merging), and no
    region overlaps a gap; without it some region spans a gap."""
    monkeypatch.setenv("NGSBITS_TORCH_DEVICE", "cpu")
    from ngsbits_tpu_torch.core.intervals import ChromosomalIndex
    hits = {"gaps": [], "merges": 0}
    overlaps = roh_hunter.DeviceExclude.overlaps
    matching = ChromosomalIndex.matching_index

    def spy_overlaps(self, *a):
        got = overlaps(self, *a)
        hits["gaps"].append(int(got.sum()))
        return got

    def spy_matching(self, *a):
        got = matching(self, *a)
        hits["merges"] += got != -1
        return got

    monkeypatch.setattr(roh_hunter.DeviceExclude, "overlaps", spy_overlaps)
    monkeypatch.setattr(ChromosomalIndex, "matching_index", spy_matching)
    loose = ["-in", str(inputs / "wgs.vcf"), "-var_af_keys", "AF", "-roh_min_markers", "5",
             "-roh_min_size", "2", "-ext_marker_perc", "10", "-ext_size_perc", "90"]
    without = _runs(tmp_path, loose)
    with_ex = _runs(tmp_path, loose + ["-exclude", str(inputs / "exclude.bed")])
    assert len(hits["gaps"]) == 2 and hits["gaps"][1] > 0 and hits["merges"] > 0
    gaps = BedFile.from_file(str(inputs / "exclude.bed"))
    crossed = [r for r in without
               if any(g.chr.str == r[0] and int(r[1]) < g.start and g.end < int(r[2])
                      for g in gaps.lines)]
    assert crossed and with_ex != without
    assert not [r for r in with_ex
                if any(g.chr.str == r[0] and int(r[1]) <= g.end and g.start <= int(r[2])
                       for g in gaps.lines)]


def test_device_exclude_matches_the_jax_index(inputs):
    """``DeviceExclude.overlaps`` against ``ChromosomalIndex.matching_index
    != -1`` on the unmerged exclude BED, at random closed intervals, at the
    regions' own ends and one past them, on a chromosome without regions."""
    bed = BedFile.from_file(str(inputs / "exclude.bed"))
    jax_index = JaxIndex(JaxBed.from_file(str(inputs / "exclude.bed")))
    from ngsbits_tpu.core.chromosome import Chromosome as JaxChromosome
    rng = np.random.default_rng(83)
    names = list(LENGTHS) + ["chr7"]
    chrom = rng.integers(0, len(names), size=3000)
    start = rng.integers(1, 1_000_000, size=3000)
    end = start + rng.integers(0, 3000, size=3000)
    edges = [(names.index(l.chr.str), p, p + w) for l in bed.lines
             for p in (l.start - 1, l.start, l.end, l.end + 1) for w in (0, 5)]
    chrom = np.concatenate([chrom, [e[0] for e in edges]])
    start = np.concatenate([start, [e[1] for e in edges]])
    end = np.concatenate([end, [e[2] for e in edges]])
    dex = roh_hunter.DeviceExclude(bed, torch.device("cpu"))
    nums = torch.tensor([Chromosome(names[c]).num for c in chrom])
    got = dex.overlaps(nums, torch.from_numpy(start), torch.from_numpy(end)).tolist()
    want = [jax_index.matching_index(JaxChromosome(names[c]), int(s), int(e)) != -1
            for c, s, e in zip(chrom, start, end)]
    assert got == want and any(want) and not all(want)
    empty = roh_hunter.DeviceExclude(BedFile(), torch.device("cpu"))
    assert not empty.overlaps(nums[:3], torch.from_numpy(start[:3]),
                              torch.from_numpy(end[:3])).any()


def _host_product(af, s, e) -> float:
    p = 1.0
    for i in range(s, e + 1):
        p *= float(af[i]) ** 2
    return p


@pytest.mark.parametrize("inputs_name", ["edges", "run-like"])
def test_h1_plain_is_the_host_product_bit_for_bit(inputs_name):
    if inputs_name == "edges":
        af, ranges = selfcheck.roh_edge_inputs(seed=84)
    else:  # float32 values of every exponent a run meets, long ranges
        rng = np.random.default_rng(85)
        af = np.maximum(rng.beta(0.6, 2.5, size=40_000), 0.01).astype(np.float32)
        af = af.astype(np.float64)
        starts = np.sort(rng.integers(0, 39_000, size=200))
        ranges = np.stack([starts, np.minimum(starts + rng.integers(0, 3000, size=200),
                                              39_999)], 1)
    out = torch.zeros(len(ranges), dtype=torch.float64)
    before = vops.roh_products_into.launches
    vops.roh_products_into(torch.from_numpy(af), torch.from_numpy(ranges), out)
    assert vops.roh_products_into.launches == before
    m = len(af)
    for (s, e), p in zip(ranges.tolist(), out.tolist()):
        if s < 0 or e >= m:
            assert p != p
            continue
        assert p == _host_product(af, s, e) or (p == 0 and _host_product(af, s, e) == 0)
        var_info = [jax_roh._Var(None, 0, True, float(a)) for a in af[max(s, 0):e + 1]]
        region = jax_roh._Roh(None, 0, 0, 0, e - s) if s <= e else None
        if region is not None:
            assert roh_hunter._q_score(p) == region.q_score(var_info)


def _same(p: float, q: float) -> bool:
    return p == q or (p != p and q != q)


@pytest.mark.parametrize("inputs_name", ["exit edges", "card edges"])
def test_h1_plain_at_the_exit_edges_is_the_host_product(inputs_name):
    """At the edges of H1's early exit (products that reach 0 or +inf and
    then meet a +inf, 0 or NaN square at every place the exit cares for,
    NaN af with payloads and signs, -0.0 and -inf, 4,000 markers at af 1.0)
    and at the card's edges (``roh_cases``: those joined with
    ``roh_edge_inputs``, ranges outside the joined array), the plain
    version equals the host's ``p *= float(af) ** 2``, any two NaNs equal
    (their payloads are the card's to decide, and chip_smoke.py holds the
    kernel's bits against the plain version's there)."""
    if inputs_name == "exit edges":
        af, ranges = selfcheck.roh_exit_edges(seed=88)
        af_t, ranges_t = torch.from_numpy(af), torch.from_numpy(ranges)
    else:
        _, case = selfcheck.roh_cases(torch.device("cpu"), seed=88)[0]
        af_t, ranges_t = case.inputs
        af, ranges = af_t.numpy(), ranges_t.numpy()
    out = torch.zeros(len(ranges), dtype=torch.float64)
    vops.roh_products_into(af_t, ranges_t, out)
    m, got = len(af), out.tolist()
    for (s, e), p in zip(ranges.tolist(), got):
        if s < 0 or e >= m:
            assert p != p
        else:
            assert _same(p, _host_product(af, s, e)), (s, e)
    kinds = {"0": sum(p == 0 for p in got), "inf": sum(p == float("inf") for p in got),
             "nan": sum(p != p for p in got), "1": sum(p == 1 for p in got)}
    assert all(kinds.values()), kinds
    if inputs_name == "exit edges":  # each late +inf or NaN turns a 0 into NaN
        for r in range(8):
            assert got[3 * r] != got[3 * r] and got[3 * r + 1] == 0


def test_roh_chain_is_the_longest_walk_to_an_exit():
    """``selfcheck.roh_chain`` against a walk of every range: the longest
    range, and the most multiplies before the product leaves the positive
    finite numbers (a range's length where it never does)."""
    for seed in (89, 90):
        af, ranges = selfcheck.roh_exit_edges(seed)
        rng = np.random.default_rng(seed)
        ranges = np.concatenate([ranges, np.array([(-1, 4), (7, 6), (len(af) - 1, len(af))]),
                                 np.sort(rng.integers(0, len(af), size=(200, 2)), axis=1)])
        longest = chain = 0
        for s, e in ranges.tolist():
            if s < 0 or e >= len(af) or e < s:
                continue
            longest = max(longest, e - s + 1)
            p, n = 1.0, 0
            for i in range(s, e + 1):
                p *= float(af[i]) ** 2
                n += 1
                if not 0 < p < float("inf"):
                    break
            chain = max(chain, n)
        assert selfcheck.roh_chain(af, ranges) == {"longest_range": longest,
                                                   "longest_chain": chain}
    assert selfcheck.roh_chain(np.ones(3), np.zeros((0, 2), dtype=np.int64)) == {
        "longest_range": 0, "longest_chain": 0}


def test_h1_squares_every_float32_exactly():
    """The host's ``float(af) ** 2`` (pow) equals af * af for float32 values
    across their exponents, so H1's ``__dmul_rn(a, a)`` is the host's."""
    rng = np.random.default_rng(86)
    bits = rng.integers(0, 0x7F800000, size=200_000, dtype=np.int64).astype(np.uint32)
    x = bits.view(np.float32).astype(np.float64)
    assert all(float(v) ** 2 == v * v for v in x.tolist())


def test_roh_hunter_seconds_and_launches(inputs, tmp_path, monkeypatch):
    """The tool's stages; on the CPU route H1's plain version runs twice
    (the raw runs, the final regions) and no kernel is launched."""
    monkeypatch.setenv("NGSBITS_TORCH_DEVICE", "cpu")
    from ngsbits_tpu_torch.tools import get_tool
    calls = []
    real = vops.roh_products_plain
    monkeypatch.setattr(vops, "roh_products_plain", lambda *a: calls.append(a[1].shape[0])
                        or real(*a))
    before = {k.__name__: k.launches for k in KERNELS}
    tool = get_tool("RohHunter")()
    assert tool.execute(["-in", str(inputs / "wgs.vcf"), "-exclude", str(inputs / "exclude.bed"),
                         "-out", str(tmp_path / "o.tsv")]) == 0
    assert set(tool.seconds) == {"parse", "pack", "kernel", "host"}
    assert len(calls) == 2 and calls[0] > calls[1] > 0
    assert {k.__name__: k.launches for k in KERNELS} == before
