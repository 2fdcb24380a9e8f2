"""The port's VariantQC on its CPU route against the JAX package's tool (its
host loops, JAX_PLATFORMS=cpu) on the same seeded VCFs: qcML (without its
``creation `` lines), TXT, ``-ignore_filter``, ``-long_read`` with
``-phasing_bed`` and STDOUT byte-identical, and the same exit code and
message where the tool refuses its input. V1's plain version
(``ops/variants.py::variant_classify_plain``) against the JAX package's
record loops (``ngsbits_tpu/qc/variant_stats.py:49-165``, through its own
accessors) at every selfcheck edge, on random records and on the seam
records (``selfcheck.variant_seams``: each pattern, key and field at every
offset of a 16-byte chunk and across the kernel's 512-byte steps), counts
equal.
F15 pinned: ``-long_read`` on a VCF whose passing records carry no phase
block fails as in the JAX package, and a record whose FORMAT has no PS
counts as phased with the block id ``""``.

Inputs (numpy seeds): ``synth.wgs_vcf`` at a small scale (three chromosomes
of 0.2-0.4 Mb, about 1,300 records), ``selfcheck.VARIANT_EDGES`` written as
a VCF, ``synth.synth_vcfs`` (no CSQ or RS), a header-only VCF, a two-sample
VCF, a VCF of unphased records and one without PS keys."""

import numpy as np
import pytest
import torch

from ngsbits_tpu.io.vcf import VcfFile as JaxVcf

from helpers import execute
from ngsbits_tpu_torch.__main__ import main as port_main
from ngsbits_tpu_torch.ops import KERNELS, selfcheck
from ngsbits_tpu_torch.ops import variants as vops
from ngsbits_tpu_torch.utils import synth

LENGTHS = {"chr1": 400_000, "chr2": 300_000, "chrX": 200_000}
HEADER = ("##fileformat=VCFv4.2\n"
          '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
          '##FORMAT=<ID=PS,Number=1,Type=Integer,Description="Phase set">\n'
          "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{samples}\n")


def _vcf(path, rows, samples="s1"):
    path.write_text(HEADER.format(samples=samples) + "".join(r + "\n" for r in rows))
    return path


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("variant_qc")
    synth.wgs_vcf(d / "wgs.vcf", LENGTHS, seed=71, n_roh=(2, 3), roh_size=(50_000, 120_000))
    rows = [f"chr1\t{100 + i}\t.\t{r.decode()}\t{a.decode()}\t50\t{f.decode()}\t{info.decode()}"
            f"\t{fk.decode()}\t{s.decode()}"
            for i, (r, a, f, info, fk, s) in enumerate(selfcheck.VARIANT_EDGES)]
    _vcf(d / "edges.vcf", rows)
    synth.synth_vcfs([d / "plain.vcf"], 300, seed=72, lengths={"chr1": 300_000})
    _vcf(d / "empty.vcf", [])
    _vcf(d / "multi.vcf", ["chr1\t5\t.\tA\tG\t50\tPASS\t.\tGT\t0/1\t1/1"], samples="s1\ts2")
    _vcf(d / "unphased.vcf", [f"chr1\t{10 + i}\t.\tA\tG\t50\tPASS\t.\tGT:PS\t0/1:."
                              for i in range(5)] + ["chr1\t90\t.\tA\tG\t50\tlow\t.\tGT:PS\t0|1:7"])
    _vcf(d / "nops.vcf", [f"chr1\t{10 * i + 1}\t.\tAC\tA\t50\tPASS\t.\t{fk}\t{gt}"
                          for i, (fk, gt) in enumerate([("GT", "0/1"), ("GT:PS", "0|1:11"),
                                                        ("GT:PS", "1|1:11"), ("GT", "1/1"),
                                                        ("GT", "0/1"), ("GT:PS", "1|0:.")])])
    # FORMAT but no sample column: the accessors raise where the loops read GT or PS
    (d / "nosample.vcf").write_text(HEADER.format(samples="").replace("\tFORMAT\t\n", "\tFORMAT\n")
                                    + "chr1\t5\t.\tA\tG\t50\tPASS\t.\tGT\n")
    (d / "nosample_ps.vcf").write_text(HEADER.format(samples="").replace("\tFORMAT\t\n",
                                                                         "\tFORMAT\n")
                                       + "chr1\t5\t.\tA\tG\t50\tPASS\t.\tPS\n")
    return d


def _qc(vcf, *extra):
    return ["-in", f"{{d}}/{vcf}", *extra]


CASES = {
    # name: (arguments, outputs written, expected exit code)
    "qcML": (_qc("wgs.vcf"), ("out.qcML",), 0),
    "txt": (_qc("wgs.vcf", "-txt"), ("out.txt",), 0),
    "ignore_filter txt": (_qc("wgs.vcf", "-ignore_filter", "-txt"), ("out.txt",), 0),
    "ignore_filter qcML": (_qc("wgs.vcf", "-ignore_filter"), ("out.qcML",), 0),
    "long_read phasing_bed": (_qc("wgs.vcf", "-long_read", "-phasing_bed", "{o}/blocks.bed"),
                              ("out.qcML", "blocks.bed"), 0),
    "long_read ignore_filter txt": (_qc("wgs.vcf", "-long_read", "-ignore_filter", "-txt",
                                        "-phasing_bed", "{o}/blocks.bed"),
                                    ("out.txt", "blocks.bed"), 0),
    "edges txt": (_qc("edges.vcf", "-txt"), ("out.txt",), 0),
    "edges ignore_filter": (_qc("edges.vcf", "-ignore_filter"), ("out.qcML",), 0),
    "no CSQ or RS": (_qc("plain.vcf", "-txt"), ("out.txt",), 0),
    "no records": (_qc("empty.vcf", "-txt"), ("out.txt",), 0),
    "no records qcML": (_qc("empty.vcf"), ("out.qcML",), 0),
    "two samples": (_qc("multi.vcf"), ("out.qcML",), 1),
    "no sample column, GT": (_qc("nosample.vcf", "-txt"), ("out.txt",), 1),
    "no sample column, PS": (_qc("nosample_ps.vcf", "-long_read", "-txt"), ("out.txt",), 1),
    "F15 no phase block": (_qc("unphased.vcf", "-long_read", "-txt"), ("out.txt",), 1),
    "F15 no PS key": (_qc("nops.vcf", "-long_read", "-txt", "-phasing_bed", "{o}/blocks.bed"),
                      ("out.txt", "blocks.bed"), 0),
}


def _strip(text: str) -> str:
    return "".join(l for l in text.splitlines(True) if "creation " not in l)


@pytest.mark.parametrize("name", sorted(CASES))
def test_variant_qc_matches_the_jax_package(inputs, tmp_path, monkeypatch, capsys, name):
    monkeypatch.setenv("NGSBITS_TORCH_DEVICE", "cpu")
    args, outputs, rc = CASES[name]
    got = []
    for label, run in (("jax", lambda a: execute("VariantQC", a)),
                       ("port", lambda a: port_main(["VariantQC", *a]))):
        o = tmp_path / label
        o.mkdir()
        argv = [a.format(d=inputs, o=o) for a in args] + ["-out", str(o / outputs[0])]
        assert run(argv) == rc
        err = [l for l in capsys.readouterr().err.splitlines() if l.startswith("Exception")]
        got.append(([_strip((o / n).read_text()) if (o / n).exists() else None
                     for n in outputs], err))
    assert got[0] == got[1]
    texts, err = got[1]
    if rc:
        assert err and not texts[0]
        if name.startswith("F15"):
            assert err == ["Exception: index -1 is out of bounds for axis 0 with size 0"]
        if name.startswith("no sample column"):
            assert err == ["Exception: list index out of range"]
        return
    assert "variant count" in texts[0]
    if name == "F15 no PS key":
        # GT-only records have the block id "" and count as phased (F15)
        assert texts[1].splitlines() == ["chr1\t0\t2\t", "chr1\t10\t22\t11", "chr1\t30\t42\t"]
        assert "phasing block count: 3" in texts[0]


@pytest.mark.parametrize("txt", [False, True])
def test_variant_qc_to_stdout_matches_the_jax_package(inputs, monkeypatch, capsys, txt):
    monkeypatch.setenv("NGSBITS_TORCH_DEVICE", "cpu")
    args = ["-in", str(inputs / "wgs.vcf"), "-long_read", *(["-txt"] if txt else [])]
    assert execute("VariantQC", args) == 0
    want = capsys.readouterr().out
    assert port_main(["VariantQC", *args]) == 0
    got = capsys.readouterr().out
    assert ("variant count: " if txt else 'name="variant count"') in got
    assert _strip(got) == _strip(want)


def _jax_counts(cols, filter_: bool) -> dict:
    """The nine counts as the JAX package's record loops make them, through
    its own ``VcfLineView`` on the same fields."""
    f = JaxVcf()
    n = len(cols[0])
    f.chr_strs, f.pos, f.ids, f.quals = [b"chr1"] * n, np.arange(1, n + 1), [b"."] * n, [b"."] * n
    f.refs, f.alts, f.filters, f.infos, f.format_keys = (list(c) for c in cols[:5])
    f.samples = [[s] for s in cols[5]]
    c = dict.fromkeys(vops.COUNTERS, 0)
    for i in range(n):
        v = f[i]
        if filter_ and not v.filters_passed():
            c["mosaic"] += b"mosaic" in v.filters
            continue
        c["passing"] += 1
        csq = v.info("CSQ")
        c["known"] += b"|rs" in csq or v.info("RS").startswith(b"rs")
        c["high"] += b"|HIGH|" in csq
        gt = v.format_value("GT")
        c["hom"] += gt in (b"1/1", b"1|1")
        c["het"] += gt in (b"0/1", b"1/0", b"0|1", b"1|0")
        ref, alt0 = v.ref, v.alt(0)
        if (len(alt0) > 1 and len(ref) == 1) or (len(alt0) == 1 and len(ref) > 1):
            c["indel"] += 1
        elif (alt0, ref) in ((b"A", b"G"), (b"G", b"A"), (b"T", b"C"), (b"C", b"T")):
            c["ti"] += 1
        else:
            c["tv"] += 1
    return c


V1_INPUTS = {"edges": selfcheck.variant_edge_columns,
             "no records": lambda: [[] for _ in range(6)],
             "random records": lambda: selfcheck.variant_fuzz(6_000, seed=73),
             "seams": selfcheck.variant_seams}


@pytest.mark.parametrize("filter_", [True, False])
@pytest.mark.parametrize("inputs_name", sorted(V1_INPUTS))
def test_v1_plain_matches_the_jax_record_loops(inputs_name, filter_):
    cols = V1_INPUTS[inputs_name]()
    data, offsets = vops.pack_fields(cols)
    assert data.shape[0] % vops.ALIGN == 0 and data.shape[0] >= int(offsets[-1])
    out = torch.zeros(len(vops.COUNTERS), dtype=torch.int64)
    before = vops.variant_classify_into.launches
    vops.variant_classify_into(data, offsets, filter_, out)
    assert vops.variant_classify_into.launches == before  # the CPU route launches nothing
    assert dict(zip(vops.COUNTERS, out.tolist())) == _jax_counts(cols, filter_)


@pytest.mark.parametrize("filter_", [True, False])
@pytest.mark.parametrize("kind", [*selfcheck.SEAM_KINDS, "long INFO", "long FORMAT"])
def test_v1_plain_matches_the_jax_record_loops_at_the_seams(kind, filter_):
    """V1's plain version against the JAX package's record loops on the
    records whose feature lies at each offset of a 16-byte chunk and across
    the 512-byte step in which the kernel reads a record, on INFOs of 511,
    512, 513 and 1,025 bytes, and on FORMATs and samples longer than the 64
    bytes of them the kernel copies a record."""
    cols = selfcheck.variant_seams(kind)
    data, offsets = vops.pack_fields(cols)
    out = torch.zeros(len(vops.COUNTERS), dtype=torch.int64)
    vops.variant_classify_into(data, offsets, filter_, out)
    want = _jax_counts(cols, filter_)
    assert dict(zip(vops.COUNTERS, out.tolist())) == want
    assert want["passing"] > 0


def _feature_at(kind: str, rec: tuple) -> int:
    """Where in the record the seam feature of ``kind`` starts."""
    ref, alt, _, info, fmt, sample = rec
    head = len(ref) + len(alt) + len(rec[2])
    if kind == "ALT ,":
        return len(ref) + alt.index(b",")
    if kind == "GT key":
        return head + len(info) + (b":" + fmt).index(b":GT:")
    if kind == "GT value":
        return head + len(info) + len(fmt) + sample.index(b":") + 1
    pattern = {"CSQ value end": b";Z="}.get(kind, kind.encode())
    return head + info.index(pattern)


@pytest.mark.parametrize("kind", selfcheck.SEAM_KINDS)
def test_v1_seams_put_each_feature_at_each_offset(kind):
    """Each seam kind's feature lies at every one of ``SEAM_OFFSETS`` from the
    16-byte chunk that holds its record's first byte, its record starting at
    each of ``SEAM_ALIGNS`` in that chunk (a leading record puts it there)."""
    recs = list(zip(*selfcheck.variant_seams(kind)))
    at, seen, aligns = 0, set(), set()
    for i, rec in enumerate(recs):
        if i % 2:
            aligns.add(at % 16)
            seen.add(at % 16 + _feature_at(kind, rec))
        at += sum(map(len, rec))
    assert aligns == set(selfcheck.SEAM_ALIGNS)
    assert seen == set(selfcheck.SEAM_OFFSETS)


def _needed_bytes(cols, filter_: bool) -> tuple[int, int]:
    """``selfcheck.variant_needed_bytes`` walked a record at a time with
    bytes methods."""
    total = counted = 0
    for ref, alt, filt, info, fmt, sample in zip(*cols):
        total += len(filt) if filter_ else 0
        if filter_ and filt not in (b"", b".", b"PASS"):
            continue
        counted += 1
        alt0 = alt.split(b",")[0]
        total += min(len(alt0) + 1, len(alt)) + (len(ref) == 1 and len(alt0) == 1)
        ends, at = {}, 0
        for entry in info.split(b";"):
            ends.setdefault(entry.split(b"=")[0], at + len(entry))
            at += len(entry) + 1
        total += (min(max(ends[b"CSQ"], ends[b"RS"]) + 1, len(info))
                  if b"CSQ" in ends and b"RS" in ends else len(info))
        keys = fmt.split(b":") if fmt else []
        if b"GT" not in keys:
            total += len(fmt)
            continue
        gi = keys.index(b"GT")
        total += min(sum(len(k) + 1 for k in keys[:gi]) + 3, len(fmt))
        vals = sample.split(b":")
        if gi >= len(vals):
            total += len(sample)
            continue
        gs = sum(len(v) + 1 for v in vals[:gi])
        total += gs + min(len(vals[gi]) + (gs + len(vals[gi]) < len(sample)), 4)
    return total, counted


@pytest.mark.parametrize("filter_", [True, False])
@pytest.mark.parametrize("inputs_name", sorted(V1_INPUTS))
def test_v1_needed_bytes_match_a_record_walk(inputs_name, filter_):
    """V1's bound counts the field bytes its counts need, no more."""
    cols = V1_INPUTS[inputs_name]()
    data, offsets = vops.pack_fields(cols)
    want = _needed_bytes(cols, filter_)
    assert selfcheck.variant_needed_bytes(data, offsets, filter_) == want
    if cols[0]:
        assert want[0] < int(offsets[-1])


def test_v1_edges_cover_each_count():
    """Every count is hit by the edges and missed by some of them."""
    cols = selfcheck.variant_edge_columns()
    want = _jax_counts(cols, True)
    assert all(0 < want[k] < len(cols[0]) for k in vops.COUNTERS)
    assert max(len(i) for i in cols[3]) > 64 * 1024


def test_v1_refuses_what_the_kernel_does_not_take():
    data, offsets = vops.pack_fields(selfcheck.variant_edge_columns())
    out = torch.zeros(len(vops.COUNTERS), dtype=torch.int64)
    with pytest.raises(ValueError, match="multiple of 16"):
        vops.variant_classify_into(data[:-1], offsets, True, out)
    with pytest.raises(TypeError):
        vops.variant_classify_into(data, offsets.to(torch.int32), True, out)
    with pytest.raises(ValueError, match="6n"):
        vops.variant_classify_into(data, offsets[:-1], True, out)
    with pytest.raises(ValueError):
        vops.variant_classify_into(data, offsets, True, out[:8])


def test_variant_qc_seconds_and_launches(inputs, tmp_path, monkeypatch):
    """The tool's stages, one record pass for both engines, and on the CPU
    route no kernel launched."""
    monkeypatch.setenv("NGSBITS_TORCH_DEVICE", "cpu")
    from ngsbits_tpu_torch.tools import get_tool
    calls = []
    real = vops.variant_classify_plain
    monkeypatch.setattr(vops, "variant_classify_plain", lambda *a: calls.append(1) or real(*a))
    before = {k.__name__: k.launches for k in KERNELS}
    tool = get_tool("VariantQC")()
    assert tool.execute(["-in", str(inputs / "wgs.vcf"), "-long_read", "-out",
                         str(tmp_path / "o.qcML")]) == 0
    assert set(tool.seconds) == {"parse", "pack", "kernel", "host"}
    assert calls == [1]
    assert {k.__name__: k.launches for k in KERNELS} == before
