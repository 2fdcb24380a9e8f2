"""B1's region form and the variant-details path on the CPU:
``pileup_regions_plain`` (through ``DeviceRegions``, ``get_indels`` and
``variant_details``) against the JAX package's
``ngsbits_tpu/qc/variant_details.py::get_indels`` (its host filter and CIGAR
walk) and ``variant_details`` on the same BAM files: seeded record batches
(``selfcheck.REGION_EDGES``' records, written with ``utils/synth.py::
write_bam``: every CIGAR op, an I and a D op at one g, records of no
reference span, MAPQ 0, filtered records, mate pairs sharing a name) over
``selfcheck.indel_regions`` (random, long, overlapping, repeated, at records'
spans, under long N ops, on a chromosome the BAM lacks), and a synthetic BAM
with germline SNVs and indels (``utils/synth.py``), with and without
``include_not_properly_paired`` and ``count_fragments``. Records without
SEQ that hold an I op are kept out of the parity inputs (``ROADMAP.md`` F13:
the JAX package keys such an insertion with the next record's bases;
``test_an_insertion_past_its_records_seq_...`` shows it). Indel lists and
depths: exact equality; MAPQ-0 shares and frequencies: the same float to
the last bit, or NaN on both sides."""

import math

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ngsbits_tpu.core.chromosome import Chromosome as JaxChromosome  # noqa: E402
from ngsbits_tpu.io.fasta import FastaFileIndex as JaxFasta  # noqa: E402
from ngsbits_tpu.qc import variant_details as jax_vd  # noqa: E402

from ngsbits_tpu_torch.core.chromosome import Chromosome  # noqa: E402
from ngsbits_tpu_torch.io.bam import BamBatch  # noqa: E402
from ngsbits_tpu_torch.io.fasta import FastaFileIndex  # noqa: E402
from ngsbits_tpu_torch.ops import device_reduce as dr  # noqa: E402
from ngsbits_tpu_torch.ops import selfcheck  # noqa: E402
from ngsbits_tpu_torch.qc import pileup as port_pileup  # noqa: E402
from ngsbits_tpu_torch.qc import variant_details as port_vd  # noqa: E402
from ngsbits_tpu_torch.utils import synth  # noqa: E402

REFS = ["chr1", "chr2", "chr3"]
LENGTHS = {"chr1": 260_000, "chr2": 260_000, "chr3": 100_000}
CODES = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6, "=": 7, "X": 8}
NIBBLE = {ord("A"): 1, ord("C"): 2, ord("G"): 4, ord("T"): 8, ord("N"): 15}


@pytest.fixture(autouse=True)
def _cpu_route(monkeypatch):
    monkeypatch.setenv("NGSBITS_TORCH_DEVICE", "cpu")


def _subset(cols: dict, keep: np.ndarray) -> dict:
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
    """The batch less its records without SEQ that hold an I op (F13)."""
    op = cols["cigar"] & 0xF
    rec_of = np.repeat(np.arange(len(cols["pos"])), np.diff(cols["cigar_off"]))
    has_i = np.bincount(rec_of[op == 1], minlength=len(cols["pos"])) > 0
    return _subset(cols, ~(has_i & (cols["l_seq"] == 0)))


def _batch(cols: dict) -> BamBatch:
    """The columns as a batch whose mates share a name (``r0``, ``r0``,
    ``r1``, ...), for the fragment route."""
    n = len(cols["pos"])
    z = np.zeros(n, np.int32)
    names = [b"r%d" % (i // 2) for i in range(n)]
    name_off = np.concatenate(([0], np.cumsum([len(x) for x in names]))).astype(np.int64)
    return BamBatch(ref_id=cols["ref_id"], pos=cols["pos"], flag=cols["flag"],
                    mapq=cols["mapq"], l_seq=cols["l_seq"], n_cigar=cols["n_cigar"], tlen=z,
                    mate_ref_id=z, mate_pos=z, cigar=cols["cigar"].astype(np.uint32),
                    cigar_off=cols["cigar_off"], seq=cols["seq"], qual=cols["qual"],
                    seq_off=cols["seq_off"], names=b"".join(names), name_off=name_off,
                    tags=np.zeros(0, np.uint8), tags_off=np.zeros(n + 1, np.int64))


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("regions")
    synth.synth_genome(d / "g.fa", LENGTHS, seed=401)
    return d


@pytest.fixture(scope="module")
def edges(genome):
    """Each of ``REGION_EDGES``' batches as a BAM (two batches of it, the
    second 30,000 bases on), and its regions."""
    out = {}
    for k, label in enumerate(sorted(selfcheck.REGION_EDGES)):
        cols, chrs, starts, ends, refs = selfcheck.region_edge_columns(
            label, _without_seqless_insertions)
        later = dict(cols, pos=cols["pos"] + 30_000)
        path = genome / f"edges{k}.bam"
        # past the three chromosomes of the genome, references without records
        names = REFS + [f"chr{i}" for i in range(len(REFS) + 1, refs + 1)]
        lengths = list(LENGTHS.values()) + [100_000] * (len(names) - len(REFS))
        synth.write_bam(path, names, lengths, [_batch(cols), _batch(later)])
        out[label] = (path, chrs, starts, ends)
    return out


def _regions(chrs, starts, ends, cls):
    return [(cls(f"chr{c}"), int(s), int(e)) for c, s, e in zip(chrs, starts, ends)]


def _same_float(a: float, b: float) -> bool:
    return (math.isnan(a) and math.isnan(b)) or a == b


def _assert_same_regions(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.indels == w.indels, k
        assert g.depth == w.depth, k
        assert _same_float(g.mapq0_frac, w.mapq0_frac), k


@pytest.mark.parametrize("fragments", [False, True], ids=["reads", "fragments"])
@pytest.mark.parametrize("npp", [False, True], ids=["proper pairs", "not properly paired"])
@pytest.mark.parametrize("label", sorted(selfcheck.REGION_EDGES))
def test_get_indels_matches_the_jax_package_at_the_edges(genome, edges, label, npp, fragments):
    """``get_indels`` (one sweep, B1's region form; the name dedup on the
    host with ``count_fragments``) against the JAX package's: each region's
    indel list in order, depth and MAPQ-0 share."""
    path, chrs, starts, ends = edges[label]
    want = jax_vd.get_indels(str(path), _regions(chrs, starts, ends, JaxChromosome),
                             JaxFasta(str(genome / "g.fa")), npp, fragments)
    got = port_vd.get_indels(str(path), _regions(chrs, starts, ends, Chromosome),
                             FastaFileIndex(str(genome / "g.fa")), npp, fragments)
    _assert_same_regions(got, want)
    assert sum(len(r.indels) for r in want) > 50
    assert sum(r.depth > 0 for r in want) > 20
    assert any(math.isnan(r.mapq0_frac) for r in want)
    assert any(r.mapq0_frac > 0 for r in want)


def test_regions_repeat_overlap_and_lie_off_the_bam(edges):
    """What the edge regions hold: repeated regions, overlapping ones,
    regions of hundreds of bases, regions on a chromosome the BAM lacks,
    deletions and insertions keyed, and an I and a D op at one g."""
    path, chrs, starts, ends = edges["sorted, three chromosomes, one without regions"]
    keys = chrs * (1 << 40) + starts * (1 << 20) + ends
    assert len(np.unique(keys)) < len(keys)
    assert (ends - starts).max() >= 100 and (chrs > 3).sum() == 20
    order = np.lexsort((starts, chrs))
    assert (starts[order][1:] <= ends[order][:-1]).any()
    cols = selfcheck.alignment_records(**selfcheck.REGION_EDGES[
        "sorted, three chromosomes, one without regions"][0])
    words = cols["cigar"] & 0xF
    ins_then_del = (words[:-1] == 1) & (words[1:] == 2)
    same_record = np.diff(np.repeat(np.arange(len(cols["pos"])), np.diff(cols["cigar_off"]))) == 0
    assert (ins_then_del & same_record).any()


@pytest.mark.parametrize("label", sorted(selfcheck.REGION_EDGES))
def test_the_wrapper_on_the_cpu_route_gives_the_plain_versions_counters_and_hits(label):
    rec, eng, capacity, regions_range = selfcheck.region_edge_inputs(label, torch.device("cpu"))
    case = selfcheck.pileup_regions_case(rec, eng.regions, eng.table, capacity, regions_range)
    case.kernel()
    case.plain()
    assert selfcheck.max_abs_err(case) == 0
    (counters, hits), _ = case.outputs()
    assert hits.shape[0] > 100 and int(counters[0].sum()) > int(counters[2].sum()) > 0
    if "N ops" in label:  # spanning reads whose N op covers a region come off its depth
        pairs, spans, _ = dr.pileup_region_pairs(rec, eng.regions, eng.table)
        assert (pairs[:, 3][spans] < 1).sum() > 100


@pytest.mark.parametrize("label", sorted(selfcheck.REGION_EDGES))
def test_the_pre_filter_keeps_every_record_that_overlaps_a_region(label):
    """``DeviceRegions.reaching``: the pairs and hits of the records it
    keeps are those of every record; it drops some records."""
    cols, chrs, starts, ends, refs = selfcheck.region_edge_columns(label)
    eng = dr.DeviceRegions(chrs, starts, ends, np.arange(1, refs + 1), device="cpu")
    keys = selfcheck.pileup_keys(cols, True)
    reach, _ = eng.reaching(cols["pos"], selfcheck.record_ends(cols), keys)
    got = []
    for batch in (cols, _subset(cols, reach)):
        k = keys if batch is cols else keys[reach]
        rec = dr.upload_records(batch["pos"], k, batch["cigar_off"], batch["cigar"],
                                mapq=batch["mapq"], device="cpu")
        pairs, _, hits = dr.pileup_region_pairs(rec, eng.regions, eng.table)
        # records renumbered: compare by each record's key, position and CIGAR
        at_rec = np.stack([batch["pos"], k])
        got.append((sorted(map(tuple, np.concatenate([at_rec[:, pairs[:, 0]].T,
                                                      pairs[:, 1:].numpy()], 1).tolist())),
                    sorted(map(tuple, np.concatenate([at_rec[:, hits[:, 0]].T,
                                                      hits[:, [1, 2, 4]].numpy()],
                                                     1).tolist()))))
    assert got[0] == got[1] and len(got[0][1]) > 50
    if "pile" not in label:
        assert not reach.all()


def _chunks(label: str):
    """``REGION_EDGES[label]``'s engine (on the CPU) and its records in four
    chunks by index, as a sweep's batches (of a coordinate-sorted file:
    stretches of the reference), each with its regions range from
    ``DeviceRegions.reaching``."""
    cols, chrs, starts, ends, refs = selfcheck.region_edge_columns(label)
    eng = dr.DeviceRegions(chrs, starts, ends, np.arange(1, refs + 1), device="cpu")
    keys = selfcheck.pileup_keys(cols, True)
    out = []
    for part in np.array_split(np.arange(len(keys)), 4):
        sub = _subset(cols, np.isin(np.arange(len(keys)), part))
        k = keys[part]
        _, cut = eng.reaching(sub["pos"], selfcheck.record_ends(sub), k)
        rec = dr.upload_records(sub["pos"], k, sub["cigar_off"], sub["cigar"],
                                mapq=sub["mapq"], device="cpu")
        out.append((rec, cut))
    return eng, out


@pytest.mark.parametrize("label", sorted(selfcheck.REGION_EDGES))
def test_every_range_that_holds_the_reached_regions_gives_the_same_counters_and_hits(label):
    """``pileup_regions_plain`` (and the wrapper on the CPU route) at the
    regions range ``DeviceRegions.reaching`` finds for each chunk of the
    batch, at that range widened on either side and at every region: the
    same counters and hits as over every region."""
    eng, chunks = _chunks(label)
    n, narrower = eng.n, 0
    for rec, (lo, hi) in chunks:
        full = torch.zeros((dr.REGION_COUNTERS, n), dtype=torch.int32)
        want = dr.pileup_regions_plain(rec, eng.regions, eng.table, full)
        narrower += hi - lo < n
        for cut in ((lo, hi), (max(lo - 7, 0), hi), (lo, min(hi + 5, n)), (0, n)):
            counters = torch.zeros_like(full)
            got = dr.pileup_regions_plain(rec, eng.regions, eng.table, counters, cut)
            assert torch.equal(counters, full) and torch.equal(got, want), cut
        counters = torch.zeros_like(full)
        got = dr.pileup_regions_into(rec, eng.regions, eng.table, counters,
                                     dr.region_out(want.shape[0], torch.device("cpu")),
                                     regions_range=(lo, hi))
        assert torch.equal(counters, full) and torch.equal(got, want)
    assert narrower >= 2


@pytest.mark.parametrize("label", sorted(selfcheck.REGION_EDGES))
def test_the_regions_range_holds_every_region_of_every_pair(label):
    """``DeviceRegions.reaching``'s range of a chunk holds the region of
    every (record, region) pair and every hit that ``pileup_region_pairs``
    makes of it over every region; a chunk that overlaps no region gets
    ``(0, 0)``."""
    eng, chunks = _chunks(label)
    pairs_seen = 0
    for rec, (lo, hi) in chunks:
        pairs, _, hits = dr.pileup_region_pairs(rec, eng.regions, eng.table)
        if pairs.shape[0] == 0:
            continue
        assert lo <= int(pairs[:, 1].min()) and int(pairs[:, 1].max()) < hi
        if hits.shape[0]:
            assert lo <= int(hits[:, 1].min()) and int(hits[:, 1].max()) < hi
        pairs_seen += pairs.shape[0]
    assert pairs_seen > 100
    rec, _ = chunks[0]
    far = np.full(rec.pos.shape[0], 10_000_000, np.int64)
    assert eng.reaching(far, far + 151, rec.keep.numpy())[1] == (0, 0)


def _plain_and_spliced_records(seed: int) -> list[dict]:
    """3,000 sorted records on chr1 of 151 bases: most a single M op, one
    in 14 spliced (an N op of 300-3,000 bases), one in 12 with a 1-4 base I
    or D op, one in 20 of MAPQ 0; mates share a name."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.integers(1_000, 200_000, size=3000))
    out = []
    for i, p in enumerate(pos.tolist()):
        kind, a = rng.random(), int(rng.integers(20, 120))
        if kind < 1 / 14:
            ops = [("M", a), ("N", int(rng.integers(300, 3001))), ("M", 151 - a)]
        elif kind < 1 / 14 + 1 / 12:
            ln = int(rng.integers(1, 5))
            ops = ([("M", a), ("I", ln), ("M", 151 - a - ln)] if rng.random() < 0.5
                   else [("M", a), ("D", ln), ("M", 151 - a)])
        else:
            ops = [("M", 151)]
        qlen = sum(n for o, n in ops if o in "MI")
        seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=qlen))
        out.append(_record(p, ops, seq, b"r%d" % (i // 2),
                           mapq=0 if rng.random() < 0.05 else 60))
    return out


@pytest.mark.parametrize("fragments", [False, True], ids=["reads", "fragments"])
def test_get_indels_matches_the_jax_package_where_most_records_hold_no_indel(
        genome, tmp_path, fragments):
    """Most records a single M op (the region form adds them to the depth
    of each region they span with no second CIGAR walk), spliced records
    whose N op covers some regions, records with an I or D op in others:
    ``get_indels`` against the JAX package's, each region's indel list,
    depth and MAPQ-0 share."""
    records = _plain_and_spliced_records(seed=431)
    _write(tmp_path / "plain.bam", records)
    rng = np.random.default_rng(432)
    regions = []
    for r in records:
        ops = [(w & 0xF, w >> 4) for w in r["cigar"]]
        g = r["pos"] + 1 + ops[0][1]   # where the second op lies
        if len(ops) > 1 and ops[1][0] == 3:   # under the N op, and across its start
            regions += [(g + 10, g + 40), (g - 2, g + 3)]
        elif len(ops) > 1:
            regions.append((g - int(rng.integers(0, 4)), g + int(rng.integers(0, 6))))
    starts = rng.integers(1_000, 200_000, size=300)
    regions += [(int(s), int(s) + int(rng.integers(0, 60))) for s in starts]
    fasta = str(genome / "g.fa")
    want = jax_vd.get_indels(str(tmp_path / "plain.bam"),
                             [(JaxChromosome("chr1"), s, e) for s, e in regions],
                             JaxFasta(fasta), False, fragments)
    got = port_vd.get_indels(str(tmp_path / "plain.bam"),
                             [(Chromosome("chr1"), s, e) for s, e in regions],
                             FastaFileIndex(fasta), False, fragments)
    _assert_same_regions(got, want)
    assert sum(len(r.indels) for r in want) > 100
    assert sum(r.depth for r in want) > 1000
    assert any(math.isnan(r.mapq0_frac) or r.mapq0_frac > 0 for r in want)


@pytest.fixture(scope="module")
def trio_bam(tmp_path_factory):
    """A synthetic BAM with germline SNVs and indels of 1-4 bases (40% of
    600 sites) and its variants in GSvar coordinates, for both packages."""
    d = tmp_path_factory.mktemp("details")
    lengths = {"chr1": 400_000, "chr2": 300_000}
    genome = synth.synth_genome(d / "g.fa", lengths, seed=411)
    roi = synth.synth_roi(d / "roi.bed", genome, 200, seed=412)
    trio = synth.trio_variants(genome, roi, 600, seed=413, indel_share=0.4)
    synth.synth_bam(d / "x.bam", genome, 9000, seed=414, roi=roi, snps=trio.snps(2),
                    indels=trio.indels(2))
    rows = [(genome.names[c], *port_vd.gsvar_from_vcf(int(p) + 1, r, a))
            for c, p, r, a in zip(trio.chrom, trio.pos, trio.ref, trio.alt)]
    return d, rows


@pytest.mark.parametrize("fragments", [False, True], ids=["reads", "fragments"])
@pytest.mark.parametrize("npp", [False, True], ids=["proper pairs", "not properly paired"])
def test_variant_details_matches_the_jax_package(trio_bam, npp, fragments):
    """SNVs and indels mixed: depth, observations, frequency and MAPQ-0
    share of each variant equal the JAX package's."""
    d, rows = trio_bam
    want = jax_vd.variant_details(str(d / "x.bam"), JaxFasta(str(d / "g.fa")),
                                  [(JaxChromosome(r[0]), *r[1:]) for r in rows], npp, fragments)
    got = port_vd.variant_details(str(d / "x.bam"), FastaFileIndex(str(d / "g.fa")),
                                  [(Chromosome(r[0]), *r[1:]) for r in rows], npp, fragments)
    assert len(got) == len(want) == len(rows)
    for g, w in zip(got, want):
        assert (g.depth, g.obs) == (w.depth, w.obs)
        assert _same_float(g.frequency, w.frequency)
        assert _same_float(g.mapq0_frac, w.mapq0_frac)
    indel = [not port_vd.is_snv(r[3], r[4]) for r in rows]
    assert sum(g.obs for g, i in zip(got, indel) if i) > 500
    assert sum(g.obs for g, i in zip(got, indel) if not i) > 500


def test_the_sweep_reads_each_bam_once(trio_bam, monkeypatch):
    """``variant_details`` opens the BAM once for its SNVs and indels (the
    JAX package opens it twice), ``get_indels`` once; no BAM is opened for
    no variants."""
    d, rows = trio_bam
    opened = []
    real = port_pileup.BamReader
    monkeypatch.setattr(port_pileup, "BamReader",
                        lambda path, *a, **k: opened.append(path) or real(path, *a, **k))
    fasta = FastaFileIndex(str(d / "g.fa"))
    variants = [(Chromosome(r[0]), *r[1:]) for r in rows]
    port_vd.variant_details(str(d / "x.bam"), fasta, variants)
    assert opened == [str(d / "x.bam")]
    port_vd.get_indels(str(d / "x.bam"), [(v[0], v[1] - 1, v[2] + 1) for v in variants[:50]],
                       fasta)
    assert opened == [str(d / "x.bam")] * 2
    assert port_vd.variant_details(str(d / "missing.bam"), fasta, []) == []
    assert port_vd.get_indels(str(d / "missing.bam"), [], fasta) == []
    assert len(opened) == 2


def test_region_hits_are_keyed_a_launch_later(trio_bam, monkeypatch):
    """Batches of 2,000 records: the sweep waits for a batch's region hits
    only after it has launched the next batch, or at the end."""
    from ngsbits_tpu_torch.io.bam import BamReader
    d, rows = trio_bam
    monkeypatch.setattr(port_pileup, "BamReader",
                        lambda path, *a, **k: BamReader(path, batch_records=2000))
    events = []
    add, hits = dr.DeviceRegions.add, dr.IndelHits.hits

    def spy_add(self, *a, **kw):
        got = add(self, *a, **kw)
        events.append(("launch", got))
        return got

    def spy_hits(self):
        events.append(("hits", self))
        return hits(self)

    monkeypatch.setattr(dr.DeviceRegions, "add", spy_add)
    monkeypatch.setattr(dr.IndelHits, "hits", spy_hits)
    variants = [(Chromosome(r[0]), *r[1:]) for r in rows if not port_vd.is_snv(r[3], r[4])]
    port_vd.variant_details(str(d / "x.bam"), FastaFileIndex(str(d / "g.fa")), variants)
    launches = [h for kind, h in events if kind == "launch"]
    assert len(launches) >= 5
    kinds = [kind for kind, _ in events]
    assert kinds == ["launch"] + ["launch", "hits"] * (len(launches) - 1) + ["hits"]
    assert [h for kind, h in events if kind == "hits"] == launches


@pytest.mark.parametrize("wait", [True, False], ids=["waited for", "handle"])
def test_hits_past_the_capacity_raise(wait):
    """A capacity below the batch's hits: the CPU route raises, as the card
    does (the kernel only counts past it)."""
    rec, eng, capacity, _ = selfcheck.region_edge_inputs(sorted(selfcheck.REGION_EDGES)[0],
                                                         torch.device("cpu"))
    n_hits = dr.pileup_region_pairs(rec, eng.regions, eng.table)[2].shape[0]
    assert 100 < n_hits <= capacity
    out = dr.region_out(n_hits - 1, torch.device("cpu"))
    with pytest.raises(RuntimeError, match=f"{n_hits} hits past the capacity of {n_hits - 1}"):
        got = dr.pileup_regions_into(rec, eng.regions, eng.table, eng.counters, out, wait=wait)
        got.hits()
    exact = dr.pileup_regions_into(rec, eng.regions, eng.table, eng.counters,
                                   dr.region_out(n_hits, torch.device("cpu")))
    assert exact.shape == (n_hits, dr.REGION_HIT)


def test_an_over_capacity_batch_in_the_sweep_raises(trio_bam, monkeypatch):
    """The sweep reckons each batch's capacity from its I and D ops: with
    too few ops reckoned it raises instead of dropping a hit."""
    d, rows = trio_bam
    monkeypatch.setattr(port_pileup, "count_indel_ops", lambda cigar: 1)
    variants = [(Chromosome(r[0]), *r[1:]) for r in rows]
    with pytest.raises(RuntimeError, match="pileup_regions: .* past the capacity"):
        port_vd.variant_details(str(d / "x.bam"), FastaFileIndex(str(d / "g.fa")), variants)


def _record(pos: int, ops: list[tuple[str, int]], seq: bytes, name: bytes,
            mapq: int = 60) -> dict:
    return dict(pos=pos, cigar=[(n << 4) | CODES[o] for o, n in ops],
                seq=[NIBBLE[b] for b in seq], mapq=mapq, name=name)


def _write(path, records: list[dict]):
    n = len(records)
    l_seq = np.array([len(r["seq"]) for r in records], np.int32)
    n_cigar = np.array([len(r["cigar"]) for r in records], np.int32)
    names = [r["name"] for r in records]
    z = np.zeros(n, np.int32)
    batch = BamBatch(
        ref_id=z, pos=np.array([r["pos"] for r in records], np.int32),
        flag=np.full(n, 0x3, np.uint16), mapq=np.array([r["mapq"] for r in records], np.uint8),
        l_seq=l_seq, n_cigar=n_cigar, tlen=z, mate_ref_id=z, mate_pos=z,
        cigar=np.array([w for r in records for w in r["cigar"]], np.uint32),
        cigar_off=np.concatenate(([0], np.cumsum(n_cigar))).astype(np.int64),
        seq=np.array([b for r in records for b in r["seq"]], np.uint8),
        qual=np.full(int(l_seq.sum()), 30, np.uint8),
        seq_off=np.concatenate(([0], np.cumsum(l_seq))).astype(np.int64),
        names=b"".join(names),
        name_off=np.concatenate(([0], np.cumsum([len(x) for x in names]))).astype(np.int64),
        tags=np.zeros(0, np.uint8), tags_off=np.zeros(n + 1, np.int64))
    synth.write_bam(path, ["chr1"], [LENGTHS["chr1"]], [batch])


@pytest.mark.parametrize("where", ["before another record", "last in the file"])
def test_an_insertion_past_its_records_seq_keeps_its_own_bases(genome, tmp_path, where):
    """F13: a record with an I op and ``l_seq`` 0 spanning a region. The
    JAX package slices the batch's bases at the record's SEQ offset plus the
    op's query offset: it keys the insertion with the next record's bases,
    or an empty slice for the file's last record. The port reads no other
    record's bytes: ``+`` and the bases its record holds (none). Depths and
    the deletion's key agree."""
    no_seq = _record(99, [("M", 3), ("I", 2), ("M", 3), ("D", 1), ("M", 2)], b"", b"a")
    other = _record(90, [("M", 20)], b"GTACGTACGTACGTACGTAC", b"b")
    records = [no_seq, other] if where == "before another record" else [other, no_seq]
    _write(tmp_path / "f13.bam", records)
    fasta = str(genome / "g.fa")
    want = jax_vd.get_indels(str(tmp_path / "f13.bam"), [(JaxChromosome("chr1"), 102, 108)],
                             JaxFasta(fasta))
    got = port_vd.get_indels(str(tmp_path / "f13.bam"), [(Chromosome("chr1"), 102, 108)],
                             FastaFileIndex(fasta))
    deletion = b"-" + FastaFileIndex(fasta).seq(Chromosome("chr1"), 106, 1)
    if where == "before another record":
        assert want[0].indels == [b"+CG", deletion]  # the next record's bases at offset 3
    else:
        assert want[0].indels == [b"+", deletion]    # past the batch's end: an empty slice
    assert got[0].indels == [b"+", deletion]
    assert got[0].depth == want[0].depth == 2
