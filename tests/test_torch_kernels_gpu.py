"""Each CUDA kernel of the port against its plain torch version, on the card:
the ReadQC kernels at their main path's batch shape (B=65536 reads, L=192
cycles, the bucket of 151 bp reads), K1 also at the edge shapes its paths
split on (16-byte and byte loads, column passes, partial tiles), with each
quality profile and random bytes past the reads, unpack at the edges of its
paths (L % 16 == 8, views only 4- or 8-byte aligned, inputs at odd offsets,
8-bit quals up to 222) and tails at the edges of its rules (no reads,
n_valid past B, len_hist past the shared cap, wrapped sums, sums at exactly
20 and 60 times the length), the stream step with dirty scratch buffers,
SeqPurge's scans at theirs (B=10000
pairs, L=151) and at a ragged shape (B=1237, L=250), with adapters with and
without N and adapter prefixes of 15 and 20 bases, and the adapter scans at
the edges of their design (L from 1 to 1000, windows of 1 to 64 bases, random
bytes past the reads, all-N pairs), K2 at the edges of its contract (L from 1
to 24,576, min_len below 0 and above L, bytes outside ACGTN, all-N pairs,
random bytes past min_len), and SeqPurge's decisions at the main path's
batch, ragged rows, empty and two-base rows, single pairs, rows on either
side of the widest the decisions stage in shared memory (497 bases
staged, 498 read where they lie) and rows of 999 bases (read where they lie), with and without -ec,
and at parameters off the defaults (no trims, N runs of 3 and 6, a window
of one base, other match percentages and tails), and MappingQC's coverage
and pileup-count kernels (C1, C2, B1) at the main path's shapes and at their
edges (span 1, tile edges, spans of length 0, piles at and past the
histogram's range, each histogram parameter set, hot bins, all bundled
SNPs), with the engines on the card against the CPU, and the coverage
tools' kernels (C2's dense mode alone, R1, R2) at their edges (one-base
regions, regions at both ends and over the whole span, regions that touch,
cutoffs of 0, negative and above every depth) and at a whole chromosome
(chr1's 248,956,422 positions, coverage near 30 everywhere, so a region's
sum passes 2^31); C2's single pass at 64M positions and at chr1's length
(its look-backs cross waves of blocks), launched twice on one scratch and
replayed from a CUDA graph; R2 with regions of 1-3 positions at unaligned
starts, runs across mask words and warps' tiles, and chr1's box as one
region; C1's record form (a BAM batch's records walked on the card) at a
few thousand records: sorted and unsorted, several chromosomes, a pile, a
box's edges, a sparse panel with N ops over many blocks, -min_baseq 0, 20
and 30, several batches into one difference array against the CPU; B1's
record form (the contamination pileup) at ``selfcheck.PILEUP_EDGES`` with
each of ``PILEUP_PARAMS``, several batches into one ``DevicePileup``
against the CPU, and the wrapper's refusals; B1's indel form (VcfMerge's
re-calling) at ``selfcheck.INDEL_EDGES`` (its reached loci in shared memory,
200,000 of them in global memory, a chromosome whose reached range is
empty), both sweeps on the card against the CPU over a BAM with germline
indels, VcfMerge's sweep never waiting on the batch it has just launched,
and its refusals; B1's region form (the variant-details path) at
``selfcheck.REGION_EDGES`` (about 6,000 reached regions, 1,100 references,
both at once),
``variant_details`` on the card against the CPU (with and without
``count_fragments``), and its refusals; both forms' launches one device
operation each on a scratch left zero, the region form's replayed from a
CUDA graph, the engines' pinned slots of the hits' copies reused from batch
to batch and grown past their capacity; X7 (the
similarity's moments)
at the kernels phase's shapes (n = 1, off its 16-byte steps, a constant row,
n = 2^29 + 7 past int32, an exome's and a WGS VCF pair's overlap), at rows
off 16-byte boundaries, its refusals and ``pearson_from_genotypes`` against
the CPU, at rows of 255s (its 32-bit partials at their bound), at n = 1,
15, 16 and 17, on fixed grids through its test entry (one block whose
threads walk past the steps after which they widen their partials; grids
of a few blocks, past the SMs, past the steps); F10's seeded ties and zeros
through ``calculate_similarity`` on the card, printed as the centred form
prints them; and SampleSimilarity (VCF and BAM modes), SampleGender (hetx,
sry), SampleIdentity (two threads) and CfDnaQC on the card against the
port's CPU route on small seeded inputs, byte for byte; VariantQC's V1 at
its edges, on the seam records (each kind alone: patterns, keys and fields
at every offset of a 16-byte chunk and across the 512-byte steps in which a
warp reads a record) and on random records, RohHunter's H1 bit for bit, and
both tools on the card against the CPU.
Integer outputs: the tolerance is exact equality. Skips where no CUDA
device is available."""

import functools
import gzip

import numpy as np
import pytest
import torch

from ngsbits_tpu_torch.ops import selfcheck


@pytest.mark.gpu
@pytest.mark.parametrize("qual_bits", [6, 8])
@pytest.mark.parametrize("kernel", ["readqc_unpack", "readqc_batch", "readqc_tails"])
def test_kernel_matches_plain_version(kernel, qual_bits):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    (case,) = [c for c in selfcheck.cases(65536, 192, qual_bits, dev, seed=1)
               if c.name == kernel]
    before = case.wrapper.launches
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert case.wrapper.launches == before + 1
    assert selfcheck.max_abs_err(case) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("profile,qual_bits", [("uniform", 6), ("uniform", 8),
                                               ("binned", 6), ("wide", 8)])
@pytest.mark.parametrize("B,L,n_valid", [
    (65536, 192, None), (16384, 192, 10000), (1237, 151, None), (1, 1, 1),
    (33, 300, None), (1024, 10240, None)])
def test_readqc_batch_matches_plain_version(B, L, n_valid, profile, qual_bits):
    """K1 with random bytes past each read's length; ``wide`` puts quality
    bytes below 33 and at or above 133 (outside the histogram)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    arrays = selfcheck.reads(B, L, qual_bits, seed=B + L, profile=profile,
                             n_valid=n_valid, dirty=True)[:3]
    case = selfcheck.batch_case(*(torch.from_numpy(a).cuda() for a in arrays))
    before = case.wrapper.launches
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert case.wrapper.launches == before + 1
    assert selfcheck.max_abs_err(case) == 0


@pytest.mark.gpu
def test_readqc_batch_unaligned_inputs_take_byte_loads():
    """Inputs that are not 16-byte aligned (here L % 16 == 0, so only the
    address decides) go through the kernel's byte loads, with the same
    result; outputs wider than the batch keep their last columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import pallas_kernels as pk
    B, L = 4096, 192
    arrays = selfcheck.reads(B, L, 6, seed=5, profile="binned", dirty=True)[:3]
    bases, quals = (torch.empty(B * L + 1, dtype=torch.uint8, device="cuda")[1:]
                    .view(B, L).copy_(torch.from_numpy(a)) for a in arrays[:2])
    lengths = torch.from_numpy(arrays[2]).cuda()
    assert bases.data_ptr() % 16 and quals.data_ptr() % 16
    outs = []
    for fn in (pk.readqc_batch_into, pk.readqc_batch_plain):
        out = [torch.full((5, L + 8), 7, dtype=torch.int64, device="cuda"),
               torch.full((L + 8,), 7, dtype=torch.int64, device="cuda"),
               torch.zeros(100, dtype=torch.int64, device="cuda"),
               torch.empty(B, dtype=torch.int32, device="cuda")]
        fn(bases, quals, lengths, *out)
        outs.append(out)
    torch.cuda.synchronize()
    for g, w in zip(*outs):
        assert torch.equal(g, w)
    assert (outs[0][0][:, L:] == 7).all()


@pytest.mark.gpu
@pytest.mark.parametrize("qual_bits", [6, 8])
def test_stream_on_card_matches_cpu(qual_bits):
    """The whole stream step on the card, with batches both wider and
    narrower than the carry (K1 then adds into the carry's first columns),
    against the same batches folded on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu.ops.readqc import pack_batch
    from ngsbits_tpu_torch.ops import readqc as tops

    carries = {}
    for dev in (torch.device("cpu"), torch.device("cuda")):
        carry = None
        for i, (B, L) in enumerate([(4096, 192), (1024, 64), (2048, 320), (1024, 128)]):
            bases, quals, lengths, n_valid = selfcheck.reads(B, L, qual_bits, seed=i)
            packed = [torch.from_numpy(a).to(dev) for a in pack_batch(bases, quals, qual_bits)]
            carry = (tops.stream_carry_init(L, dev) if carry is None
                     else tops.stream_carry_grow(carry, L))
            tops.stream_step(carry, *packed, torch.from_numpy(lengths).to(dev),
                             n_valid, i % 2, qual_bits)
        carries[dev.type] = tops.carry_to_numpy(carry)
    for k in tops.CARRY_KEYS:
        assert (carries["cuda"][k] == carries["cpu"][k]).all(), k


@pytest.mark.gpu
def test_unpack_refuses_misaligned_output():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import pallas_kernels as pk
    dev = torch.device("cuda")
    B, L = 4, 64
    pb = torch.zeros((B, L // 4), dtype=torch.uint8, device=dev)
    nm = torch.zeros((B, L // 8), dtype=torch.uint8, device=dev)
    pq = torch.zeros((B, L // 4 * 3), dtype=torch.uint8, device=dev)
    out = torch.empty((B, L), dtype=torch.uint8, device=dev)
    odd = torch.empty(B * L + 1, dtype=torch.uint8, device=dev)[1:].view(B, L)
    before = pk.readqc_unpack_into.launches
    with pytest.raises(ValueError, match="aligned"):
        pk.readqc_unpack_into(pb, nm, pq, 6, odd, out)
    assert pk.readqc_unpack_into.launches == before


def _on_card(t: torch.Tensor, offset: int = 0, slack: int = 0):
    """``t`` copied to the card ``offset`` elements into a fresh allocation,
    with ``slack`` elements of 0xA5 bytes after it; returns (the copy, the
    allocation)."""
    buf = torch.full((offset + t.numel() + slack,), 0, dtype=t.dtype, device="cuda")
    buf.view(torch.uint8).fill_(0xA5)
    return buf[offset:offset + t.numel()].view(t.shape).copy_(t), buf


def _packed(B, L, qual_bits, seed):
    """Random packed reads: any code, about one N in eight, any 6-bit field
    or 8-bit quals 0..222, 222 among them."""
    rng = np.random.default_rng(seed)
    pb = rng.integers(0, 256, (B, L // 4), dtype=np.uint8)
    nm = (rng.integers(0, 256, (B, L // 8)) & rng.integers(0, 256, (B, L // 8))
          & rng.integers(0, 256, (B, L // 8))).astype(np.uint8)
    if qual_bits == 8:
        pq = rng.integers(0, 223, (B, L), dtype=np.uint8)
        pq[0, 0] = 222
    else:
        pq = rng.integers(0, 256, (B, L // 4 * 3), dtype=np.uint8)
    return [torch.from_numpy(a) for a in (pb, nm, pq)]


def _unpack_both(B, L, qual_bits, seed, in_off=0, out_off=0):
    from ngsbits_tpu_torch.ops import pallas_kernels as pk
    packed = [_on_card(t, in_off)[0] for t in _packed(B, L, qual_bits, seed)]
    outs = [_on_card(torch.zeros((B, L), dtype=torch.uint8), out_off, slack=32)
            for _ in range(4)]
    before = pk.readqc_unpack_into.launches
    pk.readqc_unpack_into(*packed, qual_bits, outs[0][0], outs[1][0])
    pk.readqc_unpack_plain(*packed, qual_bits, outs[2][0], outs[3][0])
    torch.cuda.synchronize()
    assert pk.readqc_unpack_into.launches == before + 1
    for got, want in ((outs[0], outs[2]), (outs[1], outs[3])):
        assert torch.equal(got[0], want[0])
        # nothing written before or after the rows
        assert (got[1][:out_off] == 0xA5).all() and (got[1][out_off + B * L:] == 0xA5).all()


@pytest.mark.gpu
@pytest.mark.parametrize("qual_bits", [6, 8])
@pytest.mark.parametrize("B,L", [(1237, 8), (1237, 24), (1237, 200), (1237, 256),
                                 (10000, 192), (1, 8), (3, 24)])
def test_unpack_matches_plain_version_at_the_edges(B, L, qual_bits):
    """unpack on random packed bytes: L % 16 == 8 (an odd last 8 columns when
    B is odd), 16-column rows, the -qc bucket's 10,000 reads at L=192, and
    8-bit quals up to 222."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _unpack_both(B, L, qual_bits, seed=B + L)


@pytest.mark.gpu
@pytest.mark.parametrize("qual_bits", [6, 8])
@pytest.mark.parametrize("in_off,out_off", [(0, 4), (0, 8), (1, 0), (2, 8)])
def test_unpack_at_views_not_16_byte_aligned(in_off, out_off, qual_bits):
    """Outputs only 4- or 8-byte aligned, packed inputs at odd offsets: the
    kernel's 8-column and byte paths give what the plain version gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _unpack_both(333, 192, qual_bits, seed=in_off + out_off, in_off=in_off, out_off=out_off)


def _tail_inputs(B, Lc, seed):
    """Lengths 0..Lc+59 (past Lc too), some negative and many 151; per-read
    sums exactly 20*len, 20*len - 1, 60*len, 60*len + 1, any int32 (wrapped
    sums), small negative ones, and ordinary means."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, Lc + 60, B)
    lengths[rng.random(B) < 0.3] = 151
    lengths[rng.random(B) < 0.02] = -3
    k = rng.integers(0, 8, B)
    mean = lengths * rng.integers(0, 45, B) + rng.integers(0, np.maximum(lengths, 1))
    rq = np.select([k == 0, k == 1, k == 2, k == 3, k == 4, k == 5],
                   [20 * lengths, 20 * lengths - 1, 60 * lengths, 60 * lengths + 1,
                    rng.integers(-2**31, 2**31, B), -rng.integers(0, 1000, B)], mean)
    rq = (rq.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return torch.from_numpy(lengths.astype(np.int32)), torch.from_numpy(rq)


@pytest.mark.gpu
@pytest.mark.parametrize("B,n_valid,Lc,offset", [
    (65536, 65536, 192, 0),   # ReadQC's batch: every row a read
    (16384, 10000, 192, 0),   # SeqPurge's -qc bucket
    (4099, 0, 192, 0),        # no reads: bases only
    (4099, 4099, 64, 1),      # B not a multiple of 4; inputs not 16-byte aligned
    (4099, 2001, 64, 2),
    (2050, 2050, 4095, 0),    # the widest len_hist in shared memory
    (4, 9999, 4096, 0),       # n_valid past B; the narrowest len_hist past the cap
    (2053, 1999, 5000, 3),    # len_hist by global atomics
])
def test_tails_match_plain_version_at_the_edges(B, n_valid, Lc, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import pallas_kernels as pk
    from ngsbits_tpu_torch.ops import readqc as tops
    lengths, rq = (_on_card(t, offset)[0] for t in _tail_inputs(B, Lc, seed=B + Lc))
    carries = []
    for _ in range(2):
        g = torch.Generator().manual_seed(5)
        carry = tops.stream_carry_init(Lc, torch.device("cuda"))
        for k in pk.TAIL_KEYS:
            carry[k] += torch.randint(0, 1000, carry[k].shape, generator=g).cuda()
        carries.append(carry)
    direction = B % 2
    before = pk.readqc_tails_into.launches
    pk.readqc_tails_into(rq, lengths, n_valid, direction, carries[0])
    pk.readqc_tails_plain(rq, lengths, n_valid, direction, carries[1])
    torch.cuda.synchronize()
    assert pk.readqc_tails_into.launches == before + 1
    for k in pk.TAIL_KEYS:
        assert torch.equal(carries[0][k], carries[1][k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("qual_bits", [6, 8])
def test_stream_step_with_dirty_scratch_on_card_matches_cpu(qual_bits):
    """A bucket of 10,000 reads in 16,384 rows, both directions, scratch
    buffers filled with 0xFF first: the card's carries and unpacked rows
    equal the CPU route's, and the padding rows keep their 0xFF."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import readqc as tops
    B, L, n_valid = 16384, 192, 10000
    bases, quals, lengths, _ = selfcheck.reads(B, L, qual_bits, seed=3, n_valid=n_valid)
    packed = [torch.from_numpy(a) for a in tops.pack_batch(bases, quals, qual_bits)]
    rng = np.random.default_rng(4)
    start = {k: rng.integers(0, 10_000, v.shape) for k, v in
             tops.carry_to_numpy(tops.stream_carry_init(L, torch.device("cpu"))).items()}
    carries, scratches = {}, {}
    for dev in (torch.device("cpu"), torch.device("cuda")):
        carry = tops.carry_from_numpy(start, dev)
        scratch = {k: torch.full((B * L,), 0xFF, dtype=torch.uint8, device=dev)
                   for k in ("bases", "quals")}
        for direction in (0, 1):
            tops.stream_step(carry, *(t.to(dev) for t in packed),
                             torch.from_numpy(lengths).to(dev), n_valid, direction,
                             qual_bits, scratch)
        carries[dev.type] = tops.carry_to_numpy(carry)
        scratches[dev.type] = {k: scratch[k].cpu().view(B, L) for k in ("bases", "quals")}
    for k in tops.CARRY_KEYS:
        assert (carries["cuda"][k] == carries["cpu"][k]).all(), k
    for k in ("bases", "quals"):
        assert torch.equal(scratches["cuda"][k], scratches["cpu"][k]), k
        assert (scratches["cuda"][k][n_valid:] == 0xFF).all(), k


A1 = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
A2 = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
ADAPTERS = {"default": (A1, A2),
            "with_n": (b"AGANCGGAAGNGCACACGTC", b"NGATCGGAAGAGCGTCGTGN")}


@pytest.mark.gpu
@pytest.mark.parametrize("a_size", [15, 20])
@pytest.mark.parametrize("adapters", sorted(ADAPTERS))
@pytest.mark.parametrize("B,L", [(10000, 151), (1237, 250)])
def test_seqpurge_kernels_match_plain_versions(B, L, adapters, a_size):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a1, a2 = ADAPTERS[adapters]
    for case in selfcheck.seqpurge_cases(B, L, torch.device("cuda"), a1, a2,
                                         a_size=a_size, seed=B + a_size):
        before = case.wrapper.launches
        case.kernel()
        case.plain()
        torch.cuda.synchronize()
        assert case.wrapper.launches == before + 1, case.name
        assert selfcheck.max_abs_err(case) == 0, case.name


# adapters of 64 bases, and the same with N (read 2's first base among them)
LONG = {False: ((A1 + A2)[:64], (A2 + A1)[:64])}
LONG[True] = tuple(bytes(ord("N") if i % 7 == 3 or (k == 1 and i == 0) else c
                         for i, c in enumerate(a)) for k, a in enumerate(LONG[False]))


@pytest.mark.gpu
@pytest.mark.parametrize("with_n", [False, True])
@pytest.mark.parametrize("size", [1, 10, 20, 33, 64])
@pytest.mark.parametrize("B", [1, 33, 10000])
@pytest.mark.parametrize("L", [1, 7, 151, 1000])
def test_adapter_scans_match_plain_versions_at_the_edges(L, B, size, with_n):
    """adapter_evidence with a window of ``size`` bases and adapter_scan with
    an adapter prefix of ``size`` bases, on pairs with random bytes past the
    lengths, zero lengths, read 2 shorter than the window and all-N pairs:
    the edges of the staged rows, the template and run-time word counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a1, a2 = LONG[with_n]
    cases = [c for c in selfcheck.seqpurge_cases(B, L, torch.device("cuda"), a1, a2,
                                                 a_size=size, overlap=size,
                                                 seed=L + B + size, dirty=True)
             if c.name != "insert_scan"]
    for case in cases:
        before = case.wrapper.launches
        case.kernel()
        case.plain()
        torch.cuda.synchronize()
        assert case.wrapper.launches == before + 1, case.name
        assert selfcheck.max_abs_err(case) == 0, case.name


@pytest.mark.gpu
@pytest.mark.parametrize("B,L", [(1, 1), (33, 1), (10000, 1), (1, 7), (33, 7), (10000, 7),
                                 (1, 151), (33, 151), (10000, 151), (1, 1000), (33, 1000),
                                 (10000, 1000), (1, 24576), (3, 24576)])
def test_insert_scan_matches_plain_version_at_the_edges(B, L):
    """K2 on ``selfcheck.insert_edge_pairs``: overlapping pairs, one base
    repeated (counts up to L), any byte value, all-N pairs, min_len -1, 0,
    L, above L and int32's largest, random bytes past min_len; tiles of
    one row up to the widest rows the wrapper takes, and batches that are
    not a multiple of a tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = selfcheck.insert_case(*(torch.from_numpy(a).cuda() for a in
                                   selfcheck.insert_edge_pairs(B, L, seed=B + L)))
    before = case.wrapper.launches
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert case.wrapper.launches == before + 1
    assert selfcheck.max_abs_err(case) == 0


@pytest.mark.gpu
def test_insert_scan_refuses_wide_rows_and_int32_outputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import pallas_kernels as pk
    before = pk.insert_scan_into.launches
    for L, dtype, match in ((pk.MAX_SCAN_WIDTH + 1, torch.int16, "exceeds"),
                            (151, torch.int32, "dtype")):
        rows = torch.zeros((2, L), dtype=torch.uint8, device="cuda")
        n = torch.zeros(2, dtype=torch.int32, device="cuda")
        out = [torch.empty((2, L), dtype=dtype, device="cuda") for _ in range(2)]
        with pytest.raises((ValueError, TypeError), match=match):
            pk.insert_scan_into(rows, rows, n, *out)
    assert pk.insert_scan_into.launches == before


@pytest.mark.gpu
def test_adapter_scans_refuse_rows_wider_than_shared_memory_takes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import pallas_kernels as pk
    from ngsbits_tpu_torch.ops import seqpurge as sp
    B, L = 2, pk.MAX_SCAN_WIDTH + 1
    read = torch.zeros((B, L), dtype=torch.uint8, device="cuda")
    n = torch.zeros(B, dtype=torch.int32, device="cuda")
    out = [torch.empty((B, L), dtype=sp.ADAPTER_COUNT, device="cuda") for _ in range(4)]
    before = [k.launches for k in (sp.adapter_evidence_into, sp.adapter_scan_into)]
    with pytest.raises(ValueError, match="exceeds"):
        sp.adapter_evidence_into(read, read, n, n, A1[:10], A2[:10], *out)
    with pytest.raises(ValueError, match="exceeds"):
        sp.adapter_scan_into(read, n, A1[:20], *out[:2])
    assert [k.launches for k in (sp.adapter_evidence_into, sp.adapter_scan_into)] == before


@pytest.mark.gpu
def test_adapter_scans_refuse_int32_outputs():
    """The adapter scans write one-byte counts; int32 outputs are refused
    before any launch, as K2 refuses them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import seqpurge as sp
    B, L = 2, 151
    read = torch.zeros((B, L), dtype=torch.uint8, device="cuda")
    n = torch.zeros(B, dtype=torch.int32, device="cuda")
    out = [torch.empty((B, L), dtype=torch.int32, device="cuda") for _ in range(4)]
    before = [k.launches for k in (sp.adapter_evidence_into, sp.adapter_scan_into)]
    with pytest.raises(TypeError, match="dtype"):
        sp.adapter_evidence_into(read, read, n, n, A1[:10], A2[:10], *out)
    with pytest.raises(TypeError, match="dtype"):
        sp.adapter_scan_into(read, n, A1[:20], *out[:2])
    assert [k.launches for k in (sp.adapter_evidence_into, sp.adapter_scan_into)] == before


@pytest.mark.gpu
@pytest.mark.parametrize("dirty", [False, True])
@pytest.mark.parametrize("ec", [False, True])
@pytest.mark.parametrize("B,L,adapters", [
    (10000, 151, "default"), (1237, 250, "default"), (1237, 250, "with_n"),
    (5, 0, "default"), (7, 2, "with_n"), (1, 151, "default"), (33, 151, "with_n"),
    # a block's 16 staging buffers (two a warp) fill kStageLimit at L=497
    (64, 497, "default"),
    (64, 498, "with_n"), (1, 999, "default"), (33, 999, "default"),
    (500, 999, "with_n"), (4000, 999, "default")])
def test_seqpurge_decide_matches_plain_version(B, L, adapters, ec, dirty):
    """The decisions' kernel on the scans of a short-insert library with
    adapters (ties in p at 0.0 on the long rows, errors for -ec, N runs,
    low-quality tails, random bytes past the reads with ``dirty``): per-pair
    results, accumulators and corrected reads equal the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = selfcheck.decide_case(B, L, torch.device("cuda"), *ADAPTERS[adapters],
                                 ec=ec, seed=B + L, dirty=dirty)
    before = case.wrapper.launches
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert case.wrapper.launches == before + 1
    assert selfcheck.max_abs_err(case) == 0


# parameters off the defaults: no trims; N runs shorter than an aligned
# word of four (the N trim's exact path alone); a window of one base; other
# thresholds (the ratio test and the tail)
OTHER_PARAMS = [dict(qcut=0, ncut=0), dict(ncut=3, qcut=30), dict(qwin=1, ncut=6),
                dict(match_perc=66.7, mep=1e-3), dict(match_perc=100.0, mep=0.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("ec", [False, True])
@pytest.mark.parametrize("params", OTHER_PARAMS, ids=lambda d: "-".join(
    f"{k}={v}" for k, v in d.items()))
def test_seqpurge_decide_matches_plain_version_with_other_parameters(params, ec):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = selfcheck.decide_case(2000, 151, torch.device("cuda"), *ADAPTERS["default"],
                                 ec=ec, seed=len(params), dirty=True, **params)
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert selfcheck.max_abs_err(case) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("ec", [False, True])
def test_seqpurge_decide_breaks_ties_as_the_plain_version(ec):
    """Pairs whose best insert p-value is reached at several offsets (ties
    at 0.0 that span lanes of a warp on rows of 700 bases): the kernel
    picks the smallest offset, as the plain version does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    *pairs, quals = selfcheck.tie_pairs(720, seed=7)
    case = selfcheck.decide_case_for(*pairs, quals, torch.device("cuda"),
                                     *selfcheck.POLY, ec=ec)
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert selfcheck.max_abs_err(case) == 0
    best = case.outputs()[0][0][0]
    assert (best[:8] == 5).all() and (best[8:] > 32).all()


@pytest.mark.gpu
@pytest.mark.parametrize("ec", [False, True])
def test_seqpurge_engine_on_card_matches_cpu(ec):
    """Whole batches through the engine on the card and on the CPU: new
    lengths, corrected reads and every statistic are equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from ngsbits_tpu_torch.io.fastq import FastqBatch
    from ngsbits_tpu_torch.qc.seqpurge import (SeqPurgeEngine, SeqPurgeParams,
                                               stats_to_dict)

    results = {}
    for dev in ("cpu", "cuda"):
        engine = SeqPurgeEngine(SeqPurgeParams(ec=ec), device=dev)
        out = []
        for seed in range(3):
            read1, read2, _, len1, len2, _ = selfcheck.pairs(3000, 151, seed)
            rng = np.random.default_rng(seed)
            q1, q2 = (np.where(r != 0, rng.integers(35, 74, size=r.shape), 0)
                      .astype(np.uint8) for r in (read1, read2))
            b1 = FastqBatch(bases=read1, quals=q1, lengths=len1)
            b2 = FastqBatch(bases=read2, quals=q2, lengths=len2)
            out.append((*engine.process_batch(b1, b2), b1.bases, b2.bases))
        results[dev] = (out, stats_to_dict(engine.stats))
    for got, want in zip(results["cuda"][0], results["cpu"][0]):
        for g, w in zip(got, want):
            assert (g == w).all()
    for k, v in results["cpu"][1].items():
        assert np.array_equal(results["cuda"][1][k], v), k


# ---------------------------------------------------------------- MappingQC

def _t(a):
    return torch.from_numpy(a).to("cuda")


@functools.lru_cache(maxsize=1)
def _diff(span, pile, seed):
    """C2's input: the difference array of span // 20 spans and a pile, on
    the card (kept for the cases that share it; C2 only reads it)."""
    s, e = selfcheck.coverage_spans(span, max(span // 20, 4), seed=seed, pile=pile)
    return selfcheck.coverage_diff(s, e, span, torch.device("cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("span,n,pile", [(1, 0, 0), (5000, 777, 0), (3 * 8192 + 17, 5000, 0),
                                         (3 * 8192 + 17, 5000, 700), (8192, 100_000, 0),
                                         (12_000_000, 49_000, 0)])
def test_coverage_add_matches_plain_version(span, n, pile):
    """C1, spans of length 0 to 400 with some at 0 and some ending at the
    span, a pile of equal spans (one counter hit by a whole warp)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if n == 0:
        s, e = np.array([0, 0, 1, 0], np.int32), np.array([0, 1, 1, 1], np.int32)
    else:
        s, e = selfcheck.coverage_spans(span, n, seed=span + n, pile=pile)
    case = selfcheck.coverage_add_case(_t(s), _t(e), span)
    before = case.wrapper.launches
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert case.wrapper.launches == before + 1
    assert selfcheck.max_abs_err(case) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("params", [(5, 599, 120, 20), (5, 599, 120, 0), (10, 999, 100, 125),
                                    (10, 1499, 150, 300), (10, 2499, 250, 600),
                                    (500, 20000, 40, 450), (1, 0, 1, 1)])
@pytest.mark.parametrize("span,pile", [(1, 0), (8192, 0), (3 * 8192 + 17, 599),
                                       (3 * 8192 + 17, 600), (3 * 8192 + 17, 20001),
                                       (1_000_003, 2500), (64_000_003, 2500)])
@pytest.mark.parametrize("dense", [False, True])
def test_coverage_finalize_matches_plain_version(span, pile, params, dense):
    """C2 at tile edges and with coverage at, above and far above the
    histogram's range, for each set of histogram parameters MappingQC uses
    (default, the adaptive steps, cfDNA), with and without the dense
    coverage; at 64M positions the tiles (7,813) far outnumber the blocks
    resident at once, so look-backs cross waves of blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    diff = _diff(span, pile, span + pile)
    case = selfcheck.coverage_finalize_case(diff, *params, dense=dense)
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert selfcheck.max_abs_err(case) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("span", [8192, 3 * 8192 + 17, 64_000_003])
@pytest.mark.parametrize("dense", [False, True])
def test_coverage_finalize_relaunched_on_one_scratch_and_from_a_graph(span, dense):
    """C2's status words and tile counter are cleared by each launch: two
    launches on one scratch (left dirty by a fill before the first), and a
    CUDA graph replayed three times over outputs made dirty between the
    replays, give the plain version's outputs each time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops.pallas_kernels import _lib, _ptr, _stream
    diff = _diff(span, 2500, span + 2500)
    case = selfcheck.coverage_finalize_case(diff, 5, 599, 120, 20, dense=dense)
    case.plain()
    got, want = case.outputs()
    scratch = torch.full((_lib().ngs_coverage_scratch(span),), -1, dtype=torch.int64,
                         device="cuda")
    cov = got[2] if dense else None
    for _ in range(2):
        for g in got:
            g.fill_(-3)
        rc = _lib().ngs_coverage_finalize(_ptr(diff), span, 5, 599, 120, 20, _ptr(scratch),
                                          _ptr(got[0]), _ptr(got[1]),
                                          None if cov is None else _ptr(cov), _stream(diff))
        assert rc == 0
        torch.cuda.synchronize()
        assert selfcheck.max_abs_err(case) == 0
    case.kernel()  # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        case.kernel()
    for _ in range(3):
        for g in got:
            g.fill_(-3)
        graph.replay()
        torch.cuda.synchronize()
        assert selfcheck.max_abs_err(case) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("n_snps,n,hot", [(1, 1, 0), (16, 10_000, 0), (3200, 2500, 0),
                                          (3200, 2500, 20_000), (100_779, 403_116, 0)])
def test_bincount_add_matches_plain_version(n_snps, n, hot):
    """B1, with hot bins (many indices on one locus) and over all of the
    bundled SNPs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = selfcheck.bincount_case(_t(selfcheck.pileup_indices(n_snps, n, seed=n, hot=hot)),
                                   4 * n_snps)
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert selfcheck.max_abs_err(case) == 0


@pytest.mark.gpu
def test_coverage_engines_on_card_match_cpu():
    """DeviceCoverage (histogram, coverage_at, finalize) and DeviceBincount
    on the card against the same calls on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    span = 3 * 8192 + 17
    s, e = selfcheck.coverage_spans(span, 4000, seed=9, pile=650)
    got, want = dr.DeviceCoverage(span, "cuda"), dr.DeviceCoverage(span, "cpu")
    for eng in (got, want):
        for i in range(0, len(s), 999):
            eng.add(s[i:i + 999], e[i:i + 999])
    hg, hw = got.histogram(5, 599, 120, 20), want.histogram(5, 599, 120, 20)
    np.testing.assert_array_equal(hg[0], hw[0])
    assert hg[1] == hw[1]
    pos = np.array([0, 17, span - 1])
    np.testing.assert_array_equal(got.coverage_at(pos), want.coverage_at(pos))
    np.testing.assert_array_equal(got.finalize(), want.finalize())
    idx = selfcheck.pileup_indices(300, 5000, seed=3, hot=800)
    bg, bw = dr.DeviceBincount(1200, "cuda"), dr.DeviceBincount(1200, "cpu")
    for eng in (bg, bw):
        eng.add(idx)
    np.testing.assert_array_equal(bg.finalize(), bw.finalize())


@pytest.mark.gpu
def test_coverage_wrappers_refuse_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    diff = torch.zeros(11, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        dr.coverage_add_into(torch.zeros(2, dtype=torch.int64, device="cuda"),
                             torch.zeros(2, dtype=torch.int32, device="cuda"), diff)
    with pytest.raises(ValueError, match="bins"):
        dr.coverage_finalize_into(diff, 1, 10, 0,
                                  torch.zeros(dr.MAX_BINS + 1, dtype=torch.int64, device="cuda"),
                                  torch.zeros(1, dtype=torch.int64, device="cuda"))
    with pytest.raises(TypeError):
        dr.bincount_add_into(torch.zeros(2, dtype=torch.int32, device="cuda"),
                             torch.zeros(4, dtype=torch.int64, device="cuda"))


# ------------------------------------------------------------ coverage tools

ODD = 3 * 8192 + 17
CHR1 = 248_956_422


def _cov(diff):
    return torch.cumsum(diff[:-1], 0).to(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("span,pile", [(1, 0), (8192, 0), (ODD, 650), (1_000_003, 2500),
                                       (64_000_003, 2500), (CHR1, 0)])
def test_coverage_dense_mode_matches_plain_version_and_the_histogram_mode(span, pile):
    """Up to chr1's whole length (30,391 tiles, many waves of blocks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    diff = _diff(span, pile, span)
    case = selfcheck.coverage_dense_case(diff)
    before = case.wrapper.launches
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert case.wrapper.launches == before + 1
    assert selfcheck.max_abs_err(case) == 0
    with_hist = torch.zeros(span, dtype=torch.int32, device="cuda")
    dr.coverage_finalize_into(diff, 5, 599, 20, torch.zeros(120, dtype=torch.int64, device="cuda"),
                              torch.zeros(1, dtype=torch.int64, device="cuda"), with_hist)
    assert torch.equal(with_hist, case.outputs()[0][0])


@pytest.mark.gpu
@pytest.mark.parametrize("disjoint", [False, True])
@pytest.mark.parametrize("span,n", [(1, 1), (5000, 900), (ODD, 2000), (1_000_003, 5000),
                                    (1_000_003, 40)])
def test_region_sums_match_plain_version(span, n, disjoint):
    """R1: regions of one base, at both ends, over the whole span, long
    ones over many warps' tiles, overlapping and repeated."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s, e = selfcheck.coverage_spans(span, max(span // 10, 4), seed=span + n, pile=700)
    cov = _cov(selfcheck.coverage_diff(s, e, span, torch.device("cuda")))
    rs, re = selfcheck.coverage_regions(span, n, seed=n, max_len=60_000 if n == 40 else 400,
                                        disjoint=disjoint)
    case = selfcheck.region_sums_case(cov, rs, re)
    before = case.wrapper.launches
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert case.wrapper.launches == before + 1
    assert selfcheck.max_abs_err(case) == 0


@functools.lru_cache(maxsize=1)
def _runs_cov(span, n):
    """R2's coverage: span // 10 spans and a pile of 700, on the card."""
    s, e = selfcheck.coverage_spans(span, max(span // 10, 4), seed=span + n, pile=700)
    return _cov(selfcheck.coverage_diff(s, e, span, torch.device("cuda")))


@pytest.mark.gpu
@pytest.mark.parametrize("is_high", [False, True])
@pytest.mark.parametrize("cutoff", [-1, 0, 1, 20, 700, 10**30])
@pytest.mark.parametrize("span,n,max_len", [(1, 1, 400), (5000, 900, 400), (ODD, 300, 400),
                                            (1_000_003, 3000, 400), (70_001, 25_000, 3),
                                            (1_000_003, 30, 60_000), (CHR1, 1, 400)])
def test_threshold_runs_match_plain_version(span, n, max_len, cutoff, is_high):
    """R2 in disjoint regions: runs at region and tile ends, one-base
    regions, runs over whole regions, no runs at all; regions of 1-3
    positions at unaligned starts (many to a mask word, past the 32 a warp
    holds at once); regions of up to 60,000 positions whose runs cross mask
    words and warps' tiles of 1,024; chr1's whole box as one region."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cov = _runs_cov(span, n)
    regions = selfcheck.coverage_regions(span, n, seed=n, max_len=max_len, disjoint=True)
    case = selfcheck.threshold_runs_case(cov, *regions, cutoff, is_high)
    before = case.wrapper.launches
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert case.wrapper.launches == before + 1
    assert selfcheck.max_abs_err(case) == 0
    if max_len == 60_000 and (cutoff, is_high) in ((10**30, False), (-1, True)):
        region, first, last = case.outputs()[1][0].cpu().numpy().astype(np.int64)
        from ngsbits_tpu_torch.ops import device_reduce as dr
        starts, offsets = dr.region_offsets(*regions)
        q_first = offsets[region] + first - starts[region]
        q_last = offsets[region] + last - starts[region]
        assert (q_first // 1024 != q_last // 1024).any()  # a run across two warps' tiles
    case.device_fn()  # the graph-timed launches give the same runs
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_regions_that_touch_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    cov = torch.tensor([0, 0, 5, 5, 5, 0, 5, 5], dtype=torch.int32, device="cuda")
    starts, offsets = (torch.from_numpy(a).cuda() for a in
                       dr.region_offsets(np.array([0, 2, 5, 6]), np.array([1, 4, 5, 7])))
    assert dr.threshold_runs(cov, starts, offsets, 5, True).tolist() == [[1, 3], [2, 6], [4, 7]]
    assert dr.threshold_runs(cov, starts, offsets, 5, False).tolist() == [[0, 2], [0, 5], [1, 5]]
    out = torch.empty(4, dtype=torch.int64, device="cuda")
    dr.region_sums_into(cov, starts, offsets, out)
    assert out.tolist() == [0, 15, 0, 10]
    starts, offsets = (torch.from_numpy(a).cuda() for a in
                       dr.region_offsets(np.array([0, 0]), np.array([7, 7])))
    with pytest.raises(ValueError, match="disjoint"):
        dr.threshold_runs(cov, starts, offsets, 1, False)


@pytest.mark.gpu
def test_whole_chromosome_box():
    """C2 (histogram and dense mode), R1 and R2 at chr1's whole length with
    coverage near 30 at every position: a region sum near 7.5e9 passes
    2^31, and every index passes MappingQC's 13.9M span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    span = CHR1
    gen = torch.Generator(device="cuda").manual_seed(5)
    diff = torch.zeros(span + 1, dtype=torch.int32, device="cuda")
    diff[0] = 30
    at = torch.randint(0, span - 1000, (2_000_000,), device="cuda", generator=gen)
    length = torch.randint(1, 1000, (2_000_000,), device="cuda", generator=gen)
    sign = torch.randint(0, 2, (2_000_000,), device="cuda", generator=gen).to(torch.int32) * 2 - 1
    diff.index_add_(0, at, sign)
    diff.index_add_(0, at + length, -sign)
    for case in (selfcheck.coverage_finalize_case(diff, 1, 59, 60, 15),
                 selfcheck.coverage_dense_case(diff)):
        case.kernel()
        case.plain()
        torch.cuda.synchronize()
        assert selfcheck.max_abs_err(case) == 0
    cov = case.outputs()[0][0]
    del case
    torch.cuda.empty_cache()
    rs = np.array([0, 0, 100_000_000, span - 1, 12_345_678])
    re = np.array([span - 1, 99_999_999, span - 1, span - 1, 12_345_678 + 70_000_000])
    case = selfcheck.region_sums_case(cov, rs, re)
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert selfcheck.max_abs_err(case) == 0
    assert case.outputs()[0][0][0] > 2**31
    del case
    for cutoff, is_high in ((29, False), (31, True)):
        case = selfcheck.threshold_runs_case(cov, np.array([0]), np.array([span - 1]),
                                             cutoff, is_high)
        case.kernel()
        case.plain()
        torch.cuda.synchronize()
        assert selfcheck.max_abs_err(case) == 0
        assert case.outputs()[0][0].shape[1] > 1000
        del case
        torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("bad", [([5, -1], [10, 3]), ([5, 90], [10, 101]), ([5, 12], [10, 11]),
                                 ([0, 100], None)])
def test_out_of_contract_spans_raise_on_the_card_as_on_the_cpu(bad):
    """F7: the same ValueError on both routes, before any upload."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    s, e = bad
    for dev in ("cuda", "cpu"):
        dc = dr.DeviceCoverage(100, dev)
        before = dr.coverage_add_into.launches
        with pytest.raises(ValueError, match="outside the coverage"):
            dc.add(np.array(s), None if e is None else np.array(e))
        assert dr.coverage_add_into.launches == before
        assert int(dc.diff.abs().sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("sparse", [False, True])
def test_coverage_tool_accumulators_on_card_match_cpu(sparse, monkeypatch):
    """The tools' accumulators (spans, -min_baseq positions through C1's mode
    without ends, region sums, runs) on the card against the CPU route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.qc import coverage as qc
    rng = np.random.default_rng(11)
    rs = np.sort(rng.integers(1_000, 5_000_000 if sparse else 900_000, size=200))
    re = rs + rng.integers(0, 400, size=200)
    got = {}
    for dev in ("cuda", "cpu"):
        monkeypatch.setenv("NGSBITS_TORCH_DEVICE", dev)
        acc = (qc._ChrCoverageSparse(rs, re) if sparse
               else qc._ChrCoverage(int(rs[0]), int(re.max())))
        r = np.random.default_rng(12)
        for _ in range(5):
            c = rs[r.integers(0, 200, size=3000)] + r.integers(-300, 300, size=3000)
            acc.add_spans(c, c + r.integers(0, 300, size=3000))
            acc.add_positions(c + 7)
        got[dev] = (acc.region_sums(rs, re),
                    acc.runs(*_disjoint(rs, re), 3, False), acc.runs(*_disjoint(rs, re), 3, True))
    np.testing.assert_array_equal(got["cuda"][0], got["cpu"][0])
    for k in (1, 2):
        for a, b in zip(got["cuda"][k], got["cpu"][k]):
            np.testing.assert_array_equal(a, b)


def _disjoint(rs, re):
    """Sorted regions merged where they overlap or touch."""
    out_s, out_e = [int(rs[0])], [int(re[0])]
    for a, b in zip(rs[1:], re[1:]):
        if a <= out_e[-1] + 1:
            out_e[-1] = max(out_e[-1], int(b))
        else:
            out_s.append(int(a))
            out_e.append(int(b))
    return np.array(out_s), np.array(out_e)


@pytest.mark.gpu
def test_region_wrappers_refuse_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    starts = torch.zeros(1, dtype=torch.int32, device="cuda")
    offsets = torch.tensor([0, 4], dtype=torch.int64, device="cuda")
    out = torch.zeros(1, dtype=torch.int64, device="cuda")
    with pytest.raises(TypeError):
        dr.region_sums_into(torch.zeros(8, dtype=torch.int64, device="cuda"), starts, offsets, out)
    with pytest.raises(ValueError, match="aligned"):
        dr.region_sums_into(torch.zeros(9, dtype=torch.int32, device="cuda")[1:], starts,
                            offsets, out)
    with pytest.raises(TypeError):
        dr.threshold_runs(torch.zeros(8, dtype=torch.int32, device="cuda"), starts,
                          offsets.to(torch.int32), 1, False)


# ------------------------------------------------------------ C1's record form

def _regions_as_blocks(start, width, seed):
    """Merged blocks of regions of 20-300 bp every 0.5-3 kb: genomic starts,
    exclusive ends and offsets (int64 [3, n] on the card), and their span."""
    rng = np.random.default_rng(seed)
    s = start + np.cumsum(rng.integers(500, 3000, size=width // 1500))
    e = s + rng.integers(20, 300, size=len(s))
    off = np.concatenate(([0], np.cumsum(e - s)[:-1]))
    return torch.tensor(np.stack([s, e, off]), device="cuda"), int((e - s).sum())


# name: (alignment_records' arguments, chromosome, the accumulator: a box
# (start, end) or ("sparse", start, width))
RECORD_CASES = {
    "sorted, deep box": (dict(n=4000, seed=31, start=0, width=12_000), 0, (0, 12_000)),
    "a pile on a few positions": (dict(n=3000, seed=32, start=5000, width=40), 0,
                                  (4900, 5300)),
    "box edges, reads past both": (dict(n=3000, seed=33, start=0, width=30_000), 0,
                                   (9000, 21_000)),
    "unsorted, three chromosomes": (dict(n=5000, seed=34, start=0, width=30_000, n_refs=3,
                                         ordered=False), 2, (0, 30_000)),
    "sparse, long N ops": (dict(n=5000, seed=35, start=0, width=400_000, long_n=40_000), 0,
                           ("sparse", 0, 400_000)),
    "unsorted, sparse": (dict(n=5000, seed=36, start=0, width=400_000, n_refs=2,
                              ordered=False, long_n=5_000), 1, ("sparse", 0, 400_000)),
}


def _record_inputs(name, min_baseq):
    """The case's records on the card (kept: the tools' filter), its range
    of records for the chromosome, the blocks and the span."""
    from ngsbits_tpu_torch.ops import device_reduce as dr
    args, ref, geo = RECORD_CASES[name]
    cols = selfcheck.alignment_records(**args)
    keep = ((cols["flag"] & 0x704) == 0) & (cols["mapq"] >= 1)
    quals = (cols["seq_off"], cols["qual"]) if min_baseq > 0 else ()
    rec = dr.upload_records(cols["pos"], selfcheck.records_keys(cols, keep), cols["cigar_off"],
                            cols["cigar"], *quals, device="cuda")
    if geo[0] == "sparse":
        blocks, span = _regions_as_blocks(geo[1], geo[2], args["seed"])
    else:
        blocks = torch.tensor([[geo[0]], [geo[1]], [0]], device="cuda")
        span = geo[1] - geo[0]
    at = np.flatnonzero(keep & (cols["ref_id"] == ref))
    return rec, int(at[0]), int(at[-1]) + 1, ref, blocks, span


@pytest.mark.gpu
@pytest.mark.parametrize("min_baseq", [0, 20, 30])
@pytest.mark.parametrize("name", sorted(RECORD_CASES))
def test_coverage_add_records_matches_plain_version(name, min_baseq):
    """C1's record form at a few thousand records: a coordinate-sorted deep
    box, a pile on a few positions (one counter hit by many warps), reads
    past a box's edges, unsorted records of three chromosomes, a sparse
    panel with N ops over many blocks; every CIGAR op, qualities of 0xFF,
    records without SEQ, filtered records inside the range. The coverages
    are compared (a run of bases is one span on the card, unit positions in
    the plain version); one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rec, r0, r1, ref, blocks, span = _record_inputs(name, min_baseq)
    case = selfcheck.coverage_add_records_case(rec, r0, r1, ref, min_baseq, blocks, span)
    before = case.wrapper.launches
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert case.wrapper.launches == before + 1
    assert selfcheck.max_abs_err(case) == 0
    assert case.outputs()[0][0].max() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("min_baseq", [0, 20])
def test_coverage_add_records_into_one_array_on_card_matches_cpu(min_baseq):
    """Three batches of two chromosomes into one difference array each, on
    the card and on the CPU (``DeviceCoverage.add_records``, then C2's dense
    mode), a box and a sparse panel; launches counted once a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    rng = np.random.default_rng(37)
    s = np.cumsum(rng.integers(500, 3000, size=150))
    e = s + rng.integers(20, 300, size=150)
    geometries = {"box": np.array([[0], [200_000]]), "sparse": np.stack([s, e])}
    for geo in geometries.values():
        span = int((geo[1] - geo[0]).sum())
        got = {dev: dr.DeviceCoverage(span, dev, blocks=geo) for dev in ("cuda", "cpu")}
        before = dr.coverage_add_records_into.launches
        for seed in (38, 39, 40):
            cols = selfcheck.alignment_records(3000, seed=seed, start=0, width=200_000,
                                               n_refs=2, long_n=3000)
            keys = selfcheck.records_keys(cols, (cols["flag"] & 0x704) == 0)
            quals = (cols["seq_off"], cols["qual"]) if min_baseq > 0 else ()
            for dev, dc in got.items():
                rec = dr.upload_records(cols["pos"], keys, cols["cigar_off"], cols["cigar"],
                                        *quals, device=dev)
                for ref in (0, 1):
                    at = np.flatnonzero(keys == ref)
                    dc.add_records(rec, int(at[0]), int(at[-1]) + 1, ref, min_baseq)
        assert dr.coverage_add_records_into.launches == before + 6
        np.testing.assert_array_equal(got["cuda"].finalize(), got["cpu"].finalize())


@pytest.mark.gpu
def test_coverage_add_records_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    cols = selfcheck.alignment_records(100, seed=41)
    rec = dr.upload_records(cols["pos"], np.zeros(100, np.int32), cols["cigar_off"],
                            cols["cigar"], cols["seq_off"], cols["qual"], device="cuda")
    blocks = torch.tensor([[0], [20_000], [0]], device="cuda")
    diff = torch.zeros(20_001, dtype=torch.int32, device="cuda")
    before = dr.coverage_add_records_into.launches
    with pytest.raises(TypeError):
        dr.coverage_add_records_into(rec._replace(pos=rec.pos.to(torch.int64)), 0, 100, 0, 20,
                                     blocks, diff)
    with pytest.raises(TypeError):
        dr.coverage_add_records_into(rec, 0, 100, 0, 20, blocks.to(torch.int32), diff)
    with pytest.raises(ValueError, match="qualities"):
        dr.coverage_add_records_into(rec._replace(qual=None), 0, 100, 0, 20, blocks, diff)
    with pytest.raises(ValueError, match="devices"):
        dr.coverage_add_records_into(rec, 0, 100, 0, 20, blocks.cpu(), diff)
    dr.coverage_add_records_into(rec, 50, 50, 0, 20, blocks, diff)  # no records: no launch
    assert dr.coverage_add_records_into.launches == before
    assert int(diff.abs().sum()) == 0


# ------------------------------------------------------------ C1's read form

def _roi_reads(n, seed, **kw):
    """C1's read form's inputs on the card: (reads [4, k], regions [3, n],
    span), the regions as ``DeviceCoverage`` holds them."""
    from ngsbits_tpu_torch.ops import device_reduce as dr
    (_, rs, re), (_, qs, qe, i0, i1) = selfcheck.roi_reads(n, seed=seed, **kw)
    span = int((re - rs + 1).sum())
    regions = dr.DeviceCoverage(span, "cuda", regions=np.stack([rs, re])).regions
    return _t(np.stack([qs, qe, i0, i1]).astype(np.int32)), regions, span


@pytest.mark.gpu
@pytest.mark.parametrize("n,seed,kw", [
    (1, 0, {}), (31, 1, {}), (3000, 2, {}),
    (45_000, 3, dict(n_chroms=24, n_regions=2500, width=8_000_000))])
def test_coverage_add_reads_matches_plain_version(n, seed, kw):
    """C1's read form: reads at region edges, over many regions, in none,
    of no reference length, over the ROI's last region, on several
    chromosomes; at the last shape a MappingQC batch over an exome panel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = selfcheck.coverage_add_reads_case(*_roi_reads(n, seed, **kw))
    before = case.wrapper.launches
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert case.wrapper.launches == before + 1
    assert selfcheck.max_abs_err(case) == 0


@pytest.mark.gpu
def test_coverage_add_reads_spreads_long_reads_and_clamps_ranges():
    """One read over all 2,000 regions beside reads over one, so a warp's
    pairs are dealt out over many steps; ranges wider than a read (empty
    clips add nothing); ranges past ``[0, n]``, which the contract excludes
    and the wrapper alone does not check, clamped as the plain version
    clamps them: nothing is written outside the array."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    n = 2000
    rs = 1 + 20 * np.arange(n)
    re = rs + 9
    span = 10 * n
    regions = dr.DeviceCoverage(span, "cuda", regions=np.stack([rs, re])).regions
    rng = np.random.default_rng(44)
    k = 3000
    r = rng.integers(0, n, size=k)
    qs, qe = rs[r] + rng.integers(-5, 8, size=k), rs[r] + rng.integers(8, 15, size=k)
    i0, i1 = np.maximum(r - 2, 0), np.minimum(r + 3, n)   # wider than the read
    qs[::97], qe[::97], i0[::97], i1[::97] = 1, re[-1], 0, n  # over every region
    qs[5], i0[5], i1[5] = 1, -7, n + 9                        # past the contract
    reads = _t(np.stack([qs, qe, i0, i1]).astype(np.int32))
    guard = torch.full((span + 1 + 64,), 7, dtype=torch.int32, device="cuda")
    diff = guard[32:32 + span + 1]
    diff.zero_()
    want = torch.zeros(span + 1, dtype=torch.int32, device="cuda")
    dr.coverage_add_reads_into(reads, regions, diff)
    dr.coverage_add_reads_plain(reads, regions, want)
    torch.cuda.synchronize()
    assert torch.equal(diff, want)
    assert int(guard[:32].ne(7).sum()) == 0 and int(guard[32 + span + 1:].ne(7).sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("bad", [([10, 20], [60, 70], [0, -1], [1, 1]),
                                 ([10, 20], [60, 70], [0, 2], [1, 4]),
                                 ([10, 20], [60, 70], [0, 2], [1, 1]),
                                 ([10, 20], [60, 17], [0, 0], [1, 1]),
                                 ([10, 20], [60, 2**31], [0, 0], [1, 1])])
def test_out_of_contract_reads_raise_on_the_card_as_on_the_cpu(bad):
    """F7 stays closed for the read form: the same ValueError on both
    routes, before any upload, and nothing added."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    regions = np.array([[1, 101, 151], [100, 150, 200]])
    for dev in ("cuda", "cpu"):
        dc = dr.DeviceCoverage(200, dev, regions=regions)
        before = dr.coverage_add_reads_into.launches
        with pytest.raises(ValueError, match="outside the contract"):
            dc.add_reads(*(np.array(c) for c in bad))
        assert dr.coverage_add_reads_into.launches == before
        assert int(dc.diff.abs().sum()) == 0


@pytest.mark.gpu
def test_read_form_engine_on_card_matches_cpu():
    """``DeviceCoverage.add_reads`` over several batches, then C2
    (histogram and dense coverage), on the card against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    (_, rs, re), (_, qs, qe, i0, i1) = selfcheck.roi_reads(20_000, seed=45)
    span = int((re - rs + 1).sum())
    got = {}
    for dev in ("cuda", "cpu"):
        dc = dr.DeviceCoverage(span, dev, regions=np.stack([rs, re]))
        for b in range(0, len(qs), 3000):
            dc.add_reads(qs[b:b + 3000], qe[b:b + 3000], i0[b:b + 3000], i1[b:b + 3000])
        hist, half = dc.histogram(5, 599, 120, 3)
        got[dev] = (hist, half, dc.finalize())
    np.testing.assert_array_equal(got["cuda"][0], got["cpu"][0])
    assert got["cuda"][1] == got["cpu"][1]
    np.testing.assert_array_equal(got["cuda"][2], got["cpu"][2])


@pytest.mark.gpu
def test_coverage_add_reads_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    reads, regions, span = _roi_reads(100, 46)
    diff = torch.zeros(span + 1, dtype=torch.int32, device="cuda")
    before = dr.coverage_add_reads_into.launches
    with pytest.raises(TypeError):
        dr.coverage_add_reads_into(reads.to(torch.int64), regions, diff)
    with pytest.raises(ValueError, match="shape"):
        dr.coverage_add_reads_into(reads[:3], regions, diff)
    with pytest.raises(ValueError, match="contiguous"):
        dr.coverage_add_reads_into(reads.t().contiguous().t(), regions, diff)
    with pytest.raises(ValueError, match="devices"):
        dr.coverage_add_reads_into(reads, regions.cpu(), diff)
    dr.coverage_add_reads_into(reads[:, :0], regions, diff)  # no reads: no launch
    assert dr.coverage_add_reads_into.launches == before
    assert int(diff.abs().sum()) == 0


# ------------------------------------------------------------ R1's tiling

@pytest.mark.gpu
@pytest.mark.parametrize("kind", selfcheck.R1_KINDS)
def test_region_sums_match_plain_version_where_the_tiling_differs(kind):
    """R1 at the region sets its tiling treats differently
    (``selfcheck.r1_regions``): thousands of short regions (tiles of a few
    hundred positions), pieces straddling every tile edge, overlapping and
    repeated regions, regions longer than a tile, regions of one position,
    and a dense panel whose tiles of 8,192 hold many pieces each; launched
    twice on one output (the launcher clears it) and from a CUDA graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    span, rs, re = selfcheck.r1_regions(kind, seed=47)
    s, e = selfcheck.coverage_spans(span, max(span // 50, 4), seed=48, pile=700)
    cov = _cov(selfcheck.coverage_diff(s, e, span, torch.device("cuda")))
    case = selfcheck.region_sums_case(cov, rs, re)
    before = case.wrapper.launches
    case.kernel()
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert case.wrapper.launches == before + 2
    assert selfcheck.max_abs_err(case) == 0
    selfcheck.device_ms(case.kernel, calls=2, runs=1)
    torch.cuda.synchronize()
    assert selfcheck.max_abs_err(case) == 0


# ------------------------------------------------------------ B1's record form

@pytest.mark.gpu
@pytest.mark.parametrize("params", selfcheck.PILEUP_PARAMS)
@pytest.mark.parametrize("label", sorted(selfcheck.PILEUP_EDGES))
def test_pileup_add_records_matches_plain_version(label, params):
    """B1's record form at a few thousand records (sorted and unsorted,
    several chromosomes and one without loci, a pile on a few loci, long N
    ops; records without SEQ, 0xFF qualities, every CIGAR op, MAPQ 0,
    filtered records) at loci at op edges and repeated, with MAPQ-0
    counters and without, min_mapq 0, 1 and 20, min_baseq 0, 13, 20 and
    256; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = selfcheck.pileup_edge_case(label, params, torch.device("cuda"))
    before = case.wrapper.launches
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert case.wrapper.launches == before + 1
    assert selfcheck.max_abs_err(case) == 0
    if params[1] < 256:
        assert case.outputs()[0][0].max() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("track_mapq0", [False, True])
def test_pileup_engine_on_card_matches_cpu(track_mapq0):
    """Three batches into one ``DevicePileup`` on the card and on the CPU,
    fetched once: the same counts in the loci's order; one launch a
    batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    batches = [selfcheck.alignment_records(3000, seed=seed, width=50_000, n_refs=2)
               for seed in (61, 62, 63)]
    chrs, pos = selfcheck.pileup_loci(batches[0], 500, seed=64, n_refs=2, edges=200,
                                      duplicates=20)
    got = {dev: dr.DevicePileup(chrs, pos, np.array([1, 2]), track_mapq0, dev)
           for dev in ("cuda", "cpu")}
    before = dr.pileup_add_records_into.launches
    for cols in batches:
        for dev, eng in got.items():
            rec = dr.upload_records(cols["pos"], selfcheck.pileup_keys(cols, True),
                                    cols["cigar_off"], cols["cigar"], cols["seq_off"],
                                    cols["qual"], seq=cols["seq"], mapq=cols["mapq"], device=dev)
            eng.add(rec, 1, 13)
    assert dr.pileup_add_records_into.launches == before + 3
    card, cpu = got["cuda"].finalize(), got["cpu"].finalize()
    assert sorted(card) == sorted(cpu)
    for field in card:
        np.testing.assert_array_equal(card[field], cpu[field], field)
    assert card["counts"].sum() > 0 and card["dels"].sum() > 0


@pytest.mark.gpu
def test_pileup_add_records_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    cols = selfcheck.alignment_records(100, seed=65)
    rec = dr.upload_records(cols["pos"], np.zeros(100, np.int32), cols["cigar_off"],
                            cols["cigar"], cols["seq_off"], cols["qual"], seq=cols["seq"],
                            mapq=cols["mapq"], device="cuda")
    eng = dr.DevicePileup(np.ones(3), np.array([5, 9, 400]), np.array([1]), True, "cuda")
    args = (eng.loci, eng.table, 1, 13, eng.counts, eng.dels, eng.mapped, eng.mapq0)
    before = dr.pileup_add_records_into.launches
    with pytest.raises(TypeError):
        dr.pileup_add_records_into(rec._replace(mapq=rec.mapq.to(torch.int32)), *args)
    with pytest.raises(TypeError):
        dr.pileup_add_records_into(rec, eng.loci.to(torch.int64), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        dr.pileup_add_records_into(rec, eng.loci, eng.table, 1, 13, eng.counts[:2], eng.dels)
    with pytest.raises(ValueError, match="devices"):
        dr.pileup_add_records_into(rec, eng.loci.cpu(), *args[1:])
    with pytest.raises(ValueError, match="bases"):
        dr.pileup_add_records_into(rec._replace(seq=None), *args)
    empty = dr.upload_records(np.zeros(0, np.int32), np.zeros(0, np.int32),
                              np.zeros(1, np.int64), np.zeros(0, np.uint32), np.zeros(1, np.int64),
                              np.zeros(0, np.uint8), seq=np.zeros(0, np.uint8),
                              mapq=np.zeros(0, np.uint8), device="cuda")
    dr.pileup_add_records_into(empty, *args)  # no records: no launch
    assert dr.pileup_add_records_into.launches == before
    assert int(eng.out.abs().sum()) == 0


# -------------------------------------------------------------- X7, the moments

@pytest.mark.gpu
@pytest.mark.parametrize("n,kind", [
    (1, "related"), (4099, "related"), (100_003, "constant"), ((1 << 29) + 7, "all 2"),
    (100_000, "related"), (4_500_000, "related")])
def test_correlation_moments_matches_plain_version(n, kind):
    """X7 at the kernels phase's shapes: n = 1, off the 16-byte steps, a
    constant row, past 2^31 in sxx (a row of 2s), an exome's and a WGS VCF
    pair's overlap; one launch a call, the sums added into the counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.from_numpy(selfcheck.genotype_rows(n, seed=n % 997, kind=kind)).to("cuda")
    case = selfcheck.correlation_moments_case(g)
    before = case.wrapper.launches
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert case.wrapper.launches == before + 1
    assert selfcheck.max_abs_err(case) == 0
    sums = case.outputs()[0][0].tolist()
    if kind == "all 2":
        assert sums[2] == 4 * n > 2**31
    case.kernel()  # adds again
    assert case.outputs()[0][0].tolist() == [2 * s for s in sums]


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 4, 8])
def test_correlation_moments_at_rows_off_16_byte_boundaries(offset):
    """Rows that start off a 16-byte boundary take byte loads: the same
    sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    n = 70_001
    flat = torch.zeros(2 * n + offset, dtype=torch.uint8, device="cuda")
    g = flat[offset:].view(2, n)
    g.copy_(torch.from_numpy(selfcheck.genotype_rows(n, seed=offset)))
    got, want = (torch.zeros(5, dtype=torch.int64, device="cuda") for _ in range(2))
    dr.correlation_moments_into(g, got)
    dr.correlation_moments_plain(g, want)
    assert got.tolist() == want.tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4_500_000, (1 << 22) + 5])
def test_correlation_moments_at_rows_of_255(n):
    """Rows of 255s: every 16-byte step adds its most, 16 * 255^2, to a
    32-bit partial; a row's n % 16 last bytes take byte loads (n = 1, 15,
    17 and 2^22 + 5, whose second row is also off 16 bytes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.from_numpy(selfcheck.genotype_rows(n, kind="all 255")).to("cuda")
    case = selfcheck.correlation_moments_case(g)
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert selfcheck.max_abs_err(case) == 0
    assert case.outputs()[0][0].tolist() == [255 * n] * 2 + [255 * 255 * n] * 3


# one block of 256 threads, each walking 4,200 16-byte steps of each row:
# past the 4,096 after which a thread widens its 32-bit partials (a partial
# of rows of 255s would wrap after 4,128)
WIDEN_N = 16 * 256 * 4200 + 3


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["all 255", "related"])
def test_correlation_moments_past_the_widening_interval(kind):
    """X7's test entry on one block: each thread walks past the steps after
    which it widens its 32-bit partials into 64-bit totals; the sums equal
    the plain version's, and the entry counts no launch of the wrapper."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.from_numpy(selfcheck.genotype_rows(WIDEN_N, seed=7, kind=kind)).to("cuda")
    case = selfcheck.correlation_moments_case(g, grid=1)
    before = case.wrapper.launches
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert case.wrapper.launches == before
    assert selfcheck.max_abs_err(case) == 0
    if kind == "all 255":
        assert case.outputs()[0][0].tolist()[2] == 255 * 255 * WIDEN_N


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [1, 3, 7, 133, 1000])
def test_correlation_moments_on_any_grid(grid):
    """The kernel's sums do not depend on its grid: a grid of one block, of
    a few, past the card's SMs and of more blocks than 16-byte steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.from_numpy(selfcheck.genotype_rows(100_003, seed=grid)).to("cuda")
    case = selfcheck.correlation_moments_case(g, grid=grid)
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert selfcheck.max_abs_err(case) == 0


@pytest.mark.gpu
def test_correlation_moments_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    g = torch.zeros((2, 32), dtype=torch.uint8, device="cuda")
    out = torch.zeros(5, dtype=torch.int64, device="cuda")
    before = dr.correlation_moments_into.launches
    with pytest.raises(TypeError):
        dr.correlation_moments_into(g.to(torch.int32), out)
    with pytest.raises(ValueError, match="shape"):
        dr.correlation_moments_into(g[:1], out)
    with pytest.raises(TypeError):
        dr.correlation_moments_into(g, out.to(torch.int32))
    with pytest.raises(ValueError, match="devices"):
        dr.correlation_moments_into(g, out.cpu())
    dr.correlation_moments_into(g[:, :0].contiguous(), out)  # n = 0: no launch
    assert dr.correlation_moments_into.launches == before
    assert out.tolist() == [0] * 5


@pytest.mark.gpu
@pytest.mark.parametrize("n", [3, 1000, 74_321])
def test_pearson_on_card_matches_cpu(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    x, y = selfcheck.genotype_rows(n, seed=n) / 2.0
    card, cpu = (dr.pearson_from_genotypes(x, y, dev) for dev in ("cuda", "cpu"))
    assert card == cpu or (card != card and cpu != cpu)  # NaN where a row is constant


@pytest.mark.gpu
def test_f10_ties_on_the_card_print_as_the_centred_form():
    """F10's seeded exact ties and zeros through ``calculate_similarity`` on
    the card: X7 launched once a call, and the printed correlation the
    centred float64 form's (the reference's), through the tie band."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.core.basicstats import correlation
    from ngsbits_tpu_torch.ops import device_reduce as dr
    from ngsbits_tpu_torch.qc import sample_similarity as ss
    found = selfcheck.f10_overlaps(3)
    cases = found["zero"] + found["tie"]
    launches, hits = dr.correlation_moments_into.launches, ss.genotype_correlation.band_hits
    for x, y in cases:
        r = ss.calculate_similarity({f"k{i}": np.float32(v) for i, v in enumerate(x)},
                                    {f"k{i}": np.float32(v) for i, v in enumerate(y)})
        assert selfcheck.print4(r.sample_correlation) == selfcheck.print4(correlation(x, y))
    assert dr.correlation_moments_into.launches == launches + len(cases)
    assert ss.genotype_correlation.band_hits == hits + len(cases)


# ------------------------------------------------- the similarity tools on the card

SAMPLE_LENGTHS = {"chr1": 1_100_000, "chr4": 2_800_000, "chr19": 2_000_000,
                  "chrX": 4_000_000, "chrY": 3_000_000}


@pytest.fixture(scope="module")
def sample_inputs(tmp_path_factory):
    """Two BAMs of two samples over the known SNPs of a few chromosome
    prefixes (one identity SNP, SRY), two VCFs and a cfDNA panel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.utils import synth
    d = tmp_path_factory.mktemp("sample_tools_gpu")
    chrom, pos, ref, alt, af = synth.known_snvs(SAMPLE_LENGTHS)
    names = list(SAMPLE_LENGTHS)
    genome = synth.synth_genome(d / "g.fa", SAMPLE_LENGTHS, seed=71, set_bases=[
        (name, pos[chrom == k], ref[chrom == k]) for k, name in enumerate(names)])
    anchor = (af >= 0.2) & (af <= 0.8)
    a_chr = np.concatenate([chrom[anchor], [0, names.index("chrY")]])
    a_pos = np.concatenate([pos[anchor], [1014228, 2787100]]) - 1
    roi = synth.synth_roi(d / "roi.bed", genome, len(a_chr), seed=72, anchors=(a_chr, a_pos))
    for seed, name in ((73, "x.bam"), (74, "y.bam")):
        synth.synth_bam(d / name, genome, 20_000, seed=seed, roi=roi,
                        snps=(chrom, pos - 1, alt))
    synth.synth_vcfs([d / "a.vcf", d / "b.vcf"], 3000, seed=75, lengths=SAMPLE_LENGTHS)
    rows = [f"{names[c]}\t{p - 21}\t{p + 20}\tSNP_for_sample_identification:s{i}\n"
            for i, (c, p) in enumerate(zip(chrom[anchor][::2], pos[anchor][::2]))]
    rows += [f"{names[c]}\t{s}\t{e}\tgene{i}\n" for i, (c, s, e) in enumerate(zip(*roi))][::5]
    (d / "cfdna.bed").write_text("".join(rows))
    return d


SAMPLE_TOOLS = {
    "SampleSimilarity vcf": ["SampleSimilarity", "-in", "{d}/a.vcf", "{d}/b.vcf"],
    "SampleSimilarity bam": ["SampleSimilarity", "-mode", "bam", "-in", "{d}/x.bam",
                             "{d}/y.bam", "-min_cov", "10"],
    "SampleGender hetx": ["SampleGender", "-in", "{d}/x.bam", "{d}/y.bam", "-method", "hetx"],
    "SampleGender sry": ["SampleGender", "-in", "{d}/x.bam", "-method", "sry"],
    "SampleIdentity -threads 2": ["SampleIdentity", "-bams", "{d}/x.bam", "{d}/y.bam",
                                  "-min_snps", "1", "-min_depth", "5", "-min_identity", "0",
                                  "-min_correlation", "-1", "-threads", "2"],
    "CfDnaQC": ["CfDnaQC", "-bam", "{d}/x.bam", "-cfdna_panel", "{d}/cfdna.bed",
                "-tumor_bam", "{d}/y.bam", "-ref", "{d}/g.fa", "-txt"],
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SAMPLE_TOOLS))
def test_sample_tools_on_card_match_cpu(sample_inputs, tmp_path, monkeypatch, name):
    """The four tools on the card (B1's record form, X7, C1's record form,
    C2, R1) and on the CPU route: the same bytes."""
    from ngsbits_tpu_torch.__main__ import main
    outs = []
    for dev in ("cuda", "cpu"):
        monkeypatch.setenv("NGSBITS_TORCH_DEVICE", dev)
        out = tmp_path / f"{dev}.out"
        argv = [a.format(d=sample_inputs) for a in SAMPLE_TOOLS[name]] + ["-out", str(out)]
        assert main(argv) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and outs[0].count(b"\n") >= 2


# ------------------------------------------------------------- B1's indel form

@pytest.mark.gpu
@pytest.mark.parametrize("label", sorted(selfcheck.INDEL_EDGES))
def test_pileup_indels_matches_plain_version(label):
    """B1's indel form at a few thousand records (sorted and unsorted,
    several chromosomes and one without loci, a pile; I and D ops first and
    last in records, records without SEQ, MAPQ 0, filtered records) at loci
    at the window's edges and middle, just outside it and repeated, window
    0, 1 and 3, min_mapq 0, 1 and 20: the same hits; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = selfcheck.pileup_indel_edge_case(label, torch.device("cuda"))
    before = case.wrapper.launches
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert case.wrapper.launches == before + 1
    assert selfcheck.max_abs_err(case) == 0
    assert case.outputs()[0][0].shape[0] > 50


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 1, 3])
def test_indel_sweep_on_card_matches_cpu(tmp_path, monkeypatch, window):
    """``indel_pileup_at_positions`` and ``pileup_at_positions(...,
    indel_window=...)`` on the card and on the CPU over a synthetic BAM
    with germline indels, batches of 1,000 records: the same dicts and
    counts; one indel launch a batch that holds an I or D op reaching a
    locus."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.io.bam import BamReader
    from ngsbits_tpu_torch.ops import device_reduce as dr
    from ngsbits_tpu_torch.qc import pileup as pm
    from ngsbits_tpu_torch.utils import synth
    genome = synth.synth_genome(tmp_path / "g.fa", {"chr1": 600_000, "chr2": 400_000}, seed=81)
    roi = synth.synth_roi(tmp_path / "roi.bed", genome, 80, seed=82)
    trio = synth.trio_variants(genome, roi, 400, seed=83, indel_share=0.3)
    synth.synth_bam(tmp_path / "x.bam", genome, 8000, seed=84, roi=roi, snps=trio.snps(0),
                    indels=trio.indels(0))
    # each site's VCF position, the base after it (where its I or D op lies) and
    # some repeated
    chrs = np.concatenate([trio.chrom + 1, trio.chrom + 1, trio.chrom[:30] + 1])
    pos = np.concatenate([trio.pos + 1, trio.pos + 2, trio.pos[:30] + 1])
    got = {}
    for dev in ("cuda", "cpu"):
        before = dr.pileup_indels_into.launches
        monkeypatch.setenv("NGSBITS_TORCH_DEVICE", dev)
        reader = BamReader(str(tmp_path / "x.bam"), batch_records=1000)
        both = pm.pileup_at_positions("", chrs, pos, min_mapq=20, min_baseq=0,
                                      reader=reader, indel_window=window)
        reader.close()
        alone = pm.indel_pileup_at_positions(str(tmp_path / "x.bam"), chrs, pos,
                                             window=window, min_mapq=20)
        got[dev] = (both, alone, dr.pileup_indels_into.launches - before)
    (card, card_alone, launched), (cpu, cpu_alone, _) = got["cuda"], got["cpu"]
    assert card.indels == cpu.indels == card_alone == cpu_alone
    np.testing.assert_array_equal(card.counts, cpu.counts)
    np.testing.assert_array_equal(card.dels, cpu.dels)
    assert launched > 8 and sum(sum(d.values()) for d in card.indels) > 100


@pytest.mark.gpu
def test_pileup_indels_refuses_what_the_kernel_does_not_take():
    """Wrong dtypes, shapes and devices raise before a launch; a capacity
    below the hits raises after it (the kernel only counts past it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    rec, loci, table = _indel_inputs()
    out = dr.indel_out(10_000, torch.device("cuda"))
    before = dr.pileup_indels_into.launches
    with pytest.raises(TypeError):
        dr.pileup_indels_into(rec._replace(mapq=rec.mapq.to(torch.int32)), loci, table, 1, 1,
                              out)
    with pytest.raises(TypeError):
        dr.pileup_indels_into(rec, loci, table, 1, 1, out.to(torch.int32))
    with pytest.raises(ValueError, match="out"):
        dr.pileup_indels_into(rec, loci, table, 1, 1, out[:3])
    with pytest.raises(ValueError, match="devices"):
        dr.pileup_indels_into(rec, loci.cpu(), table, 1, 1, out)
    with pytest.raises(ValueError, match="window"):
        dr.pileup_indels_into(rec, loci, table, 1, -1, out)
    with pytest.raises(ValueError, match="loci range"):
        dr.pileup_indels_into(rec, loci, table, 1, 1, out, loci_range=(0, loci.shape[0] + 1))
    with pytest.raises(TypeError):
        dr.pileup_indels_into(rec, loci, table, 1, 1, out,
                              scratch=torch.zeros(2, dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError, match="devices"):
        dr.pileup_indels_into(rec, loci, table, 1, 1, out,
                              scratch=torch.zeros(2, dtype=torch.int64))
    assert dr.pileup_indels_into.launches == before
    hits = dr.pileup_indels_plain(rec, loci, table, 1, 1).shape[0]
    assert hits > 10
    with pytest.raises(RuntimeError, match="capacity"):
        dr.pileup_indels_into(rec, loci, table, 1, 1, dr.indel_out(hits - 1, torch.device("cuda")))
    assert dr.pileup_indels_into.launches == before + 1


@pytest.mark.gpu
def test_the_sweep_never_waits_on_the_batch_it_has_just_launched(tmp_path, monkeypatch):
    """VcfMerge's sweep (``pileup_at_positions``, window 1, min_mapq 20,
    min_baseq 0) over a synthetic BAM in batches of 65,536 records: no
    blocking fetch of a batch's hits while that batch is the newest one
    launched, but one at the end, after the last launch; each launch's hits
    fetched once; the same dicts and counts as the CPU route; the indel
    form's launches are one device operation each (its scratch stays
    zero)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    from ngsbits_tpu_torch.qc import pileup as pm
    from ngsbits_tpu_torch.utils import synth
    genome = synth.synth_genome(tmp_path / "g.fa", {"chr1": 3_000_000, "chr2": 2_000_000},
                                seed=87)
    roi = synth.synth_roi(tmp_path / "roi.bed", genome, 400, seed=88)
    trio = synth.trio_variants(genome, roi, 1500, seed=89, indel_share=0.3)
    synth.synth_bam(tmp_path / "x.bam", genome, 150_000, seed=90, roi=roi, snps=trio.snps(0),
                    indels=trio.indels(0))
    chrs = np.concatenate([trio.chrom + 1, trio.chrom + 1])
    pos = np.concatenate([trio.pos + 1, trio.pos + 2])
    events, engines = [], []
    add, wait = dr.DevicePileup.add, dr.IndelHits.wait

    def spy_add(self, *a, **kw):
        engines.append(self)
        got = add(self, *a, **kw)
        if got is not None:
            events.append(("launch", got))
        return got

    def spy_wait(self):
        if self.event is not None:  # a wait on the card, not a second look
            events.append(("wait", self))
        wait(self)

    got = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.setenv("NGSBITS_TORCH_DEVICE", dev)
        if dev == "cuda":
            monkeypatch.setattr(dr.DevicePileup, "add", spy_add)
            monkeypatch.setattr(dr.IndelHits, "wait", spy_wait)
        got[dev] = pm.pileup_at_positions(str(tmp_path / "x.bam"), chrs, pos, min_mapq=20,
                                          min_baseq=0, indel_window=1)
    launches = [h for kind, h in events if kind == "launch"]
    assert len(launches) >= 4
    newest, on_newest = None, []
    for i, (kind, h) in enumerate(events):
        if kind == "launch":
            newest = h
        elif h is newest:
            on_newest.append(i)
    assert on_newest == [len(events) - 1] and events[-1][1] is launches[-1]
    assert [h for kind, h in events if kind == "wait"] == launches
    assert got["cuda"].indels == got["cpu"].indels
    assert sum(sum(d.values()) for d in got["cuda"].indels) > 100
    np.testing.assert_array_equal(got["cuda"].counts, got["cpu"].counts)
    assert int(engines[-1].scratch.abs().sum()) == 0


def _indel_inputs():
    """A batch of seeded records on the card and loci around their I and D
    ops (window 1)."""
    from ngsbits_tpu_torch.ops import device_reduce as dr
    cols = selfcheck.alignment_records(2000, seed=85, width=20_000, n_refs=2)
    chrs, pos = selfcheck.indel_loci(cols, 200, seed=86, n_refs=2, window=1)
    eng = dr.DevicePileup(chrs, pos, np.array([1, 2]), device="cuda", indel_window=1,
                          count_bases=False)
    rec = dr.upload_records(cols["pos"], selfcheck.pileup_keys(cols, True), cols["cigar_off"],
                            cols["cigar"], cols["seq_off"], cols["qual"], seq=cols["seq"],
                            mapq=cols["mapq"], device="cuda")
    return rec, eng.loci, eng.table


# ------------------------------------------------------------ B1's region form

@pytest.mark.gpu
@pytest.mark.parametrize("label", sorted(selfcheck.REGION_EDGES))
def test_pileup_regions_matches_plain_version(label):
    """B1's region form at a few thousand records (sorted and unsorted,
    several chromosomes and one without regions, a pile, long N ops; I and D
    ops at regions' edges and an I and a D op at one g, records without SEQ,
    of no reference span and of MAPQ 0, filtered records) over random, long,
    overlapping and repeated regions, regions at records' spans and under
    long N ops and on a chromosome the BAM lacks: the same counters and
    hits; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = selfcheck.pileup_region_edge_case(label, torch.device("cuda"))
    before = case.wrapper.launches
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert case.wrapper.launches == before + 1
    assert selfcheck.max_abs_err(case) == 0
    assert case.outputs()[0][1].shape[0] > 100


@pytest.mark.gpu
@pytest.mark.parametrize("fragments", [False, True], ids=["reads", "-fragments"])
def test_variant_details_on_card_matches_cpu(tmp_path, monkeypatch, fragments):
    """``variant_details`` on the card and on the CPU over a synthetic BAM
    with germline SNVs and indels, batches of 1,000 records: the same
    depths, observations, frequencies and MAPQ-0 shares; one region launch
    and one record-form launch a batch that reaches a region or locus (none
    with ``-fragments``, which counts on the host)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.core.chromosome import Chromosome
    from ngsbits_tpu_torch.io.bam import BamReader
    from ngsbits_tpu_torch.io.fasta import FastaFileIndex
    from ngsbits_tpu_torch.ops import device_reduce as dr
    from ngsbits_tpu_torch.qc import pileup as pm
    from ngsbits_tpu_torch.qc import variant_details as vd
    from ngsbits_tpu_torch.utils import synth
    genome = synth.synth_genome(tmp_path / "g.fa", {"chr1": 600_000, "chr2": 400_000}, seed=91)
    roi = synth.synth_roi(tmp_path / "roi.bed", genome, 80, seed=92)
    trio = synth.trio_variants(genome, roi, 400, seed=93, indel_share=0.3)
    synth.synth_bam(tmp_path / "x.bam", genome, 8000, seed=94, roi=roi, snps=trio.snps(0),
                    indels=trio.indels(0))
    variants = [(Chromosome(genome.names[c]), *vd.gsvar_from_vcf(int(p) + 1, r, a))
                for c, p, r, a in zip(trio.chrom, trio.pos, trio.ref, trio.alt)]
    monkeypatch.setattr(pm, "BamReader", lambda path, *a, **k: BamReader(path,
                                                                         batch_records=1000))
    got = {}
    for dev in ("cuda", "cpu"):
        before = dr.pileup_regions_into.launches, dr.pileup_add_records_into.launches
        monkeypatch.setenv("NGSBITS_TORCH_DEVICE", dev)
        details = vd.variant_details(str(tmp_path / "x.bam"),
                                     FastaFileIndex(str(tmp_path / "g.fa")), variants,
                                     count_fragments=fragments)
        got[dev] = ([(d.depth, d.obs, repr(d.frequency), repr(d.mapq0_frac)) for d in details],
                    dr.pileup_regions_into.launches - before[0],
                    dr.pileup_add_records_into.launches - before[1])
    (card, regions, records), (cpu, _, _) = got["cuda"], got["cpu"]
    assert card == cpu
    assert sum(d[1] for d in card) > 500
    if fragments:
        assert regions == records == 0
    else:
        assert regions > 8 and records > 8


@pytest.mark.gpu
def test_pileup_regions_refuses_what_the_kernel_does_not_take():
    """Wrong dtypes, shapes and devices raise before a launch; a capacity
    below the hits raises after it (the kernel only counts past it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    rec, eng, capacity, _ = selfcheck.region_edge_inputs(sorted(selfcheck.REGION_EDGES)[0],
                                                         torch.device("cuda"))
    regions, table, counters = eng.regions, eng.table, eng.counters
    out = dr.region_out(capacity, torch.device("cuda"))
    before = dr.pileup_regions_into.launches
    with pytest.raises(TypeError):
        dr.pileup_regions_into(rec._replace(mapq=rec.mapq.to(torch.int32)), regions, table,
                               counters, out)
    with pytest.raises(TypeError):
        dr.pileup_regions_into(rec, regions, table, counters, out.to(torch.int32))
    with pytest.raises(ValueError, match="out"):
        dr.pileup_regions_into(rec, regions, table, counters, out[:3])
    with pytest.raises(ValueError, match="table"):
        dr.pileup_regions_into(rec, regions, table[:2], counters, out)
    with pytest.raises(ValueError, match="counters"):
        dr.pileup_regions_into(rec, regions, table, counters[:2], out)
    with pytest.raises(ValueError, match="devices"):
        dr.pileup_regions_into(rec, regions.cpu(), table, counters, out)
    with pytest.raises(ValueError, match="MAPQ"):
        dr.pileup_regions_into(rec._replace(mapq=None), regions, table, counters, out)
    assert dr.pileup_regions_into.launches == before
    hits = dr.pileup_region_pairs(rec, regions, table)[2].shape[0]
    assert hits > 10
    with pytest.raises(RuntimeError, match="capacity"):
        dr.pileup_regions_into(rec, regions, table, counters,
                               dr.region_out(hits - 1, torch.device("cuda")))
    assert dr.pileup_regions_into.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["regions", "indels"])
def test_a_launch_is_one_device_operation_and_leaves_its_scratch_zero(form):
    """The region form's and the indel form's launches queue one kernel and
    nothing else (no memset): the launch captured into a CUDA graph has one
    node; launched three times on one scratch, the scratch is zero after
    each and the hits are the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    if form == "regions":
        case = selfcheck.pileup_region_edge_case(sorted(selfcheck.REGION_EDGES)[0], dev)
        scratch = case.inputs[6]
    else:
        rec, eng, mq, window, capacity, cut = selfcheck.indel_edge_inputs(
            sorted(selfcheck.INDEL_EDGES)[0], dev)
        case = selfcheck.pileup_indels_case(rec, eng.loci, eng.table, mq, window, capacity, cut)
        scratch = case.inputs[7]
    assert selfcheck.device_ops(case.device_fn, dev) == 1
    case.plain()
    for _ in range(3):
        case.kernel()
        torch.cuda.synchronize()
        assert int(scratch.abs().sum()) == 0
        got, want = case.outputs()
        assert torch.equal(got[-1], want[-1]) and got[-1].shape[0] > 100


@pytest.mark.gpu
def test_pileup_regions_replayed_from_a_graph():
    """Three launches of the region form captured in one CUDA graph and the
    graph replayed twice: the counters are six times the plain version's,
    the hits of the last launch the plain version's and the scratch zero
    (the last block clears it, so a replay finds it clean)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    dev = torch.device("cuda")
    label = "a pile over overlapping regions"
    case = selfcheck.pileup_region_edge_case(label, dev)
    rec, regions, table, counters, out, cut, scratch, _ = case.inputs
    launch = case.device_fn
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(3):
            launch()
    counters.zero_()
    out.fill_(-1)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    want = torch.zeros_like(counters)
    hits = dr.pileup_regions_plain(rec, regions, table, want)
    assert torch.equal(counters, 6 * want)
    count = int(out[0])
    assert count == hits.shape[0] > 1000 and int(scratch.abs().sum()) == 0
    got = out[1:1 + dr.REGION_HIT * count].view(-1, dr.REGION_HIT)
    assert torch.equal(selfcheck.sorted_region_hits(got), selfcheck.sorted_region_hits(hits))


@pytest.mark.gpu
def test_many_regions_over_many_references():
    """About 6,000 reached regions over a table of 1,100 references, both at
    once: the region form gives the plain version's counters and hits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    dev = torch.device("cuda")
    cols, chrs, starts, ends, _ = selfcheck.region_edge_columns(
        "6,000 regions reached")
    eng = dr.DeviceRegions(chrs, starts, ends, np.arange(1, 1101), device=dev)
    keys = selfcheck.pileup_keys(cols, True)
    _, cut = eng.reaching(cols["pos"], selfcheck.record_ends(cols), keys)
    rec = dr.upload_records(cols["pos"], keys, cols["cigar_off"], cols["cigar"],
                            mapq=cols["mapq"], device=dev)
    assert cut[1] - cut[0] > 6000 and eng.table.shape[1] == 1100
    case = selfcheck.pileup_regions_case(rec, eng.regions, eng.table,
                                         selfcheck.region_capacity(rec, eng), cut)
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert selfcheck.max_abs_err(case) == 0
    assert case.outputs()[0][1].shape[0] > 1000


@pytest.mark.gpu
def test_the_engines_reuse_their_pinned_slots_and_grow_them():
    """``DeviceRegions.add`` over 24 batches read as the sweep reads them (a
    batch's hits after the next launch): the plain version's hits each time,
    two pinned slots in all and the device output allocated once while the
    capacity stays; a batch past the slots' and the output's size grows
    them, with the same hits; three launches held unread take three slots,
    none overwritten, and go back to the ring once their hits are read.
    ``DevicePileup.add``'s indel form the same way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    dev = torch.device("cuda")
    rec, eng, capacity, cut = selfcheck.region_edge_inputs(
        "sorted, three chromosomes, one without regions", dev)
    ops = capacity // eng.depth
    want = selfcheck.sorted_region_hits(dr.pileup_region_pairs(rec, eng.regions, eng.table)[2])
    buffers, outputs, pending = set(), set(), None
    for k in range(24):
        grow = k == 20
        got = eng.add(rec, ops * (8 if grow else 1), cut)
        buffers.add(got.slot.ptr)
        outputs.add(eng.hits_out.data_ptr())
        if pending is not None:
            assert torch.equal(selfcheck.sorted_region_hits(pending.hits()), want)
        pending = got
        if k == 19:
            assert len(buffers) == 2 and len(outputs) == 1
    assert torch.equal(selfcheck.sorted_region_hits(pending.hits()), want)
    assert len(outputs) == 2 and len(buffers) <= 4
    free = len(eng.ring.free)
    held = [eng.add(rec, ops, cut) for _ in range(free + 1)]
    assert len({h.slot.ptr for h in held}) == free + 1 and len(eng.ring.free) == 0
    for h in held:
        assert torch.equal(selfcheck.sorted_region_hits(h.hits()), want)
    assert len(eng.ring.free) == free + 1

    irec, ieng, mq, window, icap, icut = selfcheck.indel_edge_inputs(
        sorted(selfcheck.INDEL_EDGES)[0], dev)
    iops = icap // ieng.indel_depth
    iwant = selfcheck.sorted_hits(dr.pileup_indels_plain(irec, ieng.loci, ieng.table, mq, window))
    buffers, pending = set(), None
    for _ in range(12):
        got = ieng.add(irec, mq, 0, iops, icut)
        buffers.add(got.slot.ptr)
        if pending is not None:
            assert torch.equal(selfcheck.sorted_hits(pending.hits()), iwant)
        pending = got
    assert torch.equal(selfcheck.sorted_hits(pending.hits()), iwant)
    assert len(buffers) == 2 and int(ieng.scratch.abs().sum()) == 0


# ------------------------------------------------------- SomaticQC and RnaQC on the card

SOMATIC_LENGTHS = {"chr1": 1_100_000, "chr4": 2_800_000, "chr19": 2_000_000}


@pytest.fixture(scope="module")
def somatic_inputs(tmp_path_factory):
    """A tumor and a normal BAM of one person over the known SNPs of a few
    chromosome prefixes (the tumor's SNVs at an allele share of 0.25), a
    somatic VCF, the mutation burden's BEDs, and RnaQC's housekeeping BED
    and TSVs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.core.intervals import BedFile
    from ngsbits_tpu_torch.utils import synth
    d = tmp_path_factory.mktemp("somatic_gpu")
    chrom, pos, ref, alt, af = synth.known_snvs(SOMATIC_LENGTHS)
    names = list(SOMATIC_LENGTHS)
    genome = synth.synth_genome(d / "g.fa", SOMATIC_LENGTHS, seed=81, set_bases=[
        (name, pos[chrom == k], ref[chrom == k]) for k, name in enumerate(names)])
    anchor = (af >= 0.2) & (af <= 0.8)
    roi = synth.synth_roi(d / "target.bed", genome, int(anchor.sum()), seed=82,
                          anchors=(chrom[anchor], pos[anchor] - 1))
    variants = synth.somatic_variants(genome, roi, 200, seed=83, share=0.25,
                                      on_known=(chrom[anchor][:2], pos[anchor][:2]))
    germline = (chrom, pos - 1, alt, np.where(np.random.default_rng(84).random(len(chrom))
                                              < 0.6, 1, 2))
    synth.synth_bam(d / "normal.bam", genome, 20_000, seed=85, roi=roi, snps=germline)
    synth.synth_bam(d / "tumor.bam", genome, 20_000, seed=86, roi=roi, snps=germline,
                    somatic=variants.snvs())
    synth.somatic_vcf(d / "somatic.vcf", variants, genome, seed=87, flavour="strelka")
    rows = (d / "target.bed").read_text().splitlines()
    (d / "exons.bed").write_text("".join(l + "\n" for l in rows[::2]))
    (d / "tsg.bed").write_text("".join(l + "\n" for l in rows[::5]))
    (d / "blacklist.bed").write_text("".join(l + "\n" for l in rows[1::9]))
    (d / "hk.bed").write_text("".join(l + "\n" for l in rows[::10]))
    panel = BedFile.from_file(str(d / "target.bed"))
    panel.sort()
    panel.merge()
    panel.store(str(d / "roi.bed"))
    synth.rna_tsvs(d / "splicing.tsv", d / "expression.tsv", 300, seed=88)
    return d


_SOMATIC = ["SomaticQC", "-tumor_bam", "{d}/tumor.bam", "-normal_bam", "{d}/normal.bam",
            "-somatic_vcf", "{d}/somatic.vcf", "-ref", "{d}/g.fa"]
SOMATIC_TOOLS = {
    # name: (arguments, values the card's report must show as a number)
    "SomaticQC target tmb": (_SOMATIC + ["-target_bed", "{d}/target.bed", "-target_exons",
                                         "{d}/exons.bed", "-blacklist", "{d}/blacklist.bed",
                                         "-tsg_bed", "{d}/tsg.bed"],
                             ["sample correlation", "tumor content estimate"]),
    "SomaticQC no target": (_SOMATIC, ["tumor content estimate"]),
    "RnaQC": (["RnaQC", "-bam", "{d}/tumor.bam", "-ref", "{d}/g.fa", "-housekeeping_genes",
               "{d}/hk.bed", "-roi", "{d}/roi.bed", "-splicing", "{d}/splicing.tsv",
               "-expression", "{d}/expression.tsv"], ["housekeeping genes read depth"]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SOMATIC_TOOLS))
def test_somatic_tools_on_card_match_cpu(somatic_inputs, tmp_path, monkeypatch, name):
    """SomaticQC (B1's record form, one sweep a BAM) and RnaQC (C1's read
    form, C2) on the card and on the CPU route: the same qcML but for its
    ``creation `` line, the card's run launched its kernels, and its report
    reads a number where the tool's device work feeds it (with a target,
    both halves of SomaticQC's split sweep: the genotypes and the SNVs)."""
    from ngsbits_tpu_torch.__main__ import main
    from ngsbits_tpu_torch.ops import KERNELS
    outs = []
    for dev in ("cuda", "cpu"):
        monkeypatch.setenv("NGSBITS_TORCH_DEVICE", dev)
        for k in KERNELS:
            k.launches = 0
        out = tmp_path / f"{dev}.qcML"
        args, numbers = SOMATIC_TOOLS[name]
        argv = [a.format(d=somatic_inputs) for a in args] + ["-out", str(out)]
        assert main(argv) == 0
        launched = {k.__name__ for k in KERNELS if k.launches}
        outs.append([l for l in out.read_text().splitlines() if "creation " not in l])
        if dev == "cuda":
            assert launched == ({"coverage_add_reads_into", "coverage_finalize_into"}
                                if name == "RnaQC" else {"pileup_add_records_into"})
            for value in numbers:
                line = next(l for l in outs[-1] if f'name="{value}"' in l)
                assert 'value="n/a' not in line, line
        else:
            assert not launched
    assert outs[0] == outs[1]


# ------------------------------------------------------------------ the mesh

@pytest.mark.gpu
def test_mesh_world_of_one_on_nccl():
    """``dryrun_multichip(1)`` on the card: an NCCL group of one rank runs the
    five steps, each held against the same kernels on the whole input inside
    the rank, and each step launched its kernels (K1, C1's span form and C2,
    K2, X7)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch import entry
    (record,) = entry.dryrun_multichip(1, timeout=300)
    assert record["backend"] == "nccl" and record["device"] == "cuda:0"
    launched = {s["step"]: set(s["launches"]) for s in record["steps"]}
    assert launched["sharded_readqc_step"] == {"readqc_batch"}
    assert launched["sharded_coverage_step"] == {"coverage_add", "coverage_finalize"}
    assert launched["sharded_insert_scan"] == {"insert_scan"}
    assert launched["sharded_correlation_step uint8"] == {"correlation_moments"}


@pytest.mark.gpu
def test_mesh_tool_at_a_world_of_one_on_nccl_matches_the_card(tmp_path, monkeypatch):
    """ReadQC -out1 with ``NGSBITS_MESH=1`` in this process: an NCCL group of
    one that meets after each batch (``mesh.in_step``), the same report and
    reads as without the mesh, the group left afterwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.__main__ import main
    from ngsbits_tpu_torch.parallel import mesh
    from ngsbits_tpu_torch.utils import synth
    synth.synth_fastq(tmp_path / "r.fastq.gz", 3001, 151, seed=31)
    monkeypatch.setenv("NGSBITS_TORCH_DEVICE", "cuda")
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", mesh.INIT_ENV, mesh.BACKEND_ENV):
        monkeypatch.delenv(var, raising=False)
    reports = []
    for flag in ("0", "1"):
        monkeypatch.setenv("NGSBITS_MESH", flag)
        out = tmp_path / f"mesh{flag}.qcML"
        reads = tmp_path / f"mesh{flag}.fastq.gz"
        before = mesh.COUNTS["all_reduce"]
        assert main(["ReadQC", "-in1", str(tmp_path / "r.fastq.gz"), "-out", str(out),
                     "-out1", str(reads)]) == 0
        assert (mesh.COUNTS["all_reduce"] > before) == (flag == "1")
        assert not mesh.active()
        reports.append([l for l in out.read_text().splitlines() if "creation " not in l])
        reports.append(gzip.decompress(reads.read_bytes()))
    assert reports[0] == reports[2]
    assert reports[1] == reports[3] == gzip.decompress((tmp_path / "r.fastq.gz").read_bytes())


@pytest.mark.gpu
def test_mesh_path_wrappers_skip_the_launch_at_zero_rows():
    """Every wrapper on the mesh path, given zero rows on the card: no launch,
    no error, every output as it was."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import KERNELS
    from ngsbits_tpu_torch.ops import device_reduce as dr
    from ngsbits_tpu_torch.ops import pallas_kernels as pk
    from ngsbits_tpu_torch.ops import readqc as ops_readqc
    dev = torch.device("cuda")
    before = {k.__name__: k.launches for k in KERNELS}
    u8 = torch.zeros((0, 64), dtype=torch.uint8, device=dev)
    i32 = torch.zeros(0, dtype=torch.int32, device=dev)
    carry = ops_readqc.stream_carry_init(64, dev)
    sums = {k: v.clone() for k, v in carry.items()}
    pk.readqc_unpack_into(torch.zeros((0, 16), dtype=torch.uint8, device=dev),
                          torch.zeros((0, 8), dtype=torch.uint8, device=dev),
                          torch.zeros((0, 48), dtype=torch.uint8, device=dev), 6, u8, u8.clone())
    pk.readqc_batch_into(u8, u8.clone(), i32, carry["counts5"], carry["qsum1"], carry["qhist"],
                         i32.clone())
    pk.readqc_tails_into(i32, i32.clone(), 0, 0, carry)
    m = torch.zeros((0, 64), dtype=pk.INSERT_COUNT, device=dev)
    pk.insert_scan_into(u8, u8.clone(), i32, m, m.clone())
    diff = torch.zeros(65, dtype=torch.int32, device=dev)
    dr.coverage_add_into(i32, i32.clone(), diff)
    dr.coverage_add_reads_into(torch.zeros((4, 0), dtype=torch.int32, device=dev),
                               torch.tensor([[1], [64], [0]], dtype=torch.int32, device=dev),
                               diff)
    rec = dr.upload_records(np.zeros(2, np.int32), np.zeros(2, np.int32), np.array([0, 1, 2]),
                            np.full(2, 10 << 4, np.uint32), np.array([0, 10, 20]),
                            np.full(20, 40, np.uint8), device=dev)
    blocks = torch.tensor([[0], [64], [0]], dtype=torch.int64, device=dev)
    for baseq in (0, 20):
        dr.coverage_add_records_into(rec, 1, 1, 0, baseq, blocks, diff)
    moments = torch.full((5,), 7, dtype=torch.int64, device=dev)
    dr.correlation_moments_into(torch.zeros((2, 0), dtype=torch.uint8, device=dev), moments)
    torch.cuda.synchronize()
    assert {k.__name__: k.launches for k in KERNELS} == before
    assert not diff.any() and moments.tolist() == [7] * 5
    assert all(torch.equal(carry[k], sums[k]) for k in carry)


# ------------------------------------------------- VariantQC and RohHunter on the card

@pytest.mark.gpu
@pytest.mark.parametrize("index", range(8))
def test_variant_classify_matches_plain_version(index):
    """V1 at ``selfcheck.variant_cases``: ``VARIANT_EDGES`` (an INFO over 64
    KiB among them), no records, the seam records, 20,000 random records;
    with and without the FILTER test. Counts equal; one launch, none for no
    records."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    label, case = selfcheck.variant_cases(torch.device("cuda"), seed=index)[index]
    before = case.wrapper.launches
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert case.wrapper.launches == before + (0 if label.startswith("no records") else 1)
    assert selfcheck.max_abs_err(case) == 0, label


@pytest.mark.gpu
@pytest.mark.parametrize("filter_", [True, False])
@pytest.mark.parametrize("kind", [*selfcheck.SEAM_KINDS, "long INFO", "long FORMAT"])
def test_variant_classify_at_each_seam_kind(kind, filter_):
    """V1 on each kind of ``selfcheck.variant_seams`` alone: a pattern, key
    or field at every offset of a 16-byte chunk and across the 512-byte
    step in which a warp reads a record, after leading records of every
    alignment; INFOs of 511, 512, 513 and 1,025 bytes; FORMATs and samples
    past the 64 bytes of them the kernel copies a record (the rest read from
    the buffer). Counts equal to the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import variants as vops
    data, offsets = (t.cuda() for t in vops.pack_fields(selfcheck.variant_seams(kind)))
    case = selfcheck.variant_classify_case(data, offsets, filter_)
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert selfcheck.max_abs_err(case) == 0


@pytest.mark.gpu
def test_variant_classify_on_a_record_over_a_gibibyte():
    """V1 on a record whose INFO runs past 2^30 bytes between two short
    records: its offsets from its first chunk pass the kernel's 32-bit clamp,
    and its base moves on twice (every 2^29 bytes); "|rs" and "|HIGH|" at
    the CSQ value's end, then an RS value. Counts equal to the plain
    version's, with and without the FILTER test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import variants as vops
    short = (b"A", b"G", b"PASS", b"CSQ=A|x|LOW|", b"GT", b"0/1")
    long_info = b"CSQ=" + b"x" * ((1 << 30) + 4093) + b"|rs|HIGH|;RS=rs7"
    recs = [short, (b"C", b"T", b"PASS", long_info, b"DP:GT", b"9:1|1"), short]
    data, offsets = (t.cuda() for t in vops.pack_fields([list(c) for c in zip(*recs)]))
    for filter_ in (True, False):
        case = selfcheck.variant_classify_case(data, offsets, filter_)
        case.kernel()
        case.plain()
        torch.cuda.synchronize()
        assert selfcheck.max_abs_err(case) == 0
        assert case.outputs()[0][0].tolist()[:4] == [3, 1, 1, 1]


@pytest.mark.gpu
def test_variant_classify_on_records_past_the_grid():
    """V1 on more records than its grid has warps (each warp a range of
    records, in groups of 32), from an unaligned-length buffer padded by
    ``pack_fields``, and its refusals of an unaligned buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.ops import variants as vops
    cols = selfcheck.variant_fuzz(400_000, seed=9)
    data, offsets = (t.cuda() for t in vops.pack_fields(cols))
    for filter_ in (True, False):
        case = selfcheck.variant_classify_case(data, offsets, filter_)
        case.kernel()
        case.plain()
        torch.cuda.synchronize()
        assert selfcheck.max_abs_err(case) == 0
    out = torch.zeros(len(vops.COUNTERS), dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError, match="aligned"):
        vops.variant_classify_into(data[16:][1:-15], offsets, True, out)


@pytest.mark.gpu
@pytest.mark.parametrize("index", range(2))
def test_roh_products_match_plain_version_bit_for_bit(index):
    """H1 at ``selfcheck.roh_cases``: single markers, the whole array, af 0,
    products that go subnormal and underflow to 0, an empty range, ranges
    outside the array (NaN); the early exit's edges (products of 0 or +inf
    meeting a later +inf, 0 or NaN square at every place the exit cares for,
    NaN af with payloads and signs, -0.0, -inf, 4,000 markers at af 1.0,
    every offset of a 32-marker chunk); no range (no launch). Bit patterns
    equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    label, case = selfcheck.roh_cases(torch.device("cuda"), seed=3)[index]
    before = case.wrapper.launches
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    assert case.wrapper.launches == before + (index == 0)
    assert selfcheck.max_abs_err(case) == 0, label
    if index == 0:
        got = case.outputs()[0][0].view(torch.float64)
        assert (got == 0).any() and ((got > 0) & (got < 2.2250738585072014e-308)).any()


@pytest.fixture(scope="module")
def roh_inputs(tmp_path_factory):
    """A WGS-shaped VCF over three chromosome prefixes (about 4,300
    records, five planted ROH segments) and RohHunter's BEDs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsbits_tpu_torch.utils import synth
    d = tmp_path_factory.mktemp("variants_gpu")
    lengths = {"chr1": 1_500_000, "chr2": 1_000_000, "chrX": 500_000}
    segments = synth.wgs_vcf(d / "wgs.vcf", lengths, seed=91, n_roh=(5, 5),
                             roh_size=(100_000, 400_000))
    synth.roh_beds(d / "exclude.bed", [d / "a.bed", d / "b.bed"], lengths, segments, seed=92)
    synth.roh_af_vcf(d / "af_inf.vcf", "inf", 450, seed=93)
    return d


VARIANT_TOOLS = {
    # name: (arguments, outputs, kernels launched on the card)
    "VariantQC": (["VariantQC", "-in", "{d}/wgs.vcf", "-out", "{o}/out.qcML"], ["out.qcML"],
                  {"variant_classify_into": 1}),
    "VariantQC -txt -ignore_filter": (["VariantQC", "-in", "{d}/wgs.vcf", "-txt",
                                       "-ignore_filter", "-out", "{o}/out.txt"], ["out.txt"],
                                      {"variant_classify_into": 1}),
    "VariantQC -long_read": (["VariantQC", "-in", "{d}/wgs.vcf", "-long_read", "-phasing_bed",
                              "{o}/blocks.bed", "-out", "{o}/out.qcML"],
                             ["out.qcML", "blocks.bed"], {"variant_classify_into": 1}),
    "RohHunter -var_af_keys_vep -exclude -annotate": (
        ["RohHunter", "-in", "{d}/wgs.vcf", "-var_af_keys_vep", "gnomAD_AF,AF", "-exclude",
         "{d}/exclude.bed", "-annotate", "{d}/a.bed", "{d}/b.bed", "-out", "{o}/roh.tsv"],
        ["roh.tsv"], {"roh_products_into": 2}),
    "RohHunter -var_af_keys -inc_chrx": (
        ["RohHunter", "-in", "{d}/wgs.vcf", "-var_af_keys", "AF", "-inc_chrx", "-out",
         "{o}/roh.tsv"], ["roh.tsv"], {"roh_products_into": 2}),
    # QD read as an AF: products overflow to +inf, Q below 0, no raw run
    # kept, so no final region and no second launch
    "RohHunter af above 1": (
        ["RohHunter", "-in", "{d}/wgs.vcf", "-var_af_keys", "AF,QD", "-out", "{o}/roh.tsv"],
        ["roh.tsv"], {"roh_products_into": 1}),
    # an AF of inf after the last run's product reached 0: NaN, the run dropped
    "RohHunter af inf after 0": (
        ["RohHunter", "-in", "{d}/af_inf.vcf", "-var_af_keys", "AF", "-out", "{o}/roh.tsv"],
        ["roh.tsv"], {"roh_products_into": 2}),
}
HEADER_ONLY = {"RohHunter af above 1"}   # outputs with no region


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(VARIANT_TOOLS))
def test_variant_tools_on_card_match_cpu(roh_inputs, tmp_path, monkeypatch, name):
    """VariantQC (one V1 launch) and RohHunter (two H1 launches: the raw
    runs, the final regions; also with af above 1 and with an AF of inf
    after a run's product reached 0) on the card and on the CPU route: the
    same bytes (qcML without its ``creation `` line)."""
    from ngsbits_tpu_torch.__main__ import main
    from ngsbits_tpu_torch.ops import KERNELS
    args, outputs, launches = VARIANT_TOOLS[name]
    got = []
    for dev in ("cuda", "cpu"):
        monkeypatch.setenv("NGSBITS_TORCH_DEVICE", dev)
        for k in KERNELS:
            k.launches = 0
        o = tmp_path / dev
        o.mkdir()
        assert main([a.format(d=roh_inputs, o=o) for a in args]) == 0
        got.append([[l for l in (o / n).read_text().splitlines() if "creation " not in l]
                    for n in outputs])
        assert {k.__name__: k.launches for k in KERNELS if k.launches} == \
            (launches if dev == "cuda" else {})
    assert got[0] == got[1]
    assert len(got[0][0]) == 1 if name in HEADER_ONLY else len(got[0][0]) > 3
