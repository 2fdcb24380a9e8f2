"""The port's SeqPurge scans (plain torch versions on the CPU) must equal the
JAX package's functions on the same inputs: the Pallas K2 in interpret mode,
the XLA scans and the host (numpy) scans. Every output is an integer count,
so the tolerance is exact equality.

Inputs are made with numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ngsbits_tpu.ops import pallas_kernels as jpk
from ngsbits_tpu.ops import seqpurge as jsp
from ngsbits_tpu_torch.ops import KERNELS, selfcheck
from ngsbits_tpu_torch.ops import pallas_kernels as tpk
from ngsbits_tpu_torch.ops import seqpurge as tsp

ACGTN = np.frombuffer(b"ACGTN", dtype=np.uint8)
A1 = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
A2 = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_equal(got, want, names):
    for g, w, name in zip(got, want, names):
        g = g.numpy()
        assert g.dtype == np.int32, name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


def _scan_inputs(B, L, seed):
    """As tests/test_pallas_kernels.py: random bases with N, half the pairs
    truly overlapping, min_len in [1, L]."""
    rng = np.random.default_rng(seed)
    seq1 = rng.choice(ACGTN, size=(B, L))
    seq2 = rng.choice(ACGTN, size=(B, L))
    seq2[: B // 2, : L // 2] = seq1[: B // 2, L // 2:]
    min_len = rng.integers(1, L + 1, size=(B,)).astype(np.int32)
    return seq1, seq2, min_len


@pytest.mark.parametrize("B,L", [(16, 100), (8, 64)])
def test_insert_scan_matches_pallas_interpret(B, L):
    seq1, seq2, min_len = _scan_inputs(B, L, seed=L)
    want = jpk.insert_scan_pallas(seq1, seq2, min_len, interpret=True)
    got = tsp.insert_scan(*_t(seq1, seq2, min_len))
    _assert_equal(got, want, ["matches", "mismatches"])


def _overlapping_pairs(B, L, seed, ragged=True):
    """Read pairs of a short-insert library, padded to one width L as the
    engine pads them: read 2 is the reverse complement of read 1's fragment
    for two pairs in three, with ~1% substitutions and ~2% N; lengths are
    ragged (some 0, some below 10) or full."""
    rng = np.random.default_rng(seed)
    comp = np.zeros(256, np.uint8)
    for a, c in zip(b"ACGTN", b"TGCAN"):
        comp[a] = c
    len1 = (rng.integers(0, L + 1, size=B) if ragged
            else np.full(B, L)).astype(np.int32)
    len2 = (rng.integers(0, L + 1, size=B) if ragged
            else np.full(B, L)).astype(np.int32)
    if ragged:
        len1[:3] = 0
        len2[3:6] = rng.integers(1, 10, size=3)
    read1 = rng.choice(ACGTN, size=(B, L), p=[0.245] * 4 + [0.02])
    read2 = rng.choice(ACGTN, size=(B, L), p=[0.245] * 4 + [0.02])
    for b in range(0, B, 3):
        n = int(min(len1[b], len2[b]))
        insert = int(rng.integers(0, n + 1))
        read2[b, :insert] = comp[read1[b, :insert][::-1]]
    sub = rng.random(size=(B, L)) < 0.01
    read2[sub] = rng.choice(ACGTN, size=int(sub.sum()))
    pos = np.arange(L)[None, :]
    read1 = np.where(pos < len1[:, None], read1, 0).astype(np.uint8)
    read2 = np.where(pos < len2[:, None], read2, 0).astype(np.uint8)
    idx2 = len2[:, None] - 1 - pos
    seq2rc = np.where(idx2 >= 0, comp[read2[np.arange(B)[:, None],
                                            np.maximum(idx2, 0)]], 0).astype(np.uint8)
    min_len = np.minimum(len1, len2)
    return read1, read2, seq2rc, len1, len2, min_len


@pytest.mark.parametrize("ragged", [True, False])
def test_insert_scan_matches_xla_and_host(ragged):
    read1, _, seq2rc, _, _, min_len = _overlapping_pairs(300, 120, 3, ragged)
    got = tsp.insert_scan(*_t(read1, seq2rc, min_len))
    names = ["matches", "mismatches"]
    _assert_equal(got, jsp.insert_scan(read1, seq2rc, min_len), names)
    _assert_equal(got, jsp.insert_scan_host(read1, seq2rc, min_len), names)
    assert int(got[0].max()) > 20   # some pairs really overlap


def _insert_rows(kind, seed):
    """Rows for K2's int16 counts: ``one_base``, one base repeated on both
    sides at L=300 (a few N), so counts pass 255 and a byte-wide count
    would wrap; ``any_byte``, bytes 0..255 on both sides, half the pairs
    overlapping at a random offset; ``edges``, ``selfcheck.insert_edge_pairs``
    (min_len -1, 0, above L and int32's largest, all-N pairs, random bytes
    past min_len)."""
    rng = np.random.default_rng(seed)
    if kind == "edges":
        return selfcheck.insert_edge_pairs(61, 130, seed)
    if kind == "one_base":
        B, L = 24, 300
        seq1 = np.full((B, L), ord("G"), np.uint8)
        seq2rc = np.full((B, L), ord("G"), np.uint8)
        seq1[rng.random((B, L)) < 0.01] = ord("N")
        seq2rc[rng.random((B, L)) < 0.01] = ord("N")
        min_len = rng.integers(L - 20, L + 1, size=B).astype(np.int32)
        return seq1, seq2rc, min_len
    B, L = 50, 90
    seq1 = rng.integers(0, 256, size=(B, L)).astype(np.uint8)
    seq2rc = rng.integers(0, 256, size=(B, L)).astype(np.uint8)
    for b in range(0, B, 2):
        o = int(rng.integers(0, L))
        seq2rc[b, o:] = seq1[b, :L - o]
    min_len = rng.integers(0, L + 1, size=B).astype(np.int32)
    return seq1, seq2rc, min_len


@pytest.mark.parametrize("kind", ["one_base", "any_byte", "edges"])
def test_int16_insert_scan_matches_xla_and_host(kind):
    """K2's plain version into int16 outputs, as the engine gives them,
    against the JAX package's XLA scan and host scan."""
    seq1, seq2rc, min_len = _insert_rows(kind, seed=len(kind))
    B, L = seq1.shape
    got = [torch.empty((B, L), dtype=torch.int16) for _ in range(2)]
    tpk.insert_scan_into(*_t(seq1, seq2rc, min_len), *got)
    names = ["matches", "mismatches"]
    for want in (jsp.insert_scan(seq1, seq2rc, min_len),
                 jsp.insert_scan_host(seq1, seq2rc, min_len)):
        for g, w, name in zip(got, want, names):
            assert g.dtype == torch.int16, name
            np.testing.assert_array_equal(g.numpy().astype(np.int32), np.asarray(w),
                                          err_msg=name)
    if kind == "one_base":
        assert int(got[0].max()) > 255
    else:
        assert int(got[0].max()) > 20   # some pairs really overlap


# adapter windows: the defaults, and variants with N and shorter adapters
_A_CASES = {
    "default": (A1, A2),
    "with_n": (b"AGANCGGAAGNGCACACGTC", b"NGATCGGAAGAGCGTCGTGN"),
    "short15": (A1[:15], A2[:15]),
}


@pytest.mark.parametrize("adapters", sorted(_A_CASES))
@pytest.mark.parametrize("overlap", [10, 15])
def test_adapter_evidence_matches_xla_and_host(adapters, overlap):
    a1, a2 = _A_CASES[adapters]
    read1, read2, _, len1, len2, _ = _overlapping_pairs(257, 90, overlap)
    w1 = np.frombuffer(a1[:overlap], dtype=np.uint8)
    w2 = np.frombuffer(a2[:overlap], dtype=np.uint8)
    got = tsp.adapter_evidence(*_t(read1, read2, len1, len2), a1[:overlap],
                               a2[:overlap])
    names = ["m1", "mm1", "m2", "mm2"]
    _assert_equal(got, jsp.adapter_evidence(read1, read2, len1, len2, w1, w2,
                                            overlap), names)
    _assert_equal(got, jsp.adapter_evidence_host(read1, read2, len1, len2, w1,
                                                 w2, overlap), names)


@pytest.mark.parametrize("adapters", sorted(_A_CASES))
@pytest.mark.parametrize("a_size", [15, 20])
def test_adapter_scan_matches_xla_and_host(adapters, a_size):
    a1, _ = _A_CASES[adapters]
    a_size = min(a_size, len(a1))
    read, _, _, length, _, _ = _overlapping_pairs(211, 151, a_size)
    adapter = np.frombuffer(a1, dtype=np.uint8)
    got = tsp.adapter_scan(*_t(read, length), a1[:a_size])
    names = ["matches", "mismatches"]
    _assert_equal(got, jsp.adapter_scan(read, length, adapter, a_size), names)
    _assert_equal(got, jsp.adapter_scan_host(read, length, adapter, a_size), names)


def _edge_pairs(L, seed):
    """The card's edge inputs (``selfcheck.pairs`` with ``dirty``: random
    bytes past the lengths, all-N pairs), with zero lengths and read 2
    shorter than a window of 10 in the first rows."""
    read1, read2, _, len1, len2, _ = selfcheck.pairs(97, L, seed, dirty=True)
    len1[:3] = 0
    len2[3:6] = np.minimum([0, 4, 9], L)
    return read1, read2, len1, len2


# (L, window or adapter prefix): windows of 1 and 64 bases, L below the window
_EDGES = [(90, 1), (90, 64), (40, 64), (7, 10), (1, 20)]


@pytest.mark.parametrize("L,size", _EDGES)
def test_adapter_evidence_at_the_edges(L, size):
    """Zero lengths, read 2 shorter than the window, random bytes past the
    lengths, adapters of 64 bases with N."""
    read1, read2, len1, len2 = _edge_pairs(L, L * size)
    a1 = bytes(ord("N") if i % 9 == 4 else c for i, c in enumerate((A1 + A2)[:size]))
    a2 = (A2 + A1)[:size]
    w1, w2 = (np.frombuffer(a, dtype=np.uint8) for a in (a1, a2))
    got = tsp.adapter_evidence(*_t(read1, read2, len1, len2), a1, a2)
    names = ["m1", "mm1", "m2", "mm2"]
    _assert_equal(got, jsp.adapter_evidence(read1, read2, len1, len2, w1, w2, size), names)
    _assert_equal(got, jsp.adapter_evidence_host(read1, read2, len1, len2, w1, w2, size),
                  names)


@pytest.mark.parametrize("L,size", _EDGES)
def test_adapter_scan_at_the_edges(L, size):
    """As above for the adapter-prefix scan. The JAX package's host scan
    takes only prefixes of at most L + 1 bases (past that its shifted slices
    no longer line up), so it is held to them there; the XLA scan always."""
    read, _, length, _ = _edge_pairs(L, L + size)
    adapter = bytes(ord("N") if i % 9 == 4 else c for i, c in enumerate((A1 + A2)[:size]))
    ad = np.frombuffer(adapter, dtype=np.uint8)
    got = tsp.adapter_scan(*_t(read, length), adapter)
    names = ["matches", "mismatches"]
    _assert_equal(got, jsp.adapter_scan(read, length, ad, size), names)
    if size <= L + 1:
        _assert_equal(got, jsp.adapter_scan_host(read, length, ad, size), names)


def _full_count_rows(adapter: bytes, L: int = 90, at: int = 20):
    """Rows at the adapter scans' largest counts, N outside ``at`` .. ``at``
    + 63: the whole 64-base adapter (64 matches at one offset), the adapter
    with every base changed (64 mismatches), all N, and a row of length 0."""
    a = np.frombuffer(adapter, np.uint8)
    shifted = np.zeros(256, np.uint8)
    for x, y in zip(b"ACGT", b"CGTA"):
        shifted[x] = y
    rows = np.full((4, L), ord("N"), np.uint8)
    rows[0, at:at + len(a)] = a
    rows[1, at:at + len(a)] = shifted[a]
    rows[3] = 0
    return rows, np.array([L, L, L, 0], np.int32)


@pytest.mark.parametrize("kernel", ["adapter_evidence", "adapter_scan"])
def test_one_byte_adapter_counts_at_their_largest(kernel):
    """The plain versions into one-byte outputs, as the engine gives them,
    against the JAX package's int32 XLA and host scans, where counts reach
    64: a 64-base adapter (window or prefix), reads that hold it whole,
    all-N rows and a row of length 0."""
    a1, a2 = (A1 + A2)[:64], (A2 + A1)[:64]
    read1, len1 = _full_count_rows(a1)
    read2, len2 = _full_count_rows(a2)
    B, L = read1.shape
    w1, w2 = (np.frombuffer(a, dtype=np.uint8) for a in (a1, a2))
    if kernel == "adapter_evidence":
        got = [torch.empty((B, L), dtype=tsp.ADAPTER_COUNT) for _ in range(4)]
        tsp.adapter_evidence_into(*_t(read1, read2, len1, len2), a1, a2, *got)
        wants = [jsp.adapter_evidence(read1, read2, len1, len2, w1, w2, 64),
                 jsp.adapter_evidence_host(read1, read2, len1, len2, w1, w2, 64)]
    else:
        got = [torch.empty((B, L), dtype=tsp.ADAPTER_COUNT) for _ in range(2)]
        tsp.adapter_scan_into(*_t(read1, len1), a1, *got)
        wants = [jsp.adapter_scan(read1, len1, w1, 64),
                 jsp.adapter_scan_host(read1, len1, w1, 64)]
    for want in wants:
        for g, w in zip(got, want):
            assert g.dtype == torch.uint8
            np.testing.assert_array_equal(g.numpy().astype(np.int32), np.asarray(w))
    assert all(int(g.max()) == 64 for g in got)


def test_scans_of_an_empty_batch():
    e8 = torch.zeros((0, 40), dtype=torch.uint8)
    e32 = torch.zeros(0, dtype=torch.int32)
    for out in (tsp.insert_scan(e8, e8, e32),
                tsp.adapter_evidence(e8, e8, e32, e32, A1[:10], A2[:10]),
                tsp.adapter_scan(e8, e32, A1[:20])):
        assert all(t.shape == (0, 40) and t.dtype == torch.int32 for t in out)


def test_cpu_tensors_take_plain_version_without_counting():
    before = [k.launches for k in KERNELS]
    read1, read2, seq2rc, len1, len2, min_len = _overlapping_pairs(40, 64, 1)
    tsp.insert_scan(*_t(read1, seq2rc, min_len))
    tsp.adapter_evidence(*_t(read1, read2, len1, len2), A1[:10], A2[:10])
    tsp.adapter_scan(*_t(read1, len1), A1[:20])
    assert [k.launches for k in KERNELS] == before
    assert len(KERNELS) == 15


def test_wrappers_refuse_other_devices_and_long_adapters():
    t = torch.zeros((4, 64), dtype=torch.uint8, device="meta")
    n = torch.zeros(4, dtype=torch.int32, device="meta")
    o = torch.zeros((4, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device type"):
        tsp.insert_scan_into(t, t, n, o, o)
    with pytest.raises(ValueError, match="device type"):
        tsp.adapter_scan_into(t, n, A1[:20], o, o)
    cpu = torch.zeros((4, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="different devices"):
        tsp.adapter_evidence_into(cpu, t, n, n, A1[:10], A2[:10], o, o, o, o)
    with pytest.raises(ValueError, match="at most"):
        tsp.adapter_scan_into(cpu, torch.zeros(4, dtype=torch.int32), b"A" * 65,
                              torch.zeros((4, 64), dtype=torch.int32),
                              torch.zeros((4, 64), dtype=torch.int32))
