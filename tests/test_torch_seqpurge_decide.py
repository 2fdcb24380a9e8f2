"""SeqPurge's per-pair decisions in the port (``ops/seqpurge.py``: the plain
version of ``seqpurge_decide``, which the engine runs on the CPU) against the
JAX package's engine on both of its routes (native C++, and numpy with
``NGSBITS_SEQPURGE_NO_NATIVE=1``), at their edges: ties in the insert
p-value (equal binomial tails at two offsets, and tails that underflow to 0
at many), overlaps of 0, 1 and 2 bases, all-N pairs, reads shorter than the
quality window and the N run, ``-qcut 0`` and ``-ncut 0``, adapters with N,
rows wider than 512 bases, each with and without ``-ec``. New lengths,
counters, histograms and corrected reads are exact; the one float sum is
exact against the numpy route and within 1e-9 of the native route, whose
C++ sums in another order."""

import numpy as np
import pytest
import torch

from ngsbits_tpu.core.basicstats import match_probability_table as jax_table
from ngsbits_tpu.io.fastq import FastqBatch as JaxFastqBatch
from ngsbits_tpu.qc.seqpurge import SeqPurgeEngine as JaxEngine
from ngsbits_tpu.qc.seqpurge import SeqPurgeParams as JaxParams
from ngsbits_tpu_torch.io.fastq import FastqBatch
from ngsbits_tpu_torch.ops import KERNELS, seqpurge as sp, selfcheck
from ngsbits_tpu_torch.qc.seqpurge import (SeqPurgeEngine, SeqPurgeParams,
                                           stats_to_dict)

ACGTN = np.frombuffer(b"ACGTN", dtype=np.uint8)
COMP = np.arange(256, dtype=np.uint8)
for _a, _c in zip(b"ACGTN", b"TGCAN"):
    COMP[_a] = _c
A1 = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
A2 = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
POLY = selfcheck.POLY


def _library(rng, B, L, a1, a2, n_rate=0.01):
    """Mates of a short-insert library at width L: inserts of 0..2L bases
    followed by the adapter and random bases, ragged lengths, a few Ns,
    errors in read 2 and low-quality tails. Returns [(bases, quals, lens)]
    for read 1 and read 2, zero past each read."""
    read1, read2, _, len1, len2, _ = selfcheck.adapter_pairs(
        B, L, a1, a2, seed=int(rng.integers(1 << 30)))
    n = rng.random((2, B, L)) < n_rate
    read1 = np.where(n[0], ord("N"), read1).astype(np.uint8)
    read2 = np.where(n[1], ord("N"), read2).astype(np.uint8)
    quals = selfcheck.pair_quals(len1, len2, L, seed=int(rng.integers(1 << 30)))
    return _mates(read1, read2, quals, len1, len2)


def _mates(read1, read2, quals, len1, len2):
    L = read1.shape[1]
    out = []
    for bases, q, ln in ((read1, quals[0], len1), (read2, quals[1], len2)):
        inside = np.arange(L)[None, :] < ln[:, None]
        out.append((np.where(inside, bases, 0).astype(np.uint8),
                    np.where(inside, q, 0).astype(np.uint8), ln.astype(np.int32)))
    return out


def _ties(rng, L):
    """``selfcheck.tie_pairs``: ties in the insert p-value at two or more
    offsets (5 on the short rows; at 0.0, across lanes, on the long ones)."""
    read1, read2, _, len1, len2, _, quals = selfcheck.tie_pairs(
        L, seed=int(rng.integers(1 << 30)))
    return _mates(read1, read2, quals, len1, len2)


def _short_and_all_n(rng, B, L):
    """Lengths 0..8 (overlaps of 0, 1 and 2; shorter than qwin 5 and ncut
    7), pairs all N or with one mate all N, and N-rich reads with runs."""
    (b1, q1, l1), (b2, q2, l2) = _library(rng, B, L, A1, A2, n_rate=0.3)
    short = rng.random(B) < 0.5
    l1 = np.where(short, rng.integers(0, 9, size=B), l1).astype(np.int32)
    l2 = np.where(short & (rng.random(B) < 0.7), rng.integers(0, 9, size=B), l2)
    b1[0::7] = ord("N")
    b2[0::7] = ord("N")
    b1[3::11] = ord("N")
    b2[5::13] = ord("N")
    return _mates(b1, b2, np.stack([q1, q2]), l1, l2.astype(np.int32))


def _batches(kind, rng):
    """(adapters, params, [mates of each batch]) for one kind of edge."""
    if kind == "ties_wide_rows":
        ties = _ties(rng, 720)
        lib = _library(rng, 60, 720, *POLY)
        return POLY, {}, [ties, lib]
    if kind == "short_and_all_n":
        return (A1, A2), {}, [_short_and_all_n(rng, 200, 40),
                              _short_and_all_n(rng, 150, 21)]
    if kind == "qcut0_ncut0":
        return (A1, A2), dict(qcut=0, ncut=0), [_library(rng, 200, 151, A1, A2),
                                                 _short_and_all_n(rng, 100, 30)]
    if kind == "adapters_with_n":
        a1, a2 = b"AGANCGGAAGNGCACACGTC", b"NGATCGGAAGAGCGTCGTGN"
        return (a1, a2), dict(qcut=25), [_library(rng, 250, 151, a1, a2),
                                         _library(rng, 120, 77, a1, a2)]
    raise ValueError(kind)


KINDS = ("ties_wide_rows", "short_and_all_n", "qcut0_ncut0", "adapters_with_n")


@pytest.mark.parametrize("ec", [False, True])
@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("kind", KINDS)
def test_decisions_match_jax_engine_at_the_edges(monkeypatch, kind, route, ec):
    """The port's engine on the CPU, whose decisions take the adapter scans'
    one-byte counts, against the JAX package's engine."""
    rng = np.random.default_rng(KINDS.index(kind))
    (a1, a2), extra, batches = _batches(kind, rng)
    if route == "numpy":
        monkeypatch.setenv("NGSBITS_SEQPURGE_NO_NATIVE", "1")
    scan_types = []

    def decide(scans, *args, **kw):
        scan_types.append(scans.dtype)
        return sp.seqpurge_decide_into(scans, *args, **kw)
    monkeypatch.setattr("ngsbits_tpu_torch.qc.seqpurge.seqpurge_decide_into", decide)
    ref = JaxEngine(JaxParams(a1=a1, a2=a2, ec=ec, **extra))
    assert ref.native_available() == (route == "native")
    port = SeqPurgeEngine(SeqPurgeParams(a1=a1, a2=a2, ec=ec, **extra), device="cpu")
    for mates in batches:
        jb = [JaxFastqBatch(bases=b.copy(), quals=q.copy(), lengths=n.copy())
              for b, q, n in mates]
        pb = [FastqBatch(bases=b.copy(), quals=q.copy(), lengths=n.copy())
              for b, q, n in mates]
        want = ref.process_batch(*jb)
        got = port.process_batch(*pb)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for p, j in zip(pb, jb):
            np.testing.assert_array_equal(p.bases, j.bases)
            np.testing.assert_array_equal(p.quals, j.quals)
    got, want = stats_to_dict(port.stats), stats_to_dict(ref.stats)
    for k in got:
        if k == "bases_perc_trim_sum" and route == "native":
            assert abs(got[k] - want[k]) < 1e-9, k
        elif isinstance(got[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k
    assert port.stats.reads_trimmed_insert > 0
    assert scan_types == [torch.uint8] * len(batches)
    if ec and kind != "short_and_all_n":
        assert port.stats.mismatch_r1.sum() + port.stats.mismatch_r2.sum() > 0


def _decide(mates, a1, a2, device="cpu", **extra):
    """The decisions on one batch, on ``device`` (the kernels on a card, the
    plain versions on the CPU): (out [3, B], acc fields, bases, quals,
    K2's insert counts [2, B, L], table) as numpy."""
    (b1, q1, l1), (b2, q2, l2) = mates
    read1, read2 = (torch.from_numpy(b).to(device) for b in (b1, b2))
    len1, len2 = (torch.from_numpy(n).to(device) for n in (l1, l2))
    idx = len2[:, None] - 1 - torch.arange(read1.shape[1], device=device)[None, :]
    seq2rc = torch.where(idx >= 0, sp.complement_table(device)[
        torch.gather(read2, 1, idx.clamp(min=0).long()).long()], 0)
    scans, ins = selfcheck.seqpurge_scans(read1, read2, seq2rc, len1, len2,
                                          torch.minimum(len1, len2), a1, a2)
    from ngsbits_tpu_torch.core.basicstats import match_probability_table
    table = torch.from_numpy(match_probability_table(0.25, sp.MAXLEN)).to(device)
    bases = torch.stack([read1, read2])
    quals = torch.from_numpy(np.stack([q1, q2])).to(device)
    out = torch.empty((3, len(l1)), dtype=torch.int32, device=device)
    acc = torch.zeros(sp.ACC_SIZE, dtype=torch.int64, device=device)
    params = dict(selfcheck.PARAMS, ec=False)
    params.update(extra)
    need = sp.decide_thresholds(table, params["match_perc"], params["mep"])
    sp.seqpurge_decide_into(scans, ins, bases, quals, torch.stack([len1, len2]),
                            table, need, out, acc, **params)
    return (out.cpu().numpy(), sp.acc_fields(acc.cpu().numpy()), bases.cpu().numpy(),
            quals.cpu().numpy(), ins.cpu().numpy(), table.cpu().numpy())


def test_ties_go_to_the_smallest_offset():
    """Every row has two or more offsets at its smallest p-value among
    those that pass the ratio test (all pass the evidence here); the first
    of them wins: 5 on the short rows, and on the long ones an offset of a
    tie at 0.0 that spans lanes of a warp."""
    mates = _ties(np.random.default_rng(3), 720)
    out, _, _, _, ins, table = _decide(mates, *POLY)
    ml = np.minimum(mates[0][2], mates[1][2])
    for b in range(len(ml)):
        o = np.arange(1, ml[b])
        m, mm = ins[:, b, o].astype(np.int64)
        tot = m + mm
        ok = (tot > 0) & ~(100.0 * m / np.maximum(tot, 1) < 80.0)
        pv = np.where(ok, table[tot, m], np.inf)
        best = o[pv == pv.min()]
        assert len(best) >= 2 and pv.min() <= 1e-6, b
        assert out[0, b] == best[0], b
    assert (out[0, :8] == 5).all()
    assert (out[0, 8:] > 32).all()


def _decide_args(B, L, T, need_width):
    return (torch.zeros((sp.SCAN_ROWS, B, L), dtype=sp.ADAPTER_COUNT),
            torch.zeros((2, B, L), dtype=torch.int16),
            torch.zeros((2, B, L), dtype=torch.uint8),
            torch.zeros((2, B, L), dtype=torch.uint8),
            torch.zeros((2, B), dtype=torch.int32),
            torch.ones((T, T), dtype=torch.float64),
            torch.zeros((2, need_width), dtype=torch.int32),
            torch.empty((3, B), dtype=torch.int32),
            torch.zeros(sp.ACC_SIZE, dtype=torch.int64))


def test_table_too_small_for_the_rows_is_refused():
    with pytest.raises(ValueError, match="table"):
        sp.seqpurge_decide_into(*_decide_args(2, 80, 70, 70),
                                **dict(selfcheck.PARAMS, ec=False))


def test_thresholds_of_another_table_are_refused():
    """``need`` must hold one threshold per total of the table given."""
    with pytest.raises(ValueError, match="need"):
        sp.seqpurge_decide_into(*_decide_args(2, 80, 100, 99),
                                **dict(selfcheck.PARAMS, ec=False))


@pytest.mark.parametrize("B,L", [(0, 40), (5, 0), (3, 1)])
def test_empty_batches_and_rows(B, L):
    """No pairs, or pairs of empty reads: every read keeps length 0 and
    counts in bases_remaining[0]; the CPU route launches nothing."""
    before = [k.launches for k in KERNELS]
    mates = _mates(np.zeros((B, L), np.uint8), np.zeros((B, L), np.uint8),
                   np.zeros((2, B, L), np.uint8), np.zeros(B, np.int32),
                   np.zeros(B, np.int32))
    out, acc = _decide(mates, A1, A2, ec=True)[:2]
    assert out.shape == (3, B)
    assert (out[0] == -1).all() and (out[1:] == 0).all()
    assert acc["bases_remaining"][0] == 2 * B
    assert acc["bases_remaining"].sum() == 2 * B
    assert acc["counters"].sum() == 0
    assert [k.launches for k in KERNELS] == before


def test_error_correction_moves_the_base_of_lower_quality():
    """One insert pair of 40 bases with two mismatches in the overlap: at
    one read 1's quality is higher (read 2 takes read 1's base and
    quality), at the other read 2's; equal qualities leave both."""
    rng = np.random.default_rng(5)
    n = 40
    insert = ACGTN[rng.integers(0, 4, size=n)]
    read1 = np.concatenate([insert, np.frombuffer(A1[:20], np.uint8)])
    read2 = np.concatenate([COMP[insert[::-1]], np.frombuffer(A2[:20], np.uint8)])
    L = len(read1)
    quals = np.full((2, 1, L), 60, np.uint8)
    # read 1's pos 3 meets read 2's 36; pos 10 meets 29; pos 20 meets 19
    for pos in (3, 10, 20):
        read2[n - 1 - pos] = ord("A") if read2[n - 1 - pos] != ord("A") else ord("C")
    quals[0, 0, 3], quals[1, 0, 36] = 70, 40
    quals[0, 0, 10], quals[1, 0, 29] = 40, 70
    mates = _mates(read1[None], read2[None], quals, np.array([L], np.int32),
                   np.array([L], np.int32))
    out, acc, bases, q = _decide(mates, A1, A2, ec=True, qcut=0, ncut=0)[:4]
    assert out[0, 0] == L - n and out[1, 0] == out[2, 0] == n
    assert bases[1, 0, 36] == COMP[insert[3]] and q[1, 0, 36] == 70
    assert bases[0, 0, 10] == COMP[read2[29]] and q[0, 0, 10] == 70
    assert bases[1, 0, 19] == read2[19] and bases[0, 0, 20] == insert[20]
    assert acc["mismatch_r2"][36] == 1 and acc["mismatch_r1"][10] == 1
    assert acc["mismatch_r1"].sum() + acc["mismatch_r2"].sum() == 2
    assert acc["errors_per_read"][3] == 1



# (match_perc, mep): the defaults and the edges of both tests
THRESHOLD_PARAMS = [(80.0, 1e-6)] + [(mp, mep) for mp in (0.0, 66.7, 100.0)
                                     for mep in (0.0, 1e-6, 1.0)]


@pytest.mark.parametrize("match_perc,mep", THRESHOLD_PARAMS)
def test_thresholds_equal_the_float64_tests_everywhere(match_perc, mep):
    """``decide_thresholds`` against the host's float64 tests (numpy, on the
    JAX package's table) at every (tot, m) of the [1001, 1001] table: the
    insert test (tot > 0, the ratio test, the tail) and the adapter test
    (tot == 0 passes the ratio test) each hold exactly where m >= need[tot]."""
    table = jax_table(0.25, sp.MAXLEN)
    T = table.shape[0]
    tot = np.arange(T)[:, None]
    m = np.arange(T)[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        below = (tot > 0) & (100.0 * m / tot < match_perc)
    tail = table <= mep
    need = sp.decide_thresholds(torch.from_numpy(table), match_perc, mep).numpy()
    assert need.shape == (2, T) and need.dtype == np.int32
    np.testing.assert_array_equal(m >= need[0][:, None], (tot > 0) & ~below & tail)
    np.testing.assert_array_equal(m >= need[1][:, None], ~below & tail)


def test_thresholds_refuse_a_table_that_is_not_monotone():
    """A row whose tail rises with m has no threshold: refused, not guessed."""
    table = jax_table(0.25, 100)
    table[40, 35] = 0.5   # above its neighbours, which pass at mep 1e-6
    with pytest.raises(ValueError, match="monotone"):
        sp.decide_thresholds(torch.from_numpy(table), 80.0, 1e-6)
