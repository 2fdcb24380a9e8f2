"""SeqPurge's count scans and per-pair decisions on a torch device.

Counterpart of ``ngsbits_tpu/ops/seqpurge.py`` and of the host decisions in
``ngsbits_tpu/qc/seqpurge.py``. Behavioral reference: ngs-bits SeqPurge
AnalysisWorker.cpp:79-457. For every (pair, offset) the scans count matching
and mismatching bases (``N`` on either side is skipped); the decisions then
look the p-values up in float64 on the same device and leave only per-pair
results and the batch's statistics (``seqpurge_decide_into``).

The reference's early abort (AnalysisWorker.cpp:143-167) is outcome-neutral
(a scan that aborts always fails the match-percentage test), so full counts
give identical decisions.

This module holds the wrappers of the two adapter kernels of
``csrc/seqpurge.cu`` and of the decisions' kernel (``csrc/seqpurge_decide.cu``)
with their plain versions, under the dispatch rule of
``ops/pallas_kernels.py`` (CPU tensors take the plain version, CUDA tensors
launch the kernel or raise), and the three scans as functions that allocate
their outputs. The adapters are passed as bytes: they travel to the kernel by
value. The kernels stage each tile of rows in shared memory, so rows are at
most ``MAX_SCAN_WIDTH`` bases wide, as for K2. The adapter scans write
one-byte counts (``ADAPTER_COUNT``): a count is at most ``MAX_ADAPTER``.
"""

from __future__ import annotations

import numpy as np
import torch

from .pallas_kernels import (INSERT_COUNT, MAX_SCAN_WIDTH, N_CODE, _check,
                             _launched, _lib, _ptr, _route, _stream,
                             insert_scan_into)

MAX_ADAPTER = 64   # the kernels carry at most this many adapter bases
ADAPTER_COUNT = torch.uint8  # the adapter scans' counts: at most MAX_ADAPTER


def _adapter(name: str, adapter: bytes) -> bytes:
    adapter = bytes(adapter)
    if len(adapter) > MAX_ADAPTER:
        raise ValueError(f"{name}: {len(adapter)} bases, at most {MAX_ADAPTER}")
    return adapter


# --------------------------------------------------------------------------
# adapter evidence at each candidate insert
# --------------------------------------------------------------------------

def _aligned(read, rlen, len2, P):
    """aligned[b, P + j] = read[b, len2[b] - j] for j in [-P, L), 0 where
    that position lies outside [0, rlen[b]); and the in-range mask."""
    B, L = read.shape
    j = torch.arange(-P, L, device=read.device)[None, :]
    src = len2.to(torch.int64)[:, None] - j
    inb = (src >= 0) & (src < rlen.to(torch.int64)[:, None])
    a = torch.gather(read, 1, src.clamp(0, L - 1))
    return torch.where(inb, a, 0), inb


def _evidence_plain(al, inb, adapter, cap_by_o, m, mm):
    B, L = m.shape
    P = len(adapter) - 1
    m.zero_()
    mm.zero_()
    ok = inb & (al != N_CODE)
    for i, c in enumerate(adapter):
        if c == N_CODE:
            continue
        lo = i + 1 if cap_by_o else 0          # window 2 needs i < o
        w = L - lo
        if w <= 0:
            continue
        # offset o in [lo, L) reads aligned column o - i + P
        s = lo - i + P
        eff = ok[:, s: s + w]
        eq = al[:, s: s + w] == c
        m[:, lo:] += (eff & eq).to(m.dtype)
        mm[:, lo:] += (eff & ~eq).to(mm.dtype)


def adapter_evidence_plain(read1, read2, len1, len2, a1, a2, m1, mm1, m2, mm2):
    """Plain PyTorch version in the shifted-slice form of
    ``adapter_evidence_host``: each row is realigned once so that the window
    start ``len2 - o`` becomes a uniform shift, then one pass per adapter
    base over contiguous slices (no ``[B, L, overlap]`` gather)."""
    if len(a1) != len(a2):
        raise ValueError(f"adapter windows differ: {len(a1)} and {len(a2)}")
    if len(a1) == 0 or read1.shape[1] == 0:
        for t in (m1, mm1, m2, mm2):
            t.zero_()
        return
    P = len(a1) - 1
    al1, inb1 = _aligned(read1, len1, len2, P)
    al2, inb2 = _aligned(read2, len2, len2, P)
    _evidence_plain(al1, inb1, a1, False, m1, mm1)
    _evidence_plain(al2, inb2, a2, True, m2, mm2)


def adapter_evidence_into(read1: torch.Tensor, read2: torch.Tensor,
                          len1: torch.Tensor, len2: torch.Tensor, a1: bytes,
                          a2: bytes, m1: torch.Tensor, mm1: torch.Tensor,
                          m2: torch.Tensor, mm2: torch.Tensor) -> None:
    """Adapter-presence counts for the insert match
    (AnalysisWorker.cpp:182-259), the counterpart of the XLA
    ``adapter_evidence``. For each offset o the window of ``len(a1)`` bases
    starting at ``len2 - o`` is compared on read 1 with ``a1`` (positions
    below ``len1``) and on read 2 with ``a2`` (positions below ``len2``, and
    only its first ``o`` bases). Writes ``m1, mm1, m2, mm2`` (``[B, L]``
    ``ADAPTER_COUNT``; the plain version writes the outputs' dtype).

    ``read1``/``read2`` are ``[B, L]`` uint8 ASCII, ``len1``/``len2`` ``[B]``
    int32, ``a1``/``a2`` adapter windows of equal length."""
    a1, a2 = _adapter("a1", a1), _adapter("a2", a2)
    if _route(read1, read2, len1, len2, m1, mm1, m2, mm2) == "cpu":
        return adapter_evidence_plain(read1, read2, len1, len2, a1, a2,
                                      m1, mm1, m2, mm2)
    if len(a1) != len(a2):
        raise ValueError(f"adapter windows differ: {len(a1)} and {len(a2)}")
    B, L = read1.shape
    if L > MAX_SCAN_WIDTH:
        raise ValueError(f"adapter_evidence: L={L} exceeds {MAX_SCAN_WIDTH}")
    _check("read1", read1, torch.uint8, (B, L))
    _check("read2", read2, torch.uint8, (B, L))
    _check("len1", len1, torch.int32, (B,))
    _check("len2", len2, torch.int32, (B,))
    for name, t in (("m1", m1), ("mm1", mm1), ("m2", m2), ("mm2", mm2)):
        _check(name, t, ADAPTER_COUNT, (B, L))
    if B == 0 or L == 0:
        return
    rc = _lib().ngs_adapter_evidence(
        _ptr(read1), _ptr(read2), _ptr(len1), _ptr(len2), B, L, a1, len(a1),
        a2, len(a2), _ptr(m1), _ptr(mm1), _ptr(m2), _ptr(mm2), _stream(read1))
    _launched("adapter_evidence", rc)
    adapter_evidence_into.launches += 1


adapter_evidence_into.launches = 0


# --------------------------------------------------------------------------
# adapter-prefix scan
# --------------------------------------------------------------------------

def adapter_scan_plain(read, length, adapter, matches, mismatches):
    """Plain PyTorch version in the shifted-slice form of
    ``adapter_scan_host``: adapter base i meets offset o at read position
    o + i, one pass per adapter base."""
    B, L = read.shape
    matches.zero_()
    mismatches.zero_()
    inside = torch.arange(L, device=read.device)[None, :] < length[:, None]
    ok = inside & (read != N_CODE)
    for i, c in enumerate(adapter):
        if c == N_CODE or i >= L:
            continue
        w = L - i
        eff = ok[:, i:]
        eq = read[:, i:] == c
        matches[:, :w] += (eff & eq).to(matches.dtype)
        mismatches[:, :w] += (eff & ~eq).to(mismatches.dtype)


def adapter_scan_into(read: torch.Tensor, length: torch.Tensor,
                      adapter: bytes, matches: torch.Tensor,
                      mismatches: torch.Tensor) -> None:
    """Adapter-prefix scan (steps 2/3, AnalysisWorker.cpp:304-427), the
    counterpart of the XLA ``adapter_scan``: for each offset o compares
    ``read[o + i]`` with ``adapter[i]`` for ``i < len(adapter)`` and
    ``o + i < length``. Writes ``matches``/``mismatches`` (``[B, L]``
    ``ADAPTER_COUNT``; the plain version writes the outputs' dtype).
    ``read`` is ``[B, L]`` uint8 ASCII, ``length`` ``[B]`` int32."""
    adapter = _adapter("adapter", adapter)
    if _route(read, length, matches, mismatches) == "cpu":
        return adapter_scan_plain(read, length, adapter, matches, mismatches)
    B, L = read.shape
    if L > MAX_SCAN_WIDTH:
        raise ValueError(f"adapter_scan: L={L} exceeds {MAX_SCAN_WIDTH}")
    _check("read", read, torch.uint8, (B, L))
    _check("length", length, torch.int32, (B,))
    _check("matches", matches, ADAPTER_COUNT, (B, L))
    _check("mismatches", mismatches, ADAPTER_COUNT, (B, L))
    if B == 0 or L == 0:
        return
    rc = _lib().ngs_adapter_scan(_ptr(read), _ptr(length), B, L, adapter,
                                 len(adapter), _ptr(matches), _ptr(mismatches),
                                 _stream(read))
    _launched("adapter_scan", rc)
    adapter_scan_into.launches += 1


adapter_scan_into.launches = 0


# --------------------------------------------------------------------------
# the scans, allocating their outputs
# --------------------------------------------------------------------------

def _outputs(like: torch.Tensor, n: int):
    return [torch.empty(like.shape, dtype=ADAPTER_COUNT, device=like.device)
            for _ in range(n)]


def insert_scan(seq1: torch.Tensor, seq2rc: torch.Tensor,
                min_len: torch.Tensor):
    """Counts for the insert-match offset scan (AnalysisWorker.cpp:150-167).

    ``seq1``: ``[B, L]`` uint8 ASCII read 1 (zero-padded); ``seq2rc``: the
    reverse complement of read 2, likewise; ``min_len``: ``[B]`` int32.
    Returns (matches, mismatches), ``[B, L]`` int32 indexed by offset, as
    the JAX package's: K2's int16 counts, widened.
    """
    m, mm = (torch.empty(seq1.shape, dtype=INSERT_COUNT, device=seq1.device)
             for _ in range(2))
    insert_scan_into(seq1, seq2rc, min_len, m, mm)
    return m.to(torch.int32), mm.to(torch.int32)


def adapter_evidence(read1, read2, len1, len2, a1: bytes, a2: bytes):
    """Returns (m1, mm1, m2, mm2), ``[B, L]`` int32 as the JAX package's:
    the one-byte counts of ``adapter_evidence_into``, widened."""
    out = _outputs(read1, 4)
    adapter_evidence_into(read1, read2, len1, len2, a1, a2, *out)
    return tuple(t.to(torch.int32) for t in out)


def adapter_scan(read, length, adapter: bytes):
    """Returns (matches, mismatches), ``[B, L]`` int32 as the JAX
    package's: the one-byte counts of ``adapter_scan_into``, widened."""
    m, mm = _outputs(read, 2)
    adapter_scan_into(read, length, adapter, m, mm)
    return m.to(torch.int32), mm.to(torch.int32)


# --------------------------------------------------------------------------
# D: the per-pair decisions on the scans' counts
# --------------------------------------------------------------------------

MAXLEN = 1000   # the statistics' histograms, as SeqPurge's
# the int64 accumulators of one batch, in this order in one flat tensor
ACC_FIELDS = (("counters", 4), ("bases_remaining", MAXLEN), ("acons1", 200),
              ("acons2", 200), ("mismatch_r1", MAXLEN), ("mismatch_r2", MAXLEN),
              ("errors_per_read", MAXLEN))
ACC_SIZE = sum(n for _, n in ACC_FIELDS)
# what acc_fields(acc)["counters"] counts, in reads
COUNTERS = ("reads_trimmed_insert", "reads_trimmed_adapter", "reads_trimmed_q",
            "reads_trimmed_n")
SCAN_ROWS = 8  # evidence m1, mm1, m2, mm2; prefix m, mm of read 1, of read 2


def acc_fields(acc):
    """Named views of a flat ``[ACC_SIZE]`` accumulator (a tensor or a numpy
    array): ``counters [4]`` (see ``COUNTERS``), ``bases_remaining``,
    ``mismatch_r1``, ``mismatch_r2``, ``errors_per_read`` (``[MAXLEN]``) and
    the consensus pileups ``acons1``, ``acons2`` (``[40, 5]``, A/C/G/T/N)."""
    views, start = {}, 0
    for name, n in ACC_FIELDS:
        views[name] = acc[start:start + n]
        start += n
    for name in ("acons1", "acons2"):
        views[name] = views[name].reshape(40, 5)
    return views


def complement_table(device) -> torch.Tensor:
    """``[256]`` uint8: ACGTN to TGCAN, every other byte to itself."""
    table = torch.arange(256, dtype=torch.int32)
    for a, c in zip(b"ACGTN", b"TGCAN"):
        table[a] = c
    return table.to(torch.uint8).to(device)


def _first_true(mask):
    """Per row, the index of the first True, or -1."""
    B, L = mask.shape
    if L == 0:
        return torch.full((B,), -1, dtype=torch.int64, device=mask.device)
    return torch.where(mask.any(1), mask.to(torch.int8).argmax(1), -1)


def _last_true(mask):
    first = _first_true(mask.flip(1))
    return torch.where(first >= 0, mask.shape[1] - 1 - first, -1)


def _below_ratio(k, tot, match_perc):
    """``100.0 * k / tot < match_perc`` in float64 where ``tot > 0``, as the
    host computes it; False where ``tot == 0`` (the host's NaN passes)."""
    ratio = 100.0 * k.to(torch.float64) / tot.clamp(min=1).to(torch.float64)
    return (tot > 0) & (ratio < match_perc)


def _lookup(table, tot, k):
    """``table[tot, k]`` elementwise."""
    return table.reshape(-1)[tot * table.shape[1] + k]


def decide_thresholds(table: torch.Tensor, match_perc: float,
                      mep: float) -> torch.Tensor:
    """``[2, T]`` int32 on the table's device: for each total ``tot`` of
    matches and mismatches, the least ``m`` from which on every ``m`` passes
    the decisions' per-offset test, ``T`` where none does. Row 0 is the
    insert match's test (``tot > 0``, the ratio test and ``table[tot, m] <=
    mep``), row 1 the adapter match's (``tot == 0`` passes the ratio test).
    Built on the host with the float64 expressions of the plain version; the
    kernel then tests ``m >= need[tot]``, with no division and no table
    lookup. The caller builds them once per table and parameters and
    passes them to ``seqpurge_decide_into``.

    For a fixed ``tot`` both tests are monotone in ``m``: the ratio is an
    exact product and one rounded division, and each table row is a
    reversed cumulative sum of non-negative terms, capped at 1. That is
    checked here, not assumed: a table whose rows break it raises
    ``ValueError``."""
    tab = table.detach().cpu().numpy()
    T = tab.shape[0]
    tot, m = np.arange(T)[:, None], np.arange(T)[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio_ok = ~((tot > 0) & (100.0 * m / np.maximum(tot, 1) < match_perc))
    tail_ok = tab <= mep
    need = []
    for ok in ((tot > 0) & ratio_ok & tail_ok, ratio_ok & tail_ok):
        rev = ok[:, ::-1]
        passing = np.where(rev.all(1), T, rev.argmin(1))  # the passing tail's length
        row = T - passing
        if not np.array_equal(ok, m >= row[:, None]):
            raise ValueError("decide_thresholds: a table row is not monotone in "
                             "the matches; the per-offset test has no threshold")
        need.append(row)
    return torch.from_numpy(np.stack(need).astype(np.int32)).to(table.device)


def insert_offsets_plain(scans, ins, lens, table, match_perc, mep):
    """Step 1: each pair's insert offset, or -1. ``best[b]`` is the offset
    1 <= o < min(len1, len2) of the smallest p-value among those that pass
    the ratio test, ``p <= mep`` and the adapter evidence; the smallest such
    offset among equal p-values."""
    m, mm = ins.to(torch.int64)
    m1, mm1, m2, mm2 = scans[:4].to(torch.int64)
    len1, len2 = lens.to(torch.int64)
    L = m.shape[1]
    off = torch.arange(L, device=m.device)[None, :]
    tot = m + mm
    cand = (~_below_ratio(m, tot, match_perc) & (tot > 0) & (off >= 1)
            & (off < torch.minimum(len1, len2)[:, None]))
    pv = torch.where(cand, _lookup(table, tot, m), torch.inf)
    maxmm = torch.where(off < 3, 0, torch.where(off < 6, 1, 2))
    short = (mm1 <= maxmm) | (mm2 <= maxmm)
    long = _lookup(table, m1 + mm1, m1) * _lookup(table, m2 + mm2, m2) <= mep
    ok = cand & (pv <= mep) & torch.where(off < 10, short, long)
    if L == 0:
        return _first_true(ok)
    return torch.where(ok.any(1), torch.where(ok, pv, torch.inf).argmin(1), -1)


def first_hits_plain(scans, lens, table, match_perc, mep):
    """Step 3's search on every pair: per read, the first offset o < len
    whose adapter-prefix counts pass the ratio test and ``p <= mep``, or -1.
    Returns (read 1's, read 2's)."""
    hits = []
    for k, ln in zip((4, 6), lens.to(torch.int64)):
        am, amm = scans[k].to(torch.int64), scans[k + 1].to(torch.int64)
        t = am + amm
        off = torch.arange(am.shape[1], device=am.device)[None, :]
        ok = (~_below_ratio(am, t, match_perc) & (off < ln[:, None])
              & (_lookup(table, t, am) <= mep))
        hits.append(_first_true(ok))
    return tuple(hits)


def _trim_quality(qual, count, qcut, qwin, qoff):
    """FastqEntry::trimQuality on each row: the last window of ``qwin``
    bases whose quality sum reaches ``qcut * qwin``, then trailing bases
    below ``qcut``; rows shorter than the window stay as they are."""
    B, L = qual.shape
    if L < qwin:
        return count
    pos = torch.arange(L, device=qual.device)[None, :]
    q = qual.to(torch.int64) - qoff
    cums = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=qual.device),
                      torch.where(pos < count[:, None], q, 0).cumsum(1)], dim=1)
    win = cums[:, qwin:] - cums[:, :L + 1 - qwin]   # the window starting at i
    i = torch.arange(L + 1 - qwin, device=qual.device)[None, :]
    start = _last_true((i <= count[:, None] - qwin) & (win >= qcut * qwin))
    last = _last_true((q >= qcut) & (pos < (start + qwin)[:, None]))
    return torch.where(count < qwin, count, torch.where(start >= 0, last + 1, 0))


def _trim_n(bases, count, ncut):
    """FastqEntry::trimN on each row: the first run of ``ncut`` Ns cuts the
    row at the run's start."""
    B, L = bases.shape
    if L < ncut:
        return count
    pos = torch.arange(L, device=bases.device)[None, :]
    isn = (bases == N_CODE) & (pos < count[:, None])
    cums = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=bases.device),
                      isn.to(torch.int64).cumsum(1)], dim=1)
    first = _first_true(cums[:, ncut:] - cums[:, :L + 1 - ncut] == ncut)
    return torch.where((count >= ncut) & (first >= 0), first, count)


def _correct_errors(bases, quals, has, count, acc):
    """-ec (AnalysisWorker.cpp:19-77) on the insert pairs, in place: each
    mismatch of read 1's pos against read 2's count-1-pos goes to the base
    of higher quality."""
    B, L = bases.shape[1:]
    comp = complement_table(bases.device)
    off = torch.arange(L, device=bases.device)[None, :]
    count = torch.where(has, count, 0)[:, None]
    inside = off < count
    mirror = (count - 1 - off).clamp(min=0)   # the partner of column off
    b1, b2 = bases
    q1, q2 = quals
    b1m, b2m, q1m, q2m = (torch.gather(t, 1, mirror) for t in (b1, b2, q1, q2))
    mismatch = inside & (b1 != comp[b2m.long()])
    r1 = mismatch & (q1 < q2m)                           # read 1's base loses
    r2 = torch.gather(mismatch & (q1 > q2m), 1, mirror) & inside  # at read 2's column
    f = acc_fields(acc)
    n = min(L, MAXLEN)
    f["mismatch_r1"][:n] += r1.sum(0)[:n]
    f["mismatch_r2"][:n] += r2.sum(0)[:n]
    errors = mismatch.sum(1)
    f["errors_per_read"] += torch.bincount(errors[(errors > 0) & (errors < MAXLEN)],
                                           minlength=MAXLEN)
    bases[0] = torch.where(r1, comp[b2m.long()], b1)
    quals[0] = torch.where(r1, q2m, q1)
    bases[1] = torch.where(r2, comp[b1m.long()], b2)
    quals[1] = torch.where(r2, q1m, q2)


def seqpurge_decide_plain(scans, ins, bases, quals, lens, table, out, acc, *,
                          match_perc, mep, qcut, qwin, qoff, ncut, ec):
    """Plain PyTorch D: the JAX package's numpy decisions
    (``ngsbits_tpu/qc/seqpurge.py:267-382``) as dense ``[B, L]`` tensor ops
    in float64, on any device. See ``seqpurge_decide_into``."""
    B, L = scans.shape[1:]
    len1, len2 = lens.to(torch.int64)
    f = acc_fields(acc)
    counters = f["counters"]

    # 1. insert match, consensus pileups, -ec
    best = insert_offsets_plain(scans, ins, lens, table, match_perc, mep)
    has = best >= 0
    nl = len2 - best
    new1 = torch.where(has, torch.minimum(len1, nl), len1)
    new2 = torch.where(has, torch.minimum(len2, nl), len2)
    counters[0] += 2 * has.sum()
    if bool(has.any()):
        pos = nl[:, None] + torch.arange(40, device=scans.device)[None, :]
        for read, ln, name in ((bases[0], len1, "acons1"), (bases[1], len2, "acons2")):
            valid = has[:, None] & (pos < ln[:, None])
            window = torch.gather(read, 1, pos.clamp(0, L - 1))
            for i, code in enumerate(b"ACGTN"):
                f[name][:, i] += ((window == code) & valid).sum(0)
        if ec:
            _correct_errors(bases, quals, has, torch.minimum(new1, new2), acc)

    # 3. adapter match on the pairs without an insert
    off_f, off_r = first_hits_plain(scans, lens, table, match_perc, mep)
    hit = ~has & ((off_f >= 0) | (off_r >= 0))
    new1 = torch.where(hit, torch.minimum(new1, torch.where(off_f >= 0, off_f, off_r)), new1)
    new2 = torch.where(hit, torch.minimum(new2, torch.where(off_r >= 0, off_r, off_f)), new2)
    counters[1] += 2 * hit.sum()

    # 4. quality, then N trimming
    if qcut > 0:
        t1 = _trim_quality(quals[0], new1, qcut, qwin, qoff)
        t2 = _trim_quality(quals[1], new2, qcut, qwin, qoff)
        counters[2] += (t1 < new1).sum() + (t2 < new2).sum()
        new1, new2 = t1, t2
    if ncut > 0:
        t1 = _trim_n(bases[0], new1, ncut)
        t2 = _trim_n(bases[1], new2, ncut)
        counters[3] += (t1 < new1).sum() + (t2 < new2).sum()
        new1, new2 = t1, t2

    # 5. per-pair results and statistics
    for new in (new1, new2):
        f["bases_remaining"] += torch.bincount(new[new < MAXLEN], minlength=MAXLEN)
    out[0] = best
    out[1] = new1
    out[2] = new2


def seqpurge_decide_into(scans: torch.Tensor, ins: torch.Tensor,
                         bases: torch.Tensor, quals: torch.Tensor,
                         lens: torch.Tensor, table: torch.Tensor,
                         need: torch.Tensor, out: torch.Tensor,
                         acc: torch.Tensor, *, match_perc: float, mep: float,
                         qcut: int, qwin: int, qoff: int, ncut: int,
                         ec: bool) -> None:
    """SeqPurge's per-pair decisions (AnalysisWorker.cpp:79-457,
    FastqFileStream.cpp:52-115, OutputWorker.cpp:34-77), which the JAX
    package runs on the host (``ngsbits_tpu/qc/seqpurge.py:267-382``,
    ``ngsbits_tpu/native/seqpurge.cpp:116-339``): the insert match, with
    ``ec`` error correction of the insert pairs, the adapter match of the
    others, quality and N trimming, and the statistics.

    ``scans`` is ``[8, B, L]`` ``ADAPTER_COUNT``, the adapter scans'
    outputs in this order: the four adapter evidence counts, the
    adapter-prefix matches and mismatches of read 1 and of read 2; ``ins``
    is ``[2, B, L]`` int16, K2's insert matches and mismatches.
    ``bases``/``quals`` are ``[2, B, L]`` uint8 ASCII (read 1, read 2;
    corrected in place with ``ec``; bytes past a read's length decide
    nothing), ``lens`` ``[2, B]`` int32 in [0, L], ``table`` the ``[T, T]``
    float64 binomial tail of ``core/basicstats.py::match_probability_table``
    with T >= L and T > ``MAX_ADAPTER``, ``need`` its ``[2, T]`` int32
    thresholds (``decide_thresholds`` of the same table and ``match_perc``,
    ``mep``; the kernel's tests, which the plain version does not read).
    Writes ``out [3, B]`` int32 (the insert offset or -1, the new length
    of read 1, of read 2) and adds into ``acc [ACC_SIZE]`` int64
    (``acc_fields``). The plain version makes the host's float64
    comparisons, operation for operation; the kernel tests each offset
    against ``need``, built from the same comparisons, and looks the table
    up where it needs a p-value, so every decision is the same."""
    _, B, L = scans.shape
    T = table.shape[0]
    if table.dim() != 2 or table.shape[1] != T or T < max(L, MAX_ADAPTER + 1):
        raise ValueError(f"table: shape {tuple(table.shape)}, needs [T, T] "
                         f"with T >= {max(L, MAX_ADAPTER + 1)}")
    params = dict(match_perc=float(match_perc), mep=float(mep), qcut=int(qcut),
                  qwin=int(qwin), qoff=int(qoff), ncut=int(ncut), ec=bool(ec))
    if tuple(need.shape) != (2, T):
        raise ValueError(f"need: shape {tuple(need.shape)}, needs [2, {T}] "
                         "(decide_thresholds of the table)")
    if _route(scans, ins, bases, quals, lens, table, need, out, acc) == "cpu":
        return seqpurge_decide_plain(scans, ins, bases, quals, lens, table, out,
                                     acc, **params)
    _check("scans", scans, ADAPTER_COUNT, (SCAN_ROWS, B, L))
    _check("ins", ins, INSERT_COUNT, (2, B, L))
    _check("bases", bases, torch.uint8, (2, B, L))
    _check("quals", quals, torch.uint8, (2, B, L))
    _check("lens", lens, torch.int32, (2, B))
    _check("table", table, torch.float64, (T, T))
    _check("need", need, torch.int32, (2, T))
    _check("out", out, torch.int32, (3, B))
    _check("acc", acc, torch.int64, (ACC_SIZE,))
    if B == 0:
        return
    rc = _lib().ngs_seqpurge_decide(
        _ptr(scans), _ptr(ins), _ptr(bases), _ptr(quals), _ptr(lens), _ptr(need),
        _ptr(table), T, B, L,
        params["match_perc"], params["mep"], params["qcut"], params["qwin"],
        params["qoff"], params["ncut"], int(params["ec"]), _ptr(out), _ptr(acc),
        ACC_SIZE, _stream(scans))
    _launched("seqpurge_decide", rc)
    seqpurge_decide_into.launches += 1


seqpurge_decide_into.launches = 0
