"""SeqPurge's count scans on a torch device.

Counterpart of ``ngsbits_tpu/ops/seqpurge.py``. Behavioral reference: ngs-bits
SeqPurge AnalysisWorker.cpp:79-457. For every (pair, offset) the scans count
matching and mismatching bases (``N`` on either side is skipped); the p-value
lookups and decisions run on the host in float64 (``qc/seqpurge.py``).

The reference's early abort (AnalysisWorker.cpp:143-167) is outcome-neutral
(a scan that aborts always fails the match-percentage test), so full counts
give identical decisions.

This module holds the wrappers of the two adapter kernels of
``csrc/seqpurge.cu`` with their plain versions, under the dispatch rule of
``ops/pallas_kernels.py`` (CPU tensors take the plain version, CUDA tensors
launch the kernel or raise), and the three scans as functions that allocate
their outputs. The adapters are passed as bytes: they travel to the kernel by
value. The kernels stage each tile of rows in shared memory, so rows are at
most ``MAX_SCAN_WIDTH`` bases wide, as for K2.
"""

from __future__ import annotations

import torch

from .pallas_kernels import (MAX_SCAN_WIDTH, N_CODE, _check, _launched, _lib,
                             _ptr, _route, _stream, insert_scan_into)

MAX_ADAPTER = 64   # the kernels carry at most this many adapter bases


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
        m[:, lo:] += (eff & eq).to(torch.int32)
        mm[:, lo:] += (eff & ~eq).to(torch.int32)


def adapter_evidence_plain(read1, read2, len1, len2, a1, a2, m1, mm1, m2, mm2):
    """Plain PyTorch version in the shifted-slice form of
    ``adapter_evidence_host``: each row is realigned once so that the window
    start ``len2 - o`` becomes a uniform shift, then one pass per adapter
    base over contiguous slices (no ``[B, L, overlap]`` gather)."""
    if len(a1) != len(a2):
        raise ValueError(f"adapter windows differ: {len(a1)} and {len(a2)}")
    if len(a1) == 0:
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
    int32).

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
        _check(name, t, torch.int32, (B, L))
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
        matches[:, :w] += (eff & eq).to(torch.int32)
        mismatches[:, :w] += (eff & ~eq).to(torch.int32)


def adapter_scan_into(read: torch.Tensor, length: torch.Tensor,
                      adapter: bytes, matches: torch.Tensor,
                      mismatches: torch.Tensor) -> None:
    """Adapter-prefix scan (steps 2/3, AnalysisWorker.cpp:304-427), the
    counterpart of the XLA ``adapter_scan``: for each offset o compares
    ``read[o + i]`` with ``adapter[i]`` for ``i < len(adapter)`` and
    ``o + i < length``. Writes ``matches``/``mismatches`` (``[B, L]``
    int32). ``read`` is ``[B, L]`` uint8 ASCII, ``length`` ``[B]`` int32."""
    adapter = _adapter("adapter", adapter)
    if _route(read, length, matches, mismatches) == "cpu":
        return adapter_scan_plain(read, length, adapter, matches, mismatches)
    B, L = read.shape
    if L > MAX_SCAN_WIDTH:
        raise ValueError(f"adapter_scan: L={L} exceeds {MAX_SCAN_WIDTH}")
    _check("read", read, torch.uint8, (B, L))
    _check("length", length, torch.int32, (B,))
    _check("matches", matches, torch.int32, (B, L))
    _check("mismatches", mismatches, torch.int32, (B, L))
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
    return [torch.empty(like.shape, dtype=torch.int32, device=like.device)
            for _ in range(n)]


def insert_scan(seq1: torch.Tensor, seq2rc: torch.Tensor,
                min_len: torch.Tensor):
    """Counts for the insert-match offset scan (AnalysisWorker.cpp:150-167).

    ``seq1``: ``[B, L]`` uint8 ASCII read 1 (zero-padded); ``seq2rc``: the
    reverse complement of read 2, likewise; ``min_len``: ``[B]`` int32.
    Returns (matches, mismatches), ``[B, L]`` int32 indexed by offset.
    """
    m, mm = _outputs(seq1, 2)
    insert_scan_into(seq1, seq2rc, min_len, m, mm)
    return m, mm


def adapter_evidence(read1, read2, len1, len2, a1: bytes, a2: bytes):
    """Returns (m1, mm1, m2, mm2), ``[B, L]`` int32; see
    ``adapter_evidence_into``."""
    out = _outputs(read1, 4)
    adapter_evidence_into(read1, read2, len1, len2, a1, a2, *out)
    return tuple(out)


def adapter_scan(read, length, adapter: bytes):
    """Returns (matches, mismatches), ``[B, L]`` int32; see
    ``adapter_scan_into``."""
    m, mm = _outputs(read, 2)
    adapter_scan_into(read, length, adapter, m, mm)
    return m, mm
