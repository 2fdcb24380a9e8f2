"""The ReadQC kernels and K2: wrappers over ``csrc/readqc.cu`` and
``csrc/seqpurge.cu`` and their plain PyTorch versions.

Counterpart of ``ngsbits_tpu/ops/pallas_kernels.py``. Each wrapper follows one
dispatch rule: tensors on the CPU take the plain version; tensors on a CUDA
device launch the hand-written kernel on the current stream, after checking
device, dtype, shape and contiguity, and raise if the launch is refused. There
is no fallback from the CUDA route to the plain version. Each wrapper counts
its kernel launches in its ``launches`` attribute.

The three ReadQC kernels add into caller-given int64 accumulators, so a
stream of batches updates one set of tensors in place. K2 writes its outputs
in full, as int16. The adapter scans and the decisions of SeqPurge live in
``ops/seqpurge.py``, the coverage and pileup kernels in ``ops/device_reduce.py``;
both share the checks here. ``ngsbits_tpu_torch.ops.KERNELS`` lists all fifteen
wrappers.
"""

from __future__ import annotations

import torch

# module reference: ops/readqc.py imports this module in turn
from . import _build, readqc

READ_Q_BINS = 100   # per-read rounded mean quality
QDIST_BINS = 60     # Histogram(0, 60, 1)


# --------------------------------------------------------------------------
# checks shared by the wrappers
# --------------------------------------------------------------------------
# A wrapper's call from Python costs about as much as its kernel on the card
# at the main path's small batches, so these do no more than they must:
# every launcher's pointer and stream arguments are declared ``c_void_p``
# (``_build.library``), so plain ints pass without a ctypes object each, and
# the loaded library comes back without a lock after the first call.

def _route(*tensors: torch.Tensor) -> str:
    """'cpu' or 'cuda' for a set of tensors that all lie on one device."""
    first = tensors[0]
    if first.is_cuda:  # device indices as ints: no ``torch.device`` objects
        index = first.get_device()
        for t in tensors:
            if not t.is_cuda or t.get_device() != index:
                raise ValueError(f"tensors on different devices: {first.device} and {t.device}")
        return "cuda"
    dev = first.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type != "cpu":
        raise ValueError(f"no kernel for device type '{dev.type}'")
    return "cpu"


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           align: int = 1):
    if t.dtype is not dtype:  # dtypes are singletons
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if align > 1 and t.data_ptr() % align:
        raise ValueError(f"{name}: address not {align}-byte aligned")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream of ``t``'s device (what
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives, without
    making a ``Stream`` object)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _launched(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _base_codes(device: torch.device) -> torch.Tensor:
    return torch.tensor(readqc.BASE_CODES.tolist(), dtype=torch.uint8, device=device)


_lib = _build.library


# --------------------------------------------------------------------------
# K1: per-batch ReadQC reductions
# --------------------------------------------------------------------------

def readqc_batch_plain(bases, quals, lengths, counts5, qsum_cycle, qhist,
                       read_qsum):
    """Plain PyTorch K1: masked by ``pos < length``; q = qual - 33; q outside
    [0, 100) is left out of the histogram. Adds into the first L columns of
    ``counts5`` and ``qsum_cycle``; writes ``read_qsum``."""
    B, L = bases.shape
    mask = torch.arange(L, device=bases.device)[None, :] < lengths[:, None]
    q = torch.where(mask, quals.to(torch.int64) - 33, 0)
    codes = _base_codes(bases.device)
    hit = (bases[None, :, :] == codes[:, None, None]) & mask[None]
    counts5[:, :L] += hit.sum(dim=1)
    qsum_cycle[:L] += q.sum(dim=0)
    read_qsum.copy_(q.sum(dim=1).to(torch.int32))
    inq = q[mask & (q >= 0) & (q < readqc.QHIST_SIZE)]
    qhist += torch.bincount(inq, minlength=readqc.QHIST_SIZE)[:readqc.QHIST_SIZE]


def readqc_batch_into(bases: torch.Tensor, quals: torch.Tensor,
                      lengths: torch.Tensor, counts5: torch.Tensor,
                      qsum_cycle: torch.Tensor, qhist: torch.Tensor,
                      read_qsum: torch.Tensor) -> None:
    """K1, the counterpart of ``readqc_batch_pallas``: adds per-cycle base
    counts into ``counts5 [5, Lc]`` and quality sums into ``qsum_cycle [Lc]``
    (Lc >= L, columns past L untouched), the base-quality histogram into
    ``qhist [100]`` (all int64), and writes ``read_qsum [B]`` (int32).

    ``bases``/``quals`` are ``[B, L]`` uint8 ASCII, ``lengths`` ``[B]`` int32.
    """
    if _route(bases, quals, lengths, counts5, qsum_cycle, qhist,
              read_qsum) == "cpu":
        return readqc_batch_plain(bases, quals, lengths, counts5, qsum_cycle,
                                  qhist, read_qsum)
    B, L = bases.shape
    Lc = counts5.shape[1] if counts5.dim() == 2 else -1
    if Lc < L:
        raise ValueError(f"counts5: {Lc} columns, batch has {L}")
    _check("bases", bases, torch.uint8, (B, L))
    _check("quals", quals, torch.uint8, (B, L))
    _check("lengths", lengths, torch.int32, (B,))
    _check("counts5", counts5, torch.int64, (5, Lc))
    _check("qsum_cycle", qsum_cycle, torch.int64, (Lc,))
    _check("qhist", qhist, torch.int64, (readqc.QHIST_SIZE,))
    _check("read_qsum", read_qsum, torch.int32, (B,))
    if B == 0:
        return
    rc = _lib().ngs_readqc_batch(
        _ptr(bases), _ptr(quals), _ptr(lengths), B, L, Lc, _ptr(counts5),
        _ptr(qsum_cycle), _ptr(qhist), _ptr(read_qsum), _stream(bases))
    _launched("readqc_batch", rc)
    readqc_batch_into.launches += 1


readqc_batch_into.launches = 0


# --------------------------------------------------------------------------
# unpack: packed upload -> ASCII bases and quals
# --------------------------------------------------------------------------

def packed_widths(L: int, qual_bits: int) -> tuple[int, int, int]:
    """Row widths of (packed bases, N mask, packed quals) for L cycles."""
    return L // 4, L // 8, L if qual_bits == 8 else L // 4 * 3


def readqc_unpack_plain(pb, nm, pq, qual_bits, bases, quals):
    B, L = bases.shape
    shifts = torch.arange(4, device=pb.device, dtype=torch.uint8) * 2
    codes = ((pb[:, :, None] >> shifts) & 3).reshape(B, L).to(torch.int64)
    bits = torch.arange(8, device=pb.device, dtype=torch.uint8)
    is_n = ((nm[:, :, None] >> bits) & 1).reshape(B, L).bool()
    code5 = torch.where(is_n, 4, codes)
    bases.copy_(_base_codes(pb.device)[code5])
    if qual_bits == 8:
        q = pq.to(torch.int32)
    else:
        pq3 = pq.reshape(B, L // 4, 3).to(torch.int32)
        v = pq3[:, :, 0] | (pq3[:, :, 1] << 8) | (pq3[:, :, 2] << 16)
        q = torch.stack([(v >> (6 * k)) & 63 for k in range(4)], dim=-1)
        q = q.reshape(B, L)
    quals.copy_(((q + 33) & 0xFF).to(torch.uint8))


def readqc_unpack_into(pb: torch.Tensor, nm: torch.Tensor, pq: torch.Tensor,
                       qual_bits: int, bases: torch.Tensor,
                       quals: torch.Tensor) -> None:
    """Counterpart of ``unpack`` in ``ngsbits_tpu/ops/readqc.py``: writes
    ``"ACGTN"[code5]`` into ``bases`` and ``q + 33`` into ``quals`` (both
    ``[B, L]`` uint8, L % 8 == 0). With ``qual_bits=8``, q must be at most 222
    so that q + 33 fits a byte (``pack_batch`` guarantees it)."""
    if qual_bits not in (6, 8):
        raise ValueError(f"qual_bits must be 6 or 8, got {qual_bits}")
    B, L = bases.shape
    if L % 8:
        raise ValueError(f"unpack needs L % 8 == 0, got L={L}")
    if _route(pb, nm, pq, bases, quals) == "cpu":
        return readqc_unpack_plain(pb, nm, pq, qual_bits, bases, quals)
    wb, wn, wq = packed_widths(L, qual_bits)
    _check("pb", pb, torch.uint8, (B, wb))
    _check("nm", nm, torch.uint8, (B, wn))
    _check("pq", pq, torch.uint8, (B, wq))
    # the kernel stores 16 bytes at a time where the outputs allow it, and
    # never fewer than four
    _check("bases", bases, torch.uint8, (B, L), align=4)
    _check("quals", quals, torch.uint8, (B, L), align=4)
    if B == 0 or L == 0:
        return
    rc = _lib().ngs_readqc_unpack(_ptr(pb), _ptr(nm), _ptr(pq), B, L,
                                  qual_bits, _ptr(bases), _ptr(quals),
                                  _stream(pb))
    _launched("readqc_unpack", rc)
    readqc_unpack_into.launches += 1


readqc_unpack_into.launches = 0


# --------------------------------------------------------------------------
# tails: per-read statistics from the per-read quality sums
# --------------------------------------------------------------------------

TAIL_KEYS = ("q20", "read_q_hist", "qdist1", "qdist2", "len_hist", "n_fwd",
             "n_rev", "bases")


def readqc_tails_plain(read_qsum, lengths, n_valid, direction, carry):
    B = lengths.shape[0]
    Lc = carry["len_hist"].shape[0] - 1
    dev = lengths.device
    rq = read_qsum.to(torch.int64)
    ln = lengths.to(torch.int64)
    real = torch.arange(B, device=dev) < n_valid
    valid = real & (ln > 0)
    safe = torch.where(valid, ln, 1)
    carry["q20"] += (valid & (rq >= 20 * ln)).sum()
    rounded = torch.div(2 * rq + ln, 2 * safe, rounding_mode="floor")
    rq_idx = rounded.clamp(0, READ_Q_BINS - 1)[valid]
    carry["read_q_hist"] += torch.bincount(rq_idx, minlength=READ_Q_BINS)
    h = torch.div(rq, safe, rounding_mode="floor")
    h = torch.where(rq == 60 * ln, 59, h)
    take = valid & (rq <= 60 * ln) & (h >= 0)
    qdist = torch.bincount(h[take], minlength=QDIST_BINS)
    carry["qdist1" if direction == 0 else "qdist2"] += qdist
    len_idx = ln.clamp(0, Lc)[real]
    carry["len_hist"] += torch.bincount(len_idx, minlength=Lc + 1)
    carry["n_fwd" if direction == 0 else "n_rev"] += real.sum()
    carry["bases"] += ln.sum()


def readqc_tails_into(read_qsum: torch.Tensor, lengths: torch.Tensor,
                      n_valid: int, direction: int, carry: dict) -> None:
    """Counterpart of the per-read tail of the XLA ``step``
    (``ngsbits_tpu/ops/readqc.py``): rows < ``n_valid`` are reads (a read may
    have length 0), rows beyond are padding. Adds into the int64 carries
    named in ``TAIL_KEYS``; ``direction`` 0 is forward, 1 reverse."""
    if direction not in (0, 1):
        raise ValueError(f"direction must be 0 or 1, got {direction}")
    tails = [carry[k] for k in TAIL_KEYS]
    if _route(read_qsum, lengths, *tails) == "cpu":
        return readqc_tails_plain(read_qsum, lengths, n_valid, direction, carry)
    B = lengths.shape[0]
    Lc = carry["len_hist"].shape[0] - 1
    _check("read_qsum", read_qsum, torch.int32, (B,))
    _check("lengths", lengths, torch.int32, (B,))
    shapes = dict(q20=(), read_q_hist=(READ_Q_BINS,), qdist1=(QDIST_BINS,),
                  qdist2=(QDIST_BINS,), len_hist=(Lc + 1,), n_fwd=(),
                  n_rev=(), bases=())
    for k in TAIL_KEYS:
        _check(k, carry[k], torch.int64, shapes[k])
    if B == 0:
        return
    rc = _lib().ngs_readqc_tails(
        _ptr(read_qsum), _ptr(lengths), B, int(n_valid), int(direction), Lc,
        *[_ptr(t) for t in tails], _stream(lengths))
    _launched("readqc_tails", rc)
    readqc_tails_into.launches += 1


readqc_tails_into.launches = 0


# --------------------------------------------------------------------------
# K2: SeqPurge's insert-match offset scan
# --------------------------------------------------------------------------

N_CODE = ord("N")
MAX_SCAN_WIDTH = 24576   # the scans stage rows in shared memory (K2: about 8 L bytes a pair)
INSERT_COUNT = torch.int16  # K2's counts: at most L <= MAX_SCAN_WIDTH


def insert_scan_plain(seq1, seq2rc, min_len, matches, mismatches):
    """Plain PyTorch K2 in the shifted-slice form of ``insert_scan_host``
    (``ngsbits_tpu/ops/seqpurge.py``): one pass per offset over contiguous
    ``[B, L - o]`` slices, no ``[B, O, L]`` gather; writes the outputs'
    dtype (int16 where the wrapper's)."""
    B, L = seq1.shape
    matches.zero_()
    mismatches.zero_()
    ok1 = seq1 != N_CODE
    jmask = torch.arange(L, device=seq1.device)[None, :] < min_len[:, None]
    ok2m = (seq2rc != N_CODE) & jmask
    max_o = min(int(min_len.max()), L) if B else 0
    for o in range(max_o):
        w = L - o
        eff = ok1[:, :w] & ok2m[:, o:]
        m = (eff & (seq1[:, :w] == seq2rc[:, o:])).sum(dim=1, dtype=torch.int32)
        matches[:, o] = m.to(matches.dtype)
        mismatches[:, o] = (eff.sum(dim=1, dtype=torch.int32) - m).to(mismatches.dtype)


def insert_scan_into(seq1: torch.Tensor, seq2rc: torch.Tensor,
                     min_len: torch.Tensor, matches: torch.Tensor,
                     mismatches: torch.Tensor) -> None:
    """K2, the counterpart of ``insert_scan_pallas``: for each pair b and
    offset o < L, writes into ``matches``/``mismatches [B, L]`` (int16:
    counts are at most L) the matching and mismatching positions of
    ``seq1[b, j - o]`` against ``seq2rc[b, j]`` over ``o <= j < n``, where
    ``n = clamp(min_len[b], 0, L)``, skipping ``N`` on either side; offsets
    at or past ``n`` get 0.

    ``seq1``/``seq2rc`` are ``[B, L]`` uint8 ASCII (zero-padded),
    ``min_len`` ``[B]`` int32."""
    if _route(seq1, seq2rc, min_len, matches, mismatches) == "cpu":
        return insert_scan_plain(seq1, seq2rc, min_len, matches, mismatches)
    B, L = seq1.shape
    if L > MAX_SCAN_WIDTH:
        raise ValueError(f"insert_scan: L={L} exceeds {MAX_SCAN_WIDTH}")
    _check("seq1", seq1, torch.uint8, (B, L))
    _check("seq2rc", seq2rc, torch.uint8, (B, L))
    _check("min_len", min_len, torch.int32, (B,))
    _check("matches", matches, INSERT_COUNT, (B, L))
    _check("mismatches", mismatches, INSERT_COUNT, (B, L))
    if B == 0 or L == 0:
        return
    rc = _lib().ngs_insert_scan(_ptr(seq1), _ptr(seq2rc), _ptr(min_len), B, L,
                                _ptr(matches), _ptr(mismatches), _stream(seq1))
    _launched("insert_scan", rc)
    insert_scan_into.launches += 1


insert_scan_into.launches = 0
