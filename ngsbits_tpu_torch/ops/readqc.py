"""ReadQC device compute in PyTorch: the K1 batch contract and the
device-resident stream step.

Counterpart of ``ngsbits_tpu/ops/readqc.py``. Behavioral reference: ngs-bits
``StatisticsReads::update`` (cppNGS/StatisticsReads.cpp:26-81).

The stream step runs three kernels on the current stream with no host
synchronisation: unpack (the packed reads -> ASCII rows), K1 (per-cycle
counts and sums, base-quality histogram, per-read quality sums) and tails
(per-read statistics). All 12 carries are int64 on the device, so a run of any
length accumulates without spilling to the host. Unlike the JAX step, which
returns a new carry, this one updates the carry tensors in place.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io import native
# module reference: pallas_kernels reads this module's constants in turn
from . import pallas_kernels as pk

# base codes in pileup order A, C, G, T, N (ASCII)
BASE_CODES = np.frombuffer(b"ACGTN", dtype=np.uint8)
QHIST_SIZE = 100  # reference base_qualities_ array size (StatisticsReads.h:48)

CARRY_KEYS = ("counts5", "qsum1", "qsum2", "qhist", "read_q_hist", "q20",
              "qdist1", "qdist2", "len_hist", "n_fwd", "n_rev", "bases")
_CYCLE_KEYS = ("counts5", "qsum1", "qsum2", "len_hist")


def readqc_batch(bases: torch.Tensor, quals: torch.Tensor,
                 lengths: torch.Tensor):
    """ReadQC partial statistics for one batch (the K1 contract).

    Args:
      bases:   [B, L] uint8 ASCII base codes (zero-padded)
      quals:   [B, L] uint8 ASCII quality codes (zero-padded)
      lengths: [B] int32 read lengths

    Returns (counts5 [5, L], qsum_cycle [L], qhist [100]) as int64 and
    read_qsum [B] as int32, on the inputs' device.
    """
    B, L = bases.shape
    dev = bases.device
    counts5 = torch.zeros((5, L), dtype=torch.int64, device=dev)
    qsum_cycle = torch.zeros(L, dtype=torch.int64, device=dev)
    qhist = torch.zeros(QHIST_SIZE, dtype=torch.int64, device=dev)
    read_qsum = torch.empty(B, dtype=torch.int32, device=dev)
    pk.readqc_batch_into(bases, quals, lengths, counts5, qsum_cycle, qhist,
                         read_qsum)
    return counts5, qsum_cycle, qhist, read_qsum


def _buffer(scratch: dict, key: str, n: int, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    buf = scratch.get(key)
    if buf is None or buf.device != device or buf.numel() < n:
        scratch[key] = buf = torch.empty(n, dtype=dtype, device=device)
    return buf[:n]


def unpack(pb: torch.Tensor, nm: torch.Tensor, pq: torch.Tensor, L: int,
           qual_bits: int):
    """Packed bases, N mask and quals -> ASCII ``[B, L]`` bases and quals."""
    bases, quals = (torch.empty((pb.shape[0], L), dtype=torch.uint8, device=pb.device)
                    for _ in range(2))
    pk.readqc_unpack_into(pb, nm, pq, qual_bits, bases, quals)
    return bases, quals


def stream_carry_init(L: int, device: torch.device) -> dict:
    """Fresh int64 accumulators on ``device`` for max cycle count L."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.int64, device=device)
    return dict(counts5=z(5, L), qsum1=z(L), qsum2=z(L), qhist=z(QHIST_SIZE),
                read_q_hist=z(pk.READ_Q_BINS), q20=z(), qdist1=z(pk.QDIST_BINS),
                qdist2=z(pk.QDIST_BINS), len_hist=z(L + 1), n_fwd=z(), n_rev=z(),
                bases=z())


def stream_carry_grow(carry: dict, L: int) -> dict:
    """Pad the cycle-indexed accumulators to a larger max length."""
    old = carry["counts5"].shape[1]
    if L <= old:
        return carry
    pad = L - old
    carry = dict(carry)
    for k in _CYCLE_KEYS:  # the last dimension is the cycle
        carry[k] = torch.nn.functional.pad(carry[k], (0, pad))
    return carry


def stream_step(carry: dict, pb: torch.Tensor, nm: torch.Tensor,
                pq: torch.Tensor, lengths: torch.Tensor, n_valid: int,
                direction: int, qual_bits: int,
                scratch: dict | None = None) -> dict:
    """Fold one packed batch into ``carry`` in place and return it.

    ``pb``/``nm``/``pq`` are ``pack_batch``'s outputs for a ``[B, L]`` bucket
    with L % 8 == 0 and L at most the carry's width; ``lengths`` is ``[B]``
    int32; rows < ``n_valid`` are reads, rows beyond are padding of length 0
    (as ``ReadStatistics._bucket`` makes them); ``direction`` 0 is forward,
    1 reverse.

    Only the reads are unpacked: K1 reads no byte of a row of length 0, so
    the padding rows of the scratch buffers are left as they were. K1 and
    tails take all B rows.
    """
    B = pb.shape[0]
    L = pb.shape[1] * 4
    if L > carry["counts5"].shape[1]:
        raise ValueError(f"batch width {L} exceeds carry width "
                         f"{carry['counts5'].shape[1]}; grow the carry first")
    scratch = {} if scratch is None else scratch
    bases = _buffer(scratch, "bases", B * L, torch.uint8, pb.device).view(B, L)
    quals = _buffer(scratch, "quals", B * L, torch.uint8, pb.device).view(B, L)
    n = min(max(int(n_valid), 0), B)
    pk.readqc_unpack_into(pb[:n], nm[:n], pq[:n], qual_bits, bases[:n], quals[:n])
    read_qsum = _buffer(scratch, "read_qsum", B, torch.int32, pb.device)
    qsum = carry["qsum1"] if direction == 0 else carry["qsum2"]
    pk.readqc_batch_into(bases, quals, lengths, carry["counts5"], qsum,
                         carry["qhist"], read_qsum)
    pk.readqc_tails_into(read_qsum, lengths, n_valid, direction, carry)
    return carry


def carry_from_numpy(np_carry: dict, device: torch.device) -> dict:
    """A stream carry given as numpy arrays (e.g. a JAX stream carry fetched
    to the host, any integer dtype) -> the port's int64 carry on ``device``."""
    missing = set(CARRY_KEYS) - set(np_carry)
    if missing:
        raise KeyError(f"carry lacks {sorted(missing)}")
    return {k: torch.as_tensor(np.asarray(np_carry[k], dtype=np.int64),
                               device=device).clone()
            for k in CARRY_KEYS}


def carry_to_numpy(carry: dict) -> dict:
    """The port's carry -> int64 numpy arrays on the host (one sync)."""
    return {k: carry[k].cpu().numpy() for k in CARRY_KEYS}


def pack_batch(bases: np.ndarray, quals: np.ndarray, qual_bits: int = 6):
    """Pack a ``[B, L]`` batch (L % 8 == 0) for upload with the native
    ``ngs_pack_batch``: 2-bit base codes, a 1-bit N mask, and quals at 6 bits
    (q - 33 clamped to [0, 63]) or, with ``qual_bits=8`` (the long-read
    range), one byte each (q - 33, 0 below 33)."""
    B, L = bases.shape
    if L % 8:
        raise ValueError(f"pack_batch needs L % 8 == 0, got L={L}")
    pb = np.empty((B, L // 4), np.uint8)
    nm = np.empty((B, L // 8), np.uint8)
    pq = np.empty((B, L // 4 * 3), np.uint8)
    native.get_lib().ngs_pack_batch(np.ascontiguousarray(bases),
                                    np.ascontiguousarray(quals), B, L, pb, nm, pq)
    if qual_bits == 8:
        pq = np.where(quals >= 33, quals - 33, 0).astype(np.uint8)
    return pb, nm, pq
