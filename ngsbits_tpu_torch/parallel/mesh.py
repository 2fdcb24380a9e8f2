"""Process group and sharded QC reduction steps on ``torch.distributed``.

Counterpart of ``ngsbits_tpu/parallel/mesh.py``. The JAX package runs one
process that shards each batch over the devices it sees. Here there is one
process a rank, joined by a process group (``torchrun --nproc-per-node N -m
ngsbits_tpu_torch <Tool> ...``): NCCL where the ranks' device is CUDA, gloo
on the CPU. Every rank reads the whole input and takes its rows of each batch
(``shard_range``: ``tensor_split``'s split, uneven and empty shards allowed).
The accumulators are merged with ``all_reduce`` (``psum``'s counterpart), and
per-row results are put back in row order on every rank with ``all_gather``.
Sharding rows, not batches, keeps every rank's sequence of batches the same,
so every rank reaches the same collectives in the same order.

``NGSBITS_MESH`` (set, not ``0``) sends ReadQC, SeqPurge, MappingQC and the
coverage tools through ``run_tool``: it joins the group (``distributed_init``),
runs the tool, has every rank exit with the same code and leaves the group.
While a group is up, ``active()`` is true and the engines take their rows
(``rows``) and merge (``sum_ranks_``); without one they take every row and
merge nothing. A world of one still goes through the group: on one card that
is NCCL at a world of one.

Gloo takes CUDA tensors for only some collectives, so under gloo the
collectives here always stage CUDA tensors through the host. ``COUNTS`` counts
the collectives and the bytes this rank hands them.
"""

from __future__ import annotations

import datetime
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..utils import backend

ENV = "NGSBITS_MESH"
INIT_ENV = "NGSBITS_MESH_INIT"        # init method: tcp://host:port or file:///path
BACKEND_ENV = "NGSBITS_MESH_BACKEND"  # nccl or gloo; default by the ranks' device
TIMEOUT = datetime.timedelta(seconds=600)  # the longest a collective waits for a peer
AXIS = "data"

COUNTS = {"all_reduce": 0, "all_reduce_bytes": 0, "all_gather": 0, "all_gather_bytes": 0}


def enabled() -> bool:
    """True when ``NGSBITS_MESH`` asks for the mesh route."""
    return os.environ.get(ENV, "") not in ("", "0")


def active() -> bool:
    """True while this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def rank(group=None) -> int:
    return dist.get_rank(group) if active() else 0


def world(group=None) -> int:
    return dist.get_world_size(group) if active() else 1


def writes() -> bool:
    """True where outputs are written: without a group, or on rank 0."""
    return rank() == 0


def shard_range(n: int, rank_: int, world_: int) -> tuple[int, int]:
    """Rank ``rank_``'s rows ``[lo, hi)`` of ``n`` split over ``world_``
    ranks as ``torch.tensor_split`` splits them: the first ``n % world_``
    ranks take one row more; a rank may take none."""
    q, r = divmod(n, world_)
    lo = rank_ * q + min(rank_, r)
    return lo, lo + q + (rank_ < r)


def rows(n: int, group=None) -> tuple[int, int]:
    """This rank's rows of a batch of ``n``: all of them without a group."""
    return shard_range(n, rank(group), world(group))


def distributed_init(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None):
    """Joins this process to a process group; a no-op when it is in one.

    The address is ``coordinator_address`` (``host:port`` or any
    ``init_method``: ``tcp://``, ``file://``), else ``NGSBITS_MESH_INIT``,
    else torchrun's ``env://`` where ``MASTER_ADDR`` is set; without any of
    them the world is this process alone. ``num_processes`` and
    ``process_id`` default to ``WORLD_SIZE`` and ``RANK`` (1 and 0). The
    backend is NCCL where ``NGSBITS_TORCH_DEVICE`` names CUDA, gloo on the
    CPU, or ``NGSBITS_MESH_BACKEND``; a collective waits at most ``TIMEOUT``
    for its peers."""
    if active():
        return
    kind = backend.device_type()
    name = os.environ.get(BACKEND_ENV, "").strip().lower() or (
        "nccl" if kind == "cuda" else "gloo")
    if name not in ("nccl", "gloo"):
        raise ValueError(f"{BACKEND_ENV} must be 'nccl' or 'gloo', got '{name}'")
    if name == "nccl" and kind != "cuda":
        raise ValueError("NCCL needs the ranks on CUDA devices")
    address = coordinator_address or os.environ.get(INIT_ENV) or (
        "env://" if "MASTER_ADDR" in os.environ else None)
    n = int(os.environ.get("WORLD_SIZE", "1")) if num_processes is None else num_processes
    r = int(os.environ.get("RANK", "0")) if process_id is None else process_id
    if address is None:
        if n != 1:
            raise ValueError(f"a world of {n} ranks needs an address ({INIT_ENV}, or "
                             f"torchrun's MASTER_ADDR)")
        dist.init_process_group(name, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=TIMEOUT)
    else:
        if "://" not in address:
            address = "tcp://" + address
        dist.init_process_group(name, init_method=address, rank=r, world_size=n,
                                timeout=TIMEOUT)
    if kind == "cuda":
        torch.cuda.set_device(backend.device())


def make_mesh(axis: str = AXIS):
    """A 1-D ``DeviceMesh`` named ``axis`` over the process group (joined
    first where needed)."""
    from torch.distributed.device_mesh import init_device_mesh
    distributed_init()
    return init_device_mesh(backend.device_type(), (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def run_tool(execute: Callable[[], int]) -> int:
    """Runs a tool (``execute`` returns its exit code) as this process's rank:
    joins the group, and after the run agrees with every rank on the exit
    code, then leaves. A rank whose run failed leaves at once, without the
    agreement: its peers' next collective fails (gloo's at once, NCCL's at the
    group's timeout), so every rank exits non-zero."""
    distributed_init()
    rc = 1
    try:
        rc = execute()
        if rc == 0:
            code = torch.zeros(1, dtype=torch.int64, device=backend.device())
            rc = int(all_reduce_(code, op=dist.ReduceOp.MAX)[0])
    except Exception as exc:  # noqa: BLE001 — a collective failed: a peer left
        print(f"Exception: mesh rank {rank()}: {exc}", file=sys.stderr)
        rc = max(rc, 1)
    finally:
        dist.destroy_process_group()
    return rc


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the group's backend takes it: under gloo on the host."""
    return t.cpu() if t.is_cuda and dist.get_backend(group) == "gloo" else t


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """Reduces the contiguous ``t`` over the group's ranks in place (a sum by
    default) and returns it."""
    s = _staged(t, group)
    dist.all_reduce(s, op=op, group=group)
    if s is not t:
        t.copy_(s)
    COUNTS["all_reduce"] += 1
    COUNTS["all_reduce_bytes"] += t.numel() * t.element_size()
    return t


def in_step(group=None):
    """Under a group, returns once every rank has called it. A tool whose
    rank 0 does work that its peers skip (its writers) calls it once a batch,
    so that a peer waits at a collective for one batch's share of that work,
    never for the whole run's (which may pass ``TIMEOUT``)."""
    if active():
        flag = torch.zeros(1, dtype=torch.int64, device=backend.device())
        int(all_reduce_(flag, group=group)[0])  # the host waits, NCCL's too


def sum_ranks_(t: torch.Tensor, group=None) -> torch.Tensor:
    """``all_reduce_`` under a group; without one ``t`` as it is."""
    return all_reduce_(t, group=group) if active() else t


def all_gather_rows_(part: torch.Tensor, out: torch.Tensor, dim: int = 0,
                     group=None) -> torch.Tensor:
    """Fills ``out`` on every rank with each rank's ``part``, its rows
    (``rows``) of ``out`` along ``dim``, in rank order. ``all_gather`` takes
    equal sizes, so each part goes padded to the largest shard, and as bytes
    (neither NCCL nor gloo gathers int16)."""
    n, w = out.shape[dim], world(group)
    if n == 0:  # every rank holds the same empty batch: nothing to gather
        return out
    shape = list(part.shape)
    shape[dim] = shard_range(n, 0, w)[1]
    pad = part.new_zeros(shape)
    pad.narrow(dim, 0, part.shape[dim]).copy_(part)
    s = _staged(pad.view(-1).view(torch.uint8), group)
    got = [torch.empty_like(s) for _ in range(w)]
    dist.all_gather(got, s, group=group)
    for r, g in enumerate(got):
        lo, hi = shard_range(n, r, w)
        g = g.to(out.device).view(pad.dtype).view(shape)
        out.narrow(dim, lo, hi - lo).copy_(g.narrow(dim, 0, hi - lo))
    COUNTS["all_gather"] += 1
    COUNTS["all_gather_bytes"] += pad.numel() * pad.element_size()
    return out


# --------------------------------------------------------------------------
# the kernels on a rank's rows
# --------------------------------------------------------------------------

def insert_scan_rows(seq1: torch.Tensor, seq2rc: torch.Tensor, min_len: torch.Tensor,
                     ins: torch.Tensor, group=None) -> torch.Tensor:
    """K2 (``insert_scan_into``) on this rank's pairs of a ``[B, L]`` batch;
    every rank's counts gathered into ``ins`` (``[2, B, L]``: matches,
    mismatches) in pair order. Without a group K2 takes every pair."""
    from ..ops.pallas_kernels import INSERT_COUNT, insert_scan_into
    if not active():
        insert_scan_into(seq1, seq2rc, min_len, ins[0], ins[1])
        return ins
    B, L = seq1.shape
    lo, hi = rows(B, group)
    part = torch.empty((2, hi - lo, L), dtype=INSERT_COUNT, device=seq1.device)
    insert_scan_into(seq1[lo:hi], seq2rc[lo:hi], min_len[lo:hi], part[0], part[1])
    return all_gather_rows_(part, ins, dim=1, group=group)


def _group(mesh):
    return None if mesh is None else mesh.get_group()


def _rows_of(a, lo: int, hi: int, dtype, dev: torch.device) -> torch.Tensor:
    """Rows ``lo:hi`` of an array (or tensor) as ``dtype`` (numpy) on ``dev``."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)[lo:hi], dtype=dtype)).to(dev)


# --------------------------------------------------------------------------
# the five sharded steps (the JAX package's, with a DeviceMesh or None for
# the whole group; inputs are the whole batch on every rank, as arrays or
# tensors; outputs are on this rank's device). They are dryrun_multichip's
# contract. The tools' routes share rows, all_reduce_, all_gather_rows_ and
# insert_scan_rows with them but merge inside their engines (the read stream's
# carries, the coverage accumulators, MappingQC's ROI depth); the byte
# comparisons of the tools' outputs check those routes.
# --------------------------------------------------------------------------

def sharded_coverage_step(mesh, starts, ends, genome_bins: int) -> torch.Tensor:
    """Coverage of read spans (half-open, ``[N]`` int32 bins): C1's span form
    on this rank's spans into an int32 ``[genome_bins + 1]`` difference array,
    ``all_reduce`` of it, then C2's dense mode. Returns the int32
    ``[genome_bins]`` coverage."""
    from ..ops.device_reduce import DeviceCoverage
    group = _group(mesh)
    lo, hi = rows(len(starts), group)
    cov = DeviceCoverage(genome_bins, device=backend.device())
    cov.add(np.asarray(starts, dtype=np.int64)[lo:hi], np.asarray(ends, dtype=np.int64)[lo:hi])
    all_reduce_(cov.diff, group=group)
    return cov.dense()


def sharded_insert_scan(mesh, seq1, seq2rc, min_len) -> tuple[torch.Tensor, torch.Tensor]:
    """SeqPurge's insert-match scan over read pairs: K2 on this rank's
    pairs, the counts gathered in pair order (``insert_scan_rows``).
    Returns int16 ``[B, L]`` matches and mismatches."""
    from ..ops.pallas_kernels import INSERT_COUNT
    group, dev = _group(mesh), backend.device()
    B, L = np.shape(seq1)
    s1, s2 = (_rows_of(a, 0, B, np.uint8, dev) for a in (seq1, seq2rc))
    ins = torch.empty((2, B, L), dtype=INSERT_COUNT, device=dev)
    insert_scan_rows(s1, s2, _rows_of(min_len, 0, B, np.int32, dev), ins, group)
    return ins[0], ins[1]


def sharded_readqc_step(mesh, bases, quals, lengths):
    """One ReadQC reduction step: K1 on this rank's reads, one int64
    ``all_reduce`` of the per-cycle counts, quality sums and histogram, the
    per-read quality sums gathered in read order. Returns int64 ``counts5
    [5, L]``, ``qsum_cycle [L]``, ``qhist [100]`` and int32 ``read_qsum
    [B]``."""
    from ..ops.pallas_kernels import readqc_batch_into
    from ..ops.readqc import QHIST_SIZE
    group, dev = _group(mesh), backend.device()
    B, L = np.shape(bases)
    lo, hi = rows(B, group)
    b, q = (_rows_of(a, lo, hi, np.uint8, dev) for a in (bases, quals))
    n = _rows_of(lengths, lo, hi, np.int32, dev)
    sums = torch.zeros(6 * L + QHIST_SIZE, dtype=torch.int64, device=dev)
    counts5, qsum_cycle, qhist = sums[:5 * L].view(5, L), sums[5 * L:6 * L], sums[6 * L:]
    part = torch.empty(hi - lo, dtype=torch.int32, device=dev)
    readqc_batch_into(b, q, n, counts5, qsum_cycle, qhist, part)
    all_reduce_(sums, group=group)
    read_qsum = torch.empty(B, dtype=torch.int32, device=dev)
    all_gather_rows_(part, read_qsum, group=group)
    return counts5, qsum_cycle, qhist, read_qsum


def sharded_mapping_counters_step(mesh, flags, mapqs, on_target) -> torch.Tensor:
    """MappingQC's counters over this rank's alignments (SAM flags, MAPQs,
    on-target marks), then one int64 ``all_reduce``. Returns int64 ``[5]``:
    reads, mapped, duplicates, on-target, MAPQ 0."""
    group, dev = _group(mesh), backend.device()
    lo, hi = rows(len(flags), group)
    f = _rows_of(flags, lo, hi, np.int32, dev)
    q = _rows_of(mapqs, lo, hi, np.int32, dev)
    t = _rows_of(on_target, lo, hi, np.bool_, dev)
    mapped = (f & 0x4) == 0
    counters = torch.stack([torch.tensor(hi - lo, device=dev), mapped.sum(),
                            ((f & 0x400) != 0).sum(), (mapped & t).sum(),
                            (mapped & (q == 0)).sum()]).to(torch.int64)
    return all_reduce_(counters, group=group)


def sharded_correlation_step(mesh, x, y) -> float:
    """Pearson correlation of x and y from moments merged over the ranks.

    Integer genotype codes (both uint8): X7's exact int64 sums on this
    rank's values, an int64 ``all_reduce`` of them and the count, r formed
    in float64 on the host (``pearson_from_moments``). Other inputs: float64
    moments (n, sx, sy, sxx, syy, sxy), one ``all_reduce``, r in float64 by
    the JAX step's formula. Both agree with ``np.corrcoef`` in float64 within
    1e-12 at the sizes the tests take; the JAX step, in float32, within its
    own 1e-3."""
    group, dev = _group(mesh), backend.device()
    x, y = np.asarray(x), np.asarray(y)
    lo, hi = rows(len(x), group)
    k = hi - lo
    if x.dtype == np.uint8 and y.dtype == np.uint8:
        from ..ops.device_reduce import correlation_moments_into, pearson_from_moments
        m = -(-k // 16) * 16  # rows padded to 16 bytes, as upload_genotypes pads them
        buf = np.zeros((2, m), dtype=np.uint8)
        buf[0, :k], buf[1, :k] = x[lo:hi], y[lo:hi]
        moments = torch.zeros(5, dtype=torch.int64, device=dev)
        correlation_moments_into(torch.from_numpy(buf).to(dev), moments)
        sums = torch.cat([torch.tensor([k], dtype=torch.int64, device=dev), moments])
        n, *s = all_reduce_(sums, group=group).tolist()
        return pearson_from_moments(n, s)
    a = _rows_of(x, lo, hi, np.float64, dev)
    b = _rows_of(y, lo, hi, np.float64, dev)
    parts = torch.stack([torch.tensor(float(k), dtype=torch.float64, device=dev), a.sum(),
                         b.sum(), (a * a).sum(), (b * b).sum(), (a * b).sum()])
    n, sx, sy, sxx, syy, sxy = all_reduce_(parts, group=group)
    cov = sxy / n - sx / n * sy / n
    var_x = sxx / n - (sx / n) ** 2
    var_y = syy / n - (sy / n) ** 2
    return float(cov / torch.sqrt(var_x * var_y))


# --------------------------------------------------------------------------
# starting ranks
# --------------------------------------------------------------------------

_ROOT = Path(__file__).resolve().parent.parent.parent  # the directory holding the package


def spawn_ranks(n: int, argv: list[str], env: dict | None = None,
                timeout: float = 600.0) -> list[subprocess.CompletedProcess]:
    """Runs the command ``argv`` as ranks 0..n-1 of one group and returns their
    results in rank order. Each rank gets ``RANK``, ``LOCAL_RANK``,
    ``WORLD_SIZE`` and ``NGSBITS_MESH_INIT`` (a file store in a fresh
    temporary directory: no port to pick), the package's directory first on
    ``PYTHONPATH``, and ``env`` over this process's environment. When
    ``timeout`` seconds have passed, the ranks still running are killed (their
    code is negative)."""
    tmp = tempfile.mkdtemp(prefix="ngsbits-mesh-")
    path = os.environ.get("PYTHONPATH", "")
    procs, files = [], []
    try:
        for r in range(n):
            e = dict(os.environ, **(env or {}))
            e.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                     PYTHONPATH=os.pathsep.join(p for p in (str(_ROOT), path) if p))
            e[INIT_ENV] = "file://" + os.path.join(tmp, "store")
            out, err = (open(os.path.join(tmp, f"rank{r}.{s}"), "w+") for s in ("out", "err"))
            files += [out, err]
            procs.append(subprocess.Popen(argv, env=e, stdout=out, stderr=err))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.01))
            except subprocess.TimeoutExpired:
                break
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        results = []
        for r, p in enumerate(procs):
            out, err = files[2 * r], files[2 * r + 1]
            out.seek(0)
            err.seek(0)
            results.append(subprocess.CompletedProcess(argv, p.returncode, out.read(),
                                                       err.read()))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in files:
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)

