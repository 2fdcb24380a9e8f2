"""Entry points of the port, the counterparts of ``__graft_entry__.py``.

``entry()``             -> (fn, example_args): K1's batch function
                          (``ops.readqc.readqc_batch``) and a batch on the
                          port's device, made with numpy from the same seed
                          as the JAX package's example.
``dryrun_multichip(n)`` -> starts a process group of n ranks and runs the five
                          sharded steps once at the JAX dryrun's shapes, with
                          its assertions, each step's result also held
                          against the same work done without the mesh.

``python -m ngsbits_tpu_torch.entry dryrun`` is one rank of the dryrun (its
group from ``RANK``, ``WORLD_SIZE`` and ``NGSBITS_MESH_INIT``); it prints
one JSON line: each step's kernel launches, collective bytes and seconds.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def _example_batch(B=1024, L=128, seed=0):
    rng = np.random.default_rng(seed)
    bases = rng.choice(np.frombuffer(b"ACGTN", dtype=np.uint8), size=(B, L))
    quals = (rng.integers(33, 74, size=(B, L))).astype(np.uint8)
    lengths = np.full((B,), L, dtype=np.int32)
    return bases, quals, lengths


def entry():
    import torch

    from .ops.readqc import readqc_batch
    from .utils.backend import device

    dev = device()
    return readqc_batch, tuple(torch.from_numpy(a).to(dev) for a in _example_batch())


def dryrun_multichip(n_devices: int, backend: str | None = None,
                     timeout: float = 600.0) -> list[dict]:
    """Runs ``n_devices`` ranks of this module's dryrun in a process group of
    their own (NCCL on the card, gloo on the CPU, or ``backend``); raises if
    a rank fails. Returns each rank's record, in rank order."""
    from .parallel import mesh

    env = {mesh.BACKEND_ENV: backend} if backend else None
    results = mesh.spawn_ranks(n_devices, [sys.executable, "-m", "ngsbits_tpu_torch.entry",
                                           "dryrun"], env=env, timeout=timeout)
    for r, res in enumerate(results):
        if res.returncode != 0:
            raise RuntimeError(f"dryrun rank {r} of {n_devices} exited {res.returncode}:\n"
                               f"{res.stderr[-4000:]}")
    return [json.loads(res.stdout.strip().splitlines()[-1]) for res in results]


def _expect(ok: bool, message: str):
    if not ok:
        raise AssertionError(message)


def _dryrun_rank() -> dict:
    """One rank's dryrun: the JAX dryrun's steps, shapes and assertions; each
    step also against the same kernels on the whole input without the mesh
    (integers equal; the float correlation against ``np.corrcoef`` within
    1e-12, the JAX dryrun's 1e-3 too)."""
    import torch

    from .ops import KERNELS
    from .ops.device_reduce import DeviceCoverage, genotype_moments, pearson_from_moments
    from .ops.pallas_kernels import INSERT_COUNT, insert_scan_into
    from .ops.readqc import readqc_batch
    from .parallel import mesh
    from .utils.backend import device

    mesh.distributed_init()
    n_devices = mesh.world()
    grid = mesh.make_mesh()
    dev = device()
    steps: list[dict] = []

    def timed(name, fn, *args):
        before = {k.__name__: k.launches for k in KERNELS}
        counts = dict(mesh.COUNTS)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(grid, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = {k.__name__.removesuffix("_into"): k.launches - before[k.__name__]
                    for k in KERNELS if k.launches != before[k.__name__]}
        steps.append(dict(step=name, seconds=time.perf_counter() - t0, launches=launches,
                          **{k: v - counts[k] for k, v in mesh.COUNTS.items()}))
        return out

    # data-parallel ReadQC reduction at a production batch (B >= 16k reads)
    B_qc = max(16384, 2048 * n_devices)
    B_qc += (-B_qc) % n_devices
    bases, quals, lengths = _example_batch(B=B_qc, L=152)
    out = timed("sharded_readqc_step", mesh.sharded_readqc_step, bases, quals, lengths)
    counts5 = out[0].cpu().numpy()
    _expect(counts5.sum() == bases.size, "sharded pileup count mismatch")
    whole = readqc_batch(*(torch.from_numpy(a).to(dev) for a in (bases, quals, lengths)))
    for got, want in zip(out, whole):
        _expect(torch.equal(got, want), "sharded_readqc_step differs from K1 on the whole batch")

    # coverage scatter-add + all_reduce + scan at WES-chunk scale
    rng = np.random.default_rng(1)
    n_spans = 65536
    n_spans += (-n_spans) % n_devices
    span = 1 << 20
    starts = rng.integers(0, span - 150, size=n_spans).astype(np.int32)
    ends = starts + rng.integers(1, 150, size=n_spans).astype(np.int32)
    cov = timed("sharded_coverage_step", mesh.sharded_coverage_step, starts, ends, span)
    _expect(int(cov.sum()) == int((ends - starts).sum()), "sharded coverage mismatch")
    alone = DeviceCoverage(span, device=dev)
    alone.add(starts, ends)
    _expect(torch.equal(cov, alone.dense()), "sharded_coverage_step differs from C1 + C2")

    # SeqPurge insert scan, gathered in pair order
    B = max(16384, 2048 * n_devices)
    B += (-B) % n_devices
    s1 = rng.choice(np.frombuffer(b"ACGTN", dtype=np.uint8), size=(B, 128))
    s2 = rng.choice(np.frombuffer(b"ACGTN", dtype=np.uint8), size=(B, 128))
    ml = np.full((B,), 128, dtype=np.int32)
    m, mm = timed("sharded_insert_scan", mesh.sharded_insert_scan, s1, s2, ml)
    _expect(m.shape == (B, 128), "sharded insert scan shape mismatch")
    want = torch.empty((2, B, 128), dtype=INSERT_COUNT, device=dev)
    insert_scan_into(*(torch.from_numpy(a).to(dev) for a in (s1, s2, ml)), want[0], want[1])
    _expect(torch.equal(m, want[0]) and torch.equal(mm, want[1]),
            "sharded_insert_scan differs from K2 on the whole batch")

    # MappingQC counters
    n_aln = 32 * n_devices
    flags = rng.choice(np.array([0, 0x4, 0x400], dtype=np.uint16), size=n_aln)
    mapqs = rng.integers(0, 60, size=n_aln).astype(np.int32)
    on_target = rng.random(n_aln) < 0.5
    counters = timed("sharded_mapping_counters_step", mesh.sharded_mapping_counters_step,
                     flags, mapqs, on_target).cpu().numpy()
    _expect(counters[0] == n_aln, "sharded mapping counter mismatch")
    _expect(counters[1] == int((flags & 0x4 == 0).sum()), "mapped count mismatch")
    mapped = (flags & 0x4) == 0
    _expect(counters.tolist() == [n_aln, int(mapped.sum()), int(((flags & 0x400) != 0).sum()),
                                  int((mapped & on_target).sum()),
                                  int((mapped & (mapqs == 0)).sum())], "counters differ")

    # sample-similarity correlation: float moments, then X7 on genotype codes
    x = rng.random(64 * n_devices).astype(np.float32)
    y = 0.5 * x + 0.1 * rng.random(64 * n_devices).astype(np.float32)
    corr = timed("sharded_correlation_step", mesh.sharded_correlation_step, x, y)
    ref = float(np.corrcoef(x, y)[0, 1])
    _expect(abs(corr - ref) < 1e-3, f"sharded correlation mismatch: {corr} vs {ref}")
    _expect(abs(corr - ref) < 1e-12, f"float64 correlation off np.corrcoef: {corr} vs {ref}")
    gx = rng.integers(0, 3, size=64 * n_devices).astype(np.uint8)
    gy = np.where(rng.random(64 * n_devices) < 0.7, gx, rng.integers(0, 3, 64 * n_devices))
    gy = gy.astype(np.uint8)
    r = timed("sharded_correlation_step uint8", mesh.sharded_correlation_step, gx, gy)
    alone = pearson_from_moments(len(gx), genotype_moments(gx / 2, gy / 2, dev))
    _expect(r == alone, f"X7 through the mesh {r} differs from X7 alone {alone}")
    return dict(rank=mesh.rank(), world=n_devices, device=str(dev),
                backend=mesh.dist.get_backend(), steps=steps)


def main(argv: list[str]) -> int:
    if argv != ["dryrun"]:
        print("usage: python -m ngsbits_tpu_torch.entry dryrun", file=sys.stderr)
        return 2
    from .parallel import mesh
    try:
        record = _dryrun_rank()
        print(json.dumps(record), flush=True)
    finally:
        if mesh.active():
            mesh.dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
