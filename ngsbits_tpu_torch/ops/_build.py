"""Build and load the port's CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source in ``csrc/`` (one process per
source, all started together) and links them into one shared library with a
plain C interface, under ``ngsbits_tpu_torch/build/``, named by
a hash of the sources and flags, so an edited source builds anew and an
unchanged one is reused. The library is loaded with ``ctypes``. A failed build
raises with nvcc's output. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class BuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    """nvcc from ``CUDA_HOME``, else ``PATH``, else the toolkit's default
    install prefix."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # sources and the headers they share
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libngsbits_torch_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the sources if the library for their hash is missing: one
    nvcc per source, all started together, then one link. Returns (library
    path, seconds spent building; 0.0 when reused)."""
    so = library_path()
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    t0 = time.perf_counter()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log_text = "".join(" ".join(c) + "\n" + out for c, out in zip(cmds, outs))
    failed = [c[-1] for c, p in zip(cmds, procs) if p.returncode != 0]
    if not failed:
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        log_text += " ".join(link) + "\n" + res.stdout + res.stderr
        if res.returncode != 0:
            failed = ["link"]
    seconds = time.perf_counter() - t0
    so.with_suffix(".log").write_text(log_text)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"nvcc failed for {', '.join(failed)}:\n{log_text}")
    os.replace(tmp, so)
    return so, seconds


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call; later calls return it
    without taking the lock (every wrapper calls this on every launch)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            so, _ = build()
            lib = ctypes.CDLL(str(so))
            p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            lib.ngs_readqc_batch.argtypes = [p, p, p, i, i, i, p, p, p, p, p]
            lib.ngs_readqc_unpack.argtypes = [p, p, p, i, i, i, p, p, p]
            lib.ngs_readqc_tails.argtypes = [p, p, i, i, i, i,
                                             p, p, p, p, p, p, p, p, p]
            lib.ngs_insert_scan.argtypes = [p, p, p, i, i, p, p, p]
            lib.ngs_adapter_evidence.argtypes = [p, p, p, p, i, i, p, i, p, i,
                                                 p, p, p, p, p]
            lib.ngs_adapter_scan.argtypes = [p, p, i, i, p, i, p, p, p]
            lib.ngs_seqpurge_decide.argtypes = [p, p, p, p, p, p, p, i, i, i, d, d,
                                                i, i, i, i, i, p, p, i, p]
            ll = ctypes.c_longlong
            lib.ngs_coverage_add.argtypes = [p, p, ll, i, p, p]
            lib.ngs_coverage_add_reads.argtypes = [p, i, p, i, i, p, p]
            lib.ngs_coverage_add_records.argtypes = [p, p, p, p, p, p, i, i, i, i, p, i,
                                                     i, p, p]
            lib.ngs_coverage_scratch.argtypes = [i]
            lib.ngs_coverage_finalize.argtypes = [p, i, i, i, i, i, p, p, p, p, p]
            lib.ngs_bincount_add.argtypes = [p, ll, i, p, p]
            lib.ngs_region_sums.argtypes = [p, p, p, i, p, p]
            lib.ngs_runs_scratch.argtypes = [ll]
            lib.ngs_runs_count.argtypes = [p, ll, p, p, i, ll, i, p, p]
            lib.ngs_runs_write.argtypes = [p, ll, p, p, i, ll, i, p, i, p, p]
            lib.ngs_pileup_add_records.argtypes = [p, p, p, p, p, p, p, p, i, p, i, p, i, i,
                                                   i, p, p, p, p, p]
            lib.ngs_pileup_indels.argtypes = [p, p, p, p, p, p, i, p, i, p, i, i, i, i, i, p, ll,
                                              p, p]
            lib.ngs_pileup_regions.argtypes = [p, p, p, p, p, i, p, i, p, i, i, i, p, p, ll,
                                               p, p]
            lib.ngs_copy_hits.argtypes = [p, p, ll, p, p]
            lib.ngs_capture_begin.argtypes = [p]
            lib.ngs_capture_end.argtypes = [p, p]
            lib.ngs_correlation_moments.argtypes = [p, ll, p, p]
            lib.ngs_correlation_moments_grid.argtypes = [p, ll, p, ll, p]
            for fn in (lib.ngs_readqc_batch, lib.ngs_readqc_unpack,
                       lib.ngs_readqc_tails, lib.ngs_insert_scan,
                       lib.ngs_adapter_evidence, lib.ngs_adapter_scan,
                       lib.ngs_seqpurge_decide, lib.ngs_coverage_add,
                       lib.ngs_coverage_add_reads,
                       lib.ngs_coverage_add_records,
                       lib.ngs_coverage_finalize, lib.ngs_bincount_add,
                       lib.ngs_region_sums, lib.ngs_runs_count, lib.ngs_runs_write,
                       lib.ngs_pileup_add_records, lib.ngs_pileup_indels,
                       lib.ngs_pileup_regions, lib.ngs_copy_hits, lib.ngs_capture_begin,
                       lib.ngs_capture_end,
                       lib.ngs_correlation_moments,
                       lib.ngs_correlation_moments_grid):
                fn.restype = ctypes.c_int
            lib.ngs_coverage_scratch.restype = ll
            lib.ngs_runs_scratch.restype = ll
            _lib = lib
    return _lib
