"""Coverage and pileup-count engines on a torch device: C1, C2, R1, R2 and B1.

Counterpart of ``DeviceCoverage`` and ``DeviceBincount`` in
``ngsbits_tpu/ops/device_reduce.py``, and of the host's region sums and
threshold runs in ``ngsbits_tpu/qc/coverage.py``. The JAX package buffers
spans and indices on the host and sorts and searches them on the device in
one finalize, because XLA serialises scatter on the TPU. Here the state lives
on the device from the first batch and each batch is scattered into it at once
by a hand-written kernel (``csrc/coverage.cu``), with integer atomics that are
exact in any order:

- C1 ``coverage_add_into``: +1 at ``diff[start]``, -1 at ``diff[end_excl]``
  into a ``[span + 1]`` int32 difference array (without ends: unit spans at
  the starts, ``-min_baseq``'s per-base positions);
- C2 ``coverage_finalize_into``: its prefix sum, binned into the depth
  histogram of ``qc/mapping_stats.py::_depth_histogram_metrics`` (bins of
  ``cov // step``; values above the last bin clamped into it up to
  ``hist_max`` and dropped beyond), and the count of positions at or above
  ``half_depth``; optionally the dense coverage too, or only that;
- R1 ``region_sums_into``: the coverage summed over each region (int64);
- R2 ``threshold_runs``: the runs of positions in each region whose
  coverage is below a cutoff (or at or above it);
- B1 ``bincount_add_into``: ``counts[idx] += 1`` into int32 counters.

R1 and R2 take regions as int32 ``starts`` and the int64 exclusive prefix of
their lengths (``region_offsets``): region ``r`` is positions
``starts[r] .. starts[r] + offsets[r + 1] - offsets[r] - 1``. The kernels cut
the concatenated regions into equal tiles and find a tile's region by a
binary search in ``offsets``.

Each wrapper follows the port's dispatch rule (``ops/pallas_kernels.py``):
tensors on the CPU take the plain version (``index_add_`` and ``cumsum``
for C1 and C2, ``cumsum`` and differences for R1, masks and ``nonzero`` for
R2, ``torch.bincount`` for B1), tensors on a CUDA device launch the kernel
on the current stream after checking device, dtype, shape and contiguity,
or raise. Each counts its launches in ``launches``. The engines take the
device from ``utils/backend.py`` and use no size threshold.

Uploads are blocking copies from pageable memory: a batch's numpy arrays may
be reused as soon as ``add`` returns, and no host buffer is shared with a
kernel that may still be running.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.backend import device as default_device
from .pallas_kernels import _check, _launched, _lib, _ptr, _route, _stream

MAX_BINS = 4096        # C2 keeps its histogram in shared memory
INT32_LIMIT = 2**31 - 1
CUTOFF_LIMIT = 2**62   # R2's cutoff is clamped to +-this (coverage is int32)


def _optional_ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


# --------------------------------------------------------------------------
# C1: spans into the difference array
# --------------------------------------------------------------------------

def coverage_add_plain(starts, ends, diff):
    ones = torch.ones(starts.shape[0], dtype=diff.dtype, device=diff.device)
    s = starts.to(torch.int64)
    diff.index_add_(0, s, ones)
    diff.index_add_(0, s + 1 if ends is None else ends.to(torch.int64), -ones)


def coverage_add_into(starts: torch.Tensor, ends: torch.Tensor | None,
                      diff: torch.Tensor) -> None:
    """C1: for each span ``(starts[i], ends[i])`` (int32 ``[n]``, half-open,
    ``0 <= start <= end <= span``) adds +1 at ``diff[start]`` and -1 at
    ``diff[end]`` of the int32 ``[span + 1]`` difference array. Without
    ``ends`` each span is the one position ``starts[i]`` (``< span``)."""
    tensors = (starts, diff) + (() if ends is None else (ends,))
    if _route(*tensors) == "cpu":
        return coverage_add_plain(starts, ends, diff)
    n = starts.shape[0]
    _check("starts", starts, torch.int32, (n,))
    if ends is not None:
        _check("ends", ends, torch.int32, (n,))
    _check("diff", diff, torch.int32, (diff.shape[0],))
    if n == 0:
        return
    rc = _lib().ngs_coverage_add(_ptr(starts), _optional_ptr(ends), n,
                                 diff.shape[0] - 1, _ptr(diff), _stream(diff))
    _launched("coverage_add", rc)
    coverage_add_into.launches += 1


coverage_add_into.launches = 0


# --------------------------------------------------------------------------
# C2: prefix sum, depth histogram, half-depth count
# --------------------------------------------------------------------------

def coverage_finalize_plain(diff, step, hist_max, half_depth, hist, half,
                            cov=None):
    span = diff.shape[0] - 1
    c = torch.cumsum(diff[:span].to(torch.int64), 0)
    if cov is not None:
        cov.copy_(c.to(cov.dtype))
    if hist is None:
        return
    d = torch.div(c, step, rounding_mode="floor")
    bins = hist.shape[0]
    counts = torch.bincount(d, minlength=bins)
    hist.copy_(counts[:bins])
    if counts.shape[0] > bins:
        hist[bins - 1] += ((d >= bins) & (c <= hist_max)).sum()
    half.fill_(int((c >= half_depth).sum()))


def coverage_finalize_into(diff: torch.Tensor, step: int, hist_max: int,
                           half_depth: int, hist: torch.Tensor | None,
                           half: torch.Tensor | None,
                           cov: torch.Tensor | None = None) -> None:
    """C2, the counterpart of the prefix sum at ``mapping_stats.py:636-641``
    and of ``_depth_histogram_metrics``: from the int32 ``[span + 1]``
    difference array, the coverage ``cov[p] = diff[0] + ... + diff[p]`` for
    ``p < span``, binned into ``hist [bins]`` (int64, written in full) by
    ``cov // step``, values past the last bin clamped into it while
    ``cov <= hist_max`` and dropped beyond; ``half [1]`` (int64) gets the
    count of positions with ``cov >= half_depth``; ``cov [span]`` (int32),
    when given, the dense coverage. With ``hist`` and ``half`` None only
    the dense coverage is made (the histogram parameters are not read)."""
    if (hist is None) != (half is None):
        raise ValueError("hist and half are given together or not at all")
    if hist is None and cov is None:
        raise ValueError("nothing to compute: no histogram and no dense coverage")
    step, hist_max, half_depth = int(step), int(hist_max), int(half_depth)
    if hist is not None and step < 1:
        raise ValueError(f"step must be at least 1, got {step}")
    tensors = (diff,) + tuple(t for t in (hist, half, cov) if t is not None)
    if _route(*tensors) == "cpu":
        return coverage_finalize_plain(diff, step, hist_max, half_depth, hist,
                                       half, cov)
    span, bins = diff.shape[0] - 1, 0 if hist is None else hist.shape[0]
    if hist is not None and not 1 <= bins <= MAX_BINS:
        raise ValueError(f"hist: {bins} bins, the kernel takes 1 to {MAX_BINS}")
    _check("diff", diff, torch.int32, (span + 1,), align=16)
    if hist is not None:
        _check("hist", hist, torch.int64, (bins,))
        _check("half", half, torch.int64, (1,))
    if cov is not None:
        _check("cov", cov, torch.int32, (span,))
    if span == 0:
        if hist is not None:
            hist.zero_()
            half.zero_()
        return
    lib = _lib()
    # the tiles' status words and the tile counter, cleared by the launcher
    scratch = torch.empty(lib.ngs_coverage_scratch(span), dtype=torch.int64,
                          device=diff.device)
    rc = lib.ngs_coverage_finalize(
        _ptr(diff), span, max(step, 1), hist_max, bins, half_depth, _ptr(scratch),
        _optional_ptr(hist), _optional_ptr(half), _optional_ptr(cov), _stream(diff))
    _launched("coverage_finalize", rc)
    coverage_finalize_into.launches += 1


coverage_finalize_into.launches = 0


# --------------------------------------------------------------------------
# R1 and R2: per-region results from the dense coverage
# --------------------------------------------------------------------------

def region_offsets(starts: np.ndarray, ends: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(int32 starts, int64 ``[R + 1]`` exclusive prefix of the lengths) of
    regions given as inclusive bounds, the form R1 and R2 take."""
    starts = np.asarray(starts, dtype=np.int64)
    lengths = np.asarray(ends, dtype=np.int64) - starts + 1
    if len(lengths) and lengths.min() < 1:
        raise ValueError("a region ends before it starts")
    offsets = np.zeros(len(starts) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return starts.astype(np.int32), offsets


def _check_regions(cov, starts, offsets) -> int:
    n = starts.shape[0]
    _check("cov", cov, torch.int32, (cov.shape[0],), align=16)
    _check("starts", starts, torch.int32, (n,))
    _check("offsets", offsets, torch.int64, (n + 1,))
    return n


def _region_ends(starts, offsets):
    return starts.to(torch.int64) + (offsets[1:] - offsets[:-1]) - 1


def region_sums_plain(cov, starts, offsets, out):
    ps = torch.zeros(cov.shape[0] + 1, dtype=torch.int64, device=cov.device)
    torch.cumsum(cov.to(torch.int64), 0, out=ps[1:])
    out.copy_(ps[_region_ends(starts, offsets) + 1] - ps[starts.to(torch.int64)])


def region_sums_into(cov: torch.Tensor, starts: torch.Tensor,
                     offsets: torch.Tensor, out: torch.Tensor) -> None:
    """R1, the counterpart of ``_ChrCoverage.region_sum``
    (``ngsbits_tpu/qc/coverage.py:131-134``, ``:236-240``): ``out[r]``
    (int64 ``[R]``) is the sum of the int32 coverage ``cov`` over region
    ``r``, regions as ``region_offsets`` gives them and within
    ``[0, len(cov))``. Regions may overlap and repeat."""
    if _route(cov, starts, offsets, out) == "cpu":
        return region_sums_plain(cov, starts, offsets, out)
    n = _check_regions(cov, starts, offsets)
    _check("out", out, torch.int64, (n,))
    if n == 0:
        return
    rc = _lib().ngs_region_sums(_ptr(cov), _ptr(starts), _ptr(offsets), n,
                                _ptr(out), _stream(cov))
    _launched("region_sums", rc)
    region_sums_into.launches += 1


region_sums_into.launches = 0


def _clamp_cutoff(cutoff: int) -> int:
    """Any integer cutoff, within +-2^62: the same tests of int32 coverage."""
    return max(-CUTOFF_LIMIT, min(int(cutoff), CUTOFF_LIMIT))


def _hit(values: torch.Tensor, cutoff: int, is_high: bool) -> torch.Tensor:
    cutoff = _clamp_cutoff(cutoff)
    return values >= cutoff if is_high else values < cutoff


def _too_many_positions(total: int, span: int):
    raise ValueError(f"regions of {total} positions over a coverage of {span}: "
                     f"R2 takes disjoint regions")


def threshold_runs_plain(cov, starts, offsets, cutoff, is_high):
    dev = cov.device
    lengths = offsets[1:] - offsets[:-1]
    total = int(offsets[-1])
    if total > cov.shape[0]:
        _too_many_positions(total, cov.shape[0])
    # the coverage position of each region position, and its mask
    pos = torch.repeat_interleave(starts.to(torch.int64) - offsets[:-1], lengths)
    pos += torch.arange(total, dtype=torch.int64, device=dev)
    hit = _hit(cov[pos].to(torch.int64), cutoff, is_high)
    # a run starts where the position before is not hit or in another region
    same = torch.ones(total, dtype=torch.bool, device=dev)
    same[offsets[:-1][lengths > 0]] = False
    before = torch.zeros_like(hit)
    before[1:] = hit[:-1] & same[1:]
    begins = torch.nonzero(hit & ~before).flatten()
    after = torch.zeros_like(hit)
    after[:-1] = hit[1:] & same[1:]
    ends = torch.nonzero(hit & ~after).flatten()
    region = torch.searchsorted(offsets[1:], begins, right=True)
    return torch.stack([region, pos[begins], pos[ends]]).to(torch.int32)


RUNS_COUNT_BYTES = 16  # R2's first fetch: the totals of run starts and ends


def runs_scratch(cov: torch.Tensor) -> torch.Tensor:
    """The int64 scratch of R2's passes for regions over ``cov``: the hit
    mask (a bit a region position), the blocks' counts of run starts and of
    run ends (scanned in place), then the two totals."""
    return torch.empty(_lib().ngs_runs_scratch(cov.shape[0]), dtype=torch.int64,
                       device=cov.device)


def runs_count(cov, starts, offsets, cutoff, is_high, scratch):
    """R2's first pass (two launches): the hit mask, run starts and ends
    counted per block, then scanned; the totals land in ``scratch[-2:]``
    (-1 when the regions hold more positions than ``cov``)."""
    rc = _lib().ngs_runs_count(_ptr(cov), cov.shape[0], _ptr(starts), _ptr(offsets),
                               starts.shape[0], cutoff, int(is_high), _ptr(scratch),
                               _stream(cov))
    _launched("threshold_runs (count)", rc)


def runs_write(cov, starts, offsets, cutoff, is_high, scratch, out):
    """R2's second pass, from the mask and ``offsets`` (the coverage is not
    read): each block writes its runs at its scanned offsets into
    ``out [3, n]``."""
    rc = _lib().ngs_runs_write(_ptr(cov), cov.shape[0], _ptr(starts), _ptr(offsets),
                               starts.shape[0], cutoff, int(is_high), _ptr(scratch),
                               out.shape[1], _ptr(out), _stream(cov))
    _launched("threshold_runs (write)", rc)


def threshold_runs(cov: torch.Tensor, starts: torch.Tensor, offsets: torch.Tensor,
                   cutoff: int, is_high: bool) -> torch.Tensor:
    """R2, the counterpart of the runs loop of ``low_or_high_coverage``
    (``ngsbits_tpu/qc/coverage.py:404-419``): the maximal runs of positions
    of each region whose coverage is ``< cutoff`` (``>= cutoff`` with
    ``is_high``), as int32 ``[3, n]`` rows (region index, first position,
    last position) in region order, then position order. Regions as
    ``region_offsets`` gives them, disjoint and within ``[0, len(cov))``; a
    run never crosses from one region into the next. On the card: a pass
    that reads the coverage once into a hit mask and counts run starts and
    ends per block, a scan of the counts, one fetch of the totals
    (``RUNS_COUNT_BYTES``), and a pass that writes the runs from the
    mask."""
    cutoff = _clamp_cutoff(cutoff)
    if _route(cov, starts, offsets) == "cpu":
        return threshold_runs_plain(cov, starts, offsets, cutoff, is_high)
    n = _check_regions(cov, starts, offsets)
    if n == 0 or cov.shape[0] == 0:
        return torch.zeros(3, 0, dtype=torch.int32, device=cov.device)
    scratch = runs_scratch(cov)
    runs_count(cov, starts, offsets, cutoff, is_high, scratch)
    n_begin, n_end = scratch[-2:].tolist()
    if n_begin < 0:
        _too_many_positions(int(offsets[-1]), cov.shape[0])
    if n_begin != n_end:
        raise RuntimeError(f"threshold_runs: {n_begin} run starts, {n_end} run ends")
    out = torch.empty(3, n_begin, dtype=torch.int32, device=cov.device)
    if n_begin:
        runs_write(cov, starts, offsets, cutoff, is_high, scratch, out)
    threshold_runs.launches += 1
    return out


threshold_runs.launches = 0


# --------------------------------------------------------------------------
# B1: counters
# --------------------------------------------------------------------------

def bincount_add_plain(idx, counts):
    size = counts.shape[0]
    got = torch.bincount(idx.to(torch.int64), minlength=size)[:size]
    counts += got.to(counts.dtype)


def bincount_add_into(idx: torch.Tensor, counts: torch.Tensor) -> None:
    """B1: ``counts[idx[i]] += 1`` for int32 ``idx [n]`` with
    ``0 <= idx < size``, into int32 ``counts [size]``."""
    if _route(idx, counts) == "cpu":
        return bincount_add_plain(idx, counts)
    n = idx.shape[0]
    _check("idx", idx, torch.int32, (n,))
    _check("counts", counts, torch.int32, (counts.shape[0],))
    if n == 0:
        return
    rc = _lib().ngs_bincount_add(_ptr(idx), n, counts.shape[0], _ptr(counts),
                                 _stream(counts))
    _launched("bincount_add", rc)
    bincount_add_into.launches += 1


bincount_add_into.launches = 0


# --------------------------------------------------------------------------
# engines with the JAX package's API
# --------------------------------------------------------------------------

def _upload(rows: list[np.ndarray], dev: torch.device) -> torch.Tensor:
    """int32 ``[len(rows), n]`` on ``dev`` in one copy."""
    return torch.from_numpy(np.stack([np.asarray(r, dtype=np.int32) for r in rows])).to(dev)


class DeviceCoverage:
    """Coverage of one span (positions 0..span-1), its difference array on
    the device: ``add`` scatters each batch of spans at once (C1);
    ``histogram`` returns the depth histogram and the half-depth count (C2);
    ``region_sums`` (C2's dense mode, then R1) and ``runs`` (then R2) return
    per-region results; ``coverage_at`` and ``finalize`` take the dense
    coverage from the same dense mode. ``fetched`` counts the bytes copied
    back to the host."""

    def __init__(self, span: int, device: torch.device | None = None):
        if span + 1 > INT32_LIMIT:
            raise ValueError(f"span {span}: int32 coordinates need span < 2^31 - 1")
        self.span = span
        self.device = default_device() if device is None else torch.device(device)
        self.diff = torch.zeros(span + 1, dtype=torch.int32, device=self.device)
        self.fetched = 0

    def add(self, starts: np.ndarray, ends_excl: np.ndarray | None = None):
        """Adds the half-open spans ``[starts[i], ends_excl[i])``, or without
        ``ends_excl`` the positions ``starts[i]`` one each. Raises
        ValueError, on every device, for a span outside ``[0, span]`` or one
        that ends before it starts."""
        if not len(starts):
            return
        s = np.asarray(starts, dtype=np.int64)
        e = s + 1 if ends_excl is None else np.asarray(ends_excl, dtype=np.int64)
        if s.min() < 0 or e.max() > self.span or (e - s).min() < 0:
            i = int(np.argmax((s < 0) | (e > self.span) | (e < s)))
            raise ValueError(f"span [{s[i]}, {e[i]}) is outside the coverage's "
                             f"positions [0, {self.span}] or ends before it starts")
        if ends_excl is None:
            coverage_add_into(_upload([s], self.device)[0], None, self.diff)
        else:
            se = _upload([s, e], self.device)
            coverage_add_into(se[0], se[1], self.diff)

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        out = t.cpu().numpy()
        self.fetched += out.nbytes
        return out

    def histogram(self, step: int, hist_max: int, bins: int,
                  half_depth: int) -> tuple[np.ndarray, int]:
        """(int64 counts of the ``bins`` depth bins, positions at or above
        ``half_depth``): all that comes back from the card."""
        out = torch.empty(bins + 1, dtype=torch.int64, device=self.device)
        coverage_finalize_into(self.diff, step, hist_max, half_depth, out[:bins],
                               out[bins:])
        got = self._fetch(out)
        return got[:bins], int(got[bins])

    def dense(self) -> torch.Tensor:
        """The int32 coverage ``[span]`` on the device (C2 without its
        histogram)."""
        cov = torch.empty(self.span, dtype=torch.int32, device=self.device)
        coverage_finalize_into(self.diff, 1, 0, 0, None, None, cov)
        return cov

    def _regions(self, starts: np.ndarray, ends: np.ndarray):
        starts = np.asarray(starts, dtype=np.int64)
        ends = np.asarray(ends, dtype=np.int64)
        if len(starts) and (starts.min() < 0 or ends.max() >= self.span):
            raise ValueError(f"regions must lie within [0, {self.span})")
        s, off = region_offsets(starts, ends)
        return (torch.from_numpy(s).to(self.device),
                torch.from_numpy(off).to(self.device))

    def region_sums(self, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
        """int64 coverage sums over the regions ``[starts[r], ends[r]]``
        (inclusive)."""
        out = torch.empty(len(starts), dtype=torch.int64, device=self.device)
        if len(starts):
            region_sums_into(self.dense(), *self._regions(starts, ends), out)
        return self._fetch(out)

    def runs(self, starts: np.ndarray, ends: np.ndarray, cutoff: int,
             is_high: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(region index, first, last) of each run of positions of the
        regions ``[starts[r], ends[r]]`` whose coverage is below ``cutoff``
        (at or above it with ``is_high``), in region then position order."""
        if not len(starts):
            z = np.zeros(0, dtype=np.int32)
            return z, z, z
        got = threshold_runs(self.dense(), *self._regions(starts, ends), cutoff, is_high)
        self.fetched += RUNS_COUNT_BYTES if got.is_cuda else 0
        region, first, last = self._fetch(got)
        return region, first, last

    def coverage_at(self, pos: np.ndarray) -> np.ndarray:
        """Coverage at the given positions (each in [0, span))."""
        if len(pos) == 0:
            return np.zeros(0, dtype=np.int64)
        idx = torch.from_numpy(np.asarray(pos, dtype=np.int64)).to(self.device)
        return self._fetch(self.dense()[idx].to(torch.int64))

    def finalize(self) -> np.ndarray:
        """Dense coverage over the full span (int64)."""
        out = self._fetch(self.dense().to(torch.int64))
        self.diff = None
        return out


class DeviceBincount:
    """Counter array engine (pileup base counts): int32 counters on the
    device, each batch of indices counted at once (B1), fetched once at the
    end as int64."""

    def __init__(self, size: int, device: torch.device | None = None):
        self.size = size
        self.device = default_device() if device is None else torch.device(device)
        self.counts = torch.zeros(size, dtype=torch.int32, device=self.device)

    def add(self, idx: np.ndarray):
        if len(idx):
            bincount_add_into(_upload([idx], self.device)[0], self.counts)

    def finalize(self) -> np.ndarray:
        out = self.counts.to(torch.int64).cpu().numpy()
        self.counts = None
        return out
