#!/usr/bin/env python3
"""MappingQC's contamination check split into its stages: this checkout
against another, in turns.

    python3 scripts/profile_pileup.py [--other DIR] [--pairs 2000000] [--turns 1]

Writes a synthetic exome (24 chromosomes of 8 Mb, 60,000
regions around the bundled hg38 SNVs and at random, a BAM of N pairs)
under build/profile_pileup/, then runs the contamination check
(``qc/mapping_stats.py::contamination``, MappingQC's stage "Performing
contamination check", the pileup at the panel's SNPs of AF 0.2-0.8) in a
fresh process of each checkout (its own ``ngsbits_tpu_torch``, its
libraries built first, untimed), ``--turns`` times in the order other,
this, this (a), this (a), this, other, where (a) is this checkout without
its host pre-filter (``DevicePileup.reaching``: each kept record's span
searched against its chromosome's loci, two searchsorted calls a
chromosome, so that only the records that reach a locus go up): every
record of a batch goes up, about 21 MB of bases and qualities a batch.

Each process times, by wrapping the functions it finds: the decode
(``BamReader.read_batch``, on whichever thread runs it), the consumer's
wait for the next batch (where the sweep has a prefetch thread), the flag
filter's keys (``record_keys``), the uploads (``_upload`` for B1's indices,
``upload_records`` for a batch's records, with the pre-filter's searches,
``DevicePileup.reaching``), the kernel launches (``bincount_add_into``,
``pileup_add_records_into``; synchronised after each, so device time is
inside), the final fetch (``finalize``); the rest of the stage's wall is
the host's other work: the records' spans and the batch's subset for the
pre-filter and, before the record form, the CIGAR expansion and join
against the loci.
Wrapping and synchronising cost a little; the stage's own seconds come from
``scripts/compare_e2e.py --tools MappingQC``. Prints one line a run and,
last, one JSON line with every run. The device is the one
NGSBITS_TORCH_DEVICE names (cuda by default).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WORK = ROOT / "build" / "profile_pileup"

_RUN = r"""
import json, sys, threading, time
import numpy as np, torch
sys.path.insert(0, '.')
bam_path, roi_path, route = sys.argv[1:4]
from ngsbits_tpu_torch.io import bam as bam_mod
from ngsbits_tpu_torch.ops import device_reduce as dr
from ngsbits_tpu_torch.qc import mapping_stats, pileup
cuda = torch.cuda.is_available() and dr.default_device().type == 'cuda'
t = dict(setup=0.0, decode=0.0, wait=0.0, select=0.0, upload=0.0, kernel=0.0, fetch=0.0)
n = dict(batches=0, uploaded_records=0, uploaded_bytes=0, launches=0)
main = threading.main_thread()

def timed(key, fn, sync=False, count=None):
    def call(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        if sync and cuda:
            torch.cuda.synchronize()
        if key == 'decode' or threading.current_thread() is main:
            t[key] += time.perf_counter() - t0
        if count:
            count(out, *a)
        return out
    if hasattr(fn, 'launches'):  # a wrapper counts its launches under its global name
        call.launches = fn.launches
    return call

def uploaded(out, *a):
    first = out if isinstance(out, torch.Tensor) else out.pos
    n['uploaded_bytes'] += first.untyped_storage().nbytes()
    if not isinstance(out, torch.Tensor):
        n['uploaded_records'] += out.pos.shape[0]

bam_mod.BamReader.read_batch = timed('decode', bam_mod.BamReader.read_batch)
res = mapping_stats.resources
res.known_variants = timed('setup', res.known_variants)
mapping_stats.BedFile.from_file = timed('setup', mapping_stats.BedFile.from_file)
dr._upload = timed('upload', dr._upload, count=uploaded)
for name in ('bincount_add_into', 'pileup_add_records_into'):
    if hasattr(dr, name):
        setattr(dr, name, timed('kernel', getattr(dr, name), sync=True))
for cls in ('DeviceBincount', 'DevicePileup'):
    if hasattr(dr, cls):
        getattr(dr, cls).finalize = timed('fetch', getattr(dr, cls).finalize)
if hasattr(pileup, 'record_keys'):
    pileup.record_keys = timed('select', pileup.record_keys)
if hasattr(pileup, 'prefetch'):
    real_prefetch = pileup.prefetch

    def waited(it, depth=2):
        gen = real_prefetch(it, depth)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(gen)
            except StopIteration:
                return
            finally:
                t['wait'] += time.perf_counter() - t0
            n['batches'] += 1
            yield item

    pileup.prefetch = waited
else:
    real_iter = bam_mod.BamReader.__iter__

    def counted(self):
        for item in real_iter(self):
            n['batches'] += 1
            yield item

    bam_mod.BamReader.__iter__ = counted
if hasattr(pileup, 'upload_records'):
    pileup.upload_records = timed('upload', pileup.upload_records, count=uploaded)
if hasattr(dr, 'DevicePileup'):
    if route == 'every record':  # no pre-filter: every record of a batch goes up
        if hasattr(dr, 'IndelHits'):  # since the indel form's loci range: (mask, range)
            dr.DevicePileup.reaching = lambda self, pos, ends, keys: (
                np.ones(len(keys), dtype=bool), (0, self.n))
        else:
            dr.DevicePileup.reaching = lambda self, pos, ends, keys: np.ones(len(keys), dtype=bool)
        bam_mod.BamBatch.end_positions = lambda self: self.pos
    dr.DevicePileup.reaching = timed('upload', dr.DevicePileup.reaching)

for w in dr.__dict__.values():
    if callable(w) and hasattr(w, 'launches'):
        w.launches = 0
t0 = time.perf_counter()
out = mapping_stats.contamination('hg38', bam_path, roi_path, 20, 50, False)
if cuda:
    torch.cuda.synchronize()
wall = time.perf_counter() - t0
n['launches'] = {k: v.launches for k, v in vars(dr).items()
                 if callable(v) and getattr(v, 'launches', 0)}
consumer = t['wait'] if hasattr(pileup, 'prefetch') else t['decode']
rest = wall - t['setup'] - consumer - t['select'] - t['upload'] - t['kernel'] - t['fetch']
print(json.dumps(dict(wall=wall, **t, host_rest=rest, **n,
                      device=torch.cuda.get_device_name(0) if cuda else 'cpu',
                      report=out.to_string_list())))
"""


_BUILD = """
import sys, torch
sys.path.insert(0, '.')
from ngsbits_tpu_torch.io import native
native.get_lib()
if torch.cuda.is_available():
    from ngsbits_tpu_torch.ops import _build
    _build.library()
"""


def _run(tree: Path, files: list[Path], route: str) -> dict:
    res = subprocess.run([sys.executable, "-c", _RUN, *map(str, files), route], cwd=tree,
                         capture_output=True, text=True, env=dict(os.environ))
    if res.returncode != 0:
        raise RuntimeError(f"{tree} ({route}) failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="the checkout to compare with (e.g. the parent commit); "
                         "without it only this checkout's runs")
    ap.add_argument("--pairs", type=int, default=2_000_000,
                    help="read pairs of the BAM (default 2,000,000)")
    ap.add_argument("--turns", type=int, default=1,
                    help="turns of other, this, this (a), this (a), this, other "
                         "(default 1)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from ngsbits_tpu_torch.utils import synth

    WORK.mkdir(parents=True, exist_ok=True)
    try:
        files = [WORK / "mq.bam", WORK / "mq.bed"]
        lengths = {f"chr{c}": 8_000_000 for c in [*range(1, 23), "X", "Y"]}
        chrom, pos, ref, alt, _ = synth.known_snvs(lengths)
        genome = synth.synth_genome(WORK / "mq.fa", lengths, seed=11, set_bases=[
            (name, pos[chrom == k], ref[chrom == k]) for k, name in enumerate(lengths)])
        roi = synth.synth_roi(files[1], genome, 60_000, seed=12, anchors=(chrom, pos - 1))
        synth.synth_bam(files[0], genome, args.pairs, seed=13, roi=roi,
                        snps=(chrom, pos - 1, alt))
        turn = [("this", "as is"), ("this", "every record"), ("this", "every record"),
                ("this", "as is")]
        if args.other is not None:
            turn = [("other", "as is")] + turn + [("other", "as is")]
        order = turn * args.turns
        trees = {"this": ROOT, "other": None if args.other is None else args.other.resolve()}
        for tree in {trees[name] for name, _ in order}:
            subprocess.run([sys.executable, "-c", _BUILD], cwd=tree, check=True)
        runs, reports = [], set()
        for name, route in order:
            got = _run(trees[name], files, route)
            reports.add(tuple(got.pop("report")))
            label = f"{name} ({route})" if name == "this" else name
            print(f"{label:19s} wall {got['wall']:.3f} s: set-up {got['setup']:.3f}, decode "
                  f"{got['decode']:.3f} (consumer "
                  f"wait {got['wait']:.3f}), keys {got['select']:.3f}, upload {got['upload']:.3f} "
                  f"({got['uploaded_records']} records, {got['uploaded_bytes']} bytes), "
                  f"launches and device {got['kernel']:.3f}, fetch {got['fetch']:.3f}, host rest "
                  f"{got['host_rest']:.3f}; {got['batches']} batches, launches "
                  f"{got['launches']} on {got['device']}", flush=True)
            runs.append(dict(tree=name, route=route, **got))
        if len(reports) != 1:
            raise AssertionError(f"the runs' contamination reports differ: {reports}")
        print(f"reports identical: {next(iter(reports))}")
        print(json.dumps({"profile_pileup": runs}))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
