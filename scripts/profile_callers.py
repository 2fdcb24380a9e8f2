#!/usr/bin/env python3
"""VcfMerge's re-calling split into its host stages on the card, with the
sweep's deferred keys and with keys at once, in turns.

    python3 scripts/profile_callers.py [--turns 2]

Writes chip_smoke.py's callers inputs under build/chip_smoke/ (its synthetic
exome's genome and panel, a trio of BAMs of 2 x 1,000,000 pairs, VCFs of
about 15,000 variants; ``chip_smoke._callers_inputs``), then runs VcfMerge
-bam on the card in this process ``--turns`` times in the order deferred,
at once, at once, deferred. Deferred is the sweep as built: a batch's indel
hits are waited for only after the next launch. At once wraps
``DevicePileup.add`` so that each launch's copy is waited for as soon as it
is queued, the order of a blocking fetch a batch. Each run prints its wall,
``tool.seconds`` (set-up, sweep, fetch, output) and, inside the fetch stage,
the host seconds in B1's record-form wrapper (``pileup_add_records_into``),
in the indel form's (``pileup_indels_into``: checks, launch, the copy
queued), in the waits for the copies (``IndelHits.wait``) and in the
counters' fetch (``DevicePileup.finalize``), each with its calls. Prints,
last, one JSON line with every run. Needs a CUDA device; the outputs of
every run must be identical.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ngsbits_tpu_torch.ops import device_reduce as dr  # noqa: E402

SPLIT = {"b1": (dr, "pileup_add_records_into"), "indels": (dr, "pileup_indels_into"),
         "waits": (dr.IndelHits, "wait"), "finalize": (dr.DevicePileup, "finalize")}


def _timed(acc: dict, name: str, fn):
    def call(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t
            acc[name + " calls"] = acc.get(name + " calls", 0) + 1
    call.launches = getattr(fn, "launches", 0)
    return call


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_callers: no CUDA device available", file=sys.stderr)
        return 1
    os.environ["NGSBITS_TORCH_DEVICE"] = "cuda"
    chip_smoke.build()
    chip_smoke.WORK.mkdir(parents=True, exist_ok=True)
    try:
        inp = chip_smoke._callers_inputs()
        bams, vcfs = [str(b) for b in inp["bams"]], [str(v) for v in inp["vcfs"]]
        acc: dict = {}
        for name, (owner, attr) in SPLIT.items():
            setattr(owner, attr, _timed(acc, name, getattr(owner, attr)))
        deferred = dr.DevicePileup.add

        def at_once(self, *a, **kw):
            got = deferred(self, *a, **kw)
            if got is not None:
                got.wait()
            return got

        runs, outputs = [], set()
        for _ in range(args.turns):
            for route in ("deferred", "at once", "at once", "deferred"):
                dr.DevicePileup.add = deferred if route == "deferred" else at_once
                acc.clear()
                out = chip_smoke.WORK / f"profile_{len(runs)}.vcf"
                tool, wall = chip_smoke._port(["VcfMerge", "-in", *vcfs, "-bam", *bams,
                                               "-out", str(out)])
                outputs.add(out.read_bytes())
                got = dict(route=route, wall=wall, stages=dict(tool.seconds),
                           fetch_split=dict(acc))
                runs.append(got)
                print(f"{route:8s} wall {wall:.3f} s; stages "
                      + ", ".join(f"{k} {v:.4f}" for k, v in tool.seconds.items())
                      + "; in the fetch stage: "
                      + ", ".join(f"{k} {acc.get(k, 0.0):.4f} s "
                                  f"({acc.get(k + ' calls', 0)} calls)" for k in SPLIT),
                      flush=True)
        dr.DevicePileup.add = deferred
        if len(outputs) != 1:
            raise AssertionError("the runs' outputs differ")
    finally:
        shutil.rmtree(chip_smoke.WORK, ignore_errors=True)
    print(json.dumps({"profile_callers": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
