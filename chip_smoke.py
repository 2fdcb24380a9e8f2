#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phase kernels|mappingqc|coverage|similarity|callers|annotate|somatic|variants|mesh]

Phases, each of which raises on failure (the script then exits non-zero):

1. probe    a CUDA device is required; prints the card's name and power
            limit, and the toolchain (torch's CUDA, nvcc, triton).
2. build    compiles the port's host library (g++, native/ngshost.cpp) and
            its kernels (nvcc, one process per csrc/*.cu, all at once) side
            by side; prints the seconds of each.
3. kernels  each kernel against its plain torch version on the card, integer
            outputs equal. K1 at six inputs (``K1_INPUTS``): the main path's
            (B=65536 reads of 151 bp in the L=192 bucket, 6-bit quals binned
            to Q2/12/23/37), the same with uniform quals, ragged lengths with
            6- and 8-bit quals, SeqPurge's -qc bucket (B=16384, 10,000 reads)
            and long reads (B=1024, L=10240); unpack and tails at each, timed
            at the first and at the -qc bucket (unpack on the rows that hold
            reads, as the stream step hands them: 65,536 and 10,000).
            SeqPurge's three scans at their main path's batch (B=10000 pairs,
            L=151) and at a ragged B=1237, L=250, with adapters with and
            without N and adapter prefixes of 15 and 20 bases (off the main
            batch: random bytes past the reads and all-N pairs); K2 also on
            wide rows at the edges of its contract (B=1000, L=1000 and B=3,
            L=24,576: min_len below 0 and above L, bytes outside ACGTN,
            all-N pairs, random bytes past min_len); its
            decisions (``seqpurge_decide``) on the scans of a library with
            adapters at the main batch, with and without -ec, at B=1237,
            L=250 and at B=1237, L=999 (rows too wide to stage, read where
            they lie; per-pair results, accumulators and corrected reads
            equal). MappingQC's C1 (its span form and its read form), C2
            and B1 at their edges (span 1, a span not a multiple of C2's
            tile, spans of length 0 and at both ends; reads at region edges,
            over many regions, in none, of no reference length, over the
            ROI's last region, on several chromosomes; coverage at and above
            hist_max, cfDNA's and the adaptive histogram parameters, hot
            bins, all bundled SNPs); at the main path's inputs they are
            checked and timed in the mappingqc phase. The contamination
            pileup's B1 record form at its edges
            (``selfcheck.PILEUP_EDGES``: records without SEQ, 0xFF
            qualities, every CIGAR op, loci at an op's first and last base
            and repeated, sorted and unsorted records, several chromosomes
            in a batch and one without loci, a pile, long N ops; MAPQ 0 with
            and without the MAPQ-0 counters, include_not_properly_paired,
            min_mapq 0, 1 and 20, min_baseq 0, 13, 20 and 256:
            ``selfcheck.PILEUP_PARAMS``), and its indel form at its edges
            (``selfcheck.INDEL_EDGES``: I and D ops first and last in
            records, loci at the window's edges and middle, just outside
            and repeated, window 0, 1 and 3, min_mapq 0, 1 and 20; the
            reached loci staged in shared memory, and 200,000 of them
            searched in global memory; a chromosome whose reached range is
            empty), and its region form at its edges
            (``selfcheck.REGION_EDGES``: I and D ops at a region's start and
            end, just outside and an I and a D op at one g; random, long
            (up to 500 bases), overlapping and repeated regions, regions at
            records' spans and under long N ops, a chromosome the BAM lacks;
            records without SEQ, of no reference span, of MAPQ 0; counters
            and hits; about 6,000 reached regions (timed) and a table of
            1,100 references).
            The coverage tools' C2 (dense mode alone), R1 and R2 at their
            edges (one-base regions, regions at both ends and over the whole
            span, overlapping and repeated (R1) or disjoint (R2), cutoffs of
            0, 1, 3, 10^30 and -1; R1 also at the region sets its tiling
            treats differently, ``selfcheck.r1_regions``), and C1's record
            form on seeded records
            (every CIGAR op, 0xFF qualities, no SEQ; sorted into a box,
            unsorted over a sparse panel with N ops across many blocks; with
            and without -min_baseq).
            The similarity's moments (X7, ``correlation_moments``) at n = 1,
            15, 16 and 17, at an n off its 16-byte steps, with a constant
            first row (the NaN route), at n = 2^29 + 7 with a first row of
            2s (sxx past 2^31), at rows of 255s (every step adds its most
            to the 32-bit partials), at rows 1 and 8 bytes off 16 (byte
            loads), and on fixed grids through the library's test entry
            (one block whose threads walk 4,200 steps, past the 4,096 after
            which they widen their partials, with rows of 255s and of
            genotypes; 1,000 blocks); timed at an exome's and a WGS VCF
            pair's overlap (n = 100,000 and 4,500,000) beside ``torch.mm``
            of the float64 stack [1; x; y] with its transpose (the same
            sums), and at the WGS pair's ``upload_genotypes`` (its 9 MB
            host-to-card copy alone and the whole call, host's clock).
            VariantQC's record classification (V1, ``variant_classify``) at
            ``selfcheck.VARIANT_EDGES`` (no INFO and ``.``, CSQ a flag and
            empty, keys that only start with CSQ or RS, ``|rs`` and
            ``|HIGH|`` at a value's ends and across a ``;``, RS without
            CSQ, multi-allelic, lower-case and MNP alleles, FILTER ``.``,
            ``PASS;low`` and ``mosaic`` alone and in lists, FORMAT without
            GT, GT ``./.``, an INFO over 64 KiB), with no records, at
            ``selfcheck.variant_seams``' records (``CSQ=``, ``;RS=rs``,
            ``|rs``, ``|HIGH|``, a CSQ value's end, ALT's ``,``, the GT key
            and the GT value at every offset of a 16-byte chunk and across
            the 512-byte step in which a warp reads a record; INFOs of 511,
            512, 513 and 1,025 bytes) and at 20,000 random records (timed
            there until the variants phase times it), each with and without
            the FILTER test; RohHunter's
            ROH products (H1, ``roh_products``) at ``roh_edge_inputs``
            (single markers, the whole array, af 0, products that go
            subnormal and underflow to 0, an empty range, ranges outside the
            array; timed there likewise) joined with ``roh_exit_edges``
            (products that reach 0 or +inf and then meet a +inf, 0 or NaN
            square at every place the early exit cares for, NaN af with
            payloads and signs, -0.0 and -inf, 4,000 markers at af 1.0,
            every offset of a 32-marker chunk) and with no range, bit patterns
            equal.
            K1, unpack and tails also at MappingQC's -read_qc buckets. Times per
            call (``ops/selfcheck.py``): ``ms`` device time (10 calls captured
            in a CUDA graph, replays between CUDA events, median of 5,
            L2-warm); ``call_ms`` the same 10 calls made from Python (the
            wrapper's host work included); ``cold_ms`` (every kernel at its
            main input) one call after a 128 MB overwrite
            and read, median of 20, and the share of the bound against it;
            ``plain_ms`` as ``call_ms``.
            ``--phase kernels`` stops here.
4. readqc   a seeded paired gzip FASTQ (2 x 500,000 reads x 151 bp) through
            the port's ReadQC CLI on the card, qcML then TXT, with every launch
            count reset before and read after (each ReadQC kernel's
            ``launches`` and ``launches_by_tool["ReadQC"]``, from the qcML run);
            then the first 100,000 reads of
            each file through ReadQC on the card and through the port's CPU
            route (NGSBITS_TORCH_DEVICE=cpu, a subprocess): qcML and TXT must
            be byte-identical once ``creation `` lines are dropped.
5. seqpurge seeded read pairs of a short-insert library (2 x 500,000 x 151
            bp; 2 x 1,000,000 until the annotate phase came) through the
            port's SeqPurge CLI on the card with -qc and -summary, counts
            reset before and read after: all seven kernels launched, the
            decisions once per batch of 10,000 pairs (50 times), and
            neither jax nor the JAX package loaded; each kernel's
            ``launches_by_tool["SeqPurge"]`` (the ReadQC kernels run on its
            -qc stream at B=16384). Prints
            pairs/s and the seconds by stage (scans and decisions: device
            time). Then the first 50,000 pairs on the card and on the
            CPU route, with the default flags and once with -ec -out3:
            decompressed FASTQs and the summary identical, qcML identical once
            ``creation `` lines are dropped.
6. mappingqc a seeded synthetic exome (utils/synth.py): chr1-10, X and Y,
            each its first 4.5 Mb, the bundled hg38 SNVs' reference alleles
            set; 16,875 regions of 100-400 bp around those SNVs and at
            random; 2 x 562,500 pairs of 151 bp, coordinate-sorted, 80% on
            or near target, duplicates, MAPQ 0, unmapped mates, clips and
            indels, heterozygous and homozygous SNPs. MappingQC -roi -read_qc
            with the contamination check on the card, counts reset before
            and read after (C1's read form, C2, B1's record form, unpack, K1
            and tails all launched, C1's span form and B1's index form not),
            the inputs it hands C1, C2 and B1's record form kept where it
            calls the coverage and pileup engines (host copies of each
            batch's reads, C2's difference array copied on the card, each
            batch's uploaded records: in the run's time; one a launch);
            prints reads/s and the seconds of each pass; C1's read form, C2
            and B1's record form against their plain versions at each of the
            run's launches, timed at the launch of median size (C1; B1's
            record form by its bases and deletions at the loci) and at C2's,
            C1's span form at the spans the host made of that launch's reads
            before the read form, B1's index form at the counter indices the
            host's join made of the median pileup launch's records (the
            library calls timed as the kernels are: ``index_add_`` for C1 on
            those spans, ``torch.bincount`` for B1; C2's yardstick cumsum +
            bincount and X6's sort route over the run's spans); runs the JAX
            package's host route on the same files in a subprocess
            (scripts/jax_host_route.py, with -debug for its stage times) and
            requires identical reports; then the first 65,536 records on
            the card and on the CPU route, qcML and TXT with -read_qc:
            identical once ``creation `` lines are dropped. Then RnaQC on the
            card on the same BAM: every tenth exome region as housekeeping
            genes, ``-roi`` the panel merged and sorted, splicing and
            expression TSVs of 20,000 genes (``synth.rna_tsvs``), counts
            reset before and read after (C1's read form and C2 launched,
            nothing else); prints its wall, seconds by stage and launches;
            then on the first 65,536 records the card against the CPU
            route, qcML identical once ``creation `` lines are dropped.
            ``--phase mappingqc`` runs only the kernels and this phase.
7. coverage BedCoverage, BedLowCoverage and BedHighCoverage on the card on
            the mappingqc phase's BAM (1,125,000 records), over three panels:
            its exome panel (16,875 regions, unmerged: BedCoverage, BedLow-
            and BedHighCoverage -cutoff 20, BedLowCoverage -cutoff 20
            -min_baseq 20), a dense panel (regions of 1-50 kb over half of
            each chromosome's first 4.5 Mb: BedCoverage, BedLowCoverage) and a
            whole-genome panel (one region a chromosome at GRCh38's lengths:
            24 boxes of up to 248,956,422 positions; BedLowCoverage,
            BedCoverage). Each run with counts reset before and read after
            (C1's record form, C2 and R1 or R2 launched, C1's span form
            not), every launch of C2's dense mode, R1 and R2 held against
            its plain version right after it, and in the exome BedCoverage
            and -min_baseq 20 runs every launch of C1's record form too (the
            coverage it added against the plain version's on the same
            records; the checks' time and memory kept out of the run's),
            C2's, R1's and R2's device time summed over every launch of the
            run with the bound of that work (CUDA events around each
            launcher call; ``whole_runs``), the D2H bytes of each finalize
            required to be per-region results; prints reads/s, seconds by
            stage, D2H bytes and the device memory peak. The exome and dense
            outputs must be byte-identical to the JAX package's host route
            (scripts/jax_host_route.py, timed beside); the whole-genome ones
            are held against the port's CPU route on the first 65,536
            records with the panel cut to chr1. Then C1's record form timed
            at the median launch of each of those two exome runs (warm and
            cold; the -min_baseq run's is its main shape), and C2's dense
            mode, R1 and R2 at the largest box of the exome's and of the
            whole genome's runs (chr1's whole length), timed. ``--phase
            coverage`` runs only the kernels and this phase.
8. similarity SampleSimilarity, SampleGender, SampleIdentity and CfDnaQC on
            the card, each run with counts reset before and read after and
            its output byte-identical to the JAX package's host route on the
            same files (scripts/jax_host_route.py; qcML without ``creation
            `` lines): SampleSimilarity -mode bam on the mappingqc phase's
            BAM and a second BAM of 2 x 281,250 pairs of another sample
            (another seed) with -min_cov 10 (the second BAM's target depth is
            about 12), -mode vcf on two seeded VCFs of 100,000 variants (80%
            of their keys shared; X7's route) and on a pair with a constant
            genotype vector (the NaN message); SampleGender -method xy, hetx
            and sry on the first BAM; SampleIdentity on both BAMs with
            -min_depth 2 -min_snps 1 (some of the 75 identity SNPs lie in the
            genome, off the panel: the count used is printed); CfDnaQC on the
            first BAM with -tumor_bam the second and a panel of windows around
            the genome's known SNPs annotated SNP_for_sample_identification
            and every tenth exome region. Prints each tool's wall and stage
            seconds, its launches and its calls in F10's tie band (where
            X7's moments show r at 0 or a decimal tie and the centred form
            is printed); every X7 launch of the VCF runs is held against its
            plain version and timed at the first's shape. Then F10's seeded
            exact zeros and ties (``selfcheck.f10_overlaps``, twelve each)
            through ``calculate_similarity`` on the card: one X7 launch and
            one band hit a call, printed as the centred form prints them.
            ``--phase similarity`` runs only the kernels and this phase.
9. callers  VcfMerge -bam, TrioMaternalContamination and BedAnnotateFreq on
            the card over a synthetic trio on the mappingqc phase's genome
            and panel (``utils/synth.py::trio_variants``: the known SNVs
            and random panel sites, 5,625 in all, 10% of them indels
            of 1-4 bases; a BAM of 2 x 281,250 pairs a member, written by
            three processes; VCFs of about 15,000 variants with a few per
            cent left out; a BED of the sites), each run with counts reset
            before and read after (B1's record form launched, and for
            VcfMerge its indel form; nothing else), each BAM swept once a
            tool (readers counted), the output byte-identical to the JAX
            package's host route (scripts/jax_host_route.py, timed
            beside; VcfMerge's ``##fileDate`` dropped only if the runs fall
            on two days); VcfMerge again with -threads 3 (the same launches
            and bytes). Prints each tool's wall and seconds by stage
            (set-up, sweep, fetch, output) and its launches. Then every
            launch of the indel form held against its plain version on
            the records it was given (the hits the run got, sorted; not
            in the runs' times; the sweep fetches a launch's hits only
            after its next launch, and each is held against the plain
            version over every locus, where the launch saw only the loci
            the batch can reach) and the form timed at the launch of median
            hits (``--save-indel-launch FILE`` saves its inputs). Prints
            VcfMerge's fetch stage. ``--phase callers`` runs only the
            kernels and this phase.
10. annotate VcfAnnotateFrequency -depth, VariantAnnotateFrequency -depth
            -mapq0 (and again with -target, the panel), VariantAnnotateASE
            and VcfCalculatePRS -details on the card on the callers phase's
            child: its BAM and VCF (about 14,600 variants, a tenth indels),
            a GSvar made from that VCF (``utils/synth.py::vcf_gsvar``: a
            genotype column), the VCF bgzipped with a tabix index
            (``bgzip_tabix``) and a PRS VCF of 2,000 of the trio's sites
            (``prs_vcf``: some IMPUTE, some REF_IS_EFFECT_ALLELE, 100
            percentiles). Each run with counts reset before and read after
            (B1's record form and its region form launched, nothing else),
            the BAM swept once (readers counted), the outputs byte-identical
            to the JAX package's host route (scripts/jax_host_route.py,
            timed beside). Prints each tool's wall and seconds by stage
            (set-up, details with its sweep and fetch, output; the PRS's
            details and scoring), the region form's scratch zero after each
            run. Then every launch of the region form held against its plain
            version on the records it was given (the hits the run got,
            sorted; not in the runs' times), and launched again alone: one
            device operation (its launch captured into a CUDA graph of one
            node), its scratch left zero, the plain version's counters and
            hits; the form timed at the launch of median hits, with its
            wrapper's call (its hits waited for at once, and as the sweep
            makes it: the hits read after the next call)
            (``--save-region-launch FILE`` saves its inputs; the callers
            phase does the same for the indel form's median launch).
            ``--phase annotate`` runs only the
            kernels and this phase (generating the exome's genome and panel
            and the trio).
11. somatic SomaticQC on the card over a tumor/normal pair on the mappingqc
            phase's genome (``utils/synth.py``): a panel of about 2 Mb of
            the exome panel's regions that hold a known SNP; 2,000 somatic
            variants in it (``somatic_variants``: a tenth indels, about 70%
            PASS, the rest filtered, three SNVs on known SNPs), the tumor's
            SNVs at an allele share of 0.2; a normal and a tumor BAM of 2 x
            500,000 pairs of one person (``synth_bam``'s ``somatic``),
            written by two processes; a Strelka-flavoured VCF with gnomAD
            AFs (``somatic_vcf``). SomaticQC with ``-target_bed``,
            ``-target_exons`` (the exome panel), ``-blacklist`` and
            ``-tsg_bed``, then without a target on the genome's first four
            chromosomes (a FASTA of its own: plots 2 and 3 read the whole
            genome), both with plots. Each run with counts reset before and
            read after (B1's record form launched, nothing else), each BAM
            swept once (readers counted), B1's launches printed for each
            sweep; prints the wall and seconds by stage; the qcML equal to
            the port's CPU route on the same files once ``creation `` lines
            are dropped. Then every launch of B1's record form held against
            its plain version and the launch of median counts timed (kept
            beside the record's main shape as ``somatic_median``).
            ``--phase somatic`` runs only the kernels and this phase
            (generating the exome's genome and panel).
12. variants VariantQC and RohHunter on the card over a WGS-shaped
            single-sample VCF (``utils/synth.py::wgs_vcf``: a record a 982
            bases over chr1 and chr2 at GRCh38's lengths and chrX's first 50
            Mb, 551,069 records, a VEP CSQ of one to four transcripts, phase
            blocks, 20-40 planted ROH segments of 1-15 Mb) and ``roh_beds``'
            exclude and annotation BEDs: VariantQC as qcML, with ``-txt
            -ignore_filter`` and with ``-long_read -phasing_bed``, RohHunter
            with ``-var_af_keys_vep gnomAD_AF,AF -exclude -annotate`` (two
            BEDs) and with ``-var_af_keys AF -inc_chrx``; each run with
            counts reset before and read after (V1 once a VariantQC run, H1
            twice a RohHunter run: the raw runs and the final regions;
            nothing else), its wall and seconds of parse, pack, kernel and
            host printed; the first run of each tool traced by
            ``utils/trace.py::device_profile`` and its device busy share
            printed from the trace; the regions on chrX counted (some with
            ``-inc_chrx``, none without). Then the same five runs on the
            first 45,000 records and chrX's first 5,000 on the card and on
            the CPU route (five processes at once): every output
            byte-identical (qcML without ``creation `` lines). Then every V1
            and H1 launch of those runs (the prefix's on the card too) held
            against its plain version on the card (counts equal, the
            products' bit patterns equal, and equal to what the run got), V1
            timed at the ``-ignore_filter`` run's launch (its bound counts
            the bytes the counts need, ``selfcheck.variant_needed_bytes``)
            and at the qcML run's (the FILTER test: ``filtered_launch`` in
            its record) and H1 at the first RohHunter run's two (the final regions' plain
            version once: it takes a step a marker of the longest region),
            each with its longest range, its longest chain of multiplies
            before the product leaves the positive finite numbers
            (``selfcheck.roh_chain``) and the chain floor: that chain times
            one dependent float64 multiply's latency (a one-thread chain of
            2^22 ``__dmul_rn``, ``H1_PROBE``) plus the launch floor (an
            empty kernel, cold); then ``NgsBitsInfo``'s lines.
            ``--phase variants`` runs only the kernels and this phase.
13. mesh    the mesh layer (``ngsbits_tpu_torch/parallel/mesh.py``). At a
            world of one on NCCL: ``dryrun_multichip(1)`` (the five sharded
            steps at the JAX dryrun's shapes, each held inside the rank
            against the same kernels on the whole input: K1, C1's span form
            and C2, K2, the counters, X7 on uint8 genotype codes), then with
            ``NGSBITS_MESH=1`` in this process ReadQC on 2 x ``MESH_READS``
            reads (a prefix of the readqc phase's FASTQs: its last batch
            odd), SeqPurge -qc on the seqpurge phase's prefix of
            ``SP_PREFIX`` pairs, MappingQC -roi -read_qc (with the
            contamination check) on the mappingqc phase's whole BAM and its
            panel, BedCoverage and BedLowCoverage -min_baseq 20 on the exome BAM
            and panel; each byte-compared with the same tool without the
            mesh in this call, launch counts reset before and read after.
            Then two ranks on the one card over gloo (a check of the
            sharding, not of NCCL: NCCL refuses two ranks on one device):
            ``dryrun_multichip(2)``, ReadQC and BedCoverage on the same
            inputs, each rank a process of this script (``--mesh-rank``),
            outputs byte-compared with the world of one's; the kernels'
            launch counts of rank 1 printed. Each run prints its wall and
            the bytes it handed ``all_reduce`` and ``all_gather``.
            ``--phase mesh`` runs only the kernels and this phase
            (generating its inputs).

Each phase's line prints the seconds since the script started.

The CPU route is where the plain kernel versions run; the CPU tests hold them
against the JAX package. This script imports only torch, numpy, the stdlib and
ngsbits_tpu_torch. Before its last line it prints one JSON line with the
kernels' records (the times at each kernel's main shape, K1's at each
input under ``inputs``, unpack's and tails' at both of their shapes under
``shapes``; ``bound_ms`` is the larger of bytes over 3.35 TB/s and
integer operations over 16.7 T/s (H1's float64 multiplies over 34 T/s),
K1's bytes those inside the reads, K2's
operations its compares four to a 32-bit operation, the decisions' bytes
the counts and bases that their inputs need them to read).
The last line is {"ok": true, "device": {...}}. Data is written under
build/chip_smoke/ and removed at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import multiprocessing
import os
import re
import subprocess
import sys
import shutil
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import torch

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
N_READS, READ_LEN = 500_000, 151
RQ_PREFIX, SP_PREFIX = 100_000, 50_000
A1 = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
A2 = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
ADAPTERS = {"default": (A1, A2),
            "with_n": (b"AGANCGGAAGNGCACACGTC", b"NGATCGGAAGAGCGTCGTGN")}
# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s; int32 operations/s,
# 132 SMs x 64 INT32 lanes x 1.98 GHz; float64 operations/s outside the
# tensor cores
PEAK_BYTES, PEAK_INT_OPS, PEAK_FP64_OPS = 3.35e12, 16.7e12, 34e12
KERNELS = {  # name: (source, the TPU/XLA function it replaces)
    "readqc_unpack": ("ngsbits_tpu_torch/csrc/readqc.cu", "ngsbits_tpu/ops/readqc.py:144"),
    "readqc_batch": ("ngsbits_tpu_torch/csrc/readqc.cu", "ngsbits_tpu/ops/pallas_kernels.py:53"),
    "readqc_tails": ("ngsbits_tpu_torch/csrc/readqc.cu", "ngsbits_tpu/ops/readqc.py:183"),
    "insert_scan": ("ngsbits_tpu_torch/csrc/seqpurge.cu", "ngsbits_tpu/ops/pallas_kernels.py:153"),
    "adapter_evidence": ("ngsbits_tpu_torch/csrc/seqpurge.cu", "ngsbits_tpu/ops/seqpurge.py:123"),
    "adapter_scan": ("ngsbits_tpu_torch/csrc/seqpurge.cu", "ngsbits_tpu/ops/seqpurge.py:147"),
    # not a TPU kernel: the JAX package's host decisions (and native/seqpurge.cpp:116)
    "seqpurge_decide": ("ngsbits_tpu_torch/csrc/seqpurge_decide.cu",
                        "ngsbits_tpu/qc/seqpurge.py:267"),
    # X6's sort-and-search behind DeviceCoverage.add, its finalize (with the
    # prefix sum and histogram of mapping_stats.py:636-641 and :477), and
    # DeviceBincount (X6 with an empty ends side)
    "coverage_add": ("ngsbits_tpu_torch/csrc/coverage.cu", "ngsbits_tpu/ops/device_reduce.py:77"),
    # the same X6, with MappingQC's flattening of its reads onto the ROI
    # before it (ngsbits_tpu/qc/mapping_stats.py:284-305)
    "coverage_add_reads": ("ngsbits_tpu_torch/csrc/coverage.cu",
                           "ngsbits_tpu/ops/device_reduce.py:77"),
    # the same X6, with the host's span making and -min_baseq expansion
    # before it (ngsbits_tpu/qc/coverage.py:243-300, :376-390)
    "coverage_add_records": ("ngsbits_tpu_torch/csrc/coverage.cu",
                             "ngsbits_tpu/ops/device_reduce.py:77"),
    "coverage_finalize": ("ngsbits_tpu_torch/csrc/coverage.cu",
                          "ngsbits_tpu/ops/device_reduce.py:128"),
    "bincount_add": ("ngsbits_tpu_torch/csrc/coverage.cu", "ngsbits_tpu/ops/device_reduce.py:135"),
    # the same DeviceBincount, with the host's per-op expansion, join against
    # the loci and base, deletion and MAPQ-0 counts before it
    # (ngsbits_tpu/qc/pileup.py:126-251)
    "pileup_add_records": ("ngsbits_tpu_torch/csrc/pileup.cu",
                           "ngsbits_tpu/ops/device_reduce.py:135"),
    # not a TPU kernel: the JAX package's host indel pileup, a Python loop over
    # every I and D op (VcfMerge's re-calling)
    "pileup_indels": ("ngsbits_tpu_torch/csrc/pileup.cu", "ngsbits_tpu/qc/pileup.py:278"),
    # not a TPU kernel: the JAX package's host get_indels, a numpy filter of
    # each batch for each indel region and a Python CIGAR walk of each read
    # over it (the variant-details path)
    "pileup_regions": ("ngsbits_tpu_torch/csrc/pileup.cu",
                       "ngsbits_tpu/qc/variant_details.py:115"),
    # X7: the jitted moments of _corr_fn behind pearson_from_genotypes
    "correlation_moments": ("ngsbits_tpu_torch/csrc/similarity.cu",
                            "ngsbits_tpu/ops/device_reduce.py:167"),
    # not TPU kernels: the host's region sums (prefix sums) and threshold runs
    # (masks) of the coverage tools
    "region_sums": ("ngsbits_tpu_torch/csrc/coverage.cu", "ngsbits_tpu/qc/coverage.py:131"),
    "threshold_runs": ("ngsbits_tpu_torch/csrc/coverage.cu", "ngsbits_tpu/qc/coverage.py:409"),
    # not TPU kernels: VariantQC's host loops over every record (and phasing's
    # het count) and RohHunter's host product of af^2 over a run's markers
    "variant_classify": ("ngsbits_tpu_torch/csrc/variants.cu",
                         "ngsbits_tpu/qc/variant_stats.py:49"),
    "roh_products": ("ngsbits_tpu_torch/csrc/variants.cu", "ngsbits_tpu/tools/roh_hunter.py:51"),
}
SP_BATCH = 10000  # SeqPurge's -block_size: one decisions launch per batch
# the kernels SeqPurge with -qc runs: the ReadQC stream's three and its own four
SP_PATH = ("readqc_unpack", "readqc_batch", "readqc_tails", "insert_scan",
           "adapter_evidence", "adapter_scan", "seqpurge_decide")
# MappingQC's inputs: chr1-10, X and Y, each its first 4.5 Mb; a clinical-exome
# panel; 2 x 562,500 pairs of 151 bp (utils/synth.py). Until the mesh phase
# came, 24 chromosomes of 8 Mb, 60,000 regions and 2 x 2,000,000 pairs: 9/32 of
# the genome and of each count sampled from it keeps every depth the same, and
# a chromosome's panel still spans more than 4 Mb, so the coverage tools take
# their sparse route on the exome panel.
MQ_CHROMS = {f"chr{c}": 4_500_000 for c in [*range(1, 11), "X", "Y"]}
MQ_PAIRS, MQ_REGIONS, MQ_PREFIX = 562_500, 16_875, 65_536
MQ_ALL_SNPS = 100_779   # the bundled hg38 SNPs


def phase(name: str):
    print(f"== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


def run(cmd: list[str], **kw) -> subprocess.CompletedProcess:
    res = subprocess.run(cmd, capture_output=True, text=True, **kw)
    if res.returncode != 0:
        raise RuntimeError(f"{cmd[0]} exited {res.returncode}:\n{res.stderr}")
    return res


# ------------------------------------------------------------------ phases

def probe():
    phase("probe")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA runtime {torch.version.cuda}, "
          f"devices {torch.cuda.device_count()}, {torch.cuda.get_device_name(0)}")
    from ngsbits_tpu_torch.ops import _build
    nvcc = _build.nvcc_path()
    print(f"nvcc {nvcc}: {run([nvcc, '--version']).stdout.strip().splitlines()[-1]}")
    try:
        import triton
        print(f"triton {triton.__version__} imports")
    except ImportError as exc:
        print(f"triton does not import: {exc}")


# H1's yardsticks, built beside the kernels: a one-thread chain of dependent
# float64 multiplies (its latency), an empty kernel (the launch floor) and
# __dmul_rn of pairs (what the card's multiply makes of NaN operands).
H1_PROBE = r"""
#include <cuda_runtime.h>
__global__ void dmul_chain(double x, double y, long long n, double* out, long long* cycles) {
    double p = x;
    const long long t0 = clock64();
    for (long long i = 0; i < n; ++i) p = __dmul_rn(p, y);
    cycles[0] = clock64() - t0;
    out[0] = p;
}
__global__ void empty_kernel() {}
__global__ void pair_mul(const double* a, const double* b, double* out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = __dmul_rn(a[i], b[i]);
}
extern "C" {
int ngs_probe_dmul_chain(double x, double y, long long n, double* out, long long* cycles,
                         cudaStream_t s) {
    dmul_chain<<<1, 1, 0, s>>>(x, y, n, out, cycles);
    return static_cast<int>(cudaGetLastError());
}
int ngs_probe_empty(cudaStream_t s) {
    empty_kernel<<<1, 32, 0, s>>>();
    return static_cast<int>(cudaGetLastError());
}
int ngs_probe_mul(const double* a, const double* b, double* out, int n, cudaStream_t s) {
    pair_mul<<<(n + 255) / 256, 256, 0, s>>>(a, b, out, n);
    return static_cast<int>(cudaGetLastError());
}
}
"""
H1_CHAIN = 1 << 22   # multiplies of the latency probe's chain


def start_h1_probe(out_dir: Path) -> tuple[subprocess.Popen, Path]:
    """Starts nvcc on ``H1_PROBE`` into ``out_dir``: (the process, the library)."""
    from ngsbits_tpu_torch.ops import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    src, so = out_dir / "h1_probe.cu", out_dir / "libh1_probe.so"
    src.write_text(H1_PROBE)
    return subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
                             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), so


def load_h1_probe(proc: subprocess.Popen, so: Path):
    import ctypes
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the H1 probe:\n{log}")
    lib = ctypes.CDLL(str(so))
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.ngs_probe_dmul_chain.argtypes = [ctypes.c_double, ctypes.c_double, ll, p, p, p]
    lib.ngs_probe_empty.argtypes = [p]
    lib.ngs_probe_mul.argtypes = [p, p, p, ctypes.c_int, p]
    return lib


def h1_floors(lib) -> dict:
    """One dependent float64 multiply's latency (ns and SM cycles, from a
    one-thread chain of ``H1_CHAIN``), and the launch floor: an empty
    kernel's device and cold ms."""
    from ngsbits_tpu_torch.ops import selfcheck
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    out = torch.zeros(1, dtype=torch.float64, device="cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")

    def chain():
        if lib.ngs_probe_dmul_chain(1.0, 1.0 + 2.0 ** -40, H1_CHAIN, out.data_ptr(),
                                    cycles.data_ptr(), stream()):
            raise RuntimeError("the multiply chain did not launch")

    def empty():
        if lib.ngs_probe_empty(stream()):
            raise RuntimeError("the empty kernel did not launch")
    chain()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    chain()
    b.record()
    torch.cuda.synchronize()
    return {"dmul_ns": a.elapsed_time(b) * 1e6 / H1_CHAIN,
            "dmul_cycles": int(cycles.item()) / H1_CHAIN,
            "launch_ms": selfcheck.device_ms(empty), "launch_cold_ms": selfcheck.cold_ms(empty)}


def build():
    phase("build")
    from ngsbits_tpu_torch.io import native
    from ngsbits_tpu_torch.ops import _build
    host: dict = {}

    def build_host():
        try:
            host["result"] = native.build()
        except Exception as exc:  # noqa: BLE001 — re-raised below
            host["error"] = exc

    t = threading.Thread(target=build_host)
    t.start()
    h1_probe = start_h1_probe(WORK.parent / "h1_probe")
    so, seconds = _build.build()
    t.join()
    if "error" in host:
        raise host["error"]
    hso, hseconds = host["result"]
    print(f"built {hso.relative_to(ROOT)} (g++) in {hseconds:.2f} s")
    print(f"built {so.relative_to(ROOT)} (nvcc) in {seconds:.2f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())
    _build.library()
    native.get_lib()
    return load_h1_probe(*h1_probe)


# K1's inputs: (label, B, L, qual_bits, quality profile, read length or None
# for ragged lengths 0..L, valid rows or None for all but the last eighth).
# The first is the main path's: full ReadQC batches of 151 bp reads from a
# binning instrument.
K1_INPUTS = [
    ("B=65536 L=192 151bp binned", 65536, 192, 6, "binned", 151, 65536),
    ("B=65536 L=192 151bp uniform", 65536, 192, 6, "uniform", 151, 65536),
    ("B=65536 L=192 ragged uniform", 65536, 192, 6, "uniform", None, None),
    ("B=65536 L=192 ragged uniform 8-bit", 65536, 192, 8, "uniform", None, None),
    ("B=16384 L=192 10000x151bp binned", 16384, 192, 6, "binned", 151, 10000),
    ("B=1024 L=10240 ragged uniform 8-bit", 1024, 10240, 8, "uniform", None, None),
    # MappingQC -read_qc: a BAM batch of 65,536 records split by mate, each
    # mate's share (about 32,768) in the bucket of 32,768 or 65,536 rows
    ("B=32768 L=192 32600x151bp binned", 32768, 192, 6, "binned", 151, 32600),
    ("B=65536 L=192 32900x151bp binned", 65536, 192, 6, "binned", 151, 32900),
]
# where unpack and tails are timed: ReadQC's batch, SeqPurge's -qc bucket and
# MappingQC's -read_qc buckets
STREAM_SHAPES = (K1_INPUTS[0][0], K1_INPUTS[4][0], K1_INPUTS[6][0], K1_INPUTS[7][0])


def _check_equal(case, label: str) -> int:
    from ngsbits_tpu_torch.ops import selfcheck
    case.kernel()
    case.plain()
    torch.cuda.synchronize()
    err = selfcheck.max_abs_err(case)
    if err != 0:
        raise AssertionError(f"{case.name} ({label}) differs from its plain "
                             f"version: max abs err {err}")
    return err


def _kernel_record(records: dict, name: str) -> dict:
    """The kernel's record in the JSON line, made on first use."""
    source, replaces = KERNELS[name]
    return records.setdefault(name, {"name": name, "route": "cuda", "source": source,
                                     "replaces": replaces, "launches": 0, "max_abs_err": 0})


def _record(records: dict, case, label: str, main_shape: bool,
            cold: bool = False, library=None, library_graph: bool = True,
            peak_ops: float = PEAK_INT_OPS) -> dict:
    """Checks the case, times it and returns its numbers; at the kernel's
    main shape they become its record's. ``library`` is one PyTorch call
    that computes the same function on the same inputs, timed as the kernel
    is: ``library_ms`` per call from Python, ``library_device_ms`` in a CUDA
    graph (None, not measured, without ``library_graph``: a call that
    synchronises cannot be captured) and, with ``cold``,
    ``library_cold_ms``."""
    from ngsbits_tpu_torch.ops import selfcheck
    err = _check_equal(case, label)
    bytes_ms = case.bytes / PEAK_BYTES * 1e3
    ops_ms = case.ops / peak_ops * 1e3
    launches = case.device_fn or case.kernel  # R2: its launches without the fetch between
    got = dict(shape=label, ms=selfcheck.device_ms(launches),
               call_ms=selfcheck.call_ms(case.kernel),
               plain_ms=selfcheck.call_ms(case.plain),
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bytes=case.bytes)
    if cold:
        got["cold_ms"] = selfcheck.cold_ms(launches)
    got["library_ms"] = None if library is None else selfcheck.call_ms(library)
    lib_text = ""
    if library is not None:
        got["library_device_ms"] = selfcheck.device_ms(library) if library_graph else None
        lib_text = (", library: device " + (f"{got['library_device_ms']:.4f}" if library_graph
                                            else "not measured (it synchronises)"))
        if cold:
            got["library_cold_ms"] = selfcheck.cold_ms(library)
            lib_text += f", cold {got['library_cold_ms']:.4f}"
        lib_text += f", per call {got['library_ms']:.4f} ms"
    print(f"{case.name:16s} {label}: equal; device {got['ms']:.4f} ms"
          + (f", cold {got['cold_ms']:.4f} ms ({got['bound_ms'] / got['cold_ms']:.1%} "
             f"of the bound)" if cold else "")
          + f", per wrapper call {got['call_ms']:.4f} ms, plain "
          f"{got['plain_ms']:.4f} ms" + lib_text
          + f"; bound {got['bound_ms']:.4f} ms "
          f"({case.bytes} B, {case.ops} ops)", flush=True)
    rec = _kernel_record(records, case.name)
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    if main_shape:
        rec.update({k: v for k, v in got.items() if k != "bytes"})
    return got


def kernels(dev: torch.device) -> dict:
    """Every kernel against its plain version; device, per-call and plain
    times. K1 at each of ``K1_INPUTS`` (warm and cold); unpack and tails at
    each, timed (warm and cold) at ``STREAM_SHAPES``; the scans and the
    decisions warm and cold at their main inputs, K2 also at its edges."""
    from ngsbits_tpu_torch.ops import selfcheck
    records: dict = {}
    phase("kernels: ReadQC")
    k1, stream = [], {"readqc_unpack": [], "readqc_tails": []}
    for i, (label, B, L, qual_bits, profile, read_len, n_valid) in enumerate(K1_INPUTS):
        for case in selfcheck.cases(B, L, qual_bits, dev, seed=i, profile=profile,
                                    read_len=read_len, n_valid=n_valid):
            if case.name == "readqc_batch":
                k1.append(_record(records, case, label, i == 0, cold=True))
            elif label in STREAM_SHAPES:
                stream[case.name].append(_record(records, case, label, i == 0, cold=True))
            else:
                _check_equal(case, label)
    records["readqc_batch"]["inputs"] = k1
    for name, shapes in stream.items():
        records[name]["shapes"] = shapes
    phase("kernels: SeqPurge at B=10000, L=151 and B=1237, L=250 (random bytes "
          "past the reads, all-N pairs); K2 at B=1000, L=1000 and B=3, L=24576 "
          "(its edges)")
    for (B, L) in ((10000, 151), (1237, 250)):
        for name, (a1, a2) in sorted(ADAPTERS.items()):
            for a_size in (20, 15):
                main = (B, L, name, a_size) == (10000, 151, "default", 20)
                for case in selfcheck.seqpurge_cases(B, L, dev, a1, a2, a_size=a_size,
                                                     seed=B + a_size, dirty=not main):
                    _record(records, case, f"B={B} L={L} {name} a_size={a_size}", main,
                            cold=main)
    for B, L in ((1000, 1000), (3, 24576)):
        case = selfcheck.insert_case(*(torch.from_numpy(a).to(dev) for a in
                                       selfcheck.insert_edge_pairs(B, L, seed=B + L)))
        label = f"B={B} L={L} edges"
        _check_equal(case, label)
        print(f"{case.name:16s} {label}: equal", flush=True)
    phase("kernels: SeqPurge decisions at B=10000, L=151 (with and without -ec), "
          "B=1237, L=250 and B=1237, L=999 (random bytes past the reads, all-N pairs)")
    for B, L, name, ec in ((SP_BATCH, READ_LEN, "default", False),
                           (SP_BATCH, READ_LEN, "default", True),
                           (1237, 250, "default", False), (1237, 250, "with_n", True),
                           (1237, 999, "default", True)):
        main = (B, L, ec) == (SP_BATCH, READ_LEN, False)
        case = selfcheck.decide_case(B, L, dev, *ADAPTERS[name], ec=ec, seed=B + L,
                                     dirty=L != READ_LEN)
        label = f"B={B} L={L} {name}{' -ec' if ec else ''}"
        if main:
            _record(records, case, label, True, cold=True)
        else:
            _check_equal(case, label)
            print(f"{case.name:16s} {label}: equal", flush=True)
    coverage_edges(records, dev)
    similarity_kernels(records, dev)
    variant_kernels(records, dev)
    return records


def _hist_params(avg_depth: float, cfdna: bool = False) -> tuple[int, int, int, int]:
    """(step, hist_max, bins, half_depth) as MappingQC's ROI mode makes them."""
    from ngsbits_tpu_torch.core.histogram import Histogram
    from ngsbits_tpu_torch.qc.mapping_stats import _depth_histogram_params
    half, hist_max, step = _depth_histogram_params(avg_depth, cfdna, adaptive=True)
    return step, hist_max, Histogram(0, hist_max, step).bin_count(), half


def coverage_edges(records: dict, dev: torch.device):
    """C1, C2 and B1 against their plain versions at their edges: span 1;
    spans at 0 and at the end, of length 0; a span that is not a multiple
    of C2's tile; piles at and above hist_max; cfDNA's and the adaptive
    histogram parameters; B1's hot bins and all of the bundled SNPs."""
    import numpy as np
    from ngsbits_tpu_torch.ops import selfcheck
    phase("kernels: MappingQC's C1, C2 and B1 at their edges (at the main "
          "path's inputs after the mappingqc phase)")
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    odd = 3 * 8192 + 17
    edge_spans = {
        "span=1": (np.array([0, 0, 1, 0], np.int32), np.array([0, 1, 1, 1], np.int32), 1),
        f"span={odd}": (*selfcheck.coverage_spans(odd, 5000, seed=24), odd),
    }
    for label, (es, ee, sp) in edge_spans.items():
        _check_equal(selfcheck.coverage_add_case(t(es), t(ee), sp), label)
        print(f"coverage_add     {label}: equal", flush=True)
    from ngsbits_tpu_torch.ops import device_reduce as dr
    for label, n, kw in (("1 read", 1, {}), ("31 reads", 31, {}),
                         ("3000 reads, 3 chromosomes", 3000, {}),
                         ("45000 reads, 24 chromosomes of 2500 regions", 45_000,
                          dict(n_chroms=24, n_regions=2500, width=8_000_000))):
        (_, rs, re), (_, qs, qe, i0, i1) = selfcheck.roi_reads(n, seed=n, **kw)
        sp = int((re - rs + 1).sum())
        regions = dr.DeviceCoverage(sp, dev, regions=np.stack([rs, re])).regions
        reads = t(np.stack([qs, qe, i0, i1]).astype(np.int32))
        _check_equal(selfcheck.coverage_add_reads_case(reads, regions, sp), label)
        print(f"coverage_add_reads {label} (edges, no region, several regions, no reference "
              f"length, the last region): equal", flush=True)
    cases = [("span=1, dense", edge_spans["span=1"], (1, 0, 1, 1), True),
             (f"span={odd}, dense", edge_spans[f"span={odd}"], (5, 599, 120, 1), True)]
    for avg, cfdna, pile in ((40, False, 599), (40, False, 600), (250, False, 1000),
                             (600, False, 1500), (1200, False, 2500), (900, True, 20000),
                             (900, True, 20001)):
        params = _hist_params(avg, cfdna)
        es, ee = selfcheck.coverage_spans(odd, 5000, seed=pile, pile=pile)
        cases.append((f"span={odd}, a pile of {pile}, step={params[0]} hist_max={params[1]}",
                      (es, ee, odd), params, False))
    for label, (es, ee, sp), params, dense in cases:
        d = selfcheck.coverage_diff(es, ee, sp, dev)
        _check_equal(selfcheck.coverage_finalize_case(d, *params, dense=dense), label)
        print(f"coverage_finalize {label}: equal", flush=True)
    for label, ix in (
            ("hot bins", selfcheck.pileup_indices(MQ_ALL_SNPS, 2000, seed=25, hot=20000)),
            ("all bundled SNPs", selfcheck.pileup_indices(MQ_ALL_SNPS, 4 * MQ_ALL_SNPS,
                                                          seed=26))):
        _check_equal(selfcheck.bincount_case(t(ix), 4 * MQ_ALL_SNPS), label)
        print(f"bincount_add     {label} (size={4 * MQ_ALL_SNPS}, n={len(ix)}): equal",
              flush=True)
    phase("kernels: the contamination pileup's B1 record form at its edges (at the main "
          "path's inputs after the mappingqc phase)")
    for label in selfcheck.PILEUP_EDGES:
        for params in selfcheck.PILEUP_PARAMS:
            _check_equal(selfcheck.pileup_edge_case(label, params, dev), f"{label} {params}")
        print(f"pileup_add_records {label}: records without SEQ, 0xFF qualities, every CIGAR "
              f"op, loci at op edges and repeated; (min_mapq, min_baseq, track_mapq0, "
              f"include_not_properly_paired) in {selfcheck.PILEUP_PARAMS}: equal", flush=True)
    phase("kernels: B1's indel form at its edges (at the main path's inputs after the "
          "callers phase)")
    for label in selfcheck.INDEL_EDGES:
        rec, eng, mq, window, capacity, cut = selfcheck.indel_edge_inputs(label, dev)
        case = selfcheck.pileup_indels_case(rec, eng.loci, eng.table, mq, window, capacity, cut)
        where = "shared" if cut[1] - cut[0] <= dr.INDEL_STAGED_LOCI else "global"
        if where == "global":  # timed: the loci past the shared memory's limit
            _record(records, case, f"{label}: {rec.pos.shape[0]} records, {cut[1] - cut[0]} "
                    f"loci reached", False, cold=True)
        else:
            _check_equal(case, label)
        print(f"pileup_indels    {label}: I and D ops first and last in records, loci at the "
              f"window's edges and middle, just outside and repeated, records without SEQ, "
              f"MAPQ 0; {cut[1] - cut[0]} loci reached, searched in {where} memory; "
              f"{case.outputs()[0][0].shape[0]} hits: equal", flush=True)
    phase("kernels: B1's region form at its edges (at the main path's inputs after the "
          "annotate phase)")
    for label in selfcheck.REGION_EDGES:
        rec, eng, capacity, cut = selfcheck.region_edge_inputs(label, dev)
        case = selfcheck.pileup_regions_case(rec, eng.regions, eng.table, capacity, cut)
        if label == "6,000 regions reached":  # timed: the most regions a thread walks
            _record(records, case, f"{label}: {rec.pos.shape[0]} records, {cut[1] - cut[0]} "
                    f"regions reached", False, cold=True)
        else:
            _check_equal(case, label)
        print(f"pileup_regions   {label}: I and D ops at region edges and at one g, long and "
              f"repeated regions, long N ops, records without SEQ or reference span, MAPQ 0, a "
              f"chromosome the BAM lacks; {cut[1] - cut[0]} regions reached, a table of "
              f"{eng.table.shape[1]} references; "
              f"{case.outputs()[0][1].shape[0]} hits: counters and hits equal", flush=True)
    phase("kernels: the coverage tools' C1 record form, C2 (dense mode), R1 and R2 at "
          "their edges (at the main path's inputs after the coverage phase)")
    rng = np.random.default_rng(27)
    s = np.cumsum(rng.integers(500, 3000, size=300))
    e = s + rng.integers(20, 300, size=300)
    sparse = torch.tensor(np.stack([s, e, np.concatenate(([0], np.cumsum(e - s)[:-1]))]),
                          device=dev)
    for label, args, ref, blocks, span in (
            ("sorted, a box past the reads", dict(n=5000, seed=28, width=30_000), 0,
             torch.tensor([[9000], [21_000], [0]], device=dev), 12_000),
            ("unsorted, sparse, N ops over many blocks",
             dict(n=5000, seed=29, width=int(e[-1]), n_refs=2, ordered=False, long_n=40_000),
             1, sparse, int((e - s).sum()))):
        cols = selfcheck.alignment_records(**args)
        keys = selfcheck.records_keys(cols, (cols["flag"] & 0x704) == 0)
        rec = dr.upload_records(cols["pos"], keys, cols["cigar_off"], cols["cigar"],
                                cols["seq_off"], cols["qual"], device=dev)
        for min_baseq in (0, 20):
            _check_equal(selfcheck.coverage_add_records_case(rec, 0, len(keys), ref, min_baseq,
                                                             blocks, span), label)
        print(f"coverage_add_records {label}, -min_baseq 0 and 20: equal", flush=True)
    for label, (es, ee, sp) in edge_spans.items():
        d = selfcheck.coverage_diff(es, ee, sp, dev)
        _check_equal(selfcheck.coverage_dense_case(d), label)
        print(f"coverage_finalize {label}, dense mode alone: equal", flush=True)
        cov = torch.cumsum(d[:-1], 0).to(torch.int32)
        for disjoint in (False, True):
            regions = selfcheck.coverage_regions(sp, 300, seed=sp, disjoint=disjoint)
            _check_equal(selfcheck.region_sums_case(cov, *regions), label)
            print(f"region_sums      {label}, {len(regions[0])} "
                  f"{'disjoint' if disjoint else 'overlapping'} regions: equal", flush=True)
        regions = selfcheck.coverage_regions(sp, 300, seed=sp + 1, disjoint=True)
        for cutoff, high in ((0, False), (1, False), (3, False), (3, True), (10**30, False),
                             (-1, True)):
            _check_equal(selfcheck.threshold_runs_case(cov, *regions, cutoff, high), label)
        print(f"threshold_runs   {label}, {len(regions[0])} regions, cutoffs 0, 1, 3, "
              f"3 (high), 10^30, -1 (high): equal", flush=True)
    for kind in selfcheck.R1_KINDS:  # where R1's tiling differs
        sp, rs, re = selfcheck.r1_regions(kind, seed=30)
        es, ee = selfcheck.coverage_spans(sp, max(sp // 50, 4), seed=31, pile=700)
        cov = torch.cumsum(selfcheck.coverage_diff(es, ee, sp, dev)[:-1], 0).to(torch.int32)
        _check_equal(selfcheck.region_sums_case(cov, rs, re), kind)
        print(f"region_sums      {kind}: {len(rs)} regions, {int((re - rs + 1).sum())} "
              f"positions over a span of {sp}: equal", flush=True)
        del cov


# one block of 256 threads, each walking 4,200 16-byte steps of each row:
# past the 4,096 after which a thread widens its 32-bit partials
X7_WIDEN_N = 16 * 256 * 4200 + 3
X7_EDGES = (  # label, n, kind, grid (None: the wrapper's), bytes the rows lie off 16
    ("n=1", 1, "related", None, 0), ("n=15", 15, "related", None, 0),
    ("n=16", 16, "related", None, 0), ("n=17", 17, "related", None, 0),
    ("n=4099 (off the 16-byte steps)", 4099, "related", None, 0),
    ("n=100003, a constant first row (the NaN route)", 100_003, "constant", None, 0),
    ("n=2^29+7, a first row of 2s (sxx = 4n past 2^31)", (1 << 29) + 7, "all 2", None, 0),
    ("n=4500000, rows of 255s (each step adds its most to the 32-bit partials)", 4_500_000,
     "all 255", None, 0),
    ("n=70000, rows 1 byte off 16 (byte loads)", 70_000, "related", None, 1),
    ("n=70000, rows 8 bytes off 16 (byte loads)", 70_000, "related", None, 8),
    (f"n={X7_WIDEN_N}, rows of 255s on one block (4,200 steps a thread, past the widening "
     f"at 4,096)", X7_WIDEN_N, "all 255", 1, 0),
    (f"n={X7_WIDEN_N} on one block", X7_WIDEN_N, "related", 1, 0),
    ("n=100003 on 1000 blocks (more than its 6,250 steps' threads need)", 100_003, "related",
     1000, 0),
)
X7_SHAPES = (("n=100000, an exome VCF pair's overlap", 100_000),
             ("n=4500000, a WGS VCF pair's overlap", 4_500_000))


def _x7_rows(n: int, kind: str, seed: int, offset: int, dev: torch.device) -> torch.Tensor:
    """``selfcheck.genotype_rows`` on the card, the rows ``offset`` bytes
    past a 16-byte boundary."""
    from ngsbits_tpu_torch.ops import selfcheck
    flat = torch.zeros(2 * n + offset, dtype=torch.uint8, device=dev)
    g = flat[offset:].view(2, n)
    g.copy_(torch.from_numpy(selfcheck.genotype_rows(n, seed=seed, kind=kind)))
    return g


def _x7_library(g: torch.Tensor):
    """One ``torch.mm`` of the float64 stack [1; x; y] with its transpose:
    n, sx, sy, sxx, sxy and syy, exact below 2^53."""
    x, y = g.to(torch.float64)
    stack = torch.stack([torch.ones_like(x), x, y])
    return lambda: torch.mm(stack, stack.t())


def _x7_record(records: dict, g: torch.Tensor, label: str, main_shape: bool):
    """X7 checked and timed at ``g``, beside the library call (whose sums
    are checked once against the plain version's)."""
    from ngsbits_tpu_torch.ops import device_reduce as dr
    from ngsbits_tpu_torch.ops import selfcheck
    lib = _x7_library(g)
    m = lib().round().to(torch.int64).cpu()
    plain = torch.zeros(5, dtype=torch.int64, device=g.device)
    dr.correlation_moments_plain(g, plain)
    if [int(m[0, 1]), int(m[0, 2]), int(m[1, 1]), int(m[2, 2]), int(m[1, 2])] != plain.tolist():
        raise AssertionError(f"correlation_moments {label}: torch.mm gives other sums")
    got = _record(records, selfcheck.correlation_moments_case(g), label, main_shape, cold=True,
                  library=lib)
    records["correlation_moments"].setdefault("shapes", []).append(got)
    return got


def _upload_ms(x, y, dev: torch.device) -> tuple[float, float]:
    """Milliseconds of ``upload_genotypes`` (doubling, checks, the padded
    host buffer and its copy to the card) and of that buffer's host-to-card
    copy alone, each the median of five calls on the host's clock, the card
    synchronised after each."""
    import statistics
    from ngsbits_tpu_torch.ops import device_reduce as dr
    buf = dr.upload_genotypes(x, y, "cpu")
    times: dict = {"upload": [], "copy": []}
    for _ in range(6):
        for name, fn in (("upload", lambda: dr.upload_genotypes(x, y, dev)),
                         ("copy", lambda: buf.to(dev))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return tuple(statistics.median(times[k][1:]) for k in ("upload", "copy"))


def similarity_kernels(records: dict, dev: torch.device):
    """X7 against its plain version at its edges (through the wrapper, or on
    a fixed grid through the library's test entry) and timed at the main
    shapes (an exome's and a WGS VCF pair's overlap), with the upload of
    the WGS pair's genotypes beside it."""
    from ngsbits_tpu_torch.ops import device_reduce as dr
    from ngsbits_tpu_torch.ops import selfcheck
    phase("kernels: the similarity's moments (X7) at its edges, and at an exome's and a WGS "
          "VCF pair's overlap")
    for k, (label, n, kind, grid, offset) in enumerate(X7_EDGES):
        g = _x7_rows(n, kind, 40 + k, offset, dev)
        case = selfcheck.correlation_moments_case(g, grid=grid)
        _check_equal(case, label)
        sums = case.outputs()[0][0].tolist()
        if kind == "all 2" and (sums[0], sums[2], sums[4]) != (2 * n, 4 * n, 2 * sums[1]):
            raise AssertionError(f"correlation_moments {label}: sums {sums}")
        if kind == "all 255" and sums != [255 * n] * 2 + [255 * 255 * n] * 3:
            raise AssertionError(f"correlation_moments {label}: sums {sums}")
        if kind == "constant":
            r = dr.pearson_from_genotypes(*(g.cpu().numpy() / 2.0), device=dev)
            if r == r:
                raise AssertionError(f"correlation_moments {label}: r = {r}, not NaN")
        print(f"correlation_moments {label}: equal; sums {sums}", flush=True)
        del g, case
    torch.cuda.empty_cache()
    for i, (label, n) in enumerate(X7_SHAPES):
        rows = selfcheck.genotype_rows(n, seed=50 + i)
        g = torch.from_numpy(rows).to(dev)
        got = _x7_record(records, g, label, i == 0)
        if n == X7_SHAPES[-1][1]:
            got["upload_ms"], got["copy_ms"] = _upload_ms(*(rows / 2.0), dev)
            print(f"upload_genotypes n={n}: {got['upload_ms']:.4f} ms a call on the host's clock, "
                  f"of it the {2 * n}-byte host-to-card copy {got['copy_ms']:.4f} ms; X7 "
                  f"{got['cold_ms']:.4f} ms cold, {got['ms']:.4f} warm", flush=True)


@contextlib.contextmanager
def _capture_x7_inputs():
    """The genotype rows X7 is handed while the block runs, in call order,
    taken where the similarity calls ``genotype_moments`` (the same
    upload, made again on the card); each call goes on to it, whose wrapper
    launches and counts."""
    from ngsbits_tpu_torch.ops import device_reduce as dr
    from ngsbits_tpu_torch.qc import sample_similarity as ss
    got: list = []
    moments = ss.genotype_moments

    def capture(x, y, device=None):
        got.append(dr.upload_genotypes(x, y, device))
        return moments(x, y, device)

    ss.genotype_moments = capture
    try:
        yield got
    finally:
        ss.genotype_moments = moments


@contextlib.contextmanager
def _capture_coverage_inputs():
    """What MappingQC hands C1's read form, C2 and B1's record form while
    the block runs, in launch order, taken where the engines
    (``DeviceCoverage.add_reads`` and ``histogram``, ``DevicePileup.add``)
    are called; each call goes on to the engine, whose wrappers launch and
    count. Yields ``{"coverage_add_reads": [(reads, regions, span)],
    "coverage_finalize": [(diff, step, hist_max, bins, half_depth)],
    "pileup_add_records": [(rec, loci, table, min_mapq, min_baseq,
    track_mapq0)]}``: host int32 copies of the reads (``[4, k]`` as they go
    up), the ROI's regions as the engine holds them on the card, C2's
    difference array as a copy on the card, and each batch's records as
    they went up (a fresh upload a batch, kept) with the engine's loci and
    table on the card."""
    import numpy as np
    from ngsbits_tpu_torch.ops.device_reduce import DeviceCoverage, DevicePileup
    got: dict = {"coverage_add_reads": [], "coverage_finalize": [], "pileup_add_records": []}
    cov_add, cov_histogram, pileup_add = (DeviceCoverage.add_reads, DeviceCoverage.histogram,
                                          DevicePileup.add)

    def coverage_add_reads(self, starts, ends, i0, i1):
        if len(starts):
            got["coverage_add_reads"].append((np.stack([starts, ends, i0, i1]).astype(np.int32),
                                              self.regions, self.span))
        cov_add(self, starts, ends, i0, i1)

    def histogram(self, step, hist_max, bins, half_depth):
        got["coverage_finalize"].append((self.diff.clone(), step, hist_max, bins, half_depth))
        return cov_histogram(self, step, hist_max, bins, half_depth)

    def add_records(self, rec, min_mapq, min_baseq, indel_ops=0, loci_range=None):
        got["pileup_add_records"].append((rec, self.loci, self.table, min_mapq, min_baseq,
                                          self.mapped is not None))
        return pileup_add(self, rec, min_mapq, min_baseq, indel_ops, loci_range)

    DeviceCoverage.add_reads, DeviceCoverage.histogram, DevicePileup.add = (
        coverage_add_reads, histogram, add_records)
    try:
        yield got
    finally:
        DeviceCoverage.add_reads, DeviceCoverage.histogram, DevicePileup.add = (
            cov_add, cov_histogram, pileup_add)


def _median_launch(launches: list, size) -> tuple[int, tuple]:
    """(index, inputs) of the launch of median ``size``."""
    order = sorted(range(len(launches)), key=lambda i: size(launches[i]))
    i = order[len(order) // 2]
    return i, launches[i]


def _sweep_call_ms(call, calls: int = 200) -> float:
    """Host milliseconds a call of a B1 form's wrapper as the sweep makes it
    (``wait=False``: the launch, its copy and event queued, the hits read
    after the next call), by ``time.perf_counter`` over ``calls`` calls."""
    for _ in range(3):
        call().hits()
    torch.cuda.synchronize()
    prev, t0 = None, time.perf_counter()
    for _ in range(calls):
        got = call()
        if prev is not None:
            prev.hits()
        prev = got
    prev.hits()
    return (time.perf_counter() - t0) / calls * 1e3


def _flattened(reads: torch.Tensor, regions: torch.Tensor) -> tuple:
    """The int32 spans MappingQC's host made of these reads before C1's read
    form (a span a pair of a read and a region of its range, clipped; the
    JAX package's flattening)."""
    import numpy as np
    qs, qe, i0, i1 = reads.cpu().numpy().astype(np.int64)
    rs, re, off = regions.cpu().numpy().astype(np.int64)
    cnt = i1 - i0
    rep = np.repeat(np.arange(len(qs)), cnt)
    r = np.repeat(i0, cnt) + (np.arange(int(cnt.sum()))
                              - np.repeat(np.concatenate(([0], np.cumsum(cnt)[:-1])), cnt))
    lo, hi = np.maximum(rs[r], qs[rep]), np.minimum(re[r], qe[rep])
    s = off[r] + lo - rs[r]
    return s.astype(np.int32), (s + hi - lo + 1).astype(np.int32)


def mappingqc_kernels(records: dict, got: dict, dev: torch.device):
    """C1's read form, C2 and B1's record form against their plain versions
    at every launch of the mappingqc phase's run, on the inputs that run
    handed them (``_capture_coverage_inputs``); timed at the launch of
    median size (C1; B1's record form by its bases and deletions at the
    loci) and at C2's launch, with the library calls and C2's yardsticks.
    C1's span form is timed at the spans the host made of the median
    launch's reads before the read form (the same work, and
    ``index_add_``'s), B1's index form at the counter indices the host's
    join made of the median pileup launch's records before the record form
    (the same counts, and ``torch.bincount``'s)."""
    from ngsbits_tpu_torch.ops import device_reduce as dr
    from ngsbits_tpu_torch.ops import selfcheck
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    adds = [(t(r), regions, span) for r, regions, span in got["coverage_add_reads"]]
    piles = got["pileup_add_records"]
    fins = got["coverage_finalize"]
    n_reads = [r.shape[1] for r, _, _ in adds]
    # each pileup launch's counts, one by one: (locus, base) of its bases and deletions
    hits = [dr.pileup_hits(rec, loci, table, mq, bq)[1:3]
            for rec, loci, table, mq, bq, _ in piles]
    n_hits = [j.shape[0] for j, _ in hits]
    phase(f"kernels: MappingQC's C1 read form, C2 and B1's record form at the mappingqc run's "
          f"inputs: C1 {len(adds)} launches of {min(n_reads)}-{max(n_reads)} reads "
          f"({sum(n_reads)} in all), C2 {len(fins)}, B1's record form {len(piles)} of "
          f"{min(r[0].pos.shape[0] for r in piles)}-{max(r[0].pos.shape[0] for r in piles)} "
          f"records with {min(n_hits)}-{max(n_hits)} bases and deletions at the loci "
          f"({sum(n_hits)} in all)")
    for k, (r, regions, span) in enumerate(adds):
        _check_equal(selfcheck.coverage_add_reads_case(r, regions, span), f"launch {k}")
    for k, args in enumerate(piles):
        _check_equal(selfcheck.pileup_case(*args), f"launch {k}")
    print(f"coverage_add_reads and pileup_add_records: equal at each of the run's launches",
          flush=True)

    k, (r, regions, span) = _median_launch(adds, lambda a: a[0].shape[1])
    s, e = (t(a) for a in _flattened(r, regions))
    idx_both = torch.cat([s, e]).to(torch.int64)
    signs = torch.cat([torch.ones_like(s), -torch.ones_like(e)])
    lib_diff = torch.zeros(span + 1, dtype=torch.int32, device=dev)
    index_add = lambda: lib_diff.index_add_(0, idx_both, signs)  # noqa: E731
    label = (f"launch {k} of {len(adds)} (median): {r.shape[1]} reads, {s.shape[0]} (read, "
             f"region) pairs, into a span of {span} ({regions.shape[1]} regions)")
    _record(records, selfcheck.coverage_add_reads_case(r, regions, span), label, True,
            cold=True, library=index_add)
    _record(records, selfcheck.coverage_add_case(s, e, span), f"{label}, as the host's spans",
            True, cold=True, library=index_add)

    for k, (diff, step, hist_max, bins, half) in enumerate(fins):
        span = diff.shape[0] - 1
        got_c2 = _record(records, selfcheck.coverage_finalize_case(
            diff, step, hist_max, bins, half),
            f"launch {k} of {len(fins)}: span={span} step={step} hist_max={hist_max} "
            f"bins={bins} half_depth={half}", k == len(fins) - 1, cold=True)

    def yardstick():  # index_add_ + cumsum + bincount: no single call computes C2
        cov = torch.cumsum(diff[:span], 0)
        torch.bincount(torch.clamp(torch.div(cov, step, rounding_mode="floor"), max=bins),
                       minlength=bins + 1)
        (cov >= half).sum()

    def sort_route():  # X6's form: sort the events, search every position
        sorted_s, sorted_e = torch.sort(all_s)[0], torch.sort(all_e)[0]
        (torch.searchsorted(sorted_s, positions, right=True)
         - torch.searchsorted(sorted_e, positions, right=True))

    spans = [_flattened(r, regions) for r, regions, _ in adds]
    all_s = torch.cat([t(a) for a, _ in spans])
    all_e = torch.cat([t(b) for _, b in spans])
    positions = torch.arange(span, dtype=torch.int32, device=diff.device)
    got_c2.update(yardstick_ms=selfcheck.call_ms(yardstick),
                  sort_route_ms=selfcheck.call_ms(sort_route))
    records["coverage_finalize"].update(yardstick_ms=got_c2["yardstick_ms"],
                                        sort_route_ms=got_c2["sort_route_ms"])
    print(f"coverage_finalize yardstick (cumsum + bincount): {got_c2['yardstick_ms']:.4f} ms; "
          f"X6's sort route over the run's {all_s.shape[0]} spans (two sorts, two searches "
          f"of {span} positions): {got_c2['sort_route_ms']:.4f} ms", flush=True)

    k, _ = _median_launch(list(range(len(piles))), lambda a: n_hits[a])
    rec, loci, table, mq, bq, track = piles[k]
    n_kept = int((rec.keep >= 0).sum())
    _record(records, selfcheck.pileup_case(rec, loci, table, mq, bq, track),
            f"launch {k} of {len(piles)} (median): {rec.pos.shape[0]} records ({n_kept} kept), "
            f"{n_hits[k]} bases and deletions at {loci.shape[0]} loci, min_mapq {mq}, "
            f"min_baseq {bq}", True, cold=True)
    j, base = hits[k]
    i = (j * 4 + base)[base < dr.DELETION].to(torch.int32)
    size = 4 * loci.shape[0]
    _record(records, selfcheck.bincount_case(i, size),
            f"the host's indices of pileup launch {k} of {len(piles)} (median): {i.shape[0]} "
            f"indices into {size} counters", True, cold=True,
            library=lambda: torch.bincount(i, minlength=size), library_graph=False)


def _drop_creation(path: Path) -> list[str]:
    return [line for line in path.read_text().splitlines() if "creation " not in line]


def _reset():
    from ngsbits_tpu_torch.ops import KERNELS as wrappers
    for k in wrappers:
        k.launches = 0


def _launches() -> dict:
    from ngsbits_tpu_torch.ops import KERNELS as wrappers
    return {k.__name__.removesuffix("_into"): k.launches for k in wrappers}


def _port(args: list[str]):
    """A port tool in this process, on the card: (tool, seconds)."""
    from ngsbits_tpu_torch.tools import get_tool
    tool = get_tool(args[0])()
    t0 = time.perf_counter()
    rc = tool.execute(args[1:])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"port {args[0]} exited {rc}")
    return tool, seconds


def _port_on_cpu(args: list[str]):
    """A port tool on its CPU route, in a subprocess."""
    run([sys.executable, "-m", "ngsbits_tpu_torch", *args], cwd=ROOT,
        env=dict(os.environ, NGSBITS_TORCH_DEVICE="cpu"))


def _prefix(src: Path, dst: Path, n_reads: int):
    """The first n_reads records of a gzip FASTQ, as gzip."""
    with gzip.open(src, "rb") as fin, gzip.open(dst, "wb", compresslevel=1) as fout:
        for _ in range(4 * n_reads):
            fout.write(fin.readline())


def _jax_loaded() -> list[str]:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "ngsbits_tpu"))


def readqc(records: dict):
    phase(f"readqc: 2 x {N_READS} reads x {READ_LEN} bp")
    from ngsbits_tpu_torch.utils.synth import synth_fastq
    f1, f2 = WORK / "rq1.fastq.gz", WORK / "rq2.fastq.gz"
    t0 = time.perf_counter()
    synth_fastq(f1, N_READS, READ_LEN, seed=42)
    synth_fastq(f2, N_READS, READ_LEN, seed=43)
    print(f"generated {f1.stat().st_size + f2.stat().st_size} gzip bytes in "
          f"{time.perf_counter() - t0:.2f} s")
    total = 2 * N_READS
    for fmt, flags in (("qcML", []), ("txt", ["-txt"])):
        out = WORK / f"ReadQC.{fmt}"
        _reset()
        _, seconds = _port(["ReadQC", "-in1", str(f1), "-in2", str(f2),
                            "-out", str(out), *flags])
        launches = _launches()
        for name in ("readqc_unpack", "readqc_batch", "readqc_tails"):
            if launches[name] == 0:
                raise AssertionError(f"{name} was not launched by ReadQC: {launches}")
            if fmt == "qcML":
                records[name]["launches"] = launches[name]
                records[name]["launches_by_tool"] = {"ReadQC": launches[name]}
        if fmt == "txt" and f"read count: {total}" not in out.read_text():
            raise AssertionError("TXT output lacks the expected read count")
        print(f"ReadQC {fmt} on {torch.cuda.get_device_name(0)}: {seconds:.3f} s, "
              f"{total / seconds:.0f} reads/s; launches {launches}")

    p1, p2 = WORK / "rq1.prefix.fastq.gz", WORK / "rq2.prefix.fastq.gz"
    _prefix(f1, p1, RQ_PREFIX)
    _prefix(f2, p2, RQ_PREFIX)
    for fmt, flags in (("qcML", []), ("txt", ["-txt"])):
        out = WORK / f"ReadQC.prefix.{fmt}"  # one path: qcML records the command line
        args = ["ReadQC", "-in1", str(p1), "-in2", str(p2), "-out", str(out), *flags]
        _port(args)
        on_card = out.replace(out.with_name(f"card.{out.name}"))
        _port_on_cpu(args)
        if _drop_creation(on_card) != _drop_creation(out):
            raise AssertionError(f"ReadQC {fmt}: card and CPU route differ")
        print(f"ReadQC {fmt} on 2 x {RQ_PREFIX} reads: card == CPU route")
    if _jax_loaded():
        raise AssertionError(f"the port loaded {_jax_loaded()}")


def _seqpurge_args(d: Path, i1: Path, i2: Path, extra: list[str]) -> list[str]:
    d.mkdir(parents=True, exist_ok=True)
    return ["SeqPurge", "-in1", str(i1), "-in2", str(i2),
            "-out1", str(d / "out1.fastq.gz"), "-out2", str(d / "out2.fastq.gz"),
            "-qc", str(d / "qc.qcML"), "-summary", str(d / "summary.txt"),
            *[a.format(d=d) for a in extra]]


def _same_outputs(card: Path, cpu: Path):
    names = sorted(p.name for p in card.iterdir())
    if names != sorted(p.name for p in cpu.iterdir()):
        raise AssertionError(f"outputs differ: {names}")
    for name in names:
        a, b = card / name, cpu / name
        if name.endswith(".gz"):
            same = gzip.decompress(a.read_bytes()) == gzip.decompress(b.read_bytes())
        elif name.endswith(".qcML"):
            same = _drop_creation(a) == _drop_creation(b)
        else:
            same = a.read_bytes() == b.read_bytes()
        if not same:
            raise AssertionError(f"SeqPurge {name}: card and CPU route differ")
    return names


def seqpurge(records: dict):
    phase(f"seqpurge: 2 x {N_READS} pairs x {READ_LEN} bp, -qc -summary")
    from ngsbits_tpu_torch.utils.synth import synth_pairs
    f1, f2 = WORK / "sp1.fastq.gz", WORK / "sp2.fastq.gz"
    t0 = time.perf_counter()
    synth_pairs(f1, f2, N_READS, seed=7, read_len=READ_LEN)
    print(f"generated {f1.stat().st_size + f2.stat().st_size} gzip bytes in "
          f"{time.perf_counter() - t0:.2f} s")
    _reset()
    tool, seconds = _port(_seqpurge_args(WORK / "sp_full", f1, f2, []))
    launches = _launches()
    if min(launches[name] for name in SP_PATH) == 0:
        raise AssertionError(f"a kernel was not launched by SeqPurge -qc: {launches}")
    if launches["seqpurge_decide"] != N_READS // SP_BATCH:
        raise AssertionError(f"seqpurge_decide launched {launches['seqpurge_decide']} "
                             f"times, not once per batch ({N_READS // SP_BATCH})")
    for name in ("insert_scan", "adapter_evidence", "adapter_scan", "seqpurge_decide"):
        records[name]["launches"] = launches[name]
    for name in SP_PATH:
        records[name].setdefault("launches_by_tool", {})["SeqPurge"] = launches[name]
    if _jax_loaded():
        raise AssertionError(f"the port loaded {_jax_loaded()}")
    summary = (WORK / "sp_full" / "summary.txt").read_text()
    if f"Reads (forward + reverse): {2 * N_READS}" not in summary:
        raise AssertionError("the summary lacks the expected read count")
    print(summary.split("\n\nForward adapter")[0])
    stages = tool.engine.seconds
    split = ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
    print(f"SeqPurge on {torch.cuda.get_device_name(0)}: {seconds:.3f} s, "
          f"{N_READS / seconds:.0f} pairs/s; seconds by stage: {split} "
          f"(scans: device time of the three scans; decisions: device time of "
          f"seqpurge_decide plus the host's fold of its accumulators; the rest "
          f"host time on the consumer thread); decisions + fetch "
          f"{stages['decisions'] + stages['fetch']:.3f} s; launches {launches}")

    p1, p2 = WORK / "sp1.prefix.fastq.gz", WORK / "sp2.prefix.fastq.gz"
    _prefix(f1, p1, SP_PREFIX)
    _prefix(f2, p2, SP_PREFIX)
    for label, extra in (("defaults", []), ("-ec -out3", ["-ec", "-out3", "{d}/single"])):
        _port(_seqpurge_args(WORK / "sp_card", p1, p2, extra))
        _port_on_cpu(_seqpurge_args(WORK / "sp_cpu", p1, p2, extra))
        names = _same_outputs(WORK / "sp_card", WORK / "sp_cpu")
        print(f"SeqPurge {label} on {SP_PREFIX} pairs: card == CPU route ({', '.join(names)})")
        shutil.rmtree(WORK / "sp_card")
        shutil.rmtree(WORK / "sp_cpu")


def _mq_args(d: Path, bam: Path, bed: Path, fa: Path, extra=()) -> list[str]:
    d.mkdir(parents=True, exist_ok=True)
    out = "out.txt" if "-txt" in extra else "out.qcML"
    return ["MappingQC", "-in", str(bam), "-roi", str(bed), "-ref", str(fa),
            "-out", str(d / out), "-read_qc", str(d / "read_qc.qcML"), *extra]


def _same_reports(a: Path, b: Path) -> list[str]:
    names = sorted(p.name for p in a.iterdir())
    if names != sorted(p.name for p in b.iterdir()):
        raise AssertionError(f"reports differ: {names}")
    return [n for n in names if _drop_creation(a / n) != _drop_creation(b / n)]


_MQ: dict = {}


def _mq_inputs() -> dict:
    """The synthetic exome of the mappingqc, coverage and similarity phases,
    made once: FASTA, panel, BAM and the BAM's first MQ_PREFIX records, and
    the genome, panel rows and known SNVs they were made of."""
    if _MQ:
        return _MQ
    from ngsbits_tpu_torch.utils import synth
    t0 = time.perf_counter()
    chrom, pos, ref, alt, af = synth.known_snvs(MQ_CHROMS)
    fa, bed, bam = WORK / "mq.fa", WORK / "mq.bed", WORK / "mq.bam"
    genome = synth.synth_genome(fa, MQ_CHROMS, seed=11, set_bases=[
        (name, pos[chrom == k], ref[chrom == k]) for k, name in enumerate(MQ_CHROMS)])
    roi = synth.synth_roi(bed, genome, MQ_REGIONS, seed=12, anchors=(chrom, pos - 1))
    snps = (chrom, pos - 1, alt)
    synth.synth_bam(bam, genome, MQ_PAIRS, seed=13, roi=roi, snps=snps)
    prefix = WORK / "mq.prefix.bam"
    synth.synth_bam(prefix, genome, MQ_PAIRS, seed=13, roi=roi, snps=snps,
                    max_records=MQ_PREFIX)
    print(f"generated {fa.stat().st_size} FASTA bytes, {len(roi[0])} regions "
          f"({int((roi[2] - roi[1]).sum())} bases before merging, windows around "
          f"{len(chrom)} known SNVs), {bam.stat().st_size} BAM bytes and its first "
          f"{MQ_PREFIX} records in {time.perf_counter() - t0:.2f} s", flush=True)
    _MQ.update(fa=fa, bed=bed, bam=bam, prefix=prefix, genome=genome, roi=roi, snps=snps,
               known=(chrom, pos, af))
    return _MQ


def mappingqc(records: dict):
    phase(f"mappingqc: 2 x {MQ_PAIRS} pairs x {READ_LEN} bp on {len(MQ_CHROMS)} chromosomes "
          f"({MQ_CHROMS['chr1'] / 1e6:g} Mb each), {MQ_REGIONS} target regions; -roi "
          f"-read_qc, contamination on")
    inp = _mq_inputs()
    fa, bed, bam = inp["fa"], inp["bed"], inp["bam"]

    reads = 2 * MQ_PAIRS
    card = WORK / "mq_card"
    with _capture_coverage_inputs() as got:
        _reset()
        tool, seconds = _port(_mq_args(card, bam, bed, fa))
        launches = _launches()
    path = ("coverage_add_reads", "coverage_finalize", "pileup_add_records",
            "readqc_unpack", "readqc_batch", "readqc_tails")
    for name in path:
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched by MappingQC: {launches}")
    if launches["coverage_add"]:
        raise AssertionError(f"MappingQC uploaded spans to C1's span form: {launches}")
    if launches["bincount_add"]:
        raise AssertionError(f"MappingQC's contamination check uploaded counter indices to "
                             f"B1's index form: {launches}")
    for name in path[:3]:
        if len(got[name]) != launches[name]:
            raise AssertionError(f"{name}: {len(got[name])} inputs copied, "
                                 f"{launches[name]} launches")
    if _jax_loaded():
        raise AssertionError(f"the port loaded {_jax_loaded()}")
    report = (card / "out.qcML").read_text()
    if 'name="SNV allele frequency deviation"' not in report or \
            re.search(r'name="SNV allele frequency deviation"[^>]*value="n/a"', report):
        raise AssertionError("contamination did not read a number")
    if not re.search(rf'name="read count"[^>]*value="{reads}"',
                     (card / "read_qc.qcML").read_text()):
        raise AssertionError(f"the -read_qc report lacks the read count {reads}")
    split = ", ".join(f"{k} {v:.4f}" for k, v in tool.seconds.items())
    print(f"MappingQC on {torch.cuda.get_device_name(0)}: {seconds:.3f} s, "
          f"{reads / seconds:.0f} reads/s (both mates); seconds by stage: {split} "
          f"(scan: the main QC's pass over the BAM with C1's read form; finalize: C2 and its "
          f"fetch; the contamination check's pileup runs B1's record form, one launch a "
          f"batch); launches {launches}", flush=True)

    depth = re.search(r'name="target region read depth"[^>]*value="([^"]+)"', report)
    print(f"target region read depth {depth.group(1) if depth else 'missing'}", flush=True)
    mappingqc_kernels(records, got, torch.device("cuda"))
    del got
    for name in path + ("bincount_add",):
        records[name].setdefault("launches_by_tool", {})["MappingQC"] = launches[name]
    for name in path[:3] + ("bincount_add",):
        records[name]["launches"] = launches[name]

    # -debug prints each stage's time to stderr and changes no report
    res = run([sys.executable, str(ROOT / "scripts" / "jax_host_route.py"),
               *_mq_args(WORK / "mq_jax", bam, bed, fa, ("-debug",))], cwd=ROOT)
    jax_s = float(res.stdout.strip().splitlines()[-1])
    stages = "; ".join(l.strip() for l in res.stderr.splitlines() if " took: " in l)
    differ = _same_reports(card, WORK / "mq_jax")
    if differ:
        raise AssertionError(f"MappingQC {differ}: the port and the JAX package differ")
    print(f"JAX package host route on the same files: {jax_s:.3f} s, "
          f"{reads / jax_s:.0f} reads/s ({stages}); reports identical to the port's",
          flush=True)

    prefix = inp["prefix"]
    for label, extra in (("qcML", ()), ("TXT", ("-txt",))):
        _port(_mq_args(WORK / "mq_pcard", prefix, bed, fa, extra))
        t0 = time.perf_counter()
        _port_on_cpu(_mq_args(WORK / "mq_pcpu", prefix, bed, fa, extra))
        cpu_s = time.perf_counter() - t0
        differ = _same_reports(WORK / "mq_pcard", WORK / "mq_pcpu")
        if differ:
            raise AssertionError(f"MappingQC {label} {differ}: card and CPU route differ")
        print(f"MappingQC {label} with -read_qc on the first {MQ_PREFIX} records: card == "
              f"CPU route ({cpu_s:.1f} s on the CPU)", flush=True)
        shutil.rmtree(WORK / "mq_pcard")
        shutil.rmtree(WORK / "mq_pcpu")
    rnaqc(records, inp)


def rnaqc(records: dict, inp: dict):
    """RnaQC on the card on the mappingqc phase's BAM: every tenth exome
    region as housekeeping genes (unmerged), ``-roi`` the exome panel merged
    and sorted, splicing and expression TSVs of 20,000 genes
    (``synth.rna_tsvs``); launches counted (C1's read form and C2, nothing
    else); then on the BAM's first ``MQ_PREFIX`` records the card against
    the CPU route."""
    from ngsbits_tpu_torch.core.intervals import BedFile
    from ngsbits_tpu_torch.utils import synth
    hk, roi = WORK / "housekeeping.bed", WORK / "mq_merged.bed"
    hk.write_text("".join(l + "\n" for l in inp["bed"].read_text().splitlines()[::10]))
    panel = BedFile.from_file(str(inp["bed"]))
    panel.sort()
    panel.merge()
    panel.store(str(roi))
    splicing, expression = WORK / "splicing.tsv", WORK / "expression.tsv"
    synth.rna_tsvs(splicing, expression, 20_000, seed=96)

    def args(bam: Path, out: Path) -> list[str]:
        return ["RnaQC", "-bam", str(bam), "-ref", str(inp["fa"]), "-housekeeping_genes",
                str(hk), "-roi", str(roi), "-splicing", str(splicing), "-expression",
                str(expression), "-out", str(out)]

    path = ("coverage_add_reads", "coverage_finalize")
    with _capture_coverage_inputs() as got:
        _reset()
        tool, seconds = _port(args(inp["bam"], WORK / "rna_card.qcML"))
        launches = _launches()
    for name in path:
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched by RnaQC: {launches}")
        if len(got[name]) != launches[name]:
            raise AssertionError(f"{name}: {len(got[name])} inputs copied, "
                                 f"{launches[name]} launches")
    other = {n: c for n, c in launches.items() if c and n not in path}
    if other:
        raise AssertionError(f"RnaQC launched kernels off its path: {other}")
    if _jax_loaded():
        raise AssertionError(f"the port loaded {_jax_loaded()}")
    for name in path:
        by_tool = records[name].setdefault("launches_by_tool", {})
        by_tool["RnaQC"] = launches[name]
        records[name]["launches"] = sum(by_tool.values())
    report = (WORK / "rna_card.qcML").read_text()
    depth = re.search(r'name="housekeeping genes read depth"[^>]*value="([^"]+)"', report)
    stages = ", ".join(f"{s} {v:.4f}" for s, v in tool.seconds.items())
    print(f"RnaQC on {torch.cuda.get_device_name(0)}: {seconds:.3f} s (stages: {stages}; scan: "
          f"the BAM pass with C1's read form, finalize: C2 and its fetch, tsv: the two TSVs); "
          f"housekeeping genes read depth {depth.group(1) if depth else 'missing'}; launches "
          f"{ {n: launches[n] for n in path} }", flush=True)
    if not depth:
        raise AssertionError("RnaQC did not report the housekeeping genes' depth")
    rnaqc_kernels(records, got, torch.device("cuda"))
    del got
    card, cpu = WORK / "rna_pcard.qcML", WORK / "rna_pcpu.qcML"
    _port(args(inp["prefix"], card))
    t0 = time.perf_counter()
    _port_on_cpu(args(inp["prefix"], cpu))
    cpu_s = time.perf_counter() - t0
    if _drop_creation(card) != _drop_creation(cpu):
        raise AssertionError("RnaQC: the card's and the CPU route's reports differ")
    print(f"RnaQC on the first {MQ_PREFIX} records: card == CPU route ({cpu_s:.1f} s on the "
          f"CPU)", flush=True)


def rnaqc_kernels(records: dict, got: dict, dev: torch.device):
    """C1's read form and C2 against their plain versions at every launch of
    RnaQC's run on the whole BAM, on the inputs that run handed them
    (``_capture_coverage_inputs``); timed at the read form's launch of
    median size and at C2's last launch. The kernels' records keep
    MappingQC's shapes; these numbers are printed."""
    from ngsbits_tpu_torch.ops import selfcheck
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    adds = [(t(r), regions, span) for r, regions, span in got["coverage_add_reads"]]
    fins = got["coverage_finalize"]
    n_reads = [r.shape[1] for r, _, _ in adds]
    phase(f"kernels: RnaQC's C1 read form and C2 at the rnaqc run's inputs: C1 {len(adds)} "
          f"launches of {min(n_reads)}-{max(n_reads)} reads ({sum(n_reads)} in all) into a "
          f"span of {adds[0][2]} ({adds[0][1].shape[1]} regions), C2 {len(fins)}")
    for k, (r, regions, span) in enumerate(adds):
        _check_equal(selfcheck.coverage_add_reads_case(r, regions, span), f"RnaQC launch {k}")
    print("coverage_add_reads: equal at each of RnaQC's launches", flush=True)
    k, (r, regions, span) = _median_launch(adds, lambda a: a[0].shape[1])
    _record(records, selfcheck.coverage_add_reads_case(r, regions, span),
            f"RnaQC launch {k} of {len(adds)} (median): {r.shape[1]} reads into a span of "
            f"{span} ({regions.shape[1]} regions)", False, cold=True)
    for k, (diff, step, hist_max, bins, half) in enumerate(fins):
        label = (f"RnaQC launch {k} of {len(fins)}: span={diff.shape[0] - 1} step={step} "
                 f"hist_max={hist_max} bins={bins} half_depth={half}")
        case = selfcheck.coverage_finalize_case(diff, step, hist_max, bins, half)
        if k == len(fins) - 1:
            _record(records, case, label, False, cold=True)
        else:
            _check_equal(case, label)
            print(f"coverage_finalize {label}: equal", flush=True)


# ------------------------------------------------------------ coverage tools

COV_CUTOFF = 20
CHR1 = "chr1"


class _CoverageChecks:
    """While a coverage tool runs on the card, in its engine
    (``DeviceCoverage``): every launch of C2's dense mode (``dense``), R1
    (``region_sums``) and R2 (``runs``) is held against its plain version on
    the same inputs right after it (the plain versions count no launch);
    with ``check_c1`` so is every launch of C1's record form
    (``add_records``: the coverage the launch added to the difference array
    against the plain version's on the same records), whose inputs are kept
    in ``c1`` for the timings after the run. The time the checks take and
    the memory they use are kept out of the tool's: ``seconds`` is what
    they took (``pass_seconds`` of it during the BAM pass, the rest in the
    finalize), ``peak`` the tool's own peak of allocated device memory.
    ``largest`` keeps, for the timings after the run, the inputs of the
    launch at the largest span of each kernel. ``device`` sums, for C2, R1
    and R2, the device time of every launch of the run (CUDA events around
    each call of their launchers in the kernel library: C2's memset and
    kernel, R1's memset and kernel, R2's count pass with its scan and its
    write pass; a spin of about 0.1 ms queued before each start event keeps
    the host's work out of the time), counts the launches and adds up the
    bytes that bound them (as ``ops/selfcheck.py``'s cases count them)."""

    def __init__(self, check_c1: bool = False):
        self.check_c1 = check_c1
        self.seconds = 0.0
        self.pass_seconds = 0.0   # the part of ``seconds`` taken in the BAM pass (C1's checks)
        self.peak = 0
        self.kept_bytes = 0   # allocated before the run, or kept by the checks
        self.c1: list = []
        self._c1_buffers: set = set()
        self.largest: dict = {}   # kernel -> (span, inputs)
        self.checked = {"coverage_add_records": 0, "coverage_finalize": 0, "region_sums": 0,
                        "threshold_runs": 0}
        # kernel -> [device ms, launches, bytes of the bound]
        self.device = {"coverage_finalize": [0.0, 0, 0], "region_sums": [0.0, 0, 0],
                       "threshold_runs": [0.0, 0, 0]}
        self._events: list = []   # (kernel, start, end) not yet read

    def _timed(self, name: str, fn, launch: bool = True):
        """``fn`` with CUDA events around each call, added to ``device[name]``
        (counted as a launch unless ``launch`` is false)."""
        def call(*args, **kw):
            torch.cuda._sleep(200_000)  # clock cycles: the stream stays busy while the host enqueues
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self._events.append((name, start, end))
            self.device[name][1] += launch
            return out
        return call

    def _read_events(self):
        for name, start, end in self._events:
            self.device[name][0] += start.elapsed_time(end)
        self._events.clear()

    def _begin(self) -> float:
        torch.cuda.synchronize()  # the tool's own work, in its time
        self.peak = max(self.peak, torch.cuda.max_memory_allocated() - self.kept_bytes)
        t0 = time.perf_counter()
        self._read_events()
        return t0

    def _end(self, t0: float):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.seconds += time.perf_counter() - t0

    def _keep(self, name: str, span: int, inputs):
        """Keeps ``inputs()`` if ``span`` is the largest of ``name`` so far."""
        old = self.largest.get(name)
        if old is None or span > old[0]:
            size = lambda x: sum(t.numel() * t.element_size() for t in x  # noqa: E731
                                 if isinstance(t, torch.Tensor))
            got = inputs()
            self.kept_bytes += size(got) - (0 if old is None else size(old[1]))
            self.largest[name] = (span, got)

    @contextlib.contextmanager
    def installed(self):
        import numpy as np
        from ngsbits_tpu_torch.ops import device_reduce as dr
        engine = dr.DeviceCoverage
        add, dense, sums, runs = engine.add_records, engine.dense, engine.region_sums, engine.runs

        def add_checked(eng, rec, r0, r1, ref, min_baseq):
            if not self.check_c1:
                return add(eng, rec, r0, r1, ref, min_baseq)
            seconds = self.seconds
            t0 = self._begin()
            before = eng.diff.clone()
            self.kept_bytes += before.nbytes
            self._end(t0)
            add(eng, rec, r0, r1, ref, min_baseq)
            t0 = self._begin()
            self.kept_bytes -= before.nbytes
            want = torch.zeros_like(eng.diff)
            dr.coverage_add_records_plain(rec, r0, r1, ref, min_baseq, eng.blocks, want)
            got = torch.cumsum((eng.diff - before)[:-1].to(torch.int64), 0)
            if not torch.equal(got, torch.cumsum(want[:-1].to(torch.int64), 0)):
                raise AssertionError(f"coverage_add_records differs from its plain version at "
                                     f"records [{r0}, {r1}) into a span of {eng.span}")
            self.checked["coverage_add_records"] += 1
            del before, want, got
            buf = rec.pos.untyped_storage()
            if buf.data_ptr() not in self._c1_buffers:  # a batch's upload, kept once
                self._c1_buffers.add(buf.data_ptr())
                self.kept_bytes += buf.nbytes()
            self.c1.append((rec, r0, r1, ref, min_baseq, eng.blocks, eng.span))
            self._end(t0)
            self.pass_seconds += self.seconds - seconds

        def dense_checked(eng):
            cov = dense(eng)
            self.device["coverage_finalize"][2] += 8 * eng.span + 4
            t0 = self._begin()
            want = torch.empty_like(cov)
            dr.coverage_finalize_plain(eng.diff, 1, 0, 0, None, None, want)
            if not torch.equal(cov, want):
                raise AssertionError(f"coverage_finalize (dense mode) differs from its plain "
                                     f"version at span {eng.span}")
            self.checked["coverage_finalize"] += 1
            eng.plain_cov = want  # the input of the R1 or R2 check that follows
            self._keep("coverage_finalize", eng.span, lambda: (eng.diff.clone(),))
            self._end(t0)
            return cov

        def region_sums(eng, starts, ends):
            got = sums(eng, starts, ends)
            positions = int((np.asarray(ends) - np.asarray(starts) + 1).sum())
            self.device["region_sums"][2] += 4 * positions + 20 * len(starts) + 8
            t0 = self._begin()
            cov = eng.__dict__.pop("plain_cov")
            s, off = eng._regions(starts, ends)
            want = torch.empty(len(starts), dtype=torch.int64, device=cov.device)
            dr.region_sums_plain(cov, s, off, want)
            if not np.array_equal(got, want.cpu().numpy()):
                raise AssertionError(f"region_sums differs from its plain version at span "
                                     f"{eng.span}")
            self.checked["region_sums"] += 1
            self._keep("region_sums", eng.span,
                       lambda: (cov, s.cpu().numpy(), off.cpu().numpy()))
            del cov
            self._end(t0)
            return got

        def runs_checked(eng, starts, ends, cutoff, is_high):
            got = runs(eng, starts, ends, cutoff, is_high)
            positions = int((np.asarray(ends) - np.asarray(starts) + 1).sum())
            self.device["threshold_runs"][2] += (4 * positions + 12 * len(starts) + 8 + 16
                                                 + 12 * len(got[0]))
            t0 = self._begin()
            cov = eng.__dict__.pop("plain_cov")
            s, off = eng._regions(starts, ends)
            want = dr.threshold_runs_plain(cov, s, off, cutoff, is_high).cpu().numpy()
            if not np.array_equal(np.stack(got), want):
                raise AssertionError(f"threshold_runs differs from its plain version at span "
                                     f"{eng.span}: {len(got[0])} runs, plain {want.shape[1]}")
            self.checked["threshold_runs"] += 1
            self._keep("threshold_runs", eng.span, lambda: (
                cov, s.cpu().numpy(), off.cpu().numpy(), cutoff, is_high))
            del cov
            self._end(t0)
            return got

        engine.add_records, engine.dense = add_checked, dense_checked
        engine.region_sums, engine.runs = region_sums, runs_checked
        lib = dr._lib
        real = lib()
        timed = {"ngs_coverage_finalize": self._timed("coverage_finalize",
                                                      real.ngs_coverage_finalize),
                 "ngs_region_sums": self._timed("region_sums", real.ngs_region_sums),
                 "ngs_runs_count": self._timed("threshold_runs", real.ngs_runs_count),
                 # one launch of threshold_runs: both passes
                 "ngs_runs_write": self._timed("threshold_runs", real.ngs_runs_write,
                                               launch=False)}

        class TimedLib:  # the kernel library, with events around C2's, R1's and R2's launchers
            def __getattr__(self, name):
                return timed.get(name) or getattr(real, name)

        dr._lib = TimedLib
        self.kept_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        try:
            yield self
        finally:
            engine.add_records, engine.dense = add, dense
            engine.region_sums, engine.runs = sums, runs
            dr._lib = lib
            torch.cuda.synchronize()
            self._read_events()
            self.peak = max(self.peak, torch.cuda.max_memory_allocated() - self.kept_bytes)


def _ends(starts, offsets):
    """Inclusive region ends from R1's and R2's (starts, offsets)."""
    return starts.astype("int64") + (offsets[1:] - offsets[:-1]) - 1


def _coverage_run(label: str, args: list[str], reads: int, check_c1: bool = False):
    """One coverage tool on the card with launch counts reset before and read
    after and every C2/R1/R2 launch checked, with ``check_c1`` every launch
    of C1's record form too: (tool, wall seconds without the checks,
    checks, launches)."""
    checks = _CoverageChecks(check_c1)
    with checks.installed():
        _reset()
        tool, seconds = _port(args)
        launches = _launches()
    wanted = ("coverage_add_records", "coverage_finalize",
              "region_sums" if args[0] == "BedCoverage" else "threshold_runs")
    for name in wanted:
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched by {args[0]} ({label}): {launches}")
    if launches["coverage_add"]:
        raise AssertionError(f"{args[0]} ({label}) uploaded spans to C1's span form: {launches}")
    checked = checks.checked["coverage_finalize"], checks.checked[wanted[2]]
    if checked != (launches["coverage_finalize"], launches[wanted[2]]):
        raise AssertionError(f"{label}: {checked} launches checked of {launches}")
    if check_c1 and checks.checked["coverage_add_records"] != launches[wanted[0]]:
        raise AssertionError(f"{label}: {checks.checked['coverage_add_records']} C1 launches "
                             f"checked of {launches[wanted[0]]}")
    from ngsbits_tpu_torch.ops.device_reduce import RUNS_COUNT_BYTES
    per_region = 8 if args[0] == "BedCoverage" else 12  # a region's sum; a run
    extra = 0 if args[0] == "BedCoverage" or not torch.cuda.is_available() else RUNS_COUNT_BYTES
    for span, fetched in tool.finalizes:
        if (fetched - extra) % per_region or fetched - extra < 0:
            raise AssertionError(f"{label}: a finalize over {span} positions fetched "
                                 f"{fetched} bytes, not per-region results")
    wall = seconds - checks.seconds
    stages = tool.seconds
    stages["pass"] -= checks.pass_seconds
    stages["finalize"] -= checks.seconds - checks.pass_seconds
    fetched = sum(b for _, b in tool.finalizes)
    dense = sum(4 * span for span, _ in tool.finalizes)
    device = ", ".join(f"{k} {ms:.4f} ms in {n} launches (bound {b / PEAK_BYTES * 1e3:.4f} ms)"
                       for k, (ms, n, b) in checks.device.items() if n)
    print(f"{label}: {args[0]} on {torch.cuda.get_device_name(0)}: {wall:.3f} s, "
          f"{reads / wall:.0f} reads/s; seconds by stage: "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f" (pass: BAM decode, host filter and C1; finalize: C2, then R1 or R2, and "
          f"their fetch; output: lines and file); D2H of the finalizes {fetched} bytes in "
          f"{len(tool.finalizes)} fetches (the int32 coverage would be {dense}); device "
          f"memory peak {checks.peak / 2**30:.3f} GiB; launches "
          f"{ {k: launches[k] for k in wanted} }; every "
          + ("C1 record-form, " if check_c1 else "")
          + f"C2 dense-mode and {wanted[2]} launch equal to its plain version (checks "
          f"{checks.seconds:.2f} s, not in the times); device time of the run's launches: "
          f"{device}", flush=True)
    return tool, wall, checks, launches


def _jax_route(args: list[str]) -> float:
    res = run([sys.executable, str(ROOT / "scripts" / "jax_host_route.py"), *args], cwd=ROOT)
    return float(res.stdout.strip().splitlines()[-1])


def coverage(records: dict, dev: torch.device):
    """BedCoverage, BedLowCoverage and BedHighCoverage on the card over the
    mappingqc phase's exome BAM: its panel, a dense panel and a whole-genome
    panel."""
    from ngsbits_tpu_torch.utils import synth
    phase(f"coverage: BedCoverage, BedLowCoverage and BedHighCoverage on the mappingqc "
          f"phase's BAM (2 x {MQ_PAIRS} pairs) over the exome panel, a dense panel and "
          f"a whole-genome panel")
    inp = _mq_inputs()
    bam = inp["bam"]
    dense_bed, wg_bed, chr1_bed = WORK / "dense.bed", WORK / "wg.bed", WORK / "wg_chr1.bed"
    dense = synth.synth_dense_panel(dense_bed, MQ_CHROMS, seed=14)
    synth.whole_genome_panel(wg_bed)
    synth.whole_genome_panel(chr1_bed, {CHR1: synth.GRCH38_LENGTHS[CHR1]})
    print(f"panels: exome {MQ_REGIONS} regions; dense {len(dense[0])} regions of 1-50 kb, "
          f"{int((dense[2] - dense[1]).sum())} bases; whole genome 24 regions, "
          f"{sum(synth.GRCH38_LENGTHS.values())} bases", flush=True)
    reads = 2 * MQ_PAIRS
    out = WORK / "cov"
    out.mkdir(exist_ok=True)
    low = ["-cutoff", str(COV_CUTOFF)]
    runs = [  # label, tool, panel, flags, held against
        ("exome", "BedCoverage", inp["bed"], [], "jax"),
        ("exome", "BedLowCoverage", inp["bed"], low, "jax"),
        ("exome", "BedHighCoverage", inp["bed"], low, "jax"),
        ("exome", "BedLowCoverage", inp["bed"], [*low, "-min_baseq", "20"], "jax"),
        ("dense", "BedCoverage", dense_bed, [], "jax"),
        ("dense", "BedLowCoverage", dense_bed, low, "jax"),
        ("whole genome", "BedLowCoverage", wg_bed, low, "cpu"),
        ("whole genome", "BedCoverage", wg_bed, [], "cpu"),
    ]
    kept: dict = {}
    totals: dict = {}
    whole: dict = {}   # C2's, R1's and R2's device time of every launch, a run
    c1_runs: dict = {}  # C1's record form: run -> the inputs of each launch
    for label, tool_name, panel, flags, against in runs:
        bam_flag = ["-bam", str(bam)]
        card = out / f"{label}.{tool_name}.bed".replace(" ", "_")
        args = [tool_name, *bam_flag, "-in", str(panel), "-out", str(card), *flags]
        run_name = f"{label} {tool_name} {' '.join(flags)}".strip()
        check_c1 = label == "exome" and (tool_name == "BedCoverage" or "-min_baseq" in flags)
        tool, wall, checks, launches = _coverage_run(f"{label} {' '.join(flags)}".strip(),
                                                     args, reads, check_c1=check_c1)
        for name, count in launches.items():
            if name in ("coverage_add_records", "coverage_finalize", "region_sums",
                        "threshold_runs") and count:
                by_tool = totals.setdefault(name, {})
                by_tool[tool_name] = by_tool.get(tool_name, 0) + count
        for name, (ms, n, nbytes) in checks.device.items():
            if n:  # the device time of every launch of the run, summed
                whole.setdefault(name, []).append(
                    {"run": run_name, "ms": ms, "launches": n,
                     "bound_ms": nbytes / PEAK_BYTES * 1e3})
        for name, (span, inputs) in checks.largest.items():
            key = (name, label)
            if label != "dense" and (key not in kept or span > kept[key][0]):
                kept[key] = (span, inputs, f"{label} {tool_name}")
        if check_c1:
            c1_runs[run_name] = checks.c1
        if against == "jax":
            jax_out = card.with_suffix(".jax.bed")
            jax_s = _jax_route([tool_name, *bam_flag, "-in", str(panel), "-out",
                                str(jax_out), *flags])
            if jax_out.read_bytes() != card.read_bytes():
                raise AssertionError(f"{label} {tool_name}: the port and the JAX package differ")
            print(f"  JAX package host route on the same files: {jax_s:.3f} s, "
                  f"{reads / jax_s:.0f} reads/s; output identical to the port's "
                  f"({card.stat().st_size} bytes)", flush=True)
        else:
            # the JAX route would take jax.numpy for boxes over 32M positions;
            # the port's CPU route on the first records, the panel cut to chr1
            pc, pu = out / "wg_prefix.card.bed", out / "wg_prefix.cpu.bed"
            pargs = [tool_name, "-bam", str(inp["prefix"]), "-in", str(chr1_bed), *flags]
            _port([*pargs, "-out", str(pc)])
            t0 = time.perf_counter()
            _port_on_cpu([*pargs, "-out", str(pu)])
            if pc.read_bytes() != pu.read_bytes():
                raise AssertionError(f"{label} {tool_name}: card and CPU route differ on the "
                                     f"first {MQ_PREFIX} records, chr1")
            print(f"  the first {MQ_PREFIX} records over chr1's whole length: card == CPU "
                  f"route ({pc.stat().st_size} bytes; {time.perf_counter() - t0:.1f} s on "
                  f"the CPU)", flush=True)
        del checks
    if _jax_loaded():
        raise AssertionError(f"the port loaded {_jax_loaded()}")
    coverage_kernels(records, kept, c1_runs, dev)
    for name, runs_ms in whole.items():
        records[name]["whole_runs"] = runs_ms
    for name, by_tool in totals.items():
        rec = records[name]
        rec.setdefault("launches_by_tool", {}).update(by_tool)
        rec["launches"] = sum(rec["launches_by_tool"].values())


def coverage_kernels(records: dict, kept: dict, c1_runs: dict, dev: torch.device):
    """C1's record form at the median launch (by records in its range) of
    each run in ``c1_runs`` (each of their launches was checked during the
    run; the -min_baseq run's is the main shape), C2's dense mode, R1 and R2
    at the largest box the exome's and the whole genome's runs gave them
    (the latter chr1's whole length, their main shape): checked again and
    timed."""
    from ngsbits_tpu_torch.ops import selfcheck
    phase("kernels: the coverage tools' C1 record form, C2 (dense mode), R1 and R2 at the "
          "coverage phase's inputs")
    for run_name, launches in c1_runs.items():
        k, (rec, r0, r1, ref, min_baseq, blocks, span) = _median_launch(
            launches, lambda a: a[2] - a[1])
        case = selfcheck.coverage_add_records_case(rec, r0, r1, ref, min_baseq, blocks, span)
        got = _record(records, case, f"{run_name}, launch {k} of {len(launches)} (median): "
                      f"records [{r0}, {r1}) of a batch of {rec.pos.shape[0]}, "
                      f"{int((rec.keep[r0:r1] == ref).sum())} kept, into {blocks.shape[1]} "
                      f"block(s) of {span} positions", min_baseq > 0, cold=True)
        records["coverage_add_records"].setdefault("shapes", []).append(got)
        del case, launches
    c1_runs.clear()
    torch.cuda.empty_cache()
    c2_timed = "ms" in records.get("coverage_finalize", {})  # at MappingQC's launch
    for (name, panel), (span, inputs, label) in kept.items():
        if name == "coverage_finalize":
            (diff,) = inputs
            case = selfcheck.coverage_dense_case(diff)
            lib = lambda: torch.cumsum(diff[:span], 0, dtype=torch.int32)  # noqa: E731
        elif name == "region_sums":
            cov, starts, offsets = inputs
            case = selfcheck.region_sums_case(cov, starts, _ends(starts, offsets))
            lib = None
        else:
            cov, starts, offsets, cutoff, is_high = inputs
            case = selfcheck.threshold_runs_case(cov, starts, _ends(starts, offsets),
                                                 cutoff, is_high)
            lib = None
        shape = (f"{label}, span {span}, {len(inputs[1]) if name != 'coverage_finalize' else 1}"
                 f" region(s)" + ("" if name != "threshold_runs" else
                                  f", cutoff {inputs[3]}"))
        main = panel == "whole genome" and (name != "coverage_finalize" or not c2_timed)
        got = _record(records, case, shape, main, cold=True, library=lib)
        records[name].setdefault("shapes", []).append(got)
        del case, inputs
        torch.cuda.empty_cache()


# ------------------------------------------------------- the similarity tools

SIM_PAIRS, SIM_VARIANTS = 281_250, 100_000  # 1,000,000 pairs until the mesh phase came


def _similarity_inputs() -> dict:
    """A second BAM (another sample: another seed), two pairs of VCFs and a
    cfDNA panel, beside the mappingqc phase's exome."""
    from ngsbits_tpu_torch.utils import synth
    inp = dict(_mq_inputs())
    t0 = time.perf_counter()
    inp["bam2"] = WORK / "sim2.bam"
    synth.synth_bam(inp["bam2"], inp["genome"], SIM_PAIRS, seed=31, roi=inp["roi"],
                    snps=inp["snps"])
    inp["vcf"] = [WORK / "sim1.vcf", WORK / "sim2.vcf"]
    synth.synth_vcfs(inp["vcf"], SIM_VARIANTS, seed=32)
    inp["const"] = [WORK / "const1.vcf", WORK / "const2.vcf"]
    synth.synth_vcfs(inp["const"], SIM_VARIANTS, seed=33, constant="0/1")
    chrom, pos, af = inp["known"]
    names = list(MQ_CHROMS)
    ids = [f"{names[c]}\t{p - 21}\t{p + 20}\tSNP_for_sample_identification:snp{i}\n"
           for i, (c, p) in enumerate(zip(chrom[(af >= 0.2) & (af <= 0.8)],
                                          pos[(af >= 0.2) & (af <= 0.8)]))]
    r_chr, r_start, r_end = inp["roi"]
    monitoring = [f"{names[c]}\t{s}\t{e}\tgene{i}\n"
                  for i, (c, s, e) in enumerate(zip(r_chr[::10], r_start[::10], r_end[::10]))]
    inp["panel"] = WORK / "cfdna.bed"
    inp["panel"].write_text("".join(ids + monitoring))
    print(f"generated a second BAM of 2 x {SIM_PAIRS} pairs ({inp['bam2'].stat().st_size} "
          f"bytes), two pairs of VCFs of {SIM_VARIANTS} variants and a cfDNA panel of "
          f"{len(ids)} identification SNP windows and {len(monitoring)} monitoring regions in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return inp


def _same_output(a: Path, b: Path) -> bool:
    if a.suffix == ".qcML":
        return _drop_creation(a) == _drop_creation(b)
    return a.read_bytes() == b.read_bytes()


def similarity(records: dict):
    """SampleSimilarity, SampleGender, SampleIdentity and CfDnaQC on the
    card, each against the JAX package's host route on the same files."""
    phase(f"similarity: SampleSimilarity, SampleGender, SampleIdentity and CfDnaQC on the "
          f"mappingqc phase's BAM (2 x {MQ_PAIRS} pairs), a second BAM (2 x {SIM_PAIRS} "
          f"pairs) and VCFs of {SIM_VARIANTS} variants")
    inp = _similarity_inputs()
    bam, bam2, fa = str(inp["bam"]), str(inp["bam2"]), str(inp["fa"])
    (v1, v2), (c1, c2) = (map(str, inp["vcf"]), map(str, inp["const"]))
    pileup = ("pileup_add_records",)
    coverage = ("coverage_add_records", "coverage_finalize", "region_sums")
    runs = [  # label, arguments ("{out}": the output), output's suffix, kernels of the path
        ("SampleSimilarity -mode bam", ["SampleSimilarity", "-mode", "bam", "-in", bam, bam2,
                                        "-min_cov", "10"], "tsv", pileup),
        ("SampleSimilarity -mode vcf", ["SampleSimilarity", "-in", v1, v2], "tsv",
         ("correlation_moments",)),
        ("SampleSimilarity -mode vcf, constant genotypes", ["SampleSimilarity", "-in", c1, c2],
         "tsv", ("correlation_moments",)),
        ("SampleGender -method xy", ["SampleGender", "-in", bam, "-method", "xy"], "tsv", ()),
        ("SampleGender -method hetx", ["SampleGender", "-in", bam, "-method", "hetx"], "tsv",
         pileup),
        ("SampleGender -method sry", ["SampleGender", "-in", bam, "-method", "sry"], "tsv",
         coverage),
        ("SampleIdentity", ["SampleIdentity", "-bams", bam, bam2, "-min_depth", "2",
                            "-min_snps", "1", "-min_identity", "0", "-min_correlation", "-1"],
         "tsv", pileup),
        ("CfDnaQC", ["CfDnaQC", "-bam", bam, "-cfdna_panel", str(inp["panel"]), "-tumor_bam",
                     bam2, "-ref", fa], "qcML", coverage + pileup),
    ]
    from ngsbits_tpu_torch.qc import sample_similarity as ss
    x7_launches, launched, band_hits = [], set(), 0
    for k, (label, args, suffix, path) in enumerate(runs):
        card, jax = WORK / f"sim_card{k}" / f"out.{suffix}", WORK / f"sim_jax{k}" / f"out.{suffix}"
        card.parent.mkdir()
        jax.parent.mkdir()
        with _capture_x7_inputs() as x7:
            _reset()
            ss.genotype_correlation.band_hits = 0
            tool, seconds = _port([*args, "-out", str(card)])
            launches = _launches()
        band_hits += ss.genotype_correlation.band_hits
        for name in path:
            if launches[name] == 0:
                raise AssertionError(f"{name} was not launched by {label}: {launches}")
        if len(x7) != launches["correlation_moments"]:
            raise AssertionError(f"{label}: {len(x7)} X7 inputs, "
                                 f"{launches['correlation_moments']} launches")
        x7_launches += x7
        for name, count in launches.items():
            if count:
                launched.add(name)
                by_tool = _kernel_record(records, name).setdefault("launches_by_tool", {})
                by_tool[args[0]] = by_tool.get(args[0], 0) + count
        jax_s = _jax_route([*args, "-out", str(jax)])
        if not _same_output(card, jax):
            raise AssertionError(f"{label}: the port and the JAX package differ")
        text = card.read_text()
        if suffix == "qcML":  # the report's values, without its metadata
            text = "".join(f"{n}: {v}\n" for n, v in re.findall(
                r'<qualityParameter ID="[^"]*" name="([^"]+)"[^>]* value="([^"]*)"', text))
        stages = ", ".join(f"{s} {v:.4f}" for s, v in tool.seconds.items())
        print(f"{label} on {torch.cuda.get_device_name(0)}: {seconds:.3f} s (stages: {stages}); "
              f"launches { {n: c for n, c in launches.items() if c} }; calls in F10's tie "
              f"band {ss.genotype_correlation.band_hits}; the JAX package's host "
              f"route on the same files {jax_s:.3f} s; outputs identical "
              f"({card.stat().st_size} bytes):\n{text.rstrip()}", flush=True)
    if _jax_loaded():
        raise AssertionError(f"the port loaded {_jax_loaded()}")
    for name in launched:
        records[name]["launches"] = sum(records[name]["launches_by_tool"].values())
    print(f"calls in F10's tie band in the phase's runs: {band_hits}", flush=True)
    f10_on_card()
    from ngsbits_tpu_torch.ops import selfcheck
    phase(f"kernels: X7 at the similarity phase's {len(x7_launches)} launches")
    for k, g in enumerate(x7_launches):
        _check_equal(selfcheck.correlation_moments_case(g), f"launch {k}")
    print("correlation_moments: equal at each of the phase's launches", flush=True)
    _x7_record(records, x7_launches[0], f"the VCF run's launch: n={x7_launches[0].shape[1]} "
               f"(the overlap, padded to 16 bytes a row)", True)


def f10_on_card():
    """F10's seeded exact ties and zeros (``selfcheck.f10_overlaps``: the
    first twelve of each kind) through ``calculate_similarity`` on the card:
    X7 launched once a call, every call in the tie band, and the printed
    correlation the centred float64 form's (the reference's)."""
    from ngsbits_tpu_torch.core.basicstats import correlation
    from ngsbits_tpu_torch.ops import device_reduce as dr
    from ngsbits_tpu_torch.ops import selfcheck
    from ngsbits_tpu_torch.qc import sample_similarity as ss
    import numpy as np
    found = selfcheck.f10_overlaps(12)
    cases = found["zero"] + found["tie"]
    launches, hits = dr.correlation_moments_into.launches, ss.genotype_correlation.band_hits
    for x, y in cases:
        r = ss.calculate_similarity({f"k{i}": np.float32(v) for i, v in enumerate(x)},
                                    {f"k{i}": np.float32(v) for i, v in enumerate(y)})
        want = selfcheck.print4(correlation(x, y))
        if selfcheck.print4(r.sample_correlation) != want:
            raise AssertionError(f"F10: the card prints {r.sample_correlation!r}, the centred "
                                 f"form {want}")
    launches = dr.correlation_moments_into.launches - launches
    hits = ss.genotype_correlation.band_hits - hits
    if launches != len(cases) or hits != len(cases):
        raise AssertionError(f"F10: {len(cases)} overlaps, {launches} X7 launches, {hits} in "
                             f"the tie band")
    print(f"F10 on the card: {len(found['zero'])} exact zeros and {len(found['tie'])} exact "
          f"ties through calculate_similarity, {launches} X7 launches, {hits} calls in the tie "
          f"band, every correlation printed as the centred form's", flush=True)


# ------------------------------------------------------ the pileup callers

# 1,000,000 pairs and 20,000 sites on the 8 Mb genome until the mesh phase came
CALLERS_PAIRS, CALLERS_SITES = 281_250, 5_625
CALLERS_BAMS = ("mother", "father", "child")
_CALLERS: dict = {}  # the trio's inputs, made once for the callers and annotate phases


def _callers_inputs() -> dict:
    """A trio beside the mappingqc phase's exome (its genome and panel):
    germline SNVs at the known SNVs and at random panel sites, and indels of
    1-4 bases (``CALLERS_SITES`` sites in all, 10% indels), the child one
    allele of each parent's; a BAM of 2 x ``CALLERS_PAIRS`` pairs a member
    (its own seed), a single-sample VCF a member with a few per cent of its
    variants left out, and a BED of every site as a single base. The BAMs
    are written by three processes at once."""
    if _CALLERS:
        return _CALLERS
    from ngsbits_tpu_torch.utils import synth
    inp = dict(_mq_inputs())
    t0 = time.perf_counter()
    k_chr, k_pos0, k_alt = inp["snps"]
    random_sites = CALLERS_SITES - len(k_chr)
    trio = synth.trio_variants(inp["genome"], inp["roi"], random_sites, seed=41,
                               known=(k_chr, k_pos0 + 1, k_alt),
                               indel_share=0.1 * CALLERS_SITES / random_sites)
    inp["bams"] = [WORK / f"trio_{m}.bam" for m in CALLERS_BAMS]
    inp["vcfs"] = [WORK / f"trio_{m}.vcf" for m in CALLERS_BAMS]
    jobs = [(inp["bams"][k], inp["genome"], CALLERS_PAIRS, 42 + k, inp["roi"], trio.snps(k),
             trio.indels(k)) for k in range(3)]
    with ProcessPoolExecutor(3, mp_context=multiprocessing.get_context("spawn")) as pool:
        list(pool.map(_trio_bam, jobs))
    synth.trio_vcfs(inp["vcfs"], trio, inp["genome"], seed=45)
    inp["sites"] = WORK / "trio_sites.bed"
    names = inp["genome"].names
    inp["sites"].write_text("".join(f"{names[c]}\t{p}\t{p + 1}\n"
                                    for c, p in zip(trio.chrom, trio.pos)))
    n_vcf = [sum(1 for l in v.read_text().splitlines() if not l.startswith("#"))
             for v in inp["vcfs"]]
    n_indel = sum(len(r) != 1 or len(a) != 1 for r, a in zip(trio.ref, trio.alt))
    print(f"generated a trio: {len(trio.chrom)} sites ({len(k_chr)} known SNVs, {n_indel} "
          f"indels), VCFs of {n_vcf} variants, three BAMs of 2 x {CALLERS_PAIRS} pairs "
          f"({[b.stat().st_size for b in inp['bams']]} bytes) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    inp["trio"] = trio
    _CALLERS.update(inp)
    return _CALLERS


def _trio_bam(job):
    """One trio member's BAM (in a process of its own)."""
    from ngsbits_tpu_torch.utils import synth
    path, genome, pairs, seed, roi, snps, indels = job
    synth.synth_bam(path, genome, pairs, seed=seed, roi=roi, snps=snps, indels=indels)


class _KeptHits:
    """A launch's ``IndelHits`` as the sweep gets it: its ``hits()`` also
    keep a copy of what the sweep got, so the launch can be checked after
    the run while the sweep frees the pinned copy as it would."""

    def __init__(self, pending, kept: list):
        self.pending, self.kept = pending, kept

    def hits(self):
        hits = self.pending.hits()
        self.kept.append(hits.clone())
        return hits


@contextlib.contextmanager
def _capture_indel_launches():
    """Each launch of B1's indel form while the block runs, taken where
    ``DevicePileup.add`` makes it: (records as they went up, loci, table,
    min_mapq, window, capacity, loci range, a list that gets the hits the
    sweep fetched, once it waits for them: after the next launch), in
    launch order; and the number of BAM sweeps the pileups made (readers
    opened)."""
    from ngsbits_tpu_torch.ops.device_reduce import DevicePileup
    from ngsbits_tpu_torch.qc import pileup as pm
    got: dict = {"launches": [], "sweeps": 0}
    add, reader = DevicePileup.add, pm.BamReader

    def add_records(self, rec, min_mapq, min_baseq, indel_ops=0, loci_range=None):
        pending = add(self, rec, min_mapq, min_baseq, indel_ops, loci_range)
        if pending is None:
            return None
        kept: list = []
        got["launches"].append((rec, self.loci, self.table, min_mapq, self.indel_window,
                                pending.capacity, loci_range, kept))
        return _KeptHits(pending, kept)

    def open_reader(*a, **kw):
        got["sweeps"] += 1
        return reader(*a, **kw)

    DevicePileup.add, pm.BamReader = add_records, open_reader
    try:
        yield got
    finally:
        DevicePileup.add, pm.BamReader = add, reader


def _same_bytes(card: Path, jax: Path) -> str:
    """The two outputs compared byte for byte; the ``##fileDate`` line is
    dropped from the comparison only where the runs fell on two days (said
    in the result)."""
    a, b = card.read_bytes(), jax.read_bytes()
    if a == b:
        return "identical"
    drop = lambda t: b"\n".join(l for l in t.split(b"\n")  # noqa: E731
                                if not l.startswith(b"##fileDate="))
    if drop(a) == drop(b):
        return "identical but for ##fileDate (the runs fell on two days)"
    raise AssertionError(f"{card.name}: the port and the JAX package differ")


def callers(records: dict, save_launch: Path | None = None):
    """VcfMerge with re-calling, TrioMaternalContamination and
    BedAnnotateFreq on the card over a synthetic trio, each against the JAX
    package's host route; every launch of B1's indel form held against its
    plain version after the runs, on the hits the sweep fetched a launch
    later. ``save_launch``: where to save the inputs of the launch of median
    hits (``torch.save``; for ``scripts/indel_variants.py --launch``)."""
    import numpy as np
    from ngsbits_tpu_torch.ops import device_reduce as dr
    from ngsbits_tpu_torch.ops import selfcheck
    phase(f"callers: VcfMerge -bam, TrioMaternalContamination and BedAnnotateFreq on a trio "
          f"of BAMs of 2 x {CALLERS_PAIRS} pairs over the mappingqc phase's genome and panel")
    inp = _callers_inputs()
    bams, vcfs = [str(b) for b in inp["bams"]], [str(v) for v in inp["vcfs"]]
    runs = [  # label, arguments, output's suffix, kernels of the path
        ("VcfMerge -bam", ["VcfMerge", "-in", *vcfs, "-bam", *bams], "vcf",
         ("pileup_add_records", "pileup_indels")),
        ("TrioMaternalContamination", ["TrioMaternalContamination", "-bam_m", bams[0],
                                       "-bam_f", bams[1], "-bam_c", bams[2]], "txt",
         ("pileup_add_records",)),
        ("BedAnnotateFreq", ["BedAnnotateFreq", "-bam", *bams, "-in", str(inp["sites"])],
         "tsv", ("pileup_add_records",)),
    ]
    indel_launches = []
    for k, (label, args, suffix, path) in enumerate(runs):
        card = WORK / f"callers_card{k}" / f"out.{suffix}"
        jax = WORK / f"callers_jax{k}" / f"out.{suffix}"
        card.parent.mkdir()
        jax.parent.mkdir()
        with _capture_indel_launches() as got:
            _reset()
            tool, seconds = _port([*args, "-out", str(card)])
            launches = _launches()
        for name in path:
            if launches[name] == 0:
                raise AssertionError(f"{name} was not launched by {label}: {launches}")
        other = {n: c for n, c in launches.items() if c and n not in path}
        if other:
            raise AssertionError(f"{label} launched kernels off its path: {other}")
        if len(got["launches"]) != launches["pileup_indels"]:
            raise AssertionError(f"{label}: {len(got['launches'])} indel inputs, "
                                 f"{launches['pileup_indels']} launches")
        if got["sweeps"] != len(bams):
            raise AssertionError(f"{label} swept the BAMs {got['sweeps']} times, not once each")
        indel_launches += got["launches"]
        for name, count in launches.items():
            if count:
                by_tool = _kernel_record(records, name).setdefault("launches_by_tool", {})
                by_tool[args[0]] = by_tool.get(args[0], 0) + count
        jax_s = _jax_route([*args, "-out", str(jax)])
        same = _same_bytes(card, jax)
        text = card.read_text().splitlines()
        stages = ", ".join(f"{s} {v:.4f}" for s, v in tool.seconds.items())
        print(f"{label} on {torch.cuda.get_device_name(0)}: {seconds:.3f} s (stages: {stages}); "
              f"launches { {n: c for n, c in launches.items() if c} }; BAM sweeps "
              f"{got['sweeps']}; the JAX package's host route on the same files {jax_s:.3f} s; "
              f"outputs {same} ({card.stat().st_size} bytes, {len(text)} lines)"
              + (f":\n" + "\n".join(text) if suffix == "txt" else ""), flush=True)
        if suffix == "vcf":
            rc = sum(l.count(":RC") for l in text if not l.startswith("#"))
            print(f"  {rc} genotypes added by re-calling (CT=RC); fetch stage (the engines' "
                  f"launches, the waits for the indel form's copies a launch later, the "
                  f"counters' fetch) {tool.seconds['fetch']:.4f} s", flush=True)
            threaded = card.with_name("threads.vcf")
            _reset()
            _, t_seconds = _port([*args, "-threads", "3", "-out", str(threaded)])
            t_launches = _launches()
            if {n: t_launches[n] for n in path} != {n: launches[n] for n in path} or \
                    threaded.read_bytes() != card.read_bytes():
                raise AssertionError(f"{label} -threads 3: {t_launches} launches, or other "
                                     f"bytes than one thread's")
            print(f"  -threads 3 (the three BAMs at once, a pileup engine each on the card): "
                  f"{t_seconds:.3f} s, the same launches and bytes as one thread", flush=True)
    if _jax_loaded():
        raise AssertionError(f"the port loaded {_jax_loaded()}")
    for name in ("pileup_add_records", "pileup_indels"):
        records[name]["launches"] = sum(records[name]["launches_by_tool"].values())

    phase(f"kernels: B1's indel form at the callers phase's {len(indel_launches)} launches")
    t0 = time.perf_counter()
    for k, (rec, loci, table, mq, window, capacity, cut, kept) in enumerate(indel_launches):
        if len(kept) != 1:
            raise AssertionError(f"pileup_indels launch {k}: its hits were fetched {len(kept)} "
                                 f"times, not once")
        want = selfcheck.sorted_hits(dr.pileup_indels_plain(rec, loci, table, mq, window))
        if not torch.equal(selfcheck.sorted_hits(kept[0]), want):
            raise AssertionError(f"pileup_indels launch {k}: the run's hits differ from the "
                                 f"plain version's")
    n_hits = [kept[0].shape[0] for *_, kept in indel_launches]
    reached = [cut[1] - cut[0] for *_, cut, _ in indel_launches]
    print(f"pileup_indels: the hits of each of the {len(indel_launches)} launches equal the "
          f"plain version's over every locus ({sum(n_hits)} hits, {min(n_hits)}-{max(n_hits)} "
          f"a launch; the launches reached {min(reached)}-{max(reached)} loci, "
          f"{sum(r > dr.INDEL_STAGED_LOCI for r in reached)} past the "
          f"{dr.INDEL_STAGED_LOCI} staged in shared memory; checks "
          f"{time.perf_counter() - t0:.2f} s, not in the runs' times)", flush=True)
    k, (rec, loci, table, mq, window, capacity, cut, kept) = _median_launch(
        indel_launches, lambda a: a[-1][0].shape[0])
    n_ops = dr.count_indel_ops(rec.cigar.cpu().numpy().view(np.uint32))
    case = selfcheck.pileup_indels_case(rec, loci, table, mq, window, capacity, cut)
    got = _record(records, case,
                  f"launch {k} of {len(indel_launches)} (median by hits): {rec.pos.shape[0]} "
                  f"records, {n_ops} I and D ops, {kept[0].shape[0]} hits at {loci.shape[0]} "
                  f"loci ({cut[1] - cut[0]} reached), window {window}, min_mapq {mq}, capacity "
                  f"{capacity}", True, cold=True)
    ops = selfcheck.device_ops(case.device_fn, torch.device("cuda"))
    *_, out, _, scratch, ring = case.inputs
    sweep_ms = _sweep_call_ms(lambda: dr.pileup_indels_into(
        rec, loci, table, mq, window, out, loci_range=cut, scratch=scratch, ring=ring,
        wait=False))
    if ops != 1 or int(scratch.abs().sum()):
        raise AssertionError(f"pileup_indels: {ops} device operations a launch, or its scratch "
                             f"left {scratch.tolist()}")
    records["pileup_indels"]["sweep_call_ms"] = sweep_ms
    print(f"pileup_indels    that launch: one device operation, its scratch left zero; the "
          f"wrapper's call {got['call_ms']:.4f} ms with its hits waited for at once, "
          f"{sweep_ms:.4f} ms as the sweep makes it (launch, copy and event queued, the hits "
          f"read after the next call; host clock)", flush=True)
    if save_launch is not None:
        torch.save(dict(rec={f: getattr(rec, f).cpu() for f in rec._fields
                             if getattr(rec, f) is not None},
                        loci=loci.cpu(), table=table.cpu(), min_mapq=mq, window=window,
                        capacity=capacity, loci_range=cut, launch=k, launches=len(indel_launches)),
                   save_launch)
        print(f"saved the median launch's inputs to {save_launch}", flush=True)


# ---------------------------------------------------- the variant-details path

ANNOTATE_PRS = 2_000  # sites of the PRS VCF


@contextlib.contextmanager
def _capture_region_launches():
    """Each launch of B1's region form while the block runs, taken where
    ``DeviceRegions.add`` makes it: (records as they went up, regions,
    table, capacity, regions range, a list that gets the hits the sweep
    fetched, once it waits for them: after the next launch), in launch
    order; the engines that launched them; and the number of BAM sweeps
    (readers opened)."""
    from ngsbits_tpu_torch.ops.device_reduce import DeviceRegions
    from ngsbits_tpu_torch.qc import pileup as pm
    got: dict = {"launches": [], "engines": {}, "sweeps": 0}
    add, reader = DeviceRegions.add, pm.BamReader

    def add_records(self, rec, indel_ops, regions_range=None):
        pending = add(self, rec, indel_ops, regions_range)
        kept: list = []
        got["launches"].append((rec, self.regions, self.table, pending.capacity, regions_range,
                                kept))
        got["engines"][id(self)] = self
        return _KeptHits(pending, kept)

    def open_reader(*a, **kw):
        got["sweeps"] += 1
        return reader(*a, **kw)

    DeviceRegions.add, pm.BamReader = add_records, open_reader
    try:
        yield got
    finally:
        DeviceRegions.add, pm.BamReader = add, reader


def _rebuilt_set_seconds(rows: list[str]) -> float:
    """Seconds of the JAX package's ``ind_idx`` comprehension at
    ``ngsbits_tpu/qc/variant_details.py:239`` (a set of the SNV indices
    built anew for each variant: quadratic in the variants) on a VCF's data
    lines, reproduced here as it is written there."""
    from ngsbits_tpu_torch.qc.variant_details import gsvar_from_vcf, is_snv
    variants = [gsvar_from_vcf(int(f[1]), f[3].encode(), f[4].encode())
                for f in (r.split("\t") for r in rows)]
    n = len(variants)
    snv_idx = [i for i, v in enumerate(variants) if is_snv(v[2], v[3])]
    t0 = time.perf_counter()
    ind_idx = [i for i in range(n) if i not in set(snv_idx)]
    seconds = time.perf_counter() - t0
    if len(ind_idx) + len(snv_idx) != n:
        raise AssertionError("the SNVs and indels do not partition the variants")
    return seconds


def annotate(records: dict, inp: dict, save_launch: Path | None = None):
    """VcfAnnotateFrequency, VariantAnnotateFrequency (twice),
    VariantAnnotateASE and VcfCalculatePRS on the card on the callers
    phase's child (its BAM and VCF, the genome and panel), each against the
    JAX package's host route; every launch of B1's region form held against
    its plain version after the runs, on the hits the sweep fetched a
    launch later, and launched again alone (one device operation, its
    scratch left zero, the counters too). ``save_launch``: where to save the
    inputs of the launch of median hits (``torch.save``; for
    ``scripts/region_variants.py --launch``)."""
    import numpy as np
    from ngsbits_tpu_torch.ops import device_reduce as dr
    from ngsbits_tpu_torch.ops import selfcheck
    from ngsbits_tpu_torch.utils import synth
    phase(f"annotate: VcfAnnotateFrequency, VariantAnnotateFrequency, VariantAnnotateASE and "
          f"VcfCalculatePRS on the callers phase's child (a BAM of 2 x {CALLERS_PAIRS} pairs, "
          f"its VCF) over the mappingqc phase's genome and panel (-target: every second "
          f"region)")
    t0 = time.perf_counter()
    bam, vcf, fa = str(inp["bams"][2]), inp["vcfs"][2], str(inp["fa"])
    gsvar, prs, sample = WORK / "child.GSvar", WORK / "prs.vcf", WORK / "child.vcf.gz"
    synth.vcf_gsvar(vcf, gsvar, seed=46)
    synth.bgzip_tabix(vcf, sample)
    synth.prs_vcf(prs, inp["trio"], inp["genome"], ANNOTATE_PRS, seed=47)
    half = WORK / "half_panel.bed"  # every second region of the panel, for -target
    half.write_text("".join(l + "\n" for l in inp["bed"].read_text().splitlines()[::2]))
    rows = [l for l in vcf.read_text().splitlines() if not l.startswith("#")]
    n_indel = sum(len(r.split("\t")[3]) != len(r.split("\t")[4]) for r in rows)
    print(f"generated a GSvar of the child's {len(rows)} variants ({n_indel} indels), its VCF "
          f"bgzipped with a tabix index and a PRS VCF of {ANNOTATE_PRS} sites in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    set_s = _rebuilt_set_seconds(rows)
    common = ["-bam", bam, "-ref", fa]
    runs = [  # label, arguments, the outputs' names
        ("VcfAnnotateFrequency -depth",
         ["VcfAnnotateFrequency", "-in", str(vcf), *common, "-depth"], ["out.vcf"]),
        ("VariantAnnotateFrequency -depth -mapq0",
         ["VariantAnnotateFrequency", "-in", str(gsvar), *common, "-depth", "-mapq0"],
         ["out.GSvar"]),
        ("VariantAnnotateFrequency -depth -mapq0 -target",
         ["VariantAnnotateFrequency", "-in", str(gsvar), *common, "-depth", "-mapq0",
          "-target", str(half)], ["out.GSvar"]),
        ("VariantAnnotateASE", ["VariantAnnotateASE", "-in", str(gsvar), *common], ["out.GSvar"]),
        ("VcfCalculatePRS -details",
         ["VcfCalculatePRS", "-in", str(sample), *common, "-prs", str(prs)],
         ["out.tsv", "details.tsv"]),
    ]
    path = ("pileup_add_records", "pileup_regions")
    region_launches = []
    for k, (label, args, outs) in enumerate(runs):
        card = [WORK / f"annotate_card{k}" / o for o in outs]
        jax = [WORK / f"annotate_jax{k}" / o for o in outs]
        card[0].parent.mkdir()
        jax[0].parent.mkdir()
        extra = (lambda f: ["-out", str(f[0])] + (["-details", str(f[1])] if len(f) > 1 else []))
        with _capture_region_launches() as got:
            _reset()
            tool, seconds = _port([*args, *extra(card)])
            launches = _launches()
        for name in path:
            if launches[name] == 0:
                raise AssertionError(f"{name} was not launched by {label}: {launches}")
        other = {n: c for n, c in launches.items() if c and n not in path}
        if other:
            raise AssertionError(f"{label} launched kernels off its path: {other}")
        if len(got["launches"]) != launches["pileup_regions"]:
            raise AssertionError(f"{label}: {len(got['launches'])} region inputs, "
                                 f"{launches['pileup_regions']} launches")
        if got["sweeps"] != 1:
            raise AssertionError(f"{label} swept the BAM {got['sweeps']} times, not once")
        for eng in got["engines"].values():
            if int(eng.scratch.abs().sum()):
                raise AssertionError(f"{label}: the region form's scratch was left "
                                     f"{eng.scratch.tolist()}")
        region_launches += got["launches"]
        for name, count in launches.items():
            if count:
                by_tool = _kernel_record(records, name).setdefault("launches_by_tool", {})
                by_tool[args[0]] = by_tool.get(args[0], 0) + count
        jax_s = _jax_route([*args, *extra(jax)])
        same = [_same_bytes(c, j) for c, j in zip(card, jax)]
        stages = ", ".join(f"{s} {v:.4f}" for s, v in tool.seconds.items())
        print(f"{label} on {torch.cuda.get_device_name(0)}: {seconds:.3f} s (stages: {stages}); "
              f"launches { {n: c for n, c in launches.items() if c} }; BAM sweeps "
              f"{got['sweeps']}; the JAX package's host route on the same files {jax_s:.3f} s; "
              f"outputs {', '.join(same)} ({[c.stat().st_size for c in card]} bytes)",
              flush=True)
        if outs[0] == "out.tsv":
            print("  " + card[0].read_text().strip().replace("\n", "\n  "), flush=True)
        if k == 0:
            print(f"  the JAX package's set of SNV indices rebuilt for each variant "
                  f"(ngsbits_tpu/qc/variant_details.py:239), reproduced on this host: "
                  f"{set_s:.3f} s, {set_s / jax_s:.1%} of its host route's wall", flush=True)
    if _jax_loaded():
        raise AssertionError(f"the port loaded {_jax_loaded()}")
    records["pileup_regions"]["launches"] = sum(
        records["pileup_regions"]["launches_by_tool"].values())
    records["pileup_add_records"]["launches"] = sum(
        records["pileup_add_records"]["launches_by_tool"].values())

    phase(f"kernels: B1's region form at the annotate phase's {len(region_launches)} launches")
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    scratch, ring = dr.indel_scratch(dev), dr.HitRing()
    for k, (rec, regions, table, capacity, cut, kept) in enumerate(region_launches):
        if len(kept) != 1:
            raise AssertionError(f"pileup_regions launch {k}: its hits were fetched {len(kept)} "
                                 f"times, not once")
        counters = torch.zeros((dr.REGION_COUNTERS, regions.shape[1]), dtype=torch.int32,
                               device=regions.device)
        want = selfcheck.sorted_region_hits(dr.pileup_regions_plain(rec, regions, table,
                                                                    counters))
        if not torch.equal(selfcheck.sorted_region_hits(kept[0]), want):
            raise AssertionError(f"pileup_regions launch {k}: the run's hits differ from the "
                                 f"plain version's")
        # launched again alone: one device operation, the scratch left zero, the
        # plain version's counters and hits
        again, out = torch.zeros_like(counters), dr.region_out(capacity, dev)
        ops = selfcheck.device_ops(lambda: dr._pileup_regions_launch(
            rec, regions, table, again, out, cut, scratch), dev)
        hits = dr.pileup_regions_into(rec, regions, table, again, out, regions_range=cut,
                                      scratch=scratch, ring=ring)
        if ops != 1 or int(scratch.abs().sum()) or not torch.equal(again, counters) or \
                not torch.equal(selfcheck.sorted_region_hits(hits), want):
            raise AssertionError(f"pileup_regions launch {k} alone: {ops} device operations, "
                                 f"its scratch left {scratch.tolist()}, or its counters or hits "
                                 f"differ from the plain version's")
    n_hits = [kept[0].shape[0] for *_, kept in region_launches]
    reached = [cut[1] - cut[0] for *_, cut, _ in region_launches]
    print(f"pileup_regions: the hits of each of the {len(region_launches)} launches equal the "
          f"plain version's over every region ({sum(n_hits)} hits, {min(n_hits)}-{max(n_hits)} "
          f"a launch; the launches reached {min(reached)}-{max(reached)} regions, median "
          f"{int(np.median(reached))}); each launched again alone is "
          f"one device operation, leaves its scratch zero and gives the plain version's "
          f"counters and hits (checks {time.perf_counter() - t0:.2f} s, not in the runs' times)",
          flush=True)
    k, (rec, regions, table, capacity, cut, kept) = _median_launch(
        region_launches, lambda a: a[-1][0].shape[0])
    n_ops = dr.count_indel_ops(rec.cigar.cpu().numpy().view(np.uint32))
    case = selfcheck.pileup_regions_case(rec, regions, table, capacity, cut)
    got = _record(records, case,
                  f"launch {k} of {len(region_launches)} (median by hits): {rec.pos.shape[0]} "
                  f"records, {n_ops} I and D ops, {kept[0].shape[0]} hits at {regions.shape[1]} "
                  f"regions ({cut[1] - cut[0]} reached), capacity {capacity}", True, cold=True)
    *_, counters, out, _, scratch, ring = case.inputs
    sweep_ms = _sweep_call_ms(lambda: dr.pileup_regions_into(
        rec, regions, table, counters, out, regions_range=cut, scratch=scratch, ring=ring,
        wait=False))
    records["pileup_regions"]["sweep_call_ms"] = sweep_ms
    print(f"pileup_regions   the wrapper's call at that launch: {got['call_ms']:.4f} ms with its "
          f"hits waited for at once, {sweep_ms:.4f} ms as the sweep makes it (launch, copy and "
          f"event queued, the hits read after the next call; host clock)", flush=True)
    if save_launch is not None:
        torch.save(dict(rec={f: getattr(rec, f).cpu() for f in rec._fields
                             if getattr(rec, f) is not None},
                        regions=regions.cpu(), table=table.cpu(), capacity=capacity,
                        regions_range=cut, launch=k, launches=len(region_launches)), save_launch)
        print(f"saved the median launch's inputs to {save_launch}", flush=True)


# ---------------------------------------------------------------- SomaticQC

SOMATIC_PAIRS = 500_000      # pairs of each BAM of the tumor/normal pair
SOMATIC_PANEL = 2_000_000    # bases of the panel cut from the exome's
SOMATIC_VARIANTS, SOMATIC_SHARE = 2_000, 0.2
SOMATIC_GENOME = 4           # chromosomes of the genome prefix of the run without a target
_SOMATIC: dict = {}


def _pair_bam(job):
    """One BAM of the tumor/normal pair (in a process of its own)."""
    from ngsbits_tpu_torch.utils import synth
    path, genome, pairs, seed, roi, snps, somatic = job
    synth.synth_bam(path, genome, pairs, seed=seed, roi=roi, snps=snps, somatic=somatic)


def _somatic_inputs() -> dict:
    """A tumor/normal pair on the mappingqc phase's genome: a panel cut from
    its exome panel to about ``SOMATIC_PANEL`` bases of regions that hold a
    known SNP; ``SOMATIC_VARIANTS`` somatic variants in it
    (``synth.somatic_variants``: a tenth indels, about 70% PASS, three SNVs
    on known SNPs), the tumor's SNVs in its reads at ``SOMATIC_SHARE``; a
    normal and a tumor BAM of 2 x ``SOMATIC_PAIRS`` pairs of one person (the
    known SNPs at the same genotypes), written by two processes at once; a
    Strelka-flavoured somatic VCF with gnomAD AFs, its samples named after
    the BAMs; the exome panel as target exons, a blacklist and tumor
    suppressor genes cut from the panel; the genome's first
    ``SOMATIC_GENOME`` chromosomes as a FASTA of their own (with its
    ``.fai``), for the run without a target, whose plots read the whole
    genome."""
    if _SOMATIC:
        return _SOMATIC
    import numpy as np
    from ngsbits_tpu_torch.utils import synth
    inp = dict(_mq_inputs())
    t0 = time.perf_counter()
    genome, (r_chr, r_start, r_end) = inp["genome"], inp["roi"]
    chrom, pos, af = inp["known"]
    g = np.sort(genome.offsets[chrom] + pos - 1)
    rs, re_ = genome.offsets[r_chr] + r_start, genome.offsets[r_chr] + r_end
    holds = np.flatnonzero(np.searchsorted(g, rs) < np.searchsorted(g, re_))
    width = r_end[holds] - r_start[holds]
    n_keep = min(len(holds), int(round(len(holds) * SOMATIC_PANEL / width.sum())))
    keep = holds[np.linspace(0, len(holds) - 1, n_keep).astype(np.int64)]
    panel = (r_chr[keep], r_start[keep], r_end[keep])
    names = genome.names
    rows = [f"{names[c]}\t{s}\t{e}\n" for c, s, e in zip(*panel)]
    inp["target"] = WORK / "somatic_target.bed"
    inp["target"].write_text("".join(rows))
    (WORK / "somatic_blacklist.bed").write_text("".join(rows[3::20]))
    (WORK / "somatic_tsg.bed").write_text("".join(rows[::7]))
    on_known = np.flatnonzero((af >= 0.2) & (af <= 0.8))[::1000][:3]
    variants = synth.somatic_variants(genome, panel, SOMATIC_VARIANTS, seed=91,
                                      share=SOMATIC_SHARE,
                                      on_known=(chrom[on_known], pos[on_known]))
    k_chr, k_pos0, k_alt = inp["snps"]
    gt = np.where(np.random.default_rng(92).random(len(k_chr)) < 0.6, 1, 2)
    germline = (k_chr, k_pos0, k_alt, gt)
    inp["tumor"], inp["normal"] = WORK / "tumor.bam", WORK / "normal.bam"
    jobs = [(inp["normal"], genome, SOMATIC_PAIRS, 93, panel, germline, None),
            (inp["tumor"], genome, SOMATIC_PAIRS, 94, panel, germline, variants.snvs())]
    with ProcessPoolExecutor(len(jobs), mp_context=multiprocessing.get_context("spawn")) as pool:
        list(pool.map(_pair_bam, jobs))
    inp["vcf"] = WORK / "somatic.vcf"
    synth.somatic_vcf(inp["vcf"], variants, genome, seed=95, flavour="strelka")
    fai = Path(str(inp["fa"]) + ".fai").read_text().splitlines(True)
    end = int(fai[SOMATIC_GENOME].split("\t")[2]) - len(names[SOMATIC_GENOME]) - 2
    inp["fa_prefix"] = WORK / "somatic_prefix.fa"
    with open(inp["fa"], "rb") as src, open(inp["fa_prefix"], "wb") as dst:
        dst.write(src.read(end))
    Path(str(inp["fa_prefix"]) + ".fai").write_text("".join(fai[:SOMATIC_GENOME]))
    n_pass = sum(f == "PASS" for f in variants.filters)
    n_indel = sum(len(r) != 1 or len(a) != 1 for r, a in zip(variants.ref, variants.alt))
    print(f"generated a tumor/normal pair: a panel of {n_keep} regions ({int(width.sum())} "
          f"bases of regions holding {len(g)} known SNPs, cut to "
          f"{int((panel[2] - panel[1]).sum())}), {len(variants.chrom)} somatic variants "
          f"({n_indel} indels, {n_pass} PASS), the tumor's SNVs at an allele share of "
          f"{SOMATIC_SHARE}; two BAMs of 2 x {SOMATIC_PAIRS} pairs "
          f"({inp['normal'].stat().st_size}, {inp['tumor'].stat().st_size} bytes) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    _SOMATIC.update(inp)
    return _SOMATIC


@contextlib.contextmanager
def _capture_pileup_launches():
    """Each launch of B1's record form while the block runs, taken where
    ``DevicePileup.add`` makes it: (the engine, records as they went up,
    loci, table, min_mapq, min_baseq, MAPQ-0 counters); and the BAM sweeps
    the pileups made (readers opened)."""
    from ngsbits_tpu_torch.ops.device_reduce import DevicePileup
    from ngsbits_tpu_torch.qc import pileup as pm
    got: dict = {"launches": [], "sweeps": 0}
    add, reader = DevicePileup.add, pm.BamReader

    def add_records(self, rec, min_mapq, min_baseq, indel_ops=0, loci_range=None):
        got["launches"].append((self, rec, self.loci, self.table, min_mapq, min_baseq,
                                self.mapped is not None))
        return add(self, rec, min_mapq, min_baseq, indel_ops, loci_range)

    def open_reader(*a, **kw):
        got["sweeps"] += 1
        return reader(*a, **kw)

    DevicePileup.add, pm.BamReader = add_records, open_reader
    try:
        yield got
    finally:
        DevicePileup.add, pm.BamReader = add, reader


def somatic(records: dict):
    """SomaticQC on the card over a tumor/normal pair, with a target and the
    mutation burden's BEDs, then without a target (plots 2 and 3 over the
    genome); each run against the port's CPU route; every launch of B1's
    record form held against its plain version after the runs, the launch
    of median counts timed."""
    from ngsbits_tpu_torch.ops import selfcheck
    phase(f"somatic: SomaticQC on a tumor/normal pair of BAMs of 2 x {SOMATIC_PAIRS} pairs "
          f"over the mappingqc phase's genome, a panel of about {SOMATIC_PANEL} bases cut "
          f"from its exome panel, {SOMATIC_VARIANTS} somatic variants")
    inp = _somatic_inputs()
    common = ["SomaticQC", "-somatic_vcf", str(inp["vcf"]), "-tumor_bam", str(inp["tumor"]),
              "-normal_bam", str(inp["normal"])]
    target = ["-target_bed", str(inp["target"]), "-target_exons", str(inp["bed"]),
              "-blacklist", str(WORK / "somatic_blacklist.bed"),
              "-tsg_bed", str(WORK / "somatic_tsg.bed"), "-ref", str(inp["fa"])]
    runs = [("SomaticQC -target_bed -target_exons -blacklist -tsg_bed", target),
            (f"SomaticQC without a target (the genome's first {SOMATIC_GENOME} chromosomes)",
             ["-ref", str(inp["fa_prefix"])])]
    launches_all = []
    for k, (label, extra) in enumerate(runs):
        card = WORK / f"somatic_card{k}.qcML"
        with _capture_pileup_launches() as got:
            _reset()
            tool, seconds = _port([*common, *extra, "-out", str(card)])
            launches = _launches()
        if launches["pileup_add_records"] == 0:
            raise AssertionError(f"pileup_add_records was not launched by {label}: {launches}")
        other = {n: c for n, c in launches.items() if c and n != "pileup_add_records"}
        if other:
            raise AssertionError(f"{label} launched kernels off its path: {other}")
        if got["sweeps"] != 2 or len(got["launches"]) != launches["pileup_add_records"]:
            raise AssertionError(f"{label}: {got['sweeps']} BAM sweeps (not one a BAM), "
                                 f"{len(got['launches'])} inputs for "
                                 f"{launches['pileup_add_records']} launches")
        if _jax_loaded():
            raise AssertionError(f"the port loaded {_jax_loaded()}")
        engines = []
        for eng, *_ in got["launches"]:
            if not any(e is eng for e in engines):
                engines.append(eng)
        per_sweep = [sum(1 for e, *_ in got["launches"] if e is eng) for eng in engines]
        launches_all += [(f"{label}, the {('tumor', 'normal')[j]}'s sweep", *args[1:])
                         for j, eng in enumerate(engines)
                         for args in got["launches"] if args[0] is eng]
        by_tool = _kernel_record(records, "pileup_add_records").setdefault("launches_by_tool", {})
        by_tool["SomaticQC"] = by_tool.get("SomaticQC", 0) + launches["pileup_add_records"]
        report = card.read_text()
        values = dict(re.findall(r'name="([^"]+)" description="[^"]*" value="([^"]*)"', report))
        stages = ", ".join(f"{s} {v:.4f}" for s, v in tool.seconds.items())
        print(f"{label} on {torch.cuda.get_device_name(0)}: {seconds:.3f} s (stages: {stages}); "
              f"B1's record form launched {per_sweep} times in the tumor's and the normal's "
              f"sweep; {report.count('<binary>')} plots; sample correlation "
              f"{values.get('sample correlation')}, tumor content estimate "
              f"{values.get('tumor content estimate')}, somatic variant rate "
              f"{values.get('somatic variant rate')}", flush=True)
        if k == 0 and "n/a" in values.get("sample correlation", "n/a") + \
                values.get("tumor content estimate", "n/a"):
            raise AssertionError(f"{label}: the correlation or tumor content read n/a")
        cpu = WORK / f"somatic_cpu{k}.qcML"
        t0 = time.perf_counter()
        _port_on_cpu([*common, *extra, "-out", str(cpu)])
        cpu_s = time.perf_counter() - t0
        if _drop_creation(card) != _drop_creation(cpu):
            raise AssertionError(f"{label}: the card's and the CPU route's reports differ")
        print(f"  card == CPU route on the same files ({cpu_s:.1f} s on the CPU, in a process "
              f"of its own)", flush=True)
    records["pileup_add_records"]["launches"] = sum(
        records["pileup_add_records"]["launches_by_tool"].values())

    phase(f"kernels: B1's record form at the somatic phase's {len(launches_all)} launches")
    from ngsbits_tpu_torch.ops import device_reduce as dr
    t0 = time.perf_counter()
    n_hits, depth = [], {}
    for k, (sweep, *args) in enumerate(launches_all):
        _check_equal(selfcheck.pileup_case(*args), f"somatic launch {k}")
        n_hits.append(dr.pileup_hits(*args[:5])[1].shape[0])
        total, _ = depth.get(sweep, (0, 0))
        depth[sweep] = (total + n_hits[-1], args[1].shape[0])
    print(f"pileup_add_records: equal at each of the somatic phase's {len(launches_all)} "
          f"launches ({min(n_hits)}-{max(n_hits)} bases and deletions at the loci; checks "
          f"{time.perf_counter() - t0:.2f} s, not in the runs' times); mean depth at the "
          f"loci (bases and deletions that pass the filters): "
          + "; ".join(f"{sweep} {total / n:.2f} at {n} loci"
                      for sweep, (total, n) in depth.items()), flush=True)
    k, _ = _median_launch(list(range(len(launches_all))), lambda a: n_hits[a])
    _, rec, loci, table, mq, bq, track = launches_all[k]
    got = _record(records, selfcheck.pileup_case(rec, loci, table, mq, bq, track),
                  f"somatic launch {k} of {len(launches_all)} (median): {rec.pos.shape[0]} "
                  f"records, {n_hits[k]} bases and deletions at {loci.shape[0]} loci, min_mapq "
                  f"{mq}, min_baseq {bq}", False, cold=True)
    records["pileup_add_records"]["somatic_median"] = {
        key: got[key] for key in ("shape", "ms", "cold_ms", "call_ms", "plain_ms", "bound_ms")}


# ------------------------------------------------------ VariantQC and RohHunter

VARIANT_CHROMS = ("chr1", "chr2", "chrX")   # chr1 and chr2 at GRCh38's lengths
VARIANT_CHRX = 50_000_000           # chrX cut to its first 50 Mb
VARIANT_BP_PER_RECORD = 982         # 500,000 records over chr1 and chr2
VARIANT_PREFIX = 45_000             # the prefix the CPU route runs on: its
VARIANT_PREFIX_CHRX = 5_000         # first records, then chrX's first ones


def variant_kernels(records: dict, dev: torch.device):
    """V1 against its plain version at ``VARIANT_EDGES``, no records and
    20,000 random records (timed there until the variants phase times it at
    its runs' inputs), with and without the FILTER test; H1 at its edges
    (timed there likewise) and with no range, bit patterns equal."""
    from ngsbits_tpu_torch.ops import selfcheck
    phase("kernels: VariantQC's record classification (V1) and RohHunter's ROH products "
          "(H1) at their edges")
    timed = {"variant_classify": f"{selfcheck.VARIANT_FUZZ} random records",
             "roh_products": "edges"}
    for label, case in selfcheck.variant_cases(dev) + selfcheck.roh_cases(dev):
        if label == timed[case.name]:
            _record(records, case, label, True, cold=True,
                    peak_ops=PEAK_FP64_OPS if case.name == "roh_products" else PEAK_INT_OPS)
        else:
            _check_equal(case, label)
            print(f"{case.name:16s} {label}: equal", flush=True)


@contextlib.contextmanager
def _capture_variant_launches():
    """Each V1 and H1 launch while the block runs, in call order: its
    inputs and what it returned (copied on the card), taken where VariantQC
    and RohHunter call the wrappers."""
    from ngsbits_tpu_torch.qc import variant_stats
    from ngsbits_tpu_torch.tools import roh_hunter
    got: dict = {"variant_classify": [], "roh_products": []}
    classify, products = variant_stats.variant_classify_into, roh_hunter.roh_products_into

    def v1(data, offsets, filter_, out):
        classify(data, offsets, filter_, out)
        got["variant_classify"].append((data, offsets, filter_, out.clone()))

    def h1(af, ranges, out):
        products(af, ranges, out)
        got["roh_products"].append((af, ranges, out.clone()))

    variant_stats.variant_classify_into, roh_hunter.roh_products_into = v1, h1
    try:
        yield got
    finally:
        variant_stats.variant_classify_into, roh_hunter.roh_products_into = classify, products


def _vcf_prefix(src: Path, dst: Path, n: int, chrom: bytes, n_chrom: int):
    """The header, the first n records of a VCF and the first n_chrom
    records of chromosome ``chrom`` (which must come after them)."""
    with open(src, "rb") as fin, open(dst, "wb") as fout:
        for line in fin:
            if line.startswith(b"#") or n > 0:
                n -= not line.startswith(b"#")
                fout.write(line)
            elif line.startswith(chrom + b"\t"):
                fout.write(line)
                n_chrom -= 1
                if n_chrom == 0:
                    break


def _variant_runs(vcf: Path, beds: dict, d: Path) -> dict:
    """The phase's runs: label -> (arguments writing under ``d``, the kernel
    its path launches, its launches a run)."""
    return {
        "VariantQC": (["VariantQC", "-in", str(vcf), "-out", str(d / "qc.qcML")],
                      "variant_classify", 1),
        "VariantQC -txt -ignore_filter": (["VariantQC", "-in", str(vcf), "-txt",
                                           "-ignore_filter", "-out", str(d / "qc.txt")],
                                          "variant_classify", 1),
        "VariantQC -long_read -phasing_bed": (["VariantQC", "-in", str(vcf), "-long_read",
                                               "-phasing_bed", str(d / "blocks.bed"), "-out",
                                               str(d / "long.qcML")], "variant_classify", 1),
        "RohHunter -var_af_keys_vep -exclude -annotate": (
            ["RohHunter", "-in", str(vcf), "-var_af_keys_vep", "gnomAD_AF,AF", "-exclude",
             str(beds["exclude"]), "-annotate", str(beds["a"]), str(beds["b"]), "-out",
             str(d / "roh.tsv")], "roh_products", 2),
        "RohHunter -var_af_keys AF -inc_chrx": (
            ["RohHunter", "-in", str(vcf), "-var_af_keys", "AF", "-inc_chrx", "-out",
             str(d / "roh_x.tsv")], "roh_products", 2),
    }


def _union_us(intervals: list[tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _busy(trace: str, wall_s: float) -> str:
    """The device busy share of a ``device_profile`` trace: the union of its
    kernels', copies' and memsets' intervals over the run's wall."""
    events = json.loads(Path(trace).read_text())["traceEvents"]
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        return "device busy share not measured (no device event in the trace)"
    busy_us = _union_us(device)
    kernels = sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "kernel")
    return (f"device busy {busy_us / 1000:.3f} ms = {100 * busy_us / 1e6 / wall_s:.3f}% of the "
            f"{wall_s:.3f} s wall ({kernels} kernels, {len(device) - kernels} copies and sets)")


def _h1_chain(got: dict, af: torch.Tensor, ranges: torch.Tensor, floors: dict) -> str:
    """Adds an H1 launch's longest range, longest chain before an exit and
    chain floor (that chain's multiplies at ``floors``' latency, plus the
    cold launch floor) to its numbers ``got``; returns them as text."""
    from ngsbits_tpu_torch.ops import selfcheck
    got.update(selfcheck.roh_chain(af.cpu().numpy(), ranges.cpu().numpy()))
    got["chain_floor_ms"] = (got["longest_chain"] * floors["dmul_ns"] * 1e-6
                             + floors["launch_cold_ms"])
    return (f"longest range {got['longest_range']} markers, longest chain to exit "
            f"{got['longest_chain']}, chain floor {got['chain_floor_ms']:.4f} ms "
            f"({got['chain_floor_ms'] / got['cold_ms']:.1%} of the cold time; bound "
            f"{got['bound_ms'] / got['cold_ms']:.1%})")


def variants(records: dict, h1_probe):
    """VariantQC and RohHunter on the card over a WGS-shaped VCF of chr1 and
    chr2; every V1 and H1 launch held against its plain version, each timed
    at its runs' inputs, H1's beside its chain floor; the first run of each
    tool traced (``device_profile``); the card against the CPU route on a
    prefix; ``NgsBitsInfo``."""
    from ngsbits_tpu_torch.ops import selfcheck
    from ngsbits_tpu_torch.utils import synth
    from ngsbits_tpu_torch.utils.trace import device_profile
    t_phase = time.perf_counter()
    lengths = {c: synth.GRCH38_LENGTHS[c] for c in VARIANT_CHROMS}
    lengths["chrX"] = VARIANT_CHRX
    n_records = sum(lengths.values()) // VARIANT_BP_PER_RECORD
    phase(f"variants: VariantQC and RohHunter on a VCF of {n_records} records over "
          f"{', '.join(VARIANT_CHROMS)} (chrX its first {VARIANT_CHRX} bases); the CPU route on "
          f"its first {VARIANT_PREFIX} and chrX's first {VARIANT_PREFIX_CHRX}")
    vcf, prefix = WORK / "wgs.vcf", WORK / "wgs_prefix.vcf"
    segments = synth.wgs_vcf(vcf, lengths, seed=101, n_records=n_records)
    beds = {"exclude": WORK / "roh_exclude.bed", "a": WORK / "roh_genes.bed",
            "b": WORK / "roh_plain.bed"}
    synth.roh_beds(beds["exclude"], [beds["a"], beds["b"]], lengths, segments, seed=102)
    _vcf_prefix(vcf, prefix, VARIANT_PREFIX, b"chrX", VARIANT_PREFIX_CHRX)
    print(f"inputs in {time.perf_counter() - t_phase:.2f} s: {vcf.stat().st_size} bytes, "
          f"{len(segments)} planted ROH segments ({sum(c == 'chrX' for c, _, _ in segments)} on "
          f"chrX) of {min(e - s for _, s, e in segments) + 1}-"
          f"{max(e - s for _, s, e in segments) + 1} bases", flush=True)
    launches_all: dict = {"variant_classify": [], "roh_products": []}
    (WORK / "variants_card").mkdir(exist_ok=True)
    traced = ("VariantQC", "RohHunter -var_af_keys_vep -exclude -annotate")
    for label, (args, kernel, want) in _variant_runs(vcf, beds, WORK / "variants_card").items():
        with _capture_variant_launches() as got, \
                device_profile(str(WORK / "traces") if label in traced else None) as prof:
            _reset()
            tool, seconds = _port(args)
            launches = _launches()
        if launches[kernel] != want or len(got[kernel]) != want:
            raise AssertionError(f"{label} launched {kernel} {launches[kernel]} times, not {want}")
        other = {n: c for n, c in launches.items() if c and n != kernel}
        if other:
            raise AssertionError(f"{label} launched kernels off its path: {other}")
        if _jax_loaded():
            raise AssertionError(f"the port loaded {_jax_loaded()}")
        launches_all[kernel] += [(label, j, *a) for j, a in enumerate(got[kernel])]
        by_tool = _kernel_record(records, kernel).setdefault("launches_by_tool", {})
        by_tool[label] = launches[kernel]
        stages = ", ".join(f"{k} {v:.4f}" for k, v in tool.seconds.items())
        print(f"{label} on {torch.cuda.get_device_name(0)}: {seconds:.3f} s (stages: {stages}); "
              f"{kernel} launched {launches[kernel]} times", flush=True)
        if prof is not None:
            print(f"  traced (device_profile: CPU and CUDA activity, the wall above with the "
                  f"profiler on): {_busy(prof.trace_path, seconds)}", flush=True)
    for name in launches_all:
        records[name]["launches"] = sum(records[name]["launches_by_tool"].values())
    print((WORK / "variants_card" / "qc.txt").read_text().strip().replace("\n", "; "),
          flush=True)
    regions = {name: [l.split("\t", 1)[0] for l in
                      (WORK / "variants_card" / name).read_text().splitlines()[1:]]
               for name in ("roh.tsv", "roh_x.tsv")}
    x = {name: chroms.count("chrX") for name, chroms in regions.items()}
    print(f"RohHunter -exclude -annotate: {len(regions['roh.tsv'])} regions; -inc_chrx: "
          f"{len(regions['roh_x.tsv'])}, {x['roh_x.tsv']} of them on chrX", flush=True)
    if x["roh.tsv"] or not x["roh_x.tsv"]:
        raise AssertionError(f"chrX regions: {x['roh.tsv']} without -inc_chrx, "
                             f"{x['roh_x.tsv']} with it")

    t0 = time.perf_counter()
    card, cpu = WORK / "variants_prefix_card", WORK / "variants_prefix_cpu"
    card.mkdir(exist_ok=True)
    cpu.mkdir(exist_ok=True)
    procs = [subprocess.Popen([sys.executable, "-m", "ngsbits_tpu_torch", *args], cwd=ROOT,
                              env=dict(os.environ, NGSBITS_TORCH_DEVICE="cpu"),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for args, _, _ in _variant_runs(prefix, beds, cpu).values()]
    for label, (args, kernel, _) in _variant_runs(prefix, beds, card).items():
        with _capture_variant_launches() as got:
            _port(args)
        launches_all[kernel] += [(f"{label} on the prefix", j, *a)
                                 for j, a in enumerate(got[kernel])]
    for p in procs:
        out, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"the CPU route exited {p.returncode}:\n{err}")
    names = _same_files(card, cpu, "the variants phase's prefix: card against the CPU route")
    print(f"card == CPU route on the first {VARIANT_PREFIX} records and chrX's first "
          f"{VARIANT_PREFIX_CHRX}: {len(names)} files "
          f"byte-identical ({', '.join(names)}; {time.perf_counter() - t0:.1f} s, the CPU "
          f"route's five runs in processes of their own, at once)", flush=True)

    phase(f"kernels: V1 at the variants phase's {len(launches_all['variant_classify'])} "
          f"launches and H1 at its {len(launches_all['roh_products'])}")
    floors = records["roh_products"]["floors"] = h1_floors(h1_probe)
    print(f"H1's yardsticks: a dependent float64 multiply {floors['dmul_ns']:.3f} ns "
          f"({floors['dmul_cycles']:.2f} SM cycles, a one-thread chain of {H1_CHAIN}); an empty "
          f"kernel {floors['launch_ms']:.4f} ms, cold {floors['launch_cold_ms']:.4f} ms",
          flush=True)
    timed = next(k for k, a in enumerate(launches_all["variant_classify"]) if not a[4])
    filtered = next(k for k, a in enumerate(launches_all["variant_classify"])
                    if a[0] == "VariantQC")
    for k, (label, _, data, offsets, filter_, out) in enumerate(launches_all["variant_classify"]):
        case = selfcheck.variant_classify_case(data, offsets, filter_)
        _check_equal(case, f"{label}'s launch")
        if not torch.equal(out, case.outputs()[1][0]):
            raise AssertionError(f"variant_classify: {label}'s counts differ from the plain "
                                 f"version's")
        n = offsets.shape[0] // 6
        if k in (timed, filtered):
            needed, counted = selfcheck.variant_needed_bytes(data, offsets, filter_)
            got = _record(records, case, f"{label}'s launch: {n} records ({counted} counted), "
                          f"{int(offsets[-1])} bytes of fields, {needed} of them needed",
                          k == timed, cold=True)
            if k == filtered:
                records["variant_classify"]["filtered_launch"] = got
        else:
            print(f"variant_classify {label}'s launch: equal ({n} records)", flush=True)
    for label, j, af, ranges, out in launches_all["roh_products"]:
        case = selfcheck.roh_products_case(af, ranges)
        _check_equal(case, f"{label}'s launch {j}")
        if not torch.equal(out.view(torch.int64), case.outputs()[1][0]):
            raise AssertionError(f"roh_products: {label}'s products differ from the plain "
                                 f"version's")
        shape = (f"{label}, {('the raw runs', 'the final regions')[j]}: {ranges.shape[0]} ranges "
                 f"over {af.shape[0]} markers, {case.bytes // 8 - 3 * ranges.shape[0]} covered")
        if label == "RohHunter -var_af_keys_vep -exclude -annotate" and j == 0:
            got = _record(records, case, shape, True, cold=True, peak_ops=PEAK_FP64_OPS)
            print(f"roh_products     the raw runs: {_h1_chain(got, af, ranges, floors)}",
                  flush=True)
            records["roh_products"].update(
                {k: got[k] for k in ("longest_range", "longest_chain", "chain_floor_ms")})
        elif label == "RohHunter -var_af_keys_vep -exclude -annotate":
            # the plain version takes a step a marker of the longest region: timed once
            t0 = time.perf_counter()
            case.plain()
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            records["roh_products"]["final_regions"] = got = dict(
                shape=shape, ms=selfcheck.device_ms(case.kernel),
                cold_ms=selfcheck.cold_ms(case.kernel), call_ms=selfcheck.call_ms(case.kernel),
                plain_ms=plain_ms, bound_ms=case.bytes / PEAK_BYTES * 1e3)
            print(f"roh_products     {shape}: equal; device {got['ms']:.4f} ms, cold "
                  f"{got['cold_ms']:.4f} ms, per wrapper call {got['call_ms']:.4f} ms, plain "
                  f"{plain_ms:.4f} ms (one call, host clock); bound {got['bound_ms']:.4f} ms "
                  f"({case.bytes} B); {_h1_chain(got, af, ranges, floors)}", flush=True)
        else:
            print(f"roh_products     {shape}: equal", flush=True)
    del launches_all
    torch.cuda.empty_cache()
    _port(["NgsBitsInfo"])
    print(f"variants phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------- the mesh

MESH_READS = RQ_PREFIX + 1   # ReadQC's reads a mate: its last batch odd
MESH_TIMEOUT = 300           # seconds a group of ranks may take


def _mesh_inputs() -> dict:
    """The mesh phase's inputs: prefixes of the readqc and seqpurge phases'
    FASTQs (made afresh with the same seeds where those phases did not run)
    and the mappingqc phase's exome."""
    from ngsbits_tpu_torch.utils.synth import synth_fastq, synth_pairs
    inp = dict(_mq_inputs())
    rq = [WORK / f"mesh_rq{k}.fastq.gz" for k in (1, 2)]
    for k, (src, dst) in enumerate(zip((WORK / "rq1.fastq.gz", WORK / "rq2.fastq.gz"), rq)):
        if src.exists():
            _prefix(src, dst, MESH_READS)
        else:
            synth_fastq(dst, MESH_READS, READ_LEN, seed=42 + k)
    sp = [WORK / "sp1.prefix.fastq.gz", WORK / "sp2.prefix.fastq.gz"]
    if not sp[0].exists():
        synth_pairs(*sp, SP_PREFIX, seed=7, read_len=READ_LEN)
    inp.update(rq=rq, sp=sp)
    return inp


def _mesh_runs(inp: dict, d: Path) -> dict:
    """The four routes' runs, each as (label, arguments, the kernels its path
    must launch), writing under ``d``."""
    fa, bed = str(inp["fa"]), str(inp["bed"])
    (d / "sp").mkdir(parents=True, exist_ok=True)
    cov = ["coverage_add_records", "coverage_finalize"]
    return {
        "ReadQC": (["ReadQC", "-in1", str(inp["rq"][0]), "-in2", str(inp["rq"][1]),
                    "-out", str(d / "ReadQC.qcML")],
                   ["readqc_unpack", "readqc_batch", "readqc_tails"]),
        "SeqPurge -qc": (_seqpurge_args(d / "sp", *inp["sp"], []), list(SP_PATH)),
        "MappingQC -roi -read_qc": (_mq_args(d / "mq", inp["bam"], Path(bed), Path(fa)),
                                    ["coverage_add_reads", "coverage_finalize",
                                     "readqc_unpack", "readqc_batch", "readqc_tails"]),
        "BedCoverage": (["BedCoverage", "-bam", str(inp["bam"]), "-in", bed, "-out",
                         str(d / "BedCoverage.bed")], cov + ["region_sums"]),
        "BedLowCoverage -min_baseq 20": (["BedLowCoverage", "-bam", str(inp["bam"]), "-in", bed,
                                          "-cutoff", str(COV_CUTOFF), "-min_baseq", "20",
                                          "-out", str(d / "BedLowCoverage.bed")],
                                         cov + ["threshold_runs"]),
    }


def _outputs(d: Path) -> dict:
    """Every file under ``d`` as compared: FASTQs decompressed, qcML without
    ``creation `` lines."""
    out = {}
    for p in sorted(d.rglob("*")):
        if p.is_file():
            data = p.read_bytes()
            if p.name.endswith(".gz"):
                data = gzip.decompress(data)
            elif p.name.endswith(".qcML"):
                data = "\n".join(_drop_creation(p)).encode()
            out[str(p.relative_to(d))] = data
    return out


def _same_files(a: Path, b: Path, label: str):
    got, want = _outputs(a), _outputs(b)
    if sorted(got) != sorted(want) or not got:
        raise AssertionError(f"{label}: files {sorted(got)} against {sorted(want)}")
    differ = [n for n in got if got[n] != want[n]]
    if differ:
        raise AssertionError(f"{label}: {differ} differ")
    return sorted(got)


def _mesh_counts() -> dict:
    from ngsbits_tpu_torch.parallel import mesh
    return dict(mesh.COUNTS)


def _moved(before: dict) -> str:
    now = _mesh_counts()
    return (f"all_reduce {now['all_reduce_bytes'] - before['all_reduce_bytes']} bytes in "
            f"{now['all_reduce'] - before['all_reduce']} calls, all_gather "
            f"{now['all_gather_bytes'] - before['all_gather_bytes']} bytes in "
            f"{now['all_gather'] - before['all_gather']} calls")


def _dryrun(records: dict, n: int, backend: str | None) -> list[dict]:
    """``dryrun_multichip(n)``; each step's launches and bytes printed (a
    rank other than 0 too), its kernels' launches recorded."""
    from ngsbits_tpu_torch.entry import dryrun_multichip
    t0 = time.perf_counter()
    ranks = dryrun_multichip(n, backend=backend, timeout=MESH_TIMEOUT)
    wall = time.perf_counter() - t0
    want = {"sharded_readqc_step": {"readqc_batch"},
            "sharded_coverage_step": {"coverage_add", "coverage_finalize"},
            "sharded_insert_scan": {"insert_scan"},
            "sharded_correlation_step uint8": {"correlation_moments"}}
    print(f"dryrun_multichip({n}) over {ranks[0]['backend']} on {ranks[0]['device']}: "
          f"{wall:.3f} s with {n} process start(s); every step equal to the same kernels on "
          f"the whole input", flush=True)
    for r in ranks:
        for st in r["steps"]:
            if not want.get(st["step"], set()) <= set(st["launches"]):
                raise AssertionError(f"dryrun rank {r['rank']}: {st['step']} launched "
                                     f"{st['launches']}")
            print(f"  rank {r['rank']} {st['step']}: {st['seconds']:.4f} s, launches "
                  f"{st['launches']}, all_reduce {st['all_reduce_bytes']} bytes, all_gather "
                  f"{st['all_gather_bytes']} bytes", flush=True)
            for name, count in st["launches"].items():
                by_tool = _kernel_record(records, name).setdefault("launches_by_tool", {})
                key = f"mesh dryrun {n} rank {r['rank']}"
                by_tool[key] = by_tool.get(key, 0) + count
    return ranks


def _two_ranks(label: str, args: list[str], d: Path) -> list[dict]:
    """``args`` as two ranks of one gloo group on the card, each a process
    of this script; their records (rank 0 wrote under ``d``)."""
    from ngsbits_tpu_torch.parallel import mesh
    t0 = time.perf_counter()
    res = mesh.spawn_ranks(2, [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
                               *args],
                           env={"NGSBITS_MESH": "1", mesh.BACKEND_ENV: "gloo",
                                "NGSBITS_TORCH_DEVICE": "cuda"}, timeout=MESH_TIMEOUT)
    wall = time.perf_counter() - t0
    for r, p in enumerate(res):
        if p.returncode != 0:
            raise AssertionError(f"{label}, rank {r} of 2 exited {p.returncode}:\n"
                                 f"{p.stderr[-4000:]}")
    ranks = [json.loads(p.stdout.strip().splitlines()[-1]) for p in res]
    for r in ranks:
        print(f"  {label}, rank {r['rank']} of 2 (gloo, {r['device']}): {r['seconds']:.3f} s "
              f"in the tool, all_reduce {r['all_reduce_bytes']} bytes in {r['all_reduce']} "
              f"calls, all_gather {r['all_gather_bytes']} bytes; launches {r['launches']}",
              flush=True)
    print(f"{label} as two ranks on one card over gloo: {wall:.3f} s with two process "
          f"starts", flush=True)
    return ranks


def mesh_rank(args: list[str]) -> int:
    """One rank of a two-rank run (``--mesh-rank``): the tool in this
    process, then one JSON line of its wall, launches and collective bytes."""
    from ngsbits_tpu_torch.parallel import mesh
    from ngsbits_tpu_torch.tools import get_tool
    from ngsbits_tpu_torch.utils.backend import device
    _reset()
    t0 = time.perf_counter()
    rc = get_tool(args[0])().execute(args[1:])
    torch.cuda.synchronize()
    print(json.dumps(dict(rank=int(os.environ.get("RANK", "0")), rc=rc,
                          seconds=time.perf_counter() - t0, device=str(device()),
                          launches={k: v for k, v in _launches().items() if v},
                          **mesh.COUNTS)), flush=True)
    return rc


def mesh_phase(records: dict):
    """The mesh layer on the card: a world of one on NCCL, then two ranks
    over gloo; every output byte-compared with the run without the mesh."""
    phase(f"mesh: dryrun_multichip(1) on NCCL; ReadQC (2 x {MESH_READS} reads), SeqPurge -qc "
          f"({SP_PREFIX} pairs), MappingQC -roi -read_qc (the mappingqc phase's BAM), BedCoverage and "
          f"BedLowCoverage -min_baseq 20 (the exome) with NGSBITS_MESH=1 at a world of one; "
          f"then two ranks over gloo on the one card")
    from ngsbits_tpu_torch.parallel import mesh
    t_phase = time.perf_counter()
    inp = _mesh_inputs()
    print(f"inputs ready in {time.perf_counter() - t_phase:.2f} s", flush=True)
    _dryrun(records, 1, None)
    plain, one = WORK / "mesh_plain", WORK / "mesh_one"
    runs = _mesh_runs(inp, plain)
    for label, (args, path) in _mesh_runs(inp, one).items():
        os.environ.pop("NGSBITS_MESH", None)
        _, plain_s = _port(runs[label][0])
        os.environ["NGSBITS_MESH"] = "1"
        try:
            before = _mesh_counts()
            _reset()
            _, seconds = _port(args)
            launches = _launches()
        finally:
            os.environ.pop("NGSBITS_MESH", None)
        if mesh.active():
            raise AssertionError(f"{label} left its process group up")
        missed = [k for k in path if launches[k] == 0]
        if missed:
            raise AssertionError(f"{label} on the mesh did not launch {missed}: {launches}")
        for k in path:
            by_tool = _kernel_record(records, k).setdefault("launches_by_tool", {})
            by_tool[f"mesh {label}"] = launches[k]
        print(f"{label} with NGSBITS_MESH=1 (NCCL, a world of one): {seconds:.3f} s against "
              f"{plain_s:.3f} s without the mesh; {_moved(before)}; launches "
              f"{ {k: launches[k] for k in path} }", flush=True)
    names = _same_files(one, plain, "the mesh at a world of one against no mesh")
    print(f"world of one == no mesh: {len(names)} files byte-identical ({', '.join(names)})",
          flush=True)

    _dryrun(records, 2, "gloo")
    two = WORK / "mesh_two"
    two_runs = _mesh_runs(inp, two)
    for label in ("ReadQC", "BedCoverage"):
        args, path = two_runs[label]
        ranks = _two_ranks(label, args, two)
        missed = [k for k in path if not ranks[1]["launches"].get(k)]
        if missed:
            raise AssertionError(f"{label}: rank 1 launched no {missed}")
        for k in path:
            _kernel_record(records, k).setdefault("launches_by_tool", {})[
                f"mesh {label} rank 1 of 2"] = \
                ranks[1]["launches"][k]
        name = Path(args[args.index("-out") + 1]).name
        if _outputs(two).get(name) != _outputs(one).get(name) or name not in _outputs(two):
            raise AssertionError(f"{label}: two ranks' {name} differs from the world of one's")
        print(f"{label}: two ranks == a world of one ({name} byte-identical)", flush=True)
    # C1's span form: sharded_coverage_step's, the one main path that launches it
    span_form = _kernel_record(records, "coverage_add")
    span_form["launches"] = span_form["launches_by_tool"]["mesh dryrun 1 rank 0"]
    if _jax_loaded():
        raise AssertionError(f"the port loaded {_jax_loaded()}")
    print(f"mesh phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", choices=("all", "kernels", "mappingqc", "coverage",
                                        "similarity", "callers", "annotate", "somatic",
                                        "variants", "mesh"),
                    default="all",
                    help="'kernels' stops after the kernels phase (no tool "
                         "run, so no launch counts); 'mappingqc', 'coverage', "
                         "'similarity', 'callers', 'annotate', 'somatic', 'variants' and "
                         "'mesh' run the kernels phase and that phase only")
    ap.add_argument("--mesh-rank", nargs=argparse.REMAINDER, metavar="TOOL",
                    help="run one rank of the mesh phase's two-rank runs: a tool and its "
                         "arguments (the rank's group from RANK, WORLD_SIZE and "
                         "NGSBITS_MESH_INIT)")
    ap.add_argument("--save-indel-launch", type=Path, metavar="FILE",
                    help="the callers phase saves the inputs of B1's indel form's launch "
                         "of median hits there (for scripts/indel_variants.py --launch)")
    ap.add_argument("--save-region-launch", type=Path, metavar="FILE",
                    help="the annotate phase saves the inputs of B1's region form's launch "
                         "of median hits there (for scripts/region_variants.py --launch)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import ngsbits_tpu_torch  # noqa: F401  fails outside a checkout of the repo
    if args.mesh_rank:
        return mesh_rank(args.mesh_rank)
    os.environ["NGSBITS_TORCH_DEVICE"] = "cuda"
    dev = torch.device("cuda")
    probe()
    h1_probe = build()
    records = kernels(dev)
    if args.phase != "kernels":
        WORK.mkdir(parents=True, exist_ok=True)
        try:
            if args.phase == "all":
                readqc(records)
                seqpurge(records)
            if args.phase in ("all", "mappingqc"):
                mappingqc(records)
            if args.phase in ("all", "coverage"):
                coverage(records, dev)
            if args.phase in ("all", "similarity"):
                similarity(records)
            if args.phase in ("all", "callers"):
                callers(records, args.save_indel_launch)
            if args.phase in ("all", "annotate"):
                annotate(records, _callers_inputs(), args.save_region_launch)
            if args.phase in ("all", "somatic"):
                somatic(records)
            if args.phase in ("all", "variants"):
                variants(records, h1_probe)
            if args.phase in ("all", "mesh"):
                mesh_phase(records)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
