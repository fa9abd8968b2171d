#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (pandaseq_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package pandaseq_tpu.
Each phase passes or the script exits nonzero without a result line; no
phase is caught.

1. The card (nvidia-smi name and power limit), torch and CUDA versions,
   the kernels' build from pandaseq_tpu_torch/csrc (one nvcc per source,
   in parallel; seconds), and the native host library.
2. Each CUDA kernel against its plain PyTorch twin on the card at B=8192
   (the CLI's batch) and Lb=O in {256, 384, 512}, with CUDA-event times
   of each kernel and its twin, and the bound of each (the larger of its
   bytes over 3.35 TB/s and the operations its function needs over the
   card's rate for their type; see WORK); cand_join, counts and the
   shortlist also, with the same checks and times, at the shape buckets
   (Lb, O) of phase 8's runs that these lack (SHAPE_ROWS): (128, 128) on
   2x100 reads with N and (384, 256) on 2x300 reads whose R2 is cut to
   200-250 bp, each batch's bucket first checked against the engine's
   rule (batch_buckets):
   - cand_join, the candidate search of every path, exactly: on the
     4-bit packed plane and on the nibble plane with N, at num_kmers in
     {0, 1, 2, 3}, list and mask, over the whole plane (a mesh runs it
     once per dp row: phase 4); on reads generated by
     tests/golden/make_data.py --fast (through make_batch and psq_pack4),
     on generated reads with N, and on random planes with low-entropy
     rows; the bitmasks also against native.cand_mask, the exact host
     twin;
   - the dense path's counts (the k-mer frames fused in) exactly, at
     num_kmers in {0, 1, 2, 3}, over the full plane and the row blocks of
     op 2 and 4 (summed against the full plane), with the hits of each
     block's rows and with the mesh's hit rows (every row in the first
     block, none in the others), its k-mer hits against cand_join's
     mask; shortlist exactly or within SHORTLIST_ULPS on its
     f32 columns for each of the four count kinds; on generated reads
     with N bases and B-cliffs (make_data.py without --fast) and on
     random nibble planes with N runs and low-entropy rows; the
     shortlist of every score kind also on the edge rows of
     tests/shortlist_rows.py, on whose -0.0 / +0.0 row the pear kind
     ships jax.lax.top_k's order (the +0.0 offsets first), argmax's
     besto32 and XLA's best32 (the last zero's sign), as the JAX package
     does on the CPU; assemble_candidates_nt on the card against
     native.cand_mask at num_kmers in {1, 2, 3};
   - counts (num_kmers 0 and 2), shortlist and lut_sums timed beside the
     recorded times of the kernels they replaced (REPLACED_MS) on the
     card those were taken on (REFERENCE_CARD): the script exits nonzero
     if counts at num_kmers 0, shortlist or lut_sums (pear) takes more
     than MAX_RATIO of them at any width; on another card it prints "not
     compared";
   - lut_sums (the pear / rdp_mle LUT sums) against its twin bit for bit
     (0 ulp), over the full plane and the row blocks of op 2 and 4, on
     the generated reads with N (their own qual planes, stale tails
     included), on random nibble planes with random quals and on the
     edge rows of tests/lut_rows.py; the LUT kind of the shortlist
     kernel against its twin.
3. The port CLI end to end against the native host engine
   (PANDASEQ_TPU_ENGINE=host). The cuda runs are the run a user types:
   PANDASEQ_TPU_ENGINE is not set, so each must log INFO ENGINE "cuda
   (default)" (no probe): FASTA byte-identical and non-empty, the
   STAT/log line sequence equal, and every kernel of the run's path
   launched once per dispatched batch and every other kernel never (the
   defaults: cand_join alone; -k 0: counts and shortlist):
   - the defaults (simple_bayesian, -k 2) on 500,000 generated 2x250
     pairs, in turns cuda, host, host, cuda; again on the 200-pair
     stream with N bases and B-cliffs (the host fix-up path);
   - -k 0 (the dense path) on the same 500,000 pairs, and -k 0 with
     -A uparse, ea_util, flash and stitch on 50,000 pairs, each in turns
     cuda, host, host, cuda; -k 0 on the 200-pair stream;
   - the engine probe: one run under PANDASEQ_TPU_ENGINE=auto on the
     200-pair stream with an empty probe cache shows INFO ENGINE with
     reason probe and the measured host and device ms; its launch check
     leaves out the probe's own runtime.PROBE_RUNS launches of cand_join.
   Pairs/s of both engines beside the card's line.
3b. The installed layout: the files a wheel of this checkout ships (the
   package's *.py and the package-data globs of pyproject.toml) copied
   into a temporary directory outside the checkout, left unchanged (its
   files read-only, and compared before and after), with HOME in another
   temporary directory and PANDASEQ_TPU_CACHE unset. One process from
   there builds the kernels and the native host library from scratch
   under ~/.cache/pandaseq_tpu_torch (printing the seconds of each) and
   runs the CLI's defaults on the 500,000 pairs with no engine pin: it
   must log INFO ENGINE cuda (default), launch cand_join once per batch
   (62) and nothing else (the counts set to 0 just before the run and
   read just after, as phase 3 does), and write phase 3's FASTA byte for
   byte.
4. The mesh engine (parallel/shard.py) on one card: BatchAssembler with
   make_mesh(devices=["cuda:0"] * 4, dp=2, op=2) through emit_stream on
   the 500,000 pairs, for the defaults and -k 0, and with a dp-only mesh
   (dp=2, op=1) for the defaults: FASTA byte-identical to the CLI runs of
   phase 3, STAT counters equal to the host engine's through the same
   emit_stream loop (which, with the unpinned single-device engine,
   reason default, is also timed there), and the launches the split
   implies (a split batch launches cand_join once per dp row, not once
   per mesh cell: the sort-join runs once per dp row; counts once per
   mesh cell and the shortlist once per dp row; an unsplit batch each once: over the
   500,000 pairs' 62 batches, all split, the (2, 2) mesh launches
   cand_join 124 times, counts 248 and shortlist 124). Then the pear /
   rdp_mle library path:
   make_sharded_step on the (2, 2) mesh at B=8192, Lb=O=256 against the
   single-device assemble_shortlist: examined equal, and the shortlist
   sets equal on every row whose SL-th and SL+1-th scores are apart by
   more than the f32 summation bound; assemble_shortlist_packed (the
   [B, 3L] single upload) equal to assemble_shortlist. Pairs/s beside the
   card's line.
5. Two-process run_distributed on the card through
   ``python -m pandaseq_tpu_torch.scale_run --procs 2 --mode mux`` on the
   500,000 pairs: two OS processes on cuda:0, torch.distributed over gloo
   on localhost, claiming the stream's batches round-robin; the union of
   their part files' records equals the one-process run's, and the
   reduced counter vectors (and overlap histograms) are equal. No engine
   is pinned, so the default holds: each process
   launches cand_join once per dispatch group of its batches and no
   other kernel.
6. The tools, each through the entry point a user calls:
   pandaseq-tpu-torch-diff (-- -- -t 0.9, and -- -A pear -- -A rdp_mle)
   on 10,000 pairs with the default engine (cand_join launched in both
   passes) and the host engine: equal report and exit status;
   pandaseq-tpu-torch-hang -P/-Q on 50,000 primed pairs, the default
   engine against host: FASTA and STAT equal, non-empty;
   pandaseq-tpu-torch-checkid on one header.
7. The library entry point, pandaseq_tpu_torch.Assembler() with no
   device argument (the card is the default device), and the CLI's
   result-object path, each on the card's default engine against the
   same call on the native host engine (PANDASEQ_TPU_ENGINE=host), with
   the launch counts set to 0 just before each run and read just after:
   - Assembler.stream (batches of 1024 in dispatch groups of 4) on the
     500,000 pairs: the FASTA of its OK results (io.output.format_fasta)
     byte-identical to the host engine's and to phase 3's CLI FASTA,
     every counter getter, overlap_count and the fail callback's sids
     equal, cand_join launched once per device step the engine counted
     (_device_dispatches) and no other kernel; with num_kmers 0 on the
     50,000 pairs: counts and shortlist once per device step; with a
     registered custom algorithm (a renamed SimpleBayes) on 5,000 of
     them: counts and shortlist once per device step, against the plain
     versions on the host's CPU (a custom algorithm takes the dense
     device step on every engine). Pairs/s of each run;
   - assemble_batch on ReadPair lists of 1, 7 and 1024 pairs and on a
     decoded Batch of 8192 rows: every field of every result equal to
     the host engine's, one cand_join launch a call; assemble on 100
     single pairs: equal, no launch;
   - the CLI (batches of 8192, one launch each) with -p -q -a on the
     50,000 primed pairs, with -C <tmp>/only_short.py:400 (a check
     module without check_batch) on the 50,000 pairs and with -d rkm -N
     on the 200-pair stream: FASTA byte-identical and the STAT/log line
     sequence equal, cuda against host, cand_join once per batch.
8. The read shapes of users' runs, each through the port CLI on the
   card's default engine (INFO ENGINE cuda (default)) against the host
   engine: FASTA byte-identical, STAT equal, each kernel of the path
   launched once per batch and no other (the launch counts set to 0 just
   before each run and read just after), pairs/s of both:
   - v3v4_2x300, 500,000 MiSeq 2x300 V3-V4 pairs (400-480 bp amplicons;
     the bucket Lb = O = 384), v3v4_r2cut, the same with each R2 cut to
     200-250 bp (cut_r2: O = 256 < Lb = 384), and short_2x100, 200,000
     2x100 pairs with N runs and B-cliffs (Lb = O = 128): each at the
     defaults (cand_join) and at -k 0 (counts and shortlist);
   - pooled, 40,960 pairs each of short_2x100, v3v4_2x300, phase 3's
     2x250 and short_2x100 again (pool_streams): 20 batches whose
     buckets run 128, 384, 256, 128;
   - the first 100,000 pairs of v3v4_2x300 with -O 200 (O = 256 < Lb)
     and with -O 700, whose O_full 640 passes the CLI's plane width 512:
     every batch reroutes to the host twin, so the card's run launches
     nothing; the same stream through emit_stream on the engine counts
     the reroutes (_overflow_reroutes: every batch) and no device step,
     and writes the CLI's FASTA;
   - Assembler().stream over pooled on the card against the host engine
     (as phase 7): its device steps (cand_join launches) equal the
     prediction of the flush rule (predict_steps over the buckets of its
     batches of 1024, at group 4: 40), and its FASTA the pooled CLI
     run's.
9. The card's line, the kernels' JSON line, and the result line.
"""

from __future__ import annotations

import filecmp
import glob
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
B = 8192  # phase 2's batch: the CLI's default (cli/main.py)
CLI_BATCH = 8192  # the CLI's default batch: one dispatch per batch
CLI_DEPTH = 10  # the CLI's PANDASEQ_TPU_DEPTH default
E2E_PAIRS = 500000
ALGO_PAIRS = 50000
DIFF_PAIRS = 10000  # pandaseq-tpu-torch-diff holds every pair in memory
PRIMED_PAIRS = 50000  # pandaseq-tpu-torch-hang's input
# phase 7's sizes: the custom algorithm's stream (every pair replays
# through the oracle on the host), assemble_batch's ReadPair lists and
# decoded Batch, and assemble's single pairs
CUSTOM_PAIRS = 5000
BATCH_PAIRS = (1, 7, 1024)
DECODED_ROWS = 8192
SINGLE_PAIRS = 100
# the primers of tests/test_oracle_primers.py; hang takes -P REV -Q FWD
FWD_PRIMER = "GTGCCAGCMGCCGCGGTAA"
REV_PRIMER = "GGACTACHVGGGTWTCTAAT"
C = 4
SL = 8
SHAPES = (256, 384, 512)  # Lb = O
READ_SPEC = {256: ("250", "300", "460"), 384: ("380", "400", "700"),
             512: ("450", "500", "850")}  # read length, amplicon range
# phase 2's rows at the buckets of phase 8's streams that SHAPES lacks:
# {(Lb, O): (reads, make_data.py arguments)}; the R2-cut row's reverse
# reads are cut as phase 8's v3v4_r2cut (cut_r2)
SHAPE_ROWS = {
    (128, 128): ("2x100 with N", ("--seed", "44", "--read-len", "100",
                                  "--amp-min", "120", "--amp-max", "190",
                                  "--n-run-rate", "0.1")),
    (384, 256): ("R2-cut 2x300", ("--fast", "--seed", "43", "--read-len",
                                  "300", "--amp-min", "400", "--amp-max",
                                  "480"))}
# phase 8's streams: the MiSeq 2x300 V3-V4 run, its reverse reads cut to
# a length drawn from R2_CUT by numpy.random.default_rng(R2_CUT_SEED), a
# 2x100 run with N runs and B-cliffs, a pooled run whose POOL_SEGMENT-
# pair segments cross the buckets, and the first OLIMIT_PAIRS of the
# 2x300 run under -O limits
V3V4_PAIRS = 500000
SHORT_PAIRS = 200000
V3V4_ARGS = ("--fast", "--pairs", str(V3V4_PAIRS), "--seed", "43",
             "--read-len", "300", "--amp-min", "400", "--amp-max", "480")
SHORT_ARGS = ("--pairs", str(SHORT_PAIRS), "--seed", "44", "--read-len",
              "100", "--amp-min", "120", "--amp-max", "190",
              "--n-run-rate", "0.1")
R2_CUT = (200, 250)
R2_CUT_SEED = 13
POOL_SEGMENT = 40960
OLIMIT_PAIRS = 100000
OLIMITS = ("200", "700")
SPARSE = ("cand_join",)  # the main path
DENSE = ("counts", "shortlist")  # -k 0 and custom algorithms
LUT = DENSE + ("lut_sums",)  # the pear / rdp_mle library path
KERNELS = SPARSE + LUT
REPLACES = {"cand_join": "pandaseq_tpu/ops/pallas_cand.py:117",
            "counts": "pandaseq_tpu/ops/fused2.py:190",
            "shortlist": "pandaseq_tpu/ops/fused2.py:267",
            "lut_sums": "pandaseq_tpu/ops/fused2.py:218"}
SOURCES = {"cand_join": "pandaseq_tpu_torch/csrc/cand_join.cu",
           "counts": "pandaseq_tpu_torch/csrc/counts.cu",
           "shortlist": "pandaseq_tpu_torch/csrc/shortlist.cu",
           "lut_sums": "pandaseq_tpu_torch/csrc/lut_sums.cu"}
OPS = (2, 4)  # op widths of the row-block checks
# the recorded CUDA-event times (ms) of the kernels that counts
# (num_kmers 0: a per-cell counts kernel) and shortlist (one block per
# pair) replaced, and of lut_sums before its redesign (pear, one thread
# per diagonal), at B=8192 and Lb=O, on REFERENCE_CARD (PERF.md, kernel
# table); each new kernel takes at most MAX_RATIO of them there
REPLACED_MS = {("counts", 256): 0.2102, ("counts", 384): 0.4467,
               ("counts", 512): 0.7617, ("shortlist", 256): 0.1105,
               ("shortlist", 384): 0.1213, ("shortlist", 512): 0.1312,
               ("lut_sums", 256): 0.2579, ("lut_sums", 384): 0.5492,
               ("lut_sums", 512): 0.9368}
REFERENCE_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
MAX_RATIO = 0.5
LUT_ALGOS = ("pear", "rdp_mle")
MESHES = ((2, 2), (2, 1))  # (dp, op) of the mesh runs, all on cuda:0
# the dense kernel is held to its twin on the f32 score columns within
# this many ulp (logf of the card against torch.log of the card); the
# integer columns are exact
SHORTLIST_ULPS = 2
# the four score kinds of the dense path, each with its algorithm
SCORE_ALGOS = {"counts": "simple_bayesian", "ea_util": "ea_util",
               "flash": "flash", "stitch": "stitch"}
# the card's peaks for the bounds (H100 SXM data sheet): device memory;
# float32 outside the tensor cores is 67 T/s with an FMA counted as two
# operations on 128 lanes per SM, so a lone f32 add runs at half that;
# 32-bit integer add, compare, min, max and logic run on 64 lanes per SM
# (NVIDIA's instruction throughput table for compute capability 9.0): a
# quarter of it
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2
INT32_OPS_PER_S = 67e12 / 4
# cycles of the spin kernel that each timed loop waits behind (~10 ms at
# the H100's 1.98 GHz): longer than the host takes to queue the loop
HOLD_CYCLES = 20_000_000
# {(kernel, Lb, O): (bytes, int32 ops, f32 ops)} of the timed call, filled
# where it is timed. Bytes: each input read once and each output written
# once. Operations: what the function needs on these inputs, whatever
# the kernel's design:
# - cand_join: one per emitted forward and per emitted reverse k-mer,
#   and one per candidate found; a join need not sort, nor compare every
#   cell;
# - counts: 3 per 32 live cells (j, i), j + i < O (a 32-bit word holds
#   32 cells of a bit-parallel compare), and at num_kmers > 0 the
#   candidate search's (as cand_join, one per k-mer hit);
# - lut_sums: one f32 add per term after the first of each diagonal;
# - shortlist: one f32 score and one compare per offset.
WORK = {}
# {(kernel, Lb, O): operations of the kernel's own design}, a diagnostic
# beside the bound: cand_join 2 per compare-exchange of its bitonic sort
# over the next power of two >= Lb plus log2 of that per reverse
# emission (its binary search); counts COUNTS_WORD_OPS per 32-cell word
# it walks, plus cand_join's sort and searches at num_kmers > 0;
# shortlist ~10 per offset for its score, 9 for its total-order key and
# the two passes after the rounds (besto32 / best32, n_band), and per
# lane and round of the top SL one compare per slot and 5 shuffle steps
# of 3; lut_sums
# LUT_CELL_OPS per cell it walks (lut_cells: forward pads included, which
# it skips)
DESIGN_OPS = {}
COUNTS_WORD_OPS = 22  # 6 funnel shifts, 14 logic operations, 2 popcounts
# a match test, a select of the half, an address add, the table load
# and the f32 add
LUT_CELL_OPS = 5


def say(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def make_data(prefix, *args):
    """Starts tests/golden/make_data.py; returns (process, fastq pair)."""
    proc = subprocess.Popen([sys.executable,
                             os.path.join(ROOT, "tests", "golden",
                                          "make_data.py"),
                             "--out-prefix", prefix, *args],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    return proc, (prefix + "_1.fastq", prefix + "_2.fastq")


def wait_data(started):
    proc, files = started
    if proc.wait(timeout=600):
        raise SystemExit("make_data.py exited %d" % proc.returncode)
    return files


def cut_r2(files, prefix, lo=R2_CUT[0], hi=R2_CUT[1], seed=R2_CUT_SEED):
    """A run whose reverse reads were cut, as users cut a 2x300 run's R2
    quality tail: each R2 record's sequence and quality cut to a length
    drawn from [lo, hi] by numpy.random.default_rng(seed), in record
    order. Writes prefix_2.fastq; returns (the forward file, it)."""
    import numpy as np
    with open(files[1], "rb") as fh:
        lines = fh.read().split(b"\n")
    n = len(lines) // 4
    cuts = np.random.default_rng(seed).integers(lo, hi + 1, size=n).tolist()
    for i, cut in enumerate(cuts):
        lines[4 * i + 1] = lines[4 * i + 1][:cut]
        lines[4 * i + 3] = lines[4 * i + 3][:cut]
    dest = prefix + "_2.fastq"
    with open(dest, "wb") as fh:
        fh.write(b"\n".join(lines))
    return files[0], dest


def pool_streams(parts, prefix):
    """A pooled run: the records [start, start + n) of each (files,
    start, n) of ``parts``, in order, written to prefix_[12].fastq."""
    out = []
    for i in (0, 1):
        dest = "%s_%d.fastq" % (prefix, i + 1)
        with open(dest, "w") as dst:
            for files, start, n in parts:
                with open(files[i]) as src:
                    dst.writelines(itertools.islice(src, 4 * start,
                                                    4 * (start + n)))
        out.append(dest)
    return tuple(out)


def batch_buckets(files, batch, L=512, step=128):
    """The (Lb, O) shape bucket of each ``batch``-pair batch of a FASTQ
    pair under the engine's rule with no -O and no primers, read from
    the records' lengths: O the step-rounded longest min(flen, rlen), Lb
    the step-rounded longest read but at least O, both at most L."""
    def up(n):
        return -(-max(n, 1) // step) * step

    out = []
    with open(files[0]) as f1, open(files[1]) as f2:
        while True:
            lens = []
            for _ in range(batch):
                rec = [(f1.readline(), f2.readline()) for _ in range(4)]
                if not rec[0][0]:
                    break
                lens.append((len(rec[1][0].rstrip("\r\n")),
                             len(rec[1][1].rstrip("\r\n"))))
            if not lens:
                return out
            O = min(L, up(max(min(a, b) for a, b in lens)))
            out.append((min(L, max(up(max(max(a, b) for a, b in lens)), O)),
                        O))


def predict_steps(buckets, group):
    """Device steps of a grouped stream under the engine's flush rule
    (assembler.py _dispatch_stream): a group goes to the card when it
    holds ``group`` batches, when the next batch's bucket differs, and at
    the stream's end."""
    steps = held = 0
    for i, key in enumerate(buckets):
        if held and key != buckets[i - 1]:
            steps, held = steps + 1, 0
        held += 1
        if held == group:
            steps, held = steps + 1, 0
    return steps + (held > 0)


def exact(got, want, what):
    """Max |got - want| over equal-shaped integer tensors; exits unless
    it is 0 (the kernels compute integers: the tolerance is 0)."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise SystemExit("%s: shape/dtype %s %s vs %s %s" % (
            what, tuple(got.shape), got.dtype, tuple(want.shape),
            want.dtype))
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err:
        bad = int((got != want).any(dim=1).sum())
        raise SystemExit("%s: kernel != plain on %d rows (max abs err %d)"
                         % (what, bad, err))
    return err


def shortlist_err(got, want, what):
    """The shortlist against its twin: integer columns exact, f32 score
    columns within SHORTLIST_ULPS; returns (max abs err of the scores,
    max ulp)."""
    import torch
    f32 = list(range(SL, 2 * SL)) + [2 * SL + 3]
    ints = [c for c in range(2 * SL + 4) if c not in f32]
    exact(got[:, ints], want[:, ints], what + " integer columns")
    ulp = int((got[:, f32].to(torch.int64)
               - want[:, f32].to(torch.int64)).abs().max())
    if ulp > SHORTLIST_ULPS:
        raise SystemExit("%s: f32 scores %d ulp from the twin" % (what, ulp))
    err = float((got[:, f32].view(torch.float32).double()
                 - want[:, f32].view(torch.float32).double()).abs().max())
    return err, ulp


def cuda_ms(fn, reps):
    """Mean CUDA-event ms of ``reps`` calls of ``fn``, queued behind a
    spin kernel of HOLD_CYCLES: the host queues the calls while the
    stream waits, so the events time the card's work and not the rate at
    which a busy host launches it."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(plain, kernel):
    """(kernel ms, plain ms), each the mean of two runs taken in turns
    plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, 3)
    k1 = cuda_ms(kernel, 20)
    k2 = cuda_ms(kernel, 20)
    p2 = cuda_ms(plain, 3)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(name, Lb, O):
    """(bound ms, "bytes" or "operations") of the timed call (WORK)."""
    nbytes, int_ops, f32_ops = WORK[(name, Lb, O)]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(int_ops / INT32_OPS_PER_S, f32_ops / F32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# what each timed call runs, beside its time
TIMED_AS = {"cand_join": "num_kmers 2, list", "counts": "num_kmers 0",
            "counts k=2": "num_kmers 2",
            "counts rows": "num_kmers 0, rows [0, O/2)",
            "shortlist": "counts kind",
            "lut_sums": "pear"}


def shape(Lb, O):
    """A row's shape as the lines name it: "Lb=O=256" or "Lb=384 O=256"."""
    return "Lb=O=%d" % Lb if Lb == O else "Lb=%d O=%d" % (Lb, O)


def say_times(times, names, Lb, O):
    for name in names:
        key = (name, Lb, O)
        ms, pms = times[key]
        bms, by = bound(*key)
        design = DESIGN_OPS.get(key)
        say("time %s (%s) B=%d %s: kernel %.4f ms, plain %.4f ms, "
            "bound %.5f ms (%s: %d B, %d int32 + %d f32 ops needed%s), "
            "kernel at %.2f%% of the bound (CUDA events)"
            % (name, TIMED_AS[name], B, shape(Lb, O), ms, pms, bms, by,
               *WORK[key],
               "" if design is None else "; design ops %d" % design,
               100 * bms / ms))


def against_replaced(times, names, Lb, card):
    """The kernels ``names`` against the replaced kernels' times on
    REFERENCE_CARD: exits if one takes more than MAX_RATIO of it; on
    another card prints "not compared"."""
    for name in names:
        ms = times[(name, Lb, Lb)][0]
        old = REPLACED_MS[(name, Lb)]
        if card != REFERENCE_CARD:
            say("%s Lb=O=%d: %.4f ms; the replaced kernel's %.4f ms was "
                "taken on %s, this card is %s: not compared"
                % (name, Lb, ms, old, REFERENCE_CARD, card))
            continue
        say("%s Lb=O=%d: %.4f ms against the replaced kernel's %.4f ms on "
            "%s: ratio %.3f (limit %.1f)"
            % (name, Lb, ms, old, card, ms / old, MAX_RATIO))
        if ms > MAX_RATIO * old:
            raise SystemExit("%s at Lb=O=%d takes %.4f ms, more than %.1f of "
                             "the replaced kernel's %.4f ms"
                             % (name, Lb, ms, MAX_RATIO, old))


def row_blocks(O, op):
    Oj = O // op
    return [(j0, Oj) for j0 in range(0, O, Oj)]


def live_cells(O):
    """Cells (j, i), j + i < O, of the plane, summed over the pairs."""
    return B * O * (O + 1) // 2


def lut_cells(O):
    """Cells the lut_sums kernel walks over the pairs: a thread's block
    of R diagonals at t0 (R = 4 below O = 512, else 8: csrc/lut_sums.cu)
    walks rows 0 .. t0 + R - 1, R at a time, for each of its R
    diagonals."""
    R = 4 if O < 512 else 8
    return B * sum((t0 // R + 1) * R * R for t0 in range(0, O, R))


def counts_words(O):
    """32-cell words the counts kernel walks over the pairs: diagonal t
    spans words 0 .. t // 32."""
    return B * sum(t // 32 + 1 for t in range(O))


def emitted(lens, L):
    """k-mers emitted over the batch by reads of ``lens`` in a frame of
    L: positions 0 .. min(len, L) - 9 forward (the gate p <= min(flen -
    9, L - 9)), 8 .. min(len, L) - 1 reverse; the same count."""
    import torch
    return int(torch.clamp(torch.clamp(lens, max=L) - 8, min=0).sum())


def join_needed_ops(fl, rlen, Lb, O, lst):
    """The candidate search's operations on this batch (see WORK): the
    emitted k-mers of both reads and the candidates of the list [B,
    C+2] (its count column)."""
    return emitted(fl, Lb) + emitted(rlen, O) + int(lst[:, 0].sum())


def join_ops(Lb, rlen, O):
    """cand_join's design operations on this batch (see DESIGN_OPS)."""
    lpad = 1 << (Lb - 1).bit_length()
    lg = lpad.bit_length() - 1
    compare_exchanges = lpad // 2 * lg * (lg + 1) // 2
    return 2 * compare_exchanges * B + lg * emitted(rlen, O)


def join_check(plane, fl, rl, Lb, O, k, nt, what, errs):
    """cand_join against plain_candidates_join, list and mask, exactly;
    returns the mask and list."""
    import torch

    from pandaseq_tpu_torch.ops import cand, fused2
    args = (plane, fl, rl, Lb, O, k)
    out = {}
    for mode in ("list", "mask"):
        out[mode] = cand.candidates_join(*args, mode, C, nt=nt)
        errs["cand_join"] = max(errs["cand_join"], exact(
            out[mode], fused2.plain_candidates_join(*args, mode, C, nt=nt),
            "%s cand_join %s" % (what, mode)))
    torch.cuda.synchronize()
    return out["mask"], out["list"]


def sparse_kernels(Lb, O, batch, rng, errs, times, with_n=False):
    """cand_join (packed plane) against its twin on generated reads and
    random planes, and against native.cand_mask on the reads' rows
    without N (all of them unless ``with_n``: the engine sends rows with
    N to the host twin, as this plane has no N); timed on the reads."""
    import numpy as np
    import torch

    from pandaseq_tpu_torch.io import native
    from pandaseq_tpu_torch.ops import cand, fused2

    dev = torch.device(DEVICE)
    plane_r, hasN = native.pack4(batch, Lb)
    if (hasN.any() and not with_n) or len(batch.sids) != B:
        raise SystemExit("generated batch: %d rows, %d with N"
                         % (len(batch.sids), int(hasN.sum())))
    clean = torch.from_numpy(~hasN)
    # random planes: a quarter poly-C, a quarter over a 2-code
    # alphabet (deep k-mer runs: rank drops, count > C lists)
    plane_x = rng.integers(-128, 128, size=(B, Lb // 2), dtype=np.int8)
    plane_x[:B // 4] = 0b01010101
    plane_x[B // 4:B // 2] = rng.choice(
        np.array([0, 0b01010101], np.int8), size=(B // 4, Lb // 2))
    cases = [("reads", plane_r, batch.flen, batch.rlen),
             ("random", plane_x,
              rng.integers(0, Lb + 1, size=B).astype(np.int32),
              rng.integers(0, Lb + 1, size=B).astype(np.int32))]
    for tag, plane_np, fl_np, rl_np in cases:
        plane = torch.from_numpy(plane_np).to(dev)
        fl = torch.from_numpy(np.ascontiguousarray(fl_np, np.int32)).to(dev)
        rlen = torch.from_numpy(np.ascontiguousarray(
            rl_np, np.int32)).to(dev)
        for k in (0, 1, 2, 3):
            what = "%s k=%d %s" % (shape(Lb, O), k, tag)
            mask, lst = join_check(plane, fl, rlen, Lb, O, k, False, what,
                                   errs)
            over = int((lst[:, 0] > C).sum())
            if tag == "reads" and k:
                host = torch.from_numpy(native.cand_mask(
                    batch, np.arange(B, dtype=np.int64), k, O))
                exact(mask.cpu()[clean], host[clean],
                      what + " cand_join vs cand_mask")
            say("%s: cand_join == plain%s (list, mask), %d rows with "
                "candidates, %d with count > %d"
                % (what, " == native.cand_mask on the %d rows without N"
                   % int(clean.sum()) if tag == "reads" and k else "",
                   int((lst[:, 0] > 0).sum()), over, C))
        if tag == "reads":
            times[("cand_join", Lb, O)] = paired_ms(
                lambda: fused2.plain_candidates_join(plane, fl, rlen, Lb, O,
                                                     2, "list", C),
                lambda: cand.candidates_join(plane, fl, rlen, Lb, O, 2,
                                             "list", C))
            need = join_needed_ops(fl, rlen, Lb, O, cand.candidates_join(
                plane, fl, rlen, Lb, O, 2, "list", C))
            WORK[("cand_join", Lb, O)] = (
                B * (Lb // 2 + 8 + 2 * (C + 2)), need, 0)
            DESIGN_OPS[("cand_join", Lb, O)] = join_ops(Lb, rlen, O)
            say_times(times, SPARSE, Lb, O)


def _score_params():
    """{score kind: (pmatch, pmismatch)} as the engine passes them."""
    from pandaseq_tpu_torch import oracle
    from pandaseq_tpu_torch.assembler import BatchAssembler
    out = {}
    for kind, name in SCORE_ALGOS.items():
        cfg = oracle.OracleConfig()
        cfg.algorithm = oracle.make_algorithm(name, None)
        asm = BatchAssembler(cfg, device=DEVICE)
        if asm._algo_kind != kind:
            raise SystemExit("%s scores as %s" % (name, asm._algo_kind))
        out[kind] = (asm._pmatch, asm._pmismatch)
    return out


def _nt_random(rng, Lb):
    """Random nibble planes: an eighth poly-C (every k-mer equal), N
    runs, degenerate codes, zero tails past random lengths."""
    import numpy as np
    codes = np.array([1, 2, 4, 8, 1, 2, 4, 8, 15, 5, 10, 3], np.uint8)
    fwd = codes[rng.integers(0, len(codes), (B, Lb))]
    rev = codes[rng.integers(0, len(codes), (B, Lb))]
    fwd[:B // 8] = 2
    rev[:B // 8] = 2
    fwd[B // 8:B // 4, 20:40] = 15
    rev[B // 4:3 * B // 8, 50:60] = 15
    flen = rng.integers(0, Lb + 1, B).astype(np.int32)
    rlen = rng.integers(0, Lb + 1, B).astype(np.int32)
    pos = np.arange(Lb)[None, :]
    fwd[pos >= flen[:, None]] = 0
    rev[pos >= rlen[:, None]] = 0
    return (fwd | (rev << 4)).view(np.int8), flen, rlen


def dense_kernels(Lb, O, batch, rng, params, errs, times, card):
    """counts (full plane and row blocks) and shortlist against their
    twins, counts' k-mer hits against cand_join's mask, and
    assemble_candidates_nt against native.cand_mask; counts and
    shortlist timed on the reads and, at the replaced kernels' shapes
    (Lb = O in SHAPES), held to their times."""
    import numpy as np
    import torch

    from pandaseq_tpu_torch import tables
    from pandaseq_tpu_torch.io import native
    from pandaseq_tpu_torch.ops import dense, fused2

    dev = torch.device(DEVICE)
    nn = float(tables.QUAL_NN_SIMPLE_BAYESIAN)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    nt_r = batch.nt_packed()[:, :Lb]
    nt_x, fl_x, rl_x = _nt_random(rng, Lb)
    zeros = np.zeros(B, np.int32)
    cases = [("reads", nt_r, batch.flen, batch.rlen, zeros, zeros, 0),
             ("random", nt_x, fl_x, rl_x,
              rng.integers(0, 4, B).astype(np.int32),
              rng.integers(0, 4, B).astype(np.int32), O - 56)]
    for tag, nt_np, fl_np, rl_np, fo_np, ro_np, maxoverlap in cases:
        nt, fl, rl, fo, ro = map(t, (nt_np, fl_np, rl_np, fo_np, ro_np))
        for k in (0, 1, 2, 3):
            what = "%s k=%d %s" % (shape(Lb, O), k, tag)
            got = dense.counts(nt, fl, rl, Lb, O, k)
            want = fused2.plain_counts(nt, fl, rl, Lb, O, k)
            for g, w, name in zip(got, want, ("m", "unk", "candc")):
                errs["counts"] = max(errs["counts"],
                                     exact(g, w, "%s %s" % (what, name)))
            counts_blocks(nt, fl, rl, Lb, O, k, got, what, errs)
            mask, _ = join_check(nt, fl, rl, Lb, O, k, True, what + " nt",
                                 errs)
            exact(fused2.pack_bits16(got[2] != 0, O), mask,
                  what + " counts' k-mer hits vs cand_join's mask")
            bands = []
            for kind, (pm, pmm) in params.items():
                kw = dict(O=O, SL=SL, minoverlap=2, maxoverlap=maxoverlap,
                          algo_kind=kind, pmatch=pm, pmismatch=pmm, nn=nn,
                          band=fused2.BAND_COUNTS)
                sl = dense.shortlist(*got, fl, rl, fo, ro, **kw)
                err, ulp = shortlist_err(
                    sl, fused2.plain_shortlist(*want, fl, rl, fo, ro, **kw),
                    "%s %s" % (what, kind))
                errs["shortlist"] = max(errs["shortlist"], err)
                errs["shortlist_ulp"] = max(errs["shortlist_ulp"], ulp)
                bands.append(int((sl[:, 2 * SL + 2] > SL).sum()))
            say("%s: counts == plain (row blocks of op %s too, with their "
                "own and the mesh's hit rows; k-mer hits == cand_join's "
                "mask); shortlist of %s == plain, rows with "
                "n_band > %d: %s" % (what, "/".join(map(str, OPS)),
                                     "/".join(params), SL, bands))
        if tag == "reads":
            rows = np.arange(B, dtype=np.int64)
            for k in (1, 2, 3):
                mask = fused2.assemble_candidates_nt(nt, fl, rl, L=Lb, O=O,
                                                     num_kmers=k)
                exact(mask.cpu(), torch.from_numpy(
                    native.cand_mask(batch, rows, k, O)),
                    "%s k=%d assemble_candidates_nt vs cand_mask"
                    % (shape(Lb, O), k))
            say("%s: assemble_candidates_nt == native.cand_mask at "
                "k=1,2,3 (%d rows with N)" % (shape(Lb, O), int(
                    ((batch.nt_packed()[:, :Lb].view(np.uint8) & 0x0F)
                     == 0x0F).any(axis=1).sum())))
            got = dense.counts(nt, fl, rl, Lb, O, 0)
            pm, pmm = params["counts"]
            kw = dict(O=O, SL=SL, minoverlap=2, maxoverlap=0,
                      algo_kind="counts", pmatch=pm, pmismatch=pmm, nn=nn,
                      band=fused2.BAND_COUNTS)
            for name, k in (("counts", 0), ("counts k=2", 2)):
                key = (name, Lb, O)
                times[key] = paired_ms(
                    lambda: fused2.plain_counts(nt, fl, rl, Lb, O, k),
                    lambda: dense.counts(nt, fl, rl, Lb, O, k))
                nbytes = B * (Lb + 8 + 12 * O)
                ops = 3 * live_cells(O) // 32
                DESIGN_OPS[key] = COUNTS_WORD_OPS * counts_words(O)
                if k:
                    hits = int(dense.counts(nt, fl, rl, Lb, O, k)[2].sum())
                    ops += emitted(fl, Lb) + emitted(rl, O) + hits
                    DESIGN_OPS[key] += join_ops(Lb, rl, O)
                WORK[key] = (nbytes, ops, 0)
            # the row block of one op cell of a (dp, 2) mesh (K10): it
            # reads the whole row and writes all O diagonals
            times[("counts rows", Lb, O)] = paired_ms(
                lambda: fused2.plain_counts(nt, fl, rl, Lb, O, 0, 0, O // 2),
                lambda: dense.counts(nt, fl, rl, Lb, O, 0, 0, O // 2))
            half = O // 2
            WORK[("counts rows", Lb, O)] = (
                B * (Lb + 8 + 12 * O),
                3 * B * (half * O - half * (half - 1) // 2) // 32, 0)
            times[("shortlist", Lb, O)] = paired_ms(
                lambda: fused2.plain_shortlist(*got, fl, rl, fo, ro, **kw),
                lambda: dense.shortlist(*got, fl, rl, fo, ro, **kw))
            WORK[("shortlist", Lb, O)] = (
                B * (12 * O + 16 + 4 * (2 * SL + 4)), B * O, B * O)
            slots = -(-O // 32)
            DESIGN_OPS[("shortlist", Lb, O)] = B * (19 * O + 32 * SL * (
                slots + 15))
            say_times(times, ("counts", "counts k=2", "counts rows",
                              "shortlist"), Lb, O)
            if Lb == O and Lb in SHAPES:
                against_replaced(times, DENSE, Lb, card)


def shortlist_edges(O, params, errs):
    """shortlist of every score kind against its twin on the edge rows of
    tests/shortlist_rows.py (all -inf, -0.0 beside +0.0, equal scores
    across lanes and words, fewer finite scores than SL, a stitch wrap),
    with maxoverlap 0 and 150; on the zero row, the LUT kind also against
    the JAX package's answer: top_k's order (+0.0 offsets, then -0.0 ones,
    each ascending), argmax's besto32 (the first zero) and best32 with the
    last zero's sign."""
    import numpy as np
    import torch

    from pandaseq_tpu_torch import tables
    from pandaseq_tpu_torch.ops import dense, fused2
    from tests.shortlist_rows import ZERO_TIE_ROW, ZEROS, edge_rows

    zeros = sorted(ZEROS)
    tie_order = ([x + 1 for x in zeros if not np.signbit(ZEROS[x])]
                 + [x + 1 for x in zeros if np.signbit(ZEROS[x])])
    tie_best = int(np.float32(ZEROS[zeros[-1]]).view(np.int32))

    rows = {k: torch.from_numpy(v).to(DEVICE)
            for k, v in edge_rows(np.random.default_rng(O), O).items()}
    args = [rows[k] for k in ("m", "unk", "candc", "flen", "rlen", "fo",
                              "ro")]
    kinds = dict(params, pear=(0.0, 0.0))
    for kind, (pm, pmm) in kinds.items():
        lut = kind == "pear"
        for maxoverlap in (0, 150):
            kw = dict(O=O, SL=SL, minoverlap=3, maxoverlap=maxoverlap,
                      algo_kind=kind, pmatch=pm, pmismatch=pmm,
                      nn=float(tables.QUAL_NN_SIMPLE_BAYESIAN),
                      band=fused2.BAND_LUT if lut else fused2.BAND_COUNTS,
                      lutsum=rows["lutsum"] if lut else None)
            got = dense.shortlist(*args, **kw)
            err, ulp = shortlist_err(got, fused2.plain_shortlist(
                *args, **kw), "O=%d %s edge rows" % (O, kind))
            errs["shortlist"] = max(errs["shortlist"], err)
            errs["shortlist_ulp"] = max(errs["shortlist_ulp"], ulp)
            row = got[ZERO_TIE_ROW].cpu().tolist()
            if lut and ([x & 1023 for x in row[:len(tie_order)]] != tie_order
                        or row[2 * SL] != zeros[0] + 1
                        or row[2 * SL + 3] != tie_best):
                raise SystemExit("O=%d: the -0.0 / +0.0 row ships %s, "
                                 "besto32 %d, best32 bits %#x; JAX: %s, %d, "
                                 "%#x" % (O, [x & 1023 for x in row[:SL]],
                                          row[2 * SL], row[2 * SL + 3] &
                                          0xFFFFFFFF, tie_order, zeros[0] + 1,
                                          tie_best & 0xFFFFFFFF))
    say("O=%d: shortlist == plain on the edge rows for %s; the -0.0 / "
        "+0.0 row in the JAX package's order %s" % (O, "/".join(kinds),
                                                   tie_order))


def counts_blocks(nt, fl, rl, Lb, O, k, full, what, errs):
    """counts over the row blocks of op 2 and 4 against the twin, and
    summed against the full-plane kernel, exactly: with the k-mer hits
    of each block's rows, and with the mesh's hit rows (every row in the
    first block, none in the others)."""
    import torch

    from pandaseq_tpu_torch.ops import dense, fused2
    for op in OPS:
        for mesh_hits in (False, True):
            sums = [torch.zeros_like(x) for x in full]
            for j0, Oj in row_blocks(O, op):
                hits = (0, O if j0 == 0 else 0) if mesh_hits else None
                got = dense.counts(nt, fl, rl, Lb, O, k, j0, Oj, hits)
                want = fused2.plain_counts(nt, fl, rl, Lb, O, k, j0, Oj,
                                           hits)
                for acc, g, w in zip(sums, got, want):
                    errs["counts"] = max(errs["counts"], exact(
                        g, w, "%s counts rows [%d, %d) hit rows %s"
                        % (what, j0, j0 + Oj, hits)))
                    acc += g
            for acc, f in zip(sums, full):
                exact(acc, f, "%s counts op=%d sum vs the full plane"
                      % (what, op))


def _lut_params():
    """{kind: (lut_match, lut_mismatch, nn_term)} as the engine builds
    them (f64 tables)."""
    from pandaseq_tpu_torch import oracle
    from pandaseq_tpu_torch.assembler import BatchAssembler
    out = {}
    for name in LUT_ALGOS:
        cfg = oracle.OracleConfig()
        cfg.algorithm = oracle.make_algorithm(name, None)
        asm = BatchAssembler(cfg, device=DEVICE)
        out[name] = (asm._lut_m, asm._lut_mm, asm._nn_term)
    return out


def ulps(got, want, what):
    """Exits unless two f32 tensors are equal bit for bit; returns 0."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise SystemExit("%s: shape/dtype %s %s vs %s %s" % (
            what, tuple(got.shape), got.dtype, tuple(want.shape),
            want.dtype))
    diff = (got.view(torch.int32).to(torch.int64)
            - want.view(torch.int32).to(torch.int64)).abs()
    if int(diff.max()):
        raise SystemExit("%s: lut_sums != plain on %d values, up to %d ulp"
                         % (what, int((diff != 0).sum()), int(diff.max())))
    return 0


def lut_kernels(Lb, batch, rng, luts, errs, times, card):
    """lut_sums against its twin (full plane and row blocks, bit for bit)
    and the LUT kind of the shortlist against its twin, on generated
    reads with N and their qual planes, on random planes and on the edge
    rows of tests/lut_rows.py; lut_sums timed on the reads and held to
    its time before the redesign."""
    import numpy as np
    import torch

    from pandaseq_tpu_torch.ops import dense, fused2
    from tests.lut_rows import lut_edge_rows

    dev = torch.device(DEVICE)
    O = Lb
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    nt_x, fl_x, rl_x = _nt_random(rng, Lb)
    fwd_e, rev_e, fq_e, rq_e, fl_e, rl_e = lut_edge_rows(rng, B, Lb)
    cases = [("reads", batch.nt_packed()[:, :Lb], batch.fwd_q[:, :Lb],
              batch.rev_q[:, :Lb], batch.flen, batch.rlen),
             ("random", nt_x, rng.integers(-3, 50, (B, Lb)).astype(np.int8),
              rng.integers(-3, 50, (B, Lb)).astype(np.int8), fl_x, rl_x),
             ("edge rows", (fwd_e | (rev_e << 4)).view(np.int8), fq_e, rq_e,
              fl_e, rl_e)]
    zeros = t(np.zeros(B, np.int32))
    for tag, *arrays in cases:
        nt, fq, rq, fl, rl = map(t, arrays)
        counts = dense.counts(nt, fl, rl, Lb, O, 2)
        for kind, (tm64, tmm64, nn_term) in luts.items():
            what = "Lb=O=%d %s %s" % (Lb, kind, tag)
            tm, tmm = (fused2.lut_table(x, dev) for x in (tm64, tmm64))
            args = (nt, fq, rq, fl, rl, O, kind, tm, tmm, nn_term)
            full = dense.lut_sums(*args)
            ulps(full, fused2.plain_lut_sums(*args), what)
            for op in OPS:
                for j0, Oj in row_blocks(O, op):
                    ulps(dense.lut_sums(*args, j0, Oj),
                         fused2.plain_lut_sums(*args, j0, Oj),
                         "%s rows [%d, %d)" % (what, j0, j0 + Oj))
            kw = dict(O=O, SL=SL, minoverlap=2, maxoverlap=0,
                      algo_kind=kind, pmatch=0.0, pmismatch=0.0, nn=0.0,
                      band=fused2.BAND_LUT, lutsum=full)
            err, ulp = shortlist_err(
                dense.shortlist(*counts, fl, rl, zeros, zeros, **kw),
                fused2.plain_shortlist(*counts, fl, rl, zeros, zeros, **kw),
                what + " shortlist")
            errs["shortlist"] = max(errs["shortlist"], err)
            errs["shortlist_ulp"] = max(errs["shortlist_ulp"], ulp)
            say("%s: lut_sums == plain (0 ulp) over the full plane and the "
                "row blocks of op %s; LUT shortlist == plain"
                % (what, "/".join(map(str, OPS))))
        if tag == "reads":
            tm, tmm = (fused2.lut_table(x, dev) for x in luts["pear"][:2])
            args = (nt, fq, rq, fl, rl, O, "pear", tm, tmm,
                    luts["pear"][2])
            times[("lut_sums", Lb, O)] = paired_ms(
                lambda: fused2.plain_lut_sums(*args),
                lambda: dense.lut_sums(*args))
            WORK[("lut_sums", Lb, O)] = (B * (3 * Lb + 8 + 4 * O), 0,
                                         live_cells(O) - B * O)
            DESIGN_OPS[("lut_sums", Lb, O)] = LUT_CELL_OPS * lut_cells(O)
            say_times(times, ("lut_sums",), Lb, O)
            against_replaced(times, ("lut_sums",), Lb, card)


def phase_kernels(tmp, errs, card):
    """Phase 2: every kernel == its plain twin on the card, at Lb = O in
    SHAPES and at the rows of SHAPE_ROWS; returns ({(kernel, Lb, O): (ms,
    plain_ms)}, the Lb=256 batch with N, the LUT parameters)."""
    import numpy as np

    from pandaseq_tpu_torch.assembler import make_batch
    from pandaseq_tpu_torch.io import fastq as fq

    rng = np.random.default_rng(11)
    started = {}
    for Lb in SHAPES:
        rl, amin, amax = READ_SPEC[Lb]
        spec = ("--pairs", str(B), "--seed", str(Lb), "--read-len", rl,
                "--amp-min", amin, "--amp-max", amax)
        started[Lb] = (
            make_data(os.path.join(tmp, "k%d" % Lb), "--fast", *spec),
            make_data(os.path.join(tmp, "n%d" % Lb), *spec))
    for (Lb, O), (_, spec) in SHAPE_ROWS.items():
        started[(Lb, O)] = make_data(os.path.join(tmp, "r%d_%d" % (Lb, O)),
                                     "--pairs", str(B), *spec)
    params = _score_params()
    luts = _lut_params()
    times = {}
    for Lb in SHAPES:
        fast, with_n = (wait_data(s) for s in started[Lb])
        sparse_kernels(Lb, Lb, make_batch(list(fq.read_pairs(*fast)), Lb),
                       rng, errs, times)
        batch_n = make_batch(list(fq.read_pairs(*with_n)), Lb)
        dense_kernels(Lb, Lb, batch_n, rng, params, errs, times, card)
        lut_kernels(Lb, batch_n, rng, luts, errs, times, card)
        if Lb == 256:
            batch_256 = batch_n
    for (Lb, O), (reads, _) in SHAPE_ROWS.items():
        files = wait_data(started[(Lb, O)])
        if Lb != O:
            files = cut_r2(files, os.path.join(tmp, "r%d_%d_cut" % (Lb, O)))
        batch = make_batch(list(fq.read_pairs(*files)), Lb)
        bucket = batch_buckets(files, B)
        if bucket != [(Lb, O)]:
            raise SystemExit("%s: the engine's bucket is %s, not (%d, %d)"
                             % (reads, bucket, Lb, O))
        say("%s: %s reads, the bucket of the engine's rule" % (
            shape(Lb, O), reads))
        sparse_kernels(Lb, O, batch, rng, errs, times, with_n=True)
        dense_kernels(Lb, O, batch, rng, params, errs, times, card)
    for O in sorted({O for _, O in SHAPE_ROWS} | set(SHAPES)):
        shortlist_edges(O, params, errs)
    return times, batch_256, luts


def _norm_log(path):
    """(the log's line sequence with the volatile lines masked, as
    tests/test_cli.py test_stderr_line_sequence_parity does; the INFO
    ENGINE line)."""
    out = []
    engine = None
    with open(path, errors="replace") as fh:
        for ln in fh.read().splitlines():
            if ln.startswith("INFO\tENGINE"):
                engine = ln
            ln = re.sub(r"0x[0-9a-f]+:\d+\t", "", ln)
            ln = re.sub(r"STAT\tTIME\t.*", "STAT\tTIME\t<t>", ln)
            ln = re.sub(r"STAT\tELAPSED\t\d+", "STAT\tELAPSED\t<e>", ln)
            if ln.startswith(("INFO\tVER", "INFO\tUNAME", "ARG[",
                              "INFO\tENGINE")):
                continue
            out.append(ln)
    return out, engine


def run_cli(f1, f2, out_dir, engine, tag, extra=()):
    """The port CLI on one engine: "cuda" is the default a user gets (no
    engine variable set), "host" pins the native host engine
    and "auto" asks the probe; returns (seconds, reads, launch counts,
    fasta path, log lines, INFO ENGINE line). The launch counts are set
    to 0 just before the run and read just after it."""
    from pandaseq_tpu_torch.cli.main import main as cli_main
    from pandaseq_tpu_torch.ops import cand

    fa = os.path.join(out_dir, tag + ".fa")
    log = os.path.join(out_dir, tag + ".log")
    os.environ.pop("PANDASEQ_TPU_HOST", None)
    _env("PANDASEQ_TPU_ENGINE", None if engine == "cuda" else engine)
    cand.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli_main(["-f", f1, "-r", f2, "-w", fa, "-g", log, *extra])
    dt = time.perf_counter() - t0
    counts = cand.launch_counts()
    if rc != 0:
        raise SystemExit("port CLI (%s) exited %d" % (engine, rc))
    lines, engine_line = _norm_log(log)
    if engine == "cuda" and \
            engine_line != "INFO\tENGINE\t%s (default)" % DEVICE:
        raise SystemExit("the default CLI run logged %r, expected INFO "
                         "ENGINE %s (default)" % (engine_line, DEVICE))
    reads = [int(m.group(1)) for m in
             (re.match(r"STAT\tREADS\t(\d+)$", ln) for ln in lines) if m]
    return dt, reads[-1], counts, fa, lines, engine_line


def expect_counts(path, n_batches):
    """Each kernel of the run's path once per batch, the others never."""
    return {name: n_batches if name in path else 0 for name in KERNELS}


def compare_engines(label, f1, f2, sub, order, path, card, extra=(),
                    keep=False):
    """Runs the CLI in the given engine order; every run's FASTA and
    log equal the first's. Returns the first cuda run's launch counts
    (and, with ``keep``, the path of the FASTA all runs gave)."""
    secs = {"cuda": [], "host": []}
    ref = None
    main_counts = None
    for i, engine in enumerate(order):
        dt, reads, counts, fa, log, _ = run_cli(
            f1, f2, sub, engine, "%s%d" % (engine, i), extra)
        n_batches = math.ceil(reads / CLI_BATCH)
        want = expect_counts(path if engine == "cuda" else (), n_batches)
        if counts != want:
            raise SystemExit("%s: %s run launched %s, expected %s"
                             % (label, engine, counts, want))
        if engine == "cuda" and main_counts is None:
            main_counts = counts
        if ref is None:
            ref = (fa, log, reads)
            if os.path.getsize(fa) == 0:
                raise SystemExit("%s: empty FASTA" % label)
        else:
            if not filecmp.cmp(ref[0], fa, shallow=False):
                raise SystemExit("%s: %s FASTA differs from %s's"
                                 % (label, engine, order[0]))
            if log != ref[1]:
                raise SystemExit("%s: %s STAT/log line sequence differs "
                                 "from %s's" % (label, engine, order[0]))
            os.remove(fa)
        secs[engine].append(dt)
    stats = [ln for ln in ref[1] if ln.startswith("STAT\t")
             and not ln.startswith(("STAT\tTIME", "STAT\tELAPSED",
                                    "STAT\tOVERLAPS"))][-6:]
    say("%s: %d pairs, FASTA identical over %d runs (%d bytes), STAT "
        "equal: %s" % (label, ref[2], len(order), os.path.getsize(ref[0]),
                       ", ".join(s.split("\t", 1)[1].replace("\t", "=")
                                 for s in stats)))
    if keep:  # under its own name: a later run reuses the run tags
        kept = os.path.join(sub, re.sub(r"\W+", "_", label) + ".fa")
        os.replace(ref[0], kept)
    else:
        os.remove(ref[0])
    rate = {e: ref[2] * len(t) / sum(t) for e, t in secs.items()}
    say("%s: each cuda run logged INFO ENGINE %s (default) and launched %s "
        "(%d batches); cuda %.1f pairs/s (runs %s s), host %.1f pairs/s "
        "(runs %s s) on %s"
        % (label, DEVICE, "/".join(path) + " once per batch" if path
           else "no kernel", math.ceil(ref[2] / CLI_BATCH),
           rate["cuda"], ", ".join("%.3f" % t for t in secs["cuda"]),
           rate["host"], ", ".join("%.3f" % t for t in secs["host"]),
           card))
    return (main_counts, kept) if keep else main_counts


def phase_probe(f1, f2, tmp):
    """The measured engine probe on an empty cache: one run under
    PANDASEQ_TPU_ENGINE=auto. Returns the INFO ENGINE line."""
    from pandaseq_tpu_torch import runtime

    sub = os.path.join(tmp, "probe")
    os.makedirs(sub)
    os.environ["PANDASEQ_TPU_CACHE"] = sub
    try:
        _, reads, counts, _, _, line = run_cli(f1, f2, sub, "auto", "auto")
    finally:
        os.environ.pop("PANDASEQ_TPU_CACHE")
        os.environ.pop("PANDASEQ_TPU_ENGINE")
    m = re.match(r"INFO\tENGINE\t(cuda|host) \(probe: host ([\d.]+) ms, "
                 r"device ([\d.]+) ms\)$", line or "")
    if m is None:
        raise SystemExit("auto run: no probe on the INFO ENGINE line "
                         "(%r)" % line)
    n_batches = math.ceil(reads / CLI_BATCH)
    want = expect_counts(SPARSE if m.group(1) == "cuda" else (), n_batches)
    for name in SPARSE:  # the probe's own device-side runs
        want[name] += runtime.PROBE_RUNS
    if counts != want:
        raise SystemExit("auto run launched %s, expected %s (the "
                         "probe's %d runs included)"
                         % (counts, want, runtime.PROBE_RUNS))
    if not os.path.exists(os.path.join(sub, runtime.PROBE_CACHE)):
        raise SystemExit("the probe wrote no cache entry")
    say("probe: %r; the run launched %s of which %d of each sparse kernel "
        "were the probe's" % (line, counts, runtime.PROBE_RUNS))
    return line


def phase_e2e(tmp, card):
    """Phase 3: cuda engine == native host engine, end to end; returns
    the launch counts of the first cuda run of each path (the main
    paths': the default sparse path and the -k 0 dense path), the
    streams' FASTQ pairs ({"big", "algo", "n200"}) and the 500k stream's
    FASTA of each path."""
    subs = {}
    started = {}
    for name, args in (
            ("big", ("--fast", "--pairs", str(E2E_PAIRS), "--seed", "42")),
            ("algo", ("--fast", "--pairs", str(ALGO_PAIRS), "--seed", "7")),
            ("n200", ("--pairs", "200", "--seed", "42"))):
        subs[name] = os.path.join(tmp, "e2e_" + name)
        os.makedirs(subs[name])
        started[name] = make_data(os.path.join(subs[name], "in"), *args)
    data = {name: wait_data(s) for name, s in started.items()}
    turns = ("cuda", "host", "host", "cuda")
    counts = {}
    fasta = {}
    counts["sparse"], fasta["sparse"] = compare_engines(
        "%d 2x250" % E2E_PAIRS, *data["big"], subs["big"], turns, SPARSE,
        card, keep=True)
    compare_engines("200-pair N/B-cliff", *data["n200"], subs["n200"],
                    ("cuda", "host"), SPARSE, card)
    counts["dense"], fasta["dense"] = compare_engines(
        "%d 2x250 -k 0" % E2E_PAIRS, *data["big"], subs["big"], turns,
        DENSE, card, ("-k", "0"), keep=True)
    for algo in ("uparse", "ea_util", "flash", "stitch"):
        compare_engines("%d 2x250 -k 0 -A %s" % (ALGO_PAIRS, algo),
                        *data["algo"], subs["algo"], turns, DENSE, card,
                        ("-k", "0", "-A", algo))
    compare_engines("200-pair N/B-cliff -k 0", *data["n200"], subs["n200"],
                    ("cuda", "host"), DENSE, card, ("-k", "0"))
    phase_probe(*data["n200"], tmp)
    return counts, data, fasta


# the installed-layout run (phase 3b), in a process of its own whose
# path holds only the copied package: builds, then the CLI's defaults
_INSTALLED_RUN = r"""
import json, sys, time
import pandaseq_tpu_torch
from pandaseq_tpu_torch.cli.main import main
from pandaseq_tpu_torch.io import native
from pandaseq_tpu_torch.ops import _build, cand
t0 = time.perf_counter()
kernels = _build.build()
t1 = time.perf_counter()
lib = native.build()
t2 = time.perf_counter()
if lib is None:
    raise SystemExit("native host library: %s" % native.build_error)
_build.load()
cand.reset_launch_counts()
t3 = time.perf_counter()
rc = main(sys.argv[1:])
run_s = time.perf_counter() - t3
print("RESULT " + json.dumps({
    "rc": rc, "launches": cand.launch_counts(),
    "package": pandaseq_tpu_torch.__file__, "kernels": kernels,
    "native": lib, "kernels_s": t1 - t0, "native_s": t2 - t1,
    "run_s": run_s}), flush=True)
"""


def install_layout(site):
    """Copies into ``site`` what a wheel of this checkout ships of the
    port: its *.py files and its package data (the globs of
    pyproject.toml). Returns the number of files."""
    import tomllib
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as fh:
        globs = tomllib.load(fh)["tool"]["setuptools"]["package-data"][
            "pandaseq_tpu_torch"]
    pkg = os.path.join(ROOT, "pandaseq_tpu_torch")
    files = glob.glob(os.path.join(pkg, "**", "*.py"), recursive=True)
    for pattern in globs:
        files += glob.glob(os.path.join(pkg, pattern))
    for path in files:
        dest = os.path.join(site, os.path.relpath(path, ROOT))
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copy(path, dest)
    return len(files)


def _tree(root):
    """Every path under ``root`` with its size and mtime."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames + filenames:
            st = os.lstat(os.path.join(dirpath, name))
            out[os.path.relpath(os.path.join(dirpath, name), root)] = (
                st.st_size, st.st_mtime_ns)
    return out


def _set_mode(root, fmode, dmode):
    for dirpath, _, filenames in os.walk(root):
        os.chmod(dirpath, dmode)
        for name in filenames:
            os.chmod(os.path.join(dirpath, name), fmode)


def phase_installed(card, f1, f2, fasta):
    """Phase 3b: the port as a user installs it, on the card (see the
    module doc)."""
    top = tempfile.mkdtemp(prefix="psq_installed_")
    try:
        site, home, work = (os.path.join(top, d)
                            for d in ("site", "home", "work"))
        os.makedirs(home)
        os.makedirs(work)
        n_files = install_layout(site)
        _set_mode(site, 0o444, 0o555)
        before = _tree(site)
        env = {k: v for k, v in os.environ.items()
               if k not in ("PANDASEQ_TPU_ENGINE", "PANDASEQ_TPU_HOST",
                            "PANDASEQ_TPU_CACHE")}
        env.update(PYTHONPATH=site, HOME=home, PYTHONDONTWRITEBYTECODE="1",
                   PANDASEQ_TORCH_DEVICE=DEVICE)
        fa = os.path.join(work, "installed.fa")
        log = os.path.join(work, "installed.log")
        proc = subprocess.run(
            [sys.executable, "-c", _INSTALLED_RUN, "-f", f1, "-r", f2,
             "-w", fa, "-g", log], capture_output=True, text=True,
            env=env, cwd=work, timeout=900)
        if proc.returncode != 0 or "RESULT " not in proc.stdout:
            raise SystemExit("installed layout: the run exited %d:\n%s"
                             % (proc.returncode,
                                (proc.stdout + proc.stderr)[-4000:]))
        res = json.loads(proc.stdout.rsplit("RESULT ", 1)[1].splitlines()[0])
        if res["rc"] != 0:
            raise SystemExit("installed layout: the CLI exited %d"
                             % res["rc"])
        cache = os.path.join(home, ".cache", "pandaseq_tpu_torch")
        for what in ("package", "kernels", "native"):
            root = site if what == "package" else cache
            if os.path.commonpath([res[what], root]) != root:
                raise SystemExit("installed layout: %s %s is not under %s"
                                 % (what, res[what], root))
        if _tree(site) != before:
            raise SystemExit("installed layout: the run wrote into %s"
                             % site)
        lines, engine_line = _norm_log(log)
        if engine_line != "INFO\tENGINE\tcuda (default)":
            raise SystemExit("installed layout: logged %r, expected INFO "
                             "ENGINE cuda (default)" % engine_line)
        reads = [int(m.group(1)) for m in
                 (re.match(r"STAT\tREADS\t(\d+)$", ln) for ln in lines)
                 if m][-1]
        n_batches = math.ceil(reads / CLI_BATCH)
        want = expect_counts(SPARSE, n_batches)
        if res["launches"] != want:
            raise SystemExit("installed layout: launched %s, expected %s"
                             % (res["launches"], want))
        if not filecmp.cmp(fa, fasta, shallow=False):
            raise SystemExit("installed layout: FASTA differs from "
                             "phase 3's")
        say("installed layout: %d files in %s (read-only, unchanged), HOME "
            "%s; from scratch: kernels %.3f s (%s), native host library "
            "%.3f s (%s)" % (n_files, site, home, res["kernels_s"],
                             os.path.relpath(res["kernels"], home),
                             res["native_s"],
                             os.path.relpath(res["native"], home)))
        say("installed layout: defaults on %d pairs, INFO ENGINE cuda "
            "(default), cand_join launched %d times (%d batches) and "
            "nothing else, FASTA == phase 3's (%d bytes); run %.3f s, "
            "%.1f pairs/s on %s"
            % (reads, res["launches"]["cand_join"], n_batches,
               os.path.getsize(fa), res["run_s"], reads / res["run_s"],
               card))
    finally:
        if os.path.isdir(os.path.join(top, "site")):
            _set_mode(os.path.join(top, "site"), 0o644, 0o755)
        shutil.rmtree(top, ignore_errors=True)


def emit_run(asm, f1, f2, out_path):
    """The CLI's byte path driven from the library: emit_stream over the
    native reader with the _pre stage on the prefetch thread, at the
    CLI's batch, ring, depth and dispatch group. Returns (seconds, batch
    sizes, STAT counters)."""
    from pandaseq_tpu_torch.cli.main import ring_slots
    from pandaseq_tpu_torch.io import native
    from pandaseq_tpu_torch.io.prefetch import prefetch

    reader = native.NativeBatchReader(f1, f2, batch=CLI_BATCH, L=512,
                                      ring=ring_slots(CLI_DEPTH, 1))
    sizes = []
    t0 = time.perf_counter()
    with open(out_path, "wb") as out:
        for _, codes, payload in asm.emit_stream(
                prefetch(asm.pre_stream(reader)), fmt="fasta",
                depth=CLI_DEPTH, threaded=True):
            out.write(payload)
            sizes.append(len(codes))
    dt = time.perf_counter() - t0
    c = asm.counters
    return dt, sizes, (c.count, c.ok, c.noalgn, c.lowq, c.badread, c.slow,
                       c.nofp, c.norp, sorted(c.overlaps.items()))


def mesh_launches(sizes, dp, op, path):
    """The launches a (dp, op) mesh implies: a batch of B pairs splits
    over dp when B % dp == 0; a split batch launches counts once per mesh
    cell, and cand_join (the sort-join) and the shortlist once per dp
    row; an unsplit batch launches each once."""
    want = dict.fromkeys(KERNELS, 0)
    for n in sizes:
        rows = dp if n % dp == 0 else 1
        for name in path:
            want[name] += rows * op if name == "counts" else rows
    return want


def lut_mesh_step(mesh, batch, luts):
    """The pear / rdp_mle library path on the mesh: make_sharded_step at
    B=8192, Lb=O=256 against the single-device assemble_shortlist on the
    card. Returns the launch counts of the path's run (both kinds, the
    sharded and the single-device steps)."""
    import numpy as np
    import torch

    from pandaseq_tpu_torch.ops import cand, dense, fused2
    from pandaseq_tpu_torch.parallel import shard

    dev = torch.device(DEVICE, 0)
    Lb = 256
    zeros = np.zeros(B, np.int32)
    host = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        batch.nt_packed()[:, :Lb], batch.fwd_q[:, :Lb], batch.rev_q[:, :Lb],
        batch.flen, batch.rlen, zeros, zeros)]
    card = [x.to(dev) for x in host]
    out = {}
    cand.reset_launch_counts()
    for kind, (tm, tmm, nn) in luts.items():
        kw = dict(L=Lb, algo_kind=kind, nn_term=nn, lut_match=tm,
                  lut_mismatch=tmm)
        out[kind] = (shard.make_sharded_step(mesh, **kw)(*host),
                     fused2.assemble_shortlist(*card, **kw))
    torch.cuda.synchronize()
    launched = cand.launch_counts()
    cells = mesh.shape["dp"] * mesh.shape["op"]
    n = len(luts)
    want = dict(dict.fromkeys(KERNELS, 0), counts=n * (cells + 1),
                lut_sums=n * (cells + 1),
                shortlist=n * (mesh.shape["dp"] + 1))
    if launched != want:
        raise SystemExit("LUT library path launched %s, expected %s"
                         % (launched, want))
    for kind, (tm, tmm, nn) in luts.items():
        sharded, single = (x.cpu().numpy() for x in out[kind])
        kw = dict(L=Lb, algo_kind=kind, nn_term=nn, lut_match=tm,
                  lut_mismatch=tmm)
        wide = fused2.assemble_shortlist(*card, SL=SL + 1, **kw).cpu().numpy()
        # per row: 2e-5 * sum|term| + 1e-6 over its diagonals bounds an
        # f32 sum taken in another order
        abs_sums = dense.lut_sums(
            *card[:5], Lb, kind, fused2.lut_table(np.abs(tm), dev),
            fused2.lut_table(np.abs(tmm), dev), abs(nn))
        bound = (2e-5 * abs_sums.max(dim=1).values + 1e-6).cpu().numpy()
        # the [B, 3L] single-upload form: the same kernels on the same
        # columns, so exactly the single-device result
        packed = fused2.assemble_shortlist_packed(
            torch.cat(card[:3], dim=1), *card[3:], **kw).cpu().numpy()
        if not (packed == single).all():
            raise SystemExit("%s: assemble_shortlist_packed differs from "
                             "assemble_shortlist on %d rows" % (
                                 kind, int((packed != single).any(1).sum())))
        if not (sharded[:, 2 * SL + 1] == single[:, 2 * SL + 1]).all():
            raise SystemExit("%s sharded step: examined differs" % kind)
        scores = wide[:, SL + 1:2 * SL + 2].view(np.float32).astype(
            np.float64)
        # apart: the SL-th and SL+1-th scores differ by more than the
        # bound, or there is no SL+1-th candidate (the -3e38 sentinel)
        apart = ((scores[:, SL - 1] - scores[:, SL] > 2 * bound)
                 | (scores[:, SL] < -1e38))
        same = (np.sort(sharded[:, :SL], axis=1)
                == np.sort(single[:, :SL], axis=1)).all(axis=1)
        if not same[apart].all():
            raise SystemExit("%s sharded step: shortlist sets differ on %d "
                             "rows whose scores are apart" % (
                                 kind, int((~same[apart]).sum())))
        say("mesh dp=%d op=%d: make_sharded_step(%s) B=%d Lb=O=%d == "
            "single-device assemble_shortlist: examined equal, shortlist "
            "sets equal on %d of %d rows (%d rows with a near-tie at the "
            "SL-th score, of which %d differ); assemble_shortlist_packed == "
            "assemble_shortlist" % (
                mesh.shape["dp"], mesh.shape["op"], kind, B, Lb,
                int(same.sum()), B, int((~apart).sum()),
                int((~same[~apart]).sum())))
    return launched


def phase_mesh(tmp, card, f1, f2, fasta, batch_256, luts):
    """Phase 4: the mesh engine on one card against the CLI runs of
    phase 3 and the host engine; then the LUT library path on the mesh.
    Returns the LUT path's launch counts."""
    from pandaseq_tpu_torch import oracle
    from pandaseq_tpu_torch.assembler import BatchAssembler
    from pandaseq_tpu_torch.ops import cand
    from pandaseq_tpu_torch.parallel import shard

    sub = os.path.join(tmp, "mesh")
    os.makedirs(sub)
    out = os.path.join(sub, "run.fa")
    # no engine pin: the mesh itself pins the device engine,
    # the single-device engine is the default
    for name in ("PANDASEQ_TPU_ENGINE", "PANDASEQ_TPU_HOST"):
        os.environ.pop(name, None)
    cuda0 = "%s:0" % DEVICE
    for path_name, k, path, meshes in (("sparse", 2, SPARSE, MESHES),
                                       ("dense", 0, DENSE, MESHES[:1])):
        label = "%d 2x250%s" % (E2E_PAIRS, " -k 0" if k == 0 else "")
        cfg = oracle.OracleConfig(num_kmers=k)
        dt_h, _, host_counters = emit_run(
            BatchAssembler(cfg, device=DEVICE, host_only=True), f1, f2, out)
        if not filecmp.cmp(out, fasta[path_name], shallow=False):
            raise SystemExit("%s: host engine through emit_stream differs "
                             "from the CLI's FASTA" % label)
        cand.reset_launch_counts()
        asm = BatchAssembler(cfg, device=DEVICE)
        dt_1, sizes, counters = emit_run(asm, f1, f2, out)
        if (asm.engine_info != {"reason": "default"}
                or cand.launch_counts() != mesh_launches(sizes, 1, 1, path)
                or counters != host_counters
                or not filecmp.cmp(out, fasta[path_name], shallow=False)):
            raise SystemExit("%s: the single-device cuda engine through "
                             "emit_stream differs" % label)
        say("%s through emit_stream on %s: host engine %.1f pairs/s "
            "(%.3f s), single-device cuda engine %.1f pairs/s (%.3f s), "
            "FASTA and STAT equal" % (label, card, E2E_PAIRS / dt_h, dt_h,
                                      E2E_PAIRS / dt_1, dt_1))
        for dp, op in meshes:
            mesh = shard.make_mesh(devices=[cuda0] * (dp * op), dp=dp, op=op)
            asm = BatchAssembler(cfg, mesh=mesh)
            if asm.engine != DEVICE or asm.engine_info != {"reason": "mesh"}:
                raise SystemExit("mesh engine resolved to %s (%s)"
                                 % (asm.engine, asm.engine_info))
            cand.reset_launch_counts()
            dt, sizes, counters = emit_run(asm, f1, f2, out)
            launched = cand.launch_counts()
            want = mesh_launches(sizes, dp, op, path)
            if launched != want:
                raise SystemExit("%s mesh dp=%d op=%d launched %s, expected "
                                 "%s" % (label, dp, op, launched, want))
            if not filecmp.cmp(out, fasta[path_name], shallow=False):
                raise SystemExit("%s mesh dp=%d op=%d: FASTA differs from "
                                 "the CLI runs'" % (label, dp, op))
            if counters != host_counters:
                raise SystemExit("%s mesh dp=%d op=%d: STAT %s, host engine "
                                 "%s" % (label, dp, op, counters[:8],
                                         host_counters[:8]))
            split = sum(n % dp == 0 for n in sizes)
            say("%s mesh dp=%d op=%d on one card: FASTA == the CLI runs' "
                "(%d bytes), STAT == the host engine's (%s), launched %s "
                "over %d batches (%d split); %.1f pairs/s (%.3f s) on %s"
                % (label, dp, op, os.path.getsize(out), counters[:8],
                   {n: c for n, c in launched.items() if c}, len(sizes),
                   split, E2E_PAIRS / dt, dt, card))
    os.remove(out)
    mesh = shard.make_mesh(devices=[cuda0] * 4, dp=2, op=2)
    return lut_mesh_step(mesh, batch_256, luts)


def phase_distributed(tmp, card, f1, f2):
    """Phase 5: ``python -m pandaseq_tpu_torch.scale_run --procs 2`` in
    mux mode on the 500,000 pairs: two OS processes on cuda:0 run
    run_distributed over gloo; scale_run holds the union of their part
    files' records to the one-process run's and the reduced counter
    vectors and histograms to each other and exits nonzero otherwise.
    Nothing is pinned: the default engine serves every group of every
    process through cand_join, one launch per dispatch group, no other
    kernel."""
    import inspect

    from pandaseq_tpu_torch.parallel import distributed

    sub = os.path.join(tmp, "scale")
    env = dict(os.environ)
    for name in ("PANDASEQ_TPU_ENGINE", "PANDASEQ_TPU_HOST"):
        env.pop(name, None)
    group = inspect.signature(
        distributed.run_distributed).parameters["group"].default
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pandaseq_tpu_torch.scale_run", "--procs",
         "2", "--mode", "mux", "--device", DEVICE, "--input", f1, f2,
         "--batch", str(CLI_BATCH), "--workdir", sub],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT)
    try:
        out = proc.communicate(timeout=900)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise SystemExit("scale_run exited %d:\n%s"
                         % (proc.returncode, out[-3000:]))
    m = json.loads(out.strip().splitlines()[-1])["mux_shared_stream"]
    if not (m["output_identical"] and m["global_stat_identical"]
            and m["pairs"] == E2E_PAIRS
            and all(n > 0 for n in m["multi_per_proc_pairs"])):
        raise SystemExit("scale_run: %s" % m)

    def groups(pairs):
        return math.ceil(math.ceil(pairs / CLI_BATCH) / group)

    none = dict.fromkeys(KERNELS, 0)
    want = [dict(none, cand_join=groups(n))
            for n in [m["pairs"]] + m["multi_per_proc_pairs"]]
    got = [{k: ln.get(k, 0) for k in KERNELS}
           for ln in [m["launches_single"]] + m["launches_multi"]]
    if got != want:
        raise SystemExit("scale_run launches (one process, then each "
                         "rank) %s, expected %s" % (got, want))
    say("scale_run --procs 2 --mode mux (run_distributed, 2 processes on "
        "one card over gloo, default engine): %d records == the one "
        "process's, reduced vectors equal (%s); rank pairs/s %s (%s "
        "pairs); one process "
        "%.1f pairs/s (%.3f s), aggregate %.1f pairs/s, efficiency %.4f; "
        "launches one process %s, ranks %s; command %.3f s on %s" % (
            m["output_records_multi"], m["counters_vec"],
            ", ".join("%.1f" % r for r in m["multi_per_proc_pairs_per_sec"]),
            m["multi_per_proc_pairs"], m["single_pairs_per_sec"],
            m["single_wall_s"], m["multi_aggregate_pairs_per_sec"],
            m["scaling_efficiency"], m["launches_single"],
            m["launches_multi"], wall, card))


def _env(name, value):
    """Sets os.environ[name], or removes it where ``value`` is None."""
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


def phase_tools(tmp, card, diff_data, primed):
    """Phase 6, the companion tools, each through its main(): diff and
    hang on the card (the device engine) against the host engine, and
    checkid."""
    import contextlib
    import io

    from pandaseq_tpu_torch.cli import checkid, diffcmd, hang
    from pandaseq_tpu_torch.ops import cand

    none = dict.fromkeys(KERNELS, 0)
    n_diff = math.ceil(DIFF_PAIRS / diffcmd.DIFF_BATCH)
    for args in (["--", "--", "-t", "0.9"],
                 ["--", "-A", "pear", "--", "-A", "rdp_mle"]):
        res = {}
        for engine in ("default", "host"):
            _env("PANDASEQ_TPU_ENGINE", engine if engine == "host" else None)
            buf = io.StringIO()
            cand.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = diffcmd.main(["-f", diff_data[0], "-r", diff_data[1],
                                   *args])
            dt = time.perf_counter() - t0
            launched = cand.launch_counts()
            # two passes (control, experiment) of n_diff batches each
            want = dict(none, cand_join=2 * n_diff) \
                if engine == "default" else none
            if launched != want:
                raise SystemExit("diff %s (%s): launched %s, expected %s"
                                 % (" ".join(args), engine, launched, want))
            res[engine] = (rc, buf.getvalue(), dt)
        if res["default"][:2] != res["host"][:2] or not res["default"][1]:
            raise SystemExit("diff %s: the card's report (exit %d) differs "
                             "from the host engine's (exit %d)"
                             % (" ".join(args), res["default"][0],
                                res["host"][0]))
        report = res["default"][1].splitlines()
        say("pandaseq-tpu-torch-diff %s on %d pairs: card == host engine, "
            "exit %d, %d report lines (%s); card %.3f s, host %.3f s"
            % (" ".join(args), DIFF_PAIRS, res["default"][0], len(report),
               "; ".join(report[-6:]), res["default"][2], res["host"][2]))

    got = {}
    for engine in ("default", "host"):
        _env("PANDASEQ_TPU_ENGINE", engine if engine == "host" else None)
        fa = os.path.join(tmp, "hang_%s.fa" % engine)
        log = os.path.join(tmp, "hang_%s.log" % engine)
        cand.reset_launch_counts()
        t0 = time.perf_counter()
        rc = hang.main(["-T", "1", "-f", primed[0], "-r", primed[1], "-P",
                        REV_PRIMER, "-Q", FWD_PRIMER, "-w", fa, "-g", log])
        dt = time.perf_counter() - t0
        launched = cand.launch_counts()
        with open(fa, "rb") as fh:
            got[engine] = (rc, fh.read(), _norm_log(log)[0], dt, launched)
    _env("PANDASEQ_TPU_ENGINE", None)
    card_run, host_run = got["default"], got["host"]
    if card_run[4]["cand_join"] == 0 or card_run[4] != dict(
            none, cand_join=card_run[4]["cand_join"]) or host_run[4] != none:
        raise SystemExit("hang: launched %s on the card, %s on the host "
                         "engine" % (card_run[4], host_run[4]))
    if card_run[:3] != host_run[:3] or not card_run[1] or card_run[0]:
        raise SystemExit("hang: the card's FASTA / STAT (exit %d) differ "
                         "from the host engine's (exit %d)"
                         % (card_run[0], host_run[0]))
    stats = [ln for ln in card_run[2] if ln.startswith("STAT\t")
             and not ln.startswith(("STAT\tTIME", "STAT\tELAPSED",
                                    "STAT\tOVERLAPS"))][-6:]
    say("pandaseq-tpu-torch-hang -P %s -Q %s on %d primed pairs: FASTA "
        "(%d bytes) and STAT equal, card (cand_join %d launches) against "
        "host engine: %s; card %.3f s, host %.3f s"
        % (REV_PRIMER, FWD_PRIMER, PRIMED_PAIRS, len(card_run[1]),
           card_run[4]["cand_join"], ", ".join(
               s.split("\t", 1)[1].replace("\t", "=") for s in stats),
           card_run[3], host_run[3]))

    buf = io.StringIO()
    header = "M01271:10:000000000-A3WGH:1:1101:18786:6175 1:N:0:1"
    with contextlib.redirect_stdout(buf):
        rc = checkid.main([header])
    if rc or "\tGOOD" not in buf.getvalue():
        raise SystemExit("checkid exited %d: %r" % (rc, buf.getvalue()))
    say("pandaseq-tpu-torch-checkid %r: GOOD, generator %s" % (
        header, buf.getvalue().rsplit("generator = ", 1)[1].strip()))


# phase 7's -C module: a check without check_batch (the CLI's result-
# object path), keeping merged reads no longer than its argument
ONLY_SHORT = """from pandaseq_tpu_torch.filters import Module

api = 3


def opener(args, logger):
    limit = int(args) if args else 400
    return Module("only_short", check=lambda res: res.sequence_length
                  <= limit, args=args)
"""
# every field of a result the library hands out (NativeResult or
# OracleResult), beside its sid, sequence and per-base probabilities
RESULT_FIELDS = ("sequence_length", "quality", "overlap",
                 "overlaps_examined", "overlap_mismatches", "degenerates",
                 "estimated_overlap_probability", "slow", "forward_offset",
                 "reverse_offset", "forward_length", "reverse_length")


def result_fields(res):
    """A result's fields, its sid as a string, its sequence's bytes and
    its per-base log-probabilities bit for bit (None stays None)."""
    import numpy as np

    from pandaseq_tpu_torch.io import output

    if res is None:
        return None
    out = {f: getattr(res, f) for f in RESULT_FIELDS}
    out["sid"] = str(res.sid)
    if res.sequence_ascii is not None or res.sequence_nt is not None:
        out["sequence"] = output._seq_bytes(res)
        out["p"] = np.asarray(res.sequence_p[:res.sequence_length],
                              np.float64).tobytes()
    return out


def library(engine, device=None):
    """pandaseq_tpu_torch.Assembler() as a library user makes it (no
    device argument unless ``device``); "cuda" leaves the engine to its
    default, "host" pins the native host engine."""
    import pandaseq_tpu_torch

    for name in ("PANDASEQ_TPU_HOST", "PANDASEQ_TPU_GROUP"):
        os.environ.pop(name, None)
    _env("PANDASEQ_TPU_ENGINE", "host" if engine == "host" else None)
    if device is None:
        return pandaseq_tpu_torch.Assembler()
    return pandaseq_tpu_torch.Assembler(device=device)


def api_stream(asm, files):
    """One Assembler.stream run: (FASTA bytes of the OK results, the
    fail callback's sids, every counter getter, device steps, launches,
    seconds); the launch counts are set to 0 just before the run and
    read just after it."""
    from pandaseq_tpu_torch.io import output
    from pandaseq_tpu_torch.ops import cand

    failed = []
    asm.set_fail_alignment(lambda pair: failed.append(str(pair.sid)))
    cand.reset_launch_counts()
    t0 = time.perf_counter()
    fasta = b"".join(output.format_fasta(res)
                     for res in asm.stream(*files))
    dt = time.perf_counter() - t0
    launched = cand.launch_counts()
    counters = (asm.count, asm.ok_count, asm.low_quality_count,
                asm.bad_read_count, asm.failed_alignment_count,
                asm.no_forward_primer_count, asm.no_reverse_primer_count,
                asm.slow_count, asm.overlap_count, asm.longest_overlap)
    return (fasta, failed, counters, asm._engine._device_dispatches,
            launched, dt)


def compare_api(label, files, path, card, configure=lambda asm: None,
                reference="host"):
    """Assembler.stream on the card's default engine against the same
    call on ``reference`` ("host": the native host engine; "cpu": the
    plain versions on the host's CPU): FASTA, fail sids and counters
    equal, the card's run launching each kernel of ``path`` once per
    device step the engine made and nothing else. Returns the card's
    FASTA and the device steps of the card's run."""
    runs = {}
    for engine in ("cuda", reference):
        asm = library(engine, "cpu" if engine == "cpu" else None)
        configure(asm)
        runs[engine] = api_stream(asm, files)
        # (a custom algorithm's dense step never asks for the engine:
        # .engine resolves it here)
        if engine == "cuda" and (
                asm._engine.engine != DEVICE
                or asm._engine.engine_info != {"reason": "default"}):
            raise SystemExit("%s: Assembler() resolved to %s (%s)" % (
                label, asm._engine.engine, asm._engine.engine_info))
    _env("PANDASEQ_TPU_ENGINE", None)
    got, want = runs["cuda"], runs[reference]
    fasta, failed, counters, steps, launched, dt = got
    n_batches = math.ceil(counters[0] / asm.batch)
    if not fasta or got[:3] != want[:3]:
        raise SystemExit("%s: the card's FASTA (%d bytes), fail sids (%d) "
                         "or counters %s differ from %s's (%d bytes, %d, "
                         "%s)" % (label, len(fasta), len(failed),
                                  counters[:8], reference, len(want[0]),
                                  len(want[1]), want[2][:8]))
    none = dict.fromkeys(KERNELS, 0)
    if not 0 < steps <= n_batches or launched != dict(
            none, **dict.fromkeys(path, steps)):
        raise SystemExit("%s: %d device steps over %d batches, launched %s"
                         % (label, steps, n_batches, launched))
    if want[4] != none or (reference == "host" and want[3]):
        raise SystemExit("%s: the %s run made %d device steps, launched %s"
                         % (label, reference, want[3], want[4]))
    say("library %s: FASTA (%d bytes), %d fail-callback sids and every "
        "counter equal to %s's (%s); %s launched once per device step "
        "(%d steps for %d batches of %d), nothing else; cuda %.1f "
        "pairs/s (%.3f s), %s %.1f pairs/s (%.3f s) on %s"
        % (label, len(fasta), len(failed), reference, counters[:8],
           "/".join(path), steps, n_batches, asm.batch, counters[0] / dt, dt,
           reference, counters[0] / want[5], want[5], card))
    return fasta, steps


def head_pairs(files, n, prefix):
    """The first ``n`` records of a FASTQ pair, written to prefix_[12]."""
    out = []
    for i, path in enumerate(files, 1):
        dest = "%s_%d.fastq" % (prefix, i)
        with open(path) as src, open(dest, "w") as dst:
            for _, line in zip(range(4 * n), src):
                dst.write(line)
        out.append(dest)
    return out


def batch_calls(files, card):
    """assemble_batch on ReadPair lists of BATCH_PAIRS pairs and on a
    decoded Batch of DECODED_ROWS rows, on the card and on the host
    engine: every result field equal, one cand_join launch (one device
    step) a call on the card, none on the host; then assemble on
    SINGLE_PAIRS single pairs: equal, no launch."""
    from pandaseq_tpu_torch.io import fastq as fq
    from pandaseq_tpu_torch.io import native
    from pandaseq_tpu_torch.ops import cand

    none = dict.fromkeys(KERNELS, 0)
    pairs = [p for p, _ in zip(fq.read_pairs(*files), range(1024))]
    calls = [("%d ReadPair" % n, lambda n=n: pairs[:n])
             for n in BATCH_PAIRS]
    calls.append(("decoded Batch of %d" % DECODED_ROWS, lambda: next(iter(
        native.NativeBatchReader(*files, batch=DECODED_ROWS, L=512)))))
    for what, make in calls:
        got = {}
        for engine in ("cuda", "host"):
            asm = library(engine)
            batch = make()
            cand.reset_launch_counts()
            t0 = time.perf_counter()
            res = asm.assemble_batch(batch)
            dt = time.perf_counter() - t0
            got[engine] = ([(code, result_fields(r)) for code, r in res],
                           cand.launch_counts(), dt)
        _env("PANDASEQ_TPU_ENGINE", None)
        card_res, launched, dt = got["cuda"]
        n_ok = sum(code == "OK" for code, _ in card_res)
        if card_res != got["host"][0] or not n_ok:
            raise SystemExit("assemble_batch (%s): the card's results "
                             "differ from the host engine's" % what)
        if launched != dict(none, cand_join=1) or got["host"][1] != none:
            raise SystemExit("assemble_batch (%s): launched %s on the "
                             "card, %s on the host engine"
                             % (what, launched, got["host"][1]))
        say("library assemble_batch (%s): %d results, %d OK, every field "
            "== the host engine's; cand_join launched once; card %.4f s, "
            "host %.4f s" % (what, len(card_res), n_ok, dt, got["host"][2]))

    singles = []
    with open(files[0]) as f1, open(files[1]) as f2:
        for _ in range(SINGLE_PAIRS):
            rec = [(f1.readline(), f2.readline()) for _ in range(4)]
            singles.append((rec[0][0][1:].split()[0],
                            (rec[1][0].strip(), rec[3][0].strip()),
                            (rec[1][1].strip(), rec[3][1].strip())))
    got = {}
    for engine in ("cuda", "host"):
        asm = library(engine)
        cand.reset_launch_counts()
        out = [asm.assemble(*pair) for pair in singles]
        got[engine] = ([(code, result_fields(r)) for r, code in out],
                       cand.launch_counts())
    _env("PANDASEQ_TPU_ENGINE", None)
    if got["cuda"] != got["host"] or got["cuda"][1] != none:
        raise SystemExit("assemble: the card's run (launched %s) differs "
                         "from the host engine's" % got["cuda"][1])
    say("library assemble: %d single pairs (%d OK), every field == the "
        "host engine's, no kernel launched"
        % (SINGLE_PAIRS, sum(code == "OK" for code, _ in got["cuda"][0])))


def phase_library(tmp, card, data, primed, fasta):
    """Phase 7: the library entry point, pandaseq_tpu_torch.Assembler,
    and the CLI's result-object path (see the module doc)."""
    from pandaseq_tpu_torch import algorithms, oracle

    sub = os.path.join(tmp, "library")
    os.makedirs(sub)
    got, _ = compare_api("stream %d 2x250" % E2E_PAIRS, data["big"], SPARSE,
                         card)
    with open(fasta, "rb") as fh:
        if fh.read() != got:
            raise SystemExit("library stream: FASTA differs from phase "
                             "3's CLI run")
    say("library stream %d 2x250: FASTA == phase 3's CLI FASTA" % E2E_PAIRS)
    del got

    def k0(asm):
        asm.num_kmers = 0

    compare_api("stream %d 2x250 num_kmers 0" % ALGO_PAIRS, data["algo"],
                DENSE, card, k0)

    class RenamedSimpleBayes(oracle.SimpleBayes):
        name = "renamed_sb"

    algorithms.register_algorithm("renamed_sb", RenamedSimpleBayes)

    def custom(asm):
        asm.algorithm = algorithms.make_algorithm("renamed_sb")

    # a custom algorithm takes the dense device step on any engine (the
    # host engine has no path for it): its reference is the plain
    # versions on the host's CPU
    compare_api("stream %d 2x250 custom algorithm renamed_sb" % CUSTOM_PAIRS,
                head_pairs(data["algo"], CUSTOM_PAIRS,
                           os.path.join(sub, "custom")),
                DENSE, card, custom, reference="cpu")
    batch_calls(data["algo"], card)

    module = os.path.join(sub, "only_short.py")
    with open(module, "w") as fh:
        fh.write(ONLY_SHORT)
    for label, files, extra in (
            ("-p -q -a %d primed" % PRIMED_PAIRS, primed,
             ("-p", FWD_PRIMER, "-q", REV_PRIMER, "-a")),
            ("-C only_short.py:400 %d 2x250" % ALGO_PAIRS, data["algo"],
             ("-C", module + ":400")),
            ("-d rkm -N 200-pair N/B-cliff", data["n200"],
             ("-d", "rkm", "-N"))):
        compare_engines("library CLI result path " + label, *files, sub,
                        ("cuda", "host"), SPARSE, card, extra)


def phase_shapes(tmp, card, started, big):
    """Phase 8: the read shapes of users' runs (see the module doc):
    each stream through the port CLI on the card's default engine
    against the host engine, the -O 700 reroute through the engine, and
    Assembler.stream over the pooled run against the prediction of the
    flush rule."""
    import inspect

    from pandaseq_tpu_torch import api, oracle
    from pandaseq_tpu_torch.assembler import BatchAssembler
    from pandaseq_tpu_torch.ops import cand

    sub = os.path.join(tmp, "shapes")
    os.makedirs(sub)
    v3v4, short = (wait_data(started[n]) for n in ("v3v4", "short"))
    r2cut = cut_r2(v3v4, os.path.join(sub, "v3v4_r2cut"))
    pooled = pool_streams([(short, 0, POOL_SEGMENT), (v3v4, 0, POOL_SEGMENT),
                           (big, 0, POOL_SEGMENT),
                           (short, POOL_SEGMENT, POOL_SEGMENT)],
                          os.path.join(sub, "pooled"))
    olimit = head_pairs(v3v4, OLIMIT_PAIRS, os.path.join(sub, "olimit"))
    streams = {"v3v4_2x300": v3v4, "v3v4_r2cut": r2cut,
               "short_2x100": short}
    for name, files in streams.items():
        say("%s: buckets (Lb, O) of its CLI batches %s" % (
            name, sorted(set(batch_buckets(files, CLI_BATCH)))))
    turns = ("cuda", "host")
    for name, files in streams.items():
        compare_engines(name, *files, sub, turns, SPARSE, card)
        compare_engines(name + " -k 0", *files, sub, turns, DENSE, card,
                        ("-k", "0"))
    say("pooled: CLI batch buckets %s" % batch_buckets(pooled, CLI_BATCH))
    _, pooled_fa = compare_engines("pooled", *pooled, sub, turns, SPARSE,
                                   card, keep=True)
    for limit in OLIMITS:
        compare_engines("olimit -O " + limit, *olimit, sub, turns,
                        SPARSE if limit == "200" else (), card,
                        ("-O", limit), keep=limit == "700")
    # -O 700: O_full 640 passes the CLI's plane width L = 512, so every
    # batch reroutes to the host twin (the reference's own routing); the
    # engine counts the reroutes
    cli_fa = os.path.join(sub, "olimit_O_700.fa")
    out = os.path.join(sub, "olimit_700_engine.fa")
    _env("PANDASEQ_TPU_ENGINE", None)
    asm = BatchAssembler(oracle.OracleConfig(maxoverlap=int(OLIMITS[1])),
                         device=DEVICE)
    cand.reset_launch_counts()
    dt, sizes, _ = emit_run(asm, *olimit, out)
    launched = cand.launch_counts()
    if (launched != dict.fromkeys(KERNELS, 0) or asm._device_dispatches
            or asm._overflow_reroutes != len(sizes)
            or not filecmp.cmp(out, cli_fa, shallow=False)):
        raise SystemExit("olimit -O 700 through the engine: launched %s, %d "
                         "device steps, %d of %d batches rerouted, FASTA "
                         "%s the CLI's" % (
                             launched, asm._device_dispatches,
                             asm._overflow_reroutes, len(sizes),
                             "==" if filecmp.cmp(out, cli_fa, shallow=False)
                             else "!="))
    say("olimit -O 700 through the engine (%s, reason %s): %d of %d batches "
        "rerouted to the host twin (O_full 640 > L 512), 0 device steps, "
        "no kernel launched, FASTA == the CLI's; %.1f pairs/s (%.3f s) on %s"
        % (asm.engine, asm.engine_info["reason"], asm._overflow_reroutes,
           len(sizes), OLIMIT_PAIRS / dt, dt, card))
    for path in (out, cli_fa):
        os.remove(path)

    batch = inspect.signature(api.Assembler).parameters["batch"].default
    group = int(os.environ.get("PANDASEQ_TPU_GROUP", "4"))
    buckets = batch_buckets(pooled, batch)
    want = predict_steps(buckets, group)
    say("library stream pooled: %d batches of %d in segments %s; predicted "
        "by the flush rule at group %d: %d device steps" % (
            len(buckets), batch, [(key, len(list(run))) for key, run in
                                  itertools.groupby(buckets)], group, want))
    got, steps = compare_api("stream pooled", pooled, SPARSE, card)
    with open(pooled_fa, "rb") as fh:
        if fh.read() != got:
            raise SystemExit("library stream pooled: FASTA differs from the "
                             "pooled CLI run's")
    if steps != want:
        raise SystemExit("library stream pooled: %d device steps, predicted "
                         "%d" % (steps, want))
    say("library stream pooled: %d device steps == predicted, cand_join %d "
        "launches, FASTA == the pooled CLI run's (%d bytes)"
        % (steps, steps, len(got)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from pandaseq_tpu_torch.io import native
    from pandaseq_tpu_torch.ops import _build

    os.environ["PANDASEQ_TORCH_DEVICE"] = "cuda"
    card = card_line()
    say("card: %s" % card)
    say("python %s, torch %s, CUDA %s, device %s"
        % (sys.version.split()[0], torch.__version__, torch.version.cuda,
           torch.cuda.get_device_name(0)))
    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    say("kernels: %s ready in %.2f s" % (os.path.relpath(so, ROOT),
                                         time.perf_counter() - t0))
    if os.path.exists(so + ".log"):
        for ln in open(so + ".log").read().splitlines():
            if "ptxas info" in ln and ("Used" in ln or "Compiling" in ln):
                say("  " + ln.strip())
    if native.get_lib() is None:
        raise SystemExit("native host library did not build")
    say("native host library loaded")

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    errs = dict.fromkeys(KERNELS, 0)
    errs["shortlist_ulp"] = 0
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) \
            as tmp:
        # phase 6's inputs, made while the earlier phases run
        tool_data = {
            "diff": make_data(os.path.join(tmp, "diff"), "--fast",
                              "--pairs", str(DIFF_PAIRS), "--seed", "9"),
            "primed": make_data(os.path.join(tmp, "primed"), "--pairs",
                                str(PRIMED_PAIRS), "--seed", "7",
                                "--fwd-primer", FWD_PRIMER,
                                "--rev-primer", REV_PRIMER)}
        # phase 8's runs, made likewise
        shape_data = {
            "v3v4": make_data(os.path.join(tmp, "v3v4_2x300"), *V3V4_ARGS),
            "short": make_data(os.path.join(tmp, "short_2x100"),
                               *SHORT_ARGS)}
        times, batch_256, luts = phase_kernels(tmp, errs, card)
        say("shortlist f32 columns: max %d ulp, max abs err %r from the "
            "twin" % (errs["shortlist_ulp"], errs["shortlist"]))
        counts, data, fasta = phase_e2e(tmp, card)
        big = data["big"]
        phase_installed(card, *big, fasta["sparse"])
        counts["lut"] = phase_mesh(tmp, card, *big, fasta, batch_256, luts)
        phase_distributed(tmp, card, *big)
        primed = wait_data(tool_data["primed"])
        phase_tools(tmp, card, wait_data(tool_data["diff"]), primed)
        phase_library(tmp, card, data, primed, fasta["sparse"])
        phase_shapes(tmp, card, shape_data, big)

    kernels = []
    for name in KERNELS:
        ms, pms = times[(name, 256, 256)]
        bms, by = bound(name, 256, 256)
        path = ("sparse" if name in SPARSE
                else "lut" if name == "lut_sums" else "dense")
        # no single PyTorch call computes any of these functions
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": counts[path][name],
                        "max_abs_err": errs[name], "ms": ms,
                        "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                        "library_ms": None})
    say(card_line())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
