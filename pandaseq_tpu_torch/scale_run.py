"""Data-parallel scaling run of the PyTorch port: one process against N
processes joined by torch.distributed over gloo.

The port's counterpart of ``scale_run.py`` (BASELINE config 5: a
synthetic MiSeq 2x300 stream, data-parallel across N hosts). It runs the
SAME stream twice:

  1. one process,
  2. N OS processes, each calling the port's
     ``parallel.distributed.run_distributed`` with a torchrun-style
     environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
     ``RANK``),

and checks that the union of the N part files is record-for-record the
one-process output (an order-independent multiset sha256), and that the
reduced STAT counter vectors are equal. Two layouts: ``striped`` (one
input stripe per process) and ``mux`` (one shared stream whose batches
the processes claim round-robin, mux.c:132-161).

Each process is pinned to its own slice of ``cpus / N`` cores (taskset,
where present) with as many OpenMP threads, so N processes split the
machine's cores fairly and the 1-process baseline sees the same slice.
With ``--device cuda`` rank r runs on card ``r % cards`` (it sees only
that card); ``--device cpu`` runs the plain device step. A worker that
fails raises, and the script exits nonzero.

    python -m pandaseq_tpu_torch.scale_run [--pairs 10000000] [--procs 2]
        [--device cuda|cpu] [--out scale.json] [--batch 8192]
        [--input F1 F2 ...] [--mode both|striped|mux]

The data (``--pairs`` split into one file pair per process) is made by
the checkout's tests/golden/make_data.py under ``scale_data/`` in
``_paths.build_root()`` unless ``--input`` names existing FASTQ pairs;
an installed package has no generator and needs ``--input``. The work
files go to ``scale_run/`` there unless ``--workdir`` says otherwise.
``--batch`` is the CLI's batch by default. The
JSON record (per-process pairs/s, aggregate pairs/s, scaling efficiency,
the digests) is printed as the last line, and written to a file only
where ``--out`` names one.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys

from ._paths import PKG, build_root

ROOT = os.path.dirname(PKG)
# the checkout's data generator; an installed package has none
GENERATOR = os.path.join(ROOT, "tests", "golden", "make_data.py")
BATCH = 8192  # the CLI's (cli/main.py, PANDASEQ_TPU_BATCH unset)
WORKER_TIMEOUT = 3600  # seconds a worker may run

_WORKER = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
out_dir, batch = sys.argv[2], int(sys.argv[3])
inputs = [tuple(p) for p in json.loads(sys.argv[4])]
import torch
torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
from pandaseq_tpu_torch.ops import cand
from pandaseq_tpu_torch.parallel import distributed as D
perf = {}
vec, hist = D.run_distributed(inputs, out_dir=out_dir, batch=batch,
                              perf_out=perf)
print("RESULT " + json.dumps({
    "rank": perf["process"], "vec": [int(x) for x in vec],
    "hist": sorted(hist.items()), "perf": perf,
    "launches": cand.launch_counts()}), flush=True)
if torch.distributed.is_initialized():
    torch.distributed.destroy_process_group()
"""


def ensure_data(pairs: int, shards: int, data_dir: str | None = None):
    """``shards`` file pairs of pairs/shards each (the striped
    data-parallel layout: process p owns stripe p), 2x300 reads from
    420-560 bp amplicons, made once under ``data_dir`` (default
    ``scale_data/`` in the build root) by the checkout's generator.
    Returns the (fwd, rev) paths."""
    if data_dir is None:
        data_dir = os.path.join(build_root(), "scale_data")
    per = pairs // shards
    os.makedirs(data_dir, exist_ok=True)
    out = []
    for s in range(shards):
        prefix = os.path.join(data_dir, "scale%dk_s%d" % (per // 1000, s))
        f1 = prefix + "_1.fastq"
        if not os.path.exists(f1) or os.path.getsize(f1) < per * 600:
            print("generating stripe %d: %d pairs 2x300 (one-time)..."
                  % (s, per), flush=True)
            subprocess.run(
                [sys.executable, GENERATOR, "--fast", "--pairs", str(per),
                 "--read-len", "300", "--amp-min", "420", "--amp-max", "560",
                 "--seed", str(11 + 7919 * s),
                 "--out-prefix", prefix], check=True,
                stdout=subprocess.DEVNULL)
        out.append((f1, prefix + "_2.fastq"))
    return out


def multiset_sha(paths) -> tuple[str, int]:
    """Order-independent record digest over FASTA part files: sha1 per
    record, sorted, sha256 over the concatenation. Returns (hexdigest,
    n_records)."""
    digests = []
    for path in paths:
        with open(path, "rb") as fh:
            rec = []
            for line in fh:
                if line.startswith(b">") and rec:
                    digests.append(hashlib.sha1(b"".join(rec)).digest())
                    rec = []
                rec.append(line)
            if rec:
                digests.append(hashlib.sha1(b"".join(rec)).digest())
    digests.sort()
    h = hashlib.sha256()
    for d in digests:
        h.update(d)
    return h.hexdigest(), len(digests)


def _cards(device: str):
    """The card indices rank r may use (``r % len``), or None on the
    CPU; honours an inherited CUDA_VISIBLE_DEVICES."""
    if device == "cpu":
        return None
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        raise RuntimeError("--device cuda but torch sees no CUDA device "
                           "(use --device cpu for the plain step)")
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    return visible.split(",")[:n] if visible else [str(i) for i in range(n)]


def run_procs(nproc, inputs, out_dir, threads, device, batch):
    """N worker processes (1 = the baseline, no group), each pinned to
    its own ``threads``-core slice; returns (results by rank, part
    files). Raises when a worker fails."""
    if os.path.exists(out_dir):
        shutil.rmtree(out_dir)
    os.makedirs(out_dir)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env.update(OMP_NUM_THREADS=str(threads), PANDASEQ_TORCH_DEVICE=device)
    cores = sorted(os.sched_getaffinity(0))
    taskset = shutil.which("taskset")
    if taskset is None:
        print("taskset not found: the processes run unpinned", flush=True)
    cards = _cards(device)
    procs = []
    try:
        for rank in range(nproc):
            wenv = dict(env)
            if nproc > 1:
                wenv.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                            WORLD_SIZE=str(nproc), RANK=str(rank))
            if cards is not None:
                wenv["CUDA_VISIBLE_DEVICES"] = cards[rank % len(cards)]
            mine = cores[rank * threads:(rank + 1) * threads]
            pin = [taskset, "-c", ",".join(map(str, mine))] \
                if taskset and len(mine) == threads else []
            procs.append(subprocess.Popen(
                pin + [sys.executable, "-c", _WORKER, ROOT, out_dir,
                       str(batch), json.dumps([list(p) for p in inputs])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=wenv,
                text=True))
        outs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError("worker %d of %d exited %d:\n%s"
                               % (rank, nproc, p.returncode, o[-4000:]))
    results = [json.loads(o.rsplit("RESULT ", 1)[1].splitlines()[0])
               for o in outs]
    parts = sorted(os.path.join(out_dir, f) for f in os.listdir(out_dir)
                   if f.startswith("part-"))
    return results, parts


def run_mode(tag, inputs, procs, threads, device, batch, workdir):
    """One 1-process against N-process comparison over ``inputs``."""
    print("=== %s: one process (%d threads) ===" % (tag, threads),
          flush=True)
    res1, parts1 = run_procs(1, inputs, os.path.join(workdir, tag + "_1"),
                             threads, device, batch)
    rate1 = res1[0]["perf"]["pairs_per_sec"]
    n_pairs = res1[0]["perf"]["pairs"]
    print("1 process: %.1f pairs/s" % rate1, flush=True)
    print("=== %s: %d processes (%d threads each) ===" % (tag, procs,
                                                        threads), flush=True)
    resN, partsN = run_procs(procs, inputs,
                             os.path.join(workdir, "%s_%d" % (tag, procs)),
                             threads, device, batch)
    agg = n_pairs / max(r["perf"]["wall_s"] for r in resN)
    print("%d processes: aggregate %.1f pairs/s" % (procs, agg), flush=True)
    sha1, n1 = multiset_sha(parts1)
    shaN, nN = multiset_sha(partsN)
    vec_equal = all(r["vec"] == res1[0]["vec"] for r in resN)
    hist_equal = all(r["hist"] == res1[0]["hist"] for r in resN)
    return {
        "pairs": n_pairs,
        "procs": procs,
        "threads_per_proc": threads,
        "single_pairs_per_sec": rate1,
        "single_wall_s": res1[0]["perf"]["wall_s"],
        "multi_aggregate_pairs_per_sec": agg,
        "multi_per_proc_pairs_per_sec": [r["perf"]["pairs_per_sec"]
                                         for r in resN],
        "multi_per_proc_pairs": [r["perf"]["pairs"] for r in resN],
        "multi_wall_s": [r["perf"]["wall_s"] for r in resN],
        "scaling_efficiency": agg / (procs * rate1),
        "output_records_single": n1,
        "output_records_multi": nN,
        "multiset_sha256_single": sha1,
        "multiset_sha256_multi": shaN,
        "output_identical": sha1 == shaN and n1 == nN and n1 > 0,
        "global_stat_identical": vec_equal and hist_equal,
        "counters_vec": res1[0]["vec"],
        "launches_single": res1[0]["launches"],
        "launches_multi": [r["launches"] for r in resN],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pandaseq_tpu_torch.scale_run",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=10_000_000)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--out", default=None,
                    help="write the JSON record here too")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--mode", choices=["both", "striped", "mux"],
                    default="both")
    ap.add_argument("--input", nargs=2, action="append",
                    metavar=("FWD", "REV"),
                    help="an existing FASTQ pair (repeat for stripes); "
                         "default: generated data")
    ap.add_argument("--workdir", default=None,
                    help="default: scale_run/ in the build root")
    ap.add_argument("--batch", type=int, default=BATCH)
    args = ap.parse_args(argv)
    if args.procs < 2:
        ap.error("--procs must be at least 2")
    if not args.input and not os.path.exists(GENERATOR):
        ap.error("no --input FWD REV given, and no data generator (%s): "
                 "an installed package needs --input" % GENERATOR)
    if args.workdir is None:
        args.workdir = os.path.join(build_root(), "scale_run")

    inputs = ([tuple(p) for p in args.input] if args.input
              else ensure_data(args.pairs, args.procs))
    threads = max(1, len(os.sched_getaffinity(0)) // args.procs)
    out = {"inputs": [list(p) for p in inputs], "device": args.device,
           "group": "torch.distributed over gloo"}
    # striped: one input stripe per process; mux: one shared stream,
    # round-robin batch claims (every process scans the whole stream, so
    # its scaling ceiling is lower by construction)
    if args.mode in ("both", "striped"):
        out["striped"] = run_mode("striped", inputs, args.procs, threads,
                                  args.device, args.batch, args.workdir)
    if args.mode in ("both", "mux"):
        out["mux_shared_stream"] = run_mode(
            "mux", inputs[:1], args.procs, threads, args.device,
            args.batch, args.workdir)
    ok = all(m["output_identical"] and m["global_stat_identical"]
             for m in out.values() if isinstance(m, dict))
    out["all_identical"] = ok
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
