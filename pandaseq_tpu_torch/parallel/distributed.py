"""Multi-process data-parallel runner of the PyTorch port.

Counterpart of ``pandaseq_tpu/parallel/distributed.py``: every process
decodes its input shard (or claims batches round-robin on a shared
stream, the PandaMux analogue, mux.c:132-161), assembles them with the
port's ``BatchAssembler`` and writes its own part file; the STAT
counters, the overlap histogram and the per-module rejects are summed
over all processes at the end. The input sharding, the batch claims and
the checkpoint (``ShardCheckpoint``, ``shard_inputs``,
``_claimed_batches``, ``_batches_of``) are the port's copies of the JAX
module's host code.

The group is torch.distributed over gloo: the counters are host data
summed once per run, so no card is needed, and gloo works for ranks that
share one card, where NCCL refuses a duplicate GPU. A torchrun-style
environment starts it:

    MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 WORLD_SIZE=2 RANK=0 \\
        python -c "from pandaseq_tpu_torch.parallel.distributed import \\
        run_distributed; run_distributed([('f1.fq', 'f2.fq')])"

(and the same with ``RANK=1``).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

N_COUNTERS = 8
HIST_BINS = 1024


def maybe_initialize_distributed():
    """(rank, world size). Joins the torch.distributed group over gloo
    when the torchrun-style environment names one of more than one
    process (``MASTER_ADDR``, ``WORLD_SIZE`` > 1; ``RANK`` and
    ``MASTER_PORT`` are read by the rendezvous); (0, 1) otherwise. A
    process that fails to join raises: run alone, it would write a whole
    part file that another rank writes too."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if os.environ.get("MASTER_ADDR") and \
            int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group("gloo")
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def reduce_counters(counters, histogram: dict, modules=()):
    """Global STAT reduction: the counter vector, the overlap histogram
    and the per-module reject tallies summed over all processes (proxy.c's
    per-thread tallies reduced; module.c:208-216 prints each module's
    rejects in the final STAT block, so each module object's ``rejected``
    is REPLACED with the global total). One ``all_reduce`` of an int64
    CPU tensor over gloo where a group of more than one process exists,
    the identity otherwise. Returns (the 8 counters, histogram)."""
    # merged reads cap at 2*MAX_LEN-1 = 899 nt so every overlap fits;
    # fail loudly rather than silently dropping a histogram bin
    assert all(0 <= o < HIST_BINS for o in histogram), \
        "overlap histogram bin out of range"
    modules = list(modules)
    vec = np.zeros(N_COUNTERS + HIST_BINS + len(modules), dtype=np.int64)
    vec[:N_COUNTERS] = [counters.count, counters.ok, counters.noalgn,
                        counters.lowq, counters.badread, counters.slow,
                        counters.nofp, counters.norp]
    for o, n in histogram.items():
        vec[N_COUNTERS + o] = n
    for i, m in enumerate(modules):
        vec[N_COUNTERS + HIST_BINS + i] = m.rejected
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        t = torch.from_numpy(vec)
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        vec = t.numpy()
    hist = {o: int(vec[N_COUNTERS + o]) for o in range(HIST_BINS)
            if vec[N_COUNTERS + o] > 0}
    for i, m in enumerate(modules):
        m.rejected = int(vec[N_COUNTERS + HIST_BINS + i])
    return vec[:N_COUNTERS], hist


class ShardCheckpoint:
    """Append-only resume watermark per input shard."""

    def __init__(self, path: str | None):
        self.path = path
        self.done = {}
        if path and os.path.exists(path):
            with open(path) as fh:
                for line in fh:
                    rec = json.loads(line)
                    self.done[rec["shard"]] = rec["batch"]

    def watermark(self, shard: int) -> int:
        return self.done.get(shard, -1)

    def record(self, shard: int, batch: int):
        if not self.path:
            return
        with open(self.path, "a") as fh:
            fh.write(json.dumps({"shard": shard, "batch": batch}) + "\n")
        self.done[shard] = batch


def shard_inputs(inputs, process_index: int, process_count: int):
    """inputs: list of (fwd, rev) path tuples -> this host's subset."""
    return [pair for i, pair in enumerate(inputs)
            if i % process_count == process_index]


def _claimed_batches(fwd, rev, batch, L, claim, n_claim, start_after,
                     ring=28):
    """(batch_index, Batch) for this host's round-robin claims on a
    shared stream. Unclaimed batches — and claimed batches at or below
    the resume watermark — are DECODE-SKIPPED via the native
    psq_skip_batch (line scan + record validation + persistent-qual
    replay, no row writes), so N hosts sharing one stream pay ~1/N of
    the full parse cost instead of N full decodes. The reference's mux
    serializes only the pair hand-off, never the parsing
    (mux.c:132-161); skip preserves every cross-batch semantic (error
    position, NODATA counting, stream flags, stale-qual tails), so
    claimed batches are bit-identical to the decode-everything layout.
    The ring needs to cover only CLAIMED batches in flight — skipped
    batches occupy no slots."""
    try:
        from ..io import native
        if native.get_lib() is None:
            raise RuntimeError
    except (RuntimeError, OSError):
        for i, b in enumerate(_batches_of(fwd, rev, batch, L,
                                          ring=ring)):
            if i % n_claim == claim and i > start_after:
                yield i, b
        return
    rdr = native.NativeBatchReader(fwd, rev, batch=batch, L=L, ring=ring)
    i = 0
    while True:
        if i % n_claim == claim and i > start_after:
            try:
                b = next(rdr)
            except StopIteration:
                break
            yield i, b
        elif rdr.skip_batch() == 0:
            break
        i += 1


def _batches_of(fwd, rev, batch, L, ring=28):
    try:
        from ..io import native
        if native.get_lib() is None:
            raise RuntimeError
        # ring: prefetch(8) + pipeline depth(6) + dispatch group(4) +
        # consumer < 28 batches in flight; persistent decode buffers.
        # CALLERS THAT SKIP BATCHES (mux round-robin claims) must scale
        # ring by the claim stride: the decoder cycles one slot per
        # DECODED batch, so n_claim-strided consumption holds each
        # claimed batch across n_claim slot reuses (a 5M-pair mux run
        # silently corrupted ~36k records before this was sized right;
        # the engine now also hard-fails on overrun).
        yield from native.NativeBatchReader(fwd, rev, batch=batch, L=L,
                                            ring=ring)
    except (RuntimeError, OSError):
        from ..io import fastq as fq
        reader = fq.read_pairs(fwd, rev)
        done = False
        while not done:
            chunk = []
            while len(chunk) < batch:
                try:
                    chunk.append(next(reader))
                except (StopIteration, fq.StreamError):
                    done = True
                    break
            if chunk:
                yield chunk


def run_distributed(inputs, cfg=None, out_dir: str = ".",
                    batch: int = 4096, L: int = 512, modules=(),
                    checkpoint: str | None = None, fastq: bool = False,
                    op: int = 1, perf_out: dict | None = None,
                    group: int = 4, depth: int = 6):
    """Assemble a list of (fwd, rev) FASTQ pairs across all processes.

    Returns (counters vector, histogram) reduced over every process; each
    module object's ``rejected`` is replaced by its global total. Output
    is written per process to out_dir/part-<rank>.fasta (or .fastq).

    The per-process loop is the byte fast path of the CLI
    (``emit_stream``) whenever the config allows it, else the general
    per-record path. With fewer file pairs than processes, each pair's
    batch stream is claimed round-robin across the processes sharing it.
    A process that sees more than one card (``PANDASEQ_TORCH_DEVICE``
    cuda) builds a local mesh over them (``op`` splits the overlap-plane
    rows). ``perf_out`` (optional dict) receives this process's wall
    seconds, pair count and pairs/s."""
    import time as _time

    from .. import oracle, runtime
    from ..assembler import BatchAssembler
    from ..io import native as _native
    from ..io import output as out_mod
    from ..io.prefetch import prefetch
    from .shard import make_mesh

    pidx, pcount = maybe_initialize_distributed()
    inputs = list(inputs)
    cfg = cfg or oracle.OracleConfig()
    if len(inputs) >= pcount:
        my_inputs = [(i, pair, 0, 1)
                     for i, pair in enumerate(inputs)
                     if i % pcount == pidx]
    else:
        # mux mode: processes gang up on the (few) streams; process p
        # serves stream p % n_inputs and claims batches round-robin among
        # the processes on the same stream
        n_in = len(inputs)
        shard_no = pidx % n_in
        consumers = [p for p in range(pcount) if p % n_in == shard_no]
        my_inputs = [(shard_no, inputs[shard_no],
                      consumers.index(pidx), len(consumers))]
    mesh = None
    if runtime.resolve_device().type == "cuda" and \
            torch.cuda.device_count() > 1:
        mesh = make_mesh(torch.cuda.device_count(), op=op)
    asm = BatchAssembler(cfg, L=L, modules=list(modules), mesh=mesh)
    fmt = out_mod.format_fastq if fastq else out_mod.format_fasta
    if checkpoint and pcount > 1:
        checkpoint = "%s.%05d" % (checkpoint, pidx)  # per-process sidecar
    ck = ShardCheckpoint(checkpoint)

    # byte fast path eligibility: the CLI's rule (cli/main.py use_emit)
    use_emit = (not cfg.post_primers and _native.get_lib() is not None
                and all(m.check is None or m.check_batch is not None
                        for m in asm.modules))
    emit_fmt = "fastq" if fastq else "fasta"

    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "part-%05d.%s" % (pidx, emit_fmt))
    mode = "ab" if checkpoint and os.path.exists(out_path) else "wb"
    t0 = _time.perf_counter()
    n_pairs = 0
    with open(out_path, mode) as out:
        for shard_no, (fwd, rev), claim, n_claim in my_inputs:
            start_after = ck.watermark(shard_no)
            # unclaimed / pre-watermark batches are decode-skipped in the
            # generator, on the prefetch thread; only claimed batches
            # occupy ring slots
            stream = prefetch(_claimed_batches(
                fwd, rev, batch, L, claim, n_claim, start_after,
                ring=2 * depth + group + 16))
            idx_iter = []

            def tagged():
                for i, b in stream:
                    idx_iter.append(i)
                    yield b

            if use_emit:
                for _, codes, payload in asm.emit_stream(
                        prefetch(asm.pre_stream(tagged()), depth=depth
                                 + 2),
                        fmt=emit_fmt, depth=depth, threaded=True,
                        group=group):
                    batch_no = idx_iter.pop(0)
                    n_pairs += len(codes)
                    out.write(payload)
                    out.flush()
                    ck.record(shard_no, batch_no)
            else:
                for _, results in asm.assemble_stream(tagged(),
                                                      group=group):
                    batch_no = idx_iter.pop(0)
                    n_pairs += len(results)
                    for code, res in results:
                        if code == "OK":
                            out.write(fmt(res))
                    out.flush()
                    ck.record(shard_no, batch_no)

    if perf_out is not None:
        wall = _time.perf_counter() - t0
        perf_out.update(process=pidx, pairs=n_pairs, wall_s=wall,
                        pairs_per_sec=(n_pairs / wall if wall else 0.0))
    return reduce_counters(asm.counters, asm.counters.overlaps,
                           asm.modules)
