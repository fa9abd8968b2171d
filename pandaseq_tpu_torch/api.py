"""Library API of the PyTorch port: the PandaAssembler surface
(pandaseq-assembler.h) over the port's batch engine, whose candidate
search runs on ``device`` (default: PANDASEQ_TORCH_DEVICE, else cuda).

The reference exposes a refcounted PandaAssembler with ~30
getters/setters, a pull loop (panda_assembler_next) and a single-pair
entry point (panda_assembler_assemble, pandaseq-assembler.h:134). Here
the same surface wraps the batched device pipeline; single-pair calls go
through the exact numpy oracle (bit-identical, just not batched).

Example
-------
>>> import pandaseq_tpu_torch as pt
>>> asm = pt.Assembler(device="cuda")
>>> asm.algorithm = "pear"
>>> asm.minimum_overlap = 10
>>> for result in asm.stream("fwd.fastq", "rev.fastq"):
...     print(result.sid, result.sequence)

The PyTorch port's copy of ``pandaseq_tpu/api.py``, with the engine's
device as its one new argument; the port imports nothing of
``pandaseq_tpu``.
"""

from __future__ import annotations

import math
import os

import numpy as np

from . import filters as filters_mod
from . import oracle
from .assembler import BatchAssembler
from .io import native
from .nt import nt_from_ascii, nt_from_ascii_complement, nt_to_ascii


class Assembler:
    """panda_assembler_* equivalent over the batched pipeline, whose
    candidate search runs on ``device``."""

    def __init__(self, cfg: oracle.OracleConfig | None = None,
                 L: int = 512, batch: int = 1024, device=None):
        self.cfg = cfg or oracle.OracleConfig()
        self.L = L
        self.batch = batch
        self.device = device
        self.modules = []
        self._engine = None
        self._on_fail = None

    # -- configuration surface (assembler_support.c getters/setters) --
    @property
    def algorithm(self):
        return self.cfg.algorithm.name

    @algorithm.setter
    def algorithm(self, value):
        if isinstance(value, str):
            name, _, arg = value.partition(":")
            self.cfg.algorithm = oracle.make_algorithm(name, arg or None)
        else:
            self.cfg.algorithm = value
        self._engine = None

    @property
    def threshold(self):
        """Probability threshold (stored in log space like the C
        assembler; exposed linear like panda_assembler_set_threshold)."""
        return math.exp(self.cfg.threshold)

    @threshold.setter
    def threshold(self, value):
        self.cfg.threshold = math.log(value)

    @property
    def minimum_overlap(self):
        return self.cfg.minoverlap

    @minimum_overlap.setter
    def minimum_overlap(self, value):
        # panda_assembler_set_minimum_overlap silently ignores values
        # outside (1, 2*MAX_LEN) (assembler_support.c:276-282)
        if int(value) > 1 and int(value) < 2 * 450:
            self.cfg.minoverlap = int(value)

    @property
    def maximum_overlap(self):
        return self.cfg.maxoverlap

    @maximum_overlap.setter
    def maximum_overlap(self, value):
        # setter guard (assembler_support.c:289-295): silently ignores
        # values outside [0, 2*MAX_LEN)
        if 0 <= int(value) < 2 * 450:
            self.cfg.maxoverlap = int(value)

    @property
    def num_kmers(self):
        return self.cfg.num_kmers

    @num_kmers.setter
    def num_kmers(self, value):
        self.cfg.num_kmers = int(value)

    @property
    def primer_penalty(self):
        return self.cfg.primer_penalty

    @primer_penalty.setter
    def primer_penalty(self, value):
        self.cfg.primer_penalty = float(value)

    @property
    def primers_after(self):
        return self.cfg.post_primers

    @primers_after.setter
    def primers_after(self, value):
        self.cfg.post_primers = bool(value)

    def set_forward_primer(self, primer: str | None):
        """panda_assembler_set_forward_primer; None clears."""
        self.cfg.forward_primer = None if primer is None else \
            nt_from_ascii(np.frombuffer(primer.encode(), dtype=np.uint8))

    def set_reverse_primer(self, primer: str | None):
        """Reverse primers are stored complemented (args_assembler.c:221)."""
        self.cfg.reverse_primer = None if primer is None else \
            nt_from_ascii_complement(
                np.frombuffer(primer.encode(), dtype=np.uint8))

    def set_forward_trim(self, n: int):
        self.cfg.forward_trim = int(n)

    def set_reverse_trim(self, n: int):
        self.cfg.reverse_trim = int(n)

    def add_module(self, module):
        """panda_assembler_add_module; accepts Module or 'name:args'."""
        if isinstance(module, str):
            from . import stats
            module = filters_mod.load_module(module, stats.LogProxy())
        self.modules.append(module)
        self._engine = None

    def set_fail_alignment(self, callback):
        """panda_assembler_set_fail_alignment
        (pandaseq-assembler.h:224): ``callback(pair)`` is invoked for
        every pair whose alignment fails (NOALGN) during stream()."""
        self._on_fail = callback

    def copy_configuration(self, src: "Assembler"):
        """panda_assembler_copy_configuration
        (assembler_support.c:119-137): copy modules, primers, trims,
        threshold, overlap bounds, post_primers mode, the algorithm
        object (shared by reference, like panda_algorithm_ref), and the
        primer penalty from ``src``. Counters are NOT copied."""
        for m in src.modules:
            self.modules.append(m)
        self.cfg.forward_primer = None if src.cfg.forward_primer is None \
            else src.cfg.forward_primer.copy()
        self.cfg.reverse_primer = None if src.cfg.reverse_primer is None \
            else src.cfg.reverse_primer.copy()
        self.cfg.forward_trim = src.cfg.forward_trim
        self.cfg.reverse_trim = src.cfg.reverse_trim
        self.cfg.threshold = src.cfg.threshold
        self.cfg.minoverlap = src.cfg.minoverlap
        self.cfg.maxoverlap = src.cfg.maxoverlap
        self.cfg.post_primers = src.cfg.post_primers
        self.cfg.algorithm = src.cfg.algorithm
        self.cfg.primer_penalty = src.cfg.primer_penalty
        self.cfg.num_kmers = src.cfg.num_kmers
        self._engine = None

    # -- counters (panda_assembler_get_*_count,
    #    pandaseq-assembler.h:208-385) --
    @property
    def counters(self):
        return self._ensure_engine().counters

    @property
    def count(self):
        return self.counters.count

    @property
    def ok_count(self):
        return self.counters.ok

    @property
    def low_quality_count(self):
        return self.counters.lowq

    @property
    def bad_read_count(self):
        return self.counters.badread

    @property
    def failed_alignment_count(self):
        return self.counters.noalgn

    @property
    def no_forward_primer_count(self):
        return self.counters.nofp

    @property
    def no_reverse_primer_count(self):
        return self.counters.norp

    @property
    def slow_count(self):
        return self.counters.slow

    @property
    def overlap_count(self):
        """panda_assembler_get_overlap_count: histogram {overlap: n}."""
        return dict(self.counters.overlaps)

    @property
    def longest_overlap(self):
        """panda_assembler_get_longest_overlap (assembler.h:75 bound)."""
        h = self.counters.overlaps
        return max(h) if h else 0

    # -- assembly --
    def _ensure_engine(self) -> BatchAssembler:
        if self._engine is None:
            self._engine = BatchAssembler(self.cfg, L=self.L,
                                          modules=self.modules,
                                          device=self.device)
        return self._engine

    def assemble(self, sid, forward: str, reverse: str):
        """panda_assembler_assemble (single pair, exact host path).

        forward/reverse are ascii sequences; qualities default to PHRED
        40 unless (seq, qual) tuples are given.
        """
        def decode(read, table):
            if isinstance(read, tuple):
                seq, qual = read
                q = np.frombuffer(qual.encode(), dtype=np.uint8) - 33
            else:
                seq = read
                q = np.full(len(seq), 40, dtype=np.int64)
            nt = table(np.frombuffer(seq.encode(), dtype=np.uint8))
            buf_nt = np.zeros(oracle.MAX_LEN, dtype=np.int8)
            buf_q = np.zeros(oracle.MAX_LEN, dtype=np.int8)
            n = min(len(seq), oracle.MAX_LEN)
            buf_nt[:n] = nt[:n]
            buf_q[:n] = np.clip(q[:n], 0, 46)
            return buf_nt, buf_q, n

        fnt, fq, flen = decode(forward, nt_from_ascii)
        rnt, rq, rlen = decode(reverse, nt_from_ascii_complement)

        class _Pair:
            pass

        p = _Pair()
        p.sid, p.fwd_nt, p.fwd_q, p.flen = sid, fnt, fq, flen
        p.rev_nt, p.rev_q, p.rlen = rnt, rq, rlen
        res, code = oracle.assemble(self.cfg, p)
        if code != "OK":
            return None, code
        res.sequence = nt_to_ascii(
            res.sequence_nt[:res.sequence_length]).tobytes().decode()
        return res, code

    def assemble_batch(self, pairs):
        """Batched device path: list of ReadPair or a decoded Batch."""
        return self._ensure_engine().assemble_batch(pairs)

    def stream(self, fwd_path: str, rev_path: str, qualmin: int = 33,
               policy: str = "PRESENT"):
        """Iterate OK results over a paired FASTQ input (the
        panda_assembler_next pull loop, batched underneath)."""
        engine = self._ensure_engine()
        batches = native.NativeBatchReader(
            fwd_path, rev_path, qualmin=qualmin, policy=policy,
            batch=self.batch, L=self.L)
        group = int(os.environ.get("PANDASEQ_TPU_GROUP", "4"))
        for pairs, results in engine.assemble_stream(batches,
                                                     group=group):
            for pair, (code, res) in zip(pairs, results):
                if code == "OK":
                    yield res
                elif code == "NOALGN" and self._on_fail is not None:
                    self._on_fail(pair)
