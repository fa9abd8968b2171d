"""Host spans of the traced run, taken from the benchmark's own files.

The port has no spans of its own yet, so in a traced run (``--trace 1``)
the harness wraps the calls below for the window alone, and each call
appends ``(name, thread, start, end)`` on ``time.perf_counter``:

- ``decode``: ``io.native.NativeBatchReader.__next__``, the native
  decode of one batch (the prefetch thread);
- ``pre``: ``assembler.BatchAssembler._pre``, the badread gates and the
  primer scans (the prefetch thread);
- ``launch``: ``BatchAssembler._launch``, the upload, the device step
  and the queued download (the main thread); each call also records the
  batch's shape for ``roofline``;
- ``finalize``: ``BatchAssembler._finalize``, the native finalizer and
  the emit (the finalize worker).

The harness adds ``job`` around each CLI call.
"""

from __future__ import annotations

import threading
import time

import numpy as np


class Spans:
    def __init__(self):
        self.log = []  # (name, thread ident, start, end)
        self.launches = []  # (sparse, B, Lb, O, k-mers emitted)
        self._saved = []

    def _wrap(self, cls, attr, name, on_call=None):
        orig = getattr(cls, attr)
        log = self.log

        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                log.append((name, threading.get_ident(), t0,
                            time.perf_counter()))
                if on_call is not None:
                    on_call(*a, **kw)

        self._saved.append((cls, attr, orig))
        setattr(cls, attr, wrapper)

    def _launch(self, asm, sparse, lut, plane, flen, rlen, fo32, ro32, Lb,
                O):
        self.launches.append((bool(sparse), len(flen), int(Lb), int(O),
                              emitted(flen, Lb) + emitted(rlen, O)))

    def install(self):
        from pandaseq_tpu_torch.assembler import BatchAssembler
        from pandaseq_tpu_torch.io.native import NativeBatchReader
        self._wrap(NativeBatchReader, "__next__", "decode")
        self._wrap(BatchAssembler, "_pre", "pre")
        self._wrap(BatchAssembler, "_launch", "launch", self._launch)
        self._wrap(BatchAssembler, "_finalize", "finalize")

    def uninstall(self):
        while self._saved:
            cls, attr, orig = self._saved.pop()
            setattr(cls, attr, orig)

    def total(self, name) -> float:
        return sum(t1 - t0 for n, _, t0, t1 in self.log if n == name)


def emitted(lens, L) -> int:
    """k-mers the candidate search emits over a batch for reads of
    ``lens`` in a frame of L: positions 0 .. min(len, L) - 9 (chip_smoke's
    ``emitted``)."""
    lens = np.asarray(lens, dtype=np.int64)
    return int(np.clip(np.minimum(lens, L) - 8, 0, None).sum())
