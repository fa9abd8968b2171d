"""Background-thread batch prefetch — the reference's async reader
(async.c: a producer pthread filling a bounded slot queue) mapped onto
the batch pipeline: host decode for batch k+2 proceeds while batch k+1
sits on the device and batch k finalizes.

The PyTorch port's copy of ``pandaseq_tpu/io/prefetch.py``, unchanged but for its
imports and the consumer's ``wait.prefetch`` span (tracing.py); the port
imports nothing of ``pandaseq_tpu``.
"""

from __future__ import annotations

import queue
import threading

from .. import tracing

_SENTINEL = object()


def prefetch(iterable, depth: int = 4):
    """Iterate ``iterable`` on a daemon thread, ``depth`` items ahead
    (async.c:202-207 uses 4*threads slots).

    Closing/abandoning the returned generator cancels the worker: it
    stops producing, closes the source generator (releasing e.g. a
    NativeBatchReader's file handles and ring buffers) and exits —
    otherwise an aborted consumer would leak a thread blocked on
    q.put holding the reader open for the process lifetime."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    cancel = threading.Event()
    exc = []

    def put(item) -> bool:
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not put(item):
                    break
        except BaseException as e:  # re-raised on the consumer side
            exc.append(e)
        finally:
            if cancel.is_set() and hasattr(iterable, "close"):
                try:  # the worker owns iteration, so close() is safe
                    iterable.close()
                except Exception:
                    pass
            put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            sp = tracing.begin("wait.prefetch") if tracing.ON else None
            item = q.get()
            if sp is not None:
                tracing.end(sp)
            if item is _SENTINEL:
                if exc:
                    raise exc[0]
                return
            yield item
    finally:
        cancel.set()
