"""Runtime knobs of the PyTorch port: device resolution, the engine
probe and profiling.

Counterpart of ``pandaseq_tpu/runtime.py``. ``PANDASEQ_TORCH_DEVICE``
(default ``cuda``) plays the part of the JAX package's ``JAX_PLATFORMS``
switch: ``cuda`` runs the device steps in the CUDA kernels, ``cpu`` runs
the plain PyTorch twins. Asking for ``cuda`` where no card is visible
raises; nothing falls back to the CPU. There is no compilation cache:
PyTorch runs eagerly, and the kernels are built once per source version
(ops/_build.py).
"""

from __future__ import annotations

import json
import os
import time

import torch

from ._paths import build_root

# device-side runs of one probe: one warm-up (the kernels' first build
# lands there), then the best of PROBE_REPS timed runs on each side
PROBE_REPS = 3
PROBE_RUNS = 1 + PROBE_REPS
PROBE_CACHE = "engine_probe_torch.json"
LOCK_TIMEOUT = 600.0  # seconds to wait for another process's probe


def resolve_device(device=None) -> torch.device:
    """The torch device for the candidate search: ``device`` if given,
    else ``PANDASEQ_TORCH_DEVICE``, else ``cuda``."""
    name = device if device is not None else \
        os.environ.get("PANDASEQ_TORCH_DEVICE", "cuda")
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device %r requested but torch.cuda.is_available() is "
                "False (set PANDASEQ_TORCH_DEVICE=cpu to run the plain "
                "PyTorch twins on the CPU)" % str(name))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError("unsupported device %r (cuda or cpu)" % str(name))
    return dev


def _probe_key(device, L, O, num_kmers) -> str:
    import multiprocessing
    import platform
    return "%s:%s:%d:L%d:O%d:k%d" % (
        torch.cuda.get_device_name(device), platform.node(),
        multiprocessing.cpu_count(), L, O, num_kmers)


def _read_cache(path) -> dict:
    try:
        with open(path) as fh:
            return json.load(fh)
    except FileNotFoundError:
        return {}


def _flock(fh, timeout):
    """Take an exclusive flock on ``fh``, waiting at most ``timeout``
    seconds; raises TimeoutError when the wait runs out."""
    import fcntl
    deadline = time.monotonic() + timeout
    while True:
        try:
            fcntl.flock(fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
            return
        except BlockingIOError:
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    "another process held the engine-probe lock %s for "
                    "%.0f s; pin PANDASEQ_TPU_ENGINE=host|tpu to skip "
                    "the probe" % (fh.name, timeout)) from None
            time.sleep(0.05)


def _best_of(fn, n=PROBE_REPS):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def _probe_batch(B: int, L: int):
    """Synthetic reversed-frame Batch of ~250 bp ACGT pairs for the
    engine probe (deterministic; no N bases, so pack4 flags no rows).
    The JAX package's ``runtime._probe_batch``."""
    import numpy as np

    from .assembler import Batch
    rng = np.random.default_rng(7)
    codes = np.array([1, 2, 4, 8], dtype=np.int8)  # A C G T one-hot
    fwd = codes[rng.integers(0, 4, size=(B, L))]
    rev = codes[rng.integers(0, 4, size=(B, L))]
    lens = rng.integers(240, 251, size=B).astype(np.int32)
    pos = np.arange(L)[None, :]
    fwd[pos >= lens[:, None]] = 0
    rev[pos >= lens[:, None]] = 0
    q = np.full((B, L), 30, dtype=np.int8)
    return Batch([None] * B, fwd, q, rev, q, lens, lens.copy(), None)


def _measure(device, L, O, num_kmers, B):
    """(host seconds, device seconds) of one batch's candidate masks:
    the native twin psq_cand_mask against the engine's device side end
    to end — psq_pack4, the pinned upload, the kernels, the fetch, the
    mask rebuilt from the list and the host fix-up of its count > C
    rows, as the engine pays them per batch."""
    import numpy as np

    from .assembler import BatchAssembler
    from .io import native
    from .oracle import OracleConfig

    batch = _probe_batch(B, L)
    rows = np.arange(B, dtype=np.int64)
    t_host = _best_of(lambda: native.cand_mask(batch, rows, num_kmers, O))

    cfg = OracleConfig()
    cfg.num_kmers = num_kmers
    asm = BatchAssembler(cfg, L=L, host_only=False, device=device)

    def device_side():
        st = {"batch": batch, "B": B, "Lb": L, "O": O}
        plane = asm._sparse_plane(st)
        out = asm._launch(True, False, plane, batch.flen, batch.rlen,
                          None, None, L, O)
        if asm._cand_list:
            mask = asm._mask_from_list(st, out)
        else:
            mask = np.array(out)
        fix = st["hasN_rows"]
        if len(fix):
            mask[fix] = native.cand_mask(batch, fix, num_kmers, O)
        return mask

    device_side()  # warm-up: the kernels' build, the first launch
    return t_host, _best_of(device_side)


def pick_engine(device, L: int = 256, O: int = 256, num_kmers: int = 2,
                B: int = 4096, refresh: bool = False,
                lock_timeout: float = LOCK_TIMEOUT):
    """Measured choice between the device step and the native host twin
    (the JAX package's runtime.pick_engine). The engine asks for it only
    under PANDASEQ_TPU_ENGINE=auto: unpinned, a CUDA device serves the
    device engine without a probe (assembler.py _resolve_host_only).

    Returns (engine, info), engine "device" or "host". Shortcuts: no
    native library means the device (there is no host twin); a CPU
    device means host (the native twin, not the plain PyTorch twins, is
    the CPU's engine). On a card the probe times both sides end to end
    on one synthetic batch (see _measure) and caches the verdict per
    (card, host, cores, L, O, k) in ``engine_probe_torch.json`` under
    ``_paths.build_root()`` (PANDASEQ_TPU_CACHE, else build/ in a
    checkout, else ~/.cache/pandaseq_tpu_torch), so it runs
    once per environment. Concurrent probes serialise on a flock whose
    wait raises TimeoutError after ``lock_timeout`` seconds. A device
    error inside the probe raises: nothing hides the device."""
    from .io import native
    if native.get_lib() is None:
        return "device", {"reason": "no-native"}
    device = torch.device(device)
    if device.type == "cpu":
        return "host", {"reason": "cpu-device"}

    key = _probe_key(device, L, O, num_kmers)
    cache_dir = build_root()
    cache = os.path.join(cache_dir, PROBE_CACHE)
    data = _read_cache(cache)
    if not refresh and key in data:
        return data[key]["engine"], dict(data[key], cached=True)
    os.makedirs(cache_dir, exist_ok=True)
    with open(cache + ".lock", "a+") as lock_fh:
        _flock(lock_fh, lock_timeout)  # released when lock_fh closes
        data = _read_cache(cache)  # another process may have probed
        if not refresh and key in data:
            return data[key]["engine"], dict(data[key], cached=True)
        import sys
        print("pandaseq_tpu_torch: probing the candidate-search engines "
              "of this environment (once; pin PANDASEQ_TPU_ENGINE="
              "host|tpu to skip)", file=sys.stderr, flush=True)
        t_host, t_dev = _measure(device, L, O, num_kmers, B)
        info = {"engine": "host" if t_host < t_dev else "device",
                "host_ms": t_host * 1e3, "device_ms": t_dev * 1e3,
                "B": B, "reason": "probe"}
        data[key] = info
        tmp = "%s.%d.tmp" % (cache, os.getpid())
        with open(tmp, "w") as fh:
            json.dump(data, fh, indent=1)
        os.replace(tmp, cache)
        return info["engine"], dict(info)


def describe(info) -> str:
    """The engine's provenance for the INFO ENGINE line: the reason,
    with the probe's measured host and device times."""
    if info.get("reason") != "probe":
        return info.get("reason", "auto")
    return "probe%s: host %.3f ms, device %.3f ms" % (
        ", cached" if info.get("cached") else "", info["host_ms"],
        info["device_ms"])


class maybe_profile:
    """torch.profiler trace over a run when PANDASEQ_TPU_PROFILE=<dir>
    is set: CPU activity, plus the card's when one is visible, written
    as a Chrome trace ``<dir>/trace-<pid>.json`` on exit."""

    def __init__(self, trace_dir: str | None = None):
        self.dir = trace_dir or os.environ.get("PANDASEQ_TPU_PROFILE")
        self.prof = None

    def __enter__(self):
        if self.dir:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*(exc or (None, None, None)))
            os.makedirs(self.dir, exist_ok=True)
            self.prof.export_chrome_trace(
                os.path.join(self.dir, "trace-%d.json" % os.getpid()))
            self.prof = None
        return False
