"""Wrappers of the sparse path's CUDA kernels — the counterpart of
``pandaseq_tpu/ops/pallas_cand.py`` — and the launch counts of every
kernel of the port (the dense path's wrappers are in ``ops/dense.py``).

``candidates_join`` (csrc/cand_join.cu) is the candidate search of every
path: frames, rank and hit search of a pair in one sort-join kernel, on
the 4-bit packed plane or, ``nt=True``, the nibble plane with N.

Each wrapper checks device, dtype, shape and contiguity and raises on
what its kernel does not take, allocates the outputs with
``torch.empty``, launches on the current stream of the tensors' card
with that card made the current device (``_launch``; CUDA refuses a
launch into another device's stream) without synchronising, and raises
if the launch reports a CUDA error. Each adds one to its
launch count where it launches, and nowhere else, so a run can show that
the main path went through the kernel. They take CUDA tensors only: the
plain twins for the CPU live in ``ops/fused2.py``.
"""

from __future__ import annotations

import threading

import torch

from . import _build

KERNELS = ("cand_join", "counts", "shortlist", "lut_sums")
# launches of each kernel since the last reset_launch_counts()
_LAUNCHES = dict.fromkeys(KERNELS, 0)
# the engine's offload lane launches from its own threads
_COUNT_LOCK = threading.Lock()

_MODES = {"list": 0, "mask": 1}
MAX_WIDTH = 1024  # shared-memory rows of every kernel


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in KERNELS:
            _LAUNCHES[name] = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def _check(t, name, dtype, shape, device):
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{name} must be a tensor on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(dev, kernel, *args, entry=None) -> None:
    """Launch ``kernel`` through its entry point ``psq_cuda_<entry>``
    (``entry`` defaults to the kernel's name) with ``args`` and the
    current stream of ``dev``, with ``dev`` the current device; raise on
    a CUDA error, else count the launch."""
    lib = _build.load()
    with torch.cuda.device(dev):
        err = getattr(lib, "psq_cuda_" + (entry or kernel))(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = lib.psq_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({err})")
    with _COUNT_LOCK:
        _LAUNCHES[kernel] += 1


def candidates_join(plane, flen, rlen, L, O, num_kmers, mode, C, nt=False):
    """Candidate list ([B, C+2] int16, ``mode="list"``) or bitmask
    ([B, O//32] int32, ``mode="mask"``) on the card, over the whole
    plane, straight from the 4-bit packed plane4 [B, L/2] int8
    (every base taken as non-N) or, with ``nt``, the nibble-packed plane
    [B, L] int8 with the true N positions; flen/rlen [B] int32 (plain
    version: fused2.plain_candidates_join)."""
    dev = plane.device
    if dev.type != "cuda":
        raise ValueError(f"candidates_join runs on a CUDA device, not {dev}")
    if mode not in _MODES:
        raise ValueError(f"unknown candidate mode {mode!r}")
    if nt:
        if not 9 <= L <= MAX_WIDTH:
            raise ValueError(f"frame width {L} must be in [9, {MAX_WIDTH}]")
    elif L % 8 or not 0 < L <= MAX_WIDTH:
        raise ValueError(f"frame width {L} must be a multiple of 8 in "
                         f"(0, {MAX_WIDTH}]")
    if O % 32 or not 0 < O <= L:
        raise ValueError(f"O={O} must be a multiple of 32 in (0, {L}]")
    if mode == "list" and not 0 < C <= O:
        raise ValueError(f"C={C} must be in (0, {O}]")
    if num_kmers < 0:
        raise ValueError(f"num_kmers must be >= 0, got {num_kmers}")
    B = plane.shape[0]
    _check(plane, "plane", torch.int8, (B, L if nt else L // 2), dev)
    _check(flen, "flen", torch.int32, (B,), dev)
    _check(rlen, "rlen", torch.int32, (B,), dev)
    if mode == "list":
        out = torch.empty((B, C + 2), dtype=torch.int16, device=dev)
    else:
        out = torch.empty((B, O // 32), dtype=torch.int32, device=dev)
    if B:
        _launch(dev, "cand_join", plane.data_ptr(), flen.data_ptr(),
                rlen.data_ptr(), B, L, O, int(num_kmers), _MODES[mode],
                int(C), out.data_ptr(),
                entry="cand_join_nt" if nt else None)
    return out

