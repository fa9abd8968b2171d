"""Wrappers of the dense shortlist path's CUDA kernels: the N-aware
k-mer frames (csrc/kmer_frames.cu, ``psq_cuda_kmer_frames_nt``), the
per-diagonal counts (csrc/counts.cu) and the shortlist
(csrc/shortlist.cu) — the counterpart of ``pandaseq_tpu/ops/fused2.py``
``kmer_frames``, ``plane_counts`` and ``shortlist_from_counts``.

As in ``ops/cand.py``: each wrapper checks device, dtype, shape and
contiguity and raises on what its kernel does not take, allocates the
outputs with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch reports a CUDA error, and adds one
to its launch count (``cand.launch_counts()``) where it launches and
nowhere else. They take CUDA tensors only: the plain twins for the CPU
are ``plain_kmer_frames_nt``, ``plain_counts`` and ``plain_shortlist``
in ``ops/fused2.py``.
"""

from __future__ import annotations

import torch

from . import _build
from .cand import MAX_WIDTH, _check, _launched, _raise_on

SCORE_KINDS = {"counts": 0, "ea_util": 1, "flash": 2, "stitch": 3}
MAX_SL = 32  # shared-memory shortlist slots of the shortlist kernel


def _cuda(t, name):
    dev = t.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on a CUDA device, not {dev}")
    return dev


def kmer_frames_nt(nt, flen, rlen, L, num_kmers):
    """(Fkm, Rkm) [B, L] int32 on the card from the nibble-packed plane
    nt [B, L] int8 (forward read in the low nibble) and flen/rlen [B]
    int32, with the true N positions (twin:
    fused2.plain_kmer_frames_nt)."""
    dev = _cuda(nt, "kmer_frames_nt")
    if not 9 <= L <= MAX_WIDTH:
        raise ValueError(f"frame width {L} must be in [9, {MAX_WIDTH}]")
    if num_kmers < 0:
        raise ValueError(f"num_kmers must be >= 0, got {num_kmers}")
    B = nt.shape[0]
    _check(nt, "nt", torch.int8, (B, L), dev)
    _check(flen, "flen", torch.int32, (B,), dev)
    _check(rlen, "rlen", torch.int32, (B,), dev)
    Fkm = torch.empty((B, L), dtype=torch.int32, device=dev)
    Rkm = torch.empty((B, L), dtype=torch.int32, device=dev)
    if B:
        lib = _build.load()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.psq_cuda_kmer_frames_nt(
            nt.data_ptr(), flen.data_ptr(), rlen.data_ptr(),
            Fkm.data_ptr(), Rkm.data_ptr(), B, L, int(num_kmers), stream)
        _raise_on(lib, err, "kmer_frames_nt")
        _launched("kmer_frames_nt")
    return Fkm, Rkm


def counts(nt, Fkm, Rkm, O):
    """(m, unk, candc) [B, O] int32 on the card: the exact match, N and
    k-mer hit counts of every diagonal t < O (twin:
    fused2.plain_counts)."""
    dev = _cuda(nt, "counts")
    B, ld = nt.shape
    if O % 32 or not 0 < O <= min(ld, MAX_WIDTH):
        raise ValueError(f"O={O} must be a multiple of 32 in "
                         f"(0, min({ld}, {MAX_WIDTH})]")
    _check(nt, "nt", torch.int8, (B, ld), dev)
    _check(Fkm, "Fkm", torch.int32, (B, ld), dev)
    _check(Rkm, "Rkm", torch.int32, (B, ld), dev)
    m, unk, candc = (torch.empty((B, O), dtype=torch.int32, device=dev)
                     for _ in range(3))
    if B:
        lib = _build.load()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.psq_cuda_counts(nt.data_ptr(), Fkm.data_ptr(),
                                  Rkm.data_ptr(), B, ld, O, m.data_ptr(),
                                  unk.data_ptr(), candc.data_ptr(), stream)
        _raise_on(lib, err, "counts")
        _launched("counts")
    return m, unk, candc


def shortlist(m, unk, candc, flen, rlen, fo, ro, *, O, SL, minoverlap,
              maxoverlap, algo_kind, pmatch, pmismatch, nn, band):
    """[B, 2*SL + 4] int32 on the card: f32 scores, range rules and the
    winner / top-SL shortlist from the count sums (twin:
    fused2.plain_shortlist)."""
    dev = _cuda(m, "shortlist")
    if algo_kind not in SCORE_KINDS:
        raise ValueError(f"score kind {algo_kind!r} is not one of "
                         f"{sorted(SCORE_KINDS)}")
    B = m.shape[0]
    if not 0 < O <= MAX_WIDTH:
        raise ValueError(f"O={O} must be in (0, {MAX_WIDTH}]")
    if not 0 < SL <= min(O, MAX_SL):
        raise ValueError(f"SL={SL} must be in (0, min({O}, {MAX_SL})]")
    for t, name in ((m, "m"), (unk, "unk"), (candc, "candc")):
        _check(t, name, torch.int32, (B, O), dev)
    for t, name in ((flen, "flen"), (rlen, "rlen"), (fo, "fo"),
                    (ro, "ro")):
        _check(t, name, torch.int32, (B,), dev)
    out = torch.empty((B, 2 * SL + 4), dtype=torch.int32, device=dev)
    if B:
        lib = _build.load()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.psq_cuda_shortlist(
            m.data_ptr(), unk.data_ptr(), candc.data_ptr(),
            flen.data_ptr(), rlen.data_ptr(), fo.data_ptr(), ro.data_ptr(),
            B, O, SL, int(minoverlap), int(maxoverlap),
            SCORE_KINDS[algo_kind], float(pmatch), float(pmismatch),
            float(nn), float(band), out.data_ptr(), stream)
        _raise_on(lib, err, "shortlist")
        _launched("shortlist")
    return out
