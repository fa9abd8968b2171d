"""Wrappers of the dense shortlist path's CUDA kernels: the
per-diagonal counts with the N-aware k-mer frames fused in
(csrc/counts.cu), the per-diagonal LUT sums of pear and rdp_mle
(csrc/lut_sums.cu) and the shortlist (csrc/shortlist.cu) — the
counterpart of ``pandaseq_tpu/ops/fused2.py`` ``kmer_frames`` +
``plane_counts``, ``lut_plane_sums`` and ``shortlist_from_counts``.

As in ``ops/cand.py``: each wrapper checks device, dtype, shape and
contiguity and raises on what its kernel does not take, allocates the
outputs with ``torch.empty``, launches on the current stream of the
tensors' card with that card current (``cand._launch``) without
synchronising, raises if the launch reports a CUDA error, and adds one
to its launch count (``cand.launch_counts()``) where it launches and
nowhere else. They take CUDA tensors only: the plain twins for the CPU
are ``plain_counts``, ``plain_lut_sums`` and ``plain_shortlist`` in
``ops/fused2.py``.
"""

from __future__ import annotations

import torch

from .cand import MAX_WIDTH, _check, _launch
from .fused2 import QUAL_BINS

# score kinds of the shortlist kernel; pear and rdp_mle both score the
# LUT sums
SCORE_KINDS = {"counts": 0, "ea_util": 1, "flash": 2, "stitch": 3,
               "pear": 4, "rdp_mle": 4}
LUT_KINDS = {"pear": 0, "rdp_mle": 1}  # the lut_sums kernel's kinds
MAX_SL = 32  # the shortlist kernel keeps slot r in lane r of a warp


def _row_block(O, j0, Oj, empty=False):
    """Oj (None: the rest of the plane) after checking that the plane
    rows [j0, j0+Oj) lie in [0, O) and, unless ``empty``, are not
    empty."""
    if Oj is None:
        Oj = O - j0
    if not (0 <= j0 <= j0 + Oj <= O and (empty or Oj > 0)):
        raise ValueError(f"row block [{j0}, {j0}+{Oj}) is not inside "
                         f"[0, {O})")
    return Oj


def _cuda(t, name):
    dev = t.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on a CUDA device, not {dev}")
    return dev


def counts(nt, flen, rlen, L, O, num_kmers, j0=0, Oj=None, hit_rows=None):
    """(m, unk, candc) [B, O] int32 on the card: the exact match and N
    counts of every diagonal t < O over plane rows [j0, j0+Oj), and its
    k-mer hits over the rows ``hit_rows`` = (h0, Oh), [h0, h0+Oh), which
    may be empty (default: the same rows), straight from the
    nibble-packed plane nt [B, L] int8 (forward read in the low nibble)
    and flen/rlen [B] int32; the k-mer frames (stored forward k-mers of
    the whole read, N-aware) never leave the kernel, and with no hit rows
    the kernel skips its sort-join (twin: fused2.plain_counts)."""
    dev = _cuda(nt, "counts")
    if not 9 <= L <= MAX_WIDTH:
        raise ValueError(f"frame width {L} must be in [9, {MAX_WIDTH}]")
    if O % 32 or not 0 < O <= L:
        raise ValueError(f"O={O} must be a multiple of 32 in (0, {L}]")
    Oj = _row_block(O, j0, Oj)
    h0, Oh = (j0, Oj) if hit_rows is None else hit_rows
    Oh = _row_block(O, h0, Oh, empty=True)
    if num_kmers < 0:
        raise ValueError(f"num_kmers must be >= 0, got {num_kmers}")
    B = nt.shape[0]
    _check(nt, "nt", torch.int8, (B, L), dev)
    _check(flen, "flen", torch.int32, (B,), dev)
    _check(rlen, "rlen", torch.int32, (B,), dev)
    m, unk, candc = (torch.empty((B, O), dtype=torch.int32, device=dev)
                     for _ in range(3))
    if B:
        _launch(dev, "counts", nt.data_ptr(), flen.data_ptr(),
                rlen.data_ptr(), B, L, O, int(j0), int(Oj), int(h0), int(Oh),
                int(num_kmers), m.data_ptr(), unk.data_ptr(),
                candc.data_ptr())
    return m, unk, candc


def lut_sums(nt, fr_q, rr_q, flen, rlen, O, algo_kind, lut_match,
             lut_mismatch, nn_term, j0=0, Oj=None):
    """[B, O] float32 on the card: the per-diagonal sums of per-base LUT
    scores of pear / rdp_mle over plane rows [j0, j0+Oj), from the
    nibble plane nt and the qual planes fr_q / rr_q [B, ld] int8 and the
    tables lut_match / lut_mismatch [47, 47] float32 on the card (twin:
    fused2.plain_lut_sums)."""
    dev = _cuda(nt, "lut_sums")
    if algo_kind not in LUT_KINDS:
        raise ValueError(f"score kind {algo_kind!r} is not one of "
                         f"{sorted(LUT_KINDS)}")
    B, ld = nt.shape
    if O % 32 or not 0 < O <= min(ld, MAX_WIDTH):
        raise ValueError(f"O={O} must be a multiple of 32 in "
                         f"(0, min({ld}, {MAX_WIDTH})]")
    Oj = _row_block(O, j0, Oj)
    for t, name in ((nt, "nt"), (fr_q, "fr_q"), (rr_q, "rr_q")):
        _check(t, name, torch.int8, (B, ld), dev)
    _check(flen, "flen", torch.int32, (B,), dev)
    _check(rlen, "rlen", torch.int32, (B,), dev)
    for t, name in ((lut_match, "lut_match"),
                    (lut_mismatch, "lut_mismatch")):
        _check(t, name, torch.float32, (QUAL_BINS, QUAL_BINS), dev)
    out = torch.empty((B, O), dtype=torch.float32, device=dev)
    if B:
        _launch(dev, "lut_sums", nt.data_ptr(), fr_q.data_ptr(),
                rr_q.data_ptr(), flen.data_ptr(), rlen.data_ptr(), B, ld, O,
                LUT_KINDS[algo_kind], lut_match.data_ptr(),
                lut_mismatch.data_ptr(), float(nn_term), int(j0), int(Oj),
                out.data_ptr())
    return out


def shortlist(m, unk, candc, flen, rlen, fo, ro, *, O, SL, minoverlap,
              maxoverlap, algo_kind, pmatch, pmismatch, nn, band,
              lutsum=None):
    """[B, 2*SL + 4] int32 on the card: f32 scores, range rules and the
    winner / top-SL shortlist from the count sums, scored from the counts
    or, for the LUT kinds, from the f32 LUT sums ``lutsum`` [B, O]
    (twin: fused2.plain_shortlist)."""
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
    if algo_kind in LUT_KINDS:
        _check(lutsum, "lutsum", torch.float32, (B, O), dev)
    elif lutsum is not None:
        raise ValueError("lutsum goes with the LUT kinds, and only them")
    out = torch.empty((B, 2 * SL + 4), dtype=torch.int32, device=dev)
    if B:
        _launch(dev, "shortlist", m.data_ptr(), unk.data_ptr(),
                candc.data_ptr(),
                lutsum.data_ptr() if lutsum is not None else None,
                flen.data_ptr(), rlen.data_ptr(), fo.data_ptr(),
                ro.data_ptr(), B, O, SL, int(minoverlap), int(maxoverlap),
                SCORE_KINDS[algo_kind], float(pmatch), float(pmismatch),
                float(nn), float(band), out.data_ptr())
    return out
