"""Device steps of the PyTorch port: plain twins and the public entry
points.

Counterpart of ``pandaseq_tpu/ops/fused2.py``. Two device steps live
here:

* the sparse candidate search (every built-in algorithm with
  ``-k >= 1``): the device's only job is the O(L^2) k-mer candidate
  search (assembler.c:84-118); the native host finalizer
  (native/psq_io.cpp:psq_finalize) does the exact f64 selection,
  reconstruction and emission;
* the dense shortlist (``-k 0`` and custom algorithms, and the library
  entry points for pear / rdp_mle): exact integer match / N / k-mer
  counts on every diagonal of the overlap plane (plus f32 per-base LUT
  sums for pear / rdp_mle), f32 scores, and the winner plus the top-SL
  offsets, from which the host re-derives the exact f64 winner.

Two kinds of function live here:

* plain twins, written in device-agnostic PyTorch with the JAX
  functions' names and arguments (``kmer_frames``, ``kmer_frames_codes``,
  ``plane_cand``, ``plane_counts``, ``lut_plane_sums``,
  ``shortlist_from_counts``, ``pack_bits16``, ``_unpack2bit``, ...).
  They compute the same values as the JAX code (the LUT sums up to f32
  summation order), by the same method where it is exact (the kmerseen
  rank is sort-based), and never build a ``[B, L, L]`` plane. The
  ``plain_*`` functions of ``PLAIN_OPS`` mirror the CUDA kernels of
  ``ops/cand.py`` and ``ops/dense.py`` argument for argument (against
  ``device_ops(cuda)``), so the kernels can be held against them on the
  card; ``plain_kmer_frames(_nt)`` and ``plain_candidates`` are their
  pieces. The row-block forms (``j0``, ``Oj``; ``plain_counts``' hit
  rows) serve the op-sharded steps of ``parallel/shard.py``.
  ``cand_mask_join`` is the port of the JAX package's sorted join (K9),
  the CPU's mask step under ``PANDASEQ_TPU_JOIN``;
* the public entry points ``assemble_candidates_list_packed4``,
  ``assemble_candidates_packed4``, ``assemble_candidates_nt``,
  ``assemble_shortlist_nt``, ``assemble_shortlist`` and
  ``assemble_shortlist_packed``, which pick the implementation only by
  the device their tensors lie on (``device_ops``): a CPU tensor runs
  the plain twins, a CUDA tensor launches the kernels (or the kernel
  wrapper raises). There is no fallback from one to the other.

``build_ptable`` is the port's copy of the JAX package's host table (plain
numpy); the tests hold the f64 probability table and the PHRED byte
table built from it to the JAX package's bit for bit.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import tables

KMER_LEN = 8  # misc.h:33

# 2-bit k-mer packing: T=3, G=2, C=1, everything else 0 (misc.h:41)
_KCODE = np.zeros(16, dtype=np.int32)
_KCODE[8], _KCODE[4], _KCODE[2] = 3, 2, 1

# first-C candidate offsets shipped per pair; count > C rows are
# recomputed on host by the engine (assembler.py
# _mask_from_list), exactly as in the JAX package
CAND_LIST_C = 4

# the frame width the rank key and the kernels' shared-memory rows allow
MAX_FRAME = 1024

# f32-vs-f64 shortlist bands of the count-based and the LUT-sum scores,
# and the shortlist width (pandaseq_tpu/ops/fused2.py)
BAND_COUNTS = 0.01
BAND_LUT = 0.05
SHORTLIST = 8
# score families of the dense device shortlist: integer counts, and the
# per-base LUT sums of pear / rdp_mle (lut_plane_sums, K7)
COUNT_KINDS = ("counts", "ea_util", "flash", "stitch")
LUT_KINDS = ("pear", "rdp_mle")
QUAL_BINS = 47  # the LUTs are 47 x 47, quals clipped to [0, 46]


def _shift(x, t: int):
    """out[:, p] = x[:, p - t], zero where p - t falls outside the row
    (t > 0 shifts toward higher positions, t < 0 toward lower)."""
    L = x.shape[1]
    if t >= 0:
        return F.pad(x, (t, 0))[:, :L]
    return F.pad(x, (0, -t))[:, -t:]


def _window9_trail(nonn, L):
    """all-non-N over the trailing window p-8..p (reverse-read emission
    gate, misc.h:43 + assembler.c:103-109)."""
    cs = torch.cumsum(nonn.to(torch.int32), dim=1, dtype=torch.int32)
    return (cs - _shift(cs, 9)) == 9


def _window9_lead(nonn, L):
    """all-non-N over the leading window p..p+8 (forward-read emission
    gate seen from the reversed frame); false where the window passes
    the end of the row."""
    cs = torch.cumsum(nonn.to(torch.int32), dim=1, dtype=torch.int32)
    return (_shift(cs, -8) - _shift(cs, 1)) == 9


def _kmer_trail(codes, L):
    """k[p] = sum_t codes[p-t] << 2t — the FOREACH_KMER_REVERSE value
    at reversed-frame position p."""
    k = torch.zeros_like(codes)
    for t in range(KMER_LEN):
        k = k | (_shift(codes, t) << (2 * t))
    return k


def _kmer_lead(codes, L):
    """k[p] = sum_t codes[p+t] << 2t — the FOREACH_KMER value at
    reversed-frame position p."""
    k = torch.zeros_like(codes)
    for t in range(KMER_LEN):
        k = k | (_shift(codes, -t) << (2 * t))
    return k


def kmer_frames(nt_f, nt_r, flen, rlen, L, num_kmers):
    """K-mer seeding on reversed frames of 4-bit nucleotide codes:
    2-bit k-mer codes through ``_KCODE`` and non-N masks ``nt != 0x0F``
    (a pad, nt 0, counts as non-N), then ``kmer_frames_codes``."""
    kcode = torch.from_numpy(_KCODE).to(nt_f.device)
    nt_f = nt_f.to(torch.int64)
    nt_r = nt_r.to(torch.int64)
    return kmer_frames_codes(kcode[nt_f], nt_f != 0x0F, kcode[nt_r],
                             nt_r != 0x0F, flen, rlen, L, num_kmers)


def kmer_frames_codes(cf, nonn_f, cr, nonn_r, flen, rlen, L, num_kmers):
    """K-mer seeding (assembler.c:91-118, misc.h:32-45) on reversed
    frames from 2-bit codes and non-N masks. Returns (Fkm, Rkm) [B, L]
    int32: the forward k-mer where it is stored (-1 elsewhere) and the
    reverse k-mer where it is emitted (-2 elsewhere).

    The kmerseen table keeps only the first ``num_kmers`` occurrences in
    RAW order (descending frame position): the rank of an emission is
    the number of equal emissions at larger frame positions. As in the
    JAX twin it comes from a sort on key = kmer << 10 | (L-1-j'), inside
    whose runs ascending order is raw order, and a second sort that
    inverts the permutation."""
    if L > MAX_FRAME:
        raise ValueError(f"frame width {L} exceeds {MAX_FRAME}")
    dev = cf.device
    cf = cf.to(torch.int32)
    cr = cr.to(torch.int32)
    flen = flen.to(torch.int32)
    rlen = rlen.to(torch.int32)
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    kf = _kmer_lead(cf, L)
    kr = _kmer_trail(cr, L)
    # forward emits at frame j' with window j'..j'+8 non-N, j' <= flen-9
    emit_f = _window9_lead(nonn_f, L) & (pos <= flen[:, None] - 9)
    # reverse emits at frame i with window i-8..i non-N, 8 <= i < rlen
    emit_r = (_window9_trail(nonn_r, L) & (pos >= KMER_LEN)
              & (pos < rlen[:, None]))
    if num_kmers == 0:
        # -k 0: empty kmerseen table, nothing is stored
        stored_f = torch.zeros_like(emit_f)
    else:
        big = 1 << 27  # > any (kmer << 10 | pos) key
        key = torch.where(emit_f, (kf << 10) | (L - 1 - pos), big + pos)
        sk = torch.sort(key, dim=1).values
        idx = pos.expand_as(sk)
        run_start = torch.cat(
            [torch.ones_like(sk[:, :1], dtype=torch.bool),
             (sk[:, 1:] >> 10) != (sk[:, :-1] >> 10)], dim=1)
        seg_start = torch.cummax(
            torch.where(run_start, idx, 0), dim=1).values
        stored_sorted = ((idx - seg_start) < num_kmers) & (sk < big)
        # original frame position, recovered from the key itself
        pos_orig = torch.where(sk < big, (L - 1) - (sk & 1023), sk - big)
        # every position occurs once, so sorting (pos << 1 | stored)
        # puts row position j back at index j with the flag in bit 0
        sk2 = torch.sort((pos_orig << 1) | stored_sorted.to(torch.int32),
                         dim=1).values
        stored_f = (sk2 & 1) == 1
    Fkm = torch.where(stored_f, kf, -1)
    Rkm = torch.where(emit_r, kr, -2)
    return Fkm, Rkm


def plane_cand(Fkm, Rkm, O, j0=0, Oj=None):
    """K-mer candidate counts: candc[b, t] = #{(j', i) : j' + i = t,
    Fkm[b, j'] == Rkm[b, i]} for t < O, over plane rows j' in
    [j0, j0+Oj) — int32 [B, O]. One [B, O] slice per row j': the
    [B, O, O] equality plane is never built."""
    if Oj is None:
        Oj = O
    B = Fkm.shape[0]
    R = Rkm[:, :O]
    candc = torch.zeros((B, O), dtype=torch.int32, device=Fkm.device)
    for j in range(j0, min(j0 + Oj, O)):
        candc[:, j:] += Fkm[:, j:j + 1] == R[:, :O - j]
    return candc


def plane_counts(nt_f, nt_r, Fkm, Rkm, O, j0=0, Oj=None):
    """Exact integer diagonal sums over plane rows j' in [j0, j0+Oj):
    matches m (``f & r != 0``, N excluded), unknowns unk (either side N,
    neither side a pad) and k-mer hits candc (``Fkm == Rkm``), each
    [B, O] int32 with diagonal t = j' + i < O. One [B, O] slice per row
    j': the [B, O, O] planes are never built."""
    if Oj is None:
        Oj = O
    B = nt_f.shape[0]
    dev = nt_f.device
    r = nt_r[:, :O].to(torch.int32)
    R = Rkm[:, :O]
    r_live = r != 0
    r_n = r == 0x0F
    m = torch.zeros((B, O), dtype=torch.int32, device=dev)
    unk = torch.zeros_like(m)
    candc = torch.zeros_like(m)
    for j in range(j0, min(j0 + Oj, O)):
        w = O - j
        f = nt_f[:, j:j + 1].to(torch.int32)
        n = ((f == 0x0F) | r_n[:, :w]) & (f != 0) & r_live[:, :w]
        m[:, j:] += ((f & r[:, :w]) != 0) & ~n
        unk[:, j:] += n
        candc[:, j:] += Fkm[:, j:j + 1] == R[:, :w]
    return m, unk, candc


def lut_table(t, dev):
    """A 47x47 LUT as the f32 tensor on ``dev`` that the sums read: the
    f64 table rounded to f32 (an f32 tensor passes unchanged)."""
    t = torch.as_tensor(t)
    if t.dtype != torch.float32:
        t = t.to(torch.float64).to(torch.float32)
    if tuple(t.shape) != (QUAL_BINS, QUAL_BINS):
        raise ValueError(f"a LUT must be {QUAL_BINS}x{QUAL_BINS}, got "
                         f"{tuple(t.shape)}")
    return t.to(dev).contiguous()


def lut_plane_sums(fr_q, rr_q, nt_f, nt_r, flen, rlen, L, O, algo_kind,
                   lut_match, lut_mismatch, nn_term, j0=0, Oj=None):
    """f32 per-diagonal sums of per-base LUT scores (pear / rdp_mle) over
    plane rows j' in [j0, j0+Oj): [B, O] float32, diagonal t = j' + i.

    The term of cell (j', i) is ``Tm[qf, q2]`` where the forward and
    reverse codes bit-intersect (``f & r != 0``), else ``Tmm[qf, q2]``,
    with the quals clipped to [0, 46] and the tables rounded to f32; pads
    (nt 0) on either side contribute 0. pear puts ``nn_term`` on N cells
    (either side 0x0F, neither a pad); rdp_mle has no N case, so an N
    (which intersects every code) scores as a match. ``qf`` is the
    forward qual at j'; ``q2`` is the reverse qual at i, except for
    pear, which reads BOTH from the forward buffer (algo_pear.c:52-54):
    at ``flen-1-x`` for ``x = rlen-1-i < flen``, else at ``x`` — the
    stale persistent-buffer tail past ``flen``, which must be passed as
    read — clipped to [0, L-1].

    Each diagonal adds its terms one f32 add at a time in ascending j'
    (gathers, no matmul), the order of the lut_sums kernel. The JAX
    twin sums through a HIGHEST-precision dot_general instead, so the
    two differ by summation order only."""
    if Oj is None:
        Oj = O
    if algo_kind not in LUT_KINDS:
        raise ValueError(f"score kind {algo_kind!r} is not a LUT kind")
    dev = nt_f.device
    B = nt_f.shape[0]
    flen = flen.to(torch.int64)[:, None]
    rlen = rlen.to(torch.int64)[:, None]
    qf = fr_q.to(torch.int64).clamp(0, QUAL_BINS - 1)
    if algo_kind == "pear":
        x = rlen - 1 - torch.arange(O, dtype=torch.int64, device=dev)[None]
        idx = torch.where(x < flen, flen - 1 - x, x).clamp(0, L - 1)
        q2 = fr_q.to(torch.int64).gather(1, idx)
    else:
        q2 = rr_q[:, :O].to(torch.int64)
    q2 = q2.clamp(0, QUAL_BINS - 1)
    tm = lut_table(lut_match, dev).reshape(-1)
    tmm = lut_table(lut_mismatch, dev).reshape(-1)
    nn = _f32(nn_term, dev)
    zero = _f32(0.0, dev)
    r = nt_r[:, :O].to(torch.int32)
    r_pad = r == 0
    r_n = r == 0x0F
    acc = torch.zeros((B, O), dtype=torch.float32, device=dev)
    for j in range(j0, min(j0 + Oj, O)):
        w = O - j
        f = nt_f[:, j:j + 1].to(torch.int32)
        cell = qf[:, j:j + 1] * QUAL_BINS + q2[:, :w]
        term = torch.where((f & r[:, :w]) != 0, tm[cell], tmm[cell])
        if algo_kind == "pear":
            term = torch.where((f == 0x0F) | r_n[:, :w], nn, term)
        term = torch.where((f == 0) | r_pad[:, :w], zero, term)
        acc[:, j:] += term
    return acc


def _f32(x, dev):
    return torch.tensor(x, dtype=torch.float32, device=dev)


def total_order_key(x):
    """int32 keys of f32 ``x`` that order as IEEE's total order: -0.0
    below +0.0, and as floats elsewhere (the order of ``jax.lax.top_k``);
    the sign bit stays, the other bits of a negative value flip."""
    bits = x.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def shortlist_from_counts(m, unk, candc, lutsum, flen, rlen, fo, ro, *,
                          O, SL, minoverlap, maxoverlap, algo_kind,
                          pmatch, pmismatch, nn, band):
    """f32 scoring, candidate-range rules and winner / top-SL packing
    from the integer diagonal sums. Returns [B, 2*SL + 4] int32 in the
    layout of ``assemble_shortlist_nt``. Every f32 operation is rounded
    on its own, in the JAX code's order (no fused multiply-add). The
    ties are the JAX code's: the top SL are ``jax.lax.top_k``'s, a
    stable descending sort on the total-order key of the f32 score
    (+0.0 above -0.0, ties to the lower offset); ``besto32`` is
    ``jnp.argmax``'s, the first offset equal to the maximum by float
    comparison (so -0.0 equals +0.0). ``best32`` is what the JAX code's
    ``jnp.max`` compiles to: XLA folds it into the argmax's reduction,
    whose value keeps the later of two equal operands, so it is the
    score of the LAST offset equal to the maximum (its sign, where the
    maximum is a zero of both signs)."""
    dev = m.device
    f32 = torch.float32
    ninf = float("-inf")
    flen, rlen, fo, ro = (x.to(torch.int32)[:, None]
                          for x in (flen, rlen, fo, ro))
    o2 = torch.arange(1, O + 1, dtype=torch.int32, device=dev)[None, :]
    nvalid = (torch.minimum(o2, rlen)
              - (o2 - flen).clamp_min(0)).clamp_min(0)
    mm = nvalid - m - unk

    # candidate range (assembler.c:73-84,118); maxoverlap == 0 replaces
    # the offset-derived bound with min(flen, rlen)
    if maxoverlap == 0:
        maxo = torch.minimum(flen, rlen)
    else:
        maxo = (flen + rlen - minoverlap - fo - ro - 1).clamp_max(
            maxoverlap)
    in_range = (o2 >= minoverlap) & (o2 <= maxo)
    cand_in = (candc != 0) & in_range
    none_found = ~cand_in.any(dim=1, keepdim=True)
    cand_in = torch.where(none_found, in_range, cand_in)
    examined = cand_in.sum(dim=1, dtype=torch.int32)

    wrapped = None
    if algo_kind in LUT_KINDS:
        scores = lutsum
    elif algo_kind == "ea_util":
        bad = (mm + unk).to(f32)  # algo_ea_util.c:49-55
        scores = torch.log((bad * bad + _f32(1.0, dev))
                           / nvalid.clamp_min(1).to(f32))
    elif algo_kind == "flash":
        # integer floor division quirk
        ratio = torch.div(mm + unk, nvalid.clamp_min(1),
                          rounding_mode="floor")
        scores = torch.where(
            nvalid == 0, _f32(-2.0, dev),
            torch.where(ratio > 0, torch.log(ratio.to(f32)),
                        _f32(ninf, dev)))
    elif algo_kind == "stitch":
        # uint64 wrap (algo_stitch.c:40-56): the first wrapped offset
        # wins; +60 reproduces that under first-index ties
        diff = m - mm
        pos_s = torch.log(diff.to(f32).clamp_min(1e-30)
                          / (flen + rlen).to(f32))
        scores = torch.where(diff > 0, pos_s,
                             torch.where(diff < 0, _f32(60.0, dev),
                                         _f32(ninf, dev)))
        wrapped = (diff < 0) & cand_in
    elif algo_kind == "counts":  # algo_simple_bayes.c:45-65
        tail = (o2 < flen) | (o2 < rlen)
        nn_count = torch.where(tail, flen + rlen - 2 * o2 + unk, unk)
        scores = (_f32(nn, dev) * nn_count.to(f32)
                  + m.to(f32) * _f32(pmatch, dev)) \
            + mm.to(f32) * _f32(pmismatch, dev)
    else:
        raise ValueError(f"unknown score kind {algo_kind!r}")

    scores = torch.where(cand_in, scores, _f32(ninf, dev))
    order = torch.sort(total_order_key(scores), dim=1, descending=True,
                       stable=True).indices
    is_max = scores == scores.gather(1, order[:, :1])
    besto32 = (is_max.to(torch.int32).argmax(dim=1) + 1).to(torch.int32)
    last = torch.where(is_max, torch.arange(O, device=dev), -1).amax(
        dim=1, keepdim=True)
    best32 = scores.gather(1, last)
    in_band = (cand_in & torch.isfinite(scores)
               & (scores >= best32 - _f32(band, dev)))
    n_band = in_band.sum(dim=1, dtype=torch.int32)
    if wrapped is not None:
        n_band = torch.where(wrapped.any(dim=1), 1, n_band)

    topi = order[:, :SL]
    topv = scores.gather(1, topi)
    live = topv > ninf
    topi = topi.to(torch.int32)
    packed = torch.where(
        live, (topi + 1) | (m.gather(1, topi.long()) << 10)
        | (mm.gather(1, topi.long()) << 20), 0)
    sentinel = _f32(-3e38, dev)
    return torch.cat([
        packed.to(torch.int32),
        torch.where(live, topv, sentinel).view(torch.int32),
        besto32[:, None],
        examined[:, None],
        n_band.to(torch.int32)[:, None],
        torch.where(torch.isfinite(best32), best32,
                    sentinel).view(torch.int32),
    ], dim=1)


def pack_bits16(nz, O):
    """[B, O] 0/1 -> [B, O//32] int32 words, bit (o-1)%32 of word
    (o-1)//32 for offset o = index+1 (sum of distinct powers == OR)."""
    B = nz.shape[0]
    W = O // 32
    bits = nz[:, :W * 32].to(torch.int64).reshape(B, W, 32)
    weights = torch.ones(32, dtype=torch.int64, device=nz.device) \
        << torch.arange(32, dtype=torch.int64, device=nz.device)
    words = (bits * weights).sum(dim=2)
    # reinterpret the unsigned 32-bit pattern as int32
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def _unpack2bit(plane4, L):
    """(cf, cr, nonn): 2-bit k-mer codes + all-True non-N masks from
    the 4-bit packed upload plane (psq_pack4 layout: planar, forward
    bytes [0, L/4), reverse bytes [L/4, L/2), position p in byte
    p % (L/4) at bits 2*(p // (L/4)))."""
    if L % 8:
        raise ValueError(f"frame width {L} is not a multiple of 8")
    q = L // 4
    p32 = plane4.to(torch.int32) & 0xFF

    def unpack2(w):
        return torch.cat([(w >> (2 * t)) & 3 for t in range(4)], dim=1)

    cf = unpack2(p32[:, :q])
    cr = unpack2(p32[:, q:2 * q])
    return cf, cr, torch.ones(cf.shape, dtype=torch.bool, device=cf.device)


def _candc_packed4(plane4, flen, rlen, L, O, num_kmers):
    """Candidate counts [B, O] int32 from the 4-bit packed upload."""
    Fkm, Rkm = plain_kmer_frames(plane4, flen, rlen, L, num_kmers)
    return plane_cand(Fkm, Rkm, O)


def _cand_list(candc, O, C):
    """[B, C+2] int16 rows [count, first C offsets ascending
    (0-padded), 0] from candidate counts (the JAX list tail)."""
    present = candc != 0
    cnt = present.sum(dim=1, dtype=torch.int32)
    big = 1 << 20
    offs = torch.where(
        present,
        torch.arange(1, O + 1, dtype=torch.int32,
                     device=candc.device)[None, :], big)
    so = torch.sort(offs, dim=1).values[:, :C]
    so = torch.where(so >= big, 0, so)
    B = candc.shape[0]
    out = torch.cat([cnt[:, None], so,
                     torch.zeros((B, 1), dtype=torch.int32,
                                 device=candc.device)], dim=1)
    return out.to(torch.int16)


def plain_kmer_frames(plane4, flen, rlen, L, num_kmers):
    """(Fkm, Rkm) [B, L] int32 from the packed plane, with every base
    taken as non-N: the frames that the ``cand_join`` kernel builds in
    shared memory."""
    cf, cr, nonn = _unpack2bit(plane4, L)
    return kmer_frames_codes(cf, nonn, cr, nonn, flen, rlen, L, num_kmers)


def plain_candidates(Fkm, Rkm, O, mode, C=CAND_LIST_C):
    """The candidate list ([B, C+2] int16) in ``"list"`` mode, the
    candidate bitmask ([B, O//32] int32) in ``"mask"`` mode, from the
    k-mer frames: the second half of ``plain_candidates_join``."""
    candc = plane_cand(Fkm, Rkm, O)
    if mode == "list":
        return _cand_list(candc, O, C)
    if mode == "mask":
        return pack_bits16(candc != 0, O)
    raise ValueError(f"unknown candidate mode {mode!r}")


def plain_candidates_join(plane, flen, rlen, L, O, num_kmers, mode,
                          C=CAND_LIST_C, nt=False):
    """Plain version of the ``cand_join`` kernel: the frames of the
    4-bit packed plane (``plain_kmer_frames``) or, with ``nt``, of the
    nibble plane with N (``plain_kmer_frames_nt``), then the candidate
    list or mask of the whole plane (``plain_candidates``)."""
    frames = plain_kmer_frames_nt if nt else plain_kmer_frames
    Fkm, Rkm = frames(plane, flen, rlen, L, num_kmers)
    return plain_candidates(Fkm, Rkm, O, mode, C)


def cand_mask_join(cf, nonn_f, cr, nonn_r, flen, rlen, L, O, num_kmers):
    """Candidate bitmask [B, O//32] int32 through a sorted k-mer join,
    O(L log L) per pair (K9, pandaseq_tpu/ops/fused2.py cand_mask_join,
    step for step): one sort of the forward emissions together with the
    reverse-emission probes, reverse cumulative minima that carry each
    k-mer run's stored occurrences to its probes, and an OR pack.

    Under the key (kmer << 11 | 1024 | (L-1-j')) ascending order within
    one k-mer's run is raw order, so the first ``num_kmers`` keys of a
    run are the kmerseen-stored positions; a probe key (kmer << 11 | i)
    sorts before its run's sources. Propagation round t carries the
    t-th stored source of the run to the probe:

        m_0 = source ? key : INF          r_0 = rcummin(m_0)
        m_t = source ? r_{t-1}[i+1] : INF r_t = rcummin(m_t)

    and each (stored j', probe i) k-mer match sets offset o = j'+i+1 <=
    O. The JAX package runs it for ``num_kmers`` <= 2 only
    (PANDASEQ_TPU_JOIN); so does the engine here."""
    B = cf.shape[0]
    W = O // 32
    dev = cf.device
    if num_kmers <= 0:  # nothing stored -> empty mask
        return torch.zeros((B, W), dtype=torch.int32, device=dev)
    if L > MAX_FRAME:
        raise ValueError(f"frame width {L} exceeds {MAX_FRAME}")
    cf = cf.to(torch.int32)
    cr = cr.to(torch.int32)
    flen = flen.to(torch.int32)
    rlen = rlen.to(torch.int32)
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    kf = _kmer_lead(cf, L)
    kr = _kmer_trail(cr, L)
    emit_f = _window9_lead(nonn_f, L) & (pos <= flen[:, None] - 9)
    emit_r = (_window9_trail(nonn_r, L) & (pos >= KMER_LEN)
              & (pos < rlen[:, None]))
    # one int32 key: kmer << 11 | src << 10 | pos10; lanes that emit
    # nothing park above 2^29, distinct per lane
    src_v = torch.where(emit_f, (kf << 11) | 1024 | (L - 1 - pos),
                        0x20000000 | 1024 | pos)
    prb_v = torch.where(emit_r, (kr << 11) | pos, 0x28000000 | pos)
    v = torch.sort(torch.cat([src_v, prb_v], dim=1), dim=1).values
    is_src = (v & 1024) != 0
    inf = 0x7FFFFFFF
    inf_col = torch.full((B, 1), inf, dtype=torch.int32, device=dev)
    kmer_lane = v >> 11
    i_lane = v & 1023  # the probe's reverse position at probe lanes
    r_prev = None
    cand = []
    for _ in range(num_kmers):
        m = torch.where(is_src,
                        v if r_prev is None
                        else torch.cat([r_prev[:, 1:], inf_col], dim=1),
                        inf)
        r = torch.cummin(m.flip(1), dim=1).values.flip(1)
        ok = ~is_src & ((r >> 11) == kmer_lane)
        o = (L - 1 - (r & 1023)) + i_lane + 1
        ok &= (o >= 1) & (o <= O)
        cand.append(torch.where(ok, o - 1, -1))
        r_prev = r
    # pack: distinct offsets of each row, sum of distinct powers == OR
    so = torch.sort(torch.cat(cand, dim=1), dim=1).values
    uniq = (so >= 0) & torch.cat(
        [torch.ones((B, 1), dtype=torch.bool, device=dev),
         so[:, 1:] != so[:, :-1]], dim=1)
    word = so >> 5
    bit = torch.where(uniq, torch.ones_like(so, dtype=torch.int64)
                      << (so & 31).to(torch.int64), 0)
    words = torch.stack([torch.where(word == w, bit, 0).sum(dim=1)
                         for w in range(W)], dim=1)
    # reinterpret the unsigned 32-bit pattern as int32
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def _nibbles(nt):
    """(nt_f, nt_r) int32: the forward read's low nibble and the reverse
    read's high nibble of the nibble-packed plane (bytes unsigned)."""
    nts = nt.to(torch.int32) & 0xFF
    return nts & 0x0F, nts >> 4


def plain_kmer_frames_nt(nt, flen, rlen, L, num_kmers):
    """(Fkm, Rkm) [B, L] int32 from the nibble-packed plane ``nt`` [B, L]
    int8, with the true N positions: the frames that the ``counts`` and
    ``cand_join`` kernels build in shared memory."""
    nt_f, nt_r = _nibbles(nt)
    return kmer_frames(nt_f, nt_r, flen, rlen, L, num_kmers)


def plain_counts(nt, flen, rlen, L, O, num_kmers, j0=0, Oj=None,
                 hit_rows=None):
    """Plain version of the ``counts`` kernel: (m, unk, candc) [B, O]
    int32 from the nibble-packed plane ``nt`` [B, L] int8 — its N-aware
    k-mer frames (``plain_kmer_frames_nt``), then ``plane_counts`` over
    plane rows [j0, j0+Oj), with the k-mer hits over the rows
    ``hit_rows`` = (h0, Oh) instead where given (``plane_cand``; Oh may
    be 0); the counts of disjoint row blocks add up to the full
    plane's."""
    Fkm, Rkm = plain_kmer_frames_nt(nt, flen, rlen, L, num_kmers)
    nt_f, nt_r = _nibbles(nt)
    m, unk, candc = plane_counts(nt_f, nt_r, Fkm, Rkm, O, j0, Oj)
    if hit_rows is not None:
        candc = plane_cand(Fkm, Rkm, O, *hit_rows)
    return m, unk, candc


def plain_lut_sums(nt, fr_q, rr_q, flen, rlen, O, algo_kind, lut_match,
                   lut_mismatch, nn_term, j0=0, Oj=None):
    """Plain twin of the ``lut_sums`` kernel: [B, O] f32 LUT sums over
    plane rows [j0, j0+Oj) from the nibble-packed plane and the [B, L]
    int8 qual planes (L is their width)."""
    nt_f, nt_r = _nibbles(nt)
    return lut_plane_sums(fr_q, rr_q, nt_f, nt_r, flen, rlen,
                          fr_q.shape[1], O, algo_kind, lut_match,
                          lut_mismatch, nn_term, j0, Oj)


def plain_shortlist(m, unk, candc, flen, rlen, fo, ro, *, O, SL,
                    minoverlap, maxoverlap, algo_kind, pmatch, pmismatch,
                    nn, band, lutsum=None):
    """Plain twin of the ``shortlist`` kernel: [B, 2*SL + 4] int32 from
    the count sums, scored from the counts or, for the LUT kinds, from
    the f32 LUT sums ``lutsum`` [B, O]."""
    if algo_kind not in COUNT_KINDS + LUT_KINDS:
        raise ValueError(f"unknown score kind {algo_kind!r}")
    if (lutsum is None) == (algo_kind in LUT_KINDS):
        raise ValueError("lutsum goes with the LUT kinds, and only them")
    return shortlist_from_counts(
        m, unk, candc, lutsum, flen, rlen, fo, ro, O=O, SL=SL,
        minoverlap=minoverlap, maxoverlap=maxoverlap, algo_kind=algo_kind,
        pmatch=pmatch, pmismatch=pmismatch, nn=nn, band=band)


class DeviceOps(NamedTuple):
    """One implementation of each device op, with the kernel wrappers'
    names and arguments."""
    candidates_join: Callable
    counts: Callable
    lut_sums: Callable
    shortlist: Callable


PLAIN_OPS = DeviceOps(plain_candidates_join, plain_counts, plain_lut_sums,
                      plain_shortlist)


def device_ops(dev) -> DeviceOps:
    """The ops for tensors on ``dev``: the CUDA kernels' wrappers
    (ops/cand.py, ops/dense.py) on a CUDA device, the plain twins on the
    CPU. The device alone decides; nothing falls back."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        from . import cand, dense
        return DeviceOps(cand.candidates_join, dense.counts, dense.lut_sums,
                         dense.shortlist)
    if dev.type == "cpu":
        return PLAIN_OPS
    raise ValueError(f"no device step for device {dev}")


def _step_inputs(plane, lens, L, O, quals=()):
    """(plane, quals, [B] int32 lengths / offsets, O) on one device,
    checked; the device type picks the implementation (device_ops)."""
    if O is None:
        O = L
    if O > MAX_FRAME:
        raise ValueError(f"O={O} exceeds {MAX_FRAME}: offsets must fit "
                         "int16, and overflow O routes to the host")
    plane = torch.as_tensor(plane)
    dev = plane.device
    quals = [torch.as_tensor(q) for q in quals]
    lens = [torch.as_tensor(x) for x in lens]
    if any(x.device != dev for x in quals + lens):
        raise ValueError("the planes and the [B] arrays must be on one "
                         "device")
    if any(q.shape != plane.shape for q in quals):
        raise ValueError("the qual planes must have the nt plane's shape")
    if dev.type == "cuda":  # the kernels take contiguous rows
        plane = plane.contiguous()
        quals = [q.contiguous() for q in quals]
        lens = [x.to(torch.int32).contiguous() for x in lens]
    return plane, quals, lens, O


def _candidates_packed4(plane4, flen, rlen, L, O, num_kmers, mode, C):
    plane4, _, (flen, rlen), O = _step_inputs(plane4, (flen, rlen), L, O)
    return device_ops(plane4.device).candidates_join(
        plane4, flen, rlen, L, O, num_kmers, mode, C)


def assemble_candidates_list_packed4(plane4, flen, rlen, *, L: int,
                                     O: int | None = None,
                                     num_kmers: int = 2,
                                     C: int = CAND_LIST_C):
    """The main-path device step: [B, C+2] int16 rows = [count, first C
    candidate offsets ascending (0-padded), 0] from the 4-bit packed
    upload ``plane4`` [B, L/2] int8. Rows with count > C, and rows with
    N bases, are recomputed exactly on host by the engine."""
    return _candidates_packed4(plane4, flen, rlen, L, O, num_kmers,
                               "list", C)


def assemble_candidates_packed4(plane4, flen, rlen, *, L: int,
                                O: int | None = None, num_kmers: int = 2):
    """Mask form of the same step: [B, O//32] int32 candidate bitmask
    words (the engine's download when the list form is off). Under
    PANDASEQ_TPU_JOIN, a CPU plane at ``num_kmers`` <= 2 takes the sorted
    join ``cand_mask_join``, as the JAX package's step does; on a card
    the ``cand_join`` kernel runs either way."""
    plane4 = torch.as_tensor(plane4)
    if (num_kmers <= 2 and os.environ.get("PANDASEQ_TPU_JOIN")
            and plane4.device.type == "cpu"):
        plane4, _, (flen, rlen), O = _step_inputs(plane4, (flen, rlen), L,
                                                  O)
        cf, cr, nonn = _unpack2bit(plane4, L)
        return cand_mask_join(cf, nonn, cr, nonn, flen, rlen, L, O,
                              num_kmers)
    return _candidates_packed4(plane4, flen, rlen, L, O, num_kmers,
                               "mask", CAND_LIST_C)


def _shortlist_core(nt_pack, fr_q, rr_q, flen, rlen, fo, ro, *, L, O,
                    SL, minoverlap, maxoverlap, num_kmers, algo_kind,
                    pmatch, pmismatch, nn, nn_term, band, lut_match,
                    lut_mismatch):
    """The dense shortlist on the ops of the plane's device (see
    assemble_shortlist): the counts (k-mer frames fused in), the LUT
    sums for the LUT kinds, then the shortlist. The qual planes and LUTs serve only the LUT
    kinds."""
    if O is None:
        O = L
    lut = algo_kind in LUT_KINDS
    if band is None:
        band = BAND_LUT if lut else BAND_COUNTS
    ops = device_ops(nt_pack.device)
    m, unk, candc = ops.counts(nt_pack, flen, rlen, L, O, num_kmers)
    lutsum = None
    if lut:
        if lut_match is None or lut_mismatch is None:
            raise ValueError(f"{algo_kind} scores LUT sums: pass "
                             "lut_match and lut_mismatch")
        dev = nt_pack.device
        lutsum = ops.lut_sums(nt_pack, fr_q, rr_q, flen, rlen, O,
                              algo_kind, lut_table(lut_match, dev),
                              lut_table(lut_mismatch, dev), nn_term)
    return ops.shortlist(
        m, unk, candc, flen, rlen, fo, ro, O=O, SL=SL,
        minoverlap=minoverlap, maxoverlap=maxoverlap, algo_kind=algo_kind,
        pmatch=pmatch, pmismatch=pmismatch, nn=nn, band=band,
        lutsum=lutsum)


def assemble_shortlist(nt_pack, fr_q, rr_q, flen, rlen, fo, ro, *,
                       L: int, O: int | None = None, SL: int = SHORTLIST,
                       minoverlap: int = 2, maxoverlap: int = 0,
                       num_kmers: int = 2, algo_kind: str = "counts",
                       pmatch: float = 0.0, pmismatch: float = 0.0,
                       nn: float = float(tables.QUAL_NN_SIMPLE_BAYESIAN),
                       nn_term: float = 0.0, band: float | None = None,
                       lut_match=None, lut_mismatch=None):
    """The dense device step over REVERSED frames -> [B, 2*SL + 4]
    int32:

      [:SL]        packed shortlist: o | m<<10 | mm<<20 (0 = empty),
                   descending f32 score, ties toward smaller o
      [SL:2*SL]    bitcast f32 scores of those offsets (-3e38 if none)
      [2*SL]       besto32 (f32 argmax offset, first-max)
      [2*SL+1]     examined (number of candidate offsets in range)
      [2*SL+2]     n_band (offsets within ``band`` of the f32 max)
      [2*SL+3]     bitcast f32 best score (-3e38 if not finite)

    ``nt_pack`` [B, L] int8 carries both reads' 4-bit codes (fwd |
    rev << 4); ``fr_q`` / ``rr_q`` [B, L] int8 are the reversed-frame
    quals, which only the LUT kinds (pear, rdp_mle: ``lut_plane_sums``
    with ``lut_match`` / ``lut_mismatch`` and ``nn_term``) read; flen /
    rlen / fo / ro are [B]. ``band`` defaults to BAND_LUT for the LUT
    kinds and BAND_COUNTS otherwise. CPU tensors run the plain twins,
    CUDA tensors the kernels."""
    nt_pack, (fr_q, rr_q), (flen, rlen, fo, ro), O = _step_inputs(
        nt_pack, (flen, rlen, fo, ro), L, O, (fr_q, rr_q))
    return _shortlist_core(
        nt_pack, fr_q, rr_q, flen, rlen, fo, ro, L=L, O=O, SL=SL,
        minoverlap=minoverlap, maxoverlap=maxoverlap, num_kmers=num_kmers,
        algo_kind=algo_kind, pmatch=pmatch, pmismatch=pmismatch, nn=nn,
        nn_term=nn_term, band=band, lut_match=lut_match,
        lut_mismatch=lut_mismatch)


def assemble_shortlist_packed(plane, flen, rlen, fo, ro, *, L: int,
                              O: int | None = None, SL: int = SHORTLIST,
                              minoverlap: int = 2, maxoverlap: int = 0,
                              num_kmers: int = 2, algo_kind: str = "counts",
                              pmatch: float = 0.0, pmismatch: float = 0.0,
                              nn: float = float(
                                  tables.QUAL_NN_SIMPLE_BAYESIAN),
                              nn_term: float = 0.0,
                              band: float | None = None,
                              lut_match=None, lut_mismatch=None):
    """Single-upload form of assemble_shortlist: ``plane`` is [B, 3*L]
    int8 columns [nt_pack | fr_q | rr_q]."""
    plane = torch.as_tensor(plane)
    if plane.shape[1] != 3 * L:
        raise ValueError(f"the plane must be [B, {3 * L}], got "
                         f"{tuple(plane.shape)}")
    return assemble_shortlist(
        plane[:, :L], plane[:, L:2 * L], plane[:, 2 * L:], flen, rlen, fo,
        ro, L=L, O=O, SL=SL, minoverlap=minoverlap, maxoverlap=maxoverlap,
        num_kmers=num_kmers, algo_kind=algo_kind, pmatch=pmatch,
        pmismatch=pmismatch, nn=nn, nn_term=nn_term, band=band,
        lut_match=lut_match, lut_mismatch=lut_mismatch)


def assemble_shortlist_nt(nt_pack, flen, rlen, fo, ro, *, L: int,
                          O: int | None = None, SL: int = SHORTLIST,
                          minoverlap: int = 2, maxoverlap: int = 0,
                          num_kmers: int = 2, algo_kind: str = "counts",
                          pmatch: float = 0.0, pmismatch: float = 0.0,
                          nn: float = float(tables.QUAL_NN_SIMPLE_BAYESIAN),
                          band: float | None = None):
    """Quals-free form of assemble_shortlist for the count-based score
    kinds (counts, ea_util, flash, stitch): the upload is the nibble
    plane alone."""
    if algo_kind not in COUNT_KINDS:
        raise ValueError(f"score kind {algo_kind!r} is not count-based")
    nt_pack, _, (flen, rlen, fo, ro), O = _step_inputs(
        nt_pack, (flen, rlen, fo, ro), L, O)
    return _shortlist_core(
        nt_pack, None, None, flen, rlen, fo, ro, L=L, O=O, SL=SL,
        minoverlap=minoverlap, maxoverlap=maxoverlap, num_kmers=num_kmers,
        algo_kind=algo_kind, pmatch=pmatch, pmismatch=pmismatch, nn=nn,
        nn_term=0.0, band=band, lut_match=None, lut_mismatch=None)


def assemble_candidates_nt(nt_pack, flen, rlen, *, L: int,
                           O: int | None = None, num_kmers: int = 2):
    """k-mer candidate search on the nibble-packed plane with the true
    N positions: [B, O//32] int32 candidate bitmask words."""
    nt_pack, _, (flen, rlen), O = _step_inputs(nt_pack, (flen, rlen), L, O)
    return device_ops(nt_pack.device).candidates_join(
        nt_pack, flen, rlen, L, O, num_kmers, "mask", CAND_LIST_C, nt=True)


def build_ptable(algo) -> np.ndarray:
    """Host-side f64 table PTBL[case*2209 + fq*47 + rq] of exact
    per-base log-probabilities for one algorithm (case codes from the
    reconstruction, assembler.c:162-243: 0 hole, 1 fwd copy, 2 rev
    copy, 3 overlap match, 4 overlap mismatch, 5 both B-cliff masked,
    6 fwd masked, 7 rev masked)."""
    from ..assembler import _match_probability_vec

    fqg, rqg = np.meshgrid(np.arange(47), np.arange(47), indexing="ij")
    fqf = fqg.ravel()
    rqf = rqg.ravel()
    tbl = np.zeros(8 * 2209, dtype=np.float64)
    qs = tables.QUAL_SCORE
    nn = float(tables.QUAL_NN_SIMPLE_BAYESIAN)
    try:
        mp_match = _match_probability_vec(algo, np.ones(2209, bool),
                                          fqf, rqf)
        mp_mis = _match_probability_vec(algo, np.zeros(2209, bool),
                                        fqf, rqf)
    except ValueError:  # custom algorithm: scalar match_probability
        mp_match = np.array([algo.match_probability(True, a, b)
                             for a, b in zip(fqf, rqf)])
        mp_mis = np.array([algo.match_probability(False, a, b)
                           for a, b in zip(fqf, rqf)])
    for case in range(8):
        base = case * 2209
        if case == 1 or case == 7:
            tbl[base:base + 2209] = qs[fqf]
        elif case == 2 or case == 6:
            tbl[base:base + 2209] = qs[rqf]
        elif case == 3:
            tbl[base:base + 2209] = mp_match
        elif case == 4:
            tbl[base:base + 2209] = mp_mis
        elif case == 5:
            tbl[base:base + 2209] = nn
    return tbl
