"""The dense -k 0 shortlist path of the PyTorch port against the JAX
package on the CPU: the N-aware k-mer frames (``kmer_frames``),
``plane_counts``, the ``counts`` kernel's plain version (the two in
one), ``assemble_candidates_nt``, ``shortlist_from_counts`` (also on
edge rows: tests/shortlist_rows.py) and ``assemble_shortlist_nt``.

Tolerances: the frames, counts and candidate masks are integers, equal
bit for bit. Of the shortlist, ``besto32``, ``examined`` and ``n_band``
are equal, and so are the packed top-SL columns on rows without a
near-tie among the shipped scores. The f32 score columns agree within
``2**-21 * |score| + 2**-13``: XLA on the CPU contracts ``a * b + c``
into a fused multiply-add and has its own ``log``, while the twin rounds
every operation on its own as the CUDA kernel does; near cancellation in
the simple_bayesian sum that is one rounding of the largest term (up to
~2400 at O=512, whose ulp is 2**-12), and elsewhere a few ulp. The
largest difference measured on these inputs was 3.05e-05 (a score of
0.0329, simple_bayesian)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pandaseq_tpu import tables
from pandaseq_tpu.ops import fused2 as jf
from pandaseq_tpu_torch.ops import fused2 as tf
from tests.shortlist_rows import TIES, ZERO_TIE_ROW, ZEROS, edge_rows
from tests.test_torch_fused2 import _eq, _t

torch.set_num_threads(1)

SL = 8
NN = float(tables.QUAL_NN_SIMPLE_BAYESIAN)
# pmatch / pmismatch of the counts kind: simple_bayesian-like logs
PM, PMM = -0.0105, -2.36

_jax_frames = jax.jit(jf.kmer_frames, static_argnums=(4, 5))
_jax_counts = jax.jit(jf.plane_counts, static_argnums=(4, 5, 6))
_jax_shortlist = jax.jit(
    jf.shortlist_from_counts,
    static_argnames=("O", "SL", "minoverlap", "maxoverlap", "algo_kind",
                     "pmatch", "pmismatch", "nn", "band"))


def _nt_planes(rng, B, L):
    """Reversed nibble frames with N runs, degenerate codes, zero tails
    and edge lengths; odd rows draw from two bases, so k-mers repeat."""
    codes = np.array([1, 2, 4, 8, 15, 15, 15, 5, 10], np.uint8)
    fwd = codes[rng.integers(0, len(codes), (B, L))]
    rev = codes[rng.integers(0, len(codes), (B, L))]
    fwd[1::2] = np.array([2, 8], np.uint8)[rng.integers(0, 2, (B // 2, L))]
    rev[1::2] = np.array([2, 8], np.uint8)[rng.integers(0, 2, (B // 2, L))]
    fwd[2, 10:30] = 15  # an N run
    flen = rng.integers(0, L + 1, B).astype(np.int32)
    rlen = rng.integers(0, L + 1, B).astype(np.int32)
    flen[:4] = [0, 9, 10, L]
    rlen[:4] = [0, 8, 9, L]
    pos = np.arange(L)[None, :]
    fwd[pos >= flen[:, None]] = 0
    rev[pos >= rlen[:, None]] = 0
    return fwd, rev, (fwd | (rev << 4)).view(np.int8), flen, rlen


@pytest.mark.parametrize("num_kmers", [0, 1, 2, 3])
@pytest.mark.parametrize("L", [64, 128, 256])
def test_kmer_frames_nt_equals_jax(L, num_kmers):
    rng = np.random.default_rng(10 * L + num_kmers)
    fwd, rev, nt, flen, rlen = _nt_planes(rng, 16, L)
    want = _jax_frames(jnp.asarray(fwd.astype(np.int32)),
                       jnp.asarray(rev.astype(np.int32)), jnp.asarray(flen),
                       jnp.asarray(rlen), L, num_kmers)
    got = tf.plain_kmer_frames_nt(_t(nt), _t(flen), _t(rlen), L, num_kmers)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert (got[1].numpy() >= 0).any()
    if num_kmers:
        assert (got[0].numpy() >= 0).any()


@pytest.mark.parametrize("L,O,j0,Oj", [(64, 64, 0, None), (256, 128, 0, None),
                                       (256, 256, 64, 64)])
def test_plane_counts_equals_jax(L, O, j0, Oj):
    """Whole-plane counts, and a row block (the op-axis slice), of the
    counts kernel's plain version at num_kmers 2 against the JAX
    package's kmer_frames + plane_counts."""
    rng = np.random.default_rng(O + j0)
    fwd, rev, nt, flen, rlen = _nt_planes(rng, 16, L)
    got = tf.plain_counts(_t(nt), _t(flen), _t(rlen), L, O, 2, j0, Oj)
    for g, w in zip(got, _jax_counts_of(fwd, rev, flen, rlen, L, O, 2, j0,
                                        Oj)):
        _eq(g, w)
    assert got[0].numpy().any() and got[1].numpy().any()


def _jax_counts_of(fwd, rev, flen, rlen, L, O, num_kmers, j0=0, Oj=None):
    f, r = (jnp.asarray(x.astype(np.int32)) for x in (fwd, rev))
    Fkm, Rkm = _jax_frames(f, r, jnp.asarray(flen), jnp.asarray(rlen), L,
                           num_kmers)
    return _jax_counts(f, r, Fkm, Rkm, O, j0, Oj)


@pytest.mark.parametrize("num_kmers", [0, 1, 2, 3])
@pytest.mark.parametrize("L", [64, 96, 128])
def test_counts_equals_jax(L, num_kmers):
    """The counts kernel's plain version (nibble plane and lengths in,
    frames inside) against the JAX package's kmer_frames + plane_counts,
    exactly: the full plane and each row block of op 2 and 4, whose
    counts add up to the full plane's. Rows with N runs, pads, repeats
    over two bases, and flen / rlen shorter than L."""
    rng = np.random.default_rng(100 * L + num_kmers)
    fwd, rev, nt, flen, rlen = _nt_planes(rng, 16, L)
    args = (_t(nt), _t(flen), _t(rlen), L, L, num_kmers)
    full = tf.plain_counts(*args)
    for g, w in zip(full, _jax_counts_of(fwd, rev, flen, rlen, L, L,
                                         num_kmers)):
        _eq(g, w)
    for op in (2, 4):
        Oj = L // op
        sums = [torch.zeros_like(x) for x in full]
        for j0 in range(0, L, Oj):
            got = tf.plain_counts(*args, j0, Oj)
            want = _jax_counts_of(fwd, rev, flen, rlen, L, L, num_kmers, j0,
                                  Oj)
            for acc, g, w in zip(sums, got, want):
                _eq(g, w)
                acc += g
        for acc, f in zip(sums, full):
            _eq(acc, f.numpy())
    assert full[0].numpy().any() and full[1].numpy().any()
    assert full[2].numpy().any() == (num_kmers > 0)


@pytest.mark.parametrize("num_kmers", [1, 2, 3])
@pytest.mark.parametrize("L", [64, 96, 128])
def test_counts_hit_rows_equal_jax(L, num_kmers):
    """The counts' hit rows apart from their bit rows, as the mesh's op
    cells take them: each row block of op 2 and 4 counts its matches and
    N (the JAX package's block), and its k-mer hits over the rows named
    — every row in the first block (the JAX package's full-plane hits),
    none in the others — so the blocks add up to the full plane."""
    rng = np.random.default_rng(10 * L + num_kmers)
    fwd, rev, nt, flen, rlen = _nt_planes(rng, 16, L)
    args = (_t(nt), _t(flen), _t(rlen), L, L, num_kmers)
    full = _jax_counts_of(fwd, rev, flen, rlen, L, L, num_kmers)
    assert np.asarray(full[2]).any()
    for op in (2, 4):
        Oj = L // op
        sums = [np.zeros_like(np.asarray(x)) for x in full]
        for j0 in range(0, L, Oj):
            got = tf.plain_counts(*args, j0, Oj,
                                  hit_rows=(0, L if j0 == 0 else 0))
            want = _jax_counts_of(fwd, rev, flen, rlen, L, L, num_kmers, j0,
                                  Oj)
            _eq(got[0], want[0])
            _eq(got[1], want[1])
            _eq(got[2], full[2] if j0 == 0 else np.zeros_like(want[2]))
            for acc, g in zip(sums, got):
                acc += g.numpy()
        for acc, f in zip(sums, full):
            _eq(torch.from_numpy(acc), f)


@pytest.mark.parametrize("pallas", ["", "interpret"])
@pytest.mark.parametrize("num_kmers", [1, 2, 3])
def test_assemble_candidates_nt_equals_jax(monkeypatch, num_kmers, pallas):
    """The JAX step jitted as production runs it, and again through
    plane_cand with PANDASEQ_TPU_PALLAS=interpret (the Pallas kernel in
    interpret mode, O % 128 == 0)."""
    rng = np.random.default_rng(num_kmers)
    L = O = 128
    fwd, rev, nt, flen, rlen = _nt_planes(rng, 16, L)
    if pallas:
        monkeypatch.setenv("PANDASEQ_TPU_PALLAS", pallas)
        Fkm, Rkm = jf.kmer_frames(jnp.asarray(fwd.astype(np.int32)),
                                  jnp.asarray(rev.astype(np.int32)),
                                  jnp.asarray(flen), jnp.asarray(rlen), L,
                                  num_kmers)
        want = jf.pack_bits16(jf.plane_cand(Fkm, Rkm, O) != 0, O)
    else:
        want = jf.assemble_candidates_nt(nt, flen, rlen, L=L,
                                         num_kmers=num_kmers)
    got = tf.assemble_candidates_nt(_t(nt), _t(flen), _t(rlen), L=L,
                                    num_kmers=num_kmers)
    _eq(got, want)
    assert got.numpy().any()


def _counts(rng, B, O):
    """Count sums with rows built to tie and rows with no k-mer hit.

    Row 0 (flen = rlen = O) has candidates only at o = q*q + 1, with
    mm = q and unk = 0, so ea_util scores log((q*q + 1) / o) = 0 at all
    nine of them in range: more exact ties than SL. Rows 1-3 have no
    k-mer hit (ALL_BITS_IF_NONE); row 4 has an empty range."""
    flen = rng.integers(0, O + 1, B).astype(np.int32)
    rlen = rng.integers(0, O + 1, B).astype(np.int32)
    fo = rng.integers(0, 4, B).astype(np.int32)
    ro = rng.integers(0, 4, B).astype(np.int32)
    o2 = np.arange(1, O + 1)[None, :]
    nvalid = np.maximum(0, np.minimum(o2, rlen[:, None])
                        - np.maximum(0, o2 - flen[:, None]))
    m = (rng.random((B, O)) * (nvalid + 1)).astype(np.int32)
    unk = (rng.random((B, O)) * (nvalid - m + 1)).astype(np.int32)
    candc = (rng.random((B, O)) < 0.05) * rng.integers(1, 4, (B, O))
    flen[0] = rlen[0] = O
    candc[0] = 0
    for q in range(1, 11):
        o = q * q + 1
        m[0, o - 1] = o - q
        unk[0, o - 1] = 0
        candc[0, o - 1] = 1
    candc[1:4] = 0
    flen[4] = rlen[4] = 1
    return m, unk, candc.astype(np.int32), flen, rlen, fo, ro


def _near_tie_rows(want):
    """Rows where two of the SL shipped finite f32 scores (JAX's)
    differ but lie within the tolerance: there the order may differ."""
    s = want[:, SL:2 * SL].view(np.float32).astype(np.float64)
    d = np.abs(np.diff(s, axis=1))
    tol = 2.0 ** -21 * np.abs(s[:, 1:]) + 2.0 ** -13
    return ((d > 0) & (d <= tol) & (s[:, 1:] > -3e38)).any(axis=1)


def _check_shortlist(got, want):
    """The tolerances of the module docstring; returns the largest f32
    difference. Where both sides ship a zero score (the shipped scores
    and ``best32``), its bits are equal: JAX's top_k orders +0.0 above
    -0.0, and the port follows it."""
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got[:, 2 * SL:2 * SL + 3],
                                  want[:, 2 * SL:2 * SL + 3])
    near = _near_tie_rows(want)
    np.testing.assert_array_equal(got[~near, :SL], want[~near, :SL])
    cols = np.r_[SL:2 * SL, 2 * SL + 3]
    gf = got[:, cols].view(np.float32)
    wf = want[:, cols].view(np.float32)
    zeros = (gf == 0) & (wf == 0)
    np.testing.assert_array_equal(got[:, cols][zeros], want[:, cols][zeros])
    gf, wf = gf.astype(np.float64), wf.astype(np.float64)
    np.testing.assert_allclose(gf, wf, rtol=2.0 ** -21, atol=2.0 ** -13)
    return np.abs(gf - wf).max()


KINDS = [("counts", 0), ("counts", 150), ("ea_util", 0), ("ea_util", 150),
         ("flash", 0), ("flash", 150), ("stitch", 0), ("stitch", 150)]


@pytest.mark.parametrize("kind,maxoverlap", KINDS)
def test_shortlist_from_counts_equals_jax(kind, maxoverlap):
    rng = np.random.default_rng(len(kind) + maxoverlap)
    B, O = 48, 256
    m, unk, candc, flen, rlen, fo, ro = _counts(rng, B, O)
    kw = dict(O=O, SL=SL, minoverlap=3, maxoverlap=maxoverlap,
              algo_kind=kind, pmatch=PM, pmismatch=PMM, nn=NN,
              band=tf.BAND_COUNTS)
    want = _jax_shortlist(*map(jnp.asarray, (m, unk, candc)), None,
                          *map(jnp.asarray, (flen, rlen, fo, ro)), **kw)
    got = tf.plain_shortlist(*map(_t, (m, unk, candc, flen, rlen, fo, ro)),
                             **kw)
    _check_shortlist(got, want)
    g = got.numpy()
    assert (g[1:4, 2 * SL + 1] > 0).all()  # the whole range examined
    assert g[4, 2 * SL + 1] == 0 and g[4, 2 * SL] == 1  # none: first max
    if kind == "ea_util":
        # nine exact ties (o = 5 .. 101): ascending offsets fill the list
        assert list(g[0, :SL] & 1023) == [q * q + 1 for q in range(2, 10)]
        assert g[0, 2 * SL + 2] == 9


@pytest.mark.parametrize("kind,maxoverlap", KINDS)
@pytest.mark.parametrize("num_kmers", [0, 2])
def test_assemble_shortlist_nt_equals_jax(kind, maxoverlap, num_kmers):
    rng = np.random.default_rng(7 * len(kind) + maxoverlap + num_kmers)
    L = 128
    _, _, nt, flen, rlen = _nt_planes(rng, 24, L)
    fo = rng.integers(0, 3, 24).astype(np.int32)
    ro = rng.integers(0, 3, 24).astype(np.int32)
    kw = dict(L=L, O=L, minoverlap=3, maxoverlap=maxoverlap,
              num_kmers=num_kmers, algo_kind=kind, pmatch=PM,
              pmismatch=PMM)
    want = jf.assemble_shortlist_nt(nt, flen, rlen, fo, ro, **kw)
    got = tf.assemble_shortlist_nt(*map(_t, (nt, flen, rlen, fo, ro)), **kw)
    _check_shortlist(got, want)
    assert (got.numpy()[:, 2 * SL + 1] > 0).any()


def test_lut_kinds_raise():
    """pear / rdp_mle score LUT sums (K7): the quals-free count step
    refuses them, as the JAX package's does, and the dense core now
    scores them. On all-pad planes every LUT term is 0, so the port's
    core equals the JAX package's bit for bit."""
    nt = torch.zeros((2, 64), dtype=torch.int8)
    lens = torch.full((2,), 50, dtype=torch.int32)
    with pytest.raises(ValueError, match="count-based"):
        tf.assemble_shortlist_nt(nt, lens, lens, lens, lens, L=64,
                                 algo_kind="pear")
    luts = (tables.QUAL_MATCH_SIMPLE_BAYESIAN - NN,
            tables.QUAL_MISMATCH_RDP_MLE - NN)
    q = torch.full((2, 64), 30, dtype=torch.int8)
    got = tf._shortlist_core(nt, q, q, lens, lens, lens, lens, L=64,
                             O=64, SL=SL, minoverlap=2, maxoverlap=0,
                             num_kmers=2, algo_kind="rdp_mle", pmatch=0.0,
                             pmismatch=0.0, nn=NN, nn_term=0.0, band=None,
                             lut_match=luts[0], lut_mismatch=luts[1])
    want = jf.assemble_shortlist(*(x.numpy() for x in (
        nt, q, q, lens, lens, lens, lens)), L=64, algo_kind="rdp_mle",
        lut_match=luts[0], lut_mismatch=luts[1])
    _eq(got, want)


EDGE_KINDS = ["counts", "ea_util", "flash", "stitch", "pear"]


@pytest.mark.parametrize("maxoverlap", [0, 150])
@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_shortlist_edge_rows_equal_jax(kind, maxoverlap):
    """plain_shortlist against the JAX package's shortlist_from_counts on
    the edge rows of tests/shortlist_rows.py, for the four count kinds
    and the LUT kind (pear: the scores are the given LUT sums)."""
    rng = np.random.default_rng(EDGE_KINDS.index(kind) + maxoverlap)
    O = 256
    r = edge_rows(rng, O)
    lut = kind == "pear"
    kw = dict(O=O, SL=SL, minoverlap=3, maxoverlap=maxoverlap,
              algo_kind=kind, pmatch=PM, pmismatch=PMM, nn=NN,
              band=tf.BAND_LUT if lut else tf.BAND_COUNTS)
    ints = [r[k] for k in ("m", "unk", "candc")]
    lens = [r[k] for k in ("flen", "rlen", "fo", "ro")]
    want = _jax_shortlist(*map(jnp.asarray, ints),
                          jnp.asarray(r["lutsum"]) if lut else None,
                          *map(jnp.asarray, lens), **kw)
    got = tf.plain_shortlist(*map(_t, ints + lens), **kw,
                             lutsum=_t(r["lutsum"]) if lut else None)
    _check_shortlist(got, want)
    g = got.numpy()
    n = 2 * SL
    assert g[0, n] == 1 and g[0, n + 1] == 0  # empty range: first offset
    assert (g[0, :SL] == 0).all() and (g[0, SL:n] == np.float32(
        -3e38).view(np.int32)).all()
    assert g[6, n + 1] > 0  # hits only below minoverlap: whole range
    assert (g[5, 3:SL] == 0).all() and g[5, n + 1] == 3  # 3 candidates
    if kind in ("flash", "pear"):  # row 1: every candidate -inf
        assert g[1, n] == 1 and g[1, n + 1] > 0 and g[1, n + 2] == 0
        assert (g[1, :SL] == 0).all()
    if kind == "stitch":  # the first wrapped offset wins; n_band is 1
        assert g[2, n] == 51 and g[2, n + 2] == 1
    if lut:
        # jax.lax.top_k's order: the +0.0 offsets, then the -0.0 ones,
        # each ascending, then -1.0; besto32 is argmax's first zero
        pos = [x + 1 for x in sorted(ZEROS) if not np.signbit(ZEROS[x])]
        neg = [x + 1 for x in sorted(ZEROS) if np.signbit(ZEROS[x])]
        assert list(g[ZERO_TIE_ROW, :SL] & 1023) == pos + neg + [3, 5, 6]
        assert pos == [8, 42] and neg == [4, 41, 71]
        assert g[ZERO_TIE_ROW, n] == 4 and g[ZERO_TIE_ROW, n + 2] == 5
        # best32: the last zero's (offset 71, a -0.0), as XLA's max
        assert g[ZERO_TIE_ROW, n + 3] == np.float32(-0.0).view(np.int32)
        # ten equal scores across lanes and words: ascending offsets
        assert list(g[4, :SL] & 1023) == [x + 1 for x in TIES[:SL]]
        assert g[4, n + 2] == len(TIES)


@pytest.mark.parametrize("O", [128, 256, 512])
def test_shortlist_zero_ties_equal_jax(O):
    """Rows of LUT sums drawn from -0.0, +0.0, 2.5, -1.0 and -inf, so the
    maximum ties across both zeros (or 2.5s) in many places: the whole
    output equals the JAX package's bit for bit, the top SL in top_k's
    order, argmax's besto32 and best32's sign."""
    rng = np.random.default_rng(O)
    B = 64
    vals = np.float32([-0.0, 0.0, 2.5, -1.0, -np.inf])
    lutsum = vals[rng.choice(5, (B, O), p=[0.04, 0.04, 0.01, 0.81, 0.1])]
    lutsum[::4] = np.where(lutsum[::4] == 2.5, -1.0, lutsum[::4])
    zeros = np.zeros((B, O), np.int32)
    lens = np.full(B, O, np.int32)
    fo = rng.integers(0, 3, B).astype(np.int32)
    kw = dict(O=O, SL=SL, minoverlap=3, maxoverlap=0, algo_kind="pear",
              pmatch=0.0, pmismatch=0.0, nn=NN, band=tf.BAND_LUT)
    ints = [zeros, zeros, zeros]
    lens4 = [lens, lens, fo, fo]
    want = _jax_shortlist(*map(jnp.asarray, ints), jnp.asarray(lutsum),
                          *map(jnp.asarray, lens4), **kw)
    got = tf.plain_shortlist(*map(_t, ints + lens4), **kw,
                             lutsum=_t(lutsum))
    _eq(got, want)
    best = got.numpy()[:, 2 * SL + 3]
    assert (best == 0).any() and (best == np.float32(-0.0).view(
        np.int32)).any()  # best32 of both signs
