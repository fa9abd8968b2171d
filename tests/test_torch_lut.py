"""K7, the LUT-scored dense shortlist of pear and rdp_mle, in the PyTorch
port against the JAX package on the CPU: ``lut_plane_sums`` over the
full plane and over row blocks, ``assemble_shortlist`` and
``assemble_shortlist_packed``.

Tolerance. The port adds each diagonal's terms one f32 add at a time in
ascending j' (the lut_sums kernel's order); JAX sums through a
HIGHEST-precision ``dot_general``. The two differ only by summation
order, so per diagonal

    |port - jax| <= 2e-5 * sum|term| + 1e-6

(a sum of n <= 128 terms in any order is within about n * 2**-24 *
sum|term| = 7.6e-6 * sum|term| of the exact sum). The largest
difference measured on these inputs was 1.22e-04 (pear, O=128), at most
2.7% of its diagonal's bound (``test_lut_plane_sums_equals_jax`` asserts
the largest difference stays below a tenth of the largest bound), and
far below ``BAND_LUT`` = 0.05. Row blocks of op 2 and 4 sum to the full
plane within the same bound. Of the shortlist, ``examined`` is exact;
the shortlist SET and the winner are equal on rows whose neighbouring
scores are further apart than twice the bound; the f32 columns agree
within the bound."""

import math

import jax
import numpy as np
import pytest
import torch

from pandaseq_tpu import tables
from pandaseq_tpu.ops import fused2 as jf
from pandaseq_tpu_torch.ops import fused2 as tf
from tests.lut_rows import lut_edge_rows
from tests.test_torch_dense import _nt_planes
from tests.test_torch_fused2 import _t

torch.set_num_threads(1)

SL = 8
NN = float(tables.QUAL_NN_SIMPLE_BAYESIAN)
# (lut_match, lut_mismatch, nn_term) as the engine builds them
LUTS = {
    "pear": (tables.QUAL_MATCH_PEAR, tables.QUAL_MISMATCH_PEAR,
             -math.log(0.25)),
    "rdp_mle": (tables.QUAL_MATCH_SIMPLE_BAYESIAN - NN,
                tables.QUAL_MISMATCH_RDP_MLE - NN, 0.0),
}

_jax_lut = jax.jit(jf.lut_plane_sums,
                   static_argnames=("L", "O", "algo_kind", "j0", "Oj"))


def _inputs(seed, B, L):
    """Nibble planes with N runs, pads and flen < rlen rows, and quals
    from -3 to 49 (both clips) with stale, nonzero qual tails past the
    read lengths, as the decoder leaves them."""
    rng = np.random.default_rng(seed)
    fwd, rev, nt, flen, rlen = _nt_planes(rng, B, L)
    fr_q = rng.integers(-3, 50, (B, L)).astype(np.int8)
    rr_q = rng.integers(-3, 50, (B, L)).astype(np.int8)
    assert (flen < rlen).any() and (fwd == 15).any() and (fwd == 0).any()
    return fwd, rev, nt, fr_q, rr_q, flen, rlen


def _port_sums(fwd, rev, fr_q, rr_q, flen, rlen, L, O, kind, j0=0,
               Oj=None, absolute=False):
    tm, tmm, nn = LUTS[kind]
    if absolute:  # sum|term| per diagonal, for the bound
        tm, tmm, nn = np.abs(tm), np.abs(tmm), abs(nn)
    return tf.lut_plane_sums(
        _t(fr_q), _t(rr_q), _t(fwd.astype(np.int32)),
        _t(rev.astype(np.int32)), _t(flen), _t(rlen), L, O, kind, tm, tmm,
        nn, j0, Oj).numpy()


def _jax_sums(fwd, rev, fr_q, rr_q, flen, rlen, L, O, kind, j0=0,
              Oj=None):
    tm, tmm, nn = LUTS[kind]
    return np.asarray(_jax_lut(fr_q, rr_q, fwd.astype(np.int32),
                               rev.astype(np.int32), flen, rlen, L=L, O=O,
                               algo_kind=kind, lut_match=tm,
                               lut_mismatch=tmm, nn_term=nn, j0=j0,
                               Oj=Oj))


def _bound(*args, **kw):
    return 2e-5 * _port_sums(*args, absolute=True, **kw) + 1e-6


@pytest.mark.parametrize("kind", ["pear", "rdp_mle"])
@pytest.mark.parametrize("L,O", [(128, 128), (128, 96)])
def test_lut_plane_sums_equals_jax(kind, L, O):
    fwd, rev, _, fr_q, rr_q, flen, rlen = _inputs(len(kind) + O, 24, L)
    args = (fwd, rev, fr_q, rr_q, flen, rlen, L, O, kind)
    full = _port_sums(*args)
    bound = _bound(*args)
    assert full.dtype == np.float32 and full.shape == (24, O)
    err = np.abs(full.astype(np.float64) - _jax_sums(*args))
    assert (err <= bound).all()
    assert err.max() < 0.1 * bound.max()
    for op in (2, 4):
        Oj = O // op
        blocks = [(j0, Oj) for j0 in range(0, O, Oj)]
        parts = [_port_sums(*args, j0=j0, Oj=Oj) for j0, Oj in blocks]
        for (j0, Oj), part in zip(blocks, parts):
            want = _jax_sums(*args, j0=j0, Oj=Oj)
            assert (np.abs(part - want) <= _bound(*args, j0=j0, Oj=Oj)).all()
        assert (np.abs(np.sum(parts, axis=0, dtype=np.float64) - full)
                <= bound).all()


@pytest.mark.parametrize("kind", ["pear", "rdp_mle"])
@pytest.mark.parametrize("L,O", [(64, 32), (128, 96), (128, 128)])
def test_lut_plane_sums_edge_rows_equal_jax(kind, L, O):
    """The edge rows of tests/lut_rows.py (interior pads, N runs on
    either side, quals outside [0, 46], all-pad rows, flen or rlen 0,
    pear's stale tail) against the JAX package, over the full plane and
    the row blocks of op 2 and 4; a row without bases sums to +0.0."""
    fwd, rev, fr_q, rr_q, flen, rlen = lut_edge_rows(
        np.random.default_rng(L + O + len(kind)), 32, L)
    args = (fwd, rev, fr_q, rr_q, flen, rlen, L, O, kind)
    blocks = [(0, O)] + [(j0, O // op) for op in (2, 4)
                         for j0 in range(0, O, O // op)]
    for j0, Oj in blocks:
        got = _port_sums(*args, j0=j0, Oj=Oj)
        want = _jax_sums(*args, j0=j0, Oj=Oj)
        assert (np.abs(got - want) <= _bound(*args, j0=j0, Oj=Oj)).all()
        empty = (flen == 0) | (rlen == 0)
        assert (got[empty].view(np.int32) == 0).all()
    assert got.any()


def test_pear_reads_the_stale_forward_tail():
    """pear takes q2 from the forward qual buffer, past flen too: the
    stale tail changes the sums of flen < rlen rows, and only of rows
    that reach past flen; rdp_mle never reads it."""
    L = O = 128
    fwd, rev, _, fr_q, rr_q, flen, rlen = _inputs(5, 24, L)
    clean = fr_q.copy()
    clean[np.arange(L)[None, :] >= flen[:, None]] = 0
    for kind in ("pear", "rdp_mle"):
        a = _port_sums(fwd, rev, fr_q, rr_q, flen, rlen, L, O, kind)
        b = _port_sums(fwd, rev, clean, rr_q, flen, rlen, L, O, kind)
        changed = (a != b).any(axis=1)
        if kind == "pear":
            assert changed.any() and (flen[changed] < rlen[changed]).all()
            want = _jax_sums(fwd, rev, clean, rr_q, flen, rlen, L, O, kind)
            assert (np.abs(b - want) <= _bound(
                fwd, rev, clean, rr_q, flen, rlen, L, O, kind)).all()
        else:
            assert not changed.any()


def _check_lut_shortlist(got, wide, want, bound):
    """got / want: [B, 2*SL+4] of the port and of JAX; wide: the port's
    shortlist at SL+1 (for the gap below the SL-th score); bound: [B]
    per-row bound of the score differences."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    wide = wide.numpy() if isinstance(wide, torch.Tensor) else wide
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got[:, 2 * SL + 1], want[:, 2 * SL + 1])
    f32 = list(range(SL, 2 * SL)) + [2 * SL + 3]
    gs = got[:, f32].view(np.float32).astype(np.float64)
    ws = want[:, f32].view(np.float32).astype(np.float64)
    assert (np.abs(gs - ws) <= bound[:, None]).all()
    # rows whose SL-th and SL+1-th scores are apart (or no SL+1-th)
    ws_wide = wide[:, SL + 1:2 * SL + 2].view(np.float32).astype(
        np.float64)
    apart = ((ws_wide[:, SL - 1] - ws_wide[:, SL] > 2 * bound)
             | (ws_wide[:, SL] < -1e38))  # no SL+1-th candidate
    np.testing.assert_array_equal(np.sort(got[apart, :SL], axis=1),
                                  np.sort(want[apart, :SL], axis=1))
    first = ((ws_wide[:, 0] - ws_wide[:, 1] > 2 * bound)
             | (ws_wide[:, 1] < -1e38))
    np.testing.assert_array_equal(got[first, 2 * SL], want[first, 2 * SL])
    assert apart.sum() >= 4 and first.sum() >= 4


@pytest.mark.parametrize("kind", ["pear", "rdp_mle"])
@pytest.mark.parametrize("maxoverlap", [0, 100])
@pytest.mark.parametrize("num_kmers", [0, 2])
def test_assemble_shortlist_equals_jax(kind, maxoverlap, num_kmers):
    L = O = 128
    fwd, rev, nt, fr_q, rr_q, flen, rlen = _inputs(
        maxoverlap + num_kmers + len(kind), 24, L)
    rng = np.random.default_rng(maxoverlap)
    fo = rng.integers(0, 3, 24).astype(np.int32)
    ro = rng.integers(0, 3, 24).astype(np.int32)
    tm, tmm, nn = LUTS[kind]
    kw = dict(L=L, O=O, minoverlap=3, maxoverlap=maxoverlap,
              num_kmers=num_kmers, algo_kind=kind, nn_term=nn,
              lut_match=tm, lut_mismatch=tmm)
    want = jf.assemble_shortlist(nt, fr_q, rr_q, flen, rlen, fo, ro, **kw)
    args = [_t(a) for a in (nt, fr_q, rr_q, flen, rlen, fo, ro)]
    got = tf.assemble_shortlist(*args, **kw)
    wide = tf.assemble_shortlist(*args, SL=SL + 1, **kw)
    bound = _bound(fwd, rev, fr_q, rr_q, flen, rlen, L, O, kind).max(1)
    _check_lut_shortlist(got, wide, want, bound)
    assert (got.numpy()[:, 2 * SL + 1] > 0).any()


@pytest.mark.parametrize("kind", ["pear", "rdp_mle"])
def test_assemble_shortlist_packed_equals_jax(kind):
    """The [B, 3L] single-upload form equals the three-plane form and
    the JAX package's packed step."""
    L = O = 128
    fwd, rev, nt, fr_q, rr_q, flen, rlen = _inputs(11, 24, L)
    zeros = np.zeros(24, np.int32)
    tm, tmm, nn = LUTS[kind]
    kw = dict(L=L, algo_kind=kind, nn_term=nn, lut_match=tm,
              lut_mismatch=tmm)
    plane = np.concatenate([nt, fr_q, rr_q], axis=1)
    got = tf.assemble_shortlist_packed(_t(plane), *map(_t, (
        flen, rlen, zeros, zeros)), **kw)
    three = tf.assemble_shortlist(*map(_t, (nt, fr_q, rr_q, flen, rlen,
                                            zeros, zeros)), **kw)
    assert torch.equal(got, three)
    wide = tf.assemble_shortlist_packed(_t(plane), *map(_t, (
        flen, rlen, zeros, zeros)), SL=SL + 1, **kw)
    want = jf.assemble_shortlist_packed(plane, flen, rlen, zeros, zeros,
                                        **kw)
    bound = _bound(fwd, rev, fr_q, rr_q, flen, rlen, L, O, kind).max(1)
    _check_lut_shortlist(got, wide, want, bound)


def test_lut_shortlist_band_and_kind_checks():
    """The LUT kinds default to BAND_LUT; the plain shortlist takes
    lutsum with the LUT kinds only; the tables are required."""
    L = O = 64
    fwd, rev, nt, fr_q, rr_q, flen, rlen = _inputs(3, 8, L)
    zeros = np.zeros(8, np.int32)
    tm, tmm, nn = LUTS["rdp_mle"]
    args = [_t(a) for a in (nt, fr_q, rr_q, flen, rlen, zeros, zeros)]
    kw = dict(L=L, algo_kind="rdp_mle", lut_match=tm, lut_mismatch=tmm)
    assert torch.equal(tf.assemble_shortlist(*args, **kw),
                       tf.assemble_shortlist(*args, band=tf.BAND_LUT, **kw))
    with pytest.raises(ValueError, match="lut_match"):
        tf.assemble_shortlist(*args, L=L, algo_kind="pear")
    m = torch.zeros((8, O), dtype=torch.int32)
    kw = dict(O=O, SL=SL, minoverlap=2, maxoverlap=0, pmatch=0.0,
              pmismatch=0.0, nn=NN, band=0.05)
    lens = _t(flen)
    with pytest.raises(ValueError, match="lutsum"):
        tf.plain_shortlist(m, m, m, lens, lens, lens, lens,
                           algo_kind="pear", **kw)
    with pytest.raises(ValueError, match="lutsum"):
        tf.plain_shortlist(m, m, m, lens, lens, lens, lens,
                           algo_kind="counts", lutsum=m.float(), **kw)
