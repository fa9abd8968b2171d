"""The PyTorch port's k-mer iterator (pandaseq_tpu_torch/kmer_iter.py)
against the JAX package's (pandaseq_tpu/kmer_iter.py): the same arrays
from ``kmers_of`` and the same emissions from ``iterate``,
``iterate_qual`` and ``iterate_result``, on seeded nt codes with N runs,
lengths 0-300, both directions and k in {None, -1, 0, 1, 8, 17, 32, 40}
(k < 1 means 8, k caps at 32)."""

import numpy as np
import pytest

from pandaseq_tpu import kmer_iter as jax_iter
from pandaseq_tpu_torch import kmer_iter as port_iter

KS = [None, -1, 0, 1, 8, 17, 32, 40]
CODES = np.array([1, 2, 4, 8], dtype=np.int8)  # A C G T


def _seq(seed, n):
    """Seeded 4-bit nt codes of length ``n`` with N runs (code 15)."""
    rng = np.random.default_rng(seed)
    nt = CODES[rng.integers(0, 4, n)]
    for _ in range(rng.integers(0, 4)):
        if n:
            lo = int(rng.integers(0, n))
            nt[lo:lo + int(rng.integers(1, 12))] = 15
    return nt


def _outcome(fn, *args):
    try:
        return fn(*args)
    except OverflowError as e:
        return e


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 33, 150, 300])
def test_port_kmer_iter_equals_jax(k, reverse, n):
    nt = _seq(n * 31 + (k or 0) + 100, n)
    length = None if n % 2 else n  # default length and an explicit one
    got, want = (_outcome(m.kmers_of, nt, length, reverse, k)
                 for m in (port_iter, jax_iter))
    if isinstance(want, Exception):
        # a 32-mer whose first base is G or T does not fit int64: both
        # packages raise the same error
        assert type(got) is type(want) and str(got) == str(want)
    else:
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int64
            np.testing.assert_array_equal(g, w)
    for name in ("iterate", "iterate_qual", "iterate_result"):
        assert list(getattr(port_iter, name)(nt, length, reverse, k)) == \
            list(getattr(jax_iter, name)(nt, length, reverse, k)), name
    assert port_iter._clamp_k(k) == jax_iter._clamp_k(k)


def test_port_kmer_iter_api():
    assert port_iter.__all__ == jax_iter.__all__
    assert port_iter.KMER_LEN == jax_iter.KMER_LEN == 8
    assert [port_iter._clamp_k(k) for k in KS] == [8, 8, 8, 1, 8, 17, 32,
                                                   32]
