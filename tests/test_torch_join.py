"""The sorted k-mer join of the PyTorch port on the CPU: ``cand_mask_join``
(K9, pandaseq_tpu_torch/ops/fused2.py) against the JAX package's
``cand_mask_join`` and against the plain candidate mask, the plain
version of the ``cand_join`` kernel against the JAX package's candidate
steps, and the engine under ``PANDASEQ_TPU_JOIN``.

Inputs are seeded numpy rows of five kinds: random codes, low-entropy
rows over two codes (deep k-mer runs: the rank drops occurrences),
rows whose reverse read holds the forward read's k-mers on one planted
diagonal, rows with N bases, and short reads. Every compared value is
an integer, so the tolerance is 0: equal bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pandaseq_tpu.assembler import BatchAssembler as JaxAssembler
from pandaseq_tpu.ops import fused2 as jf
from pandaseq_tpu_torch import oracle
from pandaseq_tpu_torch.assembler import BatchAssembler
from pandaseq_tpu_torch.ops import cand
from pandaseq_tpu_torch.ops import fused2 as tf
from tests.test_torch_assembler import _emit, _jax_cfg
from tests.test_torch_fused2 import _eq, _t

torch.set_num_threads(1)

_jax_join = jax.jit(jf.cand_mask_join, static_argnums=(6, 7, 8))

SHAPES = [(64, 64), (64, 32), (128, 128), (128, 64), (256, 256),
          (256, 160)]  # (L, O), O <= L


def _rows(B, L, seed):
    """(cf, nonn_f, cr, nonn_r, flen, rlen): 2-bit codes, non-N masks
    and lengths of B rows, row b of kind b % 5 (see module doc)."""
    rng = np.random.default_rng(seed)
    cf = rng.integers(0, 4, (B, L)).astype(np.int32)
    cr = rng.integers(0, 4, (B, L)).astype(np.int32)
    nonn_f = np.ones((B, L), bool)
    nonn_r = np.ones((B, L), bool)
    flen = rng.integers(L // 2, L + 1, B).astype(np.int32)
    rlen = rng.integers(L // 2, L + 1, B).astype(np.int32)
    for b in range(B):
        kind = b % 5
        if kind == 1:
            cf[b] &= 1
            cr[b] &= 1
        elif kind == 2:
            s = int(rng.integers(8, 2 * L - 8))
            x = np.arange(L)
            src = s - x
            ok = (src >= 0) & (src < L)
            cr[b, ok] = cf[b, src[ok]]
        elif kind == 3:
            nonn_f[b] = rng.random(L) > 0.05
            nonn_r[b] = rng.random(L) > 0.05
            nonn_f[b, 10:20] = False
        elif kind == 4:
            flen[b] = rng.integers(0, 20)
            rlen[b] = rng.integers(0, 20)
    flen[:2] = L
    rlen[:2] = L
    return cf, nonn_f, cr, nonn_r, flen, rlen


@pytest.mark.parametrize("num_kmers", [1, 2])
@pytest.mark.parametrize("L,O", SHAPES)
def test_cand_mask_join_equals_jax(L, O, num_kmers):
    args = _rows(40, L, 10 * L + O + num_kmers)
    want = _jax_join(*map(jnp.asarray, args), L, O, num_kmers)
    got = tf.cand_mask_join(*map(_t, args), L, O, num_kmers)
    _eq(got, want)
    assert (got != 0).any()


@pytest.mark.parametrize("num_kmers", [0, 1, 2, 3])
@pytest.mark.parametrize("L,O", SHAPES)
def test_cand_mask_join_equals_plain_mask(L, O, num_kmers):
    """The join against the kmer_frames_codes + plain_candidates mask:
    equal at every num_kmers, also past the JAX package's routing
    bound of 2, and empty at 0."""
    args = [_t(a) for a in _rows(40, L, 7 * L + O + num_kmers)]
    got = tf.cand_mask_join(*args, L, O, num_kmers)
    Fkm, Rkm = tf.kmer_frames_codes(*args, L, num_kmers)
    _eq(got, tf.plain_candidates(Fkm, Rkm, O, "mask").numpy())
    assert (got != 0).any() == (num_kmers > 0)


def _planes(args, L):
    """The packed plane4 (psq_pack4 layout, N dropped) and the nibble
    plane (N as 0x0F, pads past the read 0) of ``_rows`` rows."""
    cf, nonn_f, cr, nonn_r, flen, rlen = args
    B = cf.shape[0]
    q = L // 4
    plane4 = np.zeros((B, L // 2), np.uint8)
    for t in range(4):
        plane4[:, :q] |= (cf[:, t * q:(t + 1) * q] << (2 * t)).astype(
            np.uint8)
        plane4[:, q:] |= (cr[:, t * q:(t + 1) * q] << (2 * t)).astype(
            np.uint8)
    onehot = np.array([1, 2, 4, 8], np.uint8)
    pos = np.arange(L)[None, :]
    fwd = np.where(nonn_f, onehot[cf], 0x0F).astype(np.uint8)
    rev = np.where(nonn_r, onehot[cr], 0x0F).astype(np.uint8)
    fwd[pos >= flen[:, None]] = 0
    rev[pos >= rlen[:, None]] = 0
    nt = fwd | (rev << 4)
    return plane4.view(np.int8), nt.view(np.int8)


@pytest.mark.parametrize("num_kmers", [1, 2, 3])
@pytest.mark.parametrize("L,O", SHAPES)
def test_plain_candidates_join_equals_jax_steps(L, O, num_kmers):
    """plain_candidates_join, the cand_join kernel's plain version: on
    the packed plane its list and mask equal the JAX package's
    assemble_candidates_list_packed4 / assemble_candidates_packed4, on
    the nibble plane (with N) its mask equals assemble_candidates_nt."""
    args = _rows(40, L, 3 * L + O + num_kmers)
    plane4, nt = _planes(args, L)
    flen, rlen = args[4], args[5]
    kw = dict(L=L, O=O, num_kmers=num_kmers)
    for mode, jax_step in (("list", jf.assemble_candidates_list_packed4),
                           ("mask", jf.assemble_candidates_packed4)):
        got = tf.plain_candidates_join(_t(plane4), _t(flen), _t(rlen), L, O,
                                       num_kmers, mode)
        _eq(got, jax_step(plane4, flen, rlen, **kw))
    full = tf.plain_candidates_join(_t(nt), _t(flen), _t(rlen), L, O,
                                    num_kmers, "mask", nt=True)
    _eq(full, jf.assemble_candidates_nt(nt, flen, rlen, **kw))
    assert (full != 0).any()


@pytest.mark.parametrize("num_kmers", [1, 2, 3])
def test_join_env_routes_the_cpu_mask_step(monkeypatch, num_kmers):
    """PANDASEQ_TPU_JOIN: a CPU mask step at num_kmers <= 2 goes through
    cand_mask_join (as the JAX package's step does), with the mask of
    the default step; at 3 the default step runs."""
    L, O = 128, 96
    args = _rows(40, L, 77 + num_kmers)
    plane4, _ = _planes(args, L)
    flen, rlen = _t(args[4]), _t(args[5])
    kw = dict(L=L, O=O, num_kmers=num_kmers)
    want = tf.assemble_candidates_packed4(_t(plane4), flen, rlen, **kw)
    calls = []
    join = tf.cand_mask_join
    monkeypatch.setattr(tf, "cand_mask_join",
                        lambda *a: calls.append(a[-1]) or join(*a))
    monkeypatch.setenv("PANDASEQ_TPU_JOIN", "1")
    got = tf.assemble_candidates_packed4(_t(plane4), flen, rlen, **kw)
    _eq(got, want.numpy())
    assert calls == ([num_kmers] if num_kmers <= 2 else [])


@pytest.mark.parametrize("num_kmers", [1, 2])
def test_engine_join_env_same_fasta(monkeypatch, num_kmers):
    """The engine under PANDASEQ_TPU_JOIN=1 on the CPU (the mask
    download, the sorted join) writes the FASTA and STAT counters it
    writes without it, and the JAX package's engine's."""
    monkeypatch.setenv("PANDASEQ_TPU_HOST", "0")
    monkeypatch.delenv("PANDASEQ_TPU_ENGINE", raising=False)
    monkeypatch.delenv("PANDASEQ_TPU_JOIN", raising=False)
    cfg = oracle.OracleConfig(num_kmers=num_kmers)
    want = _emit(BatchAssembler(cfg, device="cpu"))
    assert want[0]
    calls = []
    join = tf.cand_mask_join
    monkeypatch.setattr(tf, "cand_mask_join",
                        lambda *a: calls.append(a[-1]) or join(*a))
    monkeypatch.setenv("PANDASEQ_TPU_JOIN", "1")
    asm = BatchAssembler(cfg, device="cpu")
    assert not asm._cand_list
    cand.reset_launch_counts()
    assert _emit(asm) == want
    assert calls and set(calls) == {num_kmers}
    assert cand.launch_counts() == dict.fromkeys(cand.KERNELS, 0)
    assert _emit(JaxAssembler(_jax_cfg(cfg))) == want


@pytest.mark.parametrize("device,cand_list", [("cpu", False),
                                              ("cuda", True)])
def test_join_env_sets_the_download_on_the_cpu_only(monkeypatch, device,
                                                    cand_list):
    """PANDASEQ_TPU_JOIN takes the bitmask download only on the CPU,
    where the mask step is the sorted join; an engine on a card keeps
    the candidate list, since cand_join runs either way. (The engine is
    built, never run: no card is needed.)"""
    from pandaseq_tpu_torch import runtime
    monkeypatch.setattr(runtime, "resolve_device",
                        lambda d: torch.device(d))
    monkeypatch.setenv("PANDASEQ_TPU_JOIN", "1")
    assert BatchAssembler(device=device)._cand_list is cand_list
    monkeypatch.delenv("PANDASEQ_TPU_JOIN")
    assert BatchAssembler(device=device)._cand_list


def test_candidates_join_takes_cuda_tensors_only():
    """The kernel's wrapper launches on a CUDA tensor or raises; a CPU
    tensor is refused, not run through the plain version."""
    plane = torch.zeros((2, 64), dtype=torch.int8)
    lens = torch.full((2,), 100, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cand.candidates_join(plane, lens, lens, 128, 128, 2, "list", 4)
    with pytest.raises(ValueError, match="CUDA"):
        cand.candidates_join(plane, lens, lens, 64, 64, 2, "mask", 4,
                             nt=True)
    assert cand.launch_counts()["cand_join"] == 0
