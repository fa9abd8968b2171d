"""The PyTorch port's multi-device paths (pandaseq_tpu_torch/parallel/
shard.py and the engine under a mesh) on the CPU against the JAX
package, on ``make_mesh(devices=["cpu"] * 8, op=2|4)`` — the port's form
of the JAX tests' 8-device virtual mesh (tests/conftest.py).

Tolerances: the sharded count-kind and candidate steps equal the port's
single-device steps bit for bit, and the JAX package's integer columns
and masks bit for bit (its f32 score columns within the bound of
tests/test_torch_dense.py, which states why); engine bytes and STAT
counters are equal. pear / rdp_mle add their f32 LUT sums over op in
another order, so their shortlist SET and ``examined`` count are equal,
as tests/test_parallel.py holds the JAX package."""

import math

import numpy as np
import pytest
import torch

from pandaseq_tpu.assembler import BatchAssembler as JaxAssembler
from pandaseq_tpu.ops import fused2 as jf
from pandaseq_tpu_torch import oracle
from pandaseq_tpu_torch.assembler import BatchAssembler, make_batch
from pandaseq_tpu_torch.io import fastq as fq
from pandaseq_tpu_torch.io import output as out_mod
from pandaseq_tpu_torch.ops import cand
from pandaseq_tpu_torch.ops import fused2 as tf
from pandaseq_tpu_torch.parallel import shard
from tests.test_parallel import _example_rev, _pack
from tests.test_torch_assembler import SYNTH, _emit, _jax_cfg
from tests.test_torch_dense import _check_shortlist
from tests.test_torch_lut import LUTS

torch.set_num_threads(1)

SL = 8
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _device_engine(monkeypatch):
    monkeypatch.setenv("PANDASEQ_TPU_HOST", "0")
    monkeypatch.delenv("PANDASEQ_TPU_ENGINE", raising=False)
    monkeypatch.delenv("PANDASEQ_TPU_JOIN", raising=False)


def _args(B, L, seed):
    fwd_nt, fwd_q, rev_nt, rev_q, flen, rlen = _example_rev(B, L, seed)
    zeros = np.zeros(B, dtype=np.int32)
    return (_pack(fwd_nt, rev_nt), fwd_q, rev_q, flen, rlen, zeros, zeros)


@pytest.mark.parametrize("num_kmers", [1, 2, 3])
@pytest.mark.parametrize("op", [2, 4])
def test_sharded_step_matches_single_device(op, num_kmers):
    """The dp x op-sharded shortlist step (row blocks of matches and N,
    the k-mer hits of every row in each dp row's first cell, partial
    counts added over op) equals the single-device step bit for bit."""
    L, B = 128, 32
    q = 0.36
    kw = dict(pmatch=math.log(0.25 * (1 - q) ** 2),
              pmismatch=math.log((3 * q - 2 * q * q) / 18),
              num_kmers=num_kmers)
    args = _args(B, L, 3)
    mesh = shard.make_mesh(devices=CPU8, op=op)
    assert mesh.shape == {"dp": 8 // op, "op": op}
    step = shard.make_sharded_step(mesh, L=L, **kw)
    sharded = step(*shard.shard_batch(mesh, args))
    single = tf.assemble_shortlist(*map(torch.from_numpy, args), L=L, **kw)
    assert torch.equal(sharded, single)
    assert torch.equal(step(*args), single)  # host arrays shard themselves
    _check_shortlist(sharded, jf.assemble_shortlist(*args, L=L, **kw))


@pytest.mark.parametrize("num_kmers", [1, 2, 3])
@pytest.mark.parametrize("kind", ["pear", "rdp_mle"])
def test_sharded_step_lut_matches_single_device(kind, num_kmers):
    L, B = 128, 16
    args = _args(B, L, 9)
    tm, tmm, nn = LUTS[kind]
    kw = dict(algo_kind=kind, nn_term=nn, lut_match=tm, lut_mismatch=tmm,
              num_kmers=num_kmers)
    mesh = shard.make_mesh(devices=CPU8, op=2)
    step = shard.make_sharded_step(mesh, L=L, **kw)
    sharded = step(*shard.shard_batch(mesh, args)).numpy()
    for single in (tf.assemble_shortlist(*map(torch.from_numpy, args),
                                         L=L, **kw).numpy(),
                   np.asarray(jf.assemble_shortlist(*args, L=L, **kw))):
        np.testing.assert_array_equal(np.sort(sharded[:, :SL], axis=1),
                                      np.sort(single[:, :SL], axis=1))
        np.testing.assert_array_equal(sharded[:, 2 * SL + 1],
                                      single[:, 2 * SL + 1])


def _counting_ops(monkeypatch):
    """Patch the ops the mesh steps take so that each call of the
    candidate search, and each counts call that searches k-mer hits
    (a hit range that is not empty), is recorded; returns the list."""
    calls = []
    ops = tf.device_ops

    def device_ops(dev):
        real = ops(dev)

        def candidates_join(*a, **k):
            calls.append("cand_join")
            return real.candidates_join(*a, **k)

        def counts(*a, hit_rows=None, **k):
            if a[5] and (hit_rows is None or hit_rows[1]):
                calls.append("join in counts")
            return real.counts(*a, hit_rows=hit_rows, **k)
        return real._replace(candidates_join=candidates_join, counts=counts)
    monkeypatch.setattr(shard.fused2, "device_ops", device_ops)
    return calls


@pytest.mark.parametrize("num_kmers", [0, 1, 2, 3])
@pytest.mark.parametrize("op", [2, 4])
def test_sharded_candidate_steps_match_single_device(monkeypatch, op,
                                                     num_kmers):
    """The candidate steps on the nibble plane and on the 4-bit packed
    upload: the mask of one search per dp row equals the JAX package's
    single-device mask; the search runs once per dp row, whatever op."""
    from pandaseq_tpu_torch.io.native import pack4

    L, B = 128, 32
    calls = _counting_ops(monkeypatch)
    nt, _, _, flen, rlen, _, _ = _args(B, L, 5)
    mesh = shard.make_mesh(devices=CPU8, op=op)
    step = shard.make_sharded_cand_step(mesh, L=L, num_kmers=num_kmers)
    got = step(*shard.shard_batch(mesh, (nt, flen, rlen)))
    want = np.asarray(jf.assemble_candidates_nt(nt, flen, rlen, L=L,
                                                num_kmers=num_kmers))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).any() == (num_kmers > 0)
    pairs = list(fq.read_pairs(SYNTH + "_1.fastq", SYNTH + "_2.fastq"))[:B]
    b = make_batch(pairs, 256)
    plane4, _ = pack4(b, 256)
    step4 = shard.make_sharded_cand_step_packed4(mesh, L=256,
                                                 num_kmers=num_kmers)
    got4 = step4(plane4, b.flen, b.rlen)
    want4 = np.asarray(jf.assemble_candidates_packed4(
        plane4, b.flen, b.rlen, L=256, num_kmers=num_kmers))
    np.testing.assert_array_equal(got4.numpy(), want4)
    assert (want4 != 0).any() == (num_kmers > 0)
    assert calls == ["cand_join"] * (2 * mesh.shape["dp"])


@pytest.mark.parametrize("num_kmers", [0, 2])
@pytest.mark.parametrize("op", [2, 4])
def test_sharded_step_joins_once_per_dp_row(monkeypatch, op, num_kmers):
    """The shortlist step counts the k-mer hits (its sort-join) in one op
    cell per dp row, and none at num_kmers 0; the result still equals
    the single-device step's."""
    L, B = 128, 32
    calls = _counting_ops(monkeypatch)
    args = _args(B, L, 4)
    mesh = shard.make_mesh(devices=CPU8, op=op)
    got = shard.make_sharded_step(mesh, L=L, num_kmers=num_kmers)(*args)
    assert calls == ["join in counts"] * (mesh.shape["dp"] if num_kmers
                                          else 0)
    assert torch.equal(got, tf.assemble_shortlist(
        *map(torch.from_numpy, args), L=L, num_kmers=num_kmers))


@pytest.mark.parametrize("algo", ["simple_bayesian", "rdp_mle"])
@pytest.mark.parametrize("num_kmers", [2, 0])
def test_assembler_op_mesh_bit_identical(algo, num_kmers):
    """A (dp, op) mesh through the engine: the sparse path (the packed
    candidate step, mask download) for both algorithms, and at -k 0 the
    shortlist step for simple_bayesian (rdp_mle stays sparse); bytes and
    counters equal the JAX package's unsharded engine. 200 pairs in
    batches of 64: every batch splits over dp=4."""
    cfg = oracle.OracleConfig(algorithm=oracle.make_algorithm(algo),
                              num_kmers=num_kmers)
    want = _emit(JaxAssembler(_jax_cfg(cfg)))
    cand.reset_launch_counts()
    mesh = shard.make_mesh(devices=CPU8, op=2)
    asm = BatchAssembler(cfg, device="cpu", mesh=mesh)
    assert want[0] and _emit(asm) == want
    assert len(asm._op_steps) == 1
    assert cand.launch_counts() == dict.fromkeys(cand.KERNELS, 0)


def test_assembler_dp_mesh_bit_identical():
    """A dp-only mesh (op=1): the single-device steps on each dp row's
    share, for the default path and the FASTQ form."""
    mesh = shard.make_mesh(devices=CPU8, op=1)
    assert mesh.shape == {"dp": 8, "op": 1}
    for fmt in ("fasta", "fastq"):
        asm = BatchAssembler(device="cpu", mesh=mesh)
        assert _emit(asm, fmt=fmt) == _emit(JaxAssembler(), fmt=fmt)
        assert not asm._op_steps


def test_unsplit_batch_runs_whole_and_equal():
    """dp=3: batches of 66 split, the last batch of 2 pairs does not (B %
    dp != 0) and runs whole on the mesh's first device; the bytes equal
    the JAX package's. -k 0 takes the shortlist step both ways."""
    mesh = shard.make_mesh(devices=["cpu"] * 6, op=2)
    assert shard.dp_rows(mesh, 2) == [(0, 2, [torch.device("cpu")])]
    assert [r[:2] for r in shard.dp_rows(mesh, 66)] == [
        (0, 22), (22, 44), (44, 66)]
    for k in (2, 0):
        cfg = oracle.OracleConfig(num_kmers=k)
        got = _emit(BatchAssembler(cfg, device="cpu", mesh=mesh), n=66)
        assert got == _emit(JaxAssembler(_jax_cfg(cfg)), n=66)


def test_shard_fused_batch_equals_single_device():
    """shard_fused_batch: one batch dispatched dp-sharded, finalized as
    on one device (port of test_production_fused_sharded_over_dp, held
    to the port's single-device engine instead of the C reference)."""
    pairs = list(fq.read_pairs(SYNTH + "_1.fastq", SYNTH + "_2.fastq",
                               policy="PRESENT"))[:64]

    def fasta(results):
        return b"".join(out_mod.format_fasta(r) for c, r in results
                        if c == "OK")

    want = fasta(BatchAssembler(L=512, device="cpu").assemble_batch(pairs))
    asm = BatchAssembler(L=512, device="cpu")
    st, dev = shard.shard_fused_batch(shard.make_mesh(devices=CPU8), asm,
                                      make_batch(pairs, 512))
    assert asm.mesh is None
    assert want and fasta(asm._finalize(st, dev)) == want


def test_mesh_pins_the_device_engine(monkeypatch):
    """With no engine pinned, a mesh pins the device engine (reason
    "mesh"), before the probe, as in the JAX package."""
    monkeypatch.delenv("PANDASEQ_TPU_HOST")
    asm = BatchAssembler(device="cpu", mesh=shard.make_mesh(devices=CPU8))
    assert asm.engine == "cpu"
    assert asm.engine_info == {"reason": "mesh"}


def test_mesh_checks():
    """A mixed CPU / CUDA mesh, a ragged grid, a count that does not
    factor, a foreign mesh object and a device of another type raise."""
    with pytest.raises(ValueError, match="mixes device types"):
        shard.make_mesh(devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="rectangular"):
        shard.Mesh([["cpu", "cpu"], ["cpu"]])
    with pytest.raises(ValueError, match="does not make"):
        shard.make_mesh(devices=["cpu"] * 6, op=4)
    with pytest.raises(TypeError, match="make_mesh"):
        BatchAssembler(device="cpu", mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shard.make_mesh()
    mesh = shard.make_mesh(devices=CPU8, op=2)
    with pytest.raises(ValueError, match="type"):
        BatchAssembler(device="cuda", mesh=mesh)
    step = shard.make_sharded_step(shard.make_mesh(devices=CPU8, op=8),
                                   L=140)
    with pytest.raises(ValueError, match="row blocks"):
        step(*_args(8, 140, 1))  # O=140 does not split into 8 row blocks
