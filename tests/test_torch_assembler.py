"""The PyTorch port's batch engine (pandaseq_tpu_torch/assembler.py) on
the CPU against the JAX package's engine: the same emitted bytes and STAT
counters for all seven built-in algorithms on the sparse path, for the
five count-based ones at -k 0 and for a custom algorithm on the dense
path, through the same host pipeline (and on a mesh: one case here, the
rest in tests/test_torch_parallel.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pandaseq_tpu import oracle as jax_oracle
from pandaseq_tpu.assembler import BatchAssembler as JaxAssembler
from pandaseq_tpu.io import native as jax_native
from pandaseq_tpu_torch import oracle
from pandaseq_tpu_torch.assembler import BatchAssembler, _PendingList
from pandaseq_tpu_torch.io import native
from pandaseq_tpu_torch.ops import cand
from pandaseq_tpu_torch.parallel import shard

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SYNTH = os.path.join(DATA, "synth")
ALGORITHMS = ["simple_bayesian", "uparse", "pear", "rdp_mle", "ea_util",
              "flash", "stitch"]


def _batches(n, prefix=SYNTH, reader=native):
    """tests/data/synth_* (or another pair of files) in native-decoder
    batches of n pairs, decoded by ``reader``: the port's io.native, or
    the JAX package's for its own engine."""
    return reader.NativeBatchReader(prefix + "_1.fastq",
                                    prefix + "_2.fastq", batch=n, L=512)


def _jax_cfg(cfg):
    """The JAX package's OracleConfig with the same values as the
    port's ``cfg`` (each engine gets its own package's objects)."""
    out = jax_oracle.OracleConfig(
        **{k: getattr(cfg, k) for k in cfg.__dataclass_fields__
           if k != "algorithm"})
    out.algorithm = jax_oracle.make_algorithm(cfg.algorithm.name, None)
    return out


def _emit(asm, n=64, group=1, fmt="fasta", prefix=SYNTH):
    reader = native if isinstance(asm, BatchAssembler) else jax_native
    payload = b"".join(p for _, _, p in asm.emit_stream(
        _batches(n, prefix, reader), fmt=fmt, depth=2, threaded=True,
        group=group))
    c = asm.counters
    return payload, (c.count, c.ok, c.lowq, c.noalgn, c.badread, c.slow,
                     dict(c.overlaps))


@pytest.fixture(autouse=True)
def _device_engine(monkeypatch):
    monkeypatch.setenv("PANDASEQ_TPU_HOST", "0")
    monkeypatch.delenv("PANDASEQ_TPU_ENGINE", raising=False)
    monkeypatch.delenv("PANDASEQ_TPU_JOIN", raising=False)


@pytest.mark.parametrize("name", ALGORITHMS)
def test_engine_equals_jax_engine(name):
    cfg = oracle.OracleConfig()
    cfg.algorithm = oracle.make_algorithm(name, None)
    want = _emit(JaxAssembler(_jax_cfg(cfg)))
    cand.reset_launch_counts()
    asm = BatchAssembler(cfg, device="cpu")
    assert asm.engine == "cpu"
    got = _emit(asm)
    assert want[0] and got == want
    # plain twins on the CPU: no kernel launched
    assert cand.launch_counts() == dict.fromkeys(cand.KERNELS, 0)
    np.testing.assert_array_equal(asm._ptbl.view(np.uint64),
                                  JaxAssembler(_jax_cfg(cfg))._ptbl.view(
                                      np.uint64))


def test_grouped_dispatch_and_mask_form_equal_jax(monkeypatch):
    """Stacked batches (_SharedFetch over one _PendingList) and the
    bitmask download (PANDASEQ_TPU_JOIN) give the same bytes."""
    want = _emit(JaxAssembler(), fmt="fastq")
    assert _emit(BatchAssembler(device="cpu"), group=3,
                 fmt="fastq") == want
    monkeypatch.setenv("PANDASEQ_TPU_JOIN", "1")
    asm = BatchAssembler(device="cpu")
    assert not asm._cand_list
    assert _emit(asm, fmt="fastq") == want


def test_launch_returns_host_arrays():
    asm = BatchAssembler(device="cpu")
    st = asm._pre(next(iter(_batches(16))))
    dev = asm._dispatch(st)
    assert isinstance(dev, _PendingList)
    lst = np.asarray(dev)
    assert lst.dtype == np.int16 and lst.shape == (16, 6)
    assert np.asarray(dev, dtype=np.int32).dtype == np.int32


def test_host_engine_pin_and_k0(monkeypatch):
    """-k 0 on the device is the dense shortlist path: it runs through
    the three dense twins and equals the JAX package's device engine.
    Pinned to the host engine it runs the native twin, equal to the JAX
    package's host engine. A (dp, op) mesh of CPU devices runs the
    sharded twins to the same bytes."""
    cfg = oracle.OracleConfig()
    cfg.num_kmers = 0
    asm = BatchAssembler(cfg, device="cpu")
    st = asm._pre(next(iter(_batches(16))))
    lst = np.asarray(asm._dispatch(st))
    assert st["plane_kind"] == 0
    assert lst.dtype == np.int32 and lst.shape == (16, 2 * asm.SL + 4)
    assert _emit(BatchAssembler(cfg, device="cpu")) == _emit(
        JaxAssembler(_jax_cfg(cfg)))
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "host")
    asm = BatchAssembler(cfg, device="cpu")
    assert asm.engine == "host"
    assert _emit(asm) == _emit(JaxAssembler(_jax_cfg(cfg)))
    monkeypatch.delenv("PANDASEQ_TPU_ENGINE")
    mesh = shard.make_mesh(devices=["cpu"] * 8, op=2)
    asm = BatchAssembler(cfg, device="cpu", mesh=mesh)
    assert asm.mesh is mesh and asm.engine == "cpu"
    assert _emit(asm) == _emit(JaxAssembler(_jax_cfg(cfg)))


@pytest.mark.parametrize("name", ["simple_bayesian", "uparse", "ea_util",
                                  "flash", "stitch"])
def test_engine_k0_equals_jax_engine(name):
    """-k 0, the dense device path, for each count-based algorithm."""
    cfg = oracle.OracleConfig()
    cfg.algorithm = oracle.make_algorithm(name, None)
    cfg.num_kmers = 0
    want = _emit(JaxAssembler(_jax_cfg(cfg)))
    cand.reset_launch_counts()
    got = _emit(BatchAssembler(cfg, device="cpu"))
    assert want[0] and got == want
    assert cand.launch_counts() == dict.fromkeys(cand.KERNELS, 0)


def test_custom_algorithm_equals_jax_engine():
    """A custom algorithm takes the dense path at any -k: the shortlist
    shapes the plane, and every pair replays through the oracle."""

    class Mimic(oracle.SimpleBayes):
        name = "mimic_sb"

    class JaxMimic(jax_oracle.SimpleBayes):
        name = "mimic_sb"

    cfg = oracle.OracleConfig(algorithm=Mimic())
    asm = BatchAssembler(cfg, device="cpu")
    assert asm._custom
    want = _emit(JaxAssembler(
        jax_oracle.OracleConfig(algorithm=JaxMimic())))
    assert want[0] and _emit(asm) == want


@pytest.mark.parametrize("name", ["simple_bayesian", "pear"])
def test_overflow_reroute_equals_jax(tmp_path, name):
    """-O beyond the frame width with long reads: batches whose
    overlap axis exceeds the device plane go to the host candidate twin
    at full mask width (_overflow_host), in the port as in the JAX
    package."""
    prefix = str(tmp_path / "longo")
    subprocess.run([sys.executable,
                    os.path.join(os.path.dirname(DATA), "golden",
                                 "make_data.py"),
                    "--pairs", "120", "--seed", "99", "--read-len", "440",
                    "--amp-min", "500", "--amp-max", "870",
                    "--out-prefix", prefix],
                   check=True, stdout=subprocess.DEVNULL)
    cfg = oracle.OracleConfig(minoverlap=4, maxoverlap=850)
    cfg.algorithm = oracle.make_algorithm(name, None)
    want = _emit(JaxAssembler(_jax_cfg(cfg)), prefix=prefix)
    got = _emit(BatchAssembler(cfg, device="cpu"), prefix=prefix)
    assert want[0] and got == want
