"""The PyTorch port's batch engine (pandaseq_tpu_torch/assembler.py) on
the CPU against the JAX package's engine: the same emitted bytes and STAT
counters for all seven built-in algorithms on the sparse path, for the
five count-based ones at -k 0 and for a custom algorithm on the dense
path, through the same host pipeline (and on a mesh: one case here, the
rest in tests/test_torch_parallel.py); the host engine against the JAX
package's at -k 1 to 3; and -k 3 to 8, where no engine takes a device
step."""

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


def _emit(asm, n=64, group=1, fmt="fasta", prefix=SYNTH, depth=2,
          codes=False):
    """The threaded emit_stream's payload and STAT counters (and, with
    ``codes``, every pair's code name in input order)."""
    reader = native if isinstance(asm, BatchAssembler) else jax_native
    out = list(asm.emit_stream(_batches(n, prefix, reader), fmt=fmt,
                               depth=depth, threaded=True, group=group))
    payload = b"".join(p for _, _, p in out)
    c = asm.counters
    got = (payload, (c.count, c.ok, c.lowq, c.noalgn, c.badread, c.slow,
                     dict(c.overlaps)))
    if codes:
        got += ([code for _, cs, _ in out for code, _ in cs],)
    return got


def _count_device_steps(monkeypatch):
    """The list that counts the engine's device steps: single-device
    launches (_launch) and op-sharded steps (_dispatch_op)."""
    steps = []
    for name in ("_launch", "_dispatch_op"):
        real = getattr(BatchAssembler, name)

        def counting(self, *a, _real=real, _name=name, **kw):
            steps.append(_name)
            return _real(self, *a, **kw)

        monkeypatch.setattr(BatchAssembler, name, counting)
    return steps


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


@pytest.mark.parametrize("num_kmers", [1, 2, 3])
@pytest.mark.parametrize("name", ALGORITHMS)
def test_host_engine_equals_jax_host_engine(monkeypatch, name, num_kmers):
    """The host engine (PANDASEQ_TPU_ENGINE=host: the native
    psq_cand_mask twin computes every row's candidate mask) through the
    threaded pipeline at group 2 and depth 4: the payload, codes and
    counters of the JAX package's host engine, with no device step and
    no kernel launched."""
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "host")
    cfg = oracle.OracleConfig(num_kmers=num_kmers)
    cfg.algorithm = oracle.make_algorithm(name, None)
    jasm = JaxAssembler(_jax_cfg(cfg))
    want = _emit(jasm, group=2, depth=4, codes=True)
    assert jasm._resolve_host_only()
    steps = _count_device_steps(monkeypatch)
    cand.reset_launch_counts()
    asm = BatchAssembler(cfg, device="cpu")
    got = _emit(asm, group=2, depth=4, codes=True)
    assert asm.engine == "host"
    assert want[0] and got == want
    assert not steps
    assert cand.launch_counts() == dict.fromkeys(cand.KERNELS, 0)
    assert asm.engine_counters()["device_steps"] == 0


@pytest.mark.parametrize("num_kmers", [3, 4, 5, 6, 7, 8])
def test_k3_and_more_take_no_device_step(monkeypatch, num_kmers):
    """-k 3 to 8: the reference's misindexed k-mer occupancy check makes
    the native twin decide every row's candidate mask, so the device
    engine (grouped or not) and a (dp, op) mesh dispatch nothing and
    upload nothing, and give the bytes of the host engine and of the
    JAX package."""
    cfg = oracle.OracleConfig(num_kmers=num_kmers)
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "host")
    want = _emit(JaxAssembler(_jax_cfg(cfg)), group=2, codes=True)
    host = _emit(BatchAssembler(cfg, device="cpu"), group=2, codes=True)
    monkeypatch.delenv("PANDASEQ_TPU_ENGINE")
    steps = _count_device_steps(monkeypatch)
    cand.reset_launch_counts()
    for group, mesh in ((1, None), (2, None),
                        (1, shard.make_mesh(devices=["cpu"] * 4, op=2))):
        asm = BatchAssembler(cfg, device="cpu", mesh=mesh)
        assert asm.engine == "cpu"
        got = _emit(asm, group=group, codes=True)
        assert want[0] and got == host == want
        counts = asm.engine_counters()
        assert (counts["device_steps"], counts["fixup_rows_n"],
                counts["h2d_bytes"]) == (0, 0, 0)
    assert not steps
    assert cand.launch_counts() == dict.fromkeys(cand.KERNELS, 0)
