"""The hybrid host steal on the PyTorch port's engine (tests/test_hybrid_
steal.py on pandaseq_tpu_torch, the plain step on the CPU): a group
whose candidate masks the exact native twin computes instead of the
device step gives the same payload bytes, codes and counters; -k 0 never
steals; the adaptive default is exact; and the forced run's payload
equals the JAX package's for the same config."""

import os

import pytest
import torch

from pandaseq_tpu_torch import oracle
from pandaseq_tpu_torch.assembler import BatchAssembler
from pandaseq_tpu_torch.io import native
from pandaseq_tpu_torch.ops import cand

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
F1 = os.path.join(DATA, "synth_1.fastq")
F2 = os.path.join(DATA, "synth_2.fastq")
CASES = [("simple_bayesian", 2), ("pear", 2), ("simple_bayesian", 1),
         ("rdp_mle", 3)]


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("PANDASEQ_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "tpu")  # the device engine


def _run(monkeypatch, hybrid, cfg=None, batch=384, group=2):
    monkeypatch.setenv("PANDASEQ_TPU_HYBRID", hybrid)
    asm = BatchAssembler(cfg or oracle.OracleConfig(), L=512)
    reader = native.NativeBatchReader(F1, F2, policy="PRESENT", batch=batch,
                                      L=512)
    payload = bytearray()
    codes = []
    for _, cs, pay in asm.emit_stream(reader, fmt="fasta", depth=4,
                                      group=group, threaded=True):
        payload += pay
        codes.extend(cs)
    return bytes(payload), codes, asm.counters, asm._host_steals


def _cfg(algo, nk):
    return oracle.OracleConfig(algorithm=oracle.make_algorithm(algo),
                               num_kmers=nk)


@pytest.mark.parametrize("algo,nk", CASES)
def test_forced_steal_matches_device(monkeypatch, algo, nk):
    pd, cd, ctd, sd = _run(monkeypatch, "0", _cfg(algo, nk))
    ph, ch, cth, sh = _run(monkeypatch, "force", _cfg(algo, nk))
    assert sd == 0 and sh > 0  # the steal happened
    assert pd and pd == ph
    assert cd == ch
    assert (ctd.count, ctd.ok, ctd.lowq, ctd.noalgn, ctd.slow,
            ctd.overlaps) == (cth.count, cth.ok, cth.lowq, cth.noalgn,
                              cth.slow, cth.overlaps)


def test_forced_steal_launches_nothing(monkeypatch):
    """A stolen group runs no device step: with every group stolen, the
    plain step is never called."""
    calls = []
    real = BatchAssembler._launch

    def counting(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)

    monkeypatch.setattr(BatchAssembler, "_launch", counting)
    _, _, _, steals = _run(monkeypatch, "force", batch=64, group=1)
    assert steals == 4 and not calls
    _run(monkeypatch, "0", batch=64, group=1)
    assert len(calls) == 4
    assert cand.launch_counts() == dict.fromkeys(cand.KERNELS, 0)


def test_k0_never_steals(monkeypatch):
    # -k 0 stays on the device shortlist (the host dense scan is the
    # reference's own SLOW path) even when forced
    cfg = oracle.OracleConfig(num_kmers=0)
    p0, c0, _, s0 = _run(monkeypatch, "0", cfg)
    pf, cf, _, sf = _run(monkeypatch, "force", cfg)
    assert s0 == sf == 0
    assert p0 and p0 == pf and c0 == cf


def test_steal_never_applies_to_host_engine_or_mesh(monkeypatch):
    from pandaseq_tpu_torch.parallel import shard
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "host")
    p_host, _, _, s_host = _run(monkeypatch, "force")
    assert s_host == 0
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "tpu")
    p_dev, _, _, _ = _run(monkeypatch, "0")
    assert p_host == p_dev
    monkeypatch.delenv("PANDASEQ_TPU_ENGINE")
    asm = BatchAssembler(mesh=shard.make_mesh(devices=["cpu"] * 2))
    st = asm._pre(next(native.NativeBatchReader(F1, F2, batch=64, L=512)))
    assert not asm._host_route_ok([st])


def test_adaptive_default_stays_exact(monkeypatch):
    # the default (PANDASEQ_TPU_HYBRID unset) is adaptive: steals may or
    # may not fire on this host; the output is identical either way
    pd, cd, ctd, _ = _run(monkeypatch, "0")
    monkeypatch.delenv("PANDASEQ_TPU_HYBRID")
    asm = BatchAssembler(oracle.OracleConfig(), L=512)
    reader = native.NativeBatchReader(F1, F2, policy="PRESENT", batch=384,
                                      L=512)
    out = list(asm.emit_stream(reader, fmt="fasta", depth=4, group=2,
                               threaded=True))
    assert b"".join(p for _, _, p in out) == pd
    assert [c for _, cs, _ in out for c in cs] == cd
    assert asm.counters.ok == ctd.ok


@pytest.mark.parametrize("algo,nk", CASES[:2])
def test_forced_steal_equals_jax_package(monkeypatch, algo, nk):
    from pandaseq_tpu import oracle as jax_oracle
    from pandaseq_tpu.assembler import BatchAssembler as JaxAssembler
    from pandaseq_tpu.io import native as jax_native

    got, _, counters, steals = _run(monkeypatch, "force", _cfg(algo, nk))
    assert steals > 0
    monkeypatch.delenv("PANDASEQ_TPU_ENGINE")
    jax_cfg = jax_oracle.OracleConfig(
        algorithm=jax_oracle.make_algorithm(algo), num_kmers=nk)
    asm = JaxAssembler(jax_cfg, L=512)
    reader = jax_native.NativeBatchReader(F1, F2, policy="PRESENT",
                                          batch=384, L=512)
    want = b"".join(p for _, _, p in asm.emit_stream(
        reader, fmt="fasta", depth=4, group=2, threaded=True))
    assert asm._host_steals > 0
    assert want and got == want
    assert (counters.ok, counters.overlaps) == (asm.counters.ok,
                                               asm.counters.overlaps)
