"""The device-offload lane of the PyTorch port's host-engine pipeline
(tests/test_offload.py on pandaseq_tpu_torch, the plain step on the CPU
under PANDASEQ_TPU_OFFLOAD=force): offloaded groups give the pure host
path's bytes, a lane timeout and a lane job that raises each make the
run raise (no fallback hides the device), _OffloadView honours dtype,
and the lane is opt-in and needs a CUDA device unless forced."""

import os
import threading

import numpy as np
import pytest
import torch

from pandaseq_tpu_torch import oracle
from pandaseq_tpu_torch.assembler import (BatchAssembler, _DeviceOffload,
                                          _OffloadView)
from pandaseq_tpu_torch.io import native

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F1 = os.path.join(ROOT, "tests", "data", "synth_1.fastq")
F2 = os.path.join(ROOT, "tests", "data", "synth_2.fastq")


@pytest.fixture(autouse=True)
def _host_engine_on_cpu(monkeypatch):
    monkeypatch.setenv("PANDASEQ_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "host")
    monkeypatch.setenv("PANDASEQ_TPU_HYBRID", "0")


def _run(monkeypatch, offload_env, cfg=None, batch=32, group=2):
    monkeypatch.setenv("PANDASEQ_TPU_OFFLOAD", offload_env)
    asm = BatchAssembler(cfg or oracle.OracleConfig(), L=512)
    rdr = native.NativeBatchReader(F1, F2, batch=batch, L=512, ring=24)
    payload = b""
    codes = []
    for _, cs, pl in asm.emit_stream(rdr, fmt="fasta", depth=4,
                                     threaded=True, group=group):
        payload += pl
        codes.extend(cs)
    return payload, codes, asm


@pytest.mark.parametrize("nk", [1, 2])
def test_offload_output_identical(monkeypatch, nk):
    cfg = oracle.OracleConfig(num_kmers=nk)
    base, codes0, asm0 = _run(monkeypatch, "0", cfg)
    assert asm0._offload_count == 0
    got, codes1, asm1 = _run(monkeypatch, "force", cfg)
    assert asm1._offload_count > 0, "no group was offloaded"
    assert asm1._offload_groups > 0
    assert base and got == base
    assert codes1 == codes0
    assert asm1.counters == asm0.counters


def test_offload_equals_jax_package(monkeypatch):
    from pandaseq_tpu import oracle as jax_oracle
    from pandaseq_tpu.assembler import BatchAssembler as JaxAssembler
    from pandaseq_tpu.io import native as jax_native

    got, _, asm = _run(monkeypatch, "force")
    assert asm._offload_count > 0
    asm_j = JaxAssembler(jax_oracle.OracleConfig(), L=512)
    rdr = jax_native.NativeBatchReader(F1, F2, batch=32, L=512, ring=24)
    want = b"".join(p for _, _, p in asm_j.emit_stream(
        rdr, fmt="fasta", depth=4, threaded=True, group=2))
    assert asm_j._offload_count > 0
    assert want and got == want


def test_offload_timeout_counts_groups(monkeypatch):
    """With timeout() 0 and every lane job held until the run ends, the
    first offloaded group times out, and the run raises an error that
    names the group and the wait instead of recomputing on the host."""
    release = threading.Event()
    running = threading.Semaphore(0)  # one release per finished job
    started = []
    real = BatchAssembler._offload_list

    def held(self, *a):
        started.append(1)
        try:
            release.wait(60)
            return real(self, *a)
        finally:
            running.release()

    monkeypatch.setattr(BatchAssembler, "_offload_list", held)
    monkeypatch.setattr(_DeviceOffload, "timeout", lambda self: 0.0)
    try:
        with pytest.raises(TimeoutError,
                           match=r"group 0 .* within 0\.0 s"):
            _run(monkeypatch, "force")
    finally:
        release.set()
        # the late jobs finish on the lane threads before the test ends
        # (a lane thread still in a torch call at interpreter exit aborts)
        for _ in started:
            assert running.acquire(timeout=60)
    assert 1 <= len(started) <= _DeviceOffload.CAP  # the cap held


def test_lane_job_error_propagates(monkeypatch):
    def broken(self, *a):
        raise RuntimeError("cand_join kernel launch failed: injected")

    monkeypatch.setattr(BatchAssembler, "_offload_list", broken)
    with pytest.raises(RuntimeError, match="injected"):
        _run(monkeypatch, "force")


def test_offload_view_honours_dtype(monkeypatch):
    from concurrent.futures import Future
    monkeypatch.setenv("PANDASEQ_TPU_OFFLOAD", "force")
    off = _DeviceOffload(BatchAssembler(L=512))
    try:
        fut = Future()
        fut.set_result(np.arange(12, dtype=np.int16).reshape(4, 3))
        view = _OffloadView(off, fut, 0, 1, 3)
        got = np.asarray(view, dtype=np.int32)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, [[3, 4, 5], [6, 7, 8]])
        assert np.asarray(view).dtype == np.int16
    finally:
        off.shutdown()


def test_offload_is_opt_in(monkeypatch):
    monkeypatch.delenv("PANDASEQ_TPU_OFFLOAD", raising=False)
    assert not BatchAssembler(L=512)._offload_enabled()
    monkeypatch.setenv("PANDASEQ_TPU_OFFLOAD", "0")
    assert not BatchAssembler(L=512)._offload_enabled()


def test_offload_needs_cuda_unless_forced(monkeypatch):
    """OFFLOAD=1 passes the gate on a CUDA device only; force skips that
    test, so the CPU runs the plain step in the lane."""
    monkeypatch.setenv("PANDASEQ_TPU_OFFLOAD", "1")
    assert not BatchAssembler(L=512)._offload_enabled()
    monkeypatch.setenv("PANDASEQ_TPU_OFFLOAD", "force")
    assert BatchAssembler(L=512)._offload_enabled()
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "tpu")  # the device engine
    assert not BatchAssembler(L=512)._offload_enabled()


def test_offload_requires_seeded_kmers(monkeypatch):
    monkeypatch.setenv("PANDASEQ_TPU_OFFLOAD", "force")
    for nk in (0, 3):
        cfg = oracle.OracleConfig(num_kmers=nk)
        assert not BatchAssembler(cfg, L=512)._offload_enabled()
