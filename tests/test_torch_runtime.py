"""The PyTorch port's engine probe (pandaseq_tpu_torch/runtime.py
pick_engine) and engine resolution, on the CPU: the shortcuts, the env
pins in the JAX package's order, the unpinned default (the device engine
on a card with no probe, the native twin on a CPU device), the probe
only under PANDASEQ_TPU_ENGINE=auto, a cache hit, a fresh probe written
to the port's own cache file, a device error and the flock timeout, each
raising rather than picking an engine quietly. The measurement itself
(_measure) needs the card; here it is replaced where a test reaches it,
and an engine "on the card" is one whose device resolves to CARD, which
only resolves its engine and launches nothing."""

import fcntl
import json
import os

import pytest
import torch

from pandaseq_tpu_torch.io import native
from pandaseq_tpu_torch import runtime
from pandaseq_tpu_torch.assembler import BatchAssembler
from pandaseq_tpu_torch.oracle import OracleConfig

CARD = torch.device("cuda", 0)  # a device object only: nothing launches
KEY = "H100:host:8:L256:O256:k2"


@pytest.fixture
def cache(monkeypatch, tmp_path):
    """An empty cache directory, a fixed probe key, no env pins, and a
    measurement that fails the test if it is reached."""
    monkeypatch.setenv("PANDASEQ_TPU_CACHE", str(tmp_path))
    for var in ("PANDASEQ_TPU_ENGINE", "PANDASEQ_TPU_HOST"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(runtime, "_probe_key", lambda *a: KEY)

    def unreachable(*a):
        raise AssertionError("the probe measured")

    monkeypatch.setattr(runtime, "_measure", unreachable)
    return tmp_path / runtime.PROBE_CACHE


def test_shortcuts(cache, monkeypatch):
    assert runtime.pick_engine("cpu") == ("host", {"reason": "cpu-device"})
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert runtime.pick_engine(CARD) == ("device", {"reason": "no-native"})
    assert not cache.exists()


@pytest.mark.parametrize("env,value,engine,reason", [
    ("PANDASEQ_TPU_ENGINE", "host", "host", "env"),
    ("PANDASEQ_TPU_ENGINE", "tpu", "cpu", "env"),
    ("PANDASEQ_TPU_HOST", "1", "host", "env-legacy"),
    ("PANDASEQ_TPU_HOST", "0", "cpu", "env-legacy"),
    ("PANDASEQ_TPU_ENGINE", "auto", "host", "cpu-device"),
    (None, None, "host", "cpu-device")])
def test_engine_resolution_order(cache, monkeypatch, env, value, engine,
                                 reason):
    """PANDASEQ_TPU_ENGINE, then legacy PANDASEQ_TPU_HOST, then the
    probe under ``auto`` (whose shortcut picks the native twin for a CPU
    device), then the device type: a CPU device's is the native twin."""
    if env:
        monkeypatch.setenv(env, value)
    asm = BatchAssembler(device="cpu")
    assert asm.engine == engine
    assert asm.engine_info == {"reason": reason}
    # the constructor beats every pin
    assert BatchAssembler(device="cpu", host_only=False).engine == "cpu"


def _on_card(monkeypatch, **kw):
    monkeypatch.setattr(runtime, "resolve_device", lambda device=None: CARD)
    return BatchAssembler(**kw)


def test_unpinned_card_serves_the_device(cache, monkeypatch):
    """No pin: a card serves the device engine (reason ``default``) and a
    CPU device the native twin, and neither asks the probe."""
    def no_probe(*a, **kw):
        raise AssertionError("pick_engine was called")

    monkeypatch.setattr(runtime, "pick_engine", no_probe)
    cpu = BatchAssembler(device="cpu")
    assert cpu.engine == "host" and cpu.engine_info == {"reason": "cpu-device"}
    asm = _on_card(monkeypatch)
    assert asm.device == CARD
    assert asm.engine == "cuda" and asm.engine_info == {"reason": "default"}
    assert runtime.describe(asm.engine_info) == "default"
    assert not asm._resolve_host_only()
    for k in (0, 3):  # every path: the dense one's too
        asm = _on_card(monkeypatch, cfg=OracleConfig(num_kmers=k))
        assert asm.engine == "cuda" and asm._sparse_mode()[0] == (k > 0)
    assert not cache.exists()


@pytest.mark.parametrize("verdict", ["host", "device"])
def test_auto_asks_the_probe(cache, monkeypatch, verdict):
    """PANDASEQ_TPU_ENGINE=auto asks runtime.pick_engine, once, with the
    engine's device and k, and serves its verdict with its info."""
    calls = []
    info = {"engine": verdict, "host_ms": 1.0, "device_ms": 2.0,
            "B": 4096, "reason": "probe"}

    def pick(device, **kw):
        calls.append((device, kw))
        return verdict, dict(info)

    monkeypatch.setattr(runtime, "pick_engine", pick)
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "auto")
    asm = _on_card(monkeypatch, cfg=OracleConfig(num_kmers=3))
    assert asm.engine == ("host" if verdict == "host" else "cuda")
    assert asm.engine_info == info
    assert asm.engine == asm.engine  # resolved once
    assert calls == [(CARD, {"num_kmers": 2})]


def test_env_pin_beats_legacy(cache, monkeypatch):
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "tpu")
    monkeypatch.setenv("PANDASEQ_TPU_HOST", "1")
    assert BatchAssembler(device="cpu").engine == "cpu"


def test_cache_hit(cache):
    entry = {"engine": "host", "host_ms": 2.5, "device_ms": 3.25,
             "B": 4096, "reason": "probe"}
    cache.write_text(json.dumps({KEY: entry}))
    eng, info = runtime.pick_engine(CARD)
    assert eng == "host" and info == dict(entry, cached=True)
    assert runtime.describe(info) == \
        "probe, cached: host 2.500 ms, device 3.250 ms"


def test_probe_writes_the_ports_cache(cache, monkeypatch):
    calls = []

    def measure(device, L, O, k, B):
        calls.append((device, L, O, k, B))
        return 0.004, 0.001

    monkeypatch.setattr(runtime, "_measure", measure)
    eng, info = runtime.pick_engine(CARD)
    assert eng == "device" and info["reason"] == "probe"
    assert info["host_ms"] == pytest.approx(4.0)
    assert runtime.describe(info) == "probe: host 4.000 ms, device 1.000 ms"
    assert calls == [(CARD, 256, 256, 2, 4096)]
    assert json.loads(cache.read_text())[KEY]["engine"] == "device"
    assert os.path.basename(cache) != "engine_probe.json"
    # the second call reads the verdict; refresh measures again
    assert runtime.pick_engine(CARD)[1]["cached"]
    runtime.pick_engine(CARD, refresh=True)
    assert len(calls) == 2


def test_device_error_raises(cache, monkeypatch):
    def measure(*a):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(runtime, "_measure", measure)
    with pytest.raises(RuntimeError, match="illegal memory"):
        runtime.pick_engine(CARD)
    assert not cache.exists()


def test_lock_timeout_raises(cache):
    """Another process holds the probe's flock: the wait is bounded."""
    with open(str(cache) + ".lock", "a+") as held:
        fcntl.flock(held, fcntl.LOCK_EX)
        with pytest.raises(TimeoutError, match="engine-probe lock"):
            runtime.pick_engine(CARD, lock_timeout=0.2)
