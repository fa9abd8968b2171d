"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of a checkout. CPU tests run anywhere; the tests marked ``cuda``
run on a machine with a card and skip elsewhere (decided in the
``card`` fixture, not at import)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for path in (HERE, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where "
        "torch.cuda.is_available() is False)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")


@pytest.fixture
def cpu_port(monkeypatch, tmp_path_factory):
    """The port on the CPU (its native host twin), building into a
    directory of this pytest run."""
    build = tmp_path_factory.getbasetemp() / "build"
    monkeypatch.setenv("PANDASEQ_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PANDASEQ_TPU_CACHE", str(build))
    return "host (cpu-device)"
