"""The PyTorch port stands without JAX and hides no CPU path: it runs
with ``jax`` unimportable, and a request for the card where there is
none raises instead of running on the CPU."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from tests.test_torch_cli import BASE, ENV, ROOT, run_module

torch.set_num_threads(1)

_NO_JAX = ("import sys; sys.modules['jax'] = None; "
           "sys.modules['jaxlib'] = None; "
           "from pandaseq_tpu_torch.cli.main import main; "
           "sys.exit(main(sys.argv[1:]))")


def test_port_cli_runs_without_jax():
    got = subprocess.run([sys.executable, "-c", _NO_JAX, *BASE],
                         capture_output=True, env=ENV, cwd=ROOT,
                         timeout=300)
    assert got.returncode == 0, got.stderr.decode()[-2000:]
    # the same bytes as the port CLI with JAX importable, which
    # tests/test_torch_cli.py holds to pandaseq_tpu's CLI
    want = run_module("pandaseq_tpu_torch", BASE)
    assert want.stdout and got.stdout == want.stdout


_NO_JAX_MESH = (
    "import sys; sys.modules['jax'] = None; sys.modules['jaxlib'] = None\n"
    "import numpy as np, torch\n"
    "from pandaseq_tpu_torch.parallel import distributed, shard\n"
    "from pandaseq_tpu_torch.ops import cand, dense, fused2\n"
    "mesh = shard.make_mesh(devices=['cpu'] * 4, op=2)\n"
    "nt = np.full((4, 64), 0x22, np.int8)\n"
    "lens = np.full(4, 60, np.int32)\n"
    "got = shard.make_sharded_cand_step(mesh, L=64)(nt, lens, lens)\n"
    "want = fused2.assemble_candidates_nt(*map(torch.from_numpy,\n"
    "                                          (nt, lens, lens)), L=64)\n"
    "assert torch.equal(got, want) and got.any()\n"
    "assert 'jax' not in [m.split('.')[0] for m, v in sys.modules.items()\n"
    "                     if v is not None]\n"
    "print('ok')\n")


def test_parallel_modules_run_without_jax():
    """The mesh, the sharded steps and the multi-process runner import and
    run with ``jax`` unimportable."""
    got = subprocess.run([sys.executable, "-c", _NO_JAX_MESH],
                         capture_output=True, env=ENV, cwd=ROOT,
                         timeout=300)
    assert got.returncode == 0, got.stderr.decode()[-2000:]
    assert got.stdout.strip() == b"ok"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")


def test_cuda_request_raises_without_card(no_card, monkeypatch):
    from pandaseq_tpu_torch import runtime
    from pandaseq_tpu_torch.assembler import BatchAssembler
    from pandaseq_tpu_torch.ops import cand, dense

    with pytest.raises(RuntimeError, match="cuda"):
        BatchAssembler(device="cuda")
    monkeypatch.delenv("PANDASEQ_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        runtime.resolve_device()  # the default device is cuda
    # the kernel wrappers take no CPU tensor
    plane = torch.zeros((2, 64), dtype=torch.int8)
    lens = torch.full((2,), 100, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cand.kmer_frames(plane, lens, lens, 128, 2)
    frames = torch.zeros((2, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cand.candidates(frames, frames, 128, "list", 4)
    nt = torch.zeros((2, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        dense.kmer_frames_nt(nt, lens, lens, 128, 0)
    with pytest.raises(ValueError, match="CUDA"):
        dense.counts(nt, frames, frames, 128)
    with pytest.raises(ValueError, match="CUDA"):
        dense.shortlist(frames, frames, frames, lens, lens, lens, lens,
                        O=128, SL=8, minoverlap=2, maxoverlap=0,
                        algo_kind="counts", pmatch=0.0, pmismatch=0.0,
                        nn=0.0, band=0.01)
    assert cand.launch_counts() == dict.fromkeys(cand.KERNELS, 0)

    env = dict(ENV, PANDASEQ_TORCH_DEVICE="cuda")
    got = run_module("pandaseq_tpu_torch", BASE, env=env)
    assert got.returncode != 0 and got.stdout == b""
    assert b"ERR\tDEVICE" in got.stderr


def test_chip_smoke_fails_without_card(no_card, tmp_path):
    env = dict(os.environ, PYTHONPATH="")
    runs = [subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                           capture_output=True, env=env, timeout=120)]
    # alone in a directory, without the program, it fails too
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    runs.append(subprocess.run([sys.executable, "chip_smoke.py"],
                               cwd=tmp_path, capture_output=True, env=env,
                               timeout=120))
    for p in runs:
        assert p.returncode != 0
        assert p.stdout == b""
