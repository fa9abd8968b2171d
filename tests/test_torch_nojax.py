"""The PyTorch port stands alone and hides no CPU path: no module of
``pandaseq_tpu_torch`` (nor ``chip_smoke.py``) imports ``jax`` or
``pandaseq_tpu``; the CLI, a mesh step and ``run_distributed`` run
byte-equal with both names unimportable; and a request for the card
where there is none raises instead of running on the CPU."""

import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest
import torch

from tests.test_torch_cli import BASE, ENV, ROOT, norm_stderr, run_module

torch.set_num_threads(1)

# makes jax and the JAX package unimportable in the process it starts
_BLOCK = ("import sys\n"
          "for _m in ('jax', 'jaxlib', 'pandaseq_tpu'):\n"
          "    sys.modules[_m] = None\n")
_FORBIDDEN = ("jax", "jaxlib", "pandaseq_tpu")
_NO_JAX = (_BLOCK + "from pandaseq_tpu_torch.cli.main import main\n"
           "sys.exit(main(sys.argv[1:]))\n")


def _port_sources():
    files = sorted(glob.glob(os.path.join(ROOT, "pandaseq_tpu_torch", "**",
                                          "*.py"), recursive=True))
    return files + [os.path.join(ROOT, "chip_smoke.py")]


def _imported(path):
    """(top-level module, line) of every absolute import in the file,
    at any depth (inside functions too)."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module.split(".")[0], node.lineno


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_sources()
    assert len(files) >= 30
    bad = ["%s:%d imports %s" % (os.path.relpath(f, ROOT), line, mod)
           for f in files for mod, line in _imported(f)
           if mod in _FORBIDDEN]
    assert not bad, bad


def test_import_scan_sees_a_forbidden_import(tmp_path):
    """The scan finds an import of the JAX package at any depth."""
    path = tmp_path / "m.py"
    path.write_text("def f():\n    from pandaseq_tpu.io import native\n"
                    "import pandaseq_tpu_torch\nfrom . import x\n")
    assert [m for m, _ in _imported(str(path))] == [
        "pandaseq_tpu_torch", "pandaseq_tpu"]


@pytest.mark.parametrize("extra", [[], ["-k", "0"]])
def test_port_cli_runs_without_jax(extra):
    got = subprocess.run([sys.executable, "-c", _NO_JAX, *BASE, *extra],
                         capture_output=True, env=ENV, cwd=ROOT,
                         timeout=300)
    assert got.returncode == 0, got.stderr.decode()[-2000:]
    # the same bytes as the port CLI with both importable, which
    # tests/test_torch_cli.py holds to pandaseq_tpu's CLI
    want = run_module("pandaseq_tpu_torch", BASE + extra)
    assert want.stdout and got.stdout == want.stdout
    assert norm_stderr(got.stderr) == norm_stderr(want.stderr)


_NO_JAX_MESH = (
    _BLOCK +
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
    "loaded = {m.split('.')[0] for m, v in sys.modules.items() if v}\n"
    "assert not loaded & {'jax', 'pandaseq_tpu'}, loaded\n"
    "print('ok')\n")


def test_parallel_modules_run_without_jax():
    """The mesh, the sharded steps and the multi-process runner import and
    run with ``jax`` and ``pandaseq_tpu`` unimportable."""
    got = subprocess.run([sys.executable, "-c", _NO_JAX_MESH],
                         capture_output=True, env=ENV, cwd=ROOT,
                         timeout=300)
    assert got.returncode == 0, got.stderr.decode()[-2000:]
    assert got.stdout.strip() == b"ok"


# a (dp=2, op=2) CPU mesh through the engine, and a one-process
# run_distributed; each prints a digest of what it wrote
_MESH_RUN = (
    "import hashlib, os, sys, torch\n"
    "torch.set_num_threads(1)\n"
    "from pandaseq_tpu_torch.assembler import BatchAssembler\n"
    "from pandaseq_tpu_torch.io import native\n"
    "from pandaseq_tpu_torch.parallel import shard\n"
    "mesh = shard.make_mesh(devices=['cpu'] * 4, dp=2, op=2)\n"
    "asm = BatchAssembler(mesh=mesh)\n"
    "rdr = native.NativeBatchReader(sys.argv[1] + '_1.fastq',\n"
    "                               sys.argv[1] + '_2.fastq', batch=64,\n"
    "                               L=512)\n"
    "out = b''.join(p for _, _, p in asm.emit_stream(rdr, depth=2))\n"
    "c = asm.counters\n"
    "print(hashlib.sha256(out).hexdigest(), len(out), c.count, c.ok,\n"
    "      sorted(c.overlaps.items()), len(asm._op_steps))\n")
_DIST_RUN = (
    "import hashlib, os, sys, torch\n"
    "torch.set_num_threads(1)\n"
    "from pandaseq_tpu_torch.parallel import distributed as D\n"
    "vec, hist = D.run_distributed([(sys.argv[1] + '_1.fastq',\n"
    "                                sys.argv[1] + '_2.fastq')],\n"
    "                              out_dir=sys.argv[2], batch=64)\n"
    "data = open(os.path.join(sys.argv[2], 'part-00000.fasta'),\n"
    "            'rb').read()\n"
    "print(hashlib.sha256(data).hexdigest(), len(data),\n"
    "      [int(x) for x in vec], sorted(hist.items()))\n")


@pytest.mark.parametrize("script", ["mesh", "run_distributed"])
def test_mesh_and_run_distributed_without_jax(tmp_path, script):
    """The (2, 2) CPU mesh step through the engine and a one-process
    run_distributed print the same digest of their bytes and counters
    with jax and pandaseq_tpu unimportable as with both importable."""
    code = _MESH_RUN if script == "mesh" else _DIST_RUN
    env = dict(ENV)
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "PANDASEQ_TPU_ENGINE"):
        env.pop(name, None)
    outs = []
    for i, prefix in enumerate(("", _BLOCK)):
        got = subprocess.run(
            [sys.executable, "-c", prefix + code,
             os.path.join(ROOT, "tests", "data", "synth"),
             str(tmp_path / str(i))],
            capture_output=True, env=env, cwd=ROOT, timeout=300)
        assert got.returncode == 0, got.stderr.decode()[-2000:]
        outs.append(got.stdout)
    assert outs[0] and outs[0] == outs[1]
    assert b" 200 " in outs[0] or b"[200, " in outs[0]  # 200 pairs


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
        cand.candidates_join(plane, lens, lens, 128, 128, 2, "list", 4)
    nt = torch.zeros((2, 128), dtype=torch.int8)
    for k in (0, 2):
        with pytest.raises(ValueError, match="CUDA"):
            dense.counts(nt, lens, lens, 128, 128, k)
    frames = torch.zeros((2, 128), dtype=torch.int32)
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
