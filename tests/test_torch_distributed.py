"""The PyTorch port's multi-process runner (pandaseq_tpu_torch/parallel/
distributed.py) on the CPU: the counter reduction, the input sharding and
resume it shares with the JAX package, and a real two-process run —
two OS processes joined by torch.distributed over gloo on localhost,
claiming the batches of one shared stream round-robin (the PandaMux
analogue) — against the single-process run and the JAX package's
``run_distributed``. Bytes and counters are compared exactly."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from pandaseq_tpu_torch.assembler import Counters
from pandaseq_tpu_torch.parallel import distributed as D

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F1 = os.path.join(ROOT, "tests", "data", "synth_1.fastq")
F2 = os.path.join(ROOT, "tests", "data", "synth_2.fastq")

_WORKER = r"""
import json, sys
sys.modules["jax"] = None  # the port runs without JAX
sys.path.insert(0, %(root)r)
import torch
torch.set_num_threads(1)
from pandaseq_tpu_torch.parallel import distributed as D
rank, world = D.maybe_initialize_distributed()
vec, hist = D.run_distributed([(%(f1)r, %(f2)r)], out_dir=sys.argv[1],
                              batch=32)
print("RESULT " + json.dumps({"rank": rank, "world": world,
                              "vec": [int(x) for x in vec],
                              "hist": sorted(hist.items())}))
torch.distributed.destroy_process_group()
"""


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("PANDASEQ_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PANDASEQ_TPU_HOST", "0")
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "PANDASEQ_TPU_ENGINE"):
        monkeypatch.delenv(name, raising=False)


def test_reduce_counters_without_group_is_identity():
    class Module:
        rejected = 5

    c = Counters(count=101, ok=90, noalgn=3, lowq=2, badread=1, slow=4,
                 nofp=0, norp=1)
    hist = {151: 40, 200: 50, 0: 7}
    mods = [Module(), Module()]
    vec, hout = D.reduce_counters(c, hist, mods)
    assert list(vec) == [101, 90, 3, 2, 1, 4, 0, 1]
    assert hout == hist
    assert [m.rejected for m in mods] == [5, 5]
    with pytest.raises(AssertionError, match="histogram bin"):
        D.reduce_counters(c, {1024: 1})


def test_shard_inputs():
    inputs = [(f"f{i}", f"r{i}") for i in range(10)]
    parts = [D.shard_inputs(inputs, i, 3) for i in range(3)]
    assert sorted(sum(parts, [])) == sorted(inputs)
    assert [len(p) for p in parts] == [4, 3, 3]


def test_run_distributed_resume(tmp_path):
    ck = str(tmp_path / "ck.jsonl")
    vec, _ = D.run_distributed([(F1, F2)], out_dir=str(tmp_path), batch=64,
                               checkpoint=ck)
    first = (tmp_path / "part-00000.fasta").read_bytes()
    assert first and vec[0] == 200
    # resume at once: every batch is done, nothing is appended
    vec, _ = D.run_distributed([(F1, F2)], out_dir=str(tmp_path), batch=64,
                               checkpoint=ck)
    assert (tmp_path / "part-00000.fasta").read_bytes() == first
    assert vec[0] == 0


def test_failing_group_init_raises(monkeypatch):
    """A rank that cannot join raises instead of running alone."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")  # MASTER_PORT is missing
    with pytest.raises(ValueError, match="MASTER_PORT"):
        D.maybe_initialize_distributed()
    assert not torch.distributed.is_initialized()


def test_two_process_mux_equals_single_and_jax(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    script = tmp_path / "worker.py"
    script.write_text(_WORKER % dict(root=ROOT, f1=F1, f2=F2))
    out_dir = tmp_path / "out"
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   WORLD_SIZE="2", RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(out_dir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=ROOT))
    try:
        outs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]
    results = [json.loads(o.rsplit("RESULT ", 1)[1].splitlines()[0])
               for o in outs]
    assert [(r["rank"], r["world"]) for r in results] == [(0, 2), (1, 2)]
    # every rank reports the same reduced, global vector
    assert results[0]["vec"] == results[1]["vec"]
    assert results[0]["hist"] == results[1]["hist"]
    parts = [(out_dir / ("part-%05d.fasta" % i)).read_bytes()
             for i in range(2)]
    assert all(parts), [len(p) for p in parts]

    single_dir = tmp_path / "single"
    vec1, hist1 = D.run_distributed([(F1, F2)], out_dir=str(single_dir),
                                    batch=32)
    assert list(vec1) == results[0]["vec"][:8] and vec1[0] == 200
    assert sorted(hist1.items()) == [tuple(h) for h in results[0]["hist"]]
    single = (single_dir / "part-00000.fasta").read_bytes()
    recs = [r for p in parts for r in p.split(b">")[1:]]
    assert sorted(recs) == sorted(single.split(b">")[1:])

    from pandaseq_tpu.parallel import distributed as jax_distributed
    jax_dir = tmp_path / "jax"
    vec_j, hist_j = jax_distributed.run_distributed(
        [(F1, F2)], out_dir=str(jax_dir), batch=32)
    assert [int(x) for x in vec_j] == results[0]["vec"][:8]
    assert hist_j == hist1
    assert (jax_dir / "part-00000.fasta").read_bytes() == single
    np.testing.assert_array_equal(np.asarray(vec_j, np.int64), vec1)
