"""The PyTorch port's scaling run (``python -m pandaseq_tpu_torch.scale_run
--procs 2 --device cpu``) on 2,000 generated pairs in 256-pair batches:
the union of the two processes' part files equals the one-process run's
(multiset digest) and the reduced counter vectors are equal, in the
striped and the mux layout; and the union equals the part file of the
JAX package's one-process ``run_distributed`` on the same shard
inputs."""

import json
import subprocess
import sys

import pytest

from pandaseq_tpu_torch import scale_run
from tests.test_torch_cli import ENV, ROOT


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scale")
    env = dict(ENV, PANDASEQ_TPU_ENGINE="tpu")
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(name, None)
    out = tmp / "scale.json"
    stripes = scale_run.ensure_data(2000, 2, str(tmp / "data"))
    got = subprocess.run(
        [sys.executable, "-m", "pandaseq_tpu_torch.scale_run", "--procs",
         "2", "--device", "cpu", "--batch", "256",
         *[a for pair in stripes for a in ("--input", *pair)],
         "--workdir", str(tmp / "work"), "--out", str(out)],
        capture_output=True, env=env, cwd=ROOT, timeout=120)
    assert got.returncode == 0, got.stdout.decode()[-3000:]
    record = json.loads(got.stdout.decode().strip().splitlines()[-1])
    assert json.loads(out.read_text()) == record
    return tmp, record


@pytest.mark.parametrize("mode", ["striped", "mux_shared_stream"])
def test_two_processes_equal_one(run, mode):
    _, record = run
    m = record[mode]
    assert m["output_identical"] and m["global_stat_identical"]
    assert m["multiset_sha256_single"] == m["multiset_sha256_multi"]
    assert m["output_records_single"] == m["output_records_multi"] > 0
    assert sum(m["multi_per_proc_pairs"]) == m["pairs"] == \
        m["counters_vec"][0]
    assert all(n > 0 for n in m["multi_per_proc_pairs"])
    assert m["scaling_efficiency"] > 0


def test_union_equals_jax_run_distributed(run, monkeypatch):
    from pandaseq_tpu.parallel import distributed as jax_distributed
    tmp, record = run
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    inputs = [tuple(p) for p in record["inputs"]]
    vec, _ = jax_distributed.run_distributed(inputs, out_dir=str(tmp / "jax"),
                                             batch=256)
    assert [int(x) for x in vec] == record["striped"]["counters_vec"]
    parts = sorted(str(p) for p in (tmp / "work" / "striped_2").iterdir()
                   if p.name.startswith("part-"))
    assert len(parts) == 2
    assert scale_run.multiset_sha(parts) == scale_run.multiset_sha(
        [str(tmp / "jax" / "part-00000.fasta")])


def test_scale_run_refuses_one_process():
    with pytest.raises(SystemExit):
        scale_run.main(["--procs", "1", "--device", "cpu"])
