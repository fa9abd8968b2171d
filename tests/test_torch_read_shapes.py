"""The port's main path over the read shapes of users' runs, on the CPU:
the port's CLI (the plain versions of the kernels) against the JAX CLI
on small seeded streams from tests/golden/make_data.py, cut and pooled by
chip_smoke.py's own helpers (the streams of its phase 8, at a few
thousand pairs): stdout, the return code and the stderr line sequence
equal (tests/test_torch_cli.py norm_stderr), with zero tolerance.

- 2x300 V3-V4 (the shape bucket Lb = O = 384) and the same run with each
  R2 cut to 200-250 bp (O = 256 < Lb = 384), at -k 2 and -k 0;
- 2x100 with N runs and B-cliffs (Lb = O = 128), at -k 2 and -k 0;
- a pooled run whose segments cross the buckets 128 / 384 / 256 / 128;
- -O 200 (O = 256 < Lb from the flag) and -O 700 on 2x300 (O_full 640
  passes the CLI's plane width 512: every batch reroutes to the host
  twin).

Then the library: pandaseq_tpu_torch.Assembler(device="cpu") under
PANDASEQ_TPU_ENGINE=tpu on the pooled run against pandaseq_tpu.Assembler,
its device steps against the flush rule's prediction, and the engine's
-O 700 reroutes counted."""

import pytest

import pandaseq_tpu as jpt
import pandaseq_tpu_torch as tpt
from chip_smoke import (R2_CUT, R2_CUT_SEED, batch_buckets, cut_r2,
                        make_data, pool_streams, predict_steps, wait_data)
from pandaseq_tpu import oracle as jax_oracle
from pandaseq_tpu.assembler import BatchAssembler as JaxBatchAssembler
from pandaseq_tpu.io import native as jax_native
from pandaseq_tpu.io import output as jax_output
from pandaseq_tpu_torch import oracle
from pandaseq_tpu_torch.assembler import BatchAssembler
from pandaseq_tpu_torch.io import native, output
from pandaseq_tpu_torch.ops import cand
from tests.test_torch_cli import ENV, norm_stderr, run_modules

SEGMENT = 1280  # pairs of a pooled segment: 5 batches of POOL_BATCH
POOL_BATCH = 256  # the pooled run's batch, CLI (PANDASEQ_TPU_BATCH) and API
GROUP = 4  # Assembler.stream's default dispatch group
POOLED = [(128, 128)] * 5 + [(384, 384)] * 5 + [(256, 256)] * 5 \
    + [(128, 128)] * 5
# {case: (stream, extra CLI args, the shape buckets of its CLI batches)}
CASES = {
    "v3v4_2x300": ("v3v4", [], {(384, 384)}),
    "v3v4_2x300_k0": ("v3v4", ["-k", "0"], {(384, 384)}),
    "v3v4_r2cut": ("r2cut", [], {(384, 256)}),
    "v3v4_r2cut_k0": ("r2cut", ["-k", "0"], {(384, 256)}),
    "short_2x100": ("short", [], {(128, 128)}),
    "short_2x100_k0": ("short", ["-k", "0"], {(128, 128)}),
    "pooled": ("pooled", [], set(POOLED)),
    "olimit_O200": ("v3v4", ["-O", "200"], {(384, 384)}),
    "olimit_O700": ("v3v4", ["-O", "700"], {(384, 384)}),
}


def _make_data(prefix, *args):
    return wait_data(make_data(prefix, *args))


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    d = tmp_path_factory.mktemp("read_shapes")
    v3v4 = _make_data(str(d / "v3v4"), "--fast", "--pairs", "1500",
                      "--seed", "43", "--read-len", "300", "--amp-min",
                      "400", "--amp-max", "480")
    short = _make_data(str(d / "short"), "--pairs", str(2 * SEGMENT),
                       "--seed", "44", "--read-len", "100", "--amp-min",
                       "120", "--amp-max", "190", "--n-run-rate", "0.1")
    big = _make_data(str(d / "big"), "--fast", "--pairs", str(SEGMENT),
                     "--seed", "42")
    return {"v3v4": v3v4, "r2cut": cut_r2(v3v4, str(d / "r2cut")),
            "short": short,
            "pooled": pool_streams([(short, 0, SEGMENT), (v3v4, 0, SEGMENT),
                                    (big, 0, SEGMENT),
                                    (short, SEGMENT, SEGMENT)],
                                   str(d / "pooled"))}


def test_r2_cut_draws_each_length_from_the_seeded_range(streams):
    import numpy as np
    want = np.random.default_rng(R2_CUT_SEED).integers(
        R2_CUT[0], R2_CUT[1] + 1, size=1500).tolist()
    with open(streams["r2cut"][1]) as fh:
        lines = fh.read().splitlines()
    assert [len(s) for s in lines[1::4]] == want
    assert [len(q) for q in lines[3::4]] == want
    assert streams["r2cut"][0] == streams["v3v4"][0]


@pytest.mark.parametrize("case", list(CASES))
def test_read_shape_port_cli_equals_jax_cli(streams, case):
    name, extra, buckets = CASES[case]
    files = streams[name]
    env = ENV
    batch = 8192
    if name == "pooled":
        env = dict(ENV, PANDASEQ_TPU_BATCH=str(POOL_BATCH))
        batch = POOL_BATCH
    assert set(batch_buckets(files, batch)) == buckets
    if name == "pooled":
        assert batch_buckets(files, batch) == POOLED
    argv = ["-T", "1", "-f", files[0], "-r", files[1], *extra]
    want, got = run_modules([("pandaseq_tpu.cli.main", argv),
                             ("pandaseq_tpu_torch", argv)], env)
    assert want.returncode == 0 and want.stdout
    assert got.stdout == want.stdout
    assert got.returncode == want.returncode
    assert norm_stderr(got.stderr) == norm_stderr(want.stderr)
    assert b"INFO\tENGINE\tcpu" in got.stderr


def test_predict_steps_follows_the_flush_rule():
    assert predict_steps(POOLED, GROUP) == 8  # 4 + 1 per segment
    assert predict_steps([1, 1, 2, 1, 1, 1, 1, 1], 4) == 4
    assert predict_steps([1] * 8, 1) == 8
    assert predict_steps([], 4) == 0


@pytest.fixture
def _engine_tpu(monkeypatch):
    monkeypatch.setenv("PANDASEQ_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PANDASEQ_TPU_ENGINE", "tpu")
    for name in ("PANDASEQ_TPU_HOST", "PANDASEQ_TPU_GROUP",
                 "PANDASEQ_TPU_JOIN"):
        monkeypatch.delenv(name, raising=False)


def test_library_stream_pooled_equals_jax(streams, _engine_tpu):
    """Assembler.stream over the pooled run: the FASTA of the JAX
    package's Assembler, and one device step per group the flush rule
    makes (a group ends at GROUP batches and at each bucket change)."""
    files = streams["pooled"]
    want_steps = predict_steps(batch_buckets(files, POOL_BATCH), GROUP)
    got_asm = tpt.Assembler(device="cpu", batch=POOL_BATCH)
    want_asm = jpt.Assembler(batch=POOL_BATCH)
    cand.reset_launch_counts()
    got = b"".join(output.format_fasta(r) for r in got_asm.stream(*files))
    want = b"".join(jax_output.format_fasta(r)
                    for r in want_asm.stream(*files))
    assert want and got == want
    assert got_asm._engine.engine == "cpu"
    assert got_asm._engine.engine_info == {"reason": "env"}
    assert got_asm._engine._device_dispatches == want_steps == 8
    assert got_asm._engine._overflow_reroutes == 0
    assert cand.launch_counts() == dict.fromkeys(cand.KERNELS, 0)


def test_engine_counts_the_o700_reroutes(streams, _engine_tpu):
    """-O 700 on 2x300 through the engine: O_full 640 passes L = 512, so
    every batch reroutes to the host twin (no device step) and the
    results are the JAX engine's."""
    files = streams["v3v4"]

    def run(pkg_native, asm):
        batches = pkg_native.NativeBatchReader(*files, batch=POOL_BATCH,
                                               L=512)
        return [[(code, None if res is None else (
            str(res.sid), res.sequence_length, res.overlap))
            for code, res in out]
            for _, out in asm.assemble_stream(batches)]

    got_asm = BatchAssembler(oracle.OracleConfig(maxoverlap=700),
                             device="cpu")
    want_asm = JaxBatchAssembler(jax_oracle.OracleConfig(maxoverlap=700))
    got = run(native, got_asm)
    assert got == run(jax_native, want_asm)
    assert any(code == "OK" for res in got for code, _ in res)
    assert got_asm._overflow_reroutes == len(got) == 6
    assert got_asm._device_dispatches == 0
