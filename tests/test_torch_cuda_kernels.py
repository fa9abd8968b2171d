"""The port's CUDA kernels on the card: equal to their plain PyTorch
versions and to native.cand_mask (the exact host twin): the sort-join
``cand_join`` on the packed and the nibble plane, at num_kmers 0-3, in
list and mask form, and the other kernels (``counts`` with its k-mer hits
from the same join, ``shortlist`` also on the edge rows of
tests/shortlist_rows.py, the LUT sums of pear / rdp_mle bit for bit also
on the edge rows of tests/lut_rows.py), over the full plane and over the
row blocks of the op-sharded steps, the mesh's steps with one sort-join
per dp row, and the engine on the card equal to the engine
on the CPU, on the sparse path and the dense -k 0 path, on one device
and on a (dp=2, op=2) mesh of one card; on a machine with several cards,
also on a named card other than the current device and on meshes across
the cards. Every test is marked ``cuda``
and skips where ``torch.cuda.is_available()`` is False; on a machine
with the card (which has no JAX, hence no conftest) run

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pandaseq_tpu_torch import oracle
from pandaseq_tpu_torch.assembler import BatchAssembler
from pandaseq_tpu_torch.io import native
from pandaseq_tpu_torch.ops import cand, dense, fused2
from tests.shortlist_rows import ZERO_TIE_ROW, edge_rows

pytestmark = pytest.mark.cuda

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
C = fused2.CAND_LIST_C


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the machine with the card has no JAX, so this file also runs under
    # --noconftest: make the gitignored synth data here if it is missing
    if not os.path.exists(os.path.join(DATA, "synth_1.fastq")):
        subprocess.run([sys.executable,
                        os.path.join(os.path.dirname(DATA), "golden",
                                     "make_data.py"),
                        "--out-prefix", os.path.join(DATA, "synth")],
                       check=True)
    return torch.device("cuda", 0)


def _batch(n=200):
    reader = native.NativeBatchReader(os.path.join(DATA, "synth_1.fastq"),
                                      os.path.join(DATA, "synth_2.fastq"),
                                      batch=n, L=512)
    b = next(reader)
    reader.close()
    return b


def _check(dev, plane, flen, rlen, Lb, O, k, nt=False):
    """cand_join against its plain version on the card, in list and mask
    form. Returns the mask."""
    plane = torch.from_numpy(plane).to(dev)
    flen = torch.from_numpy(np.ascontiguousarray(flen, np.int32)).to(dev)
    rlen = torch.from_numpy(np.ascontiguousarray(rlen, np.int32)).to(dev)
    args = (plane, flen, rlen, Lb, O, k)
    for mode in ("list", "mask"):
        got = cand.candidates_join(*args, mode, C, nt=nt)
        assert torch.equal(got, fused2.plain_candidates_join(
            *args, mode, C, nt=nt)), (mode, nt)
    torch.cuda.synchronize()
    return got.cpu().numpy()


@pytest.mark.parametrize("Lb,O,k", [(128, 96, 2), (256, 256, 1),
                                    (256, 192, 2), (384, 384, 3),
                                    (512, 512, 2)])
def test_kernels_equal_twins_and_host_mask(dev, Lb, O, k):
    b = _batch()
    plane, hasN = native.pack4(b, Lb)
    mask = _check(dev, plane, b.flen, b.rlen, Lb, O, k)
    if Lb >= 256:  # the frame holds whole reads: host twin comparable
        rows = np.flatnonzero(~hasN)
        host = native.cand_mask(b, rows, k, O)
        np.testing.assert_array_equal(mask[rows], host)


def test_kernels_equal_twins_random_planes(dev):
    rng = np.random.default_rng(3)
    B, L = 512, 256
    plane = rng.integers(-128, 128, size=(B, L // 2), dtype=np.int8)
    plane[:B // 4] = 0b01010101
    flen = rng.integers(0, L + 1, B)
    rlen = rng.integers(0, L + 1, B)
    for k in (0, 1, 2, 3):
        _check(dev, plane, flen, rlen, L, L, k)


@pytest.mark.parametrize("Lb,O", [(96, 64), (256, 256), (384, 320),
                                  (512, 512)])
def test_cand_join_nt_equals_plain(dev, Lb, O):
    """cand_join on the nibble plane (N runs, degenerate codes, pads,
    poly-C rows) against its plain version at num_kmers 0-3; and on the
    synth reads with N against native.cand_mask."""
    rng = np.random.default_rng(Lb + O)
    nt, flen, rlen = _nt_planes(rng, 256, Lb)
    for k in (0, 1, 2, 3):
        _check(dev, nt, flen, rlen, Lb, O, k, nt=True)
    if Lb >= 256:
        b = _batch()
        nt = np.ascontiguousarray(b.nt_packed()[:, :Lb])
        rows = np.arange(len(b.sids), dtype=np.int64)
        for k in (1, 2, 3):
            mask = _check(dev, nt, b.flen, b.rlen, Lb, O, k, nt=True)
            np.testing.assert_array_equal(mask,
                                          native.cand_mask(b, rows, k, O))


def test_engine_on_card_equals_cpu(dev, monkeypatch):
    """200 synth pairs in 4 batches of one shape bucket: one launch of
    cand_join per dispatch (4 ungrouped, 2 in groups of 3)."""
    monkeypatch.setenv("PANDASEQ_TPU_HOST", "0")
    out = {}
    for device, group, launches in (("cpu", 1, 0), ("cuda", 1, 4),
                                    ("cuda", 3, 2)):
        cand.reset_launch_counts()
        asm = BatchAssembler(device=device)
        reader = native.NativeBatchReader(
            os.path.join(DATA, "synth_1.fastq"),
            os.path.join(DATA, "synth_2.fastq"), batch=64, L=512)
        out[device, group] = b"".join(
            p for _, _, p in asm.emit_stream(reader, depth=2,
                                             threaded=True, group=group))
        assert cand.launch_counts() == dict(
            dict.fromkeys(cand.KERNELS, 0), cand_join=launches)
    assert out["cpu", 1] and len(set(out.values())) == 1


def _nt_planes(rng, B, L):
    """Nibble planes with N runs, degenerate codes, zero tails past the
    read lengths and low-entropy rows (repeated k-mers)."""
    codes = np.array([1, 2, 4, 8, 1, 2, 4, 8, 15, 5, 10, 3], np.uint8)
    fwd = codes[rng.integers(0, len(codes), (B, L))]
    rev = codes[rng.integers(0, len(codes), (B, L))]
    fwd[:B // 8] = 2  # poly-C: every k-mer equal
    rev[:B // 8] = 2
    fwd[B // 8:B // 4, 20:40] = 15  # N runs
    flen = rng.integers(0, L + 1, B).astype(np.int32)
    rlen = rng.integers(0, L + 1, B).astype(np.int32)
    pos = np.arange(L)[None, :]
    fwd[pos >= flen[:, None]] = 0
    rev[pos >= rlen[:, None]] = 0
    return (fwd | (rev << 4)).view(np.int8), flen, rlen


@pytest.mark.parametrize("Lb,O", [(128, 96), (256, 256), (384, 320)])
def test_dense_kernels_equal_twins(dev, Lb, O):
    """counts and shortlist against their twins on the card, exactly, for
    every num_kmers and score kind, with maxoverlap 0 and > 0; the
    counts' k-mer hits set the bits of cand_join's mask."""
    rng = np.random.default_rng(Lb)
    B = 256
    nt, flen, rlen = _nt_planes(rng, B, Lb)
    fo = rng.integers(0, 4, B).astype(np.int32)
    ro = rng.integers(0, 4, B).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    nt, flen, rlen, fo, ro = map(t, (nt, flen, rlen, fo, ro))
    for k in (0, 1, 2, 3):
        got = dense.counts(nt, flen, rlen, Lb, O, k)
        for g, w in zip(got, fused2.plain_counts(nt, flen, rlen, Lb, O, k)):
            assert torch.equal(g, w)
        assert torch.equal(fused2.pack_bits16(got[2] != 0, O),
                           cand.candidates_join(nt, flen, rlen, Lb, O, k,
                                                "mask", C, nt=True))
        for kind in fused2.COUNT_KINDS:
            for maxoverlap in (0, 200):
                kw = dict(O=O, SL=8, minoverlap=3, maxoverlap=maxoverlap,
                          algo_kind=kind, pmatch=-0.0105, pmismatch=-2.36,
                          nn=-1.386294, band=0.01)
                sl = dense.shortlist(*got, flen, rlen, fo, ro, **kw)
                want = fused2.plain_shortlist(*got, flen, rlen, fo, ro,
                                              **kw)
                assert torch.equal(sl, want), (k, kind, maxoverlap)
    torch.cuda.synchronize()


@pytest.mark.parametrize("O", [128, 256, 384, 512, 1024])
def test_shortlist_edge_rows_equal_plain(dev, O):
    """The warp-per-pair shortlist against its plain version on the rows
    a warp design gets wrong first (tests/shortlist_rows.py: all -inf,
    -0.0 beside +0.0, equal scores across lanes and words, fewer finite
    scores than SL, a stitch wrap), for every score kind, with
    maxoverlap 0 and > 0, at every per-lane slot count of the kernel."""
    rng = np.random.default_rng(O)
    r = {k: torch.from_numpy(v).to(dev) for k, v in edge_rows(rng, O).items()}
    ints = [r[k] for k in ("m", "unk", "candc", "flen", "rlen", "fo", "ro")]
    for kind in dense.SCORE_KINDS:
        lut = kind in dense.LUT_KINDS
        for maxoverlap in (0, 150):
            kw = dict(O=O, SL=8, minoverlap=3, maxoverlap=maxoverlap,
                      algo_kind=kind, pmatch=-0.0105, pmismatch=-2.36,
                      nn=-1.386294, band=0.05 if lut else 0.01,
                      lutsum=r["lutsum"] if lut else None)
            got = dense.shortlist(*ints, **kw)
            assert torch.equal(got, fused2.plain_shortlist(*ints, **kw)), (
                kind, maxoverlap)
            if lut:  # top_k's order: +0.0 (offsets 8, 42) above -0.0;
                # argmax's first zero (offset 4); best32 the last zero's
                # sign (offset 71, a -0.0), as XLA's max on the CPU
                row = got[ZERO_TIE_ROW].cpu()
                assert [int(x) & 1023 for x in row[:5]] == [8, 42, 4, 41, 71]
                assert int(row[16]) == 4
                assert int(row[19]) == int(np.float32(-0.0).view(np.int32))
    torch.cuda.synchronize()


@pytest.mark.parametrize("k", [1, 2, 3])
def test_candidates_nt_equal_host_mask(dev, k):
    """assemble_candidates_nt on the card equals the exact host twin
    native.cand_mask, on the synth reads (N bases included)."""
    b = _batch()
    Lb = 256
    nt = np.ascontiguousarray(b.nt_packed()[:, :Lb])
    got = fused2.assemble_candidates_nt(
        torch.from_numpy(nt).to(dev), torch.from_numpy(b.flen).to(dev),
        torch.from_numpy(b.rlen).to(dev), L=Lb, num_kmers=k)
    rows = np.arange(len(b.sids), dtype=np.int64)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  native.cand_mask(b, rows, k, Lb))


@pytest.mark.parametrize("name", ["simple_bayesian", "stitch"])
def test_engine_k0_on_card_equals_cpu(dev, monkeypatch, name):
    """-k 0: the dense kernels, once each per dispatch, give the bytes
    of the plain twins."""
    monkeypatch.setenv("PANDASEQ_TPU_HOST", "0")
    cfg = oracle.OracleConfig()
    cfg.algorithm = oracle.make_algorithm(name, None)
    cfg.num_kmers = 0
    out = {}
    for device, launches in (("cpu", 0), ("cuda", 4)):
        cand.reset_launch_counts()
        asm = BatchAssembler(cfg, device=device)
        reader = native.NativeBatchReader(
            os.path.join(DATA, "synth_1.fastq"),
            os.path.join(DATA, "synth_2.fastq"), batch=64, L=512)
        out[device] = b"".join(
            p for _, _, p in asm.emit_stream(reader, depth=2,
                                             threaded=True))
        assert cand.launch_counts() == dict(
            dict.fromkeys(cand.KERNELS, 0), counts=launches,
            shortlist=launches)
    assert out["cpu"] and out["cuda"] == out["cpu"]


def _lut_inputs(dev, rng, B, L, rows="random"):
    """Nibble planes with N runs and pads and quals from -3 to 49 with
    stale tails ("random"), or the edge rows of tests/lut_rows.py
    ("edge"); and pear's and rdp_mle's tables on the card."""
    import math

    from pandaseq_tpu_torch import tables
    from tests.lut_rows import lut_edge_rows
    if rows == "edge":
        fwd, rev, fq, rq, flen, rlen = lut_edge_rows(rng, B, L)
        nt = (fwd | (rev << 4)).view(np.int8)
    else:
        nt, flen, rlen = _nt_planes(rng, B, L)
        fq = rng.integers(-3, 50, (B, L)).astype(np.int8)
        rq = rng.integers(-3, 50, (B, L)).astype(np.int8)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    nn = float(tables.QUAL_NN_SIMPLE_BAYESIAN)
    luts = {"pear": (tables.QUAL_MATCH_PEAR, tables.QUAL_MISMATCH_PEAR,
                     -math.log(0.25)),
            "rdp_mle": (tables.QUAL_MATCH_SIMPLE_BAYESIAN - nn,
                        tables.QUAL_MISMATCH_RDP_MLE - nn, 0.0)}
    luts = {k: (fused2.lut_table(a, dev), fused2.lut_table(b, dev), c)
            for k, (a, b, c) in luts.items()}
    return tuple(map(t, (nt, fq, rq, flen, rlen))), luts


@pytest.mark.parametrize("rows", ["random", "edge"])
@pytest.mark.parametrize("Lb,O", [(128, 96), (256, 256), (512, 512),
                                  (1024, 1024)])
def test_lut_sums_equal_twin(dev, Lb, O, rows):
    """lut_sums against its twin bit for bit, over the full plane and the
    row blocks of op 2 and 4 (and one block that is not aligned to the
    kernel's 8 diagonals a thread), for pear and rdp_mle, on random
    planes and on the edge rows of tests/lut_rows.py; then the LUT kind
    of the shortlist kernel against its twin, and the [B, 3L]
    single-upload entry point against assemble_shortlist (its nt columns
    are a strided view of the plane)."""
    rng = np.random.default_rng(Lb + O)
    B = 256
    (nt, fq, rq, flen, rlen), luts = _lut_inputs(dev, rng, B, Lb, rows)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    for kind, (tm, tmm, nn) in luts.items():
        full = dense.lut_sums(nt, fq, rq, flen, rlen, O, kind, tm, tmm, nn)
        want = fused2.plain_lut_sums(nt, fq, rq, flen, rlen, O, kind, tm,
                                     tmm, nn)
        assert torch.equal(full.view(torch.int32), want.view(torch.int32))
        blocks = [(j0, O // op) for op in (2, 4)
                  for j0 in range(0, O, O // op)] + [(4, O // 2 - 12)]
        for j0, Oj in blocks:
            got = dense.lut_sums(nt, fq, rq, flen, rlen, O, kind, tm, tmm,
                                 nn, j0, Oj)
            want = fused2.plain_lut_sums(nt, fq, rq, flen, rlen, O, kind,
                                         tm, tmm, nn, j0, Oj)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (kind, j0, Oj)
        counts = dense.counts(nt, flen, rlen, Lb, O, 2)
        for maxoverlap in (0, 200):
            kw = dict(O=O, SL=8, minoverlap=3, maxoverlap=maxoverlap,
                      algo_kind=kind, pmatch=0.0, pmismatch=0.0,
                      nn=-1.386294, band=fused2.BAND_LUT, lutsum=full)
            assert torch.equal(
                dense.shortlist(*counts, flen, rlen, zeros, zeros, **kw),
                fused2.plain_shortlist(*counts, flen, rlen, zeros, zeros,
                                       **kw))
        if O == Lb:
            kw = dict(L=Lb, algo_kind=kind, nn_term=nn, lut_match=tm,
                      lut_mismatch=tmm)
            assert torch.equal(
                fused2.assemble_shortlist_packed(
                    torch.cat((nt, fq, rq), dim=1), flen, rlen, zeros,
                    zeros, **kw),
                fused2.assemble_shortlist(nt, fq, rq, flen, rlen, zeros,
                                          zeros, **kw))
    torch.cuda.synchronize()


@pytest.mark.parametrize("Lb,O", [(128, 96), (256, 256), (384, 384)])
def test_row_block_kernels_equal_twins_and_full(dev, Lb, O):
    """counts over the row blocks of op 2 and 4, at num_kmers 0 and 2,
    with the k-mer hits of the block's rows and with the mesh's hit rows
    (every row in the first block, none in the others): each block
    equals its twin and the blocks add up to the full-plane kernel's
    counts, exactly; the blocks' own hits fall on the diagonals of the
    full-plane cand_join mask and together set all of its bits."""
    rng = np.random.default_rng(O)
    nt, flen, rlen = _nt_planes(rng, 256, Lb)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    nt, flen, rlen = map(t, (nt, flen, rlen))
    for k in (0, 2):
        full = dense.counts(nt, flen, rlen, Lb, O, k)
        full_mask = cand.candidates_join(nt, flen, rlen, Lb, O, k, "mask",
                                         C, nt=True)
        for op in (2, 4):
            Oj = O // op
            for mesh_hits in (False, True):
                sums = [torch.zeros_like(x) for x in full]
                for j0 in range(0, O, Oj):
                    hit_rows = (0, O if j0 == 0 else 0) if mesh_hits \
                        else None
                    got = dense.counts(nt, flen, rlen, Lb, O, k, j0, Oj,
                                       hit_rows)
                    for s, g, w in zip(sums, got, fused2.plain_counts(
                            nt, flen, rlen, Lb, O, k, j0, Oj, hit_rows)):
                        assert torch.equal(g, w)
                        s += g
                    hits = fused2.pack_bits16(got[2] != 0, O)
                    assert torch.equal(hits & full_mask, hits)
                for s, f in zip(sums, full):
                    assert torch.equal(s, f)
                assert torch.equal(fused2.pack_bits16(sums[2] != 0, O),
                                   full_mask)
    torch.cuda.synchronize()


@pytest.mark.parametrize("num_kmers", [1, 2, 3])
def test_mesh_steps_join_once_per_dp_row(dev, num_kmers):
    """On a (dp=2, op=2) mesh of one card, the candidate steps launch
    cand_join once per dp row (2), not once per cell, with the
    single-device mask; the shortlist step launches counts once per cell
    (4) and the shortlist once per dp row, with the single-device
    result, its k-mer hits counted in each dp row's first cell."""
    from pandaseq_tpu_torch.parallel import shard
    rng = np.random.default_rng(num_kmers)
    Lb, B = 256, 64
    nt, flen, rlen = _nt_planes(rng, B, Lb)
    fo = np.zeros(B, np.int32)
    mesh = shard.make_mesh(devices=[dev] * 4, dp=2, op=2)
    kernels = dict.fromkeys(cand.KERNELS, 0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    for step in (shard.make_sharded_cand_step,
                 shard.make_sharded_cand_step_packed4):
        plane = nt if step is shard.make_sharded_cand_step else \
            np.ascontiguousarray(nt.view(np.uint8)[:, :Lb // 2]).view(
                np.int8)
        cand.reset_launch_counts()
        got = step(mesh, L=Lb, num_kmers=num_kmers)(plane, flen, rlen)
        assert cand.launch_counts() == dict(kernels, cand_join=2)
        nt_plane = step is shard.make_sharded_cand_step
        assert torch.equal(got, fused2.plain_candidates_join(
            torch.from_numpy(plane), torch.from_numpy(flen),
            torch.from_numpy(rlen), Lb, Lb, num_kmers, "mask",
            nt=nt_plane).to(dev))
    cand.reset_launch_counts()
    args = (nt, None, None, flen, rlen, fo, fo)
    got = shard.make_sharded_step(mesh, L=Lb, num_kmers=num_kmers)(*args)
    assert cand.launch_counts() == dict(kernels, counts=4, shortlist=2)
    assert torch.equal(got, fused2.assemble_shortlist_nt(
        *map(t, (nt, flen, rlen, fo, fo)), L=Lb, num_kmers=num_kmers))
    torch.cuda.synchronize()


@pytest.mark.parametrize("num_kmers", [2, 0])
def test_mesh_engine_on_card_equals_cpu(dev, monkeypatch, num_kmers):
    """A (dp=2, op=2) mesh on one card through the engine gives the CPU
    engine's bytes; each 64-pair batch splits, so each launches cand_join
    once per dp row (2), or counts once per mesh cell (4) and the
    shortlist once per dp row (2); the last batch of 8 splits too."""
    from pandaseq_tpu_torch.parallel import shard
    monkeypatch.setenv("PANDASEQ_TPU_HOST", "0")
    cfg = oracle.OracleConfig(num_kmers=num_kmers)
    out = {}
    for device in ("cpu", "cuda"):
        cand.reset_launch_counts()
        mesh = shard.make_mesh(devices=[device] * 4, dp=2, op=2)
        asm = BatchAssembler(cfg, mesh=mesh)
        reader = native.NativeBatchReader(
            os.path.join(DATA, "synth_1.fastq"),
            os.path.join(DATA, "synth_2.fastq"), batch=64, L=512)
        out[device] = b"".join(
            p for _, _, p in asm.emit_stream(reader, depth=2,
                                             threaded=True))
        if device == "cuda":
            path = ("cand_join",) if num_kmers else ("counts", "shortlist")
            want = dict.fromkeys(cand.KERNELS, 0)
            for name in path:
                want[name] = 4 * (4 if name == "counts" else 2)
            assert cand.launch_counts() == want
    assert out["cpu"] and out["cuda"] == out["cpu"]


def test_engine_on_named_card_and_across_cards(dev, monkeypatch):
    """The engine on the last visible card, named as ``device=``, while
    cuda:0 stays the current device: every kernel launches on the
    tensors' card. With several cards, meshes across them too (all on dp,
    and dp x op=2 when the count is even). All give the CPU engine's
    bytes; each launches the sparse path's cand_join."""
    from pandaseq_tpu_torch.parallel import shard
    monkeypatch.setenv("PANDASEQ_TPU_HOST", "0")
    n = torch.cuda.device_count()
    runs = {"cpu": lambda: BatchAssembler(device="cpu"),
            "named": lambda: BatchAssembler(device="cuda:%d" % (n - 1))}
    if n > 1:
        runs["mesh dp"] = lambda: BatchAssembler(mesh=shard.make_mesh())
        if n % 2 == 0:
            runs["mesh dp x op"] = lambda: BatchAssembler(
                mesh=shard.make_mesh(op=2))
    out = {}
    with torch.cuda.device(0):
        for name, make in runs.items():
            cand.reset_launch_counts()
            reader = native.NativeBatchReader(
                os.path.join(DATA, "synth_1.fastq"),
                os.path.join(DATA, "synth_2.fastq"), batch=64, L=512)
            out[name] = b"".join(p for _, _, p in make().emit_stream(
                reader, depth=2, threaded=True))
            assert torch.cuda.current_device() == 0
            launched = cand.launch_counts()
            assert (launched["cand_join"] > 0) == (name != "cpu"), name
    assert out["cpu"] and len(set(out.values())) == 1, sorted(out)
