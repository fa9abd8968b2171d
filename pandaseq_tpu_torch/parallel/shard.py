"""Multi-device execution of the PyTorch port: the (dp, op) mesh and the
sharded device steps.

Counterpart of ``pandaseq_tpu/parallel/shard.py``. The JAX package runs
one SPMD program over a ``jax.sharding.Mesh`` (``shard_map``, ``psum``
over "op"); here the split is written out over a grid of
``torch.device``s:

* ``dp`` rows: the read-pair batch splits row-wise over the mesh's dp
  rows when ``B % dp == 0``; otherwise the whole batch runs on the mesh's
  first device, as the JAX engine's unsharded dispatch does. Each row's
  share is uploaded to the row's first device.
* ``op`` cells within a dp row: in the shortlist step every cell
  computes its block of overlap-plane rows ``[j0, j0+Oj)``, ``Oj = O /
  op``, through the row-block forms of ``counts`` (matches and N) and
  ``lut_sums`` (``fused2.device_ops``). The k-mer windows and the rank
  cross row blocks, so the k-mer hits' sort-join is not split: the
  row's first cell counts the hits of every row (``counts``' hit rows)
  and the other cells none, and the candidate step runs ``cand_join``
  once per dp row, on the row's first device, over the whole plane.
* the reduction ``psum`` does in JAX: partial int32 counts and partial
  f32 LUT sums are copied to the row's first device and added in op
  order, and the shortlist runs once per dp row on that device. Integer
  partials add up to the full plane bit for bit; the f32 LUT sums only
  up to summation order.

A step's result is gathered on the mesh's first device. A device may
appear more than once: the CPU tests build the JAX tests' 8-device mesh
as ``make_mesh(devices=["cpu"] * 8, op=2)``, and one card carries a
(dp, op) split as ``make_mesh(devices=["cuda:0"] * 4, dp=2, op=2)``;
cells on one card run one after another. Each kernel wrapper makes its
tensors' card the current device for the launch, so a cell may lie on
any card; a mesh across several cards has not been run on such a
machine yet.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import runtime
from ..ops import fused2
from ..tables import QUAL_NN_SIMPLE_BAYESIAN

NN = float(QUAL_NN_SIMPLE_BAYESIAN)  # the step's nn, as in the JAX body


class Mesh:
    """A dp x op grid of torch devices. ``shape`` is ``{"dp": dp, "op":
    op}``, as the JAX mesh's, so the engine reads it the same way."""

    def __init__(self, devices):
        rows = [list(row) for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid of "
                             "devices")
        types = {torch.device(d).type for r in rows for d in r}
        if len(types) != 1:
            raise ValueError(f"a mesh mixes device types {sorted(types)}: "
                             "its cells are all CUDA devices or all the CPU")
        self.devices = [[runtime.resolve_device(d) for d in r]
                        for r in rows]
        self.shape = {"dp": len(rows), "op": len(rows[0])}

    @property
    def first(self) -> torch.device:
        return self.devices[0][0]


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              op: int = 1, devices=None) -> Mesh:
    """Build a (dp, op) mesh over the first ``n_devices`` of ``devices``
    (default: every visible card once). dp shards the read-pair batch; op
    shards the overlap-plane rows. Default: all devices on the dp axis.
    ``devices`` may repeat a device."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n:
            raise RuntimeError("no CUDA device is visible; pass devices= "
                               "(e.g. ['cpu'] * 8) for a mesh on the CPU")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = list(devices)
    if n_devices is None:
        n_devices = len(devs)
    if dp is None:
        dp = n_devices // op
    if dp < 1 or dp * op != n_devices or n_devices > len(devs):
        raise ValueError(f"dp={dp} x op={op} does not make {n_devices} of "
                         f"the {len(devs)} devices")
    return Mesh([devs[r * op:(r + 1) * op] for r in range(dp)])


def dp_rows(mesh: Mesh, B: int):
    """[(lo, hi, devices of the row's op cells)] per dp row. The batch
    splits only when ``B % dp == 0``; otherwise it runs whole on the
    mesh's first device alone."""
    ndp = mesh.shape["dp"]
    if B % ndp:
        return [(0, B, [mesh.first])]
    n = B // ndp
    return [(r * n, (r + 1) * n, row) for r, row in enumerate(mesh.devices)]


class ShardedArray(NamedTuple):
    """One array split row-wise over a mesh's dp rows (``shard_batch``):
    ``parts[r]`` holds the rows of ``rows[r]`` on that row's first
    device."""
    parts: list
    rows: list


def _place(a, rows) -> ShardedArray:
    t = torch.as_tensor(np.ascontiguousarray(a) if isinstance(
        a, np.ndarray) else a).contiguous()
    if t.device.type == "cpu" and rows[0][2][0].type == "cuda":
        t = t.pin_memory()  # the uploads below do not block
    return ShardedArray([t[lo:hi].to(devs[0], non_blocking=True)
                         for lo, hi, devs in rows], rows)


def shard_batch(mesh: Mesh, arrays):
    """Place host arrays on the mesh with batch-dim sharding: for each a
    ShardedArray whose part r lies on dp row r's first device. ``None``
    stays ``None``."""
    arrays = list(arrays)
    rows = dp_rows(mesh, len(next(a for a in arrays if a is not None)))
    return tuple(None if a is None else _place(a, rows) for a in arrays)


def _shards(mesh, args):
    """(rows, one argument tuple per dp row) from host arrays or
    ShardedArrays."""
    placed = [a for a in args if isinstance(a, ShardedArray)]
    rows = placed[0].rows if placed else dp_rows(
        mesh, len(next(a for a in args if a is not None)))
    args = [a if a is None or isinstance(a, ShardedArray)
            else _place(a, rows) for a in args]
    return rows, [tuple(None if a is None else a.parts[r] for a in args)
                  for r in range(len(rows))]


def _gather(mesh, outs):
    outs = [o.to(mesh.first) for o in outs]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _make_step(mesh, body):
    """step(*arrays): ``body(row devices, *row arrays)`` on each dp row,
    gathered on the mesh's first device."""
    def step(*args):
        rows, per_row = _shards(mesh, args)
        return _gather(mesh, [body(devs, *a)
                              for (_, _, devs), a in zip(rows, per_row)])
    return step


def run_dp(mesh: Mesh, fn, arrays):
    """``fn``, a batch-parallel single-device step, on each dp row's share
    of ``arrays`` on the row's first device; the results gathered on the
    mesh's first device. The port's form of running a step on dp-sharded
    inputs."""
    return _make_step(mesh, lambda devs, *a: fn(*a))(*arrays)


def _blocks(devs, O):
    """(device, j0, Oj) of each op cell of a dp row."""
    n = len(devs)
    if O % n:
        raise ValueError(f"O={O} does not split into op={n} row blocks")
    Oj = O // n
    return [(d, k * Oj, Oj) for k, d in enumerate(devs)]


def _sum(parts, dev):
    """The op cells' partials added in op order on ``dev``."""
    total = parts[0].to(dev)
    for p in parts[1:]:
        total = total + p.to(dev)
    return total


def _int32(*xs):
    return [x.to(torch.int32).contiguous() for x in xs]


def _sharded_body(devs, nt_pack, fr_q, rr_q, flen, rlen, fo, ro, *, L, O,
                  SL, minoverlap, maxoverlap, num_kmers, algo_kind,
                  pmatch, pmismatch, nn_term, band, lut_tables):
    """One dp row of the shortlist step: each op cell counts the matches
    and N of its row block (and sums its LUT terms), the first cell also
    the k-mer hits of every row (the sort-join runs once per dp row),
    the partials add up on the row's first device, and the shortlist
    runs there once."""
    lut = algo_kind in fused2.LUT_KINDS
    flen, rlen, fo, ro = _int32(flen, rlen, fo, ro)
    parts = []
    for dev, j0, Oj in _blocks(devs, O):
        ops = fused2.device_ops(dev)
        nt, fl, rl = (x.to(dev) for x in (nt_pack, flen, rlen))
        part = ops.counts(nt, fl, rl, L, O, num_kmers, j0, Oj,
                          hit_rows=(0, O if j0 == 0 else 0))
        if lut:
            part += (ops.lut_sums(nt, fr_q.to(dev), rr_q.to(dev), fl, rl,
                                  O, algo_kind, *lut_tables(dev), nn_term, j0,
                                  Oj),)
        parts.append(part)
    sums = [_sum(p, devs[0]) for p in zip(*parts)]
    return fused2.device_ops(devs[0]).shortlist(
        *sums[:3], flen, rlen, fo, ro, O=O, SL=SL, minoverlap=minoverlap,
        maxoverlap=maxoverlap, algo_kind=algo_kind, pmatch=pmatch,
        pmismatch=pmismatch, nn=NN, band=band, lutsum=sums[3] if lut else None)


def _sharded_cand_body(devs, nt_pack, flen, rlen, *, L, O, num_kmers,
                       nt=True):
    """One dp row of the candidate step: the candidate search over the
    whole plane, once, on the row's first device (the mask
    ``pack_bits16(psum(candc) != 0)`` of the JAX body, whose op cells
    each search a row block: the k-mer windows and the rank cross row
    blocks, so a block's search would repeat the pair's decode, sort and
    probes). The row's other op cells take no part."""
    return fused2.device_ops(devs[0]).candidates_join(
        nt_pack, *_int32(flen, rlen), L, O, num_kmers, "mask",
        fused2.CAND_LIST_C, nt=nt)


def _sharded_cand_body_packed4(devs, plane4, flen, rlen, *, L, O,
                               num_kmers):
    """The candidate step on the 4-bit packed upload (psq_pack4; rows
    with N are recomputed on host, as on one device)."""
    return _sharded_cand_body(devs, plane4, flen, rlen, L=L, O=O,
                              num_kmers=num_kmers, nt=False)


def make_sharded_cand_step_packed4(mesh: Mesh, L: int,
                                   O: int | None = None,
                                   num_kmers: int = 2):
    """The production sparse candidate step (4-bit packed upload) over
    ``mesh``: ``step(plane4, flen, rlen) -> [B, O//32]`` int32, equal to
    assemble_candidates_packed4; the engine uses it when its mesh has an
    op axis wider than 1."""
    return _make_step(mesh, functools.partial(
        _sharded_cand_body_packed4, L=L, O=L if O is None else O,
        num_kmers=num_kmers))


def make_sharded_cand_step(mesh: Mesh, L: int, O: int | None = None,
                           num_kmers: int = 2):
    """The candidate step on the nibble plane over ``mesh``:
    ``step(nt_pack, flen, rlen) -> [B, O//32]`` int32, equal to
    assemble_candidates_nt."""
    return _make_step(mesh, functools.partial(
        _sharded_cand_body, L=L, O=L if O is None else O,
        num_kmers=num_kmers))


def make_sharded_step(mesh: Mesh, L: int, O: int | None = None,
                      SL: int = fused2.SHORTLIST, minoverlap: int = 2,
                      maxoverlap: int = 0, num_kmers: int = 2,
                      algo_kind: str = "counts", pmatch: float = 0.0,
                      pmismatch: float = 0.0, nn_term: float = 0.0,
                      band: float | None = None, lut_match=None,
                      lut_mismatch=None):
    """The production shortlist step over ``mesh``, batch sharded over
    dp, overlap-plane rows over op: ``step(nt_pack, fr_q, rr_q, flen,
    rlen, fo, ro) -> [B, 2*SL+4]`` int32 (nt_pack = fwd|rev<<4 nibble
    plane), equal to fused2.assemble_shortlist on one device: bit for
    bit for the count kinds; for pear / rdp_mle up to the f32 summation
    order of the LUT sums over op. The qual planes are read only by the
    LUT kinds (and may be None otherwise)."""
    lut = algo_kind in fused2.LUT_KINDS
    if band is None:
        band = fused2.BAND_LUT if lut else fused2.BAND_COUNTS
    if lut and (lut_match is None or lut_mismatch is None):
        raise ValueError(f"{algo_kind} scores LUT sums: pass lut_match "
                         "and lut_mismatch")
    cache = {}

    def lut_tables(dev):
        """The f32 tables on ``dev``, made once per device."""
        if dev not in cache:
            cache[dev] = (fused2.lut_table(lut_match, dev),
                          fused2.lut_table(lut_mismatch, dev))
        return cache[dev]

    return _make_step(mesh, functools.partial(
        _sharded_body, L=L, O=L if O is None else O, SL=SL,
        minoverlap=minoverlap, maxoverlap=maxoverlap, num_kmers=num_kmers,
        algo_kind=algo_kind, pmatch=pmatch, pmismatch=pmismatch,
        nn_term=nn_term, band=band, lut_tables=lut_tables))


def shard_fused_batch(mesh: Mesh, asm, batch):
    """Run the production device step with the read-pair batch sharded
    over the mesh; host finalization then proceeds as on one device.
    ``asm`` is a BatchAssembler of the port; returns (st, dev) ready for
    ``asm._finalize``."""
    prev = asm.mesh
    asm.mesh = mesh
    try:
        st = asm._pre(batch)
        dev = asm._dispatch(st)
    finally:
        asm.mesh = prev
    return st, dev
