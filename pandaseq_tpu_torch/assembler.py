"""Batch engine of the PyTorch port.

``BatchAssembler`` is the JAX package's host engine
(``pandaseq_tpu.assembler.BatchAssembler``: native decode, ``_pre``,
the 4-bit packed or nibble upload plane, the native ``psq_finalize``,
the oracle replay of undecided pairs, the pipelines) with only its
device seams replaced:

* ``__init__`` takes ``device=`` or ``mesh=`` (parallel/shard.py) and
  builds the port's tables (the parent's imports ``ops.fused2`` and with
  it JAX);
* ``_launch`` uploads the upload plane and the ``[B]`` arrays from
  pinned host memory without blocking, runs the device step's CUDA
  kernels on the current stream and starts the copy of the result back
  into pinned memory. It returns a ``_PendingList`` whose ``__array__``
  waits on a CUDA event: the finalizer only ever sees numpy arrays,
  never a CUDA tensor. The sparse path (every built-in algorithm at
  ``-k >= 1``) runs ``kmer_frames`` -> ``cand`` into a ``[B, 6]`` int16
  candidate list (ops/cand.py); the dense path (``-k 0`` on the device,
  custom algorithms at any ``-k``) runs ``kmer_frames_nt`` -> ``counts``
  -> ``shortlist`` into a ``[B, 20]`` int32 shortlist (ops/dense.py).
  pear and rdp_mle never take the dense path: with the native library,
  which the port requires, they run sparse at every ``-k``, so their
  LUT sums (``lut_sums``) are reached only through the library entry
  points (``fused2.assemble_shortlist``, ``shard.make_sharded_step``).
  On a CPU device the plain twins run;
* ``_dispatch`` and ``_dispatch_op`` route a batch as the parent's do
  (the overflow reroute, the sparse / host-only paths, then the mesh):
  under a mesh whose op axis is wider than 1 (and ``O % op == 0``,
  ``B % dp == 0``) the op-sharded steps of parallel/shard.py run, the
  sparse one returning the candidate mask; otherwise the single-device
  step runs on each dp row's share (``shard.run_dp``), or on the whole
  batch on the mesh's first device when ``B % dp != 0``;
* ``_mask_from_list`` takes ``CAND_LIST_C`` from the port;
* engine resolution keeps the JAX package's order: constructor, then
  ``PANDASEQ_TPU_ENGINE=host|tpu`` (``tpu``, the JAX package's name,
  pins the device engine), then legacy ``PANDASEQ_TPU_HOST``, then a
  mesh (which pins the device engine, reason ``mesh``), then the
  measured probe (``runtime.pick_engine``).

The device-offload and host-steal lanes (ROADMAP Q1 item 7) are off, so
every batch's device result comes from the kernels.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pandaseq_tpu.assembler import _ALGO_IDS, _NN, Counters
from pandaseq_tpu.assembler import BatchAssembler as _BatchAssembler
from pandaseq_tpu.io import native as _native
from pandaseq_tpu.oracle import OracleConfig
from pandaseq_tpu.tables import (QUAL_MATCH_PEAR, QUAL_MATCH_SIMPLE_BAYESIAN,
                                 QUAL_MISMATCH_PEAR, QUAL_MISMATCH_RDP_MLE)

from . import runtime
from .ops import fused2
from .parallel import shard

class _PendingList:
    """One launched batch's device result. ``np.asarray`` waits on
    the batch's CUDA event and returns the numpy view of its pinned host
    buffer; the batch's pinned inputs and device tensors stay referenced
    until then, so no buffer is reused while its batch is in flight."""

    __slots__ = ("_event", "_host", "_keep")

    def __init__(self, host, event=None, keep=None):
        self._host = host
        self._event = event
        self._keep = keep

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
            self._event = None
            self._keep = None
        out = self._host.numpy()
        if dtype is not None and out.dtype != dtype:
            out = out.astype(dtype)
        elif copy:
            out = out.copy()
        return out


def _fetch(out):
    """The device result ``out`` as a _PendingList: a CPU tensor as it
    is; from a card, a non-blocking copy into pinned host memory and the
    event that completes it."""
    if out.device.type == "cpu":
        return _PendingList(out)
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    event = torch.cuda.Event(blocking=True)
    event.record(torch.cuda.current_stream(out.device))
    return _PendingList(host, event, out)


class BatchAssembler(_BatchAssembler):
    """Assembles batches of read pairs with reference-identical output;
    the k-mer candidate search runs on ``device`` (see module doc)."""

    def __init__(self, cfg: OracleConfig | None = None, L: int = 512,
                 modules=(), need_p: bool | None = None, mesh=None,
                 host_only: bool | None = None, device=None):
        if _native.get_lib() is None:
            raise RuntimeError(
                "the native host library (native/psq_io.cpp) did not "
                "build; the port needs g++, zlib and libbz2")
        if mesh is None:
            self.device = runtime.resolve_device(device)
            # the single device as a 1x1 grid: _launch runs on it
            self._grid = shard.Mesh([[self.device]])
        else:
            if not isinstance(mesh, shard.Mesh):
                raise TypeError("mesh must be a parallel.shard.Mesh "
                                "(make_mesh)")
            if device is not None and \
                    torch.device(device).type != mesh.first.type:
                raise ValueError(f"device {device} is not of the mesh's "
                                 f"type ({mesh.first.type})")
            self.device = mesh.first
            self._grid = mesh
        # from here on, pandaseq_tpu.assembler.BatchAssembler.__init__
        # with the port's tables
        assert self.SL <= 32, "shortlist width exceeds the native bound"
        self.cfg = cfg or OracleConfig()
        self.L = L
        self.modules = list(modules)
        self.counters = Counters()
        self.mesh = mesh
        self._op_steps = {}
        self.need_p = bool(need_p)
        self._host_only = host_only
        self.engine_info = ({"reason": "constructor"}
                            if host_only is not None else None)
        algo = self.cfg.algorithm
        name = algo.name
        self._custom = name not in ("simple_bayesian", "uparse", "pear",
                                    "rdp_mle", "ea_util", "flash",
                                    "stitch")
        if name in ("pear", "rdp_mle", "ea_util", "flash", "stitch"):
            self._algo_kind = name
        else:
            self._algo_kind = "counts"
        self._pmatch = float(getattr(algo, "pmatch", 0.0))
        self._pmismatch = float(getattr(algo, "pmismatch", 0.0))
        if name == "pear":
            lut_m = np.ascontiguousarray(QUAL_MATCH_PEAR, np.float64)
            lut_mm = np.ascontiguousarray(QUAL_MISMATCH_PEAR, np.float64)
            self._nn_term = float(-algo.random_base)
        elif name == "rdp_mle":
            # per-element (LUT - nn) like the C loop (algo_rdp_mle.c:64)
            lut_m = np.ascontiguousarray(
                QUAL_MATCH_SIMPLE_BAYESIAN - _NN, np.float64)
            lut_mm = np.ascontiguousarray(
                QUAL_MISMATCH_RDP_MLE - _NN, np.float64)
            self._nn_term = 0.0
        else:
            lut_m = lut_mm = None
            self._nn_term = 0.0
        self._lut_m, self._lut_mm = lut_m, lut_mm
        self._algo_params = dict(
            algo_id=_ALGO_IDS[self._algo_kind], pmatch=self._pmatch,
            pmismatch=self._pmismatch, qual_nn=float(_NN),
            nn_term=self._nn_term, lut_m=lut_m, lut_mm=lut_mm)
        self._cfg_params = dict(minoverlap=self.cfg.minoverlap,
                                maxoverlap=self.cfg.maxoverlap,
                                threshold=float(self.cfg.threshold))
        self._fused2 = fused2
        self._ptbl = np.ascontiguousarray(fused2.build_ptable(algo),
                                          np.float64)
        from pandaseq_tpu.nt import result_phred
        # PHRED+33 output byte per pidx (panda_result_phred, nt.c:126-150)
        self._phtbl = np.ascontiguousarray(
            33 + result_phred(self._ptbl), np.uint8)
        self._payload_buf = None
        self._arrays_buf = None
        # candidate LIST download (12 B/pair) unless PANDASEQ_TPU_JOIN
        # asks for the bitmask form (the cand kernel's mask mode here)
        self._cand_list = not os.environ.get("PANDASEQ_TPU_JOIN")
        self._host_steals = 0
        self._offload_count = 0
        self._offload_timeouts = 0

    # -- engine resolution ---------------------------------------------
    def _resolve_host_only(self) -> bool:
        """Engine resolution, lazy at first dispatch. Priority:
        constructor host_only > PANDASEQ_TPU_ENGINE=host|tpu (tpu pins
        the device engine) > legacy PANDASEQ_TPU_HOST > a mesh (pins
        the device engine) > the measured probe (runtime.pick_engine: the
        device step against the native twin, cached per environment)."""
        if self._host_only is None:
            legacy = os.environ.get("PANDASEQ_TPU_HOST")
            env = os.environ.get("PANDASEQ_TPU_ENGINE", "")
            if env in ("host", "tpu"):
                self._host_only = env == "host"
                self.engine_info = {"reason": "env"}
            elif legacy is not None:
                self._host_only = legacy not in ("0", "")
                self.engine_info = {"reason": "env-legacy"}
            elif self.mesh is not None:
                self._host_only = False  # sharded runs pin the device
                self.engine_info = {"reason": "mesh"}
            else:
                eng, info = runtime.pick_engine(
                    self.device, num_kmers=min(max(self.cfg.num_kmers, 1),
                                               2))
                self._host_only = eng == "host"
                self.engine_info = info
        return self._host_only

    @property
    def engine(self) -> str:
        """'host' (the native psq_cand_mask twin) or the device type of
        the device step: 'cuda' for the kernels, 'cpu' for the plain
        twins."""
        return "host" if self._resolve_host_only() else self.device.type

    def _offload_enabled(self) -> bool:
        return False  # device-offload lane: ROADMAP Q1 item 7

    def _host_route_ok(self, sts):
        return False  # host-steal lane: ROADMAP Q1 item 7

    # -- the device step -----------------------------------------------
    def _dispatch(self, st):
        """Stage 1 (pandaseq_tpu/assembler.py:1213, with the mesh in the
        port's terms): the overflow reroute, then the host-only sparse
        path, then the op-sharded step (``_dispatch_op``) where the mesh
        has an op axis wider than 1, ``O % op == 0`` and ``B % dp ==
        0``, else the single-device step (``_launch``). Returns a
        _PendingList or a host array — never blocks on the device."""
        batch = st["batch"]
        Lb = st["Lb"]
        if st["O_full"] > st["O"]:
            return self._overflow_host(st)
        sparse, lut = self._sparse_mode()
        st["plane_kind"] = 1 if sparse else 0
        plane = None
        if sparse:
            if self._resolve_host_only():
                return self._sparse_host(st)
            plane = self._sparse_plane(st)
        use_op = False
        if self.mesh is not None:
            n_op = self.mesh.shape["op"]
            use_op = (n_op > 1 and st["O"] % n_op == 0
                      and st["B"] % self.mesh.shape["dp"] == 0)
        fo32 = st["fo"].astype(np.int32)
        ro32 = st["ro"].astype(np.int32)
        if use_op:
            return self._dispatch_op(st, batch, lambda a: self._cut(a, Lb),
                                     sparse, (plane, batch.flen, batch.rlen),
                                     fo32, ro32)
        if not sparse:
            plane = self._dense_plane(st, lut)
        if sparse and self._cand_list:
            st["cand_list"] = True  # _launch ships the list download
        return self._launch(sparse, lut, plane, batch.flen, batch.rlen,
                            fo32, ro32, Lb, st["O"])

    def _launch(self, sparse, lut, plane, flen, rlen, fo32, ro32, Lb, O):
        """The device step on already-built host arrays: the candidate
        search (sparse) or the dense shortlist, on each dp row's share
        of the batch (one row without a mesh); returns a _PendingList,
        never a device tensor."""
        cfg = self.cfg
        if sparse:
            step = (fused2.assemble_candidates_list_packed4
                    if self._cand_list
                    else fused2.assemble_candidates_packed4)
            args = ((plane, np.int8), (flen, np.int32), (rlen, np.int32))
            kw = dict(L=Lb, O=O, num_kmers=cfg.num_kmers)
        elif lut:
            raise NotImplementedError(
                "the engine runs pear / rdp_mle sparse; their dense step "
                "is fused2.assemble_shortlist")
        else:
            step = fused2.assemble_shortlist_nt
            args = ((plane, np.int8), (flen, np.int32), (rlen, np.int32),
                    (fo32, np.int32), (ro32, np.int32))
            kw = dict(L=Lb, O=O, SL=self.SL, minoverlap=cfg.minoverlap,
                      maxoverlap=cfg.maxoverlap, num_kmers=cfg.num_kmers,
                      algo_kind=self._algo_kind, pmatch=self._pmatch,
                      pmismatch=self._pmismatch)
        arrays = [np.ascontiguousarray(a, dt) for a, dt in args]
        return _fetch(shard.run_dp(self._grid, lambda *a: step(*a, **kw),
                                   arrays))

    def _dispatch_op(self, st, batch, cut, sparse, inputs, fo32, ro32):
        """Overlap-plane-row ("op")-sharded dispatch for a (dp, op) mesh
        (pandaseq_tpu/assembler.py:1381): the sharded steps of
        parallel/shard.py add exact integer partial diagonal sums (OR the
        partial masks), so the output equals the single-device step's.
        The sparse step returns the candidate mask, not the list."""
        cfg = self.cfg
        Lb, O = st["Lb"], st["O"]
        key = ("cand4" if sparse else self._algo_kind, Lb, O)
        step = self._op_steps.get(key)
        if sparse:
            if step is None:
                step = shard.make_sharded_cand_step_packed4(
                    self.mesh, L=Lb, O=O, num_kmers=cfg.num_kmers)
                self._op_steps[key] = step
            plane, flen, rlen = inputs
            return _fetch(step(np.ascontiguousarray(plane, np.int8),
                               flen, rlen))
        if step is None:
            step = shard.make_sharded_step(
                self.mesh, L=Lb, O=O, SL=self.SL,
                minoverlap=cfg.minoverlap, maxoverlap=cfg.maxoverlap,
                num_kmers=cfg.num_kmers, algo_kind=self._algo_kind,
                pmatch=self._pmatch, pmismatch=self._pmismatch)
            self._op_steps[key] = step
        # the count kinds read no quals (the LUT kinds run sparse)
        return _fetch(step(*shard.shard_batch(self.mesh, (
            cut(batch.nt_packed()), None, None, batch.flen, batch.rlen,
            fo32, ro32))))

    def _mask_from_list(self, st, lst):
        """Rebuild the [B, O//32] candidate bitmask from the device's
        first-C candidate list ([B, C+2] int16: count, C ascending
        offsets 0-padded, pad); rows whose true count exceeds C join
        the hasN fixup set, whose masks the exact native twin
        recomputes before selection."""
        C = fused2.CAND_LIST_C
        B = st["B"]
        W = st["O"] // 32
        lst = np.asarray(lst)
        cnt = lst[:, 0].astype(np.int32)
        mask = np.zeros((B, W), dtype=np.uint32)
        flat = mask.reshape(-1)
        rowbase = np.arange(B, dtype=np.int64) * W
        for c in range(C):
            k = lst[:, 1 + c].astype(np.int64) - 1
            v = k >= 0
            if not v.any():
                break
            kv = k[v]
            # one entry per row within a column -> distinct flat
            # indices, so the fancy-indexed |= is exact
            flat[rowbase[v] + (kv >> 5)] |= \
                np.uint32(1) << (kv & 31).astype(np.uint32)
        over = np.flatnonzero(cnt > C)
        if len(over):
            rows = st.get("hasN_rows")
            st["hasN_rows"] = over if rows is None or not len(rows) \
                else np.union1d(rows, over)
        return mask.view(np.int32)
