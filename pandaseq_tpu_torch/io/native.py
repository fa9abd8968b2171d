"""ctypes bindings for the native C++ paired-FASTQ decoder
(pandaseq_tpu_torch/native/psq_io.cpp), with lazy on-demand compilation.

Yields `assembler.Batch` objects (already padded [B, L] tensors) so the
hot path never materializes per-read Python objects; per-pair views are
created lazily only for module prechecks / oracle fallbacks.

The PyTorch port's copy of ``pandaseq_tpu/io/native.py``, unchanged but for its
imports, its source and where the library goes: it compiles the port's own
copy of the host engine, ``pandaseq_tpu_torch/native/psq_io.cpp`` (shipped
with the package), into ``native/`` under ``_paths.build_root()`` (``build/``
in a checkout, ``~/.cache/pandaseq_tpu_torch`` once installed), under a
per-process temporary name, so that processes that build at once do not
write one file; when it cannot, ``build_error`` says why. The port imports
nothing of ``pandaseq_tpu``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from .._paths import PKG, build_root

# The pipeline calls OpenMP regions from several pthreads (decoder on
# the prefetch thread, finalize on its worker, pack4/pear_test on the
# main thread); libgomp keeps one thread pool PER calling pthread and
# its default wait policy spin-waits between regions, so the idle pools
# burn whole cores against the active one. Passive waiting removes the
# burn (measured ~5x on the concurrent decode+finalize pipeline).
# Must be set before libgomp initializes — i.e. before the .so loads.
os.environ.setdefault("OMP_WAIT_POLICY", "passive")
os.environ.setdefault("GOMP_SPINCOUNT", "0")

_SRC = os.path.join(PKG, "native", "psq_io.cpp")

MAX_LEN = 450

ERROR_CODES = {0: None, 1: "EOF", 2: "BADID", 3: "NOTPAIRED", 4: "BADNT",
               5: "BADSEQ", 6: "READLEN", 7: "NOQUAL"}

_lib = None
build_error = None  # why the last build() gave no library, or None


def _find_bz2():
    for p in ("/usr/lib/x86_64-linux-gnu/libbz2.so.1", "/usr/lib/libbz2.so",
              "/usr/lib64/libbz2.so.1"):
        if os.path.exists(p):
            return p
    return "-lbz2"


def build(force: bool = False) -> str | None:
    """Compile the native decoder if needed; returns .so path or None.

    The output name carries a source-content hash: a rebuild writes a
    NEW file instead of truncating the old one in place, so a process
    that still has the previous build dlopen'd keeps valid mappings
    (an in-place `g++ -o` rewrite corrupts the old mapping and
    segfaults any live caller), and a reload dlopens a fresh inode.
    When it returns None, ``build_error`` names the cause: the missing
    source, g++'s stderr, or the error of the directory or compiler."""
    global build_error
    build_error = None
    if not os.path.exists(_SRC):
        build_error = "its source %s is missing" % _SRC
        return None
    import hashlib
    with open(_SRC, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:12]
    sodir = os.path.join(build_root(), "native")
    so = os.path.join(sodir, f"_psq_io-{tag}.so")
    if not force and os.path.exists(so):
        return so
    tmp = "%s.%d.tmp" % (so, os.getpid())
    cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp, _SRC, "-lz", _find_bz2()]
    try:
        os.makedirs(sodir, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    except subprocess.CalledProcessError as e:
        build_error = "g++ failed on %s:\n%s" % (
            _SRC, e.stderr.decode(errors="replace").strip())
        return None
    except OSError as e:  # no g++, or no writable build directory
        build_error = "building %s into %s: %s" % (_SRC, sodir, e)
        return None
    return so


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    so = build()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    lib.psq_open_pair.restype = ctypes.c_void_p
    lib.psq_open_pair.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_char_p]
    lib.psq_next_batch.restype = ctypes.c_long
    lib.psq_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.psq_compute_offsets.restype = None
    lib.psq_compute_offsets.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_long, ctypes.c_void_p, ctypes.c_long, ctypes.c_double,
        ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int]
    lib.psq_finalize.restype = ctypes.c_long
    lib.psq_finalize.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,                                     # skip
        ctypes.c_long, ctypes.c_long,                        # B, stride
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long,       # plane, W, SL
        ctypes.c_int,                                        # plane_kind
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_void_p,                    # ptbl, phtbl
        ctypes.c_int, ctypes.c_void_p, ctypes.c_long,        # fmt, ids
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,     # ascii,pidx,L2
        ctypes.c_void_p, ctypes.c_long,                      # payload
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]     # counters,hist
    lib.psq_cand_mask.restype = None
    lib.psq_cand_mask.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
        ctypes.c_long, ctypes.c_void_p, ctypes.c_int]
    lib.psq_pear_test.restype = None
    lib.psq_pear_test.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_void_p]
    lib.psq_emit.restype = ctypes.c_long
    lib.psq_emit.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_long]
    lib.psq_skip_batch.restype = ctypes.c_long
    lib.psq_skip_batch.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                   ctypes.c_void_p]
    lib.psq_stream_flags.restype = ctypes.c_int
    lib.psq_stream_flags.argtypes = [ctypes.c_void_p]
    lib.psq_close.argtypes = [ctypes.c_void_p]
    lib.psq_quality.restype = None
    lib.psq_quality.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                ctypes.c_long, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p]
    lib.psq_pack4.restype = None
    lib.psq_pack4.argtypes = [ctypes.c_void_p, ctypes.c_long,
                              ctypes.c_long, ctypes.c_long,
                              ctypes.c_void_p, ctypes.c_void_p]
    lib.psq_primer_align.restype = None
    lib.psq_primer_align.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_long,
                                     ctypes.c_long, ctypes.c_void_p,
                                     ctypes.c_long, ctypes.c_void_p]
    _lib = lib
    return lib


def pack4(batch, Lb: int):
    """([B, 2*Lb/4] 4-bit packed upload plane, hasN[B] bool) for the
    sparse candidate step without N planes (psq_pack4); None without
    the native library. Rows with hasN need cand_mask correction."""
    lib = get_lib()
    if lib is None:
        return None
    ntp = batch.nt_packed()
    B = ntp.shape[0]
    out = np.empty((B, 2 * Lb // 4), dtype=np.int8)
    hasN = np.empty(B, dtype=np.uint8)
    lib.psq_pack4(ntp.ctypes.data, B, ntp.shape[1], Lb,
                  out.ctypes.data, hasN.ctypes.data)
    return out, hasN.view(bool)


def cand_mask(batch, rows, num_kmers: int, O: int,
              faithful: bool = False):
    """Exact host candidate bitmask [len(rows), O//32] int32 for the
    given row indices (psq_cand_mask — the device search's host twin,
    used for N-containing rows under the 4-bit upload). faithful
    reproduces the reference's literal kmerseen table, including its
    misindexed occupancy check (assembler.c:94-99) — required for
    num_kmers >= 3, where the check reads other k-mers' slots."""
    lib = get_lib()
    if lib is None:
        return None
    assert not faithful or num_kmers >= 2, num_kmers
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    out = np.empty((len(rows), O // 32), dtype=np.int32)
    flen32 = np.ascontiguousarray(batch.flen, np.int32)
    rlen32 = np.ascontiguousarray(batch.rlen, np.int32)
    lib.psq_cand_mask(batch.fwd_nt.ctypes.data, batch.rev_nt.ctypes.data,
                      flen32.ctypes.data, rlen32.ctypes.data,
                      batch.fwd_nt.shape[1], rows.ctypes.data, len(rows),
                      int(num_kmers), O, out.ctypes.data,
                      1 if faithful else 0)
    return out


def primer_align(nt, probs, notprobs, primer):
    """Native ascending-order primer alignment sums; None w/o the lib."""
    lib = get_lib()
    if lib is None:
        return None
    nt = np.ascontiguousarray(nt, dtype=np.int8)
    probs = np.ascontiguousarray(probs, dtype=np.float64)
    notprobs = np.ascontiguousarray(notprobs, dtype=np.float64)
    primer = np.ascontiguousarray(primer, dtype=np.int8)
    B, S = nt.shape
    A = np.empty((B, S), dtype=np.float64)
    lib.psq_primer_align(nt.ctypes.data, probs.ctypes.data,
                         notprobs.ctypes.data, B, S, primer.ctypes.data,
                         len(primer), A.ctypes.data)
    return A


def quality(seq: np.ndarray, ptbl: np.ndarray,
            seq_len: np.ndarray) -> np.ndarray | None:
    """Exact mean quality via the native single-pass kernel; None when
    the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    seq = np.ascontiguousarray(seq, dtype=np.int32)
    seq_len32 = np.ascontiguousarray(seq_len, dtype=np.int32)
    B, L2 = seq.shape
    out = np.empty(B, dtype=np.float64)
    lib.psq_quality(seq.ctypes.data, B, L2, ptbl.ctypes.data,
                    seq_len32.ctypes.data, out.ctypes.data)
    return out


def compute_offsets(nt_rev, q_rev, lens, primer, threshold, penalty,
                    rev_scan: bool = False):
    """Native panda_compute_offset batch (offset.c:47-90) over REVERSED
    frames; returns int64 bestindex per read (0 = no primer found), or
    None when the native library is unavailable. rev_scan scans
    back-to-front (the pandaseq-hang overhang mode)."""
    lib = get_lib()
    if lib is None:
        return None
    from ..tables import QUAL_SCORE, QUAL_SCORE_ERR
    nt_rev = np.ascontiguousarray(nt_rev, dtype=np.int8)
    q_rev = np.ascontiguousarray(q_rev, dtype=np.int8)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    primer = np.ascontiguousarray(primer, dtype=np.int8)
    qs = np.ascontiguousarray(QUAL_SCORE, dtype=np.float64)
    qe = np.ascontiguousarray(QUAL_SCORE_ERR, dtype=np.float64)
    B, S = nt_rev.shape
    out = np.empty(B, dtype=np.int64)
    lib.psq_compute_offsets(
        nt_rev.ctypes.data, q_rev.ctypes.data, lens.ctypes.data, B, S,
        primer.ctypes.data, len(primer), float(threshold), float(penalty),
        qs.ctypes.data, qe.ctypes.data, out.ctypes.data,
        1 if rev_scan else 0)
    return out


def pear_test_check(T, o, mm, hi, alpha, beta, cutoff):
    """pear_test verdicts for compacted rows (plugin_pear_test.c:18-41):
    exact f64 ascending-i product over the caller's cumulative binomial
    table T (rows [min o, max hi) must be built). None when the native
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    T = np.ascontiguousarray(T, dtype=np.float64)
    o = np.ascontiguousarray(o, dtype=np.int64)
    mm = np.ascontiguousarray(mm, dtype=np.int64)
    hi = np.ascontiguousarray(hi, dtype=np.int64)
    out = np.empty(len(o), dtype=np.uint8)
    lib.psq_pear_test(T.ctypes.data, T.shape[1], o.ctypes.data,
                      mm.ctypes.data, hi.ctypes.data, len(o),
                      float(alpha), float(beta), float(cutoff),
                      out.ctypes.data)
    return out.view(bool)


def emit(ascii_arr, pidx_arr, seq_len, quality, emit_mask, ids, phtbl,
         fmt, payload_buf=None):
    """Payload bytes for the selected rows (psq_emit; output.c:85-126).
    None when the native library is unavailable. payload_buf: optional
    reusable output buffer (a fresh ~19 MB allocation per batch
    otherwise)."""
    lib = get_lib()
    if lib is None:
        return None
    B, L2cap = ascii_arr.shape
    sl32 = np.ascontiguousarray(seq_len, np.int32)
    q64 = np.ascontiguousarray(quality, np.float64)
    em8 = np.ascontiguousarray(emit_mask, np.uint8)
    cap = B * (ids.shape[1] + 2 * 928 + 64)
    if payload_buf is not None and payload_buf.nbytes >= cap:
        payload = payload_buf
    else:
        payload = np.empty(cap, dtype=np.uint8)
    n = lib.psq_emit(ascii_arr.ctypes.data, pidx_arr.ctypes.data,
                     sl32.ctypes.data, q64.ctypes.data, em8.ctypes.data,
                     B, L2cap, ids.ctypes.data, ids.shape[1],
                     phtbl.ctypes.data, int(fmt), payload.ctypes.data,
                     cap)
    if n < 0:
        raise RuntimeError("psq_emit payload overflow")
    return bytes(payload[:n])



def finalize(batch, skip, fo, ro, plane, SL, fb, algo_params, cfg_params,
             ptbl, phtbl, fmt, want_arrays=False, L2cap=928,
             payload_buf=None, plane_kind=0, arrays_buf=None):
    """One native pass: exact f64 selection from the device shortlist,
    reconstruction, quality, and (fmt 1=fasta / 2=fastq) payload bytes.
    Returns dict with codes/osc/quality/best/payload(+ascii/pidx).
    None when the native library is unavailable.

    arrays_buf: optional (ascii, pidx) planes to reuse across calls
    (22 MB/batch of fresh zeroing otherwise). Rows the per-pair body
    skips keep a previous batch's bytes, which is fine for callers
    that only read rows their own codes/sel masks select — the caller
    must consume ascii/pidx before its next finalize call with the
    same buffers."""
    lib = get_lib()
    if lib is None:
        return None
    B = len(batch.sids)
    stride = batch.fwd_nt.shape[1]
    plane = np.ascontiguousarray(plane, dtype=np.int32)
    W = plane.shape[1]
    fb_mask, fb_besto, fb_aligned, fb_best = fb
    codes = np.zeros(B, dtype=np.uint8)
    osc = np.zeros((B, 6), dtype=np.int32)
    oqual = np.zeros(B, dtype=np.float64)
    obest = np.zeros(B, dtype=np.float64)
    counters = np.zeros(8, dtype=np.int64)
    hist = np.zeros(1024, dtype=np.int64)
    if want_arrays:
        if arrays_buf is not None and arrays_buf[0].shape[0] >= B \
                and arrays_buf[0].shape[1] == L2cap:
            ascii_out, pidx_out = arrays_buf[0][:B], arrays_buf[1][:B]
        else:
            ascii_out = np.zeros((B, L2cap), dtype=np.uint8)
            pidx_out = np.zeros((B, L2cap), dtype=np.int16)
        a_ptr, p_ptr = ascii_out.ctypes.data, pidx_out.ctypes.data
    else:
        ascii_out = pidx_out = None
        a_ptr = p_ptr = None
    if fmt:
        cap = B * (ID_STRIDE + 2 * 928 + 64)
        if payload_buf is None or payload_buf.nbytes < cap:
            payload_buf = np.empty(cap, dtype=np.uint8)
    else:
        payload_buf = np.empty(1, dtype=np.uint8)
    ids = batch.ids_bytes()
    lm, lmm = algo_params["lut_m"], algo_params["lut_mm"]
    # keep every converted array alive in locals for the call duration
    # (.ctypes.data alone does NOT hold a reference)
    flen32 = np.ascontiguousarray(batch.flen, np.int32)
    rlen32 = np.ascontiguousarray(batch.rlen, np.int32)
    fo32 = np.ascontiguousarray(fo, np.int32)
    ro32 = np.ascontiguousarray(ro, np.int32)
    skip8 = np.ascontiguousarray(skip, np.uint8)
    fbm8 = np.ascontiguousarray(fb_mask, np.uint8)
    fbo32 = np.ascontiguousarray(fb_besto, np.int32)
    fba8 = np.ascontiguousarray(fb_aligned, np.uint8)
    fbb64 = np.ascontiguousarray(fb_best, np.float64)
    n = lib.psq_finalize(
        batch.fwd_nt.ctypes.data, batch.fwd_q.ctypes.data,
        batch.rev_nt.ctypes.data, batch.rev_q.ctypes.data,
        flen32.ctypes.data, rlen32.ctypes.data,
        fo32.ctypes.data, ro32.ctypes.data,
        skip8.ctypes.data,
        B, stride, plane.ctypes.data, W, SL, int(plane_kind),
        fbm8.ctypes.data, fbo32.ctypes.data,
        fba8.ctypes.data, fbb64.ctypes.data,
        int(algo_params["algo_id"]), float(algo_params["pmatch"]),
        float(algo_params["pmismatch"]), float(algo_params["qual_nn"]),
        float(algo_params["nn_term"]),
        lm.ctypes.data if lm is not None else None,
        lmm.ctypes.data if lmm is not None else None,
        int(cfg_params["minoverlap"]), int(cfg_params["maxoverlap"]),
        float(cfg_params["threshold"]),
        ptbl.ctypes.data, phtbl.ctypes.data,
        int(fmt), ids.ctypes.data, ids.shape[1],
        codes.ctypes.data, osc.ctypes.data, oqual.ctypes.data,
        obest.ctypes.data, a_ptr, p_ptr, L2cap,
        payload_buf.ctypes.data, payload_buf.nbytes,
        counters.ctypes.data, hist.ctypes.data, 1024)
    if n < 0:
        raise RuntimeError("psq_finalize payload overflow")
    return dict(codes=codes, osc=osc, quality=oqual, best=obest,
                payload=bytes(payload_buf[:n]) if fmt else b"",
                counters=counters, hist=hist, ascii=ascii_out,
                pidx=pidx_out)


class IdStr(str):
    """Canonical id string that quacks like SeqId where modules need it."""

    __slots__ = ()

    @property
    def tag(self):
        return self.rsplit(":", 1)[1]


def _derev(row, n):
    """Raw-order view of a REVERSED frame row: bases 0..n-1 reversed,
    tail (stale persistent-buffer bytes / zeros) kept in place."""
    out = np.empty_like(row)
    out[:n] = row[:n][::-1]
    out[n:] = row[n:]
    return out


class _PairView:
    """Lazy per-pair RAW-ORDER view over (reversed-frame) batch rows —
    for prechecks / oracle fallback / fail output."""

    __slots__ = ("_b", "_i")

    def __init__(self, b, i):
        self._b = b
        self._i = i

    @property
    def sid(self):
        return self._b.sids[self._i]

    @property
    def fwd_nt(self):
        return _derev(self._b.fwd_nt[self._i], self.flen)

    @property
    def fwd_q(self):
        return _derev(self._b.fwd_q[self._i], self.flen)

    @property
    def rev_nt(self):
        return _derev(self._b.rev_nt[self._i], self.rlen)

    @property
    def rev_q(self):
        return _derev(self._b.rev_q[self._i], self.rlen)

    @property
    def flen(self):
        return int(self._b.flen[self._i])

    @property
    def rlen(self):
        return int(self._b.rlen[self._i])


class _LazyViews:
    __slots__ = ("_b",)

    def __init__(self, b):
        self._b = b

    def __getitem__(self, i):
        return _PairView(self._b, i)

    def __len__(self):
        return len(self._b.sids)

    def __iter__(self):
        for i in range(len(self)):
            yield _PairView(self._b, i)


class _LazyIds:
    """List-like view over the decoder's raw id-bytes buffer that
    materializes IdStr objects on first access. The emit fast path
    consumes ids as raw bytes (ids_bytes -> psq_emit) and touches
    Python id strings only for rare records (LOWQ logging, debug
    streams), so eagerly decoding ~1 us/pair of strings per batch
    would be pure overhead."""

    __slots__ = ("_buf", "_cache")

    def __init__(self, buf):
        self._buf = buf
        self._cache = {}

    def __len__(self):
        return len(self._buf)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        v = self._cache.get(i)
        if v is None:
            row = self._buf[i]
            v = IdStr(row.tobytes().split(b"\0", 1)[0].decode())
            self._cache[i] = v
        return v

    def __iter__(self):
        for i in range(len(self._buf)):
            yield self[i]


POLICY_MAP = {"OPTIONAL": 0, "ABSENT": 1, "PRESENT": 2}
ID_STRIDE = 416


class NativeBatchReader:
    """Streams `assembler.Batch` objects of up to `batch` pairs."""

    def __init__(self, fwd_path: str, rev_path: str, qualmin: int = 33,
                 policy: str = "PRESENT", batch: int = 1024, L: int = 512,
                 index_path: str | None = None, ring: int = 0):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native decoder unavailable")
        self.lib = lib
        self.batch = batch
        self.L = L
        # ring > 0: cycle through `ring` persistent buffer sets instead
        # of fresh allocations (~21 MB/batch of first-touch page faults
        # shows up INSIDE the decode wall time otherwise). A batch's
        # planes are then only valid until `ring - 1` further batches
        # have been pulled — use from pipelines with bounded depth
        # (emit_stream/assemble_stream windows), not from collectors
        # that hold batches indefinitely.
        self._ring_n = ring
        self._ring = []
        self._ring_i = 0
        self.error = None
        self.seen_under_64 = False
        self.non_empty = False
        if index_path is not None:
            policy = "OPTIONAL"  # index mode forces it (fastq.c:231)
        self.h = lib.psq_open_pair(fwd_path.encode(), rev_path.encode(),
                                   qualmin, POLICY_MAP[policy],
                                   index_path.encode() if index_path
                                   else None)
        if not self.h:
            raise OSError("cannot open %s / %s" % (fwd_path, rev_path))

    def __iter__(self):
        return self

    def __next__(self):
        from ..assembler import Batch
        if self.h is None:
            raise StopIteration
        B, L = self.batch, self.L
        # np.empty, not np.zeros: the decoder writes every byte of the
        # first n rows (row tails are memset, ids are nul-terminated)
        # and rows >= n are sliced away below, so the 21 MB of eager
        # zeroing would be pure memory traffic
        if self._ring_n:
            if len(self._ring) < self._ring_n:
                self._ring.append(tuple(
                    np.empty(s, dtype=d) for s, d in (
                        ((B, L), np.int8), ((B, L), np.int8),
                        ((B, L), np.int8), ((B, L), np.int8),
                        (B, np.int32), (B, np.int32),
                        ((B, ID_STRIDE), np.uint8), ((B, L), np.int8))))
                bufs = self._ring[-1]
            else:
                bufs = self._ring[self._ring_i % self._ring_n]
            self._ring_i += 1
            (fwd_nt, fwd_q, rev_nt, rev_q, flen, rlen, ids,
             nt_pack) = bufs
        else:
            fwd_nt = np.empty((B, L), dtype=np.int8)
            fwd_q = np.empty((B, L), dtype=np.int8)
            rev_nt = np.empty((B, L), dtype=np.int8)
            rev_q = np.empty((B, L), dtype=np.int8)
            flen = np.empty(B, dtype=np.int32)
            rlen = np.empty(B, dtype=np.int32)
            ids = np.empty((B, ID_STRIDE), dtype=np.uint8)
            nt_pack = np.empty((B, L), dtype=np.int8)
        err = ctypes.c_int32(0)
        n = self.lib.psq_next_batch(
            self.h, B, L,
            fwd_nt.ctypes.data, fwd_q.ctypes.data, rev_nt.ctypes.data,
            rev_q.ctypes.data, flen.ctypes.data, rlen.ctypes.data,
            ids.ctypes.data, ID_STRIDE, ctypes.byref(err), 1,
            nt_pack.ctypes.data)
        flags = self.lib.psq_stream_flags(self.h)
        self.seen_under_64 = bool(flags & 1)
        self.non_empty = bool(flags & 2)
        if err.value:
            self.error = ERROR_CODES.get(err.value, "UNKNOWN")
        if n == 0:
            self.close()
            raise StopIteration
        if n < B:
            fwd_nt, fwd_q = fwd_nt[:n], fwd_q[:n]
            rev_nt, rev_q = rev_nt[:n], rev_q[:n]
            flen, rlen = flen[:n], rlen[:n]
            ids = ids[:n]
            nt_pack = nt_pack[:n]
        b = Batch(_LazyIds(ids), fwd_nt, fwd_q, rev_nt, rev_q, flen,
                  rlen, None)
        b.pairs = _LazyViews(b)
        b._ids_buf = ids
        b._nt_pack = nt_pack
        if self._ring_n:
            # overrun tripwire: the consumer (BatchAssembler._finalize)
            # asserts the ring hasn't lapped this batch's buffers while
            # they were still in use — an undersized ring otherwise
            # corrupts output SILENTLY (stale planes score as plausible
            # reads)
            b._ring_gen = self._ring_i
            b._ring_src = self
        return b

    def skip_batch(self) -> int:
        """Advance the stream by one batch's worth of emitted records
        without decoding any rows (psq_skip_batch — the mux decode-skip
        for batches another host claimed; mux.c:132-161 serializes only
        the hand-off, never the parse). Returns the emitted-record
        count a full decode would have produced (0 = EOF/error; check
        .error). Stream errors, the seen_under_64/non_empty flags and
        the persistent quality buffers (stale-tail PEAR quirk) advance
        exactly as a full decode would, so a later CLAIMED batch's
        planes are bit-identical to the decode-everything layout."""
        if self.h is None:
            return 0
        err = ctypes.c_int32(0)
        n = self.lib.psq_skip_batch(self.h, self.batch, ctypes.byref(err))
        flags = self.lib.psq_stream_flags(self.h)
        self.seen_under_64 = bool(flags & 1)
        self.non_empty = bool(flags & 2)
        if err.value:
            self.error = ERROR_CODES.get(err.value, "UNKNOWN")
        if n == 0:
            self.close()
        return int(n)

    def close(self):
        if self.h is not None:
            self.lib.psq_close(self.h)
            self.h = None

    def __del__(self):
        # abandoned readers (e.g. a cancelled prefetch wrapping an
        # aborted bench window) must release the native stream handle
        try:
            self.close()
        except Exception:
            pass
