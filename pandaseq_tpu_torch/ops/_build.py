"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source compiles with ``nvcc`` for ``sm_90a`` into an object, all of
them at once, in parallel processes; the objects link into one shared
library with a plain C interface, loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds. The build happens at first use, from
the package's own sources, into ``build/kernels/`` beside the package.
The library's name carries a hash of the flags and of every file under
``csrc/`` (the sources and the headers they share, ``join.cuh``); it is
written to a temporary file and renamed, so a rebuild never rewrites a
library that a running process has loaded (as
``io/native.py`` does for the host library). ``nvcc``'s
``-Xptxas -v`` report (registers, shared memory, spills per kernel) is
kept beside the library as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("cand_join.cu", "counts.cu", "shortlist.cu", "lut_sums.cu")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build")
BUILD_DIR = os.path.join(BUILD_ROOT, "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for path in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source and need the CUDA toolkit (CUDA_HOME)")


def build() -> str:
    """Compile the kernels if this source version is not built yet;
    returns the library's path. Raises when nvcc fails."""
    srcs = [os.path.join(_CSRC, s) for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(_CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(_CSRC, name), "rb") as fh:
                h.update(fh.read())
    so = os.path.join(BUILD_DIR, f"libpsq_cuda-{h.hexdigest()[:12]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{so}.{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", s, "-o", o],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        failed = [s for s, p in zip(SOURCES, procs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed on %s:\n%s"
                               % (", ".join(failed), "".join(logs)))
        link = subprocess.run([nvcc, "-shared", "-o", tmp + ".tmp", *objs],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + link.stdout
                               + link.stderr)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    with open(so + ".log", "w") as fh:
        fh.write("".join(logs))
    os.replace(tmp + ".tmp", so)
    return so


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
            F = ctypes.c_float
            sigs = {
                "psq_cuda_cand_join": [P, P, P, L, I, I, I, I, I, P, P],
                "psq_cuda_cand_join_nt": [P, P, P, L, I, I, I, I, I, P, P],
                "psq_cuda_counts": [P, P, P, L, I, I, I, I, I, I, I, P, P,
                                    P, P],
                "psq_cuda_shortlist": [P, P, P, P, P, P, P, P, L, I, I, I,
                                       I, I, F, F, F, F, P, P],
                "psq_cuda_lut_sums": [P, P, P, P, P, L, I, I, I, P, P, F,
                                      I, I, P, P],
            }
            for name, argtypes in sigs.items():
                fn = getattr(lib, name)
                fn.restype = I
                fn.argtypes = argtypes
            lib.psq_cuda_error_string.restype = ctypes.c_char_p
            lib.psq_cuda_error_string.argtypes = [I]
            _lib = lib
        return _lib
