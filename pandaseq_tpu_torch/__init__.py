"""pandaseq_tpu_torch: the PyTorch / CUDA port of pandaseq_tpu.

The same paired-end read merger (PANDAseq-compatible, byte-identical
output), with the device steps in hand-written CUDA kernels for NVIDIA
Hopper (ops/cand.py, ops/dense.py; the default merge path's candidate
search is one sort-join kernel, cand_join) and plain PyTorch versions
for the CPU (ops/fused2.py). The host modules (native
decoder and finalizer bindings, oracle, filters, I/O, tables) and the
C++ host engine they build (native/psq_io.cpp) are the port's own copies
of ``pandaseq_tpu``'s; this package imports neither JAX nor
``pandaseq_tpu``. Its builds go under ``_paths.build_root()``.

Quick start::

    import pandaseq_tpu_torch as pt
    asm = pt.Assembler(device="cuda")
    for result in asm.stream("forward.fastq", "reverse.fastq"):
        print(result.sid, result.sequence_length)

CLI: ``python -m pandaseq_tpu_torch`` (``pandaseq-tpu-torch``), flag-
compatible with ``pandaseq``; ``PANDASEQ_TORCH_DEVICE=cuda|cpu``.
"""

__version__ = "1.0.0"


def __getattr__(name):
    # lazy exports so `import pandaseq_tpu_torch` does not import torch
    if name == "Assembler":
        from .api import Assembler
        return Assembler
    if name == "OracleConfig":
        from .oracle import OracleConfig
        return OracleConfig
    if name == "make_algorithm":
        from .oracle import make_algorithm
        return make_algorithm
    if name == "IdSet":
        from .idset import IdSet
        return IdSet
    raise AttributeError(name)
