"""Scoring-algorithm registry (algo.c / pandaseq-algorithm.h).

The reference registers algorithm classes in a sorted global array
(algo.c:106-133); ``-A name:params`` resolves by name. This module is
the user-facing registry: the seven built-ins plus
:func:`register_algorithm` for custom ones (the ``algo_example.c``
template, natively).

A custom algorithm subclasses :class:`Algorithm` and provides:

  * ``name``                   — registry key
  * ``overlap_probability(fwd_nt, fwd_q, flen, rev_nt, rev_q, rlen,
    overlap) -> float``        — log-probability of one overlap
  * ``match_probability(match, qa, qb) -> float``
                               — reconstruction base quality
  * ``prob_unpaired``          — the floor constant

Custom algorithms run through the exact host path (the oracle); the
seven built-ins additionally have batched device kernels (ops/fused2.py).

Example (the algo_example.c skeleton)::

    import math
    from pandaseq_tpu_torch.algorithms import Algorithm, register_algorithm

    class Example(Algorithm):
        name = "example"
        def __init__(self, arg=None):
            self.penalty = float(arg) if arg else 1.0
        def overlap_probability(self, fwd_nt, fwd_q, flen,
                                rev_nt, rev_q, rlen, overlap):
            return -self.penalty * overlap
        def match_probability(self, match, qa, qb):
            return 0.0 if match else -self.penalty

    register_algorithm("example", Example)

The PyTorch port's copy of ``pandaseq_tpu/algorithms.py``, unchanged but for its
imports; the port imports nothing of ``pandaseq_tpu``.
"""

from __future__ import annotations

from .oracle import (Algorithm, EaUtil, Flash, Pear, RdpMle, SimpleBayes,
                     Stitch, Uparse)
from .oracle import make_algorithm as _builtin_make

__all__ = ["Algorithm", "SimpleBayes", "Pear", "RdpMle", "Uparse",
           "EaUtil", "Flash", "Stitch", "register_algorithm",
           "make_algorithm", "list_algorithms"]

_CUSTOM: dict[str, type] = {}

BUILTINS = ("ea_util", "flash", "pear", "rdp_mle", "simple_bayesian",
            "stitch", "uparse")


def register_algorithm(name: str, cls: type) -> None:
    """panda_algorithm_register (algo.c:106): add a custom algorithm
    class; its constructor receives the ``-A name:arg`` argument."""
    _CUSTOM[name] = cls


def make_algorithm(name: str, arg: str | None = None) -> Algorithm:
    """Resolve ``-A name[:params]`` against customs then built-ins."""
    if name in _CUSTOM:
        return _CUSTOM[name](arg) if arg else _CUSTOM[name]()
    return _builtin_make(name, arg)


def list_algorithms():
    """Sorted registry listing (args.c:226-236 help output)."""
    return sorted(set(BUILTINS) | set(_CUSTOM))
