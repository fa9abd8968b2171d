"""Where the port writes what it builds and caches: the CUDA kernels'
library (ops/_build.py), the native host library (io/native.py) and the
engine probe's cache (runtime.py)."""

from __future__ import annotations

import os

PKG = os.path.dirname(os.path.abspath(__file__))


def build_root() -> str:
    """The directory the port builds and caches into, in this order:
    ``PANDASEQ_TPU_CACHE`` when set; ``build/`` beside the package when
    the package lies in a checkout (``pyproject.toml`` beside it); else
    ``~/.cache/pandaseq_tpu_torch`` (an installed package, whose own
    directory may not be writable)."""
    env = os.environ.get("PANDASEQ_TPU_CACHE")
    if env:
        return env
    parent = os.path.dirname(PKG)
    if os.path.exists(os.path.join(parent, "pyproject.toml")):
        return os.path.join(parent, "build")
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "pandaseq_tpu_torch")
