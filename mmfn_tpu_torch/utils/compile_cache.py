"""Build the port's CUDA kernels ahead of the first timed call.

The counterpart of the JAX package's ``utils/compile_cache.py``, which points
XLA's persistent compilation cache at a directory so that re-runs start warm.
Here the compiled artefacts are the kernel libraries of ``csrc/*.cu``:
``ops/_cuda.build_all`` compiles each source that has no current library
into ``build/mmfn_tpu_torch/`` (named by the hash of its sources, so an
edited kernel is rebuilt and an unchanged one is reused across runs). The
CLIs call :func:`enable_persistent_cache` at start, so that ``nvcc`` runs
before any timed or watchdog-guarded loop rather than inside its first tick.
"""

from __future__ import annotations

import torch


def enable_persistent_cache() -> bool:
    """Build every kernel library that is missing (CUDA machines only).

    Returns True when the kernels are built, False on a machine without
    CUDA. Safe to call more than once: a second call compiles nothing."""
    if not torch.cuda.is_available():
        return False
    from mmfn_tpu_torch.ops import _cuda

    _cuda.build_all()
    return True
