"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain C
interface, under ``build/mmfn_tpu_torch/`` at the root of the checkout, named
by the hash of its sources so an edited kernel is rebuilt. At the first CUDA
launch every source compiles at once, one ``nvcc`` process each, all started
together. Libraries load with ``ctypes``; pointers and the stream pass as
``c_void_p``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "mmfn_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of mmfn_tpu_torch "
                           "need the CUDA toolkit")
    return path


def _library_path(source: str) -> str:
    digest = hashlib.sha256()
    for path in [source] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build_all() -> Dict[str, dict]:
    """Compile every ``csrc/*.cu`` that has no current library, in parallel.

    Returns ``{source name: {"library", "seconds", "log"}}``; ``log`` holds
    ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills) and
    ``seconds`` is 0.0 for a library that was already built. Raises with the
    compiler's output when a build fails.
    """
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        report, procs = {}, {}
        for source in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))):
            name = os.path.basename(source)
            lib = _library_path(source)
            if os.path.exists(lib):
                report[name] = {"library": lib, "seconds": 0.0, "log": ""}
                continue
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           lib, tmp, time.perf_counter())
        failures = []
        for name, (proc, lib, tmp, t0) in procs.items():
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                failures.append(f"{name}:\n{log}")
                continue
            os.replace(tmp, lib)
            report[name] = {"library": lib, "seconds": seconds, "log": log}
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        return report


class CudaKernel:
    """One kernel library's C entry point, built on first use.

    ``launches`` counts the successful calls of :meth:`launch`: the wrapper
    of each kernel calls it exactly where it launches the kernel.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = os.path.join(CSRC_DIR, source)
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._error_string = None

    def _load(self) -> None:
        build_all()
        lib = ctypes.CDLL(_library_path(self.source))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.mmfn_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._error_string = fn, err

    def launch(self, *args) -> None:
        if self._fn is None:
            self._load()
        code = self._fn(*args)
        if code != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {code} "
                               f"({self._error_string(code).decode()})")
        self.launches += 1


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda_tensor(name: str, t: torch.Tensor, dtypes, ndim: int,
                      align: int = 16) -> None:
    """Reject what a kernel cannot take: wrong device, type, rank, a
    non-contiguous layout, or a base address the kernel's vector loads
    cannot read."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")
