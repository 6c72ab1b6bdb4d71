"""Lazy builder and loader of the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled for ``sm_90a`` by
``torch.utils.cpp_extension.load`` into ``quattro_tpu_torch/_build/<name>/``
the first time a kernel of it is launched (or when ``build_all`` is called).
The sources have a plain C interface and include no PyTorch header, so each
builds in seconds; the shared library is bound with ``ctypes``. Headers
(``csrc/*.cuh``) are reached by ``#include`` relative to ``csrc/``. Nothing
here runs at import: the CPU test run collects without ``nvcc``.

``csrc/host_derivatives.cpp`` is the one host source: the same route builds
it with the host C++ compiler, so a CPU test can call the plant and cost
derivatives that the kernels share.

``launches`` counts kernel launches per kernel name. A wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its path went
through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17"]
HOST_FLAGS = ["-O2", "-std=c++17", "-Wno-unknown-pragmas"]  # the headers carry "#pragma unroll" for nvcc

launches: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    launches.clear()


def _compile(source: str) -> ctypes.CDLL:
    from torch.utils.cpp_extension import load

    build_dir = BUILD_DIR / source
    build_dir.mkdir(parents=True, exist_ok=True)
    kernel = CSRC / f"{source}.cu"
    path = load(
        name=f"qt_{source}",
        sources=[str(kernel if kernel.exists() else CSRC / f"{source}.cpp")],
        build_directory=str(build_dir),
        extra_cflags=HOST_FLAGS,
        extra_cuda_cflags=NVCC_FLAGS,
        is_python_module=False,
        verbose=False,
    )
    return ctypes.CDLL(path)


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>.cu`` (or ``.cpp``), built on first use."""
    with _lock:
        lib = _libs.get(source)
    if lib is None:
        lib = _compile(source)
        with _lock:
            lib = _libs.setdefault(source, lib)
    return lib


def build_all(sources: Iterable[str]) -> Dict[str, float]:
    """Build several sources at once (one ``nvcc`` each); returns seconds per source."""

    def timed(source):
        start = time.perf_counter()
        library(source)
        return time.perf_counter() - start

    sources = list(sources)
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        seconds = list(pool.map(timed, sources))
    return dict(zip(sources, seconds))


def check(status: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch never runs)."""
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA error {status} at launch")
