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

``bind`` hands a wrapper its C entry point with the prototype set once;
``launch`` calls it on the tensors' current stream, raises if it reports an
error, and counts the launch. ``launches`` counts kernel launches per kernel
name: a wrapper adds one where it launches its kernel (through ``launch``) and
nowhere else, so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Iterable, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17"]
HOST_FLAGS = ["-O2", "-std=c++17", "-Wno-unknown-pragmas"]  # the headers carry "#pragma unroll" for nvcc

launches: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], Any] = {}
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


def bind(source: str, symbol: str, restype: Any, argtypes: Sequence[Any]) -> Any:
    """The C function ``symbol`` of ``csrc/<source>``, its prototype set on the first call only.

    Later calls return the same ctypes function from a cache, so a wrapper
    pays one dictionary lookup per launch.
    """
    fn = _fns.get((source, symbol))
    if fn is None:
        fn = getattr(library(source), symbol)
        fn.restype = restype
        fn.argtypes = list(argtypes)
        with _lock:
            fn = _fns.setdefault((source, symbol), fn)
    return fn


def launch(kernel: str, fn: Any, device: Any, *args: Any) -> None:
    """Call C entry point ``fn(*args, stream)`` on ``device``'s current stream and count one launch of ``kernel``.

    ``device`` is a ``torch.device`` or a device index (``Tensor.get_device()``,
    the cheaper of the two). The device is entered only when it is not already
    the current one. Raises if the entry point reports a CUDA error.
    """
    index = device if isinstance(device, int) else device.index
    current = torch._C._cuda_getDevice()
    if index is None or index == current:
        status = fn(*args, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(index):
            status = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if status != 0:  # a refused launch never runs
        raise RuntimeError(f"{kernel}: CUDA error {status} at launch")
    launches[kernel] += 1


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
