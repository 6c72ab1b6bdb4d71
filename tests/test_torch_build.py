"""ops/_build.py's binding and launch helpers, on the CPU.

``bind`` is held on the host-built library of ``csrc/host_derivatives.cpp``
(g++ and ninja, as ``tests/test_torch_device_functions.py`` builds it): the
same ctypes function comes back on every call, with the prototype of the
first. ``launch`` is held with a recording stand-in for the C function and
for the CUDA runtime calls it makes: the current stream goes last, the device
is entered only when it is not the current one, an error status raises and
counts no launch.
"""

import contextlib
import ctypes
import shutil

import numpy as np
import pytest
import torch

from quattro_tpu_torch.ops import _build

DOUBLE_P = ctypes.POINTER(ctypes.c_double)
STEP_ARGTYPES = [ctypes.c_int, DOUBLE_P, ctypes.c_int, ctypes.c_double] + [DOUBLE_P] * 5


@pytest.fixture
def host_library():
    if not any(shutil.which(cc) for cc in ("c++", "g++", "clang++")) or shutil.which("ninja") is None:
        pytest.skip("needs a host C++ compiler and ninja to build csrc/host_derivatives.cpp")
    return _build.library("host_derivatives")


def test_bind_returns_one_function_with_the_first_prototype(host_library, monkeypatch):
    monkeypatch.setattr(_build, "_fns", {})
    fn = _build.bind("host_derivatives", "qt_host_step_and_jacobian", ctypes.c_int, STEP_ARGTYPES)
    assert fn.restype is ctypes.c_int and list(fn.argtypes) == STEP_ARGTYPES
    again = _build.bind("host_derivatives", "qt_host_step_and_jacobian", ctypes.c_double, [ctypes.c_int])
    assert again is fn
    assert fn.restype is ctypes.c_int and list(fn.argtypes) == STEP_ARGTYPES  # set once, not again
    z = np.zeros(16)
    p = z.ctypes.data_as(DOUBLE_P)
    assert fn(7, p, 1, 0.01, p, p, p, p, p) == 1  # an unknown plant id is refused through the bound prototype
    other = _build.bind("host_derivatives", "qt_host_cost_and_expansion", ctypes.c_int, [ctypes.c_int])
    assert other is not fn


class _Recorder:
    def __init__(self, status=0):
        self.status, self.calls = status, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.status


@pytest.fixture
def fake_cuda(monkeypatch):
    """torch's CUDA runtime calls as the launch helper makes them: current device 0, stream 1000 + index."""
    entered = []

    @contextlib.contextmanager
    def device(dev):
        entered.append(dev)
        yield

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1000 + index, raising=False)
    _build.reset_launches()
    yield entered
    _build.reset_launches()


@pytest.mark.parametrize("device", [torch.device("cuda"), torch.device("cuda:0"), 0], ids=["cuda", "cuda:0", "index"])
def test_launch_on_the_current_device_passes_its_stream_last(fake_cuda, device):
    fn = _Recorder()
    _build.launch("k", fn, device, 3, 4.5, None)
    assert fn.calls == [(3, 4.5, None, 1000)]
    assert fake_cuda == []  # the current device is not entered
    assert dict(_build.launches) == {"k": 1}


@pytest.mark.parametrize("device", [torch.device("cuda:1"), 1], ids=["cuda:1", "index"])
def test_launch_enters_another_device(fake_cuda, device):
    fn = _Recorder()
    _build.launch("k", fn, device, 7)
    assert fn.calls == [(7, 1001)]
    assert fake_cuda == [1]
    assert dict(_build.launches) == {"k": 1}


def test_launch_raises_on_a_cuda_error_and_counts_nothing(fake_cuda):
    with pytest.raises(RuntimeError, match="k: CUDA error 1 at launch"):
        _build.launch("k", _Recorder(status=1), torch.device("cuda:0"))
    assert sum(_build.launches.values()) == 0
