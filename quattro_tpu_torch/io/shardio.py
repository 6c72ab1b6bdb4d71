"""Trajectory-log shard IO: native (C++) framing/CRC/merge + numpy payloads.

Counterpart of ``quattro_tpu/io/shardio.py``, with the same file format
(``QTSHRD01``) bit for bit, so a shard written by either package reads in the
other:

- **Framing, CRC32 validation, scanning and merging** run in C++
  (``shardio.cpp``, built on demand with ``g++`` into
  ``quattro_tpu_torch/_build/shardio/`` and loaded via ctypes).
- **Payloads** are flat dicts of named numpy arrays, encoded with a small
  self-describing layout and read back zero-copy from an ``mmap``.
- A **pure-Python backend** (same byte format, ``zlib.crc32``) keeps the
  package usable without a compiler; the environment variable
  ``QUATTRO_TPU_TORCH_PURE_PYTHON_IO`` selects it. The two interoperate bit
  for bit. This is host IO: no device is involved on either backend.

A crashed writer loses at most its trailing partial record: the scanner
stops at the first invalid frame.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import struct
import subprocess
import zlib
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

_FILE_MAGIC = b"QTSHRD01"
_RECORD_MAGIC = 0x51545231  # 'QTR1'
_HEADER = struct.Struct("<IQI")  # rmagic, payload_len, crc32

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG_DIR, "shardio.cpp")
_LIB_NAME = "libqtshardio.so"
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "_build", "shardio")
PURE_PYTHON_ENV = "QUATTRO_TPU_TORCH_PURE_PYTHON_IO"


# ---------------------------------------------------------------------------
# Native library build + load
# ---------------------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _build_native() -> Optional[str]:
    """Compile shardio.cpp into a cached .so; return its path or None."""
    lib_path = os.path.join(_BUILD_DIR, _LIB_NAME)
    if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= os.path.getmtime(_SRC):
        return lib_path
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = lib_path + f".tmp{os.getpid()}"
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, lib_path)  # atomic against concurrent builds
        return lib_path
    except (OSError, subprocess.SubprocessError):
        return None


def _load_native() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if os.environ.get(PURE_PYTHON_ENV):
        return None
    path = _build_native()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.qtshard_writer_open.restype = ctypes.c_void_p
    lib.qtshard_writer_open.argtypes = [ctypes.c_char_p]
    lib.qtshard_writer_append.restype = ctypes.c_int
    lib.qtshard_writer_append.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.qtshard_writer_flush.restype = ctypes.c_int
    lib.qtshard_writer_flush.argtypes = [ctypes.c_void_p]
    lib.qtshard_writer_close.restype = ctypes.c_int
    lib.qtshard_writer_close.argtypes = [ctypes.c_void_p]
    lib.qtshard_index.restype = ctypes.c_int
    lib.qtshard_index.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.qtshard_free.restype = None
    lib.qtshard_free.argtypes = [ctypes.c_void_p]
    lib.qtshard_merge.restype = ctypes.c_int64
    lib.qtshard_merge.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    _lib = lib
    return _lib


def native_available() -> bool:
    """True when the C++ shard IO library is built and loaded."""
    return _load_native() is not None


# ---------------------------------------------------------------------------
# Payload encoding: dict[str, ndarray] <-> bytes
#   u32 n_arrays, then per array:
#   u16 name_len | name utf8 | u8 dtype_len | dtype str | u8 ndim |
#   u64 dims[ndim] | raw C-contiguous data
# ---------------------------------------------------------------------------


def encode_payload(arrays: Dict[str, np.ndarray]) -> bytes:
    parts = [struct.pack("<I", len(arrays))]
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        name_b = name.encode("utf-8")
        dt_b = arr.dtype.str.encode("ascii")  # e.g. '<f8' — endianness explicit
        parts.append(struct.pack("<H", len(name_b)))
        parts.append(name_b)
        parts.append(struct.pack("<B", len(dt_b)))
        parts.append(dt_b)
        parts.append(struct.pack("<B", arr.ndim))
        parts.append(struct.pack(f"<{arr.ndim}Q", *arr.shape) if arr.ndim else b"")
        parts.append(arr.tobytes())
    return b"".join(parts)


def decode_payload(buf: memoryview) -> Dict[str, np.ndarray]:
    """Decode a payload; arrays are zero-copy views into ``buf``."""
    out: Dict[str, np.ndarray] = {}
    (n,) = struct.unpack_from("<I", buf, 0)
    pos = 4
    for _ in range(n):
        (name_len,) = struct.unpack_from("<H", buf, pos); pos += 2
        name = bytes(buf[pos:pos + name_len]).decode("utf-8"); pos += name_len
        (dt_len,) = struct.unpack_from("<B", buf, pos); pos += 1
        dtype = np.dtype(bytes(buf[pos:pos + dt_len]).decode("ascii")); pos += dt_len
        (ndim,) = struct.unpack_from("<B", buf, pos); pos += 1
        shape = struct.unpack_from(f"<{ndim}Q", buf, pos) if ndim else ()
        pos += 8 * ndim
        count = int(np.prod(shape, dtype=np.int64)) if ndim else 1
        out[name] = np.frombuffer(buf, dtype=dtype, count=count, offset=pos).reshape(shape)
        pos += count * dtype.itemsize
    return out


# ---------------------------------------------------------------------------
# Pure-Python backend for the framing layer (same byte format)
# ---------------------------------------------------------------------------


class _PyWriter:
    def __init__(self, path: str):
        new = not (os.path.exists(path) and os.path.getsize(path) > 0)
        self._f = open(path, "ab")
        if new:
            self._f.write(_FILE_MAGIC)

    def append(self, payload: bytes) -> None:
        self._f.write(_HEADER.pack(_RECORD_MAGIC, len(payload), zlib.crc32(payload)))
        self._f.write(payload)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def _py_index(path: str):
    """Streaming scan (headers + chunked CRC), like the native scanner —
    materializing a multi-hundred-MB shard just to compute offsets would
    double peak RSS versus the mmap the reader creates afterwards."""
    offsets: List[int] = []
    lengths: List[int] = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if f.read(8) != _FILE_MAGIC:
            raise ValueError(f"{path}: not a QTSHRD01 shard")
        pos = 8
        while pos + _HEADER.size <= size:
            header = f.read(_HEADER.size)
            if len(header) != _HEADER.size:
                break
            rmagic, length, crc = _HEADER.unpack(header)
            if rmagic != _RECORD_MAGIC or length > size - pos - _HEADER.size:
                break
            running = 0
            remaining = length
            while remaining:
                chunk = f.read(min(remaining, 1 << 20))
                if not chunk:
                    break
                running = zlib.crc32(chunk, running)
                remaining -= len(chunk)
            if remaining or running != crc:
                break
            offsets.append(pos + _HEADER.size)
            lengths.append(length)
            pos += _HEADER.size + length
    return offsets, lengths


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _check_append_target(path: str) -> None:
    """Refuse to append behind a non-shard file.

    Both writers only write the file magic into a NEW/empty file; appending
    records behind foreign bytes would "succeed" while producing a file the
    scanner can never read past byte 8 — silent data loss discovered only at
    read time."""
    try:
        with open(path, "rb") as f:
            head = f.read(8)
    except (FileNotFoundError, IsADirectoryError):
        return
    if head and head != _FILE_MAGIC:
        raise ValueError(
            f"{path}: exists and is not a QTSHRD01 shard — refusing to append"
        )


class ShardWriter:
    """Append dicts of numpy arrays to a validated shard file."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        _check_append_target(path)
        lib = _load_native()
        self._native = None
        self._py: Optional[_PyWriter] = None
        if lib is not None:
            handle = lib.qtshard_writer_open(path.encode())
            if handle:
                self._native = (lib, ctypes.c_void_p(handle))
        if self._native is None:
            self._py = _PyWriter(path)

    def append(self, arrays: Dict[str, np.ndarray]) -> None:
        payload = encode_payload(arrays)
        if self._native is not None:
            lib, handle = self._native
            rc = lib.qtshard_writer_append(handle, payload, len(payload))
            if rc != 0:
                raise IOError(f"qtshard_writer_append failed rc={rc}")
        else:
            assert self._py is not None
            self._py.append(payload)

    def flush(self) -> None:
        if self._native is not None:
            lib, handle = self._native
            lib.qtshard_writer_flush(handle)
        elif self._py is not None:
            self._py.flush()

    def close(self) -> None:
        if self._native is not None:
            lib, handle = self._native
            lib.qtshard_writer_close(handle)
            self._native = None
        elif self._py is not None:
            self._py.close()
            self._py = None

    def __del__(self):
        # The native backend buffers in stdio: without this finalizer a
        # writer dropped without close() loses up to a full stdio buffer of
        # records, while the pure-Python file object flushes on GC — the
        # "loses at most its trailing partial record" bound must hold on
        # both backends. Guarded: at interpreter shutdown the ctypes lib may
        # already be unloaded.
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def index_shard(path: str):
    """Return (offsets, lengths) of every valid record's payload.

    Raises ``FileNotFoundError`` for a missing file on BOTH backends (the
    native scanner only reports a generic open failure, which would surface
    as ``ValueError`` while the pure-Python backend raises from ``open()``);
    ``ValueError`` is reserved for bad magic / unreadable shards.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    lib = _load_native()
    if lib is None:
        return _py_index(path)
    offs = ctypes.POINTER(ctypes.c_uint64)()
    lens = ctypes.POINTER(ctypes.c_uint64)()
    count = ctypes.c_uint64()
    corrupt = ctypes.c_uint64()
    rc = lib.qtshard_index(path.encode(), ctypes.byref(offs), ctypes.byref(lens),
                           ctypes.byref(count), ctypes.byref(corrupt))
    if rc in (1, 2, 5):
        raise ValueError(f"{path}: unreadable or not a QTSHRD01 shard (rc={rc})")
    n = count.value
    offsets = [offs[i] for i in range(n)]
    lengths = [lens[i] for i in range(n)]
    if n:
        lib.qtshard_free(offs)
        lib.qtshard_free(lens)
    return offsets, lengths


class ShardReader:
    """Zero-copy reader: records decoded lazily from an mmap of the file."""

    def __init__(self, path: str):
        self.path = path
        self._offsets, self._lengths = index_shard(path)
        self._f = open(path, "rb")
        self._mm: Optional[mmap.mmap] = None
        if os.path.getsize(path) > 0:
            self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)

    def __len__(self) -> int:
        return len(self._offsets)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        off, length = self._offsets[i], self._lengths[i]
        assert self._mm is not None
        return decode_payload(memoryview(self._mm)[off:off + length])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(len(self)):
            yield self[i]

    def close(self) -> None:
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                # Zero-copy views into the map are still alive; leave the
                # mapping to the GC (dealloc keeps the pages valid until the
                # last view dies).
                pass
            self._mm = None
        self._f.close()

    def __enter__(self) -> "ShardReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_shard(path: str) -> List[Dict[str, np.ndarray]]:
    """Read every record (arrays are copies, safe after close)."""
    with ShardReader(path) as r:
        return [{k: np.array(v) for k, v in rec.items()} for rec in r]


def merge_shards(dst: str, sources: Sequence[str], missing_ok: bool = True) -> int:
    """Concatenate records of ``sources`` onto ``dst``; returns records merged.

    Missing sources are skipped unless ``missing_ok=False``; native when
    available.
    """
    lib = _load_native()
    _check_append_target(dst)
    total = 0
    for src in sources:
        if not os.path.exists(src):
            if missing_ok:
                continue
            raise FileNotFoundError(src)
        if os.path.exists(dst) and os.path.samefile(dst, src):
            # Merging a shard onto itself would silently self-concatenate
            # (the index is taken before appending, so it terminates — with
            # every record duplicated).
            raise ValueError(f"merge_shards: source {src!r} is the destination")
        if lib is not None:
            n = lib.qtshard_merge(dst.encode(), src.encode())
            if n < 0:
                raise IOError(f"qtshard_merge({dst}, {src}) failed rc={n}")
            total += n
        else:
            offsets, lengths = _py_index(src)
            writer = _PyWriter(dst)
            try:
                with open(src, "rb") as f:
                    for off, length in zip(offsets, lengths):
                        f.seek(off)
                        writer.append(f.read(length))
                        total += 1
            finally:
                writer.close()
    return total
