"""ctypes bindings for the native feature store (``native/feature_store.cpp``,
this package's own copy): mmap-backed parallel row gather and an async
prefetch queue (port of the JAX package's ``data/native_store.py``).

The library is built with ``g++`` at first use into
``vqa_counterexamples_tpu_torch/_build/``, under a name keyed by the hash
of the source and the flags (as ``data/native_decoder.py`` builds the image
decoder), written to a temporary file and renamed under a file lock, so
concurrent processes never load a half-written library.

Where it cannot be built or loaded, :func:`load_library` prints why, once
a process, and returns None; :meth:`NativeFeatureStore.open_npy` then
raises ``OSError`` and the callers (``data/features.FeatureStore``) gather
with numpy, saying which path serves (``FeatureStore.gather_path``).

Usage::

    store = NativeFeatureStore.open_npy("trainset.att.npy")
    out = store.gather(indices)                 # (n, cols) f32 or bf16
    t = store.prefetch(indices, out_buffer)     # overlaps with device work
    store.wait(t)                               # before out_buffer is read
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / "native" / "feature_store.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall",
             "-Wextra")
_ABI_VERSION = 2  # fs_abi_version() in feature_store.cpp

_LIB = None
_LIB_FAILED = False   # set once a build or load failed; numpy from then on


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / ("libfeature_store_%s.so" % h.hexdigest()[:12])


def build() -> Path:
    """Compile the store unless a build of the same source and flags
    exists; raises ``RuntimeError`` with g++'s message when it fails."""
    import fcntl

    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "feature_store.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():       # another process built it while we waited
            return out
        tmp = out.with_suffix(".so.tmp%d" % os.getpid())
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
               str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as exc:
            raise RuntimeError("cannot run %s: %s" % (cmd[0], exc)) from exc
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("g++ failed for feature_store.cpp (rc %d):\n%s"
                               % (proc.returncode, proc.stderr[-2000:]))
        os.replace(tmp, out)
    return out


def load_library():
    """The loaded store library (built if needed), or None where it is
    unavailable; the first failure is printed and remembered for the
    process."""
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    try:
        lib = ctypes.CDLL(str(build()))
        lib.fs_abi_version.restype = ctypes.c_int32
        abi = lib.fs_abi_version()
        if abi != _ABI_VERSION:
            raise RuntimeError("ABI %d != %d" % (abi, _ABI_VERSION))
    except (RuntimeError, OSError, AttributeError) as exc:
        _LIB_FAILED = True
        lines = str(exc).strip().splitlines() or [type(exc).__name__]
        print("native feature store unavailable (%s); rows are gathered "
              "with numpy" % next((ln.strip() for ln in lines
                                   if "error" in ln), lines[-1]))
        return None
    i64, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    lib.fs_open.restype = i64
    lib.fs_open.argtypes = [ctypes.c_char_p, i64, i64, i64, ctypes.c_int32,
                            ctypes.c_int32]
    lib.fs_gather.restype = ctypes.c_int32
    lib.fs_gather.argtypes = [i64, i64p, i64, ctypes.c_void_p]
    lib.fs_prefetch.restype = i64
    lib.fs_prefetch.argtypes = [i64, i64p, i64, ctypes.c_void_p]
    lib.fs_wait.restype = ctypes.c_int32
    lib.fs_wait.argtypes = [i64, i64]
    lib.fs_close.restype = ctypes.c_int32
    lib.fs_close.argtypes = [i64]
    _LIB = lib
    return _LIB


def bf16_dtype() -> np.dtype:
    import ml_dtypes

    return np.dtype(ml_dtypes.bfloat16)


def npy_header_bytes(path: str) -> tuple[int, tuple[int, ...], np.dtype]:
    """Offset of the data section, shape and element dtype of a C-order
    f32 or bf16 ``.npy``.  bf16 matrices (``cli/extract.py --feat-dtype
    bfloat16``) are written as a uint16 bit-view so stock numpy opens
    them: any 2-byte ``u`` / ``V`` element is read as bf16, as the JAX
    package reads it (this store only holds CNN activations)."""
    fmt = np.lib.format
    with open(path, "rb") as f:
        version = fmt.read_magic(f)
        read = (fmt.read_array_header_1_0 if version == (1, 0)
                else fmt.read_array_header_2_0)
        shape, fortran, dtype = read(f)
        if fortran:
            raise ValueError("%s: need a C-order npy" % path)
        if dtype == np.dtype(np.float32):
            return f.tell(), shape, dtype
        if dtype.itemsize == 2 and dtype.kind in "uV":
            return f.tell(), shape, bf16_dtype()
        raise ValueError("%s: need a float32 or bfloat16 npy, got %s"
                         % (path, dtype))


class NativeFeatureStore:
    """Row store over an on-disk feature matrix (f32 or bf16 elements);
    gathers run on the library's C++ threads, without the interpreter
    lock.  ``outstanding`` counts the prefetch tickets not yet waited for:
    the buffer a ticket writes must stay alive and unread until then."""

    def __init__(self, handle: int, lib, rows: int, cols: int,
                 row_shape: tuple, dtype):
        self._handle = handle
        self._lib = lib
        self.rows = rows
        self.cols = cols
        self.row_shape = tuple(row_shape)
        self.dtype = np.dtype(dtype)
        self._tickets: set = set()

    @classmethod
    def open_npy(cls, path: str, n_threads: int = 0
                 ) -> "NativeFeatureStore":
        header, shape, dtype = npy_header_bytes(path)
        cols = int(np.prod(shape[1:]))
        return cls.open_raw(path, shape[0], cols, header, n_threads, dtype,
                            row_shape=tuple(shape[1:]))

    @classmethod
    def open_raw(cls, path: str, rows: int, cols: int,
                 header_bytes: int = 0, n_threads: int = 0,
                 dtype=np.float32, row_shape: tuple | None = None
                 ) -> "NativeFeatureStore":
        """A raw row-major matrix of ``rows`` x ``cols`` elements of
        ``dtype`` at byte ``header_bytes`` of ``path``.  Raises
        ``OSError`` where the library is unavailable or the file is
        short."""
        dtype = np.dtype(dtype)
        lib = load_library()
        if lib is None:
            raise OSError("the native feature store is unavailable")
        handle = lib.fs_open(os.fsencode(path), rows, cols, header_bytes,
                             dtype.itemsize, n_threads)
        if handle < 0:
            raise OSError("fs_open failed with code %d for %s"
                          % (handle, path))
        return cls(handle, lib, rows, cols, row_shape or (cols,), dtype)

    def _args(self, indices, out):
        idx = np.ascontiguousarray(indices, dtype=np.int64).ravel()
        if not (out.flags.c_contiguous and out.dtype == self.dtype
                and out.size == idx.shape[0] * self.cols):
            raise ValueError("out must be a C-contiguous %s buffer of %d x "
                             "%d elements" % (self.dtype, idx.shape[0],
                                              self.cols))
        if idx.size and (idx.min() < 0 or idx.max() >= self.rows):
            raise IndexError("row index out of [0, %d)" % self.rows)
        return (idx, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                idx.shape[0], ctypes.c_void_p(out.ctypes.data))

    def gather(self, indices, out: np.ndarray | None = None) -> np.ndarray:
        """Rows ``indices`` -> (n, cols) (into ``out`` when given)."""
        if out is None:
            out = np.empty((np.size(indices), self.cols), self.dtype)
        _, *args = self._args(indices, out)
        rc = self._lib.fs_gather(self._handle, *args)
        if rc != 0:
            raise RuntimeError("fs_gather failed: %d" % rc)
        return out

    def prefetch(self, indices, out: np.ndarray) -> int:
        """Start an async gather of ``indices`` into ``out``; returns a
        ticket for :meth:`wait` (the indices are copied, ``out`` is not:
        keep it alive and unread until the wait)."""
        _, *args = self._args(indices, out)
        ticket = self._lib.fs_prefetch(self._handle, *args)
        if ticket < 0:
            raise RuntimeError("fs_prefetch failed: %d" % ticket)
        self._tickets.add(ticket)
        return ticket

    def wait(self, ticket: int) -> None:
        rc = self._lib.fs_wait(self._handle, ticket)
        self._tickets.discard(ticket)
        if rc != 0:
            raise RuntimeError("fs_wait failed: %d" % rc)

    @property
    def outstanding(self) -> int:
        return len(self._tickets)

    def close(self) -> None:
        """Wait for every outstanding ticket, then unmap (the library's
        close drains its threads too)."""
        if self._handle is not None:
            for ticket in list(self._tickets):
                self.wait(ticket)
            self._lib.fs_close(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()
