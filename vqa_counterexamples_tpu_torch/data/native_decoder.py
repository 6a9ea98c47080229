"""ctypes bindings for the native image decoder (``native/image_decoder.cpp``,
this package's own copy): GIL-free libjpeg decode + Pillow-bit-exact
bilinear Scale -> CenterCrop on a C++ thread pool (port of the JAX
package's ``data/native_decoder.py``).

The library is built with ``g++`` at first use into
``vqa_counterexamples_tpu_torch/_build/``, under a name keyed by the hash of
the source and the flags (as ``ops/cuda/build.py`` keys the kernels), written
to a temporary file and renamed under a file lock, so concurrent processes
never load a half-written library.  The build needs libjpeg's headers and
library (``jpeglib.h``, ``-ljpeg``).

Where it cannot be built, PIL decodes everything: ``load_library`` prints
why and returns None, and the callers (``cli/extract.py``,
``serve/demo_server.py``) take PIL's path for every item.  Where PIL does
not import either, ``load_library`` raises, naming both.  Items the library
refuses (``ok=False``: PNG, CMYK, a truncated stream) go through PIL one by
one (:func:`decode_files`, :func:`decode_buffers`).  The two paths give the
same bytes (``tests/test_torch_decoder.py``).

Usage::

    dec = NativeImageDecoder(n_threads=8)
    batch, ok = dec.decode_files(paths, size=448)   # (n,448,448,3) u8, mask
    batch, ok = dec.decode_buffers(jpeg_bytes_list, size=448)
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import subprocess
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / "native" / "image_decoder.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall",
             "-Wextra")
LIBS = ("-ljpeg",)
_ABI_VERSION = 2  # id_abi_version() in image_decoder.cpp

_LIB = None
_LIB_FAILED = False   # set once a build failed; PIL decodes from then on


def _have_pil() -> bool:
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    h = hashlib.sha1(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / ("libimage_decoder_%s.so" % h.hexdigest()[:12])


def build() -> Path:
    """Compile the decoder unless a build of the same source and flags
    exists; raises ``RuntimeError`` with g++'s message when it fails."""
    import fcntl

    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "image_decoder.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():       # another process built it while we waited
            return out
        tmp = out.with_suffix(".so.tmp%d" % os.getpid())
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
               str(SOURCE), *LIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as exc:
            raise RuntimeError("cannot run %s: %s" % (cmd[0], exc)) from exc
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("g++ failed for image_decoder.cpp (rc %d):\n%s"
                               % (proc.returncode, proc.stderr[-2000:]))
        os.replace(tmp, out)
    return out


def load_library(build_lib: bool = True):
    """Load (building if needed) the decoder; None where it is unavailable
    and PIL can decode instead.

    With ``build_lib=False`` a missing library is a soft miss, not
    remembered: a later caller that builds still gets its attempt.  A
    failed build is remembered for the process.  Raises ``RuntimeError``
    when the library is unavailable and PIL does not import: no image
    could be decoded."""
    global _LIB, _LIB_FAILED
    if _LIB is not None:
        return _LIB
    why = None
    if _LIB_FAILED:
        why = "an earlier build failed"
    elif build_lib:
        try:
            path = build()
        except RuntimeError as exc:
            _LIB_FAILED = True
            lines = str(exc).strip().splitlines()
            why = "build failed: %s" % next(
                (ln.strip() for ln in lines if "error" in ln), lines[-1])
    else:
        path = library_path()
        if not path.exists():
            why = "not built"
    if why is None:
        try:
            lib = ctypes.CDLL(str(path))
            lib.id_abi_version.restype = ctypes.c_int32
            abi = lib.id_abi_version()
        except (OSError, AttributeError) as exc:
            lib, why = None, "load failed: %s" % exc
        else:
            if abi != _ABI_VERSION:
                lib, why = None, "ABI %d != %d" % (abi, _ABI_VERSION)
        if lib is None and build_lib:
            _LIB_FAILED = True
    if why is None:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.id_decode_files.restype = ctypes.c_int32
        lib.id_decode_files.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                        ctypes.c_int32, ctypes.c_int32,
                                        ctypes.c_int32, u8p, i32p]
        lib.id_decode_buffers.restype = ctypes.c_int32
        lib.id_decode_buffers.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                          ctypes.POINTER(ctypes.c_int64),
                                          ctypes.c_int32, ctypes.c_int32,
                                          ctypes.c_int32, u8p, i32p]
        _LIB = lib
        return _LIB
    if not _have_pil():
        raise RuntimeError("no image decoder: the native decoder is "
                           "unavailable (%s; it needs g++ and libjpeg) and "
                           "PIL does not import" % why)
    if build_lib:
        print("native image decoder unavailable (%s); decoding with PIL"
              % why)
    return None


class NativeImageDecoder:
    """Batch JPEG -> (n, size, size, 3) uint8 Scale+CenterCrop decoder."""

    def __init__(self, n_threads: int | None = None, build: bool = True):
        self._lib = load_library(build_lib=build)
        self.n_threads = n_threads or (os.cpu_count() or 1)

    @property
    def available(self) -> bool:
        return self._lib is not None

    def decode_files(self, paths, size: int = 448):
        """Decode files; returns ((n,size,size,3) uint8, (n,) bool ok).

        Rows with ok=False are left zeroed: decode those with PIL."""
        n = len(paths)
        out = np.zeros((n, size, size, 3), dtype=np.uint8)
        ok = np.zeros(n, dtype=np.int32)
        if self._lib is None or n == 0:
            return out, ok.astype(bool)
        arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        self._lib.id_decode_files(
            arr, n, self.n_threads, size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out, ok.astype(bool)

    def decode_buffers(self, buffers, size: int = 448):
        """Decode in-memory JPEG byte strings (serving request bodies)."""
        n = len(buffers)
        out = np.zeros((n, size, size, 3), dtype=np.uint8)
        ok = np.zeros(n, dtype=np.int32)
        if self._lib is None or n == 0:
            return out, ok.astype(bool)
        keep = [bytes(b) for b in buffers]   # alive through the call
        bufs = (ctypes.c_void_p * n)(
            *[ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p)
              for b in keep])
        lens = (ctypes.c_int64 * n)(*[len(b) for b in keep])
        self._lib.id_decode_buffers(
            bufs, lens, n, self.n_threads, size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out, ok.astype(bool)


def pil_decode(raw_or_path, size: int = 448) -> np.ndarray:
    """One image (bytes or a path) through PIL: ``convert("RGB")`` and
    ``models/convnets.preprocess_image_uint8``."""
    from PIL import Image

    from ..models.convnets import preprocess_image_uint8

    src = (io.BytesIO(raw_or_path) if isinstance(raw_or_path, bytes)
           else raw_or_path)
    with Image.open(src) as img:
        return preprocess_image_uint8(img.convert("RGB"), size)


def _fill_rest(out, ok, items, size):
    for i in np.flatnonzero(~ok):
        out[i] = pil_decode(items[i], size)
    return out


def decode_files(decoder, paths, size: int = 448) -> np.ndarray:
    """(n, size, size, 3) uint8 of ``paths``: the native decoder where it
    is available and takes the item, PIL for the rest (every item where
    ``decoder`` is None or unavailable)."""
    if decoder is not None and decoder.available:
        out, ok = decoder.decode_files(paths, size)
    else:
        out = np.zeros((len(paths), size, size, 3), np.uint8)
        ok = np.zeros(len(paths), bool)
    return _fill_rest(out, ok, list(paths), size)


def decode_buffers(decoder, raws, size: int = 448) -> np.ndarray:
    """The same for in-memory encoded images."""
    if decoder is not None and decoder.available:
        out, ok = decoder.decode_buffers(raws, size)
    else:
        out = np.zeros((len(raws), size, size, 3), np.uint8)
        ok = np.zeros(len(raws), bool)
    return _fill_rest(out, ok, list(raws), size)
