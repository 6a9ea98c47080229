"""Build the hand-written CUDA kernels with ``nvcc`` and bind them with
``ctypes``.

Each ``csrc/<name>.cu`` is a self-contained translation unit with a plain C
interface (no PyTorch headers, so a build takes seconds).  At first use it
is compiled for ``sm_90a`` into ``vqa_counterexamples_tpu_torch/_build/``
under a name keyed by the hash of its sources and flags, so an edited
source rebuilds and an unchanged one is reused; a file lock per library
lets one process build it while the others (a run's ranks) wait.  The
``-Xptxas -v`` report (registers, shared memory, spills per kernel) is
kept beside the library as ``lib<name>_<hash>.log``.  Counters
(``core/spans``): ``kernels.builds`` and ``kernels.build_s`` (nvcc runs and
their seconds), ``kernels.loads`` (libraries loaded).

Nothing here runs at import time: the CPU tests import every module, on
hosts that may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ...core import spans

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in %s and on PATH): the "
                           "CUDA kernels are built at first use on a host "
                           "with the CUDA toolkit" % cand)
    return found


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of the same sources and
    flags exists (the library's name carries their hash)."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC_DIR / ("%s.cu" % name)] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / ("lib%s_%s.so" % (name, h.hexdigest()[:12]))
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one build per library: the ranks of a run start together
    with open(BUILD_DIR / ("%s.lock" % name), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():       # another process built it while we waited
            return out
        tmp = out.with_suffix(".so.tmp%d" % os.getpid())
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / ("%s.cu" % name))]
        with spans.timed("kernels.build_s", "kernels.builds"):
            proc = subprocess.run(cmd, capture_output=True, text=True)
        out.with_suffix(".log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s.cu (rc %d):\n%s"
                               % (name, proc.returncode,
                                  proc.stderr[-4000:]))
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library ``name``; its
    ``vqacx_error_string`` entry point is bound for error reporting."""
    lib = ctypes.CDLL(str(build(name)))
    spans.count("kernels.loads")
    lib.vqacx_error_string.argtypes = [ctypes.c_int]
    lib.vqacx_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (its
    ``cudaGetLastError()`` after the launches)."""
    if rc != 0:
        raise RuntimeError("%s: CUDA error %d (%s)"
                           % (what, rc, lib.vqacx_error_string(rc).decode()))


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def stream_of(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def refuse_grad(what: str, *tensors) -> None:
    """Raise if grad mode is on and an operand requires grad: a
    forward-only kernel (its TPU original had no VJP either) would drop
    that gradient without a word."""
    import torch

    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError("%s is forward-only: an operand requires grad "
                           "(detach it, or run under torch.no_grad())"
                           % what)


def require_cuda(what: str, *tensors) -> None:
    """Every tensor on one CUDA device and contiguous, or raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("%s: tensors must share one CUDA device, got %s"
                             % (what, [str(x.device) for x in tensors]))
        if not t.is_contiguous():
            raise ValueError("%s: operands must be contiguous" % what)
