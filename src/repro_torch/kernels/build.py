"""Build and bind the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes`` -- no PyTorch
headers, so a build takes seconds.  Libraries land in ``build/kernels/``
at the repository root, named by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is reused.  A failed build
raises; nothing catches it.

Every C entry point takes its pointers and the CUDA stream as ``void*``
and returns ``cudaGetLastError()`` after the launch; :class:`Kernel`
raises if that is not 0 and counts the launches that succeeded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; None if its library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names=None) -> dict[str, str]:
    """Compile every named source (default: all of ``csrc/``) with one
    ``nvcc`` each, all started together.  Returns ``{name: ptxas log}``
    ("" where the library was already built)."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None \
        else list(names)
    started = {n: _start(n) for n in names}
    return {n: _finish(n, started[n]) for n in names}


class Kernel:
    """One C entry point of one source, bound lazily on first launch.

    ``launches`` counts successful launches: the wrappers in ``ops.py``
    call the kernel only through here, so this integer is how a run
    shows that its main path went through the kernel."""

    def __init__(self, source: str, entry: str, argtypes):
        self.source, self.entry = source, entry
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def _bind(self):
        path = library_path(self.source)
        if not path.exists():
            build_all([self.source])
        fn = getattr(ctypes.CDLL(str(path)), self.entry)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def __call__(self, *args) -> None:
        if self._fn is None:
            self._fn = self._bind()
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.source}.cu:{self.entry} launch failed "
                               f"with cudaError {err}")
        self.launches += 1


PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float
