"""Builds the port's native libraries at first use.

Everything goes to ``<repo>/build/qzk_tpu_torch/`` (listed in
``.gitignore``), keyed by a hash of the sources and flags, so a fresh
checkout builds once and a changed source rebuilds.  CUDA sources are
compiled with plain ``nvcc`` into a shared library with a C interface,
loaded with ``ctypes``: no PyTorch headers and no ``ninja``, so a build
takes seconds.  Threads of one process build a library once, under a
lock of its own; processes that share the build directory each compile
to a name of their own and move the result into place.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO, "build", "qzk_tpu_torch")

_LOCKS_LOCK = threading.Lock()
_LOCKS: dict[str, threading.Lock] = {}


def _lock_of(out: str) -> threading.Lock:
    """The lock of one library path: threads building different
    libraries still compile in parallel."""
    with _LOCKS_LOCK:
        return _LOCKS.setdefault(out, threading.Lock())

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _tagged_path(name: str, files: list[str], flags: list[str], ext: str) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for f in files:
        with open(f, "rb") as fh:
            h.update(fh.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}{ext}")


def _compile(cmd: list[str], out: str) -> None:
    """Run a compiler writing `out` through a temporary name of this
    process and thread, so that concurrent builders never load a
    half-written library.  The compiler's messages (nvcc -Xptxas -v:
    registers, spills) go to `out`.log."""
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    res = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True)
    with open(out + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(
            f"build of {os.path.basename(out)} failed:\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, out)


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def cuda_library(name: str, source: str, headers: list[str]) -> str:
    """Path of the shared library built from one .cu source."""
    out = _tagged_path(name, [source, *headers], NVCC_FLAGS, ".so")
    with _lock_of(out):
        if not os.path.exists(out):
            inc = ["-I", os.path.dirname(source)]
            _compile([nvcc(), *NVCC_FLAGS, *inc, source], out)
    return out


def cxx_library(name: str, source: str, flags: list[str]) -> str:
    """Path of the shared library built from one C++ source with g++."""
    out = _tagged_path(name, [source], flags, ".so")
    with _lock_of(out):
        if not os.path.exists(out):
            _compile(["g++", *flags, source], out)
    return out
