"""Build and load the port's hand-written CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` for ``sm_90a`` (Hopper)
into one shared library with a plain C interface under the repository's
``build/kernels/`` directory, keyed by a hash of the sources, at first
use. The library is loaded with ctypes: no source includes PyTorch's
headers, so a build takes seconds rather than minutes. Pointers and the
stream cross as ``c_void_p``; every C entry point returns
``cudaGetLastError()`` after its launch and ``check`` raises on a
nonzero code.

Nothing here runs at import: this module imports on machines without
``nvcc`` or a card, and only ``load()`` needs them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
# Seconds the last build in this process took (0.0 when the library
# was already on disk) and the compiler's report (ptxas register and
# shared-memory use per kernel).
build_seconds = 0.0
build_log = ""


def _sources() -> list[pathlib.Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and pathlib.Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found (set NVCC or put it on PATH); the "
                       "port's CUDA kernels build only where the CUDA "
                       "toolkit is installed")


def load() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    srcs = _sources()
    digest = hashlib.sha256()
    for p in srcs:
        digest.update(p.name.encode() + b"\0" + p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libsa_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
            tmp = pathlib.Path(td) / so.name
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *[str(p) for p in srcs if p.suffix == ".cu"]]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({' '.join(cmd)}):\n{build_log}")
            tmp.replace(so)
        build_seconds = time.perf_counter() - t0
        so.with_suffix(".log").write_text(build_log)
    lib = ctypes.CDLL(str(so))
    lib.sa_pack_ranks.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.sa_pack_ranks.restype = ctypes.c_int
    lib.sa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sa_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load().sa_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")
