"""Build and load the port's hand-written CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` for ``sm_90a`` (Hopper),
one process per source, all started together, and link into one shared
library with a plain C interface under the repository's
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

from hpc_suffix_array_tpu_torch.utils import profiling

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
# The compiler's report of the last build in this process (ptxas register
# and shared-memory use per kernel).
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
    """Compile (once per source hash) and load the kernel library, in the
    process span "kernels: load" (the compile, where one runs, in
    "kernels: compile")."""
    if _lib is not None:
        return _lib
    with profiling.span("kernels: load", process=True):
        return _load()


def _load() -> ctypes.CDLL:
    global _lib, build_log
    srcs = _sources()
    digest = hashlib.sha256()
    for p in srcs:
        digest.update(p.name.encode() + b"\0" + p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libsa_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with (profiling.span("kernels: compile", process=True),
              tempfile.TemporaryDirectory(dir=BUILD_DIR) as td):
            tmp = pathlib.Path(td) / so.name
            nvcc = _nvcc()
            objs, procs = [], []
            for src in (p for p in srcs if p.suffix == ".cu"):
                obj = pathlib.Path(td) / (src.stem + ".o")
                cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
                objs.append(str(obj))
            # Wait for every compile before judging any, so no nvcc is
            # left running behind a raise.
            logs = [proc.communicate(timeout=600)[0] for _, proc in procs]
            for (cmd, proc), out in zip(procs, logs):
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({' '.join(cmd)}):\n{out}")
            cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                   *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
            build_log = "".join(logs) + proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({' '.join(cmd)}):\n{build_log}")
            tmp.replace(so)
        so.with_suffix(".log").write_text(build_log)
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sa_pack_words.argtypes = [ptr] * 5 + [i64] * 4 + [i32] * 3 + [ptr]
    lib.sa_pack_words.restype = ctypes.c_int
    cols = [ptr] * 8 + [i32, i32, i64, i32, i32]
    lib.sa_block_digit_sort.argtypes = cols + [ptr, ptr]
    lib.sa_block_digit_sort.restype = ctypes.c_int
    lib.sa_place_runs.argtypes = cols + [ptr, ptr, ptr]
    lib.sa_place_runs.restype = ctypes.c_int
    lib.sa_radix_block_elems.argtypes = []
    lib.sa_radix_block_elems.restype = ctypes.c_int
    ints = ctypes.POINTER(ctypes.c_int)
    lib.sa_digit_histograms.argtypes = [ptr] * 3 + [
        i32, i64, i32, ints, ints, ints, i32, ptr, ptr]
    lib.sa_digit_histograms.restype = ctypes.c_int
    lib.sa_onesweep_pass.argtypes = cols + [ptr, ptr, ptr, ctypes.c_uint,
                                            ptr, ptr]
    lib.sa_onesweep_pass.restype = ctypes.c_int
    lib.sa_onesweep_tile_elems.argtypes = [i32]
    lib.sa_onesweep_tile_elems.restype = ctypes.c_int
    lib.sa_post_sort.argtypes = [ptr] * 10 + [i32, ptr, i64] + [i32] * 5 + [
        ptr]
    lib.sa_post_sort.restype = ctypes.c_int
    lib.sa_post_sort_max_blocks.argtypes = []
    lib.sa_post_sort_max_blocks.restype = ctypes.c_int
    lib.sa_round_gather.argtypes = [ptr] * 4 + [i64] * 3 + [ptr]
    lib.sa_round_gather.restype = ctypes.c_int
    lib.sa_round_split.argtypes = [ptr] * 6 + [i64, ptr, i64] + [i32] * 3 + [
        ptr]
    lib.sa_round_split.restype = ctypes.c_int
    lib.sa_round_tile_rows.argtypes = []
    lib.sa_round_tile_rows.restype = ctypes.c_int
    lib.sa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sa_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load().sa_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")
