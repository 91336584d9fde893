"""Native host helpers (SA-IS, Kasai, the O(n) validator) via ctypes,
JAX-free.

Compiles this package's own copy of the C source (``native/sais.c``,
the same file as the JAX package's) into the repository's
``build/native/`` directory on first use, keyed by a hash of the
source. A build failure raises: these helpers are the port's
correctness oracle, and an oracle that silently went missing would turn
checks into no-ops.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
SAIS_SRC = _HERE / "sais.c"
BUILD_DIR = _HERE.parents[1] / "build" / "native"
_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the helper library."""
    global _lib
    if _lib is not None:
        return _lib
    src = SAIS_SRC.read_bytes()
    so = BUILD_DIR / f"_sais_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cc = os.environ.get("CC", "cc")
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
            tmp = pathlib.Path(td) / so.name
            proc = subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", str(SAIS_SRC), "-o",
                 str(tmp)], capture_output=True, text=True, timeout=120)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {SAIS_SRC} with {cc} failed:\n{proc.stderr}")
            tmp.replace(so)         # atomic: concurrent builders race safely
    lib = ctypes.CDLL(str(so))
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.tpu_sa_build.argtypes = [u8p, ctypes.c_int32, i32p]
    lib.tpu_sa_build.restype = ctypes.c_int
    lib.tpu_lcp_kasai.argtypes = [u8p, i32p, ctypes.c_int32, i32p]
    lib.tpu_lcp_kasai.restype = ctypes.c_int
    lib.tpu_sa_validate.argtypes = [u8p, i32p, ctypes.c_int32]
    lib.tpu_sa_validate.restype = ctypes.c_int
    _lib = lib
    return lib


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _text(text) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(text, np.uint8))


def _sa(sa) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(sa, np.int32))


def sa_build(text) -> np.ndarray:
    """SA-IS suffix array of a uint8 host array (O(n))."""
    arr = _text(text)
    n = int(arr.shape[0])
    sa = np.empty(n, np.int32)
    if n and build().tpu_sa_build(_u8(arr), n, _i32(sa)) != 0:
        raise MemoryError("tpu_sa_build failed")
    return sa


def lcp_kasai(text, sa) -> np.ndarray:
    """Kasai LCP array (O(n)); lcp[0] = 0."""
    arr, sa = _text(text), _sa(sa)
    n = int(arr.shape[0])
    if sa.shape[0] != n:
        raise ValueError(f"sa length {sa.shape[0]} != text length {n}")
    lcp = np.zeros(n, np.int32)
    if n and build().tpu_lcp_kasai(_u8(arr), _i32(sa), n, _i32(lcp)) != 0:
        raise MemoryError("tpu_lcp_kasai failed")
    return lcp


def sa_validate(text, sa) -> bool:
    """True iff ``sa`` is the suffix array of the uint8 host text: a
    permutation of [0, n) whose adjacent pairs are in suffix order
    (O(n), ``tpu_sa_validate``)."""
    arr, sa = _text(text), _sa(sa)
    n = int(arr.shape[0])
    if sa.shape[0] != n:
        return False
    rc = build().tpu_sa_validate(_u8(arr), _i32(sa), n)
    if rc < 0:
        raise MemoryError("tpu_sa_validate failed")
    return bool(rc)
