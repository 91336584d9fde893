"""Host-side byte I/O feeding device buffers.

Counterpart of ``hpc_suffix_array_tpu/utils/io.py``: whole-file binary
read with a size probe, file write, head and tail previews. Reads are
read-only ``np.memmap`` views, so a 1 GiB corpus costs no host RAM up
front; the builders stage the bytes on the device once.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def read_file(path: str, mmap: bool = True) -> np.ndarray:
    """Read a file as uint8[n]. Memory-mapped (read-only view) by default."""
    size = os.path.getsize(path)
    if size == 0:
        return np.zeros((0,), np.uint8)
    if mmap:
        return np.memmap(path, dtype=np.uint8, mode="r", shape=(size,))
    with open(path, "rb") as f:
        return np.frombuffer(f.read(), dtype=np.uint8)


def write_file(path: str, data) -> None:
    """Write bytes or a uint8 array to ``path``."""
    arr = (data if isinstance(data, (bytes, bytearray))
           else np.asarray(data, np.uint8))
    with open(path, "wb") as f:
        f.write(bytes(arr))


def _decode(data) -> str:
    b = (data if isinstance(data, (bytes, bytearray))
         else bytes(np.asarray(data, np.uint8)))
    return b.decode("utf-8", errors="replace")


def print_first_chars(data, n: int, file=None) -> None:
    """Head preview."""
    print(f"First {n} characters: {_decode(data[:n])}",
          file=file or sys.stdout)


def print_last_chars(data, n: int, file=None) -> None:
    """Tail preview."""
    tail = data[-n:] if len(data) > n else data
    print(f"Last {n} characters: {_decode(tail)}", file=file or sys.stdout)
