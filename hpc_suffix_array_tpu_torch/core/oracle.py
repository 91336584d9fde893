"""Tiny trusted host-side reference implementations (test oracles only).

Counterpart of ``hpc_suffix_array_tpu/core/oracle.py``, numpy only, so
the port checks itself without importing JAX. Intentionally simple and
slow below 64K bytes (sort-based SA, textbook Kasai); above that the
native SA-IS and Kasai stand in.
"""

from __future__ import annotations

import numpy as np

from hpc_suffix_array_tpu_torch import native
from hpc_suffix_array_tpu_torch.core.suffix_array import as_byte_array

NATIVE_ABOVE = 1 << 16


def suffix_array_oracle(text) -> np.ndarray:
    """Suffix array by direct suffix sort (unsigned byte order)."""
    data = bytes(as_byte_array(text).tobytes())
    n = len(data)
    if n > NATIVE_ABOVE:
        return native.sa_build(np.frombuffer(data, np.uint8))
    return np.asarray(sorted(range(n), key=lambda i: data[i:]), dtype=np.int32)


def lcp_oracle(text, sa) -> np.ndarray:
    """LCP array via textbook Kasai; lcp[0] = 0."""
    data = as_byte_array(text)
    n = int(data.shape[0])
    if n > NATIVE_ABOVE:
        return native.lcp_kasai(data, sa)
    sa = np.asarray(sa, dtype=np.int64)
    if n == 0:
        return np.zeros(0, np.int32)
    rank = np.zeros(n, np.int64)
    rank[sa] = np.arange(n)
    lcp = np.zeros(n, np.int32)
    h = 0
    for i in range(n):
        if rank[i] > 0:
            j = sa[rank[i] - 1]
            while i + h < n and j + h < n and data[i + h] == data[j + h]:
                h += 1
            lcp[rank[i]] = h
            if h > 0:
                h -= 1
    return lcp


def lrs_oracle(text):
    """Longest repeated substring (first-argmax tie-break), or None."""
    data = as_byte_array(text)
    sa = suffix_array_oracle(data)
    lcp = lcp_oracle(data, sa)
    if len(lcp) == 0 or lcp.max() == 0:
        return None
    j = int(np.argmax(lcp))
    return data[sa[j]:sa[j] + int(lcp[j])].tobytes()
