"""Offset-k rank lookup: out[i] = rank[i + k], with -1 past the end.

Counterpart of ``hpc_suffix_array_tpu/ops/shift.py``. ``k`` is a host
integer here (the doubling loop is a Python loop), so the shift is one
slice copy; ``k`` grows up to 2n, so every ``k >= n`` gives all -1.
"""

from __future__ import annotations

import torch

SENTINEL = -1  # rank of the empty suffix, sorts before all real ranks


def shifted_ranks(rank: torch.Tensor, k: int) -> torch.Tensor:
    """int32[n] r with r[i] = rank[i+k] if i+k < n else -1 (k >= 0)."""
    n = rank.shape[0]
    out = torch.full_like(rank, SENTINEL)
    if k < n:
        out[:n - k] = rank[k:]
    return out
