"""Re-rank scan: dense ranks over the sorted keys, then back to positions.

Counterpart of ``hpc_suffix_array_tpu/ops/scan.py``: adjacent
difference plus a cumulative sum, then a scatter back to suffix order.
The JAX package routed that permutation through a sort on the TPU,
where scatters were slow; only its scatter branch is ported.
"""

from __future__ import annotations

import torch


def dense_ranks(sorted_key: torch.Tensor):
    """Dense rank per sorted record: (dense int32[n], max_rank 0-d tensor).

    ``max_rank == n-1`` means all keys are distinct. The cumsum is asked
    for int32 explicitly: without ``dtype`` it would return int64, twice
    the memory."""
    bumps = torch.zeros(sorted_key.shape[0], dtype=torch.bool,
                        device=sorted_key.device)
    torch.ne(sorted_key[1:], sorted_key[:-1], out=bumps[1:])
    dense = torch.cumsum(bumps, 0, dtype=torch.int32)
    return dense, dense[-1]


def route_to_positions(sorted_idx: torch.Tensor,
                       dense: torch.Tensor) -> torch.Tensor:
    """Permute dense ranks from sorted order back to position order."""
    out = torch.empty_like(dense)
    out[sorted_idx] = dense       # sorted_idx is a permutation: no clashes
    return out
