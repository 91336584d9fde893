"""Per-round pair sort for prefix doubling, as one int64 composite key.

Counterpart of ``hpc_suffix_array_tpu/ops/sort.py`` (a 2-key unstable
``lax.sort`` with idx as payload). Here the pair becomes one key,
``(rank << 32) | (rank_k + 1)``: ranks are below 2^30 (the packed
initial code has at most 30 bits, later ranks are dense and < n), and
the -1 sentinel of ``rank_k`` maps to 0, so it still sorts first. The
sort is unstable like the reference's: equal pairs get equal dense
ranks whatever their order, and on the converged round all keys differ.
Because the payload is the iota, the returned indices are the sorted
suffix starts. A hand-written radix sort is later work; this is
``torch.sort``, as the JAX package left its sort to XLA.
"""

from __future__ import annotations

import torch


def composite_key(rank: torch.Tensor, rank_k: torch.Tensor) -> torch.Tensor:
    """int64[n] key ordering positions by (rank, rank_k), sentinel first."""
    return (rank.to(torch.int64) << 32) | (rank_k.to(torch.int64) + 1)


def sort_by_rank_pairs(rank: torch.Tensor, rank_k: torch.Tensor):
    """(sorted_key int64[n], sorted_idx int64[n]) for the (rank, rank_k)
    pairs; sorted_idx[j] is the position holding the j-th smallest pair.

    Memory per position: 8 B key + 8 B sorted key + 8 B indices, plus
    the sort's scratch."""
    return torch.sort(composite_key(rank, rank_k), stable=False)
