"""Distributed block-bitonic sort (compare-split over a shard hypercube).

Counterpart of ``hpc_suffix_array_tpu/parallel/bitonic.py``: every
compare-exchange of the bitonic network on P elements becomes a
compare-split of two sorted blocks (merge them; the lower partner of an
ascending comparator keeps the smaller half), so the shards end globally
sorted, each block ascending, and no shard ever holds more than 2m
records. The network is oblivious: log2 P * (log2 P + 1) / 2 exchanges,
the same for any key skew.

Where the JAX package calls ``lax.sort``, each shard's local pre-sort
and each compare-split merge run the port's hand-written radix sort
(``kernels/radix.py::radix_sort_words``: one ``digit_histograms`` launch
and one ``onesweep_pass`` launch per pass, stable and in place). Keys
are read as unsigned on their live bits, so callers pass non-negative
keys (the doubling builder shifts its -1 sentinel by +1, as
``ops/sort.py`` does).

A block is one int32 tensor of shape (num_keys + 1, m): the key rows,
most significant first, then one payload row (the radix sort's
``MAX_COLS`` = 4 allows up to three keys); or, keys-only, of shape
(num_keys, m) with up to four keys, where the last key is unique and so
serves as the index (the carried-keys builder's (k0, k1[, k2], tb)).
"""

from __future__ import annotations

import torch

from hpc_suffix_array_tpu_torch.kernels.radix import radix_sort_words
from hpc_suffix_array_tpu_torch.parallel.mesh import ppermute


def _sort_rows(block: torch.Tensor, num_keys: int, live_bits) -> None:
    """Stable sort of a (num_keys [+ 1], n) block by its key rows, in
    place."""
    payload = block[num_keys] if block.shape[0] > num_keys else None
    radix_sort_words([block[i] for i in range(num_keys)], payload,
                     live_bits)


def _merge_keep(mine: torch.Tensor, other: torch.Tensor, me: int, j: int,
                k: int, num_keys: int, live_bits) -> torch.Tensor:
    """Shard ``me``'s side of one compare-split with partner ``me ^ j``:
    ascending iff ``me & k == 0``; the lower partner of an ascending
    comparator keeps the min half."""
    m = mine.shape[1]
    i_am_low = (me & j) == 0
    # Canonical merge order (the low shard's block first) and a stable
    # sort: both partners compute the same merged block even where keys
    # tie, so the kept halves partition the union exactly.
    lo, hi = (mine, other) if i_am_low else (other, mine)
    merged = torch.cat([lo, hi], dim=1)
    _sort_rows(merged, num_keys, live_bits)
    keep_min = ((me & k) == 0) == i_am_low
    return (merged[:, :m] if keep_min else merged[:, m:]).contiguous()


def block_bitonic_sort(blocks: list[torch.Tensor], num_keys: int,
                       live_bits) -> list[torch.Tensor]:
    """Globally sort a sharded array of blocks (see module doc).

    ``live_bits``: the live bits of each key row (one int for all, or one
    per key). Returns new blocks; concatenated in shard order along dim
    1 they are sorted by the keys. The inputs are left as they were."""
    n_shards = len(blocks)
    if blocks[0].shape[0] not in (num_keys, num_keys + 1):
        raise ValueError(f"blocks need {num_keys} key rows and at most one "
                         f"payload row, got {blocks[0].shape[0]} rows")
    blocks = [b.clone() for b in blocks]
    for b in blocks:
        _sort_rows(b, num_keys, live_bits)
    k = 2
    while k <= n_shards:
        j = k // 2
        while j >= 1:
            other = ppermute(blocks, [(i, i ^ j) for i in range(n_shards)])
            blocks = [_merge_keep(blocks[me], other[me], me, j, k, num_keys,
                                  live_bits) for me in range(n_shards)]
            del other
            j //= 2
        k *= 2
    return blocks
