"""Distributed dense re-rank over the globally sorted record sequence.

Counterpart of ``hpc_suffix_array_tpu/parallel/rerank.py``: a one-record
boundary ``ppermute``, a local flag cumsum, and a cross-shard exclusive
scan from an ``all_gather`` of the P shard totals.
"""

from __future__ import annotations

import torch

from hpc_suffix_array_tpu_torch.parallel.mesh import (
    all_gather, local_ids, ppermute, smap)


def dist_rerank(s_rank, s_rank_k):
    """Two-column form of :func:`dist_rerank_multi`."""
    return dist_rerank_multi((s_rank, s_rank_k))


def dist_rerank_multi(sorted_cols):
    """Dense ranks of block-sharded, globally sorted key columns.

    ``sorted_cols``: sequence of sharded int32 columns. Returns (dense,
    max_rank): ``dense`` sharded int32, the global dense rank of each
    record (0 for the globally first); ``max_rank`` one 0-d int32 tensor
    per shard, all equal, the largest dense rank (P*m - 1 when all
    records differ)."""
    n_shards = len(sorted_cols[0])
    mine = local_ids(sorted_cols[0])
    # The last record of each shard, for its successor shard (shard 0
    # receives zeros).
    lasts = [None] * n_shards
    for me in mine:
        lasts[me] = torch.stack([c[me][-1:] for c in sorted_cols])
    prev = ppermute(lasts, [(i, i + 1) for i in range(n_shards - 1)])

    locals_ = [None] * n_shards
    for me in mine:
        bumps = None
        for c, col in enumerate(sorted_cols):
            prev_col = torch.cat([prev[me][c], col[me][:-1]])
            b = col[me] != prev_col
            bumps = b if bumps is None else (bumps | b)
        if me == 0:
            bumps[0] = False        # the globally first record
        locals_[me] = torch.cumsum(bumps, 0, dtype=torch.int32)
    gathered = all_gather(smap(lambda loc: loc[-1], locals_))    # (P,)
    dense, max_rank = [None] * n_shards, [None] * n_shards
    for me in mine:
        dense[me] = locals_[me] + gathered[me][:me].sum(dtype=torch.int32)
        max_rank[me] = gathered[me].sum(dtype=torch.int32)
    return dense, max_rank
