"""Sharded offset-k rank lookup: out[i] = rank[i + k] globally.

Counterpart of ``hpc_suffix_array_tpu/parallel/shift.py``. The global
shift by k = q*m + r (m the shard width) needs only shards me+q and
me+q+1: a butterfly of log2 P ``ppermute`` steps brings shard me+q, one
more brings its neighbour, and the local window of the two is sliced at
r. ``k`` is a host integer here (the doubling loop is a Python loop), so
a butterfly step whose bit of q is 0 is skipped instead of masked.
"""

from __future__ import annotations

import torch

from hpc_suffix_array_tpu_torch.parallel.mesh import (
    first_local, local_ids, ppermute, shard_iota)

SENTINEL = -1  # rank of the empty suffix (as in ops/shift.py)


def dist_shifted_ranks(rank: list[torch.Tensor], k: int
                       ) -> list[torch.Tensor]:
    """Sharded int32 ``out`` with out[i] = rank[i + k] globally, or
    SENTINEL where i + k >= P*m (any k >= 0)."""
    n_shards = len(rank)
    m = first_local(rank).shape[0]
    n_total = n_shards * m
    if k >= n_total:
        return [None if x is None else torch.full_like(x, SENTINEL)
                for x in rank]
    q, r = divmod(int(k), m)

    # Butterfly: afterwards x holds shard (me + q) mod P of the input.
    x = rank
    b = 0
    while (1 << b) < n_shards:
        s = 1 << b
        if (q >> b) & 1:
            x = ppermute(x, [(i, (i - s) % n_shards)
                             for i in range(n_shards)])
        b += 1
    # Neighbour pull: y = shard (me + q + 1) mod P.
    y = ppermute(x, [(i, (i - 1) % n_shards) for i in range(n_shards)])

    out = [None] * n_shards
    for me in local_ids(rank):
        window = torch.cat([x[me], y[me]])[r:r + m]
        # Positions whose source falls past the padded end (this also
        # voids the butterfly's modular wrap-around).
        g = shard_iota(me, m, rank[me].device)
        out[me] = torch.where(g < n_total - k, window,
                              torch.full_like(window, SENTINEL))
    return out
