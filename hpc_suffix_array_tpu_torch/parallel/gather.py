"""Distributed random access: out[i] = values[indices[i]], sharded.

Counterpart of ``hpc_suffix_array_tpu/parallel/gather.py``. Neither
values nor indices are replicated:

  * the ring (``_serve_ring``): value blocks rotate around the shards in
    P - 1 ``ppermute`` steps and every shard serves its requests from
    each block as it visits;
  * routed (``_serve_routed``, from ``ROUTED_MIN_SHARDS`` shards up):
    each shard sorts its requests by owner, sends fixed-budget request
    rows with one ``all_to_all``, serves the requests it receives with
    one local gather and returns the answers with a second
    ``all_to_all``. When one owner draws more than the budget of one
    shard's requests (phi chains on periodic text do), every shard
    learns it through ``pmax`` and the whole call takes the ring: the
    JAX package's ``lax.cond`` on that axis-uniform predicate is a host
    branch here, one read.

``dist_scatter_perm`` is the inverse routing: (destination, value) pairs
rotate around the ring and the owner of each destination claims it.
Used by the doubling builder (rank route-back), the LCP builder and the
validator.
"""

from __future__ import annotations

import os

import torch

from hpc_suffix_array_tpu_torch.parallel.mesh import (
    all_to_all, pmax, ppermute, read_scalar, shard_iota)

# Mesh size at which dist_gather switches from the ring to routed
# requests (override: SA_ROUTED_MIN_SHARDS; a threshold set on a TPU).
ROUTED_MIN_SHARDS = int(os.environ.get("SA_ROUTED_MIN_SHARDS", 16))
# Dummy slots of dist_scatter_perm: the elements a shard does not own
# land there, spread over this many slots instead of one address.
DROP_SLOTS = 1024


def _bcast(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


def dist_gather(values: list[torch.Tensor], indices: list[torch.Tensor],
                fill=0) -> list[torch.Tensor]:
    """Sharded ``values[indices]``.

    ``values``: sharded [m, ...] (n = P*m rows); ``indices``: sharded
    int32 global row indices, any length per shard; an index outside
    [0, n) yields ``fill``. Returns the answers in requester order."""
    n_shards = len(values)
    m = values[0].shape[0]
    n = n_shards * m
    safe = [i.clamp(0, n - 1) for i in indices]
    if n_shards >= ROUTED_MIN_SHARDS:
        out = _serve_routed(values, safe)
    else:
        out = _serve_ring(values, safe)
    res = []
    for v, idx, o in zip(values, indices, out):
        ok = _bcast((idx >= 0) & (idx < n), v.dim())
        res.append(torch.where(ok, o, torch.tensor(fill, dtype=v.dtype,
                                                   device=v.device)))
    return res


def _serve_ring(values: list[torch.Tensor], srcs: list[torch.Tensor]
                ) -> list[torch.Tensor]:
    """values[src] for in-range src, rotating value blocks around the ring."""
    n_shards = len(values)
    m = values[0].shape[0]
    outs = [torch.zeros(s.shape + v.shape[1:], dtype=v.dtype,
                        device=v.device) for v, s in zip(values, srcs)]
    blocks = values
    perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    for step in range(n_shards):
        for me in range(n_shards):
            lo = ((me + step) % n_shards) * m   # owner of the held block
            local = srcs[me] - lo
            hit = _bcast((local >= 0) & (local < m), values[me].dim())
            got = torch.index_select(blocks[me], 0, local.clamp_(0, m - 1))
            outs[me] = torch.where(hit, got, outs[me])
        if step + 1 < n_shards:
            blocks = ppermute(blocks, perm)
    return outs


def _serve_routed(values: list[torch.Tensor], srcs: list[torch.Tensor],
                  slack: int = 2) -> list[torch.Tensor]:
    """values[src] by sorted request routing: two ``all_to_all`` hops and
    one local gather per shard; the ring when any owner overflows the
    per-owner budget ``slack * ceil(r / P)``."""
    n_shards = len(values)
    m = values[0].shape[0]
    plans, overflow = [], []
    for src in srcs:
        r = src.shape[0]
        c = min(r, slack * (-(-r // n_shards)))
        o_s, pos_s = torch.sort(torch.div(src, m, rounding_mode="floor"),
                                stable=True)
        first = torch.searchsorted(o_s, o_s, side="left")
        slot = torch.arange(r, device=src.device) - first
        plans.append((c, o_s, pos_s, slot))
        overflow.append((slot >= c).any().to(torch.int32))
    if read_scalar(pmax(overflow)[0]):
        return _serve_ring(values, srcs)

    reqs = []
    for src, (c, o_s, pos_s, slot) in zip(srcs, plans):
        req = torch.full((n_shards, c), -1, dtype=torch.int32,
                         device=src.device)
        req[o_s, slot] = src[pos_s]
        reqs.append(req)
    recv = all_to_all(reqs)
    answers = [v[(rq - me * m).clamp_(0, m - 1).long()]       # (P, c, ...)
               for me, (v, rq) in enumerate(zip(values, recv))]
    back = all_to_all(answers)
    outs = []
    for v, src, b, (c, o_s, pos_s, slot) in zip(values, srcs, back, plans):
        out = torch.zeros(src.shape + v.shape[1:], dtype=v.dtype,
                          device=v.device)
        out[pos_s] = b[o_s, slot]
        outs.append(out)
    return outs


def dist_scatter_perm(values: list[torch.Tensor], dest: list[torch.Tensor]
                      ) -> list[torch.Tensor]:
    """Sharded ``out`` with out[dest[i]] = values[i], ``dest`` a global
    permutation of [0, P*m) (sharded int32, like ``values``).

    (dest, value) pairs rotate around the ring; each shard claims the
    pairs it owns. A pair it does not own lands in a dummy slot, never
    on a real one, so a ``dest`` with duplicates (the validator's reject
    case) neither fails nor writes out of bounds: which duplicate wins
    is unspecified, as in ``.at[].set``."""
    n_shards = len(values)
    m = values[0].shape[0]
    outs, drops = [], []
    for v in values:
        r = v.shape[0]
        outs.append(torch.zeros(m + DROP_SLOTS, dtype=v.dtype,
                                device=v.device))
        drops.append(m + (torch.arange(r, dtype=torch.int32,
                                       device=v.device) % DROP_SLOTS))
    pairs = [torch.stack([d, v.to(d.dtype)]) for d, v in zip(dest, values)]
    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    for step in range(n_shards):
        for me in range(n_shards):
            local = pairs[me][0] - me * m
            hit = (local >= 0) & (local < m)
            slot = torch.where(hit, local, drops[me])
            outs[me].index_put_((slot,), pairs[me][1].to(outs[me].dtype))
        if step + 1 < n_shards:
            pairs = ppermute(pairs, perm)
    return [o[:m] for o in outs]
