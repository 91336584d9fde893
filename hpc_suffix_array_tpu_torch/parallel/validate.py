"""Sharded suffix-array validation, O(n/P) work per shard.

Counterpart of ``hpc_suffix_array_tpu/parallel/validate.py``: the same
linear-time criterion as ``core/validate.py`` (a permutation, and every
adjacent pair in order by first byte, then by the rank of the next
suffix) with text and SA block-sharded:

  * range: every entry in [0, P*m);
  * permutation: ring scatter of ones at the SA's entries, every slot
    hit exactly once;
  * inverse SA: ring scatter of the positions;
  * adjacent pairs: a one-entry boundary ``ppermute`` and ring gathers
    of the text bytes and next-suffix ranks at arbitrary positions.

The three violation counts are summed over shards (``psum``) and read
on the host once.
"""

from __future__ import annotations

import torch

from hpc_suffix_array_tpu_torch.parallel.doubling import (
    padded_shards, text_length)
from hpc_suffix_array_tpu_torch.parallel.gather import (
    dist_gather, dist_scatter_perm)
from hpc_suffix_array_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, padded_length, ppermute, psum, read_scalar, shard,
    shard_iota)


def _violations(texts: list[torch.Tensor], sa_pad: list[torch.Tensor]
                ) -> list[torch.Tensor]:
    """Per shard, the count of out-of-range entries, slots not hit
    exactly once, and adjacent pairs out of order."""
    n_shards = len(sa_pad)
    m = sa_pad[0].shape[0]
    n = n_shards * m
    g = [shard_iota(me, m, s.device) for me, s in enumerate(sa_pad)]
    bad = [((s < 0) | (s >= n)).sum(dtype=torch.int64) for s in sa_pad]
    safe = [s.clamp(0, n - 1) for s in sa_pad]
    hits = dist_scatter_perm([torch.ones_like(s) for s in sa_pad], safe)
    bad = [b + (h != 1).sum(dtype=torch.int64) for b, h in zip(bad, hits)]
    isa = dist_scatter_perm(g, safe)

    # Adjacent SA entries: a = sa_pad[j - 1], b = sa_pad[j] (global j).
    prev_in = ppermute([s[-1:] for s in sa_pad],
                       [(i, i + 1) for i in range(n_shards - 1)])
    a = [torch.cat([p, s[:-1]]) for p, s in zip(prev_in, sa_pad)]
    ca = dist_gather(texts, a)
    cb = dist_gather(texts, sa_pad)
    # Next rank: isa[s + 1], or -1 past the padded end.
    ra = dist_gather(isa, [x + 1 for x in a], fill=-1)
    rb = dist_gather(isa, [x + 1 for x in sa_pad], fill=-1)
    for me in range(n_shards):
        ok = (ca[me] < cb[me]) | ((ca[me] == cb[me]) & (ra[me] < rb[me]))
        ok |= g[me] == 0            # global j = 0 has no predecessor
        bad[me] = bad[me] + (~ok).sum(dtype=torch.int64)
    return bad


def is_valid_suffix_array_sharded(text, sa, mesh: Mesh | None = None
                                  ) -> bool:
    """True iff ``sa`` (int32[n], host or tensor) is exactly the suffix
    array of ``text``, checked block-sharded over ``mesh``."""
    mesh = make_mesh() if mesh is None else mesh
    n = text_length(text)
    if n == 0:
        return True
    dev0 = mesh.devices[0]
    sa_t = torch.as_tensor(sa).to(device=dev0, dtype=torch.int32)
    if sa_t.shape[0] != n:
        return False
    n_pad = padded_length(n, mesh.size)
    # Padded SA: the pad suffixes (all-zero tails, the longest last) sort
    # before every real suffix, in descending start order.
    sa_pad = torch.cat([
        torch.arange(n_pad - 1, n - 1, -1, dtype=torch.int32, device=dev0),
        sa_t])
    sas = shard(sa_pad, mesh)
    del sa_pad, sa_t
    bad = psum(_violations(padded_shards(text, n_pad, mesh), sas))
    return read_scalar(bad[0]) == 0
