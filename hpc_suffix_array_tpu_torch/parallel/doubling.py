"""Sharded prefix doubling: the distributed suffix-array builder.

Counterpart of ``hpc_suffix_array_tpu/parallel/doubling.py``. Each round,
with every array block-sharded over the mesh:

  1. rank_k <- butterfly shifted ranks          (parallel/shift.py)
  2. sort (rank, rank_k + 1, gidx) globally     (parallel/bitonic.py)
  3. dense re-rank + the convergence scalar     (parallel/rerank.py)
  4. route the dense ranks back to their positions (ring scatter,
     parallel/gather.py), skipped on the converged round.

The JAX package runs the rounds inside one ``lax.while_loop``; here the
loop is a Python loop with one host read per round (``read_scalar`` of
the replicated max rank), which decides both the loop and the skipped
route. The initial ranks come from the hand-written K1 kernel
(``kernels/pack.py::pack_ranks``), one launch per shard over the shard's
bytes and a ``PACK_BITS``-byte halo from the next shard.

The text is padded to ``padded_length(n, P)`` with pad bytes whose code
is 0, below every real byte's code (1..K), so the pad suffixes sort
first and the real suffix array is the tail of the padded one. The
suffix array is unique, so the output equals the JAX package's, the
single-device builder's and SA-IS's at any n and P.

``build_suffix_array_sharded`` first tries the sharded carried-keys
builder (``parallel/bigsort.py``) behind the JAX package's gates
(``SA_SHARDED_MSD_MIN``, ``SA_SHARDED_CHAIN_MIN``): ``info["path"]``
"sharded_msd"; texts it refuses, and the rest, take the doubling loop
("sharded_doubling").
"""

from __future__ import annotations

import numpy as np
import torch

from hpc_suffix_array_tpu_torch.core.suffix_array import (
    FACTOR, PACK_BITS, alphabet_remap, alphabet_remap_dev, as_byte_array)
from hpc_suffix_array_tpu_torch.kernels.pack import pack_ranks
from hpc_suffix_array_tpu_torch.parallel.bitonic import block_bitonic_sort
from hpc_suffix_array_tpu_torch.parallel.gather import dist_scatter_perm
from hpc_suffix_array_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, padded_length, ppermute, read_scalar, shard,
    shard_iota, unshard)
from hpc_suffix_array_tpu_torch.parallel.rerank import dist_rerank_multi
from hpc_suffix_array_tpu_torch.parallel.shift import dist_shifted_ranks


def text_length(text) -> int:
    return (int(text.shape[0]) if isinstance(text, torch.Tensor)
            else int(as_byte_array(text).shape[0]))


def padded_shards(text, n_pad: int, mesh: Mesh) -> list[torch.Tensor]:
    """Sharded uint8 text, zero-padded to ``n_pad`` bytes (a host array,
    or a tensor padded on its own device)."""
    if isinstance(text, torch.Tensor):
        full = torch.zeros(n_pad, dtype=torch.uint8, device=text.device)
        full[:text.shape[0]] = text
    else:
        arr = as_byte_array(text)
        full = np.zeros(n_pad, np.uint8)
        full[:arr.shape[0]] = arr
    return shard(full, mesh)


def sort_live_bits(n_pad: int) -> list[int]:
    """Live bits of the doubling sort's keys (rank, rank_k + 1, gidx):
    ranks are packed codes below 2^PACK_BITS or dense ranks below n_pad,
    and the sentinel shift adds one."""
    top = max((1 << PACK_BITS) - 1, n_pad - 1)
    return [top.bit_length(), (top + 1).bit_length(),
            max(1, (n_pad - 1).bit_length())]


def _dist_round(rank: list[torch.Tensor], k: int, live_bits: list[int]):
    """One sharded doubling round; returns (new_rank, max_rank, sa)."""
    n_shards = len(rank)
    m = rank[0].shape[0]
    n = n_shards * m
    shifts = [dist_shifted_ranks(rank, j * k) for j in range(1, FACTOR)]
    blocks = []
    for me in range(n_shards):
        gidx = shard_iota(me, m, rank[me].device)
        # The sentinel -1 becomes 0: the radix sort reads keys unsigned.
        blocks.append(torch.stack([rank[me], *(s[me] + 1 for s in shifts),
                                   gidx, gidx]))
    del shifts
    blocks = block_bitonic_sort(blocks, FACTOR + 1, live_bits)
    s_idx = [b[FACTOR + 1].clone() for b in blocks]
    dense, max_rank = dist_rerank_multi(
        [[b[c] for b in blocks] for c in range(FACTOR)])
    del blocks
    top = read_scalar(max_rank[0])          # the round's one host read
    # On the converged round new_rank is never read again: skip the route.
    if top >= n - 1:
        return rank, top, s_idx
    return dist_scatter_perm(dense, s_idx), top, s_idx


def _pack_local(bits: int, h0: int, texts: list[torch.Tensor], remap,
                n_real: int) -> list[torch.Tensor]:
    """Initial ranks of each shard on K1: the shard's bytes followed by
    the first ``PACK_BITS`` bytes of the next shard (the last shard gets
    zeros), with positions at or past ``n_real`` reading 0."""
    n_shards = len(texts)
    m = texts[0].shape[0]
    halo = ppermute([t[:PACK_BITS] for t in texts],
                    [(i, i - 1) for i in range(1, n_shards)])
    out = []
    for me in range(n_shards):
        ext = torch.cat([texts[me], halo[me]])
        real = min(max(n_real - me * m, 0), ext.shape[0])
        table = torch.as_tensor(remap, dtype=torch.int32).to(ext.device)
        out.append(pack_ranks(ext, table, bits, h0, real)[:m])
    return out


def suffix_array_kernel_sharded(rank0: list[torch.Tensor], k0: int):
    """Sharded suffix order for initial ranks ``rank0`` (sharded int32)
    that cover the ``k0``-symbol prefix of each suffix.

    Returns (sa, rank, rounds): ``sa`` sharded int32 (the padded suffix
    order), ``rank`` the dense rank before the converging round, as in
    the JAX kernel. At least one round runs; the loop stops when all
    ranks differ or k reaches 2n."""
    m = rank0[0].shape[0]
    n = len(rank0) * m
    live = sort_live_bits(n)
    rank, k, top, rounds, sa = rank0, int(k0), -1, 0, None
    while rounds == 0 or (top < n - 1 and k < 2 * n):
        rank, top, sa = _dist_round(rank, k, live)
        k *= FACTOR
        rounds += 1
    return sa, rank, rounds


def build_suffix_array_sharded(text, mesh: Mesh | None = None,
                               info: dict | None = None,
                               msd: bool | None = None) -> torch.Tensor:
    """Suffix array int32[n] of ``text`` (str, bytes, uint8 array or
    tensor), built block-sharded over ``mesh`` (default: one shard per
    visible card), returned whole on the mesh's first device.

    Texts from ``SA_SHARDED_MSD_MIN`` bytes (4 MiB), and deep-repeat
    texts from ``SA_SHARDED_CHAIN_MIN`` (64 KiB), first try the
    carried-keys builder; where it raises NotImplementedError the
    doubling loop builds them. ``msd`` forces (True) or skips (False)
    that attempt: a caller whose own attempt was just refused passes
    False. ``info``: optional dict that receives ``path``
    ("sharded_msd" or "sharded_doubling") and the builder's keys
    (``rounds``; ``chain_mode``, ``n_words``, ``msd_sorts``). Raises
    ValueError when the padded length reaches 2^31."""
    mesh = make_mesh() if mesh is None else mesh
    n = text_length(text)
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=mesh.devices[0])
    n_pad = padded_length(n, mesh.size)     # raises before allocating
    from hpc_suffix_array_tpu_torch.parallel import bigsort

    if bigsort.try_carried_keys(text, n) if msd is None else msd:
        try:
            sa = bigsort.build_suffix_array_sharded_big(text, mesh,
                                                        info=info)
        except NotImplementedError:
            pass                     # irregular ties: doubling takes them
        else:
            if info is not None:
                info["path"] = "sharded_msd"
            return sa
    if isinstance(text, torch.Tensor):
        remap, bits, h0 = alphabet_remap_dev(text.to(torch.uint8))
    else:
        remap, bits, h0 = alphabet_remap(as_byte_array(text))
    texts = padded_shards(text, n_pad, mesh)
    rank0 = _pack_local(bits, h0, texts, remap, n)
    del texts
    sa, _rank, rounds = suffix_array_kernel_sharded(rank0, h0)
    if info is not None:
        info["path"] = "sharded_doubling"
        info["rounds"] = rounds
    return unshard(sa)[n_pad - n:]
