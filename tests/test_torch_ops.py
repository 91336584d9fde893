"""Per-round primitives of the port against ``hpc_suffix_array_tpu/ops``.

All integer, compared exactly (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_suffix_array_tpu.ops.scan import dense_ranks as jax_dense_ranks
from hpc_suffix_array_tpu.ops.scan import (
    route_to_positions as jax_route_to_positions)
from hpc_suffix_array_tpu.ops.shift import shifted_ranks as jax_shifted_ranks
from hpc_suffix_array_tpu.ops.sort import (
    sort_by_rank_pairs as jax_sort_by_rank_pairs)
from hpc_suffix_array_tpu_torch.ops import (
    composite_key, dense_ranks, route_to_positions, shifted_ranks,
    sort_by_rank_pairs)

N = 300


def split_key(key):
    """Inverse of ``composite_key``: (rank, rank_k) as int32."""
    return ((key >> 32).to(torch.int32),
            ((key & 0xFFFFFFFF) - 1).to(torch.int32))


def _pairs(seed, n=N, hi=20):
    """Rank pairs with many ties; rank_k includes the -1 sentinel."""
    rng = np.random.default_rng(seed)
    rank = rng.integers(0, hi, n).astype(np.int32)
    rank_k = rng.integers(-1, hi, n).astype(np.int32)
    return rank, rank_k


@pytest.mark.parametrize("k", [0, 1, N - 1, N, 2 * N])
def test_shifted_ranks(k):
    rank = np.random.default_rng(k).integers(0, 1000, N).astype(np.int32)
    want = np.asarray(jax_shifted_ranks(jnp.asarray(rank), k))
    assert np.array_equal(shifted_ranks(torch.from_numpy(rank), k).numpy(),
                          want)


def test_sort_by_rank_pairs():
    rank, rank_k = _pairs(1)
    s_rank, s_rank_k, _ = (np.asarray(c) for c in jax_sort_by_rank_pairs(
        jnp.asarray(rank), jnp.asarray(rank_k),
        jnp.arange(N, dtype=jnp.int32)))
    key, s_idx = sort_by_rank_pairs(torch.from_numpy(rank),
                                    torch.from_numpy(rank_k))
    got_rank, got_rank_k = split_key(key)
    # Tie order is unspecified in both; the sorted pairs are not.
    assert np.array_equal(got_rank.numpy(), s_rank)
    assert np.array_equal(got_rank_k.numpy(), s_rank_k)
    idx = s_idx.numpy()
    assert np.array_equal(np.sort(idx), np.arange(N))
    assert np.array_equal(rank[idx], s_rank)
    assert np.array_equal(rank_k[idx], s_rank_k)


def test_composite_key_orders_sentinel_first():
    rank = torch.tensor([5, 5, 5, (1 << 30) - 1], dtype=torch.int32)
    rank_k = torch.tensor([0, -1, 1 << 30, -1], dtype=torch.int32)
    key = composite_key(rank, rank_k)
    order = torch.argsort(key).tolist()
    assert order == [1, 0, 2, 3]
    back_rank, back_rank_k = split_key(key)
    assert torch.equal(back_rank, rank) and torch.equal(back_rank_k, rank_k)


@pytest.mark.parametrize("hi", [3, 20, 10_000])
def test_dense_ranks(hi):
    rank, rank_k = _pairs(hi, hi=hi)
    order = np.lexsort((rank_k, rank))
    s_rank, s_rank_k = rank[order], rank_k[order]
    want, want_max = jax_dense_ranks(jnp.asarray(s_rank),
                                     jnp.asarray(s_rank_k))
    dense, max_rank = dense_ranks(composite_key(torch.from_numpy(s_rank),
                                                torch.from_numpy(s_rank_k)))
    assert dense.dtype == torch.int32
    assert np.array_equal(dense.numpy(), np.asarray(want))
    assert int(max_rank) == int(want_max)


def test_route_to_positions():
    rng = np.random.default_rng(3)
    s_idx = rng.permutation(N).astype(np.int32)
    dense = np.sort(rng.integers(0, N, N)).astype(np.int32)
    want = np.asarray(jax_route_to_positions(jnp.asarray(s_idx),
                                             jnp.asarray(dense)))
    got = route_to_positions(torch.from_numpy(s_idx).long(),
                             torch.from_numpy(dense))
    assert np.array_equal(got.numpy(), want)
