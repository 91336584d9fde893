"""The port's sharded backend against the JAX package's, on the CPU.

The JAX side runs its ``shard_map`` programs on the 8 virtual CPU
devices of ``tests/conftest.py``; the port runs P shards on the one CPU
(``make_mesh(P, devices=["cpu"])``). Inputs are numpy arrays from fixed
seeds; every comparison is exact. Texts stay below 2^16 bytes, so the
JAX package's sharded builder takes its doubling loop, as the port's
does. Each JAX build runs once per module (``_jax_sa``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec

import hpc_suffix_array_tpu.parallel as jpar
import hpc_suffix_array_tpu.parallel.gather as jgather
import hpc_suffix_array_tpu_torch.parallel as tpar
import hpc_suffix_array_tpu_torch.parallel.gather as tgather
from hpc_suffix_array_tpu.core.suffix_array import (
    alphabet_remap as jax_alphabet_remap)
from hpc_suffix_array_tpu.parallel.bitonic import (
    block_bitonic_sort as jax_bitonic)
from hpc_suffix_array_tpu.parallel.doubling import (
    _pack_local as jax_pack_local)
from hpc_suffix_array_tpu.parallel.doubling import (
    suffix_array_from_bytes_sharded as jax_from_bytes)
from hpc_suffix_array_tpu.parallel.rerank import (
    dist_rerank_multi as jax_rerank)
from hpc_suffix_array_tpu.parallel.shift import (
    dist_shifted_ranks as jax_shifted)
from hpc_suffix_array_tpu_torch.core.oracle import suffix_array_oracle
from hpc_suffix_array_tpu_torch.core.suffix_array import (
    PACK_BITS, alphabet_remap)
from hpc_suffix_array_tpu_torch.parallel import mesh as tmesh
from hpc_suffix_array_tpu_torch.parallel.bitonic import block_bitonic_sort
from hpc_suffix_array_tpu_torch.parallel.doubling import _pack_local
from hpc_suffix_array_tpu_torch.parallel.gather import (
    dist_gather, dist_scatter_perm)
from hpc_suffix_array_tpu_torch.parallel.rerank import (
    dist_rerank, dist_rerank_multi)
from hpc_suffix_array_tpu_torch.parallel.shift import (
    SENTINEL, dist_shifted_ranks)

from tests.conftest import CANONICAL

SHARDS = [1, 2, 4, 8]
SEQ = PartitionSpec("seq")


def _tmesh(p):
    return tpar.make_mesh(p, devices=["cpu"])


def _tshard(a, p):
    return tpar.shard(np.ascontiguousarray(a), _tmesh(p))


def _whole(xs):
    return tpar.unshard(xs).numpy()


def _jax_run(fn, p, *arrays, out_specs=SEQ):
    """``fn`` as a shard_map body over ``p`` virtual devices, on
    block-sharded numpy ``arrays``."""
    mesh = jpar.make_mesh(p)
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(SEQ,) * len(arrays),
                              out_specs=out_specs, check_vma=False))
    out = f(*[jax.device_put(a, NamedSharding(mesh, SEQ)) for a in arrays])
    return jax.tree_util.tree_map(np.asarray, out)


def _snapshot(xs):
    return [x.clone() for x in xs]


def _unchanged(before, after):
    return all(torch.equal(b, a) for b, a in zip(before, after))


# ---- mesh and collectives --------------------------------------------------

def test_make_mesh_places_shards_modulo_the_devices():
    mesh = tpar.make_mesh(4, devices=["cpu", "cpu"])
    assert mesh.size == 4 and mesh.n_cards == 1
    assert [d.type for d in mesh.shard_devices] == ["cpu"] * 4
    assert tpar.make_mesh(device="cpu").size == 1
    assert tpar.make_mesh(8, device="cpu").size == 8


@pytest.mark.parametrize("p", [0, 3, 6])
def test_make_mesh_needs_a_power_of_two(p):
    with pytest.raises(ValueError, match="power of two"):
        tpar.make_mesh(p, devices=["cpu"])


def test_make_mesh_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tpar.make_mesh(2)


def test_shard_unshard_round_trip_copies():
    a = torch.arange(64, dtype=torch.int32)
    xs = tpar.shard(a, _tmesh(4))
    assert [x.tolist() for x in xs] == [list(range(i, i + 16))
                                        for i in range(0, 64, 16)]
    xs[0][0] = 99                               # a fresh block, not a view
    assert a[0] == 0
    assert torch.equal(tpar.unshard(tpar.shard(a, _tmesh(8))), a)
    with pytest.raises(ValueError, match="multiple"):
        tpar.shard(torch.arange(10), _tmesh(4))


@pytest.mark.parametrize("p", [2, 4, 8])
def test_ppermute_matches_lax_with_zeros_for_missing_sources(p, rng):
    x = rng.integers(-99, 99, p * 16).astype(np.int32)
    perm = [(i, i + 1) for i in range(p - 1)]     # shard 0 receives nothing
    want = _jax_run(lambda v: lax.ppermute(v, "seq", perm), p, x)
    xs = _tshard(x, p)
    before = _snapshot(xs)
    got = tmesh.ppermute(xs, perm)
    assert np.array_equal(_whole(got), want)
    assert not got[0].any()
    assert _unchanged(before, xs)


@pytest.mark.parametrize("p", [2, 8])
def test_all_gather_psum_pmax_match_lax(p, rng):
    x = rng.integers(-1000, 1000, p).astype(np.int32)
    xs = [torch.tensor(v) for v in x]
    want_g = _jax_run(lambda v: lax.all_gather(v[0], "seq")[None], p, x)
    got_g = tmesh.all_gather(xs)
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got_g, want_g))
    for coll, lax_fn in ((tmesh.psum, lax.psum), (tmesh.pmax, lax.pmax)):
        want = _jax_run(lambda v, f=lax_fn: f(v, "seq"), p, x)
        got = coll(xs)
        assert [int(g) for g in got] == want.tolist()


@pytest.mark.parametrize("p", [2, 4, 8])
def test_all_to_all_matches_lax(p, rng):
    c = 3
    x = rng.integers(0, 1000, (p * p, c)).astype(np.int32)
    want = _jax_run(lambda v: lax.all_to_all(v, "seq", 0, 0, tiled=True),
                    p, x)
    xs = [torch.from_numpy(x[i * p:(i + 1) * p].copy()) for i in range(p)]
    got = tmesh.all_to_all(xs)
    assert np.array_equal(torch.cat(got).numpy(), want)


def test_read_scalar_counts_reads():
    before = tmesh.read_scalar.reads
    assert tmesh.read_scalar(torch.tensor(7)) == 7
    assert tmesh.read_scalar.reads == before + 1


# ---- shift, rerank, bitonic ------------------------------------------------

@pytest.mark.parametrize("p", [2, 8])
@pytest.mark.parametrize("k_of", [(0, 0, 0), (0, 0, 1), (1, 0, -1),
                                  (1, 0, 0), (1, 0, 3), (3, 0, 7),
                                  (0, 1, -1), (0, 1, 0), (0, 2, 0)])
def test_dist_shifted_ranks_matches_jax(p, k_of, rng):
    """k = a*m + b*n + c, including k >= m and k >= n."""
    m = 128
    n = p * m
    k = k_of[0] * m + k_of[1] * n + k_of[2]
    rank = rng.integers(0, 1 << 20, n).astype(np.int32)
    want = _jax_run(lambda r: jax_shifted(r, k, "seq", p), p, rank)
    xs = _tshard(rank, p)
    before = _snapshot(xs)
    got = _whole(dist_shifted_ranks(xs, k))
    assert np.array_equal(got, want)
    ref = np.full(n, SENTINEL, np.int32)
    ref[:max(n - k, 0)] = rank[k:]
    assert np.array_equal(got, ref)
    assert _unchanged(before, xs)


@pytest.mark.parametrize("p", SHARDS)
def test_dist_rerank_multi_matches_jax(p, rng):
    n = p * 256
    a = np.sort(rng.integers(0, 40, n)).astype(np.int32)
    b = rng.integers(-1, 3, n).astype(np.int32)
    order = np.lexsort((b, a))
    a, b = a[order], b[order]
    want_dense, want_max = _jax_run(
        lambda x, y: jax_rerank((x, y), "seq", p), p, a, b,
        out_specs=(SEQ, PartitionSpec()))
    dense, top = dist_rerank_multi((_tshard(a, p), _tshard(b, p)))
    assert np.array_equal(_whole(dense), want_dense)
    assert {int(t) for t in top} == {int(want_max)}
    dense2, top2 = dist_rerank(_tshard(a, p), _tshard(b, p))
    assert np.array_equal(_whole(dense2), want_dense)


@pytest.mark.parametrize("p", SHARDS)
def test_block_bitonic_sort_matches_jax(p, rng):
    n = p * 256
    keys = rng.integers(0, 50, n).astype(np.int32)       # heavy duplicates
    vals = np.arange(n, dtype=np.int32)
    jk, jv = _jax_run(lambda a, b: jax_bitonic((a, b), 1, "seq", p), p,
                      keys, vals, out_specs=(SEQ, SEQ))
    blocks = [torch.stack([k, v]) for k, v in
              zip(_tshard(keys, p), _tshard(vals, p))]
    before = _snapshot(blocks)
    out = torch.cat(block_bitonic_sort(blocks, 1, 6), dim=1).numpy()
    assert np.array_equal(out[0], jk)                    # global order
    assert np.array_equal(np.sort(out[1]), vals)         # a permutation
    assert np.array_equal(out[0], keys[out[1]])          # values follow
    assert sorted(zip(out[0], out[1])) == sorted(zip(jk, jv))
    assert _unchanged(before, blocks)


@pytest.mark.parametrize("p", [2, 8])
def test_block_bitonic_sort_three_keys_sorts_lexicographically(p, rng):
    n = p * 128
    cols = [rng.integers(0, 4, n), rng.integers(0, 3, n),
            rng.permutation(n)]
    cols = [c.astype(np.int32) for c in cols]
    blocks = [torch.stack(list(c) + [c[2]]) for c in
              zip(*[_tshard(c, p) for c in cols])]
    out = torch.cat(block_bitonic_sort(blocks, 3, [2, 2, 12]), dim=1).numpy()
    order = np.lexsort((cols[2], cols[1], cols[0]))
    assert np.array_equal(out[3], cols[2][order])


# ---- gather and scatter ----------------------------------------------------

def _gather_both(values, indices, p, fill=0, monkeypatch=None):
    want = _jax_run(lambda v, i: jgather.dist_gather(v, i, "seq", p, fill),
                    p, values, indices)
    vs, ids = _tshard(values, p), _tshard(indices, p)
    before = _snapshot(vs) + _snapshot(ids)
    got = _whole(dist_gather(vs, ids, fill=fill))
    assert _unchanged(before, vs + ids)
    return got, want


@pytest.mark.parametrize("p", SHARDS)
def test_dist_gather_ring_random_indices(p, rng):
    n = p * 512
    values = rng.integers(-1000, 1000, n).astype(np.int32)
    indices = rng.integers(-50, n + 50, n).astype(np.int32)
    got, want = _gather_both(values, indices, p, fill=-7)
    expect = np.where((indices >= 0) & (indices < n),
                      values[np.clip(indices, 0, n - 1)], -7)
    assert np.array_equal(got, want) and np.array_equal(got, expect)


@pytest.mark.parametrize("routed", [False, True])
@pytest.mark.parametrize("case", ["uniform", "skew", "partial_skew", "2d"])
def test_dist_gather_matches_jax(case, routed, rng, monkeypatch):
    """Ring and routed (``ROUTED_MIN_SHARDS`` lowered to 8 in both
    packages), including the skew that sends the routed path to the
    ring."""
    if routed:
        monkeypatch.setattr(jgather, "ROUTED_MIN_SHARDS", 8)
        monkeypatch.setattr(tgather, "ROUTED_MIN_SHARDS", 8)
    p = 8
    n = p * 256
    m = n // p
    values = rng.integers(0, 1 << 20, n).astype(np.int32)
    indices = rng.integers(-9, n + 9, n).astype(np.int32)
    if case == "skew":
        indices[:] = 0                               # every request: shard 0
    elif case == "partial_skew":
        indices[:m] = 5 * m + 17                     # shard 0 -> owner 5
    elif case == "2d":
        values = rng.integers(0, 100, (n, 3)).astype(np.int32)
        indices = rng.permutation(n).astype(np.int32)
    reads = tmesh.read_scalar.reads
    got, want = _gather_both(values, indices, p, fill=1234)
    assert np.array_equal(got, want)
    ok = (indices >= 0) & (indices < n)
    if values.ndim > 1:
        ok = ok[:, None]
    assert np.array_equal(
        got, np.where(ok, values[np.clip(indices, 0, n - 1)], 1234))
    # The routed path reads its overflow flag once; the ring reads none.
    assert tmesh.read_scalar.reads - reads == int(routed)


@pytest.mark.parametrize("p", SHARDS)
def test_dist_scatter_perm_matches_jax(p, rng):
    n = p * 512
    values = rng.integers(0, 10_000, n).astype(np.int32)
    dest = rng.permutation(n).astype(np.int32)
    want = _jax_run(
        lambda v, d: jgather.dist_scatter_perm(v, d, "seq", p), p, values,
        dest)
    vs, ds = _tshard(values, p), _tshard(dest, p)
    before = _snapshot(vs) + _snapshot(ds)
    got = _whole(dist_scatter_perm(vs, ds))
    expect = np.zeros(n, np.int32)
    expect[dest] = values
    assert np.array_equal(got, want) and np.array_equal(got, expect)
    assert _unchanged(before, vs + ds)


def test_dist_scatter_perm_tolerates_duplicate_destinations(rng):
    """A non-permutation (the validator's reject case) neither fails nor
    writes outside the real slots; missed slots stay 0."""
    p, n = 4, 4 * 256
    dest = rng.permutation(n).astype(np.int32)
    dest[:20] = dest[20]                       # 20 slots never written
    got = _whole(dist_scatter_perm(_tshard(np.ones(n, np.int32), p),
                                   _tshard(dest, p)))
    assert got.shape == (n,) and set(np.unique(got)) <= {0, 1}
    assert int((got == 0).sum()) == len(set(range(n)) - set(dest.tolist()))


# ---- the doubling builder --------------------------------------------------

@pytest.mark.parametrize("p", SHARDS)
def test_pack_local_matches_the_jax_fold(p, rng):
    """K1 per shard with the next shard's halo equals JAX's XLA fold."""
    n_real = p * 128 - 37
    text = np.zeros(p * 128, np.uint8)
    text[:n_real] = rng.integers(0, 4, n_real)
    text[5] = 0                                   # a real zero byte
    remap, bits, h0 = alphabet_remap(text[:n_real])
    jremap, jbits, jh0 = jax_alphabet_remap(text[:n_real])
    assert (bits, h0) == (jbits, jh0)
    want = _jax_run(
        lambda t: jax_pack_local(p, bits, h0, t, jnp.asarray(jremap),
                                 n_real), p, text)
    got = _pack_local(bits, h0, _tshard(text, p), remap, n_real)
    assert np.array_equal(_whole(got), want)
    assert PACK_BITS >= h0


@functools.cache
def _jax_sa(text: bytes, p: int):
    """JAX's sharded SA and its round count (once per text and mesh)."""
    mesh = jpar.make_mesh(p)
    sa = np.asarray(jpar.build_suffix_array_sharded(text, mesh))
    arr = np.frombuffer(text, np.uint8)
    n_pad = tmesh.padded_length(len(text), p)
    remap, bits, h0 = jax_alphabet_remap(arr)
    pad = np.zeros(n_pad, np.uint8)
    pad[:len(text)] = arr
    _, _, rounds = jax_from_bytes(mesh, bits, h0)(
        jax.device_put(pad, NamedSharding(mesh, SEQ)), jnp.asarray(remap),
        jnp.int32(len(text)))
    return sa, int(rounds)


def _check_sa(text: bytes, p: int):
    info: dict = {}
    reads = tmesh.read_scalar.reads
    sa = tpar.build_suffix_array_sharded(text, _tmesh(p), info=info)
    assert sa.dtype == torch.int32 and sa.device.type == "cpu"
    want, rounds = _jax_sa(text, p)
    assert np.array_equal(sa.numpy(), want)
    assert np.array_equal(sa.numpy(), suffix_array_oracle(text))
    assert info == {"path": "sharded_doubling", "rounds": rounds}
    # One host read per round: the replicated max rank.
    assert tmesh.read_scalar.reads - reads == rounds


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("name", sorted(CANONICAL))
def test_build_suffix_array_sharded_canonical(p, name):
    _check_sa(CANONICAL[name], p)


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("n", [1, 2, 7, 127, 1024, 4097])
def test_build_suffix_array_sharded_random(p, n):
    rng = np.random.default_rng(n)
    _check_sa(rng.integers(0, 256, n, dtype=np.uint8).tobytes(), p)


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("alphabet", [1, 2, 4])
def test_build_suffix_array_sharded_skewed_alphabets(p, alphabet):
    """Degenerate keys, including the all-zero-byte text (alphabet 1):
    the sort network does not care, and a real zero byte never mixes
    with the pad."""
    rng = np.random.default_rng(alphabet)
    _check_sa(rng.integers(0, alphabet, 3000, dtype=np.uint8).tobytes(), p)


def test_build_suffix_array_sharded_same_on_every_mesh_and_input_form():
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 64, 3000, dtype=np.uint8)
    want = suffix_array_oracle(arr)
    for p in SHARDS:
        got = tpar.build_suffix_array_sharded(arr, _tmesh(p))
        assert np.array_equal(got.numpy(), want)
    for text in (arr.tobytes(), torch.from_numpy(arr.copy())):
        got = tpar.build_suffix_array_sharded(text, _tmesh(2))
        assert np.array_equal(got.numpy(), want)
    assert tpar.build_suffix_array_sharded(b"", _tmesh(4)).shape == (0,)


def test_sort_keys_fit_their_live_bits():
    from hpc_suffix_array_tpu_torch.parallel.doubling import sort_live_bits

    assert sort_live_bits(1024) == [30, 31, 10]
    assert sort_live_bits(3 << 29) == [31, 31, 31]


@pytest.mark.parametrize("p", [1, 8])
def test_padded_length_stays_below_2_31(p):
    ok = (1 << 31) - (1 << 28)                  # pads to 15 * 2^27
    assert tmesh.padded_length(ok, p) == ok
    assert tmesh.padded_length(5, p) == p * 128
    with pytest.raises(ValueError, match="2\\^31"):
        tmesh.padded_length(ok + 1, p)
    # The builder refuses before it allocates anything.
    huge = np.broadcast_to(np.uint8(97), (1 << 31,))
    with pytest.raises(ValueError, match="2\\^31"):
        tpar.build_suffix_array_sharded(huge, _tmesh(p))


def test_bucket_size_matches_jax():
    from hpc_suffix_array_tpu.core.suffix_array import bucket_size

    for n in (1, 5, 127, 1000, 4097, 65_537, (1 << 28) + 3):
        for mult in (128, 512, 1024):
            assert tmesh.bucket_size(n, mult) == bucket_size(n, mult)


def test_build_sa_lcp_sharded_is_doubling_plus_plcp():
    info: dict = {}
    sa, lcp = tpar.build_sa_lcp_sharded(b"mississippi", _tmesh(2),
                                        info=info)
    assert sa.tolist() == [10, 7, 4, 1, 0, 9, 8, 6, 3, 5, 2]
    assert lcp.tolist() == [0, 1, 1, 4, 0, 0, 1, 0, 2, 1, 3]
    assert info["path"] == "sharded_doubling" and info["plcp_rounds"] >= 1
