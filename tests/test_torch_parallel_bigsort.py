"""The port's sharded carried-keys builder against the JAX package's.

Mirrors ``tests/test_parallel_bigsort.py`` (its host-text cases): the
JAX side runs ``build_suffix_array_sharded_big`` on P of the 8 virtual
CPU devices of ``tests/conftest.py``, the port on P shards of the one
CPU (``make_mesh(P, devices=["cpu"])``). Texts are numpy arrays from
fixed seeds; every comparison is exact, against the JAX package and
against the oracles. Each JAX build runs once per module.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpc_suffix_array_tpu.parallel as jpar
import hpc_suffix_array_tpu.parallel.bigsort as jbig
import hpc_suffix_array_tpu_torch.parallel as tpar
import hpc_suffix_array_tpu_torch.parallel.bigsort as tbig
from hpc_suffix_array_tpu.core.bigsort import byte_ranges
from hpc_suffix_array_tpu.parallel.mesh import sequence_sharding
from hpc_suffix_array_tpu_torch.core.bigsort import packing_mode
from hpc_suffix_array_tpu_torch.core.oracle import (
    lcp_oracle, suffix_array_oracle)
from hpc_suffix_array_tpu_torch.core.suffix_array import alphabet_remap
from hpc_suffix_array_tpu_torch.kernels import launch_counts
from hpc_suffix_array_tpu_torch.kernels.radix import (
    _histograms_reference, _split_histograms, pass_plan, radix_sort_words,
    radix_sort_words_reference)
from hpc_suffix_array_tpu_torch.parallel import mesh as tmesh
from hpc_suffix_array_tpu_torch.parallel.bitonic import block_bitonic_sort

SHARDS = [1, 2, 4, 8]
ALNUM = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
    np.uint8)
DNA = np.frombuffer(b"ACGT", np.uint8)


def _rng(seed):
    return np.random.default_rng(seed)


def _alnum(n, seed):
    return ALNUM[_rng(seed).integers(0, 62, n)].copy()


def _residue():
    t = _alnum(8 * 1024, 3)
    t[500:600] = t[3000:3100]             # one 100-byte repeat
    t[7000:7040] = t[1000:1040]           # one 40-byte repeat
    return t


def _odd_n():
    """n not a multiple of P*128, with a repeat that ends at the text's
    end (ties against a suffix running into the pad rows)."""
    t = _alnum(5003, 4)
    t[-50:] = t[100:150]
    return t


def _straddle():
    """48 copies of a 40-byte block: 31 tied groups of 48 rows each,
    spread over the sorted order; with this block a group crosses a
    shard boundary at P = 2, 4 and 8."""
    t = _alnum(8 * 1024, 5)
    block = _alnum(40, 16)
    for at in range(100, 100 + 48 * 160, 160):
        t[at:at + 40] = block
    return t


def _slot0():
    """The smallest suffixes tie through the carried window: a tied
    group at global sorted slot 0."""
    t = _alnum(8 * 1024, 7)
    t[:40] = ord("!")
    t[4000:4040] = ord("!")
    return t


def _dna_min_tail():
    t = DNA[_rng(8).integers(0, 4, 8 * 1024)].copy()
    t[-40:] = ord("A")
    return t


CASES = {
    "alnum": lambda: _alnum(8 * 1024, 1),
    "bytes": lambda: _rng(2).integers(0, 256, 3 * 1024).astype(np.uint8),
    "dna": lambda: DNA[_rng(9).integers(0, 4, 8 * 1024)],
    "periodic_chain": lambda: np.tile(_alnum(1000, 10), 9)[:8 * 1024],
    "all_same_char": lambda: np.full(4 * 1024, ord("a"), np.uint8),
    "short_period": lambda: np.frombuffer(b"ab" * (2 * 1024), np.uint8),
    "residue": _residue,
    "odd_n": _odd_n,
    "straddle": _straddle,
    "slot0": _slot0,
    "dna_min_tail": _dna_min_tail,
    "binary_chain": lambda: np.tile(
        np.frombuffer(b"0110100110010110", np.uint8), 256),
}


@functools.cache
def _text(name: str) -> np.ndarray:
    t = np.ascontiguousarray(CASES[name]())
    t.setflags(write=False)
    return t


@functools.cache
def _oracles(name: str):
    t = _text(name)
    sa = suffix_array_oracle(t)
    return sa, lcp_oracle(t, sa)


@functools.cache
def _jmesh(p: int):
    return jpar.make_mesh(p)


def _tmesh(p: int):
    return tpar.make_mesh(p, devices=["cpu"])


@functools.cache
def _jax_big(name: str, p: int):
    """The JAX package's (sa, lcp), or the NotImplementedError text."""
    try:
        sa, lcp = jbig.build_suffix_array_sharded_big(
            _text(name), _jmesh(p), want_lcp=True)
    except NotImplementedError as e:
        return str(e)
    return np.asarray(sa), np.asarray(lcp)


def _check(name: str, p: int, want_lcp: bool, **kw):
    info: dict = {}
    reads = tmesh.read_scalar.reads
    out = tbig.build_suffix_array_sharded_big(
        _text(name), _tmesh(p), want_lcp=want_lcp, info=info, **kw)
    sa, lcp = out if want_lcp else (out, None)
    dtype = torch.int64 if kw.get("wide_index") else torch.int32
    assert sa.dtype == dtype and sa.device.type == "cpu"
    want_sa, want_lcp_arr = _oracles(name)
    jax_sa, jax_lcp = _jax_big(name, p)
    assert np.array_equal(sa.numpy(), want_sa)
    assert np.array_equal(sa.numpy(), jax_sa)
    if want_lcp:
        assert lcp.dtype == dtype
        assert np.array_equal(lcp.numpy(), want_lcp_arr)
        assert np.array_equal(lcp.numpy(), jax_lcp)
    # One host read of the reduced stats per distributed sort.
    assert tmesh.read_scalar.reads - reads == info["msd_sorts"] >= 1
    return info


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_sa_lcp_match_jax_and_oracles(name, p):
    _check(name, p, want_lcp=True)


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_sa_alone_matches_jax_and_oracle(name, p):
    _check(name, p, want_lcp=False)


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_forced_wide_equals_narrow_as_int64(name, p):
    """int64 indices, tiebreak read unsigned: the narrow arrays cast to
    int64, with and without the LCP."""
    mesh = _tmesh(p)
    sa_w, lcp_w = tbig.build_suffix_array_sharded_big(
        _text(name), mesh, wide_index=True, want_lcp=True)
    sa_n, lcp_n = tbig.build_suffix_array_sharded_big(
        _text(name), mesh, wide_index=False, want_lcp=True)
    assert sa_w.dtype == lcp_w.dtype == torch.int64
    assert torch.equal(sa_w, sa_n.long()) and torch.equal(lcp_w, lcp_n.long())
    sa_only = tbig.build_suffix_array_sharded_big(_text(name), mesh,
                                                  wide_index=True)
    assert torch.equal(sa_only, sa_w)


def test_routes_of_the_cases():
    """The cases take the paths they are meant to: chain mode, an
    ascending residue, a chain misprediction rerun, minpad packing."""
    want = {"alnum": (False, 1), "periodic_chain": (True, 1),
            "residue": (False, 2), "straddle": (False, 2),
            "binary_chain": (True, 1), "all_same_char": (True, 1)}
    for name, (chain, sorts) in want.items():
        info: dict = {}
        tbig.build_suffix_array_sharded_big(_text(name), _tmesh(4),
                                            info=info)
        assert (info["chain_mode"], info["msd_sorts"]) == (chain, sorts), name
    assert packing_mode(alphabet_remap(_text("dna_min_tail"))[0])[2]


@pytest.mark.parametrize("p", [2, 4, 8])
def test_straddle_groups_cross_shard_boundaries(p):
    """The straddle case holds a tied group (rows equal through the 10
    carried symbols) on both sides of a sorted shard boundary, and the
    slot0 case one that starts at global slot 0."""
    _, lcp = _oracles("straddle")
    n = len(lcp)
    m = tmesh.bucket_size(n, p * 128) // p
    tied = lcp >= 10                 # row j ties with row j - 1
    assert any(tied[b] for b in range(m, n, m))
    _, lcp0 = _oracles("slot0")
    assert lcp0[1] >= 10


@pytest.mark.parametrize("p", SHARDS)
def test_irregular_heavy_ties_equal_or_refused_in_both(p):
    """Mostly periodic text with a corrupted tail: the result is exact
    or both packages raise NotImplementedError."""
    base = _alnum(8, 11)
    text = np.tile(base, 1024)[:8 * 1024].copy()
    text[-100:] = _alnum(100, 12)
    try:
        want = np.asarray(jbig.build_suffix_array_sharded_big(text,
                                                              _jmesh(p)))
    except NotImplementedError:
        with pytest.raises(NotImplementedError):
            tbig.build_suffix_array_sharded_big(text, _tmesh(p))
        return
    got = tbig.build_suffix_array_sharded_big(text, _tmesh(p))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), suffix_array_oracle(text))


def _two_periods():
    """Two periodic halves (periods 7 and 11): the chain attempt sees
    non-uniform deltas on more than a quarter of the text and refuses."""
    return np.concatenate([np.tile(_alnum(7, 13), 600)[:4096],
                           np.tile(_alnum(11, 14), 400)[:4096]])


@pytest.mark.parametrize("p", [1, 4])
def test_two_periods_refused_in_both(p):
    text = _two_periods()
    for build, mesh in ((jbig.build_suffix_array_sharded_big, _jmesh(p)),
                        (tbig.build_suffix_array_sharded_big, _tmesh(p))):
        with pytest.raises(NotImplementedError):
            build(text, mesh)


@pytest.mark.parametrize("p", SHARDS)
def test_dna_forced_to_the_third_word(p, monkeypatch):
    """A residue gate that refuses two words puts DNA on three, narrow
    and wide, with the LCP (the JAX test's monkeypatch)."""
    real = tbig.residue_feasible
    assert real(_text("dna"), 8 * 1024, 8 * (1 << 15) / 4)
    for mod in (tbig, jbig):
        monkeypatch.setattr(mod, "residue_feasible",
                            lambda *a, words=2, **k: words >= 3)
    dna = _text("dna")
    want = suffix_array_oracle(dna)
    want_l = lcp_oracle(dna, want)
    jsa, jlcp = jbig.build_suffix_array_sharded_big(dna, _jmesh(p),
                                                    want_lcp=True)
    info: dict = {}
    sa, lcp = tbig.build_suffix_array_sharded_big(dna, _tmesh(p),
                                                  want_lcp=True, info=info)
    assert info["n_words"] == 3
    for got in (sa.numpy(), np.asarray(jsa)):
        assert np.array_equal(got, want)
    for got in (lcp.numpy(), np.asarray(jlcp)):
        assert np.array_equal(got, want_l)
    sa_w, lcp_w = tbig.build_suffix_array_sharded_big(
        dna, _tmesh(p), wide_index=True, want_lcp=True)
    assert np.array_equal(sa_w.numpy(), want.astype(np.int64))
    assert np.array_equal(lcp_w.numpy(), want_l)


def test_minpad_dna_stays_two_words(monkeypatch):
    """Under minpad packing DNA's two words carry 30 symbols: the third
    word is not chosen."""
    seen = {}
    real = tbig._local_build

    def spy(bits, spw, R, nw, minpad, *rest, **kw):
        seen.update(bits=bits, spw=spw, nw=nw, minpad=minpad)
        return real(bits, spw, R, nw, minpad, *rest, **kw)

    monkeypatch.setattr(tbig, "_local_build", spy)
    sa = tbig.build_suffix_array_sharded_big(_text("dna"), _tmesh(8))
    assert np.array_equal(sa.numpy(), _oracles("dna")[0])
    assert seen == dict(bits=2, spw=15, nw=2, minpad=True)


def test_wide_auto_boundary():
    for wide_auto in (tbig.wide_auto, jbig.wide_auto):
        assert not wide_auto((1 << 31) - 2)
        assert wide_auto((1 << 31) - 1)
        assert wide_auto(1 << 31)
        assert wide_auto((1 << 31) + (1 << 28))


def test_length_checks():
    """Below 8 bytes the builder refuses; forced narrow indices need a
    padded length below 2^31 and wide ones below 2^32 (checked before
    anything is allocated)."""
    with pytest.raises(ValueError, match="n >= 8"):
        tbig.build_suffix_array_sharded_big(b"abc", _tmesh(2))
    with pytest.raises(ValueError, match="2\\^31"):
        tbig._build_narrow(types.SimpleNamespace(n=1 << 31, P=2), *[None] * 8)
    huge = np.broadcast_to(np.uint8(97), (1 << 32,))
    with pytest.raises(ValueError, match="2\\^32"):
        tbig._HostText(huge, _tmesh(4))


# --- the shard-local pieces against the JAX kernels ---------------------

@functools.cache
def _jax_kernels(name: str, p: int, chain: bool):
    """The JAX ``_kernels`` outputs (s_idx, lcp, slots, res_idx, stats)
    on the text's own plan."""
    text = _text(name)
    n = len(text)
    remap, _, _ = alphabet_remap(text)
    bits, spw, minpad = packing_mode(remap)
    mesh = _jmesh(p)
    n_pad = tmesh.bucket_size(n, p * 128)
    pad = np.zeros(n_pad, np.uint8)
    pad[:n] = text
    kern = jbig._kernels(mesh, bits, spw, byte_ranges(remap), 2, minpad)
    out = kern(jax.device_put(pad, sequence_sharding(mesh)),
               jnp.asarray(np.flatnonzero(remap > 0).astype(np.uint8)),
               jnp.int32(n), jnp.bool_(chain))
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("name,chain", [
    ("alnum", False), ("residue", False), ("straddle", False),
    ("slot0", False), ("periodic_chain", True), ("dna_min_tail", False),
    ("dna_min_tail", True), ("odd_n", False)])
def test_local_build_matches_jax_kernels(name, chain, p):
    """One sort's rows, LCP, stats (tie count, delta max and min,
    residue total, overflow) and residue compaction equal the JAX
    ``_kernels`` outputs on the same text."""
    text = _text(name)
    n = len(text)
    remap, _, _ = alphabet_remap(text)
    bits, spw, minpad = packing_mode(remap)
    n_pad = tmesh.bucket_size(n, p * 128)
    texts = tpar.doubling.padded_shards(text, n_pad, _tmesh(p))
    R = tbig.RESIDUE_SLOTS
    s_idx, lcp, members, stats = tbig._local_build(
        bits, spw, R, 2, minpad, texts, remap, n, chain)
    j_s, j_lcp, j_slots, j_idx, j_stats = _jax_kernels(name, p, chain)
    assert np.array_equal(tmesh.unshard(s_idx).numpy(), j_s)
    assert np.array_equal(tmesh.unshard(lcp).numpy(), j_lcp)
    assert stats.tolist()[:5] == j_stats.tolist()[:5]
    slots, idx = tbig._residue(members, s_idx, R)
    for me in range(p):
        keep = j_slots[me * R:(me + 1) * R] >= 0
        assert np.array_equal(slots[me].numpy(),
                              j_slots[me * R:(me + 1) * R][keep])
        assert np.array_equal(idx[me].numpy(),
                              j_idx[me * R:(me + 1) * R][keep])


def test_boundary_prev_and_pmin():
    cols = [tmesh.shard(np.arange(16, dtype=np.int32), _tmesh(4)),
            tmesh.shard(np.arange(16, dtype=np.int32) * 10, _tmesh(4))]
    got = tbig._boundary_prev(cols)
    assert [g.tolist() for g in got] == [[0, 0], [3, 30], [7, 70],
                                         [11, 110]]
    vals = [torch.tensor([3, -1]), torch.tensor([2, 5])]
    assert [v.tolist() for v in tmesh.pmin(vals)] == [[2, -1]] * 2


def test_group_patches_by_shard_and_pads():
    """Patches land in their owners' R rows; -1 pads are dropped, never
    clamped to slot 0 (the duplicate-scatter fault)."""
    ps, pv = tbig._group_patches(np.array([0, 5, 9, 2]),
                                 np.array([70, 71, 72, 73]), 2, 8, 3)
    assert ps.tolist() == [0, 5, 2, 1, -1, -1]
    assert pv.tolist() == [70, 71, 73, 72, 0, 0]
    col = [torch.full((8,), -9, dtype=torch.int32) for _ in range(2)]
    tbig._patch(col, ps, pv, 3)
    assert col[0].tolist() == [70, -9, 73, -9, -9, 71, -9, -9]
    assert col[1].tolist() == [-9, 72, -9, -9, -9, -9, -9, -9]


def test_key_lcp_first_mismatch_depth():
    """xor and the highest set bit give the first differing symbol; equal
    words keep the nw*spw bound; a pad word's top bit clamps to 0."""
    bits, spw = 6, 5
    a = torch.tensor([(1 << 24) | 5, 7, 7, tbig.PAD_KEY], dtype=torch.int32)
    b = torch.tensor([(2 << 24) | 5, 7, 6, 1], dtype=torch.int32)
    lcp = tbig._key_lcp([a, a], [b, b], spw, bits, 2)
    assert lcp.tolist() == [0, 10, 4, 0]


# --- the keys-only sort -----------------------------------------------------

@pytest.mark.parametrize("nw", [1, 3, 4])
def test_keys_only_radix_sort_matches_lexsort(nw):
    rng = _rng(nw)
    n = 3000
    words = [rng.integers(0, 4, n).astype(np.int32) for _ in range(nw - 1)]
    words.append(rng.permutation(n).astype(np.int32))
    cols = [torch.from_numpy(w.copy()) for w in words]
    got, payload = radix_sort_words(cols, None, 31)
    assert payload is None and all(g is c for g, c in zip(got, cols))
    order = np.lexsort(words[::-1])
    for g, w in zip(got, words):
        assert np.array_equal(g.numpy(), w[order])
    ref = radix_sort_words_reference(
        [torch.from_numpy(w.copy()) for w in words], None, 31)[0]
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


def test_keys_only_sort_takes_at_most_four_words():
    """A pass carries four columns: four keys alone, or three beside a
    payload."""
    cols = [torch.zeros(8, dtype=torch.int32) for _ in range(5)]
    for fn in (radix_sort_words, radix_sort_words_reference):
        with pytest.raises(ValueError):
            fn(cols, None, 31)
        with pytest.raises(ValueError):
            fn(cols[:4], cols[4], 31)


def test_four_word_histograms_split_in_plan_order():
    """Four key words are counted in two launches (at most three words
    each) whose rows follow ``pass_plan``."""
    rng = _rng(5)
    words = [torch.from_numpy(rng.integers(0, 1 << 31, 500).astype(
        np.int32)) for _ in range(4)]
    per_word = [31, 20, 9, 31]
    want = _histograms_reference(words, pass_plan(per_word, 8), 8)
    assert torch.equal(_split_histograms(words, per_word, 8), want)


@pytest.mark.parametrize("p", [2, 8])
def test_keys_only_bitonic_sort(p):
    rng = _rng(p)
    n = p * 256
    keys = np.stack([rng.integers(0, 3, n), rng.integers(0, 5, n),
                     rng.permutation(n)]).astype(np.int32)
    blocks = [torch.from_numpy(keys[:, i * 256:(i + 1) * 256].copy())
              for i in range(p)]
    before = [b.clone() for b in blocks]
    out = block_bitonic_sort(blocks, 3, [2, 3, 12])
    got = torch.cat(out, dim=1).numpy()
    assert np.array_equal(got, keys[:, np.lexsort(keys[::-1])])
    assert all(torch.equal(b, a) for b, a in zip(blocks, before))
    with pytest.raises(ValueError):
        block_bitonic_sort(blocks, 1, 12)


# --- the routers ----------------------------------------------------------

def _jax_info_sa(text, p, msd):
    info: dict = {}
    sa = jpar.build_suffix_array_sharded(text, _jmesh(p), info=info,
                                         msd=msd)
    return info["path"], np.asarray(sa)


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("msd", [None, True, False])
@pytest.mark.parametrize("name", ["alnum", "periodic_chain", "two_periods"])
def test_build_suffix_array_sharded_takes_the_jax_path(name, msd, p,
                                                       monkeypatch):
    monkeypatch.setenv("SA_SHARDED_MSD_MIN", "4096")
    text = _two_periods() if name == "two_periods" else _text(name)
    info: dict = {}
    sa = tpar.build_suffix_array_sharded(text, _tmesh(p), info=info,
                                         msd=msd)
    path, want = _jax_info_sa(text, p, msd)
    assert info["path"] == path
    assert np.array_equal(sa.numpy(), want)
    assert np.array_equal(sa.numpy(), suffix_array_oracle(text))
    expect = ("sharded_msd" if msd is not False and name != "two_periods"
              else "sharded_doubling")
    assert path == expect


def test_deep_repeat_gate_below_the_msd_minimum(monkeypatch):
    """Below SA_SHARDED_MSD_MIN, deep-repeat texts from
    SA_SHARDED_CHAIN_MIN take the carried keys in both packages; random
    text does not."""
    monkeypatch.setenv("SA_SHARDED_CHAIN_MIN", "4096")
    for name, path in (("periodic_chain", "sharded_msd"),
                       ("alnum", "sharded_doubling")):
        info: dict = {}
        tpar.build_suffix_array_sharded(_text(name), _tmesh(2), info=info)
        assert info["path"] == _jax_info_sa(_text(name), 2, None)[0] == path


def _count_big(monkeypatch):
    """Counts calls of each package's build_suffix_array_sharded_big
    (with their want_lcp) through every name the routers use."""
    calls = {"jax": [], "torch": []}
    for key, mods in (("jax", (jbig, jpar)), ("torch", (tbig, tpar))):
        real = mods[0].build_suffix_array_sharded_big

        def spy(*a, _real=real, _key=key, **k):
            calls[_key].append(bool(k.get("want_lcp")))
            return _real(*a, **k)

        for mod in mods:
            monkeypatch.setattr(mod, "build_suffix_array_sharded_big", spy)
    return calls


@pytest.mark.parametrize("lcp_min", ["1000000", "4096"])
@pytest.mark.parametrize("name", ["alnum", "two_periods"])
def test_build_sa_lcp_sharded_tries_once_as_jax(name, lcp_min, monkeypatch):
    """The fused router tries one carried-keys pass; after a refusal the
    doubling builder does not try it again (msd=False), and the LCP
    reroute tries it once more only above SA_LCP_BIG_MIN, as in the JAX
    package."""
    monkeypatch.setenv("SA_SHARDED_MSD_MIN", "4096")
    monkeypatch.setenv("SA_LCP_BIG_MIN", lcp_min)
    calls = _count_big(monkeypatch)
    text = _two_periods() if name == "two_periods" else _text(name)
    info: dict = {}
    sa, lcp = tpar.build_sa_lcp_sharded(text, _tmesh(4), info=info)
    j_info: dict = {}
    jsa, jlcp = jpar.build_sa_lcp_sharded(text, _jmesh(4), info=j_info)
    assert calls["torch"] == calls["jax"]
    assert info["path"] == j_info["path"]
    want = suffix_array_oracle(text)
    assert np.array_equal(sa.numpy(), want)
    assert np.array_equal(np.asarray(jsa), want)
    assert np.array_equal(lcp.numpy(), lcp_oracle(text, want))
    if name == "alnum":
        assert calls["torch"] == [True] and info["path"] == "sharded_msd"
    else:
        assert info["path"] == "sharded_doubling"
        assert calls["torch"] == [True] * (2 if lcp_min == "4096" else 1)


@pytest.mark.parametrize("name", ["alnum", "residue", "periodic_chain"])
def test_build_lcp_array_sharded_reroutes_above_lcp_big_min(name,
                                                            monkeypatch):
    monkeypatch.setenv("SA_LCP_BIG_MIN", "4096")
    calls = _count_big(monkeypatch)
    text = _text(name)
    want_sa, want_lcp = _oracles(name)
    info: dict = {}
    lcp = tpar.build_lcp_array_sharded(text, torch.from_numpy(want_sa),
                                       _tmesh(2), info=info)
    jlcp = jpar.build_lcp_array_sharded(text, want_sa, _jmesh(2))
    assert calls["torch"] == calls["jax"] == [True]
    assert "plcp_rounds" not in info
    assert np.array_equal(lcp.numpy(), want_lcp)
    assert np.array_equal(np.asarray(jlcp), want_lcp)


def test_tensor_input_matches_host_input():
    """A uint8 tensor (what the CLI hands over) builds the same arrays as
    the host bytes."""
    text = _text("residue")
    mesh = _tmesh(4)
    sa, lcp = tbig.build_suffix_array_sharded_big(
        torch.from_numpy(text.copy()), mesh, want_lcp=True)
    want_sa, want_lcp = _oracles("residue")
    assert np.array_equal(sa.numpy(), want_sa)
    assert np.array_equal(lcp.numpy(), want_lcp)


# --- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["alnum", "residue", "periodic_chain",
                                  "dna_min_tail", "odd_n"])
def test_four_shards_on_card_match_cpu(name):
    """P = 4 shards on the card (K1 once per shard and sort, the onesweep
    sort) against the same build on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    text = _text(name)
    info: dict = {}
    before = launch_counts()["pack_words"]
    sa, lcp = tbig.build_suffix_array_sharded_big(
        torch.from_numpy(text.copy()).cuda(),
        tpar.make_mesh(4, devices=["cuda:0"]), want_lcp=True, info=info)
    assert launch_counts()["pack_words"] - before == 4 * info["msd_sorts"]
    c_sa, c_lcp = tbig.build_suffix_array_sharded_big(
        text, _tmesh(4), want_lcp=True)
    assert torch.equal(sa.cpu(), c_sa) and torch.equal(lcp.cpu(), c_lcp)
