"""Direct carried-keys builder of the port against the JAX package's.

Every input is made with numpy from a seed and goes through both
packages: the key words (K1 at a word offset) against JAX
``_direct_keys``, the builder's SA, LCP, chain mode, reruns and residue
count against JAX ``build_suffix_array_direct``, the gates, and the
routers with their thresholds lowered through the environment. All
comparisons are exact (tolerance 0: SA, LCP, keys and flags are
integers), and the SA and LCP are also held against SA-IS and Kasai.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpc_suffix_array_tpu as jsa
import hpc_suffix_array_tpu.core.bigsort as jbs
import hpc_suffix_array_tpu_torch as tsa
import hpc_suffix_array_tpu_torch.core.bigsort as tbs
import hpc_suffix_array_tpu_torch.core.residue as tres
from hpc_suffix_array_tpu.core import lcp as jlcp
from hpc_suffix_array_tpu.core.suffix_array import (
    alphabet_remap as jax_alphabet_remap)
from hpc_suffix_array_tpu_torch.core.oracle import (
    lcp_oracle, suffix_array_oracle)
from hpc_suffix_array_tpu_torch.kernels.post_sort import _high_bit

ALNUM = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
    np.uint8)
DNA = np.frombuffer(b"ACGT", np.uint8)
INFO_KEYS = ("chain_mode", "rerun", "n_patched", "periods")


def _rng(seed):
    return np.random.default_rng(seed)


def _deep_ties(seed=1):
    """200-byte block repeated 5 times: ties deeper than the residue
    window (the JAX package's test_direct_deep_ties_and_misprediction)."""
    rng = _rng(seed)
    text = ALNUM[rng.integers(0, 62, 40_000)]
    block = ALNUM[rng.integers(0, 62, 200)]
    for at in (500, 9000, 17500, 26000, 34000):
        text[at:at + 200] = block
    return text


def _uniform_delta(seed=2):
    """One long repeated block: a uniform tie delta that is not a global
    period (test_direct_uniform_delta_not_period)."""
    text = ALNUM[_rng(seed).integers(0, 62, 30_000)]
    text[15_000:15_300] = text[:300]
    return text


def _slot_zero(seed=3):
    """The two smallest suffixes tie through the window, so the residue
    patch targets SA slot 0 (test_residue_patch_at_slot_zero)."""
    rng = _rng(seed)
    bang = np.full(64, ord("!"), np.uint8)
    return np.concatenate([bang, ALNUM[rng.integers(0, 62, 200)],
                           ALNUM[rng.integers(0, 62, 30_000)],
                           bang, ALNUM[rng.integers(0, 62, 200)]])


CORPORA = {
    # the five classes of test_direct_all_corpus_classes
    "alnum": lambda: ALNUM[_rng(10).integers(0, 62, 50_000)],
    "bytes": lambda: _rng(11).integers(0, 256, 50_000).astype(np.uint8),
    "dna": lambda: DNA[_rng(12).integers(0, 4, 50_000)],
    "periodic": lambda: np.tile(ALNUM[_rng(13).integers(0, 62, 1000)],
                                51)[:50_000],
    "all_a": lambda: np.full(50_000, ord("a"), np.uint8),
    "deep_ties": _deep_ties,
    "uniform_delta": _uniform_delta,
    "slot_zero": _slot_zero,
    # minpad stress cases (TestMinpadPacking)
    "dna_min_tail": lambda: np.concatenate(
        [DNA[_rng(14).integers(0, 4, 4950)], np.full(50, DNA[0])]),
    "binary_byte0": lambda: np.concatenate(
        [_rng(15).integers(0, 2, 7970).astype(np.uint8),
         np.zeros(30, np.uint8)]),
    "sigma8_periodic": lambda: np.tile(np.concatenate(
        [np.arange(8, dtype=np.uint8) + 97,
         _rng(16).integers(0, 8, 5).astype(np.uint8) + 97]), 2000),
}


def _both_direct(text, want_lcp=True, **kw):
    """Run both builders; check SA (and LCP) equal each other and the
    oracles, and the meta keys equal. Returns the port's info."""
    ji, pi = {}, {}
    j_out = jbs.build_suffix_array_direct(text, info=ji, want_lcp=want_lcp,
                                          **kw)
    p_out = tbs.build_suffix_array_direct(text, device="cpu", info=pi,
                                          want_lcp=want_lcp, **kw)
    j_sa, j_lcp = j_out if want_lcp else (j_out, None)
    p_sa, p_lcp = p_out if want_lcp else (p_out, None)
    assert p_sa.dtype == torch.int32
    want = suffix_array_oracle(text)
    assert np.array_equal(p_sa.numpy(), np.asarray(j_sa))
    assert np.array_equal(p_sa.numpy(), want)
    if want_lcp:
        assert p_lcp.dtype == torch.int32
        assert np.array_equal(p_lcp.numpy(), np.asarray(j_lcp))
        assert np.array_equal(p_lcp.numpy(), lcp_oracle(text, want))
    for key in INFO_KEYS:
        assert pi.get(key) == ji.get(key), key
    return pi


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_direct_matches_jax(name):
    info = _both_direct(CORPORA[name]())
    assert info["n_words"] == 2


def test_direct_expected_modes():
    """The cases exercise what they are named for: chain mode on the
    periodic ones, the host residue on the tied ones, the rerun."""
    assert _both_direct(CORPORA["periodic"]())["chain_mode"]
    assert _both_direct(CORPORA["sigma8_periodic"]())["chain_mode"]
    assert _both_direct(_deep_ties())["n_patched"] > 0
    assert _both_direct(_slot_zero(), want_lcp=False)["n_patched"] > 0


def test_direct_forced_chain_refuses_irregular_ties():
    text = _deep_ties()
    with pytest.raises(NotImplementedError):
        jbs.build_suffix_array_direct(text, force_chain_mode=True)
    with pytest.raises(NotImplementedError):
        tbs.build_suffix_array_direct(text, device="cpu",
                                      force_chain_mode=True)


def test_direct_chain_misprediction_reruns(monkeypatch):
    """A low SA_CHAIN_EST_MIN makes a text with one repeated block look
    periodic: chain mode fails its period check and reruns ascending in
    both packages."""
    monkeypatch.setenv("SA_CHAIN_EST_MIN", "100")
    info = _both_direct(_uniform_delta())
    assert info["rerun"] == ["chain_to_ascending"]
    assert not info["chain_mode"]


@pytest.mark.parametrize("periodic", [False, True])
def test_direct_three_words(periodic):
    rng = _rng(20 + periodic)
    text = (np.tile(DNA[rng.integers(0, 4, 1000)], 40) if periodic
            else DNA[rng.integers(0, 4, 50_000)])
    info = _both_direct(text, n_words=3)
    assert info["n_words"] == 3
    assert info["chain_mode"] == periodic


def test_direct_auto_picks_third_word(monkeypatch):
    """A shrunken extraction cap makes 2 words infeasible on a binary
    alphabet under reserved-0 packing; both packages pick 3 words
    (TestThirdCarriedWord's auto case) and the build stays exact."""
    text = np.frombuffer(b"ab", np.uint8)[_rng(22).integers(0, 2, 50_000)]
    for mod in (jbs, tbs):
        monkeypatch.setattr(mod, "packing_mode", lambda remap: (2, 15,
                                                                False))
        monkeypatch.setattr(mod, "packing_from_sigma",
                            lambda sigma: (2, 15, False))
        monkeypatch.setattr(mod, "RESIDUE_SLOTS", 8)
    assert jbs.prepare_direct(text)["nw"] == 3
    state = tbs.prepare_direct(text, device="cpu")
    assert state["nw"] == 3
    for mod in (jbs, tbs):
        monkeypatch.setattr(mod, "RESIDUE_SLOTS", 1 << 15)
    sa = tbs.execute_direct(state)
    assert np.array_equal(sa.numpy(), suffix_array_oracle(text))


# --- the tie finish both builders share -----------------------------------

# name: (text, environment, forced chain mode, what the case exercises)
TIE_FINISH = {
    "no_ties": (CORPORA["alnum"], {}, None,
                lambda m: not m.get("n_patched")
                and "refine_members" not in m),
    "host_residue": (_deep_ties, {}, None,
                     lambda m: m["n_patched"] > 0
                     and "refine_members" not in m),
    "host_residue_at_slot_zero": (_slot_zero, {}, None,
                                  lambda m: m["n_patched"] > 0),
    "device_refinement": (_deep_ties, {"SA_HOST_RESIDUE_MAX": "8"}, None,
                          lambda m: m["refine_members"] > 0),
    "chain_verified": (CORPORA["periodic"], {}, None,
                       lambda m: m["chain_mode"]
                       and m["periods"] == [1000]),
    "chain_to_ascending": (_uniform_delta, {"SA_CHAIN_EST_MIN": "100"}, None,
                           lambda m: m["rerun"] == ["chain_to_ascending"]
                           and not m["chain_mode"]),
    "ascending_to_chain": (CORPORA["periodic"], {}, False,
                           lambda m: m["rerun"] == ["ascending_to_chain"]
                           and m["chain_mode"]),
    "forced_chain_refused": (_deep_ties, {}, True, None),
}


@pytest.mark.parametrize("case", sorted(TIE_FINISH))
def test_direct_and_msd_finish_ties_alike(monkeypatch, case):
    """The direct builder and the MSD builder (small chunks and buckets,
    so the ties fall in many buckets) take the same branch of their
    shared tie finish on the same text: SA and LCP equal SA-IS and
    Kasai in both, and ``rerun``, ``chain_mode`` and ``periods`` agree
    (the direct build sets ``periods`` only where it verified one)."""
    make, env, force, exercised = TIE_FINISH[case]
    monkeypatch.setenv("SA_CHUNK_ELEMS", "4096")
    monkeypatch.setenv("SA_TARGET_BUCKET", "4096")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    text = make()
    direct = tbs.prepare_direct(text, device="cpu")
    msd = tbs.prepare_big(text, device="cpu")
    runs = ((tbs.execute_direct, direct, direct["meta"]),
            (tbs.execute_big, msd, msd["plan"].meta))
    if exercised is None:
        for execute, state, _ in runs:
            with pytest.raises(NotImplementedError, match="bucket at slot"):
                execute(state, force_chain_mode=force, want_lcp=True)
        return
    want = suffix_array_oracle(text)
    for execute, state, meta in runs:
        sa, lcp = execute(state, force_chain_mode=force, want_lcp=True)
        assert np.array_equal(sa.numpy(), want)
        assert np.array_equal(lcp.numpy(), lcp_oracle(text, want))
        assert exercised(meta), meta
    (_, _, dm), (_, _, mm) = runs
    for key, empty in (("rerun", []), ("chain_mode", None),
                       ("periods", [])):
        assert dm.get(key, empty) == mm.get(key, empty), key


# --- K1 at a word offset against _direct_keys ---------------------------

@pytest.mark.parametrize("alphabet,n", [
    ("alnum", 1000), ("dna", 4099), ("binary", 777), ("bytes", 5000),
    ("sigma5", 64)])
@pytest.mark.parametrize("nw", [2, 3])
def test_direct_keys_match_jax(alphabet, n, nw):
    """Both packings: alnum and bytes reserved-0, dna and binary minpad
    (binary word 2 reads 89 positions past i), sigma 5 reserved."""
    rng = _rng(n + nw)
    text = {"alnum": lambda: ALNUM[rng.integers(0, 62, n)],
            "dna": lambda: DNA[rng.integers(0, 4, n)],
            "binary": lambda: rng.integers(0, 2, n).astype(np.uint8),
            "bytes": lambda: rng.integers(0, 256, n).astype(np.uint8),
            "sigma5": lambda: ALNUM[rng.integers(0, 5, n)]}[alphabet]()
    remap, _, _ = jax_alphabet_remap(text)
    bits, spw, minpad = tbs.packing_mode(remap)
    assert minpad == (alphabet in ("dna", "binary"))
    ext = np.zeros(n + nw * spw, np.uint8)
    ext[:n] = text
    want = jbs._direct_keys(
        n, spw, bits, jnp.asarray(ext),
        jnp.asarray(np.flatnonzero(remap > 0).astype(np.uint8)),
        jnp.int32(n), jbs.byte_ranges(remap), nw, minpad)[:nw]
    got = tbs.direct_keys(torch.from_numpy(text), remap, bits, spw, nw,
                          minpad)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


# --- gates ----------------------------------------------------------------

def test_packing_and_depth_gates_match_jax():
    for sigma in range(0, 300):
        assert tbs.packing_from_sigma(sigma) == jbs.packing_from_sigma(sigma)
        assert tbs.carried_depth_syms(sigma) == jbs.carried_depth_syms(sigma)
    for est in range(0, 100):
        assert tbs.deep_repeat_class(est) == jbs.deep_repeat_class(est)


@pytest.mark.parametrize("env", [None, "100"])
def test_chain_plausible_matches_jax(monkeypatch, env):
    if env is not None:
        monkeypatch.setenv("SA_CHAIN_EST_MIN", env)
    for est in (0, 8, 99, 100, 512, 3071, 3072, 4096):
        for n in (10, 400, 4000, 20_000, 1 << 28):
            assert tbs.chain_plausible(est, n) == jbs.chain_plausible(est, n)


def test_residue_feasible_sigma_matches_jax():
    for sigma in (1, 2, 4, 5, 26, 62, 256):
        for n in (1 << 10, 1 << 20, 1 << 24, 1 << 28, 1 << 30):
            for cap in (2.0, 8192.0):
                for est in (0, 20, 5000):
                    for words in (2, 3):
                        args = (sigma, n, cap, est, words)
                        assert (tbs.residue_feasible_sigma(*args)
                                == jbs.residue_feasible_sigma(*args)), args


@pytest.mark.parametrize("name", ["alnum", "dna", "periodic", "deep_ties",
                                  "all_a", "binary"])
def test_text_gates_match_jax(monkeypatch, name):
    """The gates agree with the JAX package's at the same thresholds. The
    crossover is read from ``SA_DIRECT_CROSS`` in both packages; its
    defaults differ (2^27 measured on a TPU v5e, the port's
    ``DIRECT_CROSS`` on an H100), so the JAX default is set for both."""
    text = (np.frombuffer(b"ab", np.uint8)[_rng(30).integers(0, 2, 4096)]
            if name == "binary" else
            _deep_ties() if name == "deep_ties" else CORPORA[name]())
    n = len(text)
    assert tbs.estimate_repeat_len(text) == jbs.estimate_repeat_len(text)
    monkeypatch.setenv("SA_DIRECT_CROSS", str(1 << 27))
    for claimed in (n, 1 << 26, 1 << 28, (1 << 28) + 1):
        for words in (2, 3):
            assert (tbs.residue_feasible(text, claimed, 8192.0, words=words)
                    == jbs.residue_feasible(text, claimed, 8192.0,
                                            words=words))
        for fn in ("direct_feasible", "prefer_direct"):
            assert (getattr(tbs, fn)(text, claimed)
                    == getattr(jbs, fn)(text, claimed)), (fn, claimed)
    monkeypatch.delenv("SA_DIRECT_CROSS")
    for claimed in (n, 1 << 26, 1 << 28, (1 << 28) + 1):
        assert (tbs.prefer_direct(text, claimed)
                == (tbs.direct_feasible(text, claimed)
                    and (claimed <= tbs.DIRECT_CROSS or tbs.chain_plausible(
                        tbs.estimate_repeat_len(text), claimed))))


def test_high_bit_exact():
    vals = [1, 2, 3, 7, 8, (1 << 30) - 1, 1 << 30, (1 << 31) - 1, -1,
            -(1 << 31), 12345, 1 << 16, (1 << 16) - 1]
    got = _high_bit(torch.tensor(vals, dtype=torch.int32)).tolist()
    want = [31 if v < 0 else v.bit_length() - 1 for v in vals]
    assert got == want


def test_apply_patch_drops_pad_slots():
    """A real patch at slot 0 beside -1 pad slots: the pads are dropped,
    never written to slot 0."""
    sa = torch.arange(10, dtype=torch.int32)
    slots = torch.tensor([0, 1, -1, -1, 5], dtype=torch.int64)
    vals = torch.tensor([1, 0, 7, 8, 9], dtype=torch.int32)
    out = tres.apply_patch(sa, slots, vals)
    assert out.tolist() == [1, 0, 2, 3, 4, 9, 6, 7, 8, 9]


# --- routers --------------------------------------------------------------

def test_build_suffix_array_routes_direct(monkeypatch):
    monkeypatch.setenv("SA_BIG_THRESHOLD", "10000")
    text = _rng(40).integers(0, 256, 20_000).astype(np.uint8)
    info = {}
    sa = tsa.build_suffix_array(text, device="cpu", info=info)
    assert info["path"] == "direct"
    assert np.array_equal(sa.numpy(), np.asarray(jsa.build_suffix_array(text)))
    assert np.array_equal(sa.numpy(), suffix_array_oracle(text))


def test_build_suffix_array_decline_falls_back_to_doubling(monkeypatch):
    """Both carried-keys builders decline: doubling closes, as in JAX."""
    monkeypatch.setenv("SA_BIG_THRESHOLD", "10000")

    def declines(*a, **kw):
        raise NotImplementedError("synthetic degenerate-text refusal")

    monkeypatch.setattr(tbs, "build_suffix_array_direct", declines)
    monkeypatch.setattr(tbs, "build_suffix_array_big", declines)
    text = _rng(41).integers(0, 256, 20_000).astype(np.uint8)
    info = {}
    sa = tsa.build_suffix_array(text, device="cpu", info=info)
    assert info["path"] == "doubling"
    assert "synthetic" in info["declined"]
    assert np.array_equal(sa.numpy(), np.asarray(jsa.build_suffix_array(text)))


@pytest.mark.parametrize("n", [5_000, 20_000])
def test_build_sa_lcp_matches_jax(monkeypatch, n):
    """Below and above the lowered SA_LCP_BIG_MIN."""
    monkeypatch.setenv("SA_LCP_BIG_MIN", "10000")
    text = ALNUM[_rng(n).integers(0, 62, n)]
    info = {}
    sa, lcp = tsa.build_sa_lcp(text, device="cpu", info=info)
    j_sa, j_lcp = jlcp.build_sa_lcp(text)
    assert np.array_equal(sa.numpy(), np.asarray(j_sa))
    assert np.array_equal(lcp.numpy(), np.asarray(j_lcp))
    assert info["path"] == ("direct" if n > 10_000 else "doubling")


def test_build_sa_lcp_decline_tries_direct_once(monkeypatch):
    """A text both carried-keys builders decline goes straight to
    doubling and PLCP, without a second attempt of either from the SA or
    LCP router."""
    monkeypatch.setenv("SA_LCP_BIG_MIN", "10000")
    calls = []

    def declines(*a, **kw):
        calls.append(1)
        raise NotImplementedError("synthetic refusal")

    monkeypatch.setattr(tbs, "build_suffix_array_direct", declines)
    monkeypatch.setattr(tbs, "build_suffix_array_big", declines)
    text = ALNUM[_rng(42).integers(0, 62, 20_000)]
    info = {}
    sa, lcp = tsa.build_sa_lcp(text, device="cpu", info=info)
    assert len(calls) == 2 and info["path"] == "doubling"
    want = suffix_array_oracle(text)
    assert np.array_equal(sa.numpy(), want)
    assert np.array_equal(lcp.numpy(), lcp_oracle(text, want))


def test_build_lcp_array_big_route_checks_sa(monkeypatch):
    monkeypatch.setenv("SA_LCP_BIG_MIN", "10000")
    text = ALNUM[_rng(43).integers(0, 62, 20_000)]
    sa = suffix_array_oracle(text)
    info = {}
    lcp = tsa.build_lcp_array(text, sa, device="cpu", info=info)
    assert info["lcp_path"] == "direct"
    assert np.array_equal(lcp.numpy(),
                          np.asarray(jsa.build_lcp_array(text, sa)))
    wrong = sa.copy()
    wrong[0], wrong[1] = sa[1], sa[0]
    with pytest.raises(ValueError, match="not the suffix array"):
        tsa.build_lcp_array(text, wrong, device="cpu")
    with pytest.raises(ValueError, match="not the suffix array"):
        jsa.build_lcp_array(text, wrong)


def test_build_lcp_array_deep_repeat_route():
    """16 KiB < n <= 4 MiB with a deep repeat: both packages take the
    carried-keys chain build for the LCP (default thresholds)."""
    text = np.tile(ALNUM[_rng(44).integers(0, 62, 1000)], 20)
    sa = suffix_array_oracle(text)
    info = {}
    lcp = tsa.build_lcp_array(text, sa, device="cpu", info=info)
    assert info["lcp_path"] == "direct"
    assert np.array_equal(lcp.numpy(),
                          np.asarray(jsa.build_lcp_array(text, sa)))
    assert np.array_equal(lcp.numpy(), lcp_oracle(text, sa))
    # Below SA_LCP_CHAIN_MIN the same text takes PLCP.
    small = text[:10_000]
    info = {}
    tsa.build_lcp_array(small, suffix_array_oracle(small), device="cpu",
                        info=info)
    assert info["lcp_path"] == "plcp"
