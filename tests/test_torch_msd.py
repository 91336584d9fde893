"""MSD bucket builder of the port against the JAX package's.

Every input is made with numpy from a seed and goes through both
packages at the TINY geometry of ``tests/test_bigsort.py`` (buckets,
chunks and the edge sample of 2^12), so every build runs many chunks and
buckets: the port's ``build_suffix_array_big`` against JAX
``execute_big`` on its exact two-pass layout (``count_free=False``, the
layout the port has) and its one-call ``build_suffix_array_big``, and
against SA-IS and Kasai. Edges, fractions and the per-chunk counts must
equal the JAX plan's; SA and LCP must equal byte for byte (tolerance 0,
integers); ``chain_mode``, ``rerun``, ``periods`` and ``n_patched`` must
equal where the host residue closes the ties, and ``refine_members``
where the refinement does. Then the relaxed ``onesweep_pass`` contract
on the plain path, the skew refusals and the routers with their
thresholds lowered through the environment.
"""

import io

import numpy as np
import pytest
import torch

import hpc_suffix_array_tpu.core.bigsort as jbs
import hpc_suffix_array_tpu_torch as tsa
import hpc_suffix_array_tpu_torch.core.bigsort as tbs
from hpc_suffix_array_tpu.core import lcp as jlcp
from hpc_suffix_array_tpu.core import suffix_array as jsuf
from hpc_suffix_array_tpu_torch.cli import run as cli_run
from hpc_suffix_array_tpu_torch.core.oracle import (
    lcp_oracle, suffix_array_oracle)
from hpc_suffix_array_tpu_torch.kernels import launch_counts
from hpc_suffix_array_tpu_torch.kernels.radix import (
    LookBack, onesweep_pass, onesweep_pass_reference)

TINY = dict(target_bucket=1 << 12, chunk_elems=1 << 12, sample=1 << 12)
ALNUM = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
    np.uint8)
DNA = np.frombuffer(b"ACGT", np.uint8)
INFO_KEYS = ("chain_mode", "rerun", "periods", "n_patched")


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.fixture(autouse=True)
def _jax_exact_layout(monkeypatch):
    """JAX's exact two-pass layout for every JAX build here, reruns
    included (its count-free layout has no counterpart in the port)."""
    monkeypatch.setenv("SA_BIG_COUNT_FREE", "0")


def _repeats(seed, n, block, sites):
    rng = _rng(seed)
    text = ALNUM[rng.integers(0, 62, n)]
    blk = ALNUM[rng.integers(0, 62, block)]
    for at in sites:
        text[at:at + block] = blk
    return text


def _broken_period(seed=7):
    rng = _rng(seed)
    pat = ALNUM[rng.integers(0, 62, 500)]
    return np.concatenate([np.tile(pat, 30), ALNUM[rng.integers(0, 62, 100)],
                           np.tile(pat, 30)])


def _slot_zero(seed=8):
    rng = _rng(seed)
    bang = np.full(64, ord("!"), np.uint8)
    return np.concatenate([bang, ALNUM[rng.integers(0, 62, 200)],
                           ALNUM[rng.integers(0, 62, 30_000)],
                           bang, ALNUM[rng.integers(0, 62, 200)]])


# The corpora of tests/test_bigsort.py, each with what it must exercise.
CORPORA = {
    "random_bytes": lambda: _rng(1).integers(0, 256, 40_000).astype(np.uint8),
    "alnum": lambda: ALNUM[_rng(2).integers(0, 62, 40_000)],
    "dna": lambda: DNA[_rng(3).integers(0, 4, 40_000)],
    "low_entropy_zero_bytes": lambda: _rng(4).integers(0, 3, 30_000).astype(
        np.uint8),
    "long_repeats_host_residue": lambda: _repeats(
        5, 30_000, 60, (1000, 7777, 15000, 22222)),
    "very_long_repeats": lambda: _repeats(
        6, 40_000, 200, (500, 9000, 17500, 26000, 34000)),
    "periodic": lambda: np.tile(ALNUM[_rng(9).integers(0, 62, 1000)], 40),
    "periodic_partial_tail": lambda: np.tile(
        ALNUM[_rng(10).integers(0, 62, 997)], 41)[:40_000],
    "period_two": lambda: np.tile(np.frombuffer(b"ab", np.uint8), 15_000),
    "broken_period": _broken_period,
    "single_chunk_single_bucket": lambda: _rng(11).integers(
        0, 256, 3000).astype(np.uint8),
    "residue_at_slot_zero": _slot_zero,
    "all_a": lambda: np.full(30_000, ord("a"), np.uint8),
    "dna_min_tail": lambda: np.concatenate(
        [DNA[_rng(12).integers(0, 4, 4950)], np.full(50, DNA[0])]),
}
EXPECT = {
    "long_repeats_host_residue": lambda i: i["n_patched"] > 0,
    "very_long_repeats": lambda i: i["n_patched"] > 0,
    "periodic": lambda i: i["chain_mode"] and i["periods"] == [1000],
    "periodic_partial_tail": lambda i: i["chain_mode"],
    "period_two": lambda i: i["chain_mode"] and i["periods"] == [2],
    "broken_period": lambda i: "chain_to_ascending" in i["rerun"],
    "single_chunk_single_bucket": lambda i: i["n_buckets_run"] <= 2,
    "residue_at_slot_zero": lambda i: i["n_patched"] > 0,
}


def _jax_exact(text, edges=None, **kw):
    """JAX execute_big on its exact two-pass layout: (sa, lcp, plan)."""
    state = jbs.prepare_big(text, **TINY)
    if edges is not None:
        state["plan"].e0, state["plan"].e1 = edges
    sa, lcp = jbs.execute_big(state, want_lcp=True, count_free=False, **kw)
    return np.asarray(sa), np.asarray(lcp), state["plan"]


def _port(text, edges=None, **kw):
    """The port's staged build: (sa, lcp, plan)."""
    state = tbs.prepare_big(text, device="cpu", **TINY)
    if edges is not None:
        state["plan"].e0, state["plan"].e1 = edges
    sa, lcp = tbs.execute_big(state, want_lcp=True, **kw)
    assert sa.dtype == torch.int32 and lcp.dtype == torch.int32
    return sa.numpy(), lcp.numpy(), state["plan"]


def _hold(text, edges=None):
    """Port vs JAX vs SA-IS/Kasai; returns the port's plan meta."""
    j_sa, j_lcp, j_plan = _jax_exact(text, edges)
    p_sa, p_lcp, p_plan = _port(text, edges)
    want = suffix_array_oracle(text)
    assert np.array_equal(p_sa, want)
    assert np.array_equal(p_sa, j_sa)
    assert np.array_equal(p_lcp, lcp_oracle(text, want))
    assert np.array_equal(p_lcp, j_lcp)
    assert np.array_equal(p_plan.e0, j_plan.e0)
    assert np.array_equal(p_plan.e1, j_plan.e1)
    assert np.array_equal(p_plan.counts, j_plan.counts)
    jm, pm = j_plan.meta, p_plan.meta
    assert pm.get("refine_members") == jm.get("refine_members")
    keys = INFO_KEYS if "refine_members" not in pm else INFO_KEYS[:3]
    for key in keys:
        assert pm.get(key) == jm.get(key), key
    assert pm["n_buckets_run"] == jm["n_buckets_run"]
    return pm


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_msd_matches_jax(name):
    meta = _hold(CORPORA[name]())
    meta.setdefault("rerun", [])
    assert EXPECT.get(name, lambda i: True)(meta), meta


@pytest.mark.parametrize("name", ["alnum", "dna", "broken_period",
                                  "very_long_repeats"])
def test_one_call_matches_jax_one_call(monkeypatch, name):
    """The one-call builders (JAX's count-free layout by default): the
    same SA and LCP, and the same info apart from JAX's own
    ``count_free_overflow`` reruns, which the port has no layout for."""
    monkeypatch.delenv("SA_BIG_COUNT_FREE")
    text = CORPORA[name]()
    ji, pi = {}, {}
    j_sa, j_lcp = jbs.build_suffix_array_big(text, info=ji, want_lcp=True,
                                             **TINY)
    p_sa, p_lcp = tsa.build_suffix_array_big(text, device="cpu", info=pi,
                                             want_lcp=True, **TINY)
    assert np.array_equal(p_sa.numpy(), np.asarray(j_sa))
    assert np.array_equal(p_lcp.numpy(), np.asarray(j_lcp))
    j_rerun = [r for r in ji.get("rerun", []) if r != "count_free_overflow"]
    assert pi.get("rerun", []) == j_rerun
    for key in ("chain_mode", "periods", "n_patched"):
        assert pi.get(key) == ji.get(key), key
    sa_only = tsa.build_suffix_array_big(text, device="cpu", **TINY)
    assert np.array_equal(sa_only.numpy(), p_sa.numpy())


@pytest.mark.parametrize("name", ["alnum", "dna", "low_entropy_zero_bytes"])
def test_pair_edges_match_jax(name):
    """(k0, k1) pair edges forced on both plans: the bucket id is the
    62-bit searchsorted in the port; counts, SA and LCP as in JAX."""
    text = CORPORA[name]()
    remap, _, _ = jsuf.alphabet_remap(text)
    bits, spw, minpad = tbs.packing_mode(remap)
    edges = tbs.sample_edges(text, remap, spw, bits, 1 << 12, sample=1 << 12,
                             k0_only=False, minpad=minpad)
    assert edges[1].any()
    _hold(text, edges)


def test_forced_chain_mode_refuses_irregular_ties():
    text = CORPORA["very_long_repeats"]()
    with pytest.raises(NotImplementedError):
        jbs.execute_big(jbs.prepare_big(text, **TINY), count_free=False,
                        force_chain_mode=True)
    with pytest.raises(NotImplementedError, match="bucket"):
        tbs.execute_big(tbs.prepare_big(text, device="cpu", **TINY),
                        force_chain_mode=True)


@pytest.mark.parametrize("env", ["100", None])
def test_chain_reruns_match_jax(monkeypatch, env):
    """A low SA_CHAIN_EST_MIN makes one repeated block look periodic: both
    packages rerun ``chain_to_ascending``. Period-two text forced
    ascending ties over a quarter of the text and reruns
    ``ascending_to_chain`` in both."""
    if env is not None:
        monkeypatch.setenv("SA_CHAIN_EST_MIN", env)
        text = ALNUM[_rng(13).integers(0, 62, 30_000)]
        text[15_000:15_300] = text[:300]
        assert _hold(text)["rerun"] == ["chain_to_ascending"]
        return
    text = CORPORA["period_two"]()
    j_sa, _, j_plan = _jax_exact(text, force_chain_mode=False)
    p_sa, _, p_plan = _port(text, force_chain_mode=False)
    assert np.array_equal(p_sa, j_sa)
    assert p_plan.meta["rerun"] == j_plan.meta["rerun"] == [
        "ascending_to_chain"]


def test_refined_buckets_match_jax(monkeypatch):
    """Ties past the host cap go to the device refinement on the
    assembled arrays, as in JAX."""
    monkeypatch.setenv("SA_HOST_RESIDUE_MAX", "8")
    meta = _hold(CORPORA["very_long_repeats"]())
    assert meta["refine_members"] > 0
    assert meta["n_patched"] == meta["refine_host_members"]


# --- plan pieces ------------------------------------------------------------

@pytest.mark.parametrize("name", ["alnum", "dna", "all_a", "periodic",
                                  "random_bytes"])
@pytest.mark.parametrize("k0_only", [None, False])
@pytest.mark.parametrize("target,sample", [(1 << 12, 1 << 12),
                                           (1 << 10, 1 << 14)])
def test_sample_edges_equal_jax(name, k0_only, target, sample):
    text = CORPORA[name]()
    remap, _, _ = jsuf.alphabet_remap(text)
    bits, spw, minpad = tbs.packing_mode(remap)
    args = (text, remap, spw, bits, target)
    kw = dict(sample=sample, k0_only=k0_only, with_fracs=True, minpad=minpad)
    got = tbs.sample_edges(*args, **kw)
    want = jbs.sample_edges(*args, **kw)
    packed = tbs.sample_edges(*args, **kw, text_dev=torch.from_numpy(text))
    assert len(got) == len(want) == len(packed) == 3
    for g, p, w in zip(got, packed, want):
        assert g.dtype == p.dtype == w.dtype
        assert np.array_equal(g, w) and np.array_equal(p, w)
    assert np.array_equal(tbs._host_pack_words(text, remap, np.arange(50),
                                                spw, bits, 1, minpad),
                          jbs._host_pack_words(text, remap, np.arange(50),
                                               spw, bits, 1, minpad))


def test_k0_only_refuses_skew():
    text = CORPORA["all_a"]()
    remap, _, _ = jsuf.alphabet_remap(text)
    for mod in (tbs, jbs):
        with pytest.raises(ValueError, match="skew"):
            mod.sample_edges(text, remap, 30, 1, 1 << 12, sample=1 << 12,
                             k0_only=True)


def test_bucket_skew_refused():
    """A cap below the largest bucket: both builders refuse, so the
    routers fall back."""
    text = CORPORA["alnum"]()
    with pytest.raises(NotImplementedError, match="bucket skew"):
        jbs.build_suffix_array_big(text, max_bucket_elems=256, **TINY)
    with pytest.raises(NotImplementedError, match="bucket skew"):
        tbs.build_suffix_array_big(text, device="cpu", max_bucket_elems=256,
                                   **TINY)


def test_chunk_geometry_and_bucket_cap():
    assert tbs.chunk_geometry(10_000, 4096) == (4096, 3, 10_000)
    assert tbs.chunk_geometry(3000, 4096) == (3000, 1, 3000)
    m, c, _ = tbs.chunk_geometry(1 << 30)
    assert (m, c) == (tbs.CHUNK_ELEMS, (1 << 30) // tbs.CHUNK_ELEMS)
    # The bucket id must stay one 8-bit digit: the target bucket rises
    # to n / 256 where the asked one would make more buckets.
    text = CORPORA["alnum"]()
    plan = tbs.prepare_big(text, device="cpu", target_bucket=16,
                           chunk_elems=1 << 12, sample=1 << 12)["plan"]
    assert plan.n_buckets <= 256
    assert plan.meta["target_bucket"] == -(-len(text) // 256)


# --- the relaxed onesweep_pass contract -------------------------------------

def _scatter_case(seed=0):
    """One chunk of 5,000 rows by a 3-bit digit into columns of 12,000,
    each digit's run at a start of its own with gaps between."""
    rng = _rng(seed)
    n = 5000
    key = rng.integers(0, 8, n).astype(np.int32)
    cols = [torch.from_numpy(key), torch.from_numpy(
        rng.integers(0, 1 << 30, n).astype(np.int32)),
        torch.arange(n, dtype=torch.int32)]
    counts = np.bincount(key, minlength=8)
    starts = np.cumsum(np.r_[0, counts[:-1] + 500]).astype(np.int32)
    return cols, counts, starts


def test_onesweep_pass_writes_runs_at_digit_starts():
    cols, counts, starts = _scatter_case()
    out = [torch.full((12_000,), -7, dtype=torch.int32) for _ in cols]
    got = onesweep_pass(cols, 0, 0, 3, torch.from_numpy(starts),
                        LookBack(5000, 1, "cpu"), out=out,
                        digit_counts=counts)
    assert got is out
    key = cols[0].numpy()
    order = np.argsort(key, kind="stable")
    for o, c in zip(out, cols):
        o = o.numpy()
        for d in range(8):
            run = o[starts[d]:starts[d] + counts[d]]
            assert np.array_equal(run, c.numpy()[order][key[order] == d])
        written = np.zeros(12_000, bool)
        for d in range(8):
            written[starts[d]:starts[d] + counts[d]] = True
        assert (o[~written] == -7).all()     # nothing outside the runs
    # Without digit_starts' gaps the same call is the plain pass.
    plain = onesweep_pass_reference(cols, 0, 0, 3)
    dense = torch.from_numpy(np.cumsum(np.r_[0, counts[:-1]]).astype(
        np.int32))
    same = onesweep_pass_reference(cols, 0, 0, 3, digit_starts=dense)
    for p, s in zip(plain, same):
        assert torch.equal(p, s)


@pytest.mark.parametrize("case", ["past_end", "negative", "short_out",
                                  "no_counts", "bad_counts"])
def test_onesweep_pass_relaxed_contract_is_checked(case):
    from hpc_suffix_array_tpu_torch.kernels.radix import _check_pass_buffers

    cols, counts, starts = _scatter_case(1)
    size = 12_000
    if case == "past_end":
        starts[7] = size - counts[7] + 1
    elif case == "negative":
        starts[0] = -1
    elif case == "short_out":
        size = 4999
    elif case == "bad_counts":
        counts = counts + 1
    out = [torch.zeros(size, dtype=torch.int32) for _ in cols]
    err = TypeError if case == "short_out" else ValueError
    with pytest.raises(err):
        _check_pass_buffers(cols, out, torch.from_numpy(starts), 3,
                            None if case == "no_counts" else counts)
    if case in ("past_end", "negative", "short_out"):
        with pytest.raises(err):
            onesweep_pass_reference(cols, 0, 0, 3, out,
                                    torch.from_numpy(starts))


# --- post_sort's previous-bucket keys ---------------------------------------

def test_post_sort_prev_only_changes_row_zero():
    """With ``prev`` only row 0's LCP changes (it compares with the given
    words instead of the -1 sentinel); without it the direct build's
    pass is unchanged."""
    rng = _rng(14)
    words = [torch.from_numpy(np.sort(rng.integers(0, 1 << 30, 500)).astype(
        np.int32)), torch.from_numpy(rng.integers(0, 1 << 30, 500).astype(
            np.int32))]
    idx = torch.from_numpy(rng.permutation(500).astype(np.int32))
    base = tbs.post_sort(words, idx, 500, 5, 6, False, True)
    sentinel = [torch.full((1,), -1, dtype=torch.int32)] * 2
    same = tbs.post_sort(words, idx, 500, 5, 6, False, True, sentinel)
    prev = [words[0][:1].clone(), words[1][:1] ^ 1]
    got = tbs.post_sort(words, idx, 500, 5, 6, False, True, prev)
    for a, b in zip(base[:2], same[:2]):
        assert torch.equal(a, b)
    assert torch.equal(base[2], same[2])
    assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
    assert torch.equal(got[2][1:], base[2][1:])
    assert int(base[2][0]) == 0 and int(got[2][0]) == 9   # last symbol


# --- routers ----------------------------------------------------------------

def test_build_suffix_array_routes_msd_where_jax_does(monkeypatch):
    """Above the lowered SA_DIRECT_CROSS a non-chain text takes the MSD in
    both packages."""
    monkeypatch.setenv("SA_BIG_THRESHOLD", "10000")
    monkeypatch.setenv("SA_DIRECT_CROSS", "15000")
    text = ALNUM[_rng(15).integers(0, 62, 20_000)]
    ji, pi = {}, {}
    j_sa = jsuf.build_suffix_array(text, info=ji)
    p_sa = tsa.build_suffix_array(text, device="cpu", info=pi)
    assert pi["path"] == ji["path"] == "msd"
    assert np.array_equal(p_sa.numpy(), np.asarray(j_sa))
    assert np.array_equal(p_sa.numpy(), suffix_array_oracle(text))
    assert pi["n_buckets_run"] >= 1 and "declined" not in pi


def test_declined_direct_reaches_msd(monkeypatch):
    """A direct build that declines goes to the MSD before doubling, in
    both routers, as in JAX."""
    monkeypatch.setenv("SA_BIG_THRESHOLD", "10000")
    monkeypatch.setenv("SA_LCP_BIG_MIN", "10000")

    def declines(*a, **kw):
        raise NotImplementedError("synthetic direct refusal")

    monkeypatch.setattr(tbs, "build_suffix_array_direct", declines)
    monkeypatch.setattr(jbs, "build_suffix_array_direct", declines)
    text = ALNUM[_rng(16).integers(0, 62, 20_000)]
    ji, pi = {}, {}
    tsa.build_suffix_array(text, device="cpu", info=pi)
    jsuf.build_suffix_array(text, info=ji)
    assert pi["path"] == ji["path"] == "msd"
    assert "synthetic direct refusal" in pi["declined"]
    pi, ji = {}, {}
    sa, lcp = tsa.build_sa_lcp(text, device="cpu", info=pi)
    jlcp.build_sa_lcp(text, info=ji)
    assert pi["path"] == ji["path"] == "msd"
    want = suffix_array_oracle(text)
    assert np.array_equal(sa.numpy(), want)
    assert np.array_equal(lcp.numpy(), lcp_oracle(text, want))
    info = {}
    lcp2 = tsa.build_lcp_array(text, want, device="cpu", info=info)
    assert info["lcp_path"] == "msd" and torch.equal(lcp2, lcp)


@pytest.mark.parametrize("dialect", ["sequential", "both"])
def test_cli_prints_path_msd(monkeypatch, dialect):
    """cli.run above the lowered thresholds reports PATH:msd where the
    JAX CLI does, validated."""
    monkeypatch.setenv("SA_BIG_THRESHOLD", "10000")
    monkeypatch.setenv("SA_LCP_BIG_MIN", "10000")
    monkeypatch.setenv("SA_DIRECT_CROSS", "15000")
    from hpc_suffix_array_tpu import cli as jax_cli

    text = DNA[_rng(17).integers(0, 4, 30_000)]
    buf, want, arrays = io.StringIO(), io.StringIO(), {}
    res = cli_run(text, "dna.txt", "cpu", validate=True, dialect=dialect,
                  out=buf, arrays=arrays)
    jax_cli.run(text, "dna.txt", "single", None, validate=True,
                dialect=dialect, out=want)
    report = buf.getvalue()
    assert "Valid suffix array: YES" in report
    assert report.count("PATH:msd") == want.getvalue().count("PATH:msd") == 1
    assert res["path"] == "msd"
    sa = suffix_array_oracle(text)
    assert np.array_equal(arrays["sa"].numpy(), sa)
    assert np.array_equal(arrays["lcp"].numpy(), lcp_oracle(text, sa))


# --- on the card ------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 3 * 4096 + 17, (1 << 20) + 3])
@pytest.mark.parametrize("rbits", [3, 8])
def test_onesweep_pass_into_longer_columns_on_card(n, rbits):
    """The kernel writes every digit's run at its digit start inside
    columns longer than the input, as the plain version does, and
    leaves the gaps untouched."""
    _need_cuda()
    rng = _rng(n + rbits)
    radix = 1 << rbits
    key = rng.integers(0, radix, n).astype(np.int32)
    counts = np.bincount(key, minlength=radix)
    gaps = rng.integers(0, 100, radix)
    starts = np.cumsum(np.r_[7, (counts + gaps)[:-1]]).astype(np.int32)
    size = int(starts[-1] + counts[-1] + 5)
    cols = [torch.from_numpy(key).cuda(),
            torch.from_numpy(rng.integers(0, 1 << 30, n).astype(
                np.int32)).cuda(),
            torch.arange(n, dtype=torch.int32, device="cuda"),
            torch.from_numpy(rng.integers(0, 1 << 30, n).astype(
                np.int32)).cuda()]
    starts_t = torch.from_numpy(starts).cuda()
    got = [torch.full((size,), -3, dtype=torch.int32, device="cuda")
           for _ in cols]
    before = launch_counts()["onesweep_pass"]
    onesweep_pass(cols, 0, 0, rbits, starts_t, LookBack(n, 1, "cuda"),
                  out=got, digit_counts=counts)
    assert launch_counts()["onesweep_pass"] == before + 1
    want = [torch.full((size,), -3, dtype=torch.int32, device="cuda")
            for _ in cols]
    onesweep_pass_reference(cols, 0, 0, rbits, want, starts_t)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["alnum", "dna", "periodic",
                                  "very_long_repeats"])
def test_msd_on_card_matches_oracles(name):
    """The MSD builder on the card (K1, the onesweep scatter and bucket
    sorts) at the TINY geometry, against SA-IS and Kasai and the same
    build on the CPU."""
    _need_cuda()
    text = CORPORA[name]()
    gi, ci = {}, {}
    sa, lcp = tsa.build_suffix_array_big(text, device="cuda", info=gi,
                                         want_lcp=True, **TINY)
    c_sa, c_lcp = tsa.build_suffix_array_big(text, device="cpu", info=ci,
                                             want_lcp=True, **TINY)
    want = suffix_array_oracle(text)
    assert np.array_equal(sa.cpu().numpy(), want)
    assert np.array_equal(lcp.cpu().numpy(), lcp_oracle(text, want))
    assert torch.equal(sa.cpu(), c_sa) and torch.equal(lcp.cpu(), c_lcp)
    for key in INFO_KEYS + ("n_buckets_run",):
        assert gi.get(key) == ci.get(key), key
