"""Device tie refinement of the port against the JAX package's.

Every input is made with numpy from a seed and goes through both
packages: the direct builder with refinement forced (as
``tests/test_refine.py`` forces it) against JAX
``build_suffix_array_direct``, one refinement round against JAX
``_refine_round``, the pair table against a numpy fold, and the routers'
fallbacks (doubling, host SA-IS past the doubling reach). All
comparisons are exact (tolerance 0: SA, LCP, words and segment ids are
integers), and every SA and LCP is also held against SA-IS and Kasai.
``refine_members`` must equal the JAX value; rounds, pieces and host
members depend on the piece geometry, which the port redesigned.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpc_suffix_array_tpu.core.bigsort as jbs
import hpc_suffix_array_tpu.core.refine as jrf
import hpc_suffix_array_tpu_torch as tsa
import hpc_suffix_array_tpu_torch.core.bigsort as tbs
import hpc_suffix_array_tpu_torch.core.refine as trf
import hpc_suffix_array_tpu_torch.core.residue as tres
import hpc_suffix_array_tpu_torch.core.suffix_array as tsuf
from hpc_suffix_array_tpu.datasets.generate import generate_words_text
from hpc_suffix_array_tpu_torch.cli import run as cli_run
from hpc_suffix_array_tpu_torch.core.oracle import (
    lcp_oracle, suffix_array_oracle)
from hpc_suffix_array_tpu_torch.utils.profiling import record

ALNUM = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
    np.uint8)
DNA = np.frombuffer(b"ACGT", np.uint8)


def _force_refine(monkeypatch, **extra):
    """Route even tiny tie masses through the device refinement."""
    monkeypatch.setenv("SA_HOST_RESIDUE_MAX", "8")
    monkeypatch.setenv("SA_REFINE_CHECK", "1")   # the JAX per-piece check
    for k, v in extra.items():
        monkeypatch.setenv(k, str(v))


def _both(text):
    """Both direct builders with and without LCP: SA and LCP equal each
    other and SA-IS/Kasai, refine_members equal. Returns the port's
    info from the LCP build."""
    ji, pi = {}, {}
    j_sa, j_lcp = jbs.build_suffix_array_direct(text, want_lcp=True, info=ji)
    p_sa, p_lcp = tbs.build_suffix_array_direct(text, device="cpu",
                                                want_lcp=True, info=pi)
    want = suffix_array_oracle(text)
    assert p_sa.dtype == torch.int32 and p_lcp.dtype == torch.int32
    assert np.array_equal(p_sa.numpy(), np.asarray(j_sa))
    assert np.array_equal(p_sa.numpy(), want)
    assert np.array_equal(p_lcp.numpy(), np.asarray(j_lcp))
    assert np.array_equal(p_lcp.numpy(), lcp_oracle(text, want))
    assert pi["refine_members"] == ji["refine_members"] > 0
    pi2 = {}
    p_sa2 = tbs.build_suffix_array_direct(text, device="cpu", info=pi2)
    assert np.array_equal(p_sa2.numpy(), want)
    assert pi2["refine_members"] == pi["refine_members"]
    assert pi["n_patched"] == pi["refine_host_members"]
    return pi


def _deep_block():
    """A 2000-byte block planted at three sites (test_refine.py's)."""
    rng = np.random.default_rng(11)
    text = rng.integers(97, 123, 1 << 17).astype(np.uint8)
    blk = text[:2000].copy()
    for pos in (30_000, 70_000, 110_000):
        text[pos:pos + 2000] = blk
    return text


def _minpad_dup():
    rng = np.random.default_rng(5)
    text = DNA[rng.integers(0, 4, 1 << 17)].copy()
    text[500:2500] = text[60_000:62_000]
    return text


def _min_symbol_tail():
    rng = np.random.default_rng(6)
    text = DNA[rng.integers(0, 4, 1 << 16)].copy()
    text[:3000] = ord("A")
    text[-3000:] = ord("A")
    return text


def _tail_inside_window():
    """Reserved-0 alnum whose last 301 bytes repeat an earlier run of
    "xy": the tail's suffixes tie with longer ones until they end, so
    windows reach past n and read the all-pad row pk2[n]."""
    text = ALNUM[np.random.default_rng(7).integers(0, 62, 1 << 16)].copy()
    run = np.frombuffer(b"xy" * 200, np.uint8)
    text[1000:1400] = run
    text[-301:] = run[:301]
    return text


CASES = {
    "words_seed0": lambda: generate_words_text(1 << 17, seed=0),
    "words_seed3": lambda: generate_words_text(1 << 17, seed=3),
    "deep_block": _deep_block,
    "minpad_duplication": _minpad_dup,
    "min_symbol_tail": _min_symbol_tail,
    "tail_inside_window": _tail_inside_window,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_refined_direct_matches_jax(monkeypatch, name):
    _force_refine(monkeypatch)
    info = _both(CASES[name]())
    if name == "deep_block":
        assert info["refine_host_members"] > 0


def test_multi_round(monkeypatch):
    """A one-member host budget forces >= 2 device rounds; the boundary
    LCPs recorded in later rounds must be exact."""
    _force_refine(monkeypatch, SA_REFINE_HOST_PIECE=1)
    info = _both(generate_words_text(1 << 17, seed=2))
    assert info["refine_rounds"] >= 2


def test_multi_round_with_compaction(monkeypatch):
    """Rounds on a piece of over 2^12 rows past the point where at most a
    quarter is still tied: the geometric compaction commits the
    resolved rows and refines the rest."""
    _force_refine(monkeypatch, SA_REFINE_HOST_PIECE=1)
    text = generate_words_text(1 << 17, seed=0, vocab_size=64)
    info = _both(text)
    assert info["refine_rounds"] >= 3


@pytest.mark.parametrize("name,host_piece", [("deep_block", 3000),
                                             ("words_planted", 256)])
def test_host_residue_from_the_depth_the_rounds_proved(monkeypatch, name,
                                                       host_piece):
    """Rounds stop with members still tied, which reach the host closer
    as the rounds' segments at the depth they proved: every segment's
    members share that many symbols, at least the key window (the word
    rounds add 2*spw symbols each, the doubling rounds double it); SA and
    LCP equal the JAX package's."""
    _force_refine(monkeypatch, SA_REFINE_HOST_PIECE=host_piece)
    depths = []
    real = tres.resolve_residue_host

    def spy(arr, slots, idxs, n, *args, heads=None, depth=0, **kw):
        assert heads is not None and heads[0]
        seg = np.cumsum(heads)
        for g in np.unique(seg):
            members = idxs[seg == g]
            assert len(members) >= 2 and members.max() + depth <= n
            assert len({bytes(arr[i:i + depth]) for i in members}) == 1
        depths.append(depth)
        return real(arr, slots, idxs, n, *args, heads=heads, depth=depth,
                    **kw)

    monkeypatch.setattr(tres, "resolve_residue_host", spy)
    if name == "deep_block":
        text = _deep_block()
    else:                               # a 560-byte phrase at three sites
        text = generate_words_text(1 << 17, seed=2)
        for pos in (40_000, 90_000):
            text[pos:pos + 560] = text[1000:1560]
    info = _both(text)
    assert info["refine_rounds"] >= 1 and info["refine_host_members"] > 0
    remap = tsuf.alphabet_remap(text)[0]
    _, spw_main, minpad = tbs.packing_mode(remap)
    assert depths and len(set(depths)) == 1
    assert depths[0] > tres.key_depth(info["n_words"], spw_main, minpad)


def test_multi_piece(monkeypatch):
    _force_refine(monkeypatch, SA_REFINE_PIECE=256)
    info = _both(generate_words_text(1 << 16, seed=9))
    assert info["refine_pieces"] >= 2


def test_piece_of_more_than_2_16_members(monkeypatch):
    """One piece of over 2^16 rows (the JAX package's int32 wrap of its
    pad segments past 2^16-row chunks, commit 25ca0c5; the port has no
    pad rows)."""
    _force_refine(monkeypatch)
    text = generate_words_text(1 << 17, seed=1, vocab_size=16)
    info = _both(text)
    assert info["refine_pieces"] == 1
    assert info["refine_members"] > 1 << 16


def test_refine_overflow_falls_back(monkeypatch):
    """With refinement capped to nothing both direct builders raise
    NotImplementedError (RefineOverflow is one), and the router returns
    the exact SA through doubling and says why."""
    _force_refine(monkeypatch, SA_REFINE_ROUNDS=0, SA_REFINE_HOST_PIECE=0)
    monkeypatch.setenv("SA_BIG_THRESHOLD", str(1 << 14))
    text = generate_words_text(1 << 16, seed=1)
    with pytest.raises(NotImplementedError):
        jbs.build_suffix_array_direct(text)
    with pytest.raises(trf.RefineOverflow):
        tbs.build_suffix_array_direct(text, device="cpu")
    assert issubclass(trf.RefineOverflow, NotImplementedError)
    info = {}
    sa = tsa.build_suffix_array(text, device="cpu", info=info)
    assert np.array_equal(sa.numpy(), suffix_array_oracle(text))
    assert info["path"] == "doubling"
    assert "refinement rounds" in info["declined"]


def test_group_max_overflow(monkeypatch):
    _force_refine(monkeypatch, SA_REFINE_GROUP_MAX=4)
    with pytest.raises(trf.RefineOverflow, match="SA_REFINE_GROUP_MAX"):
        tbs.build_suffix_array_direct(generate_words_text(1 << 15, seed=1),
                                      device="cpu")


@pytest.mark.parametrize("entry", ["build_suffix_array", "build_sa_lcp"])
def test_sais_host_past_doubling_reach(monkeypatch, entry):
    """A declined text past the (lowered) doubling reach closes with host
    SA-IS (and Kasai), on the requested device."""
    _force_refine(monkeypatch, SA_REFINE_ROUNDS=0, SA_REFINE_HOST_PIECE=0)
    monkeypatch.setenv("SA_BIG_THRESHOLD", str(1 << 14))
    monkeypatch.setenv("SA_LCP_BIG_MIN", str(1 << 14))
    monkeypatch.setattr(tsuf, "DOUBLING_REACH", 1 << 15)
    text = generate_words_text(1 << 16, seed=4)
    info = {}
    out = getattr(tsa, entry)(text, device="cpu", info=info)
    sa, lcp = out if entry == "build_sa_lcp" else (out, None)
    want = suffix_array_oracle(text)
    assert sa.dtype == torch.int32 and sa.device.type == "cpu"
    assert np.array_equal(sa.numpy(), want)
    if lcp is not None:
        assert np.array_equal(lcp.numpy(), lcp_oracle(text, want))
    assert info["path"] == "sais_host"
    assert "refinement rounds" in info["declined"]


def test_kasai_host_lcp_past_doubling_reach(monkeypatch):
    """build_lcp_array on a declined text past the (lowered) doubling
    reach: host Kasai on the supplied SA, never PLCP."""
    import hpc_suffix_array_tpu_torch.core.lcp as tlcp

    _force_refine(monkeypatch, SA_REFINE_ROUNDS=0, SA_REFINE_HOST_PIECE=0)
    monkeypatch.setenv("SA_BIG_THRESHOLD", str(1 << 14))
    monkeypatch.setenv("SA_LCP_BIG_MIN", str(1 << 14))
    monkeypatch.setattr(tsuf, "DOUBLING_REACH", 1 << 15)

    def no_plcp(*args, **kwargs):
        raise AssertionError("PLCP ran past the doubling reach")

    monkeypatch.setattr(tlcp, "plcp_kernel", no_plcp)
    text = generate_words_text(1 << 16, seed=4)
    want = suffix_array_oracle(text)
    info = {}
    lcp = tsa.build_lcp_array(text, want, device="cpu", info=info)
    assert lcp.dtype == torch.int32 and lcp.device.type == "cpu"
    assert np.array_equal(lcp.numpy(), lcp_oracle(text, want))
    assert info["lcp_path"] == "kasai_host"


def test_sais_host_fallback_matches_jax():
    from hpc_suffix_array_tpu.core.suffix_array import sais_host_fallback

    text = generate_words_text(1 << 15, seed=4)
    ji, pi = {}, {}
    sa = tsuf.sais_host_fallback(text, device="cpu", info=pi)
    assert np.array_equal(sa.numpy(),
                          np.asarray(sais_host_fallback(text, ji)))
    assert pi["path"] == ji["path"] == "sais_host"


def test_build_sa_lcp_words_direct(monkeypatch):
    """The fused entry serves a words text on the direct route."""
    _force_refine(monkeypatch)
    monkeypatch.setenv("SA_LCP_BIG_MIN", str(1 << 14))
    from hpc_suffix_array_tpu.core.lcp import build_sa_lcp

    text = generate_words_text(1 << 16, seed=8)
    info = {}
    sa, lcp = tsa.build_sa_lcp(text, device="cpu", info=info)
    j_sa, j_lcp = build_sa_lcp(text)
    assert np.array_equal(sa.numpy(), np.asarray(j_sa))
    assert np.array_equal(lcp.numpy(), np.asarray(j_lcp))
    assert np.array_equal(lcp.numpy(), lcp_oracle(text, sa.numpy()))
    assert info["path"] == "direct" and info["refine_members"] > 0
    assert "declined" not in info


def test_cli_words_direct(monkeypatch):
    """cli.run on words above the lowered thresholds: PATH:direct with
    refinement, validated."""
    monkeypatch.setenv("SA_BIG_THRESHOLD", str(1 << 14))
    monkeypatch.setenv("SA_LCP_BIG_MIN", str(1 << 14))
    monkeypatch.setenv("SA_HOST_RESIDUE_MAX", "8")
    text = generate_words_text(1 << 16, seed=5)
    buf, arrays = io.StringIO(), {}
    res = cli_run(text, "words", "cpu", validate=True, dialect="sequential",
                  out=buf, arrays=arrays)
    report = buf.getvalue()
    assert "Valid suffix array: YES" in report and "PATH:direct" in report
    assert res["refine_members"] > 0 and "declined" not in res
    want = suffix_array_oracle(text)
    assert np.array_equal(arrays["sa"].numpy(), want)
    assert np.array_equal(arrays["lcp"].numpy(), lcp_oracle(text, want))


# --- pieces of the module -------------------------------------------------

@pytest.mark.parametrize("sigma", [4, 5, 63, 256])
def test_pair_table(sigma):
    """pk2 against a numpy reserved-0 fold; row n and the windows that
    run past n read 0 codes."""
    rng = np.random.default_rng(sigma)
    n = 3000
    remap = np.zeros(256, np.int32)
    remap[:sigma] = np.arange(1, sigma + 1)
    text = rng.integers(0, sigma, n).astype(np.uint8)
    bits, spw = trf.refine_packing(sigma)
    pk2 = trf.pair_table(torch.from_numpy(text), remap).numpy()
    codes = np.zeros(n + 2 * spw + 1, np.int64)
    codes[:n] = remap[text]
    want = np.zeros((n + 1, 2), np.int64)
    for col in range(2):
        for j in range(spw):
            want[:, col] = (want[:, col] << bits) | codes[
                col * spw + j:col * spw + j + n + 1]
    assert pk2.shape == (n + 1, 2)
    assert np.array_equal(pk2, want)
    assert not pk2[n].any()


def test_piece_bounds_start_at_heads():
    rng = np.random.default_rng(3)
    head = torch.from_numpy(rng.random(5000) < 0.05)
    head[0] = True
    for target in (1, 7, 100, 4999, 5000, 10_000):
        b = trf.piece_bounds(head, target)
        assert b[0] == 0 and b[-1] == 5000
        assert all(x < y for x, y in zip(b, b[1:]))
        assert all(bool(head[x]) for x in b[:-1])
        for x, y in zip(b, b[1:]):
            # A piece outgrows the target only by one group's tail.
            assert y - x <= target or not head[x + target:y].any()


def test_piece_bounds_keep_pieces_within_target():
    """Only one group longer than the target makes a longer piece."""
    rng = np.random.default_rng(4)
    head = torch.from_numpy(rng.random(20_000) < 0.3)
    head[0] = True
    head[5000:5100] = False             # one group of 101 rows
    for target in (7, 64, 1000):
        b = trf.piece_bounds(head, target)
        assert all(bool(head[x]) for x in b[:-1])
        for x, y in zip(b, b[1:]):
            assert y - x <= target or not head[x + 1:y].any()


def test_group_max_equal_to_piece_target(monkeypatch):
    """SA_REFINE_GROUP_MAX equal to SA_REFINE_PIECE (the defaults, both
    2^28) refines a text of several pieces: cutting at the first head
    past each target made every piece overflow the cap."""
    _force_refine(monkeypatch, SA_REFINE_PIECE=2048, SA_REFINE_GROUP_MAX=2048)
    text = generate_words_text(1 << 16, seed=9)
    info = {}
    sa, lcp = tbs.build_suffix_array_direct(text, device="cpu",
                                            want_lcp=True, info=info)
    want = suffix_array_oracle(text)
    assert np.array_equal(sa.numpy(), want)
    assert np.array_equal(lcp.numpy(), lcp_oracle(text, want))
    assert info["refine_pieces"] >= 2


def test_refine_round_matches_jax():
    """One round from fresh segments (words at depth 10): the segment
    partition, boundary LCP patches and the tied count equal JAX
    ``_refine_round``; each segment holds the same text indices (the
    JAX sort is unstable, so the order inside a tied segment is free).
    The JAX package labels segments by head position, the port by
    ordinal."""
    text = generate_words_text(1 << 14, seed=6)
    n = len(text)
    remap = np.zeros(256, np.int32)
    present = np.flatnonzero(np.bincount(text, minlength=256))
    remap[present] = np.arange(1, len(present) + 1)
    bits, spw = trf.refine_packing(len(present))
    pk2 = trf.pair_table(torch.from_numpy(text), remap)
    # Rows: every suffix, grouped by its first 2*spw symbols.
    order = np.lexsort((np.arange(n), pk2[:n, 1].numpy(),
                        pk2[:n, 0].numpy()))
    keys = pk2.numpy()[order]
    head = np.r_[True, (keys[1:] != keys[:-1]).any(axis=1)]
    seg = trf.segment_ids(torch.from_numpy(head))
    j_seg0 = np.maximum.accumulate(np.where(head, np.arange(n), -1))
    idx = torch.from_numpy(order.astype(np.int32))
    patch = torch.full((n,), -1, dtype=torch.int32)
    j_seg, j_idx, j_patch, j_tied = jrf._refine_round(
        n, spw, bits, jnp.asarray(j_seg0.astype(np.int32)),
        jnp.asarray(idx.numpy()),
        jnp.asarray(patch.numpy()), jnp.asarray(pk2.numpy()),
        jnp.int32(2 * spw), jnp.int32(n))
    p_seg, p_idx, p_patch, p_tied = trf.refine_round(
        seg.clone(), idx.clone(), patch, pk2, 2 * spw, spw, bits)
    assert p_tied == int(j_tied) > 0
    j_seg = np.asarray(j_seg)
    starts = np.r_[True, j_seg[1:] != j_seg[:-1]]
    assert np.array_equal(p_seg.numpy(), np.cumsum(starts) - 1)
    assert np.array_equal(p_patch.numpy(), np.asarray(j_patch))
    assert (p_patch.numpy() >= 0).any()
    key = p_seg.numpy().astype(np.int64) * n
    assert np.array_equal(np.sort(key + p_idx.numpy()),
                          np.sort(key + np.asarray(j_idx)))


def test_segment_ids():
    head = torch.tensor([1, 0, 0, 1, 1, 0, 1], dtype=torch.bool)
    assert trf.segment_ids(head).tolist() == [0, 0, 0, 1, 2, 2, 3]
    assert trf.segment_ids(head).dtype == torch.int32


def test_tied_rows():
    seg = torch.tensor([0, 0, 2, 3, 3, 3, 6, 7, 7], dtype=torch.int32)
    rows, head = trf.tied_rows(seg)
    assert rows.tolist() == [0, 1, 3, 4, 5, 7, 8]
    assert head.tolist() == [True, False, True, False, False, True, False]


# --- deepening by doubling --------------------------------------------------

def _config_text(name: str, n: int, seed: int, **change) -> np.ndarray:
    """A text of the benchmark's generator ``name`` (``cellbench/gen``),
    made on the CPU, with ``change`` laid over its parameters."""
    import json
    from importlib import import_module
    from pathlib import Path

    cfg = json.loads((Path(__file__).resolve().parents[1] / "cellbench"
                      / "configs" / f"{name}.json").read_text())
    gen = import_module(f"cellbench.gen.{cfg['generator']}")
    params = dict(cfg["generator_params"], **change)
    return gen.make(n, seed, "cpu", **params).numpy()


def _copies(n: int, seed: int) -> np.ndarray:
    """English with verbatim copies of 4-64 KiB over 5% of the text."""
    return _config_text("english", n, seed,
                        copies={"share": 0.05, "lo": 4096, "hi": 65536})


def _ab(n: int = 1 << 15) -> np.ndarray:
    return np.frombuffer(b"ab" * (n // 2), np.uint8).copy()


def _abc_tail(n: int = 1 << 15) -> np.ndarray:
    """Random letters ending in a copy of an earlier 3000-byte block:
    the last suffixes tie with the block's until they end."""
    text = np.random.default_rng(13).integers(97, 123, n).astype(np.uint8)
    text[-3000:] = text[1000:4000]
    return text


def _dna_tail(n: int = 1 << 15) -> np.ndarray:
    """The same on ACGT (minpad packing)."""
    rng = np.random.default_rng(14)
    text = DNA[rng.integers(0, 4, n)].copy()
    text[-3000:] = text[1000:4000]
    return text


def _two_depths() -> np.ndarray:
    """Two pieces whose word rounds stop at different depths: binary
    text with a 300-byte copy (ties that shrink fast), then letters n-z
    with a 3000-byte block at three sites (ties that stall at once); the
    shallower piece is brought to the other's depth before the
    doubling."""
    rng = np.random.default_rng(5)
    a = np.frombuffer(b"ab", np.uint8)[rng.integers(0, 2, 1 << 16)].copy()
    a[30000:30300] = a[1000:1300]
    b = rng.integers(ord("n"), ord("z") + 1, 1 << 15).astype(np.uint8)
    b[10000:13000] = b[20000:23000]
    b[25000:28000] = b[20000:23000]
    return np.concatenate([a, b, np.frombuffer(b"cdefghijklm", np.uint8)])


def _refine_only(text: np.ndarray, info: dict):
    """The direct build's keys, sort and post-sort (ascending: no chain
    mode, which would take a periodic text), then ``refine_ties`` over
    every tie; returns (sa, lcp) as numpy."""
    state = tbs.prepare_direct(text, device="cpu")
    n, spw, bits = state["n"], state["spw"], state["bits"]
    words, s_idx = tbs._sorted_keys(state, False)
    tie, _, lcp = tbs.post_sort(words, s_idx, n, spw, bits, False, True)
    sa, lcp = trf.refine_ties(
        s_idx, tie, lcp, state["text_dev"], remap=state["remap"],
        spw_main=spw, nw=state["nw"], minpad=state["minpad"],
        host_text=state["host_text"], want_lcp=True, meta=info)
    if state["minpad"]:
        lcp = tres.clamp_lcp(sa, lcp, n)
    return sa.numpy(), lcp.numpy()


DOUBLING = {
    # name: (text, environment, (word rounds, doubling rounds) at least)
    "english_copies_1m": (lambda: _copies(1 << 20, 2**31 + 19), {}, (1, 6)),
    "english_copies_2m": (lambda: _copies(1 << 21, 3200000002), {}, (1, 6)),
    "dna_n_runs": (lambda: _config_text("dna", 1 << 20, 3000000002), {},
                   (1, 3)),
    "periodic_ab": (_ab, {}, (1, 8)),
    "periodic_abc": (lambda: np.tile(np.frombuffer(b"abc", np.uint8),
                                     1 << 13), {}, (1, 8)),
    "tail_inside_tie": (_abc_tail, {}, (1, 4)),
    "tail_inside_tie_minpad": (_dna_tail, {}, (1, 4)),
    "pieces": (lambda: _copies(1 << 20, 77),
               {"SA_REFINE_PIECE": 1 << 16}, (8, 4)),
    "pieces_at_two_depths": (_two_depths, {"SA_REFINE_PIECE": 1 << 16,
                                           "SA_REFINE_HOST_PIECE": 256},
                             (4, 1)),
    "round_cap": (_deep_block, {"SA_REFINE_ROUNDS": 2,
                                "SA_REFINE_HOST_PIECE": 4096}, (1, 2)),
}


@pytest.mark.parametrize("name", sorted(DOUBLING))
def test_doubling_matches_the_oracle(monkeypatch, name):
    """Deepening by doubling gives the oracle's order and every LCP
    exactly (none capped or left a bound): copies of 4-64 KiB in English
    of 1 and 2 MiB, a genome with N runs and repeat families (minpad),
    periodic texts whose ties run to n, suffixes that end inside a tie,
    a build of several pieces (word rounds in each, then doubling over
    all), pieces whose word rounds stop at two depths, and a round cap
    that leaves rows to the host closer."""
    make, env, (words, doubles) = DOUBLING[name]
    _force_refine(monkeypatch, **{"SA_REFINE_HOST_PIECE": 16, **env})
    text = make()
    want = suffix_array_oracle(text)
    want_lcp = lcp_oracle(text, want)
    meta = {}
    with record("test", meta):
        sa, lcp = _refine_only(text, meta)
    assert np.array_equal(sa, want)
    assert np.array_equal(lcp, want_lcp)
    counters = meta["counters"]
    assert counters["refine_word_rounds"] >= words
    assert counters["refine_doubling_rounds"] >= doubles
    if name == "round_cap":
        assert counters["refine_doubling_rounds"] == 2
        assert meta["refine_host_members"] > 0
    if name.startswith("pieces"):
        assert meta["refine_pieces"] >= 2
    if name.startswith("english_copies"):
        # Copies of up to 64 KiB from a key depth of 6: about 14 rounds.
        assert want_lcp.max() >= 1 << 14
        assert meta["refine_rounds"] <= 16


@pytest.mark.parametrize("n", [1, 31, 32, 1000, 1 << 15, 50_003])
def test_range_min_against_brute_force(n):
    """RangeMin's three levels answer every range like a scan, before
    and after values fall (``lower``), with UNKNOWN entries."""
    rng = np.random.default_rng(n)
    v = rng.integers(0, 1000, n).astype(np.int32)
    v[rng.random(n) < 0.3] = trf.UNKNOWN
    t = torch.from_numpy(v.copy())
    rmq = trf.RangeMin(t)
    lo = rng.integers(0, n, 4000)
    span_ = np.minimum(rng.integers(0, n, 4000) >> rng.integers(0, 16, 4000),
                       n - 1 - lo)
    hi = lo + span_
    lo[:3], hi[:3] = [0, 0, n - 1], [n - 1, 0, n - 1]

    def check():
        got = rmq.query(torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
        want = [v[a:b + 1].min() for a, b in zip(lo, hi)]
        assert np.array_equal(got, np.asarray(want, np.int32))

    check()
    pos = rng.choice(n, max(1, n // 10), replace=False)
    val = rng.integers(0, 500, len(pos)).astype(np.int32)
    val = np.minimum(val, v[pos])
    v[pos] = val
    t[torch.from_numpy(pos)] = torch.from_numpy(val)
    rmq.lower(torch.from_numpy(pos), torch.from_numpy(val))
    check()


def test_doubling_lcp_is_the_range_minimum_ahead():
    """One doubling round by hand: every boundary it splits gets d plus
    the least LCP between the two ranks' slots, which is the pair's true
    LCP (brute force), and the ranks then hold the new head slots."""
    text = _abc_tail(1 << 12)
    n = len(text)
    sa_np = suffix_array_oracle(text)
    lcp_np = lcp_oracle(text, sa_np).astype(np.int32)
    d = 8
    # Groups at depth d: runs of slots whose LCP is at least d.
    head = np.r_[True, lcp_np[1:] < d]
    tied = ~head | np.r_[~head[1:], False]
    rows = np.flatnonzero(tied)
    assert len(rows) > 100
    sa = torch.from_numpy(sa_np.astype(np.int32))
    # Each group in scrambled order, as a sort by the first d symbols
    # would leave it.
    grp = np.cumsum(head) - 1
    scr = rows[np.lexsort((np.random.default_rng(2).random(len(rows)),
                           grp[rows]))]
    sa[torch.from_numpy(rows)] = torch.from_numpy(sa_np[scr].astype(np.int32))
    lcp = torch.from_numpy(lcp_np.copy())
    rh = torch.from_numpy(head[rows])
    slot = torch.from_numpy(rows.astype(np.int32))
    idx = sa[slot.long()].clone()
    rank = trf.rank_array(sa, slot, idx, rh)
    lcp[slot[~rh].long()] = trf.UNKNOWN
    rmq = trf.RangeMin(lcp)
    seg, s_idx, tied_n = trf.doubling_round(
        trf.segment_ids(rh), idx, slot, rank, lcp, rmq, d)
    # After one round each group's rows are in order by their first 2d
    # symbols, and a new segment starts exactly where those differ.
    got = s_idx.numpy()
    key = [bytes(text[i:i + 2 * d]) for i in got]
    same_group = ~head[rows][1:]
    new_seg = np.diff(seg.numpy()) != 0
    for j in np.flatnonzero(same_group):
        assert key[j] <= key[j + 1]
        assert new_seg[j] == (key[j] != key[j + 1])
    split = np.flatnonzero(new_seg) + 1
    inner = split[~head[rows][split]]
    assert len(inner)
    for j in inner:
        x, y = int(got[j - 1]), int(got[j])
        m = 0
        while y + m < n and x + m < n and text[x + m] == text[y + m]:
            m += 1
        assert d <= m < 2 * d
        assert int(lcp[rows[j]]) == m
    heads = slot.numpy()[np.r_[True, np.diff(seg.numpy()) != 0]]
    assert np.array_equal(rank[s_idx.long()].numpy(),
                          heads[seg.numpy()])
    assert tied_n == int((np.diff(seg.numpy()) == 0).sum())
