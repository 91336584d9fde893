"""The port's window and sorted-fetch LCP routes (``core/lcp_window.py``)
against the JAX package's functions of the same names, on the same numpy
inputs, and against Kasai. Every comparison is exact (int32 equality,
no tolerance). The JAX side runs on the CPU, as ``tests/test_lcp_window.py``
and ``tests/test_lcp_sorted.py`` run it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_suffix_array_tpu.core import lcp_window as jlw
from hpc_suffix_array_tpu_torch import native
from hpc_suffix_array_tpu_torch.core import lcp_window as tlw
from hpc_suffix_array_tpu_torch.datasets import generate_words_text
from hpc_suffix_array_tpu_torch.kernels.pack import pack_words

ALNUM = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
    np.uint8)


def _rng(seed):
    return np.random.default_rng(0x1CB0 + seed)


def _repeat_blocks(rng):
    """Scattered 200-byte repeated blocks: misses past the window, finished
    on the host."""
    text = ALNUM[rng.integers(0, 62, 40_000)]
    block = ALNUM[rng.integers(0, 62, 200)]
    for at in (100, 9000, 25000):
        text[at:at + 200] = block
    return text


def _near_periodic(rng):
    """Period 997 with three flipped bytes: the misses share no global
    period, so the chain rule fails its sweep and the host finishes."""
    text = np.tile(ALNUM[rng.integers(0, 62, 997)], 40)
    text[[5000, 17000, 30000]] ^= 1
    return text


CORPORA = {
    "random_bytes": lambda r: r.integers(0, 256, 50_000).astype(np.uint8),
    "alnum": lambda r: ALNUM[r.integers(0, 62, 50_000)],
    "dna": lambda r: np.frombuffer(b"ACGT", np.uint8)[r.integers(0, 4,
                                                                  50_000)],
    "binary": lambda r: np.frombuffer(b"ab", np.uint8)[r.integers(0, 2,
                                                                   20_000)],
    "repeat_blocks": _repeat_blocks,
    "periodic": lambda r: np.tile(ALNUM[r.integers(0, 62, 1000)], 40),
    "period_two": lambda r: np.tile(np.frombuffer(b"ab", np.uint8), 10_000),
    "all_same": lambda r: np.full(8192, ord("a"), np.uint8),
    "zero_bytes": lambda r: r.integers(0, 3, 30_000).astype(np.uint8),
    "rle8": lambda r: np.repeat(ALNUM[r.integers(0, 62, 5000)], 8),
    "near_periodic": _near_periodic,
    "words": lambda r: generate_words_text(40_000, seed=3),
    "len0": lambda r: np.zeros(0, np.uint8),
    "len1": lambda r: np.frombuffer(b"a", np.uint8),
    "len2": lambda r: np.frombuffer(b"ab", np.uint8),
    "len3": lambda r: np.frombuffer(b"aaa", np.uint8),
    "banana": lambda r: np.frombuffer(b"banana", np.uint8),
}
# How each corpus closes its misses (the same on both routes).
FINISH = {"repeat_blocks": "host", "rle8": "host", "near_periodic": "host",
          "words": "host", "periodic": "chain", "period_two": "chain",
          "all_same": "chain"}
ROUTES = {
    "window": (jlw.build_lcp_array_window, tlw.build_lcp_array_window),
    "sorted": (jlw.build_lcp_array_sorted, tlw.build_lcp_array_sorted),
}


def _text_sa(name):
    text = np.ascontiguousarray(CORPORA[name](_rng(len(name))))
    return text, native.sa_build(text)


@pytest.mark.parametrize("n", [0, 1, 2, 1000, 1 << 20, (1 << 22) + 1,
                               1 << 28, (1 << 31) - 1])
def test_pick_depth_matches_jax(n):
    for sigma in (0, 1, 2, 3, 4, 26, 62, 200, 256):
        assert tlw.pick_depth(n, sigma) == jlw.pick_depth(n, sigma), sigma


@pytest.mark.parametrize("n", [0, 1, 6, 50_000, 6 << 20, 1 << 28])
def test_pick_wn_matches_jax(n):
    for sigma in (1, 2, 4, 62, 256):
        for spw in (1, 3, 5, 10, 15, 30):
            assert (tlw._pick_wn(n, sigma, spw)
                    == jlw._pick_wn(n, sigma, spw)), (sigma, spw)


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_prepare_state_matches_jax(name):
    """depth (window), and wn, spw, bits (sorted fetch) equal the JAX
    package's, so the two routes miss on the same pairs."""
    text, _ = _text_sa(name)
    assert (tlw.prepare_lcp(text, device="cpu")["depth"]
            == jlw.prepare_lcp(text)["depth"])
    got = tlw.prepare_lcp_sorted(text, device="cpu")
    want = jlw.prepare_lcp_sorted(text)
    assert ({k: got[k] for k in ("n", "wn", "spw", "bits")}
            == {k: want[k] for k in ("n", "wn", "spw", "bits")})


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_route_matches_jax_and_kasai(route, name):
    jax_fn, port_fn = ROUTES[route]
    text, sa = _text_sa(name)
    info = {}
    got = port_fn(text, sa, device="cpu", info=info)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), np.asarray(jax_fn(text, sa)))
    assert np.array_equal(got.numpy(), native.lcp_kasai(text, sa))
    if len(text) > 1:
        assert info["lcp_finish"] == FINISH.get(name, "none")
        assert (info["lcp_misses"] > 0) == (name in FINISH)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("name", ["repeat_blocks", "rle8", "words"])
def test_refusal_past_host_finish_cap(route, name, monkeypatch):
    """With HOST_FINISH_CAP lowered in both modules, both packages refuse
    the same text with the same message."""
    jax_fn, port_fn = ROUTES[route]
    text, sa = _text_sa(name)
    monkeypatch.setattr(jlw, "HOST_FINISH_CAP", 8)
    monkeypatch.setattr(tlw, "HOST_FINISH_CAP", 8)
    with pytest.raises(NotImplementedError) as want:
        jax_fn(text, sa)
    with pytest.raises(NotImplementedError) as got:
        port_fn(text, sa, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_staged_state_reuse_and_padded_text_dev(route):
    """A prepared state serves repeated builds; a device copy with
    garbage past n (not zeros, which could hide a read of the pad as a
    real symbol) gives the same LCP."""
    text, sa = _text_sa("repeat_blocks")
    prepare = (tlw.prepare_lcp if route == "window"
               else tlw.prepare_lcp_sorted)
    build = ROUTES[route][1]
    state = prepare(text, device="cpu")
    a = build(text, sa, state)
    b = build(text, sa, state)
    assert torch.equal(a, b)
    garbage = np.concatenate(
        [text, _rng(9).integers(0, 256, 7777).astype(np.uint8)])
    dev = torch.from_numpy(garbage)
    key = "text_dev" if route == "window" else "text_pad_dev"
    c = build(text, sa, device="cpu", **{key: dev})
    assert torch.equal(a, c)
    assert np.array_equal(a.numpy(), native.lcp_kasai(text, sa))


def test_sorted_words_split_past_three(monkeypatch):
    """wn = 4 (binary above 2^17.5 bytes; set here on a 50 kB state) takes
    two K1 calls, three words and then one at word offset 3*spw; every
    word equals the JAX package's fold of the same codes, and the LCP
    equals Kasai's."""
    text = np.frombuffer(b"ab", np.uint8)[_rng(4).integers(0, 2, 50_000)]
    state = tlw.prepare_lcp_sorted(text, device="cpu")
    assert (state["wn"], state["spw"], state["bits"]) == (3, 15, 2)
    assert tlw._pick_wn(1 << 18, 2, 15) == 4
    state["wn"] = 4
    calls = []

    def spy(*args, **kw):
        calls.append((args[5], kw.get("offset", 0)))
        return pack_words(*args, **kw)

    monkeypatch.setattr(tlw, "pack_words", spy)
    words = tlw.sorted_words(state)
    assert calls == [(3, 0), (1, 45)]
    n = len(text)
    codes = np.zeros(n + 60, np.int32)
    codes[:n] = (text == ord("b")) + 1          # remap: a -> 1, b -> 2
    for w, word in enumerate(words):
        want = jlw._dev_pack_word_local(jnp.asarray(codes), w * 15, 15, 2, n)
        assert np.array_equal(word.numpy(), np.asarray(want)), w
    sa = native.sa_build(text)
    lcp = tlw.build_lcp_array_sorted(text, sa, state)
    assert np.array_equal(lcp.numpy(), native.lcp_kasai(text, sa))


def test_chain_stats_are_scalars():
    """_unresolved_stats and _chain_fix return host scalars, and the
    chain rule closes a periodic text's misses exactly."""
    text, sa = _text_sa("periodic")
    sa_t = torch.from_numpy(sa)
    state = tlw.prepare_lcp_sorted(text, device="cpu")
    depth = state["wn"] * state["spw"]
    lcp = tlw._mismatch_sorted(state, sa_t)
    cnt, dmax, dmin = tlw._unresolved_stats(depth, sa_t, lcp)
    assert all(isinstance(v, int) for v in (cnt, dmax, dmin))
    assert cnt > 0 and dmax == dmin == 1000
    fixed, residual = tlw._chain_fix(depth, sa_t, lcp, len(text), dmax)
    assert residual == 0
    assert np.array_equal(fixed.numpy(), native.lcp_kasai(text, sa))


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("name", ["alnum", "binary", "repeat_blocks",
                                  "periodic", "len1"])
def test_route_on_card(route, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU form")
    from hpc_suffix_array_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)

    text, sa = _text_sa(name)
    reset_launch_counts()
    got = ROUTES[route][1](text, sa, device="cuda")
    assert got.device.type == "cuda"
    assert np.array_equal(got.cpu().numpy(), native.lcp_kasai(text, sa))
    wn = tlw.prepare_lcp_sorted(text, device="cpu")["wn"]
    want = -(-wn // tlw.K1_MAX_WORDS) if route == "sorted" else 0
    assert launch_counts()["pack_words"] == want
