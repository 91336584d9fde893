"""Router parity with the JAX package: the LCP router's sorted-fetch and
window routes (``core/lcp.py``), their refusal, and ``build_sa_lcp``'s
decline path (the suffix-array router's ``SA_CHAIN_MIN`` branch:
``tests/test_torch_routing_fuzz.py``).

Thresholds are lowered through the JAX package's environment names, which
both packages read. Each case records the route the JAX package took
(spies on its route functions) and holds the port's ``info`` to it, with
the arrays equal byte for byte, and equal to SA-IS and Kasai."""

import numpy as np
import pytest
import torch

import hpc_suffix_array_tpu.core.lcp as jlcp
import hpc_suffix_array_tpu_torch as tsa
import hpc_suffix_array_tpu_torch.core.lcp as tlcp
from hpc_suffix_array_tpu.core import lcp_window as jlw
from hpc_suffix_array_tpu_torch import native
from hpc_suffix_array_tpu_torch.core import lcp_window as tlw
from hpc_suffix_array_tpu_torch.datasets import generate_words_text

ALNUM = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
    np.uint8)


def _rng(seed):
    return np.random.default_rng(0x2CB0 + seed)


def _repeat_blocks(rng):
    text = ALNUM[rng.integers(0, 62, 40_000)]
    block = ALNUM[rng.integers(0, 62, 200)]
    for at in (100, 9000, 25000):
        text[at:at + 200] = block
    return text


CORPORA = {
    "alnum": lambda r: ALNUM[r.integers(0, 62, 20_000)],
    "periodic": lambda r: np.tile(ALNUM[r.integers(0, 62, 1000)], 20),
    "repeat_blocks": _repeat_blocks,
    "rle8": lambda r: np.repeat(ALNUM[r.integers(0, 62, 5000)], 8),
    "words": lambda r: generate_words_text(30_000, seed=7),
}
ENVS = {
    "window_min": {"SA_LCP_WINDOW_MIN": "2000"},
    "big_min": {"SA_LCP_WINDOW_MIN": "2000", "SA_LCP_BIG_MIN": "5000"},
}


def _text(name):
    return np.ascontiguousarray(CORPORA[name](_rng(len(name))))


def _setenv(monkeypatch, **values):
    for key, value in values.items():
        monkeypatch.setenv(key, str(value))


def _spy_jax_routes(monkeypatch) -> list:
    """The routes the JAX package's ``build_lcp_array`` takes, in order:
    "carried" (a carried-keys build derived the LCP), "sorted" or
    "window" (with "_declined" when it refused), "plcp"."""
    taken = []
    big = jlcp._sa_lcp_big

    def spy_big(*args, **kw):
        out = big(*args, **kw)
        if out is not None:
            taken.append("carried")
        return out

    monkeypatch.setattr(jlcp, "_sa_lcp_big", spy_big)
    for fn_name, route in (("build_lcp_array_window", "window"),
                           ("build_lcp_array_sorted", "sorted")):
        def spy(*args, _fn=getattr(jlw, fn_name), _route=route, **kw):
            try:
                out = _fn(*args, **kw)
            except NotImplementedError:
                taken.append(_route + "_declined")
                raise
            taken.append(_route)
            return out

        monkeypatch.setattr(jlw, fn_name, spy)
    plcp = jlcp.plcp_kernel

    def spy_plcp(*args, **kw):
        taken.append("plcp")
        return plcp(*args, **kw)

    monkeypatch.setattr(jlcp, "plcp_kernel", spy_plcp)
    return taken


def _port_routes(info: dict) -> list:
    """The port's ``info`` in the spies' words."""
    out = []
    if "lcp_declined" in info:
        out.append(tlcp.lcp_fetch() + "_declined")
    path = info["lcp_path"]
    out.append("carried" if path in ("direct", "msd") else path)
    return out


@pytest.mark.parametrize("fetch", ["sorted", "window"])
@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("name", sorted(CORPORA))
@pytest.mark.parametrize("env", sorted(ENVS))
def test_lcp_router_matches_jax(env, name, capped, fetch, monkeypatch):
    """build_lcp_array takes the route the JAX package takes (a lowered
    HOST_FINISH_CAP in both modules makes the window routes refuse texts
    with misses), with the same LCP."""
    _setenv(monkeypatch, SA_LCP_FETCH=fetch, **ENVS[env])
    if capped:
        monkeypatch.setattr(jlw, "HOST_FINISH_CAP", 8)
        monkeypatch.setattr(tlw, "HOST_FINISH_CAP", 8)
    text = _text(name)
    sa = native.sa_build(text)
    taken = _spy_jax_routes(monkeypatch)
    want = np.asarray(jlcp.build_lcp_array(text, sa))
    info = {}
    got = tsa.build_lcp_array(text, sa, device="cpu", info=info)
    assert _port_routes(info) == taken
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), native.lcp_kasai(text, sa))
    if "lcp_declined" in info:
        assert "adjacent pairs exceed" in info["lcp_declined"]


@pytest.mark.parametrize("fetch", ["sorted", "window"])
@pytest.mark.parametrize("name", ["alnum", "periodic", "rle8"])
def test_build_sa_lcp_decline_takes_the_fetch_route(name, fetch,
                                                    monkeypatch):
    """Above SA_LCP_BIG_MIN a declined carried-keys build leaves the LCP
    to the sorted-fetch or window route, as in the JAX package (whose
    decline path reaches it through build_lcp_array)."""
    _setenv(monkeypatch, SA_LCP_FETCH=fetch, SA_LCP_WINDOW_MIN=2000,
            SA_LCP_BIG_MIN=5000)
    monkeypatch.setattr(jlcp, "_sa_lcp_big", lambda *a, **k: None)
    monkeypatch.setattr(tlcp, "_sa_lcp_big", lambda *a, **k: None)
    taken = _spy_jax_routes(monkeypatch)
    text = _text(name)
    j_sa, j_lcp = jlcp.build_sa_lcp(text)
    info = {}
    sa, lcp = tsa.build_sa_lcp(text, device="cpu", info=info)
    assert info["path"] == "doubling"
    assert _port_routes(info) == taken == [fetch]
    want_sa = native.sa_build(text)
    assert np.array_equal(sa.numpy(), want_sa)
    assert np.array_equal(sa.numpy(), np.asarray(j_sa))
    assert np.array_equal(lcp.numpy(), np.asarray(j_lcp))
    assert np.array_equal(lcp.numpy(), native.lcp_kasai(text, want_sa))


@pytest.mark.parametrize("reach", [1000, 1 << 30])
def test_refusal_falls_to_plcp_or_kasai(reach, monkeypatch):
    """A refusal falls to PLCP at every n up to the doubling reach (the
    JAX package's SA_LCP_PLCP_MAX cap is not ported), and to host Kasai
    past it."""
    _setenv(monkeypatch, SA_LCP_WINDOW_MIN=2000, SA_LCP_PLCP_MAX=1000)
    monkeypatch.setattr(tlw, "HOST_FINISH_CAP", 8)
    monkeypatch.setattr(tlcp, "doubling_reach", lambda: reach)
    text = _text("rle8")
    sa = native.sa_build(text)
    info = {}
    lcp = tsa.build_lcp_array(text, sa, device="cpu", info=info)
    assert info["lcp_path"] == ("kasai_host" if reach < len(text)
                                else "plcp")
    assert "adjacent pairs exceed" in info["lcp_declined"]
    assert np.array_equal(lcp.numpy(), native.lcp_kasai(text, sa))


@pytest.mark.cuda
@pytest.mark.parametrize("fetch", ["sorted", "window"])
@pytest.mark.parametrize("name", ["alnum", "periodic", "rle8"])
def test_lcp_router_on_card(name, fetch, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU form")
    _setenv(monkeypatch, SA_LCP_FETCH=fetch, SA_LCP_WINDOW_MIN=2000)
    text = _text(name)
    sa = native.sa_build(text)
    info = {}
    lcp = tsa.build_lcp_array(text, sa, device="cuda", info=info)
    assert info["lcp_path"] == fetch
    assert lcp.device.type == "cuda"
    assert np.array_equal(lcp.cpu().numpy(), native.lcp_kasai(text, sa))
