"""Router parity with the JAX package for the suffix-array router's
``SA_CHAIN_MIN`` branch: deep-repeat texts between ``SA_CHAIN_MIN`` and
``SA_BIG_THRESHOLD`` take the carried keys, the others doubling, with
the same ``info["path"]`` and SA in both packages; then the LCP of the
same draws on the fetch routes (``tests/test_torch_lcp_routes.py``'s
spies). The port's counterpart of ``tests/test_routing_fuzz.py``."""

import jax.numpy as jnp
import numpy as np
import pytest

import hpc_suffix_array_tpu.core.lcp as jlcp
import hpc_suffix_array_tpu.core.suffix_array as jsuf
import hpc_suffix_array_tpu_torch as tsa
from hpc_suffix_array_tpu.core.suffix_array import (
    build_suffix_array as jax_build_suffix_array)
from hpc_suffix_array_tpu_torch import native
from tests.test_routing_fuzz import _draw
from tests.test_torch_lcp_routes import (
    CORPORA, _port_routes, _setenv, _spy_jax_routes, _text)


@pytest.mark.parametrize("chain_min", [4000, 1 << 22])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_chain_min_branch_matches_jax(name, chain_min, monkeypatch):
    """With SA_CHAIN_MIN < n <= SA_BIG_THRESHOLD, deep-repeat texts take
    the carried keys (direct, else MSD) and the others doubling, in both
    packages; at the default SA_CHAIN_MIN every text here doubles."""
    _setenv(monkeypatch, SA_BIG_THRESHOLD=1 << 20, SA_CHAIN_MIN=chain_min)
    text = _text(name)
    j_info, info = {}, {}
    want = np.asarray(jax_build_suffix_array(text, info=j_info))
    got = tsa.build_suffix_array(text, device="cpu", info=info)
    assert info["path"] == j_info["path"]
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, native.sa_build(text))
    if chain_min > len(text):
        assert info["path"] == "doubling"
    if name == "periodic" and chain_min < len(text):
        assert info["path"] == "direct" and info["chain_mode"]


def _sais_for_jax_doubling(monkeypatch) -> list:
    """SA-IS in place of the JAX package's doubling kernel, whose route
    (not kernel) these cases check: compiling the kernel for each
    draw's padded shape took minutes on a loaded test machine. Returns
    the list of lengths it served."""
    served = []

    def kernel(text_pad, remap, bits, h0, n):
        n = int(n)
        served.append(n)
        sa = native.sa_build(np.asarray(text_pad)[:n])
        pad = np.zeros(int(text_pad.shape[0]) - n, np.int32)
        return jnp.asarray(np.concatenate([pad, sa])), None, 0

    monkeypatch.setattr(jsuf, "suffix_array_from_bytes_kernel", kernel)
    return served


@pytest.mark.parametrize("seed", range(12))
def test_routed_build_between_thresholds_matches_jax(seed, monkeypatch):
    """The port's counterpart of test_routing_fuzz.py::
    test_routed_build_matches_oracle, with every draw between
    SA_CHAIN_MIN and SA_BIG_THRESHOLD and above SA_LCP_WINDOW_MIN: the
    SA, its route, the LCP and the LCP's route equal the JAX
    package's (its doubling route served by SA-IS). Both packages read
    SA_REFINE_ROUNDS, lowered so that the draws the refinement cannot
    close (mutated periodic text) decline after 8 rounds, not 64."""
    _setenv(monkeypatch, SA_BIG_THRESHOLD=1 << 16, SA_CHAIN_MIN=4000,
            SA_LCP_WINDOW_MIN=2000, SA_REFINE_ROUNDS=8)
    served = _sais_for_jax_doubling(monkeypatch)
    rng = np.random.default_rng(0xF0 + seed)
    n = int(rng.integers(4_100, 60_000))
    text = np.ascontiguousarray(_draw(rng, n))
    j_info, info = {}, {}
    j_sa = np.asarray(jax_build_suffix_array(text, info=j_info))
    sa = tsa.build_suffix_array(text, device="cpu", info=info)
    assert info["path"] == j_info["path"], (seed, n)
    assert (served == [n]) == (info["path"] == "doubling")
    assert np.array_equal(sa.numpy(), j_sa)
    assert np.array_equal(j_sa, native.sa_build(text))
    taken = _spy_jax_routes(monkeypatch)
    j_lcp = np.asarray(jlcp.build_lcp_array(text, j_sa))
    l_info = {}
    lcp = tsa.build_lcp_array(text, sa, device="cpu", info=l_info)
    assert _port_routes(l_info) == taken
    assert np.array_equal(lcp.numpy(), j_lcp)
    assert np.array_equal(lcp.numpy(), native.lcp_kasai(text, j_sa))
