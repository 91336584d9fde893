"""PLCP LCP, LRS and validator of the port against the JAX package.

LCP is compared with the JAX package's ``build_lcp_array`` below 16 KiB,
where the JAX side also takes its PLCP route, and with Kasai at every
size. All comparisons are exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

import hpc_suffix_array_tpu as jsa
import hpc_suffix_array_tpu_torch as tsa
from hpc_suffix_array_tpu_torch import native
from hpc_suffix_array_tpu_torch.core.lcp import lcp_from_plcp, plcp_kernel
from hpc_suffix_array_tpu_torch.core.lrs import lrs_locate
from hpc_suffix_array_tpu_torch.core.oracle import (
    lcp_oracle, lrs_oracle, suffix_array_oracle)
from hpc_suffix_array_tpu_torch.datasets import generate as gen
from tests.conftest import GOLDEN_LRS

GENERATORS = ["generate_random_text", "generate_repetitive_text",
              "generate_dna_text", "generate_words_text"]


def _port_lcp(text):
    sa = tsa.build_suffix_array(text, device="cpu")
    lcp = tsa.build_lcp_array(text, sa, device="cpu")
    assert lcp.dtype == torch.int32
    return sa, lcp


def test_canonical_lcp_and_lrs(canonical_case):
    name, text = canonical_case
    sa, lcp = _port_lcp(text)
    j_sa = jsa.build_suffix_array(text)
    assert np.array_equal(lcp.numpy(),
                          np.asarray(jsa.build_lcp_array(text, j_sa)))
    assert np.array_equal(lcp.numpy(), lcp_oracle(text, sa.numpy()))
    lrs = tsa.find_longest_repeated_substring(text, sa, lcp, device="cpu")
    assert lrs == GOLDEN_LRS[name]
    assert lrs == jsa.find_longest_repeated_substring(
        text, j_sa, jsa.build_lcp_array(text, j_sa))


@pytest.mark.parametrize("family", GENERATORS)
def test_corpora_small_match_jax(family):
    text = getattr(gen, family)(4096, seed=5)
    sa, lcp = _port_lcp(text)
    want = np.asarray(jsa.build_lcp_array(text, sa.numpy()))
    assert np.array_equal(lcp.numpy(), want)
    assert np.array_equal(lcp.numpy(), lcp_oracle(text, sa.numpy()))


@pytest.mark.parametrize("family", GENERATORS)
def test_corpora_large_match_kasai(family):
    text = getattr(gen, family)(1 << 17, seed=6)
    info = {}
    sa = tsa.build_suffix_array(text, device="cpu")
    lcp = tsa.build_lcp_array(text, sa, device="cpu", info=info)
    want = native.lcp_kasai(text, sa.numpy())
    # The repetitive corpus takes the deep-repeat carried-keys route, as
    # in the JAX package; the others take PLCP.
    deep = family == "generate_repetitive_text"
    assert info["lcp_path"] == ("direct" if deep else "plcp")
    assert np.array_equal(lcp.numpy(), want)
    plcp, rounds = plcp_kernel(torch.from_numpy(text), sa)
    assert rounds >= 1
    assert np.array_equal(lcp_from_plcp(plcp, sa).numpy(), want)
    assert tsa.find_longest_repeated_substring(
        text, sa, lcp, device="cpu") == lrs_oracle(text)


def test_lrs_first_maximum_tie():
    """Two repeats of equal length: the first in SA order wins."""
    text = b"xyzQxyzRuvwSuvw"
    sa, lcp = _port_lcp(text)
    got = tsa.find_longest_repeated_substring(text, sa, lcp, device="cpu")
    assert got == b"uvw" == lrs_oracle(text)
    j_sa = jsa.build_suffix_array(text)
    assert got == jsa.find_longest_repeated_substring(
        text, j_sa, jsa.build_lcp_array(text, j_sa))
    lcp_t = torch.tensor([0, 2, 3, 1, 3, 3], dtype=torch.int32)
    sa_t = torch.tensor([5, 4, 3, 2, 1, 0], dtype=torch.int32)
    assert lrs_locate(lcp_t, sa_t) == (3, 3)


def test_lrs_none_and_empty():
    text = bytes(range(64))
    sa, lcp = _port_lcp(text)
    assert tsa.find_longest_repeated_substring(text, sa, lcp,
                                               device="cpu") is None
    empty = torch.zeros(0, dtype=torch.int32)
    assert tsa.build_lcp_array(b"", empty, device="cpu").shape == (0,)
    assert tsa.find_longest_repeated_substring(b"", empty, empty,
                                               device="cpu") is None


def test_lrs_of_str_slices_bytes():
    """A str text is sliced by byte offsets, not characters."""
    text = "añoñoXañoño"
    sa, lcp = _port_lcp(text)
    assert tsa.find_longest_repeated_substring(
        text, sa, lcp, device="cpu") == "añoño".encode()


def test_lcp_rejects_wrong_length():
    with pytest.raises(ValueError):
        tsa.build_lcp_array(b"banana", np.arange(5, dtype=np.int32),
                            device="cpu")


def test_plcp_rejects_past_int32_positions():
    """PLCP's extension builds int32 positions up to n - 1 + CMP_WIDTH:
    a longer text raises before any work (meta tensors: no storage)."""
    from hpc_suffix_array_tpu_torch.core import lcp as tlcp

    for n in (tlcp.PLCP_MAX + 1, 1 << 31):
        text = torch.empty(n, dtype=torch.uint8, device="meta")
        sa = torch.empty(n, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="PLCP takes at most"):
            plcp_kernel(text, sa)
    assert tlcp.PLCP_MAX == (1 << 31) - 1 - tlcp.CMP_WIDTH


def _corruptions(sa):
    swapped = sa.copy()
    swapped[[1, 2]] = swapped[[2, 1]]
    dup = sa.copy()
    dup[3] = dup[4]
    out_of_range = sa.copy()
    out_of_range[0] = len(sa)
    negative = sa.copy()
    negative[-1] = -1
    return {"swapped_pair": swapped, "duplicate": dup,
            "out_of_range": out_of_range, "negative": negative,
            "too_short": sa[:-1], "too_long": np.append(sa, 0)}


@pytest.mark.parametrize("text", [b"mississippi", b"ab" * 40,
                                  gen.generate_words_text(2000, 1).tobytes()])
def test_validator_verdicts_match_jax(text):
    sa = suffix_array_oracle(text)
    assert tsa.is_valid_suffix_array(text, sa, device="cpu")
    assert tsa.is_valid_suffix_array(text, torch.from_numpy(sa),
                                     device="cpu")
    assert tsa.is_valid_suffix_array(b"", np.zeros(0, np.int32),
                                     device="cpu")
    for name, bad in _corruptions(sa).items():
        got = tsa.is_valid_suffix_array(text, bad, device="cpu")
        assert got is False, name
        assert got == jsa.is_valid_suffix_array(text, bad), name
