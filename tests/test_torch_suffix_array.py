"""Doubling builder of the port against the JAX package and SA-IS.

A suffix array is unique, so every comparison is exact (tolerance 0).
Inputs come from numpy with fixed seeds and go through both packages.
Corpus sizes are powers of two so the JAX side reuses a few compiled
shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpc_suffix_array_tpu as jsa
import hpc_suffix_array_tpu_torch as tsa
from hpc_suffix_array_tpu.core.suffix_array import (
    alphabet_remap as jax_alphabet_remap)
from hpc_suffix_array_tpu.core.suffix_array import (
    suffix_array_kernel as jax_suffix_array_kernel)
from hpc_suffix_array_tpu.datasets import generate as jax_gen
from hpc_suffix_array_tpu_torch import native
from hpc_suffix_array_tpu_torch.core.oracle import suffix_array_oracle
from hpc_suffix_array_tpu_torch.core.suffix_array import (
    alphabet_remap, alphabet_remap_dev, pack_ranks_kernel,
    suffix_array_kernel)
from hpc_suffix_array_tpu_torch.datasets import generate as gen

GENERATORS = ["generate_random_text", "generate_repetitive_text",
              "generate_dna_text", "generate_words_text"]


def _both(text):
    """(port SA, JAX SA) as numpy int32, both checked for dtype/shape."""
    port = tsa.build_suffix_array(text, device="cpu")
    assert port.dtype == torch.int32 and port.device.type == "cpu"
    return port.numpy(), np.asarray(jsa.build_suffix_array(text))


def _check(text):
    port, ref = _both(text)
    assert np.array_equal(port, ref)
    assert np.array_equal(port, suffix_array_oracle(text))


def test_canonical(canonical_case):
    _name, text = canonical_case
    _check(text)


EDGES = {
    "one_byte": b"x",
    "multibyte_utf8": "añoño",
    "two_extremes": bytes([0, 255] * 300),
    "all_256_values": bytes(np.random.default_rng(5).permutation(256)
                            .astype(np.uint8)),
    "all_distinct": bytes(range(64)),
}


@pytest.mark.parametrize("name", sorted(EDGES))
def test_edge_cases(name):
    _check(EDGES[name])


def test_empty():
    sa = tsa.build_suffix_array(b"", device="cpu")
    assert sa.shape == (0,) and sa.dtype == torch.int32


@pytest.mark.parametrize("n", [31, 32, 33, 127, 128, 129])
def test_bucket_boundaries(n):
    text = np.random.default_rng(n).integers(0, 4, n, dtype=np.uint8)
    _check(text.tobytes())


@pytest.mark.parametrize("n", [4096, 1 << 16])
@pytest.mark.parametrize("family", GENERATORS)
def test_corpora(family, n):
    text = getattr(gen, family)(n, seed=11)
    port, ref = _both(text)
    assert np.array_equal(port, ref)
    assert np.array_equal(port, native.sa_build(text))


@pytest.mark.parametrize("family", GENERATORS)
def test_rounds_match_jax_kernel(family):
    """Same unpadded initial ranks -> same number of doubling rounds."""
    text = getattr(gen, family)(4096, seed=2)
    remap, bits, h0 = alphabet_remap(text)
    rank0 = pack_ranks_kernel(torch.from_numpy(text), remap, bits, h0,
                              len(text))
    sa, _rank, rounds = suffix_array_kernel(rank0, h0)
    j_sa, _j_rank, j_rounds = jax_suffix_array_kernel(
        jnp.asarray(rank0.numpy()), jnp.int32(h0))
    assert rounds == int(j_rounds)
    assert np.array_equal(sa.numpy(), np.asarray(j_sa))


@pytest.mark.parametrize("family", GENERATORS)
def test_generators_byte_identical(family):
    for n, seed in [(1, 0), (1000, 3), (100_000, 42)]:
        a = getattr(gen, family)(n, seed)
        b = getattr(jax_gen, family)(n, seed)
        assert a.dtype == b.dtype == np.uint8
        assert a.tobytes() == b.tobytes()
    assert gen.SMALL_FIXTURES == jax_gen.SMALL_FIXTURES


@pytest.mark.parametrize("text", [b"banana", b"ACGT" * 10, bytes(range(256)),
                                  b"\x00\x00\x01"])
def test_alphabet_plan_identical(text):
    arr = np.frombuffer(text, np.uint8)
    want_remap, want_bits, want_h0 = jax_alphabet_remap(arr)
    for remap, bits, h0 in (alphabet_remap(arr),
                            alphabet_remap_dev(torch.from_numpy(arr.copy()))):
        assert np.array_equal(remap, want_remap)
        assert (bits, h0) == (want_bits, want_h0)


def test_suffix_array_object():
    s = tsa.SuffixArray.create("mississippi", device="cpu")
    assert s.n == 11
    assert s.longest_repeated_substring() == b"issi"
    assert s.validate()
    ref = jsa.SuffixArray.create("mississippi").build_lcp()
    assert np.array_equal(s.sa.numpy(), np.asarray(ref.sa))
    assert np.array_equal(s.lcp.numpy(), np.asarray(ref.lcp))


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tsa.build_suffix_array(b"banana", device="cuda")
