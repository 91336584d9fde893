"""The port's chunked validator against the JAX package's.

Both packages read ``SA_VALIDATE_FUSED_MAX`` at call time; lowered to
``L`` = 64 it makes the chunk width 64 in both, so texts of more than 64
positions take the chunked forms. Inputs are made with numpy from a
seed; every verdict must equal JAX ``is_valid_suffix_array``'s (a bool:
no tolerance), and every true SA must be accepted.

One exception, a fault of the JAX package's chunked form: where n is
1 more than a multiple of L (n > L), its last inverse-permutation chunk
starts at n - 1, ``lax.dynamic_slice`` clamps that start to n - L (its
padding covers the order chunks, not this one), and row n - 1's slot is
filled from row 1's entry, so it rejects the true SA. There the port is
held against the JAX package's fused ``validate_kernel`` instead.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hpc_suffix_array_tpu.core.validate import (
    is_valid_suffix_array as jax_is_valid, validate_kernel as jax_fused)
from hpc_suffix_array_tpu_torch.core import validate as tval
from hpc_suffix_array_tpu_torch.core.oracle import suffix_array_oracle
from hpc_suffix_array_tpu_torch.datasets import generate as gen

L = 64
CORPORA = {
    "random_alnum": gen.generate_random_text,
    "dna": gen.generate_dna_text,
    "repetitive": gen.generate_repetitive_text,
    "words": gen.generate_words_text,
}


@pytest.fixture(autouse=True)
def _lowered(monkeypatch):
    monkeypatch.setenv("SA_VALIDATE_FUSED_MAX", str(L))


def _jax_verdict(text, sa) -> bool:
    n = len(text)
    if n > L and n % L == 1:
        return bool(jax_fused(jnp.asarray(text), jnp.asarray(sa)))
    return bool(jax_is_valid(text, sa))


def _verdicts(text, sa) -> bool:
    got = tval.is_valid_suffix_array(text, sa, device="cpu")
    assert got == _jax_verdict(text, sa)
    return got


def _text(n: int, seed: int) -> np.ndarray:
    return gen.generate_random_text(n, seed)


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_true_sa_of_corpora(name):
    text = CORPORA[name](5 * L + 3, 3)
    sa = suffix_array_oracle(text)
    assert len(text) > tval.fused_max()
    assert _verdicts(text, sa) is True


@pytest.mark.parametrize("n", [1, 2, L, L + 1, 5 * L + 3])
def test_sizes_around_the_chunk(n):
    text = _text(n, n)
    sa = suffix_array_oracle(text)
    assert _verdicts(text, sa) is True
    if n > 2:
        bad = sa.copy()
        bad[[0, n - 1]] = bad[[n - 1, 0]]
        assert _verdicts(text, bad) is False


def _corrupt(kind: str, sa: np.ndarray) -> np.ndarray:
    bad = sa.copy()
    n = len(sa)
    if kind == "swapped_pair":
        bad[[L - 1, L]] = bad[[L, L - 1]]       # straddles a chunk edge
    elif kind == "duplicate":
        bad[2 * L + 5] = bad[7]
    elif kind == "out_of_range":
        bad[L + 3] = n
    elif kind == "negative":
        bad[3 * L] = -1
    elif kind == "last_chunk":
        bad[[n - 2, n - 1]] = bad[[n - 1, n - 2]]   # in the short chunk
    return bad


@pytest.mark.parametrize("kind", ["swapped_pair", "duplicate",
                                  "out_of_range", "negative", "last_chunk"])
def test_faults_rejected(kind):
    text = gen.generate_words_text(5 * L + 3, 1)
    bad = _corrupt(kind, suffix_array_oracle(text))
    assert _verdicts(text, bad) is False


def test_wrong_length_rejected():
    text = _text(3 * L, 2)
    sa = suffix_array_oracle(text)
    assert tval.is_valid_suffix_array(text, sa[:-1], device="cpu") is False
    assert bool(jax_is_valid(text, sa[:-1])) is False


@pytest.mark.parametrize("width", [1, 7, L, 1000])
def test_chunked_equals_fused(width):
    """``validate_chunked`` at any width against ``validate_kernel`` on
    the same tensors, for a true SA and a swapped pair."""
    text = torch.from_numpy(gen.generate_dna_text(700, 5))
    sa = torch.from_numpy(suffix_array_oracle(text.numpy()))
    bad = sa.clone()
    bad[[100, 101]] = bad[[101, 100]]
    for s, want in ((sa, True), (bad, False)):
        assert bool(tval.validate_kernel(text, s)) is want
        assert tval.validate_chunked(text, s, width) is want


def test_switch_read_at_call_time(monkeypatch):
    """The fused form serves n up to the switch, the chunked form above
    it; the switch is the environment's value at each call."""
    text = _text(200, 4)
    sa = suffix_array_oracle(text)
    calls = []
    real = tval.validate_chunked

    def spy(t, s, width):
        calls.append(width)
        return real(t, s, width)

    monkeypatch.setattr(tval, "validate_chunked", spy)
    assert tval.is_valid_suffix_array(text, sa, device="cpu")
    assert calls == [L]
    monkeypatch.setenv("SA_VALIDATE_FUSED_MAX", "200")
    assert tval.is_valid_suffix_array(text, sa, device="cpu")
    assert calls == [L]
    monkeypatch.delenv("SA_VALIDATE_FUSED_MAX")
    assert tval.fused_max() == tval.FUSED_MAX


@pytest.mark.parametrize("n", [L + 1, 2 * L + 1])
def test_jax_chunked_fault_not_carried(n):
    """At n = kL + 1 the JAX chunked form rejects the true SA (see the
    module doc); its fused kernel and the port accept it."""
    text = _text(n, n)
    sa = suffix_array_oracle(text)
    assert bool(jax_is_valid(text, sa)) is False
    assert bool(jax_fused(jnp.asarray(text), jnp.asarray(sa))) is True
    assert tval.is_valid_suffix_array(text, sa, device="cpu") is True
