"""Corpus generators, byte-identical to the JAX package's.

Counterpart of ``hpc_suffix_array_tpu/datasets/generate.py``: the same
numpy ``default_rng(seed)`` draws in the same order, so both packages
see the same bytes for the same ``(n, seed)``. This system has no
weights; the data is what carries across.
"""

from __future__ import annotations

import numpy as np

ALNUM = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
    dtype=np.uint8)
DNA = np.frombuffer(b"ACGT", dtype=np.uint8)

# Canonical strings; their golden LRS values are banana -> "ana",
# mississippi -> "issi", abcabcabc -> "abcabc".
SMALL_FIXTURES = {
    "banana": b"banana",
    "mississippi": b"mississippi",
    "abcabcabc": b"abcabcabc",
    "aaaa": b"a" * 1000,
    "ababab": b"ab" * 500,
}


def generate_random_text(n: int, seed: int = 0) -> np.ndarray:
    """Uniform random alnum bytes."""
    rng = np.random.default_rng(seed)
    return ALNUM[rng.integers(0, len(ALNUM), n)]


def generate_repetitive_text(n: int, seed: int = 0,
                             period: int = 1000) -> np.ndarray:
    """A random base pattern of ``period`` chars tiled to n."""
    base = generate_random_text(period, seed)
    return np.tile(base, -(-n // period))[:n]


def generate_dna_text(n: int, seed: int = 0) -> np.ndarray:
    """Uniform ACGT bytes."""
    rng = np.random.default_rng(seed)
    return DNA[rng.integers(0, 4, n)]


def generate_words_text(n: int, seed: int = 0, vocab_size: int = 1 << 14,
                        octaves: int | None = None) -> np.ndarray:
    """Zipfian dictionary-word stream, the natural-text proxy.

    Space-separated words of 2-9 alnum chars drawn Zipf-like
    (P(word k) ~ 1/k): pick an octave uniformly, then a word uniformly
    within it, using integer draws only."""
    rng = np.random.default_rng(seed)
    if octaves is None:
        octaves = max(1, int(vocab_size).bit_length() - 1)
    vocab_size = 1 << octaves
    lens = rng.integers(2, 10, vocab_size)          # word chars, 2..9
    lmax = 10                                       # + separator
    tab = np.zeros((vocab_size, lmax), np.uint8)
    for L in range(2, 10):
        rows = np.flatnonzero(lens == L)
        tab[rows[:, None], np.arange(L)[None, :]] = ALNUM[
            rng.integers(0, len(ALNUM), (len(rows), L))]
        tab[rows, L] = ord(" ")
    wl = (lens + 1).astype(np.int64)                # emitted cell length

    parts = []
    total = 0
    while total < n:
        k = max(1 << 14, (n - total) // 4)
        o = rng.integers(0, octaves, k)
        ids = (1 << o) + (rng.integers(0, 1 << 62, k) & ((1 << o) - 1))
        ids = np.minimum(ids, vocab_size - 1)
        L = wl[ids]
        ends = np.cumsum(L)
        starts = ends - L
        m = int(ends[-1])
        wid = np.repeat(ids, L)
        intra = np.arange(m, dtype=np.int64) - np.repeat(starts, L)
        parts.append(tab[wid, intra])
        total += m
    return np.concatenate(parts)[:n]
