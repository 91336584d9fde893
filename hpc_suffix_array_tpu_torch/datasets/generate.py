"""Corpus generators, fixtures and corpus files.

Counterpart of ``hpc_suffix_array_tpu/datasets/generate.py``: the same
numpy ``default_rng(seed)`` draws in the same order, so both packages
see the same bytes for the same ``(n, seed)``, in memory and in the
files with their MD5 ``.meta`` sidecars. This system has no weights; the
data is what carries across.

The ``device_*`` generators make a corpus family where it will be built
(a seeded ``torch.Generator`` on the given device): a 1 GiB numpy
``choice`` takes seconds, the device draw milliseconds. Their bytes are
family-equivalent to the numpy generators', not equal to them.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import time

import numpy as np
import torch

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

MB = 1024 * 1024


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


def _word_table(rng, vocab_size: int):
    """(table uint8[vocab, 10], emitted cell lengths) of the words
    vocabulary: words of 2-9 chars, each followed by a space."""
    lens = rng.integers(2, 10, vocab_size)
    tab = np.zeros((vocab_size, 10), np.uint8)
    for L in range(2, 10):
        rows = np.flatnonzero(lens == L)
        tab[rows[:, None], np.arange(L)[None, :]] = ALNUM[
            rng.integers(0, len(ALNUM), (len(rows), L))]
        tab[rows, L] = ord(" ")
    return tab, (lens + 1).astype(np.int64)


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
    tab, wl = _word_table(rng, vocab_size)

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


def generate_words_text_batched(n: int, seed: int = 0,
                                batch: int = 1 << 24) -> np.ndarray:
    """The words corpus's distribution (``generate_words_text``: the same
    vocabulary for the seed), drawn in batches of ``batch`` words so the
    host holds a few GiB at 2^30. The stream differs from
    ``generate_words_text``'s for the same seed."""
    rng = np.random.default_rng(seed)
    octaves = 14
    vocab_size = 1 << octaves
    tab, wl = _word_table(rng, vocab_size)
    out = np.empty(n, np.uint8)
    total = 0
    while total < n:
        o = rng.integers(0, octaves, batch)
        ids = (1 << o) + (rng.integers(0, 1 << 62, batch) & ((1 << o) - 1))
        ids = np.minimum(ids, vocab_size - 1)
        L = wl[ids]
        ends = np.cumsum(L)
        starts = ends - L
        m = int(ends[-1])
        intra = np.arange(m, dtype=np.int64) - np.repeat(starts, L)
        piece = tab[np.repeat(ids, L), intra]
        take = min(m, n - total)
        out[total:total + take] = piece[:take]
        total += take
    return out


def _device_draw(alphabet: np.ndarray, n: int, seed: int,
                 device) -> torch.Tensor:
    """uint8[n] on ``device``: uniform draws from ``alphabet`` by a
    ``torch.Generator`` of that device seeded with ``seed``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(0, len(alphabet), (n,), generator=g, device=dev,
                          dtype=torch.uint8)
    lut = torch.from_numpy(alphabet.copy()).to(dev)
    # The int64 index of the lookup is made 2^28 positions at a time.
    return torch.cat([lut[codes[i:i + (1 << 28)].long()]
                      for i in range(0, n, 1 << 28)])


def device_random_text(n: int, seed: int, device) -> torch.Tensor:
    """Uniform random alnum bytes made on ``device``."""
    return _device_draw(ALNUM, n, seed, device)


def device_dna_text(n: int, seed: int, device) -> torch.Tensor:
    """Uniform ACGT bytes made on ``device``."""
    return _device_draw(DNA, n, seed, device)


def device_words_text(n: int, seed: int, device) -> torch.Tensor:
    """The words corpus's distribution (``generate_words_text``: the same
    vocabulary for the seed) made on ``device``: the Zipf-like word ids
    are drawn by a ``torch.Generator`` of that device seeded with
    ``seed``, 2^24 words at a time. A 2^30-byte host draw
    (``generate_words_text_batched``) takes about a minute; this takes
    milliseconds on a card."""
    rng = np.random.default_rng(seed)
    octaves = 14
    vocab_size = 1 << octaves
    tab, wl = _word_table(rng, vocab_size)
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    tab_t = torch.from_numpy(tab).to(dev)
    wl_t = torch.from_numpy(wl).to(dev)
    k = min(1 << 24, n // 3 + 1)        # a word's cell is at least 3 bytes
    parts, total = [], 0
    while total < n:
        o = torch.randint(0, octaves, (k,), generator=g, device=dev)
        r = torch.randint(0, 1 << 62, (k,), generator=g, device=dev)
        low = torch.ones_like(o) << o
        ids = (low + (r & (low - 1))).clamp_(max=vocab_size - 1)
        lens = wl_t[ids]
        ends = torch.cumsum(lens, 0)
        take = min(int(ends[-1]), n - total)
        cnt = int(torch.searchsorted(ends, take)) + 1     # words covering it
        ids, lens, ends = ids[:cnt], lens[:cnt], ends[:cnt]
        m = int(ends[-1])
        intra = (torch.arange(m, device=dev)
                 - torch.repeat_interleave(ends - lens, lens))
        parts.append(tab_t[torch.repeat_interleave(ids, lens), intra][:take])
        total += take
    return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.uint8,
                                                      device=dev)


def device_repetitive_text(n: int, seed: int, device,
                           period: int = 1000) -> torch.Tensor:
    """``generate_repetitive_text``'s bytes, tiled on ``device`` from the
    host-made base pattern."""
    base = torch.from_numpy(generate_random_text(period, seed)).to(device)
    return base.repeat(-(-n // period))[:n]


def _write_with_meta(path: pathlib.Path, data: np.ndarray,
                     kind: str) -> None:
    """Write a corpus and its MD5 ``.meta`` sidecar, 64 MiB at a time."""
    md5 = hashlib.md5()
    with open(path, "wb") as f:
        for off in range(0, len(data), 64 * MB):
            chunk = bytes(data[off:off + 64 * MB])
            f.write(chunk)
            md5.update(chunk)
    meta = {
        "filename": path.name,
        "type": kind,
        "length": int(len(data)),
        "md5": md5.hexdigest(),
        "generated": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    path.with_suffix(path.suffix + ".meta").write_text(
        json.dumps(meta, indent=2))


def generate_test_fixtures(out_dir) -> list[pathlib.Path]:
    """Write the five canonical small fixtures; existing files stay."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for name, text in SMALL_FIXTURES.items():
        p = out / f"{name}.txt"
        if not p.exists():
            _write_with_meta(p, np.frombuffer(text, np.uint8), "fixture")
        written.append(p)
    return written


def generate_standard_datasets(out_dir, random_mb=(1, 50, 100, 200, 500),
                               repetitive_mb=(1, 50, 100), dna_mb=(10,),
                               seed: int = 42) -> list[pathlib.Path]:
    """The standard corpus ladder as files; existing files stay."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    plans = (
        [(f"random_{s}MB.txt", "random", generate_random_text, s)
         for s in random_mb]
        + [(f"repetitive_{s}MB.txt", "repetitive",
            generate_repetitive_text, s) for s in repetitive_mb]
        + [(f"dna_{s}MB.txt", "dna", generate_dna_text, s) for s in dna_mb]
    )
    for fname, kind, fn, size_mb in plans:
        p = out / fname
        if not p.exists():
            _write_with_meta(p, fn(size_mb * MB, seed), kind)
        written.append(p)
    return written
