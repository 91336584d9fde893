"""Repeats laid into a generated text: copies of earlier passages, and
runs of one symbol, placed from a seed.

The generators (``gen/*.py``) make a text's symbols first and then lay
these in; their sizes and shares are the configuration's parameters.
Lengths are fixed by the parameters, so every seed gets the same
repeats; their order and places are drawn on the host (a few thousand
numbers at most) by a numpy generator seeded with the text's seed. The
bytes are moved on the device in one gather and one scatter.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _spans(rng: np.random.Generator, n: int, share: float, lo: int,
           hi: int) -> tuple[np.ndarray, np.ndarray]:
    """(starts, lengths) of disjoint spans covering about ``share`` of
    ``n`` bytes, in increasing order. The lengths are the fixed
    quantiles (k + 1/2)/count of a log-uniform law on [lo, hi], the same
    for every seed; ``rng`` draws only their order and the gaps."""
    hi = min(hi, n // 4)
    if share <= 0 or hi < lo or lo < 1:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    mean = (hi - lo) / math.log(hi / lo) if hi > lo else lo
    count = max(1, round(share * n / mean))
    q = (np.arange(count) + 0.5) / count
    lens = rng.permutation(np.exp(math.log(lo) + q * math.log(hi / lo))
                           .astype(np.int64))
    free = n - int(lens.sum())
    gaps = np.diff(np.sort(rng.integers(0, max(free, 0) + 1, count + 1)),
                   prepend=0)[:count]
    starts = np.cumsum(gaps) + np.concatenate([[0], np.cumsum(lens)[:-1]])
    return starts.astype(np.int64), lens


def _ranges(starts: np.ndarray, lens: np.ndarray, dev) -> torch.Tensor:
    """int64 positions of every span, span after span."""
    s = torch.from_numpy(starts).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    ends = torch.cumsum(ln, 0)
    owner = torch.repeat_interleave(torch.arange(len(lens), device=dev), ln)
    return s[owner] + torch.arange(int(ends[-1]), device=dev) - (ends - ln)[
        owner]


def lay_copies(text: torch.Tensor, rng: np.random.Generator, share: float,
               lo: int, hi: int, mutate: float = 0.0,
               symbols: torch.Tensor | None = None,
               weights: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> None:
    """Overwrite about ``share`` of ``text``, in place, with copies of
    passages that start earlier in it (lengths at fixed quantiles of a
    log-uniform law on [lo, hi]).
    With ``mutate`` > 0, each copied byte is replaced, with that
    probability, by one of ``symbols`` drawn by ``weights``."""
    n = text.shape[0]
    dst, lens = _spans(rng, n, share, lo, hi)
    if not len(dst):
        return
    src = np.array([rng.integers(0, max(d - ln, 0) + 1)
                    for d, ln in zip(dst, lens)], np.int64)
    dev = text.device
    to = _ranges(dst, lens, dev)
    moved = text[_ranges(src, lens, dev)]       # read before any write
    if mutate > 0:
        hit = torch.rand(moved.shape[0], generator=generator,
                         device=dev) < mutate
        k = int(hit.sum())
        if k:
            pick = torch.multinomial(weights, k, replacement=True,
                                     generator=generator)
            moved[hit] = symbols[pick]
    text[to] = moved


def lay_runs(text: torch.Tensor, rng: np.random.Generator, share: float,
             lo: int, hi: int, symbol: int) -> None:
    """Overwrite about ``share`` of ``text``, in place, with runs of
    ``symbol`` (lengths log-uniform on [lo, hi])."""
    at, lens = _spans(rng, text.shape[0], share, lo, hi)
    if len(at):
        text[_ranges(at, lens, text.device)] = symbol
