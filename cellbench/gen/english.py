"""English text: a Zipf-like stream of words with case, punctuation,
line breaks and rare bytes between them, and copies of earlier passages
laid in (books held in more than one edition), all made from ``seed``.

Parameters (the configuration's ``generator_params``):

  * ``vocab_octaves``, ``vocab_seed``: a vocabulary of 2**octaves words
    drawn once for the configuration by a numpy ``default_rng(vocab_seed)``;
    word ``k`` lies in octave ``floor(log2 k)`` and has
    ``octave_len[octave]`` letters, one more or one fewer at random,
    each letter drawn by ``letter_weights`` over ``letters``;
  * the stream, drawn on the device by a ``torch.Generator`` seeded with
    ``seed``: word ids octave-Zipf (an octave uniformly, then a word
    uniformly inside it, so P(word k) ~ 1/k), a word capitalised with
    probability ``cap_share``, and after each word one separator drawn by
    weight from ``separators`` (strings) and ``rare`` (``[lo, hi,
    weight]``: every byte lo..hi alone, each with that weight);
  * ``copies``: ``{"share", "lo", "hi"}``, verbatim copies of earlier
    passages covering about ``share`` of the text, lengths log-uniform
    on [lo, hi] bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from cellbench.copies import lay_copies

# Words drawn per call.
CHUNK = 1 << 24


def cells(vocab_octaves: int, vocab_seed: int, octave_len: list,
          letters: str, letter_weights: list, separators: list,
          rare: list):
    """(uint8[rows, width] cells, int64[rows] lengths, float64[seps]
    separator weights): the vocabulary's words, then the same words
    capitalised, then the separators."""
    rng = np.random.default_rng(vocab_seed)
    v = 1 << vocab_octaves
    octave = np.floor(np.log2(np.maximum(np.arange(v), 1))).astype(int)
    lens = np.maximum(np.asarray(octave_len)[octave]
                      + rng.integers(-1, 2, v), 1)
    p = np.asarray(letter_weights, float)
    abc = np.frombuffer(letters.encode(), np.uint8)
    seps = [(s.encode(), w) for s, w in separators]
    seps += [(bytes([b]), w) for lo, hi, w in rare for b in range(lo, hi + 1)]
    width = max(int(lens.max()), max(len(s) for s, _ in seps))
    tab = np.zeros((2 * v + len(seps), width), np.uint8)
    drawn = abc[rng.choice(len(abc), (v, width), p=p / p.sum())]
    tab[:v] = np.where(np.arange(width) < lens[:, None], drawn, 0)
    tab[v:2 * v] = tab[:v]
    tab[v:2 * v, 0] = np.frombuffer(bytes(tab[:v, 0]).upper(), np.uint8)
    for j, (s, _) in enumerate(seps):
        tab[2 * v + j, :len(s)] = np.frombuffer(s, np.uint8)
    cell = np.concatenate([lens, lens, [len(s) for s, _ in seps]])
    return tab, cell.astype(np.int64), np.array([w for _, w in seps])


def make(n: int, seed: int, device, vocab_octaves: int, vocab_seed: int,
         octave_len: list, letters: str, letter_weights: list,
         cap_share: float, separators: list, rare: list,
         copies: dict) -> torch.Tensor:
    """uint8[n] English text on ``device`` from ``seed``."""
    tab, cell, sep_w = cells(vocab_octaves, vocab_seed, octave_len, letters,
                             letter_weights, separators, rare)
    v = 1 << vocab_octaves
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    tab_t = torch.from_numpy(tab).to(dev)
    cell_t = torch.from_numpy(cell).to(dev)
    cum = torch.tensor(np.cumsum(sep_w) / sep_w.sum(), dtype=torch.float64,
                       device=dev)[:-1]
    k = min(CHUNK, n // 2 + 1)          # a word and its separator: >= 2 B
    parts, total = [], 0
    while total < n:
        o = torch.randint(0, vocab_octaves, (k,), generator=g, device=dev)
        r = torch.randint(0, 1 << 62, (k,), generator=g, device=dev)
        low = torch.ones_like(o) << o
        word = low + (r & (low - 1))
        cap = torch.rand(k, generator=g, device=dev) < cap_share
        sep = torch.searchsorted(cum, torch.rand(
            k, generator=g, device=dev, dtype=torch.float64), right=True)
        ids = torch.stack([word + v * cap, 2 * v + sep], 1).flatten()
        lens = cell_t[ids]
        ends = torch.cumsum(lens, 0)
        take = min(int(ends[-1]), n - total)
        cnt = int(torch.searchsorted(ends, take)) + 1   # cells covering it
        ids, lens, ends = ids[:cnt], lens[:cnt], ends[:cnt]
        m = int(ends[-1])
        intra = (torch.arange(m, device=dev)
                 - torch.repeat_interleave(ends - lens, lens))
        parts.append(tab_t[torch.repeat_interleave(ids, lens), intra][:take])
        total += take
    text = (torch.cat(parts) if parts
            else torch.zeros(0, dtype=torch.uint8, device=dev))
    lay_copies(text, np.random.default_rng(seed), copies["share"],
               copies["lo"], copies["hi"])
    return text
