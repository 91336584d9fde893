"""Genome text: symbols drawn independently by the configuration's
frequencies, copies of earlier passages with point substitutions laid
in (repeat families), and runs of one symbol (assembly gaps), all made
on the device from ``seed``.

Parameters (the configuration's ``generator_params``):

  * ``symbols``, ``weights``: the point alphabet and its frequencies;
  * ``copies``: ``{"share", "lo", "hi", "mutate"}``, copies covering
    about ``share`` of the text, lengths log-uniform on [lo, hi] bytes,
    each copied base replaced with probability ``mutate`` by a symbol
    drawn by ``weights``;
  * ``runs``: ``{"symbol", "share", "lo", "hi"}``, runs of ``symbol``.
"""

from __future__ import annotations

import numpy as np
import torch

from cellbench.copies import lay_copies, lay_runs

# Symbols drawn per call.
CHUNK = 1 << 26


def draw(n: int, symbols: bytes, weights, generator, dev) -> torch.Tensor:
    """uint8[n]: ``symbols`` drawn independently by ``weights``."""
    lut = torch.tensor(list(symbols), dtype=torch.uint8, device=dev)
    cum = torch.tensor(np.cumsum(weights) / np.sum(weights),
                       dtype=torch.float64, device=dev)[:-1]
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    for s in range(0, n, CHUNK):
        u = torch.rand(min(CHUNK, n - s), generator=generator, device=dev,
                       dtype=torch.float64)
        out[s:s + u.shape[0]] = lut[torch.searchsorted(cum, u, right=True)]
    return out


def make(n: int, seed: int, device, symbols: str, weights: list,
         copies: dict, runs: dict) -> torch.Tensor:
    """uint8[n] genome text on ``device`` from ``seed``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    sym = symbols.encode()
    text = draw(n, sym, weights, g, dev)
    w = torch.tensor(weights, dtype=torch.float64, device=dev)
    lay_copies(text, rng, copies["share"], copies["lo"], copies["hi"],
               copies["mutate"],
               torch.tensor(list(sym), dtype=torch.uint8, device=dev), w, g)
    lay_runs(text, rng, runs["share"], runs["lo"], runs["hi"],
             ord(runs["symbol"]))
    return text
