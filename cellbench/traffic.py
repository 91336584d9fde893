"""The one traffic generator: a traffic file's parameters to the text
sizes, the order in which the window takes them, and the host pool.

A traffic file (``traffic/<name>.json``) holds:

  * ``sizes``: ``{"law": "fixed", "bytes": B, "count": C}`` (C texts of
    B bytes) or ``{"law": "log_uniform", "lo": L, "hi": H, "count": C,
    "round": R}``: C sizes at the fixed quantiles (k + 1/2)/C of a
    log-uniform law on [L, H], rounded to a multiple of R. The sizes are
    the same for every seed;
  * ``order``: ``"cycle"`` (the pool in order, over and over) or
    ``"shuffle"`` (one permutation drawn from the seed, over and over);
  * ``check_per_route``: how many builds of each route the check keeps,
    drawn from the seed;
  * ``trace_builds``: how many of the window's first builds a traced run
    traces.

Each text's contents come from the configuration's generator, seeded by
``text_seed(seed, index)``.
"""

from __future__ import annotations

import math
import random

import numpy as np


def sizes(traffic: dict) -> list[int]:
    """The pool's text sizes, in pool order."""
    s = traffic["sizes"]
    if s["law"] == "fixed":
        return [int(s["bytes"])] * int(s["count"])
    if s["law"] == "log_uniform":
        lo, hi, count, step = (math.log(s["lo"]), math.log(s["hi"]),
                               int(s["count"]), int(s["round"]))
        return [max(step, round(math.exp(lo + (k + 0.5) / count * (hi - lo))
                                / step) * step) for k in range(count)]
    raise ValueError(f"unknown size law {s['law']!r}")


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed drawn from the run's ``seed`` for the use ``tags``
    names."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def text_seed(seed: int, index: int) -> int:
    """The seed of pool text ``index``."""
    return derive(seed, 0, index)


def order(traffic: dict, seed: int, count: int) -> list[int]:
    """One round of the pool's indices, in the order the window takes
    them."""
    idx = list(range(count))
    if traffic["order"] == "shuffle":
        random.Random(derive(seed, 1)).shuffle(idx)
    elif traffic["order"] != "cycle":
        raise ValueError(f"unknown order {traffic['order']!r}")
    return idx


def make_pool(traffic: dict, generate, seed: int, device,
              **params) -> list[np.ndarray]:
    """The pool as host byte arrays: each text made on ``device`` by
    ``generate(n, text_seed, device, **params)`` and copied to the host."""
    return [generate(n, text_seed(seed, i), device, **params).cpu().numpy()
            for i, n in enumerate(sizes(traffic))]
