"""The control: the reference's answer with its exactness broken, put in
the program's place, which the check must call not correct.

The configurations state one guarantee: the suffix array, the LCP array
and the longest repeated substring are exact. The control breaks it the
way a builder that stopped at its first key words would: it orders the
suffixes by their first ``DEPTH`` bytes only (ties by position), caps
each LCP at ``DEPTH``, and takes the longest repeated substring from
those. Plain PyTorch: two stable sorts of 8-byte words.

Run on the chip at a cell's own sizes (a pool of the cell's texts per
seed; ``--program`` also judges the program's builds of the same texts,
the readings the limits are set from)::

    python3 cellbench/control.py --workload dna.one-200m --seeds 11 12 13

It prints one JSON line per seed and text, then a summary line.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

DEPTH = 16
WORD = 8
BLOCK = 1 << 26


def _words(pad: torch.Tensor, n: int, w: int) -> torch.Tensor:
    """int64[n]: bytes w*8 .. w*8+7 of each suffix, big-endian, with the
    top bit flipped so that signed order is the bytes' order."""
    out = torch.empty(n, dtype=torch.int64, device=pad.device)
    for s in range(0, n, BLOCK):
        e = min(n, s + BLOCK)
        k = torch.zeros(e - s, dtype=torch.int64, device=pad.device)
        for b in range(WORD):
            o = w * WORD + b
            k = (k << 8) | pad[s + o:e + o].long()
        out[s:e] = k ^ torch.iinfo(torch.int64).min
    return out


def bounded_depth(text: np.ndarray, device, depth: int = DEPTH):
    """(sa, lcp, lrs) of ``text`` ordered by its first ``depth`` bytes."""
    if depth % WORD:
        raise ValueError("the control packs bytes into 8-byte words")
    dev = torch.device(device)
    n = len(text)
    t = torch.from_numpy(np.array(text, np.uint8)).to(dev)
    pad = torch.cat([t, torch.zeros(depth, dtype=torch.uint8, device=dev)])
    order = torch.arange(n, device=dev)
    for w in reversed(range(depth // WORD)):       # least significant first
        key = _words(pad, n, w)[order]
        order = order[torch.sort(key, stable=True).indices]
        del key
    sa = order.to(torch.int32)
    lcp = torch.zeros(n, dtype=torch.int32, device=dev)
    for s in range(1, n, BLOCK):
        e = min(n, s + BLOCK)
        a, b = order[s - 1:e - 1], order[s:e]
        alive = torch.ones(e - s, dtype=torch.bool, device=dev)
        run = torch.zeros(e - s, dtype=torch.int32, device=dev)
        for k in range(depth):
            alive &= (pad[a + k] == pad[b + k]) & (a + k < n) & (b + k < n)
            run += alive
        lcp[s:e] = run
    j = int(torch.argmax(lcp))
    length = int(lcp[j])
    start = int(sa[j])
    lrs = t[start:start + length].cpu().numpy().tobytes() if length else None
    return sa, lcp, lrs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true",
                    help="also judge the program's builds of each text")
    args = ap.parse_args(argv)
    from cellbench import harness, reference, traffic

    bench = harness.Bench()
    cell = bench.cell(args.workload)
    tr = bench.traffic(cell["traffic"])
    config = bench.config(cell["config"])
    gen = bench.module("gen", config["generator"])
    dev = torch.device("cuda")
    sides = {"control": lambda text: bounded_depth(text, dev)}
    if args.program:
        api = harness.port_api()
        sides = {"program": lambda text: harness.build_once(
            api, text, dev).outputs, **sides}
    readings: dict = {side: {} for side in sides}
    for seed in args.seeds:
        pool = traffic.make_pool(tr, gen.make, seed, dev,
                                 **config.get("generator_params", {}))
        for idx, text in enumerate(pool):
            for side, make in sides.items():
                t0 = time.perf_counter()
                sa, lcp, lrs = make(text)
                got = reference.judge(text, sa, lcp, lrs, dev)
                del sa, lcp
                print(json.dumps({"side": side, "workload": args.workload,
                                  "seed": seed, "text": idx, "n": len(text),
                                  "seconds": time.perf_counter() - t0,
                                  **got}), flush=True)
                for k, v in got.items():
                    readings[side].setdefault(k, []).append(v)
                readings[side].setdefault("not_correct", []).append(int(any(
                    got[k] > reference.LIMITS[k] for k in got)))
        del pool
    print(json.dumps({"seeds": args.seeds, "summary": {
        side: {k: {"min": min(v), "max": max(v), "sum": sum(v)}
               for k, v in got.items()}
        for side, got in readings.items()}}))
    return 0


if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])
    sys.exit(main())
