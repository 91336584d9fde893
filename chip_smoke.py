"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path once on the card and checks it:

  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the hand-written kernels (csrc/*.cu, nvcc, sm_90a)
     and the host SA-IS oracle from this checkout's sources;
  3. kernel vs plain: the pack kernel against its plain PyTorch fold on
     the card, exact, at the test shapes and at 2^28 bytes of random
     alnum and DNA, with both times (CUDA events, median of 5);
  4. correctness at 2^24: random alnum, DNA, period-1000 repetitive and
     words through build_suffix_array -> build_lcp_array -> LRS ->
     validator, against host SA-IS, Kasai and the LRS oracle;
  5. full size: the CLI's run() on 2^28 bytes of random alnum with
     validation, counting the pack kernel's launches.

Any failed phase raises and the script exits nonzero. The line before
the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from hpc_suffix_array_tpu_torch import (
    build_lcp_array, build_suffix_array, find_longest_repeated_substring,
    is_valid_suffix_array, native)
from hpc_suffix_array_tpu_torch.cli import run as cli_run
from hpc_suffix_array_tpu_torch.core.suffix_array import alphabet_remap
from hpc_suffix_array_tpu_torch.datasets import (
    generate_dna_text, generate_random_text, generate_repetitive_text,
    generate_words_text)
from hpc_suffix_array_tpu_torch.kernels import _build
from hpc_suffix_array_tpu_torch.kernels.pack import (
    pack_ranks, pack_ranks_reference)

FULL_N = 1 << 28
CHECK_N = 1 << 24
SEED = 0
# (n, bits, h0) of the kernel tests, plus an n that is not a multiple of 128.
SMALL_CASES = [(128, 6, 5), (128 * 8, 3, 10), (128 * 9, 9, 3),
               (128 * 513, 6, 5), (1 << 17, 1, 30), (1000, 6, 5)]


def phase(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn()`` in ms (CUDA events, after warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_pack(text: np.ndarray, remap: np.ndarray, bits: int, h0: int,
                 n_real: int, timed: bool = False) -> dict:
    t = torch.tensor(text, dtype=torch.uint8, device="cuda")
    r = torch.tensor(remap, dtype=torch.int32, device="cuda")
    got = pack_ranks(t, r, bits, h0, n_real)
    want = pack_ranks_reference(t, r, bits, h0, n_real)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err != 0:
        raise AssertionError(f"pack kernel disagrees at n={len(text)} "
                             f"bits={bits} h0={h0}: max abs err {err}")
    out = {"n": len(text), "bits": bits, "h0": h0, "max_abs_err": err}
    if timed:
        out["ms"] = median_ms(lambda: pack_ranks(t, r, bits, h0, n_real))
        out["plain_ms"] = median_ms(
            lambda: pack_ranks_reference(t, r, bits, h0, n_real))
    return out


def check_corpus(name: str, text: np.ndarray) -> None:
    """SA, LCP, LRS and validator on the card against the host oracles."""
    t0 = time.perf_counter()
    info: dict = {}
    sa = build_suffix_array(text, device="cuda", info=info)
    lcp = build_lcp_array(text, sa, device="cuda", info=info)
    lrs = find_longest_repeated_substring(text, sa, lcp, device="cuda")
    valid = is_valid_suffix_array(text, sa, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    sa_h = sa.cpu().numpy()
    want_sa = native.sa_build(text)
    if not np.array_equal(sa_h, want_sa):
        raise AssertionError(f"{name}: SA differs from SA-IS")
    want_lcp = native.lcp_kasai(text, want_sa)
    if not np.array_equal(lcp.cpu().numpy(), want_lcp):
        raise AssertionError(f"{name}: LCP differs from Kasai")
    j = int(np.argmax(want_lcp))
    want_lrs = (text[want_sa[j]:want_sa[j] + want_lcp[j]].tobytes()
                if want_lcp[j] else None)
    if lrs != want_lrs:
        raise AssertionError(f"{name}: LRS differs from the oracle")
    if not valid:
        raise AssertionError(f"{name}: validator rejected the true SA")
    bad = sa.clone()
    bad[[10, 11]] = bad[[11, 10]]
    if is_valid_suffix_array(text, bad, device="cuda"):
        raise AssertionError(f"{name}: validator accepted a swapped pair")
    phase(f"[4] {name} n={len(text)}: SA == SA-IS, LCP == Kasai, LRS "
          f"length {len(lrs or b'')} == oracle, validator True/False ok; "
          f"rounds={info['rounds']} plcp_rounds={info['plcp_rounds']} "
          f"device pipeline {dt:.3f} s")


def main() -> int:
    # 1) device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    phase(f"[1] device: {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    phase(card)

    # 2) build
    t0 = time.perf_counter()
    _build.load()
    native.build()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    nvcc = (f"nvcc {_build.build_seconds:.2f} s" if _build.build_seconds
            else "kernel library already built")
    phase(f"[2] build: {nvcc}, total {time.perf_counter() - t0:.2f} s; "
          f"ptxas: {' | '.join(ptxas) or 'n/a'}")

    # 3) kernel vs plain
    rng = np.random.default_rng(SEED)
    for n, bits, h0 in SMALL_CASES:
        text = rng.integers(0, 256, n).astype(np.uint8)
        remap = rng.integers(0, min(1 << bits, 257), 256).astype(np.int32)
        compare_pack(text, remap, bits, h0, n)
        compare_pack(text, remap, bits, h0, n // 3)       # masked tail
    zero_tail = np.zeros(1024, np.uint8)
    zero_tail[:100] = rng.integers(1, 4, 100)
    compare_pack(zero_tail, np.arange(256, dtype=np.int32) % 4, 2, 15, 1024)
    full = {}
    for name, gen in (("random alnum", generate_random_text),
                      ("DNA", generate_dna_text)):
        text = gen(FULL_N, SEED)
        remap, bits, h0 = alphabet_remap(text)
        full[name] = compare_pack(text, remap, bits, h0, FULL_N, timed=True)
        r = full[name]
        phase(f"[3] pack {name} n=2^28 bits={bits} h0={h0}: exact; kernel "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms ({card})")
    torch.cuda.empty_cache()

    # 4) correctness at 2^24
    for name, gen in (("random alnum", generate_random_text),
                      ("DNA", generate_dna_text),
                      ("repetitive p1000", generate_repetitive_text),
                      ("words", generate_words_text)):
        check_corpus(name, gen(CHECK_N, SEED))
    torch.cuda.empty_cache()

    # 5) full size through the CLI's entry point
    text = generate_random_text(FULL_N, SEED)
    torch.cuda.reset_peak_memory_stats()
    pack_ranks.launches = 0
    buf = io.StringIO()
    res = cli_run(text, "random_alnum_2^28", "cuda", validate=True,
                  dialect="sequential", out=buf)
    launches = pack_ranks.launches
    peak = torch.cuda.max_memory_allocated()
    report = buf.getvalue()
    if "Valid suffix array: YES" not in report:
        raise AssertionError("2^28 run not validated:\n" + report)
    if launches < 1:
        raise AssertionError("main path did not launch the pack kernel")
    phase(f"[5] cli.run n=2^28 random alnum: Valid suffix array: YES; "
          f"SA {res['sa_time']:.3f} s, LCP+LRS {res['lcp_time']:.3f} s, "
          f"total {res['total_time']:.3f} s; rounds={res['rounds']} "
          f"plcp_rounds={res['plcp_rounds']}; peak "
          f"{peak / 2**30:.2f} GiB; pack launches {launches} ({card})")

    main_shape = full["random alnum"]
    print(json.dumps({"kernels": [{
        "name": "pack_ranks",
        "route": "cuda",
        "source": "hpc_suffix_array_tpu_torch/csrc/pack.cu",
        "replaces": "hpc_suffix_array_tpu/kernels/pack.py:51",
        "launches": launches,
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
