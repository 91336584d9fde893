"""Headline benchmark of the port: input bytes/sec/chip to a full suffix
array, on one CUDA card.

    python bench_cuda.py                 # on the card (--device cuda)
    python bench_cuda.py --device cpu    # the same program on the CPU

Counterpart of the repository's ``bench.py`` (the JAX package's headline):
the same timed regions, routes, metric names and JSON keys. It prints ONE
JSON line on stdout:

    {"metric": "suffix_array_build_throughput", "value", "unit",
     "vs_baseline", "n", "corpus", "rounds", ["path"], "baseline",
     ["requested_bytes", "oom_fallback"]}

and on stderr, first the card's name and power limit, then one JSON line
per secondary metric: ``sa_lcp_build`` (carried-keys routes),
``sa_build_dna``, ``sa_build_repetitive_p1000``, ``sa_build_words``,
``lcp_build`` and ``lcp_build_sorted_fetch``, with ``phase_split_headline``
beside the MSD route's headline.

Where it differs from ``bench.py``:

  * corpora are made on the device by the seeded generators of
    ``datasets/generate.py`` (``device_*``) with one untimed copy to the
    host for planning, in place of the JAX package's twin generators;
  * a timed region is fenced by ``device.synchronize`` at both ends;
  * ``vs_baseline`` is measured against the port's host SA-IS
    (``native.sa_build``, line key ``baseline``: ``host_sais``) on
    ``bench_text(SA_BENCH_BASELINE_BYTES)``: the reference's C sources
    are not in the repository. No floor and no cache are applied;
  * routes come from the package's own gates (``big_threshold``,
    ``prefer_direct``) and constants, never from inline copies;
  * an error in a secondary metric propagates and the run exits
    nonzero: nothing is skipped silently.

Env knobs (``bench.py``'s): ``SA_BENCH_BYTES`` (default 2^30 on a card,
2^20 on the CPU), ``SA_BENCH_REPS`` (3, best-of), ``SA_BENCH_BASELINE_BYTES``
(2^24), ``SA_BENCH_SECONDARY`` (1; 0 skips the secondary corpora),
``SA_BENCH_LCP_BIG`` (1; 0 skips ``sa_lcp_build``).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from hpc_suffix_array_tpu_torch import native
from hpc_suffix_array_tpu_torch.core.bigsort import (
    estimate_repeat_len, execute_big, execute_direct, prefer_direct,
    prepare_big, prepare_direct, replan_edges)
from hpc_suffix_array_tpu_torch.core.lcp import build_lcp_array
from hpc_suffix_array_tpu_torch.core.lcp_window import (
    build_lcp_array_sorted, prepare_lcp_sorted)
from hpc_suffix_array_tpu_torch.core.suffix_array import (
    alphabet_remap_dev, big_threshold, build_suffix_array_doubling)
from hpc_suffix_array_tpu_torch.datasets.generate import (
    device_dna_text, device_random_text, device_words_text)
from hpc_suffix_array_tpu_torch.device import resolve_device, synchronize
from hpc_suffix_array_tpu_torch.kernels import (
    launch_counts, reset_launch_counts)

# bench.py's seeds: the headline and LCP corpora, DNA, words.
SEED = 0xBEEF
DNA_SEED = 0xD0
WORDS_SEED = 0x90D5
ALNUM = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
    dtype=np.uint8)
# Keys of a carried-keys build's meta that the secondary lines carry.
REFINE_KEYS = ("refine_members", "refine_rounds", "refine_phase_s")


def bench_text(n: int) -> np.ndarray:
    """Random alnum corpus of ``bench.py::_bench_text``, byte for byte:
    ``default_rng(0xBEEF)`` draws in 16 MiB chunks into one uint8
    buffer."""
    rng = np.random.default_rng(0xBEEF)
    out = np.empty(n, np.uint8)
    step = 1 << 24
    for i in range(0, n, step):
        m = min(step, n - i)
        out[i:i + m] = ALNUM[rng.integers(0, len(ALNUM), m).astype(np.uint8)]
    return out


def _timed(dev: torch.device, run):
    """(seconds, output) of ``run()``, the device synchronised at both
    ends."""
    synchronize(dev)
    t0 = time.perf_counter()
    out = run()
    synchronize(dev)
    return time.perf_counter() - t0, out


def _best_of(dev: torch.device, run, reps: int, keep: bool = False):
    """One untimed warm-up, then the best of ``reps`` timed runs; each
    output is dropped before the next run starts (one build's peak).
    Returns (best seconds, the last output if ``keep`` else None)."""
    run()
    best, last = float("inf"), None
    for _ in range(reps):
        last = None
        secs, out = _timed(dev, run)
        best = min(best, secs)
        last = out if keep else None
        del out
    return best, last


def _release(dev: torch.device) -> None:
    """Returns freed device memory between corpora, so each build's peak
    is its own."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _plan_inputs(t: torch.Tensor):
    """(host mirror, remap, repeat estimate) of a device corpus: one
    untimed copy to the host, the alphabet counted on the device."""
    arr = t.cpu().numpy()
    remap, _, _ = alphabet_remap_dev(t)
    return arr, remap, estimate_repeat_len(arr)


def measure(n: int, reps: int, *, device, keep_sa: bool = False):
    """(best-of-``reps`` seconds, info) of a full suffix-array build of
    n bytes of random alnum, the port of ``bench.py::measure_tpu``.

    The corpus is made on ``device`` (untimed), with one host copy for
    planning. Above ``big_threshold()`` the package's ``prefer_direct``
    picks the direct carried-keys build (timed: ``execute_direct``) or
    the MSD build (timed: ``replan_edges`` + ``execute_big``; the plan is
    untimed); below it the doubling build is timed whole. Each timed run
    follows one warm-up. ``info``: ``path`` ("direct_sort", "msd_bigsort"
    or "doubling"), ``rounds`` (doubling), ``buckets`` and ``rerun``
    (MSD), ``sa_lcp_secs`` (carried keys, one warm and one timed
    ``want_lcp`` build, unless ``SA_BENCH_LCP_BIG=0``) and, with
    ``keep_sa``, ``sa``: the last timed build's SA."""
    dev = resolve_device(device)
    t = device_random_text(n, SEED, dev)
    if n <= big_threshold():
        route: dict = {}
        secs, sa = _best_of(
            dev, lambda: build_suffix_array_doubling(t, device=dev,
                                                     info=route),
            reps, keep_sa)
        info = {"path": "doubling", "rounds": route["rounds"]}
        if keep_sa:
            info["sa"] = sa
        return secs, info

    arr, remap, est = _plan_inputs(t)
    if prefer_direct(arr, n, est_repeat=est, sigma=int(remap.max())):
        state = prepare_direct(arr, device=dev, text_dev=t, remap=remap,
                               est_repeat=est)
        del t

        def build(**kw):
            return execute_direct(dict(state), **kw)

        info = {"path": "direct_sort"}
    else:
        state = prepare_big(arr, device=dev, text_dev=t, remap=remap,
                            est_repeat=est)
        del t

        def build(**kw):
            # The timed region re-plans (edge re-sampling, on the device
            # for k0-only edges), then runs every pass.
            replan_edges(state, arr)
            return execute_big(dict(state), **kw)

        info = {"path": "msd_bigsort"}
    secs, sa = _best_of(dev, build, reps, keep_sa)
    if keep_sa:
        info["sa"] = sa
    del sa
    if "plan" in state:
        meta = state["plan"].meta
        info["buckets"] = meta.get("n_buckets_run")
        if meta.get("phase_host_s"):
            # Host stamps between the build's sync points (scatter
            # includes the re-plan), with the bucket passes' device time.
            _emit({"metric": "phase_split_headline", "unit": "s",
                   **meta["phase_host_s"],
                   "device_ms": meta.get("phase_device_ms")})
        if meta.get("rerun"):
            # The timed number includes a re-run of the passes.
            info["rerun"] = meta["rerun"]
    if os.environ.get("SA_BENCH_LCP_BIG", "1") != "0":
        info["sa_lcp_secs"] = _best_of(
            dev, lambda: build(want_lcp=True), 1)[0]
    return secs, info


def measure_baseline(nb: int) -> float:
    """Bytes/sec of the port's host SA-IS (native C, O(n)) on
    ``bench_text(nb)``, one timed run after the library is built."""
    text = bench_text(nb)
    native.build()
    t0 = time.perf_counter()
    native.sa_build(text)
    secs = time.perf_counter() - t0
    print(f"# baseline host_sais n={nb}: {secs:.4f} s, "
          f"{nb / secs / 1e6:.3f} MB/s", file=sys.stderr)
    return nb / secs


def _is_oom(e: BaseException) -> bool:
    """Only genuine allocator exhaustion: torch's out-of-memory error, a
    host MemoryError, or the CUDA caching allocator's wording. Any other
    error, even one that mentions memory, must raise, not shrink the
    headline's n."""
    return (isinstance(e, (MemoryError, torch.cuda.OutOfMemoryError))
            or "CUDA out of memory" in f"{type(e).__name__}: {e}")


def _emit(record: dict) -> None:
    print(json.dumps(record), file=sys.stderr, flush=True)


def _sa_line(metric: str, n: int, secs: float, **extra) -> None:
    _emit({"metric": metric, "value": round(n / secs / 1e6, 3),
           "unit": "MB/s/chip", "n": n, **extra})


def _secondary_build(tag: str, n: int, t: torch.Tensor,
                     dev: torch.device) -> None:
    """``sa_build_<tag>``: best of 2 after a warm-up, on the route the
    package's gates pick (doubling up to ``big_threshold()``, else
    direct when ``prefer_direct`` holds, else MSD; plans untimed)."""
    extra: dict = {}
    if n <= big_threshold():
        route: dict = {}
        secs, _ = _best_of(
            dev, lambda: build_suffix_array_doubling(t, device=dev,
                                                     info=route), 2)
        extra["rounds"] = route["rounds"]
        _sa_line(f"sa_build_{tag}", n, secs, **extra)
        return
    arr, remap, est = _plan_inputs(t)
    if prefer_direct(arr, n, est_repeat=est, sigma=int(remap.max())):
        state = prepare_direct(arr, device=dev, text_dev=t, remap=remap,
                               est_repeat=est)
        secs, _ = _best_of(dev, lambda: execute_direct(dict(state)), 2)
        meta = state["meta"]
        extra["path"] = ("direct_chain" if meta.get("chain_mode")
                         else "direct_sort")
        if state["nw"] != 2:
            extra["carried_words"] = state["nw"]
    else:
        state = prepare_big(arr, device=dev, text_dev=t, remap=remap,
                            est_repeat=est)
        secs, _ = _best_of(dev, lambda: execute_big(dict(state)), 2)
        meta = state["plan"].meta
        extra["path"] = ("msd_chain" if meta.get("chain_mode")
                         else "msd_bigsort")
    if meta.get("rerun"):
        extra["rerun"] = meta["rerun"]
    extra.update({k: meta[k] for k in REFINE_KEYS if meta.get(k)})
    _sa_line(f"sa_build_{tag}", n, secs, **extra)


def _lcp_metrics(nl: int, dev: torch.device) -> None:
    """``lcp_build`` (``build_lcp_array``, the production routing: above
    ``SA_LCP_BIG_MIN`` a carried-keys SA+LCP rebuild that cross-checks
    the SA) and ``lcp_build_sorted_fetch`` (``prepare_lcp_sorted``
    untimed, then ``build_lcp_array_sorted``), each best of 2 after a
    warm-up, on the doubling SA of ``nl`` bytes of the headline's
    corpus family."""
    t = device_random_text(nl, SEED, dev)
    arr = t.cpu().numpy()
    sa = build_suffix_array_doubling(t, device=dev)
    route: dict = {}
    secs, _ = _best_of(dev, lambda: build_lcp_array(
        arr, sa, device=dev, text_dev=t, info=route), 2)
    _sa_line("lcp_build", nl, secs, path="build_lcp_array_routing",
             lcp_path=route.get("lcp_path"))
    _release(dev)
    state = prepare_lcp_sorted(arr, text_pad_dev=t, device=dev)
    secs, _ = _best_of(dev, lambda: build_lcp_array_sorted(arr, sa, state),
                       2)
    _sa_line("lcp_build_sorted_fetch", nl, secs,
             path="sorted_fetch_standalone")


def secondary(n: int, dev: torch.device) -> None:
    """The secondary corpora of ``bench.py`` on stderr: DNA at
    min(n, 2^28), period-1000 text (the period ``bench_text(1000)``
    tiled on the device) and words at n, then the LCP metrics at
    min(n, 2^28)."""
    n_dna = min(n, 1 << 28)
    corpora = (
        ("dna", n_dna, lambda: device_dna_text(n_dna, DNA_SEED, dev)),
        ("repetitive_p1000", n, lambda: torch.from_numpy(
            bench_text(1000)).to(dev).repeat(-(-n // 1000))[:n]),
        ("words", n, lambda: device_words_text(n, WORDS_SEED, dev)),
    )
    for tag, nsec, make in corpora:
        _secondary_build(tag, nsec, make(), dev)
        _release(dev)
    _lcp_metrics(min(n, 1 << 28), dev)
    _release(dev)


def card_line(dev: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="bench_cuda.py", description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    print(f"# card: {card_line(dev)}", file=sys.stderr, flush=True)
    reset_launch_counts()
    default_n = 1 << 30 if dev.type == "cuda" else 1 << 20
    n = int(os.environ.get("SA_BENCH_BYTES", default_n))
    reps = int(os.environ.get("SA_BENCH_REPS", "3"))
    nb = int(os.environ.get("SA_BENCH_BASELINE_BYTES", 1 << 24))

    # Halve on OOM so a number always comes out; the fallback is recorded
    # in the line (requested_bytes vs n). Any other error re-raises.
    requested_n = n
    while True:
        try:
            secs, info = measure(n, reps, device=dev)
            break
        except Exception as e:
            if not _is_oom(e) or n <= 1 << 16:
                raise
            n //= 2
            msg = f"{type(e).__name__}: {e}"
            print(f"# falling back to {n} bytes "
                  f"({msg.splitlines()[0][:120]})", file=sys.stderr)
        _release(dev)
    _release(dev)
    bps = n / secs
    vs = bps / measure_baseline(nb)

    if info.get("sa_lcp_secs"):
        _sa_line("sa_lcp_build", n, info["sa_lcp_secs"],
                 path=info["path"] + "_want_lcp")
    if os.environ.get("SA_BENCH_SECONDARY", "1") != "0":
        secondary(n, dev)

    line = {
        "metric": "suffix_array_build_throughput",
        "value": round(bps / 1e6, 3),
        "unit": "MB/s/chip",
        "vs_baseline": round(vs, 3),
        "n": n,
        "corpus": "random_alnum",
        "rounds": info.get("rounds", 0),
        **({"path": info["path"]} if info["path"] != "doubling" else {}),
        "baseline": "host_sais",
    }
    if n != requested_n:
        line["requested_bytes"] = requested_n
        line["oom_fallback"] = True
    # The kernels this run launched (every wrapper counts its own).
    print(f"# launches: {json.dumps(launch_counts())}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
